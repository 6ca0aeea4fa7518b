"""Model registry - the JAX package's families and tiny test presets
(theroundtaible_tpu/engine/models/registry.py), as data. A family is a
named hyperparameter set; behavior lives in ModelConfig flags."""

from __future__ import annotations

from .common import ModelConfig

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


# --- Gemma (GeGLU, scaled embeddings, RMSNorm 1+w, tied head) ---

GEMMA_2B = register(ModelConfig(
    name="gemma-2b-it", vocab_size=256_000, num_layers=18, embed_dim=2048,
    num_heads=8, num_kv_heads=1, head_dim=256, mlp_dim=16_384,
    max_seq_len=8192, gelu_mlp=True, scale_embeddings=True,
    rmsnorm_unit_offset=True, tie_embeddings=True))

GEMMA_7B = register(ModelConfig(
    name="gemma-7b-it", vocab_size=256_000, num_layers=28, embed_dim=3072,
    num_heads=16, num_kv_heads=16, head_dim=256, mlp_dim=24_576,
    max_seq_len=8192, gelu_mlp=True, scale_embeddings=True,
    rmsnorm_unit_offset=True, tie_embeddings=True))

# --- Llama 3 (SiLU, GQA, untied head, big rope theta) ---

LLAMA3_8B = register(ModelConfig(
    name="llama-3-8b-instruct", vocab_size=128_256, num_layers=32,
    embed_dim=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    mlp_dim=14_336, max_seq_len=8192, rope_theta=500_000.0,
    norm_eps=1e-5, tie_embeddings=False))

LLAMA32_1B = register(ModelConfig(
    name="llama-3.2-1b-instruct", vocab_size=128_256, num_layers=16,
    embed_dim=2048, num_heads=32, num_kv_heads=8, head_dim=64,
    mlp_dim=8192, max_seq_len=8192, rope_theta=500_000.0,
    norm_eps=1e-5, tie_embeddings=True))

LLAMA32_3B = register(ModelConfig(
    name="llama-3.2-3b-instruct", vocab_size=128_256, num_layers=28,
    embed_dim=3072, num_heads=24, num_kv_heads=8, head_dim=128,
    mlp_dim=8192, max_seq_len=8192, rope_theta=500_000.0,
    norm_eps=1e-5, tie_embeddings=True))

# --- Mistral (SiLU, GQA, sliding window) ---

MISTRAL_7B = register(ModelConfig(
    name="mistral-7b-instruct", vocab_size=32_000, num_layers=32,
    embed_dim=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    mlp_dim=14_336, max_seq_len=8192, rope_theta=1_000_000.0,
    norm_eps=1e-5, sliding_window=4096, tie_embeddings=False))

# --- Qwen2.5 (SiLU, GQA, attention bias, tied head at small sizes) ---

QWEN25_1_5B = register(ModelConfig(
    name="qwen2.5-1.5b-instruct", vocab_size=151_936, num_layers=28,
    embed_dim=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    mlp_dim=8960, max_seq_len=8192, rope_theta=1_000_000.0,
    norm_eps=1e-6, attn_bias=True, tie_embeddings=True))

# --- Mixtral (SiLU, GQA, sparse MoE) ---

MIXTRAL_8X7B = register(ModelConfig(
    name="mixtral-8x7b-instruct", vocab_size=32_000, num_layers=32,
    embed_dim=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    mlp_dim=14_336, max_seq_len=8192, rope_theta=1_000_000.0,
    norm_eps=1e-5, tie_embeddings=False,
    num_experts=8, num_experts_per_tok=2))

# --- tiny presets: CPU tests ---

TINY_GEMMA = register(ModelConfig(
    name="tiny-gemma", vocab_size=512, num_layers=2, embed_dim=64,
    num_heads=4, num_kv_heads=2, head_dim=16, mlp_dim=128,
    max_seq_len=512, gelu_mlp=True, scale_embeddings=True,
    rmsnorm_unit_offset=True, tie_embeddings=True))

TINY_LLAMA = register(ModelConfig(
    name="tiny-llama", vocab_size=512, num_layers=2, embed_dim=64,
    num_heads=4, num_kv_heads=2, head_dim=16, mlp_dim=128,
    max_seq_len=512, tie_embeddings=False))

TINY_MISTRAL = register(ModelConfig(
    name="tiny-mistral", vocab_size=512, num_layers=2, embed_dim=64,
    num_heads=4, num_kv_heads=2, head_dim=16, mlp_dim=128,
    max_seq_len=512, sliding_window=64, tie_embeddings=False))

TINY_QWEN = register(ModelConfig(
    name="tiny-qwen", vocab_size=512, num_layers=2, embed_dim=64,
    num_heads=4, num_kv_heads=2, head_dim=16, mlp_dim=128,
    max_seq_len=512, attn_bias=True, tie_embeddings=True))

TINY_MIXTRAL = register(ModelConfig(
    name="tiny-mixtral", vocab_size=512, num_layers=2, embed_dim=64,
    num_heads=4, num_kv_heads=2, head_dim=16, mlp_dim=128,
    max_seq_len=512, tie_embeddings=False,
    num_experts=4, num_experts_per_tok=2))


def get_model_config(name: str, **overrides) -> ModelConfig:
    """Look up a family by name; unknown names raise with the known list."""
    if name not in _REGISTRY:
        known = ", ".join(sorted(_REGISTRY))
        raise ValueError(f"Unknown model '{name}'. Known: {known}")
    cfg = _REGISTRY[name]
    if overrides:
        import dataclasses
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def list_models() -> list[str]:
    return sorted(_REGISTRY)
