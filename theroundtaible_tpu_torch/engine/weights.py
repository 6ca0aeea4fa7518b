"""Weight bridge: a JAX-package parameter tree, as numpy arrays, into the
port's parameter dict - the same nested structure and axis layouts
(q_proj [E,H,D], k_proj/v_proj [E,K,D], o_proj [H,D,E], gate/up [E,F],
down [F,E], embedding/lm_head [V,E], biases, norms). With the same weights
both packages compute the same function, which is how the tests compare
them: the two packages cannot share a random stream."""

from __future__ import annotations

import numpy as np
import torch

from .models.common import ModelConfig, Params


def expected_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Shape of every per-layer leaf the port reads, by name."""
    e, h, k, d, f = (cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim, cfg.mlp_dim)
    shapes = {"q_proj": (e, h, d), "k_proj": (e, k, d), "v_proj": (e, k, d),
              "o_proj": (h, d, e), "input_norm": (e,), "pre_mlp_norm": (e,),
              "gate_proj": (e, f), "up_proj": (e, f), "down_proj": (f, e)}
    if cfg.attn_bias:
        shapes.update(q_bias=(h, d), k_bias=(k, d), v_bias=(k, d))
    if cfg.post_attn_norm:
        shapes["post_attn_norm"] = (e,)
    if cfg.post_mlp_norm:
        shapes["post_mlp_norm"] = (e,)
    return shapes


def _tensor(x, shape, name: str, dtype, device) -> torch.Tensor:
    arr = np.asarray(x)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(arr.shape)} != expected "
                         f"{tuple(shape)}")
    # via an f32 copy: numpy has no bfloat16 torch.from_numpy accepts, and
    # jax.device_get hands out read-only arrays
    return torch.from_numpy(np.array(arr, np.float32)).to(
        device=device, dtype=dtype)


def params_from_numpy(tree: dict, cfg: ModelConfig, dtype=torch.bfloat16,
                      device="cpu") -> Params:
    """The port's parameters from `jax.device_get(engine.params)`. Raises
    on a missing leaf or a shape that disagrees with `cfg`."""
    if cfg.num_experts:
        raise NotImplementedError(
            "MoE weights are not ported yet (ROADMAP, slice 7)")
    if len(tree["layers"]) != cfg.num_layers:
        raise ValueError(f"tree has {len(tree['layers'])} layers, config "
                         f"{cfg.num_layers}")
    vocab = (cfg.vocab_size, cfg.embed_dim)
    out: Params = {
        "embedding": _tensor(tree["embedding"], vocab, "embedding", dtype,
                             device),
        "final_norm": _tensor(tree["final_norm"], (cfg.embed_dim,),
                              "final_norm", dtype, device),
        "layers": [],
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = _tensor(tree["lm_head"], vocab, "lm_head", dtype,
                                 device)
    for i, layer in enumerate(tree["layers"]):
        out["layers"].append({
            name: _tensor(layer[name], shape, f"layers[{i}].{name}", dtype,
                          device)
            for name, shape in expected_shapes(cfg).items()})
    return out
