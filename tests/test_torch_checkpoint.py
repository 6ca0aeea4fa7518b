"""PyTorch port, checkpoint load: engine/checkpoint.py and
native/loader.py against the JAX package's load_hf_checkpoint and against
transformers, on tiny random HF checkpoints that transformers writes with
save_pretrained (Llama, Qwen2 with q/k/v biases, Mistral with a sliding
window, Gemma, and a Llama-3.2 shape: D=64, tied embeddings).

- Every leaf of the port's load equals the JAX loader's bit for bit, for
  single-file and sharded safetensors, f32 and bf16 checkpoints, and
  pytorch_model.bin; also with the `safetensors` and `transformers`
  packages unimportable.
- Logits of the port's forward on its load are within LOGIT_ATOL (f32) of
  the JAX forward on the JAX load and of transformers' own; the port
  engine built from `checkpoint=` decodes transformers' greedy tokens.
- Errors name the tensor or file; a MoE checkpoint raises naming its
  ROADMAP item; save_native/restore_native round-trip bit for bit; int8
  and int4 engines from a checkpoint hold quantize_params of the loaded
  tree, and a TP=2 engine on gloo decodes the one-device engine's tokens.
- chip_smoke.write_hf_checkpoint (the chip's hand-written HF shards) reads
  back through safetensors.safe_open and LlamaForCausalLM.from_pretrained
  to the same tensors and logits as through the port's loader.

This module imports only torch and numpy at its top, so the spawned TP
ranks never import jax; the JAX package and transformers are imported
inside the tests."""

import copy
import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from theroundtaible_tpu_torch.engine import checkpoint as ckpt_mod
from theroundtaible_tpu_torch.engine import distributed
from theroundtaible_tpu_torch.engine.checkpoint import (
    detect_config_from_hf, load_hf_checkpoint, restore_native, save_native)
from theroundtaible_tpu_torch.engine.engine import InferenceEngine
from theroundtaible_tpu_torch.engine.models.common import (Int4Leaf,
                                                           ModelConfig)
from theroundtaible_tpu_torch.engine.sampling import SamplingParams
from theroundtaible_tpu_torch.native import loader

ROOT = Path(__file__).resolve().parents[1]
LOGIT_ATOL = 1e-4
PROMPT_IDS = [1, 17, 93, 5, 42, 8, 61, 29, 3, 77, 12, 50]
DECODE_STEPS = 8
SPAWN_TIMEOUT_S = 300.0
VOCAB = 128

# Each family: (transformers config class, its kwargs, the port's config
# kwargs). The JAX package's ModelConfig takes the same kwargs.
_BASE = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, max_position_embeddings=256,
             rms_norm_eps=1e-6, rope_theta=10_000.0, bos_token_id=1,
             eos_token_id=2, pad_token_id=0)
_CFG = dict(vocab_size=VOCAB, num_layers=2, embed_dim=64, mlp_dim=128,
            max_seq_len=256)
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(
        _BASE, num_attention_heads=4, num_key_value_heads=2,
        tie_word_embeddings=False), dict(
        _CFG, num_heads=4, num_kv_heads=2, head_dim=16,
        tie_embeddings=False)),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", dict(
        _BASE, num_attention_heads=4, num_key_value_heads=2,
        tie_word_embeddings=False, use_sliding_window=False,
        attn_implementation="eager"), dict(
        _CFG, num_heads=4, num_kv_heads=2, head_dim=16, attn_bias=True,
        tie_embeddings=False)),
    "mistral": ("MistralConfig", "MistralForCausalLM", dict(
        _BASE, num_attention_heads=4, num_key_value_heads=2,
        sliding_window=8, tie_word_embeddings=False,
        attn_implementation="eager"), dict(
        _CFG, num_heads=4, num_kv_heads=2, head_dim=16, sliding_window=8,
        tie_embeddings=False)),
    "gemma": ("GemmaConfig", "GemmaForCausalLM", dict(
        _BASE, num_attention_heads=4, num_key_value_heads=1, head_dim=16,
        hidden_act="gelu_pytorch_tanh", tie_word_embeddings=True,
        attention_bias=False), dict(
        _CFG, num_heads=4, num_kv_heads=1, head_dim=16, gelu_mlp=True,
        scale_embeddings=True, rmsnorm_unit_offset=True,
        tie_embeddings=True)),
    # Llama-3.2's shape: head_dim 64, tied embeddings.
    "llama32": ("LlamaConfig", "LlamaForCausalLM", dict(
        _BASE, hidden_size=128, num_attention_heads=2,
        num_key_value_heads=1, head_dim=64, tie_word_embeddings=True),
        dict(_CFG, embed_dim=128, num_heads=2, num_kv_heads=1,
             head_dim=64, tie_embeddings=True)),
}
FORMS = ("single_f32", "sharded_f32", "single_bf16", "bin_f32")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(family: str) -> ModelConfig:
    return ModelConfig(name=f"ckpt-{family}", **FAMILIES[family][3])


def jax_config(family: str):
    from theroundtaible_tpu.engine.models.common import \
        ModelConfig as JaxConfig
    return JaxConfig(name=f"ckpt-{family}", **FAMILIES[family][3])


def hf_model(family: str, seed: int = 0):
    import transformers
    cfg_cls, model_cls, kwargs, _ = FAMILIES[family]
    torch.manual_seed(seed)
    model = getattr(transformers, model_cls)(
        getattr(transformers, cfg_cls)(**kwargs))
    return model.eval()


def save_form(model, path: Path, form: str) -> Path:
    """Save `model` as `form` into `path` (transformers' own writer)."""
    if form.endswith("bf16"):
        model = copy.deepcopy(model).to(torch.bfloat16)
    if form.startswith("bin"):
        model.save_pretrained(path, safe_serialization=False)
    elif form.startswith("sharded"):
        model.save_pretrained(path, safe_serialization=True,
                              max_shard_size="40KB")
        assert len(list(path.glob("*.safetensors"))) > 2
    else:
        model.save_pretrained(path, safe_serialization=True)
    return path


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """family -> (the transformers model in f32, {form: directory})."""
    out = {}
    for family in FAMILIES:
        model = hf_model(family, seed=len(out))
        base = tmp_path_factory.mktemp(f"ckpt-{family}")
        out[family] = (model, {form: save_form(model, base / form, form)
                               for form in FORMS})
    return out


def leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_tree_equal_jax(port, jax_tree):
    """Every leaf of the port's tree equals the JAX tree's bit for bit
    (compared in f32, exact for f32, bf16 and f16 leaves)."""
    got = dict(leaves(port))
    want = dict(leaves(jax_tree))
    assert got.keys() == want.keys()
    for name, w in want.items():
        w = np.asarray(w.astype(np.float32) if hasattr(w, "astype") else w,
                       np.float32)
        g = got[name].to(torch.float32).numpy()
        assert g.shape == w.shape, name
        assert np.array_equal(g, w), name


def assert_trees_identical(a, b):
    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys()
    for name in la:
        x, y = la[name], lb[name]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        else:
            assert x == y, name


# --- (a) every family, every form ---


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_leaves_equal_jax_loader(checkpoints, family, form):
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.checkpoint import \
        load_hf_checkpoint as jax_load
    d = checkpoints[family][1][form]
    for tdtype, jdtype in ((torch.float32, jnp.float32),
                           (torch.bfloat16, jnp.bfloat16)):
        port = load_hf_checkpoint(d, port_config(family), tdtype, "cpu")
        assert all(t.dtype == tdtype for _, t in leaves(port))
        assert_tree_equal_jax(port, jax_load(d, jax_config(family), jdtype))


def test_bin_and_safetensors_hold_the_same_tensors(checkpoints):
    forms = checkpoints["mistral"][1]
    from_bin = dict(ckpt_mod._iter_hf_tensors(forms["bin_f32"]))
    from_st = dict(ckpt_mod._iter_hf_tensors(forms["sharded_f32"]))
    assert from_bin.keys() == from_st.keys()
    for name, t in from_st.items():
        assert torch.equal(t, from_bin[name]), name


def port_logits(params, cfg, ids):
    from theroundtaible_tpu_torch.engine.models.common import forward
    t = len(ids)
    with torch.no_grad():
        logits, _ = forward(params, cfg, torch.tensor([ids]),
                            torch.arange(t)[None, :], None, None,
                            torch.tensor([t], dtype=torch.int32))
    return logits[0].numpy()


def engine_tokens(ckpt_dir, cfg, **kw):
    """The port engine from `checkpoint=`: the greedy tokens its slot
    record holds after the prompt (every generated token but the last,
    which is never fed back), up to eos, exclusive."""
    eng = InferenceEngine(
        cfg, checkpoint=str(ckpt_dir), num_slots=2, kv_layout="paged",
        page_size=16, dtype=kw.pop("dtype", torch.float32),
        sampling=SamplingParams(temperature=0.0,
                                max_new_tokens=DECODE_STEPS),
        device="cpu", **kw)
    eng.generate_batch([("s", list(PROMPT_IDS))],
                       max_new_tokens=DECODE_STEPS)
    return _until_eos(eng.kv._slots["s"].tokens[len(PROMPT_IDS):]), eng


def _until_eos(tokens, eos=2):
    tokens = list(tokens)
    return tokens[:tokens.index(eos)] if eos in tokens else tokens


@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_and_greedy_tokens(checkpoints, family):
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.checkpoint import \
        load_hf_checkpoint as jax_load
    from theroundtaible_tpu.engine.models.common import forward as jforward
    model, forms = checkpoints[family]
    d = forms["single_f32"]
    cfg = port_config(family)
    ours = port_logits(load_hf_checkpoint(d, cfg, torch.float32, "cpu"),
                       cfg, PROMPT_IDS)
    jparams = jax_load(d, jax_config(family), jnp.float32)
    t = len(PROMPT_IDS)
    jlogits, _ = jforward(jparams, jax_config(family),
                          jnp.asarray([PROMPT_IDS], jnp.int32),
                          jnp.arange(t)[None, :], None, None,
                          jnp.asarray([t], jnp.int32))
    with torch.no_grad():
        ref = model(torch.tensor([PROMPT_IDS])).logits[0].float().numpy()
    np.testing.assert_allclose(ours, np.asarray(jlogits[0]),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(ours, ref, atol=LOGIT_ATOL, rtol=0)
    with torch.no_grad():
        hf_seq = model.generate(
            torch.tensor([PROMPT_IDS]), max_new_tokens=DECODE_STEPS,
            do_sample=False).numpy()[0].tolist()[len(PROMPT_IDS):]
    tokens, _ = engine_tokens(d, cfg)
    want = _until_eos(hf_seq)
    assert len(tokens) >= min(len(want), DECODE_STEPS - 1)
    assert tokens == want[:len(tokens)]


def test_engine_tokens_equal_jax_engine(checkpoints):
    """The JAX engine and the port engine, each built from the same
    checkpoint directory, decode the same greedy tokens."""
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
    from theroundtaible_tpu.engine.sampling import \
        SamplingParams as JaxSampling
    d = checkpoints["llama"][1]["sharded_f32"]
    jeng = JaxEngine(jax_config("llama"), checkpoint=str(d),
                     mesh_shape={"data": 1, "model": 1}, num_slots=2,
                     kv_layout="paged", page_size=16, dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0,
                                          max_new_tokens=DECODE_STEPS),
                     prefix_cache=False, kv_offload=False,
                     ragged_attn=False, spec_decode=False)
    jeng.generate_batch([("s", list(PROMPT_IDS))],
                        max_new_tokens=DECODE_STEPS)
    want = _until_eos(jeng.kv._slots["s"].tokens[len(PROMPT_IDS):])
    tokens, _ = engine_tokens(d, port_config("llama"))
    assert tokens == want


# --- (b) without the safetensors and transformers packages ---


@pytest.mark.parametrize("form", ("single_f32", "sharded_f32",
                                  "single_bf16"))
def test_loads_without_safetensors_or_transformers(checkpoints, monkeypatch,
                                                   form):
    """As on the chip machine: neither package can be imported. The load
    and an engine built from a weight-only checkpoint (byte tokenizer)
    still work and give the same tree."""
    d = checkpoints["qwen2"][1][form]
    cfg = port_config("qwen2")
    with_pkgs = load_hf_checkpoint(d, cfg, torch.float32, "cpu")
    for name in [m for m in sys.modules
                 if m.split(".")[0] in ("safetensors", "transformers")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        import safetensors  # noqa: F401
    assert_trees_identical(load_hf_checkpoint(d, cfg, torch.float32, "cpu"),
                           with_pkgs)
    tokens, eng = engine_tokens(d, cfg)
    assert type(eng.tokenizer).__name__ == "ByteTokenizer"
    assert len(tokens) > 0


# --- (c) errors, MoE, config, native round trip, quant and TP ---


def _write_safetensors(path: Path, tensors: dict, header_edit=None,
                       cut: int = 0):
    header, offset, blob = {}, 0, b""
    for name, arr in tensors.items():
        raw = np.ascontiguousarray(arr, np.float32).tobytes()
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blob += raw
    if header_edit:
        header_edit(header)
    head = json.dumps(header).encode()
    data = struct.pack("<Q", len(head)) + head + blob
    path.write_bytes(data[:len(data) - cut] if cut else data)


def _state(model):
    return {k: v.detach().float().numpy()
            for k, v in model.state_dict().items()}


def test_incomplete_checkpoint_names_the_missing_leaf(checkpoints,
                                                      tmp_path):
    state = _state(checkpoints["llama"][0])
    del state["model.layers.1.mlp.up_proj.weight"]
    _write_safetensors(tmp_path / "model.safetensors", state)
    with pytest.raises(ValueError, match=r"missing.*layer1:up_proj"):
        load_hf_checkpoint(tmp_path, port_config("llama"), torch.float32,
                           "cpu")


def test_shape_that_does_not_fit_names_tensor_and_file(checkpoints,
                                                       tmp_path):
    import dataclasses
    _write_safetensors(tmp_path / "model.safetensors",
                       _state(checkpoints["llama"][0]))
    cfg = dataclasses.replace(port_config("llama"), mlp_dim=96)
    with pytest.raises(ValueError, match=r"gate_proj\.weight in .*"
                       r"model\.safetensors: shape \(128, 64\)"):
        load_hf_checkpoint(tmp_path, cfg, torch.float32, "cpu")


def test_truncated_file_names_the_file(checkpoints, tmp_path):
    _write_safetensors(tmp_path / "model.safetensors",
                       _state(checkpoints["llama"][0]), cut=100)
    with pytest.raises(ValueError, match=r"model\.safetensors: tensor "
                       r".* past the end of the file"):
        load_hf_checkpoint(tmp_path, port_config("llama"), torch.float32,
                           "cpu")
    short = tmp_path / "x" / "model.safetensors"
    short.parent.mkdir()
    short.write_bytes(b"\x04")
    with pytest.raises(ValueError, match=r"x/model\.safetensors: "
                       r"truncated"):
        loader.read_header(short)


def test_offsets_that_disagree_with_the_shape_are_rejected(tmp_path):
    """As JAX tests/test_native.py: the reader must never read the next
    tensor's bytes as this one's tail."""
    def shrink(header):
        header["w"]["data_offsets"] = [0, 32]
    p = tmp_path / "bad.safetensors"
    _write_safetensors(p, {"w": np.zeros(16, np.float32)},
                       header_edit=shrink)
    with pytest.raises(ValueError, match=r"bad\.safetensors: tensor w: "
                       r"data_offsets 0:32 disagree"):
        loader.read_header(p)
    with pytest.raises(FileNotFoundError):
        loader.read_header(tmp_path / "absent.safetensors")


def test_reader_dtypes_views_and_alignment(tmp_path):
    """Every dtype comes back as stored; an aligned tensor is a view of
    the map, a misaligned one an aligned copy."""
    header, blob = {}, b""
    arrays = {"a8": np.arange(3, dtype=np.int8),
              "f32": np.arange(5, dtype=np.float32) / 3,
              "i64": np.arange(4, dtype=np.int64) - 2}
    kinds = {"a8": "I8", "f32": "F32", "i64": "I64"}
    for name, arr in arrays.items():
        raw = arr.tobytes()
        header[name] = {"dtype": kinds[name], "shape": list(arr.shape),
                        "data_offsets": [len(blob), len(blob) + len(raw)]}
        blob += raw
    bf = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    raw = bf.view(torch.uint8).numpy().tobytes()
    header["bf16"] = {"dtype": "BF16", "shape": [2],
                      "data_offsets": [len(blob), len(blob) + len(raw)]}
    blob += raw
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    p = tmp_path / "m.safetensors"
    p.write_bytes(struct.pack("<Q", len(head)) + head + blob)
    reader = loader.SafetensorsReader(loader.read_header(p))
    got = {name: reader.get(name) for name in reader.index}
    for name, arr in arrays.items():
        assert np.array_equal(got[name].numpy(), arr), name
    assert torch.equal(got["bf16"], bf)
    assert got["f32"].dtype == torch.float32   # offset 3: misaligned


def _live_maps(files) -> int:
    """How many of `files` the process has mapped now."""
    text = Path("/proc/self/maps").read_text()
    return sum(text.count(str(f)) for f in files)


def test_reader_unmaps_each_tensor_once_it_is_dropped(checkpoints,
                                                      monkeypatch):
    """A tensor's map lives as long as the tensor; the loader drops each
    source tensor once copied, so no shard is mapped when the next
    tensor is read, nor after the load."""
    import gc
    d = checkpoints["llama"][1]["sharded_f32"]
    files = sorted(d.glob("*.safetensors"))
    reader = loader.SafetensorsReader(loader.index_safetensors(files))
    name = "model.layers.0.mlp.up_proj.weight"
    t = reader.get(name)
    assert _live_maps(files) == 1
    del t
    gc.collect()
    assert _live_maps(files) == 0

    live = []
    real_get = ckpt_mod._Source.get

    def get(self, n):
        live.append(_live_maps(files))
        return real_get(self, n)
    monkeypatch.setattr(ckpt_mod._Source, "get", get)
    load_hf_checkpoint(d, port_config("llama"), torch.float32, "cpu")
    assert len(live) > 10 and max(live) == 0
    assert _live_maps(files) == 0


def test_moe_checkpoint_and_config_raise_naming_the_item(tmp_path):
    """A Mixtral checkpoint raised NotImplementedError until item 7e-i:
    now a dense config over it raises the JAX loader's missing-tensor error
    (its block_sparse_moe tensors feed no dense leaf) and a MoE config
    loads it as the JAX loader does (tests/test_torch_moe.py holds the
    layout leaf by leaf)."""
    import jax.numpy as jnp
    import transformers
    from theroundtaible_tpu.engine.checkpoint import \
        load_hf_checkpoint as jax_load
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    torch.manual_seed(0)
    hf = transformers.MixtralForCausalLM(transformers.MixtralConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
        num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=2, num_experts_per_tok=1,
        max_position_embeddings=256))
    hf.save_pretrained(tmp_path, safe_serialization=True)
    with pytest.raises(ValueError, match="Checkpoint incomplete"):
        load_hf_checkpoint(tmp_path, port_config("llama"), torch.float32,
                           "cpu")
    import dataclasses
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    over = dict(num_layers=1, num_experts=2, num_experts_per_tok=1,
                vocab_size=VOCAB)
    cfg = dataclasses.replace(get_model_config("tiny-mixtral"), **over)
    ours = load_hf_checkpoint(tmp_path, cfg, torch.float32, "cpu")
    theirs = jax_load(tmp_path, dataclasses.replace(
        jax_config("tiny-mixtral"), **over), jnp.float32)
    layer, ref = ours["layers"][0], theirs["layers"][0]
    np.testing.assert_array_equal(layer["router"].numpy(),
                                  np.asarray(ref["router"]))
    for k, v in ref["experts"].items():
        np.testing.assert_array_equal(layer["experts"][k].numpy(),
                                      np.asarray(v), k)


def test_detect_config_from_hf(checkpoints, tmp_path):
    from theroundtaible_tpu.engine.checkpoint import \
        detect_config_from_hf as jax_detect
    d = checkpoints["gemma"][1]["single_f32"]
    got = detect_config_from_hf(d)
    assert got == jax_detect(d)
    assert got["model_type"] == "gemma" and got["head_dim"] == 16
    assert detect_config_from_hf(tmp_path) == {}


@pytest.mark.parametrize("quant", ("none", "int8", "int4"))
def test_native_round_trip(checkpoints, tmp_path, quant):
    cfg = port_config("llama")
    d = checkpoints["llama"][1]["single_f32"]
    eng = InferenceEngine(cfg, checkpoint=str(d), num_slots=2,
                          kv_layout="paged", page_size=16,
                          dtype=torch.float32, quant=quant, device="cpu")
    save_native(tmp_path / "tree.pt", eng.params)
    back = restore_native(tmp_path / "tree.pt", cfg, device="cpu")
    assert_trees_identical(_int4_fields(back), _int4_fields(eng.params))
    plans = [x.plan for _, x in _int4_leaves(back)]
    assert all(p is not None for p in plans)
    assert bool(plans) == (quant == "int4")


def _int4_leaves(tree):
    if isinstance(tree, Int4Leaf):
        yield None, tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _int4_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _int4_leaves(v)


def _int4_fields(tree):
    """An Int4Leaf as the dict of its stored fields (its plan is derived,
    not stored)."""
    if isinstance(tree, Int4Leaf):
        return {"q4": tree.q4, "s4": tree.s4, "axis": tree.axis,
                "group": tree.group}
    if isinstance(tree, dict):
        return {k: _int4_fields(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_int4_fields(v) for v in tree]
    return tree


@pytest.mark.parametrize("quant", ("int8", "int4"))
def test_quantized_load_is_quantize_params_of_the_load(checkpoints, quant):
    """Each layer quantized whole as it is read gives the tree
    quantize_params gives the whole loaded tree, and the same tokens."""
    from theroundtaible_tpu_torch.engine.quant import quantize_params
    cfg = port_config("llama")
    d = checkpoints["llama"][1]["single_bf16"]
    tokens, eng = engine_tokens(d, cfg, dtype=torch.bfloat16, quant=quant)
    dense = load_hf_checkpoint(d, cfg, torch.bfloat16, "cpu")
    want = quantize_params(dense, cfg, act_dtype=torch.bfloat16,
                           bits=8 if quant == "int8" else 4)
    assert_trees_identical(_int4_fields(eng.params), _int4_fields(want))
    ref = InferenceEngine(cfg, num_slots=2, kv_layout="paged", page_size=16,
                          dtype=torch.bfloat16, quant=quant, params=want,
                          sampling=SamplingParams(
                              temperature=0.0, max_new_tokens=DECODE_STEPS),
                          device="cpu")
    ref.generate_batch([("s", list(PROMPT_IDS))],
                       max_new_tokens=DECODE_STEPS)
    assert tokens == _until_eos(ref.kv._slots["s"].tokens[len(PROMPT_IDS):])


def test_load_streams_one_layer_at_a_time(checkpoints, monkeypatch):
    """Every tensor of layer i is read after layer i-1 was handed to the
    keep pipeline and before layer i is: one whole layer in flight."""
    events = []
    real_get = ckpt_mod._Source.get
    real_keeper = ckpt_mod.leaf_keeper

    def get(self, name):
        events.append(("read", name))
        return real_get(self, name)

    def keeper(cfg, mesh=None, quantize=None):
        keep, specs = real_keeper(cfg, mesh, quantize)

        def recording(tree, spec):
            events.append(("keep", tuple(tree)))
            return keep(tree, spec)
        return recording, specs

    monkeypatch.setattr(ckpt_mod._Source, "get", get)
    monkeypatch.setattr(ckpt_mod, "leaf_keeper", keeper)
    cfg = port_config("llama")
    load_hf_checkpoint(checkpoints["llama"][1]["sharded_f32"], cfg,
                       torch.float32, "cpu")
    groups, current = [], []
    for kind, what in events:
        if kind == "read":
            current.append(what)
        else:
            groups.append((what, current))
            current = []
    layer_groups = [names for keys, names in groups if "q_proj" in keys]
    assert len(layer_groups) == cfg.num_layers
    for i, names in enumerate(layer_groups):
        assert names and all(n.startswith(f"model.layers.{i}.")
                             for n in names), names


def _tp_rank(rank, ckpt_dir, cfg_kwargs, quants):
    """One rank of a {"data": 1, "model": 2} engine built from
    `checkpoint=` per quant mode: its greedy tokens."""
    cfg = ModelConfig(name="ckpt-tp", **cfg_kwargs)
    out = {}
    for quant in quants:
        eng = InferenceEngine(
            cfg, checkpoint=ckpt_dir, mesh_shape={"data": 1, "model": 2},
            num_slots=2, kv_layout="paged", page_size=16,
            dtype=torch.bfloat16 if quant != "none" else torch.float32,
            quant=quant, sampling=SamplingParams(
                temperature=0.0, max_new_tokens=DECODE_STEPS),
            device="cpu")
        eng.generate_batch([("s", list(PROMPT_IDS))],
                           max_new_tokens=DECODE_STEPS)
        out[quant] = list(eng.kv._slots["s"].tokens[len(PROMPT_IDS):])
    return out


def test_tp_engines_from_a_checkpoint_decode_the_one_device_tokens(
        checkpoints):
    d = checkpoints["llama"][1]["sharded_f32"]
    quants = ("none", "int8", "int4")
    ranks = distributed.launch(_tp_rank, 2, "gloo", "cpu",
                               args=(str(d), FAMILIES["llama"][3], quants),
                               timeout_s=SPAWN_TIMEOUT_S)
    cfg = port_config("llama")
    for quant in quants:
        dtype = torch.bfloat16 if quant != "none" else torch.float32
        want, _ = engine_tokens(d, cfg, dtype=dtype, quant=quant)
        for r in ranks:
            assert _until_eos(r[quant]) == want, quant


# --- (d) the tokenizer of a checkpoint ---


def test_trained_tokenizer_checkpoint_matches_jax_engine(tmp_path):
    import jax.numpy as jnp
    from conftest import make_tiny_hf_llama, save_trained_tokenizer
    from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_registry
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    save_trained_tokenizer(tmp_path)
    make_tiny_hf_llama(512, seed=3).save_pretrained(
        tmp_path, safe_serialization=True)
    eng = InferenceEngine(get_model_config("tiny-llama"),
                          checkpoint=str(tmp_path), num_slots=2,
                          dtype=torch.float32, device="cpu")
    jeng = JaxEngine(jax_registry("tiny-llama"), checkpoint=str(tmp_path),
                     num_slots=2, dtype=jnp.float32, prefix_cache=False,
                     kv_offload=False, spec_decode=False)
    assert type(eng.tokenizer).__name__ == "HfTokenizer"
    text = "the knights debate the session store design at the roundtable"
    ids = eng.tokenizer.encode(text)
    assert ids == jeng.tokenizer.encode(text)
    assert eng.tokenizer.decode(ids) == jeng.tokenizer.decode(ids)
    for attr in ("bos_id", "eos_id", "pad_id", "vocab_size"):
        assert getattr(eng.tokenizer, attr) == getattr(jeng.tokenizer, attr)


def test_broken_tokenizer_files_raise(checkpoints, tmp_path):
    import shutil
    d = tmp_path / "ckpt"
    shutil.copytree(checkpoints["llama"][1]["single_f32"], d)
    (d / "tokenizer.json").write_text("{not json")
    with pytest.raises(RuntimeError, match="tokenizer files"):
        InferenceEngine(port_config("llama"), checkpoint=str(d),
                        num_slots=2, dtype=torch.float32, device="cpu")


# --- (i) chip_smoke's hand-written HF checkpoint ---


def test_chip_smoke_writer_reads_back_through_safetensors_and_hf(tmp_path):
    """chip_smoke.write_hf_checkpoint at tiny width: safetensors.safe_open
    and LlamaForCausalLM.from_pretrained read the port loader's tensors
    and logits, so the chip phase cannot pass on a writer and a reader
    that agree on a wrong format."""
    from safetensors import safe_open
    from transformers import LlamaForCausalLM
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from theroundtaible_tpu_torch.engine.models.common import init_params
    cfg = port_config("llama")
    params = init_params(cfg, torch.Generator().manual_seed(5),
                         torch.bfloat16, "cpu")
    written = chip_smoke.write_hf_checkpoint(torch, params, cfg, tmp_path)
    shards = sorted(tmp_path.glob("*.safetensors"))
    assert len(shards) == 4
    index = json.loads((tmp_path / "model.safetensors.index.json")
                       .read_text())
    assert index["metadata"]["total_size"] == written
    by_name = dict(chip_smoke.hf_tensors(torch, params, cfg))
    seen = set()
    for shard in shards:
        with safe_open(str(shard), framework="pt") as f:
            for name in f.keys():
                assert index["weight_map"][name] == shard.name
                assert torch.equal(f.get_tensor(name), by_name[name]), name
                seen.add(name)
    assert seen == set(by_name)
    loaded = load_hf_checkpoint(tmp_path, cfg, torch.bfloat16, "cpu")
    assert_trees_identical(loaded, params)
    hf = LlamaForCausalLM.from_pretrained(tmp_path,
                                          torch_dtype=torch.float32).eval()
    f32 = load_hf_checkpoint(tmp_path, cfg, torch.float32, "cpu")
    with torch.no_grad():
        ref = hf(torch.tensor([PROMPT_IDS])).logits[0].numpy()
    np.testing.assert_allclose(port_logits(f32, cfg, PROMPT_IDS), ref,
                               atol=LOGIT_ATOL, rtol=0)
