"""Checkpoint loading: HuggingFace layouts -> the engine's param tree
(counterpart of theroundtaible_tpu/engine/checkpoint.py).

Reads safetensors shards (native/loader.py, the port's own reader: no
`safetensors` package needed) or torch `pytorch_model*.bin` shards from a
local directory, plus `torch.save` save/restore of the engine's own tree.

HF name map (all families), as in the JAX package:
  model.embed_tokens.weight                  -> embedding            [V, E]
  model.layers.N.self_attn.{q,k,v}_proj      -> {q,k,v}_proj         [E, H, D]
  model.layers.N.self_attn.{q,k,v}_proj.bias -> {q,k,v}_bias         [H, D]
  model.layers.N.self_attn.o_proj            -> o_proj               [H, D, E]
  model.layers.N.mlp.{gate,up,down}_proj     -> {gate,up,down}_proj
  model.layers.N.input_layernorm             -> input_norm
  model.layers.N.post_attention_layernorm    -> pre_mlp_norm
  model.layers.N.pre_feedforward_layernorm   -> pre_mlp_norm  (Gemma)
  model.layers.N.post_feedforward_layernorm  -> post_mlp_norm (Gemma)
  model.norm.weight                          -> final_norm
  lm_head.weight                             -> lm_head (untied only)
  model.layers.N.block_sparse_moe.gate       -> router [E, X] (Mixtral)
  model.layers.N.block_sparse_moe.experts.M.{w1,w3,w2}
                                             -> experts.{gate,up,down}_proj
                                                stacked on a leading expert
                                                axis: [X, E, F], [X, F, E]
Other names (rotary_emb.inv_freq, layers beyond cfg.num_layers, an
lm_head of a tied model) are skipped, as the JAX loader skips them.

Values go source dtype -> float32 -> `dtype`, as the JAX loader's
float32 reader does, so a bf16 or f16 checkpoint gives its bits.

Memory: the JAX loader assembles the whole tree on the host. Here the
shards are indexed from their headers first, then the model is assembled
one layer at a time through models/common.leaf_keeper - the pipeline
init_params draws its random layers through: a whole layer is read (each
tensor a view of its own map of the file, unmapped once copied out),
moved to `device` and cast there, quantized whole when
`quantize` is bound, and under a mesh cut to this rank's slices, before
the next layer is read. No rank holds more than one whole layer beyond
its shard, and every scale equals the one the whole leaf gives on one
device.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

import torch

from ..native.loader import SafetensorsReader, index_safetensors
from .device import resolve_device
from .models.common import (EXPERTS, Int4Leaf, ModelConfig, Params,
                            flat_layer, leaf_keeper, nest_layer,
                            stage_keeps)

_LAYER = re.compile(r"model\.layers\.(\d+)\.(.+)")


class _Source:
    """name -> tensor over a checkpoint directory's shards, indexed from
    the safetensors headers (or the lazily mapped .bin state dicts), so
    tensors can be read in any order."""

    def __init__(self, ckpt_dir: Path):
        st_files = sorted(ckpt_dir.glob("*.safetensors"))
        self._reader = None
        self._state: dict[str, torch.Tensor] = {}
        self.where: dict[str, Path] = {}
        if st_files:
            self._reader = SafetensorsReader(index_safetensors(st_files))
            self.where = {n: e.path for n, e in self._reader.index.items()}
            return
        bin_files = sorted(ckpt_dir.glob("pytorch_model*.bin"))
        if not bin_files:
            raise FileNotFoundError(
                f"No *.safetensors or pytorch_model*.bin in {ckpt_dir}")
        for f in bin_files:
            state = torch.load(str(f), map_location="cpu",
                               weights_only=True, mmap=True)
            for name, tensor in state.items():
                self._state[name] = tensor
                self.where[name] = f

    def names(self) -> list[str]:
        return list(self.where)

    def get(self, name: str) -> torch.Tensor:
        if self._reader is not None:
            return self._reader.get(name)
        return self._state[name]



def _iter_hf_tensors(ckpt_dir: str | Path
                     ) -> Iterator[tuple[str, torch.Tensor]]:
    """(name, tensor) of every tensor of the checkpoint, in the shards'
    order, each in its stored dtype (a view of the file where it can
    be)."""
    src = _Source(Path(ckpt_dir))
    for name in src.names():
        yield name, src.get(name)


def _hf_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The stored HF shape of each per-layer leaf, by our name."""
    e, h, k, d, f = (cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim, cfg.mlp_dim)
    return {"q_proj": (h * d, e), "k_proj": (k * d, e), "v_proj": (k * d, e),
            "o_proj": (e, h * d), "gate_proj": (f, e), "up_proj": (f, e),
            "down_proj": (e, f), "q_bias": (h * d,), "k_bias": (k * d,),
            "v_bias": (k * d,), "input_norm": (e,), "pre_mlp_norm": (e,),
            "post_mlp_norm": (e,), "router": (cfg.num_experts or 0, e),
            "experts.gate_proj": (f, e), "experts.up_proj": (f, e),
            "experts.down_proj": (e, f)}

# Mixtral's expert matrices: w1 gate, w3 up, w2 down.
_EXPERT_NAMES = {"w1": "gate_proj", "w3": "up_proj", "w2": "down_proj"}


def _moe_key(rest: str, cfg: ModelConfig
             ) -> Optional[tuple[str, Optional[int]]]:
    """(our flat_layer name, expert index or None) for a
    `block_sparse_moe.` name after `model.layers.N.` (None: skipped);
    raises on an expert index at or beyond cfg.num_experts (JAX
    l.122-128)."""
    parts = rest.split(".")
    if parts[1] == "gate" and parts[-1] == "weight":
        return "router", None
    if parts[1] == "experts" and len(parts) >= 4:
        xi = int(parts[2])
        if xi >= cfg.num_experts:
            raise ValueError(
                f"Checkpoint has expert index {xi} but config {cfg.name} "
                f"expects {cfg.num_experts} experts — config/checkpoint "
                f"mismatch")
        tgt = _EXPERT_NAMES.get(parts[3])
        if tgt is not None and parts[-1] == "weight":
            return f"{EXPERTS}.{tgt}", xi
    return None


def _layer_key(rest: str) -> Optional[str]:
    """Our leaf name for the part of an HF layer name after
    `model.layers.N.`, or None for a name the loader skips."""
    parts = rest.split(".")
    if parts[0] == "self_attn" and len(parts) >= 2:
        key = parts[1]
        if key in ("q_proj", "k_proj", "v_proj"):
            if len(parts) > 2 and parts[2] == "bias":
                return key[0] + "_bias"
            return key if parts[-1] == "weight" else None
        if key == "o_proj" and parts[-1] == "weight":
            return key
        return None
    if parts[0] == "mlp" and len(parts) >= 2:
        if parts[1] in ("gate_proj", "up_proj", "down_proj") \
                and parts[-1] == "weight":
            return parts[1]
        return None
    return {"input_layernorm": "input_norm",
            "post_attention_layernorm": "pre_mlp_norm",
            "pre_feedforward_layernorm": "pre_mlp_norm",
            "post_feedforward_layernorm": "post_mlp_norm"}.get(parts[0])


def _plan(src: _Source, cfg: ModelConfig):
    """Which HF tensor feeds each leaf: (top, layers) name maps. Where
    two names feed one leaf (Gemma's post_attention_layernorm and
    pre_feedforward_layernorm), the later in the shards' header order
    wins, as in the JAX loader's stream. An expert stack maps to the
    list of its experts' names, by expert index (None where one is
    missing)."""
    top: dict[str, str] = {}
    layers: list[dict[str, Any]] = [{} for _ in range(cfg.num_layers)]
    for name in src.names():
        if name == "model.embed_tokens.weight":
            top["embedding"] = name
        elif name == "model.norm.weight":
            top["final_norm"] = name
        elif name == "lm_head.weight":
            if not cfg.tie_embeddings:
                top["lm_head"] = name
        else:
            m = _LAYER.fullmatch(name)
            if m is None:
                continue
            idx, rest = int(m.group(1)), m.group(2)
            if idx >= cfg.num_layers:
                continue
            if rest.startswith("block_sparse_moe."):
                # JAX reads these only for a MoE config
                found = _moe_key(rest, cfg) if cfg.num_experts \
                    else None
                if found is not None:
                    key, xi = found
                    if xi is None:
                        layers[idx][key] = name
                    else:
                        layers[idx].setdefault(
                            key, [None] * cfg.num_experts)[xi] = name
                continue
            key = _layer_key(rest)
            if key is not None:
                layers[idx][key] = name
    return top, layers


def _validate_loaded(top: dict, layers: list[dict],
                     cfg: ModelConfig) -> None:
    """The JAX loader's missing-tensor report, from the names alone,
    before anything is read."""
    missing = []
    if "embedding" not in top:
        missing.append("embedding")
    if "final_norm" not in top:
        missing.append("final_norm")
    if not cfg.tie_embeddings and "lm_head" not in top:
        missing.append("lm_head")
    required = {"q_proj", "k_proj", "v_proj", "o_proj", "input_norm",
                "pre_mlp_norm"}
    stacks = (f"{EXPERTS}.gate_proj", f"{EXPERTS}.up_proj",
              f"{EXPERTS}.down_proj")
    required |= ({"router", EXPERTS} if cfg.num_experts
                 else {"gate_proj", "up_proj", "down_proj"})
    if cfg.attn_bias:
        required |= {"q_bias", "k_bias", "v_bias"}
    for i, layer in enumerate(layers):
        names = set(layer) | ({EXPERTS} if any(k in layer for k in stacks)
                              else set())
        lacking = required - names
        if lacking:
            missing.append(f"layer{i}:{','.join(sorted(lacking))}")
        if cfg.num_experts and EXPERTS in names:
            # JAX l.175-184: each stack present and whole
            for key in stacks:
                stack = layer.get(key)
                if stack is None:
                    missing.append(f"layer{i}:{key}")
                    continue
                holes = [j for j, n in enumerate(stack) if n is None]
                if holes:
                    missing.append(f"layer{i}:{key}[{holes[:4]}]")
    if missing:
        raise ValueError(f"Checkpoint incomplete, missing: {missing[:8]}")


def load_hf_checkpoint(ckpt_dir: str | Path, cfg: ModelConfig,
                       dtype=torch.bfloat16, device="cuda", mesh=None,
                       quantize: Optional[Callable] = None,
                       stage=None) -> Params:
    """Assemble the engine's param tree from an HF checkpoint directory,
    one layer at a time (module docstring), on `device`: the card unless
    the caller passes device="cpu". `quantize` (engine/quant
    .quantize_leaves with its options bound), `mesh` and a pipeline
    `stage` (only the stage's tensors are read) act as they do in
    models/common.init_params. Raises ValueError on a missing tensor, a
    tensor whose shape does not fit `cfg` (naming it and its file), an
    expert index beyond cfg.num_experts or an unreadable file."""
    device = resolve_device(device)
    src = _Source(Path(ckpt_dir))
    top, layer_names = _plan(src, cfg)
    _validate_loaded(top, layer_names, cfg)
    keep, specs = leaf_keeper(cfg, mesh, quantize)
    e, h, k, d = cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hf_shapes = _hf_shapes(cfg)
    hf_shapes.update(embedding=(cfg.vocab_size, e),
                     lm_head=(cfg.vocab_size, e), final_norm=(e,))
    place: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
        "q_proj": lambda w: w.t().reshape(e, h, d),
        "k_proj": lambda w: w.t().reshape(e, k, d),
        "v_proj": lambda w: w.t().reshape(e, k, d),
        # HF o_proj.weight is [E, H*D] (out, in); ours is [H, D, E].
        "o_proj": lambda w: w.reshape(e, h, d).permute(1, 2, 0),
        "gate_proj": lambda w: w.t(),
        "up_proj": lambda w: w.t(),
        "down_proj": lambda w: w.t(),
        "q_bias": lambda w: w.reshape(h, d),
        "k_bias": lambda w: w.reshape(k, d),
        "v_bias": lambda w: w.reshape(k, d),
        "router": lambda w: w.t(),
        f"{EXPERTS}.gate_proj": lambda w: w.t(),
        f"{EXPERTS}.up_proj": lambda w: w.t(),
        f"{EXPERTS}.down_proj": lambda w: w.t(),
    }
    def leaf(key: str, name: str) -> torch.Tensor:
        raw = src.get(name)
        want = hf_shapes[key]
        if tuple(raw.shape) != want:
            raise ValueError(
                f"{name} in {src.where[name]}: shape {tuple(raw.shape)} "
                f"does not fit {cfg.name} (expected {want})")
        # a copy on the device (never a view of the file), then source
        # dtype -> float32 -> dtype there; a float source already in
        # `dtype` takes that round trip as the identity it is
        x = raw.to(device, copy=True)
        del raw   # unmaps the tensor's pages
        if x.dtype != dtype or not x.is_floating_point():
            x = x.to(torch.float32).to(dtype)
        if key in place:
            x = place[key](x)
        return x.contiguous()

    def group(names: dict[str, Any]) -> dict[str, torch.Tensor]:
        # an expert stack: its experts read one by one and stacked on a
        # leading expert axis (JAX l.145-152)
        return nest_layer({
            key: (torch.stack([leaf(key, n) for n in name])
                  if isinstance(name, list) else leaf(key, name))
            for key, name in names.items()})

    params: Params = (keep(group({"embedding": top["embedding"]}), specs)
                      if stage_keeps(stage, cfg, "embedding") else {})
    own = (stage.layers(cfg.num_layers) if stage is not None
           else range(cfg.num_layers))
    params["layers"] = [keep(group(layer_names[i]),
                             specs and specs["layers"][i]) for i in own]
    if stage_keeps(stage, cfg, "final_norm"):
        params["final_norm"] = leaf("final_norm", top["final_norm"])
    if not cfg.tie_embeddings and stage_keeps(stage, cfg, "lm_head"):
        params.update(keep(group({"lm_head": top["lm_head"]}), specs))
    return params


# --- the engine's own tree (orbax in the JAX package) ---


def _to_saveable(tree):
    if isinstance(tree, Int4Leaf):
        return {"__int4__": True, "q4": tree.q4, "s4": tree.s4,
                "axis": tree.axis, "group": tree.group}
    if isinstance(tree, dict):
        return {k: _to_saveable(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_saveable(v) for v in tree]
    return tree


def save_native(path: str | Path, params: Params) -> None:
    """`torch.save` of one device's param tree (dense, int8 dicts or
    Int4Leafs, under the same names)."""
    torch.save(_to_saveable(params), str(path))


def restore_native(path: str | Path, cfg: ModelConfig,
                   device="cuda") -> Params:
    """save_native's tree back, onto `device` (the card unless the caller
    passes device="cpu"), each Int4Leaf planned for its call site."""
    from .kernels.int4mm import plan_leaf
    from .models.common import LEAF_SPECS
    device = resolve_device(device)
    raw = torch.load(str(path), map_location=device, weights_only=True)

    def back(tree, key=None):
        if isinstance(tree, dict) and tree.get("__int4__"):
            return plan_leaf(LEAF_SPECS[key], Int4Leaf(
                q4=tree["q4"], s4=tree["s4"], axis=int(tree["axis"]),
                group=int(tree["group"])))
        if isinstance(tree, dict):
            # an expert stack's call site is "experts.<name>"
            return {k: back(v, f"{EXPERTS}.{k}" if key == EXPERTS else k)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [back(v, key) for v in tree]
        return tree

    params = back(raw)
    if len(params["layers"]) != cfg.num_layers:
        raise ValueError(f"{path}: {len(params['layers'])} layers, config "
                         f"{cfg.name} has {cfg.num_layers}")
    return params


def detect_config_from_hf(ckpt_dir: str | Path) -> dict[str, Any]:
    """Read config.json from an HF checkpoint dir (for model auto-detect)."""
    cfg_path = Path(ckpt_dir) / "config.json"
    if not cfg_path.exists():
        return {}
    return json.loads(cfg_path.read_text())
