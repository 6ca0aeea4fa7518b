"""Weight quantization for serving: int8 (w8a16) and grouped int4 (w4a16)
(counterpart of theroundtaible_tpu/engine/quant.py, one device).

Representations (models/common's matmul seam and embed_tokens take both;
`quantized()` is the predicate):

- bits=8: each big matmul weight becomes {"q": int8[w.shape],
  "s": act_dtype[kept axes]}, s = absmax/127 over the contracted axes, so
  w ~ q * s with s broadcast over the output axes. The seam scales the
  matmul's output.
- bits=4: an Int4Leaf - two signed nibbles per int8 byte along the
  weight's LAST axis (even element in the low nibble), per-`group`
  absmax/7 scales in the activation dtype, planned once for its call site
  (kernels/int4mm.plan_leaf). A leaf whose last dim cannot group falls
  back to the int8 dict, so int4 trees are mixed.

q is computed from the f32 scale, which is then stored in the activation
dtype; the outputs equal the JAX package's bit for bit. Norms stay as
they are. LoRA stacks quantize the same way, per (slot, rank row)
(`quantize_lora_stack`, `quantize_lora_slot`).

Under a tensor-parallel mesh every scale is the whole leaf's, as in the
JAX engine, which quantizes its global arrays: o_proj's and down_proj's
int8 scale s[E] reduces over the sharded axis, so a leaf is quantized
before a rank keeps its slice (`quantize_leaves` inside
models/common.init_params). `model_shards` aligns an int4 leaf whose pack
axis is model-sharded (gate/up [E, F]) to groups that divide the
per-shard dim, so no group straddles two ranks. `quantized_specs` is the
JAX package's spec tree of a quantized tree (engine/sharding.py places by
it).
"""

from __future__ import annotations

from typing import Any

import torch

from .kernels.int4mm import plan_leaf
from .models.common import LEAF_SPECS, Int4Leaf, ModelConfig, Params

# Per weight key: the axes KEPT by the scale (the matmul's non-contracted
# weight axes, which land trailing in its output).
_SCALE_AXES: dict[str, tuple[int, ...]] = {
    "q_proj": (1, 2),      # [E, H, D] -> s[H, D]
    "k_proj": (1, 2),      # [E, K, D] -> s[K, D]
    "v_proj": (1, 2),
    "o_proj": (2,),        # [H, D, E] -> s[E]
    "gate_proj": (1,),     # [E, F] -> s[F]
    "up_proj": (1,),
    "down_proj": (1,),     # [F, E] -> s[E]
    "embedding": (0,),     # [V, E] -> s[V] (row scale: lookup AND head)
    "lm_head": (0,),
}


def quantized(leaf: Any) -> bool:
    return (isinstance(leaf, dict) and "q" in leaf and "s" in leaf) \
        or isinstance(leaf, Int4Leaf)


def _quantize_leaf(w: torch.Tensor, scale_axes: tuple[int, ...],
                   act_dtype) -> dict[str, torch.Tensor]:
    scale_axes = tuple(a % w.dim() for a in scale_axes)
    reduce_axes = tuple(a for a in range(w.dim()) if a not in scale_axes)
    w32 = w.float()
    absmax = w32.abs().amax(dim=reduce_axes)
    s = torch.clamp(absmax, min=1e-8) / 127.0
    s_full = s
    for a in reduce_axes:
        s_full = s_full.unsqueeze(a)
    q = torch.clamp(torch.round(w32 / s_full), -127, 127).to(torch.int8)
    return {"q": q, "s": s.to(act_dtype)}


def _int4_group_for(dim: int, group: int, shards: int = 1) -> int:
    """Largest even divisor of `dim` that is <= group (0 = no valid
    grouping; the leaf then falls back to int8). With the pack axis
    sharded over `shards` ranks the group divides the per-shard dim, so
    every shard holds whole groups (and whole packed bytes)."""
    if shards > 1 and dim % shards == 0:
        dim = dim // shards
    for g in range(min(group, dim), 1, -1):
        if g % 2 == 0 and dim % g == 0:
            return g
    return 0


def _quantize_leaf_int4(w: torch.Tensor, scale_axes: tuple[int, ...],
                        act_dtype, group: int, pack_shards: int = 1) -> Any:
    """Symmetric per-group int4 (w ~ q4 * s4, |q4| <= 7), two nibbles per
    int8 byte along the LAST axis (even element -> low nibble); groups
    aligned to `pack_shards` shards of that axis. A last dim that cannot
    group stays int8."""
    dim = w.shape[-1]
    g = _int4_group_for(dim, group, pack_shards)
    if g < 2:
        return _quantize_leaf(w, scale_axes, act_dtype)
    wg = w.float().reshape(*w.shape[:-1], dim // g, g)
    absmax = wg.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(absmax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(wg / s), -8, 7).to(torch.int8)
    q2 = q.reshape(*w.shape[:-1], dim // 2, 2).to(torch.int32)
    packed = (((q2[..., 1] & 0xF) << 4) | (q2[..., 0] & 0xF)).to(torch.int8)
    return Int4Leaf(q4=packed, s4=s.squeeze(-1).to(act_dtype),
                    axis=w.dim() - 1, group=g)


def _pack_shards(cfg: ModelConfig, key: str, value, model_shards: int
                 ) -> int:
    """model_shards when the leaf's last (pack) axis is the model-sharded
    one by param_specs and divides, else 1 (JAX l.200-214)."""
    if model_shards <= 1:
        return 1
    from .sharding import MODEL_AXIS, param_specs
    specs = param_specs(cfg)
    spec = specs.get(key, specs["layers"][0].get(key))
    if (spec is not None and len(spec) == value.dim()
            and spec[-1] == MODEL_AXIS
            and value.shape[-1] % model_shards == 0):
        return model_shards
    return 1


def quantize_leaves(tree: dict, cfg: ModelConfig, act_dtype=torch.bfloat16,
                    free_source: bool = False, bits: int = 8,
                    group: int = 64, model_shards: int = 1) -> dict:
    """quantize_params for one flat dict of named leaves (a layer, or the
    embedding or head alone): every weight of _SCALE_AXES quantized and
    planned for its call site on one device, the rest passed through."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if cfg.num_experts:
        raise NotImplementedError(
            "quantized MoE experts are not ported yet (ROADMAP, slice 7e)")

    def one(value: torch.Tensor, key: str) -> Any:
        scale_axes = _SCALE_AXES[key]
        if bits == 4:
            out = _quantize_leaf_int4(
                value, scale_axes, act_dtype, group,
                _pack_shards(cfg, key, value, model_shards))
            if isinstance(out, Int4Leaf):
                out = plan_leaf(LEAF_SPECS[key], out)
        else:
            out = _quantize_leaf(value, scale_axes, act_dtype)
        storage = value.untyped_storage()
        if free_source and storage.resizable():
            # Tied leaves (post_*_norm) are never quantized, so no other
            # name reads this storage. (A tensor over numpy memory cannot
            # give it back and keeps it.)
            storage.resize_(0)
        return out

    return {k: (one(v, k) if k in _SCALE_AXES else v)
            for k, v in tree.items()}


def quantize_params(params: Params, cfg: ModelConfig,
                    act_dtype=torch.bfloat16, free_source: bool = False,
                    bits: int = 8, group: int = 64,
                    model_shards: int = 1) -> Params:
    """Quantize the big matmul weights; returns a new tree (norms and
    unrecognized leaves pass through). bits=8: per-output-channel int8
    dicts; bits=4: per-`group` Int4Leafs (int8 where a leaf cannot group),
    with groups aligned to `model_shards` where the pack axis is
    model-sharded (the mesh's model axis size; JAX quantize_params).

    free_source=True empties each source leaf's storage as soon as its
    replacement exists, so an 8B model peaks near bf16 plus one leaf
    instead of bf16 plus int8: the caller must own `params` and must not
    read the source tree afterwards."""
    kw = dict(act_dtype=act_dtype, free_source=free_source, bits=bits,
              group=group, model_shards=model_shards)
    top = quantize_leaves({k: v for k, v in params.items()
                           if k != "layers"}, cfg, **kw)
    return {k: ([quantize_leaves(layer, cfg, **kw) for layer in v]
                if k == "layers" else top[k]) for k, v in params.items()}


def _spec_for_scale(spec, scale_axes: tuple[int, ...]) -> tuple:
    """The spec of a scale leaf: `s` keeps exactly `scale_axes` of the
    weight, so it keeps those axes' entries (JAX l.260)."""
    entries = tuple(spec) if spec is not None else ()
    return tuple(entries[a] if a < len(entries) else None
                 for a in scale_axes)


def _qspec_leaf(spec, scale_axes: tuple[int, ...], leaf):
    """The spec of one quantized leaf (JAX l.328): an Int4Leaf of specs
    (q4 and s4 both take the weight's) for an Int4Leaf, else {"q": spec,
    "s": the kept axes' spec}."""
    if isinstance(leaf, Int4Leaf):
        return Int4Leaf(q4=spec, s4=spec, axis=leaf.axis, group=leaf.group)
    return {"q": spec, "s": _spec_for_scale(spec, scale_axes)}


def quantized_specs(specs: Params, params: Params) -> Params:
    """The spec tree (sharding.param_specs, or one flat dict of its
    entries) matching the quantized tree `params` (JAX l.299): each weight
    of _SCALE_AXES that is quantized there becomes _qspec_leaf's spec; a
    dense leaf keeps its spec."""
    out: Params = {}
    for key, value in specs.items():
        pv = params.get(key)
        if key == "layers":
            out[key] = [quantized_specs(layer, pv[i])
                        for i, layer in enumerate(value)]
        elif key in _SCALE_AXES and quantized(pv):
            out[key] = _qspec_leaf(value, _SCALE_AXES[key], pv)
        else:
            out[key] = value
    return out


def quantize_lora_stack(stack: torch.Tensor, act_dtype) -> dict[str, Any]:
    """Symmetric int8 quantization of a stacked LoRA tensor [S, r, X]
    (engine/lora.LoraStore with `quant: "int8"`): per-(slot, rank-row)
    absmax/127 scales over the last axis, stored in `act_dtype`, the
    {"q", "s"} contract of the int8 weight dicts. The all-zero base slot
    quantizes to zeros exactly. The kernel K7 declines such stacks
    (`quant:int8-stack`); the grouped einsums serve them."""
    w32 = stack.float()
    s = torch.clamp(w32.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / s[..., None]), -127, 127)
    return {"q": q.to(torch.int8), "s": s.to(act_dtype)}


def quantize_lora_slot(leaf: dict[str, Any], slot: int,
                       value32: torch.Tensor, cols=slice(None)
                       ) -> dict[str, Any]:
    """Write ONE slot of an int8 LoRA stack: the f32 [r, X] rows
    quantized by quantize_lora_stack's rule, in place (a dispatch queued
    earlier on the same stream reads the slot before this write lands).
    A stack sharded on its last axis keeps the columns `cols` of the
    payload; the scales are the whole rows' on every rank. Returns
    `leaf`."""
    s = torch.clamp(value32.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(value32 / s[..., None]), -127, 127)
    leaf["q"][slot] = q[:, cols].to(torch.int8)
    leaf["s"][slot] = s.to(leaf["s"].dtype)
    return leaf
