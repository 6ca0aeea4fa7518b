"""Weight bridge: a JAX-package parameter tree, as numpy arrays, into the
port's parameter dict - the same nested structure and axis layouts
(q_proj [E,H,D], k_proj/v_proj [E,K,D], o_proj [H,D,E], gate/up [E,F],
down [F,E], embedding/lm_head [V,E], biases, norms; MoE: router [E,X] and
experts.gate/up [X,E,F], experts.down [X,F,E]). With the same weights
both packages compute the same function, which is how the tests compare
them: the two packages cannot share a random stream.

Quantized trees (the JAX engine's params after quantize_params) bridge
too: an int8 {"q", "s"} dict keeps its payload as torch.int8 and its
scales in `dtype`, and the JAX package's Int4Leaf (any object with q4, s4,
axis and group) becomes the port's models/common.Int4Leaf, planned for its
call site (kernels/int4mm.plan_leaf).

Under a mesh (`mesh`, an engine/sharding.Mesh) each rank keeps its slice of
every leaf (sharding.shard_tree: the JAX package's param_specs and, for a
quantized leaf, quantized_specs), so the ranks of a tensor-parallel engine
together hold the same weights as the JAX engine sharded over the same
mesh; an Int4Leaf's shard is planned on its own shapes (K10e)."""

from __future__ import annotations

import math

import numpy as np
import torch

from .device import resolve_device
from .kernels.int4mm import plan_leaf
from .models.common import (LEAF_SPECS, Int4Leaf, ModelConfig, Params,
                            flat_layer, nest_layer, stage_keeps)
from .quant import _SCALE_AXES


def expected_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Shape of every per-layer leaf the port reads, by its flat_layer
    name."""
    e, h, k, d, f = (cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim, cfg.mlp_dim)
    shapes = {"q_proj": (e, h, d), "k_proj": (e, k, d), "v_proj": (e, k, d),
              "o_proj": (h, d, e), "input_norm": (e,), "pre_mlp_norm": (e,)}
    if cfg.num_experts:
        x = cfg.num_experts
        shapes.update({"router": (e, x), "experts.gate_proj": (x, e, f),
                       "experts.up_proj": (x, e, f),
                       "experts.down_proj": (x, f, e)})
    else:
        shapes.update(gate_proj=(e, f), up_proj=(e, f), down_proj=(f, e))
    if cfg.attn_bias:
        shapes.update(q_bias=(h, d), k_bias=(k, d), v_bias=(k, d))
    if cfg.post_attn_norm:
        shapes["post_attn_norm"] = (e,)
    if cfg.post_mlp_norm:
        shapes["post_mlp_norm"] = (e,)
    return shapes


def param_count_of(params: Params, cfg: ModelConfig) -> int:
    """The whole model's parameter count (models/common param_count's
    count: an int8 dict counts q and s, an Int4Leaf two per packed byte
    plus its scales), from the leaves' kinds and `cfg`'s whole shapes, so a
    rank's slices count what the JAX engine's global tree counts."""
    vocab = (cfg.vocab_size, cfg.embed_dim)
    shapes = {**expected_shapes(cfg), "embedding": vocab, "lm_head": vocab,
              "final_norm": (cfg.embed_dim,)}

    def count(name: str, leaf) -> int:
        shape = shapes[name]
        n = math.prod(shape)
        if isinstance(leaf, Int4Leaf):
            return n + n // leaf.group
        if isinstance(leaf, dict):
            return n + math.prod(shape[a] for a in _SCALE_AXES[name])
        return n

    total = sum(count(k, v) for k, v in params.items() if k != "layers")
    return total + sum(count(k, v) for layer in params["layers"]
                       for k, v in flat_layer(layer).items())


def _tensor(x, shape, name: str, dtype, device) -> torch.Tensor:
    arr = np.asarray(x)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(arr.shape)} != expected "
                         f"{tuple(shape)}")
    # via an f32 copy: numpy has no bfloat16 torch.from_numpy accepts, and
    # jax.device_get hands out read-only arrays
    return torch.from_numpy(np.array(arr, np.float32)).to(
        device=device, dtype=dtype)


def _int8(x, shape, name: str, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype != np.int8 or tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{name}: int8 payload {arr.dtype} "
                         f"{tuple(arr.shape)} != expected {tuple(shape)}")
    return torch.from_numpy(np.array(arr)).to(device)


def _leaf(x, shape, name: str, dtype, device):
    """One weight leaf: dense, int8 dict or Int4Leaf, checked against the
    dense `shape`; `name` is "layers[i].<flat_layer name>" or a top-level
    key."""
    key = name.split("].", 1)[-1]
    if isinstance(x, dict) and "q" in x and "s" in x:
        kept = tuple(shape[a % len(shape)] for a in _SCALE_AXES[key])
        return {"q": _int8(x["q"], shape, f"{name}.q", device),
                "s": _tensor(x["s"], kept, f"{name}.s", dtype, device)}
    if all(hasattr(x, a) for a in ("q4", "s4", "axis", "group")):
        group = int(x.group)
        if int(x.axis) != len(shape) - 1 or group < 2 or shape[-1] % group:
            raise ValueError(f"{name}: int4 leaf packed on axis {x.axis} in "
                             f"groups of {group} does not fit {shape}")
        q4 = _int8(x.q4, (*shape[:-1], shape[-1] // 2), f"{name}.q4",
                   device)
        s4 = _tensor(x.s4, (*shape[:-1], shape[-1] // group), f"{name}.s4",
                     dtype, device)
        return plan_leaf(LEAF_SPECS[key],
                         Int4Leaf(q4=q4, s4=s4, axis=len(shape) - 1,
                                  group=group))
    return _tensor(x, shape, name, dtype, device)


def params_from_numpy(tree: dict, cfg: ModelConfig, dtype=torch.bfloat16,
                      device="cuda", mesh=None, stage=None) -> Params:
    """The port's parameters from `jax.device_get(engine.params)`, dense or
    quantized; under `mesh` this rank's slices of them (one leaf at a time
    is bridged whole on the CPU, sliced, and its slice copied to `device`,
    so the host holds one whole leaf at most). With a pipeline `stage`
    (models/common.Stage) only the stage's leaves are bridged: its layers,
    and the embedding, final norm and head where the stage holds them. On
    the card unless the caller passes device="cpu". Raises on a missing
    leaf or a shape that disagrees with `cfg`."""
    device = resolve_device(device)
    if len(tree["layers"]) != cfg.num_layers:
        raise ValueError(f"tree has {len(tree['layers'])} layers, config "
                         f"{cfg.num_layers}")
    if mesh is not None and mesh.model > 1:
        from .sharding import materialize, param_specs, shard_tree
        specs = param_specs(cfg)
        layer_specs = flat_layer(specs["layers"][0])

        def leaf(x, shape, name, key):
            spec = specs[key] if key in specs else layer_specs[key]
            whole = nest_layer({key: _leaf(x, shape, name, dtype, "cpu")})
            part = flat_layer(shard_tree(whole, nest_layer({key: spec}),
                                         mesh))[key]
            return materialize(part, device)
    else:
        def leaf(x, shape, name, key):
            return _leaf(x, shape, name, dtype, device)

    vocab = (cfg.vocab_size, cfg.embed_dim)
    own = (stage.layers(cfg.num_layers) if stage is not None
           else range(cfg.num_layers))
    out: Params = {"layers": []}
    for name, shape in (("embedding", vocab),
                        ("final_norm", (cfg.embed_dim,)),
                        ("lm_head", vocab)):
        if (name != "lm_head" or not cfg.tie_embeddings) \
                and stage_keeps(stage, cfg, name):
            out[name] = leaf(tree[name], shape, name, name)
    for i in own:
        flat = flat_layer(tree["layers"][i])
        out["layers"].append(nest_layer({
            name: leaf(flat[name], shape, f"layers[{i}].{name}", name)
            for name, shape in expected_shapes(cfg).items()}))
    return out
