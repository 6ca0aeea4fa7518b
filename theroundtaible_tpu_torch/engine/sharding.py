"""Mesh construction and parameter/cache partition specs (counterpart of
theroundtaible_tpu/engine/sharding.py).

The JAX package expresses sharding as a `jax.sharding.Mesh` plus
PartitionSpecs and lets XLA insert the collectives. Here every rank is a
process (engine/distributed.py) that holds only its own slice: a `Mesh`
records the axis sizes, this rank's coordinates and one process group per
axis; `shard_params` keeps this rank's slice of each weight by the same
spec tree (`param_specs`, JAX l.106-151); the forward
(models/common.py) issues the collectives itself.

Axes, as in the JAX package:
- "data"  - batch/slot parallelism: each replica serves different slots;
- "model" - tensor parallelism: attention heads, MLP hidden and vocab.

Ranks are laid out row-major over (data, model), as the JAX package
reshapes its device list: rank = data_index * model + model_index.

A spec is a tuple of axis names or None per dimension (the JAX package's
PartitionSpec as a plain tuple). A dimension the axis size does not divide
is replicated (`_fallback_replicated`): MQA's single kv head, or any head,
hidden or vocab count that does not divide the model axis.

Quantized leaves (engine/quant.py) take the spec tree quant.quantized_specs
makes from param_specs, as in the JAX package: an int8 dict's payload `q`
the weight's spec and its scale `s` the entries of the axes it keeps (so
o_proj's and down_proj's s[E] is whole on every rank), an Int4Leaf's `q4`
and `s4` the weight's spec, sharded only where the axis divides both (the
K10e rule, `int4_shard_axis`), so a shard holds whole scale groups. The
scales are the whole leaf's: a leaf is quantized before its slice is kept
(models/common.init_params, weights.params_from_numpy). Each Int4Leaf shard
is planned for the mesh (`plan_int4_shard`), on its own shapes.
`int4_shard_axis` and `lora_shard_axis` say which axis of a packed weight
or a LoRA stack carries the model shards and whether its product needs an
all-reduce.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

from .models.common import (LEAF_SPECS, SPEC_TP, Int4Leaf, ModelConfig,
                            Params)
from .kernels import int4mm
from .quant import quantized_specs

DATA_AXIS = "data"
MODEL_AXIS = "model"

Spec = tuple


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) mesh of ranks, seen from one rank: the axis sizes,
    this rank's index in the group, and the process group of each axis of
    size > 1 that holds this rank (None otherwise; the attention wrappers
    need only the coordinates)."""

    data: int
    model: int
    rank: int
    model_group: Any = None
    data_group: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.data_index if axis == DATA_AXIS else self.model_index

    def splits(self, n: int, axis: str = MODEL_AXIS) -> bool:
        """Whether `axis` shards a dimension of size n: the one rule of the
        port's sharding. An axis of more than one rank that divides n
        shards it; otherwise the dimension is replicated (JAX's
        _fallback_replicated)."""
        size = self.axis_size(axis)
        return size > 1 and n % size == 0

    def local(self, n: int, axis: str = MODEL_AXIS) -> int:
        """This rank's part of a dimension of size n (n where replicated)."""
        return n // self.axis_size(axis) if self.splits(n, axis) else n


def mesh_size(mesh_shape: Optional[dict[str, int]]) -> int:
    """Devices a configured mesh spans (1 without one); an axis of -1
    ("all remaining ranks") spans the initialized group."""
    sizes = [int(n) for n in (mesh_shape or {}).values()]
    if -1 in sizes:
        import torch.distributed as dist
        return (dist.get_world_size()
                if dist.is_available() and dist.is_initialized() else 1)
    return math.prod(max(n, 1) for n in sizes)


def build_mesh(mesh_shape: dict[str, int]) -> Mesh:
    """This rank's Mesh of `mesh_shape` ({"data": d, "model": m}; -1 means
    "all remaining ranks", as in the JAX package) over the initialized
    torch.distributed group, whose world size must equal the mesh size.
    Every rank must call it, in the same order: it creates the axes'
    process groups."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"mesh {mesh_shape} needs an initialized torch.distributed "
            f"process group: start one rank per device "
            f"(engine/distributed.py initialize or launch)")
    world = dist.get_world_size()
    data = int(mesh_shape.get(DATA_AXIS, 1))
    model = int(mesh_shape.get(MODEL_AXIS, -1))
    if model == -1:
        model = world // max(data, 1)
    if data == -1:
        data = world // max(model, 1)
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} ranks, the process "
            f"group has {world}")
    rank = dist.get_rank()
    model_group = data_group = None
    # new_group is collective: every rank creates every group, in order.
    for d in range(data):
        ranks = [d * model + j for j in range(model)]
        group = dist.new_group(ranks) if model > 1 else None
        if rank in ranks:
            model_group = group
    for j in range(model):
        ranks = [d * model + j for d in range(data)]
        group = dist.new_group(ranks) if data > 1 else None
        if rank in ranks:
            data_group = group
    return Mesh(data, model, rank, model_group, data_group)


def param_specs(cfg: ModelConfig) -> Params:
    """Spec tree matching init_params' structure (JAX l.106-151): q/o on
    query heads, k/v on kv heads, the MLP on its hidden, embedding and
    lm_head on the vocab."""
    if cfg.num_experts:
        raise NotImplementedError(
            "MoE sharding is not ported yet (ROADMAP, MoE and float16)")
    layer = {
        "q_proj": (None, MODEL_AXIS, None),    # [E, H, D]
        "k_proj": (None, MODEL_AXIS, None),    # [E, K, D]
        "v_proj": (None, MODEL_AXIS, None),
        "o_proj": (MODEL_AXIS, None, None),    # [H, D, E] contraction
        "input_norm": (None,),
        "pre_mlp_norm": (None,),
        "gate_proj": (None, MODEL_AXIS),       # [E, F]
        "up_proj": (None, MODEL_AXIS),
        "down_proj": (MODEL_AXIS, None),       # [F, E]
    }
    if cfg.attn_bias:
        layer["q_bias"] = (MODEL_AXIS, None)   # [H, D]
        layer["k_bias"] = (MODEL_AXIS, None)   # [K, D]
        layer["v_bias"] = (MODEL_AXIS, None)
    if cfg.post_attn_norm:
        layer["post_attn_norm"] = (None,)
    if cfg.post_mlp_norm:
        layer["post_mlp_norm"] = (None,)
    specs: Params = {
        "embedding": (MODEL_AXIS, None),       # [V, E] vocab
        "layers": [dict(layer) for _ in range(cfg.num_layers)],
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = (MODEL_AXIS, None)
    return specs


def model_axis_size(mesh: Optional[Mesh]) -> int:
    """Model-axis (TP) shard count of a mesh, 1 without one: the
    `model_shards` quant.quantize_params aligns int4 groups to, and the
    shard count K10e/K10f partition against."""
    return mesh.model if mesh is not None else 1


def int4_shard_axis(tp: Optional[str], w_ndim: int, n_cont: int,
                    mode: str) -> tuple[Optional[int], bool]:
    """(weight axis carrying the model shards or None, needs_psum) of a
    packed-int4 product (JAX l.162), kept beside param_specs so the two
    agree. tp "col" (q/k/v, gate/up, the head): the first kept axis -
    heads, hidden or vocab - each rank computes its output slice, no
    collective. tp "row" (o_proj, down_proj) with `mode` "out": the first
    contracted axis, the partial sums need one all-reduce. Anything else
    (no tp, or "row" on the head's pack-on-contraction layout, which no
    weight uses) replicates."""
    if tp == "col":
        return (n_cont if mode == "out" else 0), False
    if tp == "row" and mode == "out":
        return 0, True
    return None, False


def lora_shard_axis(tp: Optional[str]) -> Optional[str]:
    """Which axis of a target's LoRA stacks carries the model shards (JAX
    l.188): "out" (B's output axis) for a column-parallel target, no
    collective; "in" (A's contraction axis) for a row-parallel one, whose
    partial deltas need one all-reduce; None replicates."""
    if tp == "col":
        return "out"
    if tp == "row":
        return "in"
    return None


def kv_cache_spec() -> Spec:
    """KV cache [N, S, K, D]: slots on the data axis, kv heads on the model
    axis."""
    return (DATA_AXIS, None, MODEL_AXIS, None)


def _fallback_replicated(spec: Spec, shape: tuple[int, ...],
                         mesh: Mesh) -> Spec:
    """Replace axis names that do not shard their dim (Mesh.splits) with
    None."""
    fixed = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                        - len(spec))):
        fixed.append(axis if axis is not None and mesh.splits(dim, axis)
                     else None)
    return tuple(fixed)


def shard_slices(spec: Spec, shape: tuple[int, ...],
                 mesh: Mesh) -> tuple[slice, ...]:
    """This rank's slice of every dimension of a `shape` leaf under
    `spec`, after the replication fallback."""
    out = []
    for dim, axis in zip(shape, _fallback_replicated(spec, shape, mesh)):
        if axis is None:
            out.append(slice(None))
        else:
            n = mesh.local(dim, axis)
            start = mesh.axis_index(axis) * n
            out.append(slice(start, start + n))
    return tuple(out)


def shard_leaf(x, spec, mesh: Mesh):
    """This rank's slice of one leaf (torch tensors or numpy arrays) under
    its spec - views; callers copy what must outlive the whole leaf
    (`materialize`). An int8 dict takes {"q": spec, "s": spec} and an
    Int4Leaf an Int4Leaf of specs (quant.quantized_specs) or the weight's
    spec; an Int4Leaf axis is sharded only where it divides both q4 and s4
    (K10e's rule), and its shard comes back unplanned."""
    if isinstance(x, Int4Leaf):
        spec = spec.q4 if isinstance(spec, Int4Leaf) else spec
        q4, s4 = (_fallback_replicated(spec, tuple(t.shape), mesh)
                  for t in (x.q4, x.s4))
        joint = tuple(a if a == b else None for a, b in zip(q4, s4))
        return Int4Leaf(q4=x.q4[shard_slices(joint, tuple(x.q4.shape),
                                             mesh)],
                        s4=x.s4[shard_slices(joint, tuple(x.s4.shape),
                                             mesh)],
                        axis=x.axis, group=x.group)
    if isinstance(x, dict) and "q" in x:
        return {"q": shard_leaf(x["q"], spec["q"], mesh),
                "s": shard_leaf(x["s"], spec["s"], mesh)}
    return x[shard_slices(spec, tuple(x.shape), mesh)]


def plan_int4_shard(spec: str, part: Int4Leaf, mesh: Mesh, w_shape,
                    tp: Optional[str]) -> Int4Leaf:
    """`part`, this rank's shard of an int4 weight of whole dense shape
    `w_shape`, planned for K10e at the call site `spec` of convention `tp`
    (kernels/int4mm.plan_leaf): split on int4_shard_axis's axis where the
    model axis divides both q4 and s4 there, else whole on every rank. On
    a mesh without a model axis the leaf's plain plan."""
    if mesh.model == 1:
        return int4mm.plan_leaf(spec, part)
    axis, psum = None, False
    cls, _ = int4mm.classify(spec, part)
    if cls is not None:
        mode, n_cont, _gp = cls
        axis, psum = int4_shard_axis(tp, len(w_shape), n_cont, mode)
        q4 = (*w_shape[:-1], w_shape[-1] // 2)
        s4 = (*w_shape[:-1], w_shape[-1] // part.group)
        if axis is not None and not (mesh.splits(q4[axis])
                                     and mesh.splits(s4[axis])):
            axis, psum = None, False
    return int4mm.plan_leaf(spec, part, mesh, w_shape, tp, axis, psum)


def _shard_named(name: str, x, spec, mesh: Mesh):
    """shard_leaf of the leaf `name`, an Int4Leaf's shard planned for the
    mesh against the whole weight's shape."""
    part = shard_leaf(x, spec, mesh)
    if isinstance(part, Int4Leaf):
        part = plan_int4_shard(LEAF_SPECS[name], part, mesh,
                               (*x.q4.shape[:-1], 2 * x.q4.shape[-1]),
                               SPEC_TP[LEAF_SPECS[name]])
    return part


def shard_tree(tree: dict, specs: dict, mesh: Mesh) -> dict:
    """shard_params for one flat dict of named leaves (a layer, or the
    embedding or head alone) with param_specs' entries for those names;
    quantized leaves take quant.quantized_specs' specs."""
    qspecs = quantized_specs({k: specs[k] for k in tree}, tree)
    return {k: _shard_named(k, v, qspecs[k], mesh) for k, v in tree.items()}


def shard_params(tree: Params, cfg: ModelConfig, mesh: Mesh) -> Params:
    """This rank's slice of every leaf of `tree` (torch tensors or numpy
    arrays in init_params' structure, dense or quantized) by param_specs:
    q/k/v on heads, o_proj on its contraction, gate/up and down on the
    hidden, embedding and lm_head on the vocab, q/k/v biases on heads; a
    dimension that does not divide is replicated. Slices are views of the
    given leaves; an Int4Leaf's shard is planned for the mesh."""
    specs = param_specs(cfg)
    out: Params = shard_tree({k: v for k, v in tree.items()
                              if k != "layers"}, specs, mesh)
    out["layers"] = [shard_tree(layer, lspec, mesh)
                     for layer, lspec in zip(tree["layers"],
                                             specs["layers"])]
    return out


def materialize(x, device=None):
    """A contiguous copy of one torch leaf - dense, int8 dict or Int4Leaf
    (its plan kept) - on `device` (where it is without one)."""
    def copy(t):
        return t.to(device=device, copy=True).contiguous()

    if isinstance(x, Int4Leaf):
        return dataclasses.replace(x, q4=copy(x.q4), s4=copy(x.s4))
    if isinstance(x, dict):
        return {k: copy(v) for k, v in x.items()}
    return copy(x)


def local_config(cfg: ModelConfig, mesh: Optional[Mesh]) -> ModelConfig:
    """The shapes one rank holds: heads, kv heads, MLP hidden and vocab
    divided by the model axis where they divide (replicated where not).
    For cache and pool shapes and the weight bridge's checks; the forward
    keeps the global config."""
    if mesh is None or mesh.model == 1:
        return cfg
    return dataclasses.replace(
        cfg, num_heads=mesh.local(cfg.num_heads),
        num_kv_heads=mesh.local(cfg.num_kv_heads),
        mlp_dim=mesh.local(cfg.mlp_dim), vocab_size=mesh.local(cfg.vocab_size))
