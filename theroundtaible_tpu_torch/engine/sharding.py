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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

from .models.common import Int4Leaf, ModelConfig, Params

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
    """Model-axis (TP) shard count of a mesh, 1 without one."""
    return mesh.model if mesh is not None else 1


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


def shard_leaf(x, spec: Spec, mesh: Mesh):
    """This rank's slice of one dense leaf (a torch tensor or a numpy
    array) - a view; callers copy it when the full leaf must go."""
    if isinstance(x, Int4Leaf) or (isinstance(x, dict) and "q" in x):
        raise NotImplementedError(
            "quantized weights under a mesh are not ported yet (ROADMAP, "
            "slice 7: int4 weights and LoRA under a mesh)")
    return x[shard_slices(spec, tuple(x.shape), mesh)]


def shard_params(tree: Params, cfg: ModelConfig, mesh: Mesh) -> Params:
    """This rank's slice of every leaf of `tree` (torch tensors or numpy
    arrays in init_params' structure) by param_specs: q/k/v on heads,
    o_proj on its contraction, gate/up and down on the hidden, embedding
    and lm_head on the vocab, q/k/v biases on heads; a dimension that does
    not divide is replicated. Slices are views of the given leaves."""
    specs = param_specs(cfg)
    out: Params = {k: shard_leaf(v, specs[k], mesh)
                   for k, v in tree.items() if k != "layers"}
    out["layers"] = [{name: shard_leaf(w, lspec[name], mesh)
                      for name, w in layer.items()}
                     for layer, lspec in zip(tree["layers"],
                                             specs["layers"])]
    return out


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
