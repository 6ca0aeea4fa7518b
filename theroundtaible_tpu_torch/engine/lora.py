"""Multi-LoRA knight personas on one shared base model (counterpart of
theroundtaible_tpu/engine/lora.py).

K personas are LoRA deltas over ONE resident base: at each tagged
projection (models/common: q/k/v/o, gate/up/down) the serving product
becomes `y = x.W + x.A_id^T.B_id`, where `id` is each row's adapter slot,
so knights with different personas share one decode batch and K personas
cost K x rank x (C + O) values per target instead of K models.

- **LoraStore** - per-target stacked tensors `a_t [S, r, C]` / `b [S, r,
  O]` on the device, S = max_adapters + 1 slots; slot 0 is all zeros, so a
  base row gets an exact zero delta. Loading and evicting write slot
  values in place; residency is refcounted by the serving paths (the
  scheduler's requests, generate calls) and eviction is LRU over
  unreferenced adapters. `lora: {quant: "int8"}` stores int8 stacks with
  per-(slot, rank-row) scales (engine/quant.quantize_lora_stack).
- **LoraBatch / apply_group** - PyTorch runs eagerly, so where the JAX
  package announces a trace-time `lora_scope`, the engine builds one
  LoraBatch per dispatch and passes it down the forward: the store (its
  stacks and per-(target, rows) routes), the adapter ids as a device
  tensor built once (per row [B] for batched programs, per token [T] for
  the ragged flat buffer) and the engine's `lora_paths` sink. The tagged
  projections that read one input call apply_group(keys, x, ys, lora)
  once - q/k/v, gate/up, and o_proj and down_proj alone - which flattens
  x to [M, C], repeats the ids to one per flattened row and adds each
  target's delta to its f32 product. Routing per (target, rows): the
  kernel K7 (kernels/lora.py; its plain version on the CPU) where the plan
  takes it - one in-place call for the group's members it takes - else,
  per target, the grouped einsums `grouped_bmm` with the reason: prefill
  rows (`rows:prefill-m`) and int8 stacks (`quant:int8-stack`), the JAX
  package's own routing.

Sharing (correctness): K/V computed under one adapter is wrong under
another, so a mixed-adapter batch suppresses cross-knight prefix sharing,
a uniform batch takes only donors of its own adapter, and a slot re-served
under another adapter is released first (engine._prepare_batch).

Tensor parallelism (`mesh`, an engine/sharding.Mesh with a model axis):
each rank holds its shard of every target's stacks - B's output axis for a
column-parallel target, A's contraction axis for a row-parallel one - and
runs K10f (kernels/lora.lora_bgmv_spmd) on it; a row target's partial
delta lands on the base's partial product, and the forward's one
all-reduce of o_proj/down_proj sums both. A stack is sharded exactly
where its base weight is (`base_units`: the base's heads or hidden count
must divide the model axis). The JAX package shards a stack where its
flat dim divides (heads x head_dim), which differs where heads do not
divide but heads x head_dim does (gemma-2b's one kv head on two ranks:
JAX splits the k/v stacks' B on D, the port keeps them whole with the
whole k/v weight); the delta is then the same sum in another order, and
no collective of its own is needed. A seed or npz persona writes each
rank's slice of the whole pair, so a persona row on a mesh is the
single-device persona; an int8 stack's scales are the whole rows'.

Not ported here, each with its ROADMAP item: the telemetry series and the
perf model's per-row bytes (7c), the jaxpr-audit registration of the slot
setter (no compiled setter exists here).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from .kernels import lora as klora

LORA_ENV = "ROUNDTABLE_LORA"

DEFAULT_RANK = 8
DEFAULT_MAX_ADAPTERS = 8
# alpha/rank folded into B at load time: delta = x.A^T.(scale.B).
DEFAULT_SCALE = 2.0
# Seed personas draw both A and B nonzero, so an untrained persona still
# changes the model's outputs.
DEFAULT_INIT_STD = 0.02

# The grouped einsums' provenance name (the JAX package's XLA route).
PATH_GROUPED = "xla_grouped_bmm"
QUANT_REASON = "quant:int8-stack"


def lora_enabled(cfg_value: Any) -> bool:
    """LoRA serves only with an explicit `lora:` config block, and
    ROUNDTABLE_LORA=0 turns it off everywhere (the byte-identity
    lever)."""
    if not cfg_value:
        return False
    return os.environ.get(LORA_ENV, "") != "0"


def lora_dims(model_cfg) -> dict[str, tuple[int, int, str]]:
    """Per-target (in_dim, out_flat, tp) of the tagged projections; `tp`
    is the JAX package's shard convention ("col": output axis, "row":
    contraction axis), kept for the multi-device slice. MoE configs
    target attention only."""
    e, h, k, d, f = (model_cfg.embed_dim, model_cfg.num_heads,
                     model_cfg.num_kv_heads, model_cfg.head_dim,
                     model_cfg.mlp_dim)
    dims = {
        "q_proj": (e, h * d, "col"),
        "k_proj": (e, k * d, "col"),
        "v_proj": (e, k * d, "col"),
        "o_proj": (h * d, e, "row"),
    }
    if not model_cfg.num_experts:
        dims.update({
            "gate_proj": (e, f, "col"),
            "up_proj": (e, f, "col"),
            "down_proj": (f, e, "row"),
        })
    return dims


def base_units(model_cfg) -> dict[str, int]:
    """Per target, the count of whole units of its base weight along the
    axis its stacks shard: q/o heads, k/v kv heads, the MLP hidden. A
    mesh splits a stack where it splits these (the base weight's
    placement, sharding.param_specs)."""
    h, k, f = (model_cfg.num_heads, model_cfg.num_kv_heads,
               model_cfg.mlp_dim)
    return {"q_proj": h, "k_proj": k, "v_proj": k, "o_proj": h,
            "gate_proj": f, "up_proj": f, "down_proj": f}


def _dequant_stack(leaf, dtype) -> torch.Tensor:
    """A stacked tensor in `dtype`: as stored, or an int8 {"q", "s"} pair
    times its per-(slot, rank-row) scales (both in `dtype`)."""
    if isinstance(leaf, dict):
        return leaf["q"].to(dtype) * leaf["s"][..., None].to(dtype)
    return leaf.to(dtype)


def grouped_bmm(x2: torch.Tensor, a_t: torch.Tensor, b_s: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """The grouped einsums (the JAX package's `_xla_grouped`, which it
    runs outside any Pallas kernel): x2 [M, C] against every slot's A,
    masked to each row's slot, then the masked [S, M, r] against B ->
    [M, O] f32. Each product takes its inputs' values and sums in f32; the
    masked intermediate is rounded to b_s's dtype, as in JAX. Serves
    prefill rows and int8 stacks."""
    s = a_t.shape[0]
    xa = torch.einsum("mc,src->smr", x2.float(), a_t.float())
    mask = ids.long()[None, :] == torch.arange(s, device=ids.device)[:, None]
    xa = torch.where(mask[:, :, None], xa, torch.zeros((), device=xa.device))
    return torch.einsum("smr,sro->mo", xa.to(b_s.dtype).float(),
                        b_s.float())


def _record(sink: Optional[dict], key: str, m: int, path: str,
            reason: Optional[str]) -> None:
    """The route of (target, rows) into the lora_paths sink, once: a
    route is fixed per (target, rows) for a store."""
    if sink is None or (key, m) in sink:
        return
    entry = {"leaf": key, "rows": m, "path": path}
    if reason:
        entry["fallback_reason"] = reason
    sink[(key, m)] = entry


class LoraBatch:
    """One dispatch's LoRA inputs, passed down the forward: the store, the
    adapter slot ids as a device tensor (checked against the store's slot
    count on the host, where they were built), the engine's lora_paths
    sink, and `mode` - "auto" routes by the plan; "plain" (K7's plain
    version where the plan takes K7) and "grouped" (the grouped einsums
    everywhere) hold a path against the kernel on any device."""

    __slots__ = ("store", "ids", "sink", "mode", "_by_rows")

    def __init__(self, store: "LoraStore", ids, sink: Optional[dict] = None,
                 mode: str = "auto"):
        if mode not in ("auto", "plain", "grouped"):
            raise ValueError(f"lora mode must be auto|plain|grouped, got "
                             f"{mode!r}")
        ids_np = np.asarray(ids, np.int32).reshape(-1)
        slots = store.max_adapters + 1
        if ids_np.size and (ids_np.min() < 0 or ids_np.max() >= slots):
            raise ValueError(f"lora slot ids {ids_np.tolist()} outside the "
                             f"store's {slots} slots")
        self.store = store
        self.ids = torch.as_tensor(ids_np, device=store.device)
        self.sink = sink
        self.mode = mode
        self._by_rows: dict[int, torch.Tensor] = {}

    def ids_for(self, m: int) -> torch.Tensor:
        """One id per row of a [M, C] flattening of the activation: the
        ids as given when they number M, else each repeated M/n times
        (row-major, as the reshape lays the rows out)."""
        n = self.ids.shape[0]
        if n == m:
            return self.ids
        out = self._by_rows.get(m)
        if out is None:
            if m % n:
                raise ValueError(f"{m} activation rows do not spread over "
                                 f"{n} lora ids")
            out = self._by_rows[m] = self.ids.repeat_interleave(m // n)
        return out


def apply_group(keys, x: torch.Tensor, ys, lora: Optional[LoraBatch]):
    """`ys` - the f32 products of targets `keys`, all read from `x` - each
    plus its LoRA delta for the rows of `lora` (a target the store does
    not hold keeps its product). The members K7's route takes (mode "auto"
    or "plain") share one call that adds their deltas in place
    (LoraStore.kernel_add; their products must be contiguous); each other
    member adds the grouped einsums' delta. Returns the products as a
    tuple."""
    ys = list(ys)
    if lora is None:
        return tuple(ys)
    store = lora.store
    held = [n for n, key in enumerate(keys) if key in store.stacked]
    if not held:
        return tuple(ys)
    a = store.stacked[keys[held[0]]]["a"]
    x2 = x.reshape(-1, (a["q"] if isinstance(a, dict) else a).shape[-1])
    m = x2.shape[0]
    ids = lora.ids_for(m)
    reasons = {n: (store.route(keys[n], m, x2.dtype)
                   if lora.mode != "grouped" else "mode:grouped")
               for n in held}
    kernel = [n for n in held if reasons[n] is None]
    if kernel:
        store.kernel_add([keys[n] for n in kernel], x2.contiguous(),
                         [ys[n].view(m, -1) for n in kernel], ids,
                         plain=lora.mode == "plain")
    path = klora.kernel_path(store.device)
    for n in held:
        if reasons[n] is not None:
            ent = store.stacked[keys[n]]
            delta = grouped_bmm(x2, _dequant_stack(ent["a"], x.dtype),
                                _dequant_stack(ent["b"], x.dtype), ids)
            # One kernel: the working-dtype base widens to f32 in the add.
            ys[n] = delta.reshape(ys[n].shape) + ys[n]
        _record(lora.sink, keys[n], m,
                path if reasons[n] is None else PATH_GROUPED, reasons[n])
    return tuple(ys)


def summarize_lora_paths(dispatches: dict, device) -> dict:
    """The lora_paths provenance of describe(): each (target, rows) route
    recorded, sorted, under the kernel path's name on `device` or the
    grouped route."""
    kernel, grouped = [], []
    for e in dispatches.values():
        (grouped if e["path"] == PATH_GROUPED else kernel).append(e)

    def order(e):
        return (e["leaf"], e["rows"])

    return {klora.kernel_path(device): sorted(kernel, key=order),
            PATH_GROUPED: sorted(grouped, key=order)}


# ---------------------------------------------------------------------
# the adapter store
# ---------------------------------------------------------------------


class LoraStore:
    """Adapter A/B pairs keyed by adapter id over stacked device tensors,
    with load/evict, refcounted residency and byte accounting. One per
    engine; every mutation happens on a thread that holds the engine's
    serve lock (the scheduler thread, or a generate call), and slot writes
    are in place on the serving stream, so a dispatch queued before a swap
    reads the old values."""

    def __init__(self, model_cfg, *,
                 max_adapters: int = DEFAULT_MAX_ADAPTERS,
                 rank: int = DEFAULT_RANK, scale: float = DEFAULT_SCALE,
                 dtype=torch.bfloat16, quant: str = "none",
                 adapters: Optional[dict] = None,
                 targets: Optional[list] = None, device="cuda",
                 mesh=None):
        if max_adapters < 1:
            raise ValueError(f"max_adapters must be >= 1, got "
                             f"{max_adapters}")
        if rank < 1:
            raise ValueError(f"lora rank must be >= 1, got {rank}")
        if quant not in ("none", "int8"):
            raise ValueError(
                f"lora quant must be none|int8, got {quant!r}")
        self.rank = rank
        self.scale = float(scale)
        self.max_adapters = max_adapters
        self.dtype = dtype
        self.quant = quant
        self.device = torch.device(device)
        dims = lora_dims(model_cfg)
        if targets:
            unknown = [t for t in targets if t not in dims]
            if unknown:
                raise ValueError(
                    f"unknown lora targets {unknown}; serveable: "
                    f"{sorted(dims)}")
            dims = {k: v for k, v in dims.items() if k in targets}
        self.dims = dims
        # Under a model axis: this rank's shard of each target's stacks -
        # (which axis is split or None, local C, local O) - placed as its
        # base weight (kernels/lora.spmd_dims with base_units).
        self.mesh = mesh if mesh is not None and mesh.model > 1 else None
        self.units = base_units(model_cfg)
        self.shards = {
            key: (klora.spmd_dims(self.mesh, c, o, tp, self.units[key])
                  if self.mesh is not None else (None, c, o))
            for key, (c, o, tp) in dims.items()}
        # Registered persona configs, loadable on demand at acquire:
        # {name: {"seed": int, "init_std": float} or {"path": npz}}.
        self.personas: dict[str, dict] = dict(adapters or {})
        s = max_adapters + 1
        self.stacked: dict[str, dict[str, Any]] = {}
        for key, (_which, c, o) in self.shards.items():
            a = torch.zeros((s, rank, c), dtype=dtype, device=self.device)
            b = torch.zeros((s, rank, o), dtype=dtype, device=self.device)
            if quant == "int8":
                from .quant import quantize_lora_stack
                a = quantize_lora_stack(a, dtype)
                b = quantize_lora_stack(b, dtype)
            self.stacked[key] = {"a": a, "b": b}
        # K7's switch, read once: the routes below are planned per
        # (target, rows, dtype) and kept.
        self.kernel_enabled = klora.enabled()
        self._routes: dict[tuple, Optional[str]] = {}
        # adapter id -> slot (1..max_adapters); slot 0 is the base.
        self._slots: dict[str, int] = {}
        self._free: list[int] = list(range(1, s))
        self._refs: dict[str, int] = {}
        self._last_used: dict[str, float] = {}
        self.loads = 0
        self.evictions = 0
        self.swaps = 0

    # --- routing ---

    def route(self, key: str, m: int, dtype) -> Optional[str]:
        """Why a dispatch of `m` rows at target `key` does not run K7
        (None: it does), planned once per (key, m, dtype): the stack's
        quantization first, then the kill switch, then the kernel's plan
        (K10f's, on the per-shard dims, under a mesh)."""
        k = (key, m, dtype)
        if k not in self._routes:
            c, o, tp = self.dims[key]
            if self.quant != "none":
                reason = QUANT_REASON
            elif not self.kernel_enabled:
                reason = "kernel-disabled"
            elif self.mesh is not None:
                reason = klora.plan_bgmv_spmd(self.mesh, m, c, self.rank, o,
                                              tp, dtype, self.units[key])[1]
            else:
                reason = klora.plan_bgmv(m, c, self.rank, o, dtype)[1]
            self._routes[k] = reason
        return self._routes[k]

    def kernel_add(self, keys, x2: torch.Tensor, ys, ids: torch.Tensor,
                   plain: bool = False) -> None:
        """ys[t] += the delta of target keys[t] for rows x2 [M, C_l], in
        place, through one K7 group call (K10f's group form under a mesh:
        this rank's slices of column targets, or a row target's partial),
        or its plain version with `plain`. The targets read the same x2;
        the caller has routed each of them to the kernel (route)."""
        stacks = [(self.stacked[k]["a"], self.stacked[k]["b"]) for k in keys]
        if self.mesh is None:
            fn = klora.bgmv_add_ref if plain else klora.lora_bgmv_add
            fn(x2, stacks, ys, ids)
            return
        tps = {self.dims[k][2] for k in keys}
        if len(tps) != 1:
            raise ValueError(f"lora targets {list(keys)} mix {sorted(tps)} "
                             f"parallel products in one group")
        fn = (klora.lora_bgmv_add_spmd_ref if plain
              else klora.lora_bgmv_add_spmd)
        reason = fn(self.mesh, x2, stacks, ys, ids,
                    dims=[self.dims[k][:2] for k in keys], tp=tps.pop(),
                    units=[self.units[k] for k in keys])
        if reason is not None:
            raise ValueError(f"lora targets {list(keys)}: K10f declines a "
                             f"dispatch their routes planned: {reason}")

    def decode_declines(self, dtype) -> dict[str, str]:
        """Targets whose decode dispatches K7 would not serve, with the
        reason - the engine refuses them on a card. An int8 store's
        `quant:int8-stack` is the grouped route by design, not a
        decline."""
        out = {}
        for key in self.dims:
            reason = self.route(key, 1, dtype)
            if reason is not None and reason != QUANT_REASON:
                out[key] = reason
        return out

    # --- loading / eviction ---

    def resolvable(self, adapter_id: Optional[str]) -> bool:
        return (adapter_id is None or adapter_id in self._slots
                or adapter_id in self.personas)

    def resident(self) -> list[str]:
        return sorted(self._slots)

    def slot_of(self, adapter_id: str) -> Optional[int]:
        return self._slots.get(adapter_id)

    def adapter_bytes(self) -> int:
        """Device bytes ONE resident adapter costs to store (its A and B
        rows across the targets) on this rank: its shards under a mesh."""
        per_elt = 1 if self.quant == "int8" else torch.empty(
            (), dtype=self.dtype).element_size()
        return sum(self.rank * (c + o) * per_elt
                   for _which, c, o in self.shards.values())

    def resident_bytes(self) -> int:
        return len(self._slots) * self.adapter_bytes()

    def stack_bytes(self) -> int:
        """Bytes of the stacked tensors on this rank (every slot is
        allocated up front)."""
        total = 0
        for ent in self.stacked.values():
            for leaf in ent.values():
                arrs = (leaf["q"], leaf["s"]) if isinstance(leaf, dict) \
                    else (leaf,)
                total += sum(x.numel() * x.element_size() for x in arrs)
        return total

    def register(self, adapter_id: str, spec: Optional[dict] = None
                 ) -> None:
        """Register a persona config ({"seed": int, "init_std": float} or
        {"path": npz}) loadable on demand at acquire."""
        self.personas[adapter_id] = dict(spec or {})

    def make_pair_tree(self, adapter_id: str) -> dict[str, tuple]:
        """An adapter's {key: (a_t [r, C], b [r, O])} host tree from its
        registered persona: an npz (save_pair_tree's layout, the same
        file in both packages), or random pairs from its seed drawn by a
        torch.Generator with the JAX package's distributions (A normal
        times C^-0.5, B normal times init_std; the values differ from
        jax.random's)."""
        spec = self.personas.get(adapter_id)
        if spec is None:
            raise KeyError(
                f"unknown lora adapter {adapter_id!r}; registered: "
                f"{sorted(self.personas)}")
        path = spec.get("path")
        if path:
            data = np.load(path)
            out = {}
            for key in self.dims:
                if f"{key}.a" not in data:
                    raise ValueError(
                        f"lora npz {path} missing target {key!r}")
                out[key] = (np.asarray(data[f"{key}.a"]),
                            np.asarray(data[f"{key}.b"]))
            return out
        seed = int(spec.get("seed", 0))
        std = float(spec.get("init_std", DEFAULT_INIT_STD))
        gen = torch.Generator().manual_seed(seed ^ 0x10A4)
        out = {}
        for key, (c, o, _tp) in sorted(self.dims.items()):
            a = torch.randn((self.rank, c), generator=gen) * (c ** -0.5)
            b = torch.randn((self.rank, o), generator=gen) * std
            out[key] = (a.numpy(), b.numpy())
        return out

    def load(self, adapter_id: str,
             pair_tree: Optional[dict] = None) -> int:
        """Load (or refresh) an adapter into a slot and return the slot.
        `pair_tree` {key: (a_t [r, C], b [r, O])} overrides the registered
        persona. Evicts the LRU unreferenced adapter when the store is
        full; raises when every slot is held by an active serving call."""
        if adapter_id in self._slots and pair_tree is None:
            self._last_used[adapter_id] = time.monotonic()
            return self._slots[adapter_id]
        if pair_tree is None:
            pair_tree = self.make_pair_tree(adapter_id)
        slot = self._slots.get(adapter_id)
        # A swap replaces a slot's previous contents: a refresh of a
        # resident adapter, or a load that had to evict.
        is_swap = slot is not None
        if slot is None:
            if not self._free:
                self._evict_lru()
                is_swap = True
            if not self._free:
                raise RuntimeError(
                    f"lora store exhausted: {self.max_adapters} slots "
                    f"all referenced by active rows - raise "
                    "lora.max_adapters or lower concurrency")
            slot = self._free.pop(0)
            self._slots[adapter_id] = slot
            self._refs.setdefault(adapter_id, 0)
        self._write_slot(slot, pair_tree)
        self._last_used[adapter_id] = time.monotonic()
        self.loads += 1
        if is_swap:
            self.swaps += 1
        return slot

    def _write_slot(self, slot: int, pair_tree: dict) -> None:
        """Every target's slot values, in place: A as given, B times the
        scale, each through f32; under a mesh this rank's slice of the
        whole pair (an int8 stack quantizes the whole rows)."""
        for key in self.stacked:
            if key not in pair_tree:
                raise ValueError(f"lora pair tree missing target "
                                 f"{key!r}")
        for key, ent in self.stacked.items():
            a, b = pair_tree[key]
            c, o, _tp = self.dims[key]
            a = torch.as_tensor(np.asarray(a, np.float32))
            b = torch.as_tensor(np.asarray(b, np.float32)) * self.scale
            if a.shape != (self.rank, c) or b.shape != (self.rank, o):
                raise ValueError(
                    f"lora target {key!r} shape mismatch: got "
                    f"A{tuple(a.shape)} B{tuple(b.shape)}, want "
                    f"A{(self.rank, c)} B{(self.rank, o)}")
            a, b = a.to(self.device), b.to(self.device)
            which, c_l, o_l = self.shards[key]
            cols = {"a": slice(None), "b": slice(None)}
            if which is not None:
                i = self.mesh.model_index
                cols["a" if which == "in" else "b"] = (
                    slice(i * c_l, (i + 1) * c_l) if which == "in"
                    else slice(i * o_l, (i + 1) * o_l))
            if self.quant == "int8":
                from .quant import quantize_lora_slot
                quantize_lora_slot(ent["a"], slot, a, cols["a"])
                quantize_lora_slot(ent["b"], slot, b, cols["b"])
            else:
                ent["a"][slot] = a[:, cols["a"]].to(self.dtype)
                ent["b"][slot] = b[:, cols["b"]].to(self.dtype)

    def _evict_lru(self) -> None:
        victims = [a for a, r in self._refs.items()
                   if r <= 0 and a in self._slots]
        if not victims:
            return
        victim = min(victims,
                     key=lambda a: self._last_used.get(a, 0.0))
        self.evict(victim)

    def evict(self, adapter_id: str) -> bool:
        """Drop an unreferenced adapter: its slot returns to the free list
        and is overwritten by the next load."""
        slot = self._slots.get(adapter_id)
        if slot is None:
            return False
        if self._refs.get(adapter_id, 0) > 0:
            raise RuntimeError(
                f"cannot evict lora adapter {adapter_id!r}: "
                f"{self._refs[adapter_id]} active row(s) reference it")
        del self._slots[adapter_id]
        self._refs.pop(adapter_id, None)
        self._last_used.pop(adapter_id, None)
        self._free.append(slot)
        self.evictions += 1
        return True

    # --- residency / admission ---

    def validate(self, adapter_ids: list, n_turns: int) -> None:
        """Request-shape validation shared by the direct generate path and
        the scheduler's queue mouth: per-turn length, unknown personas,
        and more distinct adapters than the store can ever hold."""
        if len(adapter_ids) != n_turns:
            raise ValueError(
                f"adapters_per_turn has {len(adapter_ids)} entries "
                f"for {n_turns} turns")
        unknown = [a for a in adapter_ids
                   if a is not None and not self.resolvable(a)]
        if unknown:
            raise ValueError(
                f"unknown lora adapters {unknown}; registered: "
                f"{sorted(self.personas)}")
        distinct = {a for a in adapter_ids if a is not None}
        if len(distinct) > self.max_adapters:
            raise ValueError(
                f"request names {len(distinct)} distinct lora "
                f"adapters but the store holds at most "
                f"{self.max_adapters} - raise lora.max_adapters")

    def can_admit(self, adapter_ids: list) -> bool:
        """Would acquiring these adapters succeed now? Free slots plus
        unreferenced residents must cover the new distinct adapters - the
        scheduler's admission backpressure."""
        need = {a for a in adapter_ids
                if a is not None and a not in self._slots}
        if not need:
            return True
        evictable = sum(1 for a, r in self._refs.items()
                        if r <= 0 and a in self._slots)
        return len(need) <= len(self._free) + evictable

    def acquire(self, adapter_ids: list) -> list[int]:
        """Per-row adapter ids (None = base) to slots, loading registered
        personas on demand, one residency ref per row; callers release()
        the same list. Two passes: resident adapters are ref'd first, so a
        later load's LRU eviction never takes an id this request names.
        Exception-atomic: a failure releases the refs this call took
        before it re-raises."""
        slots: list = [None] * len(adapter_ids)
        taken: list = []
        try:
            for i, a in enumerate(adapter_ids):
                if a is None:
                    slots[i] = 0
                elif a in self._slots:
                    self._last_used[a] = time.monotonic()
                    self._refs[a] = self._refs.get(a, 0) + 1
                    taken.append(a)
                    slots[i] = self._slots[a]
            for i, a in enumerate(adapter_ids):
                if slots[i] is None:
                    slot = self.load(a)
                    self._refs[a] = self._refs.get(a, 0) + 1
                    taken.append(a)
                    slots[i] = slot
        except Exception:
            self.release(taken)
            raise
        return slots

    def release(self, adapter_ids: list) -> None:
        for a in adapter_ids:
            if a is None:
                continue
            if a in self._refs:
                self._refs[a] = max(self._refs[a] - 1, 0)

    def warm(self) -> None:
        """Load and evict a throwaway persona twice, so the slot writes'
        first-use costs land at warmup; slot accounting is untouched."""
        name = "__lorawarm__"
        self.personas.setdefault(name, {"seed": 0})
        tree = self.make_pair_tree(name)
        for _ in range(2):
            self.load(name, tree)
        self.evict(name)
        self.personas.pop(name, None)

    def describe(self) -> dict[str, Any]:
        return {
            "rank": self.rank,
            "scale": self.scale,
            "quant": self.quant,
            "max_adapters": self.max_adapters,
            "targets": sorted(self.dims),
            "resident": self.resident(),
            "registered": sorted(self.personas),
            "refs": {a: r for a, r in self._refs.items() if r > 0},
            "adapter_bytes": self.adapter_bytes(),
            "resident_bytes": self.resident_bytes(),
            "stack_bytes": self.stack_bytes(),
            "loads": self.loads,
            "evictions": self.evictions,
            "swaps": self.swaps,
        }


def stack_bytes_for(model_cfg, lora_cfg, dtype_bytes: int = 2) -> int:
    """Closed-form stacked-tensor bytes of a `lora:` config block, with the
    store's defaults and `targets:` restriction (int8 scales omitted)."""
    lc = lora_cfg if isinstance(lora_cfg, dict) else {}
    rank = int(lc.get("rank", DEFAULT_RANK))
    slots = int(lc.get("max_adapters", DEFAULT_MAX_ADAPTERS)) + 1
    per_elt = 1 if lc.get("quant") == "int8" else dtype_bytes
    dims = lora_dims(model_cfg)
    targets = lc.get("targets")
    if targets:
        dims = {k: v for k, v in dims.items() if k in targets}
    return slots * rank * sum(c + o for c, o, _tp in dims.values()) \
        * per_elt


def save_pair_tree(path: str, pair_tree: dict) -> None:
    """Save {key: (a_t, b)} as the npz layout make_pair_tree loads."""
    arrays = {}
    for key, (a, b) in pair_tree.items():
        arrays[f"{key}.a"] = np.asarray(a)
        arrays[f"{key}.b"] = np.asarray(b)
    np.savez(path, **arrays)


# --- test-visibility counters: each dispatch's adapter mix ---

_lock = threading.Lock()
_dispatches = 0
_max_mixed = 0


def reset_test_counters() -> None:
    global _dispatches, _max_mixed
    with _lock:
        _dispatches = 0
        _max_mixed = 0


def note_dispatch_ids(ids) -> None:
    """Record one dispatch's adapter composition (distinct non-base slots
    in one program)."""
    global _dispatches, _max_mixed
    distinct = len({int(x) for x in np.asarray(ids).ravel()} - {0})
    with _lock:
        _dispatches += 1
        if distinct > _max_mixed:
            _max_mixed = distinct


def dispatches_seen() -> int:
    return _dispatches


def max_mixed_seen() -> int:
    return _max_mixed
