"""Grouped LoRA BGMV (K7): the hand-written CUDA kernel, its plain PyTorch
version and its plan (counterpart of
theroundtaible_tpu/engine/pallas/lora.py).

The multi-LoRA persona path adds, at each tagged projection, the delta
`x . A_id^T . B_id` of every row's adapter slot `id` (slot 0 is the
all-zero base adapter) to the shared base product (engine/lora.py).
`lora_bgmv(x2, a_t, b_s, ids)` computes it for decode-sized row counts:
ids [M] int32, x2 [M, C], a_t [S, r, C] (A stored transposed), b_s
[S, r, O] -> delta [M, O] f32, with the TPU kernel's numerics: xa =
x2 . a_t[id]^T summed in f32 and rounded to x2's dtype, then xa . b_s[id]
in f32 (csrc/bgmv.cu).

The plan (`plan_bgmv`) keeps the JAX package's reason strings and its
rules for rows (`rows:prefill-m` past 64 rows: prefill takes the grouped
einsums of engine/lora.py) and rank (`rank:unsupported` outside 1..512).
The TPU's lane alignment (C and O multiples of 128) and VMEM budget give
way to the CUDA kernel's own constraints:

- x2, a_t and b_s share one dtype, float32 or bfloat16 (`dtype:<dtype>`);
- C and O are multiples of the 16-byte vector a thread loads: 8 bf16 or 4
  f32 values (`dims:contract-misaligned`, `dims:out-misaligned`).

The engine plans each (target, rows) once (engine/lora.LoraStore.route).
ROUNDTABLE_LORA_MM=0, read when a store is built, declines every dispatch
(`kernel-disabled`): the CPU then serves the grouped einsums, and a card
refuses to build the engine. The wrapper takes the plain version only for
a CPU tensor; on a CUDA tensor it launches the kernel or raises. Each
launch adds one to its count (launch_counts()).

Under a tensor-parallel mesh `lora_bgmv_spmd` (K10f, the counterpart of
the TPU package's lora_bgmv_spmd) runs K7 on this rank's shard of a
target's stacks: a column-parallel target ("col": q/k/v, gate/up) shards
B's output axis and gives the rank its slice of the delta; a row-parallel
one ("row": o_proj, down_proj) shards A's contraction and gives the rank a
partial delta, which the caller all-reduces once with the base product
(models/common._row_parallel). Where the model axis does not divide the
sharded axis the stacks are whole on every rank. The plan runs on the
per-shard dims, a sharded target's decline carrying "/sharded". A launch
counts under lora_bgmv_spmd and under lora_bgmv.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch

from . import build

KERNELS = ("lora_bgmv",)
# K10f: a launch on a card counts here AND under lora_bgmv.
SPMD_WRAPPERS = ("lora_bgmv_spmd",)
_launches = dict.fromkeys(KERNELS + SPMD_WRAPPERS, 0)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Decode kernel only: past this many rows the grouped einsums amortize
# over the rows (the JAX package's _MAX_ROWS).
MAX_ROWS = 64
MAX_RANK = 512
_VEC_BYTES = 16


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def enabled() -> bool:
    """The kernel path is on by default; ROUNDTABLE_LORA_MM=0 declines
    every dispatch (`kernel-disabled`), as ROUNDTABLE_INT4_MM=0 does for
    K5/K6."""
    return os.environ.get("ROUNDTABLE_LORA_MM", "") != "0"


def kernel_path(device) -> str:
    """Provenance name of the kernel path on `device`."""
    return ("cuda_bgmv" if torch.device(device).type == "cuda"
            else "plain_bgmv")


@functools.lru_cache(maxsize=None)
def plan_bgmv(m_rows: int, c_dim: int, r: int, o_dim: int,
              dtype=torch.bfloat16):
    """((cols_per_block,), None) when the kernel takes a grouped BGMV of
    these dims, else (None, reason) - the JAX package's plan_bgmv with the
    card's constraints in place of the TPU's alignment and VMEM budget."""
    if m_rows > MAX_ROWS:
        return None, "rows:prefill-m"
    if r < 1 or r > MAX_RANK:
        return None, "rank:unsupported"
    if dtype not in _DTYPE_CODES:
        return None, f"dtype:{str(dtype).replace('torch.', '')}"
    vec = _VEC_BYTES // torch.empty((), dtype=dtype).element_size()
    if c_dim % vec:
        return None, "dims:contract-misaligned"
    if o_dim % vec:
        return None, "dims:out-misaligned"
    return (256 * vec,), None


# --- plain version ---


def bgmv_ref(x2: torch.Tensor, a_t: torch.Tensor, b_s: torch.Tensor,
             ids: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: per row i, xa = x2[i] . a_t[ids[i]]^T in f32
    rounded to x2's dtype, then xa . b_s[ids[i]] in f32 -> [M, O] f32."""
    idx = ids.long()
    xa = torch.einsum("mc,mrc->mr", x2.float(), a_t[idx].float())
    xa = xa.to(x2.dtype).float()
    return torch.einsum("mr,mro->mo", xa, b_s[idx].float())


# --- kernel wrapper ---


def _check(x2, a_t, b_s, ids, what: str) -> None:
    if x2.dim() != 2 or a_t.dim() != 3 or b_s.dim() != 3 or ids.dim() != 1:
        raise ValueError(f"{what}: x2 [M, C], a_t [S, r, C], b_s [S, r, O] "
                         f"and ids [M], got {tuple(x2.shape)}, "
                         f"{tuple(a_t.shape)}, {tuple(b_s.shape)}, "
                         f"{tuple(ids.shape)}")
    m, c = x2.shape
    s, r, _o = b_s.shape
    if a_t.shape != (s, r, c) or ids.shape[0] != m:
        raise ValueError(f"{what}: a_t {tuple(a_t.shape)}, b_s "
                         f"{tuple(b_s.shape)}, ids {tuple(ids.shape)} do "
                         f"not match x2 {tuple(x2.shape)}")
    if ids.dtype != torch.int32:
        raise ValueError(f"{what}: ids must be int32, got {ids.dtype}")
    if len({x2.device, a_t.device, b_s.device, ids.device}) != 1:
        raise ValueError(f"{what}: operands on several devices")


def _cuda_operands(x2, a_t, b_s, ids, what: str) -> None:
    if a_t.dtype != x2.dtype or b_s.dtype != x2.dtype:
        raise ValueError(f"{what}: a_t and b_s must be in x2's dtype "
                         f"{x2.dtype}, got {a_t.dtype}, {b_s.dtype}")
    m, c = x2.shape
    _s, r, o = b_s.shape
    _plan, reason = plan_bgmv(m, c, r, o, x2.dtype)
    if reason is not None:
        raise ValueError(f"{what} declines: {reason}")
    for name, t in (("x2", x2), ("a_t", a_t), ("b_s", b_s), ("ids", ids)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % _VEC_BYTES:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def lora_bgmv(x2: torch.Tensor, a_t: torch.Tensor, b_s: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """ids [M] int32, x2 [M, C], a_t [S, r, C], b_s [S, r, O] -> delta
    [M, O] f32 (K7). Every id must lie in [0, S): the caller checks them
    on the host, where it builds them (engine/lora.LoraBatch); the kernel
    reads them unchecked."""
    what = "lora_bgmv"
    _check(x2, a_t, b_s, ids, what)
    if x2.device.type == "cpu":
        return bgmv_ref(x2, a_t, b_s, ids)
    _cuda_operands(x2, a_t, b_s, ids, what)
    m, c = x2.shape
    s, r, o = b_s.shape
    out = torch.empty((m, o), dtype=torch.float32, device=x2.device)
    rc = build.library("bgmv").rt_bgmv(
        ids.data_ptr(), x2.data_ptr(), a_t.data_ptr(), b_s.data_ptr(),
        out.data_ptr(), m, c, r, o, s, _DTYPE_CODES[x2.dtype],
        x2.device.index or 0,
        torch.cuda.current_stream(x2.device).cuda_stream)
    build.check(rc, f"{what} launch")
    _launches[what] += 1
    return out


def lora_bgmv_or_reason(x2: torch.Tensor, a_t: torch.Tensor,
                        b_s: torch.Tensor, ids: torch.Tensor):
    """(delta [M, O] f32, None) on the kernel path (its plain version on
    the CPU), (None, reason) when the plan declines this dispatch and the
    caller serves the grouped einsums - the JAX package's contract."""
    m, c = x2.shape
    _s, r, o = b_s.shape
    _plan, reason = plan_bgmv(m, c, r, o, x2.dtype)
    if reason is not None:
        return None, reason
    return lora_bgmv(x2, a_t, b_s, ids), None


# --- K10f: the kernel under a (data, model) mesh ---


def spmd_dims(mesh, c_dim: int, o_dim: int, tp: Optional[str],
              units: int) -> tuple:
    """(which, local C, local O) of a target of global (C, O) under `mesh`:
    which stack axis carries the model shards - "in" (A's contraction, tp
    "row") or "out" (B's output, tp "col") - where the model axis divides
    `units`, the count of whole units along it, else None (the stacks
    whole on every rank). The engine's store passes its base weight's
    heads or hidden count (engine/lora.base_units), so a stack is split
    exactly where its base weight is. The JAX package divides the flat
    dim itself: passing the flat dim as `units` gives its placement."""
    from ..sharding import lora_shard_axis
    which = lora_shard_axis(tp) if mesh.model > 1 else None
    if which is not None and not mesh.splits(units):
        which = None
    return (which, c_dim // mesh.model if which == "in" else c_dim,
            o_dim // mesh.model if which == "out" else o_dim)


def plan_bgmv_spmd(mesh, m_rows: int, c_dim: int, r: int, o_dim: int,
                   tp: Optional[str], dtype, units: int):
    """plan_bgmv on the per-shard dims of a target of global (C, O) under
    `mesh`, "/sharded" added to a sharded target's reason (the JAX
    package's lora_bgmv_spmd plan)."""
    which, c_l, o_l = spmd_dims(mesh, c_dim, o_dim, tp, units)
    plan, reason = plan_bgmv(m_rows, c_l, r, o_l, dtype)
    if reason is not None and which is not None:
        reason += "/sharded"
    return plan, reason


def _spmd(mesh, x2, a_t, b_s, ids, dims, tp, units, plain: bool):
    what = "lora_bgmv_spmd"
    c_dim, o_dim = dims
    which, c_l, o_l = spmd_dims(mesh, c_dim, o_dim, tp, units)
    s, r = b_s.shape[:2]
    want = ((x2.shape[0], c_l), (s, r, c_l), (s, r, o_l))
    got = (tuple(x2.shape), tuple(a_t.shape), tuple(b_s.shape))
    if got != want:
        raise ValueError(
            f"{what}: local x2/a_t/b_s {got} are not this rank's shard "
            f"{want} of (C, O) {tuple(dims)} ({tp}) on mesh {mesh.shape}")
    _plan, reason = plan_bgmv_spmd(mesh, x2.shape[0], c_dim, r, o_dim, tp,
                                   x2.dtype, units)
    if reason is not None:
        return None, reason
    if plain:
        return bgmv_ref(x2, a_t, b_s, ids), None
    delta = lora_bgmv(x2, a_t, b_s, ids)
    if delta.is_cuda:
        _launches[what] += 1
    return delta, None


def lora_bgmv_spmd(mesh, x2: torch.Tensor, a_t: torch.Tensor,
                   b_s: torch.Tensor, ids: torch.Tensor, *, dims,
                   tp: Optional[str], units: int):
    """K10f (the TPU package's lora.py:179): K7 on this rank's shard of a
    target of global (C, O) = `dims` under `mesh`. x2 [M, C_l] is the
    rank's local activation (the whole input for "col", its slice of the
    contraction for a sharded "row"), a_t [S, r, C_l] and b_s [S, r, O_l]
    its shards of the stacks (spmd_dims, with `units` as there). Returns
    (delta [M, O_l] f32, None) - the rank's output slice for "col", its
    partial delta for a sharded "row", which the caller all-reduces once -
    or (None, reason) where the plan declines the per-shard dims. K7 on a
    card (raising where it cannot launch), its plain version on the CPU;
    local tensors that are not the rank's shard raise."""
    return _spmd(mesh, x2, a_t, b_s, ids, dims, tp, units,
                 plain=x2.device.type == "cpu")


def lora_bgmv_spmd_ref(mesh, x2: torch.Tensor, a_t: torch.Tensor,
                       b_s: torch.Tensor, ids: torch.Tensor, *, dims,
                       tp: Optional[str], units: int):
    """Plain version of lora_bgmv_spmd: K7's plain version on the same
    shard, on any device (counts nothing)."""
    return _spmd(mesh, x2, a_t, b_s, ids, dims, tp, units, plain=True)
