"""Grouped LoRA BGMV (K7): the hand-written CUDA kernel, its plain PyTorch
version and its plan (counterpart of
theroundtaible_tpu/engine/pallas/lora.py).

The multi-LoRA persona path adds, at each tagged projection, the delta
`x . A_id^T . B_id` of every row's adapter slot `id` (slot 0 is the
all-zero base adapter) to the shared base product (engine/lora.py). The
kernel (csrc/bgmv.cu) serves decode-sized row counts with the TPU
kernel's numerics: xa = x2 . a_t[id]^T summed in f32 and rounded to x2's
dtype, then xa . b_s[id] in f32. Two entry points:

- `lora_bgmv_add(x2, stacks, ys, ids)`, the engine's: a group of up to
  three targets that read the same x2 [M, C] (q/k/v, gate/up, or one of
  o_proj, down_proj), `stacks` their (a_t [S, r, C], b_s [S, r, O_t])
  pairs, `ys` their f32 contiguous base products [M, O_t], each updated
  in place (y += delta; fl(y + delta) is the rounding a separate add
  makes). One call is two kernel launches (the shrink over C, the expand
  over the outputs, csrc/bgmv.cu); base rows leave y untouched.
- `lora_bgmv(x2, a_t, b_s, ids)`, the JAX package's one-target form: a
  fresh delta [M, O] f32, base rows zero (the same kernel adding into
  zeros).

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
refuses to build the engine. The wrappers take the plain versions only
for a CPU tensor; on a CUDA tensor they launch the kernel or raise. Each
wrapper call that launches adds one to the count `lora_bgmv`
(launch_counts()), whatever its target count.

Under a tensor-parallel mesh K10f (the counterpart of the TPU package's
lora_bgmv_spmd) runs K7 on this rank's shard of a target's stacks: a
column-parallel target ("col": q/k/v, gate/up) shards B's output axis and
gives the rank its slice of the delta; a row-parallel one ("row": o_proj,
down_proj) shards A's contraction and gives the rank a partial delta,
which the caller all-reduces once with the base product
(models/common._row_parallel). Where the model axis does not divide the
sharded axis the stacks are whole on every rank. The plan runs on the
per-shard dims, a sharded target's decline carrying "/sharded".
`lora_bgmv_spmd` is the one-target form, `lora_bgmv_add_spmd` the
engine's group form (a column group shares its whole x2; a row target is
a group of one). A launch counts under lora_bgmv_spmd and under
lora_bgmv.
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
# Targets of one launch: q/k/v share their input.
MAX_TARGETS = 3
_VEC_BYTES = 16
# 16-byte vectors of C per shrink block (four per lane).
_SLICE_VECS = 128
# Per (device, stream): the f32 workspace of the shrink's partial sums.
_workspaces: dict = {}


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
    """((c_splits,), None) when the kernel takes a grouped BGMV of these
    dims, else (None, reason) - the JAX package's plan_bgmv with the
    card's constraints in place of the TPU's alignment and VMEM budget. C
    is cut into slices of 128 16-byte vectors (the shrink's blocks, a
    count that depends on C and the dtype only)."""
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
    return (-(-(c_dim // vec) // _SLICE_VECS),), None


# --- plain version ---


def bgmv_ref(x2: torch.Tensor, a_t: torch.Tensor, b_s: torch.Tensor,
             ids: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: per row i, xa = x2[i] . a_t[ids[i]]^T in f32
    rounded to x2's dtype, then xa . b_s[ids[i]] in f32 -> [M, O] f32."""
    idx = ids.long()
    xa = torch.einsum("mc,mrc->mr", x2.float(), a_t[idx].float())
    xa = xa.to(x2.dtype).float()
    return torch.einsum("mr,mro->mo", xa, b_s[idx].float())


def bgmv_add_ref(x2: torch.Tensor, stacks, ys, ids: torch.Tensor) -> None:
    """Plain version of lora_bgmv_add: y += bgmv_ref(x2, a_t, b_s, ids)
    for each (a_t, b_s) of `stacks` and y of `ys`, in place."""
    for (a_t, b_s), y in zip(stacks, ys):
        y += bgmv_ref(x2, a_t, b_s, ids)


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


def _check_group(x2, stacks, ys, ids, what: str) -> None:
    """A group: 1-3 (a_t, b_s) pairs of one slot count and rank that
    contract with x2, each with its f32 contiguous [M, O_t] y on x2's
    device; no y overlaps x2 or another y. Once per engine call, so kept
    to a few attribute reads per member."""
    n = len(stacks)
    if not 1 <= n <= MAX_TARGETS or len(ys) != n:
        raise ValueError(f"{what}: 1-{MAX_TARGETS} (a_t, b_s) pairs and as "
                         f"many ys, got {n} and {len(ys)}")
    _check(x2, *stacks[0], ids, what)
    m, c = x2.shape
    s, r, _o = stacks[0][1].shape
    dev = x2.device
    spans = [(x2.data_ptr(), x2.data_ptr() + x2.numel() * x2.element_size())]
    for k, ((a_t, b_s), y) in enumerate(zip(stacks, ys)):
        if k:
            if b_s.dim() != 3 or b_s.shape[:2] != (s, r):
                raise ValueError(f"{what}: members' slots and ranks differ: "
                                 f"{tuple(b_s.shape)}, {(s, r)}")
            if a_t.shape != (s, r, c):
                raise ValueError(f"{what}: a_t {tuple(a_t.shape)}, b_s "
                                 f"{tuple(b_s.shape)} do not match x2 "
                                 f"{tuple(x2.shape)}")
            if a_t.device != dev or b_s.device != dev:
                raise ValueError(f"{what}: operands on several devices")
        if y.shape != (m, b_s.shape[2]):
            raise ValueError(f"{what}: y {k} is {tuple(y.shape)}, not the "
                             f"rows' product {(m, b_s.shape[2])}")
        if y.dtype != torch.float32:
            raise ValueError(f"{what}: y {k} must be float32, got {y.dtype}")
        if not y.is_contiguous():
            raise ValueError(f"{what}: y {k} must be contiguous")
        if y.device != dev:
            raise ValueError(f"{what}: y {k} on {y.device}, x2 on {dev}")
        lo = y.data_ptr()
        hi = lo + 4 * y.numel()
        if any(lo < b and a < hi for a, b in spans):
            raise ValueError(f"{what}: y {k} overlaps x2 or another y")
        spans.append((lo, hi))


def _cuda_group(x2, stacks, ys, ids, what: str) -> None:
    """_cuda_operands for a checked group: every member's dtype, plan,
    contiguity and alignment, x2's and ids' once, and each y's
    alignment."""
    _cuda_operands(x2, *stacks[0], ids, what)
    m, c = x2.shape
    for a_t, b_s in stacks[1:]:
        if a_t.dtype != x2.dtype or b_s.dtype != x2.dtype:
            raise ValueError(f"{what}: a_t and b_s must be in x2's dtype "
                             f"{x2.dtype}, got {a_t.dtype}, {b_s.dtype}")
        reason = plan_bgmv(m, c, b_s.shape[1], b_s.shape[2], x2.dtype)[1]
        if reason is not None:
            raise ValueError(f"{what} declines: {reason}")
        for name, t in (("a_t", a_t), ("b_s", b_s)):
            if not t.is_contiguous():
                raise ValueError(f"{what}: {name} must be contiguous")
            if t.data_ptr() % _VEC_BYTES:
                raise ValueError(f"{what}: {name} must be 16-byte aligned")
    for k, y in enumerate(ys):
        if y.data_ptr() % _VEC_BYTES:
            raise ValueError(f"{what}: y {k} must be 16-byte aligned")


def _group_workspace(device, stream: int, n: int) -> torch.Tensor:
    """The shrink's f32 partial sums, kept per (device, stream): calls on
    one stream run in order, so each reuses the last one's buffer."""
    key = (device.index or 0, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < n:
        ws = _workspaces[key] = torch.empty(max(n, 1 << 16),
                                            dtype=torch.float32,
                                            device=device)
    return ws


def _launch_group(x2, stacks, ys, ids) -> None:
    """K7's two launches on checked CUDA operands: y += delta for each
    member of the group."""
    m, c = x2.shape
    s, r = stacks[0][1].shape[:2]
    (splits,), _ = plan_bgmv(m, c, r, ys[0].shape[1], x2.dtype)
    index = x2.device.index or 0
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    n = len(stacks)
    part = _group_workspace(x2.device, stream, n * splits * m * r)
    pad = [None] * (MAX_TARGETS - n)
    rc = build.library("bgmv").rt_bgmv_add(
        ids.data_ptr(), x2.data_ptr(),
        *[a.data_ptr() for a, _ in stacks], *pad,
        *[b.data_ptr() for _, b in stacks], *pad,
        *[y.data_ptr() for y in ys], *pad,
        *[y.shape[1] for y in ys], *[0] * (MAX_TARGETS - n),
        n, m, c, r, s, splits, _DTYPE_CODES[x2.dtype], part.data_ptr(),
        index, stream)
    build.check(rc, "lora_bgmv launch")


def lora_bgmv_add(x2: torch.Tensor, stacks, ys, ids: torch.Tensor) -> None:
    """ys[t] += delta of (a_t, b_s) = stacks[t] for ids [M] int32 and x2
    [M, C] (K7's group form, one call per input group): `stacks` holds 1-3
    (a_t [S, r, C], b_s [S, r, O_t]) pairs, `ys` their f32 contiguous [M,
    O_t] base products, updated in place. Every id must lie in [0, S):
    the caller checks them on the host, where it builds them
    (engine/lora.LoraBatch); the kernel reads them unchecked."""
    what = "lora_bgmv_add"
    stacks, ys = list(stacks), list(ys)
    _check_group(x2, stacks, ys, ids, what)
    if x2.device.type == "cpu":
        bgmv_add_ref(x2, stacks, ys, ids)
        return
    _cuda_group(x2, stacks, ys, ids, what)
    _launch_group(x2, stacks, ys, ids)
    _launches["lora_bgmv"] += 1


def lora_bgmv(x2: torch.Tensor, a_t: torch.Tensor, b_s: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """ids [M] int32, x2 [M, C], a_t [S, r, C], b_s [S, r, O] -> delta
    [M, O] f32 (K7's one-target form: the group kernel adding into zeros,
    so a base row's delta is exactly zero). Every id must lie in [0, S):
    the caller checks them on the host; the kernel reads them
    unchecked."""
    what = "lora_bgmv"
    _check(x2, a_t, b_s, ids, what)
    if x2.device.type == "cpu":
        return bgmv_ref(x2, a_t, b_s, ids)
    _cuda_operands(x2, a_t, b_s, ids, what)
    out = torch.zeros((x2.shape[0], b_s.shape[2]), dtype=torch.float32,
                      device=x2.device)
    _launch_group(x2, [(a_t, b_s)], [out], ids)
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


def _local_reason(mesh, x2, a_t, b_s, dims, tp, units, what: str):
    """The plan's reason for this rank's shard of a target of global (C,
    O) = `dims` (None: K10f serves it); raises where the local tensors are
    not that shard."""
    c_dim, o_dim = dims
    _which, c_l, o_l = spmd_dims(mesh, c_dim, o_dim, tp, units)
    s, r = b_s.shape[:2]
    want = ((x2.shape[0], c_l), (s, r, c_l), (s, r, o_l))
    got = (tuple(x2.shape), tuple(a_t.shape), tuple(b_s.shape))
    if got != want:
        raise ValueError(
            f"{what}: local x2/a_t/b_s {got} are not this rank's shard "
            f"{want} of (C, O) {tuple(dims)} ({tp}) on mesh {mesh.shape}")
    return plan_bgmv_spmd(mesh, x2.shape[0], c_dim, r, o_dim, tp, x2.dtype,
                          units)[1]


def _spmd(mesh, x2, a_t, b_s, ids, dims, tp, units, plain: bool):
    what = "lora_bgmv_spmd"
    reason = _local_reason(mesh, x2, a_t, b_s, dims, tp, units, what)
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


def _spmd_add(mesh, x2, stacks, ys, ids, dims, tp, units,
              plain: bool) -> Optional[str]:
    what = "lora_bgmv_spmd"
    stacks, ys = list(stacks), list(ys)
    if not len(stacks) == len(ys) == len(dims) == len(units):
        raise ValueError(f"{what}: {len(stacks)} stacks, {len(ys)} ys, "
                         f"{len(dims)} dims and {len(units)} units")
    for (a_t, b_s), d, u in zip(stacks, dims, units):
        reason = _local_reason(mesh, x2, a_t, b_s, d, tp, u, what)
        if reason is not None:
            return reason
    if plain:
        _check_group(x2, stacks, ys, ids, what)
        bgmv_add_ref(x2, stacks, ys, ids)
        return None
    lora_bgmv_add(x2, stacks, ys, ids)
    if x2.is_cuda:
        _launches[what] += 1
    return None


def lora_bgmv_add_spmd(mesh, x2: torch.Tensor, stacks, ys,
                       ids: torch.Tensor, *, dims, tp: Optional[str],
                       units) -> Optional[str]:
    """K10f's group form: K7's lora_bgmv_add on this rank's shards of a
    group of targets that share x2 [M, C_l], each of global (C, O) =
    dims[t] with units[t] (spmd_dims), all of one `tp` - a column group
    (q/k/v, gate/up: the whole x2, each y the rank's [M, O_l] slice) or a
    row target alone (o_proj, down_proj: x2 the rank's slice of the
    contraction, y its partial product, which the caller all-reduces
    once). Returns None once every y holds its delta, or the plan's
    reason for the first member it declines (ys untouched). K7 on a card
    (raising where it cannot launch), its plain version on the CPU; local
    tensors that are not the rank's shard raise."""
    return _spmd_add(mesh, x2, stacks, ys, ids, dims, tp, units,
                     plain=x2.device.type == "cpu")


def lora_bgmv_add_spmd_ref(mesh, x2: torch.Tensor, stacks, ys,
                           ids: torch.Tensor, *, dims, tp: Optional[str],
                           units) -> Optional[str]:
    """Plain version of lora_bgmv_add_spmd, on any device (counts
    nothing)."""
    return _spmd_add(mesh, x2, stacks, ys, ids, dims, tp, units,
                     plain=True)
