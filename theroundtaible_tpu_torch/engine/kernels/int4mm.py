"""w4a16 decode products: hand-written CUDA kernels, their plain PyTorch
versions, and their plan (counterpart of
theroundtaible_tpu/engine/pallas/int4mm.py).

An Int4Leaf (engine/quant.py) packs two signed nibbles per int8 byte along
the weight's last axis, even element in the low nibble, with one scale in
the activation dtype per `group` elements (gp = group / 2 packed bytes).
Two kernels cover every serving call site at decode (M <= 64 activation
rows), streaming the packed bytes instead of a dequantized copy:

- mm_pack_out (K5, csrc/int4mm.cu) - x [M, C] . unpack(q4 [C, P],
  s4 [C, P/gp]) -> [M, 2P] f32, output column 2k from byte k's low
  nibble and 2k+1 from its high one: every per-layer projection (the
  packed axis is an output axis). Replaces the TPU kernel `_mm_pack_out`.
- mm_pack_contract (K6, csrc/int4mm.cu) - x [M, 2Cp] . unpack(q4 [N, Cp],
  s4 [N, Cp/gp])^T -> [M, N] f32: the lm head ("bte,ve->btv", the packed
  axis is contracted), tied or not. Replaces the TPU kernel
  `_mm_pack_contract`; x's even and odd columns are read in place.

Numerics of both (and of models/common.dequant_int4): each nibble times
its scale in the activation dtype, rounded to it, then f32 products and
sums, in an order that is the same on every call. bf16 and f16 run tensor-core
bodies (mma.sync), f32 the CUDA-core ones.

Each leaf is planned once, when it is made (quant.quantize_params,
weights.params_from_numpy): `plan_leaf` classifies its call site
(`classify`, the JAX package's, with its reason strings) and checks the
kernels' block constraints, which take the place of the TPU plan's VMEM
budget; the leaf keeps the Int4Plan. Each launch follows `out_plan` (K5's
C splits and column tiles) or `contract_plan` (K6's blocks and staged
pieces of x): functions of the shapes and the SM count only. A product
then only counts its activation rows (`einsum_int4_or_reason`): up to 64
run the planned kernel, more (prefill) take the dequant path with
`rows:prefill-m`, as in the JAX package. A leaf whose plan declines takes
the dequant path on the CPU, with the reason; on a CUDA tensor it raises,
and the engine refuses such a leaf when it is built. The one exception is
the MoE expert gate/up ("bte,xef->btxf", DEQUANT_SPECS): its weight keeps
the expert axis ahead of the contraction, no kernel takes it
(`spec:mixed-kept-contracted`), and the JAX package computes it outside
any Pallas kernel too, so it takes the dequant path on every device. The
expert down ("btxf,xfe->bte") is pack-on-output with two contracted axes
(C = X * F) and runs K5 like every other decode product. ROUNDTABLE_INT4_MM=0,
read when a leaf is planned, declines every leaf (`kernel-disabled`). The
CPU runs the plain versions where a card runs the kernels; each launch
adds one to its count (launch_counts()).

Under a tensor-parallel mesh (engine/sharding.py Mesh) `einsum_int4_spmd`
(K10e, the counterpart of the TPU package's einsum_int4_spmd) runs the same
kernels on this rank's shard of the leaf: column-parallel products (q/k/v,
gate/up, the head) on the rank's output slice, row-parallel ones (o_proj,
down_proj) on its slice of the contraction. It takes the rank's local leaf,
the global weight shape and the call site's `tp`; the leaf must carry
the plan sharding.plan_int4_shard made for that mesh: split where
sharding.int4_shard_axis says and the mesh divides both q4 and s4 (else
whole on every rank), checked to be that shard, planned on the per-shard
shapes, a decline of a sharded leaf carrying the JAX package's "/sharded"
suffix. A row product returns this
rank's partial sum: the one all-reduce per row-parallel projection belongs
to the forward (models/common._row_parallel), after the int8 scale and the
LoRA delta are added, so it never runs twice. A launch counts under
einsum_int4_spmd and under the kernel it ran.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import torch

from . import build

KERNELS = ("mm_pack_out", "mm_pack_contract")
# K10e: a launch on a card counts here AND under the kernel it ran.
SPMD_WRAPPERS = ("einsum_int4_spmd",)
_launches = dict.fromkeys(KERNELS + SPMD_WRAPPERS, 0)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
PATH_DEQUANT = "xla_dequant"
# Call sites whose products no kernel serves on any device: the JAX package
# computes them outside Pallas (its XLA dequant path), so they are not a
# kernel's decline on a card.
DEQUANT_SPECS = ("bte,xef->btxf",)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def enabled() -> bool:
    """The kernel path is on by default; ROUNDTABLE_INT4_MM=0 declines
    every leaf planned while it is set (`kernel-disabled`): the CPU then
    serves every product through the dequant path, and a card refuses the
    leaves."""
    return os.environ.get("ROUNDTABLE_INT4_MM", "") != "0"


def kernel_path(device) -> str:
    """Provenance name of the kernel path on `device`."""
    return ("cuda_w4a16" if torch.device(device).type == "cuda"
            else "plain_w4a16")


# --- the plan ---


def classify(spec: str, leaf):
    """((mode, n_cont, gp), None) with mode "out" (weight = contracted
    prefix + kept axes, pack axis kept-minor) or "contract" (kept + one
    contracted pack axis: the lm head), or (None, reason) when neither
    kernel serves the spec."""
    lhs, out_dims = spec.split("->")
    a_dims, b_dims = lhs.split(",")
    cont = [d for d in b_dims if d in a_dims]
    kept = [d for d in b_dims if d not in a_dims]
    if not cont or not kept:
        return None, "spec:no-contraction-or-kept"
    if a_dims[-len(cont):] != "".join(cont):
        return None, "spec:cont-not-activation-suffix"
    batch = a_dims[:-len(cont)]
    if out_dims != batch + "".join(kept):
        return None, "spec:out-layout"
    if leaf.axis != leaf.q4.dim() - 1:
        return None, "pack:non-minor-axis"
    if leaf.group % 2:
        return None, "pack:odd-group"
    gp = leaf.group // 2
    if list(b_dims) == cont + kept:
        return ("out", len(cont), gp), None
    if list(b_dims) == kept + cont and len(cont) == 1:
        return ("contract", 1, gp), None
    return None, "spec:mixed-kept-contracted"


# Decode kernels: above this many activation rows a product takes the
# dequant path, where the dequantized weight amortizes over the rows (the
# JAX package's _plan_rows: rows padded to 8, at most 64).
MAX_ROWS = 64

# The CUDA kernels' constraints (csrc/int4mm.cu): a thread loads 16 packed
# bytes that share one scale, so the packed width and the packed group
# are multiples of 16. K6's f32 body stages 4 rows of x in shared memory
# as f32, so its width is bounded; the bf16 bodies stage x in pieces.
_VEC_BYTES = 16
_SMEM_LIMIT = 227 * 1024


def _kernel_reason(mode: str, packed: int, gp: int, dtype) -> Optional[str]:
    """Why the CUDA kernel of `mode` declines these operands (None: it
    takes them). `packed`: P for K5, Cp for K6."""
    if dtype not in _DTYPE_CODES:
        return f"dtype:{dtype}"
    if gp % _VEC_BYTES:
        return f"pack:group {2 * gp} not a multiple of {2 * _VEC_BYTES}"
    if packed % _VEC_BYTES:
        return f"blocks:packed width {packed} not a multiple of {_VEC_BYTES}"
    if mode == "contract" and dtype == torch.float32 \
            and _f32_contract_smem_bytes(packed) > _SMEM_LIMIT:
        return f"smem:{_f32_contract_smem_bytes(packed)}"
    return None


def _f32_contract_smem_bytes(cp: int) -> int:
    """K6 f32's staged x: 4 rows of 2*cp values as f32, each 32-value
    chunk padded to 36 (conflict-free float4 reads)."""
    return 4 * 4 * (cp // _VEC_BYTES) * 36


# --- the launch plans (shapes and the SM count only) ---

# K5 bf16 (mm_pack_out_tc_kernel): a block owns 128 packed bytes (256
# output columns) and one split of C; C is split for about four blocks per
# SM, a split a whole number of 32-row ring stages, at least 128 rows per
# n-tile where C allows (the splits' partial sums grow with the rows of
# x) and at most 960 (x's split rows are staged whole: 8 * NT rows of 976
# bf16).
_OUT_BYTES = 128
_OUT_STAGE_ROWS = 32
_OUT_MIN_ROWS = 128
_OUT_MAX_ROWS = 960
_OUT_BLOCKS_PER_SM = 4
# K5 f32 (mm_pack_out_kernel): 512-byte column tiles, splits of 64 to 1024
# rows, a multiple of 8.
_F32_OUT_BYTES = 512
_F32_MAX_ROWS = 1024
# K6 bf16 (mm_pack_contract_tc_kernel): 8 warps of 16 vocab rows a block,
# at most two blocks per SM; x staged in pieces of E (multiples of 128)
# whose 8 * NT rows fit 64 KB. K6 f32: 8 warps of one vocab row, at most
# four blocks per SM.
_CON_WARPS = 8
_CON_X_BYTES = 64 * 1024


def n_tiles(m: int) -> int:
    """n-tiles of 8 rows of x a tensor-core body carries (1, 2, 4 or 8):
    one weight read serves every row."""
    t = -(-m // 8)
    return 1 if t <= 1 else 2 if t <= 2 else 4 if t <= 4 else 8


@dataclasses.dataclass(frozen=True)
class OutPlan:
    """K5's launch: `splits` splits of C of `rows` rows (the last one
    shorter) by `col_tiles` column tiles of `col_bytes` packed bytes; the
    splits' partial sums are added in split order."""

    rows: int
    splits: int
    col_bytes: int
    col_tiles: int

    def split_ranges(self, c: int) -> list:
        """[c_begin, c_end) of each split, in the order they are summed."""
        return [(i * self.rows, min(c, (i + 1) * self.rows))
                for i in range(self.splits)]

    def col_ranges(self, p: int) -> list:
        """[first, last) output column of each column tile."""
        return [(2 * i * self.col_bytes, min(2 * p, 2 * (i + 1)
                                             * self.col_bytes))
                for i in range(self.col_tiles)]


def out_plan(m: int, c: int, p: int, sms: int,
             dtype=torch.bfloat16) -> OutPlan:
    """K5's plan for x [m, c] and q4 [c, p] on a card of `sms` SMs: C
    split so the grid fills the SMs (k/v_proj have few column tiles),
    each split within its body's limits."""
    if dtype == torch.float32:
        tiles = -(-p // _F32_OUT_BYTES)
        splits = max(1, min(-(-2 * sms // tiles), -(-c // 64)))
        splits = max(splits, -(-c // _F32_MAX_ROWS))
        rows = -(-(-(-c // splits)) // 8) * 8
        return OutPlan(rows, -(-c // rows), _F32_OUT_BYTES, tiles)
    tiles = -(-p // _OUT_BYTES)
    splits = max(1, min(-(-_OUT_BLOCKS_PER_SM * sms // tiles),
                        -(-c // (_OUT_MIN_ROWS * n_tiles(m)))))
    rows = -(-(-(-c // splits)) // _OUT_STAGE_ROWS) * _OUT_STAGE_ROWS
    rows = min(rows, _OUT_MAX_ROWS)
    return OutPlan(rows, -(-c // rows), _OUT_BYTES, tiles)


@dataclasses.dataclass(frozen=True)
class ContractPlan:
    """K6's launch: `blocks` blocks of `warps` warps, each warp taking the
    vocab tiles of `tile_rows` rows at warp index + k x (blocks x warps),
    in that order; the bf16 body stages x in pieces of `piece` contracted
    values (0: the f32 body, which stages 4 whole rows at a time)."""

    blocks: int
    piece: int
    warps: int = _CON_WARPS
    tile_rows: int = 16

    def piece_ranges(self, e: int) -> list:
        """[e_begin, e_end) of each staged piece of x, in order."""
        step = self.piece or e
        return [(b, min(e, b + step)) for b in range(0, e, step)]

    def warp_tiles(self, n: int, block: int, warp: int) -> list:
        """First vocab row of each tile the warp computes, in order."""
        first = (block * self.warps + warp) * self.tile_rows
        stride = self.blocks * self.warps * self.tile_rows
        return list(range(first, n, stride))


def contract_plan(m: int, n: int, cp: int, sms: int,
                  dtype=torch.bfloat16) -> ContractPlan:
    """K6's plan for x [m, 2cp] and q4 [n, cp] on a card of `sms` SMs."""
    if dtype == torch.float32:
        return ContractPlan(min(-(-n // _CON_WARPS), 4 * sms), 0,
                            tile_rows=1)
    tiles = -(-n // 16)
    mpad = 8 * n_tiles(m)
    piece = min(-(-2 * cp // 128) * 128,
                _CON_X_BYTES // (2 * mpad) // 128 * 128)
    return ContractPlan(min(-(-tiles // _CON_WARPS), 2 * sms), piece)


@dataclasses.dataclass(frozen=True)
class Int4Plan:
    """How a leaf's products run, fixed when the leaf is made. `mode` "out"
    (K5) or "contract" (K6) once `classify` accepts the call site, else
    None; `reason` why no kernel serves the leaf (None: one does). The
    activation's last `n_cont` axes (`width` values) are contracted; the
    weight's 2-D view has `w_rows` rows; the output's trailing axes are
    `kept`. `plain` runs the kernels' plain versions on any device. A plan
    for a mesh (K10e) also holds the mesh's (data, model) sizes
    `mesh_shape` (() without one), the whole weight's dense shape
    `w_shape`, the call site's `tp` and `shard_axis`, the weight axis that
    carries the model shards (None: the leaf is whole on every rank);
    `psum` says that the product is a partial sum to all-reduce."""

    spec: str
    mode: Optional[str] = None
    reason: Optional[str] = None
    gp: int = 0
    n_cont: int = 0
    width: int = 0
    w_rows: int = 0
    kept: tuple = ()
    plain: bool = False
    mesh_shape: tuple = ()
    w_shape: tuple = ()
    tp: Optional[str] = None
    shard_axis: Optional[int] = None
    psum: bool = False


def _plan(spec: str, leaf) -> Int4Plan:
    cls, reason = classify(spec, leaf)
    if cls is None:
        return Int4Plan(spec, reason=reason)
    mode, n_cont, gp = cls
    shape = tuple(leaf.q4.shape)
    if mode == "out":
        c = 1
        for s in shape[:n_cont]:
            c *= s
        packed = leaf.q4.numel() // c
        geo = dict(n_cont=n_cont, width=c, w_rows=c,
                   kept=(*shape[n_cont:-1], 2 * shape[-1]))
    else:
        packed = shape[-1]
        geo = dict(n_cont=1, width=2 * packed,
                   w_rows=leaf.q4.numel() // packed, kept=shape[:-1])
    return Int4Plan(spec, mode=mode, gp=gp,
                    reason=_kernel_reason(mode, packed, gp, leaf.s4.dtype),
                    **geo)


def plan_leaf(spec: str, leaf, mesh=None, w_shape=(),
              tp: Optional[str] = None, shard_axis: Optional[int] = None,
              psum: bool = False):
    """`leaf` with its plan for the call site `spec` (SPEC_* of
    models/common): shapes only, once per leaf. With a `mesh` the plan is
    K10e's for this rank's shard of a weight of whole dense shape
    `w_shape` at a call site of convention `tp`, split on `shard_axis`
    (None: whole on every rank; `psum`: a partial sum) as
    sharding.plan_int4_shard places it: the local leaf must be that shard,
    and a sharded leaf's decline carries "/sharded"."""
    if mesh is None:
        plan = _plan(spec, leaf)
    else:
        w_shape = tuple(int(n) for n in w_shape)

        def local(shape):
            return tuple(n // mesh.model if i == shard_axis else n
                         for i, n in enumerate(shape))

        want = (local((*w_shape[:-1], w_shape[-1] // 2)),
                local((*w_shape[:-1], w_shape[-1] // leaf.group)))
        got = (tuple(leaf.q4.shape), tuple(leaf.s4.shape))
        if got != want:
            raise ValueError(
                f"{spec}: the local Int4Leaf (q4 {got[0]}, s4 {got[1]}) is "
                f"not this rank's shard (q4 {want[0]}, s4 {want[1]}) of the "
                f"{list(w_shape)} weight on mesh {mesh.shape}")
        plan = _plan(spec, leaf)
        reason = plan.reason
        if reason is not None and shard_axis is not None \
                and plan.mode is not None:
            reason += "/sharded"
        plan = dataclasses.replace(plan, reason=reason, w_shape=w_shape,
                                   tp=tp, shard_axis=shard_axis, psum=psum,
                                   mesh_shape=(mesh.data, mesh.model))
    if not enabled():
        plan = dataclasses.replace(plan, mode=None, reason="kernel-disabled")
    return dataclasses.replace(leaf, plan=plan)


def plan_reason(spec: str, a_shape: tuple, leaf) -> Optional[str]:
    """Why `einsum(spec, a, dequant(leaf))` at activation shape `a_shape`
    does not run a kernel (None: one does) - the JAX package's
    plan_reason with the card's constraints in place of its VMEM plan."""
    plan = _plan(spec, leaf)
    if plan.mode is None:
        return plan.reason
    a_numel = 1
    for s in a_shape:
        a_numel *= s
    if a_numel > MAX_ROWS * plan.width:
        return "rows:prefill-m"
    return plan.reason


def route_report(sites, device) -> dict:
    """int4 path provenance from the plans of `sites` ((spec, leaf) of
    every Int4Leaf product, models/common.int4_sites), in the JAX engine's
    shape: {kernel_path(device): [...], "xla_dequant": [{...,
    "fallback_reason"}]}. Each call site appears once per weight shape:
    its decode rows (`rows` "<=64") on the kernel path and its prefill
    rows (">64") on the dequant path, or all of its rows there with the
    reason its plan declines. On a card a declining plan raises: K5/K6
    serve every decode product there."""
    kernel, dequant, seen = [], [], set()
    for spec, leaf in sites:
        plan = leaf.plan
        # Under a mesh the whole weight's shape, as the JAX engine records
        # its global leaf.
        w_shape = (list(plan.w_shape) if plan is not None and plan.w_shape
                   else [*leaf.q4.shape[:-1], 2 * leaf.q4.shape[-1]])
        key = (spec, tuple(w_shape))
        if key in seen:
            continue
        seen.add(key)
        if plan is None or plan.spec != spec:
            raise ValueError(f"{spec} {w_shape}: the Int4Leaf is not "
                             f"planned for this call site (plan_leaf)")
        if plan.reason is not None:
            if torch.device(device).type == "cuda" \
                    and spec not in DEQUANT_SPECS:
                hint = (" (ROUNDTABLE_INT4_MM=0)"
                        if plan.reason == "kernel-disabled" else "")
                raise ValueError(
                    f"the w4a16 kernels (K5/K6) decline {spec} {w_shape} on "
                    f"{device}: {plan.reason}{hint}")
            dequant.append({"spec": spec, "w_shape": w_shape, "rows": "all",
                            "fallback_reason": plan.reason})
            continue
        kernel.append({"spec": spec, "w_shape": w_shape,
                       "rows": f"<={MAX_ROWS}"})
        dequant.append({"spec": spec, "w_shape": w_shape,
                        "rows": f">{MAX_ROWS}",
                        "fallback_reason": _rows_reason(plan)})
    return {kernel_path(device): kernel, PATH_DEQUANT: dequant}


# --- plain versions ---


def _nibbles(q4: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(low, high) signed nibbles of every packed byte, in `dtype`."""
    q = q4.to(torch.int32)
    return ((q << 28) >> 28).to(dtype), (q >> 4).to(dtype)


def mm_pack_out_ref(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor,
                    gp: int) -> torch.Tensor:
    """Plain version of K5: x [M, C] . unpack(q4 [C, P], s4 [C, P/gp]) ->
    [M, 2P] f32, even columns from the low nibbles."""
    low, high = _nibbles(q4, x.dtype)
    srep = s4.to(x.dtype).repeat_interleave(gp, dim=1)         # [C, P]
    xf = x.float()
    lo = torch.matmul(xf, (low * srep).float())
    hi = torch.matmul(xf, (high * srep).float())
    return torch.stack([lo, hi], dim=-1).reshape(x.shape[0], -1)


def mm_pack_contract_ref(x: torch.Tensor, q4: torch.Tensor,
                         s4: torch.Tensor, gp: int) -> torch.Tensor:
    """Plain version of K6: x [M, 2Cp] . unpack(q4 [N, Cp],
    s4 [N, Cp/gp])^T -> [M, N] f32 (x's even columns meet the low
    nibbles, its odd columns the high ones)."""
    low, high = _nibbles(q4, x.dtype)
    srep = s4.to(x.dtype).repeat_interleave(gp, dim=1)         # [N, Cp]
    return (torch.matmul(x[:, 0::2].float(), (low * srep).float().t())
            + torch.matmul(x[:, 1::2].float(), (high * srep).float().t()))


# --- kernel wrappers ---


def _check(x, q4, s4, gp: int, what: str) -> None:
    if x.dim() != 2 or q4.dim() != 2 or s4.dim() != 2:
        raise ValueError(f"{what}: x, q4 and s4 must be 2-D, got "
                         f"{tuple(x.shape)}, {tuple(q4.shape)}, "
                         f"{tuple(s4.shape)}")
    if q4.dtype != torch.int8:
        raise ValueError(f"{what}: q4 must be int8, got {q4.dtype}")
    if gp < 1 or q4.shape[1] % gp or s4.shape != (q4.shape[0],
                                                   q4.shape[1] // gp):
        raise ValueError(f"{what}: s4 {tuple(s4.shape)} does not group q4 "
                         f"{tuple(q4.shape)} by {gp} bytes")
    if len({x.device, q4.device, s4.device}) != 1:
        raise ValueError(f"{what}: operands on several devices")


def _cuda_operands(mode, x, q4, s4, gp, what: str) -> None:
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"{what} declines: rows:prefill-m ({x.shape[0]} "
                         f"rows)")
    reason = _kernel_reason(mode, q4.shape[1], gp, x.dtype)
    if reason is not None:
        raise ValueError(f"{what} declines: {reason}")
    if s4.dtype != x.dtype:
        raise ValueError(f"{what}: s4 must be in x's dtype {x.dtype}, got "
                         f"{s4.dtype}")
    for name, t in (("x", x), ("q4", q4), ("s4", s4)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# K5 bf16's per-column-tile split counters, by (card, stream): zeroed once,
# and the last split block of each tile resets its counter.
_counters: dict = {}


def _tile_counters(device, stream: int, n: int) -> torch.Tensor:
    key = (device.index or 0, stream)
    t = _counters.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[key] = t
    return t


def mm_pack_out(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor,
                gp: int) -> torch.Tensor:
    """x [M, C] . unpack(q4 [C, P], s4 [C, P/gp]) -> [M, 2P] f32 (K5).
    C splits (out_plan) write their partial sums to a workspace, added in
    split order, so a call's result is the same every time. The splits
    follow this product's width: a column shard of a wider weight (K10e)
    may split C otherwise than the whole product and then sums in another
    order."""
    what = "mm_pack_out"
    _check(x, q4, s4, gp, what)
    if x.shape[1] != q4.shape[0]:
        raise ValueError(f"{what}: x {tuple(x.shape)} does not contract "
                         f"with q4 {tuple(q4.shape)}")
    if x.device.type == "cpu":
        return mm_pack_out_ref(x, q4, s4, gp)
    _cuda_operands("out", x, q4, s4, gp, what)
    plan = out_plan(x.shape[0], x.shape[1], q4.shape[1],
                    _sm_count(x.device.index or 0), x.dtype)
    out = _launch_pack_out(x, q4, s4, gp, plan.rows)
    _launches[what] += 1
    return out


def _launch_pack_out(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor,
                     gp: int, rows: int) -> torch.Tensor:
    """K5's launch on checked CUDA operands with C in splits of `rows`
    rows."""
    m, c = x.shape
    p = q4.shape[1]
    index = x.device.index or 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty((m, 2 * p), dtype=torch.float32, device=x.device)
    splits = -(-c // rows)
    work = (torch.empty((splits, m, 2 * p), dtype=torch.float32,
                        device=x.device) if splits > 1 else out)
    counters = (_tile_counters(x.device, stream, -(-p // _OUT_BYTES))
                if splits > 1 and x.dtype != torch.float32 else out)
    rc = build.library("int4mm").rt_mm_pack_out(
        x.data_ptr(), q4.data_ptr(), s4.data_ptr(), out.data_ptr(),
        work.data_ptr(), counters.data_ptr(), m, c, p, gp, rows,
        _DTYPE_CODES[x.dtype], index, stream)
    build.check(rc, "mm_pack_out launch")
    return out


def mm_pack_contract(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor,
                     gp: int) -> torch.Tensor:
    """x [M, 2Cp] . unpack(q4 [N, Cp], s4 [N, Cp/gp])^T -> [M, N] f32
    (K6)."""
    what = "mm_pack_contract"
    _check(x, q4, s4, gp, what)
    if x.shape[1] != 2 * q4.shape[1]:
        raise ValueError(f"{what}: x {tuple(x.shape)} is not twice q4's "
                         f"packed width {tuple(q4.shape)}")
    if x.device.type == "cpu":
        return mm_pack_contract_ref(x, q4, s4, gp)
    _cuda_operands("contract", x, q4, s4, gp, what)
    m = x.shape[0]
    n, cp = q4.shape
    index = x.device.index or 0
    plan = contract_plan(m, n, cp, _sm_count(index), x.dtype)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    rc = build.library("int4mm").rt_mm_pack_contract(
        x.data_ptr(), q4.data_ptr(), s4.data_ptr(), out.data_ptr(), m, n,
        cp, gp, plan.blocks, plan.piece, _DTYPE_CODES[x.dtype], index,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, f"{what} launch")
    _launches[what] += 1
    return out


# --- the seam ---


def _rows_reason(plan: Int4Plan) -> str:
    return "rows:prefill-m" + ("/sharded" if plan.shard_axis is not None
                               else "")


def _run(spec: str, a: torch.Tensor, leaf, plan: Int4Plan):
    """(result, None) when the kernel of `plan` (its plain version on the
    CPU, or with plan.plain) serves the product, else (None, reason); a
    CUDA tensor whose leaf the plan declines raises."""
    if plan.mode is not None and a.numel() > MAX_ROWS * plan.width:
        return None, _rows_reason(plan)
    if plan.reason is not None:
        if a.is_cuda and spec not in DEQUANT_SPECS:
            raise ValueError(f"{spec}: no w4a16 kernel serves this leaf on "
                             f"the card: {plan.reason}")
        return None, plan.reason
    x = a.reshape(-1, plan.width)
    q4 = leaf.q4.reshape(plan.w_rows, -1)
    s4 = leaf.s4.reshape(plan.w_rows, -1)
    if plan.mode == "out":
        fn = mm_pack_out_ref if plan.plain else mm_pack_out
    else:
        fn = mm_pack_contract_ref if plan.plain else mm_pack_contract
    y = fn(x.contiguous(), q4, s4, plan.gp)
    return y.reshape(*a.shape[:a.dim() - plan.n_cont], *plan.kept), None


def einsum_int4_or_reason(spec: str, a: torch.Tensor, leaf):
    """(result, None) when a kernel (its plain version on the CPU) serves
    `einsum(spec, a, dequant(leaf))` - f32, the einsum's output shape - by
    the leaf's plan, else (None, reason) and the caller takes the dequant
    path. A CUDA tensor whose leaf the plan declines raises."""
    plan = leaf.plan
    if plan is None or plan.spec != spec:
        raise ValueError(f"{spec}: the Int4Leaf is planned for "
                         f"{plan.spec if plan else 'no call site'} "
                         f"(kernels/int4mm.plan_leaf)")
    if plan.mesh_shape:
        raise ValueError(f"{spec}: the Int4Leaf is a shard planned for mesh "
                         f"{plan.mesh_shape} (einsum_int4_spmd)")
    return _run(spec, a, leaf, plan)


def _spmd(mesh, spec, a, leaf, w_shape, tp, plain: bool):
    plan = leaf.plan
    # A shard is the model axis's (the data axis replicates the weights):
    # a data replica's rows, whichever mesh view the forward got, run the
    # same shard.
    if (plan is None or not plan.mesh_shape
            or plan.mesh_shape[1] != mesh.model or plan.spec != spec
            or plan.w_shape != tuple(w_shape) or plan.tp != tp):
        raise ValueError(
            f"{spec}: the Int4Leaf is not planned as a shard of the "
            f"{list(w_shape)} weight ({tp}) on a {mesh.model}-way model "
            f"axis (sharding.plan_int4_shard)")
    if plain:
        plan = dataclasses.replace(plan, plain=True)
    y, reason = _run(spec, a, leaf, plan)
    if y is not None and y.is_cuda and not plan.plain:
        _launches["einsum_int4_spmd"] += 1
    return y, reason


def einsum_int4_spmd(mesh, spec: str, a: torch.Tensor, leaf, *, w_shape,
                     tp: Optional[str] = None):
    """K10e (the TPU package's int4mm.py:428): `einsum(spec, a,
    dequant(leaf))` on this rank's shard under `mesh` - `a` the rank's
    local activation (its heads or hidden slice for a row product, the
    whole input for a column one), `leaf` its shard of the packed weight
    of whole dense shape `w_shape`, `tp` the call site's convention
    ("col"/"row", models/common.SPEC_TP). K5 or K6 on a card, their plain
    versions on the CPU. Returns (f32 result, None) - the rank's output
    slice for "col", its partial sum for a sharded "row" product, which the
    caller all-reduces once - or (None, reason): prefill rows
    ("rows:prefill-m", "/sharded" on a sharded leaf) and, on the CPU, a
    shard the kernels decline; the caller then multiplies the dequantized
    local weight. A shard the kernels decline raises on a card, and a
    local leaf that is not this rank's shard raises anywhere."""
    return _spmd(mesh, spec, a, leaf, w_shape, tp, plain=False)


def einsum_int4_spmd_ref(mesh, spec: str, a: torch.Tensor, leaf, *,
                         w_shape, tp: Optional[str] = None):
    """Plain version of einsum_int4_spmd: K5/K6's plain versions on the
    same shard, on any device (counts nothing)."""
    return _spmd(mesh, spec, a, leaf, w_shape, tp, plain=True)
