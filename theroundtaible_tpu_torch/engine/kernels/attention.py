"""Attention for the serving hot path: hand-written CUDA kernels, their
plain PyTorch versions, and their gates.

Counterpart of theroundtaible_tpu/engine/pallas/attention.py for the
kernels the single-device serving paths call - the paged pool's
(paged_forward's forward_paged and forward_ragged) and the contiguous
cache's (models/common's forward_cached):

- paged_decode_attention (K1, csrc/paged_decode.cu) - one query position
  per row against the page pool through the page table; replaces the TPU
  kernel `paged_decode_attention`.
- paged_prefill_attention (K2, csrc/paged_prefill.cu) - a causal prefill
  chunk at per-row offsets against the pool; replaces the TPU kernel
  `paged_prefill_attention`.
- ragged_paged_attention (K3, csrc/ragged_paged.cu) - mixed prefill/decode
  rows of a flat token buffer, each 8-row block belonging to one sequence,
  against the pool; replaces the TPU kernel `ragged_paged_attention`.
- flash_prefill_attention (K8, csrc/flash_prefill.cu) - a causal prefill
  chunk at per-row offsets against the position-aligned cache
  [N,S,K,D]; replaces the TPU kernel `flash_prefill_attention`.
- ragged_decode_attention (K9, csrc/ragged_decode.cu) - one query position
  per row against the position-aligned cache; replaces the TPU kernel
  `ragged_decode_attention`.

Under a (data, model) mesh of ranks (engine/sharding.py Mesh) the SPMD
wrappers partition those kernels as the TPU package's shard_map wrappers
do (K10): flash_attention_spmd (K8/K9), paged_decode_spmd (K1),
paged_prefill_spmd (K2) and ragged_paged_spmd (K3). Each takes this
rank's local tensors - its kv heads on "model", its rows on "data" - and
the global head counts, applies the wrapped kernel's gate to the
per-shard shapes, rebases a replica's page table to its local pages, and
runs the same hand-written kernel on the shard (its plain version on the
CPU). Attention is embarrassingly parallel over (row, kv head), so no
wrapper has a collective; the o_proj all-reduce after it belongs to the
forward. Each returns None where the TPU wrapper does (a head layout that
does not partition, a data axis the call cannot split, a declined
shard), with the reason from spmd_decline_reason.

K1 and K9 are one split-KV body (csrc/decode_split.cuh) under two
addressing policies: a block per span of decode_chunk(D, dtype) absolute
positions, kv head and row, and a combine kernel that merges the spans in
order. Their wrappers allocate the f32 workspace of the spans' partials
(one torch.empty per call) and launch both kernels with one call of the C
entry. decode_split_ref models that schedule in plain PyTorch for the
tests and chip_smoke.py.

K3 (csrc/ragged_paged.cu) launches no attention body of its own: it cuts
the flat buffer into the work ragged_tiles lists - prefill tiles of
TILE_PAIR * (TC_ROWS // G) rows on K2/K8's mainloop (csrc/prefill_tc.cuh)
and decode items on K1/K9's split-KV body - which its kernels derive on
the card from the same metadata. Its wrapper allocates the decode items'
workspace as K1's does. ragged_tile_ref models that schedule.

K8 and K9 take the JAX signature plus `rows`, a [B] int32 map from batch
row to cache row: the engine passes its batch's slot ids, so the kernels
read the slots in place from the [num_slots, S, K, D] cache. rows=None
reads cache row b for batch row b, which is the JAX call.

K1-K3 also serve quantized pools (engine/kv_quant.py): int8 payload pools
[P,ps,K,Dp] (Dp = D for int8, D/2 for int4) with f32 scale pools
`k_scale`/`v_scale` [P,ps,K,G] and `kv_bits` 8 or 4. Each kernel
dequantizes every staged tile in-kernel (K4, csrc/paged_common.cuh);
the plain versions dequantize the gathered cells with
kv_quant.dequantize_cells, the same math, then run the unquantized math.
kv_quant_decline_reason is K4's gate.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. A tensor on the CPU takes the plain version (the
CPU tests); a CUDA tensor launches the kernel or raises - there is no
fallback. Each launch adds one to the wrapper's count (launch_counts()), so
a run can show that its main path went through the kernels.

The plain versions gather each row's pages through the table (or its
cache row through `rows`) and run a masked softmax in f32 with the same
finite MASK_VALUE. Cells at or past a row's kv_valid are zeroed before
use: they are stale (the frontier page's tail, pages never written, a
reused slot's previous occupant) and may hold anything, NaN included.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kv_quant import KVQuantSpec, dequantize_cells
from ..models.common import MASK_VALUE
from ..serving_loop import MAX_PREFILL_CHUNK, RAGGED_BLOCK_Q
from . import build

KERNELS = ("paged_decode_attention", "paged_prefill_attention",
           "ragged_paged_attention", "flash_prefill_attention",
           "ragged_decode_attention")
# K10's attention wrappers: a launch on a card counts here AND under the
# kernel it ran.
SPMD_WRAPPERS = ("flash_attention_spmd", "paged_decode_spmd",
                 "paged_prefill_spmd", "ragged_paged_spmd")
_launches = dict.fromkeys(KERNELS + SPMD_WRAPPERS, 0)

# What the CUDA kernels take (csrc/paged_common.cuh kMaxGroup; the D and
# page sizes each kernel is instantiated and tested for).
HEAD_DIMS = (64, 128, 256)
PAGE_SIZES = (16, 32, 64, 128, 256)
MAX_GROUP = 16
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# Launches of K1-K3 on quantized pools (K4 ran inside), by kernel and
# payload: "paged_decode_attention:int8", ...
_dequant_launches = {f"{k}:int{b}": 0 for k in KERNELS[:3] for b in (8, 4)}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_launches)


def dequant_launch_counts() -> dict[str, int]:
    """Of those, the K1-K3 launches on quantized pools, by payload."""
    return dict(_dequant_launches)


def reset_launch_counts() -> None:
    for counts in (_launches, _dequant_launches):
        for name in counts:
            counts[name] = 0


def _count(what: str, bits: int) -> None:
    _launches[what] += 1
    if bits:
        _dequant_launches[f"{what}:int{bits}"] += 1


# --- gates ---


_declines: dict[tuple, Optional[str]] = {}


def _decline(kernel: str, t: int, page_size: int, d: int, group: int,
             device) -> Optional[str]:
    """Why `kernel` cannot serve this shape on `device`, or None. On the
    CPU every shape goes (the plain versions take any). Answers are
    remembered per shape: the serving loop asks on every launch."""
    device = torch.device(device)
    if device.type == "cpu":
        return None
    key = (kernel, t, page_size, d, group, device)
    if key not in _declines:
        _declines[key] = _cuda_decline(kernel, t, page_size, d, group,
                                       device)
    return _declines[key]


def _cuda_decline(kernel: str, t: int, page_size: int, d: int, group: int,
                  device: torch.device) -> Optional[str]:
    if device.type != "cuda":
        return f"device:{device.type}"
    if d not in HEAD_DIMS:
        return f"head_dim:{d} not in {HEAD_DIMS}"
    paged = kernel in ("decode", "prefill", "ragged")
    if paged and page_size not in PAGE_SIZES:
        return f"page_size:{page_size} not in {PAGE_SIZES}"
    if not 1 <= group <= MAX_GROUP:
        return f"group:{group} not in 1..{MAX_GROUP}"
    index = device.index if device.index is not None else 0
    lib = build.library({"decode": "paged_decode", "prefill": "paged_prefill",
                         "ragged": "ragged_paged", "flash": "flash_prefill",
                         "rdecode": "ragged_decode"}[kernel])
    limit = lib.rt_max_smem_optin(index)
    if kernel == "decode":
        need = lib.rt_paged_decode_smem_bytes(group, d, page_size)
    elif kernel == "prefill":
        need = lib.rt_paged_prefill_smem_bytes(group, d, page_size, t)
    elif kernel == "ragged":
        need = lib.rt_ragged_smem_bytes(group, d, page_size)
    elif kernel == "flash":
        need = lib.rt_flash_prefill_smem_bytes(group, d, t)
    else:
        need = lib.rt_ragged_decode_smem_bytes(group, d)
    if need > limit:
        return f"smem:{need}>{limit}"
    return None


def paged_decode_supported(page_size: int, d: int, kh: int = 1,
                           group: int = 1, device="cpu") -> bool:
    """Can paged_decode_attention serve this pool shape on `device`?"""
    return _decline("decode", 1, page_size, d, group, device) is None


def paged_prefill_supported(t: int, page_size: int, d: int, kh: int = 1,
                            group: int = 1, device="cpu") -> bool:
    """Can paged_prefill_attention serve this chunk/pool shape?"""
    return _decline("prefill", t, page_size, d, group, device) is None


def pool_direct_decline_reason(chunk: int, page_size: int, d: int,
                               kh: int, group: int,
                               device) -> Optional[str]:
    """The build-time gate of pool-direct paged serving: prefill chunks up
    to `chunk` rows AND decode steps run off the pool, so both kernels
    must take the shape. None when they do, else the reason."""
    return (_decline("prefill", chunk, page_size, d, group, device)
            or _decline("decode", 1, page_size, d, group, device))


def ragged_decline_reason(page_size: int, d: int, kh: int = 1,
                          group: int = 1, device="cpu") -> Optional[str]:
    """Why ragged_paged_attention cannot serve this pool shape on `device`,
    or None when it can (the engine's build-time gate of the ragged
    path)."""
    return _decline("ragged", RAGGED_BLOCK_Q, page_size, d, group, device)


def contiguous_decline_reason(chunk: int, d: int, group: int,
                              device) -> Optional[str]:
    """The build-time gate of the contiguous layout's kernel path: prefill
    chunks up to `chunk` rows (K8, any T >= 1 and any cache length) AND
    decode steps (K9) must take the shape. None when they do, else the
    reason. Unlike the TPU gate, T and S need not be multiples of 8."""
    return (_decline("flash", chunk, 0, d, group, device)
            or _decline("rdecode", 1, 0, d, group, device))


# K4's payloads: int8, and int4 whose scale group spans whole 16-byte
# payload vectors (32 values).
KV_BITS = (8, 4)
INT4_GROUP_MULTIPLE = 32


def kv_quant_decline_reason(page_size: int, d: int, kh: int, group: int,
                            bits: int = 8, quant_group: int = 32,
                            device="cpu") -> Optional[str]:
    """Why K1-K3 cannot serve a QUANTIZED pool of this shape on `device`
    (in-kernel dequant, K4), or None when they can. The JAX package's
    checks (bits, an int4 head and grouping that are well-formed), then on
    a card the unquantized kernels' gates and the payload/group
    instantiations the kernels take: int8 (one scale per cell), int4 with
    a group that is a multiple of 32 values."""
    if bits not in KV_BITS:
        return f"kv_bits:{bits}"
    g = d
    if bits == 4:
        if d % 2:
            return f"int4_head_dim:{d}"
        g = KVQuantSpec(bits=4, group=quant_group).effective_group(d)
        if d % g or g % 2:
            return f"int4_group:d={d},g={quant_group}"
    if torch.device(device).type == "cpu":
        return None
    base = (ragged_decline_reason(page_size, d, kh, group, device)
            or pool_direct_decline_reason(MAX_PREFILL_CHUNK, page_size, d,
                                          kh, group, device))
    if base is not None:
        return base
    if bits == 4 and g % INT4_GROUP_MULTIPLE:
        return (f"int4_group:{g} not a multiple of {INT4_GROUP_MULTIPLE} "
                f"(the kernels' payload vector)")
    return None


def paged_pool_direct_supported(chunk: int, page_size: int, d: int,
                                kh_local: int, group: int,
                                device="cpu") -> bool:
    return pool_direct_decline_reason(chunk, page_size, d, kh_local, group,
                                      device) is None


# --- plain versions ---


def _gather(pool, scale, idx, kv_bits: int, dtype):
    """pool[idx]: the cells of the pages `idx`, dequantized to `dtype`
    (kv_quant.dequantize_cells, K4's math) when `scale` is given."""
    cells = pool[idx]
    if scale is None:
        return cells
    return dequantize_cells(cells, scale[idx], KVQuantSpec(bits=kv_bits),
                            dtype)


def paged_prefill_attention_ref(q, k_pool, v_pool, table, offsets, kv_valid,
                                *, sliding_window: Optional[int] = None,
                                softcap: Optional[float] = None,
                                k_scale=None, v_scale=None,
                                kv_bits: int = 8):
    """Plain version of K2: gather every row's pages (dequantized when the
    pools are quantized), masked softmax in f32, p cast to v's dtype before
    the PV product. [B,T,H,D]."""
    b, t, h, d = q.shape
    ps, kh = k_pool.shape[1], k_pool.shape[2]
    group = h // kh
    s = table.shape[1] * ps
    dev = q.device
    kv_pos = torch.arange(s, device=dev)
    live = kv_pos[None, :] < kv_valid.to(dev)[:, None].long()   # [B,S]
    idx = table.to(dev).long()
    k = _gather(k_pool, k_scale, idx, kv_bits, q.dtype).reshape(b, s, kh, d)
    v = _gather(v_pool, v_scale, idx, kv_bits, q.dtype).reshape(b, s, kh, d)
    zero = torch.zeros((), dtype=k.dtype, device=dev)
    k = torch.where(live[:, :, None, None], k, zero)
    v = torch.where(live[:, :, None, None], v, zero)
    q_pos = offsets.to(dev).long()[:, None] + torch.arange(t, device=dev)
    mask = (kv_pos[None, None, :] <= q_pos[:, :, None]) & live[:, None, :]
    if sliding_window is not None:
        mask &= kv_pos[None, None, :] > q_pos[:, :, None] - sliding_window
    qg = q.reshape(b, t, kh, group, d)       # head h = kh_i * group + g
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(MASK_VALUE, device=dev))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs.float(), v.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, table, kv_valid, *,
                               sliding_window: Optional[int] = None,
                               softcap: Optional[float] = None,
                               k_scale=None, v_scale=None,
                               kv_bits: int = 8):
    """Plain version of K1: the prefill math at one position per row,
    q position kv_valid - 1 (kv_valid includes this step). [B,1,H,D]."""
    return paged_prefill_attention_ref(
        q, k_pool, v_pool, table, kv_valid - 1, kv_valid,
        sliding_window=sliding_window, softcap=softcap, k_scale=k_scale,
        v_scale=v_scale, kv_bits=kv_bits)


def ragged_paged_attention_ref(q, k_pool, v_pool, tables, seq_of_block,
                               block_qstart, query_offsets, kv_valid, *,
                               sliding_window: Optional[int] = None,
                               softcap: Optional[float] = None,
                               k_scale=None, v_scale=None,
                               kv_bits: int = 8):
    """Plain version of K3. Loops over the sequences present in the flat
    buffer: each gathers its pages once, up to its own frontier, and its
    rows run the masked f32 softmax, p cast to v's dtype before the PV
    product. Pad rows (q_pos >= kv_valid of their sequence) are 0.
    [T,H,D]."""
    t, h, d = q.shape
    ps, kh = k_pool.shape[1], k_pool.shape[2]
    group = h // kh
    dev = q.device
    bq = RAGGED_BLOCK_Q
    out = torch.zeros_like(q)
    blk_seq = seq_of_block.tolist()
    blk_start = block_qstart.tolist()
    offsets = query_offsets.tolist()
    valid = kv_valid.tolist()
    blocks_of: dict[int, list[int]] = {}
    for blk, s in enumerate(blk_seq):
        blocks_of.setdefault(s, []).append(blk)
    for s, blocks in blocks_of.items():
        rows = torch.tensor([blk * bq + i for blk in blocks
                             for i in range(bq)], device=dev)
        q_pos = torch.tensor([offsets[s] + blk_start[blk] + i
                              for blk in blocks for i in range(bq)],
                             device=dev)
        real = q_pos < valid[s]
        n_pages = min(-(-valid[s] // ps), tables.shape[1])
        if n_pages < 1 or not bool(real.any()):
            continue
        length = n_pages * ps
        idx = tables[s, :n_pages].to(dev).long()
        kv_pos = torch.arange(length, device=dev)
        live = kv_pos < valid[s]
        zero = torch.zeros((), dtype=q.dtype, device=dev)
        k = torch.where(live[:, None, None], _gather(
            k_pool, k_scale, idx, kv_bits, q.dtype).reshape(length, kh, d),
            zero)
        v = torch.where(live[:, None, None], _gather(
            v_pool, v_scale, idx, kv_bits, q.dtype).reshape(length, kh, d),
            zero)
        mask = (kv_pos[None, :] <= q_pos[:, None]) & live[None, :]
        if sliding_window is not None:
            mask &= kv_pos[None, :] > q_pos[:, None] - sliding_window
        qg = q[rows].reshape(len(rows), kh, group, d)
        logits = torch.einsum("nkgd,lkd->kgnl", qg.float(), k.float())
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        logits = torch.where(mask[None, None], logits,
                             torch.tensor(MASK_VALUE, device=dev))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.einsum("kgnl,lkd->nkgd", probs.float(), v.float())
        o = torch.where(real[:, None, None, None], o, 0.0)
        out[rows] = o.reshape(len(rows), h, d).to(q.dtype)
    return out


def flash_prefill_attention_ref(q, k_cache, v_cache, offsets, kv_valid, *,
                                sliding_window: Optional[int] = None,
                                softcap: Optional[float] = None,
                                rows=None):
    """Plain version of K8: gather each batch row's cache row (`rows`, or
    row b), run the masked f32 softmax with p cast to v's dtype before the
    PV product. Pad rows (q_pos >= kv_valid) are 0, as in the kernel.
    [B,T,H,D]."""
    b, t, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    group = h // kh
    dev = q.device
    idx = (torch.arange(b, device=dev) if rows is None
           else rows.to(dev).long())
    if rows is not None and (int(idx.min()) < 0
                             or int(idx.max()) >= k_cache.shape[0]):
        raise IndexError(f"rows {idx.tolist()} outside the cache's "
                         f"{k_cache.shape[0]} rows")
    valid = torch.clamp(kv_valid.to(dev).long(), max=s)          # [B]
    # Positions at or past every row's frontier are masked for all rows:
    # attend over the longest live prefix only.
    n = max(min(int(valid.max()), s), 1)
    kv_pos = torch.arange(n, device=dev)
    live = kv_pos[None, :] < valid[:, None]                       # [B,n]
    zero = torch.zeros((), dtype=k_cache.dtype, device=dev)
    k = torch.where(live[:, :, None, None], k_cache[idx, :n], zero)
    v = torch.where(live[:, :, None, None], v_cache[idx, :n], zero)
    q_pos = offsets.to(dev).long()[:, None] + torch.arange(t, device=dev)
    mask = (kv_pos[None, None, :] <= q_pos[:, :, None]) & live[:, None, :]
    if sliding_window is not None:
        mask &= kv_pos[None, None, :] > q_pos[:, :, None] - sliding_window
    qg = q.reshape(b, t, kh, group, d)       # head h = kh_i * group + g
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(MASK_VALUE, device=dev))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs.float(), v.float())
    real = (q_pos < valid[:, None])[:, :, None, None, None]
    out = torch.where(real, out, 0.0)
    return out.reshape(b, t, h, d).to(q.dtype)


def ragged_decode_attention_ref(q, k_cache, v_cache, kv_valid, *,
                                sliding_window: Optional[int] = None,
                                softcap: Optional[float] = None,
                                rows=None):
    """Plain version of K9: the prefill math at one position per row,
    q position kv_valid - 1 (kv_valid includes this step). [B,1,H,D]."""
    return flash_prefill_attention_ref(
        q, k_cache, v_cache, kv_valid - 1, kv_valid,
        sliding_window=sliding_window, softcap=softcap, rows=rows)


# K1/K9's split: bytes of K (and of V) one block stages
# (csrc/decode_split.cuh kSplitBytes).
DECODE_SPLIT_BYTES = 32768


def decode_chunk(d: int, dtype) -> int:
    """Positions per split of K1/K9 for head dim `d` and q's `dtype`: a
    constant of (dtype, D), never of the heads, rows, pages or cache
    length (128 in bf16 at D = 128)."""
    return DECODE_SPLIT_BYTES // (d * dtype.itemsize)


def _decode_workspace(q, kh: int, span: int, rows: Optional[int] = None):
    """The f32 workspace of a K1/K9 launch: (m, l, acc[G, D]) of every
    split of `span` positions, for every (row, kv head); K3 passes its
    sequence count as `rows`."""
    h, d = q.shape[-2], q.shape[-1]
    b = q.shape[0] if rows is None else rows
    n_splits = -(-span // decode_chunk(d, q.dtype))
    return torch.empty(b * kh * n_splits * (h // kh) * (d + 2),
                       dtype=torch.float32, device=q.device)


def decode_split_ref(q, k, v, kv_valid, *, table=None, rows=None,
                     sliding_window: Optional[int] = None,
                     softcap: Optional[float] = None, k_scale=None,
                     v_scale=None, kv_bits: int = 8):
    """Plain model of K1/K9's algorithm (csrc/decode_split.cuh), for the
    tests and chip_smoke.py only: with `table`, k/v are page pools
    [P,ps,K,Dp] (quantized with `k_scale`/`v_scale`); without, caches
    [N,S,K,D] read through `rows` (None: row b). Positions split into
    spans of decode_chunk(D, q.dtype) aligned to 0; each live span
    computes (m, l, acc) of its window cells - scores in f32, softcap, the
    finite mask, p rounded to q's dtype for the PV product, l from the
    unrounded p - and the spans merge in ascending order, the output
    divided by max(l, 1e-30). Every kv head is computed on its own,
    so a shard's heads give the bits of the full call's slice. Cells
    outside [window start, kv_valid) are never read (zeroed first).
    [B,1,H,D] in q's dtype."""
    b, _, h, d = q.shape
    dev = q.device
    kh = k.shape[2]
    if table is not None:
        span = table.shape[1] * k.shape[1]
        idx = table.to(dev).long()
        kc = _gather(k, k_scale, idx, kv_bits, q.dtype).reshape(b, span,
                                                                kh, d)
        vc = _gather(v, v_scale, idx, kv_bits, q.dtype).reshape(b, span,
                                                                kh, d)
    else:
        span = k.shape[1]
        idx = (torch.arange(b, device=dev) if rows is None
               else rows.to(dev).long())
        kc, vc = k[idx], v[idx]
    chunk = decode_chunk(d, q.dtype)
    n = -(-span // chunk)
    valid = kv_valid.to(dev).long()
    end = torch.clamp(valid, max=span)
    lo = (torch.clamp(valid - sliding_window, min=0) if sliding_window
          else torch.zeros_like(valid))
    pos = torch.arange(n * chunk, device=dev)
    live = (pos[None] >= lo[:, None]) & (pos[None] < end[:, None])
    pad = n * chunk - span
    zero = torch.zeros((), dtype=kc.dtype, device=dev)
    cells = [torch.where(live[:, :, None, None],
                         torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)),
                         zero).float().reshape(b, n, chunk, kh, d)
             for x in (kc, vc)]
    live = live.reshape(b, n, chunk)
    split_live = live.any(-1)                                  # [B, n]
    group = h // kh
    qg = q[:, 0].reshape(b, kh, group, d).float()
    mask = torch.tensor(MASK_VALUE, device=dev)
    out = []
    for i in range(kh):
        s = torch.einsum("bgd,bncd->bngc", qg[:, i], cells[0][:, :, :, i])
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(live[:, :, None], s, mask)
        m = s.amax(-1)                                         # [B,n,G]
        p = torch.exp(s - m[..., None])
        l = p.sum(-1)
        acc = torch.einsum("bngc,bncd->bngd", p.to(q.dtype).float(),
                           cells[1][:, :, :, i])
        m_all = torch.full((b, group), MASK_VALUE, device=dev)
        for j in range(n):
            m_all = torch.where(split_live[:, j, None],
                                torch.maximum(m_all, m[:, j]), m_all)
        l_all = torch.zeros(b, group, device=dev)
        a_all = torch.zeros(b, group, d, device=dev)
        for j in range(n):
            w = torch.where(split_live[:, j, None],
                            torch.exp(m[:, j] - m_all), 0.0)
            l_all = l_all + w * l[:, j]
            a_all = a_all + w[..., None] * acc[:, j]
        out.append(a_all / torch.clamp(l_all, min=1e-30)[..., None])
    return torch.stack(out, 1).reshape(b, 1, h, d).to(q.dtype)


# K3's schedule (csrc/ragged_paged.cu): prefill tiles of TILE_PAIR * (64 //
# G) rows on prefill_tc.cuh's body, keys in tiles of KEY_TILE positions.
TC_ROWS = 64        # query rows per consumer warpgroup (kTcRows)
TILE_PAIR = 2       # consumer warpgroups per block (kTcConsumers)
KEY_TILE = 64       # keys per staged tile (kTcBK)


def _ints(x) -> list[int]:
    return [int(v) for v in (x.tolist() if hasattr(x, "tolist") else x)]


def ragged_tiles(seq_of_block, block_qstart, query_offsets, kv_valid,
                 group: int) -> tuple[list, list]:
    """The work K3's kernels walk over a flat buffer, which their device
    code derives from the same metadata: (tiles, decode items).

    A run is a maximal stretch of consecutive 8-row blocks of one sequence
    whose block_qstart steps by 8; a block at block_qstart 0 always starts
    one (every inert block is its own run). A sequence's first run in the
    buffer is a decode item (row, seq) - its first row, at the split-KV
    decode body - when that row is its only real one (position kv_valid -
    1) and the sequence holds more than KEY_TILE cells. Every other run is
    cut from its start into tiles (row0, n, pos0, seq) of TILE_PAIR *
    (TC_ROWS // group) rows, the last one shorter: rows row0 .. row0 + n -
    1 at positions pos0 .. pos0 + n - 1. Tile heights depend on the group
    and the run alone."""
    seq, qs = _ints(seq_of_block), _ints(block_qstart)
    offs, valid = _ints(query_offsets), _ints(kv_valid)
    bq = RAGGED_BLOCK_Q
    runs: list[list[int]] = []                   # [first block, blocks]
    for j in range(len(seq)):
        if (j == 0 or qs[j] == 0 or seq[j - 1] != seq[j]
                or qs[j - 1] + bq != qs[j]):
            runs.append([j, 1])
        else:
            runs[-1][1] += 1
    first_of: dict[int, int] = {}
    for j, s in enumerate(seq):
        first_of.setdefault(s, j)
    height = TILE_PAIR * (TC_ROWS // group)
    tiles, decode = [], []
    for b0, n in runs:
        s = seq[b0]
        p0 = offs[s] + qs[b0]
        if p0 == valid[s] - 1 and valid[s] > KEY_TILE and first_of[s] == b0:
            decode.append((bq * b0, s))
            continue
        for t0 in range(0, bq * n, height):
            tiles.append((bq * b0 + t0, min(height, bq * n - t0), p0 + t0,
                          s))
    return tiles, decode


def ragged_tile_ref(q, k_pool, v_pool, tables, seq_of_block, block_qstart,
                    query_offsets, kv_valid, *,
                    sliding_window: Optional[int] = None,
                    softcap: Optional[float] = None, k_scale=None,
                    v_scale=None, kv_bits: int = 8):
    """Plain model of K3's schedule (csrc/ragged_paged.cu), for the tests
    and chip_smoke.py only: the work of ragged_tiles. Each tile walks its
    sequence's keys in tiles of KEY_TILE positions, from the window's
    first tile to the tile's causal/valid frontier, with the online
    softmax in f32 (scores in f32, softcap, the finite mask, p rounded to
    v's dtype for the PV product, l from the unrounded p, the output
    divided by max(l, 1e-30)); decode items go through decode_split_ref.
    Cells at or past kv_valid are zeroed before use. Pad rows (q_pos >=
    kv_valid) are 0. [T,H,D] in q's dtype."""
    t, h, d = q.shape
    ps, kh = k_pool.shape[1], k_pool.shape[2]
    group = h // kh
    dev = q.device
    span = tables.shape[1] * ps
    tiles, decode = ragged_tiles(seq_of_block, block_qstart, query_offsets,
                                 kv_valid, group)
    valid = _ints(kv_valid)
    out = torch.zeros_like(q)
    mask = torch.tensor(MASK_VALUE, device=dev)
    for row0, n, pos0, s in tiles:
        v_s = min(valid[s], span)
        if pos0 >= v_s:
            continue
        end = min(pos0 + n, v_s)
        lo = max(0, pos0 - sliding_window + 1) if sliding_window else 0
        n_lo, n_hi = lo // KEY_TILE, (end - 1) // KEY_TILE + 1
        length = min(n_hi * KEY_TILE, span)
        n_pages = -(-length // ps)
        idx = tables[s, :n_pages].to(dev).long()
        zero = torch.zeros((), dtype=q.dtype, device=dev)
        kv_pos = torch.arange(n_pages * ps, device=dev)
        live = (kv_pos < v_s)[:, None, None]
        k = torch.where(live, _gather(k_pool, k_scale, idx, kv_bits,
                                      q.dtype).reshape(-1, kh, d), zero)
        v = torch.where(live, _gather(v_pool, v_scale, idx, kv_bits,
                                      q.dtype).reshape(-1, kh, d), zero)
        q_pos = pos0 + torch.arange(n, device=dev)
        qg = q[row0:row0 + n].reshape(n, kh, group, d).float()
        m = torch.full((kh, group, n), MASK_VALUE, device=dev)
        l = torch.zeros(kh, group, n, device=dev)
        acc = torch.zeros(kh, group, n, d, device=dev)
        for j in range(n_lo, n_hi):
            pos = torch.arange(j * KEY_TILE, min((j + 1) * KEY_TILE, length),
                               device=dev)
            sc = torch.einsum("nkgd,ckd->kgnc", qg, k[pos].float())
            if softcap is not None:
                sc = softcap * torch.tanh(sc / softcap)
            keep = (pos[None] <= q_pos[:, None]) & (pos[None] < v_s)
            if sliding_window:
                keep &= pos[None] > q_pos[:, None] - sliding_window
            sc = torch.where(keep, sc, mask)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(keep, torch.exp(sc - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "kgnc,ckd->kgnd", p.to(v.dtype).float(), v[pos].float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        o = torch.where((q_pos < v_s)[None, None, :, None], o, 0.0)
        out[row0:row0 + n] = o.permute(2, 0, 1, 3).reshape(n, h, d).to(
            q.dtype)
    if decode:
        rows = torch.tensor([r for r, _ in decode], device=dev)
        seqs = torch.tensor([s for _, s in decode], device=dev)
        out[rows] = decode_split_ref(
            q[rows][:, None], k_pool, v_pool, kv_valid.to(dev)[seqs],
            table=tables.to(dev)[seqs], sliding_window=sliding_window,
            softcap=softcap, k_scale=k_scale, v_scale=v_scale,
            kv_bits=kv_bits)[:, 0]
    return out


# --- kernel wrappers ---


def _check_pools(q, k_pool, v_pool, k_scale, v_scale, kv_bits: int,
                 what: str) -> int:
    """Shape/dtype checks of the pools (and scale pools) against q
    [..., H, D]; returns the kernel's kv_bits (0: unquantized pools)."""
    h, d = q.shape[-2], q.shape[-1]
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{what}: pools must be [P,ps,K,D] and equal, got "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    kh = k_pool.shape[2]
    if h % kh:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pool.shape)}")
    if k_scale is None and v_scale is None:
        if k_pool.shape[3] != d:
            raise ValueError(f"{what}: q {tuple(q.shape)} does not match "
                             f"pools {tuple(k_pool.shape)}")
        if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
            raise ValueError(f"{what}: pool dtype {k_pool.dtype} != q dtype "
                             f"{q.dtype}")
        return 0
    if k_scale is None or v_scale is None:
        raise ValueError(f"{what}: k_scale and v_scale come together")
    if kv_bits not in KV_BITS:
        raise ValueError(f"{what}: kv_bits must be one of {KV_BITS}, got "
                         f"{kv_bits}")
    dp = d if kv_bits == 8 else d // 2
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise ValueError(f"{what}: quantized pools must be int8 payloads, "
                         f"got {k_pool.dtype}")
    if k_pool.shape[3] != dp:
        raise ValueError(f"{what}: an int{kv_bits} pool of D={d} holds {dp} "
                         f"bytes per cell, got {tuple(k_pool.shape)}")
    if (k_scale.dim() != 4 or k_scale.shape != v_scale.shape
            or k_scale.shape[:3] != k_pool.shape[:3]
            or d % k_scale.shape[3]):
        raise ValueError(f"{what}: scale pools must be [P,ps,K,G] beside "
                         f"the payload, G dividing D={d}, got "
                         f"{tuple(k_scale.shape)} / {tuple(v_scale.shape)}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError(f"{what}: scales must be float32, got "
                         f"{k_scale.dtype}")
    return kv_bits


def _check(q, k_pool, v_pool, table, rows, what: str, k_scale=None,
           v_scale=None, kv_bits: int = 8) -> int:
    b = q.shape[0]
    bits = _check_pools(q, k_pool, v_pool, k_scale, v_scale, kv_bits, what)
    if table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"{what}: table must be [B, pages_per_seq], got "
                         f"{tuple(table.shape)}")
    for name, x in rows.items():
        if x.shape != (b,):
            raise ValueError(f"{what}: {name} must be [B], got "
                             f"{tuple(x.shape)}")
    _same_device(what, q, k_pool, v_pool, table, *rows.values(), k_scale,
                 v_scale)
    return bits


def _same_device(what: str, *xs) -> None:
    devices = {x.device for x in xs if x is not None}
    if len(devices) != 1:
        raise ValueError(f"{what}: operands on several devices {devices}")


def _cuda_operands(q, k_pool, v_pool, index: dict, what: str,
                   k_scale=None, v_scale=None):
    """Kernel-side checks of q, the caches (and scales) and the index
    tensors."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: dtype {q.dtype} not in "
                         f"{tuple(_DTYPE_CODES)}")
    for name, x in (("q", q), ("k_cache", k_pool), ("v_cache", v_pool),
                    ("k_scale", k_scale), ("v_scale", v_scale)):
        if x is None:
            continue
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    ints = {}
    for name, x in index.items():
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous int32")
        ints[name] = x
    return ints


def _quant_args(k_scale, v_scale, bits: int) -> tuple:
    """(k_scale ptr, v_scale ptr, kv_bits, G) of a launch (0s when the
    pools are unquantized)."""
    if not bits:
        return None, None, 0, 0
    return k_scale.data_ptr(), v_scale.data_ptr(), bits, k_scale.shape[3]


_kv_declines: dict[tuple, Optional[str]] = {}


def _kv_decline(bits: int, ps: int, d: int, kh: int, group: int,
                k_scale, device) -> Optional[str]:
    """K4's gate for a quantized launch (None for unquantized pools),
    remembered per shape."""
    if not bits:
        return None
    key = (bits, ps, d, kh, group, k_scale.shape[3], device)
    if key not in _kv_declines:
        _kv_declines[key] = kv_quant_decline_reason(
            ps, d, kh, group, bits, d // k_scale.shape[3], device)
    return _kv_declines[key]


def paged_decode_attention(q, k_pool, v_pool, table, kv_valid, *,
                           sliding_window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           k_scale=None, v_scale=None, kv_bits: int = 8):
    """Single-position decode attention straight off the page pool (K1).

    q [B,1,H,D] pre-scaled and rope'd; pools [P,ps,K,D] (quantized: int8
    [P,ps,K,Dp] with f32 `k_scale`/`v_scale` [P,ps,K,G], `kv_bits` 8 or
    4); table [B,pp] int32; kv_valid [B] int32 INCLUDING this step, whose
    K/V the caller has written into the pool already. Returns [B,1,H,D]
    in q's dtype."""
    what = "paged_decode_attention"
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{what} serves one position, got q "
                         f"{tuple(q.shape)}")
    bits = _check(q, k_pool, v_pool, table, {"kv_valid": kv_valid}, what,
                  k_scale, v_scale, kv_bits)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_pool, v_pool, table, kv_valid,
            sliding_window=sliding_window, softcap=softcap, k_scale=k_scale,
            v_scale=v_scale, kv_bits=kv_bits)
    b, _, h, d = q.shape
    p, ps, kh, _ = k_pool.shape
    reason = (_decline("decode", 1, ps, d, h // kh, q.device)
              or _kv_decline(bits, ps, d, kh, h // kh, k_scale, q.device))
    if reason is not None:
        raise ValueError(f"{what} declines: {reason}")
    ints = _cuda_operands(q, k_pool, v_pool,
                          {"table": table, "kv_valid": kv_valid}, what,
                          k_scale, v_scale)
    ks, vs, bits, groups = _quant_args(k_scale, v_scale, bits)
    out = torch.empty_like(q)
    ws = _decode_workspace(q, kh, table.shape[1] * ps)
    rc = build.library("paged_decode").rt_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
        ints["table"].data_ptr(), ints["kv_valid"].data_ptr(),
        out.data_ptr(), ws.data_ptr(), b, h, kh, d, ps, table.shape[1],
        int(sliding_window or 0), float(softcap or 0.0),
        _DTYPE_CODES[q.dtype], bits, groups, q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, f"{what} launch")
    _count(what, bits)
    return out


def paged_prefill_attention(q, k_pool, v_pool, table, offsets, kv_valid, *,
                            sliding_window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            k_scale=None, v_scale=None, kv_bits: int = 8):
    """Causal prefill attention of a chunk straight off the page pool (K2).

    q [B,T,H,D] pre-scaled and rope'd, row i of batch row b at absolute
    position offsets[b] + i; kv_valid [B] = offsets + real lengths;
    quantized pools as for K1. The caller has scattered the chunk's K/V
    into the rows' pages; pages below a row's offset may be aliased donor
    pages and are only read. Returns [B,T,H,D] in q's dtype; rows past a
    row's real length are garbage the caller drops."""
    what = "paged_prefill_attention"
    if q.dim() != 4:
        raise ValueError(f"q must be [B,T,H,D], got {tuple(q.shape)}")
    rows = {"offsets": offsets, "kv_valid": kv_valid}
    bits = _check(q, k_pool, v_pool, table, rows, what, k_scale, v_scale,
                  kv_bits)
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(
            q, k_pool, v_pool, table, offsets, kv_valid,
            sliding_window=sliding_window, softcap=softcap, k_scale=k_scale,
            v_scale=v_scale, kv_bits=kv_bits)
    b, t, h, d = q.shape
    p, ps, kh, _ = k_pool.shape
    reason = (_decline("prefill", t, ps, d, h // kh, q.device)
              or _kv_decline(bits, ps, d, kh, h // kh, k_scale, q.device))
    if reason is not None:
        raise ValueError(f"{what} declines: {reason}")
    ints = _cuda_operands(q, k_pool, v_pool, {"table": table, **rows}, what,
                          k_scale, v_scale)
    ks, vs, bits, groups = _quant_args(k_scale, v_scale, bits)
    out = torch.empty_like(q)
    rc = build.library("paged_prefill").rt_paged_prefill(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
        ints["table"].data_ptr(), ints["offsets"].data_ptr(),
        ints["kv_valid"].data_ptr(), out.data_ptr(), b, t, h, kh, d, ps,
        table.shape[1], int(sliding_window or 0), float(softcap or 0.0),
        _DTYPE_CODES[q.dtype], bits, groups, q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, f"{what} launch")
    _count(what, bits)
    return out


def ragged_paged_attention(q, k_pool, v_pool, tables, seq_of_block,
                           block_qstart, query_offsets, kv_valid, *,
                           sliding_window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           k_scale=None, v_scale=None, kv_bits: int = 8):
    """Mixed prefill/decode attention over a flat token buffer straight off
    the page pool (K3).

    q [T,H,D] pre-scaled and rope'd, T a multiple of RAGGED_BLOCK_Q; block
    qb (rows qb*8 .. qb*8+7) belongs to sequence seq_of_block[qb] and its
    row i sits at absolute position query_offsets[seq] + block_qstart[qb]
    + i, causal within the sequence; tables [S,pp] int32; kv_valid [S]
    valid entries AFTER this call; quantized pools as for K1. The caller
    has scattered every real token's K/V into its pages. Every index must
    lie inside its table (serving_loop.build_ragged_batch keeps them
    there). Returns [T,H,D] in q's dtype; pad rows (q_pos >= kv_valid) are
    0. On a card one call of the C entry launches the prefill tiles, then
    the decode items' split kernel and combine (ragged_tiles)."""
    what = "ragged_paged_attention"
    if q.dim() != 3 or q.shape[0] % RAGGED_BLOCK_Q or q.shape[0] == 0:
        raise ValueError(f"{what}: q must be [T,H,D] with T a multiple of "
                         f"{RAGGED_BLOCK_Q}, got {tuple(q.shape)}")
    t, h, d = q.shape
    bits = _check_pools(q, k_pool, v_pool, k_scale, v_scale, kv_bits, what)
    kh = k_pool.shape[2]
    if tables.dim() != 2:
        raise ValueError(f"{what}: tables must be [S, pages_per_seq], got "
                         f"{tuple(tables.shape)}")
    s = tables.shape[0]
    shapes = {"seq_of_block": (seq_of_block, t // RAGGED_BLOCK_Q),
              "block_qstart": (block_qstart, t // RAGGED_BLOCK_Q),
              "query_offsets": (query_offsets, s),
              "kv_valid": (kv_valid, s)}
    for name, (x, n) in shapes.items():
        if x.shape != (n,):
            raise ValueError(f"{what}: {name} must be [{n}], got "
                             f"{tuple(x.shape)}")
    rows = {name: x for name, (x, _) in shapes.items()}
    _same_device(what, q, k_pool, v_pool, tables, *rows.values(), k_scale,
                 v_scale)
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(
            q, k_pool, v_pool, tables, seq_of_block, block_qstart,
            query_offsets, kv_valid, sliding_window=sliding_window,
            softcap=softcap, k_scale=k_scale, v_scale=v_scale,
            kv_bits=kv_bits)
    ps = k_pool.shape[1]
    reason = (ragged_decline_reason(ps, d, kh, h // kh, q.device)
              or _kv_decline(bits, ps, d, kh, h // kh, k_scale, q.device))
    if reason is not None:
        raise ValueError(f"{what} declines: {reason}")
    ints = _cuda_operands(q, k_pool, v_pool, {"table": tables, **rows},
                          what, k_scale, v_scale)
    ks, vs, bits, groups = _quant_args(k_scale, v_scale, bits)
    out = torch.empty_like(q)
    ws = _decode_workspace(q, kh, tables.shape[1] * ps, rows=s)
    rc = build.library("ragged_paged").rt_ragged_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
        ints["table"].data_ptr(), ints["seq_of_block"].data_ptr(),
        ints["block_qstart"].data_ptr(), ints["query_offsets"].data_ptr(),
        ints["kv_valid"].data_ptr(), out.data_ptr(), ws.data_ptr(), t, h,
        kh, d, ps, tables.shape[1], s, int(sliding_window or 0),
        float(softcap or 0.0), _DTYPE_CODES[q.dtype], bits, groups,
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, f"{what} launch")
    _count(what, bits)
    return out


def _cached_operands(q, k_cache, v_cache, per_row: dict, rows, what: str):
    """Shape/dtype/device checks of a contiguous-cache call; returns the
    [B] int32 row map (arange(B) when `rows` is None)."""
    b, _, h, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"{what}: caches must be [N,S,K,D] and equal, got "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    kh = k_cache.shape[2]
    if k_cache.shape[3] != d or h % kh:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not match caches "
                         f"{tuple(k_cache.shape)}")
    if rows is None:
        if k_cache.shape[0] != b:
            raise ValueError(f"{what}: without `rows` the caches must hold "
                             f"B={b} rows, got {k_cache.shape[0]}")
        rows = torch.arange(b, dtype=torch.int32, device=q.device)
    for name, x in {**per_row, "rows": rows}.items():
        if x.shape != (b,):
            raise ValueError(f"{what}: {name} must be [B], got "
                             f"{tuple(x.shape)}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"{what}: cache dtype {k_cache.dtype} != q dtype "
                         f"{q.dtype}")
    devices = {x.device for x in (q, k_cache, v_cache, rows,
                                  *per_row.values())}
    if len(devices) != 1:
        raise ValueError(f"{what}: operands on several devices {devices}")
    return rows


def flash_prefill_attention(q, k_cache, v_cache, offsets, kv_valid, *,
                            sliding_window: Optional[int] = None,
                            softcap: Optional[float] = None, rows=None):
    """Causal prefill attention of a chunk against the position-aligned
    cache (K8).

    q [B,T,H,D] pre-scaled and rope'd, row i of batch row b at absolute
    position offsets[b] + i; caches [N,S,K,D]; kv_valid [B] = offsets +
    real lengths; `rows` [B] int32 cache row of each batch row (None: row
    b). The caller has written the chunk's K/V into the cache. Returns
    [B,T,H,D] in q's dtype; pad rows (q_pos >= kv_valid) are 0."""
    what = "flash_prefill_attention"
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be [B,T,H,D], got "
                         f"{tuple(q.shape)}")
    per_row = {"offsets": offsets, "kv_valid": kv_valid}
    rows_t = _cached_operands(q, k_cache, v_cache, per_row, rows, what)
    if q.device.type == "cpu":
        return flash_prefill_attention_ref(
            q, k_cache, v_cache, offsets, kv_valid,
            sliding_window=sliding_window, softcap=softcap, rows=rows)
    b, t, h, d = q.shape
    n, s, kh, _ = k_cache.shape
    reason = _decline("flash", t, 0, d, h // kh, q.device)
    if reason is not None:
        raise ValueError(f"{what} declines: {reason}")
    ints = _cuda_operands(q, k_cache, v_cache, {"rows": rows_t, **per_row},
                          what)
    out = torch.empty_like(q)
    rc = build.library("flash_prefill").rt_flash_prefill(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        ints["rows"].data_ptr(), ints["offsets"].data_ptr(),
        ints["kv_valid"].data_ptr(), out.data_ptr(), b, t, h, kh, d, s, n,
        int(sliding_window or 0), float(softcap or 0.0),
        _DTYPE_CODES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, f"{what} launch")
    _launches[what] += 1
    return out


def ragged_decode_attention(q, k_cache, v_cache, kv_valid, *,
                            sliding_window: Optional[int] = None,
                            softcap: Optional[float] = None, rows=None):
    """Single-position decode attention against the position-aligned
    cache (K9).

    q [B,1,H,D] pre-scaled and rope'd; caches [N,S,K,D]; kv_valid [B]
    INCLUDING this step, whose K/V the caller has written already; `rows`
    [B] int32 cache row of each batch row (None: row b). Returns [B,1,H,D]
    in q's dtype."""
    what = "ragged_decode_attention"
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{what} serves one position, got q "
                         f"{tuple(q.shape)}")
    per_row = {"kv_valid": kv_valid}
    rows_t = _cached_operands(q, k_cache, v_cache, per_row, rows, what)
    if q.device.type == "cpu":
        return ragged_decode_attention_ref(
            q, k_cache, v_cache, kv_valid, sliding_window=sliding_window,
            softcap=softcap, rows=rows)
    b, _, h, d = q.shape
    n, s, kh, _ = k_cache.shape
    reason = _decline("rdecode", 1, 0, d, h // kh, q.device)
    if reason is not None:
        raise ValueError(f"{what} declines: {reason}")
    ints = _cuda_operands(q, k_cache, v_cache, {"rows": rows_t, **per_row},
                          what)
    out = torch.empty_like(q)
    ws = _decode_workspace(q, kh, s)
    rc = build.library("ragged_decode").rt_ragged_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        ints["rows"].data_ptr(), ints["kv_valid"].data_ptr(), out.data_ptr(),
        ws.data_ptr(), b, h, kh, d, s, n, int(sliding_window or 0),
        float(softcap or 0.0), _DTYPE_CODES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, f"{what} launch")
    _launches[what] += 1
    return out


# --- K10: the kernels under a (data, model) mesh ---


def spmd_partitionable(num_heads: int, num_kv_heads: int,
                       n_model: int) -> bool:
    """Can the SPMD wrappers partition this head layout over an n_model-way
    model axis? (The JAX package's rule, shared with the engine's
    _resolve_attn.) True when q heads divide AND (kv heads divide, or
    MQA's single kv head replicates)."""
    if num_heads % n_model:
        return False
    return num_kv_heads % n_model == 0 or num_kv_heads == 1


def _spmd_axes(mesh, h: int, kh: int, b: int):
    """(batch_ax, head_ax, kv_head_ax) of a call over `mesh` (JAX
    attention.py:547), or None when the head layout cannot partition.
    `h`, `kh`, `b`: the GLOBAL head, kv-head and row counts."""
    if not spmd_partitionable(h, kh, mesh.model):
        return None
    kv_head_ax = "model" if mesh.splits(kh) else None
    batch_ax = "data" if mesh.splits(b, "data") else None
    head_ax = "model" if mesh.splits(h) else None
    return batch_ax, head_ax, kv_head_ax


def spmd_decline_reason(kind: str, mesh, heads: tuple[int, int],
                        batch: int, t: int, page_size: int, d: int,
                        device, pool_replicas: int = 1) -> Optional[str]:
    """Why the SPMD wrapper `kind` ("flash", "decode", "prefill",
    "ragged") returns None for this call, or None when it serves it: the
    TPU wrappers' partitioning rules on the global `heads` (H, K) and
    `batch`, then the wrapped kernel's gate on the per-shard shapes (`t`
    query rows, the pool's `page_size`, head dim `d`, the local GQA
    group). The engine asks it at construction, the wrappers at every
    call."""
    h, kh = heads
    if kind == "ragged" and mesh.data > 1:
        return "mesh:data-axis"
    axes = _spmd_axes(mesh, h, kh, batch)
    if axes is None:
        return "heads:model-axis"
    batch_ax = axes[0]
    if pool_replicas > 1 and (batch_ax != "data"
                              or mesh.data != pool_replicas):
        return (f"pool_replicas:{pool_replicas} needs rows split over a "
                f"data axis of that size (data {mesh.data}, rows {batch})")
    h_local, kh_local = mesh.local(h), mesh.local(kh)
    group = h_local // kh_local
    if kind == "flash":
        return _decline("flash", t, 0, d, group, device) or (
            _decline("rdecode", 1, 0, d, group, device))
    rows = {"prefill": t, "decode": 1, "ragged": RAGGED_BLOCK_Q}[kind]
    return _decline(kind, rows, page_size, d, group, device)


def _spmd_local(what: str, mesh, heads, batch: Optional[int], q_rows: int,
                h_local: int, kh_local: int) -> int:
    """The global row count of a call (`batch`, required on a data axis),
    after checking that the local tensors are the shard the mesh gives
    this rank."""
    if batch is None:
        if mesh.data > 1:
            raise ValueError(f"{what}: pass the global row count `batch` on "
                             f"a mesh with a data axis")
        batch = q_rows
    if _spmd_axes(mesh, heads[0], heads[1], batch) is not None:
        want = (mesh.local(batch, "data"), mesh.local(heads[0]),
                mesh.local(heads[1]))
        if (q_rows, h_local, kh_local) != want:
            raise ValueError(
                f"{what}: local (rows, heads, kv heads) "
                f"{(q_rows, h_local, kh_local)} are not this rank's shard "
                f"{want} of rows {batch}, heads {tuple(heads)} on mesh "
                f"{mesh.shape}")
    return batch


def _spmd_count(name: str, q) -> None:
    if q.device.type == "cuda":
        _launches[name] += 1


def _flash_spmd(mesh, q, k, v, offsets, kv_valid, *, heads, batch,
                sliding_window, softcap, rows, plain: bool):
    what = "flash_attention_spmd"
    b, t, h_local, d = q.shape
    batch = _spmd_local(what, mesh, heads, batch, b, h_local, k.shape[2])
    if spmd_decline_reason("flash", mesh, heads, batch, t, 0, d,
                           q.device) is not None:
        return None
    kw = dict(sliding_window=sliding_window, softcap=softcap, rows=rows)
    if t > 1:
        fn = flash_prefill_attention_ref if plain else flash_prefill_attention
        out = fn(q, k, v, offsets, kv_valid, **kw)
    else:
        fn = ragged_decode_attention_ref if plain else ragged_decode_attention
        out = fn(q, k, v, kv_valid, **kw)
    if not plain:
        _spmd_count(what, q)
    return out


def flash_attention_spmd(mesh, q, k, v, offsets, kv_valid, *, heads,
                         batch: Optional[int] = None,
                         sliding_window: Optional[int] = None,
                         softcap: Optional[float] = None, rows=None):
    """K8 (a chunk, T > 1) or K9 (one position) on this rank's shard
    (JAX attention.py:570): q [B_l,T,H_l,D] and the caches [N,S,K_l,D]
    hold this rank's rows and kv heads (MQA replicates its kv head),
    `rows` maps batch rows to cache rows as in K8/K9. `heads` = global
    (H, K); `batch` = global rows (needed on a data axis). Returns
    [B_l,T,H_l,D], or None where the TPU wrapper returns None
    (spmd_decline_reason)."""
    return _flash_spmd(mesh, q, k, v, offsets, kv_valid, heads=heads,
                       batch=batch, sliding_window=sliding_window,
                       softcap=softcap, rows=rows,
                       plain=q.device.type == "cpu")


def flash_attention_spmd_ref(mesh, q, k, v, offsets, kv_valid, *, heads,
                             batch: Optional[int] = None,
                             sliding_window: Optional[int] = None,
                             softcap: Optional[float] = None, rows=None):
    """Plain version of flash_attention_spmd: K8/K9's plain versions on the
    same local slices, on any device."""
    return _flash_spmd(mesh, q, k, v, offsets, kv_valid, heads=heads,
                       batch=batch, sliding_window=sliding_window,
                       softcap=softcap, rows=rows, plain=True)


def _rebase(mesh, table, k_pool, pool_replicas: int):
    """A replica's page table in its local page range: the pool's page axis
    is sharded over "data", so shard r holds global pages
    [r * P_l, (r + 1) * P_l) (JAX: table - axis_index("data") *
    per_replica)."""
    if pool_replicas <= 1:
        return table
    return table - mesh.data_index * k_pool.shape[0]


def _paged_spmd(kind: str, mesh, q, k_pool, v_pool, table, offsets,
                kv_valid, *, heads, batch, sliding_window, softcap,
                pool_replicas, k_scale, v_scale, kv_bits, plain: bool):
    what = f"paged_{kind}_spmd"
    b, t, h_local, d = q.shape
    batch = _spmd_local(what, mesh, heads, batch, b, h_local,
                        k_pool.shape[2])
    if spmd_decline_reason(kind, mesh, heads, batch, t, k_pool.shape[1], d,
                           q.device, pool_replicas) is not None:
        return None
    table = _rebase(mesh, table, k_pool, pool_replicas)
    kw = dict(sliding_window=sliding_window, softcap=softcap,
              k_scale=k_scale, v_scale=v_scale, kv_bits=kv_bits)
    if kind == "decode":
        fn = paged_decode_attention_ref if plain else paged_decode_attention
        out = fn(q, k_pool, v_pool, table, kv_valid, **kw)
    else:
        fn = paged_prefill_attention_ref if plain else paged_prefill_attention
        out = fn(q, k_pool, v_pool, table, offsets, kv_valid, **kw)
    if not plain:
        _spmd_count(what, q)
    return out


def paged_decode_spmd(mesh, q, k_pool, v_pool, table, kv_valid, *, heads,
                      batch: Optional[int] = None,
                      sliding_window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      pool_replicas: int = 1, k_scale=None, v_scale=None,
                      kv_bits: int = 8):
    """K1 (with K4 on quantized pools) on this rank's shard (JAX
    attention.py:806): q [B_l,1,H_l,D], pools [P_l,ps,K_l,D] (scale pools
    split like them), table/kv_valid row-aligned with q. With
    `pool_replicas` > 1 the pool's page axis is sharded over "data" and
    each replica's rows reference only its own pages: the table is rebased
    to the local range. Returns [B_l,1,H_l,D] or None
    (spmd_decline_reason)."""
    return _paged_spmd("decode", mesh, q, k_pool, v_pool, table, None,
                       kv_valid, heads=heads, batch=batch,
                       sliding_window=sliding_window, softcap=softcap,
                       pool_replicas=pool_replicas, k_scale=k_scale,
                       v_scale=v_scale, kv_bits=kv_bits,
                       plain=q.device.type == "cpu")


def paged_decode_spmd_ref(mesh, q, k_pool, v_pool, table, kv_valid, *,
                          heads, batch: Optional[int] = None,
                          sliding_window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          pool_replicas: int = 1, k_scale=None,
                          v_scale=None, kv_bits: int = 8):
    """Plain version of paged_decode_spmd (K1's plain version on the same
    local slices)."""
    return _paged_spmd("decode", mesh, q, k_pool, v_pool, table, None,
                       kv_valid, heads=heads, batch=batch,
                       sliding_window=sliding_window, softcap=softcap,
                       pool_replicas=pool_replicas, k_scale=k_scale,
                       v_scale=v_scale, kv_bits=kv_bits, plain=True)


def paged_prefill_spmd(mesh, q, k_pool, v_pool, table, offsets, kv_valid, *,
                       heads, batch: Optional[int] = None,
                       sliding_window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       pool_replicas: int = 1, k_scale=None, v_scale=None,
                       kv_bits: int = 8):
    """K2 (with K4 on quantized pools) on this rank's shard (JAX
    attention.py:464), partitioned as paged_decode_spmd. Returns
    [B_l,T,H_l,D] or None (spmd_decline_reason)."""
    return _paged_spmd("prefill", mesh, q, k_pool, v_pool, table, offsets,
                       kv_valid, heads=heads, batch=batch,
                       sliding_window=sliding_window, softcap=softcap,
                       pool_replicas=pool_replicas, k_scale=k_scale,
                       v_scale=v_scale, kv_bits=kv_bits,
                       plain=q.device.type == "cpu")


def paged_prefill_spmd_ref(mesh, q, k_pool, v_pool, table, offsets,
                           kv_valid, *, heads, batch: Optional[int] = None,
                           sliding_window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           pool_replicas: int = 1, k_scale=None,
                           v_scale=None, kv_bits: int = 8):
    """Plain version of paged_prefill_spmd (K2's plain version on the same
    local slices)."""
    return _paged_spmd("prefill", mesh, q, k_pool, v_pool, table, offsets,
                       kv_valid, heads=heads, batch=batch,
                       sliding_window=sliding_window, softcap=softcap,
                       pool_replicas=pool_replicas, k_scale=k_scale,
                       v_scale=v_scale, kv_bits=kv_bits, plain=True)


def _ragged_spmd(mesh, q, k_pool, v_pool, tables, seq_of_block, block_qstart,
                 query_offsets, kv_valid, *, heads, sliding_window, softcap,
                 k_scale, v_scale, kv_bits, plain: bool):
    what = "ragged_paged_spmd"
    t, h_local, d = q.shape
    if mesh.data > 1:
        return None
    _spmd_local(what, mesh, heads, None, t, h_local, k_pool.shape[2])
    if spmd_decline_reason("ragged", mesh, heads, t, RAGGED_BLOCK_Q,
                           k_pool.shape[1], d, q.device) is not None:
        return None
    fn = ragged_paged_attention_ref if plain else ragged_paged_attention
    out = fn(q, k_pool, v_pool, tables, seq_of_block, block_qstart,
             query_offsets, kv_valid, sliding_window=sliding_window,
             softcap=softcap, k_scale=k_scale, v_scale=v_scale,
             kv_bits=kv_bits)
    if not plain:
        _spmd_count(what, q)
    return out


def ragged_paged_spmd(mesh, q, k_pool, v_pool, tables, seq_of_block,
                      block_qstart, query_offsets, kv_valid, *, heads,
                      sliding_window: Optional[int] = None,
                      softcap: Optional[float] = None, k_scale=None,
                      v_scale=None, kv_bits: int = 8):
    """K3 (with K4 on quantized pools) on this rank's kv heads (JAX
    attention.py:1266): q [T,H_l,D], pools [P,ps,K_l,D]; the flat buffer
    and every metadata array are whole on every rank. Returns [T,H_l,D],
    or None on a mesh with a data axis (a flat buffer mixing replicas'
    rows cannot split) or where spmd_decline_reason declines."""
    return _ragged_spmd(mesh, q, k_pool, v_pool, tables, seq_of_block,
                        block_qstart, query_offsets, kv_valid, heads=heads,
                        sliding_window=sliding_window, softcap=softcap,
                        k_scale=k_scale, v_scale=v_scale, kv_bits=kv_bits,
                        plain=q.device.type == "cpu")


def ragged_paged_spmd_ref(mesh, q, k_pool, v_pool, tables, seq_of_block,
                          block_qstart, query_offsets, kv_valid, *, heads,
                          sliding_window: Optional[int] = None,
                          softcap: Optional[float] = None, k_scale=None,
                          v_scale=None, kv_bits: int = 8):
    """Plain version of ragged_paged_spmd (K3's plain version on the same
    local slices)."""
    return _ragged_spmd(mesh, q, k_pool, v_pool, tables, seq_of_block,
                        block_qstart, query_offsets, kv_valid, heads=heads,
                        sliding_window=sliding_window, softcap=softcap,
                        k_scale=k_scale, v_scale=v_scale, kv_bits=kv_bits,
                        plain=True)
