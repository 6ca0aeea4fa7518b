"""Host-side serving loop pieces (counterpart of
theroundtaible_tpu/engine/serving_loop.py): chunked bucketed prefill with
the cache-end bucket-shrink guard, the decode segment loop with deadline
checks, the ragged flat buffer (build_ragged_batch) of the scheduler's mixed
prefill/decode dispatches, and the eos-trim/commit epilogue. The engine
passes its dispatch closures; everything else lives here once.

The data-replica plan is not ported.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import deadlines
from .device import resolve_device

PREFILL_BUCKETS = (64, 128, 256, 512, 1024, 2048)
MAX_PREFILL_CHUNK = 2048
DECODE_SEGMENT = 64  # tokens per decode segment; timeout checks in between

# Ragged mixed prefill/decode dispatch: the flat token buffer's row
# granularity (one decode token occupies one 8-row block) and the env
# overrides of the per-dispatch token budget and the deferral threshold.
RAGGED_BLOCK_Q = 8
RAGGED_TOKENS_ENV = "ROUNDTABLE_RAGGED_TOKENS"
RAGGED_DEFER_MIN_ENV = "ROUNDTABLE_RAGGED_DEFER_MIN"


def ragged_token_budget(num_slots: int) -> int:
    """Flat-buffer capacity per ragged dispatch: big enough that a typical
    cold join's leader span streams in one dispatch, floored so every
    resident row's 8-row decode block still leaves chunk room.
    ROUNDTABLE_RAGGED_TOKENS overrides (rounded up to a block multiple)."""
    forced = int(os.environ.get(RAGGED_TOKENS_ENV, "0") or 0)
    if forced > 0:
        return -(-forced // RAGGED_BLOCK_Q) * RAGGED_BLOCK_Q
    return max(1024, RAGGED_BLOCK_Q * num_slots + 64)


def ragged_defer_min() -> int:
    """Suffix-token threshold below which a join keeps the blocking
    prologue even on a ragged engine: a warm join's few dozen tokens cost
    less as one small prefill than spread across ragged ticks. Only cold
    prefills are deferred. ROUNDTABLE_RAGGED_DEFER_MIN overrides."""
    return int(os.environ.get(RAGGED_DEFER_MIN_ENV, "256") or 256)


def ragged_shape_grid(budget: int) -> tuple[int, ...]:
    """The small fixed grid of flat-buffer shapes, {64, 256, 1024, budget}
    capped at the budget: a dispatch computes its whole buffer, pads
    included, so a lone decode step plus a short tail chunk must not pay
    for the full budget. A fixed grid also keeps the set of shapes a later
    CUDA-graph capture has to cover small."""
    return tuple(sorted({s for s in (64, 256, 1024, budget)
                         if s <= budget}))


def ragged_pick_shape(grid: tuple[int, ...], want: int) -> int:
    """Smallest grid shape >= want (the last shape when none is)."""
    for s in grid:
        if want <= s:
            return s
    return grid[-1]


def run_dispatch(dispatch: Callable, retry, deadline: float = float("inf"),
                 budget=None, rung: str = "dispatch"):
    """One device dispatch through the deadline seam (the watchdog times
    the blocking part when armed) and the retry policy, which re-runs a
    transiently-failed dispatch before it surfaces; failures a retry
    cannot fix pass straight through to the caller's degradation rung."""

    def attempt():
        if deadlines.ACTIVE and budget is not None:
            return deadlines.watched_wait(dispatch, budget, rung)
        return dispatch()

    if retry is None:
        return attempt()
    return retry.run(attempt, deadline=deadline)


def host_sync(fn: Callable, budget=None, rung: str = "decode"):
    """A blocking device->host read through the deadline seam: the read is
    where a wedged device program freezes the host loop."""
    if deadlines.ACTIVE and budget is not None:
        return deadlines.watched_wait(fn, budget, rung)
    return fn()


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n."""
    b = 1
    while b < n:
        b <<= 1
    return b


def clamp_max_new(max_new: int, max_seq_len: int) -> tuple[int, int]:
    """(clamped max_new, segment-padded decode reserve): decode never
    exceeds half the context, and the reserve rounds up to whole
    DECODE_SEGMENTs."""
    m = max(1, min(max_new, max_seq_len // 2))
    return m, -(-m // DECODE_SEGMENT) * DECODE_SEGMENT


def prompt_budget(max_seq_len: int, max_new_padded: int) -> int:
    """Prompt-token budget once the padded decode reserve is set aside.
    Raises when fewer than 2 tokens remain (head-truncation keeps [bos] +
    the last budget-1 tokens, so budget <= 1 would collapse every prompt
    to [bos])."""
    budget = max_seq_len - max_new_padded - 1
    if budget < 2:
        raise ValueError(
            f"max_seq_len {max_seq_len} leaves no prompt room after the "
            f"{max_new_padded}-token decode reserve (segments pad to "
            f"{DECODE_SEGMENT}) - use max_seq_len > {max_new_padded + 2} "
            "or lower max_new_tokens")
    return budget


def bucket_for(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return MAX_PREFILL_CHUNK


def chunked_prefill(
    dispatch: Callable[[np.ndarray, list[int], np.ndarray], torch.Tensor],
    token_lists: list[list[int]],
    offsets: list[int],
    max_seq_len: int,
    pad_id: int,
    deadline: float = float("inf"),
    retry=None,
    budget=None,
) -> torch.Tensor:
    """Bucketed multi-chunk prefill. Returns last-token logits [B, V].

    dispatch(chunk [B, bucket], offs, lengths) runs one chunk and returns
    its last-token logits. Every row writes a bucket-wide block at its
    offset; near the cache end the bucket shrinks so no row's write
    overruns the cache. Each row's logits are kept from the chunk where
    its REAL tokens ended - later pad-only chunks must not clobber them.
    `budget`: cancellation/deadline checks run between chunks."""
    b = len(token_lists)
    if budget is not None:
        deadline = min(deadline, budget.deadline)
    offs = list(offsets)
    remaining = [list(t) for t in token_lists]
    final_logits: Optional[torch.Tensor] = None
    while any(remaining):
        max_len = min(max(len(r) for r in remaining), MAX_PREFILL_CHUNK)
        bucket = bucket_for(max_len)
        allowed = max_seq_len - max(offs)
        if bucket > allowed:
            smaller = [x for x in PREFILL_BUCKETS if x <= allowed]
            bucket = smaller[-1] if smaller else max(allowed, 1)
        chunk = np.full((b, bucket), pad_id, np.int32)
        lengths = np.zeros((b,), np.int32)
        takes = np.zeros((b,), np.int32)
        for i, r in enumerate(remaining):
            take = min(len(r), bucket)
            takes[i] = take
            if take:
                chunk[i, :take] = r[:take]
                del r[:take]
            # Exhausted rows feed one pad at their current offset; it stays
            # outside their committed length and decode overwrites that
            # position with the first real generated token.
            lengths[i] = max(take, 1)
        if budget is not None:
            budget.check()
        last_logits = run_dispatch(
            lambda: dispatch(chunk, offs, lengths), retry, deadline,
            budget=budget)
        if final_logits is None:
            final_logits = last_logits
        else:
            keep = torch.as_tensor(takes > 0, device=last_logits.device)
            final_logits = torch.where(keep[:, None], last_logits,
                                       final_logits)
        for i in range(b):
            offs[i] += int(takes[i])
        if time.monotonic() > deadline and any(remaining):
            raise TimeoutError("prefill timed out")
    return final_logits


def row_budget_fn(per_row, sampling_per_turn, max_new: int,
                  device="cuda") -> Callable:
    """Per-segment remaining-row-budget closure. Only an EXPLICIT
    sampling_per_turn carries per-row max_new_tokens budgets (capped by
    the call-level max_new); the prefill-sampled first token has already
    consumed one token of every row's budget, hence the -1. `budget` is
    the remaining global token count. The totals live on the card unless
    the caller passes device="cpu"."""
    device = resolve_device(device)
    if sampling_per_turn:
        totals = [min(p.max_new_tokens, max_new) for p in per_row]
    else:
        totals = [max_new] * len(per_row)
    totals_t = torch.tensor(totals, dtype=torch.int32, device=device)

    def remaining(budget: int) -> torch.Tensor:
        consumed = max_new - budget
        return torch.clamp(totals_t - 1 - consumed, min=0)

    return remaining


def decode_segments(
    dispatch: Callable,
    first_token: torch.Tensor,
    start_valid: torch.Tensor,
    eos_id: int,
    max_new: int,
    deadline: float,
    timeout_s: float,
    retry=None,
    budget=None,
) -> np.ndarray:
    """Segmented decode: one dispatch per DECODE_SEGMENT tokens with
    host-side timeout/cancel/early-exit checks in between.

    dispatch(cur_last, cur_valid, budget, done0) -> (out, steps, last,
    valid, done) runs one segment; `budget` is the number of tokens still
    wanted, done0 the [B] done mask carried across segments. Returns the
    concatenated token matrix [B, produced]. Segments run one after
    another: the segment's own step loop already syncs with the host."""
    b = first_token.shape[0]
    if budget is not None:
        deadline = min(deadline, budget.deadline)
    segments: list[np.ndarray] = []
    produced = 0
    last, valid = first_token, start_valid
    done = first_token == eos_id
    while True:
        out, steps, last, valid, done = run_dispatch(
            lambda last=last, valid=valid, done=done: dispatch(
                last, valid, max_new - produced, done),
            retry, deadline, budget=budget)

        def read_segment(out=out, steps=steps, done=done):
            return (out[:, :steps].cpu().numpy(),
                    bool(torch.all(done).item()))

        seg, all_done = host_sync(read_segment, budget, "decode")
        segments.append(seg)
        produced += steps
        if produced >= max_new or all_done:
            break
        if budget is not None and budget.token.cancelled:
            budget.check()  # raises Cancelled with the drain/abort reason
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"generation timed out after {timeout_s:.0f}s "
                f"({produced}/{max_new} tokens)")
    return (np.concatenate(segments, axis=1) if segments
            else np.zeros((b, 0), np.int32))


class RaggedSeq:
    """One sequence's slice of a ragged dispatch: the tokens it feeds this
    call (a prefill chunk, the single last-sampled token of a decode row,
    or a speculative ``[last, drafts...]`` verify run), the absolute
    position of the first one, its page-table row, its sampling params and
    its LoRA adapter slot (`adapter`, 0 = the base model: the flat buffer
    mixes adapters, so the slot rides per token). `n_scores` is how many
    trailing token rows the dispatch scores: 1 for plain rows, drafts + 1
    for a verify run."""

    __slots__ = ("tokens", "pos", "table", "temperature", "top_k",
                 "top_p", "n_scores", "adapter")

    def __init__(self, tokens: list[int], pos: int, table: np.ndarray,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, n_scores: int = 1,
                 adapter: int = 0):
        self.tokens = tokens
        self.pos = pos
        self.table = table
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.n_scores = n_scores
        self.adapter = adapter


def build_ragged_batch(seqs: list[RaggedSeq], *, t_budget: int,
                       s_max: int, pages_per_seq: int, scratch_page: int,
                       pad_id: int, page_size: int,
                       score_width: int = 0,
                       copy_pairs: Optional[list] = None,
                       copy_slots: int = 0) -> dict:
    """Host inputs (numpy) of one ragged mixed prefill/decode dispatch.

    Every array's shape follows from (t_budget, s_max) alone; the
    composition lives in the values. Each sequence occupies a
    RAGGED_BLOCK_Q-aligned run of the flat buffer; the last slot of s_max
    is the inert sequence every pad block points at (kv_valid 1 over the
    scratch page). Pad tokens scatter their K/V to the scratch page, which
    no real sequence reads. Every table entry and position index stays
    inside the sequence's table (torch indexing raises where JAX clamps).

    Returns flat tokens/positions/token_pages/token_offs/token_seq
    [t_budget], per-block seq_of_block/block_qstart [t_budget/8], per-seq
    tables/query_offsets/kv_valid/last_rows/temps/top_ks/top_ps
    [s_max, ...], token_adapter [t_budget] (each real token's sequence
    adapter slot; pad tokens keep 0, the base), `greedy`, and the
    accounting fields
    n_seqs/n_tokens.

    `score_width` > 0 (the speculative verify): the dict also carries
    `sample_rows` [s_max, score_width], for each sequence the flat rows of
    its last n_scores tokens (pad columns repeat the last row; their
    scores are computed and dropped). `copy_slots` > 0 (tree verify): it
    also carries `copy_src`/`copy_dst` [copy_slots], whole pages the
    dispatch copies before its K/V writes (a tree path's private copy of
    the row's partly committed frontier page), padded with scratch-page
    self-copies. Every shape follows from (t_budget, s_max, score_width,
    copy_slots) alone."""
    bq = RAGGED_BLOCK_Q
    if t_budget % bq:
        raise ValueError(f"t_budget {t_budget} not a multiple of {bq}")
    nb = t_budget // bq
    inert = s_max - 1
    if len(seqs) > inert:
        raise ValueError(
            f"{len(seqs)} sequences > {inert} (one slot is the inert "
            "pad sequence)")
    tokens = np.full(t_budget, pad_id, np.int32)
    positions = np.zeros(t_budget, np.int32)
    token_pages = np.full(t_budget, scratch_page, np.int32)
    token_offs = np.zeros(t_budget, np.int32)
    token_seq = np.full(t_budget, inert, np.int32)
    seq_of_block = np.full(nb, inert, np.int32)
    block_qstart = np.zeros(nb, np.int32)
    tables = np.full((s_max, pages_per_seq), scratch_page, np.int32)
    query_offsets = np.zeros(s_max, np.int32)
    kv_valid = np.ones(s_max, np.int32)
    last_rows = np.zeros(s_max, np.int32)
    token_adapter = np.zeros(t_budget, np.int32)
    temps = np.ones(s_max, np.float32)
    top_ks = np.zeros(s_max, np.int32)
    top_ps = np.ones(s_max, np.float32)
    sample_rows = (np.zeros((s_max, score_width), np.int32)
                   if score_width > 0 else None)
    copy_src = copy_dst = None
    if copy_slots > 0:
        pairs = list(copy_pairs or [])
        if len(pairs) > copy_slots:
            raise ValueError(
                f"{len(pairs)} copy pairs > copy_slots {copy_slots}")
        copy_src = np.full(copy_slots, scratch_page, np.int32)
        copy_dst = np.full(copy_slots, scratch_page, np.int32)
        for k, (src, dst) in enumerate(pairs):
            copy_src[k] = src
            copy_dst[k] = dst
    elif copy_pairs:
        raise ValueError("copy_pairs given without copy_slots")

    row = 0
    n_tokens = 0
    for i, s in enumerate(seqs):
        n = len(s.tokens)
        if n < 1:
            raise ValueError("RaggedSeq needs at least one token")
        if s.n_scores < 1 or s.n_scores > n:
            raise ValueError(
                f"n_scores {s.n_scores} outside 1..{n} (run length)")
        if score_width and s.n_scores > score_width:
            raise ValueError(
                f"n_scores {s.n_scores} > score_width {score_width}")
        span = -(-n // bq) * bq
        if row + span > t_budget:
            raise ValueError(
                f"sequences overflow the {t_budget}-token budget")
        tokens[row:row + n] = s.tokens
        # Pad rows inside the span continue the position run: their
        # outputs are dropped, the positions only steer causal frontiers.
        positions[row:row + span] = s.pos + np.arange(span)
        pos_n = s.pos + np.arange(n)
        token_pages[row:row + n] = s.table[pos_n // page_size]
        token_offs[row:row + n] = pos_n % page_size
        token_seq[row:row + span] = i
        # Pad rows inside the span keep adapter 0: their K/V lands on the
        # scratch page and their outputs are dropped.
        token_adapter[row:row + n] = s.adapter
        b0 = row // bq
        for k in range(span // bq):
            seq_of_block[b0 + k] = i
            block_qstart[b0 + k] = k * bq
        tables[i] = s.table
        query_offsets[i] = s.pos
        kv_valid[i] = s.pos + n
        last_rows[i] = row + n - 1
        if sample_rows is not None:
            first = row + n - s.n_scores
            sample_rows[i] = np.minimum(first + np.arange(score_width),
                                        row + n - 1)
        temps[i] = s.temperature
        top_ks[i] = s.top_k
        top_ps[i] = s.top_p
        row += span
        n_tokens += n
    return {
        "tokens": tokens, "positions": positions,
        "token_pages": token_pages, "token_offs": token_offs,
        "token_seq": token_seq, "seq_of_block": seq_of_block,
        "block_qstart": block_qstart, "tables": tables,
        "query_offsets": query_offsets, "kv_valid": kv_valid,
        "last_rows": last_rows, "temps": temps, "top_ks": top_ks,
        "top_ps": top_ps, "token_adapter": token_adapter,
        "greedy": all(s.temperature <= 0.0 for s in seqs),
        "n_seqs": len(seqs), "n_tokens": n_tokens,
        "score_width": score_width,
        **({"sample_rows": sample_rows} if sample_rows is not None
           else {}),
        **({"copy_src": copy_src, "copy_dst": copy_dst}
           if copy_src is not None else {}),
    }


def eos_trim(ids: list[int], eos_id: int, max_new: int) -> list[int]:
    """Canonical per-row output epilogue: cut at the first eos, cap at
    max_new."""
    if eos_id in ids:
        ids = ids[:ids.index(eos_id)]
    return ids[:max_new]


def finalize_outputs(turns, first_np: np.ndarray, out_np: np.ndarray,
                     all_tokens: list[list[int]], max_new: int,
                     eos_id: int, commit: Callable[[str, list[int]], None],
                     decode: Callable[[list[int]], str],
                     stats) -> list[str]:
    """Eos-trim each row, commit prompt+fed ids for next-turn prefix
    reuse, detokenize, and account decode tokens into stats."""
    results = []
    for i, (name, _) in enumerate(turns):
        ids = eos_trim([int(first_np[i])] + [int(x) for x in out_np[i]],
                       eos_id, max_new)
        stats.decode_tokens += len(ids)
        # the cache holds prompt + every fed token (all but the last
        # sampled one); commit exactly that for next-turn prefix reuse
        fed = ids[:-1] if ids else []
        commit(name, all_tokens[i] + fed)
        results.append(decode(ids))
    return results
