"""Host-side serving loop pieces (counterpart of
theroundtaible_tpu/engine/serving_loop.py): chunked bucketed prefill with
the cache-end bucket-shrink guard, the decode segment loop with deadline
checks, and the eos-trim/commit epilogue. The engine passes its dispatch
closures; everything else lives here once.

The ragged flat-buffer builder and the data-replica plan are not ported.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from . import deadlines

PREFILL_BUCKETS = (64, 128, 256, 512, 1024, 2048)
MAX_PREFILL_CHUNK = 2048
DECODE_SEGMENT = 64  # tokens per decode segment; timeout checks in between


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
                  device="cpu") -> Callable:
    """Per-segment remaining-row-budget closure. Only an EXPLICIT
    sampling_per_turn carries per-row max_new_tokens budgets (capped by
    the call-level max_new); the prefill-sampled first token has already
    consumed one token of every row's budget, hence the -1. `budget` is
    the remaining global token count."""
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
