"""Token sampling - greedy, temperature, top-k, top-p, per row
(counterpart of theroundtaible_tpu/engine/sampling.py).

Greedy is exactly argmax. Sampled draws come from a torch.Generator the
caller owns (the engine seeds it from its `seed`): the Gumbel-max draw over
the filtered logits that jax.random.categorical makes, with torch's bits,
so draws do not repeat the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .device import resolve_device


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0      # 0 = greedy
    top_k: int = 0                # 0 = disabled
    top_p: float = 1.0            # 1 = disabled
    max_new_tokens: int = 1024


def sampling_arrays(params_list: list[SamplingParams], device="cuda"):
    """Per-row (temps, top_ks, top_ps) f32/i32/f32 tensors for
    sample_token_batch, on the card unless the caller passes
    device="cpu"."""
    device = resolve_device(device)
    return (torch.tensor([p.temperature for p in params_list],
                         dtype=torch.float32, device=device),
            torch.tensor([p.top_k for p in params_list], dtype=torch.int32,
                         device=device),
            torch.tensor([p.top_p for p in params_list], dtype=torch.float32,
                         device=device))


# Candidate-pool size of the sort-free path below; rows whose top_k or
# top-p cutoff it cannot prove take the exact full-sort tail.
_K_CAND = 128
_NEG_INF = float("-inf")


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx.long()[:, None])


def _exact_tail(scaled: torch.Tensor, top_ks: torch.Tensor,
                top_ps: torch.Tensor) -> torch.Tensor:
    """The full-sort threshold computation: top-k mask, then the top-p
    cutoff on the re-sorted masked row. Returns the filtered logits
    (dropped entries -inf)."""
    v = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = _take(sorted_desc, torch.clamp(top_ks - 1, 0, v - 1))
    kth = torch.where((top_ks > 0)[:, None], kth, _NEG_INF)
    scaled = torch.where(scaled < kth, _NEG_INF, scaled)
    sorted2 = torch.sort(scaled, dim=-1, descending=True).values
    cumulative = torch.cumsum(torch.softmax(sorted2, dim=-1), dim=-1)
    cutoff_idx = torch.clamp(
        torch.sum(cumulative < top_ps[:, None], dim=-1), 0, v - 1)
    cutoff = _take(sorted2, cutoff_idx)
    # top_p == 1.0 means disabled: the f32 cumsum can saturate at 1.0
    # before the last element, which would otherwise mask far-tail tokens.
    cutoff = torch.where((top_ps < 1.0)[:, None], cutoff, _NEG_INF)
    return torch.where(scaled < cutoff, _NEG_INF, scaled)


def sampler_mode(params_list: list[SamplingParams]) -> str:
    """Which path sample_token_batch takes for these per-row params:
    "greedy" (every row temp <= 0), "sort" (some top_k beyond the candidate
    pool forces the exact full-vocab sort) or "sort-free"."""
    if all(p.temperature <= 0.0 for p in params_list):
        return "greedy"
    if any(p.top_k > _K_CAND for p in params_list):
        return "sort"
    return "sort-free"


def filtered_logits(logits: torch.Tensor, temps: torch.Tensor,
                    top_ks: torch.Tensor,
                    top_ps: torch.Tensor) -> torch.Tensor:
    """Temperature-scaled logits with the per-row top-k/top-p filters
    applied (dropped entries -inf): the candidate-pool thresholds where
    the pool proves them, the exact tail for the other rows - per row, so
    a row's kept set never depends on its batchmates."""
    v = logits.shape[-1]
    k_cand = min(_K_CAND, v)
    scaled = logits / torch.clamp(temps[:, None], min=1e-6)
    cand = torch.topk(scaled, k_cand, dim=-1).values         # descending
    kth = _take(cand, torch.clamp(top_ks - 1, 0, k_cand - 1))
    kth = torch.where((top_ks > 0)[:, None], kth, _NEG_INF)
    m1 = torch.where(scaled < kth, _NEG_INF, scaled)
    cand1 = torch.where(cand < kth, _NEG_INF, cand)
    m_max = torch.max(m1, dim=-1, keepdim=True).values
    denom = torch.sum(torch.exp(m1 - m_max), dim=-1, keepdim=True)
    cum = torch.cumsum(torch.exp(cand1 - m_max) / denom, dim=-1)
    cutoff_idx = torch.clamp(torch.sum(cum < top_ps[:, None], dim=-1), 0,
                             k_cand - 1)
    cutoff = _take(cand1, cutoff_idx)
    cutoff = torch.where((top_ps < 1.0)[:, None], cutoff, _NEG_INF)
    masked = torch.where(m1 < cutoff, _NEG_INF, m1)
    bad = (temps > 0.0) & ((top_ks > k_cand)
                           | ((top_ps < 1.0) & (cum[:, -1] < top_ps)))
    if bool(bad.any()):
        masked = torch.where(bad[:, None],
                             _exact_tail(scaled, top_ks, top_ps), masked)
    return masked


def sample_token_batch(logits: torch.Tensor,
                       generator: Optional[torch.Generator],
                       temps: torch.Tensor, top_ks: torch.Tensor,
                       top_ps: torch.Tensor) -> torch.Tensor:
    """logits [B, V] f32 -> token ids [B] with per-row sampling params:
    temperature <= 0 is greedy; top_k == 0 / top_p == 1.0 disable their
    filter; top-k applies before the top-p cutoff."""
    greedy = torch.argmax(logits, dim=-1)
    masked = filtered_logits(logits, temps, top_ks, top_ps)
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    sampled = torch.argmax(masked + gumbel, dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled)


def sample_positions(logits: torch.Tensor,
                     generator: Optional[torch.Generator],
                     temps: torch.Tensor, top_ks: torch.Tensor,
                     top_ps: torch.Tensor, greedy: bool) -> torch.Tensor:
    """A speculative verify's tokens: logits [S, R, V] f32 -> [S, R] ids,
    one per scored position - the argmax, or a draw through
    sample_token_batch with each sequence's temperature, top-k and top-p
    repeated R times (one draw of S*R independent rows)."""
    s, r, v = logits.shape
    if greedy:
        return torch.argmax(logits, dim=-1)
    return sample_token_batch(
        logits.reshape(s * r, v), generator,
        torch.repeat_interleave(temps, r),
        torch.repeat_interleave(top_ks, r),
        torch.repeat_interleave(top_ps, r)).reshape(s, r)
