"""Long-context sequence parallelism - ring attention and Ulysses
all-to-all (counterpart of theroundtaible_tpu/engine/longcontext.py).

A fresh long prompt is prefilled with its sequence split over the ranks of
a ring (`SeqRing`): rank i holds positions [i * T/n, (i + 1) * T/n) of
every row, and the attention memory and work split with them. Two schemes,
as in the JAX package:

- **Ring attention** (`ring_attention`): each rank keeps an online-softmax
  accumulator (m, l, o) in f32 over its own queries while the K/V shards
  make n - 1 hops around the ring (distributed.send_to to rank i + 1,
  recv_into from rank i - 1; the send is posted before the hop's compute).
  Masks come from absolute positions, so a shard's origin needs no
  arithmetic and ragged tails just mask out. Works for any head count.
- **Ulysses** (`ulysses_attention`): all-to-alls swap the sequence axis for
  the head axis, so each rank attends over the whole sequence with H/n
  heads; it needs num_heads % n == 0, and GQA-expands the kv heads first
  when they do not divide.

The local core (`blockwise_sdpa`, and each hop of the ring) runs blocks of
at most `block` keys through the same online update (`_online_update`):
one block's f32 logits are [B, H, T, block], never a hop's or the whole
sequence's. Its products are plain matmuls, as the JAX package computes
them outside any Pallas kernel. A block that no query of any row may
attend (causal, past every row's valid length, or behind every query's
sliding window), read from the positions on the host, is skipped: it
would leave (m, l, o) as they are.

`make_ring_prefill` is the whole prefill: the embedding of this rank's
shard, every layer through models/common.transformer_block with the ring
(or Ulysses) core in its attn_fn hook and the `_matmul` seam (so int8 and
int4 weights compose), the final norm, and the head on the one hidden row
per batch row at position length - 1, summed over the ring: never
[B, T, V] logits. Each layer's whole-sequence (k, v) is gathered over the
ring for the caller (engine.py writes it into the slots or the pages).

The ring is the engine's ranks. Where the JAX package's program takes its
weights replicated and XLA gathers them, a rank here holds its model-axis
shard: each layer's shards are gathered over the model group just before
the layer runs and freed after it (sharding.gather_layer), the
vocab-sharded embedding is looked up per model group and summed over it,
and the head runs on the shards with its logits gathered, as the main
path's head. On one device the ring has width 1 and communicates nothing
(the JAX package's one-device seq mesh).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from .models.common import (MASK_VALUE, ModelConfig, Params, _o_proj,
                            _softcap, embed_tokens, lm_head, project_qkv,
                            rms_norm, rope_tables, scale_embeddings,
                            transformer_block)

BIG_NEG = MASK_VALUE
# Keys per block of the local core: one block's f32 logits are
# [B, H, T, KEY_BLOCK].
KEY_BLOCK = 512


@dataclasses.dataclass(frozen=True, eq=False)
class SeqRing:
    """The ring of a sequence-parallel prefill seen from one rank: its
    width, this rank's position in it (its sequence shard), and the gloo
    group its hops and all-to-alls go over (None at width 1). Ring
    position i is global rank i."""

    size: int = 1
    index: int = 0
    group: Any = None


def build_seq_mesh(n_seq: int) -> SeqRing:
    """The ring over the first n_seq ranks of the initialized process
    group (counterpart of the JAX package's build_seq_mesh over the first
    n_seq devices); width 1 needs no group. Every rank of the group must
    call it, in the same order: it creates the ring's gloo group, whose
    waits are bounded by the plan group's timeout."""
    if n_seq <= 1:
        return SeqRing()
    import datetime
    import torch.distributed as dist
    from .mesh_plan import PLAN_TIMEOUT_S
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n_seq:
        raise ValueError(f"seq mesh needs {n_seq} devices, have {have}")
    group = dist.new_group(
        list(range(n_seq)), backend="gloo",
        timeout=datetime.timedelta(seconds=PLAN_TIMEOUT_S))
    return SeqRing(n_seq, dist.get_rank(), group)


def _gqa_expand(x: torch.Tensor, repeat: int) -> torch.Tensor:
    return x.repeat_interleave(repeat, dim=2) if repeat > 1 else x


def _grouped(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """q [B,T,H,D] as f32 [B, K', G*T, D]: query head h = k * G + g reads
    kv head k (the JAX package's jnp.repeat order), so no K/V copy is
    expanded."""
    b, t, h, d = q.shape
    g = h // kv_heads
    return (q.float().view(b, t, kv_heads, g, d).permute(0, 2, 3, 1, 4)
            .reshape(b, kv_heads, g * t, d))


def _attend_block(state, qg, k_blk, v_blk, q_pos, kv_pos, kv_valid,
                  cfg: ModelConfig):
    """One online-softmax step (the JAX package's _online_update) of the
    grouped queries qg [B, K', G*T, D] against a roped K/V block
    [B, S, K', D] at absolute positions kv_pos [B, S]. `state` is
    (m, l, o) in f32, [B, K', G, T] and [B, K', G, T, D]."""
    m, l, o = state
    b, kh, g, t = m.shape
    s = k_blk.shape[1]
    kf = k_blk.float().permute(0, 2, 3, 1)                  # [B,K',D,S]
    vf = v_blk.float().permute(0, 2, 1, 3)                  # [B,K',S,D]
    logits = torch.matmul(qg, kf).view(b, kh, g, t, s)
    if cfg.attn_logit_softcap is not None:
        logits = _softcap(logits, cfg.attn_logit_softcap)
    mask = kv_pos[:, None, :] <= q_pos[:, :, None]          # causal
    mask &= kv_pos[:, None, :] < kv_valid[:, None, None]    # padded rows
    if cfg.sliding_window is not None:
        mask &= kv_pos[:, None, :] > q_pos[:, :, None] - cfg.sliding_window
    mask = mask[:, None, None]                              # [B,1,1,T,S]
    logits.masked_fill_(~mask, BIG_NEG)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    # `* mask` matters: an all-masked block has logits == m_new == BIG_NEG
    # and exp(0) would otherwise contribute a spurious 1 per key.
    p = logits.sub_(m_new[..., None]).exp_().mul_(mask)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.matmul(
        p.view(b, kh, g * t, s), vf).view(b, kh, g, t, -1)
    return m_new, l, o


def _online_update(m, l, o, q, k_blk, v_blk, q_pos, kv_pos, kv_valid,
                   cfg: ModelConfig, kv_repeat: int):
    """One flash-attention-style accumulation step against a K/V block,
    with the JAX package's shapes: state (m, l, o) [B,H,T] / [B,H,T] /
    [B,H,T,D] in f32, q pre-scaled and roped [B,T,H,D], k_blk/v_blk roped
    [B,S,K',D] with K' * kv_repeat == H, absolute positions kv_pos
    [B,S]."""
    b, t, h, d = q.shape
    kh = h // kv_repeat
    state = (m.view(b, kh, kv_repeat, t), l.view(b, kh, kv_repeat, t),
             o.view(b, kh, kv_repeat, t, d))
    m, l, o = _attend_block(state, _grouped(q, kh), k_blk, v_blk, q_pos,
                            kv_pos, kv_valid, cfg)
    return m.view(b, h, t), l.view(b, h, t), o.view(b, h, t, d)


def _finalize(l, o, dtype) -> torch.Tensor:
    """[B,H,T,D] accumulator -> [B,T,H,D] output; fully-masked (pad) query
    rows have l == 0 and are defined as 0."""
    out = o / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.transpose(1, 2).to(dtype)


def _init_state(b: int, kv_heads: int, g: int, t: int, d: int, device):
    return (torch.full((b, kv_heads, g, t), float("-inf"),
                       dtype=torch.float32, device=device),
            torch.zeros((b, kv_heads, g, t), dtype=torch.float32,
                        device=device),
            torch.zeros((b, kv_heads, g, t, d), dtype=torch.float32,
                        device=device))


class _Frontier:
    """The host's view of which keys any query may attend: per row the
    queries' lowest and highest position and the valid length."""

    def __init__(self, q_pos: torch.Tensor, kv_valid: torch.Tensor,
                 window: Optional[int]):
        qp = q_pos.cpu().numpy()
        self.q_lo, self.q_hi = qp.min(axis=1), qp.max(axis=1)
        self.valid = kv_valid.cpu().numpy()
        self.window = window

    def needed(self, kv_pos: np.ndarray) -> bool:
        """Whether some row has a query that may attend some key at
        kv_pos [B, S] (else the block leaves the state as it is)."""
        lo, hi = kv_pos.min(axis=1), kv_pos.max(axis=1)
        row = (lo <= self.q_hi) & (lo < self.valid)
        if self.window is not None:
            row &= hi > self.q_lo - self.window
        return bool(row.any())


def _attend_blocks(state, qg, k, v, q_pos, kv_pos_host, kv_valid, cfg,
                   frontier: _Frontier, block: int):
    """The online update over k/v [B,S,K',D] in blocks of `block` keys,
    skipping the blocks no query may attend."""
    dev = k.device
    for start in range(0, k.shape[1], block):
        end = min(start + block, k.shape[1])
        kp = kv_pos_host[:, start:end]
        if not frontier.needed(kp):
            continue
        state = _attend_block(state, qg, k[:, start:end], v[:, start:end],
                              q_pos, torch.as_tensor(kp, device=dev),
                              kv_valid, cfg)
    return state


def blockwise_sdpa(q, k, v, q_pos, kv_pos, kv_valid, cfg: ModelConfig,
                   block: int = KEY_BLOCK) -> torch.Tensor:
    """Single-device blockwise attention (online softmax over KV blocks):
    bounded memory for full-sequence attention, the local core of Ulysses.
    q [B,T,H,D], k/v [B,S,K',D] where H % K' == 0."""
    b, t, h, d = q.shape
    kh = k.shape[2]
    frontier = _Frontier(q_pos, kv_valid, cfg.sliding_window)
    state = _init_state(b, kh, h // kh, t, d, q.device)
    m, l, o = _attend_blocks(state, _grouped(q, kh), k, v, q_pos,
                             kv_pos.cpu().numpy(), kv_valid, cfg, frontier,
                             block)
    return _finalize(l.reshape(b, h, t), o.reshape(b, h, t, d), q.dtype)


def ring_attention(q, k, v, q_pos, kv_pos, kv_valid, cfg: ModelConfig,
                   ring: Optional[SeqRing] = None,
                   block: int = KEY_BLOCK) -> torch.Tensor:
    """Sequence-parallel causal attention on this rank of `ring` (width 1
    without one): q the local query shard [B,Tl,H,D] (pre-scaled, roped),
    k/v the local KV shard [B,Sl,K,D] (roped), q_pos/kv_pos absolute
    positions [B,Tl]/[B,Sl], kv_valid [B] the rows' valid lengths. Returns
    [B,Tl,H,D].

    The K/V shard and its positions make size-1 hops around the ring:
    each hop's sends to the next rank are posted before its blocks are
    attended, its shard from the previous rank is received after them.
    Every wait is bounded by the plan group's timeout."""
    from .distributed import note_ring_hop, recv_into, send_to
    n = ring.size if ring is not None else 1
    b, t, h, d = q.shape
    kh = k.shape[2]
    frontier = _Frontier(q_pos, kv_valid, cfg.sliding_window)
    qg = _grouped(q, kh)
    state = _init_state(b, kh, h // kh, t, d, q.device)
    kv = torch.stack((k, v))
    kv_pos_host = kv_pos.cpu().to(torch.int32)
    for step in range(n):
        pending = []
        if step < n - 1:
            t0 = time.monotonic()
            dst, src = (ring.index + 1) % n, (ring.index - 1) % n
            pending = [send_to(kv, dst, ring.group),
                       send_to(kv_pos_host, dst, ring.group)]
            hop_s = time.monotonic() - t0
        state = _attend_blocks(state, qg, kv[0], kv[1], q_pos,
                               kv_pos_host.numpy(), kv_valid, cfg, frontier,
                               block)
        if step < n - 1:
            t0 = time.monotonic()
            kv = recv_into(torch.empty_like(kv), src, ring.group)
            kv_pos_host = recv_into(torch.empty_like(kv_pos_host), src,
                                    ring.group)
            for p in pending:
                p.wait()
            note_ring_hop(hop_s + time.monotonic() - t0)
    m, l, o = state
    return _finalize(l.reshape(b, h, t), o.reshape(b, h, t, d), q.dtype)


def ulysses_attention(q, k, v, q_pos, kv_valid, cfg: ModelConfig,
                      ring: Optional[SeqRing] = None,
                      block: int = KEY_BLOCK) -> torch.Tensor:
    """All-to-all sequence parallelism on this rank of `ring`: swap
    sequence for heads so each rank attends over the FULL sequence with
    H/n heads (three all-to-alls and a position all-gather in, one
    all-to-all out, instead of n-1 hops). Needs num_heads % n == 0; when
    the kv heads do not divide n, they are GQA-expanded first (more bytes
    on the wire - the topology tradeoff against ring_attention)."""
    from .distributed import all_gather_cat, all_to_all_cat
    n = ring.size if ring is not None else 1
    if cfg.num_heads % n != 0:
        raise ValueError(f"Ulysses needs heads ({cfg.num_heads}) % n ({n}) "
                         f"== 0")
    if k.shape[2] % n != 0:
        k = _gqa_expand(k, cfg.kv_repeat)
        v = _gqa_expand(v, cfg.kv_repeat)
    if n == 1:
        return blockwise_sdpa(q, k, v, q_pos, q_pos, kv_valid, cfg, block)
    # [B,Tl,H,D] -> [B,T,H/n,D]: split heads, concat sequence.
    q_g, k_g, v_g = (all_to_all_cat(x, 2, 1, ring.group) for x in (q, k, v))
    pos_g = all_gather_cat(q_pos, ring.group, dim=1)          # [B,T]
    out = blockwise_sdpa(q_g, k_g, v_g, pos_g, pos_g, kv_valid, cfg, block)
    # [B,T,H/n,D] -> [B,Tl,H,D]
    return all_to_all_cat(out, 1, 2, ring.group)


def _embed_shard(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 ring: SeqRing, tl: int, mesh) -> torch.Tensor:
    """The scaled embedding rows of this rank's shard of `tokens` [B, T].
    A vocab-sharded table (a model axis that divides the vocab) is looked
    up by every rank of a model group for the shards of the whole group,
    each inside its slice of the vocab, and summed over the group in the
    rows' dtype (exact: one rank contributes each row)."""
    emb = params["embedding"]
    i = ring.index
    if mesh is None or not mesh.splits(cfg.vocab_size):
        return scale_embeddings(
            embed_tokens(emb, tokens[:, i * tl:(i + 1) * tl]), cfg)
    from .distributed import all_reduce_sum
    j, m = mesh.model_index, mesh.model
    first = i - j                      # the group's first shard
    group_tokens = tokens[:, first * tl:(first + m) * tl]
    n = mesh.local(cfg.vocab_size)
    local = group_tokens - j * n
    inside = (local >= 0) & (local < n)
    rows = embed_tokens(emb, torch.where(inside, local, 0))
    part = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))
    part = all_reduce_sum(part.contiguous(), mesh.model_group)
    return scale_embeddings(part[:, j * tl:(j + 1) * tl], cfg)


def make_ring_prefill(cfg: ModelConfig, ring: Optional[SeqRing] = None,
                      scheme: str = "ring", mesh=None,
                      block: int = KEY_BLOCK) -> Callable:
    """The sequence-parallel prefill on this rank of `ring` (width 1
    without one), `scheme` "ulysses" or the ring. `mesh`: this rank's
    model axis (a sharding.Mesh with data 1, as the engine's forward sees
    it; None without one), whose shards the weights are.

    Returns fn(params, tokens [B,Tp], positions [B,Tp], lengths [B],
    on_kv=None) -> (last-token logits f32 [B,V], [(k, v)] per layer, each
    [B,Tp,K,D]), every argument whole on every rank. Tp must divide by
    the ring width; pad with any token id and let `lengths` mask the tail.
    With `on_kv`, each layer's (k, v) goes to on_kv(layer, k, v) as soon
    as it is gathered, and the returned list is empty."""
    from .distributed import all_gather_cat, all_reduce_sum
    from .sharding import gather_layer
    ring = ring or SeqRing()

    def prefill(params: Params, tokens: torch.Tensor,
                positions: torch.Tensor, lengths: torch.Tensor,
                on_kv: Optional[Callable] = None):
        n = ring.size
        tp = tokens.shape[1]
        if tp % n:
            raise ValueError(f"ring prefill length {tp} does not divide over "
                             f"{n} ranks (pad_to_ring)")
        tl = tp // n
        # follows the param dtype; embed_tokens and the _matmul seam take
        # int8 and int4 leaves, so quantization composes with the ring
        x = _embed_shard(params, cfg, tokens, ring, tl, mesh)
        q_pos = positions[:, ring.index * tl:(ring.index + 1) * tl]
        tabs = rope_tables(q_pos, cfg.head_dim, cfg.rope_theta)

        def attn_fn(h, layer):
            q, k, v = project_qkv(h, layer, cfg, q_pos, tabs)
            if scheme == "ulysses":
                core = ulysses_attention(q, k, v, q_pos, lengths, cfg, ring,
                                         block)
            else:
                core = ring_attention(q, k, v, q_pos, q_pos, lengths, cfg,
                                      ring, block)
            return _o_proj(core, layer, cfg, h.dtype), (k, v)

        caches = []
        for li, layer in enumerate(params["layers"]):
            whole = gather_layer(layer, cfg, mesh)
            x, (k, v) = transformer_block(x, whole, cfg, q_pos, None, None,
                                          None, attn_fn=attn_fn)
            del whole
            if n > 1:
                k = all_gather_cat(k, ring.group, dim=1)
                v = all_gather_cat(v, ring.group, dim=1)
            if on_kv is not None:
                on_kv(li, k, v)
            else:
                caches.append((k, v))
            del k, v
        x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                     cfg.rmsnorm_unit_offset)
        hit = (q_pos == (lengths - 1)[:, None]).float()
        last_h = torch.einsum("bt,bte->be", hit, x.float())
        if n > 1:
            last_h = all_reduce_sum(last_h, ring.group)
        logits = lm_head(params, cfg, last_h[:, None, :], mesh)[:, 0]
        return logits, caches

    return prefill


def pad_to_ring(lengths_max: int, n_seq: int, cache_len: int) -> int:
    """Bucketed padded length for ring prefill: next power-of-two multiple
    of n_seq >= lengths_max (bounded shapes as prompts grow), capped at the
    largest n_seq-multiple that fits the cache. Returns 0 when the prompt
    cannot fit - the caller takes the chunked prefill (the JAX package's
    rule)."""
    cap = (cache_len // n_seq) * n_seq
    if lengths_max > cap:
        return 0
    tp = n_seq
    while tp < lengths_max:
        tp *= 2
    return min(tp, cap)


__all__ = [
    "SeqRing",
    "build_seq_mesh",
    "ring_attention",
    "ulysses_attention",
    "blockwise_sdpa",
    "make_ring_prefill",
    "pad_to_ring",
]
