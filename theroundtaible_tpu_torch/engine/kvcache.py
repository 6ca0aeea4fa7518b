"""Per-knight slot bookkeeping and cross-knight prefix sharing
(counterpart of theroundtaible_tpu/engine/kvcache.py).

Each knight owns a slot whose cache holds the token ids already baked into
it; the next turn prefills only the delta beyond the longest common token
prefix. Two caches serve slots: the contiguous KVCache below (the JAX
engine's default layout: per layer [num_slots, max_seq_len, K, D],
position-aligned, cache index s holds position s) and the paged pool
(paging.PagedKVCache).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from .device import resolve_device
from .models.common import ModelConfig

# Session-namespaced slot names: the ASCII unit separator, which no
# tokenizer/config surface produces, so a scoped name can never collide
# with a legal knight name.
SESSION_SEP = "\x1f"


def scoped_slot(session: Optional[str], name: str) -> str:
    """The canonical session-namespaced slot name `session<US>name`;
    None/"" session returns the bare name."""
    return f"{session}{SESSION_SEP}{name}" if session else name


def session_of(name: str) -> str:
    """The session namespace of a (possibly scoped) slot name; "" for
    un-scoped names. Prefix donation stays within one session."""
    return name.split(SESSION_SEP, 1)[0] if SESSION_SEP in name else ""


def lcp(a: list[int], b: list[int]) -> int:
    """Longest common prefix of two token-id sequences."""
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


@dataclass
class SlotState:
    """Host-side bookkeeping for one knight's slot."""

    slot_id: int
    name: str
    tokens: list[int] = field(default_factory=list)  # ids baked into cache


class SlotBook:
    """Slot-id bookkeeping alone - LRU allocation, LCP reuse planning,
    donor search - for caches addressed by slot id."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self._slots: dict[str, SlotState] = {}
        self._free = list(range(num_slots))

    def acquire(self, name: str, pinned: tuple[str, ...] = ()) -> SlotState:
        """The named knight's slot, allocated on first use. `pinned` names
        are never evicted, so two rows of one batch cannot share a slot."""
        if name in self._slots:
            self._slots[name] = self._slots.pop(name)  # LRU refresh
            return self._slots[name]
        if not self._free:
            victim = next((n for n in self._slots if n not in pinned), None)
            if victim is None:
                raise RuntimeError(
                    f"KVCache has {self.num_slots} slots but "
                    f"{len(pinned)} knights are pinned in one batch - "
                    "raise num_slots in the adapter config")
            self.release(victim)
        state = SlotState(slot_id=self._free.pop(0), name=name)
        self._slots[name] = state
        return state

    def release(self, name: str) -> None:
        state = self._slots.pop(name, None)
        if state is not None:
            self._free.append(state.slot_id)

    def reset_slot(self, name: str) -> None:
        """Forget cached tokens (cache rows need no zeroing: the
        valid-length mask makes stale entries unreachable)."""
        if name in self._slots:
            self._slots[name].tokens = []

    def forget_all(self) -> None:
        """Drop every slot record: every later prefill starts from
        scratch."""
        self._slots.clear()
        self._free = list(range(self.num_slots))

    def flush(self) -> int:
        """Release every slot through the normal release path. Returns how
        many slots were flushed."""
        names = list(self._slots)
        for name in names:
            self.release(name)
        return len(names)

    def scratch_slot(self, pinned: tuple[str, ...] = ()) -> Optional[int]:
        """A slot id safe to use as a throwaway write target - the
        scheduler's bucketed decode batch points its masked pad rows here
        (all pads write identical bytes at one position, so the
        duplicate-index write is deterministic; a free slot's stale cells
        are unreachable behind valid-length masks and the next real
        acquire prefills over them). Returns a free slot's id, evicting
        the LRU unpinned slot first when none is free; the id is NOT
        allocated, so use it within the current dispatch only. None when
        every slot is pinned."""
        if not self._free:
            victim = next((n for n in self._slots if n not in pinned),
                          None)
            if victim is None:
                return None
            self.release(victim)
        return self._free[0]

    def slot_names(self) -> list[str]:
        return list(self._slots)

    def memory_ledger(self) -> dict:
        """Slot-occupancy accounting: a contiguous layout pays memory per
        slot whether used or not, so `cached_tokens` against capacity is
        the waste number."""
        in_use = len(self._slots)
        return {
            "layout": "contiguous",
            "slots_in_use": in_use,
            "num_slots": self.num_slots,
            "slot_occupancy": round(in_use / max(self.num_slots, 1), 3),
            "cached_tokens": sum(len(s.tokens)
                                 for s in self._slots.values()),
            "hbm_bytes": None,  # SlotBook owns no buffers
        }

    @staticmethod
    def common_prefix_len(cached: list[int], new: list[int]) -> int:
        return lcp(cached, new)

    def reuse_plan(self, name: str, tokens: list[int],
                   pinned: tuple[str, ...] = ()) -> tuple[int, int]:
        """(slot_id, reuse_len), reuse_len capped at len(tokens)-1; the
        record is truncated now so a turn dying mid-flight never claims
        clobbered positions."""
        state = self.acquire(name, pinned)
        reuse = min(self.common_prefix_len(state.tokens, tokens),
                    len(tokens) - 1)
        state.tokens = state.tokens[:reuse]
        return state.slot_id, reuse

    def commit(self, name: str, tokens: list[int]) -> None:
        self.acquire(name).tokens = list(tokens)

    def best_donor(self, name: str,
                   tokens: list[int]) -> tuple[Optional[SlotState], int]:
        """The OTHER slot of the same session sharing the longest committed
        token prefix with `tokens`."""
        best, best_len = None, 0
        scope = session_of(name)
        for state in self._slots.values():
            if state.name == name or not state.tokens:
                continue
            if session_of(state.name) != scope:
                continue
            n = self.common_prefix_len(state.tokens, tokens)
            if n > best_len:
                best, best_len = state, n
        return best, best_len


def share_prefixes(kv, names, all_tokens, offsets, *, min_shared: int,
                   add_share, flush_shares, prefill_span,
                   extra_pinned: tuple[str, ...] = (),
                   defer_span=None,
                   donor_ok=None) -> tuple[list[int], int]:
    """Two-pass cross-knight shared-prefix reuse:

    (a) donor pass - a slot committed by an earlier call that shares a
        longer token prefix than a row's own history donates its span;
    (b) leader pass - within one batch, the row with the most cache
        coverage prefills the batch-wide common span ONCE and the
        laggards take it.

    Callbacks own the device mechanics: add_share(donor_state, row_i, lo,
    hi) shares one span (paged: page aliasing); flush_shares() applies
    queued shares; prefill_span(row_i, lo, hi) prefills a row's span.
    `extra_pinned`: slot names outside this batch that survive any
    eviction the passes trigger (the scheduler's live rows).

    `defer_span(m, lo, hi, followers)` (the scheduler's ragged admission):
    when given and the leader's cache does not cover the common span yet,
    the leader pass dispatches nothing. The leader's offset stays at its
    own coverage (its span joins the live decode segment as ragged
    chunks), the laggards' offsets still rise to the span end, and the
    callback records (leader index, leader coverage, span end,
    [(laggard, its pre-raise coverage), ...]) so the caller aliases the
    laggards once the leader's chunks have written the span. A leader that
    already covers the span aliases at once.

    `donor_ok(donor_state, row_i)`: an extra donor gate - LoRA engines
    pass an adapter-identity check, since K/V computed under one adapter
    is wrong under another. A rejected best donor is dropped, not
    searched past. The leader pass needs no gate: LoRA engines reach it
    only with uniform-adapter batches (mixed ones skip sharing).
    Returns (updated offsets, leader-prefilled token count)."""
    b = len(names)
    pinned = tuple(names) + tuple(extra_pinned)
    offsets = list(offsets)
    extra_prefill = 0

    for i in range(b):
        cap = len(all_tokens[i]) - 1
        donor, dlen = kv.best_donor(names[i], all_tokens[i])
        dlen = min(dlen, cap)
        if donor is not None and donor_ok is not None \
                and not donor_ok(donor, i):
            donor = None
        if donor is not None and dlen - offsets[i] >= min_shared:
            add_share(donor, i, offsets[i], dlen)
            offsets[i] = dlen
    flush_shares()

    if b < 2:
        return offsets, extra_prefill
    shared = all_tokens[0]
    for t in all_tokens[1:]:
        shared = shared[:kv.common_prefix_len(shared, t)]
    l_shared = min(len(shared), min(len(t) for t in all_tokens) - 1)
    m = max(range(b), key=lambda i: offsets[i])
    laggards = [i for i in range(b)
                if i != m and l_shared - offsets[i] >= min_shared]
    if not laggards:
        return offsets, extra_prefill
    if offsets[m] < l_shared:
        if defer_span is not None:
            defer_span(m, offsets[m], l_shared,
                       [(i, offsets[i]) for i in laggards])
            for i in laggards:
                offsets[i] = l_shared
            return offsets, extra_prefill
        prefill_span(m, offsets[m], l_shared)
        extra_prefill += l_shared - offsets[m]
        offsets[m] = l_shared
    leader = kv.acquire(names[m], pinned)
    for i in laggards:
        add_share(leader, i, offsets[i], l_shared)
        offsets[i] = l_shared
    flush_shares()
    return offsets, extra_prefill


class KVCache(SlotBook):
    """num_slots x num_layers of contiguous device KV plus SlotBook's
    bookkeeping. Layout per layer: [num_slots, max_seq_len, K, D], zeros
    at construction. Serving writes it in place (models/common
    forward_cached) and the kernels read slots through their row map, so
    no slot is ever gathered or copied whole. On the card unless the
    caller passes device="cpu"."""

    def __init__(self, cfg: ModelConfig, num_slots: int,
                 max_seq_len: Optional[int] = None, dtype=torch.bfloat16,
                 device="cuda"):
        device = resolve_device(device)
        super().__init__(num_slots)
        self.cfg = cfg
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        shape = (num_slots, self.max_seq_len, cfg.num_kv_heads, cfg.head_dim)
        self.layers: list[tuple[torch.Tensor, torch.Tensor]] = [
            (torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.num_layers)]

    def hbm_bytes(self) -> int:
        """Device bytes of every layer's K and V cache."""
        k, _ = self.layers[0]
        return 2 * k.numel() * k.element_size() * len(self.layers)

    def memory_ledger(self) -> dict:
        led = super().memory_ledger()
        led["hbm_bytes"] = self.hbm_bytes()
        return led
