"""Paged KV cache - page-pool allocation with copy-on-write sharing
(counterpart of theroundtaible_tpu/engine/paging.py, single replica).

Each layer owns a page pool `[num_pages, page_size, K, D]` (a torch tensor
on the engine's device) and each slot maps its logical positions onto pool
pages through a page table:

- Memory scales with tokens cached, not slots x max_seq_len.
- Pages are position-aligned (page j of a slot covers positions
  [j*page_size, (j+1)*page_size)), so two slots whose token prefixes agree
  ALIAS the same pages: shared-prefix reuse is a refcount bump; only the
  boundary page where prompts diverge is copied (copy-on-write).
- Page 0 is a reserved scratch page: table rows are padded with it and
  batch rows scatter their unused tail there. It is never aliased and
  never read (valid-length masks bound every attention read).

The host bookkeeping is the JAX package's, unchanged; the pools are
updated in place where the JAX package donates buffers (the page copies
here, the K/V scatter in paged_forward). The per-replica page ranges of a
data-sharded pool and the cross-session prefix-cache hooks are not ported.

Quantized pages (`kv_quant`, a kv_quant.KVQuantSpec): each layer's pools
hold an int8 payload [P, page_size, K, Dp] beside f32 scale pools
[P, page_size, K, G] (`scales`), indexed by the same page axis, so every
sharing mechanism (alias, copy-on-write, adopt) moves a page's scales with
it. The default pool keeps the unquantized default's byte budget, so the
saved bytes become more pages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .kv_quant import KVQuantSpec, page_ratio
from .device import resolve_device
from .kvcache import lcp, session_of
from .models.common import ModelConfig

SCRATCH_PAGE = 0


@dataclass
class PagedSlot:
    """Host-side bookkeeping for one knight's slot."""

    name: str
    tokens: list[int] = field(default_factory=list)  # ids baked into cache
    pages: list[int] = field(default_factory=list)   # logical order


class PagedKVCache:
    """Page-pool KV cache keyed by slot name, on the card unless the
    caller passes device="cpu"."""

    def __init__(self, cfg: ModelConfig, num_slots: int,
                 max_seq_len: Optional[int] = None, dtype=torch.bfloat16,
                 device="cuda", page_size: int = 128,
                 num_pages: Optional[int] = None,
                 kv_quant: Optional[KVQuantSpec] = None):
        device = resolve_device(device)
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        if self.max_seq_len % page_size:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} must be a multiple of "
                f"page_size {page_size}")
        self.page_size = page_size
        self.pages_per_seq = self.max_seq_len // page_size
        self.kv_quant = kv_quant
        self._kv_dtype_bytes = torch.empty((), dtype=dtype).element_size()
        # Default pool: HALF the contiguous budget, plus the scratch page; a
        # quantized pool keeps those bytes and so holds more pages.
        if num_pages is None:
            num_pages = max(num_slots * self.pages_per_seq // 2,
                            self.pages_per_seq)
            if kv_quant is not None:
                num_pages = int(num_pages * page_ratio(
                    kv_quant, cfg.head_dim, self._kv_dtype_bytes))
            num_pages += 1
        self.num_pages = num_pages
        if num_pages < self.pages_per_seq + 1:
            raise ValueError(
                f"num_pages {num_pages} cannot hold even one full sequence "
                f"({self.pages_per_seq} pages + scratch)")
        head = (num_pages, page_size, cfg.num_kv_heads)

        def zeros(width, dt):
            # Zeroed like jnp.zeros: stale cells past a row's frontier are
            # never read, but a fresh pool holds no NaN either way.
            return (torch.zeros(head + (width,), dtype=dt, device=device),
                    torch.zeros(head + (width,), dtype=dt, device=device))

        self.scales: Optional[list[tuple[torch.Tensor, torch.Tensor]]] = None
        if kv_quant is None:
            self.pools: list[tuple[torch.Tensor, torch.Tensor]] = [
                zeros(cfg.head_dim, dtype) for _ in range(cfg.num_layers)]
        else:
            self.pools = [zeros(kv_quant.packed_dim(cfg.head_dim), torch.int8)
                          for _ in range(cfg.num_layers)]
            self.scales = [zeros(kv_quant.num_groups(cfg.head_dim),
                                 torch.float32)
                           for _ in range(cfg.num_layers)]
        self._slots: dict[str, PagedSlot] = {}
        self._free: list[int] = list(range(1, num_pages))
        self._refs: dict[int, int] = {}

    # --- introspection / accounting ---

    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def usable_pages(self) -> int:
        """Total non-scratch pages."""
        return self.num_pages - 1

    def pages_held(self, names: list[str]) -> int:
        """Pages currently mapped by the named slots (missing names count
        0): the scheduler's admission backpressure counts what its live
        rows pin; the rest is reclaimable by LRU eviction."""
        return sum(len(self._slots[n].pages)
                   for n in names if n in self._slots)

    def hbm_bytes(self) -> int:
        """Resident pool bytes across all layers - payload plus, on
        quantized pools, the scale pools."""
        total = 0
        for k, v in list(self.pools) + list(self.scales or []):
            total += (k.numel() * k.element_size()
                      + v.numel() * v.element_size())
        return total

    def hbm_bytes_logical(self) -> int:
        """What the same pools would cost unquantized (hbm_bytes on an
        unquantized pool)."""
        if self.kv_quant is None:
            return self.hbm_bytes()
        return (2 * self.num_pages * self.page_size * self.cfg.num_kv_heads
                * self.cfg.head_dim * self._kv_dtype_bytes * len(self.pools))

    def _run_page_copy(self, src_ids: list[int], dst_ids: list[int]) -> None:
        """Whole-page device copies, in place in every layer's pools and
        scale pools: a copied page never leaves its scales behind."""
        dev = self.pools[0][0].device
        src = torch.tensor(src_ids, dtype=torch.long, device=dev)
        dst = torch.tensor(dst_ids, dtype=torch.long, device=dev)
        for k, v in list(self.pools) + list(self.scales or []):
            k.index_copy_(0, dst, k.index_select(0, src))
            v.index_copy_(0, dst, v.index_select(0, src))

    def slot_names(self) -> list[str]:
        return list(self._slots)

    # --- slot lifecycle ---

    def acquire(self, name: str, pinned: tuple[str, ...] = ()) -> PagedSlot:
        if name in self._slots:
            self._slots[name] = self._slots.pop(name)  # LRU refresh
            return self._slots[name]
        if len(self._slots) >= self.num_slots:
            victim = next((n for n in self._slots if n not in pinned), None)
            if victim is None:
                raise RuntimeError(
                    f"PagedKVCache has {self.num_slots} slots but "
                    f"{len(pinned)} knights are pinned in one batch - "
                    "raise num_slots in the adapter config")
            self.release(victim)
        state = PagedSlot(name=name)
        self._slots[name] = state
        return state

    def release(self, name: str) -> None:
        state = self._slots.pop(name, None)
        if state is not None:
            for p in state.pages:
                self._decref(p)

    def flush(self) -> int:
        """Release every slot; returns how many were flushed."""
        names = list(self._slots)
        for name in names:
            self.release(name)
        return len(names)

    def reset_slot(self, name: str) -> None:
        if name in self._slots:
            state = self._slots[name]
            for p in state.pages:
                self._decref(p)
            state.pages = []
            state.tokens = []

    # --- refcounting ---

    def _decref(self, page: int) -> None:
        n = self._refs.get(page, 1) - 1
        if n <= 0:
            self._refs.pop(page, None)
            self._free.append(page)
        else:
            self._refs[page] = n

    def _incref(self, page: int) -> None:
        self._refs[page] = self._refs.get(page, 1) + 1

    def _shared(self, page: int) -> bool:
        return self._refs.get(page, 1) > 1

    def cow_page(self, name: str, j: int,
                 pinned: tuple[str, ...] = ()) -> int:
        """Copy-on-write: give `name` exclusive ownership of its logical
        page j, device-copying the shared original into a fresh page.
        No-op (returns the existing id) when already exclusive."""
        state = self._slots[name]
        p = state.pages[j]
        if not self._shared(p):
            return p
        pinned = tuple(pinned) + (name,)
        fresh = self._alloc_page(pinned)
        self._decref(p)
        state.pages[j] = fresh
        self._run_page_copy([p], [fresh])
        return fresh

    def _alloc_page(self, pinned_names: tuple[str, ...]) -> int:
        if not self._free:
            # Evict LRU slots (dict order = recency) until a page frees.
            for victim in list(self._slots):
                if victim in pinned_names:
                    continue
                self.release(victim)
                if self._free:
                    break
        if not self._free:
            raise RuntimeError(
                "Page pool exhausted: all pages pinned by the in-flight "
                "batch - raise num_pages (adapter config) or lower "
                "max_new_tokens")
        return self._free.pop(0)

    # --- prefix bookkeeping ---

    @staticmethod
    def common_prefix_len(cached: list[int], new: list[int]) -> int:
        return lcp(cached, new)

    def reuse_plan(self, name: str, tokens: list[int],
                   pinned: tuple[str, ...] = ()) -> tuple[int, int]:
        """(-1, reuse_len): how many leading tokens the slot's pages
        already hold. Paged rows are keyed by table_for(names), never by a
        device slot id (the -1 sentinel fails loudly if used as an index).
        Truncates the record now (crash safety) and drops whole pages
        beyond the reuse frontier. reuse_len is capped at len(tokens)-1 so
        at least one token is fed."""
        state = self.acquire(name, pinned)
        reuse = self.common_prefix_len(state.tokens, tokens)
        reuse = min(reuse, len(tokens) - 1)
        state.tokens = state.tokens[:reuse]
        self._trim_pages(state, reuse)
        return -1, reuse

    def _trim_pages(self, state: PagedSlot, tokens_kept: int) -> None:
        """Free pages wholly beyond ceil(tokens_kept / page_size)."""
        keep = -(-tokens_kept // self.page_size) if tokens_kept else 0
        while len(state.pages) > keep:
            self._decref(state.pages.pop())

    def commit(self, name: str, tokens: list[int]) -> None:
        """Record that the slot's pages now hold exactly `tokens`."""
        state = self.acquire(name)
        state.tokens = list(tokens)
        self._trim_pages(state, len(tokens))

    def best_donor(self, name: str,
                   tokens: list[int]) -> tuple[Optional[PagedSlot], int]:
        """The OTHER slot of the same session sharing the longest committed
        token prefix with `tokens` (donation is intra-session only)."""
        scope = session_of(name)
        best, best_len = None, 0
        for state in self._slots.values():
            if state.name == name or not state.tokens:
                continue
            if session_of(state.name) != scope:
                continue
            n = self.common_prefix_len(state.tokens, tokens)
            if n > best_len:
                best, best_len = state, n
        return best, best_len

    # --- capacity + sharing ---

    def ensure_capacity(self, name: str, upto_tokens: int,
                        write_from: int,
                        pinned: tuple[str, ...] = ()) -> None:
        """Make positions [0, upto_tokens) addressable and positions
        [write_from, upto_tokens) EXCLUSIVELY owned (copy-on-write any
        shared page the upcoming prefill/decode will write)."""
        pinned = tuple(pinned) + (name,)  # never self-evict mid-alloc
        state = self.acquire(name, pinned)
        need = -(-upto_tokens // self.page_size)
        while len(state.pages) < need:
            state.pages.append(self._alloc_page(pinned))
        for j in range(write_from // self.page_size, len(state.pages)):
            if self._shared(state.pages[j]):
                self.cow_page(name, j, pinned)

    def alias_span(self, src_name: str, dst_name: str, lo: int,
                   hi: int, pinned: tuple[str, ...] = ()) -> None:
        """Give dst the K/V for positions [lo, hi) from src: whole pages
        alias (refcount++), the partial boundary pages are device-copied.
        Precondition: src's cache covers [0, hi) and the two token streams
        agree on [0, hi) (guaranteed by LCP-based callers)."""
        # Pin BOTH endpoints: an eviction inside _alloc_page must not
        # release the donor mid-call.
        pinned = tuple(pinned) + (src_name, dst_name)
        src = self.acquire(src_name, pinned)
        dst = self.acquire(dst_name, pinned)
        ps = self.page_size
        lo_page, hi_page = lo // ps, hi // ps
        self._trim_pages(dst, lo)
        if len(dst.pages) < lo_page:
            raise RuntimeError("alias_span: dst does not cover up to lo")
        cow_src, cow_dst = [], []

        def copy_into_dst(j: int) -> None:
            """Give dst its own exclusively-held page j, filled from src's
            page j."""
            if j < len(dst.pages):
                if self._shared(dst.pages[j]):
                    fresh = self._alloc_page(pinned)
                    self._decref(dst.pages[j])
                    dst.pages[j] = fresh
            else:
                dst.pages.append(self._alloc_page(pinned))
            cow_src.append(src.pages[j])
            cow_dst.append(dst.pages[j])

        if lo % ps and lo_page < hi_page:
            # dst's partial boundary page holds dst tokens [lo_page*ps, lo)
            # == src's, so copying src's full page is a superset update.
            copy_into_dst(lo_page)
            lo_page += 1
        for j in range(lo_page, hi_page):
            if j < len(dst.pages):
                self._decref(dst.pages[j])
                dst.pages[j] = src.pages[j]
            else:
                dst.pages.append(src.pages[j])
            self._incref(src.pages[j])
        if hi % ps and hi_page < len(src.pages):
            copy_into_dst(hi_page)
        if cow_src:
            self._run_page_copy(cow_src, cow_dst)

    def adopt_span(self, dst_name: str, src_pages: list[int], lo: int,
                   hi: int, pinned: tuple[str, ...] = ()) -> None:
        """alias_span's slot-free counterpart: give dst the K/V for
        positions [lo, hi) from an explicit page list covering [0, hi) at
        page granularity. Whole pages alias; the partial boundary page at
        lo is device-copied. `hi` must be page-aligned. Every source page
        is guard-ref'd for the duration, so an eviction inside an
        allocation cannot free it under the call."""
        ps = self.page_size
        if hi % ps:
            raise ValueError("adopt_span: hi must be page-aligned")
        pinned = tuple(pinned) + (dst_name,)
        dst = self.acquire(dst_name, pinned)
        lo_page, hi_page = lo // ps, hi // ps
        self._trim_pages(dst, lo)
        if len(dst.pages) < lo_page:
            raise RuntimeError("adopt_span: dst does not cover up to lo")
        guards = {j: src_pages[j] for j in range(lo_page, hi_page)}
        for p in guards.values():
            self._incref(p)
        transferred: set[int] = set()
        try:
            if lo % ps and lo_page < hi_page:
                if lo_page < len(dst.pages):
                    if self._shared(dst.pages[lo_page]):
                        fresh = self._alloc_page(pinned)
                        self._decref(dst.pages[lo_page])
                        dst.pages[lo_page] = fresh
                else:
                    dst.pages.append(self._alloc_page(pinned))
                self._run_page_copy([src_pages[lo_page]],
                                    [dst.pages[lo_page]])
                lo_page += 1
            for j in range(lo_page, hi_page):
                if j < len(dst.pages):
                    self._decref(dst.pages[j])
                    dst.pages[j] = src_pages[j]
                else:
                    dst.pages.append(src_pages[j])
                # The guard ref becomes dst's mapping reference.
                transferred.add(j)
        finally:
            for j, p in guards.items():
                if j not in transferred:
                    self._decref(p)

    # --- device tables ---

    def table_for(self, names: list[str]) -> np.ndarray:
        """[B, pages_per_seq] int32 page table padded with the scratch
        page."""
        table = np.full((len(names), self.pages_per_seq), SCRATCH_PAGE,
                        np.int32)
        for i, name in enumerate(names):
            pages = self._slots[name].pages
            table[i, :len(pages)] = pages
        return table
