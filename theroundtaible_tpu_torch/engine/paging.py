"""Paged KV cache - page-pool allocation with copy-on-write sharing
(counterpart of theroundtaible_tpu/engine/paging.py).

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
here, the K/V scatter in paged_forward).

Data-axis replicas (a mesh with a "data" axis, JAX paging.py:140-230): the
page axis is split into one range per data replica, each with its own
scratch page (the range's first page), and every slot is pinned to one
replica at acquire. Each data rank's pools hold only its replica's range,
[num_pages / data, page_size, K, D] per layer (page ids stay global in
the bookkeeping, which every rank keeps alike in lockstep; the device
side subtracts the range's first page). Cross-replica prefix shares
become whole-page copies (an aliased page cannot live on two replicas):
a copy from another replica's range travels over the data group, a
broadcast that every rank enters in the same order.

Sharing surface: the cross-session prefix cache (engine/prefix_cache.py)
and the host-RAM offload tier (engine/kv_offload.py) hold page references
of their own (`ref`/`unref`), so a page shared by several sessions and the
index is stored once and frees only when its last holder lets go. The
pool's couplings to the index: commit() publishes complete pages into it,
_alloc_page reclaims its refcount-0 pages before evicting a slot, flush()
drops it, and the write paths forget an index-only share instead of
copying it.

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
    replica: int = 0  # data-axis replica owning every page of this slot


class PagedKVCache:
    """Page-pool KV cache keyed by slot name, on the card unless the
    caller passes device="cpu"."""

    def __init__(self, cfg: ModelConfig, num_slots: int,
                 max_seq_len: Optional[int] = None, dtype=torch.bfloat16,
                 device="cuda", page_size: int = 128,
                 num_pages: Optional[int] = None,
                 kv_quant: Optional[KVQuantSpec] = None, mesh=None):
        device = resolve_device(device)
        # The data replicas of a mesh's page axis, and the one this rank
        # holds (one replica without a data axis).
        self.mesh = mesh
        self.data_size = mesh.data if mesh is not None else 1
        self.data_index = mesh.data_index if mesh is not None else 0
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
        # Default pool: HALF the contiguous budget, plus one scratch page
        # per data replica; a quantized pool keeps those bytes and so holds
        # more pages. The total is across replicas (each rank holds its
        # range), rounded up so the data axis divides it.
        if num_pages is None:
            num_pages = max(num_slots * self.pages_per_seq // 2,
                            self.data_size * self.pages_per_seq)
            if kv_quant is not None:
                num_pages = int(num_pages * page_ratio(
                    kv_quant, cfg.head_dim, self._kv_dtype_bytes))
            num_pages += self.data_size
        self.num_pages = -(-num_pages // self.data_size) * self.data_size
        per_replica = self.num_pages // self.data_size
        if per_replica < self.pages_per_seq + 1:
            raise ValueError(
                f"num_pages {self.num_pages} over {self.data_size} "
                f"replica(s) cannot hold even one full sequence per "
                f"replica ({self.pages_per_seq} pages + scratch)")
        # This rank's pools hold its replica's range only.
        head = (per_replica if self.data_size > 1 else self.num_pages,
                page_size, cfg.num_kv_heads)

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
        # Replica r owns pages [r * per, (r + 1) * per); the range's first
        # page is that replica's scratch (never allocated, never aliased).
        self._per_replica = per_replica
        self._scratch = [r * per_replica for r in range(self.data_size)]
        self._free_by_replica: list[list[int]] = [
            list(range(r * per_replica + 1, (r + 1) * per_replica))
            for r in range(self.data_size)]
        self._refs: dict[int, int] = {}
        # Pages copied from one replica's range into another's (the
        # cross-replica shares: prefix-cache attaches and same-session
        # spans whose donor sits on another replica).
        self.cross_replica_copies = 0
        # The cross-session prefix cache, attached by the engine after
        # construction (None: cache off).
        self.prefix_cache = None

    # --- introspection / accounting ---

    def pages_in_use(self) -> int:
        free = sum(len(f) for f in self._free_by_replica)
        return self.num_pages - self.data_size - free

    def free_pages(self, replica: Optional[int] = None) -> int:
        """Immediately allocatable pages (one replica's range, or all).
        Excludes everything reclaimable under pressure (idle evictable
        slots, refcount-0 prefix-cache nodes): the scheduler's spill
        policy keys off this to spill idle sessions before the allocator
        destroys their caches."""
        if replica is not None:
            return len(self._free_by_replica[replica])
        return sum(len(f) for f in self._free_by_replica)

    def usable_pages(self) -> int:
        """Total non-scratch pages across every replica range."""
        return self.num_pages - self.data_size

    def pages_held(self, names: list[str]) -> int:
        """Pages currently mapped by the named slots (missing names count
        0): the scheduler's admission backpressure counts what its live
        rows pin; the rest is reclaimable by LRU eviction."""
        return sum(len(self._slots[n].pages)
                   for n in names if n in self._slots)

    def hbm_bytes(self) -> int:
        """Resident pool bytes across all layers - payload plus, on
        quantized pools, the scale pools - of this rank's pools (its
        replica's range and kv heads under a mesh)."""
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
        return (2 * self.pools[0][0].shape[0] * self.page_size
                * self.cfg.num_kv_heads * self.cfg.head_dim
                * self._kv_dtype_bytes * len(self.pools))

    def combined_pools(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Every layer's (k, v) pools, then on a quantized pool every
        layer's scale pools: the whole state of a page, in the order the
        offload tier spills and restores it."""
        return list(self.pools) + list(self.scales or [])

    def _run_page_copy(self, src_ids: list[int], dst_ids: list[int]) -> None:
        """Whole-page device copies, in place in every layer's pools and
        scale pools: a copied page never leaves its scales behind. On data
        replicas each rank copies the pairs whose destination is in its
        range; a source in another replica's range arrives over the data
        group, one broadcast per source replica, in replica order, which
        every rank enters (the bookkeeping is the same on every rank)."""
        if self.data_size == 1:
            self._copy_local(src_ids, dst_ids)
            return
        me = self.data_index
        local = [(s, d) for s, d in zip(src_ids, dst_ids)
                 if self.replica_of_page(s) == self.replica_of_page(d) == me]
        if local:
            self._copy_local([s for s, _ in local], [d for _, d in local])
        cross = [(s, d) for s, d in zip(src_ids, dst_ids)
                 if self.replica_of_page(s) != self.replica_of_page(d)]
        self.cross_replica_copies += len(cross)
        for r in range(self.data_size):
            pairs = [(s, d) for s, d in cross if self.replica_of_page(s) == r]
            if pairs:
                self._copy_from_replica(r, pairs)

    def holds_page(self, page: int) -> bool:
        """Whether this rank's pools hold `page` (its replica's range)."""
        return (self.data_size == 1
                or self.replica_of_page(page) == self.data_index)

    def local_page(self, page: int) -> int:
        """`page`'s index in this rank's pools (its replica's range)."""
        return page - self.data_index * self._per_replica \
            if self.data_size > 1 else page

    def _copy_local(self, src_ids: list[int], dst_ids: list[int]) -> None:
        dev = self.pools[0][0].device
        src = torch.tensor([self.local_page(p) for p in src_ids],
                           dtype=torch.long, device=dev)
        dst = torch.tensor([self.local_page(p) for p in dst_ids],
                           dtype=torch.long, device=dev)
        for k, v in self.combined_pools():
            k.index_copy_(0, dst, k.index_select(0, src))
            v.index_copy_(0, dst, v.index_select(0, src))

    def _copy_from_replica(self, r: int,
                           pairs: list[tuple[int, int]]) -> None:
        """Pages of replica r's range into pages of other ranges: rank r
        packs the sources of every layer, the data group receives them,
        and each destination's rank writes its own."""
        from .distributed import broadcast_from
        dev = self.pools[0][0].device
        mine = self.data_index == r
        src = torch.tensor([self.local_page(s) if mine else 0
                            for s, _ in pairs], dtype=torch.long, device=dev)
        for group in (self.pools, self.scales or []):
            if not group:
                continue
            k0 = group[0][0]
            shape = (len(group), 2, len(pairs)) + tuple(k0.shape[1:])
            if mine:
                buf = torch.stack([torch.stack((k.index_select(0, src),
                                                v.index_select(0, src)))
                                   for k, v in group])
            else:
                buf = torch.empty(shape, dtype=k0.dtype, device=dev)
            buf = broadcast_from(buf, r * self.mesh.model
                                 + self.mesh.model_index,
                                 self.mesh.data_group)
            keep = [i for i, (_s, d) in enumerate(pairs)
                    if self.replica_of_page(d) == self.data_index]
            if not keep:
                continue
            rows = torch.tensor(keep, dtype=torch.long, device=dev)
            dst = torch.tensor([self.local_page(pairs[i][1]) for i in keep],
                               dtype=torch.long, device=dev)
            for li, (k, v) in enumerate(group):
                k.index_copy_(0, dst, buf[li, 0].index_select(0, rows))
                v.index_copy_(0, dst, buf[li, 1].index_select(0, rows))

    def slot_names(self) -> list[str]:
        return list(self._slots)

    def memory_ledger(self) -> dict:
        """Paged-pool accounting: pages in use / usable, slot occupancy,
        and fragmentation - the share of held page cells backing no cached
        token, over distinct pages with each page's covered cells taken
        once (the most any slot mapping it covers), so a page shared by N
        sessions never counts N times. "Shared" pages have two or more slot
        mappings or a holder besides the slots and the index (the offload
        tier); the index's own reference is not sharing."""
        in_use = self.pages_in_use()
        usable = self.usable_pages()
        cached_tokens = sum(len(s.tokens) for s in self._slots.values())
        ps = self.page_size
        covered: dict[int, int] = {}
        map_counts: dict[int, int] = {}
        for s in self._slots.values():
            for j, p in enumerate(s.pages):
                map_counts[p] = map_counts.get(p, 0) + 1
                cov = max(0, min(len(s.tokens) - j * ps, ps))
                if cov > covered.get(p, -1):
                    covered[p] = cov
        held_cells = len(covered) * ps
        frag = (round(1.0 - min(sum(covered.values()) / held_cells, 1.0),
                      3) if held_cells else 0.0)
        pc = self.prefix_cache

        def _is_shared(p: int) -> bool:
            if map_counts.get(p, 0) >= 2:
                return True
            extra = self._refs.get(p, 1) - map_counts.get(p, 0)
            if pc is not None and pc.holds_page(p):
                extra -= 1
            return extra >= 1

        shared = sum(1 for p in covered if _is_shared(p))
        n_slots = len(self._slots)
        resident = self.hbm_bytes()
        logical = self.hbm_bytes_logical()
        return {
            "layout": "paged",
            "kv_dtype": (self.kv_quant.dtype_name
                         if self.kv_quant is not None else "bf16"),
            "kv_quant_bits": (self.kv_quant.bits
                              if self.kv_quant is not None else 0),
            "kv_bytes_resident": resident,
            "kv_bytes_logical": logical,
            "kv_quant_bytes_saved": max(logical - resident, 0),
            "slots_in_use": n_slots,
            "num_slots": self.num_slots,
            "slot_occupancy": round(n_slots / max(self.num_slots, 1), 3),
            "cached_tokens": cached_tokens,
            "pages_in_use": in_use,
            "usable_pages": usable,
            "page_utilization": round(in_use / max(usable, 1), 3),
            "fragmentation": frag,
            "shared_pages": shared,
            "exclusive_pages": len(covered) - shared,
            "prefix_cache_pages": pc.page_count() if pc is not None else 0,
            "hbm_bytes": resident,
        }

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
        # Pin the new slot to the replica hosting the fewest slots, free
        # pages breaking ties (JAX paging.py:415-426): deterministic, so
        # every rank pins alike.
        counts = [0] * self.data_size
        for st in self._slots.values():
            counts[st.replica] += 1
        replica = min(range(self.data_size),
                      key=lambda r: (counts[r],
                                     -len(self._free_by_replica[r]), r))
        state = PagedSlot(name=name, replica=replica)
        self._slots[name] = state
        return state

    def release(self, name: str) -> None:
        state = self._slots.pop(name, None)
        if state is not None:
            for p in state.pages:
                self._decref(p)

    def flush(self) -> int:
        """Release every slot, and drop the prefix cache's index the same
        way: every holder unrefs, so a page shared between a slot and the
        index frees when the last reference goes. Returns how many slots
        were flushed."""
        names = list(self._slots)
        for name in names:
            self.release(name)
        if self.prefix_cache is not None:
            self.prefix_cache.drop_all()
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
            # A page always frees back to the replica range it belongs to.
            self._free_by_replica[self.replica_of_page(page)].append(page)
        else:
            self._refs[page] = n

    def _incref(self, page: int) -> None:
        self._refs[page] = self._refs.get(page, 1) + 1

    def _shared(self, page: int) -> bool:
        return self._refs.get(page, 1) > 1

    def _index_only_share(self, page: int) -> bool:
        """True when `page`'s only holder besides the mapping slot is the
        prefix-cache index. The write paths then make the page exclusive by
        forgetting the index entry instead of copying on write: the slot's
        divergence invalidates that entry's continuation anyway, and under
        a full pool the copy's allocation may be the page that does not
        exist."""
        return (self.prefix_cache is not None
                and self._refs.get(page, 1) == 2
                and self.prefix_cache.holds_page(page))

    # Public refcount surface: the prefix cache and the offload tier hold
    # references of their own; release/flush decref, never force-free.

    def ref(self, page: int) -> None:
        """Take one reference on `page` (index and offload-tier holders)."""
        self._incref(page)

    def unref(self, page: int) -> None:
        """Drop one reference; the page frees only when the last holder
        lets go."""
        self._decref(page)

    def refcount(self, page: int) -> int:
        """Current holder count (1 = exactly one holder)."""
        return self._refs.get(page, 1)

    def replica_of_page(self, page: int) -> int:
        """The data replica whose range holds `page`."""
        return page // self._per_replica

    def cow_page(self, name: str, j: int,
                 pinned: tuple[str, ...] = ()) -> int:
        """Copy-on-write: give `name` exclusive ownership of its logical
        page j, device-copying the shared original into a fresh page.
        No-op (returns the existing id) when already exclusive."""
        state = self._slots[name]
        p = state.pages[j]
        if not self._shared(p):
            return p
        if self._index_only_share(p):
            self.prefix_cache.forget_page(p)
            return p
        pinned = tuple(pinned) + (name,)
        fresh = self._alloc_page(pinned, state.replica)
        self._decref(p)
        state.pages[j] = fresh
        self._run_page_copy([p], [fresh])
        return fresh

    def _alloc_page(self, pinned_names: tuple[str, ...],
                    replica: int = 0) -> int:
        free = self._free_by_replica[replica]
        cache = self.prefix_cache
        if not free and cache is not None:
            # Cheapest first: pages only the index holds on this replica.
            # Evicting a slot first would free almost nothing with the
            # cache on (its complete pages stay index-held) and destroy its
            # record.
            cache.reclaim(replica=replica)
        if not free:
            # Evict LRU slots (dict order = recency) of this replica until
            # a page frees (a victim elsewhere frees pages this slot cannot
            # use); a released victim's index-held pages drop to refcount
            # 0, so reclaim between victims.
            for victim in list(self._slots):
                if (victim in pinned_names
                        or self._slots[victim].replica != replica):
                    continue
                self.release(victim)
                if not free and cache is not None:
                    cache.reclaim(replica=replica)
                if free:
                    break
        if not free:
            raise RuntimeError(
                f"Page pool exhausted on data replica {replica}: all its "
                "pages pinned by the in-flight batch - raise num_pages "
                "(adapter config) or lower max_new_tokens")
        return free.pop(0)

    # --- raw page loans (tree verify's private path pages) ---

    def take_free_pages(self, n: int,
                        replica: int = 0) -> Optional[list[int]]:
        """Borrow `n` pages from a replica's free list only: never evicts a
        slot, so a borrower that can do without (the tree verify degrades a
        row to chain speculation) cannot destroy resident state to get
        them. None when the free list is short."""
        free = self._free_by_replica[replica]
        if len(free) < n:
            return None
        return [free.pop(0) for _ in range(n)]

    def give_back_pages(self, pages: list[int]) -> None:
        """Return pages taken by take_free_pages (or adopted-and-replaced
        pages): a plain decref, so a page swapped into a slot's table
        meanwhile is not freed under it."""
        for p in pages:
            self._decref(p)

    def swap_in_page(self, name: str, j: int, page: int) -> None:
        """Replace slot `name`'s logical page j with `page`, whose cells
        already hold the position range's K/V (the tree verify's accepted
        path: its private page was copied from the old frontier page in
        the dispatch, then received the accepted tokens' writes). The old
        page decrefs, and the loaned page's reference becomes the slot's
        mapping reference."""
        state = self._slots[name]
        self._decref(state.pages[j])
        state.pages[j] = page

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

    def commit(self, name: str, tokens: list[int],
               index: bool = True) -> None:
        """Record that the slot's pages now hold exactly `tokens`, and
        publish its complete pages into the prefix cache's index. Not with
        `index=False` (a persona row's adapter-tinted K/V, which base rows
        of other sessions must not alias), nor for warmup slots (crafted to
        defeat sharing)."""
        state = self.acquire(name)
        state.tokens = list(tokens)
        self._trim_pages(state, len(tokens))
        if (index and self.prefix_cache is not None
                and not name.startswith("__warmup_")):
            self.prefix_cache.insert(state)

    def best_donor(self, name: str,
                   tokens: list[int]) -> tuple[Optional[PagedSlot], int]:
        """The OTHER slot of the same session sharing the longest committed
        token prefix with `tokens` (donation is intra-session only);
        prefix-length ties prefer a donor on `name`'s replica, whose span
        aliases where another replica's is copied."""
        dst = self._slots.get(name)
        dst_replica = dst.replica if dst is not None else 0
        scope = session_of(name)
        best, best_key = None, (0, -1)
        for state in self._slots.values():
            if state.name == name or not state.tokens:
                continue
            if session_of(state.name) != scope:
                continue
            n = self.common_prefix_len(state.tokens, tokens)
            if n == 0:
                continue
            key = (n, 1 if state.replica == dst_replica else 0)
            if key > best_key:
                best, best_key = state, key
        return best, best_key[0]

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
            state.pages.append(self._alloc_page(pinned, state.replica))
        # cow_page is the one fork policy: an index-only share goes
        # exclusive by forgetting the index entry, a real share copies.
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
        # Aliasing needs both slots on one data replica; across replicas
        # the whole pages are copied into dst's range instead.
        same_replica = src.replica == dst.replica
        self._trim_pages(dst, lo)
        if len(dst.pages) < lo_page:
            raise RuntimeError("alias_span: dst does not cover up to lo")
        cow_src, cow_dst = [], []

        def copy_into_dst(j: int) -> None:
            """Give dst its own exclusively-held page j, filled from src's
            page j."""
            if j < len(dst.pages):
                if self._shared(dst.pages[j]):
                    fresh = self._alloc_page(pinned, dst.replica)
                    self._decref(dst.pages[j])
                    dst.pages[j] = fresh
            else:
                dst.pages.append(self._alloc_page(pinned, dst.replica))
            cow_src.append(src.pages[j])
            cow_dst.append(dst.pages[j])

        if lo % ps and lo_page < hi_page:
            # dst's partial boundary page holds dst tokens [lo_page*ps, lo)
            # == src's, so copying src's full page is a superset update.
            copy_into_dst(lo_page)
            lo_page += 1
        for j in range(lo_page, hi_page):
            if not same_replica:
                copy_into_dst(j)
                continue
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
        cow_src, cow_dst = [], []

        def copy_into_dst(j: int) -> None:
            if j < len(dst.pages):
                if self._index_only_share(dst.pages[j]):
                    # About to be overwritten by the adopted copy:
                    # forgetting the index entry is exclusive for free.
                    self.prefix_cache.forget_page(dst.pages[j])
                elif self._shared(dst.pages[j]):
                    fresh = self._alloc_page(pinned, dst.replica)
                    self._decref(dst.pages[j])
                    dst.pages[j] = fresh
            else:
                dst.pages.append(self._alloc_page(pinned, dst.replica))
            cow_src.append(src_pages[j])
            cow_dst.append(dst.pages[j])

        try:
            if lo % ps and lo_page < hi_page:
                copy_into_dst(lo_page)
                lo_page += 1
            for j in range(lo_page, hi_page):
                if self.replica_of_page(src_pages[j]) != dst.replica:
                    # Another replica's page: copied into dst's range.
                    copy_into_dst(j)
                    continue
                if j < len(dst.pages):
                    self._decref(dst.pages[j])
                    dst.pages[j] = src_pages[j]
                else:
                    dst.pages.append(src_pages[j])
                # The guard ref becomes dst's mapping reference.
                transferred.add(j)
            if cow_src:
                self._run_page_copy(cow_src, cow_dst)
        finally:
            for j, p in guards.items():
                if j not in transferred:
                    self._decref(p)

    # --- device tables ---

    def replica_of(self, name: str) -> int:
        """The data replica owning every page of `name`'s slot (the
        engine's ReplicaGroupPlan keys on it)."""
        return self._slots[name].replica

    def local_table(self, table):
        """A page table of this rank's replica's rows (global page ids,
        tensor or array) as indices into this rank's pools."""
        if self.data_size == 1:
            return table
        return table - self.data_index * self._per_replica

    def pages_per_replica(self) -> int:
        """Usable (non-scratch) pages in each replica's range."""
        return self._per_replica - 1

    def scratch_page(self, replica: int) -> int:
        """The scratch page of a replica's range: pad rows point their
        whole table here (never aliased, never read)."""
        return self._scratch[replica]

    def table_for(self, names: list[str]) -> np.ndarray:
        """[B, pages_per_seq] int32 page table padded with each slot's own
        replica's scratch page (page 0 without a data axis)."""
        table = np.zeros((len(names), self.pages_per_seq), np.int32)
        for i, name in enumerate(names):
            state = self._slots[name]
            table[i, :] = self._scratch[state.replica]
            table[i, :len(state.pages)] = state.pages
        return table
