"""Host-RAM KV offload tier - spill idle sessions' pages, restore them
byte-identical, never re-prefill (counterpart of
theroundtaible_tpu/engine/kv_offload.py).

A consensus round can sit for minutes while humans type, and under page
pressure the allocator would otherwise evict idle slots - destroying the
caches that make the next turn cheap. This tier gives idle sessions a third
state: their pages move to host RAM, their slot records leave the pool,
and the session's next submit brings them back into freshly allocated
pages, byte-identical, so `reuse_plan` sees the whole committed prefix and
the turn prefills only its delta.

Page identity is kept per session: a span aliased by several of the
session's own knights (intra-session donation, or prefix-cache attaches)
spills its bytes once and restores into one fresh page that every sibling
re-maps. Only pages a holder outside the session still references (another
session's slot, an earlier spill's resident hold) stay on the device under
a per-mapping tier reference; pages shared only with the prefix-cache
index spill too (the index copy stays reclaimable, and restore never
depends on it surviving).

The device side: a spill gathers each layer's pages with `index_select`
and copies them into pinned host tensors with `non_blocking=True`, then
waits on a CUDA event before the host store is read; a restore copies the
host rows back with `index_copy_` into fresh pages. Quantized pools spill
their scale pools as extra layers (`PagedKVCache.combined_pools`), so a
restore is lossless at the stored int8/int4 width. Nothing here compiles.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from ..utils import telemetry
from . import deadlines
from .kvcache import session_of
from .paging import SCRATCH_PAGE
from .prefix_cache import env_flag

# Pages gathered (or written back) per device temporary. Nothing compiles
# here, so the JAX tier's reason for fixed chunks is gone; the chunk bounds
# the transient device buffer of one layer's index_select to WIDTH pages
# (16 MiB at Llama-3-8B's bf16 128-token page of 8 kv heads), where a whole
# session at once could be a GB-scale allocation on a card already under
# page pressure.
WIDTH = 64


def offload_enabled(flag: Optional[bool]) -> bool:
    """Config value wins, then ROUNDTABLE_KV_OFFLOAD=0/1, then ON (one
    parsing rule for every kill switch: prefix_cache.env_flag)."""
    return env_flag(flag, "ROUNDTABLE_KV_OFFLOAD")


@dataclass
class SpilledSlot:
    """One slot's layout while its session is spilled. `entries[j]` is
    ("kept", page_id) for a page left resident under a tier reference, or
    ("host", row) indexing the session record's host store. Host entries
    are keyed by store row, never by the old pool page id: the old page was
    freed and its id can be reallocated to unrelated content."""

    tokens: list[int]
    replica: int
    entries: list[tuple[str, int]] = field(default_factory=list)


@dataclass
class SpilledSession:
    """One session's spill record: per-slot layouts plus the host page
    store (rows deduplicated per spill call, while the pages were
    alive)."""

    slots: dict[str, SpilledSlot] = field(default_factory=dict)
    # Per layer (scale pools after the payload's): (k, v) host tensors
    # [n_rows, page, K, D], the pool's dtype, pinned when the pool is on
    # the card.
    host: list[tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=list)
    replicas: list[int] = field(default_factory=list)  # per store row

    def n_rows(self) -> int:
        return len(self.replicas)

    def fully_host_resident(self) -> bool:
        """No "kept" pool pages: the one definition of "this record can
        cross engines" (restorable_sessions reports by it, adopt filters
        by it)."""
        return not any(kind == "kept"
                       for srec in self.slots.values()
                       for kind, _p in srec.entries)

    def host_bytes(self) -> int:
        return sum(k.numel() * k.element_size()
                   + v.numel() * v.element_size() for k, v in self.host)

    def append_rows(self, fetched, replicas: list[int]) -> None:
        if self.host:
            self.host = [(torch.cat([k0, k1]), torch.cat([v0, v1]))
                         for (k0, v0), (k1, v1) in zip(self.host, fetched)]
        else:
            self.host = fetched
        self.replicas.extend(replicas)


class HostOffloadTier:
    """Spill/restore for one paged InferenceEngine's sessions."""

    def __init__(self, engine):
        self.engine = engine
        if getattr(engine, "kv_layout", None) != "paged":
            raise TypeError("HostOffloadTier requires a paged engine")
        self._spilled: dict[str, SpilledSession] = {}
        self.spills = 0
        self.restores = 0
        self._name = getattr(engine.cfg, "name", "engine")

    # --- introspection ---

    def spilled_sessions(self) -> list[str]:
        return list(self._spilled)

    def restorable_sessions(self) -> list[str]:
        """Sessions whose spill records are fully host-resident: exactly
        the set adopt() accepts onto another engine's tier."""
        return [s for s, rec in self._spilled.items()
                if rec.fully_host_resident()]

    def has(self, session: str) -> bool:
        return session in self._spilled

    def host_bytes(self) -> int:
        return sum(rec.host_bytes() for rec in self._spilled.values())

    def describe(self) -> dict:
        return {
            "spilled_sessions": len(self._spilled),
            "spilled_slots": sum(len(rec.slots)
                                 for rec in self._spilled.values()),
            "host_bytes": self.host_bytes(),
            "spills": self.spills,
            "restores": self.restores,
        }

    def _publish(self) -> None:
        telemetry.set_gauge("roundtable_kv_spilled_sessions",
                            len(self._spilled), engine=self._name)
        telemetry.set_gauge("roundtable_kv_host_bytes",
                            self.host_bytes(), engine=self._name)

    # --- device side ---

    def _fetch(self, page_ids: list[int]
               ) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Every layer's (k, v) rows of `page_ids` on the host, in order.
        On the card: gathered WIDTH pages at a time into pinned host
        tensors without blocking, then one event wait before the caller
        reads them."""
        pools = self.engine.kv.combined_pools()
        dev = pools[0][0].device
        cuda = dev.type == "cuda"
        n = len(page_ids)
        out = [tuple(torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                                 pin_memory=cuda) for t in kv_pair)
               for kv_pair in pools]
        for start in range(0, n, WIDTH):
            ids = torch.tensor(page_ids[start:start + WIDTH],
                               dtype=torch.long, device=dev)
            stop = start + ids.numel()
            for (k, v), (hk, hv) in zip(pools, out):
                hk[start:stop].copy_(k.index_select(0, ids),
                                     non_blocking=cuda)
                hv[start:stop].copy_(v.index_select(0, ids),
                                     non_blocking=cuda)
        if cuda:
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        return out

    def _write(self, page_ids: list[int],
               host: list[tuple[torch.Tensor, torch.Tensor]],
               rows: list[int]) -> None:
        """Write `host` store rows `rows` into pool pages `page_ids`."""
        pools = self.engine.kv.combined_pools()
        dev = pools[0][0].device
        cuda = dev.type == "cuda"
        with deadlines.commit_guard():
            for start in range(0, len(page_ids), WIDTH):
                ids = torch.tensor(page_ids[start:start + WIDTH],
                                   dtype=torch.long, device=dev)
                sel = rows[start:start + WIDTH]
                # Consecutive rows read a view of the (pinned) store; any
                # other selection gathers on the host first.
                run = sel == list(range(sel[0], sel[0] + len(sel)))
                idx = torch.tensor(sel, dtype=torch.long)
                for (k, v), (hk, hv) in zip(pools, host):
                    for pool, store in ((k, hk), (v, hv)):
                        src = (store[sel[0]:sel[0] + len(sel)] if run
                               else store.index_select(0, idx))
                        pool.index_copy_(0, ids, src.to(
                            dev, non_blocking=cuda))

    def warm(self) -> None:
        """One spill/restore round trip of the scratch page (never read),
        so the first real spill meets no first-use cost of the pinned host
        allocator or the copy engines. Nothing compiles."""
        self._write([SCRATCH_PAGE], self._fetch([SCRATCH_PAGE]), [0])

    # --- spill ---

    def spill_session(self, session: str) -> int:
        """Move every slot of `session` out of the pool. Keep resident
        (under one tier reference per mapping) only pages some holder
        outside the session still references; everything else, including
        spans aliased between the session's own knights and pages shared
        only with the prefix-cache index, spills its bytes once per unique
        page. Returns the number of slots spilled. The caller owns engine
        serialization (serve lock or scheduler thread)."""
        kv = self.engine.kv
        cache = getattr(kv, "prefix_cache", None)
        names = [n for n in kv.slot_names() if session_of(n) == session]
        # Pass 1 (no releases yet, so refcounts are stable): how many of
        # this session's own slots map each page - sibling aliases are not
        # external holders.
        own_maps: dict[int, int] = {}
        states = {}
        for name in names:
            state = kv._slots.get(name)
            if state is None:
                continue
            states[name] = state
            for p in state.pages:
                own_maps[p] = own_maps.get(p, 0) + 1
        rec = self._spilled.get(session) or SpilledSession()
        tier_refs: dict[int, int] = {}  # refs this call took, per page
        # Dedup within this call only (page -> store row): the pages are
        # alive and distinct for its duration.
        call_rows: dict[int, int] = {}
        spill_ids: list[int] = []
        empty: list[str] = []
        count = 0
        for name, state in states.items():
            if not state.tokens or not state.pages:
                # Released in pass 2 with the rest: dropping a sibling's
                # mappings now would skew the external-holder count.
                empty.append(name)
                continue
            entries: list[tuple[str, int]] = []
            for p in state.pages:
                external = (kv.refcount(p) - own_maps[p]
                            - (1 if cache is not None
                               and cache.holds_page(p) else 0)
                            - tier_refs.get(p, 0))
                if external >= 1:
                    kv.ref(p)          # per-mapping resident hold
                    tier_refs[p] = tier_refs.get(p, 0) + 1
                    entries.append(("kept", p))
                else:
                    row = call_rows.get(p)
                    if row is None:
                        row = rec.n_rows() + len(spill_ids)
                        call_rows[p] = row
                        spill_ids.append(p)
                    entries.append(("host", row))
            old = rec.slots.get(name)
            if old is not None:
                # Re-spill over a stale record (slot repopulated while
                # spilled): drop the superseded entries' resident holds;
                # the old host rows stay (row indices must stay stable).
                for kind, p in old.entries:
                    if kind == "kept":
                        kv.unref(p)
            rec.slots[name] = SpilledSlot(
                tokens=list(state.tokens), replica=0, entries=entries)
            count += 1
        if spill_ids:
            # Fetch before any release: the pages are still alive under
            # their slots' mappings.
            rec.append_rows(self._fetch(spill_ids),
                            [kv.replica_of_page(p) for p in spill_ids])
        # Pass 2: drop the slots (host-spilled pages free once their last
        # sibling mapping goes).
        for name in states:
            if name in rec.slots or name in empty:
                kv.release(name)
        if count:
            self._spilled[session] = rec
            self.spills += count
            telemetry.inc("roundtable_kv_spills_total", count,
                          engine=self._name)
            self._publish()
        return count

    # --- restore ---

    def restore_session(self, session: str,
                        pinned: tuple[str, ...] = ()) -> int:
        """Bring a spilled session back, all-or-nothing: one fresh page per
        unique spilled page (sibling slots re-map it), host bytes copied
        back, kept pages re-aliased (the tier's reference becomes the slot
        mapping's). On failure (pool exhaustion mid-restore) every effect
        of this call is undone and the record re-filed intact. Returns the
        number of slots restored."""
        rec = self._spilled.pop(session, None)
        if rec is None:
            return 0
        kv = self.engine.kv
        pin = tuple(pinned) + tuple(rec.slots)
        fresh: dict[int, int] = {}      # store row -> fresh page
        mapped: set[int] = set()        # fresh pages already mapped once
        assigned: list[str] = []
        stale: list[str] = []
        try:
            # Staleness first (a slot repopulated while spilled keeps its
            # live state), then materialize only rows a live slot's entries
            # still reference.
            live = [name for name, srec in rec.slots.items()
                    if not getattr(kv._slots.get(name), "pages", None)]
            need_rows = sorted({p for name in live
                                for kind, p in rec.slots[name].entries
                                if kind == "host"})
            for row in need_rows:
                fresh[row] = kv._alloc_page(pin)
            if fresh:
                self._write([fresh[r] for r in need_rows], rec.host,
                            need_rows)
            for name, srec in rec.slots.items():
                state = kv.acquire(name, pin)
                if state.pages:
                    stale.append(name)
                    continue
                pages: list[int] = []
                for kind, p in srec.entries:
                    if kind == "kept":
                        pages.append(p)          # tier ref transfers
                    else:
                        fp = fresh[p]
                        if fp in mapped:
                            kv.ref(fp)           # sibling re-alias
                        else:
                            mapped.add(fp)
                        pages.append(fp)
                state.pages = pages
                state.tokens = list(srec.tokens)
                assigned.append(name)
        except BaseException:
            # Undo: re-take the tier's kept holds of already-assigned slots
            # (their release below drops the transferred mapping refs),
            # release those slots, free the fresh pages nothing maps, and
            # re-file the record.
            for name in assigned:
                for kind, p in rec.slots[name].entries:
                    if kind == "kept":
                        kv.ref(p)
                kv.release(name)
            for fp in fresh.values():
                if fp not in mapped:
                    kv.unref(fp)
            self._spilled[session] = rec
            raise
        # Stale slots consumed their records: drop the tier's holds and the
        # fresh pages their skipped entries left unmapped.
        for name in stale:
            for kind, p in rec.slots[name].entries:
                if kind == "kept":
                    kv.unref(p)
        for fp in fresh.values():
            if fp not in mapped:
                kv.unref(fp)
        count = len(assigned)
        self.restores += count
        if count:
            telemetry.inc("roundtable_kv_restores_total", count,
                          engine=self._name)
        self._publish()
        return count

    def restore_for(self, names: list[str],
                    pinned: tuple[str, ...] = ()) -> int:
        """Restore every spilled session appearing among `names`: the
        engine-side seam `_prepare_batch` runs before reuse_plan, so a
        spilled session resumes on any serving path. Sessions restore in
        sorted order: the order drives the allocator's call sequence, which
        must not depend on set iteration."""
        if not self._spilled:
            return 0
        restored = 0
        for session in sorted({session_of(n) for n in names}):
            if session and session in self._spilled:
                restored += self.restore_session(session, pinned)
        return restored

    # --- drain / evacuation / teardown ---

    def evacuate(self, sessions: Optional[list[str]] = None) -> dict:
        """Move sessions fully to host RAM and return a restorable
        manifest: first spill every still-resident targeted session, then
        convert its kept-resident holds to host bytes and drop them, so
        each targeted session's state lives entirely in host RAM (which
        lets another engine's tier adopt() it). `sessions=None` targets
        everything; a subset leaves the rest untouched. The caller owns
        engine serialization.

        Manifest: {"pages_moved", "slots_spilled", "host_bytes",
        "sessions": {session: {"slots", "host_rows", "host_bytes"}}}."""
        kv = self.engine.kv
        targets = None if sessions is None else set(sessions)
        resident = sorted({session_of(n) for n in kv.slot_names()} - {""})
        slots_spilled = 0
        for s in resident:
            if targets is None or s in targets:
                slots_spilled += self.spill_session(s)
        moved = 0
        for session, rec in self._spilled.items():
            if targets is not None and session not in targets:
                continue
            kept: dict[int, int] = {}   # page -> mappings in this record
            for srec in rec.slots.values():
                for kind, p in srec.entries:
                    if kind == "kept":
                        kept[p] = kept.get(p, 0) + 1
            if not kept:
                continue
            ids = list(kept)
            base = rec.n_rows()
            rows = {p: base + i for i, p in enumerate(ids)}
            rec.append_rows(self._fetch(ids),
                            [kv.replica_of_page(p) for p in ids])
            moved += len(ids)
            for srec in rec.slots.values():
                srec.entries = [("host", rows[p]) if kind == "kept"
                                else (kind, p)
                                for kind, p in srec.entries]
            for p, n_maps in kept.items():
                for _ in range(n_maps):
                    kv.unref(p)
        if moved or slots_spilled:
            self._publish()
        manifest: dict = {
            "pages_moved": moved,
            "slots_spilled": slots_spilled,
            "host_bytes": 0,
            "sessions": {},
        }
        for session, rec in self._spilled.items():
            if targets is not None and session not in targets:
                continue
            b = rec.host_bytes()
            manifest["sessions"][session] = {
                "slots": len(rec.slots),
                "host_rows": rec.n_rows(),
                "host_bytes": b,
            }
            manifest["host_bytes"] += b
        return manifest

    def adopt(self, other: "HostOffloadTier",
              sessions: Optional[list[str]] = None) -> list[str]:
        """Graft another tier's spill records onto this tier (an engine
        rebuild, or a session migrating between engines). Records must be
        fully host-resident (evacuate() first): one still holding "kept"
        pool pages references a pool this tier has never seen, and is left
        on `other`. This tier's own record of a session wins. `sessions`
        selects a subset. Returns the adopted session names."""
        targets = None if sessions is None else set(sessions)
        adopted: list[str] = []
        for session, rec in list(other._spilled.items()):
            if targets is not None and session not in targets:
                continue
            if not rec.fully_host_resident():
                continue
            if session in self._spilled:
                continue
            self._spilled[session] = rec
            del other._spilled[session]
            adopted.append(session)
        if adopted:
            self._publish()
            other._publish()
        return adopted

    def drop_all(self) -> None:
        """Forget every spilled record without touching the pool."""
        self._spilled.clear()
        self._publish()
