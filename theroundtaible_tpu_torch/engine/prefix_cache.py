"""Cross-session radix-tree prefix cache over the paged KV pool
(counterpart of theroundtaible_tpu/engine/prefix_cache.py; pure host code,
the same tree, rules and counters).

Every discussion re-prefills the same bytes: the shared system prompt,
each knight's tail and, across rounds, the growing transcript. Donation
between slots (`PagedKVCache.best_donor`) stays within one session, since
sessions are fault-isolation domains. This module adds a content-addressed
index over the page pool itself, decoupled from any slot's lifetime:

- **Radix tree keyed by token blocks.** One node per page-sized token
  block, children keyed by the block's token tuple (exact verification: a
  hash collision can never serve wrong bytes). A node maps its block to one
  pool page whose K/V bytes are a function of the token prefix up to it.
- **The index is a reference holder, not an owner.** insert() takes one
  pool reference per node (`PagedKVCache.ref`); slots that release or
  truncate only unref, so the page's bytes survive while anyone (index,
  slot, offload tier) still references them.
- **attach() is the read path.** `InferenceEngine._prepare_batch` calls it
  per row after the slot's own reuse_plan: the longest complete-block match
  extends the row's reuse frontier by aliasing the matched pages (refcount
  ++, no copy; the partial boundary page is copied on the device,
  `PagedKVCache.adopt_span`). The attached span is read-only:
  `ensure_capacity` copies on write any shared page in the row's write
  range before the first divergent write.
- **Eviction is LRU over refcount-0 nodes only.** A node whose page a live
  slot (or the offload tier) still references is never reclaimed; leaves
  the index alone holds evict oldest first, under the page cap and, last,
  from `_alloc_page` just before it would declare the pool exhausted.
  flush() drops the whole index by unref, never by force-free.

The index never hands out a writable page and never frees a referenced
one, and a session's fault recovery can only unref or clear: it cannot
reach into another session's mappings.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from ..utils import telemetry

# Test-visibility counters: a test that claims prefix-cache coverage but
# records zero attach hits silently ran cache-off serving.
_test_hits = 0
_test_lock = threading.Lock()


def reset_test_counters() -> None:
    global _test_hits
    with _test_lock:
        _test_hits = 0


def hits_seen() -> int:
    return _test_hits


def _note_hit() -> None:
    global _test_hits
    with _test_lock:
        _test_hits += 1


def env_flag(flag: Optional[bool], env_name: str) -> bool:
    """On/off decision of a paged-pool subsystem: an explicit config value
    wins, then the env kill-switch ("0", "false", "off"), then default ON.
    The one definition of the falsy spellings: the prefix cache, the
    offload tier, speculative decoding, the ragged seam and quantized KV
    all decide through it."""
    if flag is not None:
        return bool(flag)
    env = os.environ.get(env_name)
    if env is not None:
        return env not in ("0", "false", "off")
    return True


def cache_enabled(flag: Optional[bool]) -> bool:
    """The prefix cache's on/off decision for a paged engine (default ON,
    ROUNDTABLE_PREFIX_CACHE=0 turns it off)."""
    return env_flag(flag, "ROUNDTABLE_PREFIX_CACHE")


class _Node:
    __slots__ = ("children", "parent", "block", "page", "tick")

    def __init__(self, parent=None, block=None, page=None):
        self.children: dict[tuple, "_Node"] = {}
        self.parent = parent
        self.block = block
        self.page = page
        self.tick = 0


class PrefixCache:
    """The content-addressed index over one PagedKVCache pool.

    Single-writer like the pool itself: every caller already serializes on
    the engine's serve lock (scheduler thread or generate_batch)."""

    def __init__(self, kv, engine: str = "engine",
                 max_pages: Optional[int] = None):
        self.kv = kv
        self.engine = engine
        self.page_size = kv.page_size
        # Default cap: the whole usable pool (bounded by reclaim under
        # pressure); prefix_cache_pages bounds it hard.
        self.max_pages = max_pages or kv.usable_pages()
        self.root = _Node()
        self._pages = 0
        # page id -> node (1:1: a live node's page is ref-held). The
        # offload tier asks `holds_page` to tell an index-only share from a
        # genuine cross-slot share; the write path asks `forget_page` to
        # make an index-only share exclusive without a copy.
        self._by_page: dict[int, _Node] = {}
        self._ticks = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.inserted_pages = 0
        self.reused_tokens = 0

    # --- introspection ---

    def page_count(self) -> int:
        return self._pages

    def holds_page(self, page: int) -> bool:
        return page in self._by_page

    def node_count(self) -> int:
        n = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n

    def describe(self) -> dict:
        return {
            "pages": self._pages,
            "max_pages": self.max_pages,
            "nodes": self.node_count(),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "inserted_pages": self.inserted_pages,
            "reused_tokens": self.reused_tokens,
        }

    def _tick(self) -> int:
        self._ticks += 1
        return self._ticks

    def _publish_sizes(self) -> None:
        telemetry.set_gauge("roundtable_prefix_cache_pages", self._pages,
                            engine=self.engine)

    # --- write path ---

    def insert(self, state) -> int:
        """Index every complete page of a committed slot (PagedKVCache.
        commit calls this). New blocks take one pool reference each; a
        block already present keeps its page (first writer wins: the bytes
        are equal by construction). Returns how many pages were indexed."""
        ps = self.page_size
        n_pages = min(len(state.tokens) // ps, len(state.pages))
        node = self.root
        added = 0
        tick = self._tick()
        for j in range(n_pages):
            block = tuple(state.tokens[j * ps:(j + 1) * ps])
            child = node.children.get(block)
            if child is None:
                page = state.pages[j]
                child = _Node(parent=node, block=block, page=page)
                node.children[block] = child
                self.kv.ref(page)
                self._pages += 1
                self._by_page[page] = child
                added += 1
            child.tick = tick
            node = child
        if added:
            self.inserted_pages += added
            telemetry.inc("roundtable_prefix_cache_inserted_pages_total",
                          added, engine=self.engine)
            self._publish_sizes()
        if self._pages > self.max_pages:
            self.reclaim(want=self._pages - self.max_pages)
        return added

    # --- read path ---

    def match(self, tokens: list[int]) -> list[_Node]:
        """The longest chain of complete-block nodes prefixing `tokens`
        (LRU-refreshed); a match is prefix equality."""
        ps = self.page_size
        node = self.root
        out: list[_Node] = []
        tick = self._tick()
        j = 0
        while (j + 1) * ps <= len(tokens):
            child = node.children.get(tuple(tokens[j * ps:(j + 1) * ps]))
            if child is None:
                break
            child.tick = tick
            out.append(child)
            node = child
            j += 1
        return out

    def attach(self, name: str, tokens: list[int],
               pinned: tuple[str, ...] = ()) -> int:
        """Raise slot `name`'s cached coverage to the longest complete-page
        prefix of `tokens` in the index, by aliasing the matched pages.
        Returns the new covered token count, or 0 when the index could not
        extend the slot's own reuse. Coverage never reaches len(tokens): at
        least one token is fed."""
        cap = len(tokens) - 1
        if cap < self.page_size:
            return 0
        nodes = self.match(tokens)
        n = min(len(nodes), cap // self.page_size)
        state = self.kv._slots.get(name)
        have = len(state.tokens) if state is not None else 0
        if n <= 0 or n * self.page_size <= have:
            if not nodes:
                self.misses += 1
                telemetry.inc("roundtable_prefix_cache_misses_total",
                              engine=self.engine)
            return 0
        hi = n * self.page_size
        self.kv.adopt_span(name, [nd.page for nd in nodes[:n]],
                           lo=have, hi=hi, pinned=pinned)
        state = self.kv._slots[name]
        state.tokens = list(tokens[:hi])
        gained = hi - have
        self.hits += 1
        self.reused_tokens += gained
        _note_hit()
        telemetry.inc("roundtable_prefix_cache_hits_total",
                      engine=self.engine)
        telemetry.inc("roundtable_prefix_reused_tokens_total", gained,
                      engine=self.engine)
        return hi

    def attach_rows(self, names: list[str],
                    all_tokens: list[list[int]], offsets: list[int],
                    pinned: tuple[str, ...] = ()) -> int:
        """The per-batch consult the engine runs after its own-slot
        reuse_plan pass. Warmup rows never attach. Mutates `offsets` in
        place; returns the tokens the index served."""
        gained = 0
        for i, name in enumerate(names):
            if name.startswith("__warmup_"):
                continue
            got = self.attach(name, all_tokens[i], pinned)
            if got > offsets[i]:
                gained += got - offsets[i]
                offsets[i] = got
        return gained

    # --- eviction / lifecycle ---

    def _evictable_leaves(self, replica: Optional[int]) -> list[_Node]:
        out = []
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif self.kv.refcount(node.page) == 1 and (
                    replica is None
                    or self.kv.replica_of_page(node.page) == replica):
                out.append(node)
        return out

    def reclaim(self, replica: Optional[int] = None, want: int = 1) -> int:
        """Evict up to `want` LRU refcount-0 leaf nodes, unref'ing their
        pages back to the pool; an interior node whose children all went
        becomes a leaf and follows in the same pass. Returns pages
        freed."""
        freed = 0
        while freed < want:
            leaves = self._evictable_leaves(replica)
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.tick)
            while victim is not None and freed < want:
                parent = victim.parent
                del parent.children[victim.block]
                self.kv.unref(victim.page)
                self._pages -= 1
                self._by_page.pop(victim.page, None)
                freed += 1
                self.evictions += 1
                victim = None
                if (parent is not self.root and not parent.children
                        and self.kv.refcount(parent.page) == 1
                        and (replica is None
                             or self.kv.replica_of_page(parent.page)
                             == replica)):
                    victim = parent
        if freed:
            telemetry.inc("roundtable_prefix_cache_evictions_total",
                          freed, engine=self.engine)
            self._publish_sizes()
        return freed

    def forget_page(self, page: int) -> bool:
        """Drop the node backing `page` and its whole subtree (their chain
        includes the dropped block, so they can never match again): the
        write path calls this when a slot is about to diverge inside a page
        whose only other holder is the index, which makes the page
        exclusive without a copy."""
        node = self._by_page.get(page)
        if node is None:
            return False
        del node.parent.children[node.block]
        stack = [node]
        dropped = 0
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.kv.unref(n.page)
            self._by_page.pop(n.page, None)
            self._pages -= 1
            dropped += 1
        self.evictions += dropped
        telemetry.inc("roundtable_prefix_cache_evictions_total",
                      dropped, engine=self.engine)
        self._publish_sizes()
        return True

    def drop_all(self) -> int:
        """Unref every indexed page and clear the tree (flush)."""
        dropped = self._pages
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self.kv.unref(node.page)
        self.root = _Node()
        self._pages = 0
        self._by_page.clear()
        self._publish_sizes()
        return dropped

    def clear(self, unref: bool = True) -> None:
        """Drop the index; unref=False when the pool's refcounts are
        already gone."""
        if unref:
            self.drop_all()
            return
        self.root = _Node()
        self._pages = 0
        self._by_page.clear()
        self._publish_sizes()
