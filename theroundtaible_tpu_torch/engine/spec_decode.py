"""Speculative decoding on the shared batch (counterpart of
theroundtaible_tpu/engine/spec_decode.py).

The host side: the drafters (n-gram, draft model, LoRA draft head), the
chain and tree acceptance rules, and the per-row adaptive throttle with its
re-probe hysteresis. The device side is the ragged seam: a verify dispatch
packs each speculating row's candidates as short multi-token runs of the
flat token buffer and scores every draft position in one forward
(engine._ragged_dispatch with `score_width`; forward_ragged gathers the
scored rows before the head, and K3 attends over each run at the frontier
of its row's cache).

Drafters:

- ``ngram`` - prompt lookup over the row's own prompt plus its committed
  output: roundtable transcripts repeat quoted proposals and scaffolding,
  so the token that followed the context's tail gram last time is a good
  guess on such traffic, and the throttle turns speculation off where it
  is not.
- ``model`` - a draft model served as extra rows of the same engine: each
  target row gets a shadow draft slot in the same paged pool, and drafting
  runs ordinary ragged dispatches with a `params` override (a draft
  checkpoint has the engine's shapes). The default draft weights are the
  engine's own, whose proposals are the target's own greedy chain.
- ``lora`` - drafting as an adapter: the draft head is a LoRA pair in the
  engine's LoraStore, and draft rows ride the per-token adapter ids.

Acceptance (the output-invariance contract): the verify run of a chain row
is ``[last, d_0, ..., d_{k-1}]`` at positions ``valid..valid+k``; by the
causal mask the logits at the row of ``last`` are what plain decode would
compute, those at ``d_0`` are exact given ``d_0`` in context, and so on.
Greedy rows accept the longest prefix with ``d_j == argmax_j`` and commit
``t_0..t_a`` (the first mismatch, or the bonus token after a fully
accepted draft, rides free): the same tokens as 1-token decode. Sampled
rows draw ``t_j`` from each position's filtered distribution and accept
while ``d_j == t_j``, which for a point-mass drafter is exact rejection
sampling. A token tree is its root-to-leaf paths, each one more sequence
of the same verify dispatch with its own page table (`accept_tree` walks
it). Rejected tail tokens wrote K/V past the new committed `valid` only;
every later dispatch's `kv_valid` stops before them, so they are never
read and are overwritten in place.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Any, Optional, Protocol, runtime_checkable

from .prefix_cache import env_flag

SPEC_ENV = "ROUNDTABLE_SPEC_DECODE"

DRAFTER_KINDS = ("ngram", "model", "lora")

# Drafts per row per verify dispatch (config `spec_max_draft`). The default
# keeps a row's verify run (1 + drafts) inside one RAGGED_BLOCK_Q block, so
# a speculating batch packs like a plain ragged decode batch.
DEFAULT_MAX_DRAFT = 4

# Longest n-gram the drafter keys on; it backs off to shorter grams when the
# longer suffix has no prior occurrence.
NGRAM_MAX = 3

# Adaptive throttle: after at least SPEC_MIN_DISPATCHES verify dispatches, a
# row whose windowed acceptance rate (accepted drafts / drafted) sits below
# the floor stops drafting. ROUNDTABLE_SPEC_ACCEPT_FLOOR moves the floor.
SPEC_WINDOW = 16
SPEC_MIN_DISPATCHES = 6
SPEC_ACCEPT_FLOOR = 0.2

# Re-probe hysteresis: a throttled row re-drafts once every
# SPEC_REPROBE_DISPATCHES committed tokens (ROUNDTABLE_SPEC_REPROBE), and a
# probe whose own acceptance clears the floor re-enables the row with a
# fresh window.
SPEC_REPROBE_DISPATCHES = 16


def accept_floor() -> float:
    raw = os.environ.get("ROUNDTABLE_SPEC_ACCEPT_FLOOR")
    try:
        return float(raw) if raw else SPEC_ACCEPT_FLOOR
    except ValueError:
        return SPEC_ACCEPT_FLOOR


def reprobe_interval() -> int:
    raw = os.environ.get("ROUNDTABLE_SPEC_REPROBE")
    try:
        n = int(raw) if raw else SPEC_REPROBE_DISPATCHES
    except ValueError:
        n = SPEC_REPROBE_DISPATCHES
    return max(n, 1)


def spec_enabled(flag) -> bool:
    """The speculative-decode on/off decision for a paged engine with the
    ragged seam: explicit config wins, then the ROUNDTABLE_SPEC_DECODE
    kill switch, then default ON. A dict config decides through its
    optional "enabled" key, so `spec_decode: {drafter: ...}` keeps the
    kill switch live while `{enabled: true, ...}` pins it on."""
    if isinstance(flag, dict):
        flag = flag.get("enabled")
    return env_flag(flag, SPEC_ENV)


class SpecOptions:
    """The resolved `spec_decode:` block. The config takes a bool or a
    dict::

        spec_decode: {enabled?: bool, drafter: ngram|model|lora,
                      max_draft?: int, tree?: {branch: B, depth: D},
                      draft_checkpoint?: path, adapter?: name}

    Validation lives here so the constructor and from_config fail alike;
    a drafter whose dependency is missing (no lora store, say) is the
    engine's to record, not to raise."""

    __slots__ = ("drafter", "tree", "max_draft", "draft_checkpoint",
                 "adapter")

    def __init__(self, drafter: str = "ngram",
                 tree: Optional[dict] = None,
                 max_draft: Optional[int] = None,
                 draft_checkpoint: Optional[str] = None,
                 adapter: Optional[str] = None):
        self.drafter = drafter
        self.tree = tree
        self.max_draft = max_draft
        self.draft_checkpoint = draft_checkpoint
        self.adapter = adapter

    @classmethod
    def resolve(cls, flag) -> "SpecOptions":
        if not isinstance(flag, dict):
            return cls()
        drafter = flag.get("drafter", "ngram")
        if drafter not in DRAFTER_KINDS:
            raise ValueError(
                f"spec_decode drafter must be one of {DRAFTER_KINDS}, "
                f"got {drafter!r}")
        tree = flag.get("tree") or None
        if tree is not None:
            if not isinstance(tree, dict):
                raise ValueError(
                    "spec_decode tree must be {branch: B, depth: D}")
            branch = int(tree.get("branch", 2))
            depth = int(tree.get("depth", 2))
            if branch < 2:
                raise ValueError(
                    f"spec_decode tree branch must be >= 2 (a 1-branch "
                    f"tree is the chain), got {branch}")
            if depth < 1:
                raise ValueError(
                    f"spec_decode tree depth must be >= 1, got {depth}")
            tree = {"branch": branch, "depth": depth}
        if drafter == "lora" and not flag.get("adapter"):
            raise ValueError(
                "spec_decode drafter 'lora' needs an `adapter:` name "
                "registered in the engine's lora: block")
        max_draft = flag.get("max_draft")
        return cls(drafter=drafter, tree=tree,
                   max_draft=(int(max_draft)
                              if max_draft is not None else None),
                   draft_checkpoint=flag.get("draft_checkpoint"),
                   adapter=flag.get("adapter"))


@runtime_checkable
class Drafter(Protocol):
    """Per-row host-side proposer. `sync_parts` brings the drafter up to
    the row's committed context before every draft; `draft` proposes one
    chain; `draft_paths` up to `branch` candidate paths with distinct
    first tokens for tree verify (chain drafters return one). The
    model/LoRA drafters are batched across rows (DeviceDrafter), so their
    per-row view is the draft slot the coordinator keeps."""

    kind: str

    def sync_parts(self, prompt: list[int],
                   produced: list[int]) -> None: ...

    def draft(self, max_n: int) -> list[int]: ...

    def draft_paths(self, max_n: int,
                    branch: int = 1) -> list[list[int]]: ...


class NGramDrafter:
    """Hash-indexed n-gram / prompt-lookup proposer over one row's corpus:
    its prompt plus every committed output token, indexed as tokens
    commit.

    For each gram order n in NGRAM_MAX..1 the index maps the token tuple to
    the end positions of its two most recent occurrences. A draft looks up
    the context's tail gram and proposes the tokens that followed it last
    time; the second slot exists because the tail gram's own occurrence is
    always the most recent one and has no continuation."""

    __slots__ = ("_toks", "_index")

    kind = "ngram"

    def __init__(self, tokens: Optional[list[int]] = None):
        self._toks: list[int] = []
        # gram tuple -> (last_end, prev_end); end = index after the gram.
        self._index: dict[tuple, tuple[int, int]] = {}
        if tokens:
            self.extend(tokens)

    def __len__(self) -> int:
        return len(self._toks)

    def extend(self, tokens: list[int]) -> None:
        """Append committed tokens and index every new gram."""
        toks = self._toks
        start = len(toks)
        toks.extend(tokens)
        idx = self._index
        for end in range(start + 1, len(toks) + 1):
            for n in range(1, NGRAM_MAX + 1):
                if end < n:
                    break
                key = tuple(toks[end - n:end])
                prev = idx.get(key)
                if prev is None:
                    idx[key] = (end, -1)
                elif prev[0] != end:
                    idx[key] = (end, prev[0])

    def sync(self, context: list[int]) -> None:
        """Bring the index up to `context` (prompt + produced)."""
        if len(context) > len(self._toks):
            self.extend(context[len(self._toks):])

    def sync_parts(self, prompt: list[int], produced: list[int]) -> None:
        """sync(prompt + produced) without building the concatenation (the
        prompt was indexed at construction, so only produced's tail is
        new)."""
        have = len(self._toks)
        need = len(prompt) + len(produced)
        if need > have:
            self.extend(produced[have - len(prompt):])

    def draft(self, max_n: int) -> list[int]:
        """Up to `max_n` candidate continuation tokens, from the most recent
        prior occurrence of the longest matching tail gram; [] when nothing
        matches (the row then runs plain 1-token decode this step)."""
        paths = self.draft_paths(max_n, branch=1)
        return paths[0] if paths else []

    def draft_paths(self, max_n: int,
                    branch: int = 1) -> list[list[int]]:
        """Up to `branch` candidate continuation paths with distinct first
        tokens (tree verify): the two stored occurrences of the longest
        matching tail gram propose first, and shorter grams fill further
        branches only when the longer ones could not, so
        `draft_paths(n, 1)[0]` is the chain draft. [] when nothing
        matches."""
        toks = self._toks
        if max_n < 1 or not toks or branch < 1:
            return []
        paths: list[list[int]] = []
        seen_first: set[int] = set()
        for n in range(min(NGRAM_MAX, len(toks)), 0, -1):
            entry = self._index.get(tuple(toks[len(toks) - n:]))
            if entry is None:
                continue
            # The tail gram itself is always the most recent occurrence; a
            # continuation needs an occurrence that ends before the corpus.
            for pos in entry:
                if not 0 < pos < len(toks):
                    continue
                p = list(toks[pos:pos + max_n])
                if p and p[0] not in seen_first:
                    paths.append(p)
                    seen_first.add(p[0])
                    if len(paths) >= branch:
                        return paths
            if paths and branch == 1:
                return paths
        return paths


class RowSpec:
    """Per-row speculation state: the drafter, plus the adaptive throttle's
    acceptance window and re-probe hysteresis (`kind` labels the
    metrics)."""

    __slots__ = ("drafter", "kind", "drafted", "accepted", "recent",
                 "disabled", "probing", "_idle_mark", "ctx")

    def __init__(self, prompt_tokens: Optional[list[int]] = None,
                 kind: str = "ngram"):
        # Device drafters (model/lora) keep their state in the draft slots
        # the DeviceDrafter owns; only the ngram drafter lives per row.
        self.drafter = (NGramDrafter(prompt_tokens)
                        if kind == "ngram" else None)
        self.kind = kind
        self.drafted = 0
        self.accepted = 0
        # (drafted, accepted) per verify dispatch that drafted.
        self.recent: deque = deque(maxlen=SPEC_WINDOW)
        self.disabled = False
        # Re-probe bookkeeping: the produced-token mark at throttle time,
        # so the probe decision is the same for the scheduler's probe and
        # its real call.
        self.probing = False
        self._idle_mark = 0
        # Device-drafter context cache (prompt + produced), extended by the
        # new tokens each tick instead of rebuilt.
        self.ctx: Optional[list[int]] = None

    def rate(self) -> float:
        d = sum(x for x, _ in self.recent)
        return (sum(a for _, a in self.recent) / d) if d else 0.0

    def should_draft(self, produced_len: int) -> bool:
        """Whether this row drafts this tick: unthrottled rows always;
        throttled rows once every `reprobe_interval()` committed tokens.
        A probe that fires stays armed until the next note()."""
        if not self.disabled:
            return True
        if self.probing:
            return True
        if produced_len - self._idle_mark >= reprobe_interval():
            self.probing = True
            return True
        return False

    def mark_idle(self, produced_len: int) -> None:
        """Restart the re-probe interval (a dispatch left the row
        throttled)."""
        self._idle_mark = produced_len

    def probe_failed(self, produced_len: int) -> None:
        """Resolve an armed probe whose drafter proposed nothing: clear the
        arm and restart the interval, so the row does not pay draft host
        work every tick."""
        if self.probing:
            self.probing = False
            self._idle_mark = produced_len
            note_spec_reprobe(recovered=False)

    def note(self, drafted: int, accepted: int) -> bool:
        """Record one verify dispatch's outcome. Returns True when this call
        tripped the throttle. A throttled row's probe recovers here when its
        own acceptance clears the floor, with a fresh window."""
        if drafted <= 0:
            return False
        self.drafted += drafted
        self.accepted += accepted
        if self.disabled:
            self.probing = False
            if accepted / drafted >= accept_floor():
                self.disabled = False
                self.recent.clear()
                self.recent.append((drafted, accepted))
                note_spec_reprobe(recovered=True)
            else:
                self.recent.append((drafted, accepted))
                note_spec_reprobe(recovered=False)
            return False
        self.recent.append((drafted, accepted))
        if (len(self.recent) >= SPEC_MIN_DISPATCHES
                and self.rate() < accept_floor()):
            self.disabled = True
            return True
        return False


def accept_prefix(drafts: list[int],
                  proposals: list[int]) -> tuple[list[int], int]:
    """The chain acceptance rule: `proposals` are the device's per-position
    tokens for the run ``[last, d_0, ..., d_{k-1}]`` (len k+1). Returns
    (emit, accepted): the committed tokens ``t_0..t_a`` and the accepted
    draft count a."""
    a = 0
    while a < len(drafts) and drafts[a] == proposals[a]:
        a += 1
    return list(proposals[:a + 1]), a


def accept_tree(paths: list[list[int]],
                props: list[list[int]]) -> tuple[list[int], int, int]:
    """The tree acceptance walk: `paths[i]` is root-to-leaf candidate path
    i, `props[i]` the device's per-position tokens for its run ``[last,
    paths[i]...]``. From the root, emit the current path's device token at
    depth j (an exact target-model token given the emitted prefix), then
    descend into any still-consistent path whose node j equals it.
    Returns (emit, accepted_edges, winner_path): the committed tokens, how
    many tree edges were accepted, and the path whose cells hold every
    accepted token's K/V."""
    emit: list[int] = []
    a, cur, j = 0, 0, 0
    alive = list(range(len(paths)))
    while True:
        t = int(props[cur][j])
        emit.append(t)
        alive = [i for i in alive
                 if len(paths[i]) > j and paths[i][j] == t]
        if not alive:
            return emit, a, cur
        cur = alive[0]
        a += 1
        j += 1


# --- device-batched drafters: draft model / LoRA draft head ---


class DraftUnavailable(RuntimeError):
    """The drafter cannot shadow the batch for a benign capacity reason (no
    slot for a draft slot, pool pressure): the scheduler serves plain
    decode this tick with the reason on record. Distinct from device
    dispatch failures, which take the preempt ladder."""


DRAFT_SCOPE = "__spec_draft__"

# A draft run fed through the propose/extend dispatches never exceeds one
# RAGGED_BLOCK_Q block.
PROPOSE_RUN = 7


def draft_slot_name(row_name: str) -> str:
    """The shadow draft slot of a target row, namespaced under its own
    pseudo-session so prefix sharing never moves draft-model K/V into a
    real row. Draft slots are never committed."""
    from .kvcache import SESSION_SEP
    return f"{DRAFT_SCOPE}{SESSION_SEP}{row_name}"


def to_host(h):
    """Host copy of a dispatch's result: one tensor, or (next, tops) of a
    propose dispatch."""
    if isinstance(h, tuple):
        return tuple(x.cpu().numpy() for x in h)
    return h.cpu().numpy()


class DeviceDrafter:
    """Batch-level coordinator of the model/LoRA drafters: each target row
    gets a shadow draft slot in the same paged pool, kept in step with the
    row's committed context and advanced through ordinary ragged
    dispatches - a `params` override for the `model` kind, per-token
    adapter ids for the `lora` kind.

    Per spec tick, `propose` runs:
      1. catch-up - ragged chunk dispatches feed each draft slot the
         target context it is missing (first tick: the whole prompt; then
         the last verify's committed tokens); a diverged slot overwrites
         its stale cells in place.
      2. propose - one small dispatch scores every row's context tip; the
         greedy argmax is the main chain's first node and, under a tree
         config, `propose_width` top ids seed the root branches.
      3. extend - depth-1 one-token dispatches grow the main chain through
         the draft model (root alternatives stay one-node leaves).

    The coordinator never commits draft slots and keeps `slot.tokens` =
    the real target context only: speculative cells beyond it are
    overwritten by the next catch-up, like rejected verify drafts."""

    def __init__(self, kind: str, adapter_slot: int = 0,
                 params: Any = None):
        if kind not in ("model", "lora"):
            raise ValueError(f"DeviceDrafter kind must be model|lora, "
                             f"got {kind!r}")
        self.kind = kind
        self.adapter_slot = adapter_slot
        self.params = params  # None = the engine's own params
        self.adapter_id: Optional[str] = None
        self.draft_dispatches = 0

    def end_row(self, engine, row_name: str) -> None:
        """Release the row's draft slot (row retire or failure)."""
        engine.kv.release(draft_slot_name(row_name))

    def _batch(self, engine, seqs, shape, propose_width=0):
        from .paging import SCRATCH_PAGE
        from .serving_loop import build_ragged_batch
        batch = build_ragged_batch(
            seqs, t_budget=shape, s_max=engine.kv.num_slots + 1,
            pages_per_seq=engine.kv.pages_per_seq,
            scratch_page=SCRATCH_PAGE, pad_id=engine.tokenizer.pad_id,
            page_size=engine.kv.page_size)
        batch["draft"] = True
        if propose_width:
            batch["propose_width"] = propose_width
        if self.params is not None:
            batch["draft_params"] = self.params
        return batch

    def propose(self, engine, rows, pinned=(),
                dispatch=None, read=None) -> dict:
        """rows: list of (key, row_name, ctx_tokens, depth, branch).
        Returns {key: [path, ...]}: the main chain plus up to branch-1
        one-node root alternatives, every path non-empty. `dispatch`/`read`
        let the scheduler route the device calls through its watchdog
        seams."""
        from .serving_loop import (RAGGED_BLOCK_Q, RaggedSeq,
                                   ragged_pick_shape)

        if dispatch is None:
            dispatch = engine._ragged_dispatch
        if read is None:
            read = to_host
        kv = engine.kv
        temps = 0.0  # point-mass drafter: always greedy
        pinned = tuple(pinned) + tuple(
            draft_slot_name(name) for _, name, _, _, _ in rows)

        # 1. slots, capacity and catch-up plans. Capacity failures here are
        # benign (serve plain decode; never evict live rows to draft for
        # them), unlike the device failures below.
        infos = []
        try:
            for key, name, ctx, depth, branch in rows:
                dname = draft_slot_name(name)
                st = kv.acquire(dname, pinned)
                common = kv.common_prefix_len(st.tokens, ctx)
                if common < len(st.tokens):
                    # Diverged (or freshly evicted): keep the common
                    # prefix, overwrite the rest in place.
                    st.tokens = st.tokens[:common]
                kv.ensure_capacity(dname, len(ctx) + depth,
                                   write_from=common, pinned=pinned)
                table = kv.table_for([dname])[0]
                infos.append({"key": key, "st": st, "ctx": list(ctx),
                              "depth": depth, "branch": branch,
                              "table": table})
        except RuntimeError as e:
            raise DraftUnavailable(str(e)) from e

        # 2. catch-up chunks until every remainder fits the propose run.
        while True:
            longs = [i for i in infos
                     if len(i["ctx"]) - len(i["st"].tokens) > PROPOSE_RUN]
            if not longs:
                break
            per_row = max((engine.ragged_tokens // len(longs))
                          // RAGGED_BLOCK_Q * RAGGED_BLOCK_Q,
                          RAGGED_BLOCK_Q)
            seqs, feeds = [], []
            for i in longs:
                done = len(i["st"].tokens)
                rem = len(i["ctx"]) - done
                take = min(rem - PROPOSE_RUN, per_row)
                if take < 1:
                    continue
                chunk = i["ctx"][done:done + take]
                seqs.append(RaggedSeq(chunk, done, i["table"],
                                      temperature=temps,
                                      adapter=self.adapter_slot))
                feeds.append((i, chunk))
            if not seqs:
                break
            want = sum(-(-len(s.tokens) // RAGGED_BLOCK_Q)
                       * RAGGED_BLOCK_Q for s in seqs)
            shape = ragged_pick_shape(engine.ragged_shapes,
                                      min(want, engine.ragged_tokens))
            read(dispatch(self._batch(engine, seqs, shape)))
            self.draft_dispatches += 1
            for i, chunk in feeds:
                i["st"].tokens = i["st"].tokens + chunk

        # 3. the propose dispatch: remainder runs (1..PROPOSE_RUN tokens)
        # score the context tip; top ids seed the root branches.
        branch_max = max(i["branch"] for i in infos)
        seqs = []
        for i in infos:
            done = len(i["st"].tokens)
            rem = i["ctx"][done:]
            if not rem:
                # Fully caught up (a verify failed after the previous
                # propose advanced the slot): re-feed the last context
                # token - the same K/V bytes at its own position.
                done -= 1
                rem = i["ctx"][-1:]
            assert 1 <= len(rem) <= PROPOSE_RUN
            seqs.append(RaggedSeq(rem, done, i["table"],
                                  temperature=temps,
                                  adapter=self.adapter_slot))
        shape = ragged_pick_shape(
            engine.ragged_shapes,
            min(RAGGED_BLOCK_Q * len(seqs), engine.ragged_tokens))
        out = read(dispatch(self._batch(
            engine, seqs, shape,
            propose_width=(branch_max if branch_max > 1 else 0))))
        self.draft_dispatches += 1
        if branch_max > 1:
            nxt, tops = out
        else:
            nxt, tops = out, None
        for idx, i in enumerate(infos):
            # A snapshot, never an alias of the scheduler's growing cache.
            i["st"].tokens = list(i["ctx"])
            c1 = int(nxt[idx])
            i["main"] = [c1]
            alts = []
            if tops is not None:
                for t in list(tops[idx])[:i["branch"]]:
                    t = int(t)
                    if t != c1 and t not in alts:
                        alts.append(t)
            i["alts"] = alts[:max(i["branch"] - 1, 0)]

        # 4. extend the main chain through the draft model.
        max_depth = max(i["depth"] for i in infos)
        for step in range(1, max_depth):
            seqs, growing = [], []
            for i in infos:
                if i["depth"] <= step:
                    continue
                pos = len(i["ctx"]) + step - 1
                seqs.append(RaggedSeq([i["main"][-1]], pos, i["table"],
                                      temperature=temps,
                                      adapter=self.adapter_slot))
                growing.append(i)
            if not seqs:
                break
            shape = ragged_pick_shape(
                engine.ragged_shapes,
                min(RAGGED_BLOCK_Q * len(seqs), engine.ragged_tokens))
            nxt = read(dispatch(self._batch(engine, seqs, shape)))
            self.draft_dispatches += 1
            for idx, i in enumerate(growing):
                i["main"].append(int(nxt[idx]))

        return {i["key"]: [i["main"]] + [[t] for t in i["alts"]]
                for i in infos}


# --- test-visibility counters ---

_lock = threading.Lock()
_drafted = 0
_accepted = 0
_dispatches = 0
_tree_accepted_paths = 0
_tree_nodes = 0
_reprobes = 0
_reprobe_recoveries = 0


def reset_test_counters() -> None:
    global _drafted, _accepted, _dispatches, _tree_accepted_paths
    global _tree_nodes, _reprobes, _reprobe_recoveries
    with _lock:
        _drafted = _accepted = _dispatches = 0
        _tree_accepted_paths = _tree_nodes = 0
        _reprobes = _reprobe_recoveries = 0


def note_spec_dispatch(drafted: int, accepted: int) -> None:
    global _drafted, _accepted, _dispatches
    with _lock:
        _drafted += drafted
        _accepted += accepted
        _dispatches += 1


def note_tree_row(nodes: int, accepted_edges: int) -> None:
    """One tree row through a verify dispatch: `nodes` tree nodes packed,
    `accepted_edges` edges the walk accepted (a path of >= 2 accepted
    edges counts as a tree-accepted path)."""
    global _tree_nodes, _tree_accepted_paths
    with _lock:
        _tree_nodes += nodes
        if accepted_edges >= 2:
            _tree_accepted_paths += 1


def note_spec_reprobe(recovered: bool) -> None:
    global _reprobes, _reprobe_recoveries
    with _lock:
        _reprobes += 1
        if recovered:
            _reprobe_recoveries += 1


def drafted_seen() -> int:
    return _drafted


def accepted_seen() -> int:
    return _accepted


def dispatches_seen() -> int:
    return _dispatches


def tree_accepted_paths_seen() -> int:
    return _tree_accepted_paths


def tree_nodes_seen() -> int:
    return _tree_nodes


def reprobes_seen() -> int:
    return _reprobes


def reprobe_recoveries_seen() -> int:
    return _reprobe_recoveries
