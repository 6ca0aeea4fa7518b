"""`torch-llm` adapter - knights served by the in-tree PyTorch/CUDA engine
(counterpart of theroundtaible_tpu/adapters/tpu_llm.py TpuLlmAdapter).

A thin host-side shim: the knights of a round go to the engine as one
batch over their persistent per-knight KV slots. It reads the same
adapter_config keys as the tpu-llm adapter. Fault tolerance is the same
ladder: a failed batched round invalidates the batch's slots and retries
the knights serially inside the round's remaining budget; every final
outcome feeds the engine's shared circuit breaker, and an open breaker
makes is_available() False with its reason. With a SessionScheduler
attached (attach_scheduler), every rung - the batched attempt and the
serial retries - goes through the scheduler's queue instead of the engine.
LoRA personas: `lora_adapter` names the adapter-level persona and
`knight_adapters: {name: id}` overrides it per seat; a round's persona ids
ride into the engine or the scheduler only when the engine serves LoRA, so
an engine without a store (no `lora:` block, or ROUNDTABLE_LORA=0) keeps
the exact base-model call.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

from ..core.errors import AdapterError, classify_error
from ..engine import deadlines
from .base import DEFAULT_TIMEOUT_MS, BaseAdapter, KnightTurn

RESPONSE_RESERVE_TOKENS = 4096
OVERHEAD_RESERVE_TOKENS = 3000
MIN_AVAILABLE_TOKENS = 2000

# Fraction of a multi-knight round's budget the BATCHED attempt may use,
# so a wedged batch leaves the serial-retry rung real time. Config key
# "batch_budget_fraction" overrides; single-turn rounds get it all.
BATCH_BUDGET_FRACTION = 0.6


def _engine_serves_lora(engine) -> bool:
    """True when the engine resolved an adapter store: only then does a
    round pass `adapters_per_turn`."""
    return getattr(engine, "lora", None) is not None


class TorchLlmAdapter(BaseAdapter):
    """BaseAdapter over the port's engine (theroundtaible_tpu_torch.engine).
    `device` is where the engine runs: the card unless the caller asks for
    the CPU."""

    accepts_budget = True

    def __init__(self, name: str, engine_config: dict[str, Any],
                 timeout_ms: int = DEFAULT_TIMEOUT_MS,
                 session: Optional[str] = None, device="cuda"):
        super().__init__(name)
        self.engine_config = dict(engine_config)
        self.default_timeout = timeout_ms
        # Namespaces this adapter's KV slot names (kvcache.scoped_slot).
        self.session = session
        self.device = device
        # The LoRA persona this adapter's knights speak through on a
        # shared-base engine (None: the base model); `knight_adapters`
        # overrides it per seat.
        self.persona_adapter = engine_config.get("lora_adapter")
        self._engine = None
        self._engine_error: Optional[str] = None
        self._scheduler = None
        self._last_stats: Optional[dict] = None
        # Which degradation rung served the last round ("serial_retry").
        self.last_degradation: Optional[str] = None
        # Classified kind of the failure the last round recovered from.
        self.last_recovered_kind: Optional[str] = None

    @classmethod
    def from_config(cls, adapter_id: str, cfg: dict[str, Any],
                    timeout_ms: int = DEFAULT_TIMEOUT_MS,
                    device="cuda") -> "TorchLlmAdapter":
        return cls(name=cfg.get("name", adapter_id), engine_config=cfg,
                   timeout_ms=timeout_ms, device=device)

    # --- engine lifecycle + health ---

    def breaker(self):
        """The engine-cache-shared CircuitBreaker for this config."""
        from ..engine import get_breaker
        return get_breaker(self.engine_config, self.device)

    def _get_engine(self, retry_construction: bool = False):
        if (retry_construction and self._engine is None
                and self._engine_error is not None):
            # Admitted by the breaker: a memoized construction failure
            # gets a fresh attempt.
            self._engine_error = None
        if self._engine is None and self._engine_error is None:
            try:
                from ..engine import get_engine
                self._engine = get_engine(self.engine_config, self.device)
            except Exception as e:  # noqa: BLE001 - surfaced via is_available
                self._engine_error = str(e)
                # A construction failure is permanent: open the breaker.
                self.breaker().trip(e)
        if self._engine is None:
            raise AdapterError(
                f"torch engine unavailable: {self._engine_error}",
                kind=classify_error(RuntimeError(self._engine_error or "")))
        return self._engine

    def attach_scheduler(self, scheduler,
                         session: Optional[str] = None) -> None:
        """Route this adapter's rounds through a shared continuous-batching
        SessionScheduler (engine/scheduler.py): the batched attempt and the
        per-knight serial retries then both go through its queue, so a
        degraded session keeps co-scheduling with healthy ones.

        A scheduled adapter always has a session id: with none given (and
        none set) a unique one is generated - the adapter name is not
        unique, and two adapters sharing a name would share an isolation
        domain."""
        self._scheduler = scheduler
        if session is not None:
            self.session = session
        elif not self.session:
            import uuid
            self.session = f"{self.name}-{uuid.uuid4().hex[:8]}"

    def _effective_session(self) -> Optional[str]:
        """The session namespace the engine-side slots live under; _serve
        and _slot_name must agree, or serial-retry slot invalidation would
        release a name the scheduler never allocated."""
        return self.session

    def _serve(self, engine, turn_pairs, **kwargs):
        """The one engine-call seam: scheduled sessions submit to the
        shared batch; unscheduled calls hit the engine directly with the
        session namespace applied."""
        if self._scheduler is not None:
            return self._scheduler.submit(
                self._effective_session(), turn_pairs, **kwargs)
        return engine.generate_batch_with_stats(
            turn_pairs, session=self.session, **kwargs)

    def _slot_name(self, knight_name: str) -> str:
        """The engine-side slot name for a knight of THIS session."""
        from ..engine.kvcache import scoped_slot
        return scoped_slot(self._effective_session(), knight_name)

    def known_unhealthy(self) -> bool:
        return self.breaker().is_open or self._engine_error is not None

    def is_available(self) -> bool:
        if self.breaker().is_open:
            return False
        try:
            self._get_engine()
            return True
        except AdapterError:
            return False

    def unavailable_reason(self) -> Optional[str]:
        """Why is_available() is False: the open breaker's reason, or the
        engine construction error."""
        reason = self.breaker().reason
        return reason if reason else self._engine_error

    # --- serving ---

    def get_max_source_chars(self) -> Optional[int]:
        """Budget from the engine's max_seq_len and its tokenizer's
        chars-per-token ratio."""
        try:
            engine = self._get_engine()
        except AdapterError:
            return None
        available = max(engine.max_seq_len - RESPONSE_RESERVE_TOKENS
                        - OVERHEAD_RESERVE_TOKENS, MIN_AVAILABLE_TOKENS)
        return int(available * engine.chars_per_token())

    def execute(self, prompt: str,
                timeout_ms: int = DEFAULT_TIMEOUT_MS) -> str:
        return self.execute_for(self.name, prompt, timeout_ms)

    def execute_for(self, knight_name: str, prompt: str,
                    timeout_ms: int = DEFAULT_TIMEOUT_MS,
                    budget=None) -> str:
        # Keyed by the KNIGHT, so a knight degraded to serial turns keeps
        # its own KV slot and sampling.
        return self.execute_round(
            [KnightTurn(knight_name=knight_name, prompt=prompt)],
            timeout_ms, budget=budget)[0]

    def supports_batched_rounds(self) -> bool:
        return True

    def _adapter_for(self, knight_name: str) -> Optional[str]:
        """A seat's LoRA persona id: `knight_adapters` first, then the
        adapter-level `lora_adapter`."""
        overrides = self.engine_config.get("knight_adapters", {})
        return overrides.get(knight_name, self.persona_adapter)

    def _adapters_for(self, turns) -> Optional[list]:
        """Per-turn persona ids of a round, or None when every seat serves
        the base model (the call then keeps its base-model signature)."""
        ads = [self._adapter_for(t.knight_name) for t in turns]
        return ads if any(a is not None for a in ads) else None

    def _sampling_for(self, knight_name: str):
        """Per-knight SamplingParams from `knight_sampling: {name: {...}}`,
        over the engine default; None when the knight has no override."""
        cfg = self.engine_config.get("knight_sampling", {}).get(knight_name)
        if not cfg:
            return None
        from ..engine.sampling import SamplingParams
        base = self._get_engine().sampling
        return SamplingParams(
            temperature=float(cfg.get("temperature", base.temperature)),
            top_k=int(cfg.get("top_k", base.top_k)),
            top_p=float(cfg.get("top_p", base.top_p)),
            max_new_tokens=int(cfg.get("max_new_tokens",
                                       base.max_new_tokens)))

    def execute_round(self, turns: list[KnightTurn],
                      timeout_ms: int = DEFAULT_TIMEOUT_MS,
                      budget=None) -> list[str]:
        """One batched pass over N persistent per-knight KV slots.

        A failed batched dispatch degrades to serial per-knight retry; the
        outcome is recorded on the engine's circuit breaker. `budget` is
        the round-rung Budget (None builds a root from timeout_ms), split
        across the batched attempt and the serial retries."""
        breaker = self.breaker()
        self._last_stats = None
        self.last_degradation = None
        self.last_recovered_kind = None
        if not breaker.should_attempt():
            reason = breaker.reason or ""
            raise AdapterError(f"torch engine unavailable: {reason}",
                               kind=classify_error(RuntimeError(reason)))
        engine = self._get_engine(retry_construction=True)
        per_turn = None
        if self.engine_config.get("knight_sampling"):
            per_turn = [self._sampling_for(t.knight_name) or engine.sampling
                        for t in turns]
        timeout_s = (timeout_ms or self.default_timeout) / 1000
        round_budget = (budget.child("round", timeout_s=timeout_s)
                        if budget is not None
                        else deadlines.Budget.root(timeout_s, rung="round"))
        try:
            responses, stats = self._dispatch_round(engine, turns, per_turn,
                                                    round_budget)
        except Exception as e:  # noqa: BLE001
            breaker.record_failure(e)
            if isinstance(e, AdapterError):
                raise
            raise AdapterError(str(e), kind=classify_error(e), cause=e)
        breaker.record_success()
        # per-call snapshot, not engine.last_stats (shared engine)
        self._last_stats = {
            "model": engine.cfg.name,
            "prefill_tokens": stats.prefill_tokens,
            "reused_tokens": stats.reused_tokens,
            "prefix_reused_tokens": stats.prefix_reused_tokens,
            "decode_tokens": stats.decode_tokens,
            "prefill_seconds": round(stats.prefill_seconds, 3),
            "decode_seconds": round(stats.decode_seconds, 3),
            "prefill_tps": round(stats.prefill_tps, 1),
            "decode_tps": round(stats.decode_tps, 1),
        }
        if self.last_degradation:
            self._last_stats["degraded"] = self.last_degradation
        if self.last_recovered_kind:
            self._last_stats["recovered_from"] = self.last_recovered_kind
        return responses

    def _dispatch_round(self, engine, turns, per_turn, round_budget):
        if len(turns) > 1:
            frac = float(self.engine_config.get(
                "batch_budget_fraction", BATCH_BUDGET_FRACTION))
            batch_budget = round_budget.child(
                "turn", timeout_s=round_budget.remaining() * frac)
        else:
            batch_budget = round_budget.child("turn")
        kwargs: dict[str, Any] = {
            "timeout_s": max(batch_budget.remaining(), 0.0),
            "budget": batch_budget}
        ads = self._adapters_for(turns)
        if ads is not None and _engine_serves_lora(engine):
            # Knights of different personas decode in one mixed-adapter
            # batch; engines without a store serve the base model.
            kwargs["adapters_per_turn"] = ads
        if per_turn is not None:
            kwargs["sampling_per_turn"] = per_turn
            # call-level cap = the LARGEST per-knight budget; row budgets
            # bound each row below it
            kwargs["max_new_tokens"] = max(p.max_new_tokens
                                           for p in per_turn)
        try:
            return self._serve(
                engine, [(t.knight_name, t.prompt) for t in turns], **kwargs)
        except Exception as batch_err:  # noqa: BLE001
            if len(turns) < 2:
                raise
            return self._serial_retry(engine, turns, per_turn,
                                      round_budget, batch_err)

    def _serial_retry(self, engine, turns, per_turn, round_budget,
                      batch_err):
        """Batched-round degradation rung: invalidate the batch's KV slots
        (a mid-flight failure may have left partial writes) and serve each
        knight as its own single-row batch, each with a fair share of the
        round's remaining budget. Knights that fail are collected; the
        rest still serve."""
        if round_budget.remaining() <= 0:
            # No time to retry: keep the knights' cached KV for next round.
            raise AdapterError(
                f"batched round failed ({batch_err}) and the round's "
                "deadline passed before serial retry could start",
                kind="timeout")
        warnings.warn(
            f"batched round failed ({batch_err}); invalidating the "
            f"batch's KV slots and retrying {len(turns)} knight(s) "
            "serially", stacklevel=3)
        for t in turns:
            engine.kv.release(self._slot_name(t.knight_name))
        from ..engine.engine import GenStats
        total = GenStats()
        responses = []
        failures: list[tuple[str, Exception]] = []
        for i, t in enumerate(turns):
            remaining = round_budget.remaining()
            if remaining <= 0:
                raise AdapterError(
                    f"batched round failed ({batch_err}) and the round's "
                    f"deadline passed during serial retry at knight "
                    f"{t.knight_name}", kind="timeout")
            knight_budget = round_budget.child(
                "turn", timeout_s=remaining / (len(turns) - i))
            kwargs: dict[str, Any] = {
                "timeout_s": max(knight_budget.remaining(), 0.0),
                "budget": knight_budget}
            ad = self._adapter_for(t.knight_name)
            if ad is not None and _engine_serves_lora(engine):
                kwargs["adapters_per_turn"] = [ad]
            if per_turn is not None:
                kwargs["sampling_per_turn"] = [per_turn[i]]
                kwargs["max_new_tokens"] = per_turn[i].max_new_tokens
            try:
                out, stats = self._serve(
                    engine, [(t.knight_name, t.prompt)], **kwargs)
            except Exception as serial_err:  # noqa: BLE001
                failures.append((t.knight_name, serial_err))
                continue
            responses.append(out[0])
            total.prefill_tokens += stats.prefill_tokens
            total.reused_tokens += stats.reused_tokens
            total.decode_tokens += stats.decode_tokens
            total.prefill_seconds += stats.prefill_seconds
            total.decode_seconds += stats.decode_seconds
        if failures:
            names = ", ".join(n for n, _ in failures)
            first = failures[0][1]
            raise AdapterError(
                f"batched round failed ({batch_err}) and serial retry "
                f"failed for knight(s) {names}: {first}",
                kind=classify_error(first), cause=first)
        self.last_degradation = "serial_retry"
        self.last_recovered_kind = classify_error(batch_err)
        return responses, total

    def last_stats(self) -> Optional[dict]:
        return self._last_stats
