"""Shared data types for the roundtable core.

Behavioral parity with reference src/types.ts:1-149, re-expressed as Python
dataclasses. These types are the contract between the orchestrator, the
consensus engine, the adapters, and the on-disk ``.roundtable/`` store — the
JSON shapes written to disk match the reference byte-for-byte so a user's
existing ``.roundtable/`` project directory keeps working.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import Any, Optional

# Caps shared with the reference (src/types.ts:56-57, src/orchestrator.ts:171):
MAX_FILE_REQUESTS_PER_ROUND = 4
MAX_VERIFY_COMMANDS_PER_ROUND = 4


def format_score(score: float) -> str:
    """Render a consensus score the way the reference's JS does: integral
    values without a decimal point (9, not 9.0), fractional as-is."""
    return str(int(score)) if float(score).is_integer() else str(score)


@dataclass
class KnightConfig:
    """One seat at the table (reference src/types.ts:1-7)."""

    name: str
    adapter: str
    capabilities: list[str] = field(default_factory=list)
    priority: int = 1
    fallback: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "KnightConfig":
        return cls(
            name=d["name"],
            adapter=d["adapter"],
            capabilities=list(d.get("capabilities", [])),
            priority=int(d.get("priority", 1)),
            fallback=d.get("fallback"),
        )

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "name": self.name,
            "adapter": self.adapter,
            "capabilities": self.capabilities,
            "priority": self.priority,
        }
        if self.fallback:
            d["fallback"] = self.fallback
        return d


@dataclass
class RulesConfig:
    """Discussion rules (reference src/types.ts:9-16; defaults init.ts:204-220)."""

    max_rounds: int = 5
    consensus_threshold: int = 9
    timeout_per_turn_seconds: int = 120
    escalate_to_user_after: int = 3
    auto_execute: bool = False
    ignore: list[str] = field(
        default_factory=lambda: [".git", "node_modules", "dist", "build", ".next"]
    )
    # TPU-build extension: when true and all knights share one batch-capable
    # adapter (tpu-llm), each round is ONE batched forward pass — knights
    # speak simultaneously instead of seeing same-round earlier turns.
    parallel_rounds: bool = False
    # Time-ladder roots (engine/deadlines.py): hard wall-clock
    # budgets for the whole discussion and for each round. None (the
    # default, and the reference's behavior) = unbounded; the per-turn
    # timeout remains the only clock. When set, run_discussion derives
    # the round budgets from the discussion budget top-down and returns
    # PARTIAL results (escalated, transcript intact) when the discussion
    # budget is exhausted instead of running the window into a hard kill.
    discussion_budget_seconds: Optional[float] = None
    round_budget_seconds: Optional[float] = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "RulesConfig":
        default = cls()
        return cls(
            max_rounds=int(d.get("max_rounds", default.max_rounds)),
            consensus_threshold=int(
                d.get("consensus_threshold", default.consensus_threshold)
            ),
            timeout_per_turn_seconds=int(
                d.get("timeout_per_turn_seconds", default.timeout_per_turn_seconds)
            ),
            escalate_to_user_after=int(
                d.get("escalate_to_user_after", default.escalate_to_user_after)
            ),
            auto_execute=bool(d.get("auto_execute", default.auto_execute)),
            ignore=list(d.get("ignore", default.ignore)),
            parallel_rounds=bool(d.get("parallel_rounds",
                                       default.parallel_rounds)),
            discussion_budget_seconds=(
                float(d["discussion_budget_seconds"])
                if d.get("discussion_budget_seconds") else None),
            round_budget_seconds=(
                float(d["round_budget_seconds"])
                if d.get("round_budget_seconds") else None),
        )

    def to_dict(self) -> dict[str, Any]:
        d = asdict(self)
        # Unset budgets are omitted so a config written before the keys
        # existed round-trips byte-identically (reference schema parity).
        for key in ("discussion_budget_seconds", "round_budget_seconds"):
            if d[key] is None:
                del d[key]
        return d


@dataclass
class RoundtableConfig:
    """Project config, `.roundtable/config.json` (reference src/types.ts:38-46).

    ``adapter_config`` values are kept as raw dicts: the shape is adapter-kind
    dependent (CLI {command,args,model?} / API {model,env_key} / local
    {endpoint,model,name?,source?} / tpu-llm {checkpoint,mesh,…} — reference
    src/types.ts:18-36 plus our new variant).
    """

    version: str
    project: str
    language: str
    knights: list[KnightConfig]
    rules: RulesConfig
    chronicle: str
    adapter_config: dict[str, dict[str, Any]]

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "RoundtableConfig":
        return cls(
            version=d.get("version", "1.0"),
            project=d.get("project", ""),
            # The reference defaults to "nl" (src/types.ts via init.ts:246),
            # but here `language` actually selects templates, so a config
            # written before the key existed must keep getting English —
            # init, the example config, and the prompt builders all say "en".
            language=d.get("language", "en"),
            knights=[KnightConfig.from_dict(k) for k in d.get("knights", [])],
            rules=RulesConfig.from_dict(d.get("rules", {})),
            chronicle=d.get("chronicle", ".roundtable/chronicle.md"),
            adapter_config=dict(d.get("adapter_config", {})),
        )

    def to_dict(self) -> dict[str, Any]:
        return {
            "version": self.version,
            "project": self.project,
            "language": self.language,
            "knights": [k.to_dict() for k in self.knights],
            "rules": self.rules.to_dict(),
            "chronicle": self.chronicle,
            "adapter_config": self.adapter_config,
        }


@dataclass
class ConsensusBlock:
    """The structured tail of every knight turn (reference src/types.ts:48-58)."""

    knight: str
    round: int
    consensus_score: float
    agrees_with: list[str] = field(default_factory=list)
    pending_issues: list[str] = field(default_factory=list)
    proposal: Optional[str] = None
    files_to_modify: list[str] = field(default_factory=list)
    file_requests: list[str] = field(default_factory=list)
    verify_commands: list[str] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "knight": self.knight,
            "round": self.round,
            "consensus_score": self.consensus_score,
            "agrees_with": self.agrees_with,
            "pending_issues": self.pending_issues,
        }
        if self.proposal is not None:
            d["proposal"] = self.proposal
        d["files_to_modify"] = self.files_to_modify
        d["file_requests"] = self.file_requests
        d["verify_commands"] = self.verify_commands
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ConsensusBlock":
        return cls(
            knight=d.get("knight", ""),
            round=int(d.get("round", 0)),
            consensus_score=d.get("consensus_score", 0),
            agrees_with=list(d.get("agrees_with", [])),
            pending_issues=list(d.get("pending_issues", [])),
            proposal=d.get("proposal"),
            files_to_modify=list(d.get("files_to_modify", [])),
            file_requests=list(d.get("file_requests", [])),
            verify_commands=list(d.get("verify_commands", [])),
        )


@dataclass
class RoundEntry:
    """One knight turn in the transcript (reference src/types.ts:60-66)."""

    knight: str
    round: int
    response: str
    consensus: Optional[ConsensusBlock]
    timestamp: str

    def to_dict(self) -> dict[str, Any]:
        return {
            "knight": self.knight,
            "round": self.round,
            "response": self.response,
            "consensus": self.consensus.to_dict() if self.consensus else None,
            "timestamp": self.timestamp,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "RoundEntry":
        consensus = d.get("consensus")
        return cls(
            knight=d["knight"],
            round=int(d["round"]),
            response=d.get("response", ""),
            consensus=ConsensusBlock.from_dict(consensus) if consensus else None,
            timestamp=d.get("timestamp", ""),
        )


# Session phases (reference src/types.ts:68-71). "applying"/"completed" are
# used by the apply subsystem (reference README.md:159-207).
SESSION_PHASES = (
    "discussing",
    "consensus_reached",
    "escalated",
    "applying",
    "completed",
)


@dataclass
class SessionStatus:
    """`status.json` schema (reference src/types.ts:73-83)."""

    phase: str
    current_knight: Optional[str]
    round: int
    consensus_reached: bool
    started_at: str
    updated_at: str
    lead_knight: Optional[str] = None
    decisions_hash: Optional[str] = None
    allowed_files: Optional[list[str]] = None
    # Written only when True so pre-existing status.json files (and the
    # reference's schema, src/types.ts:73-83) round-trip byte-identically.
    # The reference loses this distinction after the process exits
    # (orchestrator.ts:616 writes the same phase for rejection); persisting
    # it lets `status`/`list` render rejection distinctly afterward.
    unanimous_rejection: bool = False

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "phase": self.phase,
            "current_knight": self.current_knight,
            "round": self.round,
            "consensus_reached": self.consensus_reached,
            "started_at": self.started_at,
            "updated_at": self.updated_at,
        }
        if self.lead_knight is not None:
            d["lead_knight"] = self.lead_knight
        if self.decisions_hash is not None:
            d["decisions_hash"] = self.decisions_hash
        if self.allowed_files is not None:
            d["allowed_files"] = self.allowed_files
        if self.unanimous_rejection:
            d["unanimous_rejection"] = True
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SessionStatus":
        return cls(
            phase=d.get("phase", "discussing"),
            current_knight=d.get("current_knight"),
            round=int(d.get("round", 0)),
            consensus_reached=bool(d.get("consensus_reached", False)),
            started_at=d.get("started_at", ""),
            updated_at=d.get("updated_at", ""),
            lead_knight=d.get("lead_knight"),
            decisions_hash=d.get("decisions_hash"),
            allowed_files=d.get("allowed_files"),
            unanimous_rejection=bool(d.get("unanimous_rejection", False)),
        )


@dataclass
class SessionResult:
    """Return value of a discussion run (reference src/types.ts:85-98)."""

    session_path: str
    consensus: bool
    rounds: int
    decision: Optional[str]
    blocks: list[ConsensusBlock]
    all_rounds: list[RoundEntry]
    unanimous_rejection: bool = False
    resolved_files: str = ""
    resolved_commands: str = ""


@dataclass
class ContinueOptions:
    """State for re-entering a session (reference src/types.ts:101-107).

    Two users: the King's "send back" (unchanged reference behavior,
    king_demand=True injects the unanimity ultimatum into every prompt)
    and crash resume via `discuss --continue` (king_demand=False — the
    knights just pick up where the dead process stopped; reference marks
    this future work at TODO.md:179)."""

    session_path: str
    all_rounds: list[RoundEntry]
    start_round: int
    resolved_files: str = ""
    resolved_commands: str = ""
    king_demand: bool = True


# --- Manifest types (reference src/types.ts:109-129) ---

MANIFEST_STATUSES = ("implemented", "partial", "deprecated")


@dataclass
class ManifestEntry:
    id: str
    session: str
    status: str
    files: list[str]
    summary: str
    applied_at: str
    lead_knight: str
    files_skipped: Optional[list[str]] = None
    replaced_by: Optional[str] = None

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "id": self.id,
            "session": self.session,
            "status": self.status,
            "files": self.files,
        }
        if self.files_skipped is not None:
            d["files_skipped"] = self.files_skipped
        d.update(
            {
                "summary": self.summary,
                "applied_at": self.applied_at,
                "lead_knight": self.lead_knight,
            }
        )
        if self.replaced_by is not None:
            d["replaced_by"] = self.replaced_by
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ManifestEntry":
        return cls(
            id=d["id"],
            session=d.get("session", ""),
            status=d.get("status", "implemented"),
            files=list(d.get("files", [])),
            summary=d.get("summary", ""),
            applied_at=d.get("applied_at", ""),
            lead_knight=d.get("lead_knight", ""),
            files_skipped=d.get("files_skipped"),
            replaced_by=d.get("replaced_by"),
        )


@dataclass
class Manifest:
    version: str = "1.0"
    last_updated: str = ""
    features: list[ManifestEntry] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "version": self.version,
            "last_updated": self.last_updated,
            "features": [f.to_dict() for f in self.features],
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Manifest":
        return cls(
            version=d.get("version", "1.0"),
            last_updated=d.get("last_updated", ""),
            features=[ManifestEntry.from_dict(f) for f in d.get("features", [])],
        )


# --- Decree Log types (reference src/types.ts:131-148) ---

DECREE_TYPES = ("rejected_no_apply", "deferred")


@dataclass
class DecreeEntry:
    id: str
    type: str
    session: str
    topic: str
    reason: str
    revoked: bool
    date: str

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "DecreeEntry":
        return cls(
            id=d["id"],
            type=d.get("type", "deferred"),
            session=d.get("session", ""),
            topic=d.get("topic", ""),
            reason=d.get("reason", ""),
            revoked=bool(d.get("revoked", False)),
            date=d.get("date", ""),
        )


@dataclass
class DecreeLog:
    version: str = "1.0"
    entries: list[DecreeEntry] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "version": self.version,
            "entries": [e.to_dict() for e in self.entries],
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "DecreeLog":
        return cls(
            version=d.get("version", "1.0"),
            entries=[DecreeEntry.from_dict(e) for e in d.get("entries", [])],
        )
