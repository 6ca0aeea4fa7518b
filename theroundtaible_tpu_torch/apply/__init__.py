"""The apply subsystem — Lead Knight executes the consensus decision.

Reimplements the reference's documented-but-absent apply pipeline
(reference README.md:159-207, TODO.md:87-138, architecture-docs.md:215-219;
SURVEY.md §2.2): block-level RTDIFF/1 edits produced by an LLM against a
BLOCK_MAP of the target files, validated, scope-enforced, backed up, and
written with per-file parley approval.
"""

from .blocks import Block, scan_blocks, render_block_map
from .rtdiff import (
    ApplyOp,
    FileEdit,
    ParseError,
    parse_knight_output,
)
from .validate import ValidationIssue, validate_edits
from .executor import ApplyOutcome, apply_edits, materialize_edit
