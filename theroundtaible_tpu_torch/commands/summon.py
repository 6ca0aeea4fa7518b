"""`roundtable summon` — review the current git diff (counterpart of
theroundtaible_tpu/commands/summon.py; engine knights run on `device=`).

Parity with reference src/commands/summon.ts:10-52.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..core.config import load_config
from ..utils.git import get_git_branch, get_git_diff, get_recent_commits
from ..utils.ui import style
from .discuss import discuss_command

DIFF_PREVIEW_CHARS = 500


def summon_command(project_root: Optional[str] = None,
                   read_code: Optional[bool] = None,
                   device="cuda") -> int:
    project_root = project_root or os.getcwd()
    load_config(project_root)  # existence/validity check; errors propagate

    print(style.dim("\n  Reading the git scrolls...\n"))
    with ThreadPoolExecutor(max_workers=3) as pool:
        diff_f = pool.submit(get_git_diff, project_root)
        branch_f = pool.submit(get_git_branch, project_root)
        commits_f = pool.submit(get_recent_commits, 3, project_root)
        diff, branch, commits = diff_f.result(), branch_f.result(), \
            commits_f.result()

    if not diff:
        print(style.yellow("  Nothing to review. The code rests in peace."))
        print(style.dim("  Make some changes first, then summon again.\n"))
        return 0

    file_count = len(re.findall(r"^diff --git", diff, re.MULTILINE))
    print(style.dim(f"  Branch: {branch or 'unknown'}"))
    print(style.dim(f"  Changed files: {file_count}"))
    if commits:
        print(style.dim("  Recent commits:"))
        for line in commits.split("\n")[:3]:
            print(style.dim(f"    {line}"))

    diff_preview = " ".join(diff[:DIFF_PREVIEW_CHARS].split())
    topic = (f'Review the current changes on branch "{branch or "unknown"}". '
             f"{file_count} file(s) changed. Diff preview: {diff_preview}")

    print(style.bold("\n  The knights shall review your changes...\n"))
    return discuss_command(topic, read_code=read_code,
                           project_root=project_root, device=device)
