"""Project context builder — chronicle + git + key files + source files.

Parity with reference src/utils/context.ts:1-187: recursive walk with ignore
patterns, key-file reader (2KB each, max 5), source reader (whitelist
extensions, exclude lockfiles/.env, max 30 files, char-budget truncation with
an overflow warning surfaced through a callback).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from ..core.types import RoundtableConfig
from .chronicle import read_chronicle
from .git import get_git_branch, get_git_diff, get_recent_commits

KEY_FILE_PATTERNS = ("package.json", "tsconfig.json", "README.md", "CLAUDE.md",
                     "pyproject.toml", "setup.py")
KEY_FILE_CHAR_LIMIT = 2000
MAX_KEY_FILES = 5

SOURCE_EXTENSIONS = (".ts", ".tsx", ".js", ".jsx", ".py", ".rs", ".go",
                     ".java", ".json", ".c", ".cc", ".cpp", ".h")
SOURCE_EXCLUDE = ("package-lock.json", "yarn.lock", "pnpm-lock.yaml",
                  "bun.lockb", ".env", ".env.local")
MAX_SOURCE_FILES = 30
DEFAULT_MAX_SOURCE_CHARS = 200_000


def get_project_files(root_dir: str | Path, ignore_patterns: list[str]
                      ) -> list[str]:
    """Recursive walk honoring ignore patterns (reference context.ts:12-46)."""
    root_dir = Path(root_dir)
    files: list[str] = []

    def ignored(rel_path: str, name: str) -> bool:
        return any(
            rel_path.startswith(p) or name == p or f"/{p}/" in rel_path
            for p in ignore_patterns
        )

    for dirpath, dirnames, filenames in os.walk(root_dir):
        rel_dir = os.path.relpath(dirpath, root_dir)
        # prune ignored directories in place so walk skips them
        dirnames[:] = [
            d for d in dirnames
            if not ignored(os.path.normpath(os.path.join(rel_dir, d))
                           if rel_dir != "." else d, d)
        ]
        for fname in filenames:
            rel = os.path.normpath(os.path.join(rel_dir, fname)) \
                if rel_dir != "." else fname
            if not ignored(rel, fname):
                files.append(rel)
    return files


def read_key_files(root_dir: str | Path, files: list[str]) -> str:
    """Common config/readme files, 2KB each, max 5 (reference context.ts:52-81)."""
    key_files = [f for f in files
                 if any(f.endswith(p) for p in KEY_FILE_PATTERNS)]
    contents: list[str] = []
    for file in key_files[:MAX_KEY_FILES]:
        try:
            content = (Path(root_dir) / file).read_text(
                encoding="utf-8", errors="replace")
        except OSError:
            continue
        if len(content) > KEY_FILE_CHAR_LIMIT:
            content = content[:KEY_FILE_CHAR_LIMIT] + "\n...(truncated)"
        contents.append(f"### {file}\n```\n{content}\n```")
    return "\n\n".join(contents)


def read_source_files(
    project_root: str | Path, ignore_patterns: list[str],
    max_chars: int = 50_000,
    on_overflow: Optional[Callable[[int, int], None]] = None,
) -> str:
    """Source whitelist read under a char budget (reference context.ts:108-149).

    ``on_overflow(skipped_count, max_chars)`` fires when files were dropped.
    """
    files = get_project_files(project_root, ignore_patterns)
    source_files = [
        f for f in files
        if any(f.endswith(ext) for ext in SOURCE_EXTENSIONS)
        and not any(f.endswith(ex) for ex in SOURCE_EXCLUDE)
    ][:MAX_SOURCE_FILES]

    contents: list[str] = []
    total = 0
    overflowed = 0  # files skipped entirely or cut mid-file by the budget
    for file in source_files:
        if total >= max_chars:
            overflowed += 1
            continue
        try:
            content = (Path(project_root) / file).read_text(
                encoding="utf-8", errors="replace")
        except OSError:
            continue
        truncated = content[:max_chars - total]
        if len(truncated) < len(content):
            overflowed += 1
            contents.append(f"### {file}\n```\n{truncated}\n...(truncated)\n```")
        else:
            contents.append(f"### {file}\n```\n{truncated}\n```")
        total += len(truncated)
    if overflowed and on_overflow:
        on_overflow(overflowed, max_chars)
    return "\n\n".join(contents)


@dataclass
class ProjectContext:
    chronicle: str = ""
    git_branch: Optional[str] = None
    git_diff: Optional[str] = None
    recent_commits: Optional[str] = None
    project_files: list[str] = field(default_factory=list)
    key_file_contents: str = ""
    source_file_contents: str = ""


def build_context(
    project_root: str | Path, config: RoundtableConfig,
    read_source_code: bool = False,
    max_source_chars: int = DEFAULT_MAX_SOURCE_CHARS,
    on_overflow: Optional[Callable[[int, int], None]] = None,
) -> ProjectContext:
    """Parallel-gather chronicle + git + file walk (reference context.ts:156-187)."""
    root = str(project_root)
    with ThreadPoolExecutor(max_workers=5) as pool:
        chronicle_f = pool.submit(read_chronicle, root, config.chronicle)
        branch_f = pool.submit(get_git_branch, root)
        diff_f = pool.submit(get_git_diff, root)
        commits_f = pool.submit(get_recent_commits, 5, root)
        files_f = pool.submit(get_project_files, root, config.rules.ignore)
        chronicle = chronicle_f.result()
        branch = branch_f.result()
        diff = diff_f.result()
        commits = commits_f.result()
        files = files_f.result()

    key_file_contents = read_key_files(root, files)
    source_file_contents = ""
    if read_source_code:
        source_file_contents = read_source_files(
            root, config.rules.ignore, max_source_chars, on_overflow)

    return ProjectContext(
        chronicle=chronicle,
        git_branch=branch,
        git_diff=diff,
        recent_commits=commits,
        project_files=files,
        key_file_contents=key_file_contents,
        source_file_contents=source_file_contents,
    )
