"""`roundtable chronicle` — pretty-print the decision chronicle.

Parity with reference src/commands/chronicle.ts:9-60 (tolerates a missing
config by falling back to the default chronicle path).
"""

from __future__ import annotations

import os
import re
from typing import Optional

from ..core.config import load_config
from ..core.errors import ConfigError
from ..utils.chronicle import read_chronicle
from ..utils.ui import style


def chronicle_command(project_root: Optional[str] = None) -> int:
    project_root = project_root or os.getcwd()
    try:
        chronicle_path = load_config(project_root).chronicle
    except ConfigError:
        chronicle_path = ".roundtable/chronicle.md"

    content = read_chronicle(project_root, chronicle_path)
    if not content.strip():
        print(style.dim("\n  The chronicle is empty. "
                        "No decisions have been recorded yet.\n"))
        return 0

    decisions = len(re.findall(r"^## ", content, re.MULTILINE))
    print(style.bold(f"\n  The Chronicle — {decisions} decision(s)\n"))
    for line in content.split("\n"):
        if line.startswith("## "):
            print(style.bold(style.cyan(f"  {line[3:]}")))
        elif line.startswith("# "):
            print(style.bold(f"  {line[2:]}"))
        elif line.startswith("**"):
            print(style.dim(f"  {line}"))
        else:
            print(f"  {line}")
    print("")
    return 0
