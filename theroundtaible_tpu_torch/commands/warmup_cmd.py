"""`roundtable warmup` — build the kernels and warm the serving shapes
(counterpart of theroundtaible_tpu/commands/warmup_cmd.py).

No reference counterpart (Ollama keeps a resident server; our engine
lives in-process). The first serving of a config on a card pays the
kernels' nvcc build (cached on disk afterwards) and every prefill shape's
first launch; this command lets the operator pay that up front instead of
inside the first `discuss` round.
"""

from __future__ import annotations

import os
import time

from ..core.config import load_config
from ..utils.ui import style


def warmup_command(project_root: str | None = None, device="cuda") -> int:
    """Warm every engine knight's engine on `device` (the card unless the
    caller asks for the CPU)."""
    project_root = project_root or os.getcwd()
    config = load_config(project_root)

    from ..adapters.factory import _plan_engine_fleet, is_engine_adapter

    # KNIGHT order, not sorted: discuss plans through the factory in
    # knight order, and get_engine dedups identical configs, so warming
    # in that order builds the engines the first discuss will find.
    engine_ids = list(dict.fromkeys(
        k.adapter for k in config.knights if is_engine_adapter(k.adapter)))
    if not engine_ids:
        print(style.dim("\n  No torch-llm knights in this config — "
                        "nothing to warm.\n"))
        return 0

    from ..engine import get_engine

    # The exact planning pass discuss runs (it inserts a config dict for
    # unconfigured engine ids, as discuss's seating does).
    _plan_engine_fleet(config, None, device)
    configs = [config.adapter_config.get(a, {}) for a in engine_ids]

    # Batch sizes the orchestrator will actually dispatch: 1 (serial
    # turns) and the number of knights sharing each adapter (batched
    # rounds).
    knights_per_adapter = {
        a: sum(1 for k in config.knights if k.adapter == a)
        for a in engine_ids}

    for adapter_id, engine_cfg in zip(engine_ids, configs):
        n = knights_per_adapter[adapter_id]
        sizes = tuple(sorted({1, n}))
        print(style.dim(f"  Warming {adapter_id} "
                        f"(batch sizes {list(sizes)})..."))
        t0 = time.monotonic()
        engine = get_engine(engine_cfg, device)
        secs = engine.warmup(batch_sizes=sizes)
        d = engine.describe()
        print(f"  {style.green('✓')} {d['model']} on mesh {d['mesh']}: "
              f"built in {time.monotonic() - t0 - secs:.1f}s, "
              f"warmed in {secs:.1f}s")
    print(style.dim("\n  The kernels are built and every serving shape "
                    "has run once — the next discuss starts hot.\n"))
    return 0
