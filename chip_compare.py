#!/usr/bin/env python3
"""The single-device serving rounds of several checkouts of the port, on
one NVIDIA card, in one run - to compare a change with its parent on the
same card under the same power limit.

    python3 chip_compare.py DIR [DIR ...]

Each DIR is a checkout (or `git archive`) holding chip_smoke.py and
theroundtaible_tpu_torch/. For each DIR, in the order given, a fresh
process imports that DIR's chip_smoke.py and package, builds the kernels,
and runs its single-device phases at Llama-3-8B width, 32 layers:

- engine, round, profile: the paged bf16 engine, its two 3-knight rounds
  through execute_round and one profiled decode call;
- quant_int8: the int8-weight engine on int8 pages, its two rounds and
  its profiled call;
- lora_round, lora_profile: the LoRA engine's two rounds (three personas)
  and its profiled call.

Each phase's JSON line is printed as `{"run": i, "dir": DIR, ...}`; the
last line is one JSON object `{"card": ..., "runs": [...]}` with each
run's decode ms per step, prefill seconds and profiled wall and device
ms. Give the directories as parent, change, change, parent to see the
drift between runs beside the difference. Everything is also written to
chiprun_out/chip_compare/ under the current directory.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

OUT = Path("chiprun_out") / "chip_compare"
RUN_TIMEOUT_S = 900


def child(root: str) -> None:
    """One checkout's single-device phases, in this process."""
    sys.path[0] = root              # that checkout's chip_smoke and package
    import gc

    import chip_smoke as cs
    import torch
    from theroundtaible_tpu_torch.engine import reset_engines
    from theroundtaible_tpu_torch.engine.kernels import attention as kattn
    from theroundtaible_tpu_torch.engine.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    build.build_all()
    cs.emit("build", seconds=time.monotonic() - t0)

    def release(engine):
        reset_engines()
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    _, engine, reference = cs.engine_phase(torch, kattn)
    cs.profile_phase(torch, engine)
    release(engine)
    _, engine = cs.quant_engine_phase(torch, kattn, "quant_int8", reference)
    release(engine)
    _, engine = cs.lora_round_phase(torch, reference)
    cs.profile_phase(torch, engine, phase="lora_profile",
                     adapters=list(cs.KNIGHT_ADAPTERS.values()))
    release(engine)


def summarize(phases: list[dict]) -> dict:
    by = {}
    for p in phases:
        by.setdefault(p["phase"], []).append(p)

    def rounds(name):
        return [{"decode_ms_per_step": p["decode_ms_per_step"],
                 "prefill_s": p["prefill_seconds"], "wall_s": p["wall_s"]}
                for p in by.get(name, []) if "round" in p]

    def profile(name):
        p = by.get(name, [None])[0]
        return p and {"wall_ms": p["wall_ms"], "device_ms": p["device_ms"]}

    return {"round": rounds("round"), "profile": profile("profile"),
            "quant_int8": rounds("quant_int8"),
            "quant_int8_profile": profile("quant_int8_profile"),
            "lora_round": rounds("lora_round"),
            "lora_profile": profile("lora_profile")}


def main(dirs: list[str]) -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs, rc = [], 0
    with open(OUT / "phases.jsonl", "w") as log:
        for i, root in enumerate(dirs):
            root = str(Path(root).resolve())
            proc = subprocess.run(
                [sys.executable, __file__, "--child", root], cwd=root,
                capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
            (OUT / f"run{i}.err").write_text(proc.stderr)
            phases = []
            for line in proc.stdout.splitlines():
                if line.startswith("{"):
                    phase = json.loads(line)
                    phases.append(phase)
                    line = json.dumps({"run": i, "dir": root, **phase})
                    print(line, flush=True)
                    log.write(line + "\n")
            runs.append({"run": i, "dir": root, "rc": proc.returncode,
                         **summarize(phases)})
            if proc.returncode:
                rc = 1
                print(proc.stderr[-4000:], file=sys.stderr)
    result = {"card": card, "runs": runs}
    (OUT / "summary.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
