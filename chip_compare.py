#!/usr/bin/env python3
"""The single-device serving rounds of several checkouts of the port, on
one NVIDIA card, in one run - to compare a change with its parent on the
same card under the same power limit.

    python3 chip_compare.py [--kernels | --attention | --k5-splits |
                             --lora | --lora-variants] DIR [DIR ...]

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

With --kernels each run builds the kernels and runs only the quant_kernels
phase instead: K4 in K1-K3, K5 at the five decode projections and K6 at
the head, each timed with CUDA events and by torch.profiler beside
torch.matmul on the pre-dequantized weight; the summary holds K5's times
for one layer's seven products and K6's.

With --attention each run builds the kernels and runs only the kernels
phase: K1, K2, K3, K8 and K9 against their plain versions, then each
timed with CUDA events at the serving shapes beside its SDPA yardstick;
then K1's and K9's device time at the decode serving shape, K2's at a
512-row chunk and K3's at RAGGED_MAIN, each beside SDPA's
(`attention_device`: torch.profiler, this script's chip_smoke.device_ms,
so every tree is read the same way); the summary holds each kernel's ms,
its yardstick's and its bound, and K1's, K2's, K3's and K9's device_ms
and sdpa_device_ms.

With --k5-splits each run builds the kernels and times K5 alone at the
per-rank column shards of K10e on a 2-way model axis at Llama-3-8B width
(q_proj, k_proj/v_proj, gate_proj/up_proj; 3 decode rows): each shard with
the C splits chosen for its own width and with those chosen for the whole
weight's width, beside K5 on the whole weight: the three launches
interleaved, each time the median of 300 CUDA-event timings of one launch
with L2 flushed (and the medians of each half of them).

With --lora each run builds the kernels and times K7 alone over one
Llama-3-8B layer's LoRA targets at 3 decode rows of 3 personas (rank 8,
9 slots): a tree with K7's group form makes one lora_bgmv_add call per
input group (q/k/v, o_proj, gate/up, down_proj), an older tree one
lora_bgmv call per target followed by the f32 add of its delta. Device ms
per layer from CUDA graphs, warm (20 layers on the same stacks) and cold
(48 layers' distinct stacks, 188 MB of adapter rows per replay), three
graphs each, and the host clock around 48 eager layers ending in a
synchronize (`eager_layer_ms`, the Python included).

With --lora-variants each run builds variants of that tree's
csrc/bgmv.cu (LORA_VARIANTS: the vectors of C per shrink lane, the B rows
an expand lane loads before its wait, the expand's launch bounds, its
programmatic launch) with nvcc and times each as --lora does, in the
order given and then reversed, each checked against the plain version.

Each phase's JSON line is printed as `{"run": i, "dir": DIR, ...}`; the
last line is one JSON object `{"card": ..., "runs": [...]}` with each
run's decode ms per step, prefill seconds and profiled wall and device
ms. Give the directories as parent, change, change, parent to see the
drift between runs beside the difference. Everything is also written to
chiprun_out/chip_compare/ under the current directory.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

OUT = Path("chiprun_out") / "chip_compare"
RUN_TIMEOUT_S = 900


def k5_splits_phase(torch, cs, reps: int = 300) -> None:
    """K5 at K10e's column shards with the shard's own C splits and with
    the whole weight's (see the module docstring)."""
    import statistics
    from theroundtaible_tpu_torch.engine.kernels import int4mm
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    sms = int4mm._sm_count(0)
    gp = cs.INT4_GROUP // 2
    out = {}
    for name, width in (("q_proj", 4096), ("k_proj/v_proj", 1024),
                        ("gate_proj/up_proj", 14336)):
        x = torch.randn(3, 4096, generator=gen, device=dev).to(bf16)
        q4, s4 = cs.int4_weight(torch, gen, (4096, width), dev)
        half = width // 4      # packed columns of one of two shards
        q4_l = q4[:, :half].contiguous()
        s4_l = s4[:, :half // gp].contiguous()
        rows = {"own": int4mm.out_plan(3, 4096, half, sms).rows,
                "whole": int4mm.out_plan(3, 4096, 2 * half, sms).rows}
        splits = {k: -(-4096 // n) for k, n in rows.items()}
        calls = {k: functools.partial(int4mm._launch_pack_out, x, q4_l,
                                      s4_l, gp, n)
                 for k, n in rows.items()}
        calls["whole_weight"] = functools.partial(
            int4mm._launch_pack_out, x, q4, s4, gp, rows["whole"])
        times = {k: [] for k in calls}
        for fn in calls.values():
            fn()
        for rep in range(reps):   # interleaved, the order turning each rep
            names = list(calls)
            for k in names[rep % 3:] + names[:rep % 3]:
                flush.zero_()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                calls[k]()
                end.record()
                end.synchronize()
                times[k].append(start.elapsed_time(end))
        own, whole = calls["own"](), calls["whole"]()
        out[name] = {
            "shard_weight": [4096, 2 * half], "splits": splits,
            "col_tiles": int4mm.out_plan(3, 4096, half, sms).col_tiles,
            **{f"ms_{k}": statistics.median(v) for k, v in times.items()},
            **{f"ms_{k}_halves": [statistics.median(v[:reps // 2]),
                                  statistics.median(v[reps // 2:])]
               for k, v in times.items()},
            "max_abs_diff": float((own - whole).abs().max()),
            "bit_identical": bool(torch.equal(own, whole))}
    cs.emit("k5_splits", sms=sms, reps=reps, shards=out)


def attention_device_phase(torch, kattn, cs) -> None:
    """K1 and K9 at the decode serving shape (B=3, H=32, K=8, D=128,
    kv_valid 1600/1650/1700; pages of 128, or 8 slots of 8192 positions
    read through a row map), K2 at a 512-row chunk of three rows over a
    1.2k prefix and K3 at chip_smoke's RAGGED_MAIN buffer, through `kattn`
    - whichever tree's wrappers - and SDPA on the same inputs, each read by
    this script's chip_smoke.device_ms; `cs.emit` prints the line."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_reader", Path(__file__).resolve().parent / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(16 << 20, dtype=torch.float32, device=dev)
    H, K, D, B = 32, 8, 128, 3
    valid_l, rows_l = [1600, 1650, 1700], [5, 2, 7]
    valid = torch.tensor(valid_l, dtype=torch.int32, device=dev)
    rows = torch.tensor(rows_l, dtype=torch.int32, device=dev)
    k_pool, v_pool, table = here.make_pool(torch, gen, B, 8192, K, D, 128,
                                           bf16, dev)
    kc, vc = here.slot_cache(torch, gen, K, D, bf16, dev, valid_l, rows_l)
    q = (torch.randn(B, 1, H, D, generator=gen, device=dev)
         * D ** -0.5).to(bf16)
    k1 = functools.partial(kattn.paged_decode_attention, q, k_pool, v_pool,
                           table, valid)
    k9 = functools.partial(kattn.ragged_decode_attention, q, kc, vc, valid,
                           rows=rows)
    offs = torch.tensor([1200, 1200, 1200], dtype=torch.int32, device=dev)
    pvalid = offs + torch.tensor([300, 320, 340], dtype=torch.int32,
                                 device=dev)
    qp = (torch.randn(B, 512, H, D, generator=gen, device=dev)
          * D ** -0.5).to(bf16)
    k2 = functools.partial(kattn.paged_prefill_attention, qp, k_pool, v_pool,
                           table, offs, pvalid)
    rargs = here.ragged_inputs(torch, gen, here.RAGGED_MAIN, 1024, H, K, D,
                               128, bf16, dev)
    k3 = functools.partial(kattn.ragged_paged_attention, *rargs)
    cs.emit("attention_device", reps=20, prefill={
        "device_ms": here.device_ms(torch, k2, flush),
        "sdpa_device_ms": here.device_ms(torch, here.sdpa_view_call(
            torch, qp, k_pool, v_pool, table, pvalid, offs), flush)},
        ragged={
        "device_ms": here.device_ms(torch, k3, flush),
        "sdpa_device_ms": here.device_ms(torch, here.sdpa_ragged_call(
            torch, rargs, here.RAGGED_MAIN), flush)}, decode={
        "device_ms": here.device_ms(torch, k1, flush),
        "sdpa_device_ms": here.device_ms(torch, here.sdpa_view_call(
            torch, q, k_pool, v_pool, table, valid, None), flush)},
        cdecode={
        "device_ms": here.device_ms(torch, k9, flush),
        "sdpa_device_ms": here.device_ms(torch, here.sdpa_slots_call(
            torch, q, kc, vc, rows, valid, None), flush)})


LORA_GROUPS = [(4096, (4096, 1024, 1024)), (4096, (4096,)),
               (4096, (14336, 14336)), (14336, (4096,))]
# name: the text substitutions of csrc/bgmv.cu that make the variant.
LORA_VARIANTS = {
    "final": [],
    "lane_vecs_1": [("kLaneVecs = 4;", "kLaneVecs = 1;")],
    "lane_vecs_2": [("kLaneVecs = 4;", "kLaneVecs = 2;")],
    "lane_vecs_8": [("kLaneVecs = 4;", "kLaneVecs = 8;")],
    "prefetch_4": [("kPrefetch = 8;", "kPrefetch = 4;")],
    "expand_default_bounds": [("__launch_bounds__(kExpandThreads, 1)",
                               "__launch_bounds__(kExpandThreads)")],
    "expand_not_programmatic": [("cfg.numAttrs = 1;", "cfg.numAttrs = 0;")],
}


def lora_layer_times(torch, klora, reps: int = 3) -> dict:
    """K7 over one layer's targets (see --lora): warm and cold device ms
    per layer, each graph timed `reps` times, and the eager wall per
    layer."""
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.tensor([1, 2, 3], dtype=torch.int32, device=dev)
    xs = [torch.randn(3, c, generator=gen, device=dev).to(bf16)
          for c, _ in LORA_GROUPS]
    ys = [[torch.randn(3, o, generator=gen, device=dev) for o in outs]
          for _, outs in LORA_GROUPS]

    def stacks(c, o):
        a_t = (torch.randn(9, 8, c, generator=gen, device=dev)
               * c ** -0.5).to(bf16)
        b_s = (torch.randn(9, 8, o, generator=gen, device=dev)
               * 0.04).to(bf16)
        a_t[0] = 0
        b_s[0] = 0
        return a_t, b_s

    layers = [[[stacks(c, o) for o in outs] for c, outs in LORA_GROUPS]
              for _ in range(48)]
    group = hasattr(klora, "lora_bgmv_add")

    def layer(st):
        for x, g, yg in zip(xs, st, ys):
            if group:
                klora.lora_bgmv_add(x, g, yg, ids)
            else:
                for (a_t, b_s), y in zip(g, yg):
                    klora.lora_bgmv(x, a_t, b_s, ids) + y

    def graph_ms(fns, replays):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for fn in fns:
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for fn in fns:
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (len(fns) * replays)

    warm = [graph_ms([lambda: layer(layers[0])] * 20, 5)
            for _ in range(reps)]
    cold = [graph_ms([lambda st=st: layer(st) for st in layers], 3)
            for _ in range(reps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for st in layers:
        layer(st)
    torch.cuda.synchronize()
    eager = (time.perf_counter() - t0) * 1e3 / len(layers)
    return {"group_form": group, "warm_ms": warm, "cold_ms": cold,
            "eager_layer_ms": eager}


def lora_variants_phase(torch, cs, root: str) -> None:
    """LORA_VARIANTS of this tree's K7, built in parallel and timed as
    lora_layer_times in the order given and then reversed; each first
    checked against the plain version (KERNEL_TOL) on one layer."""
    import ctypes
    from theroundtaible_tpu_torch.engine.kernels import build
    from theroundtaible_tpu_torch.engine.kernels import lora as klora
    src = (build.CSRC / "bgmv.cu").read_text()
    out = Path(root) / "chiprun_out" / "lora_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in LORA_VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in bgmv.cu")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}: {log[-3000:]}")
        ptxas[name] = cs.ptxas_summary(log)
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        fn = lib.rt_bgmv_add
        fn.argtypes, fn.restype = build._SIGNATURES["bgmv"]["rt_bgmv_add"]
        libs[name] = lib
    library = build.library

    class Variant:
        lib = None
        check = staticmethod(build.check)

        @classmethod
        def library(cls, name):
            return cls.lib if name == "bgmv" else library(name)

    klora.build = Variant
    slice_vecs = klora._SLICE_VECS
    times = {}
    for name in list(LORA_VARIANTS) + list(reversed(LORA_VARIANTS)):
        Variant.lib = libs[name]
        lane = [new for old, new in LORA_VARIANTS[name] if "kLaneVecs" in old]
        klora._SLICE_VECS = (32 * int(lane[0].split()[-1].rstrip(";"))
                             if lane else slice_vecs)
        klora.plan_bgmv.cache_clear()
        klora._workspaces.clear()
        if name not in times:
            dev = torch.device("cuda")
            gen = torch.Generator(device=dev).manual_seed(1)
            for c, outs in LORA_GROUPS:
                x = torch.randn(3, c, generator=gen, device=dev).bfloat16()
                st = [cs.lora_stacks(torch, gen, c, o, dev) for o in outs]
                ids = torch.tensor([1, 2, 3], dtype=torch.int32, device=dev)
                ys = [torch.randn(3, o, generator=gen, device=dev)
                      for o in outs]
                ref = [y.clone() for y in ys]
                klora.bgmv_add_ref(x, st, ref, ids)
                klora.lora_bgmv_add(x, st, ys, ids)
                err = max(cs.max_err(torch, y, r)[0] for y, r in zip(ys, ref))
                cs.check(err <= cs.KERNEL_TOL, f"{name}: {err}")
        times.setdefault(name, []).append(lora_layer_times(torch, klora, 1))
    cs.emit("lora_variants", ptxas=ptxas, times=times)


def child(root: str, kernels: bool = False, splits: bool = False,
          attention: bool = False, lora: bool = False,
          variants: bool = False) -> None:
    """One checkout's single-device phases (or, with `kernels`, its
    quant_kernels phase; with `splits`, k5_splits_phase; with `attention`,
    its kernels phase), in this process."""
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
    if kernels:
        cs.quant_kernels_phase(torch, kattn)
        return
    if splits:
        k5_splits_phase(torch, cs)
        return
    if attention:
        cs.emit("kernels_timing", **cs.kernels_phase(torch, kattn)["timing"])
        attention_device_phase(torch, kattn, cs)
        return
    if lora:
        from theroundtaible_tpu_torch.engine.kernels import lora as klora
        cs.emit("lora_layer", **lora_layer_times(torch, klora))
        return
    if variants:
        lora_variants_phase(torch, cs, root)
        return

    def release(engine):
        reset_engines()
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    _, engine, reference = cs.engine_phase(torch, kattn)
    cs.profile_phase(torch, engine)
    release(engine)
    # [1]: the engine (later trees also return their rounds)
    engine = cs.quant_engine_phase(torch, kattn, "quant_int8", reference)[1]
    release(engine)
    engine = cs.lora_round_phase(torch, reference)[1]
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

    for name in ("lora_layer", "lora_variants"):
        if name in by:
            return {k: v for k, v in by[name][0].items()
                    if k not in ("phase", "elapsed_s", "ptxas")}
    if "k5_splits" in by:
        return {"k5_splits": by["k5_splits"][0]["shards"]}
    if "kernels_timing" in by:
        timing = dict(by["kernels_timing"][0])
        for key in ("phase", "elapsed_s"):
            timing.pop(key)
        attention = {
            kind: {"ms": t["ms"], "bound_ms": t["bound_ms"],
                   "sdpa_ms": t.get("sdpa_view_ms", t.get("sdpa_ms"))}
            for kind, t in timing.items()}
        for kind in ("decode", "cdecode", "prefill", "ragged"):
            for p in by.get("attention_device", []):
                attention[kind].update(p[kind])
        return {"attention": attention}
    w4 = by.get("quant_kernels", [{}])[0].get("w4a16")
    if w4:
        k5 = {n: t for n, t in w4.items() if n != "lm_head"}
        return {**{f"k5_layer_{k}": sum(t.get(k, 0.0) * t["per_layer"]
                                        for t in k5.values())
                   for k in ("ms", "device_ms", "library_device_ms")},
                "k6_ms": w4["lm_head"]["ms"],
                "k6_device_ms": w4["lm_head"].get("device_ms"),
                "k6_library_device_ms": w4["lm_head"].get(
                    "library_device_ms"),
                "k5_ms": {n: t["ms"] for n, t in k5.items()},
                "k5_device_ms": {n: t.get("device_ms")
                                 for n, t in k5.items()}}
    return {"round": rounds("round"), "profile": profile("profile"),
            "quant_int8": rounds("quant_int8"),
            "quant_int8_profile": profile("quant_int8_profile"),
            "lora_round": rounds("lora_round"),
            "lora_profile": profile("lora_profile")}


def main(dirs: list[str], mode: list[str]) -> int:
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
                [sys.executable, __file__, "--child", root] + mode,
                cwd=root,
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
        child(sys.argv[2], kernels="--kernels" in sys.argv[3:],
              splits="--k5-splits" in sys.argv[3:],
              attention="--attention" in sys.argv[3:],
              lora="--lora" in sys.argv[3:],
              variants="--lora-variants" in sys.argv[3:])
        sys.exit(0)
    args = sys.argv[1:]
    modes = [a for a in args
             if a in ("--kernels", "--attention", "--k5-splits", "--lora",
                      "--lora-variants")]
    dirs = [a for a in args if a not in modes]
    if not dirs or len(modes) > 1:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(dirs, modes))
