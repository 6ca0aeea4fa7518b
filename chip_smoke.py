#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (theroundtaible_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device  - the card's name and power limit (nvidia-smi).
2. build   - nvcc builds the CUDA kernels from engine/kernels/csrc;
             `ptxas`: each kernel's registers, static shared memory and
             spill bytes (K1's and K9's libraries must hold the split-KV
             decode kernels); `tensor_cores`: the HGMMA (wgmma) instructions
             of K2's and K8's libraries, which must be above 0 where the
             toolkit has cuobjdump.
3. kernels - K1 (paged decode), K2 (paged prefill), K3 (ragged mixed
             prefill/decode), K8 (contiguous prefill) and K9 (contiguous
             decode) against their plain PyTorch versions on the card in
             bf16 at Llama-3-8B's attention shape (H=32, K=8, D=128, page
             128; K8/K9 on an 8-slot, 8192-position cache read through a
             permutation of its slots, one K8 row ending at the cache
             end), plus window, softcap, D=64 and D=256 cases (K3 also a
             mid-page chunk with inert blocks and RAGGED_EDGES, the edges
             of its schedule, every case also against ragged_tile_ref;
             K2/K8 also the tensor-core
             tile's edges, PREFILL_EDGES: G 1, 3 and 16, pages of 16 and
             32, T = 1 and T no multiple of the tile, chunks starting
             mid-page, a window edge inside a key tile; K1/K9 also the
             split-KV spans' edges, DECODE_EDGES: kv_valid 1, CHUNK and
             CHUNK + 1, page ends at ps 16 and 32, G 1, 4 and 16, a window
             edge inside a span and one leaving whole spans below it,
             against decode_split_ref too and K1 against K9 bit for bit),
             NaN in every cell past kv_valid; kernel and plain times from
             CUDA events beside each kernel's device-memory/operations
             bound and SDPA on a pre-gathered view (K8/K9: on the batch's
             slot rows); for K1, K2, K3, K8 and K9 also `device_ms` and
             `sdpa_device_ms`, the call's own kernels' device time from
             torch.profiler (device_ms()); for K1, K9 and K3
             `device_kernels_ms`, each kernel's (K3: its prefill tiles,
             split and combine), and for K3 the same buffer with only its
             decode rows and with only its chunk (`decode_rows_only`,
             `chunk_only`: ms, device_ms, device_kernels_ms).
   tp_kernels_device - the same device times for K10a's decode route,
             K10b, K10c and K10d on rank 0's shard (H=16, K=4), and K10e's
             seven per-shard products of one layer beside torch.matmul on
             the pre-dequantized shard, taken in this process.
4. engine  - InferenceEngine.from_config for llama-3-8b-instruct (full
             width, 32 layers, seeded random weights, byte tokenizer),
             paged pool, bf16, 8 slots, max_seq_len 8192; warmup(); two
             3-knight rounds through TorchLlmAdapter.execute_round whose
             prompts share a long prefix, the second extending the first
             (two knights greedy, one sampling top-k/top-p).
             The kernels' launch counts are zeroed before and read after
             each round: both kernels must have launched.
5. profile - torch.profiler over one decode-dominated engine call: wall
             time, device busy share, kernel time by name.
6. path    - one prefill chunk and 16 decode steps of forward_paged at full
             width with the depth cut to 2 layers, through the kernels and
             through the plain versions, logits compared.
7. ragged_path - one flat buffer (3 decode rows at ~1.6k cached tokens and
             a 1000-row chunk) through forward_ragged at full width, 2
             layers: K3 against its plain version, and forward_ragged
             against forward_paged (K1 for the decode rows, K2 for the
             chunk) on identical pools; logits compared.
8. scheduler - the engine phase's 32-layer engine behind a SessionScheduler:
             session alpha (the round-1 prompts, 96 greedy tokens) and
             session beta (another 1.2k preamble) submitted once alpha has
             live rows, so beta joins through ragged mixed dispatches.
             K1, K2 and K3 must all launch within the phase; beta's TTFT,
             alpha's decode rate and the ragged dispatches' walls are
             printed. Then the same sessions again
             (`scheduler_profiled`) with the first three ragged dispatches
             under torch.profiler (`ragged_profiled`: wall, device time and
             K3's share of it).
9. contiguous - the paged engine released, TorchLlmAdapter.from_config
             with the engine phase's config minus `kv_layout`: the default
             builds a contiguous engine (same weights, 8 slots of 8192
             positions, attention resolved to K8/K9); warmup() and the same
             two rounds. K8 and K9 must launch in each round, K1-K3 never;
             prefill/decode seconds, reused tokens, cache bytes, peak
             memory and the greedy knights' token agreement with the paged
             rounds (reported, not checked) are printed.
    contiguous_profile - the profile phase on the contiguous engine.
10. contiguous_path - the path phase on the contiguous layout (2 layers,
             one chunk, 16 decode steps through forward_cached): K8/K9
             against their plain versions, and against forward_paged
             (K2/K1) fed the same tokens; logits compared.
11. contiguous_scheduler - the scheduler phase on the contiguous engine:
             no ragged seam, so beta waits for alpha's segment boundary and
             admits through the blocking prologue. K8 and K9 must launch,
             K1-K3 never.
12. quant_kernels - K4 (in-kernel dequant) inside K1, K2 and K3 on int8
             and int4 pages at the kernels phase's cases (K2 also at three
             of PREFILL_EDGES; NaN scales in
             every cell past kv_valid), K5 at Llama-3-8B's five decode
             projections (3 rows, int4 groups of 64) and K6 at the
             128256-row head, each against its plain version and K5/K6
             each called twice for the same bits; CUDA-event
             times beside the bound and a yardstick (K4: the same kernel
             on the unquantized pool; K5/K6: torch.matmul on the weight
             dequantized to bf16 beforehand), K4 in K1-K3 and K5/K6 with
             device times too.
13. quant_int8, quant_int4 - the engine phase's config with `"quant":
             "int8", "kv_quant": "int8"` (the shipped knights' quant), then
             `"int4"`/`"int4"`, from TorchLlmAdapter.from_config (32
             layers), warmup() and the same two rounds: K1/K2 must launch
             on the quantized pool, K5/K6 on int4 and never on int8, and
             the int4 engine's plan (`int4_paths`) must send only
             prefill-sized products past them. Pages, pool bytes, peak memory, decode ms
             per step beside the unquantized rounds' and the greedy
             agreement with them (reported, not checked); then the profile
             phase on each (quant_int8_profile, quant_int4_profile).
14. quant_scheduler - the scheduler phase on the int4 engine: K3 must
             launch on int4 pages.
15. quant_path - 2 layers at full width, int4 weights and int8 pages:
             forward_paged, forward_ragged and forward_cached through the
             kernels against their plain versions, and pool-direct against
             the gather view at each decode step.
16. lora_kernels - K7 (grouped LoRA BGMV): its group form
             (lora_bgmv_add, y += delta in place) at one Llama-3-8B
             layer's four input groups (q/k/v, o_proj, gate/up, down_proj)
             for 3 rows of 3 personas, a batch with a base row and 64 rows
             (3 personas and the base), rank 8, 9 slots, against its plain
             version, called twice for the same bits; device times from
             CUDA-graph replays, warm (the same stacks) and cold (distinct
             copies of the stacks, 150 MB of adapter rows per replay, as a
             decode step's layers read theirs), beside the bound and the
             grouped einsums plus the add (timed only) as the yardstick;
             then the one-target form (lora_bgmv) at the four (C, O)
             target shapes, warm, as before.
17. lora_round - the engine phase's config (all three knights greedy)
             plus the README's `lora:` block (rank 8, 8 slots, scale 2.0,
             seed personas `skeptic` and `optimist`) and `knight_adapters`
             (lancelot the base model, gawain skeptic, percival optimist),
             32 layers: warmup() and two rounds through execute_round. K1,
             K2 and K7 must launch in each round; `lora_paths` must show K7
             at decode on all seven targets and only prefill-sized rows on
             the grouped einsums; the mixed batch must have suppressed
             sharing. Prefill seconds, decode ms per step beside the bf16
             rounds', K7 calls per decode step (one per input group and
             layer), and each row's greedy agreement with its adapter
             served alone (reported, not checked). Then the profile phase
             with the three personas (lora_profile), and K7's device ms
             and the f32 adds' in it beside the bf16 profile's
             (lora_profile_kernels).
18. lora_scheduler - the scheduler phase on the LoRA engine: alpha's
             knights under base/skeptic/optimist decode while beta's
             (optimist/skeptic/base) join through K3 with one adapter slot
             per token; K3 and K7 must launch.
19. lora_path - 2 layers at full width: a 512-row chunk and 8 decode
             steps of forward_paged with a mixed-adapter batch through K7,
             its plain version and the grouped einsums (logits within
             PATH_TOL), and one decode step of an int8 store (grouped
             einsums) against K7 on its dequantized values.

The tensor-parallel phases run on two ranks sharing the card
(engine/distributed.launch, backend gloo, the kernels built beforehand by
this process), spawned three times: phases 20 and 24, then 21 and 25 (the
five 32-layer TP engines one after another, each freed before the next),
then 22 and 23.

20. tp_kernels - the SPMD wrappers K10a-d (flash_attention_spmd over K8/K9,
             paged_decode_spmd over K1, paged_prefill_spmd over K2,
             ragged_paged_spmd over K3; K10b/c also on int8 and int4 pages)
             on each rank's half of the kernels phase's heads (H=16, K=4,
             same rows, chunks and kv_valid), each against its plain
             version (KERNEL_TOL) and, bit for bit, against the
             single-device kernel's output on the full heads; CUDA-event
             times per rank (one rank at a time), the per-shard bound and
             SDPA on the per-shard gathered view. Then K10b/c's
             pool_replicas branch on a {"data": 2, "model": 1} mesh of the
             same ranks: 4 rows, each replica's pages in its half of the
             pool, against the plain version and the single-device kernel
             on the replica's rows.
21. tp_round, tp_contiguous_round - the engine phase's config plus
             `"mesh": {"data": 1, "model": 2}` (then minus `kv_layout`) on
             two ranks, 32 layers: warmup() and the two rounds; K10b/c and
             K1/K2 (paged) or K10a and K8/K9 (contiguous) must launch on
             every rank, the other layout's kernels never, and both ranks
             must return the same tokens. Prefill seconds and decode ms per
             step beside this run's single-device rounds, per-rank peak
             memory, the rounds' collectives (calls, the host's wait for
             the card, the gloo calls), greedy agreement with the
             single-device rounds (reported).
22. tp_path - 2 layers at full width: a 512-row chunk and 16 decode steps
             of forward_paged and forward_cached under TP=2 against the
             single-device forward on the same weights, logits within
             PATH_TOL.
23. tp_ragged_path - the ragged_path phase's flat buffer through
             forward_ragged under TP=2 (K10d over K3) against its plain
             version, forward_paged under TP=2 and the single-device
             forward_ragged.
24. tp_quant_kernels - K10e (einsum_int4_spmd over K5/K6) at the six
             per-shard products of Llama-3-8B on 2 ranks (q [4096,16,128],
             k/v [4096,4,128], o [16,128,4096], gate/up [4096,7168], down
             [7168,4096], the untied head [64128,4096]; 3 rows, int4
             groups of 64) and K10f (lora_bgmv_add_spmd, K7's group form
             per shard) at the four input groups (3 rows of 3 personas,
             rank 8) on each rank's half: each against its plain version
             (KERNEL_TOL), a column product against its slice of the
             single-device kernel's output (K10f bit for bit; K10e within
             KERNEL_TOL, as K5 splits C by the shard's own width), a row
             product's all-reduced partial sums against that output
             (KERNEL_TOL); times per rank, one rank at a time (K10f warm
             and cold), beside the per-shard bound and the library call
             per shard (torch.matmul on the rank's pre-dequantized weight;
             the grouped einsums plus the add).
25. tp_quant_int8, tp_quant_int4, tp_lora_round - the quant_int8 and
             quant_int4 configs and lora_round's (the `lora:` block and
             knight_adapters) plus `"mesh": {"data": 1, "model": 2}`, 32
             layers: warmup() and the two rounds; K10b/c with K1/K2 on the
             pool must launch on every rank, K10e with K5/K6 on int4 and
             K10f with K7 under personas, nothing else's kernels, and both
             ranks must return the same tokens. Prefill seconds, decode ms
             per step, peak memory and collectives per rank beside this
             run's single-device rounds of the same config, and each
             knight's greedy agreement with them (reported).

Run time: 452-624 s on an H100 80GB HBM3 at 700 W with the build (579 s
with the device-time readings); no earlier phase was cut.

Then a `{"kernels": [...]}` line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Details go to chiprun_out/chip_smoke/.
The script exits non-zero without a result when no card is present or the
package is missing next to it.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 tensor FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# bf16 kernel vs plain version: both round p and the output to bf16 (one
# ulp at |x| ~ 1 is 7.8e-3) and sum in different orders.
KERNEL_TOL = 2e-2
# Whole path: two layers of bf16 activations carry those differences into
# the logits through o_proj, the MLP and the 4096-wide head.
PATH_TOL = 5e-2
SEED = 0


_T0 = time.monotonic()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line on stdout, and appended to
    chiprun_out/chip_smoke/phases.jsonl (stdout's head can be cut), with
    the seconds since the process started."""
    line = json.dumps({"phase": phase, **fields,
                       "elapsed_s": time.monotonic() - _T0})
    if _IN_RANK:    # a spawned rank: the parent prints (tp_launch)
        _CAPTURE.append(json.loads(line))
        return
    print(line, flush=True)
    if OUT.is_dir():
        with open(OUT / "phases.jsonl", "a") as fh:
            fh.write(line + "\n")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> dict:
    """Registers, static shared memory and spill bytes of each kernel in
    nvcc's `-Xptxas -v` output, by mangled name."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[name]["spill_stores"] = int(m.group(1))
                out[name]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[name]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                out[name]["static_smem"] = int(m.group(1)) if m else 0
    return out


def hgmma_counts(build) -> dict:
    """HGMMA (wgmma) instructions in the prefill kernels' libraries, from
    cuobjdump where the toolkit has it (None where it does not)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not shutil.which(tool):
        return {"paged_prefill": None, "flash_prefill": None}
    return {name: subprocess.run(
        [tool, "-sass", str(build.library_path(name))], capture_output=True,
        text=True, timeout=120, check=True).stdout.count("HGMMA")
        for name in ("paged_prefill", "flash_prefill")}


class Failed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


# --- kernel phase helpers ---


def make_pool(torch, gen, B, S, K, D, ps, dtype, dev):
    """Per-row views scattered into a pool at shuffled page ids (page 0 is
    scratch); pages and cells past each row's frontier are poisoned with
    NaN by the caller."""
    n_pages = S // ps
    k_pool = torch.zeros(1 + B * n_pages, ps, K, D, dtype=dtype, device=dev)
    v_pool = torch.zeros_like(k_pool)
    k_pool[1:] = torch.randn(B * n_pages, ps, K, D, generator=gen,
                             device=dev).to(dtype)
    v_pool[1:] = torch.randn(B * n_pages, ps, K, D, generator=gen,
                             device=dev).to(dtype)
    perm = torch.randperm(B * n_pages, generator=gen, device=dev) + 1
    table = perm.reshape(B, n_pages).to(torch.int32)
    return k_pool, v_pool, table


def poison_past_frontier(k_pool, v_pool, table, valid, ps):
    """NaN into every cell at or past each row's kv_valid: stale cells of
    the frontier page and whole pages beyond it."""
    for b, n in enumerate(valid.tolist()):
        for j in range(table.shape[1]):
            lo = max(n - j * ps, 0)
            if lo < ps:
                page = int(table[b, j])
                k_pool[page, lo:] = float("nan")
                v_pool[page, lo:] = float("nan")


def kv_cells(valid, starts, window):
    """KV cells each row must read: [max(0, start - window + 1), valid)."""
    cells = 0
    for v, s in zip(valid, starts):
        lo = max(0, s - window + 1) if window else 0
        cells += max(v - lo, 0)
    return cells


def attended_pairs(valid, offsets, lengths, window):
    """(query, key) pairs the real query rows attend: causal, valid,
    window."""
    pairs = 0
    for v, o, n in zip(valid, offsets, lengths):
        for p in range(o, o + n):
            lo = max(0, p - window + 1) if window else 0
            pairs += max(min(p + 1, v) - lo, 0)
    return pairs


def bound_ms(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, reps, flush):
    """Median of `reps` single-launch CUDA-event timings, the L2 cache
    flushed (a 64 MB write) before each: serving finds the pages cold."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fns, calls=20, replays=5):
    """Device time per call of a launch-bound function: `calls` calls of
    `fns` (or, given a list, each of its functions once, in order)
    captured in one CUDA graph, replayed `replays` times between CUDA
    events, so the host's launch cost is left out. One function's inputs
    stay in L2 between its calls (warm). A decode step's LoRA stacks do
    not: every layer has its own, ~3.9 MB for three personas at
    Llama-3-8B width, 126 MB over 32 layers against a 50 MB L2 - so K7 and
    K10f are also timed over a list of calls on distinct copies of their
    stacks (cold_calls)."""
    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns] * calls
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


# A cold graph walks this many bytes of distinct adapter rows per replay:
# three times the L2, so no call finds its stacks cached.
COLD_BYTES = 150e6


def cold_calls(stacks, distinct_bytes, call):
    """`call(copy)` for enough distinct copies of `stacks` (a list of (a_t,
    b_s) pairs) that the adapter rows they read total COLD_BYTES (32 to
    512 copies): graph_ms over the list times each call with its stacks
    in HBM, as a decode step's layers find theirs."""
    n = min(512, max(32, -(-int(COLD_BYTES) // int(distinct_bytes))))
    copies = [[(a.clone(), b.clone()) for a, b in stacks] for _ in range(n)]
    return [lambda c=c: call(c) for c in copies]


def device_busy_us(prof):
    """Microseconds the card was busy in a torch.profiler window: the union
    of its CUDA kernels' and copies' intervals."""
    from torch.autograd import DeviceType
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    busy, reach = 0.0, None
    for start, end in spans:
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy


def device_ms(torch, fn, flush, reps=20, by_kernel=None):
    """Median over `reps` calls of one call's device time: the time the
    card spent in the CUDA kernels (and copies) the call launched - both of
    K1/K9's launches, their overlap under programmatic dependent launch
    counted once (the union of their intervals) - from torch.profiler, one
    profiled window per call. The L2 cache is flushed (a 64 MB write) and
    the card synchronised before each window, so the flush is left out and
    the pages are cold. A window in which the profiler delivered no device
    event is dropped and taken again (up to 3 * reps windows). `by_kernel`,
    a dict, receives each kernel's median duration (ms) by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    times, named = [], {}
    for _ in range(3 * reps):
        if len(times) == reps:
            break
        flush.zero_()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy = device_busy_us(prof)
        if busy > 0:
            times.append(busy)
            for ev in prof.events():
                if ev.device_type == DeviceType.CUDA:
                    named.setdefault(ev.name[:90], []).append(
                        ev.time_range.elapsed_us())
    check(len(times) == reps, f"torch.profiler saw device time in only "
                              f"{len(times)} of {3 * reps} windows")
    if by_kernel is not None:
        by_kernel.update({name: statistics.median(us) / 1e3
                          for name, us in named.items()})
    return statistics.median(times) / 1e3


def max_err(torch, out, ref, rows=None):
    """max |out - ref| over real rows, and whether all is within the bf16
    tolerance (atol = rtol = KERNEL_TOL)."""
    if rows is not None:
        out = torch.cat([out[b, :n] for b, n in enumerate(rows)])
        ref = torch.cat([ref[b, :n] for b, n in enumerate(rows)])
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    ok = bool(torch.isfinite(out).all()) and bool(
        (diff <= KERNEL_TOL + KERNEL_TOL * ref.abs()).all())
    return float(diff.max()), ok


# K2/K8 at the edges of the tensor-core tile (64 query rows of G heads x
# 64/G chunk rows per warpgroup, two warpgroups per block, keys in tiles of
# 64): (H, K, D, ps, T, offsets, lengths, window, softcap) of three rows -
# G 1, 3 and 16, pages of 16 and 32 (a key tile spans pages), T = 1 and T
# no multiple of the tile, chunks starting mid-page, a window edge inside a
# key tile, softcap. K8 takes the same rows on the slot cache.
PREFILL_EDGES = [
    (8, 8, 128, 128, 200, [0, 130, 2000], [200, 50, 150], None, None),
    (24, 8, 128, 16, 130, [37, 0, 1000], [130, 129, 100], None, None),
    (32, 2, 128, 32, 64, [200, 0, 3000], [64, 33, 64], 100, None),
    (32, 8, 128, 128, 1, [0, 999, 4000], [1, 1, 1], None, None),
    (32, 8, 128, 64, 300, [70, 1500, 3500], [300, 211, 300], 90, 50.0),
]


def edge_pool(torch, gen, case, dev):
    """A PREFILL_EDGES case's q and shuffled pool (NaN past each row's
    kv_valid): the arguments of K2 and its plain version."""
    H, K, D, ps, T, offs, lengths, _, _ = case
    k_pool, v_pool, table = make_pool(torch, gen, 3, 4096, K, D, ps,
                                      torch.bfloat16, dev)
    offsets = torch.tensor(offs, dtype=torch.int32, device=dev)
    valid = offsets + torch.tensor(lengths, dtype=torch.int32, device=dev)
    poison_past_frontier(k_pool, v_pool, table, valid, ps)
    q = (torch.randn(3, T, H, D, generator=gen, device=dev)
         * D ** -0.5).to(torch.bfloat16)
    return q, k_pool, v_pool, table, offsets, valid


# K1/K9 at the edges of their split-KV spans (decode_chunk: 128 positions
# in bf16 at D = 128, 256 at D = 64, 64 at D = 256): (H, K, D, ps, S,
# kv_valid of three rows, window, softcap) - kv_valid 1, CHUNK and
# CHUNK + 1, page ends at ps 16 and 32, G 1, 4 and 16, a window edge inside
# a span and a window that leaves whole spans below it, softcap. K9 reads
# the same cells as slot rows of a permuted cache.
DECODE_EDGES = [
    (32, 8, 128, 16, 2048, [1, 128, 129], None, None),
    (8, 8, 64, 32, 2048, [32, 256, 2048], None, None),
    (16, 1, 128, 16, 2048, [200, 300, 2048], 50, None),
    (32, 8, 128, 128, 4096, [900, 1700, 4096], 300, None),
    (32, 8, 128, 64, 2048, [5, 257, 1700], None, 20.0),
    (16, 4, 64, 16, 2048, [255, 256, 257], None, None),
    (8, 2, 256, 16, 1024, [1, 64, 65], None, None),
    (16, 1, 256, 32, 1024, [64, 100, 1000], 40, 30.0),
]


def decode_edge_cases(torch, kattn, gen):
    """K1 and K9 at DECODE_EDGES in bf16, NaN in every cell past kv_valid:
    each against its plain version and decode_split_ref (KERNEL_TOL), and
    K1 against K9 on the same cells bit for bit (one computation)."""
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    k1, k9 = [], []
    for H, K, D, ps, S, valid_l, window, softcap in DECODE_EDGES:
        k_pool, v_pool, table = make_pool(torch, gen, 3, S, K, D, ps, bf16,
                                          dev)
        valid = torch.tensor(valid_l, dtype=torch.int32, device=dev)
        poison_past_frontier(k_pool, v_pool, table, valid, ps)
        q = (torch.randn(3, 1, H, D, generator=gen, device=dev)
             * D ** -0.5).to(bf16)
        kw = dict(sliding_window=window, softcap=softcap)
        case = {"H": H, "K": K, "D": D, "ps": ps, "kv_valid": valid_l,
                "window": window, "softcap": softcap}
        out = kattn.paged_decode_attention(q, k_pool, v_pool, table, valid,
                                           **kw)
        err, ok = max_err(torch, out, kattn.paged_decode_attention_ref(
            q, k_pool, v_pool, table, valid, **kw))
        err_s, ok_s = max_err(torch, out, kattn.decode_split_ref(
            q, k_pool, v_pool, valid, table=table, **kw))
        k1.append({**case, "max_abs_err": err, "vs_split_ref": err_s})
        check(ok and ok_s, f"K1 disagrees at a split edge: {k1[-1]}")
        rows = torch.tensor([2, 0, 1], dtype=torch.int32, device=dev)
        inv = torch.argsort(rows.long())
        kc = k_pool[table.long()].reshape(3, S, K, D)[inv].contiguous()
        vc = v_pool[table.long()].reshape(3, S, K, D)[inv].contiguous()
        out9 = kattn.ragged_decode_attention(q, kc, vc, valid, rows=rows,
                                             **kw)
        err, ok = max_err(torch, out9, kattn.ragged_decode_attention_ref(
            q, kc, vc, valid, rows=rows, **kw))
        err_s, ok_s = max_err(torch, out9, kattn.decode_split_ref(
            q, kc, vc, valid, rows=rows, **kw))
        k9.append({**case, "max_abs_err": err, "vs_split_ref": err_s,
                   "equals_k1": bool(torch.equal(out, out9))})
        check(ok and ok_s and k9[-1]["equals_k1"],
              f"K9 disagrees at a split edge: {k9[-1]}")
        del k_pool, v_pool, kc, vc
    return k1, k9


def kernels_phase(torch, kattn):
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(16 << 20, dtype=torch.float32, device=dev)
    results = {}

    # K1: B=8 rows at the edges of a page and the context.
    errs = []
    cases = [(32, 8, 128, None, None), (32, 8, 128, 4096, None),
             (32, 8, 128, None, 50.0), (32, 8, 128, 4096, 50.0),
             (32, 8, 64, None, None), (8, 1, 256, None, None)]
    for H, K, D, window, softcap in cases:
        ps, S, B = 128, 8192, 8
        k_pool, v_pool, table = make_pool(torch, gen, B, S, K, D, ps, bf16,
                                          dev)
        valid = torch.tensor([1, 127, 128, 129, 2048, 4000, 5000, 8192],
                             dtype=torch.int32, device=dev)
        poison_past_frontier(k_pool, v_pool, table, valid, ps)
        q = (torch.randn(B, 1, H, D, generator=gen, device=dev)
             * D ** -0.5).to(bf16)
        args = (q, k_pool, v_pool, table, valid)
        out = kattn.paged_decode_attention(*args, sliding_window=window,
                                           softcap=softcap)
        ref = kattn.paged_decode_attention_ref(*args, sliding_window=window,
                                               softcap=softcap)
        err, ok = max_err(torch, out, ref)
        errs.append({"H": H, "K": K, "D": D, "window": window,
                     "softcap": softcap, "max_abs_err": err})
        check(ok, f"K1 disagrees with its plain version: {errs[-1]}")
    edges_k1, edges_k9 = decode_edge_cases(torch, kattn, gen)
    results["decode_cases"] = errs + edges_k1

    # K2: T=512 chunks at offsets 0/100/3000 with partial lengths.
    errs = []
    for H, K, D, window, softcap in cases:
        ps, S, B, T = 128, 4096, 3, 512
        k_pool, v_pool, table = make_pool(torch, gen, B, S, K, D, ps, bf16,
                                          dev)
        offsets = torch.tensor([0, 100, 3000], dtype=torch.int32,
                               device=dev)
        lengths = [512, 300, 512]
        valid = offsets + torch.tensor(lengths, dtype=torch.int32,
                                       device=dev)
        poison_past_frontier(k_pool, v_pool, table, valid, ps)
        q = (torch.randn(B, T, H, D, generator=gen, device=dev)
             * D ** -0.5).to(bf16)
        args = (q, k_pool, v_pool, table, offsets, valid)
        out = kattn.paged_prefill_attention(*args, sliding_window=window,
                                            softcap=softcap)
        ref = kattn.paged_prefill_attention_ref(
            *args, sliding_window=window, softcap=softcap)
        err, ok = max_err(torch, out, ref, rows=lengths)
        errs.append({"H": H, "K": K, "D": D, "window": window,
                     "softcap": softcap, "max_abs_err": err})
        check(ok, f"K2 disagrees with its plain version: {errs[-1]}")
    for case in PREFILL_EDGES:
        H, K, D, ps, T, offs, lengths, window, softcap = case
        args = edge_pool(torch, gen, case, dev)
        kw = dict(sliding_window=window, softcap=softcap)
        err, ok = max_err(torch, kattn.paged_prefill_attention(*args, **kw),
                          kattn.paged_prefill_attention_ref(*args, **kw),
                          rows=lengths)
        errs.append({"H": H, "K": K, "D": D, "ps": ps, "T": T,
                     "offsets": offs, "window": window, "softcap": softcap,
                     "max_abs_err": err})
        check(ok, f"K2 disagrees with its plain version: {errs[-1]}")
    results["prefill_cases"] = errs

    # Times at the serving shape of a 3-knight round (H=32, K=8, D=128):
    # decode at ~1.7k cached tokens, a 512-row delta chunk over a 1.2k
    # shared prefix.
    H, K, D, ps, B = 32, 8, 128, 128, 3
    k_pool, v_pool, table = make_pool(torch, gen, B, 8192, K, D, ps, bf16,
                                      dev)
    valid_l = [1600, 1650, 1700]
    valid = torch.tensor(valid_l, dtype=torch.int32, device=dev)
    q = (torch.randn(B, 1, H, D, generator=gen, device=dev)
         * D ** -0.5).to(bf16)
    args = (q, k_pool, v_pool, table, valid)
    cells = kv_cells(valid_l, [v - 1 for v in valid_l], None)
    k1_kernels = {}
    timing = {"decode": {
        "shape": {"B": B, "H": H, "K": K, "D": D, "ps": ps,
                  "kv_valid": valid_l},
        "ms": time_ms(torch, lambda: kattn.paged_decode_attention(*args),
                      50, flush),
        "plain_ms": time_ms(
            torch, lambda: kattn.paged_decode_attention_ref(*args), 5,
            flush),
        "sdpa_view_ms": sdpa_view_ms(torch, q, k_pool, v_pool, table,
                                     valid, None, flush),
        "device_ms": device_ms(
            torch, lambda: kattn.paged_decode_attention(*args), flush,
            by_kernel=k1_kernels),
        "device_kernels_ms": k1_kernels,
        "sdpa_device_ms": device_ms(torch, sdpa_view_call(
            torch, q, k_pool, v_pool, table, valid, None), flush),
        "bytes": 2 * q.numel() * 2 + cells * K * D * 2 * 2,
        "flops": cells * H * D * 4}}
    offsets_l, lengths_l, T = [1200, 1200, 1200], [300, 320, 340], 512
    offsets = torch.tensor(offsets_l, dtype=torch.int32, device=dev)
    valid_l = [o + n for o, n in zip(offsets_l, lengths_l)]
    valid = torch.tensor(valid_l, dtype=torch.int32, device=dev)
    q = (torch.randn(B, T, H, D, generator=gen, device=dev)
         * D ** -0.5).to(bf16)
    args = (q, k_pool, v_pool, table, offsets, valid)
    cells = kv_cells(valid_l, offsets_l, None)
    pairs = attended_pairs(valid_l, offsets_l, lengths_l, None)
    timing["prefill"] = {
        "shape": {"B": B, "T": T, "H": H, "K": K, "D": D, "ps": ps,
                  "offsets": offsets_l, "lengths": lengths_l},
        "ms": time_ms(torch, lambda: kattn.paged_prefill_attention(*args),
                      20, flush),
        "plain_ms": time_ms(
            torch, lambda: kattn.paged_prefill_attention_ref(*args), 5,
            flush),
        "sdpa_view_ms": sdpa_view_ms(torch, q, k_pool, v_pool, table,
                                     valid, offsets, flush),
        "device_ms": device_ms(
            torch, lambda: kattn.paged_prefill_attention(*args), flush),
        "sdpa_device_ms": device_ms(torch, sdpa_view_call(
            torch, q, k_pool, v_pool, table, valid, offsets), flush),
        "bytes": 2 * sum(lengths_l) * H * D * 2 + cells * K * D * 2 * 2,
        "flops": pairs * H * D * 4}
    results["ragged_cases"], timing["ragged"] = ragged_kernel_cases(
        torch, kattn, gen, flush)
    (results["cdecode_cases"], results["cprefill_cases"],
     timing["cdecode"], timing["cprefill"]) = contiguous_kernel_cases(
        torch, kattn, gen, flush)
    results["cdecode_cases"] += edges_k9
    for t in timing.values():
        t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["flops"])
    results["timing"] = timing
    return results


# K3's main case: three decode rows at ~1.6k cached tokens and a 1000-row
# chunk at offset 0 fill a 1024-row flat buffer (no inert blocks).
RAGGED_MAIN = [(1599, 1), (1649, 1), (1699, 1), (0, 1000)]


def ragged_inputs(torch, gen, runs, T, H, K, D, ps, dtype, dev):
    """A flat buffer of `runs` [(query offset, rows)], one sequence each,
    over shuffled pages of an 8192-token context, plus the inert sequence
    on the scratch page 0 that every unused block points at. NaN in every
    cell past each sequence's kv_valid."""
    n = len(runs)
    k_pool, v_pool, table = make_pool(torch, gen, n, 8192, K, D, ps, dtype,
                                      dev)
    valid = torch.tensor([o + m for o, m in runs], dtype=torch.int32,
                         device=dev)
    poison_past_frontier(k_pool, v_pool, table, valid, ps)
    tables = torch.cat([table, torch.zeros_like(table[:1])])
    seq_of_block = torch.full((T // 8,), n, dtype=torch.int32)
    block_qstart = torch.zeros(T // 8, dtype=torch.int32)
    blk = 0
    for s, (_o, m) in enumerate(runs):
        for k in range(-(-m // 8)):
            seq_of_block[blk], block_qstart[blk] = s, 8 * k
            blk += 1
    offsets = torch.tensor([o for o, _ in runs] + [0], dtype=torch.int32)
    kv_valid = torch.cat([valid, torch.ones(1, dtype=torch.int32,
                                            device=dev)])
    q = (torch.randn(T, H, D, generator=gen, device=dev)
         * D ** -0.5).to(dtype)
    return (q, k_pool, v_pool, tables, seq_of_block.to(dev),
            block_qstart.to(dev), offsets.to(dev), kv_valid)


# K3 at the edges of its schedule (attention.ragged_tiles: tiles of 2 *
# (64 / G) rows, decode items over more than 64 cells): (H, K, D, ps, T,
# runs, window, softcap). G 4 with runs of 1, 7, 8, 9, 31, 32 and 33 rows
# on pages of 16; G 1 (128-row tiles) with 127 and 129 rows; G 2 with a
# chunk starting mid-page and a window crossing a key tile; G 8 (15, 16, 17
# rows) with softcap; G 16 at D = 256 (8-row tiles) with window and
# softcap; G 4 at D = 64 with decode rows over 64 and 65 cells; G 3.
RAGGED_EDGES = [
    (8, 2, 128, 16, 176, [(100, 1), (5, 7), (30, 8), (0, 9), (41, 31),
                          (3, 32), (70, 33)], None, None),
    (2, 2, 128, 128, 288, [(0, 127), (200, 129), (90, 1)], None, None),
    (4, 2, 128, 32, 160, [(13, 63), (50, 65), (300, 1)], 40, None),
    (8, 1, 128, 16, 72, [(7, 15), (20, 16), (33, 17), (64, 1)], None, 30.0),
    (16, 1, 256, 64, 48, [(5, 7), (10, 9), (70, 1), (0, 8)], 24, 20.0),
    (16, 4, 64, 32, 64, [(63, 1), (64, 1), (0, 20)], None, None),
    (12, 4, 128, 64, 136, [(500, 1), (17, 100)], 90, None),
]


def ragged_kernel_cases(torch, kattn, gen, flush):
    """K3 against its plain version and against ragged_tile_ref (the plain
    model of its schedule) on every row (pad rows are 0 in all three), at
    the serving shape's cases and RAGGED_EDGES, then its times at the main
    case: the call, its buffer with only the decode rows and with only the
    chunk, each with the device time of each of its kernels."""
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    cases = [(32, 8, 128, 128, 1024, RAGGED_MAIN, None, None),
             # a chunk starting mid-page, inert blocks behind it
             (32, 8, 128, 128, 512, [(1000, 300), (700, 1), (2000, 1)],
              None, None),
             (32, 8, 128, 128, 512, [(4999, 1), (6999, 1), (4000, 480)],
              4096, None),
             (32, 8, 128, 128, 1024, RAGGED_MAIN, None, 50.0),
             (32, 8, 64, 128, 1024, RAGGED_MAIN, None, None),
             (8, 1, 256, 128, 1024, RAGGED_MAIN, None, None)] + RAGGED_EDGES
    errs = []
    for H, K, D, ps, T, runs, window, softcap in cases:
        args = ragged_inputs(torch, gen, runs, T, H, K, D, ps, bf16, dev)
        kw = dict(sliding_window=window, softcap=softcap)
        out = kattn.ragged_paged_attention(*args, **kw)
        err, ok = max_err(torch, out,
                          kattn.ragged_paged_attention_ref(*args, **kw))
        err_tiles, ok_tiles = max_err(torch, out,
                                      kattn.ragged_tile_ref(*args, **kw))
        errs.append({"H": H, "K": K, "D": D, "ps": ps, "window": window,
                     "softcap": softcap, "T": T, "runs": runs,
                     "max_abs_err": err, "vs_tile_ref": err_tiles})
        check(ok and ok_tiles,
              f"K3 disagrees with its plain versions: {errs[-1]}")
    H, K, D, T = 32, 8, 128, 1024
    args = ragged_inputs(torch, gen, RAGGED_MAIN, T, H, K, D, 128, bf16, dev)
    valid = [o + m for o, m in RAGGED_MAIN]
    offsets = [o for o, _ in RAGGED_MAIN]
    lengths = [m for _, m in RAGGED_MAIN]
    cells = kv_cells(valid, offsets, None)
    pairs = attended_pairs(valid, offsets, lengths, None)
    k3_kernels = {}
    timing = {
        "shape": {"T": T, "H": H, "K": K, "D": D, "ps": 128,
                  "runs": RAGGED_MAIN},
        "ms": time_ms(torch, lambda: kattn.ragged_paged_attention(*args),
                      20, flush),
        "plain_ms": time_ms(
            torch, lambda: kattn.ragged_paged_attention_ref(*args), 3,
            flush),
        "sdpa_view_ms": sdpa_ragged_ms(torch, args, RAGGED_MAIN, flush),
        "device_ms": device_ms(
            torch, lambda: kattn.ragged_paged_attention(*args), flush,
            by_kernel=k3_kernels),
        "device_kernels_ms": k3_kernels,
        "sdpa_device_ms": device_ms(
            torch, sdpa_ragged_call(torch, args, RAGGED_MAIN), flush),
        "bytes": 2 * T * H * D * 2 + cells * K * D * 2 * 2,
        "flops": pairs * H * D * 4}
    # Where K3's time goes: the same buffer with only its decode rows, and
    # with only its chunk (every other block inert).
    for key, runs in (("decode_rows_only", RAGGED_MAIN[:3]),
                      ("chunk_only", RAGGED_MAIN[3:])):
        part = ragged_inputs(torch, gen, runs, T, H, K, D, 128, bf16, dev)
        kernels = {}
        timing[key] = {
            "ms": time_ms(torch, lambda: kattn.ragged_paged_attention(*part),
                          20, flush),
            "device_ms": device_ms(
                torch, lambda: kattn.ragged_paged_attention(*part), flush,
                by_kernel=kernels),
            "device_kernels_ms": kernels}
    return errs, timing


def sdpa_ragged_ms(torch, args, runs, flush):
    """Yardstick only, never called by the port: one
    scaled_dot_product_attention call over the sequences' live cells
    gathered and concatenated beforehand (not timed), every row masked to
    its own sequence's causal prefix (block-diagonal mask; pad rows keep
    their sequence's cells so no row is empty)."""
    return time_ms(torch, sdpa_ragged_call(torch, args, runs), 20, flush)


def sdpa_ragged_call(torch, args, runs):
    """sdpa_ragged_ms's call, its cells gathered here."""
    import torch.nn.functional as F
    q, k_pool, v_pool, tables = args[:4]
    t, h, d = q.shape
    ps, kh = k_pool.shape[1], k_pool.shape[2]
    dev = q.device
    keys, vals, kv_seq, kv_pos = [], [], [], []
    row_seq = torch.full((t,), -1, dtype=torch.long, device=dev)
    row_pos = torch.zeros(t, dtype=torch.long, device=dev)
    row = 0
    for s, (o, m) in enumerate(runs):
        n = o + m
        pages = tables[s, :-(-n // ps)].long()
        keys.append(k_pool[pages].reshape(-1, kh, d)[:n])
        vals.append(v_pool[pages].reshape(-1, kh, d)[:n])
        kv_seq.append(torch.full((n,), s, device=dev))
        kv_pos.append(torch.arange(n, device=dev))
        span = -(-m // 8) * 8
        row_seq[row:row + span] = s
        row_pos[row:row + span] = torch.clamp(
            o + torch.arange(span, device=dev), max=n - 1)
        row += span
    row_seq[row:] = 0
    k = torch.cat(keys).transpose(0, 1)[None].contiguous()
    v = torch.cat(vals).transpose(0, 1)[None].contiguous()
    kv_seq, kv_pos = torch.cat(kv_seq), torch.cat(kv_pos)
    mask = ((kv_seq[None] == row_seq[:, None])
            & (kv_pos[None] <= row_pos[:, None]))[None, None]
    qt = q.transpose(0, 1)[None].contiguous()
    return lambda: F.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask, scale=1.0, enable_gqa=True)


def sdpa_view_ms(torch, q, k_pool, v_pool, table, valid, offsets, flush):
    """Yardstick only, never called by the port: PyTorch's
    scaled_dot_product_attention over the rows' pages gathered into a
    contiguous view beforehand (the gather is not timed), with the causal
    and valid-length mask."""
    return time_ms(torch, sdpa_view_call(torch, q, k_pool, v_pool, table,
                                         valid, offsets), 20, flush)


def sdpa_view_call(torch, q, k_pool, v_pool, table, valid, offsets):
    """sdpa_view_ms's call, its view gathered here."""
    import torch.nn.functional as F
    b, t, h, d = q.shape
    ps, kh = k_pool.shape[1], k_pool.shape[2]
    s = max(int(valid.max()), 1)
    n_pages = -(-s // ps)
    idx = table[:, :n_pages].long()
    k = k_pool[idx].reshape(b, n_pages * ps, kh, d)[:, :s].transpose(1, 2)
    v = v_pool[idx].reshape(b, n_pages * ps, kh, d)[:, :s].transpose(1, 2)
    k = torch.nan_to_num(k).contiguous()
    v = torch.nan_to_num(v).contiguous()
    starts = (valid - 1) if offsets is None else offsets
    q_pos = starts.long()[:, None] + torch.arange(t, device=q.device)
    kv_pos = torch.arange(s, device=q.device)
    mask = ((kv_pos[None, None] <= q_pos[..., None])
            & (kv_pos[None, None] < valid.long()[:, None, None]))[:, None]
    qt = q.transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask, scale=1.0, enable_gqa=True)


# K8/K9's check and timing shapes: an 8-slot cache of 8192 positions, the
# batch rows reading a permutation of its slots.
SLOTS, CACHE_LEN = 8, 8192


def slot_cache(torch, gen, K, D, dtype, dev, valid, rows):
    """A contiguous cache [SLOTS, CACHE_LEN, K, D] with NaN in every cell at
    or past each batch row's kv_valid in its slot: a reused slot's stale
    K/V, which the kernels must never load."""
    shape = (SLOTS, CACHE_LEN, K, D)
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    for n, r in zip(valid, rows):
        k[r, n:] = float("nan")
        v[r, n:] = float("nan")
    return k, v


def contiguous_kernel_cases(torch, kattn, gen, flush):
    """K9 and K8 against their plain versions on every output row (pad rows
    are 0 in both), then their times at the serving shapes of a 3-knight
    round beside K1's and K2's cases."""
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa
    cases = [(32, 8, 128, None, None), (32, 8, 128, 4096, None),
             (32, 8, 128, None, 50.0), (32, 8, 128, 4096, 50.0),
             (32, 8, 64, None, None), (8, 1, 256, None, None)]
    dec_errs, pre_errs = [], []
    for H, K, D, window, softcap in cases:
        # K9: 8 rows at the edges of a block and of the cache, rows mapped
        # onto a permutation of the slots.
        rows = [5, 2, 7, 0, 3, 6, 1, 4]
        valid = [1, 127, 128, 129, 2048, 4000, 5000, CACHE_LEN]
        k, v = slot_cache(torch, gen, K, D, bf16, dev, valid, rows)
        q = (torch.randn(8, 1, H, D, generator=gen, device=dev)
             * D ** -0.5).to(bf16)
        args = (q, k, v, i32(valid))
        kw = dict(sliding_window=window, softcap=softcap, rows=i32(rows))
        err, ok = max_err(torch, kattn.ragged_decode_attention(*args, **kw),
                          kattn.ragged_decode_attention_ref(*args, **kw))
        dec_errs.append({"H": H, "K": K, "D": D, "window": window,
                         "softcap": softcap, "max_abs_err": err})
        check(ok, f"K9 disagrees with its plain version: {dec_errs[-1]}")
        # K8: T=512 chunks at offsets 0/100 and one ending at the cache
        # end, partial lengths (pad rows compared too).
        rows, T = [6, 1, 3], 512
        offsets, lengths = [0, 100, CACHE_LEN - T], [512, 300, 512]
        valid = [o + n for o, n in zip(offsets, lengths)]
        k, v = slot_cache(torch, gen, K, D, bf16, dev, valid, rows)
        q = (torch.randn(3, T, H, D, generator=gen, device=dev)
             * D ** -0.5).to(bf16)
        args = (q, k, v, i32(offsets), i32(valid))
        kw = dict(sliding_window=window, softcap=softcap, rows=i32(rows))
        err, ok = max_err(torch, kattn.flash_prefill_attention(*args, **kw),
                          kattn.flash_prefill_attention_ref(*args, **kw))
        pre_errs.append({"H": H, "K": K, "D": D, "window": window,
                         "softcap": softcap, "max_abs_err": err})
        check(ok, f"K8 disagrees with its plain version: {pre_errs[-1]}")
        del k, v
    for H, K, D, _, T, offsets, lengths, window, softcap in PREFILL_EDGES:
        rows = [6, 1, 3]
        valid = [o + n for o, n in zip(offsets, lengths)]
        k, v = slot_cache(torch, gen, K, D, bf16, dev, valid, rows)
        q = (torch.randn(3, T, H, D, generator=gen, device=dev)
             * D ** -0.5).to(bf16)
        args = (q, k, v, i32(offsets), i32(valid))
        kw = dict(sliding_window=window, softcap=softcap, rows=i32(rows))
        err, ok = max_err(torch, kattn.flash_prefill_attention(*args, **kw),
                          kattn.flash_prefill_attention_ref(*args, **kw))
        pre_errs.append({"H": H, "K": K, "D": D, "T": T, "offsets": offsets,
                         "window": window, "softcap": softcap,
                         "max_abs_err": err})
        check(ok, f"K8 disagrees with its plain version: {pre_errs[-1]}")
        del k, v

    # Times: K1's and K2's serving cases on the slot cache.
    H, K, D, B = 32, 8, 128, 3
    rows_l = [5, 2, 7]
    rows = i32(rows_l)
    valid_l = [1600, 1650, 1700]
    k, v = slot_cache(torch, gen, K, D, bf16, dev, valid_l, rows_l)
    q = (torch.randn(B, 1, H, D, generator=gen, device=dev)
         * D ** -0.5).to(bf16)
    valid = i32(valid_l)
    cells = kv_cells(valid_l, [n - 1 for n in valid_l], None)
    k9_kernels = {}
    timing = {"cdecode": {
        "shape": {"B": B, "H": H, "K": K, "D": D, "S": CACHE_LEN,
                  "slots": SLOTS, "rows": rows_l, "kv_valid": valid_l},
        "ms": time_ms(torch, lambda: kattn.ragged_decode_attention(
            q, k, v, valid, rows=rows), 50, flush),
        "plain_ms": time_ms(torch, lambda: kattn.ragged_decode_attention_ref(
            q, k, v, valid, rows=rows), 5, flush),
        "sdpa_ms": sdpa_slots_ms(torch, q, k, v, rows, valid, None, flush),
        "device_ms": device_ms(torch, lambda: kattn.ragged_decode_attention(
            q, k, v, valid, rows=rows), flush, by_kernel=k9_kernels),
        "device_kernels_ms": k9_kernels,
        "sdpa_device_ms": device_ms(torch, sdpa_slots_call(
            torch, q, k, v, rows, valid, None), flush),
        "bytes": 2 * q.numel() * 2 + cells * K * D * 2 * 2,
        "flops": cells * H * D * 4}}
    offsets_l, lengths_l, T = [1200, 1200, 1200], [300, 320, 340], 512
    valid_l = [o + n for o, n in zip(offsets_l, lengths_l)]
    offsets, valid = i32(offsets_l), i32(valid_l)
    q = (torch.randn(B, T, H, D, generator=gen, device=dev)
         * D ** -0.5).to(bf16)
    cells = kv_cells(valid_l, offsets_l, None)
    pairs = attended_pairs(valid_l, offsets_l, lengths_l, None)
    timing["cprefill"] = {
        "shape": {"B": B, "T": T, "H": H, "K": K, "D": D, "S": CACHE_LEN,
                  "slots": SLOTS, "rows": rows_l, "offsets": offsets_l,
                  "lengths": lengths_l},
        "ms": time_ms(torch, lambda: kattn.flash_prefill_attention(
            q, k, v, offsets, valid, rows=rows), 20, flush),
        "plain_ms": time_ms(torch, lambda: kattn.flash_prefill_attention_ref(
            q, k, v, offsets, valid, rows=rows), 5, flush),
        "sdpa_ms": sdpa_slots_ms(torch, q, k, v, rows, valid, offsets,
                                 flush),
        "device_ms": device_ms(torch, lambda: kattn.flash_prefill_attention(
            q, k, v, offsets, valid, rows=rows), flush),
        "sdpa_device_ms": device_ms(torch, sdpa_slots_call(
            torch, q, k, v, rows, valid, offsets), flush),
        "bytes": 2 * sum(lengths_l) * H * D * 2 + cells * K * D * 2 * 2,
        "flops": pairs * H * D * 4}
    return dec_errs, pre_errs, timing["cdecode"], timing["cprefill"]


def sdpa_slots_ms(torch, q, k_cache, v_cache, rows, valid, offsets, flush):
    """Yardstick only, never called by the port: one
    scaled_dot_product_attention call (enable_gqa, boolean causal and
    valid-length mask) over the batch's slot rows, gathered up to the
    longest kv_valid and laid out [B,K,S,D] beforehand (not timed)."""
    return time_ms(torch, sdpa_slots_call(torch, q, k_cache, v_cache, rows,
                                          valid, offsets), 20, flush)


def sdpa_slots_call(torch, q, k_cache, v_cache, rows, valid, offsets):
    """sdpa_slots_ms's call, its slot rows gathered here."""
    import torch.nn.functional as F
    b, t, h, d = q.shape
    s = max(int(valid.max()), 1)
    idx = rows.long()
    k = torch.nan_to_num(k_cache[idx, :s]).transpose(1, 2).contiguous()
    v = torch.nan_to_num(v_cache[idx, :s]).transpose(1, 2).contiguous()
    starts = (valid - 1) if offsets is None else offsets
    q_pos = starts.long()[:, None] + torch.arange(t, device=q.device)
    kv_pos = torch.arange(s, device=q.device)
    mask = ((kv_pos[None, None] <= q_pos[..., None])
            & (kv_pos[None, None] < valid.long()[:, None, None]))[:, None]
    qt = q.transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask, scale=1.0, enable_gqa=True)


# --- engine phase ---


def knight_prompts(round_no: int, previous=None) -> dict:
    """~1.5k-token prompts (byte tokenizer) sharing a ~1.2k-token
    preamble; round 2 extends each knight's round-1 prompt."""
    knights = ("lancelot", "gawain", "percival")
    if previous is None:
        preamble = ("Round table session. The knights review a design for "
                    "a write-ahead session journal with periodic snapshots"
                    ", replay on restart, and per-turn commit records. "
                    * 9)[:1200]
        return {k: preamble + f" Knight {k}, state your position on the "
                f"journal format, snapshot cadence and recovery time. "
                * 3 for k in knights}
    return {k: previous[k] + f" Round {round_no}: {k}, answer the "
            "strongest objection raised so far and give a final score."
            for k in knights}


# The engine phase's adapter config: llama-3-8b-instruct at full width,
# seeded random weights, the paged pool. The contiguous phase drops
# `kv_layout` and so gets the default, contiguous layout.
ENGINE_CONFIG = {
    "model": "llama-3-8b-instruct", "kv_layout": "paged",
    "dtype": "bfloat16", "num_slots": 8, "max_seq_len": 8192,
    "page_size": 128, "seed": SEED,
    "sampling": {"temperature": 0.0, "max_new_tokens": 32},
    # one knight samples, so the sampled decode path runs too
    "knight_sampling": {"percival": {"temperature": 0.8, "top_k": 40,
                                     "top_p": 0.95}}}
PAGED_KERNELS = ("paged_decode_attention", "paged_prefill_attention",
                 "ragged_paged_attention")
CONTIGUOUS_KERNELS = ("flash_prefill_attention", "ragged_decode_attention")
GREEDY_KNIGHTS = ("lancelot", "gawain")


def reset_launches() -> None:
    from theroundtaible_tpu_torch.engine.kernels import attention, int4mm
    from theroundtaible_tpu_torch.engine.kernels import lora as klora
    attention.reset_launch_counts()
    int4mm.reset_launch_counts()
    klora.reset_launch_counts()


def launches_now() -> dict:
    """Every wrapper's launches since the last reset: K1-K3 and K8/K9 by
    name, K1-K3 on quantized pools ("<name>:int8", "<name>:int4": K4 ran
    inside), K5/K6 and K7."""
    from theroundtaible_tpu_torch.engine.kernels import attention, int4mm
    from theroundtaible_tpu_torch.engine.kernels import lora as klora
    return {**attention.launch_counts(), **attention.dequant_launch_counts(),
            **int4mm.launch_counts(), **klora.launch_counts()}


def decode_ms_per_step(stats: dict, rows: int = 3) -> float:
    """A round's decode wall per step of its `rows` rows."""
    return 1e3 * stats["decode_seconds"] / max(stats["decode_tokens"] / rows,
                                               1)


def serve_rounds(torch, kattn, adapter, engine, phase, required,
                 forbidden=()):
    """Two 3-knight rounds through execute_round. The launch counts are
    zeroed before and read after each round: every `required` kernel must
    have launched in it, no `forbidden` one. Returns (launch totals, each
    round's generated tokens per knight, each round's stats)."""
    from theroundtaible_tpu_torch.adapters.base import KnightTurn
    totals = dict.fromkeys(launches_now(), 0)
    generated, round_stats = {}, {}
    prompts = None
    for rnd in (1, 2):
        prompts = knight_prompts(rnd, prompts)
        turns = [KnightTurn(k, p) for k, p in prompts.items()]
        reset_launches()
        t0 = time.monotonic()
        responses = adapter.execute_round(turns, timeout_ms=600_000)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = launches_now()
        stats = adapter.last_stats()
        round_stats[rnd] = stats
        emit(phase, round=rnd, wall_s=wall,
             prompt_tokens=[len(engine.tokenizer.encode(p))
                            for p in prompts.values()],
             launches=launches, responses=len(responses),
             decode_ms_per_step=decode_ms_per_step(stats), **stats)
        check(adapter.last_degradation is None,
              f"{phase} {rnd} degraded: {adapter.last_degradation}")
        check(all(launches[k] > 0 for k in required),
              f"{phase} {rnd}: a kernel of {required} never launched: "
              f"{launches}")
        check(not any(launches[k] for k in forbidden),
              f"{phase} {rnd}: a kernel of {forbidden} launched: "
              f"{launches}")
        check(stats["decode_tokens"] > 0, f"{phase} {rnd} decoded nothing")
        if rnd == 2:
            check(stats["reused_tokens"] > 0, f"{phase} 2 reused no tokens")
        for name, n in launches.items():
            totals[name] += n
        generated[rnd] = {
            k: engine.kv._slots[k].tokens[len(engine.tokenizer.encode(p)):]
            for k, p in prompts.items()}
    return totals, generated, round_stats


def greedy_agreement(generated, reference) -> float:
    """Share of the greedy knights' generated tokens that equal the
    reference rounds' at the same place."""
    same = total = 0
    for rnd in (1, 2):
        for k in GREEDY_KNIGHTS:
            a, b = generated[rnd][k], reference[rnd][k]
            total += max(len(a), len(b))
            same += sum(x == y for x, y in zip(a, b))
    return same / max(total, 1)


def engine_phase(torch, kattn):
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    torch.cuda.reset_peak_memory_stats()
    adapter = TorchLlmAdapter.from_config("torch-llm-llama3",
                                          dict(ENGINE_CONFIG))
    t0 = time.monotonic()
    engine = adapter._get_engine()
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    warm_s = engine.warmup()
    emit("engine", model=engine.cfg.name, params=engine.num_params,
         construct_s=build_s, warmup_s=warm_s,
         kv_pool_bytes=engine.kv.hbm_bytes(), num_pages=engine.kv.num_pages,
         memory_allocated=torch.cuda.memory_allocated())
    totals, generated, stats = serve_rounds(
        torch, kattn, adapter, engine, "round",
        required=PAGED_KERNELS[:2], forbidden=CONTIGUOUS_KERNELS)
    # The unquantized paged engine's numbers the quant phases print beside
    # their own.
    reference = {"num_pages": engine.kv.num_pages,
                 "kv_pool_bytes": engine.kv.hbm_bytes(),
                 "max_memory_allocated": torch.cuda.max_memory_allocated(),
                 "prefill_s": [stats[r]["prefill_seconds"] for r in (1, 2)],
                 "decode_ms_per_step": [decode_ms_per_step(stats[r])
                                        for r in (1, 2)],
                 "generated": generated}
    return totals, engine, reference


def contiguous_phase(torch, kattn, paged_generated):
    """The engine phase's config minus `kv_layout`: the default builds a
    contiguous engine (the same weights from the same seed), attention
    resolved to K8/K9 on the card. warmup(), then the same two rounds:
    K8 and K9 must launch in each, K1-K3 never."""
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    config = {k: v for k, v in ENGINE_CONFIG.items() if k != "kv_layout"}
    torch.cuda.reset_peak_memory_stats()
    adapter = TorchLlmAdapter.from_config("torch-llm-llama3", config)
    t0 = time.monotonic()
    engine = adapter._get_engine()
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    d = engine.describe()
    check(d["kv_layout"] == "contiguous" and d["attn"] == "flash",
          f"the default config built {d['kv_layout']}/{d.get('attn')}")
    warm_s = engine.warmup()
    emit("contiguous_engine", construct_s=build_s, warmup_s=warm_s,
         kv_cache_bytes=engine.kv.hbm_bytes(),
         memory_allocated=torch.cuda.memory_allocated())
    totals, generated, stats = serve_rounds(
        torch, kattn, adapter, engine, "contiguous_round",
        required=CONTIGUOUS_KERNELS, forbidden=PAGED_KERNELS)
    # bf16 K8/K9 and K1/K2 sum in other orders: reported, not checked.
    emit("contiguous", kv_cache_bytes=engine.kv.hbm_bytes(),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         greedy_agreement_with_paged=greedy_agreement(generated,
                                                      paged_generated),
         launches=totals)
    single = {"prefill_s": [stats[r]["prefill_seconds"] for r in (1, 2)],
              "decode_ms_per_step": [decode_ms_per_step(stats[r])
                                     for r in (1, 2)],
              "generated": generated}
    return totals, engine, single


# --- whole-path phase ---


def path_phase(torch, engine):
    from theroundtaible_tpu_torch.engine.models.common import init_params
    from theroundtaible_tpu_torch.engine.paged_forward import forward_paged
    dev = torch.device("cuda")
    cfg = dataclasses.replace(engine.cfg, num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    params = init_params(cfg, gen, torch.bfloat16, dev)
    B, T, ps = 3, 512, 128
    pp = cfg.max_seq_len // ps
    table = (torch.randperm(B * pp, generator=gen, device=dev) + 1) \
        .reshape(B, pp).to(torch.int32)

    def pools():
        shape = (1 + B * pp, ps, cfg.num_kv_heads, cfg.head_dim)
        return [(torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                 torch.zeros(shape, dtype=torch.bfloat16, device=dev))
                for _ in range(cfg.num_layers)]

    kernel_pools, plain_pools = pools(), pools()
    lengths = torch.tensor([512, 400, 300], dtype=torch.int32, device=dev)
    tokens = torch.randint(3, 259, (B, T), generator=gen, device=dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev) \
        .expand(B, T).contiguous()
    worst, agree, steps = 0.0, 0, 0

    def compare(lk, lp):
        nonlocal worst
        diff = (lk - lp).abs()
        worst = max(worst, float(diff.max()))
        check(bool(torch.isfinite(lk).all()), "non-finite kernel logits")
        check(bool((diff <= PATH_TOL + PATH_TOL * lp.abs()).all()),
              f"whole path: kernel and plain logits differ by {worst}")
        return int((lk.argmax(-1) == lp.argmax(-1)).sum())

    lk = forward_paged(params, cfg, tokens, positions, kernel_pools, table,
                       lengths, last_pos=lengths - 1)
    lp = forward_paged(params, cfg, tokens, positions, plain_pools, table,
                       lengths, last_pos=lengths - 1, plain=True)
    agree += compare(lk[:, 0], lp[:, 0])
    steps += B
    cur = lk[:, 0].argmax(-1)
    valid = lengths.clone()
    for _ in range(16):
        # teacher-forced with the kernel path's greedy tokens, so both
        # paths see the same inputs at every step
        lk = forward_paged(params, cfg, cur[:, None], valid[:, None],
                           kernel_pools, table, valid + 1)
        lp = forward_paged(params, cfg, cur[:, None], valid[:, None],
                           plain_pools, table, valid + 1, plain=True)
        agree += compare(lk[:, 0], lp[:, 0])
        steps += B
        cur = lk[:, 0].argmax(-1)
        valid = valid + 1
    torch.cuda.synchronize()
    emit("path", layers=cfg.num_layers, batch=B, chunk=T, decode_steps=16,
         max_abs_err=worst, tolerance=PATH_TOL,
         greedy_agreement=agree / steps)


def ragged_path_phase(torch, engine):
    """One flat buffer at full width, depth cut to 2 layers: 3 decode rows
    at 1600/1650/1700 cached tokens (random cache content) and a 1000-row
    chunk of a 4th sequence at offset 0. forward_ragged through K3 against
    its plain version, and against forward_paged on identical pools (K1 for
    the decode rows, K2 for the chunk)."""
    from theroundtaible_tpu_torch.engine.models.common import init_params
    from theroundtaible_tpu_torch.engine.paged_forward import (
        forward_paged, forward_ragged)
    from theroundtaible_tpu_torch.engine.serving_loop import (
        RaggedSeq, build_ragged_batch)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    cfg = dataclasses.replace(engine.cfg, num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    params = init_params(cfg, gen, bf16, dev)
    ps, S = 128, 4
    pp = cfg.max_seq_len // ps
    table = (torch.randperm(S * pp, generator=gen, device=dev) + 1) \
        .reshape(S, pp).to(torch.int32)
    shape = (1 + S * pp, ps, cfg.num_kv_heads, cfg.head_dim)
    base = [(torch.randn(shape, generator=gen, device=dev).to(bf16),
             torch.randn(shape, generator=gen, device=dev).to(bf16))
            for _ in range(cfg.num_layers)]
    kernel_pools, plain_pools, paged_pools = (
        [(k.clone(), v.clone()) for k, v in base] for _ in range(3))
    del base
    starts = [1599, 1649, 1699]
    dec = torch.randint(3, 259, (3,), generator=gen, device=dev)
    chunk = torch.randint(3, 259, (1000,), generator=gen, device=dev)
    table_np = table.cpu().numpy()
    seqs = [RaggedSeq([int(dec[i])], starts[i], table_np[i])
            for i in range(3)]
    seqs.append(RaggedSeq(chunk.tolist(), 0, table_np[3]))
    batch = build_ragged_batch(seqs, t_budget=1024, s_max=S + 1,
                               pages_per_seq=pp, scratch_page=0, pad_id=0,
                               page_size=ps)
    t = {k: torch.as_tensor(batch[k], device=dev) for k in (
        "tokens", "positions", "tables", "seq_of_block", "block_qstart",
        "query_offsets", "kv_valid", "token_pages", "token_offs",
        "last_rows")}

    def ragged(pools, plain):
        return forward_ragged(
            params, cfg, t["tokens"].long(), t["positions"], pools,
            t["tables"],
            t["seq_of_block"], t["block_qstart"], t["query_offsets"],
            t["kv_valid"], t["token_pages"], t["token_offs"],
            t["last_rows"], plain=plain)[:S]

    lk, lp = ragged(kernel_pools, False), ragged(plain_pools, True)
    starts_t = torch.tensor(starts, dtype=torch.int32, device=dev)
    ld = forward_paged(params, cfg, dec.long()[:, None], starts_t[:, None],
                       paged_pools, table[:3], starts_t + 1)
    n = torch.tensor([1000], dtype=torch.int32, device=dev)
    lc = forward_paged(params, cfg, chunk.long()[None],
                       torch.arange(1000, dtype=torch.int32,
                                    device=dev)[None],
                       paged_pools, table[3:], n, last_pos=n - 1)
    lpg = torch.cat([ld[:, 0], lc[:, 0]])
    torch.cuda.synchronize()
    result = {}
    for name, other in (("vs_plain", lp), ("vs_paged", lpg)):
        diff = (lk - other).abs()
        err = float(diff.max())
        check(bool(torch.isfinite(lk).all()), "non-finite ragged logits")
        check(bool((diff <= PATH_TOL + PATH_TOL * other.abs()).all()),
              f"ragged path {name}: logits differ by {err}")
        result[name] = {"max_abs_err": err, "greedy_agreement": float(
            (lk.argmax(-1) == other.argmax(-1)).float().mean())}
    emit("ragged_path", layers=cfg.num_layers, tokens=batch["n_tokens"],
         buffer=1024, tolerance=PATH_TOL, **result)


def contiguous_path_phase(torch, engine):
    """The path phase on the contiguous layout: full width, depth cut to 2
    layers (the path phase's seed, so its weights), one 512-row prefill
    chunk (3 rows of 512/400/300 real tokens into slots 5/2/7 of an 8-slot
    cache) and 16 decode steps through forward_cached with K8/K9, against
    the same with their plain versions, and against forward_paged (K2/K1)
    fed the same tokens on its own pages; teacher-forced with the kernel
    path's greedy tokens."""
    from theroundtaible_tpu_torch.engine.models.common import (
        forward_cached, init_params)
    from theroundtaible_tpu_torch.engine.paged_forward import forward_paged
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    cfg = dataclasses.replace(engine.cfg, num_layers=2)
    check(cfg.attn_impl == "flash", f"attn_impl {cfg.attn_impl}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    params = init_params(cfg, gen, bf16, dev)
    B, T, ps = 3, 512, 128
    S = cfg.max_seq_len
    shape = (SLOTS, S, cfg.num_kv_heads, cfg.head_dim)

    def cache():
        return [(torch.zeros(shape, dtype=bf16, device=dev),
                 torch.zeros(shape, dtype=bf16, device=dev))
                for _ in range(cfg.num_layers)]

    kernel_cache, plain_cache = cache(), cache()
    pp = S // ps
    table = (torch.randperm(B * pp, generator=gen, device=dev) + 1) \
        .reshape(B, pp).to(torch.int32)
    pool_shape = (1 + B * pp, ps, cfg.num_kv_heads, cfg.head_dim)
    pools = [(torch.zeros(pool_shape, dtype=bf16, device=dev),
              torch.zeros(pool_shape, dtype=bf16, device=dev))
             for _ in range(cfg.num_layers)]
    rows = torch.tensor([5, 2, 7], dtype=torch.int32, device=dev)
    lengths = torch.tensor([512, 400, 300], dtype=torch.int32, device=dev)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    tokens = torch.randint(3, 259, (B, T), generator=gen, device=dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev) \
        .expand(B, T).contiguous()
    worst = {"vs_plain": 0.0, "vs_paged": 0.0}
    agree = {"vs_plain": 0, "vs_paged": 0}
    steps = 0

    def compare(lk, others):
        for name, other in others.items():
            diff = (lk - other).abs()
            worst[name] = max(worst[name], float(diff.max()))
            check(bool(torch.isfinite(lk).all()),
                  "non-finite contiguous logits")
            check(bool((diff <= PATH_TOL + PATH_TOL * other.abs()).all()),
                  f"contiguous path {name}: logits differ by "
                  f"{worst[name]}")
            agree[name] += int((lk.argmax(-1) == other.argmax(-1)).sum())

    last = lengths - 1
    lk = forward_cached(params, cfg, tokens, positions, kernel_cache, rows,
                        zeros, lengths, last_pos=last)
    lp = forward_cached(params, cfg, tokens, positions, plain_cache, rows,
                        zeros, lengths, last_pos=last, plain=True)
    lg = forward_paged(params, cfg, tokens, positions, pools, table,
                       lengths, last_pos=last)
    compare(lk[:, 0], {"vs_plain": lp[:, 0], "vs_paged": lg[:, 0]})
    steps += B
    cur = lk[:, 0].argmax(-1)
    valid = lengths.clone()
    for _ in range(16):
        lk = forward_cached(params, cfg, cur[:, None], valid[:, None],
                            kernel_cache, rows, valid, valid + 1)
        lp = forward_cached(params, cfg, cur[:, None], valid[:, None],
                            plain_cache, rows, valid, valid + 1, plain=True)
        lg = forward_paged(params, cfg, cur[:, None], valid[:, None], pools,
                           table, valid + 1)
        compare(lk[:, 0], {"vs_plain": lp[:, 0], "vs_paged": lg[:, 0]})
        steps += B
        cur = lk[:, 0].argmax(-1)
        valid = valid + 1
    torch.cuda.synchronize()
    emit("contiguous_path", layers=cfg.num_layers, batch=B, chunk=T,
         decode_steps=16, tolerance=PATH_TOL,
         **{name: {"max_abs_err": worst[name],
                   "greedy_agreement": agree[name] / steps}
            for name in worst})


def beta_prompts() -> dict:
    """Session beta: three knights on another ~1.2k-token preamble."""
    knights = ("tristan", "gareth", "bedivere")
    preamble = ("Second session. The knights weigh a sharded key-value "
                "store with quorum reads, hinted handoff and anti-entropy "
                "repair across three regions. " * 10)[:1200]
    return {k: preamble + f" Knight {k}, argue for or against a quorum of "
            "three, the repair interval and the failure budget." * 3
            for k in knights}


# The kernel names of K3's launches in a trace.
K3_KERNEL_NAMES = ("ragged_tc_kernel", "ragged_simt_kernel", "RaggedItem")


def scheduler_phase(torch, kattn, engine, phase="scheduler", adapters=None,
                    profiled=0):
    """The full-depth engine behind a SessionScheduler: alpha admits into
    an empty batch (blocking prologue) and decodes; beta submits once
    alpha has live rows. On the paged pool alpha runs K2 then K1, and beta
    joins through ragged mixed dispatches (K3). On the contiguous layout
    (no ragged seam) beta queues for alpha's segment boundary and admits
    through the blocking prologue: K8 and K9 must launch, K1-K3 never.
    `adapters` ({session: per-knight LoRA persona ids}) serves the
    sessions' knights under their personas: K7 must launch too. The first
    `profiled` ragged dispatches run under torch.profiler: their device
    time and K3's share of it (the profiler's cost lands in their walls
    and in beta's TTFT). Returns the phase's launch counts."""
    adapters = adapters or {}
    from theroundtaible_tpu_torch.engine.kvcache import scoped_slot
    from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
    contiguous = engine.kv_layout == "contiguous"
    engine.kv.flush()   # the engine phase's slots
    prompts = {"alpha": knight_prompts(1), "beta": beta_prompts()}
    walls, segments, traces = [], [], []
    dispatch = engine._ragged_dispatch
    seam = "_decode_dispatch_slots" if contiguous else \
        "_decode_dispatch_paged"
    decode = getattr(engine, seam)

    def timed(batch):   # the scheduler host-reads the result right after
        if len(traces) < profiled:
            return profiled_dispatch(batch)
        t0 = time.monotonic()
        out = dispatch(batch)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        return out

    def profiled_dispatch(batch):
        # The first dispatches (beta's first chunks) under torch.profiler:
        # the dispatch's device time and K3's share of it (its wall here
        # includes the profiler's own cost).
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = dispatch(batch)
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        k3 = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == DeviceType.CUDA
              and any(n in ev.name for n in K3_KERNEL_NAMES)]
        traces.append({"rows": int(batch["n_tokens"]), "wall_s": wall,
                         "device_ms": device_busy_us(prof) / 1e3,
                         "k3_device_ms": sum(k3) / 1e3,
                         "k3_kernel_launches": len(k3)})
        return out

    def timed_decode(index, *args, **kwargs):
        t0 = time.monotonic()
        out = decode(index, *args, **kwargs)
        torch.cuda.synchronize()
        segments.append({"rows": index.shape[0], "steps": out[1],
                         "wall_s": time.monotonic() - t0})
        return out

    engine._ragged_dispatch = timed
    setattr(engine, seam, timed_decode)
    sched = SessionScheduler(engine)
    results, errors = {}, {}

    def run(session, wait_active):
        try:
            if wait_active:
                deadline = time.monotonic() + 300
                while not sched._active and time.monotonic() < deadline:
                    time.sleep(0.005)
            results[session] = sched.submit(
                session, list(prompts[session].items()),
                max_new_tokens=96, timeout_s=600,
                adapters_per_turn=adapters.get(session))
        except Exception as e:  # noqa: BLE001 - checked below
            errors[session] = e

    reset_launches()
    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(s, i > 0))
               for i, s in enumerate(prompts)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launches_now()
    sched.close()
    del engine._ragged_dispatch
    delattr(engine, seam)
    d = sched.describe()
    check(not errors, f"{phase} sessions failed: {errors}")
    check(set(results) == {"alpha", "beta"}, "a session never returned")
    check(d["completed"] == 2 and d["failed"] == 0,
          f"{phase}: completed {d['completed']}, failed {d['failed']}")
    if contiguous:
        check(d["ragged_joins"] == 0 and not walls and not traces,
              "a contiguous engine ran ragged dispatches")
    else:
        check(d["ragged_joins"] >= 1 and d["ragged_segments"] >= 1,
              "beta never joined through ragged dispatches")
    check(d["max_occupancy"] >= 4,
          f"max_occupancy {d['max_occupancy']} < 4")
    required, forbidden = ((CONTIGUOUS_KERNELS, PAGED_KERNELS) if contiguous
                           else (PAGED_KERNELS, CONTIGUOUS_KERNELS))
    if adapters:
        required += LORA_KERNELS
    check(all(launches[k] > 0 for k in required)
          and not any(launches[k] for k in forbidden),
          f"{phase}: launches {launches}, needs {required} and none of "
          f"{forbidden}")
    alpha, beta = results["alpha"][1], results["beta"][1]
    # beta's scheduled tokens against generate_batch on fresh slot names
    # (bf16 K3 and K2 sum in different orders: reported, not checked)
    sched_recs = {k: list(engine.kv._slots[scoped_slot("beta", k)].tokens)
                  for k in prompts["beta"]}
    engine.generate_batch(list(prompts["beta"].items()), max_new_tokens=96,
                          session="beta-direct",
                          adapters_per_turn=adapters.get("beta"))
    same = total = 0
    for k, rec in sched_recs.items():
        direct = engine.kv._slots[scoped_slot("beta-direct", k)].tokens
        start = len(engine.tokenizer.encode(prompts["beta"][k]))
        a, b = rec[start:], direct[start:]
        total += max(len(a), len(b))
        same += sum(x == y for x, y in zip(a, b))
    emit(phase, wall_s=wall, beta_ttft_s=beta.sched["ttft_s"],
         beta_queue_wait_s=beta.sched["queue_wait_s"],
         alpha_decode_tokens=alpha.decode_tokens,
         alpha_decode_tps=alpha.decode_tps,
         alpha_decode_tokens_per_phase_s=alpha.decode_tokens / wall,
         ragged_dispatches=len(walls) + len(traces),
         ragged_mean_wall_s=(statistics.mean(walls) if walls else None),
         ragged_walls_s=walls, ragged_profiled=traces,
         decode_segments=segments,
         decode_ms_per_step=[1e3 * s["wall_s"] / max(s["steps"], 1)
                             for s in segments],
         launches=launches,
         beta_greedy_agreement=same / max(total, 1), adapters=adapters,
         **{k: d[k] for k in ("segments", "ragged_segments", "ragged_joins",
                              "max_occupancy", "occupancy_mean",
                              "segment_prefill_tokens",
                              "segment_decode_tokens", "preemptions")})
    for name in engine.kv.slot_names():
        engine.kv.release(name)
    return launches


def profile_phase(torch, engine, phase="profile", adapters=None):
    """torch.profiler over one decode-dominated call of the 8B engine: 3
    rows whose prompts are already cached (one token of prefill each),
    then 32 decode steps; `adapters`: the rows' LoRA personas. Device busy
    share = kernel time / wall time; kernel time by name. The profiler's
    own overhead lengthens the wall, so the share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    turns = [(f"profile{i}", [1] + [5 + i] * 1600) for i in range(3)]
    engine.generate_batch(turns, max_new_tokens=1, adapters_per_turn=adapters)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.generate_batch(turns, max_new_tokens=32,
                              adapters_per_turn=adapters)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range \
                .elapsed_us()
    device_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit(phase, wall_ms=wall_us / 1e3, device_ms=device_us / 1e3,
         device_busy_share=device_us / wall_us if wall_us else None,
         top_kernels=[{"name": n[:90], "ms": us / 1e3,
                       "share_of_device": us / device_us}
                      for n, us in top] if device_us else [])
    for name, _ in turns:
        engine.kv.release(name)
    return by_name


def kernel_ms(by_name: dict, part: str) -> float:
    """Device ms of a profile's kernels whose name holds `part`."""
    return sum(us for name, us in by_name.items() if part in name) / 1e3


# --- quantization phases ---


# The shipped knights' quantization, and int4 throughout.
QUANT_CONFIGS = {"quant_int8": {"quant": "int8", "kv_quant": "int8"},
                 "quant_int4": {"quant": "int4", "kv_quant": "int4"}}
INT4_KERNELS = ("mm_pack_out", "mm_pack_contract")
# Llama-3-8B's decode products at 3 rows, (x shape, weight shape), with
# how many of each one layer makes; the lm head separately.
K5_SHAPES = {"q_proj": ((3, 4096), (4096, 4096), 1),
             "kv_proj": ((3, 4096), (4096, 1024), 2),
             "o_proj": ((3, 4096), (4096, 4096), 1),
             "gate_up_proj": ((3, 4096), (4096, 14336), 2),
             "down_proj": ((3, 14336), (14336, 4096), 1),
             # 64 rows (eight n-tiles of the tensor-core body), outside
             # the layer's sum
             "gate_up_proj_64rows": ((64, 4096), (4096, 14336), 0)}
K6_SHAPE = ((3, 4096), (128256, 4096))
INT4_GROUP = 64


def quantized_pools(kvq, k_pool, v_pool, bits):
    """int8/int4 payload pools and f32 scales of unquantized pools (cells
    poisoned with NaN get NaN scales: stale cells K4 must never load), as
    the keyword arguments of K1-K3."""
    spec = kvq.KVQuantSpec(bits=bits)
    kq, ks = kvq.quantize_cells(k_pool, spec)
    vq, vs = kvq.quantize_cells(v_pool, spec)
    return kq, vq, dict(k_scale=ks, v_scale=vs, kv_bits=bits)


def quant_cell_bytes(cells, K, D, bits):
    """Bytes of `cells` quantized K and V cells: payload plus f32 scales."""
    dp, groups = (D, 1) if bits == 8 else (D // 2, D // 32)
    return cells * K * (dp + 4 * groups) * 2


def dequant_kernel_cases(torch, kattn, kvq, gen, flush):
    """K4 inside K1, K2 and K3 against their plain versions on int8 and int4
    pages (NaN scales in every cell past kv_valid), then their times at the
    serving shapes beside the same kernel on the unquantized pool."""
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    errs = {8: [], 4: []}
    cases = [(32, 8, 128, None, None), (32, 8, 128, 4096, 50.0),
             (32, 8, 64, None, None), (8, 1, 256, None, None)]
    for bits in (8, 4):
        for H, K, D, window, softcap in cases:
            kw = dict(sliding_window=window, softcap=softcap)
            k_pool, v_pool, table = make_pool(torch, gen, 8, 8192, K, D, 128,
                                              bf16, dev)
            valid = torch.tensor([1, 127, 128, 129, 2048, 4000, 5000, 8192],
                                 dtype=torch.int32, device=dev)
            poison_past_frontier(k_pool, v_pool, table, valid, 128)
            kq, vq, qkw = quantized_pools(kvq, k_pool, v_pool, bits)
            q = (torch.randn(8, 1, H, D, generator=gen, device=dev)
                 * D ** -0.5).to(bf16)
            args = (q, kq, vq, table, valid)
            err, ok = max_err(torch, kattn.paged_decode_attention(
                *args, **kw, **qkw), kattn.paged_decode_attention_ref(
                *args, **kw, **qkw))
            errs[bits].append({"kernel": "K1", "H": H, "K": K, "D": D,
                               "window": window, "softcap": softcap,
                               "max_abs_err": err})
            check(ok, f"K1+K4 int{bits} disagrees: {errs[bits][-1]}")
            k_pool, v_pool, table = make_pool(torch, gen, 3, 4096, K, D, 128,
                                              bf16, dev)
            offsets = torch.tensor([0, 100, 3000], dtype=torch.int32,
                                   device=dev)
            lengths = [512, 300, 512]
            valid = offsets + torch.tensor(lengths, dtype=torch.int32,
                                           device=dev)
            poison_past_frontier(k_pool, v_pool, table, valid, 128)
            kq, vq, qkw = quantized_pools(kvq, k_pool, v_pool, bits)
            q = (torch.randn(3, 512, H, D, generator=gen, device=dev)
                 * D ** -0.5).to(bf16)
            args = (q, kq, vq, table, offsets, valid)
            err, ok = max_err(torch, kattn.paged_prefill_attention(
                *args, **kw, **qkw), kattn.paged_prefill_attention_ref(
                *args, **kw, **qkw), rows=lengths)
            errs[bits].append({"kernel": "K2", "H": H, "K": K, "D": D,
                               "window": window, "softcap": softcap,
                               "max_abs_err": err})
            check(ok, f"K2+K4 int{bits} disagrees: {errs[bits][-1]}")
            for runs, T in ((RAGGED_MAIN, 1024),
                            ([(1000, 300), (700, 1), (2000, 1)], 512)):
                args = ragged_inputs(torch, gen, runs, T, H, K, D, 128, bf16,
                                     dev)
                kq, vq, qkw = quantized_pools(kvq, args[1], args[2], bits)
                args = (args[0], kq, vq) + tuple(args[3:])
                err, ok = max_err(torch, kattn.ragged_paged_attention(
                    *args, **kw, **qkw), kattn.ragged_paged_attention_ref(
                    *args, **kw, **qkw))
                errs[bits].append({"kernel": "K3", "H": H, "K": K, "D": D,
                                   "window": window, "softcap": softcap,
                                   "T": T, "max_abs_err": err})
                check(ok, f"K3+K4 int{bits} disagrees: {errs[bits][-1]}")
        # K2 at the tile's edges: G 3 on pages of 16, G 16 on pages of 32
        # with a window edge inside a key tile, the mid-page softcap case.
        for case in (PREFILL_EDGES[1], PREFILL_EDGES[2], PREFILL_EDGES[4]):
            H, K, D, ps, T, _, lengths, window, softcap = case
            kw = dict(sliding_window=window, softcap=softcap)
            q, k_pool, v_pool, table, offsets, valid = edge_pool(
                torch, gen, case, dev)
            kq, vq, qkw = quantized_pools(kvq, k_pool, v_pool, bits)
            args = (q, kq, vq, table, offsets, valid)
            err, ok = max_err(torch, kattn.paged_prefill_attention(
                *args, **kw, **qkw), kattn.paged_prefill_attention_ref(
                *args, **kw, **qkw), rows=lengths)
            errs[bits].append({"kernel": "K2", "H": H, "K": K, "D": D,
                               "ps": ps, "T": T, "window": window,
                               "softcap": softcap, "max_abs_err": err})
            check(ok, f"K2+K4 int{bits} disagrees: {errs[bits][-1]}")

    # Times at the serving shapes (H=32, K=8, D=128): decode at ~1.7k
    # cached tokens, a 512-row delta chunk over a 1.2k prefix, K3's main
    # buffer; `library_ms` is the same kernel on the unquantized pool.
    H, K, D, B = 32, 8, 128, 3
    timing = {}
    k_pool, v_pool, table = make_pool(torch, gen, B, 8192, K, D, 128, bf16,
                                      dev)
    valid_l = [1600, 1650, 1700]
    valid = torch.tensor(valid_l, dtype=torch.int32, device=dev)
    q = (torch.randn(B, 1, H, D, generator=gen, device=dev)
         * D ** -0.5).to(bf16)
    cells = kv_cells(valid_l, [v - 1 for v in valid_l], None)
    offs_l, lens_l = [1200, 1200, 1200], [300, 320, 340]
    offs = torch.tensor(offs_l, dtype=torch.int32, device=dev)
    pvalid_l = [o + n for o, n in zip(offs_l, lens_l)]
    pvalid = torch.tensor(pvalid_l, dtype=torch.int32, device=dev)
    qp = (torch.randn(B, 512, H, D, generator=gen, device=dev)
          * D ** -0.5).to(bf16)
    pcells = kv_cells(pvalid_l, offs_l, None)
    pairs = attended_pairs(pvalid_l, offs_l, lens_l, None)
    rargs = ragged_inputs(torch, gen, RAGGED_MAIN, 1024, H, K, D, 128, bf16,
                          dev)
    rvalid = [o + m for o, m in RAGGED_MAIN]
    roffs = [o for o, _ in RAGGED_MAIN]
    rcells = kv_cells(rvalid, roffs, None)
    rpairs = attended_pairs(rvalid, roffs, [m for _, m in RAGGED_MAIN], None)
    for bits in (8, 4):
        kq, vq, qkw = quantized_pools(kvq, k_pool, v_pool, bits)
        rkq, rvq, rkw = quantized_pools(kvq, rargs[1], rargs[2], bits)
        rq = (rargs[0], rkq, rvq) + tuple(rargs[3:])
        timing[bits] = {
            "decode": {
                "ms": time_ms(torch, lambda: kattn.paged_decode_attention(
                    q, kq, vq, table, valid, **qkw), 50, flush),
                "plain_ms": time_ms(
                    torch, lambda: kattn.paged_decode_attention_ref(
                        q, kq, vq, table, valid, **qkw), 5, flush),
                "library_ms": time_ms(
                    torch, lambda: kattn.paged_decode_attention(
                        q, k_pool, v_pool, table, valid), 50, flush),
                "device_ms": device_ms(
                    torch, lambda: kattn.paged_decode_attention(
                        q, kq, vq, table, valid, **qkw), flush),
                "library_device_ms": device_ms(
                    torch, lambda: kattn.paged_decode_attention(
                        q, k_pool, v_pool, table, valid), flush),
                "bytes": 2 * q.numel() * 2 + quant_cell_bytes(cells, K, D,
                                                              bits),
                "flops": cells * H * D * 4},
            "prefill": {
                "ms": time_ms(torch, lambda: kattn.paged_prefill_attention(
                    qp, kq, vq, table, offs, pvalid, **qkw), 20, flush),
                "plain_ms": time_ms(
                    torch, lambda: kattn.paged_prefill_attention_ref(
                        qp, kq, vq, table, offs, pvalid, **qkw), 3, flush),
                "library_ms": time_ms(
                    torch, lambda: kattn.paged_prefill_attention(
                        qp, k_pool, v_pool, table, offs, pvalid), 20, flush),
                "device_ms": device_ms(
                    torch, lambda: kattn.paged_prefill_attention(
                        qp, kq, vq, table, offs, pvalid, **qkw), flush),
                "library_device_ms": device_ms(
                    torch, lambda: kattn.paged_prefill_attention(
                        qp, k_pool, v_pool, table, offs, pvalid), flush),
                "bytes": (2 * sum(lens_l) * H * D * 2
                          + quant_cell_bytes(pcells, K, D, bits)),
                "flops": pairs * H * D * 4},
            "ragged": {
                "ms": time_ms(torch, lambda: kattn.ragged_paged_attention(
                    *rq, **rkw), 20, flush),
                "plain_ms": time_ms(
                    torch, lambda: kattn.ragged_paged_attention_ref(
                        *rq, **rkw), 3, flush),
                "library_ms": time_ms(
                    torch, lambda: kattn.ragged_paged_attention(*rargs), 20,
                    flush),
                "device_ms": device_ms(
                    torch, lambda: kattn.ragged_paged_attention(*rq, **rkw),
                    flush),
                "library_device_ms": device_ms(
                    torch, lambda: kattn.ragged_paged_attention(*rargs),
                    flush),
                "bytes": (2 * 1024 * H * D * 2
                          + quant_cell_bytes(rcells, K, D, bits)),
                "flops": rpairs * H * D * 4}}
        for t in timing[bits].values():
            t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["flops"])
        del kq, vq, qkw, rkq, rvq, rkw, rq
    return errs, timing


def int4_weight(torch, gen, shape, dev):
    """A random packed int4 weight [rows, cols/2] with bf16 scales per
    INT4_GROUP values (any byte is two valid nibbles)."""
    rows, cols = shape
    q4 = torch.randint(-128, 128, (rows, cols // 2), generator=gen,
                       device=dev, dtype=torch.int8)
    s4 = (torch.rand(rows, cols // INT4_GROUP, generator=gen, device=dev)
          * 0.025 + 0.005).to(torch.bfloat16)
    return q4, s4


def int4_kernel_ptxas(build, int4mm, m, head):
    """ptxas's registers, static shared memory and spills of the bf16
    kernel (tensor-core body for m rows) that K5 or K6 launches."""
    want = (f"{'mm_pack_contract' if head else 'mm_pack_out'}"
            f"_tc_kernelILi{int4mm.n_tiles(m)}E")
    found = {name: v for name, v in ptxas_summary(
        build.build_logs().get("int4mm", "")).items() if want in name}
    check(len(found) == 1, f"ptxas lists no single {want}: {list(found)}")
    return next(iter(found.values()))


def w4a16_cases(torch, int4mm, common, gen, flush):
    """K5 at the five decode projections (and gate/up at 64 rows) and K6
    at the 128256-row head against their plain versions, with times beside
    `torch.matmul` on the weight dequantized to bf16 beforehand (not
    timed), the yardstick, and the launched kernel's ptxas line."""
    from theroundtaible_tpu_torch.engine.kernels import build
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gp = INT4_GROUP // 2
    out = {}
    for name, (xs, ws, per_layer) in list(K5_SHAPES.items()) + [
            ("lm_head", K6_SHAPE + (1,))]:
        head = name == "lm_head"
        x = torch.randn(*xs, generator=gen, device=dev).to(bf16)
        q4, s4 = int4_weight(torch, gen, ws, dev)
        w = common.dequant_int4(q4, s4, 1, INT4_GROUP, bf16)
        if head:   # [V, E] packed along the contracted E
            fn = lambda: int4mm.mm_pack_contract(x, q4, s4, gp)  # noqa
            ref = lambda: int4mm.mm_pack_contract_ref(x, q4, s4, gp)  # noqa
            lib = lambda: torch.matmul(x, w.t())  # noqa
            n_out = ws[0]
        else:      # [C, out] packed along the output axis
            fn = lambda: int4mm.mm_pack_out(x, q4, s4, gp)  # noqa
            ref = lambda: int4mm.mm_pack_out_ref(x, q4, s4, gp)  # noqa
            lib = lambda: torch.matmul(x, w)  # noqa
            n_out = ws[1]
        first = fn()
        err, ok = max_err(torch, first, ref())
        check(ok, f"{name}: int4 kernel disagrees with its plain version "
                  f"by {err}")
        same = bool(torch.equal(first, fn()))
        check(same, f"{name}: two identical calls of the int4 kernel "
                    f"differ")
        m = xs[0]
        t = {"x": list(xs), "weight": list(ws), "per_layer": per_layer,
             "max_abs_err": err, "repeat_bit_identical": same,
             "ptxas": int4_kernel_ptxas(build, int4mm, m, head),
             "ms": time_ms(torch, fn, 50, flush),
             "plain_ms": time_ms(torch, ref, 3, flush),
             "library_ms": time_ms(torch, lib, 50, flush),
             "device_ms": device_ms(torch, fn, flush),
             "library_device_ms": device_ms(torch, lib, flush),
             "bytes": (q4.numel() + s4.numel() * 2 + x.numel() * 2
                       + m * n_out * 4),
             "flops": 2 * m * ws[0] * ws[1]}
        t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["flops"])
        out[name] = t
        del x, q4, s4, w
    return out


def quant_kernels_phase(torch, kattn):
    from theroundtaible_tpu_torch.engine import kv_quant as kvq
    from theroundtaible_tpu_torch.engine.kernels import int4mm
    from theroundtaible_tpu_torch.engine.models import common
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    flush = torch.empty(16 << 20, dtype=torch.float32, device=dev)
    errs, timing = dequant_kernel_cases(torch, kattn, kvq, gen, flush)
    w4 = w4a16_cases(torch, int4mm, common, gen, flush)
    emit("quant_kernels", tolerance=KERNEL_TOL,
         dequant_cases={f"int{b}": errs[b] for b in errs},
         dequant_timing={f"int{b}": timing[b] for b in timing},
         w4a16=w4)
    return errs, timing, w4


def quant_engine_phase(torch, kattn, phase, reference):
    """The engine phase's config plus quantization (QUANT_CONFIGS[phase]):
    int8 weights on int8 pages (the shipped knights' quant) or int4 on
    int4 pages. warmup(), the same two rounds, then the profile phase.
    K1/K2 must launch on the quantized pool in each round (K4 inside),
    K5/K6 in each int4 round and never in an int8 one; on int4 every
    dequant-path product must be a prefill-sized one. Greedy agreement
    with the unquantized paged rounds is reported, not checked."""
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    extra = QUANT_CONFIGS[phase]
    bits = 8 if extra["kv_quant"] == "int8" else 4
    int4 = extra["quant"] == "int4"
    torch.cuda.reset_peak_memory_stats()
    adapter = TorchLlmAdapter.from_config("torch-llm-llama3",
                                          {**ENGINE_CONFIG, **extra})
    t0 = time.monotonic()
    engine = adapter._get_engine()
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    d = engine.describe()
    check(d["quant"] == extra["quant"]
          and d["kv_quant"]["dtype"] == extra["kv_quant"]
          and d["paged_decode"] == "pool-direct",
          f"{phase} built quant {d['quant']}, kv_quant {d['kv_quant']}")
    warm_s = engine.warmup()
    emit(f"{phase}_engine", params=engine.num_params, construct_s=build_s,
         warmup_s=warm_s, num_pages=engine.kv.num_pages,
         kv_pool_bytes=engine.kv.hbm_bytes(),
         kv_pool_bytes_unquantized_layout=engine.kv.hbm_bytes_logical(),
         memory_allocated=torch.cuda.memory_allocated())
    required = PAGED_KERNELS[:2] + tuple(
        f"{k}:int{bits}" for k in PAGED_KERNELS[:2])
    required += INT4_KERNELS if int4 else ()
    forbidden = CONTIGUOUS_KERNELS + (() if int4 else INT4_KERNELS)
    totals, generated, stats = serve_rounds(
        torch, kattn, adapter, engine, phase, required=required,
        forbidden=forbidden)
    paths = None
    if int4:
        paths = engine.describe()["int4_paths"]
        declines = {e.get("fallback_reason") for e in paths["xla_dequant"]}
        check(paths["cuda_w4a16"] and declines <= {"rows:prefill-m"},
              f"{phase}: a decode product left K5/K6: {declines}")
        paths = {"cuda_w4a16": len(paths["cuda_w4a16"]),
                 "xla_dequant": len(paths["xla_dequant"]),
                 "fallback_reasons": sorted(r for r in declines if r)}
    emit(phase, num_pages=engine.kv.num_pages,
         kv_pool_bytes=engine.kv.hbm_bytes(),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         decode_ms_per_step=[decode_ms_per_step(stats[r]) for r in (1, 2)],
         unquantized=dict((k, v) for k, v in reference.items()
                          if k != "generated"),
         greedy_agreement_with_unquantized=greedy_agreement(
             generated, reference["generated"]),
         kv_quant=engine.kv_quant_describe()["dispatches"],
         int4_paths=paths, launches=totals)
    profile_phase(torch, engine, phase=f"{phase}_profile")
    return totals, engine, {
        "prefill_s": [stats[r]["prefill_seconds"] for r in (1, 2)],
        "decode_ms_per_step": [decode_ms_per_step(stats[r]) for r in (1, 2)],
        "generated": generated}


def quant_path_phase(torch, cfg):
    """The whole path at full width, depth cut to 2 layers, int4 weights
    and int8 pages (logits within PATH_TOL, greedy agreement >= 0.9):
    forward_paged (one 512-row chunk, 16 decode steps) through the kernels
    (K1/K2 with K4, K5/K6) against its plain versions and, at each decode
    step on the same quantized cells, against the gather view (dequantize,
    dense attention, requantize; the chunk's difference is reported, not
    checked: the view attends to the chunk's own K/V before requantizing
    them); forward_ragged
    (3 decode rows and a 1000-row chunk) through K3 with K4 against its
    plain versions; forward_cached (contiguous slots, K8/K9 with K5/K6)
    against its plain versions."""
    from theroundtaible_tpu_torch.engine.kv_quant import (KVQuantSpec,
                                                          quantize_cells)
    from theroundtaible_tpu_torch.engine.models.common import (
        forward_cached, init_params)
    from theroundtaible_tpu_torch.engine.paged_forward import (
        forward_paged, forward_ragged, gather_view, scatter_view)
    from theroundtaible_tpu_torch.engine.quant import quantize_params
    from theroundtaible_tpu_torch.engine.serving_loop import (
        RaggedSeq, build_ragged_batch)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    cfg = dataclasses.replace(cfg, num_layers=2, attn_impl="dense")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    params = quantize_params(init_params(cfg, gen, bf16, dev), cfg,
                             act_dtype=bf16, free_source=True, bits=4)
    spec = KVQuantSpec(bits=8)
    B, T, ps = 3, 512, 128
    pp = cfg.max_seq_len // ps
    table = (torch.randperm(B * pp, generator=gen, device=dev) + 1) \
        .reshape(B, pp).to(torch.int32)
    head = (1 + B * pp, ps, cfg.num_kv_heads)

    def pools():
        def pair(width, dt):
            return (torch.zeros(head + (width,), dtype=dt, device=dev),
                    torch.zeros(head + (width,), dtype=dt, device=dev))
        return ([pair(cfg.head_dim, torch.int8) for _ in range(2)],
                [pair(1, torch.float32) for _ in range(2)])

    worst, agree, steps = {}, {}, {}

    def compare(name, lk, other):
        diff = (lk - other).abs()
        worst[name] = max(worst.get(name, 0.0), float(diff.max()))
        check(bool(torch.isfinite(lk).all()), f"{name}: non-finite logits")
        check(bool((diff <= PATH_TOL + PATH_TOL * other.abs()).all()),
              f"quant_path {name}: logits differ by {worst[name]}")
        agree[name] = agree.get(name, 0) + int(
            (lk.argmax(-1) == other.argmax(-1)).sum())
        steps[name] = steps.get(name, 0) + lk.shape[0]

    (kp, ks), (pp_, ps_), (gp_, gs_) = pools(), pools(), pools()
    lengths = torch.tensor([512, 400, 300], dtype=torch.int32, device=dev)
    tokens = torch.randint(3, 259, (B, T), generator=gen, device=dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev) \
        .expand(B, T).contiguous()
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)

    def gathered(tok, pos, offsets, valid, last_pos=None):
        """The gather view's forward on gp_/gs_: dequantize the rows'
        pages, dense attention, requantize."""
        view = gather_view(gp_, gs_, table, spec, bf16)
        out = forward_cached(params, cfg, tok, pos, view, rows, offsets,
                             valid, last_pos=last_pos)
        scatter_view(gp_, gs_, table, view, spec)
        return out

    q = dict(quant_spec=spec)
    lk = forward_paged(params, cfg, tokens, positions, kp, table, lengths,
                       last_pos=lengths - 1, scales=ks, **q)
    lp = forward_paged(params, cfg, tokens, positions, pp_, table, lengths,
                       last_pos=lengths - 1, scales=ps_, plain=True, **q)
    lg = gathered(tokens, positions, zeros, lengths, lengths - 1)
    compare("paged_vs_plain", lk[:, 0], lp[:, 0])
    # The gather view attends to a call's own K/V before it requantizes
    # them (as the JAX engine does), pool-direct after: over a 512-row
    # chunk the two also differ by that int8 rounding, so the chunk's
    # difference is reported, and each decode step compares the two on
    # the same quantized cells (the view reads a copy of the kernel
    # path's pools), where only the step's own token differs so.
    gather_chunk_err = float((lk[:, 0] - lg[:, 0]).abs().max())
    cur, valid = lk[:, 0].argmax(-1), lengths.clone()
    for _ in range(16):
        tok, pos = cur[:, None], valid[:, None]
        for (dk, dv), (sk, sv) in zip(gp_ + gs_, kp + ks):
            dk.copy_(sk)
            dv.copy_(sv)
        lg = gathered(tok, pos, valid, valid + 1)
        lk = forward_paged(params, cfg, tok, pos, kp, table, valid + 1,
                           scales=ks, **q)
        lp = forward_paged(params, cfg, tok, pos, pp_, table, valid + 1,
                           scales=ps_, plain=True, **q)
        compare("paged_vs_plain", lk[:, 0], lp[:, 0])
        compare("paged_vs_gather_view", lk[:, 0], lg[:, 0])
        cur, valid = lk[:, 0].argmax(-1), valid + 1

    # forward_ragged: 3 decode rows at 1600/1650/1700 random cached tokens
    # and a 1000-row chunk of a 4th sequence, on int8 pages.
    S = 4
    rtable = (torch.randperm(S * pp, generator=gen, device=dev) + 1) \
        .reshape(S, pp).to(torch.int32)
    shape = (1 + S * pp, ps, cfg.num_kv_heads, cfg.head_dim)
    def random_quantized():
        g = torch.Generator(device=dev).manual_seed(SEED + 17)
        out_p, out_s = [], []
        for _ in range(cfg.num_layers):
            kq, kss = quantize_cells(torch.randn(
                shape, generator=g, device=dev).to(bf16), spec)
            vq, vss = quantize_cells(torch.randn(
                shape, generator=g, device=dev).to(bf16), spec)
            out_p.append((kq, vq))
            out_s.append((kss, vss))
        return out_p, out_s

    starts = [1599, 1649, 1699]
    dec = torch.randint(3, 259, (3,), generator=gen, device=dev)
    chunk = torch.randint(3, 259, (1000,), generator=gen, device=dev)
    table_np = rtable.cpu().numpy()
    seqs = [RaggedSeq([int(dec[i])], starts[i], table_np[i])
            for i in range(3)]
    seqs.append(RaggedSeq(chunk.tolist(), 0, table_np[3]))
    batch = build_ragged_batch(seqs, t_budget=1024, s_max=S + 1,
                               pages_per_seq=pp, scratch_page=0, pad_id=0,
                               page_size=ps)
    t = {k: torch.as_tensor(batch[k], device=dev) for k in (
        "tokens", "positions", "tables", "seq_of_block", "block_qstart",
        "query_offsets", "kv_valid", "token_pages", "token_offs",
        "last_rows")}
    ragged = {}
    for plain in (False, True):
        rp, rs = random_quantized()
        ragged[plain] = forward_ragged(
            params, cfg, t["tokens"].long(), t["positions"], rp,
            t["tables"], t["seq_of_block"], t["block_qstart"],
            t["query_offsets"], t["kv_valid"], t["token_pages"],
            t["token_offs"], t["last_rows"], plain=plain, scales=rs,
            **q)[:S]
        del rp, rs
    compare("ragged_vs_plain", ragged[False], ragged[True])

    # forward_cached: 8 slots of 8192 positions, K8/K9 with K5/K6.
    ccfg = dataclasses.replace(cfg, attn_impl="flash")
    cshape = (SLOTS, cfg.max_seq_len, cfg.num_kv_heads, cfg.head_dim)

    def cache():
        return [(torch.zeros(cshape, dtype=bf16, device=dev),
                 torch.zeros(cshape, dtype=bf16, device=dev))
                for _ in range(cfg.num_layers)]

    kc, pc = cache(), cache()
    crows = torch.tensor([5, 2, 7], dtype=torch.int32, device=dev)
    lk = forward_cached(params, ccfg, tokens, positions, kc, crows, zeros,
                        lengths, last_pos=lengths - 1)
    lp = forward_cached(params, ccfg, tokens, positions, pc, crows, zeros,
                        lengths, last_pos=lengths - 1, plain=True)
    compare("cached_vs_plain", lk[:, 0], lp[:, 0])
    cur, valid = lk[:, 0].argmax(-1), lengths.clone()
    for _ in range(16):
        tok, pos = cur[:, None], valid[:, None]
        lk = forward_cached(params, ccfg, tok, pos, kc, crows, valid,
                            valid + 1)
        lp = forward_cached(params, ccfg, tok, pos, pc, crows, valid,
                            valid + 1, plain=True)
        compare("cached_vs_plain", lk[:, 0], lp[:, 0])
        cur, valid = lk[:, 0].argmax(-1), valid + 1
    torch.cuda.synchronize()
    result = {name: {"max_abs_err": worst[name],
                     "greedy_agreement": agree[name] / steps[name]}
              for name in worst}
    for name, r in result.items():
        check(r["greedy_agreement"] >= 0.9,
              f"quant_path {name}: greedy agreement {r['greedy_agreement']}")
    emit("quant_path", layers=cfg.num_layers, weights="int4",
         pages="int8", tolerance=PATH_TOL,
         gather_view_chunk_max_abs_err=gather_chunk_err, **result)


# --- LoRA phases ---


LORA_KERNELS = ("lora_bgmv",)
# The README's `lora:` block with two seed personas.
LORA_BLOCK = {"rank": 8, "max_adapters": 8, "scale": 2.0,
              "adapters": {"skeptic": {"seed": 7, "init_std": 0.5},
                           "optimist": {"seed": 11, "init_std": 0.5}}}
KNIGHT_ADAPTERS = {"lancelot": None, "gawain": "skeptic",
                   "percival": "optimist"}
LORA_SESSIONS = {"alpha": [None, "skeptic", "optimist"],
                 "beta": ["optimist", "skeptic", None]}
# K7 at Llama-3-8B width: (C, O) of each target shape and its calls per
# layer (q/o, k/v, gate/up, down); 9 slots (8 adapters and the base).
LORA_SHAPES = {"q_proj/o_proj": ((4096, 4096), 2),
               "k_proj/v_proj": ((4096, 1024), 2),
               "gate_proj/up_proj": ((4096, 14336), 2),
               "down_proj": ((14336, 4096), 1)}
LORA_SLOTS, LORA_RANK = 9, 8
# K7's group form: one layer's four input groups, (C, (O_t, ...)), and the
# rows' adapter slots of each case (3 personas; a base row; 64 rows of 3
# personas and the base).
LORA_GROUPS = {"q/k/v": (4096, (4096, 1024, 1024)),
               "o_proj": (4096, (4096,)),
               "gate/up": (4096, (14336, 14336)),
               "down_proj": (14336, (4096,))}
LORA_GROUP_IDS = {"3 personas": [1, 2, 3], "base row": [0, 1, 2],
                  "64 rows": [i % 4 for i in range(64)]}


def lora_stacks(torch, gen, c, o, dev):
    """One target's 9-slot (a_t, b_s) at a persona's scale, slot 0 the
    all-zero base adapter, in bf16 on the card."""
    bf16 = torch.bfloat16
    a_t = (torch.randn(LORA_SLOTS, LORA_RANK, c, generator=gen, device=dev)
           * c ** -0.5).to(bf16)
    b_s = (torch.randn(LORA_SLOTS, LORA_RANK, o, generator=gen, device=dev)
           * 0.04).to(bf16)
    a_t[0] = 0
    b_s[0] = 0
    return a_t, b_s


def lora_group_bytes(ids, m, c, outs):
    """(bytes, flops) one group call needs: each distinct nonzero
    adapter's A and B rows per target, x, and every y read and written
    once; the products of the non-base rows."""
    distinct = len(set(ids) - {0})
    rows = sum(1 for i in ids if i)
    r = LORA_RANK
    return (sum(distinct * r * (c + o) * 2 + 2 * m * o * 4 for o in outs)
            + m * c * 2,
            sum(2 * rows * r * (c + o) for o in outs))


def lora_group_case(torch, klora, lora_mod, x, stacks, y0, ids, flush,
                    distinct_bytes):
    """One group call (lora_bgmv_add) against bgmv_add_ref (KERNEL_TOL)
    and against itself (bit for bit), then its device times: warm
    (graph_ms on the same stacks), cold (cold_calls), the plain version's
    and the yardstick's (the grouped einsums plus the add, both ways);
    `launch_ms` is one call between CUDA events after an L2 flush."""
    def fresh():
        return [y.clone() for y in y0]

    ref = fresh()
    klora.bgmv_add_ref(x, stacks, ref, ids)
    out, again = fresh(), fresh()
    klora.lora_bgmv_add(x, stacks, out, ids)
    klora.lora_bgmv_add(x, stacks, again, ids)
    errs = [max_err(torch, o, r) for o, r in zip(out, ref)]
    err = max(e for e, _ in errs)
    check(all(ok for _, ok in errs),
          f"K7's group form disagrees with its plain version by {err}")
    same = all(bool(torch.equal(a, b)) for a, b in zip(out, again))
    check(same, "two identical K7 group calls differ")
    work = fresh()

    def kernel(st):
        klora.lora_bgmv_add(x, st, work, ids)

    def plain(st):
        klora.bgmv_add_ref(x, st, work, ids)

    def library(st):
        for (a_t, b_s), y in zip(st, work):
            y += lora_mod.grouped_bmm(x, a_t, b_s, ids)

    t = {"max_abs_err": err, "repeat_bit_identical": same,
         "ms": graph_ms(torch, lambda: kernel(stacks)),
         "plain_ms": graph_ms(torch, lambda: plain(stacks)),
         "library_ms": graph_ms(torch, lambda: library(stacks)),
         "cold_ms": graph_ms(torch, cold_calls(stacks, distinct_bytes,
                                               kernel), replays=3),
         "library_cold_ms": graph_ms(torch, cold_calls(
             stacks, distinct_bytes, library), replays=3),
         "launch_ms": time_ms(torch, lambda: kernel(stacks), 50, flush)}
    return t


def lora_kernels_phase(torch):
    """K7 alone. Its group form (lora_bgmv_add, the engine's call) at one
    layer's four input groups under three cases (3 rows of 3 personas; a
    base row; 64 rows of 3 personas and the base), each against its plain
    version (KERNEL_TOL) and twice for the same bits, with device times
    from CUDA-graph replays - warm on the same stacks and cold over
    distinct copies (cold_calls) - beside the bound (lora_group_bytes) and
    the grouped einsums plus the add (the yardstick), timed both ways.
    Then the one-target form (lora_bgmv, the JAX counterpart) at the four
    target shapes, 3 rows of 3 personas, as before: against its plain
    version, twice for the same bits, warm device times beside the
    grouped einsums."""
    from theroundtaible_tpu_torch.engine import lora as lora_mod
    from theroundtaible_tpu_torch.engine.kernels import lora as klora
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    flush = torch.empty(16 << 20, dtype=torch.float32, device=dev)
    groups = {}
    for name, (c, outs) in LORA_GROUPS.items():
        stacks = [lora_stacks(torch, gen, c, o, dev) for o in outs]
        for case, id_list in LORA_GROUP_IDS.items():
            m = len(id_list)
            ids = torch.tensor(id_list, dtype=torch.int32, device=dev)
            x = torch.randn(m, c, generator=gen, device=dev).to(bf16)
            y0 = [torch.randn(m, o, generator=gen, device=dev)
                  for o in outs]
            nbytes, flops = lora_group_bytes(id_list, m, c, outs)
            distinct = len(set(id_list) - {0})
            t = lora_group_case(
                torch, klora, lora_mod, x, stacks, y0, ids, flush,
                sum(distinct * LORA_RANK * (c + o) * 2 for o in outs))
            t.update(c=c, o=list(outs), rows=m, adapters=distinct,
                     base_rows=id_list.count(0), rank=LORA_RANK,
                     bytes=nbytes, flops=flops)
            t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops)
            groups.setdefault(case, {})[name] = t
            gc.collect()
        del stacks
    ids = torch.tensor([1, 2, 3], dtype=torch.int32, device=dev)
    m, r = ids.numel(), LORA_RANK
    targets = {}
    for name, ((c, o), per_layer) in LORA_SHAPES.items():
        x = torch.randn(m, c, generator=gen, device=dev).to(bf16)
        a_t, b_s = lora_stacks(torch, gen, c, o, dev)
        fn = lambda: klora.lora_bgmv(x, a_t, b_s, ids)  # noqa: E731
        ref = lambda: klora.bgmv_ref(x, a_t, b_s, ids)  # noqa: E731
        lib = lambda: lora_mod.grouped_bmm(x, a_t, b_s, ids)  # noqa: E731
        first = fn()
        err, ok = max_err(torch, first, ref())
        check(ok, f"{name}: K7 disagrees with its plain version by {err}")
        same = bool(torch.equal(first, fn()))
        check(same, f"{name}: two identical K7 calls differ")
        distinct = len(set(ids.tolist()))
        t = {"c": c, "o": o, "rows": m, "rank": r, "per_layer": per_layer,
             "max_abs_err": err, "repeat_bit_identical": same,
             "grouped_max_abs_err": max_err(torch, first, lib())[0],
             "ms": graph_ms(torch, fn), "plain_ms": graph_ms(torch, ref),
             "library_ms": graph_ms(torch, lib),
             "launch_ms": time_ms(torch, fn, 50, flush),
             "bytes": distinct * r * (c + o) * 2 + m * c * 2 + m * o * 4,
             "flops": 2 * m * r * (c + o)}
        t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["flops"])
        targets[name] = t
        del x, a_t, b_s
    layer = {case: lora_layer_total(g) for case, g in groups.items()}
    emit("lora_kernels", tolerance=KERNEL_TOL, groups=groups, layer=layer,
         targets=targets)
    return {"groups": groups, "layer": layer, "targets": targets}


LORA_TIMES = ("ms", "plain_ms", "library_ms", "cold_ms", "library_cold_ms")


def lora_layer_total(cases):
    """One layer's group calls summed: each time, bytes and flops, and the
    bound of the sum."""
    total = {k: sum(t[k] for t in cases.values())
             for k in LORA_TIMES + ("bytes", "flops")}
    total["bound_ms"], total["bound_by"] = bound_ms(total["bytes"],
                                                    total["flops"])
    return total


def lora_round_phase(torch, reference):
    """The engine phase's config with every knight greedy, the README's
    `lora:` block and `knight_adapters`: warmup() and the two rounds (K1,
    K2 and K7 must launch in each). `lora_paths` must put every decode
    dispatch of the seven targets on K7 and only prefill-sized rows on the
    grouped einsums; the mixed batch must have suppressed sharing. Each
    knight's round-1 tokens against its adapter served alone are
    reported."""
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    from theroundtaible_tpu_torch.engine.kernels.lora import kernel_path
    from theroundtaible_tpu_torch.engine.kvcache import scoped_slot
    from theroundtaible_tpu_torch.engine.lora import lora_dims
    config = {k: v for k, v in ENGINE_CONFIG.items()
              if k != "knight_sampling"}
    config.update(lora=LORA_BLOCK, knight_adapters=KNIGHT_ADAPTERS)
    torch.cuda.reset_peak_memory_stats()
    adapter = TorchLlmAdapter.from_config("torch-llm-llama3-lora", config)
    t0 = time.monotonic()
    engine = adapter._get_engine()
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    check(engine.lora is not None, f"no LoRA store: {engine.lora_reason}")
    warm_s = engine.warmup()
    emit("lora_engine", construct_s=build_s, warmup_s=warm_s,
         store=engine.lora.describe(),
         memory_allocated=torch.cuda.memory_allocated())
    totals, generated, stats = serve_rounds(
        torch, None, adapter, engine, "lora_round",
        required=PAGED_KERNELS[:2] + LORA_KERNELS,
        forbidden=CONTIGUOUS_KERNELS)
    d = engine.lora_describe()
    paths = d["lora_paths"]
    targets = set(lora_dims(engine.cfg))
    kernel_leaves = {e["leaf"] for e in paths[kernel_path(engine.device)]}
    check(kernel_leaves == targets,
          f"lora_round: K7 served {sorted(kernel_leaves)} at decode, not "
          f"all of {sorted(targets)}")
    grouped = paths["xla_grouped_bmm"]
    check(all(e.get("fallback_reason") == "rows:prefill-m" for e in grouped),
          f"lora_round: a dispatch left K7 for another reason: {grouped}")
    check(d["share_suppressed"] >= 1,
          "lora_round: the mixed-adapter batch did not suppress sharing")
    agreement = {}
    prompts = knight_prompts(1)
    for k, p in prompts.items():
        engine.generate_batch([(k, p)], max_new_tokens=32,
                              session="lora-alone",
                              adapters_per_turn=[KNIGHT_ADAPTERS[k]])
        start = len(engine.tokenizer.encode(p))
        alone = engine.kv._slots[scoped_slot("lora-alone", k)].tokens[start:]
        mixed = generated[1][k]
        agreement[k] = sum(a == b for a, b in zip(alone, mixed)) / max(
            len(alone), len(mixed), 1)
    for name in engine.kv.slot_names():
        if name.startswith(scoped_slot("lora-alone", "")):
            engine.kv.release(name)
    emit("lora_round_summary",
         prefill_s=[stats[r]["prefill_seconds"] for r in (1, 2)],
         decode_ms_per_step=[decode_ms_per_step(stats[r]) for r in (1, 2)],
         bf16_decode_ms_per_step=reference["decode_ms_per_step"],
         greedy_agreement_with_alone=agreement,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         apply_tokens=d["apply_tokens"],
         # K7 wrapper calls per decode step of 3 rows: one per input group
         # (q/k/v, o_proj, gate/up, down_proj) and layer, 4 x 32 = 128,
         # where the per-target form made 7 x 32 (prefill rows take the
         # grouped einsums).
         lora_bgmv_per_decode_step=totals["lora_bgmv"] / max(
             sum(stats[r]["decode_tokens"] for r in (1, 2)) / 3, 1),
         share_suppressed=d["share_suppressed"],
         lora_paths={p: sorted({(e["leaf"], e["rows"]) for e in v})
                     for p, v in paths.items()},
         launches=totals)
    return totals, engine, {
        "prefill_s": [stats[r]["prefill_seconds"] for r in (1, 2)],
        "decode_ms_per_step": [decode_ms_per_step(stats[r]) for r in (1, 2)],
        "generated": generated}


def lora_path_phase(torch, cfg):
    """The whole path at full width, depth cut to 2 layers, a mixed-adapter
    batch (base, skeptic, optimist): one 512-row chunk and 8 decode steps
    of forward_paged with K7 at decode, against K7's plain version and the
    grouped einsums on their own pools, teacher-forced with the kernel
    path's tokens (logits within PATH_TOL); then one decode step of an
    int8 store (grouped einsums, quant:int8-stack) against K7 over a bf16
    store holding its dequantized values, on copies of the same pools. The
    chunk's logits without LoRA must equal the base row's bit for bit
    (slot 0's delta is exactly zero) and differ on the persona rows."""
    from theroundtaible_tpu_torch.engine.lora import (LoraBatch, LoraStore,
                                                      _dequant_stack)
    from theroundtaible_tpu_torch.engine.models.common import init_params
    from theroundtaible_tpu_torch.engine.paged_forward import forward_paged
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    cfg = dataclasses.replace(cfg, num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    params = init_params(cfg, gen, bf16, dev)
    kw = dict(rank=LORA_RANK, max_adapters=8, scale=2.0, dtype=bf16,
              adapters=LORA_BLOCK["adapters"], device=dev)
    store = LoraStore(cfg, **kw)
    slots = store.acquire([None, "skeptic", "optimist"])
    B, T, ps = 3, 512, 128
    pp = cfg.max_seq_len // ps
    table = (torch.randperm(B * pp, generator=gen, device=dev) + 1) \
        .reshape(B, pp).to(torch.int32)
    shape = (1 + B * pp, ps, cfg.num_kv_heads, cfg.head_dim)
    modes = ("auto", "plain", "grouped")
    pools = {mode: [(torch.zeros(shape, dtype=bf16, device=dev),
                     torch.zeros(shape, dtype=bf16, device=dev))
                    for _ in range(cfg.num_layers)] for mode in modes}
    lengths = torch.tensor([512, 400, 300], dtype=torch.int32, device=dev)
    tokens = torch.randint(3, 259, (B, T), generator=gen, device=dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev) \
        .expand(B, T).contiguous()
    worst = {"plain": 0.0, "grouped": 0.0}
    agree = {"plain": 0, "grouped": 0}
    steps = 0

    def compare(lk, other, mode):
        diff = (lk - other).abs()
        worst[mode] = max(worst[mode], float(diff.max()))
        check(bool(torch.isfinite(lk).all()), "non-finite K7 logits")
        check(bool((diff <= PATH_TOL + PATH_TOL * other.abs()).all()),
              f"lora_path: K7 and {mode} logits differ by {worst[mode]}")
        agree[mode] += int((lk.argmax(-1) == other.argmax(-1)).sum())

    def run(mode, tok, pos, valid, last_pos=None, pool=None, lora=None):
        return forward_paged(
            params, cfg, tok, pos, pool or pools[mode], table, valid,
            last_pos=last_pos,
            lora=lora or LoraBatch(store, slots, mode=mode))[:, 0]

    out = {mode: run(mode, tokens, positions, lengths, lengths - 1)
           for mode in modes}
    base_pools = [(torch.zeros(shape, dtype=bf16, device=dev),
                   torch.zeros(shape, dtype=bf16, device=dev))
                  for _ in range(cfg.num_layers)]
    base = forward_paged(params, cfg, tokens, positions, base_pools, table,
                         lengths, last_pos=lengths - 1)[:, 0]
    del base_pools
    persona_shift = [float((base[i] - out["auto"][i]).abs().max())
                     for i in range(B)]
    check(persona_shift[0] == 0.0 and min(persona_shift[1:]) > 0.0,
          f"lora_path: logits shift from the base model by {persona_shift} "
          f"(the base row must not move, the persona rows must)")
    for mode in ("plain", "grouped"):
        compare(out["auto"], out[mode], mode)
    steps += B
    cur = out["auto"].argmax(-1)
    valid = lengths.clone()
    for _ in range(8):
        out = {mode: run(mode, cur[:, None], valid[:, None], valid + 1)
               for mode in modes}
        for mode in ("plain", "grouped"):
            compare(out["auto"], out[mode], mode)
        steps += B
        cur = out["auto"].argmax(-1)
        valid = valid + 1
    # One int8-store step against K7 on its dequantized values.
    store8 = LoraStore(cfg, quant="int8", **kw)
    check(store8.acquire([None, "skeptic", "optimist"]) == slots,
          "the int8 store placed the personas in other slots")
    deq = LoraStore(cfg, **kw)
    deq.stacked = {k: {t: _dequant_stack(v, bf16) for t, v in ent.items()}
                   for k, ent in store8.stacked.items()}
    copies = [[(k.clone(), v.clone()) for k, v in pools["auto"]]
              for _ in range(2)]
    l8 = run("auto", cur[:, None], valid[:, None], valid + 1,
             pool=copies[0], lora=LoraBatch(store8, slots))
    lq = run("auto", cur[:, None], valid[:, None], valid + 1,
             pool=copies[1], lora=LoraBatch(deq, slots))
    diff8 = (lq - l8).abs()
    check(bool(torch.isfinite(l8).all()) and bool(
        (diff8 <= PATH_TOL + PATH_TOL * l8.abs()).all()),
        f"lora_path: the int8 store's step differs from K7 by "
        f"{float(diff8.max())}")
    torch.cuda.synchronize()
    emit("lora_path", layers=cfg.num_layers, batch=B, chunk=T,
         decode_steps=8, adapters=[None, "skeptic", "optimist"],
         max_abs_err_vs_plain=worst["plain"],
         max_abs_err_vs_grouped=worst["grouped"],
         greedy_agreement_vs_plain=agree["plain"] / steps,
         greedy_agreement_vs_grouped=agree["grouped"] / steps,
         int8_store_max_abs_err=float(diff8.max()), tolerance=PATH_TOL,
         persona_shift_from_base=persona_shift)
    del pools, copies


# --- tensor parallelism: two ranks on one card ---

TP_MESH = {"data": 1, "model": 2}
TP_BACKEND = "gloo"     # NCCL refuses two ranks on one card
TP_KERNELS = ("flash_attention_spmd", "paged_decode_spmd",
              "paged_prefill_spmd", "ragged_paged_spmd")
# Lines a rank's phase function emits are kept here and handed to the
# parent, which prints one line per phase.
_CAPTURE: list = []
_IN_RANK = False


def tp_launch(*calls):
    """`calls` - (name of a tp_* rank function below, its arguments) - one
    after another on 2 ranks spawned once, sharing cuda:0 over gloo (a
    spawn and its ranks' CUDA start cost seconds each). Returns, per call,
    each rank's (result, captured lines); a failing rank raises here
    (distributed.RankFailed)."""
    from theroundtaible_tpu_torch.engine import distributed
    ranks = distributed.launch(tp_rank, 2, TP_BACKEND, "cuda:0",
                               args=(calls,), timeout_s=1100)
    return [[r[i] for r in ranks] for i in range(len(calls))]


def tp_rank(rank, calls):
    """A spawned rank: run each call's phase function, capturing what it
    emits."""
    global _IN_RANK
    import torch
    sys.path.insert(0, str(ROOT))
    _IN_RANK = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for phase, args in calls:
        _CAPTURE.clear()
        result = globals()[phase](torch, rank, *args)
        out.append((result, list(_CAPTURE)))
    return out


def tp_mesh():
    from theroundtaible_tpu_torch.engine.sharding import build_mesh
    return build_mesh(dict(TP_MESH))


def _shard(x, axis, rank, parts=2):
    n = x.shape[axis] // parts
    return x.narrow(axis, rank * n, n).contiguous()


def _turns(torch, rank, fn):
    """fn() on each rank in turn (a barrier between), so CUDA-event times
    of one rank never overlap the other's launches on the shared card."""
    import torch.distributed as dist
    out = None
    for r in range(2):
        if r == rank:
            out = fn()
        torch.cuda.synchronize()
        dist.barrier()
    return out


def tp_kernels_rank(torch, rank):
    """K10a-d on this rank's half of the kernels phase's shapes (H=16, K=4
    per rank, D=128, page 128; the same rows, chunks and kv_valid), plus
    K10b/c on int8 and int4 pages (K4): each against its plain version on
    the card, and against the single-device kernel's output on the full
    heads (this rank's slice of it). Times per rank from CUDA events, each
    rank timing alone; the per-shard bound; SDPA on the per-shard gathered
    view as the yardstick."""
    from theroundtaible_tpu_torch.engine import kv_quant as kvq
    from theroundtaible_tpu_torch.engine.kernels import attention as kattn
    mesh = tp_mesh()
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)   # same draws
    flush = torch.empty(16 << 20, dtype=torch.float32, device=dev)
    H, K, D, ps, B = 32, 8, 128, 128, 3
    heads = (H, K)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa
    errs, timing = {}, {}

    def check_case(name, out, plain, full, rows=None):
        # The plain version within KERNEL_TOL; the single-device kernel's
        # output on this rank's heads bit for bit (the same kernel on the
        # same heads).
        err, ok = max_err(torch, out, plain, rows)
        err_full, _ = max_err(torch, out, full, rows)
        errs[name] = {"max_abs_err": err, "vs_single_device": err_full}
        check(ok and err_full == 0.0, f"{name} on rank {rank}: {errs[name]}")

    def rank_times(name, fn, ref, sdpa, bytes_, flops, reps=20):
        t = _turns(torch, rank, lambda: {
            "ms": time_ms(torch, fn, reps, flush),
            "plain_ms": time_ms(torch, ref, 3, flush),
            "sdpa_view_ms": sdpa()})
        t["bytes"], t["flops"] = bytes_, flops
        t["bound_ms"], t["bound_by"] = bound_ms(bytes_, flops)
        timing[name] = t

    # K10b (K1): decode at 1600/1650/1700 cached tokens
    k_pool, v_pool, table = make_pool(torch, gen, B, 8192, K, D, ps, bf16,
                                      dev)
    valid_l = [1600, 1650, 1700]
    valid = i32(valid_l)
    poison_past_frontier(k_pool, v_pool, table, valid, ps)
    q = (torch.randn(B, 1, H, D, generator=gen, device=dev)
         * D ** -0.5).to(bf16)
    full = kattn.paged_decode_attention(q, k_pool, v_pool, table, valid)
    ql, kp, vp = _shard(q, 2, rank), _shard(k_pool, 2, rank), \
        _shard(v_pool, 2, rank)
    args = (mesh, ql, kp, vp, table, valid)
    check_case("paged_decode_spmd",
               kattn.paged_decode_spmd(*args, heads=heads),
               kattn.paged_decode_spmd_ref(*args, heads=heads),
               _shard(full, 2, rank))
    cells = kv_cells(valid_l, [v - 1 for v in valid_l], None)
    rank_times(
        "paged_decode_spmd",
        lambda: kattn.paged_decode_spmd(*args, heads=heads),
        lambda: kattn.paged_decode_spmd_ref(*args, heads=heads),
        lambda: sdpa_view_ms(torch, ql, kp, vp, table, valid, None, flush),
        2 * ql.numel() * 2 + cells * (K // 2) * D * 2 * 2,
        cells * (H // 2) * D * 4, reps=50)
    # K4 inside K1/K2 under the wrappers: int8 and int4 pages
    for bits in (8, 4):
        kq, vq, kw = quantized_pools(kvq, k_pool, v_pool, bits)
        fq = kattn.paged_decode_attention(q, kq, vq, table, valid, **kw)
        kql, vql = _shard(kq, 2, rank), _shard(vq, 2, rank)
        kwl = dict(kw, k_scale=_shard(kw["k_scale"], 2, rank),
                   v_scale=_shard(kw["v_scale"], 2, rank))
        args_q = (mesh, ql, kql, vql, table, valid)
        check_case(f"paged_decode_spmd:int{bits}",
                   kattn.paged_decode_spmd(*args_q, heads=heads, **kwl),
                   kattn.paged_decode_spmd_ref(*args_q, heads=heads, **kwl),
                   _shard(fq, 2, rank))
        qp = (torch.randn(B, 256, H, D, generator=gen, device=dev)
              * D ** -0.5).to(bf16)
        offs = i32([1200, 1200, 1200])
        vpre = offs + 256
        fq = kattn.paged_prefill_attention(qp, kq, vq, table, offs, vpre,
                                           **kw)
        args_q = (mesh, _shard(qp, 2, rank), kql, vql, table, offs, vpre)
        check_case(f"paged_prefill_spmd:int{bits}",
                   kattn.paged_prefill_spmd(*args_q, heads=heads, **kwl),
                   kattn.paged_prefill_spmd_ref(*args_q, heads=heads,
                                                **kwl),
                   _shard(fq, 2, rank))
        del kq, vq, kw, kwl, kql, vql
    # K10c (K2): a 512-row chunk over a 1.2k prefix
    offsets_l, lengths_l, T = [1200, 1200, 1200], [300, 320, 340], 512
    offsets = i32(offsets_l)
    valid_l = [o + n for o, n in zip(offsets_l, lengths_l)]
    valid = i32(valid_l)
    q = (torch.randn(B, T, H, D, generator=gen, device=dev)
         * D ** -0.5).to(bf16)
    full = kattn.paged_prefill_attention(q, k_pool, v_pool, table, offsets,
                                         valid)
    ql = _shard(q, 2, rank)
    args = (mesh, ql, kp, vp, table, offsets, valid)
    check_case("paged_prefill_spmd",
               kattn.paged_prefill_spmd(*args, heads=heads),
               kattn.paged_prefill_spmd_ref(*args, heads=heads),
               _shard(full, 2, rank), rows=lengths_l)
    cells = kv_cells(valid_l, offsets_l, None)
    pairs = attended_pairs(valid_l, offsets_l, lengths_l, None)
    rank_times(
        "paged_prefill_spmd",
        lambda: kattn.paged_prefill_spmd(*args, heads=heads),
        lambda: kattn.paged_prefill_spmd_ref(*args, heads=heads),
        lambda: sdpa_view_ms(torch, ql, kp, vp, table, valid, offsets,
                             flush),
        2 * sum(lengths_l) * (H // 2) * D * 2
        + cells * (K // 2) * D * 2 * 2,
        pairs * (H // 2) * D * 4)
    del k_pool, v_pool, kp, vp
    # K10d (K3): 3 decode rows and a 1000-row chunk in a 1024-row buffer
    T = 1024
    rargs = ragged_inputs(torch, gen, RAGGED_MAIN, T, H, K, D, ps, bf16, dev)
    full = kattn.ragged_paged_attention(*rargs)
    local = (_shard(rargs[0], 1, rank), _shard(rargs[1], 2, rank),
             _shard(rargs[2], 2, rank)) + tuple(rargs[3:])
    check_case("ragged_paged_spmd",
               kattn.ragged_paged_spmd(mesh, *local, heads=heads),
               kattn.ragged_paged_spmd_ref(mesh, *local, heads=heads),
               _shard(full, 1, rank))
    valid_l = [o + m for o, m in RAGGED_MAIN]
    cells = kv_cells(valid_l, [o for o, _ in RAGGED_MAIN], None)
    pairs = attended_pairs(valid_l, [o for o, _ in RAGGED_MAIN],
                           [m for _, m in RAGGED_MAIN], None)
    rank_times(
        "ragged_paged_spmd",
        lambda: kattn.ragged_paged_spmd(mesh, *local, heads=heads),
        lambda: kattn.ragged_paged_spmd_ref(mesh, *local, heads=heads),
        lambda: sdpa_ragged_ms(torch, local, RAGGED_MAIN, flush),
        2 * T * (H // 2) * D * 2 + cells * (K // 2) * D * 2 * 2,
        pairs * (H // 2) * D * 4, reps=20)
    del rargs, local
    # K10a (K9 decode, K8 prefill) on an 8-slot cache through a row map
    rows_l = [5, 2, 7]
    rows = i32(rows_l)
    valid_l = [1600, 1650, 1700]
    valid = i32(valid_l)
    kc, vc = slot_cache(torch, gen, K, D, bf16, dev, valid_l, rows_l)
    kcl, vcl = _shard(kc, 2, rank), _shard(vc, 2, rank)
    q = (torch.randn(B, 1, H, D, generator=gen, device=dev)
         * D ** -0.5).to(bf16)
    full = kattn.ragged_decode_attention(q, kc, vc, valid, rows=rows)
    ql = _shard(q, 2, rank)
    args = (mesh, ql, kcl, vcl, valid - 1, valid)
    check_case("flash_attention_spmd",
               kattn.flash_attention_spmd(*args, heads=heads, rows=rows),
               kattn.flash_attention_spmd_ref(*args, heads=heads, rows=rows),
               _shard(full, 2, rank))
    cells = kv_cells(valid_l, [v - 1 for v in valid_l], None)
    rank_times(
        "flash_attention_spmd",
        lambda: kattn.flash_attention_spmd(*args, heads=heads, rows=rows),
        lambda: kattn.flash_attention_spmd_ref(*args, heads=heads,
                                               rows=rows),
        lambda: sdpa_slots_ms(torch, ql, kcl, vcl, rows, valid, None, flush),
        2 * ql.numel() * 2 + cells * (K // 2) * D * 2 * 2,
        cells * (H // 2) * D * 4, reps=50)
    offsets_l, lengths_l, T = [1200, 1200, 1200], [300, 320, 340], 512
    offsets = i32(offsets_l)
    valid_l = [o + n for o, n in zip(offsets_l, lengths_l)]
    valid = i32(valid_l)
    q = (torch.randn(B, T, H, D, generator=gen, device=dev)
         * D ** -0.5).to(bf16)
    full = kattn.flash_prefill_attention(q, kc, vc, offsets, valid,
                                         rows=rows)
    ql = _shard(q, 2, rank)
    args = (mesh, ql, kcl, vcl, offsets, valid)
    check_case("flash_attention_spmd:prefill",
               kattn.flash_attention_spmd(*args, heads=heads, rows=rows),
               kattn.flash_attention_spmd_ref(*args, heads=heads, rows=rows),
               _shard(full, 2, rank), rows=lengths_l)
    cells = kv_cells(valid_l, offsets_l, None)
    pairs = attended_pairs(valid_l, offsets_l, lengths_l, None)
    rank_times(
        "flash_attention_spmd:prefill",
        lambda: kattn.flash_attention_spmd(*args, heads=heads, rows=rows),
        lambda: kattn.flash_attention_spmd_ref(*args, heads=heads,
                                               rows=rows),
        lambda: sdpa_slots_ms(torch, ql, kcl, vcl, rows, valid, offsets,
                              flush),
        2 * sum(lengths_l) * (H // 2) * D * 2
        + cells * (K // 2) * D * 2 * 2,
        pairs * (H // 2) * D * 4)
    del kc, vc, kcl, vcl
    replica_cases(torch, kattn, rank, gen, check_case)
    torch.cuda.synchronize()
    return {"errs": errs, "timing": timing}


def spmd_device_phase(torch, kattn):
    """Device times (device_ms()) of K10a's decode route, K10b, K10c and
    K10d on rank 0's shard of tp_kernels' shapes (H=16, K=4 of H=32, K=8),
    beside SDPA's on the shard's gathered view, cells or slot rows, and of
    K10e's seven per-shard products of one layer (tp_quant_kernels'
    shapes) beside torch.matmul on the shard's pre-dequantized weight -
    taken in this process: a rank's wrapper launches the one-device kernel
    on its shard (bit for bit, tp_kernels; a row product returns its
    partial sum, which the forward all-reduces), and torch.profiler in a
    spawned gloo rank delivered device events for only its first profiled
    window."""
    from theroundtaible_tpu_torch.engine.kernels import int4mm
    from theroundtaible_tpu_torch.engine.models import common
    from theroundtaible_tpu_torch.engine.sharding import Mesh, plan_int4_shard
    mesh = Mesh(1, 2, 0)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(16 << 20, dtype=torch.float32, device=dev)
    H, K, D, ps, B = 32, 8, 128, 128, 3
    heads = (H, K)
    valid_l, rows_l = [1600, 1650, 1700], [5, 2, 7]
    valid = torch.tensor(valid_l, dtype=torch.int32, device=dev)
    rows = torch.tensor(rows_l, dtype=torch.int32, device=dev)
    out = {}
    k_pool, v_pool, table = make_pool(torch, gen, B, 8192, K, D, ps, bf16,
                                      dev)
    poison_past_frontier(k_pool, v_pool, table, valid, ps)
    q = (torch.randn(B, 1, H, D, generator=gen, device=dev)
         * D ** -0.5).to(bf16)
    ql, kp, vp = (_shard(x, 2, 0) for x in (q, k_pool, v_pool))
    args = (mesh, ql, kp, vp, table, valid)
    out["paged_decode_spmd"] = {
        "device_ms": device_ms(torch, lambda: kattn.paged_decode_spmd(
            *args, heads=heads), flush),
        "library_device_ms": device_ms(torch, sdpa_view_call(
            torch, ql, kp, vp, table, valid, None), flush)}
    offs = torch.tensor([1200, 1200, 1200], dtype=torch.int32, device=dev)
    pvalid = offs + torch.tensor([300, 320, 340], dtype=torch.int32,
                                 device=dev)
    qp = _shard((torch.randn(B, 512, H, D, generator=gen, device=dev)
                 * D ** -0.5).to(bf16), 2, 0)
    args = (mesh, qp, kp, vp, table, offs, pvalid)
    out["paged_prefill_spmd"] = {
        "device_ms": device_ms(torch, lambda: kattn.paged_prefill_spmd(
            *args, heads=heads), flush),
        "library_device_ms": device_ms(torch, sdpa_view_call(
            torch, qp, kp, vp, table, pvalid, offs), flush)}
    del k_pool, v_pool, kp, vp, qp
    rargs = ragged_inputs(torch, gen, RAGGED_MAIN, 1024, H, K, D, ps, bf16,
                          dev)
    local = (_shard(rargs[0], 1, 0), _shard(rargs[1], 2, 0),
             _shard(rargs[2], 2, 0)) + tuple(rargs[3:])
    k10d_kernels = {}
    out["ragged_paged_spmd"] = {
        "device_ms": device_ms(torch, lambda: kattn.ragged_paged_spmd(
            mesh, *local, heads=heads), flush, by_kernel=k10d_kernels),
        "device_kernels_ms": k10d_kernels,
        "library_device_ms": device_ms(torch, sdpa_ragged_call(
            torch, local, RAGGED_MAIN), flush)}
    del rargs, local
    kc, vc = slot_cache(torch, gen, K, D, bf16, dev, valid_l, rows_l)
    kcl, vcl = _shard(kc, 2, 0), _shard(vc, 2, 0)
    del kc, vc
    args = (mesh, ql, kcl, vcl, valid - 1, valid)
    out["flash_attention_spmd"] = {
        "device_ms": device_ms(torch, lambda: kattn.flash_attention_spmd(
            *args, heads=heads, rows=rows), flush),
        "library_device_ms": device_ms(torch, sdpa_slots_call(
            torch, ql, kcl, vcl, rows, valid, None), flush)}
    del kcl, vcl
    products = {}
    for name, (spec, tp, w_shape, a_shape, w_ax, a_ax, per_layer) in \
            TP_INT4_SHAPES.items():
        if not per_layer:
            continue
        axis = len(w_shape) - 1
        q4 = _shard(torch.randint(-128, 128, (*w_shape[:-1], w_shape[-1] // 2),
                                  generator=gen, device=dev,
                                  dtype=torch.int8), w_ax, 0)
        s4 = _shard((torch.rand(*w_shape[:-1], w_shape[-1] // INT4_GROUP,
                                generator=gen, device=dev) * 0.025
                     + 0.005).to(bf16), w_ax, 0)
        a = torch.randn(*a_shape, generator=gen, device=dev).to(bf16)
        a_l = _shard(a, a_ax, 0) if a_ax is not None else a
        local = plan_int4_shard(spec, common.Int4Leaf(q4, s4, axis,
                                                      INT4_GROUP),
                                mesh, w_shape, tp)
        w = common.dequant_int4(local.q4, local.s4, axis, INT4_GROUP, bf16)
        x2 = a_l.reshape(3, -1)
        w2 = w.reshape(x2.shape[1], -1)
        products[name] = {
            "per_layer": per_layer,
            "device_ms": device_ms(torch, lambda: int4mm.einsum_int4_spmd(
                mesh, spec, a_l, local, w_shape=w_shape, tp=tp), flush),
            "library_device_ms": device_ms(
                torch, lambda: torch.matmul(x2, w2), flush)}
        del q4, s4, local, w, w2
    out["einsum_int4_spmd"] = {
        k: sum(p[k] * p["per_layer"] for p in products.values())
        for k in ("device_ms", "library_device_ms")}
    out["einsum_int4_spmd"]["products"] = products
    emit("tp_kernels_device", shard={"H": H // 2, "K": K // 2, "D": D},
         **out)
    return out


def replica_cases(torch, kattn, rank, gen, check_case):
    """K10b/c's pool_replicas branch on a {"data": 2, "model": 1} mesh of
    the same two ranks: 4 rows, 2 per replica, each replica's pages in its
    own half of a 2-replica pool (page ids global in the table, rebased by
    the wrapper to the rank's local half); all 32/8 heads on each rank.
    Each replica's K1/K2 output against its plain version and, bit for
    bit, against the single-device kernel on that replica's rows of the
    whole pool."""
    from theroundtaible_tpu_torch.engine.sharding import Mesh
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    mesh = Mesh(2, 1, rank)
    H, K, D, ps, S = 32, 8, 128, 128, 2048
    heads = (H, K)
    pools = [make_pool(torch, gen, 2, S, K, D, ps, bf16, dev)
             for _ in range(2)]
    per = pools[0][0].shape[0]
    k_pool = torch.cat([p[0] for p in pools])
    v_pool = torch.cat([p[1] for p in pools])
    table = torch.cat([pools[0][2], pools[1][2] + per])
    valid = torch.tensor([1600, 1650, 1700, 1750], dtype=torch.int32,
                         device=dev)
    poison_past_frontier(k_pool, v_pool, table, valid, ps)
    local = slice(2 * rank, 2 * rank + 2)
    kp, vp = k_pool[rank * per:(rank + 1) * per], \
        v_pool[rank * per:(rank + 1) * per]
    kw = dict(heads=heads, batch=4, pool_replicas=2)
    q = (torch.randn(4, 1, H, D, generator=gen, device=dev)
         * D ** -0.5).to(bf16)
    full = kattn.paged_decode_attention(q, k_pool, v_pool, table, valid)
    args = (mesh, q[local].contiguous(), kp, vp, table[local].contiguous(),
            valid[local].contiguous())
    check_case("paged_decode_spmd:replicas",
               kattn.paged_decode_spmd(*args, **kw),
               kattn.paged_decode_spmd_ref(*args, **kw), full[local])
    T = 256
    offsets = valid - T
    q = (torch.randn(4, T, H, D, generator=gen, device=dev)
         * D ** -0.5).to(bf16)
    full = kattn.paged_prefill_attention(q, k_pool, v_pool, table, offsets,
                                         valid)
    args = (mesh, q[local].contiguous(), kp, vp, table[local].contiguous(),
            offsets[local].contiguous(), valid[local].contiguous())
    check_case("paged_prefill_spmd:replicas",
               kattn.paged_prefill_spmd(*args, **kw),
               kattn.paged_prefill_spmd_ref(*args, **kw), full[local])


def tp_kernels_phase(ranks):
    per_rank = [r for r, _ in ranks]
    emit("tp_kernels", backend=TP_BACKEND, mesh=TP_MESH, tolerance=KERNEL_TOL,
         shapes={"H_per_rank": 16, "K_per_rank": 4, "D": 128, "ps": 128},
         ranks=per_rank)
    return per_rank


_COLLECTIVES: dict = {}


def time_collectives(torch):
    """Wrap the forward's two collectives (engine/distributed.py), once per
    process, to add up, per call, the host's wait for the card's queued
    work (the gloo path's host copy waits for it anyway) and the
    collective itself. Returns the running totals: a phase reads their
    change over its rounds."""
    from theroundtaible_tpu_torch.engine import distributed
    if _COLLECTIVES:
        return _COLLECTIVES
    totals = _COLLECTIVES
    totals.update(calls=0, device_wait_s=0.0, collective_s=0.0)

    def timed(fn):
        def call(*args, **kwargs):
            t0 = time.monotonic()
            torch.cuda.synchronize()
            t1 = time.monotonic()
            out = fn(*args, **kwargs)
            totals["calls"] += 1
            totals["device_wait_s"] += t1 - t0
            totals["collective_s"] += time.monotonic() - t1
            return out
        return call

    for name in ("all_reduce_sum", "all_gather_cat"):
        setattr(distributed, name, timed(getattr(distributed, name)))
    return totals


def tp_round_rank(torch, rank, layout):
    """A 32-layer llama-3-8b-instruct engine on this rank's half of the
    model (`"mesh": {"data": 1, "model": 2}`), warmup() and the engine
    phase's two rounds through execute_round; the layout's K10 wrappers
    and kernels must launch in each round, the other layout's never. The
    rounds' collectives are timed (time_collectives)."""
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    from theroundtaible_tpu_torch.engine.kernels import attention as kattn
    config = dict(ENGINE_CONFIG, mesh=dict(TP_MESH))
    if layout == "contiguous":
        del config["kv_layout"]
        required = ("flash_attention_spmd",) + CONTIGUOUS_KERNELS
        forbidden = PAGED_KERNELS + TP_KERNELS[1:]
    else:
        required = TP_KERNELS[1:3] + PAGED_KERNELS[:2]
        forbidden = CONTIGUOUS_KERNELS + TP_KERNELS[:1]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    adapter = TorchLlmAdapter.from_config("torch-llm-llama3", config)
    t0 = time.monotonic()
    engine = adapter._get_engine()
    torch.cuda.synchronize()
    construct_s = time.monotonic() - t0
    d = engine.describe()
    check(d["mesh"] == TP_MESH and d["kv_layout"] == layout,
          f"built mesh {d['mesh']}, layout {d['kv_layout']}")
    warm_s = engine.warmup()
    phase = "tp_round" if layout == "paged" else "tp_contiguous_round"
    collectives = time_collectives(torch)
    before = dict(collectives)
    t0 = time.monotonic()
    totals, generated, stats = serve_rounds(
        torch, kattn, adapter, engine, phase, required=required,
        forbidden=forbidden)
    rounds_s = time.monotonic() - t0
    out = {"construct_s": construct_s, "warmup_s": warm_s,
           "kv_bytes": engine.kv.hbm_bytes(),
           "params_per_rank": sum(
               x.numel() for layer in engine.params["layers"]
               for x in layer.values()),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "prefill_s": [stats[r]["prefill_seconds"] for r in (1, 2)],
           "decode_ms_per_step": [decode_ms_per_step(stats[r])
                                  for r in (1, 2)],
           "rounds_s": rounds_s,
           "collectives": {k: collectives[k] - before[k]
                           for k in collectives},
           "launches": totals, "generated": generated}
    from theroundtaible_tpu_torch.engine import reset_engines
    reset_engines()
    return out


def tp_round_phase(ranks, layout, single):
    """Both ranks' rounds: identical tokens on both ranks (checked), beside
    the single-device rounds of the same layout in this run (prefill
    seconds, decode ms per step, greedy agreement: reported)."""
    phase = "tp_round" if layout == "paged" else "tp_contiguous_round"
    outs = [r for r, _ in ranks]
    check(outs[0]["generated"] == outs[1]["generated"],
          f"{phase}: the two ranks returned different tokens")
    emit(phase, backend=TP_BACKEND, mesh=TP_MESH, layers=32,
         ranks=[{k: v for k, v in o.items() if k != "generated"}
                for o in outs],
         round_lines=[lines for _, lines in ranks],
         single_device={"prefill_s": single["prefill_s"],
                        "decode_ms_per_step": single["decode_ms_per_step"]},
         greedy_agreement_with_single_device=greedy_agreement(
             outs[0]["generated"], single["generated"]))
    totals = dict.fromkeys(outs[0]["launches"], 0)
    for o in outs:
        for k, n in o["launches"].items():
            totals[k] += n
    return totals


def _tp_weights(torch, mesh, seed):
    """Full-width llama-3-8b-instruct cut to 2 layers: the single-device
    weights from `seed`, and this rank's shard of the same tensors."""
    from theroundtaible_tpu_torch.engine.models.common import init_params
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.sharding import shard_params
    dev = torch.device("cuda")
    cfg = dataclasses.replace(
        get_model_config("llama-3-8b-instruct"), num_layers=2,
        attn_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(seed)
    full = init_params(cfg, gen, torch.bfloat16, dev)
    shard = shard_params(full, cfg, mesh)
    shard = {k: ([{n: w.clone() for n, w in layer.items()} for layer in v]
                 if k == "layers" else v.clone()) for k, v in shard.items()}
    return cfg, full, shard


def tp_path_rank(torch, rank):
    """2 layers at full width: one 512-row prefill chunk (rows of
    512/400/300 real tokens) and 16 decode steps of forward_paged (K10c/b)
    and of forward_cached (K10a) under TP=2, each against the
    single-device forward on the same weights, tokens and pages/slots,
    teacher-forced with the single-device greedy tokens."""
    from theroundtaible_tpu_torch.engine.models.common import forward_cached
    from theroundtaible_tpu_torch.engine.paged_forward import forward_paged
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    mesh = tp_mesh()
    cfg, full, shard = _tp_weights(torch, mesh, SEED + 7)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    B, T, ps = 3, 512, 128
    pp = cfg.max_seq_len // ps
    table = (torch.randperm(B * pp, generator=gen, device=dev) + 1) \
        .reshape(B, pp).to(torch.int32)
    rows = torch.tensor([5, 2, 7], dtype=torch.int32, device=dev)

    def zeros(shape):
        return [(torch.zeros(shape, dtype=bf16, device=dev),
                 torch.zeros(shape, dtype=bf16, device=dev))
                for _ in range(cfg.num_layers)]

    K, D = cfg.num_kv_heads, cfg.head_dim
    pools = {"single": zeros((1 + B * pp, ps, K, D)),
             "tp": zeros((1 + B * pp, ps, K // 2, D))}
    caches = {"single": zeros((SLOTS, cfg.max_seq_len, K, D)),
              "tp": zeros((SLOTS, cfg.max_seq_len, K // 2, D))}
    lengths = torch.tensor([512, 400, 300], dtype=torch.int32, device=dev)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    tokens = torch.randint(3, 259, (B, T), generator=gen, device=dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev) \
        .expand(B, T).contiguous()
    worst = {"paged": 0.0, "cached": 0.0}
    agree = {"paged": 0, "cached": 0}
    steps = 0

    def run(toks, pos, valid, last=None, offs=None):
        out = {}
        for name, params, m in (("single", full, None), ("tp", shard, mesh)):
            out[("paged", name)] = forward_paged(
                params, cfg, toks, pos, pools[name], table, valid,
                last_pos=last, mesh=m)[:, 0]
            out[("cached", name)] = forward_cached(
                params, cfg, toks, pos, caches[name], rows,
                pos[:, 0].contiguous() if offs is None else offs, valid,
                last_pos=last, mesh=m)[:, 0]
        for path in worst:
            ref, got = out[(path, "single")], out[(path, "tp")]
            diff = (got - ref).abs()
            worst[path] = max(worst[path], float(diff.max()))
            check(bool(torch.isfinite(got).all()), "non-finite TP logits")
            check(bool((diff <= PATH_TOL + PATH_TOL * ref.abs()).all()),
                  f"tp_path {path} on rank {rank}: TP and single-device "
                  f"logits differ by {worst[path]}")
            agree[path] += int((got.argmax(-1) == ref.argmax(-1)).sum())
        return out[("paged", "single")].argmax(-1)

    reset_launches()
    cur = run(tokens, positions, lengths, last=lengths - 1, offs=zero)
    steps += B
    valid = lengths.clone()
    for _ in range(16):
        cur = run(cur[:, None], valid[:, None], valid + 1)
        steps += B
        valid = valid + 1
    torch.cuda.synchronize()
    return {"max_abs_err": worst,
            "greedy_agreement": {k: v / steps for k, v in agree.items()},
            "launches": launches_now()}


def tp_path_phase(ranks):
    outs = [r for r, _ in ranks]
    for o in outs:
        check(all(o["launches"][k] > 0 for k in TP_KERNELS[:3]),
              f"tp_path: a K10 wrapper never launched: {o['launches']}")
    emit("tp_path", backend=TP_BACKEND, mesh=TP_MESH, layers=2, batch=3,
         chunk=512, decode_steps=16, tolerance=PATH_TOL,
         ranks=[{k: o[k] for k in ("max_abs_err", "greedy_agreement")}
                for o in outs])


def tp_ragged_path_rank(torch, rank):
    """The ragged_path phase's flat buffer (3 decode rows at ~1.6k cached
    tokens, a 1000-row chunk) through forward_ragged under TP=2 (K10d over
    K3) at full width, 2 layers: against its plain version, against
    forward_paged under TP=2 (K10b/c) on identical pools, and against the
    single-device forward_ragged on the whole weights and pools. The
    launch counts are zeroed just before the TP forward_ragged and read
    just after."""
    from theroundtaible_tpu_torch.engine.paged_forward import (
        forward_paged, forward_ragged)
    from theroundtaible_tpu_torch.engine.serving_loop import (
        RaggedSeq, build_ragged_batch)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    mesh = tp_mesh()
    cfg, full, shard = _tp_weights(torch, mesh, SEED + 11)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    ps, S = 128, 4
    pp = cfg.max_seq_len // ps
    table = (torch.randperm(S * pp, generator=gen, device=dev) + 1) \
        .reshape(S, pp).to(torch.int32)
    shape = (1 + S * pp, ps, cfg.num_kv_heads, cfg.head_dim)
    base = [(torch.randn(shape, generator=gen, device=dev).to(bf16),
             torch.randn(shape, generator=gen, device=dev).to(bf16))
            for _ in range(cfg.num_layers)]
    single = [(k.clone(), v.clone()) for k, v in base]
    local = [(_shard(k, 2, rank), _shard(v, 2, rank)) for k, v in base]
    kernel_pools, plain_pools, paged_pools = (
        [(k.clone(), v.clone()) for k, v in local] for _ in range(3))
    del base, local
    starts = [1599, 1649, 1699]
    dec = torch.randint(3, 259, (3,), generator=gen, device=dev)
    chunk = torch.randint(3, 259, (1000,), generator=gen, device=dev)
    table_np = table.cpu().numpy()
    seqs = [RaggedSeq([int(dec[i])], starts[i], table_np[i])
            for i in range(3)]
    seqs.append(RaggedSeq(chunk.tolist(), 0, table_np[3]))
    batch = build_ragged_batch(seqs, t_budget=1024, s_max=S + 1,
                               pages_per_seq=pp, scratch_page=0, pad_id=0,
                               page_size=ps)
    t = {k: torch.as_tensor(batch[k], device=dev) for k in (
        "tokens", "positions", "tables", "seq_of_block", "block_qstart",
        "query_offsets", "kv_valid", "token_pages", "token_offs",
        "last_rows")}

    def ragged(params, pools, plain, m):
        return forward_ragged(
            params, cfg, t["tokens"].long(), t["positions"], pools,
            t["tables"], t["seq_of_block"], t["block_qstart"],
            t["query_offsets"], t["kv_valid"], t["token_pages"],
            t["token_offs"], t["last_rows"], plain=plain, mesh=m)[:S]

    reset_launches()
    lk = ragged(shard, kernel_pools, False, mesh)
    torch.cuda.synchronize()
    launches = launches_now()
    check(launches["ragged_paged_spmd"] > 0
          and launches["ragged_paged_attention"] > 0,
          f"tp_ragged_path: K10d/K3 never launched: {launches}")
    lp = ragged(shard, plain_pools, True, mesh)
    ls = ragged(full, single, False, None)
    starts_t = torch.tensor(starts, dtype=torch.int32, device=dev)
    ld = forward_paged(shard, cfg, dec.long()[:, None], starts_t[:, None],
                       paged_pools, table[:3], starts_t + 1, mesh=mesh)
    n = torch.tensor([1000], dtype=torch.int32, device=dev)
    lc = forward_paged(shard, cfg, chunk.long()[None],
                       torch.arange(1000, dtype=torch.int32,
                                    device=dev)[None],
                       paged_pools, table[3:], n, last_pos=n - 1, mesh=mesh)
    lpg = torch.cat([ld[:, 0], lc[:, 0]])
    torch.cuda.synchronize()
    result = {"launches": launches}
    for name, other in (("vs_plain", lp), ("vs_paged", lpg),
                        ("vs_single_device", ls)):
        diff = (lk - other).abs()
        err = float(diff.max())
        check(bool(torch.isfinite(lk).all()), "non-finite TP ragged logits")
        check(bool((diff <= PATH_TOL + PATH_TOL * other.abs()).all()),
              f"tp_ragged_path {name} on rank {rank}: logits differ by "
              f"{err}")
        result[name] = {"max_abs_err": err, "greedy_agreement": float(
            (lk.argmax(-1) == other.argmax(-1)).float().mean())}
    return result


def tp_ragged_path_phase(ranks):
    outs = [r for r, _ in ranks]
    emit("tp_ragged_path", backend=TP_BACKEND, mesh=TP_MESH, layers=2,
         buffer=1024, tolerance=PATH_TOL, ranks=outs)
    return {k: sum(o["launches"][k] for o in outs) for k in TP_KERNELS}


# K10e at Llama-3-8B on 2 ranks: (spec, tp, whole weight shape, activation
# shape, weight axis the model axis shards, activation axis a row product
# contracts over it, calls per layer). Per shard: q [4096, 16, 128], k/v
# [4096, 4, 128], o [16, 128, 4096], gate/up [4096, 7168], down
# [7168, 4096] (K5) and the untied head [64128, 4096] (K6).
TP_INT4_SHAPES = {
    "q_proj": ("bte,ehd->bthd", "col", (4096, 32, 128), (3, 1, 4096), 1,
               None, 1),
    "k_proj/v_proj": ("bte,ekd->btkd", "col", (4096, 8, 128), (3, 1, 4096),
                      1, None, 2),
    "o_proj": ("bthd,hde->bte", "row", (32, 128, 4096), (3, 1, 32, 128), 0,
               2, 1),
    "gate_proj/up_proj": ("bte,ef->btf", "col", (4096, 14336),
                          (3, 1, 4096), 1, None, 2),
    "down_proj": ("btf,fe->bte", "row", (14336, 4096), (3, 1, 14336), 0, 2,
                  1),
    "lm_head": ("bte,ve->btv", "col", (128256, 4096), (3, 1, 4096), 0, None,
                0),
}
# K10f's group form: (C, ((O_t, the base weight's units along the sharded
# axis), ...), tp) of one layer's four input groups; 3 rows of 3 personas,
# rank 8, 9 slots.
TP_LORA_GROUPS = {
    "q/k/v": (4096, ((4096, 32), (1024, 8), (1024, 8)), "col"),
    "o_proj": (4096, ((4096, 32),), "row"),
    "gate/up": (4096, ((14336, 14336), (14336, 14336)), "col"),
    "down_proj": (14336, ((4096, 14336),), "row"),
}
TP_QUANT_WRAPPERS = ("einsum_int4_spmd", "lora_bgmv_spmd")


def _layer_total(cases):
    """One layer's calls summed: ms, plain_ms, library_ms (and the cold
    times where the cases have them), bytes, flops, and the bound of the
    sum."""
    keys = [k for k in LORA_TIMES + ("bytes", "flops")
            if all(k in t for t in cases.values())]
    total = {k: sum(t[k] * t["per_layer"] for t in cases.values())
             for k in keys}
    total["bound_ms"], total["bound_by"] = bound_ms(total["bytes"],
                                                    total["flops"])
    return total


def tp_quant_kernels_rank(torch, rank):
    """K10e (einsum_int4_spmd over K5/K6) at the six per-shard products
    and K10f (lora_bgmv_spmd over K7) at the seven targets, on this rank's
    half of Llama-3-8B's weights (int4 groups of 64; LoRA rank 8, 3 rows
    of 3 personas): each against its plain version (KERNEL_TOL); a column
    product's output against its slice of the single-device kernel's (K10f
    bit for bit, K10e within KERNEL_TOL); a row product's all-reduced
    partial sums against the single-device output (KERNEL_TOL). Times per
    rank, each rank timing alone: CUDA events after an L2 flush for K10e,
    CUDA-graph replays for K10f (as lora_kernels); the per-shard bound;
    the library call per shard: torch.matmul on the rank's weight
    dequantized to bf16 beforehand (K10e), the grouped einsums plus the
    add (K10f). K10f runs its group form (lora_bgmv_add_spmd) at one
    layer's four input groups: a column group's ys against their slices
    of the one-device group call bit for bit, a row target's partial
    (each rank adding into half the base) all-reduced against it; warm
    and cold times (graph_ms, cold_calls)."""
    from theroundtaible_tpu_torch.engine import distributed, sharding
    from theroundtaible_tpu_torch.engine import lora as lora_mod
    from theroundtaible_tpu_torch.engine.kernels import int4mm
    from theroundtaible_tpu_torch.engine.kernels import lora as klora
    from theroundtaible_tpu_torch.engine.models import common
    mesh = tp_mesh()
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)  # same draws
    flush = torch.empty(16 << 20, dtype=torch.float32, device=dev)
    int4, lora = {}, {}

    def compare(name, tp, out, plain, full, out_axis, exact):
        # A column shard against its slice of the one-device output: bit
        # for bit where `exact` (K7 sums every output column alike at any
        # width), else within KERNEL_TOL (K5 splits C by the shard's own
        # width, so gate/up's shard sums in another order).
        err, ok = max_err(torch, out, plain)
        if tp == "col" and exact:
            err_full = float((out - _shard(full, out_axis, rank)).abs().max())
            ok_full = err_full == 0.0
        elif tp == "col":
            err_full, ok_full = max_err(torch, out,
                                        _shard(full, out_axis, rank))
        else:
            total = distributed.all_reduce_sum(out.clone(), mesh.model_group)
            err_full, ok_full = max_err(torch, total, full)
        check(ok and ok_full, f"{name} on rank {rank}: plain {err}, "
                              f"single device {err_full}")
        return {"max_abs_err": err, "vs_single_device": err_full}

    for name, (spec, tp, w_shape, a_shape, w_ax, a_ax, per_layer) in \
            TP_INT4_SHAPES.items():
        axis = len(w_shape) - 1
        q4 = torch.randint(-128, 128, (*w_shape[:-1], w_shape[-1] // 2),
                           generator=gen, device=dev, dtype=torch.int8)
        s4 = (torch.rand(*w_shape[:-1], w_shape[-1] // INT4_GROUP,
                         generator=gen, device=dev) * 0.025
              + 0.005).to(bf16)
        a = torch.randn(*a_shape, generator=gen, device=dev).to(bf16)
        whole = int4mm.plan_leaf(spec, common.Int4Leaf(q4, s4, axis,
                                                       INT4_GROUP))
        full, why = int4mm.einsum_int4_or_reason(spec, a, whole)
        check(full is not None, f"{name}: K5/K6 declined: {why}")
        local = sharding.plan_int4_shard(spec, common.Int4Leaf(
            _shard(q4, w_ax, rank), _shard(s4, w_ax, rank), axis,
            INT4_GROUP), mesh, w_shape, tp)
        del whole, q4, s4
        a_l = _shard(a, a_ax, rank) if a_ax is not None else a
        kw = dict(w_shape=w_shape, tp=tp)
        fn = lambda: int4mm.einsum_int4_spmd(  # noqa: E731
            mesh, spec, a_l, local, **kw)[0]
        ref = lambda: int4mm.einsum_int4_spmd_ref(  # noqa: E731
            mesh, spec, a_l, local, **kw)[0]
        out = fn()
        check(out is not None, f"{name}: K10e declined on rank {rank}")
        t = compare(name, tp, out, ref(), full, a.dim() - 1, exact=False)
        w = common.dequant_int4(local.q4, local.s4, axis, INT4_GROUP, bf16)
        x2 = a_l.reshape(3, -1)
        if spec == common.SPEC_HEAD:
            w2 = w.t()
        else:
            w2 = w.reshape(x2.shape[1], -1)
        lib = lambda: torch.matmul(x2, w2)  # noqa: E731
        t.update(_turns(torch, rank, lambda: {
            "ms": time_ms(torch, fn, 50, flush),
            "plain_ms": time_ms(torch, ref, 3, flush),
            "library_ms": time_ms(torch, lib, 50, flush)}))
        t.update(weight_per_rank=[n // 2 if i == w_ax else n
                                  for i, n in enumerate(w_shape)],
                 tp=tp, per_layer=per_layer,
                 bytes=(local.q4.numel() + local.s4.numel() * 2
                        + a_l.numel() * 2 + out.numel() * 4),
                 flops=2 * 3 * x2.shape[1] * w2.shape[1])
        t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["flops"])
        int4[name] = t
        del local, w, w2, full, out
    ids = torch.tensor([1, 2, 3], dtype=torch.int32, device=dev)
    m, r = ids.numel(), LORA_RANK
    for name, (c, members, tp) in TP_LORA_GROUPS.items():
        outs = [o for o, _units in members]
        x = torch.randn(m, c, generator=gen, device=dev).to(bf16)
        stacks = [lora_stacks(torch, gen, c, o, dev) for o in outs]
        y0 = [torch.randn(m, o, generator=gen, device=dev) for o in outs]
        full = [y.clone() for y in y0]
        klora.lora_bgmv_add(x, stacks, full, ids)
        kw = dict(dims=[(c, o) for o in outs], tp=tp,
                  units=[u for _o, u in members])
        which = [klora.spmd_dims(mesh, c, o, tp, u)[0] for o, u in members]
        check(which == ["in" if tp == "row" else "out"] * len(members),
              f"{name}: stacks placed {which} on {TP_MESH}")
        if tp == "row":
            x_l = _shard(x, 1, rank)
            local = [(_shard(a_t, 2, rank), b_s) for a_t, b_s in stacks]
            y_l = [y / 2 for y in y0]
        else:
            x_l = x
            local = [(a_t, _shard(b_s, 2, rank)) for a_t, b_s in stacks]
            y_l = [_shard(y, 1, rank) for y in y0]
        out, plain = ([y.clone() for y in y_l] for _ in range(2))
        why = klora.lora_bgmv_add_spmd(mesh, x_l, local, out, ids, **kw)
        check(why is None, f"{name}: K10f declined on rank {rank}: {why}")
        klora.lora_bgmv_add_spmd_ref(mesh, x_l, local, plain, ids, **kw)
        per = [compare(f"{name}[{n}]", tp, o, p, f, 1, exact=True)
               for n, (o, p, f) in enumerate(zip(out, plain, full))]
        t = {"max_abs_err": max(e["max_abs_err"] for e in per),
             "vs_single_device": max(e["vs_single_device"] for e in per)}
        work = [y.clone() for y in y_l]

        def kernel(st, x_l=x_l, work=work, kw=kw):
            klora.lora_bgmv_add_spmd(mesh, x_l, st, work, ids, **kw)

        def ref(st, x_l=x_l, work=work, kw=kw):
            klora.lora_bgmv_add_spmd_ref(mesh, x_l, st, work, ids, **kw)

        def lib(st, x_l=x_l, work=work):
            for (a_t, b_s), y in zip(st, work):
                y += lora_mod.grouped_bmm(x_l, a_t, b_s, ids)

        c_l = x_l.shape[1]
        distinct = 3 * r * sum(c_l + b.shape[2] for _a, b in local) * 2
        t.update(_turns(torch, rank, lambda: {
            "ms": graph_ms(torch, lambda: kernel(local)),
            "plain_ms": graph_ms(torch, lambda: ref(local)),
            "library_ms": graph_ms(torch, lambda: lib(local)),
            "cold_ms": graph_ms(torch, cold_calls(local, distinct, kernel),
                                replays=3),
            "library_cold_ms": graph_ms(torch, cold_calls(
                local, distinct, lib), replays=3)}))
        nbytes, flops = lora_group_bytes(
            ids.tolist(), m, c_l, [b.shape[2] for _a, b in local])
        t.update(c_o_per_rank=[[c_l, b.shape[2]] for _a, b in local],
                 tp=tp, per_layer=1, bytes=nbytes, flops=flops)
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops)
        lora[name] = t
        del x, stacks, local, full, out, plain, work
        gc.collect()
    torch.cuda.synchronize()
    layer = {k: v for k, v in int4.items() if v["per_layer"]}
    return {"einsum_int4_spmd": {"cases": int4, "layer": _layer_total(layer),
                                 "head": int4["lm_head"]},
            "lora_bgmv_spmd": {"cases": lora, "layer": _layer_total(lora)}}


def tp_quant_kernels_phase(ranks):
    per_rank = [r for r, _ in ranks]
    emit("tp_quant_kernels", backend=TP_BACKEND, mesh=TP_MESH,
         tolerance=KERNEL_TOL, int4_group=INT4_GROUP, lora_rank=LORA_RANK,
         ranks=per_rank)
    return per_rank


TP_QUANT_PHASES = ("tp_quant_int8", "tp_quant_int4", "tp_lora_round")


def tp_quant_rank(torch, rank):
    """The three TP engines of this run, one after another on this rank's
    half of llama-3-8b-instruct (32 layers, `"mesh": {"data": 1, "model":
    2}`), each freed before the next: the quant_int8 and quant_int4
    configs (int8/int4 weights on int8/int4 pages), then lora_round's
    (the README's `lora:` block, knight_adapters, every knight greedy).
    warmup() and the two rounds; K10b/c with K1/K2 on the pool (K4 inside
    on quantized pages) must launch in each round, K10e with K5/K6 on
    int4, K10f with K7 under personas, and nothing else's kernels. The
    rounds' collectives are timed (time_collectives)."""
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    from theroundtaible_tpu_torch.engine import reset_engines
    from theroundtaible_tpu_torch.engine.kernels import attention as kattn
    from theroundtaible_tpu_torch.engine.kernels.int4mm import \
        kernel_path as w4a16_path
    from theroundtaible_tpu_torch.engine.kernels.lora import kernel_path
    from theroundtaible_tpu_torch.engine.lora import lora_dims
    collectives = time_collectives(torch)
    outs = {}
    for phase in TP_QUANT_PHASES:
        lora = phase == "tp_lora_round"
        required = TP_KERNELS[1:3] + PAGED_KERNELS[:2]
        forbidden = CONTIGUOUS_KERNELS + TP_KERNELS[:1]
        if lora:
            config = {k: v for k, v in ENGINE_CONFIG.items()
                      if k != "knight_sampling"}
            config.update(lora=LORA_BLOCK, knight_adapters=KNIGHT_ADAPTERS)
            required += LORA_KERNELS + ("lora_bgmv_spmd",)
            forbidden += INT4_KERNELS + ("einsum_int4_spmd",)
        else:
            extra = QUANT_CONFIGS[phase[3:]]
            bits = 8 if extra["kv_quant"] == "int8" else 4
            config = {**ENGINE_CONFIG, **extra}
            required += tuple(f"{k}:int{bits}" for k in PAGED_KERNELS[:2])
            int4 = ("einsum_int4_spmd",) + INT4_KERNELS
            if extra["quant"] == "int4":
                required += int4
                forbidden += LORA_KERNELS + ("lora_bgmv_spmd",)
            else:
                forbidden += int4 + LORA_KERNELS + ("lora_bgmv_spmd",)
        config["mesh"] = dict(TP_MESH)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        adapter = TorchLlmAdapter.from_config(f"torch-llm-{phase}", config)
        t0 = time.monotonic()
        engine = adapter._get_engine()
        torch.cuda.synchronize()
        construct_s = time.monotonic() - t0
        d = engine.describe()
        check(d["mesh"] == TP_MESH and d["quant"] == config.get(
            "quant", "none"), f"{phase} built {d['mesh']} {d['quant']}")
        warm_s = engine.warmup()
        before = dict(collectives)
        t0 = time.monotonic()
        totals, generated, stats = serve_rounds(
            torch, kattn, adapter, engine, phase, required=required,
            forbidden=forbidden)
        rounds_s = time.monotonic() - t0
        out = {"construct_s": construct_s, "warmup_s": warm_s,
               "params": engine.num_params,
               "kv_bytes": engine.kv.hbm_bytes(),
               "num_pages": engine.kv.num_pages,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "prefill_s": [stats[r]["prefill_seconds"] for r in (1, 2)],
               "decode_ms_per_step": [decode_ms_per_step(stats[r])
                                      for r in (1, 2)],
               "rounds_s": rounds_s,
               "collectives": {k: collectives[k] - before[k]
                               for k in collectives},
               "launches": totals, "generated": generated}
        if lora:
            paths = engine.lora_describe()["lora_paths"]
            kernel_leaves = {e["leaf"] for e in paths[kernel_path(
                engine.device)]}
            check(kernel_leaves == set(lora_dims(engine.cfg)),
                  f"{phase}: K10f served {sorted(kernel_leaves)} at decode")
            out["store"] = engine.lora.describe()
            reasons = {e.get("fallback_reason")
                       for e in paths["xla_grouped_bmm"]}
        elif config["quant"] == "int4":
            paths = d["int4_paths"]
            reasons = {e.get("fallback_reason")
                       for e in paths["xla_dequant"]}
            check(paths[w4a16_path(engine.device)] and reasons <= {
                "rows:prefill-m/sharded", "rows:prefill-m"},
                f"{phase}: a decode product left K10e: {reasons}")
        else:
            reasons = set()
        out["fallback_reasons"] = sorted(r for r in reasons if r)
        outs[phase] = out
        reset_engines()
        del engine, adapter
    return outs


def tp_quant_phase(ranks, single):
    """Both ranks' int8, int4 and LoRA rounds: identical tokens on both
    ranks (checked), beside this run's single-device rounds of the same
    config (prefill seconds, decode ms per step, greedy agreement per
    knight - the persona rows against the single-device persona rows -
    reported). Returns the launches of both ranks, by wrapper."""
    totals = {}
    for phase in TP_QUANT_PHASES:
        outs = [r[phase] for r, _ in ranks]
        check(outs[0]["generated"] == outs[1]["generated"],
              f"{phase}: the two ranks returned different tokens")
        ref = single[phase]
        agreement = {}
        for k in ref["generated"][1]:
            same = total = 0
            for rnd in (1, 2):
                a, b = outs[0]["generated"][rnd][k], ref["generated"][rnd][k]
                total += max(len(a), len(b))
                same += sum(x == y for x, y in zip(a, b))
            agreement[k] = same / max(total, 1)
        emit(phase, backend=TP_BACKEND, mesh=TP_MESH, layers=32,
             ranks=[{k: v for k, v in o.items() if k != "generated"}
                    for o in outs],
             round_lines=[[x for x in lines if x["phase"] == phase]
                          for _, lines in ranks],
             single_device={"prefill_s": ref["prefill_s"],
                            "decode_ms_per_step": ref["decode_ms_per_step"]},
             greedy_agreement_with_single_device=agreement)
        for o in outs:
            for k, n in o["launches"].items():
                totals[k] = totals.get(k, 0) + n
    return totals


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from theroundtaible_tpu_torch.engine.kernels import attention \
            as kattn
        from theroundtaible_tpu_torch.engine.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the theroundtaible_tpu_torch package is not "
              f"next to this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "phases.jsonl").unlink(missing_ok=True)
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.monotonic()
    build.build_all()
    emit("build", seconds=time.monotonic() - t0,
         sources=list(build.SOURCES))
    logs = build.build_logs()
    for name, log in logs.items():
        (OUT / f"{name}.ptxas.log").write_text(log)
    emit("ptxas", kernels={name: ptxas_summary(log)
                           for name, log in logs.items()})
    for name in ("paged_decode", "ragged_decode"):
        kernels = " ".join(ptxas_summary(logs.get(name, "")))
        check("decode_split_kernel" in kernels
              and "decode_combine_kernel" in kernels,
              f"{name} holds no split-KV decode kernels")
    hgmma = hgmma_counts(build)
    emit("tensor_cores", hgmma=hgmma)
    check(all(n is None or n > 0 for n in hgmma.values()),
          f"the bf16 prefill kernels hold no HGMMA: {hgmma}")

    kernels = kernels_phase(torch, kattn)
    emit("kernels_check", tolerance=KERNEL_TOL,
         decode_cases=kernels["decode_cases"],
         prefill_cases=kernels["prefill_cases"],
         ragged_cases=kernels["ragged_cases"],
         contiguous_decode_cases=kernels["cdecode_cases"],
         contiguous_prefill_cases=kernels["cprefill_cases"])
    emit("kernels_timing", **kernels["timing"])
    spmd_device = spmd_device_phase(torch, kattn)
    qerrs, qtiming, w4 = quant_kernels_phase(torch, kattn)

    launches, engine, reference = engine_phase(torch, kattn)
    bf16_profile = profile_phase(torch, engine)
    path_phase(torch, engine)
    ragged_path_phase(torch, engine)
    # The scheduler path's own counts: K3 runs only there. Then the same
    # two sessions again with the ragged dispatches under torch.profiler.
    launches["ragged_paged_attention"] = scheduler_phase(
        torch, kattn, engine)["ragged_paged_attention"]
    scheduler_phase(torch, kattn, engine, phase="scheduler_profiled",
                    profiled=3)

    # Release the paged engine (the engine cache holds it too) before the
    # contiguous one takes its weights and 8.6 GB of slots.
    from theroundtaible_tpu_torch.engine import reset_engines
    reset_engines()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    contiguous, engine, contiguous_ref = contiguous_phase(
        torch, kattn, reference["generated"])
    for name in CONTIGUOUS_KERNELS:
        launches[name] = contiguous[name]
    profile_phase(torch, engine, phase="contiguous_profile")
    contiguous_path_phase(torch, engine)
    scheduler_phase(torch, kattn, engine, phase="contiguous_scheduler")

    # Quantization: int8 weights on int8 pages, then int4 on int4 pages
    # with its scheduler phase (K3 on int4 pages), then the 2-layer path.
    quant, single = {}, {}
    for phase in QUANT_CONFIGS:
        reset_engines()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        quant[phase], engine, single[f"tp_{phase}"] = quant_engine_phase(
            torch, kattn, phase, reference)
    sched = scheduler_phase(torch, kattn, engine, phase="quant_scheduler")
    check(sched["ragged_paged_attention:int4"] > 0,
          f"quant_scheduler: K3 never launched on int4 pages: {sched}")
    for name, n in sched.items():
        quant["quant_int4"][name] += n
    cfg = engine.cfg
    reset_engines()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    quant_path_phase(torch, cfg)

    # Multi-LoRA personas: K7 alone, the 32-layer LoRA engine's rounds and
    # its scheduler (K7 at decode, K3 with per-token adapter ids), then
    # the 2-layer path.
    lora_timing = lora_kernels_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()
    lora_launches, engine, single["tp_lora_round"] = lora_round_phase(
        torch, reference)
    lora_profile = profile_phase(torch, engine, phase="lora_profile",
                                 adapters=list(KNIGHT_ADAPTERS.values()))
    # K7's kernels, and the f32 adds of each profiled call: the bf16 call
    # has rope's; the LoRA call's delta adds are gone into K7.
    emit("lora_profile_kernels",
         bgmv_ms=kernel_ms(lora_profile, "bgmv"),
         add_f32_ms=kernel_ms(lora_profile, "CUDAFunctor_add<float>"),
         bf16_add_f32_ms=kernel_ms(bf16_profile, "CUDAFunctor_add<float>"))
    sched = scheduler_phase(torch, kattn, engine, phase="lora_scheduler",
                            adapters=LORA_SESSIONS)
    lora_launches = {k: n + sched[k] for k, n in lora_launches.items()}
    cfg = engine.cfg
    reset_engines()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    lora_path_phase(torch, cfg)

    # Tensor parallelism: two ranks sharing the card over gloo (the kernels
    # built above; every engine of this process released first), three
    # spawns: the K10 wrappers alone (K10a-d, then K10e/K10f); the 32-layer
    # TP engines one after another - bf16 on both layouts, then int8, int4
    # and LoRA on the paged pool - beside this run's single-device rounds
    # of the same configs; the 2-layer paths.
    gc.collect()
    torch.cuda.empty_cache()
    runs = tp_launch(("tp_kernels_rank", ()), ("tp_quant_kernels_rank", ()))
    tp_timing = tp_kernels_phase(runs[0])
    tp_quant_timing = tp_quant_kernels_phase(runs[1])
    runs = tp_launch(("tp_round_rank", ("paged",)),
                     ("tp_round_rank", ("contiguous",)),
                     ("tp_quant_rank", ()))
    tp_launches = tp_round_phase(runs[0], "paged", reference)
    for name, n in tp_round_phase(runs[1], "contiguous",
                                  contiguous_ref).items():
        tp_launches[name] += n
    tp_quant_launches = tp_quant_phase(runs[2], single)
    runs = tp_launch(("tp_path_rank", ()), ("tp_ragged_path_rank", ()))
    tp_path_phase(runs[0])
    tp_launches["ragged_paged_spmd"] = tp_ragged_path_phase(runs[1])[
        "ragged_paged_spmd"]

    src = "theroundtaible_tpu_torch/engine/kernels/csrc/"
    rows = []
    for name, kind, source, replaces, library in (
            ("paged_decode_attention", "decode", "paged_decode.cu",
             "theroundtaible_tpu/engine/pallas/attention.py:891", None),
            ("paged_prefill_attention", "prefill", "paged_prefill.cu",
             "theroundtaible_tpu/engine/pallas/attention.py:374", None),
            # K3: SDPA over the pre-gathered, block-diagonally masked view
            # is the one-call yardstick; K1/K2 keep theirs beside null.
            ("ragged_paged_attention", "ragged", "ragged_paged.cu",
             "theroundtaible_tpu/engine/pallas/attention.py:1160",
             "sdpa_view_ms"),
            # K8/K9: SDPA over the batch's slot rows.
            ("flash_prefill_attention", "cprefill", "flash_prefill.cu",
             "theroundtaible_tpu/engine/pallas/attention.py:216",
             "sdpa_ms"),
            ("ragged_decode_attention", "cdecode", "ragged_decode.cu",
             "theroundtaible_tpu/engine/pallas/attention.py:1339",
             "sdpa_ms")):
        t = kernels["timing"][kind]
        cases = kernels[f"{kind}_cases"]
        rows.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t[library] if library else None,
            "sdpa_view_ms": t.get("sdpa_view_ms", t.get("sdpa_ms")),
            **({"device_ms": t["device_ms"],
                "library_device_ms": t["sdpa_device_ms"]}
               if "device_ms" in t else {})})
    # K4: K1 at the decode serving shape on int8 / int4 pages; its
    # yardstick is the same kernel on the unquantized pool. Launches: the
    # K1-K3 launches on quantized pools in the quant phases.
    for bits in (8, 4):
        t = qtiming[bits]["decode"]
        rows.append({
            "name": f"kv_dequant_int{bits}", "route": "cuda",
            "source": src + "paged_common.cuh",
            "replaces": "theroundtaible_tpu/engine/pallas/attention.py:48",
            "launches": sum(n for counts in quant.values()
                            for k, n in counts.items()
                            if k.endswith(f":int{bits}")),
            "max_abs_err": max(c["max_abs_err"] for c in qerrs[bits]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"]})
    # K5: one layer's seven decode projections; K6: the 128256-row head.
    # Yardstick: torch.matmul on the weight dequantized to bf16 beforehand.
    k5 = [(t, t["per_layer"]) for n, t in w4.items() if n != "lm_head"]
    for name, replaces, parts in (
            ("mm_pack_out", "theroundtaible_tpu/engine/pallas/int4mm.py:165",
             k5),
            ("mm_pack_contract",
             "theroundtaible_tpu/engine/pallas/int4mm.py:205",
             [(w4["lm_head"], 1)])):
        total = {k: sum(t[k] * n for t, n in parts)
                 for k in ("ms", "plain_ms", "library_ms", "bytes", "flops",
                           "device_ms", "library_device_ms")}
        bound, by = bound_ms(total["bytes"], total["flops"])
        rows.append({
            "name": name, "route": "cuda", "source": src + "int4mm.cu",
            "replaces": replaces, "launches": quant["quant_int4"][name],
            "max_abs_err": max(t["max_abs_err"] for t, _ in parts),
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": bound, "bound_by": by,
            "library_ms": total["library_ms"],
            "device_ms": total["device_ms"],
            "library_device_ms": total["library_device_ms"]})
    # K7: one layer's four group calls at 3 rows of 3 personas, warm (`ms`)
    # and cold; yardstick: the grouped einsums plus the add, both ways.
    # Launches: the wrapper calls of the lora_round and lora_scheduler
    # phases (two kernels each).
    total = lora_timing["layer"]["3 personas"]
    rows.append({
        "name": "lora_bgmv", "route": "cuda", "source": src + "bgmv.cu",
        "replaces": "theroundtaible_tpu/engine/pallas/lora.py:133",
        "launches": lora_launches["lora_bgmv"],
        "max_abs_err": max(
            [t["max_abs_err"] for g in lora_timing["groups"].values()
             for t in g.values()]
            + [t["max_abs_err"] for t in lora_timing["targets"].values()]),
        **{k: total[k] for k in LORA_TIMES},
        "bound_ms": total["bound_ms"], "bound_by": total["bound_by"]})
    # K10a-d: each wrapper over its CUDA kernel on one rank's half of the
    # heads (K10a at K9's decode shape, K10b/c/d at K1/K2/K3's); the slower
    # rank's time (each rank timed alone), the per-shard bound, SDPA on
    # the per-shard gathered view. Launches: both ranks' in the TP rounds
    # (K10a-c) and tp_ragged_path (K10d).
    pallas = "theroundtaible_tpu/engine/pallas/attention.py"
    for name, line in (("flash_attention_spmd", 570),
                       ("paged_decode_spmd", 806),
                       ("paged_prefill_spmd", 464),
                       ("ragged_paged_spmd", 1266)):
        per = [r["timing"][name] for r in tp_timing]
        rows.append({
            "name": name, "route": "cuda",
            "source": "theroundtaible_tpu_torch/engine/kernels/attention.py",
            "replaces": f"{pallas}:{line}", "launches": tp_launches[name],
            "max_abs_err": max(e["max_abs_err"] for r in tp_timing
                               for k, e in r["errs"].items()
                               if k.split(":")[0] == name),
            "ms": max(t["ms"] for t in per),
            "plain_ms": max(t["plain_ms"] for t in per),
            "bound_ms": per[0]["bound_ms"], "bound_by": per[0]["bound_by"],
            "library_ms": max(t["sdpa_view_ms"] for t in per),
            "ms_per_rank": [t["ms"] for t in per],
            **spmd_device.get(name, {})})
    # K10e/K10f: one layer's seven per-shard products (K5) or calls (K7)
    # on one rank, the slower rank's time (each rank timed alone), the
    # per-shard bound, the library call per shard (torch.matmul on the
    # rank's pre-dequantized weight; the grouped einsums). Launches: both
    # ranks' in tp_quant_int4 / tp_lora_round.
    for name, replaces, source in (
            ("einsum_int4_spmd", "theroundtaible_tpu/engine/pallas/"
             "int4mm.py:428", "int4mm.py"),
            ("lora_bgmv_spmd", "theroundtaible_tpu/engine/pallas/"
             "lora.py:179", "lora.py")):
        per = [r[name] for r in tp_quant_timing]
        layer = [p["layer"] for p in per]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"theroundtaible_tpu_torch/engine/kernels/{source}",
            "replaces": replaces, "launches": tp_quant_launches[name],
            "max_abs_err": max(t["max_abs_err"] for p in per
                               for t in p["cases"].values()),
            "ms": max(t["ms"] for t in layer),
            "plain_ms": max(t["plain_ms"] for t in layer),
            "bound_ms": layer[0]["bound_ms"], "bound_by": layer[0]["bound_by"],
            "library_ms": max(t["library_ms"] for t in layer),
            **{k: max(t[k] for t in layer) for k in LORA_TIMES[3:]
               if k in layer[0]},
            "ms_per_rank": [t["ms"] for t in layer],
            **{k: v for k, v in spmd_device.get(name, {}).items()
               if k != "products"}})
    summary = {"kernels": rows}
    (OUT / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
