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
             of its schedule, and RAGGED_VERIFY_EDGES, speculative verify
             buffers: 17 sequences, runs of 1-5 rows ending at kv_valid - 1
             after 1,500-8,000 cached positions, runs crossing a page end,
             tree paths sharing all but a loaned frontier page, G 1, 4
             and 16, D 64 and 256, three of them on int8 and int4 pages
             too; every case also against ragged_tile_ref;
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
             torch.profiler (device_ms(): one session, the windows
             holding every kernel of the call; between CUDA events where
             fewer than 20 do, each such call in a `device_ms_by_events`
             line and counted in the `device_timing` line); for K1, K9
             and K3
             `device_kernels_ms`, each kernel's (K3: its prefill tiles,
             split and combine), and for K3 the same buffer with only its
             decode rows and with only its chunk (`decode_rows_only`,
             `chunk_only`: ms, device_ms, device_kernels_ms), and the
             17-sequence verify buffer at Llama-3-8B's shape (`verify`:
             ms, device_ms, plain_ms, SDPA and its bound).
   tp_kernels_device - the same device times for K10a's decode route,
             K10b, K10c and K10d on rank 0's shard (H=16, K=4), and K10e's
             seven per-shard products of one layer beside torch.matmul on
             the pre-dequantized shard, taken in this process.
4. engine  - InferenceEngine.from_config for llama-3-8b-instruct (full
             width cut to ENGINE_LAYERS = 16 layers, seeded random
             weights, byte tokenizer),
             paged pool, bf16, 8 slots, max_seq_len 8192; warmup(); two
             3-knight rounds through TorchLlmAdapter.execute_round whose
             prompts share a long prefix, the second extending the first
             (two knights greedy, one sampling top-k/top-p).
             The kernels' launch counts are zeroed before and read after
             each round: both kernels must have launched.
5. profile - torch.profiler over one decode-dominated engine call
             (PROFILE_STEPS decode steps, cut from 32 to 16 and then 8 to
             keep the script inside its time limit: each cut halves the
             profiler's post-processing in the six profile phases): wall time,
             device busy share, kernel time by name.
6. path    - one prefill chunk and 16 decode steps of forward_paged at full
             width with the depth cut to 2 layers, through the kernels and
             through the plain versions, logits compared.
7. ragged_path - one flat buffer (3 decode rows at ~1.6k cached tokens and
             a 1000-row chunk) through forward_ragged at full width, 2
             layers: K3 against its plain version, and forward_ragged
             against forward_paged (K1 for the decode rows, K2 for the
             chunk) on identical pools; logits compared.
8. scheduler - the engine phase's engine behind a SessionScheduler:
             session alpha (the round-1 prompts, 96 greedy tokens) and
             session beta (another 1.2k preamble) submitted once alpha has
             live rows, so beta joins through ragged mixed dispatches.
             K1, K2 and K3 must all launch within the phase; beta's TTFT,
             alpha's decode rate and the ragged dispatches' walls are
             printed. Then the same sessions again
             (`scheduler_profiled`) with the first three ragged dispatches
             under torch.profiler (`ragged_profiled`: wall, device time and
             K3's share of it). The phases built from ENGINE_CONFIG pin
             `spec_decode: false`, `prefix_cache: false` and `kv_offload:
             false`, so their numbers are the 1-token path's without the
             cache, comparable with runs before speculative decoding and
             before the prefix cache.
8a. spec_path - a speculative verify dispatch at full width, 2 layers:
             forward_ragged with `sample_rows` (three rows' runs of 5 at
             1.6k-1.8k cached tokens, one crossing a page end, and two
             tree paths on loaned pages with copy pairs) through K3
             against its plain version, and each scored row against
             forward_paged decoding the same tokens one at a time
             through K1 (the output invariance), logits within PATH_TOL;
             a tree path's first row equal to its trunk's bit for bit.
8b. spec_scheduler - one session of 3 greedy rows (the round-1 prompts,
             160 new tokens) on the 32-layer engine (ENGINE_CONFIG whole,
             built once the engine phase's is released) six ways: speculation
             off, the n-gram chain, the n-gram tree {branch 2, depth 3},
             the `model` drafter on the engine's own weights (chain and
             tree) and the `lora` drafter (lora_round's `lora:` block,
             persona skeptic),
             the spec runs on engines sharing the weights. Each run's wall,
             tokens per second, verify dispatches, drafted and accepted
             tokens, tree nodes and K1/K2/K3/K7 launches; every spec run
             has its drafter, verify dispatches with K3 launched and
             greedy agreement >= 0.9 with the off run, the lora run K7
             launched in its draft dispatches, the model run acceptance
             >= 0.9, the model tree run tree rows on loaned pages. Q1:
             where a spec run's row first differs from the off run's, the
             off run's prefix is rerun to that position through K2 and the
             top-2 logit margin there must be below PATH_TOL, the K3-vs-K1
             logit difference spec_path allows (`flips`, `flip_margins`).
8c. prefix_path - the cross-session prefix cache at full width: an engine
             on the engine phase's weights (32 layers, paged bf16, 8 slots,
             max_seq_len 8192, page 128, greedy) with the cache on. s1: 3
             knights whose prompts open with one 3,000-token preamble; s2:
             the same preamble, its own tails, on this engine and on the
             engine phase's (cache off). s2 must attach 23 pages per row
             (hits >= 3, prefix_reused_tokens >= 3 x 23 x 128) aliasing
             s1's page ids (refcount >= 2), prefill from the page-multiple
             frontier through K2 and decode through K1, agree >= 0.9 with
             the cache-off run's greedy tokens and hold its first-position
             logits within PATH_TOL of them. s3 attaches, then diverges
             inside preamble page 7 at its next turn: a copy-on-write (or
             forget), and s1's pages torch.equal to a snapshot taken before
             s3. s2's prefill tokens, prefill seconds and TTFT (the
             prefill seconds: the first token is read at its end) beside
             the cache-off run's.
8d. offload_path - the host-RAM offload tier at full width: the same
             weights on a pool cut to 143 pages (2.2 GiB of 16 MiB pages;
             the engine phase's has 257), the prefix cache off (the tier
             alone, as JAX's tests isolate it), behind a SessionScheduler
             with idle_spill_s 12. Session A (3 knights, 2.5k tokens each)
             serves a round and goes idle; B serves one, C is admitted: A
             must spill under pressure. A's next turn joins while C
             decodes: its admission spills B, restores A - its pages,
             copied to the host before the spill, torch.equal right after
             the restore - and its delta rides C's ragged dispatches (K3
             over the restored pages); the turn must reuse its committed
             transcript less one page per row and agree >= 0.9 with the
             engine phase's engine (A never leaves its pool) serving the
             same turns; then a session idle for idle_spill_s spills
             (reason "idle"). K1, K2 and K3 must launch. Each spill and
             restore's ms and GB/s beside the host-link bound (nvidia-smi
             pcie.link.gen/width, else the device's sysfs entry, else the
             data sheet's Gen5 x16).
9. contiguous - the paged engine released, TorchLlmAdapter.from_config
             with the engine phase's config minus `kv_layout`, cut to
             CONTIGUOUS_LAYERS = 16 layers: the default
             builds a contiguous engine (8 slots of 8192 positions,
             attention resolved to K8/K9); warmup() and the same two
             rounds. K8 and K9 must launch in each round, K1-K3 never;
             prefill/decode seconds, reused tokens, cache bytes and peak
             memory are printed.
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
             `"int4"`/`"int4"`, from TorchLlmAdapter.from_config at full
             width with the depth cut to TP_LAYERS = 8 (TP_MODEL; 32
             until phases 41-44 joined, then 16), warmup() and the same two rounds: K1/K2
             must launch on the quantized pool, K5/K6 on int4 and never on
             int8, and the int4 engine's plan (`int4_paths`) must send only
             prefill-sized products past them. Pages, pool bytes, peak
             memory, decode ms per step beside the unquantized engine
             phase's rounds (ENGINE_LAYERS); then the profile phase on
             each (quant_int8_profile, quant_int4_profile).
             offload_int8: on the int8 engine, one 3-knight session
             spilled to host RAM and restored (a HostOffloadTier over it:
             its config pins the tier off), int8 payload and f32 scales
             torch.equal, ms and GB/s per direction beside the host-link
             bound.
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
             LORA_LAYERS = 16 layers: warmup() and two
             rounds through execute_round. K1,
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
five TP engines one after another, each freed before the next: full
width with the depth cut to TP_LAYERS = 8, 32 until PR 17 and 16 until
PR 19, to keep the script in its limit), then 22 and 23.

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
             two ranks, 8 layers: warmup() and the two rounds; K10b/c and
             K1/K2 (paged) or K10a and K8/K9 (contiguous) must launch on
             every rank, the other layout's kernels never, and both ranks
             must return the same tokens. Prefill seconds and decode ms per
             step beside this run's single-device rounds,
             per-rank peak memory, the rounds' collectives (calls, the
             host's wait for the card, the gloo calls).
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
             knight_adapters) plus `"mesh": {"data": 1, "model": 2}`, 8
             layers: warmup() and the two rounds; K10b/c with K1/K2 on the
             pool must launch on every rank, K10e with K5/K6 on int4 and
             K10f with K7 under personas, nothing else's kernels, and both
             ranks must return the same tokens. Prefill seconds, decode ms
             per step, peak memory and collectives per rank beside this
             run's single-device rounds of the same config (8 layers for
             int8 and int4, 32 for LoRA).

Then the main path from a checkpoint, in this process again:

26. checkpoint - the engine phase's model from seeded weights (paged,
             bf16, 32 layers, every knight greedy), its tree written in HF
             layout by hand (write_hf_checkpoint: the inverse of
             engine/checkpoint.py's name map, 4 safetensors shards with
             model.safetensors.index.json and config.json, no tokenizer
             files) to a temporary directory. load_hf_checkpoint of that
             directory alone: its leaves torch.equal to the engine's, its
             device peak above what was allocated before it (no KV pool
             yet) held under the tree plus one layer, and the host's
             resident set (rss, file-backed, anonymous) sampled while it
             runs. Then a second engine built from `checkpoint=` that
             directory: every leaf torch.equal to the first engine's, a
             256-token forward's logits and one round's generated tokens
             equal bit for bit, K1 and K2 launched in that round. Write
             seconds, load seconds (the constructor's wall), bytes read
             (the payload of every indexed tensor), host peak RSS over the
             process (getrusage), the constructor's device peak (KV pool
             included).
27. discuss  - `discuss "<topic>" --no-read-code` through cli.main on the
             card, in a scratch git project (one tracked file, app.py)
             whose .roundtable/config.json seats 3 knights on one
             torch-llm adapter over that checkpoint (the shipped example's
             engine settings without the mesh: paged, int8 weights, 8
             slots, max_seq_len 8192; each knight 32 new tokens;
             max_rounds 2). Random weights emit no consensus block, so the
             discussion runs both rounds and escalates: rc 0, the
             session's transcript (2 rounds x 3 turns), status, discussion
             and metrics written, round 2 reusing tokens, K1 and K2
             launched and no other kernel. Each round's wall, prefill and
             reused tokens and decode ms per step. The shipped config
             keeps the defaults, so the engine builds the prefix cache and
             the offload tier: their describe() blocks are printed here
             and in summon and serve.

Then the rest of the CLI through cli.main in the same project, on the same
resident engine (get_engine dedups it), max_rounds cut to 1. The launch
counts are zeroed before and read after each phase, and each phase's K1-K3
launches ride the kernels line (`cli_launches`).

28. summon   - app.py changed and staged; `summon --no-read-code`: rc 0,
             one session whose topic holds the diff preview, one round, K1
             and K2 launched and no other kernel. Every page a summon
             prompt shares with a discuss prompt must be served from the
             cache (the row's reuse frontier past it): discuss and summon
             seat the same unscoped knight slots, so the slot's own record
             serves first and the index only beyond it; the shared pages,
             frontiers and the index's hits are printed.
29. serve    - `serve "<topic>" --sessions 2 --no-read-code`: two
             concurrent discussions behind the engine's SessionScheduler,
             speculative decoding on (the default): rc 0, two sessions
             (rounds and walls from their metrics), the scheduler's
             admitted (>= 2), max_occupancy (> 3 rows: the sessions shared
             a batch), segments, ragged_joins and spec_segments, the
             engine's spec_describe() counters; K2 launched, K1 or K3 (a
             verify tick runs K3, a joining session too). serve's sessions
             scope their slots, so where their prompts share a page with
             discuss's or summon's the index must serve it (hits > 0).
30. apply    - a session written with consensus, the torch-llm Lead Knight
             and allowed_files [app.py]; `apply --noparley`: random
             weights emit no RTDIFF/1, so the failure path - rc is
             FileWriteError's, the session's phase back at
             consensus_reached, `git status --porcelain` unchanged - with
             K1 and K2 launched.
31. code_red - `code-red "<incident>"`, depth cut to its triage and blind
             rounds (MAX_DIAG_ROUNDS 2; the doctors consult one after
             another): 2 rounds x 3 doctors, no convergence, a CR-001 entry
             in the error log; K1 and K2 launched.
32. commands - `warmup` (batch sizes [1, 3] on the resident engine: K1 and
             K2 launch), `status`, `list`, `chronicle`, `decrees` and
             `manifest list`, each rc 0, the read-only ones launching
             nothing.

Supervision and the telemetry spine, after offload_path on the engine
phase's engine (telemetry disarmed and ROUNDTABLE_SUPERVISOR at its
default in every earlier phase; flight dumps land in
chiprun_out/chip_smoke/telemetry/):

The supervision phases 33-34 and the serving phases 38-39 run an engine
of their own, SUPERVISION_CONFIG (the engine phase's config cut to
SUPERVISION_LAYERS = 8 layers, 16 before phases 55-59 joined; the
32-layer engine released first): their checks compare that engine with
itself.

33. supervised_restart - SUPERVISION_CONFIG with the offload tier
             on (8 layers, paged bf16, 8 slots, max_seq_len 8192, page
             128, seeded weights, greedy) from InferenceEngine.from_config
             behind a journaled SessionScheduler. Session A serves a round
             of 3 knights (~2.5k-token prompts) and goes idle; its pages
             are copied to the host; `device_lost` is armed and session B's
             round dies: the supervisor evacuates A to host RAM, rebuilds
             the engine from its config beside the old one, restores A and
             re-attaches; B is resubmitted (the adapter ladder's stand-in)
             and A serves round 2; on the rebuilt engine session F joins
             E's decode through ragged dispatches (K3). Then
             `engine_wedged` fires twice (hang_threshold): a second
             restart, reason hang_escalation.
             Required: the two restarts, sessions recovered, A's pages on
             the rebuilt engine torch.equal to the snapshot, every round's
             greedy tokens equal to the same turns on the engine phase's
             engine (never interrupted), a `supervisor` flight dump,
             `status --health` rendering the restart, and after the swap
             and gc `memory_allocated` within 1 GiB of one engine's
             footprint. Printed: each restart's wall and its stages
             (quiesce, evacuate, rebuild, restore, swap), the evacuated
             bytes and each direction's GB/s beside the host-link bound,
             the peak during the rebuild.
34. device_fault - a child process (the model at full width, 8 layers)
             serves two journaled sessions, then indexes a CUDA tensor far
             past its end (a device-side assert: a sticky fault). Required:
             its next submits fail classified `device_lost`; the
             supervisor's evacuation and rebuilds fail inside their budget
             (2 restarts of 2 builds); the engine is dead and the next
             submit fails fast with EngineDead of kind `device_lost`; a
             RetryPolicy around a later call makes one attempt; the child
             exits under its timeout. Printed: seconds from the fault to
             EngineDead.
35. journal_resume - a child (8 layers) runs `serve --journal DIR` on two
             topics through cli.main; SIGKILL once round 1 committed for
             both sessions. A fresh child runs `serve --resume DIR`, then
             each session's next turn on the resumed engine and on an
             engine of the same config that served the journaled turns
             live (never crashed). Required: every journaled turn
             replayed, numbering continuing, no record doubled, the next
             turns equal - or, where one row flips, a near tie there (top-2
             margin below PATH_TOL: the replay prefills in one pass what
             the live run decoded step by step). Printed: the replay's
             turns, tokens re-prefilled and seconds.
36. telemetry_overhead - on the engine phase's engine, 3 rows x 64 decode
             steps, 5 runs disarmed and 5 armed (a session sink, the
             discussion and round spans around generate_batch),
             interleaved: decode ms per step (medians, spreads) and host
             syncs per step at the port's read seams (equal required);
             every spans.jsonl line parses and holds the rungs discussion,
             round, turn, prefill, decode, segment and dispatch.
37. build_watch - the build watch's summary: every library built or
             loaded, its seconds, and 0 builds after any warmup.

The perf model and the serving gateway, after telemetry_overhead on the
engine phase's engine (38-39) and after journal_resume (40, children):

38. perf_model - the engine's perf model: chip `h100` detected from the
             card's name, param_bytes equal to the tree's stored bytes,
             the decode ceiling 3350e9 / param_bytes and the prefill peak
             989e12 / (2 x params). Rounds 1 and 2 of the 3 knights (64
             new tokens) on the direct path, then through a
             SessionScheduler with telemetry armed. Required: the
             roundtable_mfu{phase=prefill} and
             roundtable_bw_utilization{phase=decode} gauges published and
             finite after each, the memory ledger's device half (bytes in
             use, the card's total), `status --perf` and `--kv` rendering,
             a flight dump whose perf block holds the perf series and the
             span overheads. Printed beside each gauge: decode ms per
             step, the weights' share of the memory rate per step
             (param_bytes x steps/s / 3.35 TB/s) and the gauge's ratio to
             it (the row count: the gauge counts every row's tokens).
             Then one scheduled round of 192 new tokens (3 x
             DECODE_SEGMENT), whose plain segments pipeline: required,
             every segment's decode sample within a factor of 2 of the
             direct round 1's decode rate (each sample timed over its own
             segment).
39. gateway_stream - a Gateway (loopback, ephemeral port) over a journaled
             SessionScheduler on the same engine, with
             ROUNDTABLE_GATEWAY_MAX_INFLIGHT=2; http.client clients. Two
             /v1/discussions streams of the 3 knights on the round-1
             prompts, 96 new tokens: alpha (a client traceparent), then
             beta once alpha's rows are live (a ragged join through K3),
             whose client drops its socket after its first token event and
             reconnects with Last-Event-ID; a third stream, while both are
             in flight, is shed (429, Retry-After); then a chat completion
             streamed and not. Required: each stream's tokens equal the
             scheduler's own submission of the same turns in the same
             order, the non-stream reply equal to the stream, event ids
             monotone per row, the traceparent echoed and its trace
             retained, every retained trace's stage sum its leg's wall,
             /metrics holding the perf gauges, `roundtable trace` and
             `status --gateway`/`--slo` rendering, K1 and K3 launched.
             Then 3 + 3 interleaved streams of 64 tokens with and without
             a poller on /healthz and /metrics every 50 ms: decode ms per
             step of each and host syncs per step (equal required).
             Printed: TTFT by trace stage, the gaps between token events,
             tokens per second.
40. gateway_resume - a child (the model at full width, 8 layers, the
             default config: the ragged seam on) runs `roundtable gateway
             --port 0 --journal DIR` through cli.main; three clients (one
             knight each, round-1 prompts) stream 96 tokens after an
             uninterrupted solo reference of each, c1 and c2 joining c0
             through K3; SIGKILL once each client holds its first token
             event. A fresh child runs `gateway --resume DIR`; the clients
             reconnect at once with their Last-Event-ID. A regenerated
             turn is held against the gateway's sidecar of streamed
             tokens: where it left what the client holds, the reconnect
             is refused with 409 `nondeterministic_stream`. Required: no
             client spliced (`spliced` 0), every refusal that kind (its
             count: `refused_409`), each streamed rest equal to the
             tail, past the client's watermark, of the turn the resumed
             gateway served (its journal record: nothing lost or
             doubled), each resumed stream retired, at least one turn
             uncommitted at the kill (regenerated, ladder leg 3), K1 and
             K2 or K3 launched in the resumed child, and greedy parity by
             the journal_resume rule: where a served turn first leaves the
             reference, the resumed child's top-2 margin there is below
             PATH_TOL. Printed: per client, spliced or refused; the
             replay's seconds, the new child's start to its first
             reconnected event.

The session router and the load generator, after gateway_resume, on one
fleet (the engine phase's engine released first): ENGINE_CONFIG with the
offload tier on (llama-3-8b-instruct cut to ROUTER_LAYERS = 16 layers,
32 until phases 51-54 joined, paged bf16, 8 slots,
max_seq_len 8192, page 128, seeded weights, greedy) from
InferenceEngine.from_config, then build_replicas(engine, 2) - r1 rebuilt
from the recipe - with one journal behind a SessionRouter
(`router_fleet`: every leaf of r1's tree torch.equal to r0's, a 256-token
forward's logits equal bit for bit). Two schedulers dispatch from two
threads onto the card's one stream; each replica's describe() says which
engine ran a turn. 44 runs before 43, so its gateway point meets both
replicas live. The fleet is released before the contiguous phase.

41. router_handoff - session A (3 knights, the round-1 prompts, 32 new
             tokens) and an unmigrated copy on r0; A's pages copied to the
             host; migrate(A, "r1"): evacuate on r0, adopt on r1, restored
             at A's next dispatch there. Required: the record crossed, A's
             pages on r1 torch.equal to the snapshot right after the
             restore, A's round 2 on r1 reusing its committed transcript
             less one page per row, its tokens equal to the copy's round 2
             on r0 or differing only at a near tie (top-2 margin on r0
             below PATH_TOL), migrating a session in flight refused, one
             boundary crossing, K1 and K2 launched. Printed: the bytes
             moved, evacuate and restore ms and GB/s beside the host-link
             bound, each replica's load_score before and after.
42. router_roll - a Gateway(router=...) on an ephemeral port; three
             one-knight /v1/discussions streams (96 tokens) whose clients
             drop after their first token event; POST /v1/admin/roll of
             the replica holding the most sessions (the idle ones of 41
             among them). Required: 200 and ok, every idle session of the
             rolled replica migrated to the peer, the replica rebuilt
             through the supervisor, reopened and serving a new turn; each
             client's reconnect (Last-Event-ID) retiring with the tokens
             before and after equal to the turn its journal record holds
             (nothing lost or doubled); `status --fleet` naming both
             replicas and the roll, `status --health` both schedulers and
             the restart; K1 and K2 launched. Printed: the roll's wall,
             its stages as the port records them (telemetry armed for the
             roll: the router's `roll` span, its `migration` spans, the
             rest of it the drain) and the supervisor's (quiesce,
             evacuate, rebuild, restore, swap: its report in the flight
             dump), the peak memory during it beside the card's total.
43. router_failover - a fault-free reference of three one-knight streams
             (96 tokens), then three more with
             EngineSupervisor(max_restarts=0), each dispatch held
             FAILOVER_HOLD_S by `slow_dispatch`, and `device_lost` armed
             once every client holds its first token event (the prefill's
             token and a 64-step segment): the replica whose dispatch
             takes it dies, its sessions fail over to the survivor, and
             each client whose stream failed reconnects with Last-Event-ID
             and is served there. Required: the fault fired once, exactly
             one replica dead, failovers >= 1 and
             roundtable_router_failovers_total{replica=} moved, some
             stream crossed holding tokens, no stream spliced: a
             regenerated turn that left the tokens its client held is
             refused with 409 `nondeterministic_stream` (counted:
             `refused_409`), every other stream's tokens past what its
             client held equal to the served turn's tail, every
             divergence of a served turn from the reference a near tie on
             the survivor, a new session admitted and retired on the survivor,
             K1 and K2 or K3 launched. On one card an injected fault is
             the only kind that spares the survivor: a real device fault
             ends the context every replica of the process shares.
44. loadgen - `roundtable loadgen --smoke` through cli.main on the card
             from a scratch directory (its stack on a card: the JAX
             bench's, on llama-3-8b-instruct at full width cut to 2
             layers). Required: rc 0, >= 4 points, the shed point reached,
             the frontier valid (capacity.validate_record), chip `h100`
             detected, platform `cuda`, nothing written. Then one
             open-loop Poisson point (LOADGEN_RATE sessions/s for
             LOADGEN_DURATION_S s, short prompts, 16 new tokens) from
             GatewayDriver against phase 42's two-replica gateway:
             open_loop_peak() >= 2, every session completed or shed, none
             failed. Printed: the frontier, the knee, accepted tokens/s.

MoE (Mixtral) and float16, after lora_path, each engine released before
the next:

45. moe_engine - mixtral-8x7b-instruct at full width (E 4096, F 14336, 8
             experts, top-2, H 32, K 8, D 128, V 32000) cut to MOE_LAYERS
             = 4 layers, seeded bf16 weights: two 3-knight rounds on the
             paged pool (K2, K1) and on the contiguous layout (K8, K9), the
             scheduler phase on the paged engine (K3). Required: the
             kernels launched, and each greedy knight's round-1 tokens
             equal to greedy decoding on the plain path (forward_paged,
             plain=True) over the same weights or leaving them at a near
             tie: the plain logits' top-2 margin below PATH_TOL there
             ("token"), or a router decision before it that flipped
             between the kernels and the plain path at a router margin
             below PATH_TOL ("router"). Printed: decode ms per step beside
             the step's bound (every expert read once: the tree's bytes
             over 3.35 TB/s).
46. moe_quant - int8, then int4 experts (the router full precision) at
             MOE_QUANT_LAYERS = 8 layers: two rounds each; int4's K5
             launches counted by width, the expert down product's (C = X
             * F) required; int4's dequant-path products only prefill rows
             or the expert gate/up. Then the first 2 layers' forward over
             the quantized tree against the one over the same tree
             dequantized, both in f32 (a 64-row chunk and 4 decode steps,
             teacher-forced): logits within PATH_TOL where no router flip
             reaches them, every flip below PATH_TOL. Then K5 at the
             expert down shape (C 114,688, N 4096, 1 and 3 rows) against
             its plain version, timed beside torch.matmul on the weight
             dequantized beforehand.
47. moe_tp - in the last TP spawn: 2 gloo ranks on the card, the experts
             split 4 and 4 (EP), 2 layers; forward_paged's logits (a
             128-row chunk, 4 decode steps) against one device's on the
             same weights, bf16 and int4 experts (the expert down through
             K10e at decode rows, required), by the same flip rule.
48. moe_checkpoint - a 2-layer Mixtral written by write_hf_checkpoint in
             the HF block_sparse_moe layout, loaded back (every leaf
             torch.equal), then an engine from the directory serving two
             rounds (K1, K2).
49. f16_kernels - K1, K4 int8/int4 in K1, K2, K3 (the main buffer and
             the 17-sequence verify buffer), K8, K9, K5 (gate/up and the
             expert down), K6 and K7's group form at f16 against their
             plain versions (KERNEL_TOL) at the bf16 kernels phase's
             serving shapes, timed beside SDPA or torch.matmul at f16.
50. f16_engine - llama-3-8b-instruct at full width cut to F16_LAYERS = 8
             layers in float16: two rounds on the paged pool (then the
             scheduler phase, K3) and on the contiguous layout, each
             against the plain path by phase 45's rule, then int4 weights
             on int8 pages with one LoRA persona (K1/K2 with K4, K5/K6,
             K7 required).

Phases 51-54 ride the last TP spawn (two gloo ranks on the card, the model
at full width cut to TP_LAYERS = 8 layers, every knight greedy):

51. lint   - `roundtable lint --json` through the port's cli.main over this
             checkout on rank 0: rc 0, the eight rule ids, the
             allowlisted count (no card work).
52. data_round - the engine phase's config on `"mesh": {"data": 2,
             "model": 1}` with DATA_PAGES = 258 pages (129 on each rank:
             the pool's page axis split into one range per replica):
             warmup() and two rounds of three knights (3 rows over 2
             replicas: a pad row), K10b/K10c over the replicas' pools
             (`<name>:pool_replicas`) and K1/K2 required in each round,
             K3 never; both ranks return the same tokens; rank 0 then
             serves the same rounds on one device with the same weights
             and pool: each rank's pool bytes half of it, every token
             equal to it or a flip at a near tie below PATH_TOL (the rule
             of phases 21 and 45); prefill seconds and decode ms per step
             beside tp_round's. Then `data_round_int8`: the same on int8
             pages (K4 inside K1/K2).
53. mesh_scheduler - a SessionScheduler on `{"data": 1, "model": 2}`,
             then on `{"data": 2, "model": 1}`: rank 0 submits three
             sessions from threads (s2 once the first segment ran, so it
             joins while s0 and s1 decode) and broadcasts every
             state-changing engine call as a plan; rank 1 follows.
             Required: three completed with occupancy above 1, each
             session's tokens equal to the same engine's generate_batch
             (flips only at near ties, measured on both ranks), on TP a
             ragged join through K10d, on the data axis K10b/K10c over
             the replicas and no K3, the follower's plans and dispatches
             equal to rank 0's with none failing, a submit on rank 1
             refused, and rank 1's scheduler ended by rank 0's close.
54. mesh_serve - `serve "<topic>" --sessions 2 --no-read-code` through
             cli.main on both TP ranks, each in its own copy of a project
             seating three torch-llm knights on the TP mesh (RANK /
             WORLD_SIZE set: rank 1 follows): rc 0 on both, two session
             directories from rank 0 and no file from rank 1; then
             `gateway --port 0` on both ranks, one streamed chat request
             to rank 0 (SSE chunks ending in [DONE]), stopped by an
             interrupt that closes rank 0's scheduler and so rank 1's.

The pipeline and the contiguous layout on a data axis (phases 55-59): the
engine phase's config at TP_LAYERS layers, every knight greedy, the
engine phase's two rounds of three knights through execute_round on each
mesh (mesh_round_rank). Each rank checks its own launches in each round:
its layout's kernels launched, the other layout's never. Both ranks (all
four in phase 59) must return the same tokens, and every token must equal
the one-device engine's of the same seed and depth or flip at a near tie
below PATH_TOL (mesh_references_rank, on rank 0 at the end of the last
two-rank spawn: one device's paged, contiguous, int8 and int4 engines).
Each rank's KV bytes must be its share of one device's. Printed per rank:
parameter and KV bytes, peak memory, prefill seconds and decode ms per
step, the point-to-point sends and receives (calls, seconds) and the
collectives; one device's beside them.

55. pp_round - `"mesh": {"pipe": 2}` on the paged pool (DATA_PAGES pages),
             in the last two-rank spawn: each stage holds half the layers
             (the embedding on stage 0, the head on stage 1) and its
             layers' pages; K2 and K1 required on both ranks, K3, K8, K9
             and K10 never.
56. pp_contiguous_round - the same on the contiguous layout: K8 and K9
             required, no paged kernel.
57. pp_quant_int8 / pp_quant_int4 - phase 55 with int8, then int4
             weights; with int4, K5 on both stages and K6 (the head) on
             the last.
58. data_contiguous_round / data_gather_round - the default, contiguous
             layout on `{"data": 2, "model": 1}`: each rank its block of
             the slots, K8 and K9 required; then `attn: "dense"` on a
             paged data axis (each replica's rows' gather view from its
             own pages): no attention kernel launches.
59. pp_tp_round - `{"pipe": 2, "model": 2}` on the paged pool: four gloo
             ranks on the card (one spawn of its own, before the last
             two-rank spawn), K10c and K10b over K2 and K1 required on
             every rank.
60. ring_round - sequence-parallel prefill on one card: Llama-3-8B at
             full width, RING_LAYERS layers, paged, `seq_parallel: 2`
             (a ring of width 1), three knights reviewing one ~4k-token
             git diff, two rounds: round 1's shared span takes the ring
             (at least one ring dispatch), round 2 none; tokens against
             the chunked engine of the same seed (equal, or a flip at a
             near tie below PATH_TOL); prefill s and peak memory of both.
61. ring_round_mistral - the same on Mistral-7B with a ~5.2k-token diff,
             past its 4,096-token window (the window masks the ring's
             blocks and K1/K2's reads).
62. ring_tp / 63. ulysses_tp - phase 60's rounds on `{"data": 1,
             "model": 2}` (two gloo ranks on the card, in the last
             two-rank spawn) with `long_scheme` "ring", then "ulysses":
             a ring of the two ranks, each layer's weight shards gathered
             just before it runs; per rank its peak memory in round 1 (the
             ring) and round 2 (chunked), hops or all-to-alls and their
             seconds; tokens against phase 60's (one device).
64. fleet_trio - BASELINE.json config 3: Gemma-7B, Llama-3-8B and
             Mistral-7B at full width and depth, planned by the factory
             against this card's plannable memory (plan_fleet): Gemma-7B
             auto-degraded to int4; each engine's device bytes beside its
             estimate; one `discuss` round of three knights fanned out by
             the orchestrator; each knight's tokens equal its engine run
             alone.

Run time: 452-624 s on an H100 80GB HBM3 at 700 W with the build (579 s
with the device-time readings), 659-762 s with phases 26-27, 722.6 s with
phases 26-32 (phases 27-32 took 38 s), 797.7 s with the verify cases and
phases 8a-8b (~75 s together; 624.5 s on another machine, whose
host-bound phases ran faster), 741-795 s with phases 8c-8d and
offload_int8 (~40 s together), 924.7-959 s with phases 33-37, 1010 s with
phases 38-40 (80 s together); then the profile phases' decode steps were
cut from 32 to 16 (PROFILE_STEPS): 1011.5 s, 1154.1 s on a host ~1.3x
slower; then the TP engines' depth from 32 layers to 16 (TP_LAYERS):
740.6 s; then the quant engines' from 32 to 16 (TP_MODEL) with phases
41-44: 832.6-1050.0 s; then the TP and quant engines' from 16 to 8
(TP_LAYERS): 778.9-851.5 s; then the contiguous and LoRA engines at 16
layers: 713.7 s; then phases 51-54 with the engine phase at 16 layers:
834.3 s, 1164.8 s on a host ~1.4x slower; then the router fleet at 16
layers, PROFILE_STEPS 8 and 128 tokens in phase 53 to keep a slow host
inside the limit; then phases 55-59 (~816-880 s); then phases 60-64 with
the f16 kernel bodies built in a background thread after the kernel
timings (the build 46.9 s in place of 80.9-88.0): 767 s.

Then a `{"kernels": [...]}` line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Details go to chiprun_out/chip_smoke/.
The script exits non-zero without a result when no card is present or the
package is missing next to it.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter
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


def busy_us(spans) -> float:
    """Microseconds covered by the union of (start, end) intervals."""
    busy, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy


def device_busy_us(prof):
    """Microseconds the card was busy in a torch.profiler window: the union
    of its CUDA kernels' and copies' intervals."""
    from torch.autograd import DeviceType
    return busy_us((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)


# Cycles of torch.cuda._sleep queued ahead of an event-timed window (~1 ms
# at the H100's clock): the host enqueues the call's launches while the
# card spins, so the window holds no host launch gap.
SPIN_CYCLES = 2_000_000

# device_ms() calls in this process, and those timed by CUDA events
# because torch.profiler delivered too few complete windows.
DEVICE_TIMING = {"calls": 0, "by_events": 0}

WINDOW = "device_ms_window"


def event_window_ms(torch, fn, flush):
    """One call's time between CUDA events, the L2 flushed first and the
    launches queued behind a spin (SPIN_CYCLES): device_ms()'s fallback.
    Unlike the profiler's union of kernel intervals it also counts the
    card's gaps between the call's own launches."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    flush.zero_()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def complete_windows(events, windows):
    """The device events of each window (a sorted list of (start, end)
    ranges) whose multiset of kernel names is the census: the most of each
    name that any window delivered. torch.profiler on the H100 drops device
    events at random (whole windows, or one kernel of a call), so a window
    short of the census is left out rather than read as a faster call."""
    starts = [w[0] for w in windows]
    per = [[] for _ in windows]
    for ev in events:
        i = bisect.bisect_right(starts, ev.time_range.start) - 1
        if i >= 0 and ev.time_range.start <= windows[i][1]:
            per[i].append(ev)
    census = Counter()
    for evs in per:
        census |= Counter(ev.name for ev in evs)
    return [evs for evs in per
            if evs and Counter(ev.name for ev in evs) == census]


def device_ms(torch, fn, flush, reps=20, by_kernel=None):
    """Median of one call's device time over the complete windows among
    2 * `reps` calls: the time the card spent in the CUDA kernels (and
    copies) the call launched - both of K1/K9's launches, their overlap
    under programmatic dependent launch counted once (the union of their
    intervals) - from one torch.profiler session, each call in a
    record_function window of its own whose kernels are those inside its
    annotation on the card's timeline (complete_windows()). The L2 cache
    is flushed (a 64 MB write) and the card synchronised before each
    window, so the flush is left out and the pages are cold. Where fewer
    than `reps` windows are complete, the call is timed instead over
    `reps` windows between CUDA events (event_window_ms()), counted in
    DEVICE_TIMING and reported in a `device_ms_by_events` line.
    `by_kernel`, a dict, receives each kernel's median duration (ms) by
    name (nothing where the events timed the call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    DEVICE_TIMING["calls"] += 1
    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(2 * reps):
            flush.zero_()
            torch.cuda.synchronize()
            with record_function(f"{WINDOW}{i}"):
                fn()
                torch.cuda.synchronize()
    # Each window's range on the card's clock: the profiler's annotation of
    # the record_function, from its first kernel's start to its last's end
    # (the host's clock is offset from the card's by more than a flush).
    device = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    windows = sorted((ev.time_range.start, ev.time_range.end)
                     for ev in device if ev.name.startswith(WINDOW))
    complete = complete_windows(
        [ev for ev in device if not ev.name.startswith(WINDOW)], windows)
    if len(complete) < reps:
        DEVICE_TIMING["by_events"] += 1
        ms = statistics.median(event_window_ms(torch, fn, flush)
                               for _ in range(reps))
        emit("device_ms_by_events", call=DEVICE_TIMING["calls"],
             complete_windows=len(complete), windows=2 * reps, ms=ms)
        check(ms > 0, "CUDA events timed a call at no time")
        return ms
    if by_kernel is not None:
        named = {}
        for evs in complete:
            for ev in evs:
                named.setdefault(ev.name[:90], []).append(
                    ev.time_range.elapsed_us())
        by_kernel.update({name: statistics.median(us) / 1e3
                          for name, us in named.items()})
    return statistics.median(
        busy_us((ev.time_range.start, ev.time_range.end) for ev in evs)
        for evs in complete) / 1e3


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
    cell past each sequence's kv_valid. A run (query offset, rows, path_of)
    whose `path_of` names an earlier run is a tree path of that sequence,
    as a verify dispatch packs it: its table shares every page below the
    frontier page with it, and its own frontier page (a loan) holds the
    same committed cells below the query offset."""
    n = len(runs)
    k_pool, v_pool, table = make_pool(torch, gen, n, 8192, K, D, ps, dtype,
                                      dev)
    for s, (o, _m, *path_of) in enumerate(runs):
        if path_of and path_of[0] is not None:
            parent, j, c = path_of[0], o // ps, o % ps
            table[s, :j] = table[parent, :j]
            src, dst = int(table[parent, j]), int(table[s, j])
            k_pool[dst, :c] = k_pool[src, :c]
            v_pool[dst, :c] = v_pool[src, :c]
    valid = torch.tensor([o + m for o, m, *_ in runs], dtype=torch.int32,
                         device=dev)
    poison_past_frontier(k_pool, v_pool, table, valid, ps)
    tables = torch.cat([table, torch.zeros_like(table[:1])])
    seq_of_block = torch.full((T // 8,), n, dtype=torch.int32)
    block_qstart = torch.zeros(T // 8, dtype=torch.int32)
    blk = 0
    for s, (_o, m, *_) in enumerate(runs):
        for k in range(-(-m // 8)):
            seq_of_block[blk], block_qstart[blk] = s, 8 * k
            blk += 1
    offsets = torch.tensor([o for o, *_ in runs] + [0], dtype=torch.int32)
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


# K3 in a speculative verify dispatch (runs of 1 to spec_max_draft + 1 = 5
# rows ending at kv_valid - 1, at the frontier of a long cache), as
# (offset, rows, path_of) runs. RAGGED_VERIFY_MAIN is the verify buffer of
# 8 slots under a {branch: 2, depth: 3} tree at Llama-3-8B's shape: 8
# trunks of 5 rows after 1,495-7,995 cached positions (three crossing a
# page end) and a tree path of each (1-4 rows) sharing every page but a
# loaned frontier page - 16 sequences and the inert one, T = 128.
RAGGED_VERIFY_MAIN = (
    [(o, 5, None) for o in (1495, 2045, 2500, 3199, 4094, 5000, 6141,
                            7995)]
    + [(o, m, i) for i, (o, m) in enumerate(zip(
        (1495, 2045, 2500, 3199, 4094, 5000, 6141, 7995),
        (2, 3, 4, 1, 2, 3, 4, 2)))])
# (H, K, D, ps, T, runs, window, softcap): G 1 at pages of 64; G 4 at D 64
# on pages of 32 (paths crossing a page end) with softcap; G 16 at D 256
# with a window and softcap; G 4 at D 128 with a window.
RAGGED_VERIFY_EDGES = [
    (32, 8, 128, 128, 128, RAGGED_VERIFY_MAIN, None, None),
    (8, 8, 128, 64, 64, [(1500, 1, None), (1999, 2, None), (3005, 3, None),
                         (1999, 4, 1), (5000, 5, None), (7990, 5, None),
                         (3005, 2, 2)], None, None),
    (16, 4, 64, 32, 48, [(1535, 5, None), (1535, 3, 0), (2047, 2, None),
                         (2047, 5, 2), (6000, 4, None), (6000, 1, 4)],
     None, 30.0),
    (16, 1, 256, 64, 48, [(1600, 5, None), (1600, 2, 0), (4031, 4, None),
                          (4031, 3, 2), (7995, 5, None)], 512, 20.0),
    (32, 8, 128, 128, 32, [(2045, 5, None), (2045, 4, 0), (4500, 1, None),
                           (4500, 3, 2)], 1024, None),
]


def verify_cells(runs, ps):
    """Distinct KV cells a verify buffer's sequences read: a tree path
    shares its parent's pages below its frontier page."""
    return sum(o + m - (o // ps * ps if path_of is not None else 0)
               for o, m, path_of in runs)


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
    from theroundtaible_tpu_torch.engine import kv_quant as kvq
    errs = []
    # RAGGED_VERIFY_EDGES also on int8 and int4 pages (K4 in K3), the first
    # three of them.
    verify = [(case, None) for case in RAGGED_VERIFY_EDGES] + [
        (case, bits) for bits in (8, 4) for case in RAGGED_VERIFY_EDGES[:3]]
    for (H, K, D, ps, T, runs, window, softcap), bits in (
            [(case, None) for case in cases] + verify):
        args = ragged_inputs(torch, gen, runs, T, H, K, D, ps, bf16, dev)
        kw = dict(sliding_window=window, softcap=softcap)
        if bits is not None:
            kq, vq, qkw = quantized_pools(kvq, args[1], args[2], bits)
            args = (args[0], kq, vq) + tuple(args[3:])
            kw.update(qkw)
        out = kattn.ragged_paged_attention(*args, **kw)
        err, ok = max_err(torch, out,
                          kattn.ragged_paged_attention_ref(*args, **kw))
        err_tiles, ok_tiles = max_err(torch, out,
                                      kattn.ragged_tile_ref(*args, **kw))
        errs.append({"H": H, "K": K, "D": D, "ps": ps, "window": window,
                     "softcap": softcap, "T": T, "runs": runs,
                     "verify": any(len(r) == 3 for r in runs),
                     "kv_bits": bits,
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
    # The verify buffer of RAGGED_VERIFY_MAIN (17 sequences, T = 128).
    vruns, vT = RAGGED_VERIFY_MAIN, 128
    vargs = ragged_inputs(torch, gen, vruns, vT, H, K, D, 128, bf16, dev)
    vvalid = [o + m for o, m, _ in vruns]
    voffs = [o for o, _, _ in vruns]
    vkernels = {}
    verify = {
        "shape": {"T": vT, "H": H, "K": K, "D": D, "ps": 128,
                  "sequences": len(vruns) + 1, "runs": vruns},
        "ms": time_ms(torch, lambda: kattn.ragged_paged_attention(*vargs),
                      50, flush),
        "plain_ms": time_ms(
            torch, lambda: kattn.ragged_paged_attention_ref(*vargs), 3,
            flush),
        "sdpa_view_ms": sdpa_ragged_ms(torch, vargs, vruns, flush),
        "device_ms": device_ms(
            torch, lambda: kattn.ragged_paged_attention(*vargs), flush,
            by_kernel=vkernels),
        "device_kernels_ms": vkernels,
        "sdpa_device_ms": device_ms(
            torch, sdpa_ragged_call(torch, vargs, vruns), flush),
        "bytes": (2 * vT * H * D * 2
                  + verify_cells(vruns, 128) * K * D * 2 * 2),
        "flops": attended_pairs(vvalid, voffs, [m for _, m, _ in vruns],
                                None) * H * D * 4}
    verify["bound_ms"], verify["bound_by"] = bound_ms(verify["bytes"],
                                                      verify["flops"])
    timing["verify"] = verify
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
    for s, (o, m, *_) in enumerate(runs):
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
                                     "top_p": 0.95}},
    # The 1-token path without the prefix cache and the offload tier:
    # every phase built from this config (the rounds, profiles, scheduler
    # phases, contiguous, quant, LoRA, TP and checkpoint phases) keeps
    # numbers comparable with runs before speculative decoding and before
    # the cache; spec_scheduler, prefix_path, offload_path and the CLI
    # phases run them.
    "spec_decode": False, "prefix_cache": False, "kv_offload": False}
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
    inside), K10b/K10c over data replicas' pools
    ("<name>:pool_replicas"), K5/K6 and K7."""
    from theroundtaible_tpu_torch.engine.kernels import attention, int4mm
    from theroundtaible_tpu_torch.engine.kernels import lora as klora
    return {**attention.launch_counts(), **attention.dequant_launch_counts(),
            **attention.replica_launch_counts(),
            **int4mm.launch_counts(), **klora.launch_counts()}


def decode_ms_per_step(stats: dict, rows: int = 3) -> float:
    """A round's decode wall per step of its `rows` rows."""
    return 1e3 * stats["decode_seconds"] / max(stats["decode_tokens"] / rows,
                                               1)


def serve_rounds(torch, kattn, adapter, engine, phase, required,
                 forbidden=(), prompts_fn=None, peaks=False):
    """Two 3-knight rounds through execute_round (`prompts_fn`'s prompts,
    knight_prompts by default). The launch counts are zeroed before and
    read after each round: every `required` kernel must have launched in
    it, no `forbidden` one. A seq_parallel engine's ring dispatches of
    each round join its stats; with `peaks`, the round's peak device
    memory (its own window). Returns (launch totals, each round's
    generated tokens per knight, each round's stats)."""
    from theroundtaible_tpu_torch.adapters.base import KnightTurn
    prompts_fn = prompts_fn or knight_prompts
    totals = dict.fromkeys(launches_now(), 0)
    generated, round_stats = {}, {}
    prompts = None
    for rnd in (1, 2):
        prompts = prompts_fn(rnd, prompts)
        turns = [KnightTurn(k, p) for k, p in prompts.items()]
        reset_launches()
        rings = getattr(engine, "ring_dispatches", 0)
        if peaks:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        responses = adapter.execute_round(turns, timeout_ms=600_000)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = launches_now()
        stats = adapter.last_stats()
        if getattr(engine, "seq_ring", None) is not None:
            stats["ring_dispatches"] = engine.ring_dispatches - rings
        if peaks:
            stats["max_memory_allocated"] = torch.cuda.max_memory_allocated()
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
            totals[name] = totals.get(name, 0) + n
        generated[rnd] = {
            k: engine.kv._slots[k].tokens[len(engine.tokenizer.encode(p)):]
            for k, p in prompts.items()}
    return totals, generated, round_stats


# The engine phase's depth: its rounds, the profile and the scheduler
# phases run this engine, cut from 32 layers to keep the script inside its
# time limit; spec_scheduler and the cache phases keep the 32-layer
# weights (full_depth_engine), since a 16-layer spec_scheduler failed its
# agreement check.
ENGINE_LAYERS = 16


def engine_phase(torch, kattn):
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    torch.cuda.reset_peak_memory_stats()
    adapter = TorchLlmAdapter.from_config(
        "torch-llm-llama3", dict(ENGINE_CONFIG, model=register_depth(
            ENGINE_CONFIG["model"], ENGINE_LAYERS)))
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
    reference = {"layers": ENGINE_LAYERS, "num_pages": engine.kv.num_pages,
                 "kv_pool_bytes": engine.kv.hbm_bytes(),
                 "max_memory_allocated": torch.cuda.max_memory_allocated(),
                 "prefill_s": [stats[r]["prefill_seconds"] for r in (1, 2)],
                 "decode_ms_per_step": [decode_ms_per_step(stats[r])
                                        for r in (1, 2)],
                 "generated": generated}
    return totals, engine, reference


def full_depth_engine(torch):
    """ENGINE_CONFIG at its full 32 layers, for spec_scheduler and the
    cache phases (built after the engine phase's engine is released; the
    kernels are built and launched already, so no warmup)."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    t0 = time.monotonic()
    engine = InferenceEngine.from_config(dict(ENGINE_CONFIG))
    torch.cuda.synchronize()
    emit("engine_32_layers", model=engine.cfg.name,
         layers=engine.cfg.num_layers, construct_s=time.monotonic() - t0)
    return engine


# The contiguous and LoRA engines' depth: their checks compare each
# engine with itself; the engine phase's rounds' numbers are printed
# beside theirs.
CONTIGUOUS_LAYERS = 16
LORA_LAYERS = 16


def contiguous_phase(torch, kattn):
    """The engine phase's config minus `kv_layout` at CONTIGUOUS_LAYERS
    layers: the default builds a contiguous engine, attention resolved to
    K8/K9 on the card. warmup(), then the same two rounds: K8 and K9 must
    launch in each, K1-K3 never."""
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    config = {k: v for k, v in ENGINE_CONFIG.items() if k != "kv_layout"}
    config["model"] = register_depth(config["model"], CONTIGUOUS_LAYERS)
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
    emit("contiguous", layers=CONTIGUOUS_LAYERS,
         kv_cache_bytes=engine.kv.hbm_bytes(),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=totals)
    single = {"layers": CONTIGUOUS_LAYERS,
              "prefill_s": [stats[r]["prefill_seconds"] for r in (1, 2)],
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
        busy = device_busy_us(prof)   # 0: the profiler saw no device
        traces.append({"rows": int(batch["n_tokens"]), "wall_s": wall,
                       "device_ms": busy / 1e3 if busy else None,
                       "k3_device_ms": sum(k3) / 1e3 if busy else None,
                       "k3_kernel_launches": len(k3) if busy else None})
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


PROFILE_STEPS = 8


def profile_phase(torch, engine, phase="profile", adapters=None):
    """torch.profiler over one decode-dominated call of the 8B engine: 3
    rows whose prompts are already cached (one token of prefill each),
    then PROFILE_STEPS decode steps; `adapters`: the rows' LoRA personas.
    Device busy share = kernel time / wall time; kernel time by name. The
    profiler's own overhead lengthens the wall, so the share is a lower
    bound. Where
    the profiler delivered no device event, device time and share are
    null (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    turns = [(f"profile{i}", [1] + [5 + i] * 1600) for i in range(3)]
    engine.generate_batch(turns, max_new_tokens=1, adapters_per_turn=adapters)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.generate_batch(turns, max_new_tokens=PROFILE_STEPS,
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
    emit(phase, decode_steps=PROFILE_STEPS, wall_ms=wall_us / 1e3,
         device_ms=device_us / 1e3 if device_us else None,
         device_busy_share=device_us / wall_us if device_us else None,
         top_kernels=[{"name": n[:90], "ms": us / 1e3,
                       "share_of_device": us / device_us}
                      for n, us in top] if device_us else [])
    for name, _ in turns:
        engine.kv.release(name)
    return by_name


def kernel_ms(by_name: dict, part: str) -> float | None:
    """Device ms of a profile's kernels whose name holds `part` (None where
    the profile saw no device event)."""
    if not by_name:
        return None
    return sum(us for name, us in by_name.items() if part in name) / 1e3


# --- speculative decoding ---


def spec_path_phase(torch, engine):
    """A verify dispatch at full width, depth cut to 2 layers: three rows at
    1599/1649/1790 cached tokens (random cache content), each with a verify
    run [last, 4 drafts] (the last one crossing a page end), and tree paths
    of rows 0 and 2 (2 and 3 drafts) on tables that swap the frontier page
    (row 2's path: the next page too) for loaned pages, the frontier page
    copied into the loan in the dispatch (copy pairs). forward_ragged with
    `sample_rows` through K3 against its plain version; then the output
    invariance: each scored row's logits against forward_paged decoding
    the same tokens one at a time at the same positions (K1), on identical
    pools (the paths' on pools with the loan copied by hand). Both within
    PATH_TOL, as every path phase: at 2 layers in bf16 two kernel bodies
    (K3's prefill tiles, K1's split-KV decode) or the plain path round
    apart by ~0.045 on the logits. A tree path's first row must equal its
    trunk's bit for bit: the same token at the same position over the same
    committed cells (shared pages and the copied frontier page)."""
    from theroundtaible_tpu_torch.engine.models.common import init_params
    from theroundtaible_tpu_torch.engine.paged_forward import (
        forward_paged, forward_ragged)
    from theroundtaible_tpu_torch.engine.serving_loop import (
        RaggedSeq, build_ragged_batch)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    cfg = dataclasses.replace(engine.cfg, num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    params = init_params(cfg, gen, bf16, dev)
    ps, rows, R = 128, 3, 5
    pp = cfg.max_seq_len // ps
    pages = torch.randperm(rows * pp + 3, generator=gen, device=dev) + 1
    table = pages[:rows * pp].reshape(rows, pp).to(torch.int32)
    loans = [int(x) for x in pages[rows * pp:]]
    shape = (1 + rows * pp + 3, ps, cfg.num_kv_heads, cfg.head_dim)
    base = [(torch.randn(shape, generator=gen, device=dev).to(bf16),
             torch.randn(shape, generator=gen, device=dev).to(bf16))
            for _ in range(cfg.num_layers)]
    kernel_pools, plain_pools, paged_pools, path_pools = (
        [(k.clone(), v.clone()) for k, v in base] for _ in range(4))
    del base
    starts = [1599, 1649, 1790]
    runs = torch.randint(3, 259, (rows, R), generator=gen,
                         device=dev).tolist()
    table_np = table.cpu().numpy()
    # (row, drafts, loaned pages): row 0's path stays in its frontier page,
    # row 2's (1790..1793) crosses into the next one
    paths = [(0, torch.randint(3, 259, (2,), generator=gen,
                               device=dev).tolist(), loans[:1]),
             (2, torch.randint(3, 259, (3,), generator=gen,
                               device=dev).tolist(), loans[1:3])]
    seqs = [RaggedSeq(runs[i], starts[i], table_np[i], n_scores=R)
            for i in range(rows)]
    copy_pairs, path_tables = [], []
    for row, drafts, loan in paths:
        j = starts[row] // ps
        ptable = table_np[row].copy()
        ptable[j:j + len(loan)] = loan
        copy_pairs.append((int(table_np[row][j]), loan[0]))
        path_tables.append(ptable)
        seqs.append(RaggedSeq([runs[row][0]] + drafts, starts[row], ptable,
                              n_scores=1 + len(drafts)))
    batch = build_ragged_batch(
        seqs, t_budget=64, s_max=2 * rows + 1, pages_per_seq=pp,
        scratch_page=0, pad_id=0, page_size=ps, score_width=R,
        copy_pairs=copy_pairs, copy_slots=rows)
    t = {k: torch.as_tensor(batch[k], device=dev) for k in (
        "tokens", "positions", "tables", "seq_of_block", "block_qstart",
        "query_offsets", "kv_valid", "token_pages", "token_offs",
        "last_rows", "sample_rows", "copy_src", "copy_dst")}

    def verify(pools, plain):
        return forward_ragged(
            params, cfg, t["tokens"].long(), t["positions"], pools,
            t["tables"], t["seq_of_block"], t["block_qstart"],
            t["query_offsets"], t["kv_valid"], t["token_pages"],
            t["token_offs"], t["last_rows"], plain=plain,
            sample_rows=t["sample_rows"], copy_src=t["copy_src"],
            copy_dst=t["copy_dst"])

    reset_launches()
    lk = verify(kernel_pools, False)
    torch.cuda.synchronize()
    k3 = launches_now()["ragged_paged_attention"]
    lp = verify(plain_pools, True)
    n_scores = [s.n_scores for s in seqs]

    def decode(pools, tab, tokens, start):
        """forward_paged one token at a time: [B, len(tokens[0]), V]."""
        out = []
        tab = torch.as_tensor(tab, device=dev)
        toks = torch.as_tensor(tokens, device=dev)
        valid = torch.as_tensor(start, dtype=torch.int32, device=dev)
        for k in range(toks.shape[1]):
            out.append(forward_paged(params, cfg, toks[:, k:k + 1].long(),
                                     valid[:, None] + k, pools, tab,
                                     valid + k + 1)[:, 0])
        return torch.stack(out, 1)

    ld = [decode(paged_pools, table_np, runs, starts)]
    for pool_k, pool_v in path_pools:
        for src, dst in copy_pairs:
            pool_k[dst] = pool_k[src]
            pool_v[dst] = pool_v[src]
    for (row, drafts, _loan), ptable in zip(paths, path_tables):
        ld.append(decode(path_pools, ptable[None],
                         [[runs[row][0]] + drafts], [starts[row]]))
    torch.cuda.synchronize()
    decoded = [ld[0][i] for i in range(rows)] + [x[0] for x in ld[1:]]
    result, failures = {}, []
    for name, others, tol in (
            ("vs_plain", [lp[s] for s in range(len(seqs))], PATH_TOL),
            ("vs_decode", decoded, PATH_TOL)):
        worst, agree, total = 0.0, 0, 0
        for s, other in enumerate(others):
            a, b = lk[s, :n_scores[s]], other[:n_scores[s]]
            diff = (a - b).abs()
            worst = max(worst, float(diff.max()))
            if not bool(torch.isfinite(a).all()):
                failures.append(f"sequence {s}: non-finite verify logits")
            if not bool((diff <= tol + tol * b.abs()).all()):
                failures.append(f"{name}: sequence {s}'s scored rows differ "
                                f"by {float(diff.max())} (tolerance {tol})")
            agree += int((a.argmax(-1) == b.argmax(-1)).sum())
            total += n_scores[s]
        result[name] = {"max_abs_err": worst, "tolerance": tol,
                        "greedy_agreement": agree / total}
    # every tree path's row 0 is its trunk's row 0: the same `last` at the
    # same position over the same committed cells
    path_row0 = [float((lk[rows + k, 0] - lk[row, 0]).abs().max())
                 for k, (row, _d, _l) in enumerate(paths)]
    emit("spec_path", layers=cfg.num_layers, sequences=len(seqs),
         scored_rows=sum(n_scores), score_width=R,
         copy_pairs=copy_pairs, k3_launches=k3,
         path_row0_vs_trunk=path_row0, **result)
    check(not failures, f"spec path: {failures}")
    check(max(path_row0) == 0.0,
          f"spec path: a tree path's last row differs from its trunk's by "
          f"{max(path_row0)}")
    check(k3 > 0, "spec path: K3 never launched")


SPEC_TREE = {"branch": 2, "depth": 3}
# (run, spec_decode block, with lora_round's `lora:` block): the runs of
# spec_scheduler. Random weights repeat one token, so the n-gram tree finds
# no second root: model_tree is the run whose tree rows ride loaned pages.
SPEC_RUNS = (("off", False, False),
             ("ngram_chain", True, False),
             ("ngram_tree", {"tree": SPEC_TREE}, False),
             ("model", {"drafter": "model"}, False),
             ("model_tree", {"drafter": "model", "tree": SPEC_TREE}, False),
             ("lora", {"drafter": "lora", "adapter": "skeptic"}, True))
SPEC_KERNELS = ("paged_decode_attention", "paged_prefill_attention",
                "ragged_paged_attention", "lora_bgmv")
SPEC_MAX_NEW = 160


def next_token_logits(engine, tokens):
    """The engine's logits for the token after `tokens`: one prefill from
    position 0 (K2, or K8 on the contiguous layout) on a scratch slot,
    released after (on a data axis the row padded to one per replica, as
    the engine pads a batch; every rank of a mesh makes the same call)."""
    name = "__next_token__"
    if engine.kv_layout != "paged":
        slot, _reuse = engine.kv.reuse_plan(name, list(tokens))
        try:
            logits = engine._prefill([list(tokens)], [0], [slot])
        finally:
            engine.kv.release(name)
        return logits[0].float()
    engine.kv.ensure_capacity(name, len(tokens), write_from=0)
    try:
        toks, offs = [list(tokens)], [0]
        table, row = engine.kv.table_for([name]), 0
        plan = engine._replica_plan([name])
        if plan is not None:
            table = plan.pad_table(table, engine.kv.scratch_page)
            toks = plan.scatter_list(toks, [engine.tokenizer.pad_id])
            offs = plan.scatter_list(offs, 0)
            row = int(plan.pos[0])
        logits = engine._prefill(toks, offs, table)
    finally:
        engine.kv.release(name)
    return logits[row].float()


def first_flips(torch, base, prompts, generated, reference) -> list:
    """Q1: for each greedy row whose tokens first differ from the spec-off
    run's at position i, the spec-off prefix rerun to i on `base` and the
    top-2 margin of its logits there (a near-tie flips when it is below
    the K3-vs-K1 logit difference, PATH_TOL)."""
    flips = []
    for k, p in prompts:
        a, b = generated[k], reference[k]
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        logits = next_token_logits(base, base.tokenizer.encode(p) + b[:i])
        top = torch.topk(logits, 2)
        flips.append({"knight": k, "position": i, "off_token": b[i],
                      "spec_token": a[i],
                      "rerun_top2": [int(x) for x in top.indices],
                      "margin": float(top.values[0] - top.values[1])})
    return flips


def spec_scheduler_phase(torch, kattn, base):
    """One session of 3 greedy rows (the round-1 prompts: ~1.5k tokens
    repeating a passage, SPEC_MAX_NEW new tokens) through a SessionScheduler
    on the engine phase's 32-layer engine, six ways: speculation off (that
    engine), then on engines sharing its weights and config: the n-gram
    chain, the n-gram tree {branch 2, depth 3}, the `model` drafter on the
    engine's own weights (chain and tree), and the `lora` drafter on
    lora_round's `lora:` block drafting through the persona `skeptic`.
    Each spec run must have its drafter (no fallback), verify dispatches
    with K3 launched, greedy agreement with the off run >= 0.9; the lora
    run K7 launched in its draft dispatches, the self-drafting model run
    acceptance >= 0.9, the model tree run tree rows. Q1: where a spec
    run's greedy row first differs from the off run's, the off run's
    prefix is rerun to that position and every such flip must be a near
    tie, its top-2 logit margin below PATH_TOL (first_flips). Returns each
    run's launch counts."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.kernels import lora as klora
    from theroundtaible_tpu_torch.engine.kvcache import scoped_slot
    from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
    prompts = list(knight_prompts(1).items())
    starts = {k: len(base.tokenizer.encode(p)) for k, p in prompts}
    # The scheduler queues its second 64-token segment before it reads the
    # first (the JAX scheduler's pipelining), so a drafter whose corpus is
    # the row's own output can start only past 128 tokens on random
    # weights, whose output never quotes the prompt: 160 new tokens.
    max_new = SPEC_MAX_NEW
    base.kv.flush()
    reference, out = None, {}
    for run, spec, with_lora in SPEC_RUNS:
        engine = base if spec is False else InferenceEngine(
            base.cfg, params=base.params, num_slots=base.kv.num_slots,
            dtype=base.dtype, sampling=base.sampling, kv_layout="paged",
            page_size=base.kv.page_size, spec_decode=spec,
            lora=LORA_BLOCK if with_lora else None, prefix_cache=False,
            kv_offload=False, device=base.device)
        check(engine.spec_decode == (spec is not False),
              f"spec_scheduler {run}: spec_decode {engine.spec_decode} "
              f"({engine.spec_reason})")
        dispatch, drafts = engine._ragged_dispatch, {"k7": 0, "calls": 0}

        def counted(batch, dispatch=dispatch, drafts=drafts):
            # K7's launches inside the draft dispatches
            before = klora.launch_counts()["lora_bgmv"]
            result = dispatch(batch)
            if batch.get("draft"):
                drafts["calls"] += 1
                drafts["k7"] += klora.launch_counts()["lora_bgmv"] - before
            return result

        engine._ragged_dispatch = counted
        sched = SessionScheduler(engine)
        reset_launches()
        t0 = time.monotonic()
        try:
            _texts, stats = sched.submit("spec", prompts,
                                         max_new_tokens=max_new,
                                         timeout_s=600)
            torch.cuda.synchronize()
        finally:
            wall = time.monotonic() - t0
            sched.close()
        launches = launches_now()
        prov = sched.describe()
        del engine._ragged_dispatch
        generated = {k: engine.kv._slots[scoped_slot("spec", k)]
                     .tokens[starts[k]:] for k, _p in prompts}
        if reference is None:
            reference = generated
        same = sum(sum(a == b for a, b in zip(generated[k], reference[k]))
                   for k in generated)
        total = sum(max(len(generated[k]), len(reference[k]))
                    for k in generated)
        agreement = same / max(total, 1)
        flips = (first_flips(torch, base, prompts, generated, reference)
                 if spec is not False else [])
        sd = engine.spec_describe()
        rate = sd["acceptance_rate"]
        emit("spec_scheduler", run=run, spec_decode=spec, wall_s=wall,
             decode_tokens=stats.decode_tokens,
             tokens_per_s=stats.decode_tokens / wall,
             decode_tps=stats.decode_tps,
             verify_dispatches=sd["verify_dispatches"],
             drafted_tokens=sd["drafted_tokens"],
             accepted_tokens=sd["accepted_tokens"], acceptance_rate=rate,
             tree_nodes=sd["tree_nodes"], tree_rows=sd["tree_rows"],
             draft_dispatches=sd["draft_dispatches"],
             throttled_rows=sd["throttled_rows"], drafter=sd["drafter"],
             drafter_reason=sd["drafter_reason"],
             spec_segments=prov["spec_segments"],
             segments=prov["segments"], greedy_agreement=agreement,
             launches={k: launches[k] for k in SPEC_KERNELS},
             k7_in_draft_dispatches=drafts["k7"],
             draft_calls=drafts["calls"], flips=flips,
             flip_margins=[f["margin"] for f in flips],
             margin_tolerance=PATH_TOL)
        out[run] = launches
        if spec is not False:
            want = (spec.get("drafter", "ngram") if isinstance(spec, dict)
                    else "ngram")
            check(sd["drafter"] == want and sd["drafter_reason"] is None,
                  f"spec_scheduler {run}: drafter {sd['drafter']} "
                  f"({sd['drafter_reason']})")
            check(sd["verify_dispatches"] > 0
                  and launches["ragged_paged_attention"] > 0,
                  f"spec_scheduler {run}: {sd['verify_dispatches']} verify "
                  f"dispatches, K3 launches "
                  f"{launches['ragged_paged_attention']}")
            check(agreement >= 0.9, f"spec_scheduler {run}: greedy "
                  f"agreement with the off run {agreement}")
            check(all(f["margin"] < PATH_TOL for f in flips),
                  f"spec_scheduler {run}: a flip that is no near tie "
                  f"(top-2 margin >= {PATH_TOL}): {flips}")
        else:
            check(sd["verify_dispatches"] == 0,
                  "spec_scheduler off: a verify dispatch ran")
        if run == "model":
            check(rate is not None and rate >= 0.9,
                  f"spec_scheduler model: self-draft acceptance {rate}")
        if run == "model_tree":
            check(sd["tree_rows"] > 0, "spec_scheduler model_tree: no "
                  "tree row reached a verify dispatch")
        if run == "lora":
            check(drafts["k7"] > 0, "spec_scheduler lora: K7 never "
                  f"launched while drafting: {drafts}")
        for name in engine.kv.slot_names():
            engine.kv.release(name)
        if engine is not base:
            del engine, counted
            gc.collect()
            torch.cuda.empty_cache()
    return out


# --- prefix cache and host-RAM offload phases ---


# The Llama-3-8B bf16 page: 2 (K, V) x 8 kv heads x 128 dims x 2 B x 128
# positions x 32 layers = 16 MiB.
PAGE_MIB = 16
# ~3,000 tokens of project context every knight's prompt opens with, as
# discuss's system prompt does (byte tokenizer: one token per character).
PREFIX_PREAMBLE = ("Project context. The session store keeps every turn of "
                   "every discussion; a write-ahead journal records each "
                   "committed turn before the reply is returned, snapshots "
                   "compact the journal every hundred turns, and a restart "
                   "replays the last snapshot plus the journal tail. "
                   * 12)[:3000]
# Per-lane transfer rate of each PCIe generation, GB/s per direction
# (after line coding).
PCIE_LANE_GB_S = {1: 0.25, 2: 0.5, 3: 0.985, 4: 1.969, 5: 3.938, 6: 7.563}


def pcie_link(torch) -> dict:
    """The card's PCIe link and the host-link bound per direction, GB/s:
    the generation and width as nvidia-smi reads them (current and max),
    else as the PCI device's sysfs entry reads them (a field nvidia-smi
    reports as [N/A] in a virtual machine), else the H100 SXM5 data
    sheet's host interface (Gen5 x16); `source` says which. A link idles
    at a lower generation than it transfers at, so the bound is taken at
    the maximum generation and width read."""
    def num(text):
        try:
            return int(float(text.strip().split()[0]))
        except (ValueError, IndexError):
            return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,"
         "pcie.link.width.current,pcie.link.gen.max,pcie.link.width.max",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    raw = out.stdout.strip().splitlines()[0]
    gen, width, gen_max, width_max = (num(x) for x in raw.split(","))
    link = {"nvidia_smi": raw, "gen": gen, "width": width,
            "gen_max": gen_max, "width_max": width_max,
            "source": "nvidia-smi"}
    if not (gen_max or gen) or not (width_max or width):
        # sysfs: "<GT/s> GT/s PCIe" and the lane count
        rates = {2.5: 1, 5.0: 2, 8.0: 3, 16.0: 4, 32.0: 5, 64.0: 6}
        try:
            props = torch.cuda.get_device_properties(0)
            bus = (f"{getattr(props, 'pci_domain_id', 0):04x}:"
                   f"{props.pci_bus_id:02x}:{props.pci_device_id:02x}.0")
            sysfs = Path("/sys/bus/pci/devices") / bus
            read = {f: (sysfs / f).read_text().strip() for f in (
                "current_link_speed", "current_link_width",
                "max_link_speed", "max_link_width")}
            link.update(
                sysfs=read, source=f"sysfs {bus}",
                gen=rates.get(float(read["current_link_speed"].split()[0])),
                width=num(read["current_link_width"]),
                gen_max=rates.get(float(read["max_link_speed"].split()[0])),
                width_max=num(read["max_link_width"]))
        except (OSError, ValueError, KeyError, AttributeError) as e:
            link.update(sysfs_error=str(e)[:200], gen_max=5, width_max=16,
                        source="H100 SXM5 data sheet: PCIe Gen5 x16")
    top_gen = max(g for g in (link["gen"], link["gen_max"], 0) if g)
    top_width = max(w for w in (link["width"], link["width_max"], 0) if w)
    link["bound_gb_s"] = PCIE_LANE_GB_S.get(top_gen, 0.0) * top_width
    return link


def cache_engine(base, **kw):
    """An engine on the engine phase's weights and shapes (paged bf16, page
    128, 8 slots, greedy), with the prefix cache and the offload tier as
    `kw` says."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    return InferenceEngine(
        base.cfg, params=base.params, num_slots=base.kv.num_slots,
        dtype=base.dtype, sampling=base.sampling, kv_layout="paged",
        page_size=base.kv.page_size, spec_decode=False, device=base.device,
        **kw)


def snapshot_pages(torch, kv, pages):
    """Every layer's (k, v) rows of `pages`, payload and scale pools, copied
    to the host."""
    idx = torch.tensor(pages, device=kv.pools[0][0].device)
    return [(k.index_select(0, idx).cpu(), v.index_select(0, idx).cpu())
            for k, v in kv.combined_pools()]


def same_pages(torch, kv, pages, snapshot) -> bool:
    return all(torch.equal(a, b) and torch.equal(c, d) for (a, c), (b, d)
               in zip(snapshot_pages(torch, kv, pages), snapshot))


def last_prefill_logits(engine):
    """Wrap engine._prefill so each call's last-token logits are kept: the
    last call of a generate_batch is the one its first tokens come from.
    Returns (the list, an undo)."""
    calls = []
    prefill = engine._prefill

    def kept(token_lists, offsets, *a, **kw):
        logits = prefill(token_lists, offsets, *a, **kw)
        calls.append({"offsets": list(offsets), "logits": logits})
        return logits
    engine._prefill = kept
    return calls, lambda: delattr(engine, "_prefill")


def prefix_path_phase(torch, kattn, base):
    """The cross-session prefix cache at full width: the engine phase's
    32-layer model (paged bf16, page 128, 8 slots, greedy) with the cache
    on. Session s1 serves 3 knights whose prompts open with the same
    3,000-token preamble; s2 serves the same preamble with its own tails,
    on this engine and on the engine phase's (cache off, same weights).
    s2 must attach 23 pages per row from the index (hits >= 3,
    prefix_reused_tokens >= 3 x 23 x 128), alias s1's page ids (refcount
    >= 2), prefill from the page-multiple frontier through K2 and decode
    through K1; its greedy tokens agree with the cache-off run's >= 0.9 and
    its first-position logits are within PATH_TOL of them. Then s3
    attaches and, at its next turn, diverges inside preamble page 7: one
    copy-on-write or forget, and s1's pages torch.equal to a snapshot taken
    before s3. Returns the phase's launch counts."""
    from theroundtaible_tpu_torch.engine.kvcache import scoped_slot
    card = nvidia_smi()
    engine = cache_engine(base, prefix_cache=True, kv_offload=False)
    check(engine.prefix_cache is not None, "prefix_path: no prefix cache")
    knights = ("lancelot", "gawain", "percival")
    s1 = [(k, PREFIX_PREAMBLE + f" Session one: {k}, state your position on "
           f"the journal format and the snapshot cadence.") for k in knights]
    s2 = [(k, PREFIX_PREAMBLE + f"\n{k.upper()} (second review) asks what "
           f"a restart costs when the journal tail is long.")
          for k in knights]
    base.kv.flush()
    ps = engine.kv.page_size
    want_pages = (len(PREFIX_PREAMBLE) + 1) // ps   # BOS + the preamble
    engine.generate_batch(s1, max_new_tokens=32, session="s1")
    runs, launches = {}, {}
    for key, eng in (("cache", engine), ("off", base)):
        calls, undo = last_prefill_logits(eng)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        eng.generate_batch(s2, max_new_tokens=32, session="s2")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches[key] = launches_now()
        undo()
        st = eng.last_stats
        starts = {k: len(eng.tokenizer.encode(p)) for k, p in s2}
        runs[key] = {
            "wall_s": wall, "prefill_tokens": st.prefill_tokens,
            "prefill_s": st.prefill_seconds, "ttft_s": st.prefill_seconds,
            "reused_tokens": st.reused_tokens,
            "prefix_reused_tokens": st.prefix_reused_tokens,
            "decode_s": st.decode_seconds, "offsets": calls[-1]["offsets"],
            "logits": calls[-1]["logits"].float(),
            "generated": {k: eng.kv._slots[scoped_slot("s2", k)]
                          .tokens[starts[k]:] for k in knights}}
    cache, off = runs["cache"], runs["off"]
    d = engine.describe()["prefix_cache"]
    s1_pages = {k: list(engine.kv._slots[scoped_slot("s1", k)].pages)
                for k in knights}
    s2_pages = {k: list(engine.kv._slots[scoped_slot("s2", k)].pages)
                for k in knights}
    aliased = all(s2_pages[k][:want_pages] == s1_pages[k][:want_pages]
                  for k in knights)
    refs = min(engine.kv.refcount(p) for k in knights
               for p in s2_pages[k][:want_pages])
    same = total = 0
    for k in knights:
        a, b = cache["generated"][k], off["generated"][k]
        total += max(len(a), len(b))
        same += sum(x == y for x, y in zip(a, b))
    agreement = same / max(total, 1)
    diff = (cache["logits"] - off["logits"]).abs()
    logits_ok = bool((diff <= PATH_TOL + PATH_TOL
                      * off["logits"].abs()).all())
    # s3: attach, then a next turn diverging inside preamble page 7
    snapshot_ids = sorted({p for pages in s1_pages.values() for p in pages})
    snap = snapshot_pages(torch, engine.kv, snapshot_ids)
    forks = {"copies": 0, "forgets": 0}
    run_copy, forget = (engine.kv._run_page_copy,
                        engine.prefix_cache.forget_page)

    def counted_copy(src, dst):
        forks["copies"] += len(src)
        run_copy(src, dst)

    def counted_forget(page):
        forks["forgets"] += 1
        return forget(page)
    engine.kv._run_page_copy = counted_copy
    engine.prefix_cache.forget_page = counted_forget
    s3 = PREFIX_PREAMBLE + " Session three opens the review."
    engine.generate_batch([("tristan", s3)], max_new_tokens=32,
                          session="s3")
    s3_reused = engine.last_stats.prefix_reused_tokens
    cut = 7 * ps + 40       # inside page 7 of the preamble
    engine.generate_batch([("tristan", PREFIX_PREAMBLE[:cut - 1]
                            + " -- the context changed here.")],
                          max_new_tokens=32, session="s3")
    del engine.kv._run_page_copy
    del engine.prefix_cache.forget_page
    s1_intact = same_pages(torch, engine.kv, snapshot_ids, snap)
    ratio = (off["prefill_s"] / cache["prefill_s"]
             if cache["prefill_s"] else None)
    emit("prefix_path", card=card, layers=engine.cfg.num_layers,
         preamble_tokens=len(PREFIX_PREAMBLE) + 1, page_size=ps,
         attached_pages_per_row=want_pages, prefix_cache=d,
         **{f"s2_{key}": {k: v for k, v in r.items()
                          if k not in ("logits", "generated")}
            for key, r in runs.items()},
         s2_prefill_speedup=ratio, aliased_s1_pages=aliased,
         min_refcount=refs, greedy_agreement_with_cache_off=agreement,
         first_logits_max_abs_diff=float(diff.max()), tolerance=PATH_TOL,
         s3_prefix_reused_tokens=s3_reused, s3_forks=forks,
         s1_pages_intact=s1_intact,
         launches={k: {n: c for n, c in v.items() if c}
                   for k, v in launches.items()})
    check(d["hits"] >= 3, f"prefix_path: {d['hits']} attach hits")
    check(cache["prefix_reused_tokens"] >= 3 * want_pages * ps,
          f"prefix_path: s2 attached {cache['prefix_reused_tokens']} tokens")
    check(aliased and refs >= 2, f"prefix_path: s2's attached pages are not "
          f"s1's (aliased {aliased}, min refcount {refs})")
    check(all(o > 0 and o % ps == 0 for o in cache["offsets"]),
          f"prefix_path: s2 prefilled from {cache['offsets']}, not from a "
          f"nonzero page multiple")
    check(launches["cache"]["paged_prefill_attention"] > 0
          and launches["cache"]["paged_decode_attention"] > 0,
          f"prefix_path: K1/K2 over attached pages: {launches['cache']}")
    check(agreement >= 0.9, f"prefix_path: greedy agreement {agreement}")
    check(logits_ok, f"prefix_path: first-position logits differ by "
          f"{float(diff.max())} (tolerance {PATH_TOL})")
    check(s3_reused >= want_pages * ps,
          f"prefix_path: s3 attached {s3_reused} tokens")
    check(forks["copies"] + forks["forgets"] >= 1,
          f"prefix_path: s3's divergence forked nothing: {forks}")
    check(s1_intact, "prefix_path: s1's pages changed under s3")
    engine.kv.flush()
    base.kv.flush()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches["cache"]


# The offload phase's pool: 143 pages (2.2 GiB of bf16 K/V), room for two
# of its 3-knight sessions (60 pages each when idle, 63 decoding) but not
# three. Admission estimates a string prompt at 1.25x its bytes (75-78
# pages a session), and 142 usable pages let one session join another's
# decode once a spill has made room beside it.
OFFLOAD_PAGES = 143
OFFLOAD_IDLE_S = 12.0


def offload_prompts(session: str, round_no: int = 1) -> list:
    """3 knights' ~2.5k-token prompts, distinct per session and knight
    from the first character; round 2 extends round 1's."""
    out = []
    for k in ("lancelot", "gawain", "percival"):
        text = (f"[{session}/{k}] The council weighs the {k} proposal for "
                f"session {session}: journal first, then snapshot, then "
                f"replay on restart. " * 40)[:2500]
        if round_no > 1:
            text += f" Round {round_no}: {k}, answer the objections."
        out.append((k, text))
    return out


def timed_tier(torch, tier, log, check_restore=None):
    """Wrap the tier's spill_session/restore_session: each call's wall
    (the card synchronised at its end) and the host bytes it moved go to
    `log`; `check_restore(session)` runs right after a restore, before the
    turn that restored writes anything."""
    spill, restore = tier.spill_session, tier.restore_session

    def timed_spill(session):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        n = spill(session)
        torch.cuda.synchronize()
        rec = tier._spilled.get(session)
        log.append({"op": "spill", "session": session, "slots": n,
                    "s": time.monotonic() - t0,
                    "bytes": rec.host_bytes() if rec else 0})
        return n

    def timed_restore(session, pinned=()):
        rec = tier._spilled.get(session)
        nbytes = rec.host_bytes() if rec else 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        n = restore(session, pinned)
        torch.cuda.synchronize()
        log.append({"op": "restore", "session": session, "slots": n,
                    "s": time.monotonic() - t0, "bytes": nbytes})
        if check_restore is not None:
            check_restore(session)
        return n
    tier.spill_session = timed_spill
    tier.restore_session = timed_restore


def transfer_rates(log, link) -> list:
    return [{**e, "ms": 1e3 * e["s"],
             "gb_s": e["bytes"] / e["s"] / 1e9 if e["s"] else None,
             "bound_gb_s": link["bound_gb_s"]} for e in log]


def offload_path_phase(torch, kattn, base):
    """The host-RAM offload tier at full width: the engine phase's 32-layer
    model on a pool cut to OFFLOAD_PAGES pages (2.2 GiB), prefix cache off
    (the tier alone, as JAX's tests isolate it), behind a SessionScheduler
    with idle_spill_s. Session A (3 knights, ~2.5k tokens each) serves a
    round and goes idle; B and C are admitted: A must spill under pressure
    (event reason "pressure"). A's next turn joins while C decodes: its
    admission spills B, restores A - whose pages, snapshotted to the host
    before the spill, must be torch.equal right after the restore - and its
    delta rides C's ragged dispatches (ragged_defer_min 1: K3 over the
    restored pages). That turn must reuse its committed transcript less one
    page per row and its greedy tokens agree >= 0.9 with the engine phase's
    engine (257 pages: A never leaves) serving the same turns. Then a
    session idle for idle_spill_s spills (reason "idle"). Spill and
    restore ms and GB/s beside the host-link bound. Returns the phase's
    launch counts."""
    from theroundtaible_tpu_torch.engine.kvcache import scoped_slot
    from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
    card = nvidia_smi()
    base.kv.flush()
    engine = cache_engine(base, prefix_cache=False, kv_offload=True,
                          num_pages=OFFLOAD_PAGES)
    engine.ragged_defer_min = 1
    tier = engine.kv_offload
    check(tier is not None, "offload_path: no offload tier")
    names = [scoped_slot("A", k) for k, _p in offload_prompts("A")]
    snap, restored_equal, log = {}, {}, []

    def slot_pages():
        # every slot's pages in slot order (a sibling alias repeats)
        return [p for n in names for p in engine.kv._slots[n].pages]

    def check_restore(session):
        if session == "A" and snap:
            restored_equal["A"] = (
                [len(engine.kv._slots[n].pages) for n in names]
                == snap["lens"]
                and same_pages(torch, engine.kv, slot_pages(),
                               snap["bytes"]))
    timed_tier(torch, tier, log, check_restore)
    sched = SessionScheduler(engine, idle_spill_s=OFFLOAD_IDLE_S)
    turns, stats = {}, {}
    try:
        reset_launches()
        t0 = time.monotonic()
        turns["A1"] = sched.submit("A", offload_prompts("A"),
                                   max_new_tokens=32, timeout_s=600)
        with engine._serve_lock:
            committed = {n: len(engine.kv._slots[n].tokens) for n in names}
            snap["lens"] = [len(engine.kv._slots[n].pages) for n in names]
            snap["bytes"] = snapshot_pages(torch, engine.kv, slot_pages())
        turns["B"] = sched.submit("B", offload_prompts("B"),
                                  max_new_tokens=32, timeout_s=600)
        # C decodes two segments (96 tokens), so A's next turn, queued
        # while C's first runs, joins before C retires
        c_req = sched.submit_async("C", offload_prompts("C"),
                                   max_new_tokens=96, timeout_s=600)
        deadline = time.monotonic() + 300
        while not sched._active and time.monotonic() < deadline:
            time.sleep(0.005)
        joins = sched.ragged_joins
        turns["A2"] = sched.submit("A", offload_prompts("A", 2),
                                   max_new_tokens=32, timeout_s=600)
        joined = sched.ragged_joins - joins
        turns["C"] = sched.wait(c_req)
        events = sched.describe()["events"]
        pressure = [e for e in events if e["event"] == "spill"]
        a2 = turns["A2"][1]
        generated = {r: {k: engine.kv._slots[scoped_slot("A", k)].tokens[
            len(engine.tokenizer.encode(p)):] for k, p in
            offload_prompts("A", r)} for r in (2,)}
        # the idle policy: some session idle for idle_spill_s spills
        deadline = time.monotonic() + OFFLOAD_IDLE_S + 30
        while time.monotonic() < deadline and not any(
                e["event"] == "spill" and e["reason"] == "idle"
                for e in sched.describe()["events"]):
            time.sleep(0.2)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = launches_now()
        prov = sched.describe()
        snapshot = sched.snapshot()
    finally:
        sched.close()
    # reference: the engine phase's engine (257 pages) serving A's turns
    ref = {}
    for r in (1, 2):
        base.generate_batch(offload_prompts("A", r), max_new_tokens=32,
                            session="A-ref")
        ref[r] = {k: base.kv._slots[scoped_slot("A-ref", k)].tokens[
            len(base.tokenizer.encode(p)):] for k, p in
            offload_prompts("A", r)}
    same = total = 0
    for k in ref[2]:
        a, b = generated[2][k], ref[2][k]
        total += max(len(a), len(b))
        same += sum(x == y for x, y in zip(a, b))
    agreement = same / max(total, 1)
    spills = [e for e in prov["events"] if e["event"] == "spill"]
    link = pcie_link(torch)
    min_reuse = sum(committed.values()) - len(names) * engine.kv.page_size
    emit("offload_path", card=card, layers=engine.cfg.num_layers,
         num_pages=engine.kv.num_pages,
         pool_cut=f"{OFFLOAD_PAGES} pages = {OFFLOAD_PAGES * PAGE_MIB} MiB "
                  f"(the engine phase's pool: {base.kv.num_pages} pages)",
         idle_spill_s=OFFLOAD_IDLE_S, wall_s=wall, spill_events=spills,
         spills=prov["spills"], spilled_sessions=prov["spilled_sessions"],
         sessions=snapshot["sessions"], kv_offload=tier.describe(),
         a_committed_tokens=committed, a2_reused_tokens=a2.reused_tokens,
         a2_prefill_tokens=a2.prefill_tokens, a2_min_reuse=min_reuse,
         a_restored_equal=restored_equal.get("A"), a2_ragged_join=joined,
         greedy_agreement_with_resident=agreement, pcie=link,
         transfers=transfer_rates(log, link),
         launches={n: c for n, c in launches.items() if c})
    check(any(e["session"] == "A" and e["reason"] == "pressure"
              for e in pressure),
          f"offload_path: A never spilled under pressure: {pressure}")
    check(restored_equal.get("A") is True,
          f"offload_path: A's restored pages differ from the snapshot "
          f"({restored_equal})")
    check(a2.reused_tokens >= min_reuse,
          f"offload_path: A's next turn reused {a2.reused_tokens} < "
          f"{min_reuse}")
    check(agreement >= 0.9, f"offload_path: greedy agreement {agreement}")
    check(any(e["reason"] == "idle" for e in spills),
          f"offload_path: no idle spill within {OFFLOAD_IDLE_S + 30} s")
    check(prov["failed"] == 0, f"offload_path: {prov['failed']} failed")
    check(joined == 1, f"offload_path: A's next turn joined C's decode "
          f"through {joined} ragged joins")
    check(all(launches[k] > 0 for k in PAGED_KERNELS),
          f"offload_path: K1/K2/K3 never launched: {launches}")
    base.kv.flush()
    del engine, tier
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def offload_quant_phase(torch, engine):
    """One spill/restore round trip on the quant_int8 engine (int8 pages
    and their f32 scale pools; its config pins the tier off, so a
    HostOffloadTier is built over it here): a 3-knight session spilled and
    restored, payload and scales torch.equal, ms and GB/s per direction
    beside the host-link bound. Returns the session's launch counts."""
    from theroundtaible_tpu_torch.engine.kv_offload import HostOffloadTier
    from theroundtaible_tpu_torch.engine.kvcache import scoped_slot
    card = nvidia_smi()
    tier = HostOffloadTier(engine)
    log = []
    timed_tier(torch, tier, log)
    prompts = knight_prompts(1)
    reset_launches()
    engine.generate_batch(list(prompts.items()), max_new_tokens=32,
                          session="int8-spill")
    names = [scoped_slot("int8-spill", k) for k in prompts]
    launches = launches_now()
    lens = [len(engine.kv._slots[n].pages) for n in names]
    pages = [p for n in names for p in engine.kv._slots[n].pages]
    snap = snapshot_pages(torch, engine.kv, pages)
    check(tier.spill_session("int8-spill") == len(names),
          "offload_int8: the session did not spill")
    check(tier.restore_session("int8-spill") == len(names),
          "offload_int8: the session did not restore")
    pages = [p for n in names for p in engine.kv._slots[n].pages]
    equal = ([len(engine.kv._slots[n].pages) for n in names] == lens
             and same_pages(torch, engine.kv, pages, snap))
    link = pcie_link(torch)
    emit("offload_int8", card=card, kv_quant="int8", pages=len(pages),
         layers_spilled=len(engine.kv.combined_pools()),
         payload_and_scales_equal=equal, pcie=link,
         transfers=transfer_rates(log, link))
    check(equal, "offload_int8: restored payload or scales differ")
    for n in names:
        engine.kv.release(n)
    return launches


def prefix_blocks(engine) -> dict:
    """The engine's prefix-cache and offload-tier describe() blocks."""
    d = engine.describe()
    return {"prefix_cache": d.get("prefix_cache"),
            "kv_offload": d.get("kv_offload")}


# Each CLI phase's prepared batches: (rows' tokens, prefix-reused tokens,
# rows' reuse frontiers), for the later phases' shared-page counts.
PREPARED: dict = {}


class prepared_batches:
    """Record every _prepare_batch's token rows, prefix-reused tokens and
    reuse frontiers (after own-slot reuse, the attach and the share
    passes) under `phase` while the block runs (a class-level wrap: the
    CLI builds or reuses the engine inside cli.main)."""

    def __init__(self, phase):
        self.phase = phase

    def __enter__(self):
        from theroundtaible_tpu_torch.engine.engine import InferenceEngine
        self.cls, self.orig = InferenceEngine, InferenceEngine._prepare_batch
        rows = PREPARED.setdefault(self.phase, [])
        orig = self.orig

        def recorded(engine, *a, **kw):
            out = orig(engine, *a, **kw)
            rows.append((out["all_tokens"], out["prefix_reused_tokens"],
                         list(out["offsets"])))
            return out
        InferenceEngine._prepare_batch = recorded
        return rows

    def __exit__(self, *exc):
        self.cls._prepare_batch = self.orig
        return False


def row_shared_pages(tokens, others, ps: int) -> int:
    """The complete pages `tokens` shares from position 0 with the most
    similar row of the recorded batches `others`, short of its last token
    (at least one token is always fed)."""
    from theroundtaible_tpu_torch.engine.kvcache import lcp
    best = max((lcp(tokens, other) for other_list, _r, _o in others
                for other in other_list), default=0)
    return min(best, len(tokens) - 1) // ps


def shared_pages(rows, others, ps: int) -> int:
    """The most complete pages any row of `rows` shares with a row of
    `others`."""
    return max((row_shared_pages(tokens, others, ps)
                for tokens_list, _r, _o in rows for tokens in tokens_list),
               default=0)


def unserved_rows(rows, others, ps: int) -> list:
    """Rows of `rows` whose reuse frontier stops short of the pages they
    share with `others`: (shared pages, frontier) of each."""
    return [(n, off) for tokens_list, _r, offsets in rows
            for tokens, off in zip(tokens_list, offsets)
            for n in [row_shared_pages(tokens, others, ps)]
            if off < n * ps]


# --- quantization phases ---


# The shipped knights' quantization, and int4 throughout.
# The quant engines' model: llama-3-8b-instruct at full width with the
# depth cut to TP_LAYERS = 8 (TP_MODEL; 32 until the router phases 41-44
# joined the script, then 16 until PR 19's failover rework, which keeps
# it in its time limit), the depth of the TP quant rounds they stand
# beside.
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


def int4_weight(torch, gen, shape, dev, dtype=None):
    """A random packed int4 weight [rows, cols/2] with scales per
    INT4_GROUP values in `dtype` (bf16 by default; any byte is two valid
    nibbles)."""
    rows, cols = shape
    q4 = torch.randint(-128, 128, (rows, cols // 2), generator=gen,
                       device=dev, dtype=torch.int8)
    s4 = (torch.rand(rows, cols // INT4_GROUP, generator=gen, device=dev)
          * 0.025 + 0.005).to(dtype or torch.bfloat16)
    return q4, s4


def int4_kernel_ptxas(build, int4mm, m, head):
    """ptxas's registers, static shared memory and spills of the bf16
    kernel (tensor-core body for m rows) that K5 or K6 launches."""
    want = (f"{'mm_pack_contract' if head else 'mm_pack_out'}"
            f"_tc_kernelI13__nv_bfloat16Li{int4mm.n_tiles(m)}E")
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
    dequant-path product must be a prefill-sized one. At TP_LAYERS (8)
    layers: the unquantized engine phase's numbers are printed beside,
    without their greedy agreement (meaningless across depths)."""
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    extra = QUANT_CONFIGS[phase]
    bits = 8 if extra["kv_quant"] == "int8" else 4
    int4 = extra["quant"] == "int4"
    torch.cuda.reset_peak_memory_stats()
    register_tp_model()
    adapter = TorchLlmAdapter.from_config(
        "torch-llm-llama3", {**ENGINE_CONFIG, **extra, "model": TP_MODEL})
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
         layers=engine.cfg.num_layers,
         unquantized_engine_phase=dict(
             (k, v) for k, v in reference.items() if k != "generated"),
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


def lora_stacks(torch, gen, c, o, dev, dtype=None):
    """One target's 9-slot (a_t, b_s) at a persona's scale, slot 0 the
    all-zero base adapter, in `dtype` (bf16 by default) on the card."""
    bf16 = dtype or torch.bfloat16
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
    """The engine phase's config at LORA_LAYERS layers with every knight
    greedy, the README's `lora:` block and `knight_adapters`: warmup() and
    the two rounds (K1,
    K2 and K7 must launch in each). `lora_paths` must put every decode
    dispatch of the seven targets on K7 and only prefill-sized rows on the
    grouped einsums; the mixed batch must have suppressed sharing. Each
    knight's round-1 tokens against its adapter served alone are
    reported."""
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    from theroundtaible_tpu_torch.engine.kernels.lora import kernel_path
    from theroundtaible_tpu_torch.engine.kvcache import scoped_slot
    from theroundtaible_tpu_torch.engine.lora import lora_dims
    config = depth_config(ENGINE_CONFIG["model"], LORA_LAYERS,
                          lora=LORA_BLOCK, knight_adapters=KNIGHT_ADAPTERS)
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
         layers=LORA_LAYERS,
         bf16_engine_phase_decode_ms_per_step=reference[
             "decode_ms_per_step"],
         greedy_agreement_with_alone=agreement,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         apply_tokens=d["apply_tokens"],
         # K7 wrapper calls per decode step of 3 rows: one per input group
         # (q/k/v, o_proj, gate/up, down_proj) and layer, 4 x LORA_LAYERS,
         # where the per-target form made 7 per layer (prefill rows take
         # the grouped einsums).
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
# The TP rounds' model: llama-3-8b-instruct at full width with the depth
# cut to 8 layers (32 until PR 17, 16 until PR 19): its five engines
# under gloo were the script's largest block. The 2-layer TP paths hold TP
# against one device.
TP_LAYERS = 8
TP_MODEL = f"llama-3-8b-instruct-{TP_LAYERS}l"


def register_tp_model():
    register_depth("llama-3-8b-instruct", TP_LAYERS)
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
    """A TP_LAYERS-deep llama-3-8b-instruct engine on this rank's half of
    the model (`"mesh": {"data": 1, "model": 2}`), warmup() and the engine
    phase's two rounds through execute_round; the layout's K10 wrappers
    and kernels must launch in each round, the other layout's never. The
    rounds' collectives are timed (time_collectives)."""
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    from theroundtaible_tpu_torch.engine.kernels import attention as kattn
    register_tp_model()
    config = dict(ENGINE_CONFIG, model=TP_MODEL, mesh=dict(TP_MESH))
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
    seconds, decode ms per step: reported)."""
    phase = "tp_round" if layout == "paged" else "tp_contiguous_round"
    outs = [r for r, _ in ranks]
    check(outs[0]["generated"] == outs[1]["generated"],
          f"{phase}: the two ranks returned different tokens")
    emit(phase, backend=TP_BACKEND, mesh=TP_MESH, layers=TP_LAYERS,
         ranks=[{k: v for k, v in o.items() if k != "generated"}
                for o in outs],
         round_lines=[lines for _, lines in ranks],
         single_device={"layers": single.get("layers", 32),
                        "prefill_s": single["prefill_s"],
                        "decode_ms_per_step": single["decode_ms_per_step"]})
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
    half of llama-3-8b-instruct (TP_LAYERS deep, `"mesh": {"data": 1,
    "model": 2}`), each freed before the next: the quant_int8 and quant_int4
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
    register_tp_model()
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
        config["mesh"], config["model"] = dict(TP_MESH), TP_MODEL
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
    config (prefill seconds, decode ms per step; reported).
    Returns the launches of both ranks, by wrapper."""
    totals = {}
    for phase in TP_QUANT_PHASES:
        outs = [r[phase] for r, _ in ranks]
        check(outs[0]["generated"] == outs[1]["generated"],
              f"{phase}: the two ranks returned different tokens")
        ref = single[phase]
        emit(phase, backend=TP_BACKEND, mesh=TP_MESH, layers=TP_LAYERS,
             ranks=[{k: v for k, v in o.items() if k != "generated"}
                    for o in outs],
             round_lines=[[x for x in lines if x["phase"] == phase]
                          for _, lines in ranks],
             single_device={
                 "layers": LORA_LAYERS if phase == "tp_lora_round"
                 else TP_LAYERS,
                 "prefill_s": ref["prefill_s"],
                 "decode_ms_per_step": ref["decode_ms_per_step"]})
        for o in outs:
            for k, n in o["launches"].items():
                totals[k] = totals.get(k, 0) + n
    return totals


# --- the main path from a checkpoint ---


# --- lint, a data axis, the scheduler on a mesh, serve and gateway on a
# mesh (phases 51-54, in the last TP spawn) ---


DATA_MESH = {"data": 2, "model": 1}
# The engine phase's default pool (8 slots x 64 pages / 2) with one scratch
# page per replica: 129 pages on each data rank, 258 on one device.
DATA_PAGES = 258
# s2 arrives once the first 64-step segment ran: 128 tokens leave s0 and
# s1 a whole segment more to decode, so s2 joins mid-decode.
MESH_MAX_NEW = 128
MESH_TOPIC = "Should the session store shard its journal by session?"


def lint_rank(torch, rank):
    """Phase 51 on rank 0: `roundtable lint --json` through the port's
    cli.main over this checkout."""
    if rank != 0:
        return None
    import contextlib
    import io
    from theroundtaible_tpu_torch import cli
    from theroundtaible_tpu_torch.analysis.rules import get_rules
    cli.check_for_update = lambda cb: None
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["lint", "--json", "--root", str(ROOT)])
    report = json.loads(out.getvalue())
    return {"rc": rc, "seconds": time.monotonic() - t0,
            "rules": [r.id for r in get_rules()],
            "findings": len(report["findings"]),
            "allowlisted": report["allowlisted"],
            "unallowlisted": report["unallowlisted"],
            "jaxpr_programs": report["jaxpr_programs"]}


def lint_phase(ranks) -> None:
    res = ranks[0][0]
    emit("lint", **res)
    check(res["rc"] == 0 and res["unallowlisted"] == 0,
          f"lint: rc {res['rc']}, {res['unallowlisted']} finding(s)")
    check(len(res["rules"]) == 8, f"lint: rules {res['rules']}")


def mesh_config(mesh, **over) -> dict:
    """The engine phase's config at TP_LAYERS layers over `mesh`, every
    knight greedy."""
    return depth_config(ENGINE_CONFIG["model"], TP_LAYERS, mesh=dict(mesh),
                        **over)


def data_round_rank(torch, rank):
    """Phase 52 (module docstring) on this rank, bf16 pages then int8
    pages; rank 0 then serves the same rounds on one device (rank 1 waits
    at a barrier)."""
    import torch.distributed as dist
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    from theroundtaible_tpu_torch.engine import reset_engines
    from theroundtaible_tpu_torch.engine.kernels import attention as kattn
    out = {}
    for kv_quant in (None, "int8"):
        phase = "data_round" if kv_quant is None else "data_round_int8"
        extra = {"kv_quant": kv_quant} if kv_quant else {}
        config = mesh_config(DATA_MESH, num_pages=DATA_PAGES, **extra)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        adapter = TorchLlmAdapter.from_config("torch-llm-llama3", config)
        t0 = time.monotonic()
        engine = adapter._get_engine()
        torch.cuda.synchronize()
        construct_s = time.monotonic() - t0
        d = engine.describe()
        check(d["mesh"] == DATA_MESH and d["paged_replicas"] == 2
              and d["paged_decode"] == "pool-direct"
              and d["ragged"]["reason"] == "mesh:data-axis",
              f"{phase}: mesh {d['mesh']}, replicas {d['paged_replicas']}, "
              f"decode {d['paged_decode']}, ragged {d['ragged']['reason']}")
        warm_s = engine.warmup()
        q = ":int8" if kv_quant else ""
        required = (("paged_decode_spmd:pool_replicas",
                     "paged_prefill_spmd:pool_replicas")
                    + TP_KERNELS[1:3]
                    + tuple(k + q for k in PAGED_KERNELS[:2]))
        forbidden = ((PAGED_KERNELS[2], TP_KERNELS[3], TP_KERNELS[0])
                     + CONTIGUOUS_KERNELS)
        collectives = time_collectives(torch)
        before = dict(collectives)
        totals, generated, stats = serve_rounds(
            torch, kattn, adapter, engine, phase, required=required,
            forbidden=forbidden)
        res = {"construct_s": construct_s, "warmup_s": warm_s,
               "kv_bytes": engine.kv.hbm_bytes(),
               "num_pages": engine.kv.num_pages,
               "pages_per_rank": int(engine.kv.pools[0][0].shape[0]),
               "cross_replica_copies": engine.kv.cross_replica_copies,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "prefill_s": [stats[r]["prefill_seconds"] for r in (1, 2)],
               "decode_ms_per_step": [decode_ms_per_step(stats[r])
                                      for r in (1, 2)],
               "collectives": {k: collectives[k] - before[k]
                               for k in collectives},
               "launches": totals, "generated": generated}
        reset_engines()
        del engine, adapter
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            single = {k: v for k, v in config.items() if k != "mesh"}
            adapter = TorchLlmAdapter.from_config("torch-llm-llama3", single)
            engine = adapter._get_engine()
            engine.warmup()
            _t, sgen, sstats = serve_rounds(
                torch, kattn, adapter, engine, f"{phase}_single",
                required=PAGED_KERNELS[:2], forbidden=forbidden + TP_KERNELS)
            flips, prompts = [], None
            for rnd in (1, 2):
                prompts = knight_prompts(rnd, prompts)
                for k, p in prompts.items():
                    f = near_tie(torch, engine, engine.tokenizer.encode(p),
                                 generated[rnd][k], sgen[rnd][k])
                    if f is not None:
                        flips.append(dict(f, round=rnd, knight=k))
            res["single"] = {
                "kv_bytes": engine.kv.hbm_bytes(),
                "num_pages": engine.kv.num_pages,
                "prefill_s": [sstats[r]["prefill_seconds"] for r in (1, 2)],
                "decode_ms_per_step": [decode_ms_per_step(sstats[r])
                                       for r in (1, 2)],
                "equal": sgen == generated}
            res["flips"] = flips
            reset_engines()
            del engine, adapter
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        out[phase] = res
    return out


def data_round_phase(ranks, tp_round) -> dict:
    """Both ranks' data rounds: the same tokens on both ranks, each rank's
    pool half the one-device pool's, every token equal to the one-device
    engine's or a near-tie flip (PATH_TOL); printed beside tp_round's
    prefill seconds and decode ms per step. Returns the launch totals."""
    outs = [r for r, _ in ranks]
    tp = [r for r, _ in tp_round]
    totals: dict = {}
    for phase in ("data_round", "data_round_int8"):
        a, b = outs[0][phase], outs[1][phase]
        single = a["single"]
        check(a["generated"] == b["generated"],
              f"{phase}: the two ranks returned different tokens")
        check(a["kv_bytes"] == b["kv_bytes"]
              and 2 * a["kv_bytes"] == single["kv_bytes"]
              and 2 * a["pages_per_rank"] == single["num_pages"],
              f"{phase}: rank pools {a['kv_bytes']} B / "
              f"{a['pages_per_rank']} pages against the one-device pool "
              f"{single['kv_bytes']} B / {single['num_pages']} pages")
        check(all(f["margin"] < PATH_TOL for f in a["flips"]),
              f"{phase}: a token left the one-device engine's away from a "
              f"near tie: {a['flips']}")
        emit(phase, backend=TP_BACKEND, mesh=DATA_MESH, layers=TP_LAYERS,
             ranks=[{k: v for k, v in o[phase].items()
                     if k not in ("generated", "single", "flips")}
                    for o in outs],
             single_device=single, flips=a["flips"],
             margin_tolerance=PATH_TOL,
             tp_round={"mesh": TP_MESH,
                       "prefill_s": tp[0]["prefill_s"],
                       "decode_ms_per_step": tp[0]["decode_ms_per_step"]},
             round_lines=[lines for _, lines in ranks])
        for o in outs:
            for k, n in o[phase]["launches"].items():
                totals[k] = totals.get(k, 0) + n
    return totals


def mesh_prompts() -> dict:
    """Three sessions on the round-1 prompts: s0 two knights, s1 and s2
    one each."""
    p = knight_prompts(1)
    return {"s0": [("lancelot", p["lancelot"]), ("gawain", p["gawain"])],
            "s1": [("percival", p["percival"])],
            "s2": [("lancelot", p["percival"] + " Lancelot replies.")]}


def mesh_scheduler_rank(torch, rank):
    """Phase 53 (module docstring) on this rank: a SessionScheduler on a
    TP mesh, then on a data mesh."""
    import torch.distributed as dist
    from theroundtaible_tpu_torch.engine import reset_engines
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.kvcache import scoped_slot
    from theroundtaible_tpu_torch.engine.scheduler import scheduler_for
    out = {}
    prompts = mesh_prompts()
    for mesh in (TP_MESH, DATA_MESH):
        key = f"{mesh['data']}x{mesh['model']}"
        gc.collect()
        torch.cuda.empty_cache()
        engine = InferenceEngine.from_config(mesh_config(mesh))
        engine.warmup()
        engine.ragged_defer_min = 1
        # The references in one batch, each row in its session's scope.
        engine.generate_batch(
            [(scoped_slot(f"ref-{s}", k), p)
             for s, turns in prompts.items() for k, p in turns],
            max_new_tokens=MESH_MAX_NEW)
        sched = scheduler_for(engine)
        reset_launches()
        res = {}
        t0 = time.monotonic()
        if rank == 0:
            done, errors = {}, {}

            def go(s):
                try:
                    done[s] = sched.submit(s, prompts[s],
                                           max_new_tokens=MESH_MAX_NEW)
                except Exception as e:  # noqa: BLE001 - checked below
                    errors[s] = repr(e)
            first = [threading.Thread(target=go, args=(s,))
                     for s in ("s0", "s1")]
            for th in first:
                th.start()
            wait_for(lambda: sched.segments >= 1 or errors, 600,
                     "the first scheduled segment")
            last = threading.Thread(target=go, args=("s2",))
            last.start()
            for th in first + [last]:
                th.join(600)
            check(not errors and len(done) == 3,
                  f"mesh_scheduler {key}: sessions failed: {errors}")
            res["describe"] = sched.describe()
            res["ttft_s"] = {s: st.sched.get("ttft_s")
                             for s, (_t, st) in done.items()}
            res["wall_s"] = time.monotonic() - t0
            sched.close()
        else:
            try:
                sched.submit("x", [("a", "b")])
                res["submit_on_follower"] = None
            except RuntimeError as e:
                res["submit_on_follower"] = str(e)
            sched.close(timeout_s=900)
            res["follower_ended"] = not sched._thread.is_alive()
        res["close_s"] = time.monotonic() - t0
        torch.cuda.synchronize()
        res["launches"] = launches_now()
        res["plans"] = sched.plan_counts()
        # Every rank's pool bookkeeping took the same plans: the scheduled
        # and the reference tokens of each slot are on every rank, and
        # where they differ every rank reruns the same prefix (lockstep).
        flips, equal = [], True
        for s, turns in prompts.items():
            for knight, prompt in turns:
                n = len(engine.tokenizer.encode(prompt))
                a = engine.kv._slots[scoped_slot(s, knight)].tokens[n:]
                b = engine.kv._slots[scoped_slot(f"ref-{s}",
                                                 knight)].tokens[n:]
                equal = equal and a == b
                f = near_tie(torch, engine, engine.tokenizer.encode(prompt),
                             a, b)
                if f is not None:
                    flips.append(dict(f, session=s, knight=knight))
        res["flips"], res["equal"] = flips, equal
        dist.barrier()
        out[key] = res
        del sched, engine
        reset_engines()
    return out


def mesh_scheduler_phase(ranks) -> dict:
    """Each mesh's scheduler: rank 0 admitted and retired the three
    sessions with occupancy above 1, every session's tokens equal the same
    engine's generate_batch (a flip only at a near tie), on TP K10d
    launched (the join), on the data axis K10b/K10c over the replicas and
    no K3; the follower made every plan and dispatch rank 0 sent, refused
    a submit, and ended when rank 0 closed. Returns the launch totals."""
    outs = [r for r, _ in ranks]
    totals: dict = {}
    for key in outs[0]:
        lead, follow = outs[0][key], outs[1][key]
        d = lead["describe"]
        check(d["completed"] == 3 and d["failed"] == 0
              and d["max_occupancy"] > 1,
              f"mesh_scheduler {key}: completed {d['completed']}, failed "
              f"{d['failed']}, occupancy {d['max_occupancy']}")
        check(all(f["margin"] < PATH_TOL for f in lead["flips"]),
              f"mesh_scheduler {key}: a session left generate_batch's "
              f"tokens away from a near tie: {lead['flips']}")
        check(follow["plans"]["plans"] == lead["plans"]["plans"]
              and follow["plans"]["dispatches"]
              == lead["plans"]["dispatches"] > 0
              and follow["plans"]["errors"] == 0,
              f"mesh_scheduler {key}: plans {lead['plans']} against "
              f"{follow['plans']}")
        check(follow["follower_ended"]
              and "rank 0" in (follow["submit_on_follower"] or ""),
              f"mesh_scheduler {key}: follower ended "
              f"{follow['follower_ended']}, submit "
              f"{follow['submit_on_follower']}")
        for r in (lead, follow):
            n = r["launches"]
            if key == "1x2":
                check(n["ragged_paged_spmd"] > 0 and d["ragged_joins"] >= 1,
                      f"mesh_scheduler {key}: K10d launches "
                      f"{n['ragged_paged_spmd']}, joins {d['ragged_joins']}")
            else:
                check(n["paged_decode_spmd:pool_replicas"] > 0
                      and n["paged_prefill_spmd:pool_replicas"] > 0
                      and n["ragged_paged_attention"] == 0,
                      f"mesh_scheduler {key}: launches {n}")
            for k, v in n.items():
                totals[k] = totals.get(k, 0) + v
        emit("mesh_scheduler", mesh=key, layers=TP_LAYERS,
             describe={k: d[k] for k in (
                 "admitted", "completed", "segments", "ragged_joins",
                 "ragged_segments", "max_occupancy", "occupancy_mean")},
             ttft_s=lead["ttft_s"], wall_s=lead["wall_s"],
             close_s=[lead["close_s"], follow["close_s"]],
             plans=[lead["plans"], follow["plans"]],
             equal_to_generate_batch=lead["equal"], flips=lead["flips"],
             launches=[{k: v for k, v in r["launches"].items() if v}
                       for r in (lead, follow)])
    return totals


def mesh_project(root: Path) -> None:
    """A project seating three torch-llm knights on the TP mesh's engine
    (TP_LAYERS layers, greedy)."""
    (root / ".roundtable").mkdir(parents=True, exist_ok=True)
    sampling = {"temperature": 0.0, "max_new_tokens": 32}
    config = {
        "version": "1.0", "project": "chip-smoke-mesh", "language": "en",
        "knights": [{"name": k, "adapter": "torch-llm",
                     "capabilities": ["architecture"], "priority": i + 1}
                    for i, k in enumerate(DISCUSS_KNIGHTS)],
        "rules": {"max_rounds": 1, "consensus_threshold": 9,
                  "timeout_per_turn_seconds": 600,
                  "escalate_to_user_after": 9, "auto_execute": False,
                  "parallel_rounds": True},
        "chronicle": ".roundtable/chronicle.md",
        "adapter_config": {"torch-llm": dict(
            mesh_config(TP_MESH), sampling=sampling,
            knight_sampling={k: dict(sampling) for k in DISCUSS_KNIGHTS})}}
    (root / ".roundtable" / "config.json").write_text(
        json.dumps(config, indent=1))


class _ListenWatch:
    """A stdout stand-in that keeps what is printed and notes the
    gateway's listening port."""

    def __init__(self):
        import re
        self.text, self.port = [], None
        self.bound = threading.Event()
        self._re = re.compile(r"Gateway listening on http://[\d.]+:(\d+)")

    def write(self, s):
        self.text.append(s)
        m = self._re.search(s)
        if m:
            self.port = int(m.group(1))
            self.bound.set()
        return len(s)

    def flush(self):
        pass


def mesh_serve_rank(torch, rank):
    """Phase 54 (module docstring) on this rank: `serve` then `gateway`
    through cli.main, every rank in its own copy of the project."""
    import _thread
    import contextlib
    import io
    import os
    import shutil
    import tempfile
    import torch.distributed as dist
    from theroundtaible_tpu_torch import cli
    from theroundtaible_tpu_torch.engine import get_engine, reset_engines
    cli.check_for_update = lambda cb: None
    project = Path(tempfile.mkdtemp(prefix=f"rt-mesh-{rank}-"))
    mesh_project(project)
    files0 = sorted(str(p) for p in project.rglob("*"))
    os.environ.update(RANK=str(rank), WORLD_SIZE="2")
    cwd = os.getcwd()
    out = {}
    try:
        os.chdir(project)
        reset_launches()
        log = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
            saved, sys.stdin = sys.stdin, io.StringIO("")
            try:
                rc = cli.main(["serve", MESH_TOPIC, "--sessions", "2",
                               "--no-read-code"])
            finally:
                sys.stdin = saved
        out["serve"] = {"rc": rc, "wall_s": time.monotonic() - t0,
                        "log": log.getvalue()[-3000:],
                        "launches": {k: v for k, v in launches_now().items()
                                     if v}}
        config = json.loads(Path(".roundtable/config.json").read_text())
        engine = get_engine(config["adapter_config"]["torch-llm"], "cuda")
        out["serve"]["plans"] = engine._scheduler.plan_counts()
        if rank == 0:
            out["serve"]["describe"] = engine._scheduler.describe()
        dist.barrier()
        # One streamed chat request through `gateway` on the same ranks:
        # rank 0 binds and serves it, then stops on an interrupt.
        watch, req = _ListenWatch(), {}

        def client():
            if not watch.bound.wait(600):
                req["error"] = "never listened"
            else:
                try:
                    c = SseClient(watch.port, "POST",
                                  "/v1/chat/completions",
                                  {"model": "lancelot", "stream": True,
                                   "max_tokens": 24, "messages": [{
                                       "role": "user",
                                       "content": MESH_TOPIC}]})
                    req["status"] = c.status
                    req["events"] = [data for _eid, data, _at in c.events()]
                    c.close()
                except Exception as e:  # noqa: BLE001 - checked below
                    req["error"] = repr(e)
            _thread.interrupt_main()
        helper = None
        if rank == 0:
            helper = threading.Thread(target=client, daemon=True)
            helper.start()
        reset_launches()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(watch):
            rc = cli.main(["gateway", "--port", "0"])
        if helper is not None:
            helper.join(60)
        out["gateway"] = {"rc": rc, "wall_s": time.monotonic() - t0,
                          "request": req,
                          "launches": {k: v for k, v in
                                       launches_now().items() if v},
                          "plans": engine._scheduler.plan_counts()}
        out["files"] = sorted(set(str(p) for p in project.rglob("*"))
                              - set(files0))
    finally:
        os.chdir(cwd)
        for k in ("RANK", "WORLD_SIZE"):
            os.environ.pop(k, None)
        reset_engines()
        shutil.rmtree(project, ignore_errors=True)
    dist.barrier()
    return out


def mesh_serve_phase(ranks) -> dict:
    """serve: rc 0 on both ranks, two session directories from rank 0 and
    no file from rank 1, whose scheduler followed every plan; gateway: rc
    0 on both ranks, the streamed request's chunks and [DONE]. Returns the
    launch totals."""
    outs = [r for r, _ in ranks]
    lead, follow = outs
    sessions = {f.split("/.roundtable/sessions/")[1].split("/")[0]
                for f in lead["files"] if "/.roundtable/sessions/" in f}
    req = lead["gateway"]["request"]
    events = req.get("events") or []
    emit("mesh_serve", mesh=TP_MESH, layers=TP_LAYERS,
         serve=[{k: v for k, v in o["serve"].items() if k != "log"}
                for o in outs],
         sessions=sorted(sessions), follower_files=follow["files"],
         gateway=[{k: v for k, v in o["gateway"].items() if k != "request"}
                  for o in outs],
         request={"status": req.get("status"), "error": req.get("error"),
                  "events": len(events),
                  "done": bool(events) and events[-1] == "[DONE]"})
    check(lead["serve"]["rc"] == 0 and follow["serve"]["rc"] == 0,
          f"mesh_serve: serve rc {lead['serve']['rc']} / "
          f"{follow['serve']['rc']}: {lead['serve']['log'][-1500:]} "
          f"{follow['serve']['log'][-800:]}")
    check(len(sessions) == 2 and follow["files"] == [],
          f"mesh_serve: rank 0 sessions {sessions}, rank 1 files "
          f"{follow['files']}")
    check(follow["serve"]["plans"]["plans"]
          == lead["serve"]["plans"]["plans"] > 0,
          f"mesh_serve: serve plans {lead['serve']['plans']} against "
          f"{follow['serve']['plans']}")
    check(lead["gateway"]["rc"] == 0 and follow["gateway"]["rc"] == 0,
          f"mesh_serve: gateway rc {lead['gateway']['rc']} / "
          f"{follow['gateway']['rc']}")
    check(req.get("status") == 200 and len(events) >= 2
          and events[-1] == "[DONE]",
          f"mesh_serve: the streamed request: {req}")
    totals: dict = {}
    for o in outs:
        for part in ("serve", "gateway"):
            for k, v in o[part]["launches"].items():
                totals[k] = totals.get(k, 0) + v
    check(totals.get("paged_decode_spmd", 0) > 0
          and totals.get("paged_prefill_spmd", 0) > 0,
          f"mesh_serve: K10b/K10c launches {totals}")
    return totals


# --- Queue 1 slices 2a and 3: the contiguous layout on a data axis and
# pipeline parallelism (phases 55-59) ---

PP_MESH = {"pipe": 2}
PP_TP_MESH = {"pipe": 2, "model": 2}
K5_K6 = ("mm_pack_out", "mm_pack_contract")
# Rank 0's tokens of each mesh phase of the last two-rank spawn, held
# against one device's by mesh_references_rank.
_MESH_TOKENS: dict = {}


def mesh_round_rank(torch, rank, phase, config, required, forbidden,
                    prompts_fn=None):
    """One mesh engine from `config` on this rank: construction and the
    engine phase's two rounds through execute_round (serve_rounds: every
    `required` kernel launched on this rank in each round, no `forbidden`
    one), then the rank's parameter and KV bytes, its peak memory, prefill
    seconds and decode ms per step, collectives and point-to-point totals.
    Rank 0 keeps its tokens for mesh_references_rank."""
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    from theroundtaible_tpu_torch.engine import distributed, reset_engines
    from theroundtaible_tpu_torch.engine.kernels import attention as kattn
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    adapter = TorchLlmAdapter.from_config("torch-llm-llama3", config)
    t0 = time.monotonic()
    engine = adapter._get_engine()
    torch.cuda.synchronize()
    construct_s = time.monotonic() - t0
    d = engine.describe()
    collectives = time_collectives(torch)
    before = dict(collectives)
    distributed.reset_p2p_counts()
    totals, generated, stats = serve_rounds(
        torch, kattn, adapter, engine, phase, required=required,
        forbidden=forbidden, prompts_fn=prompts_fn,
        peaks=prompts_fn is not None)
    kv = getattr(engine, "_kv", engine.kv)
    out = {"construct_s": construct_s,
           "describe": {k: d.get(k) for k in (
               "mesh", "kv_layout", "paged_decode", "attn", "quant",
               "params", "stage", "layers")},
           "param_bytes": tree_bytes(engine.params),
           "kv_bytes": kv.hbm_bytes(),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "prefill_s": [stats[r]["prefill_seconds"] for r in (1, 2)],
           "decode_ms_per_step": [decode_ms_per_step(stats[r])
                                  for r in (1, 2)],
           "collectives": {k: collectives[k] - before[k]
                           for k in collectives},
           "p2p": distributed.p2p_counts(),
           "launches": totals, "generated": generated}
    if prompts_fn is not None:
        out.update({k: [stats[r].get(k) for r in (1, 2)]
                    for k in ("ring_dispatches", "max_memory_allocated")})
    if rank == 0:
        _MESH_TOKENS[phase] = generated
    reset_engines()
    del engine, adapter
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pp_forbidden(layout: str) -> tuple:
    other = (PAGED_KERNELS if layout == "contiguous"
             else (PAGED_KERNELS[2],) + CONTIGUOUS_KERNELS)
    return other + TP_KERNELS


def pp_round_rank(torch, rank):
    """Phases 55-57 on this rank: `{"pipe": 2}` on the paged pool (K2/K1
    required), then on the contiguous layout (K8/K9), then int8 and int4
    weights on the paged pool (int4: K5 on both stages, K6 - the head - on
    the last)."""
    out = {"pp_round": mesh_round_rank(
        torch, rank, "pp_round",
        mesh_config(PP_MESH, num_pages=DATA_PAGES), PAGED_KERNELS[:2],
        _pp_forbidden("paged"))}
    contiguous = mesh_config(PP_MESH)
    del contiguous["kv_layout"]
    out["pp_contiguous_round"] = mesh_round_rank(
        torch, rank, "pp_contiguous_round", contiguous, CONTIGUOUS_KERNELS,
        _pp_forbidden("contiguous"))
    for quant in ("int8", "int4"):
        required = PAGED_KERNELS[:2]
        if quant == "int4":
            required += K5_K6 if rank == 1 else K5_K6[:1]
        phase = f"pp_quant_{quant}"
        out[phase] = mesh_round_rank(
            torch, rank, phase,
            mesh_config(PP_MESH, num_pages=DATA_PAGES, quant=quant),
            required, _pp_forbidden("paged"))
    return out


def data_contiguous_round_rank(torch, rank):
    """Phase 58 on this rank: the default, contiguous layout on `{"data":
    2, "model": 1}` (each rank its block of 4 of the 8 slots, K8/K9
    required), then `attn: "dense"` on a paged data axis (the gather view
    from each replica's range: no attention kernel launches)."""
    contiguous = mesh_config(DATA_MESH)
    del contiguous["kv_layout"]
    out = {"data_contiguous_round": mesh_round_rank(
        torch, rank, "data_contiguous_round", contiguous,
        CONTIGUOUS_KERNELS, PAGED_KERNELS + TP_KERNELS)}
    out["data_gather_round"] = mesh_round_rank(
        torch, rank, "data_gather_round",
        mesh_config(DATA_MESH, num_pages=DATA_PAGES, attn="dense"), (),
        PAGED_KERNELS + CONTIGUOUS_KERNELS + TP_KERNELS)
    return out


def pp_tp_round_rank(torch, rank):
    """Phase 59 on one of four ranks: `{"pipe": 2, "model": 2}` on the
    paged pool, K10c/K10b over K2/K1 required."""
    return {"pp_tp_round": mesh_round_rank(
        torch, rank, "pp_tp_round",
        mesh_config(PP_TP_MESH, num_pages=DATA_PAGES),
        TP_KERNELS[1:3] + PAGED_KERNELS[:2],
        (PAGED_KERNELS[2], TP_KERNELS[0], TP_KERNELS[3])
        + CONTIGUOUS_KERNELS)}


# Each one-device reference (the mesh phases' configs without the mesh)
# and the mesh phases held against it.
MESH_REFERENCES = {
    "paged": (dict(num_pages=DATA_PAGES),
              ("pp_round", "pp_tp_round", "data_gather_round")),
    "contiguous": ({"kv_layout": None},
                   ("pp_contiguous_round", "data_contiguous_round")),
    "int8": (dict(num_pages=DATA_PAGES, quant="int8"), ("pp_quant_int8",)),
    "int4": (dict(num_pages=DATA_PAGES, quant="int4"), ("pp_quant_int4",)),
}


def mesh_references_rank(torch, rank, extra_tokens):
    """On rank 0 (rank 1 waits at a barrier): each one-device reference's
    two rounds, with its parameter and KV bytes, and for every mesh phase
    held against it (rank 0's tokens of this spawn, `extra_tokens` of the
    four-rank spawn) the first differing position of each knight's stream
    with the reference's top-2 margin there (near_tie)."""
    import torch.distributed as dist
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    from theroundtaible_tpu_torch.engine import reset_engines
    from theroundtaible_tpu_torch.engine.kernels import attention as kattn
    out = {}
    if rank == 0:
        tokens = {**_MESH_TOKENS, **extra_tokens}
        for ref, (over, phases) in MESH_REFERENCES.items():
            config = mesh_config(DATA_MESH, **{k: v for k, v in over.items()
                                               if v is not None})
            del config["mesh"]
            if "kv_layout" in over:
                del config["kv_layout"]
            gc.collect()
            torch.cuda.empty_cache()
            adapter = TorchLlmAdapter.from_config("torch-llm-llama3", config)
            engine = adapter._get_engine()
            _t, sgen, sstats = serve_rounds(
                torch, kattn, adapter, engine, f"reference_{ref}",
                required=(), forbidden=TP_KERNELS)
            res = {"param_bytes": tree_bytes(engine.params),
                   "kv_bytes": engine.kv.hbm_bytes(),
                   "prefill_s": [sstats[r]["prefill_seconds"]
                                 for r in (1, 2)],
                   "decode_ms_per_step": [decode_ms_per_step(sstats[r])
                                          for r in (1, 2)],
                   "phases": {}}
            for phase in phases:
                flips, prompts = [], None
                for rnd in (1, 2):
                    prompts = knight_prompts(rnd, prompts)
                    for k, p in prompts.items():
                        f = near_tie(torch, engine,
                                     engine.tokenizer.encode(p),
                                     tokens[phase][rnd][k], sgen[rnd][k])
                        if f is not None:
                            flips.append(dict(f, round=rnd, knight=k))
                res["phases"][phase] = {"equal": tokens[phase] == sgen,
                                        "flips": flips}
            out[ref] = res
            reset_engines()
            del engine, adapter
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def pp_tp_launch(*calls):
    """`calls` on 4 ranks spawned once, sharing cuda:0 over gloo (the one
    four-rank spawn: TP inside two pipeline stages)."""
    from theroundtaible_tpu_torch.engine import distributed
    ranks = distributed.launch(tp_rank, 4, TP_BACKEND, "cuda:0",
                               args=(calls,), timeout_s=600)
    return [[r[i] for r in ranks] for i in range(len(calls))]


def mesh_layout_phase(phase, mesh, outs, lines, reference) -> dict:
    """One mesh phase's ranks: the same tokens on every rank, every token
    equal to one device's or a flip at a near tie (PATH_TOL), each rank's
    KV bytes a share of one device's (pipe stages split the layers, a
    model axis the kv heads, a data axis the slots or pages); printed per
    rank beside one device's. Returns the launch totals."""
    ref = reference["phases"][phase]
    check(all(o["generated"] == outs[0]["generated"] for o in outs),
          f"{phase}: the ranks returned different tokens")
    check(all(f["margin"] < PATH_TOL for f in ref["flips"]),
          f"{phase}: a token left the one-device engine's away from a near "
          f"tie: {ref['flips']}")
    parts = mesh.get("pipe", 1) * mesh.get("model", 1) * mesh.get("data", 1)
    check(all(o["kv_bytes"] * parts == reference["kv_bytes"]
              for o in outs),
          f"{phase}: rank KV bytes {[o['kv_bytes'] for o in outs]} against "
          f"one device's {reference['kv_bytes']} over {parts} ranks")
    emit(phase, mesh=mesh, layers=TP_LAYERS,
         ranks=[{k: v for k, v in o.items() if k != "generated"}
                for o in outs],
         single_device={k: reference[k] for k in (
             "param_bytes", "kv_bytes", "prefill_s",
             "decode_ms_per_step")},
         equal=ref["equal"], flips=ref["flips"],
         margin_tolerance=PATH_TOL, round_lines=lines)
    totals: dict = {}
    for o in outs:
        for k, n in o["launches"].items():
            totals[k] = totals.get(k, 0) + n
    return totals


def pp_phases(pp_ranks, data_ranks, pp_tp_ranks, references) -> dict:
    """Phases 55-59 from their ranks' results. Returns each phase's launch
    totals."""
    out = {}
    for ranks, mesh in ((pp_ranks, PP_MESH), (data_ranks, DATA_MESH),
                        (pp_tp_ranks, PP_TP_MESH)):
        outs = [r for r, _ in ranks]
        lines = [lines for _, lines in ranks]
        for phase in outs[0]:
            ref = next(references[name] for name, (_o, phases)
                       in MESH_REFERENCES.items() if phase in phases)
            out[phase] = mesh_layout_phase(
                phase, mesh, [o[phase] for o in outs], lines, ref)
            if mesh.get("pipe"):
                # the stages hold the layers once between them
                layers = [o[phase]["describe"]["layers"] for o in outs]
                check(sorted({tuple(x) for x in layers})
                      == [(0, TP_LAYERS // 2), (TP_LAYERS // 2, TP_LAYERS)],
                      f"{phase}: stage layers {layers}")
                check(all(o[phase]["p2p"]["send_calls"]
                          + o[phase]["p2p"]["recv_calls"] > 0
                          for o in outs),
                      f"{phase}: a rank neither sent nor received")
    return out


# --- Queue 1 slices 4 and 5: sequence-parallel long-context prefill and
# the fleet planner (phases 60-64) ---

RING_LAYERS = 8
RING_THRESHOLD = 2048
# The shared diff preamble of each ring phase, in characters (one token
# each, byte tokenizer): past Mistral's 4,096-token window in its phase.
RING_PREAMBLE = {"ring_round": 4000, "ring_round_mistral": 5200}
RING_KNIGHTS = ("lancelot", "gawain", "percival")


def diff_preamble(chars: int) -> str:
    """A long git diff, as `summon` sends one: hunks of a session store's
    changed lines, cut to `chars` characters."""
    lines, i = [], 0
    while sum(len(x) + 1 for x in lines) < chars:
        f = f"src/store/journal_{i % 17}.py"
        lines += [f"diff --git a/{f} b/{f}",
                  f"@@ -{10 * i + 3},7 +{10 * i + 3},9 @@ def commit_{i}"
                  f"(self, turn):",
                  f"-        self.buffer.append(turn)  # slot {i}",
                  f"+        self.journal.write(encode(turn, seq={i}))",
                  "+        self.journal.flush()",
                  "         return self.ack(turn)"]
        i += 1
    return "\n".join(lines)[:chars]


def ring_prompts(chars: int):
    """Prompts of a ring phase: three knights reviewing one diff of
    `chars` characters (round 1 about 4.1-4.3k or 5.3-5.5k tokens); round
    2 extends each knight's round-1 prompt."""
    def prompts(round_no, previous=None):
        if previous is None:
            pre = diff_preamble(chars)
            return {k: pre + f"\nKnight {k}, is the flush order safe "
                    f"across a crash? " * (1 + j)
                    for j, k in enumerate(RING_KNIGHTS)}
        return {k: previous[k] + f" Round {round_no}: {k}, answer the "
                "strongest objection and give a final score."
                for k in RING_KNIGHTS}
    return prompts


def ring_config(base: str, **over) -> dict:
    """The engine phase's config on `base` cut to RING_LAYERS layers, every
    knight greedy, seq_parallel 2 with the default threshold."""
    return depth_config(base, RING_LAYERS, **{
        "seq_parallel": 2, "long_threshold": RING_THRESHOLD, **over})


def ring_flips(torch, engine, prompts_fn, got, want) -> list:
    """Every knight's first token where `got` leaves `want` (the chunked
    engine's), with `engine`'s top-2 margin there (near_tie)."""
    flips, prompts = [], None
    for rnd in (1, 2):
        prompts = prompts_fn(rnd, prompts)
        for k, p in prompts.items():
            f = near_tie(torch, engine, engine.tokenizer.encode(p),
                         got[rnd][k], want[rnd][k])
            if f is not None:
                flips.append(dict(f, round=rnd, knight=k))
    return flips


def ring_round_phase(torch, kattn, phase, base):
    """Phases 60-61: `base` at full width, RING_LAYERS layers, paged, with
    seq_parallel 2 on one card (a ring of width 1): three knights on a
    shared diff preamble, two rounds. Round 1's shared span (its leader's
    offset-0 prefill, past long_threshold) takes the ring, the suffixes
    and round 2's deltas the chunked path (K2), decode K1. The same rounds
    on the chunked engine of the same seed: tokens equal, or a flip at a
    near tie (PATH_TOL). Prints the ring dispatches per round, each
    engine's prefill seconds and peak memory per round. Returns the launch
    totals of both engines."""
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    from theroundtaible_tpu_torch.engine import reset_engines
    prompts_fn = ring_prompts(RING_PREAMBLE[phase])
    runs, totals = {}, {}
    engines = []
    for mode, over in (("ring", {}), ("chunked", {"seq_parallel": 0})):
        gc.collect()
        torch.cuda.empty_cache()
        adapter = TorchLlmAdapter.from_config(f"torch-llm-{phase}-{mode}",
                                              ring_config(base, **over))
        engine = adapter._get_engine()
        got, gen, stats = serve_rounds(
            torch, kattn, adapter, engine, f"{phase}_{mode}",
            required=PAGED_KERNELS[:2], forbidden=CONTIGUOUS_KERNELS,
            prompts_fn=prompts_fn, peaks=True)
        for name, n in got.items():
            totals[name] = totals.get(name, 0) + n
        runs[mode] = {"generated": gen, "stats": stats}
        engines.append(engine)
    ring, chunked = runs["ring"], runs["chunked"]
    rings = [ring["stats"][r]["ring_dispatches"] for r in (1, 2)]
    check(rings[0] >= 1 and rings[1] == 0,
          f"{phase}: ring dispatches per round {rings} (want >= 1, 0)")
    check(engines[0].seq_ring.size == 1, f"{phase}: ring width "
          f"{engines[0].seq_ring.size} on one card")
    flips = ring_flips(torch, engines[1], prompts_fn, ring["generated"],
                       chunked["generated"])
    check(all(f["margin"] < PATH_TOL for f in flips),
          f"{phase}: the ring left the chunked engine's tokens away from a "
          f"near tie: {flips}")
    prompts = prompts_fn(1)
    emit(phase, model=engines[0].cfg.name, layers=RING_LAYERS,
         window=engines[0].cfg.sliding_window,
         prompt_tokens=[len(engines[0].tokenizer.encode(p))
                        for p in prompts.values()],
         ring_dispatches=rings, ring_seconds=engines[0].ring_seconds,
         equal=ring["generated"] == chunked["generated"], flips=flips,
         margin_tolerance=PATH_TOL,
         **{f"{mode}_{key}": [runs[mode]["stats"][r][key] for r in (1, 2)]
            for mode in runs for key in ("prefill_seconds",
                                         "max_memory_allocated",
                                         "reused_tokens")},
         decode_ms_per_step={mode: [decode_ms_per_step(runs[mode]["stats"][r])
                                    for r in (1, 2)] for mode in runs})
    reset_engines()
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    return totals, {"generated": ring["generated"],
                    **{f"{mode}_{key}": [runs[mode]["stats"][r][key]
                                         for r in (1, 2)]
                       for mode in runs for key in (
                           "prefill_seconds", "max_memory_allocated")}}


RING_TP_SCHEMES = ("ring", "ulysses")


def ring_tp_rank(torch, rank, reference):
    """Phases 62-63 on this rank: TP_MESH ({"data": 1, "model": 2}, two
    gloo ranks on the card) at RING_LAYERS layers, seq_parallel 2 (a ring
    of the two ranks) with long_scheme "ring", then "ulysses": the
    ring_round phase's rounds (K10c/K10b over K2/K1 for the chunked parts),
    per rank its peak memory in round 1 (the ring, each layer's shards
    gathered) and in round 2 (chunked only), the hops' or all-to-alls'
    count and seconds, prefill seconds. Rank 0 holds the tokens against
    `reference` (ring_round's, one device); where they differ, a
    one-device engine of the same seed gives the top-2 margin there."""
    import torch.distributed as dist
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    from theroundtaible_tpu_torch.engine import reset_engines
    prompts_fn = ring_prompts(RING_PREAMBLE["ring_round"])
    out = {}
    for scheme in RING_TP_SCHEMES:
        phase = "ring_tp" if scheme == "ring" else "ulysses_tp"
        out[phase] = mesh_round_rank(
            torch, rank, phase,
            ring_config("llama-3-8b-instruct", mesh=dict(TP_MESH),
                        long_scheme=scheme),
            TP_KERNELS[1:3] + PAGED_KERNELS[:2],
            CONTIGUOUS_KERNELS + (TP_KERNELS[0],), prompts_fn=prompts_fn)
        out[phase]["equal"] = out[phase]["generated"] == reference
        out[phase]["flips"] = []
    differ = [p for p in out if not out[p]["equal"]]
    if rank == 0 and differ:
        gc.collect()
        torch.cuda.empty_cache()
        adapter = TorchLlmAdapter.from_config(
            "torch-llm-ring-reference",
            ring_config("llama-3-8b-instruct", seq_parallel=0))
        engine = adapter._get_engine()
        for phase in differ:
            out[phase]["flips"] = ring_flips(
                torch, engine, prompts_fn, out[phase]["generated"],
                reference)
        reset_engines()
        del engine, adapter
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def ring_tp_phases(ranks, single) -> dict:
    """Phases 62-63 from their ranks: both ranks' tokens the same, equal
    to one device's or a flip at a near tie (PATH_TOL), one ring dispatch
    in round 1 and none in round 2 on each rank, hops (ring) or
    all-to-alls (Ulysses) counted; printed per rank beside one device's
    ring_round. Returns each phase's launch totals."""
    outs = [r for r, _ in ranks]
    lines = [lines for _, lines in ranks]
    totals = {}
    for phase in outs[0]:
        per = [o[phase] for o in outs]
        check(all(p["generated"] == per[0]["generated"] for p in per),
              f"{phase}: the ranks returned different tokens")
        check(all(f["margin"] < PATH_TOL for f in per[0]["flips"]),
              f"{phase}: a token left one device's away from a near tie: "
              f"{per[0]['flips']}")
        check(all(p["ring_dispatches"][0] >= 1 and p["ring_dispatches"][1]
                  == 0 for p in per),
              f"{phase}: ring dispatches {[p['ring_dispatches'] for p in per]}")
        key = "ring_hops" if phase == "ring_tp" else "all_to_all_calls"
        check(all(p["p2p"][key] > 0 for p in per),
              f"{phase}: no {key} on a rank: {[p['p2p'] for p in per]}")
        emit(phase, mesh=TP_MESH, layers=RING_LAYERS,
             ranks=[{k: v for k, v in p.items() if k != "generated"}
                    for p in per],
             single_device={k: single[k] for k in (
                 "ring_prefill_seconds", "ring_max_memory_allocated",
                 "chunked_prefill_seconds")},
             equal=per[0]["equal"], flips=per[0]["flips"],
             margin_tolerance=PATH_TOL, round_lines=lines)
        totals[phase] = {}
        for p in per:
            for k, n in p["launches"].items():
                totals[phase][k] = totals[phase].get(k, 0) + n
    return totals


FLEET_TRIO = ("gemma-7b-it", "llama-3-8b-instruct", "mistral-7b-instruct")
FLEET_MAX_NEW = 16
FLEET_TOPIC = "Should the session store journal every turn before it acks?"


def fleet_engine_config(model: str) -> dict:
    """One knight's engine at full depth and width, the script's engine
    shape (8 slots, 8192 positions, the paged pool), greedy."""
    config = {k: v for k, v in ENGINE_CONFIG.items()
              if k != "knight_sampling"}
    config.update(model=model, seed=SEED,
                  sampling={"temperature": 0.0,
                            "max_new_tokens": FLEET_MAX_NEW})
    return config


def fleet_trio_phase(torch, kattn):
    """Phase 64, BASELINE.json config 3: three knights on Gemma-7B,
    Llama-3-8B and Mistral-7B at full width and depth. The factory plans
    the fleet against this card's plannable memory (plan_fleet with
    device_memory_bytes()); predicted: Gemma-7B degraded twice, to
    "int4 (auto-degraded)", the other two bf16, every group [0]. Each
    engine's measured device bytes beside its estimate; then one
    `discuss` round (run_discussion, 16 tokens a knight, the three groups
    fanned out by the orchestrator's thread pool), and each knight's
    tokens against its engine run alone on the prompt it was given.
    Returns the launch totals of the round and the alone runs."""
    import tempfile
    from theroundtaible_tpu_torch.adapters.factory import initialize_adapters
    from theroundtaible_tpu_torch.core.orchestrator import run_discussion
    from theroundtaible_tpu_torch.core.types import (KnightConfig,
                                                     RoundtableConfig,
                                                     RulesConfig)
    from theroundtaible_tpu_torch.engine import fleet, reset_engines
    ids = {m: f"torch-llm-{m}" for m in FLEET_TRIO}
    config = RoundtableConfig(
        version="1.0", project="fleet", language="en",
        knights=[KnightConfig(name=f"Knight-{m.split('-')[0]}",
                              adapter=ids[m], priority=i + 1)
                 for i, m in enumerate(FLEET_TRIO)],
        rules=RulesConfig(max_rounds=1, consensus_threshold=9,
                          parallel_rounds=True,
                          timeout_per_turn_seconds=600),
        chronicle="chronicle.md",
        adapter_config={ids[m]: fleet_engine_config(m) for m in FLEET_TRIO})
    budget = fleet.device_memory_bytes()
    estimates = {m: fleet.estimate_engine_hbm_bytes(
        dict(config.adapter_config[ids[m]])) for m in FLEET_TRIO}
    events = []
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    # seating plans the fleet, then builds each engine (is_available)
    adapters = initialize_adapters(
        config, lambda kind, msg: events.append((kind, msg)))
    torch.cuda.synchronize()
    seat_s = time.monotonic() - t0
    fleet_bytes = torch.cuda.memory_allocated() - before
    planned = {m: {k: config.adapter_config[ids[m]].get(k) for k in (
        "devices", "quant", "_quant_auto_degraded")} for m in FLEET_TRIO}
    check(not [m for k, m in events if k == "unavailable"],
          f"fleet_trio: a knight unseated: {events}")
    check(all(p["devices"] == [0] for p in planned.values()),
          f"fleet_trio: planned groups {planned}")
    built = {}
    for m in FLEET_TRIO:
        engine = adapters[ids[m]]._get_engine()
        d = engine.describe()
        # the engine's stored bytes: its weights and its page pool
        built[m] = {"device_bytes": (tree_bytes(engine.params)
                                     + engine.kv.hbm_bytes()),
                    "estimate_bytes": fleet.estimate_engine_hbm_bytes(
                        dict(config.adapter_config[ids[m]])),
                    "estimate_bf16_bytes": estimates[m],
                    "quant": d["quant"], "params": d["params"],
                    "kv_pool_bytes": engine.kv.hbm_bytes()}
    check(all(b["device_bytes"] < b["estimate_bytes"]
              for b in built.values()),
          f"fleet_trio: an engine holds more than its estimate: {built}")
    check(built["gemma-7b-it"]["quant"] == "int4 (auto-degraded)",
          f"fleet_trio: Gemma-7B serves {built['gemma-7b-it']['quant']}")
    # Every prompt each engine serves in the round, as it gets it.
    seen = {m: [] for m in FLEET_TRIO}
    for m in FLEET_TRIO:
        a = adapters[ids[m]]
        inner = a.execute_round

        def recording(turns, *args, _m=m, _inner=inner, **kw):
            seen[_m].extend((t.knight_name, t.prompt) for t in turns)
            return _inner(turns, *args, **kw)
        a.execute_round = recording
    project = Path(tempfile.mkdtemp(dir=OUT))
    (project / ".roundtable" / "sessions").mkdir(parents=True)
    reset_launches()
    t0 = time.monotonic()
    result = run_discussion(FLEET_TOPIC, config, adapters, str(project),
                            read_source_code=False)
    torch.cuda.synchronize()
    round_s = time.monotonic() - t0
    totals = launches_now()
    check(all(len(seen[m]) == 1 for m in FLEET_TRIO),
          f"fleet_trio: prompts served per engine "
          f"{ {m: len(v) for m, v in seen.items()} }")
    together = {}
    for m in FLEET_TRIO:
        engine = adapters[ids[m]]._get_engine()
        name = next(iter(engine.kv.slot_names()))
        together[m] = list(engine.kv._slots[name].tokens)
    # Alone: each engine again, one after another, on its knight's prompt.
    alone = {}
    reset_launches()
    for m in FLEET_TRIO:
        engine = adapters[ids[m]]._get_engine()
        engine.kv.flush()
        knight, prompt = seen[m][0]
        engine.generate_batch([(knight, prompt)],
                              max_new_tokens=FLEET_MAX_NEW)
        alone[m] = list(engine.kv._slots[knight].tokens)
    for k, n in launches_now().items():
        totals[k] = totals.get(k, 0) + n
    check(all(together[m] == alone[m] for m in FLEET_TRIO),
          f"fleet_trio: a knight's tokens in the round differ from its "
          f"engine alone: {[m for m in FLEET_TRIO if together[m] != alone[m]]}")
    check(totals["paged_prefill_attention"] > 0
          and totals["paged_decode_attention"] > 0
          and totals["mm_pack_out"] > 0 and totals["mm_pack_contract"] > 0,
          f"fleet_trio: a kernel of the trio never launched: {totals}")
    emit("fleet_trio", budget_bytes=budget, seat_s=seat_s, planned=planned,
         engines=built, fleet_bytes=fleet_bytes,
         estimate_sum=sum(b["estimate_bytes"] for b in built.values()),
         round_s=round_s,
         spoke=sorted({e.knight for e in result.all_rounds}),
         equal_alone={m: together[m] == alone[m] for m in FLEET_TRIO},
         memory_allocated=torch.cuda.memory_allocated(),
         launches=totals)
    reset_engines()
    del adapters
    gc.collect()
    torch.cuda.empty_cache()
    import shutil
    shutil.rmtree(project, ignore_errors=True)
    return totals


def hf_tensors(torch, params, cfg):
    """(HF name, tensor) of a dense param tree, in the HF layout: the
    inverse of engine/checkpoint.py's name map."""
    e, h, k, d = cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    yield "model.embed_tokens.weight", params["embedding"]
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}"
        yield f"{p}.self_attn.q_proj.weight", \
            layer["q_proj"].reshape(e, h * d).t()
        yield f"{p}.self_attn.k_proj.weight", \
            layer["k_proj"].reshape(e, k * d).t()
        yield f"{p}.self_attn.v_proj.weight", \
            layer["v_proj"].reshape(e, k * d).t()
        yield f"{p}.self_attn.o_proj.weight", \
            layer["o_proj"].permute(2, 0, 1).reshape(e, h * d)
        for name in ("q", "k", "v"):
            if f"{name}_bias" in layer:
                yield f"{p}.self_attn.{name}_proj.bias", \
                    layer[f"{name}_bias"].reshape(-1)
        if "experts" in layer:
            # Mixtral's block_sparse_moe: the router [X, E], each expert's
            # w1 (gate) and w3 (up) [F, E] and w2 (down) [E, F]
            m = f"{p}.block_sparse_moe"
            yield f"{m}.gate.weight", layer["router"].t()
            ex = layer["experts"]
            for x in range(ex["gate_proj"].shape[0]):
                for hf, name in (("w1", "gate_proj"), ("w3", "up_proj"),
                                 ("w2", "down_proj")):
                    yield f"{m}.experts.{x}.{hf}.weight", ex[name][x].t()
        else:
            for name in ("gate_proj", "up_proj", "down_proj"):
                yield f"{p}.mlp.{name}.weight", layer[name].t()
        yield f"{p}.input_layernorm.weight", layer["input_norm"]
        yield f"{p}.post_attention_layernorm.weight", layer["pre_mlp_norm"]
    yield "model.norm.weight", params["final_norm"]
    if "lm_head" in params:
        yield "lm_head.weight", params["lm_head"]


_ST_DTYPES = {"torch.float32": "F32", "torch.bfloat16": "BF16",
              "torch.float16": "F16"}


def hf_config(cfg, dtype_name: str) -> dict:
    """config.json of a Llama-family checkpoint of `cfg`'s shapes (a
    Mixtral one for a MoE config)."""
    moe = ({"architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
            "num_local_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.num_experts_per_tok}
           if cfg.num_experts else {})
    return {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.embed_dim,
        "intermediate_size": cfg.mlp_dim,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "max_position_embeddings": cfg.max_seq_len,
        "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": cfg.tie_embeddings, "hidden_act": "silu",
        "attention_bias": cfg.attn_bias, "mlp_bias": False,
        "bos_token_id": 1, "eos_token_id": 2, "torch_dtype": dtype_name,
        **moe}


def write_hf_checkpoint(torch, params, cfg, out_dir, shards: int = 4) -> int:
    """Write a dense param tree as an HF checkpoint by hand (no
    safetensors package): `shards` safetensors files of about equal size
    in layer order, each an 8-byte little-endian header length, the JSON
    header padded to 8 bytes and the payload; model.safetensors.index.json
    and config.json beside them. One tensor at a time goes to the host.
    Returns the payload bytes written."""
    import struct
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    named = list(hf_tensors(torch, params, cfg))
    sizes = [t.numel() * t.element_size() for _, t in named]
    total = sum(sizes)
    groups, acc = [[] for _ in range(shards)], 0
    for (name, t), size in zip(named, sizes):
        groups[min(shards - 1, acc * shards // total)].append((name, t))
        acc += size
    groups = [g for g in groups if g]
    weight_map = {}
    dtype_name = str(named[0][1].dtype).split(".")[-1]
    for i, group in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors"
        header, offset = {"__metadata__": {"format": "pt"}}, 0
        for name, t in group:
            n = t.numel() * t.element_size()
            header[name] = {"dtype": _ST_DTYPES[str(t.dtype)],
                            "shape": list(t.shape),
                            "data_offsets": [offset, offset + n]}
            offset += n
            weight_map[name] = fname
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        with open(out_dir / fname, "wb") as fh:
            fh.write(struct.pack("<Q", len(raw)) + raw)
            for _, t in group:
                host = t.detach().contiguous().cpu()
                fh.write(host.view(torch.uint8).numpy().data)
    (out_dir / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map},
        indent=1))
    (out_dir / "config.json").write_text(json.dumps(
        hf_config(cfg, dtype_name), indent=1))
    return total


def tree_leaves(tree, path=""):
    """(path, tensor) of every leaf of a param tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


class RssSampler:
    """The process's peak resident set while it runs, sampled every 20 ms
    from /proc/self/statm: `rss` (resident), `shared` (resident pages
    backed by a file or shared memory: a mapped checkpoint's pages are
    these) and `anon` (rss - shared, the process's own allocations), each
    peak taken on its own."""

    FIELDS = ("rss", "shared", "anon")

    def __init__(self):
        self.peak = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @classmethod
    def read(cls) -> dict:
        import resource
        page = resource.getpagesize()
        _size, resident, shared = (
            int(x) for x in Path("/proc/self/statm").read_text().split()[:3])
        return {"rss": resident * page, "shared": shared * page,
                "anon": (resident - shared) * page}

    def _sample(self):
        for k, v in self.read().items():
            self.peak[k] = max(self.peak.get(k, 0), v)

    def _run(self):
        while not self._stop.is_set():
            self._sample()
            self._stop.wait(0.02)

    def __enter__(self):
        self._sample()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()
        return False


# The checkpoint phase's model: the engine phase's, every knight greedy.
CKPT_CONFIG = {k: v for k, v in ENGINE_CONFIG.items()
               if k != "knight_sampling"}


def checkpoint_phase(torch, kattn):
    """Phase 26 (module docstring). Returns the checkpoint directory (the
    caller removes it)."""
    import resource
    import shutil
    import tempfile
    from theroundtaible_tpu_torch.adapters.base import KnightTurn
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    from theroundtaible_tpu_torch.engine.checkpoint import load_hf_checkpoint
    from theroundtaible_tpu_torch.engine.models.common import forward
    from theroundtaible_tpu_torch.native.loader import index_safetensors
    seeded = TorchLlmAdapter.from_config("torch-llm-seeded",
                                         dict(CKPT_CONFIG))
    engine = seeded._get_engine()
    cfg = engine.cfg
    tmp = Path(tempfile.mkdtemp(prefix="rt-ckpt-"))

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree))
    need = nbytes(engine.params)
    free = shutil.disk_usage(tmp).free
    check(free > need * 1.1 + 2e9,
          f"checkpoint: {free} bytes free in {tmp}, {need} needed")
    ckpt = tmp / "llama-3-8b-instruct"
    t0 = time.monotonic()
    written = write_hf_checkpoint(torch, engine.params, cfg, ckpt)
    write_s = time.monotonic() - t0
    shard_files = sorted(p.name for p in ckpt.glob("*.safetensors"))
    check(len(shard_files) == 4, f"checkpoint: shards {shard_files}")

    # bytes read: the payload of every indexed tensor, each read once
    index = index_safetensors(sorted(ckpt.glob("*.safetensors")))
    bytes_read = sum(e.end - e.begin for e in index.values())
    leaves = dict(tree_leaves(engine.params))

    # The load alone, before any KV pool: its device peak against the tree
    # it builds, and the host's resident set while it walks the shards.
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rss_before = RssSampler.read()
    with RssSampler() as rss_tree:
        t0 = time.monotonic()
        tree = load_hf_checkpoint(ckpt, cfg, engine.dtype, "cuda")
        torch.cuda.synchronize()
        tree_load_s = time.monotonic() - t0
    rss_after_tree = RssSampler.read()
    device_peak_load = torch.cuda.max_memory_allocated() - before
    tree_bytes = nbytes(tree)
    layer_bytes = max(nbytes(layer) for layer in tree["layers"])
    check(device_peak_load <= tree_bytes + layer_bytes,
          f"checkpoint: the load's device peak {device_peak_load} B is above "
          f"the tree ({tree_bytes} B) plus one layer ({layer_bytes} B)")
    got = dict(tree_leaves(tree))
    check(got.keys() == leaves.keys(),
          f"checkpoint: load_hf_checkpoint's leaf names differ: "
          f"{sorted(leaves.keys() ^ got.keys())[:8]}")
    unequal = [k for k in leaves if not torch.equal(leaves[k], got[k])]
    check(not unequal,
          f"checkpoint: load_hf_checkpoint's leaves differ: {unequal[:8]}")
    del tree, got
    gc.collect()
    torch.cuda.empty_cache()

    # The engine from `checkpoint=`: the constructor's wall (load, KV pool
    # and tokenizer) and its device peak, pool included.
    torch.cuda.synchronize()
    before_engine = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loaded = TorchLlmAdapter.from_config(
        "torch-llm-loaded", {**CKPT_CONFIG, "checkpoint": str(ckpt)})
    with RssSampler() as rss_engine:
        t0 = time.monotonic()
        engine2 = loaded._get_engine()
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
    device_peak_engine = torch.cuda.max_memory_allocated() - before_engine
    leaves2 = dict(tree_leaves(engine2.params))
    check(leaves.keys() == leaves2.keys(),
          f"checkpoint: leaf names differ: "
          f"{sorted(leaves.keys() ^ leaves2.keys())[:8]}")
    unequal = [k for k in leaves if not torch.equal(leaves[k], leaves2[k])]
    check(not unequal, f"checkpoint: leaves differ: {unequal[:8]}")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    tokens = torch.randint(3, cfg.vocab_size, (1, 256), generator=gen,
                           device="cuda")
    positions = torch.arange(256, device="cuda")[None, :]
    valid = torch.tensor([256], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits = forward(engine.params, cfg, tokens, positions, None, None,
                         valid)[0]
        logits2 = forward(engine2.params, cfg, tokens, positions, None,
                          None, valid)[0]
    check(bool(torch.isfinite(logits).all()), "checkpoint: logits")
    check(torch.equal(logits, logits2), "checkpoint: logits differ")

    prompts = knight_prompts(1)
    turns = [KnightTurn(k, p) for k, p in prompts.items()]
    responses = seeded.execute_round(turns, timeout_ms=600_000)
    reset_launches()
    responses2 = loaded.execute_round(turns, timeout_ms=600_000)
    torch.cuda.synchronize()
    launches = launches_now()
    check(all(launches[k] > 0 for k in PAGED_KERNELS[:2]),
          f"checkpoint: K1/K2 did not launch: {launches}")
    generated = {k: engine.kv._slots[k].tokens for k in prompts}
    generated2 = {k: engine2.kv._slots[k].tokens for k in prompts}
    check(generated == generated2 and responses == responses2,
          "checkpoint: the round's tokens differ")
    emit("checkpoint", model=cfg.name, layers=cfg.num_layers,
         shards=shard_files, bytes_written=written, write_s=write_s,
         load_s=load_s, tree_load_s=tree_load_s, bytes_read=bytes_read,
         host_rss_before=rss_before, host_peak_rss_load=rss_tree.peak,
         host_rss_after_load=rss_after_tree,
         host_peak_rss_engine=rss_engine.peak,
         host_peak_rss_process=resource.getrusage(
             resource.RUSAGE_SELF).ru_maxrss * 1024,
         tree_bytes=tree_bytes, layer_bytes=layer_bytes,
         device_peak_load=device_peak_load,
         device_allocated_before_engine=before_engine,
         device_peak_engine=device_peak_engine,
         leaves=len(leaves), logits_equal=True, tokens_equal=True,
         generated_tokens=sum(len(v) for v in generated.values()),
         launches=launches)
    return ckpt


DISCUSS_TOPIC = ("Should the session store move to an append-only event "
                 "log with periodic snapshots?")
DISCUSS_KNIGHTS = ("Lancelot", "Gawain", "Percival")
SERVE_TOPIC = "Should a joining session wait for the next decode segment?"
# Sessions sort by name (date, minute, slug): a slug starting with "w"
# makes the apply phase's session the latest one.
APPLY_TOPIC = "Write the session store as an append-only event log"
CODE_RED_INCIDENT = "The session store loses the last turn after a crash"
APP_SOURCE = ('"""The session store."""\n\nimport json\n\n\n'
              'def save(path, turns):\n'
              '    with open(path, "w") as fh:\n'
              '        json.dump(turns, fh)\n\n\n'
              'def load(path):\n'
              '    with open(path) as fh:\n'
              '        return json.load(fh)\n')


def discuss_config(ckpt, max_rounds: int = 2) -> dict:
    """The discuss phase's .roundtable/config.json: 3 knights on one
    torch-llm adapter over `ckpt`, the shipped example's engine settings
    (.roundtable/config.example.json, tpu-llm-claude) without the mesh."""
    sampling = {"temperature": 0.7, "top_p": 0.95, "max_new_tokens": 32}
    return {
        "version": "1.0", "project": "chip-smoke", "language": "en",
        "knights": [{"name": k, "adapter": "torch-llm",
                     "capabilities": ["architecture"], "priority": i + 1}
                    for i, k in enumerate(DISCUSS_KNIGHTS)],
        "rules": {"max_rounds": max_rounds, "consensus_threshold": 9,
                  "timeout_per_turn_seconds": 600,
                  "escalate_to_user_after": 3, "auto_execute": False,
                  "parallel_rounds": True},
        "chronicle": ".roundtable/chronicle.md",
        "adapter_config": {"torch-llm": {
            "model": "llama-3-8b-instruct", "checkpoint": str(ckpt),
            "max_seq_len": 8192, "num_slots": 8, "dtype": "bfloat16",
            "quant": "int8", "kv_layout": "paged",
            "knight_sampling": {k: dict(sampling)
                                for k in DISCUSS_KNIGHTS}}}}


def git(project, *args) -> str:
    return subprocess.run(
        ["git", "-c", "user.email=smoke@localhost", "-c", "user.name=smoke",
         *args], cwd=project, check=True, capture_output=True, text=True,
        timeout=60).stdout


def cli_project(ckpt) -> Path:
    """Phases 27-32's scratch git project: one tracked source file,
    app.py, and a .roundtable/config.json seating discuss_config(ckpt).
    The caller removes it."""
    import tempfile
    project = Path(tempfile.mkdtemp(prefix="rt-project-"))
    (project / "app.py").write_text(APP_SOURCE)
    git(project, "init", "-q")
    git(project, "add", "app.py")
    git(project, "commit", "-q", "-m", "init")
    (project / ".roundtable").mkdir()
    (project / ".roundtable" / "config.json").write_text(
        json.dumps(discuss_config(ckpt), indent=1))
    return project


def run_cli(torch, project, argv, stdin=""):
    """cli.main(argv) in `project` on the card, its output captured and
    `stdin` scripted (an empty stdin adjourns every menu), the launch
    counts zeroed before and read after: (rc, output, wall s, launches).
    No outside host is reached from this script: the CLI's update check
    (a request to PyPI) stays off."""
    import contextlib
    import io
    import os
    from theroundtaible_tpu_torch import cli
    cli.check_for_update = lambda on_update: None
    cwd = os.getcwd()
    out = io.StringIO()
    reset_launches()
    t0 = time.monotonic()
    try:
        os.chdir(project)
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(out):
            saved, sys.stdin = sys.stdin, io.StringIO(stdin)
            try:
                rc = cli.main(argv, device="cuda")
            finally:
                sys.stdin = saved
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    return rc, out.getvalue(), time.monotonic() - t0, launches_now()


def sessions_of(project) -> list:
    sessions = project / ".roundtable" / "sessions"
    return sorted(sessions.iterdir()) if sessions.is_dir() else []


def session_rounds(session) -> list:
    """Each round's wall and engine stats from a session's metrics.json
    (one engine call per round: the knights share one adapter)."""
    metrics = json.loads((session / "metrics.json").read_text())
    rounds = []
    for r in metrics["rounds"]:
        engine = [t["engine"] for t in r["turns"] if t.get("engine")]
        check(len(engine) == 1, f"{session.name}: round {r['round']} "
              f"engine stats {engine}")
        e = engine[0]
        rounds.append({
            "round": r["round"], "wall_s": r["wall_s"],
            "prefill_tokens": e["prefill_tokens"],
            "reused_tokens": e["reused_tokens"],
            "decode_tokens": e["decode_tokens"],
            "decode_ms_per_step": decode_ms_per_step(e)})
    return rounds


def require(phase, launches, required=PAGED_KERNELS[:2], allowed=()):
    """Every `required` kernel launched; none outside `required` and
    `allowed`."""
    check(all(launches[k] > 0 for k in required),
          f"{phase}: a kernel of {required} never launched: {launches}")
    others = {k: n for k, n in launches.items()
              if n and k not in required + tuple(allowed)}
    check(not others, f"{phase}: other kernels launched: {others}")


def cli_engine(project):
    """The resident engine of the CLI project's torch-llm adapter."""
    from theroundtaible_tpu_torch.engine import get_engine
    config = json.loads((project / ".roundtable" / "config.json")
                        .read_text())
    return get_engine(config["adapter_config"]["torch-llm"], "cuda")


def discuss_phase(torch, project):
    """Phase 27 (module docstring). Returns its launch counts."""
    with prepared_batches("discuss"):
        rc, log, wall, launches = run_cli(
            torch, project, ["discuss", DISCUSS_TOPIC, "--no-read-code"])
    (OUT / "discuss.log").write_text(log)
    check(rc == 0, f"discuss: rc {rc}: {log[-2000:]}")
    sessions = sessions_of(project)
    check(len(sessions) == 1, f"discuss: sessions {sessions}")
    session = sessions[0]
    files = sorted(p.name for p in session.iterdir())
    for name in ("transcript.json", "status.json", "discussion.md",
                 "metrics.json", "topic.md"):
        check(name in files, f"discuss: {name} not written: {files}")
    transcript = json.loads((session / "transcript.json").read_text())
    status = json.loads((session / "status.json").read_text())
    metrics = json.loads((session / "metrics.json").read_text())
    turns = sorted((e["round"], e["knight"]) for e in transcript)
    check(turns == sorted((r, k) for r in (1, 2) for k in DISCUSS_KNIGHTS),
          f"discuss: turns {turns}")
    rounds = session_rounds(session)
    check(len(rounds) == 2 and rounds[1]["reused_tokens"] > 0,
          f"discuss: round 2 reused no tokens: {rounds}")
    require("discuss", launches)
    blocks = prefix_blocks(cli_engine(project))
    check(blocks["prefix_cache"] is not None
          and blocks["kv_offload"] is not None,
          f"discuss: the shipped config's engine built no cache or tier: "
          f"{blocks}")
    emit("discuss", rc=rc, wall_s=wall, session=session.name, files=files,
         phase_status=status.get("phase"), turns=len(transcript),
         rounds=rounds, launches=launches,
         outcome=metrics.get("outcome"), card=nvidia_smi(), **blocks)
    return launches


def summon_phase(torch, project):
    """Phase 28 (module docstring). Returns its launch counts."""
    with open(project / "app.py", "a") as fh:
        fh.write('\n\ndef append(path, turn):\n'
                 '    with open(path, "a") as fh:\n'
                 '        fh.write(json.dumps(turn) + "\\n")\n')
    git(project, "add", "app.py")
    before = set(sessions_of(project))
    engine = cli_engine(project)
    hits0 = engine.prefix_cache.hits
    with prepared_batches("summon") as rows:
        rc, log, wall, launches = run_cli(torch, project,
                                          ["summon", "--no-read-code"])
    (OUT / "summon.log").write_text(log)
    check(rc == 0, f"summon: rc {rc}: {log[-2000:]}")
    new = [s for s in sessions_of(project) if s not in before]
    check(len(new) == 1, f"summon: new sessions {new}")
    topic = (new[0] / "topic.md").read_text()
    check("1 file(s) changed" in topic
          and "Diff preview: diff --git a/app.py b/app.py" in topic
          and "+def append(path, turn):" in topic,
          f"summon: the topic holds no diff preview: {topic[:600]}")
    rounds = session_rounds(new[0])
    check(len(rounds) == 1, f"summon: rounds {rounds}")
    require("summon", launches)
    # summon after discuss on the resident engine: every page a summon
    # prompt shares with a discuss prompt must be served from the cache.
    # discuss and summon seat the same unscoped knight slots, so a row's
    # own slot covers what it shares with its own discuss turn first and
    # the index serves only what lies beyond (hits, printed).
    discuss = PREPARED.get("discuss", [])
    shared = shared_pages(rows, discuss, engine.kv.page_size)
    unserved = unserved_rows(rows, discuss, engine.kv.page_size)
    hits = engine.prefix_cache.hits - hits0
    reused = sum(r for _t, r, _o in rows)
    emit("summon", rc=rc, wall_s=wall, session=new[0].name,
         topic_chars=len(topic), rounds=rounds, launches=launches,
         card=nvidia_smi(), pages_shared_with_discuss=shared,
         reuse_frontiers=[o for _t, _r, offs in rows for o in offs],
         prefix_hits=hits, prefix_reused_tokens=reused,
         **prefix_blocks(engine))
    check(not unserved, f"summon: rows re-prefilled pages they share with "
          f"discuss's prompts (shared pages, frontier): {unserved}")
    return launches


def serve_phase(torch, project):
    """Phase 29 (module docstring). Returns its launch counts."""
    from theroundtaible_tpu_torch.engine import get_engine
    before = set(sessions_of(project))
    hits0 = cli_engine(project).prefix_cache.hits
    with prepared_batches("serve") as rows:
        rc, log, wall, launches = run_cli(
            torch, project, ["serve", SERVE_TOPIC, "--sessions", "2",
                             "--no-read-code"])
    (OUT / "serve.log").write_text(log)
    check(rc == 0, f"serve: rc {rc}: {log[-2000:]}")
    new = [s for s in sessions_of(project) if s not in before]
    check(len(new) == 2, f"serve: new sessions {new}")
    sessions = [{"session": s.name, "rounds": session_rounds(s),
                 "wall_s": sum(r["wall_s"] for r in session_rounds(s)),
                 "phase_status": json.loads(
                     (s / "status.json").read_text()).get("phase")}
                for s in new]
    config = json.loads((project / ".roundtable" / "config.json")
                        .read_text())
    engine = get_engine(config["adapter_config"]["torch-llm"], "cuda")
    sched = engine._scheduler.describe()
    spec = engine.spec_describe()
    check(sched["admitted"] >= 2, f"serve: admitted {sched['admitted']}")
    check(sched["max_occupancy"] > len(DISCUSS_KNIGHTS),
          f"serve: max occupancy {sched['max_occupancy']}: the sessions "
          "never shared a batch")
    check(spec["enabled"], f"serve: speculation is off ({spec['reason']})")
    # Speculation is on by default: a verify tick runs K3 where a plain
    # segment runs K1, so either may carry the decode.
    require("serve", launches, required=PAGED_KERNELS[1:2],
            allowed=(PAGED_KERNELS[0], PAGED_KERNELS[2]))
    check(launches[PAGED_KERNELS[0]] + launches[PAGED_KERNELS[2]] > 0,
          f"serve: neither K1 nor K3 launched: {launches}")
    check(not spec["verify_dispatches"] or launches[PAGED_KERNELS[2]] > 0,
          "serve: verify dispatches ran without K3")
    # serve's sessions scope their slots, so every page they share with
    # the earlier phases' committed prompts comes from the index
    earlier = PREPARED.get("discuss", []) + PREPARED.get("summon", [])
    shared = shared_pages(rows, earlier, engine.kv.page_size)
    hits = engine.prefix_cache.hits - hits0
    reused = sum(r for _t, r, _o in rows)
    emit("serve", card=nvidia_smi(), **prefix_blocks(engine),
         pages_shared_with_earlier=shared, prefix_hits=hits,
         prefix_reused_tokens=reused,
         rc=rc, wall_s=wall, sessions=sessions,
         admitted=sched["admitted"], completed=sched["completed"],
         failed=sched["failed"], max_occupancy=sched["max_occupancy"],
         segments=sched["segments"], ragged_joins=sched["ragged_joins"],
         ragged_segments=sched["ragged_segments"],
         spec_segments=sched["spec_segments"],
         spec={k: spec[k] for k in (
             "drafter", "verify_dispatches", "drafted_tokens",
             "accepted_tokens", "acceptance_rate", "throttled_rows",
             "tree_nodes", "draft_dispatches")},
         k3_launches=launches["ragged_paged_attention"], launches=launches)
    check(shared == 0 or (hits > 0 and reused > 0),
          f"serve: its prompts share {shared} pages with discuss's and "
          f"summon's but the index served {hits} hits, {reused} tokens")
    return launches


def apply_phase(torch, project):
    """Phase 30 (module docstring). Returns its launch counts."""
    from theroundtaible_tpu_torch.core.errors import ExitCode
    from theroundtaible_tpu_torch.utils import session as sessions
    path = sessions.create_session(project, APPLY_TOPIC)
    sessions.write_decisions(
        path, APPLY_TOPIC, "Replace save() with an append-only event log "
        "in app.py; load() replays it.", [])
    sessions.update_status(path, phase="consensus_reached",
                           consensus_reached=True,
                           lead_knight=DISCUSS_KNIGHTS[0],
                           allowed_files=["app.py"])
    porcelain = git(project, "status", "--porcelain")
    rc, log, wall, launches = run_cli(torch, project,
                                      ["apply", "--noparley"])
    (OUT / "apply.log").write_text(log)
    status = json.loads((path / "status.json").read_text())
    unchanged = git(project, "status", "--porcelain") == porcelain
    # Random weights emit no RTDIFF/1: the Lead Knight's output does not
    # parse, nothing is written and the session keeps its consensus.
    check(rc == int(ExitCode.FILE_WRITE),
          f"apply: rc {rc}, not FileWriteError's: {log[-2000:]}")
    check("not applicable" in log, f"apply: {log[-2000:]}")
    check(status["phase"] == "consensus_reached",
          f"apply: the session's phase is {status['phase']}")
    check(unchanged, "apply: the project's git status changed")
    require("apply", launches)
    emit("apply", rc=rc, wall_s=wall, session=path.name,
         phase_status=status["phase"], porcelain_unchanged=unchanged,
         error=next(line.strip() for line in log.splitlines()
                    if "not applicable" in line)[:200], launches=launches)
    return launches


def code_red_phase(torch, project):
    """Phase 31 (module docstring). Returns its launch counts."""
    from theroundtaible_tpu_torch.commands import code_red
    # Depth cut: the triage and the blind round, the least the command
    # runs (the doctors consult one after another).
    code_red.MAX_DIAG_ROUNDS = 2
    before = set(sessions_of(project))
    rc, log, wall, launches = run_cli(
        torch, project, ["code-red", CODE_RED_INCIDENT])
    (OUT / "code_red.log").write_text(log)
    new = [s for s in sessions_of(project) if s not in before]
    check(len(new) == 1, f"code_red: new sessions {new}")
    import re
    discussion = (new[0] / "discussion.md").read_text()
    status = json.loads((new[0] / "status.json").read_text())
    error_log = (project / ".roundtable" / "error-log.md").read_text()
    turns = sorted((int(r), k) for r, k in re.findall(
        r"^## Round (\d+) — (\S+)$", discussion, re.MULTILINE))
    check(turns == sorted((r, k) for r in (1, 2) for k in DISCUSS_KNIGHTS),
          f"code_red: turns {turns}")
    # Random weights emit no diagnosis: no convergence, an OPEN entry.
    check(rc in (0, 1) and "## CR-001" in error_log,
          f"code_red: rc {rc}: {log[-2000:]}")
    require("code_red", launches)
    emit("code_red", rc=rc, wall_s=wall, session=new[0].name,
         phase_status=status.get("phase"), turns=len(turns),
         error_log_status=error_log.split("**Status:** ")[1].split()[0],
         launches=launches)
    return launches


def commands_phase(torch, project):
    """Phase 32 (module docstring). Returns the launch counts of the
    commands that launched a kernel (warmup)."""
    out, total = {}, dict.fromkeys(launches_now(), 0)
    for argv in (["warmup"], ["status"], ["list"], ["chronicle"],
                 ["decrees"], ["manifest", "list"]):
        rc, log, wall, launches = run_cli(torch, project, argv)
        name = " ".join(argv)
        check(rc == 0, f"commands: {name}: rc {rc}: {log[-2000:]}")
        if argv == ["warmup"]:
            require("commands: warmup", launches, allowed=PAGED_KERNELS[2:])
            check("batch sizes [1, 3]" in log, f"commands: warmup: {log}")
        else:
            check(not any(launches.values()),
                  f"commands: {name} launched {launches}")
        out[name] = {"rc": rc, "wall_s": wall, "lines": len(log.splitlines()),
                     "launches": {k: n for k, n in launches.items() if n}}
        for k, n in launches.items():
            total[k] += n
    emit("commands", commands=out)
    return total


# --- supervision and the telemetry spine (phases 33-37) ---

# The child-process phases' model: llama-3-8b-instruct at full width with
# the depth cut to 8 layers (a child reaches the card in seconds, and a
# sticky CUDA error ends only the child's context).
CHILD_LAYERS = 8
CHILD_MODEL = "llama-3-8b-instruct-8l"
SUPERVISION_TOPICS = ("Journal the committed turns or snapshot the pool?",
                      "Rebuild the engine in process or restart it?")


def register_child_model():
    register_depth("llama-3-8b-instruct", CHILD_LAYERS)


def child_config(**over) -> dict:
    cfg = dict(ENGINE_CONFIG, model=CHILD_MODEL, kv_offload=True)
    cfg.update(over)
    return cfg


def child_cmd(phase: str, *args) -> list:
    """This script as `--child <phase> args...`: a fresh process on the
    card."""
    return [sys.executable, str(Path(__file__).resolve()), "--child", phase,
            *map(str, args)]


def run_child(phase: str, *args, timeout: float = 300.0) -> tuple:
    """Run child_cmd(phase, *args); returns (rc, its last stdout line as
    JSON or None, stdout, stderr). A child past `timeout` is killed: rc
    None."""
    cmd = child_cmd(phase, *args)
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=timeout, cwd=ROOT)
    except subprocess.TimeoutExpired as e:
        return None, None, str(e.stdout or ""), str(e.stderr or "")
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    result = json.loads(lines[-1]) if lines else None
    return out.returncode, result, out.stdout, out.stderr


def page_ids_of(kv, sessions) -> list:
    """Every pool page the slots of `sessions` map, slot by slot in order."""
    from theroundtaible_tpu_torch.engine.kvcache import session_of
    return [p for name in sorted(kv.slot_names())
            if session_of(name) in sessions
            for p in kv._slots[name].pages]


def timed_tier_class(torch, log):
    """Time every HostOffloadTier.evacuate and restore_session of the
    process (the card synchronised at each end) into `log`: the
    supervisor builds the rebuilt engine's tier itself, so its methods are
    wrapped on the class. Returns the undo."""
    from theroundtaible_tpu_torch.engine.kv_offload import HostOffloadTier
    evacuate, restore = HostOffloadTier.evacuate, \
        HostOffloadTier.restore_session

    def timed_evacuate(self, sessions=None):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        manifest = evacuate(self, sessions)
        torch.cuda.synchronize()
        log.append({"op": "evacuate", "s": time.monotonic() - t0,
                    "bytes": manifest["host_bytes"],
                    "pages_moved": manifest["pages_moved"],
                    "sessions": len(manifest["sessions"])})
        return manifest

    def timed_restore(self, session, pinned=()):
        rec = self._spilled.get(session)
        nbytes = rec.host_bytes() if rec else 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        n = restore(self, session, pinned)
        torch.cuda.synchronize()
        log.append({"op": "restore", "session": session, "slots": n,
                    "s": time.monotonic() - t0, "bytes": nbytes})
        return n

    HostOffloadTier.evacuate = timed_evacuate
    HostOffloadTier.restore_session = timed_restore

    def undo():
        HostOffloadTier.evacuate = evacuate
        HostOffloadTier.restore_session = restore
    return undo


def submit_retrying(sched, session, turns, attempts=4, **kw):
    """The adapter ladder's stand-in: resubmit a failed round, waiting out
    a restart in progress. Returns (texts, the errors met)."""
    from theroundtaible_tpu_torch.engine.supervisor import EngineDead
    errors = []
    for _ in range(attempts):
        try:
            texts, _stats = sched.submit(session, turns, timeout_s=600, **kw)
            return texts, errors
        except EngineDead:
            raise
        except Exception as e:  # noqa: BLE001 - recorded, retried
            errors.append(f"{type(e).__name__}: {str(e)[:160]}")
            wait_restart_idle(sched)
    raise Failed(f"{session}: every attempt failed: {errors}")


def wait_restart_idle(sched, timeout_s: float = 120.0) -> None:
    """Block until the supervisor's restart cycle (if one runs) ended: the
    restart lock is free and the scheduler's gate is open."""
    from theroundtaible_tpu_torch.engine.supervisor import supervisor
    lock = supervisor()._restart_lock
    if not lock.acquire(timeout=timeout_s):
        raise Failed("a supervisor restart did not end in time")
    lock.release()
    deadline = time.monotonic() + timeout_s
    while sched.paused is not None and time.monotonic() < deadline:
        time.sleep(0.02)


# The supervision and serving phases 33-34 and 38-39 run an engine of their
# own, cut to SUPERVISION_LAYERS: their checks compare it with itself (the
# same turns, the same seeded weights), not with the 32-layer rounds.
SUPERVISION_LAYERS = 8
SUPERVISION_MODEL = f"llama-3-8b-instruct-{SUPERVISION_LAYERS}l"
SUPERVISION_CONFIG = dict(ENGINE_CONFIG, model=SUPERVISION_MODEL)


def supervision_engine(torch):
    """The engine phases 33-34 and 38-39 share: ENGINE_CONFIG at
    SUPERVISION_LAYERS layers, built through from_config (its rebuild
    recipe is the config)."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    register_depth("llama-3-8b-instruct", SUPERVISION_LAYERS)
    t0 = time.monotonic()
    engine = InferenceEngine.from_config(dict(SUPERVISION_CONFIG))
    torch.cuda.synchronize()
    emit("supervision_engine", layers=SUPERVISION_LAYERS,
         construct_s=time.monotonic() - t0, warmup_s=engine.warmup(),
         memory_allocated=torch.cuda.memory_allocated())
    return engine


def supervised_restart_phase(torch, kattn, base):
    """Phase 33 (module docstring). Returns its launch counts."""
    import contextlib
    import io
    import tempfile
    from theroundtaible_tpu_torch.commands.status import health_status
    from theroundtaible_tpu_torch.engine import faults
    from theroundtaible_tpu_torch.engine import supervisor as sup
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.scheduler import (SessionScheduler,
                                                           acquire_scheduler)
    from theroundtaible_tpu_torch.engine.session_journal import \
        SessionJournal
    from theroundtaible_tpu_torch.utils import telemetry
    card = nvidia_smi()
    link = pcie_link(torch)
    prompts_a1 = offload_prompts("A")
    prompts_b = offload_prompts("B")
    prompts_a2 = offload_prompts("A", round_no=2)
    prompts_c = [("lancelot", "A short council on the hang escalation.")]
    max_new = 32

    # The uninterrupted run: the same turns in the same order on the
    # engine phase's engine (the same seeded weights; the tier changes no
    # numerics).
    ref_sched, created = acquire_scheduler(base)
    try:
        ref = {key: ref_sched.submit(f"ref{key}", p, max_new_tokens=max_new,
                                     timeout_s=600)[0]
               for key, p in (("A", prompts_a1), ("B", prompts_b))}
        ref["A2"] = ref_sched.submit("refA", prompts_a2,
                                     max_new_tokens=max_new,
                                     timeout_s=600)[0]
    finally:
        if created:
            ref_sched.close()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    cfg = dict(SUPERVISION_CONFIG, kv_offload=True)
    t0 = time.monotonic()
    engine = InferenceEngine.from_config(cfg)
    torch.cuda.synchronize()
    construct_s = time.monotonic() - t0
    footprint = torch.cuda.memory_allocated() - m0
    check(engine._engine_config == cfg, "from_config kept no rebuild recipe")
    sup.set_supervisor(sup.EngineSupervisor(hang_threshold=2))
    jdir = Path(tempfile.mkdtemp(prefix="journal-", dir=OUT))
    sched = SessionScheduler(engine, journal=SessionJournal(jdir))
    tier_log: list = []
    undo = timed_tier_class(torch, tier_log)
    reset_launches()
    try:
        # Round 1: session A, then idle.
        a1 = sched.submit("A", prompts_a1, max_new_tokens=max_new,
                          timeout_s=600)[0]
        pages_a = page_ids_of(engine.kv, {"A"})
        tokens_a = {n: list(engine.kv._slots[n].tokens)
                    for n in sorted(engine.kv.slot_names())
                    if n.startswith("A")}
        snap_a = snapshot_pages(torch, engine.kv, pages_a)
        # Round 2: B's round dies with a lost device; the supervisor
        # evacuates A to host RAM, rebuilds, restores A, re-attaches.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        faults.arm("device_lost", count=1)
        t_fault = time.monotonic()
        b, b_errors = submit_retrying(sched, "B", prompts_b,
                                      max_new_tokens=max_new)
        b_served_s = time.monotonic() - t_fault
        faults.disarm()
        peak = torch.cuda.max_memory_allocated()
        snap1 = sup.supervisor_snapshot()
        dump1 = telemetry.last_dump_path()
        report1 = json.loads(Path(dump1).read_text())["extra"]
        new_engine = sched.engine
        check(new_engine is not engine, "the scheduler kept the old engine")
        restored_equal = (
            {n: list(new_engine.kv._slots[n].tokens)
             for n in sorted(new_engine.kv.slot_names())
             if n.startswith("A")} == tokens_a
            and same_pages(torch, new_engine.kv,
                           page_ids_of(new_engine.kv, {"A"}), snap_a))
        del engine
        # Round 2 of A on the restored pages.
        a2 = sched.submit("A", prompts_a2, max_new_tokens=max_new,
                          timeout_s=600)[0]
        # K3 on the rebuilt engine: F joins E's decode through ragged
        # dispatches (no token check: the join's timing sets which steps
        # ride K3).
        joined = {}
        th = threading.Thread(target=lambda: joined.__setitem__(
            "E", sched.submit("E", offload_prompts("E")[:1],
                              max_new_tokens=128, timeout_s=600)[0]))
        th.start()
        deadline = time.monotonic() + 60
        while not sched._active and time.monotonic() < deadline:
            time.sleep(0.002)
        joined["F"] = sched.submit("F", offload_prompts("F")[:1],
                                   max_new_tokens=16, timeout_s=600)[0]
        th.join(timeout=600)
        ragged_joins = sched.describe()["ragged_joins"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            health_rc = health_status()
        health = buf.getvalue()
        # Then an engine wedged past the ladder: hang_threshold firings.
        faults.arm("engine_wedged", count=2)
        t1 = time.monotonic()
        c, c_errors = submit_retrying(sched, "C", prompts_c,
                                      max_new_tokens=8)
        hang_s = time.monotonic() - t1
        faults.disarm()
        snap2 = sup.supervisor_snapshot()
        report2 = json.loads(Path(telemetry.last_dump_path())
                             .read_text())["extra"]
    finally:
        faults.disarm()
        undo()
        sched.close()
        sup.set_supervisor(None)
    launches = launches_now()
    # One engine is left (the scheduler's, rebuilt twice): every earlier
    # instance must be gone once nothing of the phase holds it.
    del new_engine
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated() - m0
    sched.engine = None
    hist = snap2["engines"][0]["history"]
    evac = [e for e in tier_log if e["op"] == "evacuate"]
    rest = [e for e in tier_log if e["op"] == "restore"]
    rates = transfer_rates(evac[:1] + rest, link)
    emit("supervised_restart", card=card, construct_s=construct_s,
         footprint_bytes=footprint, peak_during_rebuild_bytes=peak - m0,
         after_swap_gc_bytes=after, restarts=snap2["restarts"],
         reasons=[h["reason"] for h in hist],
         sessions_recovered=snap2["sessions_recovered"],
         sessions_lost=snap2["sessions_lost"],
         device_lost_restart={k: report1.get(k) for k in (
             "wall_s", "stage_s", "evacuated", "adopted_sessions",
             "restored_sessions", "requests_failed")},
         hang_restart={k: report2.get(k) for k in (
             "reason", "wall_s", "stage_s", "evacuated",
             "restored_sessions")},
         fault_to_served_s=b_served_s,
         b_attempt_errors=b_errors, c_attempt_errors=c_errors,
         hang_escalation_s=hang_s, transfers=rates,
         pages_restored_equal=restored_equal, flight_dump=dump1,
         a1_equal=a1 == ref["A"], b_equal=b == ref["B"],
         a2_equal=a2 == ref["A2"], journal_turns=sched.journal_turns,
         ragged_joins_after_restart=ragged_joins, launches=launches)
    (OUT / "supervised_restart_health.txt").write_text(health)
    check([h["reason"] for h in hist] == ["device_lost", "hang_escalation"]
          and all(h["ok"] for h in hist),
          f"supervised_restart: restarts {hist}")
    check(snap1["restarts"] == 1 and snap1["sessions_recovered"] >= 1,
          f"supervised_restart: {snap1}")
    check(restored_equal, "supervised_restart: A's pages on the rebuilt "
          "engine differ from the host snapshot taken before the fault")
    check(a1 == ref["A"] and b == ref["B"] and a2 == ref["A2"],
          "supervised_restart: greedy tokens differ from the "
          "uninterrupted run")
    check(Path(dump1).is_file() and "supervisor" in Path(dump1).name,
          f"supervised_restart: no supervisor flight dump ({dump1})")
    check(health_rc == 0 and "restarts=1" in health
          and "device_lost: ok" in health,
          f"supervised_restart: status --health: {health}")
    check(after <= footprint + (1 << 30),
          f"supervised_restart: {after} bytes still allocated after the "
          f"swap and gc (one engine: {footprint})")
    check(all(launches[k] > 0 for k in PAGED_KERNELS),
          f"supervised_restart: K1-K3 did not all launch: {launches}")
    check(ragged_joins >= 1 and not th.is_alive(),
          f"supervised_restart: F never joined E ({ragged_joins})")
    return launches


def device_fault_child(out_dir):
    """Phase 34's child: serve two journaled sessions, then a real sticky
    fault. Prints one JSON line; exits with os._exit (no teardown on a dead
    context)."""
    import os
    import torch
    from theroundtaible_tpu_torch.core.errors import classify_error
    from theroundtaible_tpu_torch.engine import faults
    from theroundtaible_tpu_torch.engine import supervisor as sup
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.kernels import build
    from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
    from theroundtaible_tpu_torch.engine.session_journal import \
        SessionJournal
    register_child_model()
    build.build_all()
    engine = InferenceEngine.from_config(child_config())
    sup.set_supervisor(sup.EngineSupervisor(max_restarts=2,
                                            build_attempts=2,
                                            backoff_s=0.1))
    sched = SessionScheduler(engine, journal=SessionJournal(out_dir))
    reset_launches()
    for s in ("s1", "s2"):
        sched.submit(s, offload_prompts(s)[:2], max_new_tokens=16,
                     timeout_s=300)
    launches = launches_now()
    # The fault: an index far past the end of a CUDA tensor trips the
    # gather kernel's device-side bounds assert; the context is lost.
    t_fault = time.monotonic()
    x = torch.zeros(16, device="cuda")
    _ = x[torch.tensor([1 << 30], device="cuda")]
    errors, kinds = [], []
    dead = None
    for _attempt in range(8):
        try:
            sched.submit("s1", offload_prompts("s1", round_no=2)[:2],
                         max_new_tokens=16, timeout_s=300)
            errors.append("served")
        except sup.EngineDead as e:
            dead = e
            break
        except Exception as e:  # noqa: BLE001 - recorded
            errors.append(f"{type(e).__name__}: {str(e)[:200]}")
            kinds.append(classify_error(e))
            wait_restart_idle(sched, 60)
    t_dead = time.monotonic()
    attempts = []

    def touch():
        attempts.append(1)
        return torch.ones(2, device="cuda").sum().item()

    retry_error = None
    try:
        faults.RetryPolicy(max_retries=3, backoff_s=0.01).run(touch)
    except Exception as e:  # noqa: BLE001 - expected
        retry_error = classify_error(e)
    snap = sup.supervisor_snapshot()
    print(json.dumps({
        "kinds": kinds, "errors": errors,
        "dead": dead is not None,
        "dead_kind": getattr(dead, "kind", None),
        "dead_message": str(dead)[:300] if dead else None,
        "fault_to_dead_s": t_dead - t_fault,
        "retry_attempts": len(attempts), "retry_kind": retry_error,
        "restarts": snap["restarts"], "sessions_lost": snap["sessions_lost"],
        "history": snap["engines"][0]["history"] if snap["engines"] else [],
        "journal_turns": sched.journal_turns,
        "launches": launches}), flush=True)
    os._exit(0)


def device_fault_phase(torch):
    """Phase 34 (module docstring). Returns the child's launch counts."""
    import tempfile
    card = nvidia_smi()
    jdir = Path(tempfile.mkdtemp(prefix="fault-", dir=OUT))
    t0 = time.monotonic()
    rc, res, out, err = run_child("device_fault", jdir, timeout=240)
    wall = time.monotonic() - t0
    (OUT / "device_fault.log").write_text(out + "\n--- stderr ---\n" + err)
    check(rc == 0 and res is not None,
          f"device_fault: child rc {rc} (None: killed at its timeout): "
          f"{err[-2000:]}")
    emit("device_fault", card=card, child_wall_s=wall,
         layers=CHILD_LAYERS, **{k: v for k, v in res.items()
                                 if k != "launches"},
         launches=res["launches"])
    check(res["kinds"] and all(k == "device_lost" for k in res["kinds"]),
          f"device_fault: the fault classified {res['kinds']}")
    check(res["retry_attempts"] == 1 and res["retry_kind"] == "device_lost",
          f"device_fault: RetryPolicy made {res['retry_attempts']} "
          f"attempt(s) ({res['retry_kind']})")
    check(res["dead"] and res["dead_kind"] == "device_lost",
          f"device_fault: engine not dead with device_lost: {res}")
    check(res["restarts"] >= 1 and all(not h["ok"] for h in res["history"]),
          f"device_fault: the rebuilds did not fail: {res['history']}")
    return res["launches"]


def journal_project(project: Path, max_rounds: int) -> None:
    """A scratch project whose config seats 3 knights on one torch-llm
    adapter over the child model (seeded random weights, greedy)."""
    (project / ".roundtable").mkdir(parents=True, exist_ok=True)
    sampling = {"temperature": 0.0, "max_new_tokens": 32}
    config = {
        "version": "1.0", "project": "chip-smoke-journal", "language": "en",
        "knights": [{"name": k, "adapter": "torch-llm",
                     "capabilities": ["architecture"], "priority": i + 1}
                    for i, k in enumerate(DISCUSS_KNIGHTS)],
        "rules": {"max_rounds": max_rounds, "consensus_threshold": 9,
                  "timeout_per_turn_seconds": 600,
                  "escalate_to_user_after": 9, "auto_execute": False,
                  "parallel_rounds": True},
        "chronicle": ".roundtable/chronicle.md",
        "adapter_config": {"torch-llm": dict(
            child_config(), sampling=sampling, spec_decode=False,
            knight_sampling={k: dict(sampling) for k in DISCUSS_KNIGHTS})}}
    (project / ".roundtable" / "config.json").write_text(
        json.dumps(config, indent=1))


def journal_serve_child(project, jdir):
    """Phase 35's first child: `serve --journal DIR` on two topics."""
    import os
    from theroundtaible_tpu_torch import cli
    register_child_model()
    os.chdir(project)
    cli.check_for_update = lambda cb: None
    rc = cli.main(["serve", *SUPERVISION_TOPICS, "--journal", str(jdir),
                   "--no-read-code"])
    print(json.dumps({"rc": rc}), flush=True)


def journal_resume_child(project, jdir):
    """Phase 35's second child: `serve --resume DIR` through the CLI, then
    each journaled session's next turn on the resumed engine, and the same
    turns on an engine of this process that never crashed (the journaled
    turns served live: prompt, then the decoded tokens)."""
    import os
    import torch
    from theroundtaible_tpu_torch import cli
    from theroundtaible_tpu_torch.engine import get_engine
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.kernels import build
    from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
    from theroundtaible_tpu_torch.engine.session_journal import (
        SessionJournal, replay_turn_prompt)
    register_child_model()
    build.build_all()
    os.chdir(project)
    cli.check_for_update = lambda cb: None
    config = json.loads(Path(".roundtable/config.json").read_text())
    adapter_cfg = config["adapter_config"]["torch-llm"]
    engine = get_engine(adapter_cfg, "cuda")    # the CLI reuses it
    journal = SessionJournal(jdir)
    sessions = journal.sessions()
    lines_before = {s: len(journal.path_for(s).read_text().splitlines())
                    for s in sessions}
    records = {s: journal.turns(s) for s in sessions}
    replayed_tokens = sum(len(replay_turn_prompt(row))
                          for recs in records.values() for rec in recs
                          for row in rec["rows"])
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rc = cli.main(["serve", "--resume", str(jdir)])
    torch.cuda.synchronize()
    replay_s = time.monotonic() - t0
    launches = launches_now()
    sched = engine._scheduler
    if sched is None or sched.journal is None:
        raise Failed("serve --resume replayed onto another engine")
    suffix = engine.tokenizer.encode(
        " Next round: each knight, revise your score.")[1:]
    resumed = {}
    for s in sessions:
        last = records[s][-1]
        turns = [(row["knight"], replay_turn_prompt(row) + suffix)
                 for row in last["rows"]]
        sched.submit(s, turns, max_new_tokens=16, timeout_s=600)
        rec = journal.turns(s)[-1]
        resumed[s] = {row["knight"]: row["produced"] for row in rec["rows"]}
    numbering = {s: [r["turn"] for r in journal.turns(s)] for s in sessions}
    lines_after = {s: len(journal.path_for(s).read_text().splitlines())
                   for s in sessions}
    # The run that never crashed: the journaled turns served live on an
    # engine of the same config, then the same next turn.
    ref_dir = Path(jdir).parent / "reference-journal"
    ref_engine = InferenceEngine.from_config(adapter_cfg)
    ref_sched = SessionScheduler(ref_engine,
                                 journal=SessionJournal(ref_dir))
    ref_journal = SessionJournal(ref_dir)
    reference, live_equal, flips = {}, True, []
    for s in sessions:
        for rec in records[s]:
            turns = [(row["knight"], list(row["prompt_tokens"]))
                     for row in rec["rows"]]
            want = max(len(row["produced"]) for row in rec["rows"])
            ref_sched.submit(s, turns, max_new_tokens=max(want, 1),
                             timeout_s=600)
            got = {row["knight"]: row["produced"]
                   for row in ref_journal.turns(s)[-1]["rows"]}
            live_equal &= got == {row["knight"]: row["produced"]
                                  for row in rec["rows"]}
        last = records[s][-1]
        turns = [(row["knight"], replay_turn_prompt(row) + suffix)
                 for row in last["rows"]]
        ref_sched.submit(s, turns, max_new_tokens=16, timeout_s=600)
        reference[s] = {row["knight"]: row["produced"]
                        for row in ref_journal.turns(s)[-1]["rows"]}
        for (knight, prompt) in turns:
            a, b = resumed[s][knight], reference[s][knight]
            i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if i is None:
                continue
            logits = next_token_logits(ref_engine, list(prompt) + b[:i])
            top = torch.topk(logits, 2)
            flips.append({"session": s, "knight": knight, "position": i,
                          "margin": float(top.values[0] - top.values[1])})
    ref_sched.close()
    print(json.dumps({
        "rc": rc, "sessions": len(sessions),
        "turns_replayed": sum(len(r) for r in records.values()),
        "tokens_replayed": replayed_tokens, "replay_s": replay_s,
        "numbering": numbering, "lines_before": lines_before,
        "lines_after": lines_after,
        "equal": resumed == reference, "flips": flips,
        "live_reference_reproduces_journal": bool(live_equal),
        "launches": launches}), flush=True)


def journal_resume_phase(torch):
    """Phase 35 (module docstring). Returns the children's launch counts."""
    import os
    import shutil
    import signal
    import tempfile
    card = nvidia_smi()
    work = Path(tempfile.mkdtemp(prefix="journal-resume-", dir=OUT))
    project, jdir = work / "project", work / "journal"
    journal_project(project, max_rounds=6)
    cmd = child_cmd("journal_serve", project, jdir)
    log = open(OUT / "journal_serve.log", "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            cwd=ROOT)
    t0 = time.monotonic()
    killed_at = None
    try:
        from theroundtaible_tpu_torch.engine.session_journal import \
            SessionJournal
        journal = SessionJournal(jdir)
        while time.monotonic() - t0 < 240 and proc.poll() is None:
            counts = [len(journal.turns(s)) for s in journal.sessions()]
            if len(counts) == 2 and min(counts) >= 1:
                # Round 1 committed for both; round 2 is running.
                time.sleep(0.3)
                os.kill(proc.pid, signal.SIGKILL)
                killed_at = time.monotonic() - t0
                break
            time.sleep(0.05)
    finally:
        if proc.poll() is None and killed_at is None:
            proc.kill()
        proc.wait(timeout=60)
        log.close()
    check(killed_at is not None and proc.returncode == -signal.SIGKILL,
          f"journal_resume: the serving child was not killed mid-serve "
          f"(rc {proc.returncode}): "
          f"{(OUT / 'journal_serve.log').read_text()[-2000:]}")
    rc, res, out, err = run_child("journal_resume", project, jdir,
                                  timeout=300)
    (OUT / "journal_resume.log").write_text(out + "\n--- stderr ---\n" + err)
    check(rc == 0 and res is not None and res["rc"] == 0,
          f"journal_resume: child rc {rc}: {err[-2000:]}")
    margins_ok = all(f["margin"] < PATH_TOL for f in res["flips"])
    emit("journal_resume", card=card, layers=CHILD_LAYERS,
         killed_after_s=killed_at,
         **{k: v for k, v in res.items() if k != "launches"},
         launches=res["launches"])
    numbering_ok = all(
        nums == list(range(len(nums)))
        and res["lines_after"][s] == res["lines_before"][s] + 1
        for s, nums in res["numbering"].items())
    check(res["sessions"] == 2 and res["turns_replayed"] >= 2,
          f"journal_resume: replayed {res['turns_replayed']} turns of "
          f"{res['sessions']} sessions")
    check(numbering_ok, "journal_resume: numbering broken or a record "
          f"doubled: {res['numbering']} {res['lines_before']} -> "
          f"{res['lines_after']}")
    # The replayed KV comes from one prefill (K2) where the live run's came
    # from decode steps (K1): bf16 rounds them differently, so a greedy
    # flip is allowed only at a near tie, the rule spec_scheduler holds Q1
    # to.
    check(res["equal"] or margins_ok,
          f"journal_resume: the next turn differs from the run that never "
          f"crashed away from a near tie: {res['flips']}")
    shutil.rmtree(work, ignore_errors=True)
    return res["launches"]


def telemetry_overhead_phase(torch, base):
    """Phase 36 (module docstring). Returns its launch counts."""
    import tempfile
    from theroundtaible_tpu_torch.engine import serving_loop
    from theroundtaible_tpu_torch.utils import telemetry
    card = nvidia_smi()
    prompts = knight_prompts(1)
    turns = [(k, p) for k, p in prompts.items()]
    sink_dir = Path(tempfile.mkdtemp(prefix="telemetry-", dir=OUT))
    max_new = 64
    runs = {"disarmed": [], "armed": []}
    syncs = {"disarmed": [], "armed": []}
    reset_launches()
    base.generate_batch(turns, max_new_tokens=max_new, session="tele")
    for i in range(5):
        for mode in ("disarmed", "armed"):
            s0 = serving_loop.host_syncs()
            if mode == "armed":
                telemetry.arm()
                sink = telemetry.session_sink(sink_dir)
                with telemetry.span("discussion", sink=sink,
                                    session="tele"), \
                        telemetry.span("round", round=i):
                    base.generate_batch(turns, max_new_tokens=max_new,
                                        session="tele")
                telemetry.disarm()
            else:
                base.generate_batch(turns, max_new_tokens=max_new,
                                    session="tele")
            st = base.last_stats
            steps = max(st.decode_tokens / len(turns), 1)
            runs[mode].append(1e3 * st.decode_seconds / steps)
            syncs[mode].append((serving_loop.host_syncs() - s0) / steps)
    launches = launches_now()
    lines = (sink_dir / "telemetry" / "spans.jsonl").read_text().splitlines()
    parsed = [json.loads(line) for line in lines]
    rungs = Counter(r["rung"] for r in parsed)

    def med(v):
        return statistics.median(v)
    emit("telemetry_overhead", card=card, rows=len(turns),
         max_new=max_new, decode_ms_per_step=runs,
         disarmed_median_ms=med(runs["disarmed"]),
         armed_median_ms=med(runs["armed"]),
         disarmed_spread_ms=max(runs["disarmed"]) - min(runs["disarmed"]),
         armed_spread_ms=max(runs["armed"]) - min(runs["armed"]),
         host_syncs_per_step=syncs, span_lines=len(parsed),
         rungs=dict(rungs), launches=launches)
    for rung in ("discussion", "round", "turn", "prefill", "decode",
                 "segment", "dispatch"):
        check(rungs[rung] > 0, f"telemetry_overhead: no {rung} span: "
              f"{dict(rungs)}")
    check(syncs["armed"] == syncs["disarmed"],
          f"telemetry_overhead: host syncs per step differ: {syncs}")
    check(telemetry.ACTIVE is False, "telemetry left armed")
    return launches


def build_watch_phase():
    """Phase 37 (module docstring)."""
    from theroundtaible_tpu_torch.engine import compile_watch
    s = compile_watch.summary(recent=64)
    builds = [{k: e[k] for k in ("library", "dur_s", "cache_hit", "label",
                                 "steady_state") if k in e}
              for e in compile_watch.history()]
    emit("build_watch", card=nvidia_smi(), mode=s["mode"],
         compiles=s["compiles"], cache_hits=s["cache_hits"],
         cache_misses=s["cache_misses"],
         steady_state_compiles=s["steady_state_compiles"],
         steady_state=s["steady_state"], builds=builds,
         # One nvcc per source, all started together: a library's seconds
         # run from the start of the build to its load, so the build's
         # wall is the longest.
         build_wall_s=max((b["dur_s"] for b in builds), default=0.0))
    check(s["mode"] == "build-seam", f"build_watch: mode {s['mode']}")
    check(s["steady_state_compiles"] == 0,
          f"build_watch: {s['steady_state_compiles']} builds after warmup")
    check(len(builds) >= len(__import__(
        "theroundtaible_tpu_torch.engine.kernels.build",
        fromlist=["x"]).SOURCES), f"build_watch: builds {builds}")


# --- the perf model and the serving gateway (phases 38-40) ---


def tree_bytes(params) -> int:
    """The param tree's stored bytes: numel x element size of every leaf
    (an Int4Leaf's packed weight and its scales)."""
    total = 0
    for _path, leaf in tree_leaves(params):
        parts = (leaf.q4, leaf.s4) if hasattr(leaf, "q4") else (leaf,)
        total += sum(t.numel() * t.element_size() for t in parts)
    return total


def perf_gauges(engine) -> dict:
    from theroundtaible_tpu_torch.utils import telemetry
    name = engine.cfg.name
    return {"bw_utilization_decode": telemetry.REGISTRY.gauge_value(
                "roundtable_bw_utilization", engine=name, phase="decode"),
            "mfu_prefill": telemetry.REGISTRY.gauge_value(
                "roundtable_mfu", engine=name, phase="prefill")}


def perf_reading(engine, stats, rows: int = 3) -> dict:
    """One call's gauges beside what they stand for: decode ms per step,
    the share of the card's memory rate the weights streamed once per step
    took (param_bytes x steps / s over 3.35 TB/s), and the gauge's ratio
    to that share (about the row count: the gauge counts every row's
    tokens against one stream's ceiling)."""
    g = perf_gauges(engine)
    steps = stats.decode_tokens / rows
    steps_per_s = steps / max(stats.decode_seconds, 1e-9)
    share = engine.perf.param_bytes * steps_per_s / HBM_BYTES_PER_S
    bw = g["bw_utilization_decode"]
    return {**g, "decode_ms_per_step": 1e3 / steps_per_s,
            "weight_share_per_step": share,
            "gauge_over_share": (bw / share) if bw and share else None,
            "prefill_s": stats.prefill_seconds,
            "prefill_tokens": stats.prefill_tokens,
            "decode_tokens": stats.decode_tokens}


def status_view(view: str, root: Path) -> str:
    """`roundtable status --<view>` in `root`, its output captured."""
    import contextlib
    import io
    from theroundtaible_tpu_torch.commands.status import status_command
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = status_command(str(root), **{f"{view}_view": True})
    check(rc == 0, f"status --{view} rc {rc}")
    return out.getvalue()


def status_root() -> Path:
    """A project directory holding one (empty) session: the --perf and
    --kv views render the latest session's view of the live registry."""
    root = OUT / "status-project"
    session = root / ".roundtable" / "sessions" / "2026-01-01-0000-perf"
    session.mkdir(parents=True, exist_ok=True)
    (session / "topic.md").write_text("perf model")
    return root


def perf_model_phase(torch, kattn, engine):
    """Phase 38 (module docstring). Returns its launch counts."""
    import os
    from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
    from theroundtaible_tpu_torch.engine.serving_loop import DECODE_SEGMENT
    from theroundtaible_tpu_torch.utils import perfmodel, telemetry
    card = nvidia_smi()
    perf = engine.perf
    check(os.environ.get(perfmodel.CHIP_ENV) is None,
          f"{perfmodel.CHIP_ENV} is set: the chip must be detected")
    check(perf.chip is not None and perf.chip.name == "h100"
          and perf.chip_source == "detected",
          f"perf_model: chip {perf.describe()} on "
          f"{torch.cuda.get_device_name(0)!r}")
    stored = tree_bytes(engine.params)
    check(perf.param_bytes == stored,
          f"perf_model: param_bytes {perf.param_bytes} != tree {stored}")
    ceiling, peak = 3350e9 / stored, 989e12 / (2 * engine.num_params)
    check(abs(perf.decode_ceiling - ceiling) <= 1e-9 * ceiling
          and abs(perf.prefill_peak - peak) <= 1e-9 * peak,
          f"perf_model: ceilings {perf.describe()} against {ceiling}, "
          f"{peak}")
    check(telemetry.REGISTRY.gauge_value(
        "roundtable_decode_ceiling_tps", engine=engine.cfg.name)
        == perf.decode_ceiling, "perf_model: no decode ceiling gauge")
    engine.kv.flush()
    reset_launches()
    readings = {"direct": [], "scheduler": []}
    prompts, direct_tps = None, None
    for rnd in (1, 2):
        prompts = knight_prompts(rnd, prompts)
        _out, stats = engine.generate_batch_with_stats(
            list(prompts.items()), max_new_tokens=64, session="perf-direct")
        readings["direct"].append(perf_reading(engine, stats))
        direct_tps = direct_tps or stats.decode_tps
    # The scheduler's rounds with telemetry armed: its spans give the
    # flight dump's span overheads.
    sched = SessionScheduler(engine)
    telemetry.recorder().clear()
    samples, continued = [], []
    try:
        telemetry.arm()
        try:
            prompts = None
            for rnd in (1, 2):
                prompts = knight_prompts(rnd, prompts)
                _texts, stats = sched.submit(
                    "perf-sched", list(prompts.items()), max_new_tokens=64,
                    timeout_s=600)
                readings["scheduler"].append(perf_reading(engine, stats))
        finally:
            telemetry.disarm()
        # One round past DECODE_SEGMENT: its plain segments pipeline (the
        # next dispatched before this one is read), and each segment's
        # roofline sample must still be timed over its own segment.
        may_continue = sched._may_continue

        def spy(ctx):
            continued.append(may_continue(ctx))
            return continued[-1]

        def record(tokens, seconds, **kw):
            samples.append(tokens / seconds)
            type(perf).publish_decode_sample(perf, tokens, seconds, **kw)
        sched._may_continue, perf.publish_decode_sample = spy, record
        try:
            _texts, stats = sched.submit(
                "perf-long", list(knight_prompts(1).items()),
                max_new_tokens=3 * DECODE_SEGMENT, timeout_s=600)
        finally:
            del perf.publish_decode_sample
        long_round = dict(perf_reading(engine, stats),
                          pipelined=any(continued),
                          segment_samples_tps=samples,
                          direct_round1_tps=direct_tps,
                          sample_over_direct=[x / direct_tps
                                              for x in samples])
    finally:
        sched.close()
    torch.cuda.synchronize()
    launches = launches_now()
    root = status_root()
    perf_out, kv_out = status_view("perf", root), status_view("kv", root)
    dump = json.loads(Path(telemetry.flight_dump("perf_model")).read_text())
    block = dump.get("perf", {})
    series = block.get("series", {})
    mem = {k: telemetry.REGISTRY.gauge_value(k, engine=engine.cfg.name)
           for k in ("roundtable_hbm_bytes_in_use",
                     "roundtable_hbm_bytes_limit")}
    emit("perf_model", card=card, describe=perf.describe(),
         tree_bytes=stored, readings=readings, long_round=long_round,
         memory=mem,
         dump_series=len(series),
         dump_overheads=sorted(block.get("overheads", {})),
         launches=launches)
    for path, rs in readings.items():
        for r in rs:
            check(all(v is not None and v == v and 0 < v < float("inf")
                      for v in (r["bw_utilization_decode"],
                                r["mfu_prefill"])),
                  f"perf_model {path}: gauges {r}")
    check(long_round["pipelined"] and len(samples) >= 3
          and all(0.5 < r < 2.0 for r in long_round["sample_over_direct"]),
          f"perf_model: the pipelined round's decode samples against the "
          f"direct call's rate: {long_round}")
    check("Roofline (per engine):" in perf_out
          and engine.cfg.name in perf_out
          and "Memory ledger" in perf_out, "status --perf did not render")
    check("Memory ledger (HBM tier):" in kv_out,
          "status --kv did not render")
    check(any(k.startswith("roundtable_bw_utilization") for k in series)
          and any(k.startswith("roundtable_mfu") for k in series),
          f"perf_model: the dump's perf block lacks the gauges: {series}")
    check({"turn", "segment"} & set(block.get("overheads", {})),
          f"perf_model: no span overheads in the dump: {block.keys()}")
    check(mem["roundtable_hbm_bytes_in_use"]
          and mem["roundtable_hbm_bytes_limit"],
          f"perf_model: the memory ledger's device half: {mem}")
    # The rounds run alone (no join): K2 prefills, K1 decodes.
    check(all(launches[k] > 0 for k in PAGED_KERNELS[:2]),
          f"perf_model: launches {launches}")
    for name in engine.kv.slot_names():
        engine.kv.release(name)
    return launches


class SseClient:
    """One request to the gateway through http.client. An SSE response is
    read event by event as it arrives, each stamped with the monotonic
    time it was read."""

    def __init__(self, port, method, path, body=None, headers=None,
                 timeout=600.0):
        import http.client
        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=timeout)
        payload = json.dumps(body).encode() if body is not None else None
        self.t0 = time.monotonic()
        self.conn.request(method, path, body=payload,
                          headers=dict(headers or {}))
        self.resp = self.conn.getresponse()
        self.status = self.resp.status
        self.headers = {k.lower(): v for k, v in self.resp.getheaders()}

    def json(self) -> dict:
        return json.loads(self.resp.read().decode("utf-8"))

    def events(self):
        """(event id, data, arrival time) per SSE event until EOF."""
        eid, data = None, []
        while True:
            raw = self.resp.readline()
            if not raw:
                return
            ln = raw.decode("utf-8").rstrip("\r\n")
            if ln.startswith("id: "):
                eid = ln[4:]
            elif ln.startswith("data: "):
                data.append(ln[6:])
            elif ln == "" and data:
                yield eid, "\n".join(data), time.monotonic()
                eid, data = None, []

    def close(self) -> None:
        self.conn.close()


class StreamRead:
    """A native stream's events: meta, token events (id, payload, time),
    the terminal event. `drop_after` closes the socket after that many
    token events (the client walks away mid-stream); `first`, an Event,
    is set at the first token event."""

    def __init__(self, client, drop_after=None, first=None):
        self.client = client
        self.meta, self.tokens, self.terminal = None, [], None
        for eid, data, at in client.events():
            ev = json.loads(data)
            if ev["type"] == "stream":
                self.meta = ev
            elif ev["type"] in ("tokens", "summary"):
                self.tokens.append((eid, ev, at))
                if first is not None:
                    first.set()
                if drop_after is not None and \
                        len(self.tokens) >= drop_after:
                    break
            else:
                self.terminal = ev
                break
        client.close()

    def rows(self, n: int) -> list:
        out = [[] for _ in range(n)]
        for _eid, ev, _at in self.tokens:
            if ev["type"] == "tokens":
                out[ev["row"]].extend(ev["tokens"])
            else:
                for i, d in ev["rows"].items():
                    out[int(i)].extend(d["tokens"])
        return out


def wait_for(pred, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.002)


def monotone_ids(read: StreamRead, rows: int, start=None) -> bool:
    """Every event id's per-row counts grow and equal the tokens delivered
    up to it (from `start`, a reconnect's watermark)."""
    from theroundtaible_tpu_torch.gateway.streams import parse_event_id
    running = list(start or [0] * rows)
    for eid, ev, _at in read.tokens:
        parsed = parse_event_id(eid, rows)
        if parsed is None:
            return False
        running[ev["row"]] += len(ev["tokens"])
        if parsed[1] != running:
            return False
    return True


def event_gaps(read: StreamRead) -> list:
    """Seconds between a stream's successive token events at the client."""
    times = [at for _eid, _ev, at in read.tokens]
    return [b - a for a, b in zip(times, times[1:])]


def release_session(engine, session: str) -> None:
    from theroundtaible_tpu_torch.engine.kvcache import session_of
    with engine._serve_lock:
        for name in engine.kv.slot_names():
            if session_of(name) == session:
                engine.kv.release(name)


GATEWAY_MAX_NEW = 96


def gateway_stream_phase(torch, kattn, engine):
    """Phase 39 (module docstring). Returns its launch counts."""
    import contextlib
    import io
    import os
    import tempfile
    from theroundtaible_tpu_torch.commands.trace_cmd import trace_command
    from theroundtaible_tpu_torch.engine import serving_loop
    from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
    from theroundtaible_tpu_torch.engine.session_journal import \
        SessionJournal
    from theroundtaible_tpu_torch.gateway import Gateway
    from theroundtaible_tpu_torch.gateway.streams import parse_event_id
    from theroundtaible_tpu_torch.utils import tracing
    card = nvidia_smi()
    work = Path(tempfile.mkdtemp(prefix="gateway-", dir=OUT))
    tdir = work / "traces"
    saved = {k: os.environ.get(k) for k in
             ("ROUNDTABLE_GATEWAY_MAX_INFLIGHT", "ROUNDTABLE_TRACE_DIR")}
    os.environ["ROUNDTABLE_GATEWAY_MAX_INFLIGHT"] = "2"
    os.environ["ROUNDTABLE_TRACE_DIR"] = str(tdir)
    tracing.store().reset()
    check(engine.ragged_path == "cuda_ragged" and engine.paged_direct,
          f"gateway_stream: the engine serves {engine.ragged_path}, "
          f"paged_direct {engine.paged_direct}")
    engine.kv.flush()
    sched = SessionScheduler(engine, journal=SessionJournal(work / "journal"))
    gw = Gateway(sched, port=0, intent_dir=str(work / "journal"))
    port = gw.start_in_thread()
    turns = [{"knight": k, "prompt": p}
             for k, p in knight_prompts(1).items()]
    client_tid = "c0ffee00d15c0001"
    results, errors = {}, {}
    try:
        reset_launches()
        # alpha, then beta once alpha's rows are live: beta joins alpha's
        # decode through ragged dispatches (K3); beta's client drops its
        # socket after its first token event and reconnects; a third
        # stream, while both are in flight, is shed.

        def alpha():
            c = SseClient(port, "POST", "/v1/discussions",
                          {"session": "gw-alpha", "turns": turns,
                           "max_new_tokens": GATEWAY_MAX_NEW},
                          headers={"Traceparent":
                                   tracing.format_traceparent(
                                       client_tid, "1234567890ab")})
            results["alpha_status"] = c.status
            results["alpha_header"] = c.headers.get("traceparent", "")
            results["alpha"] = StreamRead(c)

        def beta():
            c = SseClient(port, "POST", "/v1/discussions",
                          {"session": "gw-beta", "turns": turns,
                           "max_new_tokens": GATEWAY_MAX_NEW})
            first = StreamRead(c, drop_after=1)
            results["beta_first"] = first
            eid = first.tokens[-1][0]
            c2 = SseClient(port, "GET",
                           f"/v1/streams/{first.meta['stream']}",
                           headers={"Last-Event-ID": eid})
            results["beta_rest"] = StreamRead(c2)

        def guarded(fn, name):
            def run():
                try:
                    fn()
                except Exception as e:  # noqa: BLE001 - checked below
                    errors[name] = repr(e)
            return run
        t0 = time.monotonic()
        th_a = threading.Thread(target=guarded(alpha, "alpha"))
        th_a.start()
        wait_for(lambda: sched._active or errors, 300, "alpha's rows")
        th_b = threading.Thread(target=guarded(beta, "beta"))
        th_b.start()
        wait_for(lambda: len(gw.streams) >= 2 or errors, 60,
                 "beta's stream")
        shed = SseClient(port, "POST", "/v1/discussions",
                         {"session": "gw-shed", "turns": turns[:1],
                          "max_new_tokens": 8})
        shed_status, shed_headers = shed.status, shed.headers
        shed_body = shed.json()
        shed.close()
        th_a.join(600)
        th_b.join(600)
        streams_wall = time.monotonic() - t0
        check(not errors, f"gateway_stream clients failed: {errors}")
        alpha_r, beta_first, beta_rest = (results["alpha"],
                                          results["beta_first"],
                                          results["beta_rest"])
        # the chat completions, streamed and not
        chat_body = {"model": "lancelot", "max_tokens": 64,
                     "messages": [{"role": "user",
                                   "content": knight_prompts(1)["lancelot"]}]}
        c = SseClient(port, "POST", "/v1/chat/completions",
                      dict(chat_body, session="gw-chat-st", stream=True))
        chat_events, deltas = [], []
        for _eid, data, at in c.events():
            if data == "[DONE]":
                break
            choice = json.loads(data)["choices"][0]
            deltas.append(choice["delta"].get("content", ""))
            chat_events.append(at)
        c.close()
        chat_stream_s = (chat_events[-1] - c.t0) if chat_events else None
        c = SseClient(port, "POST", "/v1/chat/completions",
                      dict(chat_body, session="gw-chat-ns"))
        chat_full = c.json()
        c.close()
        chat_launches = launches_now()
        metrics = SseClient(port, "GET", "/metrics")
        metrics_text = metrics.resp.read().decode("utf-8")
        metrics.close()

        # The scheduler's own submissions of the same turns, in the same
        # order (ref-beta once ref-alpha's rows are live), outside the
        # gateway: the streams must carry exactly their tokens.
        ref_events = {"ref-alpha": [], "ref-beta": []}
        refs = {}

        def ref(session):
            req = sched.submit_async(
                session, [(t["knight"], t["prompt"]) for t in turns],
                max_new_tokens=GATEWAY_MAX_NEW, timeout_s=600,
                on_commit=ref_events[session].append)
            refs[session] = sched.wait(req)
        th = threading.Thread(target=guarded(lambda: ref("ref-alpha"),
                                             "ref-alpha"))
        th.start()
        wait_for(lambda: sched._active or errors, 300, "ref-alpha's rows")
        ref("ref-beta")
        th.join(600)
        check(not errors, f"gateway_stream references failed: {errors}")

        # decode ms per step with and without a poller on /healthz and
        # /metrics, 3 + 3 interleaved
        polls = {"without": [], "with": []}
        syncs = {"without": [], "with": []}
        poll_hits = []
        for i in range(3):
            for mode in ("without", "with"):
                stop = threading.Event()

                def poller():
                    while not stop.is_set():
                        for path in ("/healthz", "/metrics"):
                            p = SseClient(port, "GET", path)
                            p.resp.read()
                            p.close()
                            poll_hits.append(path)
                        stop.wait(0.05)
                session = f"gw-poll-{mode}-{i}"
                s0 = serving_loop.host_syncs()
                pt = threading.Thread(target=poller)
                if mode == "with":
                    pt.start()
                c = SseClient(port, "POST", "/v1/discussions",
                              {"session": session, "turns": turns,
                               "max_new_tokens": 64})
                read = StreamRead(c)
                stop.set()
                if mode == "with":
                    pt.join(30)
                state = gw.streams[read.meta["stream"]]
                _texts, stats = sched.wait(state.request)
                steps = stats.decode_tokens / len(turns)
                polls[mode].append(1e3 * stats.decode_seconds / steps)
                syncs[mode].append((serving_loop.host_syncs() - s0) / steps)
                release_session(engine, session)
        torch.cuda.synchronize()
        launches = launches_now()
        trace_out = io.StringIO()
        with contextlib.redirect_stdout(trace_out):
            rc_list = trace_command("list", trace_dir=str(tdir))
            rc_show = trace_command("show", trace_id=client_tid,
                                    trace_dir=str(tdir))
        root = status_root()
        gateway_out = status_view("gateway", root)
        slo_out = status_view("slo", root)
        describe = gw.describe()
    finally:
        gw.stop()
        sched.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    # --- the checks ---
    n = len(turns)
    alpha_rows = alpha_r.rows(n)
    beta_rows = [a + b for a, b in zip(beta_first.rows(n),
                                       beta_rest.rows(n))]
    ref_rows = {s: [[t for e in evs if e["type"] == "tokens"
                     and e["row"] == i for t in e["tokens"]]
                    for i in range(n)]
                for s, evs in ref_events.items()}
    records = {rec["trace_id"]: rec for rec in tracing.store().recent()}
    legs = tracing.load_traces(str(tdir))
    max_gap = max((abs(leg["wall_s"] - leg["stage_sum_s"])
                   for ls in legs.values() for leg in ls), default=0.0)
    gaps = {"alpha": event_gaps(alpha_r),
            "beta": event_gaps(beta_first) + event_gaps(beta_rest)}

    def stages(read):
        rec = records.get(read.meta["trace"], {})
        return {k: rec.get("stages", {}).get(k) for k in
                ("admission", "queue_wait", "placement", "prefill",
                 "first_flush")} | {"ttft_s": rec.get("ttft_s")}

    def tok_s(read, rows):
        times = [at for _e, _ev, at in read.tokens]
        return (sum(len(r) for r in rows) / (times[-1] - read.client.t0)
                if times else None)
    emit("gateway_stream", card=card, streams_wall_s=streams_wall,
         ttft_stages={"alpha": stages(alpha_r), "beta": stages(beta_first)},
         event_gaps_s=gaps,
         max_event_gap_s={k: max(v, default=None) for k, v in gaps.items()},
         tokens_per_s={"alpha": tok_s(alpha_r, alpha_rows)},
         tokens_per_stream=[sum(map(len, alpha_rows)),
                            sum(map(len, beta_rows))],
         beta_reconnect_watermark=beta_first.tokens[-1][0],
         shed={"status": shed_status, "body": shed_body,
               "retry_after": shed_headers.get("retry-after")},
         chat={"stream_s": chat_stream_s, "events": len(chat_events),
               "completion_tokens": chat_full["usage"]["completion_tokens"]},
         decode_ms_per_step=polls,
         decode_ms_per_step_median={k: statistics.median(v)
                                    for k, v in polls.items()},
         host_syncs_per_step=syncs, poller_requests=len(poll_hits),
         retained_traces=len(legs), stage_sum_gap_max_s=max_gap,
         describe=describe,
         launches=launches, chat_launches=chat_launches)
    check(results["alpha_status"] == 200
          and client_tid in results["alpha_header"],
          f"gateway_stream: traceparent not echoed: {results}")
    check(alpha_r.terminal == {"type": "retired", "session": "gw-alpha",
                               "turn": 0, "trace": client_tid},
          f"gateway_stream: alpha ended {alpha_r.terminal}")
    check(beta_rest.terminal is not None
          and beta_rest.terminal["type"] == "retired",
          f"gateway_stream: beta ended {beta_rest.terminal}")
    check(alpha_rows == ref_rows["ref-alpha"]
          and beta_rows == ref_rows["ref-beta"],
          "gateway_stream: a stream differs from the scheduler's "
          "submission of the same turns")
    # ...and against the texts submit returns, which the stream flush
    # does not touch (its eos trim, a doubled or a lost token would show).
    for name, rows in (("alpha", alpha_rows), ("beta", beta_rows)):
        check([engine.tokenizer.decode(r) for r in rows]
              == refs[f"ref-{name}"][0],
              f"gateway_stream: {name}'s tokens differ from submit's texts")
    check(all(alpha_rows) and all(beta_rows),
          f"gateway_stream: empty rows {list(map(len, alpha_rows))} "
          f"{list(map(len, beta_rows))}")
    start = parse_event_id(beta_first.tokens[-1][0], n)[1]
    check(monotone_ids(alpha_r, n) and monotone_ids(beta_first, n)
          and monotone_ids(beta_rest, n, start),
          "gateway_stream: event ids not monotone per row")
    check(beta_rest.meta["trace"] == beta_first.meta["trace"],
          "gateway_stream: the reconnect left beta's trace")
    check(shed_status == 429 and shed_body.get("reason") == "inflight_cap"
          and int(shed_headers.get("retry-after", "0")) >= 1,
          f"gateway_stream: the third stream got {shed_status} "
          f"{shed_body} {shed_headers}")
    check("".join(deltas) == chat_full["choices"][0]["message"]["content"],
          "gateway_stream: the streamed chat differs from the non-stream "
          "reply")
    # The stage marks and carves split the leg's whole wall, which ends at
    # the tail stage's mark: their sum is the wall up to rounding.
    check(legs and max_gap <= 1e-4,
          f"gateway_stream: a retained trace's stage sum is not its wall "
          f"(largest gap {max_gap} s)")
    check(client_tid in legs, "gateway_stream: the client's trace was not "
          "retained")
    check(all(name in metrics_text for name in (
        "roundtable_bw_utilization", "roundtable_mfu",
        "roundtable_decode_ceiling_tps")),
        "gateway_stream: /metrics lacks the perf gauges")
    check(rc_list == 0 and rc_show == 0
          and client_tid in trace_out.getvalue(),
          "gateway_stream: `roundtable trace` did not render")
    check("Serving gateway" in gateway_out and "TTFT stage split"
          in gateway_out and "SLO burn rate" in slo_out,
          "gateway_stream: status --gateway/--slo did not render")
    check(syncs["with"] == syncs["without"],
          f"gateway_stream: host syncs per step differ: {syncs}")
    check(launches["paged_decode_attention"] > 0
          and launches["ragged_paged_attention"] > 0,
          f"gateway_stream: K1/K3 launches {launches}")
    for s in ("gw-alpha", "gw-beta", "gw-chat-st", "gw-chat-ns",
              "ref-alpha", "ref-beta"):
        release_session(engine, s)
    import shutil
    shutil.rmtree(work, ignore_errors=True)
    return launches


def near_tie(torch, engine, prompt_tokens, a, b) -> dict | None:
    """Where greedy streams `a` and `b` of one prompt first differ (a stream
    that ends first ends at its eos): `engine`'s top-2 margin after `b`'s
    prefix there. None where they agree."""
    i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if i is None and len(a) != len(b):
        i = min(len(a), len(b))
    if i is None:
        return None
    with engine._serve_lock:   # the replica's scheduler may still run
        logits = next_token_logits(engine, list(prompt_tokens) + b[:i])
    top = torch.topk(logits, 2)
    return {"position": i, "a_token": a[i] if i < len(a) else None,
            "b_token": b[i] if i < len(b) else None,
            "rerun_top2": [int(x) for x in top.indices],
            "margin": float(top.values[0] - top.values[1])}


def resume_flip(torch, engine, query) -> dict:
    """Where two greedy streams of one prompt first differ (`a` against
    `b`; a stream that ends first ends at its eos), the top-2 margin of
    `engine`'s logits after the common prefix: a near tie flips when it is
    below PATH_TOL."""
    out = {k: query[k] for k in ("client", "pair")}
    flip = near_tie(torch, engine, query["prompt"], query["a"], query["b"])
    return dict(out, **(flip or {"position": None}))


def gateway_child(project, jdir, mode):
    """Phase 40's children: `roundtable gateway --port 0` through cli.main,
    `--journal DIR` (mode serve) or `--resume DIR` (mode resume). The
    second stops on SIGINT and prints its launch counts, and the first
    flips of the stream pairs the parent left in flip_queries.json beside
    the journal (resume_flip on the gateway's own engine)."""
    import os
    import torch
    from theroundtaible_tpu_torch import cli
    from theroundtaible_tpu_torch.engine import get_engine
    from theroundtaible_tpu_torch.engine.kernels import build
    register_child_model()
    build.build_all()
    os.chdir(project)
    cli.check_for_update = lambda cb: None
    flag = "--journal" if mode == "serve" else "--resume"
    config = json.loads(Path(".roundtable/config.json").read_text())
    engine = get_engine(config["adapter_config"]["torch-llm"], "cuda") \
        if mode == "resume" else None   # the CLI reuses it
    reset_launches()
    rc = cli.main(["gateway", "--port", "0", flag, str(jdir)])
    launches = launches_now()
    queries = Path(jdir).parent / "flip_queries.json"
    flips = ([resume_flip(torch, engine, q)
              for q in json.loads(queries.read_text())]
             if engine is not None and queries.exists() else None)
    print(json.dumps({"rc": rc, "launches": launches, "flips": flips}),
          flush=True)


class GatewayChild:
    """A gateway child process: its port from the listening line, every
    output line kept (with its arrival time) in a log."""

    def __init__(self, project, jdir, mode, timeout_s: float = 300.0):
        import re
        self.lines = []
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            child_cmd("gateway_child", project, jdir, mode),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT)
        self.reader = threading.Thread(target=self._drain, daemon=True)
        self.reader.start()
        pattern = re.compile(r"Gateway listening on http://[\d.]+:(\d+)")
        self.port = None
        deadline = time.monotonic() + timeout_s
        while self.port is None and time.monotonic() < deadline \
                and (self.proc.poll() is None or self.reader.is_alive()):
            for _t, line in list(self.lines):
                m = pattern.search(line)
                if m:
                    self.port = int(m.group(1))
            time.sleep(0.05)
        if self.port is None:
            self.proc.kill()
            self.proc.wait(60)
            raise Failed(f"gateway child ({mode}) never listened: "
                         + self.log()[-4000:])

    def _drain(self):
        for line in self.proc.stdout:
            self.lines.append((time.monotonic() - self.t0, line))

    def at(self, text):
        return next((t for t, ln in self.lines if text in ln), None)

    def log(self) -> str:
        return "".join(ln for _t, ln in self.lines)


def gateway_resume_phase(torch):
    """Phase 40 (module docstring). Returns the resumed child's launches."""
    import os
    import shutil
    import signal
    import tempfile
    from theroundtaible_tpu_torch.engine.session_journal import \
        SessionJournal
    card = nvidia_smi()
    work = Path(tempfile.mkdtemp(prefix="gateway-resume-", dir=OUT))
    project, jdir = work / "project", work / "journal"
    journal_project(project, max_rounds=1)
    prompts = knight_prompts(1)
    clients = [(f"c{i}", k, p) for i, (k, p) in enumerate(prompts.items())]
    child = GatewayChild(project, jdir, "serve")
    live, refs, killed_at = {}, {}, None
    try:
        for name, knight, prompt in clients:
            read = StreamRead(SseClient(
                child.port, "POST", "/v1/discussions",
                {"session": f"ref-{name}", "max_new_tokens": GATEWAY_MAX_NEW,
                 "turns": [{"knight": knight, "prompt": prompt}]}))
            check(read.terminal is not None
                  and read.terminal["type"] == "retired",
                  f"gateway_resume: ref-{name} ended {read.terminal}")
            refs[name] = read.rows(1)[0]
        # Three live streams: c1 and c2 join c0's decode through ragged
        # dispatches (K3).
        conns = {name: SseClient(child.port, "POST", "/v1/discussions",
                                 {"session": name,
                                  "max_new_tokens": GATEWAY_MAX_NEW,
                                  "turns": [{"knight": knight,
                                             "prompt": prompt}]})
                 for name, knight, prompt in clients}
        for name, c in conns.items():
            live[name] = StreamRead(c, drop_after=1)
        os.kill(child.proc.pid, signal.SIGKILL)
        killed_at = time.monotonic() - child.t0
    finally:
        if child.proc.poll() is None and killed_at is None:
            child.proc.kill()
        child.proc.wait(60)
        (OUT / "gateway_serve.log").write_text(child.log())
    check(child.proc.returncode == -signal.SIGKILL,
          f"gateway_resume: the serving child ended rc "
          f"{child.proc.returncode}")
    journal = SessionJournal(jdir)
    committed = {name: journal.last_turn(name) is not None
                 for name, _k, _p in clients}
    t_start = time.monotonic()
    child2 = GatewayChild(project, jdir, "resume")
    rest, errors, refused = {}, {}, {}
    try:
        # Every client reconnects at once, as after a real crash: the
        # regenerated turns join one another. A regeneration that left
        # the tokens a client holds is refused (409), never spliced.
        def reconnect(name):
            try:
                read = live[name]
                c = SseClient(
                    child2.port, "GET", f"/v1/streams/{read.meta['stream']}",
                    headers={"Last-Event-ID": read.tokens[-1][0]})
                if c.status == 409:
                    refused[name] = c.json().get("reason")
                    c.close()
                    return
                rest[name] = StreamRead(c)
            except Exception as e:  # noqa: BLE001 - checked below
                errors[name] = repr(e)
        threads = [threading.Thread(target=reconnect, args=(name,))
                   for name, _k, _p in clients]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        check(not errors and len(rest) + len(refused) == len(clients),
              f"gateway_resume: reconnects failed: {errors}")
        # What the resumed gateway generated (or replayed) for each turn
        # it streamed on, from its journal, and the stream pairs whose
        # first flips the child measures on its engine before it exits.
        journal = SessionJournal(jdir)
        served, queries = {}, []
        for name, _k, _p in clients:
            if name in refused:
                continue
            row = journal.turns(name)[-1]["rows"][0]
            served[name] = [int(t) for t in row["produced"]]
            w = len(live[name].rows(1)[0])
            queries += [
                {"client": name, "pair": "served_vs_reference",
                 "prompt": row["prompt_tokens"], "a": served[name],
                 "b": refs[name]},
                {"client": name, "pair": "streamed_vs_served",
                 "prompt": row["prompt_tokens"],
                 "a": live[name].rows(1)[0], "b": served[name][:w]}]
        (work / "flip_queries.json").write_text(json.dumps(queries))
        child2.proc.send_signal(signal.SIGINT)
        child2.proc.wait(120)
    finally:
        if child2.proc.poll() is None:
            child2.proc.kill()
            child2.proc.wait(60)
        child2.reader.join(30)
        (OUT / "gateway_resume.log").write_text(child2.log())
    lines = [ln for _t, ln in child2.lines if ln.startswith("{")]
    res = json.loads(lines[-1]) if lines else {}
    resuming, replayed = (child2.at("Resuming sessions"),
                          child2.at("replayed "))
    first_event_s = min((r.tokens[0][2] - t_start for r in rest.values()
                         if r.tokens), default=None)
    results = {}
    for name, _k, _p in clients:
        before = live[name].rows(1)[0]
        w = len(before)
        if name in refused:
            results[name] = {"before_kill": w,
                             "committed_at_kill": committed[name],
                             "refused": refused[name], "spliced": False}
            continue
        after = rest[name].rows(1)[0]
        results[name] = {
            "before_kill": w, "after_reconnect": len(after),
            "committed_at_kill": committed[name],
            # the client's stream against what the server generated
            "rest_is_served_tail": after == served[name][w:],
            "spliced": before != served[name][:w],
            "served_equals_reference": served[name] == refs[name],
            "stitched_equals_reference": before + after == refs[name]}
    flips = [f for f in res.get("flips") or [] if f["position"] is not None]
    spliced = sum(r["spliced"] for r in results.values())
    emit("gateway_resume", card=card, layers=CHILD_LAYERS,
         killed_after_s=killed_at, clients=results, flips=flips,
         spliced=spliced, refused_409=len(refused),
         replay_s=(replayed - resuming
                   if resuming is not None and replayed is not None
                   else None),
         child_start_to_listening_s=child2.at("Gateway listening"),
         child_start_to_first_reconnected_event_s=first_event_s,
         rc=res.get("rc"), launches=res.get("launches"))
    check(all(r.get("rest_is_served_tail", True)
              for r in results.values()),
          f"gateway_resume: a resumed stream lost or doubled tokens of the "
          f"turn its gateway served: {results}")
    # No client gets another generation spliced onto what it holds;
    # every divergence the regeneration met is a 409.
    check(spliced == 0, f"gateway_resume: {spliced} stream(s) spliced: "
          f"{results}")
    check(all(r == "nondeterministic_stream" for r in refused.values()),
          f"gateway_resume: refusals {refused}")
    check(all(rest[n].terminal is not None
              and rest[n].terminal["type"] == "retired" for n in rest),
          "gateway_resume: a reconnected stream did not retire")
    check(not all(committed.values()),
          f"gateway_resume: every turn had committed before the kill "
          f"({committed}): no stream was resumed by regeneration")
    check(res.get("rc") == 0 and res.get("flips") is not None,
          f"gateway_resume: the resumed child rc {res.get('rc')}: "
          f"{child2.log()[-2000:]}")
    # Greedy parity, the journal_resume rule: the served turn may leave
    # the uninterrupted run's only at a near tie (a regenerated turn runs
    # other kernels at other shapes than the first run: K3 joins, K2
    # prologues); a regeneration that leaves the tokens the client holds
    # is refused above, never spliced.
    check(all(f["margin"] < PATH_TOL for f in flips),
          f"gateway_resume: a stream left greedy parity away from a near "
          f"tie: {flips}")
    check(res["launches"]["paged_decode_attention"] > 0
          and res["launches"]["paged_prefill_attention"]
          + res["launches"]["ragged_paged_attention"] > 0,
          f"gateway_resume: launches {res['launches']}")
    shutil.rmtree(work, ignore_errors=True)
    return res["launches"]


# --- the session router and the load generator (phases 41-44) ---


ROUTER_MAX_NEW = 32
# A stream's first token event carries the prefill's token and the first
# decode segment's (DECODE_SEGMENT, 64): at 96 the turn still dispatches
# after it, so a client holds tokens when its replica dies.
FAILOVER_MAX_NEW = 96
FAILOVER_HOLD_S = 0.25
LOADGEN_RATE = 8.0          # sessions/s offered to the two-replica gateway
LOADGEN_DURATION_S = 3.0
LOADGEN_MAX_NEW = 16


# The router fleet's depth (32 layers before phases 51-54 joined): its
# checks compare replicas with each other and with the same fleet's
# reference streams, never across depths.
ROUTER_LAYERS = 16


def router_fleet(torch):
    """The fleet of phases 41-44: ENGINE_CONFIG at ROUTER_LAYERS layers with
    the offload tier on,
    from InferenceEngine.from_config (the rebuild recipe), then
    build_replicas(engine, 2) with one shared journal behind a
    SessionRouter made the active router. r1 redraws the weights from the
    recipe's seed: every leaf must be torch.equal to r0's and a 256-token
    forward's logits equal bit for bit. Returns (router, journal dir)."""
    import tempfile
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.session_journal import \
        SessionJournal
    from theroundtaible_tpu_torch.router import (SessionRouter,
                                                 build_replicas,
                                                 set_active_router)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    engine = InferenceEngine.from_config(dict(
        ENGINE_CONFIG, model=register_depth(ENGINE_CONFIG["model"],
                                            ROUTER_LAYERS),
        kv_offload=True))
    jdir = Path(tempfile.mkdtemp(prefix="router-", dir=OUT))
    journal = SessionJournal(jdir)
    replicas = build_replicas(engine, 2, journal=journal)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    router = SessionRouter(replicas, journal=journal)
    set_active_router(router)
    e0, e1 = (r.engine for r in replicas)
    a, b = dict(tree_leaves(e0.params)), dict(tree_leaves(e1.params))
    unequal = sorted(set(a) ^ set(b)) + [
        p for p in a if p in b and not (
            torch.is_tensor(a[p]) and torch.is_tensor(b[p])
            and torch.equal(a[p], b[p]))]
    tokens = e0.tokenizer.encode(knight_prompts(1)["lancelot"])[:256]
    logits_equal = torch.equal(next_token_logits(e0, tokens),
                               next_token_logits(e1, tokens))
    emit("router_fleet", card=nvidia_smi(), replicas=[r.name for r in
                                                      replicas],
         layers=e0.cfg.num_layers, num_pages=e0.kv.num_pages,
         build_s=build_s, leaves=len(a), unequal_leaves=unequal[:8],
         logits_256_equal=logits_equal,
         fleet_bytes=torch.cuda.memory_allocated() - m0,
         card_total_bytes=torch.cuda.get_device_properties(0).total_memory)
    check(not unequal, f"router_fleet: r1's tree differs from r0's at "
          f"{unequal[:8]}")
    check(logits_equal, "router_fleet: a 256-token forward's logits differ "
          "between r0 and r1")
    return router, jdir


def generated_tokens(engine, session, prompts) -> dict:
    """Each knight's generated tokens of its last turn in `session`."""
    from theroundtaible_tpu_torch.engine.kvcache import scoped_slot
    return {k: engine.kv._slots[scoped_slot(session, k)].tokens[
        len(engine.tokenizer.encode(p)):] for k, p in prompts}


def router_handoff_phase(torch, router):
    """Phase 41 (module docstring). Returns its launch counts."""
    from theroundtaible_tpu_torch.engine.kvcache import session_of
    from theroundtaible_tpu_torch.router import boundary_crossings
    card = nvidia_smi()
    link = pcie_link(torch)
    r0, r1 = router.replicas
    p1 = list(knight_prompts(1).items())
    p2 = list(knight_prompts(2, dict(p1)).items())
    crossings = boundary_crossings()
    reset_launches()
    # A and its unmigrated copy on r0 (migrate with no source: an
    # assignment)
    for session in ("A", "A-ref"):
        router.migrate(session, dst="r0")
        router.scheduler_for(session).submit(
            session, p1, max_new_tokens=ROUTER_MAX_NEW, timeout_s=600)
    kv0 = r0.engine.kv
    names = sorted(n for n in kv0.slot_names() if session_of(n) == "A")
    with r0.engine._serve_lock:
        committed = {n: len(kv0._slots[n].tokens) for n in names}
        snap = snapshot_pages(torch, kv0, page_ids_of(kv0, {"A"}))
    scores = {"before": {r.name: router.load_score(r)
                         for r in router.replicas}}
    # The evacuate's spill on r0 and the restore on r1 (at A's next
    # dispatch there), each timed with the card synchronised at its ends;
    # A's pages checked right after the restore, before the turn writes.
    log, restored = [], {}

    def check_restore(session):
        if session == "A":
            kv1 = r1.engine.kv
            restored["names"] = sorted(
                n for n in kv1.slot_names() if session_of(n) == "A")
            restored["equal"] = (restored["names"] == names and same_pages(
                torch, kv1, page_ids_of(kv1, {"A"}), snap))
    timed_tier(torch, r0.tier, log)
    timed_tier(torch, r1.tier, log, check_restore)
    try:
        t0 = time.monotonic()
        router.migrate("A", dst="r1")
        migrate_s = time.monotonic() - t0
        crossed = {"r1_holds": r1.tier.has("A"),
                   "r0_holds": r0.tier.has("A")}
        scores["after"] = {r.name: router.load_score(r)
                           for r in router.replicas}
        sched = router.scheduler_for("A")
        a2 = sched.submit("A", p2, max_new_tokens=ROUTER_MAX_NEW,
                          timeout_s=600)[1]
    finally:
        for tier in (r0.tier, r1.tier):
            del tier.spill_session, tier.restore_session
    router.scheduler_for("A-ref").submit(
        "A-ref", p2, max_new_tokens=ROUTER_MAX_NEW, timeout_s=600)
    got = generated_tokens(r1.engine, "A", p2)
    ref = generated_tokens(r0.engine, "A-ref", p2)
    flips = {}
    for k, p in p2:
        f = near_tie(torch, r0.engine, r0.engine.tokenizer.encode(p),
                     got[k], ref[k])
        if f is not None:
            flips[k] = f
    # A session in flight refuses to migrate.
    router.migrate("busy", dst="r0")
    req = r0.scheduler.submit_async("busy", p1[:1], max_new_tokens=96,
                                    timeout_s=600)
    wait_for(lambda: r0.snapshot_sessions().get("busy", "").startswith(
        ("queued", "active")) or req.event.is_set(), 60, "busy's turn")
    refusal = None
    try:
        router.migrate("busy", dst="r1")
    except RuntimeError as e:
        refusal = str(e)
    r0.scheduler.wait(req)
    torch.cuda.synchronize()
    launches = launches_now()
    min_reuse = sum(committed.values()) - len(names) * kv0.page_size
    emit("router_handoff", card=card, layers=r0.engine.cfg.num_layers,
         migrate_s=migrate_s, committed_tokens=committed,
         reused_tokens=a2.reused_tokens, min_reuse=min_reuse,
         pages_restored_equal=restored.get("equal"), crossed=crossed,
         tokens_equal={k: got[k] == ref[k] for k in got}, flips=flips,
         margin_tolerance=PATH_TOL, inflight_refusal=refusal,
         boundary_crossings=boundary_crossings() - crossings,
         load_score=scores, pcie=link, transfers=transfer_rates(log, link),
         migrations=router.migrations, launches={
             n: c for n, c in launches.items() if c})
    check(crossed == {"r1_holds": True, "r0_holds": False},
          f"router_handoff: A's record did not cross to r1: {crossed}")
    check(sched is r1.scheduler, "router_handoff: A is not routed to r1")
    check(restored.get("equal") is True,
          f"router_handoff: A's pages on r1 differ from r0's snapshot "
          f"({restored})")
    check(a2.reused_tokens >= min_reuse,
          f"router_handoff: A's round 2 reused {a2.reused_tokens} < "
          f"{min_reuse}")
    check(all(f["margin"] < PATH_TOL for f in flips.values()),
          f"router_handoff: round 2 on r1 left the unmigrated run away "
          f"from a near tie: {flips}")
    check(refusal is not None and "in-flight" in refusal,
          f"router_handoff: migrating a session in flight: {refusal}")
    check(boundary_crossings() - crossings == 1,
          "router_handoff: the migration crossed no replica boundary")
    check(all(launches[k] > 0 for k in PAGED_KERNELS[:2]),
          f"router_handoff: K1/K2 never launched: {launches}")
    return launches


def roll_clients() -> list:
    """(session, knight, prompt) of the three one-knight streams."""
    return [(f"roll-c{i}", k, p)
            for i, (k, p) in enumerate(knight_prompts(1).items())]


def router_roll_phase(torch, router, gw):
    """Phase 42 (module docstring). Returns its launch counts."""
    from theroundtaible_tpu_torch.utils import telemetry
    card = nvidia_smi()
    port = gw.port
    counts = Counter(router._assign.values())
    target = max(router.replicas, key=lambda r: counts[r.name])
    old_engine = target.engine
    reset_launches()
    # Three streams in flight; each client drops its socket after its
    # first token event and reconnects once the roll returned.
    first, errors = {}, {}

    def client(session, knight, prompt):
        try:
            first[session] = StreamRead(SseClient(
                port, "POST", "/v1/discussions",
                {"session": session, "max_new_tokens": GATEWAY_MAX_NEW,
                 "turns": [{"knight": knight, "prompt": prompt}]}),
                drop_after=1)
        except Exception as e:  # noqa: BLE001 - checked below
            errors[session] = repr(e)
    threads = [threading.Thread(target=client, args=c)
               for c in roll_clients()]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    check(not errors and len(first) == 3,
          f"router_roll: streams failed to open: {errors}")
    placed = {s: router._assign.get(s) for s, _k, _p in roll_clients()}
    # Every session of the rolled replica: 41's, and the streams' placed
    # there (the roll's quiesce lets their turns finish; then idle too).
    idle = sorted(s for s, n in router._assign.items() if n == target.name)
    # The roll's stages come from what the port records itself: the
    # router's `roll` span and its `migration` spans (telemetry armed for
    # the roll) and the supervisor's report in its flight dump.
    armed = telemetry.ACTIVE
    telemetry.arm()
    dump0 = telemetry.last_dump_path()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    try:
        t0 = time.monotonic()
        c = SseClient(port, "POST", "/v1/admin/roll",
                      {"replica": target.name})
        roll_status, rolled = c.status, c.json()
        c.close()
        roll_s = time.monotonic() - t0
    finally:
        if not armed:
            telemetry.disarm()
    dump = telemetry.last_dump_path()
    sup_report = (json.loads(Path(dump).read_text()).get("extra", {})
                  if dump and dump != dump0 else {})
    spans = telemetry.recorder().span_events()
    roll_span = next((sp for sp in reversed(spans) if sp["rung"] == "roll"
                      and sp.get("replica") == target.name), {})
    migrate_s = sum(sp["dur_s"] for sp in spans
                    if sp["rung"] == "migration"
                    and sp["parent_id"] == roll_span.get("span_id"))
    router_stages = {
        "roll_span": roll_span.get("dur_s"), "migrate_idle": migrate_s,
        "restart": sup_report.get("wall_s"),
        # admission closed, the in-flight turns' quiesce, the reopen
        "drain": (roll_span["dur_s"] - migrate_s - sup_report["wall_s"]
                  if roll_span and "wall_s" in sup_report else None)}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rest = {}
    for session, _k, _p in roll_clients():
        read = first[session]
        rest[session] = StreamRead(SseClient(
            port, "GET", f"/v1/streams/{read.meta['stream']}",
            headers={"Last-Event-ID": read.tokens[-1][0]}))
    streams = {}
    for session, _k, _p in roll_clients():
        before, after = first[session].rows(1)[0], rest[session].rows(1)[0]
        served = [int(t) for t in router.journal.turns(session)[-1][
            "rows"][0]["produced"]]
        streams[session] = {
            "replica": placed[session], "before_roll": len(before),
            "after_reconnect": len(after),
            "terminal": (rest[session].terminal or {}).get("type"),
            "equals_served": before + after == served}
    moved = {s: router._assign.get(s) for s in idle}
    cold = target.scheduler.submit(
        "roll-cold", [("lancelot", "A short council after the roll.")],
        max_new_tokens=8, timeout_s=600)[1].decode_tokens
    fleet_out = status_view("fleet", status_root())
    health_out = status_view("health", status_root())
    torch.cuda.synchronize()
    launches = launches_now()
    report = (rolled.get("rolled") or [{}])[0]
    emit("router_roll", card=card, layers=target.engine.cfg.num_layers,
         replica=target.name, idle_sessions=idle, moved_to=moved,
         placed=placed, http_status=roll_status, roll_s=roll_s,
         report=report, router_stage_s=router_stages,
         stage_s=sup_report.get("stage_s"),
         restart_wall_s=sup_report.get("wall_s"),
         peak_bytes_during_roll=peak, bytes_before_roll=m0,
         card_total_bytes=torch.cuda.get_device_properties(0).total_memory,
         streams=streams, rebuilt=target.engine is not old_engine,
         rolls=router.rolls, cold_round_decode_tokens=cold,
         launches={n: c for n, c in launches.items() if c})
    (OUT / "router_roll_status.txt").write_text(fleet_out + health_out)
    del old_engine
    check(roll_status == 200 and report.get("ok") is True,
          f"router_roll: POST /v1/admin/roll {roll_status}: {rolled}")
    check(roll_span and sup_report.get("reason") == "roll"
          and sup_report.get("stage_s"),
          f"router_roll: no roll span ({roll_span}) or supervisor report "
          f"({sup_report})")
    check(report.get("migrated") == len(idle) and idle and all(
        n != target.name for n in moved.values()),
          f"router_roll: {target.name}'s idle sessions {idle} did not all "
          f"migrate: {moved} ({report})")
    check(target.engine is not None and target.dead_reason() is None
          and target.scheduler.paused is None and cold > 0,
          f"router_roll: {target.name} did not rebuild and readmit")
    check(all(v["equals_served"] and v["terminal"] == "retired"
              for v in streams.values()),
          f"router_roll: a stream lost or doubled tokens across the roll: "
          f"{streams}")
    check(all(f"{r.name} [" in fleet_out for r in router.replicas)
          and "rolls=1" in fleet_out,
          f"router_roll: status --fleet: {fleet_out}")
    check(health_out.count("scheduler[") >= 2 and "roll: ok" in health_out,
          f"router_roll: status --health: {health_out}")
    check(all(launches[k] > 0 for k in PAGED_KERNELS[:2]),
          f"router_roll: K1/K2 never launched: {launches}")
    return launches


def stream_with_reconnect(port, body, attempts: int = 8,
                          first=None) -> dict:
    """One client of the failover: open the stream; on a failed terminal or
    a dropped socket, reconnect with the last token event's Last-Event-ID
    until it retires, or until a reconnect is refused with 409 (the
    regenerated turn left the tokens the client holds). Returns the tokens
    it held at its first failure, every token it received, its reconnects,
    the failure kinds met and the refusal's kind.
    `first` (an Event) is set at the first token event."""
    c = SseClient(port, "POST", "/v1/discussions", body)
    check(c.status == 200, f"router_failover: POST {c.status}")
    read = StreamRead(c, first=first)
    sid = read.meta["stream"]
    got = read.rows(1)[0]
    last = read.tokens[-1][0] if read.tokens else None
    held, kinds, terminal = None, [], read.terminal
    while terminal is None or terminal["type"] == "failed":
        if held is None:
            held = list(got)
        kinds.append((terminal or {}).get("kind"))
        check(len(kinds) <= attempts,
              f"router_failover: stream {sid} never recovered: {kinds}")
        time.sleep(0.5)
        c = SseClient(port, "GET", f"/v1/streams/{sid}",
                      headers={"Last-Event-ID": last} if last else None)
        if c.status == 409:
            # The regeneration left the tokens this client holds: refused,
            # never spliced. The client keeps what it holds.
            terminal = {"type": "refused", "kind": c.json().get("reason")}
            c.close()
            break
        if c.status != 200:
            terminal = {"type": "failed", "kind": f"http_{c.status}"}
            c.close()
            continue
        read = StreamRead(c)
        got += read.rows(1)[0]
        if read.tokens:
            last = read.tokens[-1][0]
        terminal = read.terminal
    return {"stream": sid, "held": got if held is None else held,
            "got": got, "reconnects": len(kinds), "kinds": kinds,
            "terminal": terminal["type"],
            "refusal": (terminal.get("kind")
                        if terminal["type"] == "refused" else None)}


def router_failover_phase(torch, router, gw):
    """Phase 43 (module docstring). Returns its launch counts."""
    from theroundtaible_tpu_torch.engine import faults
    from theroundtaible_tpu_torch.engine import supervisor as sup
    from theroundtaible_tpu_torch.utils import telemetry
    card = nvidia_smi()
    port = gw.port
    prompts = list(knight_prompts(1).items())

    def body(session, i):
        k, p = prompts[i]
        return {"session": session, "max_new_tokens": FAILOVER_MAX_NEW,
                "turns": [{"knight": k, "prompt": p}]}

    def concurrently(fn, n, during=None):
        out, errors = [None] * n, {}

        def run(i):
            try:
                out[i] = fn(i)
            except Exception as e:  # noqa: BLE001 - checked below
                errors[i] = repr(e)
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n)]
        for th in threads:
            th.start()
        if during is not None:
            during()
        for th in threads:
            th.join(600)
        check(not errors and all(x is not None for x in out),
              f"router_failover: clients failed: {errors}")
        return out
    # The fault-free reference: the same turns, served concurrently.
    refs = concurrently(lambda i: stream_with_reconnect(
        port, body(f"fo-ref{i}", i)), 3)
    before = {r.name: telemetry.REGISTRY.counter_total(
        "roundtable_router_failovers_total", replica=r.name)
        for r in router.replicas}
    failovers0 = router.failovers
    sup.set_supervisor(sup.EngineSupervisor(max_restarts=0))
    firsts = [threading.Event() for _ in range(3)]
    fired = {}

    def arm_once_every_client_holds_tokens():
        # Each dispatch waits FAILOVER_HOLD_S before its fault points, so
        # the device_lost armed here fires at the next dispatch of a
        # replica still serving a stream whose client holds tokens.
        for ev in firsts:
            check(ev.wait(300), "router_failover: a client never received "
                  "a token event")
        lost = faults.arm("device_lost", count=1)
        wait_for(lambda: lost.fired > 0, 300, "the device_lost fault")
        faults.disarm("slow_dispatch")
        fired["device_lost"] = lost.fired
    reset_launches()
    try:
        faults.arm("slow_dispatch", count=-1, delay_s=FAILOVER_HOLD_S)
        runs = concurrently(lambda i: stream_with_reconnect(
            port, body(f"fo-c{i}", i), first=firsts[i]), 3,
            during=arm_once_every_client_holds_tokens)
        faults.disarm()
        dead = [r for r in router.replicas if r.dead_reason() is not None]
        survivor = next(r for r in router.replicas if r not in dead)
        post = stream_with_reconnect(port, body("fo-post", 0))
        torch.cuda.synchronize()
        launches = launches_now()
        # read while the supervisor that marked the replica dead is live
        dead_reasons = {r.name: r.dead_reason() for r in dead}
        described = router.describe()
    finally:
        faults.disarm()
        sup.set_supervisor(None)
    clients = {}
    refused = [run for run in runs if run["terminal"] == "refused"]
    for i, run in enumerate(runs):
        session = f"fo-c{i}"
        # What the gateway served for the turn (a regenerated one: the
        # stream restored on the survivor).
        served = list(gw.streams[run["stream"]].history[0])
        prompt = survivor.engine.tokenizer.encode(prompts[i][1])
        held, ref = run["held"], refs[i]["got"]
        pairs = {}
        for pair, a, b in (("served_vs_reference", served, ref),
                           ("streamed_vs_served", held,
                            served[:len(held)])):
            f = near_tie(torch, survivor.engine, prompt, a, b)
            if f is not None:
                pairs[pair] = f
        clients[session] = {
            "replica": router._assign.get(session),
            "reconnects": run["reconnects"], "kinds": run["kinds"],
            "held_at_failure": len(held), "tokens": len(run["got"]),
            "refused": run["terminal"] == "refused",
            "rest_is_served_tail": (run["terminal"] == "refused"
                                    or run["got"][len(held):]
                                    == served[len(held):]),
            # a refused stream holds its first run's tokens and no more
            "spliced": (run["terminal"] != "refused"
                        and held != served[:len(held)]),
            "equals_reference": run["got"] == ref, "flips": pairs}
    moved = {r.name: telemetry.REGISTRY.counter_total(
        "roundtable_router_failovers_total", replica=r.name) - before[r.name]
        for r in router.replicas}
    flips = [f for c in clients.values() for f in c["flips"].values()
             if not c["refused"]]
    spliced = sum(c["spliced"] for c in clients.values())
    emit("router_failover", card=card, layers=survivor.engine.cfg.num_layers,
         spliced=spliced, refused_409=len(refused),
         refusal_flips={s: c["flips"] for s, c in clients.items()
                        if c["refused"]},
         dead=dead_reasons,
         survivor=survivor.name, failovers=router.failovers - failovers0,
         device_lost_fired=fired.get("device_lost"),
         hold_s=FAILOVER_HOLD_S,
         failovers_total_moved=moved, clients=clients,
         margin_tolerance=PATH_TOL, post_failover=post["terminal"],
         describe=described,
         launches={n: c for n, c in launches.items() if c})
    check(fired.get("device_lost") == 1 and len(dead) == 1,
          f"router_failover: device_lost fired {fired}, {len(dead)} dead "
          f"replicas")
    check(router.failovers - failovers0 >= 1 and moved[dead[0].name] >= 1,
          f"router_failover: failovers {router.failovers - failovers0}, "
          f"the counter moved {moved}")
    check(any(c["reconnects"] for c in clients.values()),
          "router_failover: no stream crossed the replica failure")
    check(any(c["reconnects"] and c["held_at_failure"]
              for c in clients.values()),
          f"router_failover: no client held tokens when its replica died: "
          f"{clients}")
    check(all(c["rest_is_served_tail"] for c in clients.values()),
          f"router_failover: a stream lost or doubled tokens: {clients}")
    # No splice: every divergence met is a 409 nondeterministic_stream
    check(spliced == 0, f"router_failover: {spliced} stream(s) spliced: "
          f"{clients}")
    check(all(r["refusal"] == "nondeterministic_stream" for r in refused),
          f"router_failover: refusals {refused}")
    check(all(f["margin"] < PATH_TOL for f in flips),
          f"router_failover: a stream left greedy parity away from a near "
          f"tie: {flips}")
    check(post["terminal"] == "retired" and post["reconnects"] == 0,
          f"router_failover: the survivor did not admit: {post}")
    check(launches["paged_decode_attention"] > 0
          and launches["paged_prefill_attention"]
          + launches["ragged_paged_attention"] > 0,
          f"router_failover: launches {launches}")
    return launches


def loadgen_phase(torch, gw):
    """Phase 44 (module docstring). Returns the launch counts of the smoke
    and of the gateway point."""
    import shutil
    import tempfile
    from theroundtaible_tpu_torch.loadgen import (GatewayDriver,
                                                  PoissonArrivals,
                                                  WorkloadMix, bench,
                                                  open_loop_peak,
                                                  reset_test_counters,
                                                  run_point,
                                                  validate_record)
    from theroundtaible_tpu_torch.utils import telemetry
    card = nvidia_smi()
    scratch = Path(tempfile.mkdtemp(prefix="loadgen-", dir=OUT))
    records, run_capacity = [], bench.run_capacity

    def kept(**kw):
        records.append(run_capacity(**kw))
        return records[-1]
    armed = telemetry.ACTIVE
    bench.run_capacity = kept
    try:
        rc, out, wall, smoke_launches = run_cli(torch, scratch,
                                                ["loadgen", "--smoke"])
    finally:
        bench.run_capacity = run_capacity
        if not armed:     # the bench arms telemetry; later phases run bare
            telemetry.disarm()
    written = sorted(p.name for p in scratch.iterdir())
    (OUT / "loadgen.log").write_text(out)
    check(records, f"loadgen: the smoke produced no record (rc {rc}): "
          f"{out[-2000:]}")
    detail = records[0]["detail"]
    frontier = detail["frontier"]
    problems = validate_record(frontier)
    # One open-loop Poisson point against the two-replica gateway.
    reset_test_counters()
    mix = WorkloadMix(max_new_tokens=LOADGEN_MAX_NEW, max_turns=1)
    reset_launches()
    point = run_point(GatewayDriver(gw.port), PoissonArrivals(SEED), mix,
                      rate_rps=LOADGEN_RATE, duration_s=LOADGEN_DURATION_S,
                      seed=SEED, n_devices=torch.cuda.device_count())
    torch.cuda.synchronize()
    point_launches = launches_now()
    peak = open_loop_peak()
    emit("loadgen", card=card, smoke_rc=rc, smoke_wall_s=wall,
         written=written, acceptance=detail["acceptance"],
         platform=detail["platform"],
         cpu_wall_caveat=detail["cpu_wall_caveat"],
         chip=frontier.get("chip"), predicted=frontier.get("predicted"),
         frontier=[{k: p.get(k) for k in (
             "offered_rps", "arrivals", "admitted", "shed", "shed_rate",
             "ttft_p95_s", "accepted_tok_s")} for p in frontier["points"]],
         knee=frontier["knee"], thresholds=frontier["derived_thresholds"],
         record_problems=problems,
         smoke_launches={n: c for n, c in smoke_launches.items() if c},
         gateway_point={k: point[k] for k in (
             "offered_rps", "arrivals", "admitted", "completed", "failed",
             "abandoned", "shed", "shed_reasons", "ttft_p50_s",
             "ttft_p95_s", "accepted_tok_s", "peak_concurrent_sessions",
             "wall_s")}, open_loop_peak=peak,
         point_launches={n: c for n, c in point_launches.items() if c})
    shutil.rmtree(scratch, ignore_errors=True)
    acc = detail["acceptance"]
    check(rc == 0 and acc["meets"] and acc["points"] >= 4
          and acc["shed_point_reached"],
          f"loadgen: --smoke rc {rc}, acceptance {acc}")
    check(not problems, f"loadgen: the frontier is not valid: {problems}")
    check((frontier.get("chip") or {}).get("name") == "h100"
          and detail["platform"] == "cuda" and not detail["cpu_wall_caveat"],
          f"loadgen: chip {frontier.get('chip')}, platform "
          f"{detail['platform']}")
    check(written == [], f"loadgen: --smoke wrote {written}")
    check(peak >= 2, f"loadgen: open-loop peak {peak} sessions in flight")
    check(point["failed"] == 0 and point["abandoned"] == 0
          and point["completed"] + point["shed"] == point["arrivals"]
          and point["completed"] > 0,
          f"loadgen: the gateway point's sessions: {point}")
    counts = dict(smoke_launches)
    for name, n in point_launches.items():
        counts[name] = counts.get(name, 0) + n
    return counts


def router_phases(torch) -> dict:
    """Phases 41-44 on one two-replica fleet: the handoff, the roll behind
    a Gateway(router=...), the load generator (before the failover, so its
    gateway point meets both replicas live), then the failover. The fleet
    is released at the end. Returns each phase's launch counts."""
    from theroundtaible_tpu_torch.gateway import Gateway
    from theroundtaible_tpu_torch.router import set_active_router
    router, jdir = router_fleet(torch)
    gw = None
    try:
        out = {"router_handoff": router_handoff_phase(torch, router)}
        gw = Gateway(router.replicas[0].scheduler, port=0,
                     intent_dir=str(jdir), router=router)
        gw.start_in_thread()
        out["router_roll"] = router_roll_phase(torch, router, gw)
        out["loadgen"] = loadgen_phase(torch, gw)
        out["router_failover"] = router_failover_phase(torch, router, gw)
    finally:
        if gw is not None:
            gw.stop()
        router.close()
        for rep in router.replicas:
            if getattr(rep, "owned_scheduler", False):
                rep.scheduler.close()
        set_active_router(None)
        del router, gw
        gc.collect()
        torch.cuda.empty_cache()
    return out


# --- MoE (Mixtral) and float16 (phases 45-50) ---
#
# 45 moe_engine: Mixtral-8x7B at full width cut to MOE_LAYERS layers, a
#    paged round (K2, K1), a contiguous round (K8, K9) and the scheduler's
#    ragged join (K3); greedy tokens against the plain path on the card,
#    each divergence a near tie of the tokens or of the router.
# 46 moe_quant: int8 and int4 experts at MOE_QUANT_LAYERS layers; K5 from
#    the expert down product, timed at its shape; the forward over the
#    quantized tree against the one over the dequantized tree.
# 47 moe_tp: 2 gloo ranks sharing the card, experts split over them (EP),
#    logits against one device; int4 experts' down through K10e.
# 48 moe_checkpoint: a 2-layer Mixtral written in the HF block_sparse_moe
#    layout, loaded back bit for bit, one round served from it.
# 49 f16_kernels: every kernel at f16 against its plain version, timed
#    beside SDPA or torch.matmul at f16.
# 50 f16_engine: Llama-3-8B width at F16_LAYERS layers in float16: paged
#    and contiguous rounds, the scheduler's join, int4 weights with int8
#    pages and a LoRA persona; greedy tokens against the plain path.

MOE_MODEL = "mixtral-8x7b-instruct"
MOE_LAYERS = 4
MOE_QUANT_LAYERS = 8
MOE_TP_LAYERS = 2
MOE_CKPT_LAYERS = 2
F16_MODEL = "llama-3-8b-instruct"
F16_LAYERS = 8


def register_depth(base: str, layers: int) -> str:
    """`base` cut to `layers` layers, registered as "<base>-<layers>l"."""
    from theroundtaible_tpu_torch.engine.models import registry
    name = f"{base}-{layers}l"
    registry.register(dataclasses.replace(
        registry.get_model_config(base), name=name, num_layers=layers))
    return name


def depth_config(base: str, layers: int, **over) -> dict:
    """ENGINE_CONFIG on `base` cut to `layers` layers, every knight
    greedy."""
    config = {k: v for k, v in ENGINE_CONFIG.items()
              if k != "knight_sampling"}
    config.update(model=register_depth(base, layers), **over)
    return config


class RouteLog:
    """Records every router decision models/common.route makes while it is
    entered: per call (one per MoE layer and forward), the top-k expert
    sets [..., k] (sorted) and the margin between the k-th and (k+1)-th
    router logits."""

    def __init__(self, torch):
        self.torch = torch
        self.calls: list = []

    def __enter__(self):
        from theroundtaible_tpu_torch.engine.models import common
        self._orig = orig = common.route
        torch = self.torch

        def route(logits, cfg):
            k = cfg.num_experts_per_tok
            top = torch.topk(logits.float(), k + 1, dim=-1)
            self.calls.append(
                (torch.sort(top.indices[..., :k], dim=-1).values,
                 top.values[..., k - 1] - top.values[..., k]))
            return orig(logits, cfg)

        common.route = route
        return self

    def __exit__(self, *exc):
        from theroundtaible_tpu_torch.engine.models import common
        common.route = self._orig
        return False


def router_flips(torch, kernel_log, plain_log, rows) -> list:
    """Every (call, row, position) whose top-k set differs between two
    RouteLogs of the same forwards, with the plain path's router margin
    there; `rows[b]` positions of row b count in each call's last axis
    (the rest are pad rows)."""
    flips = []
    for c, ((ki, _km), (pi, pm)) in enumerate(zip(kernel_log.calls,
                                                  plain_log.calls)):
        for b in range(ki.shape[0]):
            n = min(rows[b], ki.shape[1])
            diff = (ki[b, :n] != pi[b, :n]).any(-1)
            for t in diff.nonzero().flatten().tolist():
                flips.append({"call": c, "row": b, "position": t,
                              "margin": float(pm[b, t])})
    return flips


def compare_unflipped(torch, got, ref, flips, layers: int, T: int):
    """(max |got - ref|, within PATH_TOL, rows compared) over the logits of
    a prefill of T positions ([B, V] at its last position) and of the
    decode steps after it, leaving out each (step, row) a router flip
    (router_flips of the same forwards, one route call per layer and
    forward) can reach: a flip in an earlier layer at or before that
    step, or one in the last layer at exactly the compared position."""
    hit = set()
    for f in flips:
        step, layer = divmod(f["call"], layers)
        if layer < layers - 1:
            hit.update((j, f["row"]) for j in range(step, len(got)))
        elif f["position"] == (T - 1 if step == 0 else 0):
            hit.add((step, f["row"]))
    worst, ok, compared = 0.0, True, 0
    for j, (a, b) in enumerate(zip(got, ref)):
        keep = [r for r in range(a.shape[0]) if (j, r) not in hit]
        if not keep:
            continue
        diff = (a[keep] - b[keep]).abs()
        worst = max(worst, float(diff.max()))
        ok = ok and bool((diff <= PATH_TOL + PATH_TOL * b[keep].abs()).all())
        compared += len(keep)
    return worst, ok, compared


def paged_steps(torch, params, cfg, prompts, steps, dtype, plain=False,
                mesh=None, forced=None):
    """forward_paged on pools of its own: one prefill of `prompts` (token
    lists, right-padded), then `steps` decode steps of each row's greedy
    token or of `forced[step]` ([B]), through the kernels or (`plain`)
    their plain versions, under `mesh` on this rank's kv heads. Returns
    (the f32 logits [B, V] at the prefill's last position and after each
    step, the run's RouteLog)."""
    from theroundtaible_tpu_torch.engine.paged_forward import forward_paged
    dev = torch.device("cuda")
    B, ps = len(prompts), 128
    T = max(len(p) for p in prompts)
    pp = -(-(T + steps + 1) // ps)
    kv = (cfg.num_kv_heads if mesh is None
          else mesh.local(cfg.num_kv_heads))
    shape = (1 + B * pp, ps, kv, cfg.head_dim)
    pools = [(torch.zeros(shape, dtype=dtype, device=dev),
              torch.zeros(shape, dtype=dtype, device=dev))
             for _ in range(cfg.num_layers)]
    table = (torch.arange(B * pp, device=dev) + 1).reshape(B, pp).to(
        torch.int32)
    tokens = torch.zeros(B, T, dtype=torch.long, device=dev)
    for b, p in enumerate(prompts):
        tokens[b, :len(p)] = torch.as_tensor(p, device=dev)
    valid = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                         device=dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev).expand(
        B, T).contiguous()
    log, out = RouteLog(torch), []
    with log:
        out.append(forward_paged(params, cfg, tokens, positions, pools,
                                 table, valid, last_pos=valid - 1,
                                 plain=plain, mesh=mesh)[:, 0].float())
        for step in range(steps):
            cur = forced[step] if forced is not None else out[-1].argmax(-1)
            out.append(forward_paged(params, cfg, cur[:, None],
                                     valid[:, None], pools, table, valid + 1,
                                     plain=plain, mesh=mesh)[:, 0].float())
            valid = valid + 1
    return out, log


def greedy_against_plain(torch, engine, phase, generated, knights):
    """The engine's greedy round-1 tokens of `knights` against greedy
    decoding on the plain path over the same weights. Each row that
    diverges must do so at a near tie: its first differing position's
    top-2 margin of the plain logits below PATH_TOL ("token"), or (MoE)
    a router decision before it that flipped between the kernels and the
    plain path at a router margin below PATH_TOL ("router"). Returns the
    report."""
    prompts = knight_prompts(1)
    rows = [engine.tokenizer.encode(prompts[k]) for k in knights]
    steps = max(len(generated[1][k]) for k in knights)
    logits, _log = paged_steps(torch, engine.params, engine.cfg, rows,
                               steps, engine.dtype, plain=True)
    plain = [[int(lg[b].argmax()) for lg in logits[:steps]]
             for b in range(len(rows))]
    report = []
    for b, k in enumerate(knights):
        mine = generated[1][k]
        i = next((j for j, (x, y) in enumerate(zip(mine, plain[b]))
                  if x != y), None)
        if i is None:
            report.append({"knight": k, "agree": True})
            continue
        top = torch.topk(logits[i][b], 2)
        entry = {"knight": k, "agree": False, "position": i,
                 "engine_token": mine[i], "plain_token": plain[b][i],
                 "plain_top2": [int(x) for x in top.indices],
                 "margin": float(top.values[0] - top.values[1])}
        if entry["margin"] < PATH_TOL:
            entry["near_tie"] = "token"
        elif engine.cfg.num_experts:
            forced = [torch.tensor([t], device="cuda") for t in plain[b][:i]]
            logs = [paged_steps(torch, engine.params, engine.cfg, [rows[b]],
                                i, engine.dtype, plain=plain_path,
                                forced=forced)[1]
                    for plain_path in (False, True)]
            flips = router_flips(torch, *logs, [len(rows[b])])
            entry["router_flips"] = flips[:8]
            if flips and all(f["margin"] < PATH_TOL for f in flips):
                entry["near_tie"] = "router"
        report.append(entry)
        check("near_tie" in entry,
              f"{phase}: {k} left the plain path's greedy tokens at "
              f"position {i} without a near tie: {entry}")
    emit(f"{phase}_vs_plain", tolerance=PATH_TOL, rows=report)
    return report


def release(torch, engine=None):
    from theroundtaible_tpu_torch.engine import reset_engines
    reset_engines()
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def step_bound_ms(engine) -> tuple:
    """(bytes a decode step streams - every weight once, all experts of
    an expert-dense MoE among them -, their time at HBM_BYTES_PER_S)."""
    from theroundtaible_tpu_torch.utils.perfmodel import \
        streamed_param_bytes
    n = streamed_param_bytes(engine.params)
    return n, 1e3 * n / HBM_BYTES_PER_S


def moe_engine_phase(torch, kattn):
    """Phase 45 (above). Returns its launch counts."""
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    config = depth_config(MOE_MODEL, MOE_LAYERS)
    launches = {}
    for layout in ("paged", "contiguous"):
        cfg = dict(config)
        if layout == "contiguous":
            del cfg["kv_layout"]
        torch.cuda.reset_peak_memory_stats()
        adapter = TorchLlmAdapter.from_config(f"torch-llm-moe-{layout}", cfg)
        t0 = time.monotonic()
        engine = adapter._get_engine()
        torch.cuda.synchronize()
        construct_s = time.monotonic() - t0
        d = engine.describe()
        check(d["kv_layout"] == layout and engine.cfg.num_experts == 8,
              f"moe_engine built {d['kv_layout']}, {engine.cfg.num_experts} "
              f"experts")
        phase = "moe_round" if layout == "paged" else "moe_contiguous_round"
        required, forbidden = ((PAGED_KERNELS[:2], CONTIGUOUS_KERNELS)
                               if layout == "paged" else
                               (CONTIGUOUS_KERNELS, PAGED_KERNELS))
        totals, generated, stats = serve_rounds(
            torch, kattn, adapter, engine, phase, required=required,
            forbidden=forbidden)
        n_bytes, bound = step_bound_ms(engine)
        ms = [decode_ms_per_step(stats[r]) for r in (1, 2)]
        emit(f"{phase}_summary", layers=MOE_LAYERS, params=engine.num_params,
             construct_s=construct_s,
             weight_bytes=n_bytes, decode_ms_per_step=ms,
             step_bytes=n_bytes, step_bound_ms=bound,
             bound_share=[bound / m for m in ms],
             prefill_s=[stats[r]["prefill_seconds"] for r in (1, 2)],
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             launches=totals)
        greedy_against_plain(torch, engine, phase, generated,
                             GREEDY_KNIGHTS)
        for k, n in totals.items():
            launches[k] = launches.get(k, 0) + n
        if layout == "paged":
            sched = scheduler_phase(torch, kattn, engine,
                                    phase="moe_scheduler")
            for k, n in sched.items():
                launches[k] = launches.get(k, 0) + n
        release(torch, engine)
        del adapter
    return launches


def f32_tree(torch, params, layers: int):
    """The first `layers` layers of a (quantized) tree with every float
    tensor, int8 scale and int4 scale widened to f32 (payloads kept, each
    Int4Leaf planned again for its f32 body): the same weights, computed
    in f32 by the same seams."""
    import dataclasses as dc
    from theroundtaible_tpu_torch.engine.kernels import int4mm
    from theroundtaible_tpu_torch.engine.models import common

    def wide(key, leaf):
        if isinstance(leaf, common.Int4Leaf):
            return int4mm.plan_leaf(common.LEAF_SPECS[key], dc.replace(
                leaf, s4=leaf.s4.float(), plan=None))
        if isinstance(leaf, dict) and "q" in leaf:
            return {"q": leaf["q"], "s": leaf["s"].float()}
        return leaf.float() if leaf.is_floating_point() else leaf

    out = {k: wide(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [common.nest_layer({k: wide(k, v) for k, v in
                                        common.flat_layer(layer).items()})
                     for layer in params["layers"][:layers]]
    return out


def dequantized_tree(torch, params, layers: int):
    """The first `layers` layers of a quantized tree with every int8 and
    int4 leaf dequantized to its scales' dtype (the JAX package's
    "mechanics exact" reference), the rest of the tree shared."""
    from theroundtaible_tpu_torch.engine import quant
    from theroundtaible_tpu_torch.engine.models import common

    def deq(key, leaf):
        if isinstance(leaf, common.Int4Leaf):
            return common.dequant_int4(leaf.q4, leaf.s4, leaf.axis,
                                       leaf.group, leaf.s4.dtype)
        if isinstance(leaf, dict) and "q" in leaf:
            keep = tuple(a % leaf["q"].dim() for a in quant._SCALE_AXES[key])
            s = leaf["s"]
            for a in range(leaf["q"].dim()):
                if a not in keep:
                    s = s.unsqueeze(a)
            return (leaf["q"].to(s.dtype) * s).to(s.dtype)
        return leaf

    out = {k: deq(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [common.nest_layer({k: deq(k, v) for k, v in
                                        common.flat_layer(layer).items()})
                     for layer in params["layers"][:layers]]
    return out


def k5_expert_case(torch, int4mm, common, gen, flush, cfg, rows, dtype):
    """K5 at the expert down shape: x [rows, X*F] against the packed
    [X*F, E] weight with scales per INT4_GROUP, against its plain version,
    timed beside torch.matmul on the weight dequantized beforehand."""
    dev = torch.device("cuda")
    c, n = cfg.num_experts * cfg.mlp_dim, cfg.embed_dim
    x = (torch.randn(rows, c, generator=gen, device=dev) * 0.05).to(dtype)
    q4, s4 = int4_weight(torch, gen, (c, n), dev, dtype)
    gp = INT4_GROUP // 2
    fn = lambda: int4mm.mm_pack_out(x, q4, s4, gp)  # noqa
    ref = lambda: int4mm.mm_pack_out_ref(x, q4, s4, gp)  # noqa
    err, ok = max_err(torch, fn(), ref())
    check(ok, f"K5 at the expert down shape ({rows} rows, {dtype}) "
              f"disagrees with its plain version by {err}")
    w = common.dequant_int4(q4, s4, 1, INT4_GROUP, dtype)
    lib = lambda: torch.matmul(x, w)  # noqa
    plan = int4mm.out_plan(rows, c, n // 2,
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count, dtype)
    t = {"x": [rows, c], "weight": [c, n], "dtype": str(dtype),
         "splits": plan.splits, "split_rows": plan.rows,
         "max_abs_err": err,
         "ms": time_ms(torch, fn, 30, flush),
         "plain_ms": time_ms(torch, ref, 2, flush),
         "library_ms": time_ms(torch, lib, 30, flush),
         "device_ms": device_ms(torch, fn, flush),
         "library_device_ms": device_ms(torch, lib, flush),
         "bytes": (q4.numel() + s4.numel() * s4.element_size()
                   + x.numel() * x.element_size() + rows * n * 4),
         "library_bytes": w.numel() * w.element_size(),
         "flops": 2 * rows * c * n}
    t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["flops"])
    del x, q4, s4, w
    return t


def moe_quant_phase(torch, kattn):
    """Phase 46 (above). Returns (launch counts per mode, K5's expert-down
    cases)."""
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    from theroundtaible_tpu_torch.engine.kernels import int4mm
    from theroundtaible_tpu_torch.engine.models import common
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 45)
    flush = torch.empty(16 << 20, dtype=torch.float32, device=dev)
    launches, cases = {}, {}
    for mode in ("int8", "int4"):
        config = depth_config(MOE_MODEL, MOE_QUANT_LAYERS, quant=mode)
        adapter = TorchLlmAdapter.from_config(f"torch-llm-moe-{mode}",
                                              config)
        t0 = time.monotonic()
        engine = adapter._get_engine()
        torch.cuda.synchronize()
        construct_s = time.monotonic() - t0
        check(engine.describe()["quant"] == mode,
              f"moe_quant built quant {engine.describe()['quant']}")
        cfg = engine.cfg
        expert_c = cfg.num_experts * cfg.mlp_dim
        by_width = Counter()
        orig = int4mm.mm_pack_out

        def counted(x, q4, s4, gp):
            by_width[int(x.shape[1])] += 1
            return orig(x, q4, s4, gp)

        int4mm.mm_pack_out = counted
        try:
            totals, generated, stats = serve_rounds(
                torch, kattn, adapter, engine, f"moe_quant_{mode}",
                required=PAGED_KERNELS[:2] + (INT4_KERNELS if mode == "int4"
                                              else ()),
                forbidden=CONTIGUOUS_KERNELS + (() if mode == "int4"
                                                else INT4_KERNELS))
        finally:
            int4mm.mm_pack_out = orig
        expert_down = by_width[expert_c]
        if mode == "int4":
            check(expert_down > 0,
                  f"moe_quant_int4: K5 never ran the expert down product: "
                  f"{dict(by_width)}")
            paths = engine.describe()["int4_paths"]
            declines = {(e["spec"], e["fallback_reason"])
                        for e in paths["xla_dequant"]}
            check(all(r == "rows:prefill-m"
                      or s == common.SPEC_EXPERT_UP for s, r in declines),
                  f"moe_quant_int4: a decode product left K5/K6: "
                  f"{declines}")
        # Mechanics exact (JAX tests/test_quant.py's contract, which holds
        # in f32): the first 2 layers' forward over the quantized tree with
        # its scales in f32 (K5's f32 body at the decode rows) against the
        # one over the same tree dequantized in f32 (f32 matmuls), one
        # 64-row chunk and 4 decode steps, teacher-forced; the logits a
        # router flip can reach are left out (compare_unflipped). (In bf16
        # the two differ by a rounding of each dequantized weight, which
        # the int8 seam never makes.)
        two = dataclasses.replace(cfg, num_layers=2)
        qtree = f32_tree(torch, engine.params, 2)
        dtree = dequantized_tree(torch, qtree, 2)
        B, T = 3, 64
        prompts = torch.randint(3, 259, (B, T), generator=gen,
                                device=dev).tolist()
        runs = {"quantized": paged_steps(torch, qtree, two, prompts, 4,
                                         torch.float32)}
        runs["dequantized"] = paged_steps(
            torch, dtree, two, prompts, 4, torch.float32,
            forced=[lg.argmax(-1) for lg in runs["quantized"][0][:4]])
        flips = router_flips(torch, runs["quantized"][1],
                             runs["dequantized"][1], [T] * B)
        worst, ok, compared = compare_unflipped(
            torch, runs["quantized"][0], runs["dequantized"][0], flips, 2, T)
        check(ok and compared > 0,
              f"moe_quant_{mode}: quantized and dequantized forwards "
              f"differ by {worst} ({compared} row-steps compared)")
        check(all(f["margin"] < PATH_TOL for f in flips),
              f"moe_quant_{mode}: a router flip at a margin above "
              f"{PATH_TOL}: {flips[:4]}")
        del dtree, qtree
        emit(f"moe_quant_{mode}_summary", layers=MOE_QUANT_LAYERS,
             params=engine.num_params, construct_s=construct_s,
             weight_bytes=step_bound_ms(engine)[0],
             step_bound_ms=step_bound_ms(engine)[1],
             decode_ms_per_step=[decode_ms_per_step(stats[r])
                                 for r in (1, 2)],
             prefill_s=[stats[r]["prefill_seconds"] for r in (1, 2)],
             k5_expert_down_launches=expert_down,
             k5_launches_by_width=dict(by_width),
             mechanics_max_abs_err=worst, mechanics_row_steps=compared,
             router_flips=flips[:8],
             tolerance=PATH_TOL, launches=totals)
        totals["mm_pack_out:expert_down"] = expert_down
        launches[mode] = totals
        release(torch, engine)
        del adapter
    cfg = get_model_config(MOE_MODEL)
    for rows in (1, 3):
        cases[rows] = k5_expert_case(torch, int4mm, common, gen, flush, cfg,
                                     rows, torch.bfloat16)
    emit("moe_k5_expert_down", cases=cases)
    return launches, cases


def _moe_tp_weights(torch, mesh, seed, layers):
    """Mixtral-8x7B at full width cut to `layers` layers: the
    single-device weights from `seed` and this rank's EP shard (its four
    experts) of the same tensors, as views."""
    from theroundtaible_tpu_torch.engine.models import common
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.sharding import shard_params
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_model_config(MOE_MODEL), num_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(seed)
    full = common.init_params(cfg, gen, torch.bfloat16, dev)
    return cfg, full, shard_params(full, cfg, mesh)


def moe_tp_rank(torch, rank):
    """Phase 47 on one rank: the EP forward (forward_paged, a 128-row
    chunk of 3 rows and 4 decode steps) against one device's on the same
    weights, dense and int4 (the expert down through K10e at decode
    rows), teacher-forced with the single-device tokens; each rank
    computes the single-device reference in its turn."""
    import torch.distributed as dist
    from theroundtaible_tpu_torch.engine import quant, sharding
    from theroundtaible_tpu_torch.engine.kernels import int4mm
    from theroundtaible_tpu_torch.engine.models.common import (flat_layer,
                                                               nest_layer)
    dev = torch.device("cuda")
    mesh = tp_mesh()
    out = {}
    for mode in ("bf16", "int4"):
        cfg, full, shard = _moe_tp_weights(torch, mesh, SEED + 47,
                                           MOE_TP_LAYERS)
        if mode == "int4":
            full = quant.quantize_params(full, cfg, act_dtype=torch.bfloat16,
                                         bits=4, model_shards=2)
            shard = sharding.shard_params(full, cfg, mesh)
        shard = {k: ([nest_layer({n: sharding.materialize(w) for n, w in
                                  flat_layer(layer).items()})
                      for layer in v]
                     if k == "layers" else sharding.materialize(v))
                 for k, v in shard.items()}
        gen = torch.Generator(device=dev).manual_seed(SEED + 48)
        B, T = 3, 128
        prompts = torch.randint(3, 259, (B, T), generator=gen,
                                device=dev).tolist()

        def run(params, m, forced=None):
            return paged_steps(torch, params, cfg, prompts, 4,
                               torch.bfloat16, mesh=m, forced=forced)

        single = _turns(torch, rank, lambda: run(full, None))
        forced = [lg.argmax(-1) for lg in single[0][:4]]
        int4mm.reset_launch_counts()
        ep = run(shard, mesh, forced)
        torch.cuda.synchronize()
        spmd = int4mm.launch_counts()["einsum_int4_spmd"]
        flips = router_flips(torch, ep[1], single[1], [T] * B)
        worst, ok, compared = compare_unflipped(
            torch, ep[0], single[0], flips, cfg.num_layers, T)
        out[mode] = {"max_abs_err": worst,
                     "within_tolerance": ok and compared > 0,
                     "row_steps_compared": compared,
                     "router_flips": flips[:8],
                     "flip_margins_ok": all(f["margin"] < PATH_TOL
                                            for f in flips),
                     "einsum_int4_spmd": spmd,
                     "experts_per_rank": int(
                         (shard["layers"][0]["experts"]["down_proj"].q4
                          if mode == "int4" else
                          shard["layers"][0]["experts"]["down_proj"])
                         .shape[0])}
        del full, shard, single, ep
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def moe_tp_phase(ranks) -> dict:
    outs = [r for r, _ in ranks]
    for mode in ("bf16", "int4"):
        for o in outs:
            m = o[mode]
            check(m["experts_per_rank"] == 4,
                  f"moe_tp {mode}: a rank holds {m['experts_per_rank']} "
                  f"experts")
            check(m["within_tolerance"] and m["flip_margins_ok"],
                  f"moe_tp {mode}: EP logits off one device's: {m}")
        if mode == "int4":
            check(all(o[mode]["einsum_int4_spmd"] > 0 for o in outs),
                  "moe_tp int4: K10e never launched")
    emit("moe_tp", backend=TP_BACKEND, mesh=TP_MESH, layers=MOE_TP_LAYERS,
         tolerance=PATH_TOL, ranks=outs)
    return {"einsum_int4_spmd": sum(o["int4"]["einsum_int4_spmd"]
                                    for o in outs)}


def moe_checkpoint_phase(torch, kattn):
    """Phase 48 (above). Returns its launch counts."""
    import shutil
    import tempfile
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    from theroundtaible_tpu_torch.engine.checkpoint import load_hf_checkpoint
    from theroundtaible_tpu_torch.engine.models import common
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    dev = torch.device("cuda")
    name = register_depth(MOE_MODEL, MOE_CKPT_LAYERS)
    cfg = get_model_config(name)
    gen = torch.Generator(device=dev).manual_seed(SEED + 49)
    params = common.init_params(cfg, gen, torch.bfloat16, dev)
    d = Path(tempfile.mkdtemp(prefix="moe-ckpt-")) / "hf"
    try:
        t0 = time.monotonic()
        written = write_hf_checkpoint(torch, params, cfg, d, shards=2)
        write_s = time.monotonic() - t0
        t0 = time.monotonic()
        loaded = load_hf_checkpoint(d, cfg, torch.bfloat16)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        written_leaves = dict(tree_leaves(params))
        loaded_leaves = dict(tree_leaves(loaded))
        check(set(written_leaves) == set(loaded_leaves),
              f"moe_checkpoint: the loaded tree has other leaves: "
              f"{sorted(set(written_leaves) ^ set(loaded_leaves))[:6]}")
        equal = all(bool(torch.equal(x, loaded_leaves.get(k, x[:0])))
                    for k, x in written_leaves.items())
        check(equal, "moe_checkpoint: a loaded leaf differs from the "
                     "written one")
        pairs = written_leaves
        names = json.loads((d / "model.safetensors.index.json")
                           .read_text())["weight_map"]
        last = cfg.num_experts - 1
        check(any(f".block_sparse_moe.experts.{last}.w2." in n
                  for n in names),
              "moe_checkpoint: no block_sparse_moe expert tensors written")
        del loaded, params
        gc.collect()
        torch.cuda.empty_cache()
        config = depth_config(MOE_MODEL, MOE_CKPT_LAYERS,
                              checkpoint=str(d))
        adapter = TorchLlmAdapter.from_config("torch-llm-moe-ckpt", config)
        engine = adapter._get_engine()
        totals, _gen, stats = serve_rounds(
            torch, kattn, adapter, engine, "moe_checkpoint_round",
            required=PAGED_KERNELS[:2], forbidden=CONTIGUOUS_KERNELS)
        emit("moe_checkpoint", layers=MOE_CKPT_LAYERS, bytes=written,
             write_s=write_s, load_s=load_s, leaves=len(pairs),
             bit_identical=equal, tensors=len(names),
             decode_ms_per_step=[decode_ms_per_step(stats[r])
                                 for r in (1, 2)], launches=totals)
        release(torch, engine)
        del adapter
    finally:
        shutil.rmtree(d.parent, ignore_errors=True)
    return totals


def f16_kernels_phase(torch, kattn):
    """Phase 49 (above): each kernel at f16 against its plain version
    (KERNEL_TOL) at the serving shapes of the bf16 kernels phase, timed
    beside SDPA or torch.matmul at f16. Returns {kernel: timing}."""
    from theroundtaible_tpu_torch.engine import kv_quant as kvq
    from theroundtaible_tpu_torch.engine import lora as lora_mod
    from theroundtaible_tpu_torch.engine.kernels import int4mm
    from theroundtaible_tpu_torch.engine.kernels import lora as klora
    from theroundtaible_tpu_torch.engine.models import common
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    dev, f16 = torch.device("cuda"), torch.float16
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    flush = torch.empty(16 << 20, dtype=torch.float32, device=dev)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa
    H, K, D, ps, B = 32, 8, 128, 128, 3
    out = {}

    def timed(name, fn, ref, lib, nbytes, flops, rows=None, reps=30,
              plain_reps=3, library=None, **extra):
        first = fn()
        err, ok = max_err(torch, first, ref(), rows=rows)
        check(ok, f"f16 {name} disagrees with its plain version by {err}")
        t = {"max_abs_err": err, "ms": time_ms(torch, fn, reps, flush),
             "plain_ms": time_ms(torch, ref, plain_reps, flush),
             "library_ms": time_ms(torch, lib, reps, flush),
             "device_ms": device_ms(torch, fn, flush),
             "library_device_ms": device_ms(torch, lib, flush),
             "library": library, "bytes": nbytes, "flops": flops, **extra}
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops)
        out[name] = t

    # K1 (and K4 inside it) at decode: 3 rows at ~1.7k cached tokens.
    k_pool, v_pool, table = make_pool(torch, gen, B, 8192, K, D, ps, f16,
                                      dev)
    valid_l = [1600, 1650, 1700]
    valid = i32(valid_l)
    poison_past_frontier(k_pool, v_pool, table, valid, ps)
    q = (torch.randn(B, 1, H, D, generator=gen, device=dev)
         * D ** -0.5).to(f16)
    args = (q, k_pool, v_pool, table, valid)
    cells = kv_cells(valid_l, [v - 1 for v in valid_l], None)
    timed("paged_decode_attention",
          lambda: kattn.paged_decode_attention(*args),
          lambda: kattn.paged_decode_attention_ref(*args),
          sdpa_view_call(torch, q, k_pool, v_pool, table, valid, None),
          2 * q.numel() * 2 + cells * K * D * 2 * 2, cells * H * D * 4,
          library="sdpa_view")
    for bits in (8, 4):
        kq, vq, kw = quantized_pools(kvq, k_pool, v_pool, bits)
        qa = (q, kq, vq, table, valid)
        timed(f"kv_dequant_int{bits}",
              lambda: kattn.paged_decode_attention(*qa, **kw),
              lambda: kattn.paged_decode_attention_ref(*qa, **kw),
              sdpa_view_call(torch, q, k_pool, v_pool, table, valid, None),
              2 * q.numel() * 2 + quant_cell_bytes(cells, K, D, bits),
              cells * H * D * 4, library="sdpa_view on the f16 pool")
        del kq, vq, kw
    # K2: a 512-row delta chunk over a 1.2k shared prefix.
    offsets_l, lengths_l, T = [1200, 1200, 1200], [300, 320, 340], 512
    offsets = i32(offsets_l)
    valid_l = [o + n for o, n in zip(offsets_l, lengths_l)]
    valid = i32(valid_l)
    q = (torch.randn(B, T, H, D, generator=gen, device=dev)
         * D ** -0.5).to(f16)
    args = (q, k_pool, v_pool, table, offsets, valid)
    cells = kv_cells(valid_l, offsets_l, None)
    pairs = attended_pairs(valid_l, offsets_l, lengths_l, None)
    timed("paged_prefill_attention",
          lambda: kattn.paged_prefill_attention(*args),
          lambda: kattn.paged_prefill_attention_ref(*args),
          sdpa_view_call(torch, q, k_pool, v_pool, table, valid, offsets),
          2 * sum(lengths_l) * H * D * 2 + cells * K * D * 2 * 2,
          pairs * H * D * 4, rows=lengths_l, reps=20, library="sdpa_view")
    del k_pool, v_pool
    # K3: the main flat buffer, then the verify buffer.
    for name, runs, T in (("ragged_paged_attention", RAGGED_MAIN, 1024),
                          ("ragged_paged_attention:verify",
                           RAGGED_VERIFY_MAIN, 128)):
        rargs = ragged_inputs(torch, gen, runs, T, H, K, D, ps, f16, dev)
        offs = [o for o, *_ in runs]
        lens = [m for _o, m, *_ in runs]
        cells = (verify_cells(runs, ps) if name.endswith("verify")
                 else kv_cells([o + m for o, m in zip(offs, lens)], offs,
                               None))
        pairs = attended_pairs([o + m for o, m in zip(offs, lens)], offs,
                               lens, None)
        timed(name, lambda: kattn.ragged_paged_attention(*rargs),
              lambda: kattn.ragged_paged_attention_ref(*rargs),
              sdpa_ragged_call(torch, rargs, runs),
              2 * T * H * D * 2 + cells * K * D * 2 * 2,
              pairs * H * D * 4, reps=20, library="sdpa_ragged")
        del rargs
    # K8/K9: the slot cache of 8 x 8192 positions.
    rows_l = [5, 2, 7]
    dec_valid = [1600, 1650, 1700]
    kc, vc = slot_cache(torch, gen, K, D, f16, dev, dec_valid, rows_l)
    rows = i32(rows_l)
    q = (torch.randn(B, 1, H, D, generator=gen, device=dev)
         * D ** -0.5).to(f16)
    valid = i32(dec_valid)
    dargs = (q, kc, vc, valid)
    cells = sum(dec_valid)
    timed("ragged_decode_attention",
          lambda: kattn.ragged_decode_attention(*dargs, rows=rows),
          lambda: kattn.ragged_decode_attention_ref(*dargs, rows=rows),
          sdpa_slots_call(torch, q, kc, vc, rows, valid, None),
          2 * q.numel() * 2 + cells * K * D * 2 * 2, cells * H * D * 4,
          library="sdpa_slots")
    pre_valid = [o + n for o, n in zip(offsets_l, lengths_l)]
    q = (torch.randn(B, 512, H, D, generator=gen, device=dev)
         * D ** -0.5).to(f16)
    pargs = (q, kc, vc, i32(offsets_l), i32(pre_valid))
    cells = kv_cells(pre_valid, offsets_l, None)
    pairs = attended_pairs(pre_valid, offsets_l, lengths_l, None)
    timed("flash_prefill_attention",
          lambda: kattn.flash_prefill_attention(*pargs, rows=rows),
          lambda: kattn.flash_prefill_attention_ref(*pargs, rows=rows),
          sdpa_slots_call(torch, q, kc, vc, rows, i32(pre_valid),
                          i32(offsets_l)),
          2 * sum(lengths_l) * H * D * 2 + cells * K * D * 2 * 2,
          pairs * H * D * 4, rows=lengths_l, reps=20, library="sdpa_slots")
    del kc, vc
    # K5 at Llama-3-8B's gate/up and at Mixtral's expert down; K6 at the
    # head. Yardstick: torch.matmul on the weight dequantized to f16.
    gp = INT4_GROUP // 2
    for name, (xs, ws) in (("mm_pack_out", ((3, 4096), (4096, 14336))),
                           ("mm_pack_contract", K6_SHAPE)):
        x = torch.randn(*xs, generator=gen, device=dev).to(f16)
        q4, s4 = int4_weight(torch, gen, ws, dev, f16)
        w = common.dequant_int4(q4, s4, 1, INT4_GROUP, f16)
        if name == "mm_pack_contract":
            fn = lambda: int4mm.mm_pack_contract(x, q4, s4, gp)  # noqa
            ref = lambda: int4mm.mm_pack_contract_ref(x, q4, s4, gp)  # noqa
            lib = lambda: torch.matmul(x, w.t())  # noqa
            n_out = ws[0]
        else:
            fn = lambda: int4mm.mm_pack_out(x, q4, s4, gp)  # noqa
            ref = lambda: int4mm.mm_pack_out_ref(x, q4, s4, gp)  # noqa
            lib = lambda: torch.matmul(x, w)  # noqa
            n_out = ws[1]
        timed(name, fn, ref, lib,
              q4.numel() + s4.numel() * 2 + x.numel() * 2 + xs[0] * n_out * 4,
              2 * xs[0] * ws[0] * ws[1], library="torch.matmul",
              x=list(xs), weight=list(ws))
        del x, q4, s4, w
    out["mm_pack_out:expert_down"] = k5_expert_case(
        torch, int4mm, common, gen, flush, get_model_config(MOE_MODEL), 3,
        f16)
    # K7: one layer's q/k/v group call at 3 rows of 3 personas.
    c, outs = LORA_GROUPS["q/k/v"]
    x = (torch.randn(3, c, generator=gen, device=dev) * 0.5).to(f16)
    stacks = [lora_stacks(torch, gen, c, o, dev, f16) for o in outs]
    ids = i32(LORA_GROUP_IDS["3 personas"])
    y0 = [torch.zeros(3, o, dtype=torch.float32, device=dev) for o in outs]
    nbytes, flops = lora_group_bytes(LORA_GROUP_IDS["3 personas"], 3, c,
                                     outs)
    t = lora_group_case(torch, klora, lora_mod, x, stacks, y0, ids, flush,
                        sum(a.numel() * 2 + b.numel() * 2
                            for a, b in stacks))
    t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops)
    t["library"] = "grouped einsums plus the add"
    out["lora_bgmv"] = t
    emit("f16_kernels", tolerance=KERNEL_TOL, kernels=out)
    return out


def f16_engine_phase(torch, kattn):
    """Phase 50 (above). Returns its launch counts."""
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    launches = {}
    runs = (("f16_round", {}, PAGED_KERNELS[:2], CONTIGUOUS_KERNELS),
            ("f16_contiguous_round", {"kv_layout": None},
             CONTIGUOUS_KERNELS, PAGED_KERNELS),
            ("f16_quant_lora_round",
             {"quant": "int4", "kv_quant": "int8",
              "lora": {**LORA_BLOCK, "adapters": {
                  "skeptic": LORA_BLOCK["adapters"]["skeptic"]}},
              "knight_adapters": {"lancelot": None, "gawain": "skeptic",
                                  "percival": None}},
             PAGED_KERNELS[:2] + ("paged_decode_attention:int8",)
             + INT4_KERNELS + LORA_KERNELS, CONTIGUOUS_KERNELS))
    for phase, extra, required, forbidden in runs:
        config = depth_config(F16_MODEL, F16_LAYERS, dtype="float16")
        for k, v in extra.items():
            if v is None:
                config.pop(k)
            else:
                config[k] = v
        adapter = TorchLlmAdapter.from_config(f"torch-llm-{phase}", config)
        engine = adapter._get_engine()
        check(engine.dtype == torch.float16,
              f"{phase}: built {engine.dtype}")
        totals, generated, stats = serve_rounds(
            torch, kattn, adapter, engine, phase, required=required,
            forbidden=forbidden)
        emit(f"{phase}_summary", layers=F16_LAYERS,
             decode_ms_per_step=[decode_ms_per_step(stats[r])
                                 for r in (1, 2)],
             prefill_s=[stats[r]["prefill_seconds"] for r in (1, 2)],
             step_bound_ms=step_bound_ms(engine)[1],
             describe={k: engine.describe().get(k) for k in (
                 "quant", "kv_quant", "kv_layout", "attn")},
             launches=totals)
        if phase != "f16_quant_lora_round":
            # the unquantized engines' greedy knights on the plain path
            greedy_against_plain(torch, engine, phase, generated,
                                 GREEDY_KNIGHTS)
        for k, n in totals.items():
            launches[k] = launches.get(k, 0) + n
        if phase == "f16_round":
            for k, n in scheduler_phase(torch, kattn, engine,
                                        phase="f16_scheduler").items():
                launches[k] = launches.get(k, 0) + n
        release(torch, engine)
        del adapter
    return launches


# The kernels line's f16 entries: the f16_kernels cases of each row, and
# the kernels a K10 wrapper's f16 calls run.
F16_CASES = {"paged_decode_attention": ("paged_decode_attention",),
             "paged_prefill_attention": ("paged_prefill_attention",),
             "ragged_paged_attention": ("ragged_paged_attention",
                                        "ragged_paged_attention:verify"),
             "flash_prefill_attention": ("flash_prefill_attention",),
             "ragged_decode_attention": ("ragged_decode_attention",),
             "kv_dequant_int8": ("kv_dequant_int8",),
             "kv_dequant_int4": ("kv_dequant_int4",),
             "mm_pack_out": ("mm_pack_out", "mm_pack_out:expert_down"),
             "mm_pack_contract": ("mm_pack_contract",),
             "lora_bgmv": ("lora_bgmv",)}
F16_RIDES = {"flash_attention_spmd": "K8/K9", "paged_decode_spmd": "K1",
             "paged_prefill_spmd": "K2", "ragged_paged_spmd": "K3",
             "einsum_int4_spmd": "K5/K6", "lora_bgmv_spmd": "K7"}
F16_FIELDS = ("max_abs_err", "ms", "plain_ms", "library_ms", "library",
              "device_ms", "library_device_ms", "bound_ms", "bound_by",
              "cold_ms", "library_cold_ms")


def add_f16_and_moe(rows, f16_timing, k5_expert, moe_quant, f16_launches,
                    moe_tp) -> None:
    """Each kernel row gets its dtypes and its f16 cases (phase 49), K5 its
    expert-down cases (phase 46, bf16; phase 49, f16), and K4-K7's and
    K10e's launches in the MoE and f16 phases (added to `launches`, and
    beside it by phase)."""
    extra = {
        "kv_dequant_int8": {"f16_engine": sum(
            n for k, n in f16_launches.items() if k.endswith(":int8"))},
        "kv_dequant_int4": {"f16_engine": sum(
            n for k, n in f16_launches.items() if k.endswith(":int4"))},
        "mm_pack_out": {"moe_quant": moe_quant["int4"]["mm_pack_out"],
                        "f16_engine": f16_launches.get("mm_pack_out", 0)},
        "mm_pack_contract": {
            "moe_quant": moe_quant["int4"]["mm_pack_contract"],
            "f16_engine": f16_launches.get("mm_pack_contract", 0)},
        "lora_bgmv": {"f16_engine": f16_launches.get("lora_bgmv", 0)},
        "einsum_int4_spmd": {"moe_tp": moe_tp["einsum_int4_spmd"]}}
    for row in rows:
        name = row["name"]
        row["dtypes"] = ["float32", "bfloat16", "float16"]
        if name in F16_CASES:
            row["f16"] = {case: {k: f16_timing[case][k] for k in F16_FIELDS
                                 if k in f16_timing[case]}
                          for case in F16_CASES[name]}
        else:
            row["f16"] = f"the f16 bodies of {F16_RIDES[name]} per rank"
        if name in extra:
            row["moe_f16_launches"] = extra[name]
            row["launches"] += sum(extra[name].values())
        if name == "mm_pack_out":
            row["expert_down_launches"] = moe_quant["int4"][
                "mm_pack_out:expert_down"]
            row["expert_down"] = {f"bf16_{m}_rows": k5_expert[m]
                                  for m in sorted(k5_expert)}


CHILDREN = {"device_fault": device_fault_child,
            "journal_serve": journal_serve_child,
            "journal_resume": journal_resume_child,
            "gateway_child": gateway_child}


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
    # Flight dumps (a restart, a breaker trip, a hang) land beside the
    # phase lines; the children inherit the setting.
    import os
    os.environ.setdefault("ROUNDTABLE_TELEMETRY_DIR", str(OUT / "telemetry"))
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # The build watch records every library this process builds or loads
    # (phase 37 reads it).
    from theroundtaible_tpu_torch.engine import compile_watch
    compile_watch.install()
    t0 = time.monotonic()
    build.build_all(f16=False)
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
    # The f16 bodies (phases 49-50) build in the background from here, once
    # the kernels' timings are taken, while the engine phases run.
    f16_build = threading.Thread(target=build.build_all,
                                 kwargs={"f16": "only"}, daemon=True)
    f16_build.start()

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
    # Speculative decoding: the verify dispatch at 2 layers, then, on the
    # 32-layer weights (the engine phase's engine released first), the
    # session six ways (off, then engines sharing the weights).
    spec_path_phase(torch, engine)
    from theroundtaible_tpu_torch.engine import reset_engines
    reset_engines()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine = full_depth_engine(torch)
    spec_launches = spec_scheduler_phase(torch, kattn, engine)
    # The prefix cache and the offload tier at full width, on engines
    # sharing the weights: attach, copy-on-write, pressure and idle spills.
    cache_launches = {"prefix_path": prefix_path_phase(torch, kattn, engine),
                      "offload_path": offload_path_phase(torch, kattn,
                                                         engine)}
    for counts in cache_launches.values():
        for name in PAGED_KERNELS:
            launches[name] += counts[name]
    # Supervision and the telemetry spine: a supervised restart at full
    # width beside an engine of SUPERVISION_LAYERS layers (the 32-layer
    # engine released first), telemetry's cost on it, then the child
    # processes (a real CUDA fault; kill -9 and resume).
    reset_engines()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine = supervision_engine(torch)
    supervision_launches = {
        "supervised_restart": supervised_restart_phase(torch, kattn,
                                                       engine),
        "telemetry_overhead": telemetry_overhead_phase(torch, engine)}
    # The perf model and the serving gateway on the same engine, then the
    # gateway's kill -9 resume in child processes.
    serving_launches = {
        "perf_model": perf_model_phase(torch, kattn, engine),
        "gateway_stream": gateway_stream_phase(torch, kattn, engine)}
    gc.collect()
    torch.cuda.empty_cache()
    supervision_launches["device_fault"] = device_fault_phase(torch)
    supervision_launches["journal_resume"] = journal_resume_phase(torch)
    serving_launches["gateway_resume"] = gateway_resume_phase(torch)
    for counts in (*supervision_launches.values(),
                   *serving_launches.values()):
        for name in PAGED_KERNELS:
            launches[name] += counts.get(name, 0)

    # Release the supervision engine (the engine cache holds the paged
    # engine's config too) before the router's two replicas take two
    # engines' memory (three during a roll), then before the contiguous
    # engine takes its weights and 8.6 GB of slots.
    reset_engines()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    router_launches = router_phases(torch)
    for counts in router_launches.values():
        for name in PAGED_KERNELS:
            launches[name] += counts.get(name, 0)
    contiguous, engine, contiguous_ref = contiguous_phase(torch, kattn)
    for name in CONTIGUOUS_KERNELS:
        # the contiguous rounds' and the loadgen smoke's (its stack is
        # the contiguous layout)
        launches[name] = contiguous[name] + router_launches[
            "loadgen"].get(name, 0)
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
        if phase == "quant_int8":
            for name, n in offload_quant_phase(torch, engine).items():
                quant[phase][name] += n
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

    # Multi-LoRA personas: K7 alone, the LORA_LAYERS-deep engine's rounds and
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

    # MoE (Mixtral at full width, cut in depth) and float16: the engines
    # of phases 45-46 and 48-50 one after another (each released before
    # the next); phase 47 rides the TP spawns below.
    gc.collect()
    torch.cuda.empty_cache()
    moe_launches = {"moe_engine": moe_engine_phase(torch, kattn)}
    moe_quant_launches, k5_expert = moe_quant_phase(torch, kattn)
    moe_launches["moe_checkpoint"] = moe_checkpoint_phase(torch, kattn)
    t0 = time.monotonic()
    f16_build.join()
    emit("build_f16", libraries=[n + build.F16 for n in build.SOURCES],
         waited_s=time.monotonic() - t0)
    f16_timing = f16_kernels_phase(torch, kattn)
    gc.collect()
    torch.cuda.empty_cache()
    f16_launches = f16_engine_phase(torch, kattn)
    for name in PAGED_KERNELS + CONTIGUOUS_KERNELS:
        launches[name] += sum(c.get(name, 0) for c in moe_launches.values())
        launches[name] += f16_launches.get(name, 0)

    # Sequence-parallel prefill on one card (phases 60-61), then the
    # heterogeneous trio at full depth (phase 64) while no other engine is
    # resident; phases 62-63 ride the last two-rank spawn.
    gc.collect()
    torch.cuda.empty_cache()
    seq_launches = {}
    seq_launches["ring_round"], ring_single = ring_round_phase(
        torch, kattn, "ring_round", "llama-3-8b-instruct")
    seq_launches["ring_round_mistral"], _ = ring_round_phase(
        torch, kattn, "ring_round_mistral", "mistral-7b-instruct")
    seq_launches["fleet_trio"] = fleet_trio_phase(torch, kattn)

    # Tensor parallelism: two ranks sharing the card over gloo (the kernels
    # built above; every engine of this process released first), three
    # spawns: the K10 wrappers alone (K10a-d, then K10e/K10f); the 16-layer
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
    tp_round_runs = runs[0]
    tp_launches = tp_round_phase(runs[0], "paged", reference)
    for name, n in tp_round_phase(runs[1], "contiguous",
                                  contiguous_ref).items():
        tp_launches[name] += n
    tp_quant_launches = tp_quant_phase(runs[2], single)
    # Phase 59 first: four gloo ranks on the card, TP inside two
    # pipeline stages; its tokens are held against one device's in the
    # last two-rank spawn.
    gc.collect()
    torch.cuda.empty_cache()
    pp_tp_runs = pp_tp_launch(("pp_tp_round_rank", ()))[0]
    pp_tp_tokens = {"pp_tp_round":
                    pp_tp_runs[0][0]["pp_tp_round"]["generated"]}
    # The same spawn then runs phases 51-54: lint, the data axis, the
    # scheduler on both meshes, serve and gateway on the TP ranks; then
    # phases 55-58: the pipeline on both layouts and with quantized
    # weights, the contiguous layout and the gather view on a data axis,
    # and the one-device references of phases 55-59.
    runs = tp_launch(("tp_path_rank", ()), ("tp_ragged_path_rank", ()),
                     ("moe_tp_rank", ()), ("lint_rank", ()),
                     ("data_round_rank", ()), ("mesh_scheduler_rank", ()),
                     ("mesh_serve_rank", ()), ("pp_round_rank", ()),
                     ("data_contiguous_round_rank", ()),
                     ("mesh_references_rank", (pp_tp_tokens,)),
                     ("ring_tp_rank", (ring_single["generated"],)))
    tp_path_phase(runs[0])
    tp_launches["ragged_paged_spmd"] = tp_ragged_path_phase(runs[1])[
        "ragged_paged_spmd"]
    moe_tp_launches = moe_tp_phase(runs[2])
    lint_phase(runs[3])
    mesh_launches = {"data_round": data_round_phase(runs[4], tp_round_runs),
                     "mesh_scheduler": mesh_scheduler_phase(runs[5]),
                     "mesh_serve": mesh_serve_phase(runs[6])}
    for counts in mesh_launches.values():
        for name in TP_KERNELS:
            tp_launches[name] += counts.get(name, 0)
        for name in PAGED_KERNELS:
            launches[name] += counts.get(name, 0)
    pp_launches = pp_phases(runs[7], runs[8], pp_tp_runs, runs[9][0][0])
    seq_launches.update(ring_tp_phases(runs[10], ring_single))

    # The main path from a checkpoint: write, load, discuss; then the rest
    # of the CLI on the same engine (one round each), in one project.
    gc.collect()
    torch.cuda.empty_cache()
    import shutil
    ckpt = checkpoint_phase(torch, kattn)
    project = cli_project(ckpt)
    try:
        reset_engines()
        gc.collect()
        torch.cuda.empty_cache()
        cli_launches = {"discuss": discuss_phase(torch, project)}
        (project / ".roundtable" / "config.json").write_text(
            json.dumps(discuss_config(ckpt, max_rounds=1), indent=1))
        for phase, run in (("summon", summon_phase), ("serve", serve_phase),
                           ("apply", apply_phase),
                           ("code_red", code_red_phase),
                           ("commands", commands_phase)):
            cli_launches[phase] = run(torch, project)
    finally:
        reset_engines()
        shutil.rmtree(ckpt.parent, ignore_errors=True)
        shutil.rmtree(project, ignore_errors=True)

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
            # K1-K3's launches in each CLI phase (phases 27-32), in each
            # spec_scheduler run, in prefix_path / offload_path, in the
            # supervision phases 33-36, the serving phases 38-40 and the
            # router phases 41-44 (also in `launches`)
            **({"cli_launches": {phase: counts[name] for phase, counts
                                 in cli_launches.items()},
                "router_launches": {
                    phase: counts.get(name, 0) for phase, counts
                    in router_launches.items()},
                "supervision_launches": {
                    phase: counts.get(name, 0) for phase, counts
                    in supervision_launches.items()},
                "serving_launches": {
                    phase: counts.get(name, 0) for phase, counts
                    in serving_launches.items()},
                "spec_launches": {run: counts[name] for run, counts
                                  in spec_launches.items()},
                "cache_launches": {phase: counts[name] for phase, counts
                                   in cache_launches.items()}}
               if name in PAGED_KERNELS else {}),
            # K3 at the verify buffer of RAGGED_VERIFY_MAIN
            **({"verify": {k: t["verify"][k] for k in (
                "shape", "ms", "plain_ms", "device_ms", "device_kernels_ms",
                "sdpa_view_ms", "sdpa_device_ms", "bound_ms", "bound_by")}}
               if kind == "ragged" else {}),
            **({"device_ms": t["device_ms"],
                "library_device_ms": t["sdpa_device_ms"]}
               if "device_ms" in t else {})})
    # K4: K1 at the decode serving shape on int8 / int4 pages; its
    # yardstick is the same kernel on the unquantized pool. Launches: the
    # K1-K3 launches on quantized pools in the quant phases and
    # data_round_int8.
    for bits in (8, 4):
        t = qtiming[bits]["decode"]
        rows.append({
            "name": f"kv_dequant_int{bits}", "route": "cuda",
            "source": src + "paged_common.cuh",
            "replaces": "theroundtaible_tpu/engine/pallas/attention.py:48",
            "launches": sum(n for counts in (*quant.values(),
                                             *mesh_launches.values())
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
        "bound_ms": total["bound_ms"], "bound_by": total["bound_by"],
        "spec_launches": {run: counts["lora_bgmv"]
                          for run, counts in spec_launches.items()}})
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
            # phases 52-54's share of `launches`, and of it the launches
            # over data replicas' pools
            "mesh_launches": {phase: counts.get(name, 0)
                              for phase, counts in mesh_launches.items()},
            **({"pool_replicas_launches": sum(
                counts.get(f"{name}:pool_replicas", 0)
                for counts in mesh_launches.values())}
               if name in TP_KERNELS[1:3] else {}),
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
    add_f16_and_moe(rows, f16_timing, k5_expert, moe_quant_launches,
                    f16_launches, moe_tp_launches)
    # Phases 55-59's launches (the pipeline, the contiguous data axis):
    # K1/K2, K8/K9, K10b/K10c, K5/K6, by phase.
    for row in rows:
        extra = {phase: counts[row["name"]]
                 for phase, counts in pp_launches.items()
                 if counts.get(row["name"])}
        if extra:
            row["launches"] += sum(extra.values())
            row["pipeline_launches"] = extra
    # Phases 60-64's launches (the ring prefill's rounds, the fleet trio):
    # K1/K2, K10b/K10c, K5/K6, by phase.
    for row in rows:
        extra = {phase: counts[row["name"]]
                 for phase, counts in seq_launches.items()
                 if counts.get(row["name"])}
        if extra:
            row["launches"] += sum(extra.values())
            row["seq_fleet_launches"] = extra
    build_watch_phase()
    emit("device_timing", **DEVICE_TIMING)
    summary = {"kernels": rows}
    (OUT / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def child_main(argv) -> int:
    """`chip_smoke.py --child <phase> args...`: one child-process phase
    (CHILDREN), on the card, printing its result as its last JSON line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CHILDREN[argv[0]](*argv[1:])
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        sys.exit(child_main(sys.argv[2:]))
    sys.exit(main())
