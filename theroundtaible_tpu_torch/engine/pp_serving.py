"""Pipeline-parallel serving - stage-local weights and KV, prefill and
decode (counterpart of theroundtaible_tpu/engine/pp_serving.py).

The engine for checkpoints too large for one device or one TP group,
reachable from the adapter config as `mesh: {"pipe": N}` or `{"pipe": N,
"model": M}` (TP inside stages). One process per rank, ranks laid out
(stage, model index) as sharding.PipeMesh: each stage holds only its
layers' weights (models/common.Stage: the embedding on the first stage,
the final norm and the head on the last) and only its layers' cache, so no
device ever holds the whole model or the whole cache.

- Prefill: each chunk runs the GPipe schedule of engine/pipeline.py over
  `n_micro` microbatches (one where the batch does not divide): stage s
  runs microbatch m once stage s-1 has sent it and sends it on without
  waiting. A stage's layers are the main path's own forward
  (models/common.forward_cached or paged_forward.forward_paged, with
  `hidden` and `head`), with its kernels and its `_matmul` seam.
- Decode: one hop per stage per token: stage 0 embeds the last token and
  sends the hidden state, each stage applies its layers against its own
  cache, the last stage applies the final norm and the head and samples
  with the per-row sampling parameters, then broadcasts the tokens and the
  done flags to every rank.
- Storage: contiguous, stage-local KVCache slots under the same SlotBook
  bookkeeping on every rank (prefix sharing copies each stage's own
  layers' span); paged, a PagedKVCache per rank over the stage's layers,
  its page table identical on every rank (the host bookkeeping is the
  same calls in the same order), served pool-direct through K2 (prefill)
  and K1 (decode) - K10c and K10b under TP inside stages - or, with
  `attn: "dense"`, through the gather view; the prefix cache rides the
  paged pool.

Every rank makes the same calls in the same order: a rank that left a
call early would wait forever in a receive the others left. The host
bookkeeping (slots, pages, LCP reuse, share passes, prefix-cache
attaches) is deterministic from the same turns, and whatever could end a
call early - fleet.drain's admission gate, a deadline, `timeout_s`, a
budget's cancellation - is decided on rank 0 and broadcast at the chunk
and segment boundaries (the budget on the other ranks is never read);
every row done comes with the last stage's tokens. Dispatches run bare
(no injected fault, watchdog or retry), as inside a mesh plan
(engine/mesh_plan.py).

By design, unlike the JAX engine: the shared leaves are not replicated on
every stage (the embedding lives on stage 0, the head on the last stage;
describe()["params"] still counts the whole model), a process waits for
its input where the JAX program computes masked bubbles, and sampling
runs on the last stage, whose tokens every rank takes.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..utils import telemetry
from . import compile_watch, deadlines, faults, trace_hooks
from .device import resolve_device
from .distributed import broadcast_from, recv_into, send_to
from .engine import _DTYPES, MIN_SHARED_PREFIX, GenStats, InferenceEngine
from .kernels import attention as kattn
from .kernels import build as kbuild
from .kernels import int4mm
from .kvcache import KVCache, scoped_slot, share_prefixes
from .mesh_plan import inside_plan, lockstep
from .models.common import (ModelConfig, Stage, forward_cached, init_params,
                            int4_sites)
from .models.registry import get_model_config
from .paged_forward import forward_paged, gather_view, scatter_view
from .paging import PagedKVCache
from .pipeline import run_microbatches, stage_dtype
from .prefix_cache import PrefixCache, cache_enabled
from .quant import quantize_leaves
from .sampling import SamplingParams, sample_token_batch, sampling_arrays
from .serving_loop import (DECODE_SEGMENT, MAX_PREFILL_CHUNK,
                           PREFILL_BUCKETS, bucket_for, chunked_prefill,
                           clamp_max_new, decode_segments, finalize_outputs,
                           host_sync, prompt_budget, row_budget_fn)
from .sharding import build_pipe_mesh, local_config
from .tokenizer import load_tokenizer
from .weights import expected_shapes


class PPEngine:
    """Pipeline-parallel serving engine (stage-local weights AND KV), one
    rank of it: every rank of the pipe mesh builds the same engine and
    makes the same calls."""

    def __init__(self, model_cfg: ModelConfig, *, checkpoint: str = "",
                 n_stages: int = 2, n_model: int = 1, n_micro: int = 2,
                 num_slots: int = 4, dtype=torch.bfloat16,
                 quant: str = "none", kv_layout: str = "contiguous",
                 page_size: int = 128, num_pages: Optional[int] = None,
                 attn: str = "auto",
                 sampling: Optional[SamplingParams] = None, seed: int = 0,
                 devices: Optional[list[int]] = None,
                 prefix_cache: Optional[bool] = None,
                 prefix_cache_pages: Optional[int] = None,
                 params: Optional[dict] = None, device="cuda"):
        if quant not in ("none", "int8", "int4"):
            raise ValueError(
                f"quant must be none|int8|int4, got {quant!r}")
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(
                f"kv_layout must be contiguous|paged, got {kv_layout!r}")
        if attn not in ("auto", "flash", "dense"):
            raise ValueError(f"attn must be auto|flash|dense, got {attn!r}")
        if dtype not in _DTYPES.values():
            raise ValueError(f"dtype must be one of {list(_DTYPES)}, got "
                             f"{dtype}")
        self.device = resolve_device(
            InferenceEngine._pinned_device(device, devices, None))
        heads_divide = kattn.spmd_partitionable(
            model_cfg.num_heads, model_cfg.num_kv_heads, n_model)
        if attn == "flash" and n_model > 1 and not heads_divide:
            raise ValueError(
                f"attn='flash' on a {n_model}-way model axis needs head "
                f"counts divisible by it (got H={model_cfg.num_heads}, "
                f"K={model_cfg.num_kv_heads}) - use attn='auto' or "
                "'dense'")
        # JAX's message, before any group is touched.
        Stage(0, n_stages).layers(model_cfg.num_layers)
        shape = {"pipe": n_stages}
        if n_model > 1:
            shape["model"] = n_model
        self.mesh = build_pipe_mesh(shape)
        self.stage = Stage(self.mesh.stage, n_stages)
        self.n_stages, self.n_model, self.n_micro = n_stages, n_model, n_micro
        smesh = self.mesh.stage_mesh
        if kv_layout == "contiguous":
            model_cfg = InferenceEngine._resolve_attn(
                model_cfg, attn, self.device, smesh)
        else:
            impl = attn if attn != "auto" else (
                "flash" if self.device.type == "cuda" else "dense")
            model_cfg = dataclasses.replace(model_cfg, attn_impl=impl)
        self.cfg = model_cfg
        self.max_seq_len = model_cfg.max_seq_len
        self.sampling = sampling or SamplingParams()
        self.tokenizer = load_tokenizer(checkpoint or None)
        self.quant = quant
        self.dtype = dtype
        self.kv_layout = kv_layout
        self.lora = None
        self.params = self._build_params(params, seed, checkpoint)
        self.num_params = self._whole_count()
        self._int4_paths = self._int4_report() if quant == "int4" else None
        # This rank's share of the cache: its stage's layers, its kv heads.
        per = len(self.stage.layers(model_cfg.num_layers))
        kv_cfg = dataclasses.replace(local_config(model_cfg, smesh),
                                     num_layers=per)
        local = local_config(model_cfg, smesh)
        self._pool_direct = False
        self.prefix_cache: Optional[PrefixCache] = None
        if kv_layout == "contiguous":
            self._kv = KVCache(kv_cfg, num_slots, self.max_seq_len, dtype,
                               self.device)
        else:
            self._pool_direct = attn != "dense"
            if self._pool_direct:
                reason = self._pool_decline(model_cfg, local, page_size)
                if reason == "heads:model-axis" \
                        and self.device.type == "cpu":
                    self._pool_direct = False
                elif reason is not None:
                    raise ValueError(
                        f"the paged attention kernels decline this pool "
                        f"shape on {self.device}: {reason}")
            self._kv = PagedKVCache(kv_cfg, num_slots, self.max_seq_len,
                                    dtype, self.device, page_size=page_size,
                                    num_pages=num_pages, mesh=smesh)
            if cache_enabled(prefix_cache):
                self.prefix_cache = PrefixCache(
                    self._kv, engine=model_cfg.name,
                    max_pages=prefix_cache_pages)
                self._kv.prefix_cache = self.prefix_cache
        # JAX's gather-view attributes: the view never outlives a dispatch.
        self.kc = self.vc = None
        # The last stage samples; its generator is seeded as every rank's.
        self._generator = torch.Generator(
            device=self.device).manual_seed(seed + 1)
        self._chars_per_token: Optional[float] = None
        self.last_stats = GenStats()
        self._serve_lock = threading.Lock()
        self.retry = faults.DEFAULT_RETRY
        self.quant_auto_degraded = False
        # Rank 0's plan channel under `serve` on a pipe mesh (lead()).
        self._channel = None
        self._plans_closed = False
        self._devices = self._mesh_devices()
        from ..utils import perfmodel
        self.perf = perfmodel.EnginePerf.from_engine(self)
        compile_watch.install()

    # --- construction ---

    def _build_params(self, params, seed: int, checkpoint: str):
        """The stage's weights: `params` as given (weights.params_from_numpy
        with this stage), or those of an HF checkpoint, or seeded random
        ones - drawn whole, in order, on every rank, quantized whole as
        each leaf arrives (int4 groups aligned to the in-stage model
        shards), the stage keeping its own."""
        smesh = self.mesh.stage_mesh
        if params is not None:
            if checkpoint:
                raise ValueError("pass params or checkpoint, not both")
            return params
        quantize = None
        if self.quant != "none":
            import functools
            quantize = functools.partial(
                quantize_leaves, cfg=self.cfg, act_dtype=self.dtype,
                free_source=True, bits=8 if self.quant == "int8" else 4,
                model_shards=self.n_model)
        if checkpoint:
            from .checkpoint import load_hf_checkpoint
            return load_hf_checkpoint(checkpoint, self.cfg, self.dtype,
                                      self.device, smesh, quantize=quantize,
                                      stage=self.stage)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.cfg, gen, self.dtype, self.device, smesh,
                           quantize=quantize, stage=self.stage)

    def _whole_count(self) -> int:
        """The whole model's dense parameter count, as JAX's PPEngine
        counts its tree before quantizing and stacking it (every stage
        knows it from the config)."""
        shapes = expected_shapes(self.cfg)
        e, v = self.cfg.embed_dim, self.cfg.vocab_size
        return (self.cfg.num_layers * sum(math.prod(s)
                                          for s in shapes.values())
                + v * e * (1 if self.cfg.tie_embeddings else 2) + e)

    def _int4_report(self) -> dict:
        """The int4 path report of the whole model: every stage's sites,
        merged in stage order (kernels/int4mm.route_report)."""
        import torch.distributed as dist
        mine = int4mm.route_report(
            int4_sites(self.params, self.cfg), self.device)
        reports: list = [None] * self.mesh.size
        dist.all_gather_object(reports, mine, group=self.mesh.pipe_group)
        merged: dict = {}
        for rep in reports:
            for path, entries in rep.items():
                have = merged.setdefault(path, [])
                for e in entries:
                    if e not in have:
                        have.append(e)
        return merged

    def _pool_decline(self, cfg: ModelConfig, local: ModelConfig,
                      page_size: int) -> Optional[str]:
        """Why the paged kernels decline the pool (None: pool-direct):
        K1/K2's shapes on a pipe-only mesh, the K10b/K10c wrappers' under
        TP inside stages."""
        smesh = self.mesh.stage_mesh
        if smesh is None:
            return kattn.pool_direct_decline_reason(
                MAX_PREFILL_CHUNK, page_size, cfg.head_dim,
                local.num_kv_heads, local.num_heads // local.num_kv_heads,
                self.device)
        heads = (cfg.num_heads, cfg.num_kv_heads)
        return (kattn.spmd_decline_reason(
            "prefill", smesh, heads, 1, MAX_PREFILL_CHUNK, page_size,
            cfg.head_dim, self.device) or kattn.spmd_decline_reason(
            "decode", smesh, heads, 1, 1, page_size, cfg.head_dim,
            self.device))

    def _mesh_devices(self) -> list[str]:
        import torch.distributed as dist
        names: list = [None] * self.mesh.size
        dist.all_gather_object(names, str(self.device),
                               group=self.mesh.pipe_group)
        return names

    @classmethod
    def from_config(cls, config: dict[str, Any],
                    device="cuda") -> "PPEngine":
        """JAX's PPEngine.from_config keys, with its refusals of axes other
        than "pipe" and "model" and of seq_parallel."""
        overrides = {}
        if config.get("max_seq_len"):
            overrides["max_seq_len"] = int(config["max_seq_len"])
        model_cfg = get_model_config(config.get("model", "tiny-gemma"),
                                     **overrides)
        dtype_name = config.get("dtype", "bfloat16")
        if dtype_name not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype_name!r}")
        sampling_cfg = config.get("sampling", {})
        sampling = SamplingParams(
            temperature=float(sampling_cfg.get("temperature", 0.7)),
            top_k=int(sampling_cfg.get("top_k", 0)),
            top_p=float(sampling_cfg.get("top_p", 1.0)),
            max_new_tokens=int(sampling_cfg.get("max_new_tokens", 1024)),
        )
        mesh = config.get("mesh", {})
        extra_axes = sorted(set(mesh) - {"pipe", "model"})
        if extra_axes:
            raise ValueError(
                f"mesh axes {extra_axes} are not supported alongside "
                "'pipe' — the PP engine supports mesh={'pipe': N} or "
                "mesh={'pipe': N, 'model': M} (TP inside stages); use a "
                "(data, model) mesh on the main engine for DP")
        if config.get("seq_parallel"):
            raise ValueError(
                "seq_parallel is not supported on the PP engine — use a "
                "(data, model) mesh for ring/Ulysses long-context")
        engine = cls(
            model_cfg,
            checkpoint=config.get("checkpoint", "") or "",
            n_stages=int(mesh.get("pipe", 2)),
            n_model=int(mesh.get("model", 1)),
            n_micro=int(config.get("n_micro", 2)),
            num_slots=int(config.get("num_slots", 4)),
            dtype=_DTYPES[dtype_name], quant=config.get("quant", "none"),
            kv_layout=config.get("kv_layout", "contiguous"),
            page_size=int(config.get("page_size", 128)),
            num_pages=(int(config["num_pages"])
                       if config.get("num_pages") else None),
            attn=config.get("attn") or "auto",
            sampling=sampling,
            seed=int(config.get("seed", 0)),
            devices=config.get("devices"),
            prefix_cache=config.get("prefix_cache"),
            prefix_cache_pages=(int(config["prefix_cache_pages"])
                                if config.get("prefix_cache_pages")
                                else None),
            device=device,
        )
        # The fleet planner's auto-degrade marker, surfaced by describe().
        engine.quant_auto_degraded = bool(
            config.get("_quant_auto_degraded"))
        engine._engine_config = dict(config)
        if "dispatch_retries" in config:
            engine.retry = faults.RetryPolicy(
                max_retries=max(0, int(config["dispatch_retries"])))
        return engine

    # --- the cache, as the adapter and the plans see it ---

    @property
    def kv(self):
        """The slot cache; on rank 0 under `serve` (lead()) outside a
        planned call, its state-changing calls are planned for every
        rank first (engine/mesh_plan.py)."""
        if self._channel is not None and not inside_plan():
            from .mesh_plan import _PlanPart
            return _PlanPart("kv", self._kv, self._channel)
        return self._kv

    def lead(self) -> None:
        """Rank 0 of `serve` on a pipe mesh: from here on every
        generate_batch_with_stats call and every slot release is
        broadcast as a plan to the other ranks, which follow them
        (follow_plans). Idempotent; a no-op on other ranks."""
        if self._channel is None and self.mesh.rank == 0:
            from .mesh_plan import PlanChannel, kv_digest
            kv = self._kv
            self._channel = PlanChannel(self.mesh,
                                        digest=lambda: kv_digest(kv))

    def close_plans(self) -> None:
        """Rank 0: close the plan channel, which ends the followers'
        loops (once: a second close has no follower left)."""
        if self._channel is not None and not self._plans_closed:
            self._plans_closed = True
            self._channel.send(None)

    def follow_plans(self) -> dict:
        """A rank > 0 of `serve` on a pipe mesh: make rank 0's planned
        calls on this engine until rank 0 closes the channel. Returns the
        plan counts."""
        from .mesh_plan import PlanChannel, follow, kv_digest
        kv = self._kv
        channel = PlanChannel(self.mesh, digest=lambda: kv_digest(kv))
        self._follow_counts = follow(
            self, channel, {"plans": 0, "dispatches": 0, "errors": 0})
        return self._follow_counts

    def plan_counts(self) -> Optional[dict]:
        """Rank 0's sent plans or a follower's counts (None without
        plans)."""
        if self._channel is not None:
            return {"role": "rank0", "plans": self._channel.sent,
                    "dispatches": self._channel.dispatches}
        counts = getattr(self, "_follow_counts", None)
        return None if counts is None else {"role": "follower", **counts}

    # --- the surface the adapter uses on InferenceEngine ---

    def int4_path_report(self) -> Optional[dict]:
        """Which path the whole model's int4 products take (every stage's
        call sites, InferenceEngine.int4_path_report's shape); None
        without int4 weights."""
        return self._int4_paths

    def revive_kv_if_dead(self) -> bool:
        """InferenceEngine's seam: the stage's cache tensors are updated
        in place and never consumed by a failed dispatch, so there is
        nothing to revive."""
        return False

    def chars_per_token(self) -> float:
        if self._chars_per_token is None:
            sample = ("The quick brown fox jumps over the lazy dog. "
                      "def main(args): return 0  # typical source text\n" * 4)
            n = len(self.tokenizer.encode(sample, add_bos=False))
            self._chars_per_token = max(len(sample) / max(n, 1), 0.25)
        return self._chars_per_token

    def warmup(self, max_prompt_tokens: int = 256,
               batch_sizes: tuple[int, ...] = (1,)) -> float:
        """Build the kernels (on a card) and serve every (batch, bucket)
        prefill shape up to the prompt limit, plus one shared-prefix batch,
        as JAX's warmup does; every rank must call it."""
        t0 = time.monotonic()
        compile_watch.reopen_warmup(self.cfg.name)
        if self.device.type == "cuda":
            kbuild.build_all()
        limit = min(max_prompt_tokens,
                    self.max_seq_len - DECODE_SEGMENT - 1)
        buckets = [x for x in PREFILL_BUCKETS if x <= bucket_for(limit)]
        for b in batch_sizes:
            if b > self._kv.num_slots:
                continue
            for bucket in buckets:
                n = min(bucket, limit)
                turns = [(f"__warmup_{i}",
                          [self.tokenizer.bos_id] + [5 + i] * (n - 1))
                         for i in range(b)]
                for name, _p in turns:
                    self._kv.release(name)
                self.generate_batch(turns, max_new_tokens=1)
        if self._kv.num_slots >= 2 and limit > MIN_SHARED_PREFIX + 8:
            shared = [self.tokenizer.bos_id] + [7] * (MIN_SHARED_PREFIX + 4)
            turns = [(f"__warmup_{i}", shared + [9 + i] * 4)
                     for i in range(2)]
            for name, _p in turns:
                self._kv.release(name)
            self.generate_batch(turns, max_new_tokens=1)
        for i in range(max(max(batch_sizes), 2)):
            self._kv.release(f"__warmup_{i}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        compile_watch.warmup_complete(self.cfg.name)
        return time.monotonic() - t0

    def generate(self, prompt, slot_name: str = "default",
                 max_new_tokens: Optional[int] = None,
                 timeout_s: float = 600.0, session=None) -> str:
        return self.generate_batch([(slot_name, prompt)],
                                   max_new_tokens=max_new_tokens,
                                   timeout_s=timeout_s, session=session)[0]

    def generate_batch(self, turns, max_new_tokens=None,
                       timeout_s: float = 600.0, sampling_per_turn=None,
                       budget=None, session=None) -> list[str]:
        return self.generate_batch_with_stats(
            turns, max_new_tokens=max_new_tokens, timeout_s=timeout_s,
            sampling_per_turn=sampling_per_turn, budget=budget,
            session=session)[0]

    def generate_batch_with_stats(self, turns, max_new_tokens=None,
                                  timeout_s: float = 600.0,
                                  sampling_per_turn=None, budget=None,
                                  session=None):
        """Serve N (slot_name, prompt) turns as one batch on every rank;
        the same keyword surface as InferenceEngine's (no LoRA). On rank 0
        under `serve` (lead()) the call is broadcast as a plan first."""
        if session:
            turns = [(scoped_slot(session, name), prompt)
                     for name, prompt in turns]
        kwargs = dict(max_new_tokens=max_new_tokens, timeout_s=timeout_s,
                      sampling_per_turn=sampling_per_turn, budget=budget)
        turns = list(turns)
        with self._serve_lock:
            if self._channel is not None and not inside_plan():
                # The followers' copy carries no budget: rank 0 decides
                # its boundaries inside the call (_agree).
                return self._channel.call(
                    ("engine", "_generate_planned", (turns,),
                     {**kwargs, "budget": None}),
                    lambda *_a, **_k: self._generate_planned(turns,
                                                             **kwargs))
            return self._generate_planned(turns, **kwargs)

    def _generate_planned(self, turns, max_new_tokens=None,
                          timeout_s: float = 600.0, sampling_per_turn=None,
                          budget=None):
        """The call every rank makes whole (under the serve lock): the
        admission gate decided on rank 0, the "turn" span, the build
        watch's window."""
        with lockstep():
            self._agree(deadlines.check_admission)
            with compile_watch.label(f"pp_serve[b={len(turns)}]",
                                     engine=self.cfg.name):
                if telemetry.ACTIVE:
                    with telemetry.span("turn", engine=self.cfg.name,
                                        rows=len(turns), pp=True):
                        return self._generate_locked(
                            turns, max_new_tokens, timeout_s,
                            sampling_per_turn, budget)
                return self._generate_locked(turns, max_new_tokens,
                                             timeout_s, sampling_per_turn,
                                             budget)

    # --- rank 0's decisions ---

    def _agree(self, check) -> None:
        """Run `check()` on rank 0 and raise what it raised on every rank
        (nothing when it passed): a decision that could end the call
        early is one rank's, broadcast."""
        import torch.distributed as dist
        box: list = [None]
        if self.mesh.rank == 0:
            try:
                check()
            except Exception as e:  # noqa: BLE001 - broadcast, re-raised
                box[0] = e
        dist.broadcast_object_list(box, src=0, group=self.mesh.pipe_group)
        if box[0] is not None:
            raise box[0]

    # --- the stage's forward ---

    def _stage(self, tokens, positions, index, offsets, kv_valid,
               last_pos, hidden, view=None):
        """This stage's layers over one microbatch (or decode step):
        `hidden` from the previous stage (None on the first, which embeds
        `tokens`); the last stage returns f32 logits [b, 1, V], the others
        their hidden states. `index`: slot ids (contiguous) or page-table
        rows (paged). On the gather view `view` is the rows' view a decode
        segment holds (None: this call gathers and scatters its own)."""
        last = self.mesh.last
        smesh = self.mesh.stage_mesh
        kw = dict(last_pos=last_pos if last else None, mesh=smesh,
                  hidden=hidden, head=last)
        with deadlines.commit_guard():
            if self.kv_layout == "contiguous":
                return forward_cached(self.params, self.cfg, tokens,
                                      positions, self._kv.layers, index,
                                      offsets, kv_valid, **kw)
            if self._pool_direct:
                return forward_paged(self.params, self.cfg, tokens,
                                     positions, self._kv.pools, index,
                                     kv_valid, **kw)
            owned = view is None
            if owned:
                view = gather_view(self._kv.pools, None, index, None,
                                   self.dtype)
            rows = torch.arange(index.shape[0], dtype=torch.int32,
                                device=self.device)
            out = forward_cached(self.params, self.cfg, tokens, positions,
                                 view, rows, offsets, kv_valid, **kw)
            if owned:
                scatter_view(self._kv.pools, None, index, view, None)
            return out

    def _ints(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int32),
                               device=self.device)

    # --- prefill ---

    def _prefill_rows(self, rows, token_lists, offsets, deadline,
                      budget=None) -> torch.Tensor:
        """Chunked, bucketed prefill of B rows (`rows`: slot ids or page
        tables), each chunk through the GPipe schedule. Rank 0 decides at
        every chunk boundary: the budget, and past the first chunk the
        deadline. Returns last-token f32 logits [B, V] on the last stage
        (a [B, 1] placeholder elsewhere)."""
        index = self._ints(rows)
        chunk_no = [0]

        def check():
            if budget is not None:
                budget.check()
            if chunk_no[0] and time.monotonic() > deadline:
                raise TimeoutError("prefill timed out")

        def dispatch(chunk, offs, lengths):
            self._agree(check)
            chunk_no[0] += 1
            b, t = chunk.shape
            n_mb = self.n_micro if b % self.n_micro == 0 else 1
            mb = b // n_mb
            tokens = self._ints(chunk).long()
            offs_t = self._ints(offs)
            lengths_t = self._ints(lengths)
            positions = offs_t[:, None] + torch.arange(
                t, dtype=torch.int32, device=self.device)[None, :]

            def stage_fn(m, x):
                r = slice(m * mb, (m + 1) * mb)
                return self._stage(tokens[r], positions[r], index[r],
                                   offs_t[r], offs_t[r] + lengths_t[r],
                                   lengths_t[r] - 1, x)

            with compile_watch.label(f"pp_prefill[b={b},bucket={t}]",
                                     engine=self.cfg.name):
                banked = run_microbatches(
                    self.mesh, n_mb, stage_fn,
                    lambda m: (mb, t, self.cfg.embed_dim),
                    stage_dtype(self.params), self.device)
            if self.mesh.last:
                return torch.cat(banked)[:, 0]
            return torch.zeros((b, 1), dtype=torch.float32,
                               device=self.device)

        return chunked_prefill(dispatch, token_lists, offsets,
                               self.max_seq_len, self.tokenizer.pad_id)

    def _sample_broadcast(self, logits, greedy, temps, top_ks,
                          top_ps) -> torch.Tensor:
        """The last stage's tokens from `logits` [B, V] (f32), on every
        rank, as a CPU int64 tensor [B]."""
        b = logits.shape[0]
        if self.mesh.last:
            if greedy:
                nxt = torch.argmax(logits, dim=-1)
            else:
                nxt = sample_token_batch(logits, self._generator, temps,
                                         top_ks, top_ps)
            box = nxt.to(torch.int64).cpu()
        else:
            box = torch.empty((b,), dtype=torch.int64)
        return broadcast_from(box, self.mesh.sampler, self.mesh.pipe_group)

    # --- decode ---

    def _decode_run(self, index, greedy, temps, top_ks, top_ps,
                    row_remaining, deadline, timeout_s, budget, max_new,
                    first: np.ndarray, start_valid: list[int]):
        """Decode segments (serving_loop.decode_segments): each step one
        hop per stage, the last stage sampling and broadcasting the
        tokens and the done flags; rank 0 decides between segments."""
        eos = self.tokenizer.eos_id
        segment = [0]
        produced = [0]

        def check():
            if budget is not None and budget.token.cancelled:
                budget.check()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"generation timed out after {timeout_s:.0f}s "
                    f"({produced[0]}/{max_new} tokens)")

        def dispatch(cur_last, cur_valid, want, done0):
            if segment[0]:
                self._agree(check)
            segment[0] += 1
            row_budgets = row_remaining(want).cpu()
            out, steps, last, valid, done = self._decode_segment(
                index, cur_last, cur_valid, want, done0, row_budgets,
                greedy, temps, top_ks, top_ps, eos)
            produced[0] += steps
            return out, steps, last, valid, done

        first_t = torch.as_tensor(first.astype(np.int32))
        valid_t = torch.as_tensor(np.asarray(start_valid, np.int32))
        return decode_segments(dispatch, first_t, valid_t, eos, max_new,
                               float("inf"), timeout_s)

    def _decode_segment(self, index, last, valid, want, done, row_budgets,
                        greedy, temps, top_ks, top_ps, eos):
        """One segment of up to min(DECODE_SEGMENT, want) steps, stopping
        once every row is done (the same loop as InferenceEngine's
        _decode_segment, its state on the host). Returns (out, steps,
        last, valid, done), CPU tensors."""
        b = last.shape[0]
        out = torch.zeros((b, DECODE_SEGMENT), dtype=torch.int32)
        step = 0
        gathered = None
        if not self._pool_direct and self.kv_layout == "paged":
            gathered = gather_view(self._kv.pools, None, index, None,
                                   self.dtype)
        try:
            while step < DECODE_SEGMENT and step < want \
                    and not bool(torch.all(done)):
                valid_d = valid.to(self.device)
                tokens = last.to(self.device).long()[:, None]
                hidden = None
                if not self.mesh.first:
                    hidden = recv_into(
                        torch.empty((b, 1, self.cfg.embed_dim),
                                    dtype=stage_dtype(self.params),
                                    device=self.device),
                        self.mesh.rank_of(self.mesh.stage - 1),
                        self.mesh.pipe_group)
                h = self._stage(tokens, valid_d[:, None], index, valid_d,
                                valid_d + 1, None, hidden, view=gathered)
                pending = None
                if not self.mesh.last:
                    pending = send_to(h, self.mesh.rank_of(
                        self.mesh.stage + 1), self.mesh.pipe_group)
                    nxt = torch.empty((b,), dtype=torch.int64)
                else:
                    row = h[:, 0].float()
                    nxt = (torch.argmax(row, dim=-1) if greedy else
                           sample_token_batch(row, self._generator, temps,
                                              top_ks, top_ps))
                    nxt = nxt.to(torch.int64).cpu()
                    nxt = torch.where(done | (step >= row_budgets),
                                      torch.tensor(eos, dtype=torch.int64),
                                      nxt)
                pack = broadcast_from(
                    torch.cat([nxt, (done | (nxt == eos)).to(torch.int64)]),
                    self.mesh.sampler, self.mesh.pipe_group)
                if pending is not None:
                    pending.wait()
                nxt = pack[:b].to(torch.int32)
                out[:, step] = nxt
                valid = torch.where(done, valid, valid + 1)
                done = pack[b:].bool()
                last = nxt
                step += 1
        finally:
            if gathered is not None:
                with deadlines.commit_guard():
                    scatter_view(self._kv.pools, None, index, gathered, None)
        return out, step, last, valid, done

    # --- prefix sharing and the prepare phase ---

    def _apply_copies(self, copies) -> None:
        """(src_slot, dst_slot, lo, hi) K/V span copies on this stage's
        layers (the slot axis is whole on every rank: no traffic)."""
        if not copies:
            return
        with deadlines.commit_guard():
            for k, v in self._kv.layers:
                for src, dst, lo, hi in copies:
                    k[dst, lo:hi] = k[src, lo:hi]
                    v[dst, lo:hi] = v[src, lo:hi]

    def _share_prefixes(self, names, slot_ids, all_tokens, offsets,
                        deadline, budget=None):
        """kvcache.share_prefixes (the main engine's donor and leader
        passes) with the stages' mechanics: span copies (contiguous) or
        page aliasing (paged), and the leader's span prefilled through
        the pipeline."""
        paged = self.kv_layout == "paged"
        pinned = tuple(names)
        copies: list[tuple[int, int, int, int]] = []

        def add_share(donor, i, lo, hi):
            if paged:
                self._kv.alias_span(donor.name, names[i], lo, hi, pinned)
            else:
                copies.append((donor.slot_id, slot_ids[i], lo, hi))

        def flush_shares():
            self._apply_copies(copies)
            copies.clear()

        def prefill_span(m, lo, hi):
            if paged:
                self._kv.ensure_capacity(names[m], hi, write_from=lo,
                                         pinned=pinned)
                rows = self._kv.table_for([names[m]])
            else:
                rows = [slot_ids[m]]
            self._prefill_rows(rows, [all_tokens[m][lo:hi]], [lo], deadline,
                               budget)

        return share_prefixes(
            self._kv, names, all_tokens, offsets,
            min_shared=MIN_SHARED_PREFIX, add_share=add_share,
            flush_shares=flush_shares, prefill_span=prefill_span)

    def _prepare_batch(self, turns, max_new_padded, deadline, pre_budget,
                       stats) -> dict:
        """tokenize + tail-truncate -> own-slot reuse_plan -> prefix-cache
        attach -> share_prefixes -> paged capacity/COW and tables, on every
        rank alike (JAX PPEngine._prepare_batch)."""
        pinned = tuple(name for name, _ in turns)
        slot_ids, offsets, all_tokens = [], [], []
        for name, prompt in turns:
            tokens = (list(prompt) if isinstance(prompt, list)
                      else self.tokenizer.encode(prompt))
            budget_tok = prompt_budget(self.max_seq_len, max_new_padded)
            if len(tokens) > budget_tok:
                tokens = tokens[:1] + tokens[len(tokens) - budget_tok + 1:]
            slot_id, reuse = self._kv.reuse_plan(name, tokens, pinned)
            slot_ids.append(slot_id)
            offsets.append(reuse)
            all_tokens.append(tokens)
        prefix_reused = 0
        if self.prefix_cache is not None:
            prefix_reused = self.prefix_cache.attach_rows(
                list(pinned), all_tokens, offsets, pinned)
        offsets, extra_prefill = self._share_prefixes(
            list(pinned), slot_ids, all_tokens, offsets, deadline,
            budget=pre_budget)
        stats.reused_tokens = sum(offsets) - extra_prefill
        stats.prefix_reused_tokens = prefix_reused
        stats.prefill_tokens = extra_prefill + sum(
            len(t) - o for t, o in zip(all_tokens, offsets))
        rows: Any = slot_ids
        if self.kv_layout == "paged":
            for i, name in enumerate(pinned):
                self._kv.ensure_capacity(
                    name, len(all_tokens[i]) + max_new_padded,
                    write_from=offsets[i], pinned=pinned)
            rows = self._kv.table_for(list(pinned))
        return {"rows": rows, "offsets": offsets, "all_tokens": all_tokens}

    def _generate_locked(self, turns, max_new_tokens, timeout_s,
                         sampling_per_turn=None, budget=None):
        stats = GenStats()
        turn_budget = budget if budget is not None \
            else deadlines.Budget.root(timeout_s, rung="turn")
        deadline = min(turn_budget.deadline, time.monotonic() + timeout_s)
        pre_budget = turn_budget.child("prefill")
        max_new, max_new_padded = clamp_max_new(
            max_new_tokens or self.sampling.max_new_tokens,
            self.max_seq_len)

        prep = self._prepare_batch(turns, max_new_padded, deadline,
                                   pre_budget, stats)
        rows, offsets = prep["rows"], prep["offsets"]
        all_tokens = prep["all_tokens"]

        t0 = time.monotonic()
        spans = [t[o:] for t, o in zip(all_tokens, offsets)]
        with telemetry.span("prefill", engine=self.cfg.name, pp=True):
            last_logits = self._prefill_rows(rows, spans, offsets, deadline,
                                             pre_budget)
            host_sync(lambda: float(last_logits[0, 0]))
        stats.prefill_seconds = time.monotonic() - t0

        per_row = sampling_per_turn or [self.sampling] * len(turns)
        if len(per_row) != len(turns):
            raise ValueError(
                f"sampling_per_turn has {len(per_row)} entries for "
                f"{len(turns)} turns")
        temps, top_ks, top_ps = sampling_arrays(per_row, self.device)
        greedy = all(p.temperature <= 0.0 for p in per_row)
        first_np = host_sync(lambda: self._sample_broadcast(
            last_logits.float(), greedy, temps, top_ks,
            top_ps).numpy().astype(np.int32))

        t1 = time.monotonic()
        dec_budget = turn_budget.child("decode")
        row_remaining = row_budget_fn(per_row, sampling_per_turn, max_new,
                                      "cpu")
        index = self._ints(rows)
        with telemetry.span("decode", engine=self.cfg.name, pp=True):
            out_np = self._decode_run(
                index, greedy, temps, top_ks, top_ps, row_remaining,
                min(deadline, dec_budget.deadline), timeout_s, dec_budget,
                max_new, first_np, [len(t) for t in all_tokens])
        stats.decode_seconds = time.monotonic() - t1

        results = finalize_outputs(
            turns, first_np, out_np, all_tokens, max_new,
            self.tokenizer.eos_id, self._kv.commit, self.tokenizer.decode,
            stats)
        stats.int4_paths = self.int4_path_report()
        trace_hooks.publish_gen_stats(stats, self.cfg.name, perf=self.perf)
        trace_hooks.publish_int4_paths(stats.int4_paths, self.cfg.name)
        trace_hooks.publish_memory_ledger(self)
        self.last_stats = stats
        return results, stats

    # --- introspection ---

    def describe(self) -> dict[str, Any]:
        """JAX's PPEngine.describe() keys and values, then the port's:
        this rank's stage, its cache bytes, the kernels' launch counts and
        this process's point-to-point totals."""
        from .distributed import p2p_counts
        info = {
            "model": self.cfg.name,
            "params": self.num_params,
            "max_seq_len": self.max_seq_len,
            "mesh": dict(self.mesh.shape),
            "n_micro": self.n_micro,
            "num_slots": self._kv.num_slots,
            "kv_layout": (f"stage-local {self.kv_layout}"
                          + (" (pool-direct)" if self._pool_direct
                             else (" (gather-view)"
                                   if self.kv_layout == "paged" else ""))),
            "attn": self.cfg.attn_impl,
            "quant": (self.quant + " (auto-degraded)"
                      if self.quant_auto_degraded else self.quant),
            "scope": "PP serving: prefill + decode with stage-local KV "
                     "(contiguous or paged pool; pool-direct "
                     "page-table kernels, incl. TP-in-stage via nested "
                     "shard_map over the model axis); flash kernels "
                     "inside stages (raw on pipe-only meshes, spmd "
                     "wrappers under TP-in-stage; dense only by opt-out "
                     "or non-partitionable heads); own-slot LCP reuse; "
                     "cross-knight donor + leader prefix sharing (page "
                     "aliasing when paged); per-row sampling; int8 "
                     "w8a16; int4 w4a16 on the fused kernels inside "
                     "stages (LOCAL_MESH / nested shard_map)",
            "devices": list(self._devices),
        }
        if self.quant == "int4":
            info["int4_paths"] = self.int4_path_report()
        if self.prefix_cache is not None:
            info["prefix_cache"] = self.prefix_cache.describe()
        info["telemetry"] = trace_hooks.engine_telemetry_view(self.cfg.name)
        info["perf"] = self.perf.describe()
        info["compile_observatory"] = compile_watch.summary()
        info.update({
            "stage": self.mesh.stage,
            "layers": [self.stage.layers(self.cfg.num_layers).start,
                       self.stage.layers(self.cfg.num_layers).stop],
            "kv_hbm_bytes": self._kv.hbm_bytes(),
            "attention_kernels": ("cuda" if self.device.type == "cuda"
                                  else "plain"),
            "kernel_launches": {**kattn.launch_counts(),
                                **int4mm.launch_counts()},
            "p2p": p2p_counts(),
        })
        return info
