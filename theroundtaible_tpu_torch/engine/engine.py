"""InferenceEngine - chunked prefill + segmented decode over persistent
per-knight KV slots, on one device (counterpart of
theroundtaible_tpu/engine/engine.py, trimmed to the single-device paths in
bf16 or f32).

Two KV layouts, as in the JAX engine. The default, "contiguous", keeps
kvcache.KVCache ([num_slots, max_seq_len, K, D] per layer): tokenize ->
own-slot LCP reuse + cross-knight prefix sharing (K/V span copies between
slots) -> chunked, bucketed prefill -> first token -> decode segments ->
eos trim, commit, detokenize, every chunk and step through
models/common.forward_cached, which writes the slots in place and attends
through K8/K9 (`attn` "auto" on a card, or "flash") or the dense math
("auto" on the CPU, or "dense"). "paged" keeps paging.PagedKVCache: prefix
sharing aliases pages, the write range is copied on write, and every chunk
and step runs paged_forward.forward_paged through K1/K2. The kernels run
as CUDA on a card and as their plain versions on the CPU.

PyTorch runs eagerly, so there are no compiled programs to warm: warmup()
builds the kernels and runs every (batch, bucket) and every ragged shape
once. The decode segment is a host loop of single-token steps. Host syncs:
the first token after prefill, the all-done flag at every decode step, and
the segment's tokens at its end. CUDA graphs are later work.

The ragged seam (_ragged_dispatch: forward_ragged through K3) serves the
continuous-batching scheduler's mixed prefill/decode dispatches; it is on
by default for the paged pool and off on the contiguous layout, as in the
JAX engine.

Quantization, as in the JAX engine: `quant` "int8"/"int4" quantizes the
weights after init (engine/quant.py; int4 products run K5/K6 at decode
by each leaf's plan, reported in `int4_paths`; on a card a leaf the
kernels decline, ROUNDTABLE_INT4_MM=0 among them, fails construction), on
both layouts. `kv_quant`
"int8"/"int4" (or {"bits", "group"}) stores the paged pool's pages
quantized (engine/kv_quant.py) and K1-K3 dequantize in-kernel (K4); a
shape K4 declines fails construction; the contiguous layout records
`kv_layout:contiguous` and serves unquantized, and ROUNDTABLE_KV_QUANT=0
restores unquantized pools. `attn: "dense"` on the paged pool serves
through the gather view (each chunk, and each decode segment, gathers its
rows' pages into a position-aligned cache, dequantized, runs the dense
forward and scatters it back, requantized), with the ragged seam off
(`attn=dense`: the JAX engine's dense ragged fallback is not ported).

Multi-LoRA personas, as in the JAX engine: a `lora:` block builds a
LoraStore (engine/lora.py; ROUNDTABLE_LORA=0 serves the base model byte
for byte), and `adapters_per_turn` names each row's persona. Every
dispatch gets one LoraBatch of adapter slots - per row for prefill chunks
and decode segments on both layouts, per token for ragged dispatches -
and the tagged projections add the deltas through K7 (the grouped einsums
for prefill rows and int8 stacks; `lora_paths` in describe()). On a card a
decode shape K7 declines, ROUNDTABLE_LORA_MM=0 among them, fails
construction. A mixed-adapter batch shares no prefix, a uniform one only
with donors of its adapter, and a slot re-served under another adapter is
released first.

Tensor parallelism, as in the JAX engine's `mesh`: `{"data": 1, "model":
m}` with m > 1 serves one model over m ranks of an initialized
torch.distributed group (engine/distributed.py), one process per device,
every rank calling the same methods in lockstep. Each rank holds its slice
of the weights (sharding.shard_params: its q/k/v heads, o_proj rows, MLP
hidden, vocab) and of the cache or pool (its kv heads); the forward
all-reduces the row-parallel products in f32 and gathers the head's
logits, so every rank samples the same tokens from the same generator.
Attention runs through the K10 wrappers (kernels/attention.py); a shape
they decline fails construction on a card. Quantized weights and LoRA
personas serve on the mesh too: each rank's int8/int4 leaves are its
slices of the whole leaves' quantization (every scale the whole leaf's;
int4 groups aligned to the shards), their products run K10e
(kernels/int4mm.einsum_int4_spmd) over K5/K6, and the LoRA store's stacks
are sharded where their base weights are, their deltas run K10f
(kernels/lora.lora_bgmv_spmd) over K7 and land on the partial products
before the one all-reduce of o_proj and down_proj. A data axis splits the
rows of a batch over its replicas (ReplicaGroupPlan): on the paged pool
each data rank holds its replica's range of pages, on the contiguous
layout its replica's block of slots (every slot where num_slots does not
divide, as JAX's _fallback_replicated), and the logits are gathered over
the data group. A "pipe" axis is PPEngine's (engine/pp_serving.py, which
get_engine builds): this engine refuses it.

Speculative decoding, as in the JAX engine: on by default where the
paged pool's ragged seam is on (`spec_decode: false` or
ROUNDTABLE_SPEC_DECODE=0 turn it off), with the drafter, tree shape and
draft length of the `spec_decode:` block (engine/spec_decode.py). The
scheduler drafts per row and scores every draft in one verify dispatch
(_ragged_dispatch with `score_width`, through K3); the `model` and `lora`
drafters shadow each row with a draft slot in the same pool and draft
through ordinary ragged dispatches. `spec_describe()` is its provenance.

The cross-session prefix cache and the host-RAM offload tier, as in the
JAX engine: a paged engine builds both by default (`prefix_cache: false` /
ROUNDTABLE_PREFIX_CACHE=0 and `kv_offload: false` / ROUNDTABLE_KV_OFFLOAD=0
turn them off; the contiguous layout has no page to share and builds
neither). `_prepare_batch` restores a spilled session before its reuse
plan (engine/kv_offload.py) and attaches every base row's longest indexed
prefix after it (engine/prefix_cache.py); commits publish complete pages
into the index, except a persona row's. The moves are whole-page gathers
and copies; attention over attached or restored pages runs K1-K3 as any
other page does. Under tensor parallelism each rank's index and tier keep
its own pool's bookkeeping, identical across ranks.

Asking for an option that is not ported raises NotImplementedError naming
its ROADMAP item (core/errors.not_ported).
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..core.errors import ITEM_7E_II, not_ported
from . import compile_watch, deadlines, faults
from . import kv_quant as kvq
from .device import resolve_device
from .kernels import attention as kattn
from .kernels import build as kbuild
from .kernels import int4mm
from .kernels import lora as klora
from .kv_offload import HostOffloadTier, offload_enabled
from .kvcache import KVCache, scoped_slot, session_of, share_prefixes
from .lora import (DEFAULT_MAX_ADAPTERS, DEFAULT_RANK, DEFAULT_SCALE,
                   LoraBatch, LoraStore, lora_enabled, note_dispatch_ids,
                   summarize_lora_paths)
from .models.common import (Int4Leaf, ModelConfig, flat_layer,
                            forward_cached, init_params, int4_sites,
                            param_count)
from .models.registry import get_model_config
from .paged_forward import (forward_paged, forward_ragged, gather_view,
                            scatter_view)
from .quant import quantize_leaves, quantize_params, quantized
from .paging import SCRATCH_PAGE, PagedKVCache
from .prefix_cache import PrefixCache, cache_enabled
from .sharding import (Mesh, build_mesh, check_mesh_axes, local_config,
                       mesh_size, model_axis_size, refuse_pipe_mesh)
from .sampling import (SamplingParams, sample_positions, sample_token_batch,
                       sampling_arrays)
from .serving_loop import (DECODE_SEGMENT, MAX_PREFILL_CHUNK,
                           PREFILL_BUCKETS, RAGGED_BLOCK_Q, RaggedSeq,
                           ReplicaGroupPlan, bucket_for,
                           build_ragged_batch, chunked_prefill,
                           clamp_max_new, decode_segments, eos_trim,
                           finalize_outputs, host_sync, note_host_sync,
                           prompt_budget,
                           ragged_defer_min, ragged_shape_grid,
                           ragged_token_budget, row_budget_fn)
from .spec_decode import (DEFAULT_MAX_DRAFT, DRAFT_SCOPE, DRAFTER_KINDS,
                          DeviceDrafter, SpecOptions, env_flag, spec_enabled)
from . import spec_decode as spec_mod
from .tokenizer import load_tokenizer
from .weights import param_count_of

# Below this many shared tokens a plain prefill beats sharing a span.
MIN_SHARED_PREFIX = 64

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _quant_mode(params: dict) -> str:
    """"none", "int8" or "int4": how a parameter tree is quantized."""
    leaves = [params["embedding"]] + [v for layer in params["layers"]
                                      for v in flat_layer(layer).values()]
    if any(isinstance(x, Int4Leaf) for x in leaves):
        return "int4"
    return "int8" if any(quantized(x) for x in leaves) else "none"


@dataclass
class GenStats:
    prefill_tokens: int = 0
    reused_tokens: int = 0
    # of reused_tokens, those the cross-session prefix cache attached
    prefix_reused_tokens: int = 0
    decode_tokens: int = 0
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    # Scheduler provenance: set only on calls served through the
    # continuous-batching SessionScheduler (queue_wait_s, segments,
    # occupancy_mean/max, sessions_max, ttft_s); None on direct calls.
    sched: Optional[dict] = None
    # int4 path provenance: which path each Int4Leaf product takes -
    # {"cuda_w4a16"|"plain_w4a16": [...], "xla_dequant": [...]}; None on
    # engines without int4 weights.
    int4_paths: Optional[dict] = None

    @property
    def prefill_tps(self) -> float:
        return self.prefill_tokens / self.prefill_seconds \
            if self.prefill_seconds else 0.0

    @property
    def decode_tps(self) -> float:
        return self.decode_tokens / self.decode_seconds \
            if self.decode_seconds else 0.0


class InferenceEngine:
    """One resident model + its slot cache (contiguous or paged) on one
    device."""

    def __init__(self, model_cfg: ModelConfig, *, checkpoint: str = "",
                 mesh_shape: Optional[dict[str, int]] = None,
                 num_slots: int = 8, dtype=torch.bfloat16,
                 sampling: Optional[SamplingParams] = None,
                 seed: int = 0, seq_parallel: int = 0,
                 attn: str = "auto", kv_layout: str = "contiguous",
                 page_size: int = 128, num_pages: Optional[int] = None,
                 quant: str = "none",
                 prefix_cache: Optional[bool] = None,
                 prefix_cache_pages: Optional[int] = None,
                 kv_offload: Optional[bool] = None,
                 ragged_attn: Optional[bool] = None,
                 spec_decode: Any = None,
                 spec_max_draft: Optional[int] = None,
                 lora: Optional[dict] = None, kv_quant: Any = None,
                 params: Optional[dict] = None,
                 devices: Optional[list[int]] = None,
                 dcn_axis: Optional[str] = None, device="cuda"):
        self.device = resolve_device(self._pinned_device(device, devices,
                                                         dcn_axis))
        self._check_ported(model_cfg, mesh_shape, dtype, seq_parallel,
                           attn, kv_layout, quant)
        # This rank's Mesh under tensor parallelism, else None (one
        # device); `local_cfg` is the slice of the model it holds.
        self.mesh = (build_mesh(mesh_shape) if mesh_size(mesh_shape) > 1
                     else None)
        self.local_cfg = local_config(model_cfg, self.mesh)
        # The forward's view of the mesh where each rank's rows are its
        # own (the contiguous slots and the gather view on a data axis):
        # the model axis alone.
        self._model_mesh = (Mesh(1, self.mesh.model, self.mesh.model_index,
                                 self.mesh.model_group)
                            if self.mesh is not None and self.mesh.model > 1
                            else None)
        if kv_layout == "contiguous":
            model_cfg = self._resolve_attn(model_cfg, attn, self.device,
                                           self._model_mesh)
        self.cfg = model_cfg
        self.max_seq_len = model_cfg.max_seq_len
        self.sampling = sampling or SamplingParams()
        self.tokenizer = load_tokenizer(checkpoint or None)
        self.quant = quant
        self.dtype = dtype
        self.kv_layout = kv_layout
        self.params = self._build_params(model_cfg, params, quant, dtype,
                                         seed, checkpoint)
        # The whole model's count, as the JAX engine's sharded tree gives
        # (a rank holds a slice).
        self.num_params = (param_count(self.params) if self.mesh is None
                           else param_count_of(self.params, model_cfg))
        # int4 path provenance, from the leaves' plans: on a card a leaf
        # K5/K6 decline fails construction, as a pool K1-K4 decline does.
        self._int4_paths = (int4mm.route_report(
            int4_sites(self.params, model_cfg), self.device)
            if quant == "int4" else None)

        # Quantized KV pages: resolved against the ROUNDTABLE_KV_QUANT kill
        # switch before the pool is built. The contiguous layout has no
        # page to quantize: it records why and serves unquantized.
        self.kv_quant_spec: Optional[kvq.KVQuantSpec] = None
        self.kv_quant_reason: Optional[str] = None
        self._kv_quant_dispatches: dict[str, int] = {}
        self._kv_quant_recent: deque = deque(maxlen=32)
        if kv_layout != "paged":
            self.kv_quant_reason = ("kv_layout:contiguous"
                                    if kv_quant and kv_quant != "none"
                                    else "disabled:config")
        else:
            self.kv_quant_spec, self.kv_quant_reason = kvq.resolve_spec(
                kv_quant)

        # The kernels see this rank's heads: its kv heads and GQA group.
        local = self.local_cfg
        group = local.num_heads // local.num_kv_heads
        # Paged decode: pool-direct through K1/K2 unless attn "dense" asks
        # for the gather view (or, under a mesh on the CPU, the heads do
        # not partition: JAX engine.py:505-550).
        self.paged_direct = kv_layout == "paged" and attn != "dense"
        if self.paged_direct and self.mesh is not None:
            self.paged_direct = self._spmd_paged_direct(model_cfg,
                                                        page_size)
        # Data replicas (JAX engine.py:567 and kv_cache_spec): each data
        # rank serves its block of the replica-grouped batch
        # (ReplicaGroupPlan) against its own range of pages, or its own
        # block of slots. JAX reports paged_replicas only for pool-direct
        # serving; the gather view builds each replica's rows' view from
        # its own range here. Slots that do not divide over "data" are
        # replicated (JAX _fallback_replicated): every data rank holds
        # every slot and serves every row.
        data = self.mesh.data if self.mesh is not None else 1
        self._paged_replicas = data if self.paged_direct else 1
        self._row_replicas = (data if kv_layout == "paged"
                              or num_slots % data == 0 else 1)
        if kv_layout == "contiguous":
            self.kv = KVCache(local, num_slots, self.max_seq_len, dtype,
                              self.device, replicas=self._row_replicas,
                              replica_index=(self.mesh.data_index
                                             if self._row_replicas > 1
                                             else 0))
        else:
            # Pool-direct serving needs both kernels to take the pool
            # shape (chunks up to MAX_PREFILL_CHUNK rows and decode steps);
            # a shape they decline fails construction.
            reason = (kattn.pool_direct_decline_reason(
                MAX_PREFILL_CHUNK, page_size, model_cfg.head_dim,
                local.num_kv_heads, group, self.device)
                if self.paged_direct else None)
            if reason is not None:
                raise ValueError(
                    f"the paged attention kernels decline this pool shape "
                    f"on {self.device}: {reason}")
            spec = self.kv_quant_spec
            if spec is not None:
                # K4's gate: a quantized pool the kernels cannot dequantize
                # in-kernel fails construction with the reason.
                reason = kattn.kv_quant_decline_reason(
                    page_size, model_cfg.head_dim, local.num_kv_heads,
                    group, spec.bits, spec.group, self.device)
                if reason is not None:
                    raise ValueError(
                        f"the paged attention kernels cannot dequantize "
                        f"this {spec.dtype_name} pool on {self.device}: "
                        f"kv_quant:{reason}")
            self.kv = PagedKVCache(local, num_slots, self.max_seq_len,
                                   dtype, self.device, page_size=page_size,
                                   num_pages=num_pages, kv_quant=spec,
                                   mesh=self.mesh)
        # The cross-session prefix cache rides the pool (commit inserts,
        # the allocator reclaims); the offload tier needs the engine. Both
        # are paged-pool subsystems, default ON (JAX engine.py:773-789).
        self.prefix_cache: Optional[PrefixCache] = None
        self.kv_offload: Optional[HostOffloadTier] = None
        if kv_layout == "paged":
            if cache_enabled(prefix_cache):
                self.prefix_cache = PrefixCache(
                    self.kv, engine=model_cfg.name,
                    max_pages=prefix_cache_pages)
                self.kv.prefix_cache = self.prefix_cache
            if offload_enabled(kv_offload):
                self.kv_offload = HostOffloadTier(self)
        # Ragged mixed prefill/decode dispatch (the scheduler's chunk-
        # interleaved admission): on by default for the paged pool;
        # ragged_attn=False or ROUNDTABLE_RAGGED_ATTN=0 turns the seam off
        # and the scheduler keeps the blocking admission prologue. A pool
        # shape K3 declines fails construction, like K1/K2: there is no
        # fallback path, so ragged_fallback_reason stays None. The flat
        # buffer addresses pages, so the contiguous layout never has the
        # seam (ragged_reason None, as in the JAX engine).
        self.ragged_enabled = False
        self.ragged_path: Optional[str] = None
        self.ragged_reason: Optional[str] = None
        self.ragged_fallback_reason: Optional[str] = None
        self.ragged_tokens = 0
        self.ragged_shapes: tuple[int, ...] = ()
        self.ragged_defer_min = 0
        self._ragged_dispatches: dict[str, int] = {}
        self._ragged_recent: deque = deque(maxlen=32)
        if kv_layout == "contiguous":
            pass
        elif not env_flag(ragged_attn, "ROUNDTABLE_RAGGED_ATTN"):
            self.ragged_reason = "disabled:config/env"
        elif self.mesh is not None and self.mesh.data > 1:
            # The pool's page axis is split over "data": a flat buffer
            # mixing replicas' rows cannot run on one rank's range.
            self.ragged_reason = "mesh:data-axis"
        elif not self.paged_direct:
            # (JAX's own dense ragged fallback is not ported: the seam is
            # off and the scheduler keeps its blocking prologue.)
            self.ragged_reason = ("attn=dense" if attn == "dense"
                                  else "heads:model-axis")
        else:
            if self.mesh is not None:
                reason = kattn.spmd_decline_reason(
                    "ragged", self.mesh,
                    (model_cfg.num_heads, model_cfg.num_kv_heads), 1,
                    RAGGED_BLOCK_Q, page_size, model_cfg.head_dim,
                    self.device)
            else:
                reason = kattn.ragged_decline_reason(
                    page_size, model_cfg.head_dim, local.num_kv_heads,
                    group, self.device)
            if reason is not None:
                raise ValueError(
                    f"the ragged attention kernel declines this pool shape "
                    f"on {self.device}: {reason}")
            self.ragged_enabled = True
            self.ragged_path = ("cuda_ragged" if self.device.type == "cuda"
                                else "plain_ragged")
            self.ragged_tokens = ragged_token_budget(num_slots)
            self.ragged_shapes = ragged_shape_grid(self.ragged_tokens)
            self.ragged_defer_min = ragged_defer_min()
        # The engine's roofline model: streamed bytes from the actual
        # (quantized) tree and the card's ceilings, published at event rate
        # by the generate and scheduler seams and embedded in describe().
        from ..utils import perfmodel
        self.perf = perfmodel.EnginePerf.from_engine(self)
        self._build_lora(lora, model_cfg, dtype)
        self._resolve_spec(spec_decode, spec_max_draft, num_slots)
        # Every rank of a mesh seeds its generator alike: the gathered
        # logits are identical, so are the sampled tokens.
        self._generator = torch.Generator(
            device=self.device).manual_seed(seed + 1)
        self._devices = self._mesh_devices()
        self._chars_per_token: Optional[float] = None
        self.last_stats = GenStats()
        # Serving mutates the slot cache: one generation at a time.
        self._serve_lock = threading.Lock()
        self.retry = faults.DEFAULT_RETRY
        # The attached SessionScheduler (scheduler.acquire_scheduler).
        self._scheduler = None
        # The build watch: every kernel library this process builds or
        # loads from here on is recorded and checked against the
        # steady-state sentinel (engine/compile_watch.py).
        compile_watch.install()

    def _spmd_paged_direct(self, cfg: ModelConfig, page_size: int) -> bool:
        """Pool-direct serving under the mesh: the K10 wrappers must
        partition the heads (else the gather view on the CPU, as the JAX
        engine; a failed construction on a card) and take the per-rank
        prefill and decode shapes (a failed construction otherwise)."""
        heads = (cfg.num_heads, cfg.num_kv_heads)
        # A data axis splits the rows (one block per replica) and the
        # pool's pages (pool_replicas).
        rows = replicas = self.mesh.data
        reason = (kattn.spmd_decline_reason(
            "prefill", self.mesh, heads, rows, MAX_PREFILL_CHUNK, page_size,
            cfg.head_dim, self.device, replicas) or kattn.spmd_decline_reason(
            "decode", self.mesh, heads, rows, 1, page_size, cfg.head_dim,
            self.device, replicas))
        if reason == "heads:model-axis" and self.device.type == "cpu":
            return False
        if reason is not None:
            raise ValueError(
                f"the paged attention kernels under mesh "
                f"{self.mesh.shape} decline this pool shape on "
                f"{self.device}: {reason}")
        return True

    def _mesh_devices(self) -> list[str]:
        """Every rank's device, in rank order (one entry without a
        mesh)."""
        if self.mesh is None:
            return [str(self.device)]
        import torch.distributed as dist
        names: list = [None] * dist.get_world_size()
        dist.all_gather_object(names, str(self.device))
        return names

    def _build_lora(self, lora, model_cfg, dtype) -> None:
        """The multi-LoRA store for a `lora:` block (None without one, or
        under ROUNDTABLE_LORA=0, with `lora_reason`), the lora_paths sink
        and the sharing bookkeeping. On a card, a target whose decode
        dispatches K7 declines fails construction, as K5/K6 do."""
        self._lora_dispatches: dict = {}
        self.lora: Optional[LoraStore] = None
        self.lora_reason: Optional[str] = None
        self._lora_tokens = 0
        self._lora_share_suppressed = 0
        # Adapter label per slot NAME: sharing never crosses slots served
        # under different adapters (the K/V bytes differ).
        self._slot_adapters: dict[str, Optional[str]] = {}
        if not lora:
            self.lora_reason = "disabled:config"
            return
        if not lora_enabled(lora):
            self.lora_reason = "disabled:env"
            return
        lora_cfg = lora if isinstance(lora, dict) else {}
        store = LoraStore(
            model_cfg,
            max_adapters=int(lora_cfg.get("max_adapters",
                                          DEFAULT_MAX_ADAPTERS)),
            rank=int(lora_cfg.get("rank", DEFAULT_RANK)),
            scale=float(lora_cfg.get("scale", DEFAULT_SCALE)),
            dtype=dtype, quant=lora_cfg.get("quant", "none"),
            adapters=lora_cfg.get("adapters"),
            targets=lora_cfg.get("targets"),
            device=self.device, mesh=self.mesh,
            engine_name=model_cfg.name, perf=self.perf)
        if self.device.type == "cuda":
            declines = store.decode_declines(dtype)
            if declines:
                hint = (" (ROUNDTABLE_LORA_MM=0)"
                        if "kernel-disabled" in declines.values() else "")
                raise ValueError(
                    f"the LoRA kernel (K7) declines the decode dispatches "
                    f"of {declines} on {self.device}{hint}")
        self.lora = store

    def _resolve_spec(self, spec_decode, spec_max_draft,
                      num_slots: int) -> None:
        """Speculative decoding's resolution (JAX engine.py:915-986,
        1030-1048): the `spec_decode:` block is validated (a bad block
        raises), speculation is on where the ragged seam is (a verify run
        is a short multi-token row of the flat buffer) unless config or
        ROUNDTABLE_SPEC_DECODE turn it off, and the tree statics size
        every verify dispatch: `spec_s_max` sequences and
        `spec_copy_slots` page copies. A drafter whose dependency is
        missing falls back to the n-gram chain with `spec_drafter_reason`
        recorded, as in the JAX engine."""
        self.spec_decode = False
        self.spec_reason: Optional[str] = None
        self.spec_options = SpecOptions.resolve(spec_decode)
        if spec_max_draft is None and self.spec_options.max_draft \
                is not None:
            spec_max_draft = self.spec_options.max_draft
        self.spec_max_draft = (DEFAULT_MAX_DRAFT if spec_max_draft is None
                               else int(spec_max_draft))
        if not 1 <= self.spec_max_draft <= RAGGED_BLOCK_Q - 1:
            raise ValueError(
                f"spec_max_draft must be 1..{RAGGED_BLOCK_Q - 1} "
                f"(verify run = drafts+1 tokens in one "
                f"{RAGGED_BLOCK_Q}-row block), got {self.spec_max_draft}")
        if (self.spec_options.tree is not None
                and self.spec_options.tree["depth"] > self.spec_max_draft):
            raise ValueError(
                f"spec_decode tree depth {self.spec_options.tree['depth']}"
                f" exceeds spec_max_draft {self.spec_max_draft} (the "
                f"static score_width must cover every root-to-leaf run)")
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_throttled = 0
        self._spec_dispatches = 0
        self._spec_tree_nodes = 0
        self._spec_tree_rows = 0
        # drafter kind -> [drafted, accepted]
        self._spec_by_drafter: dict[str, list[int]] = {}
        self._spec_recent: Optional[deque] = (
            deque(maxlen=32) if self.kv_layout == "paged" else None)
        if self.kv_layout != "paged":
            self.spec_reason = "kv_layout:contiguous"
        elif not spec_enabled(spec_decode):
            self.spec_reason = "disabled:config/env"
        elif not self.ragged_enabled:
            self.spec_reason = f"ragged:{self.ragged_reason}"
        else:
            self.spec_decode = True
        self.spec_tree = (self.spec_options.tree
                          if self.spec_decode else None)
        self.spec_branch = (self.spec_tree["branch"]
                            if self.spec_tree else 1)
        self.spec_s_max = num_slots * self.spec_branch + 1
        self.spec_copy_slots = num_slots * (self.spec_branch - 1)
        if self.spec_decode:
            self._check_verify_head()
        self.spec_drafter: Optional[str] = ("ngram" if self.spec_decode
                                            else None)
        self.spec_drafter_reason: Optional[str] = None
        self.spec_device_drafter: Optional[DeviceDrafter] = None
        if self.spec_decode and self.spec_options.drafter != "ngram":
            try:
                self._install_drafter(
                    self.spec_options.drafter,
                    adapter=self.spec_options.adapter,
                    checkpoint=self.spec_options.draft_checkpoint)
            except Exception as e:  # noqa: BLE001 - degrade, recorded
                self.spec_drafter_reason = (
                    f"{self.spec_options.drafter}:{str(e)[:120]}")

    def _check_verify_head(self) -> None:
        """On int4 weights the head of a verify dispatch sees spec_s_max *
        (spec_max_draft + 1) rows: up to 64 run K6, more take the dequant
        path by the rule every product of that many rows follows
        (`rows:prefill-m`, in int4_paths). Any other decline of that shape
        fails construction on a card."""
        if self.quant != "int4" or self.device.type != "cuda":
            return
        from .models.common import SPEC_HEAD
        head = (self.params["embedding"] if self.cfg.tie_embeddings
                else self.params["lm_head"])
        if not isinstance(head, Int4Leaf):
            return
        rows = self.spec_s_max * (self.spec_max_draft + 1)
        reason = int4mm.plan_reason(SPEC_HEAD, (rows, self.cfg.embed_dim),
                                    head)
        if reason not in (None, "rows:prefill-m"):
            raise ValueError(
                f"the w4a16 head kernel (K6) declines the verify dispatch's "
                f"{rows} rows on {self.device}: {reason}")

    def _install_drafter(self, kind: str, adapter: Optional[str] = None,
                         checkpoint: Optional[str] = None) -> None:
        """Build (or hot-swap to) the `kind` drafter: a draft-model params
        override of the engine's shapes, or a LoRA draft head in the
        engine's store. Raises when the drafter's dependency is missing;
        callers record the reason and keep the n-gram chain."""
        if kind not in DRAFTER_KINDS:
            raise ValueError(
                f"drafter must be one of {DRAFTER_KINDS}, got {kind!r}")
        if kind == "ngram":
            self.spec_device_drafter = None
            self.spec_drafter = "ngram"
            self.spec_drafter_reason = None
            return
        if kind == "model":
            draft_params = None
            if checkpoint:
                draft_params = self._load_draft_params(checkpoint)
            self.spec_device_drafter = DeviceDrafter(
                "model", params=draft_params)
        else:  # lora
            if self.lora is None:
                raise RuntimeError(
                    f"lora drafter needs a `lora:` store "
                    f"({self.lora_reason or 'disabled:config'})")
            if not adapter:
                raise ValueError("lora drafter needs an adapter name")
            if not self.lora.resolvable(adapter):
                self.lora.register(adapter)
            # The residency reference is held for the drafter's lifetime:
            # the draft head must not be evicted under a propose dispatch.
            slot = self.lora.acquire([adapter])[0]
            self.spec_device_drafter = DeviceDrafter(
                "lora", adapter_slot=slot)
            self.spec_device_drafter.adapter_id = adapter
        self.spec_drafter = kind
        self.spec_drafter_reason = None

    def set_spec_drafter(self, kind: str,
                         adapter: Optional[str] = None,
                         checkpoint: Optional[str] = None) -> None:
        """Hot-swap the active drafter. The old LoRA draft head's residency
        reference is released and the old drafter's draft slots freed.
        Raises (state unchanged) when the new drafter's dependency is
        missing or speculation is off on this engine."""
        if not self.spec_decode:
            raise RuntimeError(
                f"spec_decode is off on this engine ({self.spec_reason})")
        old = self.spec_device_drafter
        self._install_drafter(kind, adapter=adapter, checkpoint=checkpoint)
        if old is not None and old is not self.spec_device_drafter:
            if (old.kind == "lora" and self.lora is not None
                    and old.adapter_id):
                self.lora.release([old.adapter_id])
            self._release_draft_slots()

    def _release_draft_slots(self) -> None:
        """Release every shadow draft slot in the paged pool (a hot swap
        away from a device drafter; the per-row release at retire is the
        scheduler's)."""
        if self.kv_layout != "paged":
            return
        for name in self.kv.slot_names():
            if name.startswith(DRAFT_SCOPE):
                self.kv.release(name)

    def _load_draft_params(self, checkpoint: str):
        """A draft checkpoint on the engine's ModelConfig shapes, loaded
        like the engine's own weights (engine/checkpoint.py, under a mesh
        this rank's slice) and quantized as the engine is."""
        from .checkpoint import load_hf_checkpoint
        quantize = None
        if self.quant != "none":
            quantize = functools.partial(
                quantize_leaves, cfg=self.cfg, act_dtype=self.dtype,
                free_source=True, bits=8 if self.quant == "int8" else 4,
                model_shards=model_axis_size(self.mesh))
        return load_hf_checkpoint(checkpoint, self.cfg, self.dtype,
                                  self.device, self.mesh,
                                  quantize=quantize)

    def _build_params(self, cfg, params, quant: str, dtype, seed: int,
                      checkpoint: str = ""):
        """The engine's weights: `params` as given, or those of the HF
        checkpoint directory `checkpoint` (engine/checkpoint.py), or
        seeded random ones - loaded or drawn one whole layer at a time and
        quantized as `quant` says as each whole leaf arrives (JAX engine:
        after init or load, on the global arrays), under a mesh before the
        rank keeps its slice, int4 groups aligned to the model axis. A
        given tree must be quantized as `quant` says already (a bridged
        JAX tree); on one device a dense one is quantized here."""
        if params is None:
            quantize = None
            if quant != "none":
                quantize = functools.partial(
                    quantize_leaves, cfg=cfg, act_dtype=dtype,
                    free_source=True, bits=8 if quant == "int8" else 4,
                    model_shards=model_axis_size(self.mesh))
            if checkpoint:
                from .checkpoint import load_hf_checkpoint
                return load_hf_checkpoint(checkpoint, cfg, dtype,
                                          self.device, self.mesh,
                                          quantize=quantize)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return init_params(cfg, gen, dtype, self.device, self.mesh,
                               quantize=quantize)
        if checkpoint:
            raise ValueError("pass params or checkpoint, not both")
        mode = _quant_mode(params)
        if mode == quant:
            return params
        if mode != "none":
            raise ValueError(f"params are {mode}-quantized but quant is "
                             f"{quant!r}")
        if self.mesh is not None:
            raise ValueError(
                f"quant {quant!r} on a mesh needs params quantized whole "
                f"before they were sharded (weights.params_from_numpy of a "
                f"quantized tree): a rank's slice has not the whole leaf's "
                f"scales")
        return quantize_params(params, cfg, act_dtype=dtype,
                               bits=8 if quant == "int8" else 4)

    @staticmethod
    def _pinned_device(device, devices, dcn_axis):
        """`device` narrowed by the JAX engine's `devices` (indices into
        jax.devices(), which the fleet planner writes) and `dcn_axis`: one
        index selects that card, as the index of `cuda:<i>`. Several
        indices, an index with a CPU `device`, or any DCN axis are the
        multi-device options still to port."""
        if dcn_axis:
            raise not_ported(f"dcn_axis {dcn_axis!r}", ITEM_7E_II)
        if not devices:
            return device
        if len(devices) != 1:
            raise not_ported(f"devices {list(devices)} (several cards)",
                             ITEM_7E_II)
        dev = torch.device(device)
        if dev.type != "cuda":
            raise not_ported(f"devices {list(devices)} on device {dev}",
                             ITEM_7E_II)
        index = int(devices[0])
        if dev.index is not None and dev.index != index:
            raise ValueError(f"devices {list(devices)} contradicts device "
                             f"{dev}")
        return torch.device("cuda", index)

    @staticmethod
    def _check_ported(cfg, mesh_shape, dtype, seq_parallel, attn,
                      kv_layout, quant) -> None:
        """Raise NotImplementedError for every option the port does not
        serve yet, naming the ROADMAP item that brings it."""
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(
                f"kv_layout must be contiguous|paged, got {kv_layout!r}")
        if quant not in ("none", "int8", "int4"):
            raise ValueError(f"quant must be none|int8|int4, got {quant!r}")
        if seq_parallel and seq_parallel > 0:
            raise not_ported("seq_parallel (longcontext)", ITEM_7E_II)
        check_mesh_axes(mesh_shape)
        refuse_pipe_mesh(mesh_shape, "InferenceEngine")
        if attn not in ("auto", "flash", "dense"):
            raise ValueError(f"attn must be auto|flash|dense, got {attn!r}")
        if dtype not in _DTYPES.values():
            raise ValueError(f"dtype must be one of {list(_DTYPES)}, got "
                             f"{dtype}")

    @staticmethod
    def _resolve_attn(model_cfg: ModelConfig, attn: str,
                      device: torch.device, mesh=None) -> ModelConfig:
        """The contiguous layout's attention implementation (JAX
        _resolve_attn, engine.py:1149-1180): "auto" is "flash" on a card and
        "dense" on the CPU - what the JAX engine's auto gives off a TPU;
        explicit "flash"/"dense" always win ("flash" on the CPU runs the
        kernels' plain versions). On a card, a shape K8/K9 decline fails
        construction with the reason: there is no silent dense
        fallback. Under a mesh spmd_partitionable decides as in JAX:
        explicit "flash" on heads the model axis does not divide raises,
        and the per-rank shapes go through flash_attention_spmd's gate."""
        import dataclasses
        impl = attn
        if attn == "auto":
            impl = "flash" if device.type == "cuda" else "dense"
        if mesh is not None and impl == "flash":
            heads = (model_cfg.num_heads, model_cfg.num_kv_heads)
            if not kattn.spmd_partitionable(*heads, mesh.model):
                raise ValueError(
                    f"attn={attn!r} on a {mesh.model}-way model axis needs "
                    f"head counts divisible by it (got H={heads[0]}, "
                    f"K={heads[1]}) - use attn='dense'")
            reason = kattn.spmd_decline_reason(
                "flash", mesh, heads, 1, MAX_PREFILL_CHUNK, 0,
                model_cfg.head_dim, device)
            if reason is not None:
                raise ValueError(
                    f"the contiguous attention kernels (K8/K9) under mesh "
                    f"{mesh.shape} decline this shape on {device}: "
                    f"{reason}")
        elif impl == "flash":
            reason = kattn.contiguous_decline_reason(
                MAX_PREFILL_CHUNK, model_cfg.head_dim,
                model_cfg.num_heads // model_cfg.num_kv_heads, device)
            if reason is not None:
                raise ValueError(
                    f"the contiguous attention kernels (K8/K9) decline "
                    f"this shape on {device}: {reason}")
        return dataclasses.replace(model_cfg, attn_impl=impl)

    # --- construction from adapter config ---

    @classmethod
    def from_config(cls, config: dict[str, Any],
                    device="cuda") -> "InferenceEngine":
        """The JAX engine's from_config keys; `kv_layout` defaults to
        "contiguous", as in the JAX engine."""
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
        engine = cls(
            model_cfg,
            checkpoint=config.get("checkpoint", "") or "",
            mesh_shape=config.get("mesh"),
            num_slots=int(config.get("num_slots", 8)),
            dtype=_DTYPES[dtype_name],
            sampling=sampling,
            seed=int(config.get("seed", 0)),
            seq_parallel=int(config.get("seq_parallel", 0)),
            attn=config.get("attn", "auto"),
            kv_layout=config.get("kv_layout", "contiguous"),
            page_size=int(config.get("page_size", 128)),
            num_pages=(int(config["num_pages"])
                       if config.get("num_pages") else None),
            quant=config.get("quant", "none"),
            prefix_cache=config.get("prefix_cache"),
            prefix_cache_pages=(int(config["prefix_cache_pages"])
                                if config.get("prefix_cache_pages")
                                else None),
            kv_offload=config.get("kv_offload"),
            ragged_attn=config.get("ragged_attn"),
            spec_decode=config.get("spec_decode"),
            # `is not None`: spec_max_draft 0 must reach the range check.
            spec_max_draft=(int(config["spec_max_draft"])
                            if config.get("spec_max_draft") is not None
                            else None),
            lora=config.get("lora"),
            kv_quant=config.get("kv_quant"),
            devices=config.get("devices"),
            dcn_axis=config.get("dcn_axis"),
            device=device,
        )
        # Rebuild recipe: the supervisor reconstructs a dead engine from
        # exactly this config, on the engine's device - recorded here so
        # engines built outside the get_engine cache are supervisable too.
        engine._engine_config = dict(config)
        if "dispatch_retries" in config:
            engine.retry = faults.RetryPolicy(
                max_retries=max(0, int(config["dispatch_retries"])))
        return engine

    # --- serving ---

    def warmup(self, max_prompt_tokens: int = MAX_PREFILL_CHUNK,
               batch_sizes: tuple[int, ...] = (1,)) -> float:
        """Build the kernels (on a card) and serve every (batch, bucket)
        prefill shape plus one shared-prefix batch once, so the first real
        round meets no build and no first-launch cost. Warmup ends by
        declaring the engine's build set closed (compile_watch): a kernel
        build attributable to it later is a steady-state violation.
        Returns seconds."""
        t0 = time.monotonic()
        # Warming is always a sanctioned build phase, a re-warm included.
        compile_watch.reopen_warmup(self.cfg.name)
        if self.device.type == "cuda":
            kbuild.build_all()
        if self.lora is not None:
            # The store's slot writes first, as the JAX engine warms its
            # setters before the serving programs.
            self.lora.warm()
        limit = min(max_prompt_tokens, self.max_seq_len - DECODE_SEGMENT - 1)
        for b in batch_sizes:
            if b > self.kv.num_slots:
                continue
            limit_b = min(limit, self._warm_prompt_cap(b))
            if limit_b < 2:
                continue
            for bucket in [x for x in PREFILL_BUCKETS
                           if x <= bucket_for(limit_b)]:
                n = min(bucket, limit_b)  # lands exactly in `bucket`
                # Rows diverge at position 1 so prefix sharing cannot
                # collapse the batch.
                turns = [(f"__warmup_{i}",
                          [self.tokenizer.bos_id] + [5 + i] * (n - 1))
                         for i in range(b)]
                self._release_warm_slots()
                self.generate_batch(turns, max_new_tokens=1)
        if (self.kv.num_slots >= 2
                and min(limit, self._warm_prompt_cap(2))
                > MIN_SHARED_PREFIX + 8):
            shared = [self.tokenizer.bos_id] + [7] * (MIN_SHARED_PREFIX + 4)
            self._release_warm_slots()
            self.generate_batch([(f"__warmup_{i}", shared + [9 + i] * 4)
                                 for i in range(2)], max_new_tokens=1)
        self._release_warm_slots()
        if self.ragged_enabled:
            self._warm_ragged()
        if self.kv_offload is not None:
            self.kv_offload.warm()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        compile_watch.warmup_complete(self.cfg.name)
        return time.monotonic() - t0

    def _warm_ragged(self) -> None:
        """Run every flat-buffer shape of the ragged grid once through the
        real _ragged_dispatch seam (a prefill chunk plus a decode-shaped
        row), so K3 is built and launched before real traffic - greedy,
        plus the sampled mode when the engine samples by default. On a
        speculating engine also one verify-shaped batch (a run of
        spec_max_draft + 1 scored rows beside a plain row, at the engine's
        spec_s_max and copy slots) and, on a tree engine, one propose
        batch, per shape. Rows attend warm garbage; outputs are
        discarded."""
        names = ("__warmup_0", "__warmup_1")
        if self.kv.num_slots < 2:
            return
        self._release_warm_slots()
        self.kv.ensure_capacity(names[0], 32, write_from=0, pinned=names)
        self.kv.ensure_capacity(names[1], 16, write_from=0, pinned=names)
        t0 = self.kv.table_for([names[0]])[0]
        t1 = self.kv.table_for([names[1]])[0]
        bos = self.tokenizer.bos_id
        temps = [0.0]
        if self.sampling.temperature > 0.0:
            temps.append(self.sampling.temperature)
        for temp in temps:
            # (seqs, score_width, s_max, copy_slots, propose_width)
            batches = [([RaggedSeq([bos] + [5] * 23, 0, t0,
                                   temperature=temp),
                         RaggedSeq([7], 8, t1, temperature=temp)],
                        0, self.kv.num_slots + 1, 0, 0)]
            if self.spec_decode:
                r = self.spec_max_draft + 1
                batches.append((
                    [RaggedSeq([7] * r, 8, t1, temperature=temp,
                               n_scores=r),
                     RaggedSeq([9], 4, t0, temperature=temp)],
                    r, self.spec_s_max, self.spec_copy_slots, 0))
                if self.spec_branch > 1:
                    batches.append((
                        [RaggedSeq([7], 8, t1, temperature=temp),
                         RaggedSeq([9], 4, t0, temperature=temp)],
                        0, self.kv.num_slots + 1, 0, self.spec_branch))
            for seqs, score_width, s_max, copy_slots, pw in batches:
                for shape in self.ragged_shapes:
                    batch = build_ragged_batch(
                        seqs, t_budget=shape, s_max=s_max,
                        pages_per_seq=self.kv.pages_per_seq,
                        scratch_page=SCRATCH_PAGE,
                        pad_id=self.tokenizer.pad_id,
                        page_size=self.kv.page_size,
                        score_width=score_width, copy_slots=copy_slots)
                    if pw:
                        batch["propose_width"] = pw
                    self._ragged_dispatch(batch)
        self._release_warm_slots()

    def _release_warm_slots(self) -> None:
        for i in range(self.kv.num_slots):
            self.kv.release(f"__warmup_{i}")

    def _warm_prompt_cap(self, b: int) -> int:
        """Longest prompt a b-row batch can pin without exhausting the
        pool (each row pins ceil((len + DECODE_SEGMENT) / page_size)
        pages). Contiguous slots have no cap."""
        if self.kv_layout != "paged":
            return self.max_seq_len
        # Warm slots balance over the replicas: the tightest replica
        # hosts ceil(b / data) rows.
        rows = -(-b // self.kv.data_size)
        return ((self.kv.pages_per_replica() // max(rows, 1))
                * self.kv.page_size - DECODE_SEGMENT)

    def chars_per_token(self) -> float:
        if self._chars_per_token is None:
            sample = ("The quick brown fox jumps over the lazy dog. "
                      "def main(args): return 0  # typical source text\n" * 4)
            n = len(self.tokenizer.encode(sample, add_bos=False))
            self._chars_per_token = max(len(sample) / max(n, 1), 0.25)
        return self._chars_per_token

    def _ints(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int32),
                               device=self.device)

    # --- data replicas: each data rank runs its block of the rows ---

    def _local_rows(self, x, block: Optional[slice] = None):
        """This data rank's block of a replica-grouped batch's rows (the
        whole batch without data replicas); `block` (_slot_block) keeps
        only the block's real rows."""
        if block is not None:
            return x[block]
        if self._row_replicas == 1:
            return x
        g = len(x) // self._row_replicas
        r = self.mesh.data_index
        return x[r * g:(r + 1) * g]

    def _gather_rows(self, out: torch.Tensor,
                     block: Optional[tuple] = None) -> torch.Tensor:
        """Every data rank's block of a forward's output, in row order, on
        every rank: each then samples the whole batch from the same
        generator, so the host programs stay in lockstep. With `block`
        (_slot_block's (rows, block size)) the block's real rows are
        padded to the block first."""
        if self._row_replicas == 1:
            return out
        from .distributed import all_gather_cat
        if block is not None:
            rows, g = block
            n = rows.stop - rows.start
            if n < g:
                out = torch.cat([out, out.new_zeros((g - n,)
                                                    + tuple(out.shape[1:]))])
        return all_gather_cat(out, self.mesh.data_group, dim=0)

    def _slot_block(self, index) -> tuple[slice, int, torch.Tensor]:
        """(rows, block size, local slot ids) of this data rank's real rows
        in a replica-grouped slot index whose pad rows are -1: the
        contiguous layout's pads run nowhere (no slot is theirs to
        write); their outputs are zeros."""
        idx = np.asarray(index.cpu() if torch.is_tensor(index) else index)
        g = len(idx) // self._row_replicas
        r = self.mesh.data_index
        n = int((idx[r * g:(r + 1) * g] >= 0).sum())
        local = [self.kv.local_slot(int(s)) for s in idx[r * g:r * g + n]]
        return slice(r * g, r * g + n), g, self._ints(local)

    def _replica_plan(self, names: list[str],
                      bucket_group: bool = False
                      ) -> Optional[ReplicaGroupPlan]:
        """The rows' ReplicaGroupPlan with data replicas (None without):
        each row in the block of the replica holding its pages or its
        slot."""
        if self._row_replicas == 1:
            return None
        return ReplicaGroupPlan([self.kv.replica_of(n) for n in names],
                                self._row_replicas,
                                bucket_group=bucket_group)

    def _prefill(self, token_lists: list[list[int]], offsets: list[int],
                 rows, deadline: float = float("inf"),
                 budget=None, lora_ids=None) -> torch.Tensor:
        """Chunked, bucketed prefill of B rows: through forward_cached at
        the rows' slot ids (`rows` [B], contiguous layout) or through
        forward_paged over their page tables (`rows` [B, pages], paged).
        `lora_ids`: the rows' adapter slots (None: all base); one
        LoraBatch serves every chunk. Returns last-token logits [B, V].

        On data replicas the rows are replica-grouped (ReplicaGroupPlan)
        and each data rank runs its block: the paged pool's whole block
        (pad rows on the replica's scratch page), the contiguous slots'
        real rows only (pad rows are slot -1)."""
        contiguous = self.kv_layout == "contiguous"
        block = None
        if contiguous and self._row_replicas > 1:
            rows_blk, g, index = self._slot_block(rows)
            block = (rows_blk, g)
        else:
            index = self._local_rows(self._ints(rows))
            if not contiguous and not self.paged_direct:
                index = self.kv.local_table(index)

        def local(x):
            return self._local_rows(x, block and block[0])

        lora = None
        if self.lora is not None:
            lora = self._lora_args(local(
                lora_ids if lora_ids is not None
                else [0] * len(token_lists)))

        def dispatch(chunk, offs, lengths):
            with compile_watch.label(
                    f"prefill[b={chunk.shape[0]},bucket={chunk.shape[1]}]",
                    engine=self.cfg.name):
                return self._kernel_dispatch(
                    "prefill", lambda: prefill_chunk(chunk, offs, lengths),
                    kernel=not contiguous and self.paged_direct)

        def prefill_chunk(chunk, offs, lengths):
            t = chunk.shape[1]
            offs_t = local(self._ints(offs))
            lengths_t = local(self._ints(lengths))
            positions = offs_t[:, None] + torch.arange(
                t, dtype=torch.int32, device=self.device)[None, :]
            tokens = local(self._ints(chunk)).long()
            # The chunk writes the cache in place: a watchdog-abandoned
            # dispatch must not write after recovery took over.
            with deadlines.commit_guard():
                if contiguous and tokens.shape[0] == 0:
                    # a data replica with no row of this batch
                    logits = torch.zeros((0, 1, self.cfg.vocab_size),
                                         dtype=torch.float32,
                                         device=self.device)
                elif contiguous:
                    logits = forward_cached(
                        self.params, self.cfg, tokens, positions,
                        self.kv.layers, index, offs_t, offs_t + lengths_t,
                        last_pos=lengths_t - 1, lora=lora,
                        mesh=self._model_mesh)
                elif self.paged_direct:
                    logits = forward_paged(
                        self.params, self.cfg, tokens, positions,
                        self.kv.pools, index, offs_t + lengths_t,
                        last_pos=lengths_t - 1, scales=self.kv.scales,
                        quant_spec=self.kv_quant_spec, lora=lora,
                        mesh=self.mesh)
                else:
                    view = self._gather(index)
                    logits = forward_cached(
                        self.params, self.cfg, tokens, positions, view,
                        self._view_rows(index), offs_t, offs_t + lengths_t,
                        last_pos=lengths_t - 1, lora=lora,
                        mesh=self._model_mesh)
                    self._scatter(index, view)
            if not contiguous:
                self._note_kv_quant("prefill", kernel=self.paged_direct)
            return self._gather_rows(logits[:, 0], block)

        return chunked_prefill(dispatch, token_lists, offsets,
                               self.kv.max_seq_len, self.tokenizer.pad_id,
                               deadline, retry=self.retry, budget=budget)

    def _apply_copies(self, copies: list[tuple[int, int, int, int]]) -> None:
        """Apply queued (src_slot, dst_slot, lo, hi) K/V span copies in
        place, one slice copy per copy and layer (the JAX engine's
        copy_spans pads to one compiled shape; nothing compiles here).
        Sources never overlap a pass's destinations' spans (a donor's
        span ends at its own reuse frontier), so copying one by one equals
        the JAX program's simultaneous copy. On data replicas each rank
        copies the spans whose destination slot it holds; a source on
        another replica arrives over the data group, one broadcast per
        source replica, in replica order, which every rank enters (the
        bookkeeping is the same on every rank)."""
        if not copies:
            return
        kv = self.kv
        with deadlines.commit_guard():
            if self._row_replicas == 1:
                for k, v in kv.layers:
                    for src, dst, lo, hi in copies:
                        k[dst, lo:hi] = k[src, lo:hi]
                        v[dst, lo:hi] = v[src, lo:hi]
                return
            me = self.mesh.data_index
            for src, dst, lo, hi in copies:
                if kv.replica_of_slot(src) == kv.replica_of_slot(dst) == me:
                    for k, v in kv.layers:
                        k[kv.local_slot(dst), lo:hi] = k[kv.local_slot(src),
                                                         lo:hi]
                        v[kv.local_slot(dst), lo:hi] = v[kv.local_slot(src),
                                                         lo:hi]
            cross = [c for c in copies
                     if kv.replica_of_slot(c[0]) != kv.replica_of_slot(c[1])]
            kv.cross_replica_copies += len(cross)
            for r in range(self._row_replicas):
                spans = [c for c in cross if kv.replica_of_slot(c[0]) == r]
                if spans:
                    self._copy_spans_from_replica(r, spans)

    def _copy_spans_from_replica(self, r: int, spans) -> None:
        """(src, dst, lo, hi) spans whose sources sit on data replica r:
        rank r packs every layer's source cells, the data group receives
        them, and each destination's rank writes its own."""
        from .distributed import broadcast_from
        kv = self.kv
        mine = self.mesh.data_index == r
        k0 = kv.layers[0][0]
        parts = []
        for src, _dst, lo, hi in spans:
            shape = (len(kv.layers), 2, hi - lo) + tuple(k0.shape[2:])
            if mine:
                s = kv.local_slot(src)
                parts.append(torch.stack([torch.stack((k[s, lo:hi],
                                                       v[s, lo:hi]))
                                          for k, v in kv.layers]))
            else:
                parts.append(torch.empty(shape, dtype=k0.dtype,
                                         device=k0.device))
        buf = broadcast_from(torch.cat(parts, dim=2),
                             r * self.mesh.model + self.mesh.model_index,
                             self.mesh.data_group)
        at = 0
        for _src, dst, lo, hi in spans:
            n = hi - lo
            if kv.replica_of_slot(dst) == self.mesh.data_index:
                d = kv.local_slot(dst)
                for li, (k, v) in enumerate(kv.layers):
                    k[d, lo:hi] = buf[li, 0, at:at + n]
                    v[d, lo:hi] = buf[li, 1, at:at + n]
            at += n

    def _share_prefixes(self, names: list[str], slot_ids: list[int],
                        all_tokens, offsets, deadline: float, budget=None,
                        extra_pinned: tuple[str, ...] = (),
                        defer_span=None, row_adapters=None,
                        row_lora_slots=None) -> tuple[list[int], int]:
        """Cross-knight shared-prefix reuse (kvcache.share_prefixes): paged
        slots ALIAS the donor's whole pages and copy only partial boundary
        pages, contiguous slots queue K/V span copies; a batch's common
        span is prefilled once by its leader (under its adapter slot,
        `row_lora_slots`), or, with `defer_span`, recorded for the
        scheduler's ragged chunks. With `row_adapters` a donor serves only
        rows of its own adapter label."""
        paged = self.kv_layout == "paged"
        pinned = tuple(names) + tuple(extra_pinned)
        copies: list[tuple[int, int, int, int]] = []

        def add_share(donor, i, lo, hi):
            if paged:
                self.kv.alias_span(donor.name, names[i], lo, hi, pinned)
            else:
                copies.append((donor.slot_id, slot_ids[i], lo, hi))

        def flush_shares():
            self._apply_copies(copies)
            copies.clear()

        def prefill_span(m, lo, hi):
            toks, offs = [all_tokens[m][lo:hi]], [lo]
            l_ids = ([row_lora_slots[m]] if row_lora_slots is not None
                     else None)
            if paged:
                self.kv.ensure_capacity(names[m], hi, write_from=lo,
                                        pinned=pinned)
                rows = self.kv.table_for([names[m]])
                plan = self._replica_plan([names[m]])
                if plan is not None:
                    # A leader's one row pads to one row per replica.
                    rows = plan.pad_table(rows, self.kv.scratch_page)
                    toks = plan.scatter_list(toks, [self.tokenizer.pad_id])
                    offs = plan.scatter_list(offs, 0)
                    if l_ids is not None:
                        l_ids = plan.scatter_list(l_ids, 0)
            else:
                rows = [slot_ids[m]]
                plan = self._replica_plan([names[m]])
                if plan is not None:
                    # one row per replica; the others' rows are pads
                    rows = plan.scatter_list(rows, -1)
                    toks = plan.scatter_list(toks, [self.tokenizer.pad_id])
                    offs = plan.scatter_list(offs, 0)
                    if l_ids is not None:
                        l_ids = plan.scatter_list(l_ids, 0)
            self._prefill(toks, offs, rows, deadline, budget=budget,
                          lora_ids=l_ids)

        # Adapter-identity donor filter: K/V computed under one adapter is
        # wrong under another.
        donor_ok = None
        if row_adapters is not None:
            labels = self._slot_adapters

            def donor_ok(donor, i):
                return labels.get(donor.name) == row_adapters[i]

        return share_prefixes(
            self.kv, names, all_tokens, offsets,
            min_shared=MIN_SHARED_PREFIX, add_share=add_share,
            flush_shares=flush_shares, prefill_span=prefill_span,
            extra_pinned=extra_pinned, defer_span=defer_span,
            donor_ok=donor_ok)

    def _prepare_batch(self, turns, max_new_padded, deadline, pre_budget,
                       sampling_per_turn=None,
                       extra_pinned: tuple[str, ...] = (),
                       defer_prefill: bool = False, adapters=None) -> dict:
        """The pre-decode phase, one definition shared by generate_batch
        and the session scheduler's admission: restore spilled sessions ->
        tokenize + tail-truncate -> own-slot reuse_plan -> cross-session
        prefix-cache attach -> cross-knight share_prefixes -> capacity/COW
        -> chunked prefill -> first token. Returns names, slot_ids (-1 per
        paged row), all_tokens, offsets, tables_np (None on the contiguous
        layout), per_row,
        temps/top_ks/top_ps, greedy, first_np, prefill_tokens,
        reused_tokens and prefix_reused_tokens (of reused_tokens, those the
        prefix cache attached).

        `extra_pinned` names survive every eviction this phase can trigger
        (the scheduler pins its live rows). `defer_prefill` (the mixed-
        dispatch seam) stops after the host/aliasing work: the suffixes
        all_tokens[i][offsets[i]:] stay unprefilled for the scheduler's
        ragged dispatches, first_np is None and temps/top_ks/top_ps are
        None, and `share_plan` lists the deferred leader spans
        ({"leader", "lo", "hi", "followers"}). A join whose suffixes sum
        below ragged_defer_min resolves back to the prologue.

        `adapters`: per-turn LoRA adapter ids (None = base), acquired by
        the caller so residency cannot change under this call. They give
        the rows' adapter slots (`lora_slots` in the result, with
        `adapters`), the adapter-flip release, the prefix cache's
        base-rows-only filter, the mixed-adapter share suppression and the
        donor filter."""
        pinned = tuple(name for name, _ in turns) + tuple(extra_pinned)
        if self.kv_offload is not None:
            # A spilled session resumes here, before reuse_plan acquires
            # its slots: the restored tokens and pages let the LCP pass see
            # the whole committed prefix, so the turn prefills its delta.
            self.kv_offload.restore_for([n for n, _ in turns], pinned)
        ad: Optional[list] = None
        lora_slots: Optional[list[int]] = None
        if self.lora is not None:
            ad, lora_slots = self._lora_rows(turns, adapters)
        slot_ids, offsets, all_tokens = [], [], []
        for name, prompt in turns:
            # A list of ids is accepted as a pre-tokenized prompt.
            tokens = (list(prompt) if isinstance(prompt, list)
                      else self.tokenizer.encode(prompt))
            budget_tok = prompt_budget(self.max_seq_len, max_new_padded)
            if len(tokens) > budget_tok:
                # Keep the tail - the turn ask and latest transcript live
                # there.
                tokens = tokens[:1] + tokens[len(tokens) - budget_tok + 1:]
            slot_id, reuse = self.kv.reuse_plan(name, tokens, pinned)
            slot_ids.append(slot_id)
            offsets.append(reuse)
            all_tokens.append(tokens)
        names = [name for name, _ in turns]
        # Cross-session prefix cache: the content-addressed index extends
        # each row's reuse frontier past its own slot's history by aliasing
        # pages any earlier session committed. Its pages hold base-model
        # K/V, so on a LoRA batch only the base rows consult it.
        prefix_reused = 0
        if self.prefix_cache is not None:
            base = [i for i in range(len(names))
                    if lora_slots is None or lora_slots[i] == 0]
            if base:
                sub = [offsets[i] for i in base]
                prefix_reused = self.prefix_cache.attach_rows(
                    [names[i] for i in base], [all_tokens[i] for i in base],
                    sub, pinned)
                for j, i in enumerate(base):
                    offsets[i] = sub[j]
        if defer_prefill:
            # Deferral pays off only for cold prefills: after own-slot
            # reuse and the attach, a warm join's few leftover tokens cost
            # less as one blocking prefill.
            est = sum(len(t) - o for t, o in zip(all_tokens, offsets))
            if est < self.ragged_defer_min:
                defer_prefill = False
        share_plan: list[dict] = []
        defer_span = None
        if defer_prefill:
            def defer_span(m, lo, hi, followers):
                share_plan.append({"leader": m, "lo": lo, "hi": hi,
                                   "followers": followers})
        if lora_slots is not None and len(set(lora_slots)) > 1:
            # Mixed-adapter batch: no donor or leader span is valid across
            # rows of different adapters, so both share passes are off.
            self._lora_share_suppressed += 1
            leader_prefill = 0
        else:
            offsets, leader_prefill = self._share_prefixes(
                names, slot_ids, all_tokens, offsets, deadline,
                budget=pre_budget, extra_pinned=tuple(extra_pinned),
                defer_span=defer_span, row_adapters=ad,
                row_lora_slots=lora_slots)
        # Pages for the whole call (prompt + padded decode); copy-on-write
        # any shared page in the write range, so no step below allocates
        # or writes an aliased page. Deferred-share laggards skip this:
        # their span pages arrive by alias once the leader's chunks have
        # written them, and their tail capacity is ensured then
        # (scheduler._apply_share_plans) - allocating now would double the
        # pool demand of the join.
        tables_np = None
        plan = None
        if self.kv_layout == "paged":
            deferred_followers = {i for p in share_plan
                                  for i, _lo in p["followers"]}
            for i, name in enumerate(names):
                if i in deferred_followers:
                    continue
                self.kv.ensure_capacity(
                    name, len(all_tokens[i]) + max_new_padded,
                    write_from=offsets[i], pinned=pinned)
            tables_np = self.kv.table_for(names)
            # Data replicas: rows go to the block of the replica holding
            # their pages; pad rows point at that replica's scratch page
            # and start done (JAX engine.py:2307-2320).
            plan = self._replica_plan(names)
            if plan is not None:
                tables_np = plan.pad_table(tables_np, self.kv.scratch_page)
        else:
            # Slots on data replicas: rows go to the block of the replica
            # holding their slot; pad rows are slot -1 and start done.
            plan = self._replica_plan(names)
        slot_index = (plan.scatter_list(slot_ids, -1)
                      if plan is not None and tables_np is None
                      else slot_ids)
        suffixes = [t[o:] for t, o in zip(all_tokens, offsets)]
        prefill_tokens = leader_prefill + sum(len(s) for s in suffixes)
        # "reused" counts own-slot LCP hits and shared donor spans
        reused_tokens = sum(len(t) for t in all_tokens) - prefill_tokens
        common = {
            "names": names, "slot_ids": slot_ids, "all_tokens": all_tokens,
            "offsets": offsets, "tables_np": tables_np,
            "slot_index": slot_index,
            "prefill_tokens": prefill_tokens,
            "reused_tokens": reused_tokens,
            "prefix_reused_tokens": prefix_reused,
            "lora_slots": lora_slots, "adapters": ad, "plan": plan,
        }
        if defer_prefill:
            if plan is not None:
                raise RuntimeError(
                    "defer_prefill needs a pool without data replicas (the "
                    "ragged flat buffer cannot mix replicas' rows)")
            per_row = sampling_per_turn or [self.sampling] * len(turns)
            if len(per_row) != len(turns):
                raise ValueError(
                    f"sampling_per_turn has {len(per_row)} entries for "
                    f"{len(turns)} turns")
            return {**common, "per_row": per_row, "temps": None,
                    "top_ks": None, "top_ps": None,
                    "greedy": all(p.temperature <= 0.0 for p in per_row),
                    "first_np": None, "share_plan": share_plan}
        p_offsets, p_lora = offsets, lora_slots
        if plan is not None:
            suffixes = plan.scatter_list(suffixes, [self.tokenizer.pad_id])
            p_offsets = plan.scatter_list(offsets, 0)
            if p_lora is not None:
                p_lora = plan.scatter_list(p_lora, 0)
        last_logits = self._prefill(
            suffixes, p_offsets,
            tables_np if tables_np is not None else slot_index,
            deadline=deadline, budget=pre_budget, lora_ids=p_lora)
        # A blocking read (prefill time is not billed to decode), through
        # the deadline seam.
        host_sync(lambda: float(last_logits[0, 0]), pre_budget, "prefill")

        per_row = sampling_per_turn or [self.sampling] * len(turns)
        if len(per_row) != len(turns):
            raise ValueError(
                f"sampling_per_turn has {len(per_row)} entries for "
                f"{len(turns)} turns")
        temps, top_ks, top_ps = sampling_arrays(per_row, self.device)
        greedy = all(p.temperature <= 0.0 for p in per_row)
        if plan is not None:
            # The decode phase runs in the padded replica-grouped order.
            temps = plan.scatter_rows(temps, 1.0)
            top_ks = plan.scatter_rows(top_ks, 0)
            top_ps = plan.scatter_rows(top_ps, 1.0)
        logits = last_logits.float()
        if greedy:
            first = torch.argmax(logits, dim=-1)
        else:
            first = sample_token_batch(logits, self._generator, temps,
                                       top_ks, top_ps)
        first_np = host_sync(lambda: first.to(torch.int32).cpu().numpy(),
                             pre_budget, "prefill")
        if plan is not None:
            first_np = first_np[plan.pos]
        return {**common, "per_row": per_row, "temps": temps,
                "top_ks": top_ks, "top_ps": top_ps, "greedy": greedy,
                "first_np": first_np}

    def _lora_rows(self, turns, adapters) -> tuple[list, list[int]]:
        """(per-turn adapter ids, their resident slots) of a batch, with
        the adapter-flip release: a slot re-served under another adapter
        (base to persona included) must not reuse K/V computed under the
        old one, so it is released and prefills afresh."""
        ad = (list(adapters) if adapters is not None
              else [None] * len(turns))
        if len(ad) != len(turns):
            raise ValueError(f"adapters has {len(ad)} entries for "
                             f"{len(turns)} turns")
        lora_slots = []
        for a in ad:
            slot = 0 if a is None else self.lora.slot_of(a)
            if slot is None:
                raise RuntimeError(
                    f"lora adapter {a!r} is not resident - callers "
                    "acquire() adapters before _prepare_batch")
            lora_slots.append(slot)
        # Base rows label None, so "never seen" needs its own sentinel. The
        # release runs after the offload restore (_prepare_batch), or a
        # flip across a spill gap would release a name not in the pool and
        # the restore would bring back the old adapter's bytes.
        unset = object()
        for (name, _p), a in zip(turns, ad):
            prev = self._slot_adapters.get(name, unset)
            if prev is not unset and prev != a:
                self.kv.release(name)
            self._slot_adapters[name] = a
        if len(self._slot_adapters) > 4 * self.kv.num_slots:
            # Keep the labels whose K/V still exists: pool slots, this
            # batch, and sessions parked in the offload tier.
            live = set(self.kv.slot_names()) | {name for name, _ in turns}
            spilled = (set(self.kv_offload.spilled_sessions())
                       if self.kv_offload is not None else set())
            self._slot_adapters = {
                n: a_ for n, a_ in self._slot_adapters.items()
                if n in live or session_of(n) in spilled}
        return ad, lora_slots

    def _lora_args(self, ids) -> Optional[LoraBatch]:
        """One dispatch's LoraBatch: adapter slot ids per row (batched
        dispatches) or per token (ragged), checked and moved to the device
        once; None on engines without a store. Records the dispatch's
        adapter mix (lora.note_dispatch_ids)."""
        if self.lora is None:
            return None
        ids_np = np.asarray(ids, np.int32)
        note_dispatch_ids(ids_np)
        return LoraBatch(self.lora, ids_np, sink=self._lora_dispatches)

    def note_lora_tokens(self, n: int) -> None:
        """Account tokens served through a persona adapter."""
        if n > 0:
            self._lora_tokens += n

    def lora_describe(self) -> dict[str, Any]:
        """Multi-LoRA provenance (the JAX engine's keys): the resolved
        state, persona tokens served, share suppressions, and with a store
        its residency and the routes each (target, rows) took."""
        info: dict[str, Any] = {
            "enabled": self.lora is not None,
            "reason": self.lora_reason,
            "apply_tokens": self._lora_tokens,
            "share_suppressed": self._lora_share_suppressed,
        }
        if self.lora is not None:
            info["store"] = self.lora.describe()
            info["lora_paths"] = summarize_lora_paths(self._lora_dispatches,
                                                      self.device)
        return info

    def _gather(self, table: torch.Tensor) -> list:
        """The gather view of the rows' pages (attn "dense")."""
        return gather_view(self.kv.pools, self.kv.scales, table,
                           self.kv_quant_spec, self.dtype)

    def _scatter(self, table: torch.Tensor, view: list) -> None:
        scatter_view(self.kv.pools, self.kv.scales, table, view,
                     self.kv_quant_spec)

    def _kernel_dispatch(self, rung: str, run, kernel: bool = True):
        """Run one dispatch of a kernel route. The `mosaic_compile` chaos
        point fires here (a kernel-launch failure), and a kernel's build or
        launch failure is recorded (`kernel_failure` flight event) and
        surfaces classified: the port has no fallback path, so nothing is
        re-run on a plain version or another route."""
        try:
            if kernel and faults.ARMED:
                faults.maybe_inject("mosaic_compile")
            return run()
        except Exception as e:
            if faults.is_kernel_failure(e):
                from ..utils import telemetry
                telemetry.recorder().record(
                    "kernel_failure", rung=rung, engine=self.cfg.name,
                    error=str(e)[:200])
            raise

    def _view_rows(self, table: torch.Tensor) -> torch.Tensor:
        return torch.arange(table.shape[0], dtype=torch.int32,
                            device=self.device)

    def _decode_dispatch_paged(self, table, first_token, start_valid,
                               budget, temps, top_ks, top_ps, row_budgets,
                               done0, *, greedy: bool,
                               max_new: int = DECODE_SEGMENT, lora=None):
        """One paged decode segment: single-token forward_paged steps over
        the rows' page tables (_decode_segment) - or, on the gather view,
        forward_cached steps on the rows' view, gathered once before the
        segment and scattered back after it (skipped when every row is
        done already, as the JAX engine's segment is). `lora`: the rows'
        LoraBatch."""
        with compile_watch.label(f"decode[b={first_token.shape[0]},paged]",
                                 engine=self.cfg.name):
            out = self._kernel_dispatch(
                "decode", lambda: self._decode_paged_run(
                    table, first_token, start_valid, budget, temps, top_ks,
                    top_ps, row_budgets, done0, greedy, max_new, lora),
                kernel=self.paged_direct)
        self._note_kv_quant("decode", kernel=self.paged_direct)
        return out

    def _decode_paged_run(self, table, first_token, start_valid, budget,
                          temps, top_ks, top_ps, row_budgets, done0, greedy,
                          max_new, lora):
        if self.paged_direct:
            local_table = self._local_rows(table)

            def step(last, valid):
                last, valid = self._local_rows(last), self._local_rows(valid)
                return self._gather_rows(forward_paged(
                    self.params, self.cfg, last.long()[:, None],
                    valid[:, None], self.kv.pools, local_table, valid + 1,
                    scales=self.kv.scales, quant_spec=self.kv_quant_spec,
                    lora=lora, mesh=self.mesh))
            out = self._decode_segment(
                step, first_token, start_valid, budget, temps, top_ks,
                top_ps, row_budgets, done0, greedy=greedy, max_new=max_new)
        elif bool(torch.all(done0).item()):
            out = self._decode_segment(
                None, first_token, start_valid, budget, temps, top_ks,
                top_ps, row_budgets, done0, greedy=greedy, max_new=max_new)
        else:
            # The gather view of this data rank's block of rows, from its
            # own range of pages.
            local_table = self.kv.local_table(self._local_rows(table))
            view = self._gather(local_table)
            rows = self._view_rows(local_table)

            def step(last, valid):
                last, valid = self._local_rows(last), self._local_rows(valid)
                return self._gather_rows(forward_cached(
                    self.params, self.cfg, last.long()[:, None],
                    valid[:, None], view, rows, valid, valid + 1,
                    lora=lora, mesh=self._model_mesh))
            out = self._decode_segment(
                step, first_token, start_valid, budget, temps, top_ks,
                top_ps, row_budgets, done0, greedy=greedy, max_new=max_new)
            with deadlines.commit_guard():
                self._scatter(local_table, view)
        return out

    def _decode_dispatch_slots(self, slot_idx, first_token, start_valid,
                               budget, temps, top_ks, top_ps, row_budgets,
                               done0, *, greedy: bool,
                               max_new: int = DECODE_SEGMENT, lora=None):
        """Contiguous-layout counterpart of _decode_dispatch_paged:
        single-token forward_cached steps over the rows' slots `slot_idx`
        [B] int32 (the JAX engine's cached_step: write at `valid`, attend
        over valid + 1). On data replicas the index is replica-grouped
        (pads -1) and each data rank steps its block's real rows."""
        block = None
        if self._row_replicas > 1:
            rows_blk, g, slot_idx = self._slot_block(slot_idx)
            block = (rows_blk, g)

        def step(last, valid):
            if block is not None:
                last, valid = last[block[0]], valid[block[0]]
                if last.shape[0] == 0:
                    return self._gather_rows(torch.zeros(
                        (0, 1, self.cfg.vocab_size), dtype=torch.float32,
                        device=self.device), block)
            return self._gather_rows(forward_cached(
                self.params, self.cfg, last.long()[:, None],
                valid[:, None], self.kv.layers, slot_idx, valid, valid + 1,
                lora=lora, mesh=self._model_mesh), block)
        with compile_watch.label(f"decode[b={first_token.shape[0]}]",
                                 engine=self.cfg.name):
            return self._decode_segment(
                step, first_token, start_valid, budget, temps, top_ks,
                top_ps, row_budgets, done0, greedy=greedy, max_new=max_new)

    def _segment_from_host(self, host: dict):
        """One decode segment from host inputs: the padded batch's page
        table (or slots), last tokens, valid lengths, done flags, budgets,
        per-row (temperature, top_k, top_p) and full-batch adapter slots -
        what the scheduler on a mesh plans, so every rank builds the same
        call (engine/mesh_plan.py). Returns the decode seam's (out, steps,
        last, valid, done)."""
        dev = self.device
        temps, top_ks, top_ps = sampling_arrays(
            [SamplingParams(temperature=t, top_k=k, top_p=p)
             for t, k, p in host["sampling"]], dev)
        block = (self._slot_block(host["index"])[0]
                 if self.kv_layout == "contiguous" and self._row_replicas > 1
                 else None)
        lora = (self._lora_args(self._local_rows(host["lora"], block))
                if host["lora"] is not None else None)
        seam = (self._decode_dispatch_paged if self.kv_layout == "paged"
                else self._decode_dispatch_slots)
        return seam(torch.as_tensor(host["index"], device=dev),
                    self._ints(host["last"]), self._ints(host["valid"]),
                    DECODE_SEGMENT, temps, top_ks, top_ps,
                    self._ints(host["budgets"]),
                    torch.tensor(host["done"], device=dev),
                    greedy=host["greedy"], lora=lora)

    def _decode_segment(self, step_fn, first_token, start_valid, budget,
                        temps, top_ks, top_ps, row_budgets, done0, *,
                        greedy: bool, max_new: int = DECODE_SEGMENT):
        """One decode segment, once for both layouts (`step_fn(last,
        valid) -> logits [B,1,V]` is the layout's forward): up to
        min(max_new, budget) single-token steps, stopping early once every
        row is done. A row whose own budget is spent emits eos; done rows
        keep their valid length. The all-done flag is read from the device
        every step - the only host sync inside the segment. Returns (out
        [B, max_new], steps, last, valid, done)."""
        b = first_token.shape[0]

        def all_done(d) -> bool:
            note_host_sync()
            return bool(torch.all(d).item())

        out = torch.zeros((b, max_new), dtype=torch.int32,
                          device=self.device)
        eos = torch.tensor(self.tokenizer.eos_id, dtype=torch.int32,
                           device=self.device)
        last, valid, done = first_token, start_valid, done0
        step = 0
        while (step < max_new and step < budget
               and not all_done(done)):
            # Each step writes the cache in place: a watchdog-abandoned
            # segment stops here instead of writing after recovery.
            with deadlines.commit_guard():
                logits = step_fn(last, valid)
            row_logits = logits[:, 0].float()
            if greedy:
                nxt = torch.argmax(row_logits, dim=-1)
            else:
                nxt = sample_token_batch(row_logits, self._generator, temps,
                                         top_ks, top_ps)
            nxt = torch.where(done | (step >= row_budgets), eos,
                              nxt.to(torch.int32))
            out[:, step] = nxt
            valid = torch.where(done, valid, valid + 1)
            done = done | (nxt == eos)
            last = nxt
            step += 1
        return out, step, last, valid, done

    def _ragged_dispatch(self, batch: dict):
        """One mixed prefill/decode dispatch over a flat token buffer
        (serving_loop.build_ragged_batch output), the scheduler's
        chunk-interleaved admission seam: forward_ragged writes the pools
        in place under commit_guard, then each sequence's next token is its
        greedy argmax or a sample from the engine's generator. Returns the
        next-token tensor [S_max] int32 on the device; the caller reads it
        through its own watchdog seam. On a card a K3 failure raises into
        the scheduler's preempt ladder: there is no fallback path.

        Speculative decoding rides the same seam: a batch with
        `score_width` (a verify dispatch, with `sample_rows` and, on a tree
        engine, `copy_src`/`copy_dst`) returns [S_max, score_width] tokens,
        one per scored position; `propose_width` (a draft model's propose
        dispatch) returns (next [S_max], top ids [S_max, propose_width]);
        `draft_params` serves the dispatch with a draft model's weights and
        `draft` marks its provenance."""
        if not self.ragged_enabled:
            raise RuntimeError(
                f"ragged dispatch on an engine whose ragged path is off "
                f"({self.ragged_reason})")
        score_width = int(batch.get("score_width", 0) or 0)
        propose_width = int(batch.get("propose_width", 0) or 0)
        params = (batch["draft_params"]
                  if batch.get("draft_params") is not None else self.params)
        t = {k: self._ints(batch[k]) for k in (
            "tokens", "positions", "tables", "seq_of_block", "block_qstart",
            "query_offsets", "kv_valid", "token_pages", "token_offs",
            "last_rows")}
        copy = batch.get("copy_src") is not None
        with compile_watch.label(f"ragged[t={len(batch['tokens'])}]",
                                 engine=self.cfg.name):
            logits = self._kernel_dispatch(
                "ragged", lambda: self._ragged_forward(params, batch, t,
                                                       score_width, copy))
        self._note_kv_quant("ragged", kernel=True)
        return self._ragged_sample(batch, logits, score_width,
                                   propose_width)

    def _ragged_forward(self, params, batch, t, score_width, copy):
        # The dispatch writes the pools in place: a watchdog-abandoned
        # dispatch must not write after recovery took over.
        with deadlines.commit_guard():
            return forward_ragged(
                params, self.cfg, t["tokens"].long(), t["positions"],
                self.kv.pools, t["tables"], t["seq_of_block"],
                t["block_qstart"], t["query_offsets"], t["kv_valid"],
                t["token_pages"], t["token_offs"], t["last_rows"],
                sample_rows=(self._ints(batch["sample_rows"])
                             if score_width else None),
                scales=self.kv.scales, quant_spec=self.kv_quant_spec,
                copy_src=self._ints(batch["copy_src"]) if copy else None,
                copy_dst=self._ints(batch["copy_dst"]) if copy else None,
                lora=self._lora_args(batch["token_adapter"]), mesh=self.mesh)

    def _ragged_sample(self, batch, logits, score_width, propose_width):
        if score_width:
            nxt = sample_positions(
                logits, self._generator,
                torch.as_tensor(batch["temps"], device=self.device),
                torch.as_tensor(batch["top_ks"], device=self.device),
                torch.as_tensor(batch["top_ps"], device=self.device),
                greedy=batch["greedy"])
        elif batch["greedy"]:
            nxt = torch.argmax(logits, dim=-1)
        else:
            nxt = sample_token_batch(
                logits, self._generator,
                torch.as_tensor(batch["temps"], device=self.device),
                torch.as_tensor(batch["top_ks"], device=self.device),
                torch.as_tensor(batch["top_ps"], device=self.device))
        path = self.ragged_path
        self._ragged_dispatches[path] = \
            self._ragged_dispatches.get(path, 0) + 1
        entry = {"path": path, "tokens": int(batch["n_tokens"]),
                 "seqs": int(batch["n_seqs"])}
        if score_width:
            entry["spec"] = True
        if batch.get("draft"):
            entry["draft"] = True
        self._ragged_recent.append(entry)
        if propose_width:
            # A propose dispatch's logits are [S, V]: each row's top ids,
            # best first, seed the token tree's root branches.
            tops = torch.topk(logits, propose_width, dim=-1).indices
            return nxt.to(torch.int32), tops.to(torch.int32)
        return nxt.to(torch.int32)

    # --- speculative-decoding provenance ---

    def note_spec_dispatch(self, drafted: int, accepted: int,
                           rows: int, tree_nodes: int = 0,
                           tree_rows: int = 0) -> None:
        """Record one verify dispatch's acceptance outcome (the scheduler
        computes it after the read): the engine's provenance and the
        registry's `roundtable_spec_*` series, labelled by drafter."""
        from ..utils import telemetry
        self._spec_drafted += drafted
        self._spec_accepted += accepted
        self._spec_dispatches += 1
        self._spec_tree_nodes += tree_nodes
        self._spec_tree_rows += tree_rows
        drafter = self.spec_drafter or "ngram"
        # Per-drafter totals: the labelled acceptance gauge reports this
        # drafter's rate, not the blend with an earlier one's.
        d_tot = self._spec_by_drafter.setdefault(drafter, [0, 0])
        d_tot[0] += drafted
        d_tot[1] += accepted
        if self._spec_recent is not None:
            entry = {"drafted": drafted, "accepted": accepted,
                     "rows": rows, "path": self.ragged_path,
                     "drafter": drafter}
            if tree_rows:
                entry["tree_rows"] = tree_rows
                entry["tree_nodes"] = tree_nodes
            self._spec_recent.append(entry)
        spec_mod.note_spec_dispatch(drafted, accepted)
        name = self.cfg.name
        if drafted:
            telemetry.inc("roundtable_spec_drafted_tokens_total",
                          drafted, engine=name, drafter=drafter)
            telemetry.inc("roundtable_spec_rejected_tokens_total",
                          drafted - accepted, engine=name,
                          drafter=drafter)
        if accepted:
            telemetry.inc("roundtable_spec_accepted_tokens_total",
                          accepted, engine=name, drafter=drafter)
        if tree_nodes:
            telemetry.inc("roundtable_spec_tree_nodes_total",
                          tree_nodes, engine=name, drafter=drafter)
        if d_tot[0]:
            telemetry.set_gauge(
                "roundtable_spec_acceptance_rate",
                d_tot[1] / d_tot[0], engine=name, drafter=drafter)

    def note_spec_throttle(self) -> None:
        self._spec_throttled += 1

    def spec_describe(self) -> dict[str, Any]:
        """Speculative-decoding provenance (the JAX engine's keys): the
        resolved state, the active drafter and why a configured one fell
        back, the tree shape, the cumulative drafted/accepted counts and
        the recent per-dispatch ring."""
        rate = (self._spec_accepted / self._spec_drafted
                if self._spec_drafted else None)
        dd = self.spec_device_drafter
        return {
            "enabled": self.spec_decode,
            "reason": self.spec_reason,
            "drafter": self.spec_drafter,
            "drafter_reason": self.spec_drafter_reason,
            "tree": (dict(self.spec_tree) if self.spec_tree else None),
            "max_draft": self.spec_max_draft,
            "verify_dispatches": self._spec_dispatches,
            "drafted_tokens": self._spec_drafted,
            "accepted_tokens": self._spec_accepted,
            "rejected_tokens": self._spec_drafted - self._spec_accepted,
            "acceptance_rate": (round(rate, 3)
                                if rate is not None else None),
            "throttled_rows": self._spec_throttled,
            "by_drafter": {k: {"drafted": v[0], "accepted": v[1]}
                           for k, v in self._spec_by_drafter.items()},
            "tree_nodes": self._spec_tree_nodes,
            "tree_rows": self._spec_tree_rows,
            "draft_dispatches": (dd.draft_dispatches
                                 if dd is not None else 0),
            "recent": (list(self._spec_recent)[-8:]
                       if self._spec_recent is not None else []),
        }

    def _note_kv_quant(self, seam: str, kernel: bool) -> None:
        """Record one serving dispatch that read quantized pages: `kernel`
        when K1-K3 dequantized in-kernel (pool-direct, ragged), else the
        gather view dequantized at the gather, with its reason."""
        if self.kv_quant_spec is None:
            return
        kvq.note_quant_dispatch(kernel)
        path = "kernel_dequant" if kernel else "xla_dequant"
        key = f"{seam}:{path}"
        self._kv_quant_dispatches[key] = \
            self._kv_quant_dispatches.get(key, 0) + 1
        entry: dict[str, Any] = {"seam": seam, "path": path}
        if not kernel:
            entry["fallback_reason"] = "gather_view:pool-direct-off"
        self._kv_quant_recent.append(entry)

    def kv_quant_describe(self) -> dict[str, Any]:
        """Quantized-KV provenance (the JAX engine's keys): the resolved
        spec, why it is off (`reason`), the per-seam dispatch counts and
        the recent-dispatch ring, and on a quantized pool its group and
        the bytes it saves against the unquantized layout.
        `fallback_reason` stays None: a pool K4 declines fails
        construction instead of serving without the kernels."""
        spec = self.kv_quant_spec
        info: dict[str, Any] = {
            "enabled": spec is not None,
            "dtype": spec.dtype_name if spec is not None else None,
            "bits": spec.bits if spec is not None else None,
            "reason": self.kv_quant_reason,
            "fallback_reason": None,
            "dispatches": dict(self._kv_quant_dispatches),
            "recent": list(self._kv_quant_recent)[-8:],
        }
        if spec is not None and self.kv_layout == "paged":
            info["group"] = spec.effective_group(self.cfg.head_dim)
            info["bytes_saved"] = max(
                self.kv.hbm_bytes_logical() - self.kv.hbm_bytes(), 0)
        return info

    def int4_path_report(self) -> Optional[dict]:
        """Which path the Int4Leaf products take, by call site and weight
        shape (kernels/int4mm.route_report): {kernel path: [...],
        "xla_dequant": [{..., "fallback_reason"}]}, the kernel path
        "cuda_w4a16" on a card, "plain_w4a16" on the CPU. None on engines
        without int4 weights."""
        return self._int4_paths

    def ragged_describe(self) -> dict[str, Any]:
        """Ragged-path provenance: the resolved path, why the seam is off,
        the per-path dispatch counts and the recent-dispatch ring."""
        return {
            "enabled": self.ragged_enabled,
            "path": self.ragged_path,
            "reason": self.ragged_reason,
            "fallback_reason": self.ragged_fallback_reason,
            "tokens_budget": self.ragged_tokens,
            "shapes": list(self.ragged_shapes),
            "defer_min_tokens": self.ragged_defer_min,
            "dispatches": dict(self._ragged_dispatches),
            "recent": list(self._ragged_recent)[-8:],
        }

    def generate(self, prompt: str, slot_name: str = "default",
                 max_new_tokens: Optional[int] = None,
                 timeout_s: float = 600.0,
                 session: Optional[str] = None) -> str:
        return self.generate_batch([(slot_name, prompt)],
                                   max_new_tokens=max_new_tokens,
                                   timeout_s=timeout_s, session=session)[0]

    def generate_batch(self, turns: list[tuple[str, Any]],
                       max_new_tokens: Optional[int] = None,
                       timeout_s: float = 600.0,
                       sampling_per_turn: Optional[
                           list[SamplingParams]] = None,
                       budget=None,
                       session: Optional[str] = None,
                       adapters_per_turn: Optional[
                           list[Optional[str]]] = None) -> list[str]:
        return self.generate_batch_with_stats(
            turns, max_new_tokens=max_new_tokens, timeout_s=timeout_s,
            sampling_per_turn=sampling_per_turn, budget=budget,
            session=session, adapters_per_turn=adapters_per_turn)[0]

    def generate_batch_with_stats(
            self, turns: list[tuple[str, Any]],
            max_new_tokens: Optional[int] = None,
            timeout_s: float = 600.0,
            sampling_per_turn: Optional[list[SamplingParams]] = None,
            budget=None,
            session: Optional[str] = None,
            adapters_per_turn: Optional[list[Optional[str]]] = None,
    ) -> tuple[list[str], GenStats]:
        """Serve N (slot_name, prompt) turns as one batch.

        sampling_per_turn: per-row SamplingParams (None = the engine
        default); `budget`: a turn-rung deadlines.Budget (None builds a
        root from `timeout_s`); `session` namespaces the slot names so two
        discussions' same-named knights never collide;
        `adapters_per_turn`: per-row LoRA persona ids (None = base), every
        persona in one batch - ignored on engines without a store, so
        ROUNDTABLE_LORA=0 serves the base model instead of raising.
        Returns (responses, this call's stats)."""
        if session:
            turns = [(scoped_slot(session, name), prompt)
                     for name, prompt in turns]
        deadlines.check_admission()
        with self._serve_lock:
            # Residency refs for the call, under the serve lock so a swap
            # never races a dispatch; acquire() is exception-atomic, so
            # `acquired` is set only once the refs are taken.
            acquired = None
            if self.lora is not None and adapters_per_turn:
                self.lora.validate(adapters_per_turn, len(turns))
                self.lora.acquire(adapters_per_turn)
                acquired = list(adapters_per_turn)
            elif self.lora is None:
                adapters_per_turn = None
            try:
                # The "turn" rung of the span tree - the node the turn
                # Budget bounds; session/engine attrs make concurrent
                # discussions separable in one trace.
                from ..utils import telemetry
                if telemetry.ACTIVE:
                    with telemetry.span("turn", engine=self.cfg.name,
                                        rows=len(turns),
                                        session=session or "",
                                        knights=[n for n, _ in turns]):
                        return self._generate_batch_locked(
                            turns, max_new_tokens, timeout_s,
                            sampling_per_turn, budget, adapters_per_turn)
                return self._generate_batch_locked(
                    turns, max_new_tokens, timeout_s, sampling_per_turn,
                    budget, adapters_per_turn)
            finally:
                if acquired:
                    self.lora.release(acquired)

    def _generate_batch_locked(self, turns, max_new_tokens, timeout_s,
                               sampling_per_turn=None, budget=None,
                               adapters_per_turn=None):
        if faults.ARMED and len(turns) > 1:
            # Chaos point of the batched-round ladder: a "corrupted KV
            # slot" fails the fan-out before any slot bookkeeping mutates;
            # the adapter invalidates the batch's slots and retries the
            # knights serially.
            faults.maybe_inject("kv_corrupt")
        from ..utils import telemetry
        stats = GenStats()
        turn_budget = budget if budget is not None \
            else deadlines.Budget.root(timeout_s, rung="turn")
        deadline = min(turn_budget.deadline, time.monotonic() + timeout_s)
        pre_budget = turn_budget.child("prefill")
        max_new, max_new_padded = clamp_max_new(
            max_new_tokens or self.sampling.max_new_tokens,
            self.max_seq_len)

        t0 = time.monotonic()
        with telemetry.span("prefill", engine=self.cfg.name) as _psp:
            prep = self._prepare_batch(turns, max_new_padded, deadline,
                                       pre_budget, sampling_per_turn,
                                       adapters=adapters_per_turn)
            _psp.set_attr("prefill_tokens", prep["prefill_tokens"])
            _psp.set_attr("reused_tokens", prep["reused_tokens"])
        stats.prefill_tokens = prep["prefill_tokens"]
        stats.reused_tokens = prep["reused_tokens"]
        stats.prefix_reused_tokens = prep["prefix_reused_tokens"]
        stats.prefill_seconds = time.monotonic() - t0

        all_tokens = prep["all_tokens"]
        first_np = prep["first_np"]
        per_row = prep["per_row"]
        plan = prep["plan"]
        first = self._ints(first_np)
        cur_valid = self._ints([len(t) for t in all_tokens])
        if plan is not None:
            # Padded replica-grouped rows; pad rows open at eos (done).
            first = plan.scatter_rows(first, self.tokenizer.eos_id)
            cur_valid = plan.scatter_rows(cur_valid, 1)
        t1 = time.monotonic()
        dec_budget = turn_budget.child("decode")
        if self.kv_layout == "paged":
            seam = self._decode_dispatch_paged
            index = self._ints(prep["tables_np"])
        else:
            seam = self._decode_dispatch_slots
            index = self._ints(prep["slot_index"])
        row_remaining = row_budget_fn(per_row, sampling_per_turn, max_new,
                                      self.device)
        lora_slots = prep["lora_slots"]
        dec_lora = None
        if lora_slots is not None:
            dec_ids = (plan.scatter_list(lora_slots, 0) if plan is not None
                       else lora_slots)
            block = (self._slot_block(prep["slot_index"])[0]
                     if self.kv_layout == "contiguous"
                     and self._row_replicas > 1 else None)
            dec_lora = self._lora_args(self._local_rows(dec_ids, block))

        def decode_dispatch(cur_last, cur_valid, budget, done0):
            row_budgets = row_remaining(budget)
            if plan is not None:
                row_budgets = plan.scatter_rows(row_budgets, 0)
            return seam(index, cur_last, cur_valid, budget, prep["temps"],
                        prep["top_ks"], prep["top_ps"], row_budgets,
                        done0, greedy=prep["greedy"], lora=dec_lora)

        with telemetry.span("decode", engine=self.cfg.name,
                            max_new=max_new):
            out_np = decode_segments(decode_dispatch, first, cur_valid,
                                     self.tokenizer.eos_id, max_new,
                                     deadline, timeout_s, retry=self.retry,
                                     budget=dec_budget)
        if plan is not None:
            out_np = out_np[plan.pos]
        stats.decode_seconds = time.monotonic() - t1
        commit = self.kv.commit
        ad = prep["adapters"]
        if ad is not None and any(a is not None for a in ad):
            # Persona rows never feed the cross-session index: their pages
            # hold adapter-tinted K/V no other row may alias.
            base_row = {name: a is None for (name, _p), a in zip(turns, ad)}

            def commit(name, toks):
                self.kv.commit(name, toks, index=base_row[name])
        results = finalize_outputs(
            turns, first_np, out_np, all_tokens, max_new,
            self.tokenizer.eos_id, commit, self.tokenizer.decode,
            stats)
        if lora_slots and any(lora_slots):
            # Persona tokens: each persona row's prefilled suffix and its
            # eos-trimmed output.
            n = 0
            for i, sl in enumerate(lora_slots):
                if sl:
                    ids_row = eos_trim(
                        [int(first_np[i])] + [int(x) for x in out_np[i]],
                        self.tokenizer.eos_id, max_new)
                    n += len(ids_row) + len(all_tokens[i]) \
                        - prep["offsets"][i]
            self.note_lora_tokens(n)
        stats.int4_paths = self.int4_path_report()
        # The call into the registry (token and throughput counters, the
        # roofline gauges, the int4 path view) and the memory ledger at the
        # call boundary: host math over counters the call already holds.
        from . import trace_hooks
        trace_hooks.publish_gen_stats(stats, self.cfg.name, perf=self.perf)
        trace_hooks.publish_int4_paths(stats.int4_paths, self.cfg.name)
        trace_hooks.publish_memory_ledger(self)
        self.last_stats = stats
        return results, stats

    # --- introspection ---

    def describe(self) -> dict[str, Any]:
        """The JAX engine's keys for this layout (page keys, the paged
        decode path, the ragged and kv_quant blocks on the paged pool only;
        int4_paths on int4 engines; the lora block), plus the resolved
        attention, the kernels' route and launch counts."""
        paged = self.kv_layout == "paged"
        kernels = "cuda" if self.device.type == "cuda" else "plain"
        info = {
            "model": self.cfg.name,
            "params": self.num_params,
            "max_seq_len": self.max_seq_len,
            "mesh": (self.mesh.shape if self.mesh is not None
                     else {"data": 1, "model": 1}),
            "num_slots": self.kv.num_slots,
            "kv_layout": self.kv_layout,
            "quant": self.quant,
            "dtype": str(self.dtype).replace("torch.", ""),
            "devices": list(self._devices),
            "kv_hbm_bytes": self.kv.hbm_bytes(),
            "attention_kernels": kernels,
            "kernel_launches": {**kattn.launch_counts(),
                                **int4mm.launch_counts(),
                                **klora.launch_counts()},
        }
        if self.quant == "int4":
            info["int4_paths"] = self.int4_path_report()
        if paged:
            info.update({"page_size": self.kv.page_size,
                         "num_pages": self.kv.num_pages,
                         "paged_decode": ("pool-direct" if self.paged_direct
                                          else "gather-view"),
                         "paged_replicas": self._paged_replicas,
                         "ragged": self.ragged_describe(),
                         "spec_decode": self.spec_describe(),
                         "kv_quant": self.kv_quant_describe()})
            if self.prefix_cache is not None:
                info["prefix_cache"] = self.prefix_cache.describe()
            if self.kv_offload is not None:
                info["kv_offload"] = self.kv_offload.describe()
            if not self.paged_direct:
                info["attention_kernels"] = "none"
        else:
            info["attn"] = self.cfg.attn_impl
            if self.cfg.attn_impl == "dense":
                info["attention_kernels"] = "none"
        info["lora"] = self.lora_describe()
        # This engine's slice of the registry and the flight recorder, and
        # the roofline model.
        from . import trace_hooks
        info["telemetry"] = trace_hooks.engine_telemetry_view(self.cfg.name)
        info["perf"] = self.perf.describe()
        info["compile_observatory"] = compile_watch.summary()
        if self._scheduler is not None:
            info["scheduler"] = self._scheduler.describe()
        return info
