"""Transformer core shared by Gemma / Llama / Mistral / Qwen - PyTorch.

Counterpart of theroundtaible_tpu/engine/models/common.py. Parameters are a
plain dict of tensors in the JAX package's axis layouts (q_proj [E,H,D],
k_proj/v_proj [E,K,D], o_proj [H,D,E], gate/up [E,F], down [F,E],
embedding and lm_head [V,E]), so a weight tree moves between the two
packages unchanged (engine/weights.py). Numerics follow the JAX code:
norms, rope and softmax in f32, activations in the parameter dtype, and
every matrix product's result widened to f32 where the JAX code asks for an
f32 result (`preferred_element_type`).

The dense `attention`/`forward` over a position-aligned cache is the
whole-model oracle of the tests (it clones the cache it is given). Serving
runs `forward_cached` below on the contiguous layout, which writes the
cache in place and attends through K8/K9 (`attn_impl == "flash"`) or the
dense math, and paged_forward.forward_paged on the paged pool.

Every weight product goes through one quant-aware seam, `_matmul` (the
JAX package's `_einsum_base`), and returns f32, as the JAX einsums'
`preferred_element_type=f32` do: a dense weight is one 2-D product with an
f32 result (`_dense`), an int8 {"q", "s"} dict (engine/quant.py) that
product on q in the working dtype with the per-output-channel scale
applied to it, and an Int4Leaf the w4a16 kernels K5/K6
(kernels/int4mm.py) at decode-sized products, by the plan the leaf was
given when it was made, else its dequantized weight through `_dense` (the
JAX package's XLA path, which prefill always takes). Callers cast where
the JAX package's callers cast: q/k/v after the Qwen2 bias, o_proj and
down_proj after their all-reduce, the MLP's hidden after silu/gelu and the
product; the head's logits stay f32. MoE (`moe_mlp`) is not ported yet.

LoRA: the seam's call sites in `project_qkv`, `_o_proj` and `mlp` carry
their target's name, as the JAX package's `_einsum(..., lora=key)` does
(the head stays untagged). A forward given a LoraBatch (engine/lora.py)
adds each row's f32 adapter delta to the f32 product there
(lora.apply_group: one call for q/k/v, one for gate/up, o_proj and
down_proj each alone), through the kernel K7 or the grouped einsums, and
the caller rounds once, as the JAX einsum does.

Tensor parallelism (`mesh`, an engine/sharding.Mesh with a model axis
> 1): every rank holds its slice of the weights (sharding.shard_params)
and of the cache, and the forward issues the collectives XLA inserts for
the JAX package: the o_proj and down_proj partial sums are all-reduced in
f32 before the cast (JAX l.424-425, l.464-465), the vocab-sharded
embedding is a masked local lookup plus an all-reduce, and the
vocab-sharded head's f32 logits are gathered along the vocab. A dimension
the model axis does not divide is replicated and needs no collective.
Attention runs through the K10 wrappers (kernels/attention.py
flash_attention_spmd), or the dense math on the local heads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..lora import apply_group

Params = dict[str, Any]

# Masked-attention-logit sentinel - finite (not -inf) so a fully-masked row
# softmaxes to uniform instead of NaN. The CUDA kernels
# (kernels/csrc/paged_common.cuh kMaskValue) use the same value.
MASK_VALUE = -2.3819763e38

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters + family behavior flags."""

    name: str
    vocab_size: int
    num_layers: int
    embed_dim: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    mlp_dim: int
    max_seq_len: int = 8192
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    # family flags
    gelu_mlp: bool = False            # Gemma: GeGLU; Llama/Mistral: SiLU
    scale_embeddings: bool = False    # Gemma: embeddings *= sqrt(embed_dim)
    rmsnorm_unit_offset: bool = False  # Gemma: weight is (1 + w)
    post_attn_norm: bool = False      # Gemma2-style extra norms
    post_mlp_norm: bool = False
    attn_logit_softcap: Optional[float] = None   # Gemma2: 50.0
    final_logit_softcap: Optional[float] = None  # Gemma2: 30.0
    sliding_window: Optional[int] = None         # Mistral: 4096
    query_pre_attn_scalar: Optional[float] = None  # Gemma: head_dim**-0.5
    attn_bias: bool = False           # Qwen2: bias on q/k/v projections
    tie_embeddings: bool = True       # output head = embedding table
    # MoE (Mixtral): None = dense MLP; X experts, top-k routed
    num_experts: Optional[int] = None
    num_experts_per_tok: int = 2
    # Attention implementation on a position-aligned cache: "flash" runs
    # K8 (prefill chunks) and K9 (decode steps), "dense" the masked
    # softmax below (the engine's _resolve_attn picks). The paged pool
    # always runs its own kernels.
    attn_impl: str = "dense"

    @property
    def kv_repeat(self) -> int:
        return self.num_heads // self.num_kv_heads


# --- primitives ---


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             unit_offset: bool) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = weight.float()
    if unit_offset:
        w = 1.0 + w
    return (x * w).to(dtype)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) [B, T, 1, D/2] f32 of the rotary angles at `positions`
    [B, T] - the same for every layer, so a forward computes them once."""
    half = head_dim // 2
    fraction = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    timescale = theta ** fraction                            # [D/2]
    angles = positions[..., None].float() / timescale        # [B,T,D/2]
    angles = angles[:, :, None, :]                           # [B,T,1,D/2]
    return torch.sin(angles), torch.cos(angles)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         tables: Optional[tuple[torch.Tensor, torch.Tensor]] = None
         ) -> torch.Tensor:
    """Rotary position embedding. x: [B, T, H, D], positions: [B, T];
    `tables` = rope_tables(positions, D, theta) when already computed."""
    half = x.shape[-1] // 2
    sin, cos = (tables if tables is not None
                else rope_tables(positions, x.shape[-1], theta))
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


@dataclasses.dataclass
class Int4Leaf:
    """Packed w4a16 weight (engine/quant.py, bits=4): two signed nibbles
    per int8 byte along the weight's LAST axis (even element in the low
    nibble), with per-`group` absmax scales - `s4` has q4's shape except
    that the last axis holds the groups. `plan` (kernels/int4mm.Int4Plan)
    is how its products run, set once when the leaf is made
    (kernels/int4mm.plan_leaf)."""

    q4: torch.Tensor
    s4: torch.Tensor
    axis: int
    group: int
    plan: Any = None


def dequant_int4(q4: torch.Tensor, s4: torch.Tensor, axis: int, group: int,
                 dtype) -> torch.Tensor:
    """Unpack + scale a last-axis int4-packed weight back to `dtype`: each
    nibble and its group's scale in `dtype`, their product rounded to
    `dtype` (the JAX package's dequant_int4)."""
    if axis != q4.dim() - 1:
        raise ValueError("int4 pack axis must be minor-most")
    from ..kv_quant import unpack_int4
    w = unpack_int4(q4).to(dtype)                            # [..., n]
    shape = w.shape
    w = w.reshape(*shape[:-1], shape[-1] // group, group) \
        * s4[..., None].to(dtype)
    return w.reshape(shape)


# Call-site specs of the weight products (the JAX package's einsums).
# Every one contracts the activation's last n axes with the weight's first
# n, except the head, which contracts the weight's last axis.
SPEC_QKV = "bte,ehd->bthd"
SPEC_KV = "bte,ekd->btkd"
SPEC_O = "bthd,hde->bte"
SPEC_UP = "bte,ef->btf"
SPEC_DOWN = "btf,fe->bte"
SPEC_HEAD = "bte,ve->btv"
# The call site of each weight leaf, by its key (a tied head's embedding
# is the head's weight).
LEAF_SPECS = {"q_proj": SPEC_QKV, "k_proj": SPEC_KV, "v_proj": SPEC_KV,
              "o_proj": SPEC_O, "gate_proj": SPEC_UP, "up_proj": SPEC_UP,
              "down_proj": SPEC_DOWN, "embedding": SPEC_HEAD,
              "lm_head": SPEC_HEAD}
# The TP convention of each call site (the JAX package's `tp=` hints):
# "col" shards the output (no collective), "row" the contraction (one
# all-reduce, _row_parallel).
SPEC_TP = {SPEC_QKV: "col", SPEC_KV: "col", SPEC_O: "row", SPEC_UP: "col",
           SPEC_DOWN: "row", SPEC_HEAD: "col"}


def int4_sites(params: Params, cfg: ModelConfig) -> list:
    """(spec, leaf) of every Int4Leaf weight product a forward makes."""
    head = "embedding" if cfg.tie_embeddings else "lm_head"
    sites = [(LEAF_SPECS[k], v) for layer in params["layers"]
             for k, v in layer.items() if k in LEAF_SPECS]
    sites.append((SPEC_HEAD, params[head]))
    return [(spec, w) for spec, w in sites if isinstance(w, Int4Leaf)]


def plain_weights(params: Params) -> Params:
    """`params` with every Int4Leaf's products on the plain versions of
    K5/K6, on any device (how forward_*(plain=True) hold a whole path
    against the kernels); the tensors are shared."""
    def plain(x):
        if isinstance(x, Int4Leaf) and x.plan is not None:
            return dataclasses.replace(
                x, plan=dataclasses.replace(x.plan, plain=True))
        return x

    return {k: ([{n: plain(w) for n, w in layer.items()} for layer in v]
                if k == "layers" else plain(v))
            for k, v in params.items()}


def _n_contracted(spec: str) -> int:
    lhs = spec.split("->")[0]
    a_dims, b_dims = lhs.split(",")
    return sum(d in a_dims for d in b_dims)


def _mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, C] @ w [C, N] with an f32 result. On a card a bf16 GEMM writes
    f32 (torch.mm's out_dtype, aten::mm.dtype): the JAX einsum's
    preferred_element_type=f32, no rounding of the product. The CPU build
    has no kernel for that, so there the operands widen to f32 first
    (every bf16 product is exact in f32; the sums run in f32 either
    way)."""
    if a.dtype == torch.float32:
        return torch.mm(a, w.float())
    if a.is_cuda:
        return torch.mm(a, w.to(a.dtype), out_dtype=torch.float32)
    return torch.mm(a.float(), w.float())


def _dense(spec: str, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The call site's einsum as one 2-D product, f32 result."""
    if spec == SPEC_HEAD:
        out = _mm_f32(a.reshape(-1, a.shape[-1]), w.t())
        return out.reshape(*a.shape[:-1], w.shape[0])
    n = _n_contracted(spec)
    lead = a.shape[:a.dim() - n]
    c = math.prod(w.shape[:n])
    out = _mm_f32(a.reshape(-1, c), w.reshape(c, -1))
    return out.reshape(*lead, *w.shape[n:])


def _matmul(a: torch.Tensor, w, spec: str = SPEC_UP, lora=None,
            target: Optional[str] = None, mesh=None) -> torch.Tensor:
    """The weight product of the call site `spec` (SPEC_*), for a dense,
    int8 or int4 weight, plus the LoRA delta of `target` for the rows of
    `lora` (a LoraBatch, engine/lora.py). The result is f32 for every
    weight kind, as the JAX einsum's: int8 scales the f32 product per
    output channel, int4 runs K5/K6 (f32 out; K10e on this rank's shard
    under `mesh`) or the dequantized weight, a delta is added in f32.
    Callers cast to what they need next."""
    if isinstance(w, Int4Leaf):
        y = _int4_matmul(spec, a, w, mesh)
    elif isinstance(w, dict):
        y = _dense(spec, a, w["q"].to(a.dtype)) * w["s"].float()
    else:
        y = _dense(spec, a, w)
    if lora is not None:
        (y,) = apply_group((target,), a, (y,), lora)
    return y


def _int4_matmul(spec: str, a: torch.Tensor, leaf: Int4Leaf,
                 mesh=None) -> torch.Tensor:
    """An Int4Leaf product: the w4a16 kernels (K5/K6, their plain versions
    on the CPU) by the leaf's plan - under a mesh with a model axis
    through K10e (einsum_int4_spmd) on this rank's shard, which must be
    planned for that mesh, a row-parallel product's partial sum left to
    _row_parallel's one all-reduce - else (prefill rows, or on the CPU a
    leaf the plan declines) the dequantized local weight through
    torch.matmul."""
    from ..kernels import int4mm
    if _model_tp(mesh) is not None:
        y, _ = int4mm.einsum_int4_spmd(
            mesh, spec, a, leaf, tp=SPEC_TP[spec],
            w_shape=leaf.plan.w_shape if leaf.plan is not None else ())
    else:
        y, _ = int4mm.einsum_int4_or_reason(spec, a, leaf)
    if y is not None:
        return y
    w = dequant_int4(leaf.q4, leaf.s4, leaf.axis, leaf.group, a.dtype)
    return _dense(spec, a, w)


def embed_tokens(emb, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding lookup; a quantized table dequantizes only the looked-up
    rows. The result's dtype follows the table (its scales' dtype)."""
    if isinstance(emb, Int4Leaf):
        return dequant_int4(emb.q4[tokens], emb.s4[tokens], tokens.dim(),
                            emb.group, emb.s4.dtype)
    if isinstance(emb, dict):
        rows = emb["q"][tokens].to(emb["s"].dtype)
        return rows * emb["s"][tokens][..., None]
    return emb[tokens]


def _model_tp(mesh):
    """`mesh` when it has a model axis to shard over, else None."""
    return mesh if mesh is not None and mesh.model > 1 else None


def _splits(n: int, mesh) -> bool:
    """Whether the model axis of `mesh` (None: no mesh) shards a dimension
    of n (sharding.Mesh.splits)."""
    return mesh is not None and mesh.splits(n)


def embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
          mesh=None) -> torch.Tensor:
    """The scaled embedding rows of `tokens`. Under a mesh that shards the
    vocab, each rank looks up the ids inside its slice of the table (zeros
    for the rest) and one f32 all-reduce sums the rows - exact, since one
    rank contributes each row."""
    emb = params["embedding"]
    if not _splits(cfg.vocab_size, mesh):
        return scale_embeddings(embed_tokens(emb, tokens), cfg)
    from ..distributed import all_reduce_sum
    n = mesh.local(cfg.vocab_size)
    local = tokens - mesh.model_index * n
    inside = (local >= 0) & (local < n)
    rows = embed_tokens(emb, torch.where(inside, local, 0))
    part = torch.where(inside[..., None], rows.float(), 0.0)
    return scale_embeddings(
        all_reduce_sum(part, mesh.model_group).to(rows.dtype), cfg)


def project_qkv(
    x: torch.Tensor,              # [B, T, E]
    layer: Params,
    cfg: ModelConfig,
    positions: torch.Tensor,      # [B, T] absolute positions
    rope_tabs: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    lora=None,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """QKV projection + rope + query scaling. `rope_tabs`: the forward's
    rope_tables, shared by every layer; `lora`: the dispatch's LoraBatch;
    `mesh`: this rank's Mesh."""
    # f32 products; under a mesh this rank's heads (column-parallel, no
    # collective)
    q, k, v = apply_group(
        ("q_proj", "k_proj", "v_proj"), x,
        (_matmul(x, layer["q_proj"], SPEC_QKV, mesh=mesh),
         _matmul(x, layer["k_proj"], SPEC_KV, mesh=mesh),
         _matmul(x, layer["v_proj"], SPEC_KV, mesh=mesh)), lora)
    if cfg.attn_bias:  # Qwen2: linear bias applied BEFORE rotary (HF order)
        q = q + layer["q_bias"].float()
        k = k + layer["k_bias"].float()
        v = v + layer["v_bias"].float()
    if rope_tabs is None:
        rope_tabs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    q = rope(q.to(x.dtype), positions, cfg.rope_theta, rope_tabs)
    k = rope(k.to(x.dtype), positions, cfg.rope_theta, rope_tabs)
    v = v.to(x.dtype)
    scale = (cfg.query_pre_attn_scalar
             if cfg.query_pre_attn_scalar is not None
             else cfg.head_dim ** -0.5)
    return q * scale, k, v


def kv_head_index(cfg: ModelConfig, mesh, h_local: int,
                  kh_local: int) -> Optional[torch.Tensor]:
    """For dense attention on one rank's heads: the local kv head of each
    local q head, where plain GQA repetition would pair them wrongly - q
    heads sharded over the model axis while more than one kv head is
    replicated (a kv-head count the axis does not divide). None where
    repetition is right."""
    if not _splits(cfg.num_heads, mesh) or kh_local == 1 \
            or _splits(cfg.num_kv_heads, mesh):
        return None
    group = cfg.num_heads // cfg.num_kv_heads
    first = mesh.model_index * h_local
    return torch.arange(first, first + h_local) // group


def dense_attend(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                 attn_mask: torch.Tensor, cfg: ModelConfig,
                 dtype, kv_index: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """softmax(QK^T)V of q [B,T,H,D] against k/v [B,S,K,D] under the
    [B,T,S] mask, GQA by repeating kv heads (or by `kv_index`, the kv head
    of each q head: kv_head_index); [B,T,H,D] in `dtype`."""
    if kv_index is not None:
        idx = kv_index.to(k_all.device)
        k_att, v_att = k_all[:, :, idx], v_all[:, :, idx]
    else:
        repeat = q.shape[2] // k_all.shape[2]
        k_att = k_all.repeat_interleave(repeat, dim=2)
        v_att = v_all.repeat_interleave(repeat, dim=2)
    # f32 products of the working-dtype values, as the JAX einsums'
    # preferred_element_type=f32 gives
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k_att.float())
    logits = _softcap(logits, cfg.attn_logit_softcap)
    logits = torch.where(attn_mask[:, None, :, :], logits,
                         torch.tensor(MASK_VALUE, device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhts,bshd->bthd", probs.float(),
                        v_att.float()).to(dtype)


def _kernels(plain: bool):
    """(K8, K9) callables: the CUDA wrappers, or their plain versions.
    Imported here: kernels/attention imports this module."""
    from ..kernels import attention as kattn
    if plain:
        return (kattn.flash_prefill_attention_ref,
                kattn.ragged_decode_attention_ref)
    return kattn.flash_prefill_attention, kattn.ragged_decode_attention


def _flash_spmd(q, k_all, v_all, cfg: ModelConfig, offsets, kv_valid, mesh,
                plain: bool = False, rows=None) -> Optional[torch.Tensor]:
    """K8/K9 on this rank's shard (kernels/attention.flash_attention_spmd,
    its plain version with `plain`); None where the wrapper declines."""
    from ..kernels import attention as kattn
    fn = (kattn.flash_attention_spmd_ref if plain
          else kattn.flash_attention_spmd)
    return fn(mesh, q, k_all, v_all, offsets, kv_valid,
              heads=(cfg.num_heads, cfg.num_kv_heads),
              sliding_window=cfg.sliding_window,
              softcap=cfg.attn_logit_softcap, rows=rows)


def _flash(q, k_all, v_all, cfg: ModelConfig, offsets, kv_valid,
           plain: bool = False, rows=None, mesh=None) -> torch.Tensor:
    """JAX common.attention's flash branch: K8 for a chunk, K9 for one
    position; under a mesh through flash_attention_spmd, which must serve
    the call (the engine checked the shapes at construction)."""
    if _model_tp(mesh) is not None:
        out = _flash_spmd(q, k_all, v_all, cfg, offsets, kv_valid, mesh,
                          plain, rows)
        if out is None:
            raise ValueError(
                f"flash attention under mesh {mesh.shape} needs a head "
                f"layout that partitions over the model axis (H="
                f"{cfg.num_heads}, K={cfg.num_kv_heads}) and shards the "
                f"kernels take")
        return out
    prefill, decode = _kernels(plain)
    if q.shape[1] > 1:
        return prefill(q, k_all, v_all, offsets, kv_valid,
                       sliding_window=cfg.sliding_window,
                       softcap=cfg.attn_logit_softcap, rows=rows)
    return decode(q, k_all, v_all, kv_valid,
                  sliding_window=cfg.sliding_window,
                  softcap=cfg.attn_logit_softcap, rows=rows)


def _row_parallel(y: torch.Tensor, n: int, mesh, dtype) -> torch.Tensor:
    """A row-parallel product's f32 result in `dtype`: under a mesh that
    shards its contraction (of n) the partial sums are all-reduced in f32
    first, as the JAX einsum's f32 result is reduced before its cast. The
    one all-reduce of o_proj and down_proj for every weight kind: `y`
    already holds the int8 scale (its axis is never the sharded one), the
    K10e partial of an int4 weight and the K10f partial LoRA delta, whose
    stacks are sharded exactly where the weight is (engine/lora.py)."""
    if _splits(n, mesh):
        from ..distributed import all_reduce_sum
        y = all_reduce_sum(y, mesh.model_group)
    return y.to(dtype)


def _o_proj(out: torch.Tensor, layer: Params, cfg: ModelConfig,
            dtype, lora=None, mesh=None) -> torch.Tensor:
    """[B,T,H,D] attention output -> [B,T,E] in `dtype`."""
    return _row_parallel(
        _matmul(out, layer["o_proj"], SPEC_O, lora, "o_proj", mesh),
        cfg.num_heads, mesh, dtype)


def attention(
    x: torch.Tensor,              # [B, T, E]
    layer: Params,
    cfg: ModelConfig,
    positions: torch.Tensor,      # [B, T]
    kv_cache: Optional[tuple[torch.Tensor, torch.Tensor]],  # [B,S,K,D]
    cache_offset: Optional[torch.Tensor],   # [B] write offset
    attn_mask: torch.Tensor,      # [B, T, S] bool, True = attend
    rope_tabs=None,
    kv_valid: Optional[torch.Tensor] = None,  # [B] valid after the step
    lora=None,
    mesh=None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """GQA attention over a position-aligned cache. Returns (output
    [B,T,E], updated (k_cache, v_cache)); the input cache is not modified.
    With kv_cache None the k/v of this call form the cache. With
    cfg.attn_impl "flash" and kv_valid given, K8/K9 attend (their plain
    versions on the CPU; under a mesh flash_attention_spmd, whose decline
    takes the dense math on the CPU, as in JAX, and raises on a card),
    else the dense math. `lora`: the
    dispatch's LoraBatch; `mesh`: this rank's Mesh (tensor parallel)."""
    q, k, v = project_qkv(x, layer, cfg, positions, rope_tabs, lora, mesh)
    if kv_cache is not None:
        k_cache, v_cache = kv_cache[0].clone(), kv_cache[1].clone()
        t = k.shape[1]
        for row in range(k.shape[0]):
            off = int(cache_offset[row])
            k_cache[row, off:off + t] = k[row]
            v_cache[row, off:off + t] = v[row]
    else:
        k_cache, v_cache = k, v
    out = None
    if cfg.attn_impl == "flash" and kv_valid is not None:
        offsets = positions[:, 0].contiguous()
        if _model_tp(mesh) is not None and q.device.type == "cpu":
            # JAX's attention() takes the dense math where
            # flash_attention_spmd declines; on a card _flash raises
            out = _flash_spmd(q, k_cache, v_cache, cfg, offsets, kv_valid,
                              mesh)
        else:
            out = _flash(q, k_cache, v_cache, cfg, offsets, kv_valid,
                         mesh=mesh)
    if out is None:
        out = dense_attend(q, k_cache, v_cache, attn_mask, cfg, x.dtype,
                           kv_head_index(cfg, mesh, q.shape[2],
                                         k_cache.shape[2]))
    return _o_proj(out, layer, cfg, x.dtype, lora, mesh), (k_cache, v_cache)


def mlp(x: torch.Tensor, layer: Params, cfg: ModelConfig,
        lora=None, mesh=None) -> torch.Tensor:
    """Gated MLP (JAX l.456-465): gate and up stay f32 through silu/gelu
    and their product, the hidden is cast to x's dtype, down_proj's f32
    result (all-reduced under a mesh that shards the hidden) is cast
    last."""
    if cfg.num_experts:
        raise NotImplementedError(
            "MoE (moe_mlp) is not ported yet (ROADMAP, slice 7)")
    gate, up = apply_group(
        ("gate_proj", "up_proj"), x,
        (_matmul(x, layer["gate_proj"], SPEC_UP, mesh=mesh),
         _matmul(x, layer["up_proj"], SPEC_UP, mesh=mesh)), lora)
    act = (F.gelu(gate, approximate="tanh") if cfg.gelu_mlp
           else F.silu(gate))
    hidden = (act * up).to(x.dtype)
    return _row_parallel(
        _matmul(hidden, layer["down_proj"], SPEC_DOWN, lora, "down_proj",
                mesh),
        cfg.mlp_dim, mesh, x.dtype)


def transformer_block(
    x: torch.Tensor, layer: Params, cfg: ModelConfig,
    positions: torch.Tensor, kv_cache, cache_offset, attn_mask,
    attn_fn: Optional[Callable] = None, rope_tabs=None, kv_valid=None,
    lora=None, mesh=None,
) -> tuple[torch.Tensor, Any]:
    """One block. `attn_fn(h, layer) -> (out, cache)`, when given,
    replaces `attention` - the hook forward_cached and paged_forward use,
    so the norm/residual/MLP wiring and every family flag live in one
    place (a hook applies `lora` and `mesh` itself). `lora`: the
    dispatch's LoraBatch; `mesh`: this rank's Mesh."""
    h = rms_norm(x, layer["input_norm"], cfg.norm_eps,
                 cfg.rmsnorm_unit_offset)
    if attn_fn is None:
        attn_out, new_cache = attention(h, layer, cfg, positions, kv_cache,
                                        cache_offset, attn_mask, rope_tabs,
                                        kv_valid=kv_valid, lora=lora,
                                        mesh=mesh)
    else:
        attn_out, new_cache = attn_fn(h, layer)
    if cfg.post_attn_norm:
        attn_out = rms_norm(attn_out, layer["post_attn_norm"], cfg.norm_eps,
                            cfg.rmsnorm_unit_offset)
    x = x + attn_out
    h = rms_norm(x, layer["pre_mlp_norm"], cfg.norm_eps,
                 cfg.rmsnorm_unit_offset)
    mlp_out = mlp(h, layer, cfg, lora, mesh)
    if cfg.post_mlp_norm:
        mlp_out = rms_norm(mlp_out, layer["post_mlp_norm"], cfg.norm_eps,
                           cfg.rmsnorm_unit_offset)
    return x + mlp_out, new_cache


def make_attention_mask(positions: torch.Tensor, kv_len: int,
                        kv_valid_len: torch.Tensor,
                        sliding_window: Optional[int]) -> torch.Tensor:
    """Causal (+ optional sliding window) mask against a position-aligned
    cache of kv_len entries: pos_kv <= pos_q and s < valid."""
    kv_pos = torch.arange(kv_len, device=positions.device)[None, None, :]
    q_pos = positions[:, :, None]
    mask = (kv_pos <= q_pos) & (kv_pos < kv_valid_len[:, None, None])
    if sliding_window is not None:
        mask &= kv_pos > q_pos - sliding_window
    return mask


def scale_embeddings(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if not cfg.scale_embeddings:
        return x
    return x * torch.tensor(math.sqrt(cfg.embed_dim),
                            dtype=torch.float32).to(x.dtype)


def lm_head(params: Params, cfg: ModelConfig, x: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """Final-normed hidden [B,T,E] -> f32 logits [B,T,V] (softcapped; JAX
    l.591-593). Under a mesh that shards the vocab each rank's f32 logits
    of its slice are gathered along the vocab (identical on every
    rank)."""
    head = params["embedding"] if cfg.tie_embeddings else params["lm_head"]
    logits = _matmul(x, head, SPEC_HEAD, mesh=mesh)
    if _splits(cfg.vocab_size, mesh):
        from ..distributed import all_gather_cat
        logits = all_gather_cat(logits, mesh.model_group, dim=-1)
    return _softcap(logits, cfg.final_logit_softcap)


def forward(
    params: Params, cfg: ModelConfig,
    tokens: torch.Tensor,          # [B, T]
    positions: torch.Tensor,       # [B, T]
    kv_caches: Optional[list[tuple[torch.Tensor, torch.Tensor]]],
    cache_offset: Optional[torch.Tensor],   # [B]
    kv_valid_len: torch.Tensor,    # [B] valid entries AFTER this step
    last_pos: Optional[torch.Tensor] = None,   # [B] row index into T
    lora=None,
    mesh=None,
) -> tuple[torch.Tensor, list[tuple[torch.Tensor, torch.Tensor]]]:
    """Full model forward over a position-aligned cache. Returns (logits
    [B,T,V] - [B,1,V] when `last_pos` is given, gathered before the head -
    and the updated caches). `lora`: a LoraBatch with one adapter slot per
    row; `mesh`: this rank's Mesh, with `params` and the caches its
    shards."""
    x = embed(params, cfg, tokens, mesh)
    kv_len = (kv_caches[0][0].shape[1] if kv_caches is not None
              else tokens.shape[1])
    mask = make_attention_mask(positions, kv_len, kv_valid_len,
                               cfg.sliding_window)
    tabs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    new_caches = []
    for i, layer in enumerate(params["layers"]):
        cache_i = kv_caches[i] if kv_caches is not None else None
        x, new_cache = transformer_block(x, layer, cfg, positions, cache_i,
                                         cache_offset, mask, rope_tabs=tabs,
                                         kv_valid=kv_valid_len, lora=lora,
                                         mesh=mesh)
        new_caches.append(new_cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 cfg.rmsnorm_unit_offset)
    if last_pos is not None:
        x = gather_rows(x, last_pos)
    return lm_head(params, cfg, x, mesh), new_caches


def _check_cached_write(rows: torch.Tensor, offsets: torch.Tensor, t: int,
                        n_rows: int, s: int) -> None:
    """Every row writes cache row rows[b], positions offsets[b] ..
    offsets[b]+t-1, inside the cache. JAX's dynamic_update_slice clamps a
    start that would overrun (overwriting earlier cells) and its gather
    clamps a row index; here an overrun raises. Index tensors on the CPU
    are checked here; on a card the in-place write's own bounds check
    raises at the next synchronisation (the engine's bucket shrink and
    prompt budget keep every write inside, without a host read per
    step)."""
    if rows.device.type != "cpu" or offsets.device.type != "cpu":
        return
    if rows.numel() and (int(rows.min()) < 0 or int(rows.max()) >= n_rows):
        raise IndexError(f"rows {rows.tolist()} outside the cache's "
                         f"{n_rows} rows")
    if offsets.numel() and (int(offsets.min()) < 0
                            or int(offsets.max()) + t > s):
        raise IndexError(f"a {t}-token write at offsets {offsets.tolist()} "
                         f"overruns the {s}-position cache")


def forward_cached(
    params: Params, cfg: ModelConfig,
    tokens: torch.Tensor,          # [B, T] (T == 1: a decode step)
    positions: torch.Tensor,       # [B, T] absolute positions
    cache_layers: list,            # per-layer (k, v) [num_slots, S, K, D]
    rows: torch.Tensor,            # [B] int32 cache row (slot) of each row
    offsets: torch.Tensor,         # [B] int32 write offset (= positions[:, 0])
    kv_valid: torch.Tensor,        # [B] int32 valid entries AFTER this call
    last_pos: Optional[torch.Tensor] = None,   # [B] row index into T
    plain: bool = False,
    lora=None,
    mesh=None,
) -> torch.Tensor:
    """One serving step against the contiguous cache - a prefill chunk or a
    decode step; the counterpart of the JAX engine's prefill_step and
    cached_step around `forward`. Each layer writes this call's K/V in
    place into cache[rows, offsets:offsets+T], then attends through K8/K9
    reading the slots in place through `rows` (cfg.attn_impl "flash";
    `plain=True`: their plain versions, and those of K5/K6 for int4
    weights, on any device) or through the
    dense masked softmax over the rows' gathered slots ("dense"). Where
    the JAX programs gather the batch's slots and scatter them back every
    call, nothing here copies a slot. `lora`: a LoraBatch with one adapter
    slot per row. `mesh`: this rank's Mesh - the caches hold its kv heads
    and K8/K9 run through flash_attention_spmd. Returns f32 logits [B,T,V],
    or [B,1,V] when `last_pos` is given (gathered before the head)."""
    if plain:
        params = plain_weights(params)
    n_rows, s = cache_layers[0][0].shape[:2]
    t = tokens.shape[1]
    _check_cached_write(rows, offsets, t, n_rows, s)
    rows_l = rows.long()
    write_pos = offsets.long()[:, None] + torch.arange(
        t, device=offsets.device)[None, :]                      # [B, T]
    flash = cfg.attn_impl == "flash"
    mask = (None if flash else
            make_attention_mask(positions, s, kv_valid, cfg.sliding_window))
    tabs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = embed(params, cfg, tokens, mesh)
    for layer, (k_cache, v_cache) in zip(params["layers"], cache_layers):

        def attn_fn(h, layer, k_cache=k_cache, v_cache=v_cache):
            q, k, v = project_qkv(h, layer, cfg, positions, tabs, lora,
                                  mesh)
            # In place: JAX's per-row dynamic_update_slice of the chunk.
            k_cache[rows_l[:, None], write_pos] = k
            v_cache[rows_l[:, None], write_pos] = v
            if flash:
                out = _flash(q, k_cache, v_cache, cfg, offsets, kv_valid,
                             plain=plain, rows=rows, mesh=mesh)
            else:
                out = dense_attend(q, k_cache[rows_l], v_cache[rows_l],
                                   mask, cfg, h.dtype,
                                   kv_head_index(cfg, mesh, q.shape[2],
                                                 k_cache.shape[2]))
            return _o_proj(out, layer, cfg, h.dtype, lora, mesh), None

        x, _ = transformer_block(x, layer, cfg, positions, None, None, None,
                                 attn_fn=attn_fn, lora=lora, mesh=mesh)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 cfg.rmsnorm_unit_offset)
    if last_pos is not None:
        x = gather_rows(x, last_pos)
    return lm_head(params, cfg, x, mesh)


def gather_rows(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Gather one T-row per batch element: [B,T,E], [B] -> [B,1,E]."""
    idx = pos.long()[:, None, None].expand(x.shape[0], 1, x.shape[2])
    return torch.gather(x, 1, idx)


# --- initialization ---


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda", mesh=None,
                quantize: Optional[Callable] = None) -> Params:
    """Random init with the JAX package's distributions (normal scaled by
    fan_in^-0.5, unit or zero norms, 0.02 biases), drawn in a fixed order
    from `generator` - the counterpart of the JAX key splits. The values
    differ from jax.random's; tests bridge weights instead
    (engine/weights.py). `quantize` (engine/quant.quantize_leaves with its
    options bound) maps each dict of whole drawn leaves to their quantized
    forms as soon as they are drawn. Under a `mesh` every rank draws the
    same whole tensors in the same order, quantizes them whole (every
    scale the whole leaf's) and keeps its slice of each
    (sharding.shard_tree): the shards of the weights one device would draw
    and quantize from the same generator. One whole layer is alive at a
    time. On the card unless the caller passes device="cpu"."""
    device = resolve_device(device)
    if mesh is not None:
        from ..sharding import materialize, param_specs, shard_tree
        specs = param_specs(cfg)

        def keep(tree, spec):
            if quantize is not None:
                tree = quantize(tree)
            return {k: materialize(v)
                    for k, v in shard_tree(tree, spec, mesh).items()}
    else:
        specs = None

        def keep(tree, spec):
            return tree if quantize is None else quantize(tree)

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * scale).to(dtype)

    def norm(n):
        return (torch.zeros(n, dtype=dtype, device=device)
                if cfg.rmsnorm_unit_offset
                else torch.ones(n, dtype=dtype, device=device))

    if cfg.num_experts:
        raise NotImplementedError(
            "MoE parameters are not ported yet (ROADMAP, slice 7)")
    e, h, k_, d, f = (cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.mlp_dim)
    params: Params = keep(
        {"embedding": normal((cfg.vocab_size, e), e ** -0.5)}, specs)
    layers = []
    for _ in range(cfg.num_layers):
        layer = {
            "q_proj": normal((e, h, d), e ** -0.5),
            "k_proj": normal((e, k_, d), e ** -0.5),
            "v_proj": normal((e, k_, d), e ** -0.5),
            "o_proj": normal((h, d, e), (h * d) ** -0.5),
            "input_norm": norm(e),
            "pre_mlp_norm": norm(e),
            "gate_proj": normal((e, f), e ** -0.5),
            "up_proj": normal((e, f), e ** -0.5),
            "down_proj": normal((f, e), f ** -0.5),
        }
        if cfg.attn_bias:
            layer["q_bias"] = normal((h, d), 0.02)
            layer["k_bias"] = normal((k_, d), 0.02)
            layer["v_bias"] = normal((k_, d), 0.02)
        if cfg.post_attn_norm:
            layer["post_attn_norm"] = layer["input_norm"]
        if cfg.post_mlp_norm:
            layer["post_mlp_norm"] = layer["pre_mlp_norm"]
        layers.append(keep(layer, specs and specs["layers"][len(layers)]))
    params["layers"] = layers
    params["final_norm"] = norm(e)
    if not cfg.tie_embeddings:
        params.update(keep({"lm_head": normal((cfg.vocab_size, e),
                                              e ** -0.5)}, specs))
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(params: Params) -> int:
    """Logical parameter count: every leaf's elements (a leaf reachable
    under two names counts twice, as jax.tree_util.tree_leaves does). An
    Int4Leaf's packed byte holds two parameters, so it counts
    2 * q4.numel() plus its scales, as int8 counts q plus s."""
    total = 0
    for x in _leaves(params):
        if isinstance(x, Int4Leaf):
            total += 2 * x.q4.numel() + x.s4.numel()
        else:
            total += x.numel()
    return total
