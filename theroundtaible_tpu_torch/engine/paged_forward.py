"""Pool-direct paged serving forward (counterpart of
theroundtaible_tpu/engine/paged_forward.py, `forward_paged` and
`forward_ragged`).

Serves decode steps AND prefill chunks straight off the page pools: each
layer writes its K/V into the rows' pages (an indexed in-place write -
where the JAX package scatters into a donated buffer, outside any
kernel), then attends through the page-table-aware kernels K1 (decode) /
K2 (prefill chunk), which read only the pages inside each row's
causal/valid frontier. Block wiring (norms, residuals, MLP, family flags)
comes from models/common.transformer_block through its attn_fn hook.

forward_ragged serves the scheduler's mixed dispatches: every sequence's
prefill chunk or decode token in one flat buffer
(serving_loop.build_ragged_batch), attending through K3.

Quantized pools (`scales`, `quant_spec`: kv_quant): each written token's
K/V is quantized on write (kv_quant.quantize_cells, its own per-cell
scales, neighbours untouched) and its payload and scales land in the same
[page, offset] cells; K1-K3 then dequantize in-kernel (K4).

LoRA (`lora`, an engine/lora.LoraBatch): the tagged projections add each
row's adapter delta - one adapter slot per batch row in forward_paged, one
per token of the flat buffer in forward_ragged (pads keep slot 0, the
base).

Tensor parallelism (`mesh`, an engine/sharding.Mesh with a model axis
> 1): the pools hold this rank's kv heads and the kernels run through the
K10 wrappers (kernels/attention.py paged_decode_spmd, paged_prefill_spmd,
ragged_paged_spmd; JAX paged_forward.py:130-160, :336); the page tables
and every index are the same on every rank. The block's collectives are
models/common's.

Write-exclusivity: the engine's ensure_capacity copy-on-writes any shared
page in a row's write range before dispatch (the scheduler's
_apply_share_plans does it at alias time), and distinct rows own their
frontier pages exclusively, so a real token's write never touches an
aliased page. Pad tokens of a flat buffer all write the scratch page with
duplicate indices; in-place indexing then keeps an arbitrary one, which is
harmless because those cells are never read.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import attention as kattn
from .kv_quant import dequantize_cells, quantize_cells
from .models.common import (ModelConfig, Params, _model_tp, _o_proj, embed,
                            gather_rows, lm_head, plain_weights, project_qkv,
                            rms_norm, rope_tables, transformer_block)


def _layer_scales(scales, quant_spec, n_layers: int) -> list:
    """Per-layer (k_scale, v_scale) of a forward, (None, None) each on
    unquantized pools."""
    if scales is None:
        return [(None, None)] * n_layers
    if quant_spec is None or len(scales) != n_layers:
        raise ValueError("quantized pools need quant_spec and one scale "
                         "pair per layer")
    return list(scales)


def _spmd(out, what: str, mesh, t: int, page_size: int):
    """A K10 wrapper's output; its None fails loudly (the engine checked
    the shapes at construction, so this is direct misuse)."""
    if out is None:
        raise ValueError(
            f"{what} under mesh {mesh.shape} needs a head layout that "
            f"partitions over the model axis and a shard the kernel takes "
            f"(T={t}, page {page_size}); see "
            f"kernels/attention.spmd_decline_reason")
    return out


def _write_kv(k_pool, v_pool, k_sc, v_sc, pages, offs, k, v, quant_spec):
    """This call's K/V into the [pages, offs] cells, in place (the JAX
    package's `pool.at[pages, offs].set`) - quantized on write, payload
    and scales into the same cells, when the pools are quantized."""
    if k_sc is None:
        k_pool[pages, offs] = k
        v_pool[pages, offs] = v
        return
    k_q, k_s = quantize_cells(k, quant_spec)
    v_q, v_s = quantize_cells(v, quant_spec)
    k_pool[pages, offs] = k_q
    v_pool[pages, offs] = v_q
    k_sc[pages, offs] = k_s
    v_sc[pages, offs] = v_s


def forward_paged(
    params: Params, cfg: ModelConfig,
    tokens: torch.Tensor,          # [B, T] token ids (T==1: decode step)
    positions: torch.Tensor,       # [B, T] absolute positions
    pools: list,                   # per-layer (k_pool, v_pool) [P,ps,K,D]
    table: torch.Tensor,           # [B, pages_per_seq] int32
    kv_valid_len: torch.Tensor,    # [B] int32 valid entries AFTER this call
    last_pos: Optional[torch.Tensor] = None,   # [B] row index into T
    plain: bool = False,
    scales: Optional[list] = None,  # per-layer (k_s, v_s) [P,ps,K,G]
    quant_spec=None,                # kv_quant.KVQuantSpec with scales
    lora=None,                      # LoraBatch, one adapter slot per row
    mesh=None,                      # this rank's sharding.Mesh
) -> torch.Tensor:
    """One serving step off the page pools - a decode step (T==1) or a
    prefill chunk - writing this call's K/V into `pools` (and `scales`) in
    place. Returns f32 logits [B,T,V], or [B,1,V] when `last_pos` is given
    (the hidden state is gathered before the head, so a chunk never
    materializes full-sequence logits).

    `plain=True` runs the kernels' plain PyTorch versions instead of the
    CUDA kernels (K1/K2 and, for int4 weights, K5/K6), on any device - how
    the chip smoke holds the whole path against them. Pad-tail cells of a
    bucket land on the row's own decode-reserve pages or the scratch page,
    both overwritten or ignored before any read."""
    if plain:
        params = plain_weights(params)
    page_size = pools[0][0].shape[1]
    pp = table.shape[1]
    # Positions past the table's reach clamp to its last entry, as the JAX
    # gather clamps an out-of-range index (torch indexing would raise).
    page_idx = torch.clamp(positions // page_size, max=pp - 1).long()
    pages = torch.gather(table.long(), 1, page_idx)           # [B, T]
    offs = (positions % page_size).long()
    starts = positions[:, 0].contiguous()
    t = tokens.shape[1]
    tp = _model_tp(mesh)
    if tp is not None:
        heads = (cfg.num_heads, cfg.num_kv_heads)
        spmd_decode = (kattn.paged_decode_spmd_ref if plain
                       else kattn.paged_decode_spmd)
        spmd_prefill = (kattn.paged_prefill_spmd_ref if plain
                        else kattn.paged_prefill_spmd)

        def decode(q, kp, vp, tb, valid, **kw):
            return _spmd(spmd_decode(tp, q, kp, vp, tb, valid, heads=heads,
                                     **kw),
                         "paged_decode_spmd", tp, 1, page_size)

        def prefill(q, kp, vp, tb, offs_, valid, **kw):
            return _spmd(spmd_prefill(tp, q, kp, vp, tb, offs_, valid,
                                      heads=heads, **kw),
                         "paged_prefill_spmd", tp, q.shape[1], page_size)
    else:
        decode = (kattn.paged_decode_attention_ref if plain
                  else kattn.paged_decode_attention)
        prefill = (kattn.paged_prefill_attention_ref if plain
                   else kattn.paged_prefill_attention)

    bits = quant_spec.bits if quant_spec is not None else 8
    layer_scales = _layer_scales(scales, quant_spec, len(pools))
    tabs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = embed(params, cfg, tokens, mesh)
    for layer, (k_pool, v_pool), (k_sc, v_sc) in zip(params["layers"], pools,
                                                     layer_scales):

        def attn_fn(h, layer, k_pool=k_pool, v_pool=v_pool, k_sc=k_sc,
                    v_sc=v_sc):
            q, k, v = project_qkv(h, layer, cfg, positions, tabs, lora,
                                  mesh)
            _write_kv(k_pool, v_pool, k_sc, v_sc, pages, offs, k, v,
                      quant_spec)
            kw = dict(sliding_window=cfg.sliding_window,
                      softcap=cfg.attn_logit_softcap, k_scale=k_sc,
                      v_scale=v_sc, kv_bits=bits)
            if t == 1:
                out = decode(q, k_pool, v_pool, table, kv_valid_len, **kw)
            else:
                out = prefill(q, k_pool, v_pool, table, starts, kv_valid_len,
                              **kw)
            return _o_proj(out, layer, cfg, h.dtype, lora, mesh), None

        x, _ = transformer_block(x, layer, cfg, positions, None, None, None,
                                 attn_fn=attn_fn, lora=lora, mesh=mesh)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 cfg.rmsnorm_unit_offset)
    if last_pos is not None:
        x = gather_rows(x, last_pos)
    return lm_head(params, cfg, x, mesh)


def forward_ragged(
    params: Params, cfg: ModelConfig,
    tokens: torch.Tensor,          # [T] flat token buffer
    positions: torch.Tensor,       # [T] absolute positions
    pools: list,                   # per-layer (k_pool, v_pool) [P,ps,K,D]
    tables: torch.Tensor,          # [S, pages_per_seq] int32
    seq_of_block: torch.Tensor,    # [T/8] sequence id per q block
    block_qstart: torch.Tensor,    # [T/8] block start row within its seq
    query_offsets: torch.Tensor,   # [S] absolute position of seq's row 0
    kv_valid: torch.Tensor,        # [S] valid entries AFTER this call
    token_pages: torch.Tensor,     # [T] pool page per token (pads: scratch)
    token_offs: torch.Tensor,      # [T] in-page offset per token
    last_rows: torch.Tensor,       # [S] flat row of each seq's last token
    plain: bool = False,
    sample_rows: Optional[torch.Tensor] = None,
    scales: Optional[list] = None,  # per-layer (k_s, v_s) [P,ps,K,G]
    quant_spec=None,                # kv_quant.KVQuantSpec with scales
    copy_src: Optional[torch.Tensor] = None,
    copy_dst: Optional[torch.Tensor] = None,
    lora=None,                      # LoraBatch, one adapter slot per token
    mesh=None,                      # this rank's sharding.Mesh
) -> torch.Tensor:
    """One mixed prefill/decode step over the flat token buffer: each
    layer writes the buffer's K/V into the owning sequences' pages in place
    (quantized on write when `scales` is given; pads land on the scratch
    page, never read), then attends through K3 (`plain=True`: its plain
    version, and those of K5/K6 for int4 weights, on any device). Returns f32 per-sequence last-token logits
    [S,V], gathered before the head; the inert pad sequence's row is
    garbage the caller drops.

    Speculative verify rows (`sample_rows`) and tree pre-copies
    (`copy_src`/`copy_dst`) are not ported."""
    if sample_rows is not None or copy_src is not None \
            or copy_dst is not None:
        raise NotImplementedError(
            "sample_rows/copy_src/copy_dst (speculative verify) are not "
            "ported to the PyTorch engine yet (ROADMAP, slice 7: "
            "speculative decoding)")
    if plain:
        params = plain_weights(params)
    bits = quant_spec.bits if quant_spec is not None else 8
    layer_scales = _layer_scales(scales, quant_spec, len(pools))
    pos2 = positions[None]
    pages = token_pages.long()
    offs = token_offs.long()
    tp = _model_tp(mesh)
    if tp is not None:
        spmd = (kattn.ragged_paged_spmd_ref if plain
                else kattn.ragged_paged_spmd)
        heads = (cfg.num_heads, cfg.num_kv_heads)

        def attend(q, kp, *args, **kw):
            return _spmd(spmd(tp, q, kp, *args, heads=heads, **kw),
                         "ragged_paged_spmd", tp, q.shape[0], kp.shape[1])
    else:
        attend = (kattn.ragged_paged_attention_ref if plain
                  else kattn.ragged_paged_attention)
    tabs = rope_tables(pos2, cfg.head_dim, cfg.rope_theta)
    x = embed(params, cfg, tokens[None], mesh)
    for layer, (k_pool, v_pool), (k_sc, v_sc) in zip(params["layers"], pools,
                                                     layer_scales):

        def attn_fn(h, layer, k_pool=k_pool, v_pool=v_pool, k_sc=k_sc,
                    v_sc=v_sc):
            q, k, v = project_qkv(h, layer, cfg, pos2, tabs, lora,
                                  mesh)                    # [1,T,.,D]
            _write_kv(k_pool, v_pool, k_sc, v_sc, pages, offs, k[0], v[0],
                      quant_spec)
            out = attend(q[0], k_pool, v_pool, tables, seq_of_block,
                         block_qstart, query_offsets, kv_valid,
                         sliding_window=cfg.sliding_window,
                         softcap=cfg.attn_logit_softcap, k_scale=k_sc,
                         v_scale=v_sc, kv_bits=bits)
            return _o_proj(out[None], layer, cfg, h.dtype, lora, mesh), None

        x, _ = transformer_block(x, layer, cfg, pos2, None, None, None,
                                 attn_fn=attn_fn, lora=lora, mesh=mesh)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 cfg.rmsnorm_unit_offset)
    return lm_head(params, cfg, x[:, last_rows.long()], mesh)[0]


# --- the gather view (attn "dense" on the paged pool) ---


def gather_view(pools: list, scales: Optional[list], table: torch.Tensor,
                quant_spec, dtype) -> list:
    """The rows' pages as a position-aligned cache: per layer (k, v)
    [B, pages_per_seq * page_size, K, D] copies in `dtype`, dequantized at
    the gather when the pools are quantized (the JAX engine's
    gather_view)."""
    idx = table.long()
    b = idx.shape[0]
    out = []
    for li, (k_pool, v_pool) in enumerate(pools):
        if scales is not None:
            k_sc, v_sc = scales[li]
            kb = dequantize_cells(k_pool[idx], k_sc[idx], quant_spec, dtype)
            vb = dequantize_cells(v_pool[idx], v_sc[idx], quant_spec, dtype)
        else:
            kb, vb = k_pool[idx], v_pool[idx]
        out.append((kb.reshape(b, -1, *kb.shape[3:]),
                    vb.reshape(b, -1, *vb.shape[3:])))
    return out


def scatter_view(pools: list, scales: Optional[list], table: torch.Tensor,
                 view: list, quant_spec) -> None:
    """The inverse of gather_view, in place: every cell of the view back
    into its page - requantized cell by cell on a quantized pool (the JAX
    engine's scatter_view). Table entries past a row's allocation are the
    scratch page, which absorbs the tail and is never read."""
    idx = table.long()
    b, pp = idx.shape
    for li, ((k_pool, v_pool), (kb, vb)) in enumerate(zip(pools, view)):
        ps = k_pool.shape[1]
        if scales is not None:
            k_sc, v_sc = scales[li]
            for pool, sc, x in ((k_pool, k_sc, kb), (v_pool, v_sc, vb)):
                q, s = quantize_cells(x, quant_spec)
                pool[idx] = q.reshape(b, pp, ps, *q.shape[2:])
                sc[idx] = s.reshape(b, pp, ps, *s.shape[2:])
        else:
            k_pool[idx] = kb.reshape(b, pp, ps, *kb.shape[2:])
            v_pool[idx] = vb.reshape(b, pp, ps, *vb.shape[2:])
