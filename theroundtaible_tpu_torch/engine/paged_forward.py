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
from .models.common import (ModelConfig, Params, _matmul, _o_proj,
                            embed_tokens, gather_rows, lm_head, project_qkv,
                            rms_norm, rope_tables, scale_embeddings,
                            transformer_block)


def forward_paged(
    params: Params, cfg: ModelConfig,
    tokens: torch.Tensor,          # [B, T] token ids (T==1: decode step)
    positions: torch.Tensor,       # [B, T] absolute positions
    pools: list,                   # per-layer (k_pool, v_pool) [P,ps,K,D]
    table: torch.Tensor,           # [B, pages_per_seq] int32
    kv_valid_len: torch.Tensor,    # [B] int32 valid entries AFTER this call
    last_pos: Optional[torch.Tensor] = None,   # [B] row index into T
    plain: bool = False,
) -> torch.Tensor:
    """One serving step off the page pools - a decode step (T==1) or a
    prefill chunk - writing this call's K/V into `pools` in place. Returns
    f32 logits [B,T,V], or [B,1,V] when `last_pos` is given (the hidden
    state is gathered before the head, so a chunk never materializes
    full-sequence logits).

    `plain=True` runs the kernels' plain PyTorch versions instead of the
    CUDA kernels, on any device - how the chip smoke holds the whole path
    against them. Pad-tail cells of a bucket land on the row's own
    decode-reserve pages or the scratch page, both overwritten or ignored
    before any read."""
    page_size = pools[0][0].shape[1]
    pp = table.shape[1]
    # Positions past the table's reach clamp to its last entry, as the JAX
    # gather clamps an out-of-range index (torch indexing would raise).
    page_idx = torch.clamp(positions // page_size, max=pp - 1).long()
    pages = torch.gather(table.long(), 1, page_idx)           # [B, T]
    offs = (positions % page_size).long()
    starts = positions[:, 0].contiguous()
    t = tokens.shape[1]
    decode = (kattn.paged_decode_attention_ref if plain
              else kattn.paged_decode_attention)
    prefill = (kattn.paged_prefill_attention_ref if plain
               else kattn.paged_prefill_attention)

    tabs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = scale_embeddings(embed_tokens(params["embedding"], tokens), cfg)
    for layer, (k_pool, v_pool) in zip(params["layers"], pools):

        def attn_fn(h, layer, k_pool=k_pool, v_pool=v_pool):
            q, k, v = project_qkv(h, layer, cfg, positions, tabs)
            # In place: the JAX package's `pool.at[pages, offs].set`.
            k_pool[pages, offs] = k
            v_pool[pages, offs] = v
            if t == 1:
                out = decode(q, k_pool, v_pool, table, kv_valid_len,
                             sliding_window=cfg.sliding_window,
                             softcap=cfg.attn_logit_softcap)
            else:
                out = prefill(q, k_pool, v_pool, table, starts,
                              kv_valid_len,
                              sliding_window=cfg.sliding_window,
                              softcap=cfg.attn_logit_softcap)
            return _o_proj(out, layer, cfg, h.dtype), None

        x, _ = transformer_block(x, layer, cfg, positions, None, None, None,
                                 attn_fn=attn_fn)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 cfg.rmsnorm_unit_offset)
    if last_pos is not None:
        x = gather_rows(x, last_pos)
    return lm_head(params, cfg, x)


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
    scales: Optional[list] = None,
    copy_src: Optional[torch.Tensor] = None,
    copy_dst: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One mixed prefill/decode step over the flat token buffer: each
    layer writes the buffer's K/V into the owning sequences' pages in place
    (pads land on the scratch page, never read), then attends through K3
    (`plain=True`: its plain version, on any device). Returns f32
    per-sequence last-token logits [S,V], gathered before the head; the
    inert pad sequence's row is garbage the caller drops.

    Speculative verify rows (`sample_rows`), tree pre-copies
    (`copy_src`/`copy_dst`) and quantized pools (`scales`) are not
    ported."""
    if sample_rows is not None or copy_src is not None \
            or copy_dst is not None:
        raise NotImplementedError(
            "sample_rows/copy_src/copy_dst (speculative verify) are not "
            "ported to the PyTorch engine yet (ROADMAP, slice 7: "
            "speculative decoding)")
    if scales is not None:
        raise NotImplementedError(
            "quantized KV pools are not ported to the PyTorch engine yet "
            "(ROADMAP, slice 5: quantization, K4/K5/K6)")
    pos2 = positions[None]
    pages = token_pages.long()
    offs = token_offs.long()
    attend = (kattn.ragged_paged_attention_ref if plain
              else kattn.ragged_paged_attention)
    tabs = rope_tables(pos2, cfg.head_dim, cfg.rope_theta)
    x = scale_embeddings(embed_tokens(params["embedding"], tokens[None]),
                         cfg)
    for layer, (k_pool, v_pool) in zip(params["layers"], pools):

        def attn_fn(h, layer, k_pool=k_pool, v_pool=v_pool):
            q, k, v = project_qkv(h, layer, cfg, pos2, tabs)   # [1,T,.,D]
            # In place: the JAX package's `pool.at[pages, offs].set`.
            k_pool[pages, offs] = k[0]
            v_pool[pages, offs] = v[0]
            out = attend(q[0], k_pool, v_pool, tables, seq_of_block,
                         block_qstart, query_offsets, kv_valid,
                         sliding_window=cfg.sliding_window,
                         softcap=cfg.attn_logit_softcap)
            out = _matmul(out.reshape(1, out.shape[0], -1),
                          layer["o_proj"].reshape(-1, cfg.embed_dim))
            return out.to(h.dtype), None

        x, _ = transformer_block(x, layer, cfg, pos2, None, None, None,
                                 attn_fn=attn_fn)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps,
                 cfg.rmsnorm_unit_offset)
    return lm_head(params, cfg, x[:, last_rows.long()])[0]
