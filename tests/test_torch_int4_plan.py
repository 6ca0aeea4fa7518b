"""PyTorch port, the launch plan of the w4a16 kernels K5/K6
(kernels/int4mm.py out_plan, contract_plan, _kernel_reason) on shapes
alone: no card, no weights (the leaves live on the meta device).

For every int4 leaf that the registry's Llama, Qwen, Gemma and Mistral
configs make - whole, and as a rank's shard on a 2-way model axis (K10e)
- the plan covers C (K5) or E (K6) and every output column or vocab row
exactly once, in a fixed order, and stays within the kernels' shared
memory; and the kernels take exactly the leaves they took before their
tensor-core bodies (the table below).
"""

import pytest
import torch

from theroundtaible_tpu_torch.engine import quant
from theroundtaible_tpu_torch.engine.kernels import int4mm
from theroundtaible_tpu_torch.engine.models.common import Int4Leaf
from theroundtaible_tpu_torch.engine.models.registry import (
    get_model_config, list_models)

FAMILIES = ("llama", "qwen", "gemma", "mistral")
MODELS = sorted(n for n in list_models()
                if not get_model_config(n).num_experts
                and any(f in n for f in FAMILIES))
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
ROWS = (1, 3, 8, 9, 17, 33, 64)
SMS = (132, 114, 78)     # H100 SXM, H100 PCIe, a partitioned card


def leaves(name, shards, dtype):
    """{weight: (spec, leaf)} of `name`'s int4 tree, each leaf whole
    (shards 1) or a rank's slice on the axis the model shards split, its
    group as quantize_params picks it (aligned to the shards where the
    pack axis is split)."""
    cfg = get_model_config(name)
    e, h, k, d, f, v = (cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.mlp_dim, cfg.vocab_size)
    sites = {"q_proj": ("bte,ehd->bthd", (e, h, d), 1),
             "k_proj": ("bte,ekd->btkd", (e, k, d), 1),
             "o_proj": ("bthd,hde->bte", (h, d, e), 0),
             "gate_proj": ("bte,ef->btf", (e, f), 1),
             "down_proj": ("btf,fe->bte", (f, e), 0),
             "lm_head": ("bte,ve->btv", (v, e), 0)}
    out = {}
    for key, (spec, shape, axis) in sites.items():
        last = len(shape) - 1
        g = quant._int4_group_for(shape[-1], 64,
                                  shards if axis == last else 1)
        local = [n // shards if i == axis and n % shards == 0 else n
                 for i, n in enumerate(shape)]
        out[key] = (spec, Int4Leaf(
            q4=torch.empty(*local[:-1], local[-1] // 2, dtype=torch.int8,
                           device="meta"),
            s4=torch.empty(*local[:-1], local[-1] // g, dtype=dtype,
                           device="meta"),
            axis=last, group=g))
    return out


def geometry(spec, leaf):
    """(mode, contracted C or rows N, packed width) of a leaf's product."""
    plan = int4mm._plan(spec, leaf)
    return plan.mode, plan.w_rows, leaf.q4.numel() // plan.w_rows


def covered(ranges, total):
    """Ranges in ascending order that tile [0, total) exactly."""
    edge = 0
    for lo, hi in ranges:
        if lo != edge or hi <= lo:
            return False
        edge = hi
    return edge == total


# The kernels' decisions on every leaf above before their tensor-core
# bodies (computed by the parent tree's _kernel_reason, the same for bf16
# and f32 and for whole and sharded leaves): the tiny models' q/k weights
# have groups of 16 values, which 16-byte loads cannot share; every other
# leaf is taken.
PARENT_DECLINES = {
    (name, key): "pack:group 16 not a multiple of 32"
    for name in ("tiny-gemma", "tiny-llama", "tiny-mistral", "tiny-qwen")
    for key in ("q_proj", "k_proj")}
PARENT_SITES = 264   # models x shards (1, 2) x dtypes x 6 weights


def test_plan_table_covers_every_leaf():
    assert len(MODELS) == 11
    assert sum(len(leaves(n, s, t)) for n in MODELS for s in (1, 2)
               for t in DTYPES.values()) == PARENT_SITES


@pytest.mark.parametrize("name", MODELS)
def test_kernel_reason_takes_what_it_took(name):
    """_kernel_reason accepts every leaf it accepted before, and declines
    only what it declined, with the same reason."""
    for shards in (1, 2):
        for dtype in DTYPES.values():
            for key, (spec, leaf) in leaves(name, shards, dtype).items():
                plan = int4mm._plan(spec, leaf)
                assert plan.mode is not None, (name, key)
                assert plan.reason == PARENT_DECLINES.get((name, key)), \
                    (name, shards, dtype, key, plan.reason)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", MODELS)
def test_out_plan_covers_c_and_columns_once(name, dtype):
    """K5: every split of C and every column tile appears once, in
    order; bf16 splits are whole 32-row stages whose staged x rows and
    ring fit an SM's shared memory, f32 splits stay within 1024 rows."""
    dt = DTYPES[dtype]
    for shards in (1, 2):
        for key, (spec, leaf) in leaves(name, shards, dt).items():
            mode, c, p = geometry(spec, leaf)
            if mode != "out":
                continue
            for sms in SMS:
                for m in ROWS:
                    plan = int4mm.out_plan(m, c, p, sms, dt)
                    what = (name, shards, key, sms, m)
                    assert covered(plan.split_ranges(c), c), what
                    assert covered(plan.col_ranges(p), 2 * p), what
                    assert plan.splits == len(plan.split_ranges(c))
                    if dt == torch.float32:
                        assert plan.rows % 8 == 0 and plan.rows <= 1024
                        continue
                    assert plan.rows % 32 == 0, what
                    # the ring (4 x 4 KB) and x's split rows fit the SM
                    stride = (plan.rows + 63) // 64 * 64 + 16
                    smem = 16384 + 8 * int4mm.n_tiles(m) * stride * 2
                    assert smem <= 227 * 1024, what
                    assert plan.splits <= -(-c // 32), what


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", MODELS)
def test_contract_plan_covers_e_and_vocab_once(name, dtype):
    """K6: the staged pieces tile E in order, and the warps' vocab tiles
    (each warp's in ascending order) cover every vocab row once."""
    dt = DTYPES[dtype]
    for shards in (1, 2):
        spec, leaf = leaves(name, shards, dt)["lm_head"]
        mode, n, cp = geometry(spec, leaf)
        assert mode == "contract"
        for sms in SMS:
            for m in ROWS:
                plan = int4mm.contract_plan(m, n, cp, sms, dt)
                assert covered(plan.piece_ranges(2 * cp), 2 * cp)
                starts = []
                for block in range(plan.blocks):
                    for warp in range(plan.warps):
                        tiles = plan.warp_tiles(n, block, warp)
                        assert tiles == sorted(tiles)
                        starts += tiles
                # tiles of tile_rows rows from each start: every row once
                assert sorted(starts) == list(range(0, n, plan.tile_rows))
                if dt == torch.bfloat16:
                    assert plan.piece % 128 == 0 and plan.piece >= 128
                    x_bytes = plan.piece * 8 * int4mm.n_tiles(m) * 2
                    assert x_bytes <= 64 * 1024
                    assert plan.blocks <= 2 * sms


@pytest.mark.parametrize("m,c,p", [
    (3, 4096 + 32, 2048),     # a C that leaves a partial last split
    (9, 14336 + 16, 512),     # and a partial last 32-row stage
    (64, 100, 16),            # C shorter than one stage, one column tile
    (1, 4096, 48),            # a partial column tile
])
def test_out_plan_edges(m, c, p):
    plan = int4mm.out_plan(m, c, p, 132)
    ranges = plan.split_ranges(c)
    assert covered(ranges, c) and covered(plan.col_ranges(p), 2 * p)
    assert all(hi - lo <= plan.rows for lo, hi in ranges)
    assert plan.col_tiles == -(-p // 128)


@pytest.mark.parametrize("m,want", [(1, 1), (8, 1), (9, 2), (16, 2),
                                    (17, 4), (32, 4), (33, 8), (64, 8)])
def test_n_tiles(m, want):
    assert int4mm.n_tiles(m) == want
