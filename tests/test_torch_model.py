"""PyTorch port, model core: the port's dense `forward` and its pool-direct
`forward_paged` against the JAX package's on the same bridged weights
(engine/weights.py) and the same numpy inputs. f32; logits within atol
1e-4 (the two frameworks sum in different orders). The bf16 cases hold
the weight products' f32 results (the JAX einsums' preferred_element_type)
against JAX's bf16 forward: logits within BF16_ATOL, greedy tokens
equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theroundtaible_tpu.engine.models import common as jcommon
from theroundtaible_tpu.engine.models.registry import \
    get_model_config as jax_config
from theroundtaible_tpu.engine.paged_forward import \
    forward_paged as jax_forward_paged
from theroundtaible_tpu_torch.engine.models import common as tcommon
from theroundtaible_tpu_torch.engine.models.registry import \
    get_model_config as torch_config
from theroundtaible_tpu_torch.engine.paged_forward import forward_paged
from theroundtaible_tpu_torch.engine.weights import params_from_numpy

ATOL = 1e-4
# bf16 parity: with f32 products the port's logits stay within 0.015
# (llama, gemma, mistral) / 0.030 (qwen, its q/k/v bias added in f32) of
# JAX's on a B=4, T=64 prefill; products rounded to bf16 before their
# consumers (the fault this checks for) gave 0.049 / 0.076.
BF16_ATOL = 0.04


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers' timing tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bridged(name, **overrides):
    """(jax cfg, jax params, torch cfg, torch params) with equal weights."""
    jcfg = jax_config(name, **overrides)
    jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tcfg = torch_config(name, **overrides)
    tparams = params_from_numpy(jax.device_get(jparams), tcfg,
                                torch.float32, "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-gemma",
                                  "tiny-mistral", "tiny-qwen"])
def test_forward_matches_jax(name):
    """Prefill from scratch (T=96 crosses tiny-mistral's 64 window), then
    one cached decode step at per-row offsets."""
    jcfg, jparams, tcfg, tparams = bridged(name)
    rng = np.random.default_rng(0)
    B, T, S = 2, 96, 128
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    valid = np.full((B,), T, np.int32)
    jl, _ = jcommon.forward(jparams, jcfg, jnp.asarray(tokens),
                            jnp.asarray(positions), None, None,
                            jnp.asarray(valid))
    tl, _ = tcommon.forward(tparams, tcfg, torch.from_numpy(tokens).long(),
                            torch.from_numpy(positions.copy()), None, None,
                            torch.from_numpy(valid))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)

    # decode one position against a position-aligned cache
    K, D = jcfg.num_kv_heads, jcfg.head_dim
    caches = [(rng.normal(size=(B, S, K, D)).astype(np.float32),
               rng.normal(size=(B, S, K, D)).astype(np.float32))
              for _ in range(jcfg.num_layers)]
    offs = np.asarray([5, 90], np.int32)
    step = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
    jl, jc = jcommon.forward(
        jparams, jcfg, jnp.asarray(step), jnp.asarray(offs[:, None]),
        [(jnp.asarray(k), jnp.asarray(v)) for k, v in caches],
        jnp.asarray(offs), jnp.asarray(offs + 1))
    tl, tc = tcommon.forward(
        tparams, tcfg, torch.from_numpy(step).long(),
        torch.from_numpy(offs[:, None]),
        [(torch.from_numpy(k), torch.from_numpy(v)) for k, v in caches],
        torch.from_numpy(offs), torch.from_numpy(offs + 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tc[-1][0].numpy(), np.asarray(jc[-1][0]),
                               atol=ATOL, rtol=0)


def bridged_bf16(name):
    """bridged() in bf16: the JAX params drawn in bf16, the same bits in
    the port."""
    jcfg = jax_config(name)
    jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tcfg = torch_config(name)
    tparams = params_from_numpy(jax.device_get(jparams), tcfg,
                                torch.bfloat16, "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-qwen", "tiny-gemma",
                                  "tiny-mistral"])
def test_bf16_forward_matches_jax(name):
    """A bf16 B=4, T=64 prefill: the weight products keep f32 results
    through the head, the MLP's gate/up and the Qwen2 bias, as JAX's."""
    jcfg, jparams, tcfg, tparams = bridged_bf16(name)
    rng = np.random.default_rng(0)
    B, T = 4, 64
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    valid = np.full((B,), T, np.int32)
    jl, _ = jcommon.forward(jparams, jcfg, jnp.asarray(tokens),
                            jnp.asarray(positions), None, None,
                            jnp.asarray(valid))
    tl, _ = tcommon.forward(tparams, tcfg, torch.from_numpy(tokens).long(),
                            torch.from_numpy(positions), None, None,
                            torch.from_numpy(valid))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                               atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-qwen"])
def test_bf16_greedy_decode_matches_jax(name):
    """A bf16 prefill of 3 rows into a position-aligned cache, then 12
    greedy decode steps, each package feeding back its own tokens: the
    tokens are equal at every step."""
    jcfg, jparams, tcfg, tparams = bridged_bf16(name)
    rng = np.random.default_rng(1)
    B, T, S, steps = 3, 32, 64, 12
    K, D = jcfg.num_kv_heads, jcfg.head_dim
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jcache = [(jnp.zeros((B, S, K, D), jnp.bfloat16),) * 2
              for _ in range(jcfg.num_layers)]
    tcache = [(torch.zeros(B, S, K, D, dtype=torch.bfloat16),) * 2
              for _ in range(tcfg.num_layers)]
    zeros, valid = np.zeros(B, np.int32), np.full(B, T, np.int32)
    last = np.full(B, T - 1, np.int32)
    jl, jcache = jcommon.forward(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jcache,
        jnp.asarray(zeros), jnp.asarray(valid), last_pos=jnp.asarray(last))
    tl, tcache = tcommon.forward(
        tparams, tcfg, torch.from_numpy(tokens).long(),
        torch.from_numpy(positions), tcache, torch.from_numpy(zeros),
        torch.from_numpy(valid), last_pos=torch.from_numpy(last))
    jtok = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32)
    ttok = tl[:, 0].argmax(-1).numpy().astype(np.int32)
    got_j, got_t = [jtok], [ttok]
    for i in range(steps):
        pos = np.full((B, 1), T + i, np.int32)
        jl, jcache = jcommon.forward(
            jparams, jcfg, jnp.asarray(jtok[:, None]), jnp.asarray(pos),
            jcache, jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 0] + 1))
        tl, tcache = tcommon.forward(
            tparams, tcfg, torch.from_numpy(ttok[:, None]).long(),
            torch.from_numpy(pos), tcache, torch.from_numpy(pos[:, 0]),
            torch.from_numpy(pos[:, 0] + 1))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                                   atol=BF16_ATOL, rtol=0)
        jtok = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32)
        ttok = tl[:, 0].argmax(-1).numpy().astype(np.int32)
        got_j.append(jtok)
        got_t.append(ttok)
    np.testing.assert_array_equal(np.stack(got_t), np.stack(got_j))


def test_param_count_and_layouts_match():
    jcfg, jparams, tcfg, tparams = bridged("tiny-qwen")
    assert tcommon.param_count(tparams) == jcommon.param_count(jparams)
    gen = torch.Generator().manual_seed(0)
    fresh = tcommon.init_params(tcfg, gen, torch.float32)
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in flat:
        node = fresh
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        assert tuple(node.shape) == tuple(leaf.shape), path


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-mistral"])
def test_forward_paged_matches_jax(name):
    """One prefill chunk and one decode step of forward_paged on the same
    shuffled pools and table: logits, and every pool cell a real token
    wrote, agree with the JAX package's forward_paged (its Pallas kernels
    in interpret mode)."""
    jcfg, jparams, tcfg, tparams = bridged(name, max_seq_len=256)
    rng = np.random.default_rng(1)
    B, ps, K, D = 2, 32, jcfg.num_kv_heads, jcfg.head_dim
    pp = jcfg.max_seq_len // ps
    table = (rng.permutation(B * pp) + 1).reshape(B, pp).astype(np.int32)
    offsets = np.asarray([0, 40], np.int32)   # row 1: delta prefill
    lengths = np.asarray([64, 30], np.int32)
    valid = offsets + lengths
    pools = []
    for _ in range(jcfg.num_layers):
        pair = []
        for _ in range(2):
            pool = np.zeros((1 + B * pp, ps, K, D), np.float32)
            # row 1's cached history below its offset
            for pos in range(offsets[1]):
                pool[table[1, pos // ps], pos % ps] = rng.normal(size=(K, D))
            pair.append(pool)
        pools.append(tuple(pair))
    jpools = [(jnp.asarray(k), jnp.asarray(v)) for k, v in pools]
    tpools = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
              for k, v in pools]

    def step(tokens, positions, kv_valid, last_pos):
        nonlocal jpools
        jl, jpools = jax_forward_paged(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
            jpools, jnp.asarray(table), jnp.asarray(kv_valid),
            last_pos=None if last_pos is None else jnp.asarray(last_pos))
        tl = forward_paged(
            tparams, tcfg, torch.from_numpy(tokens).long(),
            torch.from_numpy(positions), tpools, torch.from_numpy(table),
            torch.from_numpy(kv_valid),
            last_pos=None if last_pos is None else torch.from_numpy(last_pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        for (tk, tv), (jk, jv) in zip(tpools, jpools):
            for b in range(B):
                for pos in range(int(kv_valid[b])):
                    page, off = table[b, pos // ps], pos % ps
                    np.testing.assert_allclose(
                        tk[page, off].numpy(), np.asarray(jk[page, off]),
                        atol=ATOL, rtol=0)
                    np.testing.assert_allclose(
                        tv[page, off].numpy(), np.asarray(jv[page, off]),
                        atol=ATOL, rtol=0)
        return tl

    T = 64
    chunk = rng.integers(3, 259, size=(B, T)).astype(np.int32)
    positions = (offsets[:, None] + np.arange(T, dtype=np.int32))
    step(chunk, positions.astype(np.int32), valid, lengths - 1)
    nxt = rng.integers(3, 259, size=(B, 1)).astype(np.int32)
    step(nxt, valid[:, None].copy(), valid + 1, None)


def test_positions_past_the_table_clamp_like_jax():
    """A bucket whose pad tail runs past max_seq_len: the page lookup
    clamps to the table's last entry (JAX's gather semantics) instead of
    raising. The engine never builds such a bucket (chunked_prefill
    shrinks it at the cache end - test_torch_engine)."""
    _, _, tcfg, tparams = bridged("tiny-llama", max_seq_len=64)
    ps, pp = 16, 4
    pools = [(torch.zeros(1 + pp, ps, 2, 16), torch.zeros(1 + pp, ps, 2, 16))
             for _ in range(tcfg.num_layers)]
    table = torch.arange(1, 1 + pp, dtype=torch.int32)[None]
    tokens = torch.full((1, 16), 7, dtype=torch.long)
    positions = torch.arange(56, 72, dtype=torch.int32)[None]  # 64.. = pad
    logits = forward_paged(tparams, tcfg, tokens, positions, pools, table,
                           torch.tensor([64], dtype=torch.int32),
                           last_pos=torch.tensor([7]))
    assert torch.isfinite(logits).all()
