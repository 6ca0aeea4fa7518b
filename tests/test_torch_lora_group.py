"""PyTorch port, K7's group form: `lora_bgmv_add` (one call per input
group, each target's delta added in place into its f32 base product) on
its plain version against the JAX package's per-target `_bgmv` (Pallas
interpret mode) plus the same f32 base, the grouped forward against the
per-target forward bit for bit, the wrapper's refusals, and K10f's group
form (`lora_bgmv_add_spmd`) on each rank coordinate of a 2-way model axis
against the per-target K10f. f32; inputs from numpy seeds. The CUDA kernel
itself runs only on a card: tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theroundtaible_tpu.engine import lora as jlora
from theroundtaible_tpu.engine.pallas import lora as jplora
from theroundtaible_tpu_torch.engine import lora
from theroundtaible_tpu_torch.engine.kernels import lora as klora
from theroundtaible_tpu_torch.engine.models import common
from theroundtaible_tpu_torch.engine.models.registry import \
    get_model_config
from theroundtaible_tpu_torch.engine.paged_forward import forward_paged
from theroundtaible_tpu_torch.engine.sharding import Mesh

# The plain versions against the JAX functions: f32, sums in another order
# (tests/test_torch_lora.py's tolerance).
TOL = dict(atol=1e-5, rtol=1e-5)
SLOTS = 5

# tests/test_torch_lora.py's CASES: (rows, rank, C, O).
CASES = ([(m, r, c, o) for m in (1, 3, 8, 64) for r, (c, o) in
          zip((1, 8, 16), ((128, 512), (256, 256), (512, 128)))]
         + [(3, 8, c, o) for c in (128, 256, 512) for o in (128, 256, 512)])
# Each group's output widths from a case's O: q/k/v (a wide q, narrow k/v),
# gate/up, and a target alone (o_proj, down_proj).
GROUPS = {"qkv": lambda o: (o, 128, 128), "gate_up": lambda o: (o, o),
          "alone": lambda o: (o,)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def group_inputs(rng, m, r, c, outs, ids_kind):
    """x [m, c], one (a_t, b_s) pair per output width at a persona's scale
    (slot 0 zero), f32 base products y0, and ids: "mixed" holds the base
    slot and repeats, "one" a single adapter on every row."""
    x = rng.normal(size=(m, c)).astype(np.float32)
    stacks = []
    for o in outs:
        a_t = (rng.normal(size=(SLOTS, r, c)) * c ** -0.5).astype(np.float32)
        b_s = (rng.normal(size=(SLOTS, r, o)) * 0.5).astype(np.float32)
        a_t[0] = b_s[0] = 0.0
        stacks.append((a_t, b_s))
    ys = [rng.normal(size=(m, o)).astype(np.float32) for o in outs]
    if ids_kind == "mixed":
        ids = (np.arange(m) * 3 + 1) % SLOTS
        ids[0] = 0
    else:
        ids = np.full(m, 2)
    return x, stacks, ys, ids.astype(np.int32)


def jax_delta(x, a_t, b_s, ids):
    """JAX's per-target delta: its kernel in interpret mode, or, where its
    plan declines (C or O not multiples of 128, the tiny models' widths),
    the _xla_grouped its engine serves there."""
    args = [jnp.asarray(v) for v in (x, a_t, b_s, ids)]
    y, reason = jplora.lora_bgmv_or_reason(*args)
    if y is None:
        assert reason.startswith("dims:"), reason
        y = jlora._xla_grouped(*args)
    return np.asarray(y)


def torch_group(x, stacks, ys, ids):
    return (torch.from_numpy(x),
            [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in stacks],
            [torch.from_numpy(y.copy()) for y in ys],
            torch.from_numpy(ids))


@pytest.mark.parametrize("ids_kind", ["mixed", "one"])
@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("m,r,c,o", CASES)
def test_group_add_plain_matches_jax_per_target(monkeypatch, m, r, c, o,
                                                group, ids_kind):
    """lora_bgmv_add's plain path: each y becomes y0 plus JAX's per-target
    delta, base rows keep y0 exactly, and nothing is counted on the
    CPU."""
    monkeypatch.setenv("ROUNDTABLE_LORA_MM", "1")
    rng = np.random.default_rng(m * 1000 + r * 100 + c + o)
    x, stacks, ys, ids = group_inputs(rng, m, r, c, GROUPS[group](o),
                                      ids_kind)
    xt, st, yt, it = torch_group(x, stacks, ys, ids)
    before = klora.launch_counts()
    klora.lora_bgmv_add(xt, st, yt, it)
    assert klora.launch_counts() == before
    for (a_t, b_s), y0, y in zip(stacks, ys, yt):
        np.testing.assert_allclose(y.numpy(),
                                   y0 + jax_delta(x, a_t, b_s, ids), **TOL)
        np.testing.assert_array_equal(y.numpy()[ids == 0], y0[ids == 0])


@pytest.mark.parametrize("rows", [1, 3, 64])
@pytest.mark.parametrize("model", ["tiny-llama", "tiny-gemma"])
def test_group_add_plain_at_tiny_model_widths(model, rows):
    """The tiny models' q/k/v, gate/up, o_proj and down_proj groups (C, O
    in 32..128, below the TPU's 128-lane alignment: JAX serves them its
    grouped einsums)."""
    dims = lora.lora_dims(get_model_config(model))
    rng = np.random.default_rng(rows + len(model))
    for keys in (("q_proj", "k_proj", "v_proj"), ("gate_proj", "up_proj"),
                 ("o_proj",), ("down_proj",)):
        c = dims[keys[0]][0]
        x, stacks, ys, ids = group_inputs(
            rng, rows, 4, c, [dims[k][1] for k in keys], "mixed")
        xt, st, yt, it = torch_group(x, stacks, ys, ids)
        klora.lora_bgmv_add(xt, st, yt, it)
        for (a_t, b_s), y0, y in zip(stacks, ys, yt):
            np.testing.assert_allclose(
                y.numpy(), y0 + jax_delta(x, a_t, b_s, ids), **TOL)


def test_group_add_refuses_what_it_cannot_take():
    """A y that is not f32, not contiguous, overlapping x2 or another y,
    or of other rows, and members whose contraction, slots or ranks
    differ, raise before any arithmetic."""
    rng = np.random.default_rng(4)
    x, stacks, ys, ids = group_inputs(rng, 3, 4, 64, (64, 32), "mixed")
    xt, st, yt, it = torch_group(x, stacks, ys, ids)
    cases = {
        "float32": [yt[0].to(torch.bfloat16), yt[1]],
        "contiguous": [torch.zeros(64, 3).t(), yt[1]],
        "overlaps": [yt[0], yt[0].view(-1)[:96].view(3, 32)],
        "rows' product": [yt[0][:2], yt[1]],
    }
    for match, bad in cases.items():
        with pytest.raises(ValueError, match=match):
            klora.lora_bgmv_add(xt, st, bad, it)
    wide = torch.zeros(3, 64)
    with pytest.raises(ValueError, match="overlaps"):
        klora.lora_bgmv_add(wide, [st[0]], [wide], it)
    other_c = (torch.zeros(SLOTS, 4, 32), torch.zeros(SLOTS, 4, 32))
    with pytest.raises(ValueError, match="do not match"):
        klora.lora_bgmv_add(xt, [st[0], other_c], yt, it)
    other_r = (torch.zeros(SLOTS, 2, 64), torch.zeros(SLOTS, 2, 32))
    with pytest.raises(ValueError, match="ranks differ"):
        klora.lora_bgmv_add(xt, [st[0], other_r], yt, it)
    with pytest.raises(ValueError, match="do not match"):
        klora.lora_bgmv_add(xt[:2], st, [y[:2] for y in yt], it)
    with pytest.raises(ValueError, match="1-3"):
        klora.lora_bgmv_add(xt, st * 2, yt * 2, it)
    np.testing.assert_array_equal(yt[0].numpy(), ys[0])


# --- the grouped forward against the per-target one ---


def per_target_group(keys, x, ys, lora_batch):
    """The forward's seam one target at a time (apply_group on each
    member alone), the calls every projection made before the group
    form."""
    return tuple(lora.apply_group((k,), x, (y,), lora_batch)[0]
                 for k, y in zip(keys, ys))


def _run_forward(model, layout, dtype):
    """A 3-row batch (base and two seed personas): a 24-token prefill
    (72 rows: the grouped einsums), a 4-token chunk (12 rows: K7's plain
    version) and two decode steps; every step's logits."""
    cfg = get_model_config(model, max_seq_len=128)
    gen = torch.Generator().manual_seed(3)
    params = common.init_params(cfg, gen, dtype, "cpu")
    store = lora.LoraStore(cfg, rank=4, max_adapters=3, dtype=dtype,
                           device="cpu",
                           adapters={"p": {"seed": 1, "init_std": 0.6},
                                     "q": {"seed": 2, "init_std": 0.6}})
    slots = store.acquire([None, "p", "q"])
    sink = {}
    batch = lora.LoraBatch(store, slots, sink)
    B, K, D = 3, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(3, 200, (B, 30)))
    if layout == "paged":
        ps = 16
        caches = [(torch.zeros(1 + B * 8, ps, K, D, dtype=dtype),
                   torch.zeros(1 + B * 8, ps, K, D, dtype=dtype))
                  for _ in range(cfg.num_layers)]
        table = (torch.arange(B * 8, dtype=torch.int32) + 1).reshape(B, 8)
    else:
        caches = [(torch.zeros(B, 128, K, D, dtype=dtype),
                   torch.zeros(B, 128, K, D, dtype=dtype))
                  for _ in range(cfg.num_layers)]
        rows = torch.arange(B, dtype=torch.int32)
    out, start = [], 0
    for n in (24, 4, 1, 1):
        tok = tokens[:, start:start + n]
        pos = (torch.arange(start, start + n, dtype=torch.int32)
               .expand(B, n).contiguous())
        valid = torch.full((B,), start + n, dtype=torch.int32)
        if layout == "paged":
            logits = forward_paged(params, cfg, tok, pos, caches, table,
                                   valid, lora=batch)
        else:
            logits = common.forward_cached(
                params, cfg, tok, pos, caches, rows, pos[:, 0].contiguous(),
                valid, lora=batch)
        out.append(logits)
        start += n
    return out, sink


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("model", ["tiny-llama", "tiny-gemma"])
def test_grouped_forward_equals_per_target_forward(monkeypatch, model,
                                                   layout, dtype):
    """The forward through apply_group (q/k/v and gate/up one call each)
    gives the per-target forward's logits bit for bit, with the same
    lora_paths entries: on the CPU both add K7's plain delta to the same
    f32 product once."""
    grouped, sink = _run_forward(model, layout, dtype)
    monkeypatch.setattr(common, "apply_group", per_target_group)
    per_target, sink_per_target = _run_forward(model, layout, dtype)
    for a, b in zip(grouped, per_target):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)
    assert sink == sink_per_target
    assert {e["path"] for e in sink.values()} == {"plain_bgmv",
                                                  "xla_grouped_bmm"}


def test_mode_grouped_takes_the_einsums_for_every_member():
    """A LoraBatch in mode "grouped" sends each member of a group to the
    grouped einsums (the reference a path is held against) with
    mode:grouped recorded."""
    cfg = get_model_config("tiny-llama")
    store = lora.LoraStore(cfg, rank=4, max_adapters=2, dtype=torch.float32,
                           device="cpu",
                           adapters={"p": {"seed": 1, "init_std": 0.6}})
    ids = store.acquire(["p", None])
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(2, 1, 64)).astype(np.float32))
    base = [torch.from_numpy(rng.normal(size=(2, 1, o)).astype(np.float32))
            for o in (64, 32, 32)]
    keys = ("q_proj", "k_proj", "v_proj")
    out = {}
    for mode in ("auto", "grouped"):
        sink = {}
        ys = tuple(y.clone() for y in base)
        out[mode] = lora.apply_group(keys, x, ys,
                                     lora.LoraBatch(store, ids, sink, mode))
        assert {e["leaf"] for e in sink.values()} == set(keys)
        if mode == "grouped":
            assert {e["fallback_reason"] for e in sink.values()} == {
                "mode:grouped"}
    for a, b in zip(out["auto"], out["grouped"]):
        torch.testing.assert_close(a, b, **TOL)


# --- K10f's group form ---


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("tp", ["col", "row"])
def test_k10f_group_equals_per_target_k10f(tp, rank):
    """On each coordinate of a 2-way model axis: lora_bgmv_add_spmd on the
    rank's shards equals y0 plus the per-target K10f plain version
    (lora_bgmv_spmd_ref) bit for bit - a column group of q/k/v where q's
    stacks shard and k/v's (one kv head) stay whole, or a row target alone
    with its contraction sharded."""
    mesh = Mesh(1, 2, rank)
    rng = np.random.default_rng(20 + rank)
    if tp == "col":
        c, outs, units = 256, (512, 128, 128), (8, 1, 1)
    else:
        c, outs, units = 512, (256,), (512,)
    x, stacks, ys, ids = group_inputs(rng, 8, 8, c, outs, "mixed")
    x_l = x if tp == "col" else x[:, rank * c // 2:(rank + 1) * c // 2]
    local = []
    for (a_t, b_s), o, u in zip(stacks, outs, units):
        which, c_l, o_l = klora.spmd_dims(mesh, c, o, tp, u)
        if which == "out":
            b_s = b_s[:, :, rank * o_l:(rank + 1) * o_l]
        elif which == "in":
            a_t = a_t[:, :, rank * c_l:(rank + 1) * c_l]
        local.append((np.ascontiguousarray(a_t), np.ascontiguousarray(b_s)))
    y0 = [y[:, :b.shape[2]].copy() for y, (_a, b) in zip(ys, local)]
    xt, st, yt, it = torch_group(np.ascontiguousarray(x_l), local, y0, ids)
    kw = dict(dims=[(c, o) for o in outs], tp=tp, units=list(units))
    assert klora.lora_bgmv_add_spmd(mesh, xt, st, yt, it, **kw) is None
    for n, ((a_t, b_s), y) in enumerate(zip(st, yt)):
        delta, why = klora.lora_bgmv_spmd_ref(
            mesh, xt, a_t, b_s, it, dims=(c, outs[n]), tp=tp,
            units=units[n])
        assert why is None
        assert torch.equal(y, torch.from_numpy(y0[n]) + delta)
    # The plain version on the same shards gives the same bits.
    yr = [torch.from_numpy(y.copy()) for y in y0]
    assert klora.lora_bgmv_add_spmd_ref(mesh, xt, st, yr, it, **kw) is None
    assert all(torch.equal(a, b) for a, b in zip(yt, yr))


def test_k10f_group_declines_and_checks_its_shards():
    """A member whose per-shard plan declines returns its reason and
    leaves every y untouched; local tensors that are not the rank's
    shard raise."""
    mesh = Mesh(1, 2, 0)
    rng = np.random.default_rng(30)
    x, stacks, ys, ids = group_inputs(rng, 80, 8, 256, (256, 256), "mixed")
    local = [(a, np.ascontiguousarray(b[:, :, :128])) for a, b in stacks]
    xt, st, yt, it = torch_group(x, local, [y[:, :128] for y in ys], ids)
    kw = dict(dims=[(256, 256)] * 2, tp="col", units=[256, 256])
    before = [y.clone() for y in yt]
    assert klora.lora_bgmv_add_spmd(mesh, xt, st, yt, it, **kw) == \
        "rows:prefill-m/sharded"
    assert all(torch.equal(a, b) for a, b in zip(yt, before))
    with pytest.raises(ValueError, match="not this rank's shard"):
        klora.lora_bgmv_add_spmd(
            mesh, xt, [(torch.from_numpy(a), torch.from_numpy(b))
                       for a, b in stacks], yt, it, **kw)
