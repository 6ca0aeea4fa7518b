"""PyTorch port, GPipe full-sequence prefill (engine/pipeline.py), against
the JAX package's make_pp_prefill on the virtual 8-CPU mesh.

The JAX side stacks the stages of one numpy parameter tree over a "pipe"
mesh; the port runs one gloo rank per stage, each holding only its
stage's slice of the same tree (weights.params_from_numpy with `stage=`),
and every rank returns the last stage's logits [B, T, V]. Logits agree
within LOGIT_ATOL in f32 at 2 and 4 stages, with 1 and 2 microbatches, on
llama, gemma (scaled embeddings, tied head: the last stage holds the
embedding as its head) and mistral (a sliding window inside stages).
Layers that do not split into the stages raise JAX's message. This module
imports only torch and numpy at its top (the spawned ranks import it);
each stage count's ranks are spawned once."""

import numpy as np
import pytest
import torch

from theroundtaible_tpu_torch.engine import distributed

SPAWN_TIMEOUT_S = 300.0
LOGIT_ATOL = 1e-4
# (model, layers, stages, n_micro)
CASES = [("tiny-llama", 2, 2, 1), ("tiny-llama", 2, 2, 2),
         ("tiny-gemma", 2, 2, 2), ("tiny-mistral", 2, 2, 2),
         ("tiny-llama", 4, 4, 1), ("tiny-llama", 4, 4, 2)]


def _inputs(model, n_micro, vocab):
    b, t = 2 * n_micro, 16
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, vocab, (b, t)).astype(np.int32)
    positions = np.broadcast_to(np.arange(t)[None, :], (b, t)).astype(
        np.int32)
    valid = np.full((b,), t, np.int32)
    if model == "tiny-llama":
        valid[0] = t - 5   # a row whose last positions are padding
    return tokens, positions, valid


def _rank(rank, runs):
    """Each run: this rank's stage of the tree, the port's pp_prefill."""
    torch.set_num_threads(1)
    from theroundtaible_tpu_torch.engine.models.common import Stage
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.pipeline import (build_pipe_mesh,
                                                          make_pp_prefill)
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    world = torch.distributed.get_world_size()
    mesh = build_pipe_mesh({"pipe": world})
    out = []
    for model, layers, n_micro, tree, (tokens, positions, valid) in runs:
        cfg = get_model_config(model, max_seq_len=64, num_layers=layers)
        params = params_from_numpy(tree, cfg, torch.float32, "cpu",
                                   stage=Stage(mesh.stage, world))
        pp = make_pp_prefill(cfg, mesh, n_micro)
        logits = pp(params, torch.from_numpy(tokens).long(),
                    torch.from_numpy(positions), torch.from_numpy(valid))
        out.append({"logits": logits.numpy(),
                    "leaves": sorted(k for k in params if k != "layers"),
                    "layers": len(params["layers"])})
    return out


def _jax_logits(model, layers, stages, n_micro):
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.models.common import \
        init_params as jax_init
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu.engine.pipeline import (build_pipe_mesh,
                                                    make_pp_prefill,
                                                    stack_stage_params)
    cfg = jax_config(model, max_seq_len=64, num_layers=layers)
    params = jax_init(cfg, jax.random.PRNGKey(0), jnp.float32)
    inputs = _inputs(model, n_micro, cfg.vocab_size)
    mesh = build_pipe_mesh(stages)
    shared, staged = stack_stage_params(params, cfg, stages, mesh)
    pp = make_pp_prefill(cfg, mesh, n_micro)
    got = pp(shared, staged, *(jnp.asarray(x) for x in inputs))
    return jax.device_get(params), inputs, np.asarray(got, np.float32)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for stages in (2, 4):
        cases = [c for c in CASES if c[2] == stages]
        jax_side = [_jax_logits(*c) for c in cases]
        ranks = distributed.launch(
            _rank, stages, "gloo", "cpu",
            args=([(m, layers, n_micro, tree, inputs)
                   for (m, layers, _s, n_micro), (tree, inputs, _l)
                   in zip(cases, jax_side)],),
            timeout_s=SPAWN_TIMEOUT_S)
        for i, case in enumerate(cases):
            out[case] = (jax_side[i][2], [r[i] for r in ranks])
    return out


@pytest.mark.parametrize("case", CASES, ids=[
    f"{m}-{s}stages-micro{n}" for m, _l, s, n in CASES])
def test_pp_prefill_matches_jax(runs, case):
    want, ranks = runs[case]
    for r in ranks:
        np.testing.assert_allclose(r["logits"], want, atol=LOGIT_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("case", CASES[:4], ids=[
    f"{m}-micro{n}" for m, _l, _s, n in CASES[:4]])
def test_each_stage_holds_only_its_leaves(runs, case):
    """Stage 0 holds the embedding and its layer; the last stage its layer,
    the final norm and the head (the embedding where it is tied)."""
    model = case[0]
    _want, (first, last) = runs[case]
    head = ["embedding"] if model == "tiny-gemma" else ["lm_head"]
    assert first["leaves"] == ["embedding"] and first["layers"] == 1
    assert last["leaves"] == sorted(["final_norm"] + head)
    assert last["layers"] == 1


def test_indivisible_layers_raise_as_jax():
    """Two layers over three stages: the port's Stage, make_pp_prefill and
    PPEngine raise JAX's stack_stage_params message, before any process
    group is needed."""
    import jax
    from theroundtaible_tpu.engine.models.common import \
        init_params as jax_init
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu.engine.pipeline import (build_pipe_mesh,
                                                    stack_stage_params)
    from theroundtaible_tpu_torch.engine.models.common import Stage
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.pipeline import make_pp_prefill
    from theroundtaible_tpu_torch.engine.pp_serving import PPEngine
    from theroundtaible_tpu_torch.engine.sharding import PipeMesh
    jcfg = jax_config("tiny-llama")
    with pytest.raises(ValueError, match="split") as jax_err:
        stack_stage_params(jax_init(jcfg, jax.random.PRNGKey(4)), jcfg, 3,
                           build_pipe_mesh(2))
    cfg = get_model_config("tiny-llama")
    for call in (lambda: Stage(0, 3).layers(cfg.num_layers),
                 lambda: make_pp_prefill(cfg, PipeMesh(3, 1, 0), 2),
                 lambda: PPEngine(cfg, n_stages=3, device="cpu")):
        with pytest.raises(ValueError) as err:
            call()
        assert str(err.value) == str(jax_err.value)


def test_stage_init_equals_slices_of_one_device_init():
    """init_params with a stage draws every leaf in order and keeps its
    own: stage s holds exactly the tensors one device draws from the same
    seed, for both stages of gemma (tied) and llama."""
    from theroundtaible_tpu_torch.engine.models.common import (Stage,
                                                               init_params)
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    for model in ("tiny-llama", "tiny-gemma"):
        cfg = get_model_config(model, num_layers=4)
        whole = init_params(cfg, torch.Generator().manual_seed(5),
                            torch.float32, "cpu")
        for s in range(2):
            part = init_params(cfg, torch.Generator().manual_seed(5),
                               torch.float32, "cpu", stage=Stage(s, 2))
            for i, layer in enumerate(part["layers"]):
                for k, v in layer.items():
                    assert torch.equal(v, whole["layers"][2 * s + i][k])
            for k in ("embedding", "final_norm", "lm_head"):
                if k in part:
                    assert torch.equal(part[k], whole[k])
