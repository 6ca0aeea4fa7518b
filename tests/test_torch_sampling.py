"""PyTorch port, sampling: greedy is the same argmax, the top-k/top-p
filtered logits equal the JAX package's, and sampled draws (torch's own
random bits) land only inside the kept set."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theroundtaible_tpu.engine import sampling as jsampling
from theroundtaible_tpu_torch.engine import sampling as tsampling


def _rows(seed=0, b=6, v=512):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(b, v)) * 3).astype(np.float32)
    temps = np.asarray([0.7, 1.0, 0.3, 1.3, 0.9, 1.0], np.float32)[:b]
    top_ks = np.asarray([0, 5, 40, 0, 200, 1], np.int32)[:b]
    top_ps = np.asarray([0.9, 1.0, 0.5, 0.95, 0.8, 1.0], np.float32)[:b]
    return logits, temps, top_ks, top_ps


def test_greedy_is_identical():
    logits, _, top_ks, top_ps = _rows(1, b=4)
    temps = np.zeros(4, np.float32)
    ours = tsampling.sample_token_batch(
        torch.from_numpy(logits), torch.Generator().manual_seed(0),
        torch.from_numpy(temps), torch.from_numpy(top_ks[:4]),
        torch.from_numpy(top_ps[:4]))
    ref = jsampling.sample_token_batch(
        jnp.asarray(logits), jnp.zeros(2, jnp.uint32), jnp.asarray(temps),
        jnp.asarray(top_ks[:4]), jnp.asarray(top_ps[:4]))
    assert ours.tolist() == np.asarray(ref).tolist()
    assert ours.tolist() == np.argmax(logits, axis=-1).tolist()


def test_exact_tail_filters_identically():
    logits, temps, top_ks, top_ps = _rows(2)
    scaled = logits / np.maximum(temps[:, None], 1e-6)
    ours = tsampling._exact_tail(torch.from_numpy(scaled),
                                 torch.from_numpy(top_ks),
                                 torch.from_numpy(top_ps)).numpy()
    ref = np.asarray(jsampling._exact_tail(
        jnp.asarray(scaled), jnp.asarray(top_ks), jnp.asarray(top_ps)))
    np.testing.assert_array_equal(np.isfinite(ours), np.isfinite(ref))
    np.testing.assert_array_equal(ours[np.isfinite(ours)],
                                  ref[np.isfinite(ref)])


def test_fast_path_keeps_the_exact_set():
    """The candidate-pool filter (and its per-row exact fallback for
    top_k beyond the pool) keeps the same tokens as the exact tail."""
    logits, temps, top_ks, top_ps = _rows(3)
    scaled = logits / np.maximum(temps[:, None], 1e-6)
    ours = tsampling.filtered_logits(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(top_ks), torch.from_numpy(top_ps)).numpy()
    ref = np.asarray(jsampling._exact_tail(
        jnp.asarray(scaled), jnp.asarray(top_ks), jnp.asarray(top_ps)))
    np.testing.assert_array_equal(np.isfinite(ours), np.isfinite(ref))


def test_sampled_draws_stay_in_the_kept_set():
    logits, temps, top_ks, top_ps = _rows(4)
    scaled = logits / np.maximum(temps[:, None], 1e-6)
    kept = np.isfinite(np.asarray(jsampling._exact_tail(
        jnp.asarray(scaled), jnp.asarray(top_ks), jnp.asarray(top_ps))))
    reps = 200
    gen = torch.Generator().manual_seed(7)
    draws = tsampling.sample_token_batch(
        torch.from_numpy(np.repeat(logits, reps, axis=0)), gen,
        torch.from_numpy(np.repeat(temps, reps)),
        torch.from_numpy(np.repeat(top_ks, reps)),
        torch.from_numpy(np.repeat(top_ps, reps))).numpy()
    rows = np.repeat(np.arange(len(temps)), reps)
    assert kept[rows, draws].all()
    # the top_k == 1 row is deterministic; wider rows do vary
    assert len(set(draws[rows == 5])) == 1
    assert len(set(draws[rows == 0])) > 1


@pytest.mark.parametrize("params", [
    [jsampling.SamplingParams()],
    [jsampling.SamplingParams(temperature=0.7, top_k=20)],
    [jsampling.SamplingParams(temperature=0.7, top_k=500)],
])
def test_sampler_mode_matches(params):
    ported = [tsampling.SamplingParams(**p.__dict__) for p in params]
    assert tsampling.sampler_mode(ported) == jsampling.sampler_mode(params)
