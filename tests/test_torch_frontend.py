"""The port's log-mel frontend and instance norm against the JAX package's."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from convasr_tpu.frontend import logmel as jax_logmel
from convasr_tpu_torch.frontend import logmel


def signal(seed, B=3, T=4000):
    rng = np.random.RandomState(seed)
    return (0.3 * rng.randn(B, T) * np.linspace(0.1, 1.0, T)).astype(np.float32)


@pytest.mark.parametrize('window', ['hann_window', 'hamming_window'])
@pytest.mark.parametrize('features,sr', [(64, 8000), (16, 8000), (40, 16000)])
def test_logmel_matches_jax(features, sr, window):
    x = signal(0, T=sr // 2)
    kw = dict(out_channels=features, sample_rate=sr, window_size=0.02, window_stride=0.01,
              window=window, dither=0.0)
    ref = np.asarray(jax_logmel.LogFilterBankFrontend(**kw)(jnp.asarray(x)))
    ours = logmel.LogFilterBankFrontend(**kw)(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)


def test_logmel_masked_and_short_signal_match_jax():
    kw = dict(out_channels=16, sample_rate=8000, window_size=0.02, window_stride=0.01,
              dither=0.0)
    x = signal(1)
    lengths = np.array([4000, 2500, 1300])
    mask = (np.arange(x.shape[1])[None] < lengths[:, None]).astype(np.float32)
    ref = np.asarray(jax_logmel.LogFilterBankFrontend(**kw)(jnp.asarray(x), mask=jnp.asarray(mask)))
    ours = logmel.LogFilterBankFrontend(**kw)(torch.from_numpy(x), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=1e-4)
    # shorter than the pad: zero-pad instead of reflect
    short = x[:, :100]
    ref = np.asarray(jax_logmel.LogFilterBankFrontend(**kw)(jnp.asarray(short)))
    ours = logmel.LogFilterBankFrontend(**kw)(torch.from_numpy(short)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('masked', [False, True])
def test_masked_instance_norm_matches_jax(masked):
    rng = np.random.RandomState(2)
    x = (3 + 2 * rng.randn(4, 50, 16)).astype(np.float32)
    mask = (np.arange(50)[None] < np.array([50, 31, 12, 44])[:, None]) if masked else None
    ref = np.asarray(jax_logmel.masked_instance_norm(
        jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask)))
    ours = logmel.masked_instance_norm(
        torch.from_numpy(x), mask=None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def test_output_lengths_in_float32_match_jax():
    frac = np.random.RandomState(3).uniform(0.01, 1.0, 2000).astype(np.float32)
    for T in (37, 251, 1500):
        ref = np.asarray(jax_logmel.compute_output_lengths(T, jnp.asarray(frac)))
        ours = logmel.compute_output_lengths(T, torch.from_numpy(frac)).numpy()
        np.testing.assert_array_equal(ours, ref)
