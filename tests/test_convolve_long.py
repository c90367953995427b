"""convolve on long signals (the streaming overlap-save route) at the
shapes the former fused overlap-save kernel was checked at, against
numpy in float64."""

import jax.numpy as jnp
import numpy as np
import pytest

from simpledsp_jax.ops.conv import convolve


@pytest.mark.parametrize("t,m", [(65536, 301), (10000, 301), (8192, 129),
                                 (4096, 257)])
def test_full_convolution_matches_numpy(rng, t, m):
    x = rng.standard_normal((2, t))
    h = rng.standard_normal(m)
    y = np.asarray(convolve(jnp.asarray(x), h, mode="full"))
    ref = np.stack([np.convolve(r, h) for r in x])
    assert y.shape == ref.shape
    np.testing.assert_allclose(y, ref, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["same", "valid"])
def test_modes_64k_301(rng, mode):
    x = rng.standard_normal((2, 65536))
    h = rng.standard_normal(301)
    y = np.asarray(convolve(jnp.asarray(x), h, mode=mode))
    ref = np.stack([np.convolve(r, h, mode=mode) for r in x])
    assert y.shape == ref.shape
    np.testing.assert_allclose(y, ref, atol=1e-12 * np.abs(ref).max())


def test_single_tap_identity(rng):
    x = rng.standard_normal(10000)
    y = np.asarray(convolve(jnp.asarray(x), np.array([2.5]), method="fft"))
    np.testing.assert_allclose(y, 2.5 * x, atol=1e-12)


def test_leading_batch_axes(rng):
    x = rng.standard_normal((2, 3, 8192))
    h = rng.standard_normal(65)
    y = np.asarray(convolve(jnp.asarray(x), h, method="fft"))
    assert y.shape == (2, 3, 8192 + 64)
    np.testing.assert_allclose(y[1, 2], np.convolve(x[1, 2], h), atol=1e-11)


def test_f32_long_signal(rng):
    """f32 on the overlap-save route: error at f32 rounding of the
    matmul FFT (HIGHEST), relative to the output scale."""
    x = rng.standard_normal((2, 65536)).astype(np.float32)
    h = rng.standard_normal(301).astype(np.float32)
    y = np.asarray(convolve(jnp.asarray(x), h, mode="full"))
    ref = np.stack([np.convolve(r.astype(np.float64), h) for r in x])
    assert y.dtype == np.float32
    np.testing.assert_allclose(y, ref, atol=2e-5 * np.abs(ref).max())
