"""2-D transform + convolution layer: ops/fft.py 2-D entries and
ops/conv2d.py vs numpy.fft / scipy.signal."""

import numpy as np
import pytest
import scipy.signal as sig

import jax.numpy as jnp

from simpledsp_jax.ops.conv2d import convolve2d, correlate2d
from simpledsp_jax.ops.fft import (fft2, fft2_ri, ifft2, irfft2_ri,
                                   rfft2_ri)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


class TestFFT2:
    @pytest.mark.parametrize("shape", [(8, 16), (3, 12, 20), (2, 31, 17)])
    def test_fft2_ifft2_match_numpy(self, rng, shape):
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        np.testing.assert_allclose(np.asarray(fft2(jnp.asarray(x))),
                                   np.fft.fft2(x), atol=1e-10)
        np.testing.assert_allclose(np.asarray(ifft2(jnp.asarray(x))),
                                   np.fft.ifft2(x), atol=1e-12)

    @pytest.mark.parametrize("shape", [(8, 16), (5, 12, 21), (2, 9, 32)])
    def test_rfft2_matches_numpy_and_roundtrips(self, rng, shape):
        x = rng.standard_normal(shape)
        yr, yi = rfft2_ri(jnp.asarray(x))
        got = np.asarray(yr) + 1j * np.asarray(yi)
        np.testing.assert_allclose(got, np.fft.rfft2(x), atol=1e-10)
        back = np.asarray(irfft2_ri(yr, yi, shape[-1]))
        np.testing.assert_allclose(back, x, atol=1e-12)

    def test_fft2_ri_parseval(self, rng):
        x = rng.standard_normal((16, 32))
        yr, yi = fft2_ri(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)))
        energy = (np.asarray(yr) ** 2 + np.asarray(yi) ** 2).sum()
        np.testing.assert_allclose(energy / x.size, (x * x).sum(),
                                   rtol=1e-12)


class TestConv2d:
    @pytest.mark.parametrize("ksize", [(3, 3), (4, 5), (7, 2), (1, 1)])
    @pytest.mark.parametrize("mode", ["full", "same", "valid"])
    @pytest.mark.parametrize("boundary", ["fill", "wrap", "symm"])
    def test_convolve_matches_scipy(self, rng, ksize, mode, boundary):
        x = rng.standard_normal((12, 15))
        k = rng.standard_normal(ksize)
        for method in ("direct", "fft"):
            got = np.asarray(convolve2d(jnp.asarray(x), k, mode,
                                        boundary=boundary, method=method))
            want = sig.convolve2d(x, k, mode, boundary=boundary)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-10)

    @pytest.mark.parametrize("ksize", [(3, 3), (4, 5), (7, 2)])
    @pytest.mark.parametrize("mode", ["full", "same", "valid"])
    def test_correlate_matches_scipy(self, rng, ksize, mode):
        x = rng.standard_normal((12, 15))
        k = rng.standard_normal(ksize)
        got = np.asarray(correlate2d(jnp.asarray(x), k, mode))
        want = sig.correlate2d(x, k, mode)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-10)

    @pytest.mark.parametrize("mode", ["full", "same", "valid"])
    def test_complex_inputs(self, rng, mode):
        x = rng.standard_normal((10, 11)) + 1j * rng.standard_normal((10, 11))
        k = rng.standard_normal((4, 3)) + 1j * rng.standard_normal((4, 3))
        np.testing.assert_allclose(
            np.asarray(convolve2d(jnp.asarray(x), k, mode)),
            sig.convolve2d(x, k, mode), atol=1e-10)
        np.testing.assert_allclose(
            np.asarray(correlate2d(jnp.asarray(x), k, mode)),
            sig.correlate2d(x, k, mode), atol=1e-10)

    def test_batched_leading_axes(self, rng):
        x = rng.standard_normal((3, 2, 12, 15))
        k = rng.standard_normal((3, 3))
        got = np.asarray(convolve2d(jnp.asarray(x), k, "same"))
        for i in range(3):
            for j in range(2):
                np.testing.assert_allclose(
                    got[i, j], sig.convolve2d(x[i, j], k, "same"),
                    atol=1e-10)

    def test_fillvalue(self, rng):
        x = rng.standard_normal((6, 6))
        k = rng.standard_normal((3, 3))
        got = np.asarray(convolve2d(jnp.asarray(x), k, "full",
                                    fillvalue=2.5))
        want = sig.convolve2d(x, k, "full", fillvalue=2.5)
        np.testing.assert_allclose(got, want, atol=1e-10)

    def test_rejects_bad_args(self, rng):
        x = jnp.asarray(rng.standard_normal((6, 6)))
        k = rng.standard_normal((3, 3))
        with pytest.raises(ValueError):
            convolve2d(x, k, "same", boundary="reflect")
        with pytest.raises(ValueError):
            convolve2d(x, k, "ful")
        with pytest.raises(ValueError):
            convolve2d(x, rng.standard_normal(3))
        with pytest.raises(ValueError):
            convolve2d(x, rng.standard_normal((7, 7)), "valid")
        with pytest.raises(ValueError):
            convolve2d(x, k, method="winograd")


class TestConv2dShapes:
    """The f32 direct route at the shapes the former fused direct kernel
    was checked at (odd sizes, even and 1-wide kernels, extra batch
    axes) against scipy in float64."""

    @pytest.mark.parametrize("shape,ks", [
        ((2, 70, 90), (9, 9)),
        ((1, 130, 200), (5, 7)),
        ((3, 2, 40, 50), (3, 3)),
        ((1, 128, 128), (13, 13)),
        ((1, 17, 33), (4, 2)),
        ((1, 8, 130), (1, 3)),
    ])
    def test_direct_f32_matches_scipy(self, rng, shape, ks):
        x = rng.standard_normal(shape)
        k = rng.standard_normal(ks)
        got = np.asarray(convolve2d(jnp.asarray(x, jnp.float32), k,
                                    "valid", method="direct"))
        flat = x.reshape((-1,) + shape[-2:])
        ref = np.stack([sig.convolve2d(a, k, "valid") for a in flat])
        assert got.shape == ref.reshape(shape[:-2] + ref.shape[-2:]).shape
        np.testing.assert_allclose(got.reshape(ref.shape), ref,
                                   atol=2e-5 * np.abs(ref).max())

    def test_direct_and_fft_routes_agree_9x9(self, rng):
        x = jnp.asarray(rng.standard_normal((2, 96, 80)))
        k = rng.standard_normal((9, 9))
        a = np.asarray(convolve2d(x, k, "same", method="direct"))
        b = np.asarray(convolve2d(x, k, "same", method="fft"))
        np.testing.assert_allclose(a, b, atol=1e-10)
