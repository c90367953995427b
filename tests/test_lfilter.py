"""Generic transfer-function filter tests (lfilter / filtfilt family) —
scipy.signal parity in float64 plus the framework's streaming contracts
(blockwise == whole, scan == block fast path)."""

import numpy as np
import pytest
import scipy.signal as ss

import jax.numpy as jnp

from simpledsp_jax.ops.lfilter import (
    BlockLFilter, filtfilt, freqz, lfilter, lfilter_scan, lfilter_zi)


@pytest.fixture(scope="module")
def ba():
    return ss.butter(5, 0.2)


class TestLfilterScan:
    def test_matches_scipy(self, rng, ba):
        b, a = ba
        x = rng.standard_normal((3, 1000))
        y, _ = lfilter_scan(b, a, jnp.asarray(x))
        ref = ss.lfilter(b, a, x, axis=-1)
        assert np.max(np.abs(np.asarray(y) - ref)) < 1e-12

    def test_zi_and_final_state(self, rng, ba):
        b, a = ba
        x = rng.standard_normal((2, 300))
        zi0 = np.tile(ss.lfilter_zi(b, a), (2, 1)) * x[:, :1]
        y, zf = lfilter_scan(b, a, jnp.asarray(x), jnp.asarray(zi0))
        ref, rzf = ss.lfilter(b, a, x, axis=-1, zi=zi0)
        assert np.max(np.abs(np.asarray(y) - ref)) < 1e-12
        assert np.max(np.abs(np.asarray(zf) - rzf)) < 1e-12

    def test_fir_and_pure_gain(self, rng):
        x = rng.standard_normal(128)
        y, _ = lfilter_scan([0.5, 0.25], [1.0], jnp.asarray(x))
        assert np.allclose(np.asarray(y),
                           ss.lfilter([0.5, 0.25], [1.0], x), atol=1e-14)
        g, zf = lfilter_scan([3.0], [1.5], jnp.asarray(x))
        assert np.allclose(np.asarray(g), 2.0 * x, atol=1e-14)
        assert zf.shape == (0,)

    def test_lfilter_zi_matches_scipy(self, ba):
        b, a = ba
        assert np.max(np.abs(lfilter_zi(b, a) - ss.lfilter_zi(b, a))) < 1e-12

    def test_bad_coeffs_rejected(self, rng):
        x = jnp.asarray(rng.standard_normal(16))
        with pytest.raises(ValueError):
            lfilter_scan([1.0], [0.0], x)
        with pytest.raises(ValueError):
            lfilter_scan(np.ones((2, 2)), [1.0], x)


class TestBlockLFilter:
    def test_matches_scan(self, rng, ba):
        b, a = ba
        x = rng.standard_normal((2, 1024))
        blk = BlockLFilter(b, a, block_size=128, dtype=jnp.float64)
        y_blk, zf_blk = blk(jnp.asarray(x))
        y_ref, zf_ref = lfilter_scan(b, a, jnp.asarray(x))
        assert np.max(np.abs(np.asarray(y_blk) - np.asarray(y_ref))) < 1e-12
        assert np.max(np.abs(np.asarray(zf_blk) - np.asarray(zf_ref))) < 1e-12

    def test_streaming_split(self, rng, ba):
        """Splitting at an arbitrary boundary (incl. a non-block tail)
        equals the whole run — the reference's streaming contract
        (testIIR.cpp:61-75) for the generic filter."""
        b, a = ba
        x = rng.standard_normal(700)
        blk = BlockLFilter(b, a, block_size=128, dtype=jnp.float64)
        y_whole, _ = blk(jnp.asarray(x))
        ya, z = blk(jnp.asarray(x[:300]))
        yb, _ = blk(jnp.asarray(x[300:]), z)
        y_split = np.concatenate([np.asarray(ya), np.asarray(yb)])
        assert np.max(np.abs(y_split - np.asarray(y_whole))) < 1e-12

    def test_lfilter_auto_dispatch(self, rng, ba):
        b, a = ba
        x = rng.standard_normal(5000)
        y, _ = lfilter(b, a, jnp.asarray(x))
        assert np.max(np.abs(np.asarray(y)
                             - ss.lfilter(b, a, x))) < 1e-12


class TestFiltfilt:
    def test_matches_scipy_defaults(self, rng, ba):
        b, a = ba
        x = rng.standard_normal((2, 800))
        y = filtfilt(b, a, jnp.asarray(x))
        ref = ss.filtfilt(b, a, x, axis=-1)
        assert np.max(np.abs(np.asarray(y) - ref)) < 1e-11

    def test_high_order_and_zero_phase(self, rng):
        b, a = ss.cheby1(8, 1, 0.4)
        t = np.arange(2000)
        x = np.sin(2 * np.pi * 0.02 * t) + rng.standard_normal(2000) * 0.1
        y = np.asarray(filtfilt(b, a, jnp.asarray(x)))
        ref = ss.filtfilt(b, a, x)
        assert np.max(np.abs(y - ref)) < 1e-10
        # Zero phase: the low-frequency tone is not delayed.
        xc = np.sin(2 * np.pi * 0.02 * t)
        yc = np.asarray(filtfilt(b, a, jnp.asarray(xc)))
        core = slice(200, -200)
        lag = np.argmax(np.correlate(yc[core], xc[core], "full")) - \
            (yc[core].size - 1)
        assert lag == 0

    def test_padlen_too_long_rejected(self, rng, ba):
        b, a = ba
        with pytest.raises(ValueError):
            filtfilt(b, a, jnp.asarray(rng.standard_normal(10)))


def test_freqz_matches_scipy(ba):
    b, a = ba
    w, h = freqz(b, a, 256)
    wr, hr = ss.freqz(b, a, worN=256)
    assert np.max(np.abs(w - wr)) < 1e-12
    assert np.max(np.abs(h - hr)) < 1e-12


class TestResponseHelpers:
    """freqs / freqs_zpk / freqz_zpk / lfiltic vs scipy."""

    def test_freqs_matches_scipy(self):
        from simpledsp_jax.ops.lfilter import freqs
        bc, ac = ss.butter(4, 100.0, analog=True)
        w = np.logspace(0, 3, 50)
        w1, h1 = freqs(bc, ac, worN=w)
        w2, h2 = ss.freqs(bc, ac, worN=w)
        np.testing.assert_allclose(w1, w2)
        np.testing.assert_allclose(h1, h2, atol=1e-12)

    def test_freqs_zpk_freqz_zpk_match_scipy(self):
        from simpledsp_jax.ops.lfilter import freqs_zpk, freqz_zpk
        z, p, k = ss.butter(4, 100.0, analog=True, output="zpk")
        w = np.logspace(0, 3, 50)
        _, h1 = freqs_zpk(z, p, k, w)
        _, h2 = ss.freqs_zpk(z, p, k, worN=w)
        np.testing.assert_allclose(h1, h2, atol=1e-12)
        z, p, k = ss.butter(4, 0.3, output="zpk")
        w1, h1 = freqz_zpk(z, p, k, 128)
        w2, h2 = ss.freqz_zpk(z, p, k, worN=128)
        np.testing.assert_allclose(w1, w2)
        np.testing.assert_allclose(h1, h2, atol=1e-12)

    def test_lfiltic_matches_scipy_and_continues_stream(self, rng):
        from simpledsp_jax.ops.lfilter import lfilter, lfiltic
        b, a = ss.butter(4, 0.3)
        y_hist = rng.standard_normal(4)
        x_hist = rng.standard_normal(4)
        zi = lfiltic(b, a, y_hist, x_hist)
        np.testing.assert_allclose(zi, ss.lfiltic(b, a, y_hist, x_hist),
                                   atol=1e-14)
        zi_nox = lfiltic(b, a, y_hist)
        np.testing.assert_allclose(zi_nox, ss.lfiltic(b, a, y_hist),
                                   atol=1e-14)
        x = rng.standard_normal(64)
        y1, _ = lfilter(b, a, jnp.asarray(x), zi=jnp.asarray(zi))
        y2, _ = ss.lfilter(b, a, x, zi=zi)
        np.testing.assert_allclose(np.asarray(y1), y2, atol=1e-12)


def test_freqs_positional_worN_and_freqz_zpk_array():
    """scipy calling conventions (review-fixed regression pin)."""
    from simpledsp_jax.ops.lfilter import freqs, freqz_zpk
    bc, ac = ss.butter(4, 100.0, analog=True)
    w = np.logspace(0, 3, 50)
    _, h1 = freqs(bc, ac, w)                  # positional array
    _, h2 = ss.freqs(bc, ac, worN=w)
    np.testing.assert_allclose(h1, h2, atol=1e-12)
    wn, _ = freqs(bc, ac, 64)                 # positional int
    assert wn.size == 64
    z, p, k = ss.butter(4, 0.3, output="zpk")
    warr = np.linspace(0.01, 0.99 * np.pi, 33)
    _, h1 = freqz_zpk(z, p, k, warr)
    _, h2 = ss.freqz_zpk(z, p, k, worN=warr)
    np.testing.assert_allclose(h1, h2, atol=1e-12)
