"""Smoothing layer parity vs scipy.signal (ops/smooth.py)."""

import numpy as np
import pytest
import scipy.signal as sig

import jax.numpy as jnp

from simpledsp_jax.ops.smooth import (detrend, medfilt, medfilt2d,
                                      order_filter, savgol_coeffs,
                                      savgol_filter, wiener)


@pytest.fixture
def rng():
    return np.random.default_rng(77)


class TestSavgol:
    @pytest.mark.parametrize("wl,po,d", [(5, 2, 0), (11, 3, 1), (21, 4, 2),
                                         (7, 6, 0)])
    def test_coeffs_match_scipy(self, wl, po, d):
        np.testing.assert_allclose(savgol_coeffs(wl, po, deriv=d),
                                   sig.savgol_coeffs(wl, po, deriv=d),
                                   atol=1e-13)

    @pytest.mark.parametrize("mode", ["interp", "mirror", "constant",
                                      "nearest", "wrap"])
    @pytest.mark.parametrize("wl,po,d,delta", [(11, 3, 0, 1.0),
                                               (11, 3, 1, 0.5),
                                               (9, 2, 2, 2.0)])
    def test_filter_matches_scipy(self, rng, mode, wl, po, d, delta):
        x = rng.standard_normal(200).cumsum()
        got = np.asarray(savgol_filter(jnp.asarray(x), wl, po, deriv=d,
                                       delta=delta, mode=mode))
        want = sig.savgol_filter(x, wl, po, deriv=d, delta=delta, mode=mode)
        np.testing.assert_allclose(got, want, atol=1e-9)

    def test_batched(self, rng):
        x = rng.standard_normal((4, 100))
        got = np.asarray(savgol_filter(jnp.asarray(x), 9, 3))
        for i in range(4):
            np.testing.assert_allclose(got[i], sig.savgol_filter(x[i], 9, 3),
                                       atol=1e-10)

    def test_rejects_bad_args(self, rng):
        x = jnp.asarray(rng.standard_normal(50))
        with pytest.raises(ValueError):
            savgol_filter(x, 8, 3)
        with pytest.raises(ValueError):
            savgol_filter(x, 9, 9)
        with pytest.raises(ValueError):
            savgol_filter(x, 51, 3, mode="interp")
        with pytest.raises(ValueError):
            savgol_filter(x, 9, 3, mode="reflect")


class TestMedian:
    @pytest.mark.parametrize("k", [1, 3, 5, 9])
    def test_medfilt_matches_scipy(self, rng, k):
        x = rng.standard_normal(200)
        np.testing.assert_array_equal(
            np.asarray(medfilt(jnp.asarray(x), k)), sig.medfilt(x, k))

    @pytest.mark.parametrize("k", [3, 5, (3, 5)])
    def test_medfilt2d_matches_scipy(self, rng, k):
        im = rng.standard_normal((20, 24))
        np.testing.assert_array_equal(
            np.asarray(medfilt2d(jnp.asarray(im), k)), sig.medfilt2d(im, k))

    def test_rejects_even_kernel(self, rng):
        with pytest.raises(ValueError):
            medfilt(jnp.asarray(rng.standard_normal(10)), 4)
        with pytest.raises(ValueError):
            medfilt2d(jnp.asarray(rng.standard_normal((5, 5))), (3, 4))


class TestWiener:
    @pytest.mark.parametrize("mysize,noise", [(3, None), (5, 0.5),
                                              ((3, 7), None)])
    def test_2d_matches_scipy(self, rng, mysize, noise):
        im = rng.standard_normal((20, 24))
        got = np.asarray(wiener(jnp.asarray(im), mysize, noise))
        np.testing.assert_allclose(got, sig.wiener(im, mysize, noise),
                                   atol=1e-10)

    @pytest.mark.parametrize("mysize,noise", [(3, None), (7, 0.25)])
    def test_1d_matches_scipy(self, rng, mysize, noise):
        x = rng.standard_normal(300)
        got = np.asarray(wiener(jnp.asarray(x), mysize, noise))
        np.testing.assert_allclose(got, sig.wiener(x, mysize, noise),
                                   atol=1e-10)


class TestDetrend:
    @pytest.mark.parametrize("kind", ["linear", "constant"])
    def test_matches_scipy(self, rng, kind):
        x = rng.standard_normal((3, 400)).cumsum(axis=-1)
        got = np.asarray(detrend(jnp.asarray(x), type=kind))
        np.testing.assert_allclose(got, sig.detrend(x, type=kind, axis=-1),
                                   atol=1e-9)

    def test_rejects_unknown_type(self, rng):
        with pytest.raises(ValueError):
            detrend(jnp.asarray(rng.standard_normal(10)), type="quadratic")


class TestOrderFilter:
    def test_matches_scipy_hole_free(self, rng):
        """Hole-free domains: scipy's rank_filter path is correct there."""
        x2 = rng.standard_normal((20, 25))
        got = np.asarray(order_filter(jnp.asarray(x2), np.ones((3, 5)), 7))
        ref = sig.order_filter(x2, np.ones((3, 5)), 7)
        np.testing.assert_allclose(got, ref)
        x1 = rng.standard_normal(50)
        got1 = np.asarray(order_filter(jnp.asarray(x1), np.ones(5), 2))
        ref1 = sig.order_filter(x1, np.ones(5), 2)
        np.testing.assert_allclose(got1, ref1)

    def test_holed_domain_true_semantics(self, rng):
        """Domains with holes: rank over the SELECTED neighbors only
        (scipy 1.17's rank_filter ignores footprint holes — verified in
        ops/smooth.py docstring; we honor the documented semantics and
        pin them against a direct numpy reference)."""
        x = rng.standard_normal(30)
        dom = np.array([1, 0, 1, 1, 1])
        got = np.asarray(order_filter(jnp.asarray(x), dom, 1))
        offs = [j - 2 for j in np.flatnonzero(dom)]
        ref = np.array([
            np.sort([x[t + o] if 0 <= t + o < 30 else 0.0 for o in offs])[1]
            for t in range(30)])
        np.testing.assert_allclose(got, ref)
        # and scipy 1.17 indeed ignores the hole (upstream behavior pin)
        assert np.allclose(sig.order_filter(x, dom, 1),
                           sig.order_filter(x, np.ones(5), 1))

    def test_median_special_case_and_errors(self, rng):
        x = rng.standard_normal((2, 40))
        np.testing.assert_allclose(
            np.asarray(order_filter(jnp.asarray(x), np.ones(5), 2)),
            np.asarray(medfilt(jnp.asarray(x), 5)))
        with pytest.raises(ValueError):
            order_filter(jnp.zeros(8), np.ones(4), 0)      # even domain
        with pytest.raises(ValueError):
            order_filter(jnp.zeros(8), np.ones(5), 5)      # rank range
        with pytest.raises(ValueError):
            order_filter(jnp.zeros(8), np.ones((3, 3, 3)), 0)
