"""B-spline family vs scipy.signal (ops/splines.py)."""

import numpy as np
import pytest
import scipy.signal as ss

import jax.numpy as jnp

from simpledsp_jax.ops import splines as sp


def test_spline_coefficients_match_scipy(rng):
    x = rng.standard_normal(50)
    np.testing.assert_allclose(sp.cspline1d(x), ss.cspline1d(x), atol=1e-12)
    np.testing.assert_allclose(sp.qspline1d(x), ss.qspline1d(x), atol=1e-12)
    # single-sample branch (incl. scipy's skipped-gain quirk, replicated)
    np.testing.assert_allclose(sp.cspline1d(x[:1]), ss.cspline1d(x[:1]))
    np.testing.assert_allclose(sp.qspline1d(x[:1]), ss.qspline1d(x[:1]))
    with pytest.raises(ValueError):
        sp.qspline1d(x, lamb=1.0)


def test_spline_eval_matches_scipy_and_interpolates(rng):
    x = rng.standard_normal(50)
    cj = ss.cspline1d(x)
    qj = ss.qspline1d(x)
    newx = rng.uniform(-20, 70, 300)      # includes mirror extrapolation
    np.testing.assert_allclose(sp.cspline1d_eval(cj, newx),
                               ss.cspline1d_eval(cj, newx), atol=1e-12)
    np.testing.assert_allclose(sp.qspline1d_eval(qj, newx),
                               ss.qspline1d_eval(qj, newx), atol=1e-12)
    np.testing.assert_allclose(
        sp.cspline1d_eval(cj, newx, dx=0.5, x0=2.0),
        ss.cspline1d_eval(cj, newx, dx=0.5, x0=2.0), atol=1e-12)
    # the defining property: evaluation at the knots returns the samples
    np.testing.assert_allclose(sp.cspline1d_eval(cj, np.arange(50.0)), x,
                               atol=1e-12)
    with pytest.raises(ValueError):
        sp.cspline1d_eval(np.empty(0), newx)


def test_sepfir2d_matches_scipy(rng):
    img = rng.standard_normal((20, 30))
    hr = rng.standard_normal(5)
    hc = rng.standard_normal(7)
    got = np.asarray(sp.sepfir2d(jnp.asarray(img), hr, hc))
    np.testing.assert_allclose(got, ss.sepfir2d(img, hr, hc), atol=1e-12)
    # batched leading axis
    imgs = rng.standard_normal((3, 12, 14))
    got = np.asarray(sp.sepfir2d(jnp.asarray(imgs), hr, hc))
    for i in range(3):
        np.testing.assert_allclose(got[i], ss.sepfir2d(imgs[i], hr, hc),
                                   atol=1e-12)
    with pytest.raises(ValueError):
        sp.sepfir2d(jnp.zeros((4, 4)), np.ones(4), hc)   # even taps
    with pytest.raises(ValueError):
        sp.sepfir2d(jnp.zeros(4), hr, hc)                # 1-D input


def test_gauss_spline_matches_scipy(rng):
    x = rng.standard_normal(64)
    got = np.asarray(sp.gauss_spline(jnp.asarray(x), 3))
    np.testing.assert_allclose(got, ss.gauss_spline(x, 3), atol=1e-14)


def test_symiirorder1_and_2d_splines_match_scipy(rng):
    r = -2.0 + np.sqrt(3.0)
    x = rng.standard_normal(60)
    np.testing.assert_allclose(
        sp.symiirorder1(x, -r * 6, r, 1e-8),
        ss.symiirorder1(x, -r * 6, r, precision=1e-8), atol=1e-12)
    # default precision: eps-truncation, ~1e-12 agreement with scipy's
    # default, and the SAME did-not-converge raise on short signals
    np.testing.assert_allclose(sp.symiirorder1(x, -r * 6, r),
                               ss.symiirorder1(x, -r * 6, r), atol=1e-10)
    with pytest.raises(ValueError, match="did not converge"):
        sp.symiirorder1(x[:8], -r * 6, r)          # short + DEFAULT prec
    X = rng.standard_normal((30, 40))
    np.testing.assert_allclose(sp.cspline2d(X), ss.cspline2d(X),
                               atol=1e-12)
    np.testing.assert_allclose(sp.qspline2d(X), ss.qspline2d(X),
                               atol=1e-12)
    with pytest.raises(ValueError):
        sp.symiirorder1(x, 1.0, 1.5)               # |z1| >= 1
    with pytest.raises(ValueError, match="did not converge"):
        sp.symiirorder1(x[:5], -r * 6, r, 1e-9)    # short + explicit prec


def test_symiirorder2_matches_scipy(rng):
    x = rng.standard_normal(400)
    for r in (0.3, 0.6, 0.9):
        for omega in (0.4, 1.1, 2.5):
            for prec in (-1.0, 1e-3, 1e-6, 1e-9):
                np.testing.assert_allclose(
                    sp.symiirorder2(x, r, omega, prec),
                    ss.symiirorder2(x, r, omega, precision=prec),
                    atol=1e-10, err_msg=f"r={r} omega={omega} prec={prec}")
    # short-signal behavior tracks scipy exactly: where scipy's boundary
    # series cannot converge, ours raises the same error
    xs = x[:80]
    for r, prec in ((0.9, -1.0), (0.9, 1e-9)):
        with pytest.raises(ValueError, match="did not converge"):
            ss.symiirorder2(xs, r, 0.4, precision=prec)
        with pytest.raises(ValueError, match="did not converge"):
            sp.symiirorder2(xs, r, 0.4, prec)
    # batched leading axis == row-by-row scipy
    X = rng.standard_normal((3, 60))
    got = sp.symiirorder2(X, 0.5, 1.3)
    for i in range(3):
        np.testing.assert_allclose(got[i], ss.symiirorder2(X[i], 0.5, 1.3),
                                    atol=1e-10)
    with pytest.raises(ValueError):
        sp.symiirorder2(x, 1.0, 0.5)               # r >= 1
    with pytest.raises(ValueError, match="did not converge"):
        sp.symiirorder2(x[:6], 0.9, 0.5)           # short + default prec
    with pytest.raises(ValueError):
        sp.symiirorder2(np.ones(8, complex), 0.5, 0.5)


def test_smoothing_splines_match_scipy(rng):
    x = rng.standard_normal(64)
    for lamb in (0.05, 1.0, 5.0, 100.0):
        np.testing.assert_allclose(sp.cspline1d(x, lamb),
                                   ss.cspline1d(x, lamb), atol=1e-10,
                                   err_msg=f"lamb={lamb}")
    X = rng.standard_normal((40, 48))
    for lamb in (0.05, 1.0, 8.0):
        np.testing.assert_allclose(sp.cspline2d(X, lamb),
                                   ss.cspline2d(X, lamb), atol=1e-10,
                                   err_msg=f"lamb={lamb}")
    # explicit precision in the smoothing branch
    np.testing.assert_allclose(sp.cspline2d(X, 2.0, 1e-4),
                               ss.cspline2d(X, 2.0, precision=1e-4),
                               atol=1e-10)
    # where scipy's boundary series cannot converge, same raise
    with pytest.raises(ValueError, match="did not converge"):
        sp.cspline2d(rng.standard_normal((24, 30)), 8.0)
    # f32 smoothing keeps dtype and scipy's 1e-3 default precision
    X32 = X.astype(np.float32)
    out32 = sp.cspline2d(X32, 3.0)
    assert out32.dtype == np.float32
    np.testing.assert_allclose(out32, ss.cspline2d(X32, 3.0), atol=1e-3)
    with pytest.raises(ValueError):
        sp.qspline2d(X, lamb=1.0)                  # scipy raises too


def test_spline_filter_matches_scipy(rng):
    X = rng.standard_normal((40, 48))
    for lmbda in (0.1, 5.0):
        np.testing.assert_allclose(sp.spline_filter(X, lmbda),
                                   ss.spline_filter(X, lmbda), atol=1e-10)
    X32 = X.astype(np.float32)
    got32 = sp.spline_filter(X32)
    assert got32.dtype == np.float32
    np.testing.assert_allclose(got32, ss.spline_filter(X32), atol=1e-3)
    # Complex input: scipy 1.16's compiled path rejects it (TypeError in
    # symiirorder2_ic_fwd — an upstream regression); the framework keeps
    # the capability via RI planes.  The filter is linear with real
    # coefficients, so plane-by-plane scipy is the exact oracle.
    Z = (rng.standard_normal((40, 44))
         + 1j * rng.standard_normal((40, 44))).astype(np.complex64)
    gotc = sp.spline_filter(Z, 2.0)
    assert gotc.dtype == np.complex64
    ref_r = ss.spline_filter(Z.real.astype(np.float32), 2.0)
    ref_i = ss.spline_filter(Z.imag.astype(np.float32), 2.0)
    np.testing.assert_allclose(gotc.real, ref_r, atol=1e-3)
    np.testing.assert_allclose(gotc.imag, ref_i, atol=1e-3)
    with pytest.raises(TypeError):
        sp.spline_filter(np.ones((4, 4), dtype=np.int32))


def test_splines_reject_complex_and_preserve_f32(rng):
    with pytest.raises(ValueError):
        sp.cspline1d(np.ones(8, complex))
    with pytest.raises(ValueError):
        sp.symiirorder1(np.ones(8, complex), 1.0, 0.5)
    X32 = rng.standard_normal((20, 24)).astype(np.float32)
    out = sp.cspline2d(X32)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ss.cspline2d(X32), atol=1e-5)
