"""Window library vs scipy.signal oracle.

The framework implements every window from its closed form
(simpledsp_jax/design/windows.py); scipy is the f64 validation oracle only.
"""

import numpy as np
import pytest
import scipy.signal as sig

from simpledsp_jax.design import windows as W

NO_ARG = ["boxcar", "triang", "bartlett", "barthann", "hann", "hamming",
          "blackman", "blackmanharris", "nuttall", "flattop", "bohman",
          "parzen", "cosine", "lanczos"]

WITH_ARG = [("kaiser", 8.6), ("gaussian", 7.0), ("general_gaussian", 1.5, 5.0),
            ("general_hamming", 0.7), ("chebwin", 100.0), ("tukey", 0.25),
            ("exponential", None, 3.0), ("taylor", 4, 30.0),
            ("general_cosine", [0.4, 0.5, 0.1]), ("dpss", 3.0)]


@pytest.mark.parametrize("name", NO_ARG)
@pytest.mark.parametrize("m", [8, 9, 64, 65])
@pytest.mark.parametrize("fftbins", [True, False])
def test_no_arg_windows_match_scipy(name, m, fftbins):
    ours = W.get_window(name, m, fftbins=fftbins)
    ref = sig.get_window(name, m, fftbins=fftbins)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-13)


@pytest.mark.parametrize("spec", WITH_ARG)
@pytest.mark.parametrize("m", [16, 17, 63])
@pytest.mark.parametrize("fftbins", [True, False])
def test_parametric_windows_match_scipy(spec, m, fftbins):
    ours = W.get_window(tuple(spec), m, fftbins=fftbins)
    ref = sig.get_window(tuple(spec), m, fftbins=fftbins)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-10)


def test_float_spec_is_kaiser_beta():
    np.testing.assert_allclose(W.get_window(8.6, 33),
                               sig.get_window(8.6, 33), atol=1e-13)


@pytest.mark.parametrize("m", [0, 1])
def test_degenerate_lengths(m):
    for name in NO_ARG:
        assert W.get_window(name, m).shape == (m,)
    assert W.get_window(("kaiser", 5.0), m).shape == (m,)


def test_unknown_and_missing_arg_raise():
    with pytest.raises(ValueError):
        W.get_window("nosuchwindow", 16)
    with pytest.raises(ValueError):
        W.get_window("kaiser", 16)  # needs beta
    with pytest.raises(ValueError):
        W.get_window(("hann", 1.0), 16)  # takes no parameters


def test_exponential_sym_with_center_raises():
    with pytest.raises(ValueError):
        W.exponential(16, center=4.0, tau=2.0, sym=True)


def test_kaiserord_matches_scipy():
    for ripple, width in [(65.0, 0.05), (30.0, 0.1), (100.0, 0.02)]:
        n_ours, beta_ours = W.kaiserord(ripple, width)
        n_ref, beta_ref = sig.kaiserord(ripple, width)
        assert n_ours == n_ref
        np.testing.assert_allclose(beta_ours, beta_ref, rtol=1e-12)


def test_dpss_concentration():
    # The Slepian window maximizes in-band energy: check its in-band
    # fraction beats a Kaiser window of the same length at NW=3.
    m, nw = 128, 3.0
    v = W.dpss(m, nw)
    k = W.kaiser(m, 2 * np.pi * nw / 2)
    grid = 8192
    f = np.fft.rfftfreq(grid)

    def inband(w):
        spec = np.abs(np.fft.rfft(w, grid)) ** 2
        band = f <= nw / m
        return spec[band].sum() / spec.sum()

    assert inband(v) > inband(k)
    assert inband(v) > 0.99999


def test_kaiser_atten_matches_scipy():
    from simpledsp_jax.design.windows import kaiser_atten
    for taps, width in [(101, 0.05), (64, 0.1), (13, 0.3)]:
        assert abs(kaiser_atten(taps, width)
                   - sig.kaiser_atten(taps, width)) < 1e-12
