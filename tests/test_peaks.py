"""Peak-detection family vs scipy.signal (ops/peaks.py)."""

import numpy as np
import pytest
import scipy.signal as ss

from simpledsp_jax.ops import peaks as pk


@pytest.fixture
def sig1(rng):
    n = 2000
    return np.cumsum(rng.standard_normal(n)) + 0.3 * np.sin(
        np.arange(n) * 0.1)


def test_plain_local_maxima(sig1):
    a, _ = pk.find_peaks(sig1)
    b, _ = ss.find_peaks(sig1)
    np.testing.assert_array_equal(a, b)
    assert a.size > 100


@pytest.mark.parametrize("kw", [
    dict(height=1.0),
    dict(height=(0.5, 20.0)),
    dict(threshold=0.2),
    dict(distance=15),
    dict(prominence=2.0),
    dict(width=3),
    dict(prominence=1.0, width=(2, 30), distance=8),
    dict(plateau_size=1),
])
def test_find_peaks_conditions_match_scipy(sig1, kw):
    a, pa = pk.find_peaks(sig1, **kw)
    b, pb = ss.find_peaks(sig1, **kw)
    np.testing.assert_array_equal(a, b)
    assert set(pa) == set(pb)
    for k in pb:
        np.testing.assert_allclose(pa[k], pb[k], err_msg=k)


def test_plateau_handling():
    x = np.array([0, 1, 1, 1, 0, 2, 2, 0, 3, 0, 1, 0], float)
    a, pa = pk.find_peaks(x, plateau_size=2)
    b, pb = ss.find_peaks(x, plateau_size=2)
    np.testing.assert_array_equal(a, b)
    for k in pb:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


@pytest.mark.parametrize("wlen", [None, 5, 40, 41, 100])
def test_peak_prominences_match_scipy(sig1, wlen):
    p, _ = ss.find_peaks(sig1, distance=10)
    a = pk.peak_prominences(sig1, p, wlen=wlen)
    b = ss.peak_prominences(sig1, p, wlen=wlen)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u, v)


@pytest.mark.parametrize("rel", [0.5, 0.7, 1.0])
def test_peak_widths_match_scipy(sig1, rel):
    p, _ = ss.find_peaks(sig1, distance=10)
    a = pk.peak_widths(sig1, p, rel)
    b = ss.peak_widths(sig1, p, rel)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u, v)


def test_argrel_family(rng):
    y = rng.standard_normal((3, 100))
    for order in (1, 3):
        for ours, theirs in [(pk.argrelmax, ss.argrelmax),
                             (pk.argrelmin, ss.argrelmin)]:
            a = ours(y, order=order)
            b = theirs(y, order=order, axis=-1)
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)


def test_errors(sig1):
    with pytest.raises(ValueError):
        pk.find_peaks(sig1, distance=0.5)
    with pytest.raises(ValueError):
        pk.find_peaks(np.zeros((2, 3)))
    with pytest.raises(ValueError):
        pk.peak_prominences(sig1, [99999])
    with pytest.raises(ValueError):
        pk.peak_prominences(sig1, [5], wlen=1)
    with pytest.raises(ValueError):
        pk.peak_widths(sig1, [100], rel_height=-1.0)
    with pytest.raises(ValueError):
        pk.argrelmax(sig1, order=0)


def test_find_peaks_x_length_condition_arrays(sig1):
    """Array conditions are SIGNAL-length, sampled at peak positions
    (scipy semantics — review-fixed regression pin)."""
    arr = np.full(sig1.size, 1.0)
    arr[: sig1.size // 2] = 50.0           # suppress the first half
    a, _ = pk.find_peaks(sig1, height=arr)
    b, _ = ss.find_peaks(sig1, height=arr)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pk.find_peaks(sig1, height=np.ones(7))


def test_peak_widths_plateau_rel0_no_nan():
    x = np.array([0., 1, 2, 2, 2, 1, 0])
    w, wh, li, ri = pk.peak_widths(x, [3], rel_height=0.0)
    ref = ss.peak_widths(x, [3], rel_height=0.0)
    for u, v in zip((w, wh, li, ri), ref):
        np.testing.assert_allclose(u, v)
    assert np.all(np.isfinite(w))


def test_find_peaks_cwt_matches_scipy():
    """Wavelet-ridge peak finding (round 5): index-exact vs scipy across
    widths/filters, noise-only input, and a custom wavelet."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 10, 800)
    x = (np.exp(-((t - 2.0) / 0.15) ** 2)
         + 0.8 * np.exp(-((t - 5.0) / 0.4) ** 2)
         + 0.6 * np.exp(-((t - 8.0) / 0.1) ** 2)
         + 0.05 * rng.standard_normal(t.size))
    for widths in (np.arange(1, 20), np.arange(2, 35, 3), [5, 10, 15]):
        for kw in (dict(), dict(min_snr=2.0), dict(noise_perc=25),
                   dict(gap_thresh=3), dict(min_length=3),
                   dict(window_size=41)):
            got = pk.find_peaks_cwt(x, widths, **kw)
            ref = ss.find_peaks_cwt(x, widths, **kw)
            assert np.array_equal(got, ref), (widths, kw)
    y = rng.standard_normal(300)
    assert np.array_equal(pk.find_peaks_cwt(y, np.arange(1, 10)),
                          ss.find_peaks_cwt(y, np.arange(1, 10)))

    def gauss_wavelet(points, a):
        v = np.arange(points) - (points - 1.0) / 2
        return np.exp(-v ** 2 / (2 * a * a))

    assert np.array_equal(
        pk.find_peaks_cwt(x, np.arange(1, 12), wavelet=gauss_wavelet),
        ss.find_peaks_cwt(x, np.arange(1, 12), wavelet=gauss_wavelet))


def test_find_peaks_cwt_complex_wavelet():
    """Complex wavelets promote the CWT matrix to complex128 (round-5
    review fix): lexicographic maxima + fraction-percentile noise floor,
    index-exact vs scipy."""
    rng = np.random.default_rng(1)
    t = np.linspace(0, 10, 500)
    x = (np.exp(-((t - 3) / 0.2) ** 2)
         + 0.7 * np.exp(-((t - 7) / 0.3) ** 2)
         + 0.05 * rng.standard_normal(500))

    def morlet_like(points, a):
        v = (np.arange(points) - (points - 1.0) / 2) / a
        return np.exp(1j * 5 * v) * np.exp(-v * v / 2)

    got = pk.find_peaks_cwt(x, np.arange(1, 10), wavelet=morlet_like)
    ref = ss.find_peaks_cwt(x, np.arange(1, 10), wavelet=morlet_like)
    assert np.array_equal(got, ref)
