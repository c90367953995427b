"""Extended-transform tests: arbitrary-N FFT (Bluestein), chirp-z / zoom
FFT, DCT-II/III, Hilbert / analytic signal, Goertzel, convolve / correlate.

These widen the reference's power-of-2/4-only FFT family (reference:
include/sdsp/fft.h:261, 304 static_asserts); correctness is gated against
numpy / scipy.fft / scipy.signal the same way the golden-fixture tests gate
the IIR designs (SURVEY.md §4 category 3).
"""

import numpy as np
import pytest
import scipy.fft as sfft
import scipy.signal as ss

import jax.numpy as jnp

from simpledsp_jax.ops.conv import convolve, correlate
from simpledsp_jax.ops.fft import fft, ifft
from simpledsp_jax.ops.transforms import (
    analytic_ri, czt, dct, goertzel, goertzel_ri, hilbert, idct, zoom_fft)

EPS = np.finfo(np.float64).eps


def tol(n):
    return 4.0 * n * EPS


# ---------------------------------------------------------------------------
# Arbitrary-N FFT via the Bluestein fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [17, 127, 131, 251, 262, 999, 1000, 4099])
def test_fft_arbitrary_n(rng, n):
    """Sizes with prime factors > 128 route through the chirp-z transform
    and still match numpy to the reference's 4*N*eps bound."""
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    xc = jnp.asarray(x, dtype=jnp.complex128)
    assert np.max(np.abs(np.asarray(fft(xc)) - np.fft.fft(x))) < tol(n)
    assert np.max(np.abs(np.asarray(ifft(xc)) - np.fft.ifft(x))) < tol(n)


def test_fft_arbitrary_n_round_trip(rng):
    n = 331  # prime
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    xc = jnp.asarray(x, dtype=jnp.complex128)
    back = np.asarray(ifft(fft(xc)))
    assert np.max(np.abs(back - x)) < tol(n)


# ---------------------------------------------------------------------------
# Chirp-z / zoom FFT
# ---------------------------------------------------------------------------

def test_czt_matches_scipy(rng):
    """Generic logarithmic-spiral CZT vs scipy.signal.czt."""
    n, m = 100, 61
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    w = np.exp(-2j * np.pi / 77) * 1.001
    a = 1.02 * np.exp(0.4j)
    got = np.asarray(czt(jnp.asarray(x), m, w=w, a=a))
    ref = ss.czt(x, m, w, a)
    assert np.max(np.abs(got - ref)) < 1e-9 * np.max(np.abs(ref))


def test_czt_default_is_dft(rng):
    """czt with defaults (m = n, w on the unit circle) equals the DFT."""
    n = 50
    x = rng.standard_normal(n)
    got = np.asarray(czt(jnp.asarray(x)))
    assert np.max(np.abs(got - np.fft.fft(x))) < tol(n)


@pytest.mark.parametrize("fn", [[0.1, 0.4], 0.75])
@pytest.mark.parametrize("endpoint", [False, True])
def test_zoom_fft_matches_scipy(rng, fn, endpoint):
    x = rng.standard_normal(256)
    m = 99
    got = np.asarray(zoom_fft(jnp.asarray(x), fn, m, fs=2.0,
                              endpoint=endpoint))
    ref = ss.zoom_fft(x, fn, m, fs=2.0, endpoint=endpoint)
    assert np.max(np.abs(got - ref)) < 1e-10 * np.max(np.abs(ref))


def test_zoom_fft_batched(rng):
    x = rng.standard_normal((4, 128))
    got = np.asarray(zoom_fft(jnp.asarray(x), [0.2, 0.3], 33))
    for i in range(4):
        ref = ss.zoom_fft(x[i], [0.2, 0.3], 33)
        assert np.max(np.abs(got[i] - ref)) < 1e-10 * np.max(np.abs(ref))


# ---------------------------------------------------------------------------
# DCT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [7, 8, 15, 64, 128])
@pytest.mark.parametrize("dct_type", [2, 3])
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_dct_matches_scipy(rng, n, dct_type, norm):
    x = rng.standard_normal((3, n))
    got = np.asarray(dct(jnp.asarray(x), type=dct_type, norm=norm))
    ref = sfft.dct(x, type=dct_type, norm=norm)
    assert np.max(np.abs(got - ref)) < tol(n) * max(1.0, np.abs(ref).max())
    got_i = np.asarray(idct(jnp.asarray(x), type=dct_type, norm=norm))
    ref_i = sfft.idct(x, type=dct_type, norm=norm)
    assert np.max(np.abs(got_i - ref_i)) < tol(n) * max(1.0,
                                                        np.abs(ref_i).max())


def test_dct_ortho_round_trip(rng):
    x = rng.standard_normal(63)
    back = np.asarray(idct(dct(jnp.asarray(x), norm="ortho"), norm="ortho"))
    assert np.max(np.abs(back - x)) < tol(63)


def test_dct_rejects_bad_args(rng):
    x = jnp.asarray(rng.standard_normal(8))
    with pytest.raises(ValueError):
        dct(x, type=1)
    with pytest.raises(ValueError):
        dct(x, norm="backward")
    with pytest.raises(ValueError):
        dct(jnp.asarray(np.ones(4, dtype=np.complex128)))


# ---------------------------------------------------------------------------
# Hilbert / analytic signal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [256, 257])
def test_hilbert_matches_scipy(rng, n):
    x = rng.standard_normal((2, n))
    got = np.asarray(hilbert(jnp.asarray(x)))
    ref = ss.hilbert(x)
    assert np.max(np.abs(got - ref)) < tol(n)


def test_analytic_envelope_of_tone(rng):
    """|analytic(cos)| == 1: the textbook envelope property."""
    t = np.arange(1024)
    x = np.cos(2 * np.pi * 37 * t / 1024)
    yr, yi = analytic_ri(jnp.asarray(x))
    env = np.hypot(np.asarray(yr), np.asarray(yi))
    assert np.max(np.abs(env - 1.0)) < 1e-10


# ---------------------------------------------------------------------------
# Goertzel
# ---------------------------------------------------------------------------

def test_goertzel_matches_fft_bins(rng):
    x = rng.standard_normal((2, 500))
    bins = (0, 7, 100, 499)
    got = np.asarray(goertzel(jnp.asarray(x), bins))
    ref = np.fft.fft(x, axis=-1)[:, list(bins)]
    assert np.max(np.abs(got - ref)) < tol(500)


def test_goertzel_ri_planes(rng):
    x = rng.standard_normal(64)
    yr, yi = goertzel_ri(jnp.asarray(x), (3,))
    ref = np.fft.fft(x)[3]
    assert abs(complex(float(yr[0]), float(yi[0])) - ref) < tol(64)


# ---------------------------------------------------------------------------
# convolve / correlate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("method", ["direct", "fft"])
def test_convolve_real(rng, mode, method):
    x = rng.standard_normal(200)
    h = rng.standard_normal(17)
    got = np.asarray(convolve(jnp.asarray(x), h, mode, method=method))
    ref = np.convolve(x, h, mode)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < 1e-10


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_convolve_complex_batched(rng, mode):
    x = rng.standard_normal((3, 100)) + 1j * rng.standard_normal((3, 100))
    h = rng.standard_normal(9) + 1j * rng.standard_normal(9)
    got = np.asarray(convolve(jnp.asarray(x), h, mode))
    for i in range(3):
        ref = np.convolve(x[i], h, mode)
        assert np.max(np.abs(got[i] - ref)) < 1e-10


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_correlate_matches_scipy(rng, mode):
    x = rng.standard_normal(120) + 1j * rng.standard_normal(120)
    h = rng.standard_normal(15) + 1j * rng.standard_normal(15)
    got = np.asarray(correlate(jnp.asarray(x), h, mode))
    ref = ss.correlate(x, h, mode)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < 1e-10


def test_convolve_auto_long_kernel_uses_fft(rng):
    """auto == fft for long kernels; parity with scipy.fftconvolve."""
    x = rng.standard_normal(4096)
    h = rng.standard_normal(301)
    got = np.asarray(convolve(jnp.asarray(x), h))
    ref = ss.fftconvolve(x, h)
    assert np.max(np.abs(got - ref)) < 1e-8


def test_convolve_rejects_bad_args(rng):
    x = jnp.asarray(rng.standard_normal(16))
    with pytest.raises(ValueError):
        convolve(x, np.ones((2, 2)))
    with pytest.raises(ValueError):
        convolve(x, np.ones(4), mode="cyclic")
    with pytest.raises(ValueError):
        convolve(x, np.ones(4), method="magic")


# ---------------------------------------------------------------------------
# STFT / ISTFT
# ---------------------------------------------------------------------------

from simpledsp_jax.ops.spectral import istft_ri, stft_ri  # noqa: E402


def test_stft_istft_round_trip_hann(rng):
    """Weighted-OLA inverse recovers every sample where the window is
    nonzero (periodic hann zeroes only t = 0)."""
    x = rng.standard_normal((2, 2048))
    sr, si = stft_ri(jnp.asarray(x), nfft=256, hop=128)
    y = np.asarray(istft_ri(sr, si, nfft=256, hop=128))
    assert y.shape == x.shape
    assert np.max(np.abs(y[:, 1:] - x[:, 1:])) < 1e-6
    assert np.max(np.abs(y[:, 128:-128] - x[:, 128:-128])) < 1e-10


def test_stft_istft_rect_no_overlap(rng):
    x = rng.standard_normal(1024)
    sr, si = stft_ri(jnp.asarray(x), nfft=128, hop=128, window="rect")
    y = np.asarray(istft_ri(sr, si, nfft=128, hop=128, window="rect"))
    assert np.max(np.abs(y - x)) < 1e-12


def test_stft_istft_quarter_hop_twosided(rng):
    x = rng.standard_normal(1000)
    sr, si = stft_ri(jnp.asarray(x), nfft=64, hop=16, onesided=False)
    y = np.asarray(istft_ri(sr, si, nfft=64, hop=16, onesided=False))
    n_out = y.shape[-1]
    assert np.max(np.abs(y[1:n_out] - x[1:n_out])) < 1e-8


def test_stft_matches_scipy(rng):
    """Ours == scipy.signal.stft(boundary=None, padded=False) * sum(w)."""
    x = rng.standard_normal(2048)
    sr, si = stft_ri(jnp.asarray(x), nfft=256, hop=128)
    w = np.hanning(257)[:-1]  # periodic hann
    _, _, zxx = ss.stft(x, nperseg=256, noverlap=128, boundary=None,
                        padded=False)
    ref = (zxx * np.sum(w)).T  # scipy is (bins, frames)
    got = np.asarray(sr) + 1j * np.asarray(si)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < 1e-9 * np.max(np.abs(ref))


def test_istft_direct_matches_fft_route(rng):
    """The direct synthesis-matmul route (inverse DFT + Hermitian weights
    + window folded into one table pair) equals the engine route for
    every config class: overlapped/non-overlapped, one/two-sided, odd
    nfft."""
    for nfft, hop, win, onesided in [(256, 128, "hann", True),
                                     (256, 64, "hamming", True),
                                     (128, 128, "rect", True),
                                     (64, 16, "hann", False),
                                     (250, 125, "hann", True)]:
        x = rng.standard_normal((2, 8 * nfft))
        sr, si = stft_ri(jnp.asarray(x), nfft=nfft, hop=hop, window=win,
                         onesided=onesided)
        y_fft = np.asarray(istft_ri(sr, si, nfft=nfft, hop=hop, window=win,
                                    onesided=onesided, method="fft"))
        y_dir = np.asarray(istft_ri(sr, si, nfft=nfft, hop=hop, window=win,
                                    onesided=onesided, method="direct"))
        assert np.max(np.abs(y_fft - y_dir)) < 1e-11, (nfft, hop, win)


def test_istft_rejects_bad_hop(rng):
    sr = jnp.zeros((4, 33))
    with pytest.raises(ValueError):
        istft_ri(sr, sr, nfft=64, hop=48)


def test_convolve_long_signal_ols_route(rng):
    """Long real x routes through overlap-save; parity with fftconvolve
    at full/same/valid and with a batched input."""
    x = rng.standard_normal((2, 40_000))
    h = rng.standard_normal(301)
    for mode in ("full", "same", "valid"):
        got = np.asarray(convolve(jnp.asarray(x), h, mode))
        ref = np.stack([ss.fftconvolve(x[i], h, mode) for i in range(2)])
        assert got.shape == ref.shape
        assert np.max(np.abs(got - ref)) < 1e-8


# ---------------------------------------------------------------------------
# deconvolve / correlation_lags / lombscargle (round-4 breadth)
# ---------------------------------------------------------------------------

from simpledsp_jax.ops.conv import correlation_lags, deconvolve  # noqa: E402
from simpledsp_jax.ops.spectral import lombscargle  # noqa: E402


def test_deconvolve_matches_scipy(rng):
    sig_ = rng.standard_normal(100)
    div = np.array([1.5, 0.7, -0.3])
    q, r = deconvolve(jnp.asarray(sig_), div)
    qs, rs = ss.deconvolve(sig_, div)
    np.testing.assert_allclose(np.asarray(q), qs, atol=1e-12)
    np.testing.assert_allclose(np.asarray(r), rs, atol=1e-12)
    # identity: signal == convolve(divisor, q) + r, batched
    sb = rng.standard_normal((3, 60))
    qb, rb = deconvolve(jnp.asarray(sb), div)
    recon = np.stack([np.convolve(div, np.asarray(qb[i]))[:60]
                      + np.asarray(rb[i]) for i in range(3)])
    np.testing.assert_allclose(recon, sb, atol=1e-12)
    with pytest.raises(ValueError):
        deconvolve(jnp.asarray(sig_), np.array([0.0, 1.0]))


def test_correlation_lags_matches_scipy():
    for mode in ("full", "same", "valid"):
        for a, b in [(10, 7), (7, 10), (8, 8), (5, 1)]:
            np.testing.assert_array_equal(correlation_lags(a, b, mode),
                                          ss.correlation_lags(a, b, mode))
    with pytest.raises(ValueError):
        correlation_lags(4, 4, "sideways")


def test_lombscargle_matches_scipy(rng):
    x = np.sort(rng.uniform(0, 10, 400))
    y = np.sin(2.3 * x) + 0.5 * rng.standard_normal(400)
    freqs = np.linspace(0.1, 10, 200)
    for pc in (False, True):
        for nm in (False, True):
            ours = np.asarray(lombscargle(jnp.asarray(x), jnp.asarray(y),
                                          freqs, precenter=pc, normalize=nm))
            ref = ss.lombscargle(x, y, freqs, precenter=pc, normalize=nm)
            np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=1e-12)
    # batched y over shared time base
    yb = np.stack([y, 2.0 * y])
    ob = np.asarray(lombscargle(jnp.asarray(x), jnp.asarray(yb), freqs))
    np.testing.assert_allclose(ob[1], ss.lombscargle(x, 2.0 * y, freqs),
                               rtol=1e-10)
    with pytest.raises(ValueError):
        lombscargle(jnp.zeros((2, 4)), jnp.zeros(4), freqs)


def test_hilbert2_matches_scipy(rng):
    """2-D single-orthant analytic signal (even/odd sizes + batch; the
    even-N Nyquist bin is ZEROED per scipy's convention)."""
    from simpledsp_jax.ops.transforms import hilbert2
    for shape in [(32, 48), (33, 47), (8, 8)]:
        x = rng.standard_normal(shape)
        got = np.asarray(hilbert2(jnp.asarray(x)))
        ref = ss.hilbert2(x)
        assert np.max(np.abs(got - ref)) < 1e-12
    xb = rng.standard_normal((3, 16, 24))
    got = np.asarray(hilbert2(jnp.asarray(xb)))
    for i in range(3):
        assert np.max(np.abs(got[i] - ss.hilbert2(xb[i]))) < 1e-12
    with pytest.raises(ValueError):
        hilbert2(jnp.zeros(8))
    with pytest.raises(ValueError):
        hilbert2(jnp.zeros((4, 4), jnp.complex128))


def test_czt_points_matches_scipy():
    from simpledsp_jax.ops.transforms import czt_points
    w = 0.9 * np.exp(-1j * 0.3)
    np.testing.assert_allclose(czt_points(7, w, 1.1),
                               ss.czt_points(7, w, 1.1), atol=1e-14)
    np.testing.assert_allclose(czt_points(7), ss.czt_points(7), atol=1e-14)
    with pytest.raises(ValueError):
        czt_points(0)


def test_check_cola_nola_match_scipy():
    from simpledsp_jax.ops.spectral import check_COLA, check_NOLA
    cases = [("hann", 256, 128), ("hann", 256, 192), ("hann", 256, 100),
             ("boxcar", 100, 0), ("hamming", 256, 128),
             (("kaiser", 8.0), 128, 64)]
    for win, nseg, nov in cases:
        assert check_COLA(win, nseg, nov) == bool(
            ss.check_COLA(win, nseg, nov)), (win, nseg, nov)
        assert check_NOLA(win, nseg, nov) == bool(
            ss.check_NOLA(win, nseg, nov)), (win, nseg, nov)
    with pytest.raises(ValueError):
        check_COLA("hann", 128, 128)


def test_vectorstrength_matches_scipy(rng):
    from simpledsp_jax.ops.spectral import vectorstrength
    ev = rng.uniform(0, 100, 200)
    s1, p1 = vectorstrength(ev, 7.0)
    s2, p2 = ss.vectorstrength(ev, 7.0)
    assert abs(s1 - s2) < 1e-12 and abs(p1 - p2) < 1e-12
    sa, pa = vectorstrength(ev, [5.0, 7.0])
    sb, pb = ss.vectorstrength(ev, [5.0, 7.0])
    np.testing.assert_allclose(sa, sb, atol=1e-12)
    np.testing.assert_allclose(pa, pb, atol=1e-12)
    # perfectly periodic events -> strength 1
    s1, _ = vectorstrength(np.arange(20) * 3.0, 3.0)
    assert abs(s1 - 1.0) < 1e-12
    with pytest.raises(ValueError):
        vectorstrength(ev, -1.0)


def test_envelope_matches_scipy(rng):
    from simpledsp_jax.ops.spectral import envelope
    z = rng.standard_normal(64)
    for bp in ((1, None), (4, 20), (-10, 12), (None, 16)):
        for kw in (dict(), dict(residual="all"), dict(residual=None),
                   dict(squared=True), dict(n_out=32), dict(n_out=128)):
            got = np.asarray(envelope(jnp.asarray(z), bp, **kw))
            ref = np.asarray(ss.envelope(z, bp, **kw))
            np.testing.assert_allclose(got, ref, atol=1e-12,
                                       err_msg=f"{bp} {kw}")
    # batched leading axis
    zb = rng.standard_normal((3, 64))
    got = np.asarray(envelope(jnp.asarray(zb), (4, 20)))
    for i in range(3):
        np.testing.assert_allclose(got[:, i], ss.envelope(zb[i], (4, 20)),
                                   atol=1e-12)
    # negative-only band, positive axis, odd-n lower bound (review pins)
    for kw in (dict(), dict(residual="all"), dict(residual=None)):
        got = np.asarray(envelope(jnp.asarray(z), (-10, -5), **kw))
        np.testing.assert_allclose(got, np.asarray(
            ss.envelope(z, (-10, -5), **kw)), atol=1e-12)
    z2 = rng.standard_normal((64, 5))
    got = np.asarray(envelope(jnp.asarray(z2), (4, 20), axis=0))
    ref = np.asarray(ss.envelope(z2, (4, 20), axis=0))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-12)
    z63 = rng.standard_normal(63)
    np.testing.assert_allclose(
        np.asarray(envelope(jnp.asarray(z63), (-32, 5))),
        np.asarray(ss.envelope(z63, (-32, 5))), atol=1e-12)
    with pytest.raises(ValueError):
        envelope(jnp.zeros(8), (5, 3))
    with pytest.raises(ValueError):
        envelope(jnp.zeros(8), (1, None), residual="sideways")


def test_stft_dual_windows_match_scipy(rng):
    """Canonical + closest STFT dual windows (round 5): parity with
    scipy.signal.closest_STFT_dual_window / ShortTimeFFT.dual_win,
    real and complex windows, scaled and unscaled."""
    from scipy.signal import ShortTimeFFT
    from scipy.signal.windows import gaussian, hann
    from simpledsp_jax.ops.spectral import (closest_STFT_dual_window,
                                            stft_dual_window)
    for win, hop in [(hann(64), 16), (gaussian(50, 10), 13),
                     (rng.standard_normal(32) + 1.5, 8),
                     (hann(48) + 1j * 0.2 * gaussian(48, 9), 12)]:
        win = np.asarray(win)
        for desired in (None, np.roll(np.abs(win), 3) + 0.1):
            for scaled in (True, False):
                d1, a1 = closest_STFT_dual_window(win, hop, desired,
                                                  scaled=scaled)
                d2, a2 = ss.closest_STFT_dual_window(win, hop, desired,
                                                     scaled=scaled)
                np.testing.assert_allclose(d1, d2, atol=1e-12)
                np.testing.assert_allclose(a1, a2, atol=1e-12)
        mode = "onesided" if np.isrealobj(win) else "twosided"
        st = ShortTimeFFT(win, hop, fs=1.0, fft_mode=mode)
        np.testing.assert_allclose(stft_dual_window(win, hop),
                                   st.dual_win, atol=1e-12)
    with pytest.raises(ValueError):
        stft_dual_window(np.ones(8), 9)          # hop > len(win)
    with pytest.raises(ValueError):
        stft_dual_window(np.ones(8), 4.0)        # non-int hop (scipy too)
    with pytest.raises(ValueError):
        closest_STFT_dual_window(np.hanning(32), 8.5)
    with pytest.raises(ValueError):
        closest_STFT_dual_window(np.ones(8, int), 2)
    with pytest.raises(ValueError):
        stft_dual_window(np.ones(8) * np.r_[1, 0, 0, 0, 0, 0, 0, 0], 4)


def test_envelope_complex_matches_scipy(rng):
    """Complex input (scipy's full-spectrum branch, round 5): no
    analytic doubling; residual via the frequency-domain-resample
    Nyquist split/join corrections."""
    from simpledsp_jax.ops.spectral import envelope, envelope_ri
    z = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    for bp in ((1, None), (4, 20), (-10, 12), (None, 16), (-20, -5)):
        for res in ("all", "lowpass", None):
            for n_out in (None, 32, 48, 128, 63):
                got = np.asarray(envelope(jnp.asarray(z), bp,
                                          residual=res, n_out=n_out))
                ref = np.asarray(ss.envelope(z, bp, residual=res,
                                             n_out=n_out))
                np.testing.assert_allclose(
                    got, ref, atol=1e-12, err_msg=f"{bp} {res} {n_out}")
    got = np.asarray(envelope(jnp.asarray(z), (2, 20), squared=True,
                              residual=None))
    np.testing.assert_allclose(
        got, np.asarray(ss.envelope(z, (2, 20), squared=True,
                                    residual=None)), atol=1e-12)
    # batched leading axis and axis=0
    zb = rng.standard_normal((3, 40)) + 1j * rng.standard_normal((3, 40))
    got = np.asarray(envelope(jnp.asarray(zb), (1, None), n_out=20))
    for i in range(3):
        np.testing.assert_allclose(
            got[:, i], np.asarray(ss.envelope(zb[i], (1, None), n_out=20)),
            atol=1e-12)
    z2 = rng.standard_normal((40, 5)) + 1j * rng.standard_normal((40, 5))
    np.testing.assert_allclose(
        np.asarray(envelope(jnp.asarray(z2), (1, None), axis=0)),
        np.asarray(ss.envelope(z2, (1, None), axis=0)), atol=1e-12)
    # RI-plane wrapper (the framework's carrier): env real, residual as planes
    env, (rr, ri_) = envelope_ri(jnp.asarray(z.real), jnp.asarray(z.imag),
                                 (4, 20), n_out=32)
    ref = np.asarray(ss.envelope(z, (4, 20), n_out=32))
    np.testing.assert_allclose(np.asarray(env), ref[0].real, atol=1e-12)
    np.testing.assert_allclose(np.asarray(rr) + 1j * np.asarray(ri_),
                               ref[1], atol=1e-12)
    env2 = envelope_ri(jnp.asarray(z.real), jnp.asarray(z.imag),
                       (4, 20), residual=None)
    np.testing.assert_allclose(
        np.asarray(env2), np.asarray(ss.envelope(z, (4, 20),
                                                 residual=None)),
        atol=1e-12)


def test_envelope_residual_with_resampling(rng):
    """residual= combined with n_out= (advisor round-4 finding): the bin
    landing at the new Nyquist when cropping is genuinely complex; scipy's
    irfft keeps only its real part — outputs must still match scipy."""
    from simpledsp_jax.ops.spectral import envelope
    z = rng.standard_normal(64)
    for bp in ((1, None), (4, 20), (None, 16), (-10, 12)):
        for res in ("all", "lowpass"):
            for n_out in (32, 48, 128):   # even crops + an expansion
                got = np.asarray(envelope(jnp.asarray(z), bp,
                                          residual=res, n_out=n_out))
                ref = np.asarray(ss.envelope(z, bp, residual=res,
                                             n_out=n_out))
                np.testing.assert_allclose(
                    got, ref, atol=1e-12, err_msg=f"{bp} {res} {n_out}")


def test_czt_zoomfft_plan_classes(rng):
    """Callable CZT/ZoomFFT plans (round 5) vs scipy's classes."""
    from simpledsp_jax.ops.transforms import CZT, ZoomFFT
    x = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    for kw in (dict(), dict(m=33),
               dict(m=20, w=np.exp(-2j * np.pi / 21) * 1.001,
                    a=1.02 * np.exp(0.3j))):
        mine, ref = CZT(64, **kw), ss.CZT(64, **kw)
        np.testing.assert_allclose(np.asarray(mine(x)), ref(x), atol=1e-9)
        np.testing.assert_allclose(mine.points(), ref.points(), atol=1e-12)
    xb = rng.standard_normal((3, 64))
    np.testing.assert_allclose(np.asarray(CZT(64, 20)(xb)),
                               ss.CZT(64, 20)(xb), atol=1e-9)
    xt = xb.T.copy()
    np.testing.assert_allclose(np.asarray(CZT(64, 20)(xt, axis=0)),
                               ss.CZT(64, 20)(xt, axis=0), atol=1e-9)
    for kw in (dict(), dict(m=17), dict(fs=10.0), dict(endpoint=True)):
        zf, rz = ZoomFFT(64, [0.1, 0.4], **kw), ss.ZoomFFT(64, [0.1, 0.4],
                                                           **kw)
        np.testing.assert_allclose(np.asarray(zf(x.real)), rz(x.real),
                                   atol=1e-10)
    np.testing.assert_allclose(np.asarray(ZoomFFT(64, 0.75)(x.real)),
                               ss.ZoomFFT(64, 0.75)(x.real), atol=1e-10)
    with pytest.raises(ValueError):
        CZT(64)(x[:32])
    with pytest.raises(ValueError):
        ZoomFFT(64, [0.1, 0.2, 0.3])


def test_choose_conv_method_surface():
    """scipy API shape; the answer is the framework's own ON-DEVICE
    crossover (min length > 96 -> the matmul-FFT engine), documented as
    such — not scipy's CPU heuristic."""
    from simpledsp_jax.ops.conv import choose_conv_method
    assert choose_conv_method(np.ones(50), np.ones(20)) == "direct"
    assert choose_conv_method(np.ones(4000), np.ones(300)) == "fft"
    method, times = choose_conv_method(np.ones(512), np.ones(128),
                                       measure=True)
    assert method in ("direct", "fft")
    assert set(times) == {"direct", "fft"} and all(
        t > 0 for t in times.values())
