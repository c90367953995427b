"""FFT op tests — ports the reference's FFT test methodology
(test/testFFT.cpp, SURVEY.md §4 categories 1-2):

- analytic spectra (cosine at bin n -> N/2 at bins n and N-n)
- forward/inverse round trip
- time-shift <-> phase property
- linearity
plus batched parity vs numpy's independent FFT and a float32 SNR gate.
Tolerance for f64: 4*N*eps (testFFT.cpp:37).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from simpledsp_jax.ops.fft import fft, fft_radix2, fft_radix4, ifft

EPS = np.finfo(np.float64).eps


def tol(n):
    return 4.0 * n * EPS


def run_fft(x, inverse=False):
    xj = jnp.asarray(x, dtype=jnp.complex128)
    y = ifft(xj) if inverse else fft(xj)
    return np.asarray(y)


@pytest.mark.parametrize("n", [1024, 4096])
def test_cosine_spectrum(n):
    """cos(2 pi 7 t / N) -> exactly N/2 at bins 7 and N-7 (testFFT.cpp:17-38)."""
    bin_ = 7
    t = np.arange(n)
    x = np.cos(2 * np.pi * bin_ * t / n).astype(np.complex128)
    X = run_fft(x)
    expected = np.zeros(n, dtype=np.complex128)
    expected[bin_] = n / 2
    expected[n - bin_] = n / 2
    assert np.max(np.abs(X - expected)) < tol(n)


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_round_trip(n):
    """ifft(fft(x)) == x (testFFT.cpp:40-47; reverse policy fft.h:121-132)."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    y = run_fft(run_fft(x), inverse=True)
    assert np.max(np.abs(y - x)) < tol(n)


@pytest.mark.parametrize("n", [1024, 4096])
def test_time_shift_phase(n):
    """90-degree-shifted cosine (i.e. sine) -> purely imaginary -+ iN/2 bins
    (testFFT.cpp:49-67)."""
    bin_ = 7
    t = np.arange(n)
    x = np.sin(2 * np.pi * bin_ * t / n).astype(np.complex128)
    X = run_fft(x)
    expected = np.zeros(n, dtype=np.complex128)
    expected[bin_] = -1j * n / 2
    expected[n - bin_] = 1j * n / 2
    assert np.max(np.abs(X - expected)) < tol(n)


@pytest.mark.parametrize("n", [1024, 4096])
def test_linearity(n):
    """FFT(a1 x1 + a2 x2) == a1 FFT(x1) + a2 FFT(x2) (testFFT.cpp:70-125)."""
    rng = np.random.default_rng(11)
    t = np.arange(n)
    x1 = np.cos(2 * np.pi * 5 * t / n) + 0j
    x2 = np.cos(2 * np.pi * 11 * t / n) + 0j
    a1, a2 = 2.5, -1.25
    lhs = run_fft(a1 * x1 + a2 * x2)
    rhs = a1 * run_fft(x1) + a2 * run_fft(x2)
    assert np.max(np.abs(lhs - rhs)) < tol(n)


@pytest.mark.parametrize("n", [64, 384, 1000, 1024, 4096, 8192])
def test_matches_numpy_fft(n):
    """Batched parity vs numpy (pocketfft) — independent implementation."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
    ours = run_fft(x)
    ref = np.fft.fft(x, axis=-1)
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(ours - ref)) < tol(n) * max(scale, 1.0)


def test_ifft_matches_numpy():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 4096)) + 1j * rng.standard_normal((2, 4096))
    ours = run_fft(x, inverse=True)
    ref = np.fft.ifft(x, axis=-1)
    assert np.max(np.abs(ours - ref)) < tol(4096)


def test_radix_wrappers():
    """fft_radix2 / fft_radix4 parity aliases enforce the reference's size
    constraints (fft.h:261, 304) and agree with fft()."""
    rng = np.random.default_rng(14)
    x1024 = jnp.asarray(rng.standard_normal(1024) + 0j, dtype=jnp.complex128)
    assert np.allclose(np.asarray(fft_radix2(x1024)), np.asarray(fft(x1024)))
    x4096 = jnp.asarray(rng.standard_normal(4096) + 0j, dtype=jnp.complex128)
    assert np.allclose(np.asarray(fft_radix4(x4096)), np.asarray(fft(x4096)))
    with pytest.raises(ValueError):
        fft_radix4(x1024[:512])  # 512 is not a power of 4
    with pytest.raises(ValueError):
        fft_radix2(x1024[:1000])


@pytest.mark.parametrize("n", [1024, 4096])
def test_f32_snr(n):
    """float32 path (the device compute dtype): SNR vs f64 numpy > 120 dB."""
    rng = np.random.default_rng(15)
    x = rng.standard_normal((8, n)) + 1j * rng.standard_normal((8, n))
    ours = np.asarray(fft(jnp.asarray(x, dtype=jnp.complex64)))
    ref = np.fft.fft(x, axis=-1)
    err = ours - ref
    snr_db = 10 * np.log10(np.sum(np.abs(ref) ** 2) / np.sum(np.abs(err) ** 2))
    assert snr_db > 120.0, f"SNR {snr_db:.1f} dB"


def test_rfft_irfft_roundtrip(rng):
    from simpledsp_jax.ops.fft import irfft, rfft
    x = rng.standard_normal((3, 1024))
    half = rfft(jnp.asarray(x))
    assert half.shape == (3, 513)
    np.testing.assert_allclose(np.asarray(half), np.fft.rfft(x), atol=1e-10)
    back = irfft(half)
    np.testing.assert_allclose(np.asarray(back), x, atol=1e-12)


@pytest.mark.parametrize("n", [4, 64, 100, 125, 1024, 4096])
def test_rfft_ri_matches_numpy(rng, n):
    """True half-spectrum path (even n: half-size packed transform +
    Hermitian post-twiddle; odd n: fallback) vs numpy, both directions."""
    from simpledsp_jax.ops.fft import irfft_ri, rfft_ri
    x = rng.standard_normal((3, n))
    yr, yi = rfft_ri(jnp.asarray(x))
    assert yr.shape == (3, n // 2 + 1)
    ref = np.fft.rfft(x, axis=-1)
    np.testing.assert_allclose(np.asarray(yr), ref.real, atol=1e-10 * n)
    np.testing.assert_allclose(np.asarray(yi), ref.imag, atol=1e-10 * n)
    back = irfft_ri(yr, yi, n)
    np.testing.assert_allclose(np.asarray(back), x, atol=1e-11 * n)


def test_rfft_half_cost(rng):
    """The even-size rfft must actually run the packed half-size transform:
    its HLO flop estimate stays under ~60% of the full fft's."""
    import jax
    from simpledsp_jax.ops.fft import fft, rfft

    def cost(fn, x):
        c = jax.jit(fn).lower(x).compile().cost_analysis()
        c = c[0] if isinstance(c, (list, tuple)) else c
        return float(c.get("flops", 0.0))

    x = jnp.asarray(rng.standard_normal((64, 4096)), dtype=jnp.float32)
    full = cost(lambda v: fft(v), x)
    half = cost(lambda v: rfft(v), x)
    assert 0 < half < 0.6 * full, (half, full)


def test_welch_psd_matches_scipy(rng):
    import scipy.signal as sig
    from simpledsp_jax.ops.spectral import welch_psd
    fs = 1000.0
    t = np.arange(16384) / fs
    # DC offset makes detrend behavior observable: scipy's default
    # detrend='constant' must be matched BY DEFAULT here too.
    x = (np.sin(2 * np.pi * 123.0 * t) + 0.1 * rng.standard_normal(t.size)
         + 3.0)
    f1, p1 = welch_psd(jnp.asarray(x), nfft=1024, fs=fs, window="hann")
    f2, p2 = sig.welch(x, fs=fs, nperseg=1024, window="hann", noverlap=512)
    np.testing.assert_allclose(f1, f2)
    np.testing.assert_allclose(np.asarray(p1), p2, rtol=1e-8, atol=1e-12)
    for detrend in (False, "constant", "linear"):
        f1, p1 = welch_psd(jnp.asarray(x), nfft=1024, fs=fs, window="hann",
                           detrend=detrend)
        f2, p2 = sig.welch(x, fs=fs, nperseg=1024, window="hann",
                           noverlap=512, detrend=detrend)
        np.testing.assert_allclose(np.asarray(p1), p2, rtol=1e-7, atol=1e-12)


def test_spectrogram_tone_bin(rng):
    from simpledsp_jax.ops.spectral import spectrogram_ri
    n = 1024
    x = np.cos(2 * np.pi * 128 * np.arange(8 * n) / n)
    sr, si = spectrogram_ri(jnp.asarray(x), nfft=n, window="rect")
    mag = np.abs(np.asarray(sr) + 1j * np.asarray(si))
    # positive-frequency half (bin n-128 mirrors bin 128 for real input)
    assert (mag[..., : n // 2].argmax(axis=-1) == 128).all()


def test_csd_matches_scipy(rng):
    import scipy.signal as sig
    from simpledsp_jax.ops.spectral import csd_ri
    fs = 2000.0
    t = np.arange(8192) / fs
    x = np.sin(2 * np.pi * 97.0 * t) + 0.2 * rng.standard_normal(t.size)
    y = (np.roll(np.sin(2 * np.pi * 97.0 * t), 11)
         + 0.2 * rng.standard_normal(t.size) + 1.5)
    f1, pr, pi = csd_ri(jnp.asarray(x), jnp.asarray(y), nfft=512, fs=fs)
    f2, pxy = sig.csd(x, y, fs=fs, nperseg=512, noverlap=256)
    np.testing.assert_allclose(f1, f2)
    np.testing.assert_allclose(np.asarray(pr), pxy.real, rtol=1e-7,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(pi), pxy.imag, rtol=1e-7,
                               atol=1e-12)


def test_coherence_matches_scipy(rng):
    import scipy.signal as sig
    from simpledsp_jax.ops.spectral import coherence
    fs = 1000.0
    t = np.arange(16384) / fs
    s = np.sin(2 * np.pi * 61.0 * t)
    x = s + 0.5 * rng.standard_normal(t.size)
    y = 0.7 * s + 0.5 * rng.standard_normal(t.size)
    f1, c1 = coherence(jnp.asarray(x), jnp.asarray(y), nfft=256, fs=fs)
    f2, c2 = sig.coherence(x, y, fs=fs, nperseg=256, noverlap=128)
    np.testing.assert_allclose(f1, f2)
    np.testing.assert_allclose(np.asarray(c1), c2, rtol=1e-7, atol=1e-10)
    assert float(jnp.max(c1)) <= 1.0 + 1e-9


def test_periodogram_matches_scipy(rng):
    import scipy.signal as sig
    from simpledsp_jax.ops.spectral import periodogram
    x = rng.standard_normal(3000) + 2.0
    for window, nfft, detrend in (("boxcar", None, "constant"),
                                  ("hann", 4096, "constant"),
                                  ("hann", None, False)):
        f1, p1 = periodogram(jnp.asarray(x), fs=100.0, window=window,
                             nfft=nfft, detrend=detrend)
        f2, p2 = sig.periodogram(x, fs=100.0, window=window, nfft=nfft,
                                 detrend=detrend)
        np.testing.assert_allclose(f1, f2)
        np.testing.assert_allclose(np.asarray(p1), p2, rtol=1e-7,
                                   atol=1e-12)


def test_spectrogram_direct_matches_fft(rng):
    """The windowed-DFT matmul route ('direct') must agree with the
    four-step FFT route ('fft') bin-for-bin, one- and two-sided, with
    window + detrend in play."""
    from simpledsp_jax.ops.spectral import spectrogram_ri
    x = jnp.asarray(rng.standard_normal((3, 5000)))
    for nfft, hop in ((256, 128), (250, 125), (1024, 1024)):
        for onesided in (False, True):
            d = spectrogram_ri(x, nfft=nfft, hop=hop, window="hann",
                               detrend="constant", onesided=onesided,
                               method="direct")
            f = spectrogram_ri(x, nfft=nfft, hop=hop, window="hann",
                               detrend="constant", onesided=onesided,
                               method="fft")
            for a, b in zip(d, f):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           atol=1e-9)


def test_fft_1d_small_sizes(rng):
    """Regression: rank-1 input with N <= 128 (single dense-matmul path)."""
    for n in (16, 64, 128):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        got = np.asarray(fft(jnp.asarray(x)))
        np.testing.assert_allclose(got, np.fft.fft(x), atol=1e-10)


def test_welch_odd_nfft_matches_scipy(rng):
    """Regression: odd nfft has no Nyquist bin — top bin must not be
    halved."""
    import scipy.signal as sig
    from simpledsp_jax.ops.spectral import welch_psd
    x = rng.standard_normal(8000)
    f1, p1 = welch_psd(jnp.asarray(x), nfft=125, fs=500.0)
    # our hop is nfft//2 = 62 -> scipy noverlap = nperseg - hop = 63
    f2, p2 = sig.welch(x, fs=500.0, nperseg=125, noverlap=63)
    np.testing.assert_allclose(np.asarray(p1), p2, rtol=1e-8, atol=1e-12)
