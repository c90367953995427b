"""FIR / polyphase / overlap-save tests.

Methodology mirrors the reference's (SURVEY.md §4): golden parity against an
independent implementation (scipy lfilter/upfirdn/firwin) plus the streaming
block-consistency contract (the reference's testIIR.cpp:61-75 applied to the
net-new FIR components).
"""

import numpy as np
import pytest
import scipy.signal as sig

import jax.numpy as jnp

from simpledsp_jax.design.fir import lowpass_taps, resampler_taps
from simpledsp_jax.ops.fir import (
    FIRFilter,
    OverlapSaveFIR,
    PolyphaseDecimator,
    PolyphaseInterpolator,
    PolyphaseResampler,
    fir_filter,
)


def test_lowpass_taps_match_firwin():
    ours = lowpass_taps(101, 0.2, fs=1.0, atten_db=80.0)
    theirs = sig.firwin(101, 0.2, fs=1.0,
                        window=("kaiser", 0.1102 * (80.0 - 8.7)))
    assert np.max(np.abs(ours - theirs)) < 1e-12


def test_firwin_scipy_parity_all_band_types():
    """The scipy-named entry point matches scipy.signal.firwin
    tap-for-tap across lowpass/highpass/bandpass/bandstop/multiband and
    window specs."""
    from simpledsp_jax.design import firwin

    cases = [
        dict(num_taps=65, cutoff=0.3, pass_zero=True),
        dict(num_taps=65, cutoff=0.3, pass_zero=False),
        dict(num_taps=64, cutoff=[0.2, 0.4], pass_zero=False),
        dict(num_taps=65, cutoff=[0.2, 0.4], pass_zero=True),
        dict(num_taps=101, cutoff=[0.1, 0.2, 0.35, 0.45],
             pass_zero="bandstop"),
        dict(num_taps=101, cutoff=[0.1, 0.2, 0.35, 0.45],
             pass_zero="bandpass"),
        dict(num_taps=73, cutoff=0.25, pass_zero="lowpass",
             window=("chebwin", 70)),
        dict(num_taps=73, cutoff=0.25, pass_zero=True, window="blackman"),
    ]
    for kw in cases:
        window = kw.pop("window", "hamming")
        ours = firwin(kw["num_taps"], kw["cutoff"], window=window,
                      pass_zero=kw["pass_zero"])
        theirs = sig.firwin(kw["num_taps"], kw["cutoff"], window=window,
                            pass_zero=kw["pass_zero"])
        assert np.max(np.abs(ours - theirs)) < 1e-12, kw


def test_firwin_rejects_bad_args():
    from simpledsp_jax.design import firwin

    with pytest.raises(ValueError):
        firwin(64, [0.4, 0.2])                       # non-ascending edges
    with pytest.raises(ValueError):
        firwin(64, 0.3, pass_zero="sideways")        # unknown mode
    with pytest.raises(ValueError):
        firwin(64, 0.3, pass_zero=False)             # even taps @ Nyquist


def test_fir_filter_matches_lfilter():
    rng = np.random.default_rng(20)
    h = lowpass_taps(63, 0.25)
    x = rng.standard_normal(1000)
    y, _ = FIRFilter(h, dtype=jnp.float64)(jnp.asarray(x))
    ref = sig.lfilter(h, 1.0, x)
    assert np.max(np.abs(np.asarray(y) - ref)) < 1e-12


def test_fir_streaming_bit_exact():
    rng = np.random.default_rng(21)
    h = lowpass_taps(31, 0.3)
    x = rng.standard_normal(512)
    f = FIRFilter(h, dtype=jnp.float64)
    whole, _ = f(jnp.asarray(x))
    y1, st = f(jnp.asarray(x[:200]))
    y2, _ = f(jnp.asarray(x[200:]), st)
    assert np.array_equal(np.asarray(whole),
                          np.concatenate([np.asarray(y1), np.asarray(y2)]))


@pytest.mark.parametrize("up,down", [(1, 4), (4, 1), (3, 2), (2, 3), (5, 7)])
def test_resampler_matches_upfirdn(up, down):
    rng = np.random.default_rng(22)
    h = resampler_taps(up, down)
    T = 420  # multiple of every `down` above
    x = rng.standard_normal(T)
    r = PolyphaseResampler(h, up=up, down=down, dtype=jnp.float64)
    y, _ = r(jnp.asarray(x))
    ref = sig.upfirdn(h, x, up=up, down=down)[: T * up // down]
    assert np.max(np.abs(np.asarray(y) - ref)) < 1e-12


def test_resampler_streaming_bit_exact():
    rng = np.random.default_rng(23)
    h = resampler_taps(3, 2)
    x = rng.standard_normal(400)
    r = PolyphaseResampler(h, up=3, down=2, dtype=jnp.float64)
    whole, _ = r(jnp.asarray(x))
    y1, st = r(jnp.asarray(x[:160]))
    y2, _ = r(jnp.asarray(x[160:]), st)
    assert np.array_equal(np.asarray(whole),
                          np.concatenate([np.asarray(y1), np.asarray(y2)]))


def test_decimator_interpolator_wrappers():
    rng = np.random.default_rng(24)
    h = lowpass_taps(48, 0.1)
    x = rng.standard_normal(256)
    yd, _ = PolyphaseDecimator(h, 4, dtype=jnp.float64)(jnp.asarray(x))
    ref_d = sig.upfirdn(h, x, up=1, down=4)[: 256 // 4]
    assert np.max(np.abs(np.asarray(yd) - ref_d)) < 1e-12
    yi, _ = PolyphaseInterpolator(h, 4, dtype=jnp.float64)(jnp.asarray(x))
    ref_i = sig.upfirdn(h, x, up=4, down=1)[: 256 * 4]
    assert np.max(np.abs(np.asarray(yi) - ref_i)) < 1e-12


def test_overlap_save_matches_lfilter():
    rng = np.random.default_rng(25)
    h = lowpass_taps(129, 0.22)
    x = rng.standard_normal(1024)
    f = OverlapSaveFIR(h, block_size=256, dtype=jnp.float64)
    y, _ = f(jnp.asarray(x))
    ref = sig.lfilter(h, 1.0, x)
    assert np.max(np.abs(np.asarray(y) - ref)) < 1e-10


def test_overlap_save_streaming():
    rng = np.random.default_rng(26)
    h = lowpass_taps(129, 0.22)
    x = rng.standard_normal(1024)
    f = OverlapSaveFIR(h, block_size=256, dtype=jnp.float64)
    whole, _ = f(jnp.asarray(x))
    y1, st = f(jnp.asarray(x[:512]))
    y2, _ = f(jnp.asarray(x[512:]), st)
    assert np.array_equal(np.asarray(whole),
                          np.concatenate([np.asarray(y1), np.asarray(y2)]))


def test_batched_channels():
    rng = np.random.default_rng(27)
    h = lowpass_taps(33, 0.2)
    x = rng.standard_normal((4, 300))
    yb, _ = FIRFilter(h, dtype=jnp.float64)(jnp.asarray(x))
    for i in range(4):
        ref = sig.lfilter(h, 1.0, x[i])
        assert np.max(np.abs(np.asarray(yb)[i] - ref)) < 1e-12


def test_f32_snr():
    rng = np.random.default_rng(28)
    h = lowpass_taps(63, 0.25)
    x = rng.standard_normal(4096)
    y, _ = FIRFilter(h, dtype=jnp.float32)(jnp.asarray(x, dtype=jnp.float32))
    ref = sig.lfilter(h, 1.0, x)
    err = np.asarray(y, dtype=np.float64) - ref
    snr = 10 * np.log10(np.sum(ref ** 2) / np.sum(err ** 2))
    assert snr > 100.0, f"SNR {snr:.1f} dB"


def test_fir_filter_convenience():
    rng = np.random.default_rng(29)
    h = lowpass_taps(129, 0.2)
    x = jnp.asarray(rng.standard_normal(2048))
    y_fft, _ = fir_filter(h, x, method="fft", block_size=1024)
    y_dir, _ = fir_filter(h, x, method="direct")
    assert np.max(np.abs(np.asarray(y_fft) - np.asarray(y_dir))) < 1e-10


class TestFourierResample:
    """ops.fir.resample vs scipy.signal.resample (FFT method), including
    the even-grid Nyquist fold/halve rules."""

    @pytest.mark.parametrize("n,num", [(100, 50), (100, 51), (100, 200),
                                       (100, 201), (99, 50), (99, 200),
                                       (100, 64), (128, 100), (100, 100)])
    def test_matches_scipy(self, rng, n, num):
        import scipy.signal as ss
        from simpledsp_jax.ops.fir import resample

        x = rng.standard_normal((3, n))
        got = np.asarray(resample(jnp.asarray(x), num))
        ref = ss.resample(x, num, axis=-1)
        assert got.shape == ref.shape
        assert np.max(np.abs(got - ref)) < 1e-10

    def test_rejects_complex_and_bad_num(self, rng):
        from simpledsp_jax.ops.fir import resample

        with pytest.raises(ValueError):
            resample(jnp.asarray(np.ones(8, dtype=np.complex128)), 4)
        with pytest.raises(ValueError):
            resample(jnp.asarray(np.ones(8)), 0)


class TestDecimate:
    @pytest.mark.parametrize("q", [2, 4, 13])
    @pytest.mark.parametrize("ftype", ["iir", "fir"])
    @pytest.mark.parametrize("zero_phase", [True, False])
    def test_matches_scipy(self, rng, q, ftype, zero_phase):
        import scipy.signal as ss
        from simpledsp_jax.ops.fir import decimate

        x = rng.standard_normal((2, 1000))
        got = np.asarray(decimate(jnp.asarray(x), q, ftype=ftype,
                                  zero_phase=zero_phase))
        ref = ss.decimate(x, q, ftype=ftype, zero_phase=zero_phase,
                          axis=-1)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-11)

    def test_rejects_bad_args(self, rng):
        from simpledsp_jax.ops.fir import decimate

        x = jnp.asarray(rng.standard_normal(100))
        with pytest.raises(ValueError):
            decimate(x, 0)
        with pytest.raises(ValueError):
            decimate(x, 2, n=7, ftype="iir")
        with pytest.raises(ValueError):
            decimate(x, 2, ftype="cic")


class TestResamplePoly:
    @pytest.mark.parametrize("up,down", [(2, 1), (1, 3), (3, 2), (7, 5),
                                         (160, 441)])
    @pytest.mark.parametrize("t", [1000, 997])
    def test_matches_scipy(self, rng, up, down, t):
        import scipy.signal as ss
        from simpledsp_jax.ops.fir import resample_poly

        x = rng.standard_normal((2, t)) + 2.0
        got = np.asarray(resample_poly(jnp.asarray(x), up, down))
        want = ss.resample_poly(x, up, down, axis=-1)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-12)

    def test_padtypes_window_and_taps(self, rng):
        import scipy.signal as ss
        from simpledsp_jax.ops.fir import resample_poly

        x = rng.standard_normal(800) + 3.0
        for padtype in ("mean", "median", "minimum", "maximum"):
            got = np.asarray(resample_poly(jnp.asarray(x), 3, 2,
                                           padtype=padtype))
            want = ss.resample_poly(x, 3, 2, padtype=padtype)
            np.testing.assert_allclose(got, want, atol=1e-12)
        got = np.asarray(resample_poly(jnp.asarray(x), 2, 3,
                                       window="hamming"))
        want = ss.resample_poly(x, 2, 3, window="hamming")
        np.testing.assert_allclose(got, want, atol=1e-12)
        taps = ss.firwin(31, 0.4)
        got = np.asarray(resample_poly(jnp.asarray(x), 2, 3, window=taps))
        want = ss.resample_poly(x, 2, 3, window=taps)
        np.testing.assert_allclose(got, want, atol=1e-12)

    def test_identity_and_errors(self, rng):
        from simpledsp_jax.ops.fir import resample_poly

        x = jnp.asarray(rng.standard_normal(64))
        assert resample_poly(x, 3, 3) is x
        with pytest.raises(ValueError):
            resample_poly(x, 2, 3, padtype="wrap")
        with pytest.raises(ValueError):
            resample_poly(x, 2, 3, window=np.ones((3, 3)))


def test_firwin_2d_matches_scipy():
    from simpledsp_jax.design.fir import firwin_2d
    a = firwin_2d((15, 21), ("hamming", "blackman"), fc=0.3)
    b = sig.firwin_2d((15, 21), ("hamming", "blackman"), fc=0.3)
    np.testing.assert_allclose(a, b, atol=1e-15)
    a = firwin_2d((17, 17), "hamming", fc=0.4, circular=True)
    b = sig.firwin_2d((17, 17), "hamming", fc=0.4, circular=True)
    np.testing.assert_allclose(a, b, atol=1e-15)
    with pytest.raises(ValueError):
        firwin_2d((15,), ("hamming", "hamming"), fc=0.3)
    with pytest.raises(ValueError):
        firwin_2d((15, 15), "hamming", circular=True)      # no fc
    with pytest.raises(ValueError):
        firwin_2d((15, 15), "hamming", fc=0.3)             # non-pair window


def test_fftconvolve_oaconvolve_aliases(rng):
    from simpledsp_jax.ops.conv import fftconvolve, oaconvolve
    x = rng.standard_normal(500)
    h = rng.standard_normal(31)
    for mode in ("full", "same", "valid"):
        np.testing.assert_allclose(
            np.asarray(fftconvolve(jnp.asarray(x), h, mode)),
            sig.fftconvolve(x, h, mode), atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(oaconvolve(jnp.asarray(x), h, mode)),
            sig.oaconvolve(x, h, mode), atol=1e-12)


@pytest.mark.parametrize("up,down,n,m", [(3, 2, 100, 31), (1, 4, 97, 24),
                                         (4, 1, 50, 16), (5, 7, 211, 61),
                                         (1, 1, 40, 7)])
def test_upfirdn_full_length_matches_scipy(rng, up, down, n, m):
    from simpledsp_jax.ops.fir import upfirdn
    h = rng.standard_normal(m)
    x = rng.standard_normal((2, n))
    got = np.asarray(upfirdn(h, jnp.asarray(x), up, down))
    ref = np.stack([sig.upfirdn(h, x[i], up=up, down=down)
                    for i in range(2)])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-12)


def test_firwin_multiband_scaling_matches_scipy():
    """Unity-response point is decided by the FIRST band (review-fixed
    regression pin: multiband pass_zero=False previously scaled at
    Nyquist)."""
    for win in ("blackman", "hamming", ("kaiser", 6.0)):
        from simpledsp_jax.design import firwin
        ours = firwin(33, [0.2, 0.4, 0.6], window=win, pass_zero=False)
        ref = sig.firwin(33, [0.2, 0.4, 0.6], window=win, pass_zero=False)
        np.testing.assert_allclose(ours, ref, atol=1e-12)
