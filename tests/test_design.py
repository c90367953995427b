"""Coefficient-design validation against scipy (the reference validates the
same math against GNU Octave butter/zp2sos/sosfilt — test/testIIR.cpp:30-77,
test_data/WriteImpulse.m).  scipy uses the same algorithms as Octave's signal
package, so this is an equivalent independent cross-check.
"""

import numpy as np
import pytest
import scipy.signal as sig

from simpledsp_jax.design import (
    FilterType,
    design_bandpass,
    design_bandstop,
    design_highpass,
    design_lowpass,
    sos_matrix,
)

# The reference fixture grid: fs = 39 kHz, order 8 (M = 4 sections), three
# (f0, Q) operating points (test_data/WriteImpulse.m:7-14, 35-36, 57-58).
FS = 39000.0
CONFIGS = [(200.0, 1.4), (2000.0, 0.8), (15000.0, 2.0)]
M = 4


def impulse(n=1000):
    x = np.zeros(n)
    x[0] = 1.0
    return x


def sos_impulse(sos, n=1000):
    return sig.sosfilt(sos, impulse(n))


@pytest.mark.parametrize("f0", [f for f, _ in CONFIGS])
def test_lowpass_matches_scipy_butter(f0):
    ours = sos_impulse(sos_matrix(design_lowpass(M, f0, FS)))
    scipy_sos = sig.butter(2 * M, f0, btype="low", fs=FS, output="sos")
    theirs = sos_impulse(scipy_sos)
    assert np.max(np.abs(ours - theirs)) < 1e-12


@pytest.mark.parametrize("f0", [f for f, _ in CONFIGS])
def test_highpass_matches_scipy_butter(f0):
    ours = sos_impulse(sos_matrix(design_highpass(M, f0, FS)))
    scipy_sos = sig.butter(2 * M, f0, btype="high", fs=FS, output="sos")
    theirs = sos_impulse(scipy_sos)
    assert np.max(np.abs(ours - theirs)) < 1e-12


def measured_band_edges(sos, f_center, fs):
    """Numerically locate the -3 dB edges of a band filter (the test-side
    analog of the reference's findIIRCutoffFreq.m analytic scan)."""
    from scipy.optimize import brentq

    def mag2(f):
        w, h = sig.sosfreqz(sos, worN=[2 * np.pi * f / fs])
        return np.abs(h[0]) ** 2 - 0.5

    lo = brentq(mag2, 1e-6, f_center, xtol=1e-10)
    hi = brentq(mag2, f_center, fs / 2 - 1e-6, xtol=1e-10)
    return lo, hi


@pytest.mark.parametrize("f0,q", CONFIGS)
def test_bandpass_is_butterworth(f0, q):
    """Our closed-form BP must equal scipy's Butterworth BP with the same
    measured -3 dB edges (Butterworth is unique given order + edges)."""
    ours_sos = sos_matrix(design_bandpass(M, f0, FS, q))
    f1, f2 = measured_band_edges(ours_sos, f0, FS)
    # Bandwidth convention check: f2 - f1 == f0 / q (findIIRCutoffFreq.m:35).
    assert abs((f2 - f1) - f0 / q) / (f0 / q) < 1e-6
    scipy_sos = sig.butter(M, [f1, f2], btype="bandpass", fs=FS, output="sos")
    ours = sos_impulse(ours_sos)
    theirs = sos_impulse(scipy_sos)
    assert np.max(np.abs(ours - theirs)) < 1e-9


@pytest.mark.parametrize("f0,q", [(2000.0, 0.8), (5000.0, 2.0)])
def test_bandstop_design(f0, q):
    """Band-stop (net-new; reference README.md:15 TODO): unity DC gain, deep
    notch at f0, -3 dB edges separated by f0/q, matches scipy bandstop."""
    d = design_bandstop(M, f0, FS, q)
    assert d.ftype == FilterType.band_stop
    assert d.nsections == M
    sos = sos_matrix(d)
    w, h = sig.sosfreqz(sos, worN=[0.0, 2 * np.pi * f0 / FS])
    assert abs(abs(h[0]) - 1.0) < 1e-9          # DC gain 1
    assert abs(h[1]) < 1e-9                      # notch at f0
    # b0 == 1 normalization with gain folded out
    assert np.allclose(d.b[:, 0], 1.0)
    assert np.allclose(d.a[:, 0], 1.0)


@pytest.mark.parametrize("f0,q", CONFIGS)
def test_bandpass_unity_peak(f0, q):
    sos = sos_matrix(design_bandpass(M, f0, FS, q))
    w, h = sig.sosfreqz(sos, worN=[2 * np.pi * f0 / FS])
    assert abs(abs(h[0]) - 1.0) < 1e-9


def test_gain_parameter_scales_linearly():
    d1 = design_lowpass(M, 2000.0, FS, gain=1.0)
    d2 = design_lowpass(M, 2000.0, FS, gain=2.0)
    assert np.allclose(d2.gain, 2.0 * d1.gain, rtol=0, atol=0)
    assert np.array_equal(d1.a, d2.a)
    assert np.array_equal(d1.b, d2.b)


def test_validation_errors():
    with pytest.raises(ValueError):
        design_bandpass(3, 2000.0, FS, 1.0)  # band filters need pole pairs
    with pytest.raises(ValueError):
        design_lowpass(0, 200.0, FS)
    with pytest.raises(ValueError):
        design_lowpass(4, -1.0, FS)
    with pytest.raises(ValueError):
        design_highpass(4, FS, FS)  # f0 >= fs/2


def test_odd_m_lowpass_matches_scipy():
    """Odd section counts are legal for LP/HP (order 2M Butterworth) —
    a deliberate loosening of the reference's blanket even-M assert."""
    import scipy.signal as sig
    from simpledsp_jax.design.biquad import sos_matrix
    d = design_lowpass(3, 2000.0, FS)  # order 6
    z, p, k = sig.butter(6, 2000.0, fs=FS, output="zpk")
    sos = sig.zpk2sos(z, p, k)
    x = np.zeros(500); x[0] = 1.0
    np.testing.assert_allclose(sig.sosfilt(sos_matrix(d), x),
                               sig.sosfilt(sos, x), atol=1e-12)


def test_freq_response_matches_scipy():
    import scipy.signal as sig
    from simpledsp_jax.design.biquad import freq_response, sos_matrix
    d = design_lowpass(4, 2000.0, 39000.0)
    w, h = freq_response(d, n=256)
    w2, h2 = sig.sosfreqz(sos_matrix(d), worN=256, fs=39000.0)
    np.testing.assert_allclose(h, h2)
    # DC gain ~1, -3 dB near cutoff for Butterworth
    assert abs(abs(h[0]) - 1.0) < 1e-9
    _, hc = freq_response(d, freqs=[2000.0])
    assert abs(20*np.log10(abs(hc[0])) + 3.01) < 0.05


def test_group_delay_positive_in_passband():
    from simpledsp_jax.design.biquad import group_delay
    d = design_lowpass(4, 2000.0, 39000.0)
    w, gd = group_delay(d, n=128)
    passband = gd[w < 1500.0]
    assert (passband > 0).all()


def test_block_matches_scan_random_designs():
    """Property: block state-space condensation == scan oracle for random
    designs (catches condensation bugs beyond the fixture grid)."""
    import jax.numpy as jnp
    from simpledsp_jax.ops.iir import (
        BlockIIR, coeffs_from_design, iir_init, sosfilt_scan)
    rng = np.random.default_rng(11)
    for _ in range(5):
        m = int(rng.choice([2, 4, 6]))
        fs = 48000.0
        kind = rng.choice(["lp", "hp", "bp"])
        f0 = float(rng.uniform(0.02, 0.4) * fs / 2)
        if kind == "lp":
            d = design_lowpass(m, f0, fs)
        elif kind == "hp":
            d = design_highpass(m, f0, fs)
        else:
            d = design_bandpass(m, f0, fs, float(rng.uniform(0.5, 3.0)))
        x = rng.standard_normal(700)
        blk = BlockIIR(d, block_size=64, dtype=jnp.float64)
        y_b, _ = blk(jnp.asarray(x))
        y_s, _ = sosfilt_scan(coeffs_from_design(d, dtype=jnp.float64),
                              jnp.asarray(x), iir_init(m, (), jnp.float64))
        scale = max(1.0, np.abs(np.asarray(y_s)).max())
        assert np.abs(np.asarray(y_b) - np.asarray(y_s)).max() / scale < 1e-11


class TestFirwinBands:
    """highpass/bandpass/bandstop windowed-sinc designs vs
    scipy.signal.firwin (same construction, same kaiser window)."""

    def test_highpass_matches_firwin(self):
        import scipy.signal as ss
        from simpledsp_jax.design.fir import highpass_taps, kaiser_beta

        h = highpass_taps(101, 8e3, fs=48e3, atten_db=70.0)
        ref = ss.firwin(101, 8e3, fs=48e3, pass_zero=False,
                        window=("kaiser", kaiser_beta(70.0)))
        np.testing.assert_allclose(h, ref, atol=1e-14)

    def test_bandpass_matches_firwin(self):
        import scipy.signal as ss
        from simpledsp_jax.design.fir import bandpass_taps, kaiser_beta

        h = bandpass_taps(128, 4e3, 9e3, fs=48e3, atten_db=60.0)
        ref = ss.firwin(128, [4e3, 9e3], fs=48e3, pass_zero=False,
                        window=("kaiser", kaiser_beta(60.0)))
        np.testing.assert_allclose(h, ref, atol=1e-14)

    def test_bandstop_matches_firwin(self):
        import scipy.signal as ss
        from simpledsp_jax.design.fir import bandstop_taps, kaiser_beta

        h = bandstop_taps(151, 4e3, 9e3, fs=48e3, atten_db=60.0)
        ref = ss.firwin(151, [4e3, 9e3], fs=48e3, pass_zero=True,
                        window=("kaiser", kaiser_beta(60.0)))
        np.testing.assert_allclose(h, ref, atol=1e-14)

    def test_stopband_attenuation(self):
        """Frequency-domain gate: >= 75 dB down in the designed stopband."""
        from simpledsp_jax.design.fir import bandstop_taps

        h = bandstop_taps(201, 0.2, 0.3, fs=1.0, atten_db=80.0)
        f = np.linspace(0, 0.5, 4001)
        w = np.exp(-2j * np.pi * np.outer(f, np.arange(h.size)))
        mag = np.abs(w @ h)
        stop = (f > 0.225) & (f < 0.275)
        assert mag[stop].max() < 10 ** (-75 / 20.0)
        assert abs(mag[0] - 1.0) < 1e-6

    def test_even_taps_at_nyquist_rejected(self):
        from simpledsp_jax.design.fir import bandstop_taps, highpass_taps

        with pytest.raises(ValueError):
            highpass_taps(100, 8e3, fs=48e3)
        with pytest.raises(ValueError):
            bandstop_taps(100, 4e3, 9e3, fs=48e3)


class TestCheby1:
    @pytest.mark.parametrize("m,rp,wn", [(4, 0.05, 0.8 / 8), (4, 0.05, 0.4),
                                         (2, 1.0, 0.1), (3, 0.5, 0.2),
                                         (5, 3.0, 0.6)])
    def test_matches_scipy_ba(self, m, rp, wn):
        import scipy.signal as ss
        from simpledsp_jax.design.biquad import (ba_coefficients,
                                                 design_cheby1_lowpass)

        d = design_cheby1_lowpass(m, rp, wn, 2.0)
        b, a = ba_coefficients(d)
        b2, a2 = ss.cheby1(2 * m, rp, wn)
        np.testing.assert_allclose(b, b2, atol=1e-14)
        np.testing.assert_allclose(a, a2, atol=1e-12)

    def test_impulse_response_gate(self):
        """Same 1e-12 impulse-response gate the golden fixtures use."""
        import scipy.signal as ss
        from simpledsp_jax.design.biquad import (design_cheby1_lowpass,
                                                 sos_matrix)

        d = design_cheby1_lowpass(4, 0.05, 3000.0, 39000.0)
        imp = np.zeros(1000)
        imp[0] = 1.0
        got = ss.sosfilt(sos_matrix(d), imp)
        want = ss.sosfilt(
            ss.cheby1(8, 0.05, 3000.0, fs=39000.0, output="sos"), imp)
        assert np.max(np.abs(got - want)) < 1e-12

    def test_rejects_bad_args(self):
        from simpledsp_jax.design.biquad import design_cheby1_lowpass

        with pytest.raises(ValueError):
            design_cheby1_lowpass(0, 0.05, 0.1, 2.0)
        with pytest.raises(ValueError):
            design_cheby1_lowpass(4, 0.05, 1.5, 2.0)


class TestFirwin2:
    @pytest.mark.parametrize("nt,f,g,kw", [
        (65, [0, 0.3, 0.3, 1], [1, 1, 0, 0], {}),
        (64, [0, 0.5, 1], [1, 1, 0], {}),
        (101, [0, 0.5, 1], [0, 1, 0], {"antisymmetric": True}),
        (100, [0, 0.5, 1], [0, 1, 1], {"antisymmetric": True}),
        (33, [0, 0.2, 0.8, 1], [0, 1, 0.5, 0], {"window": "blackman"}),
        (65, [0, 1], [1, 1], {"window": None}),
    ])
    def test_matches_scipy(self, nt, f, g, kw):
        import scipy.signal as ss
        from simpledsp_jax.design.fir import firwin2

        got = firwin2(nt, f, g, **kw)
        want = ss.firwin2(nt, f, g, **kw)
        np.testing.assert_allclose(got, want, atol=1e-15)

    def test_rejects_bad_specs(self):
        from simpledsp_jax.design.fir import firwin2

        with pytest.raises(ValueError):
            firwin2(65, [0, 0.5], [1, 1])           # must end at 1
        with pytest.raises(ValueError):
            firwin2(64, [0, 1], [1, 1])             # type II, Nyquist != 0
        with pytest.raises(ValueError):
            firwin2(101, [0, 1], [1, 0],
                    antisymmetric=True)             # type III, DC != 0
        with pytest.raises(ValueError):
            firwin2(65, [0, 0.5, 0.4, 1], [1, 1, 0, 0])  # decreasing
        with pytest.raises(ValueError):
            firwin2(65, [0, .3, .3, .3, 1], [1, 1, 1, 0, 0])  # tripled
        with pytest.raises(ValueError):
            firwin2(65, [0, 1], [1, 0], nfreqs=33)  # num_taps >= nfreqs


class TestCheby2:
    @pytest.mark.parametrize("m,rs,wn", [(4, 40.0, 0.3), (2, 60.0, 0.1),
                                         (5, 30.0, 0.7), (3, 80.0, 0.45)])
    def test_matches_scipy_ba(self, m, rs, wn):
        import scipy.signal as ss
        from simpledsp_jax.design.biquad import (ba_coefficients,
                                                 design_cheby2_lowpass)

        d = design_cheby2_lowpass(m, rs, wn, 2.0)
        b, a = ba_coefficients(d)
        b2, a2 = ss.cheby2(2 * m, rs, wn)
        np.testing.assert_allclose(b, b2, atol=1e-12)
        np.testing.assert_allclose(a, a2, atol=1e-12)

    def test_stopband_attenuation_holds(self):
        import scipy.signal as ss
        from simpledsp_jax.design.biquad import (design_cheby2_lowpass,
                                                 sos_matrix)

        d = design_cheby2_lowpass(4, 50.0, 6000.0, 48000.0)
        w, h = ss.sosfreqz(sos_matrix(d), worN=4096, fs=48000.0)
        stop = w >= 6000.0
        assert np.max(20 * np.log10(np.abs(h[stop]) + 1e-300)) <= -50.0 + 1e-6
        assert abs(abs(h[0]) - 1.0) < 1e-12


class TestLTIConversions:
    """design/ltisys.py — representation-conversion family vs scipy."""

    def test_tf_zpk_round_trip(self):
        from simpledsp_jax.design import ltisys as lt
        b = np.array([0.5, 1.2, -0.3])
        a = np.array([2.0, 0.4, 0.9, 0.1])
        z1, p1, k1 = lt.tf2zpk(b, a)
        z2, p2, k2 = sig.tf2zpk(b, a)
        np.testing.assert_allclose(np.sort_complex(z1), np.sort_complex(z2))
        np.testing.assert_allclose(np.sort_complex(p1), np.sort_complex(p2))
        assert abs(k1 - k2) < 1e-14
        bb, aa = lt.zpk2tf(z1, p1, k1)
        bs, as_ = sig.zpk2tf(z2, p2, k2)
        np.testing.assert_allclose(bb, bs, atol=1e-12)
        np.testing.assert_allclose(aa, as_, atol=1e-12)

    def test_sos_family(self):
        from simpledsp_jax.design import ltisys as lt
        sos = sig.butter(6, 0.3, output="sos")
        bt, at = lt.sos2tf(sos)
        bts, ats = sig.sos2tf(sos)
        np.testing.assert_allclose(bt, bts, atol=1e-12)
        np.testing.assert_allclose(at, ats, atol=1e-12)
        z1, p1, k1 = lt.sos2zpk(sos)
        z2, p2, k2 = sig.sos2zpk(sos)
        np.testing.assert_allclose(np.sort_complex(z1), np.sort_complex(z2),
                                   atol=1e-12)
        np.testing.assert_allclose(np.sort_complex(p1), np.sort_complex(p2),
                                   atol=1e-12)
        assert abs(k1 - k2) < 1e-12
        # tf2sos: pairing may differ from scipy's; the response may not.
        _, h1 = sig.sosfreqz(lt.tf2sos(bt, at), worN=256)
        _, h2 = sig.sosfreqz(sos, worN=256)
        np.testing.assert_allclose(h1, h2, atol=1e-9)

    def test_normalize(self):
        from simpledsp_jax.design import ltisys as lt
        bn, an = lt.normalize([0.0, 2.0, 4.0], [2.0, 1.0])
        bns, ans = sig.normalize([0.0, 2.0, 4.0], [2.0, 1.0])
        np.testing.assert_allclose(bn, bns)
        np.testing.assert_allclose(an, ans)
        # scipy trims leading denominator zeros (round-5 alignment)
        bn, an = lt.normalize([1.0], [0.0, 1.0])
        bns, ans = sig.normalize([1.0], [0.0, 1.0])
        np.testing.assert_allclose(bn, bns)
        np.testing.assert_allclose(an, ans)
        with pytest.raises(ValueError):
            lt.normalize([1.0], [0.0, 0.0])      # all-zero denominator
        # near-zero numerator columns trim with the scipy warning class
        from simpledsp_jax.design.ltisys import BadCoefficients
        with pytest.warns(BadCoefficients):
            bn, an = lt.normalize([1e-16, 1.0], [1.0, 0.5])
        import warnings as _w
        with _w.catch_warnings():
            _w.simplefilter("ignore")
            bns, ans = sig.normalize([1e-16, 1.0], [1.0, 0.5])
        np.testing.assert_allclose(bn, bns)
        np.testing.assert_allclose(an, ans)

    @pytest.mark.parametrize("method", ["bilinear", "euler",
                                        "backward_diff", "zoh"])
    def test_cont2discrete_matches_scipy(self, method):
        from simpledsp_jax.design import ltisys as lt
        bc, ac = sig.butter(3, 10.0, analog=True)
        bd, ad, dt = lt.cont2discrete((bc, ac), 0.01, method=method)
        ref = sig.cont2discrete((bc, ac), 0.01, method=method)
        np.testing.assert_allclose(bd, np.squeeze(ref[0]), atol=1e-10)
        np.testing.assert_allclose(ad, np.atleast_1d(ref[1]), atol=1e-10)
        assert dt == 0.01
        with pytest.raises(ValueError):
            lt.cont2discrete((bc, ac), 0.01, method="warp-drive")


class TestDesignGlue:
    """sosfreqz / bilinear / tf2ss / ss2tf / iirdesign vs scipy."""

    def test_sosfreqz_matches_scipy(self):
        from simpledsp_jax.design import sosfreqz
        sos = sig.butter(6, 0.3, output="sos")
        w1, h1 = sosfreqz(sos, 256)
        w2, h2 = sig.sosfreqz(sos, worN=256)
        np.testing.assert_allclose(w1, w2)
        np.testing.assert_allclose(h1, h2, atol=1e-12)
        with pytest.raises(ValueError):
            sosfreqz(np.zeros((2, 5)))

    def test_bilinear_matches_scipy(self):
        from simpledsp_jax.design import bilinear
        bc, ac = sig.butter(3, 10.0, analog=True)
        bd, ad = bilinear(bc, ac, fs=100.0)
        bds, ads = sig.bilinear(bc, ac, fs=100.0)
        np.testing.assert_allclose(bd, bds, atol=1e-12)
        np.testing.assert_allclose(ad, ads, atol=1e-12)

    def test_tf2ss_ss2tf_round_trip(self):
        from simpledsp_jax.design import ss2tf, tf2ss
        b = np.array([0.5, 1.2, -0.3])
        a = np.array([2.0, 0.4, 0.9, 0.1])
        A, B, C, D = tf2ss(b, a)
        A2, B2, C2, D2 = sig.tf2ss(b, a)
        for x, y in [(A, A2), (B, B2), (C, C2), (D, D2)]:
            np.testing.assert_allclose(x, y, atol=1e-12)
        num, den = ss2tf(A, B, C, D)
        num2, den2 = sig.ss2tf(A2, B2, C2, D2)
        np.testing.assert_allclose(num, num2, atol=1e-12)
        np.testing.assert_allclose(den, den2, atol=1e-12)

    @pytest.mark.parametrize("wp,ws,gp,gs,ft", [
        (0.2, 0.3, 1.0, 40.0, "ellip"),
        (0.3, 0.2, 1.0, 40.0, "cheby1"),
        ([0.2, 0.5], [0.1, 0.6], 2.0, 40.0, "butter"),
        ([0.1, 0.6], [0.2, 0.5], 1.0, 30.0, "cheby2"),
    ])
    def test_iirdesign_matches_scipy_response(self, wp, ws, gp, gs, ft):
        from simpledsp_jax.design import iirdesign
        sos = iirdesign(wp, ws, gp, gs, ftype=ft, output="sos")
        sos_s = sig.iirdesign(wp, ws, gp, gs, ftype=ft, output="sos")
        _, h1 = sig.sosfreqz(sos, worN=512)
        _, h2 = sig.sosfreqz(sos_s, worN=512)
        np.testing.assert_allclose(h1, h2, atol=1e-5)
        with pytest.raises(ValueError):
            iirdesign(wp, ws, gp, gs, ftype="gaussian")


class TestLTISimulation:
    """lsim / impulse / step / dlsim family vs scipy (design/ltisys.py)."""

    def test_lsim_foh_and_zoh_match_scipy(self, rng):
        from simpledsp_jax.design import ltisys as lt
        bc, ac = sig.butter(3, 8.0, analog=True)
        t = np.linspace(0, 2, 201)
        u = np.sin(3 * t) + 0.2 * rng.standard_normal(t.size)
        for interp in (True, False):
            _, y1, _ = lt.lsim((bc, ac), u, t, interp=interp)
            _, y2, _ = sig.lsim((bc, ac), u, t, interp=interp)
            np.testing.assert_allclose(y1, y2, atol=1e-12)
        with pytest.raises(ValueError):
            lt.lsim((bc, ac), u, t ** 2)      # non-uniform grid
        with pytest.raises(ValueError):
            lt.lsim((bc, ac), u[:-1], t)

    def test_impulse_step_match_scipy(self):
        from simpledsp_jax.design import ltisys as lt
        bc, ac = sig.butter(3, 8.0, analog=True)
        t = np.linspace(0, 2, 201)
        _, y1 = lt.impulse((bc, ac), t=t)
        _, y2 = sig.impulse((bc, ac), T=t)
        np.testing.assert_allclose(y1, y2, atol=1e-12)
        _, y1 = lt.step((bc, ac), t=t)
        _, y2 = sig.step((bc, ac), T=t)
        np.testing.assert_allclose(y1, y2, atol=1e-12)
        # default horizon: same length, finite values
        td, yd = lt.impulse((bc, ac))
        assert td.size == 100 and np.all(np.isfinite(yd))

    def test_discrete_family_matches_scipy(self, rng):
        from simpledsp_jax.design import ltisys as lt
        bc, ac = sig.butter(3, 8.0, analog=True)
        bd, ad, dt = lt.cont2discrete((bc, ac), 0.01)
        u = rng.standard_normal(100)
        tout, y = lt.dlsim((bd, ad, dt), u)
        t2, y2 = sig.dlsim((bd, ad, dt), u)
        np.testing.assert_allclose(tout, t2)
        np.testing.assert_allclose(y, np.squeeze(y2), atol=1e-12)
        _, (ya,) = lt.dimpulse((bd, ad, dt), n=50)
        _, (yb,) = sig.dimpulse((bd, ad, dt), n=50)
        np.testing.assert_allclose(ya, np.squeeze(yb), atol=1e-12)
        _, (ya,) = lt.dstep((bd, ad, dt), n=50)
        _, (yb,) = sig.dstep((bd, ad, dt), n=50)
        np.testing.assert_allclose(ya, np.squeeze(yb), atol=1e-12)
        with pytest.raises(ValueError):
            lt.dlsim((bd, ad, dt), u, x0=np.zeros(3))

    def test_bode_freqresp_match_scipy(self):
        from simpledsp_jax.design import ltisys as lt
        bc, ac = sig.butter(3, 8.0, analog=True)
        w = np.logspace(-1, 2, 60)
        w1, m1, p1 = lt.bode((bc, ac), w)
        w2, m2, p2 = sig.bode((bc, ac), w=w)
        np.testing.assert_allclose(m1, m2, atol=1e-12)
        np.testing.assert_allclose(p1, p2, atol=1e-10)
        _, h1 = lt.freqresp((bc, ac), w)
        _, h2 = sig.freqresp((bc, ac), w=w)
        np.testing.assert_allclose(h1, h2, atol=1e-12)
        bd, ad, dt = lt.cont2discrete((bc, ac), 0.01)
        w1, m1, p1 = lt.dbode((bd, ad, dt), w[:30])
        w2, m2, p2 = sig.dbode((bd, ad, dt), w=w[:30] * dt)
        np.testing.assert_allclose(m1, m2, atol=1e-10)
        np.testing.assert_allclose(p1, p2, atol=1e-10)


def test_dfreqresp_matches_scipy():
    from simpledsp_jax.design import ltisys as lt
    bc, ac = sig.butter(3, 8.0, analog=True)
    bd, ad, dt = lt.cont2discrete((bc, ac), 0.01)
    w = np.linspace(0.1, 100.0, 40)
    w1, h1 = lt.dfreqresp((bd, ad, dt), w)
    w2, h2 = sig.dfreqresp((bd, ad, dt), w=w * dt)
    np.testing.assert_allclose(h1, h2, atol=1e-12)


def test_discrete_z_polynomial_convention():
    """(b, a, dt) uses scipy's z-polynomial convention: a shorter
    numerator is relative degree = delay (review-fixed regression pin)."""
    from simpledsp_jax.design import ltisys as lt
    sys_ = ([1.0], [1.0, -0.5], 1.0)
    imp = np.eye(1, 8)[0]
    _, y1 = lt.dlsim(sys_, imp)
    _, y2 = sig.dlsim(sys_, imp)
    np.testing.assert_allclose(y1, np.squeeze(y2), atol=1e-14)
    w = np.linspace(0.1, 2.0, 20)
    _, h1 = lt.dfreqresp(sys_, w)
    _, h2 = sig.dfreqresp(sys_, w=w)
    np.testing.assert_allclose(h1, h2, atol=1e-14)
    with pytest.raises(ValueError):
        lt.dlsim(([1.0, 0, 0, 0], [1.0, -0.5], 1.0), imp)  # non-causal


def test_sos2zpk_unnormalized_sections():
    from simpledsp_jax.design import ltisys as lt
    sos = np.array([[2, 1, .5, 2, -.4, .1], [1, .3, .2, 1, -.2, .05]])
    _, _, k1 = lt.sos2zpk(sos)
    _, _, k2 = sig.sos2zpk(sos)
    assert abs(k1 - k2) < 1e-12


def test_lp2_frequency_transforms_match_scipy():
    """Polynomial-level analog frequency transforms (round 5: the
    scipy.signal lp2lp/lp2hp/lp2bp/lp2bs names; zpk-level forms live in
    design/iir.py)."""
    from simpledsp_jax.design import ltisys as lt
    cases = [
        (np.array([1.0]), np.array([1.0, 1.4142, 1.0])),
        (np.array([2.0, 1.0]), np.array([1.0, 2.0, 3.0, 1.0])),
        (np.array([1.0, 0.5, 0.2, 0.1]), np.array([1.0, 2.0])),  # n > d
    ]
    for b, a in cases:
        for wo in (1.0, 0.4, 3.7):
            for mine, ref in ((lt.lp2lp, sig.lp2lp),
                              (lt.lp2hp, sig.lp2hp)):
                mb, ma_ = mine(b, a, wo)
                rb, ra = ref(b, a, wo)
                np.testing.assert_allclose(mb, rb, rtol=1e-12, atol=1e-12)
                np.testing.assert_allclose(ma_, ra, rtol=1e-12, atol=1e-12)
            for mine, ref in ((lt.lp2bp, sig.lp2bp),
                              (lt.lp2bs, sig.lp2bs)):
                for bw in (1.0, 0.3, 2.2):
                    mb, ma_ = mine(b, a, wo, bw)
                    rb, ra = ref(b, a, wo, bw)
                    np.testing.assert_allclose(mb, rb, rtol=1e-10,
                                               atol=1e-12)
                    np.testing.assert_allclose(ma_, ra, rtol=1e-10,
                                               atol=1e-12)


def test_ss_zpk_roundtrip_matches_scipy():
    from simpledsp_jax.design import ltisys as lt
    rng = np.random.default_rng(3)
    A = rng.standard_normal((4, 4))
    B = rng.standard_normal((4, 1))
    C = rng.standard_normal((1, 4))
    D = rng.standard_normal((1, 1))
    z1, p1, k1 = lt.ss2zpk(A, B, C, D)
    z2, p2, k2 = sig.ss2zpk(A, B, C, D)
    np.testing.assert_allclose(np.sort_complex(z1), np.sort_complex(z2),
                               atol=1e-8)
    np.testing.assert_allclose(np.sort_complex(p1), np.sort_complex(p2),
                               atol=1e-8)
    assert abs(k1 - k2) < 1e-8 * max(1.0, abs(k2))
    zz = np.array([-1.0 + 1j, -1.0 - 1j])
    pp = np.array([-2.0, -3.0, -0.5])
    for m1, m2 in zip(lt.zpk2ss(zz, pp, 2.3), sig.zpk2ss(zz, pp, 2.3)):
        np.testing.assert_allclose(m1, m2, atol=1e-12)
    # freqz_sos is the scipy 1.15+ name for sosfreqz
    sos = sig.butter(4, 0.3, output="sos")
    _, h1 = lt.freqz_sos(sos, 128)
    _, h2 = sig.freqz_sos(sos, 128)
    np.testing.assert_allclose(h1, h2, atol=1e-12)


def test_sos2zpk_degenerate_numerator():
    """Sections with b0 == 0 (advisor round-4 finding): scipy routes each
    row through tf2zpk/normalize, so a pure-delay section contributes its
    first NONZERO numerator coefficient as gain, not b0/a0 == 0."""
    from simpledsp_jax.design import ltisys as lt
    for sos in (np.array([[0., 1., 0., 1., -.5, 0.]]),          # pure delay
                np.array([[0., 2., .3, 1., -.2, .05],            # b0=0 pair
                          [1., .3, .2, 1., -.2, .05]]),
                np.array([[0., 0., 3., 1., -.4, .1]])):          # b0=b1=0
        z1, p1, k1 = lt.sos2zpk(sos)
        z2, p2, k2 = sig.sos2zpk(sos)
        assert abs(k1 - k2) < 1e-12, f"{sos}: {k1} vs {k2}"
        np.testing.assert_allclose(np.sort_complex(z1),
                                   np.sort_complex(z2), atol=1e-12)
        np.testing.assert_allclose(np.sort_complex(p1),
                                   np.sort_complex(p2), atol=1e-12)


def test_lp2_transforms_preserve_complex_prototypes():
    """Complex analog prototypes flow through lp2* and tf2zpk unharmed
    (round-5 review fix: the f64 coercion silently realized them)."""
    from simpledsp_jax.design import ltisys as lt
    b = np.array([1 + 0.5j])
    a = np.array([1, 0.3 + 0.2j, 1])
    for mine, ref in ((lt.lp2lp, sig.lp2lp), (lt.lp2hp, sig.lp2hp)):
        mb, ma_ = mine(b, a, 2.0)
        rb, ra = ref(b, a, 2.0)
        np.testing.assert_allclose(mb, rb, atol=1e-12)
        np.testing.assert_allclose(ma_, ra, atol=1e-12)
    for mine, ref in ((lt.lp2bp, sig.lp2bp), (lt.lp2bs, sig.lp2bs)):
        mb, ma_ = mine(b, a, 2.0, 0.5)
        rb, ra = ref(b, a, 2.0, 0.5)
        np.testing.assert_allclose(mb, rb, atol=1e-12)
        np.testing.assert_allclose(ma_, ra, atol=1e-12)
    _, _, k = lt.tf2zpk(b, a)
    _, _, k2 = sig.tf2zpk(b, a)
    assert np.allclose(k, k2) and isinstance(k, complex)


def test_analog_plumbing_matches_scipy():
    """Round 5: the scipy-named analog plumbing — *ap prototype aliases,
    findfreqs grids, abcd_normalize shape inference."""
    from simpledsp_jax.design import ltisys as lt
    from simpledsp_jax.design.iir import (besselap, buttap, cheb1ap,
                                          cheb2ap, ellipap)
    for mine, ref, args in ((buttap, sig.buttap, (4,)),
                            (cheb1ap, sig.cheb1ap, (4, 1.0)),
                            (cheb2ap, sig.cheb2ap, (4, 30.0)),
                            (ellipap, sig.ellipap, (4, 1.0, 40.0)),
                            (besselap, sig.besselap, (5,))):
        z1, p1, k1 = mine(*args)
        z2, p2, k2 = ref(*args)
        np.testing.assert_allclose(np.sort_complex(np.atleast_1d(z1)),
                                   np.sort_complex(np.atleast_1d(z2)),
                                   atol=1e-12)
        np.testing.assert_allclose(np.sort_complex(p1),
                                   np.sort_complex(p2), atol=1e-12)
        assert abs(k1 - k2) < 1e-12
    num = np.real(np.poly([-3.0, -30.0]))
    rng = np.random.default_rng(0)
    for _ in range(4):
        r = (-np.abs(rng.uniform(0.01, 1000, 3))
             + 1j * rng.uniform(0, 50, 3))
        den = np.real(np.poly(np.concatenate([r, np.conj(r)])))
        np.testing.assert_allclose(lt.findfreqs(num, den, 27),
                                   sig.findfreqs(num, den, 27),
                                   rtol=1e-10)
    np.testing.assert_allclose(
        lt.findfreqs([-1 + 4j], [-2 + 1j, -5], 15, kind="zp"),
        sig.findfreqs([-1 + 4j], [-2 + 1j, -5], 15, kind="zp"),
        rtol=1e-10)
    with pytest.raises(ValueError):
        lt.findfreqs([1.0], [1.0], 5, kind="nope")
    for kw in (dict(A=[[1, 2], [3, 4]], B=[[5], [6]], D=[[7]]),
               dict(B=[[1], [2]], C=[[3, 4]]),
               dict(A=[[1]], C=[[2]], D=[[3]])):
        for m1, m2 in zip(lt.abcd_normalize(**kw),
                          sig.abcd_normalize(**kw)):
            assert np.asarray(m1).shape == np.asarray(m2).shape
            np.testing.assert_allclose(np.asarray(m1), np.asarray(m2))
    with pytest.raises(ValueError):
        lt.abcd_normalize(D=[[1]])
    with pytest.raises(ValueError):
        lt.abcd_normalize(A=[[1]], B=[[1]], C=[[1]], D=[[1, 2]])


def test_band_stop_obj_matches_scipy():
    """Round 5: the public band-stop order objective (the function the
    *ord selectors minimize for band-stop designs)."""
    from simpledsp_jax.design.iir import band_stop_obj
    passb = np.array([0.8, 2.2])
    stopb = np.array([1.0, 2.0])
    for wp, ind in ((0.9, 0), (2.1, 1), (0.85, 0)):
        for t in ("butter", "cheby", "ellip"):
            got = band_stop_obj(wp, ind, passb, stopb, 1.0, 40.0, t)
            ref = sig.band_stop_obj(wp, ind, passb.copy(), stopb, 1.0,
                                    40.0, t)
            assert np.allclose(got, ref, rtol=1e-12)
    with pytest.raises(ValueError):
        band_stop_obj(0.9, 0, passb, stopb, 1.0, 40.0, "nope")
    with pytest.raises(ValueError):
        band_stop_obj(0.9, 0, passb, stopb, 40.0, 1.0, "butter")
