"""General IIR design validation (design.iir) against scipy.signal.

Extends the reference's design-validation methodology (golden responses
from an independent implementation — reference: test/testIIR.cpp:30-59)
to the full classical family set: Butterworth / Chebyshev I / II /
elliptic / Bessel across all four band types and both parities of order,
plus order selection and the notch/peak/comb one-liners.
"""

import numpy as np
import pytest
import scipy.signal as sig

import jax.numpy as jnp

from simpledsp_jax.design import iir as dz
from simpledsp_jax.ops.iir import sosfilt


def impulse_response(sos, n=4096):
    x = np.zeros(n)
    x[0] = 1.0
    return sig.sosfilt(np.atleast_2d(np.asarray(sos, dtype=np.float64)), x)


def assert_sos_parity(ours, theirs, tol):
    err = np.max(np.abs(impulse_response(ours) - impulse_response(theirs)))
    assert err < tol, f"impulse-response deviation {err:.3e} >= {tol:g}"


ORDERS = [1, 2, 3, 5, 8]
BANDS = [("lowpass", 0.3), ("highpass", 0.45),
         ("bandpass", (0.2, 0.5)), ("bandstop", (0.2, 0.5))]


@pytest.mark.parametrize("n", ORDERS)
@pytest.mark.parametrize("btype,wn", BANDS)
def test_butter_matches_scipy(n, btype, wn):
    ours = dz.butter(n, wn, btype=btype, output="sos")
    theirs = sig.butter(n, np.atleast_1d(wn), btype=btype, output="sos")
    assert_sos_parity(ours, theirs, 1e-12)


@pytest.mark.parametrize("n", [2, 3, 7])
@pytest.mark.parametrize("btype,wn", BANDS)
def test_cheby1_matches_scipy(n, btype, wn):
    ours = dz.cheby1(n, 0.8, wn, btype=btype, output="sos")
    theirs = sig.cheby1(n, 0.8, np.atleast_1d(wn), btype=btype,
                        output="sos")
    assert_sos_parity(ours, theirs, 1e-12)


@pytest.mark.parametrize("n", [2, 3, 7])
@pytest.mark.parametrize("btype,wn", BANDS)
def test_cheby2_matches_scipy(n, btype, wn):
    ours = dz.cheby2(n, 42.0, wn, btype=btype, output="sos")
    theirs = sig.cheby2(n, 42.0, np.atleast_1d(wn), btype=btype,
                        output="sos")
    assert_sos_parity(ours, theirs, 1e-12)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8])
@pytest.mark.parametrize("btype,wn", BANDS)
def test_ellip_matches_scipy(n, btype, wn):
    """The elliptic prototype solves the degree equation exactly (Landen
    form); scipy solves it by numerical optimization — both land on the
    same unique solution, so responses agree to ~1e-13."""
    ours = dz.ellip(n, 0.7, 45.0, wn, btype=btype, output="sos")
    theirs = sig.ellip(n, 0.7, 45.0, np.atleast_1d(wn), btype=btype,
                       output="sos")
    assert_sos_parity(ours, theirs, 1e-9)


@pytest.mark.parametrize("norm", ["phase", "delay", "mag"])
@pytest.mark.parametrize("n", [1, 2, 4, 7, 10])
def test_bessel_matches_scipy(norm, n):
    ours = dz.bessel(n, 0.3, norm=norm, output="sos")
    theirs = sig.bessel(n, 0.3, norm=norm, output="sos")
    assert_sos_parity(ours, theirs, 1e-9)


def test_bessel_bandpass():
    ours = dz.bessel(4, (0.2, 0.6), btype="bandpass", output="sos")
    theirs = sig.bessel(4, [0.2, 0.6], btype="bandpass", output="sos")
    assert_sos_parity(ours, theirs, 1e-9)


def test_output_forms_consistent():
    z, p, k = dz.butter(5, 0.3, output="zpk")
    b, a = dz.butter(5, 0.3, output="ba")
    bs, as_ = sig.butter(5, 0.3)
    assert np.allclose(b, bs, atol=1e-12)
    assert np.allclose(a, as_, atol=1e-12)
    zs, ps, ks = sig.butter(5, 0.3, output="zpk")
    assert np.isclose(k, ks)
    assert np.allclose(np.sort_complex(p), np.sort_complex(ps), atol=1e-12)


def test_fs_parameterized():
    ours = dz.ellip(6, 1.0, 60.0, (3000.0, 8000.0), btype="bandpass",
                    fs=48000.0, output="sos")
    theirs = sig.ellip(6, 1.0, 60.0, [3000.0, 8000.0], btype="bandpass",
                       fs=48000.0, output="sos")
    assert_sos_parity(ours, theirs, 1e-9)


def test_design_runs_on_runtime():
    """End-to-end: an elliptic design produced here runs through the
    framework's own sosfilt and matches scipy.sosfilt in float64."""
    des = dz.ellip(7, 0.5, 55.0, 0.22)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(2048)
    y, _ = sosfilt(des, jnp.asarray(x, dtype=jnp.float64), method="scan")
    ref = sig.sosfilt(sig.ellip(7, 0.5, 55.0, 0.22, output="sos"), x)
    assert np.max(np.abs(np.asarray(y) - ref)) < 1e-9


# ---------------------------------------------------------------------------
# Order selection.
# ---------------------------------------------------------------------------

ORDER_SPECS = [
    (0.2, 0.3, 1.0, 40.0),
    (0.1, 0.5, 3.0, 60.0),
    (0.3, 0.2, 0.5, 50.0),               # highpass
    ([0.2, 0.5], [0.1, 0.6], 1.0, 40.0),  # bandpass
    ([0.1, 0.6], [0.2, 0.5], 1.0, 40.0),  # bandstop
]


@pytest.mark.parametrize("ours,theirs", [
    (dz.buttord, sig.buttord), (dz.cheb1ord, sig.cheb1ord),
    (dz.cheb2ord, sig.cheb2ord), (dz.ellipord, sig.ellipord)])
@pytest.mark.parametrize("wp,ws,gp,gs", ORDER_SPECS)
def test_order_selection_matches_scipy(ours, theirs, wp, ws, gp, gs):
    n1, wn1 = ours(wp, ws, gp, gs)
    n2, wn2 = theirs(wp, ws, gp, gs)
    assert n1 == n2
    # Band-stop wn comes out of a flat-optimum edge search; scipy's
    # optimizer and ours terminate within 1e-4 of each other there.
    assert np.allclose(np.atleast_1d(wn1), np.atleast_1d(wn2),
                       rtol=1e-4, atol=1e-6)


def test_selected_order_meets_spec():
    wp, ws, gp, gs = 3000.0, 5000.0, 1.0, 45.0
    n, wn = dz.buttord(wp, ws, gp, gs, fs=48000.0)
    sos = dz.butter(n, wn, fs=48000.0, output="sos")
    w, h = sig.sosfreqz(sos, worN=np.array([wp, ws]), fs=48000.0)
    atten = -20.0 * np.log10(np.abs(h))
    assert atten[0] <= gp + 1e-6
    assert atten[1] >= gs - 1e-6


# ---------------------------------------------------------------------------
# zpk2sos transfer-function invariance.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,btype,wn", [(7, "lowpass", 0.3),
                                        (4, "bandstop", (0.25, 0.6))])
def test_zpk2sos_transfer_invariant(n, btype, wn):
    """Our pairing differs from scipy's, but the cascade product must be
    the same transfer function."""
    z, p, k = dz.ellip(n, 1.0, 50.0, wn, btype=btype, output="zpk")
    sos = dz.zpk2sos(z, p, k)
    w = np.linspace(0.0, np.pi, 257)
    _, h_ours = sig.sosfreqz(sos, worN=w)
    zb = k * np.poly(z)
    _, h_zpk = sig.freqz(np.real(zb), np.real(np.poly(p)), worN=w)
    assert np.max(np.abs(h_ours - h_zpk)) < 1e-9


# ---------------------------------------------------------------------------
# Notch / peak / comb.
# ---------------------------------------------------------------------------

def test_iirnotch_matches_scipy():
    des = dz.iirnotch(1500.0, 30.0, fs=48000.0)
    from simpledsp_jax.design.biquad import sos_matrix
    b_sp, a_sp = sig.iirnotch(1500.0, 30.0, fs=48000.0)
    ours = impulse_response(sos_matrix(des))
    theirs = sig.lfilter(b_sp, a_sp, np.eye(1, 4096, 0)[0])
    assert np.max(np.abs(ours - theirs)) < 1e-12


def test_iirpeak_matches_scipy():
    des = dz.iirpeak(0.25 * 2, 12.0)  # scipy normalized w0 at fs=2
    from simpledsp_jax.design.biquad import sos_matrix
    b_sp, a_sp = sig.iirpeak(0.5, 12.0)
    ours = impulse_response(sos_matrix(des))
    theirs = sig.lfilter(b_sp, a_sp, np.eye(1, 4096, 0)[0])
    assert np.max(np.abs(ours - theirs)) < 1e-12


def test_iircomb_matches_scipy():
    for ftype in ("notch", "peak"):
        b, a = dz.iircomb(1000.0, 30.0, fs=8000.0, ftype=ftype)
        b_sp, a_sp = sig.iircomb(1000.0, 30.0, fs=8000.0, ftype=ftype)
        x = np.eye(1, 4096, 0)[0]
        ours = sig.lfilter(b, a, x)
        theirs = sig.lfilter(b_sp, a_sp, x)
        assert np.max(np.abs(ours - theirs)) < 1e-12, ftype


def test_invalid_args_raise():
    with pytest.raises(ValueError):
        dz.butter(0, 0.3)
    with pytest.raises(ValueError):
        dz.butter(4, 1.2)
    with pytest.raises(ValueError):
        dz.butter(4, (0.5, 0.2), btype="bandpass")
    with pytest.raises(ValueError):
        dz.cheby1(4, None, 0.3)  # missing ripple
    with pytest.raises(ValueError):
        dz.iirfilter(4, 0.3, ftype="nonsense")
    with pytest.raises(ValueError):
        dz.iirfilter(4, 0.3, btype="nonsense")


class TestGammatone:
    def test_matches_scipy_fir_and_iir(self):
        from simpledsp_jax.design.iir import gammatone
        for freq, fs in [(440.0, 16000.0), (1000.0, 44100.0), (0.3, 2.0)]:
            b1, a1 = gammatone(freq, "fir", fs=fs)
            b2, a2 = sig.gammatone(freq, "fir", fs=fs)
            np.testing.assert_allclose(b1, b2, atol=1e-15)
            np.testing.assert_allclose(a1, np.asarray(a2))
            b1, a1 = gammatone(freq, "iir", fs=fs)
            b2, a2 = sig.gammatone(freq, "iir", fs=fs)
            np.testing.assert_allclose(b1, np.asarray(b2), atol=1e-18)
            np.testing.assert_allclose(a1, np.asarray(a2), atol=1e-12)

    def test_unit_gain_at_center(self):
        from simpledsp_jax.design.iir import gammatone
        from simpledsp_jax.ops.lfilter import freqz
        b, a = gammatone(1000.0, "iir", fs=16000.0)
        w, h = freqz(b, a, 4096, fs=16000.0)
        assert abs(np.abs(h[np.argmin(np.abs(w - 1000.0))]) - 1.0) < 1e-3

    def test_bad_args(self):
        from simpledsp_jax.design.iir import gammatone
        with pytest.raises(ValueError):
            gammatone(0.0, "fir", fs=2.0)
        with pytest.raises(ValueError):
            gammatone(0.3, "cheby", fs=2.0)
        with pytest.raises(ValueError):
            gammatone(0.3, "fir", order=30, fs=2.0)


def test_gammatone_ftype_case_and_warnings():
    from simpledsp_jax.design.iir import gammatone
    b1, a1 = gammatone(440.0, "FIR", fs=16000.0)
    b2, a2 = gammatone(440.0, "fir", fs=16000.0)
    np.testing.assert_array_equal(b1, b2)
    with pytest.warns(UserWarning, match="order is not used"):
        gammatone(440.0, "iir", order=8, fs=16000.0)
    with pytest.warns(UserWarning, match="numtaps is not used"):
        gammatone(440.0, "Iir", numtaps=99, fs=16000.0)


def test_gammatone_star_export():
    import simpledsp_jax.design.iir as m
    assert "gammatone" in m.__all__
