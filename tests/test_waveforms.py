"""Waveform generator parity vs scipy.signal (ops/waveforms.py)."""

import numpy as np
import pytest
import scipy.signal as sig

import jax.numpy as jnp

from simpledsp_jax.ops.waveforms import (chirp, gausspulse, max_len_seq,
                                         sawtooth, square, sweep_poly,
                                         unit_impulse)


@pytest.fixture
def t():
    return np.linspace(0.0, 3.0, 4001)


@pytest.mark.parametrize("method", ["linear", "quadratic", "logarithmic",
                                    "hyperbolic"])
def test_chirp_matches_scipy(t, method):
    got = np.asarray(chirp(jnp.asarray(t), 5.0, 2.0, 40.0, method=method,
                           phi=30.0))
    want = sig.chirp(t, 5.0, 2.0, 40.0, method=method, phi=30.0)
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_chirp_equal_freqs_and_errors(t):
    for method in ("logarithmic", "hyperbolic"):
        got = np.asarray(chirp(jnp.asarray(t), 7.0, 2.0, 7.0, method=method))
        want = sig.chirp(t, 7.0, 2.0, 7.0, method=method)
        np.testing.assert_allclose(got, want, atol=1e-9)
    with pytest.raises(ValueError):
        chirp(jnp.asarray(t), -5.0, 2.0, 40.0, method="logarithmic")
    with pytest.raises(ValueError):
        chirp(jnp.asarray(t), 0.0, 2.0, 40.0, method="hyperbolic")
    with pytest.raises(ValueError):
        chirp(jnp.asarray(t), 5.0, 2.0, 40.0, method="cubic")


@pytest.mark.parametrize("duty", [0.5, 0.25, 0.9])
def test_square_matches_scipy(t, duty):
    w = 2 * np.pi * 3.0 * t
    got = np.asarray(square(jnp.asarray(w), duty))
    want = sig.square(w, duty)
    # Avoid the exact switching instants (float-boundary sensitive).
    mask = np.abs(got - want) > 0
    assert mask.mean() < 0.002
    np.testing.assert_allclose(got[~mask], want[~mask])


@pytest.mark.parametrize("width", [1.0, 0.5, 0.0, 0.3])
def test_sawtooth_matches_scipy(t, width):
    w = 2 * np.pi * 3.0 * t
    got = np.asarray(sawtooth(jnp.asarray(w), width))
    want = sig.sawtooth(w, width)
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_sawtooth_rejects_bad_width(t):
    with pytest.raises(ValueError):
        sawtooth(jnp.asarray(t), 1.5)


def test_gausspulse_matches_scipy():
    t = np.linspace(-0.01, 0.01, 2001)
    got = np.asarray(gausspulse(jnp.asarray(t), fc=1500.0, bw=0.6))
    want = sig.gausspulse(t, fc=1500.0, bw=0.6)
    np.testing.assert_allclose(got, want, atol=1e-9)
    gi, gq = gausspulse(jnp.asarray(t), fc=1500.0, bw=0.6, quadrature=True)
    wi, wq = sig.gausspulse(t, fc=1500.0, bw=0.6, retquad=True)
    np.testing.assert_allclose(np.asarray(gi), wi, atol=1e-9)
    np.testing.assert_allclose(np.asarray(gq), wq, atol=1e-9)
    for kwargs in ({"fc": -1.0}, {"bw": 0.0}, {"bwr": 3.0}):
        with pytest.raises(ValueError):
            gausspulse(jnp.asarray(t), **kwargs)


def test_unit_impulse_matches_scipy():
    np.testing.assert_array_equal(np.asarray(unit_impulse(7)),
                                  sig.unit_impulse(7))
    np.testing.assert_array_equal(np.asarray(unit_impulse(7, "mid")),
                                  sig.unit_impulse(7, "mid"))
    np.testing.assert_array_equal(np.asarray(unit_impulse((3, 4), 2)),
                                  sig.unit_impulse((3, 4), 2))
    np.testing.assert_array_equal(
        np.asarray(unit_impulse((3, 4), (1, 3))),
        sig.unit_impulse((3, 4), (1, 3)))


def test_sweep_poly_matches_scipy(t):
    p = np.poly1d([0.05, -0.75, 2.0, 1.0])
    got = np.asarray(sweep_poly(jnp.asarray(t), p, phi=25.0))
    want = sig.sweep_poly(t, p, phi=25.0)
    np.testing.assert_allclose(got, want, atol=1e-10)
    # plain list form
    got2 = np.asarray(sweep_poly(jnp.asarray(t), [1.0, 2.0]))
    np.testing.assert_allclose(got2, sig.sweep_poly(t, np.poly1d([1.0, 2.0])),
                               atol=1e-10)


@pytest.mark.parametrize("nbits", [4, 8, 12])
def test_max_len_seq_matches_scipy(nbits):
    ours, st = max_len_seq(nbits)
    ref, rst = sig.max_len_seq(nbits)
    np.testing.assert_array_equal(np.asarray(ours), ref)
    np.testing.assert_array_equal(st, rst)


def test_max_len_seq_streaming_and_flat_spectrum():
    a1, s1 = max_len_seq(8, length=100)
    a2, _ = max_len_seq(8, state=s1, length=155)
    full, _ = max_len_seq(8)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(a1), np.asarray(a2)]), np.asarray(full))
    # The defining MLS property: +-1 sequence has a flat spectrum.
    bip = 2.0 * np.asarray(full, dtype=np.float64) - 1.0
    mag = np.abs(np.fft.fft(bip))[1:]
    np.testing.assert_allclose(mag, np.full(mag.shape, mag[0]), rtol=1e-9)
    with pytest.raises(ValueError):
        max_len_seq(64)                        # no default taps
    with pytest.raises(ValueError):
        max_len_seq(8, state=np.zeros(8))      # all-zero state
