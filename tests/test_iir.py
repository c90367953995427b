"""IIR op tests — ports the reference's test methodology (SURVEY.md §4):

1. golden impulse responses vs an independent implementation
   (scipy sosfilt here; Octave sosfilt in the reference, testIIR.cpp:30-59)
2. blockwise == whole-signal processing, bit-exact (testIIR.cpp:61-75)
3. gain linearity (testIIR.cpp:79-171)
4. steady-state preload (testIIR.cpp:173-218)
5. fast-path (BlockIIR) parity with the scan oracle, incl. float32 SNR.
"""

import numpy as np
import pytest
import scipy.signal as sig

import jax.numpy as jnp

from simpledsp_jax.design import (
    design_bandpass,
    design_bandstop,
    design_highpass,
    design_lowpass,
    sos_matrix,
)
from simpledsp_jax.ops.iir import (
    BlockIIR,
    coeffs_from_design,
    iir_init,
    iir_preload,
    sosfilt,
    sosfilt_scan,
)

FS = 39000.0
CONFIGS = [(200.0, 1.4), (2000.0, 0.8), (15000.0, 2.0)]
M = 4
N = 1000


def all_designs():
    out = []
    for f0, q in CONFIGS:
        out.append(("lp", design_lowpass(M, f0, FS)))
        out.append(("hp", design_highpass(M, f0, FS)))
        out.append(("bp", design_bandpass(M, f0, FS, q)))
    out.append(("bs", design_bandstop(M, 2000.0, FS, 0.8)))
    return out


DESIGNS = all_designs()
IDS = [f"{k}-{d.f0:g}" for k, d in DESIGNS]


def scan_filter(design, x, state=None, dtype=jnp.float64):
    coeffs = coeffs_from_design(design, dtype=dtype)
    if state is None:
        state = iir_init(design.nsections, x.shape[:-1], dtype=dtype)
    y, st = sosfilt_scan(coeffs, jnp.asarray(x, dtype=dtype), state)
    return np.asarray(y), st


@pytest.mark.parametrize("kind,design", DESIGNS, ids=IDS)
def test_impulse_response_golden(kind, design):
    """Scan oracle matches scipy sosfilt to the reference's 1e-12 bound."""
    x = np.zeros(N)
    x[0] = 1.0
    golden = sig.sosfilt(sos_matrix(design), x)
    ours, _ = scan_filter(design, x)
    assert np.max(np.abs(ours - golden)) < 1e-12


@pytest.mark.parametrize("kind,design", DESIGNS, ids=IDS)
def test_block_processing_bit_exact(kind, design):
    """32-sample blockwise == whole-signal, bit-exact (testIIR.cpp:61-75)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(N)
    whole, _ = scan_filter(design, x)

    state = iir_init(design.nsections, dtype=jnp.float64)
    coeffs = coeffs_from_design(design, dtype=jnp.float64)
    chunks = []
    for i in range(0, N, 32):
        y, state = sosfilt_scan(coeffs, jnp.asarray(x[i:i + 32]), state)
        chunks.append(np.asarray(y))
    blockwise = np.concatenate(chunks)
    assert np.array_equal(whole, blockwise)


@pytest.mark.parametrize("kind,design", DESIGNS[:3], ids=IDS[:3])
def test_blockiir_streaming_bit_exact(kind, design):
    """BlockIIR split at block-size multiples == one shot, bit-exact."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(1024)
    f = BlockIIR(design, block_size=128, dtype=jnp.float64)
    whole, _ = f(jnp.asarray(x))
    y1, st = f(jnp.asarray(x[:512]))
    y2, _ = f(jnp.asarray(x[512:]), st)
    split = np.concatenate([np.asarray(y1), np.asarray(y2)])
    assert np.array_equal(np.asarray(whole), split)


@pytest.mark.parametrize("kind,design", DESIGNS, ids=IDS)
def test_blockiir_matches_oracle_f64(kind, design):
    """Block state-space path == scan oracle in float64 (reassociation only)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(1000)  # deliberately not a block multiple
    oracle, st_o = scan_filter(design, x)
    f = BlockIIR(design, block_size=256, dtype=jnp.float64)
    y, st_b = f(jnp.asarray(x))
    assert np.max(np.abs(np.asarray(y) - oracle)) < 1e-11
    # Final states agree too (resume-equivalence).
    assert np.max(np.abs(np.asarray(st_b.y_hist) - np.asarray(st_o.y_hist))) < 1e-11


@pytest.mark.parametrize("kind,design", DESIGNS[:3], ids=IDS[:3])
def test_blockiir_f32_snr(kind, design):
    """float32 device path: SNR vs the float64 oracle must exceed 90 dB
    (the f32 analog of the reference's 1e-12 f64 gate, per SURVEY.md §7)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(4096)
    oracle, _ = scan_filter(design, x)
    f = BlockIIR(design, block_size=256, dtype=jnp.float32)
    y, _ = f(jnp.asarray(x, dtype=jnp.float32))
    err = np.asarray(y, dtype=np.float64) - oracle
    snr_db = 10 * np.log10(np.sum(oracle ** 2) / np.sum(err ** 2))
    assert snr_db > 90.0, f"SNR {snr_db:.1f} dB"


@pytest.mark.parametrize("kind,design",
                         [(k, d) for k, d in DESIGNS if k in ("lp", "hp", "bp")][:6],
                         ids=IDS[:6])
def test_gain_linearity(kind, design):
    """gain=2 output == 2 x gain=1 output (testIIR.cpp:79-171)."""
    import dataclasses
    rng = np.random.default_rng(5)
    x = rng.standard_normal(500)
    d2 = dataclasses.replace(design, gain=2.0 * design.gain)
    y1, _ = scan_filter(design, x)
    y2, _ = scan_filter(d2, x)
    assert np.max(np.abs(y2 - 2.0 * y1)) < 1e-12


@pytest.mark.parametrize("kind,design", DESIGNS, ids=IDS)
def test_preload_steady_state(kind, design):
    """After preload(v), constant-v input has zero transient: LP -> v,
    HP/BP -> 0, BS -> v (testIIR.cpp:173-218, extended to band-stop)."""
    v = 0.7
    state = iir_preload(design, v, dtype=jnp.float64)
    x = np.full(200, v)
    y, _ = scan_filter(design, x, state=state)
    expected = v * design.dc_gain() / design.gain * design.gain
    # dc_gain includes input gain; steady output = v * dc_gain.
    expected = v * design.dc_gain()
    assert np.max(np.abs(y - expected)) < 1e-12


def test_batched_channels():
    """Leading batch axes = independent channels (one filter instance per
    channel in the reference, testIIR.cpp:37)."""
    design = design_lowpass(M, 2000.0, FS)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 400))
    yb, _ = scan_filter(design, x)
    for i in range(3):
        for j in range(5):
            y1, _ = scan_filter(design, x[i, j])
            # XLA compiles different programs for different batch shapes, so
            # bit-exactness across shapes is not guaranteed (unlike blockwise
            # splits of the SAME program, test_block_consistency); require
            # float64-roundoff agreement instead.
            np.testing.assert_allclose(yb[i, j], y1, rtol=1e-11, atol=1e-14)


def test_sosfilt_convenience_paths_agree():
    design = design_highpass(M, 2000.0, FS)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal(2048))
    y_scan, _ = sosfilt(design, x, method="scan")
    y_block, _ = sosfilt(design, x, method="block", dtype=jnp.float64)
    assert np.max(np.abs(np.asarray(y_scan) - np.asarray(y_block))) < 1e-11


def test_sosfiltfilt_matches_scipy():
    """Zero-phase forward-backward cascade vs scipy.signal.sosfiltfilt
    (same padding + steady-state edge init), LP/HP/BP designs."""
    from simpledsp_jax.design import design_bandpass, design_lowpass
    from simpledsp_jax.design.biquad import sos_matrix
    from simpledsp_jax.ops.iir import sosfiltfilt

    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3000)) + 1.5
    for design in (design_lowpass(M, 2000.0, FS),
                   design_highpass(M, 2000.0, FS),
                   design_bandpass(M, 2000.0, FS, 1.4)):
        got = np.asarray(sosfiltfilt(design, jnp.asarray(x)))
        want = sig.sosfiltfilt(sos_matrix(design), x, axis=-1)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_sosfiltfilt_rejects_long_padlen():
    from simpledsp_jax.design import design_lowpass
    from simpledsp_jax.ops.iir import sosfiltfilt

    design = design_lowpass(M, 2000.0, FS)
    with pytest.raises(ValueError):
        sosfiltfilt(design, jnp.asarray(np.ones(10)))


def test_sosfilt_zi_matches_scipy():
    import scipy.signal as sig

    from simpledsp_jax.ops.iir import sosfilt_zi
    for sos in (sig.butter(6, 0.3, output="sos"),
                sig.cheby1(5, 1.0, 0.2, output="sos"),
                sig.ellip(4, 0.5, 40.0, [0.2, 0.5], btype="bandpass",
                          output="sos")):
        np.testing.assert_allclose(sosfilt_zi(sos), sig.sosfilt_zi(sos),
                                   atol=1e-13)
    with pytest.raises(ValueError):
        sosfilt_zi(np.zeros((2, 5)))
