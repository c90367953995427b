"""Tests for parity utilities: int math, golden CSV fixtures, checkpointing."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig

from simpledsp_jax.design.biquad import (
    FilterType,
    bp_cutoff_freqs,
    design_bandpass,
    sos_matrix,
)
from simpledsp_jax.utils.checkpoint import load_state, save_state
from simpledsp_jax.utils.fixtures import (
    REFERENCE_CASES,
    REFERENCE_FS,
    generate_golden_fixtures,
    read_fixture,
    write_fixture,
)
from simpledsp_jax.utils.intmath import (
    ilog2,
    ilog4,
    is_power_of_2,
    is_power_of_4,
)


class TestIntMath:
    def test_matches_reference_semantics(self):
        # reference: include/sdsp/fft.h:12-43
        assert ilog2(1) == 0 and ilog2(1024) == 10
        assert ilog4(16) == 2 and ilog4(64) == 3
        assert is_power_of_2(4096) and not is_power_of_2(4095)
        assert is_power_of_4(2048) is False and is_power_of_4(4096) is True
        assert not is_power_of_2(0)

    def test_ilog2_rejects_nonpositive(self):
        with pytest.raises(ValueError):
            ilog2(0)


class TestBPCutoff:
    def test_bandwidth_and_warped_centering(self):
        f0, q, fs = 2000.0, 0.8, 39000.0
        f1, f2 = bp_cutoff_freqs(f0, q, fs)
        assert abs((f2 - f1) - f0 / q) < 1e-9
        t = np.tan(np.pi * np.array([f1, f0, f2]) / fs)
        assert abs(t[0] * t[2] - t[1] ** 2) < 1e-12

    def test_minus_3db_at_edges(self):
        """The designed band-pass is ~-3 dB at the computed edges."""
        f0, q, fs = 2000.0, 0.8, 39000.0
        f1, f2 = bp_cutoff_freqs(f0, q, fs)
        design = design_bandpass(4, f0, fs, q)
        w, h = sig.sosfreqz(sos_matrix(design), worN=[f1, f0, f2], fs=fs)
        db = 20 * np.log10(np.abs(h))
        assert abs(db[1]) < 0.1          # ~0 dB at center
        assert abs(db[0] + 3.01) < 0.2   # -3 dB edges
        assert abs(db[2] + 3.01) < 0.2


class TestFixtures:
    def test_roundtrip(self, tmp_path, rng):
        from simpledsp_jax.utils.fixtures import ImpulseFixture
        fx = ImpulseFixture(FilterType.low_pass, 39000.0, 200.0, 1.4,
                            rng.standard_normal(100))
        p = tmp_path / "LPimpulse.csv"
        write_fixture(p, fx)
        back = read_fixture(p)
        assert back.ftype == fx.ftype and back.fs == fx.fs
        np.testing.assert_array_equal(back.response, fx.response)

    def test_generate_golden_set(self, tmp_path):
        paths = generate_golden_fixtures(tmp_path)
        assert len(paths) == 9  # LP/HP/BP x 3 cases, like the reference
        fx = read_fixture(tmp_path / "LPimpulse.csv")
        assert fx.fs == REFERENCE_FS and fx.response.size == 1000

    def test_golden_fixtures_validate_our_designs(self, tmp_path):
        """The regenerated fixtures must match our closed-form designs to
        the reference's 1e-12 gate (reference: testIIR.cpp:59) for LP/HP."""
        from simpledsp_jax.design.biquad import design_highpass, design_lowpass
        generate_golden_fixtures(tmp_path)
        for name, designer in [("LPimpulse", design_lowpass),
                               ("HPimpulse", design_highpass)]:
            for i, (f0, q) in enumerate(REFERENCE_CASES):
                suffix = "" if i == 0 else str(i + 1)
                fx = read_fixture(tmp_path / f"{name}{suffix}.csv")
                design = designer(4, fx.f0, fx.fs)
                x = np.zeros(1000)
                x[0] = 1.0
                y = sig.sosfilt(sos_matrix(design), x)
                assert np.abs(y - fx.response).max() < 1e-12


class TestCheckpoint:
    def test_iir_state_roundtrip(self, tmp_path, rng):
        from simpledsp_jax.ops.iir import IIRState, iir_init
        state = IIRState(jnp.asarray(rng.standard_normal((3, 5, 2))))
        p = tmp_path / "state.npz"
        save_state(p, state)
        back = load_state(p, iir_init(4, (3,), dtype=jnp.float64))
        np.testing.assert_allclose(np.asarray(back.y_hist),
                                   np.asarray(state.y_hist))

    def test_resume_equals_continuous(self, tmp_path, rng):
        """Checkpoint mid-stream, restore, continue: identical output —
        the reference's streaming contract through a file."""
        from simpledsp_jax.design.biquad import design_lowpass
        from simpledsp_jax.ops.iir import (
            coeffs_from_design, iir_init, sosfilt_scan)
        design = design_lowpass(4, 1000.0, 39000.0)
        coeffs = coeffs_from_design(design, dtype=jnp.float64)
        x = rng.standard_normal(600)
        s0 = iir_init(4, (), dtype=jnp.float64)
        y_all, _ = sosfilt_scan(coeffs, jnp.asarray(x), s0)

        y1, s_mid = sosfilt_scan(coeffs, jnp.asarray(x[:300]), s0)
        save_state(tmp_path / "mid.npz", s_mid)
        s_back = load_state(tmp_path / "mid.npz", s0)
        y2, _ = sosfilt_scan(coeffs, jnp.asarray(x[300:]), s_back)
        np.testing.assert_array_equal(
            np.asarray(jnp.concatenate([y1, y2])), np.asarray(y_all))

    def test_sdr_state_roundtrip(self, tmp_path):
        from simpledsp_jax.models.sdr import FMReceiverBank
        rx = FMReceiverBank(8, 256e3, decim=2)
        st = rx.init_state(2)
        p = tmp_path / "sdr.npz"
        save_state(p, st)
        back = load_state(p, rx.init_state(2))
        np.testing.assert_allclose(np.asarray(back.demod.prev_r),
                                   np.asarray(st.demod.prev_r))

    def test_leaf_count_mismatch_raises(self, tmp_path):
        from simpledsp_jax.ops.iir import iir_init
        save_state(tmp_path / "s.npz", iir_init(4, ()))
        with pytest.raises(ValueError):
            load_state(tmp_path / "s.npz", (iir_init(4, ()), iir_init(4, ())))


class TestDebug:
    def test_assert_stable_accepts_good_design(self):
        from simpledsp_jax.design.biquad import design_lowpass
        from simpledsp_jax.utils.debug import assert_stable, pole_radii
        d = design_lowpass(4, 2000.0, 39000.0)
        assert_stable(d)
        assert (pole_radii(d) < 1.0).all()

    def test_checked_catches_nan(self):
        import jax.numpy as jnp
        from jax.experimental import checkify
        from simpledsp_jax.utils.debug import checked

        def bad(x):
            return jnp.log(x)  # NaN for negative input

        f = checked(bad)
        f(jnp.asarray([1.0, 2.0]))  # fine
        with pytest.raises(checkify.JaxRuntimeError):
            f(jnp.asarray([-1.0]))
