"""Pulse-Doppler radar model family (models/radar.py): matched filter,
range-Doppler map, CA-CFAR — validated against brute-force numpy."""

import numpy as np
import pytest

import jax.numpy as jnp

from simpledsp_jax.models.radar import (cfar_ca, lfm_chirp,
                                        matched_filter_ri,
                                        range_doppler_map)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def synth_pulses(rng, n_pulses, n_samples, targets, tx, noise=0.01):
    """targets: list of (delay_bin, doppler_cycles_per_pulse, amp)."""
    txc = tx[0] + 1j * tx[1]
    x = noise * (rng.standard_normal((n_pulses, n_samples))
                 + 1j * rng.standard_normal((n_pulses, n_samples)))
    k = np.arange(n_pulses)[:, None]
    for delay, fd, amp in targets:
        echo = np.zeros(n_samples, dtype=np.complex128)
        echo[delay: delay + txc.size] = amp * txc
        x = x + echo[None, :] * np.exp(2j * np.pi * fd * k)
    return x


class TestMatchedFilter:
    def test_peak_at_delay_with_compression_gain(self, rng):
        tx = lfm_chirp(64, 0.8)
        x = synth_pulses(rng, 1, 512, [(100, 0.0, 1.0)], tx, noise=0.0)[0]
        yr, yi = matched_filter_ri(jnp.asarray(x.real), jnp.asarray(x.imag),
                                   *tx)
        mag = np.abs(np.asarray(yr) + 1j * np.asarray(yi))
        assert mag.argmax() == 100
        # Compression gain: |peak| == sum |tx|^2 == L for unit amplitude.
        np.testing.assert_allclose(mag.max(), 64.0, rtol=1e-5)

    def test_matches_numpy_correlation(self, rng):
        tx = lfm_chirp(32, 0.5)
        txc = tx[0] + 1j * tx[1]
        x = (rng.standard_normal((3, 200))
             + 1j * rng.standard_normal((3, 200)))
        yr, yi = matched_filter_ri(jnp.asarray(x.real), jnp.asarray(x.imag),
                                   *tx)
        got = np.asarray(yr) + 1j * np.asarray(yi)
        xp = np.pad(x, [(0, 0), (0, 31)])
        want = np.stack([
            np.correlate(xp[i], txc, mode="valid") for i in range(3)])
        np.testing.assert_allclose(got, want, atol=1e-8)

    def test_rejects_long_tx(self, rng):
        tx = lfm_chirp(64, 0.5)
        with pytest.raises(ValueError):
            matched_filter_ri(jnp.zeros(32), jnp.zeros(32), *tx)
        with pytest.raises(ValueError):
            lfm_chirp(64, 1.5)


class TestRangeDoppler:
    def test_targets_land_on_expected_bins(self, rng):
        n_pulses, n_samples = 64, 512
        tx = lfm_chirp(64, 0.8)
        # Doppler bin b corresponds to fd = b / n_pulses cycles/pulse.
        targets = [(100, 8.0 / n_pulses, 1.0), (300, -12.0 / n_pulses, 0.7)]
        x = synth_pulses(rng, n_pulses, n_samples, targets, tx)
        rd = np.asarray(range_doppler_map(jnp.asarray(x.real),
                                          jnp.asarray(x.imag), *tx))
        assert rd.shape == (n_pulses, n_samples)
        # fftshifted: doppler bin b sits at row n_pulses//2 + b.
        for delay, fd, _ in targets:
            b = int(round(fd * n_pulses))
            row, col = np.unravel_index(
                np.argmax(rd[:, delay - 2: delay + 3]),
                rd[:, delay - 2: delay + 3].shape)
            assert row == n_pulses // 2 + b
            assert col == 2  # peak centered on the true delay

    def test_batched_leading_axis(self, rng):
        tx = lfm_chirp(16, 0.6)
        x = (rng.standard_normal((2, 8, 128))
             + 1j * rng.standard_normal((2, 8, 128)))
        rd = np.asarray(range_doppler_map(jnp.asarray(x.real),
                                          jnp.asarray(x.imag), *tx))
        for i in range(2):
            one = np.asarray(range_doppler_map(jnp.asarray(x[i].real),
                                               jnp.asarray(x[i].imag), *tx))
            np.testing.assert_allclose(rd[i], one, rtol=1e-6, atol=1e-8)


class TestCFAR:
    def test_matches_bruteforce_and_detects_targets(self, rng):
        n_pulses, n_samples = 64, 512
        tx = lfm_chirp(64, 0.8)
        targets = [(100, 8.0 / n_pulses, 1.0), (300, -12.0 / n_pulses, 0.7)]
        x = synth_pulses(rng, n_pulses, n_samples, targets, tx, noise=0.05)
        rd = np.asarray(range_doppler_map(jnp.asarray(x.real),
                                          jnp.asarray(x.imag), *tx))
        guard, train, pfa = 3, 10, 1e-5
        det, thresh = cfar_ca(jnp.asarray(rd), guard=guard, train=train,
                              pfa=pfa)
        det = np.asarray(det)
        # Brute-force reference with wrap-around training cells.
        n_train = 2 * train
        alpha = n_train * (pfa ** (-1.0 / n_train) - 1.0)
        want = np.zeros_like(det)
        for r in range(n_samples):
            idx = np.concatenate([
                (r + np.arange(guard + 1, guard + train + 1)) % n_samples,
                (r - np.arange(guard + 1, guard + train + 1)) % n_samples])
            noise = rd[:, idx].mean(axis=1)
            want[:, r] = rd[:, r] > alpha * noise
        np.testing.assert_array_equal(det, want)
        # Both targets detected at their bins.
        for delay, fd, _ in targets:
            b = n_pulses // 2 + int(round(fd * n_pulses))
            assert det[b, delay]
        # False alarms stay near the design rate.
        assert det.sum() <= det.size * pfa * 50 + 2 * 9

    def test_rejects_bad_args(self, rng):
        p = jnp.asarray(rng.standard_normal((4, 32)) ** 2)
        with pytest.raises(ValueError):
            cfar_ca(p, guard=8, train=9)      # window exceeds axis
        with pytest.raises(ValueError):
            cfar_ca(p, train=0)
        with pytest.raises(ValueError):
            cfar_ca(p, pfa=0.0)
