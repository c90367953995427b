"""Audio feature pipeline tests (mel spectrogram, MFCC) — gated against an
independent pure-numpy implementation (same role as the golden fixtures,
SURVEY.md §4 category 3) plus physical tone-localization properties."""

import numpy as np
import pytest
import scipy.fft as sfft

import jax
import jax.numpy as jnp

from simpledsp_jax.models.audio import (
    MelSpectrogram, _mel_bin_of_hz, mel_filterbank, mfcc)

FS = 16000.0
NFFT = 512
NMELS = 40


def _numpy_logmel(x, nfft, hop, n_mels, fs):
    """Independent reference: numpy rfft + periodic hann + fb matmul."""
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(nfft) / nfft)
    nframes = (x.shape[-1] - nfft) // hop + 1
    frames = np.stack([x[..., i * hop: i * hop + nfft] * w
                       for i in range(nframes)], axis=-2)
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    fb = mel_filterbank(n_mels, nfft, fs)
    return np.log(np.maximum(spec @ fb.T, 1e-10))


class TestMelFilterbank:
    def test_shape_and_support(self):
        fb = mel_filterbank(NMELS, NFFT, FS)
        assert fb.shape == (NMELS, NFFT // 2 + 1)
        assert np.all(fb >= 0.0)
        # Every band has support; peaks are near 1 on the discrete grid.
        assert np.all(fb.max(axis=1) > 0.5)
        assert fb.max() <= 1.0 + 1e-12

    def test_band_centers_monotonic(self):
        fb = mel_filterbank(NMELS, NFFT, FS)
        centers = np.argmax(fb, axis=1)
        assert np.all(np.diff(centers) >= 0)

    def test_bad_range_rejected(self):
        with pytest.raises(ValueError):
            mel_filterbank(8, NFFT, FS, fmin=9000.0, fmax=8000.0)


class TestMelSpectrogram:
    def test_matches_numpy_reference(self, rng):
        x = rng.standard_normal((2, 4096))
        hop = NFFT // 2
        got = np.asarray(MelSpectrogram(NFFT, hop, NMELS, FS,
                                        dtype=jnp.float64)(jnp.asarray(x)))
        ref = _numpy_logmel(x, NFFT, hop, NMELS, FS)
        assert got.shape == ref.shape
        assert np.max(np.abs(got - ref)) < 1e-8

    def test_tone_lands_in_expected_band(self):
        f_tone = 1000.0
        t = np.arange(16000) / FS
        x = np.sin(2 * np.pi * f_tone * t)
        mel = np.asarray(MelSpectrogram(NFFT, None, NMELS, FS,
                                        log=False)(jnp.asarray(x)))
        band = int(np.argmax(mel.mean(axis=0)))
        assert abs(band - _mel_bin_of_hz(f_tone, NMELS, FS)) <= 1


class TestMFCC:
    def test_matches_reference_pipeline(self, rng):
        x = rng.standard_normal(8192)
        hop = NFFT // 2
        got = np.asarray(mfcc(jnp.asarray(x), 13, nfft=NFFT, hop=hop,
                              n_mels=NMELS, fs=FS, dtype=jnp.float64))
        logmel = _numpy_logmel(x, NFFT, hop, NMELS, FS)
        ref = sfft.dct(logmel, type=2, norm="ortho", axis=-1)[..., :13]
        assert got.shape == ref.shape
        assert np.max(np.abs(got - ref)) < 1e-8

    def test_batched_shape(self, rng):
        x = rng.standard_normal((3, 2, 4096))
        out = mfcc(jnp.asarray(x), 13, nfft=NFFT, n_mels=NMELS, fs=FS)
        nframes = (4096 - NFFT) // (NFFT // 2) + 1
        assert out.shape == (3, 2, nframes, 13)

    def test_too_many_coeffs_rejected(self, rng):
        with pytest.raises(ValueError):
            mfcc(jnp.asarray(rng.standard_normal(2048)), n_mfcc=99,
                 n_mels=40)


class TestGriffinLim:
    def test_spectral_convergence(self, rng):
        """The defining GL property: |stft(y)| approaches the target
        magnitude monotonically with iterations."""
        from simpledsp_jax.models.audio import griffin_lim
        from simpledsp_jax.ops.spectral import stft_ri
        t = np.arange(8192)
        x = np.sin(2 * np.pi * 0.03 * t) + 0.5 * np.sin(
            2 * np.pi * 0.11 * t + 1.0)
        sr, si = stft_ri(jnp.asarray(x), 512, hop=128)
        mag = jnp.hypot(sr, si)

        def err(n):
            y = griffin_lim(mag, nfft=512, hop=128, n_iter=n)
            yr, yi = stft_ri(y, 512, hop=128)
            m2 = jnp.hypot(yr, yi)
            return float(jnp.linalg.norm(m2 - mag) / jnp.linalg.norm(mag))

        e0, e5, e50 = err(0), err(5), err(50)
        assert e5 < e0 and e50 < e5
        assert e50 < 0.15

    def test_jit_shapes_and_args(self, rng):
        from simpledsp_jax.models.audio import griffin_lim
        mag = jnp.asarray(np.abs(rng.standard_normal((2, 9, 129))))
        y = jax.jit(lambda m: griffin_lim(m, hop=64, n_iter=3))(mag)
        assert y.shape == (2, (9 - 1) * 64 + 256)
        y2 = griffin_lim(mag, hop=64, n_iter=3, length=300)
        assert y2.shape == (2, 300)
        with pytest.raises(ValueError):
            griffin_lim(mag, nfft=512, n_iter=3)   # bins mismatch
        with pytest.raises(ValueError):
            griffin_lim(mag, n_iter=-1)
