"""Pulse-Doppler radar processing: matched filter, range-Doppler map,
CA-CFAR detection.

A fourth model family (after the north-star chain, the SDR receiver
banks, and the audio feature stack) exercising the framework's transform
layer on the classic radar pipeline:

    IQ pulses (..., n_pulses, n_samples)
      -> pulse compression   (matched filter vs the known TX waveform —
                              one frequency-domain product through the
                              four-step FFT engine)
      -> Doppler processing  (windowed FFT across the pulse axis)
      -> CA-CFAR             (cell-averaging constant-false-alarm-rate
                              detector; train-cell noise estimate via
                              shifted-add box sums, no gathers)

Everything is (re, im) float planes end to end (framework convention:
no complex dtype on the device) and jits into one program,
batched over arbitrary leading axes.  The reference has no radar
capability; this is net-new breadth built entirely on ops/ primitives
(citations per stage below).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from simpledsp_jax.ops import fft as _fft
from simpledsp_jax.ops.spectral import window_taps

__all__ = ["matched_filter_ri", "range_doppler_map", "cfar_ca",
           "lfm_chirp"]


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def lfm_chirp(n: int, bandwidth: float = 1.0
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Unit-amplitude baseband linear-FM pulse of ``n`` samples sweeping
    ``bandwidth`` of the sample rate, as host float64 (re, im) — the
    standard high-time-bandwidth TX waveform for pulse compression."""
    if not 0.0 < bandwidth <= 1.0:
        raise ValueError(f"bandwidth must be in (0, 1], got {bandwidth}")
    t = np.arange(n, dtype=np.float64)
    phase = np.pi * bandwidth * (t - n / 2.0) ** 2 / n
    return np.cos(phase), np.sin(phase)


@functools.lru_cache(maxsize=None)
def _tx_spectrum_f64(tx_bytes: bytes, length: int, nfft: int):
    """conj(FFT(tx, nfft)) as float64 (re, im) planes — a trace-time
    constant per waveform."""
    tx = np.frombuffer(tx_bytes, dtype=np.complex128)
    assert tx.size == length
    spec = np.conj(np.fft.fft(tx, nfft))
    return np.ascontiguousarray(spec.real), np.ascontiguousarray(spec.imag)


def matched_filter_ri(xr: jnp.ndarray, xi: jnp.ndarray,
                      tx_re, tx_im) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pulse compression: correlate each row of (..., n_samples) IQ with
    the known TX waveform (host-side taps).  Output bin r is the
    correlation at delay r (y[r] = sum_t x[t + r] conj(tx[t]), zero-padded
    linearly — no circular wrap), length n_samples, so a point target at
    delay d compresses to a peak of ~L at bin d (L = TX length).

    Runs as one frequency-domain product: pow2-padded FFT of x times the
    precomputed conj TX spectrum, inverse FFT (ops/fft.py four-step
    engine — all matmuls)."""
    n = xr.shape[-1]
    tx = np.asarray(tx_re, dtype=np.float64) \
        + 1j * np.asarray(tx_im, dtype=np.float64)
    if tx.ndim != 1:
        raise ValueError("TX waveform must be 1-D")
    length = tx.size
    if length > n:
        raise ValueError(f"TX length {length} exceeds pulse length {n}")
    m = _next_pow2(n + length - 1)
    hr64, hi64 = _tx_spectrum_f64(tx.tobytes(), length, m)
    pad = [(0, 0)] * (xr.ndim - 1) + [(0, m - n)]
    fr, fi = _fft.fft_ri(jnp.pad(xr, pad), jnp.pad(xi, pad))
    hr = jnp.asarray(hr64, dtype=xr.dtype)
    hi = jnp.asarray(hi64, dtype=xr.dtype)
    yr, yi = _fft.ifft_ri(fr * hr - fi * hi, fr * hi + fi * hr)
    return yr[..., :n], yi[..., :n]


def range_doppler_map(xr: jnp.ndarray, xi: jnp.ndarray, tx_re, tx_im, *,
                      window: str = "hann") -> jnp.ndarray:
    """(..., n_pulses, n_samples) IQ pulse train -> (..., n_pulses,
    n_samples) range-Doppler POWER map: pulse compression along samples,
    windowed FFT across pulses, Doppler axis fftshifted so zero velocity
    sits at row n_pulses//2.
    """
    if xr.ndim < 2:
        raise ValueError("need (..., n_pulses, n_samples) input")
    yr, yi = matched_filter_ri(xr, xi, tx_re, tx_im)
    n_pulses = yr.shape[-2]
    w = jnp.asarray(window_taps(window, n_pulses), dtype=yr.dtype)[:, None]
    # Doppler FFT across the pulse axis: swap pulses to the last axis for
    # the engine, swap back (one XLA transpose each way).
    dr, di = _fft.fft_ri(jnp.swapaxes(yr * w, -1, -2),
                         jnp.swapaxes(yi * w, -1, -2))
    dr = jnp.swapaxes(dr, -1, -2)
    di = jnp.swapaxes(di, -1, -2)
    power = dr * dr + di * di
    return jnp.roll(power, n_pulses // 2, axis=-2)


def cfar_ca(power: jnp.ndarray, *, guard: int = 2, train: int = 8,
            pfa: float = 1e-4,
            axis: int = -1) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Cell-averaging CFAR along ``axis``: for each cell, the noise level
    is the mean of 2*train training cells flanking a 2*guard+1 guard
    region; the detection threshold is alpha * noise with
    alpha = N (pfa^(-1/N) - 1), N = 2*train — the exact CA-CFAR constant
    for exponentially-distributed (square-law) noise power.

    Returns (detections bool mask, threshold map), same shape as
    ``power``.  Edges are handled by wrap-around (the Doppler axis is
    circular; for range it matches the standard ring-buffer CFAR) —
    implemented as 2*train shifted adds on a rolled array, no gathers.
    """
    if guard < 0 or train < 1:
        raise ValueError(f"need guard >= 0, train >= 1, got ({guard}, "
                         f"{train})")
    if not 0.0 < pfa < 1.0:
        raise ValueError(f"pfa must be in (0, 1), got {pfa}")
    n = power.shape[axis]
    span = guard + train
    if 2 * span + 1 > n:
        raise ValueError(f"CFAR window 2*(guard+train)+1 = {2 * span + 1} "
                         f"exceeds the axis length {n}")
    x = jnp.moveaxis(power, axis, -1)
    acc = jnp.zeros_like(x)
    for k in range(guard + 1, span + 1):
        acc = acc + jnp.roll(x, k, axis=-1) + jnp.roll(x, -k, axis=-1)
    n_train = 2 * train
    noise = acc / n_train
    alpha = n_train * (pfa ** (-1.0 / n_train) - 1.0)
    thresh = alpha * noise
    det = x > thresh
    return (jnp.moveaxis(det, -1, axis),
            jnp.moveaxis(thresh, -1, axis))
