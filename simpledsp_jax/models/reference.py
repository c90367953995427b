"""Float64 numpy/scipy references of the models.

Each reference computes what a model computes by the textbook route —
``scipy.signal.sosfilt`` and ``numpy.fft.rfft`` for the north-star chain,
one modulated low-pass per channel through ``scipy.signal.upfirdn`` for the
receiver banks — independent of the block-state-space IIR, the four-step
matmul FFT and the masked polyphase convolution under test.  The tests,
``bench.py`` and ``chip_smoke.py`` compare against them.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sig

from simpledsp_jax.design.biquad import BiquadCascadeDesign, sos_matrix
from simpledsp_jax.design.fir import pfb_prototype_taps
from simpledsp_jax.models.sdr import audio_decimator_taps

__all__ = ["snr_db", "chain_spectra", "bank_audio"]


def snr_db(got, ref) -> float:
    """10 log10(|ref|^2 / |got - ref|^2) over all elements, in dB; inf
    when the two are equal."""
    ref = np.asarray(ref)
    err = float(np.sum(np.abs(np.asarray(got) - ref) ** 2))
    if err == 0.0:
        return float("inf")
    return float(10.0 * np.log10(np.sum(np.abs(ref) ** 2) / err))


def chain_spectra(design: BiquadCascadeDesign, x,
                  fft_size: int) -> np.ndarray:
    """Packed one-sided spectra of the north-star chain from a zero state:
    (C, T) real -> (C, T // fft_size, fft_size // 2) complex128, with the
    (real) Nyquist bin in the imaginary part of bin 0 — the layout of
    ``NorthStarChain``'s (spec_re, spec_im) planes."""
    y = sig.sosfilt(sos_matrix(design), np.asarray(x, np.float64), axis=-1)
    full = np.fft.rfft(y.reshape(y.shape[0], -1, fft_size))
    packed = full[..., :-1].copy()
    packed[..., 0] = full[..., 0].real + 1j * full[..., -1].real
    return packed


def bank_audio(x, num_channels: int, decim: int, *,
               fm_gain: float | None = None, remove_dc: bool = False,
               calls: int = 1, taps_per_channel: int = 16,
               audio_taps: int = 64, design: str = "kaiser") -> np.ndarray:
    """Audio of a receiver bank fed x (B, T) complex from a zero state:
    (B, M, T // M // decim) float64.

    Channel c is the prototype low-pass modulated to +c fs/M, sampled at
    every M-th input; FM (``fm_gain`` given) takes
    ``fm_gain * angle(y[n] conj(y[n-1]))`` with y[-1] = 1, AM the envelope,
    less each call's mean when ``remove_dc`` (the stream arriving in
    ``calls`` equal calls).  The audio decimator is the FIR low-pass
    sampled at every ``decim``-th output."""
    x = np.asarray(x, np.complex128)
    m = int(num_channels)
    b, t = x.shape
    g = t // m
    h = pfb_prototype_taps(m, taps_per_channel, design=design)
    k = np.arange(h.size)
    ataps = audio_decimator_taps(audio_taps, decim, design)
    audio = np.empty((b, m, g // decim))
    for c in range(m):
        hc = h * np.exp(2j * np.pi * c * k / m)
        for i in range(b):
            y = sig.upfirdn(hc, x[i], 1, m)[:g]
            if fm_gain is not None:
                prev = np.concatenate([[1.0 + 0j], y[:-1]])
                det = fm_gain * np.angle(y * np.conj(prev))
            else:
                det = np.abs(y)
                if remove_dc:
                    blocks = det.reshape(calls, -1)
                    det = (blocks - blocks.mean(axis=-1,
                                                keepdims=True)).ravel()
            audio[i, c] = sig.upfirdn(ataps, det, 1, decim)[: g // decim]
    return audio
