"""Audio feature-extraction pipeline: mel spectrogram + MFCC.

A third model family (after the north-star chain and the SDR receiver
banks) demonstrating the transform layer as one fused matmul program: framed
STFT (matmul four-step FFT) -> power -> mel filterbank (one dense matmul)
-> log -> DCT-II (Makhoul rfft form).  Every stage is either a matmul
against a host-precomputed float64 table (the reference's compile-time
table economics, reference: include/sdsp/fft.h:264-265) or a fused
elementwise op — there is no per-frame Python and no gather/scatter, so
the whole feature extractor jits into a single XLA program, batched over
(..., channels) of arbitrary leading shape.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from simpledsp_jax.ops.spectral import istft_ri, stft_ri
from simpledsp_jax.ops.transforms import dct

__all__ = ["mel_filterbank", "MelSpectrogram", "mfcc", "griffin_lim"]


def _hz_to_mel(f):
    """HTK mel scale: m = 2595 log10(1 + f/700)."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(n_mels: int, nfft: int, fs: float,
                   fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """(n_mels, nfft//2 + 1) triangular mel filterbank, HTK convention
    (host-side float64 — a trace-time constant, applied as ONE matmul).

    Triangle m spans mel-uniform points [m, m+2] of the n_mels + 2 grid
    from fmin to fmax, peaking at 1 at point m + 1.
    """
    if fmax is None:
        fmax = fs / 2.0
    if not (0.0 <= fmin < fmax <= fs / 2.0 + 1e-9):
        raise ValueError(f"need 0 <= fmin < fmax <= fs/2, got "
                         f"({fmin}, {fmax}) @ fs={fs}")
    pts_hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                    n_mels + 2))
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    fb = np.zeros((n_mels, freqs.size))
    for m in range(n_mels):
        lo, mid, hi = pts_hz[m], pts_hz[m + 1], pts_hz[m + 2]
        up = (freqs - lo) / max(mid - lo, 1e-12)
        down = (hi - freqs) / max(hi - mid, 1e-12)
        fb[m] = np.clip(np.minimum(up, down), 0.0, None)
    return fb


class MelSpectrogram:
    """Framed power-spectrum -> mel-band energies, one jittable call.

    (..., T) real audio -> (..., nframes, n_mels); `log=True` returns
    natural-log energies (floored at `eps` to keep gradients/values
    finite).  The mel projection is a single (nbins, n_mels) matmul — the
    matmul form of the textbook per-triangle loop.
    """

    def __init__(self, nfft: int = 512, hop: Optional[int] = None,
                 n_mels: int = 64, fs: float = 16000.0, *,
                 fmin: float = 0.0, fmax: Optional[float] = None,
                 window: str = "hann", log: bool = True,
                 eps: float = 1e-10, dtype=jnp.float32):
        self.nfft = nfft
        self.hop = hop or nfft // 2
        self.n_mels = n_mels
        self.fs = fs
        self.window = window
        self.log = log
        self.eps = eps
        self.dtype = jnp.dtype(dtype)
        self._fbT = np.ascontiguousarray(
            mel_filterbank(n_mels, nfft, fs, fmin, fmax).T)

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        x = jnp.asarray(x, dtype=self.dtype)
        sr, si = stft_ri(x, self.nfft, hop=self.hop, window=self.window)
        power = sr * sr + si * si                    # (..., F, nbins)
        mel = jnp.dot(power, jnp.asarray(self._fbT, dtype=self.dtype),
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=self.dtype)
        if self.log:
            mel = jnp.log(jnp.maximum(mel, self.eps))
        return mel


def mfcc(x: jnp.ndarray, n_mfcc: int = 13, *, nfft: int = 512,
         hop: Optional[int] = None, n_mels: int = 64, fs: float = 16000.0,
         fmin: float = 0.0, fmax: Optional[float] = None,
         window: str = "hann", dtype=jnp.float32) -> jnp.ndarray:
    """Mel-frequency cepstral coefficients: (..., T) -> (..., F, n_mfcc).

    log-mel energies -> orthonormal DCT-II over the mel axis, keeping the
    first n_mfcc coefficients (the standard HTK-style pipeline).
    """
    if n_mfcc > n_mels:
        raise ValueError(f"n_mfcc={n_mfcc} exceeds n_mels={n_mels}")
    mel = MelSpectrogram(nfft, hop, n_mels, fs, fmin=fmin, fmax=fmax,
                         window=window, log=True, dtype=dtype)(x)
    return dct(mel, type=2, norm="ortho")[..., :n_mfcc]


def griffin_lim(mag: jnp.ndarray, *, nfft: Optional[int] = None,
                hop: Optional[int] = None, window: str = "hann",
                n_iter: int = 50, momentum: float = 0.99,
                length: Optional[int] = None) -> jnp.ndarray:
    """Griffin-Lim phase reconstruction: magnitude spectrogram
    (..., nframes, nfft//2 + 1) -> real signal.

    The fast-GL accelerated iteration (momentum extrapolation before the
    magnitude projection; momentum=0 recovers classic Griffin-Lim 1984):
    alternate istft (least-squares weighted-OLA inverse) and stft, keep
    the rebuilt phase, re-impose the target magnitude.  Entirely in the
    framework's RI planes — no complex dtypes, no angle/exp calls (the
    phase is carried as a unit vector renormalized by rsqrt) — and the
    whole n_iter loop is ONE jittable `lax.fori_loop` program whose
    stft/istft bodies are the direct windowed-DFT matmul routes.
    ``length`` crops the output signal (librosa semantics).
    """
    mag = jnp.asarray(mag)
    nbins = mag.shape[-1]
    nfft = int(nfft or 2 * (nbins - 1))
    if nfft // 2 + 1 != nbins:
        raise ValueError(f"mag has {nbins} bins, inconsistent with "
                         f"nfft={nfft}")
    hop = int(hop or nfft // 2)
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    eps = jnp.asarray(1e-16, mag.dtype)
    mom = float(momentum)

    def project(sr, si):
        y = istft_ri(sr, si, nfft, hop=hop, window=window)
        return stft_ri(y, nfft, hop=hop, window=window)

    def body(_, carry):
        sr, si, pr, pi = carry
        tr, ti = project(sr, si)
        er = tr + mom * (tr - pr)          # fast-GL extrapolation
        ei = ti + mom * (ti - pi)
        inv = jax.lax.rsqrt(er * er + ei * ei + eps)
        return mag * er * inv, mag * ei * inv, tr, ti

    zeros = jnp.zeros_like(mag)
    sr, si, _, _ = jax.lax.fori_loop(
        0, int(n_iter), body, (mag, zeros, mag, zeros))
    y = istft_ri(sr, si, nfft, hop=hop, window=window)
    return y if length is None else y[..., :length]


def _mel_bin_of_hz(f: float, n_mels: int, fs: float, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> int:
    """Index of the mel band whose peak is nearest f (test/debug helper)."""
    if fmax is None:
        fmax = fs / 2.0
    pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                 n_mels + 2))
    return int(np.argmin(np.abs(pts[1:-1] - f)))
