"""Spectral analysis conveniences built on the batched FFT engine.

Welch power-spectral-density estimation and spectrograms — the analysis
layer a user of the reference's FFT typically builds by hand (frame,
window, transform, average).  Windows are host-side float64 constants;
transforms run through ops/fft (the four-step matmul engine).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from simpledsp_jax.ops import fft as _fft

__all__ = ["spectrogram_ri", "welch_psd", "window_taps",
           "stft_ri", "istft_ri", "csd_ri", "coherence", "periodogram",
           "lombscargle", "check_COLA", "check_NOLA", "vectorstrength",
           "envelope", "envelope_ri", "stft_dual_window",
           "closest_STFT_dual_window"]


def _hop_fold(x: np.ndarray, hop: int) -> np.ndarray:
    """sum_k x shifted by every nonzero multiple of hop, added to x —
    the periodization that appears in every STFT dual-window identity."""
    out = x.copy()
    for k in range(hop, x.size, hop):
        out[k:] += x[:-k]
        out[:-k] += x[k:]
    return out


def stft_dual_window(win, hop: int) -> np.ndarray:
    """Canonical dual window of ``win`` at time step ``hop`` — the
    window the least-squares inverse STFT implicitly applies (the same
    weighted-OLA normalization istft_ri computes; host-side f64,
    scipy's ShortTimeFFT.dual_win semantics).  Raises if the STFT is
    not invertible (the hop-folded energy has zeros — the NOLA
    condition)."""
    win = np.asarray(win)
    if np.issubdtype(win.dtype, np.integer):
        raise ValueError("win cannot be of integer dtype")
    if not (isinstance(hop, (int, np.integer))
            and 1 <= hop <= win.size):
        raise ValueError(f"hop={hop} must be an integer in "
                         f"[1, len(win)={win.size}]")
    dd = _hop_fold(win.real ** 2 + win.imag ** 2, hop)
    if not np.all(dd >= np.finfo(win.dtype).resolution * dd.max()):
        raise ValueError("STFT not invertible for this (win, hop) "
                         "(NOLA violated)")
    return win / dd


def closest_STFT_dual_window(win, hop: int, desired_dual=None, *,
                             scaled: bool = True):
    """The valid STFT dual window closest to ``desired_dual``
    (scipy.signal.closest_STFT_dual_window semantics): minimizes
    ``|dual - desired|^2`` (or ``|dual - alpha desired|^2`` over alpha
    when ``scaled``) subject to the window-duality constraint.  Returns
    ``(dual_win, alpha)``."""
    win = np.asarray(win)
    desired = np.ones_like(win) if desired_dual is None \
        else np.asarray(desired_dual)
    if win.ndim != 1 or win.shape != desired.shape:
        raise ValueError("win and desired_dual must be equal-length 1-D")
    if not (np.all(np.isfinite(win)) and np.all(np.isfinite(desired))):
        raise ValueError("win and desired_dual must be finite")
    if not (isinstance(hop, (int, np.integer))
            and 1 <= hop <= win.size):
        raise ValueError(f"hop={hop} must be an integer in "
                         f"[1, len(win)={win.size}]")
    w_d = stft_dual_window(win, hop)
    # Projection of `desired` onto the duality-constraint manifold.
    q_d = w_d * _hop_fold(np.conjugate(win) * desired, hop)
    if not scaled:
        return w_d + desired - q_d, 1.0
    num = np.conjugate(q_d) @ w_d
    den = q_d.real @ q_d.real + q_d.imag @ q_d.imag
    if not (abs(num) > 0 and den > np.finfo(w_d.dtype).resolution):
        raise ValueError("scaled closest dual window is numerically "
                         "unstable; try scaled=False")
    alpha = num / den
    return w_d + alpha * (desired - q_d), alpha


def check_COLA(window, nperseg: int, noverlap: int,
               tol: float = 1e-10) -> bool:
    """Constant-OverLap-Add check (scipy.signal.check_COLA semantics):
    do the shifted windows sum to a constant?  Host-side f64; the
    condition under which plain (unweighted) overlap-add inverts an
    STFT exactly.  (The framework's istft_ri uses the least-squares
    weighted-OLA inverse, which needs only the weaker NOLA condition.)"""
    nperseg = int(nperseg)
    noverlap = int(noverlap)
    if nperseg < 1 or not 0 <= noverlap < nperseg:
        raise ValueError(f"need 0 <= noverlap < nperseg, got "
                         f"{noverlap}/{nperseg}")
    w = window_taps(window, nperseg)
    step = nperseg - noverlap
    bins = w.reshape(-1, step) if nperseg % step == 0 else None
    if bins is None:
        # General hop: accumulate each shift's contribution mod step.
        acc = np.zeros(step)
        for ofs in range(0, nperseg, step):
            seg = w[ofs: ofs + step]
            acc[: seg.size] += seg
        sums = acc
    else:
        sums = bins.sum(axis=0)
    return bool(np.max(np.abs(sums - sums[0])) < tol * max(sums[0], 1e-30))


def check_NOLA(window, nperseg: int, noverlap: int,
               tol: float = 1e-10) -> bool:
    """NOnzero-OverLap-Add check (scipy.signal.check_NOLA semantics):
    is the squared-window overlap sum everywhere nonzero?  This is the
    exact invertibility condition of the framework's weighted-OLA
    :func:`istft_ri`."""
    nperseg = int(nperseg)
    noverlap = int(noverlap)
    if nperseg < 1 or not 0 <= noverlap < nperseg:
        raise ValueError(f"need 0 <= noverlap < nperseg, got "
                         f"{noverlap}/{nperseg}")
    w = window_taps(window, nperseg) ** 2
    step = nperseg - noverlap
    acc = np.zeros(step)
    for ofs in range(0, nperseg, step):
        seg = w[ofs: ofs + step]
        acc[: seg.size] += seg
    return bool(np.min(acc) > tol * max(np.max(acc), 1e-30))


def vectorstrength(events, period):
    """Vector strength (phase coherence) of event times against one or
    more periods (scipy.signal.vectorstrength semantics): returns
    (strength, phase) — the length and angle of the mean unit phasor
    e^{2 pi i events / period}."""
    events = np.asarray(events, dtype=np.float64)
    period = np.asarray(period, dtype=np.float64)
    scalar = period.ndim == 0
    per = np.atleast_1d(period)
    if np.any(per <= 0):
        raise ValueError("periods must be positive")
    ang = 2.0 * np.pi * events[None, :] / per[:, None]
    ph = np.exp(1j * ang).mean(axis=-1)
    strength, phase = np.abs(ph), np.angle(ph)
    if scalar:
        return float(strength[0]), float(phase[0])
    return strength, phase


def window_taps(kind, n: int) -> np.ndarray:
    """Host-side analysis window, PERIODIC form (float64) — the spectral-
    analysis convention (scipy.signal.get_window default), not the
    symmetric filter-design form.  Served by the framework's own window
    library (design/windows.py); accepts the full get_window spec (name,
    (name, arg) tuple, or kaiser-beta float)."""
    if kind in ("rect", "none"):
        return np.ones(n)
    from ..design.windows import get_window

    return get_window(kind, n, fftbins=True).astype(np.float64)


def _detrend_frames(frames: jnp.ndarray, detrend) -> jnp.ndarray:
    """Per-segment detrend (scipy.signal.welch semantics): ``'constant'``
    removes each segment's mean, ``'linear'`` its least-squares line;
    False/None is a no-op."""
    if detrend in (False, None, "none"):
        return frames
    if detrend == "constant":
        return frames - jnp.mean(frames, axis=-1, keepdims=True)
    if detrend == "linear":
        n = frames.shape[-1]
        # Least-squares [1, t] projection, basis precomputed host-side:
        # trend = B (B^+ x) with B (n, 2), pinv(B) (2, n).
        t = np.arange(n, dtype=np.float64)
        basis = np.stack([np.ones(n), t], axis=1)
        pinv = np.linalg.pinv(basis)
        coef = jnp.einsum("cn,...n->...c",
                          jnp.asarray(pinv, dtype=frames.dtype), frames)
        return frames - jnp.einsum("nc,...c->...n",
                                   jnp.asarray(basis, dtype=frames.dtype),
                                   coef)
    raise ValueError(f"unknown detrend {detrend!r}")


def _windowed_frames(x: jnp.ndarray, nfft: int, hop: Optional[int],
                     window: str, detrend) -> jnp.ndarray:
    hop = hop or nfft
    t = x.shape[-1]
    nframes = (t - nfft) // hop + 1
    if nframes < 1:
        raise ValueError(f"signal length {t} shorter than nfft={nfft}")
    if nfft % hop == 0:
        # Gather-free framing: view the signal
        # as hop-sample blocks; frame f is blocks [f, f + q) — q shifted
        # block-slices concatenated on the sample axis.
        q = nfft // hop
        nb = nframes + q - 1
        xb = x[..., : nb * hop].reshape(x.shape[:-1] + (nb, hop))
        frames = jnp.concatenate(
            [xb[..., j: j + nframes, :] for j in range(q)], axis=-1)
    else:
        starts = np.arange(nframes) * hop
        idx = jnp.asarray(starts[:, None] + np.arange(nfft)[None, :])
        frames = jnp.take(x, idx, axis=-1)  # (..., nframes, nfft)
    frames = _detrend_frames(frames, detrend)
    w = jnp.asarray(window_taps(window, nfft), dtype=x.dtype)
    return frames * w


@functools.lru_cache(maxsize=None)
def _windowed_dft_f64(nfft: int, window: str, onesided: bool):
    """(cos, sin) parts of the window-folded DFT table W[t, k] =
    w[t] e^{-2 pi i t k / nfft} (host f64, exact mod-N phase reduction)."""
    nb = nfft // 2 + 1 if onesided else nfft
    t = np.arange(nfft, dtype=np.int64)[:, None]
    k = np.arange(nb, dtype=np.int64)[None, :]
    ang = (-2.0 * np.pi / nfft) * ((t * k) % nfft)
    w = window_taps(window, nfft)[:, None]
    return np.ascontiguousarray(w * np.cos(ang)), \
        np.ascontiguousarray(w * np.sin(ang))


def spectrogram_ri(x: jnp.ndarray, nfft: int = 1024, *,
                   hop: Optional[int] = None, window: str = "hann",
                   detrend=False, onesided: bool = False,
                   method: str = "auto"
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Framed windowed FFT of a real signal: (..., T) -> (re, im) planes of
    shape (..., nframes, nfft) — or (..., nframes, nfft//2 + 1) with
    ``onesided=True``, which routes through the half-cost real-input
    transform (ops/fft.rfft_ri).  hop defaults to nfft (no overlap); for
    50% overlap pass hop=nfft//2.  ``detrend`` (False | 'constant' |
    'linear') removes each frame's mean/line BEFORE windowing.

    method: 'fft' (four-step engine), 'direct' (ONE dense matmul against
    the window-folded DFT table — no separate window multiply, no FFT
    relayouts; can win up to moderate nfft despite the O(N) vs
    O(log N) per-sample flop count), or 'auto' (direct for
    nfft <= 2048).
    """
    if method not in ("auto", "fft", "direct"):
        raise ValueError(f"unknown method {method!r}")
    if method == "direct" or (method == "auto" and nfft <= 2048):
        frames = _windowed_frames(x, nfft, hop, "rect", detrend)
        wc64, ws64 = _windowed_dft_f64(nfft, window, onesided)
        dot = functools.partial(jnp.dot,
                                precision=jax.lax.Precision.HIGHEST,
                                preferred_element_type=x.dtype)
        return (dot(frames, jnp.asarray(wc64, dtype=x.dtype)),
                dot(frames, jnp.asarray(ws64, dtype=x.dtype)))
    frames = _windowed_frames(x, nfft, hop, window, detrend)
    if onesided:
        return _fft.rfft_ri(frames)
    return _fft.fft_ri(frames, jnp.zeros_like(frames))


@functools.lru_cache(maxsize=None)
def _synth_idft_f64(nfft: int, window: str, onesided: bool):
    """(cos, sin) synthesis tables folding the inverse DFT, the Hermitian
    doubling weights, 1/nfft, AND the synthesis window into one matmul
    pair: frame = sr @ C + si @ S (host f64, exact mod-N phase
    reduction).  The istft analog of :func:`_windowed_dft_f64`."""
    t = np.arange(nfft, dtype=np.int64)[None, :]
    nb = nfft // 2 + 1 if onesided else nfft
    k = np.arange(nb, dtype=np.int64)[:, None]
    ang = (2.0 * np.pi / nfft) * ((t * k) % nfft)
    if onesided:
        ck = np.full((nb, 1), 2.0)
        ck[0] = 1.0
        if nfft % 2 == 0:
            ck[-1] = 1.0
    else:
        ck = np.ones((nb, 1))
    w = window_taps(window, nfft)[None, :] * ck / nfft
    return np.ascontiguousarray(w * np.cos(ang)), \
        np.ascontiguousarray(-w * np.sin(ang))


def stft_ri(x: jnp.ndarray, nfft: int = 1024, *,
            hop: Optional[int] = None, window: str = "hann",
            onesided: bool = True) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Short-time Fourier transform of a real signal (no boundary padding,
    no 1/sum(w) scaling — scipy.signal.stft with ``boundary=None,
    padded=False`` times ``sum(w)``): (..., T) -> (re, im) planes of shape
    (..., nframes, nfft//2+1) (or nfft bins with ``onesided=False``).
    Inverted exactly by :func:`istft_ri` (weighted overlap-add)."""
    return spectrogram_ri(x, nfft, hop=hop or nfft // 2, window=window,
                          onesided=onesided)


def istft_ri(sr: jnp.ndarray, si: jnp.ndarray, nfft: int = 1024, *,
             hop: Optional[int] = None, window: str = "hann",
             onesided: bool = True, method: str = "auto") -> jnp.ndarray:
    """Inverse STFT via weighted overlap-add: (..., nframes, nbins) planes
    -> (..., (nframes-1)*hop + nfft) real signal.

    Each inverse-FFT frame is re-weighted by the analysis window and the
    sum is normalized by the window-power overlap ``sum_f w^2[t - f hop]``
    (the least-squares inverse; exact wherever the window is nonzero, for
    ANY window/hop — no COLA condition needed).  Formulation:
    with q = nfft // hop, the overlap-add is q shifted pad-and-adds on the
    frame axis — pure reshapes/pads, no scatter.  The normalizer is a
    host-side float64 constant.  Requires hop | nfft.

    method: 'fft' (inverse four-step engine + window multiply), 'direct'
    (TWO dense matmuls against synthesis tables folding the inverse DFT,
    Hermitian weights, 1/nfft and the window — the istft mirror of the
    stft direct route), or 'auto' (direct for nfft <= 2048, the measured
    stft crossover).
    """
    hop = hop or nfft // 2
    if nfft % hop:
        raise ValueError(f"hop={hop} must divide nfft={nfft}")
    if method not in ("auto", "fft", "direct"):
        raise ValueError(f"unknown method {method!r}")
    q = nfft // hop
    w64 = window_taps(window, nfft)
    if method == "direct" or (method == "auto" and nfft <= 2048):
        cr64, ci64 = _synth_idft_f64(nfft, window, onesided)
        dot = functools.partial(jnp.dot,
                                precision=jax.lax.Precision.HIGHEST,
                                preferred_element_type=sr.dtype)
        fw = dot(sr, jnp.asarray(cr64, dtype=sr.dtype)) \
            + dot(si, jnp.asarray(ci64, dtype=sr.dtype))
    elif onesided:
        frames = _fft.irfft_ri(sr, si, nfft)     # (..., F, nfft)
        fw = frames * jnp.asarray(w64, dtype=frames.dtype)
    else:
        frames, _ = _fft.ifft_ri(sr, si)
        fw = frames * jnp.asarray(w64, dtype=frames.dtype)
    nframes = fw.shape[-2]
    # Overlap-add: split each frame into q hop-chunks; chunk j of frame f
    # lands at output block f + j.  Shift = pad on the frame axis.
    fw = fw.reshape(fw.shape[:-1] + (q, hop))    # (..., F, q, hop)
    lead = fw.ndim - 3
    total = None
    for j in range(q):
        part = jnp.pad(fw[..., j, :],
                       [(0, 0)] * lead + [(j, q - 1 - j), (0, 0)])
        total = part if total is None else total + part
    y = total.reshape(total.shape[:-2] + ((nframes + q - 1) * hop,))
    # Window-power normalizer over the same OLA geometry (host, f64): the
    # w^2 chunks summed into q output blocks, same decomposition as above.
    t_out = (nframes - 1) * hop + nfft
    w2 = (w64 * w64).reshape(q, hop)
    den = np.zeros((nframes + q - 1, hop))
    for j in range(q):
        den[j: j + nframes] += w2[j]
    den = den.reshape(-1)[:t_out]
    den = np.where(den > 1e-10 * np.max(den), den, 1.0)
    return y[..., :t_out] / jnp.asarray(den, dtype=y.dtype)


def csd_ri(x: jnp.ndarray, y: jnp.ndarray, nfft: int = 1024, *,
           fs: float = 1.0, window: str = "hann", overlap: bool = True,
           detrend="constant"
           ) -> Tuple[np.ndarray, jnp.ndarray, jnp.ndarray]:
    """Welch-averaged one-sided cross-spectral density of two real
    signals: returns (freqs, re(Pxy), im(Pxy)) with scipy.signal
    ``csd(..., scaling='density')`` conventions (Pxy = mean over segments
    of conj(X)·Y).  x and y must have the same trailing length; leading
    batch dims broadcast."""
    hop = nfft // 2 if overlap else nfft
    if x.shape[-1] != y.shape[-1]:
        raise ValueError("csd_ri requires equal signal lengths "
                         f"({x.shape[-1]} vs {y.shape[-1]})")
    xr, xi = spectrogram_ri(x, nfft, hop=hop, window=window,
                            detrend=detrend, onesided=True)
    yr, yi = spectrogram_ri(y, nfft, hop=hop, window=window,
                            detrend=detrend, onesided=True)
    pr = jnp.mean(xr * yr + xi * yi, axis=-2)     # re(conj(X) Y)
    pi = jnp.mean(xr * yi - xi * yr, axis=-2)     # im(conj(X) Y)
    w = window_taps(window, nfft)
    top = nfft // 2 if nfft % 2 == 0 else nfft // 2 + 1
    scale_mid = jnp.ones(nfft // 2 + 1).at[1:top].set(2.0)
    scale = scale_mid / (fs * np.sum(w ** 2))
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    return freqs, pr * scale, pi * scale


def coherence(x: jnp.ndarray, y: jnp.ndarray, nfft: int = 1024, *,
              fs: float = 1.0, window: str = "hann", overlap: bool = True,
              detrend="constant") -> Tuple[np.ndarray, jnp.ndarray]:
    """Magnitude-squared coherence |Pxy|^2 / (Pxx Pyy) (scipy.signal
    `coherence` conventions): returns (freqs, Cxy in [0, 1])."""
    freqs, pr, pi = csd_ri(x, y, nfft, fs=fs, window=window,
                           overlap=overlap, detrend=detrend)
    _, pxx = welch_psd(x, nfft, fs=fs, window=window, overlap=overlap,
                       detrend=detrend)
    _, pyy = welch_psd(y, nfft, fs=fs, window=window, overlap=overlap,
                       detrend=detrend)
    return freqs, (pr * pr + pi * pi) / (pxx * pyy)


def lombscargle(x: jnp.ndarray, y: jnp.ndarray, freqs,
                *, precenter: bool = False,
                normalize: bool = False) -> jnp.ndarray:
    """Lomb-Scargle periodogram of UNEVENLY sampled data
    (scipy.signal.lombscargle semantics: x sample times, y values, freqs
    in rad/s).  The classic tau-shifted form, vectorized over frequencies
    — the per-frequency sums become (..., N) @ (N, F) matmuls and
    the tau rotation is done implicitly via the double-angle atan2, so no
    per-frequency Python loop exists.  y may carry leading batch dims
    over a shared time base x."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    if x.ndim != 1:
        raise ValueError("x must be 1-D sample times")
    if y.shape[-1] != x.shape[0]:
        raise ValueError(f"y trailing axis {y.shape[-1]} != len(x) "
                         f"{x.shape[0]}")
    freqs = jnp.asarray(freqs, dtype=x.dtype)
    if precenter:
        y = y - jnp.mean(y, axis=-1, keepdims=True)
    ang = freqs[:, None] * x[None, :]                     # (F, N)
    c = jnp.cos(ang)
    s = jnp.sin(ang)
    # tan(2 w tau) = sum sin 2wx / sum cos 2wx, via double angles.
    s2 = 2.0 * jnp.sum(s * c, axis=-1)
    c2 = jnp.sum((c - s) * (c + s), axis=-1)
    two_wt = jnp.arctan2(s2, c2)
    ct = jnp.cos(0.5 * two_wt)[:, None]                   # cos(w tau)
    st = jnp.sin(0.5 * two_wt)[:, None]
    cshift = c * ct + s * st                              # cos w(x - tau)
    sshift = s * ct - c * st
    dot = functools.partial(jnp.einsum,
                            precision=jax.lax.Precision.HIGHEST)
    yc = dot("...n,fn->...f", y, cshift)
    ys = dot("...n,fn->...f", y, sshift)
    cc = jnp.sum(cshift * cshift, axis=-1)                # (F,)
    ss_ = jnp.sum(sshift * sshift, axis=-1)
    pgram = 0.5 * (yc * yc / cc + ys * ys / ss_)
    if normalize:
        pgram = pgram * (2.0 / jnp.sum(y * y, axis=-1, keepdims=True))
    return pgram


def periodogram(x: jnp.ndarray, *, fs: float = 1.0,
                window: str = "boxcar", nfft: Optional[int] = None,
                detrend="constant") -> Tuple[np.ndarray, jnp.ndarray]:
    """Single-segment one-sided PSD estimate (scipy.signal `periodogram`
    conventions: window spans the whole signal, optional zero-padding to
    ``nfft`` AFTER windowing, 'density' scaling)."""
    n = x.shape[-1]
    nfft = nfft or n
    if nfft < n:
        raise ValueError(f"nfft={nfft} < signal length {n}")
    frames = _windowed_frames(x, n, None, window, detrend)
    if nfft > n:
        pad = [(0, 0)] * (frames.ndim - 1) + [(0, nfft - n)]
        frames = jnp.pad(frames, pad)
    sr, si = _fft.rfft_ri(frames)
    half = jnp.squeeze(sr * sr + si * si, axis=-2)
    top = nfft // 2 if nfft % 2 == 0 else nfft // 2 + 1
    scale_mid = jnp.ones(nfft // 2 + 1).at[1:top].set(2.0)
    w = window_taps(window, n)
    psd = half * scale_mid / (fs * np.sum(w ** 2))
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    return freqs, psd


def welch_psd(x: jnp.ndarray, nfft: int = 1024, *, fs: float = 1.0,
              window: str = "hann", overlap: bool = True,
              detrend="constant") -> Tuple[np.ndarray, jnp.ndarray]:
    """Welch-averaged one-sided PSD of a real signal.

    Returns (freqs (nfft//2+1,), psd (..., nfft//2+1)) with scipy.signal
    `welch(..., scaling='density')` conventions (validated in tests),
    including the per-segment ``detrend='constant'`` default.
    """
    hop = nfft // 2 if overlap else nfft
    sr, si = spectrogram_ri(x, nfft, hop=hop, window=window,
                            detrend=detrend, onesided=True)
    w = window_taps(window, nfft)
    power = sr * sr + si * si            # (..., nframes, nfft//2+1)
    half = jnp.mean(power, axis=-2)      # (..., nfft//2+1)
    # one-sided: double everything except DC — and Nyquist, which only
    # exists for even nfft.
    top = nfft // 2 if nfft % 2 == 0 else nfft // 2 + 1
    scale_mid = jnp.ones(nfft // 2 + 1).at[1:top].set(2.0)
    psd = half * scale_mid / (fs * np.sum(w ** 2))
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    return freqs, psd


def envelope(z: jnp.ndarray, bp_in: Tuple = (1, None), *,
             n_out: Optional[int] = None, squared: bool = False,
             residual: Optional[str] = "lowpass", axis: int = -1):
    """Envelope of a signal with optional residual
    (scipy.signal.envelope semantics): the magnitude of the signal
    restricted to the in-band bins ``bp_in = (lo, hi)`` of the length-n
    DFT, optionally resampled to ``n_out``; ``residual`` returns what
    the band excluded ('lowpass': only bins below the band; 'all':
    everything outside; None: envelope alone).  Runs on the framework's
    FFT engine.  REAL input follows scipy's analytic-signal branch
    (in-band doubling, real residual via irfft); COMPLEX input follows
    scipy's full-spectrum branch (no doubling; complex residual via the
    frequency-domain-resample Nyquist corrections); :func:`envelope_ri`
    is the RI-plane form.
    """
    z = jnp.asarray(z)
    if jnp.iscomplexobj(z):
        return _envelope_complex(z, bp_in, n_out=n_out, squared=squared,
                                 residual=residual, axis=axis)
    if axis != -1:
        z = jnp.moveaxis(z, axis, -1)
    n = z.shape[-1]
    if n < 1:
        raise ValueError("empty signal")
    if len(bp_in) != 2 or not all(b is None or isinstance(b, int)
                                  for b in bp_in):
        raise ValueError("bp_in must be a 2-tuple of int | None")
    if residual not in ("lowpass", "all", None):
        raise ValueError("residual must be 'lowpass', 'all', or None")
    n_out = n if n_out is None else int(n_out)
    if n_out < 1:
        raise ValueError("n_out must be positive")
    fak = n_out / n
    lo = bp_in[0] if bp_in[0] is not None else -(n // 2)
    hi = bp_in[1] if bp_in[1] is not None else (n + 1) // 2
    if not (-n // 2 <= lo < hi <= (n + 1) // 2):
        raise ValueError(f"invalid bp_in={bp_in} for n={n}")

    from simpledsp_jax.ops.fft import rfft

    zr = rfft(z.astype(jnp.result_type(z.dtype, jnp.float32)))
    full = jnp.zeros(z.shape[:-1] + (n,), dtype=zr.dtype)
    full = full.at[..., : n // 2 + 1].set(zr)
    if lo > 0:
        full = full.at[..., lo:hi].multiply(2.0)
    elif hi > 0:
        full = full.at[..., 1:hi].multiply(2.0)
    # ---- in-band baseband signal ----
    if not (lo <= 0 < hi):
        # scipy slices Z[..., lo:hi] directly: plain python slicing
        # covers both all-positive and all-negative bands (the latter
        # selects the zero negative bins of a real signal's spectrum).
        z_bb = _ifft_resampled(full[..., lo:hi], n_out) * fak
    else:
        shifted = jnp.roll(full, n // 2, axis=-1)
        z_bb = _ifft_resampled(shifted[..., lo + n // 2: hi + n // 2],
                               n_out) * fak
    env = (jnp.real(z_bb) ** 2 + jnp.imag(z_bb) ** 2) if squared \
        else jnp.abs(z_bb)
    if residual is None:
        return env if axis in (-1, z.ndim - 1) \
            else jnp.moveaxis(env, -1, axis)
    # ---- residual: zero the band (and, for 'lowpass', above it) ----
    # Exactly scipy's zeroing branches, as a boolean mask.
    sl = np.zeros(n, dtype=bool)
    if not (lo <= 0 < hi):
        sl[lo:hi] = True          # python slice: positive OR negative band
    else:
        sl[:hi] = True
        sl[lo:] = True
    if residual == "lowpass":
        if hi > 0:
            sl[hi:(n + 1) // 2] = True
        else:
            sl[lo:] = True
            sl[: (n + 1) // 2] = True
    keep = jnp.asarray(~sl, dtype=full.real.dtype)
    fullr = full * keep
    # Real inverse with the unpaired-Nyquist correction on resampling.
    # The bin that becomes (or stops being) Nyquist may be genuinely
    # complex when cropping (n_out < n); scipy's irfft discards its
    # imaginary part while the framework irfft would use it — take the
    # real part explicitly before scaling so both agree.
    if n_out != n and (m := min(n, n_out)) % 2 == 0:
        nyq = jnp.real(fullr[..., m // 2]).astype(fullr.dtype)
        fullr = fullr.at[..., m // 2].set(
            (2.0 if n_out < n else 0.5) * nyq)
    spec_half = fullr[..., : n_out // 2 + 1] if n_out <= n else \
        jnp.pad(fullr[..., : n // 2 + 1],
                [(0, 0)] * (fullr.ndim - 1) + [(0, n_out // 2 + 1
                                                - (n // 2 + 1))])
    from simpledsp_jax.ops.fft import irfft
    z_res = fak * irfft(spec_half, n_out)
    res = jnp.real(z_res)
    if axis not in (-1, env.ndim - 1):
        env = jnp.moveaxis(env, -1, axis)
        res = jnp.moveaxis(res, -1, axis)
    return jnp.stack([env, res], axis=0)


def _ifft_resampled(band: jnp.ndarray, n_out: int) -> jnp.ndarray:
    """ifft(band, n=n_out): numpy's convention — crop or zero-pad the
    SPECTRUM TAIL to n_out before the inverse transform."""
    from simpledsp_jax.ops.fft import ifft

    m = band.shape[-1]
    if n_out == m:
        return ifft(band)
    if n_out < m:
        return ifft(band[..., :n_out])
    pad = [(0, 0)] * (band.ndim - 1) + [(0, n_out - m)]
    return ifft(jnp.pad(band, pad))


def _envelope_complex(z: jnp.ndarray, bp_in: Tuple, *,
                      n_out: Optional[int], squared: bool,
                      residual: Optional[str], axis: int):
    """scipy.signal.envelope's complex-input branch: full spectrum (no
    analytic doubling), residual via the frequency-domain-resample
    Nyquist-bin corrections (scipy.signal.resample domain='freq')."""
    from simpledsp_jax.ops.fft import fft, ifft

    if axis != -1:
        z = jnp.moveaxis(z, axis, -1)
    n = z.shape[-1]
    if n < 1:
        raise ValueError("empty signal")
    if len(bp_in) != 2 or not all(b is None or isinstance(b, int)
                                  for b in bp_in):
        raise ValueError("bp_in must be a 2-tuple of int | None")
    if residual not in ("lowpass", "all", None):
        raise ValueError("residual must be 'lowpass', 'all', or None")
    n_out = n if n_out is None else int(n_out)
    if n_out < 1:
        raise ValueError("n_out must be positive")
    fak = n_out / n
    lo = bp_in[0] if bp_in[0] is not None else -(n // 2)
    hi = bp_in[1] if bp_in[1] is not None else (n + 1) // 2
    if not (-n // 2 <= lo < hi <= (n + 1) // 2):
        raise ValueError(f"invalid bp_in={bp_in} for n={n}")

    Z = fft(z)
    if not (lo <= 0 < hi):
        z_bb = _ifft_resampled(Z[..., lo:hi], n_out) * fak
    else:
        shifted = jnp.roll(Z, n // 2, axis=-1)
        z_bb = _ifft_resampled(shifted[..., lo + n // 2: hi + n // 2],
                               n_out) * fak
    env = (jnp.real(z_bb) ** 2 + jnp.imag(z_bb) ** 2) if squared \
        else jnp.abs(z_bb)
    if residual is None:
        return env if axis in (-1, z.ndim - 1) \
            else jnp.moveaxis(env, -1, axis)
    # Zero the band (scipy's exact branches; unlike the real path, the
    # 'lowpass' negative-lo case also zeroes the positive frequencies).
    sl = np.zeros(n, dtype=bool)
    if not (lo <= 0 < hi):
        sl[lo:hi] = True
    else:
        sl[:hi] = True
        sl[lo:] = True
    if residual == "lowpass":
        if hi > 0:
            sl[hi:(n + 1) // 2] = True
        else:
            sl[lo:] = True
            sl[: (n + 1) // 2] = True
    Zr = Z * jnp.asarray(~sl, dtype=env.dtype)
    # Frequency-domain resample to n_out (scipy.signal.resample
    # domain='freq', complex branch): head + tail copy, then the
    # even-min(n, n_out) Nyquist split/join.
    if n_out == n:
        z_res = ifft(Zr)
    else:
        m = min(n_out, n)
        nyq = m // 2 + 1
        y_spec = jnp.zeros(z.shape[:-1] + (n_out,), dtype=Zr.dtype)
        y_spec = y_spec.at[..., :nyq].set(Zr[..., :nyq])
        if m > 2:
            y_spec = y_spec.at[..., nyq - m:].set(Zr[..., nyq - m:])
        if m % 2 == 0:
            if n_out < n:       # join the straddled -m/2 bin
                y_spec = y_spec.at[..., -(m // 2)].add(
                    Zr[..., n - m // 2])
            else:               # split: halve +m/2 and mirror to -m/2
                y_spec = y_spec.at[..., m // 2].multiply(0.5)
                y_spec = y_spec.at[..., n_out - m // 2].set(
                    y_spec[..., m // 2])
        z_res = ifft(y_spec) * fak
    if axis not in (-1, env.ndim - 1):
        env = jnp.moveaxis(env, -1, axis)
        z_res = jnp.moveaxis(z_res, -1, axis)
    return jnp.stack([env.astype(z_res.dtype), z_res], axis=0)


def envelope_ri(zr: jnp.ndarray, zi: jnp.ndarray,
                bp_in: Tuple = (1, None), *, n_out: Optional[int] = None,
                squared: bool = False,
                residual: Optional[str] = "lowpass", axis: int = -1):
    """Complex-signal envelope on RI planes — the framework's complex
    carrier; scipy.signal.envelope complex semantics via
    :func:`envelope`'s complex branch.  Returns ``env`` (real) when
    ``residual`` is None, else ``(env, (res_r, res_i))``."""
    zr = jnp.asarray(zr)
    zi = jnp.asarray(zi)
    dt = jnp.result_type(zr.dtype, zi.dtype, jnp.float32)
    z = jax.lax.complex(zr.astype(dt), zi.astype(dt))
    out = _envelope_complex(z, bp_in, n_out=n_out, squared=squared,
                            residual=residual, axis=axis)
    if residual is None:
        return out
    env, res = out[0], out[1]
    return jnp.real(env), (jnp.real(res), jnp.imag(res))
