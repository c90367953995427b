"""1-D convolution and cross-correlation (numpy/scipy semantics), batched.

The reference library has no standalone convolution API — streaming FIR is
the closest capability (this framework's ops/fir.py) — but every DSP user
reaches for ``convolve``/``correlate``, so they are provided with full
numpy/scipy mode semantics (``full`` / ``same`` / ``valid``) over batched
leading axes, real or complex inputs.

Methods:
  * ``direct`` — one ``lax.conv_general_dilated`` call (the right choice
    for short kernels).
  * ``fft`` — zero-padded power-of-2 FFT product via ops/fft.py's four-step
    matmul engine (the right choice for long kernels).
  * ``auto`` — picks by kernel length.

Complex inputs are carried as (re, im) float planes (see ops/fft.py) and
recombined at the boundary.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from simpledsp_jax.ops.fft import _as_ri, _pick_real_dtype, fft_ri, ifft_ri

__all__ = ["choose_conv_method",
           "convolve", "correlate", "correlation_lags", "deconvolve",
           "fftconvolve", "oaconvolve"]

def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.lru_cache(maxsize=64)
def _cached_ols(taps_bytes: bytes, m: int, block: int, dtype_str: str):
    from simpledsp_jax.ops.fir import OverlapSaveFIR
    taps = np.frombuffer(taps_bytes, dtype=np.float64, count=m)
    return OverlapSaveFIR(taps, block_size=block, dtype=jnp.dtype(dtype_str))


def _conv_ols_full(x: jnp.ndarray, h64: np.ndarray, dtype) -> jnp.ndarray:
    """Full linear convolution of a LONG real signal with real taps via
    streaming overlap-save blocks (ops/fir.OverlapSaveFIR) — one length-L
    FFT per hop instead of one giant 2x-padded transform.  Zero initial
    history makes the causal OLS output exactly the full convolution."""
    n = x.shape[-1]
    m = h64.size
    total = n + m - 1
    block = max(4096, _next_pow2(4 * m))
    pad_tail = (m - 1) + (-total % block)
    ols = _cached_ols(h64.tobytes(), m, block, jnp.dtype(dtype).str)
    # Inline the OLS body (ols._run) instead of calling the streaming
    # __call__: that avoids the zero-history concat AND keeps everything
    # in THIS trace so XLA fuses the front/tail pad and the output slice
    # with the framing (a nested jit call is a fusion barrier).
    xp = jnp.pad(x.astype(dtype),
                 [(0, 0)] * (x.ndim - 1) + [(m - 1, pad_tail)])
    return ols._run(xp)[..., :total]


def _conv_real_full(x: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """Full linear convolution of real planes: (..., n) * (m,) ->
    (..., n + m - 1), via one grouped XLA convolution."""
    n = x.shape[-1]
    m = h.shape[-1]
    batch = x.shape[:-1]
    xb = x.reshape((-1, 1, n))                       # (B, C=1, W)
    # XLA convs are correlations; flip the taps for convolution.
    hb = h[::-1].reshape((1, 1, m)).astype(x.dtype)  # (O, I, W)
    y = jax.lax.conv_general_dilated(
        xb, hb, window_strides=(1,), padding=[(m - 1, m - 1)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=x.dtype,
        precision=jax.lax.Precision.HIGHEST)
    return y.reshape(batch + (n + m - 1,))


def _conv_fft_full(xr, xi, hr, hi, complex_out: bool
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full linear convolution via zero-padded power-of-2 FFT."""
    n = xr.shape[-1]
    m = hr.shape[-1]
    L = _next_pow2(n + m - 1)
    pad_x = [(0, 0)] * (xr.ndim - 1) + [(0, L - n)]
    pad_h = [(0, L - m)]
    fxr, fxi = fft_ri(jnp.pad(xr, pad_x), jnp.pad(xi, pad_x))
    fhr, fhi = fft_ri(jnp.pad(hr, pad_h), jnp.pad(hi, pad_h))
    yr = fxr * fhr - fxi * fhi
    yi = fxr * fhi + fxi * fhr
    zr, zi = ifft_ri(yr, yi)
    return zr[..., : n + m - 1], zi[..., : n + m - 1]


def _apply_mode(y: jnp.ndarray, n: int, m: int, mode: str) -> jnp.ndarray:
    if mode == "full":
        return y
    if mode == "same":
        start = (m - 1) // 2
        return y[..., start: start + n]
    if mode == "valid":
        lo, hi = sorted((n, m))
        start = lo - 1
        return y[..., start: start + hi - lo + 1]
    raise ValueError(f"unknown mode {mode!r} (use 'full', 'same', 'valid')")


def choose_conv_method(in1, in2, mode: str = "full",
                       measure: bool = False):
    """Which method :func:`convolve`'s ``method='auto'`` would pick for
    these operands (scipy.signal.choose_conv_method API) — answered
    with THIS framework's crossover (min length > 96 routes to the
    matmul-FFT engine), not scipy's CPU heuristic.  With
    ``measure=True`` both framework paths are timed on the current
    backend and (method, times) is returned."""
    n = np.shape(np.asarray(in1))[-1]
    m = np.shape(np.asarray(in2))[-1]
    method = "fft" if min(n, m) > 96 else "direct"
    if not measure:
        return method
    import time as _time

    times = {}
    x1 = jnp.asarray(in1)
    x2 = jnp.asarray(in2)
    for meth in ("fft", "direct"):
        y = convolve(x1, x2, mode, method=meth)
        jax.block_until_ready(y)
        t0 = _time.perf_counter()
        y = convolve(x1, x2, mode, method=meth)
        jax.block_until_ready(y)
        times[meth] = _time.perf_counter() - t0
    return ("fft" if times["fft"] < times["direct"] else "direct"), times


def convolve(x: jnp.ndarray, h, mode: str = "full", *,
             method: str = "auto", dtype=None) -> jnp.ndarray:
    """Linear convolution over the last axis (numpy.convolve semantics for
    1-D inputs; x may carry leading batch axes, h is 1-D).

    Complex inputs are supported; the output is complex iff either input
    is.  ``method``: 'direct' | 'fft' | 'auto'.
    """
    if method not in ("auto", "direct", "fft"):
        raise ValueError(f"unknown method {method!r}")
    # Concreteness must be tested on the CALLER's taps: jnp.asarray lifts
    # numpy constants into tracers inside a jit trace, but the values are
    # still trace-time constants we can bake into OLS tables.
    h_in = h
    h = jnp.asarray(h)
    if h.ndim != 1:
        raise ValueError(f"h must be 1-D, got shape {h.shape}")
    n = x.shape[-1]
    m = h.shape[-1]
    if n == 0 or m == 0:
        raise ValueError("convolve requires non-empty inputs")
    complex_out = jnp.iscomplexobj(x) or jnp.iscomplexobj(h)
    rdt = _pick_real_dtype(x, dtype)
    xr, xi = _as_ri(x, rdt)
    hr, hi = _as_ri(h, rdt)
    use_fft = method == "fft" or (method == "auto" and min(n, m) > 96)
    h_concrete = not isinstance(h_in, jax.core.Tracer)
    if (use_fft and not complex_out and h_concrete
            and n >= 4 * m and n + m - 1 >= 8192):
        # Long real signal: streaming overlap-save blocks beat one giant
        # 2x-padded FFT (and skip the pow2 over-padding entirely).
        yr = _conv_ols_full(xr, np.asarray(h_in, dtype=np.float64), rdt)
        yi = None
    elif use_fft:
        yr, yi = _conv_fft_full(xr, xi, hr, hi, complex_out)
    elif complex_out:
        yr = _conv_real_full(xr, hr) - _conv_real_full(xi, hi)
        yi = _conv_real_full(xr, hi) + _conv_real_full(xi, hr)
    else:
        yr = _conv_real_full(xr, hr)
        yi = None
    yr = _apply_mode(yr, n, m, mode)
    if not complex_out:
        return yr
    yi = _apply_mode(yi if yi is not None else jnp.zeros_like(yr), n, m,
                     mode)
    return jax.lax.complex(yr, yi)


def correlate(x: jnp.ndarray, h, mode: str = "full", *,
              method: str = "auto", dtype=None) -> jnp.ndarray:
    """Cross-correlation over the last axis (scipy.signal.correlate
    semantics: ``z[k] = sum_j x[j + k - (m - 1)] conj(h[j])``), i.e.
    ``convolve(x, conj(h[::-1]))``."""
    if isinstance(h, (jax.core.Tracer, jax.Array)):
        # Device/traced taps stay on device (a np.asarray fetch would
        # block per call).
        h = jnp.conj(h)[::-1] if jnp.iscomplexobj(h) else h[::-1]
    else:
        # Flip host-side so convolve still sees concrete HOST taps
        # (keeps the overlap-save route available under jit).
        h = np.conj(np.asarray(h))[::-1]
    return convolve(x, h, mode, method=method, dtype=dtype)


def fftconvolve(x: jnp.ndarray, h, mode: str = "full", *,
                dtype=None) -> jnp.ndarray:
    """FFT-domain convolution by the familiar scipy name
    (scipy.signal.fftconvolve semantics for 1-D taps over the last
    axis) — :func:`convolve` forced onto the transform route: the
    four-step engine or, for long real signals, streaming overlap-save."""
    return convolve(x, h, mode, method="fft", dtype=dtype)


def oaconvolve(x: jnp.ndarray, h, mode: str = "full", *,
               dtype=None) -> jnp.ndarray:
    """Overlap-add-style block convolution by the familiar scipy name
    (scipy.signal.oaconvolve's use case: one long signal against short
    taps).  Routed through :func:`convolve`'s streaming overlap-SAVE
    blocks; identical outputs to fftconvolve, better memory behavior on
    long signals."""
    return convolve(x, h, mode, method="fft", dtype=dtype)


def correlation_lags(in1_len: int, in2_len: int,
                     mode: str = "full") -> np.ndarray:
    """Lag indices for the output of :func:`correlate`
    (scipy.signal.correlation_lags semantics) — host-side metadata, so a
    plain numpy array."""
    if mode == "full":
        return np.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = np.arange(-in2_len + 1, in1_len)
        mid = lags.size // 2
        lo = mid - in1_len // 2
        return lags[lo: lo + in1_len]
    if mode == "valid":
        lo, hi = sorted((in1_len, in2_len))
        return np.arange(hi - lo + 1) + min(0, in1_len - in2_len)
    raise ValueError(f"unknown mode {mode!r}")


def deconvolve(signal: jnp.ndarray, divisor
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Polynomial deconvolution (scipy.signal.deconvolve semantics):
    quotient q and remainder r with ``signal = convolve(divisor, q) + r``.
    Long division IS the IIR recurrence
    ``q[k] = (s[k] - sum_{j>=1} div[j] q[k-j]) / div[0]`` — i.e. the
    framework's own ``lfilter([1], divisor, signal[:n])`` — so the
    quotient runs through the existing scan/state machinery, batched over
    leading axes.  ``divisor`` is a concrete 1-D tap vector."""
    from simpledsp_jax.ops.lfilter import lfilter

    div = np.asarray(divisor, dtype=np.float64)
    if div.ndim != 1 or div.size == 0 or div[0] == 0.0:
        raise ValueError("divisor must be 1-D with a nonzero leading tap")
    n = signal.shape[-1] - div.size + 1
    if n < 1:
        return (jnp.zeros(signal.shape[:-1] + (0,), signal.dtype),
                signal)
    quot, _ = lfilter(np.ones(1), div, signal[..., :n])
    rem = signal - convolve(quot, div, mode="full")[..., : signal.shape[-1]]
    return quot, rem
