"""2-D convolution / cross-correlation (scipy.signal.convolve2d /
correlate2d semantics), batched over leading axes.

The reference is strictly 1-D (FFT + IIR on sample streams); 2-D
filtering is the natural widening of the same capability set:

* ``direct`` — the kernel unrolled as kh*kw shifted fused
  multiply-adds, which XLA fuses into one elementwise pass over the
  image (a 1-in/1-out-channel conv gives a GEMM-based conv lowering a
  degenerate contraction).
* ``fft`` — pad-and-multiply through the four-step engine's 2-D entry
  points (ops/fft.rfft2_ri / irfft2_ri), right for large kernels
  (cost flat in kernel size).

Boundary handling ('fill'/'wrap'/'symm') is one host-side jnp.pad before
a VALID convolution, so every mode/boundary combination shares the same
compiled core.  Complex inputs are carried as (re, im) float planes
(framework-wide convention).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from simpledsp_jax.ops.fft import (_as_ri, _pick_real_dtype, irfft2_ri,
                                   rfft2_ri)

__all__ = ["convolve2d", "correlate2d"]

def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _pad_boundary(x: jnp.ndarray, kh: int, kw: int, boundary: str,
                  fillvalue: float) -> jnp.ndarray:
    """Extend the image by (kh-1, kw-1) on every side per the boundary
    rule, so a VALID convolution over the result is the FULL output."""
    pad = [(0, 0)] * (x.ndim - 2) + [(kh - 1, kh - 1), (kw - 1, kw - 1)]
    if boundary == "fill":
        return jnp.pad(x, pad, constant_values=fillvalue)
    if boundary == "wrap":
        return jnp.pad(x, pad, mode="wrap")
    if boundary == "symm":
        return jnp.pad(x, pad, mode="symmetric")
    raise ValueError(f"unknown boundary {boundary!r} "
                     "(use 'fill', 'wrap', or 'symm')")


def _crop_mode(y: jnp.ndarray, hw: Tuple[int, int], kh: int, kw: int,
               mode: str) -> jnp.ndarray:
    """Slice the FULL result down to the requested mode."""
    h, w = hw
    if mode == "full":
        return y
    if mode == "same":
        r0, c0 = (kh - 1) // 2, (kw - 1) // 2
        return y[..., r0: r0 + h, c0: c0 + w]
    if mode == "valid":
        if h < kh or w < kw:
            raise ValueError("valid mode needs an image at least as large "
                             f"as the kernel, got {hw} vs ({kh}, {kw})")
        return y[..., kh - 1: h, kw - 1: w]
    raise ValueError(f"unknown mode {mode!r} (use 'full', 'same', 'valid')")


def _conv2d_direct_real(xp: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """VALID real 2-D convolution of the pre-padded (..., Hp, Wp) image
    with the already-FLIPPED (kh, kw) kernel, as kh*kw shifted FMAs
    (one fused elementwise pass)."""
    kh, kw = k.shape
    oh = xp.shape[-2] - kh + 1
    ow = xp.shape[-1] - kw + 1
    acc = jnp.zeros(xp.shape[:-2] + (oh, ow), dtype=xp.dtype)
    for i in range(kh):
        for j in range(kw):
            acc = acc + k[i, j] * xp[..., i: i + oh, j: j + ow]
    return acc


def _fft_size_2d(n: int) -> int:
    """Smallest efficient FFT length >= n: any multiple of 128 factors
    onto the four-step engine (n = k * 128, k <= 128 — step 1 is a dense
    DFT_k matmul, step 3 the 128-point dense DFT), so rounding 575 -> 640
    instead of -> 1024 cuts the padded pixel count 2.56x."""
    if n <= 128:
        return _next_pow2(n)
    return min(-(-n // 128) * 128, _next_pow2(n))


def _conv2d_fft_real(xp: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """VALID == FULL-grid FFT convolution of the pre-padded image with
    the (unflipped) kernel: tight-padded rfft2 product."""
    hp, wp = xp.shape[-2:]
    kh, kw = k.shape
    oh, ow = hp - kh + 1, wp - kw + 1   # valid-output size
    fh, fw = _fft_size_2d(hp), _fft_size_2d(wp)
    pad_x = [(0, 0)] * (xp.ndim - 2) + [(0, fh - hp), (0, fw - wp)]
    xr, xi = rfft2_ri(jnp.pad(xp, pad_x))
    kr, ki = rfft2_ri(jnp.pad(k, [(0, fh - kh), (0, fw - kw)]))
    yr = xr * kr - xi * ki
    yi = xr * ki + xi * kr
    y = irfft2_ri(yr, yi, fw)
    # Linear-convolution indices [kh-1, hp) of the circular result.
    return y[..., kh - 1: kh - 1 + oh, kw - 1: kw - 1 + ow]


def convolve2d(x: jnp.ndarray, h, mode: str = "full", *,
               boundary: str = "fill", fillvalue: float = 0.0,
               method: str = "auto", dtype=None) -> jnp.ndarray:
    """2-D convolution over the last two axes (scipy.signal.convolve2d
    semantics for mode/boundary/fillvalue, extended with batched leading
    axes).  method: 'direct' (shifted-FMA unroll, one fused elementwise
    pass), 'fft' (pow2-padded rfft2 product), 'auto' (direct up to 256
    kernel taps)."""
    if method not in ("auto", "direct", "fft"):
        raise ValueError(f"unknown method {method!r}")
    h = jnp.asarray(h)
    if h.ndim != 2:
        raise ValueError(f"kernel must be 2-D, got shape {h.shape}")
    if x.ndim < 2:
        raise ValueError(f"image must have >= 2 dims, got shape {x.shape}")
    kh, kw = h.shape
    hw = x.shape[-2:]
    cplx = jnp.iscomplexobj(x) or jnp.iscomplexobj(h)
    rdt = _pick_real_dtype(x, dtype) if cplx else (dtype or x.dtype)
    use_fft = method == "fft" or (method == "auto" and kh * kw > 256)

    xr, xi = _as_ri(x, rdt) if cplx else (x.astype(rdt), None)
    hr, hi = _as_ri(h, rdt) if cplx else (h.astype(rdt), None)

    def conv_real(img, ker):
        imgp = _pad_boundary(img, kh, kw, boundary, fillvalue)
        if use_fft:
            return _conv2d_fft_real(imgp, ker)
        return _conv2d_direct_real(imgp, ker[::-1, ::-1])

    if not cplx:
        return _crop_mode(conv_real(xr, hr), hw, kh, kw, mode)
    yr = conv_real(xr, hr) - conv_real(xi, hi)
    yi = conv_real(xr, hi) + conv_real(xi, hr)
    return _crop_mode(jax.lax.complex(yr, yi), hw, kh, kw, mode)


def correlate2d(x: jnp.ndarray, h, mode: str = "full", *,
                boundary: str = "fill", fillvalue: float = 0.0,
                method: str = "auto", dtype=None) -> jnp.ndarray:
    """2-D cross-correlation (scipy.signal.correlate2d semantics):
    convolution with the conjugated, 180-degree-rotated kernel on the
    same full-output grid."""
    if isinstance(h, (jax.core.Tracer, jax.Array)):
        if h.ndim != 2:
            raise ValueError(f"kernel must be 2-D, got shape {h.shape}")
        hf = jnp.conj(h[::-1, ::-1])
    else:
        # Flip host-side; device arrays stay on device (no blocking
        # fetch).
        hnp = np.asarray(h)
        if hnp.ndim != 2:
            raise ValueError(f"kernel must be 2-D, got shape {hnp.shape}")
        hf = np.conj(hnp[::-1, ::-1])
    h = jnp.asarray(h)
    if mode == "same":
        # Correlation centers 'same' at kh//2 (vs convolution's
        # (kh-1)//2) — they differ only for even kernel dims.
        kh, kw = h.shape
        hcont, wcont = x.shape[-2:]
        full = convolve2d(x, hf, "full", boundary=boundary,
                          fillvalue=fillvalue, method=method, dtype=dtype)
        return full[..., kh // 2: kh // 2 + hcont,
                    kw // 2: kw // 2 + wcont]
    return convolve2d(x, hf, mode, boundary=boundary, fillvalue=fillvalue,
                      method=method, dtype=dtype)
