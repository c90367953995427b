"""Smoothing / robust local filtering: Savitzky-Golay, median, Wiener,
detrend (scipy.signal parity, batched over leading axes).

Design: every op is (weights from host-side float64 linear algebra) x
(one batched device convolution or rank-select) — the framework's
standard split of trace-time design vs device compute.  The
Savitzky-Golay edge handling ('interp') is a LINEAR map of the edge
samples, so it is precomputed as two small matrices and applied as dense
matmuls instead of per-call polyfits.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import jax.numpy as jnp
import numpy as np

__all__ = ["savgol_coeffs", "savgol_filter", "medfilt", "medfilt2d",
           "order_filter", "wiener", "detrend"]


@functools.lru_cache(maxsize=None)
def _savgol_coeffs_f64(window_length: int, polyorder: int, deriv: int,
                       delta: float) -> np.ndarray:
    """Least-squares local-polynomial FIR weights (scipy.signal
    savgol_coeffs with use='conv': reversed for convolution)."""
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    if deriv > polyorder:
        return np.zeros(window_length)
    pos = (window_length - 1) / 2.0
    x = np.arange(-pos, window_length - pos, dtype=np.float64)[::-1]
    order = np.arange(polyorder + 1, dtype=np.float64)[:, None]
    A = x[None, :] ** order
    y = np.zeros(polyorder + 1)
    y[deriv] = math.factorial(deriv) / (float(delta) ** deriv)
    coeffs, *_ = np.linalg.lstsq(A, y, rcond=None)
    return coeffs


def savgol_coeffs(window_length: int, polyorder: int, *, deriv: int = 0,
                  delta: float = 1.0) -> np.ndarray:
    """Savitzky-Golay FIR weights in convolution order (scipy.signal
    savgol_coeffs(use='conv')), host float64."""
    return _savgol_coeffs_f64(int(window_length), int(polyorder),
                              int(deriv), float(delta))


@functools.lru_cache(maxsize=None)
def _savgol_edge_maps_f64(window_length: int, polyorder: int, deriv: int,
                          delta: float) -> Tuple[np.ndarray, np.ndarray]:
    """(E_left, E_right): linear maps from the first/last window_length
    samples to the first/last halflen 'interp'-mode outputs — the matrix
    form of scipy's per-call edge polyfit."""
    wl, po = window_length, polyorder
    half = wl // 2
    t = np.arange(wl, dtype=np.float64)
    v_fit = t[:, None] ** np.arange(po + 1)[None, :]          # (wl, po+1)
    pinv = np.linalg.pinv(v_fit)                              # (po+1, wl)
    # Differentiation matrix on the monomial basis.
    dmat = np.eye(po + 1)
    for _ in range(deriv):
        shift = np.zeros((po + 1, po + 1))
        for k in range(1, po + 1):
            shift[k - 1, k] = k
        dmat = shift @ dmat
    def eval_at(points):
        return (points[:, None] ** np.arange(po + 1)[None, :]) @ dmat @ pinv
    scale = float(delta) ** deriv
    e_left = eval_at(np.arange(half, dtype=np.float64)) / scale
    e_right = eval_at(np.arange(wl - half, wl, dtype=np.float64)) / scale
    return e_left, e_right


def savgol_filter(x: jnp.ndarray, window_length: int, polyorder: int, *,
                  deriv: int = 0, delta: float = 1.0,
                  mode: str = "interp", cval: float = 0.0) -> jnp.ndarray:
    """Savitzky-Golay smoothing / differentiation over the last axis
    (scipy.signal.savgol_filter semantics; odd window_length).

    mode 'interp' (default) replaces each edge half-window with an exact
    polynomial fit of the outermost window — applied here as one small
    precomputed matmul per edge.  'mirror'/'constant'/'nearest'/'wrap'
    pad then convolve.
    """
    wl = int(window_length)
    if wl % 2 != 1 or wl < 1:
        raise ValueError(f"window_length must be odd and >= 1, got {wl}")
    c = _savgol_coeffs_f64(wl, int(polyorder), int(deriv), float(delta))
    cj = jnp.asarray(c, dtype=x.dtype)
    half = wl // 2
    t = x.shape[-1]
    if mode == "interp":
        if wl > t:
            raise ValueError("mode 'interp' needs window_length <= the "
                             f"signal length ({wl} > {t})")
        xp = x
    elif mode in ("mirror", "constant", "nearest", "wrap"):
        pad = [(0, 0)] * (x.ndim - 1) + [(half, half)]
        if mode == "constant":
            xp = jnp.pad(x, pad, constant_values=cval)
        elif mode == "mirror":
            xp = jnp.pad(x, pad, mode="reflect")
        elif mode == "nearest":
            xp = jnp.pad(x, pad, mode="edge")
        else:
            xp = jnp.pad(x, pad, mode="wrap")
    else:
        raise ValueError(f"unknown mode {mode!r}")
    # Valid convolution with the (short) SG kernel: shifted FMAs fuse
    # into one elementwise pass; the kernel taps are trace-time constants.
    n_out = xp.shape[-1] - wl + 1
    y = jnp.zeros(xp.shape[:-1] + (n_out,), dtype=x.dtype)
    for j in range(wl):
        y = y + cj[wl - 1 - j] * xp[..., j: j + n_out]
    if mode != "interp":
        return y
    e_left, e_right = _savgol_edge_maps_f64(wl, int(polyorder), int(deriv),
                                            float(delta))
    yl = jnp.einsum("ij,...j->...i", jnp.asarray(e_left, x.dtype),
                    x[..., :wl])
    yr = jnp.einsum("ij,...j->...i", jnp.asarray(e_right, x.dtype),
                    x[..., -wl:])
    # Interior valid outputs are exactly indices [half, t-half).
    return jnp.concatenate([yl, y, yr], axis=-1)


def order_filter(x: jnp.ndarray, domain, rank: int) -> jnp.ndarray:
    """Rank-order filter (scipy.signal.order_filter semantics): at each
    position, gather the neighbors where ``domain`` is nonzero, sort,
    and keep the ``rank``-th (0-based) — median/erosion/dilation as
    special cases.  ``domain`` is a 1-D or 2-D odd-sized mask applied
    over the trailing axes (leading axes batch, the framework-wide
    convention; with matching ndim this is exactly scipy).  Zero-padded
    edges.  Formulation: one shifted-slice stack (static slices, no
    gather) + jnp.sort over the small neighbor axis.

    Known upstream deviation: scipy 1.17's order_filter delegates to
    ndimage.rank_filter, which IGNORES zeros inside the footprint
    (verified here: footprint [1,0,1,1,1] gives output identical to the
    full size-5 window).  This implementation honors the documented
    semantics — the rank is taken over the domain-selected neighbors
    only — so results differ from scipy 1.17 exactly when the domain
    has interior holes (tests pin both behaviors)."""
    dom = np.asarray(domain)
    if dom.ndim not in (1, 2):
        raise ValueError("domain must be 1-D or 2-D")
    if any(s % 2 == 0 for s in dom.shape):
        raise ValueError(f"domain sides must be odd, got {dom.shape}")
    sel = np.argwhere(dom != 0)
    nsel = sel.shape[0]
    if not 0 <= rank < nsel:
        raise ValueError(f"rank {rank} out of range for {nsel} active "
                         "domain elements")
    if dom.ndim == 1:
        k = dom.shape[0]
        half = k // 2
        t = x.shape[-1]
        xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(half, half)])
        stack = jnp.stack([xp[..., int(j): int(j) + t] for (j,) in sel],
                          axis=-1)
    else:
        kh, kw = dom.shape
        hh, hw = kh // 2, kw // 2
        h, w = x.shape[-2:]
        xp = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(hh, hh), (hw, hw)])
        stack = jnp.stack(
            [xp[..., int(i): int(i) + h, int(j): int(j) + w]
             for i, j in sel], axis=-1)
    return jnp.sort(stack, axis=-1)[..., rank]


def medfilt(x: jnp.ndarray, kernel_size: int = 3) -> jnp.ndarray:
    """Sliding-window median over the last axis, zero-padded edges
    (scipy.signal.medfilt semantics; odd kernel_size)."""
    k = int(kernel_size)
    if k % 2 != 1 or k < 1:
        raise ValueError(f"kernel_size must be odd and >= 1, got {k}")
    if k == 1:
        return x
    half = k // 2
    pad = [(0, 0)] * (x.ndim - 1) + [(half, half)]
    xp = jnp.pad(x, pad)
    t = x.shape[-1]
    stack = jnp.stack([xp[..., j: j + t] for j in range(k)], axis=-1)
    return jnp.median(stack, axis=-1)


def medfilt2d(x: jnp.ndarray, kernel_size: Union[int, Tuple[int, int]] = 3
              ) -> jnp.ndarray:
    """2-D sliding median over the last two axes, zero-padded edges
    (scipy.signal.medfilt2d semantics; odd kernel dims)."""
    if isinstance(kernel_size, int):
        kh = kw = int(kernel_size)
    else:
        kh, kw = (int(v) for v in kernel_size)
    if kh % 2 != 1 or kw % 2 != 1 or kh < 1 or kw < 1:
        raise ValueError(f"kernel dims must be odd, got ({kh}, {kw})")
    pad = [(0, 0)] * (x.ndim - 2) + [(kh // 2, kh // 2), (kw // 2, kw // 2)]
    xp = jnp.pad(x, pad)
    h, w = x.shape[-2:]
    windows = [xp[..., i: i + h, j: j + w]
               for i in range(kh) for j in range(kw)]
    return jnp.median(jnp.stack(windows, axis=-1), axis=-1)


def wiener(x: jnp.ndarray, mysize: Union[int, Tuple[int, ...], None] = None,
           noise: Optional[float] = None) -> jnp.ndarray:
    """Adaptive Wiener filter (scipy.signal.wiener semantics) over the
    last one (1-D input) or two (2-D input) axes; local moments via box
    convolutions, noise power estimated as the mean local variance when
    not given."""
    nd = min(x.ndim, 2)
    if mysize is None:
        sizes = (3,) * nd
    elif isinstance(mysize, int):
        sizes = (mysize,) * nd
    else:
        sizes = tuple(int(v) for v in mysize)
        if len(sizes) != nd:
            raise ValueError(f"mysize {sizes} must have {nd} entries")
    count = float(np.prod(sizes))

    def box(img):
        if nd == 1:
            k = int(sizes[0])
            half = k // 2
            pad = [(0, 0)] * (img.ndim - 1) + [(half, k - 1 - half)]
            ip = jnp.pad(img, pad)
            t = img.shape[-1]
            acc = jnp.zeros_like(img)
            for j in range(k):
                acc = acc + ip[..., j: j + t]
            return acc
        kh, kw = sizes
        pad = [(0, 0)] * (img.ndim - 2) + [
            (kh // 2, kh - 1 - kh // 2), (kw // 2, kw - 1 - kw // 2)]
        ip = jnp.pad(img, pad)
        h, w = img.shape[-2:]
        acc = jnp.zeros_like(img)
        for i in range(kh):
            for j in range(kw):
                acc = acc + ip[..., i: i + h, j: j + w]
        return acc

    l_mean = box(x) / count
    l_var = box(x * x) / count - l_mean * l_mean
    if noise is None:
        noise_p = jnp.mean(l_var, axis=tuple(range(x.ndim - nd, x.ndim)),
                           keepdims=True)
    else:
        noise_p = jnp.asarray(noise, dtype=x.dtype)
    out = l_mean + (x - l_mean) * (1.0 - noise_p / l_var)
    return jnp.where(l_var < noise_p, l_mean, out)


def detrend(x: jnp.ndarray, *, type: str = "linear") -> jnp.ndarray:
    """Remove the least-squares line ('linear') or the mean ('constant')
    over the last axis (scipy.signal.detrend semantics, batched)."""
    if type in ("constant", "c"):
        return x - jnp.mean(x, axis=-1, keepdims=True)
    if type in ("linear", "l"):
        n = x.shape[-1]
        t = np.arange(n, dtype=np.float64)
        basis = np.stack([np.ones(n), t], axis=1)
        pinv = np.linalg.pinv(basis)
        coef = jnp.einsum("cn,...n->...c", jnp.asarray(pinv, x.dtype), x)
        return x - jnp.einsum("nc,...c->...n", jnp.asarray(basis, x.dtype),
                              coef)
    raise ValueError(f"unknown detrend type {type!r}")
