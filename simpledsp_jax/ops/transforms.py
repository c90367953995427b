"""Extended spectral transforms: chirp-z / Bluestein, zoom FFT, DCT,
Hilbert / analytic signal, Goertzel.

These widen the framework's FFT family beyond the reference's power-of-2/4
sizes (reference: include/sdsp/fft.h:261,304 static_asserts) the matmul way:
every transform reduces to dense matmuls / power-of-2 four-step FFTs
(ops/fft.py) plus elementwise chirp multiplies, with all chirp/phase tables
precomputed host-side in float64 — the trace-time analog of the reference's
constexpr twiddle tables (fft.h:197-214).

Capabilities (validated against scipy.fft / scipy.signal in tests):

* ``czt`` / ``czt_ri`` — chirp-z transform (Bluestein's algorithm): samples
  ``X[k] = sum_n x[n] a^{-n} w^{nk}`` on any logarithmic spiral.  With
  ``w = exp(-2j pi / n), a = 1`` this IS the arbitrary-length DFT, which is
  how :func:`simpledsp_jax.ops.fft.fft` transparently supports sizes with
  prime factors > 128.
* ``zoom_fft`` — band-limited spectral zoom (CZT on a unit-circle arc),
  scipy.signal.zoom_fft semantics.
* ``dct`` / ``idct`` — DCT-II/III (scipy norms ``None`` / ``"ortho"``) via
  Makhoul's length-N real-FFT method: one rfft + O(N) twiddle work, any N.
* ``hilbert`` / ``analytic_ri`` — analytic signal (one-sided spectrum
  doubling); the imaginary plane is the Hilbert transform.
* ``goertzel`` / ``goertzel_ri`` — selected-bin DFT as ONE dense matmul
  against trace-time cos/sin rows (the batched-matmul analog of the
  classic single-bin recurrence, which would serialize).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from simpledsp_jax.ops.fft import fft_ri, ifft_ri, rfft_ri

__all__ = [
    "czt", "czt_ri", "czt_points", "zoom_fft", "zoom_fft_ri",
    "CZT", "ZoomFFT",
    "dct", "idct", "hilbert", "analytic_ri", "hilbert2", "hilbert2_ri",
    "goertzel", "goertzel_ri",
]


class CZT:
    """Callable chirp-z transform plan for fixed (n, m, w, a)
    (scipy.signal.CZT semantics) over the framework's czt engine; the
    per-plan tables are cached by the underlying jit."""

    def __init__(self, n: int, m: "int | None" = None, w=None,
                 a: complex = 1.0 + 0.0j):
        self.n = int(n)
        if self.n < 1:
            raise ValueError("n must be positive")
        self.m = self.n if m is None else int(m)
        if self.m < 1:
            raise ValueError("m must be positive")
        if w is None:
            w = np.exp(-2j * np.pi / self.m)
        self.w = complex(w)
        self.a = complex(a)

    def __call__(self, x, *, axis: int = -1):
        x = jnp.asarray(x)
        if x.shape[axis] != self.n:
            raise ValueError(
                f"CZT defined for length {self.n}, got {x.shape[axis]}")
        if axis not in (-1, x.ndim - 1):
            x = jnp.moveaxis(x, axis, -1)
        y = czt(x, self.m, w=self.w, a=self.a)
        return y if axis in (-1, x.ndim - 1) else jnp.moveaxis(y, -1, axis)

    def points(self) -> np.ndarray:
        """The m z-plane evaluation points of this plan."""
        return czt_points(self.m, self.w, self.a)


class ZoomFFT(CZT):
    """Callable zoom-FFT plan (scipy.signal.ZoomFFT semantics): the CZT
    specialized to a frequency band [f1, f2] of the fs-periodic
    spectrum."""

    def __init__(self, n: int, fn, m: "int | None" = None, *,
                 fs: float = 2.0, endpoint: bool = False):
        n = int(n)
        fn = np.atleast_1d(np.asarray(fn, dtype=np.float64))
        if fn.size == 2:
            f1, f2 = float(fn[0]), float(fn[1])
        elif fn.size == 1:
            f1, f2 = 0.0, float(fn[0])
        else:
            raise ValueError("fn must be one or two frequencies")
        m = n if m is None else int(m)
        # Same arc construction as zoom_fft_ri (endpoint=True stretches
        # the span so f2 lands on the last of the m samples).
        span = ((f2 - f1) * m / (m - 1)) if (endpoint and m > 1)             else (f2 - f1)
        w = np.exp(-2j * np.pi * span / (fs * m))
        a = np.exp(2j * np.pi * f1 / fs)
        super().__init__(n, m, w=w, a=a)
        self.f1, self.f2, self.fs = f1, f2, float(fs)


def czt_points(m: int, w=None, a: complex = 1.0 + 0.0j) -> np.ndarray:
    """The m z-plane evaluation points a * w**(-k) of a CZT
    (scipy.signal.czt_points semantics; host-side metadata)."""
    m = int(m)
    if m < 1:
        raise ValueError(f"m must be positive, got {m}")
    k = np.arange(m)
    if w is None:
        return a * np.exp(2j * np.pi * k / m)
    return a * np.asarray(w, dtype=np.complex128) ** -k


# ---------------------------------------------------------------------------
# Chirp-z transform (Bluestein)
# ---------------------------------------------------------------------------

def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.lru_cache(maxsize=None)
def _czt_tables_f64(n: int, m: int, wre: float, wim: float,
                    are: float, aim: float,
                    exact_denom: Optional[int]):
    """Host float64 chirp tables for an (n -> m) CZT with ratio w, start a.

    Returns (qr, qi, Br, Bi, pr, pi, L):
      q[j]  = a^{-j} w^{+j^2/2}, j < n      (input chirp, premultiply)
      B     = fft(b, L) with b the circularly-wrapped 1/chirp filter
              b[k] = w^{-k^2/2} for k in (-n, m)   (length-L constant)
      p[k]  = w^{+k^2/2}, k < m             (output chirp, postmultiply)

    When ``exact_denom = N`` is given, w is taken as exp(sign * i pi / N)
    with sign from (wre, wim)'s angle and the squared indices are reduced
    mod 2N in EXACT integer arithmetic before the single trig evaluation —
    the same accuracy device as ops.fft._dft_mats_f64 (large-k chirp phases
    otherwise lose ~k^2 eps of precision).  This is the path the arbitrary-N
    DFT fallback uses.
    """
    j = np.arange(max(n, m), dtype=np.int64)
    if exact_denom is not None:
        # w = exp(sign * 1j * pi / exact_denom); chirp phase = sign*pi*j^2/N
        # with j^2 reduced mod 2N (exp period in j^2).
        sign = 1.0 if wim > 0 else -1.0
        red = (j * j) % (2 * exact_denom)
        ang = (sign * np.pi / exact_denom) * red
        chr_, chi = np.cos(ang), np.sin(ang)          # w^{+j^2/2}
        mag_pow = np.ones_like(chr_)
    else:
        wang = np.arctan2(wim, wre)
        wmag = np.hypot(wre, wim)
        half_sq = 0.5 * (j.astype(np.float64) ** 2)
        ang = wang * half_sq
        chr_, chi = np.cos(ang), np.sin(ang)
        mag_pow = wmag ** half_sq
    # w^{+j^2/2} and its reciprocal w^{-j^2/2} (unit-|w| reciprocal is the
    # conjugate; general case divides the magnitude power).
    wp_r, wp_i = chr_ * mag_pow, chi * mag_pow
    with np.errstate(divide="ignore"):
        inv_mag = np.where(mag_pow > 0, 1.0 / mag_pow, 0.0)
    wm_r, wm_i = chr_ * inv_mag, -chi * inv_mag

    # Input chirp q[j] = a^{-j} w^{+j^2/2}.
    aang = np.arctan2(aim, are)
    amag = np.hypot(are, aim)
    ja = np.arange(n, dtype=np.float64)
    aa = -aang * ja
    with np.errstate(divide="ignore"):
        am = amag ** (-ja)
    ar_, ai_ = np.cos(aa) * am, np.sin(aa) * am
    qr = ar_ * wp_r[:n] - ai_ * wp_i[:n]
    qi = ar_ * wp_i[:n] + ai_ * wp_r[:n]

    # Circular filter b and its length-L DFT (host-side, f64).
    L = _next_pow2(n + m - 1)
    br = np.zeros(L)
    bi = np.zeros(L)
    br[:m], bi[:m] = wm_r[:m], wm_i[:m]
    if n > 1:
        br[L - n + 1:] = wm_r[1:n][::-1]
        bi[L - n + 1:] = wm_i[1:n][::-1]
    B = np.fft.fft(br + 1j * bi)
    return (qr, qi, np.ascontiguousarray(B.real),
            np.ascontiguousarray(B.imag), wp_r[:m], wp_i[:m], L)


def czt_ri(xr: jnp.ndarray, xi: jnp.ndarray, m: Optional[int] = None, *,
           w: Optional[complex] = None, a: complex = 1.0 + 0.0j,
           _exact_denom: Optional[int] = None,
           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Chirp-z transform over the last axis on (re, im) float planes.

    ``X[k] = sum_n x[n] a^{-n} w^{nk}`` for k < m (scipy.signal.czt
    semantics; default w = exp(-2j pi / m) makes it an m-point DFT-like
    sweep of the unit circle).  Bluestein factorization: the nk product
    becomes (n^2 + k^2 - (k - n)^2) / 2, turning the transform into chirp
    premultiply -> length-L circular convolution (one forward + one inverse
    power-of-2 FFT; the filter's DFT is a host-side constant) -> chirp
    postmultiply.  All tables are float64 trace-time constants.
    """
    n = xr.shape[-1]
    if m is None:
        m = n
    if w is None:
        # Default ratio is exactly exp(-2j pi / m): use the exact-integer
        # phase-reduction table path (generic chirp tables lose ~k^2 eps).
        w = np.exp(-2j * np.pi / m)
        if _exact_denom is None:
            _exact_denom = m
    dtype = xr.dtype
    qr64, qi64, Br64, Bi64, pr64, pi64, L = _czt_tables_f64(
        n, m, float(np.real(w)), float(np.imag(w)),
        float(np.real(a)), float(np.imag(a)), _exact_denom)
    qr = jnp.asarray(qr64, dtype=dtype)
    qi = jnp.asarray(qi64, dtype=dtype)
    # Chirp premultiply, zero-pad to L.
    yr = xr * qr - xi * qi
    yi = xr * qi + xi * qr
    pad = [(0, 0)] * (yr.ndim - 1) + [(0, L - n)]
    yr = jnp.pad(yr, pad)
    yi = jnp.pad(yi, pad)
    # Circular convolution with the host-precomputed filter spectrum.
    fr, fi = fft_ri(yr, yi)
    Br = jnp.asarray(Br64, dtype=dtype)
    Bi = jnp.asarray(Bi64, dtype=dtype)
    gr = fr * Br - fi * Bi
    gi = fr * Bi + fi * Br
    cr, ci = ifft_ri(gr, gi)
    cr = cr[..., :m]
    ci = ci[..., :m]
    # Chirp postmultiply.
    pr = jnp.asarray(pr64, dtype=dtype)
    pi_ = jnp.asarray(pi64, dtype=dtype)
    return cr * pr - ci * pi_, cr * pi_ + ci * pr


def czt(x: jnp.ndarray, m: Optional[int] = None, *,
        w: Optional[complex] = None, a: complex = 1.0 + 0.0j,
        dtype=None) -> jnp.ndarray:
    """Complex-dtype wrapper over :func:`czt_ri` (scipy.signal.czt API)."""
    from simpledsp_jax.ops.fft import _as_ri, _pick_real_dtype
    rdt = _pick_real_dtype(x, dtype)
    xr, xi = _as_ri(x, rdt)
    yr, yi = czt_ri(xr, xi, m, w=w, a=a)
    return jax.lax.complex(yr, yi)


def zoom_fft_ri(xr: jnp.ndarray, xi: jnp.ndarray,
                fn: Union[float, Sequence[float]], m: Optional[int] = None,
                *, fs: float = 2.0, endpoint: bool = False,
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Band-limited spectral zoom on (re, im) planes: m DFT samples on the
    unit-circle arc [f1, f2] (scipy.signal.zoom_fft semantics, including
    ``endpoint=False`` — f2 itself is excluded; ``fn`` a scalar means
    [0, fn]).  A CZT with |w| = |a| = 1."""
    n = xr.shape[-1]
    if m is None:
        m = n
    f1, f2 = (0.0, float(fn)) if np.isscalar(fn) else map(float, fn)
    span = ((f2 - f1) * m / (m - 1)) if (endpoint and m > 1) else (f2 - f1)
    w = np.exp(-2j * np.pi * span / (fs * m))
    a = np.exp(2j * np.pi * f1 / fs)
    return czt_ri(xr, xi, m, w=w, a=a)


def zoom_fft(x: jnp.ndarray, fn, m: Optional[int] = None, *,
             fs: float = 2.0, endpoint: bool = False,
             dtype=None) -> jnp.ndarray:
    """Complex-dtype wrapper over :func:`zoom_fft_ri`."""
    from simpledsp_jax.ops.fft import _as_ri, _pick_real_dtype
    rdt = _pick_real_dtype(x, dtype)
    xr, xi = _as_ri(x, rdt)
    yr, yi = zoom_fft_ri(xr, xi, fn, m, fs=fs, endpoint=endpoint)
    return jax.lax.complex(yr, yi)


# ---------------------------------------------------------------------------
# DCT-II / DCT-III (Makhoul single-FFT method)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dct_phase_f64(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin of pi k / (2 n), k < n, exact-integer phase reduction."""
    k = np.arange(n, dtype=np.int64) % (4 * n)
    ang = (np.pi / (2 * n)) * k
    return np.cos(ang), np.sin(ang)


def _full_spectrum_from_rfft(vr, vi, n):
    """Mirror one-sided (n//2+1) real-input FFT planes to all n bins."""
    lo = n // 2 + 1
    tr = vr[..., 1:n - lo + 1][..., ::-1]
    ti = -vi[..., 1:n - lo + 1][..., ::-1]
    return (jnp.concatenate([vr, tr], axis=-1),
            jnp.concatenate([vi, ti], axis=-1))


def dct(x: jnp.ndarray, type: int = 2, *, norm: Optional[str] = None
        ) -> jnp.ndarray:
    """DCT over the last axis of a REAL array (scipy.fft.dct types 2 and 3,
    norm ``None`` or ``"ortho"``), any length.

    Type 2 (Makhoul): reorder x into v = [x[0::2]; reversed(x[1::2])], one
    length-N real FFT, then ``X[k] = 2 (cos(pi k/2N) Re V[k] +
    sin(pi k/2N) Im V[k])`` — the length-4N zero-padding trick collapsed to
    N.  Type 3 is the transpose, computed by running the inverse chain.
    """
    if jnp.iscomplexobj(x):
        raise ValueError("dct expects a real array")
    n = x.shape[-1]
    cos64, sin64 = _dct_phase_f64(n)
    cosk = jnp.asarray(cos64, dtype=x.dtype)
    sink = jnp.asarray(sin64, dtype=x.dtype)
    half = (n + 1) // 2
    if type == 2:
        v = jnp.concatenate([x[..., 0::2], x[..., 1::2][..., ::-1]],
                            axis=-1)
        vr, vi = rfft_ri(v)
        vr, vi = _full_spectrum_from_rfft(vr, vi, n)
        y = 2.0 * (cosk * vr + sink * vi)
        if norm == "ortho":
            s = np.full(n, np.sqrt(1.0 / (2 * n)))
            s[0] = np.sqrt(1.0 / (4 * n))
            y = y * jnp.asarray(s, dtype=x.dtype)
        elif norm is not None:
            raise ValueError(f"unsupported norm {norm!r}")
        return y
    if type == 3:
        y = x
        if norm == "ortho":
            # Transpose of the ortho DCT-II: z[0] = y[0]/sqrt(N),
            # z[k>=1] = y[k]/sqrt(2N) feed the unnormalized type-3 chain.
            s = np.full(n, np.sqrt(1.0 / (2 * n)))
            s[0] = np.sqrt(1.0 / n)
            y = y * jnp.asarray(s, dtype=x.dtype)
        elif norm is not None:
            raise ValueError(f"unsupported norm {norm!r}")
        # U[k] = (y[k] - i y_rev[k]) e^{i pi k / 2N}, y_rev = [0, y[N-1:0:-1]]
        yrev = jnp.concatenate(
            [jnp.zeros_like(y[..., :1]), -y[..., 1:][..., ::-1]], axis=-1)
        ur = y * cosk - yrev * sink
        ui = y * sink + yrev * cosk
        vr, _ = fft_ri(ur, -ui)          # ifft * N == conj(fft(conj(U)))
        # v real (U has the required symmetry); undo the even/odd reorder.
        out = jnp.zeros_like(y)
        out = out.at[..., 0::2].set(vr[..., :half])
        out = out.at[..., 1::2].set(vr[..., half:][..., ::-1])
        if norm == "ortho":
            return out
        return out
    raise ValueError(f"unsupported DCT type {type} (have 2, 3)")


def idct(x: jnp.ndarray, type: int = 2, *, norm: Optional[str] = None
         ) -> jnp.ndarray:
    """Inverse DCT (scipy.fft.idct): idct(type=2) = dct(type=3) scaled."""
    n = x.shape[-1]
    if type == 2:
        if norm == "ortho":
            return dct(x, type=3, norm="ortho")
        return dct(x, type=3) * (1.0 / (2.0 * n))
    if type == 3:
        if norm == "ortho":
            return dct(x, type=2, norm="ortho")
        return dct(x, type=2) * (1.0 / (2.0 * n))
    raise ValueError(f"unsupported IDCT type {type} (have 2, 3)")


# ---------------------------------------------------------------------------
# Analytic signal / Hilbert transform
# ---------------------------------------------------------------------------

def analytic_ri(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Analytic signal of a real array over the last axis, as (re, im)
    planes: re == x (up to rounding), im == the Hilbert transform.

    One-sided construction (scipy.signal.hilbert): keep DC and (even N)
    Nyquist, double bins 0 < k < N/2, zero the negative half, inverse FFT.
    Runs as rfft + scaled Hermitian mirror + ifft.
    """
    if jnp.iscomplexobj(x):
        raise ValueError("analytic_ri expects a real array")
    n = x.shape[-1]
    vr, vi = rfft_ri(x)
    nb = vr.shape[-1]
    scale = np.full(nb, 2.0)
    scale[0] = 1.0
    if n % 2 == 0:
        scale[-1] = 1.0
    sc = jnp.asarray(scale, dtype=x.dtype)
    ur = vr * sc
    ui = vi * sc
    pad = [(0, 0)] * (x.ndim - 1) + [(0, n - nb)]
    return ifft_ri(jnp.pad(ur, pad), jnp.pad(ui, pad))


def hilbert(x: jnp.ndarray) -> jnp.ndarray:
    """Complex analytic signal (scipy.signal.hilbert semantics)."""
    yr, yi = analytic_ri(x)
    return jax.lax.complex(yr, yi)


def hilbert2_ri(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """2-D analytic signal over the last two axes as (re, im) planes
    (scipy.signal.hilbert2 "single-orthant" semantics): fft2, multiply
    by the separable per-axis one-sided step weights h1[u] h2[v]
    (1 at DC, 2 for 1 <= k < (N+1)//2, 0 elsewhere — the even-N Nyquist
    bin is ZEROED, unlike the 1-D hilbert), inverse fft2.  The weight
    grid is a host-f64 rank-1 constant folded into the jitted program."""
    from simpledsp_jax.ops.fft import fft2_ri, ifft2_ri

    if jnp.iscomplexobj(x):
        raise ValueError("hilbert2_ri expects a real array")
    if x.ndim < 2:
        raise ValueError("hilbert2_ri needs at least 2 dims")

    def axis_weights(n: int) -> np.ndarray:
        w = np.zeros(n)
        w[0] = 1.0
        w[1:(n + 1) // 2] = 2.0
        return w

    h, w_ = x.shape[-2:]
    grid = np.outer(axis_weights(h), axis_weights(w_))
    ur, ui = fft2_ri(x, jnp.zeros_like(x))
    g = jnp.asarray(grid, dtype=x.dtype)
    return ifft2_ri(ur * g, ui * g)


def hilbert2(x: jnp.ndarray) -> jnp.ndarray:
    """Complex 2-D analytic signal (scipy.signal.hilbert2 semantics)."""
    yr, yi = hilbert2_ri(x)
    return jax.lax.complex(yr, yi)


# ---------------------------------------------------------------------------
# Goertzel (selected-bin DFT)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _goertzel_rows_f64(n: int, bins: Tuple[int, ...]):
    k = np.asarray(bins, dtype=np.int64).reshape(-1, 1)
    j = np.arange(n, dtype=np.int64).reshape(1, -1)
    red = (k * j) % n
    ang = (-2.0 * np.pi / n) * red
    return np.cos(ang), np.sin(ang)


def goertzel_ri(x: jnp.ndarray, bins: Sequence[int]
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """DFT at selected bins of a REAL signal: (..., n) -> (..., len(bins)).

    The classic Goertzel filter is a per-sample recurrence — hostile to a
    vector machine — but its entire purpose (a few bins cheaper than a
    full FFT) is a short-fat matmul: X[b] = x @ [cos; -sin] rows, trace-time
    constants with exact mod-n phase reduction.
    """
    n = x.shape[-1]
    cr64, si64 = _goertzel_rows_f64(n, tuple(int(b) for b in bins))
    cr = jnp.asarray(cr64.T, dtype=x.dtype)
    si = jnp.asarray(si64.T, dtype=x.dtype)
    dot = functools.partial(jnp.dot, precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=x.dtype)
    return dot(x, cr), dot(x, si)


def goertzel(x: jnp.ndarray, bins: Sequence[int]) -> jnp.ndarray:
    """Complex DFT values at selected bins (see :func:`goertzel_ri`)."""
    yr, yi = goertzel_ri(x, bins)
    return jax.lax.complex(yr, yi)
