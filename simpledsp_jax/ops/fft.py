"""Batched FFT/IFFT as a four-step matmul factorization.

Reference capability being reproduced: in-place radix-2 / radix-4 complex FFT
and IFFT on power-of-2 / power-of-4 sizes with compile-time twiddle tables
(reference: include/sdsp/fft.h:258-360; direction policies fft.h:121-146 —
forward is unscaled, inverse conjugates twiddles and scales by 1/N).

Design
------
Instead of emulating the reference's butterfly networks and bit-reversal
permutations, the engine uses the four-step (Bailey/Cooley-Tukey)
factorization

    N = N1 * N2,  x -> reshape (N1, N2)
    1. DFT_N1 along axis -2            (dense matmul)
    2. twiddle by exp(-+ 2 pi i k1 n2 / N)   (elementwise, fuses)
    3. DFT_N2 along axis -1            (dense matmul)
    4. transpose (k1, k2) -> (k2, k1) and flatten

applied recursively until factors are <= _MAX_DFT, at which point the DFT is
a single small matmul with a precomputed (trace-time constant) DFT matrix —
the analog of the reference's constexpr twiddle tables (fft.h:197-214).  The
permutation the reference does with digit-reversal swap tables (fft.h:217-256)
becomes the step-4 transpose, which XLA lays out efficiently.

Complex arithmetic is carried as explicit (re, im) float pairs so every matmul
is a real matmul.  Public entry points accept and return complex dtypes for
API convenience.

Everything is batched over leading axes; there is no single-FFT fast path
because throughput comes from batch.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["fft", "ifft", "rfft", "irfft", "fft_ri", "ifft_ri",
           "rfft_ri", "irfft_ri", "pack_rfft_ri", "unpack_rfft_ri",
           "fft_radix2", "fft_radix4", "dft_matrix",
           "fft2", "ifft2", "fft2_ri", "ifft2_ri", "rfft2_ri",
           "irfft2_ri"]

# Largest size computed as one dense DFT matmul; 4096 = 64*64 -> one
# recursion level.
_MAX_DFT = 128


from simpledsp_jax.utils.intmath import is_power_of as _is_power_of


@functools.lru_cache(maxsize=None)
def _dft_mats_f64(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, -sin) parts of the forward DFT matrix W[k, j] = e^{-2 pi i kj/n}.

    The phase index k*j is reduced mod n in exact integer arithmetic before
    scaling by 2 pi / n, so the trig argument never exceeds one turn — the
    float64 analog of the reference's quarter-wave-symmetric table builder
    (reference: include/sdsp/fft.h:148-194), which exists for the same
    accuracy reason.
    """
    k = np.arange(n, dtype=np.int64)
    red = np.outer(k, k) % n
    ang = (-2.0 * np.pi / n) * red
    return np.cos(ang), np.sin(ang)


def dft_matrix(n: int, inverse: bool = False, dtype=np.float64):
    """Dense DFT matrix as an (re, im) pair of real matrices (host-side)."""
    cr, si = _dft_mats_f64(n)
    if inverse:
        return cr.astype(dtype), (-si).astype(dtype)
    return cr.astype(dtype), si.astype(dtype)


@functools.lru_cache(maxsize=None)
def _twiddle_f64(n1: int, n2: int) -> Tuple[np.ndarray, np.ndarray]:
    """Step-2 twiddles T[k1, n2] = e^{-2 pi i k1 n2 / (n1 n2)}, with the
    phase index reduced mod n1*n2 exactly (see _dft_mats_f64)."""
    n = n1 * n2
    red = np.outer(np.arange(n1, dtype=np.int64),
                   np.arange(n2, dtype=np.int64)) % n
    ang = (-2.0 * np.pi / n) * red
    return np.cos(ang), np.sin(ang)


def _split(n: int) -> Tuple[int, int]:
    """Factor n = n1 * n2 with n1 <= _MAX_DFT and factors as square as
    possible (keeps matmul shapes fat)."""
    # balanced split: largest divisor <= sqrt(n) bounded by _MAX_DFT
    d = min(int(np.sqrt(n)), _MAX_DFT)
    while d > 1:
        if n % d == 0 and d <= _MAX_DFT:
            return d, n // d
        d -= 1
    raise ValueError(f"cannot factor N={n} into radices <= {_MAX_DFT}")


def _cmatmul(wr, wi, xr, xi, axis: int):
    """Complex matmul along `axis`:  (wr + i wi) @ (xr + i xi)."""
    if axis == -2:
        spec = "kn,...nm->...km"
    elif axis == -1:
        # "...n" (not "...mn") so rank-1 inputs work: a bare 1-D FFT of
        # size <= _MAX_DFT takes this path directly.
        spec = "kn,...n->...k"
    else:
        raise ValueError(axis)
    dot = functools.partial(jnp.einsum, spec,
                            preferred_element_type=xr.dtype,
                            precision=jax.lax.Precision.HIGHEST)
    yr = dot(wr, xr) - dot(wi, xi)
    yi = dot(wr, xi) + dot(wi, xr)
    return yr, yi


def _fft_ri(xr: jnp.ndarray, xi: jnp.ndarray, inverse: bool):
    """Recursive four-step FFT over the LAST axis on (re, im) float arrays.

    No scaling is applied here (done once at the top level for inverse).
    """
    n = xr.shape[-1]
    dtype = xr.dtype

    if n <= _MAX_DFT:
        wr64, wi64 = dft_matrix(n, inverse=inverse)
        wr = jnp.asarray(wr64, dtype=dtype)
        wi = jnp.asarray(wi64, dtype=dtype)
        return _cmatmul(wr, wi, xr, xi, axis=-1)

    try:
        n1, n2 = _split(n)
    except ValueError:
        # Sizes with prime factors > _MAX_DFT (e.g. prime N): Bluestein's
        # chirp-z factorization over a power-of-2 convolution length —
        # arbitrary-N support the reference's static_asserts exclude
        # (fft.h:261, 304).  Unscaled either direction, matching this
        # function's contract (callers apply the 1/N inverse scale).
        from simpledsp_jax.ops.transforms import czt_ri
        sgn = 1.0 if inverse else -1.0
        return czt_ri(xr, xi, n, w=np.exp(sgn * 2j * np.pi / n),
                      _exact_denom=n)
    xr = xr.reshape(xr.shape[:-1] + (n1, n2))
    xi = xi.reshape(xi.shape[:-1] + (n1, n2))

    # Step 1: DFT_n1 along axis -2 (n1 <= _MAX_DFT by construction).
    wr64, wi64 = dft_matrix(n1, inverse=inverse)
    wr = jnp.asarray(wr64, dtype=dtype)
    wi = jnp.asarray(wi64, dtype=dtype)
    xr, xi = _cmatmul(wr, wi, xr, xi, axis=-2)

    # Step 2: twiddle (conjugated for inverse).
    tr64, ti64 = _twiddle_f64(n1, n2)
    tr = jnp.asarray(tr64, dtype=dtype)
    ti = jnp.asarray(ti64 if not inverse else -ti64, dtype=dtype)
    xr, xi = xr * tr - xi * ti, xr * ti + xi * tr

    # Step 3: DFT_n2 along the last axis — recurse (n2 may still be big).
    xr, xi = _fft_ri(xr, xi, inverse)

    # Step 4: output index k = k1 + n1 k2 -> transpose to (k2, k1), flatten.
    xr = jnp.swapaxes(xr, -1, -2).reshape(xr.shape[:-2] + (n,))
    xi = jnp.swapaxes(xi, -1, -2).reshape(xi.shape[:-2] + (n,))
    return xr, xi


def _as_ri(x: jnp.ndarray, dtype):
    if jnp.iscomplexobj(x):
        return jnp.real(x).astype(dtype), jnp.imag(x).astype(dtype)
    return x.astype(dtype), jnp.zeros_like(x, dtype=dtype)


def _pick_real_dtype(x, dtype):
    if dtype is not None:
        return jnp.dtype(dtype)
    if x.dtype in (jnp.complex128, jnp.float64):
        return jnp.dtype(jnp.float64)
    return jnp.dtype(jnp.float32)


def fft_ri(xr: jnp.ndarray, xi: jnp.ndarray
           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Forward FFT on explicit (re, im) float planes — the native entry
    point.  Complex dtypes never materialize, which keeps every matmul
    real."""
    return _fft_ri(xr, xi, inverse=False)


def ifft_ri(xr: jnp.ndarray, xi: jnp.ndarray
            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Inverse FFT on (re, im) planes: conjugate twiddles + 1/N scaling."""
    yr, yi = _fft_ri(xr, xi, inverse=True)
    scale = jnp.asarray(1.0 / xr.shape[-1], dtype=xr.dtype)
    return yr * scale, yi * scale


def fft(x: jnp.ndarray, *, dtype=None) -> jnp.ndarray:
    """Forward complex FFT over the last axis, batched over leading axes.

    Unscaled, matching the reference's forward policy (fft.h:135-146).
    Returns complex64 (or complex128 when computing in float64).
    """
    rdt = _pick_real_dtype(x, dtype)
    xr, xi = _as_ri(x, rdt)
    yr, yi = _fft_ri(xr, xi, inverse=False)
    return jax.lax.complex(yr, yi)


def ifft(x: jnp.ndarray, *, dtype=None) -> jnp.ndarray:
    """Inverse FFT: conjugate twiddles + 1/N scaling, matching the
    reference's reverse policy (fft.h:121-132)."""
    rdt = _pick_real_dtype(x, dtype)
    xr, xi = _as_ri(x, rdt)
    yr, yi = _fft_ri(xr, xi, inverse=True)
    scale = jnp.asarray(1.0 / x.shape[-1], dtype=rdt)
    return jax.lax.complex(yr * scale, yi * scale)


def fft_radix2(x: jnp.ndarray, *, inverse: bool = False, dtype=None) -> jnp.ndarray:
    """API-parity wrapper for the reference's `fft_radix2` (fft.h:258):
    requires a power-of-2 size.  The result is the mathematical DFT — the
    radix only selected the reference's internal schedule."""
    if not _is_power_of(x.shape[-1], 2):
        raise ValueError(f"fft_radix2 requires power-of-2 size, got {x.shape[-1]}")
    return ifft(x, dtype=dtype) if inverse else fft(x, dtype=dtype)


def fft_radix4(x: jnp.ndarray, *, inverse: bool = False, dtype=None) -> jnp.ndarray:
    """API-parity wrapper for the reference's `fft_radix4` (fft.h:301):
    requires a power-of-4 size."""
    if not _is_power_of(x.shape[-1], 4):
        raise ValueError(f"fft_radix4 requires power-of-4 size, got {x.shape[-1]}")
    return ifft(x, dtype=dtype) if inverse else fft(x, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _half_twiddle_f64(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, -sin) of W[k] = e^{-2 pi i k / n} for k = 0..n//2 inclusive —
    the Hermitian post-twiddle of the real-input split-radix step."""
    k = np.arange(n // 2 + 1, dtype=np.int64)
    ang = (-2.0 * np.pi / n) * k
    return np.cos(ang), np.sin(ang)


def rfft_ri(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """True half-spectrum real-input FFT on float planes:
    (..., N) real -> (re, im) planes of the N//2+1 non-negative bins.

    Even N runs at HALF the full transform's cost: the N real samples are
    packed as N/2 complex (even samples real plane, odd samples imaginary
    plane), one N/2-point complex FFT runs, and the Hermitian post-twiddle

        X[k] = E[k] - i W^k O[k],   W = e^{-2 pi i / N},
        E = (Z[k] + conj(Z[N/2-k]))/2,  O = (Z[k] - conj(Z[N/2-k]))/2

    recovers the half spectrum (elementwise work).  Odd N falls back
    to the full transform + slice.
    """
    n = x.shape[-1]
    nb = n // 2 + 1
    if n % 2 or n < 4:
        yr, yi = _fft_ri(x, jnp.zeros_like(x), inverse=False)
        return yr[..., :nb], yi[..., :nb]
    zr, zi = _fft_ri(x[..., 0::2], x[..., 1::2], inverse=False)
    # Extend with Z[N/2] := Z[0] so k and N/2-k index one array of nb bins.
    zr = jnp.concatenate([zr, zr[..., :1]], axis=-1)
    zi = jnp.concatenate([zi, zi[..., :1]], axis=-1)
    rr, ri_ = zr[..., ::-1], zi[..., ::-1]       # Z[N/2-k]
    er, ei = 0.5 * (zr + rr), 0.5 * (zi - ri_)   # even part E
    orr, oi = 0.5 * (zr - rr), 0.5 * (zi + ri_)  # odd part O
    wc, ws = _half_twiddle_f64(n)
    wr = jnp.asarray(wc, dtype=x.dtype)
    wi = jnp.asarray(ws, dtype=x.dtype)
    # X = E - i (wr + i wi) O
    yr = er + (wr * oi + wi * orr)
    yi = ei - (wr * orr - wi * oi)
    return yr, yi


def irfft_ri(xr: jnp.ndarray, xi: jnp.ndarray,
             n: Optional[int] = None) -> jnp.ndarray:
    """Inverse of :func:`rfft_ri`: (re, im) planes of N//2+1 bins -> the
    length-n real signal.  Even n inverts the half-size packing (half the
    full transform's cost); other lengths reconstruct the full Hermitian
    spectrum and take the real part of a full inverse."""
    nb = xr.shape[-1]
    if n is None:
        n = 2 * (nb - 1)
    if n % 2 or n != 2 * (nb - 1) or n < 4:
        tail_r = xr[..., 1: n - nb + 1][..., ::-1]
        tail_i = -xi[..., 1: n - nb + 1][..., ::-1]
        fr = jnp.concatenate([xr, tail_r], axis=-1)
        fi = jnp.concatenate([xi, tail_i], axis=-1)
        yr, _ = ifft_ri(fr, fi)
        return yr
    ar, ai = xr[..., :-1], xi[..., :-1]            # X[k], k = 0..N/2-1
    br = xr[..., 1:][..., ::-1]                    # X[N/2-k]
    bi = xi[..., 1:][..., ::-1]
    er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
    orr, oi = 0.5 * (ar - br), 0.5 * (ai + bi)
    wc, ws = _half_twiddle_f64(n)
    wr = jnp.asarray(wc[:-1], dtype=xr.dtype)
    wp = jnp.asarray(-ws[:-1], dtype=xr.dtype)     # +sin: W^{+k}
    # Z = E + i (wr + i wp) O
    zr = er - (wr * oi + wp * orr)
    zi = ei + (wr * orr - wp * oi)
    zr, zi = ifft_ri(zr, zi)
    return jnp.stack([zr, zi], axis=-1).reshape(zr.shape[:-1] + (n,))


def pack_rfft_ri(yr: jnp.ndarray, yi: jnp.ndarray
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pack a pure one-sided spectrum ((..., N/2+1) planes, even N) into the
    FFTW-halfcomplex-style N/2-bin form the north-star chain emits:
    DC..bin N/2-1 in both planes, with X[N/2].re (real for real input)
    stored in the imag plane's bin-0 slot (Im X[0] == 0)."""
    pr = yr[..., :-1]
    pi = jnp.concatenate([yr[..., -1:], yi[..., 1:-1]], axis=-1)
    return pr, pi


def unpack_rfft_ri(pr: jnp.ndarray, pi: jnp.ndarray
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Inverse of :func:`pack_rfft_ri`: (..., N/2) packed planes ->
    (..., N/2+1) pure one-sided (re, im) planes."""
    zero = jnp.zeros_like(pi[..., :1])
    yr = jnp.concatenate([pr, pi[..., :1]], axis=-1)
    yi = jnp.concatenate([zero, pi[..., 1:], zero], axis=-1)
    return yr, yi


def rfft(x: jnp.ndarray, *, dtype=None) -> jnp.ndarray:
    """FFT of real input returning the N//2+1 non-negative-frequency bins
    (numpy.fft.rfft semantics).  Even sizes route through the half-size
    packed transform (:func:`rfft_ri` — half the flops of :func:`fft`);
    complex output dtype follows :func:`fft`."""
    rdt = _pick_real_dtype(x, dtype)
    yr, yi = rfft_ri(x.astype(rdt))
    return jax.lax.complex(yr, yi)


def irfft(x: jnp.ndarray, n: Optional[int] = None, *,
          dtype=None) -> jnp.ndarray:
    """Inverse of :func:`rfft`: length-n real signal from the half
    spectrum (half-size packed inverse for even n)."""
    rdt = _pick_real_dtype(x, dtype)
    return irfft_ri(jnp.real(x).astype(rdt), jnp.imag(x).astype(rdt), n)


# ---------------------------------------------------------------------------
# 2-D transforms: the four-step engine applied per axis.  The inter-axis
# "permutation" is a single XLA transpose, exactly like step 4 of the 1-D
# factorization.
# ---------------------------------------------------------------------------

def fft2_ri(xr: jnp.ndarray, xi: jnp.ndarray
            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """2-D FFT over the last two axes, (re, im) planes in and out
    (numpy.fft.fft2 semantics; arbitrary sizes via Bluestein)."""
    yr, yi = fft_ri(xr, xi)
    yr, yi = fft_ri(jnp.swapaxes(yr, -1, -2), jnp.swapaxes(yi, -1, -2))
    return jnp.swapaxes(yr, -1, -2), jnp.swapaxes(yi, -1, -2)


def ifft2_ri(xr: jnp.ndarray, xi: jnp.ndarray
             ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Inverse 2-D FFT over the last two axes, (re, im) planes."""
    yr, yi = ifft_ri(xr, xi)
    yr, yi = ifft_ri(jnp.swapaxes(yr, -1, -2), jnp.swapaxes(yi, -1, -2))
    return jnp.swapaxes(yr, -1, -2), jnp.swapaxes(yi, -1, -2)


def rfft2_ri(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """2-D FFT of a REAL array over the last two axes: half spectrum on
    the LAST axis (numpy.fft.rfft2 layout, (..., H, W//2+1) bins), rows
    through the half-cost packed transform."""
    yr, yi = rfft_ri(x)
    yr, yi = fft_ri(jnp.swapaxes(yr, -1, -2), jnp.swapaxes(yi, -1, -2))
    return jnp.swapaxes(yr, -1, -2), jnp.swapaxes(yi, -1, -2)


def irfft2_ri(xr: jnp.ndarray, xi: jnp.ndarray,
              w: Optional[int] = None) -> jnp.ndarray:
    """Inverse of :func:`rfft2_ri`: real (..., H, w) array from the
    (..., H, W//2+1) half-spectrum planes.  ``w`` defaults to
    2*(bins-1) (numpy.fft.irfft2's last-axis rule)."""
    yr, yi = ifft_ri(jnp.swapaxes(xr, -1, -2), jnp.swapaxes(xi, -1, -2))
    return irfft_ri(jnp.swapaxes(yr, -1, -2), jnp.swapaxes(yi, -1, -2), w)


def fft2(x: jnp.ndarray, *, dtype=None) -> jnp.ndarray:
    """Complex-dtype convenience wrapper over :func:`fft2_ri`."""
    rdt = _pick_real_dtype(x, dtype)
    yr, yi = fft2_ri(*_as_ri(x, rdt))
    return jax.lax.complex(yr, yi)


def ifft2(x: jnp.ndarray, *, dtype=None) -> jnp.ndarray:
    """Complex-dtype convenience wrapper over :func:`ifft2_ri`."""
    rdt = _pick_real_dtype(x, dtype)
    yr, yi = ifft2_ri(*_as_ri(x, rdt))
    return jax.lax.complex(yr, yi)
