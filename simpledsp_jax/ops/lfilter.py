"""Generic transfer-function IIR/FIR filtering: lfilter / filtfilt.

The reference library only offers cascaded-biquad Butterworth filters
(include/sdsp/casc_2o_iir.h); real users also carry arbitrary (b, a)
transfer functions, so scipy.signal's `lfilter` family is provided with
the framework's two-formulation design (ops/iir.py):

1. **Scan oracle** (`lfilter_scan`): direct-form II transposed per-sample
   `lax.scan` — the semantic definition, bit-exact under block splits,
   scipy's `zi` state convention.
2. **Block state-space fast path** (`BlockLFilter`): the DF2T companion
   form is condensed over B-sample blocks into three dense matmuls
   (`block_operators_from_ss_f64`), turning the serial recurrence into
   matmul work — the same trick `BlockIIR` plays for the cascade.

`filtfilt` (zero-phase forward-backward with odd-reflection padding and
steady-state initialization) matches scipy.signal.filtfilt defaults.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from simpledsp_jax.ops.iir import block_operators_from_ss_f64

__all__ = ["lfilter", "lfilter_scan", "lfilter_zi", "lfiltic",
           "BlockLFilter", "filtfilt", "freqz", "freqs", "freqs_zpk",
           "freqz_zpk", "tf_state_space_f64"]


def _normalize_ba(b, a) -> Tuple[np.ndarray, np.ndarray]:
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if b.ndim != 1 or a.ndim != 1:
        raise ValueError("b and a must be 1-D coefficient vectors")
    if a.size == 0 or a[0] == 0.0:
        raise ValueError("a[0] must be nonzero")
    return b / a[0], a / a[0]


def tf_state_space_f64(b, a):
    """DF2T companion-form state space of H(z) = B(z)/A(z), float64.

    With D = max(len(a), len(b)) - 1 and coefficients zero-padded to
    D + 1:  s' = A s + p x,  y = c.s + d x  where the state s IS scipy's
    lfilter `zi` vector (direct-form II transposed delays):

        y    = b0 x + z0
        z_i' = z_{i+1} + b_{i+1} x - a_{i+1} y
    """
    b, a = _normalize_ba(b, a)
    D = max(b.size, a.size) - 1
    if D == 0:
        return (np.zeros((0, 0)), np.zeros(0), np.zeros(0), float(b[0]))
    bp = np.zeros(D + 1)
    bp[: b.size] = b
    ap = np.zeros(D + 1)
    ap[: a.size] = a
    A = np.zeros((D, D))
    A[:, 0] = -ap[1:]
    A[: D - 1, 1:] = np.eye(D - 1)
    p = bp[1:] - ap[1:] * bp[0]
    c = np.zeros(D)
    c[0] = 1.0
    return A, p, c, float(bp[0])


def freqz(b, a=1.0, n: int = 512, *, fs: float = 2.0 * np.pi
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Frequency response of B(z)/A(z) on n points of [0, fs/2)
    (scipy.signal.freqz(worN=n) semantics; host-side float64 analysis —
    the generic-transfer-function analog of design.biquad.freq_response)."""
    b64, a64 = _normalize_ba(b, a)
    w = np.linspace(0.0, np.pi, n, endpoint=False)
    z = np.exp(-1j * w)
    h = np.polynomial.polynomial.polyval(z, b64) / \
        np.polynomial.polynomial.polyval(z, a64)
    return w * (fs / (2.0 * np.pi)), h


def freqs(b, a, worN=200) -> Tuple[np.ndarray, np.ndarray]:
    """Analog (s-domain) frequency response of B(s)/A(s)
    (scipy.signal.freqs semantics, including the POSITIONAL worN
    convention): an integer picks that many log-spaced points around the
    system's interesting range; an array evaluates H(jw) at those rad/s
    points."""
    b64 = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a64 = np.atleast_1d(np.asarray(a, dtype=np.float64))
    worN_arr = np.asarray(worN)
    if worN_arr.ndim == 0 and np.issubdtype(worN_arr.dtype, np.integer):
        roots = np.concatenate([np.roots(a64) if a64.size > 1 else [],
                                np.roots(b64) if b64.size > 1 else []])
        mags = np.abs(roots[np.abs(roots) > 0]) if roots.size else []
        center = np.median(mags) if len(mags) else 1.0
        w = np.logspace(np.log10(center) - 2, np.log10(center) + 2,
                        int(worN))
    else:
        w = np.atleast_1d(worN_arr.astype(np.float64))
    s = 1j * w
    h = np.polyval(b64, s) / np.polyval(a64, s)
    return w, h


def freqs_zpk(z, p, k: float, worN) -> Tuple[np.ndarray, np.ndarray]:
    """Analog frequency response from zeros/poles/gain
    (scipy.signal.freqs_zpk semantics, explicit ``worN``): evaluated as
    a product over roots — no polynomial expansion, so high orders stay
    well-conditioned."""
    w = np.atleast_1d(np.asarray(worN, dtype=np.float64))
    s = 1j * w
    h = np.full(w.shape, complex(k))
    for zi in np.atleast_1d(z):
        h *= s - zi
    for pi in np.atleast_1d(p):
        h /= s - pi
    return w, h


def freqz_zpk(z, p, k: float, n=512, *, fs: float = 2.0 * np.pi
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Digital frequency response from zeros/poles/gain
    (scipy.signal.freqz_zpk semantics): product over roots on the unit
    circle.  ``n`` is a point count over [0, fs/2), or an explicit array
    of frequencies in the units of ``fs`` (scipy's worN array form)."""
    n_arr = np.asarray(n)
    if n_arr.ndim == 0 and np.issubdtype(n_arr.dtype, np.integer):
        w = np.linspace(0.0, np.pi, int(n), endpoint=False)
    else:
        w = np.atleast_1d(n_arr.astype(np.float64)) * (2.0 * np.pi / fs)
    zv = np.exp(1j * w)
    h = np.full(w.shape, complex(k))
    for zi in np.atleast_1d(z):
        h *= zv - zi
    for pi in np.atleast_1d(p):
        h /= zv - pi
    return w * (fs / (2.0 * np.pi)), h


def lfilter_zi(b, a) -> np.ndarray:
    """Steady-state DF2T state for unit step input
    (scipy.signal.lfilter_zi): the zi that makes a constant input produce
    its DC-gain output with zero transient."""
    A, p, c, d = tf_state_space_f64(b, a)
    D = A.shape[0]
    if D == 0:
        return np.zeros(0)
    return np.linalg.solve(np.eye(D) - A, p)


def lfiltic(b, a, y, x=None) -> np.ndarray:
    """Initial lfilter state reproducing given past outputs ``y`` (and
    past inputs ``x``) — scipy.signal.lfiltic semantics, returning the
    direct-form-II-transposed ``zi`` this module's lfilter consumes.

    Derivation: run the DF2T update backwards.  z[i] carries
    sum_{j>i} (b[j] x[t-(j-i)] - a[j] y[t-(j-i)]); with the convention
    y[-1], y[-2], ... = y[0], y[1], ... (scipy's ordering) each state
    entry is a finite double sum over the known history, zero beyond the
    provided samples."""
    b64, a64 = _normalize_ba(b, a)
    n = max(b64.size, a64.size)
    bp = np.zeros(n)
    bp[: b64.size] = b64
    ap = np.zeros(n)
    ap[: a64.size] = a64
    y = np.atleast_1d(np.asarray(y, dtype=np.float64))
    x = (np.zeros(0) if x is None
         else np.atleast_1d(np.asarray(x, dtype=np.float64)))
    zi = np.zeros(n - 1)
    for i in range(n - 1):
        acc = 0.0
        for j in range(i + 1, n):
            lag = j - i - 1          # y[-1 - lag] == y[lag] in scipy order
            if lag < x.size:
                acc += bp[j] * x[lag]
            if lag < y.size:
                acc -= ap[j] * y[lag]
        zi[i] = acc
    return zi


def lfilter_scan(b, a, x: jnp.ndarray,
                 zi: Optional[jnp.ndarray] = None
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Direct-form II transposed sample scan (scipy.signal.lfilter
    semantics, always returning (y, zf)).  x: (..., T); zi: (..., D)."""
    b, a = _normalize_ba(b, a)
    D = max(b.size, a.size) - 1
    dtype = x.dtype
    bp = np.zeros(D + 1)
    bp[: b.size] = b
    ap = np.zeros(D + 1)
    ap[: a.size] = a
    bj = jnp.asarray(bp, dtype=dtype)
    aj = jnp.asarray(ap, dtype=dtype)
    if zi is None:
        zi = jnp.zeros(x.shape[:-1] + (D,), dtype=dtype)
    if D == 0:
        return bj[0] * x, zi

    xt = jnp.moveaxis(x, -1, 0)

    def step(z, xs):
        y = bj[0] * xs + z[..., 0]
        z_shift = jnp.concatenate(
            [z[..., 1:], jnp.zeros_like(z[..., :1])], axis=-1)
        z_next = z_shift + bj[1:] * xs[..., None] - aj[1:] * y[..., None]
        return z_next, y

    zf, yt = jax.lax.scan(step, zi.astype(dtype), xt)
    return jnp.moveaxis(yt, 0, -1), zf


class BlockLFilter:
    """Block state-space fast path for an arbitrary (b, a) transfer
    function: the DF2T recurrence condensed over B-sample blocks into
    dense matmuls (same machinery as :class:`BlockIIR`; operators
    precomputed float64 host-side, folded into the jit as constants).

    State is scipy's `zi` vector, so results (and streaming splits) are
    interchangeable with :func:`lfilter_scan` up to float reassociation
    within full blocks.
    """

    def __init__(self, b, a, block_size: int = 256, dtype=jnp.float32,
                 precision=None):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.b, self.a = _normalize_ba(b, a)
        self.block_size = int(block_size)
        self.dtype = dtype
        self.precision = precision or jax.lax.Precision.HIGHEST
        A, p, c, d = tf_state_space_f64(self.b, self.a)
        self.state_dim = A.shape[0]
        H, Phi, K, F = block_operators_from_ss_f64(A, p, c, d,
                                                   self.block_size)
        npdt = np.dtype(dtype)
        self._H = H.astype(npdt)
        self._Phi = Phi.astype(npdt)
        self._K = K.astype(npdt)
        self._F = F.astype(npdt)
        self._jit_blocks = jax.jit(self._run_blocks)

    def _run_blocks(self, xb: jnp.ndarray, s0: jnp.ndarray):
        H, Phi, K, F = self._H, self._Phi, self._K, self._F
        conv = jnp.einsum("ij,...kj->...ki", H, xb,
                          preferred_element_type=xb.dtype,
                          precision=self.precision)
        kx = jnp.einsum("dj,...kj->...kd", K, xb,
                        preferred_element_type=xb.dtype,
                        precision=self.precision)
        kx_t = jnp.moveaxis(kx, -2, 0)

        def step(s, kxk):
            s_next = jnp.einsum("de,...e->...d", F, s,
                                preferred_element_type=s.dtype,
                                precision=self.precision) + kxk
            return s_next, s

        s_final, s_starts = jax.lax.scan(step, s0, kx_t)
        s_starts = jnp.moveaxis(s_starts, 0, -2)
        y = conv + jnp.einsum("id,...kd->...ki", Phi, s_starts,
                              preferred_element_type=xb.dtype,
                              precision=self.precision)
        return y, s_final

    def __call__(self, x: jnp.ndarray, zi: Optional[jnp.ndarray] = None
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        D = self.state_dim
        x = x.astype(self.dtype)
        if zi is None:
            zi = jnp.zeros(x.shape[:-1] + (D,), dtype=self.dtype)
        if D == 0:
            return jnp.asarray(self.b[0], self.dtype) * x, zi
        T = x.shape[-1]
        B = self.block_size
        nfull = T // B
        rem = T - nfull * B
        if nfull > 0:
            xb = x[..., : nfull * B].reshape(x.shape[:-1] + (nfull, B))
            yb, zi = self._jit_blocks(xb, zi.astype(self.dtype))
            y_main = yb.reshape(x.shape[:-1] + (nfull * B,))
        else:
            y_main = x[..., :0]
        if rem:
            y_tail, zi = lfilter_scan(self.b, self.a, x[..., nfull * B:],
                                      zi)
            return jnp.concatenate([y_main, y_tail], axis=-1), zi
        return y_main, zi


def lfilter(b, a, x: jnp.ndarray, zi: Optional[jnp.ndarray] = None, *,
            method: str = "auto", block_size: int = 256,
            dtype=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Filter x along its last axis with the transfer function B(z)/A(z)
    (scipy.signal.lfilter semantics; ALWAYS returns (y, zf) — the
    framework's explicit-state streaming contract).

    method: 'scan' (oracle), 'block' (matmul fast path), 'auto'.
    """
    if method not in ("auto", "scan", "block"):
        raise ValueError(f"unknown method {method!r}")
    dtype = dtype or x.dtype
    x = x.astype(dtype)
    if method == "scan" or (method == "auto"
                            and x.shape[-1] < 4 * block_size):
        return lfilter_scan(b, a, x, zi)
    return BlockLFilter(b, a, block_size=block_size, dtype=dtype)(x, zi)


def filtfilt(b, a, x: jnp.ndarray, *, padlen: Optional[int] = None,
             method: str = "auto", dtype=None) -> jnp.ndarray:
    """Zero-phase forward-backward filtering (scipy.signal.filtfilt with
    the default odd-reflection padding and steady-state edge init)."""
    b64, a64 = _normalize_ba(b, a)
    ntaps = max(b64.size, a64.size)
    if padlen is None:
        padlen = 3 * ntaps
    T = x.shape[-1]
    if padlen >= T:
        raise ValueError(f"padlen={padlen} must be less than the signal "
                         f"length {T}")
    dtype = dtype or x.dtype
    x = x.astype(dtype)
    if padlen > 0:
        # Odd reflection: 2 x[0] - x[padlen:0:-1]  |  x  |  2 x[-1] - ...
        head = 2.0 * x[..., :1] - x[..., padlen:0:-1]
        tail = 2.0 * x[..., -1:] - x[..., -2: -padlen - 2: -1]
        ext = jnp.concatenate([head, x, tail], axis=-1)
    else:
        ext = x
    zi = jnp.asarray(lfilter_zi(b64, a64), dtype=dtype)
    zi_b = jnp.broadcast_to(zi, ext.shape[:-1] + zi.shape)
    y, _ = lfilter(b64, a64, ext, zi_b * ext[..., :1], method=method,
                   dtype=dtype)
    y = y[..., ::-1]
    y, _ = lfilter(b64, a64, y, zi_b * y[..., :1], method=method,
                   dtype=dtype)
    y = y[..., ::-1]
    if padlen > 0:
        y = y[..., padlen:-padlen]
    return y
