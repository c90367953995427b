"""Cascaded second-order-section IIR filtering, block-parallel.

Reference behavior being reproduced (not translated): streaming block
processing of a cascade of M biquads with carried state, such that processing
a signal in blocks is exactly equivalent to processing it whole
(reference: include/sdsp/casc_2o_iir.h:36-80, proven at test/testIIR.cpp:61-75),
plus steady-state preload (casc_2o_iir.h:196-214).

Design
------
The reference's per-sample recurrence is hostile to a vector machine, so this
module provides two interchangeable formulations:

1. **Scan oracle** (`sosfilt_scan`): a `lax.scan` over samples carrying an
   explicit state pytree — the pure-functional form of the reference's
   `m_mem`/`m_pos` ring buffer.  Bit-exact under arbitrary block splits,
   matches scipy.signal.sosfilt to ~1e-15 in float64.  This is the semantic
   definition every fast path is diffed against.

2. **Block state-space fast path** (`BlockIIR`): the cascade is an LTI system
   of order D = 2(M+1) (including the gained-input delay line).  Condensing B
   samples at a time turns the serial recurrence into three dense matmuls

       y_block   = H  @ x_block  +  Phi @ s_in          (matmul, parallel over blocks)
       s_next    = F  @ s_in     +  K   @ x_block       (D-dim scan, negligible)

   where H is the B-by-B lower-triangular Toeplitz of the cascade impulse
   response and F = A^B.  All operators are precomputed in float64 on the host
   at design time and folded into the jitted HLO as constants — the trace-time
   analog of the reference's compile-time twiddle tables.  Throughput is then
   matmul-bound instead of latency-bound.

State is an explicit pytree the caller threads through calls; it is trivially
serializable (checkpoint/resume story, SURVEY.md §5).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from simpledsp_jax.design.biquad import BiquadCascadeDesign

__all__ = [
    "CascadeCoeffs",
    "IIRState",
    "coeffs_from_design",
    "iir_init",
    "iir_preload",
    "sosfilt_scan",
    "sosfilt_zi",
    "BlockIIR",
    "block_operators_f64",
    "block_operators_from_ss_f64",
    "sosfilt",
    "sosfiltfilt",
]


class CascadeCoeffs(NamedTuple):
    """Traced coefficient pytree for a cascade of M biquads (b0 == a0 == 1)."""

    b1: jnp.ndarray  # (M,)
    b2: jnp.ndarray  # (M,)
    a1: jnp.ndarray  # (M,)
    a2: jnp.ndarray  # (M,)
    gain: jnp.ndarray  # scalar

    @property
    def nsections(self) -> int:
        return self.b1.shape[0]


class IIRState(NamedTuple):
    """Carried filter state: last two outputs of each cascade node.

    ``y_hist[..., j, 0]`` is node j's output at n-1, ``[..., j, 1]`` at n-2.
    Node 0 is the gained input; node j >= 1 is the output of section j.  This
    is the functional equivalent of the reference's (M+1)x3 ring buffer
    (casc_2o_iir.h:15) with the ring cursor normalized away.
    """

    y_hist: jnp.ndarray  # (..., M+1, 2)


def coeffs_from_design(design: BiquadCascadeDesign, dtype=jnp.float32) -> CascadeCoeffs:
    return CascadeCoeffs(
        b1=jnp.asarray(design.b[:, 1], dtype=dtype),
        b2=jnp.asarray(design.b[:, 2], dtype=dtype),
        a1=jnp.asarray(design.a[:, 1], dtype=dtype),
        a2=jnp.asarray(design.a[:, 2], dtype=dtype),
        gain=jnp.asarray(design.gain, dtype=dtype),
    )


def iir_init(nsections: int, batch_shape: Tuple[int, ...] = (),
             dtype=jnp.float32) -> IIRState:
    """Zero state (cold start), batched over `batch_shape` channels."""
    return IIRState(jnp.zeros(batch_shape + (nsections + 1, 2), dtype=dtype))


def _preload_levels_f64(design: BiquadCascadeDesign) -> np.ndarray:
    """Per-node steady-state levels for a UNIT constant input: node 0 holds
    the gain, node j the running product of section DC gains (float64)."""
    v = design.gain
    levels = [v]
    for k in range(design.nsections):
        v = v * design.b[k].sum() / design.a[k].sum()
        levels.append(v)
    return np.asarray(levels, dtype=np.float64)


def sosfilt_zi(sos) -> np.ndarray:
    """Steady-state DF2T initial conditions for a unit-step input through
    an (n, 6) SOS cascade (scipy.signal.sosfilt_zi semantics): section
    k's lfilter_zi scaled by the DC gain of the sections before it.
    Host-side f64 — the scipy-compat counterpart of the framework's own
    :func:`iir_preload` (which fills the explicit IIRState pytree)."""
    from simpledsp_jax.ops.lfilter import lfilter_zi

    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (n, 6), got {sos.shape}")
    n = sos.shape[0]
    zi = np.empty((n, 2))
    scale = 1.0
    for k in range(n):
        b, a = sos[k, :3], sos[k, 3:]
        zi[k] = scale * lfilter_zi(b, a)
        scale *= b.sum() / a.sum()
    return zi


def iir_preload(design: BiquadCascadeDesign, value: float,
                batch_shape: Tuple[int, ...] = (), dtype=jnp.float32) -> IIRState:
    """Steady-state preload: constant input `value` produces zero transient.

    Generalizes the reference's preload_filter (casc_2o_iir.h:196-214): node 0
    holds value*gain and each later node holds the running product of section
    DC gains.  For HP/BP the section DC gain is 0 so later nodes are 0, for LP
    it propagates — identical outcomes to the reference's special-casing,
    but one formula covers band-stop too.
    """
    hist = np.repeat(float(value) * _preload_levels_f64(design)[:, None],
                     2, axis=1)
    full = np.broadcast_to(hist, batch_shape + hist.shape)
    return IIRState(jnp.asarray(full, dtype=dtype))


def _preload_from_values(design: BiquadCascadeDesign,
                         values: jnp.ndarray) -> IIRState:
    """Batched preload: steady state for per-signal constant inputs
    ``values`` (...,) — scipy's ``zi * x[0]`` edge initialization."""
    lev = jnp.asarray(_preload_levels_f64(design), dtype=values.dtype)
    hist = values[..., None, None] * lev[:, None]       # (..., M+1, 1)
    return IIRState(jnp.broadcast_to(
        hist, values.shape + (design.nsections + 1, 2)))


# ---------------------------------------------------------------------------
# 1. Scan oracle — semantic ground truth
# ---------------------------------------------------------------------------

def _cascade_step(coeffs: CascadeCoeffs, y_hist: jnp.ndarray, x: jnp.ndarray):
    """One sample through the cascade.  y_hist: (..., M+1, 2); x: (...)."""
    m = coeffs.nsections
    v = x * coeffs.gain
    new_nodes = [v]
    for j in range(m):  # M is static; unrolled at trace time
        v = (v
             + coeffs.b1[j] * y_hist[..., j, 0]
             + coeffs.b2[j] * y_hist[..., j, 1]
             - coeffs.a1[j] * y_hist[..., j + 1, 0]
             - coeffs.a2[j] * y_hist[..., j + 1, 1])
        new_nodes.append(v)
    y_new = jnp.stack(new_nodes, axis=-1)  # (..., M+1)
    y_hist_next = jnp.stack([y_new, y_hist[..., 0]], axis=-1)
    return y_hist_next, new_nodes[-1]


def sosfilt_scan(coeffs: CascadeCoeffs, x: jnp.ndarray,
                 state: IIRState) -> Tuple[jnp.ndarray, IIRState]:
    """Filter `x` (time on the last axis) via a sample-level `lax.scan`.

    Bit-exact under any block split (the reference's streaming contract,
    testIIR.cpp:61-75).  Serial, hence slow; use `BlockIIR` for throughput.
    """
    xt = jnp.moveaxis(x, -1, 0)  # (T, ...)

    def step(y_hist, xs):
        return _cascade_step(coeffs, y_hist, xs)

    y_hist_final, yt = jax.lax.scan(step, state.y_hist, xt)
    return jnp.moveaxis(yt, 0, -1), IIRState(y_hist_final)


# ---------------------------------------------------------------------------
# 2. Block state-space fast path — matmuls
# ---------------------------------------------------------------------------

def _state_space_f64(design: BiquadCascadeDesign):
    """Derive the one-step LTI form  s' = A s + p x,  y = c.s + d x  in f64.

    Probes the (linear) cascade step with unit vectors — guaranteed consistent
    with the scan oracle by construction.
    """
    m = design.nsections
    d_dim = 2 * (m + 1)

    b1 = design.b[:, 1]
    b2 = design.b[:, 2]
    a1 = design.a[:, 1]
    a2 = design.a[:, 2]
    gain = design.gain

    def step_np(y_hist, x):
        # y_hist: (m+1, 2) float64
        v = x * gain
        nodes = [v]
        for j in range(m):
            v = (v + b1[j] * y_hist[j, 0] + b2[j] * y_hist[j, 1]
                 - a1[j] * y_hist[j + 1, 0] - a2[j] * y_hist[j + 1, 1])
            nodes.append(v)
        y_new = np.asarray(nodes)
        nxt = np.stack([y_new, y_hist[:, 0]], axis=-1)
        return nxt, nodes[-1]

    A = np.zeros((d_dim, d_dim))
    c = np.zeros(d_dim)
    for i in range(d_dim):
        e = np.zeros(d_dim)
        e[i] = 1.0
        nxt, y = step_np(e.reshape(m + 1, 2), 0.0)
        A[:, i] = nxt.reshape(-1)
        c[i] = y
    nxt, y = step_np(np.zeros((m + 1, 2)), 1.0)
    p = nxt.reshape(-1)
    d = y
    return A, p, c, d


def block_operators_from_ss_f64(A: np.ndarray, p: np.ndarray,
                                c: np.ndarray, d: float, block_size: int):
    """Block-condensation operators for ANY one-step LTI quadruple
    ``s' = A s + p x, y = c.s + d x`` (float64 host math).

    Returns (H, Phi, K, F):
      H   (B, B)  lower-triangular Toeplitz of the impulse response
      Phi (B, D)  initial-state response of each in-block output
      K   (D, B)  input-to-final-state map
      F   (D, D)  B-step state transition A^B
    Shared by the cascaded-biquad BlockIIR, the generic transfer-function
    BlockLFilter (ops/lfilter.py), and the sequence-parallel forms.
    """
    B = int(block_size)
    D = A.shape[0]

    powers = np.empty((B + 1, D, D))
    powers[0] = np.eye(D)
    for i in range(1, B + 1):
        powers[i] = A @ powers[i - 1]

    h = np.empty(B)
    h[0] = d
    for k in range(1, B):
        h[k] = c @ powers[k - 1] @ p
    idx = np.subtract.outer(np.arange(B), np.arange(B))
    H = np.where(idx >= 0, h[np.clip(idx, 0, B - 1)], 0.0)

    Phi = np.stack([c @ powers[i] for i in range(B)])
    K = np.stack([powers[B - 1 - j] @ p for j in range(B)], axis=1)
    F = powers[B]
    return H, Phi, K, F


def block_operators_f64(design: BiquadCascadeDesign, block_size: int):
    """Host-side float64 block-condensation operators for a B-sample block
    of the biquad cascade (see :func:`block_operators_from_ss_f64`).

    Returns (H, Phi, K, F, A, p, c, d) with D = 2(M+1)."""
    A, p, c, d = _state_space_f64(design)
    H, Phi, K, F = block_operators_from_ss_f64(A, p, c, d, block_size)
    return H, Phi, K, F, A, p, c, d


class BlockIIR:
    """Precompiled block-parallel IIR for one design (trace-time constants).

    The analog of instantiating `casc_2o_iir<M>` with a coefficient set in the
    reference: operators are computed once on the host in float64, then baked
    into the jitted computation.

    Usage::

        f = BlockIIR(design, block_size=256, dtype=jnp.float32)
        y, state = f(x, state)          # x: (..., T), T % block_size free

    Consistency: splitting the signal at multiples of `block_size` is
    bit-exact; the sub-block tail is handled by the scan oracle so results are
    identical to `sosfilt_scan` up to float reassociation within full blocks.
    """

    def __init__(self, design: BiquadCascadeDesign, block_size: int = 256,
                 dtype=jnp.float32, precision=None):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.design = design
        self.block_size = int(block_size)
        self.dtype = dtype
        # HIGHEST keeps f32 matmuls at true f32; a lower setting lets
        # the compiler use reduced-precision passes (TF32 on a GPU).
        self.precision = precision or jax.lax.Precision.HIGHEST

        H, Phi, K, F, *_ = block_operators_f64(design, self.block_size)

        npdt = np.dtype(dtype)
        self._H = H.astype(npdt)
        self._Phi = Phi.astype(npdt)
        self._K = K.astype(npdt)
        self._F = F.astype(npdt)
        self._coeffs = coeffs_from_design(design, dtype=dtype)
        self._jit_blocks = jax.jit(self._run_blocks)

    # -- core jitted computation ------------------------------------------
    def _run_blocks(self, xb: jnp.ndarray, s0: jnp.ndarray):
        """xb: (..., nblocks, B) full blocks; s0: (..., D)."""
        H, Phi, K, F = self._H, self._Phi, self._K, self._F
        # Input-driven contributions — fully parallel over (batch, blocks).
        conv = jnp.einsum("ij,...kj->...ki", H, xb,
                          preferred_element_type=xb.dtype,
                          precision=self.precision)
        kx = jnp.einsum("dj,...kj->...kd", K, xb,
                        preferred_element_type=xb.dtype,
                          precision=self.precision)

        # Cheap D-dim scan over blocks for the state chain.
        kx_t = jnp.moveaxis(kx, -2, 0)  # (nblocks, ..., D)

        def step(s, kxk):
            s_next = jnp.einsum("de,...e->...d", F, s,
                                preferred_element_type=s.dtype,
                                precision=self.precision) + kxk
            return s_next, s  # emit state at block START

        s_final, s_starts = jax.lax.scan(step, s0, kx_t)
        s_starts = jnp.moveaxis(s_starts, 0, -2)  # (..., nblocks, D)

        y = conv + jnp.einsum("id,...kd->...ki", Phi, s_starts,
                              preferred_element_type=xb.dtype,
                          precision=self.precision)
        return y, s_final

    # -- public API ---------------------------------------------------------
    def __call__(self, x: jnp.ndarray,
                 state: Optional[IIRState] = None) -> Tuple[jnp.ndarray, IIRState]:
        m = self.design.nsections
        if state is None:
            state = iir_init(m, x.shape[:-1], dtype=self.dtype)
        T = x.shape[-1]
        B = self.block_size
        nfull = T // B
        rem = T - nfull * B

        s0 = state.y_hist.reshape(state.y_hist.shape[:-2] + (-1,))
        if nfull > 0:
            xb = x[..., : nfull * B].reshape(x.shape[:-1] + (nfull, B))
            yb, s_end = self._jit_blocks(xb, s0)
            y_main = yb.reshape(x.shape[:-1] + (nfull * B,))
            state = IIRState(s_end.reshape(s_end.shape[:-1] + (m + 1, 2)))
        else:
            y_main = x[..., :0]

        if rem:
            y_tail, state = sosfilt_scan(self._coeffs, x[..., nfull * B:], state)
            return jnp.concatenate([y_main, y_tail], axis=-1), state
        return y_main, state

    def run_blocks(self, xb: jnp.ndarray, s0: jnp.ndarray):
        """Raw blocked interface for the sharded pipeline (parallel layer)."""
        return self._run_blocks(xb, s0)

    @property
    def operators(self):
        """(H, Phi, K, F) as jnp constants — used by the distributed path."""
        return self._H, self._Phi, self._K, self._F


def sosfiltfilt(design: BiquadCascadeDesign, x: jnp.ndarray, *,
                padlen: Optional[int] = None, method: str = "auto",
                block_size: int = 256, dtype=None) -> jnp.ndarray:
    """Zero-phase forward-backward cascade filtering
    (scipy.signal.sosfiltfilt semantics: odd-reflection padding, per-edge
    steady-state initialization via the preload machinery — the same
    contract the reference's preload_filter establishes for one edge,
    applied to both).  x: (..., T) -> (..., T)."""
    m = design.nsections
    nzero = min(int(np.sum(design.b[:, 2] == 0.0)),
                int(np.sum(design.a[:, 2] == 0.0)))
    if padlen is None:
        padlen = 3 * (2 * m + 1 - nzero)
    T = x.shape[-1]
    if padlen >= T:
        raise ValueError(f"padlen={padlen} must be less than the signal "
                         f"length {T}")
    dtype = dtype or x.dtype
    x = x.astype(dtype)
    if padlen > 0:
        head = 2.0 * x[..., :1] - x[..., padlen:0:-1]
        tail = 2.0 * x[..., -1:] - x[..., -2: -padlen - 2: -1]
        ext = jnp.concatenate([head, x, tail], axis=-1)
    else:
        ext = x

    def one_pass(sig):
        s0 = _preload_from_values(design, sig[..., 0])
        y, _ = sosfilt(design, sig, s0, method=method,
                       block_size=block_size, dtype=dtype)
        return y[..., ::-1]

    y = one_pass(one_pass(ext))
    if padlen > 0:
        y = y[..., padlen:-padlen]
    return y


def sosfilt(design: BiquadCascadeDesign, x: jnp.ndarray,
            state: Optional[IIRState] = None, *, method: str = "auto",
            block_size: int = 256, dtype=None) -> Tuple[jnp.ndarray, IIRState]:
    """One-shot convenience wrapper.

    method: 'scan' (oracle), 'block' (matmul fast path), or 'auto'.
    For hot loops, construct a `BlockIIR` once and reuse it.
    """
    dtype = dtype or x.dtype
    if method not in ("auto", "scan", "block"):
        raise ValueError(f"unknown method {method!r}")
    if state is None:
        state = iir_init(design.nsections, x.shape[:-1], dtype=dtype)
    if method == "scan" or (method == "auto" and x.shape[-1] < 4 * block_size):
        coeffs = coeffs_from_design(design, dtype=dtype)
        return sosfilt_scan(coeffs, x, state)
    return BlockIIR(design, block_size=block_size, dtype=dtype)(x, state)
