"""Polyphase filter-bank (PFB) channelizer — net-new component required by
the north star (BASELINE.json: "channelize + resample + FM demod";
SURVEY.md §2b "channelizer (polyphase filter bank + batched FFT)").

Analysis channelizer, critically sampled: splits a wideband stream into M
baseband channels at rate fs/M, channel c centered at +c*fs/M.
Downconverting by e^{-2 pi i c n / M} before the low-pass gives, at output
sample g (input index gM):

    y_c[g] = sum_k h[k] x[gM - k] e^{-2 pi i c (gM - k) / M}
           = sum_k h[k] x[gM - k] e^{+2 pi i c k / M}
           = sum_r e^{+2 pi i c r / M} v_r[g],
             v_r[g] = sum_j h[jM + r] x[(g-j)M - r]

i.e. M polyphase branch FIRs (trace-time-constant taps, as in ops/fir.py)
followed by an UNSCALED INVERSE length-M DFT across branches (the +i sign;
computed with the four-step matmul engine from ops/fft.py via
conjugation).  Streaming with explicit carried history; blockwise ==
whole-signal at multiples of M.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from simpledsp_jax.design.fir import pfb_prototype_taps
from simpledsp_jax.ops import fft as _fft
from simpledsp_jax.ops.fir import FIRState, fir_init

__all__ = ["PFBChannelizer", "ChanStateRI"]


class ChanStateRI(NamedTuple):
    """Carried channelizer input history as (re, im) float planes."""

    hist_r: jnp.ndarray  # (..., L-1)
    hist_i: jnp.ndarray  # (..., L-1)


class PFBChannelizer:
    """M-channel analysis polyphase filter bank.

    Args:
      num_channels: M (channel spacing fs/M, output rate fs/M each).
      taps: prototype low-pass of length M*K (defaults to a Kaiser design
        from design/fir.py with cutoff at half the channel spacing).
      dtype: compute dtype of the branch filters (f32 on device, f64 for
        parity).

    Call with x: (..., T) real or complex, T % M == 0; returns
    (y, state) with y: (..., T//M, M) complex channel outputs, channel c
    centered at c*fs/M.
    """

    def __init__(self, num_channels: int, taps: Optional[np.ndarray] = None,
                 taps_per_channel: int = 16, dtype=jnp.float32,
                 design: str = "kaiser"):
        self.m = int(num_channels)
        if taps is None:
            # design="remez" buys 16-34 dB more adjacent-channel rejection
            # at equal taps (see design.fir.pfb_prototype_taps).
            taps = pfb_prototype_taps(self.m, taps_per_channel,
                                      design=design)
        taps = np.asarray(taps, dtype=np.float64)
        if taps.size % self.m != 0:
            taps = np.pad(taps, (0, self.m - taps.size % self.m))
        self.num_taps = taps.size
        self.taps_per_branch = taps.size // self.m
        self.hist_len = self.num_taps - 1
        self.dtype = dtype
        # branch_taps[r, j] = h[j*M + r]
        self._branch = taps.reshape(self.taps_per_branch, self.m).T.copy()
        self._jit = jax.jit(self._run)

    def _branch_filter(self, xp: jnp.ndarray) -> jnp.ndarray:
        """Polyphase branch FIRs: (..., L-1+T) -> (..., T//M, M) real/any.

        Frame the (history-prefixed) signal once and apply the K taps as K
        contiguous LAGGED frame products — branch r's input x[gM - r] is
        column M-1-r of frame g+K-1 of xp, so
        u[g] = sum_j taps[:, j] * S[g + K-1-j]  with S = flip(frames(xp), -1).
        K vector FMAs on contiguous slices replace M*K strided gathers.
        """
        M, K, L = self.m, self.taps_per_branch, self.num_taps
        T = xp.shape[-1] - (L - 1)
        G = T // M
        nfr = K + G - 1
        S = jnp.flip(xp[..., : nfr * M].reshape(xp.shape[:-1] + (nfr, M)),
                     axis=-1)
        taps = self._branch  # (M, K), numpy constant
        acc = None
        for j in range(K):
            lag = K - 1 - j
            term = (S[..., lag: lag + G, :]
                    * jnp.asarray(taps[:, j], dtype=xp.dtype))
            acc = term if acc is None else acc + term
        return acc  # (..., G, M)

    def _run(self, xp: jnp.ndarray):
        # Channel c downconverts +c*fs/M, i.e. y_c = sum_r v_r e^{+2pi i cr/M}
        # — an UNSCALED inverse DFT across branches, computed with the
        # forward kernel via conjugation: IDFT(v) = conj(DFT(conj(v))).
        v = self._branch_filter(xp)
        return jnp.conj(_fft.fft(jnp.conj(v)))

    def _run_ri(self, xpr: jnp.ndarray, xpi: jnp.ndarray):
        """RI path: IQ carried as (re, im) float planes; the branch
        FIRs (real taps) apply per-plane and the cross-branch (inverse) DFT
        runs on the RI pair — no complex dtype ever materializes."""
        vr = self._branch_filter(xpr)
        vi = self._branch_filter(xpi)
        yr, yi = _fft.fft_ri(vr, -vi)
        return yr, -yi

    # -- channel-major fast path -------------------------------------------
    @functools.cached_property
    def _masked_taps(self) -> np.ndarray:
        """(M, 1, L) conv kernels: feature r holds the reversed prototype
        masked to taps k ≡ r (mod M) — branch r's contribution as one
        stride-M convolution over the FLAT signal.  (M-1)/M of the MACs
        are zeros; in exchange the signal never leaves its flat layout."""
        M, L = self.m, self.num_taps
        rhs = np.zeros((M, 1, L))
        k = np.arange(L)
        for r in range(M):
            h_r = np.where(k % M == r, self._branch.T.reshape(-1), 0.0)
            rhs[r, 0] = h_r[::-1]  # lax conv is cross-correlation
        return rhs

    def _run_ri_cm(self, xpr: jnp.ndarray, xpi: jnp.ndarray):
        """Channel-MAJOR RI path: (..., L-1+T) planes -> (yr, yi) each
        (..., M, T//M).

        One stride-M masked conv per plane (branch filter) + one einsum
        over the branch axis (inverse DFT); the minor axis stays the long
        time axis end to end.  This is the natural layout for per-channel
        consumers (demod banks).  Conv precision: HIGHEST, true f32.  On
        an H100, XLA ran this f32 conv at full f32 accuracy at DEFAULT,
        HIGH and HIGHEST alike (7.6e-8 relative error); HIGHEST makes that
        a requirement instead of a compiler choice.
        """
        M, L = self.m, self.num_taps
        lead = xpr.shape[:-1]
        W = xpr.shape[-1]
        G = (W - (L - 1)) // M
        rhs = jnp.asarray(self._masked_taps, dtype=xpr.dtype)

        def branch(xp):
            lhs = xp.reshape((-1, 1, W))
            # u[b, r, g] = sum_k rhs[r, k] * xp[g*M + k]
            y = jax.lax.conv_general_dilated(
                lhs, rhs, window_strides=(M,), padding="VALID",
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=xp.dtype)
            return y.reshape(lead + (M, G))

        vr = branch(xpr)
        vi = branch(xpi)
        # Inverse DFT across branches (axis -2), minor axis untouched:
        # y_c = sum_r v_r e^{+2 pi i c r / M}.
        wr64, wi64 = _fft.dft_matrix(M)  # forward W = c + i s (s = -sin)
        Wc = jnp.asarray(wr64, dtype=xpr.dtype)
        Ws = jnp.asarray(-wi64, dtype=xpr.dtype)  # conjugate: +sin
        dot = functools.partial(jnp.einsum, "cm,...mg->...cg",
                                precision=jax.lax.Precision.HIGHEST,
                                preferred_element_type=xpr.dtype)
        yr = dot(Wc, vr) - dot(Ws, vi)
        yi = dot(Wc, vi) + dot(Ws, vr)
        return yr, yi

    def process_ri_cm(self, xr: jnp.ndarray, xi: jnp.ndarray,
                      state: Optional["ChanStateRI"] = None):
        """Streaming channel-major entry: returns ((yr, yi) each
        (..., M, T//M), state)."""
        T = xr.shape[-1]
        if T % self.m != 0:
            raise ValueError(f"block length {T} must be a multiple of M={self.m}")
        if state is None:
            z = jnp.zeros(xr.shape[:-1] + (self.hist_len,), dtype=xr.dtype)
            state = ChanStateRI(z, z)
        xpr = jnp.concatenate([state.hist_r, xr], axis=-1)
        xpi = jnp.concatenate([state.hist_i, xi], axis=-1)
        yr, yi = self._run_ri_cm(xpr, xpi)
        new = ChanStateRI(xpr[..., xpr.shape[-1] - self.hist_len:],
                          xpi[..., xpi.shape[-1] - self.hist_len:])
        return (yr, yi), new

    def process_ri(self, xr: jnp.ndarray, xi: jnp.ndarray,
                   state: Optional["ChanStateRI"] = None
                   ) -> Tuple[Tuple[jnp.ndarray, jnp.ndarray], "ChanStateRI"]:
        """Streaming RI entry point: (xr, xi): (..., T) float planes,
        T % M == 0; returns ((yr, yi) each (..., T//M, M), state)."""
        T = xr.shape[-1]
        if T % self.m != 0:
            raise ValueError(f"block length {T} must be a multiple of M={self.m}")
        if state is None:
            z = jnp.zeros(xr.shape[:-1] + (self.hist_len,), dtype=xr.dtype)
            state = ChanStateRI(z, z)
        xpr = jnp.concatenate([state.hist_r, xr], axis=-1)
        xpi = jnp.concatenate([state.hist_i, xi], axis=-1)
        yr, yi = self._run_ri(xpr, xpi)
        new = ChanStateRI(xpr[..., xpr.shape[-1] - self.hist_len:],
                          xpi[..., xpi.shape[-1] - self.hist_len:])
        return (yr, yi), new

    def __call__(self, x: jnp.ndarray, state: Optional[FIRState] = None
                 ) -> Tuple[jnp.ndarray, FIRState]:
        T = x.shape[-1]
        if T % self.m != 0:
            raise ValueError(f"block length {T} must be a multiple of M={self.m}")
        if not jnp.iscomplexobj(x):
            x = x.astype(self.dtype)
        if state is None:
            state = fir_init(self.hist_len, x.shape[:-1],
                             dtype=x.dtype)
        xp = jnp.concatenate([state.hist.astype(x.dtype), x], axis=-1)
        y = self._jit(xp)
        return y, FIRState(xp[..., xp.shape[-1] - self.hist_len:])
