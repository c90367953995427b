"""Sequence-parallel cascaded-biquad IIR over a device mesh.

This is the multi-device promotion of the reference's streaming contract —
"processing in blocks is exactly processing the whole signal"
(reference: include/sdsp/casc_2o_iir.h:36-80, test/testIIR.cpp:61-75) — from
blocks-in-time to blocks-across-devices (SURVEY.md §2b "sequence/block
parallelism for IIR").

Math
----
The cascade is LTI with one-step form  s' = A s + p x.  Condensing a
B-sample block gives (ops/iir.py):

    y_blk  = H x_blk + Phi s_in
    s_out  = F s_blk_in + K x_blk ,   F = A^B

Condensing further, a whole device shard of nb blocks has

    s_shard_out = Fs s_shard_in + k_shard,    Fs = F^nb,
    k_shard     = input-driven final state from a zero-init local scan.

Because Fs is the *same* matrix on every device (equal shard lengths), the
incoming state of shard i is the closed form

    s_in(i) = Fs^i s0 + sum_{j<i} Fs^{i-1-j} k_j

so the cross-device dependency collapses to ONE all_gather of the tiny
(channels, D) vectors k_j over the sequence axis, followed by a local
O(P D^2) weighted sum with host-precomputed Fs powers — no sequential
device-to-device chain at all.  The global final state is the matching
psum-form (replicated), so streaming across repeated sharded calls works.

All condensation operators are float64 on the host, cast once to the compute
dtype, and folded into the jitted HLO as constants (the trace-time analog of
the reference's constexpr tables, reference: include/sdsp/fft.h:264-265).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from simpledsp_jax.design.biquad import BiquadCascadeDesign
from simpledsp_jax.ops.iir import IIRState, block_operators_f64, iir_init
from simpledsp_jax.parallel.mesh import DATA_AXIS, SEQ_AXIS

__all__ = ["ShardedBlockIIR"]


class ShardedBlockIIR:
    """Block-state-space IIR sharded (channels over dp) x (time over sp).

    Usage::

        f = ShardedBlockIIR(design, mesh, block_size=256)
        y, state = f(x, state)     # x: (C, T) with T % (sp * block_size) == 0

    Splitting a stream at multiples of ``sp * block_size`` across successive
    calls is exact (the reference's streaming contract at shard granularity).
    """

    def __init__(self, design: BiquadCascadeDesign, mesh: Mesh,
                 block_size: int = 256, dtype=jnp.float32, precision=None):
        self.design = design
        self.mesh = mesh
        self.block_size = int(block_size)
        self.dtype = dtype
        self.n_seq = mesh.shape[SEQ_AXIS]
        self.n_data = mesh.shape[DATA_AXIS]
        self.precision = precision or jax.lax.Precision.HIGHEST

        H, Phi, K, F, *_ = block_operators_f64(design, self.block_size)
        npdt = np.dtype(dtype)
        self._H = H.astype(npdt)
        self._Phi = Phi.astype(npdt)
        self._K = K.astype(npdt)
        self._F = F.astype(npdt)
        self._F64 = F
        self.state_dim = F.shape[0]
        self._apow_cache = {}
        self._jit_cache = {}

    # -- host-side shard-transition powers (depend on blocks/shard) --------
    def _apow(self, nb_local: int) -> jnp.ndarray:
        """(P+1, D, D) stack of Fs^p, Fs = F^nb_local, in f64 then cast."""
        if nb_local not in self._apow_cache:
            Fs = np.linalg.matrix_power(self._F64, nb_local)
            D = Fs.shape[0]
            out = np.empty((self.n_seq + 1, D, D))
            out[0] = np.eye(D)
            for i in range(1, self.n_seq + 1):
                out[i] = Fs @ out[i - 1]
            self._apow_cache[nb_local] = out.astype(np.dtype(self.dtype))
        return self._apow_cache[nb_local]

    # -- the per-device computation (runs inside shard_map) ----------------
    def _local(self, apow: jnp.ndarray, xl: jnp.ndarray, s0: jnp.ndarray):
        """xl: (C_l, T_l) local time shard; s0: (C_l, D) global init state."""
        H, Phi, K, F = self._H, self._Phi, self._K, self._F
        B = self.block_size
        nb = xl.shape[-1] // B
        xb = xl.reshape(xl.shape[:-1] + (nb, B))

        # Input-driven work — all matmuls, parallel over (channels, blocks).
        conv = jnp.einsum("ij,ckj->cki", H, xb, preferred_element_type=xb.dtype,
                          precision=self.precision)
        kx = jnp.einsum("dj,ckj->ckd", K, xb, preferred_element_type=xb.dtype,
                          precision=self.precision)

        kx_t = jnp.moveaxis(kx, 1, 0)  # (nb, C_l, D)

        def step(s, k):
            return jnp.einsum("de,ce->cd", F, s,
                              preferred_element_type=s.dtype,
                              precision=self.precision) + k, s

        # Zero-init local scan: input-driven shard-final state k_shard.
        # (pcast: the carry becomes device-varying along sp once it mixes
        # with the sharded inputs, so the init must be marked varying too.)
        zero = jax.lax.pcast(jnp.zeros_like(s0), SEQ_AXIS, to="varying")
        k_shard, _ = jax.lax.scan(step, zero, kx_t)

        # One all_gather of the tiny k vectors; closed-form incoming state.
        kall = jax.lax.all_gather(k_shard, SEQ_AXIS)  # (P, C_l, D)
        i = jax.lax.axis_index(SEQ_AXIS)
        j = jnp.arange(self.n_seq)
        sel = jnp.clip(i - 1 - j, 0, self.n_seq)
        w = jnp.where((j < i)[:, None, None], jnp.take(apow, sel, axis=0), 0.0)
        s_in = (jnp.einsum("de,ce->cd", jnp.take(apow, i, axis=0), s0,
                           preferred_element_type=s0.dtype,
                           precision=self.precision)
                + jnp.einsum("jde,jce->cd", w, kall,
                             preferred_element_type=s0.dtype,
                             precision=self.precision))

        # Replicated global final state via psum (streaming handoff).
        own_w = jnp.take(apow, self.n_seq - 1 - i, axis=0)
        s_fin = (jnp.einsum("de,ce->cd", apow[self.n_seq], s0,
                            preferred_element_type=s0.dtype,
                            precision=self.precision)
                 + jax.lax.psum(jnp.einsum("de,ce->cd", own_w, k_shard,
                                           preferred_element_type=s0.dtype,
                                           precision=self.precision),
                                SEQ_AXIS))

        # Correct-init local scan for per-block state starts, then outputs.
        _, s_starts = jax.lax.scan(step, s_in, kx_t)
        s_starts = jnp.moveaxis(s_starts, 0, 1)  # (C_l, nb, D)
        y = conv + jnp.einsum("id,ckd->cki", Phi, s_starts,
                              preferred_element_type=xb.dtype,
                          precision=self.precision)
        return y.reshape(xl.shape), s_fin

    def _build(self, c: int, t: int):
        key = (c, t)
        if key not in self._jit_cache:
            t_local = t // self.n_seq
            nb_local = t_local // self.block_size
            apow = self._apow(nb_local)

            fn = jax.shard_map(
                lambda xl, s0: self._local(apow, xl, s0),
                mesh=self.mesh,
                in_specs=(P(DATA_AXIS, SEQ_AXIS), P(DATA_AXIS, None)),
                out_specs=(P(DATA_AXIS, SEQ_AXIS), P(DATA_AXIS, None)),
            )
            self._jit_cache[key] = jax.jit(fn)
        return self._jit_cache[key]

    def __call__(self, x: jnp.ndarray,
                 state: Optional[IIRState] = None
                 ) -> Tuple[jnp.ndarray, IIRState]:
        if x.ndim != 2:
            raise ValueError("ShardedBlockIIR expects x of shape (C, T)")
        c, t = x.shape
        stride = self.n_seq * self.block_size
        if t % stride != 0:
            raise ValueError(
                f"T={t} must be a multiple of sp*block = {stride}")
        if c % self.n_data != 0:
            raise ValueError(f"C={c} must be a multiple of dp={self.n_data}")
        m = self.design.nsections
        if state is None:
            state = iir_init(m, (c,), dtype=self.dtype)
        s0 = state.y_hist.reshape(c, -1)
        y, s_fin = self._build(c, t)(x.astype(self.dtype), s0)
        return y, IIRState(s_fin.reshape(c, m + 1, 2))
