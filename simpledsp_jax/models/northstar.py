"""The north-star signal chain: 8-SOS Butterworth IIR -> 4096-pt FFT.

This is the framework's flagship "model" (BASELINE.md headline metric): the
composition of the reference's two capabilities — cascaded-biquad filtering
(reference: include/sdsp/casc_2o_iir.h:36) into a power-of-4 FFT (reference:
include/sdsp/fft.h:301) — batched over channels and framed over time, as one
jitted XLA program.  The reference's tests compose the two manually; here the
chain is a first-class component with carried streaming state.

Serial form (:class:`NorthStarChain`) runs on one device; the sharded form
(:class:`ShardedNorthStarChain`) runs the IIR sequence-parallel over the
``sp`` mesh axis and keeps the FFT frames local to each shard, so the only
cross-device traffic is the tiny IIR state collective (parallel/iir.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from simpledsp_jax.design.biquad import BiquadCascadeDesign, design_lowpass
from simpledsp_jax.ops import fft as _fft
from simpledsp_jax.ops.iir import BlockIIR, IIRState, iir_init
from simpledsp_jax.parallel.iir import ShardedBlockIIR
from simpledsp_jax.parallel.mesh import DATA_AXIS, SEQ_AXIS

__all__ = ["default_design", "NorthStarChain", "ShardedNorthStarChain"]


def default_design(fs: float = 39000.0) -> BiquadCascadeDesign:
    """The benchmark configuration: 8th-order (4-SOS) low-pass at the golden
    fixtures' sample rate (reference: test_data/WriteImpulse.m:7-14)."""
    return design_lowpass(4, 2000.0, fs)


class NorthStarChain:
    """Streaming IIR -> framed FFT on one device.

    Call with x: (C, T), T a multiple of fft_size; returns
    (((spec_re, spec_im) each (C, T // fft_size, fft_size // 2)), state) —
    RI float planes (complex never materializes) holding the
    PACKED ONE-SIDED spectrum of each frame: the input is real, so bins
    above N/2 are conjugate-redundant and are never computed, written, or
    reordered (half the FFT matmuls and output traffic).  Bin k of the
    planes is X[k] for k < N/2; the (real) Nyquist bin X[N/2] is packed in
    ``spec_im[..., 0]`` (the Im X[0] == 0 slot — FFTW halfcomplex
    convention).  ``ops.fft.unpack_rfft_ri`` recovers the pure N/2+1 form.
    """

    def __init__(self, design: Optional[BiquadCascadeDesign] = None,
                 fft_size: int = 4096, block_size: int = 256,
                 dtype=jnp.float32, precision=None):
        self.design = design or default_design()
        self.fft_size = int(fft_size)
        if self.fft_size % 2:
            raise ValueError("fft_size must be even (one-sided output)")
        self.dtype = dtype
        self.precision = precision
        self.iir = BlockIIR(self.design, block_size=block_size, dtype=dtype,
                            precision=precision)
        self._jit = jax.jit(self._forward)

    def _forward(self, x: jnp.ndarray, s0: jnp.ndarray):
        """Jittable body: x (C, T); s0 flat state (C, D).  Returns packed
        one-sided RI spectra planes (each (C, F, N/2)) and the final
        state."""
        y, s_fin = self.iir.run_blocks(
            x.reshape(x.shape[0], -1, self.iir.block_size), s0)
        y = y.reshape(x.shape[0], -1, self.fft_size)
        sr, si = _fft.pack_rfft_ri(*_fft.rfft_ri(y))
        return (sr, si), s_fin

    def __call__(self, x: jnp.ndarray,
                 state: Optional[IIRState] = None
                 ) -> Tuple[Tuple[jnp.ndarray, jnp.ndarray], IIRState]:
        """Returns ((spec_re, spec_im), state) as RI planes (see
        ops/demod.py DemodStateRI)."""
        c, t = x.shape
        if t % self.fft_size or t % self.iir.block_size:
            raise ValueError(
                f"T={t} must be a multiple of fft_size={self.fft_size} "
                f"and block_size={self.iir.block_size}")
        m = self.design.nsections
        if state is None:
            state = iir_init(m, (c,), dtype=self.dtype)
        s0 = state.y_hist.reshape(c, -1)
        (sr, si), s_fin = self._jit(x.astype(self.dtype), s0)
        return (sr, si), IIRState(s_fin.reshape(c, m + 1, 2))


class ShardedNorthStarChain:
    """North-star chain over a (dp, sp) mesh as ONE jitted shard_map program.

    Channels shard over ``dp``; time shards over ``sp``.  The IIR runs
    sequence-parallel (one all_gather + psum of D-dim state vectors,
    parallel/iir.py); each shard then frames its own output and FFTs
    locally — zero cross-device traffic in the FFT.  Output spectra are
    packed one-sided planes (C, T // fft_size, fft_size // 2), exactly as
    :class:`NorthStarChain` (see its docstring for the bin layout).
    """

    def __init__(self, mesh: Mesh,
                 design: Optional[BiquadCascadeDesign] = None,
                 fft_size: int = 4096, block_size: int = 256,
                 dtype=jnp.float32, precision=None):
        self.mesh = mesh
        self.design = design or default_design()
        self.fft_size = int(fft_size)
        if self.fft_size % 2:
            raise ValueError("fft_size must be even (one-sided output)")
        self.dtype = dtype
        self.precision = precision
        self.iir = ShardedBlockIIR(self.design, mesh, block_size=block_size,
                                   dtype=dtype, precision=precision)
        self._jit_cache = {}

    def _build(self, c: int, t: int):
        key = (c, t)
        if key not in self._jit_cache:
            nb_local = t // self.iir.n_seq // self.iir.block_size
            apow = self.iir._apow(nb_local)

            def local_fn(xl, s0):
                y, s_fin = self.iir._local(apow, xl, s0)
                frames = y.reshape(y.shape[0], -1, self.fft_size)
                sr, si = _fft.pack_rfft_ri(*_fft.rfft_ri(frames))
                return (sr, si), s_fin

            spectra_spec = (P(DATA_AXIS, SEQ_AXIS, None),
                            P(DATA_AXIS, SEQ_AXIS, None))
            fn = jax.shard_map(
                local_fn, mesh=self.mesh,
                in_specs=(P(DATA_AXIS, SEQ_AXIS), P(DATA_AXIS, None)),
                out_specs=(spectra_spec, P(DATA_AXIS, None)),
            )
            self._jit_cache[key] = jax.jit(fn)
        return self._jit_cache[key]

    def __call__(self, x: jnp.ndarray,
                 state: Optional[IIRState] = None
                 ) -> Tuple[jnp.ndarray, IIRState]:
        c, t = x.shape
        t_local = t // self.iir.n_seq
        if (t_local * self.iir.n_seq != t or t_local % self.fft_size
                or t_local % self.iir.block_size):
            raise ValueError(
                f"local shard length must be a multiple of fft_size="
                f"{self.fft_size} and block_size={self.iir.block_size}")
        m = self.design.nsections
        if state is None:
            state = iir_init(m, (c,), dtype=self.dtype)
        s0 = state.y_hist.reshape(c, -1)
        (sr, si), s_fin = self._build(c, t)(x.astype(self.dtype), s0)
        return (sr, si), IIRState(s_fin.reshape(c, m + 1, 2))
