"""Halo-exchange FIR / polyphase / channelizer over a device mesh.

FIR-family ops need the previous ``hist`` input samples at every shard
boundary (overlap-save).  Sharding time over the ``sp`` mesh axis, the halo
is ONE ``ppermute`` ring shift over the device links of each shard's tail to its right
neighbor (SURVEY.md §2b "overlap-save halo exchange"); device 0 receives the
carried streaming state instead, so blockwise-across-calls == whole-signal
still holds at shard granularity (the reference's streaming contract,
reference: test/testIIR.cpp:61-75, promoted to devices).

The local compute is byte-identical to the single-device polyphase /
channelizer kernels (ops/fir.py, ops/channelizer.py) — the parallel layer
only supplies the halo, which is why the sharded results match the serial
oracle exactly (up to nothing: same ops, same order).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from simpledsp_jax.ops.channelizer import PFBChannelizer
from simpledsp_jax.ops.fir import FIRState, PolyphaseResampler, fir_init
from simpledsp_jax.parallel.mesh import DATA_AXIS, SEQ_AXIS

__all__ = ["halo_exchange", "ShardedFIR", "ShardedChannelizer",
           "ShardedOverlapSaveFIR", "ShardedConvolve"]


def halo_exchange(xl: jnp.ndarray, hist: int, carried: jnp.ndarray,
                  axis_name: str = SEQ_AXIS) -> jnp.ndarray:
    """Prefix each time shard with its left neighbor's last ``hist`` samples.

    xl: (..., T_local) local shard.  carried: (..., hist) streaming history
    for the global stream start (device 0's prefix).  Returns
    (..., hist + T_local).  One ppermute; devices with no left
    neighbor get zeros from ppermute and select the carried state instead.
    """
    if hist == 0:
        return xl
    if xl.shape[-1] < hist:
        raise ValueError(
            f"time shard of {xl.shape[-1]} samples is shorter than the "
            f"required halo of {hist}; use longer shards (T_local >= "
            f"filter history) or fewer sequence shards")
    n = jax.lax.axis_size(axis_name)
    tail = xl[..., -hist:]
    if n > 1:
        recv = jax.lax.ppermute(tail, axis_name,
                                [(i, i + 1) for i in range(n - 1)])
    else:
        recv = jnp.zeros_like(tail)
    i = jax.lax.axis_index(axis_name)
    prefix = jnp.where(i == 0, carried.astype(xl.dtype), recv)
    return jnp.concatenate([prefix, xl], axis=-1)


def _replicated_tail(xp_l: jnp.ndarray, hist: int,
                     axis_name: str = SEQ_AXIS) -> jnp.ndarray:
    """Last ``hist`` samples of the *global* stream, replicated over the
    sequence axis (becomes the next call's carried state)."""
    n = jax.lax.axis_size(axis_name)
    i = jax.lax.axis_index(axis_name)
    tail = xp_l[..., -hist:]
    mask = (i == n - 1).astype(tail.dtype)
    return jax.lax.psum(tail * mask, axis_name)


class ShardedFIR:
    """Polyphase FIR / resampler sharded (channels over dp) x (time over sp).

    Wraps a :class:`~simpledsp_jax.ops.fir.PolyphaseResampler`: identical
    semantics to the serial op (scipy.upfirdn), with the shard halo supplied
    by ``halo_exchange``.  Each local shard length must be a multiple of
    ``down`` so every shard starts at output phase 0.
    """

    def __init__(self, taps: np.ndarray, mesh: Mesh, up: int = 1,
                 down: int = 1, dtype=jnp.float32):
        self.rs = PolyphaseResampler(taps, up=up, down=down, dtype=dtype)
        self.mesh = mesh
        self.n_seq = mesh.shape[SEQ_AXIS]
        self.n_data = mesh.shape[DATA_AXIS]
        self.dtype = dtype
        self._jit_cache = {}

    @property
    def hist_len(self) -> int:
        return self.rs.hist_len

    def _local(self, xl: jnp.ndarray, carried: jnp.ndarray):
        xp = halo_exchange(xl, self.rs.hist_len, carried)
        y = self.rs._run(xp)
        new_hist = (_replicated_tail(xp, self.rs.hist_len)
                    if self.rs.hist_len else carried)
        return y, new_hist

    def _build(self, c: int, t: int):
        key = (c, t)
        if key not in self._jit_cache:
            fn = jax.shard_map(
                self._local, mesh=self.mesh,
                in_specs=(P(DATA_AXIS, SEQ_AXIS), P(DATA_AXIS, None)),
                out_specs=(P(DATA_AXIS, SEQ_AXIS), P(DATA_AXIS, None)),
            )
            self._jit_cache[key] = jax.jit(fn)
        return self._jit_cache[key]

    def __call__(self, x: jnp.ndarray,
                 state: Optional[FIRState] = None
                 ) -> Tuple[jnp.ndarray, FIRState]:
        if x.ndim != 2:
            raise ValueError("ShardedFIR expects x of shape (C, T)")
        c, t = x.shape
        t_local = t // self.n_seq
        if t_local * self.n_seq != t or t_local % self.rs.down != 0:
            raise ValueError(
                f"T={t} must split into sp={self.n_seq} shards with local "
                f"length a multiple of down={self.rs.down}")
        if state is None:
            state = fir_init(self.rs.hist_len, (c,), dtype=self.dtype)
        y, hist = self._build(c, t)(x.astype(self.dtype), state.hist)
        return y, FIRState(hist)


class ShardedChannelizer:
    """PFB channelizer sharded (channels over dp) x (time over sp).

    Local shards run the serial polyphase-branch + batched-FFT kernel
    (ops/channelizer.py); the halo supplies the L-1 cross-shard history.
    Output: (C, T // M, M) with the frame axis sharded over sp — each
    device holds the spectra of its own time span (no gather needed until
    a consumer wants global frames; then it is one all_gather).
    """

    def __init__(self, num_channels: int, mesh: Mesh,
                 taps: Optional[np.ndarray] = None,
                 taps_per_channel: int = 16, dtype=jnp.float32,
                 gather_output: bool = False):
        self.pfb = PFBChannelizer(num_channels, taps=taps,
                                  taps_per_channel=taps_per_channel,
                                  dtype=dtype)
        self.mesh = mesh
        self.n_seq = mesh.shape[SEQ_AXIS]
        self.dtype = dtype
        # gather_output: all_gather each shard's channel frames over the
        # sequence axis so every device holds the full (T//M, M)
        # output — the "allgather for channelizer outputs" pattern
        # (BASELINE.json north star) for consumers that need global frames.
        self.gather_output = gather_output
        self._jit_cache = {}

    def _local(self, xl: jnp.ndarray, carried: jnp.ndarray):
        xp = halo_exchange(xl, self.pfb.hist_len, carried)
        y = self.pfb._run(xp)
        new_hist = _replicated_tail(xp, self.pfb.hist_len)
        if self.gather_output:
            # Replicated global frames: scatter the local slice into a
            # zero canvas and psum over the sequence axis (psum output is
            # statically inferred replicated, unlike all_gather's).
            i = jax.lax.axis_index(SEQ_AXIS)
            g_local = y.shape[-2]  # y: (C_l, G_local, M) — frames at -2
            canvas = jnp.zeros(y.shape[:-2] + (g_local * self.n_seq,
                                               y.shape[-1]), dtype=y.dtype)
            canvas = jax.lax.dynamic_update_slice_in_dim(
                canvas, y, i * g_local, axis=-2)
            y = jax.lax.psum(canvas, SEQ_AXIS)
        return y, new_hist

    def _build(self, c: int, t: int):
        key = (c, t)
        if key not in self._jit_cache:
            y_spec = (P(DATA_AXIS, None, None) if self.gather_output
                      else P(DATA_AXIS, SEQ_AXIS, None))
            fn = jax.shard_map(
                self._local, mesh=self.mesh,
                in_specs=(P(DATA_AXIS, SEQ_AXIS), P(DATA_AXIS, None)),
                out_specs=(y_spec, P(DATA_AXIS, None)),
            )
            self._jit_cache[key] = jax.jit(fn)
        return self._jit_cache[key]

    def __call__(self, x: jnp.ndarray,
                 state: Optional[FIRState] = None
                 ) -> Tuple[jnp.ndarray, FIRState]:
        if x.ndim != 2:
            raise ValueError("ShardedChannelizer expects x of shape (C, T)")
        c, t = x.shape
        m = self.pfb.m
        t_local = t // self.n_seq
        if t_local * self.n_seq != t or t_local % m != 0:
            raise ValueError(
                f"T={t} must split into sp={self.n_seq} shards with local "
                f"length a multiple of M={m}")
        if state is None:
            state = fir_init(self.pfb.hist_len, (c,), dtype=x.dtype)
        y, hist = self._build(c, t)(x, state.hist.astype(x.dtype))
        return y, FIRState(hist)


class ShardedConvolve:
    """Centered ("same") convolution sharded (channels dp) x (time sp).

    ``ops.conv.convolve(x, h, mode="same")`` promoted to the mesh: each
    shard runs the serial convolve (OLS / FFT / direct route picked by the
    same heuristics) on its halo-prefixed span, then ONE extra ppermute
    shifts shard outputs left by (m-1)//2 samples to realize the centered
    alignment — the left halo supplies trailing context, the right
    neighbor's head supplies the centered look-ahead.  Matches the serial
    op exactly (same ops, same order, zero-padded signal ends).
    """

    def __init__(self, taps: np.ndarray, mesh: Mesh, dtype=jnp.float32,
                 method: str = "auto"):
        self.h = np.asarray(taps, dtype=np.float64)
        if self.h.ndim != 1 or self.h.size == 0:
            raise ValueError("taps must be a non-empty 1-D array")
        self.m = self.h.size
        self.shift = (self.m - 1) // 2   # "same" center offset
        self.mesh = mesh
        self.n_seq = mesh.shape[SEQ_AXIS]
        self.dtype = dtype
        self.method = method
        self._jit_cache = {}

    def _local(self, xl: jnp.ndarray):
        from simpledsp_jax.ops.conv import convolve
        t_local = xl.shape[-1]
        m, s = self.m, self.shift
        zeros_h = jnp.zeros(xl.shape[:-1] + (m - 1,), xl.dtype)
        xp = halo_exchange(xl, m - 1, zeros_h)
        if s:
            xp = jnp.concatenate(
                [xp, jnp.zeros(xl.shape[:-1] + (s,), xl.dtype)], axis=-1)
        # Causal outputs y_full[t0 .. t0+T_local+s): the m-1 halo supplies
        # the left context, the s zeros stand in for the right neighbor.
        ye = convolve(xp, self.h.astype(np.dtype(xl.dtype)), mode="full",
                      method=self.method)[..., m - 1: m - 1 + t_local + s]
        if s == 0:
            return ye
        n = jax.lax.axis_size(SEQ_AXIS)
        # Right neighbor's first s causal outputs == this shard's centered
        # tail; the LAST shard's zero-padded tail is already correct (the
        # convolution tail past the signal end).
        if n > 1:
            recv = jax.lax.ppermute(ye[..., :s], SEQ_AXIS,
                                    [(i, i - 1) for i in range(1, n)])
        else:
            recv = jnp.zeros_like(ye[..., :s])
        i = jax.lax.axis_index(SEQ_AXIS)
        tail = jnp.where(i == n - 1, ye[..., t_local:], recv)
        return jnp.concatenate([ye[..., s: t_local], tail], axis=-1)

    def _build(self, c: int, t: int):
        key = (c, t)
        if key not in self._jit_cache:
            fn = jax.shard_map(
                self._local, mesh=self.mesh,
                in_specs=P(DATA_AXIS, SEQ_AXIS),
                out_specs=P(DATA_AXIS, SEQ_AXIS),
            )
            self._jit_cache[key] = jax.jit(fn)
        return self._jit_cache[key]

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        if x.ndim != 2:
            raise ValueError("ShardedConvolve expects x of shape (C, T)")
        c, t = x.shape
        t_local = t // self.n_seq
        if t_local * self.n_seq != t:
            raise ValueError(f"T={t} not divisible by sp={self.n_seq}")
        if t_local < self.m - 1 or t_local < self.shift:
            raise ValueError(
                f"local shard of {t_local} samples is shorter than the "
                f"{self.m - 1}-sample halo; use fewer sequence shards")
        return self._build(c, t)(x.astype(self.dtype))


class ShardedOverlapSaveFIR:
    """FFT-domain overlap-save convolution sharded (channels dp) x (time sp).

    Long-tap FIR where the per-shard compute is the serial
    :class:`~simpledsp_jax.ops.fir.OverlapSaveFIR` (batched matmul-FFT
    frames); the cross-shard overlap is the same single ppermute halo as
    the direct form — overlap-save IS the halo pattern (SURVEY.md §2b).
    """

    def __init__(self, taps: np.ndarray, mesh: Mesh, block_size: int = 1024,
                 dtype=jnp.float32):
        from simpledsp_jax.ops.fir import OverlapSaveFIR
        self.os = OverlapSaveFIR(taps, block_size=block_size, dtype=dtype)
        self.mesh = mesh
        self.n_seq = mesh.shape[SEQ_AXIS]
        self.dtype = dtype
        self._jit_cache = {}

    def _local(self, xl: jnp.ndarray, carried: jnp.ndarray):
        xp = halo_exchange(xl, self.os.hist_len, carried)
        y = self.os._run(xp)
        return y, _replicated_tail(xp, self.os.hist_len)

    def _build(self, c: int, t: int):
        key = (c, t)
        if key not in self._jit_cache:
            fn = jax.shard_map(
                self._local, mesh=self.mesh,
                in_specs=(P(DATA_AXIS, SEQ_AXIS), P(DATA_AXIS, None)),
                out_specs=(P(DATA_AXIS, SEQ_AXIS), P(DATA_AXIS, None)),
            )
            self._jit_cache[key] = jax.jit(fn)
        return self._jit_cache[key]

    def __call__(self, x: jnp.ndarray,
                 state: Optional[FIRState] = None
                 ) -> Tuple[jnp.ndarray, FIRState]:
        if x.ndim != 2:
            raise ValueError("ShardedOverlapSaveFIR expects x of shape (C, T)")
        c, t = x.shape
        t_local = t // self.n_seq
        if t_local * self.n_seq != t or t_local % self.os.block_size != 0:
            raise ValueError(
                f"T={t} must split into sp={self.n_seq} shards with local "
                f"length a multiple of block={self.os.block_size}")
        if state is None:
            state = fir_init(self.os.hist_len, (c,), dtype=self.dtype)
        y, hist = self._build(c, t)(x.astype(self.dtype), state.hist)
        return y, FIRState(hist)
