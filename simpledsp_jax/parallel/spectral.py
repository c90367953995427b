"""Sequence-parallel STFT over a device mesh.

The STFT's frame f covers samples [f*hop, f*hop + nfft): sharding time
over the ``sp`` mesh axis, every shard owns the frames STARTING in its
span and needs ``nfft - hop`` look-ahead samples from its right neighbor
— the overlap-save halo pattern of parallel/fir.py run in the opposite
direction (one ppermute).  The local compute is the serial
:func:`simpledsp_jax.ops.spectral.stft_ri` (gather-free framing + the
window-folded direct DFT matmul or the four-step engine), so sharded ==
serial exactly.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from simpledsp_jax.parallel.mesh import DATA_AXIS, SEQ_AXIS

__all__ = ["ShardedSTFT"]


class ShardedSTFT:
    """STFT sharded (channels over dp) x (time/frames over sp).

    Same contract as :func:`~simpledsp_jax.ops.spectral.stft_ri` (no
    boundary padding): x (C, T) -> RI planes (C, nframes, nfft//2 + 1)
    with ``nframes = (T - nfft)//hop + 1``; the frame axis is sharded over
    ``sp`` inside the jit and re-joined lazily on fetch.  Requires
    ``hop | nfft`` (gather-free framing) and local shards of at least
    ``nfft - hop`` samples.
    """

    def __init__(self, mesh: Mesh, nfft: int = 1024, hop: int | None = None,
                 window: str = "hann", onesided: bool = True,
                 dtype=jnp.float32):
        self.nfft = int(nfft)
        self.hop = int(hop or nfft // 2)
        if self.nfft % self.hop:
            raise ValueError(
                f"ShardedSTFT needs hop | nfft, got {self.hop}/{self.nfft}")
        self.window = window
        self.onesided = onesided
        self.mesh = mesh
        self.n_seq = mesh.shape[SEQ_AXIS]
        self.dtype = dtype
        self._jit_cache = {}

    @property
    def halo(self) -> int:
        return self.nfft - self.hop

    def _local(self, xl: jnp.ndarray):
        from simpledsp_jax.ops.spectral import spectrogram_ri
        halo = self.halo
        n = jax.lax.axis_size(SEQ_AXIS)
        if halo and n > 1:
            # Right-neighbor look-ahead: shard i receives shard i+1's HEAD
            # (the mirror of halo_exchange's tail-to-the-right); the last
            # shard pads zeros — its trailing frames are the global tail
            # frames the caller slices off (stft_ri's (T-nfft)//hop + 1
            # frame count).
            recv = jax.lax.ppermute(xl[..., :halo], SEQ_AXIS,
                                    [(i, i - 1) for i in range(1, n)])
        else:
            recv = jnp.zeros(xl.shape[:-1] + (halo,), xl.dtype)
        xe = jnp.concatenate([xl, recv], axis=-1)
        return spectrogram_ri(xe, self.nfft, hop=self.hop,
                              window=self.window, onesided=self.onesided)

    def _build(self, c: int, t: int):
        key = (c, t)
        if key not in self._jit_cache:
            fn = jax.shard_map(
                self._local, mesh=self.mesh,
                in_specs=P(DATA_AXIS, SEQ_AXIS),
                out_specs=(P(DATA_AXIS, SEQ_AXIS, None),
                           P(DATA_AXIS, SEQ_AXIS, None)),
            )
            self._jit_cache[key] = jax.jit(fn)
        return self._jit_cache[key]

    def __call__(self, x: jnp.ndarray, *, padded: bool = False
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """``padded=False`` (default) returns exactly stft_ri's
        ``(T - nfft)//hop + 1`` frames.  The trailing slice is uneven
        against the frame sharding, so UNDER AN ENCLOSING JIT the SPMD
        partitioner must all-gather both spectrogram planes to apply it
        (2 x 268 MB at the bench shape, read from the compiled HLO).
        Composed-jit callers should pass ``padded=True``: the planes stay
        frame-sharded with ``T//hop`` frames, of which the last
        ``nfft//hop - 1`` are zero-lookahead tail frames to drop (or
        ignore) after the final fetch."""
        if x.ndim != 2:
            raise ValueError("ShardedSTFT expects x of shape (C, T)")
        c, t = x.shape
        t_local = t // self.n_seq
        if t_local * self.n_seq != t or t_local % self.hop:
            raise ValueError(
                f"T={t} must split into sp={self.n_seq} shards with local "
                f"length a multiple of hop={self.hop}")
        if t_local < self.halo:
            raise ValueError(
                f"local shard of {t_local} samples is shorter than the "
                f"{self.halo}-sample look-ahead; use fewer sequence shards")
        sr, si = self._build(c, t)(x.astype(self.dtype))
        if padded:
            return sr, si
        # Trailing frames of the last shard were computed from zero
        # padding; the valid global count is stft_ri's.
        nframes = (t - self.nfft) // self.hop + 1
        return sr[:, :nframes], si[:, :nframes]
