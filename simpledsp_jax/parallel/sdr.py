"""dp-sharded SDR receiver banks: many streams across devices.

The banks are embarrassingly parallel over streams (the batched promotion
of the reference's one-filter-instance-per-channel usage, reference:
test/testIIR.cpp:37): the batch axis shards over the ``dp`` mesh axis
with ZERO collectives, and every per-stream state leaf (channelizer
history, demod phase, decimator history) shards alongside.  Per shard the
bank's full forward runs unchanged.  Time stays local: the banks are
one-pass streaming pipelines whose only cross-call coupling is the tiny
per-stream history, so sequence sharding would buy nothing (contrast the
IIR chain, whose state recurrence needs the parallel/iir.py closed form).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from simpledsp_jax.models.sdr import SDRState
from simpledsp_jax.parallel.mesh import DATA_AXIS

__all__ = ["ShardedReceiverBank"]


class ShardedReceiverBank:
    """Wrap an :class:`FMReceiverBank` / :class:`AMReceiverBank` as one
    jitted shard_map program over the mesh's ``dp`` axis.

    Call with x: (B, T) complex (or an (xr, xi) float-plane pair),
    B a multiple of the dp axis size; returns (audio, state) exactly as
    the wrapped bank — shard-for-shard identical to running the serial
    bank on each stream.
    """

    def __init__(self, bank, mesh: Mesh):
        self.bank = bank
        self.mesh = mesh
        self.n_data = mesh.shape[DATA_AXIS]
        xs = P(DATA_AXIS, None)
        self._fn = jax.jit(jax.shard_map(
            bank._forward, mesh=mesh,
            in_specs=(xs, xs, P(DATA_AXIS)),
            out_specs=(P(DATA_AXIS), P(DATA_AXIS))))

    def init_state(self, batch: int) -> SDRState:
        return self.bank.init_state(batch)

    def __call__(self, x: Union[jnp.ndarray,
                                Tuple[jnp.ndarray, jnp.ndarray]],
                 state: Optional[SDRState] = None
                 ) -> Tuple[jnp.ndarray, SDRState]:
        if isinstance(x, (tuple, list)):
            xr, xi = x
        elif jnp.iscomplexobj(x):
            if isinstance(x, np.ndarray):
                xr = jnp.asarray(x.real, dtype=self.bank.dtype)
                xi = jnp.asarray(x.imag, dtype=self.bank.dtype)
            else:
                xr = jnp.real(x).astype(self.bank.dtype)
                xi = jnp.imag(x).astype(self.bank.dtype)
        else:
            xr = jnp.asarray(x, dtype=self.bank.dtype)
            xi = jnp.zeros_like(xr)
        b, t = xr.shape
        if b % self.n_data:
            raise ValueError(
                f"batch {b} must be a multiple of the dp axis size "
                f"{self.n_data}")
        if t % (self.bank.m * self.bank.decim) != 0:
            raise ValueError(
                f"T={t} must be a multiple of M*decim="
                f"{self.bank.m * self.bank.decim}")
        if state is None:
            state = self.init_state(b)
        return self._fn(xr, xi, state)
