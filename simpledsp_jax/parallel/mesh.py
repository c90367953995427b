"""Device-mesh construction for the sharded signal pipeline.

The framework's two parallelism axes (SURVEY.md §2b):

* ``"dp"`` — data/channel parallelism: independent channels/batches of the
  signal chain (the batched promotion of the reference's one-filter-per-channel
  usage, reference: test/testIIR.cpp:37).
* ``"sp"`` — sequence/block parallelism: contiguous time shards of one long
  signal (the multi-device promotion of the reference's streaming carried-state
  contract, reference: include/sdsp/casc_2o_iir.h:78-79).

On several hosts, ``jax.distributed.initialize`` + these helpers lay the
``dp`` axis across hosts and ``sp`` within a host, so that the
latency-sensitive halo/state collectives stay on the intra-host links.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = [
    "DATA_AXIS",
    "SEQ_AXIS",
    "make_mesh",
    "single_device_mesh",
    "shard_signal",
    "replicate",
]

DATA_AXIS = "dp"
SEQ_AXIS = "sp"


def make_mesh(dp: Optional[int] = None, sp: Optional[int] = None,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a ``(dp, sp)`` mesh over the given (default: all) devices.

    With neither size given, all devices go to the sequence axis — the halo
    and state collectives then stay on the intra-host links, and data parallelism is handled
    by adding hosts.  Sizes must multiply to the device count.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if dp is None and sp is None:
        dp, sp = 1, n
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"mesh {dp}x{sp} != device count {n}")
    arr = np.asarray(devices).reshape(dp, sp)
    return Mesh(arr, (DATA_AXIS, SEQ_AXIS))


def single_device_mesh() -> Mesh:
    """1x1 mesh on the default device — lets the sharded pipeline run
    unmodified on one device."""
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                (DATA_AXIS, SEQ_AXIS))


def shard_signal(mesh: Mesh, x: jax.Array) -> jax.Array:
    """Place a (channels, T) signal with channels over dp, time over sp."""
    if x.ndim == 1:
        spec = PartitionSpec(SEQ_AXIS)
    else:
        spec = PartitionSpec(DATA_AXIS, *([None] * (x.ndim - 2)), SEQ_AXIS)
    return jax.device_put(x, NamedSharding(mesh, spec))


def replicate(mesh: Mesh, x: jax.Array) -> jax.Array:
    return jax.device_put(x, NamedSharding(mesh, PartitionSpec()))
