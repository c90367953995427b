"""Multi-host runtime: jax.distributed launch + host-sharded data feeding.

SURVEY.md §2b "multi-host runtime": one process per host, the ``dp``
(channel) axis laid across hosts and the ``sp`` (sequence) axis within
each host, so the IIR state collective and FIR halo ride the fast
intra-host links.

Usage, one process per host::

    from simpledsp_jax.parallel import multihost
    multihost.initialize()                       # env-driven cluster or
    multihost.initialize(coordinator="h0:1234",
                         num_processes=4, process_id=i)   # explicit
    mesh = multihost.pod_mesh()                  # dp = hosts, sp = local devices
    x_local = loader.next_block()                # each host loads ITS channels
    x = multihost.host_sharded(mesh, x_local)    # global array, no transfer
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from simpledsp_jax.parallel.mesh import DATA_AXIS, SEQ_AXIS

__all__ = ["initialize", "pod_mesh", "host_sharded", "is_initialized"]

_initialized = False


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed.  With no args, trusts the cluster
    environment to provide coordination; surfaces
    init failures with context (SURVEY.md §5 failure-detection plan)."""
    global _initialized
    if _initialized:
        return
    try:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except Exception as e:  # surface clearly, do not half-init
        raise RuntimeError(
            f"multi-host init failed (coordinator={coordinator!r}, "
            f"num_processes={num_processes}, process_id={process_id}); "
            f"check that every host runs the same binary and can reach the "
            f"coordinator: {e}") from e
    _initialized = True


def is_initialized() -> bool:
    return _initialized or jax.process_count() > 1


def pod_mesh() -> Mesh:
    """(dp=hosts, sp=devices-per-host) mesh over all devices of all hosts.

    Channel parallelism crosses hosts; the sequence axis stays inside each
    host's devices, where the halo/state collectives are cheap.
    """
    n_hosts = jax.process_count()
    per_host = jax.local_device_count()
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    arr = np.asarray(devs).reshape(n_hosts, per_host)
    return Mesh(arr, (DATA_AXIS, SEQ_AXIS))


def host_sharded(mesh: Mesh, local_channels: np.ndarray) -> jax.Array:
    """Assemble a global (C_total, T) array from each host's own channel
    block without cross-host transfer (the data-loading story: each host
    reads only its channels).
    """
    spec = PartitionSpec(DATA_AXIS, *([None] * (local_channels.ndim - 2)),
                         SEQ_AXIS)
    sharding = NamedSharding(mesh, spec)
    global_shape = (local_channels.shape[0] * jax.process_count(),
                    *local_channels.shape[1:])
    return jax.make_array_from_process_local_data(
        sharding, local_channels, global_shape)
