"""Mesh/sharding layer: shard_map pipelines and halo exchange."""

from simpledsp_jax.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    make_mesh,
    replicate,
    shard_signal,
    single_device_mesh,
)
from simpledsp_jax.parallel.iir import ShardedBlockIIR
from simpledsp_jax.parallel.sdr import ShardedReceiverBank
from simpledsp_jax.parallel.fir import (
    ShardedChannelizer,
    ShardedConvolve,
    ShardedFIR,
    ShardedOverlapSaveFIR,
    halo_exchange,
)
from simpledsp_jax.parallel.spectral import ShardedSTFT
