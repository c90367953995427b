"""Weak-scaling benchmark of the sharded north-star chain.

North-star target (BASELINE.json): >= 90% weak-scaling efficiency.  The
chain runs sequence-parallel on 1, 2, 4, ... of the devices JAX sees, with
constant work per device, and each line names the platform it ran on:

    python bench_scaling.py                 # the GPUs of this host
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python bench_scaling.py             # mechanism check, virtual CPUs

A virtual-CPU run checks the sharded program and its collectives; it says
nothing about scaling on hardware.  Prints one JSON line per mesh size
plus a summary efficiency line.
"""

import json

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from simpledsp_jax.models.northstar import ShardedNorthStarChain
    from simpledsp_jax.parallel import make_mesh
    from simpledsp_jax.utils.benchmark import time_streaming
    from simpledsp_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    d = jax.devices()[0]
    hardware = f"{len(jax.devices())}x {d.platform} {d.device_kind}"
    rng = np.random.default_rng(0)
    c = 8
    t_per_dev = 1 << 16  # weak scaling: constant work per device
    results = []
    for sp in (1, 2, 4, 8):
        if sp > len(jax.devices()):
            break
        mesh = make_mesh(dp=1, sp=sp, devices=jax.devices()[:sp])
        chain = ShardedNorthStarChain(mesh, fft_size=4096, block_size=256,
                                      dtype=jnp.float32)
        t = sp * t_per_dev
        x = jnp.asarray(rng.standard_normal((c, t)), dtype=jnp.float32)
        dt = time_streaming(chain, x, None, iters=4, warmup=1)
        msps = c * t / dt / 1e6
        results.append((sp, msps))
        print(json.dumps({"metric": "sharded_chain_weak_scaling",
                          "devices": sp, "value": msps,
                          "unit": "Msamples/s", "hardware": hardware}))

    if len(results) > 1:
        base = results[0][1]
        eff = [m / (base * sp) for sp, m in results]
        print(json.dumps({"metric": "weak_scaling_efficiency",
                          "value": min(eff[1:]),
                          "unit": "fraction",
                          "per_mesh": {str(sp): e
                                       for (sp, _), e in zip(results, eff)},
                          "hardware": hardware}))


if __name__ == "__main__":
    main()
