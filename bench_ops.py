"""Per-op benchmarks against every BASELINE.md row (the reference's own
Catch2 BENCHMARK workloads, scaled to batch throughput on one GPU).

The reference benchmarks single blocks on one CPU core; device throughput
comes from batch, so each op runs on a large batch, timed with
``block_until_ready``, and reports Msamples/s against the measured C++
single-core number.  Every row runs at HIGHEST precision (true f32).
Prints one JSON line per row; anything but a GPU is refused.

    python bench_ops.py [--assert-floor X]

``--assert-floor X`` exits nonzero if any row drops below X times its
reference baseline.
"""

import argparse
import json

import numpy as np

# BASELINE.md measured reference numbers (1 Xeon core, f64 C++).
BASE = {
    "fft_radix2_1024": 116.0,
    "fft_radix4_1024": 121.3,
    "fft_radix2_4096": 90.2,
    "fft_radix4_4096": 81.0,
    "iir_lp_8th_order": 168.5,
    "iir_hp_8th_order": 168.0,
    "iir_bp_8th_order": 165.8,
    "chain_iir8_fft4096": 47.1,
}


def main():
    import jax
    import jax.numpy as jnp
    from simpledsp_jax.design.biquad import (
        design_bandpass, design_highpass, design_lowpass)
    from simpledsp_jax.models.northstar import NorthStarChain
    from simpledsp_jax.ops.fft import rfft_ri
    from simpledsp_jax.ops.iir import BlockIIR
    from simpledsp_jax.utils.benchmark import (device_detail, require_gpu,
                                               time_blocked, time_streaming)
    from simpledsp_jax.utils.compile_cache import enable_compile_cache

    require_gpu()
    enable_compile_cache()
    device = device_detail()
    highest = jax.lax.Precision.HIGHEST
    rng = np.random.default_rng(0)
    results = []

    def emit(name, nsamples, dt):
        msps = nsamples / dt / 1e6
        rec = {"metric": name, "value": msps, "unit": "Msamples/s",
               "vs_baseline": msps / BASE[name],
               "baseline_cpp_1core": BASE[name], "precision": "HIGHEST",
               "seconds_per_call": dt, "device": device}
        results.append(rec)
        print(json.dumps(rec), flush=True)

    def median(fn, reps=3):
        return float(np.median([fn() for _ in range(reps)]))

    # FFT rows: batched real frames of the reference's sizes (radix choice
    # is an internal schedule in the reference; both rows run one rfft).
    total = 1 << 26
    for n in (1024, 4096):
        x = jnp.asarray(rng.standard_normal((total // n, n)), jnp.float32)
        fn = jax.jit(rfft_ri)
        dt = median(lambda: time_blocked(fn, x, iters=12))
        emit(f"fft_radix2_{n}", total, dt)
        emit(f"fft_radix4_{n}", total, dt)

    # IIR rows: 8th-order (4-SOS) block-state-space, 64ch x 1M samples.
    c, t = 64, 1 << 20
    x = jnp.asarray(rng.standard_normal((c, t)), jnp.float32)
    fs = 39000.0
    for name, design in (
            ("iir_lp_8th_order", design_lowpass(4, 2000.0, fs)),
            ("iir_hp_8th_order", design_highpass(4, 2000.0, fs)),
            ("iir_bp_8th_order", design_bandpass(4, 2000.0, fs, 0.8))):
        f = BlockIIR(design, block_size=256, dtype=jnp.float32,
                     precision=highest)
        xb = x.reshape(c, -1, 256)
        s0 = jnp.zeros((c, 10), jnp.float32)
        step = jax.jit(f.run_blocks)
        dt = median(lambda: time_streaming(step, xb, s0, iters=12))
        emit(name, c * t, dt)

    # Chain row: bench.py's configuration.
    chain = NorthStarChain(fft_size=4096, block_size=256, dtype=jnp.float32,
                           precision=highest)
    dt = median(lambda: time_streaming(chain, x, None, iters=16))
    emit("chain_iir8_fft4096", c * t, dt)

    worst = min(r["vs_baseline"] for r in results)
    print(json.dumps({"metric": "bench_ops_summary",
                      "rows": len(results),
                      "min_vs_baseline": worst,
                      "all_beat_reference": worst > 1.0,
                      "device": device}))
    return worst, results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--assert-floor", type=float, default=None,
                    help="exit 1 if any row's vs_baseline drops below this")
    args = ap.parse_args()
    worst, rows = main()
    if args.assert_floor is not None and worst < args.assert_floor:
        raise SystemExit(
            f"PERF REGRESSION: min vs_baseline {worst} < floor "
            f"{args.assert_floor}")
