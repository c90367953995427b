"""Benchmark: north-star chain throughput on one GPU.

Workload (BASELINE.md): 8th-order (4-SOS) Butterworth IIR into framed
4096-pt FFT, streaming with carried state — the composition of the
reference's two capabilities (reference: include/sdsp/casc_2o_iir.h:36 +
include/sdsp/fft.h:301).  Reference baseline: 47.1 Msamples/s single-core
C++ f64 (BASELINE.md).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Msamples/s", "vs_baseline": N,
   "detail": {... "device": {platform, device_kind, count, card}}}

Every run first checks the compiled chain against the float64 scipy
oracle (>= 130 dB SNR on 2 channels).  Anything but a GPU is refused.
"""

import json

import numpy as np

BASELINE_MSPS = 47.1  # BASELINE.md north-star chain, 1 Xeon core
MIN_SNR_DB = 130.0


def main():
    import jax
    import jax.numpy as jnp
    from simpledsp_jax.models.northstar import NorthStarChain
    from simpledsp_jax.models.reference import chain_spectra, snr_db
    from simpledsp_jax.utils.benchmark import (device_detail, require_gpu,
                                               time_streaming)
    from simpledsp_jax.utils.compile_cache import enable_compile_cache

    require_gpu()
    enable_compile_cache()
    # 64 channels x 1M samples = 67 Msamples/call (f32 in, packed
    # one-sided spectra out).  Streaming pipeline: state chained
    # call-to-call, waited on once per loop — the production pattern.
    c, t = 64, 1 << 20
    chain = NorthStarChain(fft_size=4096, block_size=256, dtype=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
    x_host = np.random.default_rng(0).standard_normal((c, t)).astype(
        np.float32)
    x = jnp.asarray(x_host)

    # Parity gate on what the timed program computes, before timing.
    (sr, si), _ = chain(x)
    got = (np.asarray(sr[:2], np.float64)
           + 1j * np.asarray(si[:2], np.float64))
    snr = snr_db(got, chain_spectra(chain.design, x_host[:2], 4096))
    if not snr >= MIN_SNR_DB:
        raise SystemExit(f"chain parity FAILED: {snr:.2f} dB < {MIN_SNR_DB}")

    dt = float(np.median([time_streaming(chain, x, None, iters=16)
                          for _ in range(5)]))
    msps = c * t / dt / 1e6
    print(json.dumps({
        "metric": "northstar_chain_8sos_iir_4096fft_throughput",
        "value": msps,
        "unit": "Msamples/s",
        "vs_baseline": msps / BASELINE_MSPS,
        "detail": {
            "channels": c, "samples_per_channel": t,
            "seconds_per_call": dt, "dtype": "float32",
            "precision": "HIGHEST", "parity_snr_db": snr,
            "device": device_detail(),
            "baseline": f"{BASELINE_MSPS} Msamples/s (1 Xeon core, f64 C++)",
        },
    }), flush=True)


if __name__ == "__main__":
    main()
