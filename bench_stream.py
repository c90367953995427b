"""End-to-end streaming benchmark: file -> native SPSC ring -> native IQ
converter -> FM receiver bank on the GPU -> native audio sink, with host
I/O pipelined one chunk deep against device compute.

This measures the FULL production path — including the host<->device
transfers the compute-only bench keeps resident — and attributes wall time
per stage so the "can the host keep the card fed" question gets a number
instead of an assumption (reference anchor: SURVEY.md §2a native-code
ledger).

Prints ONE JSON line:
  {"metric": "stream_e2e_fm_bank", "value": N, "unit": "Msamples/s", ...}

Run on the GPU:  python bench_stream.py   (anything else is refused)
"""

import json
import os
import tempfile
import time

import numpy as np

B, T, CHUNKS = 16, 1 << 19, 8   # 16 streams x 512k complex samples/chunk


def main():
    import jax
    import jax.numpy as jnp
    from simpledsp_jax.models.sdr import FMReceiverBank
    from simpledsp_jax.runtime.stream import (FileSink, FileSource,
                                              RingBuffer, f32_to_i16,
                                              iq16_to_planes)
    from simpledsp_jax.utils.benchmark import (device_detail, require_gpu,
                                               time_streaming)
    from simpledsp_jax.utils.compile_cache import enable_compile_cache

    require_gpu()
    enable_compile_cache()
    rng = np.random.default_rng(0)
    nbytes_chunk = B * T * 2 * 2            # interleaved int16 IQ
    tmp = tempfile.mkdtemp(prefix="sdsp_stream_")
    in_path = os.path.join(tmp, "iq16.bin")
    out_path = os.path.join(tmp, "audio_i16.bin")
    with open(in_path, "wb") as f:
        for _ in range(CHUNKS + 1):         # +1 warm-up chunk
            f.write(rng.integers(-2048, 2048, B * T * 2,
                                 dtype=np.int16).tobytes())

    bank = FMReceiverBank(16, fs=1.6e6)
    state = bank.init_state(B)

    ring_in = RingBuffer(1 << 26)
    ring_out = RingBuffer(1 << 24)
    src = FileSource(in_path, ring_in, chunk=1 << 20)
    sink = FileSink(out_path, ring_out, chunk=1 << 20)

    stage_s = {"pop": 0.0, "convert": 0.0, "submit": 0.0, "fetch": 0.0,
               "sink": 0.0}

    def one_chunk(state, pending, record=True):
        t0 = time.perf_counter()
        raw = ring_in.pop_exact(nbytes_chunk, dtype=np.int16)
        t1 = time.perf_counter()
        re, im = iq16_to_planes(raw)        # native, multithreaded
        t2 = time.perf_counter()
        planes = (jnp.asarray(re.reshape(B, T)), jnp.asarray(im.reshape(B, T)))
        audio, state = bank(planes, state)
        t3 = time.perf_counter()
        if pending is not None:
            a_host = np.asarray(pending)    # sync on the PREVIOUS chunk
            t4 = time.perf_counter()
            ring_out.push(f32_to_i16(a_host.ravel(), scale=8192.0)
                          .view(np.uint8))
            t5 = time.perf_counter()
        else:
            t4 = t5 = t3
        if record:
            stage_s["pop"] += t1 - t0
            stage_s["convert"] += t2 - t1
            stage_s["submit"] += t3 - t2
            stage_s["fetch"] += t4 - t3
            stage_s["sink"] += t5 - t4
        return state, audio, planes

    # Warm-up chunk: compiles the bank program, fills the pipe.
    state, pending, planes = one_chunk(state, None, record=False)
    jax.block_until_ready(pending)
    pending = None

    start = time.perf_counter()
    for _ in range(CHUNKS):
        state, pending, planes = one_chunk(state, pending)
    a_host = np.asarray(pending)            # drain the pipeline
    ring_out.push(f32_to_i16(a_host.ravel(), scale=8192.0).view(np.uint8))
    wall = time.perf_counter() - start

    src.stop()
    written = sink.stop()
    ring_in.close()
    ring_out.close()
    for p in (in_path, out_path):
        os.unlink(p)
    os.rmdir(tmp)

    n_samples = B * T * CHUNKS
    msps = n_samples / wall / 1e6
    # Device-only reference at this chunk shape: resident input, chained
    # state, one wait at the end.
    dev_dt = time_streaming(bank, planes, bank.init_state(B), iters=CHUNKS)
    dev_msps = B * T / dev_dt / 1e6

    # CHUNKS pushes total: the warm-up chunk's audio is dropped, the
    # steady loop pushes CHUNKS - 1 predecessors, the drain pushes the
    # last.  Per-chunk audio = B * T / decim samples.
    audio_expect = (B * T // bank.decim) * CHUNKS
    # Host-CPU-only rate (pop + convert + sink — the work a production
    # host does per chunk) and the host<->device transfer rate implied by
    # the "fetch" stage, the sync point where each chunk's upload (2 f32
    # planes) and audio download complete.
    host_cpu_s = stage_s["pop"] + stage_s["convert"] + stage_s["sink"]
    xfer_bytes = CHUNKS * (2 * B * T * 4 + B * T // bank.decim * 4)
    result = {
        "metric": "stream_e2e_fm_bank",
        "value": msps,
        "unit": "Msamples/s",
        "vs_baseline": None,
        "detail": {
            "streams": B, "samples_per_chunk": T, "chunks": CHUNKS,
            "wall_s": wall,
            "stage_seconds": stage_s,
            "device_only_Msps": dev_msps,
            "host_cpu_only_Msps": (n_samples / host_cpu_s / 1e6
                                   if host_cpu_s > 0 else None),
            "transfer_MBps": xfer_bytes / 1e6 / max(stage_s["fetch"], 1e-9),
            "bottleneck": ("transfers" if stage_s["fetch"] > 0.5 * wall
                           else "host_cpu" if host_cpu_s > 0.5 * wall
                           else "device"),
            "audio_bytes_written": written,
            "audio_samples_expected": audio_expect,
            "device": device_detail(),
        },
    }
    if written != audio_expect * 2:
        raise SystemExit(f"sink wrote {written} bytes, expected "
                         f"{audio_expect * 2}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
