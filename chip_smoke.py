"""Smoke check of the main path on the GPU, in one process.

    python chip_smoke.py           # phases A-D on one card
    python chip_smoke.py --four    # only the sharded paths, on four cards

Phases, each printing its result on its own line:

  A  the device: ``jax.devices()`` and the card's name and power limit;
  B  the north-star chain at ``bench.py``'s width (64 x 2^20 f32, 4096-pt
     FFT, HIGHEST) over 4 chained calls: compile time, memory, steady rate,
     SNR against the float64 scipy oracle, and streaming continuity;
  C  the FM receiver bank (16 x 2^19 complex per call, 3 chained calls)
     against the float64 reference of the same chain;
  D  ``python -m simpledsp_jax fm-rx`` run in-process on an iq16 capture
     with two FM stations, through the native ring buffer and converter.

``--four`` runs the sequence-sharded chain on a (dp=1, sp=4) mesh and the
stream-sharded bank on a (dp=4, sp=1) mesh, each against the serial model
on one card.  Any failed check raises, so the process exits non-zero and
never prints the last line, which is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Anything but a GPU is refused.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from simpledsp_jax import cli
from simpledsp_jax.models.northstar import NorthStarChain, \
    ShardedNorthStarChain
from simpledsp_jax.models.reference import bank_audio, chain_spectra, snr_db
from simpledsp_jax.models.sdr import FMReceiverBank
from simpledsp_jax.parallel import ShardedReceiverBank, make_mesh
from simpledsp_jax.parallel.mesh import DATA_AXIS, SEQ_AXIS
from simpledsp_jax.utils.benchmark import card_label, require_gpu, \
    time_streaming
from simpledsp_jax.utils.compile_cache import enable_compile_cache

HIGHEST = jax.lax.Precision.HIGHEST
CHAIN_MIN_SNR_DB = 130.0     # f32 HIGHEST chain vs the f64 oracle
SPLIT_MIN_SNR_DB = 120.0     # two half-length calls vs one call, f32
BANK_MIN_SNR_DB = 100.0      # f32 bank audio vs the f64 reference
SHARDED_MIN_SNR_DB = 120.0   # sharded chain vs the serial chain, f32
SHARDED_BANK_MAX_REL = 1e-5  # sharded bank vs serial bank, max |diff| / max


def _fetch_complex(sr, si, rows) -> np.ndarray:
    return (np.asarray(sr[:rows], np.float64)
            + 1j * np.asarray(si[:rows], np.float64))


def _peak_bytes(device) -> int | None:
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def phase_chain(channels: int = 64, samples: int = 1 << 20, calls: int = 4,
                fft_size: int = 4096, block_size: int = 256,
                parity_channels: int = 2, iters: int = 16,
                seed: int = 0) -> dict:
    """North-star chain over ``calls`` chained calls of (channels, samples)
    f32: compile, memory, steady rate, SNR and split-call continuity."""
    chain = NorthStarChain(fft_size=fft_size, block_size=block_size,
                           dtype=jnp.float32, precision=HIGHEST)
    key = jax.random.key(seed)
    xs = [jax.random.normal(jax.random.fold_in(key, i),
                            (channels, samples), jnp.float32)
          for i in range(calls)]
    s0 = jnp.zeros((channels, 2 * (chain.design.nsections + 1)),
                   jnp.float32)
    t0 = time.perf_counter()
    compiled = chain._jit.lower(xs[0], s0).compile()
    compile_s = time.perf_counter() - t0

    # The stream through the public entry point, state carried call to call.
    state = None
    got = []
    for x in xs:
        (sr, si), state = chain(x, state)
        got.append(_fetch_complex(sr, si, parity_channels))
    host = np.concatenate([np.asarray(x[:parity_channels]) for x in xs], -1)
    ref = chain_spectra(chain.design, host, fft_size)
    snr = snr_db(np.concatenate(got, axis=1), ref)
    if not snr >= CHAIN_MIN_SNR_DB:
        raise AssertionError(f"chain SNR {snr:.2f} dB < {CHAIN_MIN_SNR_DB}")

    # Continuity: two half-length calls == one call.
    half = samples // 2
    (wr, wi), _ = chain(xs[0])
    (ar, ai), s1 = chain(xs[0][:, :half])
    (br, bi), _ = chain(xs[0][:, half:], s1)
    split = np.concatenate([_fetch_complex(ar, ai, channels),
                            _fetch_complex(br, bi, channels)], axis=1)
    split_snr = snr_db(split, _fetch_complex(wr, wi, channels))
    if not split_snr >= SPLIT_MIN_SNR_DB:
        raise AssertionError(
            f"split-call SNR {split_snr:.2f} dB < {SPLIT_MIN_SNR_DB}")

    dt = time_streaming(chain, xs[0], None, iters=iters)
    return {"shape": [channels, samples], "calls": calls,
            "compile_s": compile_s,
            "memory_analysis": str(compiled.memory_analysis()),
            "peak_bytes_in_use": _peak_bytes(xs[0].devices().pop()),
            "snr_db": snr, "split_snr_db": split_snr,
            "seconds_per_call": dt,
            "Msamples_per_s": channels * samples / dt / 1e6}


def fm_stations(streams: int, samples: int, num_channels: int, *,
                offset: int = 0, deviation_hz: float = 5e3,
                fs: float = 1.6e6, seed: int = 0) -> jnp.ndarray:
    """(streams, samples) complex64 baseband with one FM station centred on
    every channel, made on the device.  Station c of stream b is a tone of
    (41 + 4c + b) * fs / 2^16 Hz with a random carrier phase; phases are
    reduced in exact integer arithmetic, so any sample offset is exact."""
    n = jnp.arange(samples, dtype=jnp.int32) + offset
    c = jnp.arange(num_channels, dtype=jnp.int32)[:, None]
    b = jnp.arange(streams, dtype=jnp.int32)[:, None, None]
    k = 41 + 4 * c + b
    tone = 2 * jnp.pi * ((k * (n & 0xFFFF)) & 0xFFFF) / 65536.0
    carrier = 2 * jnp.pi * ((c * n) % num_channels) / num_channels
    beta = deviation_hz / (k * fs / 65536.0)
    phase0 = jax.random.uniform(jax.random.key(seed),
                                (streams, num_channels, 1), maxval=6.283)
    x = jnp.exp(1j * (carrier + beta * jnp.sin(tone) + phase0)).sum(axis=1)
    return (x / num_channels).astype(jnp.complex64)


def phase_bank(streams: int = 16, samples: int = 1 << 19, calls: int = 3,
               num_channels: int = 16, decim: int = 4,
               parity_streams: int = 2, iters: int = 8) -> dict:
    """FM receiver bank over ``calls`` chained calls against the float64
    reference on ``parity_streams`` streams; f32, every matmul and conv at
    HIGHEST."""
    bank = FMReceiverBank(num_channels, fs=1.6e6, decim=decim)
    xs = [fm_stations(streams, samples, num_channels, offset=i * samples)
          for i in range(calls)]
    state = None
    got = []
    for x in xs:
        audio, state = bank(x, state)
        got.append(np.asarray(audio[:parity_streams], np.float64))
    host = np.concatenate([np.asarray(x[:parity_streams]) for x in xs], -1)
    ref = bank_audio(host, num_channels, decim, fm_gain=bank.fm_gain)
    got = np.concatenate(got, axis=-1)
    snr = min(snr_db(got[i, c], ref[i, c]) for i in range(parity_streams)
              for c in range(num_channels))
    if not snr >= BANK_MIN_SNR_DB:
        raise AssertionError(f"bank SNR {snr:.2f} dB < {BANK_MIN_SNR_DB}")
    dt = time_streaming(bank, xs[0], None, iters=iters)
    return {"shape": [streams, samples], "calls": calls,
            "precision": "float32, HIGHEST", "min_channel_snr_db": snr,
            "audio_shape": list(got.shape), "seconds_per_call": dt,
            "Msamples_per_s": streams * samples / dt / 1e6}


def write_fm_capture(path: str, samples: int, fs: float, num_channels: int,
                     stations=((3, 1000.0), (9, 2500.0)),
                     deviation_hz: float = 5e3, seed: int = 0) -> None:
    """Interleaved int16 IQ file holding one FM station per (channel, tone
    Hz) pair plus a little noise, made from ``seed``."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / fs
    x = sum(np.exp(1j * (2 * np.pi * ch * fs / num_channels * t
                         + deviation_hz / tone
                         * np.sin(2 * np.pi * tone * t)))
            for ch, tone in stations)
    x = 0.4 * x + 1e-3 * (rng.standard_normal(samples)
                          + 1j * rng.standard_normal(samples))
    iq = np.empty(2 * samples, np.int16)
    iq[0::2] = np.round(x.real * 32767)
    iq[1::2] = np.round(x.imag * 32767)
    iq.tofile(path)


def phase_fm_rx(samples: int = 1 << 20, fs: float = 1.024e6,
                num_channels: int = 16, decim: int = 4,
                block_frames: int = 1024,
                stations=((3, 1000.0), (9, 2500.0))) -> dict:
    """The fm-rx command end to end: both stations' tones recovered."""
    with tempfile.TemporaryDirectory() as tmp:
        cap = os.path.join(tmp, "capture.iq16")
        out = os.path.join(tmp, "audio.npz")
        write_fm_capture(cap, samples, fs, num_channels, stations)
        rc = cli.main(["fm-rx", "--input", cap, "--output", out,
                       "--rate", str(fs), "--format", "iq16",
                       "--channels", str(num_channels), "--decim",
                       str(decim), "--deviation", "5000",
                       "--block-frames", str(block_frames)])
        if rc != 0:
            raise AssertionError(f"fm-rx exited {rc}")
        with np.load(out) as data:
            audio, rate = data["audio"], float(data["rate"])
    peaks = {}
    for ch, tone in stations:
        a = audio[ch, 64:]
        spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
        peak = float(np.fft.rfftfreq(a.size, 1.0 / rate)[np.argmax(spec)])
        if not abs(peak - tone) <= 2 * rate / a.size:
            raise AssertionError(f"channel {ch}: peak {peak} Hz, "
                                 f"expected {tone} Hz")
        peaks[ch] = peak
    return {"audio_shape": list(audio.shape), "audio_rate": rate,
            "peaks_hz": peaks}


def phase_four_chain(mesh, channels: int = 64, samples: int = 1 << 22,
                     fft_size: int = 4096, block_size: int = 256,
                     parity_channels: int = 2, seed: int = 1) -> dict:
    """Sequence-sharded chain vs the serial chain on the mesh's first
    device and vs the float64 oracle."""
    kw = dict(fft_size=fft_size, block_size=block_size, dtype=jnp.float32,
              precision=HIGHEST)
    sharded = ShardedNorthStarChain(mesh, **kw)
    serial = NorthStarChain(**kw)
    dev0 = mesh.devices.flat[0]
    x = jax.device_put(jax.random.normal(jax.random.key(seed),
                                         (channels, samples), jnp.float32),
                       dev0)
    (sr, si), s_sh = sharded(jax.device_put(
        x, NamedSharding(mesh, P(DATA_AXIS, SEQ_AXIS))))
    (pr, pi), s_se = serial(x)
    got = _fetch_complex(sr, si, channels)
    vs_serial = snr_db(got, _fetch_complex(pr, pi, channels))
    vs_oracle = snr_db(got[:parity_channels], chain_spectra(
        sharded.design, np.asarray(x[:parity_channels]), fft_size))
    if not vs_serial >= SHARDED_MIN_SNR_DB:
        raise AssertionError(f"sharded vs serial chain {vs_serial:.2f} dB")
    if not vs_oracle >= CHAIN_MIN_SNR_DB:
        raise AssertionError(f"sharded chain vs oracle {vs_oracle:.2f} dB")
    state_dev = float(np.max(np.abs(np.asarray(s_sh.y_hist)
                                    - np.asarray(s_se.y_hist))))
    return {"shape": [channels, samples], "mesh": dict(mesh.shape),
            "snr_vs_serial_db": vs_serial, "snr_vs_oracle_db": vs_oracle,
            "state_max_abs_dev": state_dev,
            "spectra_devices": sorted(d.id for d in sr.sharding.device_set),
            "state_devices": sorted(
                d.id for d in s_sh.y_hist.sharding.device_set)}


def phase_four_bank(mesh, streams: int = 64, samples: int = 1 << 19,
                    calls: int = 2, num_channels: int = 16,
                    decim: int = 4) -> dict:
    """Stream-sharded FM bank vs the serial bank on one device, over
    ``calls`` chained calls."""
    bank = FMReceiverBank(num_channels, fs=1.6e6, decim=decim)
    sharded = ShardedReceiverBank(bank, mesh)
    dev0 = mesh.devices.flat[0]
    s_sh = s_se = None
    worst = 0.0
    for i in range(calls):
        x = jax.device_put(fm_stations(streams, samples, num_channels,
                                       offset=i * samples, seed=2), dev0)
        xr = jax.device_put(jnp.real(x), NamedSharding(mesh, P(DATA_AXIS)))
        xi = jax.device_put(jnp.imag(x), NamedSharding(mesh, P(DATA_AXIS)))
        a_sh, s_sh = sharded((xr, xi), s_sh)
        a_se, s_se = bank(x, s_se)
        ref = np.asarray(a_se)
        rel = float(np.max(np.abs(np.asarray(a_sh) - ref))
                    / np.max(np.abs(ref)))
        worst = max(worst, rel)
    if not worst <= SHARDED_BANK_MAX_REL:
        raise AssertionError(f"sharded bank vs serial: rel dev {worst:.3e}")
    return {"shape": [streams, samples], "mesh": dict(mesh.shape),
            "calls": calls, "max_rel_dev": worst,
            "audio_devices": sorted(d.id for d in a_sh.sharding.device_set),
            "state_devices": sorted(
                d.id for d in s_sh.chan.hist_r.sharding.device_set)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)
    devices = require_gpu(4 if args.four else 1)
    enable_compile_cache()
    label = card_label()
    print(f"A device: {devices} | {label}", flush=True)

    def report(name, result):
        print(f"{name} [{label}]: {json.dumps(result, default=str)}",
              flush=True)

    if args.four:
        report("four.chain", phase_four_chain(
            make_mesh(dp=1, sp=4, devices=devices[:4])))
        report("four.bank", phase_four_bank(
            make_mesh(dp=4, sp=1, devices=devices[:4])))
    else:
        report("B chain", phase_chain())
        report("C bank", phase_bank())
        report("D fm-rx", phase_fm_rx())
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
