"""Command-line SDR front end: file-based receive chains on the accelerator.

    python -m simpledsp_jax fm-rx  --input capture.iq --format iq16 \
        --rate 1.024e6 --channels 16 --decim 4 --output audio.npz
    python -m simpledsp_jax am-rx  --input capture.iq ... --output audio.npz
    python -m simpledsp_jax spectra --input capture.f32 --fft 4096 \
        --design lp:2000 --rate 39000 --output spectra.npz
    python -m simpledsp_jax bench

Ingest runs through the native streaming runtime (ring buffer + background
file reader + IQ converters, simpledsp_jax/runtime); DSP runs on the
default JAX backend.  Outputs are .npz files with the
carried state included, so a follow-up run can resume the stream.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import deque

import numpy as np


def _ingest_blocks(path: str, fmt: str, block_pairs: int):
    """Yield (re, im) float32 plane blocks from an IQ capture file via the
    native ring-buffer runtime."""
    from simpledsp_jax.runtime import (
        FileSource, RingBuffer, iq16_to_planes, iqu8_to_planes)

    itemsize = {"iq16": 4, "iqu8": 2, "f32": 4}[fmt]
    ring = RingBuffer(1 << 22)
    with FileSource(path, ring, chunk=1 << 16) as src:
        while True:
            raw = ring.pop_exact(block_pairs * itemsize, timeout=5.0)
            if raw is None:
                if src.state != src.RUNNING and ring.readable < block_pairs * itemsize:
                    break
                continue
            if fmt == "iq16":
                yield iq16_to_planes(raw.view(np.int16))
            elif fmt == "iqu8":
                yield iqu8_to_planes(raw)
            else:  # real f32
                x = raw.view(np.float32)
                yield x, np.zeros_like(x)
    ring.close()


def _state_paths(args) -> str:
    return args.save_state or (args.output + ".state.npz")


def _resume_state(args, run_zero_block):
    """Resumed carried state, or None for a fresh stream.

    The checkpoint loader needs a structural prototype; processing one
    all-zeros block builds one (every leaf is then REPLACED by the saved
    values, so the prototype's contents never matter).
    """
    if not args.state:
        return None
    from simpledsp_jax.utils.checkpoint import load_state
    proto = run_zero_block()
    return load_state(args.state, proto)


def _cmd_rx(args, mode: str) -> int:
    import jax.numpy as jnp
    from simpledsp_jax.models.sdr import AMReceiverBank, FMReceiverBank
    from simpledsp_jax.utils.checkpoint import save_state

    if mode == "fm":
        rx = FMReceiverBank(args.channels, args.rate, decim=args.decim,
                            deviation_hz=args.deviation)
    else:
        rx = AMReceiverBank(args.channels, args.rate, decim=args.decim)
    block = args.channels * args.decim * args.block_frames

    def zero_block():
        z = jnp.zeros((1, block), dtype=jnp.float32)
        _, s = rx((z, z), None)
        return s

    state = _resume_state(args, zero_block)
    audio = []
    t0 = time.time()
    nsamp = 0
    # Keep a few device results in flight: jax dispatch is async, so
    # fetching block i-2 while the device chews block i overlaps ingest,
    # host conversion, upload, and download with compute (the same
    # chained-stream pattern bench.py measures).
    pending: "deque" = deque()
    for re, im in _ingest_blocks(args.input, args.format, block):
        a, state = rx((jnp.asarray(re[None, :]), jnp.asarray(im[None, :])),
                      state)
        pending.append(a)
        nsamp += re.size
        if len(pending) > 2:
            audio.append(np.asarray(pending.popleft()[0]))
    while pending:
        audio.append(np.asarray(pending.popleft()[0]))
    if not audio:
        print("no complete blocks read", file=sys.stderr)
        return 1
    out = np.concatenate(audio, axis=-1)  # (channels, T_audio)
    np.savez(args.output, audio=out,
             rate=args.rate / args.channels / args.decim,
             channels=args.channels)
    save_state(_state_paths(args), state)
    dt = time.time() - t0
    print(f"{mode.upper()} rx: {nsamp} samples -> {out.shape} audio "
          f"({nsamp/dt/1e6:.1f} Msamples/s wall)")
    return 0


def _cmd_spectra(args) -> int:
    import jax.numpy as jnp
    from simpledsp_jax.design.biquad import (
        design_bandpass, design_highpass, design_lowpass)
    from simpledsp_jax.models.northstar import NorthStarChain

    kind, _, param = args.design.partition(":")
    f0 = float(param)
    if kind == "lp":
        design = design_lowpass(args.order // 2, f0, args.rate)
    elif kind == "hp":
        design = design_highpass(args.order // 2, f0, args.rate)
    elif kind == "bp":
        design = design_bandpass(args.order // 2, f0, args.rate, args.q)
    else:
        print(f"unknown design {args.design!r} (use lp:F0|hp:F0|bp:F0)",
              file=sys.stderr)
        return 2
    chain = NorthStarChain(design=design, fft_size=args.fft)

    block = args.fft * args.block_frames

    def zero_block():
        _, s = chain(jnp.zeros((1, block), dtype=jnp.float32), None)
        return s

    state = _resume_state(args, zero_block)
    frames = 0
    sr_acc = []
    si_acc = []
    t0 = time.time()
    pending: "deque" = deque()
    for re, _ in _ingest_blocks(args.input, "f32", block):
        (sr, si), state = chain(jnp.asarray(re[None, :]), state)
        pending.append((sr, si))
        frames += sr.shape[1]
        if len(pending) > 2:
            pr, pi = pending.popleft()
            sr_acc.append(np.asarray(pr[0]))
            si_acc.append(np.asarray(pi[0]))
    while pending:
        pr, pi = pending.popleft()
        sr_acc.append(np.asarray(pr[0]))
        si_acc.append(np.asarray(pi[0]))
    if not sr_acc:
        print("no complete blocks read", file=sys.stderr)
        return 1
    np.savez(args.output, spec_re=np.concatenate(sr_acc, axis=0),
             spec_im=np.concatenate(si_acc, axis=0), fft=args.fft,
             rate=args.rate)
    from simpledsp_jax.utils.checkpoint import save_state
    save_state(_state_paths(args), state)
    dt = time.time() - t0
    print(f"spectra: {frames} frames of {args.fft} "
          f"({frames*args.fft/dt/1e6:.1f} Msamples/s wall)")
    return 0


def _cmd_mfcc(args) -> int:
    """Streaming MFCC features from a PCM file (int16 or float32 mono)."""
    import jax.numpy as jnp
    from simpledsp_jax.models.audio import mfcc
    from simpledsp_jax.runtime import FileSource, RingBuffer, i16_to_f32

    nfft, hop = args.fft, args.hop or args.fft // 2
    if nfft % hop:
        print(f"--hop must divide --fft (got {hop}, {nfft})",
              file=sys.stderr)
        return 2
    block = hop * args.block_frames
    overlap = nfft - hop
    itemsize = 2 if args.format == "i16" else 4
    hist = np.zeros(overlap, dtype=np.float32)

    import jax
    step = jax.jit(lambda a: mfcc(a, args.coeffs, nfft=nfft, hop=hop,
                                  n_mels=args.mels, fs=args.rate))
    feats = []
    t0 = time.time()
    nsamp = 0
    pending: "deque" = deque()
    ring = RingBuffer(1 << 22)
    with FileSource(args.input, ring, chunk=1 << 16) as src:
        while True:
            raw = ring.pop_exact(block * itemsize, timeout=5.0)
            if raw is None:
                if (src.state != src.RUNNING
                        and ring.readable < block * itemsize):
                    break
                continue
            x = (i16_to_f32(raw.view(np.int16)) if args.format == "i16"
                 else raw.view(np.float32))
            xb = np.concatenate([hist, x])
            hist = xb[-overlap:] if overlap else hist
            pending.append(step(jnp.asarray(xb[None, :])))
            nsamp += x.size
            if len(pending) > 2:
                feats.append(np.asarray(pending.popleft()[0]))
    ring.close()
    while pending:
        feats.append(np.asarray(pending.popleft()[0]))
    if not feats:
        print("no complete blocks read", file=sys.stderr)
        return 1
    out = np.concatenate(feats, axis=0)  # (nframes, n_mfcc)
    np.savez(args.output, mfcc=out, rate=args.rate, fft=nfft, hop=hop,
             mels=args.mels)
    dt = time.time() - t0
    print(f"mfcc: {nsamp} samples -> {out.shape} features "
          f"({nsamp/dt/1e6:.1f} Msamples/s wall)")
    return 0


def _cmd_modem_sim(args) -> int:
    """Self-contained BER simulation: bits -> RRC TX -> AWGN -> matched
    RX -> BER, one JSON line per Eb/N0 point (measured vs theory)."""
    import json

    import jax.numpy as jnp

    from simpledsp_jax.models.comms import (Constellation, LinearModem,
                                            awgn, ber)

    const = {"bpsk": Constellation.bpsk, "qpsk": Constellation.qpsk,
             "qam16": lambda: Constellation.qam(16),
             "qam64": lambda: Constellation.qam(64)}[args.constellation]()
    modem = LinearModem(const, sps=args.sps, span=args.span,
                        beta=args.beta)
    k = const.bits_per_symbol
    rng = np.random.default_rng(args.seed)
    bits = jnp.asarray(rng.integers(0, 2, (args.symbols * k,)))
    xr, xi = modem.modulate(bits)
    n_ok = (args.symbols - modem.delay_symbols) * k
    records = []
    lo, hi, step = (float(v) for v in args.ebn0.split(":"))
    for i, ebn0 in enumerate(np.arange(lo, hi + 1e-9, step)):
        snr_db = (ebn0 + 10.0 * np.log10(k)
                  - 10.0 * np.log10(modem.sps))
        yr, yi = awgn(args.seed + i + 1, (xr, xi), float(snr_db),
                      signal_power=1.0)
        rx, _ = modem.demodulate(yr, yi)
        measured = float(ber(bits[:n_ok], rx[:n_ok]))
        rec = {"constellation": const.name, "ebn0_db": round(float(ebn0), 3),
               "ber": measured, "bits": n_ok}
        records.append(rec)
        print(json.dumps(rec))
    if args.output:
        np.savez(args.output,
                 ebn0_db=np.asarray([r["ebn0_db"] for r in records]),
                 ber=np.asarray([r["ber"] for r in records]),
                 constellation=const.name, bits_per_point=n_ok)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="simpledsp_jax", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, iq=True):
        sp.add_argument("--input", required=True)
        sp.add_argument("--output", required=True)
        sp.add_argument("--rate", type=float, required=True)
        sp.add_argument("--format", choices=["iq16", "iqu8", "f32"],
                        default="iq16" if iq else "f32")
        sp.add_argument("--block-frames", type=int, default=1024)
        sp.add_argument("--state", default=None,
                        help="resume from a carried-state .npz saved by a "
                             "previous run")
        sp.add_argument("--save-state", default=None,
                        help="where to save the final carried state "
                             "(default: <output>.state.npz)")

    for mode in ("fm", "am"):
        sp = sub.add_parser(f"{mode}-rx", help=f"{mode.upper()} receiver bank")
        common(sp)
        sp.add_argument("--channels", type=int, default=16)
        sp.add_argument("--decim", type=int, default=4)
        if mode == "fm":
            sp.add_argument("--deviation", type=float, default=75e3)

    sp = sub.add_parser("spectra", help="IIR -> framed FFT chain")
    common(sp, iq=False)
    sp.add_argument("--fft", type=int, default=4096)
    sp.add_argument("--design", default="lp:2000")
    sp.add_argument("--order", type=int, default=8)
    sp.add_argument("--q", type=float, default=1.0)

    sp = sub.add_parser("mfcc", help="streaming MFCC audio features")
    sp.add_argument("--input", required=True)
    sp.add_argument("--output", required=True)
    sp.add_argument("--rate", type=float, required=True)
    sp.add_argument("--format", choices=["i16", "f32"], default="i16")
    sp.add_argument("--fft", type=int, default=512)
    sp.add_argument("--hop", type=int, default=None)
    sp.add_argument("--mels", type=int, default=64)
    sp.add_argument("--coeffs", type=int, default=13)
    sp.add_argument("--block-frames", type=int, default=256,
                    help="hop-frames per device call")

    sub.add_parser("bench", help="run the headline benchmark")

    sp = sub.add_parser("modem-sim", help="digital modem BER simulation "
                                          "(TX -> AWGN -> matched RX)")
    sp.add_argument("--constellation",
                    choices=["bpsk", "qpsk", "qam16", "qam64"],
                    default="qpsk")
    sp.add_argument("--ebn0", default="0:10:2",
                    help="Eb/N0 sweep lo:hi:step in dB")
    sp.add_argument("--symbols", type=int, default=20000)
    sp.add_argument("--sps", type=int, default=4)
    sp.add_argument("--span", type=int, default=12)
    sp.add_argument("--beta", type=float, default=0.3)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--output", default=None,
                    help="optional .npz with the sweep arrays")

    args = p.parse_args(argv)
    if args.cmd == "fm-rx":
        return _cmd_rx(args, "fm")
    if args.cmd == "am-rx":
        return _cmd_rx(args, "am")
    if args.cmd == "spectra":
        return _cmd_spectra(args)
    if args.cmd == "mfcc":
        return _cmd_mfcc(args)
    if args.cmd == "bench":
        import bench
        bench.main()
        return 0
    if args.cmd == "modem-sim":
        return _cmd_modem_sim(args)
    return 2


if __name__ == "__main__":
    from simpledsp_jax.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    raise SystemExit(main())
