"""Throughput of the extended transform layer on one GPU: DCT,
Hilbert/analytic, arbitrary-N (Bluestein) FFT, STFT/ISTFT, mel/MFCC,
Fourier resample, FFT convolve, rfft2 and 2-D convolution.

Run from the repo root:  python -m tools.bench_transforms

Prints one JSON line per op (Msamples/s of INPUT samples), each the median
of five ``block_until_ready``-timed windows.  Anything but a GPU is
refused.
"""

import functools
import json

import numpy as np

import jax
import jax.numpy as jnp

from simpledsp_jax.models.audio import MelSpectrogram, mfcc
from simpledsp_jax.ops.conv import convolve
from simpledsp_jax.ops.fft import fft_ri
from simpledsp_jax.ops.fir import resample
from simpledsp_jax.ops.spectral import istft_ri, stft_ri
from simpledsp_jax.ops.transforms import analytic_ri, dct
from simpledsp_jax.utils.benchmark import (device_detail, require_gpu,
                                           time_blocked)
from simpledsp_jax.utils.compile_cache import enable_compile_cache


def row(device, name, fn, args, n_samples, iters=8):
    f = jax.jit(fn)
    sec = float(np.median([time_blocked(f, *args, iters=iters, warmup=2)
                           for _ in range(5)]))
    print(json.dumps({
        "metric": f"{name}_throughput",
        "value": n_samples / sec / 1e6,
        "unit": "Msamples/s",
        "detail": {"seconds_per_call": sec, "device": device},
    }), flush=True)


def main():
    require_gpu()
    enable_compile_cache()
    emit = functools.partial(row, device_detail())
    rng = np.random.default_rng(0)

    x1 = jnp.asarray(rng.standard_normal((1024, 4096)), dtype=jnp.float32)
    emit("dct2_4096", lambda a: dct(a, type=2), (x1,), x1.size)
    emit("hilbert_4096", analytic_ri, (x1,), x1.size)

    xp = jnp.asarray(rng.standard_normal((512, 4099)), dtype=jnp.float32)
    emit("fft_bluestein_4099", lambda a: fft_ri(a, jnp.zeros_like(a)),
         (xp,), xp.size)

    xs = jnp.asarray(rng.standard_normal((64, 262144)), dtype=jnp.float32)
    emit("stft_1024", lambda a: stft_ri(a, 1024, hop=512), (xs,), xs.size)
    sr, si = jax.jit(lambda a: stft_ri(a, 1024, hop=512))(xs)
    emit("istft_1024", lambda a, b: istft_ri(a, b, 1024, hop=512),
         (sr, si), xs.size)

    melspec = MelSpectrogram(512, 256, 64, 16000.0)
    emit("mel_spectrogram_512x64", melspec, (xs,), xs.size)
    emit("mfcc13", lambda a: mfcc(a, 13, nfft=512, hop=256, n_mels=64,
                                  fs=16000.0), (xs,), xs.size)

    emit("resample_4096_to_3000", lambda a: resample(a, 3000), (x1,),
         x1.size)

    xc = jnp.asarray(rng.standard_normal((256, 65536)), dtype=jnp.float32)
    taps = np.asarray(rng.standard_normal(301), dtype=np.float32)
    emit("fftconvolve_301", lambda a: convolve(a, taps, "same"),
         (xc,), xc.size)

    from simpledsp_jax.ops.conv2d import convolve2d
    from simpledsp_jax.ops.fft import rfft2_ri

    xi = jnp.asarray(rng.standard_normal((32, 512, 512)), dtype=jnp.float32)
    emit("rfft2_512", rfft2_ri, (xi,), xi.size)
    k9 = np.asarray(rng.standard_normal((9, 9)), dtype=np.float32)
    emit("convolve2d_9x9", lambda a: convolve2d(a, k9, mode="same"),
         (xi,), xi.size)
    k64 = np.asarray(rng.standard_normal((64, 64)), dtype=np.float32)
    emit("convolve2d_64x64_fft",
         lambda a: convolve2d(a, k64, mode="same", method="fft"),
         (xi,), xi.size)


if __name__ == "__main__":
    main()
