"""Wideband channelize -> per-channel rational resample -> long-FIR clean-up.

Demonstrates the breadth ops working together on the default JAX device:
PFBChannelizer (RI path), PolyphaseResampler (3/2 rational rate change),
and OverlapSaveFIR (FFT-domain long filter), all streaming with carried
state.  Run from the repo root: python examples/channelize_resample.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from simpledsp_jax import (
    OverlapSaveFIR,
    PFBChannelizer,
    PolyphaseResampler,
    lowpass_taps,
    resampler_taps,
)

t0 = time.time()


def lap(msg):
    print(f"[{time.time() - t0:6.1f}s] {msg}", flush=True)


fs = 512e3
M = 8
T = 1 << 15
n = np.arange(T)

# Wideband: one tone inside channel 3 (offset +5 kHz from its center).
tone_off = 5e3
x = np.exp(2j * np.pi * (3 * fs / M + tone_off) * n / fs)

chan = PFBChannelizer(M, taps_per_channel=8)
(iqr, iqi), chan_state = chan.process_ri(
    jnp.asarray(x.real, jnp.float32), jnp.asarray(x.imag, jnp.float32))
lap(f"channelized: {iqr.shape} (frames, channels), rate {fs/M/1e3:.0f} kHz")

# Channel 3 baseband at 64 kHz -> resample 3/2 -> 96 kHz.
up, down = 3, 2
taps = resampler_taps(up, down, taps_per_phase=16)
rs_r = PolyphaseResampler(taps, up=up, down=down)
rs_i = PolyphaseResampler(taps, up=up, down=down)
ch3_r, ch3_i = iqr[..., 3], iqi[..., 3]
yr, _ = rs_r(ch3_r)
yi, _ = rs_i(ch3_i)
new_rate = fs / M * up / down
lap(f"resampled ch3: {ch3_r.shape[-1]} -> {yr.shape[-1]} samples "
    f"({new_rate/1e3:.0f} kHz)")

# Long clean-up FIR (255 taps) via overlap-save on the real plane.
os_taps = lowpass_taps(255, 0.2, fs=1.0)
osf = OverlapSaveFIR(os_taps, block_size=1024)
pad = (-yr.shape[-1]) % 1024
yr_p = jnp.pad(yr, (0, pad))
zf, _ = osf(yr_p)
lap(f"overlap-save filtered: {zf.shape[-1]} samples ({len(os_taps)} taps)")

# The tone should sit at +5 kHz at every stage.
def peak_hz(re, im, rate):
    z = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    z = z[256:]
    spec = np.abs(np.fft.fft(z * np.hanning(z.size)))
    freqs = np.fft.fftfreq(z.size, 1 / rate)
    return freqs[np.argmax(spec)]

p1 = peak_hz(ch3_r, ch3_i, fs / M)
p2 = peak_hz(yr, yi, new_rate)
lap(f"tone at channel rate: {p1/1e3:+.2f} kHz; after resample: {p2/1e3:+.2f} kHz "
    f"(expect {tone_off/1e3:+.2f})")
assert abs(p1 - tone_off) < 300 and abs(p2 - tone_off) < 300
print("channelize/resample/overlap-save chain OK")
