"""End-to-end user scenario through the PUBLIC API on the default JAX device."""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np, jax, jax.numpy as jnp
t0=time.time()
def lap(m): print(f"[{time.time()-t0:6.1f}s] {m}", flush=True)

from simpledsp_jax.models import FMReceiverBank, NorthStarChain
from simpledsp_jax.utils.host import to_numpy

fs = 1.024e6; M = 16; decim = 4; T = 1 << 16
rx = FMReceiverBank(M, fs, decim=decim, deviation_hz=5e3)
t = np.arange(T) / fs
def fm(fc, ftone, dev):
    return np.exp(1j*(2*np.pi*fc*t + dev/ftone*np.sin(2*np.pi*ftone*t)))
x = (fm(3*fs/M, 1000.0, 5e3) + fm(9*fs/M, 2500.0, 5e3))[None,:].astype(np.complex64)

audio, state = rx(x)
audio = to_numpy(audio); lap(f"audio {audio.shape} {audio.dtype}")

arate = fs / M / decim
for ch, expect in [(3, 1000.0), (9, 2500.0)]:
    a = audio[0, ch][200:]
    spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
    peak = np.fft.rfftfreq(a.size, 1/arate)[np.argmax(spec)]
    rms = float(np.sqrt(np.mean(a**2)))
    print(f"  ch {ch}: peak {peak:.1f} Hz rms {rms:.3f} (expect {expect} Hz)")
    assert abs(peak - expect) < 2*arate/a.size*10, (ch, peak)
    assert 0.5 < rms < 1.5, rms   # unit sine -> rms ~0.707

# channel isolation at the IQ surface (empty channel FM-demods to noise by
# design, so quietness is asserted pre-discriminator via the public RI API):
(iqr, iqi), _ = rx.chan.process_ri(jnp.asarray(x.real.astype(np.float32)),
                                   jnp.asarray(x.imag.astype(np.float32)))
pw = np.asarray((iqr**2 + iqi**2).mean(axis=1))[0]   # (M,) channel powers
print(f"  IQ powers: ch3={pw[3]:.3f} ch9={pw[9]:.3f} ch5={pw[5]:.2e}")
assert pw[5] < 1e-3 * pw[3], pw

audio2, _ = rx(x, state)
a2 = to_numpy(audio2)[0, 3]
spec2 = np.abs(np.fft.rfft(a2 * np.hanning(a2.size)))
peak2 = np.fft.rfftfreq(a2.size, 1/arate)[np.argmax(spec2)]
lap(f"streamed call ch3 peak {peak2:.1f} Hz")
assert abs(peak2 - 1000.0) < 20

chain = NorthStarChain()
xx = jnp.asarray(np.random.default_rng(0).standard_normal((2, 8192)), dtype=jnp.float32)
(sr, si), st = chain(xx)
jax.block_until_ready(sr)
assert sr.shape == si.shape == (2, 2, 2048)  # packed one-sided
lap(f"northstar spectra RI {sr.shape}")

# probes: wrong block length + odd section count must raise clean errors
try:
    rx(x[:, :100])
    print("PROBE FAIL: no error for bad length")
except ValueError as e:
    print("  probe bad-length ->", e)
from simpledsp_jax import design_bandpass, design_lowpass
design_lowpass(3, 200.0, 39000.0)   # odd M legal for LP/HP (order 6)
try:
    design_bandpass(3, 2000.0, 39000.0, 1.0)   # band filters need pole PAIRS
    print("PROBE FAIL: no error for odd-M band-pass")
except ValueError as e:
    print("  probe odd-M band-pass ->", e)
print("SDR end-to-end OK")
