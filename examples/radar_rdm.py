"""End-to-end radar scenario through the PUBLIC API on the default device:
LFM pulse train with two moving targets -> matched filter -> range-
Doppler map -> CA-CFAR detection, with ground-truth checks.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

t0 = time.time()


def lap(m):
    print(f"[{time.time()-t0:6.1f}s] {m}", flush=True)


from simpledsp_jax.models.radar import (cfar_ca, lfm_chirp,  # noqa: E402
                                        range_doppler_map)
from simpledsp_jax.utils.host import to_numpy  # noqa: E402

# ---- scene: 2 targets at (range bin, Doppler bin) with SNR ~ 15 dB ----
n_pulses, n_samp, n_chirp = 64, 512, 64
rng = np.random.default_rng(0)
tx_re, tx_im = lfm_chirp(n_chirp, 0.8)
tx = np.asarray(tx_re) + 1j * np.asarray(tx_im)

targets = [(140, 10, 1.0), (300, -18, 0.7)]   # (delay, doppler bin, amp)
z = (rng.standard_normal((n_pulses, n_samp))
     + 1j * rng.standard_normal((n_pulses, n_samp))) * 0.05
p = np.arange(n_pulses)
for delay, dop, amp in targets:
    phase = np.exp(2j * np.pi * dop * p / n_pulses)[:, None]
    z[:, delay: delay + n_chirp] += amp * phase * tx[None, :]

xr = jnp.asarray(z.real, jnp.float32)[None]
xi = jnp.asarray(z.imag, jnp.float32)[None]

# ---- pipeline: ONE jit program, batched over CPIs ----
@jax.jit
def pipeline(ar, ai):
    rdm = range_doppler_map(ar, ai, tx_re, tx_im)
    det, thr = cfar_ca(rdm, guard=2, train=12, pfa=1e-5)
    return rdm, det


rdm, det = pipeline(xr, xi)
rdm = to_numpy(rdm)[0]
det = to_numpy(det)[0]
lap(f"range-Doppler map {rdm.shape}, {int(det.sum())} CFAR detections")

# ---- ground truth: every target produces a detection cluster at its
# (doppler row, range bin); the matched filter is delay-aligned, so the
# compressed peak sits exactly at the target's delay bin ----
ok = True
for delay, dop, amp in targets:
    row = (dop + n_pulses // 2) % n_pulses
    col = delay
    patch = det[max(0, row - 1): row + 2, max(0, col - 2): col + 3]
    hit = bool(patch.any())
    peak_db = 10 * np.log10(rdm[row, col] / np.median(rdm))
    print(f"  target (delay={delay}, doppler={dop:+d}): detected={hit} "
          f"peak {peak_db:.1f} dB over median noise", flush=True)
    ok &= hit
assert ok, "missed target"

# false-alarm sanity: detections should be sparse (clustered on targets)
far = det.sum() / det.size
print(f"  detection-cell fraction {far:.2e} (pfa 1e-5 + target clusters)")
assert far < 5e-3, far

print("radar end-to-end OK")
