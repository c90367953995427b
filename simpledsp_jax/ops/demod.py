"""FM / AM demodulation — net-new components required by the north star
(BASELINE.json: "full SDR chain: channelize + resample + FM demod";
SURVEY.md §2b).

Pure elementwise math, batched over channels, streaming with a one-sample
carried state (the same explicit-state contract as the IIR/FIR ops).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["DemodState", "DemodStateRI", "fm_demod", "fm_demod_ri",
           "am_demod", "am_demod_ri", "nco_mix", "nco_mix_ri"]


class DemodState(NamedTuple):
    """Last complex sample, carried across blocks for the phase difference."""

    prev: jnp.ndarray  # (...,) complex


def fm_demod(iq: jnp.ndarray, state: Optional[DemodState] = None, *,
             gain: float = 1.0) -> Tuple[jnp.ndarray, DemodState]:
    """Quadrature FM discriminator on complex baseband.

    y[n] = gain * angle(iq[n] * conj(iq[n-1]))  — the instantaneous frequency
    in radians/sample.  For audio, gain = fs / (2 pi f_dev) recovers the
    modulating signal at unit amplitude.  First output of a fresh stream uses
    a zero-phase predecessor (angle(iq[0] * conj(iq[0])) == 0 convention via
    prev = iq[0] is NOT used; prev defaults to 1+0j so y[0] = angle(iq[0])).
    """
    if state is None:
        prev = jnp.ones(iq.shape[:-1], dtype=iq.dtype)
    else:
        prev = state.prev
    shifted = jnp.concatenate([prev[..., None], iq[..., :-1]], axis=-1)
    d = iq * jnp.conj(shifted)
    y = jnp.arctan2(jnp.imag(d), jnp.real(d)) * gain
    return y, DemodState(iq[..., -1])


def am_demod(iq: jnp.ndarray, *, remove_dc: bool = False) -> jnp.ndarray:
    """Envelope detector on complex baseband: |iq|, optionally DC-removed
    (per-block mean subtraction; chain an IIR high-pass for true streaming
    DC removal)."""
    env = jnp.abs(iq)
    if remove_dc:
        env = env - jnp.mean(env, axis=-1, keepdims=True)
    return env


class DemodStateRI(NamedTuple):
    """Last IQ sample as (re, im) float planes — the RI carried state.

    Baseband is carried as two float planes end-to-end (the framework-wide
    RI convention), so the discriminator is real elementwise arithmetic
    that XLA fuses.
    """

    prev_r: jnp.ndarray  # (...,)
    prev_i: jnp.ndarray  # (...,)


def fm_demod_ri(ir: jnp.ndarray, ii: jnp.ndarray,
                state: Optional[DemodStateRI] = None, *,
                gain: float = 1.0) -> Tuple[jnp.ndarray, DemodStateRI]:
    """Quadrature FM discriminator on (re, im) float planes.

    Identical math to :func:`fm_demod` — y[n] = gain * arg(z[n] conj(z[n-1]))
    with the complex product expanded into real elementwise ops.
    """
    if state is None:
        pr = jnp.ones(ir.shape[:-1], dtype=ir.dtype)
        pi = jnp.zeros(ii.shape[:-1], dtype=ii.dtype)
    else:
        pr, pi = state.prev_r, state.prev_i
    sr = jnp.concatenate([pr[..., None], ir[..., :-1]], axis=-1)
    si = jnp.concatenate([pi[..., None], ii[..., :-1]], axis=-1)
    dr = ir * sr + ii * si
    di = ii * sr - ir * si
    y = jnp.arctan2(di, dr) * jnp.asarray(gain, dtype=ir.dtype)
    return y, DemodStateRI(ir[..., -1], ii[..., -1])


def am_demod_ri(ir: jnp.ndarray, ii: jnp.ndarray, *,
                remove_dc: bool = False) -> jnp.ndarray:
    """Envelope detector on (re, im) planes: sqrt(ir^2 + ii^2)."""
    env = jnp.sqrt(ir * ir + ii * ii)
    if remove_dc:
        env = env - jnp.mean(env, axis=-1, keepdims=True)
    return env


def _nco_angles(length: int, freq: float, phase: float,
                sample_offset: int) -> np.ndarray:
    """Oscillator angles with EXACT host-side phase reduction.

    The naive -2*pi*freq*(arange + offset) loses all phase precision in
    f32 once freq*offset reaches ~1e4 cycles (minutes of streaming), and
    the index itself overflows int32 past 2^31 samples.  length, freq,
    phase, and sample_offset are all static, so the cycle count is
    computed in float64 numpy, reduced mod 1 BEFORE the 2*pi scale, and
    folded into the jitted HLO as a trace-time constant.
    """
    n = np.arange(length, dtype=np.int64) + int(sample_offset)
    cycles = (-(float(freq) * n) - phase / (2.0 * np.pi)) % 1.0
    return 2.0 * np.pi * cycles


def nco_mix_ri(xr: jnp.ndarray, xi: jnp.ndarray, freq: float, *,
               phase: float = 0.0, sample_offset: int = 0
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """NCO digital downconversion on (re, im) planes:
    (xr + i xi) * e^{-2 pi i f n}.  Phase-exact for arbitrarily large
    ``sample_offset`` (streaming continuity; see _nco_angles)."""
    ang = jnp.asarray(_nco_angles(xr.shape[-1], freq, phase, sample_offset),
                      dtype=xr.dtype)
    c, s = jnp.cos(ang), jnp.sin(ang)
    return xr * c - xi * s, xr * s + xi * c


def nco_mix(x: jnp.ndarray, freq: float, *, phase: float = 0.0,
            sample_offset: int = 0) -> jnp.ndarray:
    """Numerically-controlled-oscillator mixer: x * e^{-2 pi i f n} for
    digital downconversion.  `freq` in cycles/sample; `sample_offset` lets a
    streaming caller keep phase continuity across blocks (phase-exact for
    arbitrarily large offsets; see _nco_angles)."""
    real_dtype = jnp.real(x).dtype if jnp.iscomplexobj(x) else x.dtype
    ang = jnp.asarray(_nco_angles(x.shape[-1], freq, phase, sample_offset),
                      dtype=real_dtype)
    osc = jax.lax.complex(jnp.cos(ang), jnp.sin(ang))
    return x * osc
