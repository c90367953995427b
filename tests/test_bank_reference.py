"""The XLA FM/AM receiver banks against the float64 reference of the same
chain (models/reference.py: one modulated prototype low-pass per channel
through scipy's upfirdn, discriminator or envelope, FIR decimator) across
channel counts, taps per channel, decimations, prototype designs and
streaming splits."""

import jax.numpy as jnp
import numpy as np
import pytest

from simpledsp_jax.models.reference import bank_audio, snr_db
from simpledsp_jax.models.sdr import AMReceiverBank, FMReceiverBank

CONFIGS = [  # (M, decim, design)
    (4, 2, "kaiser"), (8, 4, "kaiser"), (16, 4, "kaiser"), (16, 8, "kaiser"),
    (32, 4, "kaiser"), (8, 2, "remez"), (16, 4, "remez"), (32, 2, "remez"),
]


def _noise(rng, b, t):
    return rng.standard_normal((b, t)) + 1j * rng.standard_normal((b, t))


def _reference(bank, x, calls=1, **kw):
    if isinstance(bank, AMReceiverBank):
        return bank_audio(x, bank.m, bank.decim, remove_dc=bank.remove_dc,
                          calls=calls, design=bank.design, **kw)
    return bank_audio(x, bank.m, bank.decim, fm_gain=bank.fm_gain,
                      design=bank.design, **kw)


@pytest.mark.parametrize("cls", [FMReceiverBank, AMReceiverBank])
@pytest.mark.parametrize("m,decim,design", CONFIGS)
def test_f64_matches_reference(rng, cls, m, decim, design):
    bank = cls(m, fs=1.6e6, decim=decim, design=design, dtype=jnp.float64)
    x = _noise(rng, 2, m * decim * 64)
    audio, state = bank(x)
    ref = _reference(bank, x)
    assert audio.shape == ref.shape == (2, m, 64)
    assert snr_db(np.asarray(audio), ref) > 200.0
    assert state.chan.hist_r.shape == (2, bank.chan.hist_len)


@pytest.mark.parametrize("cls", [FMReceiverBank, AMReceiverBank])
@pytest.mark.parametrize("design", ["kaiser", "remez"])
def test_streaming_split_matches_reference(rng, cls, design):
    """Two chained calls == the reference over the whole stream (per-call
    DC removal for AM)."""
    bank = cls(16, fs=1.6e6, decim=4, design=design, dtype=jnp.float64)
    x = _noise(rng, 2, 2 * 16 * 4 * 64)
    half = x.shape[-1] // 2
    a1, st = bank(x[:, :half])
    a2, _ = bank(x[:, half:], st)
    got = np.concatenate([np.asarray(a1), np.asarray(a2)], axis=-1)
    assert snr_db(got, _reference(bank, x, calls=2)) > 200.0


@pytest.mark.parametrize("taps_per_channel", [8, 32])
def test_taps_per_channel(rng, taps_per_channel):
    bank = FMReceiverBank(16, fs=1.6e6, taps_per_channel=taps_per_channel,
                          dtype=jnp.float64)
    x = _noise(rng, 2, 16 * 4 * 64)
    audio, _ = bank(x)
    ref = bank_audio(x, 16, 4, fm_gain=bank.fm_gain,
                     taps_per_channel=taps_per_channel)
    assert snr_db(np.asarray(audio), ref) > 200.0


def test_am_without_dc_removal(rng):
    bank = AMReceiverBank(8, fs=1.6e6, remove_dc=False, dtype=jnp.float64)
    x = _noise(rng, 2, 8 * 4 * 64)
    audio, _ = bank(x)
    assert snr_db(np.asarray(audio), bank_audio(x, 8, 4)) > 200.0


def _stations(m, t, fs=1.6e6, dev=5e3):
    """One FM station per channel: a well-conditioned f32 input."""
    n = np.arange(t)
    tones = 1000.0 + 100.0 * np.arange(m)
    x = sum(np.exp(1j * (2 * np.pi * c * n / m
                         + dev / f * np.sin(2 * np.pi * f * n / fs)))
            for c, f in enumerate(tones))
    return (x / m)[None].astype(np.complex64)


@pytest.mark.parametrize("cls", [FMReceiverBank, AMReceiverBank])
def test_f32_within_bank_tolerance(cls):
    """float32 with HIGHEST convs and matmuls: every channel's audio
    within 100 dB of the float64 reference (the bank tolerance
    chip_smoke.py holds the GPU to)."""
    bank = cls(16, fs=1.6e6)
    x = _stations(16, 16 * 4 * 256)
    audio = np.asarray(bank(x)[0], np.float64)
    ref = _reference(bank, x)
    assert min(snr_db(audio[0, c], ref[0, c]) for c in range(16)) >= 100.0
