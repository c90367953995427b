"""SDR receiver chain: DDC -> PFB channelizer -> FM demod -> audio decimate.

The full software-radio pipeline the north star requires (BASELINE.json:
"full SDR chain: channelize + resample + FM demod"; SURVEY.md §2b).  Every
stage is one of the framework's streaming ops composed functionally with an
explicit state pytree — serializable, resumable, and splittable at block
boundaries (the reference's streaming contract, test/testIIR.cpp:61-75,
extended to a whole receiver).

Complex baseband is carried as (re, im) float32 planes end-to-end, so every
stage is real arithmetic that XLA fuses.  The public call accepts either a
complex array or an (xr, xi) pair; outputs (audio) are real.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from simpledsp_jax.design.fir import lowpass_taps
from simpledsp_jax.ops.channelizer import ChanStateRI, PFBChannelizer
from simpledsp_jax.ops.demod import DemodStateRI, am_demod_ri, fm_demod_ri
from simpledsp_jax.ops.fir import FIRState, PolyphaseDecimator, fir_init

__all__ = ["SDRState", "FMReceiverBank", "AMReceiverBank",
           "audio_decimator_taps"]


def audio_decimator_taps(num_taps: int, decim: int,
                         design: str = "kaiser") -> np.ndarray:
    """Anti-alias low-pass of the banks' audio decimator (float64, unity DC
    gain): windowed sinc at 0.4/decim, or equiripple with the stopband
    from 0.5/decim for ``design="remez"``."""
    if design == "remez":
        from simpledsp_jax.design.optimal_fir import remez
        taps = remez(num_taps, [0.0, 0.35 / decim, 0.5 / decim, 0.5],
                     [1.0, 0.0], weight=[1.0, 10.0])
        return taps / taps.sum()
    return lowpass_taps(num_taps, 0.4 / decim, fs=1.0)


class SDRState(NamedTuple):
    """Carried state of the whole receiver (a serializable pytree)."""

    chan: ChanStateRI    # channelizer input history (RI planes)
    demod: DemodStateRI  # per-channel last IQ sample (RI planes)
    audio: FIRState      # per-channel decimator history (real)


class FMReceiverBank:
    """Channelize a wideband stream into M carriers and FM-demodulate all of
    them at once — the "many radios in one XLA program" model.

    Args:
      num_channels: M channels, spacing fs/M.
      decim: audio decimation after demod (output rate fs / M / decim).
      deviation_hz / fs: sets the FM discriminator gain.

    Call with x: (B, T) complex baseband — or a pair (xr, xi) of float
    planes — with T % (M * decim) == 0; returns
    (audio (B, M, T // M // decim), state).
    """

    def __init__(self, num_channels: int, fs: float, decim: int = 4,
                 deviation_hz: float = 75e3, taps_per_channel: int = 16,
                 audio_taps: int = 64, dtype=jnp.float32,
                 design: str = "kaiser"):
        self.m = int(num_channels)
        self.fs = float(fs)
        self.decim = int(decim)
        self.dtype = dtype
        chan_rate = fs / num_channels
        self.fm_gain = float(chan_rate / (2.0 * np.pi * deviation_hz))
        # design="remez": equiripple prototypes for both the channelizer
        # and the audio decimator — 16-34 dB better adjacent-channel /
        # alias rejection at equal taps (design/optimal_fir.py).
        self.design = design
        self.chan = PFBChannelizer(num_channels,
                                   taps_per_channel=taps_per_channel,
                                   dtype=dtype, design=design)
        self.audio = PolyphaseDecimator(
            audio_decimator_taps(audio_taps, decim, design), decim,
            dtype=dtype)
        self._jit = jax.jit(self._forward)

    def init_state(self, batch: int) -> SDRState:
        z = jnp.zeros((batch, self.chan.hist_len), dtype=self.dtype)
        return SDRState(
            chan=ChanStateRI(z, z),
            demod=DemodStateRI(jnp.ones((batch, self.m), dtype=self.dtype),
                               jnp.zeros((batch, self.m), dtype=self.dtype)),
            audio=fir_init(self.audio.hist_len, (batch, self.m),
                           dtype=self.dtype),
        )

    def _demod(self, ir, ii, state: DemodStateRI):
        """Per-channel detector on the channel-major planes (FM version)."""
        return fm_demod_ri(ir, ii, state, gain=self.fm_gain)

    def _forward(self, xr: jnp.ndarray, xi: jnp.ndarray, state: SDRState):
        """Jittable RI pipeline body (channel-major channelizer path: the
        minor axis stays the long time axis end to end)."""
        (ir, ii), chan_state = self.chan.process_ri_cm(xr, xi, state.chan)
        det, demod_state = self._demod(ir, ii, state.demod)
        audio, audio_state = self.audio(det, state.audio)
        return audio, SDRState(chan_state, demod_state, audio_state)

    def __call__(self, x: Union[jnp.ndarray, Tuple[jnp.ndarray, jnp.ndarray]],
                 state: Optional[SDRState] = None
                 ) -> Tuple[jnp.ndarray, SDRState]:
        if isinstance(x, (tuple, list)):
            xr, xi = x
        elif jnp.iscomplexobj(x):
            # A host array is split on the host: two real uploads and no
            # device-side split.
            if isinstance(x, np.ndarray):
                xr = jnp.asarray(x.real, dtype=self.dtype)
                xi = jnp.asarray(x.imag, dtype=self.dtype)
            else:
                xr = jnp.real(x).astype(self.dtype)
                xi = jnp.imag(x).astype(self.dtype)
        else:
            xr = jnp.asarray(x, dtype=self.dtype)
            xi = jnp.zeros_like(xr)
        b, t = xr.shape
        if t % (self.m * self.decim) != 0:
            raise ValueError(
                f"T={t} must be a multiple of M*decim={self.m * self.decim}")
        if state is None:
            state = self.init_state(b)
        return self._jit(xr, xi, state)


class AMReceiverBank(FMReceiverBank):
    """Channelize and AM-envelope-detect all M carriers at once.

    Same pipeline as :class:`FMReceiverBank` with the discriminator swapped
    for an envelope detector; per-channel DC (the carrier level) is removed
    by subtracting each call's block mean only if ``remove_dc``.
    """

    def __init__(self, num_channels: int, fs: float, decim: int = 4,
                 remove_dc: bool = True, taps_per_channel: int = 16,
                 audio_taps: int = 64, dtype=jnp.float32,
                 design: str = "kaiser"):
        super().__init__(num_channels, fs, decim=decim,
                         taps_per_channel=taps_per_channel,
                         audio_taps=audio_taps, dtype=dtype, design=design)
        self.remove_dc = remove_dc

    def _demod(self, ir, ii, state: DemodStateRI):
        """Envelope detector; the demod state passes through unused."""
        return am_demod_ri(ir, ii, remove_dc=self.remove_dc), state
