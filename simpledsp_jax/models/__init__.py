"""Flagship signal-chain models composed from the framework's ops."""

from simpledsp_jax.models.northstar import (
    NorthStarChain,
    ShardedNorthStarChain,
    default_design,
)
from simpledsp_jax.models.sdr import FMReceiverBank, SDRState
from simpledsp_jax.models.sdr import AMReceiverBank
from simpledsp_jax.models.audio import (MelSpectrogram, griffin_lim,
                                        mel_filterbank, mfcc)
from simpledsp_jax.models.comms import (Constellation, LinearModem,
                                        OFDMModem, awgn, ber)
