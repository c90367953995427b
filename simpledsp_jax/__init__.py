"""simpledsp_jax — a JAX DSP / software-radio framework.

A from-scratch JAX/XLA re-design of the capability set of
``mike919192/simpledsp`` (FFT + cascaded-biquad IIR) extended to the full
batched, sharded, multi-host signal chain: FIR/polyphase filtering, rational
resampling, channelization, and FM/AM demodulation.

Layering (bottom-up):
  design/    host-side float64 coefficient/table design (trace-time constants)
  ops/       functional JAX ops: fft, iir, fir, resample, channelizer, demod
  parallel/  mesh/sharding layer: shard_map pipelines, halo exchange
  utils/     precision helpers, benchmarking tools
"""

from simpledsp_jax.design.biquad import (
    BiquadCascadeDesign,
    FilterType,
    bp_cutoff_freqs,
    design_bandpass,
    design_bandstop,
    design_cheby1_lowpass,
    design_cheby2_lowpass,
    design_highpass,
    design_lowpass,
    ba_coefficients,
    freq_response,
    group_delay,
    sos_matrix,
)
from simpledsp_jax.design.fir import (
    bandpass_taps,
    bandstop_taps,
    firwin2,
    highpass_taps,
    lowpass_taps,
    pfb_prototype_taps,
    resampler_taps,
)
from simpledsp_jax.design.fir import (firwin, firwin_2d,
                                      kaiser_beta, rrc_taps)
from simpledsp_jax.design.iir import (
    band_stop_obj,
    bessel,
    besselap,
    bilinear_zpk,
    lp2bp_zpk,
    lp2bs_zpk,
    lp2hp_zpk,
    lp2lp_zpk,
    buttap,
    cheb1ap,
    cheb2ap,
    ellipap,
    butter,
    buttord,
    cheb1ord,
    cheb2ord,
    cheby1,
    cheby2,
    ellip,
    ellipord,
    gammatone,
    iircomb,
    iirdesign,
    iirfilter,
    iirnotch,
    iirpeak,
    zpk2sos,
)
from simpledsp_jax.design.ltisys import (
    BadCoefficients,
    abcd_normalize,
    bilinear,
    bode,
    cont2discrete,
    dbode,
    dfreqresp,
    dimpulse,
    dlsim,
    dstep,
    findfreqs,
    freqresp,
    freqz_sos,
    impulse,
    lp2bp,
    lp2bs,
    lp2hp,
    lp2lp,
    lsim,
    normalize,
    sos2tf,
    sos2zpk,
    sosfreqz,
    ss2tf,
    ss2zpk,
    step,
    tf2sos,
    tf2ss,
    tf2zpk,
    zpk2ss,
    zpk2tf,
)
from simpledsp_jax.design.optimal_fir import firls, minimum_phase, remez
from simpledsp_jax.design.residues import (
    invres,
    invresz,
    residue,
    residuez,
    unique_roots,
)
from simpledsp_jax.design.windows import (get_window, kaiser_atten,
                                           kaiserord)
from simpledsp_jax.ops.fft import (
    fft,
    fft_radix2,
    fft_radix4,
    fft_ri,
    fft2,
    fft2_ri,
    ifft,
    ifft_ri,
    ifft2,
    ifft2_ri,
    irfft2_ri,
    rfft2_ri,
)
from simpledsp_jax.ops.iir import (
    BlockIIR,
    CascadeCoeffs,
    IIRState,
    coeffs_from_design,
    iir_init,
    iir_preload,
    sosfilt,
    sosfilt_scan,
    sosfilt_zi,
    sosfiltfilt,
)
from simpledsp_jax.ops.fir import (
    FIRFilter,
    FIRState,
    OverlapSaveFIR,
    PolyphaseDecimator,
    PolyphaseInterpolator,
    PolyphaseResampler,
    decimate,
    fir_filter,
    resample,
    resample_poly,
    upfirdn,
)
from simpledsp_jax.ops.channelizer import PFBChannelizer
from simpledsp_jax.ops.conv import (
    choose_conv_method,
    convolve,
    correlate,
    correlation_lags,
    deconvolve,
    fftconvolve,
    oaconvolve,
)
from simpledsp_jax.ops.conv2d import convolve2d, correlate2d
from simpledsp_jax.ops.lfilter import (
    BlockLFilter,
    filtfilt,
    freqs,
    freqs_zpk,
    freqz,
    freqz_zpk,
    lfilter,
    lfilter_scan,
    lfilter_zi,
    lfiltic,
)
from simpledsp_jax.ops.spectral import (
    check_COLA,
    check_NOLA,
    closest_STFT_dual_window,
    coherence,
    envelope,
    envelope_ri,
    csd_ri,
    istft_ri,
    lombscargle,
    periodogram,
    spectrogram_ri,
    stft_dual_window,
    stft_ri,
    vectorstrength,
    welch_psd,
)
from simpledsp_jax.design.placement import place_poles
from simpledsp_jax.design.systems import (
    StateSpace,
    TransferFunction,
    ZerosPolesGain,
    dlti,
    lti,
)
from simpledsp_jax.ops.transforms import (
    CZT,
    ZoomFFT,
    analytic_ri,
    czt,
    czt_points,
    czt_ri,
    dct,
    goertzel,
    goertzel_ri,
    hilbert,
    hilbert2,
    hilbert2_ri,
    idct,
    zoom_fft,
    zoom_fft_ri,
)
from simpledsp_jax.ops.peaks import (
    argrelextrema,
    argrelmax,
    argrelmin,
    find_peaks,
    find_peaks_cwt,
    peak_prominences,
    peak_widths,
    ricker,
)
from simpledsp_jax.ops.splines import (
    cspline1d,
    cspline1d_eval,
    cspline2d,
    gauss_spline,
    qspline1d,
    qspline1d_eval,
    qspline2d,
    sepfir2d,
    spline_filter,
    symiirorder1,
    symiirorder2,
)
from simpledsp_jax.ops.smooth import (
    detrend,
    medfilt,
    medfilt2d,
    order_filter,
    savgol_coeffs,
    savgol_filter,
    wiener,
)
from simpledsp_jax.ops.waveforms import (
    chirp,
    gausspulse,
    max_len_seq,
    sawtooth,
    square,
    sweep_poly,
    unit_impulse,
)
from simpledsp_jax.ops.demod import (
    am_demod,
    am_demod_ri,
    fm_demod,
    fm_demod_ri,
    nco_mix,
    nco_mix_ri,
)

__version__ = "0.1.0"
