"""FIR filtering, polyphase resampling, and overlap-save block convolution.

Net-new components beyond the reference's FFT+IIR pair, required by the north
star (BASELINE.json: "polyphase FIR decimate/interpolate + overlap-save block
filtering, multi-channel"; SURVEY.md §2b).  They follow the reference's
streaming contract: explicit carried state, blockwise == whole-signal
(the reference proves this property for its IIR at test/testIIR.cpp:61-75).

Design
------
* Short/medium taps: **polyphase strided convolutions**.  Each of the `up`
  output phases is one `lax.conv_general_dilated` with window K and stride
  `down` and trace-time-constant taps, in place of strided-slice
  shift-adds.  One implementation (`PolyphaseResampler`) covers
  plain FIR (up=down=1), decimation (up=1), interpolation (down=1), and
  rational resampling, at work L*T/down.
* Long taps: **overlap-save FFT convolution** (`OverlapSaveFIR`) built on the
  four-step matmul FFT (ops/fft.py), so the heavy lifting is matmuls.

Semantics are validated against scipy.signal.lfilter / upfirdn in tests.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from simpledsp_jax.ops import fft as _fft

__all__ = [
    "FIRState",
    "fir_init",
    "PolyphaseResampler",
    "FIRFilter",
    "PolyphaseDecimator",
    "PolyphaseInterpolator",
    "OverlapSaveFIR",
    "fir_filter",
    "resample",
    "decimate",
    "upfirdn",
]


def upfirdn(h, x: jnp.ndarray, up: int = 1, down: int = 1) -> jnp.ndarray:
    """Upsample -> FIR -> downsample by the familiar name
    (scipy.signal.upfirdn semantics over the last axis, including the
    FULL tail-flushed output length ceil(((T-1) up + len(h)) / down)):
    the streaming :class:`PolyphaseResampler` engine fed a zero-extended
    input to flush the filter tail, then sliced to scipy's length."""
    h = np.asarray(h, dtype=np.float64)
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("up and down must be >= 1")
    t = x.shape[-1]
    out_len = -(-((t - 1) * up + h.size) // down)
    need_in = -(-out_len * down // up)
    pad = max(0, need_in - t)
    pad += (-(t + pad)) % down
    if pad:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    y, _ = PolyphaseResampler(h, up=up, down=down, dtype=x.dtype)(x)
    return y[..., :out_len]


def resample(x: jnp.ndarray, num: int) -> jnp.ndarray:
    """Fourier-method resampling of a REAL signal over the last axis to
    exactly ``num`` samples (scipy.signal.resample semantics, including
    the even-length Nyquist-bin fold/halve rules) — the whole-signal
    complement of the streaming :class:`PolyphaseResampler`.

    One rfft + bin copy + irfft; batched over leading axes.  Assumes the
    signal is periodic over the window (use the polyphase resampler for
    streaming / non-periodic data).
    """
    if jnp.iscomplexobj(x):
        raise ValueError("resample expects a real array (the streaming "
                         "PolyphaseResampler handles IQ via RI planes)")
    n = x.shape[-1]
    if num < 1:
        raise ValueError(f"num must be positive, got {num}")
    xr, xi = _fft.rfft_ri(x)
    nb_new = num // 2 + 1
    nb = min(xr.shape[-1], nb_new)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, nb_new - nb)]
    yr = jnp.pad(xr[..., :nb], pad)
    yi = jnp.pad(xi[..., :nb], pad)
    if num < n and num % 2 == 0:
        # Downsampling onto an even grid folds the +/- old bins at the new
        # Nyquist: Y[num/2] = 2 Re X[num/2] (scipy.signal.resample rule).
        yr = yr.at[..., num // 2].set(2.0 * xr[..., num // 2])
        yi = yi.at[..., num // 2].set(0.0)
    if num > n and n % 2 == 0:
        # Upsampling splits the old Nyquist bin symmetrically.
        yr = yr.at[..., n // 2].multiply(0.5)
        yi = yi.at[..., n // 2].multiply(0.5)
    y = _fft.irfft_ri(yr, yi, num)
    return y * (num / n)


class FIRState(NamedTuple):
    """Carried input history (the last `hist_len` input samples)."""

    hist: jnp.ndarray  # (..., hist_len)


def fir_init(hist_len: int, batch_shape: Tuple[int, ...] = (),
             dtype=jnp.float32) -> FIRState:
    return FIRState(jnp.zeros(batch_shape + (hist_len,), dtype=dtype))


class PolyphaseResampler:
    """Rational-rate FIR resampler y = upfirdn(h, x, up, down), streaming.

    Output m:  y[m] = sum_k h[k*up + r_m] * x[q_m - k],
    with q_m = floor(m*down/up), r_m = (m*down) mod up — the standard
    polyphase identity, laid out so each of the `up` output phases is a
    K-term weighted sum of stride-`down` slices (K = ceil(L/up) taps/phase).
    Tap weights are trace-time constants (the reference's compile-time-table
    economics, SURVEY.md §7 hard-part 5).

    Streaming: input block length must be a multiple of `down`; carried state
    is the last K-1 input samples.  Splitting at multiples of `down` is
    bit-exact vs one-shot.
    """

    def __init__(self, taps: np.ndarray, up: int = 1, down: int = 1,
                 dtype=jnp.float32):
        if up < 1 or down < 1:
            raise ValueError("up/down must be >= 1")
        taps = np.asarray(taps, dtype=np.float64)
        if taps.ndim != 1:
            raise ValueError("taps must be 1-D")
        self.up = int(up)
        self.down = int(down)
        self.dtype = dtype
        L = taps.size
        K = -(-L // up)  # taps per phase
        hpad = np.zeros(K * up)
        hpad[:L] = taps
        # phase_taps[r, j] = h[j*up + r]
        self._phase_taps = hpad.reshape(K, up).T.copy()
        self.taps_per_phase = K
        self.hist_len = K - 1
        # per-output-phase input offset d_i = floor(i*down/up)
        self._d = [(i * self.down) // self.up for i in range(self.up)]
        self._r = [(i * self.down) % self.up for i in range(self.up)]
        self._jit = jax.jit(self._run)

    def _run(self, xp: jnp.ndarray):
        """xp: (..., K-1 + T) history-prefixed input, T % down == 0.

        Each output phase is a strided 1-D convolution: one
        `conv_general_dilated` with window K and stride `down`.
        """
        K = self.taps_per_phase
        T = xp.shape[-1] - (K - 1)
        G = T // self.down
        up, down = self.up, self.down
        lead = xp.shape[:-1]
        lhs = xp.reshape((-1, 1, xp.shape[-1]))  # (N, C=1, W)
        outs = []
        for i in range(up):
            d, r = self._d[i], self._r[i]
            # y_i[m] = sum_j taps[r, j] * xp[d + K-1 - j + m*down]
            # == valid conv with the phase taps as the (reversed) kernel,
            # starting at offset d.
            rhs = jnp.asarray(self._phase_taps[r][::-1].reshape(1, 1, K),
                              dtype=xp.dtype)  # lax conv is cross-correlation
            seg = lhs[..., d: d + (G - 1) * down + K]
            y = jax.lax.conv_general_dilated(
                seg, rhs, window_strides=(down,), padding="VALID",
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=xp.dtype)
            outs.append(y.reshape(lead + (G,)))
        if up == 1:
            return outs[0]
        y = jnp.stack(outs, axis=-1)  # (..., G, up)
        return y.reshape(y.shape[:-2] + (G * up,))

    def __call__(self, x: jnp.ndarray,
                 state: Optional[FIRState] = None) -> Tuple[jnp.ndarray, FIRState]:
        T = x.shape[-1]
        if T % self.down != 0:
            raise ValueError(
                f"block length {T} must be a multiple of down={self.down}")
        x = x.astype(self.dtype)
        if state is None:
            state = fir_init(self.hist_len, x.shape[:-1], dtype=self.dtype)
        xp = jnp.concatenate([state.hist, x], axis=-1) if self.hist_len else x
        y = self._jit(xp)
        new_hist = xp[..., xp.shape[-1] - self.hist_len:] if self.hist_len \
            else state.hist
        return y, FIRState(new_hist)


class FIRFilter(PolyphaseResampler):
    """Plain streaming causal FIR: y[n] = sum_k h[k] x[n-k]
    (scipy.signal.lfilter(h, 1, x) semantics with explicit state)."""

    def __init__(self, taps, dtype=jnp.float32):
        super().__init__(taps, up=1, down=1, dtype=dtype)


class PolyphaseDecimator(PolyphaseResampler):
    """Anti-aliased decimate-by-q: filter then keep every q-th sample,
    computed at 1/q of the full-rate cost via the polyphase identity."""

    def __init__(self, taps, q: int, dtype=jnp.float32):
        super().__init__(taps, up=1, down=q, dtype=dtype)
        self.q = q


class PolyphaseInterpolator(PolyphaseResampler):
    """Interpolate-by-p: zero-stuff then filter, computed without ever
    materializing the zero-stuffed signal."""

    def __init__(self, taps, p: int, dtype=jnp.float32):
        super().__init__(taps, up=p, down=1, dtype=dtype)
        self.p = p


class OverlapSaveFIR:
    """FFT-domain block convolution (overlap-save) for long FIR filters.

    Frames the history-prefixed input into hops of B with window
    Nfft = B + L - 1, multiplies by the precomputed tap spectrum, and keeps
    the last B samples of each inverse transform.  Built on the four-step
    matmul FFT so the per-frame work is matmuls; frames are one batched
    gather.  Streaming-exact: identical to FIRFilter for any block split at
    multiples of B.
    """

    def __init__(self, taps: np.ndarray, block_size: int = 1024,
                 dtype=jnp.float32):
        taps = np.asarray(taps, dtype=np.float64)
        L = taps.size
        self.num_taps = L
        self.hist_len = L - 1
        self.block_size = int(block_size)
        # FFT window rounded UP to a power of two: arbitrary nfft values
        # (block + L - 1) factor badly and compile/run far slower.
        n = 1
        while n < self.block_size + L - 1:
            n <<= 1
        self.nfft = n
        self.dtype = dtype
        # Tap spectrum at trace time, float64 host FFT (numpy constants).
        H = np.fft.fft(taps, self.nfft)
        self._Hr = H.real.astype(np.dtype(dtype))
        self._Hi = H.imag.astype(np.dtype(dtype))
        self._jit = jax.jit(self._run)

    def _run(self, xp: jnp.ndarray):
        B, L, N = self.block_size, self.num_taps, self.nfft
        T = xp.shape[-1] - (L - 1)
        S = T // B
        # Each frame holds exactly its L-1+B real samples, zero-padded to
        # the power-of-two nfft — every frame's padding is zeros regardless
        # of how the stream was split, keeping streaming BIT-exact.
        # Gather-free framing: view xp as
        # B-sample blocks; frame f spans blocks [f, f + q), assembled as q
        # shifted block-slices + one concat.  Samples past W leak in from
        # the next hop, so a constant 0/1 mask restores the exact zero
        # padding (bit-identical frames to the old jnp.take path).
        W = L - 1 + B
        q = -(-W // B)
        nb = S + q - 1
        tail = nb * B - xp.shape[-1]
        lead = [(0, 0)] * (xp.ndim - 1)
        xb = jnp.pad(xp, lead + [(0, tail)]) if tail else xp
        xb = xb.reshape(xb.shape[:-1] + (nb, B))
        frames = jnp.concatenate([xb[..., j: j + S, :] for j in range(q)],
                                 axis=-1)              # (..., S, q B)
        if W < q * B:
            mask = np.zeros(q * B, dtype=np.dtype(self.dtype))
            mask[:W] = 1.0
            frames = frames * jnp.asarray(mask)
        if N > q * B:
            frames = jnp.concatenate(
                [frames, jnp.zeros(frames.shape[:-1] + (N - q * B,),
                                   dtype=frames.dtype)], axis=-1)
        elif N < q * B:
            frames = frames[..., :N]  # only masked zeros beyond W dropped
        # RI path: real input, complex never materializes.
        fr, fi = _fft.fft_ri(frames.astype(self.dtype),
                             jnp.zeros_like(frames, dtype=self.dtype))
        pr = fr * self._Hr - fi * self._Hi
        pi = fr * self._Hi + fi * self._Hr
        yr, _ = _fft.ifft_ri(pr, pi)
        # valid (non-aliased) samples per frame: [L-1, L-1+B)
        y = yr[..., L - 1:L - 1 + B].astype(xp.dtype)
        return y.reshape(y.shape[:-2] + (S * B,))

    def __call__(self, x: jnp.ndarray,
                 state: Optional[FIRState] = None) -> Tuple[jnp.ndarray, FIRState]:
        T = x.shape[-1]
        if T % self.block_size != 0:
            raise ValueError(
                f"block length {T} must be a multiple of {self.block_size}")
        x = x.astype(self.dtype)
        if state is None:
            state = fir_init(self.hist_len, x.shape[:-1], dtype=self.dtype)
        xp = jnp.concatenate([state.hist, x], axis=-1)
        y = self._jit(xp)
        return y, FIRState(xp[..., xp.shape[-1] - self.hist_len:])


def fir_filter(taps, x, state=None, *, method: str = "auto",
               block_size: int = 1024, dtype=None):
    """Convenience one-shot FIR.  method: 'direct' | 'fft' | 'auto'."""
    if method not in ("auto", "direct", "fft"):
        raise ValueError(f"unknown method {method!r} "
                         "(use 'direct', 'fft', or 'auto')")
    dtype = dtype or x.dtype
    L = np.asarray(taps).size
    if method == "fft" or (method == "auto" and L > 96
                           and x.shape[-1] % block_size == 0):
        return OverlapSaveFIR(taps, block_size=block_size, dtype=dtype)(x, state)
    return FIRFilter(taps, dtype=dtype)(x, state)


def decimate(x: jnp.ndarray, q: int, *, n: Optional[int] = None,
             ftype: str = "iir", zero_phase: bool = True) -> jnp.ndarray:
    """Anti-alias filter then downsample by the integer factor ``q``
    (scipy.signal.decimate semantics, parity-tested).

    ftype='iir': order-``n`` (default 8, even) Chebyshev-I low-pass with
    0.05 dB ripple at 0.8·(fs/2)/q (design.biquad.design_cheby1_lowpass),
    run as the biquad cascade — zero-phase (ops.iir.sosfiltfilt) or causal
    (ops.iir.sosfilt).
    ftype='fir': ``n``+1-tap (default 20·q) Hamming-windowed sinc at
    (fs/2)/q; zero_phase samples at the group-delay-compensated centers.

    One-shot whole-signal op; for streaming decimation use
    :class:`PolyphaseDecimator`.
    """
    if q < 1:
        raise ValueError(f"q must be a positive integer, got {q}")
    t = x.shape[-1]
    nout = -(-t // q)
    if ftype == "iir":
        from simpledsp_jax.design.biquad import design_cheby1_lowpass
        from simpledsp_jax.ops.iir import sosfilt, sosfiltfilt

        n = 8 if n is None else n
        if n < 2 or n % 2:
            raise ValueError("iir decimate needs an even order n >= 2 "
                             f"(biquad cascade), got {n}")
        design = design_cheby1_lowpass(n // 2, 0.05, 0.8 / q, 2.0)
        if zero_phase:
            y = sosfiltfilt(design, x)
        else:
            y, _ = sosfilt(design, x)
        return y[..., ::q]
    if ftype == "fir":
        from simpledsp_jax.design.fir import lowpass_taps
        from simpledsp_jax.ops.conv import convolve

        n = 20 * q if n is None else n
        taps = lowpass_taps(n + 1, 1.0 / q, fs=2.0, window="hamming")
        full = convolve(x, taps.astype(np.float64), "full")
        start = n // 2 if zero_phase else 0
        return full[..., start::q][..., :nout]
    raise ValueError(f"unknown ftype {ftype!r} (use 'iir' or 'fir')")


def resample_poly(x: jnp.ndarray, up: int, down: int, *,
                  window="kaiser_5.0", padtype: str = "constant"
                  ) -> jnp.ndarray:
    """Polyphase rational-rate resampling (scipy.signal.resample_poly
    semantics, parity-tested): anti-alias taps designed host-side
    (default: 20*max(up,down)+1-tap Kaiser beta=5.0 windowed sinc at
    1/max(up,down) of Nyquist), group delay compensated so y[0] aligns
    with x[0], output length ceil(T*up/down).

    window: the default marker, a scipy get_window spec (e.g. 'hamming',
    ('kaiser', 8.0)), or an explicit 1-D tap array.  padtype: 'constant'
    (zero extension) or 'mean'/'median'/'minimum'/'maximum' (subtract
    the statistic, filter, add back).

    One-shot whole-signal op over the streaming
    :class:`PolyphaseResampler` engine (strided XLA convs on device).
    """
    import math as _math

    g = _math.gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    if up < 1 or down < 1:
        raise ValueError("up and down must be >= 1")
    if up == down == 1:
        return x
    t = x.shape[-1]
    n_out = (t * up) // down + bool((t * up) % down)

    if isinstance(window, (np.ndarray, list, tuple)) and not (
            isinstance(window, tuple) and isinstance(window[0], str)):
        h = np.asarray(window, dtype=np.float64)
        if h.ndim != 1:
            raise ValueError("window taps must be 1-D")
        half_len = (h.size - 1) // 2
    else:
        max_rate = max(up, down)
        half_len = 10 * max_rate
        n = 2 * half_len + 1
        m = np.arange(n, dtype=np.float64) - half_len
        fc = 1.0 / max_rate                      # relative to Nyquist
        h = fc * np.sinc(fc * m)
        if window == "kaiser_5.0":
            w = np.kaiser(n, 5.0)
        else:
            import scipy.signal as _sig
            w = _sig.get_window(window, n, fftbins=False)
        h = h * w
        h = h / h.sum()
    h = h * up

    funcs = {"mean": jnp.mean, "median": jnp.median,
             "minimum": jnp.min, "maximum": jnp.max}
    background = None
    if padtype in funcs:
        background = funcs[padtype](x, axis=-1, keepdims=True)
        x = x - background
    elif padtype != "constant":
        raise ValueError(f"unsupported padtype {padtype!r} (use 'constant',"
                         " 'mean', 'median', 'minimum', or 'maximum')")

    # Center the output grid on the filter's group delay: pre-pad the taps
    # so the first kept output lands exactly on x[0] (scipy's rule).
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    hp = np.concatenate([np.zeros(n_pre_pad), h])
    need = n_pre_remove + n_out
    t_dev = down * (-(-need // up))              # covers `need` outputs
    pad = [(0, 0)] * (x.ndim - 1) + [(0, max(0, t_dev - t))]
    y, _ = PolyphaseResampler(hp, up, down, dtype=x.dtype)(jnp.pad(x, pad))
    y = y[..., n_pre_remove: n_pre_remove + n_out]
    if background is not None:
        y = y + background
    return y
