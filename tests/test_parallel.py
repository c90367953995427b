"""Sharded-pipeline tests on the virtual 8-device CPU mesh.

Methodology per SURVEY.md §4: the reference has no distributed tests (it is
single-threaded); these validate the net-new parallel layer against the
serial oracles — sharded == serial is this framework's analog of the
reference's blockwise == whole-signal contract (test/testIIR.cpp:61-75).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig

from simpledsp_jax.design.biquad import design_bandpass, design_lowpass
from simpledsp_jax.design.fir import lowpass_taps
from simpledsp_jax.ops.channelizer import PFBChannelizer
from simpledsp_jax.ops.fir import PolyphaseResampler
from simpledsp_jax.ops.iir import coeffs_from_design, iir_init, sosfilt_scan
from simpledsp_jax.parallel import (
    ShardedBlockIIR,
    ShardedChannelizer,
    ShardedFIR,
    make_mesh,
)


@pytest.fixture(scope="module")
def mesh24():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(dp=2, sp=4)


@pytest.fixture(scope="module")
def mesh18():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(dp=1, sp=8)


class TestShardedIIR:
    def test_matches_scan_oracle_f64(self, mesh24, rng):
        design = design_lowpass(4, 200.0, 39000.0)
        x = rng.standard_normal((4, 4096))
        f = ShardedBlockIIR(design, mesh24, block_size=128, dtype=jnp.float64)
        y, _ = f(jnp.asarray(x))
        coeffs = coeffs_from_design(design, dtype=jnp.float64)
        y_ref, _ = sosfilt_scan(coeffs, jnp.asarray(x),
                                iir_init(4, (4,), dtype=jnp.float64))
        np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                                   atol=1e-11)

    def test_matches_scipy_sosfilt(self, mesh18, rng):
        from simpledsp_jax.design.biquad import sos_matrix
        design = design_bandpass(4, 2000.0, 39000.0, 0.8)
        x = rng.standard_normal((2, 2048))
        f = ShardedBlockIIR(design, mesh18, block_size=64, dtype=jnp.float64)
        y, _ = f(jnp.asarray(x))
        y_ref = sig.sosfilt(sos_matrix(design), x, axis=-1)
        np.testing.assert_allclose(np.asarray(y), y_ref, atol=1e-11)

    def test_streaming_across_sharded_calls(self, mesh24, rng):
        design = design_lowpass(4, 1000.0, 39000.0)
        x = rng.standard_normal((2, 8192))
        f = ShardedBlockIIR(design, mesh24, block_size=128, dtype=jnp.float64)
        y_whole, s_whole = f(jnp.asarray(x))
        y1, s = f(jnp.asarray(x[:, :4096]))
        y2, s = f(jnp.asarray(x[:, 4096:]), s)
        y_blocks = jnp.concatenate([y1, y2], axis=-1)
        np.testing.assert_allclose(np.asarray(y_blocks), np.asarray(y_whole),
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(s.y_hist),
                                   np.asarray(s_whole.y_hist), atol=1e-12)

    def test_f32_snr(self, mesh18, rng):
        design = design_lowpass(4, 2000.0, 39000.0)
        x = rng.standard_normal((1, 8192)).astype(np.float32)
        f = ShardedBlockIIR(design, mesh18, block_size=256, dtype=jnp.float32)
        y, _ = f(jnp.asarray(x))
        coeffs = coeffs_from_design(design, dtype=jnp.float64)
        y_ref, _ = sosfilt_scan(coeffs, jnp.asarray(x, dtype=jnp.float64),
                                iir_init(4, (1,), dtype=jnp.float64))
        err = np.asarray(y, dtype=np.float64) - np.asarray(y_ref)
        snr = 10 * np.log10(np.mean(np.asarray(y_ref) ** 2) /
                            max(np.mean(err ** 2), 1e-30))
        assert snr > 90.0, f"sharded f32 SNR too low: {snr:.1f} dB"


class TestShardedFIR:
    def test_matches_serial_fir(self, mesh24, rng):
        taps = lowpass_taps(63, 0.12, fs=1.0)
        x = rng.standard_normal((4, 2048))
        f = ShardedFIR(taps, mesh24, dtype=jnp.float64)
        y, _ = f(jnp.asarray(x))
        y_ref = sig.lfilter(taps, [1.0], x, axis=-1)
        np.testing.assert_allclose(np.asarray(y), y_ref, atol=1e-12)

    def test_resampler_matches_upfirdn(self, mesh18, rng):
        from simpledsp_jax.design.fir import resampler_taps
        up, down = 3, 2
        taps = resampler_taps(up, down, taps_per_phase=8)
        x = rng.standard_normal((2, 1600))
        f = ShardedFIR(taps, mesh18, up=up, down=down, dtype=jnp.float64)
        y, _ = f(jnp.asarray(x))
        serial = PolyphaseResampler(taps, up=up, down=down, dtype=jnp.float64)
        y_ref, _ = serial(jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                                   atol=1e-12)

    def test_streaming_across_sharded_calls(self, mesh24, rng):
        taps = lowpass_taps(33, 0.2, fs=1.0)
        x = rng.standard_normal((2, 4096))
        f = ShardedFIR(taps, mesh24, dtype=jnp.float64)
        y_whole, _ = f(jnp.asarray(x))
        y1, s = f(jnp.asarray(x[:, :2048]))
        y2, _ = f(jnp.asarray(x[:, 2048:]), s)
        y_blocks = jnp.concatenate([y1, y2], axis=-1)
        np.testing.assert_allclose(np.asarray(y_blocks), np.asarray(y_whole),
                                   atol=1e-14)


class TestShardedChannelizer:
    def test_matches_serial(self, mesh18, rng):
        m = 16
        x = (rng.standard_normal((2, 4096))
             + 1j * rng.standard_normal((2, 4096)))
        ch = ShardedChannelizer(m, mesh18, taps_per_channel=8,
                                dtype=jnp.float64)
        y, _ = ch(jnp.asarray(x))
        serial = PFBChannelizer(m, taps=None, taps_per_channel=8,
                                dtype=jnp.float64)
        # identical prototype taps
        serial._branch = ch.pfb._branch
        y_ref, _ = PFBChannelizer.__call__(ch.pfb, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                                   atol=1e-10)

    def test_streaming_across_sharded_calls(self, mesh18, rng):
        m = 8
        x = rng.standard_normal((1, 2048)) + 1j * rng.standard_normal((1, 2048))
        ch = ShardedChannelizer(m, mesh18, taps_per_channel=4,
                                dtype=jnp.float64)
        y_whole, _ = ch(jnp.asarray(x))
        y1, s = ch(jnp.asarray(x[:, :1024]))
        y2, _ = ch(jnp.asarray(x[:, 1024:]), s)
        y_blocks = jnp.concatenate([y1, y2], axis=-2)
        np.testing.assert_allclose(np.asarray(y_blocks), np.asarray(y_whole),
                                   atol=1e-10)


class TestShardedOverlapSave:
    def test_matches_serial_lfilter(self, mesh18, rng):
        from simpledsp_jax.parallel import ShardedOverlapSaveFIR
        taps = lowpass_taps(129, 0.1, fs=1.0)
        x = rng.standard_normal((2, 4096))
        f = ShardedOverlapSaveFIR(taps, mesh18, block_size=256,
                                  dtype=jnp.float64)
        y, _ = f(jnp.asarray(x))
        y_ref = sig.lfilter(taps, [1.0], x, axis=-1)
        np.testing.assert_allclose(np.asarray(y), y_ref, atol=1e-10)

    def test_streaming_across_calls(self, mesh18, rng):
        from simpledsp_jax.parallel import ShardedOverlapSaveFIR
        taps = lowpass_taps(65, 0.2, fs=1.0)
        x = rng.standard_normal((1, 8192))
        f = ShardedOverlapSaveFIR(taps, mesh18, block_size=256,
                                  dtype=jnp.float64)
        y_whole, _ = f(jnp.asarray(x))
        y1, s = f(jnp.asarray(x[:, :4096]))
        y2, _ = f(jnp.asarray(x[:, 4096:]), s)
        np.testing.assert_allclose(
            np.asarray(jnp.concatenate([y1, y2], axis=-1)),
            np.asarray(y_whole), atol=1e-11)


class TestChannelizerGather:
    def test_gathered_output_replicated_and_correct(self, mesh18, rng):
        m = 8
        x = rng.standard_normal((1, 2048)) + 1j * rng.standard_normal((1, 2048))
        local = ShardedChannelizer(m, mesh18, taps_per_channel=4,
                                   dtype=jnp.float64)
        gathered = ShardedChannelizer(m, mesh18, taps_per_channel=4,
                                      dtype=jnp.float64, gather_output=True)
        y_local, _ = local(jnp.asarray(x))
        y_gath, _ = gathered(jnp.asarray(x))
        assert y_gath.shape == y_local.shape  # global frames either way
        np.testing.assert_allclose(np.asarray(y_gath), np.asarray(y_local),
                                   atol=1e-12)
        # gathered result is replicated over sp (one shard per device)
        assert len(y_gath.sharding.device_set) == 8


class TestShardedReceiverBank:
    """dp-sharded SDR banks == the serial banks stream for stream,
    streaming across calls."""

    def test_fm_bank_sharded_equals_serial(self, mesh24, rng):
        from simpledsp_jax.models.sdr import FMReceiverBank
        from simpledsp_jax.parallel import ShardedReceiverBank

        bank = FMReceiverBank(16, fs=1.6e6, dtype=jnp.float64)
        sharded = ShardedReceiverBank(bank, mesh24)
        x = (rng.standard_normal((4, 16 * 256))
             + 1j * rng.standard_normal((4, 16 * 256)))
        ss = sharded.init_state(4)
        sp = bank.init_state(4)
        for _ in range(2):
            a_s, ss = sharded(x, ss)
            a_p, sp = bank(x, sp)
            np.testing.assert_allclose(np.asarray(a_s), np.asarray(a_p),
                                       atol=1e-12)
        np.testing.assert_allclose(np.asarray(ss.chan.hist_r),
                                   np.asarray(sp.chan.hist_r), atol=0)
        np.testing.assert_allclose(np.asarray(ss.demod.prev_r),
                                   np.asarray(sp.demod.prev_r), atol=1e-12)

    def test_am_bank_dc_sharded_equals_serial(self, mesh24, rng):
        from simpledsp_jax.models.sdr import AMReceiverBank
        from simpledsp_jax.parallel import ShardedReceiverBank

        bank = AMReceiverBank(16, fs=1.6e6, dtype=jnp.float64)
        sharded = ShardedReceiverBank(bank, mesh24)
        x = (rng.standard_normal((4, 16 * 256))
             + 1j * rng.standard_normal((4, 16 * 256)))
        ss = sharded.init_state(4)
        sp = bank.init_state(4)
        for _ in range(2):   # per-call DC removal, streaming across calls
            a_s, ss = sharded(x, ss)
            a_p, sp = bank(x, sp)
            np.testing.assert_allclose(np.asarray(a_s), np.asarray(a_p),
                                       atol=1e-12)
        np.testing.assert_allclose(np.asarray(ss.audio.hist),
                                   np.asarray(sp.audio.hist), atol=1e-12)

    def test_batch_not_divisible_raises(self, mesh24):
        from simpledsp_jax.models.sdr import FMReceiverBank
        from simpledsp_jax.parallel import ShardedReceiverBank

        bank = FMReceiverBank(16, fs=1.6e6, dtype=jnp.float64)
        sharded = ShardedReceiverBank(bank, mesh24)
        with pytest.raises(ValueError):
            sharded(jnp.zeros((3, 16 * 64), jnp.float64))


class TestShardedConvolve:
    def test_same_mode_matches_serial(self, mesh24, rng):
        from simpledsp_jax.ops.conv import convolve
        from simpledsp_jax.parallel.fir import ShardedConvolve
        h = lowpass_taps(301, 0.1, fs=1.0)
        x = rng.standard_normal((4, 8192))
        sc = ShardedConvolve(h, mesh24, dtype=jnp.float64)
        got = np.asarray(sc(jnp.asarray(x)))
        ref = np.asarray(convolve(jnp.asarray(x), h, mode="same"))
        np.testing.assert_allclose(got, ref, atol=1e-12)

    def test_even_taps_and_sp8(self, mesh18, rng):
        from simpledsp_jax.ops.conv import convolve
        from simpledsp_jax.parallel.fir import ShardedConvolve
        h = rng.standard_normal(64)
        x = rng.standard_normal((2, 4096))
        sc = ShardedConvolve(h, mesh18, dtype=jnp.float64)
        got = np.asarray(sc(jnp.asarray(x)))
        ref = np.asarray(convolve(jnp.asarray(x), h, mode="same"))
        np.testing.assert_allclose(got, ref, atol=1e-12)

    def test_scipy_oracle(self, mesh18, rng):
        from simpledsp_jax.parallel.fir import ShardedConvolve
        h = rng.standard_normal(33)
        x = rng.standard_normal((1, 2048))
        sc = ShardedConvolve(h, mesh18, dtype=jnp.float64)
        got = np.asarray(sc(jnp.asarray(x)))[0]
        ref = sig.convolve(x[0], h, mode="same")
        np.testing.assert_allclose(got, ref, atol=1e-10)

    def test_short_shard_raises(self, mesh18):
        from simpledsp_jax.parallel.fir import ShardedConvolve
        sc = ShardedConvolve(np.ones(301), mesh18, dtype=jnp.float64)
        with pytest.raises(ValueError, match="halo"):
            sc(jnp.zeros((1, 8 * 128)))


class TestShardedSTFT:
    @pytest.mark.parametrize("hop_div", [1, 2, 4])
    def test_matches_serial(self, mesh24, rng, hop_div):
        from simpledsp_jax.ops.spectral import stft_ri
        from simpledsp_jax.parallel.spectral import ShardedSTFT
        nfft = 256
        hop = nfft // hop_div
        x = rng.standard_normal((4, 8192))
        st = ShardedSTFT(mesh24, nfft=nfft, hop=hop, dtype=jnp.float64)
        gr, gi = st(jnp.asarray(x))
        rr, ri_ = stft_ri(jnp.asarray(x), nfft, hop=hop)
        np.testing.assert_allclose(np.asarray(gr), np.asarray(rr),
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(gi), np.asarray(ri_),
                                   atol=1e-12)

    def test_sp8_onesided_false(self, mesh18, rng):
        from simpledsp_jax.ops.spectral import stft_ri
        from simpledsp_jax.parallel.spectral import ShardedSTFT
        x = rng.standard_normal((2, 8 * 512))
        st = ShardedSTFT(mesh18, nfft=128, hop=64, onesided=False,
                         dtype=jnp.float64)
        gr, gi = st(jnp.asarray(x))
        rr, ri_ = stft_ri(jnp.asarray(x), 128, hop=64, onesided=False)
        np.testing.assert_allclose(np.asarray(gr), np.asarray(rr),
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(gi), np.asarray(ri_),
                                   atol=1e-12)

    def test_bad_hop_raises(self, mesh18):
        from simpledsp_jax.parallel.spectral import ShardedSTFT
        with pytest.raises(ValueError, match="hop"):
            ShardedSTFT(mesh18, nfft=256, hop=96)

    def test_padded_keeps_frames_sharded(self, mesh18, rng):
        """padded=True returns uniform T//hop frames (no gather-forcing
        trailing slice; the composed-jit form);
        the valid prefix equals the unpadded result."""
        from simpledsp_jax.parallel.spectral import ShardedSTFT
        x = rng.standard_normal((2, 8 * 512))
        st = ShardedSTFT(mesh18, nfft=128, hop=64, dtype=jnp.float64)
        pr, pi = st(jnp.asarray(x), padded=True)
        gr, gi = st(jnp.asarray(x))
        assert pr.shape[1] == x.shape[1] // 64
        nf = gr.shape[1]
        np.testing.assert_array_equal(np.asarray(pr)[:, :nf], np.asarray(gr))
        np.testing.assert_array_equal(np.asarray(pi)[:, :nf], np.asarray(gi))
