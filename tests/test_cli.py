"""End-to-end CLI tests: all three subcommands through the native
streaming runtime (file -> ring buffer -> DSP -> .npz), including tone
recovery, the EOF/drain path, and the saved-state resume contract
(VERDICT r1 item 7)."""

import numpy as np
import pytest

from simpledsp_jax import cli


def _write_f32_tone(path, freq, fs, n, amp=1.0):
    t = np.arange(n) / fs
    x = (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    x.tofile(path)
    return x


def _write_iq16_fm(path, fs, channels, n, tone_hz=400.0, chan=3,
                   deviation=75e3):
    """FM-modulate a tone onto carrier `chan` (center chan*fs/M) and write
    interleaved int16 IQ."""
    t = np.arange(n) / fs
    phase = 2 * np.pi * chan * (fs / channels) * t + (
        deviation / tone_hz) * np.sin(2 * np.pi * tone_hz * t)
    iq = np.empty(2 * n, dtype=np.int16)
    iq[0::2] = np.round(16384 * np.cos(phase)).astype(np.int16)
    iq[1::2] = np.round(16384 * np.sin(phase)).astype(np.int16)
    iq.tofile(path)


class TestSpectraCmd:
    FS = 39000.0
    FFT = 4096

    def _run(self, tmp_path, name, infile, extra=()):
        out = tmp_path / f"{name}.npz"
        rc = cli.main(["spectra", "--input", str(infile), "--output",
                       str(out), "--rate", str(self.FS), "--fft",
                       str(self.FFT), "--block-frames", "1",
                       "--design", "lp:8000", *extra])
        assert rc == 0
        return np.load(out)

    def test_tone_recovery_and_state_file(self, tmp_path):
        freq = 2500.0
        infile = tmp_path / "tone.f32"
        _write_f32_tone(infile, freq, self.FS, 3 * self.FFT)
        data = self._run(tmp_path, "spec", infile)
        spec = data["spec_re"] + 1j * data["spec_im"]
        assert spec.shape == (3, self.FFT // 2)
        peak = np.abs(spec[1]).argmax()
        expect = round(freq / self.FS * self.FFT)
        assert abs(peak - expect) <= 1
        # carried state saved alongside (resume contract)
        assert (tmp_path / "spec.npz.state.npz").exists()

    def test_resume_equals_continuous(self, tmp_path):
        rng = np.random.default_rng(7)
        x = rng.standard_normal(4 * self.FFT).astype(np.float32)
        whole = tmp_path / "whole.f32"
        x.tofile(whole)
        a = tmp_path / "a.f32"
        b = tmp_path / "b.f32"
        x[: 2 * self.FFT].tofile(a)
        x[2 * self.FFT:].tofile(b)

        ref = self._run(tmp_path, "whole", whole)
        p1 = self._run(tmp_path, "p1", a)
        p2 = self._run(tmp_path, "p2", b,
                       extra=("--state",
                              str(tmp_path / "p1.npz.state.npz")))
        got_re = np.concatenate([p1["spec_re"], p2["spec_re"]], axis=0)
        got_im = np.concatenate([p1["spec_im"], p2["spec_im"]], axis=0)
        np.testing.assert_allclose(got_re, ref["spec_re"], atol=1e-5)
        np.testing.assert_allclose(got_im, ref["spec_im"], atol=1e-5)

    def test_partial_tail_dropped(self, tmp_path):
        """EOF/drain: a trailing partial block is dropped, full blocks
        still processed."""
        infile = tmp_path / "tail.f32"
        _write_f32_tone(infile, 1000.0, self.FS, 2 * self.FFT + 100)
        data = self._run(tmp_path, "tail", infile)
        assert data["spec_re"].shape[0] == 2

    def test_no_complete_blocks_is_error(self, tmp_path, capsys):
        infile = tmp_path / "short.f32"
        _write_f32_tone(infile, 1000.0, self.FS, 100)
        out = tmp_path / "short.npz"
        rc = cli.main(["spectra", "--input", str(infile), "--output",
                       str(out), "--rate", str(self.FS), "--fft",
                       str(self.FFT), "--block-frames", "1"])
        assert rc == 1
        assert "no complete blocks" in capsys.readouterr().err

    def test_unknown_design_is_error(self, tmp_path):
        infile = tmp_path / "x.f32"
        _write_f32_tone(infile, 1000.0, self.FS, self.FFT)
        rc = cli.main(["spectra", "--input", str(infile), "--output",
                       str(tmp_path / "x.npz"), "--rate", str(self.FS),
                       "--design", "notch:42"])
        assert rc == 2


class TestRxCmds:
    FS = 256000.0
    M = 16
    DECIM = 4

    def _run(self, tmp_path, name, infile, mode, extra=()):
        out = tmp_path / f"{name}.npz"
        rc = cli.main([f"{mode}-rx", "--input", str(infile), "--output",
                       str(out), "--rate", str(self.FS), "--format",
                       "iq16", "--channels", str(self.M), "--decim",
                       str(self.DECIM), "--block-frames", "16", *extra])
        assert rc == 0
        return np.load(out)

    def test_fm_tone_recovery(self, tmp_path):
        n = 16 * self.M * self.DECIM * 16  # 16 CLI blocks
        infile = tmp_path / "fm.iq16"
        # deviation sized to the 16 kHz channel (Carson BW ~7 kHz)
        _write_iq16_fm(infile, self.FS, self.M, n, tone_hz=500.0, chan=3,
                       deviation=3000.0)
        data = self._run(tmp_path, "fm", infile, "fm",
                         extra=("--deviation", "3000"))
        audio = data["audio"]
        audio_rate = float(data["rate"])
        assert audio.shape == (self.M, n // self.M // self.DECIM)
        assert audio_rate == self.FS / self.M / self.DECIM
        # channel 3 carries a 500 Hz tone; skip the filter warm-up.
        seg = audio[3, 48:]
        spec = np.abs(np.fft.rfft(seg * np.hanning(seg.size)))
        peak = spec[1:].argmax() + 1
        expect = 500.0 / audio_rate * seg.size
        assert abs(peak - expect) <= 2
        # the tone dominates its channel's audio band
        others = np.delete(spec[1:], [int(peak) - 2, int(peak) - 1,
                                      int(peak)])
        assert spec[int(peak)] > 3 * others.max()

    def test_am_runs_and_saves_state(self, tmp_path):
        n = 2 * self.M * self.DECIM * 16
        infile = tmp_path / "am.iq16"
        _write_iq16_fm(infile, self.FS, self.M, n)
        data = self._run(tmp_path, "am", infile, "am",
                         extra=("--save-state", str(tmp_path / "am_s.npz")))
        assert data["audio"].shape == (self.M, n // self.M // self.DECIM)
        assert (tmp_path / "am_s.npz").exists()

    def test_fm_resume_equals_continuous(self, tmp_path):
        rng = np.random.default_rng(11)
        n = 4 * self.M * self.DECIM * 16
        iq = (rng.integers(-8000, 8000, 2 * n)).astype(np.int16)
        whole = tmp_path / "w.iq16"
        iq.tofile(whole)
        a, b = tmp_path / "a.iq16", tmp_path / "b.iq16"
        iq[: n].tofile(a)       # first n/2 pairs
        iq[n:].tofile(b)
        ref = self._run(tmp_path, "w", whole, "fm")
        p1 = self._run(tmp_path, "p1", a, "fm")
        p2 = self._run(tmp_path, "p2", b, "fm",
                       extra=("--state",
                              str(tmp_path / "p1.npz.state.npz")))
        got = np.concatenate([p1["audio"], p2["audio"]], axis=-1)
        np.testing.assert_allclose(got, ref["audio"], atol=1e-5)


def test_bad_subcommand_exits():
    with pytest.raises(SystemExit):
        cli.main(["frobnicate"])


class TestMfccCmd:
    FS = 16000.0

    def test_tone_features_and_frame_count(self, tmp_path):
        """i16 PCM tone -> streaming MFCC; frame count matches the
        zero-history streaming framing and the tone's mel band dominates
        the log-mel reconstruction."""
        n = 16384
        t = np.arange(n) / self.FS
        x = np.round(20000 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.int16)
        src = tmp_path / "tone.pcm"
        x.tofile(src)
        out = tmp_path / "feat.npz"
        rc = cli.main(["mfcc", "--input", str(src), "--output", str(out),
                       "--rate", str(self.FS), "--fft", "512",
                       "--mels", "40", "--coeffs", "13",
                       "--block-frames", "16"])
        assert rc == 0
        z = np.load(str(out))
        feats = z["mfcc"]
        # block = hop*16 = 4096 -> 4 blocks; each yields
        # (hist 256 + 4096 - 512)//256 + 1 = 16 frames.
        assert feats.shape == (64, 13)
        assert np.all(np.isfinite(feats))
        # c0 (frame energy) of the steady tone is stable after warmup.
        c0 = feats[2:, 0]
        assert np.std(c0) < 0.05 * np.abs(np.mean(c0)) + 1e-6

    def test_bad_hop_is_error(self, tmp_path):
        src = tmp_path / "x.pcm"
        np.zeros(1024, np.int16).tofile(src)
        rc = cli.main(["mfcc", "--input", str(src), "--output",
                       str(tmp_path / "o.npz"), "--rate", "16000",
                       "--fft", "512", "--hop", "100"])
        assert rc == 2

    def test_empty_file_is_error(self, tmp_path, capsys):
        src = tmp_path / "empty.pcm"
        src.write_bytes(b"")
        rc = cli.main(["mfcc", "--input", str(src), "--output",
                       str(tmp_path / "o.npz"), "--rate", "16000"])
        assert rc == 1


class TestModemSim:
    def test_ber_sweep_decreases_and_saves(self, tmp_path, capsys):
        out = tmp_path / "ber.npz"
        rc = cli.main(["modem-sim", "--constellation", "qpsk",
                       "--ebn0", "2:6:2", "--symbols", "8000",
                       "--output", str(out)])
        assert rc == 0
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{")]
        assert len(lines) == 3
        z = np.load(str(out))
        b = z["ber"]
        assert b[0] > b[1] > b[2] > 0          # monotone in Eb/N0
        # 4 dB point within a loose statistical band of theory (1.25e-2)
        assert 0.5e-2 < b[1] < 2.5e-2
