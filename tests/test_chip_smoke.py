"""chip_smoke.py at tiny sizes on the CPU: every phase's checks, the
four-card phases on four virtual devices, and the refusal to run on
anything but a GPU."""

import pathlib
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from simpledsp_jax.parallel import make_mesh  # noqa: E402


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_cpu(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_phase_chain_tiny():
    r = chip_smoke.phase_chain(channels=4, samples=4 * 4096, calls=4,
                               iters=2)
    assert r["snr_db"] >= chip_smoke.CHAIN_MIN_SNR_DB
    assert r["split_snr_db"] >= chip_smoke.SPLIT_MIN_SNR_DB
    assert r["shape"] == [4, 4 * 4096] and r["calls"] == 4
    assert r["compile_s"] > 0 and r["Msamples_per_s"] > 0
    assert "CompiledMemoryStats" in r["memory_analysis"]


def test_phase_bank_tiny():
    r = chip_smoke.phase_bank(streams=3, samples=16 * 4 * 64, calls=3,
                              iters=2)
    assert r["min_channel_snr_db"] >= chip_smoke.BANK_MIN_SNR_DB
    assert r["audio_shape"] == [2, 16, 3 * 64]


def test_phase_fm_rx_tiny():
    r = chip_smoke.phase_fm_rx(samples=16 * 4 * 64 * 16, block_frames=64)
    assert r["peaks_hz"] == pytest.approx({3: 1000.0, 9: 2500.0}, abs=32.0)
    assert r["audio_shape"] == [16, 1024]


@pytest.mark.parametrize("phase,name,kw", [
    (chip_smoke.phase_chain, "CHAIN_MIN_SNR_DB",
     dict(channels=2, samples=2 * 4096, calls=4, iters=1)),
    (chip_smoke.phase_bank, "BANK_MIN_SNR_DB",
     dict(streams=2, samples=16 * 4 * 32, calls=3, iters=1)),
])
def test_failed_parity_raises(monkeypatch, phase, name, kw):
    monkeypatch.setattr(chip_smoke, name, 1e6)
    with pytest.raises(AssertionError, match="SNR"):
        phase(**kw)


def test_fm_stations_offset_continues_the_stream():
    whole = np.asarray(chip_smoke.fm_stations(2, 4096, 16))
    tail = np.asarray(chip_smoke.fm_stations(2, 1024, 16, offset=3072))
    np.testing.assert_allclose(tail, whole[:, 3072:], atol=1e-6)
    assert whole.dtype == np.complex64 and whole.shape == (2, 4096)


def test_write_fm_capture_is_seeded(tmp_path):
    a, b = tmp_path / "a.iq16", tmp_path / "b.iq16"
    chip_smoke.write_fm_capture(str(a), 4096, 1.024e6, 16)
    chip_smoke.write_fm_capture(str(b), 4096, 1.024e6, 16)
    raw = np.fromfile(a, np.int16)
    assert raw.size == 2 * 4096 and np.abs(raw).max() < 32767
    assert a.read_bytes() == b.read_bytes()


def test_phase_four_chain_on_four_devices():
    mesh = make_mesh(dp=1, sp=4, devices=jax.devices()[:4])
    r = chip_smoke.phase_four_chain(mesh, channels=2, samples=4 * 2 * 4096)
    assert r["snr_vs_serial_db"] >= chip_smoke.SHARDED_MIN_SNR_DB
    assert r["snr_vs_oracle_db"] >= chip_smoke.CHAIN_MIN_SNR_DB
    assert len(r["spectra_devices"]) == 4 and len(r["state_devices"]) == 4


def test_phase_four_bank_on_four_devices():
    mesh = make_mesh(dp=4, sp=1, devices=jax.devices()[:4])
    r = chip_smoke.phase_four_bank(mesh, streams=8, samples=16 * 4 * 64)
    assert r["max_rel_dev"] <= chip_smoke.SHARDED_BANK_MAX_REL
    assert len(r["audio_devices"]) == 4 and len(r["state_devices"]) == 4
