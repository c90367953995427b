"""Native streaming-runtime tests (ring buffer, converters, file source).

These run on the host only (no accelerator); they validate the C++ library through
its public ctypes bindings, including a threaded producer/consumer and an
end-to-end file -> ring -> RI planes -> FM receiver flow.
"""

import threading

import numpy as np
import pytest

pytest.importorskip("ctypes")

from simpledsp_jax.runtime import (
    FileSink,
    FileSource,
    RingBuffer,
    f32_to_i16,
    i16_to_f32,
    iq16_to_planes,
    iqu8_to_planes,
)


class TestRingBuffer:
    def test_push_pop_roundtrip(self, rng):
        r = RingBuffer(1 << 16)
        data = rng.integers(0, 256, 5000, dtype=np.uint8)
        assert r.push(data) == 5000
        out = r.pop(5000)
        np.testing.assert_array_equal(out, data)
        r.close()

    def test_wraparound(self, rng):
        r = RingBuffer(1 << 12)  # 4096
        for _ in range(10):  # push/pop 3000 repeatedly to force wrap
            data = rng.integers(0, 256, 3000, dtype=np.uint8)
            assert r.push(data) == 3000
            np.testing.assert_array_equal(r.pop(3000), data)
        r.close()

    def test_backpressure(self, rng):
        r = RingBuffer(1024)
        data = rng.integers(0, 256, 2000, dtype=np.uint8)
        pushed = r.push(data)
        assert pushed == 1024  # capacity-limited, no overwrite
        np.testing.assert_array_equal(r.pop(4096), data[:1024])
        r.close()

    def test_threaded_producer_consumer(self, rng):
        r = RingBuffer(1 << 14)
        total = 1 << 20
        src = rng.integers(0, 256, total, dtype=np.uint8)
        got = []

        def producer():
            off = 0
            while off < total:
                off += r.push(src[off:off + 4096])

        th = threading.Thread(target=producer)
        th.start()
        read = 0
        while read < total:
            blk = r.pop_exact(8192, timeout=10.0)
            assert blk is not None, "consumer timed out"
            got.append(blk)
            read += blk.size
        th.join()
        np.testing.assert_array_equal(np.concatenate(got), src)
        r.close()


class TestConverters:
    def test_iq16(self, rng):
        raw = rng.integers(-32768, 32768, 2048, dtype=np.int16)
        re, im = iq16_to_planes(raw)
        np.testing.assert_allclose(re, raw[0::2] / 32768.0, rtol=1e-6)
        np.testing.assert_allclose(im, raw[1::2] / 32768.0, rtol=1e-6)

    def test_iqu8(self, rng):
        raw = rng.integers(0, 256, 2048, dtype=np.uint8)
        re, im = iqu8_to_planes(raw)
        np.testing.assert_allclose(re, (raw[0::2] - 127.5) / 127.5,
                                   rtol=1e-5, atol=1e-6)

    def test_i16_f32_roundtrip(self, rng):
        x = np.clip(rng.standard_normal(4096) * 0.3, -0.99,
                    0.99).astype(np.float32)
        i = f32_to_i16(x)
        back = i16_to_f32(i, scale=1.0 / 32767.0)
        np.testing.assert_allclose(back, x, atol=1.1 / 32767.0)

    def test_f32_i16_clamps(self):
        x = np.array([2.0, -2.0, 0.0], dtype=np.float32)
        i = f32_to_i16(x)
        assert i[0] == 32767 and i[1] == -32768 and i[2] == 0


class TestFileSource:
    def test_streams_file_through_ring(self, tmp_path, rng):
        data = rng.integers(0, 256, 300_000, dtype=np.uint8)
        path = tmp_path / "stream.bin"
        path.write_bytes(data.tobytes())
        ring = RingBuffer(1 << 14)
        got = []
        with FileSource(path, ring, chunk=4096) as src:
            read = 0
            while read < data.size:
                blk = ring.pop_exact(10_000, timeout=10.0)
                assert blk is not None
                got.append(blk)
                read += blk.size
        np.testing.assert_array_equal(np.concatenate(got), data)
        ring.close()

    def test_missing_file_raises(self):
        ring = RingBuffer(1024)
        with pytest.raises(FileNotFoundError):
            FileSource("/nonexistent/nope.bin", ring)
        ring.close()

    def test_end_to_end_iq_file_to_fm_receiver(self, tmp_path):
        """File of int16 IQ -> native ring -> RI planes -> FM receiver."""
        import jax.numpy as jnp
        from simpledsp_jax.models.sdr import FMReceiverBank

        fs, m, decim = 256e3, 8, 2
        T = 8192
        t = np.arange(T) / fs
        ftone, dev = 400.0, 2e3
        iq = 0.9 * np.exp(1j * (2 * np.pi * (2 * fs / m) * t
                                + dev / ftone * np.sin(2 * np.pi * ftone * t)))
        raw = np.empty(2 * T, dtype=np.int16)
        raw[0::2] = np.round(iq.real * 32000)
        raw[1::2] = np.round(iq.imag * 32000)
        path = tmp_path / "iq.bin"
        path.write_bytes(raw.tobytes())

        ring = RingBuffer(1 << 18)
        blocks = []
        block_pairs = 2048
        with FileSource(path, ring, chunk=8192):
            read = 0
            while read < T:
                blk = ring.pop_exact(block_pairs * 4, dtype=np.int16,
                                     timeout=10.0)
                assert blk is not None
                blocks.append(iq16_to_planes(blk, scale=1.0 / 32000.0))
                read += block_pairs
        ring.close()

        rx = FMReceiverBank(m, fs, decim=decim, deviation_hz=dev,
                            dtype=jnp.float64)
        state = None
        audio = []
        for re, im in blocks:
            a, state = rx((jnp.asarray(re[None, :]), jnp.asarray(im[None, :])),
                          state)
            audio.append(np.asarray(a))
        a = np.concatenate(audio, axis=-1)[0, 2][50:]
        arate = fs / m / decim
        spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
        peak = np.fft.rfftfreq(a.size, 1 / arate)[np.argmax(spec)]
        assert abs(peak - ftone) < 3 * arate / a.size, peak


class TestPopAlignment:
    def test_partial_pop_keeps_split_elements(self, rng):
        """Regression: a pop that lands mid-element must not crash or drop
        bytes — the partial element is returned by the next pop."""
        r = RingBuffer(1 << 12)
        data = rng.integers(-1000, 1000, 600, dtype=np.int16)
        raw = data.tobytes()
        r.push(np.frombuffer(raw[:101], dtype=np.uint8))  # odd byte count
        first = r.pop(200, dtype=np.int16)
        assert first.size == 50  # 100 bytes -> 50 elements, 1 byte pending
        r.push(np.frombuffer(raw[101:], dtype=np.uint8))
        rest = r.pop(len(raw), dtype=np.int16)
        got = np.concatenate([first, rest])
        np.testing.assert_array_equal(got, data)
        r.close()


class TestMultithreadedConverters:
    """The _mt fork-join converters must be bit-identical to the serial
    loops at any thread count (including the <1 MB serial fallback)."""

    def test_iq16_mt_matches_serial(self, rng):
        raw = rng.integers(-32768, 32768, size=2_000_000,
                           dtype=np.int16)
        re1, im1 = iq16_to_planes(raw, threads=1)
        for threads in (0, 2, 4):
            re, im = iq16_to_planes(raw, threads=threads)
            assert np.array_equal(re, re1)
            assert np.array_equal(im, im1)

    def test_iqu8_mt_matches_serial(self, rng):
        raw = rng.integers(0, 256, size=3_000_001, dtype=np.uint8)
        raw = raw[:-1]  # even pair count
        re1, im1 = iqu8_to_planes(raw, threads=1)
        re4, im4 = iqu8_to_planes(raw, threads=4)
        assert np.array_equal(re4, re1)
        assert np.array_equal(im4, im1)

    def test_i16_f32_mt_small_block_serial_fallback(self, rng):
        raw = rng.integers(-100, 100, size=777, dtype=np.int16)
        assert np.array_equal(i16_to_f32(raw, threads=8),
                              i16_to_f32(raw, threads=1))

    def test_f32_i16_mt_matches_serial(self, rng):
        x = rng.standard_normal(1_500_000).astype(np.float32) * 2.0
        assert np.array_equal(f32_to_i16(x, threads=4),
                              f32_to_i16(x, threads=1))


class TestFileSink:
    def test_drains_ring_to_file(self, tmp_path, rng):
        data = rng.integers(0, 256, size=300_000, dtype=np.uint8)
        ring = RingBuffer(1 << 16)
        path = tmp_path / "out.bin"
        with FileSink(path, ring) as sink:
            off = 0
            while off < data.size:
                off += ring.push(data[off:off + 30_000])
            # stop() (via __exit__) must drain the remainder.
        assert np.array_equal(np.fromfile(path, dtype=np.uint8), data)
        ring.close()

    def test_written_count_and_stop_return(self, tmp_path, rng):
        data = rng.integers(0, 256, size=65_536, dtype=np.uint8)
        ring = RingBuffer(1 << 20)
        sink = FileSink(tmp_path / "w.bin", ring)
        ring.push(data)
        total = sink.stop()
        assert total == data.size
        ring.close()

    def test_source_to_sink_pipeline(self, tmp_path, rng):
        """file -> FileSource -> ring -> FileSink -> file copies exactly."""
        src_path = tmp_path / "src.bin"
        dst_path = tmp_path / "dst.bin"
        data = rng.integers(0, 256, size=200_000, dtype=np.uint8)
        data.tofile(src_path)
        ring = RingBuffer(1 << 14)
        sink = FileSink(dst_path, ring)
        with FileSource(src_path, ring) as src:
            import time
            deadline = time.monotonic() + 10.0
            while src.state == FileSource.RUNNING:
                assert time.monotonic() < deadline
                time.sleep(0.001)
        sink.stop()
        assert np.array_equal(np.fromfile(dst_path, dtype=np.uint8), data)
        ring.close()

    def test_bad_path_raises(self):
        ring = RingBuffer(1 << 12)
        with pytest.raises(OSError):
            FileSink("/nonexistent-dir/x.bin", ring)
        ring.close()
