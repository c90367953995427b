"""Host-side streaming runtime: ctypes bindings to the native C++ library.

The compute path is JAX/XLA on the device; this module is the native host half of
the pipeline (SURVEY.md §2a "native-code ledger"): a lock-free SPSC ring
buffer, SDR sample-format converters that deinterleave IQ bytes straight
into the (re, im) float planes the device path consumes, and a background
file-reader thread — so Python never loops over samples.

The shared library is built on demand from native/sdsp_io.cpp with the
in-image g++ (no pip, no pybind11 — plain C ABI via ctypes).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
import time
from typing import Optional, Tuple

import numpy as np

__all__ = ["RingBuffer", "FileSource", "FileSink", "iq16_to_planes",
           "iqu8_to_planes", "i16_to_f32", "f32_to_i16", "load_library"]

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
_NATIVE_DIR = _REPO_ROOT / "native"
_SO_PATH = _NATIVE_DIR / "build" / "libsdsp_io.so"

_lib = None
_lib_lock = threading.Lock()


def _build_library() -> None:
    subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                   capture_output=True)


def load_library() -> ctypes.CDLL:
    """Load (building if necessary) the native IO library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not _SO_PATH.exists() or (_SO_PATH.stat().st_mtime <
                                     (_NATIVE_DIR / "sdsp_io.cpp").stat().st_mtime):
            _build_library()
        lib = ctypes.CDLL(str(_SO_PATH))

        lib.sdsp_ring_create.restype = ctypes.c_void_p
        lib.sdsp_ring_create.argtypes = [ctypes.c_size_t]
        lib.sdsp_ring_destroy.argtypes = [ctypes.c_void_p]
        for fn in ("sdsp_ring_capacity", "sdsp_ring_readable",
                   "sdsp_ring_writable"):
            getattr(lib, fn).restype = ctypes.c_size_t
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        for fn in ("sdsp_ring_push", "sdsp_ring_pop"):
            getattr(lib, fn).restype = ctypes.c_size_t
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_size_t]

        lib.sdsp_cvt_iq16_planes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_float]
        lib.sdsp_cvt_iqu8_planes.argtypes = lib.sdsp_cvt_iq16_planes.argtypes
        lib.sdsp_cvt_i16_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_float]
        lib.sdsp_cvt_f32_i16.argtypes = lib.sdsp_cvt_i16_f32.argtypes
        for fn in ("sdsp_cvt_iq16_planes_mt", "sdsp_cvt_iqu8_planes_mt"):
            getattr(lib, fn).argtypes = \
                lib.sdsp_cvt_iq16_planes.argtypes + [ctypes.c_int]
        for fn in ("sdsp_cvt_i16_f32_mt", "sdsp_cvt_f32_i16_mt"):
            getattr(lib, fn).argtypes = \
                lib.sdsp_cvt_i16_f32.argtypes + [ctypes.c_int]

        lib.sdsp_file_source_start.restype = ctypes.c_void_p
        lib.sdsp_file_source_start.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.sdsp_file_source_state.restype = ctypes.c_int
        lib.sdsp_file_source_state.argtypes = [ctypes.c_void_p]
        lib.sdsp_file_source_stop.argtypes = [ctypes.c_void_p]

        lib.sdsp_file_sink_start.restype = ctypes.c_void_p
        lib.sdsp_file_sink_start.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.sdsp_file_sink_state.restype = ctypes.c_int
        lib.sdsp_file_sink_state.argtypes = [ctypes.c_void_p]
        lib.sdsp_file_sink_written.restype = ctypes.c_uint64
        lib.sdsp_file_sink_written.argtypes = [ctypes.c_void_p]
        lib.sdsp_file_sink_stop.restype = ctypes.c_uint64
        lib.sdsp_file_sink_stop.argtypes = [ctypes.c_void_p]

        _lib = lib
        return lib


def _as_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class RingBuffer:
    """Lock-free SPSC byte ring buffer (native).  Capacity rounds up to a
    power of two.  `push`/`pop` are non-blocking and return counts;
    `pop_exact` blocks (with a timeout) until a full block is available —
    the consumer interface a fixed-block-size device pipeline wants."""

    def __init__(self, capacity: int):
        self._lib = load_library()
        self._h = self._lib.sdsp_ring_create(capacity)
        if not self._h:
            raise MemoryError("ring allocation failed")
        self._pending = b""  # partial-dtype remainder from short pops

    def close(self):
        if self._h:
            self._lib.sdsp_ring_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    @property
    def capacity(self) -> int:
        return self._lib.sdsp_ring_capacity(self._h)

    @property
    def readable(self) -> int:
        return self._lib.sdsp_ring_readable(self._h)

    def push(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data)
        return self._lib.sdsp_ring_push(self._h, _as_ptr(data), data.nbytes)

    def pop(self, nbytes: int, dtype=np.uint8) -> np.ndarray:
        """Non-blocking pop of up to `nbytes`.  Returns whole `dtype`
        elements only; a partial element from a short read is retained
        internally and returned by the next pop (no data loss)."""
        itemsize = np.dtype(dtype).itemsize
        out = np.empty(nbytes, dtype=np.uint8)
        got = self._lib.sdsp_ring_pop(self._h, _as_ptr(out), nbytes)
        buf = self._pending + out[:got].tobytes()
        keep = len(buf) - len(buf) % itemsize
        self._pending = buf[keep:]
        return np.frombuffer(buf[:keep], dtype=dtype)

    def pop_exact(self, nbytes: int, dtype=np.uint8, timeout: float = 10.0,
                  poll: float = 0.0005) -> Optional[np.ndarray]:
        """Block until `nbytes` are available (or timeout -> None).

        Any partial-element remainder retained by a previous :meth:`pop` is
        drained into the output first, so mixing pop and pop_exact never
        skips or reorders bytes."""
        out = np.empty(nbytes, dtype=np.uint8)
        filled = min(len(self._pending), nbytes)
        if filled:
            out[:filled] = np.frombuffer(self._pending[:filled],
                                         dtype=np.uint8)
            self._pending = self._pending[filled:]
        deadline = time.monotonic() + timeout
        ptr_base = out.ctypes.data
        while filled < nbytes:
            got = self._lib.sdsp_ring_pop(
                self._h, ctypes.c_void_p(ptr_base + filled), nbytes - filled)
            filled += got
            if filled < nbytes:
                if time.monotonic() > deadline:
                    # Put everything read so far back at the stream head so
                    # a retry (or pop) sees the bytes in order.
                    self._pending = out[:filled].tobytes() + self._pending
                    return None
                if got == 0:
                    time.sleep(poll)
        return out.view(dtype)


class FileSource:
    """Background native thread streaming a file into a RingBuffer."""

    RUNNING, EOF, STOPPED, ERROR = 0, 1, 2, 3

    def __init__(self, path: os.PathLike, ring: RingBuffer,
                 chunk: int = 1 << 16):
        self._lib = load_library()
        self.ring = ring
        self._h = self._lib.sdsp_file_source_start(
            str(path).encode(), ring._h, chunk)
        if not self._h:
            raise FileNotFoundError(path)

    @property
    def state(self) -> int:
        return self._lib.sdsp_file_source_state(self._h)

    def stop(self):
        if self._h:
            self._lib.sdsp_file_source_stop(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class FileSink:
    """Background native thread draining a RingBuffer into a file — the
    output mirror of :class:`FileSource` (e.g. demodulated audio out).
    ``stop()`` drains whatever remains in the ring before closing, so
    "push then stop" never loses bytes; it returns total bytes written."""

    RUNNING, ERROR = 0, 3

    def __init__(self, path: os.PathLike, ring: RingBuffer,
                 chunk: int = 1 << 16):
        self._lib = load_library()
        self.ring = ring
        self._h = self._lib.sdsp_file_sink_start(
            str(path).encode(), ring._h, chunk)
        if not self._h:
            raise OSError(f"cannot open {path} for writing")

    @property
    def state(self) -> int:
        return self._lib.sdsp_file_sink_state(self._h)

    @property
    def written(self) -> int:
        return self._lib.sdsp_file_sink_written(self._h)

    def stop(self) -> int:
        if not self._h:
            return 0
        total = self._lib.sdsp_file_sink_stop(self._h)
        self._h = None
        return total

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def iq16_to_planes(raw: np.ndarray, scale: float = 1.0 / 32768.0, *,
                   threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Interleaved int16 IQ -> (re, im) float32 planes (native, fork-join
    multithreaded for large blocks; ``threads=0`` auto, ``1`` serial)."""
    raw = np.ascontiguousarray(raw, dtype=np.int16)
    npairs = raw.size // 2
    re = np.empty(npairs, dtype=np.float32)
    im = np.empty(npairs, dtype=np.float32)
    load_library().sdsp_cvt_iq16_planes_mt(_as_ptr(raw), _as_ptr(re),
                                           _as_ptr(im), npairs, scale,
                                           threads)
    return re, im


def iqu8_to_planes(raw: np.ndarray, scale: float = 1.0 / 127.5, *,
                   threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Interleaved uint8 IQ (RTL-SDR convention) -> (re, im) f32 planes."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    npairs = raw.size // 2
    re = np.empty(npairs, dtype=np.float32)
    im = np.empty(npairs, dtype=np.float32)
    load_library().sdsp_cvt_iqu8_planes_mt(_as_ptr(raw), _as_ptr(re),
                                           _as_ptr(im), npairs, scale,
                                           threads)
    return re, im


def i16_to_f32(raw: np.ndarray, scale: float = 1.0 / 32768.0, *,
               threads: int = 0) -> np.ndarray:
    raw = np.ascontiguousarray(raw, dtype=np.int16)
    out = np.empty(raw.size, dtype=np.float32)
    load_library().sdsp_cvt_i16_f32_mt(_as_ptr(raw), _as_ptr(out), raw.size,
                                       scale, threads)
    return out


def f32_to_i16(x: np.ndarray, scale: float = 32767.0, *,
               threads: int = 0) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.size, dtype=np.int16)
    load_library().sdsp_cvt_f32_i16_mt(_as_ptr(x), _as_ptr(out), x.size,
                                       scale, threads)
    return out
