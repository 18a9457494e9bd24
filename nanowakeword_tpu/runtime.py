"""ctypes bindings for the native audio runtime (native/nww_runtime.cc).

The accelerator computes; this C++ library handles the real-time host plumbing
around it: an SPSC int16 ring buffer for capture threads, 16-bit PCM WAV
decode, and 1280-sample chunk framing with remainder carry. Builds on first
use with the system compiler; every entry point has a pure-numpy fallback so
the framework works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from nanowakeword_tpu.utils.logger import print_info, print_warning

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libnww_runtime.so")
_lib = None
_lib_lock = threading.Lock()


def _build() -> bool:
    src = os.path.join(_NATIVE_DIR, "nww_runtime.cc")
    if not os.path.exists(src):
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o",
             _LIB_PATH, src],
            check=True, capture_output=True, timeout=120)
        return True
    except Exception as e:  # noqa: BLE001
        print_warning(f"native runtime build failed ({e}); using numpy "
                      "fallbacks")
        return False


def load_native() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library, or None."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            if not hasattr(lib, "nww_chunker_feed_f32"):
                # stale library from an older source revision: rebuild
                lib = None
                if not _build():
                    return None
                lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            print_warning(f"native runtime load failed: {e}")
            return None

        lib.nww_ring_create.restype = ctypes.c_void_p
        lib.nww_ring_create.argtypes = [ctypes.c_size_t]
        lib.nww_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.nww_ring_size.restype = ctypes.c_size_t
        lib.nww_ring_size.argtypes = [ctypes.c_void_p]
        lib.nww_ring_capacity.restype = ctypes.c_size_t
        lib.nww_ring_capacity.argtypes = [ctypes.c_void_p]
        lib.nww_ring_push.restype = ctypes.c_size_t
        lib.nww_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_size_t]
        lib.nww_ring_pop.restype = ctypes.c_size_t
        lib.nww_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_size_t]
        lib.nww_wav_decode.restype = ctypes.c_int
        lib.nww_wav_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_int32)]
        lib.nww_chunker_create.restype = ctypes.c_void_p
        lib.nww_chunker_create.argtypes = [ctypes.c_size_t]
        lib.nww_chunker_destroy.argtypes = [ctypes.c_void_p]
        lib.nww_chunker_reset.argtypes = [ctypes.c_void_p]
        lib.nww_chunker_pending.restype = ctypes.c_size_t
        lib.nww_chunker_pending.argtypes = [ctypes.c_void_p]
        lib.nww_chunker_feed.restype = ctypes.c_size_t
        lib.nww_chunker_feed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t]
        lib.nww_chunker_feed_f32.restype = ctypes.c_size_t
        lib.nww_chunker_feed_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t]
        _lib = lib
        print_info("native audio runtime loaded")
        return _lib


class AudioRing:
    """SPSC int16 ring buffer (native when available, deque-free numpy
    fallback otherwise). Capture threads push; the interpreter pops."""

    def __init__(self, capacity: int = 16000 * 10):
        self._lib = load_native()
        if self._lib is not None:
            self._handle = self._lib.nww_ring_create(capacity)
            self._fallback = None
        else:
            self._handle = None
            self._fallback = np.zeros(0, np.int16)
            self._cap = capacity
            self._lock = threading.Lock()

    @property
    def size(self) -> int:
        if self._handle:
            return int(self._lib.nww_ring_size(self._handle))
        return len(self._fallback)

    def push(self, samples: np.ndarray) -> int:
        samples = np.ascontiguousarray(samples, np.int16)
        if self._handle:
            return int(self._lib.nww_ring_push(
                self._handle, samples.ctypes.data, len(samples)))
        with self._lock:
            self._fallback = np.concatenate([self._fallback,
                                             samples])[-self._cap:]
        return len(samples)

    def pop(self, n: int) -> np.ndarray:
        if self._handle:
            out = np.empty(n, np.int16)
            got = int(self._lib.nww_ring_pop(self._handle, out.ctypes.data, n))
            return out[:got]
        with self._lock:
            out = self._fallback[:n].copy()
            self._fallback = self._fallback[len(out):]
        return out

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.nww_ring_destroy(self._handle)
            self._handle = None


def decode_wav_bytes(buf: bytes):
    """16-bit PCM WAV bytes -> (int16 mono samples, sample_rate).
    Native fast path; stdlib `wave` fallback."""
    lib = load_native()
    if lib is not None:
        cap = len(buf) // 2
        out = np.empty(max(cap, 1), np.int16)
        n = ctypes.c_size_t(0)
        rate = ctypes.c_int32(0)
        err = lib.nww_wav_decode(buf, len(buf), out.ctypes.data, cap,
                                 ctypes.byref(n), ctypes.byref(rate))
        if err == 0:
            return out[:n.value].copy(), int(rate.value)
    # fallback
    import io
    import wave
    with wave.open(io.BytesIO(buf), "rb") as f:
        sr = f.getframerate()
        data = np.frombuffer(f.readframes(f.getnframes()), np.int16)
        if f.getnchannels() > 1:
            data = data.reshape(-1, f.getnchannels()).mean(
                axis=1).astype(np.int16)
    return data, sr


class Chunker:
    """1280-sample chunk framing with remainder carry (native when
    available)."""

    def __init__(self, chunk: int = 1280):
        self.chunk = chunk
        self._lib = load_native()
        if self._lib is not None:
            self._handle = self._lib.nww_chunker_create(chunk)
        else:
            self._handle = None
            self._pending = np.zeros(0, np.float32)

    @property
    def pending(self) -> int:
        if self._handle:
            return int(self._lib.nww_chunker_pending(self._handle))
        return len(self._pending)

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """int16 or float32 samples in -> [n_chunks, chunk] float32 out.

        Float inputs take the f32 native path unquantised (AudioFeatures
        streams fractional float32; int16 framing would round them)."""
        samples = np.asarray(samples).reshape(-1)
        as_float = samples.dtype.kind == "f"
        samples = np.ascontiguousarray(
            samples, np.float32 if as_float else np.int16)
        if self._handle:
            max_chunks = (self.pending + len(samples)) // self.chunk
            out = np.empty((max(max_chunks, 1), self.chunk), np.float32)
            feed = (self._lib.nww_chunker_feed_f32 if as_float
                    else self._lib.nww_chunker_feed)
            n = int(feed(self._handle, samples.ctypes.data, len(samples),
                         out.ctypes.data, max_chunks))
            return out[:n]
        self._pending = np.concatenate(
            [self._pending, samples.astype(np.float32)])
        n = len(self._pending) // self.chunk
        out = self._pending[:n * self.chunk].reshape(n, self.chunk)
        self._pending = self._pending[n * self.chunk:]
        return out.copy()

    def reset(self):
        if self._handle:
            self._lib.nww_chunker_reset(self._handle)
        else:
            self._pending = np.zeros(0, np.float32)

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.nww_chunker_destroy(self._handle)
            self._handle = None
