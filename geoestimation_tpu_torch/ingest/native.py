"""ctypes binding to the port's C++ ingest library (libjpeg decode + resize).

The counterpart of `geoestimation_tpu/ingest/native.py`. `cpp/ingest.cpp`
does threaded JPEG decode, bilinear shorter-side resize and center crop into
one preallocated uint8 buffer -- no Python in the per-image loop. It is host
code, not a kernel.

At first use the library is built with the flags of the JAX package's
Makefile (`g++ -O3 -fPIC -std=c++17 -Wall ingest.cpp -shared -pthread
-ljpeg`; `$CXX` names another compiler) into
`build/ingest/libgeoingest-<hash>.so` at the root of the checkout, where the
hash covers the source, the compiler and the flags. The same flags are what
make its pixels bitwise equal to the JAX package's library. Where it cannot
be built (no compiler, no libjpeg headers) `available()` is False and
`build_error()` holds the compiler's message.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ..utils import cxx

SOURCE = Path(__file__).resolve().parent / "cpp" / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ingest"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-pthread", "-ljpeg")

_lock = threading.Lock()
_LIB = None
_TRIED = False
_ERROR = None


def library_path() -> Path:
    """Where the library builds to: keyed on the source, the compiler and
    the flags."""
    return cxx.library_path(SOURCE, BUILD_DIR, "libgeoingest",
                            CXXFLAGS + LDFLAGS)


def build() -> Path:
    """Compile the library unless it is built; raises RuntimeError with the
    compiler's output if the build fails."""
    return cxx.build(SOURCE, BUILD_DIR, "libgeoingest", CXXFLAGS, LDFLAGS,
                     "native ingest")


def _load():
    """The loaded library, built first if need be; None (and `_ERROR` set)
    if it cannot be built or loaded. Tried once per process."""
    global _LIB, _TRIED, _ERROR
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _ERROR = str(e)
            return None
        base_args = [
            ctypes.POINTER(ctypes.c_char_p),   # blobs
            ctypes.POINTER(ctypes.c_size_t),   # blob lengths
            ctypes.c_int,                      # n
            ctypes.c_int,                      # resize_to
            ctypes.c_int,                      # base_size
            ctypes.c_void_p,                   # out uint8 buffer
            ctypes.POINTER(ctypes.c_uint8),    # ok mask
            ctypes.c_int,                      # n_threads
        ]
        lib.geoingest_decode_batch.restype = ctypes.c_int
        lib.geoingest_decode_batch.argtypes = base_args
        lib.geoingest_decode_batch_ex.restype = ctypes.c_int
        lib.geoingest_decode_batch_ex.argtypes = base_args + [
            ctypes.c_int,                      # flags (bit 0: scaled DCT)
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    """True where the library builds and loads."""
    return _load() is not None


def build_error():
    """The compiler's (or the loader's) message if the library could not be
    had, else None."""
    _load()
    return _ERROR


def decode_batch(blobs, resize_to=256, base_size=256, num_threads=0,
                 fast_scale=False):
    """Decode JPEG byte strings with the C++ library.

    fast_scale=True decodes each image at the smallest libjpeg DCT scale
    (M/8) whose shorter side still covers `resize_to` before the exact
    antialiased resize: identical geometry, slightly different pixels.

    Returns (out[N, base, base, 3] uint8, ok[N] bool).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest library unavailable: {_ERROR}")
    n = len(blobs)
    out = np.zeros((n, base_size, base_size, 3), dtype=np.uint8)
    ok = np.zeros(n, dtype=np.uint8)
    arr_blobs = (ctypes.c_char_p * n)(*blobs)
    arr_lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    lib.geoingest_decode_batch_ex(
        arr_blobs, arr_lens, n, resize_to, base_size,
        out.ctypes.data_as(ctypes.c_void_p),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(num_threads), 1 if fast_scale else 0)
    return out, ok.astype(bool)
