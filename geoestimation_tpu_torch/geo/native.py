"""ctypes binding to the port's C++ S2 library (batch cell geometry).

The counterpart of `geoestimation_tpu/geo/native.py`. `cpp/s2geo.cpp` holds
thread-parallel batch versions of `s2.py`'s leaf-id, parent, level and
center functions; `s2.latlng_to_cell_id` dispatches to it for large batches
(`s2._NATIVE_MIN_N`), and both paths give identical ids. It is host code,
not a kernel. `GEOESTIMATION_NO_NATIVE_S2=1` keeps `s2.py` on numpy.

At first use the library is built with the flags of the JAX package's
Makefile (`g++ -O3 -fPIC -std=c++17 -Wall s2geo.cpp -shared -pthread`;
`$CXX` names another compiler) into `build/s2geo/libs2geo-<hash>.so` at the
root of the checkout, where the hash covers the source, the compiler and
the flags. Where it cannot be built (no compiler) `available()` is False
and `build_error()` holds the compiler's message.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ..utils import cxx

SOURCE = Path(__file__).resolve().parent / "cpp" / "s2geo.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "s2geo"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-pthread")

_lock = threading.Lock()
_LIB = None
_TRIED = False
_ERROR = None


def library_path() -> Path:
    """Where the library builds to: keyed on the source, the compiler and
    the flags."""
    return cxx.library_path(SOURCE, BUILD_DIR, "libs2geo",
                            CXXFLAGS + LDFLAGS)


def build() -> Path:
    """Compile the library unless it is built; raises RuntimeError with the
    compiler's output if the build fails."""
    return cxx.build(SOURCE, BUILD_DIR, "libs2geo", CXXFLAGS, LDFLAGS,
                     "native s2")


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
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.s2_latlng_to_cell_id.argtypes = [f64p, f64p, ctypes.c_int64,
                                             u64p, ctypes.c_int]
        lib.s2_parent_at_level.argtypes = [u64p, ctypes.c_int64,
                                           ctypes.c_int, u64p, ctypes.c_int]
        lib.s2_cell_level.argtypes = [u64p, ctypes.c_int64, i32p,
                                      ctypes.c_int]
        lib.s2_cell_id_to_latlng.argtypes = [u64p, ctypes.c_int64, f64p,
                                             f64p, ctypes.c_int]
        for fn in (lib.s2_latlng_to_cell_id, lib.s2_parent_at_level,
                   lib.s2_cell_level, lib.s2_cell_id_to_latlng):
            fn.restype = None
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


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native s2 library unavailable: {_ERROR}")
    return lib


def latlng_to_cell_id(lat, lng, n_threads=0):
    """Degree lat/lng arrays -> level-30 cell ids (uint64)."""
    lib = _lib()
    lat = np.ascontiguousarray(lat, np.float64)
    lng = np.ascontiguousarray(lng, np.float64)
    out = np.empty(lat.shape, np.uint64)
    lib.s2_latlng_to_cell_id(lat.ravel(), lng.ravel(), lat.size,
                             out.ravel(), n_threads)
    return out


def parent_at_level(ids, level, n_threads=0):
    lib = _lib()
    ids = np.ascontiguousarray(ids, np.uint64)
    out = np.empty(ids.shape, np.uint64)
    lib.s2_parent_at_level(ids.ravel(), ids.size, int(level), out.ravel(),
                           n_threads)
    return out


def cell_level(ids, n_threads=0):
    lib = _lib()
    ids = np.ascontiguousarray(ids, np.uint64)
    out = np.empty(ids.shape, np.int32)
    lib.s2_cell_level(ids.ravel(), ids.size, out.ravel(), n_threads)
    return out


def cell_id_to_latlng(ids, n_threads=0):
    lib = _lib()
    ids = np.ascontiguousarray(ids, np.uint64)
    lat = np.empty(ids.shape, np.float64)
    lng = np.empty(ids.shape, np.float64)
    lib.s2_cell_id_to_latlng(ids.ravel(), ids.size, lat.ravel(),
                             lng.ravel(), n_threads)
    return lat, lng
