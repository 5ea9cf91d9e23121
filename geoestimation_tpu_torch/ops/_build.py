"""Builds the port's CUDA sources with nvcc at first use, loads them with ctypes.

Each `csrc/<name>.cu` becomes `build/torch_kernels/lib<name>-<hash>.so` at the
root of the checkout, where the hash covers the source, every shared header
(`csrc/*.cuh`) and the compiler flags, so an edited source or header builds
anew. The sources have a plain C interface (no
PyTorch headers), which keeps a build to seconds. `build()` starts one nvcc
for each source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def sources() -> list:
    """Names of every CUDA source of the port (`csrc/<name>.cu`)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to: keyed on the source, every
    `csrc/*.cuh` (name and bytes) and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: all) that are not built yet, one
    nvcc each, all started together. Returns {name: ptxas report}; raises
    with the compiler's output if any build fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
        else:
            # atomic: a concurrent build never sees half a file
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if need be."""
    with _lock:
        if name not in _libs:
            lib = library_path(name)
            if not lib.exists():
                build([name])
            _libs[name] = ctypes.CDLL(str(lib))
        return _libs[name]
