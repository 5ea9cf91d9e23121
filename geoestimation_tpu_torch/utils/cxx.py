"""Build a C++ source of the port into a shared library at first use.

The host libraries (`ingest/cpp/ingest.cpp`, `geo/cpp/s2geo.cpp`) are built
with the JAX package's Makefile flags into `build/<name>/` at the root of the
checkout, under a file name hashed on the source, the compiler (`$CXX`, else
g++) and the flags, so an edit of any of them builds anew.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path(source: Path, build_dir: Path, stem: str,
                 flags: tuple) -> Path:
    """Where `source` builds to with `flags`: build_dir/<stem>-<hash>.so."""
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join((compiler(),) + tuple(flags)).encode())
    return build_dir / f"{stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path, build_dir: Path, stem: str, cxxflags: tuple,
          ldflags: tuple, what: str) -> Path:
    """Compile `source` unless it is built; raises RuntimeError ("<what>
    build failed") with the compiler's output if the build fails."""
    lib = library_path(source, build_dir, stem, cxxflags + ldflags)
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [compiler(), *cxxflags, str(source), *ldflags, "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{what} build failed: {e}") from e
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{what} build failed (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib
