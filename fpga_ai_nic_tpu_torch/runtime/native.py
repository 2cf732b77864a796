"""Build and load the port's host C++ libraries — the port of
``load_native`` from the JAX package's ``runtime/native.py`` (its host BFP
codec for checkpoints is ROADMAP A.8).

A ``csrc/*.cpp`` source is compiled at first use with ``g++ -O3 -std=c++17
-pthread -shared -fPIC`` into ``_build/`` beside the package (git-ignored),
keyed by a hash of the source and the flags, and loaded through
``ctypes``.  The build writes a temporary file and renames it into place,
so processes that build at once do not read each other's half-written
library.  A library that cannot be built raises: no caller falls back to
another implementation in its place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# no -fopenmp: not every host with g++ has libgomp, so the port's sources
# thread with std::thread
CXX_FLAGS = ("-O3", "-std=c++17", "-pthread", "-shared", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def lib_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to: its stem and a hash of the
    source and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((CSRC / source).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def load_native(source: str) -> ctypes.CDLL:
    """The library of ``csrc/<source>``, built on first use; raises
    ``RuntimeError`` (with the compiler's output) when it cannot be
    built or loaded."""
    if source in _LIBS:
        return _LIBS[source]
    path = lib_path(source)
    if not path.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"no C++ compiler (g++) to build {source}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                              str(CSRC / source)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"building {source} failed:\n{res.stderr}")
        os.replace(tmp, path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"loading {path} failed: {e}") from e
    _LIBS[source] = lib
    return lib
