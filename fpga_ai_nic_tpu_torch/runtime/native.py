"""Build and load the port's host C++ libraries, and the host BFP codec
(``csrc/bfp_codec.cpp``) that compresses checkpoints — the port of the JAX
package's ``runtime/native.py``.

A ``csrc/*.cpp`` source is compiled at first use with ``g++ -O3 -std=c++17
-pthread -shared -fPIC`` into ``_build/`` beside the package (git-ignored),
keyed by a hash of the source and the flags, and loaded through
``ctypes``.  The build writes a temporary file and renames it into place,
so processes that build at once do not read each other's half-written
library.  A library that cannot be built raises: no caller falls back to
another implementation in its place (the JAX package's codec falls back to
its numpy golden model; the port's raises).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

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


_codec: Optional[ctypes.CDLL] = None


def lib() -> ctypes.CDLL:
    """The host BFP codec library with its signatures bound (built on
    first use; raises when it cannot be)."""
    global _codec
    if _codec is not None:
        return _codec
    l = load_native("bfp_codec.cpp")
    l.bfp_encode_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int8)]
    l.bfp_decode_f32.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_float)]
    _codec = l
    return _codec


def bfp_encode(x: np.ndarray, block_size: int = 16, mantissa_bits: int = 8,
               rounding: str = "nearest") -> Tuple[np.ndarray, np.ndarray]:
    """``(mant int8 [x.shape], scale int8 [x.size / block_size])``: blocks
    of ``block_size`` consecutive elements of each row."""
    x = np.ascontiguousarray(x, np.float32)
    if x.shape[-1] % block_size != 0:
        raise ValueError(
            f"last dim {x.shape[-1]} not a multiple of block {block_size}")
    n = x.size
    mant = np.empty(n, np.int8)
    scale = np.empty(n // block_size, np.int8)
    lib().bfp_encode_f32(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, block_size,
        mantissa_bits, 0 if rounding == "nearest" else 1,
        mant.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        scale.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return mant.reshape(x.shape), scale


def bfp_decode(mant: np.ndarray, scale: np.ndarray,
               block_size: int = 16) -> np.ndarray:
    """f32 ``[mant.shape]``: ``mant * 2**scale`` block by block."""
    mant = np.ascontiguousarray(mant, np.int8)
    scale = np.ascontiguousarray(scale, np.int8)
    out = np.empty(mant.size, np.float32)
    lib().bfp_decode_f32(
        mant.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        scale.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        mant.size, block_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out.reshape(mant.shape)
