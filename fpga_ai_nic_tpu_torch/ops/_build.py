"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded through ``ctypes``.
Builds happen at first use (never at import), into ``_build/`` beside
this package (git-ignored), keyed by a hash of the sources and flags, so a
second process reuses the first one's libraries.  ``build()`` starts one
``nvcc`` per source, all at once.

Numerics flags: no fast math, denormals kept (``-ftz=false``), IEEE
division and square root, and ``-fmad=false`` so the only fused
multiply-adds are the explicit ``__fmaf_rn`` sites that mirror
``optim.golden_fused_apply``.  The tensor-core products (``wgmma``) of
``flash_attn.cu``, ``flash_bwd.cu`` and ``paged_attend.cu`` are not
touched by these flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
HEADERS = ("bfp.cuh", "hopper_mma.cuh", "attn_fwd.cuh", "ring_update.cuh")
SOURCES = ("bfp_codec.cu", "ring_rs.cu", "ring_ag.cu", "paged_attend.cu",
           "flash_attn.cu", "flash_bwd.cu", "flash_generic.cu",
           "int8_codec.cu", "checksum.cu", "ring_hop.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-ftz=false", "-prec-div=true", "-prec-sqrt=true")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((str(Path(home) / "bin" / "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from csrc/ at first use")


def lib_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + (source,):
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source started
    together; raise with the compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: lib_path(s) for s in sources}
    procs = {}
    for src, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    errors = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {src} failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def _load(source: str) -> ctypes.CDLL:
    lib = _LIBS.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build((source,))[source]))
        _LIBS[source] = lib
    return lib


def _error_string(code: int) -> str:
    try:
        rt = torch.cuda.cudart()
        return rt.cudaGetErrorString(rt.cudaError(code))
    except (AttributeError, RuntimeError, TypeError, ValueError):
        return f"cudaError {code}"


class Kernel:
    """One C launch function of a built library, plus its launch count.

    ``launches`` grows by one per launch, here and nowhere else; callers
    zero it to count the launches of one run."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence[type]):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self.launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None

    def _bind(self):
        if self._fn is None:
            fn = getattr(_load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        fn = self._bind()
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: "
                               f"{_error_string(err)}")
        self.launches += 1


def timed_build() -> float:
    """Build every library; return the wall seconds it took."""
    t0 = time.perf_counter()
    build()
    return time.perf_counter() - t0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
