"""The native batch-staging engine (``csrc/staging.cpp``) through ctypes —
the port of the JAX package's ``runtime/staging.py``.

Shuffled-minibatch assembly is a row gather, ``dst[i] = src[idx[i]]``,
that numpy runs on one thread under the GIL.  The engine runs it on a
team of threads inside a worker thread over a pool of reusable page-aligned
buffers, so batch k+1 stages while Python hands batch k on
(``data.epochs_of(native=True)``).  ``wait()`` returns a numpy view of the
slot's buffer, valid until ``release(slot)``.

The library is the port's own copy of the source, built at first use by
``runtime.native.load_native``; it raises when it cannot be built.
``chaos`` (a ``runtime.chaos.FaultPlan``) fires at the ``staging`` site as
in the JAX package: ``submit`` fires (a hang, slowdown, exception or
preemption) and ``wait`` damages the staged batch on a corruption spec
(a copy; the slot's view is returned untouched otherwise).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .native import load_native

_lib: Optional[ctypes.CDLL] = None


def lib() -> ctypes.CDLL:
    """The staging library with its signatures bound (built on first
    use; raises when it cannot be)."""
    global _lib
    if _lib is not None:
        return _lib
    l = load_native("staging.cpp")
    l.stage_create.restype = ctypes.c_void_p
    l.stage_create.argtypes = [ctypes.c_int, ctypes.c_int64]
    l.stage_create_sized.restype = ctypes.c_void_p
    l.stage_create_sized.argtypes = [ctypes.POINTER(ctypes.c_int64),
                                     ctypes.c_int]
    l.stage_destroy.argtypes = [ctypes.c_void_p]
    l.stage_submit.restype = ctypes.c_int
    l.stage_submit.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_int64),
                               ctypes.c_int64, ctypes.c_int64]
    l.stage_wait.restype = ctypes.c_void_p
    l.stage_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
    l.stage_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _lib = l
    return _lib


class Stager:
    """Pool of staging buffers: ``Stager(n_slots, bytes)`` for uniform
    slots or ``Stager.sized([b0, b1, ...])`` for per-slot capacities (a
    submit claims the smallest free slot that fits)."""

    def __init__(self, n_slots: int, slot_bytes: int, chaos=None):
        self._init([slot_bytes] * n_slots, chaos)

    @classmethod
    def sized(cls, slot_bytes_list, chaos=None) -> "Stager":
        self = cls.__new__(cls)
        self._init(list(slot_bytes_list), chaos)
        return self

    def _init(self, sizes, chaos=None):
        self._pool = None
        self.chaos = chaos
        self._l = lib()
        arr = (ctypes.c_int64 * len(sizes))(*sizes)
        self._pool = self._l.stage_create_sized(arr, len(sizes))
        if not self._pool:
            raise MemoryError(f"stage_create_sized({sizes})")
        self.n_slots = len(sizes)
        self._sizes = list(sizes)
        self.slot_bytes = max(sizes)
        self._waited = set()
        # submitted jobs' keepalives: src and idx must outlive the gather
        self._live = {}

    def submit(self, src: np.ndarray, idx: np.ndarray) -> int:
        """Enqueue ``dst[i] = src[idx[i]]`` over axis 0; returns a slot id.

        Raises when no free slot fits the job: slots return to the pool
        only through ``release()``, which only this thread calls, so a
        blocking native wait would deadlock."""
        if self.chaos is not None:
            self.chaos.fire("staging")
        src = np.ascontiguousarray(src)
        idx = np.ascontiguousarray(idx, np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= src.shape[0]):
            # the C++ gather copies unchecked in a worker thread
            raise IndexError(f"index out of range [0, {src.shape[0]})")
        row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:],
                                                     dtype=np.int64))
        need = len(idx) * row_bytes
        free_caps = [c for i, c in enumerate(self._sizes)
                     if i not in self._live]
        if not any(c >= need for c in free_caps) \
                and any(c >= need for c in self._sizes):
            raise RuntimeError(
                f"no FREE slot fits {need} B (free capacities "
                f"{sorted(free_caps)}); release() one before submitting "
                "more (bounded prefetch window)")
        slot = self._l.stage_submit(
            self._pool, src.ctypes.data_as(ctypes.c_void_p),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), row_bytes)
        if slot < 0:
            raise ValueError(
                f"batch ({len(idx)} rows x {row_bytes} B) exceeds slot size "
                f"{self.slot_bytes}")
        self._live[slot] = (src, idx, (len(idx),) + src.shape[1:],
                            src.dtype)
        return slot

    def wait(self, slot: int) -> np.ndarray:
        """Block until the slot's gather is done; a view of the slot's
        buffer (valid until ``release``)."""
        if slot not in self._live:
            # the native wait would block forever on a free slot
            raise KeyError(f"slot {slot} is not outstanding")
        _, _, shape, dtype = self._live[slot]
        ptr = self._l.stage_wait(self._pool, slot)
        self._waited.add(slot)
        n = int(np.prod(shape, dtype=np.int64))
        buf = (ctypes.c_char * (n * dtype.itemsize)).from_address(ptr)
        out = np.frombuffer(buf, dtype=dtype).reshape(shape)
        if self.chaos is not None:
            out = self.chaos.corrupt("staging", out)
        return out

    def release(self, slot: int) -> None:
        """Return a slot to the pool, waiting for its gather first if the
        caller has not (freeing a queued slot would drop the keepalives
        while the worker still reads them)."""
        if slot not in self._live:
            raise KeyError(f"slot {slot} is not outstanding")
        if slot not in self._waited:
            self._l.stage_wait(self._pool, slot)
        self._live.pop(slot, None)
        self._waited.discard(slot)
        self._l.stage_release(self._pool, slot)

    def close(self) -> None:
        if self._pool:
            self._l.stage_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
