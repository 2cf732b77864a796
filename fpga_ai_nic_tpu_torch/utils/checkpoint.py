"""Audited, crash-consistent, peer-repairable checkpoints — the port of
the JAX package's ``utils/checkpoint.py`` (the last recovery tier).

  manifest     every ``save`` writes per-leaf (and per-shard) exact
               checksums over the stored representation (after the BFP
               compression, if any): the odd-weighted u32 word sums the
               wire plane uses (``ops.integrity``), committed atomically
               with the step's bytes.
  commit       ``save`` is an explicit file-op sequence: every file lands
               in ``step_N.tmp-write`` (leaves, layout sidecar, manifest)
               and one ``os.replace`` publishes the step.  Cut at any op,
               a restore yields exactly the previous verified step or
               exactly the new one; ``op_hook`` is the crash-point seam.
  audit        every restore re-checksums every leaf against the manifest
               before a trainer sees a byte.
  peer repair  with ``mirror=True`` each shard is also stored under its dp
               peer ``(j + 1) % n``; a corrupt primary is fetched from the
               peer (``peer_fetch``: in one process a copy, accounted as
               the JAX package's pair transfer: the shard's bytes),
               verified and healed in place.
  walk-back    ``restore_latest_verified`` falls back past corrupt or torn
               steps to the newest verified one, and refuses
               (``CheckpointIntegrityError``) when none is clean.

The stored layout is the JAX package's, so each package restores the
other's steps and their manifests' checksums are equal: a trainer state
stores its flat masters as the global vector (the port's ``[n, C]`` rows
concatenated in rank order, JAX's ``P(ax)``), each optimizer moment the
same way, ``step`` as a 0-d int32, and drops the working params, the
replicas, the side rows and the error-feedback residual (every
``restore_state`` rebuilds or re-zeros them); a ``DDPState`` stores rank
0's row of its replicated masters, after checking that the rows are equal.
Dict keys are stored sorted (JAX's pytree order).  bfloat16 leaves are
stored as JAX stores them, without ``ml_dtypes``: 2-byte words with npy
descr ``'<V2'`` and ``"bfloat16"`` in the manifest; a restore hands them
back as ``torch.bfloat16`` tensors.  (The JAX package's own restore refuses
such a leaf: ``np.load`` reads ``'<V2'`` back as ``|V2``, which its audit
takes for a dtype drift.)

``compress_array`` / ``decompress_array``: BFP compression of the f32
master and optimizer leaves through the host codec (``runtime.native``,
``csrc/bfp_codec.cpp``): about 1.06 bytes an element instead of 4, at a
bounded error.  The codec raises when it cannot be built.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import time

import numpy as np
import torch

from ..runtime import native
from .config import BFPConfig

__all__ = [
    "Checkpointer", "CheckpointIntegrityError", "AuditReport", "FileOp",
    "compress_array", "decompress_array", "bytes_checksum", "peer_fetch",
    "MANIFEST_FILE", "RESTORE_SURFACES",
    "npy_data_offset", "flip_stored_bit",
]

MANIFEST_FILE = "manifest.json"
_FORMAT = 2
_ALGO = "odd-weighted-u32-word-sum/v1"
# arrays below this size are never shard-split (the split exists for
# per-shard peer repair of the big flat masters, not for scalars)
_MIN_SHARD_BYTES = 512

# Every restore entry point: each audits before it hands bytes back.
RESTORE_SURFACES = (
    "Checkpointer.restore",
    "Checkpointer.restore_latest_verified",
    "ElasticTrainer._restore",
)


class CheckpointIntegrityError(RuntimeError):
    """A stored checkpoint failed its bit-exact audit and could not be
    repaired from a peer copy — restoring it would silently train on
    corrupted masters, so the restore path REFUSES instead (the caller
    walks back to the previous verified step, or surfaces the loss)."""


def compress_array(x: np.ndarray, cfg: BFPConfig) -> Dict[str, Any]:
    """BFP compression of an f32 array: int8 mantissas and scales, the
    shape, the tail padding, the block and the dtype (JAX's blob)."""
    enc = native.bfp_encode
    flat = np.ascontiguousarray(x, np.float32).reshape(-1)
    pad = (-flat.shape[0]) % cfg.block_size
    if pad:
        flat = np.pad(flat, (0, pad))
    mant, scale = enc(flat, cfg.block_size, cfg.mantissa_bits, cfg.rounding)
    return {"mant": mant, "scale": scale, "shape": np.asarray(x.shape),
            "pad": np.asarray(pad), "block": np.asarray(cfg.block_size),
            "dtype": str(x.dtype)}


def decompress_array(blob: Dict[str, Any]) -> np.ndarray:
    dec = native.bfp_decode
    mant = np.asarray(blob["mant"], np.int8)
    out = dec(mant, np.asarray(blob["scale"], np.int8), int(blob["block"]))
    pad = int(blob["pad"])
    if pad:
        out = out[:-pad]
    return out.reshape(tuple(int(d) for d in np.asarray(blob["shape"]))).astype(
        blob["dtype"] if isinstance(blob["dtype"], str) else str(blob["dtype"]))


# ---------------------------------------------------------------------------
# checksums over the STORED representation
# ---------------------------------------------------------------------------

# weighted-sum chunk: 4 Mi words (16 MiB of payload) bounds the
# temporaries to tens of MB regardless of leaf size
_CHK_CHUNK_WORDS = 1 << 22


def _u32_words_checksum(words: np.ndarray) -> int:
    """Odd-weighted wraparound u32 word sum over a u32 vector, chunked
    so GB-scale leaves never allocate GB-scale temporaries.  Bit-equal
    to `compress.golden.golden_word_checksum` on the same words (pinned
    by test): the products and the sum wrap mod 2^32 in u32 arithmetic,
    which is all the checksum keeps, and chunking only regroups an
    associative modular sum."""
    acc = 0
    for k in range(0, words.size, _CHK_CHUNK_WORDS):
        w = words[k:k + _CHK_CHUNK_WORDS]
        weights = np.arange(w.size, dtype=np.uint32)
        weights <<= np.uint32(1)
        weights += np.uint32((2 * k + 1) & 0xFFFFFFFF)
        weights *= w
        acc += int(np.sum(weights, dtype=np.uint32))
    return acc & 0xFFFFFFFF


def _u8_checksum(a: np.ndarray) -> int:
    """Checksum of a flat u8 view: bytes pack 4-per-u32-word
    (little-endian, zero-padded tail) — the SAME u32 word decomposition
    the wire plane's checksums ride (`ops.integrity.words_u32` bitcasts
    4-byte payloads word-for-word), at 1/4 the word count of per-byte
    widening."""
    pad = (-a.size) % 4
    if pad:
        a = np.concatenate([a, np.zeros(pad, np.uint8)])
    return _u32_words_checksum(a.view("<u4"))


def bytes_checksum(buf: bytes) -> int:
    """The manifest checksum: the wire plane's odd-weighted wraparound
    u32 word sum (`ops.integrity` / `compress.golden`) over a raw byte
    stream packed little-endian 4 bytes per u32 word (zero-padded tail)
    — dtype-agnostic, so ONE spec covers f32 masters, int8 BFP mantissa
    tiles and the manifest's own canonical JSON; equal by construction
    to ``golden_word_checksum`` over the u32 word view (pinned by
    test).  Exact integer arithmetic, no tolerance band; odd weights
    are invertible mod 2^32, so any single corrupted byte changes its
    word and hence the sum."""
    return _u8_checksum(np.frombuffer(buf, np.uint8))


def npy_data_offset(header: bytes) -> int:
    """Data-region offset of a v1 ``.npy`` file (u16 header length at
    bytes 8..9, data at 10+hlen) — THE single definition shared by the
    chaos/lint/bench/test tooling that flips stored bits; a future
    stored-format change lands here once."""
    return 10 + int.from_bytes(header[8:10], "little")


def flip_stored_bit(path: str, byte_off: int = 0, bit: int = 0) -> int:
    """Flip one DATA-region bit of a stored npy file in place (the
    damage-at-rest primitive the durability batteries inject); returns
    the absolute file offset flipped."""
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    off = min(npy_data_offset(buf) + byte_off, len(buf) - 1)
    buf[off] ^= (1 << bit)
    with open(path, "wb") as f:
        f.write(buf)
    return off


def _c_contig(arr: np.ndarray) -> np.ndarray:
    """C-contiguous view/copy that PRESERVES ndim (np.ascontiguousarray
    silently promotes 0-d scalars to shape (1,), which would corrupt the
    stored shape of e.g. the step counter)."""
    return np.ascontiguousarray(arr).reshape(arr.shape)


# bfloat16 as stored: 2-byte words (numpy has no bfloat16)
_BF16 = np.dtype("V2")


def _dtype_str(arr: np.ndarray) -> str:
    """The manifest's dtype of a stored array (JAX's ``str(arr.dtype)``,
    "bfloat16" for 2-byte words)."""
    return "bfloat16" if arr.dtype == _BF16 else str(arr.dtype)


def _save_npy(f, arr: np.ndarray) -> None:
    """``np.save``, with bfloat16 words under JAX's descr ``'<V2'``."""
    arr = _c_contig(arr)
    if arr.dtype != _BF16:
        np.save(f, arr)
        return
    np.lib.format.write_array_header_1_0(
        f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
    f.write(arr.tobytes())


def _to_host(tree: Any) -> Any:
    """A tree's host snapshot in the JAX package's form: dict keys sorted,
    tensors copied to numpy (bfloat16 as 2-byte words), other leaves
    through ``np.asarray``."""
    if isinstance(tree, dict):
        return {k: _to_host(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_to_host(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_to_host(v) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16)
        return t.numpy()
    return np.asarray(tree)


def _from_stored(tree: Any) -> Any:
    """A restored tree with its bfloat16 words as ``torch.bfloat16``."""
    if isinstance(tree, dict):
        return {k: _from_stored(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_from_stored(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_from_stored(v) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype == _BF16:
        return torch.from_numpy(
            np.ascontiguousarray(tree).view(np.int16).copy()).view(
                torch.bfloat16)
    return tree


def _stored_state(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A trainer state (as a dict of its fields) in the JAX package's
    stored layout: masters and moments as global vectors, ``step`` as a
    0-d int32, the working copies and the error-feedback residual
    dropped."""
    out = {k: v for k, v in tree.items()
           if k not in ("params", "replicas", "side", "codec_state")}
    opt = dict(out.get("opt_state") or {})
    if "w_master" in out:
        # DDPState: every rank's replicated [n, L] master; JAX stores one
        w = out["w_master"]
        if isinstance(w, torch.Tensor) and w.dim() == 2:
            for name, t in [("w_master", w)] + sorted(opt.items()):
                if not bool((t == t[0]).all()):
                    raise ValueError(
                        f"cannot checkpoint a DDP state whose ranks' "
                        f"{name} rows differ: the replicas diverged")
            out["w_master"] = w[0]
            opt = {k: v[0] for k, v in opt.items()}
    if "w_own" in out:
        w = out["w_own"]
        if isinstance(w, torch.Tensor) and w.dim() == 2:
            # [n, C] rank rows -> the global [n C] vector, rank order
            out["w_own"] = w.reshape(-1)
            opt = {k: v.reshape(-1) for k, v in opt.items()}
    if "opt_state" in out:
        out["opt_state"] = opt
    if isinstance(out.get("step"), (int, np.integer)) or (
            isinstance(out.get("step"), torch.Tensor)):
        out["step"] = np.int32(int(out["step"]))
    return out


def _array_checksum(arr: np.ndarray) -> int:
    # u8 view, not tobytes(): no full-buffer copy per checksum
    return _u8_checksum(_c_contig(arr).reshape(-1).view(np.uint8))


def _canonical_json(obj: Any) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


# ---------------------------------------------------------------------------
# the peer repair's fetch
# ---------------------------------------------------------------------------

def peer_fetch(arr: np.ndarray) -> Tuple[np.ndarray, int]:
    """Land a peer-held mirror shard on its owner: ``(landed, wire_bytes)``,
    the landed bytes bit for bit.  The port keeps every virtual rank in one
    process, so the fetch is a copy; ``wire_bytes`` is what the JAX
    package's single-pair transfer moves, exactly the shard's bytes."""
    arr = _c_contig(arr)
    return np.array(arr, copy=True), int(arr.nbytes)


# ---------------------------------------------------------------------------
# the save file-op stream
# ---------------------------------------------------------------------------

class FileOp(NamedTuple):
    """One filesystem action of a save/GC sequence.  ``save`` is planned
    as a list of these and executed in order — the opstream emitter
    discipline applied to the filesystem, so the crash-point sweep can
    truncate the sequence at every prefix and assert the commit protocol
    (tests/test_torch_checkpoint.py).  Kinds:

      mkdir      create ``path`` (parents ok)
      write_npy  write ``data`` (np.ndarray) to ``path``
      write_json write ``data`` (json-able) to ``path``
      replace    atomic ``os.replace(path, data)`` — THE commit op
      remove     unlink ``path`` (missing ok)
      rmtree     remove the tree at ``path`` (missing ok)
      rmdir      remove the (now empty) dir at ``path`` (missing ok)
      gc_guard   read-back audit of the just-committed step (``data`` =
                 step): retention deletions only run if the NEW step
                 verifies on disk — a lying write can never leave the
                 directory with zero restorable steps
    """

    kind: str
    path: str
    data: Any = None


def _apply_op(op: FileOp) -> None:
    if op.kind == "mkdir":
        os.makedirs(op.path, exist_ok=True)
    elif op.kind == "write_npy":
        with open(op.path, "wb") as f:
            _save_npy(f, op.data)
    elif op.kind == "write_json":
        with open(op.path, "w") as f:
            json.dump(op.data, f)
    elif op.kind == "replace":
        os.replace(op.path, op.data)
    elif op.kind == "remove":
        try:
            os.remove(op.path)
        except FileNotFoundError:
            pass
    elif op.kind == "rmtree":
        shutil.rmtree(op.path, ignore_errors=True)
    elif op.kind == "rmdir":
        try:
            os.rmdir(op.path)
        except OSError:
            pass
    else:  # pragma: no cover - planner bug
        raise ValueError(f"unknown file op kind {op.kind!r}")


# ---------------------------------------------------------------------------
# audit report
# ---------------------------------------------------------------------------

@dataclass
class AuditReport:
    """Verdict of one step's bit-exact audit against its manifest."""

    step: int
    ok: bool = True                    # every primary byte matched
    restorable: bool = False           # clean, or every failure repaired
    failures: List[Dict[str, Any]] = field(default_factory=list)
    repaired: List[Dict[str, Any]] = field(default_factory=list)
    repair_wire_bytes: int = 0
    emergency: bool = False
    # the assembled (still-compressed) tree when restorable — restore
    # reuses it so audited bytes are the restored bytes, read once
    tree: Optional[Any] = None

    def describe(self) -> str:
        probs = "; ".join(
            f"{'/'.join(map(str, f['path']))}"
            + (f"[shard {f['shard']}]" if f.get("shard") is not None else "")
            + f": {f['reason']}" for f in self.failures) or "clean"
        return (f"step {self.step}: ok={self.ok} "
                f"restorable={self.restorable} repaired={len(self.repaired)}"
                f" ({probs})")


# ---------------------------------------------------------------------------
# tree <-> template flattening
# ---------------------------------------------------------------------------

def _template(tree: Any, leaves: List[Tuple[Tuple[Any, ...], np.ndarray]],
              path: Tuple[Any, ...] = ()) -> Any:
    """JSON template of ``tree`` with array leaves replaced by
    ``{"__leaf__": i}`` refs (appended to ``leaves``); container shape
    (dict/list/tuple) and inline scalars survive verbatim."""
    if isinstance(tree, dict):
        clash = {"__leaf__", "__tuple__", "__str__"} & set(map(str, tree))
        if clash:
            # the template's sentinel names: a user payload carrying one
            # would rebuild as the WRONG data (e.g. {'__leaf__': 0}
            # resolves to leaf 0's array) — a silent misrestore the
            # audited store must refuse at save time
            raise TypeError(
                f"cannot checkpoint dict at {path}: key(s) {sorted(clash)} "
                "collide with the manifest template's reserved names")
        return {str(k): _template(v, leaves, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        body = [_template(v, leaves, path + (i,))
                for i, v in enumerate(tree)]
        return {"__tuple__": body} if isinstance(tree, tuple) else body
    if isinstance(tree, (np.ndarray, np.generic)):
        arr = np.asarray(tree)
        if arr.dtype.kind in "USO":
            if arr.ndim == 0:
                return {"__str__": str(arr.item())}
            raise TypeError(f"cannot checkpoint non-numeric array at "
                            f"{path} (dtype {arr.dtype})")
        leaves.append((path, arr))
        return {"__leaf__": len(leaves) - 1}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot checkpoint leaf of type {type(tree).__name__} "
                    f"at {path}")


def _rebuild(template: Any, arrays: List[np.ndarray]) -> Any:
    if isinstance(template, dict):
        if "__leaf__" in template:
            return arrays[template["__leaf__"]]
        if "__str__" in template:
            return template["__str__"]
        if "__tuple__" in template:
            return tuple(_rebuild(v, arrays) for v in template["__tuple__"])
        return {k: _rebuild(v, arrays) for k, v in template.items()}
    if isinstance(template, list):
        return [_rebuild(v, arrays) for v in template]
    return template


class Checkpointer:
    """Audited, crash-consistent checkpoint manager with optional BFP-
    compressed optimizer/master state, per-shard peer mirrors, bounded
    retention and chaos hooks (the module docstring has the protocol).

    ``save`` finishes the device-to-host copy before it returns, so the
    trainer may step on at once (its steps make new tensors and update
    nothing in place).  ``async_save=True`` writes in a background
    thread: ``save`` returns once the host copy is taken — the
    BFP encode of the master/optimizer shards AND all file IO run in
    the background thread, so for GB-scale compressed state the caller
    stalls only for the device pull.  Call ``wait_until_finished()`` (or
    just the next ``save``, which waits on the previous one) before
    reading the files; background errors re-raise at the next sync
    point.

    ``shards=n`` splits big first-dim-divisible stored arrays (the flat
    ZeRO-1 masters/moments) into n per-device shard files; with
    ``mirror=True`` every shard (and every unsharded array) is ALSO
    stored under its dp peer, which is what makes a corrupt primary
    repairable (``peer_fetch``).  ``keep_last=N`` arms retention GC that
    never deletes the newest *verified* step.  ``chaos`` (a
    ``runtime.chaos.FaultPlan``) arms the durability fault sites
    ``ckpt.save`` / ``ckpt.restore``.  ``last_save`` holds the last
    save's seconds: ``pull_s`` (device to host), ``encode_s`` (the BFP
    compression), ``checksum_s`` (planning, the checksums of every leaf
    and shard) and ``write_s`` (the op stream: files, the commit, the
    retention GC with its read-back audit)."""

    _LAYOUT_FILE = "layer_layout.json"

    def __init__(self, directory: str,
                 compress: Optional[BFPConfig] = None,
                 async_save: bool = False, *,
                 shards: Optional[int] = None,
                 mirror: bool = False,
                 keep_last: Optional[int] = None,
                 chaos: Any = None,
                 recovery: Any = None,
                 events: Any = None) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.compress = compress
        self._async = async_save
        self.shards = shards
        self.mirror = mirror
        self.keep_last = keep_last
        self.chaos = chaos
        self.recovery = recovery      # observability.RecoveryStats or None
        self.events = events          # obs EventStream or None
        # crash-point sweep seam: called (op_index, FileOp) BEFORE each
        # op of a save/GC sequence executes; an exception it raises
        # leaves exactly the prefix applied (the simulated crash)
        self.op_hook: Optional[Callable[[int, FileOp], None]] = None
        self._bg: Optional[threading.Thread] = None
        self._bg_exc: Optional[BaseException] = None
        self.last_save: Dict[str, float] = {}
        self._stats_lock = threading.Lock()   # orders last_save's writers
        self._recover_leftovers()

    # -- paths --------------------------------------------------------------

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def _tmp_path(self, step: int) -> str:
        return self._path(step) + ".tmp-write"

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self._path(step), MANIFEST_FILE)

    def _layout_path(self, step: int) -> str:
        # INSIDE the step directory: the sidecar describes that step's
        # bytes and travels (and dies) with them — and under the v2
        # commit protocol it is written into the tmp dir BEFORE the
        # publishing rename, so step bytes and sidecar commit in ONE
        # atomic op (no crash window can strand a sidecar for a step
        # that never appeared, or publish a step missing its sidecar).
        return os.path.join(self._path(step), self._LAYOUT_FILE)

    def _legacy_layout_path(self) -> str:
        # directory-scoped sidecar location used by older revisions; read
        # as a fallback and migrated into the step dirs on the next save
        return os.path.join(self.directory, self._LAYOUT_FILE)

    def _all_steps(self) -> List[int]:
        steps = []
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", d)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _recover_leftovers(self) -> None:
        """Journal recovery for the same-step re-save window.  A crash
        between 'old dir steps aside' and 'tmp commits' leaves
        ``step_N.replaced`` (the old, fully verified copy) with no
        ``step_N`` — if that step was the directory's ONLY one, restore
        would otherwise refuse despite an intact copy on disk.  Roll
        the old copy back (one atomic rename); when the commit DID land
        the leftover trash is simply removed.  Uncommitted
        ``.tmp-write`` dirs are garbage by definition (their commit
        never happened — adopting one would resurrect a save the
        caller was told failed) and are cleaned here too.  Runs at
        construction (the restarting process) and at every sync point;
        never while a background save is in flight (callers join
        first)."""
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)\.replaced", d)
            if not m:
                continue
            trash = os.path.join(self.directory, d)
            committed = self._path(int(m.group(1)))
            if os.path.isdir(committed):
                shutil.rmtree(trash, ignore_errors=True)
            else:
                os.replace(trash, committed)   # roll the old step back
        for d in os.listdir(self.directory):
            if re.fullmatch(r"step_(\d+)\.tmp-write", d):
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)

    # -- legacy sidecar migration (unchanged semantics) ---------------------

    def _migrate_legacy_layout(self) -> None:
        """Copy a directory-scoped sidecar (older revisions wrote one per
        DIRECTORY) into every existing step dir that lacks its own, then
        remove it — after which the per-step rules apply uniformly and a
        plain-order save can no longer strand older steps layout-less."""
        legacy = self._legacy_layout_path()
        if not os.path.exists(legacy):
            return
        with open(legacy) as f:
            layout = json.load(f)
        for s in self._all_steps():
            p = self._layout_path(s)
            if not os.path.exists(p):
                with open(p, "w") as f:
                    json.dump(layout, f)
        os.remove(legacy)

    def _apply_sidecar(self, step: int,
                       layout: Optional[Dict[str, Any]]) -> None:
        """Write (or, for ``None``, remove) step's sidecar on disk."""
        if layout is not None:
            os.makedirs(self._path(step), exist_ok=True)
            with open(self._layout_path(step), "w") as f:
                json.dump(layout, f)
        else:
            try:
                os.remove(self._layout_path(step))
            except FileNotFoundError:
                pass

    # -- async-save sidecar staging -----------------------------------------
    # The sidecar commits atomically INSIDE the step rename, but an async
    # save only materializes the step dir when the background write
    # commits.  So save() stages the layout in a DURABLE pending file
    # next to the step dir — not in memory — and any sync point moves it
    # in.  A crash between commit and flush leaves checkpoint + pending
    # file on disk, and saved_layout()/restore() honor the pending file,
    # so the layout is never silently lost (the silent-permute hazard the
    # sidecar exists to prevent).

    def _pending_path(self, step: int) -> str:
        return os.path.join(self.directory,
                            f"step_{step:08d}.layout-pending.json")

    def _stage_sidecar(self, step: int,
                       layout: Optional[Dict[str, Any]]) -> None:
        tmp = self._pending_path(step) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"layout": layout}, f)
        os.replace(tmp, self._pending_path(step))

    def _read_pending(self, step: int) -> Optional[Dict[str, Any]]:
        """The staged {'layout': ...} dict, or None if nothing is staged."""
        try:
            with open(self._pending_path(step)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def _flush_pending_sidecars(self, skip_step: Optional[int] = None
                                ) -> None:
        """Move staged sidecars into their (now committed) step dirs."""
        for fname in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)\.layout-pending\.json", fname)
            if not m:
                continue
            step = int(m.group(1))
            if step == skip_step or not os.path.isdir(self._path(step)):
                continue                 # not committed yet: stays staged
            pending = self._read_pending(step)
            if pending is not None:
                self._apply_sidecar(step, pending["layout"])
            os.remove(self._pending_path(step))

    def save_layout(self, layout: Dict[str, Any],
                    step: int) -> Dict[str, Any]:
        """Record how step ``step``'s flat master bytes are ordered (e.g.
        the interleaved-1F1B layer permutation: layers_order / pp /
        virtual_stages).  A checkpoint that carries a layout sidecar can
        only be restored by a caller that declares a MATCHING layout —
        ``restore`` enforces it — so bytes can never be silently
        reinterpreted under a different pp/v/schedule.  (Standalone use:
        waits out any in-flight async save first; ``save(layout=...)``
        defers instead and never blocks.)"""
        self.wait_until_finished()
        self._apply_sidecar(step, layout)
        return layout

    def saved_layout(self, step: Optional[int] = None
                     ) -> Optional[Dict[str, Any]]:
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        pending = self._read_pending(step)     # async save not yet flushed
        if pending is not None:
            return pending["layout"]
        if os.path.exists(self._layout_path(step)):
            with open(self._layout_path(step)) as f:
                return json.load(f)
        # pre-migration checkpoint: a directory-scoped sidecar governs
        # every step that has no per-step sidecar of its own
        legacy = self._legacy_layout_path()
        if os.path.isdir(self._path(step)) and os.path.exists(legacy):
            with open(legacy) as f:
                return json.load(f)
        return None

    def _check_layout(self, step: int,
                      expect: Optional[Dict[str, Any]]) -> None:
        saved = self.saved_layout(step)
        if saved is None and expect is None:
            return
        if saved is None:
            raise ValueError(
                f"restore declared layout {expect} but the checkpoint at "
                f"{self._path(step)} has no {self._LAYOUT_FILE} sidecar — "
                "it was saved in plain model order; drop expect_layout or "
                "re-save with save_layout()")
        if expect is None:
            raise ValueError(
                f"checkpoint at {self._path(step)} carries a layout "
                f"sidecar {saved} (its flat masters are NOT in model "
                "order); pass expect_layout= with the run's matching "
                "pp/virtual_stages/schedule to restore()")
        mismatched = {k: (saved.get(k), expect.get(k))
                      for k in set(saved) | set(expect)
                      if saved.get(k) != expect.get(k)}
        if mismatched:
            raise ValueError(
                "checkpoint layout mismatch (saved vs requested): "
                f"{mismatched} — restoring these bytes under the requested "
                "pp/virtual_stages/schedule would silently permute layers")

    # -- save ---------------------------------------------------------------

    def _host_tree(self, state: Any) -> Any:
        """The masters-only host snapshot of a trainer state (a NamedTuple
        carrying ``w_own`` or ``w_master``: ``_stored_state``), or a plain
        tree saved verbatim (user payloads whose keys merely resemble a
        trainer state's are never reduced).  The device-to-host copy is
        finished when this returns."""
        is_trainer_state = hasattr(state, "_asdict")
        tree = dict(state._asdict()) if is_trainer_state else state
        if is_trainer_state and ("w_own" in tree or "w_master" in tree):
            tree = _stored_state(tree)
        return _to_host(tree)

    def _shard_plan(self, arr: np.ndarray, shards: Optional[int]) -> int:
        """How many shard files this stored array splits into (1 = whole
        file).  Split iff a dp width is declared, the first dim divides
        by it, and the array is big enough for per-shard repair to mean
        anything — the flat padded ZeRO-1 masters/moments by
        construction, never the step scalar."""
        n = shards or 1
        if (n > 1 and arr.ndim >= 1 and arr.shape[0] % n == 0
                and arr.nbytes >= _MIN_SHARD_BYTES):
            return n
        return 1

    def _plan_write_ops(self, step: int, tree: Any,
                        layout: Optional[Dict[str, Any]],
                        emergency: bool, shards: Optional[int]
                        ) -> List[FileOp]:
        """The save as an explicit file-op sequence.  Protocol: all
        files — leaf/shard/mirror npys, the layout sidecar, the manifest
        — land in ``step_N.tmp-write``; ONE ``os.replace`` publishes the
        step; post-commit ops (pending-sidecar flush, same-step-replace
        trash removal, retention GC) follow.  Any prefix leaves either
        the previous verified state or the fully committed new step."""
        path, tmp = self._path(step), self._tmp_path(step)
        leaves: List[Tuple[Tuple[Any, ...], np.ndarray]] = []
        template = _template(tree, leaves)
        ops: List[FileOp] = [FileOp("rmtree", tmp), FileOp("mkdir", tmp)]
        manifest_leaves: List[Dict[str, Any]] = []
        for i, (lpath, arr) in enumerate(leaves):
            arr = _c_contig(arr)
            name = f"leaf_{i:05d}"
            n_shards = self._shard_plan(arr, shards)
            entry: Dict[str, Any] = {
                "path": list(lpath), "name": name,
                "dtype": _dtype_str(arr), "shape": list(arr.shape),
                "nbytes": int(arr.nbytes),
                "checksum": _array_checksum(arr),
            }
            if n_shards > 1:
                rows = arr.shape[0] // n_shards
                shard_entries = []
                for j in range(n_shards):
                    piece = arr[j * rows:(j + 1) * rows]
                    fname = f"{name}.s{j:02d}.npy"
                    ops.append(FileOp("write_npy",
                                      os.path.join(tmp, fname), piece))
                    srec = {"file": fname, "owner": j,
                            "checksum": _array_checksum(piece),
                            "nbytes": int(piece.nbytes)}
                    if self.mirror:
                        mname = f"{name}.s{j:02d}.m.npy"
                        ops.append(FileOp("write_npy",
                                          os.path.join(tmp, mname), piece))
                        srec["mirror"] = mname
                        srec["mirror_owner"] = (j + 1) % n_shards
                    shard_entries.append(srec)
                entry["shards"] = shard_entries
            else:
                fname = f"{name}.npy"
                ops.append(FileOp("write_npy",
                                  os.path.join(tmp, fname), arr))
                entry["file"] = fname
                if self.mirror:
                    mname = f"{name}.m.npy"
                    ops.append(FileOp("write_npy",
                                      os.path.join(tmp, mname), arr))
                    entry["mirror"] = mname
            manifest_leaves.append(entry)
        if layout is not None:
            ops.append(FileOp("write_json",
                              os.path.join(tmp, self._LAYOUT_FILE), layout))
        body = {
            "format": _FORMAT, "algo": _ALGO, "step": int(step),
            "emergency": bool(emergency),
            "compress": (None if self.compress is None else
                         {"block_size": self.compress.block_size,
                          "mantissa_bits": self.compress.mantissa_bits}),
            "shards": shards, "mirror": bool(self.mirror),
            "tree": template, "leaves": manifest_leaves,
        }
        body["self_checksum"] = bytes_checksum(
            _canonical_json(dict(body, self_checksum=0)))
        ops.append(FileOp("write_json",
                          os.path.join(tmp, MANIFEST_FILE), body))
        # -- the commit -----------------------------------------------------
        trash = None
        if os.path.isdir(path):
            # same-step re-save: the old dir steps aside first (os.replace
            # cannot atomically replace a non-empty dir).  A crash in the
            # window between the two renames leaves step_N.replaced with
            # no step_N; _recover_leftovers rolls the old verified copy
            # back at the next construction/sync point, so the step is
            # never lost — and never a mixed old/new dir (the trash name
            # never matches step_\d+).
            trash = path + ".replaced"
            ops.append(FileOp("rmtree", trash))
            ops.append(FileOp("replace", path, trash))
        ops.append(FileOp("replace", tmp, path))
        if trash is not None:
            ops.append(FileOp("rmtree", trash))
        if self._async:
            # this save's own staged sidecar is committed by the rename:
            # retire the pending file
            ops.append(FileOp("remove", self._pending_path(step)))
        ops.extend(self._plan_gc_ops(new_step=step))
        return ops

    def _plan_gc_ops(self, new_step: Optional[int]) -> List[FileOp]:
        """Retention ops: delete steps beyond ``keep_last``, NEVER the
        newest verified step.  On the save path the deletions sit
        behind a ``gc_guard`` op — a read-back audit of the freshly
        committed step, so a write the disk lied about can never cost
        the directory its only restorable step; a standalone ``gc()``
        (no new step) protects the newest step that audits restorable
        instead.  Victim manifests are removed FIRST, so a crash mid-GC
        leaves the half-deleted step definitively torn (unverified)
        instead of plausibly restorable."""
        if not self.keep_last:
            return []
        existing = self._all_steps()
        all_steps = sorted(set(existing) |
                           ({new_step} if new_step is not None else set()),
                           reverse=True)
        keep = set(all_steps[:self.keep_last])
        victims = [s for s in existing if s not in keep]
        if not victims:
            return []
        ops: List[FileOp] = []
        if new_step is not None:
            ops.append(FileOp("gc_guard", self._path(new_step), new_step))
        else:
            # no fresh write to verify: the newest step that audits
            # restorable survives even outside the window (the kept
            # window steps may themselves be corrupt — the walk must
            # not stop at them)
            for s in sorted(existing, reverse=True):
                if self.audit_step(s, repair="probe").restorable:
                    keep.add(s)
                    break
            victims = [s for s in existing if s not in keep]
            if not victims:
                return []
        for s in sorted(existing, reverse=True):
            if s in keep:
                continue
            d = self._path(s)
            ops.append(FileOp("remove", os.path.join(d, MANIFEST_FILE)))
            for fname in sorted(os.listdir(d)):
                if fname != MANIFEST_FILE:
                    ops.append(FileOp("remove", os.path.join(d, fname)))
            ops.append(FileOp("remove", self._pending_path(s)))
            ops.append(FileOp("rmdir", d))
        return ops

    def _exec_ops(self, ops: List[FileOp],
                  interruptible: bool = True) -> None:
        """Run a planned op sequence with the chaos + sweep seams: the
        op_hook fires before each op; an armed FaultPlan's
        kill/diskfull specs at ``ckpt.save`` interrupt at their planned
        op index (``fraction`` of the sequence), leaving exactly that
        prefix on disk — the injected crash.  Only SAVE sequences are
        interruptible: a standalone gc() must never pop (and thereby
        silently discard) a kill spec planned for the next save."""
        kill_at: Dict[int, Any] = {}
        if self.chaos is not None and interruptible and ops:
            for spec in self.chaos.take_save_interrupts():
                idx = min(max(int(spec.fraction * len(ops)), 0),
                          len(ops) - 1)
                kill_at.setdefault(idx, spec)
        for i, op in enumerate(ops):
            if self.op_hook is not None:
                self.op_hook(i, op)
            spec = kill_at.get(i)
            if spec is not None:
                from ..runtime import chaos as chaos_lib
                if spec.kind == "diskfull":
                    import errno
                    raise OSError(errno.ENOSPC,
                                  f"injected disk-full during {op.kind} "
                                  f"{os.path.basename(op.path)}")
                raise chaos_lib.InjectedFault(spec)
            if op.kind == "gc_guard":
                # read-back verify before retention deletes old copies:
                # a new step that does not audit restorable on disk
                # aborts the remaining (deletion-only) ops — the save
                # itself already committed and stays valid
                if not self.audit_step(int(op.data),
                                       repair="probe").restorable:
                    if self.events is not None:
                        self.events.instant("ckpt.gc_aborted",
                                            step=int(op.data))
                    return
                continue
            _apply_op(op)

    def _write_step(self, step: int, tree: Any,
                    layout: Optional[Dict[str, Any]],
                    emergency: bool, shards: Optional[int]) -> None:
        """Compress (if configured) + plan + execute the op stream.  In
        async mode this whole body runs on the background thread — the
        GB-scale BFP encode included, so ``save`` stalls the trainer
        only for the host snapshot."""
        t0 = time.perf_counter()
        if self.compress is not None and isinstance(tree, dict):
            for key in ("w_own", "w_master"):
                if key in tree:
                    tree = dict(tree, **{
                        key: compress_array(tree[key], self.compress)})
            if "opt_state" in tree:
                tree = dict(tree, opt_state={
                    k: compress_array(v, self.compress)
                    for k, v in tree["opt_state"].items()})
        t1 = time.perf_counter()
        ops = self._plan_write_ops(step, tree, layout, emergency, shards)
        t2 = time.perf_counter()
        self._exec_ops(ops)
        with self._stats_lock:      # the background save's thread
            self.last_save.update(encode_s=t1 - t0, checksum_s=t2 - t1,
                                  write_s=time.perf_counter() - t2)
        if self.chaos is not None:
            # durability damage-at-rest (file bit-flip / stale manifest)
            # fires AFTER the commit: the fault models rot/operator
            # error on a fully written checkpoint
            self.chaos.damage_checkpoint("ckpt.save", self._path(step),
                                         self._prev_manifest(step))

    def _prev_manifest(self, step: int) -> Optional[str]:
        prev = [s for s in self._all_steps() if s < step]
        return self._manifest_path(max(prev)) if prev else None

    def save(self, step: int, state: Any,
             layout: Optional[Dict[str, Any]] = None, *,
             emergency: bool = False,
             shards: Optional[int] = None) -> str:
        """Persist a trainer state (see ``_host_tree`` for what is
        dropped) under the audited commit protocol.  Returns the step
        path (async: the path it will commit to)."""
        t0 = time.perf_counter()
        tree = self._host_tree(state)
        pull_s = time.perf_counter() - t0
        self.wait_until_finished()       # serialize with the previous save
        with self._stats_lock:
            self.last_save = {"pull_s": pull_s}
        self._migrate_legacy_layout()
        shards = self.shards if shards is None else shards
        if self._async:
            # stage the sidecar durably BEFORE the background write: a
            # crash between the commit and the next sync point must leave
            # the layout recoverable next to the committed bytes
            self._stage_sidecar(step, layout)

            def work() -> None:
                try:
                    self._write_step(step, tree, layout, emergency, shards)
                except BaseException as e:  # noqa: BLE001 — re-raised at sync
                    self._bg_exc = e

            self._bg = threading.Thread(target=work, daemon=True,
                                        name="ckpt-save")
            self._bg.start()
        else:
            self._write_step(step, tree, layout, emergency, shards)
        return self._path(step)

    def wait_until_finished(self) -> None:
        """Block until any in-flight async save has committed to disk,
        recover any crash leftovers, flush the committed steps' staged
        layout sidecars, and re-raise any background-save error (a
        silently failed save would leave the caller trusting a
        checkpoint that never landed)."""
        t, self._bg = self._bg, None
        if t is not None:
            t.join()
        self._recover_leftovers()
        self._flush_pending_sidecars()
        exc, self._bg_exc = self._bg_exc, None
        if exc is not None:
            raise exc

    # -- audit + repair -----------------------------------------------------

    def read_manifest(self, step: int) -> Optional[Dict[str, Any]]:
        """The step's manifest, validated (format, self-checksum, step
        field vs directory name).  None when absent/torn/stale — the
        step is then unverified by definition."""
        try:
            with open(self._manifest_path(step)) as f:
                man = json.load(f)
        except (FileNotFoundError, NotADirectoryError,
                json.JSONDecodeError, UnicodeDecodeError):
            return None
        if not isinstance(man, dict) or man.get("format") != _FORMAT:
            return None
        declared = man.get("self_checksum")
        body = dict(man, self_checksum=0)
        if declared != bytes_checksum(_canonical_json(body)):
            return None
        if int(man.get("step", -1)) != step:
            # a STALE manifest (copied from another step) must not
            # validate bytes it never described
            return None
        return man

    def _load_piece(self, d: str, fname: str, checksum: int,
                    dtype: str, rows_shape: Tuple[int, ...]
                    ) -> Tuple[Optional[np.ndarray], str]:
        """(array, '') on a bit-exact load, (None, reason) otherwise."""
        p = os.path.join(d, fname)
        try:
            arr = np.load(p, allow_pickle=False)
        except FileNotFoundError:
            return None, "missing file"
        except Exception as e:  # noqa: BLE001 — torn/garbled npy
            return None, f"unreadable ({type(e).__name__})"
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            arr = arr.view(_BF16)          # '<V2' loads back as |V2
        if _dtype_str(arr) != dtype or tuple(arr.shape) != rows_shape:
            return None, (f"dtype/shape drift ({arr.dtype}{arr.shape} "
                          f"vs {dtype}{rows_shape})")
        if _array_checksum(arr) != checksum:
            return None, "checksum mismatch"
        return arr, ""

    def _heal(self, path: str, arr: np.ndarray) -> None:
        """Atomically rewrite a damaged primary from repaired bytes."""
        tmp = path + ".heal"
        with open(tmp, "wb") as f:
            _save_npy(f, arr)
        os.replace(tmp, path)

    def audit_step(self, step: int, repair: Any = False) -> AuditReport:
        """Bit-exact audit of one step against its manifest: every
        primary leaf/shard file is re-checksummed.  With ``repair=True``
        a corrupt primary whose PEER mirror verifies is fetched
        (``peer_fetch``), re-verified against the manifest,
        and healed in place; ``repair="probe"`` verifies the mirror and
        counts the shard repairable WITHOUT moving bytes or healing (the
        non-mutating query latest_step(verified=True)/GC use).
        ``restorable`` means every byte of the assembled tree is
        manifest-verified (clean, repaired or probe-verified mirror) —
        the only state ``restore`` will hand to a trainer."""
        rep = AuditReport(step=step)
        man = self.read_manifest(step)
        if man is None:
            rep.ok = False
            rep.failures.append({"path": [MANIFEST_FILE], "shard": None,
                                 "reason": "manifest absent/torn/stale"})
            return rep
        rep.emergency = bool(man.get("emergency"))
        d = self._path(step)
        arrays: List[Optional[np.ndarray]] = []
        fatal = False
        for entry in man["leaves"]:
            dtype, shape = entry["dtype"], tuple(entry["shape"])
            if "shards" in entry:
                n = len(entry["shards"])
                rows = shape[0] // n
                pieces: List[Optional[np.ndarray]] = []
                for j, srec in enumerate(entry["shards"]):
                    pshape = (rows,) + shape[1:]
                    arr, why = self._load_piece(d, srec["file"],
                                                srec["checksum"], dtype,
                                                pshape)
                    if arr is None:
                        rep.ok = False
                        fail = {"path": entry["path"], "shard": j,
                                "reason": why}
                        if repair:
                            arr = self._repair_piece(
                                d, srec, dtype, pshape, rep, fail,
                                probe=repair == "probe")
                        if arr is None:
                            rep.failures.append(fail)
                    pieces.append(arr)
                if any(p is None for p in pieces):
                    fatal = True
                    arrays.append(None)
                elif repair == "probe":
                    arrays.append(None)   # verdict-only: no assembly
                else:
                    arrays.append(np.concatenate(pieces, axis=0))
            else:
                arr, why = self._load_piece(d, entry["file"],
                                            entry["checksum"], dtype, shape)
                if arr is None:
                    rep.ok = False
                    fail = {"path": entry["path"], "shard": None,
                            "reason": why}
                    if repair and entry.get("mirror"):
                        arr = self._repair_piece(
                            d, {"file": entry["file"],
                                "mirror": entry["mirror"],
                                "checksum": entry["checksum"]},
                            dtype, shape, rep, fail,
                            probe=repair == "probe")
                    if arr is None:
                        rep.failures.append(fail)
                        fatal = True
                arrays.append(arr)
        if not fatal:
            rep.restorable = True
            if repair != "probe":
                # probe callers (gc_guard, latest_step(verified=True))
                # need only the verdict — skipping assembly avoids a
                # second full in-memory copy of a GB-scale state
                rep.tree = _rebuild(man["tree"],
                                    [a for a in arrays])  # type: ignore[misc]
        return rep

    def _repair_piece(self, d: str, srec: Dict[str, Any], dtype: str,
                      shape: Tuple[int, ...], rep: AuditReport,
                      fail: Dict[str, Any],
                      probe: bool = False) -> Optional[np.ndarray]:
        """Peer repair of one corrupt primary: verify the mirror copy
        bit-exactly against the manifest, fetch it onto the owner via
        ``peer_fetch``, re-verify the LANDED bytes, heal the
        primary file.  ``probe`` stops after the mirror verification
        (repairability without mutation).  None (with ``fail['reason']``
        extended) when no clean source exists — the caller then refuses
        or walks back, never restores."""
        mname = srec.get("mirror")
        if not mname:
            fail["reason"] += "; no peer mirror to repair from"
            return None
        mirror, why = self._load_piece(d, mname, srec["checksum"],
                                       dtype, shape)
        if mirror is None:
            fail["reason"] += f"; peer mirror also bad ({why})"
            return None
        if probe:
            return mirror
        landed, wire = peer_fetch(mirror)
        if _array_checksum(landed) != srec["checksum"]:
            fail["reason"] += "; peer fetch landed corrupt"
            return None
        self._heal(os.path.join(d, srec["file"]), landed)
        rep.repair_wire_bytes += wire
        rec = {"path": fail["path"], "shard": fail.get("shard"),
               "file": srec["file"], "wire_bytes": wire}
        rep.repaired.append(rec)
        if self.events is not None:
            self.events.instant("ckpt.repair", step=rep.step,
                                file=srec["file"], wire_bytes=wire)
        if self.recovery is not None:
            self.recovery.record_ckpt_repair(wire_bytes=wire)
        return landed

    # -- restore ------------------------------------------------------------

    def _decompress_tree(self, tree: Any) -> Any:
        if self.compress is not None and isinstance(tree, dict):
            for key in ("w_own", "w_master"):
                if key in tree and isinstance(tree[key], dict):
                    tree[key] = decompress_array(tree[key])
            if "opt_state" in tree:
                tree["opt_state"] = {
                    k: decompress_array(v) if isinstance(v, dict) else v
                    for k, v in tree["opt_state"].items()}
        return tree

    def restore(self, step: int,
                expect_layout: Optional[Dict[str, Any]] = None) -> Any:
        """Audited restore of one step: every leaf re-checksummed
        against the manifest, corrupt shards peer-repaired when a clean
        mirror exists, and REFUSED (CheckpointIntegrityError) otherwise
        — bytes that fail their audit never reach a trainer.  There is
        no unaudited restore path."""
        self.wait_until_finished()       # commit in-flight saves + sidecars
        self._check_layout(step, expect_layout)
        if self.chaos is not None:
            # durability faults at the restore boundary (damage-at-rest
            # discovered on read): fire BEFORE the audit so the audit is
            # what catches them
            self.chaos.damage_checkpoint("ckpt.restore", self._path(step),
                                         self._prev_manifest(step))
        rep = self.audit_step(step, repair=True)
        if not rep.restorable:
            if self.events is not None:
                self.events.instant("ckpt.refused", step=step,
                                    detail=rep.describe()[:200])
            raise CheckpointIntegrityError(
                f"refusing to restore {self._path(step)}: "
                f"{rep.describe()} — no clean source for the failed "
                "leaves (restore never silently hands corrupt bytes to "
                "a trainer; fall back to an earlier verified step via "
                "restore_latest_verified)")
        return _from_stored(self._decompress_tree(rep.tree))

    def restore_latest_verified(
            self, expect_layout: Optional[Dict[str, Any]] = None,
    ) -> Tuple[int, Any]:
        """Walk the step directory BACKWARD past corrupt/torn steps to
        the newest step that audits clean (repairing where a peer copy
        allows), and restore it.  Raises CheckpointIntegrityError when
        no verified step exists — refusal, never a silent restore of
        damaged state."""
        self.wait_until_finished()
        steps = self._all_steps()
        tried = []
        for step in sorted(steps, reverse=True):
            try:
                return step, self.restore(step, expect_layout=expect_layout)
            except CheckpointIntegrityError as e:
                tried.append((step, str(e).splitlines()[0][:160]))
        raise CheckpointIntegrityError(
            f"no verified checkpoint under {self.directory}: "
            f"{len(steps)} step dir(s), every audit failed "
            f"({tried if tried else 'directory empty'})")

    def latest_step(self, verified: bool = False) -> Optional[int]:
        """Newest step number — by directory name (``verified=False``,
        the cheap legacy behavior; atomic-write temp dirs
        and the v2 ``.tmp-write``/``.replaced`` names never match), or
        the newest step whose AUDIT passes (``verified=True``: walks
        backward past corrupt/torn steps; a step is counted when clean
        OR peer-repairable, since either restores bit-exactly)."""
        steps = self._all_steps()
        if not verified:
            return max(steps) if steps else None
        for step in sorted(steps, reverse=True):
            if self.audit_step(step, repair="probe").restorable:
                return step
        return None

    def is_emergency(self, step: int) -> bool:
        man = self.read_manifest(step)
        return bool(man and man.get("emergency"))

    # -- retention ----------------------------------------------------------

    def gc(self) -> List[int]:
        """Run retention now (``keep_last`` steps kept, plus the newest
        verified step unconditionally).  Returns the deleted steps."""
        before = set(self._all_steps())
        self._exec_ops(self._plan_gc_ops(new_step=None),
                       interruptible=False)
        return sorted(before - set(self._all_steps()))
