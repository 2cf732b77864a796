"""DDP trainer: bucketed gradient all-reduce + replicated optimizer — the
port of the JAX package's ``parallel/ddp.py`` (BASELINE.json's "BERT-base
DP (bucketed ring all-reduce)").

Each virtual rank runs forward and backward on its shard with its own
replica of the working weights; its gradient leaves are copied once into
its rows of the per-bucket f32 vectors (``ops.bucketed``, reverse tree
order); each bucket is mean-all-reduced by one collective (with
``fused_kernel`` the fused BFP ring kernels, one reduce-scatter and one
all-gather launch a bucket); the mean gradient, assembled in forward leaf
order and never rounded to the model dtype, then drives every rank's
full optimizer on its replicated f32 master (``optim.clip_by_global_norm``
and ``optim.apply``), and the working weights are cast back to the model
dtype.  Every per-rank quantity is stacked over the ranks as its leading
dimension, so the replicated masters, optimizer state and working weights
are ``[n, L]``: the gathered gradient rows are bitwise equal and the
update is deterministic, so the ranks' replicas stay bit-identical, which
a caller can check (``replicas_identical``).

The loss is the mean of the per-rank losses.  With ``accum_steps > 1``
each microbatch's gradient leaves are added in f32 into the same bucket
rows (``parallel.accum``), which are scaled by ``1 / accum_steps`` before
the buckets are reduced, once a step.  The buckets are reduced one after
the other once the backward is done; ``parallel.queued.QueuedDDPTrainer``
issues them through the explicit issue/wait queue instead.
``integrity_check`` raises ``ValueError`` as the JAX trainer's does (its
bucketed reduces do not carry the verdicts); ``obs_metrics=True`` is
accepted and adds nothing, as in the JAX package (``QueuedDDPTrainer``
delivers the loss on the host).  ``restore_state`` takes a
``utils.checkpoint`` payload, which stores rank 0's master row (JAX's
replicated vector).

Under a process group of W > 1 (``parallel.multihost``) the trainer at
dp = W spans the processes, one rank a process, as JAX's runs over the
global devices after ``multihost.initialize()``: the state holds this
rank's ``[1, L]`` master, moments and replica, the batch is this
process's rows (``multihost.local_batch_to_global``), the loss the mean of
every process's, and each bucket is one all-reduce over
``ops.ring_procs`` (``ProcRing.all_reduce``: the ``csrc/ring_hop.cu``
kernels into the neighbours' CUDA IPC buffers, gloo sends for CPU rows),
the buffers opened once at the largest bucket's frame; the mean and the
replicated optimizer are the one-process trainer's on the one row (its
per-rank ``clip_norm`` is local).  What ``train.check_processes``
refuses, ``accum_steps > 1`` among it, and a restore raise
``NotImplementedError`` naming ROADMAP A.11 there, as
``QueuedDDPTrainer`` does.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from . import accum, multihost
from .mesh import VirtualRanks
from .train import (check_processes, codec_flags, rank_grads, refuse_fsdp,
                    restored_tensor)
from .. import optim
from ..ops import bucketed, fused_update, ring_procs
from ..utils.config import CollectiveConfig, TrainConfig

Params = Any


class DDPState(NamedTuple):
    params: Params              # rank 0's working weights (views of replicas)
    replicas: torch.Tensor      # [n, L] every rank's working weights
    w_master: torch.Tensor      # [n, L] every rank's f32 master
    opt_state: optim.OptState   # {key: [n, L]} every rank's optimizer state
    step: int


class DDPTrainer:
    """``loss_fn(params, batch) -> scalar``, or a loss marked
    ``joint_ranks`` over all ranks at once (``train.joint_grads``: sync-BN);
    a batch is a tuple of tensors with a leading global-batch axis, split
    over the ranks by ``shard_batch``."""

    def __init__(self, loss_fn: Callable, ranks: VirtualRanks,
                 cfg: TrainConfig):
        refuse_fsdp(cfg)
        if ranks.sp != 1:
            raise NotImplementedError(
                f"sp={ranks.sp}: sequence parallelism runs on "
                "ShardedTrainer, as in the JAX package")
        if cfg.mesh.nproc != ranks.n or cfg.mesh.dp != ranks.n:
            raise ValueError(f"cfg.mesh ({cfg.mesh}) does not describe "
                             f"{ranks.n} dp ranks")
        if cfg.collective.integrity_check:
            raise ValueError(
                "integrity_check is implemented on DPTrainer only: the "
                "bucketed DDP reduces do not carry the verdicts, as in the "
                "JAX package; construct with integrity_check=False")
        self.loss_fn = loss_fn
        self.ranks = ranks
        self.n = ranks.n
        self.cfg = cfg
        self._meta: Optional[fused_update.FlatMeta] = None
        self._plan: Optional[bucketed.BucketPlan] = None
        # codec="auto": the tuner owns codec, bucket_elems, depth and
        # topology, resolved once at the first _ensure_meta (bucket_elems
        # sizes this trainer's bucket plan)
        self._tuned_plan = None
        # processes the ranks span, this one's rank, the rows it holds, and
        # its ring with a wire a bucket (opened at init_state)
        self.world = multihost.world_size()
        self.rank = multihost.process_index() if self.world > 1 else 0
        self._rows = 1 if self.world > 1 else self.n
        self._ring: Optional[ring_procs.ProcRing] = None
        self._wires: Tuple[ring_procs.Wire, ...] = ()
        if self.world > 1:
            codec, ef = codec_flags(cfg.collective)
            check_processes(cfg, self.world, codec, ef, loss_fn)

    def _open_ring(self, device: torch.device) -> None:
        """This rank's ring: a wire a bucket, the buffers sized once for
        the largest bucket's frame."""
        codec = fused_update.resolve_codec(self.cfg.collective)
        cfg = None if codec is None else codec.cfg
        self._wires = tuple(ring_procs.wire_for(b.padded_len // self.world,
                                                cfg)
                            for b in self.plan.buckets)
        self._ring = ring_procs.open_ring(
            self.rank, self.world, self._wires[0].C, cfg, device,
            max_frame=max(w.frame_bytes for w in self._wires))

    def close(self) -> None:
        """Release the cross-process ring's buffers (every process calls
        it; a no-op in one process)."""
        if self._ring is not None:
            self._ring.close()
            self._ring = None

    # -- init -----------------------------------------------------------------

    def _ensure_meta(self, params_like) -> None:
        from .. import tune as tune_lib
        if tune_lib.needs_autotune(self.cfg.collective):
            self.cfg, self._tuned_plan = tune_lib.resolve_train_config(
                self.cfg, self.n, params_like)
        # the masters' flat layout: no codec and one rank, so no padding
        self._meta = fused_update.flat_meta(params_like, CollectiveConfig(),
                                            1)
        self._plan = bucketed.plan_buckets(params_like, self.cfg.collective,
                                           self.n)

    @property
    def plan(self) -> bucketed.BucketPlan:
        if self._plan is None:
            raise RuntimeError("call init_state first")
        return self._plan

    def obs_static_metrics(self) -> dict:
        """The bucketed collective's static accounting: buckets, per-rank
        wire bytes of one all-reduce and the raw f32 bytes; under
        ``codec="auto"`` the resolved plan (``tune``)."""
        plan, coll = self.plan, self.cfg.collective
        codec = fused_update.resolve_codec(coll)
        d = {"n_devices": self.n, "impl": coll.impl,
             "topology": coll.topology, "n_buckets": len(plan.buckets),
             "bucket_elems": coll.bucket_elems,
             "wire_bytes_per_allreduce":
                 bucketed.bucket_wire_bytes(plan, self.n, coll),
             "raw_bytes_per_allreduce": sum(
                 fused_update.wire_bytes_for(coll, b.padded_len, self.n,
                                             codec=None)
                 for b in plan.buckets)}
        if codec is not None:
            d["codec"] = codec.name
        if self._tuned_plan is not None:
            d["tune"] = self._tuned_plan.describe()
        return d

    def init_state(self, params: Params) -> DDPState:
        """Every rank's master is the given weights in f32; the optimizer
        state starts at zero.  Across processes this rank's row, its ring
        opened."""
        params = fused_update.tree_map(lambda t: t.to(self.ranks.device),
                                       params)
        self._ensure_meta(params)
        flat = fused_update.flatten_tree(params, self._meta)
        w_master = flat.reshape(1, -1).repeat(self._rows, 1)
        if self.world > 1 and self._ring is None:
            self._open_ring(w_master.device)
        opt_state = optim.init_state(self.cfg.optimizer, w_master.shape,
                                     device=w_master.device)
        replicas = self._working(w_master)
        return DDPState(fused_update.unflatten_tree(replicas[0], self._meta),
                        replicas, w_master, opt_state, 0)

    def _working(self, w: torch.Tensor) -> torch.Tensor:
        """The masters in the working dtype: the leaves' one dtype, else
        f32 (cast per leaf by ``unflatten_tree``)."""
        dtypes = set(self._meta.dtypes)
        dt = dtypes.pop() if len(dtypes) == 1 else torch.float32
        return w if w.dtype == dt else w.to(dt)

    def restore_state(self, restored: dict, params_like=None) -> DDPState:
        """DDPState from a ``utils.checkpoint`` restore payload (the
        replicated master ``w_master`` and moments once, ``step``): every
        rank's row is the stored vector, and the working weights are
        rebuilt from it.  The layout must be known: call ``init_state``
        first or pass ``params_like``."""
        multihost.refuse_processes("restore_state")
        if params_like is not None:
            self._ensure_meta(params_like)
        if self._meta is None:
            raise RuntimeError("flat layout unknown: call init_state "
                               "first or pass params_like")
        dev = self.ranks.device

        def rows(v):
            w = restored_tensor(v, dev).reshape(1, -1).to(torch.float32)
            return w.repeat(self.n, 1)

        w_master = rows(restored["w_master"])
        opt_state = {k: rows(v) for k, v in restored["opt_state"].items()}
        replicas = self._working(w_master)
        return DDPState(fused_update.unflatten_tree(replicas[0], self._meta),
                        replicas, w_master, opt_state, int(restored["step"]))

    def shard_batch(self, batch) -> Tuple[torch.Tensor, ...]:
        """[B, ...] host tensors -> [n, B/n, ...] on the ranks' device;
        across processes this process's rank's rows, [1, B/n, ...]."""
        out = self.ranks.shard_batch(batch)
        if self.world > 1:
            return tuple(x[self.rank:self.rank + 1] for x in out)
        return out

    # -- step -----------------------------------------------------------------

    def grads(self, state: DDPState, batch
              ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Per-rank backward into the bucket rows: ``(rows, mean loss)``,
        rows ``[n, padded_len]`` f32 a bucket (across processes ``[1,
        padded_len]``, the loss every process's mean), in issue order,
        accumulated over ``cfg.accum_steps`` microbatches
        (``accum.accumulate``)."""
        plan = self.plan

        def one(mb, into):
            rows = into if into is not None else bucketed.bucket_rows(
                plan, self._rows, state.replicas.device)

            def write(i: int, leaves: List[torch.Tensor]) -> None:
                bucketed.bucket_locals(leaves, plan, [r[i] for r in rows],
                                       add=into is not None)

            _, loss = rank_grads(self.loss_fn, state.replicas, self._meta,
                                 mb, write)
            return rows, loss

        rows, loss = accum.accumulate(one, batch, self.cfg.accum_steps)
        return rows, multihost.process_mean(loss)

    def all_reduce(self, rows: List[torch.Tensor]) -> torch.Tensor:
        """The bucketed mean all-reduce: ``[n, L]`` f32, every rank's row
        its dp-mean gradient in forward leaf order (``rows`` consumed).
        Across processes ``[1, L]``: each bucket one ``ProcRing.all_reduce``
        on its own wire, divided by W where ``bucketed.assemble_flat``
        divides the one-process sums."""
        if self.world > 1:
            return bucketed.assemble_flat(
                (self._ring.all_reduce(rows.pop(0)[0], w)[None]
                 for w in self._wires), self.plan, div=self.world)
        return bucketed.all_reduce_bucketed_flat(rows, self.cfg.collective,
                                                 self.plan)

    def update(self, state: DDPState, flat_g: torch.Tensor) -> DDPState:
        """Every rank's replicated optimizer on its own mean gradient row:
        the global-norm clip per rank, then ``optim.apply``."""
        opt_cfg = self.cfg.optimizer
        if opt_cfg.clip_norm is not None:
            flat_g = torch.stack([optim.clip_by_global_norm(opt_cfg, g)
                                  for g in flat_g])
        w_new, opt_state = optim.apply(opt_cfg, state.w_master, flat_g,
                                       state.opt_state, state.step)
        del flat_g
        replicas = self._working(w_new)
        return DDPState(fused_update.unflatten_tree(replicas[0], self._meta),
                        replicas, w_new, opt_state, state.step + 1)

    def step(self, state: DDPState, batch) -> Tuple[DDPState, torch.Tensor]:
        rows, loss = self.grads(state, batch)
        return self.update(state, self.all_reduce(rows)), loss


def replicas_identical(state: DDPState) -> bool:
    """Are every rank's master, optimizer state and working weights
    bitwise equal to rank 0's?"""
    return all(bool((t == t[0]).all()) for t in
               (state.w_master, state.replicas, *state.opt_state.values()))
