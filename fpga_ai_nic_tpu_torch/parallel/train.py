"""Data-parallel training with the fused scatter-update-gather collective —
the port of the JAX package's ``parallel/train.py`` (``DPTrainer``).

Each virtual rank runs forward and backward on its batch shard with its own
replica of the working weights (``per_rank_grads``); a loss that couples
the ranks, sync-BN's, is marked ``joint_ranks`` and differentiated over
all ranks in one graph (``joint_grads``).  The flat gradients
``[n, L_pad]`` then go through the two phases of the JAX ``step_fn``:

  phase 1: ``fused_update.reduce_scatter_update`` — ring reduce-scatter
    (the codec on every hop) with the ZeRO-1 optimizer update of each
    rank's owned master shard on the final hop;
  phase 2: ``fused_update.all_gather_flat`` — ring all-gather of the
    updated masters into every rank's replica.

A codec that declares error feedback (top-k by default; any codec with
``error_feedback=True``) on the ring first compensates and compresses each
rank's gradient locally (``fused_update.error_feedback_encode``), carrying
what it dropped in ``TrainState.codec_state`` ([n, L_pad]).

With ``accum_steps > 1`` the backward runs once a microbatch of every
rank's local batch (``parallel.accum``), adding each microbatch's
gradients in f32 into the same flat rows, which are then scaled by
``1 / accum_steps``: the collective, the update and the error feedback
still run once a step.

The loss is the mean of the per-rank losses.  ``step`` = ``grads``, then
``error_feedback``, then ``apply_grads``; the parts are public so a caller
can run the same compensated gradients through another collective
(``chip_smoke.py`` does).  Nothing is updated in place: a step returns a
new TrainState.

With a process group of W > 1 processes (``parallel.multihost``) the
trainer spans them, one rank a process, as the JAX ``DPTrainer`` runs over
the global devices after ``multihost.initialize()``: ``cfg.mesh.dp`` must
be W, the state holds this rank's rows (a ``[1, L_pad]`` replica, ``[1,
C]`` master and moment shards), the batch is this process's rows
(``multihost.local_batch_to_global``), its forward and backward are the
one-process loop's for that rank, phase 1 and phase 2 run over
``ops.ring_procs`` (the ``csrc/ring_hop.cu`` kernels writing into the
neighbours' CUDA IPC buffers, or gloo sends for CPU rows), and the loss is
the mean of every process's.  It takes BFP in the sublane layout or no
codec, with each fused optimizer (``fused_optimizer=True``); the
unfused update, int8, top-k, error feedback, ``integrity_check``,
``accum_steps > 1``, a ``joint_ranks`` loss (sync-BN), ``clip_norm``,
the step metrics, a restore and a reshard raise ``NotImplementedError``
naming ROADMAP A.11 there, as do the other trainers.  One process is
unchanged.

``CollectiveConfig(integrity_check=True)`` guards the collective with two
tiers (``runtime.chaos``): the value tier (chunk sums against the input's,
within ``integrity_tol``, and non-finite counts) and the exact tier
(``wire_ok``: the frame conservation of the rings or the checksum pair of
the fused kernel, ANDed with the gather's verdict).  Where
``fused_update.update_route_gatable`` holds, a tripped step leaves the
masters, the optimizer state and the codec state as they were; on the
CUDA kernel route the caller's ``chaos.check_step_diag`` is the recovery,
as in the JAX package.  With it on, ``step`` returns ``(state, diag)`` with
``diag`` = {integrity_ok, integrity_err, nonfinite, wire_ok, grad_norm,
loss}, and ``apply_grads`` returns ``(state, diag)`` without the loss.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import accum, multihost
from .mesh import VirtualRanks
from .. import optim
from ..compress import Codec
from ..obs import metrics as obs_metrics
from ..ops import fused_update, ring_hier, ring_procs
from ..runtime import chaos
from ..utils.config import CollectiveConfig, OptimizerSpec, TrainConfig

Params = Any


class TrainState(NamedTuple):
    params: Params              # rank 0's working weights (views of replicas)
    # [n, L_pad] every rank's working weights in the model dtype (the one
    # most of the tree's elements have, as JAX keeps them)
    replicas: torch.Tensor
    w_own: torch.Tensor         # [n, C] f32 master shards (ZeRO-1)
    opt_state: optim.OptState   # {key: [n, C]} optimizer state shards
    step: int
    # error-feedback residual of the codec, each rank's locally dropped
    # gradient mass [n, L_pad], re-added next step (None without EF)
    codec_state: Optional[torch.Tensor] = None
    # [n, L_side] f32: the leaves of another dtype than the replicas'
    # (a MoE router in a bf16 tree), exact, in tree order
    # (fused_update.split_working); None when the tree has one dtype
    side: Optional[torch.Tensor] = None


def _row_writer(replicas: torch.Tensor, meta: fused_update.FlatMeta,
                write: Optional[Callable[[int, List[torch.Tensor]], None]]
                ) -> Tuple[Optional[torch.Tensor],
                           Callable[[int, List[torch.Tensor]], None]]:
    """``(flat_g, write)``: the given ``write`` (flat_g None), or one that
    copies rank i's gradient leaves into row i of a new ``[n, L_pad]``
    f32 flat_g."""
    if write is not None:
        return None, write
    flat_g = torch.empty((replicas.shape[0], meta.padded_len),
                         dtype=torch.float32, device=replicas.device)

    def into_row(i: int, gs: List[torch.Tensor]) -> None:
        fused_update.flatten_leaves(gs, meta, out=flat_g[i])
    return flat_g, into_row


def _rank_leaves(replicas: torch.Tensor, meta: fused_update.FlatMeta,
                 i: int, side: Optional[torch.Tensor] = None
                 ) -> List[torch.Tensor]:
    """Rank i's leaves, cast to their dtypes (views where the replica, or
    the side, is in them already), detached and requiring grad."""
    return [t.detach().requires_grad_() for t in fused_update.tree_leaves(
        fused_update.unflatten_tree(replicas[i], meta,
                                    None if side is None else side[i]))]


def per_rank_grads(loss_fn: Callable, replicas: torch.Tensor,
                   meta: fused_update.FlatMeta, batch,
                   write: Optional[Callable[[int, List[torch.Tensor]],
                                            None]] = None,
                   side: Optional[torch.Tensor] = None
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """``(flat_g [n, L_pad] f32, mean loss)``: rank i differentiates
    ``loss_fn`` at its own replica ``replicas[i]`` (cast to the leaves'
    dtypes; views where the replica is in them already) on its own shard
    ``tuple(b[i] for b in batch)``; each gradient leaf is copied into its
    slot of the flat row as soon as it exists.  ``write(i, leaves)``
    places rank i's gradient leaves elsewhere instead (flat_g is then
    None).  ``side``: the replicas' side rows (``TrainState.side``)."""
    flat_g, write = _row_writer(replicas, meta, write)
    losses: List[torch.Tensor] = []
    for i in range(replicas.shape[0]):
        leaves = _rank_leaves(replicas, meta, i, side)
        params_i = fused_update.tree_from_leaves(meta.keys, leaves)
        loss = loss_fn(params_i, tuple(b[i] for b in batch))
        gs = torch.autograd.grad(loss, leaves)
        del params_i, leaves
        write(i, list(gs))
        del gs
        losses.append(loss.detach())
    return flat_g, torch.stack(losses).mean()


def joint_grads(loss_fn: Callable, replicas: torch.Tensor,
                meta: fused_update.FlatMeta, batch,
                write: Optional[Callable[[int, List[torch.Tensor]],
                                         None]] = None,
                side: Optional[torch.Tensor] = None
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """As ``per_rank_grads`` for a loss over all n ranks at once
    (``loss_fn.joint_ranks``, e.g. sync-BN's ``models.resnet.dp_loss_fn``):
    ``loss_fn(params_per_rank, batch) -> [n]`` losses in one graph, rank
    i's rows through leaves made from its own replica; one backward of
    their sum gives rank j d(sum_i loss_i)/d(theta_j), the gradient JAX
    gives rank j when the params are cast dp-varying before ``jax.grad``
    (``parallel/train.py`` there).  Every rank's activations are alive at
    once."""
    flat_g, write = _row_writer(replicas, meta, write)
    n = replicas.shape[0]
    leaves = [_rank_leaves(replicas, meta, i, side) for i in range(n)]
    losses = loss_fn([fused_update.tree_from_leaves(meta.keys, ls)
                      for ls in leaves], batch)
    gs = list(torch.autograd.grad(losses.sum(),
                                  [t for ls in leaves for t in ls]))
    del leaves
    k = len(meta.keys)
    for i in range(n):
        write(i, gs[i * k:(i + 1) * k])
        gs[i * k:(i + 1) * k] = [None] * k
    return flat_g, losses.detach().mean()


def restored_tensor(v: Any, device: torch.device) -> torch.Tensor:
    """A restored checkpoint leaf (numpy, or a tensor) on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(np.array(v, copy=True)).to(device)


def restored_rows(v: Any, meta: fused_update.FlatMeta, n: int,
                  device: torch.device) -> torch.Tensor:
    """A stored global flat vector (JAX's ``P(ax)`` layout) as this
    layout's ``[n, C]`` rank rows, re-padded to its padded length
    (``fused_update.repad_flat``: a checkpoint written at another rank
    count restores value-exact)."""
    flat = fused_update.repad_flat(restored_tensor(v, device).reshape(-1)
                                   .to(torch.float32), meta)
    return flat.reshape(n, -1).contiguous()


def refuse_fsdp(cfg: TrainConfig) -> None:
    """The ZeRO-1 and bucketed trainers refuse an fsdp mesh axis: ZeRO-3
    runs on ``parallel.fsdp.FSDPTrainer``, as in the JAX package."""
    if cfg.mesh.fsdp != 1:
        raise NotImplementedError(
            f"fsdp={cfg.mesh.fsdp}: fully sharded data parallelism (ZeRO-3) "
            "runs on FSDPTrainer (parallel.fsdp)")


def static_metrics(n: int, coll, codec, padded_len: int) -> dict:
    """The trainers' static telemetry (JAX's ``obs_static_metrics`` keys):
    flat layout, declared codec properties, wire bytes of one all-reduce
    under the topology and raw, and the hierarchical plan under
    ``topology="hier"``."""
    d = {"padded_len": padded_len, "n_devices": n, "impl": coll.impl,
         "topology": coll.topology}
    d.update(obs_metrics.codec_static_metrics(codec, padded_len))
    d["wire_bytes_per_allreduce"] = fused_update.wire_bytes_for(
        coll, padded_len, n)
    d["raw_bytes_per_allreduce"] = fused_update.wire_bytes_for(
        coll, padded_len, n, codec=None)
    if coll.topology == "hier":
        d["hier_plan"] = ring_hier.plan_hier(
            padded_len, n, coll.intra_size, codec).describe()
    return d


def rank_grads(loss_fn: Callable, replicas: torch.Tensor,
               meta: fused_update.FlatMeta, batch,
               write: Optional[Callable[[int, List[torch.Tensor]],
                                        None]] = None,
               side: Optional[torch.Tensor] = None
               ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The trainers' backward: ``joint_grads`` for a loss marked
    ``joint_ranks``, ``per_rank_grads`` for any other."""
    fn = (joint_grads if getattr(loss_fn, "joint_ranks", False)
          else per_rank_grads)
    return fn(loss_fn, replicas, meta, batch, write, side)


def codec_flags(coll: CollectiveConfig) -> Tuple[Optional[Codec], bool]:
    """``(codec, error_feedback)`` of a collective config: none while it
    is an unresolved ``codec="auto"``."""
    from .. import tune as tune_lib
    if tune_lib.needs_autotune(coll):
        return None, False
    codec = fused_update.resolve_codec(coll)
    return codec, (coll.impl == "ring" and codec is not None
                   and codec.error_feedback)


class DPTrainer:
    """Per-rank gradients + fused collective over n virtual ranks.

    ``loss_fn(params, batch) -> scalar``, or a loss marked ``joint_ranks``
    over all ranks at once (``joint_grads``); a batch is a tuple of
    tensors with a leading global-batch axis, split over the ranks by
    ``shard_batch``."""

    takes_sp = False     # ShardedTrainer's: the tp, sp, ep and pp axes

    def __init__(self, loss_fn: Callable, ranks: VirtualRanks,
                 cfg: TrainConfig):
        refuse_fsdp(cfg)
        if (cfg.mesh.nproc != (ranks.n * ranks.sp * ranks.ep * ranks.pp
                               * ranks.tp)
                or cfg.mesh.dp != ranks.n or cfg.mesh.sp != ranks.sp
                or cfg.mesh.ep != ranks.ep or cfg.mesh.pp != ranks.pp
                or cfg.mesh.tp != ranks.tp):
            raise ValueError(f"cfg.mesh ({cfg.mesh}) does not describe "
                             f"{ranks.n} dp x {ranks.tp} tp x {ranks.sp} "
                             f"sp x {ranks.ep} ep x {ranks.pp} pp ranks")
        for axis, size in (("tp", ranks.tp), ("sp", ranks.sp),
                           ("ep", ranks.ep), ("pp", ranks.pp)):
            if size != 1 and not self.takes_sp:
                raise NotImplementedError(
                    f"{axis}={size}: tensor, sequence, expert and pipeline "
                    "parallelism run on ShardedTrainer, as in the JAX "
                    "package")
        coll = cfg.collective
        if coll.fused_optimizer and cfg.optimizer.clip_norm is not None:
            raise ValueError(
                "fused_optimizer cannot honor clip_norm: a global-norm clip "
                "needs a barrier between the reduce-scatter and the update")
        self.loss_fn = loss_fn
        self.ranks = ranks
        self.n = ranks.n
        self.cfg = cfg
        # rank axes ahead of a rank's local batch in a sharded batch leaf
        # ([n, (ep,) (sp,) B_local, ...]): where microbatches are cut
        self._lead = 1 + (ranks.ep > 1) + (ranks.sp > 1)
        # codec="auto": codec, depth, bucket and topology resolve once at
        # the first _ensure_meta or init_state, where the payload is known
        self._tuned_plan = None
        self._codec, self._ef = codec_flags(coll)
        self._meta = None
        # per-element norm weights of the clip (optim.global_norm); the
        # ep layout's tables (ShardedTrainer), None where every master
        # row holds distinct elements
        self._norm_weights = None
        # processes the ranks span, this one's rank, and its ring
        # (ops.ring_procs, opened at init_state) when there are several
        self.world = multihost.world_size()
        self.rank = multihost.process_index() if self.world > 1 else 0
        self._ring: Optional[ring_procs.ProcRing] = None
        if self.world > 1:
            self._check_processes()

    # -- across processes -----------------------------------------------------

    def _check_processes(self) -> None:
        """What the cross-process ring takes (the class docstring)."""
        cfg, coll = self.cfg, self.cfg.collective
        if cfg.mesh.dp != self.world:
            raise ValueError(f"cfg.mesh.dp={cfg.mesh.dp} under a process "
                             f"group of {self.world}: one rank a process")

        refuse = multihost.refuse_processes
        if coll.impl != "ring" or coll.topology != "flat":
            refuse(f"impl={coll.impl!r}, topology={coll.topology!r} (the "
                   "flat explicit ring only)")
        codec = self._codec
        if codec is None and coll.codec is not None:
            refuse(f"codec={coll.codec!r}")
        if codec is not None and (codec.name != "bfp" or self._ef):
            refuse(f"the {codec.name} codec"
                   + (" with error feedback" if self._ef else ""))
        if codec is not None and not (coll.fused_kernel
                                      or codec.cfg.codec == "pallas"):
            refuse("BFP in the flat16 layout")
        for flag, what in ((not coll.fused_optimizer,
                            "fused_optimizer=False (the update runs on the "
                            "ring's last hop)"),
                           (coll.integrity_check, "integrity_check"),
                           (cfg.accum_steps > 1, "accum_steps > 1"),
                           (getattr(self.loss_fn, "joint_ranks", False),
                            "a joint_ranks loss (sync-BN)"),
                           (cfg.optimizer.clip_norm is not None,
                            "clip_norm"),
                           (cfg.obs_metrics, "obs_metrics")):
            if flag:
                refuse(what)

    def _proc_initial(self, w_own: torch.Tensor,
                      opt_state: optim.OptState) -> TrainState:
        """``_initial`` of this process's rank: the replica the masters as
        they are, its own master and moment rows, its ring opened."""
        replicas, side = self._working(w_own.reshape(1, -1))
        r = slice(self.rank, self.rank + 1)
        w_row = w_own[r].clone()
        opt_rows = {k: v[r].clone() for k, v in opt_state.items()}
        del w_own, opt_state
        if self._ring is None:
            codec = self._codec
            self._ring = ring_procs.open_ring(
                self.rank, self.world, w_row.shape[1],
                None if codec is None else codec.cfg, w_row.device)
        return TrainState(self._rank0(replicas, side), replicas, w_row,
                          opt_rows, 0, None, side)

    def _proc_mean(self, loss: torch.Tensor) -> torch.Tensor:
        """The mean of every process's loss (the one-process trainer's
        mean over its ranks), gathered over the gloo group."""
        import torch.distributed as dist
        mine = loss.detach().reshape(1).to("cpu", torch.float32)
        parts = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(parts, mine)
        return torch.cat(parts).to(loss.device).mean()

    def _proc_apply(self, state: TrainState, flat_g: torch.Tensor
                    ) -> TrainState:
        """Phase 1 over the cross-process ring, the fused update on the
        owned shard at its last hop; then phase 2."""
        opt_cfg = self.cfg.optimizer
        spec = OptimizerSpec.from_optimizer(opt_cfg)
        hyper = optim.fused_hyperparams(opt_cfg, state.step,
                                        device=flat_g.device)
        _, w_new, st = self._ring.reduce_scatter_update(
            flat_g[0], state.w_own[0],
            {k: v[0] for k, v in state.opt_state.items()}, hyper, spec.kind)
        return self._gather(w_new[None], {k: v[None] for k, v in st.items()},
                            state.step + 1)

    def close(self) -> None:
        """Release the cross-process ring's buffers (every process calls
        it; a no-op in one process)."""
        if self._ring is not None:
            self._ring.close()
            self._ring = None

    def _resolve_auto(self, params_like) -> None:
        """The one resolution of a ``codec="auto"`` template (a no-op
        otherwise), priced at the padded length its codec gives; with
        ``cfg.adapt`` armed for live calibration, the rates are first
        measured on these ranks (``tune.adapt.live_calibrate``, the live
        tier)."""
        from .. import tune as tune_lib
        if not tune_lib.needs_autotune(self.cfg.collective):
            return
        acfg = self.cfg.adapt
        calibration = (tune_lib.adapt.live_calibrate(self.ranks)
                       if acfg.enabled and acfg.live_calibration else None)
        self.cfg, self._tuned_plan = tune_lib.resolve_train_config(
            self.cfg, self.n, params_like, calibration=calibration,
            padded=True)
        self._codec, self._ef = codec_flags(self.cfg.collective)

    def _ensure_meta(self, params_like) -> None:
        """The flat layout of a params tree (shapes and dtypes only),
        resolving ``codec="auto"`` first."""
        self._resolve_auto(params_like)
        self._meta = fused_update.flat_meta(params_like, self.cfg.collective,
                                            self.n)

    # -- init -----------------------------------------------------------------

    def init_state(self, params: Params) -> TrainState:
        """Split replicated params into the ranks' master shards; every
        rank starts from the given weights as they are."""
        self._resolve_auto(params)
        coll, opt_cfg = self.cfg.collective, self.cfg.optimizer
        params = fused_update.tree_map(lambda t: t.to(self.ranks.device),
                                       params)
        w_own, opt_state, meta = fused_update.init_master_shard(
            params, coll, opt_cfg, self.n)
        self._meta = meta
        if self.world > 1:
            return self._proc_initial(w_own, opt_state)
        return self._initial(w_own, opt_state, self._init_codec_state())

    def _initial(self, w_own: torch.Tensor, opt_state: optim.OptState,
                 codec_state: Optional[torch.Tensor]) -> TrainState:
        """The step-0 state of the masters ``w_own``: every rank's
        working weights are the masters as they are, cast, not gathered."""
        replicas, side = self._working(w_own.reshape(1, -1))
        replicas = replicas.expand(self.n, -1)
        side = None if side is None else side.expand(self.n, -1)
        return TrainState(self._rank0(replicas, side), replicas, w_own,
                          opt_state, 0, codec_state, side)

    def _landed(self, w_own: torch.Tensor, opt_state: optim.OptState,
                step: int, codec_state: Optional[torch.Tensor]
                ) -> TrainState:
        """The state of masters that land from outside a step (a restore,
        a reshard), built as the uninterrupted run built it: after a step
        the replicas are what its gather made, so the same gather rebuilds
        them; at step 0 they are ``init_state``'s, the masters as they
        are, which a lossy wire codec's gather would round."""
        if step == 0:
            return self._initial(w_own, opt_state, codec_state)
        return self._gather(w_own, opt_state, step, codec_state)

    def _working(self, flat: torch.Tensor
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Gathered f32 weights as ``(replicas, side)``: one cast to the
        model dtype right after the all-gather, as JAX's gather casts in
        ``unflatten_tree``, so the per-rank leaves are views; leaves of
        another dtype (MoE's f32 router) are held apart exactly
        (``fused_update.split_working``)."""
        return fused_update.split_working(flat, self._meta)

    def _rank0(self, replicas: torch.Tensor,
               side: Optional[torch.Tensor]) -> Params:
        return fused_update.unflatten_tree(
            replicas[0], self._meta, None if side is None else side[0])

    def _init_codec_state(self) -> Optional[torch.Tensor]:
        """Zeroed per-rank error-feedback residuals [n, L_pad]."""
        if not self._ef:
            return None
        return self._codec.state_init((self.n, self._meta.padded_len),
                                      self.ranks.device)

    def shard_batch(self, batch) -> Tuple[torch.Tensor, ...]:
        """[B, ...] host tensors -> [n, B/n, ...] on the ranks' device;
        across processes this process's rank's rows, [1, B/n, ...]."""
        out = self.ranks.shard_batch(batch)
        if self.world > 1:
            return tuple(x[self.rank:self.rank + 1] for x in out)
        return out

    # -- step -----------------------------------------------------------------

    def grads(self, state: TrainState, batch
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ranks' backward (``rank_grads``): ``(flat_g [n, L_pad],
        mean loss)``, accumulated over ``cfg.accum_steps`` microbatches
        (``accum.accumulate``: microbatch k of every rank at once)."""
        meta = self._meta
        if meta is None:
            raise RuntimeError("call init_state first")

        def one(mb, into):
            write = None if into is None else (
                lambda i, gs: accum.add_leaves(gs, meta, into[i]))
            flat_g, loss = rank_grads(self.loss_fn, state.replicas, meta,
                                      mb, write, side=state.side)
            return (into if flat_g is None else flat_g), loss

        flat_g, loss = accum.accumulate(one, batch, self.cfg.accum_steps,
                                        self._lead)
        if self.world > 1:
            loss = self._proc_mean(loss)
        return flat_g, loss

    def error_feedback(self, state: TrainState, flat_g: torch.Tensor
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Compensate-then-compress: ``(g_wire, codec_state)``.  The wire
        then sees each rank's locally quantized gradient; what it dropped
        is the new residual.  Without error feedback: ``(flat_g,
        state.codec_state)``."""
        if not self._ef:
            return flat_g, state.codec_state
        return fused_update.error_feedback_encode(self._codec, flat_g,
                                                  state.codec_state)

    def apply_grads(self, state: TrainState, flat_g: torch.Tensor,
                    codec_state: Optional[torch.Tensor] = None,
                    metrics: Optional[dict] = None):
        """Phase 1 (reduce-scatter + update) and phase 2 (all-gather).
        ``codec_state``: the residual ``error_feedback`` returned (the
        new state keeps ``state.codec_state`` when it is None).  Returns
        the new TrainState, or ``(state, diag)`` with integrity on.
        ``metrics`` (a dict, ``obs_metrics``) receives the pre-clip
        ``grad_norm`` of the reduced gradient (and ``integrity_err`` on
        the unfused route with integrity on)."""
        if self.world > 1:
            return self._proc_apply(state, flat_g)
        coll = self.cfg.collective
        if codec_state is None:
            codec_state = state.codec_state
        icheck = coll.integrity_check
        diag = None
        if icheck:
            # the checksums guard what rides the wire: under error
            # feedback, the compensated and compressed gradient
            expect, l1 = chaos.chunk_checksums(flat_g, self.n)
            tol = (coll.integrity_tol if coll.integrity_tol is not None
                   else chaos.integrity_tol(coll, self.n))
        if not coll.fused_optimizer:
            if not icheck:
                return self.update(
                    state, fused_update.reduce_scatter(flat_g, coll) / self.n,
                    codec_state, metrics=metrics)
            g_red, wire_ok = fused_update.reduce_scatter(flat_g, coll,
                                                         integrity=True)
            diag = self._diag(expect, l1, g_red, tol, wire_ok)
            if metrics is not None:
                metrics["integrity_err"] = diag["integrity_err"]
            return self.update(state, g_red / self.n, codec_state, diag,
                               metrics=metrics)
        res = fused_update.reduce_scatter_update(
            flat_g, state.w_own, state.opt_state, state.step, coll,
            self.cfg.optimizer, integrity=icheck)
        _, w_new, opt_state = res[:3]
        if icheck:
            diag = self._diag(expect, l1, res[0], tol, res[3])
            if fused_update.update_route_gatable(coll, self.n,
                                                 flat_g.device):
                w_new, opt_state, codec_state = self._gate(
                    diag, state, w_new, opt_state, codec_state)
        if metrics is not None:
            metrics["grad_norm"] = (diag["grad_norm"] if icheck else
                                    obs_metrics.l2_norm(res[0] / self.n))
        return self._gather(w_new, opt_state, state.step + 1, codec_state,
                            diag)

    def _diag(self, expect, l1, g_red, tol, wire_ok) -> dict:
        """Both tiers' verdicts on one reduce-scatter (``g_red``: the raw
        sums) and the pre-clip gradient norm."""
        diag = chaos.collective_integrity(expect, l1, g_red, self.n, tol)
        diag["wire_ok"] = wire_ok
        diag["grad_norm"] = torch.sqrt(
            ((g_red / self.n).to(torch.float32) ** 2).sum())
        return diag

    def _gate(self, diag: dict, state: TrainState, w_new: torch.Tensor,
              opt_state: optim.OptState, codec_state):
        """A tripped verdict makes the update a no-op: masters, optimizer
        state and the error-feedback residual keep their old values (a
        replayed step must not count its dropped mass twice)."""
        ok = diag["integrity_ok"] & diag["wire_ok"]
        w_new = torch.where(ok, w_new, state.w_own)
        opt_state = {k: torch.where(ok, v, state.opt_state[k])
                     for k, v in opt_state.items()}
        if self._ef:
            codec_state = torch.where(ok, codec_state, state.codec_state)
        return w_new, opt_state, codec_state

    def update(self, state: TrainState, g_own: torch.Tensor,
               codec_state: Optional[torch.Tensor] = None,
               diag: Optional[dict] = None,
               metrics: Optional[dict] = None):
        """The unfused phase 1 after the reduce-scatter (clip, optimizer
        on the owned shards ``g_own [n, C]``, already divided by n), then
        phase 2.  With ``diag`` (the reduce-scatter's verdicts, integrity
        on) the update is gated by them and ``(state, diag)`` returned.
        ``metrics`` receives the pre-clip ``grad_norm``."""
        opt_cfg = self.cfg.optimizer
        if metrics is not None:
            metrics["grad_norm"] = (diag["grad_norm"] if diag is not None
                                    else obs_metrics.l2_norm(g_own))
        g_own = optim.clip_by_global_norm(opt_cfg, g_own,
                                          self._norm_weights)
        w_new, opt_state = optim.apply(opt_cfg, state.w_own, g_own,
                                       state.opt_state, state.step)
        del g_own
        if diag is not None:
            w_new, opt_state, codec_state = self._gate(
                diag, state, w_new, opt_state, codec_state)
        return self._gather(w_new, opt_state, state.step + 1, codec_state,
                            diag)

    def _gather(self, w_new: torch.Tensor, opt_state: optim.OptState,
                step: int, codec_state: Optional[torch.Tensor] = None,
                diag: Optional[dict] = None):
        """Phase 2; with ``diag``, its verdict is ANDed into ``wire_ok``
        and ``(state, diag)`` returned."""
        if self.world > 1:
            gathered = self._ring.all_gather(w_new[0])[None]
        else:
            gathered = fused_update.all_gather_flat(
                w_new, self.cfg.collective, integrity=diag is not None)
        if diag is not None:
            gathered, ag_ok = gathered
            diag = dict(diag, wire_ok=diag["wire_ok"] & ag_ok)
        replicas, side = self._working(gathered)
        new = TrainState(self._rank0(replicas, side), replicas, w_new,
                         opt_state, step, codec_state, side)
        return new if diag is None else (new, diag)

    def step(self, state: TrainState, batch):
        """One step: ``(state, loss)``, or ``(state, diag)`` with the loss
        in ``diag`` when integrity is on.  With ``cfg.obs_metrics`` and an
        active sink (``obs.metrics.use_sink``) the step's ``loss``,
        ``grad_norm`` and, with a codec, ``codec_obs_rel_err`` (the
        maximum over the ranks; the error-feedback wire vector is
        roundtrip(g + residual) already, otherwise one roundtrip is spent)
        and ``ef_resid_norm`` go to it through ``obs.metrics.tap``; off,
        nothing of them is computed."""
        flat_g, loss = self.grads(state, batch)
        m = ({} if self.cfg.obs_metrics
             and obs_metrics.active_sink() is not None else None)
        flat_raw = flat_g
        flat_g, codec_state = self.error_feedback(state, flat_g)
        if m is not None and self._codec is not None:
            if self._ef:
                m["codec_obs_rel_err"] = obs_metrics.codec_observed_error(
                    self._codec, flat_raw + state.codec_state,
                    quantized=flat_g)
                m["ef_resid_norm"] = obs_metrics.l2_norm(codec_state)
            else:
                m["codec_obs_rel_err"] = obs_metrics.codec_observed_error(
                    self._codec, flat_g)
        del flat_raw
        res = self.apply_grads(state, flat_g, codec_state, metrics=m)
        if m is not None:
            m["loss"] = loss
            obs_metrics.tap(loss, m)
        if self.cfg.collective.integrity_check:
            new, diag = res
            return new, dict(diag, loss=loss)
        return res, loss

    # -- telemetry ------------------------------------------------------------

    def obs_static_metrics(self) -> dict:
        """Static telemetry (``static_metrics``): flat layout, declared
        codec properties, wire bytes of one all-reduce, ``hier_plan``,
        and under ``codec="auto"`` the resolved plan (``tune``)."""
        if self._meta is None:
            raise RuntimeError("call init_state first")
        d = static_metrics(self.n, self.cfg.collective, self._codec,
                           self._meta.padded_len)
        if self._tuned_plan is not None:
            d["tune"] = self._tuned_plan.describe()
        return d

    # -- restore --------------------------------------------------------------

    def params_from_master(self, w_own: torch.Tensor) -> Params:
        """Working params rebuilt from the master shards by the step's own
        gather phase."""
        if self._meta is None:
            raise RuntimeError("call init_state first")
        multihost.refuse_processes("params_from_master")
        replicas = fused_update.all_gather_flat(w_own, self.cfg.collective)
        return self._rank0(*self._working(replicas[:1]))

    def restore_state(self, restored: dict, params_like=None) -> TrainState:
        """TrainState from a ``utils.checkpoint`` restore payload (JAX's
        stored layout: the global ``w_own`` and moments, ``step``).  The
        layout must be known: call ``init_state`` first or pass
        ``params_like`` (a params tree; only shapes and dtypes are read).
        The vectors are re-padded onto this rank count
        (``restored_rows``), the replicas rebuilt by the step's own gather
        phase (at step 0 laid as ``init_state`` lays them: ``_landed``),
        and the error-feedback residual restarts at zero, as in the JAX
        package."""
        multihost.refuse_processes("restore_state")
        if params_like is not None:
            self._ensure_meta(params_like)
        if self._meta is None:
            raise RuntimeError("flat layout unknown: call init_state "
                               "first or pass params_like")
        dev = self.ranks.device
        w_own = restored_rows(restored["w_own"], self._meta, self.n, dev)
        opt_state = {k: restored_rows(v, self._meta, self.n, dev)
                     for k, v in restored["opt_state"].items()}
        return self._landed(w_own, opt_state, int(restored["step"]),
                            self._init_codec_state())

    # -- live resharding (parallel.reshard) -----------------------------------

    def reshard_leaves(self, state: TrainState) -> dict:
        """The state's flat leaves in the shared transfer naming
        (``reshard.pack_state_leaves``): the masters and optimizer moments.
        The replicas are rebuilt from the landed masters, not moved, and
        the error-feedback residual rides its own per-rank plan.  A MoE
        router's side rows have no reshard (JAX's trainers hold no side
        leaves), so a state with them is refused."""
        from . import reshard as reshard_lib
        multihost.refuse_processes("a reshard")
        if state.side is not None:
            raise ValueError(
                "reshard moves the flat masters only: this state holds "
                "side leaves of another dtype (a MoE router), which the "
                "JAX package's reshard has no plan for; use "
                "checkpoint-restore")
        return reshard_lib.pack_state_leaves(state.w_own, state.opt_state)

    def state_from_reshard(self, leaves: dict, step: int,
                           codec_state: Optional[torch.Tensor]
                           ) -> TrainState:
        """This trainer's state from landed reshard leaves: the replicas
        rebuilt as a checkpoint restore rebuilds them (``_landed``), so a
        resharded state and a restored one are built identically (the
        bit-parity contract)."""
        from . import reshard as reshard_lib
        w_own, opt_state = reshard_lib.split_state_leaves(leaves)
        return self._landed(w_own, opt_state, int(step), codec_state)
