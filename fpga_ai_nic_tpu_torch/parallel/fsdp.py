"""Fully sharded data parallelism (ZeRO-3) over virtual fsdp ranks — the port
of the JAX package's ``parallel/fsdp.py`` (``FSDPTrainer``).

The ZeRO-1 trainer (``parallel.train.DPTrainer``) keeps every rank's working
replica between steps.  ZeRO-3 drops it: each rank persistently holds only
its f32 master shard ``[C]`` and optimizer shard (stacked ``[n, C]``); the
full parameters exist only inside the step, gathered on use:

    flat   = all_gather(w_own)            # [n, L] transient replicas
    params = unflatten(flat[i])           # rank i's model-dtype leaves
    loss   = loss_fn(params, batch[i])    # every rank, one graph
    ct     = d(sum_i loss_i)/d(flat)      # [n, L] f32 cotangent
    g_sum  = reduce_scatter(ct)           # the gather's transpose
    w_own' = opt(w_own, g_sum / n)

The gather is ``fused_update.all_gather_flat`` (the ``ring_ag`` kernel on
the fused route), run once a step without autograd; each rank's leaves
are cut from its gathered row (``_RankLeaves``), whose backward writes
every leaf's gradient into one ``[n, L_pad]`` f32 cotangent.  The
reduce-scatter of that cotangent (the ``ring_rs`` kernel without an
optimizer) is the gather's transpose, JAX's ``all_gather_flat_vjp``
written out.  With ``accum_steps > 1`` (JAX: the loss accumulated under
one gather, ``accum.accumulated_loss``) each microbatch's cotangent is
added in f32 into microbatch 0's, the sum is scaled by
``1 / accum_steps`` (``accum.accumulate``) and reduce-scattered once: one
``ring_ag`` and one ``ring_rs`` a step at every ``accum_steps``.  No
gather of updated weights follows the update: the next step's gather
reads the new shards.  The gather runs in f32 (master precision), as in
JAX.  With a compressed ring the loss is taken at the quantized parameters
while the update goes to the exact masters (straight-through).

A codec that declares error feedback (top-k) takes the explicit route of
JAX's ``shard_step_ef``: each rank's gradient with respect to its gathered
row (``parallel.train.rank_grads``, accumulated the same way), the
compensate-then-compress ``fused_update.error_feedback_encode`` once a
step, then ``reduce_scatter_update`` or ``reduce_scatter``; the residual
rides in ``FSDPState.codec_state``.

Parity contract (tests/test_torch_fsdp.py, tests/test_torch_accum.py): the
losses and masters of the port's ZeRO-1 ``DPTrainer`` on the same model,
batch and optimizer, and of JAX's ``FSDPTrainer``.  ``restore_state``
takes a ``utils.checkpoint`` payload (JAX's stored layout, re-padded onto
this rank count); ``reshard_leaves`` / ``state_from_reshard`` carry a live
move (``parallel.reshard``).  ``obs_metrics=True`` taps ``loss`` and
``grad_norm`` (and, with error feedback, ``codec_obs_rel_err`` and
``ef_resid_norm``) to the active sink, JAX's keys.  ``codec="auto"``
resolves once at ``init_state`` (``tune``, as JAX's ``_resolve_auto``).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from . import accum, multihost
from .mesh import VirtualRanks
from .train import codec_flags, rank_grads, restored_rows, static_metrics
from .. import optim
from ..obs import metrics as obs_metrics
from ..ops import fused_update
from ..utils.config import OptimizerSpec, TrainConfig

Params = Any


class FSDPState(NamedTuple):
    w_own: torch.Tensor         # [n, C] f32 master shards
    opt_state: optim.OptState   # {key: [n, C]} optimizer state shards
    step: int
    # error-feedback residual of the codec, each rank's full [L_pad]
    # dropped-gradient carry ([n, L_pad]; None without an EF codec)
    codec_state: Optional[torch.Tensor] = None


class _RankLeaves(torch.autograd.Function):
    """Gathered rows ``[n, L_pad]`` -> every rank's leaves (rank-major, in
    tree order, cast to the leaves' dtypes), as JAX's ``unflatten_tree``
    of each device's gathered vector.  The backward writes all the leaves'
    gradients into one ``[n, L_pad]`` f32 cotangent (zeros in the padding
    and for unused leaves), so the gather's backward gets its cotangent in
    one buffer instead of one full-size buffer a leaf."""

    @staticmethod
    def forward(ctx, flat: torch.Tensor, meta: fused_update.FlatMeta
                ) -> Tuple[torch.Tensor, ...]:
        ctx.meta = meta
        ctx.n = flat.shape[0]
        return tuple(leaf for i in range(flat.shape[0])
                     for leaf in fused_update.tree_leaves(
                         fused_update.unflatten_tree(flat[i], meta)))

    @staticmethod
    def backward(ctx, *grads: Optional[torch.Tensor]):
        meta, n = ctx.meta, ctx.n
        ref = next(g for g in grads if g is not None)
        ct = torch.empty((n, meta.padded_len), dtype=torch.float32,
                         device=ref.device)
        k = len(meta.keys)
        for i in range(n):
            leaves = [g if g is not None else torch.zeros(
                shape, dtype=torch.float32, device=ref.device)
                for g, shape in zip(grads[i * k:(i + 1) * k], meta.shapes)]
            fused_update.flatten_leaves(leaves, meta, out=ct[i])
        return ct, None


class FSDPTrainer:
    """``loss_fn(params, batch) -> scalar`` over n virtual fsdp ranks (or a
    loss marked ``joint_ranks`` over all ranks at once: ``loss_fn(
    params_per_rank, batch) -> [n]``).  Batch leaves split over the ranks
    (ZeRO-3 is still data parallelism); the parameters never exist
    replicated outside the step."""

    def __init__(self, loss_fn: Callable, ranks: VirtualRanks,
                 cfg: TrainConfig):
        multihost.refuse_processes("FSDPTrainer")
        if (cfg.mesh.fsdp != ranks.n or cfg.mesh.nproc != ranks.n
                or (ranks.sp, ranks.ep, ranks.pp) != (1, 1, 1)):
            raise ValueError(f"cfg.mesh ({cfg.mesh}) does not describe "
                             f"{ranks.n} fsdp ranks alone")
        coll = cfg.collective
        if coll.fused_optimizer and cfg.optimizer.clip_norm is not None:
            raise ValueError(
                "fused_optimizer cannot honor clip_norm (same contract as "
                "DPTrainer: no barrier between reduce and update)")
        if coll.integrity_check:
            raise ValueError(
                "integrity_check is implemented on DPTrainer only (both "
                "value and exact wire tiers ride its step diag); "
                "FSDPTrainer does not thread the verdicts, as in the JAX "
                "package: construct with integrity_check=False")
        self.loss_fn = loss_fn
        self.ranks = ranks
        self.n = ranks.n
        self.cfg = cfg
        # codec="auto": resolved once at init_state (tune), as DPTrainer's
        # (JAX's FSDPTrainer takes no live calibration)
        self._tuned_plan = None
        self._codec, self._ef = codec_flags(coll)
        self._meta: Optional[fused_update.FlatMeta] = None

    @property
    def batch_spec(self) -> Tuple[str, ...]:
        """The mesh axes a batch leaf's leading axis splits over (JAX's
        ``P("fsdp")``)."""
        return ("fsdp",)

    def _require_meta(self) -> fused_update.FlatMeta:
        if self._meta is None:
            raise RuntimeError("call init_state first")
        return self._meta

    # -- init -----------------------------------------------------------------

    def _resolve_auto(self, params_like) -> None:
        """The one resolution of a ``codec="auto"`` template (a no-op
        otherwise), priced at the padded length."""
        from .. import tune as tune_lib
        if tune_lib.needs_autotune(self.cfg.collective):
            self.cfg, self._tuned_plan = tune_lib.resolve_train_config(
                self.cfg, self.n, params_like, padded=True)
            self._codec, self._ef = codec_flags(self.cfg.collective)

    def _ensure_meta(self, params_like) -> None:
        """The flat layout of a params tree (shapes and dtypes only),
        resolving ``codec="auto"`` first."""
        self._resolve_auto(params_like)
        self._meta = fused_update.flat_meta(params_like,
                                            self.cfg.collective, self.n)

    def _init_codec_state(self) -> Optional[torch.Tensor]:
        """Zeroed per-rank error-feedback residuals [n, L_pad]."""
        if not self._ef:
            return None
        return self._codec.state_init((self.n, self._meta.padded_len),
                                      self.ranks.device)

    def init_state(self, params: Params) -> FSDPState:
        """Split replicated params into the ranks' master shards: the only
        copy that outlives the call (the ZeRO-3 memory claim)."""
        self._resolve_auto(params)
        coll, opt_cfg = self.cfg.collective, self.cfg.optimizer
        params = fused_update.tree_map(lambda t: t.to(self.ranks.device),
                                       params)
        w_own, opt_state, meta = fused_update.init_master_shard(
            params, coll, opt_cfg, self.n)
        self._meta = meta
        return FSDPState(w_own, opt_state, 0, self._init_codec_state())

    def shard_batch(self, batch) -> Tuple[torch.Tensor, ...]:
        """[B, ...] host tensors -> [n, B/n, ...] on the ranks' device."""
        return self.ranks.shard_batch(batch)

    # -- step -----------------------------------------------------------------

    def _losses(self, flat: torch.Tensor, batch) -> torch.Tensor:
        """[n] per-rank losses at the gathered rows (one graph)."""
        meta = self._meta
        leaves = _RankLeaves.apply(flat, meta)
        k = len(meta.keys)
        trees = [fused_update.tree_from_leaves(
            meta.keys, list(leaves[i * k:(i + 1) * k]))
            for i in range(self.n)]
        if getattr(self.loss_fn, "joint_ranks", False):
            return self.loss_fn(trees, batch)
        return torch.stack([self.loss_fn(t, tuple(b[i] for b in batch))
                            for i, t in enumerate(trees)])

    def _update(self, state: FSDPState, g_sum: torch.Tensor
                ) -> Tuple[torch.Tensor, optim.OptState]:
        """The owned shards' update from the summed gradient shards: the
        fused formula, or the clip and the unfused optimizer on g_sum / n."""
        opt_cfg = self.cfg.optimizer
        if self.cfg.collective.fused_optimizer:
            return optim.fused_apply_flat(
                OptimizerSpec.from_optimizer(opt_cfg), state.w_own, g_sum,
                state.opt_state,
                optim.fused_hyperparams(opt_cfg, state.step,
                                        device=g_sum.device), self.n)
        g_own = optim.clip_by_global_norm(opt_cfg, g_sum / self.n)
        return optim.apply(opt_cfg, state.w_own, g_own, state.opt_state,
                           state.step)

    def _metrics(self) -> Optional[dict]:
        """A dict for the step's metrics under ``obs_metrics`` with an
        active sink, else None (nothing computed)."""
        return ({} if self.cfg.obs_metrics
                and obs_metrics.active_sink() is not None else None)

    def step(self, state: FSDPState, batch) -> Tuple[FSDPState,
                                                     torch.Tensor]:
        """One step: ``(new state, mean loss)``."""
        self._require_meta()
        if self._ef:
            return self._step_ef(state, batch)
        m = self._metrics()
        coll = self.cfg.collective
        # all-gather on use; the reduce-scatter of the summed cotangent
        # lands the summed gradients on the owning shards
        flat = fused_update.all_gather_flat(state.w_own, coll).detach() \
            .requires_grad_()

        def one(mb, into):
            losses = self._losses(flat, mb)
            (ct,) = torch.autograd.grad(losses.sum(), [flat])
            if into is not None:
                ct = into.add_(ct)
            return ct, losses.detach()

        ct, losses = accum.accumulate(one, batch, self.cfg.accum_steps)
        del flat
        g_sum = fused_update.reduce_scatter(ct, coll)
        del ct
        if m is not None:
            m["grad_norm"] = obs_metrics.l2_norm(g_sum / self.n)
        w_new, opt_state = self._update(state, g_sum)
        loss = losses.mean()
        if m is not None:
            m["loss"] = loss
            obs_metrics.tap(loss, m)
        return (FSDPState(w_new, opt_state, state.step + 1,
                          state.codec_state), loss)

    def _step_ef(self, state: FSDPState, batch):
        """The error-feedback variant: the gradient collective is explicit
        so the full local cotangent is compensated and re-quantized before
        the per-hop-compressed reduce-scatter."""
        coll = self.cfg.collective
        flat = fused_update.all_gather_flat(state.w_own, coll)
        meta = self._meta

        def one(mb, into):
            write = None if into is None else (
                lambda i, gs: accum.add_leaves(gs, meta, into[i]))
            flat_g, loss = rank_grads(self.loss_fn, flat, meta, mb, write)
            return (into if flat_g is None else flat_g), loss

        flat_g, loss = accum.accumulate(one, batch, self.cfg.accum_steps)
        del flat
        g_wire, resid = fused_update.error_feedback_encode(
            self._codec, flat_g, state.codec_state)
        m = self._metrics()
        if m is not None:
            m["codec_obs_rel_err"] = obs_metrics.codec_observed_error(
                self._codec, flat_g + state.codec_state, quantized=g_wire)
            m["ef_resid_norm"] = obs_metrics.l2_norm(resid)
        del flat_g
        if coll.fused_optimizer:
            g_sum, w_new, opt_state = fused_update.reduce_scatter_update(
                g_wire, state.w_own, state.opt_state, state.step, coll,
                self.cfg.optimizer)
            if m is not None:
                m["grad_norm"] = obs_metrics.l2_norm(g_sum / self.n)
        else:
            g_own = fused_update.reduce_scatter(g_wire, coll) / self.n
            if m is not None:
                m["grad_norm"] = obs_metrics.l2_norm(g_own)
            g_own = optim.clip_by_global_norm(self.cfg.optimizer, g_own)
            w_new, opt_state = optim.apply(self.cfg.optimizer, state.w_own,
                                           g_own, state.opt_state,
                                           state.step)
        if m is not None:
            m["loss"] = loss
            obs_metrics.tap(loss, m)
        return FSDPState(w_new, opt_state, state.step + 1, resid), loss

    # -- telemetry and materialization ----------------------------------------

    def obs_static_metrics(self) -> dict:
        """The same statics (and keys) as JAX's FSDPTrainer: ZeRO-3's wire
        volume a step, one all-gather and one reduce-scatter, is the one
        all-reduce the accounting counts."""
        d = static_metrics(self.n, self.cfg.collective, self._codec,
                           self._require_meta().padded_len)
        d.pop("hier_plan", None)
        if self._tuned_plan is not None:
            d["tune"] = self._tuned_plan.describe()
        return d

    def gathered_params(self, state: FSDPState) -> Params:
        """The parameter tree gathered from the master shards (rank 0's
        replica; every rank's is bitwise equal), for eval or export:
        training never holds it between steps."""
        meta = self._require_meta()
        flat = fused_update.all_gather_flat(state.w_own,
                                            self.cfg.collective)
        return fused_update.unflatten_tree(flat[0].clone(), meta)

    def restore_state(self, restored: dict, params_like=None) -> FSDPState:
        """FSDPState from a ``utils.checkpoint`` restore payload (the same
        stored layout as the ZeRO-1 trainers': the global ``w_own`` and
        moments, ``step``), re-padded onto this rank count; the
        error-feedback residual restarts at zero.  The layout must be
        known: call ``init_state`` first or pass ``params_like``."""
        if params_like is not None:
            self._ensure_meta(params_like)
        meta = self._require_meta()
        dev = self.ranks.device
        return FSDPState(
            restored_rows(restored["w_own"], meta, self.n, dev),
            {k: restored_rows(v, meta, self.n, dev)
             for k, v in restored["opt_state"].items()},
            int(restored["step"]), self._init_codec_state())

    # -- live resharding (parallel.reshard) -----------------------------------

    def reshard_leaves(self, state: FSDPState) -> dict:
        """The state's flat leaves in the shared transfer naming; ZeRO-3
        holds no replicas, so the masters and moments are the whole
        state (the residual rides its own plan)."""
        from . import reshard as reshard_lib
        return reshard_lib.pack_state_leaves(state.w_own, state.opt_state)

    def state_from_reshard(self, leaves: dict, step: int,
                           codec_state: Any) -> FSDPState:
        from . import reshard as reshard_lib
        w_own, opt_state = reshard_lib.split_state_leaves(leaves)
        return FSDPState(w_own, opt_state, int(step), codec_state)


__all__: List[str] = ["FSDPState", "FSDPTrainer"]
