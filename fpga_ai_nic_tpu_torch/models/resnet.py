"""ResNet-50 for data-parallel training with sync-BN — the port of the JAX
package's ``models/resnet.py`` (BASELINE.json config 3, "ResNet-50 DP with
fused SGD").

Layouts are JAX's at every leaf and activation: filters HWIO, activations
NHWC.  ``from_jax_params`` is then a plain copy, and the flat gradient row
has JAX's order and layout, which sets the BFP blocks and the ranks'
chunks.  A convolution hands cuDNN permuted views: ``x.permute(0, 3, 1,
2)`` is NCHW with channels-last strides and ``w.permute(3, 2, 0, 1)`` is
OIHW; the gradient flows back into the HWIO leaves.  ``padding="SAME"`` is
asymmetric where the total padding is odd (the low side gets half of it,
rounded down: (2, 3) for the 7x7 stem on 224, (0, 1) for a 3x3 stride-2
conv or the max pool on an even side), so such an input is padded
explicitly; the max pool pads with -inf.

Batch norm follows JAX's formula and cast order: the moments in f32 over
(N, H, W), ``var = E[x^2] - E[x]^2``, ``rsqrt(var + eps)``, the normalised
value cast to the activation dtype and then scaled and shifted in that
dtype.  The head pools in f32, casts to the model dtype for the ``fc``
GEMM, and the loss is ``log_softmax`` in f32 averaged over the batch.

Sync-BN over the dp virtual ranks.  JAX's ``loss_fn(..., bn_axis="dp")``
inside ``shard_map`` averages every BN layer's moments over the ranks
(``lax.pmean``) and, with the params cast dp-varying before ``jax.grad``,
gives rank j the gradient d(sum_i loss_i)/d(theta_j): the cotangent of
every pooled moment is summed over all ranks before it reaches rank j's
activations, so no rank can be differentiated on its own, nor in two
passes with the moments' gradient all-reduced.  ``loss_fn_ranks`` runs
all n ranks in one forward (each rank's rows through its own replica's
leaves, a loop over the ranks inside each layer, the moments pooled at
every BN layer) and ``dp_loss_fn`` marks it ``joint_ranks`` for the
trainers, which take one backward of the summed losses
(``parallel.train.joint_grads``).  ``bn_axis="dp"`` anywhere else raises.

The pooling is one autograd function a BN layer, so its backward is
written out rather than left to autograd's accumulation order: each rank
gets its own copy of the pooled moments (and computes its variance and
scale from it), and the backward sums the copies' cotangents in rank
order, over n, into every rank's moments (``RankMoments``).  Across
processes (a process group of W > 1, one rank a process) each process
runs its one rank and a BN layer pools through ``ProcessMoments``: the
same forward over every rank's f32 ``[2, C]`` (mean and E[x^2]) gathered
in rank order (``ops.ring_procs.rank_gather``, the gloo group on CPU
copies), the same backward over the gathered cotangents, so the two
compute the same bits wherever each rank's own kernels do.  Every process
reaches the same exchanges in the same order: two a BN layer and step.

Running statistics are not part of the gradient step: ``compute_stats``
is an EMA calibration pass, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .bert import from_jax_params  # noqa: F401  (any tree of dicts/lists)

Params = Dict[str, Any]
# bn_fn(activations of each rank, BN params of each rank) -> normalised
BnFn = Callable[[List[torch.Tensor], List[Dict[str, torch.Tensor]]],
                List[torch.Tensor]]


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)   # ResNet-50
    width: int = 64                               # stem / stage-0 bottleneck
    num_classes: int = 1000
    dtype: str = "bfloat16"
    bn_eps: float = 1e-5
    bn_momentum: float = 0.9

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def resnet50(dtype: str = "bfloat16") -> "ResNetConfig":
        return ResNetConfig(dtype=dtype)

    @staticmethod
    def tiny(stage_sizes=(1, 1), width=8, num_classes=10,
             dtype="float32") -> "ResNetConfig":
        return ResNetConfig(stage_sizes=tuple(stage_sizes), width=width,
                            num_classes=num_classes, dtype=dtype)


# -- parameters ---------------------------------------------------------------

def _build(cfg: ResNetConfig, leaf: Callable[[str, Tuple[int, ...]], Any]
           ) -> Params:
    """The parameter tree with ``leaf(kind, shape)`` at each leaf, visited
    in the JAX ``init``'s order; kind is "conv" (HWIO), "scale", "bias"
    (a BN layer's), "fc_w" ([cin, classes]) or "fc_b"."""
    def bn(c: int) -> Dict[str, Any]:
        return {"scale": leaf("scale", (c,)), "bias": leaf("bias", (c,))}

    params: Params = {"stem": {"conv": leaf("conv", (7, 7, 3, cfg.width)),
                               "bn": bn(cfg.width)}, "stages": []}
    cin = cfg.width
    for s, n_blocks in enumerate(cfg.stage_sizes):
        mid = cfg.width * 2 ** s
        cout = 4 * mid
        blocks = []
        for b in range(n_blocks):
            blk = {"conv1": leaf("conv", (1, 1, cin, mid)), "bn1": bn(mid),
                   "conv2": leaf("conv", (3, 3, mid, mid)), "bn2": bn(mid),
                   "conv3": leaf("conv", (1, 1, mid, cout)), "bn3": bn(cout)}
            if b == 0:
                blk["proj"] = leaf("conv", (1, 1, cin, cout))
                blk["proj_bn"] = bn(cout)
            blocks.append(blk)
            cin = cout
        params["stages"].append(blocks)
    params["fc"] = {"w": leaf("fc_w", (cin, cfg.num_classes)),
                    "b": leaf("fc_b", (cfg.num_classes,))}
    return params


def init(generator: torch.Generator, cfg: ResNetConfig,
         device: DeviceLike = "cuda") -> Params:
    """He-normal filters (normal times sqrt(2 / fan_in), fan_in = kh kw
    cin), the fc weight at sqrt(1 / cin), BN scales one and biases zero;
    drawn in f32 on ``generator``'s device, cast to ``cfg.dtype``.  Torch's
    generator is not JAX's: carry JAX's weights with ``from_jax_params``."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype

    def leaf(kind: str, shape: Tuple[int, ...]) -> torch.Tensor:
        if kind in ("scale", "bias", "fc_b"):
            fill = torch.ones if kind == "scale" else torch.zeros
            return fill(shape, dtype=dt, device=dev)
        std = (math.sqrt(2.0 / math.prod(shape[:3])) if kind == "conv"
               else math.sqrt(1.0 / shape[0]))
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (w * std).to(dev, dt)
    return _build(cfg, leaf)


def num_params(cfg: ResNetConfig) -> int:
    """Parameter count, from the shapes alone (no weights are built)."""
    sizes: List[int] = []
    _build(cfg, lambda kind, shape: sizes.append(math.prod(shape)))
    return sum(sizes)


# -- layers -------------------------------------------------------------------

def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one side: the total that gives ceil(size /
    stride) outputs, the low side half of it rounded down."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated(x, w, (stride, stride), "SAME",
    ("NHWC", "HWIO", "NHWC"))``: x [N, H, W, Cin], w [kh, kw, Cin, Cout]."""
    (top, bottom) = _same_pads(x.shape[1], w.shape[0], stride)
    (left, right) = _same_pads(x.shape[2], w.shape[1], stride)
    xc = x.permute(0, 3, 1, 2)
    if top == bottom and left == right:
        pad: Any = (top, left)
    else:
        xc = F.pad(xc, (left, right, top, bottom))
        pad = 0
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """``lax.reduce_window(x, -inf, lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
    "SAME")`` on NHWC."""
    (top, bottom) = _same_pads(x.shape[1], 3, 2)
    (left, right) = _same_pads(x.shape[2], 3, 2)
    xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom),
               value=float("-inf"))
    return F.max_pool2d(xc, 3, 2).permute(0, 2, 3, 1)


def _pool(parts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ranks' ``[n, 2, C]`` moments -> the pooled (mean, m2), each the
    mean over the ranks of a contiguous ``[n, C]``, as ``lax.pmean``."""
    return parts[:, 0].contiguous().mean(0), parts[:, 1].contiguous().mean(0)


def _rank_sum(parts: torch.Tensor) -> torch.Tensor:
    """``[n, 2, C]`` cotangents summed in rank order."""
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    return acc


class RankMoments(torch.autograd.Function):
    """A BN layer's moments pooled over this process's n ranks:
    ``apply(local_0, ..., local_{n-1})`` (each ``[2, C]``: mean and E[x^2])
    -> ``(mean_0, m2_0, ..., mean_{n-1}, m2_{n-1})``, rank i's copy of
    the pooled moments; backward: the copies' cotangents summed in rank
    order, over n, into every rank's moments."""

    @staticmethod
    def forward(ctx, *local: torch.Tensor):
        mean, m2 = _pool(torch.stack(local))
        return tuple(t.clone() for _ in local for t in (mean, m2))

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        n = len(grads) // 2
        g = _rank_sum(torch.stack([torch.stack(grads[2 * i:2 * i + 2])
                                   for i in range(n)])) / n
        return (g,) * n


class ProcessMoments(torch.autograd.Function):
    """``RankMoments`` over the W processes of the group, one rank a
    process (the module docstring): ``apply(local [2, C], W) -> (mean,
    m2)``, this rank's copy."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, world: int):
        from ..ops import ring_procs
        ctx.world = world
        return _pool(ring_procs.rank_gather(local, world))

    @staticmethod
    def backward(ctx, g_mean: torch.Tensor, g_m2: torch.Tensor):
        from ..ops import ring_procs
        parts = ring_procs.rank_gather(torch.stack([g_mean, g_m2]),
                                       ctx.world)
        return _rank_sum(parts) / ctx.world, None


def _bn(xs: List[torch.Tensor], bns: List[Dict[str, torch.Tensor]],
        cfg: ResNetConfig, stats: Optional[Dict[str, torch.Tensor]] = None,
        world: int = 1) -> List[torch.Tensor]:
    """One BN layer over the ranks' activations ``xs`` (each rank with its
    own ``bns`` entry).  Train mode (``stats`` None): each rank's f32
    moments over (N, H, W), averaged over the ranks as ``lax.pmean``
    averages them (``RankMoments``; one rank: its own moments), and with
    ``world`` > 1 over the processes' ranks (``ProcessMoments``; ``xs``
    this process's one rank).  Eval mode: the given running statistics,
    shared."""
    xfs = [x.to(torch.float32) for x in xs]
    if stats is not None:
        pooled = [(stats["mean"], stats["var"], None)] * len(xs)
    else:
        local = [torch.stack([xf.mean((0, 1, 2)), xf.square().mean((0, 1, 2))])
                 for xf in xfs]
        if world > 1:
            (loc,) = local
            moments = ProcessMoments.apply(loc, world)
        else:
            moments = RankMoments.apply(*local)
        pooled = [(moments[2 * i], None, moments[2 * i + 1])
                  for i in range(len(xs))]
    out = []
    for x, xf, bn, (mean, var, m2) in zip(xs, xfs, bns, pooled):
        if var is None:
            var = m2 - mean.square()
        inv = torch.rsqrt(var + cfg.bn_eps)
        out.append(((xf - mean) * inv).to(x.dtype) * bn["scale"] + bn["bias"])
    return out


def _relu(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.relu(x) for x in xs]


def _convs(xs, blks, key: str, stride: int = 1) -> List[torch.Tensor]:
    return [_conv(x, blk[key], stride) for x, blk in zip(xs, blks)]


# -- forward ------------------------------------------------------------------

def _forward(ps: Sequence[Params], xs: Sequence[torch.Tensor],
             cfg: ResNetConfig, bn_fn: BnFn) -> List[torch.Tensor]:
    """The one source of the network's topology, over n ranks: rank i's
    images ``xs[i]`` [b, H, W, 3] through its parameters ``ps[i]`` -> its
    logits.  Each layer runs rank by rank; ``bn_fn`` is called once per BN
    layer with every rank's activations, in a fixed visit order (stem,
    then per block bn1..bn3 and, on block 0 of each stage, proj_bn):
    ``init_stats`` and ``compute_stats`` rely on that order."""
    dt = cfg.torch_dtype
    hs = [_conv(x.to(dt), p["stem"]["conv"], 2) for x, p in zip(xs, ps)]
    hs = _relu(bn_fn(hs, [p["stem"]["bn"] for p in ps]))
    hs = [_max_pool(h) for h in hs]
    for s, blocks in enumerate(ps[0]["stages"]):
        for b, blk0 in enumerate(blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            blks = [p["stages"][s][b] for p in ps]

            def bn(xs_, key, blks=blks):
                return bn_fn(xs_, [blk[key] for blk in blks])
            r = _relu(bn(_convs(hs, blks, "conv1"), "bn1"))
            r = _relu(bn(_convs(r, blks, "conv2", stride), "bn2"))
            r = bn(_convs(r, blks, "conv3"), "bn3")
            if "proj" in blk0:
                hs = bn(_convs(hs, blks, "proj", stride), "proj_bn")
            hs = [torch.relu(h + rr) for h, rr in zip(hs, r)]
    return [h.to(torch.float32).mean((1, 2)).to(dt) @ p["fc"]["w"]
            + p["fc"]["b"] for h, p in zip(hs, ps)]


def _single_rank(bn_axis: Optional[str]) -> None:
    if bn_axis is not None:
        raise ValueError(
            f"bn_axis={bn_axis!r}: sync-BN pools the moments of every rank "
            "in one graph; use loss_fn_ranks (dp_loss_fn for the trainers), "
            "never a per-rank loss")


def apply(params: Params, x: torch.Tensor, cfg: ResNetConfig, *,
          bn_axis: Optional[str] = None,
          stats: Optional[Dict] = None) -> torch.Tensor:
    """x: [B, H, W, 3] -> logits [B, num_classes].  Train mode: ``stats``
    None (the batch's moments).  Eval: the stats tree of
    ``compute_stats``.  ``bn_axis`` other than None raises (see
    ``loss_fn_ranks``)."""
    _single_rank(bn_axis)
    st = iter(stats["bn"]) if stats is not None else None
    return _forward([params], [x], cfg, lambda hs, bns: _bn(
        hs, bns, cfg, next(st) if st is not None else None))[0]


def _xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logz = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -logz.gather(-1, y.long()[:, None])[:, 0].mean()


def loss_fn(params: Params, batch, cfg: ResNetConfig, *,
            bn_axis: Optional[str] = None) -> torch.Tensor:
    """Softmax cross-entropy; batch = (images [B, H, W, 3], labels [B])."""
    x, y = batch
    return _xent(apply(params, x, cfg, bn_axis=bn_axis), y)


def loss_fn_ranks(params_per_rank: Sequence[Params], batch,
                  cfg: ResNetConfig, world: int = 1) -> torch.Tensor:
    """Every rank's loss [n] with sync-BN over the n ranks, as JAX's
    ``loss_fn(p, b, cfg, bn_axis="dp")`` gives it inside ``shard_map``:
    batch = (images [n, b, H, W, 3], labels [n, b]); rank i's rows go
    through ``params_per_rank[i]``, and every BN layer normalises with the
    mean over the ranks of their moments (the shards are equal).  With
    ``world`` W > 1 this process holds one rank of W processes' (n = 1)
    and the moments pool over the processes (``ProcessMoments``)."""
    x, y = batch
    logits = _forward(list(params_per_rank), list(x), cfg,
                      lambda hs, bns: _bn(hs, bns, cfg, world=world))
    return torch.stack([_xent(lg, yi) for lg, yi in zip(logits, y)])


def dp_loss_fn(cfg: ResNetConfig, sync: bool = True) -> Callable:
    """The trainers' sync-BN loss: ``(params_per_rank, batch) -> [n]``,
    marked ``joint_ranks`` so ``DPTrainer`` and ``DDPTrainer``
    differentiate all ranks in one graph.  Built under a process group of
    W > 1 its BN layers pool across the processes (``loss.processes`` =
    W, which the trainers read); ``sync=False`` there gives each process
    its own rank's moments, no exchange: the fault control of the
    cross-process checks."""
    from ..parallel import multihost
    world = multihost.world_size()

    def loss(params_per_rank, batch):
        return loss_fn_ranks(params_per_rank, batch, cfg,
                             world if sync else 1)
    loss.joint_ranks = True
    loss.processes = world
    return loss


# -- eval statistics ----------------------------------------------------------

def init_stats(cfg: ResNetConfig, device: DeviceLike = "cuda") -> Dict:
    """Zeroed means and unit variances, one entry per BN layer in the
    shared forward's visit order (found by running ``_forward`` on meta
    tensors, so it cannot drift from the topology)."""
    dev = resolve_device(device)
    chans: List[int] = []

    def probe(hs, bns):
        chans.append(hs[0].shape[-1])
        return hs
    meta = _build(cfg, lambda kind, shape: torch.empty(
        shape, dtype=cfg.torch_dtype, device="meta"))
    _forward([meta], [torch.empty((1, 32, 32, 3), device="meta")], cfg,
             probe)
    return {"bn": [{"mean": torch.zeros((c,), device=dev),
                    "var": torch.ones((c,), device=dev)} for c in chans]}


@torch.no_grad()
def compute_stats(params: Params, x: torch.Tensor, cfg: ResNetConfig,
                  stats: Dict) -> Dict:
    """One EMA calibration step of the running statistics on a batch: the
    shared forward in train mode, each BN layer's batch moments captured
    in visit order."""
    captured = []

    def capture(hs, bns):
        hf = hs[0].to(torch.float32)
        mean = hf.mean((0, 1, 2))
        st = {"mean": mean,
              "var": hf.square().mean((0, 1, 2)) - mean.square()}
        captured.append(st)
        return _bn(hs, bns, cfg, st)

    _forward([params], [x], cfg, capture)
    m = cfg.bn_momentum
    return {"bn": [{k: m * old[k] + (1 - m) * cap[k] for k in ("mean", "var")}
                   for old, cap in zip(stats["bn"], captured)]}
