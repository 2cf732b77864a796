"""Unified configuration system of the PyTorch/CUDA port.

A copy of the JAX package's ``utils/config.py``: the same dataclasses with
the same fields, defaults and validation, so one set of ``--dotted.key=value``
flags drives both packages (``from_flags``).  Field comments that name
Pallas or the TPU describe the reference package; in this port
``BFPConfig.codec="pallas"`` selects the "sublane" block layout, which the
CUDA kernels of ``ops.bfp_cuda`` / ``ops.ring_cuda`` implement.

``BFPConfig(codec="auto")`` (and int8's ``backend="auto"``) picks the
sublane CUDA kernels for a CUDA payload of whole (block, 128)-lane tiles
and the flat16 ops otherwise (``compress.bfp.use_pallas``).  Values this
port does not implement yet raise ``NotImplementedError`` at trainer
construction (in-graph metrics; mesh axes a trainer does not take),
never silently.  ``CollectiveConfig(codec="auto")`` is the
autotuner (``tune``), resolved by the trainers.
``collective.integrity_check`` is ported on ``DPTrainer``;
``ShardedTrainer`` refuses it with ``ValueError``, as the JAX package's
does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


@dataclass(frozen=True)
class BFPConfig:
    """Block-floating-point wire format.

    Mirrors the reference codec's parameterization (NUM, EXPONENT_SIZE,
    MANTISSA_SIZE, NX_MODE — hw/bf16_to_bfp_core.sv:30-34) with TPU-friendly
    storage: per-block int8 mantissas plus one int8 power-of-two scale
    exponent, value = mantissa * 2**scale_exp.  With block_size=16 and 8-bit
    mantissas this is bit-rate-identical to the reference's 136b-per-512b
    frame (hw/bfp_adapter.sv:63-77): 3.76x over f32, 1.88x over bf16.

    rounding:
      - "nearest": round-to-nearest-even (default; better accuracy than HW)
      - "rtz":     truncate toward zero, mirroring the RTL barrel-shifter
                   truncation (hw/bf16_to_bfp_core.sv:108-125) for parity
                   tests against the golden model.
    """

    block_size: int = 16          # NUM_FP (hw/all_reduce.sv:746)
    mantissa_bits: int = 8        # MANT_SIZE (hw/all_reduce.sv:746)
    rounding: str = "nearest"     # "nearest" | "rtz"
    # codec backend for the ring's per-hop encode/decode:
    #   "xla":    ops.bfp (block = consecutive elements, the reference's
    #             flat16 grouping) — the default: bit-exact vs
    #             ops.ring_golden on every platform.
    #   "pallas": ops.bfp_pallas (block = lane column, elements LANES
    #             apart) — the fused-kernel fast path for TPU.
    #   "auto":   pallas on TPU when the payload tiles onto (block, 128)
    #             lanes, xla elsewhere.
    # Every codec is bit-exact vs ops.bfp_golden under its own layout, but
    # the *block partition* differs between xla and pallas, so cross-codec
    # results differ by quantization grouping (same wire bytes, same error
    # bound).  "xla" stays the default so golden-compare guarantees hold
    # unchanged on TPU; opt into "auto"/"pallas" for wire-path speed.
    codec: str = "xla"

    def __post_init__(self) -> None:
        assert self.block_size >= 2 and self.block_size & (self.block_size - 1) == 0
        assert 2 <= self.mantissa_bits <= 8
        assert self.rounding in ("nearest", "rtz")
        assert self.codec in ("auto", "xla", "pallas")

    @property
    def compression_ratio_vs_f32(self) -> float:
        raw = 32 * self.block_size
        packed = self.mantissa_bits * self.block_size + 8
        return raw / packed


@dataclass(frozen=True)
class OptimizerSpec:
    """STATIC shape of a fused in-kernel optimizer — what the Pallas ring
    kernels specialize on (state operand count, update formula), as
    opposed to the hyperparameters, which ride the kernel as SMEM scalars
    (``optim.fused_hyperparams``) so an lr/schedule change never
    recompiles.  The reference bakes even the lr into RTL
    (hw/weight_update.sv:439-452); we bake only the FORMULA.

    kinds: "sgd" (stateless), "momentum" (1 state vector m),
    "adamw" (2 state vectors m, v).  Weight decay / schedules / bias
    correction are all dynamic scalars, never spec."""

    kind: str = "sgd"             # "sgd" | "momentum" | "adamw"

    def __post_init__(self) -> None:
        assert self.kind in ("sgd", "momentum", "adamw"), self.kind

    @property
    def state_keys(self) -> Tuple[str, ...]:
        """Optimizer-state slot names, in kernel operand order."""
        return {"sgd": (), "momentum": ("m",),
                "adamw": ("m", "v")}[self.kind]

    @property
    def n_state(self) -> int:
        return len(self.state_keys)

    @classmethod
    def from_optimizer(cls, opt: "OptimizerConfig") -> "OptimizerSpec":
        return cls(kind=opt.kind)


@dataclass(frozen=True)
class CollectiveConfig:
    """All-reduce engine configuration.

    slice_elems generalizes the reference's fixed 32 KiB ring slice
    (BUF_SIZE=512 cache lines, hw/all_reduce.sv:101-103); max_inflight
    mirrors the 8-deep collective queue with round-robin done IDs
    (hw/all_reduce.sv:1228,1373; readme.pdf §2.1).

    impl:
      - "xla":  lax.psum_scatter / all_gather — XLA schedules and overlaps.
      - "ring": explicit ppermute ring (the st_eth_t analogue); required for
                on-the-wire BFP compression.
    """

    impl: str = "xla"             # "xla" | "ring"
    compression: Optional[BFPConfig] = None
    # named gradient-compression codec (the JAX package's compress registry:
    # "bfp" | "topk" | "int8" | any registered plugin) with constructor
    # options as a (key, value) pair tuple — kept hashable so the frozen
    # config stays usable as a cache key:
    #   CollectiveConfig(impl="ring", codec="topk",
    #                    codec_opts=(("k", 32), ("bucket_elems", 256)))
    # codec=None + compression=BFPConfig(...) is the legacy BFP spelling
    # (still fully supported); codec="bfp" may combine with compression=
    # to reuse a BFPConfig.  Unknown names fail HERE, at construction,
    # with the registered list — not at first collective trace.
    #
    # codec="auto" defers the choice to the trace-time autotuner
    # (the JAX package's tune): the trainer resolves codec, pipeline_depth,
    # bucket_elems and topology ONCE at construction from the ring_cost
    # model parameterized by calibrated (banked-artifact) rates, then
    # trains on the resolved static config — no trace-time capture, and
    # the chosen plan is banked into obs_static_metrics() for obs-gate
    # to diff across PRs.  See docs/TUNING.md.
    codec: Optional[str] = None
    codec_opts: Tuple[Tuple[str, Any], ...] = ()
    # launch-ahead depth D of the fused Pallas ring's slice schedule
    # (ops.ring_pallas pipeline_depth: encode slice g+D while D RDMAs are
    # in flight).  None = the kernel's default (_PIPE_DEPTH, capped by
    # the slice plan); the autotuner owns it under codec="auto".  A
    # schedule choice, never a numerics choice.
    pipeline_depth: Optional[int] = None
    # collective topology over the (flat) axis:
    #   "flat":  the 1-D ring (the reference's only shape).
    #   "hier":  2-stage hierarchical (intra x inter) collectives
    #            (ops.ring_hier): full-precision reduce over the declared
    #            FAST intra factor first, then the codec ring only on the
    #            SLOW inter hop — EQuARX's quantize-only-the-slow-phase
    #            trick (arXiv:2506.17615).  Requires impl="ring" and
    #            intra_size > 1 dividing the axis size; codec applies to
    #            the inter hop ONLY (graftlint J9 pins the intra hop
    #            codec-free and both hops' bytes to the plan).
    topology: str = "flat"
    # declared intra/inter factorization of the flat axis for
    # topology="hier": the axis's n devices are ni = intra_size
    # consecutive ranks per fast group (device d -> group d // ni,
    # position d % ni), matching a dp x tp-style mesh flattened
    # major-to-minor.  0 = undeclared (required for "hier" unless the
    # autotuner owns the choice under codec="auto").
    intra_size: int = 0
    # run the compressed ring through the single fused Pallas kernel
    # (ops.ring_pallas: encode-into-hop with RDMA overlap) instead of the
    # separate encode/ppermute/decode XLA ops.  Implies the lane-layout
    # ("pallas") block partition; payloads are padded to (block*128)-lane
    # tiles per device chunk (ops.fused_update.pad_multiple); large
    # payloads stream HBM->VMEM through a fixed working set (resident /
    # streaming / segmented routing is automatic by size).
    #
    # Validation status: bit-exactness and the full flow-control protocol
    # (neighbor barrier + credit window) are exercised on every CI run —
    # the discharge-interpreter sweep and the threaded-interpreter
    # TestFlowControl battery in tests/test_ring_pallas.py — but the
    # kernels have NOT yet run on multi-chip ICI hardware.  Before first
    # production use on a real multi-chip mesh, run the hardware canary
    # (tools/first_contact.py stage 'canary', or loopback_microbench /
    # loopback_gather_microbench directly) on one chip of that platform.
    fused_kernel: bool = False
    # fuse the optimizer update into the gradient reduce-scatter (the
    # reference's weight_update.sv trick + ZeRO-1 weight-update sharding):
    # each replica updates its owned master shard and optimizer-state
    # shard AS the final-hop decode of that shard retires, and the
    # all-gather then distributes fresh params.  With fused_kernel=True
    # on TPU the update runs INSIDE the depth-D Pallas ring kernel
    # (ops.ring_pallas fused-opt variants: state shards are donated
    # kernel operands, hyperparams are SMEM scalars — an lr change never
    # recompiles); otherwise the same update formula
    # (optim.fused_apply_flat, bit-specified by the numpy golden twins in
    # optim.py) runs fused into the step right after the reduce.
    # Combines with integrity_check since PR 12: the EXACT wire-checksum
    # tier (ops.integrity) verifies the encoded ring frames with no
    # tolerance band, so the fused path carries integrity coverage too —
    # on the shared-formula routes (hier / off-TPU / n==1) a tripped
    # verdict gates the update in-graph (pre-step state preserved); on
    # the in-kernel TPU route the kernel accumulates the frame checksums
    # itself and a tripped conservation verdict invalidates the step
    # (check_step_diag raises WireIntegrityError -> the elastic ladder
    # restores/reshards; the donated in-kernel state is discarded with
    # the step).  The trainers still reject clip_norm (a global-norm
    # clip needs a barrier between the reduce and the update, which is
    # exactly the exposed optimizer time this mode removes).  See
    # docs/FUSED_OPTIMIZER.md.
    fused_optimizer: bool = False
    slice_elems: int = 8192       # 32 KiB of f32, matching BUF_SIZE=512 CLs
    # unroll the n-1 ring-hop loop at trace time: marginally better codegen
    # for tiny rings, O(n) compile-time blowup for real ones — rolled
    # lax.fori_loop is the default (hop count is data-independent either way)
    unroll_hops: bool = False
    max_inflight: int = 8
    # bucketed (DDP-style) all-reduce: min elements per bucket.  The
    # reference's granularity is one bucket per layer (one all_reduce()
    # call per bwd layer, sw/mlp_mpi_example_f32.cpp:753); 4M f32 = 16 MiB
    # amortizes per-collective latency while keeping backward overlap.
    bucket_elems: int = 4 * 1024 * 1024
    # collective integrity guard, two tiers computed inside the jitted
    # step:
    #   value tier (runtime.chaos): per-chunk checksums across the
    #     gradient reduce-scatter plus a NaN/inf count against a
    #     codec-derived tolerance band — the gross-corruption tripwire
    #     (NaN, flipped exponent bits, runaway scale).
    #   exact tier (ops.integrity, PR 12): bit-exact checksums over the
    #     ENCODED frames of every ring hop (flat and hier), verified by
    #     conservation — no tolerance band, so the FINITE wrong-value
    #     class (a flipped mantissa bit that decodes to a plausible
    #     number) trips too.  ``wire_ok`` lands in the step diag; the
    #     exact tier only exists on impl='ring' (XLA collectives own
    #     their own wire).
    # A tripped verdict GATES the optimizer update in-graph where the
    # pre-step state is still materialized (all unfused routes + the
    # shared-formula fused_optimizer routes) and surfaces the verdict in
    # the step's metrics dict for the elastic loop to act on; the
    # in-kernel fused TPU route surfaces the verdict only (its state is
    # donated — recovery is the elastic restore/reshard ladder).
    # integrity_tol=None derives the value-tier tolerance from the wire
    # format (chaos.integrity_tol): reassociation-only for f32,
    # quantization-bounded for BFP.
    integrity_check: bool = False
    integrity_tol: Optional[float] = None

    def __post_init__(self) -> None:
        assert self.impl in ("xla", "ring")
        if ((self.compression is not None or self.codec is not None)
                and self.impl != "ring"):
            raise ValueError("gradient compression requires impl='ring' "
                             "(XLA collectives cannot compress on the wire)")
        assert self.topology in ("flat", "hier"), self.topology
        assert self.pipeline_depth is None or self.pipeline_depth >= 1
        assert self.intra_size >= 0, self.intra_size
        if self.topology == "hier":
            if self.impl != "ring":
                raise ValueError(
                    "topology='hier' requires impl='ring': the 2-stage "
                    "intra/inter schedule is an explicit-ring program "
                    "(ops.ring_hier); XLA owns its own psum topology")
            if self.fused_kernel:
                raise ValueError(
                    "topology='hier' cannot ride fused_kernel yet: the "
                    "Pallas ring kernels drive the FULL axis's neighbor "
                    "permutation; run the separate-op hierarchical ring "
                    "(fused_kernel=False — fused_optimizer still works "
                    "through the shared update formula)")
            if self.intra_size <= 1 and self.codec != "auto":
                raise ValueError(
                    "topology='hier' needs a declared intra/inter "
                    "factorization: set intra_size > 1 (the fast-hop "
                    "group size; must divide the axis size), or use "
                    "codec='auto' and let the autotuner own it")
        if self.codec == "auto":
            # deferred to the trace-time autotuner (the JAX package's tune,
            # resolved once at trainer construction); nothing to validate
            # against the codec registry yet
            if self.fused_kernel:
                raise ValueError(
                    "codec='auto' cannot combine with fused_kernel=True: "
                    "the fused-capability check needs a concrete codec — "
                    "pick one, or let the tuner run the separate-op ring")
            if self.compression is not None:
                raise ValueError(
                    "codec='auto' conflicts with compression= (a "
                    "BFPConfig parameterizes the 'bfp' codec only)")
        if self.codec is not None:
            if not isinstance(self.codec_opts, tuple):
                raise ValueError("codec_opts must be a tuple of (key, "
                                 f"value) pairs, got {self.codec_opts!r}")
            if self.compression is not None and self.codec != "bfp":
                raise ValueError(
                    f"codec={self.codec!r} conflicts with compression= "
                    "(a BFPConfig): the BFPConfig parameterizes the 'bfp' "
                    "codec only")
        if self.codec == "auto":
            return      # the registry resolution happens at autotune time
        if self.codec is not None or self.fused_kernel:
            if self.fused_kernel and (self.impl != "ring"
                                      or (self.compression is None
                                          and self.codec is None)):
                raise ValueError("fused_kernel is the compressed-ring "
                                 "Pallas path: requires impl='ring' and a "
                                 "codec (codec=/compression=)")
            # fail fast on unknown names / bad options, with the
            # registered-codec list in the error (compress.get_codec);
            # import is lazy so constructing codec-less configs never
            # touches the compress package, and one resolve serves both
            # the name validation and the fused-capability check
            from ..compress import resolve
            c = resolve(self)
            if self.fused_kernel and not c.supports_fused:
                raise ValueError(
                    f"codec {c.name!r} cannot ride the fused Pallas ring "
                    "(its wire frames are BFP int8 mantissa+scale tiles); "
                    "use the separate-op ring (fused_kernel=False) or "
                    "codec='bfp'")


@dataclass(frozen=True)
class OptimizerConfig:
    """Fused optimizer. The reference hard-codes SGD lr=0.1 in RTL
    (a = 0xBDCCCCCD = -0.1, hw/weight_update.sv:439-446); we make it a flag
    and add momentum/adamw for the larger model configs."""

    kind: str = "sgd"             # "sgd" | "momentum" | "adamw"
    learning_rate: float = 0.1
    momentum: float = 0.9
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    # learning-rate schedule (the reference cannot schedule at all — its lr
    # is an RTL constant; see optim.learning_rate_at)
    schedule: str = "constant"    # "constant" | "cosine" | "linear"
    warmup_steps: int = 0
    decay_steps: int = 0          # horizon for cosine/linear (incl. warmup)
    min_lr_ratio: float = 0.0     # floor as a fraction of learning_rate
    # global-norm gradient clipping (None = off).  The norm is computed
    # over the FULL flat gradient (psum across master-sharding axes), so
    # sharded and single-device training clip identically.
    clip_norm: Optional[float] = None

    def __post_init__(self) -> None:
        assert self.kind in ("sgd", "momentum", "adamw")
        # 0.0 would silently zero every gradient; "off" is None
        assert self.clip_norm is None or self.clip_norm > 0, self.clip_norm
        assert self.schedule in ("constant", "cosine", "linear")
        if self.schedule != "constant":
            assert self.decay_steps > self.warmup_steps >= 0, (
                "cosine/linear schedules need decay_steps > warmup_steps")


@dataclass(frozen=True)
class AdaptConfig:
    """Online plan adaptation (the JAX package's tune.adapt): the drift
    observatory that closes the autotune loop WHILE the job runs.

    The autotuner (codec="auto") resolves a plan once at construction
    from banked/live-calibrated rates; this config arms the runtime half:
    a bounded candidate set (the top ``n_candidates`` runner-up plans
    from the same argmin grid) is built AND traced up front, each step's
    measured wall time is joined against the active plan's modeled stage
    times into drift residuals (streamed as ``tune.drift.*`` metrics and
    an "attribution" Perfetto lane), and a host-side CUSUM detector with
    hysteresis swaps to a pre-compiled alternate plan at a step boundary
    when the modeled-vs-measured regime shifts for good (SparCML's
    break-even moving with the effective link rate).  Everything here is
    HOST-side and trace-time static: detection reads banked metrics,
    never runs inside jit (R2/R4), and a switch causes ZERO new traces
    (graftlint J13).  docs/TUNING.md carries the full contract."""

    enabled: bool = False
    # run the startup mesh microbenches (tune.adapt.live_calibrate) and
    # feed the measured rates into plan resolution at the `live`
    # provenance tier (above every banked artifact; dryrun-flagged on a
    # CPU mesh — the honesty rules of tune.calibration apply unchanged)
    live_calibration: bool = True
    # bounded pre-compiled candidate set: the argmin winner plus the
    # best runner-up plans from distinct (codec, topology) groups of the
    # same grid, every one traced at construction
    n_candidates: int = 3
    # drift plane: EWMA smoothing of the per-step residuals, the
    # per-step relative excess considered drift (CUSUM slack), the
    # accumulated-drift trip threshold, warmup steps spent establishing
    # the measured step-time baseline (re-entered after every switch),
    # and the post-trip hysteresis window during which the detector
    # stays disarmed (no flapping)
    ewma_alpha: float = 0.25
    drift_rel: float = 0.75
    cusum_threshold: float = 3.0
    warmup_steps: int = 3
    cooldown_steps: int = 8

    def __post_init__(self) -> None:
        assert 0.0 < self.ewma_alpha <= 1.0, self.ewma_alpha
        assert self.drift_rel > 0, self.drift_rel
        assert self.cusum_threshold > 0, self.cusum_threshold
        assert self.warmup_steps >= 1, self.warmup_steps
        assert self.cooldown_steps >= 0, self.cooldown_steps
        if self.enabled and self.n_candidates < 2:
            raise ValueError(
                "AdaptConfig.enabled needs n_candidates >= 2: a "
                "candidate set of one has nothing to switch to — the "
                "detector would observe drift it can never act on")


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh. The reference supports only a 1-D ring of FPGAs
    (data parallelism, sw/setup_route.sh); we generalize to the full
    dp x fsdp x tp x sp x ep product over ICI."""

    dp: int = 1                   # data parallel (the reference's only axis)
    fsdp: int = 1                 # ZeRO / fully-sharded data parallel
    tp: int = 1                   # tensor parallel
    sp: int = 1                   # sequence/context parallel (ring attention)
    pp: int = 1                   # pipeline parallel (GPipe microbatch ring)
    ep: int = 1                   # expert parallel (MoE all-to-all)

    @property
    def nproc(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp * self.pp * self.ep

    def axis_sizes(self) -> Tuple[Tuple[str, int], ...]:
        return (("dp", self.dp), ("fsdp", self.fsdp), ("tp", self.tp),
                ("sp", self.sp), ("pp", self.pp), ("ep", self.ep))


@dataclass(frozen=True)
class MLPConfig:
    """The reference benchmark model: N fully-connected layers of equal width
    trained with softmax cross-entropy (sw/mlp_mpi_example_f32.cpp:284-296,
    canonical 10x2048x2048 f32, sw/run.sh:16)."""

    layer_sizes: Tuple[int, ...] = (2048,) * 11   # 10 layers of 2048x2048
    num_classes: Optional[int] = None             # defaults to last width
    dtype: str = "float32"
    fuse_bias: bool = True

    @property
    def n_layers(self) -> int:
        return len(self.layer_sizes) - 1


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop configuration (ref driver CLI: iters MB fuse_type type
    bn bk bc C1..CN, sw/mlp_mpi_example_f32.cpp:269-296)."""

    iters: int = 20               # canonical run: 20 (sw/run.sh:16)
    global_batch: int = 5376      # canonical run: MB 5376 (sw/run.sh:16)
    accum_steps: int = 1          # gradient accumulation microbatches
    mesh: MeshConfig = field(default_factory=MeshConfig)
    collective: CollectiveConfig = field(default_factory=CollectiveConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    zero1: bool = True            # sharded optimizer state + fused gather
    seed: int = 0
    # in-graph training metrics (obs.metrics): grad norm, codec declared-
    # vs-observed error, EF residual mass, integrity drift — tapped to
    # the ambient MetricsSink via pure_callback.  TRACE-TIME gate: False
    # (the default) compiles the step to HLO bit-identical to a build
    # with no obs plumbing at all (tests/test_obs.py asserts this).
    obs_metrics: bool = False
    # online plan adaptation (tune.adapt.AdaptiveTrainer): live startup
    # calibration + modeled-vs-measured drift attribution + recompile-
    # free plan switching.  Host-side and off by default; see AdaptConfig.
    adapt: AdaptConfig = field(default_factory=AdaptConfig)

    @property
    def per_device_batch(self) -> int:
        n = self.mesh.nproc
        assert self.global_batch % n == 0, (self.global_batch, n)
        return self.global_batch // n


def coerce_value(T: Any, v: str) -> Any:
    """Parse a flag string as type T (bool truthy words, int/float/str,
    comma-separated int tuples).  Shared by from_flags and the example
    drivers' --model.* overlays."""
    if T is bool:
        return v.lower() in ("1", "true", "yes", "on")
    if T in (int, float, str):
        return T(v)
    if T is tuple:     # comma-separated ints, e.g. --model.layer_sizes=64,64
        return tuple(int(p) for p in v.split(",") if p)
    raise TypeError(f"cannot coerce flag value {v!r} to {T}")


_coerce = coerce_value


def parse_codec_opts(v: str) -> Tuple[Tuple[str, Any], ...]:
    """``key=value`` pairs, comma-separated, as codec constructor kwargs
    (``--collective.codec_opts=backend=pallas,seed=3``): each value an
    int, a float, a bool word or else a string."""
    out = []
    for part in (p for p in v.split(",") if p):
        key, eq, raw = part.partition("=")
        if not eq:
            raise ValueError(f"codec_opts entries look like key=value, "
                             f"got {part!r}")
        for T in (int, float):
            try:
                val: Any = T(raw)
                break
            except ValueError:
                continue
        else:
            low = raw.lower()
            val = (low in ("true", "yes", "on")
                   if low in ("true", "false", "yes", "no", "on", "off")
                   else raw)
        out.append((key, val))
    return tuple(out)


def from_flags(cls: Any, argv: Sequence[str]) -> Any:
    """Build a (possibly nested) config dataclass from --dotted.key=value
    flags, e.g. ``from_flags(TrainConfig, ["--mesh.dp=4", "--iters=100"])``."""
    cfg = cls()
    for arg in argv:
        if not arg.startswith("--"):
            raise ValueError(f"flags must look like --key=value, got {arg!r}")
        key, _, val = arg[2:].partition("=")
        path = key.split(".")
        try:
            cfg = _replace_path(cfg, path, val)
        except (ValueError, TypeError) as e:
            raise ValueError(f"--{key}={val}: {e}") from e
    return cfg


def _declared_type(cfg: Any, name: str) -> Any:
    """The field's annotation with Optional[...] unwrapped."""
    import typing
    T = typing.get_type_hints(type(cfg)).get(name)
    args = [a for a in typing.get_args(T) if a is not type(None)]
    return args[0] if len(args) == 1 else T


def _replace_path(cfg: Any, path: Sequence[str], val: str) -> Any:
    name, rest = path[0], path[1:]
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    if name not in fields:
        raise ValueError(f"unknown config field {name!r} on {type(cfg).__name__}")
    cur = getattr(cfg, name)
    T = _declared_type(cfg, name) if cur is None else type(cur)
    if rest:
        if cur is None:
            if not dataclasses.is_dataclass(T):
                raise ValueError(f"{name} is not a nested config")
            # Optional nested config defaulting to None (e.g.
            # collective.compression): setting any sub-field turns it on
            # with defaults for the rest
            cur = T()
        new = _replace_path(cur, rest, val)
    elif dataclasses.is_dataclass(T):
        raise ValueError(f"{name} is a nested config; set a sub-field "
                         f"(...{name}.<field>=...)")
    elif name == "codec_opts":
        new = parse_codec_opts(val)
    elif cur is not None:
        new = coerce_value(T, val)
    else:
        # Optional scalar with a None default: the live value carries no
        # type, so coerce against the *declared* annotation — e.g.
        # '--num_classes=10' must become int 10, not whatever a literal
        # parse guesses.
        import typing
        new = coerce_value(typing.get_origin(T) or T, val)
    return dataclasses.replace(cfg, **{name: new})
