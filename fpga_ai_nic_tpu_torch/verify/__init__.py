"""Protocol model checking for the collectives and the serving control
plane — the port of the JAX package's ``verify/``, in plain Python.

  opstream   one op-stream emitter per protocol route (flat, streaming,
             ag, hier, reshard, handoff, gather), the execution models
             (`RingModel`, `PairModel`, `GatherModel`), the static DMA
             discipline and M2 checksum-weight passes, and the serving
             control plane's rules (`SchedEmitter`, `SCHED_RULES`).  The
             port runs the hier, handoff and reshard programs
             (``ops.ring_hier``, ``serve.handoff``, ``parallel.reshard``)
             and the rules; the flat, streaming, ag and gather routes
             are the JAX package's TPU kernels' protocols, which the
             port's CUDA kernels do not run.
  sched      the exhaustive control-plane model over `SCHED_RULES`.
  mc         an exhaustive explicit-state checker with state hashing and
             a persistent-set partial-order reduction, the randomized
             fuzz backend (`run_random`, behind
             ``ops.ring_cuda.simulate_rs_protocol``), every route's
             builder and cell grid, and the corpus.
  replay     a violating interleaving as a per-node op trace and as
             Perfetto JSON through ``obs.timeline``.
  lockset    the happens-before/lockset pass (H1) over the port's
             threaded modules.

Entry point: ``python -m fpga_ai_nic_tpu_torch.verify`` (``__main__``).
No module in this package imports torch or numpy or touches a device:
the corpus is plain-Python state exploration (``replay`` reaches
``obs``, which imports neither either).
"""

from .opstream import (
    RingModel, PairModel, ProtocolError, rs_plan, rs_op_stream,
    rs_stream_op_stream, ag_schedule, ag_op_stream, hier_program,
    hier_op_stream, reshard_op_stream, reshard_segments,
    handoff_program, handoff_op_stream, check_dma_discipline,
    check_weight_conservation, SchedEmitter, SCHED_RULES,
)
from .sched import SchedModel, build_sched, sched_cells
from .mc import Violation, CheckResult, check, run_random, run_corpus

__all__ = [
    "RingModel", "PairModel", "ProtocolError", "rs_plan", "rs_op_stream",
    "rs_stream_op_stream", "ag_schedule", "ag_op_stream", "hier_program",
    "hier_op_stream", "reshard_op_stream", "reshard_segments",
    "handoff_program", "handoff_op_stream", "check_dma_discipline",
    "check_weight_conservation", "SchedEmitter", "SCHED_RULES",
    "SchedModel", "build_sched", "sched_cells",
    "Violation", "CheckResult", "check", "run_random", "run_corpus",
]
