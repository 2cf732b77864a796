"""Every discrete policy decision of the serving control plane, as pure
functions of plain ints and strings.  The one definition lives in
``verify/opstream.py`` (``SchedEmitter``, ``SCHED_RULES``), where the
model checker (``verify.sched``) explores it; this module re-exports the
same objects, so the batcher (``serve.scheduler.ContinuousBatcher``), the
fleet, the autoscaler and ``tune.adapt`` bind the object the checker
checks.
"""

from ..verify.opstream import (SCHED_DECODE, SCHED_FINISHED, SCHED_PREFILL,
                               SCHED_RULES, SCHED_WAITING, SchedEmitter)

__all__ = ["SCHED_DECODE", "SCHED_FINISHED", "SCHED_PREFILL", "SCHED_RULES",
           "SCHED_WAITING", "SchedEmitter"]
