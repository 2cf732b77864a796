"""The collective autotuner and its drift observatory — the port of the JAX
package's ``tune/``: ``CollectiveConfig(codec="auto")`` resolved once at
trainer construction from the ``ops.ring_cost`` roofline under measured
rates, and a plan switched at a step boundary when the wire drifts.

  tune.calibration   the rates the tuner scores with: the port's banked
                     card measurements, the live tier (apply_live), the
                     documented fallbacks
  tune.autotune      candidate enumeration, scoring, argmin, config
                     resolution; tune_topk (the bounded candidate set)
  tune.adapt         live startup calibration, modeled-vs-measured
                     attribution (tune.drift.*), CUSUM regime-shift
                     detection, the AdaptiveTrainer
"""

from .calibration import (Calibration, CodecRates, apply_live,  # noqa: F401
                          fixture_calibration, load_calibration)
from .autotune import (Candidate, TunedPlan, enumerate_candidates,  # noqa: F401
                       needs_autotune, payload_class, rescore,
                       resolve_collective, resolve_train_config,
                       score_candidate, tune, tune_topk)
from . import adapt  # noqa: F401

__all__ = [
    "Calibration", "CodecRates", "apply_live", "fixture_calibration",
    "load_calibration", "Candidate", "TunedPlan", "enumerate_candidates",
    "needs_autotune", "payload_class", "rescore", "resolve_collective",
    "resolve_train_config", "score_candidate", "tune", "tune_topk", "adapt",
]
