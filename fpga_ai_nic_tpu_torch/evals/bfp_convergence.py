"""BFP convergence evaluation — the port of the JAX package's
``evals/bfp_convergence.py``, a re-export shim: the BFP mantissa sweep is
one slice of ``evals.codec_convergence``, where every name below lives.
"""

from __future__ import annotations

from .codec_convergence import (  # noqa: F401
    MODELS, codec_error_table, run_comparison, run_comparison_multiseed,
    run_curve)

__all__ = ["MODELS", "run_curve", "run_comparison",
           "run_comparison_multiseed", "codec_error_table"]
