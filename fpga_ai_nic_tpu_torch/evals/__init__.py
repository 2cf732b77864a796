"""Evaluations of the port: the codec convergence eval
(``evals.codec_convergence``) and its BFP shim (``evals.bfp_convergence``)."""

from . import bfp_convergence, codec_convergence  # noqa: F401

__all__ = ["bfp_convergence", "codec_convergence"]
