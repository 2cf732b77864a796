"""Evaluations of the port: the codec convergence eval
(``evals.codec_convergence``)."""

from . import codec_convergence  # noqa: F401

__all__ = ["codec_convergence"]
