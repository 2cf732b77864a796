"""The error classes of the JAX package's ``runtime/chaos.py`` that the
serving engine's recovery (``serve.engine.ServeEngine._recover``) tells
apart, as plain exception classes.  Fault injection itself (``FaultPlan``)
is not ported yet."""

from __future__ import annotations


class InjectedFault(RuntimeError):
    """A fault raised on purpose by a fault plan (transient by contract)."""


class InjectedPreemption(InjectedFault):
    """The process lost its device: recovery rebuilds, not a plain retry."""


class IntegrityError(RuntimeError):
    """A value-space guard tripped (for the serving tick: non-finite or
    oversized logits); the numbers must not reach a token stream."""


class WireIntegrityError(IntegrityError):
    """The exact tier tripped: a KV page (or wire frame) failed its
    bit-exact checksum (``ops.integrity``)."""
