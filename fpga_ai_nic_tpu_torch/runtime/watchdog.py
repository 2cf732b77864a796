"""The error class of the JAX package's ``runtime/watchdog.py`` that the
serving engine's recovery tells apart.  The watchdog itself (a wall-clock
bound over each tick's device work) is not ported yet."""

from __future__ import annotations


class DeviceHangError(RuntimeError):
    """A device-touching call exceeded its watchdog timeout."""
