"""Virtual data-parallel ranks and the trainers of the port."""

from .ddp import DDPState, DDPTrainer

__all__ = ["DDPState", "DDPTrainer"]
