"""Virtual data-parallel ranks and the trainers of the port."""

from .ddp import DDPState, DDPTrainer
from .fsdp import FSDPState, FSDPTrainer
from .queued import QueuedDDPTrainer

__all__ = ["DDPState", "DDPTrainer", "FSDPState", "FSDPTrainer",
           "QueuedDDPTrainer"]
