"""Serving plane of the port: continuous batching over a paged KV pool on
the Llama decode path (the JAX package's ``serve/``, the single-replica
core).

  - ``paged`` — the shared page pool, allocator and exact byte accounting
  - ``sched_rules`` — every admission, eviction and ordering rule
  - ``scheduler`` — the continuous batcher over those rules
  - ``engine`` — the tick loop, guards, recovery and request telemetry

The paged forward lives with the model
(``models.llama_decode.forward_paged``); its attention is the CUDA kernel
of ``ops.paged_attend`` on the card.
"""

from .engine import ServeEngine
from .paged import (NULL_PAGE, PageAllocator, ServeConfig,
                    contiguous_cache_bytes, init_pool, page_table_bytes,
                    pool_bytes)
from .scheduler import ContinuousBatcher

__all__ = ["ServeEngine", "NULL_PAGE", "PageAllocator", "ServeConfig",
           "init_pool", "pool_bytes", "contiguous_cache_bytes",
           "page_table_bytes", "ContinuousBatcher"]
