"""Serving plane of the port: continuous batching over a paged KV pool on
the Llama decode path, and the elastic fleet over it (the JAX package's
``serve/``).

  - ``paged`` — the shared page pool, allocator and exact byte accounting
  - ``sched_rules`` — every admission, eviction, routing and scaling rule
  - ``scheduler`` — the continuous batcher over those rules
  - ``engine`` — the tick loop, roles, guards, recovery and request
    telemetry
  - ``handoff`` — live KV migration between replicas: a page copy with
    exact byte accounting and a landed-page checksum
  - ``fleet`` — disaggregated prefill/decode replicas as slots on the
    card; replica kill recovered by KV handoff instead of replay
  - ``traffic`` — deterministic replayable workload generator (diurnal
    cycles, bursts, heavy-tailed lengths, tenant mixes)
  - ``autoscale`` — the closed-loop controller: windowed SLO metrics
    (``obs.slo``) -> CUSUM/hysteresis -> gated fleet actions

The paged forward lives with the model
(``models.llama_decode.forward_paged``); its attention is the CUDA kernel
of ``ops.paged_attend`` on the card.
"""

from .autoscale import AutoscaleConfig, Autoscaler, ScaleDecision
from .engine import ServeEngine
from .fleet import FleetConfig, Replica, ServeFleet
from .handoff import HandoffPlan, apply_handoff
from .paged import (NULL_PAGE, PageAllocator, ServeConfig,
                    contiguous_cache_bytes, init_pool, page_table_bytes,
                    pool_bytes)
from .scheduler import ContinuousBatcher
from .traffic import (TrafficConfig, TrafficRequest, Workload,
                      diurnal_config, generate, spike_config,
                      steady_config, thundering_herd_config)

__all__ = [
    "ServeEngine",
    "NULL_PAGE", "PageAllocator", "ServeConfig", "init_pool",
    "pool_bytes", "contiguous_cache_bytes", "page_table_bytes",
    "ContinuousBatcher",
    "FleetConfig", "Replica", "ServeFleet",
    "HandoffPlan", "apply_handoff",
    "AutoscaleConfig", "Autoscaler", "ScaleDecision",
    "TrafficConfig", "TrafficRequest", "Workload", "generate",
    "steady_config", "spike_config", "diurnal_config",
    "thundering_herd_config",
]
