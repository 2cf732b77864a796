"""Faults inside the serving tick (``ServeEngine(chaos=, step_timeout_s=)``)
against the JAX package's engine on the tiny f32 Llama: the same plan
fires at ``serve.step`` in both, and the token streams, recoveries,
fault kinds, ``page_trips`` and ``logit_trips`` are equal — JAX's
``TestEngineChaos`` cells, its ledger and logit-guard cells, and one plan
with every kind at once.  Each engine first serves the prompts fault-free
(JAX compiles its tick programs there: compiled under the watchdog, a
compile on a loaded machine would outlast a sub-second bound and count as
a hang), then again under the plan, whose steps count from that point.
A timed-out tick's thread is joined before the test ends."""

import dataclasses

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

import jax

from fpga_ai_nic_tpu.models import llama as jax_llama
from fpga_ai_nic_tpu.runtime import chaos as jax_chaos
from fpga_ai_nic_tpu.runtime import watchdog as jax_watchdog
from fpga_ai_nic_tpu.serve import ServeConfig as JaxServeConfig
from fpga_ai_nic_tpu.serve import ServeEngine as JaxServeEngine
from fpga_ai_nic_tpu_torch.models import llama
from fpga_ai_nic_tpu_torch.runtime import chaos, watchdog
from fpga_ai_nic_tpu_torch.serve import ServeConfig, ServeEngine

CFG = llama.LlamaConfig.tiny()
JCFG = jax_llama.LlamaConfig.tiny()
SHAPE = dict(max_reqs=3, page_size=4, n_pages=24, max_pages_per_seq=6,
             prefill_chunk=6, step_timeout_s=2.0)


@pytest.fixture(scope="module")
def world():
    jparams = jax_llama.init(jax.random.PRNGKey(0), JCFG)
    params = llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, CFG.vocab, int(n)).astype(np.int32)
               for n in rng.integers(4, 10, 4)]
    return jparams, params, prompts


def _run(world, specs, **shape):
    """``specs(mod, base)`` -> the plan's FaultSpecs, steps from tick
    ``base``; each engine serves the prompts fault-free, then under its
    package's plan.  Returns both outcomes of the second pass."""
    jparams, params, prompts = world
    kw = dict(SHAPE, **shape)
    outs, bases = [], []
    for mod, eng_cls, scfg_cls, wd, p, cfg, extra in (
            (jax_chaos, JaxServeEngine, JaxServeConfig, jax_watchdog,
             jparams, JCFG, dict(attend_impl="reference")),
            (chaos, ServeEngine, ServeConfig, watchdog, params, CFG,
             dict(device="cpu"))):
        eng = eng_cls(p, cfg, scfg_cls(**dict(kw, step_timeout_s=None)),
                      **extra)
        for q in prompts:
            eng.submit(q, max_new=4)
        eng.run()
        base = eng.ticks
        bases.append(base)
        plan = mod.FaultPlan(specs(mod, base), seed=9)
        eng.chaos = plan
        eng.scfg = scfg_cls(**kw)
        eng.watchdog = (wd.Watchdog(kw["step_timeout_s"])
                        if kw["step_timeout_s"] is not None else None)
        reqs = [eng.submit(q, max_new=4) for q in prompts]
        with mod.activate(plan):
            s = eng.run()
        if mod is chaos:
            assert eng.join_watchdog(10.0) == 0
        outs.append({"streams": [list(r.generated) for r in reqs],
                     "faults": s["recovery"]["faults"],
                     "recoveries": s["serve_recoveries"],
                     "page_trips": s["page_trips"],
                     "logit_trips": s["logit_trips"],
                     "fired": len(plan.fired),
                     "recompiles_steady": s["recompiles_steady"]})
    assert bases[0] == bases[1]
    return outs


def _fault_free(world):
    return _run(world, lambda mod, b: [])[1]["streams"]


CELLS = {
    "preemption": lambda m, b: [m.FaultSpec("preemption", "serve.step",
                                            step=b + 3)],
    "hang": lambda m, b: [m.FaultSpec("hang", "serve.step", step=b + 2,
                                      duration_s=1.5)],
    "slowdown": lambda m, b: [m.FaultSpec("slowdown", "serve.step",
                                          step=b + 1, duration_s=0.1)],
    "exception": lambda m, b: [m.FaultSpec("exception", "serve.step",
                                           step=b + 1)],
    "nan_ledger": lambda m, b: [m.FaultSpec("corruption", "serve.step",
                                            step=b + 3, mode="nan",
                                            fraction=0.5)],
    "wirebit_ledger": lambda m, b: [m.FaultSpec("corruption", "serve.step",
                                                step=b + 3, mode="wirebit",
                                                fraction=0.25)],
    "all_kinds": lambda m, b: [
        m.FaultSpec("hang", "serve.step", step=b + 2, duration_s=1.5),
        m.FaultSpec("exception", "serve.step", step=b + 4),
        m.FaultSpec("preemption", "serve.step", step=b + 6),
        m.FaultSpec("corruption", "serve.step", step=b + 8, mode="wirebit",
                    fraction=0.25),
        m.FaultSpec("corruption", "serve.step", step=b + 10, mode="nan",
                    fraction=0.5)],
}
TIMEOUTS = {"hang": 0.8, "all_kinds": 0.8}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tick_faults_match_jax_engine(world, cell):
    jax_out, port = _run(world, CELLS[cell],
                         step_timeout_s=TIMEOUTS.get(cell, 2.0),
                         backoff_s=0.0)
    assert port == jax_out
    assert port["streams"] == _fault_free(world)   # token-exact recovery
    assert port["fired"] == len(CELLS[cell](chaos, 0))
    if cell == "slowdown":
        assert port["recoveries"] == 0
    else:
        assert port["recoveries"] >= 1
    if cell in ("nan_ledger", "wirebit_ledger"):
        # the ledger (on by default) catches any pool byte change first
        assert port["page_trips"] >= 1 and port["logit_trips"] == 0


def test_logit_guard_owns_the_tick_without_the_ledger(world):
    jax_out, port = _run(world, CELLS["nan_ledger"], page_integrity=False,
                         backoff_s=0.0)
    assert port == jax_out
    assert port["logit_trips"] >= 1 and port["page_trips"] == 0
    assert port["faults"].get("corruption", 0) >= 1
    assert port["streams"] == _fault_free(world)


def test_retry_budget_exhausts_loudly(world):
    _, params, _ = world
    plan = chaos.FaultPlan([chaos.FaultSpec("preemption", "serve.step",
                                            step=0) for _ in range(4)])
    scfg = dataclasses.replace(ServeConfig(**SHAPE), max_retries=1,
                               backoff_s=0.0, step_timeout_s=None)
    eng = ServeEngine(params, CFG, scfg, chaos=plan, device="cpu")
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new=3)
    with chaos.activate(plan), pytest.raises(chaos.InjectedPreemption):
        eng.run()


def test_recovery_allocates_a_new_pool(world):
    """A timed-out tick may still write its pool: recovery hands the
    engine a new pool and leaves the old tensors alone."""
    _, params, prompts = world
    plan = chaos.FaultPlan([chaos.FaultSpec("exception", "serve.step",
                                            step=2)])
    eng = ServeEngine(params, CFG, ServeConfig(**dict(SHAPE, backoff_s=0.0)),
                      chaos=plan, device="cpu")
    for p in prompts:
        eng.submit(p, max_new=4)
    seen = []
    while len(seen) < 3:
        seen.append(eng.pool[0]["k"])
        eng.tick()
    old = seen[-1]
    assert eng.pool[0]["k"] is not old
    assert float(old.abs().sum()) > 0          # the old pool kept its bytes
    assert float(eng.pool[0]["k"].abs().sum()) == 0
