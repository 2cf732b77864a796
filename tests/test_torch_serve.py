"""The port's serving plane against the JAX package's, on the CPU.

- ``ServeEngine``: the port's engine and JAX's ``ServeEngine(attend_impl=
  "reference")`` serve the same prompts on the same float32 tiny Llama
  weights; every token stream must be equal, and so must the eviction
  count (a pool small enough that the batcher evicts and replays).
- ``sched_rules``: the port's copy of the scheduling rules equals JAX's
  ``SCHED_RULES`` on an exhaustive grid of small inputs.
- The port imports no JAX: every module of the package imports in a
  process where ``jax`` and the JAX package are blocked.
"""

import itertools
import os
import pkgutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax

import fpga_ai_nic_tpu_torch
from fpga_ai_nic_tpu.models import llama as jax_llama
from fpga_ai_nic_tpu.models import llama_decode as jax_dec
from fpga_ai_nic_tpu.serve import ServeConfig as JaxServeConfig
from fpga_ai_nic_tpu.serve import ServeEngine as JaxServeEngine
from fpga_ai_nic_tpu.verify.opstream import SCHED_RULES as JAX_RULES
from fpga_ai_nic_tpu_torch import serve_llama
from fpga_ai_nic_tpu_torch.models import llama, llama_decode as dec
from fpga_ai_nic_tpu_torch.runtime import chaos
from fpga_ai_nic_tpu_torch.serve import (PageAllocator, ServeConfig,
                                         ServeEngine, init_pool, pool_bytes)
from fpga_ai_nic_tpu_torch.serve.sched_rules import SCHED_RULES

CFG = llama.LlamaConfig.tiny()
JCFG = jax_llama.LlamaConfig.tiny()
MAX_NEW = 5
POOLS = {"roomy": 40, "tight": 9}
SHAPE = dict(max_reqs=4, page_size=4, max_pages_per_seq=6, prefill_chunk=6)


@pytest.fixture(scope="module")
def world():
    """JAX params (and the port's copy), prompts and JAX's greedy
    continuations from ``generate``."""
    jparams = jax_llama.init(jax.random.PRNGKey(0), JCFG)
    params = llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab, int(n)).astype(np.int32)
               for n in rng.integers(4, 14, 6)]
    ref = [np.asarray(jax_dec.generate(jparams, jax.numpy.asarray(p)[None],
                                       MAX_NEW, JCFG))[0, len(p):].tolist()
           for p in prompts]
    return jparams, params, prompts, ref


def _serve(engine, prompts):
    reqs = [engine.submit(p, max_new=MAX_NEW) for p in prompts]
    return reqs, engine.run()


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_engine_streams_and_evictions_equal_jax(world, pool):
    jparams, params, prompts, ref = world
    scfg = ServeConfig(n_pages=POOLS[pool], **SHAPE)
    jeng = JaxServeEngine(jparams, JCFG,
                          JaxServeConfig(n_pages=POOLS[pool], **SHAPE),
                          attend_impl="reference")
    jreqs, js = _serve(jeng, prompts)
    reqs, s = _serve(ServeEngine(params, CFG, scfg, device="cpu"), prompts)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [r.generated for r in reqs] == ref
    assert s["evictions"] == js["evictions"] == s["evicted"]
    assert (s["evictions"] > 0) == (pool == "tight")
    assert s["completed"] == len(prompts) and s["tokens_out"] == \
        js["tokens_out"]
    assert s["recovery"] == {"faults": {}, "recoveries": 0,
                             "mttr_mean_s": 0.0}
    assert s["page_trips"] == s["logit_trips"] == 0
    assert s["serve"] == js["serve"]
    assert s["ticks"] == js["ticks"]


def test_engine_reference_and_kernel_impls_agree(world):
    _, params, prompts, ref = world
    for impl in ("kernel", "reference"):
        eng = ServeEngine(params, CFG, ServeConfig(n_pages=9, **SHAPE),
                          device="cpu", attend_impl=impl)
        reqs, s = _serve(eng, prompts)
        assert [r.generated for r in reqs] == ref, impl
        assert s["prefill_calls"] > 0 and s["decode_calls"] > 0


def test_page_ledger_trips_on_corruption_and_replay_is_exact(world):
    """A page byte changed outside the engine's steps trips the exact tier
    before any token of that tick is emitted; replay keeps every stream
    token-exact."""
    _, params, prompts, ref = world
    eng = ServeEngine(params, CFG, ServeConfig(n_pages=40, **SHAPE),
                      device="cpu")
    reqs = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    for _ in range(3):
        eng.tick()
    page = int(eng.batcher.table[eng.batcher.table > 0][0])
    eng.pool[1]["v"][page, 0, 0, 0] += 1.0
    s = eng.run()
    assert s["page_trips"] == 1 and s["recovery"]["recoveries"] == 1
    assert s["recovery"]["faults"] == {"wire-corruption": 1}
    assert [r.generated for r in reqs] == ref


def test_logit_guard_trips_on_nan_weights(world):
    _, params, prompts, _ = world
    bad = dict(params, lm_head=params["lm_head"].clone())
    bad["lm_head"][0, 0] = float("nan")
    scfg = ServeConfig(n_pages=40, max_retries=1, **SHAPE)
    eng = ServeEngine(bad, CFG, scfg, device="cpu")
    eng.submit(prompts[0], max_new=2)
    with pytest.raises(chaos.IntegrityError):
        eng.run()
    assert eng.logit_trips == 1 and eng.stats.serve_recoveries == 1


@pytest.mark.parametrize("kw, what", [
    (dict(chaos=object()), "A.8"),
    (dict(role="prefill"), "A.7"),   # tp_mesh: tests/test_torch_tp_serve.py
    (dict(role="decode"), "A.7"),
])
def test_unported_options_raise(world, kw, what):
    _, params, _, _ = world
    with pytest.raises(NotImplementedError, match=what):
        ServeEngine(params, CFG, ServeConfig(), device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="A.8"):
        ServeEngine(params, CFG, ServeConfig(step_timeout_s=1.0),
                    device="cpu")


def test_pool_bytes_exact_and_allocator():
    scfg = ServeConfig(max_reqs=3, page_size=4, n_pages=11,
                       max_pages_per_seq=5)
    pool = init_pool(CFG, scfg, device="cpu")
    held = sum(t.numel() * t.element_size() for lyr in pool
               for t in lyr.values())
    assert held == pool_bytes(CFG, scfg)
    a = PageAllocator(4)
    assert a.alloc(4) is None and a.alloc(2) == [1, 2]
    a.free_pages([2])
    assert a.alloc(1) == [2] and a.peak_in_use == 2
    with pytest.raises(RuntimeError, match="double-free"):
        a.free_pages([1, 1, 2])


def test_serve_llama_driver_on_cpu():
    out = serve_llama.main([
        "--model=tiny", "--device=cpu", "--requests=5", "--prompt_min=3",
        "--prompt_max=12", "--max_new=3", "--max_reqs=2", "--page_size=4",
        "--max_pages_per_seq=4", "--n_pages=12", "--prefill_chunk=4"])
    assert out["completed"] == 5 and out["tokens_out"] == 15
    assert out["device_name"] == "cpu" and out["attend_impl"] == "kernel"
    with pytest.raises(ValueError, match="unknown flag"):
        serve_llama.parse(["--bogus=1"])


def test_generate_matches_engine_on_one_prompt(world):
    _, params, prompts, ref = world
    got = dec.generate(params, torch.from_numpy(prompts[0])[None], MAX_NEW,
                       CFG)
    assert got[0, len(prompts[0]):].tolist() == ref[0]


# -- scheduling rules --------------------------------------------------------

SMALL = range(0, 4)
STATES = ("waiting", "prefill", "decode", "finished")


def _seqs(max_len=3):
    for n in range(max_len + 1):
        yield from itertools.product(range(3), repeat=n)


RULE_GRIDS = {
    "replay_target": lambda: ((n,) for n in SMALL),
    "admission_need": lambda: ((n,) for n in SMALL),
    "committed_target": lambda: itertools.product(STATES, SMALL, SMALL),
    "committed_outstanding": lambda: (
        (list(zip(a, b)),) for a in _seqs(2) for b in _seqs(2)
        if len(a) == len(b)),
    "admit_ok": lambda: itertools.product(SMALL, SMALL, SMALL),
    "pick_victim": lambda: ((list(s),) for s in _seqs()),
    "pick_oldest": lambda: ((list(s),) for s in _seqs()),
    "decode_order": lambda: ((list(s),) for s in _seqs()),
    "prefill_chunk_len": lambda: itertools.product(SMALL, SMALL, SMALL),
    "route_least_loaded": lambda: (
        (list(zip(a, range(len(a)))),) for a in _seqs()),
    "pick_kill_victim": lambda: (
        (list(zip(a, range(len(a)))),) for a in _seqs()),
    "migration_action": lambda: itertools.product(
        STATES, (False, True), (False, True)),
    "load_residual": lambda: itertools.product((0.0, 1.5, 4.0), (0.5, 2.0),
                                               (1, 3)),
    "cusum_step": lambda: itertools.product(
        (0.0, 0.6), (0.0, 0.6), (0, 2), (-1.0, 0.0, 0.9), (0.1,), (1.0,),
        (3,)),
    "scale_up_fallback": lambda: itertools.product(SMALL, (-1, 0, 2)),
    "scale_down_ok": lambda: itertools.product(SMALL, (0, 1), (0.0, 2.0),
                                               (-1, 0)),
    "shed_action": lambda: itertools.product(
        (False, True), (0.0, 0.2, 0.5, 0.9), (0.1, 0.3), (0.6,)),
}


@pytest.mark.parametrize("rule", sorted(RULE_GRIDS))
def test_sched_rules_equal_jax_exhaustive(rule):
    ours, theirs = getattr(SCHED_RULES, rule), getattr(JAX_RULES, rule)
    n = 0
    for args in RULE_GRIDS[rule]():
        assert ours(*args) == theirs(*args), (rule, args)
        n += 1
    assert n > 0


def test_sched_rules_cover_every_jax_rule():
    public = {k for k in dir(JAX_RULES) if not k.startswith("_")}
    assert public == {k for k in dir(SCHED_RULES) if not k.startswith("_")}
    assert public == set(RULE_GRIDS)


# -- no JAX in the port --------------------------------------------------------

def test_port_imports_without_jax():
    """Every module of the port, and ``chip_smoke``, imports with ``jax``
    and the JAX package blocked (a ``None`` entry in ``sys.modules`` makes import raise)."""
    pkg = fpga_ai_nic_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                  pkg.__name__ + ".")]
    for m in ("serve.engine", "ops.flash_attention", "ops.ring_attention",
              "parallel.sharded", "train_llama"):
        assert f"fpga_ai_nic_tpu_torch.{m}" in mods, m
    mods.append("chip_smoke")
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in ("jax", "jaxlib", "fpga_ai_nic_tpu"):
            sys.modules[name] = None
        for m in {mods!r}:
            importlib.import_module(m)
        leaked = [m for m in sys.modules
                  if (m == "jax" or m.startswith(("jax.", "jaxlib",
                                                  "fpga_ai_nic_tpu.")))
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print(len({mods!r}))
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) == len(mods)
