"""The port's serving fleet (``serve/handoff.py``, ``serve/fleet.py``, the
engine's roles, the fleet's chaos sites) and its drivers
(``serve_fleet``, ``generate_llama``) against the JAX package, on the CPU.

The tiny float32 Llama with JAX's weights (``llama.params_from_jax``),
JAX's fixtures (``tests/test_fleet.py``: ``SCFG``, the prompts of
``default_rng(7)``); every replica a ``"cpu"`` slot.  JAX's fleets are run
once a module:

- the handoff: landed pages, bystanders and the untouched source equal
  JAX's ``apply_handoff`` over a pair mesh (with and without the landed
  checksum), the plan's bytes and ``handoff_program`` equal JAX's;
- the disaggregated 1-prefill, 2-decode fleet: streams equal JAX's fleet
  and ``generate()``, its counters (handoffs, wire and host bytes,
  replays, ticks, evictions) equal JAX's, each role ran only its step;
- a kill at fleet tick 6: byte-identical streams, JAX's counters; the
  last decode replica killed promotes a survivor; a mid-prefill
  migration keeps its partial KV; a planned ``kill_replica``; a handoff
  ``exception`` costs exactly one replay; a full decode fleet parks;
- a ``wirebit`` on the handoff wire trips the landed-page check and one
  retry absorbs it (zero replays);
- the drivers: every ``serve_fleet`` scenario on the tiny model, and
  ``generate_llama``'s greedy output equal to JAX's driver.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu.models import llama as jax_llama
from fpga_ai_nic_tpu.runtime import chaos as jax_chaos
from fpga_ai_nic_tpu.serve import FleetConfig as JaxFleetConfig
from fpga_ai_nic_tpu.serve import ServeConfig as JaxServeConfig
from fpga_ai_nic_tpu.serve import ServeFleet as JaxServeFleet
from fpga_ai_nic_tpu.serve import handoff as jax_handoff
from fpga_ai_nic_tpu.verify import opstream as jax_opstream
from fpga_ai_nic_tpu_torch import generate_llama, serve_fleet
from fpga_ai_nic_tpu_torch.models import llama, llama_decode as dec
from fpga_ai_nic_tpu_torch.runtime import chaos
from fpga_ai_nic_tpu_torch.runtime.requests import PREFILL
from fpga_ai_nic_tpu_torch.serve import (FleetConfig, ServeConfig,
                                         ServeFleet)
from fpga_ai_nic_tpu_torch.serve import handoff as handoff_lib
from fpga_ai_nic_tpu_torch.verify import opstream

CFG = llama.LlamaConfig.tiny()
JCFG = jax_llama.LlamaConfig.tiny()
SHAPE = dict(max_reqs=4, page_size=4, n_pages=40, max_pages_per_seq=6,
             prefill_chunk=6)
SCFG = ServeConfig(**SHAPE)
SLOTS = ["cpu"] * 3
MAX_NEW = 6
COUNTERS = ("ticks", "completed", "tokens_out", "handoffs",
            "handoff_wire_bytes", "handoff_host_bytes",
            "handoff_integrity_trips", "fleet_replays", "kills",
            "serve_recoveries", "evictions", "recompiles_steady")


def _generate(params, prompt, n):
    out = dec.generate(params, torch.from_numpy(prompt)[None], n, CFG)
    return out[0, len(prompt):].tolist()


def _prompts(seed, lo, hi, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, int(m)).astype(np.int32)
            for m in rng.integers(lo, hi, n)]


@pytest.fixture(scope="module")
def world():
    """JAX's params and the port's copy, JAX's fleet prompts and their
    greedy continuations from the port's ``generate`` (held equal to
    JAX's in ``tests/test_torch_serve.py``)."""
    jparams = jax_llama.init(jax.random.PRNGKey(0), JCFG)
    params = llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    prompts = _prompts(7, 4, 14, 6)
    ref = [_generate(params, p, MAX_NEW) for p in prompts]
    return jparams, params, prompts, ref


@pytest.fixture(scope="module")
def jax_runs(world):
    """JAX's fault-free 1-prefill, 2-decode fleet and the same fleet with a
    preemption at ``fleet.membership`` on tick 6."""
    jparams, _, prompts, _ = world
    out = {}
    for name, plan in (("steady", None), ("kill", jax_chaos.FaultPlan(
            [jax_chaos.FaultSpec("preemption", "fleet.membership", step=6)],
            seed=11))):
        fleet = JaxServeFleet(jparams, JCFG, JaxServeConfig(**SHAPE),
                              JaxFleetConfig(1, 2), chaos=plan)
        reqs = [fleet.submit(p, max_new=MAX_NEW) for p in prompts]
        with jax_chaos.activate(plan):
            s = fleet.run()
        out[name] = ([list(r.generated) for r in reqs], s,
                     0 if plan is None else len(plan.fired))
    return out


def _fleet_run(params, prompts, plan=None, *, fcfg=FleetConfig(1, 2),
               max_new=MAX_NEW, scfg=SCFG, slots=SLOTS):
    fleet = ServeFleet(params, CFG, scfg, fcfg, chaos=plan, devices=slots)
    reqs = [fleet.submit(p, max_new=max_new) for p in prompts]
    with chaos.activate(plan):
        s = fleet.run()
    return fleet, reqs, s


# -- the handoff in isolation --------------------------------------------------

def _pools(seed):
    rng = np.random.default_rng(seed)
    return [[{k: rng.standard_normal((6, 2, 4, 8)).astype(np.float32)
              for k in ("k", "v")} for _ in range(2)] for _ in range(2)]


@pytest.mark.parametrize("integrity", [False, True])
def test_handoff_pages_land_like_jax(integrity):
    src_h, dst_h = _pools(0)
    plan = handoff_lib.make_plan(n_layers=2, kv_local=2, page_size=4,
                                 head_dim=8, n_pages=6, n_move=3)
    jplan = jax_handoff.make_plan(n_layers=2, kv_local=2, page_size=4,
                                  head_dim=8, n_pages=6, n_move=3)
    devs = jax.devices()
    mesh = jax_handoff.pair_mesh(devs[0], devs[1])
    src_pages, dst_pages = [1, 3, 5], [2, 4, 1]
    expect = None
    if integrity:
        from fpga_ai_nic_tpu.ops import integrity as jax_integrity
        ledger = np.asarray(jax_integrity.page_checksums(
            [{k: jnp.asarray(v) for k, v in lyr.items()} for lyr in src_h]))
        expect = ledger[src_pages]
    jres = jax_handoff.apply_handoff(
        jplan, mesh,
        [{k: jax.device_put(jnp.asarray(v), devs[0])
          for k, v in lyr.items()} for lyr in src_h],
        [{k: jax.device_put(jnp.asarray(v), devs[1])
          for k, v in lyr.items()} for lyr in dst_h],
        src_pages, dst_pages, expect=expect)
    src = [{k: torch.from_numpy(v.copy()) for k, v in lyr.items()}
           for lyr in src_h]
    dst = [{k: torch.from_numpy(v.copy()) for k, v in lyr.items()}
           for lyr in dst_h]
    res = handoff_lib.apply_handoff(plan, src, dst, src_pages, dst_pages,
                                    expect=expect)
    assert len(res) == len(jres) == (4 if integrity else 2)
    for li in range(2):
        for k in ("k", "v"):
            got = res[1][li][k].numpy()
            np.testing.assert_array_equal(got, np.asarray(jres[1][li][k]))
            np.testing.assert_array_equal(got[dst_pages],
                                          src_h[li][k][src_pages])
            np.testing.assert_array_equal(got[[0, 3, 5]],
                                          dst_h[li][k][[0, 3, 5]])
            np.testing.assert_array_equal(res[0][li][k].numpy(),
                                          src_h[li][k])
    if integrity:
        assert res[2] is True and jres[2] is True
        np.testing.assert_array_equal(res[3], jres[3])
        np.testing.assert_array_equal(res[3], expect)
        bad = np.array(expect)
        bad[1] ^= 1
        assert handoff_lib.apply_handoff(plan, src, dst, src_pages,
                                         dst_pages, expect=bad)[2] is False


@pytest.mark.parametrize("n_move", [1, 4, 7])
def test_plan_bytes_equal_jax(n_move):
    for dtype in (None, "bfloat16"):
        plan = handoff_lib.plan_for(CFG, SCFG, n_move, dtype=dtype)
        jplan = jax_handoff.plan_for(JCFG, JaxServeConfig(**SHAPE), n_move,
                                     dtype=dtype)
        assert plan.describe() == jplan.describe()
        assert plan.host_bytes(17) == jplan.host_bytes(17)
    page = np.zeros((CFG.n_kv_heads, SCFG.page_size, CFG.head_dim),
                    np.float32)
    assert handoff_lib.plan_for(CFG, SCFG, n_move).wire_bytes() == \
        2 * CFG.n_layers * n_move * page.nbytes
    with pytest.raises(AssertionError):
        handoff_lib.make_plan(n_layers=1, kv_local=1, page_size=4,
                              head_dim=8, n_pages=4, n_move=4)


def test_handoff_program_equals_jax():
    for n in range(1, 5):
        assert [tuple(m) for m in opstream.handoff_program(n)] == \
            [tuple(m) for m in jax_opstream.handoff_program(n)]
    assert handoff_lib.handoff_program is opstream.handoff_program


# -- the disaggregated fleet -------------------------------------------------

def test_disaggregated_fleet_equals_jax(world, jax_runs):
    _, params, prompts, ref = world
    jstreams, js, _ = jax_runs["steady"]
    fleet, reqs, s = _fleet_run(params, prompts)
    assert [r.generated for r in reqs] == jstreams == ref
    for key in COUNTERS:
        assert s[key] == js[key], key
    assert s["handoffs"] == len(prompts) and s["fleet_replays"] == 0
    assert s["slo"] == js["slo"]
    for mine, theirs in zip(s["replicas"], js["replicas"]):
        assert mine["role"] == theirs["role"]
        assert mine["trace_counts"] == theirs["trace_counts"]
        if mine["role"] == "prefill":
            assert mine["decode_calls"] == 0 and mine["prefill_calls"] > 0
        else:
            assert mine["prefill_calls"] == 0 and mine["decode_calls"] > 0
    # the wire bytes are the sum of the events' plan declarations
    events = [e for e in fleet.profiler.events.snapshot()
              if e["name"] == "fleet.handoff"]
    assert s["handoff_wire_bytes"] == sum(
        handoff_lib.plan_for(CFG, SCFG, e["attrs"]["pages"]).wire_bytes()
        for e in events) > 0


def test_kill_streams_and_counters_equal_jax(world, jax_runs):
    _, params, prompts, _ = world
    jstreams, js, jfired = jax_runs["kill"]
    steady = jax_runs["steady"][0]
    plan = chaos.FaultPlan(
        [chaos.FaultSpec("preemption", "fleet.membership", step=6)], seed=11)
    _, reqs, s = _fleet_run(params, prompts, plan)
    assert len(plan.fired) == jfired == 1
    assert [list(r.generated) for r in reqs] == jstreams == steady
    for key in COUNTERS:
        assert s[key] == js[key], key
    assert s["kills"] == 1 and s["fleet_replays"] == 0
    assert s["serve_recoveries"] == 0
    assert s["handoffs"] > jax_runs["steady"][1]["handoffs"]
    assert s["recovery"]["faults"] == js["recovery"]["faults"] == {
        "replica_kill": 1}
    assert s["recovery"]["mttr_mean_s"] > 0
    assert [r["alive"] for r in s["replicas"]] == \
        [r["alive"] for r in js["replicas"]]
    assert s["slo"] == js["slo"]


def test_kill_last_decode_promotes_survivor(world):
    _, params, prompts, ref = world
    plan = chaos.FaultPlan(
        [chaos.FaultSpec("preemption", "fleet.membership", step=5)], seed=3)
    _, reqs, s = _fleet_run(params, prompts[:4], plan,
                            fcfg=FleetConfig(1, 1))
    assert s["kills"] == 1 and s["completed"] == 4
    assert [r.generated for r in reqs] == ref[:4]
    assert "both" in {r["role"] for r in s["replicas"]}


def test_mid_prefill_migration_keeps_partial_kv(world):
    _, params, _, _ = world
    prompt = np.random.default_rng(5).integers(0, CFG.vocab, 20).astype(
        np.int32)
    fleet = ServeFleet(params, CFG, SCFG, FleetConfig(1, 1), devices=SLOTS)
    req = fleet.submit(prompt, max_new=4)
    while req.prefill_done == 0 or req.state != PREFILL:
        fleet.tick()
    assert 0 < req.prefill_done < req.replay_len
    fleet.kill_replica(0)
    assert req.state == PREFILL and fleet.fleet_replays == 0
    s = fleet.run()
    assert req.generated == _generate(params, prompt, 4)
    assert s["fleet_replays"] == 0 and s["handoffs"] >= 1


def test_planned_scale_down_via_kill_replica(world):
    _, params, prompts, ref = world
    fleet = ServeFleet(params, CFG, SCFG, FleetConfig(1, 2), devices=SLOTS)
    reqs = [fleet.submit(p, max_new=MAX_NEW) for p in prompts]
    for _ in range(6):
        fleet.tick()
    fleet.kill_replica([r for r in fleet.replicas
                        if r.role == "decode"][0].idx)
    s = fleet.run()
    assert s["completed"] == len(prompts)
    assert [r.generated for r in reqs] == ref
    assert s["fleet_replays"] == 0 and s["serve_recoveries"] == 0


def test_handoff_exception_degrades_to_one_replay(world):
    _, params, _, _ = world
    prompts = _prompts(4, 4, 10, 4)
    scfg = ServeConfig(max_reqs=3, page_size=4, n_pages=24,
                       max_pages_per_seq=6, prefill_chunk=6)
    plan = chaos.FaultPlan(
        [chaos.FaultSpec("exception", "serve.handoff", step=2)], seed=2)
    _, reqs, s = _fleet_run(params, prompts, plan, max_new=4, scfg=scfg)
    assert len(plan.fired) == 1
    assert s["fleet_replays"] == 1
    assert s["recovery"]["faults"] == {"exception": 1}
    assert s["completed"] == 4
    assert [r.generated for r in reqs] == [_generate(params, p, 4)
                                           for p in prompts]


def test_full_decode_fleet_parks_not_replays(world):
    _, params, _, _ = world
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, CFG.vocab, 4).astype(np.int32)
               for _ in range(10)]
    scfg = ServeConfig(max_reqs=4, page_size=4, n_pages=24,
                       max_pages_per_seq=6, prefill_chunk=6)
    _, reqs, s = _fleet_run(params, prompts, fcfg=FleetConfig(1, 1),
                            max_new=8, scfg=scfg)
    assert s["completed"] == 10
    assert s["fleet_replays"] == 0 and s["serve_recoveries"] == 0
    assert [r.generated for r in reqs] == [_generate(params, p, 8)
                                           for p in prompts]


def test_handoff_wirebit_trips_and_one_retry_absorbs_it(world):
    """A flipped bit on the handoff wire fails the landed-page check; the
    one bounded retry re-sends the intact source pages: zero replays, the
    streams unchanged.  One spec a tick, so whichever tick migrates
    trips."""
    _, params, prompts, ref = world
    plan = chaos.FaultPlan(
        [chaos.FaultSpec("corruption", "serve.handoff", step=s,
                         mode="wirebit", fraction=0.2) for s in range(20)],
        seed=11)
    chaos.install_wire_tap()
    try:
        _, reqs, s = _fleet_run(params, prompts, plan)
    finally:
        chaos.uninstall_wire_tap()
    assert s["handoff_integrity_trips"] >= 1
    assert s["fleet_replays"] == 0 and s["serve_recoveries"] == 0
    assert [r.generated for r in reqs] == ref


# -- construction, the fleet's fault sites -------------------------------------

def test_fleet_config_and_slots(world):
    _, params, _, _ = world
    with pytest.raises(ValueError):
        FleetConfig(n_prefill=0)
    with pytest.raises(ValueError):
        FleetConfig(n_decode=0)
    assert FleetConfig(2, 3).n_replicas == 5
    with pytest.raises(ValueError, match="devices"):
        ServeFleet(params, CFG, SCFG, FleetConfig(1, 1), devices=["cpu"])
    fleet = ServeFleet(params, CFG, SCFG, FleetConfig(1, 1),
                       devices=["cpu"] * 4)
    assert fleet.spare_devices == 2
    # replicas on one device share the weights; each has its own pool
    a, b = fleet.replicas[0].engine, fleet.replicas[1].engine
    assert a.params["tok_emb"] is b.params["tok_emb"]
    assert a.pool[0]["k"] is not b.pool[0]["k"]
    assert fleet.add_replica().engine.role == "decode"
    assert fleet.add_replica("both") is not None
    assert fleet.add_replica() is None and fleet.grows == 2
    if not torch.cuda.is_available():     # the default slots are the card
        with pytest.raises(RuntimeError, match="cuda"):
            ServeFleet(params, CFG, SCFG, FleetConfig(1, 1))


def test_fleet_fault_sites_fire_as_jax():
    """``fire`` sleeps for hang and slowdown and raises one preemption or
    exception a call, in JAX's order; the other sites' specs construct
    as JAX's do (or raise JAX's ValueError)."""
    def specs(mod):
        return [mod.FaultSpec("slowdown", "fleet.membership", step=0,
                              duration_s=0.001),
                mod.FaultSpec("exception", "fleet.membership", step=0),
                mod.FaultSpec("preemption", "fleet.membership", step=0),
                mod.FaultSpec("hang", "serve.handoff", step=1,
                              duration_s=0.001)]

    seen = []
    for mod in (chaos, jax_chaos):
        plan = mod.FaultPlan(specs(mod), seed=1)
        got = []
        for step, site in ((0, "fleet.membership"), (0, "fleet.membership"),
                           (0, "fleet.membership"), (1, "serve.handoff")):
            plan.begin_step(step)
            try:
                plan.fire(site)
                got.append("ok")
            except mod.InjectedPreemption as err:
                got.append(("preemption", err.kind, err.site))
            except mod.InjectedFault as err:
                got.append(("fault", err.kind, err.site))
        seen.append((got, [(f.kind, f.site, f.step) for f in plan.fired]))
    assert seen[0] == seen[1]
    assert seen[0][0][:3] == [("preemption", "preemption",
                               "fleet.membership"),
                              ("fault", "exception", "fleet.membership"),
                              "ok"]
    chaos.FaultSpec("corruption", "serve.handoff", step=0, mode="wirebit")
    chaos.FaultSpec("corruption", "serve.handoff", step=0, mode="nan")
    chaos.FaultSpec("preemption", "serve.step", step=0)
    for mod in (chaos, jax_chaos):
        with pytest.raises((ValueError, AssertionError)):
            mod.FaultSpec("exception", "collective", step=0)
    pool = [{"k": torch.zeros(3, 2), "v": torch.zeros(3, 2)}]
    assert chaos.state_buffers_alive(pool)
    pool[0]["v"].untyped_storage().resize_(0)
    assert not chaos.state_buffers_alive(pool)


# -- the drivers ---------------------------------------------------------------

TINY_FLEET = ["--model=tiny", "--device=cpu", "--prompt_lo=4",
              "--prompt_hi=16", "--output_lo=2", "--output_hi=8",
              "--page_size=8", "--n_pages=28", "--max_pages_per_seq=8",
              "--prefill_chunk=8"]


@pytest.mark.parametrize("scenario", serve_fleet.SCENARIOS)
def test_serve_fleet_driver_on_cpu(scenario):
    out = serve_fleet.main(TINY_FLEET + [f"--scenario={scenario}"])
    json.dumps(out)
    block = out["slo_block"]
    assert out["completed"] == out["n_requests"] == out["traffic"][
        "n_requests"]
    assert block["tokens_lost"] == 0 and out["recompiles_steady"] == 0
    assert out["serve_recoveries"] == 0
    assert out["chaos_fired"] == (scenario in serve_fleet.KILL_TICK)
    assert out["kills"] - block.get("scale_ins", 0) == out["chaos_fired"]
    if scenario in serve_fleet.CLOSED_LOOP:
        assert "decision_sequence" in block
    if scenario == "thundering_herd":
        assert block["scale_outs"] >= 1 and out["grows"] >= 1
    if scenario in ("steady", "replica_kill"):
        assert out["fleet_replays"] == 0 and out["handoffs"] >= 12
    with pytest.raises(ValueError, match="scenario"):
        serve_fleet.main(TINY_FLEET + ["--scenario=bogus"])


def test_generate_llama_equals_jax_driver(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "jax_generate_llama", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "examples", "generate_llama.py"))
    jax_driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_driver)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_driver.main(["--new=12", "--prompt=the ring"])
    want = json.loads(buf.getvalue())
    jc = dataclasses.replace(jax_llama.LlamaConfig.tiny(), vocab=384)
    params = llama.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_llama.init(jax.random.PRNGKey(0), jc)), "cpu")
    got = generate_llama.main(["--device=cpu", "--new=12",
                               "--prompt=the ring"], params=params)
    assert got["continuation"] == want["continuation"]
    assert got["tokens"] == want["tokens"] == 1 + len("the ring") + 12
    sampled = generate_llama.main(["--device=cpu", "--new=8",
                                   "--temperature=0.8", "--seed=3"])
    assert sampled == generate_llama.main(["--device=cpu", "--new=8",
                                           "--temperature=0.8", "--seed=3"])
    # --ckpt restores a checkpoint (tests/test_torch_checkpoint.py); an
    # empty directory has none, as JAX's driver says
    with pytest.raises(SystemExit, match="no checkpoint"):
        generate_llama.main(["--device=cpu", f"--ckpt={tmp_path}"])
