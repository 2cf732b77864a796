"""The port's protocol model checker (``fpga_ai_nic_tpu_torch.verify``)
against the JAX package's ``verify/`` and its ``tests/test_verify.py``.

- the streams: for every cell of every route the port's op streams (and
  slot windows) equal JAX's op for op, ``rs_plan`` and the streaming
  stream of each optimizer included;
- the counts: the port's corpus gives JAX's per-route cells, states and
  branch points, its POR comparison and its fuzz-run count, both computed
  live here;
- the links: the programs ``ops/ring_hier.py``, ``serve/handoff.py`` and
  ``parallel/reshard.py`` consume are ``verify.opstream``'s, and the one
  link to the CUDA ring: ``csrc/ring_rs.cu`` numbers and weights its
  emissions as ``RsEmitter(integrity=True)`` and ``msg_weight`` do;
- JAX's battery on the port's copy: plan invariants, DMA discipline, M2,
  green corner cells, POR soundness, the mutants, replay (text and
  Perfetto structure equal to JAX's on the same violation);
- the CLI ``python -m fpga_ai_nic_tpu_torch.verify``: green on the tree,
  non-zero with JAX's wording on each of JAX's eight ``mc_*`` fixtures
  (rewritten here as source over the port);
- the strict-annotation audit over the port's ``verify/``.
"""

import ast
import glob
import inspect
import json
import os
import subprocess
import sys
import textwrap

import pytest
from torch_threads import one_torch_thread  # noqa: F401

from fpga_ai_nic_tpu.verify import mc as jmc
from fpga_ai_nic_tpu.verify import opstream as jops
from fpga_ai_nic_tpu.verify import replay as jreplay
from fpga_ai_nic_tpu_torch.verify import mc, opstream, replay

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PLAN_CELLS = [(n, S, D) for n in (2, 3, 4, 6)
              for S in (1, 2, 4, 6) for D in (1, 2, 4, None)]


def _streams(model):
    """A model's op streams and slot window, whatever its family."""
    if hasattr(model, "streams"):
        return model.streams, None
    if hasattr(model, "ops"):
        return model.ops, getattr(model, "n_slots", None)
    return None, None


# ---------------------------------------------------------------------------
# the streams: the port's equal JAX's, op for op
# ---------------------------------------------------------------------------

def _route_cells():
    return {
        "flat": [c + (i,) for c in jmc.flat_cells() for i in (False, True)],
        "streaming": [c + v for c in jmc.flat_cells()
                      for v in ((None, False), ("adamw", False),
                                (None, True), ("adamw", True))],
        "ag": jmc.ag_cells(),
        "hier": [c + (i,) for c in jmc.hier_cells() for i in (False, True)],
        "reshard": [c + (i,) for c in jmc.reshard_cells()
                    for i in (False, True)],
        "handoff": jmc.handoff_cells(),
        "gather": jmc.gather_cells(),
    }


BUILDERS = {"flat": "build_flat", "streaming": "build_streaming",
            "ag": "build_ag", "hier": "build_hier",
            "reshard": "build_reshard", "handoff": "build_handoff",
            "gather": "build_gather"}


@pytest.mark.parametrize("route", sorted(BUILDERS))
def test_streams_equal_jax_every_cell(route):
    cells = _route_cells()[route]
    assert cells
    for cell in cells:
        ours = getattr(mc, BUILDERS[route])(*cell)
        theirs = getattr(jmc, BUILDERS[route])(*cell)
        assert _streams(ours) == _streams(theirs), (route, cell)
        assert ours.meta == theirs.meta, (route, cell)


@pytest.mark.parametrize("opt", [None, "sgd", "momentum", "adamw"])
def test_streaming_stream_equal_jax_each_optimizer(opt):
    for n, S, D in PLAN_CELLS:
        for integ in (False, True):
            assert opstream.rs_stream_op_stream(
                n, S, D, opt_kind=opt, integrity=integ) == \
                jops.rs_stream_op_stream(n, S, D, opt_kind=opt,
                                         integrity=integ), (n, S, D, integ)


def test_rs_plan_and_flat_stream_equal_jax():
    from fpga_ai_nic_tpu.ops import ring_pallas as rp
    for n, S, D in PLAN_CELLS:
        assert opstream.rs_plan(n, S, D) == jops.rs_plan(n, S, D)
        assert opstream.rs_plan(n, S, D) == rp._rs_plan(n, S, D)
        for integ in (False, True):
            assert opstream.rs_op_stream(n, S, D, integrity=integ) == \
                jops.rs_op_stream(n, S, D, integrity=integ)


def test_ag_schedule_and_gather_stream_equal_jax():
    for n in range(2, 7):
        for S in range(1, 7):
            k = opstream.ag_n_slots(n, S)
            assert k == jops.ag_n_slots(n, S)
            assert opstream.ag_schedule(n, S, k) == jops.ag_schedule(n, S, k)
            for lockstep in (False, True):
                assert opstream.ag_op_stream(n, S, lockstep=lockstep) == \
                    jops.ag_op_stream(n, S, lockstep=lockstep)
    for P, nl, d in jmc.gather_cells():
        assert opstream.paged_attend_op_stream(P, nl, d) == \
            jops.paged_attend_op_stream(P, nl, d)


def test_pair_programs_equal_jax():
    for n in range(2, 9):
        for ni in range(1, n + 1):
            if n % ni:
                continue
            for s in (1, 2, 3):
                assert opstream.hier_program(n, ni, s) == \
                    jops.hier_program(n, ni, s)
                for integ in (False, True):
                    assert opstream.hier_op_stream(n, ni, s, integ) == \
                        jops.hier_op_stream(n, ni, s, integ)
    for L in range(1, 5):
        assert opstream.handoff_program(L) == jops.handoff_program(L)
        for integ in (False, True):
            assert opstream.handoff_op_stream(L, integ) == \
                jops.handoff_op_stream(L, integ)
    for live in (37, 48, 100):
        for ns in range(1, 9):
            for nt in range(1, 9):
                cs, ct, nu = jmc.reshard_layout(live, ns, nt)
                assert mc.reshard_layout(live, ns, nt) == (cs, ct, nu)
                own = jops.reshard_owners(ns, nt)
                assert opstream.reshard_owners(ns, nt) == own
                for leaves in (1, 3):
                    assert opstream.reshard_op_stream(
                        live, cs, ct, nu, own, n_flat_leaves=leaves,
                        integrity=True) == jops.reshard_op_stream(
                        live, cs, ct, nu, own, n_flat_leaves=leaves,
                        integrity=True)


def test_sched_models_equal_jax():
    from fpga_ai_nic_tpu.verify import sched as jsched
    from fpga_ai_nic_tpu_torch.verify import sched
    assert sched.sched_cells() == jsched.sched_cells()
    for cell in sched.sched_cells()[::7]:
        ours, theirs = sched.build_sched(*cell), jsched.build_sched(*cell)
        assert ours.meta == theirs.meta
        assert mc.check(ours).states == jmc.check(theirs).states


# ---------------------------------------------------------------------------
# the counts: the port's corpus is JAX's, computed live
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpora():
    return mc.run_corpus(), jmc.run_corpus()


def test_corpus_counts_equal_jax(corpora):
    (f_ours, ours), (f_theirs, theirs) = corpora
    assert f_ours == [] and f_theirs == []
    assert [(r.route, r.cells, r.states, r.branch_points)
            for r in ours.routes] == \
        [(r.route, r.cells, r.states, r.branch_points)
         for r in theirs.routes]
    assert (ours.cells, ours.states, ours.branch_points, ours.fuzz_runs) \
        == (theirs.cells, theirs.states, theirs.branch_points,
            theirs.fuzz_runs)
    assert ours.compare == theirs.compare
    assert {r.route for r in ours.routes} == {
        "flat", "streaming", "ag", "hier", "reshard", "handoff", "gather",
        "sched"}
    for cmp in ours.compare:
        assert cmp["agree"] and cmp["reduction"] >= 5.0
    rec = mc.envelope_record(ours)
    assert rec["total_cells"] == ours.cells
    assert sum(r["states"] for r in rec["routes"]) == ours.states
    assert rec["failures"] == 0


# ---------------------------------------------------------------------------
# the links: what the port executes is opstream's
# ---------------------------------------------------------------------------

class TestDelegationIdentity:
    def test_hier_programs_are_consumed(self):
        from fpga_ai_nic_tpu_torch.ops import ring_hier as rh
        assert rh._opstream is opstream
        assert "_opstream.hier_program" in \
            inspect.getsource(rh.hier_reduce_scatter)
        assert "_opstream.hier_program" in \
            inspect.getsource(rh.hier_all_gather)

    def test_reshard_table_owners_layout_are_shared(self):
        from fpga_ai_nic_tpu_torch.parallel import reshard
        assert reshard.Transfer is opstream.Seg
        assert reshard.intersection_table is opstream.reshard_segments
        assert reshard.residual_owners is opstream.reshard_owners

    def test_reshard_consumes_the_action_programs(self):
        from fpga_ai_nic_tpu_torch.parallel import reshard
        src = inspect.getsource(reshard.transfer)
        for name in ("_opstream.reshard_leaf_actions",
                     "_opstream.reshard_residual_actions",
                     "_opstream.reshard_msg_bases"):
            assert name in src, name
        assert "_opstream.union_layout" in \
            inspect.getsource(reshard.make_plan)

    def test_handoff_program_is_shared(self):
        from fpga_ai_nic_tpu_torch.serve import handoff
        assert handoff.handoff_program is opstream.handoff_program
        assert "handoff_program(" in inspect.getsource(handoff.apply_handoff)

    def test_layout_matches_make_plan(self):
        """mc.reshard_layout (the grid-cell view) and the port's make_plan
        both consume opstream.union_layout."""
        from fpga_ai_nic_tpu_torch.parallel import reshard
        for live in (37, 48, 100):
            for ns in (2, 3, 4, 6, 8):
                for nt in (2, 3, 4, 6, 8):
                    if ns == nt:
                        continue
                    padded_src = -(-live // ns) * ns
                    padded_tgt = -(-live // nt) * nt
                    plan = reshard.make_plan(live, ns, padded_src, nt,
                                             padded_tgt, n_flat_leaves=1)
                    assert mc.reshard_layout(live, ns, nt) == (
                        plan.flat.chunk_src, plan.flat.chunk_tgt,
                        plan.flat.n_union)

    def test_msg_weight_is_hop_weight(self):
        """One weight scheme: the IR's plain formula equals the port's
        ``ops.integrity.hop_weight`` on ints and on tensors."""
        import torch
        from fpga_ai_nic_tpu_torch.ops import integrity
        msgs = [0, 1, 7, 1000, 2**31 - 1, 2**32 - 1]
        for msg in msgs:
            assert opstream.msg_weight(msg) == integrity.hop_weight(msg)
        t = integrity.hop_weight(torch.tensor(msgs, dtype=torch.int64))
        assert t.tolist() == [opstream.msg_weight(m) for m in msgs]

    @pytest.mark.parametrize("n,S", [(2, 1), (3, 2), (4, 4), (8, 3)])
    def test_ring_rs_cu_numbers_emissions_as_the_emitter(self, n, S):
        """``csrc/ring_rs.cu`` weights the frame of hop j (1..n-1), slice
        ks by 2q + 1 with q = (j - 1) * n_slices + ks; the emitter's
        chk_emit ids are the same q for each (hop, slice), each weighted
        msg_weight(q), and every emission has its arrival."""
        src = open(os.path.join(REPO, "fpga_ai_nic_tpu_torch", "csrc",
                                "ring_rs.cu")).read()
        assert "const unsigned q = (unsigned)(j - 1) * n_slices + ks;" in src
        assert "const unsigned hw = 2u * q + 1u;" in src
        ops, _ = opstream.rs_op_stream(n, S, 2, integrity=True)
        emits = [op for op in ops if op[0] == "chk_emit"]
        arrives = [op for op in ops if op[0] == "chk_arrive"]
        want = [(j - 1) * S + ks for j in range(1, n) for ks in range(S)]
        assert sorted(op[2] for op in emits) == want
        assert sorted(op[2] for op in arrives) == want
        for op in emits + arrives:
            assert op[3] == opstream.msg_weight(op[2]) == 2 * op[2] + 1

    def test_pipe_depth_is_jax_kernel_depth(self):
        from fpga_ai_nic_tpu.ops import ring_pallas as rp
        from fpga_ai_nic_tpu_torch.ops import ring_cuda
        assert opstream.DEFAULT_PIPE_DEPTH == rp._PIPE_DEPTH
        for n, S, D in [(4, 2, 2), (6, 6, 4), (3, 4, None)]:
            assert ring_cuda._rs_op_stream(n, S, D) == \
                rp._rs_op_stream(n, S, D)

    def test_opt_state_counts_match_optimizer_spec(self):
        from fpga_ai_nic_tpu_torch.utils.config import OptimizerSpec
        for kind, ns in opstream.OPT_N_STATE.items():
            assert OptimizerSpec(kind=kind).n_state == ns
        assert opstream.OPT_N_STATE == jops.OPT_N_STATE


# ---------------------------------------------------------------------------
# simulate_rs_protocol: the fuzz entry point on the ring module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_rs_protocol_simulation(n):
    from fpga_ai_nic_tpu.ops import ring_pallas as rp
    from fpga_ai_nic_tpu_torch.ops import ring_cuda
    for S in (1, 2, 4):
        for depth in (1, 2, 3, None):
            for seed in (0, 1, 2):
                ev = ring_cuda.simulate_rs_protocol(n, S, depth, seed)
                assert ev > 0
                assert ev == rp.simulate_rs_protocol(n, S, depth, seed)


def test_rs_protocol_simulation_catches_bad_window(monkeypatch):
    from fpga_ai_nic_tpu_torch.ops import ring_cuda
    real_stream = ring_cuda._rs_op_stream

    def bad_stream(n, S, depth):
        ops, n_slots = real_stream(n, S, depth)
        assert n_slots >= 2, "need a window to shrink"
        return [op for op in ops if op[0] != "credit_wait"], n_slots - 1

    monkeypatch.setattr(ring_cuda, "_rs_op_stream", bad_stream)
    with pytest.raises(AssertionError, match="overwrite|deadlock"):
        for seed in range(8):
            ring_cuda.simulate_rs_protocol(4, 2, 2, seed)


# ---------------------------------------------------------------------------
# plan invariants as properties of the emitted streams
# ---------------------------------------------------------------------------

class TestOpStreamInvariants:
    @pytest.mark.parametrize("streaming", [False, True])
    def test_raw_slot_cap_invariants(self, streaming):
        build = (opstream.rs_stream_op_stream if streaming
                 else opstream.rs_op_stream)
        for n, S, D in PLAN_CELLS:
            ops, n_slots = build(n, S, D)
            total = (n - 1) * S
            sends = {op[1]: i for i, op in enumerate(ops)
                     if op[0] == "send"}
            decodes = {op[1]: i for i, op in enumerate(ops)
                       if op[0] == "decode"}
            waits = [op[1] for op in ops if op[0] == "wait_send"]
            assert sorted(sends) == list(range(total))          # CAP
            assert sorted(decodes) == list(range(total))
            assert sorted(waits) == list(range(total))          # 1 wait
            for q, pos in sends.items():
                if q - S >= 0:                                   # RAW
                    assert decodes[q - S] < pos, (n, S, D, q)
                if q - n_slots >= 0:                             # SLOT
                    assert decodes[q - n_slots] < pos, (n, S, D, q)
                    guard = [i for i, op in enumerate(ops)
                             if op[0] == "wait_send"
                             and op[1] == q - n_slots]
                    assert min(guard) < pos, (n, S, D, q)

    @pytest.mark.parametrize("opt", [None, "sgd", "momentum", "adamw"])
    def test_streaming_dma_discipline_clean(self, opt):
        for n, S, D in PLAN_CELLS:
            for integ in (False, True):
                ops, _ = opstream.rs_stream_op_stream(
                    n, S, D, opt_kind=opt, integrity=integ)
                assert opstream.check_dma_discipline(ops) == [], \
                    (n, S, D, integ)

    def test_ag_dma_discipline_clean(self):
        for n in (2, 3, 4, 6):
            for S in (1, 2, 4, 6):
                for lockstep in (False, True):
                    ops, _ = opstream.ag_op_stream(n, S,
                                                   lockstep=lockstep)
                    assert opstream.check_dma_discipline(ops) == [], \
                        (n, S, lockstep)

    def test_dma_discipline_catches_dropped_wait(self):
        ops, _ = opstream.rs_stream_op_stream(4, 4, 2, opt_kind="adamw")
        mutated = [op for op in ops if op[:3] != ("dma_wait", "wb", 1)]
        msgs = opstream.check_dma_discipline(mutated)
        assert msgs and any("hazard" in m for m in msgs)
        assert msgs == jops.check_dma_discipline(mutated)

    def test_mutated_stream_fails_invariants(self):
        ops, n_slots = opstream.rs_op_stream(3, 2, 2)
        drop = next(i for i, op in enumerate(ops) if op[0] == "decode")
        model = opstream.RingModel(3, ops[:drop] + ops[drop + 1:],
                                   n_slots, meta={"mut": "no-decode"})
        assert not mc.check(model).ok

    def test_ag_schedule_emission_order_matches_execution(self):
        for n in (3, 4, 5, 6):
            for S in (2, 4, 5, 6):
                (content, fwd_j, own_at, own_j, _own_js,
                 _tails) = opstream.ag_schedule(n, S,
                                                opstream.ag_n_slots(n, S))
                for m in range((n - 1) * S):
                    if fwd_j[m] >= 0 and own_at[m] >= 0:
                        assert fwd_j[m] < own_j[own_at[m]], (n, S, m)


class TestPairStreams:
    def test_hier_streams_expand_the_program(self):
        for n, ni, s in [(4, 2, 1), (6, 2, 3), (6, 3, 2), (6, 1, 1),
                         (6, 6, 1)]:
            prog = opstream.hier_program(n, ni, s)
            streams = opstream.hier_op_stream(n, ni, s)
            assert len(streams) == n
            for ops in streams:
                sends = [op for op in ops if op[0] == "send_to"]
                per = {k: sum(1 for op in sends if op[2][0] == k)
                       for k in ("rs_intra", "rs_inter", "ag_inter",
                                 "ag_intra")}
                assert per["rs_intra"] == prog.rs_intra.hops
                assert per["rs_inter"] == \
                    prog.rs_inter.hops * prog.rs_inter.slices
                assert per["ag_inter"] == prog.ag_inter.hops
                assert per["ag_intra"] == prog.ag_intra.hops

    def test_hier_orders_intra_before_inter(self):
        for ops in opstream.hier_op_stream(6, 3, 2):
            kinds = [op[2][0] for op in ops if op[0] == "send_to"]
            if "rs_inter" in kinds and "rs_intra" in kinds:
                assert kinds.index("rs_inter") > max(
                    i for i, k in enumerate(kinds) if k == "rs_intra")

    def test_hier_rs_carry_messages_are_distinct(self):
        prog = opstream.hier_program(6, 2, 3)
        msgs = [prog.rs_intra.msg(s) for s in range(prog.rs_intra.hops)]
        msgs += [prog.rs_inter.msg(s, k)
                 for s in range(prog.rs_inter.hops)
                 for k in range(prog.rs_inter.slices)]
        assert len(msgs) == len(set(msgs))

    def test_reshard_wire_sends_match_owner_changes(self):
        for live, ns, nt in ((48, 6, 4), (37, 6, 3), (37, 3, 6)):
            cs, ct, nu = mc.reshard_layout(live, ns, nt)
            owners = opstream.reshard_owners(ns, nt)
            streams = opstream.reshard_op_stream(live, cs, ct, nu, owners)
            sends = sum(1 for ops in streams for op in ops
                        if op[0] == "send_to" and op[2][0] == "seg")
            segs = opstream.reshard_segments(live, cs, ct)
            assert sends == sum(1 for t in segs if t.src != t.dst)
            rsends = sum(1 for ops in streams for op in ops
                         if op[0] == "send_to" and op[2][0] == "resid")
            assert rsends == sum(1 for i, o in enumerate(owners) if i != o)

    def test_reshard_multi_leaf_messages_are_distinct(self):
        streams = opstream.reshard_op_stream(
            37, *mc.reshard_layout(37, 6, 4),
            residual_owners_map=opstream.reshard_owners(6, 4),
            n_flat_leaves=3, integrity=True)
        msgs = [op[2] for ops in streams for op in ops
                if op[0] == "chk_emit"]
        assert msgs and len(msgs) == len(set(msgs))


# ---------------------------------------------------------------------------
# M2: the static checksum-weight pass
# ---------------------------------------------------------------------------

def _collision_sinks():
    a, b = opstream.ListSink(), opstream.ListSink()
    for s in range(2):
        for k in range(2):
            w = (2 * s + 1) * (2 * k + 1)
            a.chk_emit((s, k), weight=w)
            a.ops.append(("send_to", 1, ("hop", s, k)))
            b.ops.append(("recv_from", 0, ("hop", s, k)))
            b.chk_arrive((s, k), weight=w)
    return a, b


class TestM2WeightPass:
    def test_green_on_every_integrity_route(self):
        assert opstream.check_weight_conservation(
            opstream.rs_op_stream(4, 2, 2, integrity=True)[0]) == []
        assert opstream.check_weight_conservation(
            opstream.rs_stream_op_stream(4, 4, 2, opt_kind="adamw",
                                         integrity=True)[0]) == []
        assert opstream.check_weight_conservation(
            opstream.hier_op_stream(6, 2, 3, integrity=True)) == []
        assert opstream.check_weight_conservation(
            opstream.reshard_op_stream(
                37, *mc.reshard_layout(37, 6, 4),
                residual_owners_map=opstream.reshard_owners(6, 4),
                n_flat_leaves=2, integrity=True)) == []
        assert opstream.check_weight_conservation(
            opstream.handoff_op_stream(2, integrity=True)) == []

    def test_collision_rejected(self):
        a, b = _collision_sinks()
        msgs = opstream.check_weight_conservation([a.ops, b.ops])
        assert any("weight collision" in m for m in msgs)

    def test_even_weight_rejected(self):
        a = opstream.ListSink()
        a.chk_emit(0, weight=4)
        a.chk_arrive(0, weight=4)
        msgs = opstream.check_weight_conservation(a.ops)
        assert any("EVEN weight" in m for m in msgs)

    def test_unpaired_emission_rejected(self):
        a = opstream.ListSink()
        a.chk_emit(0)
        msgs = opstream.check_weight_conservation(a.ops)
        assert any("arrival" in m for m in msgs)

    def test_mismatched_pair_weight_rejected(self):
        a = opstream.ListSink()
        a.chk_emit(0, weight=1)
        a.chk_arrive(0, weight=3)
        msgs = opstream.check_weight_conservation(a.ops)
        assert any("inconsistently" in m for m in msgs)

    def test_carries_are_independent(self):
        a = opstream.ListSink()
        a.chk_emit(0, carry="rs")
        a.chk_arrive(0, carry="rs")
        a.chk_emit(0, carry="ag")
        a.chk_arrive(0, carry="ag")
        assert opstream.check_weight_conservation(a.ops) == []

    def test_runs_inside_run_cell(self):
        a, b = _collision_sinks()
        static = mc._static_violations(opstream.PairModel([a.ops, b.ops]))
        assert static and static[0][0] == "weights"


# ---------------------------------------------------------------------------
# the exhaustive checker: green cells, POR, violations
# ---------------------------------------------------------------------------

class TestExhaustive:
    @pytest.mark.parametrize("route,cell", [
        ("flat", (6, 6, 4, False)), ("flat", (2, 1, 1, False)),
        ("flat", (5, 3, 3, True)),
        ("streaming", (6, 6, 4, None, False)),
        ("streaming", (6, 6, 4, "adamw", True)),
        ("streaming", (4, 4, 4, "momentum", False)),
        ("ag", (6, 6)), ("ag", (2, 1)), ("ag", (5, 5)), ("ag", (3, 3)),
        ("hier", (6, 2, 2, True)), ("hier", (6, 3, 1, False)),
        ("reshard", (37, 6, 4, True, True)),
        ("reshard", (37, 4, 6, True, False)),
        ("handoff", (2, True)), ("handoff", (3, False)),
    ])
    def test_corner_cells_green(self, route, cell):
        res, _model = mc.run_cell(route, cell)
        assert res.ok, res.violation
        assert res.states > 0
        assert res.states == jmc.run_cell(route, cell)[0].states

    def test_por_vs_naive_agree_and_reduce(self):
        for cell in mc.COMPARE_CELLS:
            por = mc.check(mc.build_flat(*cell), por=True)
            naive = mc.check(mc.build_flat(*cell), por=False)
            assert por.ok and naive.ok
            assert naive.states >= 5 * por.states, (cell, por.states,
                                                    naive.states)

    def test_por_catches_dropped_wait_recv(self):
        ops, n_slots = opstream.rs_op_stream(3, 2, 1)
        bad = [op for op in ops if op != ("wait_recv", 1)]
        for por in (True, False):
            res = mc.check(opstream.RingModel(3, bad, n_slots), por=por)
            assert not res.ok and res.violation.kind == "ordering", por

    @staticmethod
    def _sweep(n, ops, n_slots, max_states=300_000):
        for drop in range(len(ops)):
            mut = ops[:drop] + ops[drop + 1:]
            p = mc.check(opstream.RingModel(n, mut, n_slots),
                         por=True, max_states=max_states)
            q = mc.check(opstream.RingModel(n, mut, n_slots),
                         por=False, max_states=max_states)
            assert not (p.inconclusive or q.inconclusive), (n, drop)
            assert p.ok == q.ok, (n, drop, ops[drop],
                                  p.violation, q.violation)

    @pytest.mark.parametrize("cell", [(2, 2, 1), (2, 2, 2)])
    def test_mutation_sweep_verdict_agreement_fast(self, cell):
        ops, n_slots = opstream.rs_op_stream(*cell)
        self._sweep(cell[0], ops, n_slots)

    @pytest.mark.slow
    @pytest.mark.parametrize("cell", [(2, 3, 2), (3, 2, 1), (3, 2, 2)])
    def test_mutation_sweep_verdict_agreement_full(self, cell):
        ops, n_slots = opstream.rs_op_stream(*cell)
        self._sweep(cell[0], ops, n_slots)

    def test_ag_mutation_sweep_verdict_agreement_fast(self):
        ops, n_slots = opstream.ag_op_stream(2, 2)
        self._sweep(2, ops, n_slots)

    @pytest.mark.slow
    def test_ag_mutation_sweep_verdict_agreement_full(self):
        ops, n_slots = opstream.ag_op_stream(3, 2)
        self._sweep(3, ops, n_slots, max_states=3_000_000)

    def test_budget_exhaustion_is_inconclusive_not_a_violation(self):
        res = mc.check(mc.build_flat(4, 4, 2), por=False, max_states=50)
        assert not res.ok and res.inconclusive
        assert res.violation.kind == "budget"
        assert "INCONCLUSIVE" in str(res.violation)
        ops, n_slots = opstream.rs_op_stream(4, 2, 2)
        bad = [op for op in ops if op[0] != "credit_signal"]
        res2 = mc.check(opstream.RingModel(4, bad, n_slots))
        assert not res2.ok and not res2.inconclusive

    def test_por_vs_naive_agree_on_violation(self):
        ops, n_slots = opstream.rs_op_stream(3, 2, 2)
        bad = [op for op in ops if op[0] not in
               ("credit_wait", "credit_signal", "credit_drain")]
        assert not mc.check(opstream.RingModel(3, bad, n_slots),
                            por=True).ok
        assert not mc.check(opstream.RingModel(3, bad, n_slots),
                            por=False).ok

    def test_dropped_credit_signal_deadlocks(self):
        ops, n_slots = opstream.rs_op_stream(4, 2, 2)
        bad = [op for op in ops if op[0] != "credit_signal"]
        res = mc.check(opstream.RingModel(4, bad, n_slots))
        assert not res.ok and res.violation.kind == "deadlock"
        assert "protocol deadlock" in str(res.violation)

    def test_removed_window_recv_overwrites(self):
        ops, n_slots = opstream.rs_op_stream(4, 2, 2)
        bad = [op for op in ops if op[0] not in
               ("credit_wait", "credit_signal", "credit_drain")]
        res = mc.check(opstream.RingModel(4, bad, n_slots))
        assert not res.ok and res.violation.kind == "recv_overwrite"
        assert "recv-slot overwrite" in str(res.violation)

    def test_shrunk_physical_window_overwrites(self):
        ops, n_slots = opstream.rs_op_stream(4, 2, 2)
        bad = [op for op in ops if op[0] not in
               ("credit_wait", "credit_signal", "credit_drain")]
        res = mc.check(opstream.RingModel(4, bad, n_slots - 1))
        assert not res.ok and "overwrite" in str(res.violation)

    def test_ag_window_shrunk_to_s_plus_1_overwrites(self):
        ops, n_slots = opstream.ag_op_stream(4, 4)
        por = mc.check(opstream.RingModel(4, ops, n_slots - 1))
        assert not por.ok and por.violation.kind == "recv_overwrite"
        assert "recv-slot overwrite" in str(por.violation)
        naive = mc.check(opstream.RingModel(4, ops, n_slots - 1),
                         por=False, max_states=1_500_000)
        assert not naive.ok and not naive.inconclusive

    def test_ag_integrity_of_fixed_schedule(self):
        for cell in ((5, 5), (6, 5), (6, 6)):
            res, _ = mc.run_cell("ag", cell)
            assert res.ok, (cell, res.violation)

    def test_handoff_dropped_scatter_wait_orphans(self):
        src, dst = opstream.handoff_op_stream(2, integrity=True)
        bad_dst = [op for op in dst
                   if not (op[0] == "recv_from" and op[2][0] == "pool")]
        for por in (True, False):
            res = mc.check(opstream.PairModel([src, bad_dst]), por=por)
            assert not res.ok and res.violation.kind == "termination"
            assert "orphan" in str(res.violation)

    def test_handoff_hoisted_verdict_wait_deadlocks(self):
        src, dst = opstream.handoff_op_stream(2, integrity=True)
        vote_wait = ("recv_from", 1, ("vote", 1))
        bad_src = [vote_wait] + [op for op in src if op != vote_wait]
        for por in (True, False):
            res = mc.check(opstream.PairModel([bad_src, dst]), por=por)
            assert not res.ok and res.violation.kind == "deadlock"

    def test_mismatched_pair_order_deadlocks(self):
        streams = [[("recv_from", 1, ("x",)), ("send_to", 1, ("y",))],
                   [("recv_from", 0, ("y",)), ("send_to", 0, ("x",))]]
        res = mc.check(opstream.PairModel(streams))
        assert not res.ok and res.violation.kind == "deadlock"

    def test_orphan_payload_is_termination_violation(self):
        res = mc.check(opstream.PairModel([[("send_to", 1, ("x",))], []]))
        assert not res.ok and res.violation.kind == "termination"
        assert "orphan" in str(res.violation)

    def test_fuzz_backend_matches_exhaustive_on_mutants(self):
        ops, n_slots = opstream.rs_op_stream(4, 2, 2)
        bad = [op for op in ops if op[0] != "credit_signal"]
        with pytest.raises(AssertionError, match="deadlock"):
            for seed in range(8):
                m = opstream.RingModel(4, bad, n_slots)
                m.strict_terminal = False
                mc.run_random(m, seed=seed)

    def test_violations_equal_jax(self):
        """The same mutant gives JAX's verdict, message and trace."""
        cases = []
        ops, n_slots = opstream.rs_op_stream(4, 2, 2)
        for drop in (("credit_signal",),
                     ("credit_wait", "credit_signal", "credit_drain")):
            bad = [op for op in ops if op[0] not in drop]
            cases.append((opstream.RingModel(4, bad, n_slots),
                          jops.RingModel(4, bad, n_slots)))
        src, dst = opstream.handoff_op_stream(2, integrity=True)
        vote_wait = ("recv_from", 1, ("vote", 1))
        bad_src = [vote_wait] + [op for op in src if op != vote_wait]
        cases.append((opstream.PairModel([bad_src, dst]),
                      jops.PairModel([bad_src, dst])))
        for ours, theirs in cases:
            a, b = mc.check(ours), jmc.check(theirs)
            assert (a.ok, a.states, a.branch_points) == \
                (b.ok, b.states, b.branch_points)
            assert (a.violation.kind, a.violation.message,
                    a.violation.trace) == (b.violation.kind,
                                           b.violation.message,
                                           b.violation.trace)

    @pytest.mark.slow
    def test_full_envelope_green(self):
        findings, stats = mc.run_corpus()
        assert findings == [], [f.format() for f in findings]
        assert stats.cells >= 900


# ---------------------------------------------------------------------------
# counterexample replay
# ---------------------------------------------------------------------------

def _flat_violation(ops_mod, mc_mod):
    ops, n_slots = ops_mod.rs_op_stream(4, 2, 2)
    bad = [op for op in ops if op[0] not in
           ("credit_wait", "credit_signal", "credit_drain")]
    model = ops_mod.RingModel(
        4, bad, n_slots, meta={"route": "flat", "n": 4, "S": 2, "depth": 2})
    res = mc_mod.check(model)
    assert not res.ok and res.violation.trace
    return model, res.violation


class TestReplay:
    def test_per_node_trace_pretty_print(self):
        _model, v = _flat_violation(opstream, mc)
        text = replay.format_trace(v)
        assert "per-node op trace" in text
        assert "node 0:" in text and "node 3:" in text
        assert "VIOLATION" in text and "recv-slot overwrite" in text

    def test_text_and_perfetto_equal_jax(self):
        _m, ours = _flat_violation(opstream, mc)
        _m, theirs = _flat_violation(jops, jmc)
        assert replay.format_trace(ours) == jreplay.format_trace(theirs)
        a, b = replay.perfetto_trace(ours), jreplay.perfetto_trace(theirs)
        assert a["traceEvents"] == b["traceEvents"]
        assert a["otherData"]["stream_header"] == \
            b["otherData"]["stream_header"]

    def test_perfetto_export_structure(self, tmp_path):
        model, v = _flat_violation(opstream, mc)
        trace = replay.perfetto_trace(v)
        events = trace["traceEvents"]
        assert any(e.get("ph") == "i" and "VIOLATION" in e.get("name", "")
                   for e in events)
        assert any(e.get("pid") == 2 and e.get("ph") == "X"
                   for e in events)
        assert trace["otherData"]["stream_header"]["source"] == "graftmc"
        txt, js = replay.export_counterexample(model, v, str(tmp_path))
        assert os.path.exists(txt) and os.path.exists(js)
        with open(js) as fh:
            assert json.load(fh)["traceEvents"]

    def test_ag_violation_replays_with_lane_and_tickets(self, tmp_path):
        ops, n_slots = opstream.ag_op_stream(4, 4)
        model = opstream.RingModel(4, ops, n_slots - 1,
                                   meta={"route": "ag", "n": 4, "S": 4})
        res = mc.check(model)
        assert not res.ok and res.violation.kind == "recv_overwrite"
        text = replay.format_trace(res.violation)
        assert "per-node op trace" in text and "node 3:" in text
        events = replay.perfetto_trace(res.violation)["traceEvents"]
        lanes = {e.get("tid") for e in events
                 if e.get("pid") != 2 and e.get("tid") is not None}
        assert len(lanes) >= 4, lanes
        assert [e for e in events if e.get("pid") == 2 and e.get("ph") == "X"]
        txt, js = replay.export_counterexample(model, res.violation,
                                               str(tmp_path))
        assert os.path.exists(txt) and os.path.exists(js)

    def test_handoff_violation_replays_with_pair_tickets(self, tmp_path):
        src, dst = opstream.handoff_op_stream(2, integrity=True)
        vote_wait = ("recv_from", 1, ("vote", 1))
        bad_src = [vote_wait] + [op for op in src if op != vote_wait]
        model = opstream.PairModel([bad_src, dst],
                                   meta={"route": "handoff", "n_layers": 2})
        res = mc.check(model)
        assert not res.ok and res.violation.kind == "deadlock"
        assert "per-node op trace" in replay.format_trace(res.violation)
        events = replay.perfetto_trace(res.violation)["traceEvents"]
        assert any("VIOLATION" in e.get("name", "") for e in events)
        txt, js = replay.export_counterexample(model, res.violation,
                                               str(tmp_path))
        assert os.path.exists(txt) and os.path.exists(js)
        assert "handoff" in os.path.basename(txt)


# ---------------------------------------------------------------------------
# the strict-annotation audit over the port's verify/
# ---------------------------------------------------------------------------

def test_verify_fully_annotated():
    gaps = []
    for path in sorted(glob.glob(os.path.join(
            REPO, "fpga_ai_nic_tpu_torch", "verify", "*.py"))):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            a = node.args
            named = a.posonlyargs + a.args + a.kwonlyargs
            missing = [x.arg for i, x in enumerate(named)
                       if x.annotation is None
                       and not (i == 0 and x.arg in ("self", "cls"))]
            for va in (a.vararg, a.kwarg):
                if va is not None and va.annotation is None:
                    missing.append(va.arg)
            if node.returns is None:
                missing.append("return")
            if missing:
                gaps.append((os.path.basename(path), node.lineno,
                             node.name, missing))
    assert gaps == [], gaps


# ---------------------------------------------------------------------------
# the CLI: python -m fpga_ai_nic_tpu_torch.verify
# ---------------------------------------------------------------------------

def _run_cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "fpga_ai_nic_tpu_torch.verify", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_cli_green_on_the_tree(tmp_path):
    out = tmp_path / "envelope.json"
    proc = _run_cli("--out", str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "cells exhaustive" in proc.stdout
    assert "POR reduction" in proc.stdout
    for route in ("flat", "streaming", "ag", "hier", "reshard", "handoff",
                  "gather", "sched"):
        assert f"route {route}:" in proc.stdout
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["failures"] == 0
    assert last["total_cells"] >= 900
    assert json.loads(out.read_text()) == last
    assert last["wall_s"] <= last["wall_budget_s"]


FIXTURES = {
    # name: (source body, needle, code) — JAX's tests/lint_fixtures/mc_*
    "mc_bad_credit": ("""
        ops, n_slots = opstream.rs_op_stream(4, 2, 2)
        mutated = [op for op in ops if op[0] != "credit_signal"]
        return opstream.RingModel(
            4, mutated, n_slots,
            meta={"route": "fixture", "n": 4, "S": 2, "depth": 2,
                  "mutation": "dropped-credit-signal"})
        """, "protocol deadlock", "M1:"),
    "mc_bad_window": ("""
        ops, n_slots = opstream.rs_op_stream(4, 2, 2)
        mutated = [op for op in ops if op[0] not in
                   ("credit_wait", "credit_signal", "credit_drain")]
        return opstream.RingModel(
            4, mutated, n_slots,
            meta={"route": "fixture", "n": 4, "S": 2, "depth": 2,
                  "mutation": "credit-window-removed"})
        """, "recv-slot overwrite", "M1:"),
    "mc_bad_ag_window": ("""
        ops, n_slots = opstream.ag_op_stream(4, 4)
        return opstream.RingModel(
            4, ops, n_slots - 1,
            meta={"route": "fixture", "n": 4, "S": 4,
                  "mutation": "ag-window-shrunk-to-S+1"})
        """, "recv-slot overwrite", "M1:"),
    "mc_bad_handoff_wait": ("""
        src, dst = opstream.handoff_op_stream(2, integrity=True)
        mutated = [op for op in dst
                   if not (op[0] == "recv_from" and op[2][0] == "pool")]
        return opstream.PairModel(
            [src, mutated],
            meta={"route": "fixture", "n_layers": 2,
                  "mutation": "handoff-dropped-scatter-wait"})
        """, "orphan payload", "M1:"),
    "mc_bad_handoff_order": ("""
        src, dst = opstream.handoff_op_stream(2, integrity=True)
        vote_wait = ("recv_from", 1, ("vote", 1))
        assert vote_wait in src
        mutated = [vote_wait] + [op for op in src if op != vote_wait]
        return opstream.PairModel(
            [mutated, dst],
            meta={"route": "fixture", "n_layers": 2,
                  "mutation": "handoff-verdict-wait-hoisted"})
        """, "protocol deadlock", "M1:"),
    "mc_bad_weights": ("""
        a, b = opstream.ListSink(), opstream.ListSink()
        for s in range(2):
            for k in range(2):
                w = (2 * s + 1) * (2 * k + 1)
                a.chk_emit((s, k), weight=w)
                a.ops.append(("send_to", 1, ("hop", s, k)))
                b.ops.append(("recv_from", 0, ("hop", s, k)))
                b.chk_arrive((s, k), weight=w)
        return opstream.PairModel(
            [a.ops, b.ops],
            meta={"route": "fixture",
                  "mutation": "per-axis-weight-product-collision"})
        """, "weight collision", "M2:"),
    "mc_sched_leak": ("""
        model = sched.build_sched(2, 4, 1, "none", mutate="leak_evict")
        model.meta["route"] = "fixture"
        return model
        """, "page ledger broken", "M1:"),
    "mc_sched_overcommit": ("""
        model = sched.build_sched(2, 2, 1, "none", mutate="drop_watermark")
        model.meta["route"] = "fixture"
        return model
        """, "over-commit", "M1:"),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_cli_fails_loudly_on_each_fixture(name, tmp_path):
    body, needle, code = FIXTURES[name]
    assert os.path.exists(os.path.join(REPO, "tests", "lint_fixtures",
                                       name + ".py"))
    path = tmp_path / (name + ".py")
    path.write_text(
        "from fpga_ai_nic_tpu_torch.verify import opstream, sched\n\n\n"
        "def build():\n" + textwrap.indent(textwrap.dedent(body), "    "))
    cex = tmp_path / "cex"
    proc = _run_cli("--fixture", str(path), "--skip-corpus",
                    "--counterexamples", str(cex))
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert needle in proc.stdout, proc.stdout
    assert code in proc.stdout
    assert "corpus SKIPPED" in proc.stdout
    assert not json.loads(proc.stdout.strip().splitlines()[-1])["ok"]


def test_cli_skip_corpus_needs_a_fixture():
    proc = _run_cli("--skip-corpus", "--wall-budget", "300")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "corpus SKIPPED" not in proc.stdout
    assert "route flat:" in proc.stdout


def test_checker_imports_no_torch():
    """The model checker is plain Python: importing ``verify.mc`` (and
    the CLI's modules) leaves torch and numpy out of ``sys.modules``."""
    code = ("import sys\n"
            "import fpga_ai_nic_tpu_torch.verify.mc\n"
            "import fpga_ai_nic_tpu_torch.verify.lockset\n"
            "import fpga_ai_nic_tpu_torch.verify.replay\n"
            "print(sorted(m for m in ('torch', 'numpy', 'jax')\n"
            "             if m in sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_sched_rules_are_one_object():
    import fpga_ai_nic_tpu_torch.serve.sched_rules as sched_rules
    from fpga_ai_nic_tpu_torch.verify import SCHED_RULES, SchedEmitter
    assert sched_rules.SCHED_RULES is SCHED_RULES is opstream.SCHED_RULES
    assert sched_rules.SchedEmitter is SchedEmitter
