"""The port's control-plane model (``fpga_ai_nic_tpu_torch.verify.sched``)
over its one ``SCHED_RULES``: the JAX package's ``tests/test_sched.py``
run on the port, with the model's verdicts and state counts held equal
to JAX's ``verify.sched`` on the same cells.

  - state-name constants shared with ``runtime.requests`` by VALUE;
  - the clean envelope (>= 150 exhaustive cells over reqs x pages x
    replicas x fault) green, faults included, every cell's states equal
    to JAX's;
  - each seeded mutant trips EXACTLY its intended violation kind, as
    JAX's does;
  - POR-vs-naive verdict agreement on clean AND mutated cells;
  - randomized-scheduler fuzz green on clean cells;
  - counterexample replay export (pretty print + Perfetto JSON);
  - one definition by IDENTITY (``verify.opstream``'s ``SCHED_RULES`` is
    the scheduler's, fleet's, autoscaler's, ``tune.adapt``'s and
    ``serve.sched_rules``'s) and by consumption-site inspection;
  - ``DriftDetector.update`` == the pure ``cusum_step`` rule;
  - the admission watermark at the EXACT boundary;
  - ``PageAllocator`` property-fuzzed against a reference ledger, with
    the exhaustive sweep behind -m slow.
"""

import inspect
import json
import os

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

from fpga_ai_nic_tpu.verify import mc as jmc
from fpga_ai_nic_tpu.verify import sched as jsched
from fpga_ai_nic_tpu_torch.runtime.requests import (DECODE, FINISHED,
                                                    PREFILL, WAITING,
                                                    Request)
from fpga_ai_nic_tpu_torch.serve.paged import PageAllocator, ServeConfig
from fpga_ai_nic_tpu_torch.serve.scheduler import ContinuousBatcher
from fpga_ai_nic_tpu_torch.verify import (SCHED_RULES, build_sched,
                                          sched_cells)
from fpga_ai_nic_tpu_torch.verify.mc import Violation, check, run_random
from fpga_ai_nic_tpu_torch.verify.opstream import (SCHED_DECODE,
                                                   SCHED_FINISHED,
                                                   SCHED_PREFILL,
                                                   SCHED_WAITING,
                                                   SchedEmitter)
from fpga_ai_nic_tpu_torch.verify.replay import export_counterexample
from fpga_ai_nic_tpu_torch.verify.sched import (SCHED_FAULTS, SCHED_MUTANTS,
                                                SchedModel)

# one cell per mutant, the smallest fault-free cell whose clean run
# provably reaches the mutated rule (probed exhaustively; the full
# sweeps below confirm these are not the only ones)
MUTANT_PIN = {
    "leak_evict": (2, 4, 1, "none"),
    "drop_watermark": (2, 2, 1, "none"),
    "no_evict": (3, 4, 2, "none"),
    "drop_cooldown": (3, 3, 2, "none"),
}


class TestEnvelopeShape:
    def test_state_constants_pinned_to_runtime(self):
        # the model's request-state strings ARE the runtime's: a rename
        # on either side breaks the delegation silently otherwise
        assert SCHED_WAITING == WAITING
        assert SCHED_PREFILL == PREFILL
        assert SCHED_DECODE == DECODE
        assert SCHED_FINISHED == FINISHED

    def test_envelope_meets_acceptance_floor(self):
        cells = list(sched_cells())
        assert len(cells) >= 150
        assert len(set(cells)) == len(cells)
        rs = {c[0] for c in cells}
        ps = {c[1] for c in cells}
        ks = {c[2] for c in cells}
        fs = {c[3] for c in cells}
        assert rs == {1, 2, 3, 4} and ps == {2, 3, 4, 5, 6}
        assert ks == {1, 2, 3} and fs == set(SCHED_FAULTS)


class TestCleanEnvelope:
    def test_full_envelope_green(self):
        # the headline guarantee: every cell, faults included, is
        # exhaustively explored with zero violations (~0.2 s total)
        states = 0
        for cell in sched_cells():
            res = check(build_sched(*cell))
            assert res.ok, (cell, res.violation and res.violation.message)
            assert res.terminal_paths >= 1
            states += res.states
        assert states > 10_000      # the exploration is not vacuous

    def test_random_fuzz_clean(self):
        for cell in [(2, 4, 2, "kill"), (3, 5, 3, "handoff-fail"),
                     (4, 6, 3, "kill"), (4, 6, 1, "none")]:
            for seed in range(4):
                assert run_random(build_sched(*cell), seed=seed) > 0


class TestEqualJax:
    def test_every_cell_explores_jax_states(self):
        for cell in sched_cells():
            a = check(build_sched(*cell))
            b = jmc.check(jsched.build_sched(*cell))
            assert (a.ok, a.states, a.branch_points, a.terminal_paths) == \
                (b.ok, b.states, b.branch_points, b.terminal_paths), cell

    def test_mutants_trip_as_jax(self):
        assert SCHED_MUTANTS == jsched.SCHED_MUTANTS
        assert SCHED_FAULTS == jsched.SCHED_FAULTS
        for mut in SCHED_MUTANTS:
            a = check(build_sched(*MUTANT_PIN[mut], mutate=mut))
            b = jmc.check(jsched.build_sched(*MUTANT_PIN[mut], mutate=mut))
            assert (a.violation.kind, a.violation.message,
                    a.violation.trace) == (b.violation.kind,
                                           b.violation.message,
                                           b.violation.trace), mut


class TestMutants:
    def test_pinned_mutants_trip_their_kind(self):
        for mut, kind in SCHED_MUTANTS.items():
            res = check(build_sched(*MUTANT_PIN[mut], mutate=mut))
            assert not res.ok, mut
            assert res.violation.kind == kind, (mut, res.violation.kind)
            assert res.violation.message
            assert len(res.violation.trace) > 0

    def test_mutant_sweep_trips_only_its_kind(self):
        # full grid x all four mutants: a mutant may stay green on a
        # cell too small to reach its rule, but when it trips, the kind
        # is ALWAYS the intended one — and each trips a healthy share
        floors = {"leak_evict": 20, "drop_watermark": 60,
                  "no_evict": 8, "drop_cooldown": 15}
        for mut, kind in SCHED_MUTANTS.items():
            tripped = 0
            for cell in sched_cells():
                res = check(build_sched(*cell, mutate=mut))
                if not res.ok:
                    assert res.violation.kind == kind, (mut, cell)
                    tripped += 1
            assert tripped >= floors[mut], (mut, tripped)


class TestPorNaiveAgreement:
    def test_clean_cells_agree(self):
        for cell in sched_cells():
            a = check(build_sched(*cell), por=True)
            b = check(build_sched(*cell), por=False)
            assert a.ok and b.ok, cell

    def test_mutated_pins_agree(self):
        for mut, kind in SCHED_MUTANTS.items():
            a = check(build_sched(*MUTANT_PIN[mut], mutate=mut), por=True)
            b = check(build_sched(*MUTANT_PIN[mut], mutate=mut), por=False)
            assert (not a.ok) and (not b.ok), mut
            assert a.violation.kind == b.violation.kind == kind

    @pytest.mark.slow
    def test_mutated_full_grid_agrees(self):
        for mut in SCHED_MUTANTS:
            for cell in sched_cells():
                a = check(build_sched(*cell, mutate=mut), por=True)
                b = check(build_sched(*cell, mutate=mut), por=False)
                assert a.ok == b.ok, (mut, cell)
                if not a.ok:
                    assert a.violation.kind == b.violation.kind, (mut, cell)


class TestCounterexampleReplay:
    def test_export_txt_and_perfetto(self, tmp_path):
        model = build_sched(*MUTANT_PIN["leak_evict"],
                            mutate="leak_evict")
        res = check(model)
        assert not res.ok
        txt, js = export_counterexample(model, res.violation,
                                        str(tmp_path))
        assert os.path.exists(txt) and os.path.exists(js)
        body = open(txt).read()
        assert "conservation" in body
        with open(js) as f:
            doc = json.load(f)
        assert doc["traceEvents"], "Perfetto export is empty"

    def test_violation_is_assertion_error(self):
        # simulate_rs_protocol-style callers catch AssertionError
        assert issubclass(Violation, AssertionError)


class TestDelegationIdentity:
    """The model checks the SAME rule objects the hot paths run, pinned
    by identity, and no hand transcription of any emitted rule survives
    in the consumers."""

    def test_singleton_shared_by_all_consumers(self):
        import fpga_ai_nic_tpu_torch.serve.autoscale as autoscale
        import fpga_ai_nic_tpu_torch.serve.fleet as fleet
        import fpga_ai_nic_tpu_torch.serve.scheduler as scheduler
        import fpga_ai_nic_tpu_torch.tune.adapt as adapt
        import fpga_ai_nic_tpu_torch.verify.sched as vsched
        assert scheduler._RULES is SCHED_RULES
        assert fleet._RULES is SCHED_RULES
        assert autoscale._RULES is SCHED_RULES
        assert adapt._SCHED_RULES is SCHED_RULES
        assert vsched.SCHED_RULES is SCHED_RULES
        import fpga_ai_nic_tpu_torch.serve.sched_rules as sched_rules
        assert sched_rules.SCHED_RULES is SCHED_RULES
        assert sched_rules.SchedEmitter is SchedEmitter

    def test_scheduler_has_no_hand_transcriptions(self):
        b = ContinuousBatcher
        src = inspect.getsource(b.enqueue)
        assert "_RULES.replay_target" in src
        src = inspect.getsource(b._committed_outstanding)
        assert "_RULES.committed_outstanding" in src
        assert "_RULES.committed_target" in src
        assert "max(" not in src
        src = inspect.getsource(b.admit)
        assert "_RULES.admit_ok" in src
        assert "_RULES.admission_need" in src
        assert ">=" not in src          # the watermark compare lives once
        src = inspect.getsource(b._eviction_victim)
        assert "_RULES.pick_victim" in src
        assert "max(" not in src and "sorted(" not in src
        src = inspect.getsource(b.prefill_work)
        assert "_RULES.pick_oldest" in src
        assert "_RULES.prefill_chunk_len" in src
        assert "min(" not in src
        src = inspect.getsource(b.decode_batch)
        assert "_RULES.decode_order" in src
        assert "_RULES.committed_target" in src
        assert "sorted(" not in src and "n_tokens + 1" not in src

    def test_autoscaler_has_no_hand_transcriptions(self):
        from fpga_ai_nic_tpu_torch.serve.autoscale import Autoscaler
        src = inspect.getsource(Autoscaler.observe_tick)
        assert "_RULES.load_residual" in src
        assert "- 1" not in src         # the residual arithmetic lives once
        src = inspect.getsource(Autoscaler._scale_up)
        assert "_RULES.scale_up_fallback" in src
        assert ">= 2" not in src
        src = inspect.getsource(Autoscaler._scale_down)
        assert "_RULES.scale_down_ok" in src
        assert "== 0" not in src
        src = inspect.getsource(Autoscaler._shed_valve)
        assert "_RULES.shed_action" in src

    def test_model_never_reimplements_rules(self):
        # the model file delegates every policy decision too: the
        # checker explores the shipped rules, not a transcription
        import fpga_ai_nic_tpu_torch.verify.sched as vsched
        src = inspect.getsource(vsched)
        assert src.count("SCHED_RULES.") >= 10


class TestDriftDetectorDelegation:
    def test_update_equals_pure_cusum_step(self):
        from fpga_ai_nic_tpu_torch.tune.adapt import DriftDetector
        det = DriftDetector(drift_rel=0.5, threshold=1.0,
                            cooldown_steps=3)
        pos = neg = 0.0
        cooldown = 0
        series = [0.3, 0.4, 2.0, -5.0, -5.0, -5.0, 0.0, -2.0, 0.1]
        for r in series:
            got = det.update(r)
            pos, neg, cooldown, want = SchedEmitter.cusum_step(
                pos, neg, cooldown, r, 0.5, 1.0, 3)
            assert got == want
            assert (det.pos, det.neg, det.cooldown) == (pos, neg, cooldown)

    def test_cooldown_blocks_opposite_trip(self):
        # the no-flap invariant the model checks, at the unit level: a
        # trip arms the cooldown, so the opposite trip cannot land
        # inside the window however hard the residual swings
        from fpga_ai_nic_tpu_torch.tune.adapt import DriftDetector
        det = DriftDetector(drift_rel=0.5, threshold=1.0,
                            cooldown_steps=3)
        trip = det.update(2.0)
        assert trip is not None and trip[0] == "slow"
        for _ in range(3):
            assert det.update(-100.0) is None     # disarmed window
        trip = det.update(-100.0)
        assert trip is not None and trip[0] == "fast"

    def test_update_source_delegates(self):
        from fpga_ai_nic_tpu_torch.tune.adapt import DriftDetector
        src = inspect.getsource(DriftDetector.update)
        assert "cusum_step" in src
        assert "max(" not in src        # the CUSUM arithmetic lives once


def _req(uid, plen, max_new):
    return Request(uid=uid,
                   prompt=np.arange(plen, dtype=np.int32),
                   max_new=max_new)


class TestWatermarkBoundary:
    """The admit-thrash regression, at the EXACT boundary: with
    free == promised the watermark defers (never admit-then-evict);
    with free - promised == need it admits, and that admission can run
    its replay + first decode without evicting anyone."""

    def _mk(self, n_pages):
        scfg = ServeConfig(max_reqs=2, page_size=1, n_pages=n_pages,
                           max_pages_per_seq=3, prefill_chunk=4)
        return scfg, ContinuousBatcher(scfg, PageAllocator(n_pages))

    def test_boundary_admit_then_defer(self):
        scfg, b = self._mk(n_pages=4)           # 3 usable pages
        a = _req(1, 2, 1)                       # replay 2 -> need 3
        b.enqueue(a)
        assert [r.uid for r in b.admit()] == [1]   # free - 0 == need: admit
        assert a.state == PREFILL
        c = _req(2, 1, 1)                       # need 2
        b.enqueue(c)
        # free == promised (3 == 3): defer, even though a slot is open
        assert any(s is None for s in b.slots)
        for _ in range(3):                      # stable, never oscillates
            assert b.admit() == []
        assert c.state == WAITING and b.waiting == [c]
        assert b.alloc.free == 3 and b.evictions == 0

    def test_boundary_admission_never_thrashes(self):
        scfg, b = self._mk(n_pages=4)
        a = _req(1, 2, 1)
        b.enqueue(a)
        b.admit()
        # the admitted request's whole promise (replay + first decode)
        # is claimable without a single eviction: need covered it
        assert b.ensure_pages(a, a.replay_len + 1)
        assert b.evictions == 0 and b.alloc.free == 0

    def test_one_page_past_boundary_admits(self):
        scfg, b = self._mk(n_pages=6)           # 5 usable pages
        b.enqueue(_req(1, 2, 1))                # promises 3
        c = _req(2, 1, 1)                       # need 2
        b.enqueue(c)
        # free - promised == need (5 - 3 == 2): the second admission
        # lands at ITS exact boundary
        assert [r.uid for r in b.admit()] == [1, 2]
        assert c.state == PREFILL

    def test_emitted_rule_is_the_boundary(self):
        assert not SCHED_RULES.admit_ok(3, 3, 2)
        assert not SCHED_RULES.admit_ok(4, 3, 2)
        assert SCHED_RULES.admit_ok(5, 3, 2)
        assert SCHED_RULES.admit_ok(6, 3, 2)


class _RefLedger:
    """Reference model of PageAllocator: an explicit free list
    (page n_pages-1 .. 1), alloc pops from the end, free extends — so
    comparing RETURNED ids pins the dirty-LIFO recycling order, not
    just the counts."""

    def __init__(self, n_pages):
        self.n_pages = n_pages
        self.free = list(range(n_pages - 1, 0, -1))

    def alloc(self, n):
        if len(self.free) < n:
            return None                 # all-or-None
        return [self.free.pop() for _ in range(n)]

    def free_pages(self, pages):
        self.free.extend(pages)


class TestPageAllocatorFuzz:
    def _fuzz(self, seed, n_pages, n_ops):
        rng = np.random.default_rng(seed)
        a = PageAllocator(n_pages)
        ref = _RefLedger(n_pages)
        held = []
        for _ in range(n_ops):
            if held and rng.random() < 0.45:
                k = int(rng.integers(1, len(held) + 1))
                batch = [held.pop() for _ in range(k)]
                a.free_pages(batch)
                ref.free_pages(batch)
            else:
                n = int(rng.integers(0, 4))
                got = a.alloc(n)
                want = ref.alloc(n)
                assert got == want      # ids AND order: dirty LIFO
                if got is not None:
                    held.extend(got)
            # conservation, every step
            assert a.free == len(ref.free)
            assert a.free + a.in_use == n_pages - 1
            assert a.in_use == len(held)
            assert len(set(held)) == len(held)
        return a, held

    def test_seeded_fuzz_matches_reference(self):
        for seed in range(6):
            a, held = self._fuzz(seed, n_pages=9, n_ops=250)
            a.free_pages(held)
            assert a.free == 8 and a.in_use == 0

    def test_double_free_detected(self):
        a = PageAllocator(5)
        got = a.alloc(2)
        a.free_pages(got)
        with pytest.raises(RuntimeError, match="double-free"):
            a.free_pages(got)

    def test_out_of_range_rejected(self):
        a = PageAllocator(5)
        with pytest.raises(ValueError):
            a.free_pages([0])           # the reserved null page
        with pytest.raises(ValueError):
            a.free_pages([5])

    def test_alloc_all_or_none_leaves_state_intact(self):
        a = PageAllocator(4)
        assert a.alloc(5) is None
        assert a.free == 3 and a.in_use == 0
        assert a.alloc(3) is not None
        assert a.alloc(1) is None and a.in_use == 3

    @pytest.mark.slow
    def test_exhaustive_sweep_agrees_with_envelope(self):
        # exhaustive alloc/free sequence exploration per pool size,
        # pinned to AGREE with the graftsched envelope verdict on every
        # overlapping fault-free cell: both say conservation holds
        for p in range(2, 7):
            assert self._exhaust_ok(p)
            for r in range(1, 5):
                for k in (1, 2, 3):
                    assert check(build_sched(r, p, k, "none")).ok

    def _exhaust_ok(self, pool):
        # DFS over every alloc(1..2)/free-batch sequence to depth 2*pool
        def step(a, ref, held, depth):
            if depth == 0:
                return True
            for n in (1, 2):
                a2, r2, h2 = _clone(a, ref, held)
                got = a2.alloc(n)
                if got != r2.alloc(n):
                    return False
                if got is not None:
                    h2.extend(got)
                if a2.free + a2.in_use != pool or a2.free != len(r2.free):
                    return False
                if not step(a2, r2, h2, depth - 1):
                    return False
            if held:
                for k in (1, len(held)):
                    a2, r2, h2 = _clone(a, ref, held)
                    batch = [h2.pop() for _ in range(k)]
                    a2.free_pages(batch)
                    r2.free_pages(batch)
                    if a2.free != len(r2.free):
                        return False
                    if not step(a2, r2, h2, depth - 1):
                        return False
            return True

        def _clone(a, ref, held):
            a2 = PageAllocator(a.n_pages)
            a2._free = list(a._free)
            a2.in_use = a.in_use
            a2.peak_in_use = a.peak_in_use
            r2 = _RefLedger(ref.n_pages)
            r2.free = list(ref.free)
            return a2, r2, list(held)

        return step(PageAllocator(pool + 1), _RefLedger(pool + 1),
                    [], 2 * pool)


@pytest.mark.slow
class TestSlowEnvelope:
    def test_fuzz_whole_envelope(self):
        for cell in sched_cells():
            for seed in range(3):
                assert run_random(build_sched(*cell), seed=seed) > 0

    def test_mutant_pins_fuzzable(self):
        # the randomized scheduler finds the pinned violations too for
        # the deterministic-path mutants (no fault-timing branching)
        for mut in ("leak_evict", "drop_watermark"):
            with pytest.raises(AssertionError):
                run_random(build_sched(*MUTANT_PIN[mut], mutate=mut),
                           seed=0)
