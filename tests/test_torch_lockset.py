"""The port's H1 happens-before/lockset pass (``verify/lockset.py`` over
``lint/``'s module context, finding record and suppression scan).

- the port is silent over its ``SCOPE`` (the JAX package's eight modules,
  resolved under ``fpga_ai_nic_tpu_torch/``), which needs the queue's side
  streams made under its lock;
- the pass fires on ``tests/lint_fixtures/h1_bad.py`` and is silent on
  ``h1_good.py`` (read as files), as JAX's pass is;
- it sees the port's real worker roots (``ElasticTrainer._attempt``, the
  watchdog's ``target@run``) and the ``CollectiveStats.issued`` write on
  them: silence comes from locks, not from a blind call graph;
- over ``SCOPE`` plus ``serve/engine.py``, ``utils/checkpoint.py``,
  ``runtime/requests.py`` and ``obs/slo.py`` the port's findings are JAX's
  over JAX's counterparts, computed live (the engine's step counters and
  ``Checkpointer.last_save`` are written on one thread or under a lock);
- a missing scope entry raises; a suppression comment marks a finding.
"""

import ast
import os
import shutil

import pytest
from torch_threads import one_torch_thread  # noqa: F401

from fpga_ai_nic_tpu.verify import lockset as jlockset
from fpga_ai_nic_tpu_torch.lint.engine import ModuleCtx
from fpga_ai_nic_tpu_torch.verify import lockset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
EXTRA = ("serve/engine.py", "utils/checkpoint.py", "runtime/requests.py",
         "obs/slo.py")


def _graph(paths):
    graph = lockset._Graph()
    ctxs = []
    for p in paths:
        text = open(p).read()
        ctxs.append(ModuleCtx(p, text, ast.parse(text)))
    for c in ctxs:
        lockset._collect_fns(c, graph)
    for c in ctxs:
        lockset._collect_instance_types(c, graph)
    for c in ctxs:
        lockset._scan_module(c, graph)
    return graph


def test_scope_is_jax_scope_under_the_port():
    assert lockset.SCOPE == jlockset.SCOPE
    paths = lockset.default_scope(REPO)
    assert [os.path.relpath(p, REPO) for p in paths] == [
        os.path.join("fpga_ai_nic_tpu_torch", s) for s in lockset.SCOPE]


def test_tree_is_silent():
    fs = [f for f in lockset.run_lockset(repo_root=REPO) if not f.suppressed]
    assert fs == [], [f.format() for f in fs]
    # the default root is this checkout
    assert lockset.run_lockset() == lockset.run_lockset(repo_root=REPO)


def test_fires_on_seeded_unlocked_write():
    path = os.path.join(FIXTURES, "h1_bad.py")
    fs = lockset.run_lockset([path])
    assert fs, "H1 must flag the unlocked cross-thread counter"
    assert any("Worker.processed" in f.message for f in fs)
    assert all(f.code == "H1" for f in fs)
    assert not any("last_note" in f.message for f in fs)
    assert [(f.code, f.path, f.line, f.message) for f in fs] == [
        (f.code, f.path, f.line, f.message)
        for f in jlockset.run_lockset([path])]


def test_silent_when_both_writes_share_the_lock():
    fs = lockset.run_lockset([os.path.join(FIXTURES, "h1_good.py")])
    assert fs == [], [f.format() for f in fs]


def test_sees_the_real_worker_roots():
    graph = _graph(lockset.default_scope(REPO))
    names = {k[2] for k in graph.worker_roots}
    assert "ElasticTrainer._attempt" in names
    assert "Watchdog.target@run" in names
    worker = lockset._reach(graph, graph.worker_roots)
    shared = {(w.cls, w.attr) for w in graph.writes if w.fn in worker}
    assert ("CollectiveStats", "issued") in shared
    # the queue's issue path runs on the workers too: the side streams'
    # dict is written there, under the queue's lock
    sites = [w for w in graph.writes
             if (w.cls, w.attr) == ("CollectiveQueue", "_streams")]
    assert sites and all(w.fn in worker for w in sites)
    assert all("_lock" in w.locks for w in sites)


def _messages(findings):
    """A finding's class.attr and its message, without paths and lines."""
    return sorted((f.code, f.message.split(" is written")[0],
                   f.message.split("DISJOINT lock sets")[1])
                  for f in findings)


def test_extra_modules_give_jax_findings():
    ours = lockset.run_lockset(
        lockset.default_scope(REPO)
        + [os.path.join(REPO, "fpga_ai_nic_tpu_torch", e) for e in EXTRA])
    theirs = jlockset.run_lockset(
        jlockset.default_scope(REPO)
        + [os.path.join(REPO, "fpga_ai_nic_tpu", e) for e in EXTRA])
    assert _messages(ours) == _messages(theirs)
    assert [m[1] for m in _messages(ours)] == ["'Checkpointer._bg_exc'"]
    for f in ours:
        assert not any(a in f.message for a in (
            "decode_calls", "prefill_calls", "prefill_tokens", "last_save"))


def test_engine_counters_move_out_of_the_tick_closure():
    """The step counters are written where the tick's result is taken,
    never inside the closure the watchdog worker runs."""
    graph = _graph(lockset.default_scope(REPO) + [
        os.path.join(REPO, "fpga_ai_nic_tpu_torch", "serve", "engine.py")])
    worker = lockset._reach(graph, graph.worker_roots)
    assert any(k[2] == "ServeEngine.work@_device_tick" for k in worker)
    for attr in ("decode_calls", "prefill_calls", "prefill_tokens"):
        sites = [w for w in graph.writes
                 if (w.cls, w.attr) == ("ServeEngine", attr)]
        assert sites, attr
        assert all(w.fn not in worker for w in sites), attr
        assert {w.fn[2] for w in sites} == {"ServeEngine._tick"}, attr


def test_missing_scope_entry_raises(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(REPO, "fpga_ai_nic_tpu_torch"),
                    root / "fpga_ai_nic_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "csrc",
                                                  "__pycache__"))
    os.remove(root / "fpga_ai_nic_tpu_torch" / "runtime" / "staging.py")
    with pytest.raises(FileNotFoundError, match="staging.py"):
        lockset.default_scope(str(root))


def test_suppression_marks_a_finding(tmp_path):
    text = open(os.path.join(FIXTURES, "h1_bad.py")).read()
    text = text.replace(
        "            self.processed += 1           # worker write, no lock",
        "            # graftlint: disable=H1 -- a test of the suppression\n"
        "            self.processed += 1")
    path = tmp_path / "h1_suppressed.py"
    path.write_text(text)
    fs = lockset.run_lockset([str(path)])
    assert fs and all(f.suppressed for f in fs)
    assert fs[0].suppress_reason == "a test of the suppression"
