"""``python -m fpga_ai_nic_tpu_torch.verify``: the exhaustive protocol
corpus and the H1 lockset pass, the port's counterpart of the JAX
package's ``tools/graftlint.py --mc``.

Prints a ``route <name>:`` line for each route, every finding, the POR
reduction line of each comparison cell and the ``<n> cells exhaustive``
summary; the last line is the envelope record as one JSON object.  Exits
1 on any violation or live (unsuppressed) finding, else 0.

  --fixture PATH       also load PATH and check the model its ``build()``
                       returns: a mutated protocol that MUST violate (a
                       clean one is itself a finding)
  --skip-corpus        skip the corpus; honoured only with --fixture
  --out PATH           write the envelope record to PATH as JSON
  --counterexamples DIR  write each violation's text and Perfetto replay
                       into DIR
  --wall-budget S      fail when the corpus takes longer (default 120 s:
                       a state-space regression, not a slow machine)

Nothing is written unless --out or --counterexamples names a place.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from . import mc
from .lockset import run_lockset
from ..lint.findings import Finding

WALL_BUDGET_S = 120.0


def run(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fpga_ai_nic_tpu_torch.verify",
        description="protocol model check + H1 lockset pass")
    ap.add_argument("--fixture", default=None)
    ap.add_argument("--skip-corpus", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--counterexamples", default=None)
    ap.add_argument("--wall-budget", type=float, default=WALL_BUDGET_S)
    args = ap.parse_args(argv)
    cdir = args.counterexamples
    # a bare run never skips the corpus: that would be a vacuous gate
    skip_corpus = args.skip_corpus and args.fixture is not None
    if skip_corpus:
        print("[graftmc] corpus SKIPPED (fixture-only run)")
        findings: List[Finding] = []
        stats = mc.CorpusStats()
    else:
        findings, stats = mc.run_corpus(emit=print, counterexample_dir=cdir)
    if args.fixture:
        findings += mc.run_fixture(args.fixture, counterexample_dir=cdir)
    if stats.wall_s > args.wall_budget:
        findings.append(Finding(
            "M1", "<mc:budget>", 0,
            f"corpus wall time {stats.wall_s:.1f}s exceeds the "
            f"{args.wall_budget:.0f}s explosion budget — a state-space "
            "regression, not a slow machine"))
    h1 = run_lockset()
    findings += h1
    for f in findings:
        print(f.format())
    live = [f for f in findings if not f.suppressed]
    for cmp in stats.compare:
        print(f"[graftmc] POR reduction on flat{cmp['cell']}: "
              f"{cmp['reduction']:.1f}x ({cmp['por_states']} vs "
              f"{cmp['naive_states']} states), verdicts "
              f"{'agree' if cmp['agree'] else 'DISAGREE'}")
    record = mc.envelope_record(stats)
    record["wall_budget_s"] = args.wall_budget
    record["lockset_findings"] = len(h1)
    record["ok"] = not live
    print(f"[graftmc] {stats.cells} cells exhaustive "
          f"({stats.states} states, {stats.branch_points} branch "
          f"points), {stats.fuzz_runs} fuzz runs, "
          f"{len(h1)} lockset findings, {len(live)} findings total")
    if args.out and not skip_corpus:
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=1)
            fh.write("\n")
    print(json.dumps(record), flush=True)
    return 1 if live else 0


if __name__ == "__main__":
    sys.exit(run())
