"""Counterexample replay, the port of the JAX package's
``verify/replay.py``: a violating interleaving as a per-node op trace
and as a Perfetto-loadable timeline.

The model checker attaches the exact action sequence that reached a
violation (`mc.Violation.trace`).  Two renderings:

  format_trace   the per-node op trace as text — every node's column of
                 executed ops with the global scheduler step of each,
                 followed by the interleaved tail around the violation.
  perfetto_trace the same interleaving through `obs.timeline`'s
                 Chrome-trace exporter: node programs as host-thread
                 lanes (one span per op), wire transfers as ticket
                 spans on the collective-queue lane (send step ->
                 landing step, so an in-flight frame is a visible bar),
                 and the violation as a flow-terminating instant.  Load
                 the JSON in https://ui.perfetto.dev — a deadlock's
                 wait-for cycle shows as every node lane ending in a
                 blocked wait with no ticket span able to retire.

Scheduler steps have no wall-clock meaning; the export places step k at
k microseconds so Perfetto's timeline is simply the interleaving order.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

from ..obs import events as events_lib
from ..obs import timeline as timeline_lib
from .mc import Violation

_STEP_NS = 1_000          # one scheduler step = 1 us on the timeline
_OP_DUR_NS = 800


def _op_text(entry: Tuple[Any, ...]) -> str:
    if entry[0] == "wire":
        if len(entry) == 5:               # ring: (wire, src, q, dst, slot)
            _, src, q, dst, slot = entry
            return f"emission {q} lands {src}->{dst} slot {slot}"
        _, src, dst, tag = entry          # pair: (wire, src, dst, tag)
        return f"payload {tag!r} lands {src}->{dst}"
    _, i, op = entry
    return " ".join(str(x) for x in op)


def format_trace(violation: Violation, tail: int = 24) -> str:
    """The violating interleaving as text: one column per node (each op
    with its global scheduler step), then the interleaved last ``tail``
    steps, then the violation."""
    trace = violation.trace
    per_node: Dict[int, List[str]] = {}
    for step, entry in enumerate(trace):
        if entry[0] == "node":
            per_node.setdefault(entry[1], []).append(
                f"[{step}] {_op_text(entry)}")
    ctx = " ".join(f"{k}={v}" for k, v in violation.meta.items())
    lines = [f"counterexample ({ctx}):",
             f"  {violation.kind}: {violation.message}", "",
             "per-node op trace:"]
    for i in sorted(per_node):
        lines.append(f"  node {i}:")
        for s in per_node[i]:
            lines.append(f"    {s}")
    lines.append("")
    lines.append(f"interleaved tail (last {min(tail, len(trace))} of "
                 f"{len(trace)} steps):")
    for step in range(max(0, len(trace) - tail), len(trace)):
        entry = trace[step]
        actor = (f"node {entry[1]}" if entry[0] == "node" else "wire  ")
        lines.append(f"  [{step:4d}] {actor}  {_op_text(entry)}")
    lines.append(f"  [{len(trace):4d}] VIOLATION  {violation.message}")
    return "\n".join(lines)


def _host_events(violation: Violation) -> List[Dict[str, Any]]:
    """The interleaving as obs.events-shaped host events for
    `obs.timeline.chrome_trace`."""
    trace = violation.trace
    out: List[Dict[str, Any]] = []
    # wire transfers: send step -> landing step as queue-lane tickets.
    # uids are STABLE enumeration indices, never str hashes — the
    # export must be byte-identical run to run (PYTHONHASHSEED) and
    # collision-free across timeline.py's uid % 64 lane assignment
    send_step: Dict[Any, int] = {}
    uid_of: Dict[Any, int] = {}

    def uid_for(key: Any) -> int:
        return uid_of.setdefault(key, len(uid_of))

    for step, entry in enumerate(trace):
        t_ns = step * _STEP_NS
        if entry[0] == "node":
            _, i, op = entry
            if op[0] in ("send", "send_to"):
                send_step[(i,) + tuple(op[1:])] = step
            out.append({"kind": events_lib.SPAN, "name": _op_text(entry),
                        "t_unix_ns": t_ns, "dur_ns": _OP_DUR_NS,
                        "tid": i, "attrs": {"node": i, "op": op[0]}})
            continue
        # landing: close the ticket opened by the matching send
        if len(entry) == 5:
            _, src, q, dst, slot = entry
            key: Any = (src, q)
            name = f"wire {src}->{dst} emission {q}"
        else:
            _, src, dst, tag = entry
            key = (src, dst, tag)
            name = f"wire {src}->{dst} {tag!r}"
        start = send_step.pop(key, step)
        out.append({"kind": events_lib.SPAN, "name": name,
                    "t_unix_ns": start * _STEP_NS,
                    "dur_ns": max(_OP_DUR_NS, (step - start) * _STEP_NS),
                    "tid": 0,
                    "attrs": {"lane": "queue", "uid": uid_for(key),
                              "src": src}})
    # transfers still in flight at the violation: open-ended tickets
    for key, start in sorted(send_step.items(), key=lambda kv: kv[1]):
        out.append({"kind": events_lib.SPAN,
                    "name": f"wire IN FLIGHT {key}",
                    "t_unix_ns": start * _STEP_NS,
                    "dur_ns": (len(trace) - start) * _STEP_NS,
                    "tid": 0,
                    "attrs": {"lane": "queue", "uid": uid_for(key),
                              "in_flight": True}})
    out.append({"kind": events_lib.INSTANT,
                "name": f"VIOLATION: {violation.kind}",
                "t_unix_ns": len(trace) * _STEP_NS, "tid": 0,
                "attrs": {"message": violation.message,
                          **violation.meta}})
    return out


def perfetto_trace(violation: Violation) -> Dict[str, Any]:
    """The violating interleaving as a Chrome-trace JSON object (the
    same exporter the telemetry plane uses — obs.timeline)."""
    header = {"source": "graftmc", "violation": violation.kind,
              **{str(k): v for k, v in violation.meta.items()}}
    return timeline_lib.chrome_trace(_host_events(violation),
                                     header=header)


def export_counterexample(model: Any, violation: Violation,
                          out_dir: str) -> Tuple[str, str]:
    """Write both renderings next to each other; returns (txt, json)
    paths.  Called by the corpus on any violation so a red
    run of the checker leaves an inspectable artifact."""
    os.makedirs(out_dir, exist_ok=True)
    route = str(violation.meta.get("route", getattr(model, "route", "mc")))
    cell = "_".join(str(violation.meta[k]) for k in sorted(violation.meta)
                    if k != "route")
    base = os.path.join(out_dir, f"mc_counterexample_{route}"
                        + (f"_{cell}" if cell else ""))
    txt = base + ".txt"
    with open(txt, "w") as fh:
        fh.write(format_trace(violation) + "\n")
    js = base + ".json"
    timeline_lib.write(js, perfetto_trace(violation))
    return txt, js
