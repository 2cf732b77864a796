"""H1 — the happens-before/lockset pass, the port of the JAX package's
``verify/lockset.py``: R1 generalized from "stats counters mutate under
lock" to cross-thread ORDER.

R1 froze one instance of the dropped-update race class: the named counter fields
of CollectiveStats/RecoveryStats.  But the same machine runs three-plus
real threads — the trainer loop, the elastic watchdog worker (every
`watchdog.run(fn)` executes ``fn`` on a daemon thread) and any
`threading.Thread` target (the checkpointer's background save) — and
ANY instance attribute written from two of them without a
common lock is the same dropped-update bug wearing a different field
name.

The pass (heuristic, like every graftlint rule — docs/LINT.md):

  1. thread roots: callables registered as ``Thread(target=...)``,
     ``<watchdog>.run(fn, ...)``, ``<executor>.submit(fn, ...)`` and
     host-callback bodies (``pure_callback(fn, ...)`` et al.; the
     port has none, its workers are threads), plus defs nested inside
     them;
  2. a name-based call graph over the scoped modules (self.m -> the
     enclosing class's method, bare f -> module function, obj.m -> any
     scoped class defining m), giving each function its ROLE SET:
     "worker" if reachable from a thread root, "main" if reachable
     from a public entry point;
  3. acquired-lock sets: the ``with *lock:`` contexts enclosing a
     statement, plus the INTERSECTION of lock sets over all call paths
     into the enclosing function (a lock held on only one path does
     not order the other);
  4. every ``self.<attr>`` write (assign / augassign / mutating method
     call) outside construction is a write site; a (class, attr) with
     a worker-role write and a main-role write whose lock sets are
     DISJOINT is an H1 finding — the two threads' writes are unordered.

Reads are out of scope (single-writer publish patterns are legal and
common); construction (`__init__`/`__post_init__`) happens-before
thread start and is exempt.  Findings are suppressible with
``# graftlint: disable=H1 -- reason`` like any AST rule.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from ..lint.engine import ModuleCtx
from ..lint.findings import Finding
from ..lint.suppress import scan as scan_suppressions

# the cross-thread surface: every module where a second thread executes
# (watchdog workers, the queue the worker drives) — plus the stats/event
# sinks they all write into; the JAX package's eight modules, resolved
# under this package
SCOPE = (
    "runtime/queue.py", "runtime/watchdog.py", "runtime/chaos.py",
    "runtime/staging.py", "parallel/elastic.py",
    "utils/observability.py", "obs/events.py", "obs/metrics.py",
)

_THREAD_CTORS = {"Thread"}
_SUBMIT_METHODS = {"submit"}
_CALLBACK_FUNCS = {"pure_callback", "io_callback"}
_CONSTRUCTORS = {"__init__", "__post_init__", "__new__", "_lock_field"}
_MUTATING_METHODS = {"append", "extend", "insert", "pop", "clear",
                     "update", "setdefault", "remove", "add", "discard"}

FnKey = Tuple[str, str, str]          # (path, class name or "", qualname)


@dataclass
class _Fn:
    key: FnKey
    node: ast.AST
    ctx: ModuleCtx
    cls: str                          # "" for module-level
    name: str
    nested_in: Optional[FnKey] = None


@dataclass
class _WriteSite:
    fn: FnKey
    cls: str
    attr: str
    line: int
    path: str
    locks: FrozenSet[str]             # with-locks at the statement


@dataclass
class _Graph:
    fns: Dict[FnKey, _Fn] = field(default_factory=dict)
    by_method: Dict[str, List[FnKey]] = field(default_factory=dict)
    by_class_method: Dict[Tuple[str, str], List[FnKey]] = \
        field(default_factory=dict)
    by_module_fn: Dict[Tuple[str, str], List[FnKey]] = \
        field(default_factory=dict)
    calls: Dict[FnKey, List[Tuple[FnKey, FrozenSet[str]]]] = \
        field(default_factory=dict)   # callee -> [(caller, site locks)]
    worker_roots: Set[FnKey] = field(default_factory=set)
    writes: List[_WriteSite] = field(default_factory=list)
    # (class, attr) -> class names assigned via `self.attr = Cls(...)`;
    # lets `self.queue.wait` resolve to CollectiveQueue.wait instead of
    # every scoped class with a `wait` method
    instance_types: Dict[Tuple[str, str], Set[str]] = \
        field(default_factory=dict)
    class_names: Set[str] = field(default_factory=set)
    by_node: Dict[int, FnKey] = field(default_factory=dict)  # id(def node)


# with-context names that count as acquired locks: Lock/RLock handles
# and Condition variables (a Condition acquires its underlying lock)
_LOCKISH_SUFFIXES = ("lock", "cv", "cond", "condition")


def _lock_names(ctx: ModuleCtx, node: ast.AST) -> FrozenSet[str]:
    """Locks held at ``node``: enclosing ``with X:`` items whose dotted
    name ends in a lock-ish suffix (self._lock, stats._lock, self._cv,
    ...), normalized without the leading 'self.'."""
    out: Set[str] = set()
    for anc in ctx.ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                d = ctx.dotted(item.context_expr)
                if d.lower().endswith(_LOCKISH_SUFFIXES):
                    out.add(d[5:] if d.startswith("self.") else d)
    return frozenset(out)


def _enclosing_class_name(ctx: ModuleCtx, node: ast.AST) -> str:
    for anc in ctx.ancestors(node):
        if isinstance(anc, ast.ClassDef):
            return anc.name
    return ""


def _collect_fns(ctx: ModuleCtx, graph: _Graph) -> None:
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            graph.class_names.add(node.name)
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        cls = _enclosing_class_name(ctx, node)
        outer = None
        for anc in ctx.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                outer = anc
                break
        qual = (f"{cls}." if cls else "") + node.name \
            + (f"@{outer.name}" if outer is not None else "")
        key: FnKey = (ctx.path, cls, qual)
        fn = _Fn(key=key, node=node, ctx=ctx, cls=cls, name=node.name)
        if outer is not None:
            ocls = _enclosing_class_name(ctx, outer)
            fn.nested_in = (ctx.path, ocls,
                            (f"{ocls}." if ocls else "") + outer.name)
        graph.fns[key] = fn
        graph.by_node[id(node)] = key
        graph.by_method.setdefault(node.name, []).append(key)
        if cls:
            graph.by_class_method.setdefault((cls, node.name),
                                             []).append(key)
        else:
            graph.by_module_fn.setdefault((ctx.path, node.name),
                                          []).append(key)


def _resolve_callable(ctx: ModuleCtx, graph: _Graph, expr: ast.AST,
                      at: ast.AST) -> List[FnKey]:
    """Function keys an expression may denote: self.m, bare f, obj.m
    (any scoped class with a method m), seen through
    functools.partial."""
    while isinstance(expr, ast.Call) \
            and ctx.dotted(expr.func).split(".")[-1] == "partial" \
            and expr.args:
        expr = expr.args[0]
    d = ctx.dotted(expr)
    if not d:
        return []
    parts = d.split(".")
    name = parts[-1]
    if parts[0] == "self" and len(parts) == 2:
        cls = _enclosing_class_name(ctx, at)
        return list(graph.by_class_method.get((cls, name), ())) \
            or list(graph.by_method.get(name, ()))
    if parts[0] == "self" and len(parts) == 3:
        # self.<attr>.<meth>: prefer the inferred instance type(s)
        cls = _enclosing_class_name(ctx, at)
        owners = graph.instance_types.get((cls, parts[1]))
        if owners:
            out: List[FnKey] = []
            for o in owners:
                out.extend(graph.by_class_method.get((o, name), ()))
            return out
        return list(graph.by_method.get(name, ()))
    if len(parts) == 1:
        local = graph.by_module_fn.get((ctx.path, name))
        if local:
            return list(local)
        return [k for k in graph.by_method.get(name, ())
                if graph.fns[k].nested_in is not None
                or not graph.fns[k].cls]
    if parts[0] in ctx.mod_aliases:      # module attr: out of scope
        return []
    return list(graph.by_method.get(name, ()))


def _collect_instance_types(ctx: ModuleCtx, graph: _Graph) -> None:
    """`self.attr = Cls(...)` / `Cls.sized(...)` assignments -> the
    attr's plausible classes (union over sites, any method)."""
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.value, ast.Call)):
            continue
        t = node.targets[0]
        if not (isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"):
            continue
        d = ctx.dotted(node.value.func)
        head = d.split(".")[0] if d else ""
        if head in graph.class_names:
            cls = _enclosing_class_name(ctx, node)
            graph.instance_types.setdefault((cls, t.attr),
                                            set()).add(head)


def _scan_module(ctx: ModuleCtx, graph: _Graph) -> None:
    # call graph + worker-root registrations + write sites, one walk
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn_node = ctx.enclosing_function(node)
        caller: Optional[FnKey] = None
        if fn_node is not None and not isinstance(fn_node, ast.Lambda):
            caller = graph.by_node.get(id(fn_node))
        d = ctx.dotted(node.func)
        last = d.split(".")[-1] if d else ""
        # worker-root registrations (the callable travels as DATA, not
        # as a call — it executes on another thread)
        target: Optional[ast.AST] = None
        if last in _THREAD_CTORS:
            for kw in node.keywords:
                if kw.arg == "target":
                    target = kw.value
        elif last == "run" and "watchdog" in d.lower() and node.args:
            target = node.args[0]
        elif last in _SUBMIT_METHODS and node.args:
            target = node.args[0]
        elif (last in _CALLBACK_FUNCS or d.endswith("debug.callback")) \
                and node.args:
            target = node.args[0]
        if target is not None:
            graph.worker_roots.update(
                _resolve_callable(ctx, graph, target, node))
            continue
        # ordinary call edge
        if caller is None:
            continue
        locks = _lock_names(ctx, node)
        for callee in _resolve_callable(ctx, graph, node.func, node):
            graph.calls.setdefault(callee, []).append((caller, locks))

    # write sites
    for key, fn in graph.fns.items():
        if fn.ctx is not ctx or fn.name in _CONSTRUCTORS:
            continue
        for node in ast.walk(fn.node):
            inner = ctx.enclosing_function(node)
            if inner is not fn.node:
                continue               # nested defs are their own entry
            targets: List[ast.AST] = []
            if isinstance(node, ast.AugAssign):
                targets = [node.target]
            elif isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) \
                        and f.attr in _MUTATING_METHODS:
                    targets = [f.value]
            for t in targets:
                if isinstance(t, ast.Subscript):
                    t = t.value
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                if t.attr.endswith("lock"):
                    continue
                graph.writes.append(_WriteSite(
                    fn=key, cls=fn.cls, attr=t.attr, line=node.lineno,
                    path=ctx.path, locks=_lock_names(ctx, node)))


def _reach(graph: _Graph, roots: Set[FnKey]) -> Set[FnKey]:
    """Forward closure over the call graph (callee -> callers is what we
    store, so build the forward map once), including defs nested inside
    reached functions (closures run on the reaching thread)."""
    fwd: Dict[FnKey, Set[FnKey]] = {}
    for callee, sites in graph.calls.items():
        for caller, _locks in sites:
            fwd.setdefault(caller, set()).add(callee)
    nested: Dict[FnKey, Set[FnKey]] = {}
    for key, fn in graph.fns.items():
        if fn.nested_in is not None:
            nested.setdefault(fn.nested_in, set()).add(key)
    seen: Set[FnKey] = set()
    frontier = set(roots)
    while frontier:
        k = frontier.pop()
        if k in seen:
            continue
        seen.add(k)
        frontier |= fwd.get(k, set()) - seen
        frontier |= nested.get(k, set()) - seen
    return seen


def _entry_locks(graph: _Graph, roots: Set[FnKey]
                 ) -> Dict[FnKey, FrozenSet[str]]:
    """Fixpoint: locks GUARANTEED held on entry — the intersection over
    all call paths (roots enter lock-free)."""
    top = frozenset({"<top>"})        # lattice top: unvisited
    entry: Dict[FnKey, FrozenSet[str]] = {
        k: (frozenset() if k in roots else top) for k in graph.fns}
    changed = True
    while changed:
        changed = False
        for callee, sites in graph.calls.items():
            acc: Optional[FrozenSet[str]] = None
            for caller, locks in sites:
                cal = entry.get(caller, top)
                if cal == top:
                    continue
                held = frozenset(cal | locks)
                acc = held if acc is None else frozenset(acc & held)
            if callee in roots:
                acc = frozenset() if acc is None else frozenset()
            if acc is None:
                continue
            if entry.get(callee, top) == top or entry[callee] != acc:
                if entry.get(callee) != acc:
                    entry[callee] = acc
                    changed = True
    return {k: (frozenset() if v == top else v)
            for k, v in entry.items()}


def default_scope(repo_root: str) -> List[str]:
    """The scoped module paths — a missing entry is an ERROR, never a
    silent shrink of the race-checked surface (a rename must update
    SCOPE, not quietly drop the module from the pass)."""
    base = os.path.join(repo_root, "fpga_ai_nic_tpu_torch")
    paths = [os.path.join(base, p) for p in SCOPE]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            "H1 lockset scope entries missing (renamed/deleted module? "
            f"update verify.lockset.SCOPE): {missing}")
    return paths


def run_lockset(paths: Optional[Sequence[str]] = None,
                repo_root: Optional[str] = None) -> List[Finding]:
    """Run the H1 pass over ``paths`` (default: the cross-thread scope
    of this repo).  Returns findings, suppressed ones marked."""
    if paths is None:
        root = repo_root or os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        paths = default_scope(root)
    graph = _Graph()
    ctxs: List[ModuleCtx] = []
    sups = {}
    for p in paths:
        with open(p, "r", encoding="utf-8") as fh:
            text = fh.read()
        tree = ast.parse(text, filename=p)
        ctx = ModuleCtx(p, text, tree)
        ctxs.append(ctx)
        sups[p] = scan_suppressions(p, text)
    for ctx in ctxs:
        _collect_fns(ctx, graph)
    for ctx in ctxs:
        _collect_instance_types(ctx, graph)
    for ctx in ctxs:
        _scan_module(ctx, graph)

    worker = _reach(graph, graph.worker_roots)
    main_roots = {k for k, fn in graph.fns.items()
                  if k not in graph.worker_roots
                  and fn.nested_in is None
                  and not fn.name.startswith("_")}
    main = _reach(graph, main_roots)
    entry = _entry_locks(graph, graph.worker_roots | main_roots)

    by_attr: Dict[Tuple[str, str], List[_WriteSite]] = {}
    for w in graph.writes:
        if w.fn in worker or w.fn in main:
            by_attr.setdefault((w.cls, w.attr), []).append(w)

    findings: List[Finding] = []
    for (cls, attr), sites in sorted(by_attr.items()):
        w_sites = [s for s in sites if s.fn in worker]
        m_sites = [s for s in sites if s.fn in main]
        if not w_sites or not m_sites:
            continue                   # single-threaded attribute
        reported: Set[Tuple[str, int]] = set()
        for ws in w_sites:
            wl = ws.locks | entry.get(ws.fn, frozenset())
            for ms in m_sites:
                ml = ms.locks | entry.get(ms.fn, frozenset())
                if wl & ml:
                    continue           # a common lock orders them
                loc = (ws.path, ws.line)
                if loc in reported:
                    continue
                reported.add(loc)
                other = ("the same statement" if (ms.path, ms.line) == loc
                         else f"{os.path.basename(ms.path)}:{ms.line}")
                findings.append(Finding(
                    "H1", ws.path, ws.line,
                    f"'{(cls + '.') if cls else ''}{attr}' is written on "
                    f"a worker thread here and from the main-thread path "
                    f"at {other} with DISJOINT lock sets "
                    f"({sorted(wl) or 'none'} vs {sorted(ml) or 'none'})"
                    " — unordered cross-thread writes drop updates; "
                    "route both through one locked method (the R1 "
                    "record_* pattern)"))
    out: List[Finding] = []
    for f in findings:
        sup = sups.get(f.path)
        if sup is not None:
            hit, reason = sup.lookup("H1", f.line)
            if hit:
                f = Finding(f.code, f.path, f.line, f.message,
                            suppressed=True, suppress_reason=reason)
        out.append(f)
    return sorted(out, key=lambda f: (f.path, f.line))
