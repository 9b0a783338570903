"""Whole-package lock-order & blocking-under-lock lint (GC-L304/305).

The per-class rules in :mod:`~sparkflow_tpu.analysis.locks` see one file at
a time; a lock-order inversion between ``membership.py`` and ``router.py``
is invisible to them. This pass parses EVERY file handed to it into one
model and reasons about the package as a whole:

- a **lock node** is one lock *identity*: ``module.Class._attr`` for an
  instance lock created in ``__init__`` (all instances of the class share
  the node, the standard conflation in lock-order analysis), or
  ``module:NAME`` for a module-level lock. ``threading.Condition(self._lock)``
  aliases to the wrapped lock's node.
- an **edge** L -> M means "some code path acquires M while holding L":
  either a nested ``with`` in one function, or a call made under L to a
  function that (transitively, through an approximate intra-package call
  graph) acquires M. Calls are resolved best-effort: ``self.m()``,
  ``self.attr.m()`` / ``local.m()`` where the attribute/local was assigned
  ``ClassName(...)`` of a known class, and bare ``f()`` to a same-module
  function. ``*_locked`` helpers scan with their class's locks assumed held
  (the GC-L303 convention), so edges through them land on their callers.

**GC-L304** reports every strongly-connected component of that graph — two
locks ever taken in opposite orders are a deadlock waiting for the right
interleaving — and re-acquisition of a non-reentrant lock through a call
chain (a self-cycle: the thread deadlocks against itself).

**GC-L305** reports blocking operations executed while any lock is held:
``time.sleep`` (and injectable ``*_sleep`` hooks), socket/HTTP I/O
(``getresponse``/``recv``/``connect``/``accept``/``sendall``/``urlopen``),
``Future.result()``, thread ``join()``, ``Event.wait()``,
``block_until_ready()``, and ``subprocess`` waits — directly or through a
resolved call chain. Holding a lock across a wait turns every peer thread's
bounded critical section into an unbounded one; under load that reads as a
stalled fleet. ``Condition.wait()`` on the class's own condition is exempt
(it *releases* the lock while waiting — that's the point of a condition).

Intentional sites (a chaos hook that sleeps under the store lock on
purpose) are allowlisted inline: ``# graftcheck: disable=GC-L305`` on the
flagged line, the same suppression syntax every AST analyzer honors.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .ast_lint import iter_py_files, _attr_chain
from .findings import Finding, parse_suppressions
from .locks import _LOCK_CTORS, _is_lock_ctor, _self_attr

__all__ = ["lint_paths", "build_graph", "LockGraph"]

#: attribute-call names that block the calling thread (see module docstring)
_BLOCKING_ATTRS = {"result", "getresponse", "recv", "recv_into", "accept",
                   "connect", "sendall", "communicate", "block_until_ready"}
_SUBPROCESS_FNS = {"run", "call", "check_call", "check_output"}
#: threading ctors that are waitable but NOT locks (Event.wait blocks while
#: Condition.wait releases) — tracked so `.wait()` receivers resolve
_EVENT_CTORS = {"Event", "Barrier"}


# ---------------------------------------------------------------------------
# package model
# ---------------------------------------------------------------------------


@dataclass
class _ClassInfo:
    name: str
    module: str
    path: str
    node: ast.ClassDef
    lock_attrs: Dict[str, str] = field(default_factory=dict)  # attr -> ctor
    alias: Dict[str, str] = field(default_factory=dict)       # cond -> lock
    event_attrs: Set[str] = field(default_factory=set)
    #: attr -> candidate class names (every ctor mentioned in the assigned
    #: expression — `m if m else Metrics()` yields ["Metrics"]); resolution
    #: picks the first candidate that is a known class with the method
    attr_types: Dict[str, List[str]] = field(default_factory=dict)
    methods: Dict[str, ast.AST] = field(default_factory=dict)

    def lock_node(self, attr: str) -> str:
        attr = self.alias.get(attr, attr)
        return f"{self.module}.{self.name}.{attr}"


@dataclass
class _Summary:
    """Per-function facts feeding the fixpoint."""
    acquires: List[Tuple[str, str, int]] = field(default_factory=list)
    calls: List[Tuple[object, str, int, Tuple[str, ...]]] = \
        field(default_factory=list)
    blocks: List[Tuple[str, str, int, Tuple[str, ...]]] = \
        field(default_factory=list)
    edges: List[Tuple[str, str, str, int, str]] = field(default_factory=list)


class LockGraph:
    """The assembled model: lock nodes, ordering edges (with sites), and the
    raw per-function summaries — exposed so tests and docs can introspect
    what the lint saw."""

    def __init__(self):
        self.classes: Dict[str, Optional[_ClassInfo]] = {}  # bare name
        self.mod_funcs: Dict[Tuple[str, str], ast.AST] = {}
        self.mod_func_paths: Dict[Tuple[str, str], str] = {}
        self.mod_locks: Dict[Tuple[str, str], str] = {}     # -> ctor
        self.node_ctor: Dict[str, str] = {}                 # node -> ctor
        self.summaries: Dict[object, _Summary] = {}
        self.may_acquire: Dict[object, Set[str]] = {}
        self.may_block: Dict[object, Tuple[str, str]] = {}  # key -> (desc, via)
        # L -> M -> [(path, line, note)]
        self.edges: Dict[str, Dict[str, List[Tuple[str, int, str]]]] = {}

    def add_edge(self, src: str, dst: str, path: str, line: int,
                 note: str = "") -> None:
        self.edges.setdefault(src, {}).setdefault(dst, []).append(
            (path, line, note))


def _module_name(path: str) -> str:
    """Dotted module name from a file path (best effort: the trailing
    components from the last directory that lacks an __init__.py up)."""
    parts = os.path.normpath(path).split(os.sep)
    if parts[-1] == "__init__.py":
        parts = parts[:-1]
    else:
        parts[-1] = parts[-1][:-3] if parts[-1].endswith(".py") else parts[-1]
    # walk up while the directory is a package
    keep = [parts[-1]]
    d = os.path.dirname(os.path.normpath(path))
    while d and os.path.isfile(os.path.join(d, "__init__.py")):
        keep.append(os.path.basename(d))
        d = os.path.dirname(d)
    return ".".join(reversed(keep))


def _ctor_name(value: ast.AST) -> Optional[str]:
    if not isinstance(value, ast.Call):
        return None
    fn = value.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


_TYPING_NOISE = {"Optional", "Union", "List", "Dict", "Set", "Tuple",
                 "Sequence", "Iterable", "Callable", "Any", "None", "str",
                 "int", "float", "bool", "bytes", "object", "type"}


def _ann_tokens(ann: ast.AST) -> List[str]:
    """Class-name candidates mentioned in a type annotation — handles
    ``Foo``, ``mod.Foo``, ``Optional[Foo]`` and string annotations
    (``engine: "DecodeEngine"``)."""
    import re
    toks: List[str] = []
    for n in ast.walk(ann):
        if isinstance(n, ast.Name):
            toks.append(n.id)
        elif isinstance(n, ast.Attribute):
            toks.append(n.attr)
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            toks.extend(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", n.value))
    return [t for t in toks if t not in _TYPING_NOISE]


def _index_class(cls: ast.ClassDef, module: str, path: str) -> _ClassInfo:
    info = _ClassInfo(cls.name, module, path, cls)
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        ctor = _ctor_name(node.value)
        for t in node.targets:
            attr = _self_attr(t)
            if attr is None:
                continue
            if _is_lock_ctor(node.value):
                info.lock_attrs[attr] = ctor or "Lock"
                # Condition(self._lock) shares the wrapped lock's identity
                if (ctor == "Condition" and node.value.args
                        and _self_attr(node.value.args[0]) is not None):
                    info.alias[attr] = _self_attr(node.value.args[0])
            elif ctor in _EVENT_CTORS:
                info.event_attrs.add(attr)
            else:
                cands = [c for c in (
                    _ctor_name(call) for call in ast.walk(node.value)
                    if isinstance(call, ast.Call)) if c is not None]
                if cands:
                    info.attr_types[attr] = cands
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info.methods[stmt.name] = stmt
            # annotated params stored onto self: `def __init__(self,
            # engine: "DecodeEngine")` + `self.engine = engine` types the
            # attribute (string annotations need no import, so they work
            # even where a real import would be circular)
            ann: Dict[str, List[str]] = {}
            a = stmt.args
            for arg in (*a.posonlyargs, *a.args, *a.kwonlyargs):
                if arg.annotation is not None:
                    toks = _ann_tokens(arg.annotation)
                    if toks:
                        ann[arg.arg] = toks
            if not ann:
                continue
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Assign):
                    continue
                if not (isinstance(node.value, ast.Name)
                        and node.value.id in ann):
                    continue
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        info.attr_types.setdefault(attr, []).extend(
                            ann[node.value.id])
    return info


# ---------------------------------------------------------------------------
# per-function scan
# ---------------------------------------------------------------------------


def _blocking_desc(call: ast.Call, cls: Optional[_ClassInfo],
                   local_types: Dict[str, str]) -> Optional[str]:
    """A human-readable description if ``call`` blocks, else None."""
    fn = call.func
    attr = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None)
    if attr is None:
        return None
    chain = _attr_chain(fn)
    if attr == "sleep" or attr.endswith("_sleep"):
        return f"{'.'.join(chain) or attr}() sleeps"
    if chain and chain[0] == "subprocess" and attr in _SUBPROCESS_FNS:
        return f"subprocess.{attr}() waits on a child process"
    if attr == "urlopen":
        return "urlopen() performs network I/O"
    if attr in _BLOCKING_ATTRS:
        kind = {"result": "waits on a Future",
                "block_until_ready": "synchronizes with the device",
                "communicate": "waits on a child process"}.get(
                    attr, "performs socket/HTTP I/O")
        return f".{attr}() {kind}"
    recv = fn.value if isinstance(fn, ast.Attribute) else None
    if attr == "join":
        # str.join takes exactly one iterable positional; thread/process
        # join takes none or a numeric timeout
        if isinstance(recv, ast.Constant) and isinstance(recv.value, str):
            return None
        pos_ok = (not call.args
                  or (len(call.args) == 1
                      and isinstance(call.args[0], ast.Constant)
                      and isinstance(call.args[0].value, (int, float))))
        if pos_ok:
            return ".join() waits on a thread"
        return None
    if attr == "wait":
        # Condition.wait on this class's own condition RELEASES the lock
        if recv is not None:
            a = _self_attr(recv)
            if a is not None and cls is not None:
                if a in cls.lock_attrs:
                    return None
                if a in cls.event_attrs:
                    return ".wait() blocks on an Event"
                return None  # unknown attribute: don't guess
            if isinstance(recv, ast.Name):
                cands = local_types.get(recv.id, ())
                if any(t in _LOCK_CTORS for t in cands):
                    return None
                if any(t in _EVENT_CTORS for t in cands):
                    return ".wait() blocks on an Event"
        return None
    return None


def _scan_function(key, fn: ast.AST, graph: LockGraph,
                   cls: Optional[_ClassInfo], module: str, path: str,
                   assume_held: Tuple[str, ...] = ()) -> _Summary:
    s = _Summary()
    local_types: Dict[str, str] = {}

    def lock_node_of(expr: ast.AST) -> Optional[str]:
        """The lock node a ``with`` item acquires, or None."""
        if isinstance(expr, ast.Call):
            # with self._rw.reading(): / self._rw.w_locked(): -> node of _rw
            if isinstance(expr.func, ast.Attribute):
                inner = _self_attr(expr.func.value)
                if (inner is not None and cls is not None
                        and inner in cls.lock_attrs):
                    return cls.lock_node(inner)
            return None
        a = _self_attr(expr)
        if a is not None and cls is not None and a in cls.lock_attrs:
            return cls.lock_node(a)
        if isinstance(expr, ast.Name):
            if (module, expr.id) in graph.mod_locks:
                return f"{module}:{expr.id}"
        return None

    def resolve_call(call: ast.Call):
        """A summary key for the callee, or None."""
        fn_ = call.func
        if isinstance(fn_, ast.Attribute):
            recv = fn_.value
            a = _self_attr(recv)
            if a is not None:
                # self.X.m(): resolve ONLY through X's recorded class —
                # never against the enclosing class (self._entries.get()
                # must not match a same-named method of this class)
                cands = cls.attr_types.get(a, ()) if cls is not None else ()
                for tname in cands:
                    target = graph.classes.get(tname)
                    if target is not None and fn_.attr in target.methods:
                        return ("m", target.name, fn_.attr)
                return None
            if isinstance(recv, ast.Name):
                if recv.id == "self" and cls is not None \
                        and fn_.attr in cls.methods:
                    return ("m", cls.name, fn_.attr)
                for tname in local_types.get(recv.id, ()):
                    target = graph.classes.get(tname)
                    if target is not None and fn_.attr in target.methods:
                        return ("m", target.name, fn_.attr)
            return None
        if isinstance(fn_, ast.Name):
            if (module, fn_.id) in graph.mod_funcs:
                return ("f", module, fn_.id)
        return None

    def note_assign(st: ast.Assign) -> None:
        cands = [c for c in (
            _ctor_name(call) for call in ast.walk(st.value)
            if isinstance(call, ast.Call)) if c is not None]
        src_attr = None
        if isinstance(st.value, ast.Attribute):
            src_attr = _self_attr(st.value)
        for t in st.targets:
            if not isinstance(t, ast.Name):
                continue
            if cands:
                local_types[t.id] = cands
            elif src_attr is not None and cls is not None \
                    and src_attr in cls.attr_types:
                local_types[t.id] = cls.attr_types[src_attr]
            else:
                local_types.pop(t.id, None)

    def visit(node: ast.AST, held: Tuple[str, ...]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs later on an unknown thread with unknown
            # locks: scan its body as an independent empty-held context
            for child in node.body:
                visit(child, ())
            return
        if isinstance(node, ast.Lambda):
            return
        if isinstance(node, ast.ClassDef):
            return
        if isinstance(node, ast.Assign):
            note_assign(node)
        if isinstance(node, ast.With):
            acquired = list(held)
            for item in node.items:
                visit(item.context_expr, tuple(acquired))
                n = lock_node_of(item.context_expr)
                if n is None:
                    continue
                s.acquires.append((n, path, item.context_expr.lineno))
                for h in acquired:
                    if h != n:
                        s.edges.append((h, n, path,
                                        item.context_expr.lineno, ""))
                if n not in acquired:
                    acquired.append(n)
            for stmt in node.body:
                visit(stmt, tuple(acquired))
            return
        if isinstance(node, ast.Call):
            desc = _blocking_desc(node, cls, local_types)
            if desc is not None:
                s.blocks.append((desc, path, node.lineno, held))
            else:
                callee = resolve_call(node)
                if callee is not None:
                    s.calls.append((callee, path, node.lineno, held))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in fn.body:
        visit(stmt, assume_held)
    return s


# ---------------------------------------------------------------------------
# graph assembly + fixpoints
# ---------------------------------------------------------------------------


def build_graph(paths: Iterable[str]) -> LockGraph:
    graph = LockGraph()
    trees: List[Tuple[str, str, ast.Module]] = []
    for f in iter_py_files(paths):
        try:
            with open(f, "r", encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
        except (SyntaxError, OSError):
            continue
        module = _module_name(f)
        trees.append((f, module, tree))
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                info = _index_class(node, module, f)
                # bare-name collisions make resolution ambiguous: disable
                graph.classes[info.name] = (
                    None if info.name in graph.classes else info)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                graph.mod_funcs[(module, node.name)] = node
                graph.mod_func_paths[(module, node.name)] = f
            elif isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        graph.mod_locks[(module, t.id)] = \
                            _ctor_name(node.value) or "Lock"
                        graph.node_ctor[f"{module}:{t.id}"] = \
                            _ctor_name(node.value) or "Lock"

    for info in graph.classes.values():
        if info is None:
            continue
        for attr, ctor in info.lock_attrs.items():
            graph.node_ctor[info.lock_node(attr)] = ctor

    # summaries
    for path, module, tree in trees:
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                info = graph.classes.get(node.name)
                if info is None or info.path != path:
                    info = _index_class(node, module, path)  # shadowed dup
                for mname, m in info.methods.items():
                    assume: Tuple[str, ...] = ()
                    if mname.endswith("_locked"):
                        assume = tuple(sorted({info.lock_node(a)
                                               for a in info.lock_attrs}))
                    graph.summaries[("m", info.name, mname)] = \
                        _scan_function(("m", info.name, mname), m, graph,
                                       info, module, path, assume)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                graph.summaries[("f", module, node.name)] = \
                    _scan_function(("f", module, node.name), node, graph,
                                   None, module, path)

    # fixpoint: which locks may each function (transitively) acquire, and
    # does it (transitively) block
    for key, s in graph.summaries.items():
        graph.may_acquire[key] = {n for n, _, _ in s.acquires}
        if s.blocks:
            graph.may_block[key] = (s.blocks[0][0], "")
    changed = True
    while changed:
        changed = False
        for key, s in graph.summaries.items():
            acq = graph.may_acquire[key]
            for callee, _p, _l, _h in s.calls:
                sub = graph.may_acquire.get(callee)
                if sub and not sub <= acq:
                    acq |= sub
                    changed = True
                if callee in graph.may_block and key not in graph.may_block:
                    desc, via = graph.may_block[callee]
                    name = callee[2] if len(callee) == 3 else str(callee)
                    graph.may_block[key] = (desc,
                                            f"{name}(){' -> ' + via if via else ''}")
                    changed = True

    # edges: direct nested-with + call-mediated
    for key, s in graph.summaries.items():
        for src, dst, path, line, note in s.edges:
            graph.add_edge(src, dst, path, line, note)
        for callee, path, line, held in s.calls:
            sub = graph.may_acquire.get(callee, ())
            cname = callee[2] if len(callee) == 3 else str(callee)
            for h in held:
                for m in sub:
                    if m != h:
                        graph.add_edge(h, m, path, line, f"via {cname}()")
                    else:
                        ctor = graph.node_ctor.get(m, "Lock")
                        if ctor != "RLock":
                            graph.add_edge(h, m, path, line,
                                           f"re-acquired via {cname}()")
    return graph


def _sccs(edges: Dict[str, Dict[str, List]]) -> List[List[str]]:
    """Tarjan strongly-connected components (iterative)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    nodes = set(edges)
    for tgts in edges.values():
        nodes.update(tgts)

    def strongconnect(v0: str) -> None:
        work = [(v0, iter(edges.get(v0, ())))]
        index[v0] = low[v0] = counter[0]
        counter[0] += 1
        stack.append(v0)
        on_stack.add(v0)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(edges.get(w, ()))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                out.append(comp)

    for n in sorted(nodes):
        if n not in index:
            strongconnect(n)
    return out


def _cycle_path(comp: List[str],
                edges: Dict[str, Dict[str, List]]) -> List[str]:
    """One concrete cycle through a (size>=2) SCC, as an ordered node list
    ending where it started."""
    comp_set = set(comp)
    start = sorted(comp)[0]
    path = [start]
    seen = {start}
    v = start
    while True:
        nxt = sorted(w for w in edges.get(v, ()) if w in comp_set)
        if not nxt:
            return path  # shouldn't happen inside an SCC
        w = next((x for x in nxt if x == start), None)
        if w is None:
            w = next((x for x in nxt if x not in seen), nxt[0])
        path.append(w)
        if w == start:
            return path
        if w in seen:
            # trim to the loop we just closed
            i = path.index(w)
            return path[i:]
        seen.add(w)
        v = w


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------


def _graph_findings(graph: LockGraph) -> List[Finding]:
    findings: List[Finding] = []

    # GC-L304: cycles
    for comp in _sccs(graph.edges):
        if len(comp) == 1:
            v = comp[0]
            selfsites = graph.edges.get(v, {}).get(v)
            if not selfsites:
                continue
            path, line, note = selfsites[0]
            findings.append(Finding(
                "GC-L304",
                f"lock {v} is re-acquired while already held "
                f"({note or 'nested with'}) — a non-reentrant lock "
                f"deadlocks its own thread",
                path=path, line=line, source="lock_graph",
                detail={"cycle": [v, v]}))
            continue
        cyc = _cycle_path(comp, graph.edges)
        legs = []
        for a, b in zip(cyc, cyc[1:]):
            site = graph.edges[a][b][0]
            legs.append(f"{a} -> {b} at {site[0]}:{site[1]}"
                        f"{' (' + site[2] + ')' if site[2] else ''}")
        first = graph.edges[cyc[0]][cyc[1]][0]
        findings.append(Finding(
            "GC-L304",
            f"lock-order cycle: {' ; '.join(legs)} — two threads taking "
            f"these paths concurrently deadlock; pick one order and stick "
            f"to it",
            path=first[0], line=first[1], source="lock_graph",
            detail={"cycle": cyc}))

    # GC-L305: blocking under a held lock
    for key, s in graph.summaries.items():
        for desc, path, line, held in s.blocks:
            if held:
                findings.append(Finding(
                    "GC-L305",
                    f"{_key_name(key)}: {desc} while holding "
                    f"{', '.join(held)} — every thread contending that "
                    f"lock stalls for the full wait",
                    path=path, line=line, source="lock_graph",
                    detail={"held": list(held)}))
        for callee, path, line, held in s.calls:
            if not held or callee not in graph.may_block:
                continue
            desc, via = graph.may_block[callee]
            cname = callee[2] if len(callee) == 3 else str(callee)
            chain = f"{cname}(){' -> ' + via if via else ''}"
            findings.append(Finding(
                "GC-L305",
                f"{_key_name(key)}: calls {chain} which blocks ({desc}) "
                f"while holding {', '.join(held)}",
                path=path, line=line, source="lock_graph",
                detail={"held": list(held), "via": chain}))
    findings.sort(key=lambda f: (f.path or "", f.line or 0, f.rule))
    return findings


def _key_name(key) -> str:
    if key[0] == "m":
        return f"{key[1]}.{key[2]}()"
    return f"{key[1]}.{key[2]}()"


def _filter_by_file(findings: List[Finding]) -> List[Finding]:
    """Apply inline suppressions file-by-file (a finding's site is where
    the suppression comment lives, even for cross-module cycles)."""
    by_path: Dict[str, Tuple[Set[str], Dict[int, Set[str]]]] = {}
    out: List[Finding] = []
    for f in findings:
        if f.path is None:
            out.append(f)
            continue
        if f.path not in by_path:
            try:
                with open(f.path, "r", encoding="utf-8") as fh:
                    by_path[f.path] = parse_suppressions(fh.read())
            except OSError:
                by_path[f.path] = (set(), {})
        file_wide, per_line = by_path[f.path]
        if f.rule in file_wide:
            continue
        if f.line is not None and f.rule in per_line.get(f.line, ()):
            continue
        out.append(f)
    return out


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    """The whole-package pass: build one lock graph over every ``.py``
    under ``paths`` and report GC-L304/GC-L305."""
    return _filter_by_file(_graph_findings(build_graph(paths)))
