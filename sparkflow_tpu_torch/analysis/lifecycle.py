"""Resource-lifecycle lint (GC-X601–X604): every acquire released on every
path.

The serving plane is a web of paired operations — a KV slot allocated by
``DecodeEngine.prefill`` must reach ``release``, a pooled connection checked
out of a :class:`~sparkflow_tpu.serving.client.ConnectionPool` must be
returned, a started worker thread must be joined, a ``router/replica<i>/*``
gauge namespace must be removed when the replica deregisters. The test
suite can only spot-check these pairings; this pass checks them statically,
over the whole package, reusing the same class/attribute type inference the
lock graph uses (:mod:`~sparkflow_tpu.analysis.lockgraph`), so
``self._pool.acquire()`` resolves through the ``ConnectionPool(...)``
assignment in ``__init__`` and ``replica.pool.acquire()`` resolves through
``Replica``'s annotated attributes.

What each rule means (the registry of pairs is :data:`PAIRS`):

- **GC-X601** (leak-on-escape): a registered acquire whose handle neither
  reaches a matching release nor transfers ownership (stored onto
  ``self``/a container, passed to a callee, returned) before an explicit
  escape — ``return``/``raise``/``break`` — leaves the function with the
  resource still held. ``with`` context managers and ``try/finally``
  releases are recognized; escapes inside the ``except`` handlers of the
  acquiring ``try`` are exempt (the acquire itself failed — there is
  nothing to release).
- **GC-X602** (release-skipped-on-error): the acquire *does* have a
  matching release later in the function, but code between them can raise
  (it contains calls) and nothing routes the error branch through the
  release — no ``finally``, no handler that releases. One exception and
  the resource leaks.
- **GC-X603** (unreaped-thread): a ``threading.Thread`` (or
  ``subprocess.Popen``) that is ``start()``-ed in a scope — a class, for
  ``self.<attr>`` threads, or one function, for locals — with no
  ``join``/``wait``/``kill``/``terminate`` anywhere in that scope, and no
  ownership transfer out of it.
- **GC-X604** (gauge-namespace-leak): a class publishes metrics under a
  *dynamic* namespace (an f-string name — per-replica, per-version,
  per-tenant) and has lifecycle-end methods (``stop``/``close``/
  ``deregister``/...), but none of them — directly or through a ``self.``
  call — ever calls ``Metrics.remove_prefix``/``remove_matching``. Every
  entity that ever existed stays in the exposition forever. Static gauge
  names are process-level state and exempt.

The dynamic twin of this pass is :mod:`~sparkflow_tpu.analysis.restrack`:
the same registry of pairs, enforced at runtime with per-resource balances
and acquisition stacks (``SPARKFLOW_TPU_RESTRACK=1``).

Intentional sites are suppressed inline — ``# graftcheck: disable=GC-X601``
on the flagged line — the same syntax every other analyzer honors.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .ast_lint import _attr_chain, iter_py_files
from .findings import Finding, filter_suppressed
from .lockgraph import _ClassInfo, _index_class, _module_name

__all__ = ["PAIRS", "ResourcePair", "lint_paths", "lint_source"]


@dataclass(frozen=True)
class ResourcePair:
    """One acquire/release pairing the analyzers (and the runtime
    :class:`~sparkflow_tpu.analysis.restrack.ResourceTracker`) enforce.

    ``owner`` is the class whose *instances* the methods are called on
    (resolved through attribute/local type inference); ``owner=None`` pairs
    match on bare/dotted call names instead (``tempfile.mkdtemp``).
    ``handle=False`` pairs have no caller-owned handle (gauge registration)
    and are checked only by their dedicated rule.
    """

    name: str
    owner: Optional[str]
    acquire: Tuple[str, ...]
    release: Tuple[str, ...]
    handle: bool = True
    #: when set, the caller-owned handle is this positional *argument* of
    #: the acquire, not its return value (``kv.alloc(slot, ...)`` — the
    #: caller names the slot; ``free(slot)`` takes the same name back)
    handle_arg: Optional[int] = None
    description: str = ""


#: The declarative acquire/release registry — the single source of truth
#: shared by GC-X601/X602 (handle pairs), GC-X603 (thread/subprocess pairs,
#: matched on ctor), GC-X604 (the gauge pair), and the runtime tracker.
PAIRS: Tuple[ResourcePair, ...] = (
    ResourcePair("kv-pages", "PagedKVCache", ("alloc",),
                 ("free", "truncate"), handle_arg=0,
                 description="paged KV slot + its pages"),
    ResourcePair("decode-slot", "DecodeEngine", ("prefill",), ("release",),
                 description="decode slot admitted by prefill"),
    ResourcePair("batch-slot", "ContinuousBatcher", ("_try_admit_locked",),
                 ("_finish",),
                 description="batcher admission (popped request -> retire)"),
    ResourcePair("http-conn", "ConnectionPool", ("acquire",),
                 ("release", "close"),
                 description="pooled keep-alive connection checkout"),
    ResourcePair("gauge-ns", "Metrics", ("gauge",),
                 ("remove_prefix", "remove_matching"), handle=False,
                 description="metrics namespace registration"),
    ResourcePair("thread", None, ("Thread", "Timer"), ("join",),
                 description="started worker thread"),
    ResourcePair("subprocess", None, ("Popen",),
                 ("wait", "communicate", "poll", "kill", "terminate"),
                 description="spawned child process"),
    ResourcePair("fault-point", None, ("inject",), ("__exit__",),
                 description="armed fault point (context-managed)"),
    ResourcePair("tempdir", None, ("mkdtemp",),
                 ("rmtree", "rename", "replace"),
                 description="temporary directory (create -> rename/rm)"),
)

_HANDLE_PAIRS = tuple(p for p in PAIRS
                      if p.handle and p.owner is not None)
#: owner=None handle pairs matched on the call name itself
_NAME_PAIRS = {"mkdtemp": next(p for p in PAIRS if p.name == "tempdir")}
_THREAD_CTORS = {"Thread", "Timer"}
_PROC_CTORS = {"Popen"}
_THREAD_REAP = {"join"}
_PROC_REAP = {"wait", "communicate", "poll", "kill", "terminate"}
_GAUGE_CLEANUP = {"remove_prefix", "remove_matching", "reset"}
#: terminal teardown — the object is done for good; per-entity gauges it
#: published MUST come down here (deregister may never run for every entity
#: before the owner stops, so cleanup only there is not enough)
_TERMINAL_END = {"stop", "close", "shutdown", "stop_all", "terminate",
                 "uninstall", "__exit__", "__del__"}
_LIFECYCLE_END = _TERMINAL_END | {"deregister", "drain"}


# ---------------------------------------------------------------------------
# model: classes + per-receiver type resolution (lockgraph's inference)
# ---------------------------------------------------------------------------


@dataclass
class _Model:
    classes: Dict[str, Optional[_ClassInfo]] = field(default_factory=dict)


def _build_model(trees: Sequence[Tuple[str, str, ast.Module]]) -> _Model:
    model = _Model()
    for path, module, tree in trees:
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                info = _index_class(node, module, path)
                # bare-name collisions make resolution ambiguous: disable
                model.classes[info.name] = (
                    None if info.name in model.classes else info)
    return model


def _ctor_candidates(value: ast.AST) -> List[str]:
    """Every ctor name mentioned in an assigned expression (the lockgraph
    convention: ``m if m else Metrics()`` yields ``["Metrics"]``)."""
    out: List[str] = []
    for call in ast.walk(value):
        if isinstance(call, ast.Call):
            fn = call.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None)
            if name is not None:
                out.append(name)
    return out


def _recv_types(recv: ast.AST, cls: Optional[_ClassInfo],
                local_types: Dict[str, List[str]],
                model: _Model) -> List[str]:
    """Candidate class names for a receiver expression: ``self`` -> the
    enclosing class, locals via recorded ctor/annotation candidates,
    ``self.attr`` (and chains like ``replica.pool``) via each class's
    inferred attribute types."""
    if isinstance(recv, ast.Name):
        if recv.id == "self" and cls is not None:
            return [cls.name]
        return list(local_types.get(recv.id, ()))
    if isinstance(recv, ast.Attribute):
        out: List[str] = []
        for base in _recv_types(recv.value, cls, local_types, model):
            info = model.classes.get(base)
            if info is not None:
                out.extend(info.attr_types.get(recv.attr, ()))
        return out
    return []


def _mentions(node: ast.AST, names: Set[str]) -> bool:
    return any(isinstance(n, ast.Name) and n.id in names
               for n in ast.walk(node))


def _fn_nodes(fn: ast.AST) -> List[ast.AST]:
    """Every node in ``fn``'s own body, NOT descending into nested
    defs/lambdas/classes (they run later, on their own paths)."""
    out: List[ast.AST] = []
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return out


def _parents(fn: ast.AST) -> Dict[ast.AST, ast.AST]:
    par: Dict[ast.AST, ast.AST] = {}
    stack = [fn]
    while stack:
        n = stack.pop()
        if n is not fn and isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                    ast.ClassDef)):
            continue
        for c in ast.iter_child_nodes(n):
            par[c] = n
            stack.append(c)
    return par


def _try_ancestry(node: ast.AST, par: Dict[ast.AST, ast.AST]
                  ) -> List[Tuple[ast.Try, str]]:
    """[(try node, which part of it holds ``node``)] innermost-first;
    part is 'body'/'handler'/'final'/'orelse'."""
    out: List[Tuple[ast.Try, str]] = []
    child, cur = node, par.get(node)
    while cur is not None:
        if isinstance(cur, ast.Try):
            if any(child is h or _contains(h, child)
                   for h in cur.handlers):
                out.append((cur, "handler"))
            elif any(child is s or _contains(s, child)
                     for s in cur.finalbody):
                out.append((cur, "final"))
            elif any(child is s or _contains(s, child)
                     for s in cur.orelse):
                out.append((cur, "orelse"))
            else:
                out.append((cur, "body"))
        child, cur = cur, par.get(cur)
    return out


def _contains(root: ast.AST, target: ast.AST) -> bool:
    return any(n is target for n in ast.walk(root))


def _is_none_guard(test: ast.AST, handles: Set[str]) -> bool:
    """``if h is None:`` / ``if not h:`` — the acquire *failed*; an escape
    under this guard has nothing to release."""
    if isinstance(test, ast.Compare) and len(test.ops) == 1 and \
            isinstance(test.ops[0], ast.Is) and \
            isinstance(test.left, ast.Name) and test.left.id in handles and \
            isinstance(test.comparators[0], ast.Constant) and \
            test.comparators[0].value is None:
        return True
    return (isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
            and isinstance(test.operand, ast.Name)
            and test.operand.id in handles)


def _under_none_guard(node: ast.AST, handles: Set[str],
                      par: Dict[ast.AST, ast.AST]) -> bool:
    child, cur = node, par.get(node)
    while cur is not None:
        if isinstance(cur, ast.If) and any(
                s is child or _contains(s, child) for s in cur.body) \
                and _is_none_guard(cur.test, handles):
            return True
        child, cur = cur, par.get(cur)
    return False


def _innermost_loop(node: ast.AST, par: Dict[ast.AST, ast.AST]
                    ) -> Optional[ast.AST]:
    cur = par.get(node)
    while cur is not None:
        if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
            return cur
        cur = par.get(cur)
    return None


# ---------------------------------------------------------------------------
# per-function scan: X601 / X602
# ---------------------------------------------------------------------------


@dataclass
class _Acquire:
    pair: ResourcePair
    node: ast.Call
    recv_chain: Tuple[str, ...]      # () for name-matched pairs (mkdtemp)
    handles: Set[str]                # local names bound to the result


def _call_name(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _is_release_call(call: ast.Call, acq: _Acquire,
                     cls: Optional[_ClassInfo],
                     local_types: Dict[str, List[str]],
                     model: _Model) -> bool:
    name = _call_name(call)
    if name not in acq.pair.release:
        return False
    if acq.recv_chain and isinstance(call.func, ast.Attribute):
        if tuple(_attr_chain(call.func.value)) == acq.recv_chain:
            return True
        types = _recv_types(call.func.value, cls, local_types, model)
        if acq.pair.owner in types:
            return True
        return False
    # name-matched pairs (tempdir): shutil.rmtree(d) / os.rename(d, ...)
    return bool(acq.handles) and any(_mentions(a, acq.handles)
                                     for a in call.args)


def _scan_function(fn: ast.AST, cls: Optional[_ClassInfo], model: _Model,
                   path: str) -> List[Finding]:
    findings: List[Finding] = []
    par = _parents(fn)
    nodes = _fn_nodes(fn)

    # pass 1: local types (assignment ctors, annotated params, loop aliases)
    local_types: Dict[str, List[str]] = {}
    args = getattr(fn, "args", None)
    if args is not None:
        from .lockgraph import _ann_tokens
        for a in (*args.posonlyargs, *args.args, *args.kwonlyargs):
            if a.annotation is not None:
                toks = _ann_tokens(a.annotation)
                if toks:
                    local_types[a.arg] = toks
    for n in nodes:
        if isinstance(n, ast.Assign):
            cands = _ctor_candidates(n.value)
            for t in n.targets:
                if isinstance(t, ast.Name) and cands:
                    local_types[t.id] = cands
        elif isinstance(n, (ast.For, ast.AsyncFor)):
            # `for w in self._workers:` — elements of a Thread-holding
            # container type like the container's recorded candidates
            if isinstance(n.target, ast.Name):
                elem = _recv_types(n.iter, cls, local_types, model)
                if not elem:
                    cands = (_ctor_candidates(n.iter)
                             if not isinstance(n.iter, ast.Name)
                             else local_types.get(n.iter.id, []))
                    elem = list(cands)
                if elem:
                    local_types[n.target.id] = elem

    # pass 2: acquires
    acquires: List[_Acquire] = []
    for n in nodes:
        if not isinstance(n, ast.Call):
            continue
        name = _call_name(n)
        pair: Optional[ResourcePair] = None
        recv_chain: Tuple[str, ...] = ()
        if name in _NAME_PAIRS:
            pair = _NAME_PAIRS[name]
        elif isinstance(n.func, ast.Attribute):
            for p in _HANDLE_PAIRS:
                if name in p.acquire:
                    types = _recv_types(n.func.value, cls, local_types,
                                        model)
                    if p.owner in types:
                        pair = p
                        recv_chain = tuple(_attr_chain(n.func.value))
                        break
        if pair is None:
            continue
        handles: Set[str] = set()
        if pair.handle_arg is not None:
            if len(n.args) > pair.handle_arg:
                for sub in ast.walk(n.args[pair.handle_arg]):
                    if isinstance(sub, ast.Name):
                        handles.add(sub.id)
        else:
            parent = par.get(n)
            while isinstance(parent, (ast.Tuple, ast.List, ast.Starred)):
                parent = par.get(parent)
            if isinstance(parent, ast.Assign):
                for t in parent.targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Name):
                            handles.add(sub.id)
        acquires.append(_Acquire(pair, n, recv_chain, handles))

    for acq in acquires:
        # context-managed acquire: `with pool.acquire() as c:` /
        # `with faults.inject(...):` — cleanup is the CM's job
        parent = par.get(acq.node)
        if isinstance(parent, ast.withitem):
            continue
        anc = _try_ancestry(acq.node, par)
        protective_final = False
        protective_handler = False
        for t, part in anc:
            if part != "body":
                continue
            for s in t.finalbody:
                for c in ast.walk(s):
                    if isinstance(c, ast.Call) and _is_release_call(
                            c, acq, cls, local_types, model):
                        protective_final = True
            for h in t.handlers:
                for c in ast.walk(h):
                    if isinstance(c, ast.Call) and _is_release_call(
                            c, acq, cls, local_types, model):
                        protective_handler = True
        if protective_final:
            continue

        acq_line = acq.node.lineno
        # where does this function's responsibility for the handle end?
        # the first matching release, or the first ownership transfer —
        # stored onto self/a container, passed into a call, returned/yielded
        end_line: Optional[int] = None
        end_node: Optional[ast.AST] = None
        release_line: Optional[int] = None
        for n in nodes:
            ln = getattr(n, "lineno", None)
            if ln is None or ln <= acq_line:
                continue
            if isinstance(n, ast.Call) and _is_release_call(
                    n, acq, cls, local_types, model):
                release_line = ln if release_line is None \
                    else min(release_line, ln)
                if end_line is None or ln < end_line:
                    end_line, end_node = ln, n
                continue
            if not acq.handles:
                continue
            transferred = False
            if isinstance(n, ast.Call) and n is not acq.node:
                if any(_mentions(a, acq.handles)
                       for a in (*n.args, *(kw.value for kw in n.keywords))):
                    transferred = True
            elif isinstance(n, (ast.Return, ast.Yield, ast.YieldFrom)):
                if n.value is not None and _mentions(n.value, acq.handles):
                    transferred = True
            elif isinstance(n, ast.Assign):
                stores = any(isinstance(t, (ast.Attribute, ast.Subscript))
                             for t in n.targets)
                if stores and _mentions(n.value, acq.handles):
                    transferred = True
            if transferred and (end_line is None or ln < end_line):
                end_line, end_node = ln, n
        # also: the acquire expression itself consumed by a transfer
        # (`return pool.acquire()`, `self.conn = pool.acquire()` — Assign
        # to an attribute target)
        p2 = par.get(acq.node)
        while p2 is not None and not isinstance(
                p2, (ast.Return, ast.Assign, ast.Call, ast.stmt)):
            p2 = par.get(p2)
        if isinstance(p2, ast.Return):
            continue
        if isinstance(p2, ast.Assign) and any(
                isinstance(t, (ast.Attribute, ast.Subscript))
                for t in p2.targets):
            continue

        horizon = end_line if end_line is not None else float("inf")

        # GC-X601: explicit escapes inside the exposure window
        for n in nodes:
            if not isinstance(n, (ast.Return, ast.Raise, ast.Break)):
                continue
            ln = getattr(n, "lineno", 0)
            if not (acq_line < ln < horizon):
                continue
            if acq.handles and isinstance(n, ast.Return) \
                    and n.value is not None \
                    and _mentions(n.value, acq.handles):
                continue  # returning the handle IS the transfer
            # `if h is None: return/break` — the acquire came back empty;
            # there is nothing to release on this path
            if acq.handles and _under_none_guard(n, acq.handles, par):
                continue
            # a `break` only skips the release/transfer if that release is
            # inside the same loop it breaks out of; a release below the
            # loop still runs
            if isinstance(n, ast.Break):
                loop = _innermost_loop(n, par)
                if loop is not None and end_node is not None and \
                        not _contains(loop, end_node):
                    continue
            esc_anc = _try_ancestry(n, par)
            # a finally on the escape's own path pays the release — the
            # canonical `h = acquire()` / `try: ... finally: release(h)`
            # puts the acquire OUTSIDE the try, so this must be checked on
            # the escape, not just on the acquire
            if any(part in ("body", "handler", "orelse") and any(
                    isinstance(c, ast.Call) and _is_release_call(
                        c, acq, cls, local_types, model)
                    for s in t.finalbody for c in ast.walk(s))
                   for t, part in esc_anc):
                continue
            # escapes inside the except handlers of the acquiring try are
            # reacting to the acquire's own failure: nothing was acquired
            if any(part == "handler" and any(
                    t2 is t and pt == "body"
                    for t2, pt in _try_ancestry(acq.node, par))
                   for t, part in esc_anc):
                continue
            kind = type(n).__name__.lower()
            findings.append(Finding(
                "GC-X601",
                f"{acq.pair.name}: {_call_name(acq.node)}() at line "
                f"{acq_line} acquires a {acq.pair.description or 'resource'}"
                f" but this {kind} escapes before any "
                f"{'/'.join(acq.pair.release)} — wrap the region in "
                f"try/finally or release before escaping",
                path=path, line=ln, source="lifecycle",
                detail={"pair": acq.pair.name, "acquire_line": acq_line}))
            break  # one report per acquire

        # GC-X602: a release exists but the error branch skips it
        if release_line is not None and not protective_handler \
                and (end_line is None or release_line <= end_line):
            risky = None
            for n in nodes:
                if not isinstance(n, ast.Call) or n is acq.node:
                    continue
                ln = getattr(n, "lineno", 0)
                if not (acq_line < ln < release_line):
                    continue
                if _is_release_call(n, acq, cls, local_types, model):
                    continue
                # `raise SomeError(...)`: the exception ctor is not a risky
                # call — the raise itself is the escape, and X601 owns it
                if isinstance(par.get(n), ast.Raise):
                    continue
                # a call whose own enclosing try releases in a handler or
                # finally is protected
                covered = False
                for t, part in _try_ancestry(n, par):
                    if part != "body":
                        continue
                    for s in (*t.finalbody, *t.handlers):
                        for c in ast.walk(s):
                            if isinstance(c, ast.Call) and _is_release_call(
                                    c, acq, cls, local_types, model):
                                covered = True
                if not covered:
                    risky = n
                    break
            if risky is not None:
                findings.append(Finding(
                    "GC-X602",
                    f"{acq.pair.name}: {_call_name(risky)}() between this "
                    f"{_call_name(acq.node)}() and its "
                    f"{'/'.join(acq.pair.release)} at line {release_line} "
                    f"can raise, and no try/finally or handler routes that "
                    f"error through the release",
                    path=path, line=acq_line, source="lifecycle",
                    detail={"pair": acq.pair.name,
                            "release_line": release_line,
                            "risky_line": risky.lineno}))
    return findings


# ---------------------------------------------------------------------------
# X603: started threads / spawned subprocesses must be reaped in scope
# ---------------------------------------------------------------------------


def _thread_kind(cands: Iterable[str]) -> Optional[str]:
    cands = set(cands)
    if cands & _THREAD_CTORS:
        return "thread"
    if cands & _PROC_CTORS:
        return "subprocess"
    return None


def _scan_threads_class(info: _ClassInfo, model: _Model, path: str
                        ) -> List[Finding]:
    """Class scope: a ``self.<attr>`` thread started anywhere in the class
    must be joined (wait/kill/terminate for processes) somewhere in the
    class."""
    kinds = {attr: _thread_kind(c)
             for attr, c in info.attr_types.items()}
    kinds = {a: k for a, k in kinds.items() if k is not None}
    if not kinds:
        return []
    started: Dict[str, ast.Call] = {}
    reaped: Set[str] = set()
    for m in info.methods.values():
        par = _parents(m)
        aliases: Dict[str, str] = {}  # loop var -> self attr
        for n in _fn_nodes(m):
            if isinstance(n, (ast.For, ast.AsyncFor)) and \
                    isinstance(n.target, ast.Name):
                it = n.iter
                # `for w in self._workers:` (also through list()/values())
                for sub in ast.walk(it):
                    if isinstance(sub, ast.Attribute) and \
                            isinstance(sub.value, ast.Name) and \
                            sub.value.id == "self" and sub.attr in kinds:
                        aliases[n.target.id] = sub.attr
        for n in _fn_nodes(m):
            # Popen has no .start(): the ctor assignment IS the start
            if isinstance(n, ast.Assign) and \
                    _thread_kind(_ctor_candidates(n.value)) == "subprocess":
                for t in n.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self" and t.attr in kinds:
                        started.setdefault(t.attr, n)
                continue
            if not isinstance(n, ast.Call) or \
                    not isinstance(n.func, ast.Attribute):
                continue
            recv = n.func.value
            attr = None
            if isinstance(recv, ast.Attribute) and \
                    isinstance(recv.value, ast.Name) and \
                    recv.value.id == "self" and recv.attr in kinds:
                attr = recv.attr
            elif isinstance(recv, ast.Name) and recv.id in aliases:
                attr = aliases[recv.id]
            if attr is None:
                continue
            reap = (_THREAD_REAP if kinds[attr] == "thread" else _PROC_REAP)
            if n.func.attr == "start":
                started.setdefault(attr, n)
            elif n.func.attr in reap:
                reaped.add(attr)
    out = []
    for attr, site in started.items():
        if attr in reaped:
            continue
        kind = kinds[attr]
        verbs = ("join" if kind == "thread"
                 else "wait/poll/kill/terminate")
        out.append(Finding(
            "GC-X603",
            f"{info.name}.{attr}: {kind} started here is never "
            f"{verbs}-ed anywhere in {info.name} — stop()/close() "
            f"abandons it mid-flight",
            path=path, line=site.lineno, source="lifecycle",
            detail={"class": info.name, "attr": attr, "kind": kind}))
    return out


def _scan_threads_function(fn: ast.AST, cls: Optional[_ClassInfo],
                           model: _Model, path: str) -> List[Finding]:
    """Function scope: a local Thread/Popen started here must be reaped
    here, unless ownership escapes (returned, stored, passed along)."""
    local_kind: Dict[str, str] = {}
    proc_assigns: Dict[str, ast.Assign] = {}
    escaped: Set[str] = set()
    nodes = _fn_nodes(fn)
    for n in nodes:
        if isinstance(n, ast.Assign):
            kind = _thread_kind(_ctor_candidates(n.value))
            for t in n.targets:
                if isinstance(t, ast.Name):
                    if kind is not None:
                        local_kind[t.id] = kind
                        if kind == "subprocess":
                            # Popen has no .start(): the ctor IS the start
                            proc_assigns.setdefault(t.id, n)
                elif isinstance(t, (ast.Attribute, ast.Subscript)):
                    # self._t = threading.Thread(...) — class scope's job;
                    # d[k] = Popen(...) — container ownership, skip
                    pass
    if not local_kind:
        return []
    names = set(local_kind)
    aliases: Dict[str, str] = {}
    for n in nodes:
        if isinstance(n, (ast.For, ast.AsyncFor)) and \
                isinstance(n.target, ast.Name) and \
                isinstance(n.iter, ast.Name) and n.iter.id in names:
            aliases[n.target.id] = n.iter.id
        if isinstance(n, (ast.Return, ast.Yield, ast.YieldFrom)) and \
                getattr(n, "value", None) is not None and \
                _mentions(n.value, names):
            escaped |= {nm for nm in names if _mentions(n.value, {nm})}
        if isinstance(n, ast.Assign) and _mentions(n.value, names):
            if any(isinstance(t, (ast.Attribute, ast.Subscript))
                   for t in n.targets):
                escaped |= {nm for nm in names if _mentions(n.value, {nm})}
        if isinstance(n, ast.Call):
            fname = _call_name(n)
            for a in (*n.args, *(kw.value for kw in n.keywords)):
                for nm in names:
                    if _mentions(a, {nm}):
                        # v.start()/v.join() receivers are not arguments;
                        # append(v) / register(v) hands ownership off
                        escaped.add(nm)
            del fname
    started: Dict[str, ast.Call] = {}
    reaped: Set[str] = set()
    for n in nodes:
        if not isinstance(n, ast.Call) or \
                not isinstance(n.func, ast.Attribute) or \
                not isinstance(n.func.value, ast.Name):
            continue
        rid = n.func.value.id
        target = rid if rid in names else aliases.get(rid)
        if target is None:
            continue
        kind = local_kind[target]
        reap = _THREAD_REAP if kind == "thread" else _PROC_REAP
        if n.func.attr == "start":
            started.setdefault(target, n)
        elif n.func.attr in reap:
            reaped.add(target)
    for nm, site in proc_assigns.items():
        started.setdefault(nm, site)
    out = []
    for nm, site in started.items():
        if nm in reaped or nm in escaped:
            continue
        kind = local_kind[nm]
        out.append(Finding(
            "GC-X603",
            f"local {kind} {nm!r} is started but never "
            f"{'joined' if kind == 'thread' else 'reaped'} in this "
            f"function, and never handed off — it outlives the scope that "
            f"knows about it",
            path=path, line=site.lineno, source="lifecycle",
            detail={"name": nm, "kind": kind}))
    return out


# ---------------------------------------------------------------------------
# X604: dynamic gauge namespaces need a cleanup path
# ---------------------------------------------------------------------------


def _is_metrics_recv(recv: ast.AST, cls: Optional[_ClassInfo],
                     model: _Model) -> bool:
    types = _recv_types(recv, cls, {}, model)
    if "Metrics" in types:
        return True
    chain = _attr_chain(recv)
    return bool(chain) and chain[-1] in ("metrics", "_metrics")


def _dynamic_name(arg: ast.AST) -> bool:
    """True when a metric name is built per-entity: an f-string with a
    formatted value, ``.format(...)``, or ``%``/``+`` composition over
    non-constants. A plain string literal (or Name) is process-level."""
    if isinstance(arg, ast.JoinedStr):
        return any(isinstance(v, ast.FormattedValue) for v in arg.values)
    if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute) \
            and arg.func.attr == "format":
        return True
    if isinstance(arg, ast.BinOp) and isinstance(arg.op, (ast.Mod, ast.Add)):
        return any(not isinstance(x, ast.Constant)
                   for x in (arg.left, arg.right))
    return False


def _scan_gauges_class(info: _ClassInfo, model: _Model, path: str
                       ) -> List[Finding]:
    lifecycle_methods = [m for name, m in info.methods.items()
                         if name in _LIFECYCLE_END]
    if not lifecycle_methods:
        return []  # no shutdown path to hang a cleanup on: out of scope
    # does any lifecycle-end method reach remove_prefix/remove_matching,
    # directly or through self.* calls (fixpoint within the class)?
    cleans: Set[str] = set()
    calls_of: Dict[str, Set[str]] = {}
    for name, m in info.methods.items():
        called: Set[str] = set()
        for n in _fn_nodes(m):
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute):
                if n.func.attr in _GAUGE_CLEANUP:
                    cleans.add(name)
                if isinstance(n.func.value, ast.Name) and \
                        n.func.value.id == "self":
                    called.add(n.func.attr)
        calls_of[name] = called
    changed = True
    while changed:
        changed = False
        for name, called in calls_of.items():
            if name not in cleans and called & cleans:
                cleans.add(name)
                changed = True
    # terminal teardown (stop/close/...) must itself reach the cleanup:
    # per-entity deregister cleaning is necessary but not sufficient — live
    # entities at stop() time still leak their gauges (the PR 18 bug class)
    terminal = [m for m in lifecycle_methods if m.name in _TERMINAL_END]
    required = terminal if terminal else lifecycle_methods
    if any(m.name in cleans for m in required):
        return []
    # dynamic gauge registrations with no cleanup anywhere on shutdown
    for name, m in info.methods.items():
        for n in _fn_nodes(m):
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr == "gauge" and n.args and \
                    _dynamic_name(n.args[0]) and \
                    _is_metrics_recv(n.func.value, info, model):
                ends = sorted(m2.name for m2 in lifecycle_methods)
                return [Finding(
                    "GC-X604",
                    f"{info.name}.{name}() publishes gauges under a "
                    f"per-entity namespace but none of its lifecycle-end "
                    f"methods ({', '.join(ends)}) removes them "
                    f"(Metrics.remove_prefix/remove_matching) — departed "
                    f"entities stay in the exposition forever",
                    path=path, line=n.lineno, source="lifecycle",
                    detail={"class": info.name, "method": name})]
    return []


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _lint_tree(path: str, module: str, tree: ast.Module,
               model: _Model) -> List[Finding]:
    findings: List[Finding] = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            info = model.classes.get(node.name)
            if info is None or info.path != path:
                info = _index_class(node, module, path)  # shadowed dup
            findings.extend(_scan_threads_class(info, model, path))
            findings.extend(_scan_gauges_class(info, model, path))
            for m in info.methods.values():
                findings.extend(_scan_function(m, info, model, path))
                findings.extend(
                    _scan_threads_function(m, info, model, path))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            findings.extend(_scan_function(node, None, model, path))
            findings.extend(
                _scan_threads_function(node, None, model, path))
    findings.sort(key=lambda f: (f.path or "", f.line or 0, f.rule))
    return findings


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    """The whole-package resource-lifecycle pass: one model over every
    ``.py`` under ``paths`` (so cross-file receiver types resolve), then
    GC-X601–X604 per file, inline suppressions honored."""
    trees: List[Tuple[str, str, ast.Module]] = []
    sources: Dict[str, str] = {}
    for f in iter_py_files(paths):
        try:
            with open(f, "r", encoding="utf-8") as fh:
                src = fh.read()
            tree = ast.parse(src)
        except (SyntaxError, OSError):
            continue
        sources[f] = src
        trees.append((f, _module_name(f), tree))
    model = _build_model(trees)
    findings: List[Finding] = []
    for path, module, tree in trees:
        fs = _lint_tree(path, module, tree, model)
        findings.extend(filter_suppressed(fs, sources[path]))
    return findings


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    """Single-source convenience for tests: the model is just this file."""
    tree = ast.parse(source)
    module = "mod"
    model = _build_model([(path, module, tree)])
    return filter_suppressed(_lint_tree(path, module, tree, model), source)
