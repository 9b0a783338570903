"""Lock-coverage rules (GC-L3xx): shared-state mutation outside the lock.

The serving stack (engine / micro-batcher / HTTP front) and the metrics
registry are mutated from many threads; the repo's convention is a
``threading.Lock``/``Condition`` attribute created in ``__init__`` and
``with self._lock:`` around every write. This pass checks that convention
statically, per class:

- a class *owns a lock* when any method assigns ``self.X =
  threading.Lock() / RLock() / Condition(...) / RWLock()``;
- an attribute is *guarded* when some method writes it inside a
  ``with self.X:`` block (X a lock attribute);
- **GC-L301**: a write to a guarded attribute outside any lock block —
  the class treats the attribute as shared, then mutates it unprotected;
- **GC-L302**: a read-modify-write (``self.y += 1``, or ``self.y[k] += 1``)
  outside any lock block in a lock-owning class — load/modify/store is not
  atomic even under the GIL, so concurrent increments lose updates.
- **GC-L303**: a ``*_locked`` helper is called outside any lock block —
  the naming convention promises "caller holds the lock", so an unlocked
  call site breaks the contract the helper's body relies on.

Methods whose name ends in ``_locked`` are the repo's convention for
"called with the lock already held" (e.g. an eviction sweep shared by
several locked entry points). Their bodies are scanned as if inside the
lock — the enforcement moves to their CALL SITES via GC-L303.

``__init__`` (and ``__new__``) are exempt: no other thread holds the
object during construction. Classes that own no lock are skipped entirely
— single-threaded code is allowed to mutate freely; this rule exists for
classes that already declared themselves concurrent by owning a lock.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set, Tuple

from .findings import Finding, filter_suppressed
from .ast_lint import iter_py_files

__all__ = ["lint_source", "lint_file", "lint_paths"]

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore", "RWLock"}
_EXEMPT_METHODS = {"__init__", "__new__"}


def _self_attr(node: ast.AST) -> Optional[str]:
    """'X' when ``node`` is ``self.X``, else None."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _write_targets(stmt: ast.stmt) -> List[Tuple[str, bool, int]]:
    """(attr, is_rmw, lineno) for each ``self.X = ...`` / ``self.X += ...``
    / ``self.X[k] += ...`` in one statement."""
    out: List[Tuple[str, bool, int]] = []

    def target_attr(t: ast.AST) -> Optional[str]:
        attr = _self_attr(t)
        if attr is not None:
            return attr
        # self.X[k] — a write through a container attribute
        if isinstance(t, ast.Subscript):
            return _self_attr(t.value)
        return None

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            for e in elts:
                attr = _self_attr(e)  # plain rebinds only; self.d[k] = v
                if attr is not None:  # on an Assign is not a lost-update rmw
                    out.append((attr, False, stmt.lineno))
    elif isinstance(stmt, ast.AugAssign):
        attr = target_attr(stmt.target)
        if attr is not None:
            out.append((attr, True, stmt.lineno))
    elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        attr = _self_attr(stmt.target)
        if attr is not None:
            out.append((attr, False, stmt.lineno))
    return out


def _is_lock_ctor(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    fn = value.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None)
    return name in _LOCK_CTORS


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
            for t in node.targets:
                attr = _self_attr(t)
                if attr is not None:
                    locks.add(attr)
        # aliasing: self._cond = threading.Condition(self._lock) both count
    return locks


def _with_holds_lock(stmt: ast.With, locks: Set[str]) -> bool:
    for item in stmt.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call):  # e.g. self._rw.w_locked()
            expr = expr.func
            if isinstance(expr, ast.Attribute):
                maybe = _self_attr(expr.value)
                if maybe in locks:
                    return True
                continue
        if _self_attr(expr) in locks:
            return True
    return False


def _scan_method(method: ast.AST, locks: Set[str],
                 assume_locked: bool = False):
    """Yield (attr, is_rmw, lineno, locked) for every self-attr write in
    ``method``, tracking whether a lock-holding ``with`` encloses it.
    ``assume_locked`` seeds the tracking for ``*_locked`` helpers."""

    def walk(stmts, locked: bool):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested callbacks execute on unknown threads later; their
                # writes are scanned as unlocked only if the def itself
                # is reached — keep it simple and scan with locked=False
                yield from walk(st.body, False)
                continue
            for rec in _write_targets(st):
                yield (*rec, locked)
            if isinstance(st, ast.With):
                yield from walk(st.body,
                                locked or _with_holds_lock(st, locks))
            elif isinstance(st, (ast.If,)):
                yield from walk(st.body, locked)
                yield from walk(st.orelse, locked)
            elif isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                yield from walk(st.body, locked)
                yield from walk(st.orelse, locked)
            elif isinstance(st, ast.Try):
                yield from walk(st.body, locked)
                for h in st.handlers:
                    yield from walk(h.body, locked)
                yield from walk(st.orelse, locked)
                yield from walk(st.finalbody, locked)

    yield from walk(method.body, assume_locked)


def _scan_calls(method: ast.AST, locks: Set[str], held: Set[str],
                assume_locked: bool):
    """Yield (helper_name, lineno, locked) for every ``self.<X>(...)`` call
    where ``X`` is a ``*_locked`` helper, tracking lock context."""

    def visit(node: ast.AST, locked: bool):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested callback: unknown thread / unknown lock state later
            for child in ast.iter_child_nodes(node):
                yield from visit(child, False)
            return
        if isinstance(node, ast.With):
            inner = locked or _with_holds_lock(node, locks)
            for item in node.items:
                yield from visit(item, locked)
            for st in node.body:
                yield from visit(st, inner)
            return
        if isinstance(node, ast.Call):
            attr = _self_attr(node.func)
            if attr in held:
                yield (attr, node.lineno, locked)
        for child in ast.iter_child_nodes(node):
            yield from visit(child, locked)

    for st in method.body:
        yield from visit(st, assume_locked)


def _lint_class(cls: ast.ClassDef, path: str) -> List[Finding]:
    locks = _lock_attrs(cls)
    if not locks:
        return []
    methods = [n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    # *_locked naming = "caller holds the lock": bodies scan as locked,
    # call sites are checked instead (GC-L303)
    held = {m.name for m in methods if m.name.endswith("_locked")}
    # pass 1: which attributes does this class ever write under a lock?
    guarded: Set[str] = set()
    for m in methods:
        for attr, _rmw, _line, locked in _scan_method(
                m, locks, assume_locked=m.name in held):
            if locked:
                guarded.add(attr)
    guarded -= locks
    # pass 2: violations
    out: List[Finding] = []
    for m in methods:
        if m.name in _EXEMPT_METHODS:
            continue
        assume = m.name in held
        for name, line, locked in _scan_calls(m, locks, held, assume):
            if not locked:
                out.append(Finding(
                    "GC-L303",
                    f"{cls.name}.{m.name}() calls self.{name}() outside "
                    f"any lock block — the _locked suffix promises the "
                    f"caller holds the lock",
                    path=path, line=line, source="lock_lint"))
        for attr, rmw, line, locked in _scan_method(
                m, locks, assume_locked=assume):
            if locked or attr in locks:
                continue
            if attr in guarded:
                out.append(Finding(
                    "GC-L301",
                    f"{cls.name}.{m.name}() writes self.{attr} without "
                    f"holding the lock, but other methods guard it — "
                    f"racy against every locked reader/writer",
                    path=path, line=line, source="lock_lint"))
            elif rmw:
                out.append(Finding(
                    "GC-L302",
                    f"{cls.name}.{m.name}() read-modify-writes self.{attr} "
                    f"outside any lock in a lock-owning class — concurrent "
                    f"updates lose increments",
                    path=path, line=line, source="lock_lint"))
    return out


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return []
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            findings.extend(_lint_class(node, path))
    findings.sort(key=lambda f: (f.line or 0, f.rule))
    return filter_suppressed(findings, source)


def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(lint_file(f))
    return findings
