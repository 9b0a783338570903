"""GC-S501 impure-policy: purity lint for marked policy modules.

The policy/transport split (``serving/policies.py``) only holds if policy
code stays a pure function of its inputs: the fleet simulator replays
those decisions deterministically in virtual time, so a stray
``time.monotonic()`` or ``random.random()`` inside a policy silently
forks sim behavior from production behavior — the worst kind of model
error, because every parity test still passes on the code paths it pins.

This analyzer enforces the contract mechanically. A module opts in with a
marker comment in its first ten lines::

    # graftcheck: pure-policy

and every opted-in module is then denied, anywhere in the file:

- **imports** of impure modules (``time``, ``random``, ``secrets``,
  ``socket``, ``select``, ``threading``, ``subprocess``, ``asyncio``,
  ``http``, ``urllib``, ``os``, ``datetime``) — time must arrive as a
  ``now`` argument, randomness pre-drawn by the caller;
- **calls** into those modules however aliased (``import time as t`` /
  ``from time import monotonic`` are caught at the import), plus bare
  ``open``/``input``/``print``/``eval``/``exec`` and any ``*.sleep(...)``
  — no files, no terminals, no blocking.

Suppression follows the standard graftcheck syntax (trailing
``# graftcheck: disable=GC-S501`` / file-level ``disable-file=``), and
``tests/test_analysis.py`` gates the repo: the real policy module must
lint clean, and planted defects in both directions (an impurity that must
be flagged, clean code that must not be) pin the analyzer itself.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from .ast_lint import iter_py_files
from .findings import Finding, filter_suppressed

__all__ = ["PURE_POLICY_MARKER", "lint_source", "lint_file", "lint_paths"]

PURE_POLICY_MARKER = "graftcheck: pure-policy"

#: modules whose very import means wall-clock, randomness, blocking, or
#: I/O is reachable from policy code
IMPURE_MODULES: Set[str] = {
    "time", "random", "secrets", "socket", "select", "threading",
    "subprocess", "asyncio", "http", "urllib", "os", "datetime",
}

#: bare builtins that do I/O or execute dynamic code
IMPURE_BUILTINS: Set[str] = {"open", "input", "print", "eval", "exec"}


def _is_marked(source: str) -> bool:
    head = source.splitlines()[:10]
    return any(PURE_POLICY_MARKER in line for line in head)


class _PurityVisitor(ast.NodeVisitor):
    def __init__(self, path: Optional[str]):
        self.path = path
        self.findings: List[Finding] = []
        # names bound (by import) to impure modules or their members,
        # so aliased calls are caught too
        self.tainted: Set[str] = set()

    def _hit(self, node: ast.AST, what: str) -> None:
        self.findings.append(Finding(
            "GC-S501", f"{what} in a pure-policy module — policies take "
            f"time as a `now` argument and pre-drawn randomness, never "
            f"the impure source itself", path=self.path,
            line=getattr(node, "lineno", None), source="policy_lint"))

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            root = alias.name.split(".")[0]
            if root in IMPURE_MODULES:
                self._hit(node, f"import of impure module "
                                f"'{alias.name}'")
                self.tainted.add(alias.asname or root)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        root = (node.module or "").split(".")[0]
        if node.level == 0 and root in IMPURE_MODULES:
            names = ", ".join(a.name for a in node.names)
            self._hit(node, f"import from impure module '{node.module}' "
                            f"({names})")
            for a in node.names:
                self.tainted.add(a.asname or a.name)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Name):
            if fn.id in IMPURE_BUILTINS:
                self._hit(node, f"call to '{fn.id}()'")
            elif fn.id in self.tainted:
                self._hit(node, f"call to '{fn.id}()' (imported from an "
                                f"impure module)")
        elif isinstance(fn, ast.Attribute):
            base = fn.value
            if isinstance(base, ast.Name) and (base.id in IMPURE_MODULES
                                               or base.id in self.tainted):
                self._hit(node, f"call to '{base.id}.{fn.attr}()'")
            elif fn.attr == "sleep":
                self._hit(node, "call to a '.sleep()' method")
        self.generic_visit(node)


def lint_source(source: str, path: Optional[str] = None) -> List[Finding]:
    """Lint one module's source; returns [] unless it carries the
    pure-policy marker."""
    if not _is_marked(source):
        return []
    try:
        tree = ast.parse(source, filename=path or "<policy>")
    except SyntaxError:
        return []   # the interpreter's problem, not this lint's
    visitor = _PurityVisitor(path)
    visitor.visit(tree)
    visitor.findings.sort(key=lambda f: (f.line or 0, f.message))
    return filter_suppressed(visitor.findings, source)


def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(lint_file(f))
    return findings
