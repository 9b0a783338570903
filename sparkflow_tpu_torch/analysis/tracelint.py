"""GC-T701 untraced-dispatch: trace-propagation lint for dispatch sites.

Distributed traces only assemble if every cross-process hop forwards the
``traceparent`` context. A hop that drops it does not fail loudly — the
request still works, the replica still answers — but its spans mint a
fresh trace id and silently fall off the request's timeline, which is
exactly the blind spot tracing exists to close. This analyzer makes the
propagation contract mechanical instead of reviewed-by-eyeball.

A dispatch site opts in with a marker comment, either trailing on the
call line or on its own line immediately above the call::

    # graftcheck: dispatch-site
    status, hdrs, data = self._call_replica(replica, body, headers)

Every registered site is then required to show evidence of propagation,
in either of two places:

- the **enclosing function** references the traceparent header — any
  identifier (name, attribute, argument) containing ``traceparent``, or
  the ``"traceparent"`` string literal itself; or
- the **call itself** carries trace context — an argument or keyword
  whose name mentions ``trace`` (``traceparent=ctx``, ``trace_id=tid``,
  a ``trace_headers`` variable, ...).

A marker with no call on its own or the following line is also flagged:
stale markers rot into false confidence that a site is covered.

Suppression follows the standard graftcheck syntax (trailing
``# graftcheck: disable=GC-T701`` / file-level ``disable-file=``), and
the rule runs in the full static pass (``make lint-graft-strict``), which
the repo itself must keep clean.
"""

from __future__ import annotations

import ast
import io
import tokenize
from typing import Iterable, List, Optional, Tuple

from .ast_lint import iter_py_files
from .findings import Finding, filter_suppressed

__all__ = ["DISPATCH_MARKER", "lint_source", "lint_file", "lint_paths"]

DISPATCH_MARKER = "graftcheck: dispatch-site"

#: evidence tokens, compared case-insensitively against identifiers
_HEADER_TOKEN = "traceparent"
_ARG_TOKEN = "trace"


def _identifiers(node: ast.AST) -> Iterable[str]:
    """Every identifier-ish string in a subtree: names, attributes,
    function arguments, keyword names, and string constants."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            yield sub.id
        elif isinstance(sub, ast.Attribute):
            yield sub.attr
        elif isinstance(sub, ast.arg):
            yield sub.arg
        elif isinstance(sub, ast.keyword) and sub.arg is not None:
            yield sub.arg
        elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            yield sub.value


def _mentions(node: ast.AST, token: str) -> bool:
    return any(token in ident.lower() for ident in _identifiers(node))


def _call_carries_trace(call: ast.Call) -> bool:
    for part in list(call.args) + list(call.keywords):
        if _mentions(part, _ARG_TOKEN):
            return True
    return False


class _CallIndex(ast.NodeVisitor):
    """Every Call node paired with its innermost enclosing function (or
    the module node for top-level calls)."""

    def __init__(self, tree: ast.Module):
        self.calls: List[Tuple[ast.Call, ast.AST]] = []
        self._scope: List[ast.AST] = [tree]
        self.visit(tree)

    def _enter(self, node: ast.AST) -> None:
        self._scope.append(node)
        self.generic_visit(node)
        self._scope.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._enter(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._enter(node)

    def visit_Call(self, node: ast.Call) -> None:
        self.calls.append((node, self._scope[-1]))
        self.generic_visit(node)


def lint_source(source: str, path: Optional[str] = None) -> List[Finding]:
    """Lint one module's source; returns [] unless it registers dispatch
    sites with the marker."""
    # tokenize, not a line scan: the marker only registers in real
    # comments, never in docstrings or string literals that merely talk
    # about it (this module's own docs would otherwise self-flag)
    marked: List[int] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if (tok.type == tokenize.COMMENT
                    and DISPATCH_MARKER in tok.string):
                marked.append(tok.start[0])
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return []   # the interpreter's problem, not this lint's
    if not marked:
        return []
    try:
        tree = ast.parse(source, filename=path or "<tracelint>")
    except SyntaxError:
        return []   # the interpreter's problem, not this lint's
    index = _CallIndex(tree)
    findings: List[Finding] = []
    for mline in marked:
        # trailing marker: call on the marker line; own-line marker: call
        # on the next line. Outermost call wins (smallest column).
        site = None
        for target in (mline, mline + 1):
            on_line = [(c, scope) for c, scope in index.calls
                       if c.lineno == target]
            if on_line:
                site = min(on_line, key=lambda cs: cs[0].col_offset)
                break
        if site is None:
            findings.append(Finding(
                "GC-T701", "dispatch-site marker with no call on this or "
                "the following line — the marker has rotted away from the "
                "code it was meant to register", path=path, line=mline,
                source="tracelint"))
            continue
        call, scope = site
        if _mentions(scope, _HEADER_TOKEN) or _call_carries_trace(call):
            continue
        findings.append(Finding(
            "GC-T701", "registered dispatch site sends a request without "
            "propagating trace context — the enclosing function never "
            "touches the traceparent header and no call argument carries "
            "trace context, so downstream spans mint a fresh trace and "
            "fall off this request's timeline", path=path,
            line=call.lineno, source="tracelint"))
    findings.sort(key=lambda f: (f.line or 0, f.message))
    return filter_suppressed(findings, source)


def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(lint_file(f))
    return findings
