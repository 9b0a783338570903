"""AST rules for JAX footguns (GC-A2xx) over repo and user source.

Purely syntactic — scanned files are parsed, never imported, so linting
``examples/`` doesn't need pyspark and linting a broken module doesn't
crash the pass. The flip side is that detection is *best effort*: a
function is treated as traced when the tracing is visible in the same
module (a ``@jax.jit``-style decorator, or its name passed to
``jax.jit`` / ``jax.lax.scan`` / ``shard_map`` / ... in an enclosing
scope); functions returned from factories and jitted by a *different*
module are invisible to this pass — the jaxpr/runtime analyzers cover
those.

Rules
-----
GC-A201  host-sync-in-jit   ``.item()``/``.tolist()``/``.numpy()``/
                            ``.block_until_ready()``, ``print``, and
                            ``float()/int()/bool()/np.asarray()`` applied to
                            a traced argument, inside a traced function.
GC-A202  traced-branch      Python ``if``/``while`` testing a traced
                            argument (``is None`` structure checks exempt).
GC-A203  prng-key-reuse     the same key name consumed by two sampling
                            calls with no intervening rebind (branch-aware;
                            applies to every function, traced or not).
GC-A204  unhashable-static  a jit-static argument whose default is a
                            list/dict/set — unhashable at cache-key time.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .findings import Finding, filter_suppressed

__all__ = ["lint_source", "lint_file", "lint_paths", "iter_py_files"]


# decorator / callee names (last attribute component) that trace the
# function they're applied to, mapped to which argument positions are traced
_TRACING_DECORATORS = {"jit", "pmap", "vmap", "grad", "value_and_grad",
                       "checkpoint", "remat", "filter_jit"}
_TRACING_CALLS: Dict[str, Tuple[int, ...]] = {
    "jit": (0,), "pmap": (0,), "vmap": (0,), "grad": (0,),
    "value_and_grad": (0,), "checkpoint": (0,), "remat": (0,),
    "make_jaxpr": (0,), "eval_shape": (0,), "named_call": (0,),
    "scan": (0,), "associative_scan": (0,), "map": (0,),  # lax.map only

    "while_loop": (0, 1), "fori_loop": (2,), "cond": (1, 2),
    "switch": (1, 2, 3, 4), "shard_map": (0,), "custom_vjp": (0,),
    "custom_jvp": (0,),
}

_HOST_SYNC_METHODS = {"item", "tolist", "numpy", "block_until_ready"}
_HOST_SYNC_CASTS = {"float", "int", "bool"}
_HOST_SYNC_NP = {"asarray", "array", "ascontiguousarray", "copy", "save"}
# numpy-ish module aliases whose .asarray/.array pull data to the host
_NP_ALIASES = {"np", "numpy", "onp"}
# jax.random functions that do NOT consume their key argument
_PRNG_NONCONSUMING = {"split", "fold_in", "PRNGKey", "key", "clone",
                      "key_data", "wrap_key_data", "key_impl",
                      "default_prng_impl"}


def _last_attr(node: ast.AST) -> Optional[str]:
    """Final dotted component of a Name/Attribute chain, else None."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _attr_chain(node: ast.AST) -> List[str]:
    """['jax', 'random', 'normal'] for jax.random.normal; [] if not a
    plain dotted chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


def _is_prng_call(call: ast.Call) -> Optional[str]:
    """The jax.random function name if ``call`` looks like one, else None.
    Matches ``jax.random.X`` / ``jrandom.X`` / ``random.X`` chains — the
    penultimate component must mention 'random'."""
    chain = _attr_chain(call.func)
    if len(chain) >= 2 and "random" in chain[-2].lower():
        return chain[-1]
    return None


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _walk_shallow(fn: ast.AST):
    """Walk ``fn``'s body without descending into nested function defs —
    those are linted separately against their own parameter sets."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


class _FnInfo:
    __slots__ = ("node", "scope", "traced", "reason")

    def __init__(self, node, scope):
        self.node = node
        self.scope = scope  # enclosing Module/FunctionDef/ClassDef node
        self.traced = False
        self.reason = ""


class _Index(ast.NodeVisitor):
    """One pass over the module: function defs per scope + which local
    names are handed to tracing transforms in which scope."""

    def __init__(self, tree: ast.Module):
        self.fns: Dict[ast.AST, _FnInfo] = {}
        self._by_scope: Dict[int, Dict[str, ast.AST]] = {}
        self._assigned: Dict[int, Set[str]] = {}
        self._scope_stack: List[ast.AST] = [tree]
        self._register_block(tree, tree.body)
        self._collect_assigned(tree, tree)
        for stmt in tree.body:
            self.visit(stmt)

    def _register_block(self, scope: ast.AST, body: Sequence[ast.stmt]):
        table = self._by_scope.setdefault(id(scope), {})
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                table[stmt.name] = stmt
                self.fns[stmt] = _FnInfo(stmt, scope)

    def _collect_assigned(self, scope: ast.AST, root: ast.AST) -> None:
        """Names bound by plain assignment in this scope: they shadow any
        same-named def during resolution (the binding is opaque to us)."""
        assigned = self._assigned.setdefault(id(scope), set())
        for node in _walk_shallow(root):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                targets = [node.target]
            elif isinstance(node, ast.withitem) and node.optional_vars:
                targets = [node.optional_vars]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        assigned.add(n.id)

    def _resolve(self, name: str) -> Optional[ast.AST]:
        for scope in reversed(self._scope_stack):
            if isinstance(scope, ast.ClassDef):
                continue  # class bodies aren't enclosing scopes in Python
            hit = self._by_scope.get(id(scope), {}).get(name)
            if hit is not None:
                return hit
            if name in self._assigned.get(id(scope), ()):
                return None  # shadowed by a non-def binding we can't follow
        return None

    def _mark(self, fn_node: Optional[ast.AST], reason: str):
        info = self.fns.get(fn_node)
        if info is not None and not info.traced:
            info.traced = True
            info.reason = reason

    def visit_ClassDef(self, node: ast.ClassDef):
        self._scope_stack.append(node)
        self._register_block(node, node.body)
        for stmt in node.body:
            self.visit(stmt)
        self._scope_stack.pop()

    def _visit_fn(self, node):
        # defs nested inside if/try/with blocks weren't seen by the
        # enclosing block's pre-pass — register them into the current scope
        if node not in self.fns:
            scope = self._scope_stack[-1]
            self.fns[node] = _FnInfo(node, scope)
            self._by_scope.setdefault(id(scope), {})[node.name] = node
        for dec in node.decorator_list:
            name = _last_attr(dec)
            if isinstance(dec, ast.Call):
                fname = _last_attr(dec.func)
                if fname in _TRACING_DECORATORS:
                    self._mark(node, f"@{fname}(...)")
                elif fname == "partial" and dec.args:
                    inner = _last_attr(dec.args[0])
                    if inner in _TRACING_DECORATORS:
                        self._mark(node, f"@partial({inner}, ...)")
            elif name in _TRACING_DECORATORS:
                self._mark(node, f"@{name}")
        self._scope_stack.append(node)
        self._register_block(node, node.body)
        self._collect_assigned(node, node)
        for stmt in node.body:
            self.visit(stmt)
        self._scope_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Call(self, node: ast.Call):
        fname = _last_attr(node.func)
        positions = _TRACING_CALLS.get(fname or "")
        if fname == "map":
            # lax.map traces its callback; jax.tree.map / tree_map do not
            chain = _attr_chain(node.func)
            if len(chain) < 2 or chain[-2] != "lax":
                positions = None
        if positions:
            for pos in positions:
                if pos < len(node.args) and isinstance(node.args[pos],
                                                       ast.Name):
                    self._mark(self._resolve(node.args[pos].id),
                               f"passed to {fname}()")
        self.generic_visit(node)


def _propagate_nested(index: _Index) -> None:
    """A def nested in a traced function runs at trace time too."""
    changed = True
    while changed:
        changed = False
        for info in index.fns.values():
            if info.traced:
                continue
            parent = index.fns.get(info.scope)
            if parent is not None and parent.traced:
                info.traced = True
                info.reason = f"nested in traced {parent.node.name}()"
                changed = True


def _param_names(fn: ast.AST) -> Set[str]:
    a = fn.args
    names = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return {n for n in names if n not in ("self", "cls")}


# ---------------------------------------------------------------------------
# GC-A201 / GC-A202: rules inside traced functions
# ---------------------------------------------------------------------------


def _traced_fn_findings(fn: ast.AST, params: Set[str], path: str
                        ) -> List[Finding]:
    out: List[Finding] = []
    fname = fn.name

    def mentions_param(expr: ast.AST) -> bool:
        return bool(_names_in(expr) & params)

    for node in _walk_shallow(fn):
        if isinstance(node, ast.Call):
            callee = node.func
            if isinstance(callee, ast.Attribute) \
                    and callee.attr in _HOST_SYNC_METHODS:
                out.append(Finding(
                    "GC-A201",
                    f".{callee.attr}() inside traced {fname}() forces a "
                    f"host sync (or fails on a tracer) — keep device "
                    f"values on device",
                    path=path, line=node.lineno, source="ast_lint"))
            elif isinstance(callee, ast.Name) and callee.id == "print":
                out.append(Finding(
                    "GC-A201",
                    f"print() inside traced {fname}() runs at trace time "
                    f"only (and prints tracers) — use jax.debug.print",
                    path=path, line=node.lineno, source="ast_lint"))
            elif isinstance(callee, ast.Name) \
                    and callee.id in _HOST_SYNC_CASTS and node.args \
                    and mentions_param(node.args[0]):
                out.append(Finding(
                    "GC-A201",
                    f"{callee.id}() on a traced value inside {fname}() "
                    f"synchronizes (ConcretizationTypeError under jit)",
                    path=path, line=node.lineno, source="ast_lint"))
            else:
                chain = _attr_chain(callee)
                if (len(chain) >= 2 and chain[0] in _NP_ALIASES
                        and chain[-1] in _HOST_SYNC_NP and node.args
                        and mentions_param(node.args[0])):
                    out.append(Finding(
                        "GC-A201",
                        f"{'.'.join(chain)}() on a traced value inside "
                        f"{fname}() pulls it to the host — use jnp",
                        path=path, line=node.lineno, source="ast_lint"))
        elif isinstance(node, (ast.If, ast.While)):
            test = node.test
            # occurrences that are static under jit: isinstance()/hasattr()/
            # callable()/len() arguments, and .shape/.ndim/.size/.dtype
            # attribute reads — shapes and python types are trace constants
            static_ids: Set[int] = set()
            for sub in ast.walk(test):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Name)
                        and sub.func.id in ("isinstance", "hasattr",
                                            "callable", "len")):
                    for arg in sub.args:
                        static_ids.update(id(n) for n in ast.walk(arg))
                elif (isinstance(sub, ast.Attribute)
                        and sub.attr in ("shape", "ndim", "size", "dtype")):
                    static_ids.update(id(n) for n in ast.walk(sub.value))
            hits = {n.id for n in ast.walk(test)
                    if isinstance(n, ast.Name) and n.id in params
                    and id(n) not in static_ids}
            # `x is None` / `x is not None` checks pytree STRUCTURE, which
            # is static under jit — exempt names used only that way
            for cmp in ast.walk(test):
                if (isinstance(cmp, ast.Compare)
                        and len(cmp.ops) == 1
                        and isinstance(cmp.ops[0], (ast.Is, ast.IsNot))
                        and isinstance(cmp.left, ast.Name)):
                    hits.discard(cmp.left.id)
            if hits:
                kw = "while" if isinstance(node, ast.While) else "if"
                out.append(Finding(
                    "GC-A202",
                    f"`{kw}` on traced argument(s) {sorted(hits)} of "
                    f"{fname}() — data-dependent Python control flow; use "
                    f"jnp.where / lax.cond / lax.while_loop",
                    path=path, line=node.lineno, source="ast_lint"))
    return out


# ---------------------------------------------------------------------------
# GC-A203: PRNG key reuse (branch-aware straight-line scan, every function)
# ---------------------------------------------------------------------------


def _prng_findings(fn: ast.AST, path: str) -> List[Finding]:
    findings: Dict[Tuple[int, str], Finding] = {}

    def consume_in_expr(expr: ast.AST, consumed: Dict[str, int]) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            prng_fn = _is_prng_call(node)
            if prng_fn is None or prng_fn in _PRNG_NONCONSUMING:
                continue
            if node.args and isinstance(node.args[0], ast.Name):
                key = node.args[0].id
                if key in consumed:
                    findings.setdefault((node.lineno, key), Finding(
                        "GC-A203",
                        f"PRNG key {key!r} already consumed by jax.random."
                        f"* at line {consumed[key]} is sampled again in "
                        f"{fn.name}() — split it (identical keys give "
                        f"identical 'randomness')",
                        path=path, line=node.lineno, source="ast_lint"))
                else:
                    consumed[key] = node.lineno

    def clear_targets(target: ast.AST, consumed: Dict[str, int]) -> None:
        for node in ast.walk(target):
            if isinstance(node, ast.Name):
                consumed.pop(node.id, None)

    def scan(stmts: Sequence[ast.stmt], consumed: Dict[str, int]
             ) -> Dict[str, int]:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue  # own scope, scanned separately
            if isinstance(st, ast.Assign):
                consume_in_expr(st.value, consumed)
                for t in st.targets:
                    clear_targets(t, consumed)
            elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
                if st.value is not None:
                    consume_in_expr(st.value, consumed)
                clear_targets(st.target, consumed)
            elif isinstance(st, ast.If):
                consume_in_expr(st.test, consumed)
                left = scan(st.body, dict(consumed))
                right = scan(st.orelse, dict(consumed))
                consumed = dict(consumed)
                # a branch that can't fall through (trailing return/raise/
                # break/continue) never reaches the code after the if — its
                # consumed keys must not leak into the fallthrough path
                def falls_through(stmts):
                    return not (stmts and isinstance(
                        stmts[-1], (ast.Return, ast.Raise, ast.Break,
                                    ast.Continue)))
                branches = [b for b, body in ((left, st.body),
                                              (right, st.orelse))
                            if falls_through(body)]
                for branch in branches:
                    for k, v in branch.items():
                        consumed[k] = min(v, consumed.get(k, v))
            elif isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                if isinstance(st, ast.While):
                    consume_in_expr(st.test, consumed)
                else:
                    consume_in_expr(st.iter, consumed)
                    clear_targets(st.target, consumed)
                # two passes catch loop-carried reuse; rebinds inside the
                # body clear state so rotated keys stay clean
                consumed = scan(st.body, consumed)
                consumed = scan(st.body, consumed)
                consumed = scan(st.orelse, consumed)
            elif isinstance(st, ast.With):
                for item in st.items:
                    consume_in_expr(item.context_expr, consumed)
                consumed = scan(st.body, consumed)
            elif isinstance(st, ast.Try):
                consumed = scan(st.body, dict(consumed))
                for h in st.handlers:
                    consumed.update(scan(h.body, dict(consumed)))
                consumed = scan(st.orelse, consumed)
                consumed = scan(st.finalbody, consumed)
            elif isinstance(st, (ast.Return, ast.Expr)) \
                    and st.value is not None:
                consume_in_expr(st.value, consumed)
            elif isinstance(st, (ast.Raise, ast.Assert)):
                for sub in ast.iter_child_nodes(st):
                    consume_in_expr(sub, consumed)
        return consumed

    scan(fn.body, {})
    return list(findings.values())


# ---------------------------------------------------------------------------
# GC-A204: unhashable static-arg defaults
# ---------------------------------------------------------------------------


def _static_spec_from_call(call: ast.Call):
    nums, names = None, None
    for kw in call.keywords:
        if kw.arg == "static_argnums":
            nums = kw.value
        elif kw.arg == "static_argnames":
            names = kw.value
    return nums, names


def _literal_ints(node: ast.AST) -> List[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, int):
                out.append(e.value)
        return out
    return []


def _literal_strs(node: ast.AST) -> List[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [e.value for e in node.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)]
    return []


def _unhashable_default(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return _last_attr(node.func) in ("list", "dict", "set", "bytearray")
    return False


def _static_default_findings(fn: ast.AST, call: ast.Call, path: str
                             ) -> List[Finding]:
    nums_node, names_node = _static_spec_from_call(call)
    if nums_node is None and names_node is None:
        return []
    a = fn.args
    pos = a.posonlyargs + a.args
    static_params: List[ast.arg] = []
    for i in _literal_ints(nums_node) if nums_node is not None else []:
        if 0 <= i < len(pos):
            static_params.append(pos[i])
    wanted = set(_literal_strs(names_node) if names_node is not None else [])
    for p in pos + a.kwonlyargs:
        if p.arg in wanted:
            static_params.append(p)
    # align defaults: the last len(defaults) positional args have them
    defaults = dict(zip([p.arg for p in pos[len(pos) - len(a.defaults):]],
                        a.defaults))
    defaults.update({p.arg: d for p, d in zip(a.kwonlyargs, a.kw_defaults)
                     if d is not None})
    out = []
    for p in static_params:
        d = defaults.get(p.arg)
        if d is not None and _unhashable_default(d):
            out.append(Finding(
                "GC-A204",
                f"argument {p.arg!r} of {fn.name}() is jit-static but "
                f"defaults to an unhashable {type(d).__name__.lower()} — "
                f"jit's cache key will raise TypeError; use a tuple or "
                f"frozen container",
                path=path, line=fn.lineno, source="ast_lint"))
    return out


def _unhashable_static_findings(tree: ast.Module, index: _Index, path: str
                                ) -> List[Finding]:
    out: List[Finding] = []
    for info in index.fns.values():
        for dec in info.node.decorator_list:
            if isinstance(dec, ast.Call):
                fname = _last_attr(dec.func)
                if fname in ("jit", "filter_jit") or (
                        fname == "partial" and dec.args
                        and _last_attr(dec.args[0]) in ("jit", "filter_jit")):
                    out.extend(_static_default_findings(info.node, dec, path))
    by_name = {info.node.name: info.node for info in index.fns.values()}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and _last_attr(node.func) == "jit"
                and node.args and isinstance(node.args[0], ast.Name)):
            fn = by_name.get(node.args[0].id)
            if fn is not None:
                out.extend(_static_default_findings(fn, node, path))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        # a file the interpreter can't parse is its own problem; report
        # nothing rather than crash the sweep over every other file
        return []
    index = _Index(tree)
    _propagate_nested(index)
    findings: List[Finding] = []
    for info in index.fns.values():
        if info.traced:
            findings.extend(_traced_fn_findings(info.node,
                                                _param_names(info.node),
                                                path))
        findings.extend(_prng_findings(info.node, path))
    findings.extend(_unhashable_static_findings(tree, index, path))
    findings.sort(key=lambda f: (f.line or 0, f.rule))
    return filter_suppressed(findings, source)


def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


def iter_py_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith(".")
                                 and d != "__pycache__")
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
    return out


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(lint_file(f))
    return findings
