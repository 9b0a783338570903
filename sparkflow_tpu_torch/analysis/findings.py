"""Finding/rule plumbing shared by every graftcheck analyzer.

A *finding* is one (rule, location, message) triple; analyzers return lists
of them and never print or raise — rendering and exit codes are the CLI's
job, so the library API stays embeddable (tests assert on findings directly).

Rule IDs are stable and documented in ``docs/analysis.md``; suppression is
per-line (``# graftcheck: disable=GC-A201`` — trailing comment on the
flagged line) or per-file (``# graftcheck: disable-file=GC-A201,GC-L302``
anywhere in the first ten lines). Static analyzers resolve suppressions
against the scanned source; trace-level analyzers (jaxpr/runtime) have no
source line to hang a comment on and instead take ``ignore=`` rule sets.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Finding", "RULES", "filter_suppressed", "format_findings",
           "parse_suppressions"]


#: rule id -> (short name, one-line description). The single source of truth
#: for what graftcheck checks; docs/analysis.md renders this catalog.
RULES: Dict[str, Tuple[str, str]] = {
    # jaxpr_lint (GC-J1xx): abstract-trace analysis against a mesh
    "GC-J101": ("implicit-reshard",
                "a sharding constraint silently reshards a tensor away from "
                "its declared PartitionSpec (an all-to-all on the hot path)"),
    "GC-J102": ("large-replicated",
                "a large tensor is replicated on a multi-device mesh where "
                "a sharded PartitionSpec would cut per-device memory"),
    "GC-J103": ("f64-promotion",
                "a float32 program produces float64 intermediates under "
                "x64 tracing — a Python/numpy scalar promotes the hot path"),
    "GC-J104": ("weak-type-output",
                "a traced output is weakly typed: a bare Python scalar "
                "dominates the result and its dtype depends on callers"),
    "GC-J105": ("missed-donation",
                "an input buffer matches the outputs aval-for-aval but is "
                "not donated — XLA must double-buffer it"),
    "GC-J106": ("sharding-config-mismatch",
                "the collectives observed in a train step's jaxpr "
                "contradict its declared ShardingConfig (e.g. zero_stage>=1 "
                "with no reduce_scatter in the gradient path)"),
    # ast_lint (GC-A2xx): source rules over jit'd/traced functions
    "GC-A201": ("host-sync-in-jit",
                "a host-synchronizing call (.item()/float()/np.asarray/"
                "print) inside a traced function"),
    "GC-A202": ("traced-branch",
                "Python if/while on a traced argument — data-dependent "
                "control flow fails or silently bakes in one branch"),
    "GC-A203": ("prng-key-reuse",
                "the same PRNG key is consumed by two sampling calls "
                "without an intervening split"),
    "GC-A204": ("unhashable-static",
                "an argument marked static for jit defaults to an "
                "unhashable value (list/dict/set) — every call fails "
                "or retraces"),
    # lock coverage (GC-L3xx): shared-state rules over lock-owning classes
    "GC-L301": ("unlocked-guarded-write",
                "an attribute that is written under this class's lock "
                "elsewhere is written without it here"),
    "GC-L302": ("unlocked-rmw",
                "a read-modify-write (+=, -=, ...) on shared state in a "
                "lock-owning class runs outside any lock"),
    "GC-L303": ("unlocked-call-to-locked-helper",
                "a *_locked method (caller-holds-the-lock convention) is "
                "called outside any lock block"),
    # lock graph (GC-L30x, whole-package): cross-module ordering rules
    "GC-L304": ("lock-order-cycle",
                "two locks are acquired in opposite orders on different "
                "code paths (possibly across modules) — two threads "
                "interleaving those paths deadlock"),
    "GC-L305": ("blocking-under-lock",
                "a blocking operation (sleep, socket/HTTP I/O, "
                "Future.result, thread join, block_until_ready) runs while "
                "a lock is held — every other thread needing that lock "
                "stalls for the full wait"),
    # runtime guards (GC-R4xx)
    "GC-R401": ("excess-retrace",
                "a guarded function retraced beyond its budget; the "
                "signature diff names the argument that changed"),
    "GC-R402": ("empty-lockset-race",
                "a shared field was accessed from multiple threads with no "
                "common lock held across all accesses (Eraser lockset "
                "discipline violated) — a data race, not just a hazard"),
    # jaxpr lint (continued)
    "GC-J107": ("collective-divergence",
                "a collective (psum/all_gather/...) nested under a "
                "data-dependent cond/while — if devices disagree on the "
                "predicate, some enter the collective and some don't, and "
                "the mesh hangs"),
    # policy purity (GC-S5xx): modules marked `# graftcheck: pure-policy`
    "GC-S501": ("impure-policy",
                "wall-clock, randomness, sleeping, or socket/file I/O "
                "inside a module marked pure-policy — the simulator "
                "replays these decisions in virtual time, so any impurity "
                "silently forks sim behavior from production"),
    "GC-J108": ("full-pool-dequant",
                "a convert_element_type widens the entire quantized KV page "
                "pool to float before the page gather — a full-precision "
                "transient copy of the whole cache that forfeits the memory "
                "quantization bought; dequantize the gathered pages instead"),
    # resource lifecycles (GC-X6xx): acquire/release pairing over the
    # declarative registry in analysis/lifecycle.py
    "GC-X601": ("leak-on-escape",
                "a registered acquire (pool checkout, KV slot, tempdir) is "
                "followed by an escaping path — early return, raise, break — "
                "with no matching release, try/finally, or context manager "
                "before it; that path leaks the resource"),
    "GC-X602": ("release-skipped-on-error",
                "code between a registered acquire and its release can "
                "raise, and the release is not reachable from that error "
                "branch (no try/finally or except-all that releases) — an "
                "exception leaks the resource"),
    "GC-X603": ("unreaped-thread",
                "a started thread or spawned subprocess has no join/stop/"
                "wait/reap on any path in its owning scope — shutdown "
                "abandons it mid-flight"),
    "GC-X604": ("gauge-namespace-leak",
                "a class publishes metrics under a dynamic (per-entity) "
                "namespace but no stop/close/deregister path removes them "
                "— the exposition advertises ghost entities forever"),
    "GC-X605": ("unbalanced-resource",
                "the runtime ResourceTracker saw more acquires than "
                "releases (or a double release) for a tracked resource by "
                "the end of the run — acquisition stacks in detail"),
    # tracelint (GC-T7xx): distributed-tracing propagation
    "GC-T701": ("untraced-dispatch",
                "a registered cross-process dispatch site (marked "
                "`# graftcheck: dispatch-site`) sends a request without "
                "propagating trace context — no traceparent header "
                "reference in the enclosing function and no trace-carrying "
                "argument at the call, so the callee's spans fall off the "
                "request's timeline"),
}


@dataclass
class Finding:
    """One analyzer hit. ``path``/``line`` are None for trace-level findings
    (they point at a traced callable, not a source location)."""

    rule: str
    message: str
    path: Optional[str] = None
    line: Optional[int] = None
    source: str = "graftcheck"  # which analyzer produced it
    detail: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown rule id {self.rule!r}; known: "
                             f"{sorted(RULES)}")

    @property
    def name(self) -> str:
        return RULES[self.rule][0]

    def location(self) -> str:
        if self.path is None:
            return self.source
        return f"{self.path}:{self.line}" if self.line else self.path

    def render(self) -> str:
        return f"{self.location()}: {self.rule} ({self.name}): {self.message}"

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "name": self.name, "path": self.path,
                "line": self.line, "source": self.source,
                "message": self.message, **({"detail": self.detail}
                                            if self.detail else {})}


_SUPPRESS_RE = re.compile(r"#\s*graftcheck:\s*disable(-file)?\s*=\s*"
                          r"([A-Za-z0-9_,\-\s]+)")


def parse_suppressions(source: str) -> Tuple[set, Dict[int, set]]:
    """(file-wide rule set, {line -> rule set}) from suppression comments.
    ``disable-file`` is honored only in the first ten lines so a stray
    comment deep in a module can't silently blind the whole file."""
    file_wide: set = set()
    per_line: Dict[int, set] = {}
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
        if m.group(1):  # disable-file
            if lineno <= 10:
                file_wide |= rules
        else:
            per_line.setdefault(lineno, set()).update(rules)
    return file_wide, per_line


def filter_suppressed(findings: Sequence[Finding], source: str
                      ) -> List[Finding]:
    """Drop findings a suppression comment covers (matched on rule id and
    the finding's line)."""
    file_wide, per_line = parse_suppressions(source)
    out = []
    for f in findings:
        if f.rule in file_wide:
            continue
        if f.line is not None and f.rule in per_line.get(f.line, ()):
            continue
        out.append(f)
    return out


def format_findings(findings: Sequence[Finding]) -> str:
    return "\n".join(f.render() for f in findings)
