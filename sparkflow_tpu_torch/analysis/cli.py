"""graftcheck CLI: ``python -m sparkflow_tpu_torch.analysis [paths...]``.

Runs the static passes (ast_lint + per-class lock coverage + the
whole-package lock-order/blocking graph) over every ``.py`` file under the
given paths, plus — unless ``--no-trace`` — the torch-trace self-check
(:mod:`.fx_lint`) over the port's model presets and optimizer registry.
The port's copy of the JAX package's CLI: the same passes, options,
baseline and exit codes. Exit status is the finding count clamped to 1,
so CI can gate on it; ``--format json`` emits one finding object per
line (JSONL) for tooling.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import List, Optional, Sequence

from . import ast_lint, lifecycle, lockgraph, locks, policy_lint, tracelint
from .findings import RULES, Finding, format_findings

__all__ = ["main", "run_static", "run_all", "load_baseline",
           "apply_baseline"]


def run_static(paths: Sequence[str]) -> List[Finding]:
    """ast_lint + per-class lock coverage + the whole-package lock graph
    (deadlock/blocking-under-lock) + pure-policy purity + resource
    lifecycles + trace-propagation over every .py under ``paths``."""
    return (ast_lint.lint_paths(paths) + locks.lint_paths(paths)
            + lockgraph.lint_paths(paths) + policy_lint.lint_paths(paths)
            + lifecycle.lint_paths(paths) + tracelint.lint_paths(paths))


def _baseline_key(d: dict) -> tuple:
    # line numbers shift on every edit; (rule, path, message) is what makes
    # a finding "the same one we already accepted" — and messages that
    # quote a line themselves ("acquire() at line 13 ...") get that
    # reference masked so an unrelated edit above doesn't unaccept them
    msg = re.sub(r"\bline \d+", "line ?", str(d.get("message", "")))
    return (d.get("rule"), d.get("path"), msg)


def load_baseline(path: str) -> set:
    """Accepted-finding keys from a JSONL baseline written by
    ``--write-baseline`` (or any ``--format json`` capture)."""
    keys = set()
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                keys.add(_baseline_key(json.loads(line)))
    return keys


def apply_baseline(findings: Sequence[Finding], path: str) -> List[Finding]:
    """Drop findings whose (rule, path, message) already appear in the
    baseline file — known-accepted debt stays out of the exit status while
    anything new still fails the gate."""
    keys = load_baseline(path)
    return [f for f in findings if _baseline_key(f.to_dict()) not in keys]


def run_all(paths: Sequence[str], trace: bool = True,
            ignore: Sequence[str] = ()) -> List[Finding]:
    """The full graftcheck pass: static rules over ``paths`` and, with
    ``trace``, the fx repo self-check (model presets x optimizers)."""
    ignore = set(ignore)
    findings = [f for f in run_static(paths) if f.rule not in ignore]
    if trace:
        from . import fx_lint
        findings.extend(fx_lint.repo_self_check(ignore=ignore))
    return findings


def _list_rules() -> str:
    lines = ["graftcheck rule catalog (docs/analysis.md has the long form):"]
    for rule_id in sorted(RULES):
        name, desc = RULES[rule_id]
        lines.append(f"  {rule_id}  {name:<24} {desc}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sparkflow_tpu_torch.analysis",
        description="graftcheck: sharding / tracing / concurrency lint "
                    "for sparkflow-tpu's PyTorch port")
    parser.add_argument("paths", nargs="*", default=["sparkflow_tpu_torch"],
                        help="files or directories to lint "
                             "(default: sparkflow_tpu_torch)")
    parser.add_argument("--no-trace", action="store_true",
                        help="skip the fx self-check over the port's "
                             "model presets and optimizer registry")
    parser.add_argument("--ignore", default="",
                        help="comma-separated rule ids to drop "
                             "(e.g. GC-A203,GC-L302)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("--baseline", default=None, metavar="FILE",
                        help="JSONL of known-accepted findings (from "
                             "--write-baseline): exact matches are "
                             "suppressed, new findings still fail")
    parser.add_argument("--write-baseline", default=None, metavar="FILE",
                        help="write the current findings to FILE as JSONL "
                             "and exit 0 — the accepted-debt snapshot a "
                             "later --baseline run diffs against")
    args = parser.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0

    ignore = [r.strip() for r in args.ignore.split(",") if r.strip()]
    findings = run_all(args.paths, trace=not args.no_trace, ignore=ignore)

    if args.write_baseline:
        with open(args.write_baseline, "w", encoding="utf-8") as fh:
            for f in findings:
                fh.write(json.dumps(f.to_dict(), sort_keys=True) + "\n")
        print(f"graftcheck: wrote {len(findings)} finding(s) to "
              f"{args.write_baseline}")
        return 0
    if args.baseline:
        findings = apply_baseline(findings, args.baseline)

    if args.format == "json":
        # JSONL: one finding object per line, so editors/CI can stream-parse
        # (and `grep GC-L304 | head -1 | jq` just works); clean run = no output
        for f in findings:
            print(json.dumps(f.to_dict(), sort_keys=True))
    elif findings:
        print(format_findings(findings))
        print(f"\ngraftcheck: {len(findings)} finding(s)")
    else:
        print("graftcheck: clean")
    return 1 if findings else 0
