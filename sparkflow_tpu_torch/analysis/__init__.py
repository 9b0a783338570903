"""graftcheck for the PyTorch port: static and trace analysis for tracing,
concurrency and resource correctness, behind one CLI
(``python -m sparkflow_tpu_torch.analysis``) and this library API.

- :mod:`~sparkflow_tpu_torch.analysis.fx_lint` — traces a model or train
  step with ``make_fx`` over fake tensors on the CPU (nothing computes)
  and reads the aten graph: float64 promotion (GC-J103), collectives that
  disagree with the zero stage (GC-J106), a dequantization of the whole
  KV page pool (GC-J108). The counterpart of the JAX package's
  ``jaxpr_lint``.
- :mod:`~sparkflow_tpu_torch.analysis.ast_lint` +
  :mod:`~sparkflow_tpu_torch.analysis.locks` — source rules, no imports of
  the scanned code: host syncs and Python branching inside jit'd
  functions, PRNG key reuse, unhashable static args, and shared-state
  mutation outside the owning class's lock.
- :mod:`~sparkflow_tpu_torch.analysis.lockgraph` — the whole-package
  concurrency pass: one cross-module lock-acquisition graph, reporting
  lock-order cycles (GC-L304) and blocking calls under a held lock
  (GC-L305).
- :mod:`~sparkflow_tpu_torch.analysis.policy_lint` — modules marked
  ``# graftcheck: pure-policy`` stay free of clocks, randomness and I/O
  (GC-S501).
- :mod:`~sparkflow_tpu_torch.analysis.tracelint` — request-id
  propagation across the serving hops.
- :mod:`~sparkflow_tpu_torch.analysis.runtime_guards` —
  :class:`RecompileGuard` / :func:`track_recompiles`: count the distinct
  argument signatures a step or bucket function runs with and name which
  argument's shape, dtype or device changed (GC-R401).
- :mod:`~sparkflow_tpu_torch.analysis.racecheck` — an Eraser-style
  dynamic lockset race detector (GC-R402) for tests and chaos runs,
  enabled by ``SPARKFLOW_TPU_RACECHECK=1`` and free when off; the elastic
  engine puts its parameter store under it.
- :mod:`~sparkflow_tpu_torch.analysis.lifecycle` +
  :mod:`~sparkflow_tpu_torch.analysis.restrack` — resource lifecycles,
  both directions: a static acquire/release pairing lint (leaks on
  escape/error, unreaped threads, gauge namespaces with no cleanup —
  GC-X601..X604) and its runtime twin, a per-resource balance tracker
  (GC-X605), enabled by ``SPARKFLOW_TPU_RESTRACK=1``.

The static modules, ``findings`` and ``racecheck`` are the JAX package's
files byte for byte (they import neither JAX nor the scanned code);
``cli``, ``runtime_guards`` and ``fx_lint`` are the port's own. The port
keeps itself clean under the full pass: ``tests/test_torch_analysis.py``
runs it over ``sparkflow_tpu_torch/``, ``chip_smoke.py`` and
``tests/torch_rank_tasks.py`` and asserts zero findings.
"""

from __future__ import annotations

from .findings import Finding, RULES, format_findings
from .runtime_guards import (RecompileGuard, describe_signature_diff,
                             trace_probe, track_recompiles)

__all__ = [
    "Finding", "RULES", "format_findings",
    "RecompileGuard", "track_recompiles", "trace_probe",
    "describe_signature_diff",
    "run_static", "run_all",
    "lint_fn", "lint_train_step", "lint_apply", "lint_decode_step",
    "ast_lint", "locks", "lockgraph", "fx_lint", "racecheck",
    "runtime_guards", "lifecycle", "restrack", "policy_lint", "tracelint",
]


def __getattr__(name):
    # lazy: fx_lint pulls in models/optimizers; the static passes and the
    # CLI must stay usable without importing any of that until needed
    import importlib
    if name in ("lint_fn", "lint_train_step", "lint_apply",
                "lint_decode_step"):
        return getattr(importlib.import_module(".fx_lint", __name__), name)
    if name in ("run_static", "run_all"):
        return getattr(importlib.import_module(".cli", __name__), name)
    if name in ("ast_lint", "locks", "lockgraph", "fx_lint", "racecheck",
                "runtime_guards", "lifecycle", "restrack", "policy_lint",
                "tracelint"):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
