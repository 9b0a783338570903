"""The dynamic half of the JAX package's ``analysis`` (graftcheck): the
finding records (:mod:`.findings`) and the Eraser-style lockset race
detector (:mod:`.racecheck`, GC-R402), which the elastic engine puts the
parameter store under when a :class:`~.racecheck.RaceTracker` is installed.

Both modules are copies of the JAX package's, which import no JAX. The
static and trace passes (``jaxpr_lint``, ``ast_lint``, ``locks``,
``lockgraph``, ``runtime_guards``, ``lifecycle``, ``restrack``) are not
ported (see ROADMAP.md); this package imports nothing that pulls them in.
"""

from __future__ import annotations

from . import racecheck
from .findings import RULES, Finding, format_findings

__all__ = ["Finding", "RULES", "format_findings", "racecheck"]
