"""What the port's examples share: the command line, the output directory,
the fit's loss record and the session."""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, List, Optional

from ..compat import USING_PYSPARK
from ..device import resolve_device


def parser(doc: str) -> argparse.ArgumentParser:
    """``--device`` (the card unless ``cpu``), ``--smoke`` and
    ``--workdir``; an example adds its own size options."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default: the card, else an error) or "
                        "'cpu'")
    p.add_argument("--smoke", action="store_true",
                   help="the small sizes of the JAX example's smoke mode")
    p.add_argument("--workdir", default=None,
                   help="directory for saved pipelines and artifacts "
                        "(default: a new temporary directory)")
    return p


def check_device(device) -> str:
    """The device name an example hands to the port: the card unless
    ``device`` is the CPU. Raises without a card, before any work."""
    return str(resolve_device(device))


def workdir(path: Optional[str]) -> str:
    """``path`` (created if missing), or a new temporary directory."""
    if path is None:
        return tempfile.mkdtemp(prefix="sparkflow_example_")
    os.makedirs(path, exist_ok=True)
    return path


def session(app: str):
    """A SparkSession under pyspark, else the local engine's."""
    if USING_PYSPARK:
        from pyspark.sql import SparkSession
        return (SparkSession.builder.appName(app).master("local[4]")
                .getOrCreate())
    from ..localml import LocalSession
    return LocalSession.builder.appName(app).getOrCreate()


class LossLog:
    """An estimator's ``setLossCallback`` target: each iteration's mean
    loss, in order."""

    def __init__(self):
        self.losses: List[float] = []

    def __call__(self, loss, iteration, partition_id):
        self.losses.append(float(loss))


def timed(fn: Callable):
    """``(fn(), seconds)`` on the host clock; the port's fits and
    transforms read their results back, so the card's work is inside."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def fit_rate(rows: int, iters: int, seconds: float) -> float:
    """Dataset rows times iterations over the fit's wall seconds."""
    return rows * iters / seconds if seconds > 0 else float("nan")
