"""Streaming training with the native C++ dataplane — the port of the JAX
package's ``examples/streaming_example.py``.

For datasets beyond device memory: rows stream through the C++
batch-assembly ring (padding, masking and shuffling on a thread that holds
no GIL; ``native/dataplane.cpp``, built with ``g++`` at first use) while the
H100 trains. With pyspark, feed ``df.rdd.toLocalIterator()``.

    python -m sparkflow_tpu_torch.examples.streaming_example [--device cpu] [--smoke]
"""

import numpy as np

import sparkflow_tpu_torch.nn as nn
from sparkflow_tpu_torch.examples import _common
from sparkflow_tpu_torch.graph_utils import build_graph
from sparkflow_tpu_torch.trainer import Trainer


def model():
    x = nn.placeholder([None, 128], name="x")
    y = nn.placeholder([None, 1], name="y")
    h = nn.dense(x, 64, activation="relu")
    nn.sigmoid_cross_entropy(y, nn.dense(h, 1, name="out"))


def row_stream(n_rows=20000, dim=128, seed=0):
    """Simulates an out-of-core source: yields one row at a time."""
    rs = np.random.RandomState(seed)
    w = rs.randn(dim)
    for _ in range(n_rows):
        x = rs.randn(dim).astype(np.float32)
        yield x, float(x @ w > 0)


def run(*, device="cuda", smoke=False, workdir=None, rows=None):
    """Stream one pass; returns the per-step ``losses``, ``steps``,
    ``fit_s`` and ``rows_per_s`` (the trainer's examples a second)."""
    device = _common.check_device(device)
    _common.workdir(workdir)
    tr = Trainer(build_graph(model), "x:0", "y:0", mini_batch_size=256,
                 learning_rate=0.05, device=device)
    res, fit_s = _common.timed(lambda: tr.fit_stream(
        row_stream(n_rows=rows or (2000 if smoke else 20000))))
    print(f"steps: {len(res.losses)}  loss {res.losses[0]:.3f} -> "
          f"{res.losses[-1]:.3f}  throughput {int(res.examples_per_sec)} rows/s")
    return {"losses": [float(v) for v in res.losses],
            "steps": len(res.losses), "fit_s": fit_s,
            "rows_per_s": float(res.examples_per_sec)}


def main(argv=None):
    a = _common.parser(__doc__).parse_args(argv)
    run(device=a.device, smoke=a.smoke, workdir=a.workdir)


if __name__ == "__main__":
    main()
