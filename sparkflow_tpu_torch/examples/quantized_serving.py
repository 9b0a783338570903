"""int8 quantized inference: train in full precision, serve int8 — the
port of the JAX package's ``examples/quantized_serving.py``.

The reference serves float32 through ``tf.Session``
(``sparkflow/ml_util.py:65-73``). After a normal fit, set
``inferenceQuantize`` on the fitted model and ``transform`` serves
symmetric per-channel int8 weights:

- ``weight_only``: kernels stored int8 and dequantized at the matmul — a
  quarter of float32's weight bytes, with the accuracy bounded by 8-bit
  weight rounding;
- ``dynamic``: activations quantized per row at run time too, and the
  matmul runs int8 x int8 -> int32 on the H100's int8 tensor cores
  (``torch._int_mm``).

The saved pipeline keeps its full-precision weights; the weights are
quantized at serve time, cached per (weights, mode).

    python -m sparkflow_tpu_torch.examples.quantized_serving [--device cpu] [--smoke]
"""

import numpy as np

from sparkflow_tpu_torch import nn
from sparkflow_tpu_torch.compat import USING_PYSPARK
from sparkflow_tpu_torch.examples import _common
from sparkflow_tpu_torch.graph_utils import build_graph
from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL

if USING_PYSPARK:
    from pyspark.ml.linalg import Vectors
else:
    from sparkflow_tpu_torch.localml import Vectors


def model():
    x = nn.placeholder([None, 32], name='x')
    y = nn.placeholder([None, 1], name='y')
    h = nn.dense(x, 256, activation='relu')
    h = nn.dense(h, 256, activation='relu')
    out = nn.dense(h, 1, activation='sigmoid', name='outer')
    nn.sigmoid_cross_entropy(y, out)


def run(*, device="cuda", smoke=False, workdir=None, rows=None, iters=None):
    """Fit, then transform in float32, ``weight_only`` and ``dynamic``;
    returns each mode's ``error_rate``, the fit's ``losses``, ``fit_s`` and
    ``rows_per_s`` of the float32 transform."""
    device = _common.check_device(device)
    _common.workdir(workdir)
    spark = _common.session('quantized-serving')
    rs = np.random.RandomState(0)
    rows_ = []
    for _ in range(rows or (100 if smoke else 500)):
        rows_.append((1.0, Vectors.dense(rs.normal(0.8, 1.0, 32))))
        rows_.append((0.0, Vectors.dense(rs.normal(-0.8, 1.0, 32))))
    df = spark.createDataFrame(rows_, ['label', 'features'])

    est = SparkAsyncDL(
        inputCol='features', tensorflowGraph=build_graph(model),
        tfInput='x:0', tfLabel='y:0', tfOutput='outer/Sigmoid:0',
        labelCol='label', tfLearningRate=.05,
        iters=iters or (3 if smoke else 15), miniBatchSize=128,
        verbose=1, device=device)
    log = _common.LossLog()
    est.setLossCallback(log)
    fitted, fit_s = _common.timed(lambda: est.fit(df))

    def error_rate(m):
        preds = m.transform(df).collect()
        return np.mean([round(float(r['predicted'])) != float(r['label'])
                        for r in preds])

    base, serve_s = _common.timed(lambda: error_rate(fitted))
    print(f'f32 serving error rate:        {base:.4f}')
    rates = {"float32": float(base)}
    for mode in ('weight_only', 'dynamic'):
        fitted.setParams(inferenceQuantize=mode)
        rates[mode] = float(error_rate(fitted))
        print(f'{mode:12s} serving error rate: {rates[mode]:.4f}')
    return {"error_rate": rates, "losses": log.losses, "fit_s": fit_s,
            "rows_per_s": df.count() / serve_s}


def main(argv=None):
    a = _common.parser(__doc__).parse_args(argv)
    run(device=a.device, smoke=a.smoke, workdir=a.workdir)


if __name__ == '__main__':
    main()
