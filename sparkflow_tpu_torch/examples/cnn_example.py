"""MNIST CNN through ``Pipeline.fit`` — the port of the JAX package's
``examples/cnn_example.py``, itself the reference sparkflow's
``examples/cnn_example.py``.

The same :mod:`sparkflow_tpu_torch.nn` model and Estimator Params; the data
is ``simple_dnn``'s (MNIST's csv from ``--mnist`` when it exists, else the
synthetic stand-in), and the fitted pipeline is saved into ``workdir``. The
fit runs on the H100 unless ``--device cpu`` is given.

    python -m sparkflow_tpu_torch.examples.cnn_example [--device cpu] [--smoke]
"""

import os

from sparkflow_tpu_torch import nn
from sparkflow_tpu_torch.compat import USING_PYSPARK
from sparkflow_tpu_torch.examples import _common
from sparkflow_tpu_torch.examples.simple_dnn import load_df
from sparkflow_tpu_torch.graph_utils import build_graph
from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL

if USING_PYSPARK:
    from pyspark.ml.feature import OneHotEncoder, VectorAssembler
    from pyspark.ml.pipeline import Pipeline
else:
    from sparkflow_tpu_torch.localml import (OneHotEncoder, Pipeline,
                                             VectorAssembler)


def cnn_model():
    x = nn.placeholder([None, 784], name='x')
    y = nn.placeholder([None, 10], name='y')
    xr = nn.reshape(x, shape=[-1, 28, 28, 1])
    conv1 = nn.conv2d(xr, 32, 5, activation='relu')
    conv1 = nn.max_pooling2d(conv1, 2, 2)
    conv2 = nn.conv2d(conv1, 64, 3, activation='relu')
    conv2 = nn.max_pooling2d(conv2, 2, 2)
    fc1 = nn.flatten(conv2)
    out = nn.dense(fc1, 10)
    z = nn.argmax(out, 1, name='out')
    loss = nn.softmax_cross_entropy(y, out)
    return loss


def run(*, device="cuda", smoke=False, workdir=None, rows=None, iters=None,
        mnist=None):
    """Fit and save; returns the fit's per-iteration ``losses``,
    ``fit_s``, ``rows_per_s``, the saved ``path``, and the fitted
    ``pipeline`` and the ``df`` it was fitted on."""
    device = _common.check_device(device)
    out_dir = _common.workdir(workdir)
    spark = _common.session("examples")

    df = load_df(spark, rows or (512 if smoke else 4096), mnist)
    mg = build_graph(cnn_model)
    va = VectorAssembler(inputCols=df.columns[1:785], outputCol='features')
    encoded = OneHotEncoder(inputCol='_c0', outputCol='labels', dropLast=False)

    iters = iters or (2 if smoke else 50)
    spark_model = SparkAsyncDL(
        inputCol='features',
        tensorflowGraph=mg,
        tfInput='x:0',
        tfLabel='y:0',
        tfOptimizer='adam',
        miniBatchSize=300,
        miniStochasticIters=-1,
        shufflePerIter=True,
        iters=iters,
        partitions=4,
        tfLearningRate=.0001,
        predictionCol='predicted',
        labelCol='labels',
        verbose=1,
        device=device
    )
    log = _common.LossLog()
    spark_model.setLossCallback(log)

    p, fit_s = _common.timed(lambda: Pipeline(
        stages=[va, encoded, spark_model]).fit(df))
    path = os.path.join(out_dir, "cnn")
    p.write().overwrite().save(path)
    return {"losses": log.losses, "fit_s": fit_s,
            "rows_per_s": _common.fit_rate(df.count(), iters, fit_s),
            "path": path, "pipeline": p, "df": df}


def main(argv=None):
    p = _common.parser(__doc__)
    p.add_argument("--mnist", default=None,
                   help="path of mnist_train.csv (label, 784 pixels); a "
                        "synthetic stand-in when it does not exist")
    a = p.parse_args(argv)
    run(device=a.device, smoke=a.smoke, workdir=a.workdir, mnist=a.mnist)


if __name__ == '__main__':
    main()
