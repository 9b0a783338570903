"""MNIST dense autoencoder, unsupervised (``tfLabel=None``) — the port of
the JAX package's ``examples/autoencoder_example.py``, itself the reference
sparkflow's ``examples/autoencoder_example.py``.

The bottleneck activations are read through ``tfOutput='out/Sigmoid:0'``,
as in the reference. The data is ``simple_dnn``'s (MNIST's csv from
``--mnist`` when it exists, else the synthetic stand-in). The fit runs on
the H100 unless ``--device cpu`` is given.

    python -m sparkflow_tpu_torch.examples.autoencoder_example [--device cpu] [--smoke]
"""

from sparkflow_tpu_torch import nn
from sparkflow_tpu_torch.compat import USING_PYSPARK
from sparkflow_tpu_torch.examples import _common
from sparkflow_tpu_torch.examples.simple_dnn import load_df
from sparkflow_tpu_torch.graph_utils import build_graph
from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL

if USING_PYSPARK:
    from pyspark.ml.feature import Normalizer, VectorAssembler
else:
    from sparkflow_tpu_torch.localml import Normalizer, VectorAssembler


def small_model():
    x = nn.placeholder('float', shape=[None, 784], name='x')
    layer1 = nn.dense(x, 256, activation='relu')
    layer2 = nn.dense(layer1, 128, activation='sigmoid', name='out')
    layer3 = nn.dense(layer2, 256, activation='relu')
    layer4 = nn.dense(layer3, 784, activation='sigmoid')
    loss = nn.mean_squared_error(layer4, x)
    return loss


def run(*, device="cuda", smoke=False, workdir=None, rows=None, iters=None,
        mnist=None):
    """Fit and read the bottleneck of one row; returns ``predicted`` (that
    row's 128 activations), the fit's per-iteration ``losses``, ``fit_s``,
    ``rows_per_s``, the fitted ``model`` and the ``df`` (column
    ``features``) it was fitted on."""
    device = _common.check_device(device)
    _common.workdir(workdir)
    spark = _common.session("examples")

    df = load_df(spark, rows or (512 if smoke else 4096), mnist)
    mg = build_graph(small_model)

    va = VectorAssembler(inputCols=df.columns[1:785],
                         outputCol='feats').transform(df).select(['feats'])
    na = Normalizer(inputCol='feats', outputCol='features',
                    p=1.0).transform(va).select(['features'])

    iters = iters or (2 if smoke else 10)
    est = SparkAsyncDL(
        inputCol='features',
        tensorflowGraph=mg,
        tfInput='x:0',
        tfLabel=None,
        tfOutput='out/Sigmoid:0',
        tfOptimizer='adam',
        tfLearningRate=.001,
        iters=iters,
        predictionCol='predicted',
        partitions=4,
        miniBatchSize=256,
        verbose=1,
        device=device
    )
    log = _common.LossLog()
    est.setLossCallback(log)
    spark_model, fit_s = _common.timed(lambda: est.fit(na))

    t = spark_model.transform(na).take(1)
    print(t[0]['predicted'])
    return {"predicted": t[0]['predicted'], "losses": log.losses,
            "fit_s": fit_s,
            "rows_per_s": _common.fit_rate(na.count(), iters, fit_s),
            "model": spark_model, "df": na}


def main(argv=None):
    p = _common.parser(__doc__)
    p.add_argument("--mnist", default=None,
                   help="path of mnist_train.csv (label, 784 pixels); a "
                        "synthetic stand-in when it does not exist")
    a = p.parse_args(argv)
    run(device=a.device, smoke=a.smoke, workdir=a.workdir, mnist=a.mnist)


if __name__ == '__main__':
    main()
