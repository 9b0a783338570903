"""MNIST MLP through ``Pipeline.fit`` — the port of the JAX package's
``examples/simple_dnn.py``, itself the reference sparkflow's
``examples/simple_dnn.py``.

The model function is the same :mod:`sparkflow_tpu_torch.nn` code, the
Estimator Params are the reference's, and the pipeline is saved into
``workdir``, loaded back and evaluated. MNIST's csv is read only from a
path given with ``--mnist`` that exists; otherwise a synthetic stand-in
(numpy ``RandomState(0)``) is generated, so the example always runs. The
fit runs on the H100 unless ``--device cpu`` is given.

    python -m sparkflow_tpu_torch.examples.simple_dnn [--device cpu] [--smoke]
"""

import os

import numpy as np

from sparkflow_tpu_torch import nn
from sparkflow_tpu_torch.compat import USING_PYSPARK
from sparkflow_tpu_torch.examples import _common
from sparkflow_tpu_torch.graph_utils import build_adam_config, build_graph
from sparkflow_tpu_torch.pipeline_util import PysparkPipelineWrapper
from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL

if USING_PYSPARK:
    from pyspark.ml.evaluation import MulticlassClassificationEvaluator
    from pyspark.ml.feature import OneHotEncoder, VectorAssembler
    from pyspark.ml.pipeline import Pipeline, PipelineModel
    from pyspark.sql.functions import rand
else:
    from sparkflow_tpu_torch.localml import (
        MulticlassClassificationEvaluator, OneHotEncoder, Pipeline,
        PipelineModel, VectorAssembler)
    from sparkflow_tpu_torch.localml.sql import functions
    rand = functions.rand


def small_model():
    x = nn.placeholder([None, 784], name='x')
    y = nn.placeholder([None, 10], name='y')
    layer1 = nn.dense(x, 256, activation='relu', kernel_initializer='glorot_uniform')
    layer2 = nn.dense(layer1, 256, activation='relu', kernel_initializer='glorot_uniform')
    out = nn.dense(layer2, 10, kernel_initializer='glorot_uniform')
    z = nn.argmax(out, 1, name='out')
    loss = nn.softmax_cross_entropy(y, out)
    return loss


def load_df(spark, n_synth=4096, mnist=None):
    """MNIST's csv at ``mnist`` when that path exists, else ``n_synth``
    synthetic rows (label, then 784 pixels), shuffled."""
    if mnist and os.path.exists(mnist):
        return spark.read.option("inferSchema", "true").csv(mnist).orderBy(rand())
    rs = np.random.RandomState(0)
    rows = []
    for _ in range(n_synth):
        label = rs.randint(0, 10)
        px = rs.rand(784) * (0.3 + 0.07 * label)
        rows.append(tuple([int(label)] + px.tolist()))
    cols = [f"_c{i}" for i in range(785)]
    return spark.createDataFrame(rows, cols).orderBy(rand())


def run(*, device="cuda", smoke=False, workdir=None, rows=None, iters=None,
        mnist=None):
    """Fit, save, load and evaluate; returns ``test_error``, the fit's
    per-iteration ``losses``, ``fit_s``, ``rows_per_s``, the saved
    ``path``, and the in-memory ``pipeline``, the ``loaded`` one and the
    ``df`` they ran on."""
    device = _common.check_device(device)
    out_dir = _common.workdir(workdir)
    spark = _common.session("examples")

    df = load_df(spark, rows or (512 if smoke else 4096), mnist)
    mg = build_graph(small_model)
    adam_config = build_adam_config(learning_rate=0.001, beta1=0.9, beta2=0.999)

    vector_assembler = VectorAssembler(inputCols=df.columns[1:785], outputCol='features')
    encoder = OneHotEncoder(inputCol='_c0', outputCol='labels', dropLast=False)

    iters = iters or 50
    spark_model = SparkAsyncDL(
        inputCol='features',
        tensorflowGraph=mg,
        tfInput='x:0',
        tfLabel='y:0',
        tfOutput='out:0',
        tfOptimizer='adam',
        miniBatchSize=300,
        miniStochasticIters=1,
        shufflePerIter=True,
        iters=iters,
        predictionCol='predicted',
        labelCol='labels',
        partitions=4,
        verbose=1,
        optimizerOptions=adam_config,
        device=device
    )
    log = _common.LossLog()
    spark_model.setLossCallback(log)

    p, fit_s = _common.timed(lambda: Pipeline(
        stages=[vector_assembler, encoder, spark_model]).fit(df))
    path = os.path.join(out_dir, 'simple_dnn')
    p.write().overwrite().save(path)

    loaded_pipeline = PysparkPipelineWrapper.unwrap(PipelineModel.load(path))

    predictions = loaded_pipeline.transform(df)
    evaluator = MulticlassClassificationEvaluator(
        labelCol="_c0", predictionCol="predicted", metricName="accuracy")
    accuracy = evaluator.evaluate(predictions)
    print("Test Error = %g" % (1.0 - accuracy))
    return {"test_error": 1.0 - accuracy, "losses": log.losses,
            "fit_s": fit_s, "rows_per_s": _common.fit_rate(df.count(), iters,
                                                           fit_s),
            "path": path, "pipeline": p, "loaded": loaded_pipeline, "df": df}


def main(argv=None):
    p = _common.parser(__doc__)
    p.add_argument("--mnist", default=None,
                   help="path of mnist_train.csv (label, 784 pixels); a "
                        "synthetic stand-in when it does not exist")
    a = p.parse_args(argv)
    run(device=a.device, smoke=a.smoke, workdir=a.workdir, mnist=a.mnist)


if __name__ == '__main__':
    main()
