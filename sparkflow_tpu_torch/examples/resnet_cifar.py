"""ResNet-50 on CIFAR-10-shaped data through the Spark ML pipeline — the
port of the JAX package's ``examples/resnet_cifar.py`` (the reference has
no image-model path).

Images travel as flattened 3072-dim vector columns; the registry spec is
the Estimator's graph Param like any other model. ``--smoke`` shrinks
depth and width as the JAX example's smoke mode does. As in
``bert_classifier``, ``weightsPath`` keeps ResNet-50's fitted weights in
an npz file in ``workdir`` rather than inline JSON.

    python -m sparkflow_tpu_torch.examples.resnet_cifar [--device cpu] [--smoke]
"""

import os

import numpy as np

from sparkflow_tpu_torch.compat import USING_PYSPARK
from sparkflow_tpu_torch.examples import _common
from sparkflow_tpu_torch.models import build_registry_spec
from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL

if USING_PYSPARK:
    from pyspark.ml.feature import OneHotEncoder
    from pyspark.ml.linalg import Vectors
    from pyspark.ml.pipeline import Pipeline
else:
    from sparkflow_tpu_torch.localml import OneHotEncoder, Pipeline, Vectors


def synthetic_cifar(spark, n=512):
    rs = np.random.RandomState(0)
    rows = []
    for _ in range(n):
        label = rs.randint(0, 10)
        img = rs.rand(32 * 32 * 3) * (0.5 + 0.05 * label)
        rows.append((float(label), Vectors.dense(img)))
    return spark.createDataFrame(rows, ["label", "features"])


def run(*, device="cuda", smoke=False, workdir=None, rows=None, iters=None):
    """Fit and transform; returns ``accuracy``, the fit's per-iteration
    ``losses``, ``fit_s`` and ``rows_per_s``."""
    device = _common.check_device(device)
    out_dir = _common.workdir(workdir)
    spark = _common.session("resnet-cifar")
    df = synthetic_cifar(spark, rows or (64 if smoke else 2048))

    # flattened vector columns reshape to NHWC inside the model; the smoke
    # path shrinks depth/width so the example runs on a CPU
    spec = build_registry_spec("resnet", num_classes=10,
                               depth=18 if smoke else 50,
                               image_size=32, width=16 if smoke else 64)

    iters = iters or (1 if smoke else 20)
    est = SparkAsyncDL(
        inputCol="features",
        tensorflowGraph=spec,
        tfInput="x:0",
        tfLabel="y:0",
        tfOutput="pred:0",
        tfOptimizer="adam",
        tfLearningRate=1e-3,
        iters=iters,
        miniBatchSize=32 if smoke else 64,
        labelCol="labels",
        predictionCol="predicted",
        weightsPath=os.path.join(out_dir, "resnet_cifar_weights.npz"),
        device=device)
    log = _common.LossLog()
    est.setLossCallback(log)

    pipe, fit_s = _common.timed(lambda: Pipeline(stages=[
        OneHotEncoder(inputCol="label", outputCol="labels", dropLast=False),
        est]).fit(df))
    preds = pipe.transform(df)
    acc = np.mean([float(r["predicted"]) == r["label"] for r in preds.collect()])
    print(f"train accuracy: {acc:.3f}")
    return {"accuracy": float(acc), "losses": log.losses, "fit_s": fit_s,
            "rows_per_s": _common.fit_rate(df.count(), iters, fit_s)}


def main(argv=None):
    a = _common.parser(__doc__).parse_args(argv)
    run(device=a.device, smoke=a.smoke, workdir=a.workdir)


if __name__ == "__main__":
    main()
