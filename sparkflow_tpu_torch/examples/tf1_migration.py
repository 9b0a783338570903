"""Zero-rewrite migration: run a sparkflow TF1 model on the port — the
port of the JAX package's ``examples/tf1_migration.py``.

The reference serializes models as MetaGraphDef JSON
(``sparkflow/graph_utils.py:6-15``) and ships TF1 Saver checkpoints
(``sparkflow/tensorflow_model_loader.py``). Both work here unchanged:

1. a TF1 ``build_graph`` JSON string trains through ``SparkAsyncDL``
   directly (interpreted node by node in PyTorch: no TensorFlow runs);
2. a Saver checkpoint becomes a serving model through
   ``load_tensorflow_model``, the checkpoint's own ``.meta`` the serving
   graph (TensorFlow only reads the files).

Where TensorFlow is importable the example makes both artifacts with it, as
a legacy sparkflow user would have them. Elsewhere (the H100's machine has
no TensorFlow) it takes them as ``--metagraph`` (a MetaGraphDef JSON file)
and ``--checkpoint`` (a Saver prefix); without a checkpoint it runs part 1
alone.

    python -m sparkflow_tpu_torch.examples.tf1_migration [--device cpu] [--smoke] \\
        [--metagraph GRAPH.json] [--checkpoint PREFIX]
"""

import os

import numpy as np

from sparkflow_tpu_torch.compat import USING_PYSPARK
from sparkflow_tpu_torch.examples import _common

if USING_PYSPARK:
    from pyspark.ml.linalg import Vectors
else:
    from sparkflow_tpu_torch.localml import Vectors


def make_legacy_artifacts(tmp):
    """What an existing sparkflow user already has: a metagraph JSON and a
    trained TF1 Saver checkpoint (under ``tmp``). Needs TensorFlow."""
    import tensorflow as tf
    from google.protobuf import json_format
    tf1 = tf.compat.v1

    def dense(x, units, name, act=None):
        with tf1.variable_scope(name):
            k = tf1.get_variable("kernel", [int(x.shape[-1]), units],
                                 initializer=tf1.glorot_uniform_initializer())
            b = tf1.get_variable("bias", [units],
                                 initializer=tf1.zeros_initializer())
        y = tf1.nn.bias_add(tf1.matmul(x, k), b)
        return act(y) if act else y

    os.makedirs(tmp, exist_ok=True)
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, [None, 2], name="x")
        y = tf1.placeholder(tf.float32, [None, 1], name="y")
        h = dense(x, 12, "d1", tf.nn.relu)
        out = tf1.sigmoid(dense(h, 1, "outer"), name="out_act")
        tf1.losses.log_loss(y, out)
        mg_json = json_format.MessageToJson(tf1.train.export_meta_graph())
        prefix = os.path.join(tmp, "to_load")
        with tf1.Session(graph=g) as sess:
            sess.run(tf1.global_variables_initializer())
            tf1.train.Saver().save(sess, prefix)
    return mg_json, prefix


def _have_tensorflow():
    try:
        import tensorflow  # noqa: F401
    except ImportError:
        return False
    return True


def run(*, device="cuda", smoke=False, workdir=None, iters=None,
        metagraph=None, checkpoint=None):
    """Part 1 (train from the MetaGraphDef JSON) and, with a checkpoint,
    part 2 (serve the Saver checkpoint); returns ``errors`` (of 300 rows),
    the fit's per-iteration ``losses``, ``fit_s``, ``rows_per_s``,
    ``served`` (rows, or None without a checkpoint) and the artifacts'
    paths."""
    from sparkflow_tpu_torch.model_loader import load_tensorflow_model
    from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL

    device = _common.check_device(device)
    out_dir = _common.workdir(workdir)
    if metagraph is None and _have_tensorflow():
        mg_json, ckpt_prefix = make_legacy_artifacts(
            os.path.join(out_dir, "sparkflow_tf1_demo"))
    elif metagraph is None:
        raise RuntimeError(
            "TensorFlow is not importable here, so the TF1 artifacts cannot "
            "be made: pass metagraph= (--metagraph) a MetaGraphDef JSON "
            "file, and checkpoint= (--checkpoint) a Saver prefix")
    else:
        with open(metagraph) as f:
            mg_json = f.read()
        ckpt_prefix = checkpoint
    spark = _common.session("tf1-migration")
    rs = np.random.RandomState(0)
    rows = ([(1.0, Vectors.dense(rs.normal(2, 1, 2))) for _ in range(150)]
            + [(0.0, Vectors.dense(rs.normal(-2, 1, 2))) for _ in range(150)])
    df = spark.createDataFrame(rows, ["label", "features"])

    # 1) the reference's build_graph JSON trains as-is
    iters = iters or (5 if smoke else 25)
    est = SparkAsyncDL(inputCol="features", tensorflowGraph=mg_json,
                       tfInput="x:0", tfLabel="y:0", tfOutput="out_act:0",
                       tfOptimizer="adam", tfLearningRate=0.1,
                       iters=iters, partitions=2,
                       labelCol="label", predictionCol="predicted",
                       miniBatchSize=64, device=device)
    log = _common.LossLog()
    est.setLossCallback(log)
    model, fit_s = _common.timed(lambda: est.fit(df))
    errs = sum(1 for r in model.transform(df).collect()
               if round(float(r["predicted"])) != float(r["label"]))
    print(f"trained from raw MetaGraphDef JSON: {errs}/300 errors")

    # 2) the Saver checkpoint serves without a rebuilt graph
    n = None
    if ckpt_prefix is not None:
        served = load_tensorflow_model(ckpt_prefix, "features", "x:0",
                                       "out_act:0", device=device)
        n = served.transform(df).count()
        print(f"served {n} rows from the TF1 checkpoint's own .meta graph")
    return {"errors": errs, "losses": log.losses, "fit_s": fit_s,
            "rows_per_s": _common.fit_rate(df.count(), iters, fit_s),
            "served": n, "checkpoint": ckpt_prefix}


def main(argv=None):
    p = _common.parser(__doc__)
    p.add_argument("--metagraph", default=None,
                   help="a MetaGraphDef JSON file (else made with "
                        "TensorFlow)")
    p.add_argument("--checkpoint", default=None,
                   help="a TF1 Saver checkpoint prefix to serve")
    a = p.parse_args(argv)
    run(device=a.device, smoke=a.smoke, workdir=a.workdir,
        metagraph=a.metagraph, checkpoint=a.checkpoint)


if __name__ == "__main__":
    main()
