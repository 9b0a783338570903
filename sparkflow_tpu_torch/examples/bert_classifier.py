"""BERT-base text classification at sequence length 512 — the port of the
JAX package's ``examples/bert_classifier.py`` (a capability the reference
sparkflow lacks: it has no sequence models).

Token ids travel as a vector column and the attention mask as a second
one, fed to a second graph tensor (``extraInputCols``). On the H100 the
model trains in float32, and every attention layer launches the port's
flash-attention kernels (``ops/csrc/flash_fwd.cu`` forward,
``flash_bwd.cu`` backward). Set ``SPARKFLOW_TPU_MESH`` (e.g. ``"dp=2"``,
``"tp=2"``) to fit over a mesh from the Param surface, as in JAX. The
fitted model then serves an int8 (``weight_only``) transform for
comparison. ``--smoke`` shrinks the model as the JAX example's smoke mode
does.

One Param differs from the JAX example: ``weightsPath`` puts the fitted
weights in an npz file in ``workdir`` instead of inline JSON, which for
BERT-base's 110 M weights costs about 100 s a fit and 60 s a transform of
host time beside an H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase 25).

    python -m sparkflow_tpu_torch.examples.bert_classifier [--device cpu] [--smoke]
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


def synthetic_text(spark, n, seq_len, vocab):
    rs = np.random.RandomState(0)
    rows = []
    for _ in range(n):
        label = rs.randint(0, 2)
        ids = rs.randint(10, vocab, seq_len)
        if label:
            ids[:: 7] = 3  # a "positive" marker token pattern
        # variable-length documents: real tokens then padding, with the
        # attention mask travelling as its own column
        n_real = rs.randint(seq_len // 2, seq_len + 1)
        mask = np.zeros(seq_len)
        mask[:n_real] = 1.0
        ids[n_real:] = 0
        rows.append((float(label), Vectors.dense(ids.astype(float)),
                     Vectors.dense(mask)))
    return spark.createDataFrame(rows, ["label", "tokens", "mask"])


def run(*, device="cuda", smoke=False, workdir=None, rows=None, iters=None):
    """Fit, transform, and transform again with int8 weights; returns
    ``accuracy``, ``int8_accuracy``, the fit's per-iteration ``losses``,
    ``fit_s`` and ``rows_per_s`` (training examples a second)."""
    device = _common.check_device(device)
    out_dir = _common.workdir(workdir)
    spark = _common.session("bert-classifier")
    seq_len = 64 if smoke else 512
    vocab = 1000 if smoke else 30522
    df = synthetic_text(spark, rows or (256 if smoke else 4096), seq_len,
                        vocab)

    spec = build_registry_spec(
        "transformer_classifier",
        vocab_size=vocab, num_classes=2,
        hidden=64 if smoke else 768,
        num_layers=2 if smoke else 12,
        num_heads=4 if smoke else 12,
        mlp_dim=128 if smoke else 3072,
        max_len=seq_len, dropout=0.1)

    iters = iters or (3 if smoke else 10)
    est = SparkAsyncDL(
        inputCol="tokens",
        tensorflowGraph=spec,
        tfInput="input_ids:0",
        tfLabel="y:0",
        tfOutput="pred:0",
        tfOptimizer="adam",
        tfLearningRate=3e-4,
        iters=iters,
        miniBatchSize=32,
        labelCol="labels",
        predictionCol="predicted",
        # multi-input feed: the attention mask rides a second column into a
        # second graph tensor (train AND transform)
        extraInputCols="mask",
        extraTfInputs="attention_mask:0",
        weightsPath=os.path.join(out_dir, "bert_classifier_weights.npz"),
        device=device,
        # optional mesh from the environment (e.g. "dp=2", "tp=2"); tp
        # uses the model's Megatron rules, each shard launching the
        # attention kernels on its own heads
        **({"meshShape": os.environ["SPARKFLOW_TPU_MESH"]}
           if os.environ.get("SPARKFLOW_TPU_MESH") else {}))
    log = _common.LossLog()
    est.setLossCallback(log)

    pipe, fit_s = _common.timed(lambda: Pipeline(stages=[
        OneHotEncoder(inputCol="label", outputCol="labels", dropLast=False),
        est]).fit(df))
    preds = pipe.transform(df)
    acc = np.mean([float(r["predicted"]) == r["label"] for r in preds.collect()])
    print(f"train accuracy: {acc:.3f}")

    # int8 serving: same fitted model, weights quantized executor-side
    pipe.stages[-1].setParams(inferenceQuantize="weight_only")
    qpreds = pipe.transform(df)
    qacc = np.mean([float(r["predicted"]) == r["label"]
                    for r in qpreds.collect()])
    print(f"int8 (weight_only) serving accuracy: {qacc:.3f}")
    return {"accuracy": float(acc), "int8_accuracy": float(qacc),
            "losses": log.losses, "fit_s": fit_s,
            "rows_per_s": _common.fit_rate(df.count(), iters, fit_s)}


def main(argv=None):
    a = _common.parser(__doc__).parse_args(argv)
    run(device=a.device, smoke=a.smoke, workdir=a.workdir)


if __name__ == "__main__":
    main()
