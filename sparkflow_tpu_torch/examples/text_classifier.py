"""End-to-end text pipeline: raw strings -> WordPiece -> transformer — the
port of the JAX package's ``examples/text_classifier.py``.

The reference's pipelines start from numeric features; it has no text
front end. Here the native C++ WordPiece tokenizer (``WordpieceEncoder``,
built with ``g++`` at first use) turns a string column into fixed-shape
token-id and attention-mask columns, which feed a transformer classifier
through ``SparkAsyncDL``'s multi-input path. On the H100 its attention
layers launch the port's flash-attention kernels.

    python -m sparkflow_tpu_torch.examples.text_classifier [--device cpu] [--smoke]
"""

import numpy as np

from sparkflow_tpu_torch.examples import _common
from sparkflow_tpu_torch.localml import OneHotEncoder, WordpieceEncoder
from sparkflow_tpu_torch.models import build_registry_spec
from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL


def synthetic_reviews(n, rs):
    """Tiny sentiment-ish corpus: a marker word decides the label."""
    pos = ["wonderful", "great", "loved", "excellent", "delightful"]
    neg = ["terrible", "awful", "hated", "boring", "dreadful"]
    filler = ["the", "movie", "was", "plot", "acting", "and", "very",
              "with", "scenes", "a", "story"]
    rows = []
    for _ in range(n):
        label = rs.randint(0, 2)
        words = [filler[i] for i in rs.randint(0, len(filler), 8)]
        words.insert(rs.randint(0, len(words)),
                     (pos if label else neg)[rs.randint(0, 5)])
        rows.append((float(label), " ".join(words)))
    return rows


def run(*, device="cuda", smoke=False, workdir=None, rows=None, iters=None):
    """Tokenize, fit and transform; returns ``accuracy``, the fit's
    per-iteration ``losses``, ``fit_s`` and ``rows_per_s``."""
    device = _common.check_device(device)
    _common.workdir(workdir)
    spark = _common.session("text-classifier")
    rs = np.random.RandomState(0)
    seq_len = 16
    df = spark.createDataFrame(
        synthetic_reviews(rows or (200 if smoke else 2000), rs),
        ["label", "text"])

    enc = WordpieceEncoder(inputCol="text", outputCol="tokens",
                           maskCol="mask", maxLen=seq_len)
    oh = OneHotEncoder(inputCol="label", outputCol="labels", dropLast=False)
    encoded = oh.transform(enc.transform(df))

    spec = build_registry_spec(
        "transformer_classifier", vocab_size=len(enc._vocab), num_classes=2,
        hidden=32 if smoke else 128, num_layers=2 if smoke else 4,
        num_heads=4, mlp_dim=64 if smoke else 256, max_len=seq_len,
        dropout=0.1)
    iters = iters or (10 if smoke else 40)
    est = SparkAsyncDL(inputCol="tokens", tensorflowGraph=spec,
                       tfInput="input_ids:0", tfLabel="y:0",
                       tfOutput="pred:0", tfOptimizer="adam",
                       tfLearningRate=1e-3, iters=iters,
                       partitions=2, labelCol="labels",
                       predictionCol="predicted", miniBatchSize=32,
                       extraInputCols="mask",
                       extraTfInputs="attention_mask:0", device=device)
    log = _common.LossLog()
    est.setLossCallback(log)
    model, fit_s = _common.timed(lambda: est.fit(encoded))
    preds = model.transform(encoded)
    acc = np.mean([float(r["predicted"]) == r["label"]
                   for r in preds.collect()])
    print(f"train accuracy: {acc:.3f}")
    return {"accuracy": float(acc), "losses": log.losses, "fit_s": fit_s,
            "rows_per_s": _common.fit_rate(df.count(), iters, fit_s)}


def main(argv=None):
    a = _common.parser(__doc__).parse_args(argv)
    run(device=a.device, smoke=a.smoke, workdir=a.workdir)


if __name__ == "__main__":
    main()
