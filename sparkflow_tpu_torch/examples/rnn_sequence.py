"""Recurrent models end to end: a bi-GRU text classifier and an LSTM
language model — the port of the JAX package's
``examples/rnn_sequence.py``.

The ``rnn_classifier`` / ``rnn_lm`` registry family drives the same Spark
ML surface as every other model: tokenize -> fit -> transform -> evaluate,
and a character LM trained with ``Trainer`` directly. Each layer's
recurrence is a loop of one fused gate GEMM a step on the H100.

    python -m sparkflow_tpu_torch.examples.rnn_sequence [--device cpu] [--smoke]
"""

import numpy as np

from sparkflow_tpu_torch.examples import _common
from sparkflow_tpu_torch.localml import (BinaryClassificationEvaluator,
                                         Pipeline, WordpieceEncoder)
from sparkflow_tpu_torch.models import build_registry_spec
from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL


def synthetic_reviews(n, rs):
    pos_words = ["great", "wonderful", "loved", "superb", "delight"]
    neg_words = ["terrible", "awful", "hated", "dreadful", "boring"]
    filler = ["the", "movie", "plot", "acting", "was", "a", "bit", "film"]
    rows = []
    for _ in range(n):
        label = int(rs.rand() > 0.5)
        words = list(rs.choice(filler, rs.randint(4, 9)))
        words.insert(rs.randint(0, len(words)),
                     str(rs.choice(pos_words if label else neg_words)))
        rows.append((" ".join(words), float(label)))
    return rows


def classifier_pipeline(spark, rs, smoke, device, iters=None):
    max_len = 16
    df = spark.createDataFrame(synthetic_reviews(60 if smoke else 400, rs),
                               ["text", "label"])
    spec = build_registry_spec(
        "rnn_classifier", vocab_size=256, num_classes=2, hidden=32,
        num_layers=1, max_len=max_len, cell="gru", bidirectional=True)
    est = SparkAsyncDL(inputCol="ids", tensorflowGraph=spec,
                       tfInput="input_ids:0", tfLabel="y:0", labelCol="label",
                       tfOutput="probs:0", extraInputCols="mask",
                       extraTfInputs="attention_mask:0",
                       iters=iters or (10 if smoke else 60), miniBatchSize=32,
                       tfOptimizer="adam", tfLearningRate=1e-2,
                       predictionCol="rawPrediction", device=device)
    log = _common.LossLog()
    est.setLossCallback(log)
    pipe = Pipeline(stages=[
        WordpieceEncoder(inputCol="text", outputCol="ids", maskCol="mask",
                         maxLen=max_len),
        est,
    ])
    model = pipe.fit(df)
    scored = model.transform(df)
    auc = BinaryClassificationEvaluator(labelCol="label").evaluate(scored)
    print(f"bi-GRU classifier train AUC: {auc:.3f}")
    return auc, log.losses


def char_lm(rs, smoke, device, iters=None):
    """LSTM character LM on a toy corpus through the Trainer directly."""
    from sparkflow_tpu_torch.trainer import Trainer

    text = ("the quick brown fox jumps over the lazy dog " * 40)
    chars = sorted(set(text))
    idx = {c: i for i, c in enumerate(chars)}
    seq = 32
    ids = np.array([idx[c] for c in text], np.float32)
    n = (len(ids) - 1) // seq
    X = ids[:n * seq].reshape(n, seq)

    spec = build_registry_spec("rnn_lm", vocab_size=len(chars), hidden=64,
                               num_layers=2, max_len=seq, cell="lstm")
    tr = Trainer(spec, "input_ids:0", None, optimizer="adam",
                 learning_rate=5e-3, iters=iters or (5 if smoke else 40),
                 mini_batch_size=16, device=device)
    res = tr.fit(X, None)
    ppl0, ppl1 = np.exp(res.losses[0]), np.exp(res.losses[-1])
    print(f"LSTM char-LM perplexity: {ppl0:.1f} -> {ppl1:.1f}")
    return ppl1, [float(v) for v in res.losses], X.size


def run(*, device="cuda", smoke=False, workdir=None, iters=None):
    """The classifier pipeline, then the char LM (``iters`` cuts both
    fits); returns ``auc``, ``perplexity``, both fits' ``losses``,
    ``fit_s`` and the LM's ``tokens_per_s``. At the full sizes it holds
    the JAX example's bars: AUC above 0.9, perplexity below 10."""
    device = _common.check_device(device)
    _common.workdir(workdir)
    rs = np.random.RandomState(0)
    spark = _common.session("rnn-example")
    (auc, cls_losses), cls_s = _common.timed(
        lambda: classifier_pipeline(spark, rs, smoke, device, iters))
    (ppl, lm_losses, tokens), lm_s = _common.timed(
        lambda: char_lm(rs, smoke, device, iters))
    lm_iters = iters or (5 if smoke else 40)
    if not smoke and iters is None:
        assert auc > 0.9, auc
        assert ppl < 10.0, ppl
    print("rnn_sequence example OK")
    return {"auc": float(auc), "perplexity": float(ppl),
            "losses": cls_losses, "lm_losses": lm_losses,
            "fit_s": cls_s + lm_s,
            "tokens_per_s": _common.fit_rate(tokens, lm_iters, lm_s)}


def main(argv=None):
    a = _common.parser(__doc__).parse_args(argv)
    run(device=a.device, smoke=a.smoke, workdir=a.workdir)


if __name__ == "__main__":
    main()
