"""PyTorch port, the text front end: the WordPiece tokenizer
(``utils/text.py`` over ``native/tokenizer.cpp``, a pure-Python fallback
beside it) and ``WordpieceEncoder`` against the JAX package's, on the same
vocabularies and strings. Token ids and masks must be equal — exact, the
ids are integers — on the native path and the fallback alike; the encoder's
output columns equal JAX's column for column; the text pipeline trains
through the estimator on the CPU."""

import numpy as np
import pytest

from sparkflow_tpu.localml import LocalSession as JaxSession
from sparkflow_tpu.localml import WordpieceEncoder as JaxEncoder
from sparkflow_tpu.utils.text import WordpieceTokenizer as JaxTokenizer
from sparkflow_tpu.utils.text import _basic_split as jax_basic_split
from sparkflow_tpu.utils.text import build_vocab as jax_build_vocab
from sparkflow_tpu_torch.localml import (LocalSession, OneHotEncoder,
                                         WordpieceEncoder)
from sparkflow_tpu_torch.models import build_registry_spec
from sparkflow_tpu_torch.native.build import load_library
from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL
from sparkflow_tpu_torch.utils.text import (WordpieceTokenizer, _basic_split,
                                            build_vocab)

VOCAB = ["[PAD]", "[UNK]", "the", "quick", "brown", "fox", "jump", "##ed",
         "##s", "over", "lazy", "dog", ",", "."]
TEXTS = ["The quick brown fox jumps over the lazy dog.",
         "jumped, jumps", "unknownword quick", "",
         "Éclair café the",   # non-ASCII passes through both paths
         "a\x01b the",                  # control chars: no split either path
         "line\nbreak the", "the " * 20]


def _reviews(n, seed):
    """Sentences in the shape of ``examples/text_classifier.py``'s
    ``synthetic_reviews``: filler words and one sentiment marker."""
    rs = np.random.RandomState(seed)
    pos = ["wonderful", "great", "loved", "excellent", "delightful"]
    neg = ["terrible", "awful", "hated", "boring", "dreadful"]
    filler = ["the", "movie", "was", "plot", "acting", "and", "very",
              "with", "scenes", "a", "story", "Plot,", "twists!"]
    rows = []
    for _ in range(n):
        label = rs.randint(0, 2)
        words = [filler[i] for i in rs.randint(0, len(filler),
                                                rs.randint(3, 14))]
        words.insert(rs.randint(0, len(words)),
                     (pos if label else neg)[rs.randint(0, 5)])
        rows.append((float(label), " ".join(words)))
    return rows


def test_native_library_builds():
    # g++ is in the image; the fallback works without it, but the native
    # path is the one the card machine measures
    assert load_library() is not None


def test_basic_split_and_build_vocab_equal_jax():
    texts = TEXTS + [t for _l, t in _reviews(30, 1)]
    for t in texts:
        assert _basic_split(t) == jax_basic_split(t)
    assert build_vocab(texts) == jax_build_vocab(texts)
    assert build_vocab(texts, max_size=7) == jax_build_vocab(texts,
                                                             max_size=7)
    v = build_vocab(["a a a b b c"], max_size=5)
    assert v[:2] == ["[PAD]", "[UNK]"] and v[2] == "a"


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "fallback"])
@pytest.mark.parametrize("max_len", [2, 8, 16])
def test_ids_and_masks_equal_jax(use_native, max_len):
    tok = WordpieceTokenizer(VOCAB, use_native=use_native)
    assert (tok._native is not None) == use_native
    ref = JaxTokenizer(VOCAB, use_native=use_native)
    for t in TEXTS:
        ids, mask = tok.encode(t, max_len)
        want_ids, want_mask = ref.encode(t, max_len)
        assert ids.dtype == want_ids.dtype and mask.dtype == want_mask.dtype
        np.testing.assert_array_equal(ids, want_ids, err_msg=t)
        np.testing.assert_array_equal(mask, want_mask, err_msg=t)
    bi, bm = tok.encode_batch(TEXTS, max_len)
    wi, wm = ref.encode_batch(TEXTS, max_len)
    np.testing.assert_array_equal(bi, wi)
    np.testing.assert_array_equal(bm, wm)


def test_greedy_longest_match_unk_and_truncation():
    tok = WordpieceTokenizer(VOCAB)
    ids, mask = tok.encode("The quick fox jumped", max_len=8)
    expect = [VOCAB.index(t) for t in ("the", "quick", "fox", "jump", "##ed")]
    assert list(ids[:5]) == expect and list(ids[5:]) == [0, 0, 0]
    assert list(mask) == [1, 1, 1, 1, 1, 0, 0, 0]
    ids, _ = tok.encode("zebra the", max_len=2)
    assert list(ids) == [VOCAB.index("[UNK]"), VOCAB.index("the")]


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "fallback"])
def test_review_corpus_ids_equal_jax(use_native):
    texts = [t for _l, t in _reviews(64, 2)]
    vocab = build_vocab(texts[:32], max_size=20)    # later rows meet [UNK]
    got = WordpieceTokenizer(vocab, use_native=use_native).encode_batch(
        texts, 12)
    want = JaxTokenizer(vocab, use_native=use_native).encode_batch(texts, 12)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1].sum(1) == 12).any() and (got[1].sum(1) < 12).any()


def test_wordpiece_encoder_equals_jax_column_for_column():
    rows = _reviews(40, 3)
    tdf = LocalSession.builder.getOrCreate().createDataFrame(
        rows, ["label", "text"])
    jdf = JaxSession.builder.getOrCreate().createDataFrame(
        rows, ["label", "text"])
    kw = dict(inputCol="text", outputCol="tokens", maskCol="mask", maxLen=10)
    tenc, jenc = WordpieceEncoder(**kw), JaxEncoder(**kw)
    got = tenc.transform(tdf)
    want = jenc.transform(jdf)
    assert tenc._vocab == jenc._vocab     # derived from the dataset
    assert got.columns == want.columns == ["label", "text", "tokens", "mask"]
    for g, w in zip(got.collect(), want.collect()):
        assert g["label"] == w["label"] and g["text"] == w["text"]
        for col in ("tokens", "mask"):
            a, b = g[col].toArray(), w[col].toArray()
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # a given vocabulary is used as it is
    vocab = jenc._vocab[:12]
    got = WordpieceEncoder(vocab=vocab, **kw).transform(tdf).collect()
    want = JaxEncoder(vocab=vocab, **kw).transform(jdf).collect()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"].toArray(),
                                      w["tokens"].toArray())


def test_text_to_transformer_pipeline():
    """WordpieceEncoder -> OneHotEncoder -> a multi-input transformer
    through the estimator: tokenize, mask, train, predict."""
    rs = np.random.RandomState(0)
    pos_words, neg_words = ["great", "good", "happy"], ["bad", "awful", "sad"]
    filler = ["the", "movie", "was", "very", "so"]
    rows = []
    for _ in range(80):
        label = rs.randint(0, 2)
        words = [filler[i] for i in rs.randint(0, len(filler), 4)]
        words.append((pos_words if label else neg_words)[rs.randint(0, 3)])
        rows.append((float(label), " ".join(words)))
    df = LocalSession.builder.getOrCreate().createDataFrame(
        rows, ["label", "text"])
    enc = WordpieceEncoder(inputCol="text", outputCol="tokens",
                           maskCol="mask", maxLen=8)
    oh = OneHotEncoder(inputCol="label", outputCol="labels", dropLast=False)
    encoded = oh.transform(enc.transform(df))
    spec = build_registry_spec("transformer_classifier",
                               vocab_size=len(enc._vocab), num_classes=2,
                               hidden=16, num_layers=1, num_heads=2,
                               mlp_dim=32, max_len=8, dropout=0.0)
    est = SparkAsyncDL(inputCol="tokens", tensorflowGraph=spec,
                       tfInput="input_ids:0", tfLabel="y:0",
                       tfOutput="pred:0", tfOptimizer="adam",
                       tfLearningRate=0.01, iters=30, partitions=2,
                       labelCol="labels", predictionCol="predicted",
                       miniBatchSize=16, extraInputCols="mask",
                       extraTfInputs="attention_mask:0", device="cpu")
    model = est.fit(encoded)
    errs = sum(1 for r in model.transform(encoded).collect()
               if round(float(r["predicted"])) != float(r["label"]))
    assert errs < 20, errs  # the sentiment marker token is fully separable
