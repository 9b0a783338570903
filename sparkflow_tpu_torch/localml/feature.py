"""Feature transformers: the ``pyspark.ml.feature`` subset the reference examples
use (``VectorAssembler``, ``OneHotEncoder``, ``Normalizer`` — see reference
``examples/simple_dnn.py:40-41``, ``examples/autoencoder_example.py:26-27``)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .base import Estimator, Model, Transformer
from .linalg import DenseVector, SparseVector, Vectors, vector_to_array
from .param import Param, Params, TypeConverters, keyword_only, HasInputCol, HasOutputCol
from .sql import DataFrame, Row


class VectorAssembler(Transformer, HasInputCol, HasOutputCol):
    """Concatenates numeric / vector columns into one DenseVector column."""

    inputCols = Param(Params._dummy(), "inputCols", "input column names",
                      typeConverter=TypeConverters.toListString)

    @keyword_only
    def __init__(self, inputCols=None, outputCol=None):
        super().__init__()
        kwargs = self._input_kwargs
        self._set(**kwargs)

    def getInputCols(self) -> List[str]:
        return self.getOrDefault(self.inputCols)

    def _transform(self, dataset: DataFrame) -> DataFrame:
        in_cols = self.getInputCols()
        out_col = self.getOrDefault(self.outputCol)
        rows = []
        fields, idx = None, None
        for r in dataset.collect():
            if r.__fields__ != fields:  # look the columns up once per layout
                fields = r.__fields__
                idx = [fields.index(c) if c in fields else c for c in in_cols]
            vals = [r.__values__[i] if isinstance(i, int) else r[i]
                    for i in idx]
            if all(isinstance(v, (int, float)) for v in vals):
                vec = Vectors.dense(np.asarray(vals, dtype=np.float64))
            else:
                vec = Vectors.dense(np.concatenate(
                    [vector_to_array(v) for v in vals]))
            rows.append(Row(**{**r.asDict(), out_col: vec}))
        cols = dataset.columns + ([out_col] if out_col not in dataset.columns else [])
        return DataFrame(rows, cols, dataset.num_partitions)


class OneHotEncoder(Transformer, HasInputCol, HasOutputCol):
    """Category index -> one-hot sparse vector (pyspark 2.x OneHotEncoder
    semantics: transform-only; vector size inferred as max(index)+1; dropLast
    drops the final category — the reference uses ``dropLast=False``,
    ``examples/simple_dnn.py:41``)."""

    dropLast = Param(Params._dummy(), "dropLast", "drop the last category",
                     typeConverter=TypeConverters.toBoolean)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, dropLast=True):
        super().__init__()
        self._setDefault(dropLast=True)
        kwargs = self._input_kwargs
        self._set(**kwargs)

    def getDropLast(self) -> bool:
        return self.getOrDefault(self.dropLast)

    def _transform(self, dataset: DataFrame) -> DataFrame:
        in_col = self.getOrDefault(self.inputCol)
        out_col = self.getOrDefault(self.outputCol)
        drop_last = self.getDropLast()
        values = [int(r[in_col]) for r in dataset.collect()]
        size = (max(values) + 1) if values else 0
        if drop_last:
            size -= 1
        rows = []
        for r, v in zip(dataset.collect(), values):
            if v < size:
                vec = SparseVector(size, [v], [1.0])
            else:  # dropped last category encodes as all-zeros
                vec = SparseVector(size, [], [])
            rows.append(Row(**{**r.asDict(), out_col: vec}))
        cols = dataset.columns + ([out_col] if out_col not in dataset.columns else [])
        return DataFrame(rows, cols, dataset.num_partitions)


class Normalizer(Transformer, HasInputCol, HasOutputCol):
    """Scale each vector to unit p-norm (reference autoencoder example uses
    p=1.0, ``examples/autoencoder_example.py:27``)."""

    p = Param(Params._dummy(), "p", "norm order", typeConverter=TypeConverters.toFloat)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, p=2.0):
        super().__init__()
        self._setDefault(p=2.0)
        kwargs = self._input_kwargs
        self._set(**kwargs)

    def getP(self) -> float:
        return self.getOrDefault(self.p)

    def _transform(self, dataset: DataFrame) -> DataFrame:
        in_col = self.getOrDefault(self.inputCol)
        out_col = self.getOrDefault(self.outputCol)
        p = self.getP()
        rows = []
        for r in dataset.collect():
            arr = vector_to_array(r[in_col])
            norm = np.linalg.norm(arr, ord=p)
            vec = Vectors.dense(arr / norm if norm > 0 else arr)
            rows.append(Row(**{**r.asDict(), out_col: vec}))
        cols = dataset.columns + ([out_col] if out_col not in dataset.columns else [])
        return DataFrame(rows, cols, dataset.num_partitions)


class WordpieceEncoder(Transformer, HasInputCol, HasOutputCol):
    """Text column -> fixed-shape token-id vector + attention-mask columns,
    ready for ``SparkAsyncDL`` transformer models
    (``extraInputCols=maskCol``). Backed by the native C++ WordPiece
    tokenizer (``sparkflow_tpu_torch/native/tokenizer.cpp``, through
    :mod:`sparkflow_tpu_torch.utils.text`); pure-Python fallback otherwise,
    with the same ids. No pyspark analog exists. Without a vocabulary,
    ``transform`` builds one from the dataset it transforms."""

    maskCol = Param(Params._dummy(), "maskCol", "attention mask column",
                    typeConverter=TypeConverters.toString)
    maxLen = Param(Params._dummy(), "maxLen", "sequence length",
                   typeConverter=TypeConverters.toInt)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, maskCol=None,
                 maxLen=None, vocab=None):
        super().__init__()
        self._setDefault(maskCol="mask", maxLen=128)
        self._vocab = list(vocab) if vocab is not None else None
        kwargs = dict(self._input_kwargs)
        kwargs.pop("vocab", None)
        self._set(**{k: v for k, v in kwargs.items() if v is not None})

    def setVocab(self, vocab) -> "WordpieceEncoder":
        self._vocab = list(vocab)
        return self

    def _transform(self, dataset: DataFrame) -> DataFrame:
        from ..utils.text import WordpieceTokenizer, build_vocab
        in_col = self.getOrDefault(self.inputCol)
        out_col = self.getOrDefault(self.outputCol)
        mask_col = self.getOrDefault(self.maskCol)
        max_len = self.getOrDefault(self.maxLen)
        rows = dataset.collect()
        texts = [str(r[in_col]) for r in rows]
        vocab = self._vocab
        if vocab is None:  # fit-free convenience: derive from this dataset
            vocab = build_vocab(texts)
            self._vocab = vocab
        tok = WordpieceTokenizer(vocab)
        ids, mask = tok.encode_batch(texts, max_len)
        out = []
        for r, i, m_ in zip(rows, ids, mask):
            out.append(Row(**{**r.asDict(),
                              out_col: Vectors.dense(i.astype(float)),
                              mask_col: Vectors.dense(m_.astype(float))}))
        cols = dataset.columns + [c for c in (out_col, mask_col)
                                  if c not in dataset.columns]
        return DataFrame(out, cols, dataset.num_partitions)


# ---------------------------------------------------------------------------
# round-2 widening: the rest of the pyspark.ml.feature subset a sparkflow user
# is likely to have in a Pipeline around the deep-learning stage. Semantics
# follow pyspark 2.4 (the reference's pinned Spark), cited per class.
# ---------------------------------------------------------------------------

# pyspark.ml.feature.StopWordsRemover.loadDefaultStopWords("english") subset —
# enough to be useful while staying compact; users can always setStopWords
_ENGLISH_STOP_WORDS = [
    "i", "me", "my", "myself", "we", "our", "ours", "ourselves", "you",
    "your", "yours", "he", "him", "his", "she", "her", "hers", "it", "its",
    "they", "them", "their", "theirs", "what", "which", "who", "whom",
    "this", "that", "these", "those", "am", "is", "are", "was", "were",
    "be", "been", "being", "have", "has", "had", "having", "do", "does",
    "did", "doing", "a", "an", "the", "and", "but", "if", "or", "because",
    "as", "until", "while", "of", "at", "by", "for", "with", "about",
    "against", "between", "into", "through", "during", "before", "after",
    "above", "below", "to", "from", "up", "down", "in", "out", "on", "off",
    "over", "under", "again", "further", "then", "once", "here", "there",
    "when", "where", "why", "how", "all", "any", "both", "each", "few",
    "more", "most", "other", "some", "such", "no", "nor", "not", "only",
    "own", "same", "so", "than", "too", "very", "s", "t", "can", "will",
    "just", "don", "should", "now",
]


def _with_col(dataset: DataFrame, out_col: str, values) -> DataFrame:
    rows = [Row(**{**r.asDict(), out_col: v})
            for r, v in zip(dataset.collect(), values)]
    cols = dataset.columns + ([out_col] if out_col not in dataset.columns
                              else [])
    return DataFrame(rows, cols, dataset.num_partitions)


class Tokenizer(Transformer, HasInputCol, HasOutputCol):
    """Lowercase + split on whitespace (pyspark.ml.feature.Tokenizer)."""

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None):
        super().__init__()
        self._set(**self._input_kwargs)

    def _transform(self, dataset: DataFrame) -> DataFrame:
        in_col = self.getOrDefault(self.inputCol)
        out_col = self.getOrDefault(self.outputCol)
        vals = [str(r[in_col]).lower().split() for r in dataset.collect()]
        return _with_col(dataset, out_col, vals)


class StopWordsRemover(Transformer, HasInputCol, HasOutputCol):
    """Filter stop words out of a string-array column. Also the class the
    pyspark persistence carrier abuses (reference ``pipeline_util.py:30-31``);
    here it is a real transformer."""

    stopWords = Param(Params._dummy(), "stopWords", "words to filter out",
                      typeConverter=TypeConverters.toListString)
    caseSensitive = Param(Params._dummy(), "caseSensitive",
                          "case sensitive comparison",
                          typeConverter=TypeConverters.toBoolean)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, stopWords=None,
                 caseSensitive=False):
        super().__init__()
        self._setDefault(stopWords=list(_ENGLISH_STOP_WORDS),
                         caseSensitive=False)
        self._set(**{k: v for k, v in self._input_kwargs.items()
                     if v is not None})

    @staticmethod
    def loadDefaultStopWords(language: str) -> List[str]:
        if language != "english":
            raise ValueError("only 'english' default stop words are bundled")
        return list(_ENGLISH_STOP_WORDS)

    def getStopWords(self) -> List[str]:
        return self.getOrDefault(self.stopWords)

    def setStopWords(self, value) -> "StopWordsRemover":
        self._set(stopWords=list(value))
        return self

    def _transform(self, dataset: DataFrame) -> DataFrame:
        in_col = self.getOrDefault(self.inputCol)
        out_col = self.getOrDefault(self.outputCol)
        cs = self.getOrDefault(self.caseSensitive)
        stop = set(self.getStopWords() if cs
                   else [w.lower() for w in self.getStopWords()])
        vals = []
        for r in dataset.collect():
            words = list(r[in_col])
            vals.append([w for w in words
                         if (w if cs else w.lower()) not in stop])
        return _with_col(dataset, out_col, vals)


class StringIndexerModel(Model, HasInputCol, HasOutputCol):
    def __init__(self, labels=None, handleInvalid="error"):
        super().__init__()
        self.labels: List[str] = list(labels or [])
        self._handle_invalid = handleInvalid

    def _transform(self, dataset: DataFrame) -> DataFrame:
        in_col = self.getOrDefault(self.inputCol)
        out_col = self.getOrDefault(self.outputCol)
        index = {v: float(i) for i, v in enumerate(self.labels)}
        rows, cols = [], dataset.columns + (
            [out_col] if out_col not in dataset.columns else [])
        for r in dataset.collect():
            v = str(r[in_col])
            if v in index:
                rows.append(Row(**{**r.asDict(), out_col: index[v]}))
            elif self._handle_invalid == "keep":
                rows.append(Row(**{**r.asDict(), out_col: float(len(index))}))
            elif self._handle_invalid == "skip":
                continue
            else:
                raise ValueError(f"Unseen label: {v!r} (StringIndexer "
                                 f"handleInvalid='error')")
        return DataFrame(rows, cols, dataset.num_partitions)


class StringIndexer(Estimator, HasInputCol, HasOutputCol):
    """Label string -> double index by descending frequency, ties broken
    alphabetically (pyspark 2.4 'frequencyDesc' order)."""

    handleInvalid = Param(Params._dummy(), "handleInvalid",
                          "error|skip|keep for unseen labels",
                          typeConverter=TypeConverters.toString)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, handleInvalid="error"):
        super().__init__()
        self._setDefault(handleInvalid="error")
        self._set(**{k: v for k, v in self._input_kwargs.items()
                     if v is not None})

    def _fit(self, dataset: DataFrame) -> StringIndexerModel:
        in_col = self.getOrDefault(self.inputCol)
        counts: dict = {}
        for r in dataset.collect():
            v = str(r[in_col])
            counts[v] = counts.get(v, 0) + 1
        labels = sorted(counts, key=lambda v: (-counts[v], v))
        m = StringIndexerModel(labels,
                               self.getOrDefault(self.handleInvalid))
        m._set(inputCol=in_col,
               outputCol=self.getOrDefault(self.outputCol))
        return m


class StandardScalerModel(Model, HasInputCol, HasOutputCol):
    def __init__(self, mean=None, std=None, with_mean=False, with_std=True):
        super().__init__()
        self.mean = np.asarray(mean) if mean is not None else None
        self.std = np.asarray(std) if std is not None else None
        self._with_mean, self._with_std = with_mean, with_std

    def _transform(self, dataset: DataFrame) -> DataFrame:
        in_col = self.getOrDefault(self.inputCol)
        out_col = self.getOrDefault(self.outputCol)
        vals = []
        for r in dataset.collect():
            arr = vector_to_array(r[in_col]).astype(float)
            if self._with_mean:
                arr = arr - self.mean
            if self._with_std:
                safe = np.where(self.std > 0, self.std, 1.0)
                arr = arr / safe
            vals.append(Vectors.dense(arr))
        return _with_col(dataset, out_col, vals)


class StandardScaler(Estimator, HasInputCol, HasOutputCol):
    """Unit-variance (and optionally zero-mean) scaling; std is the UNBIASED
    sample std, matching Spark MLlib."""

    withMean = Param(Params._dummy(), "withMean", "center before scaling",
                     typeConverter=TypeConverters.toBoolean)
    withStd = Param(Params._dummy(), "withStd", "scale to unit std",
                    typeConverter=TypeConverters.toBoolean)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, withMean=False,
                 withStd=True):
        super().__init__()
        self._setDefault(withMean=False, withStd=True)
        self._set(**{k: v for k, v in self._input_kwargs.items()
                     if v is not None})

    def _fit(self, dataset: DataFrame) -> StandardScalerModel:
        in_col = self.getOrDefault(self.inputCol)
        mat = np.stack([vector_to_array(r[in_col]).astype(float)
                        for r in dataset.collect()])
        mean = mat.mean(axis=0)
        std = mat.std(axis=0, ddof=1) if mat.shape[0] > 1 \
            else np.zeros(mat.shape[1])
        m = StandardScalerModel(mean, std,
                                self.getOrDefault(self.withMean),
                                self.getOrDefault(self.withStd))
        m._set(inputCol=in_col, outputCol=self.getOrDefault(self.outputCol))
        return m


class MinMaxScalerModel(Model, HasInputCol, HasOutputCol):
    def __init__(self, emin=None, emax=None, lo=0.0, hi=1.0):
        super().__init__()
        self.originalMin = np.asarray(emin) if emin is not None else None
        self.originalMax = np.asarray(emax) if emax is not None else None
        self._lo, self._hi = lo, hi

    def _transform(self, dataset: DataFrame) -> DataFrame:
        in_col = self.getOrDefault(self.inputCol)
        out_col = self.getOrDefault(self.outputCol)
        rng = self.originalMax - self.originalMin
        vals = []
        for r in dataset.collect():
            arr = vector_to_array(r[in_col]).astype(float)
            # constant features map to the midpoint (Spark semantics)
            scaled = np.where(
                rng != 0,
                (arr - self.originalMin) / np.where(rng != 0, rng, 1.0)
                * (self._hi - self._lo) + self._lo,
                0.5 * (self._hi + self._lo))
            vals.append(Vectors.dense(scaled))
        return _with_col(dataset, out_col, vals)


class MinMaxScaler(Estimator, HasInputCol, HasOutputCol):
    min = Param(Params._dummy(), "min", "lower bound after scaling",
                typeConverter=TypeConverters.toFloat)
    max = Param(Params._dummy(), "max", "upper bound after scaling",
                typeConverter=TypeConverters.toFloat)

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, min=0.0, max=1.0):
        super().__init__()
        self._setDefault(min=0.0, max=1.0)
        self._set(**{k: v for k, v in self._input_kwargs.items()
                     if v is not None})

    def _fit(self, dataset: DataFrame) -> MinMaxScalerModel:
        in_col = self.getOrDefault(self.inputCol)
        mat = np.stack([vector_to_array(r[in_col]).astype(float)
                        for r in dataset.collect()])
        m = MinMaxScalerModel(mat.min(axis=0), mat.max(axis=0),
                              self.getOrDefault(self.min),
                              self.getOrDefault(self.max))
        m._set(inputCol=in_col, outputCol=self.getOrDefault(self.outputCol))
        return m


class Bucketizer(Transformer, HasInputCol, HasOutputCol):
    """Map a continuous column into bucket indices given split points;
    the last bucket includes its upper bound (pyspark semantics)."""

    splits = Param(Params._dummy(), "splits", "bucket split points",
                   typeConverter=TypeConverters.toListFloat)
    handleInvalid = Param(Params._dummy(), "handleInvalid",
                          "error|skip|keep for NaN/null entries",
                          typeConverter=TypeConverters.toString)

    @keyword_only
    def __init__(self, splits=None, inputCol=None, outputCol=None,
                 handleInvalid="error"):
        super().__init__()
        self._setDefault(handleInvalid="error")
        self._set(**{k: v for k, v in self._input_kwargs.items()
                     if v is not None})

    def _transform(self, dataset: DataFrame) -> DataFrame:
        in_col = self.getOrDefault(self.inputCol)
        out_col = self.getOrDefault(self.outputCol)
        splits = list(self.getOrDefault(self.splits))
        hi_mode = self.getOrDefault(self.handleInvalid)
        n_buckets = len(splits) - 1
        rows, cols = [], dataset.columns + (
            [out_col] if out_col not in dataset.columns else [])
        for r in dataset.collect():
            raw = r[in_col]
            v = float("nan") if raw is None else float(raw)
            if np.isnan(v):
                # Spark 2.4: handleInvalid governs NaN AND null entries
                if hi_mode == "keep":
                    b = float(n_buckets)
                elif hi_mode == "skip":
                    continue
                else:
                    raise ValueError("NaN/null value in Bucketizer input "
                                     "(handleInvalid='error')")
            elif v == splits[-1]:
                b = float(n_buckets - 1)
            elif splits[0] <= v < splits[-1]:
                b = float(int(np.searchsorted(splits, v, side="right")) - 1)
            else:
                # out-of-range is an error regardless of handleInvalid
                # (Spark 2.4 semantics)
                raise ValueError(f"value {v} out of bucket range "
                                 f"[{splits[0]}, {splits[-1]}]")
            rows.append(Row(**{**r.asDict(), out_col: b}))
        return DataFrame(rows, cols, dataset.num_partitions)


class IndexToString(Transformer, HasInputCol, HasOutputCol):
    """Inverse of StringIndexer: double index -> label string. ``labels``
    may be given explicitly (pyspark uses column metadata, which the local
    engine doesn't carry — pass the fitted StringIndexerModel's labels)."""

    @keyword_only
    def __init__(self, inputCol=None, outputCol=None, labels=None):
        super().__init__()
        self._labels = list(labels) if labels is not None else None
        kw = dict(self._input_kwargs)
        kw.pop("labels", None)
        self._set(**{k: v for k, v in kw.items() if v is not None})

    def setLabels(self, labels) -> "IndexToString":
        self._labels = list(labels)
        return self

    def _transform(self, dataset: DataFrame) -> DataFrame:
        if not self._labels:
            raise ValueError("IndexToString needs labels= (the local engine "
                             "carries no column metadata)")
        in_col = self.getOrDefault(self.inputCol)
        out_col = self.getOrDefault(self.outputCol)
        vals = []
        for r in dataset.collect():
            i = int(r[in_col])
            if not 0 <= i < len(self._labels):
                raise ValueError(f"index {i} out of range for "
                                 f"{len(self._labels)} labels")
            vals.append(self._labels[i])
        return _with_col(dataset, out_col, vals)


class PCAModel(Model, HasInputCol, HasOutputCol):
    def __init__(self, pc=None, explained_variance=None):
        super().__init__()
        # principal components [n_features, k], column-major like pyspark
        self.pc = np.asarray(pc) if pc is not None else None
        self.explainedVariance = (list(explained_variance)
                                  if explained_variance is not None else [])

    def _transform(self, dataset: DataFrame) -> DataFrame:
        in_col = self.getOrDefault(self.inputCol)
        out_col = self.getOrDefault(self.outputCol)
        vals = [Vectors.dense(vector_to_array(r[in_col]).astype(float)
                              @ self.pc)
                for r in dataset.collect()]
        return _with_col(dataset, out_col, vals)


class PCA(Estimator, HasInputCol, HasOutputCol):
    """Project vectors onto the top-k principal components. Like Spark
    MLlib, inputs are NOT re-centered at transform time; the components are
    computed from the centered covariance (SVD of X - mean)."""

    k = Param(Params._dummy(), "k", "number of components",
              typeConverter=TypeConverters.toInt)

    @keyword_only
    def __init__(self, k=None, inputCol=None, outputCol=None):
        super().__init__()
        self._set(**{k_: v for k_, v in self._input_kwargs.items()
                     if v is not None})

    def getK(self) -> int:
        return self.getOrDefault(self.k)

    def _fit(self, dataset: DataFrame) -> PCAModel:
        k = self.getK()
        mat = np.stack([vector_to_array(r[self.getOrDefault(self.inputCol)])
                        .astype(float) for r in dataset.collect()])
        if k > mat.shape[1]:
            raise ValueError(f"k={k} > n_features={mat.shape[1]}")
        centered = mat - mat.mean(axis=0)
        _, svals, vt = np.linalg.svd(centered, full_matrices=False)
        var = (svals ** 2) / max(mat.shape[0] - 1, 1)
        ratio = var / var.sum() if var.sum() > 0 else var
        m = PCAModel(vt[:k].T, ratio[:k])
        m._set(inputCol=self.getOrDefault(self.inputCol),
               outputCol=self.getOrDefault(self.outputCol))
        return m


class ImputerModel(Model):
    def __init__(self, surrogates=None, input_cols=None, output_cols=None):
        super().__init__()
        self.surrogates = dict(surrogates or {})
        self._in = list(input_cols or [])
        self._out = list(output_cols or [])

    def _transform(self, dataset: DataFrame) -> DataFrame:
        out = dataset
        for ic, oc in zip(self._in, self._out):
            vals = []
            for r in out.collect():
                v = r[ic]
                bad = v is None or (isinstance(v, float) and v != v)
                vals.append(self.surrogates[ic] if bad else float(v))
            out = _with_col(out, oc, vals)
        return out


class Imputer(Estimator):
    """Replace missing values (null/NaN) in numeric columns with the
    column's mean or median (pyspark.ml.feature.Imputer)."""

    inputCols = Param(Params._dummy(), "inputCols", "columns to impute",
                      typeConverter=TypeConverters.toListString)
    outputCols = Param(Params._dummy(), "outputCols", "imputed columns",
                       typeConverter=TypeConverters.toListString)
    strategy = Param(Params._dummy(), "strategy", "mean|median",
                     typeConverter=TypeConverters.toString)

    @keyword_only
    def __init__(self, inputCols=None, outputCols=None, strategy="mean"):
        super().__init__()
        self._setDefault(strategy="mean")
        self._set(**{k: v for k, v in self._input_kwargs.items()
                     if v is not None})

    def _fit(self, dataset: DataFrame) -> ImputerModel:
        ics = self.getOrDefault(self.inputCols)
        ocs = self.getOrDefault(self.outputCols)
        strat = self.getOrDefault(self.strategy)
        if strat not in ("mean", "median"):
            raise ValueError(f"strategy must be mean|median, got {strat!r}")
        if len(ics) != len(ocs):
            raise ValueError("inputCols and outputCols must align")
        surrogates = {}
        for c in ics:
            good = [float(r[c]) for r in dataset.collect()
                    if r[c] is not None
                    and not (isinstance(r[c], float) and r[c] != r[c])]
            if not good:
                raise ValueError(f"column {c!r} has no non-missing values")
            surrogates[c] = (float(np.mean(good)) if strat == "mean"
                             else float(np.median(good)))
        return ImputerModel(surrogates, ics, ocs)
