"""localml: a pyspark-ml-compatible local engine — the port's carried copy
of the JAX package's ``localml`` (same classes, same persistence format).

The reference framework's public surface is the Spark ML API — ``Estimator`` /
``Model`` / ``Pipeline`` with ``Param``s (``sparkflow/tensorflow_async.py``). This
package provides an API-compatible local implementation of the subset sparkflow
uses, so the framework runs standalone (no JVM, no pyspark install) with the
*same user code*; when pyspark is importable, :mod:`sparkflow_tpu_torch.compat` selects
the real pyspark classes instead and this package is unused.

Implemented subset (names and behavior match pyspark 2.4-3.x where the reference
touches them):

- ``param``:       ``Param``, ``Params``, ``TypeConverters``, ``keyword_only``
- ``base``:        ``Estimator``, ``Transformer``, ``Model``, ``Identifiable``,
                   ``MLReadable``, ``MLWritable``
- ``linalg``:      ``Vectors``, ``DenseVector``, ``SparseVector``
- ``sql``:         ``Row``, ``DataFrame``, ``RDD``, ``LocalSession``, ``functions.rand``
- ``feature``:     ``VectorAssembler``, ``OneHotEncoder``, ``Normalizer``,
                   ``Tokenizer``, ``StopWordsRemover``, ``StringIndexer``,
                   ``StandardScaler``, ``MinMaxScaler``, ``Bucketizer``
- ``pipeline``:    ``Pipeline``, ``PipelineModel``
- ``evaluation``:  ``MulticlassClassificationEvaluator``,
                   ``BinaryClassificationEvaluator``
- ``tuning``:      ``ParamGridBuilder``, ``CrossValidator``,
                   ``TrainValidationSplit``
"""

from .param import Param, Params, TypeConverters, keyword_only
from .base import Estimator, Transformer, Model, Identifiable, MLReadable, MLWritable
from .linalg import Vectors, DenseVector, SparseVector
from .sql import Row, DataFrame, RDD, LocalSession
from .feature import (VectorAssembler, OneHotEncoder, Normalizer,
                      WordpieceEncoder, Tokenizer, StopWordsRemover,
                      StringIndexer, StringIndexerModel,
                      StandardScaler, StandardScalerModel,
                      MinMaxScaler, MinMaxScalerModel, Bucketizer,
                      IndexToString, PCA, PCAModel, Imputer,
                      ImputerModel)
from .pipeline import Pipeline, PipelineModel
from .evaluation import (MulticlassClassificationEvaluator,
                         BinaryClassificationEvaluator,
                         RegressionEvaluator)
from .tuning import (ParamGridBuilder, CrossValidator, CrossValidatorModel,
                     TrainValidationSplit, TrainValidationSplitModel)

__all__ = [
    "Param", "Params", "TypeConverters", "keyword_only",
    "Estimator", "Transformer", "Model", "Identifiable", "MLReadable", "MLWritable",
    "Vectors", "DenseVector", "SparseVector",
    "Row", "DataFrame", "RDD", "LocalSession",
    "VectorAssembler", "WordpieceEncoder", "OneHotEncoder", "Normalizer",
    "Tokenizer", "StopWordsRemover", "StringIndexer", "StringIndexerModel",
    "StandardScaler", "StandardScalerModel", "MinMaxScaler",
    "MinMaxScalerModel", "Bucketizer",
    "Pipeline", "PipelineModel",
    "MulticlassClassificationEvaluator", "BinaryClassificationEvaluator",
    "RegressionEvaluator", "IndexToString", "PCA", "PCAModel",
    "Imputer", "ImputerModel",
    "ParamGridBuilder", "CrossValidator", "CrossValidatorModel",
    "TrainValidationSplit", "TrainValidationSplitModel",
]
