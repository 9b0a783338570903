"""Engine facade: real pyspark when importable, localml otherwise (carried
from the JAX package unchanged, imports rewired).

The estimator layer (``sparkflow_tpu_torch.spark_async``) imports every Spark ML symbol
from here, so the same class definitions drop into a genuine
``pyspark.ml.Pipeline`` on a cluster (reference behavior,
``sparkflow/tensorflow_async.py:1-14``) or run standalone on
:mod:`sparkflow_tpu_torch.localml` when pyspark isn't installed.
``USING_PYSPARK`` tells persistence which wire path to use.
"""

from __future__ import annotations

try:  # covered by the pyspark CI job (make test-pyspark); absent locally
    from pyspark import keyword_only
    from pyspark.ml import Model
    from pyspark.ml.base import Estimator, Transformer
    from pyspark.ml.linalg import DenseVector, SparseVector, Vectors
    from pyspark.ml.param import Param, Params, TypeConverters
    from pyspark.ml.param.shared import (HasInputCol, HasLabelCol,
                                         HasPredictionCol)
    from pyspark.ml.pipeline import Pipeline, PipelineModel
    from pyspark.ml.util import Identifiable, MLReadable, MLWritable
    from pyspark.sql import Row

    USING_PYSPARK = True
except ImportError:
    from .localml.base import (Estimator, Identifiable, MLReadable,  # noqa: F401
                               MLWritable, Model, Transformer)
    from .localml.linalg import DenseVector, SparseVector, Vectors  # noqa: F401
    from .localml.param import (HasInputCol, HasLabelCol,  # noqa: F401
                                HasPredictionCol, Param, Params, TypeConverters,
                                keyword_only)
    from .localml.pipeline import Pipeline, PipelineModel  # noqa: F401
    from .localml.sql import Row  # noqa: F401

    USING_PYSPARK = False

__all__ = [
    "Estimator", "Transformer", "Model", "Identifiable", "MLReadable", "MLWritable",
    "Param", "Params", "TypeConverters", "keyword_only",
    "HasInputCol", "HasLabelCol", "HasPredictionCol",
    "Pipeline", "PipelineModel", "Vectors", "DenseVector", "SparseVector", "Row",
    "USING_PYSPARK",
]
