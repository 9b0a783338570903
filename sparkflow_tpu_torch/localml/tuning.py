"""Model selection: the ``pyspark.ml.tuning`` subset (ParamGridBuilder,
CrossValidator, TrainValidationSplit).

The reference lists "Hyperopt implementation" as future work it never built
(reference ``README.md:234-236``); here grid search over any Estimator —
including ``SparkAsyncDL`` — is first-class. Fits run sequentially on the
local engine.

Semantics follow pyspark 2.4: CrossValidator averages the evaluator metric
over k folds per param map and refits the best map on the full dataset;
TrainValidationSplit evaluates each map once on a held-out split. Whether a
larger metric is better comes from the evaluator's ``isLargerBetter()``
(all localml evaluators: True).
"""

from __future__ import annotations

import itertools
import random as _random
from typing import Any, Dict, List

import numpy as np

from .base import Estimator, Model
from .param import Param, Params, TypeConverters, keyword_only
from .sql import DataFrame


class ParamGridBuilder:
    """Builds a list of param maps (the cartesian product of the grids)."""

    def __init__(self):
        self._grid: Dict[Any, List[Any]] = {}

    def addGrid(self, param, values) -> "ParamGridBuilder":
        self._grid[param] = list(values)
        return self

    def baseOn(self, *args) -> "ParamGridBuilder":
        """Fixed (param, value) pairs included in every map."""
        if len(args) == 1 and isinstance(args[0], dict):
            pairs = args[0].items()
        else:
            pairs = args
        for param, value in pairs:
            self._grid[param] = [value]
        return self

    def build(self) -> List[Dict[Any, Any]]:
        keys = list(self._grid)
        out = []
        for combo in itertools.product(*(self._grid[k] for k in keys)):
            out.append(dict(zip(keys, combo)))
        return out or [{}]


class _ValidatorParams(Params):
    numFolds = Param(Params._dummy(), "numFolds", "number of folds",
                     typeConverter=TypeConverters.toInt)
    trainRatio = Param(Params._dummy(), "trainRatio", "train fraction",
                       typeConverter=TypeConverters.toFloat)
    seed = Param(Params._dummy(), "seed", "random seed",
                 typeConverter=TypeConverters.toInt)

    def __init__(self):
        super().__init__()
        self.estimator = None
        self.estimatorParamMaps = None
        self.evaluator = None

    def _is_larger_better(self) -> bool:
        fn = getattr(self.evaluator, "isLargerBetter", None)
        return bool(fn()) if callable(fn) else True

    def _fit_and_eval(self, pm, train_df, eval_df) -> float:
        model = self.estimator.copy(pm)._fit(train_df)
        return float(self.evaluator.evaluate(model.transform(eval_df)))

    def _pick_best(self, metrics: List[float]) -> int:
        arr = np.asarray(metrics, dtype=float)
        return int(np.argmax(arr) if self._is_larger_better()
                   else np.argmin(arr))


def _shuffled_rows(df: DataFrame, seed) -> list:
    rows = df.collect()
    _random.Random(seed).shuffle(rows)
    return rows


class CrossValidatorModel(Model):
    def __init__(self, bestModel=None, avgMetrics=None):
        super().__init__()
        self.bestModel = bestModel
        self.avgMetrics = list(avgMetrics or [])

    def _transform(self, dataset: DataFrame) -> DataFrame:
        return self.bestModel.transform(dataset)


class CrossValidator(Estimator, _ValidatorParams):
    """k-fold grid search: avg metric per param map, best map refit on the
    full dataset (pyspark.ml.tuning.CrossValidator semantics)."""

    @keyword_only
    def __init__(self, estimator=None, estimatorParamMaps=None,
                 evaluator=None, numFolds=3, seed=None):
        super().__init__()
        self._setDefault(numFolds=3)
        kw = self._input_kwargs
        self.estimator = kw.pop("estimator", None)
        self.estimatorParamMaps = kw.pop("estimatorParamMaps", None)
        self.evaluator = kw.pop("evaluator", None)
        self._set(**{k: v for k, v in kw.items() if v is not None})

    def _fit(self, dataset: DataFrame) -> CrossValidatorModel:
        if not (self.estimator and self.estimatorParamMaps and self.evaluator):
            raise ValueError("CrossValidator needs estimator, "
                             "estimatorParamMaps and evaluator")
        k = self.getOrDefault(self.numFolds)
        if k < 2:
            raise ValueError(f"numFolds must be >= 2, got {k}")
        rows = _shuffled_rows(dataset, self.getOrDefault(self.seed)
                              if self.isSet(self.seed) else None)
        n = len(rows)
        folds = [rows[int(i * n / k):int((i + 1) * n / k)] for i in range(k)]
        metrics = []
        for pm in self.estimatorParamMaps:
            scores = []
            for i in range(k):
                train = [r for j, f in enumerate(folds) if j != i for r in f]
                train_df = DataFrame(train, dataset.columns,
                                     dataset.num_partitions)
                eval_df = DataFrame(folds[i], dataset.columns,
                                    dataset.num_partitions)
                scores.append(self._fit_and_eval(pm, train_df, eval_df))
            metrics.append(float(np.mean(scores)))
        best = self._pick_best(metrics)
        best_model = self.estimator.copy(
            self.estimatorParamMaps[best])._fit(dataset)
        return CrossValidatorModel(best_model, metrics)


class TrainValidationSplitModel(Model):
    def __init__(self, bestModel=None, validationMetrics=None):
        super().__init__()
        self.bestModel = bestModel
        self.validationMetrics = list(validationMetrics or [])

    def _transform(self, dataset: DataFrame) -> DataFrame:
        return self.bestModel.transform(dataset)


class TrainValidationSplit(Estimator, _ValidatorParams):
    """Single held-out split grid search; cheaper than k-fold."""

    @keyword_only
    def __init__(self, estimator=None, estimatorParamMaps=None,
                 evaluator=None, trainRatio=0.75, seed=None):
        super().__init__()
        self._setDefault(trainRatio=0.75)
        kw = self._input_kwargs
        self.estimator = kw.pop("estimator", None)
        self.estimatorParamMaps = kw.pop("estimatorParamMaps", None)
        self.evaluator = kw.pop("evaluator", None)
        self._set(**{k: v for k, v in kw.items() if v is not None})

    def _fit(self, dataset: DataFrame) -> TrainValidationSplitModel:
        if not (self.estimator and self.estimatorParamMaps and self.evaluator):
            raise ValueError("TrainValidationSplit needs estimator, "
                             "estimatorParamMaps and evaluator")
        ratio = self.getOrDefault(self.trainRatio)
        if not 0.0 < ratio < 1.0:
            raise ValueError(f"trainRatio must be in (0, 1), got {ratio}")
        rows = _shuffled_rows(dataset, self.getOrDefault(self.seed)
                              if self.isSet(self.seed) else None)
        cut = int(round(len(rows) * ratio))
        train_df = DataFrame(rows[:cut], dataset.columns,
                             dataset.num_partitions)
        eval_df = DataFrame(rows[cut:], dataset.columns,
                            dataset.num_partitions)
        metrics = [self._fit_and_eval(pm, train_df, eval_df)
                   for pm in self.estimatorParamMaps]
        best = self._pick_best(metrics)
        best_model = self.estimator.copy(
            self.estimatorParamMaps[best])._fit(dataset)
        return TrainValidationSplitModel(best_model, metrics)
