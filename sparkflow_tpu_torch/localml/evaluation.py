"""Evaluators: the subset the reference examples use
(``MulticlassClassificationEvaluator`` with accuracy,
``examples/simple_dnn.py:71-74``)."""

from __future__ import annotations

import numpy as np

from .param import Param, Params, TypeConverters, keyword_only, HasLabelCol, HasPredictionCol


class MulticlassClassificationEvaluator(HasLabelCol, HasPredictionCol):
    metricName = Param(Params._dummy(), "metricName", "metric name",
                       typeConverter=TypeConverters.toString)

    @keyword_only
    def __init__(self, labelCol="label", predictionCol="prediction",
                 metricName="f1"):
        super().__init__()
        self._setDefault(labelCol="label", predictionCol="prediction", metricName="f1")
        kwargs = self._input_kwargs
        self._set(**kwargs)

    def isLargerBetter(self) -> bool:
        return True  # accuracy / f1 both improve upward

    def evaluate(self, dataset) -> float:
        label_col = self.getOrDefault(self.labelCol)
        pred_col = self.getOrDefault(self.predictionCol)
        metric = self.getOrDefault(self.metricName)
        y = np.array([float(r[label_col]) for r in dataset.collect()])
        p = np.array([float(r[pred_col]) for r in dataset.collect()])
        if metric == "accuracy":
            return float((y == p).mean()) if len(y) else 0.0
        if metric == "f1":  # weighted f1
            classes = np.unique(np.concatenate([y, p]))
            f1s, weights = [], []
            for c in classes:
                tp = float(((p == c) & (y == c)).sum())
                fp = float(((p == c) & (y != c)).sum())
                fn = float(((p != c) & (y == c)).sum())
                prec = tp / (tp + fp) if tp + fp else 0.0
                rec = tp / (tp + fn) if tp + fn else 0.0
                f1s.append(2 * prec * rec / (prec + rec) if prec + rec else 0.0)
                weights.append(float((y == c).sum()))
            return float(np.average(f1s, weights=weights)) if weights else 0.0
        raise ValueError(f"unsupported metric {metric!r}")


class BinaryClassificationEvaluator(HasLabelCol, HasPredictionCol):
    """areaUnderROC / areaUnderPR over a score column
    (pyspark.ml.evaluation.BinaryClassificationEvaluator). The score column
    (``rawPredictionCol``) may hold floats or vectors — for vectors the last
    component is the positive-class score, matching how sparkflow models
    emit probabilities (reference ``ml_util.py:74-81``)."""

    rawPredictionCol = Param(Params._dummy(), "rawPredictionCol",
                             "score column",
                             typeConverter=TypeConverters.toString)
    metricName = Param(Params._dummy(), "metricName", "metric name",
                       typeConverter=TypeConverters.toString)

    @keyword_only
    def __init__(self, rawPredictionCol="rawPrediction", labelCol="label",
                 metricName="areaUnderROC"):
        super().__init__()
        self._setDefault(rawPredictionCol="rawPrediction", labelCol="label",
                         metricName="areaUnderROC")
        self._set(**self._input_kwargs)

    def isLargerBetter(self) -> bool:
        return True  # both AUC metrics improve upward

    @staticmethod
    def _score(v) -> float:
        arr = np.atleast_1d(np.asarray(
            v.toArray() if hasattr(v, "toArray") else v, dtype=float))
        return float(arr[-1])

    def evaluate(self, dataset) -> float:
        label_col = self.getOrDefault(self.labelCol)
        score_col = self.getOrDefault(self.rawPredictionCol)
        metric = self.getOrDefault(self.metricName)
        rows = dataset.collect()
        y = np.array([float(r[label_col]) for r in rows])
        s = np.array([self._score(r[score_col]) for r in rows])
        if len(y) == 0 or len(np.unique(y)) < 2:
            return 0.0
        order = np.argsort(-s, kind="stable")
        y, s = y[order], s[order]
        tp = np.cumsum(y == 1)
        fp = np.cumsum(y == 0)
        # one curve point per DISTINCT score threshold (keep the last
        # cumulative count in each tie group) — otherwise tied scores make
        # the metric row-order-dependent; with collapsed ties the trapezoid
        # gives ties half credit (Mann-Whitney), matching Spark/sklearn
        last_of_group = np.concatenate([s[1:] != s[:-1], [True]])
        tp, fp = tp[last_of_group], fp[last_of_group]
        P, N = tp[-1], fp[-1]
        tpr = np.concatenate([[0.0], tp / P])
        fpr = np.concatenate([[0.0], fp / N])
        # np.trapezoid is numpy>=2 only; np.trapz its 1.x name
        _trapz = getattr(np, "trapezoid", None) or np.trapz
        if metric == "areaUnderROC":
            return float(_trapz(tpr, fpr))
        if metric == "areaUnderPR":
            prec = np.concatenate([[1.0], tp / np.maximum(tp + fp, 1)])
            rec = np.concatenate([[0.0], tp / P])
            return float(_trapz(prec, rec))
        raise ValueError(f"unsupported metric {metric!r}")


class RegressionEvaluator(HasLabelCol, HasPredictionCol):
    """rmse (default) / mse / mae / r2 over a numeric prediction column
    (pyspark.ml.evaluation.RegressionEvaluator)."""

    metricName = Param(Params._dummy(), "metricName", "metric name",
                       typeConverter=TypeConverters.toString)

    @keyword_only
    def __init__(self, predictionCol="prediction", labelCol="label",
                 metricName="rmse"):
        super().__init__()
        self._setDefault(predictionCol="prediction", labelCol="label",
                         metricName="rmse")
        self._set(**self._input_kwargs)

    def isLargerBetter(self) -> bool:
        # errors shrink toward better; r2 grows
        return self.getOrDefault(self.metricName) == "r2"

    def evaluate(self, dataset) -> float:
        label_col = self.getOrDefault(self.labelCol)
        pred_col = self.getOrDefault(self.predictionCol)
        metric = self.getOrDefault(self.metricName)
        rows = dataset.collect()
        y = np.array([float(r[label_col]) for r in rows])
        p = np.array([float(r[pred_col]) for r in rows])
        if len(y) == 0:
            return 0.0
        err = y - p
        if metric == "mse":
            return float(np.mean(err ** 2))
        if metric == "rmse":
            return float(np.sqrt(np.mean(err ** 2)))
        if metric == "mae":
            return float(np.mean(np.abs(err)))
        if metric == "r2":
            ss_tot = float(np.sum((y - y.mean()) ** 2))
            ss_res = float(np.sum(err ** 2))
            return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
        raise ValueError(f"unsupported metric {metric!r}")
