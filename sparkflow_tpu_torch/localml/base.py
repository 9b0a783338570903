"""Estimator/Transformer/Model base classes + save/load, like ``pyspark.ml.base``.

Persistence here is the localml-native path: a directory with ``metadata.json``
naming the class and a dill payload of the instance (the pyspark backend instead
uses the StopWordsRemover carrier trick — see ``sparkflow_tpu_torch/pipeline_util.py``).
"""

from __future__ import annotations

import importlib
import json
import os
import zlib
from typing import Any

import dill

from .param import Identifiable, Params

_FORMAT = "sparkflow-tpu-localml"


class _Writer:
    def __init__(self, instance):
        self.instance = instance
        self._overwrite = False

    def overwrite(self):
        self._overwrite = True
        return self

    def save(self, path: str):
        if os.path.exists(path):
            if not self._overwrite:
                raise IOError(f"path {path} already exists; use .overwrite()")
        os.makedirs(path, exist_ok=True)
        payload = zlib.compress(dill.dumps(self.instance))
        cls = type(self.instance)
        meta = {
            "format": _FORMAT,
            "class": f"{cls.__module__}.{cls.__qualname__}",
            "uid": getattr(self.instance, "uid", None),
        }
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(path, "stage.dill.z"), "wb") as f:
            f.write(payload)


class _Reader:
    def __init__(self, cls):
        self.cls = cls

    def load(self, path: str):
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        if meta.get("format") != _FORMAT:
            raise IOError(f"{path} is not a {_FORMAT} save")
        with open(os.path.join(path, "stage.dill.z"), "rb") as f:
            obj = dill.loads(zlib.decompress(f.read()))
        return obj


class MLWritable:
    def write(self):
        return _Writer(self)

    def save(self, path: str):
        self.write().save(path)


class MLReadable:
    @classmethod
    def read(cls):
        return _Reader(cls)

    @classmethod
    def load(cls, path: str):
        return cls.read().load(path)


# MLReadable/MLWritable precede Params so user classes can re-list them AFTER
# Identifiable-bearing mixins (the reference's class declarations do exactly
# that: ``class SparkAsyncDLModel(Model, ..., MLReadable, MLWritable,
# Identifiable)``, sparkflow/tensorflow_async.py:51) without C3 conflicts.
class Transformer(MLReadable, MLWritable, Params):
    def _transform(self, dataset):
        raise NotImplementedError

    def transform(self, dataset, params=None):
        if params:
            return self.copy(params)._transform(dataset)
        return self._transform(dataset)


class Estimator(MLReadable, MLWritable, Params):
    def _fit(self, dataset):
        raise NotImplementedError

    def fit(self, dataset, params=None):
        if params:
            return self.copy(params)._fit(dataset)
        return self._fit(dataset)


class Model(Transformer):
    """A fitted Transformer (pyspark.ml.Model analog)."""
