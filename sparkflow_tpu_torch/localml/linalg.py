"""Dense/sparse vectors, API-compatible with ``pyspark.ml.linalg``.

The reference consumes feature columns of Spark ML vectors (dense or sparse —
``tests/dl_runner.py:164-185`` exercises ``Vectors.sparse``) and emits
``Vectors.dense`` predictions (``sparkflow/ml_util.py:74-81``).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


class DenseVector:
    __slots__ = ("values",)

    def __init__(self, values):
        self.values = np.asarray(values, dtype=np.float64)

    def toArray(self) -> np.ndarray:
        return self.values

    @property
    def size(self) -> int:
        return self.values.shape[0]

    def __len__(self):
        return self.values.shape[0]

    def __getitem__(self, i):
        return self.values[i]

    def __iter__(self):
        return iter(self.values)

    def __eq__(self, other):
        if isinstance(other, (DenseVector, SparseVector)):
            return np.array_equal(self.toArray(), other.toArray())
        return NotImplemented

    def __repr__(self):
        return f"DenseVector({self.values.tolist()})"


class SparseVector:
    __slots__ = ("_size", "indices", "values")

    def __init__(self, size: int, indices, values=None):
        if values is None and isinstance(indices, dict):
            items = sorted(indices.items())
            indices = [i for i, _ in items]
            values = [v for _, v in items]
        self._size = int(size)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.values = np.asarray(values, dtype=np.float64)

    @property
    def size(self) -> int:
        return self._size

    def toArray(self) -> np.ndarray:
        arr = np.zeros(self._size, dtype=np.float64)
        arr[self.indices] = self.values
        return arr

    def __len__(self):
        return self._size

    def __getitem__(self, i):
        pos = np.searchsorted(self.indices, i)
        if pos < len(self.indices) and self.indices[pos] == i:
            return self.values[pos]
        return 0.0

    def __eq__(self, other):
        if isinstance(other, (DenseVector, SparseVector)):
            return np.array_equal(self.toArray(), other.toArray())
        return NotImplemented

    def __repr__(self):
        return (f"SparseVector({self._size}, {self.indices.tolist()}, "
                f"{self.values.tolist()})")


class Vectors:
    @staticmethod
    def dense(*values) -> DenseVector:
        if len(values) == 1 and isinstance(values[0], (list, tuple, np.ndarray)):
            values = values[0]
        return DenseVector(values)

    @staticmethod
    def sparse(size: int, indices, values=None) -> SparseVector:
        return SparseVector(size, indices, values)


def vector_to_array(v) -> np.ndarray:
    """Coerce any supported feature value (localml or pyspark vector, list,
    ndarray, scalar) to a 1-D float array."""
    if hasattr(v, "toArray"):
        return np.asarray(v.toArray(), dtype=np.float64)
    if isinstance(v, (list, tuple, np.ndarray)):
        return np.asarray(v, dtype=np.float64)
    return np.asarray([v], dtype=np.float64)
