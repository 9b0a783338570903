"""Row / RDD / DataFrame / session: the ``pyspark.sql`` subset sparkflow touches.

The reference drives training through ``df.rdd.map``, ``coalesce``,
``foreachPartition`` and inference through ``rdd.mapPartitions(...).toDF()``
(``sparkflow/tensorflow_async.py:90-99,290-291``; ``HogwildSparkModel.py:259``).
This local engine keeps those exact call shapes over in-process lists, with
logical partitions standing in for Spark executors — the multi-device mesh is
the real parallelism substrate underneath.
"""

from __future__ import annotations

import csv as _csv
import json as _json
import os as _os
import random as _random
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np


class Row:
    """Named-field record, pyspark-Row-compatible (attr + item access, asDict)."""

    __slots__ = ("__fields__", "__values__")

    def __init__(self, **kwargs):
        object.__setattr__(self, "__fields__", list(kwargs.keys()))
        object.__setattr__(self, "__values__", list(kwargs.values()))

    def asDict(self) -> Dict[str, Any]:
        return dict(zip(self.__fields__, self.__values__))

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.__values__[key]
        try:
            return self.__values__[self.__fields__.index(key)]
        except ValueError:
            raise KeyError(key)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        try:
            return self.__values__[self.__fields__.index(name)]
        except ValueError:
            raise AttributeError(name)

    def __contains__(self, key):
        return key in self.__fields__

    def __len__(self):
        return len(self.__values__)

    def __iter__(self):
        return iter(self.__values__)

    def __eq__(self, other):
        return isinstance(other, Row) and self.asDict() == other.asDict()

    def __repr__(self):
        kv = ", ".join(f"{f}={v!r}" for f, v in zip(self.__fields__, self.__values__))
        return f"Row({kv})"


def _slice(items: List[Any], n: int) -> List[List[Any]]:
    n = max(1, min(n, len(items)) if items else 1)
    base, extra = divmod(len(items), n)
    out, i = [], 0
    for k in range(n):
        size = base + (1 if k < extra else 0)
        out.append(items[i:i + size])
        i += size
    return out


class RDD:
    """A list with logical partitions; mirrors the RDD methods sparkflow uses."""

    def __init__(self, items: List[Any], num_partitions: int = 1):
        self.items = list(items)
        self.num_partitions = max(1, num_partitions)

    # -- transforms ---------------------------------------------------------

    def map(self, f: Callable) -> "RDD":
        return RDD([f(x) for x in self.items], self.num_partitions)

    def mapPartitions(self, f: Callable) -> "RDD":
        out: List[Any] = []
        for part in _slice(self.items, self.num_partitions):
            out.extend(f(iter(part)))
        return RDD(out, self.num_partitions)

    def foreachPartition(self, f: Callable) -> None:
        for part in _slice(self.items, self.num_partitions):
            f(iter(part))

    def coalesce(self, n: int) -> "RDD":
        return RDD(self.items, min(self.num_partitions, max(1, n)))

    def persist(self, *_a) -> "RDD":
        return self  # local lists are always materialized

    def unpersist(self, *_a) -> "RDD":
        return self

    def repartition(self, n: int) -> "RDD":
        items = list(self.items)
        _random.Random(17).shuffle(items)
        return RDD(items, max(1, n))

    # -- actions ------------------------------------------------------------

    def collect(self) -> List[Any]:
        return list(self.items)

    def toLocalIterator(self) -> Iterator[Any]:
        """Partition-by-partition generator (pyspark's streaming action: the
        driver holds one partition at a time, never the whole dataset)."""
        for part in _slice(self.items, self.num_partitions):
            for x in part:
                yield x

    def count(self) -> int:
        return len(self.items)

    def getNumPartitions(self) -> int:
        return self.num_partitions

    def toDF(self, schema: Optional[Sequence[str]] = None) -> "DataFrame":
        if not self.items:
            return DataFrame([], list(schema) if schema else [])
        rows = [x if isinstance(x, Row) else Row(**x) if isinstance(x, dict)
                else Row(**{c: v for c, v in zip(schema, x)}) for x in self.items]
        return DataFrame(rows, rows[0].__fields__, self.num_partitions)


class _RandOrder:
    """Sentinel returned by functions.rand() for orderBy-shuffles."""

    def __init__(self, seed: Optional[int] = None):
        self.seed = seed


class functions:
    @staticmethod
    def rand(seed: Optional[int] = None) -> _RandOrder:
        return _RandOrder(seed)


class DataFrame:
    """Immutable list-of-Rows table with logical partitions."""

    def __init__(self, rows: List[Row], columns: List[str], num_partitions: int = 4):
        self._rows = rows
        self.columns = list(columns)
        self.num_partitions = max(1, num_partitions)

    @property
    def rdd(self) -> RDD:
        return RDD(self._rows, self.num_partitions)

    def select(self, *cols) -> "DataFrame":
        if len(cols) == 1 and isinstance(cols[0], (list, tuple)):
            cols = tuple(cols[0])
        rows = [Row(**{c: r[c] for c in cols}) for r in self._rows]
        return DataFrame(rows, list(cols), self.num_partitions)

    def withColumn(self, name: str, values: Sequence[Any]) -> "DataFrame":
        """localml extension: attach a computed column (no Column expressions)."""
        rows = [Row(**{**r.asDict(), name: v}) for r, v in zip(self._rows, values)]
        cols = self.columns + ([name] if name not in self.columns else [])
        return DataFrame(rows, cols, self.num_partitions)

    def orderBy(self, *exprs) -> "DataFrame":
        rows = list(self._rows)
        if exprs and isinstance(exprs[0], _RandOrder):
            _random.Random(exprs[0].seed).shuffle(rows)
        elif exprs:
            rows.sort(key=lambda r: tuple(r[c] for c in exprs))
        return DataFrame(rows, self.columns, self.num_partitions)

    def repartition(self, n: int) -> "DataFrame":
        return DataFrame(self._rows, self.columns, max(1, n))

    def coalesce(self, n: int) -> "DataFrame":
        return DataFrame(self._rows, self.columns,
                         min(self.num_partitions, max(1, n)))

    def collect(self) -> List[Row]:
        return list(self._rows)

    def take(self, n: int) -> List[Row]:
        return self._rows[:n]

    def first(self) -> Optional[Row]:
        return self._rows[0] if self._rows else None

    def count(self) -> int:
        return len(self._rows)

    def show(self, n: int = 20) -> None:
        print(" | ".join(self.columns))
        for r in self._rows[:n]:
            print(" | ".join(str(r[c]) for c in self.columns))

    def filter(self, pred) -> "DataFrame":
        """localml: ``pred`` is a callable Row -> bool (no Column exprs)."""
        if not callable(pred):
            raise TypeError("localml filter() takes a callable Row -> bool")
        rows = [r for r in self._rows if pred(r)]
        return DataFrame(rows, self.columns, self.num_partitions)

    where = filter

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self._rows[:n], self.columns, self.num_partitions)

    def union(self, other: "DataFrame") -> "DataFrame":
        if list(other.columns) != list(self.columns):
            raise ValueError(f"union: column mismatch {self.columns} vs "
                             f"{other.columns}")
        return DataFrame(self._rows + other.collect(), self.columns,
                         self.num_partitions)

    def sample(self, withReplacement=None, fraction=None, seed=None
               ) -> "DataFrame":
        # pyspark also allows sample(fraction) / sample(fraction, seed)
        if isinstance(withReplacement, float):
            withReplacement, fraction, seed = False, withReplacement, fraction
        rng = _random.Random(seed)
        if withReplacement:
            k = int(round(len(self._rows) * float(fraction)))
            rows = [rng.choice(self._rows) for _ in range(k)] if self._rows else []
        else:
            rows = [r for r in self._rows if rng.random() < float(fraction)]
        return DataFrame(rows, self.columns, self.num_partitions)

    def randomSplit(self, weights, seed=None) -> List["DataFrame"]:
        total = float(sum(weights))
        rng = _random.Random(seed)
        rows = list(self._rows)
        rng.shuffle(rows)
        out, start = [], 0
        bounds = []
        acc = 0.0
        for w in weights[:-1]:
            acc += w / total
            bounds.append(int(round(acc * len(rows))))
        bounds.append(len(rows))
        for b in bounds:
            out.append(DataFrame(rows[start:b], self.columns,
                                 self.num_partitions))
            start = b
        return out

    def dropna(self, how: str = "any", thresh=None, subset=None
               ) -> "DataFrame":
        """pyspark signature: how='any'|'all', thresh = min non-null count
        (overrides how), subset = columns to consider."""
        if how not in ("any", "all"):
            raise ValueError(f"how must be 'any' or 'all', got {how!r}")
        if isinstance(subset, str):
            subset = [subset]
        cols = subset or self.columns

        def is_null(v):
            return v is None or (isinstance(v, float) and v != v)

        def ok(r):
            non_null = sum(0 if is_null(r[c]) else 1 for c in cols)
            if thresh is not None:
                return non_null >= thresh
            return non_null == len(cols) if how == "any" else non_null > 0

        return DataFrame([r for r in self._rows if ok(r)], self.columns,
                         self.num_partitions)

    def fillna(self, value, subset=None) -> "DataFrame":
        if isinstance(subset, str):
            subset = [subset]
        cols = subset or self.columns
        # pyspark only fills SCALAR columns whose type matches the value:
        # numbers fill numeric columns, strings fill string columns; vector
        # or other object columns are never touched
        want_str = isinstance(value, str)

        def col_matches(c):
            for r in self._rows:
                v = r[c]
                if v is None or (isinstance(v, float) and v != v):
                    continue
                if want_str:
                    return isinstance(v, str)
                return isinstance(v, (int, float, bool)) \
                    and not isinstance(v, str)
            return True  # all-null column: fill it

        cols = [c for c in cols if col_matches(c)]

        def fix(r):
            d = r.asDict()
            for c in cols:
                v = d.get(c)
                if v is None or (isinstance(v, float) and v != v):
                    d[c] = value
            return Row(**d)

        return DataFrame([fix(r) for r in self._rows], self.columns,
                         self.num_partitions)

    def cache(self) -> "DataFrame":
        return self  # everything is already in memory

    def persist(self, *_a) -> "DataFrame":
        return self

    def unpersist(self, *_a) -> "DataFrame":
        return self

    def toPandas(self):
        import pandas as pd
        return pd.DataFrame([r.asDict() for r in self._rows],
                            columns=self.columns)

    @property
    def write(self) -> "_Writer":
        return _Writer(self)

    def __repr__(self):
        return f"DataFrame[{', '.join(self.columns)}] ({len(self._rows)} rows)"


def _vector_to_plain(v):
    """DenseVector/SparseVector -> list[float] for columnar formats (the
    JVM VectorUDT has no pyarrow analog; densified on purpose)."""
    if hasattr(v, "toArray"):
        return [float(x) for x in v.toArray()]
    return v


def _plain_to_vector(v):
    """list-of-numbers -> DenseVector on read (the inverse convention)."""
    if (isinstance(v, list) and v
            and all(isinstance(x, (int, float)) for x in v)):
        from .linalg import Vectors
        return Vectors.dense([float(x) for x in v])
    return v


class _Writer:
    """``df.write.mode("overwrite").parquet(path)`` / ``.json(path)`` /
    ``.csv(path)`` — single-file writers for the standalone engine."""

    def __init__(self, df: "DataFrame"):
        self._df = df
        self._mode = "error"

    def mode(self, m: str) -> "_Writer":
        if m not in ("error", "errorifexists", "overwrite", "ignore"):
            raise ValueError(f"unsupported write mode {m!r} (supported: "
                             f"error, overwrite, ignore)")
        self._mode = m
        return self

    def _should_write(self, path: str) -> bool:
        if _os.path.exists(path):
            if self._mode == "overwrite":
                return True
            if self._mode == "ignore":
                return False
            raise IOError(f"path {path} already exists "
                          f"(mode={self._mode!r})")
        return True

    def parquet(self, path: str) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq
        if not self._should_write(path):
            return
        rows = self._df.collect()
        cols = {c: [_vector_to_plain(r[c]) for r in rows]
                for c in self._df.columns}
        pq.write_table(pa.table(cols), path)

    def json(self, path: str) -> None:
        if not self._should_write(path):
            return
        with open(path, "w") as f:
            for r in self._df.collect():
                d = {c: _vector_to_plain(r[c]) for c in self._df.columns}
                f.write(_json.dumps(d) + "\n")

    def csv(self, path: str) -> None:
        if not self._should_write(path):
            return
        with open(path, "w", newline="") as f:
            w = _csv.writer(f)
            w.writerow(self._df.columns)
            for r in self._df.collect():
                w.writerow([_vector_to_plain(r[c])
                            for c in self._df.columns])


class _CsvReader:
    def __init__(self, session):
        self._session = session
        self._options: Dict[str, Any] = {}

    def option(self, key: str, value) -> "_CsvReader":
        self._options[str(key).lower()] = value
        return self

    def csv(self, path: str) -> DataFrame:
        infer = str(self._options.get("inferschema", "false")).lower() == "true"
        header = str(self._options.get("header", "false")).lower() == "true"
        rows: List[Row] = []
        with open(path, newline="") as f:
            reader = _csv.reader(f)
            cols: Optional[List[str]] = None
            for rec in reader:
                if cols is None:
                    cols = rec if header else [f"_c{i}" for i in range(len(rec))]
                    if header:
                        continue
                vals = [_parse(v) if infer else v for v in rec]
                rows.append(Row(**dict(zip(cols, vals))))
        return DataFrame(rows, cols or [], self._session._default_parallelism)

    def parquet(self, path: str) -> DataFrame:
        import pyarrow.parquet as pq
        table = pq.read_table(path)
        cols = table.column_names
        data = {c: table.column(c).to_pylist() for c in cols}
        n = table.num_rows
        rows = [Row(**{c: _plain_to_vector(data[c][i]) for c in cols})
                for i in range(n)]
        return DataFrame(rows, cols, self._session._default_parallelism)

    def json(self, path: str) -> DataFrame:
        """JSON Lines (one object per line), like spark.read.json. Missing
        keys on a line become None (pyspark fills null)."""
        dicts, cols = [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = {k: _plain_to_vector(v)
                     for k, v in _json.loads(line).items()}
                for k in d:
                    if k not in cols:
                        cols.append(k)
                dicts.append(d)
        rows = [Row(**{c: d.get(c) for c in cols}) for d in dicts]
        return DataFrame(rows, cols, self._session._default_parallelism)


def _parse(s: str):
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s


class _SessionBuilder:
    def __init__(self):
        self._conf: Dict[str, Any] = {}
        self._master = "local[1]"

    def appName(self, name: str) -> "_SessionBuilder":
        self._conf["app.name"] = name
        return self

    def master(self, m: str) -> "_SessionBuilder":
        self._master = m
        return self

    def config(self, key: str, value) -> "_SessionBuilder":
        self._conf[key] = value
        return self

    def getOrCreate(self) -> "LocalSession":
        par = 1
        if self._master.startswith("local["):
            spec = self._master[6:-1]
            par = 4 if spec == "*" else int(spec)
        return LocalSession(self._conf, par)


class LocalSession:
    """Stands in for SparkSession: createDataFrame + read.csv."""

    builder = None  # set below (class property pattern like SparkSession.builder)

    def __init__(self, conf: Optional[Dict[str, Any]] = None, parallelism: int = 4):
        self.conf = conf or {}
        self._default_parallelism = parallelism

    @property
    def read(self) -> _CsvReader:
        return _CsvReader(self)

    def createDataFrame(self, data, schema: Optional[Sequence[str]] = None) -> DataFrame:
        rows: List[Row] = []
        for item in data:
            if isinstance(item, Row):
                rows.append(item)
            elif isinstance(item, dict):
                rows.append(Row(**item))
            else:  # tuple/list + schema
                if schema is None:
                    raise ValueError("schema required for tuple data")
                rows.append(Row(**dict(zip(schema, item))))
        cols = list(schema) if schema else (rows[0].__fields__ if rows else [])
        return DataFrame(rows, cols, self._default_parallelism)

    def stop(self):
        pass


class _BuilderAccessor:
    def __get__(self, obj, objtype=None):
        return _SessionBuilder()


LocalSession.builder = _BuilderAccessor()
