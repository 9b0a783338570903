"""Param system: API-compatible with ``pyspark.ml.param``.

The reference declares all configuration as class-level ``Param`` descriptors with
``TypeConverters`` plus ``keyword_only`` constructors
(``sparkflow/tensorflow_async.py:104-121,123-210``). This module reimplements that
public protocol (``_dummy``, ``_input_kwargs``, ``_set``, ``_setDefault``,
``getOrDefault``, ``set``/``isSet``/``hasDefault``/``copy``) without the JVM.
"""

from __future__ import annotations

import copy as _copy
import functools
import uuid
from typing import Any, Callable, Dict, Optional


class TypeConverters:
    """Subset of pyspark's converters (same names, same coercion behavior)."""

    @staticmethod
    def toString(v):
        if v is None:
            return None
        return str(v)

    @staticmethod
    def toInt(v):
        if v is None:
            return None
        return int(v)

    @staticmethod
    def toFloat(v):
        if v is None:
            return None
        return float(v)

    @staticmethod
    def toBoolean(v):
        if v is None:
            return None
        return bool(v)

    @staticmethod
    def toList(v):
        if v is None:
            return None
        return list(v)

    @staticmethod
    def toListString(v):
        if v is None:
            return None
        return [str(x) for x in v]

    @staticmethod
    def toListFloat(v):
        if v is None:
            return None
        return [float(x) for x in v]

    @staticmethod
    def toListInt(v):
        if v is None:
            return None
        return [int(x) for x in v]

    @staticmethod
    def identity(v):
        return v


class Param:
    """A named parameter attached to a parent Params instance (or ``_dummy``)."""

    def __init__(self, parent, name: str, doc: str = "",
                 typeConverter: Optional[Callable] = None):
        self.parent = getattr(parent, "uid", parent)
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter or TypeConverters.identity

    def __repr__(self):
        return f"Param({self.parent}__{self.name})"

    def __hash__(self):
        return hash((self.parent, self.name))

    def __eq__(self, other):
        return (isinstance(other, Param) and self.parent == other.parent
                and self.name == other.name)


def keyword_only(func):
    """pyspark's decorator: stashes kwargs in ``self._input_kwargs``."""

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        if args:
            raise TypeError(f"{func.__name__} only takes keyword arguments")
        self._input_kwargs = kwargs
        return func(self, **kwargs)

    return wrapper


class Identifiable:
    """Object with a unique id, like ``pyspark.ml.util.Identifiable``."""

    def __init__(self):
        self.uid = self._randomUID()

    @classmethod
    def _randomUID(cls):
        return f"{cls.__name__}_{uuid.uuid4().hex[:12]}"

    def __repr__(self):
        return self.uid


class Params(Identifiable):
    """Holds instance param values + defaults; Param descriptors live on the class."""

    _DUMMY = None

    def __init__(self):
        super().__init__()
        self._paramMap: Dict[Param, Any] = {}
        self._defaultParamMap: Dict[Param, Any] = {}
        self._copy_class_params()

    @classmethod
    def _dummy(cls):
        if Params._DUMMY is None:
            dummy = object.__new__(Params)
            dummy.uid = "undefined"
            Params._DUMMY = dummy
        return Params._DUMMY

    def _copy_class_params(self):
        """Rebind class-level Param descriptors to this instance (pyspark's
        ``_copyValues``/descriptor-binding behavior): ``self.<name>`` yields a
        Param whose parent is this instance's uid."""
        for klass in reversed(type(self).__mro__):
            for name, attr in vars(klass).items():
                if isinstance(attr, Param):
                    bound = Param(self, attr.name, attr.doc, attr.typeConverter)
                    setattr(self, name, bound)

    # -- core protocol ------------------------------------------------------

    @property
    def params(self):
        return sorted(
            (v for v in vars(self).values() if isinstance(v, Param)),
            key=lambda p: p.name)

    def _resolveParam(self, param) -> Param:
        if isinstance(param, Param):
            return getattr(self, param.name)
        return getattr(self, param)

    def hasParam(self, name: str) -> bool:
        return isinstance(getattr(self, name, None), Param)

    def _set(self, **kwargs):
        for name, value in kwargs.items():
            p = self._resolveParam(name)
            if value is not None:
                value = p.typeConverter(value)
            self._paramMap[p] = value
        return self

    def _setDefault(self, **kwargs):
        for name, value in kwargs.items():
            p = self._resolveParam(name)
            self._defaultParamMap[p] = value
        return self

    def set(self, param, value):
        return self._set(**{self._resolveParam(param).name: value})

    def isSet(self, param) -> bool:
        return self._resolveParam(param) in self._paramMap

    def hasDefault(self, param) -> bool:
        return self._resolveParam(param) in self._defaultParamMap

    def isDefined(self, param) -> bool:
        return self.isSet(param) or self.hasDefault(param)

    def getOrDefault(self, param):
        p = self._resolveParam(param)
        if p in self._paramMap:
            return self._paramMap[p]
        if p in self._defaultParamMap:
            return self._defaultParamMap[p]
        raise KeyError(f"param {p.name} is not set and has no default")

    def getParam(self, name: str) -> Param:
        p = getattr(self, name, None)
        if not isinstance(p, Param):
            raise ValueError(f"no param with name {name!r}")
        return p

    def extractParamMap(self, extra=None):
        m = dict(self._defaultParamMap)
        m.update(self._paramMap)
        if extra:
            m.update(extra)
        return m

    def explainParams(self) -> str:
        lines = []
        for p in self.params:
            val = self.getOrDefault(p) if self.isDefined(p) else "undefined"
            lines.append(f"{p.name}: {p.doc} (current: {val})")
        return "\n".join(lines)

    def copy(self, extra=None):
        that = _copy.copy(self)
        that._paramMap = dict(self._paramMap)
        that._defaultParamMap = dict(self._defaultParamMap)
        that._copy_class_params()
        # re-key maps onto the re-bound Param objects
        that._paramMap = {getattr(that, p.name): v for p, v in that._paramMap.items()}
        that._defaultParamMap = {getattr(that, p.name): v
                                 for p, v in that._defaultParamMap.items()}
        if extra:
            for p, v in extra.items():
                # pyspark semantics: extras keyed by a Param another object
                # owns are ignored here (the owning stage applies them —
                # see Pipeline.copy); string keys always resolve locally
                if isinstance(p, Param):
                    if p.parent != that.uid or not that.hasParam(p.name):
                        continue
                that._paramMap[that._resolveParam(p)] = v
        return that


# shared-param mixins mirroring pyspark.ml.param.shared

class HasInputCol(Params):
    inputCol = Param(Params._dummy(), "inputCol", "input column name",
                     typeConverter=TypeConverters.toString)

    def getInputCol(self):
        return self.getOrDefault(self.inputCol)

    def setInputCol(self, value):
        return self._set(inputCol=value)


class HasOutputCol(Params):
    outputCol = Param(Params._dummy(), "outputCol", "output column name",
                      typeConverter=TypeConverters.toString)

    def getOutputCol(self):
        return self.getOrDefault(self.outputCol)

    def setOutputCol(self, value):
        return self._set(outputCol=value)


class HasPredictionCol(Params):
    predictionCol = Param(Params._dummy(), "predictionCol", "prediction column name",
                          typeConverter=TypeConverters.toString)

    def getPredictionCol(self):
        return self.getOrDefault(self.predictionCol)


class HasLabelCol(Params):
    labelCol = Param(Params._dummy(), "labelCol", "label column name",
                     typeConverter=TypeConverters.toString)

    def getLabelCol(self):
        return self.getOrDefault(self.labelCol)
