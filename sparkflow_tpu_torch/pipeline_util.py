"""Pipeline persistence: ``PysparkReaderWriter`` / ``PysparkPipelineWrapper``.

Reference contract (``sparkflow/pipeline_util.py``): custom Python stages must
survive Spark's native ``Pipeline.save`` / ``PipelineModel.load``. The reference
smuggles a dill-pickled, zlib-compressed Python object through a Java
``StopWordsRemover``'s stopwords list, marked with a GUID, and ``unwrap`` swaps
the real stage back in after load (``pipeline_util.py:109-127, 56-74``).

Here the same two public names exist with the same call shapes:

- with **pyspark** present, the carrier trick is reproduced (it is
  model-framework-agnostic: any Params-only Python stage round-trips);
- with **localml**, stages are dill-serialized directly by the localml
  writer — no carrier needed — and ``unwrap`` is a structural no-op that still
  recurses for API compatibility.
"""

from __future__ import annotations

import zlib
from typing import Any, List

import dill

from .compat import USING_PYSPARK

# GUID marking carrier stages (ours, not the reference's — saves are not
# wire-compatible across frameworks, only API-compatible).
GUID = "7a3f9c2e51b44de2a0c8sparkflowtpu".replace("sparkflowtpu", "9d17e3b4")


def _to_bytes_string(obj: Any) -> str:
    raw = zlib.compress(dill.dumps(obj))
    return ",".join(str(b) for b in raw)


def _from_bytes_string(s: str) -> Any:
    raw = bytes(int(tok) for tok in s.split(","))
    return dill.loads(zlib.decompress(raw))


if USING_PYSPARK:  # covered by the pyspark CI job (make test-pyspark)

    from pyspark.ml.feature import StopWordsRemover
    from pyspark.ml.pipeline import Pipeline, PipelineModel
    from pyspark.ml.util import JavaMLReader, JavaMLWriter

    class PysparkObjId:
        """Carrier constants (reference ``pipeline_util.py:16-31``)."""

        _getCarrierClass = staticmethod(lambda: StopWordsRemover)
        GUID = GUID

    def _unwrap_carrier(words: List[str], what: str = "stage") -> Any:
        """Single decode path for every carrier consumer (reader, _from_java,
        pipeline unwrap): validate the GUID sentinel, then dill-load."""
        words = list(words)
        if len(words) < 2 or words[-1] != GUID:
            raise ValueError(f"{what} is not a sparkflow-tpu carrier")
        return _from_bytes_string(words[0])

    class _CarrierReader:
        """Loads a saved carrier StopWordsRemover and unwraps the Python
        stage (reference ``pipeline_util.py:89-98``: the reader is for the
        CARRIER class — a Python-only class has no Java loader)."""

        def load(self, path: str):
            carrier = JavaMLReader(StopWordsRemover).load(path)
            return _unwrap_carrier(carrier.getStopWords(), what=path)

    class PysparkReaderWriter:
        """Mixin giving a Python stage Spark-native save/load via the
        StopWordsRemover carrier (reference ``pipeline_util.py:77-127``)."""

        def write(self):
            return JavaMLWriter(self)

        def save(self, path: str):
            self.write().save(path)

        @classmethod
        def read(cls):
            return _CarrierReader()

        @classmethod
        def load(cls, path: str):
            return cls.read().load(path)

        def _to_java(self):
            payload = _to_bytes_string(self)
            carrier = StopWordsRemover()
            carrier._resetUid(self.uid)  # keep stage identity in metadata
            carrier.setStopWords([payload, GUID])
            return carrier._to_java()

        @classmethod
        def _from_java(cls, java_stage):
            return _unwrap_carrier(java_stage.getStopWords())

    class PysparkPipelineWrapper:
        """Recursively swap carrier stages back into real Python objects after
        ``PipelineModel.load`` (reference ``pipeline_util.py:56-74``)."""

        @staticmethod
        def unwrap(pipeline):
            if isinstance(pipeline, (Pipeline, PipelineModel)):
                stages = (pipeline.getStages() if isinstance(pipeline, Pipeline)
                          else pipeline.stages)
                for i, stage in enumerate(stages):
                    if isinstance(stage, (Pipeline, PipelineModel)):
                        stages[i] = PysparkPipelineWrapper.unwrap(stage)
                    elif (isinstance(stage, StopWordsRemover)
                          and stage.getStopWords()
                          and stage.getStopWords()[-1] == GUID):
                        stages[i] = _unwrap_carrier(stage.getStopWords())
                if isinstance(pipeline, Pipeline):
                    pipeline.setStages(stages)
                else:
                    pipeline.stages = stages
            return pipeline

else:

    from .localml.pipeline import Pipeline, PipelineModel

    class PysparkObjId:
        GUID = GUID

    class PysparkReaderWriter:
        """With localml the base writer already dill-serializes the full stage
        (``sparkflow_tpu_torch/localml/base.py``); nothing extra to mix in."""

    class PysparkPipelineWrapper:
        @staticmethod
        def unwrap(pipeline):
            # localml loads real Python objects directly; recurse only to keep
            # the call shape of the reference API.
            if isinstance(pipeline, (Pipeline, PipelineModel)):
                stages = (pipeline.getStages() if isinstance(pipeline, Pipeline)
                          else pipeline.stages)
                for i, stage in enumerate(stages):
                    if isinstance(stage, (Pipeline, PipelineModel)):
                        stages[i] = PysparkPipelineWrapper.unwrap(stage)
            return pipeline
