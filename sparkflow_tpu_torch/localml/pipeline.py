"""Pipeline / PipelineModel, like ``pyspark.ml.pipeline``.

``Pipeline.fit`` runs stages in order — transformers transform the running
dataset, estimators fit then contribute their fitted model — producing a
``PipelineModel`` of transformers, exactly the contract the reference's examples
rely on (``examples/simple_dnn.py:65-68``).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from .base import Estimator, Model, Transformer, _Reader
from .param import Param, Params, keyword_only


class Pipeline(Estimator):
    stages = Param(Params._dummy(), "stages", "pipeline stages")

    @keyword_only
    def __init__(self, stages=None):
        super().__init__()
        kwargs = self._input_kwargs
        self._set(**kwargs)

    def getStages(self) -> List:
        return self.getOrDefault(self.stages)

    def setStages(self, stages) -> "Pipeline":
        return self._set(stages=stages)

    def copy(self, extra=None) -> "Pipeline":
        """Propagate ``extra`` INTO the stages (pyspark behavior) — this is
        what lets CrossValidator grids target a stage's params."""
        that = super().copy(extra)
        stages = self.getStages()
        if stages:
            that._set(stages=[s.copy(extra) for s in stages])
        return that

    def _fit(self, dataset) -> "PipelineModel":
        fitted: List[Transformer] = []
        current = dataset
        stages = self.getStages()
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(current)
                fitted.append(model)
                if i < len(stages) - 1:
                    current = model.transform(current)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                if i < len(stages) - 1:
                    current = stage.transform(current)
            else:
                raise TypeError(f"stage {stage!r} is neither Estimator nor Transformer")
        return PipelineModel(fitted)


class PipelineModel(Model):
    def __init__(self, stages: List[Transformer]):
        super().__init__()
        self.stages = stages

    def _transform(self, dataset):
        for stage in self.stages:
            dataset = stage.transform(dataset)
        return dataset

    # directory-per-stage persistence so individual stages stay inspectable
    def write(self):
        outer = self

        class _PipelineWriter:
            def __init__(self):
                self._overwrite = False

            def overwrite(self):
                self._overwrite = True
                return self

            def save(self, path: str):
                os.makedirs(path, exist_ok=True)
                meta = {"format": "sparkflow-tpu-localml-pipeline",
                        "num_stages": len(outer.stages)}
                with open(os.path.join(path, "pipeline.json"), "w") as f:
                    json.dump(meta, f)
                for i, stage in enumerate(outer.stages):
                    w = stage.write()
                    if self._overwrite:
                        w = w.overwrite()
                    w.save(os.path.join(path, f"stage_{i}"))

        return _PipelineWriter()

    @classmethod
    def load(cls, path: str) -> "PipelineModel":
        with open(os.path.join(path, "pipeline.json")) as f:
            meta = json.load(f)
        stages = []
        for i in range(meta["num_stages"]):
            stages.append(_Reader(None).load(os.path.join(path, f"stage_{i}")))
        return PipelineModel(stages)
