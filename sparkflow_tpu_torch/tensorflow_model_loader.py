"""Import-compatibility alias: ``from sparkflow_tpu_torch.tensorflow_model_loader
import load_tensorflow_model`` works like the reference's
``from sparkflow.tensorflow_model_loader import load_tensorflow_model``
(``sparkflow/tensorflow_model_loader.py:8,35``).

The implementation lives in :mod:`sparkflow_tpu_torch.model_loader` (TF1
Saver checkpoints are read straight off their shards; the ``.meta`` graph
runs through the TF1 interpreter)."""

from .model_loader import (attach_pretrained_model_to_pipeline,
                           attach_tensorflow_model_to_pipeline,
                           extract_tensorflow_weights, load_tensorflow_model)

__all__ = ["load_tensorflow_model", "attach_tensorflow_model_to_pipeline",
           "attach_pretrained_model_to_pipeline", "extract_tensorflow_weights"]
