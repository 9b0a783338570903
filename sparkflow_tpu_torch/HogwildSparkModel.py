"""Import-compatibility alias: ``from sparkflow_tpu_torch.HogwildSparkModel
import HogwildSparkModel`` works like the reference's
``from sparkflow.HogwildSparkModel import HogwildSparkModel``
(``sparkflow/HogwildSparkModel.py:103``).

The implementation lives in :mod:`sparkflow_tpu_torch.hogwild`: the same
constructor surface and ``.train(rdd)`` entry point, training asynchronously
through the elastic parameter store (no Flask server exists; ``stop_server``
does nothing)."""

from .hogwild import HogwildSparkModel

__all__ = ["HogwildSparkModel"]
