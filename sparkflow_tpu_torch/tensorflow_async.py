"""Import-compatibility alias: ``from sparkflow_tpu_torch.tensorflow_async
import SparkAsyncDL`` works like the reference's ``from
sparkflow.tensorflow_async import SparkAsyncDL``; the implementation lives
in :mod:`sparkflow_tpu_torch.spark_async`."""

from .spark_async import (SparkAsyncDL, SparkAsyncDLModel, build_optimizer,
                          handle_data)

__all__ = ["SparkAsyncDL", "SparkAsyncDLModel", "build_optimizer", "handle_data"]
