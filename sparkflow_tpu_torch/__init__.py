"""sparkflow-tpu ported to PyTorch and CUDA.

The JAX package ``sparkflow_tpu`` stays the reference; this package is its
port, module by module, onto an NVIDIA Hopper card. It imports ``torch``
and never ``jax`` or anything of ``sparkflow_tpu``. Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.

Ported so far: the decode-serving path — ``ServingClient.generate`` →
``InferenceServer`` ``/v1/generate`` → ``ContinuousBatcher`` →
``DecodeEngine`` → ``TransformerLM.prefill`` / ``decode_step`` → the
``flash_attention`` and ``paged_attention`` CUDA kernels — and the
single-card training path — ``trainer.Trainer.fit`` → ``core`` steps →
``optimizers`` → the ``transformer_lm`` / ``transformer_classifier`` loss
→ ``flash_attention`` forward and its dq and dk/dv backward kernels, with
checkpoints, resume and preemption (``checkpoint``, ``resilience``), step
spans (``obs.StepStats``, ``utils.flops``) and ``fit_stream`` over the
native host data plane (``native``, ``utils.data``, ``utils.text``) —
and the Spark ML estimator on top of it: ``spark_async.SparkAsyncDL`` /
``SparkAsyncDLModel`` (alias ``tensorflow_async``) in a ``Pipeline`` on
``localml`` or pyspark (``compat``, ``pipeline_util``, ``ml_util``), with
models from the ``nn`` graph DSL (``nn``, ``graph_utils.build_graph``,
``graphdef.GraphModel``) or the registry — and the serving fleet:
``serving.RouterServer`` over replicas, ``serving.Autoscaler``, canary
rollout, the ``sim`` fleet simulator, and a replica's cold start from a
stored kernel library (``serving.ExecutableStore``) — and the reference's
own path: TF1 ``MetaGraphDef`` JSON run by the ``tf1_compat`` interpreter
(``SparkAsyncDL(tensorflowGraph=<metagraph JSON>)``), Saver / npz / torch
checkpoint import (``model_loader``, alias ``tensorflow_model_loader``), and
Hogwild-style async training (``hogwild.HogwildSparkModel``,
``Trainer(strategy="elastic_dp")``) over the elastic parameter store
(``parallel.elastic``). ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"

from .device import device_report, resolve_device

__all__ = ["device_report", "resolve_device"]
