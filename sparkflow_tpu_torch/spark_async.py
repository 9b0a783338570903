"""``SparkAsyncDL`` / ``SparkAsyncDLModel``: the Spark ML estimator surface,
ported to PyTorch.

The JAX package's classes with the same Params — names, defaults and
converters — so a persisted stage keeps its shape, and the same
``.fit`` / ``.transform`` semantics: unsupervised mode (``tfLabel=None``),
the dropout feed (``tfDropout`` / ``toKeepDropout``), extra input columns
(``extraInputCols`` / ``extraTfInputs``), ``weightsPath`` side files and
``useEmaWeights``, mid-training checkpoints (``checkpointDir`` /
``checkpointEvery``: a refit on the same directory resumes). ``_fit``
collects the rows and trains with the port's :class:`~.trainer.Trainer`
(``fitMode="stream"``: ``Trainer.fit_stream`` over
``rdd.toLocalIterator``, never collecting); ``_transform`` predicts per
partition through :func:`~.ml_util.predict_func`.

``tensorflowGraph`` is any spec ``models.model_from_json`` takes: the
reference's TF1 ``MetaGraphDef`` JSON (run by the ``tf1_compat``
interpreter; ``tfDropout`` names its keep-probability placeholder, e.g. a
``placeholder_with_default``), a registry spec or an ``nn`` graph.

Both stages take a ``device`` keyword (not a Param): ``None`` is the CUDA
card, ``"cpu"`` must be asked for. The estimator hands it to its
``Trainer`` and to the model it fits, the model to its predict path.

The model's ``inferenceQuantize`` (``"weight_only"`` / ``"dynamic"``)
serves int8 weights through ``predict_func`` (a TF1 graph dequantizes at the
variable read, so it serves both as weight-only).

``meshShape`` on the estimator trains on a mesh of ranks (the JAX package's
checks: ``sp`` needs ``fitMode="collect"``, a ``dp=1`` axis is added when
``dp`` is absent): ``"dp=N"`` is synchronous data parallelism, in collect
and stream mode, with ``weightUpdateSharding`` / ``zeroStage`` choosing the
ZeRO stage; ``"tp=N"`` (Megatron tensor parallelism, registry models that
publish ``param_pspecs``) and ``"fsdp=N"`` (parameter sharding, any model)
beside it, in both modes; ``sp`` sequence parallelism; the trainer launches
the ranks
(one card each, or sharing the card with gloo). Without ``meshShape`` the
fit runs over every local card on one ``dp`` axis, as JAX's does
(``parallel.mesh.default_mesh``): in this process on a host with one card
or none, and with ``device="cpu"`` (or one named card) on any host; one
rank per card on a host with several — and spawned ranks re-import the main module, so a
script keeps its top-level code under ``if __name__ == "__main__":``.
``meshShape="dp=N"`` on the model stage serves each partition over N weight
copies in this process (the serving rule of ``parallel/mesh.py``); its
other axes are refused with the JAX package's message.
A ``pp`` axis (``"pp=2"``, ``"dp=2,pp=2"``) trains the registry
transformers through the Trainer's pipeline under ``ppSchedule``
(``"gpipe"``, ``"1f1b"`` or ``"sequential"``) and ``ppMicrobatches``
(unset or < 1: the Trainer's rule), in ``fitMode="collect"`` only — the
JAX package's rules and messages; the fitted model serves without a mesh.
An ``ep`` axis (``"ep=2"``, ``"dp=2,ep=2"``) reaches the Trainer as in JAX:
an MoE spec shards its expert banks over it, a dense graph trains
replicated over it, and the combinations JAX refuses fail with its
messages.

Also importable as :mod:`sparkflow_tpu_torch.tensorflow_async`.
"""

from __future__ import annotations

import json
import logging
from typing import Optional

import numpy as np

from .compat import (Estimator, HasInputCol, HasLabelCol, HasPredictionCol,
                     Identifiable, MLReadable, MLWritable, Model, Param, Params,
                     TypeConverters, keyword_only)
from .localml.linalg import vector_to_array
from .ml_util import (check_serving_mesh, convert_weights_to_json,
                      handle_features, predict_func, save_weights_npz)
from .pipeline_util import PysparkReaderWriter
from .trainer import Trainer

logger = logging.getLogger("sparkflow_tpu_torch")


class _OnDevice:
    """The ``device`` keyword of both stages: kept on the instance (and so
    in a saved stage), not as a Param."""

    _device = None

    def _take_device(self, kwargs: dict) -> dict:
        kwargs = dict(kwargs)
        if "device" in kwargs:
            self._device = kwargs.pop("device")
        return kwargs

    def getDevice(self):
        return self._device

    def setDevice(self, device):
        self._device = device
        return self


def _split_csv(s: Optional[str]) -> list:
    """Comma-separated Param -> list of names (empty list for None/blank)."""
    return [t.strip() for t in (s or "").split(",") if t.strip()]


def _opt_param(obj, param, default=None):
    """getOrDefault that tolerates instances persisted by OLDER versions:
    dill-loaded stages restore the old _defaultParamMap, which lacks Params
    added since — treat those as their current default instead of KeyError."""
    try:
        return obj.getOrDefault(param)
    except KeyError:
        return default


def build_optimizer(optimizer_name, learning_rate, optimizer_options=None):
    """Name -> gradient transformation (reference
    ``tensorflow_async.py:17-42``)."""
    from .optimizers import build_optimizer as _bo
    return _bo(optimizer_name, learning_rate, optimizer_options)


def handle_data(data, inp_col: str, label_col: Optional[str],
                extra_cols: Optional[list] = None):
    """Row -> (features ndarray, label) or bare features when unsupervised
    (reference ``tensorflow_async.py:45-48``). With ``extra_cols`` the
    features become a tuple (multi-input models)."""
    def feat(row):
        base = np.asarray(vector_to_array(row[inp_col]), dtype=np.float32)
        if extra_cols:
            return (base,) + tuple(
                np.asarray(vector_to_array(row[c]), dtype=np.float32)
                for c in extra_cols)
        return base

    if label_col is None:
        return feat(data)
    return (feat(data), data[label_col])


class SparkAsyncDLModel(_OnDevice, Model, HasInputCol, HasPredictionCol,
                        PysparkReaderWriter, MLReadable, MLWritable,
                        Identifiable):
    """Fitted model: graph JSON + weights JSON as string Params, applied
    per-partition (reference ``tensorflow_async.py:51-99``)."""

    modelJson = Param(Params._dummy(), "modelJson", "", typeConverter=TypeConverters.toString)
    modelWeights = Param(Params._dummy(), "modelWeights", "", typeConverter=TypeConverters.toString)
    tfOutput = Param(Params._dummy(), "tfOutput", "", typeConverter=TypeConverters.toString)
    tfInput = Param(Params._dummy(), "tfInput", "", typeConverter=TypeConverters.toString)
    tfDropout = Param(Params._dummy(), "tfDropout", "", typeConverter=TypeConverters.toString)
    toKeepDropout = Param(Params._dummy(), "toKeepDropout", "", typeConverter=TypeConverters.toBoolean)
    # upgrade: extra (column, tensor) feeds for multi-input models, e.g. an
    # attention mask next to token ids; comma-separated so the Params stay
    # plain strings (persistence-friendly, like every reference Param)
    extraInputCols = Param(Params._dummy(), "extraInputCols", "", typeConverter=TypeConverters.toString)
    extraTfInputs = Param(Params._dummy(), "extraTfInputs", "", typeConverter=TypeConverters.toString)
    # JAX-package upgrades kept so persisted stages keep their shape:
    # int8-quantized serving ('' = off, 'weight_only', 'dynamic') and
    # data-parallel serving over weight copies ("dp=8")
    inferenceQuantize = Param(Params._dummy(), "inferenceQuantize", "", typeConverter=TypeConverters.toString)
    meshShape = Param(Params._dummy(), "meshShape", "", typeConverter=TypeConverters.toString)

    @keyword_only
    def __init__(self,
                 inputCol=None,
                 modelJson=None,
                 modelWeights=None,
                 tfInput=None,
                 tfOutput=None,
                 tfDropout=None,
                 toKeepDropout=None,
                 predictionCol=None,
                 extraInputCols=None,
                 extraTfInputs=None,
                 inferenceQuantize=None,
                 meshShape=None,
                 device=None):
        super(SparkAsyncDLModel, self).__init__()
        self._setDefault(modelJson=None, inputCol='encoded',
                         predictionCol='predicted', tfOutput=None, tfInput=None,
                         modelWeights=None, tfDropout=None, toKeepDropout=False,
                         extraInputCols=None, extraTfInputs=None,
                         inferenceQuantize=None, meshShape=None)
        self.setParams(**self._take_device(self._input_kwargs))

    @keyword_only
    def setParams(self,
                  inputCol=None,
                  modelJson=None,
                  modelWeights=None,
                  tfInput=None,
                  tfOutput=None,
                  tfDropout=None,
                  toKeepDropout=None,
                  predictionCol=None,
                  extraInputCols=None,
                  extraTfInputs=None,
                  inferenceQuantize=None,
                  meshShape=None):
        kwargs = self._input_kwargs
        return self._set(**kwargs)

    def _transform(self, dataset):
        inp = self.getOrDefault(self.inputCol)
        out = self.getOrDefault(self.predictionCol)
        mod_json = self.getOrDefault(self.modelJson)
        mod_weights = self.getOrDefault(self.modelWeights)
        tf_input = self.getOrDefault(self.tfInput)
        tf_output = self.getOrDefault(self.tfOutput)
        tf_dropout = self.getOrDefault(self.tfDropout)
        to_keep_dropout = self.getOrDefault(self.toKeepDropout)
        extra_cols = _split_csv(_opt_param(self, self.extraInputCols))
        extra_inputs = _split_csv(_opt_param(self, self.extraTfInputs))
        if len(extra_cols) != len(extra_inputs):
            raise ValueError(
                "extraInputCols (%d names) and extraTfInputs (%d names) must "
                "pair up one-to-one" % (len(extra_cols), len(extra_inputs)))
        quantize = _opt_param(self, self.inferenceQuantize) or None
        if quantize:
            from .utils.quant import MODES
            if quantize not in MODES:
                raise ValueError(
                    "inferenceQuantize must be one of %s (or unset), got %r"
                    % (list(MODES), quantize))
        mesh_shape = _opt_param(self, self.meshShape) or None
        mesh_axes = None
        if mesh_shape:
            from .parallel.mesh import make_mesh, parse_mesh_shape
            mesh_axes = parse_mesh_shape(mesh_shape)
            check_serving_mesh(mesh_axes)
            if mesh_axes["dp"] == -1:
                # every local card (make_mesh's rule); more copies than
                # cards share them (the serving rule, parallel/mesh.py)
                mesh_axes = dict(make_mesh(mesh_axes).shape)
        device = self._device
        return dataset.rdd.mapPartitions(
            lambda x: predict_func(x, mod_json, out, mod_weights, inp, tf_output,
                                   tf_input, tf_dropout, to_keep_dropout,
                                   extra_cols=extra_cols or None,
                                   extra_inputs=extra_inputs or None,
                                   quantize=quantize, mesh_axes=mesh_axes,
                                   device=device)).toDF()


class SparkAsyncDL(_OnDevice, Estimator, HasInputCol, HasPredictionCol,
                   HasLabelCol, PysparkReaderWriter, MLReadable, MLWritable,
                   Identifiable):
    """Estimator with the reference's full 18-Param surface
    (``tensorflow_async.py:102-210``) and the JAX package's upgrades;
    ``_fit`` trains on one card (or the CPU with ``device="cpu"``)."""

    tensorflowGraph = Param(Params._dummy(), "tensorflowGraph", "", typeConverter=TypeConverters.toString)
    tfInput = Param(Params._dummy(), "tfInput", "", typeConverter=TypeConverters.toString)
    tfOutput = Param(Params._dummy(), "tfOutput", "", typeConverter=TypeConverters.toString)
    tfLabel = Param(Params._dummy(), "tfLabel", "", typeConverter=TypeConverters.toString)
    tfOptimizer = Param(Params._dummy(), "tfOptimizer", "", typeConverter=TypeConverters.toString)
    tfLearningRate = Param(Params._dummy(), "tfLearningRate", "", typeConverter=TypeConverters.toFloat)
    iters = Param(Params._dummy(), "iters", "", typeConverter=TypeConverters.toInt)
    partitions = Param(Params._dummy(), "partitions", "", typeConverter=TypeConverters.toInt)
    miniBatchSize = Param(Params._dummy(), "miniBatchSize", "", typeConverter=TypeConverters.toInt)
    miniStochasticIters = Param(Params._dummy(), "miniStochasticIters", "", typeConverter=TypeConverters.toInt)
    verbose = Param(Params._dummy(), "verbose", "", typeConverter=TypeConverters.toInt)
    acquireLock = Param(Params._dummy(), "acquireLock", "", typeConverter=TypeConverters.toBoolean)
    shufflePerIter = Param(Params._dummy(), "shufflePerIter", "", typeConverter=TypeConverters.toBoolean)
    tfDropout = Param(Params._dummy(), "tfDropout", "", typeConverter=TypeConverters.toString)
    toKeepDropout = Param(Params._dummy(), "toKeepDropout", "", typeConverter=TypeConverters.toBoolean)
    partitionShuffles = Param(Params._dummy(), "partitionShuffles", "", typeConverter=TypeConverters.toInt)
    optimizerOptions = Param(Params._dummy(), "optimizerOptions", "", typeConverter=TypeConverters.toString)
    port = Param(Params._dummy(), "port", "", typeConverter=TypeConverters.toInt)
    # the JAX package's upgrades over the reference param set, all kept so
    # persisted stages keep their shape: weightsPath (npz side-file weights),
    # extraInputCols/extraTfInputs (multi-input feeds), useEmaWeights,
    # checkpointDir/checkpointEvery, fitMode='stream', dp / sp / tp / fsdp /
    # pp / ep meshShape with ppMicrobatches / ppSchedule and
    # weightUpdateSharding/zeroStage are ported (see the module docstring)
    weightsPath = Param(Params._dummy(), "weightsPath", "", typeConverter=TypeConverters.toString)
    checkpointDir = Param(Params._dummy(), "checkpointDir", "", typeConverter=TypeConverters.toString)
    checkpointEvery = Param(Params._dummy(), "checkpointEvery", "", typeConverter=TypeConverters.toInt)
    fitMode = Param(Params._dummy(), "fitMode", "", typeConverter=TypeConverters.toString)
    extraInputCols = Param(Params._dummy(), "extraInputCols", "", typeConverter=TypeConverters.toString)
    extraTfInputs = Param(Params._dummy(), "extraTfInputs", "", typeConverter=TypeConverters.toString)
    meshShape = Param(Params._dummy(), "meshShape", "", typeConverter=TypeConverters.toString)
    useEmaWeights = Param(Params._dummy(), "useEmaWeights", "", typeConverter=TypeConverters.toBoolean)
    ppMicrobatches = Param(Params._dummy(), "ppMicrobatches", "", typeConverter=TypeConverters.toInt)
    ppSchedule = Param(Params._dummy(), "ppSchedule", "", typeConverter=TypeConverters.toString)
    weightUpdateSharding = Param(Params._dummy(), "weightUpdateSharding", "", typeConverter=TypeConverters.toString)
    zeroStage = Param(Params._dummy(), "zeroStage", "", typeConverter=TypeConverters.toInt)

    @keyword_only
    def __init__(self,
                 inputCol=None,
                 tensorflowGraph=None,
                 tfInput=None,
                 tfLabel=None,
                 tfOutput=None,
                 tfOptimizer=None,
                 tfLearningRate=None,
                 iters=None,
                 predictionCol=None,
                 partitions=None,
                 miniBatchSize=None,
                 miniStochasticIters=None,
                 acquireLock=None,
                 shufflePerIter=None,
                 tfDropout=None,
                 toKeepDropout=None,
                 verbose=None,
                 labelCol=None,
                 partitionShuffles=None,
                 optimizerOptions=None,
                 port=None,
                 weightsPath=None,
                 checkpointDir=None,
                 checkpointEvery=None,
                 fitMode=None,
                 extraInputCols=None,
                 extraTfInputs=None,
                 meshShape=None,
                 useEmaWeights=None,
                 ppMicrobatches=None,
                 ppSchedule=None,
                 weightUpdateSharding=None,
                 zeroStage=None,
                 device=None):
        """Same parameter meanings as the reference estimator docstring
        (``tensorflow_async.py:146-175``); ``acquireLock`` and ``port`` are
        accepted no-ops under synchronous training. ``weightsPath`` is an
        upgrade (side-file weights); ``device`` is the card unless
        ``"cpu"``."""
        super(SparkAsyncDL, self).__init__()
        self._setDefault(inputCol='transformed', tensorflowGraph='',
                         tfInput='x:0', tfLabel=None, tfOutput='out/Sigmoid:0',
                         tfOptimizer='adam', tfLearningRate=.01, partitions=5,
                         miniBatchSize=128, miniStochasticIters=-1,
                         shufflePerIter=True, tfDropout=None, acquireLock=False,
                         verbose=0, iters=1000, toKeepDropout=False,
                         predictionCol='predicted', labelCol=None,
                         partitionShuffles=1, optimizerOptions=None, port=5000,
                         weightsPath=None, checkpointDir=None, checkpointEvery=0,
                         fitMode='collect', extraInputCols=None,
                         extraTfInputs=None, meshShape=None,
                         useEmaWeights=False, ppMicrobatches=-1,
                         ppSchedule='gpipe', weightUpdateSharding='auto',
                         zeroStage=-1)
        self._loss_callback = None
        self.last_mesh_stats = None
        self.setParams(**self._take_device(self._input_kwargs))

    @keyword_only
    def setParams(self,
                  inputCol=None,
                  tensorflowGraph=None,
                  tfInput=None,
                  tfLabel=None,
                  tfOutput=None,
                  tfOptimizer=None,
                  tfLearningRate=None,
                  iters=None,
                  predictionCol=None,
                  partitions=None,
                  miniBatchSize=None,
                  miniStochasticIters=None,
                  acquireLock=None,
                  shufflePerIter=None,
                  tfDropout=None,
                  toKeepDropout=None,
                  verbose=None,
                  labelCol=None,
                  partitionShuffles=None,
                  optimizerOptions=None,
                  port=None,
                  weightsPath=None,
                  checkpointDir=None,
                  checkpointEvery=None,
                  fitMode=None,
                  extraInputCols=None,
                  extraTfInputs=None,
                  meshShape=None,
                 useEmaWeights=None,
                 ppMicrobatches=None,
                 ppSchedule=None,
                 weightUpdateSharding=None,
                 zeroStage=None):
        kwargs = self._input_kwargs
        return self._set(**kwargs)

    def setLossCallback(self, fn):
        """Per-iteration ``fn(loss, iteration, partition_id)`` hook — the hook
        the reference declared on HogwildSparkModel but never plumbed through
        the estimator (``HogwildSparkModel.py:124``; SURVEY.md §5). Not a
        Param (functions don't persist); set it per-fit."""
        self._loss_callback = fn
        return self

    # getters (reference tensorflow_async.py:212-264)
    def getTensorflowGraph(self):
        return self.getOrDefault(self.tensorflowGraph)

    def getIters(self):
        return self.getOrDefault(self.iters)

    def getTfInput(self):
        return self.getOrDefault(self.tfInput)

    def getTfLabel(self):
        return self.getOrDefault(self.tfLabel)

    def getTfOutput(self):
        return self.getOrDefault(self.tfOutput)

    def getTfOptimizer(self):
        return self.getOrDefault(self.tfOptimizer)

    def getTfLearningRate(self):
        return self.getOrDefault(self.tfLearningRate)

    def getPartitions(self):
        return self.getOrDefault(self.partitions)

    def getMiniBatchSize(self):
        return self.getOrDefault(self.miniBatchSize)

    def getMiniStochasticIters(self):
        return self.getOrDefault(self.miniStochasticIters)

    def getVerbose(self):
        return self.getOrDefault(self.verbose)

    def getAcquireLock(self):
        return self.getOrDefault(self.acquireLock)

    def getShufflePerIter(self):
        return self.getOrDefault(self.shufflePerIter)

    def getTfDropout(self):
        return self.getOrDefault(self.tfDropout)

    def getToKeepDropout(self):
        return self.getOrDefault(self.toKeepDropout)

    def getPartitionShuffles(self):
        return self.getOrDefault(self.partitionShuffles)

    def getOptimizerOptions(self):
        return self.getOrDefault(self.optimizerOptions)

    def getPort(self):
        return self.getOrDefault(self.port)

    def getMeshShape(self):
        return _opt_param(self, self.meshShape)

    def getFitMode(self):
        return _opt_param(self, self.fitMode, "collect")

    def _validate_params(self):
        """Error loudly on inconsistent Param combinations (the JAX
        package's checks and messages), then refuse what is not yet ported
        — all before any training."""
        label_col = self.getOrDefault(self.labelCol)
        tf_label = self.getTfLabel()
        if tf_label is not None and label_col is None:
            raise ValueError(
                "tfLabel=%r names a label tensor but labelCol is None: the "
                "supervised loss would train on dummy zero labels. Set "
                "labelCol (or clear tfLabel for unsupervised training)."
                % tf_label)
        if label_col is not None and tf_label is None:
            raise ValueError(
                "labelCol=%r supplies labels but tfLabel is None, so no loss "
                "consumes them. Set tfLabel (or clear labelCol)." % label_col)
        fit_mode = (self.getFitMode() or "collect").lower()
        if fit_mode not in ("collect", "stream"):
            raise ValueError("fitMode must be 'collect' or 'stream', got %r"
                             % self.getFitMode())
        extra_cols = _split_csv(_opt_param(self, self.extraInputCols))
        extra_inputs = _split_csv(_opt_param(self, self.extraTfInputs))
        if len(extra_cols) != len(extra_inputs):
            raise ValueError(
                "extraInputCols (%d names) and extraTfInputs (%d names) must "
                "pair up one-to-one" % (len(extra_cols), len(extra_inputs)))
        mesh_axes = None
        mesh_shape = self.getMeshShape()
        if mesh_shape:
            from .parallel.mesh import parse_mesh_shape
            mesh_axes = parse_mesh_shape(mesh_shape)  # raises on bad syntax
            if (("sp" in mesh_axes or "pp" in mesh_axes)
                    and fit_mode == "stream"):
                raise ValueError(
                    "meshShape axes sp/pp need fitMode='collect': their "
                    "fixed-shape batch schedules stage the whole dataset "
                    "(the Trainer refuses pp/sp in fit_stream)")
            if "dp" not in mesh_axes:
                # rows shard over 'dp'; a size-1 axis keeps the other axes'
                # meaning instead of a shapeless mesh
                mesh_axes = {"dp": 1, **mesh_axes}
        sched = _opt_param(self, self.ppSchedule, "gpipe") or "gpipe"
        if sched not in ("gpipe", "1f1b", "sequential"):
            raise ValueError(
                "ppSchedule must be 'gpipe', '1f1b', or 'sequential'; got %r"
                % sched)
        wus = _opt_param(self, self.weightUpdateSharding, "auto") or "auto"
        if wus not in ("auto", "on", "off"):
            raise ValueError(
                "weightUpdateSharding must be 'auto', 'on', or 'off'; got %r"
                % wus)
        zs = _opt_param(self, self.zeroStage, -1)
        zs = -1 if zs is None else int(zs)
        if zs not in (-1, 0, 1, 2, 3):
            raise ValueError(
                "zeroStage must be -1 (unset) or 0-3; got %r" % zs)
        if self.getOrDefault(self.useEmaWeights):
            # fail BEFORE training, not after hours of fit: the EMA only
            # exists when the optimizer maintains it
            raw = self.getOptimizerOptions()
            opts_d = (json.loads(raw) if isinstance(raw, str) and raw
                      else (raw or {}))
            d = float(opts_d.get("ema_decay", 0) or 0)
            if not 0.0 < d < 1.0:
                raise ValueError(
                    "useEmaWeights=True requires {'ema_decay': d} with "
                    "0 < d < 1 in optimizerOptions — no EMA would be "
                    "maintained (got %r)" % d)
        # Documented no-ops (there is no parameter server): warn so a config
        # carried over from the reference states its own inertness instead of
        # silently passing (the API contract is "accepted, warned, ignored").
        if self.getAcquireLock():
            logger.warning(
                "acquireLock=True has no effect: synchronous all-reduce "
                "updates are already serialized (no Hogwild parameter server "
                "exists to lock)")
        if self.isSet(self.port):
            logger.warning(
                "port=%d has no effect: there is no parameter server to bind "
                "a port for (weights never leave the device mesh)",
                self.getPort())
        return extra_cols, extra_inputs, mesh_axes

    def _sharding_config(self):
        """``zeroStage`` >= 0 mapped into a declarative
        :class:`~sparkflow_tpu_torch.sharding.ShardingConfig`; ``-1`` (unset)
        returns ``None`` so the legacy ``weightUpdateSharding`` knob keeps
        driving the trainer's eligibility gate."""
        stage = _opt_param(self, self.zeroStage, -1)
        stage = -1 if stage is None else int(stage)
        if stage < 0:
            return None
        from .sharding import as_sharding_config
        return as_sharding_config({"zero_stage": stage})

    def _mesh(self, mesh_axes):
        """The fit's mesh: ``meshShape``'s axes (a ``-1`` axis takes the
        local cards that are left), else every local card on one ``dp``
        axis (``parallel.mesh.default_mesh``, as JAX's estimator) — None,
        one process, on a host with one card or none, and for a fit on the
        CPU or on one named card."""
        from .parallel.mesh import Mesh, default_mesh, make_mesh
        if not mesh_axes:
            return default_mesh(device=self._device)
        if any(v == -1 for v in mesh_axes.values()):
            return make_mesh(mesh_axes)
        return Mesh(mesh_axes)

    def _fit(self, dataset):
        inp_col = self.getOrDefault(self.inputCol)
        graph_json = self.getTensorflowGraph()
        label_col = self.getOrDefault(self.labelCol)
        tf_label = self.getTfLabel()
        optimizer_options = self.getOptimizerOptions()
        extra_cols, extra_inputs, mesh_axes = self._validate_params()

        # DataFrame -> (features, label) pairs; partitions Param shapes the RDD
        # exactly as the reference does (tensorflow_async.py:290-291), and the
        # union of the partitions is staged on the card
        rdd = dataset.rdd.map(
            lambda r: handle_data(r, inp_col, label_col,
                                  extra_cols=extra_cols or None))
        partitions = self.getPartitions()
        if rdd.getNumPartitions() > partitions:
            rdd = rdd.coalesce(partitions)

        # by name, as the trainer's launched ranks rebuild it (the same
        # transformation build_optimizer_from_json makes)
        opts = (json.loads(optimizer_options)
                if isinstance(optimizer_options, str) and optimizer_options
                else optimizer_options or None)
        input_spec = ([self.getTfInput()] + extra_inputs if extra_inputs
                      else self.getTfInput())
        trainer = Trainer(
            graph_json,
            input_spec,
            tf_label,
            optimizer=self.getTfOptimizer(),
            learning_rate=self.getTfLearningRate(),
            optimizer_options=opts,
            iters=self.getIters(),
            mini_batch_size=self.getMiniBatchSize(),
            mini_stochastic_iters=self.getMiniStochasticIters(),
            shuffle_per_iter=self.getShufflePerIter(),
            partition_shuffles=self.getPartitionShuffles(),
            verbose=self.getVerbose(),
            loss_callback=self._loss_callback,
            dropout_name=self.getTfDropout(),
            acquire_lock=self.getAcquireLock(),
            checkpoint_dir=self.getOrDefault(self.checkpointDir),
            checkpoint_every=self.getOrDefault(self.checkpointEvery) or 0,
            mesh=self._mesh(mesh_axes),
            pp_microbatches=(None if (_opt_param(self, self.ppMicrobatches,
                                                 -1) or -1) < 1
                             else _opt_param(self, self.ppMicrobatches)),
            pp_schedule=_opt_param(self, self.ppSchedule, "gpipe") or "gpipe",
            weight_update_sharding=(_opt_param(self, self.weightUpdateSharding,
                                               "auto") or "auto"),
            sharding=self._sharding_config(),
            device=self._device,
        )
        if (self.getFitMode() or "collect").lower() == "stream":
            # one epoch = one pass over rdd.toLocalIterator(): the dataset
            # never fully materializes on the driver (bounded by one
            # partition + the batch-assembly ring); iters x
            # partitionShuffles passes, as the collect path's epochs, with
            # the optimizer state and generators carried across passes
            epochs = (max(1, self.getIters())
                      * max(1, self.getPartitionShuffles()))
            rdd.persist()
            try:
                trainer.fit_stream(rdd.toLocalIterator, epochs=epochs)
            finally:
                rdd.unpersist()
        else:
            items = rdd.collect()
            features, labels = handle_features(
                items, is_supervised=label_col is not None)
            trainer.fit(features, labels)
        # a mesh fit's accounting (backend, bytes moved, per-rank memory and
        # kernel launches); None off a mesh
        self.last_mesh_stats = trainer.last_mesh_stats
        final_weights = trainer.weights_list()
        if self.getOrDefault(self.useEmaWeights):
            ema = trainer.ema_weights()
            if ema is None:
                raise ValueError(
                    "useEmaWeights=True requires {'ema_decay': d} in "
                    "optimizerOptions (no EMA was maintained this fit)")
            from .convert import params_to_list
            final_weights = params_to_list(trainer.model, ema)
        weights_path = self.getOrDefault(self.weightsPath)
        if weights_path:
            if not weights_path.endswith(".npz"):
                weights_path += ".npz"
            save_weights_npz(weights_path, final_weights)
            # NOTE: the model stores this PATH, not the weights — unlike the
            # reference's self-contained inline JSON, the file must be visible
            # to every executor/machine that transforms or loads the pipeline
            # (use a shared filesystem path).
            logger.warning(
                "weightsPath=%s: model references a filesystem path; ensure it "
                "is reachable from all executors and travels with saved "
                "pipelines", weights_path)
            weights_json = "npz:" + weights_path
        else:
            weights_json = convert_weights_to_json(final_weights)

        return SparkAsyncDLModel(
            inputCol=inp_col,
            modelJson=graph_json,
            modelWeights=weights_json,
            tfOutput=self.getTfOutput(),
            tfInput=self.getTfInput(),
            tfDropout=self.getTfDropout(),
            toKeepDropout=self.getToKeepDropout(),
            predictionCol=self.getOrDefault(self.predictionCol),
            extraInputCols=_opt_param(self, self.extraInputCols),
            extraTfInputs=_opt_param(self, self.extraTfInputs),
            device=self._device)
