"""PyTorch port, the Spark ML estimator: ``SparkAsyncDL`` /
``SparkAsyncDLModel`` fit, transform, save and load on ``localml`` (on the
CPU, asked for with ``device="cpu"``), the Params it refuses, and fitted
stages moving between the two packages at the Param level (``modelJson``
plus ``modelWeights``).

The data and the ``nn`` model are the reference suite's (overlapping
Gaussians, ``tests/test_estimator.py``; reference ``dl_runner.py``); its
bar is "better than all-wrong", and the port is also held to 90 %
accuracy. Across packages the predictions of one fitted model agree within
1e-5 absolute, float32, for an ``nn`` MLP and for a 2-layer, width-64
``transformer_classifier`` fed token ids plus a padding-mask column.
"""

import logging
import os

import numpy as np
import pytest
import torch

import sparkflow_tpu.nn as jnn
import sparkflow_tpu_torch.nn as tnn
from sparkflow_tpu.graph_utils import build_graph as jax_build_graph
from sparkflow_tpu.models.registry import build_registry_spec as jax_spec
from sparkflow_tpu.tensorflow_async import SparkAsyncDL as JaxSparkAsyncDL
from sparkflow_tpu.tensorflow_async import SparkAsyncDLModel as JaxModel
from sparkflow_tpu_torch.graph_utils import build_adam_config, build_graph
from sparkflow_tpu_torch.checkpoint import CheckpointManager
from sparkflow_tpu_torch.localml import (LocalSession, OneHotEncoder, Pipeline,
                                         PipelineModel, Vectors)
from sparkflow_tpu_torch.ml_util import predict_func, resolve_weights
from sparkflow_tpu_torch.models import build_registry_spec
from sparkflow_tpu_torch.pipeline_util import PysparkPipelineWrapper
from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL, SparkAsyncDLModel


def create_model(nn):
    x = nn.placeholder([None, 2], name="x")
    y = nn.placeholder([None, 1], name="y")
    layer1 = nn.dense(x, 12, activation="relu")
    layer2 = nn.dense(layer1, 5, activation="relu")
    out = nn.dense(layer2, 1, activation="sigmoid", name="outer")
    nn.sigmoid_cross_entropy(y, out)


def create_autoencoder(nn):
    x = nn.placeholder([None, 10], name="x")
    layer1 = nn.dense(x, 5, activation="relu")
    layer2 = nn.dense(layer1, 2, activation="relu", name="out")
    layer3 = nn.dense(layer2, 5, activation="relu")
    out = nn.dense(layer3, 10, activation="sigmoid", name="outer")
    nn.mean_squared_error(x, out)


@pytest.fixture(scope="module")
def spark():
    return LocalSession.builder.appName("torch-estimator").getOrCreate()


def _gaussians(localml):
    # two overlapping gaussians, 400 rows (reference dl_runner.py:90-95),
    # as a DataFrame of the given package's localml: a stage transforms the
    # DataFrames of its own package
    rs = np.random.RandomState(12345)
    rows = []
    for _ in range(200):
        rows.append((1.0, localml.Vectors.dense(rs.normal(2, 1, 2))))
        rows.append((0.0, localml.Vectors.dense(rs.normal(-2, 1, 2))))
    spark = localml.LocalSession.builder.appName("gaussians").getOrCreate()
    return spark.createDataFrame(rows, ["label", "features"])


@pytest.fixture(scope="module")
def gaussian_df():
    import sparkflow_tpu_torch.localml as tlocal
    return _gaussians(tlocal)


def _errors(df, pred="predicted"):
    return sum(1 for r in df.collect()
               if round(float(r[pred])) != float(r["label"]))


def _estimator(cls=SparkAsyncDL, **over):
    kw = dict(inputCol="features", tensorflowGraph=build_graph(
        lambda: create_model(tnn)), tfInput="x:0", tfLabel="y:0",
        tfOutput="outer/Sigmoid:0", tfOptimizer="adam", tfLearningRate=.1,
        iters=35, partitions=2, predictionCol="predicted", labelCol="label",
        verbose=0)
    if cls is SparkAsyncDL:
        kw["device"] = "cpu"
    kw.update(over)
    return cls(**kw)


# -- (d) fit -> transform, persistence, refusals ------------------------------

def test_fit_transform_learns_the_reference_data(gaussian_df):
    model = _estimator().fit(gaussian_df)
    assert model.getDevice() == "cpu"
    errors = _errors(model.transform(gaussian_df))
    assert errors < 400          # the reference's bar
    assert errors < 40           # 90 % accuracy


def test_pipeline_saves_and_loads(gaussian_df, tmp_path):
    fitted = Pipeline(stages=[_estimator()]).fit(gaussian_df)
    want = [r["predicted"] for r in fitted.transform(gaussian_df).collect()]
    path = str(tmp_path / "pipeline")
    fitted.write().overwrite().save(path)
    loaded = PysparkPipelineWrapper.unwrap(PipelineModel.load(path))
    assert type(loaded.stages[-1]).__module__ == \
        "sparkflow_tpu_torch.spark_async"
    assert loaded.stages[-1].getDevice() == "cpu"
    got = [r["predicted"] for r in loaded.transform(gaussian_df).collect()]
    assert got == want
    # a model saved alone loads alone
    mpath = str(tmp_path / "model")
    fitted.stages[-1].write().overwrite().save(mpath)
    again = SparkAsyncDLModel.load(mpath)
    assert [r["predicted"] for r in again.transform(gaussian_df).collect()] \
        == want


def test_weights_path_ema_and_optimizer_options(gaussian_df, tmp_path):
    opts = build_adam_config(learning_rate=0.1, beta1=0.85, beta2=0.98)
    est = _estimator(optimizerOptions=opts, weightsPath=str(tmp_path / "w"))
    model = est.fit(gaussian_df)
    assert model.getOrDefault(model.modelWeights) == \
        "npz:" + str(tmp_path / "w.npz")
    assert os.path.exists(tmp_path / "w.npz")
    assert _errors(model.transform(gaussian_df)) < 40
    ema = _estimator(useEmaWeights=True,
                     optimizerOptions='{"ema_decay": 0.9}').fit(gaussian_df)
    assert _errors(ema.transform(gaussian_df)) < 40
    with pytest.raises(ValueError, match="ema_decay"):
        _estimator(useEmaWeights=True).fit(gaussian_df)


def test_unsupervised_autoencoder_and_vector_predictions(spark):
    rs = np.random.RandomState(3)
    df = spark.createDataFrame(
        [(Vectors.dense(rs.uniform(0, 1, 10)),) for _ in range(64)],
        ["features"])
    est = SparkAsyncDL(inputCol="features", device="cpu",
                       tensorflowGraph=build_graph(
                           lambda: create_autoencoder(tnn)),
                       tfInput="x:0", tfLabel=None, tfOutput="out/Relu:0",
                       tfLearningRate=0.01, iters=3, miniBatchSize=16)
    rows = est.fit(df).transform(df).collect()
    assert len(rows) == 64
    assert all(len(r["predicted"]) == 2 for r in rows)


@pytest.mark.parametrize("over", [
    {"meshShape": "pp=2"}, {"ppMicrobatches": 3, "meshShape": "pp=2"},
    {"ppSchedule": "zigzag"},
    {"weightUpdateSharding": "on", "meshShape": "ep=2"},
    {"zeroStage": 1, "meshShape": "dp=2,ep=2"}], ids=lambda d: next(iter(d)))
def test_unported_params_are_refused_before_training(gaussian_df, over):
    # dp / sp / tp / fsdp / pp meshes and the ZeRO Params are ported
    # (tests/test_torch_{zero,tp,fsdp,pp}.py); the ep axis is not. The pp
    # Params are refused where JAX refuses them, with its messages: a pp
    # mesh over a graph with no blocks, microbatches that do not divide the
    # batch, an unknown schedule
    calls = []
    df = gaussian_df
    if "ppMicrobatches" in over:
        rs = np.random.RandomState(0)
        df = LocalSession.builder.appName("pp-tokens").getOrCreate(
        ).createDataFrame([(float(rs.randint(0, 2)), Vectors.dense(
            rs.randint(0, 30, 8).astype(float))) for _ in range(32)],
            ["label", "features"])
        over = dict(over, tensorflowGraph=build_registry_spec(
            "transformer_classifier", vocab_size=30, num_classes=2,
            hidden=32, num_layers=2, num_heads=4, mlp_dim=64, max_len=8,
            dropout=0.0), tfInput="input_ids", tfLabel="y",
            tfOutput="logits", miniBatchSize=16)
    est = _estimator(**over).setLossCallback(lambda *a: calls.append(a))
    if "ep=" in over.get("meshShape", ""):
        with pytest.raises(NotImplementedError,
                           match="not yet ported.*ROADMAP.md.*item 7"):
            est.fit(df)
    else:
        match = ("has no block structure to pipeline"
                 if "ppMicrobatches" not in over and "meshShape" in over
                 else "pp_microbatches=3 must divide the per-dp-replica "
                      "batch 16" if "ppMicrobatches" in over
                 else "ppSchedule must be")
        with pytest.raises(ValueError, match=match):
            est.fit(df)
    assert calls == []


@pytest.mark.parametrize("over", [{"meshShape": "tp=2"}],
                         ids=lambda d: next(iter(d)))
def test_model_refuses_unported_params(gaussian_df, over):
    # a dp meshShape serves (tests/test_torch_mesh_predict.py); any other
    # axis is refused with the JAX package's message
    fitted = _estimator(iters=1).fit(gaussian_df)
    fitted.setParams(**over)
    with pytest.raises(ValueError,
                       match="Model meshShape serves data-parallel only"):
        fitted.transform(gaussian_df)


def test_model_refuses_a_bad_quantize_mode_with_the_jax_message(gaussian_df):
    fitted = _estimator(iters=1).fit(gaussian_df)
    fitted.setParams(inferenceQuantize="int4")
    with pytest.raises(ValueError, match="inferenceQuantize must be one of"):
        fitted.transform(gaussian_df)
    with pytest.raises(ValueError, match="quantize must be one of"):
        predict_func([], "{}", "p", "[]", "x", "out:0", "x:0",
                     quantize="int4", device="cpu")


def test_param_checks_keep_their_messages_and_no_ops_warn(gaussian_df,
                                                          caplog):
    with pytest.raises(ValueError, match="labelCol is None"):
        _estimator(labelCol=None).fit(gaussian_df)
    with pytest.raises(ValueError, match="fitMode must be"):
        _estimator(fitMode="bogus").fit(gaussian_df)
    with pytest.raises(ValueError, match="pair up one-to-one"):
        _estimator(extraInputCols="a,b", extraTfInputs="c").fit(gaussian_df)
    with pytest.raises(ValueError, match="zeroStage must be"):
        _estimator(zeroStage=7).fit(gaussian_df)
    with caplog.at_level(logging.WARNING, logger="sparkflow_tpu_torch"):
        _estimator(iters=1, acquireLock=True, port=5001).fit(gaussian_df)
    assert "acquireLock=True has no effect" in caplog.text
    assert "port=5001 has no effect" in caplog.text


def test_the_card_is_the_default_device(gaussian_df):
    est = _estimator(cls=SparkAsyncDL, iters=1)
    est.setDevice(None)
    assert SparkAsyncDL().getDevice() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            est.fit(gaussian_df)


def test_the_params_keep_the_jax_packages_names_and_defaults():
    for ours, theirs in ((SparkAsyncDL(), JaxSparkAsyncDL()),
                         (SparkAsyncDLModel(), JaxModel())):
        assert sorted(p.name for p in ours.params) == \
            sorted(p.name for p in theirs.params)
        for p in theirs.params:
            assert ours.getOrDefault(p.name) == theirs.getOrDefault(p.name)


# -- fitMode="stream" and checkpointDir --------------------------------------

def test_fit_mode_stream_never_collects(gaussian_df, monkeypatch):
    """fitMode='stream' trains through rdd.toLocalIterator and never
    materializes the dataset on the driver."""
    from sparkflow_tpu_torch.localml.sql import RDD

    def no_collect(self):
        raise AssertionError("collect() called in stream mode")

    monkeypatch.setattr(RDD, "collect", no_collect)
    model = _estimator(iters=20, fitMode="stream",
                       miniBatchSize=64).fit(gaussian_df)
    monkeypatch.undo()
    assert _errors(model.transform(gaussian_df)) < 40


@pytest.mark.parametrize("mode", ["collect", "stream"])
def test_a_multi_card_host_fits_without_a_mesh_unless_asked(gaussian_df,
                                                           monkeypatch, mode):
    """Without meshShape the fit goes over every local card, as JAX's
    (``default_mesh``): on a host with two cards a fit without one, collect
    or stream, launches two ranks (their trainer built on the CPU here, in
    place of the cards), a fit asked onto the CPU keeps one process, and so
    does a host with one card."""
    import sparkflow_tpu_torch.spark_async as sa
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    meshes, trainer = [], sa.Trainer

    def on_the_cpu(*args, **kwargs):
        meshes.append(kwargs.get("mesh"))
        assert kwargs["device"] is None
        return trainer(*args, **dict(kwargs, device="cpu"))

    monkeypatch.setattr(sa, "Trainer", on_the_cpu)
    est = _estimator(iters=20, fitMode=mode, miniBatchSize=64, device=None)
    assert est._mesh({}) == Mesh({"dp": 2}) and est._mesh(None) == \
        Mesh({"dp": 2})
    model = est.fit(gaussian_df)
    assert meshes == [Mesh({"dp": 2})]
    st = est.last_mesh_stats
    assert st["mesh"] == {"dp": 2} and st["launched"]
    assert len(st["ranks"]) == 2
    model.setDevice("cpu")
    assert _errors(model.transform(gaussian_df)) < 40
    est.setDevice("cpu")
    assert est._mesh({}) is None
    est.setDevice("cuda:1")
    assert est._mesh({}) is None
    est.setDevice(None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert est._mesh({}) is None


def test_fit_stream_consumes_the_iterator_boundedly():
    """The stream path pulls rows in ring-sized chunks while it trains,
    not all up front."""
    from sparkflow_tpu_torch.trainer import Trainer
    pulled, at_first_step = [], []

    def rows():
        rs = np.random.RandomState(3)
        for i in range(5000):
            pulled.append(i)
            yield rs.rand(4).astype(np.float32), float(i % 2)

    def m():
        x = tnn.placeholder([None, 4], name="x")
        y = tnn.placeholder([None, 1], name="y")
        tnn.sigmoid_cross_entropy(y, tnn.dense(x, 1, name="out"))

    def cb(loss, step, pid):
        if not at_first_step:
            at_first_step.append(len(pulled))

    tr = Trainer(build_graph(m), "x:0", "y:0", mini_batch_size=32,
                 loss_callback=cb, device="cpu")
    res = tr.fit_stream(rows(), queue_capacity=2, chunk=64)
    assert len(pulled) == 5000 and len(res.losses) == -(-5000 // 32)
    assert at_first_step[0] < 1000, at_first_step


def test_multi_input_stream_mode_through_estimator(spark):
    """fitMode='stream' with extraInputCols: ids and mask ride the batch
    ring as one row and split back per input before the step."""
    seq, vocab = 8, 30
    spec = build_registry_spec("transformer_classifier", vocab_size=vocab,
                               num_classes=2, hidden=16, num_layers=1,
                               num_heads=2, mlp_dim=32, max_len=seq,
                               dropout=0.0)
    rs = np.random.RandomState(0)
    rows = []
    for _ in range(60):
        label = rs.randint(0, 2)
        ids = rs.randint(3, vocab, seq)
        if label:
            ids[0] = 1  # marker token
        n_real = rs.randint(seq // 2, seq + 1)
        mask = np.zeros(seq)
        mask[:n_real] = 1.0
        ids[n_real:] = 0
        rows.append((float(label), Vectors.dense(ids.astype(float)),
                     Vectors.dense(mask)))
    df = spark.createDataFrame(rows, ["label", "tokens", "mask"])
    est = SparkAsyncDL(inputCol="tokens", tensorflowGraph=spec,
                       tfInput="input_ids:0", tfLabel="y:0",
                       tfOutput="pred:0", tfOptimizer="adam",
                       tfLearningRate=0.01, iters=30, partitions=2,
                       labelCol="label", predictionCol="predicted",
                       miniBatchSize=16, fitMode="stream",
                       extraInputCols="mask",
                       extraTfInputs="attention_mask:0", device="cpu")
    model = est.fit(df)
    errs = sum(1 for r in model.transform(df).collect()
               if round(float(r["predicted"])) != float(r["label"]))
    assert errs < 15


@pytest.mark.parametrize("mode", ["collect", "stream"])
def test_checkpoint_dir_is_passed_to_the_trainer(gaussian_df, tmp_path,
                                                 mode):
    """checkpointDir / checkpointEvery reach the Trainer: epochs (collect)
    or steps (stream) are saved, and a refit on the same directory resumes.
    Collect: the refit restores the last epoch, has nothing left to run and
    lands on the same weights. Stream: the refit continues from the saved
    step on a new pass of the stream."""
    ck = str(tmp_path / "ck")
    est = _estimator(iters=4, miniBatchSize=100, checkpointDir=ck,
                     checkpointEvery=2, fitMode=mode)
    first = _predictions(est.fit(gaussian_df).transform(gaussian_df))
    mgr = CheckpointManager(ck)
    # 400 rows, batches of 100: 4 epochs of 4 steps; the newest 3 are kept
    assert mgr.all_steps() == ([2, 4] if mode == "collect" else [12, 14, 16])
    again = _predictions(est.fit(gaussian_df).transform(gaussian_df))
    if mode == "collect":
        assert mgr.all_steps() == [2, 4]
        np.testing.assert_array_equal(again, first)
    else:
        assert mgr.all_steps() == [28, 30, 32]


# -- (e) across the packages --------------------------------------------------

def _predictions(df, col="predicted"):
    return np.array([np.asarray(r[col].toArray() if hasattr(r[col], "toArray")
                                else r[col], np.float64)
                     for r in df.collect()])


def _model_kw(m):
    keys = ("inputCol", "modelJson", "modelWeights", "tfInput", "tfOutput",
            "tfDropout", "toKeepDropout", "predictionCol", "extraInputCols",
            "extraTfInputs")
    return {k: m.getOrDefault(k) for k in keys}


def test_jax_fitted_mlp_transforms_in_the_port(gaussian_df):
    import sparkflow_tpu.localml as jlocal
    assert build_graph(lambda: create_model(tnn)) == \
        jax_build_graph(lambda: create_model(jnn))
    jdf = _gaussians(jlocal)
    jfit = _estimator(cls=JaxSparkAsyncDL, iters=10).fit(jdf)
    ours = SparkAsyncDLModel(device="cpu", **_model_kw(jfit))
    np.testing.assert_allclose(_predictions(ours.transform(gaussian_df)),
                               _predictions(jfit.transform(jdf)),
                               atol=1e-5, rtol=0)


def _text_df(localml, n=16, seq=32, vocab=50, seed=0):
    """``examples/bert_classifier.py``'s ``synthetic_text`` at a small
    size: token ids with a marker pattern, ragged real lengths, the mask
    as its own column."""
    rs = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        label = rs.randint(0, 2)
        ids = rs.randint(10, vocab, seq)
        if label:
            ids[::7] = 3
        n_real = rs.randint(seq // 2, seq + 1)
        mask = np.zeros(seq)
        mask[:n_real] = 1.0
        ids[n_real:] = 0
        rows.append((float(label), localml.Vectors.dense(ids.astype(float)),
                     localml.Vectors.dense(mask)))
    spark = localml.LocalSession.builder.appName("text").getOrCreate()
    return spark.createDataFrame(rows, ["label", "tokens", "mask"])


def test_port_fitted_transformer_transforms_in_jax(tmp_path):
    import sparkflow_tpu.localml as jlocal
    import sparkflow_tpu_torch.localml as tlocal
    cfg = dict(vocab_size=50, num_classes=2, hidden=64, num_layers=2,
               num_heads=4, mlp_dim=128, max_len=32, dropout=0.0)
    spec = build_registry_spec("transformer_classifier", **cfg)
    assert spec == jax_spec("transformer_classifier", **cfg)
    df = _text_df(tlocal)
    est = SparkAsyncDL(inputCol="tokens", tensorflowGraph=spec,
                       tfInput="input_ids:0", tfLabel="y:0",
                       tfOutput="probs:0", tfLearningRate=3e-3, iters=2,
                       miniBatchSize=8, labelCol="labels",
                       predictionCol="probs", extraInputCols="mask",
                       extraTfInputs="attention_mask:0", device="cpu",
                       weightsPath=str(tmp_path / "cls"))
    fitted = Pipeline(stages=[
        OneHotEncoder(inputCol="label", outputCol="labels", dropLast=False),
        est]).fit(df)
    ours = fitted.stages[-1]
    got = _predictions(ours.transform(df), "probs")
    assert got.shape == (16, 2) and np.isfinite(got).all()
    theirs = JaxModel(**_model_kw(ours))
    np.testing.assert_allclose(got, _predictions(
        theirs.transform(_text_df(jlocal)), "probs"), atol=1e-5, rtol=0)
    # the weights side file holds the fitted weights in spec order
    w = resolve_weights(ours.getOrDefault(ours.modelWeights))
    assert len(w) == 2 + 2 * 12 + 2 + 2     # embed, blocks, final_ln, head


def test_predict_func_refuses_mesh_serving():
    # dp serving is ported (tests/test_torch_mesh_predict.py); an axis
    # that is not an inference strategy is refused with JAX's message
    with pytest.raises(ValueError, match="serves data-parallel only"):
        predict_func([], "{}", "p", "[]", "x", "out:0", "x:0",
                     device="cpu", mesh_axes={"tp": 2})


# -- (f) int8 serving across the packages --------------------------------------

QCLS = dict(vocab_size=50, num_classes=2, hidden=64, num_layers=2,
            num_heads=4, mlp_dim=128, max_len=32, dropout=0.0)


def _quant_stage_kw(weights_json):
    spec = build_registry_spec("transformer_classifier", **QCLS)
    return dict(inputCol="tokens", modelJson=spec, modelWeights=weights_json,
                tfInput="input_ids:0", tfOutput="probs:0",
                predictionCol="probs", extraInputCols="mask",
                extraTfInputs="attention_mask:0")


@pytest.fixture(scope="module")
def quant_weights():
    """A 2-layer, 64-wide classifier's weights (numpy, seeded) as the
    inline JSON Param: its four block projections are above the default
    quant_min_size (4096 elements), the head is not."""
    from test_torch_shared import numpy_params
    from sparkflow_tpu.models.registry import model_from_json as jax_from
    spec = build_registry_spec("transformer_classifier", **QCLS)
    tree = numpy_params(jax_from(spec).param_specs(), seed=8, std=0.1)
    from sparkflow_tpu_torch.ml_util import convert_weights_to_json
    return convert_weights_to_json([tree[ln][pn] for ln, ps in
                                    jax_from(spec).param_specs().items()
                                    for pn in ps])


# int8-served probs across the packages: every row within 1e-4, as for
# weight_only, but for at most one row in dynamic mode, held at 1e-3.
# dynamic also rounds every activation x / row_scale to an int8 at run time,
# and the packages' float32 activations differ in the last bits (XLA and
# torch sum the layer norms in different orders), so an activation lying
# next to a rounding tie can round one way in one package and the other way
# in the other. On these rows that moves row 0 by 2.5e-4 and row 15 by
# 3.2e-5; every other row agrees within 1e-7. Neither package is wrong. The
# witness: the row past 1e-4 must hold an activation within TIE_GAP of a
# tie in the port's own rounding (row 0's is 4.8e-6 off one).
QUANT_TOL, QUANT_OUTLIER_TOL, TIE_GAP = 1e-4, 1e-3, 1e-5


@pytest.fixture
def tie_gaps(monkeypatch):
    """Per row, how near the port's dynamic int8 rounding came to a tie:
    the least |frac(|x / row_scale|) - 1/2| over the row's live tokens in
    every ``int8_matmul`` call (rows and masks as ``_text_df`` makes
    them)."""
    from sparkflow_tpu_torch.utils import quant
    import sparkflow_tpu_torch.localml as tlocal
    mask = _predictions(_text_df(tlocal), "mask") > 0
    gaps = np.full(len(mask), np.inf)
    real = quant.int8_matmul

    def spy(x, q8, scale):
        xf = x.float()
        absmax = xf.abs().amax(dim=-1, keepdim=True)
        xs = torch.where(absmax > 0, quant._over_127(absmax),
                         torch.ones_like(absmax))
        r = (xf / xs).abs()
        gap = (r - r.floor() - 0.5).abs().amin(-1).numpy()     # [B, S]
        gaps[:] = np.minimum(gaps, np.where(mask, gap, np.inf).min(-1))
        return real(x, q8, scale)

    monkeypatch.setattr(quant, "int8_matmul", spy)
    return gaps


def _assert_int8_parity(got, want, mode, gaps):
    off = np.abs(got - want).max(-1)
    assert np.isfinite(got).all()
    np.testing.assert_array_less(off, QUANT_OUTLIER_TOL)
    outliers = np.flatnonzero(off >= QUANT_TOL)
    assert mode == "dynamic" or outliers.size == 0, off
    assert outliers.size <= 1, off
    assert (gaps[outliers] < TIE_GAP).all(), (outliers, gaps)


@pytest.mark.parametrize("mode", ["weight_only", "dynamic"])
def test_quantized_transform_matches_jax(quant_weights, tie_gaps, mode):
    """``SparkAsyncDLModel(inferenceQuantize=mode)`` in both packages on
    the same weights and rows: probs within ``QUANT_TOL`` (one dynamic row
    next to a rounding tie within ``QUANT_OUTLIER_TOL``); the int8 probs
    differ from the float32 ones, and dynamic's from weight_only's by more
    than ``QUANT_OUTLIER_TOL`` (the int8 x int8 product really ran)."""
    import sparkflow_tpu.localml as jlocal
    import sparkflow_tpu_torch.localml as tlocal
    kw = _quant_stage_kw(quant_weights)

    def ours(m):
        return _predictions(SparkAsyncDLModel(
            device="cpu", inferenceQuantize=m, **kw).transform(
            _text_df(tlocal)), "probs")
    got = ours(mode)
    want = _predictions(JaxModel(inferenceQuantize=mode, **kw).transform(
        _text_df(jlocal)), "probs")
    assert got.shape == (16, 2)
    _assert_int8_parity(got, want, mode, tie_gaps)
    full = _predictions(SparkAsyncDLModel(device="cpu", **kw).transform(
        _text_df(tlocal)), "probs")
    assert np.abs(full - got).max() > 0
    if mode == "dynamic":
        assert np.abs(ours("weight_only") - got).max() > QUANT_OUTLIER_TOL


@pytest.mark.parametrize("mode", ["weight_only", "dynamic"])
def test_predict_func_serves_int8_like_jax(quant_weights, tie_gaps,
                                          tmp_path, mode):
    """``predict_func(quantize=)`` directly, weights in an npz side file:
    the port's probs against the JAX package's as in
    ``test_quantized_transform_matches_jax``, the quantized tree cached on
    the weights identity."""
    from sparkflow_tpu.ml_util import predict_func as jax_predict_func
    from sparkflow_tpu_torch import ml_util
    import sparkflow_tpu.localml as jlocal
    import sparkflow_tpu_torch.localml as tlocal
    w = ml_util.convert_json_to_weights(quant_weights)
    path = str(tmp_path / "w.npz")
    ml_util.save_weights_npz(path, w)
    kw = _quant_stage_kw("npz:" + path)
    args = lambda df: (df.collect(), kw["modelJson"], "probs",  # noqa: E731
                       "npz:" + path, "tokens", "probs:0", "input_ids:0")
    common = dict(extra_cols=["mask"], extra_inputs=["attention_mask:0"],
                  quantize=mode)
    got = ml_util.predict_func(*args(_text_df(tlocal)), device="cpu",
                               **common)
    want = jax_predict_func(*args(_text_df(jlocal)), **common)
    g = np.array([r["probs"].toArray() for r in got])
    j = np.array([r["probs"].toArray() for r in want])
    _assert_int8_parity(g, j, mode, tie_gaps)
    before = len(ml_util._QUANT_CACHE)
    ml_util.predict_func(*args(_text_df(tlocal)), device="cpu", **common)
    assert len(ml_util._QUANT_CACHE) == before
