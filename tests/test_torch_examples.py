"""PyTorch port, its examples (``sparkflow_tpu_torch/examples``): the
reference's three MNIST examples, ``bert_classifier``, ``text_classifier``
and ``tf1_migration``, each run in-process on the CPU at its smoke sizes
(``run(device="cpu", smoke=True, workdir=tmp)``); the serving, streaming,
recurrent, ResNet and long-context examples are in
``tests/test_torch_examples_serving.py``.

For the reference's three the model is held to the JAX example: the graph
JSON byte for byte (the JAX example module is imported from its path; its
``__main__`` guard keeps it from running), and the port-fitted
``modelJson`` / ``modelWeights`` loaded into the JAX package's
``SparkAsyncDLModel`` predict within 1e-5 (float32) of the port's own model
on the smoke rows, read at a float tensor (the logits, or the
autoencoder's bottleneck).
"""

import importlib.util
import os

import numpy as np
import pytest

from sparkflow_tpu.graph_utils import build_graph as jax_build_graph
from sparkflow_tpu.localml import LocalSession as JaxSession
from sparkflow_tpu.localml import Vectors as JaxVectors
from sparkflow_tpu.tensorflow_async import SparkAsyncDLModel as JaxModel
from sparkflow_tpu_torch.graph_utils import build_graph
from sparkflow_tpu_torch.localml import LocalSession, Vectors
from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDLModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_tf1")

# example -> (its model function, a float tensor to compare at)
REFERENCE = {"simple_dnn": ("small_model", "dense_2/BiasAdd:0"),
             "cnn_example": ("cnn_model", "dense/BiasAdd:0"),
             "autoencoder_example": ("small_model", "out/Sigmoid:0")}


def _port(name):
    return importlib.import_module(f"sparkflow_tpu_torch.examples.{name}")


def _jax(name, monkeypatch):
    """The JAX example module, imported from its path (``cnn_example`` and
    ``autoencoder_example`` import ``simple_dnn`` from their directory)."""
    monkeypatch.syspath_prepend(EXAMPLES)
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    return {name: _port(name).run(device="cpu", smoke=True,
                                  workdir=str(tmp_path_factory.mktemp(name)))
            for name in REFERENCE}


def _stage(result):
    return (result["model"] if "model" in result
            else result["pipeline"].stages[-1])


def _rows(result, n=64):
    """The first ``n`` smoke rows' model inputs."""
    rows = result["df"].take(n)
    if "features" in rows[0]:
        return np.stack([r["features"].toArray() for r in rows])
    return np.array([[r[f"_c{i}"] for i in range(1, 785)] for r in rows])


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_reference_example_graph_equals_the_jax_examples(name, monkeypatch):
    fn, _ = REFERENCE[name]
    ours = build_graph(getattr(_port(name), fn))
    assert ours == jax_build_graph(getattr(_jax(name, monkeypatch), fn))


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_reference_example_fits_and_predicts_in_the_jax_model(
        name, reference_runs):
    """The fit's losses are finite and fall; the fitted strings serve in
    the JAX package as in the port."""
    res = reference_runs[name]
    losses = np.asarray(res["losses"])
    assert losses.size >= 2 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert res["rows_per_s"] > 0
    stage = _stage(res)
    mj = stage.getOrDefault(stage.modelJson)
    mw = stage.getOrDefault(stage.modelWeights)
    x = _rows(res)
    tensor = REFERENCE[name][1]
    kw = dict(inputCol="features", modelJson=mj, modelWeights=mw,
              tfInput="x:0", tfOutput=tensor, predictionCol="p")
    ours = SparkAsyncDLModel(device="cpu", **kw).transform(
        LocalSession.builder.getOrCreate().createDataFrame(
            [(Vectors.dense(r),) for r in x], ["features"])).collect()
    theirs = JaxModel(**kw).transform(
        JaxSession.builder.getOrCreate().createDataFrame(
            [(JaxVectors.dense(r),) for r in x], ["features"])).collect()
    a = np.stack([np.asarray(r["p"].toArray()) for r in ours])
    b = np.stack([np.asarray(r["p"].toArray()) for r in theirs])
    assert a.shape == b.shape and a.shape[0] == len(x)
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_simple_dnn_saves_into_workdir_and_reloads_bit_for_bit(
        reference_runs, tmp_path):
    res = reference_runs["simple_dnn"]
    assert os.path.isdir(res["path"])
    assert not os.path.exists(os.path.join(os.getcwd(), "simple_dnn"))
    assert 0.0 <= res["test_error"] <= 1.0
    df = res["df"]
    a = [r["predicted"] for r in res["pipeline"].transform(df).collect()]
    b = [r["predicted"] for r in res["loaded"].transform(df).collect()]
    assert a == b


# -- the transformer classifiers and the TF1 migration -----------------------


def test_bert_classifier_fits_and_serves_int8(tmp_path):
    res = _port("bert_classifier").run(device="cpu", smoke=True,
                                       workdir=str(tmp_path))
    losses = np.asarray(res["losses"])
    assert losses.size == 3 and np.isfinite(losses).all()
    assert 0.0 <= res["int8_accuracy"] <= 1.0
    assert res["accuracy"] > 0.5 and res["rows_per_s"] > 0


def test_bert_classifier_takes_its_mesh_from_the_environment(monkeypatch,
                                                            tmp_path):
    """``SPARKFLOW_TPU_MESH`` becomes the estimator's ``meshShape``, as in
    the JAX example; the estimator is stopped at its construction."""
    ex = _port("bert_classifier")
    seen = {}

    class Stop(Exception):
        pass

    def capture(**kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(ex, "SparkAsyncDL", capture)
    monkeypatch.setenv("SPARKFLOW_TPU_MESH", "dp=2,tp=2")
    with pytest.raises(Stop):
        ex.run(device="cpu", smoke=True, workdir=str(tmp_path))
    assert seen["meshShape"] == "dp=2,tp=2"
    seen.clear()
    monkeypatch.delenv("SPARKFLOW_TPU_MESH")
    with pytest.raises(Stop):
        ex.run(device="cpu", smoke=True, workdir=str(tmp_path))
    assert seen and "meshShape" not in seen


def test_text_classifier_tokenizes_fits_and_predicts(tmp_path):
    res = _port("text_classifier").run(device="cpu", smoke=True,
                                       workdir=str(tmp_path))
    losses = np.asarray(res["losses"])
    assert losses.size == 10 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert res["accuracy"] > 0.5


def test_tf1_migration_trains_the_metagraph_and_serves_the_checkpoint(
        tmp_path):
    """With TensorFlow (this machine) both parts run; from the committed
    fixture alone, as on a machine without it, part 1 does."""
    ex = _port("tf1_migration")
    res = ex.run(device="cpu", smoke=True, workdir=str(tmp_path / "tf"))
    assert res["served"] == 300 and res["checkpoint"].startswith(
        str(tmp_path))
    assert res["errors"] < 30 and np.isfinite(res["losses"]).all()
    alone = ex.run(device="cpu", smoke=True, workdir=str(tmp_path / "fx"),
                   metagraph=os.path.join(FIXTURES, "tf1_migration.json"))
    assert alone["served"] is None and alone["errors"] < 30
    assert len(alone["losses"]) == 5
