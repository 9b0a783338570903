"""PyTorch port, pre-trained model import (``model_loader``, alias
``tensorflow_model_loader``) against the JAX package's on the CPU.

The same checkpoint goes through both packages' loaders and the fitted
stages' predictions on the same rows agree within 1e-5 (float32): an npz
weight list and a checkpoint directory (``load_checkpoint_model``), a TF1
Saver checkpoint with its ``.meta`` (``load_tensorflow_model``; these skip
without TensorFlow), batch-norm moving statistics baked into the graph, a
torch ``state_dict`` (``load_torch_model``). ``var_order``, shape matching
and the mismatch messages are the JAX package's. The port imports, and
interprets and trains a TF1 fixture, with ``tensorflow`` and
``google.protobuf`` blocked.
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import sparkflow_tpu.model_loader as jml
import sparkflow_tpu.nn as jnn
import sparkflow_tpu_torch.model_loader as tml
from sparkflow_tpu.graph_utils import build_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_tf1")


def mlp_graph():
    x = jnn.placeholder([None, 4], name="x")
    h = jnn.dense(x, 3, activation="relu")
    out = jnn.dense(h, 2, name="out")
    jnn.mean_squared_error(x, out)


def _weights(seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(4, 3).astype(np.float32), rs.randn(3).astype(np.float32),
            rs.randn(3, 2).astype(np.float32), rs.randn(2).astype(np.float32)]


def _manual_forward(w, x):
    return np.maximum(x @ w[0] + w[1], 0.0) @ w[2] + w[3]


def _predict(stage, x, jax_side: bool):
    """A fitted stage's predictions of rows ``x`` on its own package's
    ``localml`` DataFrame."""
    if jax_side:
        import sparkflow_tpu.localml as local
    else:
        import sparkflow_tpu_torch.localml as local
    spark = local.LocalSession.builder.getOrCreate()
    df = spark.createDataFrame([(local.Vectors.dense(r),) for r in x],
                               ["features"])
    out = stage.getOrDefault(stage.predictionCol)
    rows = stage.transform(df).collect()
    return np.stack([np.atleast_1d(np.asarray(
        r[out].toArray() if hasattr(r[out], "toArray") else r[out],
        np.float32)) for r in rows])


def _both(load, x, **kw):
    """(port predictions, JAX predictions) of the same import."""
    got = _predict(getattr(tml, load)(device="cpu", **kw), x, False)
    want = _predict(getattr(jml, load)(**kw), x, True)
    return got, want


def test_npz_and_checkpoint_dir_round_trip(tmp_path):
    """``load_checkpoint_model`` from an npz weight list and from a
    ``CheckpointManager`` directory: the port's predictions equal the JAX
    loader's and the weights' own forward."""
    from sparkflow_tpu_torch.checkpoint import CheckpointManager
    w = _weights()
    p = str(tmp_path / "w.npz")
    tml.save_weights_npz(p, w)
    x = np.random.RandomState(1).randn(8, 4).astype(np.float32)
    kw = dict(graph_json=build_graph(mlp_graph), inputCol="features",
              tfInput="x:0", tfOutput="out/BiasAdd:0")
    got, want = _both("load_checkpoint_model", x, checkpoint_path=p, **kw)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, _manual_forward(w, x), atol=1e-5,
                               rtol=1e-5)
    from sparkflow_tpu_torch.models import model_from_json
    specs = model_from_json(kw["graph_json"], device="cpu").param_specs()
    it = iter(w)
    d = str(tmp_path / "ckpt")
    CheckpointManager(d).save(3, {"params": {
        ln: {pn: next(it) for pn in ps} for ln, ps in specs.items()}})
    got_dir = _predict(tml.load_checkpoint_model(d, device="cpu", **kw), x,
                       False)
    np.testing.assert_allclose(got_dir, got, atol=0)


def test_a_bad_weight_count_is_refused(tmp_path):
    p = str(tmp_path / "w.npz")
    tml.save_weights_npz(p, _weights()[:3])
    with pytest.raises(ValueError, match="weight list has 3 arrays"):
        tml.load_checkpoint_model(p, build_graph(mlp_graph), "features",
                                  "x:0", "out/BiasAdd:0", device="cpu")


def test_the_card_is_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = str(tmp_path / "w.npz")
    tml.save_weights_npz(p, _weights())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tml.load_checkpoint_model(p, build_graph(mlp_graph), "features",
                                  "x:0", "out/BiasAdd:0")


# -- TF1 Saver checkpoints (TensorFlow reads them) ------------------------------

@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


@pytest.fixture(scope="module")
def tf1_checkpoint(tf, tmp_path_factory):
    """A Saver checkpoint with its ``.meta``: TF1 layer naming (dense,
    dense_1), an Adam slot variable that must not import."""
    tf1 = tf.compat.v1
    w = _weights(seed=7)
    prefix = str(tmp_path_factory.mktemp("tfckpt") / "to_load")
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, [None, 4], name="x")
        with tf1.variable_scope("dense"):
            k1 = tf1.get_variable("kernel", initializer=w[0])
            b1 = tf1.get_variable("bias", initializer=w[1])
        with tf1.variable_scope("dense_1"):
            k2 = tf1.get_variable("kernel", initializer=w[2])
            b2 = tf1.get_variable("bias", initializer=w[3])
        with tf1.variable_scope("dense/kernel"):
            tf1.get_variable("Adam", initializer=np.zeros((4, 3), np.float32),
                             trainable=False)
        h = tf1.nn.relu(tf1.nn.bias_add(tf1.matmul(x, k1), b1))
        tf1.nn.bias_add(tf1.matmul(h, k2), b2, name="out")
        with tf1.Session(graph=g) as sess:
            sess.run(tf1.global_variables_initializer())
            tf1.train.Saver().save(sess, prefix)  # writes the .meta too
    return prefix, w


def test_saver_checkpoint_serves_like_jax(tf1_checkpoint):
    """The reference's exact usage: no rebuilt graph — the ``.meta``
    MetaGraphDef becomes the serving graph, its variables load by name."""
    prefix, w = tf1_checkpoint
    x = np.random.RandomState(2).randn(5, 4).astype(np.float32)
    got, want = _both("load_tensorflow_model", x, path=prefix,
                      inputCol="features", tfInput="x:0", tfOutput="out:0")
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, _manual_forward(w, x), atol=1e-5,
                               rtol=1e-5)
    # with an nn re-expression as graph_json, shape matching assigns them
    got2, want2 = _both("load_tensorflow_model", x, path=prefix,
                        inputCol="features", tfInput="x:0",
                        tfOutput="out/BiasAdd:0",
                        graph_json=build_graph(mlp_graph))
    np.testing.assert_allclose(got2, want2, atol=1e-5)
    np.testing.assert_allclose(got2, got, atol=1e-5)


def test_var_order_and_slot_filtering(tf1_checkpoint):
    prefix, w = tf1_checkpoint
    got = tml.extract_tensorflow_weights(prefix)
    want = jml.extract_tensorflow_weights(prefix)
    assert len(got) == len(want) == 4  # the Adam slot is left out
    for a, b, c in zip(got, want, w):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    pick = ["dense_1/kernel", "dense_1/bias"]
    for a, b in zip(tml.extract_tensorflow_weights(prefix, var_order=pick),
                    w[2:]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError, match="nope/kernel"):
        tml.extract_tensorflow_weights(prefix, var_order=["nope/kernel"])


def test_mismatch_and_missing_graph_messages(tf1_checkpoint, tmp_path):
    """The JAX package's messages: a graph the checkpoint does not fit names
    ``var_order``; no ``.meta`` and no ``graph_json`` asks for one."""
    import shutil
    prefix, _ = tf1_checkpoint

    def wrong_graph():
        x = jnn.placeholder([None, 9], name="x")
        out = jnn.dense(x, 2, name="out")
        jnn.mean_squared_error(x, out)

    for mod in (tml, jml):
        kw = {"device": "cpu"} if mod is tml else {}
        with pytest.raises(ValueError, match="var_order"):
            mod.load_tensorflow_model(prefix, "features", "x:0",
                                      "out/BiasAdd:0",
                                      graph_json=build_graph(wrong_graph),
                                      **kw)
    stripped = str(tmp_path / "to_load")
    for suf in (".index", ".data-00000-of-00001"):
        shutil.copy(prefix + suf, stripped + suf)
    with pytest.raises(ValueError, match="graph_json is required"):
        tml.load_tensorflow_model(stripped, "features", "x:0", "out:0",
                                  device="cpu")


def test_shape_matching_survives_nonalphabetical_scopes(tf, tmp_path):
    """Hand-named scopes whose names sort against creation order land on
    the right slots by shape, in both packages alike."""
    tf1 = tf.compat.v1
    rs = np.random.RandomState(4)
    w = [rs.randn(4, 6).astype(np.float32), rs.randn(6).astype(np.float32),
         rs.randn(6, 2).astype(np.float32), rs.randn(2).astype(np.float32)]
    prefix = str(tmp_path / "hand")
    g = tf1.Graph()
    with g.as_default():
        with tf1.variable_scope("zeta"):
            tf1.get_variable("kernel", initializer=w[0])
            tf1.get_variable("bias", initializer=w[1])
        with tf1.variable_scope("alpha"):
            tf1.get_variable("kernel", initializer=w[2])
            tf1.get_variable("bias", initializer=w[3])
        with tf1.Session(graph=g) as sess:
            sess.run(tf1.global_variables_initializer())
            tf1.train.Saver().save(sess, prefix, write_meta_graph=False)

    def graph():
        x = jnn.placeholder([None, 4], name="x")
        h = jnn.dense(x, 6, activation="relu")
        jnn.dense(h, 2, name="out")

    x = rs.randn(5, 4).astype(np.float32)
    got, want = _both("load_tensorflow_model", x, path=prefix,
                      inputCol="features", tfInput="x:0",
                      tfOutput="out/BiasAdd:0", graph_json=build_graph(graph))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, _manual_forward(w, x), atol=1e-5,
                               rtol=1e-5)


def test_batch_norm_moving_statistics_are_baked_in(tf, tmp_path):
    """A trained BN model serves with the checkpoint's moving statistics
    (baked into the graph JSON, no fresh-init warning), equal to the JAX
    package's import and to a live tf.Session."""
    from sparkflow_tpu_torch.convert import list_to_params
    from sparkflow_tpu_torch.ml_util import convert_json_to_weights
    from sparkflow_tpu_torch.models import model_from_json
    tf1 = tf.compat.v1
    rs = np.random.RandomState(3)
    mm_v = rs.randn(6).astype(np.float32)
    mv_v = (rs.rand(6) + 0.5).astype(np.float32)
    x = rs.randn(5, 4).astype(np.float32)
    prefix = str(tmp_path / "bn_model")
    g = tf1.Graph()
    with g.as_default():
        xp = tf1.placeholder(tf.float32, [None, 4], name="x")
        with tf1.variable_scope("dense"):
            k = tf1.get_variable("kernel",
                                 initializer=rs.randn(4, 6).astype(np.float32))
            b = tf1.get_variable("bias",
                                 initializer=rs.randn(6).astype(np.float32))
        h = tf1.nn.bias_add(tf1.matmul(xp, k), b)
        with tf1.variable_scope("bn"):
            gamma = tf1.get_variable(
                "gamma", initializer=rs.randn(6).astype(np.float32))
            beta = tf1.get_variable(
                "beta", initializer=rs.randn(6).astype(np.float32))
            mm = tf1.get_variable("moving_mean", trainable=False,
                                  initializer=mm_v)
            mv = tf1.get_variable("moving_variance", trainable=False,
                                  initializer=mv_v)
        n, _, _ = tf1.nn.fused_batch_norm(
            tf1.reshape(h, [-1, 1, 1, 6]), gamma, beta, mean=mm, variance=mv,
            is_training=False)
        tf1.identity(tf1.reshape(n, [-1, 6]), name="out")
        with tf1.Session(graph=g) as sess:
            sess.run(tf1.global_variables_initializer())
            tf_out = sess.run("out:0", {"x:0": x})
            tf1.train.Saver().save(sess, prefix)

    stage = tml.load_tensorflow_model(prefix, "features", "x:0", "out:0",
                                      device="cpu")
    m = model_from_json(stage.getOrDefault(stage.modelJson), device="cpu")
    params = list_to_params(m, convert_json_to_weights(
        stage.getOrDefault(stage.modelWeights)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the stats are baked: no warning
        out = m.apply(params, {"x": x}, ["out:0"])["out:0"].numpy()
    np.testing.assert_allclose(out, tf_out, atol=1e-5)
    jstage = jml.load_tensorflow_model(prefix, "features", "x:0", "out:0")
    assert (stage.getOrDefault(stage.modelJson)
            == jstage.getOrDefault(jstage.modelJson))
    got, want = _predict(stage, x, False), _predict(jstage, x, True)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bake_refuses_a_name_that_is_not_a_variable():
    from sparkflow_tpu_torch.tf1_compat import bake_nontrainable_values
    mg = open(os.path.join(FIXTURES, "mnist_mlp.json")).read()
    with pytest.raises(ValueError, match="not a variable node"):
        bake_nontrainable_values(mg, {"x": np.zeros(2, np.float32)})


# -- torch state_dict import ----------------------------------------------------

def test_torch_state_dict_serves_like_jax_and_torch(tmp_path):
    """A torch MLP's ``state_dict`` (Linear weights transposed by shape)
    serves the module's own forward, in both packages alike."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                              torch.nn.Linear(8, 2), torch.nn.Sigmoid())
    path = str(tmp_path / "mlp.pt")
    torch.save(net.state_dict(), path)

    def graph():
        x = jnn.placeholder([None, 4], name="x")
        h = jnn.dense(x, 8, activation="relu")
        jnn.dense(h, 2, activation="sigmoid", name="out")

    x = np.random.RandomState(0).randn(6, 4).astype(np.float32)
    got, want = _both("load_torch_model", x, path=path,
                      graph_json=build_graph(graph), inputCol="features",
                      tfInput="x:0", tfOutput="out:0", predictionCol="p")
    with torch.no_grad():
        expect = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, expect, atol=1e-5)


def test_torch_conv_weights_permute_to_hwio(tmp_path):
    torch.manual_seed(1)
    net = torch.nn.Sequential(torch.nn.Conv2d(1, 3, 3, padding=1),
                              torch.nn.ReLU(), torch.nn.Flatten(),
                              torch.nn.Linear(3 * 16, 2))
    path = str(tmp_path / "cnn.pt")
    torch.save(net.state_dict(), path)

    def graph():
        x = jnn.placeholder([None, 4, 4, 1], name="x")
        c = jnn.conv2d(x, 3, 3, padding="same", activation="relu")
        jnn.dense(jnn.flatten(c), 2, name="out")

    gj = build_graph(graph)
    got = tml.extract_torch_weights(path, gj)
    want = jml.extract_torch_weights(path, gj)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        got[0], net[0].weight.detach().numpy().transpose(2, 3, 1, 0))


def test_torch_shape_mismatch_fails_loudly(tmp_path):
    torch.manual_seed(0)
    path = str(tmp_path / "lin.pt")
    torch.save(torch.nn.Linear(5, 3).state_dict(), path)

    def graph():
        x = jnn.placeholder([None, 4], name="x")
        jnn.dense(x, 2, name="out")

    with pytest.raises(ValueError, match="no torch state_dict tensor fits"):
        tml.extract_torch_weights(path, build_graph(graph))
    with pytest.raises(ValueError, match="var_order has 1 names"):
        tml.extract_torch_weights(path, build_graph(graph),
                                  var_order=["weight"])


# -- no TensorFlow ---------------------------------------------------------------

_NO_TF = r"""
import importlib, pkgutil, sys
sys.modules["tensorflow"] = None
sys.modules["google.protobuf"] = None
sys.modules["jax"] = None
import numpy as np
import sparkflow_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if not m.name.endswith(".__main__"):    # a package's program, not a module
        importlib.import_module(m.name)
from sparkflow_tpu_torch.model_loader import extract_tensorflow_weights
try:
    extract_tensorflow_weights("nowhere")
except ImportError as e:
    assert "needs TensorFlow installed" in str(e), e
else:
    raise AssertionError("no ImportError")
from sparkflow_tpu_torch.trainer import Trainer
mg = open(sys.argv[1]).read()
rs = np.random.RandomState(0)
x = rs.rand(32, 784).astype(np.float32)
y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 32)]
res = Trainer(mg, "x:0", "y:0", optimizer="adam", learning_rate=1e-3,
              iters=3, mini_batch_size=16, device="cpu").fit(x, y)
assert np.isfinite(res.losses).all() and res.losses[-1] < res.losses[0]
print("ok", len(res.losses))
"""


def test_imports_and_trains_with_tensorflow_blocked():
    """With ``tensorflow``, ``google.protobuf`` (and ``jax``) blocked in
    ``sys.modules``, every module of the port imports, reading a Saver
    checkpoint raises the JAX package's ``ImportError`` message, and the
    MNIST MLP fixture trains."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _NO_TF,
         os.path.join(FIXTURES, "mnist_mlp.json")],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok 3")
