"""PyTorch port, hyperparameter parallelism: ``parallel/hyper.py``'s
vmapped learning-rate sweep against the JAX package's.

The JAX package's three cases (``tests/test_hyper.py``) run on the port
as they are. Then the sweep starts from fixed initial weights, handed to
both packages through the model object's ``init`` (the packages draw
initial weights from different streams), at full batch, where the shuffle
cannot matter: the loss curves within 1e-5 relative of JAX's, for an MLP
graph and a small transformer classifier (whose flash attention runs under
``torch.func.vmap`` through the wrapper's batching rule), and the best
params within 1e-5. The transformer sweeps with momentum: the key third of
every ``qkv_bias`` has an exactly-zero gradient, which each package
computes as round-off and adam divides by its epsilon (1e-8 in optax's
defaults, which the sweep uses; ``tests/test_torch_train.py``). Last, the
vmapped sweep equals K separate one-rate sweeps of the port within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparkflow_tpu.nn as jnn
import sparkflow_tpu_torch.nn as tnn
from test_torch_shared import numpy_params
from sparkflow_tpu.graph_utils import build_graph as jax_build_graph
from sparkflow_tpu.models import model_from_json as jax_model
from sparkflow_tpu.parallel.hyper import \
    hyperparameter_search as jax_search
from sparkflow_tpu_torch.graph_utils import build_graph
from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
from sparkflow_tpu_torch.parallel.hyper import hyperparameter_search


def clf(nn):
    x = nn.placeholder([None, 6], name="x")
    y = nn.placeholder([None, 1], name="y")
    h = nn.dense(x, 8, activation="relu")
    nn.sigmoid_cross_entropy(y, nn.dense(h, 1, name="out"))


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    X = rs.randn(200, 6).astype(np.float32)
    Y = (X @ rs.randn(6) > 0).astype(np.float32)
    return X, Y


# -- the JAX package's cases ------------------------------------------------


def test_vmapped_sweep_trains_every_config(data):
    X, Y = data
    lrs = [1e-4, 1e-2, 0.1]
    res = hyperparameter_search(build_graph(lambda: clf(tnn)), "x:0", "y:0",
                                X, Y, learning_rates=lrs, iters=12,
                                mini_batch_size=64, device="cpu")
    assert res.loss_curves.shape == (3, 12)
    # every config's loss decreased; faster rates learned more on this easy
    # problem than the tiny 1e-4 rate
    for k in range(3):
        assert res.loss_curves[k, -1] < res.loss_curves[k, 0]
    assert res.final_losses[1] < res.final_losses[0]
    assert res.best_learning_rate in (1e-2, 0.1)
    # best_params is a single (unbatched) params tree usable for inference
    from sparkflow_tpu_torch.core import make_predict_fn, predict_in_chunks
    m = model_from_json(build_graph(lambda: clf(tnn)), device="cpu")
    preds = predict_in_chunks(
        make_predict_fn(m, "x:0", "out/BiasAdd:0"), res.best_params, X)
    assert (((preds[:, 0] > 0.0) == (Y > 0.5)).mean()) > 0.8  # logits


def test_sweep_same_init_isolates_lr_effect(data):
    X, Y = data
    res = hyperparameter_search(build_graph(lambda: clf(tnn)), "x:0", "y:0",
                                X, Y, learning_rates=[0.0, 0.0], iters=3,
                                mini_batch_size=64, same_init=True,
                                device="cpu")
    # identical rates + identical init -> identical curves
    np.testing.assert_allclose(res.loss_curves[0], res.loss_curves[1],
                               rtol=1e-6)


def test_sweep_unknown_optimizer_falls_back(data):
    X, Y = data
    res = hyperparameter_search(build_graph(lambda: clf(tnn)), "x:0", "y:0",
                                X, Y, learning_rates=[0.5],
                                optimizer="not_real", iters=5,
                                mini_batch_size=64, device="cpu")
    assert res.loss_curves[0, -1] < res.loss_curves[0, 0]  # sgd fallback


# -- against the JAX package's sweep -----------------------------------------


CLS = dict(vocab_size=30, num_classes=2, hidden=32, num_layers=2,
           num_heads=4, mlp_dim=64, max_len=8, dropout=0.0)


def _fixed(jm, tm, p0):
    """The two models with ``init`` returning ``p0`` (numpy) as each
    package's tree."""
    jm.init = lambda *a, **k: jax.tree.map(jnp.asarray, p0)
    tm.init = lambda *a, **k: {ln: {n: torch.tensor(v) for n, v in d.items()}
                               for ln, d in p0.items()}
    return jm, tm


def _mlp_case(data):
    X, Y = data
    jm = jax_model(jax_build_graph(lambda: clf(jnn)))
    tm = model_from_json(build_graph(lambda: clf(tnn)), device="cpu")
    p0 = numpy_params(jm.param_specs(), seed=3, std=0.3)
    return _fixed(jm, tm, p0) + ("x:0", "y:0", X, Y)


def _transformer_case(_data):
    spec = build_registry_spec("transformer_classifier", **CLS)
    jm, tm = jax_model(spec), model_from_json(spec, device="cpu")
    p0 = numpy_params(jm.param_specs(), seed=4, std=0.1)
    rs = np.random.RandomState(5)
    ids = rs.randint(0, 30, (16, 8)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 16)]
    return _fixed(jm, tm, p0) + ("input_ids", "y", ids, y)


@pytest.mark.parametrize("case,opt", [
    (_mlp_case, "adam"), (_mlp_case, "momentum"),
    (_transformer_case, "momentum")],
    ids=["mlp-adam", "mlp-momentum", "transformer-momentum"])
def test_sweep_from_fixed_weights_matches_jax(data, case, opt):
    jm, tm, inp, lab, x, y = case(data)
    lrs = [1e-3, 1e-2, 5e-2]
    kw = dict(learning_rates=lrs, optimizer=opt, iters=4,
              mini_batch_size=x.shape[0])
    want = jax_search(jm, inp, lab, x, y, **kw)
    got = hyperparameter_search(tm, inp, lab, x, y, device="cpu", **kw)
    np.testing.assert_allclose(got.loss_curves, want.loss_curves, rtol=1e-5)
    assert got.best_index == want.best_index
    for ln, d in want.best_params.items():
        for k, v in d.items():
            np.testing.assert_allclose(got.best_params[ln][k].numpy(),
                                       np.asarray(v), atol=1e-5, rtol=1e-5,
                                       err_msg=f"{ln}/{k}")


def test_the_vmapped_sweep_equals_separate_fits(data):
    """K rates in one vmapped program against K one-rate sweeps (the same
    shuffles, the same initial weights)."""
    X, Y = data
    spec = build_graph(lambda: clf(tnn))
    lrs = [1e-3, 3e-2, 0.1]
    kw = dict(optimizer="adam", iters=3, mini_batch_size=64, seed=2,
              device="cpu")
    res = hyperparameter_search(spec, "x:0", "y:0", X, Y,
                                learning_rates=lrs, **kw)
    for i, lr in enumerate(lrs):
        one = hyperparameter_search(spec, "x:0", "y:0", X, Y,
                                    learning_rates=[lr], **kw)
        np.testing.assert_allclose(res.loss_curves[i], one.loss_curves[0],
                                   rtol=1e-6, atol=0)
