"""PyTorch port, the ``nn`` graph DSL: ``build_graph`` JSON, each op of
``GraphModel`` and the ``Trainer`` on a graph model, against the JAX
package on the same numpy-drawn weights and inputs.

Tolerances, float32: the graph JSON and the config builders' JSON are
byte-identical; per op, the forward output, the per-example loss and the
gradients with respect to every weight and the float input agree within
1e-5 absolute plus 1e-5 relative; ``Trainer`` per-epoch losses within 2e-4
relative and final weights within 1e-5 absolute (sweep mode, no shuffle,
the same initial weights). Dropout is compared only where it is the
identity (keep = 1): ``jax.random`` and ``torch.Generator`` draw
differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparkflow_tpu.graph_utils as jgu
import sparkflow_tpu.nn as jnn
import sparkflow_tpu_torch.graph_utils as tgu
import sparkflow_tpu_torch.nn as tnn
from test_torch_shared import numpy_params
from sparkflow_tpu.graphdef import GraphModel as JaxGraphModel
from sparkflow_tpu.graphdef import params_to_list as jax_to_list
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu_torch.convert import params_from_jax
from sparkflow_tpu_torch.graphdef import GraphDef, GraphModel, list_to_params
from sparkflow_tpu_torch.models import model_from_json
from sparkflow_tpu_torch.trainer import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)


# -- (a) build_graph JSON ------------------------------------------------------
# the estimator suite's models (tests/test_estimator.py, reference
# dl_runner.py:42-73), written against either package's nn module

def create_model(nn):
    x = nn.placeholder([None, 2], name="x")
    y = nn.placeholder([None, 1], name="y")
    layer1 = nn.dense(x, 12, activation="relu")
    layer2 = nn.dense(layer1, 5, activation="relu")
    out = nn.dense(layer2, 1, activation="sigmoid", name="outer")
    nn.sigmoid_cross_entropy(y, out)


def create_random_model(nn):
    x = nn.placeholder([None, 10], name="x")
    y = nn.placeholder([None, 1], name="y")
    layer1 = nn.dense(x, 12, activation="relu")
    out = nn.dense(layer1, 1, activation="sigmoid", name="outer")
    nn.log_loss(y, out)


def create_autoencoder(nn):
    x = nn.placeholder([None, 10], name="x")
    layer1 = nn.dense(x, 5, activation="relu")
    layer2 = nn.dense(layer1, 2, activation="relu", name="out")
    layer3 = nn.dense(layer2, 5, activation="relu")
    out = nn.dense(layer3, 10, activation="sigmoid", name="outer")
    nn.mean_squared_error(x, out)


def create_cnn(nn):
    """SAME and VALID convolutions and pools at stride 2 over an odd and an
    even spatial size (TF's SAME pads the odd pixel after), a keep-prob
    placeholder and a softmax head."""
    x = nn.placeholder([None, 7, 8, 3], name="x")
    y = nn.placeholder([None, 4], name="y")
    keep = nn.placeholder_with_default(1.0, [], name="keep")
    h = nn.conv2d(x, 5, 3, strides=2, padding="same", activation="relu")
    h = nn.max_pooling2d(h, 2, strides=2, padding="same")
    g = nn.conv2d(x, 4, (3, 2), strides=(2, 1), padding="valid")
    g = nn.avg_pooling2d(g, 3, strides=2, padding="same")
    h = nn.concat([nn.flatten(h), nn.flatten(g)], axis=1)
    h = nn.dropout(h, keep_prob=keep)
    out = nn.dense(h, 4, name="out")
    nn.argmax(out, 1, name="label")
    nn.softmax_cross_entropy(y, out)


MODELS = {"create_model": create_model,
          "create_random_model": create_random_model,
          "create_autoencoder": create_autoencoder, "cnn": create_cnn}


def _graphs(fn):
    j = jgu.build_graph(lambda: fn(jnn))
    t = tgu.build_graph(lambda: fn(tnn))
    return j, t


@pytest.mark.parametrize("name", sorted(MODELS))
def test_build_graph_json_is_byte_identical(name):
    j, t = _graphs(MODELS[name])
    assert t == j
    # and it round-trips through the port's GraphDef unchanged
    assert GraphDef.from_json(t).to_json() == t


@pytest.mark.parametrize("builder,kw", [
    ("build_adam_config", dict(learning_rate=0.1, beta1=0.85, beta2=0.98)),
    ("build_rmsprop_config", dict(learning_rate=0.1, decay=0.95)),
    ("build_momentum_config", dict(momentum=0.8, use_nesterov=True)),
    ("build_adadelta_config", {}), ("build_adagrad_config", {}),
    ("build_gradient_descent", dict(learning_rate=0.3)),
    ("build_ftrl_config", dict(l1_regularization_strength=0.1))])
def test_config_builders_match(builder, kw):
    assert getattr(tgu, builder)(**kw) == getattr(jgu, builder)(**kw)


def test_registry_dispatches_graph_specs_and_refuses_tf1():
    _, t = _graphs(create_model)
    assert isinstance(model_from_json(t, device="cpu"), GraphModel)
    # a TF1 MetaGraphDef JSON goes to the TF1 interpreter (no longer
    # refused), which refuses an op it does not know by name
    from sparkflow_tpu_torch.tf1_compat import TF1GraphModel
    tf1 = '{"metaInfoDef": {}, "graphDef": {"node": []}}'
    assert isinstance(model_from_json(tf1, device="cpu"), TF1GraphModel)
    bad = ('{"graphDef": {"node": [{"name": "w", "op": "SparseSegmentMean"}'
           ']}}')
    with pytest.raises(NotImplementedError, match="SparseSegmentMean"):
        model_from_json(bad, device="cpu").apply({}, {}, ["w:0"])


# -- (b) each op: forward, loss and gradients ---------------------------------

def _dense_in(nn):
    return nn.placeholder([None, 6], name="x"), nn.placeholder([None, 3], name="y")


def _act_case(act):
    def build(nn):
        x, y = _dense_in(nn)
        h = nn.dense(x, 5, activation=act)
        out = nn.dense(h, 3, name="out")
        nn.mean_squared_error(y, out)
    return build


def _conv_case(pad, stride):
    def build(nn):
        x = nn.placeholder([None, 7, 8, 2], name="x")
        y = nn.placeholder([None, 3], name="y")
        h = nn.conv2d(x, 4, 3, strides=stride, padding=pad)
        out = nn.dense(nn.flatten(h), 3, name="out")
        nn.mean_squared_error(y, out)
    return build


def _pool_case(op, pad):
    def build(nn):
        x = nn.placeholder([None, 7, 8, 2], name="x")
        y = nn.placeholder([None, 3], name="y")
        h = getattr(nn, op)(x, 3, strides=2, padding=pad)
        out = nn.dense(nn.flatten(h), 3, name="out")
        nn.mean_squared_error(y, out)
    return build


def _norm_case(op):
    def build(nn):
        x, y = _dense_in(nn)
        h = getattr(nn, op)(nn.dense(x, 5))
        out = nn.dense(h, 3, name="out")
        nn.mean_squared_error(y, out)
    return build


def _loss_case(op, labels):
    def build(nn):
        x = nn.placeholder([None, 6], name="x")
        y = nn.placeholder([None, 3], name="y")
        out = nn.dense(x, 3, name="out")
        pred = nn.sigmoid(out) if labels == "prob" else out
        getattr(nn, op)(y, pred)
    return build


def _embedding(nn):
    ids = nn.placeholder([None, 5], name="x", dtype="int32")
    y = nn.placeholder([None, 3], name="y")
    e = nn.embedding(ids, 11, 4)
    out = nn.dense(nn.flatten(e), 3, name="out")
    nn.softmax_cross_entropy(y, out)


def _dropout(nn):
    x, y = _dense_in(nn)
    keep = nn.placeholder([], name="keep")
    h = nn.dropout(nn.dense(x, 5, activation="tanh"), keep_prob=keep)
    h = nn.dropout(h, rate=0.0)
    out = nn.dense(h, 3, name="out")
    nn.mean_squared_error(y, out)


def _arith(nn):
    x, y = _dense_in(nn)
    w = nn.placeholder([6, 3], name="w")
    a = nn.dense(x, 3)
    b = nn.matmul(x, w)
    h = nn.concat([a * b - 0.5, a + 2.0], axis=-1)
    h = nn.reshape(h, [-1, 2, 3])
    out = nn.dense(nn.flatten(h), 3, name="out")
    nn.huber_loss(y, out, delta=0.7)
    nn.argmax(out, 1, name="label")


OP_CASES = {
    "dense": _act_case(None),
    **{f"act_{a}": _act_case(a) for a in (
        "relu", "sigmoid", "tanh", "softmax", "log_softmax", "gelu", "elu",
        "leaky_relu", "softplus", "swish")},
    **{f"conv_{p}_s{s}": _conv_case(p, s) for p in ("same", "valid")
       for s in (1, 2)},
    **{f"{op}_{p}": _pool_case(op, p) for op in ("max_pooling2d",
                                                  "avg_pooling2d")
       for p in ("same", "valid")},
    "layer_norm": _norm_case("layer_norm"),
    "batch_norm": _norm_case("batch_norm"),
    "embedding": _embedding,
    "dropout_keep_1": _dropout,
    "arith_reshape_concat": _arith,
    **{f"loss_{op}": _loss_case(op, lab) for op, lab in (
        ("softmax_cross_entropy", "prob"), ("sigmoid_cross_entropy", "any"),
        ("mean_squared_error", "any"), ("absolute_difference", "any"),
        ("huber_loss", "any"), ("log_loss", "prob"))},
}


def _feeds(jm, rs, n=4):
    feeds = {}
    for name, (shape, dtype) in jm.input_specs().items():
        shape = [n if d is None else d for d in shape]
        if name == "keep":
            feeds[name] = np.float32(1.0)
        elif dtype == "int32":
            feeds[name] = rs.randint(0, 11, shape).astype(np.float32)
        elif name == "y":
            feeds[name] = rs.uniform(0.05, 0.95, shape).astype(np.float32)
        else:
            feeds[name] = rs.normal(0, 1, shape).astype(np.float32)
    return feeds


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_forward_loss_and_gradients_match_jax(case):
    jg, tg = _graphs(OP_CASES[case])
    assert tg == jg
    jm, tm = JaxGraphModel.from_json(jg), GraphModel.from_json(tg, device="cpu")
    assert tm.param_specs() == jm.param_specs()
    npp = numpy_params(jm.param_specs(), seed=len(case), std=0.2)
    feeds = _feeds(jm, np.random.RandomState(len(case)))
    outs = ["out:0"] + (["label:0"] if "label:0" in jm.graphdef.aliases else [])
    grad_x = "x" if case != "embedding" else None

    jp = jax.tree.map(jnp.asarray, npp)
    jf = {k: jnp.asarray(v) for k, v in feeds.items()}
    want = jm.apply(jp, jf, outs, train=True, rng=jax.random.PRNGKey(0))

    def jloss(p, x):
        f = dict(jf, **({grad_x: x} if grad_x else {}))
        lv = jm.loss_vector(p, f, train=True, rng=jax.random.PRNGKey(0))
        return jnp.sum(lv), lv

    (_, jlv), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(jp, jf["x"])

    tp = params_from_jax(tm, npp)
    for layer in tp.values():
        for t in layer.values():
            t.requires_grad_(True)
    tf = {k: torch.from_numpy(np.asarray(v)) for k, v in feeds.items()}
    if grad_x:
        tf[grad_x] = tf[grad_x].clone().requires_grad_(True)
    gen = torch.Generator().manual_seed(0)
    got = tm.apply(tp, tf, outs, train=True, generator=gen)
    for o in outs:
        np.testing.assert_allclose(got[o].detach().numpy(),
                                   np.asarray(want[o]), **TOL)
    lv = tm.loss_vector(tp, tf, train=True, generator=gen)
    np.testing.assert_allclose(lv.detach().numpy(), np.asarray(jlv), **TOL)
    leaves = [tp[ln][pn] for ln, ps in tm.param_specs().items() for pn in ps]
    grads = torch.autograd.grad(lv.sum(), leaves + ([tf["x"]] if grad_x
                                                    else []))
    want_g = jax_to_list(jm, jgp) + ([np.asarray(jgx)] if grad_x else [])
    assert len(grads) == len(want_g)
    for g, w in zip(grads, want_g):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_dropout_draws_from_the_generator_and_predict_is_identity():
    """keep < 1 in training drops about 1 - keep of the units, scaled by
    1 / keep, repeatably for one generator seed; outside training (and at a
    fed keep of 1) dropout is the identity."""
    _, tg = _graphs(_dropout)
    tm = GraphModel.from_json(tg, device="cpu")
    x = torch.randn(64, 6)
    tp = tm.init(seed=3)
    h = "dropout:0"
    feeds = {"x": x, "keep": torch.tensor(0.25)}
    plain = tm.apply(tp, dict(feeds, keep=torch.tensor(1.0)), [h],
                     train=True)[h]
    a = tm.apply(tp, feeds, [h], train=True,
                 generator=torch.Generator().manual_seed(1))[h]
    b = tm.apply(tp, feeds, [h], train=True,
                 generator=torch.Generator().manual_seed(1))[h]
    assert torch.equal(a, b)
    kept = a != 0
    assert 0.15 < kept.float().mean() < 0.35
    torch.testing.assert_close(a[kept], plain[kept] * 4)
    assert torch.equal(tm.apply(tp, feeds, [h], train=False)[h], plain)


def test_initializers_follow_the_jax_distributions():
    """The draws differ from jax.random's; their distributions must not:
    glorot_uniform's bound sqrt(6 / (fan_in + fan_out)), he_normal's
    std sqrt(2 / fan_in) truncated at 2 std, conv fans times H x W."""
    from sparkflow_tpu_torch.graphdef import initialize
    g = torch.Generator().manual_seed(0)
    w = initialize("glorot_uniform", (300, 200), g)
    lim = np.sqrt(6 / 500)
    assert float(w.abs().max()) <= lim and float(w.abs().max()) > 0.99 * lim
    w = initialize("he_normal", (3, 3, 40, 64), g)
    std = np.sqrt(2 / (9 * 40))
    assert abs(float(w.std()) - std) < 0.03 * std
    assert float(w.abs().max()) <= 2 * std / .87962566103423978 + 1e-6
    assert float(initialize("normal(0.02)", (1000,), g).std()) == \
        pytest.approx(0.02, rel=0.1)
    with pytest.raises(ValueError, match="unknown initializer"):
        initialize("orthogonal", (2, 2), g)


# -- (c) the Trainer on a graph model -----------------------------------------

def _mlp_data(n=48, d=6, seed=21):
    rs = np.random.RandomState(seed)
    x = rs.normal(0, 1, (n, d)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]
    return x, y


def _two_input(nn):
    a = nn.placeholder([None, 4], name="a")
    b = nn.placeholder([None, 2], name="b")
    y = nn.placeholder([None, 3], name="y")
    keep = nn.placeholder_with_default(1.0, [], name="keep")
    h = nn.dense(nn.concat([a, b], axis=1), 8, activation="tanh")
    h = nn.dropout(h, keep_prob=keep)
    out = nn.dense(h, 3, name="out")
    nn.softmax_cross_entropy(y, out)


@pytest.mark.parametrize("model,optimizer,options", [
    ("cnn", "gradient_descent", None),
    ("two_input", "adam", {"learning_rate": 0.05, "epsilon": 1e-6}),
], ids=["cnn_sgd", "two_input_adam"])
def test_trainer_on_graph_model_matches_jax_trainer(model, optimizer,
                                                    options):
    """2 epochs x 3 sweep batches from the same initial weights: the
    per-epoch losses and the final weights; the dropout placeholder is left
    at its default of 1 while training and fed at predict time."""
    fn = create_cnn if model == "cnn" else _two_input
    jg, tg = _graphs(fn)
    rs = np.random.RandomState(5)
    if model == "cnn":
        names = "x:0"
        feats = rs.normal(0, 1, (24, 7, 8, 3)).astype(np.float32)
        labels = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 24)]
    else:
        names = ["a:0", "b:0"]
        x, labels = _mlp_data(24)
        feats = (x[:, :4].copy(), x[:, 4:].copy())
    npp = numpy_params(JaxGraphModel.from_json(jg).param_specs(), seed=6,
                       std=0.3)
    kw = dict(optimizer=optimizer, learning_rate=0.1, iters=2,
              mini_batch_size=8, shuffle_per_iter=False, seed=0,
              optimizer_options=options, dropout_name="keep:0")
    jt = JaxTrainer(jg, names, "y:0", **kw)
    jr = jt.fit(feats, labels, init_params=npp)
    tt = Trainer(GraphDef.from_json(tg), names, "y:0", device="cpu", **kw)
    tr = tt.fit(feats, labels, init_params=npp)
    assert tt._plan(24) == jt._plan(24) == ("sweep", 8, 3)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=2e-4)
    for got, want in zip(tt.weights_list(), jax_to_list(jt.model, jt.params)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert tr.losses[-1] < tr.losses[0]
    out = "out:0"
    jpred = np.asarray(jt.predict_fn(out, dropout_value=1.0)(
        jt.params, tuple(map(jnp.asarray, feats)) if model != "cnn"
        else jnp.asarray(feats)))
    tpred = tt.predict_fn(out, dropout_value=1.0)(tt.params, feats)
    np.testing.assert_allclose(tpred.numpy(), jpred, **TOL)


def test_weight_list_round_trip_keeps_the_spec_order():
    _, tg = _graphs(create_cnn)
    tm = GraphModel.from_json(tg, device="cpu")
    tree = tm.init(seed=1)
    from sparkflow_tpu_torch.graphdef import params_to_list
    flat = params_to_list(tm, tree)
    assert [w.shape for w in flat] == [tuple(s) for ps in
                                       tm.param_specs().values()
                                       for s, _ in ps.values()]
    back = list_to_params(tm, flat)
    assert all(torch.equal(back[ln][pn], tree[ln][pn])
               for ln, ps in tree.items() for pn in ps)
    with pytest.raises(ValueError, match="model needs"):
        list_to_params(tm, flat[:-1])
