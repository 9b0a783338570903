"""PyTorch port, optimizers: every named optimizer and every wrapper of
``build_optimizer`` against the JAX package's (optax) for 5 steps on the
same numpy parameters and gradients.

Tolerance 1e-6 (absolute and relative) in float32: both sides run the same
update rule in float32; only the rounding of a few scalar factors (bias
corrections, schedule values) may differ in the last bit.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparkflow_tpu import optimizers as jopt
from sparkflow_tpu_torch import optimizers as topt

TOL = dict(atol=1e-6, rtol=1e-6)
STEPS = 5
SHAPES = {"dense": {"kernel": (3, 4), "bias": (4,)}, "head": {"w": (5,)}}

L12 = {"l1_regularization_strength": 0.01, "l2_regularization_strength": 0.02}
CASES = [
    ("adam", None),
    ("adam", {"learning_rate": 0.05, "beta1": 0.8, "beta2": 0.99,
              "epsilon": 1e-6}),
    ("adam", {"learning_rate": 0.05, "mu_dtype": "bfloat16"}),
    ("rmsprop", None),
    ("rmsprop", {"learning_rate": 0.01, "centered": True, "momentum": 0.5}),
    ("momentum", None),
    ("momentum", {"learning_rate": 0.05, "momentum": 0.8,
                  "use_nesterov": True}),
    ("adadelta", {"learning_rate": 1.0, "rho": 0.9}),
    ("adagrad", None),
    ("gradient_descent", None),
    ("no_such_optimizer", None),               # falls back to SGD
    ("ftrl", dict(L12, learning_rate=0.1)),
    ("adagrad_da", dict(L12, learning_rate=0.1)),
    ("proximal_adagrad", dict(L12, learning_rate=0.1)),
    ("proximal_gradient_descent", dict(L12, learning_rate=0.1)),
    ("adam", {"learning_rate": 0.05, "clip_value": 0.3}),
    ("adam", {"learning_rate": 0.05, "clip_norm": 0.5}),
    ("momentum", {"learning_rate": 0.05, "clip_norm": 100.0}),  # no clip
    ("adam", {"learning_rate": 0.05, "weight_decay": 0.1}),
    ("adam", {"learning_rate": 0.05, "grad_accum_steps": 2}),
    ("adam", {"learning_rate": 0.05,
              "schedule": {"type": "warmup_cosine", "warmup_steps": 2,
                           "decay_steps": 4, "end_factor": 0.1}}),
    ("gradient_descent", {"learning_rate": 0.1,
                          "schedule": {"type": "linear", "decay_steps": 3,
                                       "end_factor": 0.2}}),
    ("gradient_descent", {"learning_rate": 0.1,
                          "schedule": {"type": "exponential",
                                       "decay_steps": 2,
                                       "decay_rate": 0.5}}),
    ("gradient_descent", {"learning_rate": 0.1,
                          "schedule": {"type": "cosine", "decay_steps": 4}}),
    ("gradient_descent", {"learning_rate": 0.1, "schedule": "warmup"}),
    ("adam", {"learning_rate": 0.05, "ema_decay": 0.9}),
    ("adam", {"learning_rate": 0.05, "ema_decay": 0.8,
              "grad_accum_steps": 2, "clip_norm": 1.0}),
]


def _tree(rs, scale=1.0):
    return {ln: {pn: (rs.randn(*shape) * scale).astype(np.float32)
                 for pn, shape in layer.items()}
            for ln, layer in SHAPES.items()}


def _flat(tree):
    return [np.asarray(tree[ln][pn]) for ln in SHAPES for pn in SHAPES[ln]]


@pytest.mark.parametrize("name,options", CASES,
                         ids=[f"{i}-{n}" for i, (n, _) in enumerate(CASES)])
def test_optimizer_matches_jax(name, options):
    rs = np.random.RandomState(0)
    init = _tree(rs)
    grads = [_tree(rs, scale=0.5) for _ in range(STEPS)]

    jo = jopt.build_optimizer(name, 0.01, options)
    jp = {ln: {pn: jnp.asarray(a) for pn, a in layer.items()}
          for ln, layer in init.items()}
    js = jo.init(jp)
    to = topt.build_optimizer(name, 0.01, options)
    tp = {ln: {pn: torch.from_numpy(a.copy()) for pn, a in layer.items()}
          for ln, layer in init.items()}
    ts = to.init(tp)
    for g in grads:
        ju, js = jo.update({ln: {pn: jnp.asarray(a) for pn, a in l.items()}
                            for ln, l in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = to.update({ln: {pn: torch.from_numpy(a) for pn, a in l.items()}
                            for ln, l in g.items()}, ts, tp)
        tp = topt.apply_updates(tp, tu)
    for want, got in zip(_flat(jp), _flat(tp)):
        np.testing.assert_allclose(got, want, **TOL)
    if options and "ema_decay" in options:
        jema, tema = jopt.extract_ema_params(js), topt.extract_ema_params(ts)
        for want, got in zip(_flat(jema), _flat(tema)):
            np.testing.assert_allclose(got, want, **TOL)


def test_optimizer_registry_and_json():
    assert topt.AVAILABLE_OPTIMIZERS == jopt.AVAILABLE_OPTIMIZERS
    t = topt.build_optimizer_from_json("momentum", 0.1,
                                       '{"momentum": 0.5}')
    p = {"a": {"w": torch.ones(2)}}
    s = t.init(p)
    u, s = t.update({"a": {"w": torch.ones(2)}}, s, p)
    np.testing.assert_allclose(u["a"]["w"].numpy(), [-0.1, -0.1], **TOL)
    assert topt.extract_ema_params(s) is None
    with pytest.raises(ValueError, match="ema_decay"):
        topt.build_optimizer("adam", 0.1, {"ema_decay": 1.5})
    with pytest.raises(ValueError, match="schedule type"):
        topt.build_optimizer("adam", 0.1, {"schedule": {"type": "bogus"}})
