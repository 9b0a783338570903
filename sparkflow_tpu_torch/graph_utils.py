"""``build_graph`` + optimizer-config builders (reference: ``sparkflow/graph_utils.py``).

``build_graph(model_fn)`` runs the user's model function inside a fresh graph scope
and returns the JSON-serialized graph spec — the model wire format that travels as a
plain string Param through the Estimator, exactly like the reference's
``MessageToJson(export_meta_graph())`` string (``sparkflow/graph_utils.py:6-15``) but
a compact declarative spec instead of a TF1 protobuf dump.

The ``build_*_config`` helpers keep the reference's exact signatures
(``sparkflow/graph_utils.py:18-47``) so optimizer hyperparameter JSON round-trips
unchanged; ``use_locking`` is accepted for compatibility and ignored (synchronous
all-reduce training has no lock to take — see ``sparkflow_tpu_torch/optimizers.py``).
"""

from __future__ import annotations

import json
from typing import Callable

from . import nn
from .graphdef import GraphDef


def build_graph(func: Callable) -> str:
    """Run ``func`` (a model-definition function using :mod:`sparkflow_tpu_torch.nn`)
    in a fresh graph scope and return the JSON graph spec."""
    with nn.graph_scope() as g:
        func()
    if not g.nodes:
        raise ValueError("model function built an empty graph — use sparkflow_tpu_torch.nn "
                         "ops (nn.placeholder, nn.dense, ...) inside it")
    return g.to_json()


def generate_config(**kwargs) -> str:
    return json.dumps(kwargs)


def build_adam_config(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                      use_locking=False) -> str:
    return generate_config(learning_rate=learning_rate, beta1=beta1,
                           beta2=beta2, epsilon=epsilon, use_locking=use_locking)


def build_rmsprop_config(learning_rate=0.001, decay=0.9, momentum=0.0, epsilon=1e-10,
                         use_locking=False, centered=False) -> str:
    return generate_config(learning_rate=learning_rate, decay=decay, momentum=momentum,
                           epsilon=epsilon, use_locking=use_locking, centered=centered)


def build_momentum_config(learning_rate=0.001, momentum=0.9, use_locking=False,
                          use_nesterov=False) -> str:
    return generate_config(learning_rate=learning_rate, momentum=momentum,
                           use_locking=use_locking, use_nesterov=use_nesterov)


def build_adadelta_config(learning_rate=0.001, rho=0.95, epsilon=1e-8,
                          use_locking=False) -> str:
    return generate_config(learning_rate=learning_rate, rho=rho, epsilon=epsilon,
                           use_locking=use_locking)


def build_adagrad_config(learning_rate=0.001, initial_accumulator=0.1,
                         use_locking=False) -> str:
    return generate_config(learning_rate=learning_rate,
                           initial_accumulator=initial_accumulator,
                           use_locking=use_locking)


def build_gradient_descent(learning_rate=0.001, use_locking=False) -> str:
    return generate_config(learning_rate=learning_rate, use_locking=use_locking)


def build_ftrl_config(learning_rate=0.001, learning_rate_power=-0.5,
                      initial_accumulator_value=0.1,
                      l1_regularization_strength=0.0,
                      l2_regularization_strength=0.0, use_locking=False) -> str:
    return generate_config(learning_rate=learning_rate,
                           learning_rate_power=learning_rate_power,
                           initial_accumulator_value=initial_accumulator_value,
                           l1_regularization_strength=l1_regularization_strength,
                           l2_regularization_strength=l2_regularization_strength,
                           use_locking=use_locking)
