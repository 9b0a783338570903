"""Shared set-up for the PyTorch-port parity tests (tests/test_torch_*.py;
this module holds no tests itself):
one small transformer_lm configuration, built in both packages, with
weights drawn by numpy from a seed and handed to both."""

import numpy as np

CFG = dict(vocab_size=61, hidden=32, num_layers=2, num_heads=4, mlp_dim=64,
           max_len=64, dropout=0.0)
PAGE = 8


def numpy_params(param_specs, seed=0, std=0.3):
    """A params tree following ``param_specs`` with weights large enough
    that greedy decoding wanders instead of repeating one token: kernels
    and embeddings N(0, std), norm scales near 1, biases near 0."""
    rng = np.random.default_rng(seed)
    tree = {}
    for lname, pspec in param_specs.items():
        layer = {}
        for pname, (shape, init) in pspec.items():
            if init == "ones":
                a = 1.0 + rng.normal(0.0, 0.05, shape)
            elif init == "zeros":
                a = rng.normal(0.0, 0.05, shape)
            else:
                a = rng.normal(0.0, std, shape)
            layer[pname] = a.astype(np.float32)
        tree[lname] = layer
    return tree


def jax_model():
    from sparkflow_tpu.models.registry import (build_registry_spec,
                                               model_from_json)
    return model_from_json(build_registry_spec("transformer_lm", **CFG))


def torch_model(**kw):
    from sparkflow_tpu_torch.models import (build_registry_spec,
                                            model_from_json)
    return model_from_json(build_registry_spec("transformer_lm", **CFG),
                           device="cpu", **kw)
