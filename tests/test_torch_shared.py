"""Shared set-up for the PyTorch-port parity tests (tests/test_torch_*.py;
this module holds no tests itself):
one small transformer_lm configuration, built in both packages, with
weights drawn by numpy from a seed and handed to both, and the prompts and
drive loop the engine parity tests share."""

import os

import numpy as np

# Every test process runs torch's CPU ops on one thread, and so do the rank
# processes it spawns (they inherit the environment): the suite runs in
# several workers at once, and each worker's threaded ops would spin on
# every core. Collection imports this module in every worker.
os.environ.setdefault("OMP_NUM_THREADS", "1")


def _one_thread():
    import torch
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))


_one_thread()

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


SYS = [11, 3, 5, 8, 2, 9, 4, 6, 1, 13, 12, 10]      # shared system prefix
PROMPTS = [[5, 2, 8], list(range(1, 25)), [33], SYS + [17, 18],
           SYS + [17, 19, 20], [7, 7, 40, 41, 42, 43, 44, 45, 46]]
NEW = 6


def _drive(eng, prompt, n):
    """n greedy tokens for one request, riding out a chunked prefill."""
    info = eng.prefill(prompt, max_new_tokens=n, temperature=0.0)
    toks = [] if info["token"] is None else [info["token"]]
    while len(toks) < n:
        toks.extend(eng.step().get(info["slot"], []))
    eng.release(info["slot"])
    return toks[:n], info


def _run_all(eng):
    out = [_drive(eng, p, NEW)[0] for p in PROMPTS]
    out.append(_drive(eng, SYS + [17, 18], NEW)[0])   # prefix-hit replay
    return out


def to_torch(a):
    """A JAX or numpy array as a torch tensor; fp8 (e4m3fn) is carried bit
    for bit (torch.from_numpy does not take ml_dtypes arrays)."""
    import torch
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())
