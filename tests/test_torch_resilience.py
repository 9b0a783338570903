"""PyTorch port, the rest of ``Trainer.fit``: checkpoints and resume,
preemption, ``run_resilient_fit``, step spans and ``utils/flops`` — within
the port, and against the JAX package on the same data and weights.

Within the port a crashed or preempted fit, resumed, must land on the
uninterrupted fit's weights bit for bit (the restored generators continue
the same shuffle and dropout streams). Across the packages the npz
checkpoints interchange: each package's ``CheckpointManager`` reads the
other's trainer checkpoint to bit-equal ``params``, ``opt_state`` and
``epoch`` (the JAX side is forced to npz by setting
``sparkflow_tpu.checkpoint._HAVE_ORBAX`` to False), while the random streams
do not (``rng_impl``), so each trainer refuses to continue the other's.
Models are small (an ``nn`` MLP 6-8-1, a 2-layer width-32
``transformer_lm`` with dropout 0.1); a fit with checkpoints on matches the
JAX ``Trainer`` within 1e-5 (float32, plain SGD, no shuffle), as
``tests/test_torch_train.py`` holds it without checkpoints.
"""

import json
import signal

import jax
import numpy as np
import pytest
import torch

import sparkflow_tpu.checkpoint as jax_ckpt
import sparkflow_tpu.nn as jnn
from sparkflow_tpu.graph_utils import build_graph as jax_build_graph
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu.trainer import _ckpt_state as jax_ckpt_state
from sparkflow_tpu.utils import flops as jax_flops
from sparkflow_tpu_torch import nn as tnn
from sparkflow_tpu_torch.checkpoint import CheckpointManager
from sparkflow_tpu_torch.convert import sorted_leaves
from sparkflow_tpu_torch.graph_utils import build_graph
from sparkflow_tpu_torch.models import build_registry_spec
from sparkflow_tpu_torch.resilience import (RetryExhausted, RetryPolicy,
                                            faults, run_resilient_fit)
from sparkflow_tpu_torch.trainer import Trainer
from sparkflow_tpu_torch.utils import flops


def _reg_graph(nn):
    x = nn.placeholder([None, 6], name="x")
    y = nn.placeholder([None, 1], name="y")
    h = nn.dense(x, 8, activation="relu")
    o = nn.dense(h, 1, name="out")
    nn.mean_squared_error(y, o)


MLP = build_graph(lambda: _reg_graph(tnn))
LM = build_registry_spec("transformer_lm", vocab_size=61, hidden=32,
                         num_layers=2, num_heads=4, mlp_dim=64, max_len=16,
                         dropout=0.1)


@pytest.fixture(scope="module")
def reg_data():
    rs = np.random.RandomState(0)
    x = rs.randn(97, 6).astype(np.float32)
    y = (x @ rs.randn(6))[:, None].astype(np.float32)
    return x, y


def _data(model, reg_data):
    if model == "mlp":
        return reg_data
    toks = np.random.default_rng(3).integers(0, 61, (24, 16))
    return toks.astype(np.float32), None


def _trainer(model, ckdir, cb=None, retries=0, **kw):
    if model == "mlp":
        args = ("x:0", "y:0")
        kw = dict(dict(iters=8, mini_batch_size=32), **kw)
    else:
        args = ("input_ids", None)
        kw = dict(dict(iters=8, mini_batch_size=8, learning_rate=0.01), **kw)
    return Trainer(MLP if model == "mlp" else LM, *args, optimizer="adam",
                   checkpoint_dir=ckdir, checkpoint_every=2, seed=3,
                   loss_callback=cb, resume_retries=retries, device="cpu",
                   **kw)


def _leaves(params):
    return [p.detach().numpy() for _path, p in sorted_leaves(params)]


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(np.array_equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.fixture(scope="module", params=["mlp", "lm"])
def case(request, reg_data, tmp_path_factory):
    """(model, data, the uninterrupted fit's result) — the loop path with
    checkpoints every 2 epochs, which the interrupted fits take too."""
    model = request.param
    data = _data(model, reg_data)
    base = _trainer(model, str(tmp_path_factory.mktemp("base")),
                    cb=lambda *a: None).fit(*data)
    return model, data, base


# -- within the port: bit-identical resume -----------------------------------

def test_crash_then_in_fit_resume_is_bit_identical(case, tmp_path):
    model, (x, y), base = case
    crash = faults.crash_at(5)   # epoch 5 raises once; the latest save is 4
    res = _trainer(model, str(tmp_path), cb=crash, retries=2).fit(x, y)
    assert crash.fired == 1 and res.completed
    assert _same(base.params, res.params)
    assert res.losses == base.losses


def test_crash_then_resilient_fit_is_bit_identical(case, tmp_path):
    model, (x, y), base = case
    crash = faults.crash_at(5)
    res = run_resilient_fit(_trainer(model, str(tmp_path), cb=crash), x, y,
                            max_restarts=2)
    assert crash.fired == 1 and res.completed
    assert _same(base.params, res.params)
    assert res.losses == base.losses[-len(res.losses):]


def test_sigterm_preempts_then_resumes_bit_identical(case, tmp_path):
    model, (x, y), base = case
    tr = _trainer(model, str(tmp_path), cb=faults.sigterm_at(3))
    first = tr.fit(x, y)
    assert first.stop_reason == "preempted" and not first.completed
    assert len(first.losses) == 3
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
    # the guard is gone after the fit: SIGTERM is back to its default
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL,
                                                signal.default_int_handler)
    second = tr.fit(x, y)  # the injector is spent: runs to the end
    assert second.completed and len(second.losses) == 5
    assert _same(base.params, second.params)
    assert first.losses + second.losses == base.losses


def test_resume_survives_a_corrupted_latest_checkpoint(case, tmp_path):
    model, (x, y), base = case
    tr = _trainer(model, str(tmp_path), cb=faults.sigterm_at(5))
    tr.fit(x, y)  # preempted at 5; checkpoints 2, 4, 5 on disk
    faults.corrupt_latest_checkpoint(str(tmp_path), mode="flip")
    # restore skips the torn step 5, resumes from 4 and re-runs 5..8
    res = tr.fit(x, y)
    assert res.completed and len(res.losses) == 4
    assert _same(base.params, res.params)


def test_retries_exhausted_raise_and_no_checkpoint_dir_never_retries(
        reg_data, tmp_path):
    x, y = reg_data

    def always_fail(loss, it, pid):
        if it == 4:
            raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError, match="persistent failure"):
        _trainer("mlp", str(tmp_path), cb=always_fail, retries=1).fit(x, y)
    with pytest.raises(RuntimeError, match="persistent failure"):
        _trainer("mlp", None, cb=always_fail, retries=5).fit(x, y)


def test_driver_refuses_without_checkpoint_dir(reg_data):
    x, y = reg_data
    tr = Trainer(MLP, "x:0", "y:0", iters=2, mini_batch_size=32,
                 device="cpu")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_resilient_fit(tr, x, y)


def test_driver_exhausts_restart_budget(reg_data, tmp_path):
    x, y = reg_data
    forever = faults.crash_at(3, times=99)  # re-fires on every resume
    pol = RetryPolicy(max_attempts=2, base_s=0.0, jitter=0.0, seed=0,
                      sleep=lambda d: None)
    with pytest.raises(RetryExhausted) as ei:
        run_resilient_fit(_trainer("mlp", str(tmp_path), cb=forever), x, y,
                          max_restarts=1, restart_policy=pol)
    assert isinstance(ei.value.last_error, faults.InjectedFault)


def test_debug_recompiles_is_refused_because_nothing_is_traced(reg_data):
    """Kept under its old name: ``debug_recompiles=True`` was refused while
    the port had no guard. It now runs the fit under ``track_recompiles``,
    counting the epoch's argument signatures where JAX counts its traces,
    and its report and findings equal the JAX ``Trainer``'s on the same
    data (a ``loss_callback`` puts both on the per-epoch loop; without one
    JAX fuses the epochs into ``run``, which the port has no counterpart
    of). A fixed-shape fit: one signature, no finding; a second fit on the
    same trainer builds its epoch anew and reports it again."""
    x, y = reg_data
    kw = dict(iters=3, mini_batch_size=32, debug_recompiles=True,
              loss_callback=lambda *a: None)
    jax_tr = JaxTrainer(jax_build_graph(lambda: _reg_graph(jnn)), "x:0",
                        "y:0", **kw)
    jax_tr.fit(x, y)
    tr = Trainer(MLP, "x:0", "y:0", device="cpu", **kw)
    tr.fit(x, y)
    assert tr.recompile_report == jax_tr.recompile_report
    assert tr.recompile_report == "epoch: 1 trace(s)\n  #1: first trace"
    assert tr.recompile_findings == jax_tr.recompile_findings == []
    tr.fit(x, y)
    assert tr.recompile_report == jax_tr.recompile_report


# -- across the packages -----------------------------------------------------

@pytest.fixture
def jax_npz(monkeypatch):
    """The JAX package's CheckpointManager on its npz path (orbax off)."""
    monkeypatch.setattr(jax_ckpt, "_HAVE_ORBAX", False)


def _jax_trainer(ckdir, **kw):
    kw = dict(dict(iters=4), **kw)
    return JaxTrainer(jax_build_graph(lambda: _reg_graph(jnn)), "x:0", "y:0",
                      optimizer="adam", mini_batch_size=32, seed=3,
                      checkpoint_dir=ckdir, checkpoint_every=2, **kw)


def _jax_like(jt):
    return jax.tree.map(np.asarray, jax_ckpt_state(
        jt.params, jt._last_opt_state, 0, jax.random.PRNGKey(0),
        rng_impl=None))


def _port_like(tt):
    return tt._ckpt_state(tt.params, tt._last_opt_state, 0,
                          tt._generators())


def _assert_state_equal(jstate, tstate):
    """params, opt_state and epoch bit-equal, dtypes included."""
    assert int(tstate["epoch"]) == int(jstate["epoch"])
    for key in ("params", "opt_state"):
        want = jax.tree.leaves(jstate[key])
        got = [np.asarray(v) for _p, v in sorted_leaves(tstate[key])]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_port_reads_a_jax_trainer_checkpoint_bit_equal(jax_npz, reg_data,
                                                       tmp_path):
    x, y = reg_data
    jt = _jax_trainer(str(tmp_path))
    jt.fit(x, y)
    tt = Trainer(MLP, "x:0", "y:0", optimizer="adam", iters=1,
                 mini_batch_size=32, device="cpu")
    tt.fit(x, y)
    for step in (2, 4):
        jstate = jax_ckpt.CheckpointManager(str(tmp_path)).restore(
            step=step, like=_jax_like(jt))
        tstate = CheckpointManager(str(tmp_path)).restore(
            step=step, like=_port_like(tt))
        _assert_state_equal(jstate, tstate)
    assert bytes(np.asarray(tstate["rng_impl"], np.uint8)) == b"threefry"


def test_jax_reads_a_port_trainer_checkpoint_bit_equal(jax_npz, reg_data,
                                                       tmp_path):
    x, y = reg_data
    tt = _trainer("mlp", str(tmp_path), iters=4)
    tt.fit(x, y)
    jt = _jax_trainer(None, iters=1)
    jt.fit(x, y)
    for step in (2, 4):
        tstate = CheckpointManager(str(tmp_path)).restore(
            step=step, like=_port_like(tt))
        jstate = jax_ckpt.CheckpointManager(str(tmp_path)).restore(
            step=step, like=_jax_like(jt))
        _assert_state_equal(jstate, tstate)
    assert bytes(np.asarray(jstate["rng_impl"], np.uint8)) == b"torch"


def test_each_trainer_refuses_the_others_random_stream(jax_npz, reg_data,
                                                       tmp_path):
    x, y = reg_data
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    _jax_trainer(jdir).fit(x, y)
    _trainer("mlp", tdir, iters=4).fit(x, y)
    calls = []
    cb = lambda *a: calls.append(a)  # noqa: E731
    with pytest.raises(ValueError, match="rng_impl='threefry'.*torch"):
        _trainer("mlp", jdir, cb=cb).fit(x, y)
    with pytest.raises(ValueError, match="rng_impl='torch'"):
        _jax_trainer(tdir, loss_callback=cb).fit(x, y)
    assert calls == []


def test_checkpointed_fit_still_matches_the_jax_trainer(jax_npz, reg_data,
                                                        tmp_path):
    """SGD, no shuffle, the same initial weights: the per-epoch losses within
    1e-5 relative, the final weights within 1e-5, with checkpoints on in
    both packages; the last checkpoints hold the same epoch."""
    x, y = reg_data
    rs = np.random.RandomState(7)
    init = {"dense/BiasAdd": {"kernel": rs.randn(6, 8).astype(np.float32),
                              "bias": rs.randn(8).astype(np.float32) * 0.1},
            "out/BiasAdd": {"kernel": rs.randn(8, 1).astype(np.float32),
                            "bias": np.zeros(1, np.float32)}}
    kw = dict(optimizer="gradient_descent", learning_rate=0.01, iters=6,
              mini_batch_size=32, shuffle_per_iter=False, checkpoint_every=2,
              loss_callback=lambda *a: None)
    jt = JaxTrainer(jax_build_graph(lambda: _reg_graph(jnn)), "x:0", "y:0",
                    checkpoint_dir=str(tmp_path / "j"), **kw)
    tt = Trainer(MLP, "x:0", "y:0", checkpoint_dir=str(tmp_path / "t"),
                 device="cpu", **kw)
    assert set(tt.model.param_specs()) == set(init)
    jr = jt.fit(x, y, init_params=init)
    tr = tt.fit(x, y, init_params=init)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-5)
    for got, want in zip(tt.weights_list(), jt.weights_list()):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (CheckpointManager(str(tmp_path / "t")).latest_step()
            == jax_ckpt.CheckpointManager(str(tmp_path / "j")).latest_step()
            == 6)


# -- step spans ---------------------------------------------------------------

def test_trace_spans_match_the_jax_fits_names(jax_npz, reg_data, tmp_path):
    x, y = reg_data
    jt = _jax_trainer(str(tmp_path / "j"), loss_callback=lambda *a: None)
    jt.fit(x, y, trace_spans=True)
    tt = _trainer("mlp", str(tmp_path / "t"), cb=lambda *a: None, iters=4)
    tt.fit(x, y, trace_spans=True)
    names = lambda tr: {s.name for s in tr.last_tracer.spans()}  # noqa: E731
    assert names(tt) == names(jt) - {"train/step_compile"}
    js, ts = jt.last_step_stats, tt.last_step_stats
    assert set(ts["phase_totals_s"]) == set(js["phase_totals_s"]) - {
        "step_compile"}
    assert ts["phase_counts"]["step"] == ts["steps"] == 4
    assert ts["compile_steps"] == 0
    assert sum(ts["phase_totals_s"].values()) <= ts["wall_s"]
    assert ts["examples"] == 4 * x.shape[0]
    # the exported traces parse, and the JSONL holds one span a line
    with open(tt.last_trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert {e["name"] for e in events if e.get("ph") == "X"} == names(tt)
    assert tt.last_trace_path.startswith(str(tmp_path / "t"))
    with open(tt.last_trace_path[:-5] + ".jsonl") as f:
        assert len(f.read().splitlines()) == len(tt.last_tracer.spans())


def test_trace_spans_count_the_transformer_step_analytically(tmp_path):
    toks = np.random.default_rng(3).integers(0, 61, (24, 16))
    tt = _trainer("lm", None, iters=2)
    tt.fit(toks.astype(np.float32), trace_spans=str(tmp_path / "t.json"))
    ss = tt.last_step_stats
    assert tt.last_trace_path == str(tmp_path / "t.json")
    # 3 batches of 8 rows an epoch
    want = 3 * flops.transformer_train_step_flops(
        8, 16, 32, 2, 64, vocab_size=61, causal=True)
    assert ss["flops_per_step"] == want
    assert ss["mfu"] is None  # no card: no peak to divide by


# -- utils/flops --------------------------------------------------------------

@pytest.mark.parametrize("args", [
    dict(batch=8, seq=1024, hidden=768, num_layers=12, mlp_dim=3072,
         vocab_size=50257, causal=True),
    dict(batch=32, seq=512, hidden=768, num_layers=12, mlp_dim=3072,
         num_classes=2),
    dict(batch=2, seq=16, hidden=32, num_layers=2, mlp_dim=64)])
def test_analytic_flops_and_mfu_equal_jax(args):
    assert (flops.transformer_train_step_flops(**args)
            == jax_flops.transformer_train_step_flops(**args))
    a = dict(batch=args["batch"], heads=12, seq_q=args["seq"],
             seq_k=args["seq"], head_dim=64)
    for causal in (False, True):
        for bwd in (False, True):
            assert (flops.attention_flops(**a, causal=causal,
                                          with_backward=bwd)
                    == jax_flops.attention_flops(**a, causal=causal,
                                                 with_backward=bwd))
    assert flops.mfu(3e14, peak=989e12) == jax_flops.mfu(3e14, peak=989e12)
    assert flops.mfu(None) is None and jax_flops.mfu(None) is None


def test_device_peak_is_none_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    assert flops.device_peak_flops() is None
    assert flops.device_peak_flops(return_assumed=True) == (None, False)
    assert flops.mfu(1e12) is None


def test_train_step_flops_counts_the_mlps_products():
    """FlopCounterMode over one step of the 6-8-1 MLP at 32 rows: the
    forward products 2·rows·Σ(in·out), the weight gradients as many, and
    the input gradient of every layer but the first, whose input needs
    none: 6·rows·Σ(in·out) − 2·rows·6·8 = 7,680 of the model-FLOPs
    convention's 6·rows·Σ(in·out) = 10,752. JAX's XLA count of the same step
    prices its elementwise work too and is larger (10,996 under jax
    0.9.0)."""
    rows = 32
    x = np.random.RandomState(1).randn(rows, 6).astype(np.float32)
    y = np.zeros((rows, 1), np.float32)
    tt = Trainer(MLP, "x:0", "y:0", optimizer="adam", device="cpu")
    got = flops.train_step_flops(tt.model, "x:0", "y:0", tt.optimizer, x, y)
    total = 6 * 8 + 8 * 1
    assert got == 6 * rows * total - 2 * rows * 6 * 8 == 7680
    jt = JaxTrainer(jax_build_graph(lambda: _reg_graph(jnn)), "x:0", "y:0",
                    optimizer="adam")
    xla = jax_flops.train_step_flops(jt.model, "x:0", "y:0", jt.optimizer,
                                     x, y)
    assert xla is None or xla > got
