"""PyTorch port, the host data plane and streaming training: ``BatchQueue``
and ``load_csv_matrix`` (``utils/data.py`` over ``native/dataplane.cpp``,
numpy fallbacks beside them) against the JAX package's, and
``Trainer.fit_stream``: it learns, matches the JAX package's streaming fit,
checkpoints every ``checkpoint_every`` steps and resumes the step count
and state, stops on SIGTERM with a save, and streams multi-input rows.

Both packages carry the same C++ source and the same numpy fallback, so a
queue with the same seed yields the same batches in either (exact). The
streaming fits are held to each other within 1e-5 (float32, plain SGD on
an ``nn`` MLP; the same batches reach both)."""

import os
import signal
import threading

import numpy as np
import pytest

import sparkflow_tpu.nn as jnn
import sparkflow_tpu.utils.data as jax_data
from sparkflow_tpu.graph_utils import build_graph as jax_build_graph
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu_torch import nn as tnn
from sparkflow_tpu_torch.checkpoint import CheckpointManager
from sparkflow_tpu_torch.graph_utils import build_graph
from sparkflow_tpu_torch.localml import Vectors
from sparkflow_tpu_torch.models import build_registry_spec
from sparkflow_tpu_torch.trainer import Trainer
from sparkflow_tpu_torch.utils import data
from sparkflow_tpu_torch.utils.data import BatchQueue, load_csv_matrix


@pytest.fixture(params=["native", "fallback"])
def path(request, monkeypatch):
    """Run a case on the native ring and on the numpy fallback, in both
    packages."""
    if request.param == "fallback":
        monkeypatch.setattr(data, "load_library", lambda: None)
        monkeypatch.setattr(jax_data, "load_library", lambda: None)
    return request.param


def _drain(q, rows, labels, step):
    def produce():
        for i in range(0, len(rows), step):
            q.push(rows[i:i + step],
                   None if labels is None else labels[i:i + step])
        q.finish()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    out = list(q)
    t.join(timeout=30)
    assert not t.is_alive()
    q.close()
    return out


def test_batch_queue_rows_masks_and_shuffles_equal_jax(path):
    rs = np.random.RandomState(1)
    m = rs.rand(250, 5).astype(np.float32)
    y = rs.rand(250, 2).astype(np.float32)
    kw = dict(batch_size=64, row_dim=5, label_dim=2, capacity=3,
              shuffle=True, seed=7)
    q = BatchQueue(**kw)
    assert (q._lib is not None) == (path == "native")
    got = _drain(q, m, y, 90)
    want = _drain(jax_data.BatchQueue(**kw), m, y, 90)
    assert [n for *_b, n in got] == [64, 64, 64, 58]
    total = 0
    for (x, yy, mask, n), (wx, wy, wm, wn) in zip(got, want):
        assert x.shape == (64, 5) and yy.shape == (64, 2)
        assert mask.sum() == n == wn and np.all(x[n:] == 0)
        for a, b in ((x, wx), (yy, wy), (mask, wm)):
            np.testing.assert_array_equal(a, b)
        total += n
    assert total == 250
    rows = np.concatenate([x[:n] for x, _y, _m, n in got])
    # every row once, in a shuffled order, with its own label
    order = np.argsort(rows[:, 0])
    np.testing.assert_array_equal(rows[order], m[np.argsort(m[:, 0])])
    assert not np.array_equal(rows, m)
    labels = np.concatenate([yy[:n] for _x, yy, _m, n in got])
    np.testing.assert_array_equal(labels[order], y[np.argsort(m[:, 0])])


def test_batch_queue_unsupervised_and_unshuffled(path):
    q = BatchQueue(batch_size=16, row_dim=3, label_dim=0, capacity=2,
                   shuffle=False)
    rows = np.arange(30, dtype=np.float32).reshape(10, 3)
    q.push(rows)
    q.finish()
    x, y, mask, n = q.pop()
    assert n == 10 and y.shape == (16, 0)
    np.testing.assert_array_equal(x[:10], rows)
    assert q.pop() is None
    q.close()


def test_csv_loader_equals_jax(path, tmp_path):
    m = np.random.RandomState(0).rand(50, 7).astype(np.float32)
    p = str(tmp_path / "m.csv")
    np.savetxt(p, m, delimiter=",", fmt="%.6f")
    a = load_csv_matrix(p)
    assert a.shape == (50, 7) and a.dtype == np.float32
    np.testing.assert_allclose(a, m, atol=1e-5)
    np.testing.assert_array_equal(a, jax_data.load_csv_matrix(p))


# -- fit_stream ----------------------------------------------------------------

def _clf(nn):
    x = nn.placeholder([None, 12], name="x")
    y = nn.placeholder([None, 1], name="y")
    nn.sigmoid_cross_entropy(y, nn.dense(x, 1, name="out"))


@pytest.fixture(scope="module")
def clf_data():
    rs = np.random.RandomState(0)
    m = rs.randn(600, 12).astype(np.float32)
    return m, (m @ rs.randn(12) > 0).astype(np.float32)


def test_fit_stream_learns(clf_data):
    m, lbl = clf_data
    tr = Trainer(build_graph(lambda: _clf(tnn)), "x:0", "y:0",
                 mini_batch_size=64, learning_rate=0.2, device="cpu")
    res = tr.fit_stream(zip(list(m), list(lbl)))
    assert res.completed and len(res.losses) == -(-600 // 64)
    assert res.losses[-1] < res.losses[0]


def test_fit_stream_matches_jax(clf_data):
    """Two epochs over a factory, SGD, the same initial weights: each
    step's loss within 1e-5 relative, the final weights within 1e-5."""
    m, lbl = clf_data
    rs = np.random.RandomState(4)
    init = {"out/BiasAdd": {"kernel": rs.randn(12, 1).astype(np.float32),
                            "bias": np.zeros(1, np.float32)}}
    rows = lambda: zip(list(m), list(lbl))  # noqa: E731
    kw = dict(optimizer="gradient_descent", learning_rate=0.2,
              mini_batch_size=64, seed=2)
    jt = JaxTrainer(jax_build_graph(lambda: _clf(jnn)), "x:0", "y:0", **kw)
    jr = jt.fit_stream(rows, init_params=init, chunk=100, epochs=2)
    tt = Trainer(build_graph(lambda: _clf(tnn)), "x:0", "y:0", device="cpu",
                 **kw)
    tr = tt.fit_stream(rows, init_params=init, chunk=100, epochs=2)
    assert len(tr.losses) == len(jr.losses) == 2 * 10
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-5)
    for got, want in zip(tt.weights_list(), jt.weights_list()):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_fit_stream_needs_a_factory_for_several_epochs(clf_data):
    m, lbl = clf_data
    tr = Trainer(build_graph(lambda: _clf(tnn)), "x:0", "y:0", device="cpu")
    with pytest.raises(ValueError, match="callable iterator factory"):
        tr.fit_stream(zip(list(m), list(lbl)), epochs=2)
    with pytest.raises(ValueError, match="no training data"):
        tr.fit_stream(iter([]))


def test_fit_stream_checkpoints_resume_step_count_and_state(clf_data,
                                                            tmp_path):
    """Saves every 3 steps; a second stream on the same directory starts
    from the saved state and step (no replay of consumed rows)."""
    m, lbl = clf_data
    ck = str(tmp_path / "ck")
    graph = build_graph(lambda: _clf(tnn))
    tr = Trainer(graph, "x:0", "y:0", mini_batch_size=64, learning_rate=0.2,
                 checkpoint_dir=ck, checkpoint_every=3, device="cpu")
    tr.fit_stream(zip(list(m), list(lbl)))                 # 10 steps
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [3, 6, 9]
    saved = mgr.restore(like=tr._ckpt_state(tr.params, tr._last_opt_state,
                                            0, tr._generators()))
    tr2 = Trainer(graph, "x:0", "y:0", mini_batch_size=64, learning_rate=0.2,
                  checkpoint_dir=ck, checkpoint_every=3, device="cpu")
    captured = {}

    def first_step(loss, step, pid):
        captured.setdefault("step", step)

    tr2.loss_callback = first_step
    res = tr2.fit_stream(zip(list(m[:192]), list(lbl[:192])))  # 3 steps
    assert captured["step"] == 10 and len(res.losses) == 3
    assert mgr.all_steps() == [6, 9, 12]
    # the resumed run started from step 9's weights (a fresh run from them
    # takes the same first loss on the same first batch) and adam's state
    # (its step count went on from 9)
    tr3 = Trainer(graph, "x:0", "y:0", mini_batch_size=64, learning_rate=0.2,
                  device="cpu")
    fresh = tr3.fit_stream(zip(list(m[:192]), list(lbl[:192])),
                           init_params=saved["params"])
    assert fresh.losses[0] == res.losses[0]
    assert saved["opt_state"][0].count == 9
    assert tr2._last_opt_state[0].count == 12


def test_sigterm_stops_the_stream_with_a_save(tmp_path):
    rs = np.random.RandomState(1)
    calls = []

    def rows():
        for _ in range(4000):
            v = rs.rand(12).astype(np.float32)
            yield v, float(v.sum() > 6)

    def cb(loss, step, pid):
        calls.append(step)
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    ck = str(tmp_path / "ck")
    tr = Trainer(build_graph(lambda: _clf(tnn)), "x:0", "y:0",
                 mini_batch_size=64, checkpoint_dir=ck,
                 checkpoint_every=1000, loss_callback=cb, device="cpu")
    res = tr.fit_stream(rows, chunk=64)
    assert res.stop_reason == "preempted" and calls == [1, 2]
    assert CheckpointManager(ck).latest_step() == 2
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL,
                                                signal.default_int_handler)


def test_multi_input_stream_trains_a_transformer():
    """ids + padding mask per row, as a tuple: they ride the ring as one
    flat row and split back into the model's two inputs."""
    seq, vocab = 8, 30
    spec = build_registry_spec("transformer_classifier", vocab_size=vocab,
                               num_classes=2, hidden=16, num_layers=1,
                               num_heads=2, mlp_dim=32, max_len=seq,
                               dropout=0.0)
    rs = np.random.RandomState(0)
    rows = []
    for _ in range(96):
        label = rs.randint(0, 2)
        ids = rs.randint(3, vocab, seq)
        if label:
            ids[0] = 1  # marker token
        n_real = rs.randint(seq // 2, seq + 1)
        mask = np.zeros(seq)
        mask[:n_real] = 1.0
        ids[n_real:] = 0
        rows.append(((Vectors.dense(ids.astype(float)), Vectors.dense(mask)),
                     Vectors.dense(np.eye(2)[label])))
    tr = Trainer(spec, ["input_ids", "attention_mask"], "y",
                 mini_batch_size=16, learning_rate=0.01, device="cpu")
    res = tr.fit_stream(lambda: iter(rows), epochs=8)
    assert len(res.losses) == 8 * 6 and np.isfinite(res.losses).all()
    assert np.mean(res.losses[-6:]) < np.mean(res.losses[:6])
    with pytest.raises(ValueError, match="takes 2 input tensors"):
        tr.fit_stream(iter([(r[0][0], r[1]) for r in rows]))
