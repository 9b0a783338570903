"""PyTorch port, the data-parallel remainder of the trainer:
``Trainer.fit_stream`` on a dp mesh at ZeRO stages 0-3, live callbacks and
in-fit resume on a launched mesh, ``offload_opt_state``, and a script that
launches ranks without a main-module guard, against the JAX package's.

The port's in-place ranks run in one module-scoped 2-rank gloo pool (a fit
inside a rank runs in place, as under torchrun); the JAX side on two of the
conftest's virtual CPU devices. The launched fits (the raising callback,
the killed rank and the stream with a live callback, which start their own
ranks as a user's fit does) are held bit for bit to the uninterrupted
in-place fit. Bars: losses and params
within 1e-5 of JAX's (float32, dropout off); bit-equal where the port runs
the same arithmetic (offload, resume). The stream shuffles: both packages
carry the same native batch ring, which shuffles each batch's rows from
the same seed (``tests/test_torch_stream.py`` holds the two rings' batches
equal).
"""

import multiprocessing
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import sparkflow_tpu.checkpoint as jax_ckpt
import torch_rank_tasks as tasks
from sparkflow_tpu.models import model_from_json as jax_model
from sparkflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparkflow_tpu.resilience import faults as jax_faults
from sparkflow_tpu.sharding import ShardingConfig as JaxConfig
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu_torch.checkpoint import CheckpointManager
from sparkflow_tpu_torch.models.presets import mlp
from sparkflow_tpu_torch.resilience import faults
from sparkflow_tpu_torch.sharding import ShardingConfig
from sparkflow_tpu_torch.trainer import Trainer

TOL = 1e-5
SPEC = mlp(10, 3, hidden=(17,))   # every size ragged mod 2
# 6 batches of 32 and a ragged one of 8: rank 1's block of the last batch
# is all padding, and it still joins every collective
ROWS = 200
_STREAM = dict(optimizer="adam", learning_rate=1e-2, mini_batch_size=32,
               seed=3)
_TRAIN = dict(optimizer="adam", learning_rate=1e-2, mini_batch_size=16,
              iters=4, seed=3, shuffle_per_iter=False)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool2():
    with tasks.rank_pool(2, timeout_s=180) as pool:
        yield pool


@pytest.fixture(scope="module")
def p0():
    p = jax_model(SPEC).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


@pytest.fixture
def jax_npz(monkeypatch):
    monkeypatch.setattr(jax_ckpt, "_HAVE_ORBAX", False)


def _data(n=ROWS, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 10).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]
    return x, y


def _jax_mesh():
    return jax_make_mesh({"dp": 2}, devices=jax.devices()[:2])


def _close(ours, theirs, msg=""):
    for layer in theirs:
        for k in theirs[layer]:
            np.testing.assert_allclose(
                np.asarray(ours[layer][k]), np.asarray(theirs[layer][k]),
                atol=TOL, rtol=TOL, err_msg=f"{msg} {layer}/{k}")


def _same(a, b):
    return all(np.array_equal(np.asarray(a[ln][k]), np.asarray(b[ln][k]))
               for ln in b for k in b[ln])


# -- fit_stream on a dp mesh ----------------------------------------------------

@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_fit_stream_on_dp_mesh_matches_jax(pool2, p0, stage):
    """Two epochs of a shuffled stream at dp=2: every step's loss and the
    final params within 1e-5 of JAX's ``fit_stream`` on a 2-device dp
    mesh at the same zero stage (JAX's ``test_fit_stream_on_dp_mesh`` with
    ``zeroStage`` in place of its fsdp axis)."""
    x, y = _data()
    ours = pool2.run(tasks.stream_fit, SPEC, {"dp": 2},
                     dict(_STREAM, sharding=stage, shuffle_per_iter=True),
                     x, y, p0, 2)
    jt = JaxTrainer(SPEC, "x:0", "y:0", mesh=_jax_mesh(),
                    sharding=JaxConfig(zero_stage=stage),
                    shuffle_per_iter=True, **_STREAM)
    jr = jt.fit_stream(lambda: zip(list(x), list(y)),
                       init_params=jax.tree.map(jnp.asarray, p0), chunk=64,
                       epochs=2)
    assert jt._zero_stage == stage and len(jr.losses) == 2 * 7
    for o in ours:
        assert o["zero_stage"] == stage and o["stop"] == "completed"
        np.testing.assert_allclose(o["losses"], jr.losses, atol=TOL,
                                   rtol=TOL)
        _close(o["params"], jax.tree.map(np.asarray, jr.params),
               f"stage {stage}")
    assert ours[0]["losses"] == ours[1]["losses"]
    me = ours[0]["stats"]["ranks"][0]
    assert me["steps"] == 14 and len(me["epoch_ms"]) == 14
    assert ours[0]["losses"][-1] < ours[0]["losses"][0]


def test_stream_checkpoint_resumes_on_a_mesh(pool2, p0, tmp_path):
    """A stream saved every 2 steps at ZeRO 2; a second stream on the same
    directory resumes from step 6 and, fed the rows after step 6's, lands
    on the uninterrupted fit bit for bit (rows in order)."""
    x, y = _data()
    ck = str(tmp_path / "ck")
    kw = dict(_STREAM, sharding=2, shuffle_per_iter=False,
              checkpoint_dir=ck, checkpoint_every=2)
    full = pool2.run(tasks.stream_fit, SPEC, {"dp": 2}, kw, x, y, p0)
    assert CheckpointManager(ck).all_steps() == [2, 4, 6]
    rest = pool2.run(tasks.stream_fit, SPEC, {"dp": 2}, kw, x[192:],
                     y[192:], p0)
    for r, f in zip(rest, full):
        assert len(f["losses"]) == 7
        assert r["losses"] == f["losses"][6:]
        assert _same(r["params"], f["params"])


# -- offload_opt_state ------------------------------------------------------------

@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_offload_opt_state_is_bit_equal(pool2, p0, stage):
    """The working state stays on the device and the host mirror is only
    read: losses, params and the final optimizer state equal the same fit
    without offload bit for bit, in ``fit`` and in ``fit_stream`` (JAX's
    ``test_offload_opt_state_equivalence``); the state ends host-side."""
    x, y = _data(64)
    fit = pool2.run(tasks.offload_pair, SPEC, {"dp": 2},
                    dict(_TRAIN, iters=2, sharding=stage), x, y, p0, False)
    stream = pool2.run(tasks.offload_pair, SPEC, {"dp": 2},
                       dict(_STREAM, sharding=stage), x, y, p0, True)
    for out in fit + stream:
        off, on = out[False], out[True]
        assert on["offload"] and not off["offload"]
        assert on["losses"] == off["losses"] and len(on["losses"]) > 1
        assert _same(on["params"], off["params"])
        assert len(on["opt_state"]) == len(off["opt_state"]) > 0
        for a, b in zip(on["opt_state"], off["opt_state"]):
            assert np.array_equal(a, b)
    assert all(o[True]["opt_on_host"] for o in stream)


def test_offload_opt_state_is_inert_without_a_mesh(p0):
    x, y = _data(64)
    kw = dict(_TRAIN, iters=2)
    base = Trainer(SPEC, "x:0", "y:0", device="cpu", **kw)
    off = Trainer(SPEC, "x:0", "y:0", device="cpu",
                  sharding=ShardingConfig(offload_opt_state=True), **kw)
    rb, ro = base.fit(x, y, init_params=p0), off.fit(x, y, init_params=p0)
    assert not off._offload_active and ro.losses == rb.losses
    jt = JaxTrainer(SPEC, "x:0", "y:0",
                    sharding=JaxConfig(offload_opt_state=True), **kw)
    jr = jt.fit(x, y, init_params=jax.tree.map(jnp.asarray, p0))
    assert not jt._offload_active
    np.testing.assert_allclose(ro.losses, jr.losses, atol=TOL, rtol=TOL)


# -- live callbacks and in-fit resume on a launched mesh ----------------------------

def _launched(tmp_path, cb, stage):
    return Trainer(SPEC, "x:0", "y:0", mesh={"dp": 2}, device="cpu",
                   sharding=ShardingConfig(zero_stage=stage),
                   checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1,
                   resume_retries=1, loss_callback=cb, **_TRAIN)


def test_a_raising_callback_restores_every_rank_live(pool2, p0, tmp_path,
                                                     jax_npz):
    """The callback runs here while the ranks train: a raise at epoch 2
    (``faults.crash_at``) restores the epoch-1 checkpoint on every rank and
    the fit finishes, as JAX's ``test_auto_resume_from_checkpoint_on_
    failure`` does on a 2-device mesh, on the uninterrupted fit's params
    bit for bit and within 1e-5 of JAX's resumed fit. (Before, the port
    replayed the callbacks after training, and the raise escaped ``fit``.)"""
    x, y = _data(64)
    want = pool2.run(tasks.trainer_fit, SPEC, {"dp": 2},
                     dict(_TRAIN, sharding=1), x, y, p0)[0]
    crash, seen = faults.crash_at(2), []

    def cb(loss, it, part):
        seen.append(it)
        crash(loss, it, part)

    t = _launched(tmp_path, cb, 1)
    r = t.fit(x, y, init_params=p0)
    assert crash.fired == 1 and r.completed
    assert seen == [1, 2, 2, 3, 4]
    assert r.losses == want["losses"]
    assert _same({ln: {k: v.numpy() for k, v in layer.items()}
                  for ln, layer in r.params.items()}, want["params"])
    assert t.last_mesh_stats["launched"]
    jt = JaxTrainer(SPEC, "x:0", "y:0", mesh=_jax_mesh(),
                    sharding=JaxConfig(zero_stage=1),
                    checkpoint_dir=str(tmp_path / "jax"), checkpoint_every=1,
                    resume_retries=1, loss_callback=jax_faults.crash_at(2),
                    **_TRAIN)
    jr = jt.fit(x, y, init_params=jax.tree.map(jnp.asarray, p0))
    np.testing.assert_allclose(r.losses, jr.losses, atol=TOL, rtol=TOL)
    _close({ln: {k: v.numpy() for k, v in layer.items()}
            for ln, layer in r.params.items()},
           jax.tree.map(np.asarray, jr.params), "resumed")


def test_a_killed_rank_is_relaunched_from_its_checkpoint(pool2, p0,
                                                         tmp_path):
    """A rank killed once (SIGKILL, from a live callback at epoch 3) stops
    its pool; the fit starts new ranks that resume from the checkpoint
    directory and lands on the uninterrupted fit bit for bit, every epoch's
    loss once."""
    x, y = _data(64)
    want = pool2.run(tasks.trainer_fit, SPEC, {"dp": 2},
                     dict(_TRAIN, sharding=2), x, y, p0)[0]
    module_ranks = set(pool2._procs)
    killed = []

    def cb(loss, it, part):
        if it == 3 and not killed:
            victim = [p for p in multiprocessing.active_children()
                      if p not in module_ranks][0]
            killed.append(victim.pid)
            os.kill(victim.pid, signal.SIGKILL)

    r = _launched(tmp_path, cb, 2).fit(x, y, init_params=p0)
    assert killed and r.completed
    assert r.losses == want["losses"]
    assert _same({ln: {k: v.numpy() for k, v in layer.items()}
                  for ln, layer in r.params.items()}, want["params"])


def test_a_launched_stream_runs_its_callback_live(pool2, p0, tmp_path):
    """The estimator's stream path: the stream is read here and each rank
    sent its rows; rank 0's per-step losses reach the callback while the
    ranks train. A SIGTERM from the callback at step 3 stops every rank
    there with a save (one process's ``fit_stream`` contract), on the
    in-place stream fit's first three steps bit for bit."""
    x, y = _data()
    kw = dict(_STREAM, sharding=1, shuffle_per_iter=True)
    want = pool2.run(tasks.stream_fit, SPEC, {"dp": 2}, kw, x, y, p0)[0]
    seen = []

    def cb(loss, step, part):
        seen.append((step, loss))
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    ck = str(tmp_path / "ck")
    t = Trainer(SPEC, "x:0", "y:0", mesh={"dp": 2}, device="cpu",
                sharding=ShardingConfig(zero_stage=1), checkpoint_dir=ck,
                checkpoint_every=100, loss_callback=cb,
                **{k: v for k, v in kw.items() if k != "sharding"})
    r = t.fit_stream(lambda: zip(list(x), list(y)), init_params=p0,
                     chunk=64)
    assert r.stop_reason == "preempted" and t.last_mesh_stats["launched"]
    assert [s for s, _ in seen] == [1, 2, 3]
    assert r.losses == [v for _, v in seen] == want["losses"][:3]
    assert CheckpointManager(ck).all_steps() == [3]
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL,
                                                signal.default_int_handler)


def test_a_stop_goes_ahead_of_the_queued_batches():
    """A launched rank's line to its caller: a "stop" sent after batches
    that are still queued is taken before them (the rank stops at its next
    step, as one process's stream does), the batches then come in order,
    and a message of another kind waits for a ``recv`` of its kind."""
    import queue
    from sparkflow_tpu_torch.parallel.distributed import _MSG, _Channel
    inbox, outbox = queue.Queue(), queue.Queue()
    chan = _Channel(0, inbox, outbox)
    for msg in [("batch", 1), ("verdict", "go"), ("batch", 2), ("stop",)]:
        inbox.put((_MSG, msg))
    assert chan.take("stop") == ("stop",) and chan.take("stop") is None
    assert chan.recv("verdict") == ("verdict", "go")
    assert [chan.recv(), chan.recv()] == [("batch", 1), ("batch", 2)]
    inbox.put(None)
    with pytest.raises(RuntimeError, match="closing"):
        chan.recv()
    assert inbox.get_nowait() is None       # left for the rank's task loop


def test_a_script_without_a_main_guard_gets_the_guard_message(tmp_path):
    """Spawned ranks re-import the main module; in a script without the
    guard every rank dies while starting, and the fit raises naming the
    guard within the limit instead of hanging."""
    script = tmp_path / "unguarded.py"
    script.write_text(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import numpy as np
        from sparkflow_tpu_torch.localml import LocalSession, Vectors
        from sparkflow_tpu_torch.models.presets import mlp
        from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL
        rs = np.random.RandomState(0)
        spark = LocalSession.builder.appName("guard").getOrCreate()
        df = spark.createDataFrame(
            [(Vectors.dense(rs.randn(10)), Vectors.dense(np.eye(3)[i % 3]))
             for i in range(32)], ["features", "label"])
        SparkAsyncDL(inputCol="features", tensorflowGraph=mlp(10, 3),
                     tfInput="x:0", tfLabel="y:0", tfOutput="out:0",
                     labelCol="label", iters=1, miniBatchSize=16,
                     meshShape="dp=2", device="cpu").fit(df)
        """))
    env = dict(os.environ, SPARKFLOW_TORCH_MESH_TIMEOUT_S="60")
    proc = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=60,
                          env=env)
    assert proc.returncode != 0
    assert "exited" in proc.stderr and "while starting" in proc.stderr
    assert 'under `if __name__ == "__main__":`' in proc.stderr
