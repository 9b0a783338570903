"""PyTorch port, the tooling (graftcheck): the static passes over the port,
the CLI, the runtime recompile guard against the JAX package's, the fx
trace lint and ``utils.tracing``.

- The lint gate: the full static pass over ``sparkflow_tpu_torch/``,
  ``chip_smoke.py`` and ``tests/torch_rank_tasks.py`` reports nothing, as
  ``tests/test_lint_gate.py`` holds the JAX package; the port's CLI keeps
  the JAX CLI's exit codes, JSONL output and baseline.
- The guard: one call sequence through the JAX package's
  ``RecompileGuard`` (a ``jax.jit`` inside) and through the port's gives
  equal trace counts and the same causes word for word; the predict
  engines of both packages, warmed up on one graph, report ``traces ==
  aot_compiles == len(buckets)`` and no steady-state trace; a
  ``debug_recompiles`` fit reports what JAX's does.
- ``fx_lint``: GC-J103, GC-J106 (on a 2-rank gloo world) and GC-J108
  planted in both directions, the repo self-check and a quantized decode
  engine clean.
"""

import json
import os
import textwrap

import numpy as np
import pytest
import torch

from test_torch_shared import numpy_params, torch_model
from sparkflow_tpu_torch.analysis import (RecompileGuard, cli, fx_lint,
                                          policy_lint, track_recompiles)
from sparkflow_tpu_torch.analysis.findings import RULES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GATE = [os.path.join(REPO, "sparkflow_tpu_torch"),
        os.path.join(REPO, "chip_smoke.py"),
        os.path.join(REPO, "tests", "torch_rank_tasks.py")]

_DEFECT = '''
class ConnectionPool:
    def acquire(self): ...
    def release(self, conn, reuse=True): ...

class Client:
    def __init__(self):
        self.pool = ConnectionPool()

    def bad(self, flag):
        conn, reused = self.pool.acquire()
        if flag:
            return None
        self.pool.release(conn)
        return flag
'''

_SECOND_DEFECT = '''
import threading

def orphan():
    t = threading.Thread(target=print)
    t.start()
'''


# -- the static passes and the CLI -------------------------------------------


def test_port_full_static_pass_clean():
    findings = cli.run_static(GATE)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_cli_exit_codes_and_json(tmp_path, capsys):
    (tmp_path / "leaky.py").write_text(_DEFECT)
    assert cli.main([str(tmp_path), "--no-trace", "--format", "json"]) == 1
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
           if ln.strip()]
    assert [f["rule"] for f in out] == ["GC-X601"]
    assert {"rule", "name", "path", "line", "source", "message"} <= set(
        out[0])
    assert cli.main([str(tmp_path), "--no-trace", "--ignore",
                     "GC-X601"]) == 0
    assert "graftcheck: clean" in capsys.readouterr().out
    (tmp_path / "leaky.py").write_text(_DEFECT.replace(
        "        if flag:\n            return None\n", ""))
    assert cli.main([str(tmp_path), "--no-trace", "--format", "json"]) == 0
    assert capsys.readouterr().out.strip() == ""
    assert cli.main(["--list-rules"]) == 0
    listing = capsys.readouterr().out
    assert all(rule in listing for rule in RULES)


def test_cli_baseline_roundtrip(tmp_path, capsys):
    (tmp_path / "leaky.py").write_text(_DEFECT)
    baseline = str(tmp_path / "b.jsonl")
    assert cli.main([str(tmp_path), "--no-trace",
                     "--write-baseline", baseline]) == 0
    # line-insensitive: shifting the file keeps the accepted finding
    (tmp_path / "leaky.py").write_text("import os\n" + _DEFECT)
    assert cli.main([str(tmp_path), "--no-trace",
                     "--baseline", baseline]) == 0
    capsys.readouterr()
    (tmp_path / "orphan.py").write_text(_SECOND_DEFECT)
    assert cli.main([str(tmp_path), "--no-trace", "--baseline", baseline,
                     "--format", "json"]) == 1
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
           if ln.strip()]
    assert [f["rule"] for f in out] == ["GC-X603"]


def test_cli_trace_runs_the_fx_self_check(monkeypatch, capsys):
    called = []
    monkeypatch.setattr(fx_lint, "repo_self_check",
                        lambda ignore=(): called.append(1) or [])
    assert cli.main([GATE[2]]) == 0
    assert called == [1]
    assert "graftcheck: clean" in capsys.readouterr().out


def test_lifecycle_registry_names_the_port_api():
    """The carried pair registry names classes and methods; the port kept
    every one, so the registry applies to it unchanged."""
    from sparkflow_tpu_torch.analysis.lifecycle import PAIRS
    from sparkflow_tpu_torch.serving import (batcher, client, decode,
                                             kvcache)
    from sparkflow_tpu_torch.utils import metrics
    classes = {"PagedKVCache": kvcache.PagedKVCache,
               "DecodeEngine": decode.DecodeEngine,
               "ContinuousBatcher": batcher.ContinuousBatcher,
               "ConnectionPool": client.ConnectionPool,
               "Metrics": metrics.Metrics}
    named = [p for p in PAIRS if p.owner is not None]
    assert {p.owner for p in named} == set(classes)
    for p in named:
        for method in p.acquire + p.release:
            assert hasattr(classes[p.owner], method), (p.name, method)


def test_s501_on_the_port_policy_module():
    from sparkflow_tpu_torch.serving import policies
    with open(policies.__file__, encoding="utf-8") as fh:
        first = fh.readline()
    assert policy_lint.PURE_POLICY_MARKER in first
    assert policy_lint.lint_file(policies.__file__) == []
    # the marker is enforced: a clock read in a marked module fires
    src = textwrap.dedent("""\
        # graftcheck: pure-policy
        import time

        def pick(views):
            return time.monotonic()
    """)
    assert {f.rule for f in policy_lint.lint_source(src, "p.py")} == {
        "GC-S501"}


# -- the runtime guard, held against JAX's ---------------------------------


def test_recompile_guard_matches_jax():
    import jax.numpy as jnp
    from sparkflow_tpu.analysis import RecompileGuard as JaxGuard
    seq = [((4,), "float32"), ((4,), "float32"), ((8,), "float32"),
           ((8,), "int32"), ((4,), "float32")]
    jg = JaxGuard(lambda p, x: p["w"].sum() * x, name="mul")
    tg = RecompileGuard(lambda p, x: p["w"].sum() * x, name="mul")
    for shape, dt in seq:
        jg({"w": jnp.ones((1,), jnp.float32)}, jnp.ones(shape, dt))
        tg({"w": torch.ones(1)}, torch.ones(shape, dtype=getattr(torch, dt)))
    assert jg.traces == tg.traces == 3 and tg.retraces == 2
    assert tg.causes == jg.causes
    assert tg.causes[1] == "arg[0][1]: float32[4] -> float32[8]"
    # a nested leaf is named by its path in both
    jg({"w": jnp.ones((2,), jnp.float32)}, jnp.ones((4,), jnp.float32))
    tg({"w": torch.ones(2)}, torch.ones(4))
    assert tg.causes[-1] == jg.causes[-1]
    assert "arg[0][0]['w']: float32[1] -> float32[2]" in tg.causes[-1]
    for g in (jg, tg):
        g.mark_steady()
    jg({"w": jnp.ones((1,), jnp.float32)}, jnp.ones((16,), jnp.float32))
    tg({"w": torch.ones(1)}, torch.ones(16))
    assert jg.steady_traces == tg.steady_traces == 1
    assert ([f.rule for f in tg.findings()]
            == [f.rule for f in jg.findings()] == ["GC-R401"])
    assert tg.findings()[0].message == jg.findings()[0].message


def test_guard_signature_leaves():
    """A Python number counts by its type (JAX: a weak scalar), a
    generator by its device; a device move is named as one."""
    from sparkflow_tpu_torch.analysis.runtime_guards import _signature
    g = RecompileGuard(lambda x, n, gen: x, name="f")
    gen = torch.Generator()
    g(torch.ones(2), 1, gen)
    g(torch.ones(2), 7, torch.Generator())
    assert g.traces == 1
    g(torch.ones(2), 1.5, gen)
    assert g.traces == 2 and "python int -> python float" in g.causes[-1]
    sig = dict(_signature((torch.ones(2, device="meta"),), {}))
    assert sig["[0][0]"] == ("array", (2,), "float32", "meta")
    g(torch.ones(2, device="meta"), 1.5, gen)
    assert "float32[2] on cpu -> float32[2] on meta" in g.causes[-1]


def test_track_recompiles_sees_the_port_train_step():
    from sparkflow_tpu_torch import core
    from sparkflow_tpu_torch.models import model_from_json, presets
    from sparkflow_tpu_torch.optimizers import build_optimizer
    model = model_from_json(presets.mlp(4, 2, hidden=(3,)), device="cpu")
    opt = build_optimizer("adam", 0.1)
    params = {k: {n: t.requires_grad_(True) for n, t in d.items()}
              for k, d in model.init(torch.Generator().manual_seed(0))
              .items()}
    state = opt.init(params)
    step = core.make_train_step(core.make_loss_fn(model, "x:0", "y:0"), opt)

    def batch(n):
        return torch.zeros(n, 4), torch.zeros(n, 2), torch.ones(n)

    step(params, state, *batch(8))              # no tracker: not seen
    with track_recompiles() as tracker:
        state = step(params, state, *batch(8))[1]
        state = step(params, state, *batch(8))[1]   # adam's count moves
        assert tracker.traces == {"train_step": 1}
        step(params, state, *batch(4))              # a ragged batch
    assert tracker.traces == {"train_step": 2}
    assert [f.rule for f in tracker.findings()] == ["GC-R401"]
    assert "arg[0][2]: float32[8, 4] -> float32[4, 4]" in tracker.report()


def _serving_graph(nn, build_graph):
    def g():
        x = nn.placeholder([None, 4], name="x")
        h = nn.dense(x, 3, activation="relu")
        out = nn.dense(h, 2, name="out")
        nn.mean_squared_error(x, out)
    return build_graph(g)


def _tgraph():
    import sparkflow_tpu_torch.nn as tnn
    from sparkflow_tpu_torch.graph_utils import build_graph
    return _serving_graph(tnn, build_graph)


def test_predict_engines_hold_the_ladder_like_jax():
    import sparkflow_tpu.nn as jnn
    from sparkflow_tpu.graph_utils import build_graph as jax_build_graph
    from sparkflow_tpu.serving import InferenceEngine as JaxEngine
    from sparkflow_tpu_torch.serving import InferenceEngine
    rs = np.random.RandomState(0)
    weights = [rs.randn(4, 3).astype(np.float32),
               rs.randn(3).astype(np.float32),
               rs.randn(3, 2).astype(np.float32),
               rs.randn(2).astype(np.float32)]
    kw = dict(input_name="x:0", output_name="out/BiasAdd:0", max_batch=8)
    engines = [JaxEngine(_serving_graph(jnn, jax_build_graph), weights,
                         **kw),
               InferenceEngine(_tgraph(), weights, device="cpu", **kw)]
    for eng in engines:
        st = eng.stats()
        assert st["traces"] == st["aot_compiles"] == len(eng.buckets) == 4
        assert st["steady_traces"] == 0
        for n in list(range(1, 9)) + [11]:
            assert eng.predict(rs.randn(n, 4)).shape == (n, 2)
        st = eng.stats()
        assert st["traces"] == 4 and st["steady_traces"] == 0
        assert st["fallback_compiles"] == 0
        assert eng.recompile_guard.findings() == []
    assert engines[1].recompile_guard.causes[1] == (
        "arg[0][1][0]: float32[1, 4] -> float32[2, 4]")


def test_predict_engine_steady_trace_names_the_escape():
    from sparkflow_tpu_torch.serving import InferenceEngine
    rs = np.random.RandomState(1)
    weights = [rs.randn(4, 3).astype(np.float32),
               rs.randn(3).astype(np.float32),
               rs.randn(3, 2).astype(np.float32),
               rs.randn(2).astype(np.float32)]
    eng = InferenceEngine(_tgraph(), weights, input_name="x:0",
                          output_name="out/BiasAdd:0", max_batch=4,
                          device="cpu")
    # a shape outside the ladder (as a bypass of the bucket rule would
    # send) is a steady-state signature, named with its leaf
    eng._forward(eng._snapshot_copies(), (np.zeros((3, 4), np.float32),), 3)
    assert eng.stats()["steady_traces"] == 1
    (f,) = eng.recompile_guard.findings()
    assert f.rule == "GC-R401" and "float32[4, 4] -> float32[3, 4]" in (
        f.message)


@pytest.fixture(scope="module")
def lm_params():
    model = torch_model()
    return model, numpy_params(model.param_specs())


@pytest.mark.parametrize("kw", [
    {}, {"prefill_chunk": 8}, {"spec_k": 3}, {"spec_k": 3, "draft_layers": 1,
                                              "kv_quant": "int8"}],
    ids=["plain", "chunked", "spec", "spec-int8"])
def test_decode_engine_warmup_covers_every_shape(lm_params, kw):
    from test_torch_shared import _run_all
    from sparkflow_tpu_torch.serving import DecodeEngine
    model, params = lm_params
    eng = DecodeEngine(model, params, num_slots=4, page_size=8, seed=0, **kw)
    cold = DecodeEngine(model, params, num_slots=4, page_size=8, seed=0,
                        warmup=False, **kw)
    st = eng.stats()
    assert st["traces"] == st["aot_compiles"] > len(eng.prefill_buckets)
    assert st["steady_traces"] == 0
    # warmup leaves no trace in the tokens (scratch page 0 restored)
    assert _run_all(eng) == _run_all(cold)
    assert eng.stats()["steady_traces"] == 0, eng.recompile_guard.report()
    assert cold.stats()["steady_traces"] == 0 < cold.stats()["traces"]


def test_debug_recompiles_fit_matches_jax():
    from sparkflow_tpu.models import presets as jax_presets
    from sparkflow_tpu.trainer import Trainer as JaxTrainer
    from sparkflow_tpu_torch.models import presets
    from sparkflow_tpu_torch.trainer import Trainer
    rs = np.random.RandomState(0)
    x = rs.rand(20, 4).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 20)]
    kw = dict(iters=2, mini_batch_size=8, debug_recompiles=True,
              loss_callback=lambda *a: None)
    jt = JaxTrainer(jax_presets.mlp(4, 2, hidden=(3,)), "x:0", "y:0", **kw)
    tt = Trainer(presets.mlp(4, 2, hidden=(3,)), "x:0", "y:0", device="cpu",
                 **kw)
    jt.fit(x, y)
    tt.fit(x, y)
    assert tt.recompile_report == jt.recompile_report
    assert tt.recompile_findings == jt.recompile_findings == []
    rows = [(x[i].tolist(), y[i].tolist()) for i in range(20)]
    jt.fit_stream(rows)
    tt.fit_stream(rows)
    assert tt.recompile_report == jt.recompile_report == (
        "train_step: 1 trace(s)\n  #1: first trace")


# -- fx_lint ------------------------------------------------------------------


def test_j103_both_directions():
    x = torch.zeros(4, 3)
    a64 = np.linspace(0.0, 1.0, 3)
    (f,) = fx_lint.lint_fn(lambda x: x * torch.as_tensor(a64), (x,),
                           name="planted")
    assert f.rule == "GC-J103" and "aten.mul.Tensor -> float64[4, 3]" in (
        f.message)
    assert [g.rule for g in fx_lint.lint_fn(lambda x: x.double() + 1,
                                            (x,))] == ["GC-J103"]
    # clean: the array given float32, a numpy scalar (no promotion in torch)
    assert fx_lint.lint_fn(
        lambda x: x * torch.as_tensor(a64, dtype=torch.float32)
        * np.float64(1.5), (x,)) == []
    # an input already float64 is the caller's choice: not checked
    assert fx_lint.lint_fn(lambda x: x * 2, (x.double(),)) == []
    assert fx_lint.lint_fn(lambda x: x.double(), (x,),
                           ignore=("GC-J103",)) == []


def test_j108_both_directions():
    from sparkflow_tpu_torch.utils import quant
    pages = 33
    rows = torch.zeros(2, pages, 8, 4, 8, dtype=torch.int8)
    scales = torch.zeros(2, pages, 4)
    pids = torch.tensor([[1, 2], [3, 4]])

    def dequant_then_gather(rows, scales, pids):
        return (rows[0].float() * scales[0][:, None, :, None])[pids]

    def gather_then_dequant(rows, scales, pids):
        return quant.paged_quant_gather(rows, scales, 0, pids)

    args = (rows, scales, pids)
    (f,) = fx_lint.lint_fn(dequant_then_gather, args, kv_pool_pages=pages)
    assert f.rule == "GC-J108" and f.detail["kv_pool_pages"] == pages
    assert f.detail["operand_shape"] == [pages, 8, 4, 8]
    assert fx_lint.lint_fn(gather_then_dequant, args,
                           kv_pool_pages=pages) == []
    assert fx_lint.lint_fn(dequant_then_gather, args) == []  # scan off
    # the pool's write helpers never widen the pool either
    offs = torch.tensor([[0, 3], [5, 7]])
    assert fx_lint.lint_fn(
        lambda r, s, p, o, x: quant.paged_quant_append(r, s, 1, p, o, x),
        (rows, scales, pids, offs, torch.randn(2, 2, 4, 8)),
        kv_pool_pages=pages) == []
    assert fx_lint.lint_fn(
        lambda r, s, p, x: quant.paged_quant_write_pages(r, s, 1, p, x),
        (rows, scales, pids[0], torch.randn(2, 8, 4, 8)),
        kv_pool_pages=pages) == []


@pytest.mark.parametrize("kv", ["int8", "fp8", None])
def test_decode_step_lint_clean(lm_params, kv):
    from sparkflow_tpu_torch.serving import DecodeEngine
    model, params = lm_params
    eng = DecodeEngine(model, params, num_slots=4, page_size=8, seed=0,
                       kv_quant=kv, spec_k=3, warmup=False)
    before = [t.clone() for t in eng._pool_tensors()]
    assert fx_lint.lint_decode_step(eng) == []
    # traced over fake tensors: the pools are untouched, no signature seen
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 eng._pool_tensors()))
    assert eng.stats()["traces"] == 0


def test_j106_on_two_ranks():
    import torch_rank_tasks as T
    from sparkflow_tpu_torch.models import presets
    spec = presets.mlp(6, 3, hidden=(4,))
    with T.rank_pool(2) as pool:
        for stage in (0, 1, 2, 3):
            assert pool.run(T.fx_j106, {"dp": 2}, spec, stage,
                            stage) == [[], []]
        # declared stage 1 built as stage 0: all-reduces, never scatters
        rules, msgs = zip(*pool.run(T.fx_j106, {"dp": 2}, spec, 1, 0)[0])
        assert rules == ("GC-J106",) and "NO reduce_scatter" in msgs[0]
        # declared stage 0 built as stage 1: scatters behind the label
        rules, msgs = zip(*pool.run(T.fx_j106, {"dp": 2}, spec, 0, 1)[0])
        assert rules == ("GC-J106",) and "IS sharded" in msgs[0]


def test_j106_reads_the_observed_collectives():
    from sparkflow_tpu_torch.sharding import ShardingConfig
    lint = fx_lint.lint_sharding_config
    assert lint({"all_reduce": 64}, ShardingConfig(zero_stage=0)) == []
    assert lint({"reduce_scatter": 32, "all_gather": 32},
                ShardingConfig(zero_stage=2)) == []
    (f,) = lint({}, ShardingConfig(zero_stage=1))
    assert "no cross-rank reduction" in f.message
    assert lint({}, ShardingConfig(zero_stage=1), ignore=("GC-J106",)) == []


def test_repo_self_check_clean():
    fs = fx_lint.repo_self_check()
    assert fs == [], "\n".join(f.render() for f in fs)


# -- utils.tracing ------------------------------------------------------------


def test_trace_writes_annotated_spans(tmp_path):
    from sparkflow_tpu_torch.obs import Tracer
    from sparkflow_tpu_torch.utils import tracing
    tracer = Tracer()
    with tracing.trace(str(tmp_path)) as cap:
        with tracer.span("tooling/host_span", profiler_annotation=True):
            torch.ones(8).add_(1)
        with tracing.annotate("tooling/direct"):
            torch.ones(8).mul_(2)
    assert cap.path is not None and os.path.dirname(cap.path) == str(
        tmp_path)
    with open(cap.path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"tooling/host_span", "tooling/direct"} <= names
    assert tracing.device_memory_stats() == {}     # no card initialised
