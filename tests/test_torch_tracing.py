"""PyTorch port, fleet-wide tracing: the ``traceparent`` wire format, a
hedged generate's cross-process trace, and the crash flight recorder,
held against the JAX package (``tests/test_tracing.py``).

- the ``traceparent`` header: minted by either package, parsed by the
  other to the same ids and flags; garbage parses to None in both;
- a hedged, chaos-delayed ``/v1/generate`` through the port's router and
  two port decode servers assembles ONE trace (every assertion of the JAX
  test), with the span names of the same scenario on JAX servers and the
  tokens of JAX's ``DecodeEngine`` on the same numpy-drawn weights;
- the wire between the packages: a JAX router over a port replica and a
  port router over a JAX replica each assemble one trace over both
  processes, with the span names of the port-only run;
- the flight recorder over real port replica processes
  (``tests/torch_trace_replica.py``): a SIGTERM dumps, a SIGKILL leaves
  the begin line that names the trace in flight; and a recorder file
  written by either package is harvested by the other to the same report.
"""

import ast
import json
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_shared import PAGE, jax_model, numpy_params, torch_model
from sparkflow_tpu.obs import flight as jax_flight
from sparkflow_tpu.obs import spans as jax_spans
from sparkflow_tpu.serving import ContinuousBatcher as JaxBatcher
from sparkflow_tpu.serving import DecodeEngine as JaxDecodeEngine
from sparkflow_tpu.serving import InferenceServer as JaxServer
from sparkflow_tpu.serving import RouterServer as JaxRouter
from sparkflow_tpu.serving import ServingClient as JaxClient
from sparkflow_tpu.utils.metrics import Metrics as JaxMetrics
from sparkflow_tpu_torch.analysis import restrack
from sparkflow_tpu_torch.convert import params_from_jax
from sparkflow_tpu_torch.obs import flight as port_flight
from sparkflow_tpu_torch.obs import spans as port_spans
from sparkflow_tpu_torch.resilience.retry import RetryPolicy
from sparkflow_tpu_torch.serving import (ContinuousBatcher, DecodeEngine,
                                         InferenceServer, RouterServer,
                                         ServingClient)
from sparkflow_tpu_torch.serving.autoscaler import ReplicaManager
from sparkflow_tpu_torch.serving.membership import Membership
from sparkflow_tpu_torch.utils.metrics import Metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(REPO, "tests", "torch_trace_replica.py")

JAX = SimpleNamespace(name="jax", spans=jax_spans, flight=jax_flight,
                      Metrics=JaxMetrics, Batcher=JaxBatcher,
                      Server=JaxServer, Router=JaxRouter, Client=JaxClient)
PORT = SimpleNamespace(name="port", spans=port_spans, flight=port_flight,
                       Metrics=Metrics, Batcher=ContinuousBatcher,
                       Server=InferenceServer, Router=RouterServer,
                       Client=ServingClient)
PKGS = {"jax": JAX, "port": PORT}

PROMPT, NEW = [1, 2, 3], 4
STALL_S = 1.2


# -- traceparent (the wire format) -------------------------------------------


def _seeded_contexts(spans_mod, n=50, seed=23):
    """``n`` contexts from a seed: random 128-bit ids, half with a parent
    uid of a fresh tracer, sampled or not."""
    rng = np.random.default_rng(seed)
    tracer = spans_mod.Tracer()
    out = []
    for i in range(n):
        trace_id = rng.bytes(16).hex()
        parent = (tracer.span_uid(int(rng.integers(1, 1 << 20)))
                  if i % 2 else None)
        out.append(spans_mod.TraceContext(trace_id, parent,
                                          bool(rng.integers(0, 2))))
    return out


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_traceparent_headers_interchange(src, dst):
    """A header minted by one package parses in the other to the same ids
    and flags, and prints back to the same header."""
    a, b = PKGS[src].spans, PKGS[dst].spans
    assert a.TRACEPARENT_HEADER == b.TRACEPARENT_HEADER == "traceparent"
    for ctx in _seeded_contexts(a) + [a.TraceContext.mint()]:
        back = b.TraceContext.parse(ctx.to_header())
        assert back is not None, ctx
        assert (back.trace_id, back.parent, back.sampled) == (
            ctx.trace_id, ctx.parent, ctx.sampled)
        assert back.to_header() == ctx.to_header()


def test_child_contexts_reparent_identically():
    """``child`` under a span uid of either package's tracer: the same
    header in both, which round-trips in both."""
    for ctx_j in _seeded_contexts(jax_spans, n=10, seed=5):
        ctx_p = port_spans.TraceContext(ctx_j.trace_id, ctx_j.parent,
                                        ctx_j.sampled)
        for uid in (jax_spans.Tracer().span_uid(7),
                    port_spans.Tracer().span_uid(7)):
            assert "-" not in uid
            hj, hp = ctx_j.child(uid).to_header(), ctx_p.child(uid).to_header()
            assert hj == hp
            for spans_mod in (jax_spans, port_spans):
                back = spans_mod.TraceContext.parse(hj)
                assert back.trace_id == ctx_j.trace_id and back.parent == uid


MALFORMED = [None, "", "not-a-header", "00-zz-0-01",
             "00-" + "0" * 32 + "-x-01", "99-" + "a" * 32 + "-x-01",
             "00-" + "a" * 31 + "-x-01", "00-" + "a" * 32 + "-x-zz",
             "00-" + "a" * 32 + "-x", "00-" + "g" * 32 + "-x-01"]


@pytest.mark.parametrize("header", MALFORMED, ids=range(len(MALFORMED)))
def test_malformed_headers_parse_to_none_in_both(header):
    assert jax_spans.TraceContext.parse(header) is None
    assert port_spans.TraceContext.parse(header) is None


# -- decode servers, hedging and trace assembly -------------------------------


class _ChaosPrefill:
    """A decode engine whose prefill stalls ``delay_s``: the straggler a
    hedge must race around (0 serves as the plain engine)."""

    def __init__(self, engine, delay_s: float = 0.0):
        self._engine = engine
        self.delay_s = delay_s

    def prefill(self, *args, **kwargs):
        if self.delay_s:
            time.sleep(self.delay_s)
        return self._engine.prefill(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._engine, name)


def _decode_server(pkg, engine, delay_s=0.0):
    tracer = pkg.spans.Tracer()
    batcher = pkg.Batcher(_ChaosPrefill(engine, delay_s), max_queue=64,
                          tracer=tracer)
    srv = pkg.Server(None, generate_batcher=batcher, max_delay_ms=1.0,
                     tracer=tracer, memory_watch=False)
    srv._httpd.handle_error = lambda *a: None   # hedge losers tear sockets
    return srv.start()


@pytest.fixture(scope="module")
def fleet():
    """A slow (stalled prefill) and a fast decode server of each package,
    on the same numpy-drawn weights."""
    jm = jax_model()
    npp = numpy_params(jm.param_specs(), seed=2)
    jp = jax.tree.map(jnp.asarray, npp)
    tm = torch_model()
    tp = params_from_jax(tm, npp)
    servers = {}
    try:
        for role, delay in (("slow", STALL_S), ("fast", 0.0)):
            servers["jax", role] = _decode_server(
                JAX, JaxDecodeEngine(jm, jp, num_slots=4, page_size=PAGE,
                                     seed=0), delay)
            servers["port", role] = _decode_server(
                PORT, DecodeEngine(tm, tp, num_slots=4, page_size=PAGE,
                                   seed=0), delay)
        yield servers
    finally:
        for (_pkg, role), srv in servers.items():
            if role == "slow":
                srv.kill()          # its batcher may be mid-stall
            else:
                srv.stop()


def _settled_trace(pkg, router, trace_id, done, timeout_s=15.0):
    """``GET /traces/<id>`` from ``router`` until ``done(trace)``."""
    probe = pkg.Client(router.url)
    try:
        deadline = time.time() + timeout_s
        while True:
            trace = probe._request(f"/traces/{trace_id}")
            if done(trace) or time.time() > deadline:
                return trace
            time.sleep(0.1)
    finally:
        probe.close()


def _outcomes(trace):
    return sorted((s.get("args") or {}).get("outcome", "")
                  for s in trace["spans"] if s["name"] == "router/dispatch")


def _hedged_generate(pkg, fleet):
    slow, fast = fleet[pkg.name, "slow"], fleet[pkg.name, "fast"]
    router = pkg.Router([slow.url, fast.url], probe_interval_s=60.0,
                        hedge=True, hedge_delay_ms=100.0,
                        dispatch_retries=1, tracer=pkg.spans.Tracer(),
                        trace_sample=0.0).start()
    try:
        ctx = pkg.spans.TraceContext.mint()
        client = pkg.Client(router.url, retries=0)
        out = client.generate(PROMPT, max_new_tokens=NEW, traceparent=ctx,
                              timeout_s=60.0)
        client.close()
        # hedged -> always kept, regardless of trace_sample=0.0
        assert ctx.trace_id in router.collector.trace_ids()
        trace = _settled_trace(pkg, router, ctx.trace_id,
                               lambda t: _outcomes(t) == ["loser", "winner"])
        return ctx, out, trace
    finally:
        router.stop()


@pytest.fixture(scope="module")
def jax_hedged(fleet):
    """The same hedged scenario on the JAX servers and router."""
    return _hedged_generate(JAX, fleet)


def test_hedged_generate_assembles_single_trace_with_loser_labeled(
        fleet, jax_hedged):
    ctx, out, trace = _hedged_generate(PORT, fleet)
    assert out["num_tokens"] == NEW
    assert trace["trace_id"] == ctx.trace_id
    assert trace["reason"] == "hedged"
    assert len(trace["processes"]) == 3   # router + both replicas
    names = [s["name"] for s in trace["spans"]]
    assert "router/request" in names
    assert _outcomes(trace) == ["loser", "winner"]
    assert "serving/request" in names
    assert "serving/decode_admit" in names
    assert names.count("serving/decode_tick") >= NEW   # one per token
    # monotone wall-clock ordering; a child starts no earlier than its
    # parent, within the anchor skew between tracers
    ts = [s["ts"] for s in trace["spans"]]
    assert ts == sorted(ts)
    by_id = {s["span_id"]: s for s in trace["spans"]}
    for s in trace["spans"]:
        parent = by_id.get(s.get("parent_id"))
        if parent is not None:
            assert s["ts"] >= parent["ts"] - 0.05, (s, parent)
    # each replica's serving/request hangs under a distinct dispatch
    roots = {s.get("parent_id") for s in trace["spans"]
             if s["name"] == "serving/request"}
    dispatch_ids = {s["span_id"] for s in trace["spans"]
                    if s["name"] == "router/dispatch"}
    assert roots and roots <= dispatch_ids and len(roots) == 2
    # the JAX fleet's trace of the same scenario: the same span names, and
    # its DecodeEngine's tokens
    _jctx, jout, jtrace = jax_hedged
    assert jtrace["reason"] == "hedged" and len(jtrace["processes"]) == 3
    assert set(names) == {s["name"] for s in jtrace["spans"]}
    assert out["tokens"] == jout["tokens"]


def _single(router_pkg, replica, timeout_s=15.0):
    """One generate through ``router_pkg``'s router over ``replica`` with
    every trace kept; (tokens, the trace once both processes are in)."""
    router = router_pkg.Router([replica.url], probe_interval_s=60.0,
                               tracer=router_pkg.spans.Tracer(),
                               trace_sample=1.0).start()
    try:
        header = router_pkg.spans.TraceContext.mint().to_header()
        trace_id = header.split("-")[1]
        client = router_pkg.Client(router.url, retries=0)
        out = client.generate(PROMPT, max_new_tokens=NEW, traceparent=header,
                              timeout_s=60.0)
        client.close()
        trace = _settled_trace(router_pkg, router, trace_id,
                               lambda t: len(t["processes"]) == 2,
                               timeout_s)
        assert trace["trace_id"] == trace_id
        return out["tokens"], trace
    finally:
        router.stop()


@pytest.mark.parametrize("router_pkg,replica_pkg",
                         [("jax", "port"), ("port", "jax")],
                         ids=["jax-router-port-replica",
                              "port-router-jax-replica"])
def test_traces_assemble_across_the_packages(fleet, router_pkg, replica_pkg):
    """``trace_sample=1.0``: one generate assembles one trace over the
    router and the replica, whichever package each is, with the span names
    of the port-only run and JAX's tokens."""
    want_tokens, want = _single(PORT, fleet["port", "fast"])
    tokens, trace = _single(PKGS[router_pkg], fleet[replica_pkg, "fast"])
    assert len(trace["processes"]) == 2
    assert tokens == want_tokens
    names = {s["name"] for s in trace["spans"]}
    assert names == {s["name"] for s in want["spans"]}
    assert {"router/request", "router/dispatch", "serving/request",
            "serving/decode_admit", "serving/decode_tick"} <= names
    jax_tokens, _ = _single(JAX, fleet["jax", "fast"])
    assert tokens == jax_tokens


def test_router_response_advertises_traceparent(fleet):
    router = RouterServer([fleet["port", "fast"].url], probe_interval_s=60.0,
                          tracer=port_spans.Tracer(),
                          trace_sample=1.0).start()
    try:
        client = ServingClient(router.url, retries=0)
        _body, hdrs = client._request(
            "/v1/generate", {"prompt": [1, 2], "max_new_tokens": 2},
            with_headers=True, timeout_s=60.0)
        client.close()
        advertised = port_spans.TraceContext.parse(
            hdrs.get(port_spans.TRACEPARENT_HEADER))
        assert advertised is not None
        # head_sample=1.0 keeps even this boring request
        assert advertised.trace_id in router.collector.trace_ids()
    finally:
        router.stop()


# -- flight harvest over real port replica processes --------------------------


def test_trace_replica_helper_imports_only_the_port():
    with open(HELPER) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom)
                else [])
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "sparkflow_tpu")


def test_replica_manager_harvests_port_flight_records(tmp_path, monkeypatch):
    """SIGTERM gets a dump; SIGKILL gets begin-line replay naming the
    in-flight trace id; both harvested by the port's ReplicaManager with
    no pooled connection leaked under the resource tracker."""
    monkeypatch.setenv("SPARKFLOW_TPU_RESTRACK", "1")
    assert restrack.enabled()
    tracker = restrack.ResourceTracker().install()
    flight_dir = str(tmp_path)
    delay = [0.0]

    def launcher(port):
        cmd = [sys.executable, HELPER, "--port", str(port),
               "--flight-dir", flight_dir]
        if delay[0]:
            cmd += ["--predict-delay-s", str(delay[0])]
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = REPO
        return subprocess.Popen(cmd, env=env)

    metrics = Metrics()
    mem = Membership(["http://127.0.0.1:1"], metrics=metrics,
                     probe_interval_s=0.2)
    mem.deregister(mem.replicas[0])
    rm = ReplicaManager(launcher, membership=mem,
                        retry=RetryPolicy(max_attempts=2, base_s=0.2),
                        health_timeout_s=120.0, drain_timeout_s=10.0,
                        metrics=metrics, flight_dir=flight_dir)
    try:
        # -- SIGTERM: graceful death dumps, the harvest sees the dump
        graceful = rm.spawn()
        restrack.instrument_pool(graceful.pool)
        mem.probe_all()
        assert graceful.flight_path is not None
        assert graceful.flight_path.endswith(
            f"replica-{graceful.port}.jsonl")
        ctx_done = port_spans.TraceContext.mint()
        client = ServingClient(graceful.url, retries=0)
        client.predict_full(np.zeros((1, 4), np.float32),
                            traceparent=ctx_done, timeout_s=30.0)
        client.close()
        rm.drain(graceful, reason="scale-down")
        rep = {r["replica_url"]: r for r in rm.flight_reports}[graceful.url]
        assert rep["dumped"] and rep["reason"].startswith("signal:")
        assert rep["begins"] >= 1
        assert ctx_done.trace_id not in rep["inflight_trace_ids"]

        # -- SIGKILL: no dump, the begin line names the dead trace
        delay[0] = 30.0
        doomed = rm.spawn()
        restrack.instrument_pool(doomed.pool)
        ctx_dead = port_spans.TraceContext.mint()

        def fire():
            c = ServingClient(doomed.url, retries=0)
            try:
                c.predict_full(np.zeros((1, 4), np.float32),
                               traceparent=ctx_dead, timeout_s=5.0)
            except Exception:
                pass   # killed out from under it: that is the test
            finally:
                c.close()

        t = threading.Thread(target=fire, daemon=True)
        t.start()
        flight_file = os.path.join(flight_dir,
                                   f"replica-{doomed.port}.jsonl")
        deadline = time.time() + 20.0
        while time.time() < deadline:
            if (os.path.exists(flight_file)
                    and '"begin"' in open(flight_file).read()):
                break
            time.sleep(0.05)
        rm.destroy(doomed, reason="crash")        # SIGKILL, no last word
        t.join(timeout=30.0)
        rep = {r["replica_url"]: r for r in rm.flight_reports}[doomed.url]
        assert not rep["dumped"]
        assert rep["inflight_trace_ids"] == [ctx_dead.trace_id]
        assert rep["harvest_reason"] == "crash"
        assert metrics.counters()["autoscaler/flight_harvested"] == 2.0
    finally:
        rm.stop_all(kill=True)
        mem.stop()
        tracker.uninstall()
    tracker.assert_balanced()


# -- flight files between the packages ----------------------------------------


def _write_flight(pkg, path, case):
    """A recorder file: three requests begun, one ended; ``dump`` adds the
    last word, ``torn`` a line cut off mid-write."""
    tracer, metrics = pkg.spans.Tracer(), pkg.Metrics()
    fr = pkg.flight.FlightRecorder(path, tracer=tracer, metrics=metrics)
    for i, tid in enumerate(("a" * 32, "b" * 32, "c" * 32)):
        fr.begin(tid, request_id=f"r{i}")
    with tracer.span("serving/request", args={"trace_id": "b" * 32}):
        metrics.incr("serving/requests")
    fr.end("b" * 32)
    if case == "dump":
        fr.dump(reason="signal:15")
    fr.close()
    if case == "torn":
        with open(path, "a") as f:
            f.write('{"event":"begin","trace_id":"' + "d" * 32 + '","ts":1')


@pytest.mark.parametrize("case", ["clean", "dump", "torn"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_flight_files_interchange(tmp_path, writer, reader, case):
    path = str(tmp_path / "replica-1.jsonl")
    _write_flight(PKGS[writer], path, case)
    got = PKGS[reader].flight.harvest_flight(path)
    assert got == PKGS[writer].flight.harvest_flight(path)
    assert got["inflight_trace_ids"] == ["a" * 32, "c" * 32]
    assert (got["begins"], got["ends"]) == (3, 1)
    assert got["dumped"] == (case == "dump")
    if case == "dump":
        assert got["reason"] == "signal:15"
        assert got["metric_deltas"] == {"serving/requests": 1.0}
        assert [s["name"] for s in got["spans"]] == ["serving/request"]
    json.dumps(got)
