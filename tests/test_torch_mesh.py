"""PyTorch port, the mesh layer: ``parallel/mesh.py``, ``collectives.py``,
``distributed.py`` and ``sharding.py`` against the JAX package's.

``parse_mesh_shape``, ``make_mesh`` and ``ShardingConfig`` give JAX's
results and error messages for the same inputs. Each collective runs on
ranks of a ``torch.distributed`` gloo group on the CPU (one
:class:`~sparkflow_tpu_torch.parallel.distributed.RankPool` a module: a
2-rank and a 4-rank pool) and matches the JAX collective under
``shard_map`` on the conftest's virtual CPU devices within 1e-6,
``hierarchical_psum_mean`` on ``{dcn: 2, dp: 2}`` included. A failing or
hanging rank stops its pool and raises in the caller.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JP

import torch_rank_tasks as tasks
from sparkflow_tpu.jax_compat import shard_map
from sparkflow_tpu.parallel import collectives as JC
from sparkflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparkflow_tpu.parallel.mesh import parse_mesh_shape as jax_parse
from sparkflow_tpu.sharding import ShardingConfig as JaxConfig
from sparkflow_tpu.sharding import at_rest_leaf_spec as jax_leaf_spec
from sparkflow_tpu_torch.parallel import distributed as D
from sparkflow_tpu_torch.parallel.mesh import (Mesh, as_mesh, default_mesh,
                                               make_mesh, mesh_axis_size,
                                               parse_mesh_shape)
from sparkflow_tpu_torch.sharding import (ShardingConfig, as_sharding_config,
                                          at_rest_leaf_spec, per_device_bytes)

TOL = 1e-6


@pytest.fixture(scope="module")
def pool2():
    with tasks.rank_pool(2, timeout_s=120) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with tasks.rank_pool(4, timeout_s=120) as pool:
        yield pool


def _outcome(fn, *a, **kw):
    """``("ok", value)`` or ``("error", type name, message)``."""
    try:
        return ("ok", fn(*a, **kw))
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("error", type(e).__name__, str(e))


# -- parse_mesh_shape / make_mesh ---------------------------------------------

@pytest.mark.parametrize("s", [
    "dp=2,tp=4", " dp = 2 , sp=2 ", "dp=-1", "fsdp=8", "dp=2,,sp=2",
    "dp", "xx=2", "dp=2,dp=4", "dp=a", "", " , "])
def test_parse_mesh_shape_matches_jax(s):
    assert _outcome(parse_mesh_shape, s) == _outcome(jax_parse, s)


@pytest.mark.parametrize("axes,n", [
    ({"dp": 2}, 2), ({"dp": -1}, 4), ({"dcn": 2, "dp": -1}, 8),
    ({"dp": 2, "sp": 2}, 4), ({"dp": -1, "tp": -1}, 4),
    ({"dp": -1, "tp": 3}, 8), ({"dp": 3}, 2), ({"dp": 2, "sp": 4}, 4)])
def test_make_mesh_matches_jax(axes, n):
    ours = _outcome(make_mesh, axes, devices=n)
    theirs = _outcome(jax_make_mesh, axes, devices=jax.devices()[:n])
    if theirs[0] == "error":
        assert ours == theirs
        return
    assert ours[0] == "ok"
    assert ours[1].shape == dict(theirs[1].shape)
    assert ours[1].axis_names == tuple(theirs[1].axis_names)
    assert ours[1].size == theirs[1].devices.size
    # ranks sit on the mesh as JAX's devices do: row-major
    ids = np.vectorize(lambda d: d.id)(theirs[1].devices)
    for r in range(n):
        c = ours[1].coords(r)
        assert ids[tuple(c[a] for a in ours[1].axis_names)] == \
            jax.devices()[r].id
        assert ours[1].rank_of(c) == r


def test_mesh_helpers():
    m = as_mesh({"dcn": 2, "dp": 3})
    assert isinstance(m, Mesh) and m.size == 6 and m == Mesh({"dcn": 2,
                                                             "dp": 3})
    assert mesh_axis_size(m, "dp") == 3 and mesh_axis_size(m, "sp") == 1
    assert mesh_axis_size(None, "dp") == 1
    assert m.axis_index(("dcn", "dp"), rank=4) == 4
    assert m.axis_index("dp", rank=4) == 1
    assert m.line("dcn", rank=4) == [1, 4]
    assert m.line("dp", rank=4) == [3, 4, 5]
    assert as_mesh(None) is None and as_mesh(m) is m
    with pytest.raises(TypeError, match="mesh must be"):
        as_mesh(object())
    with pytest.raises(ValueError, match=">= 1"):
        as_mesh({"dp": -1})
    with pytest.raises(ValueError, match="not a mesh axis"):
        m.axis_size("sp")
    if not torch.cuda.is_available():
        assert default_mesh() is None
    with pytest.raises(RuntimeError, match="no mesh is bound"):
        from sparkflow_tpu_torch.parallel.collectives import axis_index
        axis_index("dp")
    with pytest.raises(RuntimeError, match="initialised"):
        m.group("dp")


# -- ShardingConfig -----------------------------------------------------------

_CONFIGS = [
    {}, {"zero_stage": 3, "dcn_axis": "dcn"}, {"zero_stage": 5},
    {"data_axis": "dp", "dcn_axis": "dp"}, {"data_axis": ""},
    {"tp_axis": "dp"}, {"dcn_axis": "dcn", "ep_axis": "dcn"},
    {"tp_axis": "mp", "ep_axis": "mp"}, {"tp_axis": ""},
    {"tp_axis": "tp", "ep_axis": "ep", "pp_axis": "pp"},
    {"zero_stage": 2, "offload_opt_state": True, "param_axes": None},
    {"param_axes": {"a": 1}}]


@pytest.mark.parametrize("kw", _CONFIGS, ids=lambda d: repr(d))
def test_sharding_config_matches_jax(kw):
    ours, theirs = _outcome(ShardingConfig, **kw), _outcome(JaxConfig, **kw)
    if theirs[0] == "error":
        assert ours == theirs
        return
    a, b = ours[1], theirs[1]
    assert a.describe() == b.describe()
    assert a.shards_opt_state() == b.shards_opt_state()
    assert a.shards_params() == b.shards_params()
    assert a.model_parallel() == b.model_parallel()
    assert a.replace(zero_stage=1).describe() == \
        b.replace(zero_stage=1).describe()
    for axes, n in (({"dp": 2}, 2), ({"dcn": 2, "dp": 2}, 4),
                    ({"pp": 2}, 2), ({"tp": 2, "ep": 2, "pp": 2}, 8),
                    ({"dcn": 2, "sp": 2}, 4)):
        ours_m, jax_m = make_mesh(axes, devices=n), jax_make_mesh(
            axes, devices=jax.devices()[:n])
        for req in (None, True, False):
            got = _outcome(a.validate, ours_m, require_data_axis=req)
            want = _outcome(b.validate, jax_m, require_data_axis=req)
            assert got[0] == want[0], (axes, req)
            if got[0] == "error":
                assert got == want
        assert a.batch_axes(ours_m) == b.batch_axes(jax_m)
        assert tuple(a.data_spec(ours_m)) == tuple(b.data_spec(jax_m))
        assert a.dp_size(ours_m) == b.dp_size(jax_m)
        assert (a.tp_size(ours_m), a.ep_size(ours_m), a.pp_size(ours_m)) \
            == (b.tp_size(jax_m), b.ep_size(jax_m), b.pp_size(jax_m))


def test_sharding_config_coercion_and_legacy_mapping():
    assert as_sharding_config(None) == ShardingConfig()
    cfg = ShardingConfig(zero_stage=2)
    assert as_sharding_config(cfg) is cfg
    assert as_sharding_config({"zero_stage": 3}).zero_stage == 3
    with pytest.raises(TypeError, match="ShardingConfig"):
        as_sharding_config(3)
    for mode in ("off", "auto", "on", "maybe"):
        ours = _outcome(ShardingConfig.from_legacy, mode, tp_axis="tp")
        theirs = _outcome(JaxConfig.from_legacy, mode, tp_axis="tp")
        assert ours[0] == theirs[0]
        if ours[0] == "ok":
            assert ours[1].describe() == theirs[1].describe()
        else:
            assert ours == theirs


@pytest.mark.parametrize("shape,layout,n", [
    ((8, 5), "flat", 8), ((4, 5), "flat", 8), ((), "flat", None),
    ((2, 3), "flat", None), ((300, 400), "gspmd", None), ((5,), "gspmd", None),
    ((70000,), "gspmd", None), ((3, 3), "sideways", None)])
def test_at_rest_leaf_spec_matches_jax(shape, layout, n):
    ours = _outcome(at_rest_leaf_spec, shape, "dp", layout=layout, n_shards=n)
    theirs = _outcome(jax_leaf_spec, shape, "dp", layout=layout, n_shards=n)
    if theirs[0] == "error":
        assert ours == theirs
    else:
        assert tuple(ours[1]) == tuple(theirs[1])


def test_per_device_bytes():
    assert per_device_bytes(torch.zeros(3, 4)) == 48
    assert per_device_bytes(torch.zeros(3, dtype=torch.bfloat16)) == 6
    assert per_device_bytes(np.zeros((2, 2), np.float32)) == 16


# -- collectives against JAX under shard_map ----------------------------------

def _jax_per_rank(fn, xs, axes):
    """``fn`` on each device's slice of the stacked ``xs`` inside
    shard_map over a mesh of ``axes``; the per-device results."""
    n = xs.shape[0]
    mesh = JaxMesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())),
                   tuple(axes))
    spec = JP(tuple(axes)) if len(axes) > 1 else JP(next(iter(axes)))
    f = shard_map(lambda x: jax.tree.map(lambda y: y[None], fn(x[0])),
                  mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
    out = f(jnp.asarray(xs))
    return [jax.tree.map(lambda y: np.asarray(y[i]), out) for i in range(n)]


def test_collectives_match_jax(pool2):
    rs = np.random.RandomState(0)
    xs = rs.randn(2, 4, 3).astype(np.float32)
    ours = pool2.run(tasks.collectives, {"dp": 2}, xs)
    ref = {
        "psum": lambda x: JC.psum(x, "dp"),
        "psum_mean": lambda x: JC.psum_mean(x, "dp"),
        "all_gather0": lambda x: JC.all_gather(x, "dp", axis=0),
        "all_gather1": lambda x: JC.all_gather(x, "dp", axis=1),
        "all_gather_stack": lambda x: JC.all_gather(x, "dp", tiled=False),
        "reduce_scatter": lambda x: JC.reduce_scatter(x, "dp", axis=0),
        "ppermute": lambda x: JC.ppermute_ring(x, "dp", 1),
        "ppermute_back": lambda x: JC.ppermute_ring(x, "dp", -1),
    }
    for name, fn in ref.items():
        want = _jax_per_rank(fn, xs, {"dp": 2})
        for r in range(2):
            np.testing.assert_allclose(ours[r][name], want[r], atol=TOL,
                                       rtol=0, err_msg=name)
    assert [o["axis_index"] for o in ours] == [0, 1]
    # payload bytes are counted per op; gloo on the CPU stages nothing
    st = ours[0]["stats"]
    assert st["all_reduce"] == 2 * xs[0].nbytes
    assert st["reduce_scatter"] == xs[0].nbytes
    assert st["ppermute"] == 2 * xs[0].nbytes
    assert st.get("host_staged", 0) == 0


def test_hierarchical_psum_mean_matches_jax(pool4):
    rs = np.random.RandomState(1)
    trees = [{"a": rs.randn(5).astype(np.float32),
              "b": {"w": rs.randn(3, 3).astype(np.float32)}}
             for _ in range(4)]
    ours = pool4.run(tasks.hierarchical, {"dcn": 2, "dp": 2}, trees)
    stacked = jax.tree.map(lambda *ls: np.stack(ls), *trees)
    mesh = JaxMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dcn", "dp"))
    spec = JP(("dcn", "dp"))
    f = shard_map(
        lambda t: jax.tree.map(lambda y: y[None], JC.hierarchical_psum_mean(
            jax.tree.map(lambda y: y[0], t), ici_axis="dp",
            dcn_axis="dcn")),
        mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
    want = jax.tree.map(np.asarray, f(jax.tree.map(jnp.asarray, stacked)))
    mean = jax.tree.map(lambda y: y.mean(0), stacked)
    for r in range(4):
        got = ours[r]["two_level"]
        np.testing.assert_allclose(got["a"], want["a"][r], atol=TOL, rtol=0)
        np.testing.assert_allclose(got["b"]["w"], want["b"]["w"][r],
                                   atol=TOL, rtol=0)
        # the same mean as the flat reduction over both axes
        np.testing.assert_allclose(got["a"], mean["a"], atol=TOL, rtol=0)
        np.testing.assert_allclose(ours[r]["flat"]["b"]["w"],
                                   mean["b"]["w"], atol=TOL, rtol=0)


# -- the launcher and the backend rule ----------------------------------------

def test_a_failing_or_hanging_rank_stops_the_launch(monkeypatch):
    monkeypatch.setenv("SPARKFLOW_TORCH_MESH_TIMEOUT_S", "60")
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*on purpose"):
        D.launch(tasks.fail_on, 2, 1, device="cpu")
    pool = D.RankPool(2, device="cpu")
    with pytest.raises(RuntimeError, match="timed out"):
        pool.run(tasks.hang, 60, timeout_s=2)
    assert pool._closed and not any(p.is_alive() for p in pool._procs)
    with pytest.raises(RuntimeError, match="closed"):
        pool.run(tasks.rank)


def test_backend_rule():
    assert D.choose_backend(2, "cpu") == "gloo"
    assert D.choose_backend(2, "cpu", "gloo") == "gloo"
    with pytest.raises(ValueError, match="CPU backend"):
        D.choose_backend(2, "cpu", "nccl")
    cards = torch.cuda.device_count()
    if cards < 2:
        # two ranks, fewer cards: gloo, and NCCL is refused, never swapped
        assert D.choose_backend(2, "cuda") == "gloo"
        with pytest.raises(ValueError, match="one card per rank"):
            D.choose_backend(2, "cuda", "nccl")
    with pytest.raises(ValueError, match="'nccl', 'gloo' or None"):
        D.choose_backend(1, "cuda", "mpi")
    assert D.rank_device(3, "cpu") == "cpu"


def test_distributed_helpers(monkeypatch):
    monkeypatch.setenv("SPARKFLOW_TPU_COORDINATOR", "10.0.0.1")
    assert D.determine_master(9000) == "10.0.0.1:9000"
    monkeypatch.setenv("SPARKFLOW_TPU_COORDINATOR", "10.0.0.1:77")
    assert D.determine_master() == "10.0.0.1:77"
    for var in ("SPARKFLOW_TPU_COORDINATOR", "MASTER_ADDR", "WORLD_SIZE",
                "RANK"):
        monkeypatch.delenv(var, raising=False)
    D.initialize()                     # nothing to go on: no-op, no latch
    assert not D._INITIALIZED and D.current_backend() is None
    with pytest.raises(ValueError, match=re.escape("number of processes")):
        D.initialize(coordinator_address="127.0.0.1:1")
    assert D.process_local_batch(8) == 8
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(D.local_rows(x, 1, 3), x[2:4])
    with pytest.raises(ValueError, match="does not divide"):
        D.local_rows(x, 0, 4)
    with pytest.raises(RuntimeError, match="initialised"):
        D.global_mesh({"dp": -1})
