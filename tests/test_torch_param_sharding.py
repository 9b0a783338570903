"""PyTorch port, explicit parameter placement: ``Trainer(param_sharding=
<PartitionSpec pytree>)`` and ``ShardingConfig(param_axes=<pytree>)``
(``parallel/tp.py``'s ``PlacementPlan`` and just-in-time gather, the
sharded step of ``parallel/dp.py``), against the JAX package's
``Trainer`` given the same tree, and the ZeRO re-exports of
``optimizers.py``.

The JAX side runs GSPMD on the conftest's virtual CPU devices; the port's
ranks run over gloo on the CPU in one module-scoped 2-rank pool and, for
the ``tp`` x ``fsdp`` cases, one 4-rank pool, each fit in place as under
torchrun (one fit is launched, as a user's is). Weights and tokens are
drawn with numpy and handed to both packages; dropout is off and the rows
keep their order.

The ``tp`` x ``fsdp`` tree is built here, not by the library: the
model's Megatron rules on ``tp``, plus ``fsdp`` on the first dimension
the rule leaves free where ``fsdp`` divides it; one-dimensional leaves
keep their rule.

Tolerances (float32, ``tests/test_torch_tp.py``'s): 4 adam steps' losses
within 2e-4 relative and params within 1e-5 absolute, adam's epsilon at
1e-4 (the key third of ``qkv_bias`` has an exactly zero gradient that
adam would magnify); one SGD step's loss within 1e-5 relative; predictions
within 1e-5 absolute. Within the port, an explicit tree equal to the
derived one, and an all-replicated tree against ``param_sharding=None``,
give the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import sparkflow_tpu.checkpoint as jax_ckpt
import sparkflow_tpu.optimizers as jax_optimizers
import sparkflow_tpu_torch.optimizers as optimizers
import sparkflow_tpu_torch.optimizers_sharded as optimizers_sharded
import torch_rank_tasks as tasks
from test_torch_shared import numpy_params
from sparkflow_tpu.models import model_from_json as jax_model
from sparkflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sparkflow_tpu.parallel.tp import derive_param_pspecs as jax_derive
from sparkflow_tpu.sharding import ShardingConfig as JaxShardingConfig
from sparkflow_tpu.trainer import Trainer as JaxTrainer
from sparkflow_tpu.trainer import _ckpt_state as jax_ckpt_state
from sparkflow_tpu_torch.checkpoint import CheckpointManager
from sparkflow_tpu_torch.convert import sorted_leaves
from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
from sparkflow_tpu_torch.parallel.mesh import Mesh
from sparkflow_tpu_torch.parallel.tp import PlacementPlan
from sparkflow_tpu_torch.sharding import P, ShardingConfig
from sparkflow_tpu_torch.trainer import Trainer

S = 16
LM = dict(vocab_size=64, hidden=32, num_layers=2, num_heads=4, mlp_dim=64,
          max_len=S, dropout=0.0)
MOE = dict(LM, num_experts=4, moe_every=2, capacity_factor=2.0)
TPF = {"tp": 2, "fsdp": 2}
LOSS_RTOL, PARAM_ATOL = 2e-4, 1e-5
ZERO_NAMES = ("sharded_update", "zero1_state_specs", "place_zero1_state",
              "gather_zero1_state", "shard_zero1_state",
              "has_per_param_state")


@pytest.fixture(scope="module")
def pool2():
    with tasks.rank_pool(2, timeout_s=180) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with tasks.rank_pool(4, timeout_s=180) as pool:
        yield pool


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jax_make_mesh(axes, devices=jax.devices()[:n])


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(ours, theirs, msg="", **tol):
    for layer in theirs:
        for k in theirs[layer]:
            np.testing.assert_allclose(
                np.asarray(ours[layer][k]), np.asarray(theirs[layer][k]),
                err_msg=f"{msg} {layer}/{k}", **tol)


def _same(a, b, msg=""):
    _close(a, b, msg, rtol=0, atol=0)


def _fit_kw(**over):
    kw = dict(optimizer="adam", learning_rate=0.01, iters=2,
              mini_batch_size=4, shuffle_per_iter=False, seed=0,
              optimizer_options={"epsilon": 1e-4})
    kw.update(over)
    return kw


def _tokens(n, seed):
    return np.random.default_rng(seed).integers(
        0, LM["vocab_size"], (n, S)).astype(np.float32)


def _case(family=("transformer_lm", LM), seed=4):
    spec = build_registry_spec(family[0], **family[1])
    p0 = numpy_params(jax_model(spec).param_specs(), seed=seed, std=0.1)
    return spec, p0


def _as_jax(tree):
    return {ln: {k: JP(*s) for k, s in d.items()} for ln, d in tree.items()}


def _rules(spec, edit=None):
    """The model's own table (``param_pspecs()``) in the port's specs,
    ``edit(layer, name, spec)`` applied to each leaf."""
    table = model_from_json(spec, device="cpu").param_pspecs()
    edit = edit or (lambda _ln, _k, s: s)
    return {ln: {k: edit(ln, k, s) for k, s in d.items()}
            for ln, d in table.items()}


def tp_fsdp_tree(spec):
    """Megatron on ``tp`` plus ``fsdp`` on each leaf's first free
    dimension that 2 divides; 1-D leaves keep their rule."""
    shapes = model_from_json(spec, device="cpu").param_specs()

    def edit(ln, k, s):
        shape = shapes[ln][k][0]
        entries = list(s) + [None] * (len(shape) - len(s))
        if len(shape) > 1:
            for d, e in enumerate(entries):
                if e is None and shape[d] % TPF["fsdp"] == 0:
                    entries[d] = "fsdp"
                    break
        return P(*entries)

    return _rules(spec, edit)


def plain_tree(spec):
    """A tree the Megatron forward cannot run: ``qkv_kernel`` split by
    rows over ``tp`` (the rule splits its columns), ``embed.tok`` by
    rows."""
    def edit(ln, k, s):
        if k == "qkv_kernel" or (ln, k) == ("embed", "tok"):
            return P("tp", None)
        return s
    return _rules(spec, edit)


def _jax_fit(spec, axes, tree, kw, toks, p0, stream=False):
    jt = JaxTrainer(spec, "input_ids", None, mesh=_jmesh(axes),
                    param_sharding=_as_jax(tree), **kw)
    if stream:
        return jt, jt.fit_stream(lambda: iter(list(toks)),
                                 init_params=jax.tree.map(jnp.asarray, p0),
                                 chunk=64)
    return jt, jt.fit(toks, init_params=jax.tree.map(jnp.asarray, p0))


def _port_fit(pool, spec, axes, kw, toks, p0, stream=False):
    task = tasks.tp_stream_fit if stream else tasks.tp_trainer_fit
    return pool.run(task, spec, axes, dict(kw, inputs=("input_ids", None)),
                    toks, None, p0)


def _against_jax(ours, jr, jt, msg):
    for r in ours:
        np.testing.assert_allclose(r["losses"], jr.losses, rtol=LOSS_RTOL,
                                   err_msg=msg)
        _close(r["params"], _np_tree(jt.params), msg, atol=PARAM_ATOL,
               rtol=0)
    assert all(r["losses"] == ours[0]["losses"] for r in ours)


# -- the ZeRO re-exports -------------------------------------------------------


@pytest.mark.parametrize("name", ZERO_NAMES)
def test_zero_names_import_from_both_optimizers_modules(name):
    """JAX's ``optimizers.py`` re-exports six names of
    ``optimizers_sharded``; the port's does too, the same objects."""
    assert callable(getattr(jax_optimizers, name))
    assert getattr(optimizers, name) is getattr(optimizers_sharded, name)


# -- the plan ----------------------------------------------------------------


def test_placement_plan_decides_leaf_by_leaf():
    """The decision each tree gives on the LM: the derived Megatron tree
    computes every split; tp x fsdp computes on tp and keeps fsdp at rest;
    the plain-forward tree computes on nothing; the expert leaves compute
    on ep."""
    spec, _ = _case()
    model = model_from_json(spec, device="cpu")
    tmpl = {ln: {k: np.zeros(shape) for k, (shape, _i) in d.items()}
            for ln, d in model.param_specs().items()}

    def plan(tree, axes):
        return PlacementPlan(model, Mesh(axes), tree, tmpl)

    mega = plan(model.param_pspecs(), {"tp": 2}).describe()
    assert mega == {"compute_axes": ["tp"], "leaves": {
        "compute": 12, "at_rest": 0, "compute_and_at_rest": 0,
        "replicated": 16}}
    tpf = plan(tp_fsdp_tree(spec), TPF)
    assert tpf.describe() == {"compute_axes": ["tp"], "leaves": {
        "compute": 4, "at_rest": 2, "compute_and_at_rest": 8,
        "replicated": 14}}
    assert tpf.compute[("block_0", "qkv_kernel")] == {1: "tp"}
    assert tpf.rest[("block_0", "qkv_kernel")] == [(0, ("fsdp",))]
    plain = plan(plain_tree(spec), {"tp": 2})
    assert plain.tp_axis is None and plain.describe()["leaves"] == {
        "compute": 0, "at_rest": 13, "compute_and_at_rest": 0,
        "replicated": 15}
    moe_spec, _ = _case(("transformer_moe_lm", MOE))
    moe = model_from_json(moe_spec, device="cpu")
    mt = {ln: {k: np.zeros(shape) for k, (shape, _i) in d.items()}
          for ln, d in moe.param_specs().items()}
    ep = PlacementPlan(moe, Mesh({"ep": 2}), moe.param_pspecs(), mt)
    assert ep.ep_axis == "ep" and ep.tp_axis is None
    assert ep.compute[("block_1", "experts_fc1")] == {0: "ep"}


# -- fits against the derived tree and against JAX -------------------------------


@pytest.mark.parametrize("family,axes", [
    (("transformer_lm", LM), {"tp": 2}),
    (("transformer_lm", LM), {"dp": 1, "fsdp": 2}),
    (("transformer_moe_lm", MOE), {"ep": 2})], ids=["tp", "fsdp", "ep"])
def test_explicit_derived_tree_equals_auto_bit_for_bit(pool2, family, axes):
    """(a) JAX's own ``derive_param_pspecs`` output, given as an explicit
    tree, trains to the ``"auto"`` fit's bits in the port."""
    spec, p0 = _case(family)
    derived = jax_derive(jax_model(spec), _jmesh(axes))
    tree = {ln: {k: P(*tuple(s)) for k, s in d.items()}
            for ln, d in derived.items()}
    toks = _tokens(8, 1)
    kw = _fit_kw(iters=1)
    auto = _port_fit(pool2, spec, axes, kw, toks, p0)
    mine = _port_fit(pool2, spec, axes, dict(kw, param_sharding=tree), toks,
                     p0)
    for a, b in zip(auto, mine):
        assert a["losses"] == b["losses"]
        _same(a["params"], b["params"], "auto vs explicit")
        assert b["stats"]["placement"] == a["stats"]["placement"]


@pytest.fixture(scope="module")
def tpf_fits(pool4, tmp_path_factory):
    """The tp x fsdp tree, 4 adam steps (2 epochs x 2 batches) with a
    checkpoint an epoch, in each package."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_ckpt, "_HAVE_ORBAX", False)
    spec, p0 = _case(seed=4)
    tree = tp_fsdp_tree(spec)
    toks = _tokens(8, 9)
    d = tmp_path_factory.mktemp("tpf")
    kw = _fit_kw(checkpoint_every=1)
    jt, jr = _jax_fit(spec, TPF, tree, dict(kw, checkpoint_dir=str(
        d / "jax")), toks, p0)
    ours = _port_fit(pool4, spec, TPF, dict(
        kw, param_sharding=tree, checkpoint_dir=str(d / "port")), toks, p0)
    yield dict(spec=spec, p0=p0, tree=tree, toks=toks, kw=kw, jt=jt, jr=jr,
               ours=ours, dir=d)
    mp.undo()


def test_tp_fsdp_tree_fits_as_jax(tpf_fits):
    """(b) ``Trainer(mesh={"tp": 2, "fsdp": 2}, param_sharding=tree)``:
    the Megatron forward over tp on packed qkv columns, each 2-D leaf
    stored over fsdp and gathered just in time — JAX's losses and params,
    a quarter of the bytes a rank."""
    f = tpf_fits
    _against_jax(f["ours"], f["jr"], f["jt"], "tp x fsdp")
    full = sum(a.nbytes for d in f["p0"].values() for a in d.values())
    for r in f["ours"]:
        st = r["stats"]
        assert st["placement"]["compute_axes"] == ["tp"]
        assert st["zero_stage"] == 0
        assert st["ranks"][0]["param_bytes"] < full / 2


def test_tp_fsdp_checkpoints_interchange(tpf_fits, pool4, tmp_path):
    """(g) The tp x fsdp checkpoint holds the standard layout: one card
    resumes it bit for bit (training nothing), JAX's trainer carries it on
    to the port's own continued fit, and the port at tp x fsdp carries on
    from JAX's tp x fsdp checkpoint."""
    f = tpf_fits
    spec, kw, toks, tree = f["spec"], f["kw"], f["toks"], f["tree"]
    d_port, d_jax = str(f["dir"] / "port"), str(f["dir"] / "jax")
    one = Trainer(spec, "input_ids", None, device="cpu",
                  **dict(kw, checkpoint_dir=d_port))
    r = one.fit(toks)
    assert one._resumed_from == 2 and r.losses == []
    _same({ln: {k: v.detach().numpy() for k, v in d.items()}
           for ln, d in r.params.items()}, f["ours"][0]["params"], "one")
    # each package reads the other's checkpoint: the port's into a JAX
    # directory (JAX's own random stream), JAX's into a port directory
    jlike = jax.tree.map(np.asarray, jax_ckpt_state(
        f["jt"].params, f["jt"]._last_opt_state, 0, jax.random.PRNGKey(0),
        rng_impl=None))
    tlike = one._ckpt_state(one.params, one._last_opt_state, 0,
                            one._generators())
    jstate = jax_ckpt.CheckpointManager(d_port).restore(step=2, like=jlike)
    tstate = CheckpointManager(d_jax).restore(step=2, like=tlike)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_ckpt, "_HAVE_ORBAX", False)
    try:
        d_to_jax = str(tmp_path / "to_jax")
        jax_ckpt.CheckpointManager(d_to_jax).save(2, jax.tree.map(
            np.asarray, jax_ckpt_state(jstate["params"], jstate["opt_state"],
                                       2, jax.random.PRNGKey(0),
                                       rng_impl=None)))
        jt2, jr2 = _jax_fit(spec, TPF, tree, dict(
            kw, iters=4, checkpoint_dir=d_to_jax), toks, f["p0"])
    finally:
        mp.undo()
    d_to_port = str(tmp_path / "to_port")
    CheckpointManager(d_to_port).save(2, one._ckpt_state(
        tstate["params"], tstate["opt_state"], 2, one._generators()))
    cont = _port_fit(pool4, spec, TPF, dict(
        kw, iters=4, param_sharding=tree, checkpoint_dir=d_to_port), toks,
        f["p0"])
    for r2 in cont:
        assert r2["resumed_from"] == 2
        np.testing.assert_allclose(r2["losses"][-2:], jr2.losses[-2:],
                                   rtol=LOSS_RTOL)
        _close(r2["params"], _np_tree(jt2.params), "jax <-> tp x fsdp",
               atol=PARAM_ATOL, rtol=0)
    # the saved optimizer state is whole: adam's moments of qkv_kernel
    assert any(np.shape(v) == (32, 96) for _p, v in
               sorted_leaves(tstate["opt_state"]))


def test_launched_tp_fsdp_fit_predicts_as_jax(tpf_fits):
    """(h) A launched fit (the caller spawns the 4 ranks) with the tree in
    ``ShardingConfig.param_axes`` lands on the in-place fit's bits, and
    ``predict_fn(mesh=)`` after it gives JAX's predictions after its
    explicit fit."""
    f = tpf_fits
    tr = Trainer(f["spec"], "input_ids", None, mesh=TPF, device="cpu",
                 sharding=ShardingConfig(param_axes=f["tree"]), **f["kw"])
    res = tr.fit(f["toks"], init_params=f["p0"])
    assert tr.last_mesh_stats["launched"]
    assert tr.last_mesh_stats["placement"]["compute_axes"] == ["tp"]
    assert res.losses == f["ours"][0]["losses"]
    _same({ln: {k: v.numpy() for k, v in d.items()}
           for ln, d in res.params.items()}, f["ours"][0]["params"])
    x = _tokens(5, 11)
    got = tr.predict_fn("logits", mesh=TPF)(tr.params, x).numpy()
    want = np.asarray(f["jt"].predict_fn("logits", mesh=_jmesh(TPF))(
        f["jt"].params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_tp_fsdp_tree_streams_and_clips_as_jax(pool4):
    """(b) ``fit_stream`` and (f) ``clip_norm`` on the tp x fsdp tree: the
    global norm counts each leaf's blocks over the axes its spec names
    (0.05 clips every step here). ``embed.tok`` is kept at rest over
    ``("tp", "fsdp")``, a split the Megatron forward gathers whole: its
    gradient reduce-scatters over fsdp and is sliced over tp."""
    spec, p0 = _case(seed=5)
    tree = tp_fsdp_tree(spec)
    tree["embed"]["tok"] = P(None, ("tp", "fsdp"))
    toks = _tokens(12, 10)
    kw = _fit_kw(iters=1, optimizer_options={"epsilon": 1e-4,
                                             "clip_norm": 0.05})
    jt, jr = _jax_fit(spec, TPF, tree, kw, toks, p0, stream=True)
    ours = _port_fit(pool4, spec, TPF, dict(kw, param_sharding=tree), toks,
                     p0, stream=True)
    assert len(jr.losses) == 3
    _against_jax(ours, jr, jt, "stream + clip")


@pytest.mark.parametrize("case", ["plain-forward", "dp-at-rest"])
def test_trees_at_rest_fit_as_jax(pool2, case):
    """(c) A tree the Megatron forward cannot take: the plain forward on
    both tp ranks, every tp split gathered just in time and its gradient
    sliced, not summed, over tp. (d) ``embed.tok`` at rest over ``dp``
    on a dp mesh: its gradient reduce-scatters over dp and is summed once."""
    spec, p0 = _case(seed=6)
    if case == "plain-forward":
        axes, tree = {"tp": 2}, plain_tree(spec)
    else:
        axes = {"dp": 2}
        tree = _rules(spec, lambda ln, k, s: P("dp", None)
                      if (ln, k) == ("embed", "tok") else P())
    toks = _tokens(8, 3)
    kw = _fit_kw()
    jt, jr = _jax_fit(spec, axes, tree, kw, toks, p0)
    ours = _port_fit(pool2, spec, axes, dict(kw, param_sharding=tree), toks,
                     p0)
    _against_jax(ours, jr, jt, case)
    assert ours[0]["stats"]["placement"]["compute_axes"] == []


def test_all_replicated_tree_equals_no_sharding(pool2):
    """(e) An all-replicated tree on dp=2 trains to JAX's fit with the
    same tree, and to the bits of ``param_sharding=None`` with the
    replicated update (an explicit tree declines ZeRO, as in JAX)."""
    spec, p0 = _case(seed=7)
    tree = _rules(spec, lambda _ln, _k, _s: P())
    toks = _tokens(8, 5)
    kw = _fit_kw()
    none = _port_fit(pool2, spec, {"dp": 2}, dict(
        kw, param_sharding=None, weight_update_sharding="off"), toks, p0)
    mine = _port_fit(pool2, spec, {"dp": 2}, dict(
        kw, sharding={"param_axes": tree}), toks, p0)
    jt, jr = _jax_fit(spec, {"dp": 2}, tree, kw, toks, p0)
    _against_jax(mine, jr, jt, "all replicated")
    for a, b in zip(none, mine):
        assert a["losses"] == b["losses"]
        _same(a["params"], b["params"], "replicated")
        assert b["stats"]["zero_stage"] == 0


# -- refusals -----------------------------------------------------------------


def _refusals(spec):
    tree = tp_fsdp_tree(spec)
    odd = _rules(spec, lambda ln, k, s: P("fsdp", None)
                 if (ln, k) == ("embed", "tok") else s)
    return [
        ("param_sharding='bogus'", {"tp": 2}, {"param_sharding": "bogus"},
         "param_sharding must be 'auto', None, or a PartitionSpec pytree; "
         "got 'bogus'"),
        ("param_axes='bogus'", {"tp": 2},
         {"sharding": ("param_axes", "bogus")},
         "ShardingConfig.param_axes must be 'auto', None, or a "
         "PartitionSpec pytree; got 'bogus'"),
        ("pp mesh", {"dp": 1, "pp": 2}, {"param_sharding": tree},
         "explicit param_sharding pytrees do not apply to pp/sp strategy "
         "meshes"),
        ("sp mesh", {"dp": 1, "sp": 2}, {"param_sharding": tree},
         "explicit param_sharding pytrees do not apply to pp/sp strategy "
         "meshes"),
        ("zero stage", {"dp": 2}, {"sharding": ("zero_stage", 1),
                                   "param_sharding": tree},
         "sharding.zero_stage=1 needs a pure-dp fit with replicated params"),
        ("uneven", {"fsdp": 2}, {"param_sharding": odd},
         "should be divisible by 2, but it is equal to 61"),
    ]


@pytest.mark.parametrize("i", range(6), ids=[
    "param_sharding-string", "param_axes-string", "pp", "sp", "zero-stage",
    "uneven"])
def test_refusals_match_jax(i):
    """(i) Each refusal, before any rank starts, with JAX's message."""
    spec, _ = _case(("transformer_lm", dict(LM, vocab_size=61)))
    _what, axes, opts, match = _refusals(spec)[i]
    toks = np.random.default_rng(0).integers(0, 61, (8, S)).astype(
        np.float32)

    def build(cls, cfg_cls, to_p):
        kw = {}
        for k, v in opts.items():
            if k == "sharding":
                kw[k] = cfg_cls(**{v[0]: v[1]})
            elif isinstance(v, dict):
                kw[k] = to_p(v)
            else:
                kw[k] = v
        mesh = _jmesh(axes) if cls is JaxTrainer else axes
        extra = {} if cls is JaxTrainer else {"device": "cpu"}
        return cls(spec, "input_ids", None, mesh=mesh, **_fit_kw(iters=1),
                   **kw, **extra)

    with pytest.raises(ValueError, match=match):
        build(JaxTrainer, JaxShardingConfig, _as_jax).fit(toks)
    with pytest.raises(ValueError, match=match):
        build(Trainer, ShardingConfig, lambda t: t).fit(toks)


def test_a_tree_of_another_structure_is_refused_naming_the_leaf():
    """(i) JAX's ``tree.map`` refuses a tree whose structure differs from
    the params; the port names the first leaf at fault."""
    spec, _ = _case()
    toks = _tokens(8, 0)
    bad = _rules(spec)
    del bad["block_1"]["fc1_kernel"]
    with pytest.raises(ValueError):
        JaxTrainer(spec, "input_ids", None, mesh=_jmesh({"tp": 2}),
                   param_sharding=_as_jax(bad), **_fit_kw(iters=1)).fit(toks)
    with pytest.raises(ValueError, match="at block_1/fc1_kernel: the params "
                                         "have it, the tree lacks it"):
        Trainer(spec, "input_ids", None, mesh={"tp": 2}, device="cpu",
                param_sharding=bad, **_fit_kw(iters=1)).fit(toks)
    extra = _rules(spec)
    extra["head"] = {"kernel": P()}
    with pytest.raises(ValueError, match="at head: the tree has it"):
        Trainer(spec, "input_ids", None, mesh={"tp": 2}, device="cpu",
                param_sharding=extra, **_fit_kw(iters=1)).fit(toks)
