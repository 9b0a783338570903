"""PyTorch port, its public surface against the JAX package's.

Read from the source trees with ``ast`` alone: neither package is imported,
so the whole file runs in about a second. For every module of
``sparkflow_tpu/`` and each of its public names — a top-level def, class or
assignment, or a public method of a class — the port must have the same
name at the mirrored path of ``sparkflow_tpu_torch/`` (a re-export counts,
and a method may come from a base class the port module defines or
imports), or a row in :data:`DEVIATIONS` that names the port's counterpart
and says why. Every parameter name of a function that has a counterpart
must be a parameter of it too, or have its row.

A row is checked both ways: what it names must exist in the JAX package
and be missing from the port (a row for a name the port now has fails, so
the table stays true), its counterpart must resolve in the port, and its
reason must be given. Together the table and this file are the
definition of "the port covers the JAX package".

Row keys: ``"path"`` (a module), ``"path:Name"`` or ``"path:Class.method"``
(a name), ``"path:func(param)"`` (a parameter). A counterpart starts with
a port reference of the same form (``path``, ``path:Name`` or
``path:func(param)``), then free text.
"""

import ast
import functools
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "sparkflow_tpu")
PORT_ROOT = os.path.join(REPO, "sparkflow_tpu_torch")

_GEN = "torch cannot reproduce jax.random streams: a torch.Generator "
_RAW = ("the unjitted body, for nesting inside another shard_map or jit; "
        "the port's step is already that body, a plain Python function")
_SHARD = ("a JAX NamedSharding placement for one jitted GSPMD program; a "
          "port rank holds plain local tensors, so the port's parallel "
          "builders take the rank's step as step_fn and its rows as rows")
_INTERPRET = ("Pallas interpret mode; a CUDA kernel has none, so a CPU "
              "tensor runs the kernel's plain PyTorch version and a CUDA "
              "tensor launches the kernel")
_BLOCKS = ("the TPU kernel's tile sizes; the CUDA kernels pick their tiles "
           "from head_dim and dtype (ops/csrc/flash_fwd.cu, flash_bwd.cu)")

DEVIATIONS = {
    # -- modules
    "analysis/jaxpr_lint.py": (
        "analysis/fx_lint.py",
        "the jaxpr lint reads JAX programs; the port lints torch fx "
        "traces of the same steps for the same rules (GC-J103, J106, J108)"),
    "jax_compat.py": (
        "device.py",
        "shims over JAX API versions; the port needs none, and device.py "
        "holds its device and dtype resolution"),
    "utils/hw.py": (
        "device.py:resolve_device",
        "TPU probing and the CPU fallback of a wedged relay; the port runs "
        "on the card unless asked for the CPU and never falls back"),
    # -- names
    "ops/attention.py:force_xla_attention": (
        "ops/attention.py:flash_attention",
        "sends flash_attention to XLA's blockwise path; the port's wrappers "
        "never fall back: a CUDA tensor launches the kernel"),
    "ops/attention.py:sharded_attention": (
        "parallel/tp.py:TPShards",
        "nests the Pallas kernel in a shard_map under GSPMD; a port tp "
        "shard holds its own heads and launches the kernel on them"),
    "ops/attention.py:unsharded_attention": (
        "ops/attention.py:flash_attention",
        "switches sharded_attention off inside pp / sp shard_maps; the "
        "port has no enclosing context to switch off"),
    "optimizers_sharded.py:zero3_param_shardings": (
        "optimizers_sharded.py:zero3_param_specs",
        "returns NamedShardings; the port returns the specs, and a rank "
        "holds its own row of the flat layout"),
    "optimizers_sharded.py:gathered_param_view": (
        "optimizers_sharded.py:gathered_params",
        "a sharding-constraint view of ZeRO-3 params inside a jit; the "
        "port gathers the rows with a collective whose backward "
        "reduce-scatters"),
    "optimizers_sharded.py:zero1_state_shardings": (
        "optimizers_sharded.py:zero1_state_specs",
        "returns NamedShardings; the port returns the specs and places "
        "the state with place_zero1_state"),
    "parallel/distributed.py:host_shard_to_global": (
        "parallel/distributed.py:local_rows",
        "assembles a global jax.Array from per-host shards; a "
        "torch.distributed rank keeps its own rows, there is no global "
        "array"),
    "sharding.py:ShardingConfig.data_sharding": (
        "sharding.py:ShardingConfig.data_spec",
        "returns a JAX NamedSharding of the batch rows; the port's ranks "
        "take their rows by the spec"),
    "sharding.py:ShardingConfig.replicated": (
        "sharding.py:P",
        "returns a replicated JAX NamedSharding; in the port P() is a "
        "replicated leaf"),
    "utils/flops.py:jit_flops": (
        "utils/flops.py:train_step_flops",
        "XLA's cost analysis of a compiled program; PyTorch runs eagerly, "
        "so the port counts a step's FLOPs from the model's shapes"),
    # -- parameters: the core builders
    "core.py:make_train_step(mesh)": (
        "parallel/dp.py:make_dp_train_step", _SHARD),
    "core.py:make_train_step(sharding)": (
        "parallel/dp.py:make_dp_train_step(sharding)", _SHARD),
    "core.py:make_train_step(infer_params)": (
        "parallel/tp.py:derive_param_pspecs",
        "lets XLA infer parameter shardings from placed inputs; a port "
        "rank's placement is explicit"),
    "core.py:make_epoch_fn(mesh)": ("core.py:make_epoch_fn(step_fn)", _SHARD),
    "core.py:make_epoch_fn(sharding)": ("core.py:make_epoch_fn(rows)", _SHARD),
    "core.py:make_epoch_fn(opt_shardings)": (
        "core.py:make_epoch_fn(step_fn)", _SHARD),
    "core.py:make_epoch_fn(param_shardings)": (
        "core.py:make_epoch_fn(step_fn)", _SHARD),
    "core.py:make_epoch_fn(infer_params)": (
        "parallel/tp.py:derive_param_pspecs",
        "lets XLA infer parameter shardings from placed inputs; a port "
        "rank's placement is explicit"),
    "core.py:make_epoch_fn(_raw)": ("core.py:make_multi_epoch_fn", _RAW),
    "core.py:make_epoch_fn(_unroll_budget)": (
        "core.py:make_epoch_fn",
        "unrolls the epoch's lax.scan on XLA:CPU; the port's epoch is a "
        "Python loop"),
    "core.py:make_multi_epoch_fn(mesh)": (
        "core.py:make_multi_epoch_fn(step_fn)", _SHARD),
    "core.py:make_multi_epoch_fn(sharding)": (
        "core.py:make_multi_epoch_fn(step_fn)", _SHARD),
    "core.py:make_multi_epoch_fn(opt_shardings)": (
        "core.py:make_multi_epoch_fn(step_fn)", _SHARD),
    "core.py:make_multi_epoch_fn(param_shardings)": (
        "core.py:make_multi_epoch_fn(step_fn)", _SHARD),
    "core.py:make_multi_epoch_fn(infer_params)": (
        "parallel/tp.py:derive_param_pspecs",
        "lets XLA infer parameter shardings from placed inputs; a port "
        "rank's placement is explicit"),
    "core.py:make_predict_fn(infer_params)": (
        "core.py:make_predict_fn(mesh)",
        "lets XLA infer parameter shardings; the port places a copy per dp "
        "shard itself"),
    # -- parameters: random streams
    "graphdef.py:GraphModel.init(rng)": (
        "graphdef.py:GraphModel.init(generator)", _GEN + "or a seed"),
    "graphdef.py:GraphModel.apply(rng)": (
        "graphdef.py:GraphModel.apply(generator)", _GEN + "feeds dropout"),
    "graphdef.py:GraphModel.loss_vector(rng)": (
        "graphdef.py:GraphModel.loss_vector(generator)",
        _GEN + "feeds dropout"),
    "models/base.py:RegistryModel.init(rng)": (
        "models/base.py:RegistryModel.init(generator)", _GEN + "or a seed"),
    "models/base.py:RegistryModel.apply(rng)": (
        "models/base.py:RegistryModel.apply(generator)",
        _GEN + "feeds dropout"),
    "models/base.py:RegistryModel.loss_vector(rng)": (
        "models/base.py:RegistryModel.loss_vector(generator)",
        _GEN + "feeds dropout"),
    "tf1_compat.py:TF1GraphModel.init(rng)": (
        "tf1_compat.py:TF1GraphModel.init(seed)",
        _GEN + "seeded from seed runs the graph's initializer subgraphs"),
    "tf1_compat.py:TF1GraphModel.apply(rng)": (
        "tf1_compat.py:TF1GraphModel.apply(generator)",
        _GEN + "feeds the graph's random ops"),
    "tf1_compat.py:TF1GraphModel.loss_vector(rng)": (
        "tf1_compat.py:TF1GraphModel.loss_vector(generator)",
        _GEN + "feeds the graph's random ops"),
    # -- parameters: kernels
    "ops/attention.py:flash_attention(block_q)": (
        "ops/attention.py:flash_attention", _BLOCKS),
    "ops/attention.py:flash_attention(block_k)": (
        "ops/attention.py:flash_attention", _BLOCKS),
    "ops/attention.py:flash_attention(interpret)": (
        "ops/attention.py:flash_attention(q)", _INTERPRET),
    "ops/attention.py:paged_attention(interpret)": (
        "ops/attention.py:paged_attention(q)", _INTERPRET),
    "ops/attention.py:paged_attention_verify(interpret)": (
        "ops/attention.py:paged_attention_verify(q)", _INTERPRET),
    "ops/attention.py:ring_flash_attention(block_q)": (
        "ops/attention.py:ring_flash_attention", _BLOCKS),
    "ops/attention.py:ring_flash_attention(block_k)": (
        "ops/attention.py:ring_flash_attention", _BLOCKS),
    "ops/attention.py:ring_flash_attention(interpret)": (
        "ops/attention.py:ring_flash_attention(q)", _INTERPRET),
    # -- parameters: the parallel builders
    "parallel/dp.py:make_dp_train_step(_raw)": (
        "parallel/dp.py:make_dp_train_step", _RAW),
    "parallel/dp.py:make_dp_zero1_train_step(_raw)": (
        "parallel/dp.py:make_dp_zero1_train_step", _RAW),
    "parallel/pp.py:make_pp_train_step(_raw)": (
        "parallel/pp.py:make_pp_train_step", _RAW),
    "parallel/sp.py:make_sp_train_step(_raw)": (
        "parallel/sp.py:make_sp_train_step", _RAW),
    # -- parameters: tooling
    "obs/spans.py:Tracer.span(jax_annotation)": (
        "obs/spans.py:Tracer.span(profiler_annotation)",
        "the span is mirrored into torch.profiler's record_function, not "
        "jax.profiler's TraceAnnotation"),
    "obs/spans.py:span(jax_annotation)": (
        "obs/spans.py:span(profiler_annotation)",
        "the span is mirrored into torch.profiler's record_function, not "
        "jax.profiler's TraceAnnotation"),
    "serving/coldstart.py:ExecutableStore.save(compiled)": (
        "serving/coldstart.py:ExecutableStore.save(library)",
        "the store keeps the built kernel library, not a serialized XLA "
        "executable"),
    "utils/tracing.py:trace(create_perfetto_link)": (
        "utils/tracing.py:trace(log_dir)",
        "jax.profiler serves a trace to Perfetto over HTTP; the port writes "
        "a Chrome-trace JSON into log_dir to open there"),
}

# the names the port gained last; a row for any of them would be stale
PORTED_LAST = ("core.py:make_multi_epoch_fn",
               "graphdef.py:GraphModel.quantize_for_serving",
               "models/base.py:RegistryModel.quantize_for_serving",
               "optimizers.py:ProximalAdagradState",
               "optimizers.py:OPTIMIZER_BUILDERS",
               "parallel/tp.py:make_sharded_train_step")

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _modules(root):
    out = []
    for d, dirs, files in os.walk(root):
        dirs[:] = sorted(x for x in dirs
                         if x != "__pycache__" and not x.startswith("_"))
        out += [os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
                for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


_TREES = {}


def _tree(root, rel):
    key = (root, rel)
    if key not in _TREES:
        with open(os.path.join(root, rel)) as f:
            _TREES[key] = ast.parse(f.read())
    return _TREES[key]


def _top(body):
    """Top-level statements, those under a module-level ``if`` / ``try``
    included."""
    for n in body:
        if isinstance(n, ast.If):
            yield from _top(n.body + n.orelse)
        elif isinstance(n, ast.Try):
            yield from _top(n.body + n.orelse + n.finalbody
                            + [s for h in n.handlers for s in h.body])
        else:
            yield n


def _targets(n):
    if isinstance(n, ast.Assign):
        return [t.id for t in n.targets if isinstance(t, ast.Name)]
    if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
        return [n.target.id]
    return []


@functools.lru_cache(maxsize=None)
def _defs(rel, root):
    """``{name: node}`` of a module's top-level defs, classes and
    assignments, and ``{name: (module, name)}`` of what it imports from
    its own package."""
    defs, imports = {}, {}
    for n in _top(_tree(root, rel).body):
        if isinstance(n, _FUNCS + (ast.ClassDef,)):
            defs[n.name] = n
        for t in _targets(n):
            defs[t] = n
        if isinstance(n, ast.ImportFrom) and n.level:
            base = os.path.dirname(rel).split("/") if "/" in rel else []
            base = base[:len(base) - (n.level - 1)] if n.level > 1 else base
            path = "/".join(base + (n.module or "").split(".")).strip("/")
            if not os.path.exists(os.path.join(root, path + ".py")):
                path += "/__init__"
            for a in n.names:
                if n.module is not None:  # not `from . import module`
                    imports[a.asname or a.name] = (path + ".py", a.name)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            for a in n.names:
                imports.setdefault((a.asname or a.name).split(".")[0], None)
    return defs, imports


def _public(name):
    return not any(p.startswith("_") for p in name.split("."))


def jax_public(rel):
    """``{name: node}``: the JAX module's public top-level names and the
    public methods of its classes (``Class.method``)."""
    defs, imports = _defs(rel, JAX_ROOT)
    out = {}
    for name, node in defs.items():
        if name in imports:  # an import's fallback (`except: x = None`)
            continue
        out[name] = node
        if isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, _FUNCS):
                    out[f"{name}.{m.name}"] = m
    return {k: v for k, v in out.items() if _public(k)}


def _port_class(rel, name, seen=()):
    """The members ``{name: node}`` of a port class, its bases' within the
    package included."""
    if (rel, name) in seen or not os.path.exists(os.path.join(PORT_ROOT,
                                                              rel)):
        return {}
    defs, imports = _defs(rel, PORT_ROOT)
    node = defs.get(name)
    if not isinstance(node, ast.ClassDef):
        src = imports.get(name)
        return _port_class(*src, seen + ((rel, name),)) if src else {}
    members = {}
    for b in node.bases:
        if isinstance(b, ast.Name):
            where = ((rel, b.id) if b.id in defs else imports.get(b.id))
            if where:
                members.update(_port_class(*where, seen + ((rel, name),)))
    for m in node.body:
        if isinstance(m, _FUNCS):
            members[m.name] = m
        for t in _targets(m):
            members[t] = m
    return members


def port_lookup(rel, name):
    """The port's node for ``name`` (``Class.method`` allowed) in module
    ``rel``: a def or class node, True for a re-export or assignment, None
    when the port lacks it."""
    if not os.path.exists(os.path.join(PORT_ROOT, rel)):
        return None
    defs, imports = _defs(rel, PORT_ROOT)
    if "." in name:
        cls, meth = name.split(".", 1)
        node = _port_class(rel, cls).get(meth)
        return node if isinstance(node, _FUNCS) else (node and True)
    if name in defs:
        node = defs[name]
        return node if isinstance(node, _FUNCS + (ast.ClassDef,)) else True
    if name in imports:
        src = imports[name]
        if src and os.path.exists(os.path.join(PORT_ROOT, src[0])):
            found = port_lookup(*src)
            return found if found is not None else True
        return True
    return None


def params_of(node):
    a = node.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return names


_KEY = re.compile(r"^(?P<path>[\w/]+\.py)(?::(?P<name>[\w.]+)"
                  r"(?:\((?P<param>\w+)\))?)?")


def _parse(key):
    m = _KEY.match(key)
    assert m, f"unreadable reference {key!r}"
    return m.group("path"), m.group("name"), m.group("param")


def _missing():
    """Every module, name and parameter of the JAX package that the port
    lacks, as row keys."""
    out = []
    for rel in _modules(JAX_ROOT):
        if not os.path.exists(os.path.join(PORT_ROOT, rel)):
            out.append(rel)
            continue
        for name, node in jax_public(rel).items():
            found = port_lookup(rel, name)
            if found is None:
                out.append(f"{rel}:{name}")
            elif isinstance(node, _FUNCS) and isinstance(found, _FUNCS):
                have = set(params_of(found))
                out += [f"{rel}:{name}({p})" for p in params_of(node)
                        if p not in have]
    return out


JAX_MODULES = _modules(JAX_ROOT)


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_and_parameter_has_a_counterpart(rel):
    """A JAX module's names and parameters are in the port, or each has its
    row."""
    gaps = [k for k in _missing_by_module().get(rel, []) if k not in DEVIATIONS]
    assert not gaps, (f"{len(gaps)} public name(s) or parameter(s) of "
                      f"sparkflow_tpu/{rel} have no counterpart in the port "
                      f"and no DEVIATIONS row: {gaps}")


_BY_MODULE = {}


def _missing_by_module():
    if not _BY_MODULE:
        for key in _missing():
            _BY_MODULE.setdefault(_parse(key)[0], []).append(key)
        _BY_MODULE.setdefault("", [])
    return _BY_MODULE


@pytest.mark.parametrize("key", sorted(DEVIATIONS))
def test_each_row_names_a_live_gap_and_a_real_counterpart(key):
    """The row names something the JAX package has and the port lacks;
    its counterpart resolves in the port; its reason is given."""
    counterpart, reason = DEVIATIONS[key]
    assert reason.strip() and counterpart.strip(), key
    path, name, param = _parse(key)
    assert os.path.exists(os.path.join(JAX_ROOT, path)), key
    if name is not None:
        node = jax_public(path).get(name)
        assert node is not None, f"{key}: the JAX package has no {name}"
        if param is not None:
            assert param in params_of(node), f"{key}: JAX has no {param}"
    assert key in _missing_by_module().get(path, []), (
        f"stale row {key!r}: the port has it now; delete the row")

    cpath, cname, cparam = _parse(counterpart)
    assert os.path.exists(os.path.join(PORT_ROOT, cpath)), counterpart
    if cname is not None:
        found = port_lookup(cpath, cname)
        assert found is not None, f"{key}: counterpart {counterpart!r}"
        if cparam is not None:
            assert isinstance(found, _FUNCS) and cparam in params_of(found), (
                f"{key}: counterpart {counterpart!r}")


@pytest.mark.parametrize("key", PORTED_LAST)
def test_the_names_ported_last_are_in_the_port_not_the_table(key):
    path, name, _ = _parse(key)
    assert key not in DEVIATIONS
    assert name in jax_public(path)
    assert port_lookup(path, name) is not None


def test_the_walk_sees_classes_bases_and_reexports():
    """The resolver the checks rest on: an inherited method, a re-export
    and a method the port lacks."""
    assert isinstance(port_lookup("models/transformer.py",
                                  "TransformerLM.prefill_embed"), _FUNCS)
    assert port_lookup("parallel/hyper.py", "OPTIMIZER_BUILDERS") is not None
    assert port_lookup("sharding.py", "ShardingConfig.replicated") is None
    assert "core.py:make_epoch_fn(_raw)" in _missing()
    assert len(JAX_MODULES) > 80
