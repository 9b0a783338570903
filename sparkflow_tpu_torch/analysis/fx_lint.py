"""Graph-level lint (GC-J1xx) on torch traces — the counterpart of the JAX
package's ``jaxpr_lint``.

A function is traced with :func:`torch.fx.experimental.proxy_tensor.make_fx`
in ``"fake"`` mode on the CPU: its inputs (and the tensors it closes over,
an engine's weights and pools) become fake tensors, so no FLOP runs, no
buffer is written, and the aten graph that comes back carries every op's
output dtype and shape. The kernel wrappers take their plain path, because
the tensors are CPU tensors. A training step is traced through
``torch.autograd.grad``, so the graph holds the backward and the update.

Rules
-----
GC-J103  f64-promotion      a program whose float inputs are float32 or
                            bf16 yields a float64 tensor somewhere in its
                            aten graph: a numpy double (an array
                            ``torch.as_tensor`` turned into a float64
                            tensor, a ``.double()``) is on the hot path, at
                            half speed or worse on the card and double the
                            memory.
GC-J106  sharding-config-   the collectives a dp train step actually issued
         mismatch           (:func:`~sparkflow_tpu_torch.parallel.
                            collectives.stats` over one step on every rank)
                            contradict its declared ``ShardingConfig``: a
                            ``zero_stage >= 1`` step that never reduce-
                            scatters is all-reducing the full gradient (the
                            sharded update silently degraded), and a
                            ``zero_stage = 0`` step that reduce-scatters is
                            mislabelled. The port's collectives are eager
                            ``torch.distributed`` calls outside any graph,
                            so the rule reads the ones that ran
                            (:func:`lint_dp_train_step`,
                            :func:`lint_sharding_config`).
GC-J108  full-pool-dequant  a dtype conversion (``aten._to_copy``) whose
                            operand is the WHOLE quantized KV page pool
                            (int8/fp8 operand, a float of two bytes or more
                            out, rank >= 4 with the pool's ``num_pages`` in
                            its shape): the dequantization must run on the
                            gathered pages, never the pool, or the engine
                            holds a full-precision copy of the cache for a
                            moment — it scales with the pool, not the batch.
                            Checked in :func:`lint_decode_step` on a
                            quantized engine and by :func:`lint_fn` when
                            given ``kv_pool_pages``.

The JAX rules with no counterpart, and why:

GC-J101  implicit-reshard   needs GSPMD: a sharding constraint inside a
                            program that disagrees with its input's
                            declared spec makes the compiler insert a
                            collective. The port places every shard
                            explicitly (``parallel.tp.ParamPlacement``,
                            the ZeRO row layouts) and runs each collective
                            by name, so nothing reshards behind its back.
GC-J102  large-replicated   needs declared input ``PartitionSpec`` s. A
                            port rank holds what its placement gives it —
                            whole trees at zero stage 0 by design, 1/dp rows
                            at stages 1-3 — and the bytes it holds are
                            measured, not declared
                            (``Trainer.last_mesh_stats``).
GC-J104  weak-type-output   torch has no weak types: a Python scalar never
                            decides a tensor's dtype (type promotion keeps
                            the tensor's), so no output can be weakly typed.
GC-J105  missed-donation    needs buffers held across an executable
                            boundary. The port updates parameters in place
                            (``optimizers.apply_updates``) and drops the old
                            optimizer state with its last reference, so an
                            input's memory is reused without a donation to
                            miss.
GC-J107  collective-        needs collectives inside traced control flow.
         divergence         A fake-tensor trace cannot branch on data at
                            all (make_fx raises on a data-dependent Python
                            branch), and the port's collectives are eager
                            calls between the device ops, each ending with
                            an error after ``SPARKFLOW_TORCH_MESH_TIMEOUT_S``
                            instead of hanging.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch

from .findings import Finding

__all__ = ["trace", "lint_fn", "lint_train_step", "lint_apply",
           "lint_decode_step", "lint_sharding_config", "lint_dp_train_step",
           "repo_self_check"]

#: a dtype conversion as it appears in a make_fx aten graph
_CONVERT = "aten._to_copy.default"

#: storage dtypes a quantized KV pool can hold (GC-J108 operand gate)
_QUANT_POOL_DTYPES = ("int8", "float8")

_F64 = (torch.float64, torch.complex128)

#: a captured constant materialised in the graph: a float64 numpy array
#: given another dtype (``torch.as_tensor(a, dtype=torch.float32)``) shows
#: as its float64 constant and a conversion, and only the ops that compute
#: on float64 matter
_CONSTANT = "aten.lift_fresh_copy.default"


def trace(fn: Callable, args: Sequence) -> torch.fx.GraphModule:
    """``fn(*args)`` traced to an aten graph over fake tensors (the
    tensors ``fn`` closes over are faked too; none is written)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    with torch.inference_mode(False):
        return make_fx(fn, tracing_mode="fake",
                       _allow_non_fake_inputs=True)(*args)


def _vals(node) -> Iterable[torch.Tensor]:
    v = node.meta.get("val")
    for t in (v if isinstance(v, (tuple, list)) else (v,)):
        if isinstance(t, torch.Tensor):
            yield t


def _leaves(tree) -> List[Any]:
    from torch.utils import _pytree as pytree
    return pytree.tree_leaves(tree)


def _short(t: torch.Tensor) -> str:
    return f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"


def _f64_findings(gm, label: str) -> List[Finding]:
    hits = []
    for node in gm.graph.nodes:
        if node.op != "call_function" or str(node.target) == _CONSTANT:
            continue
        for t in _vals(node):
            if t.dtype in _F64:
                hits.append(f"{node.target} -> {_short(t)}")
                break
    if not hits:
        return []
    shown = "; ".join(hits[:3])
    more = f" (+{len(hits) - 3} more)" if len(hits) > 3 else ""
    return [Finding(
        "GC-J103",
        f"{label}: float32/bf16 inputs produce float64 in the aten graph "
        f"— a numpy double is on the hot path: {shown}{more}. Give the "
        f"array a float32 dtype before it becomes a tensor",
        source="fx_lint", detail={"count": len(hits)})]


def _full_pool_dequant_findings(gm, label: str,
                                kv_pool_pages: int) -> List[Finding]:
    findings = []
    for node in gm.graph.nodes:
        if node.op != "call_function" or str(node.target) != _CONVERT:
            continue
        src = node.args[0] if node.args else None
        ins = list(_vals(src)) if isinstance(src, torch.fx.Node) else []
        outs = list(_vals(node))
        if not ins or not outs:
            continue
        a, out = ins[0], outs[0]
        name = str(a.dtype).replace("torch.", "")
        if not name.startswith(_QUANT_POOL_DTYPES):
            continue
        if not (out.dtype.is_floating_point and out.element_size() >= 2):
            continue
        shape = tuple(a.shape)
        if len(shape) < 4 or kv_pool_pages not in shape:
            continue
        new = str(out.dtype).replace("torch.", "")
        findings.append(Finding(
            "GC-J108",
            f"{label}: {node.target}({name} -> {new}) over a {shape} "
            f"operand — the whole quantized KV pool "
            f"(num_pages={kv_pool_pages}) is being dequantized before the "
            f"page gather. This materializes a full-precision transient "
            f"copy of the entire cache (scales with pool size, not batch), "
            f"forfeiting the memory quantization bought; gather the pages "
            f"first and dequantize the gathered rows",
            source="fx_lint",
            detail={"operand_shape": list(shape), "operand_dtype": name,
                    "new_dtype": new, "kv_pool_pages": kv_pool_pages}))
    return findings


def lint_fn(fn: Callable, args: Sequence, *, name: Optional[str] = None,
            kv_pool_pages: Optional[int] = None,
            ignore: Sequence[str] = ()) -> List[Finding]:
    """Lint one function over ``args`` (pytrees of tensors; traced over
    fake tensors, never run). GC-J103 unless an input is already 64-bit;
    GC-J108 when ``kv_pool_pages`` (the pool's page count) is given."""
    ignore = set(ignore)
    label = name or getattr(fn, "__name__", "fn")
    gm = trace(fn, args)
    findings: List[Finding] = []
    input_f64 = any(isinstance(t, torch.Tensor) and t.dtype in _F64
                    for t in _leaves(list(args)))
    if "GC-J103" not in ignore and not input_f64:
        findings.extend(_f64_findings(gm, label))
    if kv_pool_pages is not None and "GC-J108" not in ignore:
        findings.extend(_full_pool_dequant_findings(gm, label,
                                                    int(kv_pool_pages)))
    return findings


def _model_inputs(model, names: Sequence[str], batch: int):
    specs = model.input_specs()
    out = []
    for n in names:
        key = n.split(":")[0]
        if key not in specs:
            raise KeyError(f"{key!r} is not a model input; inputs: "
                           f"{sorted(specs)}")
        shape, dtype = specs[key]
        shape = tuple(batch if d is None else int(d) for d in shape)
        out.append(torch.zeros(shape, dtype=getattr(torch, str(dtype))))
    return out


def _params(model):
    init = model.init(torch.Generator().manual_seed(0))
    return {k: {n: t.detach().requires_grad_(t.is_floating_point())
                for n, t in layer.items()} for k, layer in init.items()}


def lint_train_step(model, input_name, label_name=None, optimizer="adam",
                    *, batch: int = 8, ignore: Sequence[str] = (),
                    name: Optional[str] = None) -> List[Finding]:
    """Lint one optimizer step of ``model`` as the trainer builds it
    (:func:`sparkflow_tpu_torch.core.make_train_step`'s body): masked
    loss, its gradient, the optimizer update and the in-place apply.
    ``optimizer`` is a registry name or a ``GradientTransformation``."""
    from ..core import _step_body, make_loss_fn
    from ..optimizers import build_optimizer

    if isinstance(optimizer, str):
        opt_label, optimizer = optimizer, build_optimizer(optimizer, 0.01)
    else:
        opt_label = type(optimizer).__name__
    step = _step_body(make_loss_fn(model, input_name, label_name), optimizer)
    multi = isinstance(input_name, (list, tuple))
    xs = _model_inputs(model, list(input_name) if multi else [input_name],
                       batch)
    x = tuple(xs) if multi else xs[0]
    y = (_model_inputs(model, [label_name], batch)[0]
         if label_name is not None else torch.zeros(batch, 1))
    params = _params(model)
    opt_state = optimizer.init(params)

    def train_step(params, opt_state, x, y, mask):
        return step(params, opt_state, x, y, mask)

    return lint_fn(
        train_step, (params, opt_state, x, y, torch.ones(batch)),
        name=name or f"train_step[{type(model).__name__}/{opt_label}]",
        ignore=ignore)


def lint_apply(model, input_name, output_name, *, batch: int = 8,
               ignore: Sequence[str] = (),
               name: Optional[str] = None) -> List[Finding]:
    """Lint the inference path: ``apply(params, x) -> output_name``."""
    multi = isinstance(input_name, (list, tuple))
    names = list(input_name) if multi else [input_name]
    in_keys = [n.split(":")[0] for n in names]

    def predict(params, x):
        feeds = dict(zip(in_keys, tuple(x) if multi else (x,)))
        with torch.no_grad():
            return model.apply(params, feeds, [output_name],
                               train=False)[output_name]

    xs = _model_inputs(model, names, batch)
    params = {k: {n: t.detach() for n, t in layer.items()}
              for k, layer in _params(model).items()}
    return lint_fn(predict, (params, tuple(xs) if multi else xs[0]),
                   name=name or f"apply[{type(model).__name__}"
                                f"/{output_name}]",
                   ignore=ignore)


def lint_decode_step(engine, *, name: Optional[str] = None,
                     ignore: Sequence[str] = ()) -> List[Finding]:
    """Lint a live :class:`~sparkflow_tpu_torch.serving.decode.DecodeEngine`'s
    decode step over all its lanes, as the engine runs it (its weights and
    pools faked): GC-J103, and on a quantized pool (``kv_quant=``) GC-J108.
    The decode plane runs no collective (its tp / ep / pp shards are summed
    and handed on explicitly in one process), so GC-J106 has nothing to
    read there."""
    import numpy as np
    from ..serving.decode import DecodeEngine

    B = engine.num_slots
    table = np.zeros_like(engine.kv.page_tables())
    zeros = np.zeros(B, np.int64)

    def decode_step(token, pos, table):
        return DecodeEngine._decode(engine, token, pos, table)

    return lint_fn(
        decode_step, (torch.as_tensor(zeros), torch.as_tensor(zeros),
                      torch.as_tensor(table)),
        kv_pool_pages=(engine.kv.num_pages if engine._quantized else None),
        name=name or (f"decode_step[kv={engine.kv_quant},tp={engine._tp},"
                      f"ep={engine._ep},pp={engine._pp}]"),
        ignore=ignore)


# ---------------------------------------------------------------------------
# GC-J106: declared ShardingConfig vs the collectives a step issued
# ---------------------------------------------------------------------------

#: collective byte counters of parallel.collectives.stats()
_SCATTER_OPS = ("reduce_scatter",)
_REDUCE_OPS = ("all_reduce", "reduce_scatter")


def lint_sharding_config(observed: Dict[str, int], sharding, *,
                         name: str = "step",
                         ignore: Sequence[str] = ()) -> List[Finding]:
    """Check the collectives a train step issued — ``observed``, the
    :func:`~sparkflow_tpu_torch.parallel.collectives.stats` delta over
    one step — against its declared ``ShardingConfig`` (GC-J106): a stage
    >= 1 step must reduce-scatter, a stage-0 step must not."""
    from ..sharding import as_sharding_config

    if "GC-J106" in set(ignore):
        return []
    cfg = as_sharding_config(sharding)
    scatters = sorted(k for k in _SCATTER_OPS if observed.get(k, 0) > 0)
    reduces = sorted(k for k in _REDUCE_OPS if observed.get(k, 0) > 0)
    detail = {"declared": cfg.describe(), "observed": dict(observed)}
    if cfg.zero_stage >= 1 and not scatters:
        if reduces:
            msg = (f"{name}: declared zero_stage={cfg.zero_stage} but the "
                   f"step's gradient merge is {reduces} with NO "
                   f"reduce_scatter — every rank still receives the FULL "
                   f"gradient, so the sharded optimizer state saves nothing "
                   f"at update time; the step was built without the sharded "
                   f"update (check that the config reached the step "
                   f"builder)")
        else:
            msg = (f"{name}: declared zero_stage={cfg.zero_stage} but the "
                   f"step ran no cross-rank reduction at all — each rank "
                   f"trains an independent model copy on its shard "
                   f"(divergent replicas, not data parallelism)")
        return [Finding("GC-J106", msg, source="fx_lint", detail=detail)]
    if cfg.zero_stage == 0 and scatters:
        return [Finding(
            "GC-J106",
            f"{name}: declared zero_stage=0 (replicated update) but the "
            f"step runs {scatters} — the update IS sharded, and anything "
            f"trusting the declared config (checkpoint layout conversion, "
            f"memory budgets) is wrong for this program",
            source="fx_lint", detail=detail)]
    return []


def lint_dp_train_step(model, optimizer="adam", *, mesh, sharding,
                       input_name="x:0", label_name="y:0", batch: int = 8,
                       built=None, ignore: Sequence[str] = (),
                       name: Optional[str] = None) -> List[Finding]:
    """GC-J106 over the dp train step as the trainer builds it
    (:func:`~sparkflow_tpu_torch.parallel.dp.make_dp_train_step`), run
    once on zeros rows. Call it on every rank of the process group, as
    the step's collectives need (``mesh`` a
    :class:`~sparkflow_tpu_torch.parallel.mesh.Mesh` over it). ``built``
    (default: ``sharding``) is the config the step is built with — a
    planted mismatch declares one stage and builds another."""
    from ..optimizers import build_optimizer
    from ..optimizers_sharded import (place_zero1_state, shard_zero3_params,
                                      sharded_update)
    from ..parallel import collectives
    from ..parallel.dp import make_dp_train_step
    from ..sharding import as_sharding_config

    cfg = as_sharding_config(sharding)
    bcfg = as_sharding_config(built) if built is not None else cfg
    if isinstance(optimizer, str):
        opt_label, optimizer = optimizer, build_optimizer(optimizer, 0.01)
    else:
        opt_label = type(optimizer).__name__
    dev = getattr(model, "device", torch.device("cpu"))
    with mesh.bind():
        n = bcfg.dp_size(mesh)
        rows = max(1, batch // mesh.axis_size(bcfg.batch_axes(mesh)))
        x = _model_inputs(model, [input_name], rows)[0].to(dev)
        y = (_model_inputs(model, [label_name], rows)[0].to(dev)
             if label_name is not None else torch.zeros(rows, 1, device=dev))
        params = {k: {p: t.to(dev).requires_grad_(True) for p, t in d.items()}
                  for k, d in _params(model).items()}
        with torch.no_grad():
            if bcfg.zero_stage == 0:
                state = optimizer.init(params)
            else:
                state = place_zero1_state(sharded_update(
                    optimizer, n, bcfg.data_axis).init(params), mesh, n,
                    bcfg.data_axis)
            if bcfg.zero_stage >= 3:
                params = place_zero1_state(shard_zero3_params(
                    {k: {p: t.detach() for p, t in d.items()}
                     for k, d in params.items()}, n), mesh, n,
                    bcfg.data_axis)
        if bcfg.zero_stage >= 3:
            params = {k: {p: t.requires_grad_(True) for p, t in d.items()}
                      for k, d in params.items()}
        step = make_dp_train_step(model, optimizer, mesh, input_name,
                                  label_name, sharding=bcfg)
        before = collectives.stats()
        step(params, state, x, y, torch.ones(rows, device=dev), 0)
        after = collectives.stats()
    observed = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    return lint_sharding_config(
        observed, cfg, ignore=ignore,
        name=name or f"dp_train_step[{type(model).__name__}/{opt_label}/"
                     f"zero{cfg.zero_stage}]")


# ---------------------------------------------------------------------------
# repo self-check: the presets x the optimizer registry
# ---------------------------------------------------------------------------


def repo_self_check(ignore: Sequence[str] = ()) -> List[Finding]:
    """Trace-lint the port's own model presets and optimizer registry at
    the JAX self-check's sizes — the hot paths every example and test
    trains. Any finding here is a bug; ``tests/test_torch_analysis.py``
    pins it to zero."""
    from ..models import model_from_json, presets
    from ..optimizers import AVAILABLE_OPTIMIZERS

    findings: List[Finding] = []
    mlp = model_from_json(presets.mlp(16, 4, hidden=(8,)), device="cpu")
    # every registry optimizer across the mlp step: this is where Python
    # scalars and numpy math (lr, eps, decay) would promote dtypes
    for opt in AVAILABLE_OPTIMIZERS:
        findings.extend(lint_train_step(
            mlp, "x:0", "y:0", opt, batch=4, ignore=ignore,
            name=f"train_step[mlp/{opt}]"))
    cnn = model_from_json(presets.cnn(side=12, channels=1, num_classes=4),
                          device="cpu")
    findings.extend(lint_train_step(cnn, "x:0", "y:0", "adam", batch=4,
                                    ignore=ignore,
                                    name="train_step[cnn/adam]"))
    ae = model_from_json(presets.autoencoder(input_dim=12, widths=(8, 4, 8)),
                         device="cpu")
    findings.extend(lint_train_step(ae, "x:0", None, "adam", batch=4,
                                    ignore=ignore,
                                    name="train_step[autoencoder/adam]"))
    findings.extend(lint_apply(mlp, "x:0", "out:0", batch=4, ignore=ignore,
                               name="apply[mlp/out]"))
    return findings
