"""Online-inference engine: a bucket ladder of padded batch sizes — the port
of the JAX package's ``serving/engine.py`` ``InferenceEngine`` for one
device.

Requests pad with zero rows up to the nearest bucket of a ladder (1, 2, 4,
... ``max_batch``) and trim on return; requests beyond ``max_batch`` run in
``max_batch`` chunks. Rows are independent through every model of the
package, so padded rows cannot perturb real rows' outputs. On the card a
``transformer_classifier``'s forward runs the CUDA ``flash_fwd`` kernel, in
3xTF32 for float32 and on the bf16 tensor cores with
``compute_dtype="bfloat16"``.

Quantized serving reuses :mod:`sparkflow_tpu_torch.utils.quant`: the
engine quantizes the full-precision tree once at load (and on every hot
swap), and ``weight_only`` and ``dynamic`` serve through the same ladder.

What changes: PyTorch runs eagerly, so there is no ``jit``, no AOT
executable and no trace. :meth:`warmup` runs every bucket once on the
device instead — the kernels' build at first use, cuBLAS's set-up and the
allocator's pools — and counts those runs in ``aot_compiles``; a bucket
first run outside warmup is counted in ``fallback_compiles``, so the
steady-state contract ("no first-time work after warmup") reads the same.
``stats()`` keeps every key of the JAX engine's. ``traces`` and
``steady_traces`` come from :attr:`InferenceEngine.recompile_guard`, a
:class:`~sparkflow_tpu_torch.analysis.runtime_guards.RecompileGuard` around
the bucket forward: one signature per bucket after warmup, and any
signature first met after it (a shape that escaped the ladder) counts in
``steady_traces``.

Cold start (:mod:`~sparkflow_tpu_torch.serving.coldstart`): what a fresh
replica compiles is the kernel library, not executables, so
``executable_dir`` stores that library beside the weights and
``compile_cache_dir`` is the build directory it is looked up and built in.
With either set, the engine loads the library before :meth:`warmup` by the
best tier there is and reports it under ``stats()["cold_start"]`` (JAX's
``dir`` / ``serialized_loads`` / ``serialized_saves``, plus ``tier``,
``source``, ``library`` and ``boot_s``) and ``stats()["compile_cache"]``
(``dir`` / ``hits`` / ``misses``).

Data-parallel serving (``mesh``, a :class:`~..parallel.mesh.Mesh` or a
dict of sizes; ``sharding`` for its data / dcn axes) follows the serving
rule of :mod:`~sparkflow_tpu_torch.parallel.mesh`, in this process: one
parameter copy per dp shard, copy ``r`` on card ``r % device_count`` (or
the CPU). A bucket that divides dp splits into dp row blocks, one per copy;
a smaller bucket runs on copy 0. An MoE model keeps one copy: its routing
couples a batch's rows (capacity, slot order), and JAX's program routes
the whole batch. :meth:`warmup` runs every bucket on every
copy, a hot swap places the new tree on every copy before the flip,
``quantize`` quantizes once and copies the int8 tree, and ``stats()["mesh"]``
is the mesh's shape.

Tensor-parallel serving (``sharding=ShardingConfig(tp_axis=...)`` on a mesh
with that axis, or a mesh axis named ``tp``): each dp copy is split into
``tp`` shards by the model's megatron rules (:mod:`..parallel.tp`), shard
``t`` of copy ``d`` on card ``(d * tp + t) % device_count``; each block
half runs on every shard — the ``flash_fwd`` kernel on each shard's heads —
and the partials are summed in float32 on the copy's shard 0, where the
row-parallel biases are added once. ``stats()`` reports ``tp`` and the bytes one shard
holds. As in JAX, ``quantize`` together with ``tp`` is refused, and so is
a ``tp_axis`` for a model without ``param_pspecs``. JAX's
``sharded_attention`` context needs no counterpart: each shard already
holds its own heads. An active ``pp_axis`` is refused with the JAX
engine's ``ValueError`` (depth-sharded models serve through
``DecodeEngine``). An ``fsdp`` or ``sp`` axis holds whole copies.

Expert-parallel serving (``sharding=ShardingConfig(ep_axis=...)`` on a mesh
with that axis): each MoE block's expert bank is split into ``ep`` shards
(:class:`~..parallel.tp.EPShards`), shard ``e`` of copy ``d`` on card
``((d * ep + e) * tp) % device_count``; each shard serves its experts'
slots and the outputs are summed in float32 on the copy's first card —
exact zeros besides one real row per token, so the predictions equal the
unsharded forward. It composes with ``tp``; ``stats()["ep"]`` is its
size. As in JAX, ``quantize`` with ``ep`` is refused, an ``ep`` axis the
config does not name replicates (``ep`` 1), and an ``ep_axis`` without a
mesh serves unsharded.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..analysis.runtime_guards import RecompileGuard
from ..convert import check_template, list_to_params, params_tree, \
    shape_template
from ..core import _to_numpy
from ..obs.spans import span as obs_span
from ..resilience import faults
from ..utils import metrics as metrics_mod
from ..utils.tracing import annotate
from .coldstart import (ExecutableStore, boot_kernels, cold_start_stats,
                        compile_cache_stats)

__all__ = ["InferenceEngine"]

def _bucket_ladder(max_batch: int) -> List[int]:
    """1, 2, 4, ... up to max_batch (max_batch itself always included, so a
    non-power-of-two cap still has a full-size bucket)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    buckets, b = [], 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return buckets


class InferenceEngine:
    """Low-latency predictions from a trained model over a bucket ladder.

    Parameters
    ----------
    graph : str | model
        Model spec JSON (``nn`` graph DSL or registry spec — anything
        :func:`sparkflow_tpu_torch.models.model_from_json` loads), built on
        ``device``, or an already constructed model (its own device).
    weights : list of arrays | str | params tree
        Flat weight list, the estimator's weights Param (inline JSON or
        ``npz:<path>``), or a params tree (the port's tensors or numpy
        arrays, the JAX package's layout).
    input_name : str | sequence of str
        Input tensor name(s); a sequence means requests carry a tuple of
        arrays (multi-input models, e.g. ``input_ids:0`` +
        ``attention_mask:0``).
    output_name : str
        Output tensor to serve.
    dropout_name, dropout_value
        A keep-probability placeholder to feed (graph-DSL models).
    max_batch : int
        Top of the bucket ladder; larger requests run in max_batch chunks.
    quantize : None | 'weight_only' | 'dynamic'
        int8 serving via ``utils.quant``. ``quant_min_size`` forwards to
        :func:`~sparkflow_tpu_torch.utils.quant.quantize_params` (kernels
        below it stay full precision).
    compute_dtype
        ``"bfloat16"`` runs a spec's matmuls and attention in bf16.
    warmup : bool
        Run every bucket once at construction (default); with
        ``warmup=False`` each bucket's first request is counted in
        ``stats()['fallback_compiles']``.
    device
        The CUDA card unless ``"cpu"`` is asked for; with no card it raises.
    executable_dir : str | None
        Cold start from a stored kernel library: a
        :class:`~sparkflow_tpu_torch.serving.coldstart.ExecutableStore`
        directory. The engine loads the library from here (sha256-verified,
        no ``nvcc``) before warmup; on a miss it finds or builds it and
        saves it back for the next boot.
    compile_cache_dir : str | None
        The kernel build directory the library is looked up and built in,
        in place of ``ops/_build/`` or ``SPARKFLOW_TORCH_KERNEL_DIR``.
    mesh, sharding
        Data-parallel serving over weight copies, split into tensor-parallel
        shards under ``tp`` and expert shards under ``ep`` (see the module
        docstring); ``pp`` is a decode axis (refused, as in JAX).
    """

    def __init__(self, graph, weights=None, *,
                 input_name: Union[str, Sequence[str]] = "x:0",
                 output_name: str = "out:0",
                 dropout_name: Optional[str] = None,
                 dropout_value: float = 1.0,
                 max_batch: int = 64,
                 mesh=None,
                 sharding=None,
                 quantize: Optional[str] = None,
                 quant_min_size: int = 4096,
                 compute_dtype=None,
                 warmup: bool = True,
                 compile_cache_dir: Optional[str] = None,
                 executable_dir: Optional[str] = None,
                 metrics: Optional[metrics_mod.Metrics] = None,
                 device=None):
        from ..sharding import as_sharding_config
        self.sharding = as_sharding_config(sharding)
        if self.sharding.tp_axis is not None and mesh is None:
            raise ValueError("sharding names tp_axis but no mesh was given; "
                             "pass mesh= to InferenceEngine")
        self.mesh = None
        dp, tp_axis, tp, ep_axis, ep = 1, None, 1, None, 1
        if mesh is not None:
            from ..parallel.mesh import as_mesh, serving_layout
            self.mesh = as_mesh(mesh)
            # a typo'd axis fails here, not on the first request
            self.sharding.validate(self.mesh, require_data_axis=False)
            if (self.sharding.pp_axis is not None
                    and int(self.mesh.shape.get(self.sharding.pp_axis, 1))
                    > 1):
                raise ValueError(
                    "pp_axis is a decode-plane axis: the single-shot "
                    "predict engine has no token cadence to hide pipeline "
                    "bubbles behind. Serve depth-sharded models through "
                    "DecodeEngine (serving/decode.py), or drop pp_axis "
                    "from this engine's sharding config.")
            dp, tp_axis, tp, ep_axis, ep = serving_layout(self.mesh,
                                                          self.sharding)
            if self.sharding.ep_axis is None:
                ep = 1      # as JAX's engine: a bare ep axis replicates
        if tp * ep > 1 and quantize:
            raise ValueError("quantize does not compose with tensor/expert-"
                             "parallel serving (int8 packing breaks the "
                             "megatron layout); pick one")
        if isinstance(graph, str):
            from ..models import model_from_json
            self.model = model_from_json(graph, compute_dtype, device=device)
        else:
            self.model = graph
        self.device = self.model.device
        self._pspecs = None
        if tp * ep > 1:
            from ..parallel.tp import serving_pspecs
            self._pspecs = serving_pspecs(self.model, self.mesh,
                                          tp_axis if tp > 1 else None,
                                          ep_axis if ep > 1 else None)
            if self._pspecs is None:
                if (self.sharding.tp_axis is not None
                        or self.sharding.ep_axis is not None):
                    raise TypeError("model-parallel serving needs the model "
                                    "to publish param_pspecs() (megatron "
                                    "rules)")
                tp = ep = 1   # a bare tp axis on a model without rules
        if getattr(self.model, "num_experts", None):
            # an MoE layer routes the whole batch (capacity and slot order
            # couple its rows), as JAX's program does: one copy holds it
            dp = 1
        # the serving rule (parallel/mesh.py): one copy per dp shard, split
        # into tp shards and its banks into ep shards
        from ..parallel.mesh import expert_grid, model_on, serving_grid
        self.dp, self.tp, self._tp_axis = dp, tp, tp_axis
        self.ep, self._ep_axis = ep, ep_axis
        self._grid = serving_grid(dp, tp, self.device, ep=ep)
        self._expert_grid = expert_grid(dp, tp, ep, self.device)
        self._devices = [g[0] for g in self._grid]
        self._models = [model_on(self.model, d) for d in self._devices]
        self.input_name = input_name
        self.output_name = output_name
        self.dropout_name = dropout_name
        self.dropout_value = dropout_value
        self.max_batch = int(max_batch)
        self.quantize = quantize
        self.metrics = metrics if metrics is not None else metrics_mod.Metrics()

        self._multi = isinstance(input_name, (list, tuple))
        names = list(input_name) if self._multi else [input_name]
        self._in_keys = [n.split(":")[0] for n in names]
        # validate names against the model's tensor table up front — a typo
        # must fail at engine construction, not on the first live request
        for n in names + [output_name]:
            self.model.resolve(n)

        params = self._load_params(weights)
        # shape/dtype template of the ctor weights in STANDARD layout,
        # captured before quantize: every hot swap validates against it
        self._weights_template = shape_template(params)
        self._quant_min_size = int(quant_min_size)
        if quantize:
            from ..utils.quant import MODES
            if quantize not in MODES:
                raise ValueError(f"quantize must be one of {MODES} (or None), "
                                 f"got {quantize!r}")
        self._copies = self._place_params(params)

        self._in_shapes, self._in_dtypes = self._input_layouts()
        self.buckets = _bucket_ladder(self.max_batch)
        self._warm: set = set()
        self._compile_lock = threading.Lock()
        self._stats_lock = threading.Lock()  # request counters + params ref
        # one expected signature per ladder bucket; anything beyond warns
        self.recompile_guard = RecompileGuard(name="serving.predict",
                                              warn_after=len(self.buckets))
        self._forward = self.recompile_guard.wrap(self._forward)
        self.aot_compiles = 0
        self.fallback_compiles = 0
        self._requests = 0
        self._rows = 0
        self._serving_version = 0  # bumped by swap_params; 0 = ctor weights
        self._swaps = 0
        # cold start: the kernel library, from the store (tier 1), the
        # build directory (tier 2) or nvcc (tier 3), before any bucket runs
        self.exec_store = None
        if executable_dir is not None:
            self.exec_store = ExecutableStore(executable_dir,
                                              metrics=self.metrics)
        self.compile_cache_dir = (os.path.abspath(compile_cache_dir)
                                  if compile_cache_dir is not None else None)
        self.boot = None
        if self.exec_store is not None or self.compile_cache_dir is not None:
            self.boot = boot_kernels(self.exec_store, self.compile_cache_dir,
                                     self.device)
        if warmup:
            self.warmup()

    # -- loading -------------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, directory: str, graph, retry=None, **kwargs
                        ) -> "InferenceEngine":
        """Load from a :class:`~sparkflow_tpu_torch.checkpoint.
        CheckpointManager` directory: its ``weights.npz`` export (the JAX
        package's too) or its newest restorable npz checkpoint, whose
        restore verifies manifest checksums and falls back past corrupt
        steps. An orbax checkpoint is refused (the port reads npz only).
        ``retry`` (a ``RetryPolicy``) governs transient read errors."""
        from ..checkpoint import CheckpointManager
        from ..models import model_from_json
        model = (model_from_json(graph, kwargs.get("compute_dtype"),
                                 device=kwargs.get("device"))
                 if isinstance(graph, str) else graph)
        weights = CheckpointManager.load_weights(directory, model,
                                                 retry=retry)
        return cls(model, weights, **kwargs)

    def _load_params(self, weights):
        if weights is None:
            raise ValueError("weights are required (flat list, weights JSON, "
                             "'npz:<path>', or a params pytree)")
        if isinstance(weights, str):
            from ..ml_util import resolve_weights
            weights = resolve_weights(weights)
        if isinstance(weights, (list, tuple)):
            return list_to_params(self.model, list(weights),
                                  device=self.device)
        return params_tree(self.model, weights, self.device)

    def _place_params(self, params) -> list:
        """Quantize one standard-layout tree into this engine's serving
        form, one copy per dp shard (the tree itself on one device), each
        split into its tp shards under tp. The ctor and every hot swap run
        exactly this path, so a swapped tree lands bit-identical to a cold
        start."""
        if self.tp * self.ep > 1:
            from ..parallel.tp import serving_tree
            return [serving_tree(self.model, params, self._pspecs,
                                 self._tp_axis if self.tp > 1 else None, g,
                                 self._ep_axis if self.ep > 1 else None, x)
                    for g, x in zip(self._grid, self._expert_grid)]
        if self.quantize:
            from ..utils.quant import quantize_for_serving
            params = quantize_for_serving(self.model, params, self.quantize,
                                          self._quant_min_size)
            for m in self._models:
                m.quant_mode = self.quantize
        from ..parallel.mesh import dp_copies
        return dp_copies(params, self._devices)

    def _snapshot_params(self):
        """The serving tree of copy 0 (the only one without a mesh)."""
        with self._stats_lock:
            return self._copies[0]

    def _snapshot_copies(self) -> list:
        with self._stats_lock:
            return self._copies

    def _input_layouts(self) -> Tuple[List[Tuple[int, ...]], List[Any]]:
        specs = self.model.input_specs()
        shapes, dtypes = [], []
        for key in self._in_keys:
            if key not in specs:
                raise KeyError(f"input {key!r} is not a model input; inputs: "
                               f"{sorted(specs)}")
            shape, dtype = specs[key]
            if any(d is None for d in shape[1:]):
                raise ValueError(
                    f"input {key!r} has non-static feature dims {shape}; the "
                    f"bucket ladder needs fully static row shapes")
            shapes.append(tuple(int(d) for d in shape[1:]))
            dtypes.append(np.dtype(dtype))
        return shapes, dtypes

    # -- the forward ---------------------------------------------------------

    def _apply(self, params, xs: Tuple[np.ndarray, ...],
               copy: int = 0) -> torch.Tensor:
        """One forward on copy ``copy``'s device (the engine's device for
        copy 0); ``xs`` padded numpy rows."""
        model = self._models[copy]
        dev = model.device
        feeds = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for k, a in zip(self._in_keys, xs)}
        if self.dropout_name:
            feeds[self.dropout_name.split(":")[0]] = torch.tensor(
                self.dropout_value, dtype=torch.float32, device=dev)
        with torch.inference_mode():
            return model.apply(params, feeds, [self.output_name],
                               train=False)[self.output_name]

    def _forward(self, copies, xs, bucket: int) -> np.ndarray:
        """A bucket's forward: split into one row block per copy when the
        bucket divides dp, else on copy 0."""
        if self.dp == 1 or bucket % self.dp:
            return _to_numpy(self._apply(copies[0], xs))
        from ..parallel.mesh import dp_apply
        return _to_numpy(dp_apply(
            lambda r, p, block: self._apply(p, block, r), copies, xs))

    def warmup(self) -> None:
        """Run every bucket once through the request path's forward (zeros
        rows), and a bucket that does not split over the dp copies on
        every copy as well. Idempotent; after it returns, no request size
        meets first-time work, and the recompile guard is marked steady: a
        signature first met later counts in ``steady_traces``."""
        with self._compile_lock:
            copies = self._snapshot_copies()
            for b in self.buckets:
                if b not in self._warm:
                    xs = tuple(np.zeros((b,) + shape, dtype)
                               for shape, dtype in zip(self._in_shapes,
                                                       self._in_dtypes))
                    with annotate(f"serving/aot_compile_b{b}"):
                        self._forward(copies, xs, b)
                        if b % self.dp:
                            for r in range(1, self.dp):
                                _to_numpy(self._apply(copies[r], xs, r))
                    self._warm.add(b)
                    self.aot_compiles += 1
            self.recompile_guard.mark_steady()

    def _first_use(self, bucket: int) -> None:
        # lazy path (warmup=False) — counted so tests can assert the steady
        # state meets no first-time work
        if bucket not in self._warm:
            with self._compile_lock:
                if bucket not in self._warm:
                    self._warm.add(bucket)
                    self.fallback_compiles += 1

    # -- serving -------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    def predict(self, x) -> np.ndarray:
        """Predict for ``x``: one array ``[n, ...]`` (or a tuple for
        multi-input models), any ``n >= 1``. Pads to the nearest bucket;
        requests beyond ``max_batch`` run in max_batch chunks."""
        faults.fire("engine.predict")  # chaos hook; no-op unless armed
        # rows take the model's input dtypes (JSON bodies arrive as float64
        # / int64 arrays)
        xs = tuple(np.asarray(a, dt) for a, dt in zip(
            x if self._multi else (x,), self._in_dtypes))
        if xs[0].ndim == len(self._in_shapes[0]):  # single unbatched row
            xs = tuple(a[None] for a in xs)
        for a, shape, key in zip(xs, self._in_shapes, self._in_keys):
            if tuple(a.shape[1:]) != shape:
                raise ValueError(
                    f"input {key!r}: rows have shape {tuple(a.shape[1:])}, "
                    f"model expects {shape}")
        n = xs[0].shape[0]
        if any(a.shape[0] != n for a in xs):
            raise ValueError("multi-input arrays must share the batch dim")
        # one params snapshot per request: a concurrent hot swap never gives
        # a chunked request mixed versions — every chunk runs the same tree
        params = self._snapshot_copies()
        if n == 0:
            probe = self._run(tuple(a[:0] for a in xs), 0, params,
                              probe_rows=1)
            return probe[:0]
        with self._stats_lock:
            self._requests += 1
            self._rows += n
        if n > self.max_batch:
            outs = [self._run(tuple(a[i:i + self.max_batch] for a in xs),
                              min(self.max_batch, n - i), params)
                    for i in range(0, n, self.max_batch)]
            return np.concatenate(outs, axis=0)
        return self._run(xs, n, params)

    def _run(self, xs, n: int, params, probe_rows: int = 0) -> np.ndarray:
        have = max(n, probe_rows)
        bucket = self._bucket_for(have)
        if have < bucket:
            xs = tuple(np.concatenate(
                [a, np.zeros((bucket - a.shape[0],) + a.shape[1:], a.dtype)])
                for a in xs)
        elif probe_rows and xs[0].shape[0] == 0:
            xs = tuple(np.zeros((bucket,) + a.shape[1:], a.dtype) for a in xs)
        self._first_use(bucket)
        self.metrics.observe("serving/engine_batch_rows", n)
        self.metrics.observe("serving/padding_waste",
                             (bucket - n) / bucket if bucket else 0.0)
        # the host span routes to whatever tracer is active on this thread
        # (the batcher worker's, usually); the same named range shows in
        # torch.profiler captures
        with obs_span("serving/engine_apply", args={"bucket": bucket},
                      profiler_annotation=True):
            out = self._forward(params, xs, bucket)
        return out[:n]

    # -- live weight hot-swap ------------------------------------------------

    def weights_template(self):
        """Shape/dtype template (``{layer: {name: meta tensor}}``, standard
        layout) of the ctor weights — what a published tree must match leaf
        for leaf for :meth:`swap_params` to accept it."""
        return self._weights_template

    def swap_params(self, weights, *, version: Optional[int] = None) -> bool:
        """Hot-swap the serving weights without a restart. ``weights`` is
        anything the ctor accepts, in the model's STANDARD layout, with every
        leaf's shape and dtype identical to the ctor tree's (enforced).
        Double-buffered: the new tree is placed on the device and quantized
        while the old one keeps serving, then swapped in one reference
        assignment; in-flight predicts hold their snapshot, so no request
        observes mixed versions. Returns True (swaps apply immediately on
        this engine)."""
        faults.fire("engine.swap")  # chaos hook; no-op unless armed
        params = self._load_params(weights)
        check_template(params, self._weights_template)
        placed = self._place_params(params)  # old trees still serving
        with self._stats_lock:
            # the swap: every copy placed, then one flip
            self._copies = placed
            v = (int(version) if version is not None
                 else self._serving_version + 1)
            self._serving_version = v
            self._swaps += 1
        self.metrics.gauge("serving/version", float(v))
        return True

    def serving_version(self) -> int:
        """Version of the weights currently serving (0 = ctor weights)."""
        with self._stats_lock:
            return self._serving_version

    def maybe_swap(self) -> bool:
        """Swaps apply immediately on this engine; nothing is deferred."""
        return True

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        from ..parallel.tp import shard_bytes
        with self._stats_lock:
            requests, rows = self._requests, self._rows
            serving_version, swaps = self._serving_version, self._swaps
            params = self._copies[0]
        return {"buckets": list(self.buckets),
                "serving_version": serving_version,
                "swaps": swaps,
                "sharding": self.sharding.describe(),
                "aot_compiles": self.aot_compiles,
                "fallback_compiles": self.fallback_compiles,
                "traces": self.recompile_guard.traces,
                "steady_traces": self.recompile_guard.steady_traces,
                "requests": requests,
                "rows": rows,
                "compile_cache": compile_cache_stats(self.compile_cache_dir,
                                                     self.boot),
                "cold_start": cold_start_stats(self.exec_store, self.boot),
                "quantize": self.quantize,
                "mesh": (dict(self.mesh.shape) if self.mesh is not None
                         else None),
                "tp": self.tp,
                "ep": self.ep,
                "param_bytes_per_device": shard_bytes(params),
                "device": str(self.device)}
