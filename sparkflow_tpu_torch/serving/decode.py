"""Autoregressive decode engine: prefill ladder + fixed-shape paged decode.

The port of the JAX package's ``serving/decode.py`` ``DecodeEngine`` for one
device. What it keeps:

- **Prefill** pads a prompt to the nearest page-aligned bucket of the ladder
  (page, 2*page, 4*page, ... up to ``max_seq_len``), runs
  :meth:`TransformerLM.prefill` — flash attention, the CUDA ``flash_fwd``
  kernel on the card — and writes every block's K/V straight into the
  slot's pool pages (the padded tail's pages point at scratch page 0).
- **Decode** is one step over all ``num_slots`` lanes whatever subset is
  live: token ids, positions and page tables are dense ``[num_slots]``
  operands, lanes not ready to decode point at scratch page 0 with
  position 0, and attention is :func:`~sparkflow_tpu_torch.ops.paged_attention`
  — the CUDA ``paged_attention`` kernel — over the page-table-indirected
  pool of :class:`~sparkflow_tpu_torch.serving.kvcache.PagedKVCache`.
- **Shared-prefix caching** (``prefix_cache=True``) maps indexed prefix
  pages into a new slot's table and forwards only the un-shared suffix,
  in ``page_size`` chunks, through :meth:`TransformerLM.prefill_suffix`
  with a plain-torch attend over the slot's pages.
- **Chunked prefill** (``prefill_chunk=N``) admits a long prompt at once and
  advances its suffix one N-token chunk per :meth:`step`, run together
  with the decode step; the first token surfaces from :meth:`step`.
- **Speculative decoding** (``spec_k=N``): a draft proposes up to N tokens
  per slot — self-speculation through the target's first ``draft_layers``
  blocks over the same paged pool (default ``num_layers // 2``), or an
  external ``draft_model`` with its own dense cache — then ONE verify call
  (:meth:`TransformerLM.decode_verify` over
  :func:`~sparkflow_tpu_torch.ops.paged_attention_verify`, the CUDA
  ``paged_verify`` kernel) scores all N + 1 positions of every live slot.
  The longest draft prefix matching the target's greedy argmax commits,
  plus the target's own bonus token, and the rest rolls back through
  :meth:`PagedKVCache.truncate`. Greedy output equals non-speculative
  decoding; temperature slots run with a window of 0 and sample their token
  from the verify logits at position 0.
- **Quantized KV** (``kv_quant="int8"|"fp8"``): each pool is a ``(rows,
  scales)`` pair — int8 or float8_e4m3fn rows plus ``[layers, pages,
  heads]`` float32 scales (:mod:`~sparkflow_tpu_torch.utils.quant`); writes
  quantize with a running per-page-per-head absmax, and every attend reads
  the quantized rows with the scales folded into the kernels'
  accumulations (the ``paged_attention`` and ``paged_verify`` kernels'
  quantized instantiations). Construction measures the quantization's
  logit error once (``stats()["kv_quant_error"]``).
- **Sampling** is greedy at ``temperature == 0``; otherwise temperature +
  per-slot top-k (clamped to ``max_top_k``) from a per-slot
  ``torch.Generator`` (seeded ``seed + slot``, re-seeded by a request's
  ``seed``). ``jax.random``'s bits cannot be reproduced here: greedy output
  matches the JAX engine token for token, seeded sampling repeats within
  this package.

What changes: there is no ``jit`` and no AOT executable — the engine runs
eagerly under ``torch.inference_mode()`` and the pools are updated in
place. :meth:`DecodeEngine.warmup` runs each device entry point once at
every shape the engine serves (each prefill bucket, the decode step, the
suffix chunk, the wave stages, draft and verify, the external draft's
prefill ladder) on scratch operands, writing only scratch page 0, which
it restores. :attr:`DecodeEngine.recompile_guard` (a
:class:`~sparkflow_tpu_torch.analysis.runtime_guards.RecompileGuard`)
wraps those entry points: ``stats()["traces"]`` counts their argument
signatures, ``aot_compiles`` the ones warmup ran, and ``steady_traces``
any first met after warmup. ``stats()`` keeps the keys the server and
``/healthz`` read. The quantization-error probe lets a failure raise (the
JAX engine swallows it): on the card it runs the kernels, and a kernel
fault must not pass unseen.

``executable_dir`` boots the kernel library from a
:class:`~sparkflow_tpu_torch.serving.coldstart.ExecutableStore` before
warmup, as the predict engine does, and reports the tier under
``stats()["cold_start"]``.

Tensor-parallel decode (``mesh=`` with ``sharding=ShardingConfig(tp_axis=
...)``, the JAX engine's checks and messages): in one process, shard ``t``
of ``tp`` on card ``t % device_count`` (or the CPU) holds its slice of the
weights (qkv columns packed in ``(tp, 3, H/tp, d)`` order) and its
``heads / tp`` slice of each pool (a quantized pool's scales sharded on
heads with their rows). Each block half runs on every shard — the paged
kernels over the shard's heads — and the partials are summed in float32 on
shard 0's device in shard order, rounded to the compute dtype once; the
row-parallel biases are added once after the sum, where JAX's decode plane
adds ``bias / tp`` on every shard (the same value in exact arithmetic). Every arm runs over the shards: the ladder and
chunked prefill, prefix hits, hot swap, ``spec_k`` with the self draft and
``kv_quant``; an external ``draft_model`` stays whole on the engine's
device, as in JAX. The host bookkeeping (page tables, refcounts, the prefix
trie, the batcher) stays single and layout-blind. ``stats()["parallel"]``
reports ``tp`` and one shard's bytes.

Pipeline-parallel decode (``sharding=ShardingConfig(pp_axis=...)`` on a
mesh with that axis, the JAX engine's checks and messages) splits the
depth into ``pp`` stages in one process: stage ``s`` holds its ``L/pp``
blocks, a copy of the shared leaves (embedding, final norm) and its
``L/pp`` layers of each pool (a quantized pool's scales split with their
layers), on card ``s * tp % device_count`` — under ``pp x tp`` its tp
shards on cards ``(s * tp + t) % device_count``, each block split as
above. The activation moves to the next stage's device between stages
(:class:`_Stages`). Every arm runs staged: the ladder and chunked prefill,
prefix hits, the plain step, ``spec_k`` with the self draft (which must
stop at a stage boundary) and with an external draft, ``kv_quant`` and hot
swap. With ``pp_wave=True`` (the default) and ``spec_k=0`` every
:meth:`DecodeEngine.step` is one tick: the slots split into ``pp`` waves by
lane, stage ``s`` runs wave ``(t - s) mod pp`` on the activation its
predecessor left last tick, and the last stage's wave emits — the same
slots on the same ticks as JAX's engine. A chunked prefill drains the
waves first. ``pp_wave=False`` keeps the single-wave step. JAX stages
without control flow (every stage computes every pass, inactive ones
write to scratch page 0); eagerly only the stages with work run, so the
tokens are the same and only scratch page 0 may differ.

Expert-parallel decode (``sharding=ShardingConfig(ep_axis=...)``, the JAX
engine's checks and messages, in their order: an ``ep_axis`` over a model
without an expert bank, ``num_experts`` not divisible by ``ep``, then
``pp`` with ``ep``): in one process each MoE block's expert bank is split
into ``ep`` shards (:class:`~sparkflow_tpu_torch.parallel.tp.EPShards`),
shard ``e`` on card ``(e * tp) % device_count`` (the serving rule of
:mod:`~sparkflow_tpu_torch.parallel.mesh`; under ``tp x ep`` the tp shards
on cards ``t % device_count``). The routing runs once on the whole batch;
each shard serves its experts' slots and the outputs are summed in float32
on the first card and rounded once — one real row per token beside exact
zeros, so the tokens are the unsharded engine's. Every arm runs so, as
under tp; ``stats()["parallel"]["ep"]`` is its size.

The engine is mechanism only — slot admission at token boundaries, queueing,
futures and drain semantics live in
:class:`~sparkflow_tpu_torch.serving.batcher.ContinuousBatcher`.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis.runtime_guards import RecompileGuard
from ..convert import check_template, params_tree, shape_template
from ..obs.spans import span as obs_span
from ..ops import paged_attention, paged_attention_verify
from ..parallel.tp import TPShards, shard_of as _shard
from ..resilience import faults
from ..utils import metrics as metrics_mod
from ..utils import quant
from ..utils.tracing import annotate
from .coldstart import ExecutableStore, boot_kernels, cold_start_stats
from .kvcache import OutOfPages, PagedKVCache, SwapPending

__all__ = ["DecodeEngine"]

NEG_INF = -1e30


def _prefill_ladder(page_size: int, max_prompt: int) -> List[int]:
    """Page-aligned bucket ladder: page, 2*page, 4*page, ... capped at
    ``max_prompt`` (itself included, already page-aligned)."""
    buckets, b = [], page_size
    while b < max_prompt:
        buckets.append(b)
        b *= 2
    buckets.append(max_prompt)
    return buckets


class _Stages:
    """The model's serving entry points (``prefill``, ``decode_step``,
    ``prefill_suffix``, ``decode_verify``) walked over pipeline stages in
    one process: ``params`` is one tree a stage (``DecodeEngine.
    _stage_tree``) and ``cache`` one cache a stage; the activation moves to
    each stage's device before its blocks, which see stage-local layer
    indices, and the logits come back on ``out_device``. Each stage runs
    only when it has work: JAX's every-stage-every-pass ("no-cond") staging
    is a compile-time rule, and the tokens are the same."""

    def __init__(self, model, per: int, out_device):
        self.model, self.per, self.out_device = model, per, out_device
        self.num_layers = model.num_layers

    def _blocks(self, params, x, n_layers, run):
        """``x`` through the first ``n_layers`` blocks: ``run(bp, x, j, s)``
        on stage ``s``'s block ``j``. Returns ``(x, shared)``, the shared
        leaves of the stage it left on."""
        last = 0
        for i in range(n_layers):
            s, j = divmod(i, self.per)
            st = params[s]
            if j == 0:
                x = x.to(st["device"])
            x = run(st["blocks"][j], x, j, s)
            last = s
        return x, params[last]["shared"]

    def prefill(self, params, ids, mask=None, lengths=None):
        m = self.model
        kvs = []

        def run(bp, x, _j, _s):
            x, k, v = m.block_prefill(bp, x, mask)
            kvs.append((k, v))
            return x

        x, shared = self._blocks(params, m.prefill_embed(
            params[0]["shared"], ids), self.num_layers, run)
        if lengths is not None:
            lengths = lengths.to(x.device)
        return m.head_last(shared, x, lengths).to(self.out_device), kvs

    def decode_step(self, params, cache, token, pos, attend,
                    num_layers: Optional[int] = None):
        m = self.model
        n = self.num_layers if num_layers is None else int(num_layers)
        x, shared = self._blocks(
            params, m.decode_embed(params[0]["shared"], token, pos), n,
            lambda bp, x, j, s: m.block_decode(bp, x, j, cache[s], pos,
                                               attend)[0])
        return m.decode_head(shared, x).to(self.out_device), cache

    def _suffix(self, params, ids, start, cache, attend):
        m = self.model
        return self._blocks(
            params, m.suffix_embed(params[0]["shared"], ids, start),
            self.num_layers,
            lambda bp, x, j, s: m.block_suffix(bp, x, j, cache[s], start,
                                               attend)[0])

    def prefill_suffix(self, params, ids, start, cache, attend,
                       lengths=None):
        x, shared = self._suffix(params, ids, start, cache, attend)
        if lengths is not None:
            lengths = lengths.to(x.device)
        return (self.model.head_last(shared, x, lengths).to(self.out_device),
                cache)

    def decode_verify(self, params, ids, start, cache, attend):
        x, shared = self._suffix(params, ids, start, cache, attend)
        return self.model.head_all(shared, x).to(self.out_device), cache


class DecodeEngine:
    """Continuous-decode mechanism over a paged KV cache.

    Parameters
    ----------
    model : TransformerLM | str
        A causal LM exposing ``prefill`` / ``decode_step`` (or a registry
        spec JSON, loaded on the CUDA card).
    params : tree | list | None
        The port's ``{layer: {name: tensor}}`` tree, a tree of numpy arrays
        (JAX params), or the flat weight list; default the model's own
        parameters. Moved to the model's device.
    num_slots, page_size, num_pages, max_seq_len, max_top_k, prefill_chunk,
    prefix_cache, metrics
        As in the JAX engine.
    spec_k : int
        Speculative window: draft up to ``spec_k`` tokens per slot per step
        and verify them (plus a bonus token) in one target call; 0 (default)
        is off. Any ``spec_k >= 1``, as in the JAX engine (the verify
        kernel scores a slot's ``spec_k + 1`` rows in groups of 16).
    draft_layers : int | None
        Self-speculation depth (default ``num_layers // 2``).
    draft_model, draft_params
        An external draft (same vocab) instead of self-speculation: a model
        or a registry spec JSON (loaded on the engine's device) and its
        params in any form ``params`` takes.
    kv_quant : str | None
        ``None``/``"bf16"`` keeps the compute-dtype pool; ``"int8"`` /
        ``"fp8"`` store quantized rows plus per-page-per-head float32 scales.
    seed : int
        Slot ``i``'s sampling generator starts at ``seed + i``.
    warmup : bool
        Build the CUDA kernels now (on the card) so the first request does
        not pay the compile, and measure ``kv_quant_error`` for a quantized
        pool.
    executable_dir : str | None
        Cold start from a stored kernel library (see the module docstring);
        on a miss the library is found or built and saved back.
    """

    def __init__(self, model, params=None, *, num_slots: int = 8,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 max_seq_len: Optional[int] = None, max_top_k: int = 64,
                 seed: int = 0, warmup: bool = True,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True,
                 spec_k: int = 0, draft_layers: Optional[int] = None,
                 draft_model=None, draft_params=None,
                 mesh=None, sharding=None, pp_wave: bool = True,
                 kv_quant: Optional[str] = None,
                 executable_dir: Optional[str] = None,
                 metrics: Optional[metrics_mod.Metrics] = None):
        if isinstance(model, str):
            from ..models import model_from_json
            model = model_from_json(model)
        for need in ("prefill", "decode_step", "prefill_suffix"):
            if not hasattr(model, need):
                raise TypeError(f"model has no {need}(); DecodeEngine needs "
                                f"a causal LM (transformer_lm)")
        self.model = model
        self.device = model.device
        # an MoE model's lanes compete for expert capacity (_scratch_src)
        self._routes = bool(getattr(model, "num_experts", None))
        self._init_mesh(mesh, sharding)
        self.metrics = metrics if metrics is not None else metrics_mod.Metrics()
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        cap = self.page_size * (int(model.max_len) // self.page_size)
        if cap < self.page_size:
            raise ValueError(
                f"model.max_len={model.max_len} is below one page "
                f"(page_size={page_size})")
        self.max_seq_len = int(max_seq_len) if max_seq_len else cap
        if self.max_seq_len > int(model.max_len):
            raise ValueError(f"max_seq_len={self.max_seq_len} exceeds the "
                             f"model's max_len={model.max_len}")
        self.max_pages_per_slot = math.ceil(self.max_seq_len / self.page_size)
        if num_pages is None:
            num_pages = self.num_slots * self.max_pages_per_slot + 1
        # the pool layout is validated here so a misconfigured replica fails
        # at construction, not at its first decode
        self.kv_quant = ("bf16" if kv_quant in (None, "bf16")
                         else str(kv_quant))
        if self.kv_quant not in quant.KV_DTYPES:
            raise ValueError(f"kv_quant must be one of {quant.KV_DTYPES} or "
                             f"None, got {kv_quant!r}")
        if not quant.kv_quant_supported(self.kv_quant):
            raise ValueError(
                "kv_quant='fp8' needs torch.float8_e4m3fn, which this torch "
                "does not expose; use 'int8'")
        self._quantized = self.kv_quant != "bf16"
        self._kv_quant_error: Optional[float] = None
        pool_dtype = model.compute_dtype or torch.float32
        heads, hd = int(model.num_heads), int(model.head_dim)
        # device bytes of one page across K and V and all layers: rows plus,
        # quantized, one float32 scale per page-head
        itemsize = (1 if self._quantized
                    else torch.empty((), dtype=pool_dtype).element_size())
        self._kv_bytes_per_page = 2 * int(model.num_layers) * (
            self.page_size * heads * hd * itemsize
            + (heads * 4 if self._quantized else 0))
        self.kv = PagedKVCache(num_pages, self.page_size, self.num_slots,
                               self.max_pages_per_slot, metrics=self.metrics,
                               kv_dtype=self.kv_quant,
                               kv_bytes_per_page=self._kv_bytes_per_page)
        self.max_top_k = max(1, min(int(max_top_k), int(model.vocab_size)))
        self.prefill_buckets = _prefill_ladder(
            self.page_size, self.page_size * (self.max_seq_len
                                              // self.page_size))
        self.max_prompt_len = self.prefill_buckets[-1]
        self.prefix_cache = bool(prefix_cache)
        self.prefill_chunk: Optional[int] = None
        if prefill_chunk:
            self.prefill_chunk = max(1, min(int(prefill_chunk),
                                            self.max_prompt_len))
        # width of one suffix chunk: the chunk size when chunking, else one
        # page (prefix-hit suffixes are typically short)
        self._chunk_width = self.prefill_chunk or self.page_size
        self._init_spec(spec_k, draft_layers, draft_model, draft_params)
        # micro-token wave scheduling: live slots partition into pp waves
        # that occupy the pipeline at once (stage s decodes wave (t - s) mod
        # pp at tick t); the speculative step already amortizes depth over
        # its multi-token chunk, so waves stand down when speculation is on
        self._pp_wave = bool(pp_wave) and self._pp > 1 and not self.spec_k
        if self._pp_wave and self.num_slots % self._pp:
            raise ValueError(
                f"num_slots={num_slots} is not divisible by pp={self._pp}: "
                f"wave scheduling partitions the slot lanes into pp equal "
                f"waves (pass pp_wave=False for the single-wave schedule)")

        tree = params_tree(model, params, self.device)
        self._weights_template = shape_template(tree)
        self._params = self._prepare_params(tree)
        # under tp each shard holds the pool's heads axis / tp on its device
        # (the int8/fp8 scales sharded on heads with their rows), under pp
        # each stage its layers / pp (the scales split with their layers);
        # the page bookkeeping stays single and layout-blind
        local_heads = heads // self._tp
        pool_shape = (self._per, num_pages, self.page_size, local_heads, hd)

        def make_pool(dev):
            if self._quantized:
                store, _ = quant.kv_pool_dtype(self.kv_quant)
                return (torch.zeros(pool_shape, dtype=store, device=dev),
                        torch.zeros(pool_shape[:2] + (local_heads,),
                                    device=dev))
            return torch.zeros(pool_shape, dtype=pool_dtype, device=dev)

        with torch.inference_mode():
            self._stage_pools = [[(make_pool(d), make_pool(d)) for d in devs]
                                 for devs in self._stage_devices]
            self._shard_pools = [p for st in self._stage_pools for p in st]
            self._k_pool, self._v_pool = self._shard_pools[0]
            if self._draft_model is not None:
                dm = self._draft_model
                # dense per-slot draft cache: a clamped-window chain reaches
                # position max_seq_len - 1 + spec_k, and the last row is the
                # write margin masked lanes aim at (never attended)
                self._draft_cache_len = self.max_seq_len + self.spec_k + 1
                cache = dm.init_decode_cache(self.num_slots,
                                             self._draft_cache_len)
                self._draft_k, self._draft_v = cache["k"], cache["v"]
        self._gens = [self._generator(seed + i) for i in range(self.num_slots)]
        self._last_token = np.zeros(self.num_slots, np.int64)
        self._temp = np.zeros(self.num_slots, np.float32)
        self._topk = np.zeros(self.num_slots, np.int64)
        # slots mid-chunked-prefill are kv-active but not decode-ready: the
        # step masks them to scratch until their K/V is committed
        self._decode_ready = np.zeros(self.num_slots, bool)
        self._pending: List[Dict[str, Any]] = []  # chunked-prefill states
        # wave scheduling: each stage's output activation of the last tick
        # (the carry the next stage picks up), the tick counter, and which
        # slots ride each in-flight wave
        self._x_carry: List[Optional[torch.Tensor]] = [None] * self._pp
        self._tick = 0
        self._wave_inflight: Dict[int, List[int]] = (
            {w: [] for w in range(self._pp)} if self._pp_wave else {})
        self._lock = threading.Lock()
        self._steps = 0
        self._tokens_out = 0
        self._prefills = 0
        self._spec_steps = 0
        self._spec_slot_steps = 0   # per-slot participations in spec steps
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_draft_ms = 0.0
        self._spec_verify_ms = 0.0
        # hot-swap state (guarded by self._lock): a prepared-but-unapplied
        # (params, version) waiting for a drained token boundary
        self._pending_swap: Optional[Tuple[Any, int]] = None
        self._serving_version = 0  # 0 = ctor weights
        self._swaps = 0
        # expected signatures: one per prefill bucket + decode + suffix
        # chunk (+ a wave stage each); speculation adds draft + verify, and
        # an external draft its own prefill ladder — all run in warmup
        spec_shapes = 0
        if self.spec_k:
            spec_shapes = 2 + (len(self.prefill_buckets)
                               if self._draft_model is not None else 0)
        self.recompile_guard = RecompileGuard(
            name="serving.decode",
            warn_after=len(self.prefill_buckets) + 2
            + (self._pp if self._pp_wave else 0) + spec_shapes)
        for fn in ("_decode", "_prefill_bucket", "_suffix_chunk",
                   "_wave_stage", "_self_draft", "_ext_draft", "_verify",
                   "_draft_forward"):
            setattr(self, fn, self.recompile_guard.wrap(getattr(self, fn)))
        self._aot_compiles = 0
        # cold start: the kernel library from the store before any launch
        self.exec_store = None
        self.boot = None
        if executable_dir is not None:
            self.exec_store = ExecutableStore(executable_dir,
                                              metrics=self.metrics)
            self.boot = boot_kernels(self.exec_store, None, self.device)
        if warmup:
            self.warmup()

    # -- set-up ----------------------------------------------------------------

    def _init_mesh(self, mesh, sharding) -> None:
        """Validate ``mesh`` / ``sharding`` (the JAX engine's rules and
        messages) and lay out the stages and their tp shards: shard ``t`` of
        stage ``s`` on card ``(s * tp + t) % device_count`` (the serving
        rule, :mod:`..parallel.mesh`), or the CPU; under ``ep`` expert
        shard ``e`` on card ``(e * tp) % device_count``."""
        from ..parallel.mesh import as_mesh, expert_grid, serving_grid
        from ..sharding import as_sharding_config
        model = self.model
        self.mesh = as_mesh(mesh)
        self.sharding = None
        self._tp_axis: Optional[str] = None
        self._ep_axis: Optional[str] = None
        self._pp_axis: Optional[str] = None
        self._tp = self._ep = self._pp = 1
        if sharding is not None:
            self.sharding = as_sharding_config(sharding)
            if self.mesh is None and self.sharding.model_parallel():
                raise ValueError("sharding names tp_axis/ep_axis/pp_axis but "
                                 "no mesh was given; pass mesh= to "
                                 "DecodeEngine")
        if self.mesh is not None and self.sharding is not None:
            self.sharding.validate(self.mesh, require_data_axis=False)
            tp_ax, ep_ax = self.sharding.tp_axis, self.sharding.ep_axis
            pp_ax = self.sharding.pp_axis
            if tp_ax and int(self.mesh.shape[tp_ax]) > 1:
                self._tp_axis, self._tp = tp_ax, int(self.mesh.shape[tp_ax])
            if ep_ax and int(self.mesh.shape[ep_ax]) > 1:
                self._ep_axis, self._ep = ep_ax, int(self.mesh.shape[ep_ax])
            if pp_ax and int(self.mesh.shape[pp_ax]) > 1:
                self._pp_axis, self._pp = pp_ax, int(self.mesh.shape[pp_ax])
        if self._tp > 1 and int(model.num_heads) % self._tp:
            raise ValueError(f"num_heads={model.num_heads} is not divisible "
                             f"by tp={self._tp}")
        if self._ep > 1:
            n_exp = getattr(model, "num_experts", None)
            if not n_exp:
                raise ValueError("ep_axis is set but the model has no expert "
                                 "bank (num_experts); use a transformer_moe_lm")
            if int(n_exp) % self._ep:
                raise ValueError(f"num_experts={n_exp} is not divisible by "
                                 f"ep={self._ep}")
        if self._pp > 1 and self._ep > 1:
            raise ValueError(
                "pp_axis does not compose with ep_axis: expert dispatch "
                "reduces inside the block body, which the staged no-cond "
                "schedule would re-run on every stage. Shard depth (pp) "
                "x width (tp) instead.")
        if self._pp > 1:
            if int(model.num_layers) % self._pp:
                raise ValueError(
                    f"num_layers={model.num_layers} is not divisible by "
                    f"pp={self._pp}: each pipeline stage must hold the same "
                    f"number of blocks")
            for need in ("decode_embed", "block_decode", "decode_head"):
                if not hasattr(model, need):
                    raise TypeError(
                        f"pipeline-parallel decode needs the model to expose "
                        f"stage-level pieces ({need}()); use a "
                        f"transformer_lm")
        if (self._tp * self._ep * self._pp > 1
                and not hasattr(model, "param_pspecs")):
            raise TypeError("model-parallel decode needs the model to "
                            "publish param_pspecs() (megatron rules)")
        self._per = int(model.num_layers) // self._pp
        self._stage_devices = [serving_grid(1, self._tp, self.device, s,
                                            ep=self._ep)[0]
                               for s in range(self._pp)]
        self._expert_devices = expert_grid(1, self._tp, self._ep,
                                           self.device)[0]
        self._devices = self._stage_devices[0]
        self._lm = (_Stages(model, self._per, self.device) if self._pp > 1
                    else model)

    def _prepare_params(self, tree):
        """One standard-layout tree -> this engine's serving placement: under
        tp the qkv columns packed in ``(tp, 3, H/tp, d)`` order and one slice
        per shard on its device (the row-parallel biases whole, added once
        after the sum); under ep each expert bank an ``EPShards``; under pp one tree a stage (:class:`_Stages`): its
        blocks and a copy of the shared leaves on its devices. The ctor and
        every hot swap run exactly this path, outside the lock."""
        if self._pp > 1:
            return [self._stage_tree(tree, s) for s in range(self._pp)]
        if self._tp * self._ep <= 1:
            return tree
        from ..parallel.tp import serving_pspecs, serving_tree
        return serving_tree(self.model, tree, serving_pspecs(
            self.model, self.mesh, self._tp_axis, self._ep_axis),
            self._tp_axis, self._devices, self._ep_axis,
            self._expert_devices)

    def _stage_tree(self, tree, s: int):
        """Stage ``s``'s serving tree: ``{"blocks": [its blocks, tp-split
        under tp], "shared": {embed, final_ln}, "device"}``."""
        per, devs = self._per, self._stage_devices[s]
        names = [f"block_{s * per + j}" for j in range(per)]
        sub = {k: v for k, v in tree.items() if not k.startswith("block_")}
        sub.update({n: tree[n] for n in names})
        if self._tp > 1:
            from ..parallel.tp import serving_pspecs, serving_tree
            specs = serving_pspecs(self.model, self.mesh, self._tp_axis)
            sub = serving_tree(self.model, sub, specs, self._tp_axis, devs)
        else:
            sub = {k: {n: t.to(devs[0]) for n, t in v.items()}
                   for k, v in sub.items()}
        return {"blocks": [sub.pop(n) for n in names], "shared": sub,
                "device": devs[0]}

    def _pools(self):
        """The K/V pools as the model's ``cache`` argument: each shard's
        ``(k, v)`` (one without tp), the model hands shard ``s`` its own;
        under pp one such cache a stage."""
        return self._cache(self._stage_pools)

    def _cache(self, stage_pools):
        """A cache argument from per-stage lists of per-shard pools."""
        caches = [TPShards(st) for st in stage_pools]
        return caches if self._pp > 1 else caches[0]

    def _init_spec(self, spec_k, draft_layers, draft_model,
                   draft_params) -> None:
        """Validate the speculative-decoding options (the JAX engine's
        rules and messages)."""
        model = self.model
        self.spec_k = int(spec_k or 0)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self.draft_layers: Optional[int] = None
        self._draft_model = None
        self._draft_params = None
        if not self.spec_k:
            if draft_model is not None or draft_layers:
                raise ValueError(
                    "draft_model / draft_layers require spec_k >= 1")
            return
        if draft_model is None:
            n = (int(draft_layers) if draft_layers
                 else max(1, int(model.num_layers) // 2))
            if not 1 <= n <= int(model.num_layers):
                raise ValueError(
                    f"draft_layers={n} outside [1, {model.num_layers}]")
            if self._pp > 1 and n % self._per:
                raise ValueError(
                    f"draft_layers={n} must be a whole number of "
                    f"pipeline stages (stage depth = {self._per}) so the "
                    f"self-speculation chain exits at a stage boundary")
            self.draft_layers = n
            return
        if isinstance(draft_model, str):
            from ..models import model_from_json
            draft_model = model_from_json(draft_model, device=self.device)
        for need in ("prefill", "decode_step"):
            if not hasattr(draft_model, need):
                raise TypeError(f"draft_model has no {need}(); it must be a "
                                f"causal LM")
        if int(draft_model.vocab_size) != int(model.vocab_size):
            raise ValueError(
                f"draft vocab_size={draft_model.vocab_size} != target "
                f"vocab_size={model.vocab_size}")
        if draft_params is None:
            raise ValueError("draft_model requires draft_params")
        if draft_model.device != self.device:
            raise ValueError(f"draft_model is on {draft_model.device}, the "
                             f"engine on {self.device}")
        self._draft_model = draft_model
        self._draft_params = params_tree(draft_model, draft_params, self.device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def warmup(self) -> None:
        """Build the CUDA kernels ahead of the first request (on the card),
        run every device entry point once at each shape the engine serves
        (then the recompile guard is marked steady) and, for a quantized
        pool, measure ``kv_quant_error``. Idempotent."""
        if self.device.type == "cuda":
            from ..ops import _build
            _build.load()
        with self._lock, torch.inference_mode():
            if not self._aot_compiles:
                self._warm_locked()
                self._aot_compiles = self.recompile_guard.traces
                self.recompile_guard.mark_steady()
            if self._quantized and self._kv_quant_error is None:
                self._kv_quant_error_probe_locked()

    def _warm_locked(self) -> None:
        """Each guarded entry point once per shape, with the operands' dtypes
        of the serving path and every write aimed at scratch page 0 (all
        lanes idle: position 0, table 0, no room). Scratch page 0 holds
        whatever the padding last wrote, and an MoE model's idle lanes
        read it, so it is saved and restored: warmup leaves no trace in
        the tokens."""
        B, K, dev = self.num_slots, self.spec_k, self.device
        saved = [t[:, 0].clone() for t in self._pool_tensors()]
        table = np.zeros_like(self.kv.page_tables())
        zeros = np.zeros(B, np.int64)
        try:
            for b in self.prefill_buckets:
                with annotate(f"serving/decode_compile_prefill_b{b}"):
                    self._prefill_bucket(
                        np.zeros((1, b), np.int64), 1,
                        np.zeros(b // self.page_size, np.int64))
            with annotate("serving/decode_compile_step"):
                self._decode(zeros, zeros, table)
            with annotate("serving/decode_compile_suffix"):
                self._suffix_chunk(np.zeros((1, self._chunk_width), np.int64),
                                   0, 1, table[0])
            if self._pp_wave:
                W = B // self._pp
                pos_w = torch.zeros(W, dtype=torch.int64)
                x = torch.zeros(W, dtype=torch.int64)
                with annotate("serving/decode_compile_wave_tick"):
                    for st in range(self._pp):
                        d = self._params[st]["device"]
                        x = self._wave_stage(
                            st, x.to(d), pos_w.to(d),
                            torch.as_tensor(table[:W], dtype=torch.int32,
                                            device=d))
            if K:
                tok = torch.zeros(B, dtype=torch.int64, device=dev)
                table_t = torch.as_tensor(table, dtype=torch.int32,
                                          device=dev)
                with annotate("serving/decode_compile_draft"):
                    if self._draft_model is None:
                        self._self_draft(tok, tok, table_t, tok)
                    else:
                        self._ext_draft(tok, tok, torch.zeros(
                            B, dtype=torch.bool, device=dev))
                with annotate("serving/decode_compile_verify"):
                    self._verify(torch.zeros((B, K + 1), dtype=torch.int64,
                                             device=dev), tok, tok, table_t)
                if self._draft_model is not None:
                    for b in self.prefill_buckets:
                        with annotate(
                                f"serving/decode_compile_draft_prefill_b{b}"):
                            self._draft_forward(np.zeros((1, b), np.int64),
                                                1)
        finally:
            for t, page0 in zip(self._pool_tensors(), saved):
                t[:, 0] = page0

    def _kv_quant_error_probe_locked(self) -> None:
        """The ``decode/kv_quant_error`` gauge: prefill one synthetic
        page-length prompt, commit its K/V to two throwaway pools (the
        compute dtype and the quantized layout), run one decode step through
        each and record the largest absolute logit difference. The serving
        pools are untouched. A failure raises — on the card this runs the
        paged kernels."""
        model, page = self.model, self.page_size
        dev = self.device
        store, _ = quant.kv_pool_dtype(self.kv_quant)
        ref_dt = model.compute_dtype or torch.float32
        rng = np.random.default_rng(0)
        ids = torch.as_tensor(rng.integers(0, model.vocab_size, (1, page)),
                              device=dev)
        logits, kvs = self._lm.prefill(
            self._params, ids, lengths=torch.as_tensor([page], device=dev))
        L = self._per
        refs, quants = [], []   # a stage's shards' pools
        for st, devs in enumerate(self._stage_devices):
            refs.append([])
            quants.append([])
            for s, d_s in enumerate(devs):
                k0 = _shard(kvs[0][0], s)
                h, d = k0.shape[1], k0.shape[3]
                shape = (L, 3, page, h, d)
                kr = torch.zeros(shape, dtype=ref_dt, device=d_s)
                vr = torch.zeros(shape, dtype=ref_dt, device=d_s)
                kq = (torch.zeros(shape, dtype=store, device=d_s),
                      torch.zeros((L, 3, h), device=d_s))
                vq = (torch.zeros(shape, dtype=store, device=d_s),
                      torch.zeros((L, 3, h), device=d_s))
                pid = torch.tensor([1], device=d_s)
                for i, (ks, vs) in enumerate(kvs[st * L:(st + 1) * L]):
                    # [1, page, h, d]
                    kk = _shard(ks, s)[0].transpose(0, 1)[None].to(d_s)
                    vv = _shard(vs, s)[0].transpose(0, 1)[None].to(d_s)
                    kr[i, pid] = kk.to(ref_dt)
                    vr[i, pid] = vv.to(ref_dt)
                    quant.paged_quant_write_pages(kq[0], kq[1], i, pid, kk)
                    quant.paged_quant_write_pages(vq[0], vq[1], i, pid, vv)
                refs[-1].append((kr, vr))
                quants[-1].append((kq, vq))
        table = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
        tok = logits.argmax(dim=-1)
        pos = torch.tensor([page], device=dev)
        pids, off = table[0, pos // page].long(), pos % page

        def attend_ref(layer, q, k_new, v_new, cache, p):
            kp, vp = cache
            d_q = q.device
            kp[layer, pids.to(d_q), off.to(d_q)] = k_new.to(kp.dtype)
            vp[layer, pids.to(d_q), off.to(d_q)] = v_new.to(vp.dtype)
            out = paged_attention(q, kp[layer], vp[layer], table.to(d_q),
                                  (p + 1).to(torch.int32))
            return out.to(q.dtype), cache

        def attend_q(layer, q, k_new, v_new, cache, p):
            kp, vp = cache
            d_q = q.device
            pid, of = pids.to(d_q), off.to(d_q)
            quant.paged_quant_append(kp[0], kp[1], layer, pid, of, k_new)
            quant.paged_quant_append(vp[0], vp[1], layer, pid, of, v_new)
            out = paged_attention(q, kp[0][layer], vp[0][layer],
                                  table.to(d_q), (p + 1).to(torch.int32),
                                  k_scales=kp[1][layer],
                                  v_scales=vp[1][layer])
            return out.to(q.dtype), cache

        lg_ref, _ = self._lm.decode_step(self._params, self._cache(refs),
                                         tok, pos, attend=attend_ref)
        lg_q, _ = self._lm.decode_step(self._params, self._cache(quants),
                                       tok, pos, attend=attend_q)
        err = float((lg_q.float() - lg_ref.float()).abs().max())
        self._kv_quant_error = err
        self.metrics.gauge("decode/kv_quant_error", err)

    # -- pool layout ------------------------------------------------------------
    #
    # With kv_quant on, each pool is a (rows int8/fp8, scales f32) pair;
    # these keep the attend closures layout-agnostic. All writes are in place.

    def _scratch_src(self, pids, offs=None):
        """For writes at ``(pids, offs)`` (``offs`` None: whole pages), the
        row each write takes so that every write aimed at scratch page 0
        carries the row of the LAST lane writing the same place — what a
        sequential scatter (the CPU's, XLA's) keeps; a CUDA ``index_put_``
        keeps an arbitrary one of several rows written to one place. Only
        an MoE model needs it: a lane past its room (a clamped spec window,
        a prompt's padding) attends over scratch rows, and its hidden state
        claims expert capacity like a live token's, so an arbitrary pick
        would make the live tokens vary run to run; in a dense model only
        that lane's own, discarded output reads them. None where nothing
        needs resolving. One index serves every layer and both K and V of
        a forward call."""
        flat = pids.reshape(-1).long()
        n = flat.numel()
        if not self._routes or n < 2:
            return None
        order = torch.arange(n, device=flat.device)
        scratch = flat == 0
        at = (torch.zeros_like(flat) if offs is None
              else offs.reshape(-1).long())
        last = torch.full((self.page_size,), -1, dtype=torch.long,
                          device=flat.device).scatter_reduce(
            0, at, torch.where(scratch, order, -1), "amax")
        return torch.where(scratch, last[at], order)

    @staticmethod
    def _take(rows, src, lead: int):
        """``rows`` (``lead`` batch dims first) re-picked by ``src``."""
        if src is None:
            return rows
        flat = rows.reshape((-1,) + tuple(rows.shape[lead:]))
        return flat[src.to(rows.device)].reshape(rows.shape)

    def _kv_rows(self, pool, layer, pids, offs, rows, src=None) -> None:
        """Write token rows at ``(layer, pids, offs)``, any batch shape;
        a quantized pool keeps its running per-page-per-head scale.
        ``src``: the forward call's :meth:`_scratch_src`."""
        rows = self._take(rows, src, pids.dim())
        if self._quantized:
            quant.paged_quant_append(pool[0], pool[1], layer, pids, offs, rows)
        else:
            pool[layer, pids, offs] = rows.to(pool.dtype)

    def _kv_pages(self, pool, layer, page_ids, pages, src=None) -> None:
        """Commit whole pages at ``(layer, page_ids)`` (ladder prefill; the
        padding's pages aim at scratch page 0, resolved by ``src``, the
        call's :meth:`_scratch_src`)."""
        pages = self._take(pages, src, page_ids.dim())
        if self._quantized:
            quant.paged_quant_write_pages(pool[0], pool[1], layer, page_ids,
                                          pages)
        else:
            pool[layer, page_ids] = pages.to(pool.dtype)

    def _kv_gather(self, pool, layer, page_ids) -> torch.Tensor:
        """Pages as float32 rows ``[..., page, heads, d]``, dequantizing the
        gathered pages only."""
        if self._quantized:
            return quant.paged_quant_gather(pool[0], pool[1], layer, page_ids)
        return pool[layer, page_ids].float()

    def _paged_att(self, q, kp, vp, layer, table, lengths):
        if self._quantized:
            return paged_attention(q, kp[0][layer], vp[0][layer], table,
                                   lengths, k_scales=kp[1][layer],
                                   v_scales=vp[1][layer])
        return paged_attention(q, kp[layer], vp[layer], table, lengths)

    def _paged_verify_att(self, q, kp, vp, layer, table, start):
        if self._quantized:
            return paged_attention_verify(q, kp[0][layer], vp[0][layer],
                                          table, start, k_scales=kp[1][layer],
                                          v_scales=vp[1][layer])
        return paged_attention_verify(q, kp[layer], vp[layer], table, start)

    def _pool_tensors(self, shards=None):
        """Every device tensor of the K and V pools (rows, and scales), of
        every tp shard or of ``shards``."""
        pools = [p for pair in (self._shard_pools if shards is None
                                else shards) for p in pair]
        return [t for p in pools for t in (p if self._quantized else (p,))]

    # -- device pieces -----------------------------------------------------------

    def _sample(self, logits: torch.Tensor, slots: Sequence[int],
                temp: np.ndarray, topk: np.ndarray) -> np.ndarray:
        """Greedy lanes take the argmax; ``temp > 0`` lanes draw from the
        temperature-scaled softmax, restricted to the top-k logits when
        ``topk > 0``, with their slot's generator. Returns host int64."""
        tok = logits.argmax(dim=-1)
        hot = [i for i in range(len(slots)) if temp[i] > 0]
        if hot:
            tok = tok.clone()
            for i in hot:
                lg = logits[i]
                k = int(min(topk[i], self.max_top_k))
                if k > 0:
                    thr = torch.topk(lg, k).values[-1]
                    lg = torch.where(lg < thr, NEG_INF, lg)
                probs = torch.softmax(lg / float(temp[i]), dim=-1)
                tok[i] = torch.multinomial(probs, 1,
                                           generator=self._gens[slots[i]])[0]
        return tok.cpu().numpy()

    def _decode_attend(self, pos_t: torch.Tensor, table_t: torch.Tensor):
        """The decode step's ``attend`` for lanes at ``pos_t`` over the
        table rows ``table_t``: write each lane's new K/V row into its page,
        attend over the pool through the table."""
        page = self.page_size
        bidx = torch.arange(pos_t.shape[0], device=pos_t.device)
        page_ids = table_t[bidx, pos_t // page].long()
        off = pos_t % page
        lengths = (pos_t + 1).to(torch.int32)

        def attend(layer, q, k_new, v_new, cache, _pos):
            kp, vp = cache
            d = q.device      # a tp shard's (a stage's) device
            pid, of = page_ids.to(d), off.to(d)
            self._kv_rows(kp, layer, pid, of, k_new)
            self._kv_rows(vp, layer, pid, of, v_new)
            out = self._paged_att(q, kp, vp, layer, table_t.to(d),
                                  lengths.to(d))
            return out.to(q.dtype), cache

        return attend

    def _decode(self, token: np.ndarray, pos: np.ndarray,
                table: np.ndarray) -> torch.Tensor:
        """One token for every lane: write each lane's new K/V row into its
        page, attend over the pool through the page table; returns logits
        [num_slots, vocab] f32."""
        dev = self.device
        token_t = torch.as_tensor(token, device=dev)
        pos_t = torch.as_tensor(pos, dtype=torch.int64, device=dev)
        table_t = torch.as_tensor(table, dtype=torch.int32, device=dev)
        logits, _ = self._lm.decode_step(
            self._params, self._pools(), token_t, pos_t,
            attend=self._decode_attend(pos_t, table_t))
        return logits

    def _prefill_bucket(self, ids: np.ndarray, n: int,
                        page_ids: np.ndarray) -> torch.Tensor:
        """Ladder prefill of one padded prompt; commits every block's K/V
        into ``page_ids`` (pads -> scratch page 0). Returns [1, vocab]."""
        dev, page = self.device, self.page_size
        npages = ids.shape[1] // page
        logits, kvs = self._lm.prefill(
            self._params, torch.as_tensor(ids, device=dev),
            lengths=torch.as_tensor([n], device=dev))
        pid = torch.as_tensor(page_ids, dtype=torch.int64, device=dev)
        src = self._scratch_src(pid)
        for layer, (ks, vs) in enumerate(kvs):
            # a stage's pools hold its layers, at stage-local indices
            st, i = divmod(layer, self._per)
            for s, (kp, vp) in enumerate(self._stage_pools[st]):
                k, v = _shard(ks, s), _shard(vs, s)
                # [1, heads, bucket, d] -> [npages, page, heads, d]
                kk = k[0].transpose(0, 1).reshape(npages, page, k.shape[1],
                                                  k.shape[3])
                vv = v[0].transpose(0, 1).reshape(npages, page, v.shape[1],
                                                  v.shape[3])
                p = pid.to(k.device)
                self._kv_pages(kp, i, p, kk, src)
                self._kv_pages(vp, i, p, vv, src)
        return logits

    def _suffix_chunk(self, ids: np.ndarray, start: int, valid: int,
                      ctable: np.ndarray) -> torch.Tensor:
        """Forward one ``_chunk_width``-token chunk of a prompt whose first
        ``start`` tokens' K/V is committed in the slot's pages: write the
        chunk's K/V into those pages and attend over the whole history
        through the table row ``ctable`` (plain torch; chunks are per-slot
        events). Returns the last valid position's logits [1, vocab]."""
        model, dev = self.model, self.device
        page, C = self.page_size, self._chunk_width
        maxp = self.max_pages_per_slot
        scale = 1.0 / math.sqrt(model.head_dim)
        j = torch.arange(C, device=dev)
        tpos = torch.arange(maxp * page, device=dev)
        row = torch.as_tensor(ctable, dtype=torch.int64, device=dev)
        pos_abs = start + j
        pids = row[(pos_abs // page).clamp(0, maxp - 1)]
        pids = torch.where(j < valid, pids, 0)              # pad -> scratch
        off = pos_abs % page
        src = self._scratch_src(pids, off)
        causal = tpos[None, :] <= pos_abs[:, None]          # [C, L]

        def attend(layer, q, k_new, v_new, cache, _start):
            kp, vp = cache
            d = q.device      # a tp shard's device
            pid, of, rw = pids.to(d), off.to(d), row.to(d)
            self._kv_rows(kp, layer, pid, of, k_new[0].transpose(0, 1), src)
            self._kv_rows(vp, layer, pid, of, v_new[0].transpose(0, 1), src)
            hk = self._kv_gather(kp, layer, rw).reshape(maxp * page, -1,
                                                        model.head_dim)
            hv = self._kv_gather(vp, layer, rw).reshape(maxp * page, -1,
                                                        model.head_dim)
            s = torch.einsum("hcd,lhd->hcl", q[0].float(), hk) * scale
            s = torch.where(causal.to(d)[None], s, NEG_INF)
            p = torch.softmax(s, dim=-1)
            out = torch.einsum("hcl,lhd->hcd", p, hv)
            return out[None].to(q.dtype), cache

        logits, _ = self._lm.prefill_suffix(
            self._params, torch.as_tensor(ids, device=dev),
            torch.as_tensor([start], device=dev), self._pools(), attend,
            lengths=torch.as_tensor([valid], device=dev))
        return logits

    def _self_draft(self, token, start, table, nappend) -> torch.Tensor:
        """Self-speculation: a ``spec_k``-step greedy chain through the
        target's first ``draft_layers`` blocks, reading and writing the same
        paged pool the verify pass uses — a truncated stack's layer-i K/V is
        the full stack's, and the verify pass rewrites every chunk position
        anyway. Writes past a slot's appended room go to scratch page 0.
        Returns the drafts [B, spec_k]."""
        page, maxp = self.page_size, self.max_pages_per_slot
        bidx = torch.arange(self.num_slots, device=self.device)
        writable = start + nappend         # first position with no room
        pools = self._pools()
        toks, tok = [], token
        for j in range(self.spec_k):
            pos = start + j
            pids = table[bidx, (pos // page).clamp(0, maxp - 1)].long()
            pids = torch.where(pos < writable, pids, 0)
            off = pos % page
            lengths = (pos + 1).to(torch.int32)
            src = self._scratch_src(pids, off)

            def attend(layer, q, k_new, v_new, cache, _pos, pids=pids,
                       off=off, lengths=lengths, src=src):
                kp, vp = cache
                d = q.device      # a tp shard's device
                pid, of = pids.to(d), off.to(d)
                self._kv_rows(kp, layer, pid, of, k_new, src)
                self._kv_rows(vp, layer, pid, of, v_new, src)
                out = self._paged_att(q, kp, vp, layer, table.to(d),
                                      lengths.to(d))
                return out.to(q.dtype), cache

            logits, _ = self._lm.decode_step(
                self._params, pools, tok, pos, attend=attend,
                num_layers=self.draft_layers)
            tok = logits.argmax(dim=-1)
            toks.append(tok)
        return torch.stack(toks, dim=1)

    def _ext_draft(self, token, start, live) -> torch.Tensor:
        """External draft: the draft model's greedy ``spec_k`` steps over its
        own dense per-slot cache (plain torch attention, as in the JAX
        engine). Rejected positions leave stale rows behind that the next
        chain overwrites before anything attends to them; dead lanes write
        to the cache's margin row. Returns the drafts [B, spec_k]."""
        dm = self._draft_model
        CL = self._draft_cache_len
        bidx = torch.arange(self.num_slots, device=self.device)
        scale = 1.0 / math.sqrt(dm.head_dim)
        lpos = torch.arange(CL, device=self.device)

        def attend(layer, q, k_new, v_new, cache, p):
            ck, cv = cache
            p_eff = torch.where(live, p, CL - 1)
            ck[layer][bidx, :, p_eff] = k_new.to(ck.dtype)
            cv[layer][bidx, :, p_eff] = v_new.to(cv.dtype)
            s = torch.einsum("bhd,bhld->bhl", q.float(),
                             ck[layer].float()) * scale
            ok = lpos[None, :] <= p[:, None]
            s = torch.where(ok[:, None, :], s, NEG_INF)
            pr = torch.softmax(s, dim=-1)
            out = torch.einsum("bhl,bhld->bhd", pr, cv[layer].float())
            return out.to(q.dtype), cache

        toks, tok = [], token
        for j in range(self.spec_k):
            logits, _ = dm.decode_step(self._draft_params,
                                       (self._draft_k, self._draft_v), tok,
                                       start + j, attend=attend)
            tok = logits.argmax(dim=-1)
            toks.append(tok)
        return torch.stack(toks, dim=1)

    def _verify(self, ids, start, nvalid, table) -> torch.Tensor:
        """One target call scoring all ``spec_k + 1`` chunk positions of
        every slot: write the chunk's K/V into the slots' pages (positions
        past ``nvalid`` -> scratch), attend causally per query over the
        whole table (:func:`paged_attention_verify`). Returns the logits
        [B, spec_k + 1, vocab] f32."""
        page, maxp = self.page_size, self.max_pages_per_slot
        dev = self.device
        j = torch.arange(self.spec_k + 1, device=dev)
        bidx = torch.arange(self.num_slots, device=dev)
        pos_abs = start[:, None] + j[None, :]                    # [B, S]
        pids = table[bidx[:, None], (pos_abs // page).clamp(0, maxp - 1)]
        pids = torch.where(j[None, :] < nvalid[:, None], pids.long(), 0)
        off = pos_abs % page
        src = self._scratch_src(pids, off)
        start32 = start.to(torch.int32)

        def attend(layer, q, k_new, v_new, cache, _st):
            kp, vp = cache
            d = q.device      # a tp shard's device
            pid, of = pids.to(d), off.to(d)
            self._kv_rows(kp, layer, pid, of, k_new.transpose(1, 2), src)
            self._kv_rows(vp, layer, pid, of, v_new.transpose(1, 2), src)
            out = self._paged_verify_att(q, kp, vp, layer, table.to(d),
                                         start32.to(d))
            return out.to(q.dtype), cache

        logits, _ = self._lm.decode_verify(
            self._params, ids, start, self._pools(), attend)
        return logits

    def _copy_pages(self, src: int, dst: int) -> None:
        """Rollback COW un-alias: clone pool page ``src`` into ``dst`` in
        every layer — the rows and, quantized, the scales."""
        for t in self._pool_tensors():
            t[:, dst] = t[:, src]

    # -- admission / prefill -------------------------------------------------

    def can_admit(self, prompt_len: int, max_new_tokens: int,
                  prompt: Optional[Sequence[int]] = None) -> bool:
        """Token-boundary admission check: a free slot exists and the pool
        can reserve the request's worst case (less any indexed prefix pages
        when the actual ``prompt`` is given and prefix caching is on)."""
        if not (1 <= prompt_len <= self.max_prompt_len):
            return False
        total = prompt_len + max(1, int(max_new_tokens))
        if total > self.max_seq_len:
            return False
        with self._lock:
            if (self._pending_swap is not None
                    and not self._maybe_swap_locked()):
                return False
        return self.kv.can_admit(
            total, list(prompt) if (prompt is not None
                                    and self.prefix_cache) else None)

    def prefill(self, prompt: Sequence[int], *, max_new_tokens: int = 32,
                temperature: float = 0.0, top_k: int = 0,
                seed: Optional[int] = None) -> Dict[str, Any]:
        """Admit one sequence: allocate a slot + pages (mapping any indexed
        shared prefix into the table), prefill what isn't shared — the
        bucket ladder for cold prompts, suffix chunks for prefix hits — and
        sample the first token. With chunked prefill and a suffix longer
        than ``prefill_chunk`` the call returns at once with
        ``token=None``; the first token surfaces from :meth:`step`.

        Returns ``{"slot", "token", "prompt_len", "shared_tokens",
        "chunked"}``; raises :class:`OutOfPages` when the request cannot be
        admitted right now (backpressure)."""
        prompt = [int(t) for t in prompt]
        n = len(prompt)
        if not 1 <= n <= self.max_prompt_len:
            raise ValueError(f"prompt length {n} outside [1, "
                             f"{self.max_prompt_len}]")
        total = n + max(1, int(max_new_tokens))
        if total > self.max_seq_len:
            raise ValueError(f"prompt + max_new_tokens = {total} exceeds "
                             f"max_seq_len={self.max_seq_len}")
        with self._lock, torch.inference_mode():
            if (self._pending_swap is not None
                    and not self._maybe_swap_locked()):
                raise SwapPending("weight swap pending at token boundary")
            slot = self.kv.free_slot()
            if slot is None:
                raise OutOfPages("no free decode slot")
            shared_pages, _saved = self.kv.alloc(
                slot, prompt if self.prefix_cache else n, total)
            try:
                t0 = time.perf_counter()
                start = shared_pages * self.page_size  # first un-shared pos
                self._temp[slot] = float(temperature)
                self._topk[slot] = min(int(top_k), self.max_top_k)
                self._decode_ready[slot] = False
                if seed is not None:
                    self._gens[slot] = self._generator(seed)
                self._prefills += 1
                self.metrics.observe("serving/decode/prompt_tokens", n)
                if (self.prefill_chunk is not None
                        and n - start > self.prefill_chunk):
                    self._pending.append({"slot": int(slot),
                                          "prompt": prompt,
                                          "next": start, "end": n,
                                          "seed": seed, "t0": t0})
                    return {"slot": int(slot), "token": None,
                            "prompt_len": n, "shared_tokens": start,
                            "chunked": True}
                if start == 0:
                    bucket = next(b for b in self.prefill_buckets if n <= b)
                    ids = np.zeros((1, bucket), np.int64)
                    ids[0, :n] = prompt
                    page_ids = np.zeros(bucket // self.page_size, np.int64)
                    held = self.kv.pages_for(n, self.page_size)
                    page_ids[:held] = self.kv.page_tables()[slot, :held]
                    with obs_span("serving/decode_prefill",
                                  args={"bucket": bucket, "slot": int(slot)},
                                  profiler_annotation=True):
                        logits = self._prefill_bucket(ids, n, page_ids)
                else:
                    logits = self._suffix_prefill_locked(slot, prompt,
                                                         start, n)
                if self.prefix_cache:
                    self.kv.commit_prefix(slot, prompt)  # K/V on device now
                if self._draft_model is not None:
                    # the draft keeps its own cache, so a prefix hit on the
                    # target side still needs a full draft prefill
                    self._draft_prefill_locked(slot, prompt)
                first = int(self._sample(logits, [slot],
                                         self._temp[[slot]],
                                         self._topk[[slot]])[0])
                self._last_token[slot] = first
                self._decode_ready[slot] = True
                self.metrics.observe("serving/decode/prefill_ms",
                                     (time.perf_counter() - t0) * 1000.0)
            except BaseException:
                # a prefill that dies after alloc must hand the slot's pages
                # back before the error propagates — the caller never learns
                # the slot id, so nobody else can release it
                self._release_locked(int(slot))
                raise
        return {"slot": int(slot), "token": first, "prompt_len": n,
                "shared_tokens": start, "chunked": False}

    def _suffix_prefill_locked(self, slot: int, prompt: List[int],
                               start: int, n: int) -> torch.Tensor:
        """Synchronous suffix prefill for a prefix-hit prompt, in
        ``_chunk_width`` pieces. Returns the final chunk's logits."""
        C = self._chunk_width
        row = self.kv.page_tables()[slot]
        logits = None
        p = start
        while p < n:
            c = min(C, n - p)
            ids = np.zeros((1, C), np.int64)
            ids[0, :c] = prompt[p:p + c]
            with obs_span("serving/decode_prefill_suffix",
                          args={"slot": int(slot), "start": int(p)},
                          profiler_annotation=True):
                logits = self._suffix_chunk(ids, p, c, row)
            p += c
        return logits

    def _draft_prefill_locked(self, slot: int, prompt: List[int]) -> None:
        """Fill the external draft's dense cache lane of ``slot``: one
        forward of the bucket-padded prompt through the draft model (padding
        rows past the prompt are overwritten by the first draft chain
        before anything attends to them)."""
        n = len(prompt)
        bucket = next(b for b in self.prefill_buckets if n <= b)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :n] = prompt
        with obs_span("serving/decode_draft_prefill",
                      args={"bucket": bucket, "slot": int(slot)},
                      profiler_annotation=True):
            kvs = self._draft_forward(ids, n)
            for i, (k, v) in enumerate(kvs):
                self._draft_k[i, slot, :, :bucket] = k[0].to(
                    self._draft_k.dtype)
                self._draft_v[i, slot, :, :bucket] = v[0].to(
                    self._draft_v.dtype)

    def _draft_forward(self, ids: np.ndarray, n: int):
        """The external draft's forward of one bucket-padded prompt: every
        block's K/V, ``[(k, v)]`` of ``[1, heads, bucket, d]``."""
        return self._draft_model.prefill(
            self._draft_params, torch.as_tensor(ids, device=self.device),
            lengths=torch.as_tensor([n], device=self.device))[1]

    # -- decode --------------------------------------------------------------

    def step(self) -> Dict[int, List[int]]:
        """One decode iteration over every decode-ready slot: append page
        room, run the step, return ``{slot: [tokens...]}`` — one token per
        slot, or up to ``spec_k + 1`` with speculation on (the accepted
        drafts and the target's bonus token, in order). A pending chunked
        prefill advances one chunk here, before a plain decode step (the
        speculative path stands down for that iteration); a slot whose final
        chunk just committed contributes its *first* token. No-op (empty
        dict) when nothing is active.

        With wave scheduling on (``pp_wave`` under a pp mesh) each call is
        one pipeline *tick*: roughly ``1/pp`` of the slots emit a token a
        call and a slot's next token arrives ``pp`` ticks after its entry.
        A pending chunked prefill drains the waves first, then runs the
        single-wave step."""
        with self._lock, torch.inference_mode():
            if self._pending_swap is not None:
                self._maybe_swap_locked()  # lands iff fully drained
            active = self.kv.active_slots()
            ready = np.asarray([int(s) for s in active
                                if self._decode_ready[s]], np.int64)
            state = self._pending[0] if self._pending else None
            if self._pp_wave and state is None:
                return self._wave_step_locked(ready)
            if ready.size == 0 and state is None:
                return {}
            if self.spec_k and state is None:
                return self._spec_step_locked(ready)
            t0 = time.perf_counter()
            pre: Dict[int, List[int]] = {}
            if self._pp_wave:
                # the chunk step runs the single-wave schedule: every
                # in-flight token lands before new page room is appended
                pre = self._drain_waves_locked()
                ready = np.asarray(
                    [int(s) for s in self.kv.active_slots()
                     if self._decode_ready[s]], np.int64)
            # the incoming token occupies position == current length: make
            # sure its page exists, then pass the PRE-append position
            for s in ready:
                self.kv.append(int(s))
            lengths = self.kv.lengths()
            table_full = self.kv.page_tables()
            # mask non-ready lanes (mid-chunked-prefill or idle) to scratch:
            # the step must not write into half-committed pages
            mask = np.zeros(self.num_slots, bool)
            mask[ready] = True
            pos = np.maximum(lengths - 1, 0).astype(np.int64)
            pos[~mask] = 0
            table = table_full.copy()
            table[~mask] = 0
            token = np.where(mask, self._last_token, 0).astype(np.int64)
            out: Dict[int, List[int]] = {}
            if state is not None:
                C = self._chunk_width
                p, end = state["next"], state["end"]
                c = min(C, end - p)
                ids = np.zeros((1, C), np.int64)
                ids[0, :c] = state["prompt"][p:p + c]
                with obs_span("serving/decode_fused_step",
                              args={"active": int(ready.size),
                                    "slot": state["slot"]},
                              profiler_annotation=True):
                    chunk_logits = self._suffix_chunk(
                        ids, p, c, table_full[state["slot"]])
                    logits = self._decode(token, pos, table)
                state["next"] = p + c
                if state["next"] >= end:  # final chunk: first token is born
                    self._pending.pop(0)
                    slot = state["slot"]
                    if self.prefix_cache:
                        self.kv.commit_prefix(slot, state["prompt"])
                    if self._draft_model is not None:
                        self._draft_prefill_locked(slot, state["prompt"])
                    if state["seed"] is not None:
                        self._gens[slot] = self._generator(state["seed"])
                    first = int(self._sample(chunk_logits, [slot],
                                             self._temp[[slot]],
                                             self._topk[[slot]])[0])
                    self._last_token[slot] = first
                    self._decode_ready[slot] = True
                    out[int(slot)] = [first]
                    self.metrics.observe(
                        "serving/decode/prefill_ms",
                        (time.perf_counter() - state["t0"]) * 1000.0)
            else:
                with obs_span("serving/decode_step",
                              args={"active": int(ready.size)},
                              profiler_annotation=True):
                    logits = self._decode(token, pos, table)
            if ready.size:
                tok = self._sample(logits[torch.as_tensor(ready, device=self.device)],
                                   list(ready), self._temp[ready],
                                   self._topk[ready])
                for s, t in zip(ready, tok):
                    self._last_token[s] = t
                    out[int(s)] = [int(t)]
            self._steps += 1
            self._tokens_out += len(out)
            dt_ms = (time.perf_counter() - t0) * 1000.0
            self.metrics.observe("serving/decode/step_ms", dt_ms)
            self.metrics.observe("serving/decode/step_active",
                                 int(ready.size))
            self.metrics.observe("serving/decode/token_latency_ms", dt_ms)
            for sl, ts in pre.items():
                # tokens harvested while draining the waves come first
                out[sl] = ts + out.get(sl, [])
        return out

    # -- wave scheduling (pp_wave) --------------------------------------------

    def _wave_step_locked(self, ready: np.ndarray) -> Dict[int, List[int]]:
        """One wave tick: admit this tick's entry wave (append page room for
        its ready slots), run every stage on its own wave and harvest the
        exit wave. A slot's wave is fixed by its lane (``slot //
        (num_slots / pp)``), so a freshly admitted slot waits at most ``pp -
        1`` ticks for its entry turn."""
        inflight = any(self._wave_inflight[w] for w in range(self._pp))
        if ready.size == 0 and not inflight:
            return {}
        t0 = time.perf_counter()
        W = self.num_slots // self._pp
        wn = self._tick % self._pp
        entry = [int(s) for s in ready if wn * W <= int(s) < (wn + 1) * W]
        for s in entry:
            self.kv.append(s)
        self._wave_inflight[wn] = entry
        with obs_span("serving/decode_wave_tick",
                      args={"tick": int(self._tick), "entry": len(entry)},
                      profiler_annotation=True):
            out = self._run_tick_locked()
        self._steps += 1
        dt_ms = (time.perf_counter() - t0) * 1000.0
        self.metrics.observe("serving/decode/step_ms", dt_ms)
        self.metrics.observe("serving/decode/step_active", int(ready.size))
        for _ in out:
            self.metrics.observe("serving/decode/token_latency_ms", dt_ms)
        return out

    def _run_tick_locked(self) -> Dict[int, List[int]]:
        """One tick over the in-flight waves: stage ``s`` runs wave ``(t -
        s) mod pp`` — stage 0 embeds its wave's tokens, every other stage
        continues the activation its predecessor left last tick — and the
        last stage's wave is sampled and harvested. A stage whose wave is
        empty does nothing. The operands are rebuilt every tick, which is
        safe mid-flight: a slot's length, table row and token change only
        at its entry (append) and its harvest (sample)."""
        B, PP = self.num_slots, self._pp
        W = B // PP
        t = self._tick
        inflight = sorted({s for lst in self._wave_inflight.values()
                           for s in lst})
        mask = np.zeros(B, bool)
        mask[inflight] = True
        lengths = self.kv.lengths()
        pos = np.maximum(lengths - 1, 0).astype(np.int64)
        pos[~mask] = 0
        table = self.kv.page_tables().copy()
        table[~mask] = 0
        token = np.where(mask, self._last_token, 0).astype(np.int64)
        carry: List[Optional[torch.Tensor]] = [None] * PP
        logits = None
        for s in range(PP):
            w = (t - s) % PP
            if not self._wave_inflight[w]:
                continue
            dev = self._params[s]["device"]
            lanes = slice(w * W, (w + 1) * W)
            inp = (torch.as_tensor(token[lanes], device=dev) if s == 0
                   else self._x_carry[s - 1].to(dev))
            out = self._wave_stage(
                s, inp, torch.as_tensor(pos[lanes], device=dev),
                torch.as_tensor(table[lanes], dtype=torch.int32, device=dev))
            if s == PP - 1:
                logits = out
            else:
                carry[s] = out
        self._x_carry = carry
        we = (t - (PP - 1)) % PP
        self._tick += 1
        exit_slots = self._wave_inflight[we]
        self._wave_inflight[we] = []
        out: Dict[int, List[int]] = {}
        if exit_slots:
            rows = torch.as_tensor([s - we * W for s in exit_slots],
                                   device=self.device)
            toks = self._sample(logits[rows], exit_slots,
                                self._temp[exit_slots],
                                self._topk[exit_slots])
            for s, tk in zip(exit_slots, toks):
                self._last_token[s] = tk
                out[s] = [int(tk)]
            self._tokens_out += len(exit_slots)
        return out

    def _wave_stage(self, s: int, inp: torch.Tensor, pos_t: torch.Tensor,
                    table_t: torch.Tensor) -> torch.Tensor:
        """Stage ``s``'s blocks over one wave's lanes: stage 0 embeds the
        token ids ``inp``, a later stage continues the activation ``inp``;
        returns the activation, or the logits at the last stage."""
        model, st = self.model, self._params[s]
        x = (model.decode_embed(st["shared"], inp, pos_t) if s == 0
             else inp)
        attend = self._decode_attend(pos_t, table_t)
        cache = self._pools()[s]
        for j, bp in enumerate(st["blocks"]):
            x, _ = model.block_decode(bp, x, j, cache, pos_t, attend)
        if s == self._pp - 1:
            return model.decode_head(st["shared"], x).to(self.device)
        return x

    def _drain_waves_locked(self) -> Dict[int, List[int]]:
        """Tick the pipeline with no new entries until every in-flight wave
        has been harvested (at most ``pp - 1`` ticks)."""
        out: Dict[int, List[int]] = {}
        while any(self._wave_inflight[w] for w in range(self._pp)):
            for s, ts in self._run_tick_locked().items():
                out.setdefault(s, []).extend(ts)
        return out

    def _spec_step_locked(self, ready: np.ndarray) -> Dict[int, List[int]]:
        """One speculative iteration: clamp each slot's window to its page
        room (temperature slots to 0), append the whole window's room, run
        the draft chain then the single verify call, commit the longest
        matching prefix + bonus per slot, and roll the rest back through
        :meth:`PagedKVCache.truncate`."""
        t0 = time.perf_counter()
        K, B, dev = self.spec_k, self.num_slots, self.device
        lengths0 = self.kv.lengths()
        rooms = self.kv.token_rooms()
        mask = np.zeros(B, bool)
        mask[ready] = True
        kb = np.zeros(B, np.int64)
        for s in ready:
            want = K if self._temp[s] == 0.0 else 0
            kb[s] = max(0, min(want, int(rooms[s]) - 1))
        nappend = np.where(mask, kb + 1, 0)
        for s in ready:
            self.kv.append(int(s), int(nappend[s]))
        table = self.kv.page_tables()
        table[~mask] = 0
        # chunk base: the incoming token sits at the pre-append length
        start = np.where(mask, lengths0, 0).astype(np.int64)
        token = np.where(mask, self._last_token, 0).astype(np.int64)
        table_t = torch.as_tensor(table, dtype=torch.int32, device=dev)
        start_t = torch.as_tensor(start, device=dev)
        token_t = torch.as_tensor(token, device=dev)
        nappend_t = torch.as_tensor(nappend, device=dev)

        td = time.perf_counter()
        with obs_span("serving/decode_draft",
                      args={"active": int(ready.size)},
                      profiler_annotation=True):
            if self._draft_model is None:
                drafts_t = self._self_draft(token_t, start_t, table_t,
                                            nappend_t)
            else:
                drafts_t = self._ext_draft(
                    token_t, start_t, torch.as_tensor(mask, device=dev))
            drafts = drafts_t.cpu().numpy()                  # [B, K]
        draft_ms = (time.perf_counter() - td) * 1000.0

        ids = np.zeros((B, K + 1), np.int64)
        ids[:, 0] = token
        ids[:, 1:] = drafts
        ids[~mask] = 0
        tv = time.perf_counter()
        with obs_span("serving/decode_verify",
                      args={"active": int(ready.size)},
                      profiler_annotation=True):
            logits = self._verify(torch.as_tensor(ids, device=dev), start_t,
                                  nappend_t, table_t)
            g = logits.argmax(dim=-1).cpu().numpy()          # [B, K+1]
            hot = [int(s) for s in ready if self._temp[s] > 0.0]
            samp0 = {}
            if hot:
                # temperature slots (window 0): their token is sampled from
                # the verify logits at position 0, one draw per step
                drawn = self._sample(logits[torch.as_tensor(hot, device=dev),
                                            0], hot, self._temp[hot],
                                     self._topk[hot])
                samp0 = dict(zip(hot, (int(t) for t in drawn)))
        verify_ms = (time.perf_counter() - tv) * 1000.0

        out: Dict[int, List[int]] = {}
        committed_total = 0
        for s in ready:
            s = int(s)
            k_b = int(kb[s])
            a = 0
            while a < k_b and drafts[s, a] == g[s, a]:
                a += 1
            bonus = samp0[s] if s in samp0 else int(g[s, a])
            for src, dst in self.kv.truncate(s, int(lengths0[s]) + a + 1):
                self._copy_pages(int(src), int(dst))
            toks = [int(drafts[s, i]) for i in range(a)] + [bonus]
            self._last_token[s] = bonus
            out[s] = toks
            self._spec_proposed += k_b
            self._spec_accepted += a
            committed_total += len(toks)

        self._spec_steps += 1
        self._spec_slot_steps += int(ready.size)
        self._steps += 1
        self._tokens_out += committed_total
        self._spec_draft_ms = draft_ms
        self._spec_verify_ms = verify_ms
        dt_ms = (time.perf_counter() - t0) * 1000.0
        self.metrics.observe("serving/decode/step_ms", dt_ms)
        self.metrics.observe("serving/decode/step_active", int(ready.size))
        self.metrics.observe("serving/decode/draft_ms", draft_ms)
        self.metrics.observe("serving/decode/verify_ms", verify_ms)
        # amortized per-token latency: one observation per committed token so
        # the histogram's percentiles stay per-token like the plain path
        per_tok = dt_ms / max(1, committed_total)
        for _ in range(committed_total):
            self.metrics.observe("serving/decode/token_latency_ms", per_tok)
        self.metrics.gauge("decode/spec/accept_rate", self._accept_rate())
        self.metrics.gauge("decode/spec/mean_accepted",
                           self._spec_accepted
                           / max(1, self._spec_slot_steps))
        self.metrics.gauge("decode/spec/draft_ms", draft_ms)
        self.metrics.gauge("decode/spec/verify_ms", verify_ms)
        return out

    def _accept_rate(self) -> float:
        return (self._spec_accepted / self._spec_proposed
                if self._spec_proposed else 0.0)

    def release(self, slot: int) -> None:
        """Retire a finished sequence at a token boundary: its pages return
        to the pool immediately (shared pages drop one reference), the lane
        is reusable next step."""
        with self._lock:
            self._release_locked(int(slot))

    def _release_locked(self, slot: int) -> None:
        self.kv.free(slot)
        for w in self._wave_inflight:
            self._wave_inflight[w] = [s for s in self._wave_inflight[w]
                                      if s != slot]
        self._pending = [st for st in self._pending if st["slot"] != slot]
        self._decode_ready[slot] = False
        self._last_token[slot] = 0
        self._temp[slot] = 0.0
        self._topk[slot] = 0

    def active_slots(self) -> np.ndarray:
        return self.kv.active_slots()

    # -- live weight hot-swap ------------------------------------------------

    def weights_template(self):
        """``{layer: {name: meta tensor}}`` of the ctor params (shape and
        dtype, no storage) — what a swapped tree must match leaf for leaf."""
        return self._weights_template

    def swap_params(self, params, *, version: Optional[int] = None) -> bool:
        """Stage a hot swap of the serving weights (any form the ctor
        accepts; shapes and dtypes must equal the ctor tree's). The tree is
        placed on the device outside the engine lock, then applied only at a
        fully drained token boundary so no sequence decodes under two
        versions; ``can_admit`` holds new admissions meanwhile. Returns True
        if the swap applied immediately (engine idle)."""
        faults.fire("engine.swap")  # chaos hook; no-op unless armed
        tree = params_tree(self.model, params, self.device)
        check_template(tree, self._weights_template)
        tree = self._prepare_params(tree)   # device placement, no lock
        with self._lock:
            v = (int(version) if version is not None
                 else self._serving_version + 1)
            self._pending_swap = (tree, v)
            return self._maybe_swap_locked()

    def _maybe_swap_locked(self) -> bool:
        if self._pending_swap is None:
            return False
        if self.kv.active_slots().size or self._pending:
            return False
        params, version = self._pending_swap
        self._pending_swap = None
        self._params = params
        if self.prefix_cache:
            # old-version K/V must not seed post-swap prompts
            self.kv.flush_prefix_index()
        self._serving_version = version
        self._swaps += 1
        self.metrics.gauge("serving/version", float(version))
        return True

    def maybe_swap(self) -> bool:
        """Try to land a pending swap. True if a swap applied now."""
        with self._lock:
            return self._maybe_swap_locked()

    def serving_version(self) -> int:
        """Version of the weights currently serving (0 = ctor weights)."""
        with self._lock:
            return self._serving_version

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            from ..parallel.tp import shard_bytes
            kv_bytes = sum(t.numel() * t.element_size()
                           for t in self._pool_tensors(self._shard_pools[:1]))
            if self._pp > 1:
                st = self._params[0]   # a device: stage 0's shard 0
                param_bytes = shard_bytes(dict(
                    st["shared"], **{f"b{j}": bp for j, bp in
                                     enumerate(st["blocks"])}))
            else:
                param_bytes = shard_bytes(self._params)
            return {
                "num_slots": self.num_slots,
                "prefill_buckets": list(self.prefill_buckets),
                "max_seq_len": self.max_seq_len,
                "prefix_cache": self.prefix_cache,
                "prefill_chunk": self.prefill_chunk,
                "pending_prefills": len(self._pending),
                "device": str(self.device),
                "aot_compiles": self._aot_compiles,
                "cold_start": cold_start_stats(self.exec_store, self.boot),
                "traces": self.recompile_guard.traces,
                "steady_traces": self.recompile_guard.steady_traces,
                "steps": self._steps,
                "tokens_out": self._tokens_out,
                "prefills": self._prefills,
                "serving_version": self._serving_version,
                "swaps": self._swaps,
                "pending_swap": self._pending_swap is not None,
                "kv_quant": self.kv_quant,
                "kv_quant_error": self._kv_quant_error,
                "spec": {
                    "enabled": bool(self.spec_k),
                    "k": self.spec_k,
                    "mode": ("external" if self._draft_model is not None
                             else ("self" if self.spec_k else None)),
                    "draft_layers": self.draft_layers,
                    "steps": self._spec_steps,
                    "proposed": self._spec_proposed,
                    "accepted": self._spec_accepted,
                    "accept_rate": self._accept_rate(),
                    # mean draft tokens accepted per slot per spec step
                    "mean_accepted": (self._spec_accepted
                                      / self._spec_slot_steps
                                      if self._spec_slot_steps else 0.0),
                    "draft_ms": self._spec_draft_ms,
                    "verify_ms": self._spec_verify_ms,
                },
                "kv": self.kv.stats(),
                "parallel": {"mesh": (dict(self.mesh.shape)
                                      if self.mesh is not None else None),
                             "tp": self._tp, "ep": self._ep, "pp": self._pp,
                             "stages": self._pp, "pp_wave": self._pp_wave,
                             "wave_ticks": self._tick,
                             "kv_bytes_per_device": kv_bytes,
                             "param_bytes_per_device": param_bytes},
            }
