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
place. ``stats()`` keeps the keys the server and ``/healthz`` read;
``traces`` / ``steady_traces`` read 0 (nothing is traced). The
quantization-error probe lets a failure raise (the JAX engine swallows it):
on the card it runs the kernels, and a kernel fault must not pass unseen.

``executable_dir`` boots the kernel library from a
:class:`~sparkflow_tpu_torch.serving.coldstart.ExecutableStore` before
warmup, as the predict engine does, and reports the tier under
``stats()["cold_start"]``.

Not yet ported, and refused with a ``ValueError`` naming ROADMAP.md: model
parallelism (``mesh``, ``sharding``, ``pp_wave``).

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

from ..convert import check_template, params_tree, shape_template
from ..obs.spans import span as obs_span
from ..ops import paged_attention, paged_attention_verify
from ..resilience import faults
from ..utils import metrics as metrics_mod
from ..utils import quant
from .coldstart import ExecutableStore, boot_kernels, cold_start_stats
from .kvcache import OutOfPages, PagedKVCache

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


def _not_yet(option: str):
    raise ValueError(f"DecodeEngine option {option} is not yet ported to "
                     f"PyTorch (see ROADMAP.md)")


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
        is off. At most ``MAX_VERIFY_ROWS - 1`` (15) on the card.
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
        unported = {"mesh": mesh, "sharding": sharding,
                    "pp_wave": None if pp_wave else pp_wave}
        for name, value in unported.items():
            if value is not None:
                _not_yet(f"{name}={value!r}")
        if isinstance(model, str):
            from ..models import model_from_json
            model = model_from_json(model)
        for need in ("prefill", "decode_step", "prefill_suffix"):
            if not hasattr(model, need):
                raise TypeError(f"model has no {need}(); DecodeEngine needs "
                                f"a causal LM (transformer_lm)")
        self.model = model
        self.device = model.device
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

        tree = params_tree(model, params, self.device)
        self._weights_template = shape_template(tree)
        self._params = tree
        pool_shape = (model.num_layers, num_pages, self.page_size, heads, hd)
        with torch.inference_mode():
            if self._quantized:
                store, _ = quant.kv_pool_dtype(self.kv_quant)
                scale_shape = pool_shape[:2] + (heads,)
                self._k_pool, self._v_pool = (
                    (torch.zeros(pool_shape, dtype=store, device=self.device),
                     torch.zeros(scale_shape, device=self.device))
                    for _ in range(2))
            else:
                self._k_pool, self._v_pool = (
                    torch.zeros(pool_shape, dtype=pool_dtype,
                                device=self.device) for _ in range(2))
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
        """Build the CUDA kernels ahead of the first request (on the card)
        and, for a quantized pool, measure ``kv_quant_error``."""
        if self.device.type == "cuda":
            from ..ops import _build
            _build.load()
        if self._quantized and self._kv_quant_error is None:
            with self._lock, torch.inference_mode():
                self._kv_quant_error_probe_locked()

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
        logits, kvs = model.prefill(self._params, ids,
                                    lengths=torch.as_tensor([page], device=dev))
        L = len(kvs)
        h, d = kvs[0][0].shape[1], kvs[0][0].shape[3]
        shape = (L, 3, page, h, d)
        kr = torch.zeros(shape, dtype=ref_dt, device=dev)
        vr = torch.zeros(shape, dtype=ref_dt, device=dev)
        kq = (torch.zeros(shape, dtype=store, device=dev),
              torch.zeros((L, 3, h), device=dev))
        vq = (torch.zeros(shape, dtype=store, device=dev),
              torch.zeros((L, 3, h), device=dev))
        pid = torch.tensor([1], device=dev)
        for i, (k, v) in enumerate(kvs):
            kk = k[0].transpose(0, 1)[None]                # [1, page, h, d]
            vv = v[0].transpose(0, 1)[None]
            kr[i, pid] = kk.to(ref_dt)
            vr[i, pid] = vv.to(ref_dt)
            quant.paged_quant_write_pages(kq[0], kq[1], i, pid, kk)
            quant.paged_quant_write_pages(vq[0], vq[1], i, pid, vv)
        table = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
        tok = logits.argmax(dim=-1)
        pos = torch.tensor([page], device=dev)
        pids, off = table[0, pos // page].long(), pos % page

        def attend_ref(layer, q, k_new, v_new, cache, p):
            kp, vp = cache
            kp[layer, pids, off] = k_new.to(kp.dtype)
            vp[layer, pids, off] = v_new.to(vp.dtype)
            out = paged_attention(q, kp[layer], vp[layer], table,
                                  (p + 1).to(torch.int32))
            return out.to(q.dtype), cache

        def attend_q(layer, q, k_new, v_new, cache, p):
            kp, vp = cache
            quant.paged_quant_append(kp[0], kp[1], layer, pids, off, k_new)
            quant.paged_quant_append(vp[0], vp[1], layer, pids, off, v_new)
            out = paged_attention(q, kp[0][layer], vp[0][layer], table,
                                  (p + 1).to(torch.int32),
                                  k_scales=kp[1][layer],
                                  v_scales=vp[1][layer])
            return out.to(q.dtype), cache

        lg_ref, _ = model.decode_step(self._params, (kr, vr), tok, pos,
                                      attend=attend_ref)
        lg_q, _ = model.decode_step(self._params, (kq, vq), tok, pos,
                                    attend=attend_q)
        err = float((lg_q.float() - lg_ref.float()).abs().max())
        self._kv_quant_error = err
        self.metrics.gauge("decode/kv_quant_error", err)

    # -- pool layout ------------------------------------------------------------
    #
    # With kv_quant on, each pool is a (rows int8/fp8, scales f32) pair;
    # these keep the attend closures layout-agnostic. All writes are in place.

    def _kv_rows(self, pool, layer, pids, offs, rows) -> None:
        """Write token rows at ``(layer, pids, offs)``, any batch shape;
        a quantized pool keeps its running per-page-per-head scale."""
        if self._quantized:
            quant.paged_quant_append(pool[0], pool[1], layer, pids, offs, rows)
        else:
            pool[layer, pids, offs] = rows.to(pool.dtype)

    def _kv_pages(self, pool, layer, page_ids, pages) -> None:
        """Commit whole pages at ``(layer, page_ids)`` (ladder prefill)."""
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

    def _pool_tensors(self):
        """Every device tensor of the K and V pools (rows, and scales)."""
        pools = (self._k_pool, self._v_pool)
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

    def _decode(self, token: np.ndarray, pos: np.ndarray,
                table: np.ndarray) -> torch.Tensor:
        """One token for every lane: write each lane's new K/V row into its
        page, attend over the pool through the page table; returns logits
        [num_slots, vocab] f32."""
        dev, page = self.device, self.page_size
        token_t = torch.as_tensor(token, device=dev)
        pos_t = torch.as_tensor(pos, dtype=torch.int64, device=dev)
        table_t = torch.as_tensor(table, dtype=torch.int32, device=dev)
        bidx = torch.arange(self.num_slots, device=dev)
        page_ids = table_t[bidx, pos_t // page].long()
        off = pos_t % page
        lengths = (pos_t + 1).to(torch.int32)

        def attend(layer, q, k_new, v_new, cache, _pos):
            kp, vp = cache
            self._kv_rows(kp, layer, page_ids, off, k_new)
            self._kv_rows(vp, layer, page_ids, off, v_new)
            out = self._paged_att(q, kp, vp, layer, table_t, lengths)
            return out.to(q.dtype), cache

        logits, _ = self.model.decode_step(
            self._params, (self._k_pool, self._v_pool), token_t, pos_t,
            attend=attend)
        return logits

    def _prefill_bucket(self, ids: np.ndarray, n: int,
                        page_ids: np.ndarray) -> torch.Tensor:
        """Ladder prefill of one padded prompt; commits every block's K/V
        into ``page_ids`` (pads -> scratch page 0). Returns [1, vocab]."""
        dev, page = self.device, self.page_size
        npages = ids.shape[1] // page
        logits, kvs = self.model.prefill(
            self._params, torch.as_tensor(ids, device=dev),
            lengths=torch.as_tensor([n], device=dev))
        pid = torch.as_tensor(page_ids, dtype=torch.int64, device=dev)
        for i, (k, v) in enumerate(kvs):
            # [1, heads, bucket, d] -> [npages, page, heads, d]
            kk = k[0].transpose(0, 1).reshape(npages, page, k.shape[1],
                                              k.shape[3])
            vv = v[0].transpose(0, 1).reshape(npages, page, v.shape[1],
                                              v.shape[3])
            self._kv_pages(self._k_pool, i, pid, kk)
            self._kv_pages(self._v_pool, i, pid, vv)
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
        causal = tpos[None, :] <= pos_abs[:, None]          # [C, L]

        def attend(layer, q, k_new, v_new, cache, _start):
            kp, vp = cache
            self._kv_rows(kp, layer, pids, off, k_new[0].transpose(0, 1))
            self._kv_rows(vp, layer, pids, off, v_new[0].transpose(0, 1))
            hk = self._kv_gather(kp, layer, row).reshape(maxp * page, -1,
                                                         model.head_dim)
            hv = self._kv_gather(vp, layer, row).reshape(maxp * page, -1,
                                                         model.head_dim)
            s = torch.einsum("hcd,lhd->hcl", q[0].float(), hk) * scale
            s = torch.where(causal[None], s, NEG_INF)
            p = torch.softmax(s, dim=-1)
            out = torch.einsum("hcl,lhd->hcd", p, hv)
            return out[None].to(q.dtype), cache

        logits, _ = model.prefill_suffix(
            self._params, torch.as_tensor(ids, device=dev),
            torch.as_tensor([start], device=dev),
            (self._k_pool, self._v_pool), attend,
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
        pools = (self._k_pool, self._v_pool)
        toks, tok = [], token
        for j in range(self.spec_k):
            pos = start + j
            pids = table[bidx, (pos // page).clamp(0, maxp - 1)].long()
            pids = torch.where(pos < writable, pids, 0)
            off = pos % page
            lengths = (pos + 1).to(torch.int32)

            def attend(layer, q, k_new, v_new, cache, _pos, pids=pids,
                       off=off, lengths=lengths):
                kp, vp = cache
                self._kv_rows(kp, layer, pids, off, k_new)
                self._kv_rows(vp, layer, pids, off, v_new)
                out = self._paged_att(q, kp, vp, layer, table, lengths)
                return out.to(q.dtype), cache

            logits, _ = self.model.decode_step(
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
        start32 = start.to(torch.int32)

        def attend(layer, q, k_new, v_new, cache, _st):
            kp, vp = cache
            self._kv_rows(kp, layer, pids, off, k_new.transpose(1, 2))
            self._kv_rows(vp, layer, pids, off, v_new.transpose(1, 2))
            out = self._paged_verify_att(q, kp, vp, layer, table, start32)
            return out.to(q.dtype), cache

        logits, _ = self.model.decode_verify(
            self._params, ids, start, (self._k_pool, self._v_pool), attend)
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
                raise OutOfPages("weight swap pending at token boundary")
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
            _logits, kvs = self._draft_model.prefill(
                self._draft_params, torch.as_tensor(ids, device=self.device),
                lengths=torch.as_tensor([n], device=self.device))
            for i, (k, v) in enumerate(kvs):
                self._draft_k[i, slot, :, :bucket] = k[0].to(
                    self._draft_k.dtype)
                self._draft_v[i, slot, :, :bucket] = v[0].to(
                    self._draft_v.dtype)

    # -- decode --------------------------------------------------------------

    def step(self) -> Dict[int, List[int]]:
        """One decode iteration over every decode-ready slot: append page
        room, run the step, return ``{slot: [tokens...]}`` — one token per
        slot, or up to ``spec_k + 1`` with speculation on (the accepted
        drafts and the target's bonus token, in order). A pending chunked
        prefill advances one chunk here, before a plain decode step (the
        speculative path stands down for that iteration); a slot whose final
        chunk just committed contributes its *first* token. No-op (empty
        dict) when nothing is active."""
        with self._lock, torch.inference_mode():
            if self._pending_swap is not None:
                self._maybe_swap_locked()  # lands iff fully drained
            active = self.kv.active_slots()
            ready = np.asarray([int(s) for s in active
                                if self._decode_ready[s]], np.int64)
            state = self._pending[0] if self._pending else None
            if ready.size == 0 and state is None:
                return {}
            if self.spec_k and state is None:
                return self._spec_step_locked(ready)
            t0 = time.perf_counter()
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
            kv_bytes = sum(t.numel() * t.element_size()
                           for t in self._pool_tensors())
            param_bytes = sum(t.numel() * t.element_size()
                              for layer in self._params.values()
                              for t in layer.values())
            return {
                "num_slots": self.num_slots,
                "prefill_buckets": list(self.prefill_buckets),
                "max_seq_len": self.max_seq_len,
                "prefix_cache": self.prefix_cache,
                "prefill_chunk": self.prefill_chunk,
                "pending_prefills": len(self._pending),
                "device": str(self.device),
                "aot_compiles": 0,
                "cold_start": cold_start_stats(self.exec_store, self.boot),
                "traces": 0,
                "steady_traces": 0,
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
                "parallel": {"mesh": None, "tp": 1, "ep": 1, "pp": 1,
                             "stages": 1, "pp_wave": False,
                             "wave_ticks": 0,
                             "kv_bytes_per_device": kv_bytes,
                             "param_bytes_per_device": param_bytes},
            }
