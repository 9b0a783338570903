"""Slot-based paged KV-cache manager for autoregressive decode.

Decode serving needs one KV cache per in-flight sequence, but sequences are
ragged (a 20-token chat next to a 2048-token completion) and join/leave the
batch every token. A dense ``[slots, max_len]`` cache would reserve worst-case
memory for every slot; instead the pool is carved into fixed-size **pages**
(``page_size`` tokens each) and each slot owns just the pages its tokens
occupy, listed in a per-slot **page table** — the same indirection OS virtual
memory and vLLM's PagedAttention use. The CUDA kernel behind
:func:`~sparkflow_tpu_torch.ops.paged_attention` consumes the table directly
(each thread block reads its own slot's table row), so the scattered pages
are never gathered into a contiguous cache on the device.

This class is the **host-side bookkeeper**: free-page list, per-slot tables
and lengths, allocation/append/free at token granularity. The actual K/V
arrays live on-device inside :class:`~sparkflow_tpu_torch.serving.decode.DecodeEngine`'s
pool tensors; the manager just hands the engine ``page_table`` /
``lengths`` operands each step. The bookkeeping is device-layout-blind: a
page id names the same ``[page_size, heads, head_dim]`` block of every
layer, whether the pool lives on one chip or shards its heads axis over a
tp mesh / its layers axis over a pp mesh — refcounts, the prefix trie and
COW never change when the engine re-lays the pool out.

Admission is reservation-based: :meth:`alloc` checks that the request's
**worst case** (prompt + max_new_tokens) fits in free pages before admitting,
then allocates lazily as tokens arrive (:meth:`append`). A request that was
admitted can therefore never hit out-of-pages mid-generation — backpressure
happens once, at admission, where the batcher can map it to ``QueueFull``.

Unassigned page-table entries point at page 0, a **scratch page** the manager
never hands out: inactive slots' decode writes land there harmlessly and the
kernel always reads valid pool indices.

Shared-prefix caching (copy-on-write page sharing)
--------------------------------------------------
Real decode traffic repeats prompt prefixes — system prompts, few-shot
preambles — and recomputing their K/V per request is the dominant redundant
cost. The manager therefore keeps a **prefix index**: a hash-chained trie of
page-aligned prompt blocks (each key is ``blake2b(parent_key ‖ block_tokens)``,
so a block is only reachable through its exact prefix chain). When
:meth:`alloc` receives the actual prompt *tokens*, it walks the chain and maps
every indexed page straight into the new slot's table — no allocation, no
prefill for those tokens — and returns ``(shared_pages, tokens_saved)``.

Sharing is reference-counted and copy-on-write by construction:

* only **full** pages are shared, and never the page holding the final prompt
  token (cap ``(len(prompt) - 1) // page_size``) — the consumer always
  recomputes at least one suffix token (its first-token logits) and all of
  its writes (suffix prefill and decode appends) land at positions past the
  shared pages, i.e. in private pages. Divergence therefore never mutates a
  shared page; "copy"-on-write degenerates to allocate-on-write.
* :meth:`free` decrements; a page is reclaimed only at refcount 0. Pages that
  are in the prefix index keep their contents after release in a **cached
  tier** (LRU) — still evictable supply for admission, but a later prompt
  with the same prefix revives them for free.
* a page's contents are published to the index by :meth:`commit_prefix` only
  **after** the engine has committed the K/V on device — an alloc-time
  registration would let a concurrent request share pages whose K/V hasn't
  been written yet.
* admission stays exact: a prefix hit reduces the worst-case demand by the
  shared pages (they are mapped, not drawn from the pool), and a shared page
  is never double-reserved — reservations only cover future *private* pages.

The attention kernel needs zero changes: aliased page-table entries are just two
tables pointing at the same pool index.

Occupancy and fragmentation export as ``serving/kv/*`` gauges, and the
decode-plane summary (occupancy, fragmentation, prefix hit-rate, tokens
saved) additionally exports under ``decode/*`` for fleet dashboards.
"""

from __future__ import annotations

import hashlib
import math
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from ..utils import metrics as metrics_mod
from ..utils.quant import KV_DTYPES

__all__ = ["PagedKVCache", "OutOfPages", "SwapPending", "KV_DTYPES"]


class OutOfPages(Exception):
    """Raised by :meth:`PagedKVCache.alloc` when the reservation (worst-case
    pages for the request) does not fit in the free pool — the admission
    signal the continuous batcher turns into backpressure."""


class SwapPending(OutOfPages):
    """Raised by ``DecodeEngine.prefill`` while a weight swap waits for the
    active slots to drain. A swap staged between the batcher's
    ``can_admit`` and its prefill lands here: the batcher puts the request
    back at the head of its queue instead of failing it."""


class PagedKVCache:
    """Page bookkeeping for ``num_slots`` concurrent sequences.

    Parameters
    ----------
    num_pages : int
        Total pool pages **including** the reserved scratch page 0; usable
        capacity is ``num_pages - 1`` pages.
    page_size : int
        Tokens per page.
    num_slots : int
        Decode slots (the fixed batch dimension of the decode step).
    max_pages_per_slot : int
        Page-table width — caps any single sequence at
        ``max_pages_per_slot * page_size`` tokens.
    kv_dtype : str
        Device pool element layout — ``"bf16"`` (full precision), ``"int8"``
        or ``"fp8"``. Pure metadata here: page ids, refcounts, COW and the
        prefix trie are byte-layout-blind (aliased table entries gather the
        same quantized rows), so the manager only records the layout for
        capacity accounting (``stats()["kv_dtype"]`` / gauges) and fleet
        headroom comparison.
    kv_bytes_per_page : int, optional
        Device bytes one page costs across all layers (K + V + scales), as
        measured by the engine from the actual pool tensors. Exported so
        routing can compare *byte* headroom across replicas with different
        pool layouts.
    """

    def __init__(self, num_pages: int, page_size: int, num_slots: int,
                 max_pages_per_slot: int,
                 metrics: Optional[metrics_mod.Metrics] = None,
                 kv_dtype: str = "bf16",
                 kv_bytes_per_page: Optional[int] = None):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is scratch), "
                             f"got {num_pages}")
        if page_size < 1 or num_slots < 1 or max_pages_per_slot < 1:
            raise ValueError("page_size, num_slots, max_pages_per_slot must "
                             "be >= 1")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                             f"got {kv_dtype!r}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.num_slots = int(num_slots)
        self.max_pages_per_slot = int(max_pages_per_slot)
        self.kv_dtype = kv_dtype
        self.kv_bytes_per_page = (int(kv_bytes_per_page)
                                  if kv_bytes_per_page is not None else None)
        self.metrics = metrics if metrics is not None else metrics_mod.Metrics()
        self._lock = threading.Lock()
        # page 0 is scratch: never allocated, absorbs inactive slots' writes
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._tables = np.zeros((self.num_slots, self.max_pages_per_slot),
                                np.int32)
        self._lengths = np.zeros(self.num_slots, np.int32)
        self._pages_held = np.zeros(self.num_slots, np.int32)
        self._reserved = np.zeros(self.num_slots, np.int32)  # beyond held
        self._active = np.zeros(self.num_slots, bool)
        # prefix sharing state: per-page refcounts; chain-hash -> page for
        # published full prefix blocks; reverse map for deregistration; and
        # the cached tier — refcount-0 pages whose contents are still indexed
        # (LRU order; evicted last, after the plain free list is exhausted)
        self._refcount = np.zeros(self.num_pages, np.int32)
        self._prefix_index: Dict[bytes, int] = {}
        self._page_key: Dict[int, bytes] = {}
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._prefix_lookups = 0
        self._prefix_hits = 0
        self._tokens_saved = 0
        self._export_gauges_locked()

    # -- capacity ------------------------------------------------------------

    @staticmethod
    def pages_for(tokens: int, page_size: int) -> int:
        return max(0, math.ceil(tokens / page_size))

    def free_slot(self) -> Optional[int]:
        """Lowest inactive slot index, or None when all slots are busy."""
        with self._lock:
            idle = np.flatnonzero(~self._active)
            return int(idle[0]) if idle.size else None

    def can_admit(self, total_tokens: int,
                  prompt_tokens: Optional[Sequence[int]] = None) -> bool:
        """Whether a sequence whose worst case is ``total_tokens`` (prompt +
        max new tokens) could be admitted right now: a free slot exists and
        the un-reserved evictable pool covers its reservation. With the
        actual ``prompt_tokens``, prefix-index hits are subtracted from the
        demand — the exact mirror of :meth:`alloc`'s accounting."""
        need = self.pages_for(total_tokens, self.page_size)
        if need > self.max_pages_per_slot:
            return False
        with self._lock:
            if not np.any(~self._active):
                return False
            shared = 0
            revived = 0
            if prompt_tokens is not None and not isinstance(
                    prompt_tokens, (int, np.integer)):
                hits = self._lookup_locked(list(prompt_tokens))
                shared = len(hits)
                revived = sum(1 for p in hits if self._refcount[p] == 0)
            return need - shared <= self._avail_locked() - revived

    # -- prefix index --------------------------------------------------------

    def _block_digests(self, tokens: Sequence[int], limit: int) -> List[bytes]:
        """Chained digests of the first ``limit`` full page blocks: block i's
        key commits to every token before it, so equal keys mean equal
        page-aligned prefixes (up to hash collision)."""
        out: List[bytes] = []
        parent = b""
        ps = self.page_size
        for i in range(limit):
            h = hashlib.blake2b(parent, digest_size=16)
            h.update(np.asarray(tokens[i * ps:(i + 1) * ps],
                                np.int64).tobytes())
            parent = h.digest()
            out.append(parent)
        return out

    def _lookup_locked(self, tokens: List[int]) -> List[int]:
        """Longest indexed page chain for ``tokens``'s shareable prefix (full
        pages only, and never the final prompt token's page)."""
        limit = max(0, (len(tokens) - 1) // self.page_size)
        pages: List[int] = []
        for dg in self._block_digests(tokens, limit):
            pid = self._prefix_index.get(dg)
            if pid is None:
                break
            pages.append(pid)
        return pages

    def commit_prefix(self, slot: int, prompt_tokens: Sequence[int]) -> int:
        """Publish ``slot``'s full-page prompt blocks into the prefix index.
        Call only once the K/V for those tokens is committed on device — the
        index is how *other* slots find these pages, so publishing before the
        write would hand out garbage. Returns the number of newly indexed
        pages (already-indexed blocks are skipped)."""
        tokens = [int(t) for t in prompt_tokens]
        with self._lock:
            if not self._active[slot]:
                return 0
            n = min(len(tokens), int(self._lengths[slot]))
            added = 0
            for i, dg in enumerate(self._block_digests(tokens,
                                                       n // self.page_size)):
                pid = int(self._tables[slot, i])
                if pid == 0:
                    break
                if self._prefix_index.get(dg) == pid:
                    continue  # shared from the index in the first place
                if dg in self._prefix_index or pid in self._page_key:
                    continue  # block already published by a concurrent twin
                self._prefix_index[dg] = pid
                self._page_key[pid] = dg
                added += 1
            return added

    def flush_prefix_index(self) -> int:
        """Forget every indexed shared prefix: cached-tier pages (refcount
        0) return to the plain free list; pages still referenced by active
        slots merely lose their index entry, so their holders keep decoding
        but no new request can map them. The weight hot-swap calls this —
        indexed K/V was computed under the OLD weights, and serving it to a
        post-swap prompt would silently mix versions. Returns the number of
        dropped index entries."""
        with self._lock:
            dropped = len(self._prefix_index)
            self._prefix_index.clear()
            self._page_key.clear()
            while self._cached:
                pid, _ = self._cached.popitem(last=False)
                self._free.append(pid)
            self._export_gauges_locked()
            return dropped

    def _avail_locked(self) -> int:
        """Pages available to new demand: the free list plus the evictable
        cached tier, minus outstanding reservations."""
        return (len(self._free) + len(self._cached)
                - int(self._reserved.sum()))

    def _take_page_locked(self) -> int:
        """Draw one page: plain free list first, then evict the LRU cached
        page (dropping its index entry — the prefix is simply forgotten)."""
        if self._free:
            return self._free.pop()
        if self._cached:
            pid, _ = self._cached.popitem(last=False)
            dg = self._page_key.pop(pid, None)
            if dg is not None:
                self._prefix_index.pop(dg, None)
            return pid
        raise OutOfPages("page pool exhausted despite reservation "
                         "(accounting bug)")

    # -- lifecycle -----------------------------------------------------------

    def alloc(self, slot: int, prompt_tokens: Union[int, Sequence[int]],
              total_tokens: int) -> tuple:
        """Claim ``slot`` for a sequence: allocate pages covering the prompt
        now, reserve (but don't allocate) the rest of the worst case so
        :meth:`append` can never fail later. Raises :class:`OutOfPages` when
        the reservation doesn't fit.

        ``prompt_tokens`` may be the prompt length (no sharing — the legacy
        contract) or the actual token sequence, in which case indexed prefix
        pages are mapped into the table instead of allocated. Returns
        ``(shared_pages, tokens_saved)`` — ``(0, 0)`` on a miss or when only
        a length was given."""
        if isinstance(prompt_tokens, (int, np.integer)):
            tokens: Optional[List[int]] = None
            n_prompt = int(prompt_tokens)
        else:
            tokens = [int(t) for t in prompt_tokens]
            n_prompt = len(tokens)
        if n_prompt < 1:
            raise ValueError("prompt_tokens must be >= 1")
        total_tokens = max(int(total_tokens), n_prompt)
        need_now = self.pages_for(n_prompt, self.page_size)
        need_total = self.pages_for(total_tokens, self.page_size)
        if need_total > self.max_pages_per_slot:
            raise OutOfPages(
                f"sequence of {total_tokens} tokens needs {need_total} pages "
                f"> max_pages_per_slot={self.max_pages_per_slot}")
        with self._lock:
            if self._active[slot]:
                raise ValueError(f"slot {slot} is already active")
            shared: List[int] = []
            if tokens is not None:
                shared = self._lookup_locked(tokens)
                self._prefix_lookups += 1
                if shared:
                    self._prefix_hits += 1
            n_shared = len(shared)
            # shared pages are mapped, not drawn, so they leave the demand;
            # cached hits about to be revived leave the evictable supply
            revived = sum(1 for p in shared if self._refcount[p] == 0)
            avail = self._avail_locked() - revived
            if need_total - n_shared > avail:
                self.metrics.incr("serving/kv/alloc_rejections")
                raise OutOfPages(
                    f"need {need_total - n_shared} pages "
                    f"({n_shared} shared), {avail} unreserved free")
            self._tables[slot, :] = 0
            for i, pid in enumerate(shared):
                if self._refcount[pid] == 0:
                    self._cached.pop(pid, None)  # revive from the cached tier
                self._refcount[pid] += 1
                self._tables[slot, i] = pid
            for i in range(n_shared, need_now):
                pid = self._take_page_locked()
                self._refcount[pid] = 1
                self._tables[slot, i] = pid
            self._lengths[slot] = n_prompt
            self._pages_held[slot] = need_now
            self._reserved[slot] = need_total - need_now
            self._active[slot] = True
            saved = n_shared * self.page_size
            self._tokens_saved += saved
            self._export_gauges_locked()
            return n_shared, saved

    def append(self, slot: int, n: int = 1) -> None:
        """Extend ``slot`` by ``n`` tokens, drawing new pages from its
        reservation at page boundaries. Never raises for admitted sequences
        within their reservation."""
        with self._lock:
            if not self._active[slot]:
                raise ValueError(f"slot {slot} is not active")
            for _ in range(n):
                length = int(self._lengths[slot])
                if length % self.page_size == 0:  # first token of a new page
                    held = int(self._pages_held[slot])
                    if held >= self.max_pages_per_slot:
                        raise OutOfPages(
                            f"slot {slot} exceeded max_pages_per_slot="
                            f"{self.max_pages_per_slot}")
                    if self._reserved[slot] <= 0:
                        raise OutOfPages(
                            f"slot {slot} grew past its reservation")
                    pid = self._take_page_locked()
                    self._refcount[pid] = 1
                    self._tables[slot, held] = pid
                    self._pages_held[slot] += 1
                    self._reserved[slot] -= 1
                self._lengths[slot] = length + 1
            self._export_gauges_locked()

    def truncate(self, slot: int, n: int) -> List[tuple]:
        """Roll ``slot`` back to ``n`` tokens (speculative-decode rejection).

        Pages wholly past the new boundary drop one reference — the exact
        release path of :meth:`free`, so shared pages just lose our alias and
        exclusively-held ones return to the pool (cached tier when still
        indexed). Released pages go back into the slot's *reservation*, so a
        later :meth:`append` re-draws them without new admission — accept /
        reject churn is pool-neutral.

        The new tail page is special: if ``n`` is mid-page the slot will keep
        writing into it, and writing a **shared** page would corrupt every
        other reader — so a shared tail is un-aliased through the COW path
        (a fresh private page is drawn and the caller is told to copy the
        contents). Returns a list of ``(src_pid, dst_pid)`` pairs the caller
        must apply to the device pool before the next write; empty in the
        common all-private case. An indexed-but-exclusive tail is instead
        deregistered from the prefix index (its future contents diverge from
        what the index advertises).

        The un-alias draw is not covered by the admission reservation (shared
        pages were mapped, not reserved), so it can pathologically raise
        :class:`OutOfPages` on an exhausted pool. The engine never hits this:
        speculative rollback floors at the first *generated* token, which is
        always past the shared prompt pages.
        """
        n = int(n)
        copies: List[tuple] = []
        with self._lock:
            if not self._active[slot]:
                raise ValueError(f"slot {slot} is not active")
            length = int(self._lengths[slot])
            if not 1 <= n <= length:
                raise ValueError(
                    f"truncate to {n} outside [1, {length}] for slot {slot}")
            if n == length:
                return copies
            held = int(self._pages_held[slot])
            keep = self.pages_for(n, self.page_size)
            for i in range(keep, held):
                pid = int(self._tables[slot, i])
                self._refcount[pid] -= 1
                if self._refcount[pid] <= 0:
                    self._refcount[pid] = 0
                    if pid in self._page_key:
                        self._cached[pid] = None
                        self._cached.move_to_end(pid)
                    else:
                        self._free.append(pid)
                self._tables[slot, i] = 0
            self._pages_held[slot] = keep
            self._reserved[slot] += held - keep
            if n % self.page_size != 0:
                # the tail page will receive this slot's future writes
                pid = int(self._tables[slot, keep - 1])
                if self._refcount[pid] > 1:
                    dst = self._take_page_locked()
                    self._refcount[dst] = 1
                    self._refcount[pid] -= 1
                    self._tables[slot, keep - 1] = dst
                    copies.append((pid, dst))
                    self.metrics.incr("serving/kv/cow_unaliases")
                elif pid in self._page_key:
                    dg = self._page_key.pop(pid)
                    self._prefix_index.pop(dg, None)
            self._lengths[slot] = n
            self.metrics.incr("serving/kv/truncations")
            self._export_gauges_locked()
            return copies

    def free(self, slot: int) -> None:
        """Retire ``slot``: drop one reference from each held page; pages
        reaching refcount 0 return to the pool — straight to the free list,
        or to the cached tier when the prefix index still knows their
        contents. Idempotent."""
        with self._lock:
            if not self._active[slot]:
                return
            held = int(self._pages_held[slot])
            for i in range(held):
                pid = int(self._tables[slot, i])
                self._refcount[pid] -= 1
                if self._refcount[pid] <= 0:
                    self._refcount[pid] = 0
                    if pid in self._page_key:
                        self._cached[pid] = None
                        self._cached.move_to_end(pid)
                    else:
                        self._free.append(pid)
            self._tables[slot, :] = 0
            self._lengths[slot] = 0
            self._pages_held[slot] = 0
            self._reserved[slot] = 0
            self._active[slot] = False
            self._export_gauges_locked()

    # -- device operands -----------------------------------------------------

    def page_tables(self) -> np.ndarray:
        """``[num_slots, max_pages_per_slot]`` int32 — every entry a valid
        pool index (unassigned entries point at scratch page 0)."""
        with self._lock:
            return self._tables.copy()

    def lengths(self) -> np.ndarray:
        """``[num_slots]`` int32 tokens per slot (0 for inactive)."""
        with self._lock:
            return self._lengths.copy()

    def token_rooms(self) -> np.ndarray:
        """``[num_slots]`` int32 — tokens each slot can still append without
        outgrowing its admission reservation (``(held + reserved) * page_size
        - length``; 0 for inactive slots). The speculative decoder clamps its
        per-slot window to this so mid-burst appends never fail."""
        with self._lock:
            room = ((self._pages_held.astype(np.int64) + self._reserved)
                    * self.page_size - self._lengths)
            return np.where(self._active, room, 0).astype(np.int32)

    def active_slots(self) -> np.ndarray:
        with self._lock:
            return np.flatnonzero(self._active)

    def length(self, slot: int) -> int:
        with self._lock:
            return int(self._lengths[slot])

    def refcounts(self) -> np.ndarray:
        """``[num_pages]`` int32 per-page reference counts (scratch page 0
        is always 0)."""
        with self._lock:
            return self._refcount.copy()

    # -- stats ---------------------------------------------------------------

    def _used_frag_locked(self) -> tuple:
        used = int(np.count_nonzero(self._refcount > 0))
        tokens = int(self._lengths.sum())
        # with sharing, logical tokens can exceed distinct-page capacity,
        # so internal fragmentation clamps at 0
        frag = (max(0.0, 1.0 - tokens / (used * self.page_size))
                if used else 0.0)
        return used, tokens, frag

    def _export_gauges_locked(self) -> None:
        usable = self.num_pages - 1
        used, tokens, frag = self._used_frag_locked()
        occ = used / usable if usable else 0.0
        hit_rate = (self._prefix_hits / self._prefix_lookups
                    if self._prefix_lookups else 0.0)
        self.metrics.gauge("serving/kv/pages_total", usable)
        self.metrics.gauge("serving/kv/pages_used", used)
        self.metrics.gauge("serving/kv/pages_cached", len(self._cached))
        self.metrics.gauge("serving/kv/pages_reserved",
                           int(self._reserved.sum()))
        self.metrics.gauge("serving/kv/occupancy", occ)
        self.metrics.gauge("serving/kv/fragmentation", frag)
        self.metrics.gauge("serving/kv/tokens", tokens)
        self.metrics.gauge("serving/kv/slots_active",
                           int(self._active.sum()))
        # decode-plane summary for fleet dashboards (obs exporters render
        # these as decode_* in Prometheus exposition)
        self.metrics.gauge("decode/occupancy", occ)
        self.metrics.gauge("decode/fragmentation", frag)
        self.metrics.gauge("decode/prefix_hit_rate", hit_rate)
        self.metrics.gauge("decode/tokens_saved", self._tokens_saved)
        # quantized-capacity surface: the dtype exports as its KV_DTYPES
        # index so exposition stays numeric (0=bf16, 1=int8, 2=fp8)
        self.metrics.gauge("serving/kv/dtype_code",
                           KV_DTYPES.index(self.kv_dtype))
        if self.kv_bytes_per_page is not None:
            self.metrics.gauge("serving/kv/bytes_per_page",
                               self.kv_bytes_per_page)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            usable = self.num_pages - 1
            used, tokens, frag = self._used_frag_locked()
            return {
                "page_size": self.page_size,
                "pages_total": usable,
                "pages_used": used,
                # evictable supply: plain free pages + cached prefix pages
                "pages_free": len(self._free) + len(self._cached),
                "pages_cached": len(self._cached),
                "pages_reserved": int(self._reserved.sum()),
                "occupancy": used / usable if usable else 0.0,
                "fragmentation": frag,
                "tokens": tokens,
                "slots_active": int(self._active.sum()),
                "num_slots": self.num_slots,
                "prefix_lookups": self._prefix_lookups,
                "prefix_hits": self._prefix_hits,
                "prefix_hit_rate": (self._prefix_hits / self._prefix_lookups
                                    if self._prefix_lookups else 0.0),
                "prefix_blocks_indexed": len(self._prefix_index),
                "tokens_saved": self._tokens_saved,
                "kv_dtype": self.kv_dtype,
                "kv_bytes_per_page": self.kv_bytes_per_page,
            }
