"""Host data plane: native batch queue + fast CSV, with numpy fallbacks —
carried from the JAX package.

This is the ingest path between row-oriented sources (Spark partitions,
localml DataFrames, CSV files) and the trainer's fixed-shape device batches.
The native library (``sparkflow_tpu_torch/native/dataplane.cpp``) assembles padded,
masked, shuffled batches on a C++ thread with the GIL released; when the
toolchain is unavailable everything still works via numpy.
"""

from __future__ import annotations

import ctypes
import queue as _pyqueue
import threading
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from ..native.build import load_library


def load_csv_matrix(path: str) -> np.ndarray:
    """Numeric CSV -> float32 [rows, cols] matrix (native parser when built;
    ~an order of magnitude faster than the pure-python csv reader)."""
    lib = load_library()
    if lib is not None:
        rows = ctypes.c_int64()
        cols = ctypes.c_int64()
        ptr = lib.sf_csv_load(path.encode(), ctypes.byref(rows), ctypes.byref(cols))
        if ptr:
            try:
                n = rows.value * cols.value
                arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
                return arr.reshape(rows.value, cols.value)
            finally:
                lib.sf_free(ptr)
    return np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)


class BatchQueue:
    """Bounded queue of fixed-shape (x, y, mask, n_real) batches.

    Producer side: ``push(rows, labels)`` any number of times, then
    ``finish()``. Consumer side: iterate — each item is a ready padded batch.
    Backed by the native ring buffer when available, else a Python thread-safe
    fallback with identical semantics.
    """

    def __init__(self, batch_size: int, row_dim: int, label_dim: int = 0,
                 capacity: int = 8, shuffle: bool = True, seed: int = 0):
        self.batch_size = batch_size
        self.row_dim = row_dim
        self.label_dim = label_dim
        self._cv = threading.Condition()
        self._active = 0      # threads currently inside a native call
        self._closed = False
        self._lib = load_library()
        if self._lib is not None:
            self._q = self._lib.sfq_create(batch_size, row_dim, label_dim,
                                           capacity, int(shuffle), seed)
            if not self._q:
                self._lib = None
        if self._lib is None:
            self._pyq: _pyqueue.Queue = _pyqueue.Queue(maxsize=capacity)
            self._stage_x: list = []
            self._stage_y: list = []
            self._rng = np.random.RandomState(seed)
            self._shuffle = shuffle
            self._finished = False

    def _enter(self):
        """Register a native call so close() can drain before freeing."""
        with self._cv:
            if self._closed:
                raise RuntimeError("queue closed")
            self._active += 1
            return self._q

    def _exit(self):
        with self._cv:
            self._active -= 1
            self._cv.notify_all()

    # -- producer -----------------------------------------------------------

    def push(self, rows: np.ndarray, labels: Optional[np.ndarray] = None) -> None:
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if labels is not None:
            labels = np.ascontiguousarray(labels, dtype=np.float32)
        if self._lib is not None:
            xp = rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            yp = (labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                  if labels is not None else None)
            handle = self._enter()
            try:
                n = self._lib.sfq_push(handle, xp, yp, rows.shape[0])
            finally:
                self._exit()
            if n != rows.shape[0]:
                raise RuntimeError("queue closed during push")
            return
        for i in range(rows.shape[0]):
            self._stage_x.append(rows[i])
            if labels is not None:
                self._stage_y.append(labels[i])
            if len(self._stage_x) == self.batch_size:
                self._emit()

    def _emit(self) -> None:
        n = len(self._stage_x)
        x = np.zeros((self.batch_size, self.row_dim), np.float32)
        y = np.zeros((self.batch_size, self.label_dim), np.float32)
        mask = np.zeros((self.batch_size,), np.float32)
        order = self._rng.permutation(n) if self._shuffle else np.arange(n)
        for i, src in enumerate(order):
            x[i] = self._stage_x[src]
            if self._stage_y:
                y[i] = self._stage_y[src]
            mask[i] = 1.0
        self._stage_x, self._stage_y = [], []
        while True:  # bounded put that close() can interrupt
            if self._closed:
                raise RuntimeError("queue closed")
            try:
                self._pyq.put((x, y, mask, n), timeout=0.1)
                return
            except _pyqueue.Full:
                continue

    def finish(self) -> None:
        if self._lib is not None:
            handle = self._enter()
            try:
                self._lib.sfq_finish(handle)
            finally:
                self._exit()
            return
        if self._stage_x:
            self._emit()
        self._finished = True
        self._pyq.put(None)

    # -- consumer -----------------------------------------------------------

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
        while True:
            item = self.pop()
            if item is None:
                return
            yield item

    def pop(self):
        if self._lib is not None:
            x = np.empty((self.batch_size, self.row_dim), np.float32)
            y = np.empty((self.batch_size, max(self.label_dim, 1)), np.float32)
            mask = np.empty((self.batch_size,), np.float32)
            handle = self._enter()
            try:
                n = self._lib.sfq_pop(
                    handle,
                    x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            finally:
                self._exit()
            if n < 0:
                raise RuntimeError("queue closed during pop")
            if n == 0:
                return None
            return x, y[:, :self.label_dim], mask, int(n)
        item = self._pyq.get()
        return item

    def close(self) -> None:
        """Tear down safely even with a producer/consumer mid-call: mark
        closed (wakes blocked native calls), wait for every thread to leave
        the native layer, then free. Idempotent."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            handle = getattr(self, "_q", None)
        if self._lib is not None and handle:
            self._lib.sfq_close(handle)        # wake + fail blocked calls
            with self._cv:
                while self._active > 0:
                    self._cv.wait()
                self._lib.sfq_destroy(handle)  # drains C++-side inflight too
                self._q = None
        elif self._lib is None:
            # unblock a producer stuck in put() and deliver EOF to consumers
            try:
                while True:
                    self._pyq.get_nowait()
            except _pyqueue.Empty:
                pass
            try:
                self._pyq.put_nowait(None)
            except _pyqueue.Full:  # pragma: no cover
                pass

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def feed_from_iterator(q: BatchQueue, it: Iterable, supervised: bool,
                       chunk: int = 1024) -> threading.Thread:
    """Spawn a daemon thread pushing (features[, label]) items into the queue —
    the producer half of streaming training (``Trainer.fit_stream``)."""

    def run():
        from ..ml_util import handle_features

        def push(buf):
            f, l = handle_features(buf, is_supervised=supervised)
            if isinstance(f, tuple):
                # multi-input rows ride the ring CONCATENATED into one flat
                # row (the ring is a single matrix); the consumer splits the
                # batch back into per-input arrays by the known widths
                f = np.concatenate(f, axis=1)
            q.push(f, l)

        buf = []
        try:
            for item in it:
                buf.append(item)
                if len(buf) >= chunk:
                    push(buf)
                    buf.clear()
            if buf:
                push(buf)
        finally:
            q.finish()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t
