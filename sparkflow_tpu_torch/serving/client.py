"""Minimal stdlib client for :class:`~sparkflow_tpu_torch.serving.server.InferenceServer`.

Deliberately tiny — ``http.client`` plus JSON — because its jobs are the
smoke path (``make serve-smoke``), the e2e tests, and showing the wire
protocol in ~30 lines. Production callers can speak the same JSON from any
HTTP stack.

Connections are **keep-alive**: the client owns a small pool of persistent
``HTTPConnection`` objects (:class:`ConnectionPool`), so repeated calls —
the router's 2 Hz health probes, hedged duplicates, test bursts — pay the
TCP handshake once, not per request. A request that lands on a stale pooled
connection (the server restarted, or an idle-timeout closed it) is retried
once on a fresh one; that retry only covers wire-level "the connection died
before a response started" signatures, never timeouts, so a slow predict is
not silently re-executed.

Resilience: :meth:`ServingClient.predict` retries connection errors and
``503`` rejections (queue-full backpressure, drains during a rolling
restart) with jittered exponential backoff, honoring the server's
``Retry-After`` hint and a hard wall-clock deadline. ``retries=0`` opts a
call out entirely (first error propagates untouched). Every read path
accepts a per-request ``timeout_s`` overriding the client-wide timeout, so
a health probe can be impatient while predictions stay patient.
"""

from __future__ import annotations

import http.client
import json
import threading
import urllib.error
from typing import Any, Dict, Optional, Tuple
from urllib.parse import urlsplit

import numpy as np

from ..obs.spans import TRACEPARENT_HEADER, TraceContext
from ..resilience.retry import RetryExhausted, RetryPolicy

# Wire-level failures that mean "this pooled connection is dead" — safe to
# retry once on a fresh connection because no response ever started.
# Timeouts are deliberately excluded: the server may be mid-predict.
_STALE_CONN_ERRORS = (http.client.BadStatusLine,
                      http.client.RemoteDisconnected,
                      ConnectionResetError, ConnectionAbortedError,
                      BrokenPipeError)


class ServingError(Exception):
    """Non-2xx reply from the server. Carries the structured error body and,
    when the server sent one, the ``Retry-After`` hint (seconds)."""

    def __init__(self, status: int, code: str, message: str,
                 retry_after: Optional[float] = None):
        super().__init__(f"HTTP {status} [{code}]: {message}")
        self.status = status
        self.code = code
        self.message = message
        self.retry_after = retry_after


class ConnectionPool:
    """Bounded stack of idle keep-alive connections to one ``host:port``.

    ``acquire`` pops an idle connection (or dials a new one) — the caller
    owns it exclusively until ``release``. ``release(conn, reuse=True)``
    returns it for the next caller; ``reuse=False`` closes it (error paths,
    ``Connection: close`` responses). The pool holds its lock only around
    the idle-stack push/pop, never during I/O, so concurrent callers each
    check out their own connection and proceed in parallel.
    """

    def __init__(self, host: str, port: int, timeout_s: float = 30.0,
                 max_idle: int = 8):
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self.max_idle = int(max_idle)
        self._lock = threading.Lock()
        self._idle: list = []
        self._closed = False

    def acquire(self, timeout_s: Optional[float] = None
                ) -> Tuple[http.client.HTTPConnection, bool]:
        """Returns ``(conn, reused)`` — ``reused`` tells the caller whether
        a dead-connection error is a stale keep-alive (retry on a fresh
        one) or a real connect failure (propagate)."""
        t = self.timeout_s if timeout_s is None else float(timeout_s)
        with self._lock:
            conn = self._idle.pop() if self._idle else None
        if conn is not None:
            try:
                if conn.sock is not None:
                    conn.sock.settimeout(t)
                else:
                    conn.timeout = t
            except OSError:
                # the idle socket died while pooled — close it and fall
                # through to a fresh dial; raising here would leak a
                # checked-out-but-never-returned connection
                conn.close()
            else:
                return conn, True
        return http.client.HTTPConnection(self.host, self.port, timeout=t), \
            False

    def release(self, conn: http.client.HTTPConnection,
                reuse: bool = True) -> None:
        if reuse:
            with self._lock:
                if not self._closed and len(self._idle) < self.max_idle:
                    self._idle.append(conn)
                    return
        conn.close()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()


class ServingClient:
    """``ServingClient(url).predict(rows)`` → np.ndarray of predictions.

    ``retries`` is the default number of re-attempts after a retryable
    failure (connection refused/reset, HTTP 503); ``retry_policy`` (a
    :class:`~sparkflow_tpu_torch.resilience.retry.RetryPolicy`) shapes the backoff
    and supplies the optional ``deadline_s`` — the default policy backs off
    0.1s/0.2s/0.4s... (jittered) with no deadline. A spent budget raises
    :class:`~sparkflow_tpu_torch.resilience.retry.RetryExhausted` chained to the
    last error.
    """

    def __init__(self, url: str, timeout: float = 30.0, retries: int = 3,
                 retry_policy: Optional[RetryPolicy] = None,
                 max_idle: int = 8):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.retries = int(retries)
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=self.retries + 1, base_s=0.1, multiplier=2.0,
            max_s=5.0, jitter=0.5, seed=0)
        parts = urlsplit(self.url)
        if parts.scheme not in ("http", ""):
            raise ValueError(f"only http:// urls are supported, got {url!r}")
        self._pool = ConnectionPool(parts.hostname or "127.0.0.1",
                                    parts.port or 80, timeout_s=timeout,
                                    max_idle=max_idle)

    def close(self) -> None:
        """Drop the pooled keep-alive connections (the server sees clean
        disconnects instead of idle sockets)."""
        self._pool.close()

    def __enter__(self) -> "ServingClient":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- wire ----------------------------------------------------------------

    def _http(self, method: str, path: str, body: Optional[bytes],
              headers: Dict[str, str], timeout_s: Optional[float] = None
              ) -> Tuple[int, Dict[str, str], bytes]:
        """One request over a pooled connection; returns
        ``(status, headers, raw_body)``. A stale pooled connection gets one
        fresh-connection retry."""
        for last_try in (False, True):
            conn, reused = self._pool.acquire(timeout_s)
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except _STALE_CONN_ERRORS:
                self._pool.release(conn, reuse=False)
                if reused and not last_try:
                    continue
                raise
            except Exception:
                self._pool.release(conn, reuse=False)
                raise
            self._pool.release(conn, reuse=not resp.will_close)
            return resp.status, {k: v for k, v in resp.getheaders()}, data
        raise AssertionError("unreachable")  # pragma: no cover

    def _request(self, path: str, payload: Optional[Dict[str, Any]] = None,
                 headers: Optional[Dict[str, str]] = None,
                 with_headers: bool = False,
                 timeout_s: Optional[float] = None):
        status, hdrs, data = self._http(
            "POST" if payload is not None else "GET", path,
            (json.dumps(payload).encode("utf-8")
             if payload is not None else None),
            {"Content-Type": "application/json", **(headers or {})},
            timeout_s)
        if status >= 400:
            ra = hdrs.get("Retry-After")
            try:
                retry_after = float(ra) if ra is not None else None
            except ValueError:
                retry_after = None
            try:
                err = json.loads(data.decode("utf-8"))["error"]
                raise ServingError(status, err.get("code", "unknown"),
                                   err.get("message", ""), retry_after)
            except (ValueError, KeyError, UnicodeDecodeError):
                raise ServingError(status, "unknown",
                                   data.decode("utf-8", "replace")[:200],
                                   retry_after) from None
        body = json.loads(data.decode("utf-8"))
        if with_headers:
            return body, hdrs
        return body

    @staticmethod
    def _retryable(exc: Exception) -> bool:
        if isinstance(exc, ServingError):
            return exc.status == 503  # queue_full / draining backpressure
        # connection refused/reset, socket timeouts, torn keep-alives
        return isinstance(exc, (OSError, http.client.HTTPException,
                                urllib.error.URLError))

    def predict(self, inputs, retries: Optional[int] = None,
                timeout_s: Optional[float] = None) -> np.ndarray:
        """``inputs``: rows (list/array) or, for multi-input engines, a dict
        of ``{input_name: rows}``. Retryable failures (connection errors,
        503) back off and re-send up to ``retries`` times (default: the
        client's setting; 0 = fail fast); anything else — 400s, 500s —
        raises :class:`ServingError` immediately. ``timeout_s`` bounds each
        attempt (default: the client-wide timeout)."""
        if isinstance(inputs, dict):
            wire: Any = {k: np.asarray(v).tolist() for k, v in inputs.items()}
        else:
            wire = np.asarray(inputs).tolist()
        payload = {"inputs": wire}
        budget = (self.retries if retries is None else int(retries)) + 1
        policy = self.retry_policy
        start = policy.clock()
        attempt = 0
        while True:
            try:
                reply = self._request("/v1/predict", payload,
                                      timeout_s=timeout_s)
                return np.asarray(reply["predictions"])
            except (ServingError, OSError,
                    http.client.HTTPException) as e:
                attempt += 1
                if not self._retryable(e) or attempt >= budget:
                    raise
                delay = policy.backoff(attempt - 1)
                hint = getattr(e, "retry_after", None)
                if hint is not None:
                    # the server knows its own drain/queue horizon better
                    # than our backoff curve does
                    delay = max(delay, float(hint))
                elapsed = policy.clock() - start
                if (policy.deadline_s is not None
                        and elapsed + delay > policy.deadline_s):
                    raise RetryExhausted(
                        f"predict against {self.url}", attempt, elapsed,
                        e) from e
                policy.sleep(delay)

    @staticmethod
    def _wire_headers(request_id: Optional[str],
                      traceparent) -> Optional[Dict[str, str]]:
        headers: Dict[str, str] = {}
        if request_id:
            headers["X-Request-Id"] = request_id
        if traceparent is not None:
            if isinstance(traceparent, TraceContext):
                traceparent = traceparent.to_header()
            headers[TRACEPARENT_HEADER] = str(traceparent)
        return headers or None

    def generate(self, prompt, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id: Optional[int] = None, seed: Optional[int] = None,
                 request_id: Optional[str] = None,
                 traceparent=None,
                 retries: Optional[int] = None,
                 timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """``POST /v1/generate``: autoregressive decode of ``prompt`` (a list
        of token ids). Returns the full reply — ``tokens``, ``num_tokens``,
        ``finish_reason``, ``request_id``, ``timing_ms``, plus the echoed
        ``X-Request-Id`` header as ``x_request_id_header``. Retry semantics
        match :meth:`predict` (503s and connection errors back off and
        re-send; 400s/500s raise immediately). ``traceparent`` (a
        :class:`~sparkflow_tpu_torch.obs.spans.TraceContext` or a raw header
        string) joins this call to an existing distributed trace; the
        router/server otherwise mint a fresh one."""
        payload: Dict[str, Any] = {
            "prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
            "top_k": int(top_k),
        }
        if eos_id is not None:
            payload["eos_id"] = int(eos_id)
        if seed is not None:
            payload["seed"] = int(seed)
        headers = self._wire_headers(request_id, traceparent)
        budget = (self.retries if retries is None else int(retries)) + 1
        policy = self.retry_policy
        start = policy.clock()
        attempt = 0
        while True:
            try:
                # graftcheck: dispatch-site
                body, hdrs = self._request("/v1/generate", payload,
                                           headers=headers,
                                           with_headers=True,
                                           timeout_s=timeout_s)
                body["x_request_id_header"] = hdrs.get("X-Request-Id")
                return body
            except (ServingError, OSError,
                    http.client.HTTPException) as e:
                attempt += 1
                if not self._retryable(e) or attempt >= budget:
                    raise
                delay = policy.backoff(attempt - 1)
                hint = getattr(e, "retry_after", None)
                if hint is not None:
                    delay = max(delay, float(hint))
                elapsed = policy.clock() - start
                if (policy.deadline_s is not None
                        and elapsed + delay > policy.deadline_s):
                    raise RetryExhausted(
                        f"generate against {self.url}", attempt, elapsed,
                        e) from e
                policy.sleep(delay)

    def predict_full(self, inputs, request_id: Optional[str] = None,
                     traceparent=None,
                     timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """One attempt (no retries), full reply: ``predictions``, ``rows``,
        the server's ``request_id`` (yours, echoed, if you passed one) and
        the per-request ``timing_ms`` latency decomposition. The echoed
        ``X-Request-Id`` response header is surfaced as
        ``x_request_id_header``. ``traceparent`` joins the call to an
        existing distributed trace (see :meth:`generate`)."""
        if isinstance(inputs, dict):
            wire: Any = {k: np.asarray(v).tolist() for k, v in inputs.items()}
        else:
            wire = np.asarray(inputs).tolist()
        # graftcheck: dispatch-site
        body, hdrs = self._request(
            "/v1/predict", {"inputs": wire},
            headers=self._wire_headers(request_id, traceparent),
            with_headers=True, timeout_s=timeout_s)
        body["x_request_id_header"] = hdrs.get("X-Request-Id")
        return body

    def healthz(self, timeout_s: Optional[float] = None) -> Dict[str, Any]:
        return self._request("/healthz", timeout_s=timeout_s)

    def metrics(self, timeout_s: Optional[float] = None) -> Dict[str, Any]:
        return self._request("/metrics", timeout_s=timeout_s)

    def metrics_prometheus(self, timeout_s: Optional[float] = None) -> str:
        """Raw Prometheus text exposition from
        ``GET /metrics?format=prometheus``."""
        status, _hdrs, data = self._http(
            "GET", "/metrics?format=prometheus", None, {}, timeout_s)
        if status >= 400:
            raise ServingError(status, "unknown",
                               data.decode("utf-8", "replace")[:200])
        return data.decode("utf-8")
