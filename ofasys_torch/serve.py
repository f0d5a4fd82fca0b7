"""Dynamic-batching inference server (counterpart of ofasys_tpu/serve.py,
same behaviour).

  * queues concurrent requests and groups them by (instruction,
    generation options),
  * pads each group's batch up to a power-of-two bucket (replicating the
    final record) and slices the answers back out, so the batch sizes the
    model sees stay few,
  * runs generation on a single dispatcher thread, one batch on the card
    at a time, resolving a concurrent.futures.Future per request.

Usage:
    srv = InferenceServer(hub, max_batch=8, max_wait_ms=5)
    fut = srv.submit("[TEXT:src] -> [TEXT:tgt]", {"src": "hello"})
    print(fut.result().text)
    srv.stats()          # requests, batches, mean occupancy, p50 latency
    srv.close()

``serve_http(srv, port=8000)`` exposes ``POST /v1/generate`` (JSON, stdlib
http.server — no extra dependencies).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ofasys_torch.utils.device import resolve_device

logger = logging.getLogger("ofasys_torch.serve")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class _Request:
    key: Tuple
    instruction: str
    data: Dict[str, Any]
    overrides: Dict[str, Any]
    future: Future
    t_submit: float


class InferenceServer:
    """Groups concurrent ``submit`` calls into batched ``hub.inference``
    dispatches. Thread-safe; one dispatcher thread owns the card.

    ``device`` must be the hub's device; CUDA is the default, and the
    server raises when CUDA is absent."""

    def __init__(self, hub, max_batch: int = 8, max_wait_ms: float = 5.0,
                 bucket_batches: bool = True, device: Union[str, torch.device] = "cuda"):
        dev = resolve_device(device)
        if dev != hub.device:
            raise ValueError(f"InferenceServer device {dev} differs from the hub's {hub.device}")
        self.hub = hub
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max_wait_ms / 1000.0
        self.bucket_batches = bucket_batches
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._pending: Dict[Tuple, List[_Request]] = {}
        self._lock = threading.Lock()
        self._n_requests = 0
        self._n_batches = 0
        self._n_batched_requests = 0
        self._latencies: List[float] = []
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ofasys-serve-dispatch")
        self._thread.start()

    # ---------------------------------------------------------------- API
    def submit(self, instruction: str, data: Optional[Dict[str, Any]] = None,
               **gen_overrides) -> Future:
        """Enqueue one request; returns a Future resolving to the same
        object ``hub.inference`` returns for a single record."""
        if not self._running:
            raise RuntimeError("InferenceServer is closed")
        key = (str(instruction), tuple(sorted(gen_overrides.items())))
        req = _Request(key, str(instruction), dict(data or {}),
                       dict(gen_overrides), Future(), time.perf_counter())
        with self._lock:
            self._n_requests += 1
        self._q.put(req)
        return req.future

    def generate(self, instruction: str, data: Optional[Dict[str, Any]] = None,
                 timeout: Optional[float] = None, **gen_overrides):
        """Blocking convenience wrapper around ``submit``."""
        return self.submit(instruction, data, **gen_overrides).result(timeout)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lats = sorted(self._latencies)
            return {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "mean_batch_occupancy": (
                    self._n_batched_requests / self._n_batches
                    if self._n_batches else 0.0
                ),
                "p50_latency_ms": (
                    round(lats[len(lats) // 2] * 1000.0, 2) if lats else None
                ),
                "queued": self._q.qsize(),
            }

    def close(self, timeout: float = 30.0):
        """Drain the queue, stop the dispatcher. Idempotent."""
        if not self._running:
            return
        self._running = False
        self._q.put(None)  # wake the dispatcher
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------- dispatch
    def _collect(self, first: _Request) -> List[_Request]:
        """Gather up to max_batch same-key requests, waiting at most
        max_wait_s for stragglers (classic dynamic batching)."""
        group = [first]
        deadline = time.perf_counter() + self.max_wait_s
        leftovers: List[_Request] = []
        while len(group) < self.max_batch:
            remain = deadline - time.perf_counter()
            try:
                req = self._q.get(timeout=max(remain, 0.0) if remain > 0 else None,
                                  block=remain > 0)
            except queue.Empty:
                break
            if req is None:          # shutdown sentinel: put it back for _loop
                self._q.put(None)
                break
            if req.key == first.key:
                group.append(req)
            else:
                leftovers.append(req)
        for req in leftovers:        # different template/options: next rounds
            self._q.put(req)
        return group

    def _loop(self):
        while True:
            try:
                req = self._q.get(timeout=0.1)
            except queue.Empty:
                if not self._running:
                    return
                continue
            if req is None:
                if self._running:
                    continue
                # shutdown: drain — everything submitted before close() still
                # gets an answer
                while True:
                    try:
                        req = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if req is not None:
                        self._dispatch(self._collect(req))
            group = self._collect(req)
            self._dispatch(group)

    def _dispatch(self, group: List[_Request]):
        records = [r.data for r in group]
        n = len(records)
        if self.bucket_batches and n > 1:
            # pad to the power-of-two bucket: at most log2(max_batch) batch
            # shapes per template
            target = min(_next_pow2(n), self.max_batch)
            records = records + [records[-1]] * (target - n)
        try:
            if len(records) == 1:
                outs = [self.hub.inference(group[0].instruction, records[0],
                                           **group[0].overrides)]
            else:
                outs = self.hub.inference(group[0].instruction, records,
                                          **group[0].overrides)
        except Exception as e:  # noqa: BLE001 — failures propagate per-request
            for r in group:
                if not r.future.cancelled():
                    r.future.set_exception(e)
            return
        now = time.perf_counter()
        with self._lock:
            self._n_batches += 1
            self._n_batched_requests += n
            self._latencies.extend(now - r.t_submit for r in group)
            if len(self._latencies) > 10000:
                self._latencies = self._latencies[-5000:]
        for r, out in zip(group, outs):
            if not r.future.cancelled():
                r.future.set_result(out)


# -------------------------------------------------------------------- HTTP
def _output_to_json(out) -> Dict[str, Any]:
    """Serialize a generator output (or n-best list) to JSON-able fields."""
    if isinstance(out, list):
        return {"nbest": [_output_to_json(o) for o in out]}
    d: Dict[str, Any] = {}
    for field in ("text", "score", "box", "tokens"):
        v = getattr(out, field, None)
        if v is None:
            continue
        if isinstance(v, np.ndarray) or hasattr(v, "tolist"):
            v = v.tolist()
        if isinstance(v, float) and v != v:  # NaN is not valid strict JSON
            v = None
        if isinstance(v, (str, int, float, list)):
            d[field] = v
    if not d:
        d["repr"] = repr(out)[:500]
    return d


def serve_http(server: InferenceServer, host: str = "127.0.0.1", port: int = 8000,
               block: bool = True):
    """Minimal JSON endpoint over the batching server (stdlib only).

    POST /v1/generate  {"instruction": "...", "data": {...}, "options": {...}}
        -> 200 {"output": {...}}
    GET  /v1/stats     -> 200 stats()

    Returns the http.server instance; when ``block`` is False it runs on a
    daemon thread (call ``.shutdown()`` to stop).
    """
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def _send(self, code: int, payload: Dict[str, Any]):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path.rstrip("/") == "/v1/stats":
                self._send(200, server.stats())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):  # noqa: N802
            if self.path.rstrip("/") != "/v1/generate":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                fut = server.submit(
                    payload["instruction"], payload.get("data") or {},
                    **(payload.get("options") or {}),
                )
                out = fut.result()
                self._send(200, {"output": _output_to_json(out)})
            except Exception as e:  # noqa: BLE001 — report to the client
                self._send(400, {"error": repr(e)[:500]})

        def log_message(self, fmt, *args):
            logger.debug("http: " + fmt, *args)

    httpd = http.server.ThreadingHTTPServer((host, port), Handler)
    if block:
        logger.info("serving on http://%s:%d/v1/generate", host, port)
        httpd.serve_forever()
    else:
        t = threading.Thread(target=httpd.serve_forever, daemon=True,
                             name="ofasys-serve-http")
        t.start()
    return httpd
