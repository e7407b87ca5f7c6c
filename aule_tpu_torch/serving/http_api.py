"""Minimal HTTP serving front end over a ServingEngine (counterpart of
aule_tpu/serving/http_api.py: the same endpoints, JSON fields, status
codes and NDJSON chunks), stdlib only (http.server).

Endpoints (token-id level; tokenization is the caller's concern, same
contract as ServingEngine):

  POST /v1/completions
      {"prompt": [int, ...], "max_tokens": N,
       "temperature": 0.0, "top_k": 0, "top_p": 0.0,
       "eos_id": null, "stop": [[int, ...], ...],
       "logprobs": false, "logit_bias": {token: bias}, "lora": name,
       "stream": false}
      -> 200 {"id": int, "tokens": [...], "logprobs": [...]?,
              "cancelled": false}
      With "stream": true the response is chunked NDJSON: one
      {"id": ..., "token": t} line per generated token, then a final
      {"id": ..., "done": true, "cancelled": ...} line.  A client that
      goes away mid-stream cancels its request.

  POST /v1/cancel    {"id": int} -> {"cancelled": bool}
  GET  /health       {"status": "ok", **engine.stats()} — queue depths,
                     page pressure, token/dispatch counters, prefix-cache
                     and speculative-decoding effectiveness

  400 for a bad body, 404 for an unknown path; when the engine raises,
  every waiting request gets a 500, later ones a 503 and /health a 500
  with the error.

Threading model: ServingEngine is single-threaded by design, so ALL
engine interaction happens under one lock: handler threads only
submit/cancel and then wait on per-request events/queues; a driver
thread calls engine.step() whenever there is work.  Streaming tokens
come from the engine's on_token callback (which fires under the lock,
inside step()) through a thread-safe queue.  The engine's failure is
recorded and its waiters released under the same lock, and a handler
reads it there before it submits, so no request can register after the
waiters were released (the JAX package does both without the lock).  A
handler waiting for the lock goes before the driver's next step (the JAX
driver takes the lock back straight after each step, so under load a
cancel or /health could wait until the engine idles).
"""

from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .engine import Request, ServingEngine


class _Pending:
    __slots__ = ("event", "request", "stream_q")

    def __init__(self, streaming: bool):
        self.event = threading.Event()
        self.request: Optional[Request] = None
        self.stream_q: Optional[queue.Queue] = (
            queue.Queue() if streaming else None)


class ServingHTTPServer:
    """Drive `engine` behind an HTTP API.  start() returns immediately;
    the bound port is in `.port` (pass port=0 for an ephemeral one)."""

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 0):
        self.engine = engine
        self.error: Optional[str] = None  # set when the driver dies
        self._lock = threading.Lock()
        # handlers waiting for the lock: the driver lets them in before its
        # next step (`_locked`)
        self._waiting = 0
        self._count = threading.Lock()
        self._pending = {}          # req_id -> _Pending
        self._wake = threading.Event()   # new work submitted
        self._stop = threading.Event()

        outer = self

        class Handler(BaseHTTPRequestHandler):
            # chunked transfer is an HTTP/1.1 construct; the handler
            # default of HTTP/1.0 would make proxies/spec-compliant
            # clients read the stream raw (interleaved chunk framing)
            protocol_version = "HTTP/1.1"

            # quiet: BaseHTTPRequestHandler logs every request to stderr
            def log_message(self, fmt, *args):
                pass

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path != "/health":
                    return self._json(404, {"error": "unknown path"})
                with outer._locked():
                    stats = outer.engine.stats()
                if outer.error is not None:
                    return self._json(
                        500, {"status": "error", "error": outer.error,
                              **stats})
                self._json(200, {"status": "ok", **stats})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    return self._json(400, {"error": f"bad json: {e}"})
                if self.path == "/v1/cancel":
                    try:
                        rid = int(body["id"])
                    except (KeyError, ValueError, TypeError) as e:
                        return self._json(400, {"error": f"bad id: {e}"})
                    with outer._locked():
                        ok = outer.engine.cancel(rid)
                    return self._json(200, {"cancelled": ok})
                if self.path != "/v1/completions":
                    return self._json(404, {"error": "unknown path"})
                self._completions(body)

            def _completions(self, body):
                stream = bool(body.get("stream", False))
                pend = _Pending(stream)
                try:
                    with outer._locked():
                        died = outer.error
                        if died is None:
                            rid = outer.engine.submit(
                                body["prompt"],
                                max_new_tokens=int(body["max_tokens"]),
                                eos_id=body.get("eos_id"),
                                temperature=float(
                                    body.get("temperature", 0.0)),
                                top_k=int(body.get("top_k", 0)),
                                top_p=float(body.get("top_p", 0.0)),
                                logprobs=bool(body.get("logprobs", False)),
                                stop=body.get("stop"),
                                logit_bias=({int(k): float(v) for k, v in
                                             body["logit_bias"].items()}
                                            if body.get("logit_bias")
                                            else None),
                                lora=body.get("lora"),
                                on_token=(
                                    (lambda _rid, tok:
                                     pend.stream_q.put(tok)) if stream
                                    else None))
                            outer._pending[rid] = pend
                except (KeyError, ValueError, TypeError) as e:
                    return self._json(400, {"error": str(e)})
                if died is not None:
                    return self._json(
                        503, {"error": f"engine failed: {died}"})
                outer._wake.set()
                if not stream:
                    pend.event.wait()
                    r = pend.request
                    if r is None:  # driver died mid-request
                        return self._json(
                            500, {"error": outer.error or "engine died"})
                    out = {"id": rid, "tokens": list(r.output),
                           "cancelled": r.cancelled}
                    if r.want_logprobs:
                        out["logprobs"] = list(r.logprobs)
                    return self._json(200, out)
                # chunked NDJSON streaming
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj):
                    data = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(f"{len(data):x}\r\n".encode()
                                     + data + b"\r\n")
                    self.wfile.flush()

                try:
                    while True:
                        try:
                            tok = pend.stream_q.get(timeout=0.1)
                        except queue.Empty:
                            if pend.event.is_set() \
                                    and pend.stream_q.empty():
                                break
                            continue
                        chunk({"id": rid, "token": int(tok)})
                    pend.event.wait()
                    r = pend.request
                    chunk({"id": rid, "done": True,
                           "cancelled": r.cancelled if r is not None
                           else True,
                           **({"error": outer.error} if r is None
                              else {})})
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    # client went away mid-stream: free its batch slot
                    # and KV pages instead of generating to max_tokens
                    with outer._locked():
                        outer.engine.cancel(rid)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._drive_thread = threading.Thread(
            target=self._drive, daemon=True)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServingHTTPServer":
        self._serve_thread.start()
        self._drive_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._drive_thread.join(timeout=30)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- engine driver -----------------------------------------------------

    @contextlib.contextmanager
    def _locked(self):
        """The engine lock, for a handler: counted while it waits, so the
        driver, which would otherwise take the lock back straight after
        each step, lets every waiting handler in first."""
        with self._count:
            self._waiting += 1
        try:
            self._lock.acquire()
        finally:
            with self._count:
                self._waiting -= 1
        try:
            yield
        finally:
            self._lock.release()

    def _drive(self) -> None:
        while not self._stop.is_set():
            try:
                with self._lock:
                    busy = self.engine.has_work()
                    if busy:
                        self.engine.step()
                    done, self.engine.finished = \
                        self.engine.finished, []
            except Exception as e:  # noqa: BLE001 — the engine died;
                # fail every waiter loudly instead of hanging them and
                # flip /health to error (a silently dead server is the
                # worst failure mode for a load balancer); under the lock,
                # so a handler either registered before (released here) or
                # sees the error before it submits
                with self._lock:
                    self.error = repr(e)
                    for pend in list(self._pending.values()):
                        pend.request = None
                        pend.event.set()
                    self._pending.clear()
                return
            for r in done:
                pend = self._pending.pop(r.req_id, None)
                if pend is not None:
                    pend.request = r
                    pend.event.set()
            while self._waiting and not self._stop.is_set():
                time.sleep(1e-4)  # a cancel, a submit or /health goes first
            if not busy:
                # idle: block until a handler submits (or stop)
                self._wake.wait(timeout=0.5)
                self._wake.clear()
