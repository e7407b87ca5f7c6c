"""Minimal TCP wire transport for the multi-process serving pool
(counterpart of aule_tpu/serving/transport.py; the port keeps its own
copy).

Replicas own disjoint KV pools and page allocators, so only request and
response tuples cross between hosts, never KV pages
(serving/multihost.py).  This module gives the pool's queue pair a
deployable form:

  * `QueueTransportServer` exports a host-local (req_q, res_q) pair over
    one TCP listen socket.
  * `RemoteQueue` is the client stub: it implements exactly the queue
    surface the worker loop touches (`get`, `get_nowait`, `put`), so
    serving/worker.py's `worker_main` runs unchanged over TCP.

Framing: 4-byte big-endian length + pickle, the JAX package's wire format
byte for byte.  Pickle is acceptable only between mutually trusted hosts
of one serving fleet on a private network, never on a public edge.
"""

from __future__ import annotations

import pickle
import queue as _queue
import socket
import struct
import threading
from typing import Optional


def _send_msg(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("peer closed")
        buf += part
    return buf


def _recv_msg(sock: socket.socket):
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    return pickle.loads(_recv_exact(sock, n))


class QueueTransportServer:
    """Serves a (req_q, res_q) pair to N remote workers.

    Protocol (client -> server):
      ("get", qname, timeout) -> ("item", obj) | ("empty",)
      ("put", qname, obj)     -> ("ok",)
    """

    def __init__(self, req_q, res_q, host: str = "127.0.0.1",
                 port: int = 0):
        self._queues = {"req": req_q, "res": res_q}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()
        self._stopping = False
        self._threads = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stopping:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stopping:
                try:
                    msg = _recv_msg(conn)
                except (ConnectionError, EOFError, OSError):
                    return
                op, qname = msg[0], msg[1]
                q = self._queues[qname]
                if op == "get":
                    timeout = msg[2]
                    try:
                        if timeout == "nowait" or timeout is None:
                            # None kept for wire-compat with old clients
                            item = q.get_nowait()
                        else:
                            item = q.get(timeout=timeout)
                        _send_msg(conn, ("item", item))
                    except _queue.Empty:
                        _send_msg(conn, ("empty",))
                elif op == "put":
                    q.put(msg[2])
                    _send_msg(conn, ("ok",))
                else:  # pragma: no cover - protocol misuse
                    _send_msg(conn, ("err", f"bad op {op!r}"))
        finally:
            conn.close()

    def stop(self) -> None:
        self._stopping = True
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass


class RemoteQueue:
    """Client stub exposing the queue surface the worker loop uses."""

    def __init__(self, host: str, port: int, name: str):
        if name not in ("req", "res"):
            raise ValueError(f"unknown queue {name!r}")
        self._name = name
        self._sock = socket.create_connection((host, port), timeout=600)
        self._lock = threading.Lock()

    def _rpc(self, msg):
        with self._lock:
            _send_msg(self._sock, msg)
            return _recv_msg(self._sock)

    def get(self, timeout: Optional[float] = None):
        """queue.Queue semantics: timeout=None blocks until an item
        arrives (bounded server waits in a loop so one slow client
        can't pin a server thread forever); timeout=x waits up to x."""
        if timeout is None:
            while True:
                reply = self._rpc(("get", self._name, 1.0))
                if reply[0] == "item":
                    return reply[1]
        reply = self._rpc(("get", self._name, float(timeout)))
        if reply[0] == "item":
            return reply[1]
        raise _queue.Empty()

    def get_nowait(self):
        reply = self._rpc(("get", self._name, "nowait"))
        if reply[0] == "item":
            return reply[1]
        raise _queue.Empty()

    def put(self, item) -> None:
        reply = self._rpc(("put", self._name, item))
        if reply[0] != "ok":  # pragma: no cover - protocol misuse
            raise RuntimeError(f"put failed: {reply!r}")

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass
