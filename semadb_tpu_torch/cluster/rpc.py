"""RPC transport: msgpack-over-HTTP mesh with retries and self-routing.

Parity reference: cluster/rpc.go + cluster/mrpc/ — the reference speaks Go
net/rpc over a hijacked HTTP CONNECT with a msgpack codec, caches one
client per destination, and retries with exponential backoff (2s, 4s, 8s…)
inside a timeout (rpc.go:42-109). Here the wire protocol is plain
``POST /rpc/<Method>`` with msgpack request/response bodies — simpler and
language-neutral — with the same cached-session, retry/backoff, and
dead-client-eviction behavior. Every handler self-routes when
``dest == my_hostname`` (rpchandlers.go:49-51), which is what lets a
single-node cluster exercise the full routing path without a network.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict

import msgpack

from semadb_tpu_torch.models.errors import TimeoutError_

RPC_PATH_PREFIX = "/rpc/"


class RPCError(Exception):
    pass


class RPCClientPool:
    """Cached HTTP sessions per destination (rpc.go:11-24)."""

    def __init__(self, timeout: float = 30.0, retries: int = 2, backoff: float = 2.0):
        self.timeout = timeout
        self.retries = retries
        self.backoff = backoff
        self._sessions: Dict[str, Any] = {}
        self._mu = threading.Lock()

    def _session(self, dest: str):
        import requests

        with self._mu:
            s = self._sessions.get(dest)
            if s is None:
                s = requests.Session()
                self._sessions[dest] = s
            return s

    def _evict(self, dest: str) -> None:
        with self._mu:
            s = self._sessions.pop(dest, None)
        if s is not None:
            try:
                s.close()
            except Exception:
                pass

    def call(self, dest: str, method: str, payload: dict) -> dict:
        """Call with exponential backoff retries + dead-client eviction
        (rpc.go:52-108)."""
        deadline = time.monotonic() + self.timeout
        delay = self.backoff
        last_err: Exception | None = None
        for attempt in range(self.retries + 1):
            if time.monotonic() > deadline:
                raise TimeoutError_(f"rpc timeout calling {method} on {dest}")
            try:
                s = self._session(dest)
                resp = s.post(
                    f"http://{dest}{RPC_PATH_PREFIX}{method}",
                    data=msgpack.packb(payload, use_bin_type=True),
                    headers={"Content-Type": "application/msgpack"},
                    timeout=max(deadline - time.monotonic(), 0.1),
                )
                if resp.status_code != 200:
                    raise RPCError(
                        f"rpc {method} on {dest} failed: {resp.status_code}"
                        f" {resp.text[:200]}"
                    )
                out = msgpack.unpackb(resp.content, raw=False, strict_map_key=False)
                if isinstance(out, dict) and out.get("__error"):
                    raise RPCError(out["__error"])
                return out
            except RPCError:
                raise  # handler-level errors don't retry
            except Exception as e:  # connection-level: evict + retry
                last_err = e
                self._evict(dest)
                if attempt < self.retries:
                    time.sleep(min(delay, max(deadline - time.monotonic(), 0)))
                    delay *= 2
        raise RPCError(f"rpc {method} on {dest} failed after retries: {last_err}")


class RPCServer:
    """Threaded HTTP server exposing registered handlers under /rpc/."""

    def __init__(self, host: str, port: int, handlers: Dict[str, Callable[[dict], dict]]):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        handler_map = handlers

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_POST(self):
                if not self.path.startswith(RPC_PATH_PREFIX):
                    self.send_error(404)
                    return
                method = self.path[len(RPC_PATH_PREFIX):]
                fn = handler_map.get(method)
                if fn is None:
                    self.send_error(404, f"unknown rpc method {method}")
                    return
                length = int(self.headers.get("Content-Length", 0))
                payload = msgpack.unpackb(
                    self.rfile.read(length), raw=False, strict_map_key=False
                )
                try:
                    out = fn(payload)
                except Exception as e:
                    out = {"__error": f"{type(e).__name__}: {e}"}
                blob = msgpack.packb(out, use_bin_type=True)
                self.send_response(200)
                self.send_header("Content-Type", "application/msgpack")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def serve_background(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
