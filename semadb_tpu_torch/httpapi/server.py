"""HTTP server: router + middleware chain over the stdlib threading server.

Port of ``semadb_tpu/httpapi/server.py`` serving the v1 API (a fixed
Vamana schema, ``httpapi/v1.py``) and the v2 API.

Parity reference: httpapi/httpapi.go RunHTTPServer — mux with middleware
chain (Recover → metrics/logging → ProxySecret → WhiteListIP → AppHeader),
JSON + msgpack bodies, optional Prometheus metrics on a separate port.
"""

from __future__ import annotations

import re
import threading
import time
import traceback
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from semadb_tpu_torch.cluster.node import ClusterNode
from semadb_tpu_torch.httpapi.encdec import decode_body, encode_body
from semadb_tpu_torch.httpapi.middleware import (
    HttpError,
    RequestContext,
    check_proxy_secret,
    check_whitelist,
    extract_app_headers,
    record_metrics,
    start_metrics_server,
)
from semadb_tpu_torch.models.collection import UserPlan


@dataclass
class HttpApiConfig:
    """Reference: HttpApiConfig (httpapi.go:18-32)."""

    http_host: str = ""
    http_port: int = 8081
    enable_metrics: bool = False
    metrics_http_port: int = 8091
    proxy_secret: str = ""
    white_list_ips: List[str] = field(default_factory=list)
    user_plans: Dict[str, UserPlan] = field(default_factory=dict)
    debug: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "HttpApiConfig":
        return cls(
            http_host=d.get("httpHost", ""),
            http_port=int(d.get("httpPort", 8081)),
            enable_metrics=bool(d.get("enableMetrics", False)),
            metrics_http_port=int(d.get("metricsHttpPort", 8091)),
            proxy_secret=d.get("proxySecret", ""),
            white_list_ips=list(d.get("whiteListIPs", [])),
            user_plans={
                k: UserPlan.from_dict(v) for k, v in (d.get("userPlans") or {}).items()
            },
            debug=bool(d.get("debug", False)),
        )


class Route:
    def __init__(self, method: str, pattern: str, fn, auth: bool = True):
        self.method = method
        self.fn = fn
        self.auth = auth
        self.param_names: List[str] = []
        regex = re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern)
        self.regex = re.compile(f"^{regex}$")
        self.pattern = pattern


class Router:
    def __init__(self):
        self.routes: List[Route] = []

    def add(self, method: str, pattern: str, fn, auth: bool = True) -> None:
        self.routes.append(Route(method, pattern, fn, auth))

    def match(self, method: str, path: str) -> Optional[Tuple[Route, Dict[str, str]]]:
        for r in self.routes:
            if r.method != method:
                continue
            m = r.regex.match(path)
            if m:
                return r, m.groupdict()
        return None


class HttpServer:
    def __init__(self, node: ClusterNode, cfg: HttpApiConfig):
        from semadb_tpu_torch.httpapi import v1, v2

        self.node = node
        self.cfg = cfg
        self.router = Router()
        v1.register_routes(self.router, node)
        v2.register_routes(self.router, node)

        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _respond(self, status: int, obj, started: float, handler_name: str):
                ctype, blob = encode_body(self.headers.get("Accept", ""), obj)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)
                record_metrics(self.command, handler_name, status, started)

            def _handle(self):
                started = time.perf_counter()
                path = self.path.split("?", 1)[0]
                matched = server.router.match(self.command, path)
                handler_name = matched[0].pattern if matched else path
                try:
                    if matched is None:
                        raise HttpError(404, f"no route for {self.command} {path}")
                    route, params = matched
                    # Middleware chain (httpapi.go:47-52)
                    check_proxy_secret(self.headers, server.cfg.proxy_secret)
                    check_whitelist(
                        self.client_address[0], server.cfg.white_list_ips
                    )
                    if route.auth:
                        ctx = extract_app_headers(self.headers, server.cfg.user_plans)
                    else:
                        ctx = RequestContext()
                    ctx.params = params
                    length = int(self.headers.get("Content-Length", 0))
                    try:
                        body = decode_body(
                            self.headers.get("Content-Type", ""),
                            self.rfile.read(length) if length else b"",
                        )
                    except Exception as e:
                        raise HttpError(400, f"invalid request body: {e}")
                    status, out = route.fn(ctx, body)
                    self._respond(status, out, started, handler_name)
                except HttpError as e:
                    self._respond(e.status, {"error": e.message}, started, handler_name)
                except Exception as e:  # Recover middleware: 500 + trace log
                    if server.cfg.debug:
                        traceback.print_exc()
                    self._respond(
                        500,
                        {"error": f"{type(e).__name__}: {e}"},
                        started,
                        handler_name,
                    )

            do_GET = do_POST = do_PUT = do_DELETE = _handle

        self._httpd = ThreadingHTTPServer((cfg.http_host, cfg.http_port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def serve_background(self) -> None:
        if self.cfg.enable_metrics:
            start_metrics_server(self.cfg.metrics_http_port)
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        if self.cfg.enable_metrics:
            start_metrics_server(self.cfg.metrics_http_port)
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def run_http_server(node: ClusterNode, cfg: HttpApiConfig) -> HttpServer:
    """httpapi.RunHTTPServer parity: build + start in background."""
    server = HttpServer(node, cfg)
    server.serve_background()
    return server
