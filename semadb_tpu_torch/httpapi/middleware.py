"""HTTP middleware chain.

Parity reference: httpapi/httpapi.go:47-52 (Recover → logger/metrics →
ProxySecret → WhiteListIP → AppHeader) and httpapi/middleware/
(appheaders.go user/plan extraction from X-User-Id/X-Plan-Id;
middleware.go Prometheus HTTP metrics; metrics.go separate metrics port).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from semadb_tpu_torch.models.collection import UserPlan

try:
    from prometheus_client import Counter, Histogram

    HTTP_REQUESTS = Counter(
        "semadb_http_requests_total",
        "HTTP requests",
        ["code", "method", "handler"],
    )
    HTTP_DURATION = Histogram(
        "semadb_http_request_duration_seconds",
        "HTTP request duration",
        ["method", "handler"],
    )
    _HAVE_PROM = True
except Exception:  # pragma: no cover
    _HAVE_PROM = False


@dataclass
class RequestContext:
    user_id: str = ""
    plan_id: str = ""
    user_plan: UserPlan = field(default_factory=UserPlan)
    params: Dict[str, str] = field(default_factory=dict)


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def check_proxy_secret(headers, proxy_secret: str) -> None:
    """middleware.ProxySecretMiddleware: require X-Proxy-Secret match."""
    if proxy_secret and headers.get("X-Proxy-Secret", "") != proxy_secret:
        raise HttpError(407, "missing or invalid proxy secret")


def check_whitelist(client_ip: str, whitelist: List[str]) -> None:
    """middleware.WhiteListIPMiddleware: allow-list client IPs ('*' = all)."""
    if whitelist and "*" not in whitelist and client_ip not in whitelist:
        raise HttpError(403, f"ip {client_ip} not allowed")


def extract_app_headers(
    headers, user_plans: Dict[str, UserPlan]
) -> RequestContext:
    """middleware/appheaders.go: X-User-Id + X-Plan-Id required; plan must
    be configured."""
    user_id = headers.get("X-User-Id", "")
    plan_id = headers.get("X-Plan-Id", "")
    if not user_id or not plan_id:
        raise HttpError(400, "missing X-User-Id or X-Plan-Id headers")
    plan = user_plans.get(plan_id)
    if plan is None:
        raise HttpError(400, f"unknown user plan {plan_id}")
    return RequestContext(user_id=user_id, plan_id=plan_id, user_plan=plan)


def record_metrics(method: str, handler: str, code: int, started: float) -> None:
    if _HAVE_PROM:
        HTTP_REQUESTS.labels(code=str(code), method=method, handler=handler).inc()
        HTTP_DURATION.labels(method=method, handler=handler).observe(
            time.perf_counter() - started
        )


def start_metrics_server(port: int) -> None:
    """Prometheus metrics on a separate port (middleware/metrics.go:20-69)."""
    if _HAVE_PROM and port:
        from prometheus_client import start_http_server

        start_http_server(port)
