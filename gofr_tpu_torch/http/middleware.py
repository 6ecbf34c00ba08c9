"""The default middleware chain: Tracer -> Logging -> CORS -> Metrics.

A copy of the default chain of ``gofr_tpu/http/middleware/__init__.py``:
``tracer_middleware`` (a span per request under an inbound W3C
``traceparent``, kept raw on ``request.traceparent`` and the span on
``request.span``, an ``X-Trace-Id`` response header), ``logging_middleware``
with ``RequestLog`` (one structured record per request, and recovery of a
handler's exception as a 500), ``cors_middleware`` and
``metrics_middleware`` (``app_http_response`` by route template, method and
status). The auth middlewares (basic, API key, OAuth and JWKS) wait in
ROADMAP A18b.
"""

from __future__ import annotations

import json
import time
from typing import Callable

from ..logging import PrettyPrint
from .errors import PanicRecovery
from .request import Request
from .responder import Response
from .router import WireHandler


# -- tracing ------------------------------------------------------------------
def tracer_middleware(tracer) -> Callable[[WireHandler], WireHandler]:
    def mw(inner: WireHandler) -> WireHandler:
        def handle(request: Request) -> Response:
            # the raw header too: handlers thread it through
            # engine.submit(traceparent=...) so the engine's spans parent
            # under the caller's trace even after this span has closed
            # (a streamed response ends it before admission)
            request.traceparent = request.headers.get("traceparent")
            span = tracer.start_span(
                f"{request.method} {request.path}",
                traceparent=request.traceparent,
            )
            span.set_attribute("http.method", request.method)
            span.set_attribute("http.target", request.path)
            request.span = span
            try:
                resp = inner(request)
                span.set_attribute("http.status_code", resp.status)
                span.set_status(resp.status < 500)
                resp.headers.setdefault("X-Trace-Id", span.trace_id)
                return resp
            finally:
                span.end()

        return handle

    return mw


# -- request logging + panic recovery ----------------------------------------
class RequestLog(PrettyPrint):
    """Structured request log record."""

    def __init__(self, trace_id: str, method: str, uri: str, status: int, duration_us: int, ip: str):
        self.trace_id = trace_id
        self.method = method
        self.uri = uri
        self.status = status
        self.response_time_us = duration_us
        self.ip = ip

    def pretty_print(self, fp) -> None:
        color = 32 if self.status < 400 else (33 if self.status < 500 else 31)
        fp.write(f"{self.trace_id} \x1b[{color}m{self.status}\x1b[0m "
                 f"{self.response_time_us:>8}µs {self.method} {self.uri}")


def logging_middleware(logger) -> Callable[[WireHandler], WireHandler]:
    def mw(inner: WireHandler) -> WireHandler:
        def handle(request: Request) -> Response:
            start = time.time()
            try:
                resp = inner(request)
            except Exception as exc:  # noqa: BLE001 - panic recovery -> 500
                logger.error({"error": str(exc), "path": request.path,
                              "method": request.method, "panic": True})
                err = PanicRecovery()
                resp = Response(status=err.status_code,
                                headers={"Content-Type": "application/json"},
                                body=json.dumps({"error": {"message": err.message}}).encode())
            duration_us = int((time.time() - start) * 1e6)
            trace_id = request.span.trace_id if request.span is not None else ""
            record = RequestLog(trace_id, request.method, request.path, resp.status,
                                duration_us, request.client_addr)
            if resp.status >= 500:
                logger.error(record)
            else:
                logger.info(record)
            return resp

        return handle

    return mw


# -- CORS ---------------------------------------------------------------------
def cors_middleware(allowed_headers: str = "Authorization, Content-Type, x-requested-with, origin, true-client-ip, X-Correlation-ID",
                    allowed_methods: str = "PUT, POST, GET, DELETE, OPTIONS, PATCH") -> Callable[[WireHandler], WireHandler]:
    def mw(inner: WireHandler) -> WireHandler:
        def handle(request: Request) -> Response:
            if request.method == "OPTIONS":
                resp = Response(status=200)
            else:
                resp = inner(request)
            resp.headers.setdefault("Access-Control-Allow-Origin", "*")
            resp.headers.setdefault("Access-Control-Allow-Headers", allowed_headers)
            resp.headers.setdefault("Access-Control-Allow-Methods", allowed_methods)
            return resp

        return handle

    return mw


# -- metrics ------------------------------------------------------------------
def metrics_middleware(metrics) -> Callable[[WireHandler], WireHandler]:
    def mw(inner: WireHandler) -> WireHandler:
        def handle(request: Request) -> Response:
            start = time.time()
            resp = inner(request)
            # by the matched route template, not the raw path: bounded
            # series cardinality
            route = getattr(request, "route_pattern", None) or "unmatched"
            metrics.record_histogram("app_http_response", time.time() - start,
                                     path=route, method=request.method,
                                     status=str(resp.status))
            return resp

        return handle

    return mw
