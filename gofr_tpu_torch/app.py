"""App facade: the HTTP server and the metrics server around one container.

Counterpart of ``gofr_tpu/app.py`` (``App``), cut to what the port's servers
use: ``App(config, container)`` (a Config or a plain mapping; with neither,
``EnvFile`` over ``GOFR_CONFIGS_DIR``, default ``./configs``; a container
passed in is used as it is, and the App reads its own keys from `config`
when one is given, else from the container's), the route
verbs ``get``/``post``/``add_route``, the default middleware chain in the
reference's order, Tracer -> Logging -> CORS -> Metrics (http/middleware.py),
``MAX_CONCURRENT_REQUESTS`` handler slots (default 256,
<= 0 for none; a request that finds them full for 0.5 s gets a 503, a
streamed response holds its slot until its body ends, ``/.well-known/*``
bypasses them), ``GET /.well-known/health`` (the container's aggregate) and
``GET /.well-known/alive`` (in the ``{data}`` envelope, as the reference's
handlers answer), the metrics server on ``METRICS_PORT`` (default 2121, 0
picks a free port; ``GET /metrics`` in Prometheus text, or OpenMetrics
with exemplars when the scrape accepts it, plus the two well-known routes,
unwrapped), ``start``/``run``/``shutdown`` with ``on_shutdown``
hooks (run first, LIFO) and ``add_health_contributor``.

A handler runs on its connection's server thread; ``REQUEST_TIMEOUT``
(seconds, default 5, <= 0 for none) sets the deadline it reads through
``ctx.remaining()``. Waiting in ROADMAP A11: the ``enable_*`` planes
(flight recorder, step ledger, timeline, SLO, QoS and the rest). Waiting in
ROADMAP A18b: the auth middlewares, gRPC, cron, pub/sub subscriptions,
static files and the OpenAPI routes.
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
from typing import Any, Callable, Mapping, Optional, Union

from .config import Config, EnvFile, as_config
from .container import Container
from .context import Context
from .http import middleware as mw
from .http.errors import HTTPError, ServiceUnavailable
from .http.request import Request
from .http.responder import Responder, Response, Stream
from .http.router import Router
from .http.server import HTTPServer

__all__ = ["App", "Context", "Stream"]

DEFAULT_HTTP_PORT = 8000
DEFAULT_METRICS_PORT = 2121
DEFAULT_REQUEST_TIMEOUT_S = 5.0
DEFAULT_MAX_CONCURRENT_REQUESTS = 256

Handler = Callable[[Context], Any]


def _stream_with_slot(stream: Stream, release: Callable[[], None]) -> Stream:
    """Tie a handler slot to a streamed response's lifetime: released once,
    when the body ends or the client goes away, after any user on_close."""
    prev = stream.on_close
    released = threading.Event()

    def close() -> None:
        try:
            if prev is not None:
                prev()
        finally:
            if not released.is_set():
                released.set()
                release()

    stream.on_close = close
    return stream


class App:
    def __init__(self, config: Union[Config, Mapping[str, str], None] = None,
                 container: Optional[Container] = None):
        if container is not None:
            # an engine's container (serve.app_for): its metrics, tracer and
            # logger; the App's own keys come from `config` when given
            self.container = container
            self.config = (container.config if config is None
                           else as_config(config))
        else:
            if config is None:
                config = EnvFile(os.environ.get("GOFR_CONFIGS_DIR",
                                                "./configs"))
            self.config = as_config(config)
            self.container = Container.create(self.config)
        self.logger = self.container.logger
        self.router = Router()
        self.request_timeout_s = self.config.get_float(
            "REQUEST_TIMEOUT", DEFAULT_REQUEST_TIMEOUT_S)
        # a cap on concurrently running handlers, live streams included
        self.max_concurrent_requests = self.config.get_int(
            "MAX_CONCURRENT_REQUESTS", DEFAULT_MAX_CONCURRENT_REQUESTS)
        self._handler_slots = (
            threading.BoundedSemaphore(self.max_concurrent_requests)
            if self.max_concurrent_requests > 0 else None)
        self.http_port = self.config.get_int("HTTP_PORT", DEFAULT_HTTP_PORT)
        self.metrics_port = self.config.get_int("METRICS_PORT",
                                                DEFAULT_METRICS_PORT)
        self._http_server: Optional[HTTPServer] = None
        self._metrics_server: Optional[HTTPServer] = None
        self._shutdown_hooks: list = []
        # the default chain, in the reference's order
        self.router.use_middleware(
            mw.tracer_middleware(self.container.tracer),
            mw.logging_middleware(self.logger),
            mw.cors_middleware(),
            mw.metrics_middleware(self.container.metrics_manager),
        )
        # the reference's well-known handlers, in the {data} envelope
        self.router.add("GET", "/.well-known/health",
                        self._wire(lambda ctx: self.health()))
        self.router.add("GET", "/.well-known/alive",
                        self._wire(lambda ctx: {"status": "UP"}))

    # -- routes ---------------------------------------------------------------
    def add_route(self, method: str, pattern: str,
                  handler: Optional[Handler] = None):
        if handler is None:  # decorator form: @app.get("/path")
            def decorator(fn: Handler) -> Handler:
                self.add_route(method, pattern, fn)
                return fn
            return decorator
        self.router.add(method, pattern, self._wire(handler))
        return handler

    def get(self, pattern: str, handler: Optional[Handler] = None):
        return self.add_route("GET", pattern, handler)

    def post(self, pattern: str, handler: Optional[Handler] = None):
        return self.add_route("POST", pattern, handler)

    def _wire(self, handler: Handler):
        def wire_handler(request: Request) -> Response:
            responder = Responder(request.method)
            # /.well-known/* bypasses the cap: "is the process up" must
            # answer precisely when the app sheds everything else
            shed = (self._handler_slots is not None
                    and not request.path.startswith("/.well-known/"))
            if shed and not self._handler_slots.acquire(timeout=0.5):
                return responder.respond(None, ServiceUnavailable(
                    "server overloaded; try again later"))
            transferred = False
            try:
                deadline = (time.monotonic() + self.request_timeout_s
                            if self.request_timeout_s > 0 else None)
                try:
                    data = handler(Context(request, self.container,
                                           responder, deadline))
                except HTTPError as exc:
                    return responder.respond(None, exc)
                except Exception as exc:  # noqa: BLE001 - keep serving
                    self.logger.errorf("handler %s %s failed: %s",
                                       request.method, request.path,
                                       traceback.format_exc())
                    return responder.respond(None, exc)
                if shed and isinstance(data, Stream):
                    # a streamed body is generated after the handler
                    # returns: the slot follows the stream
                    data = _stream_with_slot(data,
                                             self._handler_slots.release)
                    transferred = True
                return responder.respond(data, None)
            finally:
                if shed and not transferred:
                    self._handler_slots.release()

        return wire_handler

    # -- health ---------------------------------------------------------------
    def add_health_contributor(self, name: str,
                               check: Callable[[], Any]) -> None:
        """check() returns a dict with a "status" of UP, DOWN or DEGRADED."""
        self.container.add_health_contributor(name, check)

    def health(self):
        return self.container.health()

    # -- the metrics server ---------------------------------------------------
    def _metrics_router(self) -> Router:
        router = Router()

        def metrics_handler(request: Request) -> Response:
            self.container.refresh_runtime_metrics()
            # a scrape that accepts the OpenMetrics dialect gets exemplars;
            # classic Prometheus text stays byte-identical without them
            openmetrics = ("application/openmetrics-text"
                           in request.header("accept"))
            ctype = ("application/openmetrics-text; version=1.0.0; "
                     "charset=utf-8" if openmetrics
                     else "text/plain; version=0.0.4")
            return Response(
                status=200, headers={"Content-Type": ctype},
                body=self.container.metrics_manager.expose(
                    openmetrics=openmetrics).encode())

        router.add("GET", "/metrics", metrics_handler)
        router.add("GET", "/.well-known/health", lambda request: Response(
            status=200, headers={"Content-Type": "application/json"},
            body=json.dumps(self.health()).encode()))
        router.add("GET", "/.well-known/alive", lambda request: Response(
            status=200, headers={"Content-Type": "application/json"},
            body=b'{"status":"UP"}'))
        return router

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        """Start the metrics and HTTP servers without blocking (port 0 picks
        a free port; the bound ones are in metrics_port and http_port
        afterwards). A metrics server that cannot bind is logged and
        skipped, as in the reference."""
        if self._http_server is not None:
            return
        self._metrics_server = HTTPServer(self._metrics_router(),
                                          self.metrics_port, self.logger)
        try:
            self._metrics_server.start()
            self.metrics_port = self._metrics_server.port
        except OSError as exc:
            self.logger.errorf("metrics server failed to start: %s", exc)
            self._metrics_server = None
        self._http_server = HTTPServer(self.router, self.http_port,
                                       self.logger)
        self._http_server.start()
        self.http_port = self._http_server.port
        self.logger.infof("app %s started: http=:%d metrics=:%d",
                          self.container.app_name, self.http_port,
                          self.metrics_port)

    def run(self) -> None:
        """Start and block until interrupted."""
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            self.shutdown()

    def on_shutdown(self, fn: Callable[[], Any]) -> None:
        """Register a hook run first (LIFO) during shutdown, before the
        servers stop: the place for a graceful drain."""
        self._shutdown_hooks.append(fn)

    def shutdown(self) -> None:
        for hook in reversed(self._shutdown_hooks):
            try:
                hook()
            except Exception as exc:  # noqa: BLE001 - shutdown must proceed
                self.logger.errorf("shutdown hook failed: %s", exc)
        for server in (self._http_server, self._metrics_server):
            if server is not None:
                server.shutdown()
        self._http_server = self._metrics_server = None
        self.container.close()
