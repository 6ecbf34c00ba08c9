"""App facade and per-request Context, lean.

Counterpart of ``gofr_tpu/app.py`` (``App``) and ``gofr_tpu/context.py``
(``Context``), cut to what the port's LLM server needs: route verbs
``get``/``post``, ``start``/``run``/``shutdown`` with shutdown hooks, health
contributors behind ``GET /.well-known/health``, and a Context with
``bind()`` and the request deadline. The container, datasources, metrics
server, middleware, gRPC, pub/sub and cron are not ported (ROADMAP A11).

A handler runs on the connection's own server thread; ``REQUEST_TIMEOUT``
(seconds, default 5, <= 0 for none) sets the deadline a handler reads
through ``ctx.remaining()``.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any, Callable, Dict, Mapping, Optional

from .http.errors import HTTPError
from .http.request import Request
from .http.responder import Responder, Response, Stream
from .http.router import Router
from .http.server import HTTPServer

__all__ = ["App", "Context", "Stream"]

DEFAULT_HTTP_PORT = 8000
DEFAULT_REQUEST_TIMEOUT_S = 5.0

Handler = Callable[["Context"], Any]


class Context:
    """What a handler receives: the request and its deadline."""

    def __init__(self, request: Request, deadline: Optional[float] = None):
        self.request = request
        self.deadline = deadline

    def bind(self) -> Any:
        return self.request.bind()

    def remaining(self) -> Optional[float]:
        """Seconds left before the request deadline; None when unbounded."""
        if self.deadline is None:
            return None
        return max(0.0, self.deadline - time.monotonic())


class App:
    def __init__(self, config: Optional[Mapping[str, str]] = None,
                 logger: Optional[logging.Logger] = None):
        self.config: Mapping[str, str] = dict(config or {})
        self.logger = logger or logging.getLogger("gofr_tpu_torch")
        self.http_port = int(self.config.get("HTTP_PORT", DEFAULT_HTTP_PORT))
        self.request_timeout_s = float(self.config.get(
            "REQUEST_TIMEOUT", DEFAULT_REQUEST_TIMEOUT_S))
        self.router = Router()
        self._health: Dict[str, Callable[[], Dict[str, Any]]] = {}
        self._shutdown_hooks: list = []
        self._http_server: Optional[HTTPServer] = None
        self.router.add("GET", "/.well-known/health", self._health_handler)

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
            deadline = (time.monotonic() + self.request_timeout_s
                        if self.request_timeout_s > 0 else None)
            try:
                data = handler(Context(request, deadline))
            except HTTPError as exc:
                return responder.respond(None, exc)
            except Exception as exc:  # noqa: BLE001 - the server keeps serving
                self.logger.exception("handler %s %s failed", request.method,
                                      request.path)
                return responder.respond(None, exc)
            return responder.respond(data, None)

        return wire_handler

    # -- health ---------------------------------------------------------------
    def add_health_contributor(self, name: str,
                               check: Callable[[], Dict[str, Any]]) -> None:
        """check() returns a dict with a "status" of "UP" or "DOWN"."""
        self._health[name] = check

    def health(self) -> Dict[str, Any]:
        details = {name: check() for name, check in self._health.items()}
        up = all(d.get("status") == "UP" for d in details.values())
        return {"status": "UP" if up else "DOWN", "details": details}

    def _health_handler(self, request: Request) -> Response:
        return Response(status=200, headers={"Content-Type": "application/json"},
                        body=json.dumps(self.health()).encode())

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        """Start the HTTP server without blocking (HTTP_PORT 0 picks a free
        port; the bound one is in http_port afterwards)."""
        if self._http_server is not None:
            return
        self._http_server = HTTPServer(self.router, self.http_port, self.logger)
        self._http_server.start()
        self.http_port = self._http_server.port

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
        server stops."""
        self._shutdown_hooks.append(fn)

    def shutdown(self) -> None:
        for hook in reversed(self._shutdown_hooks):
            try:
                hook()
            except Exception:  # noqa: BLE001 - shutdown must proceed
                self.logger.exception("shutdown hook failed")
        if self._http_server is not None:
            self._http_server.shutdown()
            self._http_server = None
