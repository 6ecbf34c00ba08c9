"""Router: `{param}` path patterns and method dispatch.

A copy of ``gofr_tpu/http/router.py``: routes, ``route_pattern`` set on a
match (the metrics middleware labels by it), and the middleware chain
(``use_middleware``; the App installs the default chain, http/middleware.py).
"""

from __future__ import annotations

import re
import threading
from typing import Callable, List, Optional, Tuple

from .request import Request
from .responder import Response

WireHandler = Callable[[Request], Response]
Middleware = Callable[[WireHandler], WireHandler]


def _compile(pattern: str) -> re.Pattern:
    # "/users/{id}" -> ^/users/(?P<id>[^/]+)/?$
    out = []
    for part in re.split(r"(\{[a-zA-Z_][a-zA-Z0-9_]*\})", pattern):
        if part.startswith("{") and part.endswith("}"):
            out.append(f"(?P<{part[1:-1]}>[^/]+)")
        else:
            out.append(re.escape(part))
    return re.compile("^" + "".join(out) + "/?$")


class Route:
    def __init__(self, method: str, pattern: str, handler: WireHandler):
        self.method = method.upper()
        self.pattern = pattern
        self.regex = _compile(pattern)
        self.handler = handler


class Router:
    def __init__(self):
        self._routes: List[Route] = []
        self._middleware: List[Middleware] = []
        self._lock = threading.Lock()
        self._chain_cache: Optional[WireHandler] = None

    def add(self, method: str, pattern: str, handler: WireHandler) -> None:
        with self._lock:
            self._routes.append(Route(method, pattern, handler))
            self._chain_cache = None

    def use_middleware(self, *mws: Middleware) -> None:
        with self._lock:
            self._middleware.extend(mws)
            self._chain_cache = None

    def _match(self, request: Request) -> Tuple[Optional[Route], bool]:
        """Returns (route, path_matched_any_method)."""
        path_matched = False
        for route in self._routes:
            m = route.regex.match(request.path)
            if not m:
                continue
            path_matched = True
            if route.method == request.method or (request.method == "HEAD"
                                                  and route.method == "GET"):
                request.path_params = {k: v for k, v in m.groupdict().items()
                                       if v is not None}
                request.route_pattern = route.pattern
                return route, True
        return None, path_matched

    def _terminal(self, request: Request) -> Response:
        route, path_matched = self._match(request)
        if route is not None:
            return route.handler(request)
        if path_matched:
            return Response(status=405, headers={"Content-Type": "application/json"},
                            body=b'{"error":{"message":"method not allowed"}}')
        return Response(status=404, headers={"Content-Type": "application/json"},
                        body=b'{"error":{"message":"route not registered"}}')

    def dispatch(self, request: Request) -> Response:
        with self._lock:
            chain = self._chain_cache
            if chain is None:
                chain = self._terminal
                for mw in reversed(self._middleware):
                    chain = mw(chain)
                self._chain_cache = chain
        return chain(request)
