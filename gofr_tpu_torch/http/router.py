"""Router: `{param}` path patterns and method dispatch.

A copy of ``gofr_tpu/http/router.py`` without the middleware chain (the
port has no tracer, logging or metrics middleware yet — ROADMAP A11).
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Tuple

from .request import Request
from .responder import Response

WireHandler = Callable[[Request], Response]


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

    def add(self, method: str, pattern: str, handler: WireHandler) -> None:
        self._routes.append(Route(method, pattern, handler))

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
                return route, True
        return None, path_matched

    def dispatch(self, request: Request) -> Response:
        route, path_matched = self._match(request)
        if route is not None:
            return route.handler(request)
        if path_matched:
            return Response(status=405, headers={"Content-Type": "application/json"},
                            body=b'{"error":{"message":"method not allowed"}}')
        return Response(status=404, headers={"Content-Type": "application/json"},
                        body=b'{"error":{"message":"route not registered"}}')
