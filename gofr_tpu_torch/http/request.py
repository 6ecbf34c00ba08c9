"""HTTP Request wrapper: method, path, headers, JSON bind.

A copy of ``gofr_tpu/http/request.py``, trimmed to what the port's servers
need: JSON bodies (multipart and dataclass binding are not ported),
``header()``, ``param()`` (the first value of a query parameter, the debug
routes' ``?steps=N``), ``path_param()``, and the fields the router and the
middleware set (``route_pattern``, ``span``, ``traceparent``, and the auth
middlewares' ``auth_subject`` and ``context["jwt_claims"]``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlsplit

from .errors import HTTPError

MAX_BODY_BYTES = 32 << 20


class BindError(HTTPError):
    status_code = 400


class Request:
    """One inbound HTTP request, built by the server glue and enriched by the
    router (path_params)."""

    def __init__(self, method: str, target: str,
                 headers: Optional[Dict[str, str]] = None, body: bytes = b"",
                 client_addr: str = ""):
        self.method = method.upper()
        parts = urlsplit(target)
        self.path = parts.path or "/"
        self.query = parse_qs(parts.query)
        self.headers = {k.lower(): v for k, v in (headers or {}).items()}
        self.body = body or b""
        self.client_addr = client_addr
        self.path_params: Dict[str, str] = {}
        self.route_pattern: Optional[str] = None  # set by the router on match
        self.span = None  # set by the tracer middleware
        self.traceparent: Optional[str] = None  # the raw W3C header, ditto
        self.auth_subject: Optional[str] = None  # set by an auth middleware
        self.context: Dict[str, Any] = {}  # request-scoped values

    def header(self, key: str) -> str:
        return self.headers.get(key.lower(), "")

    def param(self, key: str) -> str:
        """The first value of query parameter `key`, "" when absent."""
        values = self.query.get(key)
        return values[0] if values else ""

    def path_param(self, key: str) -> str:
        return self.path_params.get(key, "")

    def bind(self) -> Any:
        """The parsed JSON body ({} when empty); 400 on malformed JSON."""
        if len(self.body) > MAX_BODY_BYTES:
            raise BindError("request body exceeds 32 MB limit")
        try:
            return json.loads(self.body.decode("utf-8")) if self.body else {}
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            raise BindError(f"invalid JSON body: {exc}") from exc
