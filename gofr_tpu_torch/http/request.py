"""HTTP Request wrapper: method, path, headers, JSON bind.

A copy of ``gofr_tpu/http/request.py``, trimmed to what ``/generate``
needs (JSON bodies only; query params, multipart and dataclass binding
are not ported).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional
from urllib.parse import urlsplit

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
        self.path = urlsplit(target).path or "/"
        self.headers = {k.lower(): v for k, v in (headers or {}).items()}
        self.body = body or b""
        self.client_addr = client_addr
        self.path_params: Dict[str, str] = {}

    def bind(self) -> Any:
        """The parsed JSON body ({} when empty); 400 on malformed JSON."""
        if len(self.body) > MAX_BODY_BYTES:
            raise BindError("request body exceeds 32 MB limit")
        try:
            return json.loads(self.body.decode("utf-8")) if self.body else {}
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            raise BindError(f"invalid JSON body: {exc}") from exc
