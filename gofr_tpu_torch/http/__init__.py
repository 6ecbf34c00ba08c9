"""HTTP transport: router with its middleware chain, request/responder,
threaded server with SSE.

Own copies of ``gofr_tpu/http``'s stdlib-only modules, trimmed to what the
port's servers need; ``middleware.py`` holds the default chain of
``gofr_tpu/http/middleware/``.
"""

from .errors import HTTPError, InvalidParam, RequestTimeout, ServiceUnavailable
from .request import Request
from .responder import Raw, Responder, Response, Stream
from .router import Router
from .server import HTTPServer

__all__ = [
    "HTTPError", "InvalidParam", "RequestTimeout", "ServiceUnavailable",
    "Request", "Raw", "Responder", "Response", "Stream", "Router",
    "HTTPServer",
]
