"""HTTP transport: router, request/responder, threaded server with SSE.

Own copies of ``gofr_tpu/http``'s stdlib-only modules, trimmed to what the
port's ``/generate`` needs.
"""

from .errors import HTTPError, InvalidParam, RequestTimeout, ServiceUnavailable
from .request import Request
from .responder import Responder, Response, Stream
from .router import Router
from .server import HTTPServer

__all__ = [
    "HTTPError", "InvalidParam", "RequestTimeout", "ServiceUnavailable",
    "Request", "Responder", "Response", "Stream", "Router", "HTTPServer",
]
