"""Response types and the uniform JSON-envelope Responder, with SSE streams.

A copy of ``gofr_tpu/http/responder.py``, trimmed to what the port's
servers need: ``Response``, ``Raw`` (JSON without the envelope, the OpenAI
shapes), ``Stream`` (chunked or server-sent events) and the ``{data}`` /
``{error}`` envelope with a Retry-After header for sheds.
"""

from __future__ import annotations

import json
import math
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

from .errors import status_from_method


class Response:
    """Wire-level response handed to the server glue."""

    def __init__(self, status: int = 200, headers: Optional[Dict[str, str]] = None,
                 body: bytes = b"", stream: Optional[Iterator[bytes]] = None):
        self.status = status
        self.headers = headers or {}
        self.body = body
        self.stream = stream  # when set, body is ignored and chunks are flushed as produced


class Raw:
    """Marshal `data` as JSON without the {data: ...} envelope."""

    def __init__(self, data: Any):
        self.data = data


class Stream:
    """Generator-backed streaming body. `sse=True` wraps each chunk as a
    `data: ...\\n\\n` server-sent event (the /generate token stream).
    on_close runs when the body ends or the client goes away."""

    def __init__(self, chunks: Iterable[Any], content_type: str = "application/octet-stream",
                 sse: bool = False, on_close: Optional[Callable[[], None]] = None):
        self.chunks = chunks
        self.sse = sse
        self.content_type = "text/event-stream" if sse else content_type
        self.on_close = on_close

    def iter_bytes(self) -> Iterator[bytes]:
        try:
            for chunk in self.chunks:
                if self.sse:
                    if not isinstance(chunk, (str, bytes)):
                        chunk = json.dumps(chunk, default=str)
                    if isinstance(chunk, bytes):
                        chunk = chunk.decode("utf-8", "replace")
                    yield f"data: {chunk}\n\n".encode()
                else:
                    if isinstance(chunk, str):
                        chunk = chunk.encode()
                    elif not isinstance(chunk, bytes):
                        chunk = json.dumps(chunk, default=str).encode()
                    yield chunk
        finally:
            if self.on_close is not None:
                self.on_close()


class Responder:
    """Builds the uniform envelope; one per request."""

    def __init__(self, method: str):
        self.method = method

    def respond(self, data: Any, err: Optional[BaseException]) -> Response:
        if err is not None:
            # duck-typed status_code lets non-HTTP layers map to a status
            # without importing the transport package
            status = getattr(err, "status_code", None)
            if not isinstance(status, int):
                status = 500
            payload = {"error": {"message": getattr(err, "message", None) or str(err)}}
            response = self._json(status, payload)
            retry_after = getattr(err, "retry_after_s", None)
            if isinstance(retry_after, (int, float)) and retry_after > 0:
                response.headers["Retry-After"] = str(
                    max(1, int(math.ceil(retry_after))))
            return response
        if isinstance(data, Response):
            return data
        if isinstance(data, Raw):
            return self._json(status_from_method(self.method), data.data)
        if isinstance(data, Stream):
            return Response(status=200, headers={"Content-Type": data.content_type},
                            stream=data.iter_bytes())
        return self._json(status_from_method(self.method), {"data": data})

    @staticmethod
    def _json(status: int, payload: Any) -> Response:
        body = json.dumps(payload, default=str).encode()
        return Response(status=status, headers={"Content-Type": "application/json"},
                        body=body)
