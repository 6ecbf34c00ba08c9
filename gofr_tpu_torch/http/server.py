"""Threaded HTTP server over the Router, with chunked/SSE streaming support.

A copy of ``gofr_tpu/http/server.py``: one thread per connection via
ThreadingHTTPServer.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .request import Request
from .router import Router


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    router: Router = None  # type: ignore[assignment]
    logger = None

    # silence default stderr access logs; the logging middleware owns request logs
    def log_message(self, fmt: str, *args) -> None:
        pass

    def _dispatch(self) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        request = Request(
            method=self.command,
            target=self.path,
            headers=dict(self.headers.items()),
            body=body,
            client_addr=self.client_address[0],
        )
        try:
            resp = self.router.dispatch(request)
        except Exception as exc:  # noqa: BLE001 - last-ditch guard below middleware
            if self.logger is not None:
                self.logger.error(f"unhandled server error: {exc}")
            self.send_response(500)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return

        try:
            self.send_response(resp.status)
            for key, val in resp.headers.items():
                self.send_header(key, val)
            if resp.stream is not None:
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                for chunk in resp.stream:
                    if not chunk:
                        continue
                    self.wfile.write(f"{len(chunk):X}\r\n".encode() + chunk + b"\r\n")
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            else:
                self.send_header("Content-Length", str(len(resp.body)))
                self.end_headers()
                if self.command != "HEAD" and resp.body:
                    self.wfile.write(resp.body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-response (common for cancelled streams)

    # route every verb through the same dispatch
    do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = do_OPTIONS = do_HEAD = _dispatch


class _Server(ThreadingHTTPServer):
    # The socketserver default listen backlog is 5; a burst of simultaneous
    # connects (concurrent SSE clients, fleet fan-out) overflows it on a busy
    # host and the kernel RSTs connections before accept() ever sees them.
    request_queue_size = 128


class HTTPServer:
    def __init__(self, router: Router, port: int, logger=None, host: str = "0.0.0.0"):
        self.router = router
        self.port = port
        self.host = host
        self.logger = logger
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        handler = type("BoundHandler", (_Handler,), {"router": self.router, "logger": self.logger})
        self._server = _Server((self.host, self.port), handler)
        self._server.daemon_threads = True
        if self.port == 0:
            self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name=f"http-server-{self.port}", daemon=True)
        self._thread.start()
        if self.logger is not None:
            self.logger.info("HTTP server started on port %d", self.port)

    def serve_forever(self) -> None:
        if self._thread is not None:
            self._thread.join()

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
