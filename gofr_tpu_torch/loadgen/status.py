"""The loadgen status surface: a tiny stdlib HTTP server that exposes
a running ``OpenLoopRunner`` the same way the fleet exposes its debug
planes, so the existing pollers need no new transport.

Ports ``gofr_tpu/loadgen/status.py`` whole: ``StatusServer``.

``GET /debug/loadgen`` returns the runner's live ``status()`` (offered
vs served rates, per-class inflight, outcomes, dispatch-lag self-audit)
plus a live scorecard when a ``scorecard_fn`` is attached;
``GET /debug/loadgen/rows`` dumps the per-request rows collected so
far. grafttop's loadgen panel and obs_dump's offered-vs-served
timeline both point here (``--loadgen http://host:port``).

Deliberately not an App: the generator is the *instrument*,
and booting the framework under test to observe its own load harness
would tangle the measurement with the measured. ThreadingHTTPServer +
a JSON handler is the whole surface.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

STATUS_PATH = "/debug/loadgen"


class StatusServer:
    """Serve one runner's live status over HTTP until stopped."""

    def __init__(self, runner, host: str = "127.0.0.1", port: int = 0,
                 scorecard_fn: Optional[Callable[[], Dict[str, Any]]] = None):
        self.runner = runner
        self.scorecard_fn = scorecard_fn
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # noqa: A003,ANN002 - quiet
                pass

            def _send(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - http.server API
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path in ("/", STATUS_PATH):
                        self._send(200, outer.payload())
                    elif path == STATUS_PATH + "/rows":
                        self._send(200, {"rows": outer.runner.rows()})
                    else:
                        self._send(404, {"error": f"no route {path}"})
                except Exception as exc:  # noqa: BLE001 - surface it
                    self._send(500, {"error": repr(exc)[:200]})

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = int(self._server.server_address[1])
        self._thread: Optional[threading.Thread] = None

    def payload(self) -> Dict[str, Any]:
        """status() + optional live scorecard — also usable directly
        (obs_dump in-process mode) without the HTTP hop."""
        out = self.runner.status()
        if self.scorecard_fn is not None:
            try:
                out["scorecard"] = self.scorecard_fn()
            except Exception as exc:  # noqa: BLE001 - degrade, don't die
                out["scorecard_error"] = repr(exc)[:160]
        return out

    def start(self) -> "StatusServer":
        if self._thread is not None:
            raise RuntimeError("status server already started")
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.2},
            name="loadgen-status", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
