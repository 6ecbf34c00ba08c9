"""Outbound HTTP service client: metrics, health, circuit breaker, auth.

Ports ``gofr_tpu/service/__init__.py`` whole: ``HTTPService`` (the verb
surface, ``request`` with ``stream=True``), ``ServiceResponse`` (``json``,
``header``, streaming ``iter_chunks``, ``read``, ``close``),
``CircuitOpenError``, the ``Options`` decorators (``DefaultHeaders``,
``BasicAuthConfig``, ``APIKeyConfig``, ``OAuthConfig``, ``HealthConfig``,
``CircuitBreakerConfig`` with its ``CircuitBreaker``) and
``new_http_service``. The port's breaker adds ``close``, which ends its
health prober (the fleet registry closes its replicas' breakers on stop). Every call is timed into
``app_http_service_response`` and logged at debug.

The port's is stdlib only: ``http.client`` where the reference uses
``requests``. A streamed response keeps its connection in ``raw`` and
``iter_chunks`` yields what has arrived (``read1``), so an SSE relay sees
each event as it is sent. A call made under a handler's context (one with
a ``span``) carries that span's ``traceparent``. ``Health`` and the
statuses are the container's (``gofr_tpu_torch/container``).
"""

from __future__ import annotations

import base64
import http.client
import json
import threading
import time
import urllib.parse
from typing import Any, Dict, Optional

from ..container import STATUS_DOWN, STATUS_UP, Health


class ServiceResponse:
    def __init__(self, status_code: int, body: bytes,
                 headers: Optional[Dict[str, str]] = None):
        self.status_code = status_code
        self.body = body
        self.headers = headers or {}
        # (connection, response) of a stream=True call, until read or closed
        self.raw = None

    def json(self) -> Any:
        return json.loads(self.body.decode("utf-8")) if self.body else None

    def header(self, name: str) -> Optional[str]:
        lowered = name.lower()
        for key, value in self.headers.items():
            if key.lower() == lowered:
                return value
        return None

    def iter_chunks(self, chunk_size: Optional[int] = None):
        """Yield body bytes as they arrive (stream=True), or the buffered
        body in one piece otherwise."""
        if self.raw is None:
            if self.body:
                yield self.body
            return
        resp = self.raw[1]
        while True:
            chunk = resp.read1(chunk_size or 8192)
            if not chunk:
                return
            yield chunk

    def read(self) -> bytes:
        """Drain a streamed response into `body` (a no-op when buffered)."""
        if self.raw is not None:
            self.body = self.raw[1].read()
            self.close()
        return self.body

    def close(self) -> None:
        if self.raw is not None:
            try:
                self.raw[0].close()
            except Exception:  # noqa: BLE001 - close is best-effort
                pass
            self.raw = None


class CircuitOpenError(Exception):
    def __init__(self):
        super().__init__("circuit breaker is open; service unreachable")


class HTTPService:
    """Plain client; the Options decorators wrap it."""

    def __init__(self, address: str, logger=None, metrics=None,
                 timeout_s: float = 5.0):
        self.address = address.rstrip("/")
        self.logger = logger
        self.metrics = metrics
        self.timeout_s = timeout_s
        self.health_endpoint = ".well-known/alive"
        self.default_headers: Dict[str, str] = {}

    # -- the verb surface -----------------------------------------------------
    def get(self, ctx, path: str, params: Optional[Dict[str, Any]] = None,
            headers: Optional[Dict[str, str]] = None) -> ServiceResponse:
        return self.request(ctx, "GET", path, params=params, headers=headers)

    def post(self, ctx, path: str, params: Optional[Dict[str, Any]] = None,
             body: Any = None,
             headers: Optional[Dict[str, str]] = None) -> ServiceResponse:
        return self.request(ctx, "POST", path, params=params, body=body,
                            headers=headers)

    def put(self, ctx, path: str, params=None, body=None,
            headers=None) -> ServiceResponse:
        return self.request(ctx, "PUT", path, params=params, body=body,
                            headers=headers)

    def patch(self, ctx, path: str, params=None, body=None,
              headers=None) -> ServiceResponse:
        return self.request(ctx, "PATCH", path, params=params, body=body,
                            headers=headers)

    def delete(self, ctx, path: str, body=None,
               headers=None) -> ServiceResponse:
        return self.request(ctx, "DELETE", path, body=body, headers=headers)

    def request(self, ctx, method: str, path: str, params=None, body=None,
                headers=None, stream: bool = False,
                timeout_s: Optional[float] = None) -> ServiceResponse:
        """One outbound call. With ``stream=True`` the body is not
        buffered: the response keeps the live connection in ``raw`` (iterate
        with ``iter_chunks``, finish with ``close``), and the histogram
        covers the time to the headers only."""
        url = urllib.parse.urlsplit(f"{self.address}/{path.lstrip('/')}")
        target = url.path or "/"
        query = urllib.parse.urlencode(params) if params else url.query
        if query:
            target += "?" + query
        allheaders = dict(self.default_headers)
        if headers:
            allheaders.update(headers)
        span = getattr(ctx, "span", None) if ctx is not None else None
        if span is not None:
            allheaders["traceparent"] = span.traceparent
        data = None
        if body is not None:
            if isinstance(body, (dict, list)):
                data = json.dumps(body).encode()
                allheaders.setdefault("Content-Type", "application/json")
            elif isinstance(body, str):
                data = body.encode()
            else:
                data = body
        conn_cls = (http.client.HTTPSConnection if url.scheme == "https"
                    else http.client.HTTPConnection)
        start = time.time()
        conn = conn_cls(url.hostname, url.port,
                        timeout=timeout_s or self.timeout_s)
        try:
            conn.request(method, target, body=data, headers=allheaders)
            resp = conn.getresponse()
            out = ServiceResponse(resp.status, b"", dict(resp.getheaders()))
            if stream:
                out.raw = (conn, resp)
            else:
                out.body = resp.read()
                conn.close()
        except BaseException:
            conn.close()
            raise
        finally:
            elapsed = time.time() - start
            if self.metrics is not None:
                try:
                    self.metrics.record_histogram(
                        "app_http_service_response", elapsed,
                        path=f"{self.address}/{path.lstrip('/')}",
                        method=method)
                except Exception:  # noqa: BLE001 - metrics never fail a call
                    pass
            if self.logger is not None:
                self.logger.debugf("http service %s %s took %dµs", method,
                                   url.geturl(), int(elapsed * 1e6))
        return out

    def health_check(self) -> Health:
        try:
            resp = self.request(None, "GET", self.health_endpoint)
            if resp.status_code < 500:
                return Health(status=STATUS_UP, details={"host": self.address})
            return Health(status=STATUS_DOWN,
                          details={"host": self.address,
                                   "status_code": resp.status_code})
        except Exception as exc:  # noqa: BLE001 - unreachable is DOWN
            return Health(status=STATUS_DOWN,
                          details={"host": self.address, "error": str(exc)})


# -- options (decorators) -----------------------------------------------------
class Options:
    def apply(self, svc: HTTPService) -> HTTPService:  # pragma: no cover
        raise NotImplementedError


class DefaultHeaders(Options):
    def __init__(self, **headers: str):
        self.headers = headers

    def apply(self, svc: HTTPService) -> HTTPService:
        svc.default_headers.update(self.headers)
        return svc


class BasicAuthConfig(Options):
    def __init__(self, username: str, password: str):
        self.username = username
        self.password = password

    def apply(self, svc: HTTPService) -> HTTPService:
        token = base64.b64encode(
            f"{self.username}:{self.password}".encode()).decode()
        svc.default_headers["Authorization"] = f"Basic {token}"
        return svc


class APIKeyConfig(Options):
    def __init__(self, api_key: str):
        self.api_key = api_key

    def apply(self, svc: HTTPService) -> HTTPService:
        svc.default_headers["X-Api-Key"] = self.api_key
        return svc


class OAuthConfig(Options):
    """Client-credentials flow: fetches and caches a bearer token."""

    def __init__(self, client_id: str, client_secret: str, token_url: str):
        self.client_id = client_id
        self.client_secret = client_secret
        self.token_url = token_url
        self._token: Optional[str] = None
        self._expiry = 0.0
        self._lock = threading.Lock()

    def _fetch(self) -> Optional[str]:
        with self._lock:
            if self._token and time.time() < self._expiry - 30:
                return self._token
            try:
                url = urllib.parse.urlsplit(self.token_url)
                svc = HTTPService(f"{url.scheme}://{url.netloc}")
                resp = svc.request(
                    None, "POST", url.path,
                    body=urllib.parse.urlencode({
                        "grant_type": "client_credentials",
                        "client_id": self.client_id,
                        "client_secret": self.client_secret}),
                    headers={"Content-Type":
                             "application/x-www-form-urlencoded"})
                payload = resp.json()
                self._token = payload.get("access_token")
                self._expiry = time.time() + float(
                    payload.get("expires_in", 3600))
            except Exception:  # noqa: BLE001
                self._token = None
            return self._token

    def apply(self, svc: HTTPService) -> HTTPService:
        original = svc.request

        def with_token(ctx, method, path, params=None, body=None,
                       headers=None, **kwargs):
            token = self._fetch()
            headers = dict(headers or {})
            if token:
                headers["Authorization"] = f"Bearer {token}"
            return original(ctx, method, path, params=params, body=body,
                            headers=headers, **kwargs)

        svc.request = with_token  # type: ignore[method-assign]
        return svc


class HealthConfig(Options):
    def __init__(self, endpoint: str):
        self.endpoint = endpoint

    def apply(self, svc: HTTPService) -> HTTPService:
        svc.health_endpoint = self.endpoint.lstrip("/")
        return svc


class CircuitBreakerConfig(Options):
    def __init__(self, threshold: int = 5, interval_s: float = 10.0):
        self.threshold = threshold
        self.interval_s = interval_s

    def apply(self, svc: HTTPService) -> "CircuitBreaker":
        return CircuitBreaker(svc, self.threshold, self.interval_s)


class CircuitBreaker:
    """Counts consecutive failures and opens past the threshold; while open
    a background prober hits the health endpoint and closes it on
    success."""

    def __init__(self, svc: HTTPService, threshold: int, interval_s: float):
        self._svc = svc
        self.threshold = threshold
        self.interval_s = interval_s
        self.failure_count = 0
        self.open = False
        self.opened_at = 0.0
        self._lock = threading.Lock()
        self._probe_thread: Optional[threading.Thread] = None
        self._closed = threading.Event()

    def __getattr__(self, name):
        # passthrough for the non-verb attributes (address, ...)
        return getattr(self._svc, name)

    def _execute(self, fn):
        with self._lock:
            if self.open:
                raise CircuitOpenError()
        try:
            result = fn()
        except Exception:
            with self._lock:
                self.failure_count += 1
                if self.failure_count > self.threshold and not self.open:
                    self.open = True
                    self.opened_at = time.time()
                    self._start_probing()
            raise
        with self._lock:
            self.failure_count = 0
        return result

    def _start_probing(self) -> None:
        def probe() -> None:
            while not self._closed.wait(self.interval_s):
                health = self._svc.health_check()
                if health.status == STATUS_UP:
                    with self._lock:
                        self.open = False
                        self.failure_count = 0
                        self._probe_thread = None
                    return

        self._probe_thread = threading.Thread(target=probe,
                                              name="circuit-probe",
                                              daemon=True)
        self._probe_thread.start()

    def close(self) -> None:
        """End the prober (an owner going away: the fleet registry's stop)."""
        self._closed.set()

    def get(self, ctx, path, params=None, headers=None):
        return self._execute(lambda: self._svc.get(ctx, path, params, headers))

    def post(self, ctx, path, params=None, body=None, headers=None):
        return self._execute(
            lambda: self._svc.post(ctx, path, params, body, headers))

    def put(self, ctx, path, params=None, body=None, headers=None):
        return self._execute(
            lambda: self._svc.put(ctx, path, params, body, headers))

    def patch(self, ctx, path, params=None, body=None, headers=None):
        return self._execute(
            lambda: self._svc.patch(ctx, path, params, body, headers))

    def delete(self, ctx, path, body=None, headers=None):
        return self._execute(lambda: self._svc.delete(ctx, path, body,
                                                      headers))

    def request(self, ctx, method, path, **kwargs):
        return self._execute(
            lambda: self._svc.request(ctx, method, path, **kwargs))

    def health_check(self) -> Health:
        with self._lock:
            if self.open:
                return Health(status=STATUS_DOWN,
                              details={"host": self._svc.address,
                                       "circuit": "open"})
        return self._svc.health_check()


def new_http_service(address: str, logger=None, metrics=None,
                     *options: Options):
    svc: Any = HTTPService(address, logger, metrics)
    for opt in options:
        svc = opt.apply(svc)
    return svc
