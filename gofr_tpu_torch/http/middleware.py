"""The default middleware chain (Tracer -> Logging -> CORS -> Metrics) and auth.

A copy of ``gofr_tpu/http/middleware/__init__.py``: ``tracer_middleware``
(a span per request under an inbound W3C ``traceparent``, kept raw on
``request.traceparent`` and the span on ``request.span``, an ``X-Trace-Id``
response header), ``logging_middleware`` with ``RequestLog`` (one
structured record per request, and recovery of a handler's exception as a
500), ``cors_middleware``, ``metrics_middleware`` (``app_http_response`` by
route template, method and status), and the auth middlewares:
``basic_auth_middleware`` (users or a validator; ``auth_subject`` the
user), ``api_key_auth_middleware`` (``X-API-Key``), ``jwt_encode`` /
``jwt_decode`` (HS256 with ``exp``) behind ``oauth_middleware``, and RS256
bearer tokens against a kid-indexed ``JWKSKeySet`` (fetched with urllib and
refreshed on a background thread, which ``close`` stops; gated on the
``cryptography`` package, whose absence makes its construction raise
RuntimeError) through ``rs256_verify`` / ``jwt_decode_rs256`` behind
``oauth_jwks_middleware``; the bearer paths put the claims in
``request.context["jwt_claims"]``. Every auth middleware passes
``/.well-known/*`` through (``_is_well_known``) and answers the reference's
401: ``{"error": {"message": ...}}`` with ``WWW-Authenticate: Basic``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import threading
import time
from typing import Callable, Dict, Iterable, Optional

from ..logging import PrettyPrint
from .errors import PanicRecovery
from .request import Request
from .responder import Response
from .router import WireHandler

WELL_KNOWN_PREFIX = "/.well-known/"


def _is_well_known(request: Request) -> bool:
    return request.path.startswith(WELL_KNOWN_PREFIX)


# -- tracing ------------------------------------------------------------------
def tracer_middleware(tracer) -> Callable[[WireHandler], WireHandler]:
    def mw(inner: WireHandler) -> WireHandler:
        def handle(request: Request) -> Response:
            # the raw header too: handlers thread it through
            # engine.submit(traceparent=...) so the engine's spans parent
            # under the caller's trace even after this span has closed
            # (a streamed response ends it before admission)
            request.traceparent = request.headers.get("traceparent")
            span = tracer.start_span(
                f"{request.method} {request.path}",
                traceparent=request.traceparent,
            )
            span.set_attribute("http.method", request.method)
            span.set_attribute("http.target", request.path)
            request.span = span
            try:
                resp = inner(request)
                span.set_attribute("http.status_code", resp.status)
                span.set_status(resp.status < 500)
                resp.headers.setdefault("X-Trace-Id", span.trace_id)
                return resp
            finally:
                span.end()

        return handle

    return mw


# -- request logging + panic recovery ----------------------------------------
class RequestLog(PrettyPrint):
    """Structured request log record."""

    def __init__(self, trace_id: str, method: str, uri: str, status: int, duration_us: int, ip: str):
        self.trace_id = trace_id
        self.method = method
        self.uri = uri
        self.status = status
        self.response_time_us = duration_us
        self.ip = ip

    def pretty_print(self, fp) -> None:
        color = 32 if self.status < 400 else (33 if self.status < 500 else 31)
        fp.write(f"{self.trace_id} \x1b[{color}m{self.status}\x1b[0m "
                 f"{self.response_time_us:>8}µs {self.method} {self.uri}")


def logging_middleware(logger) -> Callable[[WireHandler], WireHandler]:
    def mw(inner: WireHandler) -> WireHandler:
        def handle(request: Request) -> Response:
            start = time.time()
            try:
                resp = inner(request)
            except Exception as exc:  # noqa: BLE001 - panic recovery -> 500
                logger.error({"error": str(exc), "path": request.path,
                              "method": request.method, "panic": True})
                err = PanicRecovery()
                resp = Response(status=err.status_code,
                                headers={"Content-Type": "application/json"},
                                body=json.dumps({"error": {"message": err.message}}).encode())
            duration_us = int((time.time() - start) * 1e6)
            trace_id = request.span.trace_id if request.span is not None else ""
            record = RequestLog(trace_id, request.method, request.path, resp.status,
                                duration_us, request.client_addr)
            if resp.status >= 500:
                logger.error(record)
            else:
                logger.info(record)
            return resp

        return handle

    return mw


# -- CORS ---------------------------------------------------------------------
def cors_middleware(allowed_headers: str = "Authorization, Content-Type, x-requested-with, origin, true-client-ip, X-Correlation-ID",
                    allowed_methods: str = "PUT, POST, GET, DELETE, OPTIONS, PATCH") -> Callable[[WireHandler], WireHandler]:
    def mw(inner: WireHandler) -> WireHandler:
        def handle(request: Request) -> Response:
            if request.method == "OPTIONS":
                resp = Response(status=200)
            else:
                resp = inner(request)
            resp.headers.setdefault("Access-Control-Allow-Origin", "*")
            resp.headers.setdefault("Access-Control-Allow-Headers", allowed_headers)
            resp.headers.setdefault("Access-Control-Allow-Methods", allowed_methods)
            return resp

        return handle

    return mw


# -- metrics ------------------------------------------------------------------
def metrics_middleware(metrics) -> Callable[[WireHandler], WireHandler]:
    def mw(inner: WireHandler) -> WireHandler:
        def handle(request: Request) -> Response:
            start = time.time()
            resp = inner(request)
            # by the matched route template, not the raw path: bounded
            # series cardinality
            route = getattr(request, "route_pattern", None) or "unmatched"
            metrics.record_histogram("app_http_response", time.time() - start,
                                     path=route, method=request.method,
                                     status=str(resp.status))
            return resp

        return handle

    return mw


# -- auth ---------------------------------------------------------------------
def _unauthorized(message: str = "Unauthorized") -> Response:
    return Response(status=401, headers={"Content-Type": "application/json",
                                         "WWW-Authenticate": "Basic"},
                    body=json.dumps({"error": {"message": message}}).encode())


def basic_auth_middleware(users: dict, validate_func: Optional[Callable[[str, str], bool]] = None):
    """users: {username: password}; validate_func(user, password), when
    given, decides instead."""

    def mw(inner: WireHandler) -> WireHandler:
        def handle(request: Request) -> Response:
            if _is_well_known(request):
                return inner(request)
            header = request.headers.get("authorization", "")
            if not header.startswith("Basic "):
                return _unauthorized()
            try:
                decoded = base64.b64decode(header[6:]).decode("utf-8")
                user, _, password = decoded.partition(":")
            except Exception:  # noqa: BLE001
                return _unauthorized()
            if validate_func is not None:
                ok = validate_func(user, password)
            else:
                expected = users.get(user)
                ok = expected is not None and hmac.compare_digest(expected, password)
            if not ok:
                return _unauthorized()
            request.auth_subject = user
            return inner(request)

        return handle

    return mw


def api_key_auth_middleware(keys: Iterable[str] = (), validate_func: Optional[Callable[[str], bool]] = None):
    keyset = set(keys)

    def mw(inner: WireHandler) -> WireHandler:
        def handle(request: Request) -> Response:
            if _is_well_known(request):
                return inner(request)
            key = request.headers.get("x-api-key", "")
            if not key:
                return _unauthorized()
            ok = validate_func(key) if validate_func is not None else key in keyset
            if not ok:
                return _unauthorized()
            request.auth_subject = "api-key"
            return inner(request)

        return handle

    return mw


# -- JWT (HS256) --------------------------------------------------------------
def _b64url_decode(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def _b64url_encode(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def jwt_encode(claims: dict, secret: str) -> str:
    header = _b64url_encode(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url_encode(json.dumps(claims).encode())
    signing = f"{header}.{payload}".encode()
    sig = hmac.new(secret.encode(), signing, hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64url_encode(sig)}"


def jwt_decode(token: str, secret: str) -> Optional[dict]:
    parts = token.split(".")
    if len(parts) != 3:
        return None
    signing = f"{parts[0]}.{parts[1]}".encode()
    expected = hmac.new(secret.encode(), signing, hashlib.sha256).digest()
    try:
        if not hmac.compare_digest(expected, _b64url_decode(parts[2])):
            return None
        claims = json.loads(_b64url_decode(parts[1]))
    except Exception:  # noqa: BLE001
        return None
    exp = claims.get("exp")
    if exp is not None and time.time() > float(exp):
        return None
    return claims


# -- JWT (RS256 via JWKS) -----------------------------------------------------
class JWKSKeySet:
    """kid-indexed RSA public keys fetched from a JWKS endpoint, refreshed in
    the background — parity with the reference's OAuth provider polling
    (oauth.go:53-140: NewOAuth spawns a refresh goroutine on an interval).

    Gated on the `cryptography` package for the signature math; construction
    raises cleanly when it is absent (the reference's nil-on-misconfig
    posture is handled by enable_oauth logging and skipping)."""

    def __init__(self, url: str, refresh_interval_s: float = 300.0,
                 logger=None, fetch=None):
        try:
            from cryptography.hazmat.primitives.asymmetric import rsa  # noqa: F401
        except ImportError as exc:  # pragma: no cover - env has it
            raise RuntimeError(
                "RS256 JWKS requires the 'cryptography' package") from exc
        self.url = url
        self.refresh_interval_s = refresh_interval_s
        self.logger = logger
        self._fetch = fetch or self._http_fetch
        self._keys: Dict[str, tuple] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.refresh()
        self._thread = threading.Thread(target=self._refresh_loop,
                                        name="jwks-refresh", daemon=True)
        self._thread.start()

    def _http_fetch(self) -> dict:
        import urllib.request

        with urllib.request.urlopen(self.url, timeout=10) as resp:
            return json.loads(resp.read().decode())

    def refresh(self) -> None:
        try:
            doc = self._fetch()
            keys = {}
            for key in doc.get("keys", []):
                if key.get("kty") != "RSA":
                    continue
                kid = key.get("kid", "")
                n = int.from_bytes(_b64url_decode(key["n"]), "big")
                e = int.from_bytes(_b64url_decode(key["e"]), "big")
                keys[kid] = (n, e)
            with self._lock:
                self._keys = keys
        except Exception as exc:  # noqa: BLE001 - keep serving old keys
            if self.logger is not None:
                self.logger.errorf("JWKS refresh from %s failed: %s",
                                   self.url, exc)

    def _refresh_loop(self) -> None:
        while not self._stop.wait(self.refresh_interval_s):
            self.refresh()

    def close(self) -> None:
        self._stop.set()

    def get(self, kid: str):
        with self._lock:
            return self._keys.get(kid)

    def __len__(self) -> int:
        with self._lock:
            return len(self._keys)


def rs256_verify(signing_input: bytes, signature: bytes, n: int, e: int) -> bool:
    """RSASSA-PKCS1-v1_5 SHA-256 verification against a public (n, e)."""
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding, rsa

    try:
        pub = rsa.RSAPublicNumbers(e, n).public_key()
        pub.verify(signature, signing_input, padding.PKCS1v15(),
                   hashes.SHA256())
        return True
    except (InvalidSignature, ValueError):
        return False


def jwt_decode_rs256(token: str, keyset: JWKSKeySet) -> Optional[dict]:
    """Validate an RS256 bearer JWT against the JWKS keys (kid-matched)."""
    parts = token.split(".")
    if len(parts) != 3:
        return None
    try:
        header = json.loads(_b64url_decode(parts[0]))
        if header.get("alg") != "RS256":  # no alg-confusion downgrades
            return None
        key = keyset.get(header.get("kid", ""))
        if key is None:
            return None
        signing = f"{parts[0]}.{parts[1]}".encode()
        if not rs256_verify(signing, _b64url_decode(parts[2]), *key):
            return None
        claims = json.loads(_b64url_decode(parts[1]))
    except Exception:  # noqa: BLE001
        return None
    exp = claims.get("exp")
    if exp is not None and time.time() > float(exp):
        return None
    return claims


def oauth_jwks_middleware(keyset: JWKSKeySet):
    """Bearer-JWT validation against background-refreshed RSA JWKS — the
    reference's OAuth shape (oauth.go:53-140)."""

    def mw(inner: WireHandler) -> WireHandler:
        def handle(request: Request) -> Response:
            if _is_well_known(request):
                return inner(request)
            header = request.headers.get("authorization", "")
            if not header.startswith("Bearer "):
                return _unauthorized()
            claims = jwt_decode_rs256(header[7:], keyset)
            if claims is None:
                return _unauthorized("invalid or expired token")
            request.auth_subject = str(claims.get("sub", ""))
            request.context["jwt_claims"] = claims
            return inner(request)

        return handle

    return mw


def oauth_middleware(secret: str):
    """Bearer-JWT validation (HS256 shared secret). For provider-issued RSA
    tokens use oauth_jwks_middleware, which validates RS256 against a
    background-refreshed JWKS endpoint like the reference (oauth.go:53-140);
    HS256 remains for zero-egress deployments. Claim checks (exp) and claim
    propagation are identical on both paths."""

    def mw(inner: WireHandler) -> WireHandler:
        def handle(request: Request) -> Response:
            if _is_well_known(request):
                return inner(request)
            header = request.headers.get("authorization", "")
            if not header.startswith("Bearer "):
                return _unauthorized()
            claims = jwt_decode(header[7:], secret)
            if claims is None:
                return _unauthorized("invalid or expired token")
            request.auth_subject = str(claims.get("sub", ""))
            request.context["jwt_claims"] = claims
            return inner(request)

        return handle

    return mw
