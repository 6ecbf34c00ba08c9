"""The port's auth middlewares and remote log level against the reference's.

- Each auth middleware of gofr_tpu_torch/http/middleware.py and its
  reference twin (gofr_tpu/http/middleware) on identical requests: the
  same status, body, headers and ``auth_subject`` (and JWT claims) for
  basic auth, API keys, HS256 bearer tokens and RS256 bearer tokens
  against a JWKS (with ``cryptography``), the ``/.well-known/*`` bypass
  included; the HS256 tokens are byte-equal; a JWKS refresh that fails
  keeps the old keys; key rotation is picked up by the background refresh.
- The App's ``enable_*_auth`` over HTTP beside the reference App's, and
  ``enable_oauth_jwks`` without ``cryptography`` logging and skipping; the
  JWKS refresher stops at shutdown.
- ``logging/remote.py``: ``_extract_level`` equal to the reference's on its
  shapes, and a live poll of a local stub: an App with REMOTE_LOG_URL
  changes its level within one REMOTE_LOG_FETCH_INTERVAL, and its shutdown
  stops the poller.
"""

import base64
import http.client
import http.server
import json
import sys
import threading
import time

import pytest

from gofr_tpu.http import middleware as jmw
from gofr_tpu.http.request import Request as JRequest
from gofr_tpu.http.responder import Response as JResponse
from gofr_tpu.logging.remote import _extract_level as j_extract
from gofr_tpu_torch.http import middleware as tmw
from gofr_tpu_torch.http.request import Request as TRequest
from gofr_tpu_torch.http.responder import Response as TResponse
from gofr_tpu_torch.logging import Level, MockLogger
from gofr_tpu_torch.logging.remote import (_extract_level,
                                           fetch_and_update_level)

PKGS = {"jax": (jmw, JRequest, JResponse), "torch": (tmw, TRequest,
                                                     TResponse)}


def _ok(response_cls):
    return lambda request: response_cls(status=200, body=b"ok")


def _run(pkg: str, make_mw, requests) -> list:
    """Each (target, headers) through make_mw(module)'s middleware around an
    ok handler: (status, body, headers, auth_subject, jwt claims)."""
    mw, request_cls, response_cls = PKGS[pkg]
    handler = make_mw(mw)(_ok(response_cls))
    out = []
    for target, headers in requests:
        req = request_cls("GET", target, headers=headers)
        resp = handler(req)
        out.append((resp.status, resp.body, dict(resp.headers),
                    req.auth_subject, req.context.get("jwt_claims")))
    return out


def _basic(user_pass: str) -> dict:
    return {"Authorization": "Basic " + base64.b64encode(
        user_pass.encode()).decode()}


def _bearer(token: str) -> dict:
    return {"Authorization": f"Bearer {token}"}


def _same(make_mw, requests):
    want = _run("jax", make_mw, requests)
    got = _run("torch", make_mw, requests)
    assert got == want
    return got


def test_basic_auth_as_the_reference():
    requests = [("/x", {}), ("/x", _basic("admin:wrong")),
                ("/x", _basic("admin:secret")), ("/x", _basic("nobody:x")),
                ("/x", {"Authorization": "Basic !!!"}),
                ("/x", {"Authorization": "Bearer t"}),
                ("/.well-known/health", {})]
    got = _same(lambda mw: mw.basic_auth_middleware({"admin": "secret"}),
                requests)
    assert [g[0] for g in got] == [401, 401, 200, 401, 401, 401, 200]
    assert got[0][1] == b'{"error": {"message": "Unauthorized"}}'
    assert got[0][2]["WWW-Authenticate"] == "Basic"
    assert got[2][3] == "admin"
    got = _same(lambda mw: mw.basic_auth_middleware(
        {}, validate_func=lambda u, p: u == p), [
        ("/x", _basic("a:a")), ("/x", _basic("a:b"))])
    assert [g[0] for g in got] == [200, 401]


def test_api_key_auth_as_the_reference():
    requests = [("/x", {}), ("/x", {"X-API-Key": "nope"}),
                ("/x", {"X-API-Key": "k1"}), ("/.well-known/alive", {})]
    got = _same(lambda mw: mw.api_key_auth_middleware(["k1", "k2"]),
                requests)
    assert [g[0] for g in got] == [401, 401, 200, 200]
    assert got[2][3] == "api-key"
    got = _same(lambda mw: mw.api_key_auth_middleware(
        validate_func=lambda k: k.startswith("ok")), [
        ("/x", {"X-API-Key": "ok-1"}), ("/x", {"X-API-Key": "no"})])
    assert [g[0] for g in got] == [200, 401]


def test_hs256_jwt_and_oauth_as_the_reference():
    exp = time.time() + 60
    claims = {"sub": "user1", "exp": exp, "scope": "gen"}
    token = tmw.jwt_encode(claims, "s3cr3t")
    assert token == jmw.jwt_encode(claims, "s3cr3t")
    assert tmw.jwt_decode(token, "s3cr3t") == claims
    assert tmw.jwt_decode(token, "wrong") is None
    expired = tmw.jwt_encode({"sub": "u", "exp": time.time() - 1}, "s3cr3t")
    assert tmw.jwt_decode(expired, "s3cr3t") is None
    assert tmw.jwt_decode("a.b", "s3cr3t") is None
    got = _same(lambda mw: mw.oauth_middleware("s3cr3t"), [
        ("/x", {}), ("/x", _bearer(token)), ("/x", _bearer(expired)),
        ("/x", _bearer(token[:-4] + "AAAA")), ("/x", _basic("a:b")),
        ("/.well-known/health", {})])
    assert [g[0] for g in got] == [401, 200, 401, 401, 401, 200]
    assert got[1][3] == "user1" and got[1][4] == claims
    assert json.loads(got[2][1]) == {"error": {
        "message": "invalid or expired token"}}


def _rsa_jwks(kid="kid-1"):
    """An RSA key, its JWKS document and an RS256 signer (cryptography)."""
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding, rsa

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    pub = key.public_key().public_numbers()

    def b64(x: int) -> str:
        raw = x.to_bytes((x.bit_length() + 7) // 8, "big")
        return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()

    jwks = {"keys": [{"kty": "RSA", "kid": kid, "alg": "RS256",
                      "n": b64(pub.n), "e": b64(pub.e)},
                     {"kty": "EC", "kid": "ignored"}]}

    def sign(claims: dict, kid: str = kid, alg: str = "RS256") -> str:
        header = tmw._b64url_encode(json.dumps({"alg": alg,
                                                "kid": kid}).encode())
        payload = tmw._b64url_encode(json.dumps(claims).encode())
        sig = key.sign(f"{header}.{payload}".encode(), padding.PKCS1v15(),
                       hashes.SHA256())
        return f"{header}.{payload}.{tmw._b64url_encode(sig)}"

    return jwks, sign


def test_rs256_jwks_as_the_reference():
    jwks, sign = _rsa_jwks()
    keysets = {}

    def make(mw):
        ks = mw.JWKSKeySet("http://test/jwks", refresh_interval_s=3600,
                           fetch=lambda: jwks)
        keysets[mw.__name__] = ks
        return mw.oauth_jwks_middleware(ks)

    good = sign({"sub": "alice", "exp": time.time() + 60})
    try:
        got = _same(make, [
            ("/x", {}), ("/x", _bearer(good)),
            ("/x", _bearer(good[:-8] + "AAAAAAAA")),
            ("/x", _bearer(sign({"sub": "a", "exp": time.time() - 1}))),
            ("/x", _bearer(sign({"sub": "a"}, kid="kid-9"))),
            ("/x", _bearer(tmw.jwt_encode({"sub": "eve"}, "n"))),
            ("/.well-known/alive", {})])
        assert [g[0] for g in got] == [401, 200, 401, 401, 401, 401, 200]
        assert got[1][3] == "alice"
        assert len(keysets[tmw.__name__]) == 1    # the EC key is skipped
    finally:
        for ks in keysets.values():
            ks.close()


def test_jwks_refresh_rotates_and_a_failed_fetch_keeps_the_keys():
    jwks, sign = _rsa_jwks()
    jwks2, sign2 = _rsa_jwks()
    state = {"doc": jwks, "fail": False, "count": 0}

    def fetch():
        state["count"] += 1
        if state["fail"]:
            raise OSError("endpoint down")
        return state["doc"]

    ks = tmw.JWKSKeySet("http://test/jwks", refresh_interval_s=0.05,
                        fetch=fetch, logger=MockLogger())
    try:
        state["fail"] = True
        ks.refresh()
        assert len(ks) == 1
        token = sign({"sub": "x", "exp": time.time() + 60})
        assert tmw.jwt_decode_rs256(token, ks)["sub"] == "x"
        state["fail"] = False
        state["doc"] = jwks2
        deadline = time.time() + 5
        new = sign2({"sub": "bob", "exp": time.time() + 60})
        while time.time() < deadline and tmw.jwt_decode_rs256(new, ks) is None:
            time.sleep(0.05)
        assert tmw.jwt_decode_rs256(new, ks)["sub"] == "bob"
        assert tmw.jwt_decode_rs256(token, ks) is None
        assert state["count"] >= 3
    finally:
        ks.close()
    ks._thread.join(timeout=5)
    assert not ks._thread.is_alive()


# -- the App's auth ------------------------------------------------------------------
def _apps():
    from gofr_tpu import App as JApp
    from gofr_tpu.config import MockConfig as JConfig
    from gofr_tpu_torch.app import App as TApp

    env = {"HTTP_PORT": "0", "METRICS_PORT": "0", "GRPC_PORT": "0",
           "LOG_LEVEL": "ERROR"}
    return [("jax", JApp(config=JConfig(env))), ("torch", TApp(env))]


def _call(port, path, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path, headers=headers or {})
    resp = conn.getresponse()
    out = (resp.status, resp.read(), resp.getheader("WWW-Authenticate"))
    conn.close()
    return out


@pytest.mark.parametrize("scheme", ["basic", "api_key", "oauth"])
def test_app_auth_over_http_as_the_reference(scheme):
    token = tmw.jwt_encode({"sub": "u", "exp": time.time() + 60}, "sec")
    good = {"basic": _basic("admin:pw"), "api_key": {"X-API-Key": "k1"},
            "oauth": _bearer(token)}[scheme]
    seen = {}
    for name, app in _apps():
        if scheme == "basic":
            app.enable_basic_auth("admin", "pw")
        elif scheme == "api_key":
            app.enable_api_key_auth("k1")
        else:
            app.enable_oauth("sec")
        app.get("/hello", lambda ctx: {"hi": 1})
        app.start()
        try:
            seen[name] = [_call(app.http_port, "/hello"),
                          _call(app.http_port, "/hello", good),
                          _call(app.http_port, "/.well-known/alive")[0]]
        finally:
            app.shutdown()
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0][0] == 401 and seen["torch"][1][0] == 200


def test_app_oauth_jwks_stops_its_refresher_and_needs_cryptography(
        monkeypatch):
    jwks, sign = _rsa_jwks()
    from gofr_tpu_torch.app import App

    app = App({"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR"})
    ks = tmw.JWKSKeySet("http://test/jwks", refresh_interval_s=0.05,
                        fetch=lambda: jwks)
    app.enable_oauth_jwks("http://test/jwks", keyset=ks)
    app.get("/hello", lambda ctx: {"hi": 1})
    app.start()
    try:
        assert _call(app.http_port, "/hello")[0] == 401
        assert _call(app.http_port, "/hello", _bearer(
            sign({"sub": "a", "exp": time.time() + 60})))[0] == 200
    finally:
        app.shutdown()
    ks._thread.join(timeout=5)
    assert not ks._thread.is_alive()
    # without cryptography: logged and skipped, the routes stay open
    for name in ("cryptography", "cryptography.hazmat.primitives.asymmetric"):
        monkeypatch.setitem(sys.modules, name, None)
    app = App({"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR"})
    app.logger = app.container.logger = MockLogger()
    app.enable_oauth_jwks("http://127.0.0.1:9/jwks")
    app.get("/hello", lambda ctx: {"hi": 1})
    app.start()
    try:
        assert _call(app.http_port, "/hello")[0] == 200
    finally:
        app.shutdown()
    assert "OAuth JWKS disabled" in app.logger.output()


# -- the remote log level ------------------------------------------------------------
SHAPES = ["DEBUG", {"data": {"LOG_LEVEL": "WARN"}},
          {"data": [{"serviceName": "x", "logLevel": {"LOG_LEVEL": "ERROR"}}]},
          {"data": [{"serviceName": "x", "logLevel": "NOTICE"}]},
          {"LOG_LEVEL": "INFO"}, {"nonsense": 1}, {"data": []}, [1, 2], 7,
          None]


def test_extract_level_as_the_reference():
    assert [_extract_level(p) for p in SHAPES] == [j_extract(p)
                                                   for p in SHAPES]
    assert _extract_level(SHAPES[2]) == "ERROR"


class _Stub:
    """A local level endpoint: GET answers (status, JSON body) from
    `self.reply`, and counts its hits."""

    def __init__(self):
        stub = self
        self.reply = (200, {"data": [{"serviceName": "t", "logLevel": {
            "LOG_LEVEL": "DEBUG"}}]})
        self.hits = 0

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                stub.hits += 1
                status, body = stub.reply
                raw = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.url = f"http://127.0.0.1:{self.server.server_port}/level"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def test_fetch_changes_the_level_only_on_a_200():
    stub = _Stub()
    try:
        logger = MockLogger(level=Level.INFO)
        stub.reply = (500, {"data": {"LOG_LEVEL": "DEBUG"}})
        fetch_and_update_level(logger, stub.url)
        assert logger.level == Level.INFO
        stub.reply = (200, {"nonsense": 1})
        fetch_and_update_level(logger, stub.url)
        assert logger.level == Level.INFO
        stub.reply = (200, {"data": {"LOG_LEVEL": "WARN"}})
        fetch_and_update_level(logger, stub.url)
        assert logger.level == Level.WARN
        assert "LOG_LEVEL updated from INFO to WARN" in logger.output()
        fetch_and_update_level(logger, "http://127.0.0.1:9/nowhere")
        assert logger.level == Level.WARN
    finally:
        stub.close()


def test_app_polls_the_remote_level_and_stops_at_shutdown():
    from gofr_tpu_torch.app import App

    stub = _Stub()
    try:
        app = App({"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "INFO",
                   "REMOTE_LOG_URL": stub.url,
                   "REMOTE_LOG_FETCH_INTERVAL": "0.1"})
        poller = app.container._level_poller
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and app.logger.level != Level.DEBUG:
            time.sleep(0.02)
        assert app.logger.level == Level.DEBUG
        stub.reply = (200, {"data": {"LOG_LEVEL": "ERROR"}})
        t0 = time.monotonic()
        while time.monotonic() < deadline and app.logger.level != Level.ERROR:
            time.sleep(0.02)
        assert app.logger.level == Level.ERROR
        assert time.monotonic() - t0 < 1.0     # within a few intervals
        app.shutdown()
        assert not poller.is_alive()
        hits = stub.hits
        time.sleep(0.3)
        assert stub.hits == hits
    finally:
        stub.close()
