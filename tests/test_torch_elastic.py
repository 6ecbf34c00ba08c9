"""Drain with migration and the warm boot on the port (tpu/migrate.py,
App.enable_drain_migration, serve.py's ELASTIC_WARM_BOOT) against the
reference's.

The twins of tests/test_elastic.py's migration half at the debug preset
on the CPU (its autoscaler half, with the port's router, is in
tests/test_torch_fleet_elastic.py): a
session exported mid-stream from one port engine and landed on another is
token-equal to the JAX colocated engine's stream on the same weights; a
migration whose peers all refuse degrades to a local resume with the
stream complete; ``begin_drain`` is idempotent; between two port Apps over
HTTP, ``POST /debug/drain`` ships a live stream through the peer's ``POST
/migrate`` (a refused peer degrades to ``local_resume``), and ``GET
/debug/kvtier`` feeds a warm-booting App, whose ``/stats`` goes
``warming`` then ``serving`` with ``warm_boot_s``. The stdlib peer client
(service/) is checked on its own: buffered and streamed bodies, the
circuit breaker.
"""

import http.server
import json
import threading
import time
import urllib.request

import jax
import pytest

from gofr_tpu.models.llama import LlamaConfig as JConfig
from gofr_tpu.models.llama import llama_init as jax_init
from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
from gofr_tpu_torch import serve
from gofr_tpu_torch.container import STATUS_DOWN, STATUS_UP
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.service import (CircuitBreakerConfig, CircuitOpenError,
                                    DefaultHeaders, HTTPService,
                                    new_http_service)
from gofr_tpu_torch.tpu.faults import FaultPlane
from gofr_tpu_torch.tpu.kvtier import RedisKVTier
from gofr_tpu_torch.tpu.migrate import (Lifecycle, MigrationCoordinator,
                                        admit_migration)
from gofr_tpu_torch.tpu.paging import PagedLLMEngine

from _torch_env import INCIDENT_DIR

CFG = LlamaConfig.debug()
ENGINE = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16),
              page_size=8)
PROMPT, N = [5, 6, 7, 8, 9], 32
BASE = {"MODEL_PRESET": "debug", "HTTP_PORT": "0", "METRICS_PORT": "0",
        "GRPC_PORT": "0",
        "MAX_BATCH": "4", "MAX_SEQ_LEN": "64", "PREFILL_BUCKETS": "8,16",
        "PAGE_SIZE": "8", "WARMUP": "false", "REQUEST_TIMEOUT": "120",
        "LOG_LEVEL": "WARN", "HOSTPROF": "false",
        "INCIDENT_DIR": INCIDENT_DIR}


class MockLogger:
    def debugf(self, *a, **k):
        pass

    infof = warnf = errorf = debugf


@pytest.fixture(scope="module")
def weights():
    jparams = jax_init(JConfig.debug(), seed=0)
    return jparams, params_from_numpy(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def golden(weights):
    """The JAX colocated paged engine's greedy stream, computed live."""
    eng = JPaged(weights[0], JConfig.debug(), logger=MockLogger(), **ENGINE)
    eng.start()
    try:
        return eng.generate(PROMPT, max_new_tokens=N, temperature=0.0)
    finally:
        eng.stop()


def _slow_plane(delay_s: float = 0.05) -> FaultPlane:
    """Decode dispatches throttled, so a stream is live at the export."""
    return FaultPlane([{"site": "engine.decode", "action": "delay",
                        "every": 1, "times": 0, "delay_s": delay_s}])


def _engine(weights, slow: bool = False, **kw):
    if slow:
        kw.update(decode_block_size=1, faults=_slow_plane())
    eng = PagedLLMEngine(weights[1], CFG, device="cpu", logger=MockLogger(),
                         **dict(ENGINE, **kw))
    eng.start()
    return eng


def _wait(predicate, timeout_s=30.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# -- migration on engines --------------------------------------------------------
def test_migrated_session_token_equality(weights, golden):
    """A stream exported from engine A mid-generation and landed on B
    through submit_handoff (with its pages) continues token for token: the
    JAX colocated stream, no prefill on B, the client's queue unchanged."""
    a, b = _engine(weights, slow=True), _engine(weights)
    try:
        req = a.submit(PROMPT, max_new_tokens=N, temperature=0.0)
        stream = req.stream(timeout_s=30.0)
        got = [next(stream)]
        exported = []
        a.request_migration(
            lambda r, blobs, n_ctx: exported.append((r, blobs, n_ctx)) or True)
        _wait(lambda: not a.migration_pending, what="the export round")
        assert len(exported) == 1
        xreq, blobs, n_ctx = exported[0]
        assert xreq is req and a.migrations_total == 1
        assert n_ctx == len(req.prompt_tokens) + len(req.emitted) - 1
        assert blobs and len(blobs) == a.allocator.pages_for(n_ctx)
        b.submit_handoff(req.prompt_tokens, list(req.emitted),
                         max_new_tokens=req.max_new_tokens, temperature=0.0,
                         out_queue=req.out_queue, cancelled=req.cancelled,
                         blobs=blobs)
        got.extend(stream)
        assert got == golden
        assert b.prefill_dispatches == b.prefix_dispatches == 0
        assert b.handoff_fallbacks_total == 0
    finally:
        a.stop()
        b.stop()


def test_migration_failure_degrades_to_local_resume(weights, golden):
    """Every peer unreachable: the coordinator resumes the session on the
    draining engine itself (it still admits: migration runs before
    engine.drain), and the client's stream is complete and exact."""
    a = _engine(weights, slow=True)
    try:
        def refuse(address):
            raise OSError(f"connect refused: {address}")

        coord = MigrationCoordinator(a, Lifecycle("serving"),
                                     client_factory=refuse,
                                     ship_timeout_s=5.0)
        req = a.submit(PROMPT, max_new_tokens=N, temperature=0.0)
        stream = req.stream(timeout_s=30.0)
        got = [next(stream)]
        coord.begin_drain(["http://127.0.0.1:9"], timeout_s=20.0)
        got.extend(stream)
        assert got == golden and req.error is None
        _wait(lambda: coord.status()["drained"], what="the drain")
        status = coord.status()
        assert status["outcomes"]["local_resume"] == 1
        assert status["outcomes"]["failed"] == 0
        assert status["lifecycle"]["state"] == "draining"
        [session] = status["sessions"]
        assert session["outcome"] == "local_resume"
        # the resume landed the exported pages: no recompute
        assert a.handoff_fallbacks_total == 0
    finally:
        a.stop()


class _FakeEngine:
    """Just enough engine for the coordinator's units."""

    _lands_handoffs = False
    migrations_total = 0
    migration_pending = False

    def __init__(self):
        self.drain_calls = 0

    def request_migration(self, sink):
        pass

    def drain(self, timeout_s=30.0):
        self.drain_calls += 1
        return True


def test_begin_drain_is_idempotent():
    eng = _FakeEngine()
    lifecycle = Lifecycle("serving")
    coord = MigrationCoordinator(eng, lifecycle)
    first = coord.begin_drain()
    assert first["drain_started"] is True
    assert lifecycle.state == "draining"
    _wait(lambda: coord.status()["drained"], timeout_s=5.0,
          what="a drain with no session")
    assert eng.drain_calls == 1
    second = coord.begin_drain()
    assert second["drain_started"] is True
    time.sleep(0.05)
    assert eng.drain_calls == 1
    assert len(lifecycle.snapshot()["trail"]) == 1
    assert lifecycle.to("serving") is False
    assert lifecycle.state == "draining"


def test_admit_migration_refuses_a_malformed_spec(weights):
    eng = _engine(weights)
    try:
        with pytest.raises(ValueError):
            admit_migration(eng, {"v": 1, "rid": 1})
        with pytest.raises(ValueError):
            admit_migration(eng, {"spec": {"prompt": [1, 2]}})
        spec = dict(prompt=PROMPT, emitted=[1], max_new=N, temp=0.0,
                    stop=[], prio=0, min=0, top_p=0.0, top_k=0)
        with pytest.raises(ValueError, match="outside the vocabulary"):
            admit_migration(eng, {"spec": dict(spec, emitted=[CFG.vocab_size])})
        with pytest.raises(ValueError, match="malformed"):
            admit_migration(eng, {"spec": dict(spec, max_new=float("inf"))})
    finally:
        eng.stop()


# -- two Apps over HTTP -----------------------------------------------------------
def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())["data"]


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="POST",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())["data"]


def _slow_app(weights, env):
    eng = serve.build_engine(env, device="cpu", params=weights[1])
    eng.faults, eng.decode_block_size = _slow_plane(), 1
    app = serve.build_app(env, engine=eng)
    app.start()
    return app


@pytest.mark.parametrize("peer", ["live", "refused"])
def test_drain_ships_live_streams_over_http(weights, golden, peer):
    """POST /debug/drain on A with B as the peer: A's live stream is
    exported, sent to B's POST /migrate and relayed back into the client's
    stream, token for token ("shipped", with the first-token gap); a
    refused peer degrades to "local_resume" with the stream complete. GET
    /debug/drain reports the outcome, B's /debug/kvtier answers."""
    a = _slow_app(weights, BASE)
    b = serve.build_app(BASE, engine=serve.build_engine(
        BASE, device="cpu", params=weights[1]))
    b.start()
    try:
        target = (f"http://127.0.0.1:{b.http_port}" if peer == "live"
                  else "http://127.0.0.1:9")
        req = a.engine.submit(PROMPT, max_new_tokens=N, temperature=0.0)
        stream = req.stream(timeout_s=60.0)
        got = [next(stream)]
        started = _post(a.http_port, "/debug/drain",
                        {"peers": [target], "timeout_s": 20})
        assert started["drain_started"] is True
        got.extend(stream)
        assert got == golden and req.error is None
        _wait(lambda: _get(a.http_port, "/debug/drain")["drained"],
              what="the drain")
        status = _get(a.http_port, "/debug/drain")
        [session] = status["sessions"]
        if peer == "live":
            assert status["outcomes"]["shipped"] == 1
            assert session["peer"] == target and session["gap_s"] >= 0
            assert b.engine.prefill_dispatches == 0
        else:
            assert status["outcomes"]["local_resume"] == 1
        assert status["migrations_total"] == 1
        assert _get(b.http_port, "/debug/kvtier") == {"pages": []}
        assert _get(a.http_port, "/stats")["fleet"]["lifecycle"] == \
            "draining"
    finally:
        a.shutdown()
        b.shutdown()


def _migration_envelope(golden) -> str:
    """A blob-less migration of the golden stream after its third token."""
    from gofr_tpu_torch.tpu.disagg import encode_handoff

    class Req:
        id, prompt_tokens, emitted = 1, PROMPT, golden[:3]
        max_new_tokens, temperature, stop_tokens = N, 0.0, set()
        priority = min_tokens = top_k = 0
        top_p, traceparent, gen_span = 0.0, None, None

    return encode_handoff(Req, None, 7)


def _migrate_tokens(svc, envelope: str):
    resp = svc.request(None, "POST", "/migrate", body=envelope,
                       headers={"Content-Type": "application/json"},
                       stream=True)
    assert resp.status_code == 200
    body = b"".join(resp.iter_chunks()).decode()
    resp.close()
    events = [json.loads(line[5:]) for line in body.splitlines()
              if line.startswith("data:")]
    assert events[-1]["done"] is True
    return [e["t"] for e in events if "t" in e]


def test_migrate_route_streams_token_ids(weights, golden):
    """POST /migrate takes an envelope and answers SSE of raw token ids,
    then done; a torn envelope is a 400."""
    app = serve.build_app(BASE, engine=serve.build_engine(
        BASE, device="cpu", params=weights[1]))
    app.start()
    try:
        svc = HTTPService(f"http://127.0.0.1:{app.http_port}", timeout_s=60)
        assert _migrate_tokens(svc, _migration_envelope(golden)) == golden[3:]
        bad = svc.request(None, "POST", "/migrate", body="{}",
                          headers={"Content-Type": "application/json"})
        assert bad.status_code == 400
    finally:
        app.shutdown()


def test_migrate_route_refuses_a_spec_outside_the_vocabulary(weights, golden):
    """POST /migrate's spec comes raw from the network. A prompt, emitted
    or stop id outside [0, vocab_size) (on the card an id past it fires a
    device-side assert in the embedding gather and loses the context), a
    non-integer id, and top_p, top_k or a temperature out of range are
    each a 400, and the engine goes on serving the next migration."""
    vocab = CFG.vocab_size
    good = json.loads(_migration_envelope(golden))
    app = serve.build_app(BASE, engine=serve.build_engine(
        BASE, device="cpu", params=weights[1]))
    app.start()
    try:
        svc = HTTPService(f"http://127.0.0.1:{app.http_port}", timeout_s=60)
        for patch in ({"prompt": PROMPT[:-1] + [vocab]},
                      {"prompt": [-1] + PROMPT[1:]},
                      {"emitted": golden[:2] + [vocab + 7]},
                      {"stop": [vocab]},
                      {"prompt": [5.5] + PROMPT[1:]},
                      {"prompt": "abc"},
                      {"top_p": 1.5},
                      {"top_k": -1},
                      {"temp": -1.0},
                      {"temp": "hot"}):
            envelope = dict(good, spec=dict(good["spec"], **patch))
            resp = svc.request(None, "POST", "/migrate",
                               body=json.dumps(envelope),
                               headers={"Content-Type": "application/json"})
            assert resp.status_code == 400, patch
        assert app.engine.health_check().status == STATUS_UP
        assert _migrate_tokens(svc, json.dumps(good)) == golden[3:]
    finally:
        app.shutdown()


def test_warm_boot_goes_warming_then_serving_and_prewarms(weights):
    """ELASTIC_WARM_BOOT=true: /stats says warming until the warm-up and
    the pre-warm from the peer's /debug/kvtier are done, then serving with
    warm_boot_s; pages a shared cold store holds are pre-warmed into host
    RAM and the first request over them restores them."""
    store = {}

    class Store:
        def set(self, key, value, ttl_s=None):
            store[key] = str(value)

        def get(self, key):
            return store.get(key)

        def delete(self, key):
            store.pop(key, None)

    # the peer's host tier holds 4 page blobs of the debug pool (4 KiB
    # each), so its spills go on to the shared store
    tier_env = {**BASE, "KV_HOST_TIER_BYTES": str(4 * 4096 + 512),
                "N_PAGES": "10", "MAX_SEQ_LEN": "128",
                "PREFILL_BUCKETS": "8,32,64"}
    system = list(range(1, 33)) + [40, 41]
    peer = serve.build_app(tier_env, engine=serve.build_engine(
        tier_env, device="cpu", params=weights[1],
        kv_cold_store=RedisKVTier(Store(), write_behind=False)))
    peer.start()
    try:
        pe = peer.engine
        want = pe.generate(system, max_new_tokens=6, temperature=0.0)
        trunk = pe.prefix.keys_for(system, 4)
        for i in range(16):   # churn until the trunk went through the store
            if all(f"gofr:kvpage:{k:#x}" in store for k in trunk):
                break
            pe.generate([(100 + 7 * i + j) % 250 + 1 for j in range(17)],
                        max_new_tokens=6, temperature=0.0)
        assert all(f"gofr:kvpage:{k:#x}" in store for k in trunk)
        # a lookup promotes the trunk back into the peer's host tier, so its
        # inventory advertises it (the reference's shared-cold-tier path)
        for i, key in enumerate(trunk):
            assert pe.kv_tier.get(key, system[i * 8:(i + 1) * 8])
        inventory = _get(peer.http_port, "/debug/kvtier")["pages"]
        assert {r["key"] for r in inventory} >= set(trunk)
        # the peer's inventory behind a gate, so /stats is seen warming
        gate = threading.Event()
        peer_url = f"http://127.0.0.1:{peer.http_port}/debug/kvtier"

        class Gated(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                gate.wait(30)
                with urllib.request.urlopen(peer_url, timeout=30) as resp:
                    body = resp.read()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        relay = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Gated)
        threading.Thread(target=relay.serve_forever, daemon=True).start()
        env = {**tier_env, "ELASTIC_WARM_BOOT": "true",
               "KV_HOST_TIER_BYTES": str(1 << 20),
               "ELASTIC_PREWARM_PEERS":
               f"http://127.0.0.1:{relay.server_address[1]}",
               "ELASTIC_PREWARM_PAGES": "64"}
        eng = serve.build_engine(
            env, device="cpu", params=weights[1],
            kv_cold_store=RedisKVTier(Store(), write_behind=False))
        app = serve.build_app(env, engine=eng)
        app.start()
        try:
            stats = _get(app.http_port, "/stats")
            assert stats["fleet"]["lifecycle"] == "warming"
            assert "warm_boot_s" not in stats["fleet"]
            gate.set()
            _wait(lambda: _get(app.http_port, "/stats")["fleet"]
                  ["lifecycle"] == "serving", what="serving")
            stats = _get(app.http_port, "/stats")
            assert stats["fleet"]["warm_boot_s"] >= 0
            assert eng.prewarmed_pages >= len(trunk)
            assert stats["kv_tier"]["pages"] == eng.prewarmed_pages
            restored = eng._kv_restored
            assert eng.generate(system, max_new_tokens=6,
                                temperature=0.0) == want
            assert eng._kv_restored > restored
            assert eng.kv_tier.stats()["hits"] > 0
        finally:
            gate.set()
            app.shutdown()
            relay.shutdown()
    finally:
        peer.shutdown()


# -- the stdlib peer client ----------------------------------------------------------
class _Handler(http.server.BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_GET(self):
        if self.path.startswith("/fail"):
            self.send_response(500)
            self.end_headers()
            return
        body = json.dumps({"path": self.path,
                           "hdr": self.headers.get("X-Test")}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(n)
        self.send_response(200)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        for part in (data, b"|", data):
            self.wfile.write(b"%x\r\n%s\r\n" % (len(part), part))
            self.wfile.flush()
        self.wfile.write(b"0\r\n\r\n")


def test_http_service_buffered_streamed_and_breaker():
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    address = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        svc = new_http_service(address, None, None,
                               DefaultHeaders(**{"X-Test": "yes"}))
        resp = svc.get(None, "/x", params={"a": "1"})
        assert resp.status_code == 200
        assert resp.json() == {"path": "/x?a=1", "hdr": "yes"}
        assert resp.header("content-type") == "application/json"
        streamed = svc.request(None, "POST", "/s", body={"k": 1},
                               stream=True)
        chunks = list(streamed.iter_chunks())
        streamed.close()
        assert b"".join(chunks) == b'{"k": 1}|{"k": 1}'
        assert svc.health_check().status == STATUS_UP
        breaker = CircuitBreakerConfig(threshold=1, interval_s=60).apply(
            HTTPService("http://127.0.0.1:9", timeout_s=0.5))
        for _ in range(2):
            with pytest.raises(OSError):
                breaker.get(None, "/")
        with pytest.raises(CircuitOpenError):
            breaker.get(None, "/")
        assert breaker.health_check().status == STATUS_DOWN
    finally:
        server.shutdown()
