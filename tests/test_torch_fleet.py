"""The port's fleet tier (gofr_tpu_torch/fleet, serve_router.py) against the
reference's (gofr_tpu/fleet, examples/router).

The twins of tests/test_fleet.py (affinity stickiness, spillover, ejection
and probe-back, the retry discipline, pass-through streams, traceparent,
/debug/fleet, the health contributor, the 503, the service client's
breaker, the units), of tests/test_journey.py's router half (assembly, a
retried journey, the stream_break terminal, the fleet SLO rollup and the
hidden-burn incident, and the disaggregated replica's trace continuity), of
tests/test_timeline.py's fleet half (stitch, align, router events and the
disaggregated replica's stitched trace) and of tests/test_meter.py's fleet
rollup (``replicas_needed``, ``GET /debug/fleet/capacity`` over 2
replicas). Stub replicas are the port's Apps with no engine, speaking the
llm-server's dialect; the router under test is ``serve_router.build_app``;
the e2e tests boot the port's replicas (``serve.build_app``, the debug
preset on the CPU).

Where both packages answer the same question they are compared on the same
inputs: ``make_policy``'s picks for one seed over one set of replica
states, ``FleetCapacity.rollup`` and ``FleetBurnEngine`` on the same
payloads and events, ``router_events`` / ``align_replica`` /
``stitch_payloads`` on the same journeys and timelines, and a router trace
written by either package read by the other. On the wire, both ways: the
reference router over two port replicas, and the port's router over the
reference's llm-server and a port replica holding its weights; greedy
streams through either replica equal the JAX engine's.
"""

import importlib.util
import json
import pathlib
import re
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from gofr_tpu_torch import serve_router
from gofr_tpu_torch.app import App, Stream
from gofr_tpu_torch.config import MockConfig
from gofr_tpu_torch.datasource import STATUS_DOWN, STATUS_UP, Health
from gofr_tpu_torch.fleet.affinity import (AffinityMap, AffinityRecorder,
                                           affinity_keys)
from gofr_tpu_torch.fleet.capacity import FleetCapacity
from gofr_tpu_torch.fleet.journey import JourneyRecorder
from gofr_tpu_torch.fleet.policy import (AffinityPolicy, P2CPolicy,
                                         RoundRobinPolicy, make_policy)
from gofr_tpu_torch.fleet.registry import FleetRegistry, Replica
from gofr_tpu_torch.fleet.slo import FleetSLO
from gofr_tpu_torch.fleet.timeline import (align_replica, router_events,
                                           stitch_payloads)
from gofr_tpu_torch.http.errors import HTTPError, ServiceUnavailable
from gofr_tpu_torch.service import (CircuitBreakerConfig, CircuitOpenError,
                                    HTTPService, new_http_service)
from gofr_tpu_torch.tpu.journey import is_trace_id, order_hops

from _torch_env import INCIDENT_DIR

pytestmark = pytest.mark.fleet

ROOT = pathlib.Path(__file__).resolve().parents[1]
QUIET = {"HTTP_PORT": "0", "METRICS_PORT": "0", "REQUEST_TIMEOUT": "30",
         "GRPC_PORT": "0",
         "LOG_LEVEL": "ERROR", "HOSTPROF": "false"}


def _load(example, alias):
    path = ROOT / "examples" / example / "main.py"
    spec = importlib.util.spec_from_file_location(alias, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _trace_of(traceparent):
    parts = (traceparent or "").split("-")
    return parts[1] if len(parts) == 4 else None


def _get_json(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())["data"]


def _sse(base, body, headers=None, timeout=60):
    """(status, events) of a POST /generate; an HTTP error's status and
    decoded body, and its headers, otherwise."""
    req = urllib.request.Request(
        base + "/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    events = []
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status = resp.status
            for line in resp:
                line = line.strip()
                if line.startswith(b"data: "):
                    events.append(json.loads(line[6:]))
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode() or "null"), dict(
            err.headers)
    return status, events, {}


class StubReplica:
    """An llm-server-shaped port App with no engine: SSE /generate, /stats
    with the fleet digest, /debug/slo, /debug/journey/{id} with hops made
    for every trace it served, and a health contributor named "engine"."""

    def __init__(self, name, tokens=3):
        self.name = name
        self.tokens = tokens
        self.state = {
            "status": STATUS_UP, "queue_depth": 0, "shed": False,
            "retry_after": 2, "generation": f"{name}-gen1", "digest": [],
            "die_after": None, "gate": None,
        }
        self.served = []
        self.traceparents = []
        self.journeys = {}
        app = App({**QUIET, "APP_NAME": name})
        st = self.state

        app.add_health_contributor(
            "engine", lambda: Health(status=st["status"], details={}))

        @app.post("/generate")
        def generate(ctx):
            body = ctx.bind()
            self.traceparents.append(ctx.request.traceparent)
            if st["shed"]:
                raise ServiceUnavailable("replica shedding",
                                         retry_after_s=st["retry_after"])
            self.served.append(body.get("prompt"))
            trace_id = _trace_of(ctx.request.traceparent)
            if trace_id:
                t = time.time()
                rid = len(self.served)
                hops = [{"hop": hop, "actor": "engine:serve",
                         "t_start": t + i * 0.001,
                         "t_end": t + (i + 1) * 0.001,
                         "duration_s": 0.001, "request_id": rid}
                        for i, hop in enumerate(("queue", "prefill",
                                                 "decode", "finish"))]
                self.journeys[trace_id] = {
                    "trace_id": trace_id, "source": "replica", "hops": hops,
                    "requests": [{"id": rid, "trace_id": trace_id}]}
            die_after, gate = st["die_after"], st["gate"]
            n = self.tokens

            def chunks():
                for i in range(n):
                    if die_after is not None and i >= die_after:
                        raise RuntimeError("stub replica died mid-stream")
                    yield {"text": f"{self.name}-t{i}"}
                    if gate is not None and i == 0:
                        # (release, ended): hold the stream open after the
                        # first token until released
                        gate[0].wait(5.0)
                yield {"done": True, "tokens": n}
                if gate is not None:
                    gate[1].set()

            return Stream(chunks(), sse=True)

        @app.get("/stats")
        def stats(ctx):  # noqa: ARG001
            return {
                "queue_depth": st["queue_depth"], "active_slots": 0,
                "fleet": {"duty_cycle": 0.25,
                          "affinity": {"block": 8,
                                       "generation": st["generation"],
                                       "keys": list(st["digest"])}},
            }

        @app.get("/debug/slo")
        def slo(ctx):  # noqa: ARG001
            return {"slos": {"ttft": {
                "state": "ok",
                "windows": {"fast": {"burn_rate": 0.1},
                            "slow": {"burn_rate": 0.1}}}}}

        @app.get("/debug/journey/{id}")
        def journey(ctx):
            raw = ctx.request.path_param("id")
            payload = self.journeys.get(raw)
            if payload is None:
                raise HTTPError(f"no journey for {raw!r}", status_code=404)
            return payload

        self.app = app

    def start(self):
        self.app.start()
        self.url = f"http://127.0.0.1:{self.app.http_port}"
        return self

    def stop(self):
        self.app.shutdown()


class Harness:
    """N stub replicas behind the port's router (serve_router.build_app)."""

    def __init__(self, n=2, **cfg):
        self.replicas = [StubReplica(f"r{i}").start() for i in range(n)]
        values = {
            **QUIET, "APP_NAME": "router",
            "FLEET_REPLICAS": ",".join(f"{r.name}={r.url}"
                                       for r in self.replicas),
            "FLEET_PROBE_S": "0.2", "FLEET_AFFINITY_BLOCK": "8",
            "FLEET_BREAKER_INTERVAL_S": "0.3", "FLEET_RETRY_BUDGET": "2",
            "INCIDENT_DIR": INCIDENT_DIR,
        }
        values.update({k: str(v) for k, v in cfg.items()})
        self.app = serve_router.build_app(values)
        self.app.start()
        self.port = self.app.http_port
        self.base = f"http://127.0.0.1:{self.port}"

    def replica(self, name):
        return next(r for r in self.replicas if r.name == name)

    def served_by(self, prompt):
        return [r.name for r in self.replicas if prompt in r.served]

    def generate(self, prompt, headers=None, timeout=10):
        return _sse(self.base, {"prompt": prompt, "stream": True}, headers,
                    timeout)

    def debug_fleet(self):
        return _get_json(self.base + "/debug/fleet")

    def journey_index(self):
        return _get_json(self.base + "/debug/journey")

    def journey(self, raw_id):
        return _get_json(self.base + f"/debug/journey/{raw_id}")

    def wait_probe(self, predicate, timeout=5.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            snap = self.debug_fleet()
            if predicate(snap):
                return snap
            time.sleep(0.1)
        raise AssertionError(
            f"probe condition not reached: {self.debug_fleet()}")

    def close(self):
        self.app.shutdown()
        for r in self.replicas:
            r.stop()


@pytest.fixture()
def fleet():
    harnesses = []

    def build(n=2, **cfg):
        h = Harness(n=n, **cfg)
        harnesses.append(h)
        return h

    yield build
    for h in harnesses:
        h.close()


def test_exports_equal_the_reference():
    import gofr_tpu.fleet as jfleet
    import gofr_tpu_torch.fleet as tfleet

    assert tfleet.__all__ == jfleet.__all__
    for name in tfleet.__all__:
        assert hasattr(tfleet, name), name


# -- routing behaviour (tests/test_fleet.py) ----------------------------------
def test_affinity_same_session_sticks_to_one_replica(fleet):
    h = fleet(n=2)
    prompt = "session-alpha: the quick brown fox jumps over the lazy dog"
    for _ in range(4):
        status, events, _ = h.generate(prompt)
        assert status == 200
        assert events[-1].get("done") is True
    names = h.served_by(prompt)
    assert len(names) == 1, f"session bounced across {names}"
    assert len(h.replica(names[0]).served) == 4
    snap = h.debug_fleet()
    assert snap["affinity"]["hits"] >= 3
    assert snap["affinity"]["hit_rate"] > 0.5


def test_saturated_preferred_replica_spills_by_queue_depth(fleet):
    h = fleet(n=2, FLEET_SPILL_DEPTH=4)
    prompt = "session-beta: shared prefix that should pin to one replica"
    status, _, _ = h.generate(prompt)
    assert status == 200
    [preferred] = h.served_by(prompt)
    other = next(r.name for r in h.replicas if r.name != preferred)
    h.replica(preferred).state["queue_depth"] = 50
    h.wait_probe(lambda s: any(r["name"] == preferred
                               and r["queue_depth"] == 50
                               for r in s["replicas"]))
    status, _, _ = h.generate(prompt)
    assert status == 200
    assert h.replica(other).served == [prompt]
    assert h.debug_fleet()["routes"].get("spill", 0) >= 1


def test_down_replica_ejected_then_probed_back_in(fleet):
    h = fleet(n=2)
    sick = h.replicas[0]
    sick.state["status"] = STATUS_DOWN
    snap = h.wait_probe(lambda s: any(r["name"] == sick.name
                                      and r["state"] == "DOWN"
                                      and not r["available"]
                                      for r in s["replicas"]))
    assert snap["available"] == 1
    for i in range(3):
        status, events, _ = h.generate(f"while-down prompt {i}")
        assert status == 200 and events[-1].get("done") is True
    assert sick.served == []
    sick.state["status"] = STATUS_UP
    h.wait_probe(lambda s: all(r["available"] for r in s["replicas"]))


def test_shed_replica_retried_unstarted_and_retry_after_honored(fleet):
    h = fleet(n=2, FLEET_POLICY="round_robin")
    shedder = h.replicas[0]
    shedder.state["shed"] = True
    shedder.state["retry_after"] = 2
    for i in range(4):
        status, events, _ = h.generate(f"shed-phase prompt {i}")
        assert status == 200 and events[-1].get("done") is True
    assert shedder.served == []
    assert h.debug_fleet()["retries"].get("shed", 0) >= 1
    # the shed window holds after the replica stops shedding
    shedder.state["shed"] = False
    status, _, _ = h.generate("still-in-window prompt")
    assert status == 200
    assert shedder.served == []
    time.sleep(2.2)
    for i in range(6):
        h.generate(f"after-window prompt {i}")
    assert len(shedder.served) >= 1


def test_midstream_death_never_double_sends_and_unstarted_requests_survive(
        fleet):
    h = fleet(n=2)
    prompt = "session-gamma: stream that will be cut down mid-flight"
    status, _, _ = h.generate(prompt)
    assert status == 200
    [victim_name] = h.served_by(prompt)
    victim = h.replica(victim_name)
    survivor = next(r for r in h.replicas if r.name != victim_name)
    victim.state["die_after"] = 1
    status, events, _ = h.generate(prompt)
    # started: the tokens that made it out and a terminal error event, and
    # the request never replayed elsewhere
    assert status == 200
    assert any("error" in e for e in events)
    assert not any(e.get("done") for e in events)
    assert victim.served.count(prompt) == 2
    assert survivor.served.count(prompt) == 0
    assert h.debug_fleet()["stream_breaks"] >= 1
    # the victim gone: unstarted requests go on through connect-error
    # retries and the probe's ejection
    victim.stop()
    for i in range(4):
        status, events, _ = h.generate(f"post-kill prompt {i}")
        assert status == 200 and events[-1].get("done") is True
    h.wait_probe(lambda s: any(r["name"] == victim_name and not r["available"]
                               for r in s["replicas"]))
    h.replicas.remove(victim)


def test_traceparent_spans_router_to_replica(fleet):
    h = fleet(n=1)
    trace_id = "0af7651916cd43dd8448eb211c80319c"
    span_id = "b7ad6b7169203331"
    status, _, _ = h.generate("trace me please",
                              headers={"traceparent":
                                       f"00-{trace_id}-{span_id}-01"})
    assert status == 200
    received = h.replicas[0].traceparents[-1]
    assert received is not None
    parts = received.split("-")
    assert parts[1] == trace_id, "the trace id must span router -> replica"
    assert parts[2] != span_id, "the replica must see a child span"


def test_debug_fleet_snapshot_e2e(fleet):
    h = fleet(n=2)
    h.generate("snapshot session prompt one")
    h.generate("snapshot session prompt one")
    snap = h.debug_fleet()
    assert snap["policy"] == "affinity"
    assert snap["routes_total"] == 2
    assert {r["name"] for r in snap["replicas"]} == {"r0", "r1"}
    for row in snap["replicas"]:
        assert {"state", "available", "breaker_open", "queue_depth",
                "inflight", "load", "affinity_entries",
                "stream_breaks"} <= set(row)
    assert snap["affinity"]["map_size"] >= 1
    assert snap["available"] == 2


def test_router_health_contributor_follows_fleet(fleet):
    h = fleet(n=2)
    body = _get_json(h.base + "/.well-known/health")
    assert body["details"]["fleet"]["status"] == STATUS_UP
    for r in h.replicas:
        r.state["status"] = STATUS_DOWN
    h.wait_probe(lambda s: s["available"] == 0)
    body = _get_json(h.base + "/.well-known/health")
    assert body["details"]["fleet"]["status"] == STATUS_DOWN


def test_no_replica_available_returns_503_with_retry_after(fleet):
    h = fleet(n=2)
    for r in h.replicas:
        r.state["status"] = STATUS_DOWN
    h.wait_probe(lambda s: s["available"] == 0)
    status, body, headers = h.generate("nowhere to go")
    assert status == 503
    assert "error" in body
    assert int(headers.get("Retry-After", 0)) >= 1


# -- the service client's breaker paths the router leans on -------------------
def test_circuit_breaker_open_probe_close_cycle():
    port = _free_port()
    svc = new_http_service(f"http://127.0.0.1:{port}", None, None,
                           CircuitBreakerConfig(threshold=1, interval_s=0.2))
    for _ in range(2):
        with pytest.raises(Exception):
            svc.get(None, "/stats")
    assert svc.open is True
    with pytest.raises(CircuitOpenError):
        svc.get(None, "/stats")
    # the replica comes back on the same address: the breaker's prober
    # closes the circuit with no caller's help
    app = App({**QUIET, "HTTP_PORT": str(port), "APP_NAME": "revived"})

    @app.get("/stats")
    def stats(ctx):  # noqa: ARG001
        return {"ok": True}

    app.start()
    try:
        deadline = time.time() + 5
        while svc.open and time.time() < deadline:
            time.sleep(0.1)
        assert svc.open is False, "the prober never closed the breaker"
        assert svc.get(None, "/stats").status_code == 200
    finally:
        app.shutdown()
        svc.close()


def test_http_service_health_check_down_when_unreachable():
    svc = HTTPService(f"http://127.0.0.1:{_free_port()}", timeout_s=0.5)
    assert svc.health_check().status == STATUS_DOWN


def test_http_service_streaming_response_passthrough():
    app = App({**QUIET, "APP_NAME": "sse"})

    @app.post("/gen")
    def gen(ctx):  # noqa: ARG001
        return Stream(iter([{"text": "a"}, {"done": True}]), sse=True)

    app.start()
    try:
        svc = HTTPService(f"http://127.0.0.1:{app.http_port}", timeout_s=5)
        resp = svc.request(None, "POST", "/gen", body={"x": 1}, stream=True)
        assert resp.status_code == 200
        assert "text/event-stream" in (resp.header("Content-Type") or "")
        assert resp.body == b""
        payload = b"".join(resp.iter_chunks())
        assert b'data: {"text": "a"}' in payload
        assert b'"done": true' in payload
        resp.close()
    finally:
        app.shutdown()


def test_sse_relay_is_per_chunk_not_buffered(fleet):
    """The first token event reaches the client through the router while
    the replica still holds its stream open (a relay that buffered would
    deliver it only after the replica's stream ended)."""
    h = fleet(n=1)
    stub = h.replicas[0]
    gate, ended = threading.Event(), threading.Event()
    stub.state["gate"] = (gate, ended)
    seen_open = []
    req = urllib.request.Request(
        h.base + "/generate",
        data=json.dumps({"prompt": "gated", "stream": True}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    events = []
    with urllib.request.urlopen(req, timeout=20) as resp:
        for line in resp:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            events.append(json.loads(line[6:]))
            if len(events) == 1:
                seen_open.append(not ended.is_set())
                gate.set()
    assert seen_open == [True]
    assert events[0] == {"text": "r0-t0"} and events[-1]["done"] is True


# -- fast units ---------------------------------------------------------------
def test_affinity_keys_stable_and_cumulative():
    assert affinity_keys("") == []
    short = affinity_keys("abcd", block=8)
    assert len(short) == 1
    long = affinity_keys("abcdefgh" * 3, block=8)
    assert len(long) == 3
    assert long[0] != short[0]
    assert affinity_keys("abcdefgh" * 3, block=8) == long
    assert (affinity_keys("abcdefghXXXX", block=8)[0]
            == affinity_keys("abcdefghYYYY", block=8)[0])


def test_affinity_map_learn_lookup_forget_and_digest_warmup():
    amap = AffinityMap(capacity=8)
    keys = affinity_keys("abcdefgh" * 2, block=8)
    amap.learn(keys, "r0")
    assert amap.lookup(keys) == ("r0", keys[-1])
    amap.merge_digest("r1", keys)
    assert amap.lookup(keys)[0] == "r0"
    recorder = AffinityRecorder(block=8)
    recorder.record("zyxwvuts" * 2)
    fresh = AffinityMap()
    fresh.merge_digest("r1", recorder.digest()["keys"])
    assert fresh.lookup(affinity_keys("zyxwvuts" * 2, block=8))[0] == "r1"
    assert amap.forget("r0") == len(keys)
    assert amap.lookup(keys) == (None, None)


class _FakeReplica:
    def __init__(self, name, load):
        self.name = name
        self._load = load

    def load(self):
        return self._load


def test_policy_units():
    a, b = _FakeReplica("a", 1), _FakeReplica("b", 5)
    amap = AffinityMap()
    rr = RoundRobinPolicy()
    picks = [rr.choose([a, b], [], amap)[0].name for _ in range(4)]
    assert picks == ["a", "b", "a", "b"]
    p2c = P2CPolicy(seed=7)
    for _ in range(8):
        replica, reason = p2c.choose([a, b], [], amap)
        assert replica.name == "a" and reason == "p2c"
    pol = AffinityPolicy(spill_depth=4)
    keys = affinity_keys("abcdefgh", block=8)
    assert pol.choose([a, b], keys, amap)[1] == "miss"
    amap.learn(keys, "b")
    replica, reason = pol.choose([a, b], keys, amap)
    assert (replica.name, reason) == ("a", "spill")
    b._load = 2
    replica, reason = pol.choose([a, b], keys, amap)
    assert (replica.name, reason) == ("b", "affinity")
    amap.learn(keys, "gone")
    assert pol.choose([a, b], keys, amap)[1] == "failover"
    assert make_policy("round_robin").name == "round_robin"
    with pytest.raises(ValueError):
        make_policy("nonsense")


def test_registry_from_config_parses_named_and_bare_urls():
    config = MockConfig({
        "FLEET_REPLICAS":
            "alpha=http://h0:8000, http://h1:8000 ,beta=http://h2:9000",
        "FLEET_PROBE_S": "0.7"})
    registry = FleetRegistry.from_config(config)
    assert [(r.name, r.address) for r in registry.replicas] == [
        ("alpha", "http://h0:8000"), ("r1", "http://h1:8000"),
        ("beta", "http://h2:9000")]
    assert registry.probe_s == 0.7
    with pytest.raises(ValueError):
        FleetRegistry.from_config(MockConfig({}))


def test_replica_shed_window_and_load_accounting():
    replica = Replica("r0", "http://127.0.0.1:1")
    assert replica.load() == 0
    replica.begin()
    replica.queue_depth = 3
    assert replica.load() == 4
    replica.end()
    assert replica.load() == 3
    replica.state = STATUS_UP
    assert replica.available()
    replica.note_shed(0.3)
    assert not replica.available()
    time.sleep(0.35)
    assert replica.available()


# -- the router's journey and the fleet SLO (tests/test_journey.py) -----------
def _wait_finished(h, n, timeout=5.0):
    """The router finishes a journey after the client drains the stream
    (the pass-through's close hook): poll the index until the count lands."""
    deadline = time.monotonic() + timeout
    while True:
        index = h.journey_index()
        if index["finished_total"] >= n:
            return index
        assert time.monotonic() < deadline, (
            f"journey index stuck at {index['finished_total']}/{n}")
        time.sleep(0.02)


def _assert_causal(hops):
    starts = [h["t_start"] for h in hops]
    assert starts == sorted(starts)
    assert hops == order_hops(hops)


def test_journey_assembly_e2e(fleet):
    h = fleet(n=2)
    status, events, _ = h.generate("assembly prompt one")
    assert status == 200 and events[-1].get("done") is True
    row = _wait_finished(h, 1)["recent"][0]
    assert row["outcome"] == "ok"
    assert is_trace_id(row["trace_id"])
    assert row["chunks"] >= 1 and row["ttfb_s"] >= 0.0
    assembled = h.journey(row["id"])
    assert assembled["complete"] is True and assembled["missing"] == []
    assert assembled["trace_id"] == row["trace_id"]
    names = [hop["hop"] for hop in assembled["hops"]]
    for hop in ("route", "queue", "prefill", "decode", "stream", "finish"):
        assert hop in names, f"missing {hop} in {names}"
    _assert_causal(assembled["hops"])
    served = row["replica"]
    assert {hop["actor"] for hop in assembled["hops"]
            if hop["actor"] != "router"} == {f"{served}:engine:serve"}
    for rec in assembled["replicas"][served]["requests"]:
        assert rec["trace_id"] == assembled["trace_id"]
    assert h.journey(row["trace_id"])["journey_id"] == assembled["journey_id"]


def test_retry_after_failover_shows_both_attempts(fleet):
    h = fleet(n=2, FLEET_POLICY="round_robin")
    h.replicas[0].state["shed"] = True
    for i in range(2):
        status, events, _ = h.generate(f"failover prompt {i}")
        assert status == 200 and events[-1].get("done") is True
    index = _wait_finished(h, 2)
    retried = [r for r in index["recent"]
               if len(r["attempts"]) >= 2 and r["outcome"] == "ok"]
    assert retried, f"no retried journey in {index['recent']}"
    row = retried[0]
    outcomes = [a["outcome"] for a in row["attempts"]]
    assert outcomes[0] == "shed" and outcomes[-1] == "committed"
    assert row["attempts"][0]["replica"] != row["attempts"][-1]["replica"]
    assembled = h.journey(row["id"])
    assert assembled["complete"] is True
    assert [hop["outcome"] for hop in assembled["hops"]
            if hop["hop"] == "route"] == outcomes
    _assert_causal(assembled["hops"])


def test_midstream_kill_yields_stream_break_terminal_hop(fleet):
    h = fleet(n=1)
    h.replicas[0].state["die_after"] = 1
    status, events, _ = h.generate("doomed stream prompt")
    assert status == 200
    assert any("error" in e for e in events)
    row = _wait_finished(h, 1)["recent"][0]
    assert row["outcome"] == "stream_break"
    assembled = h.journey(row["id"])
    terminal = [hop for hop in assembled["hops"]
                if hop["actor"] == "router"][-1]
    assert terminal["hop"] == "stream_break"
    assert terminal["outcome"] == "stream_break" and terminal.get("error")
    assert any(hop["hop"] == "stream" for hop in assembled["hops"])
    _assert_causal(assembled["hops"])


def test_unknown_journey_id_is_404(fleet):
    h = fleet(n=1)
    with pytest.raises(urllib.error.HTTPError) as err:
        h.journey("999999")
    assert err.value.code == 404


def test_fleet_slo_rollup_endpoint_e2e(fleet):
    h = fleet(n=2)
    for i in range(3):
        status, events, _ = h.generate(f"slo prompt {i}")
        assert status == 200 and events[-1].get("done") is True
    _wait_finished(h, 3)
    snap = _get_json(h.base + "/debug/fleet/slo")
    assert set(snap["fleet_states"]) == {"ttft", "tpot", "availability"}
    assert snap["replicas"]["r0"]["ttft"]["state"] == "ok"
    assert snap["replicas_paging"] == [] and snap["hidden_pages"] == 0
    assert snap["classes"]["unclassified"]["goodput"] == 1.0
    own = _get_json(h.base + "/debug/slo")
    assert set(own["slos"]) == {"ttft", "tpot", "availability"}


class _Incidents:
    def __init__(self):
        self.triggered = []

    def trigger(self, kind, **ctx):
        self.triggered.append((kind, ctx))


SLO_CFG = {"FLEET_SLO_MIN_EVENTS": "1", "FLEET_SLO_PAGE_BURN": "1.0",
           "FLEET_SLO_WARN_BURN": "0.5", "FLEET_SLO_FAST_WINDOW_S": "60",
           "FLEET_SLO_SLOW_WINDOW_S": "60"}


def _fleet_slo(states_fn, incidents, clock, pkg_slo=FleetSLO,
               config_cls=MockConfig):
    slo = pkg_slo.from_config(config_cls(SLO_CFG), incidents=incidents,
                              clock=lambda: clock[0])
    slo._replica_states_fn = states_fn
    return slo


def _broken_journey(recorder):
    rec = recorder.begin(None, "interactive", None)
    recorder.finish(rec, "stream_break", error="upstream died")
    return rec


def test_fleet_burn_page_while_replicas_quiet_triggers_incident():
    clock = [100.0]
    incidents = _Incidents()
    slo = _fleet_slo(lambda: {"r0": {"ttft": "ok", "availability": "ok"}},
                     incidents, clock)
    recorder = JourneyRecorder(capacity=8, slo=slo)
    for _ in range(3):
        clock[0] += 1.0
        _broken_journey(recorder)
    assert slo.hidden_pages >= 1
    assert "fleet_burn_hidden" in [kind for kind, _ in incidents.triggered]
    _, ctx = incidents.triggered[0]
    assert ctx["slo"] == "availability"
    assert ctx["replica_states"]["r0"]["availability"] == "ok"
    assert slo.class_goodput()["interactive"]["goodput"] == 0.0
    assert slo.rollup()["hidden_pages"] == slo.hidden_pages


def test_fleet_burn_page_not_hidden_when_a_replica_pages_too():
    clock = [100.0]
    incidents = _Incidents()
    slo = _fleet_slo(lambda: {"r0": {"availability": "page"}},
                     incidents, clock)
    recorder = JourneyRecorder(capacity=8, slo=slo)
    for _ in range(3):
        clock[0] += 1.0
        _broken_journey(recorder)
    assert slo.hidden_pages == 0
    assert incidents.triggered == []


def test_journey_recorder_finish_is_idempotent():
    recorder = JourneyRecorder(capacity=4)
    rec = recorder.begin("0" * 32, None, None)
    recorder.attempt(rec, "r0", "affinity")
    recorder.committed(rec, "r0", 200)
    recorder.first_chunk(rec)
    recorder.chunk(rec)
    recorder.finish(rec, "stream_break", error="died")
    recorder.finish(rec, "ok")
    assert rec.outcome == "stream_break"
    assert recorder.finished_total == 1
    assert [h["hop"] for h in rec.router_hops()] == [
        "route", "stream", "stream_break"]
    for _ in range(8):
        recorder.finish(recorder.begin(None, None, None), "ok")
    assert len(recorder.snapshot()["recent"]) == 4


# -- fleet stitching (tests/test_timeline.py) ---------------------------------
def _replica_payload(trace_id, wall0=1000.0, mono0=100.0):
    """A minimal /debug/timeline payload: a step slice and a request flow
    in the monotonic-us domain, with the anchor pair."""
    def ev(ph, ts_mono, **extra):
        base = {"ph": ph, "pid": 1, "tid": 1, "ts": ts_mono * 1e6}
        base.update(extra)
        return base

    return {
        "anchor": {"wall0": wall0, "mono0": mono0},
        "traceEvents": [
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
             "ts": 0, "args": {"name": "llm-server"}},
            ev("B", 100.5, name="step:decode", cat="step",
               args={"wall_s": 0.1}),
            ev("E", 100.6),
            ev("s", 100.45, cat="flow", id=trace_id, name="request",
               args={"milestone": "enqueued"}),
            ev("t", 100.5, cat="flow", id=trace_id, name="request",
               args={"milestone": "admitted"}),
            ev("f", 100.62, cat="flow", id=trace_id, name="request",
               bp="e", args={"milestone": "finished"}),
        ],
    }


def _journey(trace_id):
    summary = {"id": 7, "trace_id": trace_id, "outcome": "ok"}
    hops = [
        {"hop": "route", "actor": "router", "t_start": 1000.40,
         "t_end": 1000.41, "replica": "r0", "outcome": "committed"},
        {"hop": "stream", "actor": "router", "t_start": 1000.45,
         "t_end": 1000.70, "chunks": 3},
        {"hop": "finish", "actor": "router", "t_start": 1000.70,
         "t_end": 1000.70, "outcome": "ok"},
    ]
    return summary, hops


def _flow_chains(events):
    chains = {}
    for ev in events:
        if ev.get("cat") == "flow":
            chains.setdefault(ev.get("id"), []).append(ev)
    for chain in chains.values():
        chain.sort(key=lambda e: e["ts"])
    return chains


def _assert_contract(events):
    """Per track: duration events time-ordered, B/E balanced; every flow
    one chain: one s first, t between, at most one f."""
    tracks = {}
    for ev in events:
        if ev.get("ph") != "M":
            tracks.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    for key, track in tracks.items():
        depth, last_ts = 0, None
        for ev in track:
            if ev["ph"] not in ("B", "E", "X"):
                continue
            if last_ts is not None:
                assert ev["ts"] >= last_ts - 1e-6, (key, ev)
            last_ts = ev["ts"]
            depth += {"B": 1, "E": -1}.get(ev["ph"], 0)
            assert depth >= 0, (key, ev)
        assert depth == 0, key
    for fid, chain in _flow_chains(events).items():
        phases = [ev["ph"] for ev in chain]
        assert phases.count("s") == 1 and phases[0] == "s", (fid, phases)
        assert phases.count("f") <= 1, (fid, phases)
        assert all(ph == "t" for ph in phases[1:-1]), (fid, phases)


def test_stitch_aligns_clocks_and_joins_flows_across_pids():
    trace_id = "ab" * 16
    summary, hops = _journey(trace_id)
    stitched = stitch_payloads({"r0": _replica_payload(trace_id)},
                               journey=summary, hops=hops,
                               trace_id=trace_id)
    assert stitched["complete"] is True and stitched["missing"] == []
    assert stitched["pids"] == {"r0": 2}
    assert stitched["clock_domain"] == "wall_us"
    events = stitched["traceEvents"]
    _assert_contract(events)
    step = next(ev for ev in events if ev.get("cat") == "step")
    assert step["pid"] == 2
    assert step["ts"] == pytest.approx(1000.5e6, abs=1e3)
    meta = next(ev for ev in events if ev.get("ph") == "M"
                and ev["pid"] == 2 and ev["name"] == "process_name")
    assert meta["args"]["name"] == "r0" and meta["ts"] == 0
    chain = _flow_chains(events)[trace_id]
    assert {ev["pid"] for ev in chain} == {1, 2}
    phases = [ev["ph"] for ev in chain]
    assert phases[0] == "s" and phases[-1] == "f"
    assert phases.count("s") == 1 and phases.count("f") == 1
    assert chain[0]["pid"] == 1


def test_stitch_degrades_anchorless_replica_to_missing():
    trace_id = "cd" * 16
    summary, hops = _journey(trace_id)
    bad = _replica_payload(trace_id)
    del bad["anchor"]
    stitched = stitch_payloads(
        {"r0": _replica_payload(trace_id), "r1": bad},
        journey=summary, hops=hops, trace_id=trace_id)
    assert stitched["missing"] == ["r1"]
    assert stitched["complete"] is False
    assert stitched["pids"] == {"r0": 2}
    assert all(ev["pid"] != 3 for ev in stitched["traceEvents"])


def test_align_replica_requires_the_anchor_pair():
    events, ok = align_replica({"traceEvents": [{"ph": "X", "ts": 1}]},
                               pid=5, name="r9")
    assert ok is False and events == []


def test_router_events_mark_terminal_hop_finished():
    summary, hops = _journey("ef" * 16)
    events = router_events(summary, hops)
    flows = [ev for ev in events if ev.get("cat") == "flow"]
    assert [ev["args"]["milestone"] for ev in flows] == ["route", "finished"]
    assert [ev["name"] for ev in events if ev["ph"] == "X"] == [
        "route", "stream", "finish"]


# -- the fleet capacity rollup (tests/test_meter.py) --------------------------
def _replica_snap(lam, mu, tenants, collapse=False):
    return {
        "forecast": {"lambda_rps": lam / 500.0, "lambda_tok_s": lam,
                     "mu_tok_s": mu, "rho": (lam / mu) if mu else None,
                     "headroom_tok_s": max(0.0, mu - lam),
                     "predicted_ttft_ms": 140.0, "queue_depth": 3,
                     "collapse_warning": collapse},
        "totals": {"device_s": 10.0},
        "tenants": [{"tenant": name, "device_s": d, "flops": d * 1e9,
                     "page_s": d / 2, "queue_s": 0.1, "requests": 2}
                    for name, d in tenants],
    }


def _rollup_snaps():
    return {
        "r0": _replica_snap(900.0, 1000.0, [("a", 6.0), ("b", 4.0)]),
        "r1": _replica_snap(600.0, 1000.0, [("a", 3.0), ("c", 1.0)],
                            collapse=True),
        "r2": {"error": "connection refused"},
    }


def test_fleet_rollup_merges_and_sizes_the_fleet():
    snaps = _rollup_snaps()
    out = FleetCapacity(target_rho=0.75,
                        replica_capacity_fn=lambda: snaps).rollup()
    fleet = out["fleet"]
    assert fleet["lambda_tok_s"] == pytest.approx(1500.0)
    assert fleet["mu_tok_s"] == pytest.approx(2000.0)
    assert fleet["rho"] == pytest.approx(0.75)
    assert fleet["headroom_tok_s"] == pytest.approx(500.0)
    assert fleet["replicas_needed"] == 2
    assert fleet["replicas_reporting"] == 2
    assert fleet["replicas_total"] == 3
    assert fleet["collapse_warnings"] == ["r1"]
    assert [t["tenant"] for t in out["tenants"]] == ["a", "b", "c"]
    assert out["tenants"][0]["device_s"] == pytest.approx(9.0)
    assert out["replicas"]["r2"] == {"error": "connection refused"}


def test_fleet_rollup_cold_fleet_recommends_what_it_has():
    snaps = {"r0": {"forecast": {}, "totals": {}, "tenants": []},
             "r1": {"forecast": {}, "totals": {}, "tenants": []}}
    fleet = FleetCapacity(replica_capacity_fn=lambda: snaps).rollup()["fleet"]
    assert fleet["mu_tok_s"] is None
    assert fleet["replicas_needed"] == 2


def test_replicas_needed_scales_with_offered_load():
    def mk(lam):
        snaps = {"r0": _replica_snap(lam / 2, 1000.0, []),
                 "r1": _replica_snap(lam / 2, 1000.0, [])}
        return FleetCapacity(target_rho=0.75,
                             replica_capacity_fn=lambda: snaps)
    assert mk(600.0).rollup()["fleet"]["replicas_needed"] == 1
    assert mk(1500.0).rollup()["fleet"]["replicas_needed"] == 2
    assert mk(6000.0).rollup()["fleet"]["replicas_needed"] == 8


def test_fleet_capacity_endpoint_e2e_two_replicas():
    replicas = []
    for name, lam in (("r0", 900.0), ("r1", 600.0)):
        app = App({**QUIET, "APP_NAME": name})
        snap = _replica_snap(lam, 1000.0, [("acme", 5.0), ("zeta", 1.0)])
        app.get("/debug/capacity", lambda ctx, snap=snap: snap)
        app.get("/stats", lambda ctx: {"queue_depth": 0, "active_slots": 0})
        app.start()
        replicas.append((name, app))
    router = serve_router.build_app({
        **QUIET, "APP_NAME": "router", "FLEET_PROBE_S": "0.2",
        "FLEET_REPLICAS": ",".join(f"{n}=http://127.0.0.1:{a.http_port}"
                                   for n, a in replicas),
        "FLEET_JOURNEY": "false", "FLEET_SLO": "false",
        "CAPACITY_TARGET_RHO": "0.75", "INCIDENT_DIR": INCIDENT_DIR})
    router.start()
    try:
        body = _get_json(f"http://127.0.0.1:{router.http_port}"
                         "/debug/fleet/capacity")
        fleet = body["fleet"]
        assert fleet["lambda_tok_s"] == pytest.approx(1500.0)
        assert fleet["mu_tok_s"] == pytest.approx(2000.0)
        assert fleet["rho"] == pytest.approx(0.75)
        assert fleet["replicas_needed"] == 2
        assert fleet["replicas_reporting"] == 2
        assert body["tenants"][0]["tenant"] == "acme"
        assert body["tenants"][0]["device_s"] == pytest.approx(10.0)
        assert set(body["replicas"]) == {"r0", "r1"}
        assert body["replicas"]["r0"]["rho"] == pytest.approx(0.9)
    finally:
        router.shutdown()
        for _, app in replicas:
            app.shutdown()


# -- the same inputs through both packages ------------------------------------
@pytest.mark.parametrize("policy,seed", [("affinity", 0), ("affinity", 11),
                                         ("p2c", 3), ("p2c", 42),
                                         ("round_robin", None)])
def test_make_policy_picks_equal_the_reference(policy, seed):
    """One seed over one sequence of replica states: the same replica and
    reason at every pick (P2C's random.Random, affinity's spill)."""
    import random as _random

    import gofr_tpu.fleet.affinity as jaff
    import gofr_tpu.fleet.policy as jpol
    import gofr_tpu_torch.fleet.affinity as taff
    import gofr_tpu_torch.fleet.policy as tpol

    rng = _random.Random(99)
    prompts = [f"session-{i % 5}: " + "x" * (i % 7) for i in range(40)]
    loads = [[rng.randrange(0, 12) for _ in range(4)] for _ in prompts]
    picks = {}
    for name, pol_mod, aff_mod in (("jax", jpol, jaff),
                                   ("torch", tpol, taff)):
        pol = pol_mod.make_policy(policy, spill_depth=6, seed=seed)
        amap = aff_mod.AffinityMap(capacity=64)
        reps = [_FakeReplica(f"r{i}", 0) for i in range(4)]
        out = []
        for prompt, load in zip(prompts, loads):
            for rep, n in zip(reps, load):
                rep._load = n
            keys = aff_mod.affinity_keys(prompt, block=8)
            candidates = [r for r, n in zip(reps, load) if n != 11] or reps
            replica, reason = pol.choose(candidates, keys, amap)
            amap.learn(keys, replica.name)
            out.append((replica.name, reason))
        picks[name] = out
    assert picks["torch"] == picks["jax"]
    assert len({r for r, _ in picks["torch"]}) > 1


def test_fleet_capacity_rollup_equals_the_reference():
    from gofr_tpu.fleet.capacity import FleetCapacity as JCapacity

    for target in (0.5, 0.75, 0.9):
        snaps = _rollup_snaps()
        snaps["r3"] = {"forecast": {}, "totals": {}, "tenants": []}
        want = JCapacity(target_rho=target,
                         replica_capacity_fn=lambda: snaps).rollup()
        got = FleetCapacity(target_rho=target,
                            replica_capacity_fn=lambda: snaps).rollup()
        assert got == want


def test_fleet_burn_engine_equals_the_reference():
    """The same terminal journeys (outcome, TTFB, stream cadence, class)
    on the same clock: equal burn snapshots, states, class goodput and
    hidden pages, and the same incidents."""
    from gofr_tpu.config import MockConfig as JMockConfig
    from gofr_tpu.fleet.slo import FleetSLO as JFleetSLO

    rng = __import__("random").Random(5)
    recs = []
    for i in range(40):
        outcome = rng.choice(["ok", "ok", "ok", "stream_break",
                              "upstream_error", "no_replica"])
        ttfb = None if outcome == "no_replica" else rng.uniform(0.05, 1.2)
        stream = None if ttfb is None else rng.uniform(0.1, 2.0)
        recs.append(types.SimpleNamespace(
            outcome=outcome, chunks=rng.randrange(1, 30),
            qos_class=rng.choice([None, "interactive", "batch"]),
            ttfb_s=lambda t=ttfb: t, stream_s=lambda s=stream: s))
    out = {}
    for name, pkg, cfg in (("jax", JFleetSLO, JMockConfig),
                           ("torch", FleetSLO, MockConfig)):
        clock = [100.0]
        incidents = _Incidents()
        slo = _fleet_slo(lambda: {"r0": {"availability": "ok"}}, incidents,
                         clock, pkg_slo=pkg, config_cls=cfg)
        for rec in recs:
            clock[0] += 0.5
            slo.observe_journey(rec)
        roll = slo.rollup()
        # the transitions' wall-clock stamps are the only field apart
        for tr in roll["fleet"]["transitions"]:
            tr.pop("t")
        out[name] = (roll, [(k, sorted(set(c) - {"t"}))
                            for k, c in incidents.triggered])
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["hidden_pages"] >= 1


def test_stitching_equals_the_reference():
    import gofr_tpu.fleet.timeline as jtl
    import gofr_tpu_torch.fleet.timeline as ttl

    trace_id = "9a" * 16
    summary, hops = _journey(trace_id)
    bad = _replica_payload(trace_id, wall0=2000.0)
    del bad["anchor"]
    payloads = {"r0": _replica_payload(trace_id),
                "r1": _replica_payload(trace_id, wall0=1000.2, mono0=50.0),
                "r2": bad}
    assert ttl.router_events(summary, hops) == jtl.router_events(summary,
                                                                 hops)
    for name, payload in payloads.items():
        assert ttl.align_replica(payload, 4, name) == jtl.align_replica(
            payload, 4, name)
    got = ttl.stitch_payloads(payloads, journey=summary, hops=hops,
                              trace_id=trace_id)
    want = jtl.stitch_payloads(payloads, journey=summary, hops=hops,
                               trace_id=trace_id)
    got.pop("stitched_at")
    want.pop("stitched_at")
    assert got == want


# -- the port's replicas behind the port's router -----------------------------
REPLICA_ENV = {**QUIET, "MODEL_PRESET": "debug", "WARMUP": "false",
               "MAX_BATCH": "4", "MAX_SEQ_LEN": "64",
               "PREFILL_BUCKETS": "8,16,32", "PAGED": "true",
               "PAGE_SIZE": "8", "REQUEST_TIMEOUT": "300",
               "INCIDENT_AUTOPSY": "false", "FLEET_AFFINITY_BLOCK": "8",
               "INCIDENT_DIR": INCIDENT_DIR}


@pytest.fixture(scope="module")
def disagg_fleet():
    """Two port replicas, r0 split (DISAGG_MODE=both) and r1 colocated,
    behind the port's router, round-robin."""
    from gofr_tpu_torch import serve

    replicas = []
    try:
        for name, extra in (("r0", {"DISAGG_MODE": "both"}), ("r1", {})):
            app = serve.build_app({**REPLICA_ENV, "APP_NAME": name, **extra},
                                  device="cpu")
            app.start()
            replicas.append(app)
        router = serve_router.build_app({
            **QUIET, "APP_NAME": "router", "REQUEST_TIMEOUT": "300",
            "FLEET_POLICY": "round_robin", "FLEET_PROBE_S": "0.2",
            "FLEET_REPLICAS": ",".join(f"r{i}=http://127.0.0.1:{a.http_port}"
                                       for i, a in enumerate(replicas)),
            "INCIDENT_DIR": INCIDENT_DIR})
        router.start()
        try:
            yield {"router": router, "replicas": replicas,
                   "base": f"http://127.0.0.1:{router.http_port}"}
        finally:
            router.shutdown()
    finally:
        for app in replicas:
            app.shutdown()


def _traced(base, prompt, trace, max_tokens=4):
    status, events, _ = _sse(
        base, {"prompt": prompt, "max_tokens": max_tokens, "stream": True},
        {"traceparent": f"00-{trace}-00f067aa0ba902b7-01"}, timeout=300)
    assert status == 200 and events[-1].get("done") is True, events
    return events


def test_disagg_fleet_journey_trace_continuity(disagg_fleet):
    """The assembled waterfall of a request served by the split replica
    shows route -> queue -> prefill -> kv_handoff -> decode under one
    trace id; the colocated replica's shows no hand-off; each replica
    answers the same path itself."""
    base = disagg_fleet["base"]
    waterfalls = {}
    for i in range(8):
        if len(waterfalls) == 2:
            break
        trace = f"{0xabc0 + i:032x}"
        _traced(base, f"hop trace {i}", trace)
        assembled = _get_json(base + f"/debug/journey/{trace}", timeout=30)
        waterfalls.setdefault(assembled["journey"]["replica"], assembled)
    assert set(waterfalls) == {"r0", "r1"}
    for name, assembled in waterfalls.items():
        assert assembled["complete"] is True
        assert is_trace_id(assembled["trace_id"])
        for rec in assembled["replicas"][name]["requests"]:
            assert rec["trace_id"] == assembled["trace_id"]
        starts = [h["t_start"] for h in assembled["hops"]]
        assert starts == sorted(starts)
    split = [h["hop"] for h in waterfalls["r0"]["hops"]]
    for hop in ("route", "queue", "prefill", "kv_handoff", "decode",
                "finish"):
        assert hop in split, f"split waterfall missing {hop}: {split}"
    assert (split.index("queue") < split.index("prefill")
            < split.index("kv_handoff") < split.index("decode"))
    actors = {h["actor"] for h in waterfalls["r0"]["hops"]}
    assert "r0:engine:prefill" in actors
    assert any(a.startswith("r0:engine:") and "prefill" not in a
               for a in actors)
    colocated = [h["hop"] for h in waterfalls["r1"]["hops"]]
    for hop in ("route", "queue", "prefill", "decode", "finish"):
        assert hop in colocated
    assert "kv_handoff" not in colocated
    for i, name in enumerate(("r0", "r1")):
        app = disagg_fleet["replicas"][i]
        local = _get_json(f"http://127.0.0.1:{app.http_port}/debug/journey/"
                          f"{waterfalls[name]['trace_id']}", timeout=30)
        assert local["source"] == "replica" and local["hops"]
        assert local["trace_id"] == waterfalls[name]["trace_id"]


def test_fleet_timeline_stitches_disagg_replica_e2e(disagg_fleet):
    """One request on the split replica: its stitched trace is multi-pid
    (router and replica), the replica's prefill half renders its own
    tracks, the flow chain of its trace id crosses the process boundary
    unbroken, and the replica's events lie in the router's route-to-finish
    window after the alignment."""
    base = disagg_fleet["base"]
    for i in range(4):
        trace = f"{0xfaded0 + i:032x}"
        _traced(base, f"stitch me {i}", trace)
        if _get_json(base + f"/debug/journey/{trace}")["journey"][
                "replica"] == "r0":
            break
    else:
        raise AssertionError("round-robin never reached the split replica")
    stitched = _get_json(base + f"/debug/fleet/timeline/{trace}", timeout=60)
    assert stitched["complete"] is True, stitched["missing"]
    assert stitched["trace_id"] == trace
    assert stitched["pids"] == {"r0": 2}
    events = stitched["traceEvents"]
    _assert_contract(events)
    assert {ev["pid"] for ev in events} == {1, 2}
    names = {ev["args"]["name"] for ev in events
             if ev.get("ph") == "M" and ev["name"] == "thread_name"}
    assert any(n.startswith("prefill:") for n in names), names
    chain = _flow_chains(events).get(trace)
    assert chain, "no flow events for the journey's trace id"
    phases = [ev["ph"] for ev in chain]
    assert phases[0] == "s" and phases.count("s") == 1
    assert phases[-1] == "f" and phases.count("f") == 1
    assert {ev["pid"] for ev in chain} == {1, 2}
    router_ts = [ev["ts"] for ev in events
                 if ev["pid"] == 1 and ev.get("ph") == "X"]
    replica_flow = [ev["ts"] for ev in chain if ev["pid"] == 2]
    assert min(router_ts) <= min(replica_flow)
    assert max(replica_flow) <= max(router_ts) + 1e3
    with pytest.raises(urllib.error.HTTPError) as err:
        _get_json(base + "/debug/fleet/timeline/999999")
    assert err.value.code == 404


# -- on the wire, both ways ---------------------------------------------------
WIRE_PROMPTS = ["wire session one: hello", "wire session two: hello",
                "wire three"]


@pytest.fixture(scope="module")
def mixed():
    """The reference's llm-server (JAX, debug preset) and two port replicas
    holding its weights (models/weights.params_from_numpy)."""
    import jax

    from gofr_tpu.config import MockConfig as JMockConfig
    from gofr_tpu_torch import serve
    from gofr_tpu_torch.models.weights import params_from_numpy

    env = {k: v for k, v in REPLICA_ENV.items() if k != "HOSTPROF"}
    jref = _load("llm-server", "fleet_wire_llm_server").build_app(
        config=JMockConfig({**env, "APP_NAME": "jax", "TPU_PLATFORM": "cpu",
                            "HOSTPROF": "false"}))
    jref.start()
    ports = []
    try:
        params = params_from_numpy(jax.device_get(jref.engine.params),
                                   device="cpu")
        for name in ("p0", "p1"):
            engine = serve.build_engine({**REPLICA_ENV, "APP_NAME": name},
                                        device="cpu", params=params)
            app = serve.build_app({**REPLICA_ENV, "APP_NAME": name},
                                  engine=engine)
            app.start()
            ports.append(app)
        urls = {"jax": f"http://127.0.0.1:{jref.http_port}",
                **{f"p{i}": f"http://127.0.0.1:{a.http_port}"
                   for i, a in enumerate(ports)}}
        # the JAX engine's greedy streams, straight from its replica
        golden = {p: _greedy(urls["jax"], p) for p in WIRE_PROMPTS}
        yield {"urls": urls, "golden": golden}
    finally:
        for app in ports:
            app.shutdown()
        jref.shutdown()


def _greedy(base, prompt, headers=None):
    status, events, _ = _sse(base, {"prompt": prompt, "max_tokens": 6,
                                    "temperature": 0.0, "stream": True},
                             headers, timeout=300)
    assert status == 200 and events[-1].get("done") is True, events
    return "".join(e.get("text", "") for e in events), events[-1]["tokens"]


def _wire_checks(base, urls, golden, names, router):
    """Greedy streams equal through the router (classified, with a tenant)
    and straight to either replica; /debug/fleet fills every row; affinity
    learned from a replica's /stats digest. Returns the router's GET
    /debug/trace."""
    for i, prompt in enumerate(WIRE_PROMPTS):
        headers = {"X-QoS-Class": ("interactive", "batch")[i % 2],
                   "X-Tenant": f"t{i}"}
        assert _greedy(base, prompt, headers) == golden[prompt], prompt
        for name in names:
            assert _greedy(urls[name], prompt) == golden[prompt], (name,
                                                                   prompt)
    snap = _get_json(base + "/debug/fleet")
    assert {r["name"] for r in snap["replicas"]} == set(names)
    for row in snap["replicas"]:
        assert row["state"] == "UP" and row["available"] is True, row
        assert row["generation"] and row["probe_error"] is None, row
        assert row["lifecycle"] == "serving", row
    assert snap["routes_total"] >= len(WIRE_PROMPTS)
    # a prompt served straight by one replica: its digest teaches the
    # router, which then routes the session there by affinity
    fresh = "digest-taught session: hi"
    target = names[-1]
    _greedy(urls[target], fresh)
    keys = affinity_keys(fresh, block=8)
    amap = router.affinity_map
    deadline = time.time() + 10
    while amap.lookup(keys)[0] != target and time.time() < deadline:
        time.sleep(0.1)
    assert amap.lookup(keys)[0] == target
    before = dict(_get_json(base + "/debug/fleet")["routes"])
    assert _greedy(base, fresh) == _greedy(urls[target], fresh)
    after = _get_json(base + "/debug/fleet")["routes"]
    assert after.get("affinity", 0) == before.get("affinity", 0) + 1
    doc = _get_json(base + "/debug/trace")
    assert len(doc["events"]) >= len(WIRE_PROMPTS) + 1
    assert {e.get("class") for e in doc["events"]} >= {"interactive",
                                                       "batch"}
    assert {e.get("tenant") for e in doc["events"]} >= {"t0", "t1", "t2"}
    return doc


def test_reference_router_over_port_replicas(mixed, tmp_path):
    """The reference router (examples/router) over two port replicas; its
    trace, written by the reference's dump_trace, reads alike in both
    packages' load_trace."""
    from gofr_tpu.config import MockConfig as JMockConfig
    from gofr_tpu.loadgen import dump_trace as jdump
    from gofr_tpu.loadgen.trace import load_trace as jload
    from gofr_tpu_torch.loadgen.trace import load_trace

    urls = mixed["urls"]
    router = _load("router", "fleet_wire_router").build_app(
        config=JMockConfig({
            **QUIET, "APP_NAME": "jax-router", "REQUEST_TIMEOUT": "300",
            "FLEET_PROBE_S": "0.2", "FLEET_AFFINITY_BLOCK": "8",
            "FLEET_REPLICAS": f"p0={urls['p0']},p1={urls['p1']}",
            "ELASTIC": "false", "INCIDENT_DIR": INCIDENT_DIR}))
    router.start()
    try:
        base = f"http://127.0.0.1:{router.http_port}"
        doc = _wire_checks(base, urls, mixed["golden"], ["p0", "p1"],
                           router.fleet)
        path = str(tmp_path / "jax_router.jsonl")
        jdump(doc["events"], path, source="router")
        assert load_trace(path) == jload(path)
        assert len(load_trace(path)[1]) == len(doc["events"])
    finally:
        router.shutdown()


def test_port_router_over_a_jax_replica_and_a_port_replica(mixed, tmp_path):
    """The port's router over the reference's llm-server and a port replica
    holding its weights; its trace, written by the port's dump_trace, reads
    alike in both packages' load_trace."""
    from gofr_tpu.loadgen.trace import load_trace as jload
    from gofr_tpu_torch.loadgen import dump_trace
    from gofr_tpu_torch.loadgen.trace import load_trace

    urls = mixed["urls"]
    router = serve_router.build_app({
        **QUIET, "APP_NAME": "router", "REQUEST_TIMEOUT": "300",
        "FLEET_PROBE_S": "0.2", "FLEET_AFFINITY_BLOCK": "8",
        "FLEET_REPLICAS": f"jax={urls['jax']},p1={urls['p1']}",
        "ELASTIC": "false", "INCIDENT_DIR": INCIDENT_DIR})
    router.start()
    try:
        base = f"http://127.0.0.1:{router.http_port}"
        doc = _wire_checks(base, urls, mixed["golden"], ["jax", "p1"],
                           router.fleet)
        path = str(tmp_path / "port_router.jsonl")
        dump_trace(doc["events"], path, source="router")
        assert jload(path) == load_trace(path)
        assert len(jload(path)[1]) == len(doc["events"])
    finally:
        router.shutdown()


# -- the key table -------------------------------------------------------------
_KEY = r'(?:config|cfg)\.get(?:_\w+)?\(\s*"([A-Z0-9_]+)"'


def _router_keys():
    """Every key the reference router reads: its main.py, the fleet
    modules' from_config, its App's constructor, container and tracer, and
    the device client its container may build."""
    import ast

    src = (ROOT / "gofr_tpu" / "app.py").read_text()
    app_cls = next(n for n in ast.parse(src).body
                   if isinstance(n, ast.ClassDef) and n.name == "App")
    init = next(n for n in app_cls.body
                if isinstance(n, ast.FunctionDef) and n.name == "__init__")
    text = ast.get_source_segment(src, init)
    keys = set(re.findall(_KEY, text)) | set(
        re.findall(r'environ\.get\(\s*"([A-Z0-9_]+)"', text))
    paths = [ROOT / "examples" / "router" / "main.py",
             ROOT / "gofr_tpu" / "container" / "__init__.py",
             ROOT / "gofr_tpu" / "tracing" / "__init__.py",
             ROOT / "gofr_tpu" / "tpu" / "device.py"]
    paths += sorted((ROOT / "gofr_tpu" / "fleet").glob("*.py"))
    for path in paths:
        keys.update(re.findall(_KEY, path.read_text()))
    return keys


def test_every_router_key_is_accounted_for():
    keys = _router_keys()
    assert {"FLEET_REPLICAS", "FLEET_POLICY", "FLEET_RETRY_BUDGET",
            "FLEET_JOURNEY", "FLEET_SLO_PAGE_BURN", "CAPACITY_TARGET_RHO",
            "ELASTIC_LAUNCH_CMD", "DRAIN_TIMEOUT_S", "INCIDENT_DIR",
            "HTTP_PORT", "GRPC_PORT", "TPU_ENABLED"} <= keys
    ported = set(serve_router.PORTED)
    refused = {k for k, _, _ in serve_router.NOT_PORTED}
    inert = {k for k, _ in serve_router.INERT}
    assert not (ported & refused) and not (ported & inert) \
        and not (refused & inert)
    missing = sorted(keys - (ported | refused | inert))
    assert not missing, f"unaccounted router keys: {missing}"
    assert not (ported | refused | inert) - keys
    assert all(len(why) > 20 for _, why in serve_router.INERT)
    # every served key is read by the router, its fleet modules or its App
    import inspect

    from gofr_tpu_torch import app, container, fleet, tracing

    src = inspect.getsource(serve_router) + "".join(
        inspect.getsource(m) for m in (
            app, container, tracing, fleet.registry, fleet.proxy,
            fleet.slo, fleet.capacity, fleet.elastic))
    for key in ported:
        assert f'"{key}"' in src, key
    for key in ported - {"HTTP_PORT", "METRICS_PORT", "REQUEST_TIMEOUT",
                         "MAX_CONCURRENT_REQUESTS", "LOG_LEVEL", "APP_NAME",
                         "APP_VERSION", "TRACE_EXPORTER", "TRACER_URL",
                         "GOFR_CONFIGS_DIR", "DB_DIALECT", "DB_PATH",
                         "KV_STORE", "KV_ENABLED", "PUBSUB_BACKEND"}:
        assert key in serve_router.__doc__ or key.startswith(
            ("FLEET_", "ELASTIC_", "INCIDENT_", "CAPACITY_", "DRAIN_")), key


def test_router_refuses_the_waiting_keys_at_boot():
    # no key waits any more: REMOTE_LOG_URL starts the container's level
    # poller (A18b part 5), and the router's container builds no device
    # client even under TPU_ENABLED
    assert serve_router.NOT_PORTED == ()
    app = serve_router.build_app({**QUIET, "FLEET_REPLICAS": "http://h:1",
                                  "REMOTE_LOG_URL": "http://h:2/level",
                                  "REMOTE_LOG_FETCH_INTERVAL": "30",
                                  "TPU_ENABLED": "true",
                                  "INCIDENT_DIR": INCIDENT_DIR})
    poller = app.container._level_poller
    try:
        assert poller.is_alive() and app.container.tpu is None
    finally:
        app.shutdown()
    assert not poller.is_alive()
    with pytest.raises(ValueError, match="FLEET_REPLICAS"):
        serve_router.build_app({**QUIET})
    with pytest.raises(ValueError, match="ELASTIC_LAUNCH_CMD"):
        serve_router.build_app({**QUIET, "FLEET_REPLICAS": "http://h:1",
                                "ELASTIC_LAUNCHER": "subprocess",
                                "INCIDENT_DIR": INCIDENT_DIR})
