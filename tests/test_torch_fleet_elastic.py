"""The port's autoscaler and drain orchestration (gofr_tpu_torch/fleet/
elastic.py behind serve_router.py) against the reference's.

The twins of tests/test_elastic.py's autoscaler half: the dwell gating
absorbs a flapping demand signal while sustained demand actuates exactly
once, the QoS ladder's scale-out rung outranks the steady sizing, warming
and draining replicas are held out of routing and a drain announcement
drops learned affinity at once, and the router's ``/debug/fleet/elastic``
and ``POST /debug/fleet/drain/{replica}`` work over live HTTP. The same
decision sequence is held against the reference's ``FleetAutoscaler`` on
the same clock and capacity signal. Beyond the reference's tests: the
autoscaler launches a port replica in process (``InProcessLauncher`` over
``serve.build_app``, the debug preset on the CPU), routes to it once it
serves, and drains it on calm with its live streams migrated to the other
replica, every stream complete and equal to the undrained run; the
subprocess launcher's children end with the App.
"""

import json
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from gofr_tpu_torch import serve_router
from gofr_tpu_torch.app import App, Stream
from gofr_tpu_torch.config import MockConfig
from gofr_tpu_torch.datasource import STATUS_UP, Health
from gofr_tpu_torch.fleet.elastic import (FleetAutoscaler, InProcessLauncher,
                                          SubprocessLauncher,
                                          launcher_from_config)
from gofr_tpu_torch.fleet.registry import FleetRegistry, Replica

from _torch_env import INCIDENT_DIR

pytestmark = pytest.mark.elastic

QUIET = {"HTTP_PORT": "0", "METRICS_PORT": "0", "REQUEST_TIMEOUT": "30",
         "GRPC_PORT": "0",
         "LOG_LEVEL": "ERROR", "HOSTPROF": "false"}


class MockLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


def _wait(predicate, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# -- autoscaler hysteresis ----------------------------------------------------
def _spy_replica(name):
    return types.SimpleNamespace(name=name, scaleout_wanted=False,
                                 effective_lifecycle="serving",
                                 available=lambda: True)


class _SpyRegistry:
    def __init__(self, n=1):
        self.replicas = [_spy_replica(f"r{i}") for i in range(n)]
        self.added = []

    def add_replica(self, name, address, lifecycle_override="warming"):
        self.added.append((name, address, lifecycle_override))
        self.replicas = self.replicas + [_spy_replica(name)]

    def candidates(self):
        # no routable victim: a scale-down decides "no_victim"
        return []


def _autoscaler(registry, clock, capacity_fn, cls=FleetAutoscaler,
                launcher_cls=InProcessLauncher, **kw):
    router = types.SimpleNamespace(registry=registry)
    launcher = launcher_cls(lambda name: f"http://test/{name}")
    defaults = dict(min_replicas=1, max_replicas=4, up_hold_s=5.0,
                    down_hold_s=30.0, cooldown_s=30.0, clock=clock,
                    capacity_fn=capacity_fn)
    defaults.update(kw)
    return cls(router, launcher, **defaults)


def test_autoscaler_flapping_demand_never_oscillates():
    now = [0.0]
    needed = [1]
    reg = _SpyRegistry(n=1)
    scaler = _autoscaler(reg, lambda: now[0],
                         lambda: {"replicas_needed": needed[0]})
    for tick in range(20):
        now[0] = float(tick)
        needed[0] = 2 if tick % 2 == 0 else 1
        scaler.evaluate()
    assert reg.added == []
    assert scaler.scale_events == {"up": 0, "down": 0}
    assert all(d["action"] == "none" for d in scaler.decisions)


def test_autoscaler_sustained_demand_launches_once_then_cools():
    now = [0.0]
    reg = _SpyRegistry(n=1)
    scaler = _autoscaler(reg, lambda: now[0],
                         lambda: {"replicas_needed": 2})
    record = scaler.evaluate()
    assert record["action"] == "none" and record["reason"] == "dwell"
    now[0] = 6.0
    record = scaler.evaluate()
    assert record["action"] == "launched auto0"
    assert reg.added == [("auto0", "http://test/auto0", "warming")]
    assert scaler.scale_events["up"] == 1
    now[0] = 8.0
    record = scaler.evaluate()
    assert record["action"] == "none"
    assert reg.added == [("auto0", "http://test/auto0", "warming")]
    snap = scaler.snapshot()
    assert snap["launched"] == ["auto0"]
    assert snap["scale_events"] == {"up": 1, "down": 0}


def test_autoscaler_scaleout_rung_outranks_steady_sizing():
    now = [0.0]
    reg = _SpyRegistry(n=1)
    reg.replicas[0].scaleout_wanted = True
    scaler = _autoscaler(reg, lambda: now[0],
                         lambda: {"replicas_needed": 1}, up_hold_s=0.0)
    record = scaler.evaluate()
    assert record["desired"] == 2
    assert record["scaleout_wanted"] == ["r0"]
    assert record["action"] == "launched auto0"


def test_autoscaler_decisions_equal_the_reference():
    """The same clock and capacity signal (demand, a spike, a collapse
    warning, calm) through both packages' reconcilers: the same decision
    records and launches, tick for tick."""
    from gofr_tpu.fleet.elastic import FleetAutoscaler as JAutoscaler
    from gofr_tpu.fleet.elastic import InProcessLauncher as JLauncher

    rng = __import__("random").Random(3)
    signal = []
    for tick in range(80):
        phase = tick // 20
        needed = [1, 3, 2, 1][phase] + (rng.random() < 0.15)
        collapse = ["r0"] if phase == 2 and tick % 7 == 0 else []
        signal.append({"replicas_needed": needed,
                       "collapse_warnings": collapse})
    runs = {}
    for name, cls, launcher in (("jax", JAutoscaler, JLauncher),
                                ("torch", FleetAutoscaler,
                                 InProcessLauncher)):
        now = [0.0]
        reg = _SpyRegistry(n=1)
        i = [0]
        scaler = _autoscaler(reg, lambda: now[0], lambda: signal[i[0]],
                             cls=cls, launcher_cls=launcher, up_hold_s=3.0,
                             down_hold_s=6.0, cooldown_s=4.0,
                             max_replicas=3)
        for tick in range(len(signal)):
            i[0] = tick
            now[0] = float(tick)
            scaler.evaluate()
        runs[name] = (scaler.decisions, reg.added, scaler.scale_events)
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][2]["up"] >= 1


# -- registry lifecycle gating ------------------------------------------------
def test_lifecycle_gates_availability_and_drain_drops_affinity():
    r0 = Replica("r0", "http://127.0.0.1:1", logger=MockLogger())
    r1 = Replica("r1", "http://127.0.0.1:2", logger=MockLogger())
    reg = FleetRegistry([r0, r1], logger=MockLogger())
    added = reg.add_replica("auto0", "http://127.0.0.1:3")
    assert added.effective_lifecycle == "warming"
    assert not added.available()
    assert reg.add_replica("auto0", "http://other") is added
    added.lifecycle_override = None
    assert added.available(), "a cleared override restores routability"
    reg.affinity_map.learn(["k1", "k2"], "r0")
    reg.affinity_map.learn(["k3"], "r1")
    assert reg.announce_drain("r0") == 2
    assert r0.effective_lifecycle == "draining"
    assert not r0.available()
    assert reg.candidates() and all(r.name != "r0" for r in reg.candidates())
    assert reg.affinity_map.lookup(["k1"]) == (None, None)
    assert reg.affinity_map.lookup(["k3"]) == ("r1", "k3")
    assert reg.announce_drain("ghost") is None
    assert reg.remove_replica("auto0") is True
    assert reg.replica("auto0") is None
    reg.stop()


# -- end to end over live HTTP ------------------------------------------------
class _ElasticStub:
    """An llm-server-shaped port App advertising a lifecycle and honouring
    the drain order."""

    def __init__(self, name, lifecycle="serving"):
        self.name = name
        self.state = {"lifecycle": lifecycle, "drained": False}
        self.served = []
        self.drain_orders = []
        app = App({**QUIET, "APP_NAME": name})
        st = self.state
        app.add_health_contributor(
            "engine", lambda: Health(status=STATUS_UP, details={}))

        @app.post("/generate")
        def generate(ctx):
            self.served.append(ctx.bind().get("prompt"))

            def chunks():
                yield {"text": f"{name}-t0"}
                yield {"done": True, "tokens": 1}

            return Stream(chunks(), sse=True)

        @app.get("/stats")
        def stats(ctx):  # noqa: ARG001
            return {"queue_depth": 0, "active_slots": 0,
                    "fleet": {"duty_cycle": 0.25,
                              "lifecycle": st["lifecycle"],
                              "affinity": {"block": 8,
                                           "generation": f"{name}-gen1",
                                           "keys": []}}}

        @app.post("/debug/drain")
        def drain_order(ctx):
            self.drain_orders.append(ctx.bind())
            st["lifecycle"] = "draining"
            st["drained"] = True
            return {"drain_started": True, "drained": st["drained"]}

        @app.get("/debug/drain")
        def drain_status(ctx):  # noqa: ARG001
            return {"drain_started": st["drained"], "drained": st["drained"]}

        self.app = app

    def start(self):
        self.app.start()
        self.url = f"http://127.0.0.1:{self.app.http_port}"
        return self

    def stop(self):
        self.app.shutdown()


def _call(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=15) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode() or "null")


def _generate(port, prompt, max_tokens=None):
    body = {"prompt": prompt, "stream": True}
    if max_tokens is not None:
        body.update(max_tokens=max_tokens, temperature=0.0)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        events = [json.loads(line.strip()[6:]) for line in resp
                  if line.strip().startswith(b"data: ")]
        return resp.status, events


def _wait_fleet(port, predicate, timeout=6.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        _, payload = _call(port, "GET", "/debug/fleet")
        if predicate(payload["data"]):
            return payload["data"]
        time.sleep(0.1)
    raise AssertionError("probe condition not reached")


def test_elastic_debug_surface_end_to_end():
    """The port's router over lifecycle-advertising stubs: warming replicas
    get no traffic, /debug/fleet/elastic shows the reconciler, and the
    operator's drain runs announce -> order -> poll."""
    replicas = [_ElasticStub(f"r{i}", lifecycle=lc).start()
                for i, lc in enumerate(("serving", "warming"))]
    app = serve_router.build_app({
        **QUIET, "APP_NAME": "router", "FLEET_PROBE_S": "0.2",
        "FLEET_REPLICAS": ",".join(f"{r.name}={r.url}" for r in replicas),
        "ELASTIC_INTERVAL_S": "0.5", "DRAIN_TIMEOUT_S": "5",
        "INCIDENT_DIR": INCIDENT_DIR})
    app.start()
    port = app.http_port
    try:
        _wait_fleet(port, lambda s: {r["name"]: r.get("lifecycle")
                                     for r in s["replicas"]}
                    == {"r0": "serving", "r1": "warming"})
        for _ in range(3):
            assert _generate(port, "elastic-e2e prompt")[0] == 200
        assert len(replicas[0].served) == 3
        assert replicas[1].served == [], "a warming replica got traffic"
        snap = _wait_fleet(
            port, lambda s: s.get("route_skips", {}).get("warming", 0) >= 1)
        assert snap["route_skips"]["warming"] >= 1
        replicas[1].state["lifecycle"] = "serving"
        _wait_fleet(port, lambda s: all(r.get("lifecycle") == "serving"
                                        for r in s["replicas"]))
        status, payload = _call(port, "GET", "/debug/fleet/elastic")
        assert status == 200
        elastic = payload["data"]
        assert elastic["launcher"] is None
        assert {r["name"] for r in elastic["replicas"]} == {"r0", "r1"}
        status, payload = _call(port, "POST", "/debug/fleet/drain/r0",
                                {"migrate": True, "remove": False})
        assert status in (200, 201)
        out = payload["data"]
        assert out["drained"] is True and out["removed"] is False
        [order] = replicas[0].drain_orders
        assert order["peers"] == [replicas[1].url]
        assert order["migrate"] is True
        _wait_fleet(port, lambda s: any(r["name"] == "r0"
                                        and r.get("lifecycle") == "draining"
                                        for r in s["replicas"]))
        before = len(replicas[1].served)
        assert _generate(port, "post-drain prompt")[0] == 200
        assert len(replicas[1].served) == before + 1
        assert len(replicas[0].served) == 3, "a draining replica got traffic"
        status, _ = _call(port, "POST", "/debug/fleet/drain/ghost", {})
        assert status == 404
    finally:
        app.shutdown()
        for r in replicas:
            r.stop()


# -- launchers ----------------------------------------------------------------
def test_launcher_from_config_as_the_reference():
    assert launcher_from_config(MockConfig({})) is None
    assert launcher_from_config(MockConfig({"ELASTIC_LAUNCHER": "none"})) \
        is None
    with pytest.raises(ValueError, match="ELASTIC_LAUNCH_CMD"):
        launcher_from_config(MockConfig({"ELASTIC_LAUNCHER": "subprocess"}))
    with pytest.raises(ValueError, match="unknown ELASTIC_LAUNCHER"):
        launcher_from_config(MockConfig({"ELASTIC_LAUNCHER": "k8s"}))
    launcher = launcher_from_config(MockConfig({
        "ELASTIC_LAUNCHER": "subprocess",
        "ELASTIC_LAUNCH_CMD": "python -m gofr_tpu_torch.serve",
        "ELASTIC_PORT_BASE": "9911"}))
    assert isinstance(launcher, SubprocessLauncher)
    assert launcher.argv == [sys.executable, "-m", "gofr_tpu_torch.serve"]
    assert launcher._next_port == 9911


def test_subprocess_children_end_with_the_router():
    """A launched child (here a sleeping interpreter) is terminated by the
    autoscaler's stop, which the App's shutdown runs."""
    app = serve_router.build_app({
        **QUIET, "APP_NAME": "router", "FLEET_REPLICAS": "http://127.0.0.1:9",
        "ELASTIC_LAUNCHER": "subprocess",
        "ELASTIC_LAUNCH_CMD": "python -c import\\ time;time.sleep(60)",
        "INCIDENT_DIR": INCIDENT_DIR})
    scaler = app.autoscaler
    scaler.launcher.argv = [sys.executable, "-c",
                            "import time; time.sleep(60)"]
    address = scaler.launcher.launch("auto0")
    scaler._launched.add("auto0")
    proc = scaler.launcher._procs["auto0"]
    assert address.startswith("http://127.0.0.1:") and proc.poll() is None
    app.shutdown()
    assert proc.poll() is not None, "the child outlived the router"
    assert scaler.launcher._procs == {}


# -- the port's replicas: launch on demand, drain with migration on calm ------
REPLICA_ENV = {**QUIET, "MODEL_PRESET": "debug", "WARMUP": "false",
               "MAX_BATCH": "4", "MAX_SEQ_LEN": "128",
               "PREFILL_BUCKETS": "8,16,32,64,128", "PAGED": "true",
               "PAGE_SIZE": "8", "REQUEST_TIMEOUT": "300",
               "INCIDENT_AUTOPSY": "false", "ENGINE_HBM_SAMPLE_S": "0",
               "INCIDENT_DIR": INCIDENT_DIR}


def _slow(app, delay_s=0.25):
    """Hold each decode block of the App's engine, so a stream stays live
    long enough to be migrated."""
    eng = app.engine
    dispatch = eng._dispatch_decode

    def slowed(*a, **k):
        time.sleep(delay_s)
        return dispatch(*a, **k)

    eng._dispatch_decode = slowed


def test_autoscaler_launches_routes_and_drains_a_port_replica():
    from gofr_tpu_torch import serve

    base_app = serve.build_app({**REPLICA_ENV, "APP_NAME": "r0"},
                               device="cpu")
    base_app.start()
    launched = {}

    def factory(name):
        app = serve.build_app({**REPLICA_ENV, "APP_NAME": name},
                              device="cpu")
        _slow(app)
        app.start()
        launched[name] = app
        return f"http://127.0.0.1:{app.http_port}", app.shutdown

    demand = [2]
    router = serve_router.build_app({
        **QUIET, "APP_NAME": "router", "REQUEST_TIMEOUT": "300",
        "FLEET_PROBE_S": "0.2", "FLEET_POLICY": "round_robin",
        "FLEET_REPLICAS": f"r0=http://127.0.0.1:{base_app.http_port}",
        "ELASTIC_MIN_REPLICAS": "1", "ELASTIC_MAX_REPLICAS": "2",
        "ELASTIC_INTERVAL_S": "0.2", "ELASTIC_UP_HOLD_S": "0.4",
        "ELASTIC_DOWN_HOLD_S": "0.4", "ELASTIC_COOLDOWN_S": "0.5",
        "DRAIN_TIMEOUT_S": "60", "INCIDENT_DIR": INCIDENT_DIR})
    scaler = router.autoscaler
    scaler.launcher = InProcessLauncher(factory)
    scaler._capacity_fn = lambda: {"replicas_needed": demand[0]}
    router.start()
    port = router.http_port
    prompts = [f"elastic stream {i}" for i in range(4)]
    try:
        # the undrained run, straight to the base replica
        want = {}
        for p in prompts:
            status, events = _generate(base_app.http_port, p, 96)
            want[p] = [e.get("text") for e in events if "text" in e]
        # sustained demand: exactly one launch, routable once it serves
        _wait(lambda: "auto0" in launched and any(
            r.name == "auto0" and r.available()
            for r in router.fleet.registry.replicas), 60, "auto0 serving")
        assert scaler.scale_events["up"] == 1
        assert [r.name for r in router.fleet.registry.replicas] == [
            "r0", "auto0"]
        # streams through the router, round-robin over both replicas
        results = {}

        def stream(p):
            results[p] = _generate(port, p, 96)

        threads = [threading.Thread(target=stream, args=(p,))
                   for p in prompts]
        for t in threads:
            t.start()
        auto = launched["auto0"].engine
        _wait(lambda: any(s.active for s in auto.slots), 60,
              "a live stream on auto0")
        demand[0] = 1   # calm: drain auto0 with its streams migrated
        for t in threads:
            t.join(120)
        _wait(lambda: scaler.scale_events["down"] == 1
              and router.fleet.registry.replica("auto0") is None, 60,
              "auto0 drained and removed")
        assert scaler.scale_events["up"] == 1
        for p in prompts:
            status, events = results[p]
            assert status == 200 and events[-1].get("done") is True, events
            assert [e.get("text") for e in events if "text" in e] == want[p]
        assert auto.migrations_total >= 1
        assert "auto0" not in [r.name for r in
                               router.fleet.registry.replicas]
    finally:
        router.shutdown()
        base_app.shutdown()
        for app in launched.values():
            app.shutdown()
