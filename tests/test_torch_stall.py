"""The port's stall watchdog, health, /stats and plane opt-outs.

The counterparts of tests/test_engine_stall.py on the port's engine (debug
preset, on the CPU): a loop stuck inside a sync (a ``_sync_oldest`` that
blocks until released) grows ``stall_seconds``; past ``STALL_REJECT_S``
``submit`` sheds with ``EngineStalledError`` (503, through
``serve.shed_to_503`` on /generate, with Retry-After), the health
contributor answers DEGRADED with the stall age at once (it never touches
the device), ``/stats.stall_seconds`` and the scrape-time
``app_tpu_engine_stall_seconds`` gauge move, and the engine recovers when
the sync returns. The container's de-flap rule and its scrape hooks are
held as the reference's. Each plane's opt-out key set to false removes its
route (404), HOSTPROF_HZ=0 starts no sampler thread, and a draining
lifecycle answers 503 on /generate.
"""

import http.client
import json
import threading
import time

import pytest

from gofr_tpu_torch.container import (STATUS_DEGRADED, STATUS_DOWN,
                                      STATUS_UP, Container, Health)
from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
from gofr_tpu_torch.serve import build_app, build_engine, shed_to_503
from gofr_tpu_torch.tpu.engine import (EngineDrainingError,
                                       EngineStalledError, LLMEngine)

from _torch_env import INCIDENT_DIR

CFG = LlamaConfig.debug()
ENV = {"MODEL_PRESET": "debug", "HTTP_PORT": "0", "METRICS_PORT": "0",
       "GRPC_PORT": "0",
       "MAX_BATCH": "2", "MAX_SEQ_LEN": "64", "PREFILL_BUCKETS": "16",
       "PAGE_SIZE": "8", "WARMUP": "false", "LOG_LEVEL": "WARN",
       "REQUEST_TIMEOUT": "60", "ENGINE_HBM_SAMPLE_S": "0",
       "INCIDENT_DIR": INCIDENT_DIR}


@pytest.fixture(scope="module")
def params():
    return llama_init(CFG, seed=0, device="cpu")


@pytest.fixture
def engine(params):
    eng = LLMEngine(params, CFG, n_slots=2, max_seq_len=64,
                    prefill_buckets=(16,), decode_block_size=4,
                    device="cpu")
    eng.start()
    yield eng
    eng.stop()


def _wedge(engine, threshold: float = 0.3):
    """Make the next sync block until the returned event is set."""
    gate = threading.Event()
    orig = engine._sync_oldest

    def stuck_sync():
        gate.wait(timeout=30)
        return orig()

    engine._sync_oldest = stuck_sync
    engine.STALL_REJECT_S = threshold
    return gate, orig


def _wait_stalled(engine, at_least: float):
    deadline = time.monotonic() + 10
    while engine.stall_seconds < at_least and time.monotonic() < deadline:
        time.sleep(0.05)
    assert engine.stall_seconds >= at_least, "the loop never blocked"


def test_idle_engine_reports_healthy(engine):
    time.sleep(0.2)     # an idle loop parks in 50 ms waits: it beats
    assert engine.stall_seconds < 1.0
    assert not engine.wedged()
    h = engine.health_check()
    assert h.status == STATUS_UP
    assert "stall_seconds" not in h.details


def test_stopped_engine_reports_zero_stall(params):
    eng = LLMEngine(params, CFG, n_slots=2, max_seq_len=64,
                    prefill_buckets=(16,), device="cpu")
    assert eng.stall_seconds == 0.0    # never started
    assert eng.health_check().status == STATUS_DOWN
    eng.start()
    eng.stop()
    assert eng.stall_seconds == 0.0    # a dead thread cannot be stalled


def test_wedged_engine_sheds_and_degrades_then_recovers(engine):
    gate, orig = _wedge(engine)
    first = engine.submit([1, 2, 3], max_new_tokens=4)
    _wait_stalled(engine, 0.6)
    with pytest.raises(EngineStalledError) as ei:
        engine.submit([4, 5, 6], max_new_tokens=4)
    assert ei.value.status_code == 503
    h = engine.health_check()
    assert h.status == STATUS_DEGRADED
    assert h.details["stall_seconds"] >= 0.6
    gate.set()
    engine._sync_oldest = orig
    assert len(first.result(timeout_s=60)) == 4
    # the stall clock resets once the loop runs again: under the 0.3 s
    # threshold, it falls below it and health reads UP (polled, since an
    # idle loop parks in 50 ms waits and a loaded CPU may wake it late)
    deadline = time.monotonic() + 10
    while ((engine.stall_seconds >= 0.3
            or engine.health_check().status != STATUS_UP)
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert engine.stall_seconds < 0.3
    assert engine.health_check().status == STATUS_UP
    # the class default again before the next request (as the reference's
    # twin has it): one slow eager step on a loaded CPU must not shed it
    engine.STALL_REJECT_S = type(engine).STALL_REJECT_S
    assert len(engine.generate([7, 8], max_new_tokens=3)) == 3
    assert engine.health_check().status == STATUS_UP


def test_container_health_contributor_degrades_aggregate():
    container = Container.create({"LOG_LEVEL": "WARN"})
    container.add_health_contributor(
        "engine", lambda: Health(status=STATUS_DEGRADED,
                                 details={"stall_seconds": 12.0}))
    # de-flap: the first DEGRADED check is visible, not yet actionable
    out = container.health()
    assert out["status"] == STATUS_UP
    assert out["degrading"] is True
    assert out["details"]["engine"]["details"]["stall_seconds"] == 12.0
    out = container.health()
    assert out["status"] == STATUS_DEGRADED
    # a contributor that raises is DOWN, and the aggregate DEGRADED at once
    container2 = Container.create({"LOG_LEVEL": "WARN"})
    container2.add_health_contributor(
        "engine", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    out2 = container2.health()
    assert out2["status"] == STATUS_DEGRADED
    assert out2["details"]["engine"]["details"]["error"] == "boom"


def test_health_answers_while_the_loop_is_stuck(engine):
    """The engine's health reads host stamps only: while the loop is stuck
    in a sync it answers at once, DEGRADED past the threshold."""
    gate, orig = _wedge(engine, threshold=0.2)
    try:
        engine.submit([1, 2, 3], max_new_tokens=4)
        _wait_stalled(engine, 0.4)
        t0 = time.monotonic()
        h = engine.health_check()
        assert time.monotonic() - t0 < 0.5
        assert h.status == STATUS_DEGRADED
    finally:
        gate.set()
        engine._sync_oldest = orig


def test_shed_errors_map_to_503_with_retry_after():
    stalled = shed_to_503(EngineStalledError(200.0))
    assert stalled.status_code == 503 and stalled.retry_after_s == 15.0
    draining = shed_to_503(EngineDrainingError())
    assert draining.status_code == 503 and draining.retry_after_s == 1.0
    assert "stuck in a device call for 200s" in str(EngineStalledError(200))


def test_stall_gauge_refreshes_at_scrape():
    container = Container.create({"LOG_LEVEL": "WARN"})
    m = container.metrics_manager
    m.new_gauge("app_tpu_engine_stall_seconds", "test")

    class FakeEngine:
        stall_seconds = 0.0

    eng = FakeEngine()
    for _ in range(2):   # name-keyed: registering again replaces
        container.add_scrape_hook("engine_stall", lambda: m.set_gauge(
            "app_tpu_engine_stall_seconds", round(eng.stall_seconds, 1)))
    assert len(container._scrape_hooks) == 1
    container.refresh_runtime_metrics()
    assert m.get("app_tpu_engine_stall_seconds").series[()] == 0.0
    eng.stall_seconds = 42.2
    container.refresh_runtime_metrics()
    assert m.get("app_tpu_engine_stall_seconds").series[()] == 42.2
    container.add_scrape_hook("broken",
                              lambda: (_ for _ in ()).throw(RuntimeError()))
    container.refresh_runtime_metrics()        # does not raise


# -- through the server -------------------------------------------------------
def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=json.dumps(body) if body else None)
    resp = conn.getresponse()
    raw = resp.read().decode()
    conn.close()
    return resp.status, resp.getheader("Retry-After"), raw


def test_wedged_server_answers_503_and_reports_the_stall(params):
    app = build_app(ENV, engine=build_engine(ENV, device="cpu",
                                             params=params))
    app.start()
    try:
        engine = app.engine
        gate, orig = _wedge(engine)
        try:
            first = engine.submit([1, 2, 3], max_new_tokens=4)
            _wait_stalled(engine, 0.6)
            status, retry, raw = _call(app.http_port, "POST", "/generate",
                                       {"prompt": "hi", "max_tokens": 4})
            assert status == 503 and retry == "15"
            assert "stuck in a device call" in raw
            status, _, raw = _call(app.http_port, "GET", "/stats")
            assert json.loads(raw)["data"]["stall_seconds"] >= 0.6
            _, _, metrics = _call(app.metrics_port, "GET", "/metrics")
            line = [l for l in metrics.splitlines()
                    if l.startswith("app_tpu_engine_stall_seconds ")][0]
            assert float(line.split()[1]) >= 0.6
            _, _, raw = _call(app.http_port, "GET", "/.well-known/health")
            detail = json.loads(raw)["data"]["details"]["engine"]
            assert detail["status"] == STATUS_DEGRADED
            assert detail["details"]["stall_seconds"] >= 0.6
            _, _, raw = _call(app.http_port, "GET", "/debug/requests")
            events = json.loads(raw)["data"]["engine_events"]
            assert events[-1]["event"] == "stall_shed"
        finally:
            gate.set()
            engine._sync_oldest = orig
        # as the reference's twin: the wedged request finishes, and the
        # threshold is the class default again, before the next request
        assert len(first.result(timeout_s=60)) == 4
        engine.STALL_REJECT_S = type(engine).STALL_REJECT_S
        status, _, _ = _call(app.http_port, "POST", "/generate",
                             {"prompt": "hi", "max_tokens": 4})
        assert status == 200
        # the gauge is round(stall, 1) at each scrape: a loop that wakes
        # late from its 50 ms park may read 0.1 once, so poll for 0.0
        deadline = time.monotonic() + 10
        while True:
            _, _, metrics = _call(app.metrics_port, "GET", "/metrics")
            if ("app_tpu_engine_stall_seconds 0.0" in metrics
                    or time.monotonic() > deadline):
                break
            time.sleep(0.05)
        assert "app_tpu_engine_stall_seconds 0.0" in metrics
    finally:
        app.shutdown()


def test_draining_lifecycle_answers_503(params):
    app = build_app(ENV, engine=build_engine(ENV, device="cpu",
                                             params=params))
    app.start()
    try:
        _, _, raw = _call(app.http_port, "GET", "/stats")
        assert json.loads(raw)["data"]["fleet"]["lifecycle"] == "serving"
        app.engine.drain(0.0)
        status, retry, raw = _call(app.http_port, "POST", "/generate",
                                   {"prompt": "hi", "max_tokens": 4})
        assert status == 503 and retry == "1" and "draining" in raw
        _, _, raw = _call(app.http_port, "GET", "/stats")
        assert json.loads(raw)["data"]["fleet"]["lifecycle"] == "draining"
    finally:
        app.shutdown()


# (opt-out key, the routes it removes)
OPT_OUTS = {
    "FLIGHT_RECORDER": ("/debug/requests", "/debug/journey", "/debug/trace"),
    "FLIGHT_TRACE_EXPORT": ("/debug/trace",),
    "ENGINE_SNAPSHOT": ("/debug/engine",),
    "STEP_LEDGER": ("/debug/steps",),
    "TIMELINE": ("/debug/timeline",),
    "HOSTPROF": ("/debug/hostprof",),
}
ROUTES = ("/debug/requests", "/debug/journey", "/debug/trace",
          "/debug/engine", "/debug/steps", "/debug/timeline",
          "/debug/hostprof", "/stats")


@pytest.fixture(scope="module")
def idle_engine(params):
    eng = build_engine(ENV, device="cpu", params=params)
    yield eng
    eng.stop()


def _samplers():
    return [t for t in threading.enumerate()
            if t.name == "hostprof-sampler" and t.is_alive()]


@pytest.mark.parametrize("key", sorted(OPT_OUTS) + ["HOSTPROF_HZ", None])
def test_each_opt_out_removes_its_route(idle_engine, key):
    env = dict(ENV)
    if key == "HOSTPROF_HZ":
        env[key] = "0"
        gone = ("/debug/hostprof",)
    elif key is not None:
        env[key] = "false"
        gone = OPT_OUTS[key]
    else:
        gone = ()
    before = len(_samplers())
    app = build_app(env, engine=idle_engine)
    app.start()
    try:
        for path in ROUTES:
            status, _, _ = _call(app.http_port, "GET", path)
            assert status == (404 if path in gone else 200), path
        started = len(_samplers()) - before
        assert started == (0 if "/debug/hostprof" in gone else 1)
    finally:
        app.shutdown()
        idle_engine.start()     # the app's shutdown drained and stopped it
    assert len(_samplers()) == before     # the sampler stopped with it
