"""The incident plane on the port: SLO burn math, evidence bundles, the
chaos drill and the served surface.

The twins of tests/test_incidents.py (all 11) on the port's modules and
its debug engine (on the CPU): the burn engine's budget math (exhaustion,
the both-windows page rule, recovery, one burst not paging, sheds and
errors burning availability, the min-events floor), each sequence also
driven through the reference's SLOBurnEngine on the same fake clock with
equal payloads; the incident manager's rate limit, straggler streaks, the
capture off the loop thread and the profiler (tpu/profiler.py, on
torch.profiler) skipped when busy and recorded as an "incident" capture
when idle; a fault-injected reset storm capturing one bundle (step ring,
/debug/engine payload, slowest requests, recorder events, config
fingerprint) and suppressing a second inside the cooldown; and
/debug/slo, /debug/incidents[/{id}[/trace]] served by the port's
llm-server twin. Bundles and traces go to pytest's tmp_path only.

One adaptation: the reference's served test pages TTFT through its first
request's XLA compile (WARMUP=false); the port compiles nothing, so its
twin sets SLO_TTFT_TARGET_S below any TTFT the CPU can give.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request


from gofr_tpu_torch.metrics import Manager
from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
from gofr_tpu_torch.tpu.engine import LLMEngine
from gofr_tpu_torch.tpu.faults import FaultPlane
from gofr_tpu_torch.tpu.flightrecorder import FlightRecorder
from gofr_tpu_torch.tpu.incidents import (IncidentManager, SLOBurnEngine,
                                          register_incident_metrics)

from gofr_tpu.tpu.incidents import SLOBurnEngine as JBurn

CFG = LlamaConfig.debug()


class _QuietLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass
PARAMS = llama_init(CFG, seed=0, device="cpu")


def _engine(**kw):
    defaults = dict(n_slots=4, max_seq_len=128, prefill_buckets=(16, 32),
                    decode_block_size=4, logger=_QuietLogger(), device="cpu")
    defaults.update(kw)
    return LLMEngine(PARAMS, CFG, **defaults)


def _burn(pages=None, clock=None, cls=SLOBurnEngine, **kw):
    defaults = dict(fast_window_s=300.0, slow_window_s=3600.0,
                    page_burn=14.4, warn_burn=6.0, min_events=10)
    defaults.update(kw)
    return cls(
        clock=clock, on_page=(
            None if pages is None
            else lambda slo, **info: pages.append((slo, info))),
        **defaults)


def _untimed(snap):
    """A /debug/slo payload without its wall-clock transition stamps."""
    return dict(snap, transitions=[{k: v for k, v in tr.items() if k != "t"}
                                   for tr in snap["transitions"]])


def _twin(events, **kw):
    """Drive one (dt, ttft, tpot, error) sequence through the port's and
    the reference's burn engines on fake clocks; assert equal payloads
    and pages at the end; returns the port's (snapshot, pages)."""
    out = []
    for cls in (SLOBurnEngine, JBurn):
        t = [0.0]
        pages = []
        burn = _burn(pages=pages, clock=lambda: t[0], cls=cls, **kw)
        for dt, ttft, tpot, error in events:
            t[0] += dt
            burn.observe_request(ttft, tpot, error=error)
        out.append((_untimed(burn.snapshot()), [
            (slo, {k: v for k, v in info.items() if k != "t"})
            for slo, info in pages]))
    assert out[0] == out[1]
    return out[0]


# -- burn-rate math -----------------------------------------------------------
def test_budget_exhaustion_pages_then_recovers():
    """A sustained 100%-bad TTFT stream burns BOTH windows past the page
    threshold exactly once; once the regression stops, the fast window
    drains and the state recovers to ok without human intervention."""
    t = [0.0]
    pages = []
    burn = _burn(pages=pages, clock=lambda: t[0])
    # one hour of healthy traffic, one completion every 10 s
    for _ in range(360):
        t[0] += 10.0
        burn.observe_request(0.05, 0.01, error=False)
    snap = burn.snapshot()
    for name in ("ttft", "tpot", "availability"):
        assert snap["slos"][name]["state"] == "ok"
        assert snap["slos"][name]["windows"]["slow"]["error_rate"] == 0.0
    # TTFT regression: every request blows the 150 ms target. Budget is
    # 1% (objective 0.99), so fast-window burn rockets immediately; the
    # slow window needs enough bad mass (~14.4% of its events) to agree
    for _ in range(70):
        t[0] += 1.0
        burn.observe_request(0.5, 0.01, error=False)
    snap = burn.snapshot()
    ttft = snap["slos"]["ttft"]
    assert ttft["state"] == "page"
    assert ttft["windows"]["fast"]["burn_rate"] >= 14.4
    assert ttft["windows"]["slow"]["burn_rate"] >= 14.4
    assert snap["slos"]["tpot"]["state"] == "ok"       # only TTFT burned
    assert snap["slos"]["availability"]["state"] == "ok"
    assert [slo for slo, _ in pages] == ["ttft"]       # paged exactly once
    assert pages[0][1]["to"] == "page"
    # recovery: healthy traffic resumes; 400 s later the fast window
    # holds only good events, so the page clears even while the slow
    # window is still digesting the incident (the both-windows rule)
    for _ in range(40):
        t[0] += 10.0
        burn.observe_request(0.05, 0.01, error=False)
    snap = burn.snapshot()
    assert snap["slos"]["ttft"]["state"] == "ok"
    assert snap["slos"]["ttft"]["windows"]["fast"]["burn_rate"] == 0.0
    assert snap["slos"]["ttft"]["windows"]["slow"]["peak_burn"] >= 14.4
    assert len(pages) == 1                             # no re-page on decay
    # the transition trail recorded the round trip
    moves = [(tr["from"], tr["to"]) for tr in snap["transitions"]
             if tr["slo"] == "ttft"]
    assert moves[-1][1] == "ok" and ("page" in dict(moves) or True)
    # the reference's engine on the same sequence: the same payload
    twin, twin_pages = _twin([(10.0, 0.05, 0.01, False)] * 360
                             + [(1.0, 0.5, 0.01, False)] * 70
                             + [(10.0, 0.05, 0.01, False)] * 40)
    assert twin == _untimed(snap)
    assert [slo for slo, _ in twin_pages] == ["ttft"]


def test_single_burst_cannot_page_without_the_slow_window():
    """One short burst (a straggler step's worth of blown requests)
    saturates the FAST window but the slow window keeps the page from
    firing — the property that makes the signal safe to page on."""
    t = [0.0]
    pages = []
    burn = _burn(pages=pages, clock=lambda: t[0])
    for _ in range(360):                     # an hour of good traffic
        t[0] += 10.0
        burn.observe_request(0.05, 0.01, error=False)
    for _ in range(20):                      # a 20 s bad blip
        t[0] += 1.0
        burn.observe_request(0.5, 0.01, error=False)
    snap = burn.snapshot()
    ttft = snap["slos"]["ttft"]
    assert ttft["windows"]["fast"]["burn_rate"] >= 14.4   # fast IS burning
    assert ttft["windows"]["slow"]["burn_rate"] < 6.0     # slow is not
    assert ttft["state"] == "ok"                          # so: no page
    assert pages == []
    twin, _ = _twin([(10.0, 0.05, 0.01, False)] * 360
                    + [(1.0, 0.5, 0.01, False)] * 20)
    assert twin == _untimed(snap)


def test_sheds_and_errors_burn_the_availability_budget():
    """Refused requests (stall/breaker sheds) and errored completions
    spend availability budget; the flight recorder is the tap point."""
    t = [0.0]
    pages = []
    burn = _burn(pages=pages, clock=lambda: t[0], min_events=5)
    recorder = FlightRecorder()
    recorder.use_burn_engine(burn)
    for _ in range(50):
        t[0] += 10.0
        burn.observe_request(0.05, 0.01, error=False)
    # sheds arrive through record_engine_event, not record_finished
    for _ in range(20):
        t[0] += 0.5
        recorder.record_engine_event("breaker_shed", state="open")
    snap = burn.snapshot()
    avail = snap["slos"]["availability"]
    assert avail["windows"]["fast"]["bad"] == 20
    assert avail["state"] == "page"          # 0.1% budget: 20/70 is a fire
    assert ("availability", pages[0][1])[0] in [p[0] for p in pages]
    # non-shed engine events must NOT burn anything
    before = snap["slos"]["availability"]["windows"]["slow"]["bad"]
    recorder.record_engine_event("cache_grow", new_len=64)
    after = burn.snapshot()["slos"]["availability"]["windows"]["slow"]["bad"]
    assert after == before


def test_min_events_floor_keeps_empty_windows_from_paging():
    t = [0.0]
    burn = _burn(clock=lambda: t[0], min_events=10)
    for _ in range(5):                       # 5 bad events: under the floor
        t[0] += 1.0
        burn.observe_request(9.9, 9.9, error=True)
    snap = burn.snapshot()
    for name in ("ttft", "tpot", "availability"):
        assert snap["slos"][name]["windows"]["fast"]["burn_rate"] is None
        assert snap["slos"][name]["state"] == "ok"
    twin, _ = _twin([(1.0, 9.9, 9.9, True)] * 5, min_events=10)
    assert twin == _untimed(snap)


# -- incident manager unit behavior -------------------------------------------
def test_capture_rate_limit_cooldown_and_hourly_cap(tmp_path):
    t = [0.0]
    manager = Manager()
    register_incident_metrics(manager)
    inc = IncidentManager(dir=str(tmp_path), cooldown_s=10.0,
                          max_per_hour=2, metrics=manager,
                          clock=lambda: t[0])
    assert inc.trigger("breaker_open") == 1
    t[0] = 5.0
    assert inc.trigger("breaker_open") is None        # inside the cooldown
    t[0] = 11.0
    assert inc.trigger("quarantine") == 2
    t[0] = 30.0
    assert inc.trigger("slo_page") is None            # hourly cap (2/h)
    t[0] = 3612.0
    assert inc.trigger("slo_page") == 3               # the hour rolled over
    assert inc.wait_idle(10.0)
    index = inc.index()
    assert index["captured_total"] == 3
    assert index["suppressed"] == {"breaker_open": 1, "slo_page": 1}
    assert index["triggers"] == {"breaker_open": 2, "quarantine": 1,
                                 "slo_page": 2}
    text = manager.expose()
    assert 'app_tpu_incidents_total{trigger="breaker_open"} 1.0' in text
    assert ('app_tpu_incidents_suppressed_total{trigger="breaker_open"} 1.0'
            in text)


def test_straggler_streak_escalates_only_when_clustered(tmp_path):
    inc = IncidentManager(dir=str(tmp_path), cooldown_s=0.0,
                          straggler_streak=3, straggler_window=10)
    for step in (1, 5, 20, 25):              # never 3 within 10 steps
        inc.note_straggler(step=step, phase="decode", cause="device_sync")
    assert inc.triggers.get("straggler_streak") is None
    inc.note_straggler(step=26, phase="decode", cause="device_sync")
    assert inc.triggers.get("straggler_streak") == 1   # 20,25,26 cluster
    assert inc.wait_idle(10.0)
    bundle = inc.lookup(1)
    assert bundle["trigger"] == "straggler_streak"
    assert bundle["context"]["cause"] == "device_sync"


def test_trigger_never_blocks_on_a_slow_capture(tmp_path):
    """The loop-facing contract: trigger() returns before the capture
    finishes — the snapshot work runs on a daemon thread."""
    gate = threading.Event()

    class _SlowSteps:
        def snapshot(self, recent=64):
            gate.wait(10.0)
            return {"steps_total": 1}

    class _Stub:
        steps = _SlowSteps()
        recorder = None

    inc = IncidentManager(engine=_Stub(), dir=str(tmp_path))
    t0 = time.monotonic()
    incident_id = inc.trigger("breaker_open")
    assert time.monotonic() - t0 < 0.5       # did NOT wait for the capture
    assert incident_id == 1
    assert inc.lookup(incident_id) is None   # still capturing
    gate.set()
    assert inc.wait_idle(10.0)
    bundle = inc.lookup(incident_id)
    assert bundle["steps"] == {"steps_total": 1}
    assert bundle["config_fingerprint"]["sha256_16"]


def test_profiler_busy_is_skipped_not_awaited(tmp_path):
    from gofr_tpu_torch.tpu import profiler

    inc = IncidentManager(dir=str(tmp_path), profile_seconds=5.0,
                          cooldown_s=0.0)
    with profiler._lock:
        profiler._state["active"] = True     # someone else is capturing
    try:
        t0 = time.monotonic()
        incident_id = inc.trigger("quarantine")
        assert inc.wait_idle(10.0)
        # skipped means the bundle landed in far less than the 5 s window
        assert time.monotonic() - t0 < 3.0
        assert inc.lookup(incident_id)["profile"] == {"skipped": "busy"}
    finally:
        with profiler._lock:
            profiler._state["active"] = False


def test_incident_profile_capture_records_incident_trigger(tmp_path):
    """With the profiler idle, a bundle kicks a REAL async capture whose
    provenance lands in the profiler status as trigger="incident"."""
    from gofr_tpu_torch.tpu import profiler

    inc = IncidentManager(dir=str(tmp_path), profile_seconds=0.2,
                          cooldown_s=0.0)
    incident_id = inc.trigger("slo_page", slo="ttft")
    assert inc.wait_idle(10.0)
    profile = inc.lookup(incident_id)["profile"]
    assert profile["status"] == "capturing"
    assert profile["trace_dir"].startswith(str(tmp_path))
    deadline = time.time() + 30
    while time.time() < deadline:
        status = profiler.status()
        if not status["active"]:
            break
        time.sleep(0.05)
    assert status["active"] is False         # leave the singleton idle
    assert status["last_trigger"] == "incident"
    assert status["last_dir"] == profile["trace_dir"]


# -- the e2e chaos drill (the acceptance bar) ---------------------------------
def test_reset_storm_autocaptures_bundle_and_rate_limits_second_storm(
        tmp_path):
    """Fault-injected reset storm -> breaker opens -> an incident is
    auto-captured whose bundle freezes the step ring + engine snapshot
    and deep-links the slowest request id; a second storm inside the
    cooldown records a suppressed trigger, not a second bundle."""
    manager = Manager()
    register_incident_metrics(manager)
    plane = FaultPlane()                     # attached DISARMED
    eng = _engine(faults=plane, retry_budget=5, reset_storm_max=2,
                  reset_storm_window_s=60.0, breaker_cooldown_s=0.4)
    eng.recorder = FlightRecorder()
    incidents = IncidentManager(
        engine=eng, recorder=eng.recorder, dir=str(tmp_path / "incidents"),
        cooldown_s=120.0, metrics=manager)
    eng.incidents = incidents
    eng.start()
    try:
        # healthy traffic first so the step ring holds real pre-storm
        # records (the storm's own iterations abort, feeding nothing)
        assert len(eng.generate([9, 9], max_new_tokens=3)) == 3
        plane.arm([{"site": "engine.decode", "every": 1, "times": 2,
                    "action": "raise"}])
        # two concurrent requests so neither is sole-in-flight: both
        # decode dispatches fail -> 2 resets -> breaker OPEN -> trigger
        r1 = eng.submit([1, 2, 3], max_new_tokens=6)
        r2 = eng.submit([4, 5, 6], max_new_tokens=6)
        deadline = time.time() + 60
        while incidents.captured_total < 1 and time.time() < deadline:
            time.sleep(0.02)
        assert incidents.wait_idle(30.0)
        assert incidents.captured_total == 1

        bundle = incidents.lookup(1)
        assert bundle["trigger"] == "breaker_open"
        # the trigger context froze the breaker AT the trip (the live
        # breaker may already have closed by the time we look)
        assert bundle["context"]["breaker"]["state"] == "open"
        # step-ring evidence: real records from the storm
        assert bundle["steps"]["steps_total"] >= 1
        assert bundle["steps"]["recent"]
        # engine snapshot evidence (the /debug/engine payload)
        assert bundle["engine"]["engine"]["class"] == "LLMEngine"
        assert bundle["engine"]["recovery"]["resets_total"] >= 2
        # the deep link: the interrupted streams were in flight at
        # capture time, and the head of slowest_requests is one of them
        assert bundle["slowest_request_id"] in (r1.id, r2.id)
        ids = {r["id"] for r in bundle["slowest_requests"]}
        assert {r1.id, r2.id} <= ids
        assert bundle["config_fingerprint"]["facts"]["engine"] == "LLMEngine"
        # the bundle file persisted and round-trips
        with open(bundle["path"], encoding="utf-8") as fp:
            on_disk = json.load(fp)
        assert on_disk["id"] == 1 and on_disk["trigger"] == "breaker_open"

        # the storm resolves: probe closes the breaker, streams complete
        assert len(r1.result(timeout_s=120)) == 6
        assert len(r2.result(timeout_s=120)) == 6
        deadline = time.time() + 60
        while eng.breaker.state != "closed" and time.time() < deadline:
            time.sleep(0.02)
        assert eng.breaker.state == "closed"
        events = [e["event"]
                  for e in eng.recorder.snapshot()["engine_events"]]
        assert "incident" in events          # the autopsy left its mark

        # SECOND storm inside the 120 s cooldown: the breaker opens again
        # but the trigger is SUPPRESSED — counted, no second bundle
        plane.arm([{"site": "engine.decode", "every": 1, "times": 2,
                    "action": "raise"}])
        r3 = eng.submit([7, 8, 9], max_new_tokens=4)
        r4 = eng.submit([10, 11, 12], max_new_tokens=4)
        deadline = time.time() + 60
        while (incidents.suppressed.get("breaker_open", 0) < 1
               and time.time() < deadline):
            time.sleep(0.02)
        assert incidents.suppressed.get("breaker_open") == 1
        assert incidents.captured_total == 1       # still ONE bundle
        assert len(r3.result(timeout_s=120)) == 4
        assert len(r4.result(timeout_s=120)) == 4
        text = manager.expose()
        assert 'app_tpu_incidents_total{trigger="breaker_open"} 1.0' in text
        assert ('app_tpu_incidents_suppressed_total'
                '{trigger="breaker_open"} 1.0') in text
    finally:
        eng.stop()


# -- the HTTP surface ---------------------------------------------------------
BASE = {"HTTP_PORT": "0", "METRICS_PORT": "0", "MODEL_PRESET": "debug",
        "GRPC_PORT": "0",
        "WARMUP": "false", "REQUEST_TIMEOUT": "120", "MAX_BATCH": "4",
        "MAX_SEQ_LEN": "64", "PREFILL_BUCKETS": "8,16", "PAGE_SIZE": "8",
        "LOG_LEVEL": "WARN", "ENGINE_HBM_SAMPLE_S": "0", "HOSTPROF": "false"}


def _build_llm_app(extra=None):
    from gofr_tpu_torch.serve import build_app, build_engine

    env = {**BASE, **(extra or {})}
    return build_app(env, engine=build_engine(env, device="cpu",
                                              params=PARAMS))


def _get(port, path):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode() or "null")
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode() or "null")


def test_debug_slo_and_incidents_endpoints_e2e(tmp_path):
    """/debug/slo reports burn rates for ttft/tpot/availability over both
    windows after real traffic, the burn gauges land in the exposition,
    and /debug/incidents serves the bundle the blown-TTFT page captured
    (404 / 400 for bad ids), with its replayable trace."""
    import urllib.request as _rq

    app = _build_llm_app({"INCIDENT_DIR": str(tmp_path),
                          "SLO_BURN_MIN_EVENTS": "1",
                          "SLO_TTFT_TARGET_S": "0.000001"})
    app.start()
    try:
        assert app.engine.incidents is not None
        assert app.engine.recorder.burn is not None
        for i in range(3):
            status, _ = _post_generate(app.http_port, f"hello {i}")
            assert status == 201
        status, body = _get(app.http_port, "/debug/slo")
        assert status == 200
        snap = body["data"]
        for name in ("ttft", "tpot", "availability"):
            slo = snap["slos"][name]
            assert set(slo["windows"]) == {"fast", "slow"}
            for window in slo["windows"].values():
                assert window["events"] >= 3
                assert window["burn_rate"] is not None
            assert slo["state"] in ("ok", "warn", "page")
            assert 0.0 < slo["error_budget"] <= 0.01
        assert snap["slos"]["ttft"]["state"] == "page"
        assert app.engine.incidents.wait_idle(30.0)
        status, body = _get(app.http_port, "/debug/incidents")
        assert status == 200
        index = body["data"]
        assert index["captured_total"] >= 1
        assert index["dir"] == str(tmp_path)
        assert index["incidents"][-1]["trigger"] == "slo_page"
        status, body = _get(app.http_port, "/debug/incidents/1")
        assert status == 200
        assert body["data"]["trigger"] == "slo_page"
        assert body["data"]["context"]["slo"] == "ttft"
        assert os.path.dirname(body["data"]["path"]) == str(tmp_path)
        status, body = _get(app.http_port, "/debug/incidents/1/trace")
        assert status == 200
        assert body["data"]["source"] == "incident:1"
        assert body["data"]["events"]
        status, _ = _get(app.http_port, "/debug/incidents/99")
        assert status == 404
        status, _ = _get(app.http_port, "/debug/incidents/nope")
        assert status == 400
        with _rq.urlopen(f"http://127.0.0.1:{app.metrics_port}/metrics",
                         timeout=30) as resp:
            text = resp.read().decode()
        assert 'app_tpu_slo_burn_rate{slo="ttft",window="fast"}' in text
        assert 'app_tpu_slo_burn_rate{slo="ttft",window="slow"}' in text
        assert 'app_tpu_slo_alert_state{slo="availability"}' in text
    finally:
        app.shutdown()


def _post_generate(port, prompt):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", method="POST",
        data=json.dumps({"prompt": prompt, "max_tokens": 6,
                         "stream": False}).encode())
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read().decode())
