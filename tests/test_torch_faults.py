"""Crash-only serving on the port: fault injection, replay after a reset,
quarantine and the reset-storm breaker.

The twins of tests/test_faults.py on the port's engines (debug preset, on
the CPU): the fault plane's rules and the breaker's state machine (held
against the reference's classes on the same inputs), concurrent streams
riding out a mid-decode reset, the paged engine re-reserving pages for its
replays, a zero retry budget, poison quarantine, a reset storm opening the
breaker and the half-open probe closing it (and re-opening it once), the
executor's compile site, the zero-overhead default and /debug/faults,
gated on FAULT_INJECTION, with /generate surviving a drill and a breaker
shed answered 503 with Retry-After, and the device client's health probe
(the ``device.health_probe`` site) wedged and failed beside the
reference's ``TPUClient`` under the same plans
(``test_health_probe_wedge_degrades_then_recovers``).

Engine against engine: the same fault plan on the JAX LLMEngine /
PagedLLMEngine and on the port's, with the weights bridged by
``params_from_numpy``, gives the same greedy streams (computed live), the
same reset, replay, replayed-token and quarantine counts, the same breaker
transitions and the same recorder events. The port restores its device
state in place: across a reset every tensor a captured program reads keeps
its address and nothing is captured again; a reset whose restore raises
(what a dead CUDA context does) counts as one more reset, and with a
failing probe the breaker stays open, health reads DOWN and submit sheds
while the loop thread lives on.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import pytest

from gofr_tpu.models.llama import LlamaConfig as JConfig
from gofr_tpu.models.llama import llama_init as jax_init
from gofr_tpu.tpu import faults as jfaults
from gofr_tpu.tpu.engine import LLMEngine as JEngine
from gofr_tpu.tpu.flightrecorder import FlightRecorder as JRecorder
from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
from gofr_tpu_torch.container import STATUS_DOWN, STATUS_UP
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.tpu.engine import (CacheLostError, DeviceLostError,
                                       LLMEngine)
from gofr_tpu_torch.tpu.executor import Executor
from gofr_tpu_torch.tpu.faults import (FaultPlane, InjectedFault,
                                       ResetStormBreaker)
from gofr_tpu_torch.tpu.flightrecorder import FlightRecorder
from gofr_tpu_torch.tpu.paging import PagedLLMEngine

CFG = LlamaConfig.debug()


class _QuietLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


@pytest.fixture(scope="module")
def weights():
    jparams = jax_init(JConfig.debug(), seed=0)
    return jparams, params_from_numpy(jax.device_get(jparams), device="cpu")


def _engine(params, **kw):
    defaults = dict(n_slots=8, max_seq_len=128, prefill_buckets=(16, 32),
                    decode_block_size=4, logger=_QuietLogger(),
                    device="cpu")
    defaults.update(kw)
    return LLMEngine(params, CFG, **defaults)


# -- fault plane unit behavior ------------------------------------------------
def _pattern(module, seed):
    p = module.FaultPlane(plan=[{"site": "s", "prob": 0.5, "times": 0}],
                          seed=seed)
    out = []
    for _ in range(64):
        try:
            p.hit("s")
            out.append(0)
        except module.InjectedFault:
            out.append(1)
    return out


def test_fault_plane_rules_deterministic_and_bounded():
    plane = FaultPlane(plan=[{"site": "engine.decode", "nth": 3}])
    plane.hit("engine.decode")
    plane.hit("engine.decode")
    with pytest.raises(InjectedFault):
        plane.hit("engine.decode")
    plane.hit("engine.decode")   # times defaults to 1: rule exhausted
    snap = plane.snapshot()
    assert snap["hits"]["engine.decode"] == 4
    assert snap["rules"][0]["fired"] == 1
    assert snap["fired"][0]["hit"] == 3

    lag = FaultPlane(plan=[{"site": "engine.sync", "action": "delay",
                            "delay_s": 0.05, "times": 1}])
    t0 = time.time()
    lag.hit("engine.sync")
    assert time.time() - t0 >= 0.04

    # the seeded RNG: the same pattern per seed, and the reference's
    from gofr_tpu_torch.tpu import faults as tfaults

    assert _pattern(tfaults, 42) == _pattern(tfaults, 42)
    assert _pattern(tfaults, 42) != _pattern(tfaults, 43)
    assert _pattern(tfaults, 42) == _pattern(jfaults, 42)

    with pytest.raises(ValueError):
        FaultPlane(plan=[{"site": "s", "action": "explode"}])
    with pytest.raises(ValueError):
        FaultPlane(plan=[{"site": "s", "nth": 1, "every": 2}])
    assert tfaults.KNOWN_SITES == jfaults.KNOWN_SITES


def _breaker_drill(cls):
    """The reference's state-machine drill; returns every observation."""
    t = [0.0]
    br = cls(max_resets=2, window_s=10.0, cooldown_s=5.0,
             clock=lambda: t[0])
    seen = [br.reject_for(), br.blocked(), br.record_reset()]
    t[0] = 1.0
    seen += [br.record_reset(), br.blocked(), br.state, br.state_code,
             br.reject_for(), br.probe_due()]
    t[0] = 6.5
    seen += [br.probe_due(), br.probe_due(), br.reject_for()]
    br.probe_failed()
    seen.append(br.state)
    t[0] = 12.0
    seen += [br.probe_due(), br.probe_ok(), br.state, br.reject_for()]
    t[0] = 100.0
    seen.append(br.record_reset())
    t[0] = 200.0
    seen.append(br.record_reset())
    t[0] = 300.0
    br.record_reset()
    t[0] = 300.1
    seen.append(br.record_reset())
    t[0] = 306.0
    seen += [br.probe_due(), br.record_reset(), br.state, br.probe_ok(),
             br.state, br.snapshot()]
    off = cls(max_resets=0)
    seen += [[off.record_reset() for _ in range(10)], off.reject_for()]
    return seen


def test_breaker_state_machine():
    seen = _breaker_drill(ResetStormBreaker)
    assert seen == _breaker_drill(jfaults.ResetStormBreaker)
    assert seen[:3] == [None, False, False]
    assert seen[3:7] == [True, True, "open", 2]
    assert seen[7] >= 0.5 and seen[8] is False
    assert seen[9:11] == [True, False] and seen[11] is not None
    assert seen[12] == "open"
    assert seen[13:17] == [True, True, "closed", None]
    assert seen[17:19] == [False, False]
    assert seen[19] is True
    assert seen[20:25] == [True, False, "open", False, "open"]
    assert seen[26] == [False] * 10 and seen[27] is None


# -- replay after reset -------------------------------------------------------
def test_concurrent_streams_survive_mid_decode_reset(weights):
    plane = FaultPlane(plan=[{"site": "engine.decode", "nth": 2,
                              "action": "raise"}], seed=7)
    eng = _engine(weights[1], faults=plane, retry_budget=2)
    eng.recorder = FlightRecorder()
    eng.start()
    N, M = 8, 12
    results, reqs, errors = {}, {}, []

    def client(i):
        try:
            req = eng.submit([1 + i, 2 + i, 3 + i], max_new_tokens=M)
            reqs[i] = req
            results[i] = list(req.stream(timeout_s=120))
        except Exception as exc:  # noqa: BLE001 - the gate below
            errors.append((i, exc))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(N)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    try:
        assert not errors, errors
        for i in range(N):
            assert len(results[i]) == M, (i, len(results[i]))
        assert eng.resets_total >= 1
        assert eng.replays_total >= 1
        events = [e["event"]
                  for e in eng.recorder.snapshot()["engine_events"]]
        assert "device_reset" in events
        replayed = [i for i, req in reqs.items() if req.replays > 0]
        assert replayed, "no request ever replayed"
        detail = eng.recorder.lookup(reqs[replayed[0]].id)
        names = [e["event"] for e in detail["events"]]
        assert "replayed" in names
        assert names.count("finished") == 1
    finally:
        eng.stop()


def test_paged_engine_replays_and_rereserves_pages(weights):
    plane = FaultPlane(plan=[{"site": "engine.decode", "nth": 2,
                              "action": "raise"}])
    eng = PagedLLMEngine(weights[1], CFG, n_slots=4, max_seq_len=64,
                         prefill_buckets=(16,), decode_block_size=4,
                         page_size=8, prefix_cache=True, device="cpu",
                         logger=_QuietLogger(), faults=plane,
                         retry_budget=2)
    eng.recorder = FlightRecorder()
    eng.start()
    shared = list(range(1, 12))
    results, errors = {}, []

    def client(i):
        try:
            req = eng.submit(shared + [40 + i], max_new_tokens=10)
            results[i] = list(req.stream(timeout_s=120))
        except Exception as exc:  # noqa: BLE001
            errors.append((i, exc))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    try:
        assert not errors, errors
        for i in range(4):
            assert len(results[i]) == 10, (i, len(results[i]))
        assert eng.resets_total >= 1 and eng.replays_total >= 1
        # no leaked pages once the idle prefix-cache pages are dropped
        eng.allocator.release(eng.prefix.drop_all_idle())
        assert eng.allocator.used_pages == 0
    finally:
        eng.stop()


def test_retry_budget_zero_fails_on_first_reset(weights):
    plane = FaultPlane(plan=[{"site": "engine.decode", "nth": 1}])
    eng = _engine(weights[1], faults=plane, retry_budget=0)
    eng.start()
    try:
        req = eng.submit([1, 2, 3], max_new_tokens=8)
        with pytest.raises(CacheLostError):
            list(req.stream(timeout_s=60))
        assert eng.replays_total == 0
    finally:
        eng.stop()


def test_poison_request_quarantined_without_third_reset(weights):
    plane = FaultPlane(plan=[{"site": "engine.decode", "every": 1,
                              "times": 5, "action": "raise"}])
    eng = _engine(weights[1], faults=plane, retry_budget=5)
    eng.recorder = FlightRecorder()
    eng.start()
    try:
        req = eng.submit([1, 2, 3], max_new_tokens=8)
        with pytest.raises(CacheLostError):
            list(req.stream(timeout_s=120))
        assert eng.resets_total == 2, eng.resets_total
        assert eng.quarantined_total == 1
        names = [e["event"] for e in eng.recorder.lookup(req.id)["events"]]
        assert "replayed" in names and "quarantined" in names
        plane.disarm()
        assert len(eng.generate([5, 6], max_new_tokens=3)) == 3
    finally:
        eng.stop()


# -- reset-storm breaker end-to-end -------------------------------------------
def _wait(cond, timeout=60.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.02)
    return cond()


def test_reset_storm_opens_breaker_then_half_open_probe_closes(weights):
    plane = FaultPlane(plan=[{"site": "engine.decode", "every": 1,
                              "times": 2, "action": "raise"}])
    eng = _engine(weights[1], n_slots=4, faults=plane, retry_budget=5,
                  reset_storm_max=2, reset_storm_window_s=60.0,
                  breaker_cooldown_s=0.4)
    eng.recorder = FlightRecorder()
    eng.start()
    try:
        r1 = eng.submit([1, 2, 3], max_new_tokens=6)
        r2 = eng.submit([4, 5, 6], max_new_tokens=6)
        assert _wait(lambda: eng.breaker.state == "open")
        with pytest.raises(DeviceLostError) as ei:
            eng.submit([7, 8], max_new_tokens=2)
        assert ei.value.status_code == 503
        assert ei.value.retry_after_s > 0
        health = eng.health_check()
        assert health.status == STATUS_DOWN
        assert health.details["breaker"]["state"] in ("open", "half_open")
        assert _wait(lambda: eng.breaker.state == "closed")
        assert len(r1.result(timeout_s=120)) == 6
        assert len(r2.result(timeout_s=120)) == 6
        assert len(eng.generate([9, 10], max_new_tokens=3)) == 3
        assert eng.health_check().status == STATUS_UP
        events = [e["event"]
                  for e in eng.recorder.snapshot()["engine_events"]]
        assert "breaker_open" in events and "breaker_closed" in events
        assert "breaker_shed" in events
    finally:
        eng.stop()


def test_failed_half_open_probe_reopens(weights):
    plane = FaultPlane(plan=[
        {"site": "engine.decode", "every": 1, "times": 2, "action": "raise"},
        {"site": "engine.probe", "nth": 1, "action": "raise"},
    ])
    eng = _engine(weights[1], n_slots=4, faults=plane, retry_budget=5,
                  reset_storm_max=2, breaker_cooldown_s=0.2)
    eng.recorder = FlightRecorder()
    eng.start()
    try:
        r1 = eng.submit([1, 2, 3], max_new_tokens=4)
        r2 = eng.submit([4, 5, 6], max_new_tokens=4)
        assert _wait(lambda: eng.breaker.state == "closed"
                     and eng.resets_total == 2)
        assert len(r1.result(timeout_s=120)) == 4
        assert len(r2.result(timeout_s=120)) == 4
        events = [e["event"]
                  for e in eng.recorder.snapshot()["engine_events"]]
        assert "breaker_probe_failed" in events
        assert "breaker_closed" in events
    finally:
        eng.stop()


# -- other hook sites ---------------------------------------------------------
def test_executor_compile_latency_injection():
    import torch

    ex = Executor("cpu")
    ex.faults = FaultPlane(plan=[{"site": "executor.compile",
                                  "action": "delay", "delay_s": 0.05,
                                  "times": 1}])
    x = torch.ones(4)
    t0 = time.time()
    program = ex.compile("lagged", lambda v: v + 1, (x,))
    assert time.time() - t0 >= 0.04
    assert float(program()[0]) == 2.0
    assert ex.faults.snapshot()["hits"]["executor.compile"] == 1


def _probe_drill(client, plane_cls):
    """The reference's drill on one client: UP; a wedge held past the
    probe's timeout is DEGRADED ("not answering"), and UP again once it
    ends; a raise is DOWN, not a crash. Returns the statuses seen."""
    client.HEALTH_PROBE_TIMEOUT_S = 0.2
    seen = [client.health_check().status]
    client.faults = plane_cls(plan=[{"site": "device.health_probe",
                                     "action": "wedge", "delay_s": 0.6,
                                     "times": 1}])
    h = client.health_check()
    seen.append(h.status)
    assert "not answering" in h.details["error"]
    client._probe_thread.join(timeout=10)
    seen.append(client.health_check().status)
    client.faults = plane_cls(plan=[{"site": "device.health_probe",
                                     "action": "raise", "times": 1}])
    deadline = time.time() + 10
    status = None
    while time.time() < deadline:
        status = client.health_check().status
        if status == STATUS_DOWN:
            break
        time.sleep(0.05)
    seen.append(status)
    client.faults = None
    seen.append(client.health_check().status)
    return seen


def test_health_probe_wedge_degrades_then_recovers():
    """The reference's test on the port's device client (on the CPU),
    beside the reference's TPUClient under the same plans: the
    single-flight probe wedged answers DEGRADED within its timeout, the
    next poll after the wedge is UP, a raise-action rule is DOWN, and the
    probe comes back UP once the plane is gone."""
    from gofr_tpu.tpu.device import TPUClient
    from gofr_tpu_torch.tpu.device import CUDAClient

    ref = TPUClient()
    ref.connect()
    port = CUDAClient(device="cpu")
    port.connect()
    want = _probe_drill(ref, jfaults.FaultPlane)
    got = _probe_drill(port, FaultPlane)
    assert got == want == [STATUS_UP, "DEGRADED", STATUS_UP, STATUS_DOWN,
                           STATUS_UP]
    assert port.faults is None and CUDAClient(device="cpu").faults is None


def test_disarmed_components_hold_no_plane(weights):
    eng = _engine(weights[1])
    assert eng.faults is None
    assert Executor("cpu").faults is None
    assert eng.executor.faults is None
    eng.start()
    try:
        assert len(eng.generate([1, 2], max_new_tokens=3)) == 3
    finally:
        eng.stop()


# -- HTTP gating --------------------------------------------------------------
def _call(port, path, method="GET", body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), \
                json.loads(resp.read().decode() or "null")
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), \
            json.loads(err.read().decode() or "null")


BASE = {"HTTP_PORT": "0", "METRICS_PORT": "0", "MODEL_PRESET": "debug",
        "GRPC_PORT": "0",
        "WARMUP": "false", "REQUEST_TIMEOUT": "120", "MAX_BATCH": "4",
        "MAX_SEQ_LEN": "64", "PREFILL_BUCKETS": "8,16", "PAGE_SIZE": "8",
        "LOG_LEVEL": "WARN", "ENGINE_HBM_SAMPLE_S": "0", "HOSTPROF": "false"}


def _build_app(weights, extra=None):
    from gofr_tpu_torch.serve import build_app, build_engine

    env = {**BASE, **(extra or {})}
    return build_app(env, engine=build_engine(env, device="cpu",
                                              params=weights[1]))


def test_debug_faults_endpoint_gated_and_drives_a_drill(weights, tmp_path):
    app = _build_app(weights, {"INCIDENT_DIR": str(tmp_path)})
    app.start()
    try:
        status, _, _ = _call(app.http_port, "/debug/faults", "POST",
                             {"plan": []})
        assert status in (403, 404)
        assert app.engine.faults is None
    finally:
        app.shutdown()

    app2 = _build_app(weights, {"FAULT_INJECTION": "true",
                                "FAULT_INJECTION_SEED": "3",
                                "INCIDENT_DIR": str(tmp_path)})
    app2.start()
    try:
        assert app2.engine.faults is not None
        assert app2.engine.executor.faults is app2.engine.faults
        status, _, body = _call(
            app2.http_port, "/debug/faults", "POST",
            {"plan": [{"site": "engine.decode", "nth": 1,
                       "action": "raise"}], "seed": 3})
        assert status == 201, body
        status, _, resp = _call(app2.http_port, "/generate", "POST",
                                {"prompt": "hello", "max_tokens": 6,
                                 "stream": False})
        assert status == 201 and resp["data"]["tokens"] == 6
        assert app2.engine.resets_total >= 1
        status, _, snap = _call(app2.http_port, "/debug/faults")
        assert status == 200
        snap = snap["data"]
        assert snap["rules"][0]["fired"] == 1
        assert snap["fired"][0]["site"] == "engine.decode"
        status, _, es = _call(app2.http_port, "/debug/engine")
        assert status == 200
        es = es["data"]
        assert es["recovery"]["resets_total"] >= 1
        assert es["breaker"]["state"] == "closed"
        assert es["faults"]["rules"][0]["fired"] == 1
        status, _, _ = _call(app2.http_port, "/debug/faults", "POST",
                             {"plan": [{"site": "s", "action": "nope"}]})
        assert status == 400
    finally:
        app2.shutdown()


def test_breaker_shed_maps_to_http_503_with_retry_after(weights, tmp_path):
    from gofr_tpu_torch.http.errors import ServiceUnavailable
    from gofr_tpu_torch.http.responder import Responder
    from gofr_tpu_torch.serve import shed_to_503
    from gofr_tpu_torch.tpu.engine import (EngineDrainingError,
                                           EngineStalledError)

    for exc in (DeviceLostError(7.2), EngineDrainingError(),
                EngineStalledError(200.0)):
        response = Responder("POST").respond(None, shed_to_503(exc))
        assert response.status == 503, type(exc).__name__
        assert int(float(response.headers["Retry-After"])) >= 1
    response = Responder("POST").respond(
        None, ServiceUnavailable("backend busy", retry_after_s=3.0))
    assert response.status == 503

    # an open breaker on a served engine: /generate answers 503 with the
    # breaker's Retry-After and the health aggregate reads DOWN
    app = _build_app(weights, {"INCIDENT_DIR": str(tmp_path)})
    app.start()
    try:
        breaker = app.engine.breaker
        breaker.cooldown_s = 30.0
        for _ in range(breaker.max_resets):
            breaker.record_reset()
        status, headers, body = _call(app.http_port, "/generate", "POST",
                                      {"prompt": "hi", "max_tokens": 2,
                                       "stream": False})
        assert status == 503
        assert float(headers["Retry-After"]) >= 1
        assert "reset-storm breaker open" in body["error"]["message"]
        status, _, health = _call(app.http_port, "/.well-known/health")
        engine_health = health["data"]["details"]["engine"]
        assert engine_health["status"] == STATUS_DOWN
        assert engine_health["details"]["breaker"]["state"] == "open"
        breaker.probe_failed()
        breaker.cooldown_s = 0.0
        assert _wait(lambda: breaker.state == "closed")
    finally:
        app.shutdown()


# -- engine against engine ----------------------------------------------------
ENGINE = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16, 32),
              decode_block_size=4)
PROMPTS = [[5, 6, 7], list(range(9, 18)), [1, 2], list(range(40, 52))]
BUDGETS = [12, 10, 9, 11]
# events of the engine's own pace, not of the plan: the dense reference
# shrinks its cache at a reset and grows it again (the port keeps it)
_PACED = ("cache_grow", "step_straggler")


def _serve(eng, prompts=PROMPTS, budgets=BUDGETS, wait=None):
    """Every request queued before the loop starts (one admission round,
    the same dispatches on both engines); returns what a drill shows."""
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts,
                                                            budgets)]
    eng.start()
    try:
        if wait is not None:
            assert _wait(lambda: wait(eng))
        out = []
        for r in reqs:
            try:
                out.append(r.result(timeout_s=120))
            except Exception as exc:  # noqa: BLE001 - compared by name
                out.append(type(exc).__name__)
    finally:
        eng.stop()
    snap = eng.recorder.snapshot()
    return {
        "streams": out,
        "counts": (eng.resets_total, eng.replays_total,
                   eng.replayed_tokens_total, eng.quarantined_total),
        "replays": [r.replays for r in reqs],
        "engine_events": [e["event"] for e in snap["engine_events"]
                          if e["event"] not in _PACED],
        "request_events": [[e["event"] for e in
                            eng.recorder.lookup(r.id)["events"]]
                           for r in reqs],
    }


def _pair(weights, paged, plan, **kw):
    """(reference, port) drills of one plan on one engine kind."""
    jparams, tparams = weights
    jkw = dict(ENGINE, logger=_QuietLogger(), **kw)
    if paged:
        jkw.update(page_size=8, prefix_cache=True)
    jcls = JPaged if paged else JEngine
    tcls = PagedLLMEngine if paged else LLMEngine
    jeng = jcls(jparams, JConfig.debug(),
                faults=jfaults.FaultPlane(plan=plan), **jkw)
    jeng.recorder = JRecorder()
    teng = tcls(tparams, CFG, device="cpu", faults=FaultPlane(plan=plan),
                **jkw)
    teng.recorder = FlightRecorder()
    return jeng, teng


PLANS = {
    # a reset before any token synced, and one mid-stream
    "decode-early": [{"site": "engine.decode", "nth": 2}],
    "decode-mid": [{"site": "engine.decode", "nth": 6}],
    "sync": [{"site": "engine.sync", "nth": 4}],
    # a failed admission launch: its wave fails (nothing was dispatched)
    "prefill": [{"site": "engine.prefill", "nth": 1}],
    "two-resets": [{"site": "engine.decode", "nth": 3},
                   {"site": "engine.sync", "nth": 9}],
    # a chunk job's second chunk (the 9- and 12-token prompts admit as two
    # jobs of two chunks of 8), a speculative verify, and the dense cache's
    # growth at a decode dispatch (its first growth is at the 16-token
    # wave's admission; the paged pool never grows: no hit, no reset)
    "chunk": [{"site": "engine.chunk", "nth": 3}],
    "verify": [{"site": "engine.verify", "nth": 2}],
    "cache_grow": [{"site": "engine.cache_grow", "nth": 2}],
}
# the engines whose dispatches reach a plan's site
PLAN_ENGINES = {"chunk": dict(chunk_prefill_tokens=8),
                "verify": dict(speculative_tokens=2)}
# tests/test_speculative.py's prompts, with self-repetition (prompt-lookup
# drafts exist) and without, and their budgets
PLAN_PROMPTS = {"verify": ([[5, 6, 7, 8, 5, 6, 7, 8, 5, 6], [9, 8, 7, 6, 5],
                            [11, 12, 11, 12, 11, 12, 11],
                            [3, 1, 4, 1, 5, 9, 2, 6, 3, 1, 4, 1, 5]],
                           [24, 24, 24, 24])}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_fault_plan_replays_as_the_reference(weights, paged, plan):
    jeng, teng = _pair(weights, paged, PLANS[plan],
                       **PLAN_ENGINES.get(plan, {}))
    prompts, budgets = PLAN_PROMPTS.get(plan, (PROMPTS, BUDGETS))
    want = _serve(jeng, prompts, budgets)
    got = _serve(teng, prompts, budgets)
    assert got == want
    if plan != "prefill" and not (paged and plan == "cache_grow"):
        assert got["counts"][0] >= 1 and got["counts"][1] >= 1
        assert all(isinstance(s, list) and len(s) == n
                   for s, n in zip(got["streams"], budgets))
    if plan == "decode-mid":
        assert got["counts"][2] > 0     # delivered tokens re-prefilled


def test_breaker_transitions_match_the_reference(weights):
    plan = [{"site": "engine.decode", "every": 1, "times": 3},
            {"site": "engine.probe", "nth": 1}]
    kw = dict(retry_budget=5, reset_storm_max=2, breaker_cooldown_s=0.2)
    jeng, teng = _pair(weights, True, plan, **kw)
    closed = lambda e: e.breaker.state == "closed" and e.resets_total >= 3  # noqa: E731
    want, got = _serve(jeng, wait=closed), _serve(teng, wait=closed)
    assert got == want
    assert [e for e in got["engine_events"] if e.startswith("breaker")] \
        == ["breaker_open", "breaker_probe_failed", "breaker_closed"]


def test_quarantine_matches_the_reference(weights):
    plan = [{"site": "engine.decode", "every": 1, "times": 5}]
    jeng, teng = _pair(weights, False, plan, retry_budget=5)
    want = _serve(jeng, PROMPTS[:1], BUDGETS[:1])
    got = _serve(teng, PROMPTS[:1], BUDGETS[:1])
    assert got == want
    assert got["counts"] == (2, 1, 0, 1)
    assert got["streams"] == ["CacheLostError"]


# -- the in-place restore -----------------------------------------------------
def _graph_like(fn, inputs):
    """A capture stub that behaves as a graph's replay where the CPU can
    show it: one output tensor every call overwrites."""
    out = []

    def replay():
        got = fn(*inputs)
        if out:
            out[0].copy_(got)
        else:
            out.append(got.clone())
        return out[0]
    return replay


def _addresses(eng):
    """Every tensor a captured program reads or writes, by address."""
    tensors = {"tokens": eng._tokens, "positions": eng._positions,
               "temps": eng._temps}
    for name in ("k_cache", "v_cache"):
        cache = getattr(eng, name)
        if isinstance(cache, list):
            tensors.update({f"{name}{i}": t for i, t in enumerate(cache)})
        else:
            tensors[name] = cache
    for key, views in eng._static.items():
        tensors.update({f"{key}{i}": t for i, t in enumerate(views)})
    for key, bufs in eng._chunk_bufs.items():
        tensors.update({f"chunk{key}{i}": t for i, t in enumerate(bufs)})
    return {k: t.data_ptr() for k, t in tensors.items()}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_reset_keeps_every_graph_read_address(weights, paged):
    kw = dict(page_size=8, prefix_cache=True) if paged else {}
    cls = PagedLLMEngine if paged else LLMEngine
    eng = cls(weights[1], CFG, device="cpu", logger=_QuietLogger(),
              **ENGINE, **kw)
    eng.executor = Executor("cpu", capture=_graph_like)
    eng.warmup(k_variants=True)

    def traffic():
        # queued under the state lock: one admission round, as _serve's
        with eng._state_lock:
            reqs = [eng.submit(p, max_new_tokens=n)
                    for p, n in zip(PROMPTS, BUDGETS)]
        return [r.result(timeout_s=120) for r in reqs]

    eng.start()
    try:
        clean = traffic()
        before, captures = _addresses(eng), eng.executor.captures
        generator = eng.generator
        eng.faults = FaultPlane(plan=[{"site": "engine.decode", "nth": 6},
                                      {"site": "engine.sync", "nth": 11}])
        faulted = traffic()
    finally:
        eng.stop()
    assert eng.resets_total >= 1 and eng.replays_total >= 1
    assert faulted == clean
    assert _addresses(eng) == before
    assert eng.executor.captures == captures
    assert eng.generator is generator
    # seed 0, then one more per reset
    assert eng.generator.initial_seed() == eng.resets_total


def test_dead_context_keeps_the_breaker_open(weights):
    """What a sticky CUDA error does, on the CPU: every launch raises, the
    in-place restore raises (one more reset each time) and so does the
    probe. The breaker opens and stays open, health reads DOWN, submit
    sheds with DeviceLostError, and the loop thread lives on."""
    plane = FaultPlane(plan=[{"site": "engine.decode", "every": 1,
                              "times": 0},
                             {"site": "engine.probe", "every": 1,
                              "times": 0}])
    eng = _engine(weights[1], n_slots=4, faults=plane, retry_budget=1,
                  reset_storm_max=3, breaker_cooldown_s=0.05)

    def dead():
        raise RuntimeError("CUDA error: an illegal memory access")

    eng._restore_device_state = dead
    eng.recorder = FlightRecorder()
    eng.start()
    try:
        reqs = [eng.submit([1, 2, 3], max_new_tokens=4),
                eng.submit([4, 5, 6], max_new_tokens=4)]
        for r in reqs:
            with pytest.raises(CacheLostError):
                r.result(timeout_s=60)
        assert _wait(lambda: plane.snapshot()["hits"].get(
            "engine.probe", 0) >= 2)
        assert eng.breaker.state in ("open", "half_open")
        assert eng.health_check().status == STATUS_DOWN
        with pytest.raises(DeviceLostError):
            eng.submit([7, 8], max_new_tokens=2)
        assert eng._thread.is_alive()
        # each pass counted itself and its failed restore
        assert eng.resets_total >= 4 and eng.resets_total % 2 == 0
        events = [e["event"]
                  for e in eng.recorder.snapshot()["engine_events"]]
        assert "breaker_open" in events
        assert "breaker_probe_failed" in events
        assert "breaker_closed" not in events
    finally:
        eng.stop()
