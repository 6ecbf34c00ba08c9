"""The capacity observatory on the port (tpu/meter.py): attribution
conservation, exact tenant accounting, the λ/μ/ρ forecaster and the
collapse detector.

The twins of tests/test_meter.py's replica half (12 of its 16) on the
port's modules and its debug engine (on the CPU), with the payloads of the
meter and the forecaster held equal to the reference's for the same event
sequence on a fake clock, and the served ``/debug/capacity`` conserving
against ``/debug/steps``. The conservation run's classes and tenants go
through submit, as the reference's do, and its served twin sends them over
HTTP (headers and body fields) to both servers, which bill each request to
its own (tenant, class). Left out: the four fleet-rollup tests
(``test_fleet_rollup_merges_and_sizes_the_fleet``,
``test_fleet_rollup_cold_fleet_recommends_what_it_has``,
``test_replicas_needed_scales_with_offered_load``,
``test_fleet_capacity_endpoint_e2e_two_replicas``): ``fleet/capacity.py``
waits with ``fleet/`` in ROADMAP A18b.
"""

import json
import math
import types
import urllib.error
import urllib.request

import pytest

from gofr_tpu.models.llama import LlamaConfig as JConfig
from gofr_tpu.tpu import meter as jmeter
from gofr_tpu.tpu import qos as jqos
from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
from gofr_tpu_torch.tpu import meter as tmeter
from gofr_tpu_torch.tpu.engine import LLMEngine
from gofr_tpu_torch.tpu.meter import (_MAX_TENANTS, _TENANT_OVERFLOW,
                                      HeadroomForecaster, TPUMeter,
                                      register_meter_metrics)
from gofr_tpu_torch.tpu.utilization import prefill_flops

CFG = LlamaConfig.debug()


class MockLogger:
    def debugf(self, *a, **k):
        pass
    infof = warnf = errorf = fatalf = logf = debugf


def _req(rid, tenant="t0", cls="standard", prompt=8, max_new=4):
    return types.SimpleNamespace(id=rid, tenant=tenant, qos_class=cls,
                                 prompt_tokens=list(range(1, prompt + 1)),
                                 max_new_tokens=max_new, emitted=[])


def _rec(device_sync=0.06, dispatch=0.02, seq=1, wall=0.1):
    return types.SimpleNamespace(
        segments={"device_sync": device_sync, "dispatch": dispatch},
        wall_s=wall, seq=seq)


# -- units: token-weighted apportionment --------------------------------------

def test_token_weighted_apportionment_conserves_per_step():
    meter = TPUMeter(cfg=None)
    ra, rb = _req(1, tenant="a"), _req(2, tenant="b")
    meter.account_step(_rec(0.06, 0.02), "prefill",
                       [(ra, 30, 30), (rb, 10, 10)])
    snap = meter.snapshot()
    # weights 30/40 and 10/40 over the 0.08 s of device segments
    by_tenant = {row["tenant"]: row for row in snap["accounts"]}
    assert by_tenant["a"]["device_s"] == pytest.approx(0.06)
    assert by_tenant["b"]["device_s"] == pytest.approx(0.02)
    # conservation evidence: attributed == measured for the step
    step = snap["steps"][-1]
    assert step["attributed_s"] == pytest.approx(step["device_s"])
    assert step["device_s"] == pytest.approx(0.08)
    assert snap["totals"]["device_s"] == pytest.approx(0.08)


def test_wall_clock_fallback_without_segments():
    meter = TPUMeter(cfg=None)
    rec = types.SimpleNamespace(segments={}, wall_s=0.05, seq=7)
    meter.account_step(rec, "decode", [(_req(1), 4, 16)])
    assert meter.snapshot()["totals"]["device_s"] == pytest.approx(0.05)


def test_analytic_flops_per_row():
    meter = TPUMeter(cfg=CFG)
    ra, rb = _req(1, tenant="a"), _req(2, tenant="b")
    meter.account_step(_rec(), "prefill", [(ra, 8, 8), (rb, 16, 16)])
    by_tenant = {row["tenant"]: row for row in meter.snapshot()["accounts"]}
    assert by_tenant["a"]["flops"] == pytest.approx(prefill_flops(CFG, 8))
    assert by_tenant["b"]["flops"] == pytest.approx(prefill_flops(CFG, 16))


def test_page_seconds_accrue_between_metered_syncs(monkeypatch):
    now = [100.0]
    monkeypatch.setattr("gofr_tpu_torch.tpu.meter.time.monotonic",
                        lambda: now[0])
    meter = TPUMeter(cfg=None, page_tokens=16)
    r = _req(1, tenant="a")
    meter.account_step(_rec(), "prefill", [(r, 8, 8)])   # first sight: 0
    now[0] = 101.0
    meter.account_step(_rec(), "decode", [(r, 4, 32)])   # 2 pages x 1 s
    row = meter.snapshot()["accounts"][0]
    assert row["page_s"] == pytest.approx(2.0)


def test_queue_wait_charged_at_first_service_only():
    meter = TPUMeter(cfg=None)
    r = _req(1, tenant="a")
    meter.account_step(_rec(), "prefill", [(r, 8, 8)], queued=[(r, 0.25)])
    meter.account_step(_rec(), "decode", [(r, 4, 12)])  # no queued rows
    row = meter.snapshot()["accounts"][0]
    assert row["queue_s"] == pytest.approx(0.25)


def test_tenant_table_bounded_with_overflow_pool():
    meter = TPUMeter(cfg=None)
    for i in range(_MAX_TENANTS + 8):
        meter.account_step(_rec(seq=i), "prefill",
                           [(_req(i, tenant=f"tenant{i}"), 8, 8)])
    tenants = {row["tenant"] for row in meter.snapshot()["accounts"]}
    assert _TENANT_OVERFLOW in tenants
    # bounded: _MAX_TENANTS named labels + the overflow pool
    assert len(tenants) == _MAX_TENANTS + 1


def test_snapshot_top_k_and_finished_fold():
    meter = TPUMeter(cfg=None, top_k=2)
    reqs = [_req(i, tenant=f"t{i}") for i in range(4)]
    for i, r in enumerate(reqs):
        meter.account_step(_rec(0.01 * (i + 1), 0.0, seq=i), "prefill",
                           [(r, 8, 8)])
        meter.note_finished(r, ok=True)
    snap = meter.snapshot()
    assert len(snap["tenants"]) == 2          # top-K only
    assert snap["tenants"][0]["tenant"] == "t3"  # sorted by device_s
    assert snap["requests_total"] == 4
    assert all(row["finished"] == 1 for row in snap["accounts"])


def test_register_meter_metrics_idempotent():
    from gofr_tpu_torch.metrics import Manager
    manager = Manager()
    register_meter_metrics(manager)
    register_meter_metrics(manager)
    assert manager.get("app_tpu_meter_device_seconds_total") is not None
    assert manager.get("app_tpu_capacity_rho") is not None


# -- units: the forecaster ----------------------------------------------------

def _stub_engine(busy_s=6.0, prefill_toks=4000, decode_toks=8000, depth=0):
    util = types.SimpleNamespace(window_stats=lambda now=None: {
        "device_busy_s": busy_s,
        "tokens": {"prefill": prefill_toks, "decode": decode_toks}})
    return types.SimpleNamespace(util=util, queue_depth=lambda: depth)


def test_forecaster_lambda_mu_rho_headroom(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr("gofr_tpu_torch.tpu.meter.time.monotonic",
                        lambda: now[0])
    fc = HeadroomForecaster(engine=_stub_engine(depth=10), window_s=60.0)
    for _ in range(4):
        fc.note_arrival(400, 100)
    now[0] = 1002.0
    out = fc.evaluate(now[0])
    # span 2 s: lambda 2 req/s, 1000 tok/s; mu 12000 tok / 6 s = 2000
    assert out["lambda_rps"] == pytest.approx(2.0)
    assert out["lambda_tok_s"] == pytest.approx(1000.0)
    assert out["mu_tok_s"] == pytest.approx(2000.0)
    assert out["rho"] == pytest.approx(0.5)
    assert out["headroom_tok_s"] == pytest.approx(1000.0)
    # no traffic observed yet: backlog uses the default prompt estimate
    assert out["backlog_tokens"] == pytest.approx(10 * 128)
    assert out["predicted_ttft_ms"] == pytest.approx(1280 / 2000 * 1e3)
    # once completions teach the EWMAs, the backlog re-estimates
    fc.note_finished(400, 100)
    fc.note_prefill(0.08)
    out = fc.evaluate(now[0])
    assert out["backlog_tokens"] == pytest.approx(10 * 400)
    assert out["predicted_ttft_ms"] == pytest.approx(
        (0.08 + 4000 / 2000.0) * 1e3)


def test_forecaster_decays_when_idle(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr("gofr_tpu_torch.tpu.meter.time.monotonic",
                        lambda: now[0])
    fc = HeadroomForecaster(engine=_stub_engine(), window_s=10.0)
    fc.note_arrival(100, 10)
    assert fc.evaluate(1001.0)["arrivals"] == 1
    # the arrival window drains: lambda -> 0, rho -> 0
    out = fc.evaluate(1020.0)
    assert out["arrivals"] == 0
    assert out["lambda_tok_s"] == 0.0
    assert out["rho"] == 0.0


def test_collapse_detector_needs_rising_depth_and_high_rho():
    fc = HeadroomForecaster(engine=None, rho_warn=0.85, collapse_evals=3)
    assert fc._eval_collapse(1000.0, 1, 0.95) is False
    assert fc._eval_collapse(1000.3, 2, 0.95) is False
    assert fc._eval_collapse(1000.6, 3, 0.95) is True   # 1<2<3 at rho .95
    assert fc.collapse_events == 1
    assert fc._eval_collapse(1000.9, 3, 0.95) is False  # plateau clears it
    # rising depth alone is NOT collapse while headroom remains
    fc2 = HeadroomForecaster(engine=None, rho_warn=0.85, collapse_evals=3)
    fc2._eval_collapse(1000.0, 1, 0.2)
    fc2._eval_collapse(1000.3, 2, 0.2)
    assert fc2._eval_collapse(1000.6, 3, 0.2) is False
    assert fc2.collapse_events == 0


# -- live engine: the conservation acceptance ---------------------------------

def test_conservation_live_multi_tenant_engine():
    """Per-step attributed device-seconds sum to the step ledger's
    measured device segments (±5 % over the run), and tenant totals
    equal the per-request sums exactly — over a REAL multi-tenant run."""
    params = llama_init(CFG, seed=0, device="cpu")
    eng = LLMEngine(params, CFG, n_slots=4, max_seq_len=64,
                    prefill_buckets=(8, 16), logger=MockLogger(),
                    device="cpu")
    meter = TPUMeter(cfg=CFG, steps_capacity=8192, done_capacity=256)
    meter.forecaster = HeadroomForecaster(engine=eng)
    eng.meter = meter
    reqs = []
    for i in range(12):
        reqs.append(eng.submit(
            [1 + (i % 5), 2, 3, 4 + (i % 3)], max_new_tokens=6,
            qos_class=("interactive", "standard", "batch")[i % 3],
            tenant=f"tenant{i % 4}"))
    eng.start()
    try:
        for r in reqs:
            r.result(timeout_s=300)
    finally:
        eng.stop()

    steps = list(meter._steps)
    assert steps, "no metered steps over a 12-request run"
    total_attr = sum(s["attributed_s"] for s in steps)
    total_meas = sum(s["device_s"] for s in steps)
    assert total_meas > 0
    assert abs(total_attr - total_meas) <= 0.05 * total_meas
    snap = meter.snapshot()
    assert snap["totals"]["device_s"] == pytest.approx(total_attr, abs=1e-4)
    assert snap["requests_total"] == 12
    assert snap["forecast"]["mu_tok_s"] is None or \
        snap["forecast"]["mu_tok_s"] > 0

    # tenant totals == sum of their request accounts (all finished)
    assert not meter._live
    per = {}
    for acct in meter._done:
        key = (acct.tenant, acct.cls)
        per[key] = per.get(key, 0.0) + acct.device_s
    for key, tacct in meter._accounts.items():
        assert tacct.device_s == pytest.approx(per.get(key, 0.0),
                                               abs=1e-9), key
    # every class label the run used shows up in the accounts
    assert {cls for _, cls in meter._accounts} == {
        "interactive", "standard", "batch"}


# -- against the reference ----------------------------------------------------
def test_tenant_helpers_equal_the_references():
    assert (_MAX_TENANTS, _TENANT_OVERFLOW) == (jqos._MAX_TENANTS,
                                                jqos._TENANT_OVERFLOW)
    for cls in (None, "batch", "interactive"):
        r = types.SimpleNamespace(qos_class=cls)
        assert tmeter.effective_class(r) == jqos.effective_class(r)


def _meter_run(module, cfg, now):
    """One event sequence through a module's TPUMeter + forecaster."""
    meter = module.TPUMeter(cfg=cfg, page_tokens=16, top_k=3)
    meter.forecaster = module.HeadroomForecaster(
        engine=_stub_engine(depth=3), window_s=60.0)
    reqs = [_req(i, tenant=f"t{i % 3}", cls=("standard", "batch")[i % 2],
                 prompt=4 + i) for i in range(6)]
    for i, r in enumerate(reqs):
        meter.note_arrival(r)
        now[0] += 0.5
        meter.account_step(_rec(0.01 * (i + 1), 0.002, seq=2 * i),
                           "prefill", [(r, len(r.prompt_tokens),
                                        len(r.prompt_tokens))],
                           queued=[(r, 0.01 * i)])
        now[0] += 0.25
        meter.account_step(_rec(0.02, 0.001, seq=2 * i + 1), "decode",
                           [(q, 4, 40 + 4 * j)
                            for j, q in enumerate(reqs[:i + 1])])
        if i % 2:
            r.emitted = [7] * 5
            meter.note_finished(r, ok=i != 3)
    return meter.snapshot()


def test_meter_payload_equals_the_references(monkeypatch):
    """The same arrivals, steps and finishes, on one fake clock, through
    the port's meter and the reference's: equal /debug/capacity
    payloads (forecast included)."""
    out = []
    for module, cfg in ((tmeter, CFG), (jmeter, JConfig.debug())):
        now = [500.0]
        monkeypatch.setattr("time.monotonic", lambda: now[0])
        out.append(_meter_run(module, cfg, now))
    assert out[0] == out[1]
    assert out[0]["requests_total"] == 6
    assert out[0]["forecast"]["arrivals"] == 6


def test_forecaster_payloads_equal_the_references(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr("time.monotonic", lambda: now[0])
    fcs = [m.HeadroomForecaster(engine=_stub_engine(depth=12),
                                window_s=30.0, collapse_evals=3)
           for m in (tmeter, jmeter)]
    got = [[], []]
    for step in range(12):
        now[0] += 1.0
        for k, fc in enumerate(fcs):
            fc.note_arrival(100 + step, 20)
            if step % 3 == 0:
                fc.note_prefill(0.01 * (step + 1))
                fc.note_finished(90 + step, 18)
            got[k].append(fc.evaluate(now[0]))
    now[0] += 45.0     # the window drains
    for k, fc in enumerate(fcs):
        got[k].append(fc.evaluate(now[0]))
    assert got[0] == got[1]
    assert got[0][-1]["arrivals"] == 0


# -- the served surface -------------------------------------------------------
def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read().decode())["data"]


def test_debug_capacity_conserves_against_debug_steps(tmp_path):
    """Both servers serve /debug/capacity (on by default, CAPACITY=false
    removes it); after real traffic each metered step's attributed
    device seconds equal its /debug/steps record's device_sync +
    dispatch segments (to the 1 us the payload rounds to), and rho, headroom and the TTFT forecast are
    finite."""
    from gofr_tpu_torch.serve import build_app, build_engine
    from gofr_tpu_torch.serve_openai import build_app as build_openai

    env = {"HTTP_PORT": "0", "METRICS_PORT": "0", "MODEL_PRESET": "debug",
           "GRPC_PORT": "0",
           "WARMUP": "false", "MAX_BATCH": "4", "MAX_SEQ_LEN": "64",
           "PREFILL_BUCKETS": "8,16", "PAGE_SIZE": "8", "LOG_LEVEL": "WARN",
           "ENGINE_HBM_SAMPLE_S": "0", "HOSTPROF": "false",
           "INCIDENT_DIR": str(tmp_path), "REQUEST_TIMEOUT": "120"}
    params = llama_init(CFG, seed=0, device="cpu")
    for build in (build_app, build_openai):
        app = build(env, engine=build_engine(env, device="cpu",
                                             params=params))
        app.start()
        try:
            eng = app.engine
            reqs = [eng.submit([3 + i, 4, 5], max_new_tokens=8)
                    for i in range(4)]
            for r in reqs:
                r.result(timeout_s=120)
            snap = _get(app.http_port, "/debug/capacity")
            steps = _get(app.http_port, "/debug/steps?recent=512")
            by_seq = {s["step"]: s for s in steps["recent"]}
            metered = [s for s in snap["steps"] if s["seq"] in by_seq]
            assert metered
            for s in metered:
                seg = by_seq[s["seq"]]["segments"]
                measured = seg.get("device_sync", 0.0) + seg.get(
                    "dispatch", 0.0)
                assert s["attributed_s"] == pytest.approx(s["device_s"],
                                                          rel=1e-9)
                # /debug/steps rounds each segment to 1 us
                assert s["device_s"] == pytest.approx(measured, rel=0,
                                                      abs=1.01e-6)
            fc = snap["forecast"]
            for key in ("rho", "headroom_tok_s", "predicted_ttft_ms"):
                assert math.isfinite(fc[key]), key
            assert snap["requests_total"] == 4
        finally:
            app.shutdown()
    off = build_app({**env, "CAPACITY": "false"},
                    engine=build_engine(env, device="cpu", params=params))
    off.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(off.http_port, "/debug/capacity")
        assert err.value.code == 404
        assert off.engine.meter is None
    finally:
        off.shutdown()


def _send(port, path, body, headers):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="POST",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **headers})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status


@pytest.mark.parametrize("server", ["generate", "openai"])
def test_conservation_live_multi_tenant_served(server, tmp_path):
    """The served twin of the conservation run: 12 requests whose classes
    and tenants travel over HTTP (/generate: the X-QoS-Class and X-Tenant
    headers, or the body's class and tenant; the OpenAI routes: the
    headers), QoS off as by default. The meter bills each request to the
    (tenant, class) it was sent with, its tenant totals equal the sums of
    their requests, and the steps' attribution conserves."""
    from gofr_tpu_torch.serve import build_app, build_engine
    from gofr_tpu_torch.serve_openai import build_app as build_openai

    env = {"HTTP_PORT": "0", "METRICS_PORT": "0", "MODEL_PRESET": "debug",
           "GRPC_PORT": "0",
           "WARMUP": "false", "MAX_BATCH": "4", "MAX_SEQ_LEN": "64",
           "PREFILL_BUCKETS": "8,16", "PAGE_SIZE": "8", "LOG_LEVEL": "WARN",
           "ENGINE_HBM_SAMPLE_S": "0", "HOSTPROF": "false",
           "INCIDENT_DIR": str(tmp_path), "REQUEST_TIMEOUT": "120"}
    build = build_app if server == "generate" else build_openai
    app = build(env, engine=build_engine(
        env, device="cpu", params=llama_init(CFG, seed=0, device="cpu")))
    app.start()
    sent = []
    try:
        meter = app.engine.meter
        for i in range(12):
            cls = ("interactive", "standard", "batch")[i % 3]
            tenant = f"tenant{i % 4}"
            sent.append((tenant, cls))
            if server == "openai":
                status = _send(app.http_port, "/v1/completions",
                               {"prompt": f"hi {i}", "max_tokens": 6,
                                "temperature": 0},
                               {"X-QoS-Class": cls, "X-Tenant": tenant})
            elif i % 2:
                status = _send(app.http_port, "/generate",
                               {"prompt": f"hi {i}", "max_tokens": 6,
                                "stream": False, "class": cls,
                                "tenant": tenant}, {})
            else:
                status = _send(app.http_port, "/generate",
                               {"prompt": f"hi {i}", "max_tokens": 6,
                                "stream": False},
                               {"X-QoS-Class": cls, "X-Tenant": tenant})
            assert status in (200, 201)
        snap = _get(app.http_port, "/debug/capacity")
    finally:
        app.shutdown()
    assert snap["requests_total"] == 12
    assert not meter._live
    billed = sorted((acct.tenant, acct.cls) for acct in meter._done)
    assert billed == sorted(sent)
    per = {}
    for acct in meter._done:
        key = (acct.tenant, acct.cls)
        per[key] = per.get(key, 0.0) + acct.device_s
    assert set(meter._accounts) == set(sent)
    for key, tacct in meter._accounts.items():
        assert tacct.device_s == pytest.approx(per[key], abs=1e-9), key
    steps = list(meter._steps)
    total_attr = sum(s["attributed_s"] for s in steps)
    total_meas = sum(s["device_s"] for s in steps)
    assert total_meas > 0
    assert abs(total_attr - total_meas) <= 0.05 * total_meas
    assert {row["tenant"] for row in snap["tenants"]} <= {
        t for t, _ in sent}
