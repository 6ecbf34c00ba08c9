"""The port's open-loop load client (gofr_tpu_torch/loadgen) against the
reference's (gofr_tpu/loadgen).

The twins of tests/test_loadgen.py: trace format round-trips and version
skew, capture privacy, the open-loop schedule under a stalled server,
scorecard math at the noise-band edges, incident-bundle trace export and
the knee drill's agreement logic, on the port's modules. Where both
packages answer the same question they are compared directly on the same
inputs: ``synthesize`` for the same seeds, ``build_scorecard`` /
``compare`` on the same rows and against the checked-in
``tests/baselines/loadgen_debug.json``, and a trace that either package's
``dump_trace`` wrote, read by the other. The e2e tests boot the port's
server (``serve.build_app``, the debug preset on the CPU, QoS and the
capacity observatory on) and drive it over real sockets: an open-loop
run through the port's router (``serve_router.build_app``), the router's
``GET /debug/trace`` (classes and tenants kept) replayed and compared, the
replica's own trace export, and the knee drill polling the router's
``GET /debug/fleet/capacity``, as the reference's go through its router.
"""

import io
import json
import os
import random
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import gofr_tpu.loadgen as jlg
import gofr_tpu_torch.loadgen as tlg
from gofr_tpu_torch.loadgen import (OpenLoopRunner, StatusServer,
                                    TraceCapture, TraceError,
                                    baseline_from_scorecard, build_scorecard,
                                    compare, dump_trace,
                                    events_from_incident, make_event,
                                    percentile, poisson_arrivals,
                                    prompt_text, ramp_arrivals, run_knee,
                                    synthesize, zipf_weights)
from gofr_tpu_torch.loadgen.knee import _normalize_forecast
from gofr_tpu_torch.loadgen.trace import (TRACE_VERSION, dumps_trace,
                                          load_trace, loads_trace)

from _torch_env import INCIDENT_DIR

pytestmark = pytest.mark.loadgen

BASELINE = os.path.join(os.path.dirname(__file__), "baselines",
                        "loadgen_debug.json")


def test_exports_equal_the_reference():
    assert tlg.__all__ == jlg.__all__
    assert tlg.TRACE_VERSION == jlg.TRACE_VERSION


# ---------------------------------------------------------------- trace ----
def test_trace_roundtrip_rebases_and_sorts():
    events = [make_event(t=5.0, prompt_tokens=4, seed=9, max_new=3,
                         cls="interactive", tenant="acme", session=7,
                         turn=1),
              make_event(t=3.5, prompt_tokens=2, seed=1, max_new=1)]
    text = dumps_trace(events, source="unit")
    header, loaded = loads_trace(text)
    assert header["trace_version"] == TRACE_VERSION
    assert header["source"] == "unit"
    # sorted by t and rebased so the first arrival is t=0
    assert [e["t"] for e in loaded] == [0.0, 1.5]
    assert loaded[1]["class"] == "interactive"
    assert loaded[1]["tenant"] == "acme"
    assert loaded[1]["session"] == 7


def test_trace_version_skew():
    newer = json.dumps({"trace_version": TRACE_VERSION + 1}) + "\n"
    with pytest.raises(TraceError, match="newer"):
        loads_trace(newer)
    with pytest.raises(TraceError, match="header"):
        loads_trace("")
    with pytest.raises(TraceError):
        loads_trace("not json\n")
    # same-major unknown event fields are preserved but ignored
    text = (json.dumps({"trace_version": TRACE_VERSION}) + "\n"
            + json.dumps({"t": 0.0, "prompt_tokens": 2, "seed": 1,
                          "max_new": 1, "future_field": "xyz"}) + "\n")
    _, events = loads_trace(text)
    assert events[0]["future_field"] == "xyz"


def test_trace_file_roundtrip(tmp_path):
    path = str(tmp_path / "t.jsonl")
    n = dump_trace([make_event(0.0, 3, 5, 2)], path, source="file")
    assert n == 1
    header, events = load_trace(path)
    assert header["events"] == 1 and len(events) == 1


def test_prompt_text_is_session_prefix_extension():
    turn0 = prompt_text(make_event(0, 10, seed=1, max_new=1, session=42,
                                   turn=0))
    turn1 = prompt_text(make_event(0, 16, seed=2, max_new=1, session=42,
                                   turn=1))
    assert len(turn0.split()) == 10 and len(turn1.split()) == 16
    # shared trunk grows with turn: turn-0's trunk is a prefix of turn-1's
    trunk0 = turn0.split()[:4]
    assert turn1.split()[:4] == trunk0
    # distinct seeds keep the tails distinct
    assert turn0 != prompt_text(make_event(0, 10, seed=99, max_new=1,
                                           session=42, turn=0))


# ---------------------------------------------------------------- synth ----
def test_synth_deterministic_and_shaped():
    arr = poisson_arrivals(20.0, 2.0, __import__("random").Random(3))
    assert all(0 <= t < 2.0 for t in arr)
    a = synthesize(arr, tenants=3, seed=5)
    b = synthesize(arr, tenants=3, seed=5)
    assert a == b                      # byte-identical from the seed
    assert {e["class"] for e in a} <= {"interactive", "standard", "batch"}
    assert all(e["tenant"].startswith("tenant") for e in a)
    # session reuse produced at least one multi-turn conversation
    assert any(e["turn"] > 0 for e in a)
    ramp = ramp_arrivals(1.0, 40.0, 4.0, __import__("random").Random(3))
    # a ramp densifies: the second half holds most arrivals
    assert sum(1 for t in ramp if t > 2.0) > len(ramp) / 2
    w = zipf_weights(5)
    assert abs(sum(w) - 1.0) < 1e-9 and w == sorted(w, reverse=True)


# -------------------------------------------------------------- capture ----
def test_capture_sessions_and_privacy():
    cap = TraceCapture(capacity=16, block=8)
    cap.note("hello wor" + "ld turn one", qos_class="interactive",
             tenant="acme", max_new=4)
    cap.note("hello wor" + "ld turn two longer", qos_class="interactive",
             tenant="acme", max_new=4)
    cap.note("completely different", qos_class="batch", max_new=2)
    header, events = cap.export()
    assert header["captured_total"] == 3 and len(events) == 3
    # same leading block -> same session id, turn counter advanced
    assert events[0]["session"] == events[1]["session"]
    assert (events[0]["turn"], events[1]["turn"]) == (0, 1)
    assert events[2]["session"] != events[0]["session"]
    # privacy is structural: no prompt byte in the export
    assert "hello" not in json.dumps(events)
    assert events[0]["t"] == 0.0           # rebased
    assert events[0]["prompt_tokens"] == 4


def test_capture_is_bounded_and_never_raises():
    cap = TraceCapture(capacity=4)
    for i in range(10):
        cap.note(f"prompt {i}")
    assert len(cap) == 4
    cap.note(None)                         # type: ignore[arg-type]
    assert cap.snapshot()["captured_total"] >= 10


# ------------------------------------------------------------ scorecard ----
def test_percentile_math():
    assert percentile([], 50) is None
    assert percentile([7.0], 99) == 7.0
    assert percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5
    assert percentile([1.0, 2.0, 3.0, 4.0], 100) == 4.0


def _ok_row(cls, tenant, ttft_s, tpot_s=0.01, tokens=4):
    return {"class": cls, "tenant": tenant, "status": "ok",
            "ttft_s": ttft_s, "tpot_s": tpot_s, "tokens": tokens, "t": 0.0}


def test_scorecard_goodput_counts_offered_not_served():
    rows = [_ok_row("interactive", "a", 0.05) for _ in range(8)]
    rows += [{"class": "interactive", "tenant": "a", "status": "shed",
              "t": 0.0}] * 2
    card = build_scorecard(rows)
    cell = card["classes"]["interactive"]
    assert cell["offered"] == 10 and cell["ok"] == 8 and cell["shed"] == 2
    # shed arrivals count against goodput — shedding is not free
    assert cell["goodput"] == 0.8
    assert card["cells"]["interactive|a"]["offered"] == 10
    assert cell["slo_met"] is True and card["slo_met"] is True


def test_scorecard_objective_miss():
    rows = [_ok_row("interactive", "a", 9.0)]     # 9s TTFT
    card = build_scorecard(rows)
    assert card["slo_met"] is False
    checks = card["classes"]["interactive"]["objective_checks"]
    assert any(c["metric"] == "ttft_ms_p95" and not c["met"]
               for c in checks)


def test_noise_band_edges():
    rows = [_ok_row("interactive", "a", 0.100) for _ in range(10)]
    base = baseline_from_scorecard(build_scorecard(rows))
    band = base["classes"]["interactive"]["ttft_ms_p50"]["band"]
    assert band == max(100.0 * 0.35, 150.0)       # abs floor dominates

    def run_with(ttft_ms):
        return compare(build_scorecard(
            [_ok_row("interactive", "a", ttft_ms / 1e3)
             for _ in range(10)]), base)

    assert run_with(100.0 + band)["verdict"] == "pass"     # exactly at edge
    assert run_with(100.0 + band + 1.0)["verdict"] == "regress"
    assert run_with(100.0)["verdict"] == "pass"
    # goodput regression beyond its band
    worse = [_ok_row("interactive", "a", 0.100) for _ in range(5)]
    worse += [{"class": "interactive", "tenant": "a", "status": "shed",
               "t": 0.0}] * 5
    assert compare(build_scorecard(worse), base)["verdict"] == "regress"
    # a class absent from the run is a regression, not a silent pass
    assert compare(build_scorecard([_ok_row("batch", "a", 0.1)]),
                   base)["verdict"] == "regress"


def test_compare_improve_and_slo_override():
    slow = [_ok_row("interactive", "a", 0.900) for _ in range(10)]
    base = baseline_from_scorecard(build_scorecard(slow))
    fast = [_ok_row("interactive", "a", 0.010) for _ in range(10)]
    assert compare(build_scorecard(fast), base)["verdict"] == "improve"
    # matching a baseline that itself blew the SLO is still a failure
    blown = [_ok_row("interactive", "a", 9.0) for _ in range(10)]
    blown_base = baseline_from_scorecard(build_scorecard(blown))
    assert compare(build_scorecard(blown), blown_base)["verdict"] \
        == "regress"


def test_checked_in_baseline_is_well_formed():
    """The blessed debug-fleet baseline CI scores against: every class,
    every compared metric with a positive band, and a recorded workload
    spec so it can be re-blessed reproducibly."""
    path = os.path.join(os.path.dirname(__file__), "baselines",
                        "loadgen_debug.json")
    with open(path, encoding="utf-8") as fp:
        baseline = json.load(fp)
    assert baseline["baseline_version"] == 1
    assert set(baseline["classes"]) == {"interactive", "standard", "batch"}
    for cell in baseline["classes"].values():
        for metric in ("ttft_ms_p50", "ttft_ms_p95", "goodput"):
            assert cell[metric]["band"] > 0
    assert baseline["workload"]["seed"] == 42
    # a run that exactly matches the baseline passes its own comparison
    synthetic_rows = []
    for cls, cell in baseline["classes"].items():
        ttft = cell["ttft_ms_p50"]["value"] / 1e3
        synthetic_rows += [_ok_row(cls, "t0", ttft) for _ in range(10)]
    result = compare(build_scorecard(synthetic_rows), baseline)
    assert result["verdict"] != "regress", result


# ------------------------------------------------- incident trace export ----
def test_incident_bundle_exports_as_trace():
    from gofr_tpu_torch.tpu.incidents import IncidentManager

    bundle_rows = [
        {"id": 31, "enqueued_at": 100.0, "prompt_tokens": 12,
         "max_new_tokens": 8, "tenant": "acme"},
        {"id": 32, "enqueued_at": 100.5, "prompt_tokens": 6,
         "max_new_tokens": 4},
    ]
    events = events_from_incident({"slowest_requests": bundle_rows})
    assert [e["t"] for e in events] == [0.0, 0.5]
    assert events[0]["seed"] == 31 and events[0]["session"] == 31
    assert events[0]["tenant"] == "acme"
    assert events_from_incident({}) == []

    mgr = IncidentManager(engine=None, recorder=None,
                          dir=tempfile.mkdtemp(prefix="lg_inc_"))
    mgr._ring.append({"id": 5, "trigger": "slo_page",
                      "captured_at": 1.0,
                      "slowest_requests": bundle_rows})
    doc = mgr.export_trace(5)
    assert doc["trace_version"] == TRACE_VERSION
    assert doc["source"] == "incident:5"
    assert len(doc["events"]) == 2
    assert mgr.export_trace(999) is None
    # the export round-trips through the JSONL format
    _, loaded = loads_trace(dumps_trace(doc["events"],
                                        source=doc["source"]))
    assert len(loaded) == 2


# ---------------------------------------------------- open-loop generator ----
class _StallHandler(BaseHTTPRequestHandler):
    """Accepts, then stalls: the closed-loop failure mode on a plate."""

    stall_s = 1.5

    def do_POST(self):  # noqa: N802
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        time.sleep(self.stall_s)
        body = b'{"error": "stalled"}'
        self.send_response(503)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # noqa: A003,ANN002
        pass


class _FastSSEHandler(BaseHTTPRequestHandler):
    """Instant SSE stream: deterministic transport for generator units."""

    def do_POST(self):  # noqa: N802
        req = json.loads(
            self.rfile.read(int(self.headers.get("Content-Length") or 0)))
        n = int(req.get("max_tokens") or 1)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.end_headers()
        for _ in range(n):
            self.wfile.write(b'data: {"text": "w"}\n\n')
        done = json.dumps({"done": True, "tokens": n}).encode()
        self.wfile.write(b"data: " + done + b"\n\n")

    def log_message(self, *args):  # noqa: A003,ANN002
        pass


@pytest.fixture()
def _server_factory():
    servers = []

    def build(handler):
        srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        srv.daemon_threads = True
        threading.Thread(target=srv.serve_forever,
                         kwargs={"poll_interval": 0.1},
                         daemon=True).start()
        servers.append(srv)
        return f"http://127.0.0.1:{srv.server_address[1]}"

    yield build
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def test_open_loop_schedule_holds_under_stalled_server(_server_factory):
    """The tentpole property: a stalled server must not slow arrivals."""
    url = _server_factory(_StallHandler)
    events = [make_event(t=i * 0.05, prompt_tokens=2, seed=i, max_new=1)
              for i in range(20)]                 # 20 arrivals over ~1s
    runner = OpenLoopRunner(url, events, timeout_s=10.0)
    runner.start()
    assert runner.wait_dispatch(timeout_s=15.0)
    arrivals = runner.arrivals()
    # every arrival fired even though NO request had completed yet, and
    # fired close to schedule (the dispatch-lag self-audit)
    assert len(arrivals) == 20
    assert max(a["lag_s"] for a in arrivals) < 0.5
    assert runner.join(timeout_s=15.0)
    rows = runner.rows()
    assert len(rows) == 20
    assert {r["status"] for r in rows} == {"shed"}     # 503 -> shed


def test_open_loop_inflight_cap_records_drops(_server_factory):
    url = _server_factory(_StallHandler)
    events = [make_event(t=i * 0.02, prompt_tokens=2, seed=i, max_new=1)
              for i in range(10)]
    runner = OpenLoopRunner(url, events, timeout_s=10.0, max_inflight=3)
    runner.start()
    assert runner.wait_dispatch(timeout_s=10.0)
    assert runner.join(timeout_s=15.0)
    rows = runner.rows()
    dropped = [r for r in rows if r["status"] == "dropped"]
    # over-cap arrivals are still recorded ON SCHEDULE, loudly
    assert len(rows) == 10 and len(dropped) == 7 == runner.dropped


def test_open_loop_records_ttft_and_headers(_server_factory):
    seen = {}

    class _Echo(_FastSSEHandler):
        def do_POST(self):  # noqa: N802
            seen["class"] = self.headers.get("X-QoS-Class")
            seen["tenant"] = self.headers.get("X-Tenant")
            super().do_POST()

    url = _server_factory(_Echo)
    events = [make_event(t=0.0, prompt_tokens=3, seed=1, max_new=4,
                         cls="interactive", tenant="acme", session=1)]
    rows = OpenLoopRunner(url, events, timeout_s=10.0).run(
        drain_timeout_s=10.0)
    assert rows[0]["status"] == "ok"
    assert rows[0]["tokens"] == 4
    assert rows[0]["ttft_s"] >= 0.0
    assert seen == {"class": "interactive", "tenant": "acme"}
    status_keys = OpenLoopRunner(url, [], timeout_s=1.0).status()
    assert {"offered_rps", "served_rps", "inflight", "outcomes",
            "worst_dispatch_lag_s"} <= set(status_keys)


def test_status_server_serves_runner(_server_factory):
    runner = OpenLoopRunner("127.0.0.1:1", [], timeout_s=1.0)
    server = StatusServer(
        runner, scorecard_fn=lambda: build_scorecard(runner.rows()))
    server.start()
    try:
        with urllib.request.urlopen(server.url + "/debug/loadgen",
                                    timeout=5) as resp:
            payload = json.loads(resp.read())
        assert payload["label"] == "loadgen"
        assert "scorecard" in payload
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(server.url + "/nope", timeout=5)
    finally:
        server.stop()


# ----------------------------------------------------------------- knee ----
def test_normalize_forecast_shapes():
    replica = {"forecast": {"rho": 0.5, "predicted_ttft_ms": 12.0,
                            "collapse_warning": False}}
    fleet = {"fleet": {"rho": 0.9, "predicted_ttft_ms_max": 80.0,
                       "replicas_needed": 3,
                       "collapse_warnings": ["r0"]}}
    assert _normalize_forecast(replica)["rho"] == 0.5
    assert _normalize_forecast(replica)["collapse_warning"] is False
    flat = _normalize_forecast(fleet)
    assert flat["collapse_warning"] is True
    assert flat["replicas_needed"] == 3
    assert flat["predicted_ttft_ms"] == 80.0
    assert _normalize_forecast(None) is None


def test_knee_agreement_logic(_server_factory):
    """A fast server + an early-warning forecast fn: the drill must
    report agreement (clean run) without any real collapse."""
    url = _server_factory(_FastSSEHandler)
    result = run_knee(url, lambda: {"rho": 0.2, "predicted_ttft_ms": 5.0,
                                    "collapse_warning": False},
                      rate0_rps=5.0, rate1_rps=15.0, seconds=2.0,
                      poll_s=0.2, drain_timeout_s=15.0,
                      request_timeout_s=10.0)
    assert result["agrees"] is True
    assert result["first_blowout_at_s"] is None
    assert result["collapse_warning_at_s"] is None
    assert result["ramp"]["arrivals"] == len(result["rows"])
    assert result["samples"], "forecast sampler never ran"


# ------------------------------------------------ against the reference ----
@pytest.mark.parametrize("seed", [0, 2, 42])
def test_synthesize_equals_the_reference(seed):
    """The same seed gives the reference's arrivals and events, byte for
    byte, for both arrival processes and every synth knob."""
    for make in (lambda m, r: m.poisson_arrivals(12.0, 3.0, r),
                 lambda m, r: m.ramp_arrivals(1.0, 30.0, 4.0, r)):
        t_arr = make(tlg, random.Random(seed))
        j_arr = make(jlg, random.Random(seed))
        assert t_arr == j_arr
        kw = dict(tenants=3, sessions=5, prompt_tokens=(2, 9),
                  max_new=(1, 6), seed=seed)
        assert json.dumps(tlg.synthesize(t_arr, **kw)) == \
            json.dumps(jlg.synthesize(j_arr, **kw))
    assert tlg.zipf_weights(7, 1.3) == jlg.zipf_weights(7, 1.3)


def _rows(seed, n=60):
    rng = random.Random(seed)
    rows = []
    for i in range(n):
        cls = rng.choice(["interactive", "standard", "batch"])
        status = rng.choices(["ok", "shed", "error", "timeout", "dropped"],
                             [0.8, 0.08, 0.04, 0.04, 0.04])[0]
        row = {"class": cls, "tenant": f"tenant{rng.randrange(3)}",
               "status": status, "t": round(i * 0.05, 6)}
        if status == "ok":
            row.update(ttft_s=rng.uniform(0.01, 1.2),
                       tpot_s=rng.uniform(0.002, 0.2),
                       tokens=rng.randrange(1, 20))
        rows.append(row)
    return rows


@pytest.mark.parametrize("seed", [1, 7])
def test_scorecard_and_compare_equal_the_reference(seed):
    rows_a, rows_b = _rows(seed), _rows(seed + 100)
    card_t, card_j = tlg.build_scorecard(rows_a), jlg.build_scorecard(rows_a)
    assert card_t == card_j
    base_t = tlg.baseline_from_scorecard(card_t)
    assert base_t == jlg.baseline_from_scorecard(card_j)
    other = tlg.build_scorecard(rows_b)
    assert tlg.compare(other, base_t) == jlg.compare(
        jlg.build_scorecard(rows_b), base_t)
    # the checked-in baseline, scored the same way by both
    with open(BASELINE, encoding="utf-8") as fp:
        checked_in = json.load(fp)
    assert tlg.compare(card_t, checked_in) == jlg.compare(card_j,
                                                          checked_in)
    assert tlg.percentile([3.0, 1.0, 2.0], 90) == \
        jlg.percentile([3.0, 1.0, 2.0], 90)


def test_trace_written_by_either_package_reads_in_the_other(tmp_path):
    events = tlg.synthesize(tlg.poisson_arrivals(8.0, 2.0, random.Random(4)),
                            tenants=2, sessions=3, seed=4)
    for writer, reader in ((tlg, jlg), (jlg, tlg)):
        path = str(tmp_path / f"{writer.__name__}.jsonl")
        assert writer.dump_trace(events, path, source="twin") == len(events)
        header, loaded = reader.load_trace(path)
        assert header["source"] == "twin"
        assert loaded == writer.load_trace(path)[1]
        buf_t, buf_j = io.StringIO(), io.StringIO()
        tlg.dump_trace(loaded, buf_t, source="twin")
        jlg.dump_trace(loaded, buf_j, source="twin")
        assert buf_t.getvalue() == buf_j.getvalue()
    for event in events:
        assert tlg.prompt_text(event) == jlg.prompt_text(event)


def test_capture_export_equals_the_reference():
    prompts = [("shared system prompt: turn one", "interactive", "acme", 4),
               ("shared system prompt: turn two, longer", "interactive",
                "acme", 4),
               ("something else entirely", "batch", None, 2)]
    caps = [tlg.TraceCapture(capacity=8, block=8),
            jlg.TraceCapture(capacity=8, block=8)]
    for prompt, cls, tenant, max_new in prompts:
        for cap in caps:
            cap.note(prompt, qos_class=cls, tenant=tenant, max_new=max_new)
    (h_t, e_t), (h_j, e_j) = caps[0].export(), caps[1].export()
    strip = lambda events: [{k: v for k, v in e.items() if k != "t"}  # noqa: E731
                            for e in events]
    assert strip(e_t) == strip(e_j)
    assert h_t["captured_total"] == h_j["captured_total"] == 3


def test_cli_synth_equals_the_reference_cli(tmp_path):
    """``python -m gofr_tpu_torch.loadgen synth`` writes the trace the
    reference's ``tools/loadgen.py synth`` writes for the same flags."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    flags = ["synth", "--rate", "6", "--seconds", "2", "--seed", "3",
             "--tenants", "2"]
    out_t, out_j = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    for cmd, out in (([sys.executable, "-m", "gofr_tpu_torch.loadgen"],
                      out_t),
                     ([sys.executable, os.path.join(root, "tools",
                                                    "loadgen.py")], out_j)):
        proc = subprocess.run(cmd + flags + ["--out", out], cwd=root,
                              capture_output=True, text=True, timeout=120,
                              env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert proc.returncode == 0, proc.stderr
    assert load_trace(out_t)[1] == load_trace(out_j)[1]
    assert load_trace(out_t)[1]


# ------------------------------------------------------- live debug e2e ----
@pytest.fixture(scope="module")
def live_fleet():
    """One port replica at the debug preset on the CPU, QoS, pub/sub and
    the capacity observatory on, behind the port's router
    (serve_router.build_app), shared by the e2e tests below."""
    from gofr_tpu_torch import serve, serve_router

    replica = serve.build_app({
        "HTTP_PORT": "0", "METRICS_PORT": "0", "APP_NAME": "lg-r0",
        "GRPC_PORT": "0",
        "MODEL_PRESET": "debug", "PAGED": "true", "PAGE_SIZE": "16",
        "MAX_SEQ_LEN": "256", "PREFILL_BUCKETS": "16,64,128", "MAX_BATCH": "4",
        "WARMUP": "false", "REQUEST_TIMEOUT": "60", "LOG_LEVEL": "ERROR",
        "QOS": "true", "PUBSUB_BACKEND": "inproc", "CAPACITY_WINDOW_S": "4",
        "CAPACITY_RHO_WARN": "0.5", "INCIDENT_AUTOPSY": "false",
        "HOSTPROF": "false", "INCIDENT_DIR": INCIDENT_DIR}, device="cpu")
    replica.start()
    try:
        router = serve_router.build_app({
            "HTTP_PORT": "0", "METRICS_PORT": "0", "APP_NAME": "lg-router",
            "REQUEST_TIMEOUT": "60", "LOG_LEVEL": "ERROR",
            "FLEET_REPLICAS": f"r0=http://127.0.0.1:{replica.http_port}",
            "FLEET_PROBE_S": "0.3", "ELASTIC": "false",
            "INCIDENT_DIR": INCIDENT_DIR})
        router.start()
        try:
            yield {"router": router, "replica": replica,
                   "base": f"http://127.0.0.1:{router.http_port}"}
        finally:
            router.shutdown()
    finally:
        replica.shutdown()


def _get_json(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        body = json.loads(resp.read().decode())
    return body.get("data", body) if isinstance(body, dict) else body


def test_e2e_capture_replay_reproduces(live_fleet):
    """Open-loop run through the router -> the router's capture (class and
    tenant kept) -> replay the capture -> the replay's scorecard holds the
    first run's goodput and presence per class. Its latency checks are made
    and printed here, and held on the card (``chip_smoke.py --fleet``): the
    CPU shared by the test workers moves a TTFT by more than the 150 ms
    band."""
    base = live_fleet["base"]
    events = synthesize(poisson_arrivals(4.0, 3.0, random.Random(2)),
                        tenants=2, sessions=4, prompt_tokens=(2, 6),
                        max_new=(2, 4), seed=2)
    rows_a = OpenLoopRunner(base, events, timeout_s=60.0).run(
        drain_timeout_s=120.0)
    assert len(rows_a) == len(events)
    assert all(r["status"] == "ok" for r in rows_a), rows_a
    # each stream ends at its max_new, or earlier at the tokenizer's EOS
    assert all(1 <= r["tokens"] <= e["max_new"] for r, e in
               zip(sorted(rows_a, key=lambda r: r["i"]), events))
    doc = _get_json(base + "/debug/trace")
    captured = doc["events"]
    # the router saw everything the generator offered, and kept the
    # classes and tenants (a replica's recorder keeps neither)
    assert len(captured) >= len(rows_a)
    assert all("prompt" not in e for e in captured)
    assert {e.get("class") for e in captured} == {
        e["class"] for e in events}
    assert {e.get("tenant") for e in captured} == {
        e["tenant"] for e in events}
    rows_b = OpenLoopRunner(base, captured, timeout_s=60.0).run(
        drain_timeout_s=120.0)
    assert all(r["status"] == "ok" for r in rows_b), rows_b
    comparison = compare(build_scorecard(rows_b),
                         baseline_from_scorecard(build_scorecard(rows_a)))
    print(json.dumps(comparison["checks"]))
    drifted = [c for c in comparison["checks"]
               if c.get("metric") in ("goodput", "presence")
               and c["verdict"] == "regress"]
    assert not drifted, drifted
    assert {"ttft_ms_p50", "ttft_ms_p95", "goodput"} <= {
        c.get("metric") for c in comparison["checks"]}
    assert {c.get("class") for c in comparison["checks"]} >= {
        e["class"] for e in events}


def test_e2e_replica_trace_export(live_fleet):
    """The replica's flight recorder serves the same surface."""
    replica = live_fleet["replica"]
    doc = _get_json(f"http://127.0.0.1:{replica.http_port}/debug/trace")
    assert doc["trace_version"] == TRACE_VERSION
    assert doc["source"] == "flight_recorder"
    assert doc["events"], "the recorder saw traffic but exported no events"
    assert all("prompt" not in e for e in doc["events"])


def test_e2e_classes_and_tenants_reach_the_replica(live_fleet):
    """The runner's X-QoS-Class / X-Tenant headers cross the router and
    land in the replica's QoS ledgers and its capacity meter's tenants."""
    base = live_fleet["base"]
    rbase = f"http://127.0.0.1:{live_fleet['replica'].http_port}"
    before = _get_json(rbase + "/debug/qos")["classes"]
    events = [make_event(t=0.05 * i, prompt_tokens=3, seed=i, max_new=2,
                         cls=cls, tenant=f"t{i % 2}")
              for i, cls in enumerate(["interactive", "standard", "batch"])]
    rows = OpenLoopRunner(base, events, timeout_s=60.0).run(
        drain_timeout_s=60.0)
    assert [r["status"] for r in rows] == ["ok"] * 3
    after = _get_json(rbase + "/debug/qos")["classes"]
    for cls in ("interactive", "standard", "batch"):
        assert after[cls]["finished"] == before[cls]["finished"] + 1
    tenants = json.dumps(_get_json(rbase + "/debug/capacity"))
    assert '"t0"' in tenants and '"t1"' in tenants
    routed = _get_json(base + "/debug/fleet")["classes"]["routes"]
    assert all(routed.get(cls, 0) >= 1
               for cls in ("interactive", "standard", "batch"))


def test_e2e_knee_forecaster_cross_check(live_fleet):
    """Knee mode through the router, polling the fleet capacity rollup
    (GET /debug/fleet/capacity): the drill gets forecast samples with a
    replicas_needed of at least 1, every arrival is recorded, and when a
    blowout was measured the collapse warning fired first."""
    base = live_fleet["base"]
    result = run_knee(
        base, lambda: _get_json(base + "/debug/fleet/capacity", timeout=5),
        rate0_rps=2.0, rate1_rps=8.0, seconds=3.0, poll_s=0.3,
        drain_timeout_s=90.0, request_timeout_s=60.0,
        synth_kw={"tenants": 2, "prompt_tokens": (2, 4),
                  "max_new": (3, 6)})
    assert result["samples"], "the fleet capacity surface never answered"
    assert result["ramp"]["arrivals"] == len(result["rows"])
    assert all(isinstance(s["replicas_needed"], int)
               and s["replicas_needed"] >= 1 for s in result["samples"])
    assert result["agrees"], result["detail"]
    assert {"baseline_ttft_ms", "blowout_ttft_ms", "peak_rho",
            "collapse_warning_at_s", "first_blowout_at_s",
            "status"} <= set(result)
