"""The port's framework layers against the reference's on the same inputs.

- config: EnvFile's overlays and the typed getters;
- metrics: the same recordings expose the same Prometheus and OpenMetrics
  text (exemplars at a fixed clock), and the same percentiles;
- tracing: traceparent parsing and emitting, and each exporter's payload
  for the same span (HTTP JSON, Zipkin, OTLP/HTTP, the OTLP/gRPC protobuf
  bytes), the exporter each TRACE_EXPORTER selects, and the body an HTTP
  exporter POSTs to a collector on localhost;
- logging: the JSON line's fields for the same calls;
- the default middleware chain: statuses, headers (X-Trace-Id, CORS), the
  server span, the request log and app_http_response for the same
  requests through both chains;
- the engines: the same greedy requests on both paged engines record equal
  request and token counts and equal counts in every app_tpu_* histogram;
- one /generate call on both servers: the same span names and parenting
  under an inbound traceparent, streamed and not. The reference's flight
  recorder (its synthesized child spans; ROADMAP A11) is off.
"""

import http.client
import http.server
import importlib.util
import json
import pathlib
import threading
import types

import jax
import numpy as np
import pytest

from gofr_tpu import config as jconfig
from gofr_tpu import logging as jlogging
from gofr_tpu import metrics as jmetrics
from gofr_tpu import tracing as jtracing
from gofr_tpu.http import middleware as jmw
from gofr_tpu.http.request import Request as JRequest
from gofr_tpu.http.responder import Response as JResponse
from gofr_tpu.http.router import Router as JRouter
from gofr_tpu.models.llama import LlamaConfig as JConfig
from gofr_tpu.models.llama import llama_init as jax_init
from gofr_tpu.tpu.device import TPUClient
from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
from gofr_tpu_torch import config as tconfig
from gofr_tpu_torch import logging as tlogging
from gofr_tpu_torch import metrics as tmetrics
from gofr_tpu_torch import tracing as ttracing
from gofr_tpu_torch.http import middleware as tmw
from gofr_tpu_torch.http.request import Request as TRequest
from gofr_tpu_torch.http.responder import Response as TResponse
from gofr_tpu_torch.http.router import Router as TRouter
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.serve import build_app, build_engine
from gofr_tpu_torch.tpu.device import register_metrics
from gofr_tpu_torch.tpu.paging import PagedLLMEngine

from _torch_env import INCIDENT_DIR

ROOT = pathlib.Path(__file__).resolve().parents[1]


class _QuietLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


# -- config -------------------------------------------------------------------
@pytest.mark.parametrize("app_env", ["", "staging"])
def test_env_file_overlays_match(tmp_path, app_env):
    (tmp_path / ".env").write_text(
        "# comment\nA=1\nB='two'\nC=\"3.5\"\nD=yes\nE=x\nnot a pair\n")
    (tmp_path / ".local.env").write_text("A=local\n")
    (tmp_path / ".staging.env").write_text("A=staged\nB=b2\n")
    environ = {"E": "from-env", **({"APP_ENV": app_env} if app_env else {})}
    keys = ["A", "B", "C", "D", "E", "MISSING"]
    got = tconfig.EnvFile(str(tmp_path), environ=environ)
    want = jconfig.EnvFile(str(tmp_path), environ=environ)
    for key in keys:
        assert got.get(key) == want.get(key)
        assert got.get_or_default(key, "d") == want.get_or_default(key, "d")
        assert got.get_int(key, 7) == want.get_int(key, 7)
        assert got.get_float(key, 0.5) == want.get_float(key, 0.5)
        assert got.get_bool(key, True) == want.get_bool(key, True)
    mock = tconfig.as_config({"A": "1"})
    assert isinstance(mock, tconfig.MockConfig) and mock.get("A") == "1"
    assert tconfig.as_config(got) is got


# -- metrics ------------------------------------------------------------------
def _record(mod, script):
    m = mod.Manager()
    m.new_counter("c_total", "a counter")
    m.new_updown_counter("u", "an up-down counter")
    m.new_gauge("g", "a gauge")
    m.new_histogram("h_seconds", "a histogram", (1e-05, 0.001, 0.25, 1, 2.5))
    m.new_histogram("d", "default buckets")
    for op, *args in script:
        kw = args[-1] if args and isinstance(args[-1], dict) else {}
        pos = args[:-1] if kw else args
        getattr(m, op)(*pos, **kw)
    return m


SCRIPTS = {
    "empty": [],
    "counters": [("increment_counter", "c_total"),
                 ("increment_counter", "c_total", 2.5, {"path": "/a"}),
                 ("increment_counter", "c_total", 1, {"path": 'q"\\\n'}),
                 ("delta_updown_counter", "u", -3)],
    "gauges": [("set_gauge", "g", 4, {"kind": "x"}), ("set_gauge", "g", 0.25)],
    "histograms": [("record_histogram", "h_seconds", 0.0005),
                   ("record_histogram", "h_seconds", 3.0, {"route": "/r"}),
                   ("record_histogram_n", "h_seconds", 0.2, 7),
                   ("record_histogram_n", "h_seconds", 0.2, 0),
                   ("record_histogram", "d", 0.07)],
    "exemplars": [("record_histogram", "h_seconds", 0.1,
                   {"exemplar": {"trace_id": "ab", "request_id": 3}}),
                  ("record_histogram_n", "h_seconds", 9.0, 2,
                   {"exemplar": {"request_id": 4}})],
}


@pytest.mark.parametrize("openmetrics", [False, True])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_exposition_text_matches(monkeypatch, script, openmetrics):
    clock = types.SimpleNamespace(time=lambda: 1700000000.1234)
    monkeypatch.setattr(jmetrics, "time", clock)
    monkeypatch.setattr(tmetrics, "time", clock)
    want = _record(jmetrics, SCRIPTS[script]).expose(openmetrics=openmetrics)
    got = _record(tmetrics, SCRIPTS[script]).expose(openmetrics=openmetrics)
    assert got == want


def test_percentiles_and_bucket_bounds_match():
    values = [0.003, 0.02, 0.02, 0.4, 1.7, 8.0, 0.09, 0.11]
    hists = [mod.Histogram("h", "h", (0.01, 0.05, 0.1, 0.5, 1, 5))
             for mod in (jmetrics, tmetrics)]
    for h in hists:
        for v in values:
            h.record(v)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert hists[1].percentile(q) == hists[0].percentile(q)
    assert np.isnan(hists[1].percentile(0.5, route="none"))
    for bound in (1, 1.0, 0.1, 1e-05, 2.5e-7, 1e20, float("inf"), -3):
        assert (tmetrics.format_bucket_bound(bound)
                == jmetrics.format_bucket_bound(bound))


def test_duplicate_and_missing_metrics_match():
    for mod in (jmetrics, tmetrics):
        m = mod.Manager()
        m.new_counter("x", "x")
        with pytest.raises(mod.DuplicateMetric):
            m.new_counter("x", "x")
        with pytest.raises(mod.MetricNotFound):
            m.set_gauge("x", 1)


# -- tracing ------------------------------------------------------------------
TRACE_ID, SPAN_ID = "0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331"


@pytest.mark.parametrize("header", [
    f"00-{TRACE_ID}-{SPAN_ID}-01", f" 00-{TRACE_ID}-{SPAN_ID}-00 ",
    f"00-{TRACE_ID}-{SPAN_ID}", f"00-{TRACE_ID[:-1]}-{SPAN_ID}-01",
    "garbage", ""])
def test_traceparent_round_trip_matches(header):
    assert (ttracing.parse_traceparent(header)
            == jtracing.parse_traceparent(header))
    spans = [mod.Tracer().start_span("s", traceparent=header)
             for mod in (jtracing, ttracing)]
    parsed = jtracing.parse_traceparent(header)
    for span in spans:
        if parsed:
            assert (span.trace_id, span.parent_id) == parsed
        else:
            assert span.parent_id is None and len(span.trace_id) == 32
        assert span.traceparent == f"00-{span.trace_id}-{span.span_id}-01"
    child = ttracing.Tracer().start_span("c", parent=spans[1])
    assert (child.trace_id, child.parent_id) == (spans[1].trace_id,
                                                 spans[1].span_id)


def _span(mod, ok=True):
    span = mod.Span(mod.Tracer(), "tpu.generate", TRACE_ID, SPAN_ID)
    span.span_id = "1122334455667788"
    span.start_time, span.end_time = 1700000000.25, 1700000000.75
    span.attributes = {"tpu.prompt_tokens": 7, "http.method": "POST",
                       "ratio": 0.5, "flag": True}
    if not ok:
        span.set_status(False, "boom")
    return span


@pytest.mark.parametrize("ok", [True, False], ids=["ok", "error"])
@pytest.mark.parametrize("kind", ["http", "zipkin", "otlp", "otlp-grpc"])
def test_exporter_payloads_match(kind, ok):
    payloads = []
    for mod in (jtracing, ttracing):
        span = _span(mod, ok)
        cls = {"http": mod.HTTPExporter, "zipkin": mod.ZipkinExporter,
               "otlp": mod.OTLPHTTPExporter,
               "otlp-grpc": mod.OTLPGRPCExporter}[kind]
        exp = (cls("http://x") if kind == "http"
               else cls("http://x", service_name="svc"))
        if kind == "otlp-grpc":
            payloads.append(exp._encode_request([span, span]))
        else:
            payloads.append(exp._wrap_batch([exp._span_payload(span)]))
    assert payloads[1] == payloads[0]


@pytest.mark.parametrize("name", ["", "log", "memory", "zipkin", "jaeger",
                                  "otlp", "otlp-grpc", "http", "gofr",
                                  "unknown"])
@pytest.mark.parametrize("url", ["", "http://127.0.0.1:9"])
def test_exporter_from_config_selects_the_same_exporter(name, url):
    values = {"TRACE_EXPORTER": name, "TRACER_URL": url, "APP_NAME": "svc"}
    got = ttracing.exporter_from_config(tconfig.MockConfig(values),
                                        tlogging.MockLogger())
    want = jtracing.exporter_from_config(jconfig.MockConfig(values),
                                         jlogging.MockLogger())
    assert type(got).__name__ == type(want).__name__
    assert getattr(got, "service_name", None) == getattr(want,
                                                         "service_name", None)


def test_http_exporter_posts_the_reference_body():
    bodies = []

    class Collector(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            bodies.append(self.rfile.read(int(self.headers["Content-Length"])))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Collector)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/api/v2/spans"
        exp = ttracing.ZipkinExporter(url, service_name="svc", batch_size=2)
        tracer = ttracing.Tracer(exporter=exp)
        spans = [_span(ttracing), _span(ttracing, ok=False)]
        for span in spans:
            span.tracer = tracer
            span.end_time = None
            span.end()
        assert exp.flush(timeout_s=10)
        exp.close()
    finally:
        server.shutdown()
        server.server_close()
    ref = jtracing.ZipkinExporter(url, service_name="svc")
    assert len(bodies) == 1
    got = json.loads(bodies[0])
    want = ref._wrap_batch([ref._span_payload(s) for s in spans])
    for g, w in zip(got, want):
        w["duration"] = g["duration"]   # the spans ended at send time
    assert got == want


# -- logging ------------------------------------------------------------------
def _log_lines(mod, request_log):
    logger = mod.MockLogger(level=mod.Level.DEBUG)
    logger.infof("engine warmed up in %.1fs%s", 1.25, " (wide)")
    logger.debugf("plain")
    logger.warn({"error": "x", "panic": True})
    logger.error("a", 2, "b")
    logger.notice(request_log)
    logger.change_level(mod.Level.ERROR)
    logger.info("dropped")
    return [json.loads(line) for line in logger.output().splitlines()]


def test_json_log_lines_match():
    want = _log_lines(jlogging, jmw.RequestLog("t", "GET", "/p", 200, 12,
                                               "1.2.3.4"))
    got = _log_lines(tlogging, tmw.RequestLog("t", "GET", "/p", 200, 12,
                                              "1.2.3.4"))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"level", "time", "message"}
        assert (g["level"], g["message"]) == (w["level"], w["message"])
    for name in ("debug", "INFO", " warn ", "fatal", "nope", None):
        assert (tlogging.parse_level(name).name
                == jlogging.parse_level(name).name)


# -- the default middleware chain ---------------------------------------------
def _chain(side):
    if side == "ref":
        mods, Router, Response = (jmw, jmetrics, jtracing, jlogging), \
            JRouter, JResponse
    else:
        mods, Router, Response = (tmw, tmetrics, ttracing, tlogging), \
            TRouter, TResponse
    mw, metrics, tracing, logging = mods
    manager = metrics.Manager()
    manager.new_histogram("app_http_response", "http response time",
                          (0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1, 3, 10, 30))
    exporter = tracing.InMemoryExporter()
    logger = logging.MockLogger()
    router = Router()
    router.use_middleware(mw.tracer_middleware(tracing.Tracer(
        exporter=exporter)), mw.logging_middleware(logger),
        mw.cors_middleware(), mw.metrics_middleware(manager))

    def ok(request):
        return Response(status=201, body=b"{}")

    def boom(request):
        raise RuntimeError("boom")

    router.add("POST", "/items/{id}", ok)
    router.add("GET", "/boom", boom)
    return router, manager, exporter, logger


CHAIN_REQUESTS = [("POST", "/items/7", {"traceparent":
                                        f"00-{TRACE_ID}-{SPAN_ID}-01"}),
                  ("POST", "/items/8", {}), ("GET", "/items/7", {}),
                  ("GET", "/nowhere", {}), ("OPTIONS", "/items/7", {}),
                  ("GET", "/boom", {})]


def test_default_chain_matches():
    seen = {}
    for side, Request in (("ref", JRequest), ("port", TRequest)):
        router, manager, exporter, logger = _chain(side)
        out = []
        for method, path, headers in CHAIN_REQUESTS:
            resp = router.dispatch(Request(method, path, headers=headers,
                                           client_addr="1.2.3.4"))
            span = exporter.spans[-1]
            trace = resp.headers.get("X-Trace-Id")
            out.append((resp.status, trace == span.trace_id,
                        trace == TRACE_ID,
                        {k: v for k, v in resp.headers.items()
                         if k != "X-Trace-Id"},
                        span.name, span.parent_id, span.status_ok,
                        span.attributes))
        logs = [json.loads(line) for line in logger.output().splitlines()]
        series = sorted(k for k in manager.get("app_http_response").series)
        # a request log line: trace id, status, duration, method, uri
        seen[side] = (out, [(r["level"], r["message"] if isinstance(
            r["message"], dict) else [r["message"].split()[i]
                                      for i in (1, 3, 4)])
            for r in logs], series)
    assert seen["port"] == seen["ref"]


# -- the engines' metric series -----------------------------------------------
CFG = LlamaConfig.debug()
ENGINE = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16), page_size=8)
REQUESTS = [([5, 6, 7], 8), (list(range(9, 18)), 12), ([1, 2], 5),
            (list(range(40, 54)), 20), ([3, 4], 9)]
HISTS = ("app_tpu_ttft_seconds", "app_tpu_queue_wait_seconds",
         "app_tpu_tpot_seconds", "app_tpu_batch_size",
         "app_tpu_execute_seconds")


def _series(manager):
    def one(name):
        return manager.get(name).series.get((), 0.0)
    out = {n: one(n) for n in ("app_tpu_requests_total",
                               "app_tpu_tokens_generated_total")}
    for name in HISTS:
        entry = manager.get(name).series.get(())
        out[name] = entry["count"] if entry else 0
    return out


def test_engine_metric_series_match():
    jparams = jax_init(JConfig.debug(), seed=0)
    jm = jmetrics.Manager()
    client = TPUClient(None)
    client.use_metrics(jm)
    client.register_metrics()
    tm = tmetrics.Manager()
    register_metrics(tm)
    engines = [JPaged(jparams, JConfig.debug(), logger=_QuietLogger(),
                      metrics=jm, **ENGINE),
               PagedLLMEngine(params_from_numpy(jax.device_get(jparams),
                                                device="cpu"), CFG,
                              device="cpu", metrics=tm, **ENGINE)]
    results = []
    for eng in engines:
        # every request queued before the loop starts: one admission round,
        # the same dispatches on both engines
        reqs = [eng.submit(p, max_new_tokens=n, temperature=0.0)
                for p, n in REQUESTS]
        eng.start()
        try:
            results.append([r.result(timeout_s=120) for r in reqs])
        finally:
            eng.stop()
    assert results[1] == results[0]
    got, want = _series(tm), _series(jm)
    assert got == want
    assert got["app_tpu_requests_total"] == len(REQUESTS)
    assert got["app_tpu_tokens_generated_total"] == sum(
        len(r) for r in results[0])
    assert got["app_tpu_ttft_seconds"] == len(REQUESTS)
    assert tm.get("app_tpu_active_slots").series[()] == 0.0
    assert tm.get("app_tpu_queue_depth").series[()] == 0.0


# -- the span tree of one /generate call --------------------------------------
ENV = {"MODEL_PRESET": "debug", "HTTP_PORT": "0", "METRICS_PORT": "0",
       "GRPC_PORT": "0",
       "MAX_BATCH": "2", "MAX_SEQ_LEN": "64", "PREFILL_BUCKETS": "8,16",
       "PAGE_SIZE": "8", "WARMUP": "false", "TRACE_EXPORTER": "memory",
       "LOG_LEVEL": "WARN", "FLIGHT_RECORDER": "false",
       "INCIDENT_DIR": INCIDENT_DIR}


@pytest.fixture(scope="module")
def generate_servers():
    spec = importlib.util.spec_from_file_location(
        "example_llm_server_torch_spans",
        ROOT / "examples" / "llm-server" / "main.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    ref = module.build_app(config=jconfig.MockConfig(
        {**ENV, "TPU_PLATFORM": "cpu"}))
    params = params_from_numpy(jax.device_get(ref.engine.params),
                               device="cpu")
    port = build_app(ENV, engine=build_engine(ENV, device="cpu",
                                              params=params))
    ref.start()
    try:
        port.start()
        try:
            yield ref, port
        finally:
            port.shutdown()
    finally:
        ref.shutdown()


@pytest.mark.parametrize("stream", [True, False], ids=["sse", "json"])
def test_generate_span_tree_matches(generate_servers, stream):
    trees = []
    for app in generate_servers:
        exporter = app.container.tracer.exporter
        conn = http.client.HTTPConnection("127.0.0.1", app.http_port,
                                          timeout=120)
        conn.request("POST", "/generate", body=json.dumps(
            {"prompt": "hello", "max_tokens": 6, "stream": stream}),
            headers={"traceparent": f"00-{TRACE_ID}-{SPAN_ID}-01"})
        resp = conn.getresponse()
        resp.read()
        conn.close()
        assert resp.getheader("X-Trace-Id") == TRACE_ID
        # the engine ends tpu.generate at the request's finish, which the
        # client may see first
        for _ in range(200):
            spans = [s for s in exporter.spans if s.trace_id == TRACE_ID]
            if any(s.name == "tpu.generate" for s in spans):
                break
            threading.Event().wait(0.01)
        by_id = {s.span_id: s for s in spans}
        trees.append(sorted(
            (s.name, by_id[s.parent_id].name if s.parent_id in by_id
             else s.parent_id, sorted(s.attributes))
            for s in spans))
        exporter.spans.clear()
    assert trees[1] == trees[0]
    assert [(n, p) for n, p, _ in trees[0]] == [
        ("POST /generate", SPAN_ID), ("tpu.generate", "POST /generate")]


# -- the App: handler slots, well-known routes, the metrics server -----------
def _apps():
    """(reference App, port App) with one handler slot and the same routes:
    /slow blocks until released, /stream streams until released."""
    from gofr_tpu import App as JApp
    from gofr_tpu import Stream as JStream
    from gofr_tpu_torch.app import App as TApp
    from gofr_tpu_torch.app import Stream as TStream

    values = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "WARN",
              "MAX_CONCURRENT_REQUESTS": "1", "REQUEST_TIMEOUT": "30"}
    apps = []
    for App, Stream, cfg in ((JApp, JStream, jconfig.MockConfig(values)),
                             (TApp, TStream, dict(values))):
        app = App(config=cfg)
        app.release = threading.Event()
        app.entered = threading.Event()

        def slow(ctx, app=app):
            app.entered.set()
            app.release.wait(30)
            return {"ok": True}

        def stream(ctx, app=app, Stream=Stream):
            def chunks():
                app.entered.set()
                yield {"n": 1}
                app.release.wait(30)
                yield {"n": 2}
            return Stream(chunks(), sse=True)

        app.get("/slow", slow)
        app.get("/stream", stream)
        app.get("/fast", lambda ctx: {"fast": True})
        apps.append(app)
    return apps


def _get(port, path, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path, headers=headers or {})
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), body


@pytest.mark.parametrize("holder", ["/slow", "/stream"])
def test_handler_slots_shed_like_the_reference(holder):
    seen = []
    for app in _apps():
        app.start()
        try:
            out = {}
            held = threading.Thread(target=lambda: out.setdefault(
                "held", _get(app.http_port, holder)))
            held.start()
            assert app.entered.wait(30)
            # the one slot is taken (a stream holds it until its body ends)
            busy = _get(app.http_port, "/fast")[0]
            alive = _get(app.http_port, "/.well-known/alive")
            app.release.set()
            held.join(timeout=60)
            assert not held.is_alive()
            after = _get(app.http_port, "/fast")[0]
            seen.append((busy, alive[0], json.loads(alive[2]),
                         out["held"][0], after))
        finally:
            app.release.set()
            app.shutdown()
    assert seen[1] == seen[0]
    assert seen[0][:2] == (503, 200)


def test_metrics_server_matches_the_reference():
    seen = []
    for app in _apps()[::-1]:
        app.start()
        try:
            assert _get(app.http_port, "/fast")[0] == 200
            classic = _get(app.metrics_port, "/metrics")
            om = _get(app.metrics_port, "/metrics",
                      {"Accept": "application/openmetrics-text"})
            alive = _get(app.metrics_port, "/.well-known/alive")
            health = json.loads(_get(app.metrics_port,
                                     "/.well-known/health")[2])
            lines = [line for line in classic[2].splitlines()
                     if line.startswith("app_http_response_count")]
            seen.append((classic[0], classic[1], om[1],
                         om[2].rstrip().endswith("# EOF"), alive,
                         health["status"], lines,
                         "app_uptime_seconds" in classic[2]))
        finally:
            app.release.set()
            app.shutdown()
    assert seen[0] == seen[1]
    assert seen[0][6] == ['app_http_response_count{method="GET",'
                          'path="/fast",status="200"} 1']


def test_app_reads_its_keys_from_gofr_configs_dir(tmp_path, monkeypatch):
    from gofr_tpu import App as JApp
    from gofr_tpu_torch.app import App as TApp

    (tmp_path / ".env").write_text(
        "APP_NAME=from-file\nAPP_VERSION=1.2\nHTTP_PORT=8123\n"
        "METRICS_PORT=0\nREQUEST_TIMEOUT=7.5\nLOG_LEVEL=WARN\n"
        "MAX_CONCURRENT_REQUESTS=3\n")
    monkeypatch.setenv("GOFR_CONFIGS_DIR", str(tmp_path))
    monkeypatch.setenv("HTTP_PORT", "8124")     # the environment wins
    seen = [(app.container.app_name, app.container.app_version,
             app.http_port, app.metrics_port, app.request_timeout_s,
             app.max_concurrent_requests, app.logger.level.name)
            for app in (JApp(), TApp())]
    assert seen[1] == seen[0] == ("from-file", "1.2", 8124, 0, 7.5, 3,
                                  "WARN")


def test_container_health_aggregation_matches():
    from gofr_tpu.container import Container as JContainer
    from gofr_tpu_torch.container import Container as TContainer

    sequence = ["UP", "DEGRADED", "DEGRADED", "UP", "DOWN", "DEGRADED",
                "boom", "UP"]
    seen = []
    for container in (JContainer(jconfig.MockConfig({"APP_NAME": "a"})),
                      TContainer(tconfig.MockConfig({"APP_NAME": "a"}))):
        states = iter(sequence)

        def engine():
            state = next(states)
            if state == "boom":
                raise RuntimeError("probe failed")
            return {"status": state, "queue_depth": 0}

        container.add_health_contributor("engine", engine)
        out = []
        for _ in sequence:
            h = container.health()
            out.append((h["name"], h["status"], h.get("degrading"),
                        h["details"]["engine"].get("status"),
                        sorted(h)))
        seen.append(out)
    assert seen[1] == seen[0]
