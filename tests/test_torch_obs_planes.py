"""The port's observability planes against the reference's.

Module by module, on the same seeded call sequence and one fake clock
patched into both modules (``time.monotonic`` / ``time.time``), the
reference class and the port's give equal payloads: the step ledger's
``snapshot()`` (a straggler flagged at the same step, an aborted step, a
re-attributed compile), the utilization ledger's ``window_stats()`` and
analytic FLOPs and bytes (llama3-8b and debug, bf16 and int8 KV; integers
and the analytic counts exactly, floats within 1e-9), the flight
recorder's ``snapshot()`` / ``lookup()`` / ``slo_stats()`` and synthesized
spans, the journey waterfalls, the timeline export (thread ids and the
loop track's ownership list normalised; the capture track is named
``graph-capture`` in the port, ``xla-compile`` in the reference) and the
host profiler's classification and aggregation on synthetic stacks.

Engine against engine: a JAX PagedLLMEngine and the port's, on bridged
weights, serve the same greedy prompts, all submitted before ``start()``
and left to go idle before ``stop()``. They agree on the recorder's
per-request records, the step ledger's per-phase syncs and tokens and the
utilization window's FLOPs, bytes and tokens; in both, the ledgers'
tokens equal the tokens delivered.

Server against server: the reference llm-server and the port's, on the
CPU, answer /debug/engine, /debug/steps, /debug/requests[/{id}],
/debug/journey[/{id}], /debug/trace, /debug/timeline, /debug/hostprof and
/stats with the reference's keys (the differences named where they are
asserted: planes that wait in ROADMAP A11d-f, and card memory that the CPU
does not have).
"""

import dataclasses
import http.client
import importlib.util
import json
import pathlib
import threading
import time
import types

import jax
import numpy as np
import pytest

from gofr_tpu.config import MockConfig
from gofr_tpu.models import llama as jl
from gofr_tpu.tpu import flightrecorder as j_fr
from gofr_tpu.tpu import hostprof as j_hp
from gofr_tpu.tpu import journey as j_jr
from gofr_tpu.tpu import stepledger as j_sl
from gofr_tpu.tpu import timeline as j_tl
from gofr_tpu.tpu import utilization as j_ut
from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.serve import build_app, build_engine
from gofr_tpu_torch.tpu import flightrecorder as t_fr
from gofr_tpu_torch.tpu import hostprof as t_hp
from gofr_tpu_torch.tpu import journey as t_jr
from gofr_tpu_torch.tpu import stepledger as t_sl
from gofr_tpu_torch.tpu import timeline as t_tl
from gofr_tpu_torch.tpu import utilization as t_ut
from gofr_tpu_torch.tpu.paging import PagedLLMEngine as TPaged

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"


class Clock:
    """A fake ``time`` module: monotonic() and time() advance only when
    told to (time() is 1000 s ahead)."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return 1000.0 + self.t

    def tick(self, dt: float) -> None:
        self.t += dt


def assert_close(a, b, path="$"):
    """Equal structures; floats within 1e-9, everything else exactly."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, a, b)
        for k in a:
            assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert b == pytest.approx(a, rel=0, abs=1e-9), (path, a, b)
    else:
        assert a == b, (path, a, b)


# -- the step ledger ----------------------------------------------------------
def _drive_steps(module, scenario: str):
    clock = Clock()
    ledger = module.StepLedger(capacity=64, clock=clock.monotonic,
                               min_samples=4)
    for i in range(12):
        ledger.step_start()
        with ledger.seg("admission"):
            clock.tick(0.0005)
            with ledger.seg("page_alloc"):
                clock.tick(0.0002)
        ledger.note_dispatch("decode")
        with ledger.seg("dispatch"):
            clock.tick(0.001)
            if scenario == "compile" and i == 5:
                clock.tick(0.004)
                ledger.note_stolen("compile", 0.004)
        with ledger.seg("emit"):
            with ledger.seg("device_sync"):
                # step 10 stalls on the card: the straggler
                clock.tick(0.2 if scenario == "straggler" and i == 10
                           else 0.01)
            with ledger.seg("demux"):
                clock.tick(0.0003)
            clock.tick(0.0001)
        ledger.note_sync("decode", tokens=16, slowest_request_id=i + 1)
        clock.tick(0.00005)
        if scenario == "abort" and i == 7:
            ledger.step_abort()
        else:
            ledger.step_end(active_slots=4, inflight=3, queue_depth=i % 2)
        clock.tick(0.002)          # the park: the next step's idle gap
        ledger.step_start()        # an idle iteration is dropped
        clock.tick(0.001)
        ledger.step_end()
    return ledger


@pytest.mark.parametrize("scenario", ["plain", "straggler", "abort",
                                      "compile"])
def test_step_ledger_snapshot_matches(scenario):
    want = _drive_steps(j_sl, scenario)
    got = _drive_steps(t_sl, scenario)
    assert_close(want.snapshot(recent=64), got.snapshot(recent=64))
    assert t_sl.SEGMENTS == j_sl.SEGMENTS and t_sl.PHASES == j_sl.PHASES
    assert t_sl.STEP_SECONDS_BUCKETS == j_sl.STEP_SECONDS_BUCKETS
    snap = got.snapshot()
    if scenario == "straggler":
        assert snap["stragglers_total"] == 1
        assert snap["stragglers"][0]["step"] == 11
        assert snap["stragglers"][0]["cause"] == "device_sync"
    if scenario == "abort":
        assert snap["steps_total"] == 11
    for rec in got.records(64):   # the sum identity
        assert sum(rec.segments.values()) == pytest.approx(rec.wall_s)


def test_step_ledger_ignores_foreign_threads():
    ledger = t_sl.StepLedger()
    ledger.step_start()
    t = threading.Thread(target=lambda: (ledger.note_dispatch("decode"),
                                         ledger.note_stolen("compile", 1.0)))
    t.start()
    t.join()
    assert ledger.step_end() is None      # nothing this thread did counts


# -- the utilization ledger ---------------------------------------------------
def _configs():
    out = {}
    for name in ("debug", "llama3_8b"):
        for kv in (None, "int8"):
            out[f"{name}-{kv or 'bf16'}"] = (name, kv)
    return out


def _drive_util(module, cfg, params_nbytes):
    ledger = module.UtilizationLedger(cfg, params_nbytes=params_nbytes,
                                      platform="cpu", created_at=10.0,
                                      window_s=30.0)
    rng = np.random.default_rng(0)
    t = 10.0
    for i in range(40):
        start = t
        t += float(rng.uniform(0.001, 0.02))
        if i % 7 == 0:
            ledger.record_prefill(int(rng.integers(1, 300)), start, t,
                                  sync_wait_s=0.001)
        else:
            ledger.record_decode(int(rng.integers(1, 9)), 16,
                                 int(rng.integers(0, 4000)), start, t,
                                 sync_wait_s=0.0005)
        ledger.note_host(float(rng.uniform(0.0, 0.003)), now=t)
        t += float(rng.uniform(0.0, 0.01))
    return ledger, t


@pytest.mark.parametrize("config", sorted(_configs()))
def test_utilization_window_matches(config):
    name, kv = _configs()[config]
    jcfg = dataclasses.replace(getattr(jl.LlamaConfig, name)(), kv_dtype=kv)
    tcfg = dataclasses.replace(getattr(LlamaConfig, name)(), kv_dtype=kv)
    for nbytes in (None, 123456789):
        want, t_end = _drive_util(j_ut, jcfg, nbytes)
        got, _ = _drive_util(t_ut, tcfg, nbytes)
        w, g = want.window_stats(now=t_end), got.window_stats(now=t_end)
        assert g["tokens"] == w["tokens"]
        assert g["dispatches"] == w["dispatches"]
        assert_close(w, g)
        # the analytic counts, exactly
        for fn, args in ((t_ut.prefill_flops, (100,)),
                         (t_ut.decode_flops, (8, 16)),
                         (t_ut.prefill_bytes, (100, nbytes)),
                         (t_ut.decode_bytes, (8, 16, 3000, nbytes))):
            jfn = getattr(j_ut, fn.__name__)
            assert fn(tcfg, *args) == jfn(jcfg, *args)
        assert_close(want.device_slices(), got.device_slices())


def test_peaks_name_the_h100_row_and_nothing_else(monkeypatch):
    monkeypatch.delenv("TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("TPU_PEAK_HBM_BW", raising=False)
    assert t_ut.resolve_peaks("gpu", "NVIDIA H100 80GB HBM3") == (
        989e12, 3.35e12, "table")
    assert t_ut.resolve_peaks("gpu", "NVIDIA A100-SXM4-80GB")[2] == "default"
    assert t_ut.resolve_peaks("cpu", None) == (*t_ut.DEFAULT_PEAKS,
                                               "default")
    assert t_ut.DEFAULT_PEAKS == j_ut.DEFAULT_PEAKS
    monkeypatch.setenv("TPU_PEAK_FLOPS", "5e14")
    assert t_ut.resolve_peaks("gpu", "NVIDIA H100 80GB HBM3") == (
        5e14, 3.35e12, "env")


# -- the flight recorder and the journey --------------------------------------
class FakeTracer:
    def __init__(self):
        self.spans = []

    def span_at(self, name, start, end, trace_id=None, parent_id=None,
                attributes=None):
        self.spans.append((name, round(start, 6), round(end, 6), trace_id,
                           parent_id, dict(attributes or {})))


def _request(rid, clock, n_prompt, traced):
    return types.SimpleNamespace(
        id=rid, prompt_tokens=list(range(n_prompt)), max_new_tokens=8,
        priority=rid % 2, span=None, gen_span=None,
        traceparent=(f"00-{TRACE[:-2]}{rid:02x}-00f067aa0ba902b7-01"
                     if traced else None),
        enqueued_at=clock.monotonic(), admitted_at=None, first_token_at=None,
        finished_at=None, generated=0, error=None)


def _drive_recorder(module, monkeypatch):
    clock = Clock()
    monkeypatch.setattr(module, "time", clock)
    tracer = FakeTracer()
    rec = module.FlightRecorder(capacity=4, max_events=12, slo_ttft_s=0.05,
                                slo_tpot_s=0.01, slo_window=8, tracer=tracer)
    live = []
    for rid in range(1, 8):
        req = _request(rid, clock, 3 + rid, traced=rid % 3 != 0)
        rec.record_enqueued(req)
        live.append(req)
        clock.tick(0.01 * rid)
        req.admitted_at = clock.monotonic()
        rec.record_admitted(req, slot=rid % 4, bucket=16, batch_id=rid)
        clock.tick(0.02)
        req.first_token_at = clock.monotonic()
        rec.record_first_token(req)
        for _ in range(rid % 4 + 1):
            clock.tick(0.005 * rid)
            rec.record_decode_block(rid, 4, 0.001 * rid)
        if rid == 6:
            continue                       # left in flight
        req.generated = 1 + 4 * (rid % 4 + 1)
        req.finished_at = clock.monotonic()
        if rid == 5:
            req.error = RuntimeError("boom")
        rec.record_finished(req, "error" if rid == 5 else "length")
        clock.tick(0.001)
    rec.record_engine_event("cache_grow", new_len=64)
    rec.record_engine_event("stall_shed", stall_s=151.0)
    rec.record_event(6, "page_wait", once=True, need=3)
    rec.record_event(6, "page_wait", once=True, need=3)
    return rec, tracer


def test_flight_recorder_matches(monkeypatch):
    want, want_tracer = _drive_recorder(j_fr, monkeypatch)
    got, got_tracer = _drive_recorder(t_fr, monkeypatch)
    assert_close(want.snapshot(), got.snapshot())
    assert_close(want.slo_stats(), got.slo_stats())
    for rid in range(1, 9):
        assert_close(want.lookup(rid), got.lookup(rid))
    assert_close(want.timeline_records(), got.timeline_records())
    assert_close(want.lookup_trace(TRACE[:-2] + "01"),
                 got.lookup_trace(TRACE[:-2] + "01"))
    assert got_tracer.spans == want_tracer.spans
    assert got.finished_total == 6 and len(got) == 5


def test_journey_matches(monkeypatch):
    want, _ = _drive_recorder(j_fr, monkeypatch)
    got, _ = _drive_recorder(t_fr, monkeypatch)
    jeng = types.SimpleNamespace(recorder=want)
    teng = types.SimpleNamespace(recorder=got)
    assert_close(j_jr.journey_index(jeng), t_jr.journey_index(teng))
    for raw in ["4", "6", "3", TRACE[:-2] + "07", "99", "x" * 32, "nope"]:
        assert_close(j_jr.assemble_local(jeng, raw),
                     t_jr.assemble_local(teng, raw))
    assert t_jr.assemble_local(teng, "4")["hops"][0]["hop"] == "queue"


# -- the timeline -------------------------------------------------------------
def _timeline(sl, ut, fr, tl, monkeypatch):
    clock = Clock()
    for module in (fr, tl):
        monkeypatch.setattr(module, "time", clock)
    steps = sl.StepLedger(clock=clock.monotonic, min_samples=2)
    util = ut.UtilizationLedger(dataclasses.replace(
        (jl.LlamaConfig if sl is j_sl else LlamaConfig).debug()),
        platform="cpu", created_at=clock.monotonic())
    recorder = fr.FlightRecorder()
    executor = types.SimpleNamespace(on_compile=None)
    engine = types.SimpleNamespace(steps=steps, util=util,
                                   recorder=recorder, executor=executor,
                                   _thread=None, _finisher=None)
    exporter = tl.TimelineExporter(engine, process_name="llm-server",
                                   max_steps=8)
    for i in range(6):
        req = _request(i + 1, clock, 5, traced=i % 2 == 0)
        recorder.record_enqueued(req)
        steps.step_start()
        with steps.seg("admission"):
            clock.tick(0.001)
        steps.note_dispatch("prefill")
        start = clock.monotonic()
        with steps.seg("dispatch"):
            clock.tick(0.002)
        req.admitted_at = clock.monotonic()
        recorder.record_admitted(req, slot=0, bucket=8)
        with steps.seg("device_sync"):
            clock.tick(0.01 + (0.3 if i == 4 else 0.0))
        util.record_prefill(5, start, clock.monotonic(), 0.01)
        steps.note_sync("prefill", tokens=1, slowest_request_id=req.id)
        req.first_token_at = clock.monotonic()
        recorder.record_first_token(req)
        steps.step_end(active_slots=1)
        if i % 2 == 0:
            req.generated, req.finished_at = 1, clock.monotonic()
            recorder.record_finished(req, "stop")
        executor.on_compile(f"prog-{i}", 0.001 * i)
        clock.tick(0.003)
    recorder.record_engine_event("cache_grow", new_len=32)
    return exporter.export(steps=4), exporter.export()


def _normalise(payload):
    events = []
    for ev in payload["traceEvents"]:
        ev = json.loads(json.dumps(ev))
        if ev.get("ph") == "M":
            ev["args"].pop("loop_only", None)
            if ev["args"].get("name") in ("xla-compile", "graph-capture"):
                ev["args"]["name"] = "<captures>"
        events.append(ev)
    return dict(payload, traceEvents=events)


def test_timeline_export_matches(monkeypatch):
    want = _timeline(j_sl, j_ut, j_fr, j_tl, monkeypatch)
    got = _timeline(t_sl, t_ut, t_fr, t_tl, monkeypatch)
    for w, g in zip(want, got):
        assert_close(_normalise(w), _normalise(g))
    meta = [ev for ev in got[1]["traceEvents"] if ev.get("ph") == "M"]
    names = {ev["args"]["name"] for ev in meta}
    assert {"llm-engine", "device", "graph-capture", "requests"} <= names
    loop = [ev for ev in meta if ev["args"].get("name") == "llm-engine"][0]
    assert any(n.endswith("StepLedger.step_start")
               for n in loop["args"]["loop_only"])


# -- the host profiler --------------------------------------------------------
def _frame(chain, module="gofr_tpu_torch.tpu.engine"):
    """A synthetic frame stack, leaf last in `chain`."""
    frame = None
    for name in chain:
        code = types.SimpleNamespace(co_name=name.split(".")[-1],
                                     co_qualname=name)
        frame = types.SimpleNamespace(f_code=code, f_back=frame,
                                      f_globals={"__name__": module})
    return frame


STACKS = {
    1: ("llm-engine", ["LLMEngine._loop", "LLMEngine._step",
                       "LLMEngine._sync_oldest"]),
    2: ("llm-engine", ["LLMEngine._loop", "LLMEngine._step",
                       "LLMEngine._admit"]),
    3: ("http-server-8000", ["HTTPServer.serve_forever", "select"]),
    4: ("Thread-7 (process_request_thread)", ["handle", "wire_handler"]),
    5: ("hbm-sampler", ["MemorySampler._loop", "Event.wait"]),
    6: ("MainThread", ["main", "sleep"]),
}


def _profile(module, monkeypatch, rounds):
    prof = module.HostProfiler(hz=50, max_stacks=8, top_k=3)
    names = [types.SimpleNamespace(ident=i, name=n)
             for i, (n, _) in STACKS.items()]
    fake_threading = types.SimpleNamespace(
        get_ident=lambda: 999, enumerate=lambda: names)
    monkeypatch.setattr(module, "threading", fake_threading)
    for r in range(rounds):
        frames = {i: _frame(chain) for i, (_, chain) in STACKS.items()
                  if not (i == 2 and r % 3)}
        monkeypatch.setattr(module, "sys", types.SimpleNamespace(
            _current_frames=lambda frames=frames: frames))
        prof.sample_once()
    return prof


def test_host_profiler_classifies_and_aggregates_as_the_reference(
        monkeypatch):
    want = _profile(j_hp, monkeypatch, 10)
    got = _profile(t_hp, monkeypatch, 10)
    w, g = want.snapshot(), got.snapshot()
    assert_close(w["threads"], g["threads"])
    assert g["samples_total"] == w["samples_total"] == 10
    assert got.collapsed() == want.collapsed()
    assert got.top_loop_stacks() == want.top_loop_stacks()
    assert g["threads"]["loop"]["samples"] == 14
    assert g["threads"]["http"]["samples"] == 20
    assert t_hp.CLASSES == j_hp.CLASSES
    # a loop thread that is not named llm-engine is still the loop: a
    # @loop_only function is on its stack
    assert got._classify("worker", [
        "gofr_tpu_torch.tpu.stepledger.StepLedger.step_start"]) == "loop"


# -- engine against engine ----------------------------------------------------
class _Quiet:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


PROMPTS = [[5, 6, 7], list(range(20, 33)), [1, 2], [9] * 9]


def _serve_prompts(eng, max_new=(7, 5, 9, 6)):
    reqs = [eng.submit(p, max_new_tokens=n, temperature=0.0)
            for p, n in zip(PROMPTS, max_new)]
    eng.start()
    try:
        outs = [r.result(timeout_s=120) for r in reqs]
        deadline = time.monotonic() + 60
        while eng._inflight and time.monotonic() < deadline:
            time.sleep(0.01)   # every sync in a step before stop()
        time.sleep(0.1)
    finally:
        eng.stop()
    return reqs, outs


@pytest.fixture(scope="module")
def engine_pair():
    cfg = jl.LlamaConfig.debug()
    params = jl.llama_init(cfg, seed=0)
    kw = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16),
              page_size=8)
    jeng = JPaged(params, cfg, logger=_Quiet(),
                  flight_recorder=j_fr.FlightRecorder(), **kw)
    teng = TPaged(params_from_numpy(jax.device_get(params), device="cpu"),
                  LlamaConfig.debug(), device="cpu", logger=_Quiet(), **kw)
    teng.recorder = t_fr.FlightRecorder()
    return _serve_prompts(jeng) + (jeng,), _serve_prompts(teng) + (teng,)


def _per_phase(eng):
    summary = eng.steps.snapshot(recent=512)["summary"]
    return {phase: (agg["steps"], agg["tokens"])
            for phase, agg in summary.items()}


def test_engines_agree_on_the_recorder(engine_pair):
    (jreqs, jouts, jeng), (treqs, touts, teng) = engine_pair
    assert touts == jouts
    for jr, tr in zip(jreqs, treqs):
        want, got = jeng.recorder.lookup(jr.id), teng.recorder.lookup(tr.id)
        for key in ("prompt_tokens", "max_new_tokens", "bucket",
                    "generated", "outcome"):
            assert got[key] == want[key], key
        assert ([e["event"] for e in got["events"]]
                == [e["event"] for e in want["events"]])
        assert got["generated"] == len(touts[treqs.index(tr)])


def test_engines_agree_on_the_step_ledger(engine_pair):
    (_, jouts, jeng), (_, touts, teng) = engine_pair
    assert _per_phase(teng) == _per_phase(jeng)
    # one first token per prompt, over the admission waves
    assert _per_phase(teng)["prefill"][1] == len(PROMPTS)
    assert _per_phase(teng)["decode"][0] >= 2
    delivered = sum(len(o) for o in touts)
    for eng in (jeng, teng):
        phases = _per_phase(eng)
        assert sum(tokens for _, tokens in phases.values()) == delivered


def test_engines_agree_on_the_utilization_window(engine_pair):
    (_, _, jeng), (_, _, teng) = engine_pair
    w, g = jeng.util.window_stats(), teng.util.window_stats()
    assert g["tokens"] == w["tokens"]
    assert g["dispatches"] == w["dispatches"]
    ws = {(p, f, b, t) for _, p, f, b, _, _, t in jeng.util._entries}
    gs = {(p, f, b, t) for _, p, f, b, _, _, t in teng.util._entries}
    assert gs == ws          # FLOPs and bytes per dispatch, exactly
    assert teng.util.params_nbytes == jeng.util.params_nbytes


# -- server against server ----------------------------------------------------
ENV = {"MODEL_PRESET": "debug", "HTTP_PORT": "0", "METRICS_PORT": "0",
       "GRPC_PORT": "0",
       "MAX_BATCH": "4", "MAX_SEQ_LEN": "64", "PREFILL_BUCKETS": "8,16",
       "PAGE_SIZE": "8", "WARMUP": "false", "REQUEST_TIMEOUT": "120",
       "LOG_LEVEL": "WARN", "ENGINE_HBM_SAMPLE_S": "0",
       "TRACE_EXPORTER": "memory"}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "example_llm_server_torch_obs",
        ROOT / "examples" / "llm-server" / "main.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    # incident bundles (none is expected) land in a temporary directory
    env = {**ENV, "INCIDENT_DIR": str(tmp_path_factory.mktemp("incidents"))}
    ref = module.build_app(config=MockConfig({**env, "TPU_PLATFORM": "cpu"}))
    params = params_from_numpy(jax.device_get(ref.engine.params),
                               device="cpu")
    port = build_app(env, engine=build_engine(env, device="cpu",
                                              params=params))
    ref.start()
    try:
        port.start()
        try:
            for app in (ref, port):
                status, _ = _call(app, "POST", "/generate",
                                  {"prompt": "hello", "max_tokens": 6,
                                   "stream": False},
                                  {"traceparent": f"00-{TRACE}-"
                                   "00f067aa0ba902b7-01"})
                assert status == 201
            yield ref, port
        finally:
            port.shutdown()
    finally:
        ref.shutdown()


def _call(app, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", app.http_port,
                                      timeout=120)
    conn.request(method, path, body=json.dumps(body) if body else None,
                 headers=headers or {})
    resp = conn.getresponse()
    raw = resp.read().decode()
    conn.close()
    data = json.loads(raw) if raw else None
    return resp.status, (data or {}).get("data", data)


def _keys(obj, depth):
    """The key tree of a payload down to `depth` (lists: their first
    element's)."""
    if depth == 0:
        return None
    if isinstance(obj, dict):
        return {k: _keys(v, depth - 1) for k, v in obj.items()}
    if isinstance(obj, list) and obj:
        return [_keys(obj[0], depth)]
    return None


# (route, depth of the key tree compared, top-level keys only the reference
# has, and why)
ROUTES = {
    "engine": ("/debug/engine", 1, {"hbm"}),
    "steps": ("/debug/steps", 2, set()),
    "requests": ("/debug/requests", 2, set()),
    "journey": ("/debug/journey", 3, set()),
    "trace": ("/debug/trace", 3, set()),
    "timeline": ("/debug/timeline?steps=64", 1, set()),
    "hostprof": ("/debug/hostprof", 2, set()),
    "stats": ("/stats", 2, set()),
    "slo": ("/debug/slo", 2, set()),
    "incidents": ("/debug/incidents", 2, set()),
    "capacity": ("/debug/capacity", 2, set()),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_debug_routes_have_the_reference_keys(servers, route):
    """/debug/engine: "hbm" is the device memory, which the reference's
    CPU client lists with zeros and the port's CPU engine does not have (on
    the card it is there)."""
    path, depth, ref_only = ROUTES[route]
    ref, port = servers
    (ws, want), (gs, got) = (_call(ref, "GET", path),
                             _call(port, "GET", path))
    assert ws == gs == 200
    wk, gk = _keys(want, depth), _keys(got, depth)
    assert set(gk) == set(wk) - ref_only, (set(gk) ^ set(wk))
    for key in set(gk):
        if isinstance(wk[key], dict) and route not in ("timeline",):
            assert set(gk[key]) == set(wk[key]), key


def test_request_and_journey_details_have_the_reference_keys(servers):
    ref, port = servers
    out = []
    for app in (ref, port):
        _, snap = _call(app, "GET", "/debug/requests")
        rid = snap["recent"][0]["id"]
        _, detail = _call(app, "GET", f"/debug/requests/{rid}")
        _, by_id = _call(app, "GET", f"/debug/journey/{rid}")
        _, by_trace = _call(app, "GET", f"/debug/journey/{TRACE}")
        assert _call(app, "GET", "/debug/requests/999999")[0] == 404
        out.append((detail, by_id, by_trace))
    (wd, wj, wt), (gd, gj, gt) = out
    assert set(gd) == set(wd)
    assert [e["event"] for e in gd["events"]] == [e["event"]
                                                 for e in wd["events"]]
    assert [h["hop"] for h in gj["hops"]] == [h["hop"] for h in wj["hops"]]
    assert [h["hop"] for h in gt["hops"]] == [h["hop"] for h in wt["hops"]]
    assert gt["trace_id"] == TRACE


def test_engine_child_spans_match(servers):
    """The recorder's engine.queue / engine.prefill / engine.decode spans
    hang off the request's tpu.generate span, as the reference's do."""
    trees = []
    for app in servers:
        exporter = app.container.tracer.exporter
        for _ in range(300):
            spans = [s for s in exporter.spans if s.trace_id == TRACE]
            if sum(s.name.startswith("engine.") for s in spans) == 3:
                break
            time.sleep(0.01)
        by_id = {s.span_id: s for s in spans}
        trees.append(sorted(
            (s.name, by_id[s.parent_id].name if s.parent_id in by_id
             else "inbound", sorted(s.attributes)) for s in spans))
    assert trees[1] == trees[0]
    assert ("engine.decode", "tpu.generate") in [(n, p)
                                                  for n, p, _ in trees[1]]
