"""The QoS serving plane on the port (tpu/qos.py): class banding, quotas,
deadlines, the shed ladder and preemption of batch rows through the replay
contract, on both servers.

The twins of tests/test_qos.py at the debug preset on the CPU;
``test_batch_lane_round_trip`` drives the batch lane (tpu/qos.BatchLane)
over the port's in-process broker into the paged engine, and holds each
job's greedy result to the JAX engine's stream. The controller's tests run one event sequence on a fake clock
through the JAX QoSController and the port's and require equal answers and
equal ``snapshot()``s after every event. The engine tests hold the port's
paged and dense engines, driven by hand (``_step``), to the JAX engines'
greedy streams computed live on the same weights: class-ordered admission
under contention, a batch stream through a forced preemption (queued again
while the blocks that decoded its old row are still in flight), and a
device reset while the preempted request waits in the queue, the
interactive request the freed slot admitted replaying. The unknown-class test covers both
engines with no controller, and both servers, by body and by header.
"""

import json
import types
import urllib.error
import urllib.request

import jax
import pytest

from gofr_tpu.models.llama import LlamaConfig as JConfig
from gofr_tpu.models.llama import llama_init as jax_init
from gofr_tpu.tpu import qos as jqos
from gofr_tpu.tpu.engine import LLMEngine as JEngine
from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
from gofr_tpu_torch.http.errors import InvalidParam
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.tpu import qos as tqos
from gofr_tpu_torch.tpu.engine import LLMEngine
from gofr_tpu_torch.tpu.faults import FaultPlane
from gofr_tpu_torch.tpu.flightrecorder import FlightRecorder
from gofr_tpu_torch.tpu.paging import PagedLLMEngine
from gofr_tpu_torch.tpu.qos import (CLASS_BAND, LEVEL_LABELS, QoSShedError,
                                    UnknownClassError, banded_priority,
                                    normalize_class)

from _torch_env import INCIDENT_DIR

CFG = LlamaConfig.debug()
ENGINE = dict(n_slots=2, max_seq_len=128, prefill_buckets=(8, 16, 32, 64),
              decode_block_size=4)
PAGED = dict(page_size=8, prefix_cache=True)
# a 9-token prompt: one full 8-token page, so a paged resume is a prefix hit
BATCH_PROMPT, BATCH_TOKENS = [5, 6, 7, 8, 9, 10, 11, 12, 13], 40
SHORT = ([4, 5, 6], 6)


class MockLogger:
    def debugf(self, *a, **k):
        pass

    infof = warnf = errorf = debugf


@pytest.fixture(scope="module")
def weights():
    jparams = jax_init(JConfig.debug(), seed=0)
    return jparams, params_from_numpy(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def goldens(weights):
    """{paged: {(prompt, n): the JAX engine's greedy stream}}, each request
    served alone."""
    out = {}
    wanted = [(BATCH_PROMPT, BATCH_TOKENS), SHORT, ([1, 2, 3], 24),
              ([4, 5, 6], 2)]
    for paged in (False, True):
        cls = JPaged if paged else JEngine
        kw = dict(ENGINE, **(dict(page_size=8) if paged else {}))
        eng = cls(weights[0], JConfig.debug(), logger=MockLogger(), **kw)
        eng.start()
        try:
            out[paged] = {(tuple(p), n): eng.generate(p, max_new_tokens=n,
                                                      temperature=0.0)
                          for p, n in wanted}
        finally:
            eng.stop()
    return out


def _engine(weights, paged, **kw):
    cls = PagedLLMEngine if paged else LLMEngine
    return cls(weights[1], CFG, device="cpu", logger=MockLogger(),
               **dict(ENGINE, **(PAGED if paged else {}), **kw))


def _controller(module, **kw):
    kw.setdefault("burn_probe", lambda: {})
    return module.QoSController(**kw)


def _until(eng, cond, limit=2000):
    """Step the engine's loop by hand until cond() holds; a step that
    raises resets the device state, as the loop's catch does."""
    for _ in range(limit):
        if cond():
            return
        try:
            eng._step()
        except Exception as exc:  # noqa: BLE001 - the loop's catch
            eng.steps.step_abort()
            eng._reset_device_state(exc)
    assert cond(), "the engine did not get there"


# -- units: class normalization + banding -------------------------------------
def test_normalize_and_banded_priority():
    for value in (None, "", "  Batch ", "interactive", "STANDARD", " "):
        assert normalize_class(value) == jqos.normalize_class(value)
    for bad in ("premium", 7, "gold-tier"):
        with pytest.raises(InvalidParam) as err:
            normalize_class(bad)
        assert isinstance(err.value, ValueError)
        assert err.value.status_code == 400
        with pytest.raises(Exception) as ref:
            jqos.normalize_class(bad)
        assert str(err.value) == str(ref.value)
    for cls in (None, "interactive", "standard", "batch"):
        for prio in (-5, -1, 0, 3, 9, 99):
            assert banded_priority(cls, prio) == jqos.banded_priority(cls,
                                                                      prio)
    assert CLASS_BAND == jqos.CLASS_BAND
    assert LEVEL_LABELS == jqos.LEVEL_LABELS
    assert (tqos.SCALEOUT_LEVEL, tqos.SHED_LEVEL, tqos.GOODPUT_WINDOW_S) \
        == (jqos.SCALEOUT_LEVEL, jqos.SHED_LEVEL, jqos.GOODPUT_WINDOW_S)
    assert banded_priority("interactive", 9) < banded_priority("standard", 0)
    assert banded_priority("standard", 9) < banded_priority("batch", 0)


def _post(port, path, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="POST",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read().decode()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.read().decode()


SERVE_ENV = {"HTTP_PORT": "0", "METRICS_PORT": "0", "MODEL_PRESET": "debug",
             "GRPC_PORT": "0",
             "WARMUP": "false", "MAX_BATCH": "2", "MAX_SEQ_LEN": "64",
             "PREFILL_BUCKETS": "8,16", "PAGE_SIZE": "8", "LOG_LEVEL": "WARN",
             "ENGINE_HBM_SAMPLE_S": "0", "HOSTPROF": "false",
             "REQUEST_TIMEOUT": "120", "INCIDENT_DIR": INCIDENT_DIR}


def _servers(weights, extra=None):
    from gofr_tpu_torch.serve import build_app, build_engine
    from gofr_tpu_torch.serve_openai import build_app as build_openai

    env = {**SERVE_ENV, **(extra or {})}
    return [build(env, engine=build_engine(env, device="cpu",
                                           params=weights[1]))
            for build in (build_app, build_openai)]


def test_unknown_class_rejected_at_every_door(weights):
    """Both engines' submit refuse an unknown class with the typed 400 (a
    ValueError too) with no controller attached, and serve a known class
    unbanded; both servers answer 400 to it in the header and, on
    /generate, in the body."""
    for paged in (False, True):
        eng = _engine(weights, paged)
        with pytest.raises(UnknownClassError):
            eng.submit([1, 2, 3], max_new_tokens=2, qos_class="turbo")
        req = eng.submit([1, 2, 3], max_new_tokens=2, qos_class="batch",
                         priority=3)
        assert req.qos_class == "batch" and req.priority == 3
        _until(eng, lambda: req.finished_at is not None)
        assert len(req.result()) == 2
    gen, openai = _servers(weights)
    for app in (gen, openai):
        app.start()
    try:
        body = {"prompt": "hello", "max_tokens": 2, "stream": False}
        for extra, headers in (({"class": "platinum"}, {}),
                               ({}, {"X-QoS-Class": "platinum"})):
            status, _, text = _post(gen.http_port, "/generate",
                                    {**body, **extra}, headers)
            assert status == 400, text
            assert "class must be one of" in text
        status, _, text = _post(
            openai.http_port, "/v1/completions",
            {"prompt": "hello", "max_tokens": 2},
            {"X-QoS-Class": "platinum"})
        assert status == 400 and "class must be one of" in text
        for app in (gen, openai):
            assert app.engine.qos is None
    finally:
        for app in (gen, openai):
            app.shutdown()


# -- units: quotas + deadlines against a stub engine --------------------------
def _stub_engine(n_slots=4, active=0):
    slots = [types.SimpleNamespace(active=i < active, chunking=None,
                                   request=None, pages=None)
             for i in range(n_slots)]
    return types.SimpleNamespace(slots=slots)


def _stub_request(cls, enqueued_at=0.0, emitted=(), priority=0):
    return types.SimpleNamespace(qos_class=cls, tenant="t",
                                 enqueued_at=enqueued_at,
                                 emitted=list(emitted), priority=priority)


def _twin(events, **kw):
    """Run `events` (ctl, now -> answer) on a fake clock through the JAX
    controller and the port's: each answer and the snapshot after each
    event, per module."""
    out = []
    for module in (jqos, tqos):
        now = [100.0]
        ctl = _controller(module, clock=lambda: now[0], **kw)
        seen = []
        for event in events:
            try:
                answer = event(ctl, now)
            except Exception as exc:  # noqa: BLE001 - compared by name
                answer = (type(exc).__name__, getattr(exc, "status_code",
                                                      None),
                          getattr(exc, "retry_after_s", None))
            seen.append((answer, ctl.snapshot()))
        out.append(seen)
    return out


def test_reserved_slot_quota_and_deadlines():
    eng = _stub_engine(n_slots=3, active=1)   # 2 free slots

    def decide(cls, enqueued_at=99.0, taken=0, emitted=()):
        return lambda ctl, now: ctl.admission_decision(
            _stub_request(cls, enqueued_at, emitted), eng, taken=taken)

    events = [decide("standard"), decide("batch", taken=1),
              decide("interactive", taken=1), decide(None, taken=1),
              decide("standard", enqueued_at=90.0),
              decide("standard", enqueued_at=90.0, emitted=[7])]
    want, got = _twin(events, interactive_reserved_slots=1,
                      deadlines={"standard": 5.0})
    assert got == want
    assert [a for a, _ in got] == ["admit", "park", "admit", "admit",
                                   "expire", "admit"]


def test_batch_parks_at_level_one():
    eng = _stub_engine(n_slots=2)

    def decide(cls):
        return lambda ctl, now: ctl.admission_decision(_stub_request(cls),
                                                       eng)

    events = [decide("batch"), lambda ctl, now: ctl.force_level(1),
              decide("batch"), decide("interactive"), decide("standard")]
    want, got = _twin(events, interactive_reserved_slots=0)
    assert got == want
    assert [a for a, _ in got] == ["admit", None, "park", "admit", "admit"]


# -- units: the shed ladder with an injected clock ----------------------------
def test_ladder_walk_and_auto_recovery():
    states = {}

    def set_state(value):
        def event(ctl, now):
            states.clear()
            states["ttft"] = value
        return event

    def advance(dt):
        def event(ctl, now):
            now[0] += dt
        return event

    def evaluate(ctl, now):
        return ctl.evaluate()

    def door(cls):
        return lambda ctl, now: ctl.check_submit(cls)

    def scaleout(ctl, now):
        return ctl.scaleout_wanted

    events = [set_state("ok"), evaluate, set_state("warn"), evaluate,
              set_state("page"), evaluate, advance(5.0), evaluate,
              advance(5.0), evaluate, scaleout, door("standard"),
              advance(5.0), evaluate, advance(5.0), evaluate,
              door("standard"), door(None), door("interactive"),
              door("batch"), set_state("ok"), evaluate, advance(10.0),
              evaluate, scaleout, advance(10.0), evaluate, scaleout,
              advance(10.0), evaluate, advance(10.0), evaluate,
              door("standard")]
    want, got = _twin(events, escalate_hold_s=5.0, recover_hold_s=10.0,
                      shed_tracks=("ttft", "tpot"), retry_after_s=3.5,
                      burn_probe=lambda: states)
    assert got == want
    levels = [a for e, (a, _) in zip(events, got) if e is evaluate]
    assert levels == [0, 1, 1, 2, 3, 4, 4, 4, 3, 2, 1, 0]
    shed = ("QoSShedError", 503, 3.5)
    doors = [a for e, (a, _) in zip(events, got)
             if getattr(e, "__name__", "") == "<lambda>"]
    assert doors == [None, shed, shed, None, None, None]
    trail = [t["to"] for t in got[-1][1]["ladder"]["transitions"]]
    assert trail == ["park_batch", "preempt_batch", "request_replica",
                     "shed_standard", "request_replica", "preempt_batch",
                     "park_batch", "ok"]
    snap = got[-1][1]
    assert snap["classes"]["standard"]["shed"] == 2
    with pytest.raises(QoSShedError):
        ctl = _controller(tqos)
        ctl.force_level(4)
        ctl.check_submit(None)


# -- engine integration: class-ordered admission ------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_class_ordered_admission_under_contention(weights, goldens, paged):
    """One slot, busy: later-submitted interactive work admits before the
    earlier standard and batch work, each stream the JAX engine's."""
    eng = _engine(weights, paged, n_slots=1)
    ctl = _controller(tqos, interactive_reserved_slots=0)
    eng.qos, ctl.engine = ctl, eng
    prompt, n = [1, 2, 3], 24
    blocker = eng.submit(prompt, max_new_tokens=n)
    _until(eng, lambda: blocker.admitted_at is not None)
    batch = eng.submit(SHORT[0], max_new_tokens=SHORT[1], qos_class="batch")
    standard = eng.submit(SHORT[0], max_new_tokens=SHORT[1],
                          qos_class="standard")
    inter = eng.submit(SHORT[0], max_new_tokens=SHORT[1],
                       qos_class="interactive")
    reqs = (blocker, inter, standard, batch)
    _until(eng, lambda: all(r.finished_at is not None for r in reqs))
    assert inter.admitted_at < standard.admitted_at < batch.admitted_at
    gold = goldens[paged]
    assert blocker.result() == gold[(tuple(prompt), n)]
    for r in (inter, standard, batch):
        assert r.result() == gold[(tuple(SHORT[0]), SHORT[1])]
    classes = ctl.snapshot()["classes"]
    # the unclassified blocker counts as standard
    assert [classes[c]["admitted"] for c in tqos.CLASSES] == [1, 2, 1]
    assert classes["standard"]["submitted"] == 2


# -- engine integration: preemption with replay -------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_preempted_batch_matches_golden_tokens(weights, goldens, paged):
    """Level 2 preempts a running batch decode mid-stream while blocks are
    in flight, and the ladder drops to 0 at once: the request is queued
    again, for the same slot, while the blocks that decoded its old row
    are still in flight, and admits only once they synced. Its stream
    equals the JAX engine's greedy stream (unpreempted) token for token;
    the preemption counts apart from the replays; the paged resume is a
    tail-only prefix hit and every page comes back."""
    eng = _engine(weights, paged, n_slots=1)
    eng.recorder = FlightRecorder()
    ctl = _controller(tqos, interactive_reserved_slots=0,
                      recorder=eng.recorder)
    eng.qos, ctl.engine = ctl, eng
    req = eng.submit(BATCH_PROMPT, max_new_tokens=BATCH_TOKENS,
                     qos_class="batch", tenant="acme")
    _until(eng, lambda: len(req.emitted) >= 10 and len(eng._inflight) >= 2)
    ctl.force_level(2)
    eng._step()
    assert req.preemptions == 1 and eng.preemptions_total == 1
    ctl.force_level(0)
    assert eng._in_flight(req)                 # its old row still decodes
    while eng._in_flight(req):
        eng._step()
        assert req.admitted_at is None or not eng._in_flight(req)
    _until(eng, lambda: req.finished_at is not None)
    assert req.result() == goldens[paged][(tuple(BATCH_PROMPT),
                                           BATCH_TOKENS)]
    assert req.replays == 0 and eng.replays_total == 0
    if paged:
        assert eng.prefix_dispatches >= 1       # the resume hit its page
        eng.allocator.release(eng.prefix.drop_all_idle())
        assert eng.allocator.used_pages == 0
    snap = ctl.snapshot()
    assert snap["preemptions_total"] == 1
    assert snap["classes"]["batch"]["preempted"] == 1
    assert snap["classes"]["batch"]["admitted"] == 2
    assert snap["classes"]["batch"]["finished"] == 1
    assert snap["tenants"]["batch"] == {"acme": 1}
    names = [e["event"] for e in eng.recorder.lookup(req.id)["events"]]
    assert "preempted" in names and "replayed" not in names
    engine_events = [e["event"]
                     for e in eng.recorder.snapshot()["engine_events"]]
    assert "qos_preempt" in engine_events
    assert "qos_shed_level" in engine_events


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_reset_while_preempted_request_waits(weights, goldens, paged):
    """A device reset while a preempted request waits in the queue: the
    request is no reset survivor (no replay), no page goes back twice,
    and its stream still equals the JAX engine's; the running interactive
    request replays."""
    eng = _engine(weights, paged, n_slots=1)
    ctl = _controller(tqos, interactive_reserved_slots=0)
    eng.qos, ctl.engine = ctl, eng
    req = eng.submit(BATCH_PROMPT, max_new_tokens=BATCH_TOKENS,
                     qos_class="batch")
    _until(eng, lambda: len(req.emitted) >= 8)
    ctl.force_level(2)
    prompt, n = [1, 2, 3], 24
    inter = eng.submit(prompt, max_new_tokens=n, qos_class="interactive")
    _until(eng, lambda: len(inter.emitted) >= 4)
    assert req.preemptions == 1 and req.admitted_at is None
    eng.faults = FaultPlane(plan=[{"site": "engine.decode", "nth": 1}])
    _until(eng, lambda: eng.resets_total == 1)
    eng.faults = None
    ctl.force_level(0)
    _until(eng, lambda: req.finished_at is not None
           and inter.finished_at is not None)
    gold = goldens[paged]
    assert req.result() == gold[(tuple(BATCH_PROMPT), BATCH_TOKENS)]
    assert inter.result() == gold[(tuple(prompt), n)]
    assert req.replays == 0 and inter.replays == 1
    if paged:
        eng.allocator.release(eng.prefix.drop_all_idle())
        assert eng.allocator.used_pages == 0
        assert len(set(eng.allocator._free)) == eng.allocator.n_pages - 1


def test_preemption_skips_what_cannot_resume(weights):
    """The reference's skips: a cancelled request, an exhausted budget and
    an unclassified or non-batch class stay in their slots."""
    eng = _engine(weights, False, n_slots=2)
    ctl = _controller(tqos, interactive_reserved_slots=0)
    eng.qos, ctl.engine = ctl, eng
    std = eng.submit([1, 2, 3], max_new_tokens=30, qos_class="standard")
    cancelled = eng.submit([4, 5, 6], max_new_tokens=30, qos_class="batch")
    _until(eng, lambda: std.emitted and cancelled.emitted)
    cancelled.cancel()
    assert eng._preempt_slots(("batch",)) == 0
    assert eng._preempt_slots(("interactive",)) == 0
    _until(eng, lambda: std.finished_at is not None
           and cancelled.finished_at is not None)
    assert eng.preemptions_total == 0


def test_row_controls_forgotten_at_preemption(weights):
    """A preempted row with top_k leaves _filter_rows and its control row
    is zeroed (the blocks after it may run -sc-nosort); its resume sets
    them again."""
    eng = _engine(weights, True, n_slots=2, sampling_controls=True)
    ctl = _controller(tqos, interactive_reserved_slots=0)
    eng.qos, ctl.engine = ctl, eng
    req = eng.submit(BATCH_PROMPT, max_new_tokens=30, temperature=0.7,
                     top_k=5, qos_class="batch")
    _until(eng, lambda: len(req.emitted) >= 4)
    idx = next(i for i, s in enumerate(eng.slots) if s.request is req)
    assert idx in eng._filter_rows and float(eng._temps[idx, 2]) == 5.0
    ctl.force_level(2)
    eng._step()
    assert idx not in eng._filter_rows
    assert eng._temps[idx].abs().sum().item() == 0.0
    ctl.force_level(0)
    _until(eng, lambda: any(s.request is req for s in eng.slots))
    assert eng._filter_rows
    _until(eng, lambda: req.finished_at is not None)
    assert len(req.result()) == 30


# -- e2e: /debug/qos through both servers -------------------------------------
def test_debug_qos_endpoint_e2e(weights):
    """QOS=true on both servers: a classified request lands in the class
    ledgers and tenant table, /debug/qos serves the ladder and the
    classes, the app_tpu_qos_* series and /stats' fleet.qos are served, an
    unknown class is a 400; at shed_standard a standard request gets 503
    with Retry-After and an interactive one its answer; a queued standard
    request past its deadline gets 503."""
    apps = _servers(weights, {"QOS": "true", "QOS_SHED_RETRY_AFTER_S": "3",
                              "QOS_DEADLINE_STANDARD_S": "0.2"})
    for app in apps:
        app.start()
    try:
        for app, path, body in (
                (apps[0], "/generate", {"prompt": "hello", "max_tokens": 4,
                                        "stream": False}),
                (apps[1], "/v1/completions", {"prompt": "hello",
                                              "max_tokens": 4})):
            ctl = app.engine.qos
            assert ctl is not None and ctl._burn is app.slo_burn
            status, _, text = _post(app.http_port, path, body,
                                    {"X-QoS-Class": "interactive",
                                     "X-Tenant": "acme"})
            assert status == 201, text
            status, _, _ = _post(app.http_port, path, body,
                                 {"X-QoS-Class": "platinum"})
            assert status == 400
            snap = json.loads(_get(app.http_port, "/debug/qos"))["data"]
            assert snap["ladder"]["state"] == "ok"
            assert snap["classes"]["interactive"]["submitted"] == 1
            assert snap["classes"]["interactive"]["finished"] == 1
            assert snap["tenants"]["interactive"] == {"acme": 1}
            assert "lane" not in snap
            stats = json.loads(_get(app.http_port, "/stats"))["data"]
            assert stats["fleet"]["qos"] == {"scaleout_wanted": False}
            metrics = _get(app.metrics_port, "/metrics")
            assert "app_tpu_qos_shed_level" in metrics
            assert 'app_tpu_qos_submitted_total{class="interactive"}' \
                in metrics
            # the ladder pinned at shed_standard (a stub probe keeps it)
            ctl._burn_probe = lambda: {"ttft": "page"}
            ctl.escalate_hold_s = ctl.recover_hold_s = 3600.0
            ctl.force_level(4)
            status, headers, text = _post(app.http_port, path, body,
                                          {"X-QoS-Class": "standard"})
            assert status == 503, text
            assert headers["Retry-After"] == "3"
            status, _, _ = _post(app.http_port, path, body,
                                 {"X-QoS-Class": "interactive"})
            assert status == 201
            stats = json.loads(_get(app.http_port, "/stats"))["data"]
            assert stats["fleet"]["qos"] == {"scaleout_wanted": True}
            metrics = _get(app.metrics_port, "/metrics")
            assert 'app_tpu_qos_shed_total{class="standard"} 1' in metrics
            ctl.force_level(0)
        # a standard request queued past its 0.2 s deadline: 503
        eng = apps[0].engine
        gate = eng._admit
        eng._admit = lambda: None
        try:
            out = {}

            def ask():
                out["r"] = _post(apps[0].http_port, "/generate",
                                 {"prompt": "late", "max_tokens": 2,
                                  "stream": False},
                                 {"X-QoS-Class": "standard"})

            import threading
            import time

            th = threading.Thread(target=ask)
            th.start()
            time.sleep(0.5)
        finally:
            eng._admit = gate
        th.join(timeout=60)
        status, headers, text = out["r"]
        assert status == 503 and "expired in queue" in text
        assert "Retry-After" in headers
        snap = json.loads(_get(apps[0].http_port, "/debug/qos"))["data"]
        assert snap["classes"]["standard"]["expired"] == 1
    finally:
        for app in apps:
            app.shutdown()
    for app in apps:
        assert app.engine.qos._eval_thread is None


# -- the batch lane --------------------------------------------------------------
class _LoggedBroker:
    """The in-process broker, logging each lane result as it is published
    and each job as it commits."""

    def __init__(self):
        from gofr_tpu_torch.pubsub.inproc import InProcBroker

        self.inner = InProcBroker()
        self.log = []

    def publish(self, topic, message, key=""):
        if topic == "qos.batch.results":
            self.log.append(("result", json.loads(message)["job_id"]))
        self.inner.publish(topic, message, key)

    def subscribe(self, topic, group="default", timeout_s=None):
        msg = self.inner.subscribe(topic, group, timeout_s=timeout_s)
        if msg is not None and topic == "qos.batch.jobs":
            try:
                job_id = json.loads(msg.value).get("job_id")
            except ValueError:
                job_id = None
            commit = msg.commit

            def logged():
                self.log.append(("commit", job_id))
                commit()
            msg.commit = logged
        return msg


class _IdsTokenizer:
    """Decodes a result to its token ids, so a lane result carries them."""

    def decode(self, ids):
        return json.dumps(list(ids))


def test_batch_lane_round_trip(weights):
    """Three jobs and a poison message through the lane into the paged
    engine: each result publishes before its commit with the JAX engine's
    greedy stream, the poison one is rejected and committed away, nothing
    redelivers, and the cron kick reports the count."""
    prompts = [[1 + i, 2, 3] for i in range(3)]
    jeng = JPaged(weights[0], JConfig.debug(), logger=MockLogger(),
                  **dict(ENGINE, page_size=8))
    jeng.start()
    try:
        want = [jeng.generate(p, max_new_tokens=4, temperature=0.0)
                for p in prompts]
    finally:
        jeng.stop()
    eng = _engine(weights, paged=True)
    broker = _LoggedBroker()
    lane = tqos.BatchLane(eng, broker, max_inflight=2, poll_s=0.05,
                          logger=MockLogger(), tokenizer=_IdsTokenizer())
    eng.start()
    lane.start()
    try:
        for i, prompt in enumerate(prompts):
            broker.publish("qos.batch.jobs", json.dumps(
                {"tokens": prompt, "max_tokens": 4, "tenant": "acme",
                 "job_id": i}).encode())
        broker.publish("qos.batch.jobs", b"not json at all")  # poison
        results = {}
        deadline = __import__("time").time() + 120
        while len(results) < 4 and __import__("time").time() < deadline:
            msg = broker.subscribe("qos.batch.results", "test",
                                   timeout_s=1.0)
            if msg is None:
                continue
            payload = json.loads(msg.value.decode())
            results[payload.get("job_id")] = payload
            msg.commit()
        assert len(results) == 4, f"lane stalled: {lane.stats()}"
        for i in range(3):
            assert results[i]["ok"] is True and results[i]["tokens"] == 4
            assert results[i]["tenant"] == "acme"
            assert json.loads(results[i]["text"]) == want[i]
        assert results[None]["ok"] is False        # the poison job
        assert "bad job payload" in results[None]["error"]
        # each job's result is out before it commits, and the jobs commit
        # in arrival order (the poison one commits when it is rejected)
        jobs = [e for e in broker.log if e[1] is not None]
        assert jobs == [(kind, i) for i in range(3)
                        for kind in ("result", "commit")]
        assert broker.log.count(("commit", None)) == 1
        assert broker.subscribe("qos.batch.jobs", lane.group,
                                timeout_s=0.1) is None
        stats = lane.stats()
        assert stats["completed"] == 3 and stats["rejected"] == 1
        assert stats["submitted"] == 3 and stats["failed"] == 0
        assert lane.cron_drain()["completed"] == 3 and lane.depth() == 0
    finally:
        lane.stop()
        eng.stop()
