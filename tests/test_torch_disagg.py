"""The disaggregated prefill/decode pair on the port (tpu/disagg.py) against
the reference's.

The twins of tests/test_disagg.py at the debug preset on the CPU, with the
goldens computed live from the JAX colocated PagedLLMEngine on the same
bridged weights (the reference file's hard-coded goldens are stale under
its jax). The envelope is the reference's byte for byte (``sent_at``
pinned in both); the pair's streams equal the colocated JAX engine's with
zero prefills on the decode pool; a corrupt blob, a lost hand-off, the
prefill worker's death and the traceparent behave as in the reference; and
an envelope made by the JAX prefill engine, landed on the port's decode
engine, continues the JAX colocated stream.
"""

import json
import queue
import time
import types

import jax
import numpy as np
import pytest

from gofr_tpu.models.llama import LlamaConfig as JConfig
from gofr_tpu.models.llama import llama_init as jax_init
from gofr_tpu.tpu import disagg as jdisagg
from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.tpu import disagg as tdisagg
from gofr_tpu_torch.tpu.faults import FaultPlane
from gofr_tpu_torch.tpu.disagg import (HANDOFF_VERSION, DisaggRouter,
                                       PubSubTransport, QueueTransport,
                                       decode_handoff, encode_handoff)
from gofr_tpu_torch.tpu.kvtier import PageBlob, decode_blob
from gofr_tpu_torch.tpu.paging import PagedLLMEngine

CFG = LlamaConfig.debug()
ENGINE = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16),
              page_size=8)
PROMPTS = [([5, 6, 7], 8), ([9, 10, 11, 12, 13, 14, 15, 16, 17], 8),
           ([1, 2], 8)]


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
    """The JAX colocated paged engine's greedy streams, computed live."""
    eng = JPaged(weights[0], JConfig.debug(), logger=MockLogger(), **ENGINE)
    eng.start()
    try:
        return [eng.generate(p, max_new_tokens=n, temperature=0.0)
                for p, n in PROMPTS]
    finally:
        eng.stop()


def _engine(weights, role, **kw):
    eng = PagedLLMEngine(weights[1], CFG, device="cpu", disagg_role=role,
                         logger=MockLogger(), **dict(ENGINE, **kw))
    eng.start()
    return eng


def _pair(weights, **router_kw):
    pre = _engine(weights, "prefill")
    dec = _engine(weights, "decode")
    router = DisaggRouter(pre, dec, **router_kw)
    router.start()
    return pre, dec, router


def _teardown(pre, dec, router):
    router.stop()
    if router.worker.alive:
        pre.stop()
    dec.stop()


def _collect(req, timeout_s=120):
    return list(req.stream(timeout_s=timeout_s))


# -- the envelope ---------------------------------------------------------------
def _request():
    return types.SimpleNamespace(
        id=7, prompt_tokens=[3, 1, 4, 1, 5], emitted=[9],
        max_new_tokens=16, temperature=0.0, stop_tokens={2, 0},
        priority=1, min_tokens=0, top_p=0.0, top_k=0,
        qos_class="batch", tenant="acme",
        traceparent="00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
        gen_span=None)


def test_envelope_is_the_references_byte_for_byte(monkeypatch):
    """encode_handoff of the same request and pages in both packages gives
    the same string once sent_at is pinned; each side parses the other's."""
    from gofr_tpu.tpu import kvtier as jkv

    rng = np.random.default_rng(0)
    planes = [rng.normal(size=(2, 2, 4, 8)).astype(np.float32)
              for _ in range(4)]
    ours = [PageBlob([3, 1, 4, 1, 5], planes[0], planes[1]),
            PageBlob([9], planes[2], planes[3])]
    ref = [jkv.PageBlob([3, 1, 4, 1, 5], planes[0], planes[1]),
           jkv.PageBlob([9], planes[2], planes[3])]
    clock = types.SimpleNamespace(monotonic=lambda: 123.25)
    monkeypatch.setattr(tdisagg, "time", clock)
    monkeypatch.setattr(jdisagg, "time", clock)
    for blobs_t, blobs_j in ((ours, ref), (None, None)):
        raw_t = encode_handoff(_request(), blobs_t, n_ctx=6)
        raw_j = jdisagg.encode_handoff(_request(), blobs_j, n_ctx=6)
        assert raw_t == raw_j
        assert decode_handoff(raw_j) == jdisagg.decode_handoff(raw_t)


def test_handoff_envelope_round_trips_the_queue():
    rng = np.random.default_rng(0)
    blobs = [PageBlob(tokens=[3, 1, 4, 1, 5],
                      k=rng.normal(size=(2, 2, 4, 8)).astype(np.float32),
                      v=rng.normal(size=(2, 2, 4, 8)).astype(np.float32))
             for _ in range(2)]
    transport = QueueTransport(maxsize=4)
    assert transport.publish(encode_handoff(_request(), blobs, n_ctx=6))
    body = decode_handoff(transport.poll(timeout_s=1.0))
    assert body is not None and body["v"] == HANDOFF_VERSION
    assert body["rid"] == 7 and body["n_ctx"] == 6
    assert body["spec"]["prompt"] == [3, 1, 4, 1, 5]
    assert body["spec"]["emitted"] == [9] and body["spec"]["stop"] == [0, 2]
    assert body["spec"]["qos"] == "batch" and body["spec"]["tenant"] == "acme"
    for raw, original in zip(body["blobs"], blobs):
        decoded = decode_blob(raw)
        assert decoded.tokens == original.tokens
        np.testing.assert_array_equal(decoded.k, original.k)


def test_decode_handoff_rejects_torn_and_foreign_payloads():
    assert decode_handoff(b"\xff\xfe not json") is None
    assert decode_handoff("[1, 2, 3]") is None
    assert decode_handoff(json.dumps({"v": HANDOFF_VERSION + 1,
                                      "rid": 1, "spec": {}})) is None
    assert decode_handoff(json.dumps({"v": HANDOFF_VERSION,
                                      "spec": {}})) is None


def test_queue_transport_sheds_when_full():
    transport = QueueTransport(maxsize=1)
    assert transport.publish("a")
    assert not transport.publish("b")
    assert transport.depth() == 1


def test_pubsub_transport_over_a_fake_broker():
    """Served under DISAGG_TRANSPORT=pubsub (tests/test_torch_serve_config.py
    holds the served pair): publish
    and a committed poll over a broker-shaped fake; a dead broker is a lost
    hand-off, never a raise."""
    class Msg:
        def __init__(self, value):
            self.value, self.committed = value, False

        def commit(self):
            self.committed = True

    class Broker:
        def __init__(self):
            self.q, self.last = queue.Queue(), None

        def publish(self, topic, value):
            self.q.put((topic, value))

        def subscribe(self, topic, group, timeout_s=None):
            try:
                got_topic, value = self.q.get(timeout=timeout_s)
            except queue.Empty:
                return None
            assert got_topic == topic and group == "decode-pool"
            self.last = Msg(value)
            return self.last

    broker = Broker()
    transport = PubSubTransport(broker)
    assert transport.publish("payload")
    assert transport.poll(0.5) == "payload" and broker.last.committed
    assert transport.poll(0.01) is None and transport.depth() == 0

    class Dead:
        def publish(self, *a):
            raise ConnectionError("down")

        def subscribe(self, *a, **k):
            raise ConnectionError("down")

    dead = PubSubTransport(Dead())
    assert not dead.publish("x") and dead.poll(0.01) is None


# -- the pair on the CPU --------------------------------------------------------
def test_disagg_pair_matches_colocated_goldens_with_zero_decode_prefills(
        weights, goldens):
    pre, dec, router = _pair(weights)
    try:
        reqs = [router.submit(p, max_new_tokens=n, temperature=0.0)
                for p, n in PROMPTS]
        for golden, req in zip(goldens, reqs):
            assert _collect(req) == golden
        assert pre.handoffs_total == len(PROMPTS)
        assert router.coordinator.consumed_total == len(PROMPTS)
        assert (router.fallbacks_total + pre.handoff_fallbacks_total
                + dec.handoff_fallbacks_total) == 0
        stats = router.stats()
        assert stats["handoffs_total"] == len(PROMPTS)
        assert stats["fallbacks_total"] == 0 and stats["worker_alive"]
    finally:
        _teardown(pre, dec, router)
    # the decode pool never prefilled, the prefill pool never decoded
    assert dec.prefill_dispatches == dec.prefix_dispatches == 0
    snap = dec.steps.snapshot(recent=0)
    assert snap["summary"].get("prefill", {}).get("steps", 0) == 0
    assert snap["summary"].get("decode", {}).get("steps", 0) > 0
    assert pre.steps.snapshot(recent=0)["summary"]["prefill"]["steps"] > 0
    assert pre.decode_blocks == 0
    assert dec.util.pool == "decode" and pre.util.pool == "prefill"


class _CorruptTransport(QueueTransport):
    """Delivers every hand-off with bytes flipped in the first page blob:
    the decode side's crc must catch it."""

    def publish(self, payload):
        body = json.loads(payload)
        if body.get("blobs"):
            body["blobs"][0] = body["blobs"][0][:-8] + "AAAAAAAA"
        return super().publish(json.dumps(body))


def test_corrupt_blob_degrades_to_recompute_not_failure(weights, goldens):
    pre, dec, router = _pair(weights, transport=_CorruptTransport(maxsize=8))
    try:
        req = router.submit(PROMPTS[0][0], max_new_tokens=PROMPTS[0][1],
                            temperature=0.0)
        assert _collect(req) == goldens[0]
        assert router.fallbacks_total >= 1
        assert dec.prefill_dispatches + dec.prefix_dispatches == 1
    finally:
        _teardown(pre, dec, router)


class _LossyTransport(QueueTransport):
    """Claims success and drops every payload: the stale reaper must
    rescue the stream."""

    def publish(self, payload):
        return True


def test_lost_handoff_rescued_by_stale_reaper(weights, goldens):
    pre, dec, router = _pair(weights, transport=_LossyTransport(),
                             handoff_timeout_s=0.3)
    try:
        req = router.submit(PROMPTS[1][0], max_new_tokens=PROMPTS[1][1],
                            temperature=0.0)
        assert _collect(req) == goldens[1]
        assert router.fallbacks_total >= 1
        assert router.coordinator.consumed_total == 0
    finally:
        _teardown(pre, dec, router)


def test_prefill_worker_death_never_fails_a_stream(weights, goldens):
    pre, dec, router = _pair(weights)
    try:
        in_flight = [router.submit(p, max_new_tokens=n, temperature=0.0)
                     for p, n in PROMPTS * 2]
        router.worker.kill()
        post_kill = [router.submit(p, max_new_tokens=n, temperature=0.0)
                     for p, n in PROMPTS]
        for golden, req in zip(goldens * 3, in_flight + post_kill):
            assert _collect(req) == golden
            assert req.error is None
        assert router.fallbacks_total >= len(PROMPTS)
    finally:
        _teardown(pre, dec, router)


def test_traceparent_survives_the_hop(weights, goldens):
    sent = "00-" + "1234567890abcdef" * 2 + "-" + "fedcba0987654321" + "-01"
    captured = []

    class _Tap(QueueTransport):
        def publish(self, payload):
            captured.append(payload)
            return super().publish(payload)

    pre, dec, router = _pair(weights, transport=_Tap())
    try:
        req = router.submit(PROMPTS[2][0], max_new_tokens=PROMPTS[2][1],
                            temperature=0.0, traceparent=sent)
        assert _collect(req) == goldens[2]
    finally:
        _teardown(pre, dec, router)
    assert len(captured) == 1
    assert decode_handoff(captured[0])["traceparent"] == sent


def test_a_jax_prefill_envelope_lands_on_the_port(weights, goldens):
    """The JAX prefill engine exports each prompt's pages into an envelope
    (its own encode_handoff); the port's decode engine decodes it with its
    own decode_handoff / decode_blob and lands it: the stream, the JAX
    first token then the port's decode, is the JAX colocated one, with no
    prefill on the port."""
    shipped = []

    def sink(request, blobs, n_ctx):
        shipped.append((request, jdisagg.encode_handoff(request, blobs,
                                                        n_ctx)))
        return True

    jpre = JPaged(weights[0], JConfig.debug(), logger=MockLogger(),
                  disagg_role="prefill", handoff_sink=sink, **ENGINE)
    jpre.start()
    dec = _engine(weights, "decode")
    try:
        jreqs = [jpre.submit(p, max_new_tokens=n, temperature=0.0)
                 for p, n in PROMPTS]
        for golden, jreq in zip(goldens, jreqs):
            first = jreq.out_queue.get(timeout=60)
            deadline = time.monotonic() + 60
            while (not any(r is jreq for r, _ in shipped)
                   and time.monotonic() < deadline):
                time.sleep(0.005)   # the sink runs just after the emit
            body = decode_handoff(next(raw for r, raw in shipped
                                       if r is jreq))
            assert body is not None
            spec = body["spec"]
            blobs = [decode_blob(raw) for raw in body["blobs"]]
            assert all(b is not None for b in blobs)
            req = dec.submit_handoff(
                spec["prompt"], spec["emitted"],
                max_new_tokens=spec["max_new"], temperature=spec["temp"],
                stop_tokens=set(spec["stop"]), blobs=blobs)
            assert [first] + _collect(req) == golden
        assert dec.prefill_dispatches == dec.prefix_dispatches == 0
        assert dec.handoff_fallbacks_total == 0
    finally:
        jpre.stop()
        dec.stop()


def test_handoff_checks_degrade_to_recompute(weights, goldens):
    """Blobs this pool cannot land (a wrong page count, another pool's
    shape, torn content) park the request for a recompute, counted by
    reason; the stream is still the golden one."""
    prompt, n = PROMPTS[1]
    # decode slowed by the fault plane, so the stream is live at the export
    src = _engine(weights, "", decode_block_size=1, faults=FaultPlane(
        [{"site": "engine.decode", "action": "delay", "every": 1,
          "times": 0, "delay_s": 0.05}]))
    try:
        req = src.submit(prompt, max_new_tokens=n, temperature=0.0)
        stream = req.stream(timeout_s=60)
        first = next(stream)
        exported = []
        src.request_migration(lambda r, b, c: exported.append(b) or True)
        while src.migration_pending:
            time.sleep(0.005)
    finally:
        src.stop()
    first = [first] + req.emitted[1:]   # what the export covers
    blobs = exported[0]
    bad = {
        "page_count": blobs[:-1],
        "shape": [PageBlob(b.tokens, b.k[:1], b.v[:1]) for b in blobs],
        "content": [PageBlob([t + 1 for t in b.tokens], b.k, b.v)
                    for b in blobs],
    }
    dec = _engine(weights, "decode")
    try:
        for reason, wrong in bad.items():
            r = dec.submit_handoff(prompt, first, max_new_tokens=n,
                                   temperature=0.0, blobs=wrong)
            assert first + _collect(r) == goldens[1], reason
        assert dec.handoff_fallbacks_total == len(bad)
        assert dec.prefill_dispatches + dec.prefix_dispatches == len(bad)
    finally:
        dec.stop()


def test_roles_need_the_paged_engine(weights):
    from gofr_tpu_torch.tpu.engine import LLMEngine

    with pytest.raises(ValueError, match="paged"):
        LLMEngine(weights[1], CFG, device="cpu", disagg_role="decode",
                  logger=MockLogger(), n_slots=2, max_seq_len=64,
                  prefill_buckets=(8,))
    with pytest.raises(ValueError, match="disagg_role"):
        PagedLLMEngine(weights[1], CFG, device="cpu", disagg_role="both",
                       logger=MockLogger(), **ENGINE)
    pre = PagedLLMEngine(weights[1], CFG, device="cpu",
                         disagg_role="prefill", logger=MockLogger(),
                         **ENGINE)
    with pytest.raises(ValueError, match="prefill role"):
        pre.submit_handoff([1, 2], [3], max_new_tokens=4, blobs=[])


def test_pair_app_journey_joins_both_halves(weights, goldens):
    """DISAGG_MODE=both through serve.build_app: /generate streams the JAX
    colocated tokens through the router; the prefill pool has its own
    recorder, and GET /debug/journey/{trace id} assembles both halves in
    pipeline order (queue, prefill on the prefill pool; kv_handoff, decode
    and the finish on the decode pool); GET /debug/disagg reports the
    hand-off."""
    import urllib.request

    from gofr_tpu_torch import serve

    from _torch_env import INCIDENT_DIR

    env = {"MODEL_PRESET": "debug", "HTTP_PORT": "0", "METRICS_PORT": "0",
           "GRPC_PORT": "0",
           "MAX_BATCH": "4", "MAX_SEQ_LEN": "64", "PREFILL_BUCKETS": "8,16",
           "PAGE_SIZE": "8", "WARMUP": "false", "LOG_LEVEL": "WARN",
           "HOSTPROF": "false", "INCIDENT_DIR": INCIDENT_DIR,
           "DISAGG_MODE": "both", "TRACE_EXPORTER": "memory"}
    app = serve.build_app(env, engine=serve.build_engine(
        env, device="cpu", params=weights[1]))
    app.start()
    trace = "4bf92f3577b34da6a3ce929d0e0e4736"
    try:
        dec = app.engine
        pre = dec.disagg_router.prefill_engine
        assert pre.recorder is not None and pre.recorder is not dec.recorder
        got = app.submitter.submit(
            PROMPTS[0][0], max_new_tokens=PROMPTS[0][1], temperature=0.0,
            traceparent=f"00-{trace}-00f067aa0ba902b7-01").result(
                timeout_s=60)
        assert got == goldens[0]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{app.http_port}/debug/journey/"
                    f"{trace}", timeout=30) as resp:
                body = json.loads(resp.read())["data"]
            hops = [h["hop"] for h in body["hops"]]
            if "finish" in hops:
                break
            time.sleep(0.05)
        assert hops == ["queue", "prefill", "kv_handoff", "decode",
                        "finish"]
        actors = {h["hop"]: h["actor"] for h in body["hops"]}
        assert "prefill" in actors["prefill"] and \
            "decode" in actors["decode"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{app.http_port}/debug/disagg",
                timeout=30) as resp:
            stats = json.loads(resp.read())["data"]
        assert stats["handoffs_total"] == 1 and stats["fallbacks_total"] == 0
        assert stats["decode"]["engine"]["active_slots"] == 0
    finally:
        app.shutdown()
