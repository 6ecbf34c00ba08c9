"""Port paged engine vs the JAX PagedLLMEngine, and the port's HTTP surface.

Goldens are computed live (never hard-coded): a JAX PagedLLMEngine serves
greedy streams on `llama_init(debug, seed=0)`, and the port's engine must
serve the same tokens on the same weights carried across by the weight
bridge. Engine shape: 4 slots, max_seq_len 64, buckets (8, 16), page size 8.
"""

import collections
import http.client
import json

import jax
import pytest

from gofr_tpu.models.llama import LlamaConfig as JConfig
from gofr_tpu.models.llama import llama_init as jax_init
from gofr_tpu.tpu.paging import PageAllocator as JAllocator
from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.models.tokenizer import DebugTokenizer
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.serve import NOT_PORTED, build_app, build_engine
from gofr_tpu_torch.tpu.paging import PageAllocator, PagedLLMEngine

CFG = LlamaConfig.debug()
ENGINE = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16), page_size=8)
HELLO = DebugTokenizer(CFG.vocab_size).encode("hello")
# (prompt, max_new): short and long prompts, page-boundary crossings
REQUESTS = [([5, 6, 7], 8), ([9, 10, 11, 12, 13, 14, 15, 16, 17], 8),
            ([1, 2], 8), (list(range(40, 54)), 20), (HELLO, 12)]


class _QuietLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


@pytest.fixture(scope="module")
def served():
    """(JAX goldens per request, the same weights as port tensors)."""
    jparams = jax_init(JConfig.debug(), seed=0)
    eng = JPaged(jparams, JConfig.debug(), logger=_QuietLogger(), **ENGINE)
    eng.start()
    try:
        goldens = [eng.generate(p, max_new_tokens=n, temperature=0.0)
                   for p, n in REQUESTS]
    finally:
        eng.stop()
    return goldens, params_from_numpy(jax.device_get(jparams), device="cpu")


@pytest.fixture()
def engine(served):
    eng = PagedLLMEngine(served[1], CFG, device="cpu", **ENGINE)
    eng.start()
    yield eng
    eng.stop()


def test_page_allocator_ledger_matches_jax():
    ops = [("alloc", 3), ("alloc", 4), ("release", [2, 3]), ("alloc", 5),
           ("alloc", 1), ("release", [1]), ("alloc", 2)]
    jal, tal = JAllocator(9, 8), PageAllocator(9, 8)
    assert tal.free_pages == 8 and tal.used_pages == 0
    for op, arg in ops:
        if op == "alloc":
            assert tal.alloc(arg) == jal.alloc(arg)
        else:
            tal.release(arg)
            jal.release(arg)
        assert (tal.free_pages, tal.used_pages) == (jal.free_pages,
                                                    jal.used_pages)
    assert tal.pages_for(17) == jal.pages_for(17) == 3
    with pytest.raises(ValueError):
        PageAllocator(1, 8)


def test_garbage_page_is_never_handed_out():
    alloc = PageAllocator(5, 8)
    assert sorted(alloc.alloc(4)) == [1, 2, 3, 4]
    assert alloc.alloc(1) is None


def test_greedy_streams_match_jax_engine(served, engine):
    goldens, _ = served
    got = [engine.generate(p, max_new_tokens=n, temperature=0.0)
           for p, n in REQUESTS]
    assert got == goldens
    # one request at a time: one [1, bucket] prefill window each
    assert engine.prefill_shapes == collections.Counter(
        (1, 8 if len(p) <= 8 else 16) for p, _ in REQUESTS)


def test_concurrent_mixed_lengths_match_jax_engine(served, engine):
    """All requests in flight at once (fused admission, lock-step decode,
    rows finishing mid-block): same tokens, every page back in the pool."""
    goldens, _ = served
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in REQUESTS]
    assert [r.result(timeout_s=60) for r in reqs] == goldens
    assert engine.allocator.used_pages == 0
    assert engine.prefill_dispatches >= 2 and engine.decode_steps >= 16


def test_stop_tokens_and_min_tokens(served, engine):
    goldens, _ = served
    prompt, n = REQUESTS[3]
    gold = goldens[3]
    stop = gold[2]
    first = gold.index(stop)
    got = engine.generate(prompt, max_new_tokens=n, stop_tokens={stop})
    assert got == gold[:first + 1]          # the stop token is emitted
    later = [i for i, t in enumerate(gold) if t == stop and i > first]
    want = gold[:later[0] + 1] if later else gold
    got = engine.generate(prompt, max_new_tokens=n, stop_tokens={stop},
                          min_tokens=first + 2)
    assert got == want


def test_demux_plan_matches_jax_engine():
    """Emit counts and finish flags equal the JAX engine's _demux_plan on
    random blocks: stop sets (shared and distinct), min_tokens gating,
    budgets, context caps, cancels, per-row limits below the block."""
    import threading
    import types

    import numpy as np

    from gofr_tpu.tpu.engine import LLMEngine as JEngine
    from gofr_tpu_torch.tpu.engine import LLMEngine as TEngine

    rng = np.random.default_rng(0)
    for _ in range(200):
        B, W = 6, int(rng.integers(1, 9))
        tokens = rng.integers(0, 6, (B, W))
        rows = sorted(rng.choice(B, size=int(rng.integers(1, B + 1)),
                                 replace=False).tolist())
        slots, reqs = [], []
        for _ in range(B):
            slots.append(types.SimpleNamespace(
                remaining=int(rng.integers(0, 10)),
                length=int(rng.integers(40, 64))))
        for _ in rows:
            cancelled = threading.Event()
            if rng.random() < 0.15:
                cancelled.set()
            reqs.append(types.SimpleNamespace(
                generated=int(rng.integers(0, 5)),
                min_tokens=int(rng.integers(0, 6)),
                stop_tokens=set(rng.choice(6, size=int(rng.integers(0, 3)),
                                           replace=False).tolist()),
                cancelled=cancelled))
        limits = [int(rng.integers(1, W + 1)) for _ in rows]
        host = types.SimpleNamespace(
            slots=slots, max_seq_len=64, _plane=None,
            _is_cancelled=lambda r: r.cancelled.is_set())
        want = JEngine._demux_plan(host, tokens, rows, reqs, limits)
        got = TEngine._demux_plan(host, tokens, rows, reqs, limits)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_cancel_frees_the_slot_and_pages(engine):
    req = engine.submit([3, 4, 5], max_new_tokens=60)
    req.cancel()
    req.result(timeout_s=30)
    assert engine.allocator.used_pages == 0
    assert not any(s.active for s in engine.slots)


def test_submit_rejects_what_could_never_run(engine):
    with pytest.raises(ValueError):
        engine.submit([])
    with pytest.raises(ValueError):
        engine.submit(list(range(17)))          # over the largest bucket


def _post(port, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/generate", body=json.dumps(body),
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    resp = conn.getresponse()
    return resp.status, resp.read().decode()


def test_sse_generate_end_to_end(served):
    goldens, params = served
    env = {"MODEL_PRESET": "debug", "HTTP_PORT": "0", "MAX_BATCH": "4",
           "MAX_SEQ_LEN": "64", "PREFILL_BUCKETS": "8,16", "PAGE_SIZE": "8"}
    app = build_app(env, engine=build_engine(env, device="cpu",
                                             params=params))
    app.start()
    try:
        tok = app.engine.tokenizer
        want = goldens[4]
        status, body = _post(app.http_port, {"prompt": "hello",
                                             "max_tokens": 12})
        assert status == 200
        events = [json.loads(line[len("data: "):])
                  for line in body.splitlines() if line.startswith("data: ")]
        assert events[-1]["done"] is True
        assert events[-1]["tokens"] == len(want)
        assert len(events) - 1 == len(want)     # one event per token
        assert "".join(e["text"] for e in events[:-1]) == tok.decode(want)

        status, body = _post(app.http_port, {"prompt": "hello",
                                             "max_tokens": 12,
                                             "stream": False})
        assert status == 201
        data = json.loads(body)["data"]
        assert data["tokens"] == len(want)
        assert data["text"] == tok.decode(want)

        status, body = _post(app.http_port, {"max_tokens": 4})
        assert status == 400
        conn = http.client.HTTPConnection("127.0.0.1", app.http_port,
                                          timeout=10)
        conn.request("GET", "/.well-known/health")
        assert json.loads(conn.getresponse().read())["status"] == "UP"
    finally:
        app.shutdown()


# (body fields beside the prompt, headers): the sampling controls and QoS
# class fields of the reference's /generate, valid and not
REQUEST_FIELDS = {
    "top_p": ({"top_p": 0.5}, {}),
    "top_k": ({"top_k": 3}, {}),
    "top_p-above-1": ({"top_p": 1.5}, {}),
    "top_k-negative": ({"top_k": -1}, {}),
    "top_p-not-a-number": ({"top_p": "x"}, {}),
    "class-unknown": ({"class": "gold"}, {}),
    "header-class-unknown": ({}, {"X-QoS-Class": "gold"}),
    "class-batch": ({"class": "batch"}, {}),
    "controls-zero": ({"top_p": 0, "top_k": 0}, {}),
}


@pytest.fixture(scope="module")
def both_servers(served):
    """(the reference llm-server app, the port's app), both started, both
    on the debug preset on the CPU with their default config."""
    import importlib.util
    import os

    from gofr_tpu.config import MockConfig

    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "llm-server", "main.py")
    spec = importlib.util.spec_from_file_location("example_llm_server_c1",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    ref = module.build_app(config=MockConfig({
        "HTTP_PORT": "0", "METRICS_PORT": "0", "APP_NAME": "example",
        "TPU_PLATFORM": "cpu", "MODEL_PRESET": "debug", "WARMUP": "false",
        "REQUEST_TIMEOUT": "60"}))
    env = {"MODEL_PRESET": "debug", "HTTP_PORT": "0", "MAX_BATCH": "2",
           "MAX_SEQ_LEN": "64", "PREFILL_BUCKETS": "8,16", "PAGE_SIZE": "8"}
    port = build_app(env, engine=build_engine(env, device="cpu",
                                              params=served[1]))
    ref.start()
    try:
        port.start()
        try:
            yield ref, port
        finally:
            port.shutdown()
    finally:
        ref.shutdown()


@pytest.mark.parametrize("case", sorted(REQUEST_FIELDS))
def test_generate_refuses_the_fields_the_reference_refuses(both_servers,
                                                           case):
    """The port's /generate answers each body with the reference's status:
    400 for top_p / top_k it does not serve or that are out of range or
    not numbers, and for an unknown class in the body or the X-QoS-Class
    header; 200 for a known class and for zero controls."""
    fields, headers = REQUEST_FIELDS[case]
    body = {"prompt": "hello", "max_tokens": 2, **fields}
    want, _ = _post(both_servers[0].http_port, body, headers)
    got, text = _post(both_servers[1].http_port, body, headers)
    assert got == want, text
    assert want in (200, 400)
    if case == "top_p":
        assert "ROADMAP A9" in text


@pytest.mark.parametrize("key", [k for k, _, _ in NOT_PORTED])
def test_unported_config_keys_refuse_to_boot(key):
    asks = {"PREFIX_CACHE": "true", "SAMPLING_CONTROLS": "true",
            "CHUNK_PREFILL_TOKENS": "64", "SPECULATIVE_TOKENS": "4",
            "DISAGG_MODE": "both", "KV_HOST_TIER_BYTES": "1048576",
            "QOS": "true", "WEIGHTS_PATH": "/x.safetensors",
            "WEIGHT_DTYPE": "int8", "VOCAB_PATH": "/vocab.json",
            "TP_SHARDS": "2"}
    with pytest.raises(ValueError, match="ROADMAP A"):
        build_engine({key: asks[key]}, device="cpu")


# config keys whose features are ported, each with an env that asks for it;
# KV_DTYPE=int8 boots both engines
PORTED = {
    "PAGED": {"PAGED": "false"},
    "DECODE_ATTN": {"PAGED": "false", "DECODE_ATTN": "kernel"},
    "KV_DTYPE": {"KV_DTYPE": "int8"},
    "KV_DTYPE-dense": {"PAGED": "false", "DECODE_ATTN": "kernel",
                       "KV_DTYPE": "int8"},
}


@pytest.mark.parametrize("key", sorted(PORTED))
def test_ported_config_keys_boot_and_serve(served, key):
    env = {"MODEL_PRESET": "debug", "HTTP_PORT": "0", "MAX_BATCH": "2",
           "MAX_SEQ_LEN": "64", "PREFILL_BUCKETS": "8,16", "PAGE_SIZE": "8",
           **PORTED[key]}
    engine = build_engine(env, device="cpu", params=served[1])
    app = build_app(env, engine=engine)
    app.start()
    try:
        assert isinstance(engine, PagedLLMEngine) == (env.get("PAGED")
                                                      != "false")
        assert engine.cfg.decode_attn == env.get("DECODE_ATTN", "xla")
        assert engine._q8 == ("KV_DTYPE" in env)
        status, body = _post(app.http_port, {"prompt": "hello",
                                             "max_tokens": 6,
                                             "stream": False})
        assert status == 201
        assert json.loads(body)["data"]["tokens"] >= 1
    finally:
        app.shutdown()


def test_dense_int8_without_kernel_decode_refuses_to_boot():
    """As the reference engine refuses it: no efficient plain dequant
    read."""
    with pytest.raises(ValueError, match="requires decode_attn='kernel'"):
        build_engine({"PAGED": "false", "KV_DTYPE": "int8",
                      "DECODE_ATTN": "xla"}, device="cpu")
    with pytest.raises(ValueError, match="DECODE_ATTN must be"):
        build_engine({"DECODE_ATTN": "pallas"}, device="cpu")
