"""Port dispatch layer vs the JAX engines: pipelined loop, async D2H, programs.

Goldens are computed live (never hard-coded): the JAX engines, which keep
`pipeline_depth=4` dispatches in flight by default, serve greedy streams on
`llama_init(debug, seed=0)`; the port's engines must serve the same tokens
on the bridged weights at `pipeline_depth` 1 and 4, in the four serving
configurations (paged, paged int8, dense with the decode kernel, dense
int8), with prefix hits on the paged ones.

Driven by hand (`_admit`, `_dispatch_decode`, `_sync_oldest`, the loop's
own order), both engines must also agree on what a row freed or cancelled
between dispatch and sync gets, on the dense cache's length after every
dispatch, and on the names of the decode programs the traffic compiles.
Programs are captured on the CPU by a stub capture (a replay is the eager
block), so the warm-up before each capture runs as on the card. The
program cache is held on stub programs, the kernels' launch counters (kept
on the card) on their plumbing, and the two serving keys (ENGINE_ASYNC_D2H,
WARMUP) boot and serve through serve.py.
"""

import dataclasses
import http.client
import json

import ctypes

import jax
import pytest
import torch

from gofr_tpu.models import llama as jl
from gofr_tpu.tpu.engine import LLMEngine as JEngine
from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
from gofr_tpu_torch.models import llama as tl
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.ops import _build, launch_counts
from gofr_tpu_torch.serve import build_app, build_engine
from gofr_tpu_torch.tpu.engine import LLMEngine
from gofr_tpu_torch.tpu.executor import Executor
from gofr_tpu_torch.tpu.paging import PagedLLMEngine

from _torch_env import INCIDENT_DIR

ENGINE = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16, 32),
              decode_block_size=4)
PAGED = dict(page_size=8, prefix_cache=True)
# config -> (paged, config fields)
CONFIGS = {
    "paged": (True, {}),
    "paged-int8": (True, {"kv_dtype": "int8"}),
    "dense": (False, {"decode_attn": "kernel"}),
    "dense-int8": (False, {"decode_attn": "kernel", "kv_dtype": "int8"}),
}
SYSTEM = list(range(1, 17))             # 2 full pages at page_size 8
# served alone first, so the two sharers below hit its pages
SEED = (SYSTEM + [40, 41], 6)
CONCURRENT = [(SYSTEM + [50, 51, 52], 8), (SYSTEM + [60], 10),
              ([5, 6, 7], 8), (list(range(70, 84)), 12)]


class _QuietLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


def _stub_capture(fn, inputs):
    """A capture that records nothing: each replay runs the block eagerly
    on the static inputs, as the graph would on the card."""
    return lambda: fn(*inputs)


@pytest.fixture(scope="module")
def weights():
    jparams = jl.llama_init(jl.LlamaConfig.debug(), seed=0)
    return jparams, params_from_numpy(jax.device_get(jparams), device="cpu")


def _jax_engine(jparams, config, **kw):
    paged, fields = CONFIGS[config]
    cfg = dataclasses.replace(jl.LlamaConfig.debug(), **fields)
    if paged:
        return JPaged(jparams, cfg, logger=_QuietLogger(),
                      **{**ENGINE, **PAGED, **kw})
    return JEngine(jparams, cfg, logger=_QuietLogger(), **ENGINE, **kw)


def _port_engine(tparams, config, **kw):
    paged, fields = CONFIGS[config]
    cfg = dataclasses.replace(tl.LlamaConfig.debug(), **fields)
    if paged:
        return PagedLLMEngine(tparams, cfg, device="cpu",
                              **{**ENGINE, **PAGED, **kw})
    return LLMEngine(tparams, cfg, device="cpu", **ENGINE, **kw)


def _serve(eng):
    """The seed alone, then the rest at once: (streams, prefix hit pages)."""
    eng.start()
    try:
        out = [eng.generate(SEED[0], max_new_tokens=SEED[1])]
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in CONCURRENT]
        out += [r.result(timeout_s=300) for r in reqs]
    finally:
        eng.stop()
    prefix = getattr(eng, "prefix", None)
    return out, prefix.stats()["hit_pages"] if prefix is not None else 0


@pytest.fixture(scope="module")
def goldens(weights):
    """config -> the JAX engine's (streams, hit pages), computed once."""
    cache = {}

    def get(config):
        if config not in cache:
            cache[config] = _serve(_jax_engine(weights[0], config))
        return cache[config]
    return get


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_greedy_streams_match_jax_at_each_depth(weights, goldens, config,
                                                depth):
    eng = _port_engine(weights[1], config, pipeline_depth=depth)
    got = _serve(eng)
    assert got == goldens(config)
    if CONFIGS[config][0]:
        assert got[1] == 2 * 2            # both sharers hit the 2 pages
    # depth 4 keeps decode blocks in flight behind each other
    assert eng.max_inflight >= depth
    assert not eng._inflight


def _drive(eng):
    """The loop's order by hand until idle: admit, dispatch decode while
    fewer than pipeline_depth are in flight, sync the oldest."""
    while True:
        eng._admit()
        while (len(eng._inflight) < eng.pipeline_depth
               and any(s.active for s in eng.slots)):
            eng._dispatch_decode()
        if not eng._inflight:
            return
        eng._sync_oldest()


def _free_list(eng):
    return list(eng.allocator._free)


@pytest.mark.parametrize("config", ["paged", "dense"])
def test_freed_and_cancelled_rows_between_dispatch_and_sync(weights, config):
    """A row whose budget ends in its first decode block while three
    younger blocks are in flight, and a row cancelled after its prefill was
    dispatched: both engines deliver the same tokens (the junk of the
    blocks in flight is discarded), and the pages of both rows go back to
    the allocator exactly once."""
    kw = dict(prefix_cache=False) if CONFIGS[config][0] else {}
    results = []
    for make, params in ((_jax_engine, weights[0]),
                         (_port_engine, weights[1])):
        eng = make(params, config, **kw)
        short = eng.submit([5, 6, 7], max_new_tokens=3)
        long = eng.submit([9, 10, 11, 12], max_new_tokens=14)
        eng._admit()
        for _ in range(3):
            eng._dispatch_decode()
        assert len(eng._inflight) == 5  # two waves of K=1, three blocks
        eng._sync_oldest()              # the prefills: first tokens
        eng._sync_oldest()
        eng._sync_oldest()              # the short row finishes here
        assert not eng.slots[0].active and len(eng._inflight) == 2
        late = eng.submit([20, 21], max_new_tokens=8)
        eng._admit()                    # takes the freed slot
        eng._dispatch_decode()
        late.cancel()                   # before its prefill is synced
        _drive(eng)
        got = [r.result(timeout_s=5) for r in (short, long, late)]
        pages = None
        if CONFIGS[config][0]:
            free = _free_list(eng)
            pages = (len(free), len(set(free)), eng.allocator.n_pages - 1)
        results.append((got, pages))
    (want, want_pages), (got, got_pages) = results
    assert got == want
    assert [len(t) for t in got] == [3, 14, 1]
    assert got_pages == want_pages
    if got_pages is not None:           # all back, none twice
        assert got_pages[0] == got_pages[1] == got_pages[2]


@pytest.mark.parametrize("config", ["dense", "dense-int8"])
def test_dense_cache_length_after_each_dispatch_matches_jax(weights, config):
    """The in-flight-aware _decode_need: the cache grows as JAX's does when
    both loops are driven the same way."""
    lengths = []
    for make, params in ((_jax_engine, weights[0]),
                         (_port_engine, weights[1])):
        eng = make(params, config)
        reqs = [eng.submit(p, max_new_tokens=n)
                for p, n in [([5, 6, 7], 20), (list(range(30, 37)), 24)]]
        seen = []
        eng._admit()
        seen.append(eng._cache_len)
        while eng._inflight or any(s.active for s in eng.slots):
            while (len(eng._inflight) < eng.pipeline_depth
                   and any(s.active for s in eng.slots)):
                eng._dispatch_decode()
                seen.append(eng._cache_len)
            eng._sync_oldest()
        lengths.append((seen, [r.result(timeout_s=5) for r in reqs]))
    assert lengths[1] == lengths[0]
    assert sorted(set(lengths[1][0])) == [16, 32, 64]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_program_names_match_the_jax_executor(weights, config):
    """Under a stub capture, the programs a fixed traffic compiles are the
    ones the JAX executor compiles for it: the decode blocks, one per
    (block, cache length) dense, per (block, table width) paged, half
    blocks included; the fused admission waves, one per (bucket, K) (and
    cache length, dense); the paged tail-only waves, one per (bucket, K,
    table width); and the warm-up before every capture leaves the streams
    untouched."""
    runs = []
    for make, params in ((_jax_engine, weights[0]),
                         (_port_engine, weights[1])):
        eng = make(params, config)
        port = make is _port_engine
        if port:
            eng.executor = Executor("cpu", capture=_stub_capture)
        # five requests on four slots: half blocks while one waits; then
        # two that hit the system prompt's cached pages (paged)
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in
                [SEED] + CONCURRENT]
        _drive(eng)
        reqs += [eng.submit(SYSTEM + [90 + i, 91], max_new_tokens=5)
                 for i in range(2)]
        _drive(eng)
        names = (eng.executor.compiled if port else
                 [n for n in eng.executor.cache_info()
                  if any(k in n for k in ("decode", "prefill", "prefix"))])
        runs.append((sorted(names), [r.result(timeout_s=5) for r in reqs]))
    (want_names, want), (names, got) = runs
    assert got == want
    assert names == want_names
    assert any("-x2-" in n for n in names) and any("-x4-" in n for n in names)
    assert any("prefill" in n for n in names)
    assert CONFIGS[config][0] == any("prefix" in n for n in names)


def test_program_calls_its_capture_once_and_replays_after():
    """A stub capture that records the block once and replays its output:
    the warm-up runs inside the caller's context before the capture, and
    every later compile of the name and every call reuses the program."""
    calls = []

    def block(x):
        calls.append(1)
        return x + 1

    def capture(fn, inputs):
        out = fn(*inputs)
        return lambda: out

    ex = Executor("cpu", capture=capture)
    warm = []
    x = torch.zeros(2)
    prog = ex.compile("p", block, (x,),
                      warmup=lambda: _note(warm))
    assert warm == ["in", "out"] and len(calls) == 2   # warm-up + capture
    for _ in range(4):
        assert torch.equal(prog(), torch.ones(2))
    assert len(calls) == 2 and ex.calls == 4 and prog.calls == 4
    assert ex.compile("p", block, (x,)) is prog and len(calls) == 2
    assert ex.cache_info() == {"p": 4} and ex.cache_size() == 1
    assert ex.captures == 1 and ex.compiled == ["p"]
    assert ex.drop(lambda name: name == "p") == 1 and ex.cache_size() == 0
    assert ex.calls == 4 and ex.compiled == ["p"]


class _note:
    def __init__(self, log):
        self.log = log

    def __enter__(self):
        self.log.append("in")

    def __exit__(self, *exc):
        self.log.append("out")


def test_failed_capture_raises_and_caches_nothing():
    warmed = []

    def capture(fn, inputs):
        fn(*inputs)
        raise RuntimeError("capture refused")

    ex = Executor("cpu", capture=capture)
    with pytest.raises(RuntimeError, match="capture refused"):
        ex.compile("p", lambda: warmed.append(1) or torch.zeros(1))
    assert ex.cache_size() == 0 and ex.captures == 0
    assert warmed == [1, 1]            # the warm-up and the capture


def test_cpu_programs_are_the_eager_callable():
    ex = Executor("cpu")
    calls = []
    prog = ex.compile("p", lambda x: calls.append(1) or x * 2,
                      (torch.ones(2),))
    assert not ex.captured and not calls        # nothing runs at compile
    assert torch.equal(prog(), torch.full((2,), 2.0)) and len(calls) == 1
    assert ex.captures == 0 and ex.calls == 1


# kernel -> the tensors its wrapper passes to the C entry point
_TENSORS = {"flash_attention": 4, "paged_attention": 8,
            "paged_attention_q8": 10, "decode_attention": 7,
            "decode_attention_q8": 9}


@pytest.mark.parametrize("kernel", launch_counts.KERNELS)
def test_every_kernel_takes_its_launch_counter(kernel):
    """Each C entry point takes, besides its tensors, its launch counter as
    the last pointer before the stream (the kernels count their own
    launches on the card, a graph's replays included), and every kernel
    has a counter of its own."""
    _, _, argtypes = _build.ENTRY_POINTS[kernel]
    assert argtypes.count(ctypes.c_void_p) == _TENSORS[kernel] + 2
    assert argtypes[-1] is ctypes.c_void_p
    assert set(launch_counts.KERNELS) == set(_build.ENTRY_POINTS)


def test_plain_versions_count_no_launch():
    """On the CPU a wrapper runs its kernel's plain version: nothing is
    launched and no counter is made."""
    from gofr_tpu_torch.ops.decode_attention import decode_attention
    from gofr_tpu_torch.ops.paged_attention import paged_attention

    before = dict(launch_counts._buffers)
    q = torch.randn(2, 4, 64)
    k, v = torch.randn(2, 2, 64, 16), torch.randn(2, 2, 64, 16)
    lens = torch.tensor([3, 16], dtype=torch.int32)
    decode_attention(q, k, v, lens)
    pool = torch.randn(3, 2, 64, 8)
    table = torch.tensor([[1, 2], [2, 1]], dtype=torch.int32)
    paged_attention(q, pool, pool, table, lens)
    assert launch_counts._buffers == before
    assert launch_counts.counts() == dict.fromkeys(launch_counts.KERNELS, 0)


def _generate(port, prompt, n):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/generate", body=json.dumps(
        {"prompt": prompt, "max_tokens": n, "stream": False}),
        headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


@pytest.mark.parametrize("paged", ["true", "false"])
@pytest.mark.parametrize("keys", [
    {}, {"ENGINE_ASYNC_D2H": "false"}, {"ENGINE_ASYNC_D2H": "true"},
    {"WARMUP": "false"}, {"WARMUP": "wide"}, {"WARMUP": "true"}],
    ids=["defaults", "d2h-false", "d2h-true", "warmup-false", "warmup-wide",
         "warmup-true"])
def test_dispatch_keys_boot_and_serve(weights, paged, keys):
    """Each value boots, serves, and sets what it names: async_d2h; WARMUP
    true registers every decode program serving can reach at boot (the
    full and half block) and the reference's warm admission set (K=1 per
    bucket; paged, the tail programs at the smallest bucket per bucket's
    page span), false none; wide adds every K <= MAX_BATCH that is a power
    of two and, paged, every tail program the buckets can reach."""
    env = {"MODEL_PRESET": "debug", "HTTP_PORT": "0", "MAX_BATCH": "2",
           "GRPC_PORT": "0",
           "MAX_SEQ_LEN": "64", "PREFILL_BUCKETS": "8,16", "PAGE_SIZE": "8",
           "REQUEST_TIMEOUT": "120", "PAGED": paged, "DECODE_ATTN": "kernel",
           "INCIDENT_DIR": INCIDENT_DIR, **keys}
    engine = build_engine(env, device="cpu", params=weights[1])
    booted = set(engine.executor.cache_info())
    app = build_app(env, engine=engine)
    app.start()
    try:
        status, body = _generate(app.http_port, "hello there", 6)
    finally:
        app.shutdown()
    assert status == 201 and body["data"]["tokens"] == 6
    assert engine.async_d2h == (keys.get("ENGINE_ASYNC_D2H") != "false")
    assert engine.pipeline_depth == 4
    wide = keys.get("WARMUP") == "wide"
    ks = (1, 2) if wide else (1,)
    if keys.get("WARMUP") == "false":
        assert not booted and engine.warmup_seconds == 0.0
    elif paged == "true":
        # MAX_SEQ_LEN 64 = 8 pages: widths pow2(pages + 1) = 2 .. 16; a
        # tail (prompts of 9-16 tokens on one cached page) is at bucket 8
        # over 2 pages
        tails = {f"llama-paged-prefix-8x1-NP{n}" for n in (1, 2)}
        if wide:
            tails.add("llama-paged-prefix-8x2-NP2")
        assert booted == ({f"llama-paged-decode-x{b}-NP{n}"
                           for b in (16, 8) for n in (2, 4, 8, 16)}
                          | {f"llama-paged-prefill-{b}x{k}" for b in (8, 16)
                             for k in ks} | tails)
    else:
        # the cache grown to MAX_SEQ_LEN, where it stays
        assert booted == ({"llama-decode-x16-S64-kern",
                           "llama-decode-x8-S64-kern"}
                          | {f"llama-prefill-{b}x{k}-S64-flash"
                             for b in (8, 16) for k in ks})
        assert engine._cache_len == 64
