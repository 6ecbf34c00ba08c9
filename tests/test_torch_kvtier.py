"""The KV tier on the port (tpu/kvtier.py and the paged engine's spill and
restore) against the reference's.

The twins of tests/test_kv_tier.py at the debug preset on the CPU. The
blob wire format is held across packages: ``encode_blob`` of the same
bf16, int8-with-scales and f32 planes is byte-equal in both, and each
package decodes the other's to the same bits (the port keeps bf16 planes
as uint16 patterns, the reference as ml_dtypes bfloat16). The host tier's
units and the cold tier over a fake Redis-shaped store run one sequence
through both packages' classes and compare answers and stats. The engine
lane holds the port's paged engine, under the same pool pressure as the
JAX ``PagedLLMEngine`` on the same weights, to its greedy streams and its
spilled and restored page counts (f32 and int8 pools); a bf16 pool's
landing is checked page for page.
"""

import dataclasses
import json
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from gofr_tpu.models.llama import LlamaConfig as JConfig
from gofr_tpu.models.llama import llama_init as jax_init
from gofr_tpu.tpu import kvtier as jkv
from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.tpu import kvtier as tkv
from gofr_tpu_torch.tpu.paging import PagedLLMEngine

PS = 8
SYSTEM = list(range(1, 33)) + [40, 41]     # 4 full pages + a 2-token tail
ENGINE = dict(n_slots=4, max_seq_len=128, prefill_buckets=(8, 32, 64),
              decode_block_size=4, page_size=PS, prefix_cache=True,
              n_pages=10)


class MockLogger:
    def debugf(self, *a, **k):
        pass

    infof = warnf = errorf = debugf


class FakeStore:
    """The Redis datasource's surface over a dict: set(key, value, ttl_s=),
    get, delete; values stored as str, as the string wire does."""

    def __init__(self, down: bool = False):
        self.data = {}
        self.down = down

    def set(self, key, value, ttl_s=None):
        if self.down:
            raise ConnectionError("redis down")
        self.data[key] = str(value)

    def get(self, key):
        if self.down:
            raise ConnectionError("redis down")
        return self.data.get(key)

    def delete(self, key):
        self.data.pop(key, None)


def _planes(kind: str, seed: int = 0):
    """(port planes, reference planes) of one page: [L, Hkv, dh, ps] k / v
    (+ [L, Hkv, ps] f32 scales for int8), the same bits in both."""
    rng = np.random.default_rng(seed)
    shape = (2, 2, 4, PS)
    if kind == "bf16":
        bits = [rng.integers(0, 1 << 16, size=shape, dtype=np.uint16)
                for _ in range(2)]
        return (bits, None), ([b.view(ml_dtypes.bfloat16) for b in bits],
                              None)
    if kind == "int8":
        kv = [rng.integers(-127, 128, size=shape, dtype=np.int8)
              for _ in range(2)]
        sc = [rng.random((2, 2, PS), dtype=np.float32) for _ in range(2)]
        return (kv, sc), (kv, sc)
    kv = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    return (kv, None), (kv, None)


def _blob(module, planes, tokens):
    kv, sc = planes
    return module.PageBlob(tokens, kv[0], kv[1],
                           None if sc is None else sc[0],
                           None if sc is None else sc[1])


def _bits(arr):
    return np.asarray(arr).view(np.uint8)


# -- the wire format, across packages -----------------------------------------
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_blob_wire_format_is_the_references_byte_for_byte(kind):
    ours, ref = _planes(kind)
    tokens = list(range(3, 3 + PS))
    raw_t = tkv.encode_blob(_blob(tkv, ours, tokens))
    raw_j = jkv.encode_blob(_blob(jkv, ref, tokens))
    assert raw_t == raw_j
    if kind == "bf16":
        assert json.loads(raw_t)["k"]["dtype"] == "bfloat16"
    # each package decodes the other's to the same bits
    from_ref = tkv.decode_blob(raw_j)
    from_port = jkv.decode_blob(raw_t)
    assert from_ref is not None and from_port is not None
    assert from_ref.tokens == from_port.tokens == tuple(tokens)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(from_ref, name), getattr(from_port, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape
            np.testing.assert_array_equal(_bits(a), _bits(b))
    if kind == "bf16":
        assert from_ref.k.dtype == np.uint16
        assert str(from_port.k.dtype) == "bfloat16"
    assert from_ref.nbytes == from_port.nbytes


def test_blob_decode_rejects_corruption_and_version_skew():
    raw = tkv.encode_blob(_blob(tkv, _planes("bf16")[0], [1, 2, 3]))
    assert tkv.decode_blob(raw) is not None
    body = json.loads(raw)
    data = body["k"]["data"]
    body["k"]["data"] = data[:-4] + ("AAAA" if data[-4:] != "AAAA"
                                     else "BBBB")
    torn = json.dumps(body)
    assert tkv.decode_blob(torn) is None and jkv.decode_blob(torn) is None
    body = json.loads(raw)
    body["v"] = 99
    skew = json.dumps(body)
    assert tkv.decode_blob(skew) is None and jkv.decode_blob(skew) is None
    for garbage in ("{not json", None, b"\xff\xfe", "[1, 2]"):
        assert tkv.decode_blob(garbage) is None


# -- the host tier, one sequence through both packages ------------------------
def _tiny(module, tag: int, tokens=None, nbytes: int = 1024):
    n = max(1, nbytes // 16)
    return module.PageBlob(tokens if tokens is not None
                           else [tag + i for i in range(PS)],
                           np.full((2, n), tag, dtype=np.float32),
                           np.full((2, n), -tag, dtype=np.float32))


def _tier_script(module, sleep):
    """The reference tests' host-tier sequence; returns every answer and
    the stats after each phase."""
    out = []
    tier = module.HostKVTier(capacity_bytes=3 * 1024 + 512, page_size=PS)
    for key in (1, 2, 3):
        out.append(tier.put(key, _tiny(module, key)))
    out.append(tier.get(1, _tiny(module, 1).tokens) is not None)
    tier.put(4, _tiny(module, 4))
    out.append(tier.keys())
    out.append(tier.get(2, _tiny(module, 2).tokens) is None)
    out.append(tier.inventory(2))
    st = tier.stats()
    out.append(st)
    # oversized
    small = module.HostKVTier(capacity_bytes=512, page_size=PS)
    out.append(small.put(1, _tiny(module, 1, nbytes=4096)))
    out.append(small.stats())
    # a collision: a miss and a purge
    coll = module.HostKVTier(capacity_bytes=1 << 20, page_size=PS)
    coll.put(7, _tiny(module, 7, tokens=[1, 2, 3]))
    out.append(coll.get(7, [9, 9, 9]) is None)
    out.append(coll.get(7, [1, 2, 3]) is None)
    out.append(coll.stats()["corrupt"])
    # pins: the unpinned key goes though older; an absent key's pin counts
    pin = module.HostKVTier(capacity_bytes=2 * 1024 + 512, page_size=PS)
    pin.put(1, _tiny(module, 1))
    pin.put(2, _tiny(module, 2))
    pin.pin([1], ttl_s=60.0)
    pin.put(3, _tiny(module, 3))
    out.append((pin.contains(1, _tiny(module, 1).tokens),
                pin.contains(2, _tiny(module, 2).tokens)))
    pin.pin([99], ttl_s=60.0)
    out.append(pin.stats()["pinned"])
    short = module.HostKVTier(capacity_bytes=1024 + 256, page_size=PS)
    short.put(1, _tiny(module, 1))
    short.pin([1], ttl_s=0.02)
    sleep(0.05)
    short.put(4, _tiny(module, 4))
    out.append(short.contains(1, _tiny(module, 1).tokens))
    # all pinned: over budget rather than a dropped pin
    over = module.HostKVTier(capacity_bytes=1024 + 256, page_size=PS)
    over.put(1, _tiny(module, 1))
    over.pin([1, 2], ttl_s=60.0)
    over.put(2, _tiny(module, 2))
    out.append((over.contains(1, _tiny(module, 1).tokens),
                over.contains(2, _tiny(module, 2).tokens),
                over.stats()["used_bytes"] > over.capacity_bytes))
    return out


def test_host_tier_answers_as_the_reference():
    ours = _tier_script(tkv, time.sleep)
    ref = _tier_script(jkv, time.sleep)
    assert ours == ref
    assert ours[4] == [3, 1, 4] and ours[5] is True
    assert ours[-1] == (True, True, True)


# -- the cold tier over a fake store ------------------------------------------
def test_cold_tier_round_trip_and_purge_as_the_reference():
    for module in (tkv, jkv):
        store = FakeStore()
        tier = module.RedisKVTier(store, write_behind=False)
        blob = _tiny(module, 3)
        tier.put(11, blob)
        out = tier.get(11, blob.tokens)
        assert out is not None
        np.testing.assert_array_equal(out.k, blob.k)
        assert tier.get(11, [0] * PS) is None
        assert tier.get(11, blob.tokens) is None
        assert tier.stats() == {"hits": 1, "misses": 2, "stored": 1,
                                "corrupt": 1, "errors": 0, "dropped": 0}
    # the stored strings are the same
    a, b = FakeStore(), FakeStore()
    tkv.RedisKVTier(a, write_behind=False).put(5, _tiny(tkv, 5))
    jkv.RedisKVTier(b, write_behind=False).put(5, _tiny(jkv, 5))
    assert a.data == b.data and list(a.data) == ["gofr:kvpage:0x5"]


def test_cold_tier_down_store_counts_errors():
    tier = tkv.RedisKVTier(FakeStore(down=True), write_behind=False)
    tier.put(1, _tiny(tkv, 1))
    assert tier.get(1, _tiny(tkv, 1).tokens) is None
    assert tier.stats()["errors"] == 2 and tier.stats()["stored"] == 0


def test_host_tier_cold_fallthrough_and_promote():
    cold = tkv.RedisKVTier(FakeStore(), write_behind=True, queue_depth=8)
    tier = tkv.HostKVTier(capacity_bytes=1024 + 256, page_size=PS, cold=cold)
    tier.put(1, _tiny(tkv, 1))
    tier.put(2, _tiny(tkv, 2))          # evicts 1 to the cold queue
    cold.flush()
    deadline = time.monotonic() + 5
    while cold.stats()["stored"] < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cold.stats()["stored"] == 1
    out = tier.get(1, _tiny(tkv, 1).tokens)
    np.testing.assert_array_equal(out.k, _tiny(tkv, 1).k)
    assert tier.stats()["redis"]["hits"] == 1
    assert tier.contains(1, _tiny(tkv, 1).tokens)   # promoted


# -- the engine lane -----------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    jparams = jax_init(JConfig.debug(), seed=0)
    return jparams, params_from_numpy(jax.device_get(jparams), device="cpu")


def _evict_with_traffic(eng, rng_base: int = 100):
    """Fill the 10-page pool with fresh prompts until the SYSTEM trunk's
    idle pages are spilled; the same traffic on both engines."""
    streams = []
    for i in range(6):
        toks = [rng_base + 7 * i + j for j in range(17)]
        streams.append(eng.generate([t % 250 + 1 for t in toks],
                                    max_new_tokens=6, temperature=0.0))
        if eng._kv_spilled >= 4:
            break
    return streams


def _tier_run(eng):
    """The reference test's scenario: a cold prefill, the trunk evicted to
    the tier, the same prompt again (the restore path). Returns the
    streams and the counts."""
    eng.start()
    try:
        golden = eng.generate(SYSTEM, max_new_tokens=8, temperature=0.0)
        churn = _evict_with_traffic(eng)
        spilled = eng._kv_spilled
        again = eng.generate(SYSTEM, max_new_tokens=8, temperature=0.0)
        return {"golden": golden, "churn": churn, "again": again,
                "spilled": spilled, "restored": eng._kv_restored}
    finally:
        eng.stop()


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
def test_restore_equals_recompute_and_the_jax_engine(weights, q8):
    """Restore is bit-equal to recompute (the repeat's tokens are the cold
    prefill's), and the streams and the spilled / restored counts equal the
    JAX PagedLLMEngine's under the same pool pressure."""
    jcfg = JConfig.debug()
    cfg = LlamaConfig.debug()
    if q8:
        jcfg = dataclasses.replace(jcfg, kv_dtype="int8")
        cfg = dataclasses.replace(cfg, kv_dtype="int8")
    want = _tier_run(JPaged(weights[0], jcfg, logger=MockLogger(),
                            kv_host_tier_bytes=64 << 20, **ENGINE))
    got = _tier_run(PagedLLMEngine(weights[1], cfg, device="cpu",
                                   logger=MockLogger(),
                                   kv_host_tier_bytes=64 << 20, **ENGINE))
    assert got["spilled"] > 0 and got["restored"] > 0
    assert got["again"] == got["golden"]
    assert got == want


def test_restore_from_the_cold_tier(weights):
    """A host tier of ~1.5 page blobs pushes the spills on to the cold
    store (base64 JSON); the repeat restores from there, bit-equal."""
    cold = tkv.RedisKVTier(FakeStore(), write_behind=False)
    eng = PagedLLMEngine(weights[1], LlamaConfig.debug(), device="cpu",
                         logger=MockLogger(), kv_host_tier_bytes=6144,
                         kv_redis=cold, **ENGINE)
    got = _tier_run(eng)
    assert got["again"] == got["golden"]
    stats = eng.kv_tier.stats()
    assert stats["redis"]["stored"] > 0 and stats["redis"]["hits"] > 0


def test_conversation_pin_survives_tier_churn(weights):
    eng = PagedLLMEngine(weights[1], LlamaConfig.debug(), device="cpu",
                         logger=MockLogger(), kv_host_tier_bytes=64 << 20,
                         **ENGINE)
    eng.start()
    try:
        golden = eng.generate(SYSTEM, max_new_tokens=8, temperature=0.0)
        pinned = eng.pin_conversation("conv-1", SYSTEM)
        assert pinned == len(SYSTEM) // PS
        _evict_with_traffic(eng)
        assert eng.generate(SYSTEM, max_new_tokens=8,
                            temperature=0.0) == golden
        assert eng.kv_tier.stats()["pinned"] >= pinned
    finally:
        eng.stop()


def test_bf16_pool_lands_in_place_bit_for_bit(weights):
    """A bf16 pool's pages pulled as blobs (uint16 planes, crc-wired) and
    landed into other pages of the same pool: the pages equal bit for bit,
    the pools and the loop state are the same tensors as before."""
    cfg = dataclasses.replace(LlamaConfig.debug(), dtype="bfloat16")
    params = llama_init(cfg, seed=0, device="cpu")
    eng = PagedLLMEngine(params, cfg, device="cpu", logger=MockLogger(),
                         kv_host_tier_bytes=64 << 20, **ENGINE)
    ptrs = [t.data_ptr() for t in (eng.k_cache, eng.v_cache, eng._tokens,
                                   eng._positions, eng._temps)]
    eng.start()
    try:
        eng.generate(SYSTEM, max_new_tokens=4, temperature=0.0)
    finally:
        eng.stop()
    src = [1, 2, 3]
    blobs = eng._page_blobs(src, [SYSTEM[i * PS:(i + 1) * PS]
                                  for i in range(3)])
    assert blobs[0].k.dtype == np.uint16
    wired = [tkv.decode_blob(tkv.encode_blob(b)) for b in blobs]
    dst = [7, 8, 9]
    eng._h2d_restore(dst, wired)
    for s, d in zip(src, dst):
        assert torch.equal(eng.k_cache[:, d].view(torch.int16),
                           eng.k_cache[:, s].view(torch.int16))
        assert torch.equal(eng.v_cache[:, d].view(torch.int16),
                           eng.v_cache[:, s].view(torch.int16))
    assert ptrs == [t.data_ptr() for t in (eng.k_cache, eng.v_cache,
                                           eng._tokens, eng._positions,
                                           eng._temps)]


def test_tier_needs_the_prefix_cache(weights):
    with pytest.raises(ValueError, match="prefix_cache"):
        PagedLLMEngine(weights[1], LlamaConfig.debug(), device="cpu",
                       logger=MockLogger(), kv_host_tier_bytes=1 << 20,
                       **dict(ENGINE, prefix_cache=False))


def test_prewarm_and_inventory_as_the_reference(weights):
    """tier_inventory lists the newest resident pages as {key, tokens};
    prewarm_from_tier pulls advertised pages through the tier's own get,
    so the pages a shared cold store holds promote into host RAM (a page
    only the peer's host RAM holds is a miss, malformed rows are skipped),
    and the first request over them restores from host RAM."""
    store = FakeStore()
    a = PagedLLMEngine(weights[1], LlamaConfig.debug(), device="cpu",
                       logger=MockLogger(), kv_host_tier_bytes=6144,
                       kv_redis=tkv.RedisKVTier(store, write_behind=False),
                       **ENGINE)
    golden = _tier_run(a)["golden"]
    trunk = [{"key": k, "tokens": SYSTEM[i * PS:(i + 1) * PS]}
             for i, k in enumerate(a.prefix.keys_for(SYSTEM, 4))]

    def in_cold():
        return sum(1 for r in trunk
                   if f"gofr:kvpage:{r['key']:#x}" in store.data)

    a.start()
    try:   # more churn, until the whole trunk went through the cold store
        for i in range(12):
            if in_cold() == len(trunk):
                break
            a.generate([(200 + 5 * i + j) % 250 + 1 for j in range(17)],
                       max_new_tokens=6, temperature=0.0)
    finally:
        a.stop()
    assert in_cold() == len(trunk)
    rows = a.tier_inventory(64)
    assert rows and all(set(r) == {"key", "tokens"} for r in rows)
    b = PagedLLMEngine(weights[1], LlamaConfig.debug(), device="cpu",
                       logger=MockLogger(), kv_host_tier_bytes=64 << 20,
                       kv_redis=tkv.RedisKVTier(store, write_behind=False),
                       **ENGINE)
    only_host = [r for r in rows
                 if f"gofr:kvpage:{r['key']:#x}" not in store.data]
    warmed = b.prewarm_from_tier(trunk + only_host + [{"key": "x"}, {}])
    assert warmed == len(trunk)
    assert b.kv_tier.stats()["pages"] == len(trunk)
    hits0 = b.kv_tier.stats()["hits"]
    b.start()
    try:
        assert b.generate(SYSTEM, max_new_tokens=8,
                          temperature=0.0) == golden
    finally:
        b.stop()
    assert b.kv_tier.stats()["hits"] > hits0 and b._kv_restored > 0
    assert PagedLLMEngine(weights[1], LlamaConfig.debug(), device="cpu",
                          logger=MockLogger(),
                          **ENGINE).prewarm_from_tier(rows) == 0


def test_openai_conversation_id_pins_the_trunk(weights):
    """The OpenAI server's conversation_id pins the conversation's full
    pages (prompt + completion) in the host tier for CONVERSATION_PIN_S,
    as the reference's does under KV_HOST_TIER_BYTES."""
    import urllib.request

    from gofr_tpu_torch import serve, serve_openai

    from _torch_env import INCIDENT_DIR

    env = {"MODEL_PRESET": "debug", "HTTP_PORT": "0", "METRICS_PORT": "0",
           "GRPC_PORT": "0",
           "MAX_BATCH": "4", "MAX_SEQ_LEN": "128",
           "PREFILL_BUCKETS": "8,16,32,64", "PAGE_SIZE": str(PS),
           "WARMUP": "false", "LOG_LEVEL": "WARN", "HOSTPROF": "false",
           "INCIDENT_DIR": INCIDENT_DIR, "KV_HOST_TIER_BYTES": "1048576",
           "CONVERSATION_PIN_S": "30"}
    app = serve_openai.build_app(env, engine=serve.build_engine(
        env, device="cpu", params=weights[1]))
    app.start()
    try:
        body = {"messages": [{"role": "user", "content": "x" * 40}],
                "max_tokens": 8, "temperature": 0, "conversation_id": "c1"}
        req = urllib.request.Request(
            f"http://127.0.0.1:{app.http_port}/v1/chat/completions",
            method="POST", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status in (200, 201)
        tier = app.engine.kv_tier
        assert app.engine.conversation_pin_s == 30.0
        assert tier.stats()["pinned"] >= 40 // PS
    finally:
        app.shutdown()
