"""Port prefix cache vs the JAX package: the cache, the tail prefill, engines.

- `PrefixCache`: the port's class and the JAX one driven through the same
  seeded random sequence of match / insert / unref / evict calls must
  return the same values and stats after every call, raise the same
  over-release error and evict leaf-first.
- `llama_prefill_paged_prefix[_q8]` against JAX on the same numpy inputs
  (weights bridged by `params_from_numpy`): logits within 1e-4 in f32,
  the written pools within 1e-5 (int8 pages bit-equal). In bf16 the JAX
  function cannot run on the CPU (XLA's CPU dot has no bf16 x bf16 -> f32
  kernel, which the reference's einsums ask for), so the bf16 port is held
  against JAX in f32 on the same bf16 values, within bf16 rounding.
- The A2 functions this slice brings along (`llama_forward`,
  `llama_prefill`, `llama_decode_step`, `forward_nocache_at`,
  `llama_forward_nocache`) against JAX, and a hit's tail-prefill logits
  against `llama_forward_nocache` at the last prompt position.
- Engines: the port's `PagedLLMEngine(prefix_cache=True)` against the JAX
  one, model-dtype (f32 debug) and int8 pools, on the reference test's
  scenarios (tests/test_prefix_cache.py): greedy streams token for token,
  the same hit / inserted / evicted page counts, the same prefill and
  tail-prefill wave shapes. Goldens are computed live.
"""

import collections
import dataclasses
import http.client
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jl
from gofr_tpu.ops.decode_attention import quantize_kv as jquantize
from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
from gofr_tpu.tpu.prefixcache import PrefixCache as JPrefixCache
from gofr_tpu_torch.models import llama as tl
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.ops.paged_attention import paged_write_prefill_stacked
from gofr_tpu_torch.serve import build_app, build_engine
from gofr_tpu_torch.tpu.paging import PagedLLMEngine
from gofr_tpu_torch.tpu.prefixcache import PrefixCache

from _torch_env import INCIDENT_DIR

CFG_J = jl.LlamaConfig.debug()
CFG_T = tl.LlamaConfig.debug()
PS = 8
SYSTEM = list(range(1, 33))            # 32 tokens = 4 full pages at PS=8
ENGINE = dict(n_slots=4, max_seq_len=128, prefill_buckets=(8, 32, 64),
              decode_block_size=4, page_size=PS, prefix_cache=True)
# 12 usable pages, and each request below reserves 4 of them
PRESSURE = dict(ENGINE, n_pages=13, max_seq_len=64, prefill_buckets=(8, 32))


class _QuietLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


@pytest.fixture(scope="module")
def weights():
    jparams = jl.llama_init(CFG_J, seed=0)
    return jparams, params_from_numpy(jax.device_get(jparams), device="cpu")


# -- PrefixCache -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prefix_cache_protocol_matches_jax(seed):
    """A random serving history over prompts that share prefixes: admit
    (match, then insert the slot's table pages: the hit, then fresh page
    ids), finish (unref the pages the cache owns, free the rest), evict.
    Both classes must agree on every return value and on stats() after
    every call; at the end on keys_for, digest and drop_all_idle."""
    rng = np.random.default_rng(seed)
    ps = 4
    stems = [rng.integers(0, 9, 20).tolist() for _ in range(3)]
    ours, ref = PrefixCache(ps), JPrefixCache(ps)
    free = list(range(1, 200))
    slots = []
    for _ in range(300):
        op = rng.choice(["admit", "admit", "finish", "evict"])
        if op == "admit":
            stem = stems[int(rng.integers(0, 3))]
            tokens = (stem[:int(rng.integers(0, 21))]
                      + rng.integers(0, 9, int(rng.integers(1, 7))).tolist())
            hit = ours.match(tokens)
            assert hit == ref.match(tokens)
            n_fresh = -(-len(tokens) // ps) - len(hit)
            pages = hit + free[:n_fresh]
            del free[:n_fresh]
            ours.insert(tokens, pages)
            ref.insert(tokens, pages)
            slots.append(pages)
        elif op == "finish" and slots:
            for page in slots.pop(int(rng.integers(0, len(slots)))):
                assert ours.owns(page) == ref.owns(page)
                if ours.owns(page):
                    ours.unref(page)
                    ref.unref(page)
                else:
                    free.append(page)
        elif op == "evict":
            n = int(rng.integers(0, 5))
            got = ours.evict_entries(n)
            assert got == ref.evict_entries(n)
            free.extend(page for _, page, _ in got)
        assert ours.stats() == ref.stats()
        assert ours.resident_pages == ref.resident_pages
    assert ours.stats()["hit_pages"] > 0 and ours.stats()["evicted_pages"] > 0
    assert ours.digest(8) == ref.digest(8)
    assert ours.keys_for(stems[0], 5) == ref.keys_for(stems[0], 5)
    for pages in slots:
        for page in pages:
            if ours.owns(page):
                ours.unref(page)
                ref.unref(page)
    assert sorted(ours.drop_all_idle()) == sorted(ref.drop_all_idle())
    assert ours.resident_pages == 0


def test_over_release_is_a_loud_error_and_eviction_is_leaf_first():
    """As tests/test_prefix_cache.py holds the reference: a chain evicts
    from its tail, the surviving prefix still matches, a page released once
    too often raises, and a content mismatch under a key is a miss."""
    for cls in (PrefixCache, JPrefixCache):
        c = cls(4)
        toks = list(range(1, 14))               # 3 full pages matchable
        c.insert(toks, [5, 6, 7])
        for p in (5, 6, 7):
            c.unref(p)                          # the owning slot finished
        assert c.evict(1) == [7]                # the tail, not the LRU head
        assert c.match(toks) == [5, 6]
        for p in (5, 6):
            c.unref(p)
        with pytest.raises(RuntimeError, match="over-released"):
            c.unref(5)
        exact = cls(4)
        exact.insert(list(range(1, 9)), [3, 4])  # 8 tokens: 1 page registers
        assert exact.resident_pages == 1
        key = next(iter(exact._entries))
        exact._entries[key] = (3, (9, 9, 9, 9))  # a collision
        assert exact.match(list(range(1, 9))) == []


# -- the tail prefill --------------------------------------------------------

# rows: a 2-page hit with a 5-token tail, a 1-page hit with a full-page
# tail, and a miss riding along (prefix_len 0); T = 8 (the smallest bucket)
TOKENS = np.random.default_rng(3).integers(0, CFG_J.vocab_size,
                                           (3, 8)).astype(np.int32)
PREFIX_LENS = np.array([16, 8, 0], dtype=np.int32)
LENGTHS = np.array([21, 16, 3], dtype=np.int32)
TABLE = np.array([[3, 4, 5, 0], [6, 7, 0, 0], [8, 0, 0, 0]], dtype=np.int32)
PROJECT_LAST = np.clip(LENGTHS - PREFIX_LENS - 1, 0, 7).astype(np.int32)
POOL = (CFG_J.n_layers, 12, CFG_J.n_kv_heads, CFG_J.head_dim, PS)


def _tail_args():
    return (torch.from_numpy(TOKENS).long(), torch.from_numpy(PREFIX_LENS),
            torch.from_numpy(LENGTHS))


def _jtail_args():
    return tuple(jnp.asarray(a) for a in (TOKENS, PREFIX_LENS, LENGTHS))


def test_prefill_paged_prefix_matches_jax_f32(weights):
    jparams, tparams = weights
    rng = np.random.default_rng(4)
    pk = rng.standard_normal(POOL, dtype=np.float32)
    pv = rng.standard_normal(POOL, dtype=np.float32)
    want = jl.llama_prefill_paged_prefix(
        jparams, CFG_J, *_jtail_args(), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(TABLE), jnp.asarray(PROJECT_LAST))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    got = tl.llama_prefill_paged_prefix(
        tparams, CFG_T, *_tail_args(), tk, tv, torch.from_numpy(TABLE),
        torch.from_numpy(PROJECT_LAST))
    assert got[1] is tk and got[2] is tv                  # in place
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4, rtol=1e-4)
    for g, w in ((tk, want[1]), (tv, want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    # the shared prefix pages (3, 4, 6) are read, never written
    for page in (3, 4, 6):
        assert torch.equal(tk[:, page], torch.from_numpy(pk[:, page]))


def test_prefill_paged_prefix_bf16_within_rounding_of_jax_f32():
    """bf16 weights and pools: the port in bf16 against JAX in f32 on the
    same bf16 values. Tolerance 0.1 on logits of rms ~1 and on the written
    K/V (|k| up to ~4, a bf16 ulp there is 2**-6): bf16 rounds every
    activation to 2**-8 of its value, across 2 layers; seen 0.02-0.05."""
    cj16 = dataclasses.replace(CFG_J, dtype="bfloat16")
    ct16 = dataclasses.replace(CFG_T, dtype="bfloat16")
    host = jax.device_get(jl.llama_init(cj16, seed=0))
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, dtype=np.float32)), host)
    rng = np.random.default_rng(5)
    pk, pv = (torch.from_numpy(rng.standard_normal(POOL, dtype=np.float32)
                               ).bfloat16() for _ in range(2))
    want = jl.llama_prefill_paged_prefix(
        jparams, CFG_J, *_jtail_args(), jnp.asarray(pk.float().numpy()),
        jnp.asarray(pv.float().numpy()), jnp.asarray(TABLE),
        jnp.asarray(PROJECT_LAST))
    got = tl.llama_prefill_paged_prefix(
        params_from_numpy(host, device="cpu"), ct16, *_tail_args(), pk, pv,
        torch.from_numpy(TABLE), torch.from_numpy(PROJECT_LAST))
    assert got[0].dtype == torch.float32 and pk.dtype == torch.bfloat16
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=0.1)
    assert (got[0].numpy().argmax(-1) == np.asarray(want[0]).argmax(-1)).all()
    for g, w in ((pk, want[1]), (pv, want[2])):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w), atol=0.1)


def _q8_pools(rng):
    k8, ks = jquantize(jnp.asarray(rng.standard_normal(POOL,
                                                       dtype=np.float32)))
    v8, vs = jquantize(jnp.asarray(rng.standard_normal(POOL,
                                                       dtype=np.float32)))
    return [np.asarray(a) for a in (k8, v8, ks, vs)]


def test_prefill_paged_prefix_q8_matches_jax(weights):
    """int8 pools: the tail's pages quantize to the same int8 values (bit
    equal) and scales (to f32 rounding: JAX's and the port's f32 K differ
    in the last bit), the prefix pages keep the donor's bits, logits within
    1e-4."""
    jparams, tparams = weights
    pools = _q8_pools(np.random.default_rng(6))
    want = jl.llama_prefill_paged_prefix_q8(
        jparams, CFG_J, *_jtail_args(), *(jnp.asarray(a) for a in pools),
        jnp.asarray(TABLE), jnp.asarray(PROJECT_LAST))
    bufs = [torch.from_numpy(a.copy()) for a in pools]
    got = tl.llama_prefill_paged_prefix_q8(
        tparams, CFG_T, *_tail_args(), *bufs, torch.from_numpy(TABLE),
        torch.from_numpy(PROJECT_LAST))
    assert all(g is b for g, b in zip(got[1:], bufs))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4, rtol=1e-4)
    for i in (0, 1):
        np.testing.assert_array_equal(bufs[i].numpy(), np.asarray(want[1 + i]))
        np.testing.assert_allclose(bufs[2 + i].numpy(),
                                   np.asarray(want[3 + i]), rtol=1e-6,
                                   atol=0)
        for page in (3, 4, 6):
            np.testing.assert_array_equal(bufs[i][:, page].numpy(),
                                          pools[i][:, page])
            np.testing.assert_array_equal(bufs[2 + i][:, page].numpy(),
                                          pools[2 + i][:, page])
    assert not np.array_equal(bufs[0].numpy(), pools[0])   # the tail landed


@pytest.mark.parametrize("q8", [False, True], ids=["fp", "int8"])
def test_tail_prefill_logits_equal_the_cache_free_forward(weights, q8):
    """A hit, end to end in the port (f32): prefill the first two pages of
    a 21-token prompt through the full-window path and write them into the
    pool (quantized under int8), then prefill the 5-token tail over them.
    Its last logits equal llama_forward_nocache's at the last prompt
    position (within 1e-4; int8 within 0.05, the int8 rounding of the
    prefix's K/V, seen 0.028)."""
    from gofr_tpu_torch.ops.decode_attention import quantize_kv
    from gofr_tpu_torch.ops.paged_attention import paged_write_prefill_scales

    _, tparams = weights
    L, Hkv, dh = CFG_T.n_layers, CFG_T.n_kv_heads, CFG_T.head_dim
    prompt = torch.from_numpy(np.random.default_rng(7).integers(
        0, CFG_T.vocab_size, (1, 21)))
    want = tl.llama_forward_nocache(tparams, CFG_T, prompt)[0, -1]
    tmp_k = torch.zeros((L, 1, Hkv, dh, 16))
    tmp_v = torch.zeros_like(tmp_k)
    tl.llama_prefill_last(tparams, CFG_T, prompt[:, :16],
                          torch.arange(16)[None], torch.tensor([16]),
                          tmp_k, tmp_v)
    pools = [torch.zeros(POOL), torch.zeros(POOL)]
    table = torch.tensor([[3, 4, 5, 0]], dtype=torch.int32)
    lengths = torch.tensor([16], dtype=torch.int32)
    if q8:
        (tmp_k, ks), (tmp_v, vs) = (quantize_kv(tmp_k), quantize_kv(tmp_v))
        pools = [torch.zeros(POOL, dtype=torch.int8) for _ in range(2)] + [
            torch.zeros(POOL[:3] + (PS,)) for _ in range(2)]
        paged_write_prefill_scales(pools[2], ks, table, lengths)
        paged_write_prefill_scales(pools[3], vs, table, lengths)
    paged_write_prefill_stacked(pools[0], pools[1], tmp_k, tmp_v, table,
                                lengths)
    tail = torch.zeros((1, 8), dtype=torch.long)
    tail[0, :5] = prompt[0, 16:]
    fn = (tl.llama_prefill_paged_prefix_q8 if q8
          else tl.llama_prefill_paged_prefix)
    got = fn(tparams, CFG_T, tail, torch.tensor([16]), torch.tensor([21]),
             *pools, table, torch.tensor([4]))[0][0]
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               atol=0.05 if q8 else 1e-4,
                               rtol=0 if q8 else 1e-4)


# -- A2: the cache-writing forward family and the cache-free forward --------

@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_forward_nocache_matches_jax(weights, attn_impl):
    jparams, tparams = weights
    tokens = np.random.default_rng(8).integers(0, CFG_J.vocab_size,
                                               (2, 24)).astype(np.int32)
    want = jl.llama_forward_nocache(
        jparams, dataclasses.replace(CFG_J, attn_impl=attn_impl),
        jnp.asarray(tokens))
    got = tl.llama_forward_nocache(
        tparams, dataclasses.replace(CFG_T, attn_impl=attn_impl),
        torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # at shifted positions: the body the sequence-parallel forward shares
    pos = np.tile(np.arange(5, 29, dtype=np.int32), (2, 1))
    want = jl.forward_nocache_at(jparams, CFG_J, jnp.asarray(tokens),
                                 jnp.asarray(pos))
    got = tl.forward_nocache_at(tparams, CFG_T,
                                torch.from_numpy(tokens).long(),
                                torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_llama_prefill_then_decode_step_match_jax(weights):
    """llama_prefill (llama_forward at positions [0, T)) into a dense
    [L, B, Hkv, dh, S] cache, then llama_decode_step at T: logits within
    1e-4, caches within 1e-5, written in place."""
    jparams, tparams = weights
    L, Hkv, dh = CFG_J.n_layers, CFG_J.n_kv_heads, CFG_J.head_dim
    B, T, S = 2, 10, 16
    tokens = np.random.default_rng(9).integers(0, CFG_J.vocab_size,
                                               (B, T)).astype(np.int32)
    zeros = np.zeros((L, B, Hkv, dh, S), dtype=np.float32)
    jlog, jk, jv = jl.llama_prefill(jparams, CFG_J, jnp.asarray(tokens),
                                    jnp.asarray(zeros), jnp.asarray(zeros))
    tk, tv = torch.zeros(zeros.shape), torch.zeros(zeros.shape)
    tlog, tk2, _ = tl.llama_prefill(tparams, CFG_T,
                                    torch.from_numpy(tokens).long(), tk, tv)
    assert tk2 is tk and tuple(tlog.shape) == (B, T, CFG_T.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)
    nxt = np.asarray(jlog)[:, -1].argmax(-1).astype(np.int32)
    pos = np.full((B,), T, dtype=np.int32)
    jlog, jk, jv = jl.llama_decode_step(jparams, CFG_J, jnp.asarray(nxt),
                                        jnp.asarray(pos), jk, jv)
    tlog, _, _ = tl.llama_decode_step(tparams, CFG_T,
                                      torch.from_numpy(nxt).long(),
                                      torch.from_numpy(pos).long(), tk, tv)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)
    for g, w in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


# -- engines -----------------------------------------------------------------

_SHAPE = re.compile(r"llama-paged-(prefill|prefix)(?:-q8)?-(\d+)x(\d+)")


def _jax_waves(eng):
    """{"prefill"/"prefix": Counter((K, bucket) -> waves)} from the JAX
    engine's compiled programs and their execution counts."""
    out = {"prefill": collections.Counter(), "prefix": collections.Counter()}
    for name, runs in eng.executor.cache_info().items():
        m = _SHAPE.match(name)
        if m and runs:
            out[m.group(1)][(int(m.group(3)), int(m.group(2)))] += runs
    return out


def _port_waves(eng):
    return {"prefill": collections.Counter(eng.prefill_shapes),
            "prefix": collections.Counter(eng.prefix_shapes)}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _gen(eng, prompt, n=8):
    return eng.submit(prompt, max_new_tokens=n, temperature=0.0).result(
        timeout_s=300)


def _scenarios(eng, waves):
    """The reference test's scenarios, one after another on one engine:
    what each served and counted."""
    rec = {}
    before = waves(eng)
    a = _gen(eng, SYSTEM + [40, 41, 42])          # cold: 35 tokens, bucket 64
    stats_a = eng.prefix.stats()
    b = _gen(eng, SYSTEM + [50, 51])              # 4-page hit, 2-token tail
    rec["tail_only"] = dict(streams=[a, b], stats=[stats_a,
                                                   eng.prefix.stats()],
                            waves=_delta(waves(eng), before))
    before = waves(eng)
    same = [_gen(eng, SYSTEM + [77, 78, 79, 80]) for _ in range(2)]
    rec["identical"] = dict(streams=same, stats=[eng.prefix.stats()],
                            waves=_delta(waves(eng), before))
    warm = _gen(eng, SYSTEM + [60])
    reqs = [eng.submit(SYSTEM + [61 + i], max_new_tokens=12, temperature=0.0)
            for i in range(2)]
    streams = [warm] + [r.result(timeout_s=300) for r in reqs]
    used, resident = eng.allocator.used_pages, eng.prefix.resident_pages
    eng.allocator.release(eng.prefix.drop_all_idle())
    rec["sharers"] = dict(streams=streams, stats=[eng.prefix.stats()],
                          pages=(used, resident, eng.allocator.used_pages))
    return rec


def _pressure(eng, waves):
    """Distinct 17-token prompts (2 full pages each) of 8 new tokens: each
    reserves 4 of the 12 usable pages and leaves 2 idle in the cache, so
    from the sixth on admission must evict idle cache pages to fit."""
    streams = [_gen(eng, [100 + 19 * i + j for j in range(17)])
               for i in range(7)]
    return {"pressure": dict(streams=streams, stats=[eng.prefix.stats()],
                             waves=waves(eng),
                             used=eng.allocator.used_pages)}


def _serve(make, waves):
    out = {}
    for kw, drive in ((ENGINE, _scenarios), (PRESSURE, _pressure)):
        eng = make(kw)
        eng.start()
        try:
            out.update(drive(eng, waves))
        finally:
            eng.stop()
    return out


@pytest.fixture(scope="module", params=["fp", "int8"])
def served(request, weights):
    """(JAX records, port records) of every scenario, per pool type."""
    jparams, tparams = weights
    kv = "int8" if request.param == "int8" else None
    cj = dataclasses.replace(CFG_J, kv_dtype=kv)
    ct = dataclasses.replace(CFG_T, kv_dtype=kv)
    want = _serve(lambda kw: JPaged(jparams, cj, logger=_QuietLogger(), **kw),
                  _jax_waves)
    got = _serve(lambda kw: PagedLLMEngine(tparams, ct, device="cpu", **kw),
                 _port_waves)
    return want, got


def test_second_request_admits_tail_only(served):
    want, got = (r["tail_only"] for r in served)
    assert got["streams"] == want["streams"]
    assert got["stats"] == want["stats"]
    assert [s["hit_pages"] for s in got["stats"]] == [0, 4]
    # the cold prompt prefills its full window, the hit only its tail, at
    # the smallest bucket
    assert got["waves"] == want["waves"] == {
        "prefill": {(1, 64): 1}, "prefix": {(1, 8): 1}}


def test_identical_prompt_reuses_and_stays_deterministic(served):
    want, got = (r["identical"] for r in served)
    assert got["streams"] == want["streams"]
    assert got["streams"][0] == got["streams"][1]
    assert got["stats"] == want["stats"]
    assert got["waves"] == want["waves"] == {"prefill": {},
                                             "prefix": {(1, 8): 2}}


def test_concurrent_sharers_and_page_accounting(served):
    """Two live requests share the prefix pages; once every slot is done
    only cache-resident pages stay used, and dropping the idle cache frees
    the pool."""
    want, got = (r["sharers"] for r in served)
    assert got["streams"] == want["streams"]
    assert got["stats"] == want["stats"]
    used, resident, after = got["pages"]
    assert used == resident > 0 and after == 0
    assert got["pages"] == want["pages"]


def test_pool_pressure_evicts_idle_cache_pages(served):
    want, got = (r["pressure"] for r in served)
    assert got["streams"] == want["streams"]
    assert all(len(s) == 8 for s in got["streams"])
    assert got["stats"] == want["stats"]
    assert got["stats"][0]["evicted_pages"] > 0
    assert got["waves"] == want["waves"]
    assert got["used"] == want["used"] == got["stats"][0]["resident_pages"]


# -- serving -----------------------------------------------------------------

def test_generate_serves_a_shared_prefix_from_the_cache(weights):
    """Through serve.py with its defaults (PREFIX_CACHE on): two requests
    whose prompts share a full page; the second hits it, prefills only its
    tail, and returns what an engine without the cache returns."""
    env = {"MODEL_PRESET": "debug", "HTTP_PORT": "0", "MAX_BATCH": "2",
           "GRPC_PORT": "0",
           "MAX_SEQ_LEN": "64", "PREFILL_BUCKETS": "8,16", "PAGE_SIZE": "8",
           "INCIDENT_DIR": INCIDENT_DIR}
    texts = {}
    for cache in ("true", "false"):
        run = dict(env, PREFIX_CACHE=cache)
        app = build_app(run, engine=build_engine(run, device="cpu",
                                                 params=weights[1]))
        app.start()
        try:
            out = []
            for prompt in ("shared sys:ab", "shared sys:cd"):  # 14 tokens
                conn = http.client.HTTPConnection("127.0.0.1", app.http_port,
                                                  timeout=60)
                conn.request("POST", "/generate", body=json.dumps(
                    {"prompt": prompt, "max_tokens": 6, "stream": False}),
                    headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                assert resp.status == 201
                out.append(json.loads(resp.read())["data"]["text"])
            texts[cache] = out
            engine = app.engine
            if cache == "true":
                assert engine.prefix.hit_pages == 1
                assert engine.prefix_shapes == {(1, 8): 1}
                assert engine.prefill_shapes == {(1, 16): 1}
            else:
                assert engine.prefix is None and not engine.prefix_shapes
        finally:
            app.shutdown()
    assert texts["true"] == texts["false"]
