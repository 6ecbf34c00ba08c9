"""Port chunked prefill vs the JAX package (ROADMAP A10).

- `llama_prefill_chunk` and `llama_prefill_chunk_q8` against JAX over three
  chunks of two rows on the same numpy inputs (weights bridged by
  `params_from_numpy`): logits within 1e-4, caches within 1e-5, int8 codes
  within 1 (and their scales within 1e-5).
- The engines, the twins of tests/test_chunked_prefill.py, each held to the
  JAX engine's live streams on the same weights: chunked equals fused
  (dense and paged, f32 and int8 KV: the int8 ones to the JAX engine
  chunked alike, as the dense one re-reads earlier chunks quantized), a
  chunked admission while another request decodes, two jobs of one shape
  at once (their carried state swapped), the chunk size dividing the
  buckets, stop() failing mid-prefill requests, pages released, the
  warm-up's program names equal the JAX executor's (the cache length
  aside: the port's dense warm-up grows to MAX_SEQ_LEN), and a prefix hit
  whose tail would still chunk dropped as the reference drops it.
- The chunk graphs against eager (the CPU capture stub) and
  CHUNK_PREFILL_TOKENS served through `serve.build_engine`.
"""

import dataclasses
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jl
from gofr_tpu.ops.decode_attention import quantize_kv as jquantize
from gofr_tpu.tpu.engine import LLMEngine as JEngine
from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
from gofr_tpu_torch.models import llama as tl
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.serve import build_engine
from gofr_tpu_torch.tpu import graphcheck
from gofr_tpu_torch.tpu.engine import LLMEngine
from gofr_tpu_torch.tpu.executor import Executor
from gofr_tpu_torch.tpu.paging import PagedLLMEngine

CFG_J = jl.LlamaConfig.debug()
CFG_T = tl.LlamaConfig.debug()
L, HKV, DH = CFG_J.n_layers, CFG_J.n_kv_heads, CFG_J.head_dim
# tests/test_chunked_prefill.py's: the fused path (len 3), and last prompt
# tokens in chunk 3 of 4, the final chunk, and chunk 2 (bucket 32, chunk 8)
PROMPTS = [list(range(1, 4)), list(range(1, 21)), list(range(1, 31)),
           list(range(40, 49))]
ENGINE = dict(n_slots=4, max_seq_len=128, prefill_buckets=(8, 32),
              decode_block_size=4)
# (paged, config fields) of the four configurations
CONFIGS = {"dense": (False, {}), "paged": (True, {}),
           "dense-int8": (False, {"decode_attn": "kernel",
                                  "kv_dtype": "int8"}),
           "paged-int8": (True, {"kv_dtype": "int8"})}
SYSTEM = list(range(60, 92))             # two full 16-token pages


class _QuietLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


@pytest.fixture(scope="module")
def weights():
    jparams = jl.llama_init(CFG_J, seed=0)
    return jparams, params_from_numpy(jax.device_get(jparams), device="cpu")


def _jax(jparams, config, chunk=0, **kw):
    paged, fields = CONFIGS[config]
    cfg = dataclasses.replace(CFG_J, **fields)
    extra = {"page_size": 16} if paged else {}
    cls = JPaged if paged else JEngine
    return cls(jparams, cfg, logger=_QuietLogger(), chunk_prefill_tokens=chunk,
               **{**ENGINE, **extra, **kw})


def _port(tparams, config, chunk=0, **kw):
    paged, fields = CONFIGS[config]
    cfg = dataclasses.replace(CFG_T, **fields)
    extra = {"page_size": 16} if paged else {}
    cls = PagedLLMEngine if paged else LLMEngine
    return cls(tparams, cfg, device="cpu", chunk_prefill_tokens=chunk,
               **{**ENGINE, **extra, **kw})


def _generate(eng, prompts, n=8):
    eng.start()
    try:
        return [eng.generate(p, max_new_tokens=n, temperature=0.0)
                for p in prompts]
    finally:
        eng.stop()


def _active_decode(eng):
    """tests/test_chunked_prefill.py's: a chunked admission lands while
    another request decodes."""
    eng.start()
    try:
        long_req = eng.submit([5, 6, 7], max_new_tokens=40)
        deadline = time.monotonic() + 60
        while long_req.generated < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        new_req = eng.submit(list(range(1, 25)), max_new_tokens=8)
        return [long_req.result(timeout_s=120), new_req.result(timeout_s=120)]
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def want(weights):
    """The JAX engines' streams, computed once: fused f32 (PROMPTS, and the
    active-decode pair), and chunked int8 KV, dense and paged."""
    jparams = weights[0]
    out = {}
    eng = _jax(jparams, "dense")
    eng.start()
    try:
        out["fused"] = [eng.generate(p, max_new_tokens=8) for p in PROMPTS]
        out["active"] = [eng.generate([5, 6, 7], max_new_tokens=40),
                         eng.generate(list(range(1, 25)), max_new_tokens=8)]
    finally:
        eng.stop()
    for config in ("dense-int8", "paged-int8"):
        out[config] = _generate(_jax(jparams, config, chunk=8), PROMPTS)
    return out


# -- the chunk forwards --------------------------------------------------------

B_, S_, C_ = 3, 32, 8
SLOTS = np.array([2, 0], dtype=np.int32)
LENGTHS = np.array([20, 11], dtype=np.int32)


def _chunks():
    """(tokens [2, 8], positions [2, 8], project_last [2]) of each chunk."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, CFG_J.vocab_size, (2, 24)).astype(np.int32)
    for start in range(0, 24, C_):
        pos = np.tile(np.arange(start, start + C_, dtype=np.int32), (2, 1))
        last = np.clip(LENGTHS - 1 - start, 0, C_ - 1).astype(np.int32)
        yield prompt[:, start:start + C_], pos, last


def test_prefill_chunk_matches_jax(weights):
    jparams, tparams = weights
    rng = np.random.default_rng(6)
    ck = rng.standard_normal((L, B_, HKV, DH, S_), dtype=np.float32)
    cv = rng.standard_normal((L, B_, HKV, DH, S_), dtype=np.float32)
    jk = tuple(jnp.asarray(c) for c in ck)
    jv = tuple(jnp.asarray(c) for c in cv)
    tk = [torch.from_numpy(c.copy()) for c in ck]
    tv = [torch.from_numpy(c.copy()) for c in cv]
    for i, (tokens, pos, last) in enumerate(_chunks()):
        project = None if i == 1 else last        # None skips the head
        wl, jk, jv = jl.llama_prefill_chunk(
            jparams, CFG_J, jnp.asarray(tokens), jnp.asarray(pos), jk, jv,
            jnp.asarray(SLOTS),
            None if project is None else jnp.asarray(project))
        gl, tk2, _ = tl.llama_prefill_chunk(
            tparams, CFG_T, torch.from_numpy(tokens).long(),
            torch.from_numpy(pos).long(), tk, tv,
            torch.from_numpy(SLOTS).long(),
            None if project is None else torch.from_numpy(project))
        assert tk2 is tk
        if project is None:
            assert gl is None and wl is None
        else:
            np.testing.assert_allclose(gl.numpy(), np.asarray(wl),
                                       atol=1e-4, rtol=1e-4)
    for got, ref in ((tk, jk), (tv, jv)):
        for g, w in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-5)
    # row 1 is not a slot of the wave: untouched
    np.testing.assert_array_equal(tk[0][1].numpy(), ck[0][1])


def test_prefill_chunk_q8_matches_jax(weights):
    jparams, tparams = weights
    rng = np.random.default_rng(7)
    pools = []
    for _ in range(2):
        c8, cs = jquantize(jnp.asarray(rng.standard_normal(
            (L, B_, HKV, DH, S_), dtype=np.float32)))
        pools += [np.asarray(c8), np.asarray(cs)]
    k8, ks, v8, vs = pools
    j = [tuple(jnp.asarray(a) for a in arr) for arr in (k8, v8, ks, vs)]
    t = [[torch.from_numpy(a.copy()) for a in arr] for arr in (k8, v8, ks, vs)]
    for tokens, pos, last in _chunks():
        wl, *j = jl.llama_prefill_chunk_q8(
            jparams, CFG_J, jnp.asarray(tokens), jnp.asarray(pos), *j,
            jnp.asarray(SLOTS), jnp.asarray(last))
        gl, *t2 = tl.llama_prefill_chunk_q8(
            tparams, CFG_T, torch.from_numpy(tokens).long(),
            torch.from_numpy(pos).long(), *t,
            torch.from_numpy(SLOTS).long(), torch.from_numpy(last))
        assert all(a is b for a, b in zip(t2, t))
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-4,
                                   rtol=1e-4)
    for i in (0, 1):                               # int8 codes within 1
        for g, w in zip(t[i], j[i]):
            assert np.abs(g.numpy().astype(np.int32)
                          - np.asarray(w).astype(np.int32)).max() <= 1
    for i in (2, 3):
        for g, w in zip(t[i], j[i]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-5)


# -- the engines ---------------------------------------------------------------

@pytest.mark.parametrize("config", ["dense", "paged"])
def test_chunked_matches_fused_token_for_token(weights, want, config):
    eng = _port(weights[1], config, chunk=8)
    assert _generate(eng, PROMPTS) == want["fused"]
    # prompts 1-3 took bucket 32: 4 chunks each, one job each
    assert eng.chunk_jobs == 3 and eng.chunk_dispatches == 12
    assert eng.prefill_dispatches == 1


@pytest.mark.parametrize("config", ["dense-int8", "paged-int8"])
def test_chunked_int8_kv_matches_jax(weights, want, config):
    eng = _port(weights[1], config, chunk=8)
    assert _generate(eng, PROMPTS) == want[config]
    if eng._paged:
        assert eng.allocator.used_pages == 0


@pytest.mark.parametrize("config", ["dense", "paged"])
def test_chunked_admission_during_active_decode(weights, want, config):
    """The decoding request's stream is untouched (dense: its parked
    positions; paged: the reserved slot's zero table row) and the new one
    equals the fused engine's."""
    eng = _port(weights[1], config, chunk=8, decode_block_size=2)
    assert _active_decode(eng) == want["active"]


@pytest.mark.parametrize("config", ["dense", "paged"])
def test_two_jobs_of_one_shape_swap_their_state(weights, want, config):
    """A second K=1 job at bucket 32 starts while the first is mid-way (the
    loop driven by hand): their chunk programs share one set of carried
    buffers, so each dispatch swaps the other job's state out; both streams
    equal the fused engine's."""
    eng = _port(weights[1], config, chunk=8)
    a = eng.submit(PROMPTS[1], max_new_tokens=8)
    eng._step()                    # admits a: chunks 1 and 2
    b = eng.submit(PROMPTS[2], max_new_tokens=8)
    eng._step()                    # admits b (its chunk 1), then a's 3rd
    while eng._inflight or eng._chunk_jobs or any(s.active
                                                  for s in eng.slots):
        eng._step()
    assert [a.result(timeout_s=1), b.result(timeout_s=1)] == want["fused"][1:3]
    assert eng.chunk_swaps >= 3 and eng.chunk_swap_bytes > 0


def test_chunk_size_must_divide_buckets(weights):
    with pytest.raises(ValueError, match="must divide"):
        LLMEngine(weights[1], CFG_T, n_slots=2, max_seq_len=64,
                  prefill_buckets=(8, 24), chunk_prefill_tokens=16,
                  device="cpu")


@pytest.mark.parametrize("config", ["dense", "paged"])
def test_chunked_stop_unblocks_mid_prefill_clients(weights, config):
    eng = _port(weights[1], config, chunk=8)
    eng.start()
    try:
        reqs = [eng.submit(list(range(1, 30)), max_new_tokens=4)
                for _ in range(3)]
    finally:
        eng.stop()
    for req in reqs:
        try:
            assert len(req.result(timeout_s=30)) <= 4
        except RuntimeError:
            pass                    # "engine stopped": no client hangs
    assert not eng._chunk_jobs
    assert all(s.chunking is None for s in eng.slots)
    if eng._paged:
        assert eng.allocator.used_pages == 0


_LEN = re.compile(r"-S\d+")


def _chunk_names(names):
    return sorted({_LEN.sub("", n) for n in names
                   if "-chunk" in n or "-prefill-" in n})


@pytest.mark.parametrize("config", ["dense", "paged", "dense-int8",
                                    "paged-int8"])
def test_warmup_program_names_match_jax(weights, config):
    """The chunk and admission programs the warm-up captures are the JAX
    executor's for the same engine arguments, the cache length aside; the
    fused program of a chunk-routed bucket is not among them."""
    jeng = _jax(weights[0], config, chunk=8)
    jeng.warmup(grow=True)
    eng = _port(weights[1], config, chunk=8)
    eng.warmup()
    got = _chunk_names(eng.executor.cache_info())
    assert got == _chunk_names(jeng.executor.cache_info())
    assert any("chunk" in n for n in got)
    assert not any("-prefill-32x" in n for n in got)


def test_prefix_hit_whose_tail_chunks_is_dropped(weights):
    """Paged, prefix cache on, chunk 8: a prompt whose tail past its cached
    pages would take bucket 32 drops the hit and is chunked whole; a short
    tail keeps its hit. Streams and the cache's counts equal JAX's."""
    prompts = [SYSTEM + [1, 2, 3], SYSTEM + list(range(100, 120)),
               SYSTEM + [7, 8]]
    got = {}
    for key, make in (("jax", lambda: _jax(weights[0], "paged", chunk=8,
                                           prefix_cache=True,
                                           prefill_buckets=(8, 32, 64))),
                      ("port", lambda: _port(weights[1], "paged", chunk=8,
                                             prefix_cache=True,
                                             prefill_buckets=(8, 32, 64)))):
        eng = make()
        streams = _generate(eng, prompts)
        got[key] = (streams, eng.prefix.stats())
    assert got["port"] == got["jax"]
    # the first two prompts chunked whole (the second's 2-page hit matched,
    # counted, and dropped); only the short tail admitted tail-only
    assert eng.chunk_jobs == 2 and eng.prefix_dispatches == 1
    assert got["port"][1]["hit_pages"] == 4


@pytest.mark.parametrize("config", ["dense", "paged", "dense-int8",
                                    "paged-int8"])
def test_chunk_graph_matches_eager(weights, config):
    eng = _port(weights[1], config, chunk=8)
    eng.executor = Executor("cpu", capture=graphcheck_stub)
    for final in (False, True):
        r = graphcheck.chunk_graph_vs_eager(eng, 2, 32, final,
                                            temperature=0.7)
        assert torch.equal(r["graph"], r["eager"])
        assert r["state_diff"] == 0.0 and r["garbage_diff"] == 0.0


def graphcheck_stub(fn, inputs):
    """A capture that records nothing: each call runs fn on the static
    inputs into the one output every call returns, as a graph replay."""
    out = []

    def replay():
        got = fn(*inputs)
        if out:
            out[0].copy_(got)
        else:
            out.append(got.clone())
        return out[0]
    return replay


def test_serve_builds_chunked_engines(weights, want):
    env = {"MODEL_PRESET": "debug", "MAX_BATCH": "4", "MAX_SEQ_LEN": "128",
           "PREFILL_BUCKETS": "8,32", "PAGE_SIZE": "16", "WARMUP": "true",
           "CHUNK_PREFILL_TOKENS": "8", "ATTN_IMPL": "xla"}
    for paged in ("true", "false"):
        eng = build_engine(dict(env, PAGED=paged), device="cpu",
                           params=weights[1])
        try:
            assert eng.chunk_prefill_tokens == 8
            assert eng.generate(PROMPTS[2], max_new_tokens=8) == \
                want["fused"][2]
            assert eng.chunk_jobs == 1
        finally:
            eng.stop()
    with pytest.raises(ValueError, match="must divide"):
        build_engine(dict(env, CHUNK_PREFILL_TOKENS="16", PREFILL_BUCKETS=
                          "8,24"), device="cpu", params=weights[1])
