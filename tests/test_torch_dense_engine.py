"""Port dense-cache engine vs the JAX LLMEngine, and its model step.

Goldens are computed live (never hard-coded): a JAX `LLMEngine` serves
greedy streams on `llama_init(debug, seed=0)` with `decode_attn` "xla" (the
plain einsum read) and "kernel" (the Pallas decode kernel in interpret
mode), and the port's `LLMEngine` must serve the same tokens on the same
weights carried across by the weight bridge. Engine shape: 4 slots,
max_seq_len 64, buckets (8, 16); the cache starts at 16 and grows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jl
from gofr_tpu.tpu.engine import LLMEngine as JEngine
from gofr_tpu_torch.models import llama as tl
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.tpu.engine import LLMEngine

CFG_J = jl.LlamaConfig.debug()
CFG_T = tl.LlamaConfig.debug()
ENGINE = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16))
# (prompt, max_new): short and long prompts; the 14-token prompt with 20 new
# tokens makes the cache grow 16 -> 32 -> 64
REQUESTS = [([5, 6, 7], 8), ([9, 10, 11, 12, 13, 14, 15, 16, 17], 8),
            ([1, 2], 8), (list(range(40, 54)), 20)]
# a row that reaches the context cap (max_seq_len - 1) mid-block and keeps
# advancing past the cache's end while a later-finishing row decodes
PAST_S = [(list(range(100, 116)), 100), ([3, 1, 4], 60)]
DECODE_ATTN = ["xla", "kernel"]


class _QuietLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


def _jax_streams(jparams, cfg, requests, **engine):
    eng = JEngine(jparams, cfg, logger=_QuietLogger(), **engine)
    eng.start()
    try:
        reqs = [eng.submit(p, max_new_tokens=n, temperature=0.0)
                for p, n in requests]
        return [r.result(timeout_s=300) for r in reqs]
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def served():
    """{decode_attn: (goldens for REQUESTS, goldens for PAST_S)} and the
    same weights as port tensors."""
    jparams = jl.llama_init(CFG_J, seed=0)
    goldens = {}
    for attn in DECODE_ATTN:
        cfg = dataclasses.replace(CFG_J, decode_attn=attn)
        goldens[attn] = (_jax_streams(jparams, cfg, REQUESTS, **ENGINE),
                         _jax_streams(jparams, cfg, PAST_S, **ENGINE))
    return goldens, jparams, params_from_numpy(jax.device_get(jparams),
                                               device="cpu")


def _engine(tparams, attn, **kw):
    cfg = dataclasses.replace(CFG_T, decode_attn=attn)
    eng = LLMEngine(tparams, cfg, device="cpu", **{**ENGINE, **kw})
    eng.start()
    return eng


@pytest.mark.parametrize("attn", DECODE_ATTN)
def test_greedy_streams_match_jax_engine(served, attn):
    goldens, _, tparams = served
    eng = _engine(tparams, attn)
    try:
        got = [eng.generate(p, max_new_tokens=n, temperature=0.0)
               for p, n in REQUESTS]
    finally:
        eng.stop()
    assert got == goldens[attn][0]


@pytest.mark.parametrize("attn", DECODE_ATTN)
def test_concurrent_streams_match_jax_engine_and_grow_the_cache(served, attn):
    goldens, _, tparams = served
    eng = _engine(tparams, attn)
    try:
        assert eng._cache_len == 16
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in REQUESTS]
        assert [r.result(timeout_s=120) for r in reqs] == goldens[attn][0]
        assert eng._cache_len == 64
        assert all(k.shape[-1] == 64 for k in eng.k_cache + eng.v_cache)
        assert eng.k_scale is None
    finally:
        eng.stop()


@pytest.mark.parametrize("attn", DECODE_ATTN)
def test_row_past_the_cache_end_while_another_decodes(served, attn):
    """JAX's scatter drops a write past S and torch indexing would raise:
    the port writes it to the last column, which no emitted token reads."""
    goldens, _, tparams = served
    eng = _engine(tparams, attn)
    try:
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in PAST_S]
        got = [r.result(timeout_s=120) for r in reqs]
        assert got == goldens[attn][1]
        # the first row stopped at the context cap, the second at its budget
        assert len(got[0]) == ENGINE["max_seq_len"] - len(PAST_S[0][0])
        assert len(got[1]) == PAST_S[1][1]
        assert int(eng._positions.max()) > ENGINE["max_seq_len"]
    finally:
        eng.stop()


@pytest.mark.parametrize("attn", DECODE_ATTN)
def test_decode_step_unrolled_matches_jax(served, attn):
    _, jparams, tparams = served
    cj = dataclasses.replace(CFG_J, decode_attn=attn)
    ct = dataclasses.replace(CFG_T, decode_attn=attn)
    L, B, Hkv, dh, S = CFG_J.n_layers, 3, CFG_J.n_kv_heads, CFG_J.head_dim, 32
    rng = np.random.default_rng(5)
    k = rng.standard_normal((L, B, Hkv, dh, S), dtype=np.float32)
    v = rng.standard_normal((L, B, Hkv, dh, S), dtype=np.float32)
    # mid-cache, the last column, and a position past S (write dropped in
    # JAX, written to the last column here; both read all S columns)
    positions = np.array([9, 31, 40], dtype=np.int32)
    tokens = np.array([17, 300, 5], dtype=np.int32)
    jlog, jk, jv = jl.llama_decode_step_unrolled(
        jparams, cj, jnp.asarray(tokens), jnp.asarray(positions),
        tuple(jnp.asarray(a) for a in k), tuple(jnp.asarray(a) for a in v))
    tk = [torch.from_numpy(a.copy()) for a in k]
    tv = [torch.from_numpy(a.copy()) for a in v]
    tlog, tk2, _ = tl.llama_decode_step_unrolled(
        tparams, ct, torch.from_numpy(tokens).long(),
        torch.from_numpy(positions).long(), tk, tv)
    assert tk2 is tk
    np.testing.assert_allclose(tlog.numpy()[:2], np.asarray(jlog)[:2],
                               atol=1e-4, rtol=1e-4)
    for l in range(L):
        # rows 0 and 1 equal JAX's caches; row 2's write landed on the last
        # column instead of being dropped
        np.testing.assert_allclose(tk[l].numpy()[:2], np.asarray(jk[l])[:2],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tv[l].numpy()[:2], np.asarray(jv[l])[:2],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(tk[l].numpy()[2, ..., :-1],
                                      k[l, 2, ..., :-1])


def test_kernel_decode_rounds_max_seq_len_as_jax_does(served):
    """decode_attn='kernel' rounds a cap above 512 down to a multiple of
    512 (the admission limit users see); the plain read does not."""
    _, jparams, tparams = served
    for attn, cap, buckets in [("kernel", 1000, (8, 512)),
                               ("kernel", 1536, (8,)), ("kernel", 300, (8,)),
                               ("xla", 1000, (8,))]:
        cj = dataclasses.replace(CFG_J, max_seq_len=8192, decode_attn=attn)
        ct = dataclasses.replace(CFG_T, max_seq_len=8192, decode_attn=attn)
        want = JEngine(jparams, cj, n_slots=2, max_seq_len=cap,
                       prefill_buckets=buckets, logger=_QuietLogger())
        got = LLMEngine(tparams, ct, n_slots=2, max_seq_len=cap,
                        prefill_buckets=buckets, device="cpu")
        assert got.max_seq_len == want.max_seq_len
        assert got.prefill_buckets == want.prefill_buckets
        assert got.admission_limit == want.admission_limit
    assert got.max_seq_len == 1000


def test_kernel_rounding_cannot_strand_requests(served):
    _, _, tparams = served
    cfg = dataclasses.replace(CFG_T, max_seq_len=8192, decode_attn="kernel")
    with pytest.raises(ValueError, match="no prefill bucket"):
        LLMEngine(tparams, cfg, n_slots=2, max_seq_len=1000,
                  prefill_buckets=(768,), device="cpu")


def test_grow_cache_keeps_contents_and_caps_at_max_seq_len(served):
    _, _, tparams = served
    eng = LLMEngine(tparams, CFG_T, device="cpu", n_slots=2, max_seq_len=48,
                    prefill_buckets=(8, 16))
    assert eng._cache_len == 16
    for layer in eng.k_cache:
        layer.normal_()
    before = [k.clone() for k in eng.k_cache]
    eng._grow_cache(17)
    assert eng._cache_len == 32
    eng._grow_cache(40)                        # pow2 is 64, capped at 48
    assert eng._cache_len == 48
    for old, new in zip(before, eng.k_cache):
        assert new.shape[-1] == 48
        assert torch.equal(new[..., :16], old)
        assert not new[..., 16:].any()
    eng._grow_cache(20)                        # never shrinks
    assert eng._cache_len == 48
