"""Port int8 KV serving vs the JAX package: model steps and both engines.

Goldens are computed live (never hard-coded): JAX engines with
kv_dtype='int8' — the dense `LLMEngine` (decode_attn='kernel', the Pallas
decode kernel in interpret mode) and the `PagedLLMEngine` (the Pallas paged
kernel) — serve greedy streams on `llama_init(debug, seed=0)`, and the
port's engines must serve the same tokens on the bridged weights. The dense
cache starts at 16 and grows to 64 with its scales; the paged pools hold
int8 pages with f32 scale pages.
"""

import dataclasses

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
from gofr_tpu_torch.tpu.engine import LLMEngine
from gofr_tpu_torch.tpu.paging import PagedLLMEngine

CFG_J = dataclasses.replace(jl.LlamaConfig.debug(), decode_attn="kernel",
                            kv_dtype="int8")
CFG_T = dataclasses.replace(tl.LlamaConfig.debug(), decode_attn="kernel",
                            kv_dtype="int8")
DENSE = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16))
PAGED = dict(DENSE, page_size=8)
REQUESTS = [([5, 6, 7], 8), ([9, 10, 11, 12, 13, 14, 15, 16, 17], 8),
            ([1, 2], 8), (list(range(40, 54)), 20)]


class _QuietLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


def _streams(eng, concurrent):
    eng.start()
    try:
        if concurrent:
            reqs = [eng.submit(p, max_new_tokens=n, temperature=0.0)
                    for p, n in REQUESTS]
            return [r.result(timeout_s=300) for r in reqs]
        return [eng.generate(p, max_new_tokens=n, temperature=0.0)
                for p, n in REQUESTS]
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def served():
    """({"dense"/"paged": JAX goldens for REQUESTS}, JAX params, port
    params)."""
    jparams = jl.llama_init(jl.LlamaConfig.debug(), seed=0)
    goldens = {
        "dense": _streams(JEngine(jparams, CFG_J, logger=_QuietLogger(),
                                  **DENSE), True),
        "paged": _streams(JPaged(jparams, CFG_J, logger=_QuietLogger(),
                                 **PAGED), True),
    }
    return goldens, jparams, params_from_numpy(jax.device_get(jparams),
                                               device="cpu")


def _qcache(rng, shape):
    """An int8 cache and its scales, quantized by JAX from random f32."""
    k8, ks = jquantize(jnp.asarray(rng.standard_normal(shape,
                                                       dtype=np.float32)))
    return np.asarray(k8), np.asarray(ks)


def _assert_q8_caches_match(got8, want8, got_s, want_s):
    # the new token's int8 values may sit one step apart where its f32 K/V
    # differ by an ulp across a rounding boundary; scales to f32 precision
    assert np.abs(got8.astype(np.int32) - want8.astype(np.int32)).max() <= 1
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-8)


def test_decode_step_unrolled_q8_matches_jax(served):
    _, jparams, tparams = served
    L, B, Hkv, dh, S = CFG_J.n_layers, 3, CFG_J.n_kv_heads, CFG_J.head_dim, 32
    rng = np.random.default_rng(6)
    k8, ks = _qcache(rng, (L, B, Hkv, dh, S))
    v8, vs = _qcache(rng, (L, B, Hkv, dh, S))
    positions = np.array([9, 31, 20], dtype=np.int32)
    tokens = np.array([17, 300, 5], dtype=np.int32)
    want = jl.llama_decode_step_unrolled_q8(
        jparams, CFG_J, jnp.asarray(tokens), jnp.asarray(positions),
        *(tuple(jnp.asarray(a) for a in arr) for arr in (k8, v8, ks, vs)))
    bufs = [[torch.from_numpy(a.copy()) for a in arr]
            for arr in (k8, v8, ks, vs)]
    got = tl.llama_decode_step_unrolled_q8(
        tparams, CFG_T, torch.from_numpy(tokens).long(),
        torch.from_numpy(positions).long(), *bufs)
    assert all(g is b for g, b in zip(got[1:], bufs))     # in place
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4, rtol=1e-4)
    for l in range(L):
        for i in (0, 1):
            _assert_q8_caches_match(bufs[i][l].numpy(),
                                    np.asarray(want[1 + i][l]),
                                    bufs[2 + i][l].numpy(),
                                    np.asarray(want[3 + i][l]))


def test_decode_step_paged_q8_matches_jax(served):
    _, jparams, tparams = served
    L, Hkv, dh, P, ps = CFG_J.n_layers, CFG_J.n_kv_heads, CFG_J.head_dim, 12, 8
    rng = np.random.default_rng(7)
    k8, ks = _qcache(rng, (L, P, Hkv, dh, ps))
    v8, vs = _qcache(rng, (L, P, Hkv, dh, ps))
    # mid-page, the first token of a fresh page, and an inactive row whose
    # writes land on the garbage page 0
    table = np.array([[3, 4, 0, 0], [5, 6, 7, 0], [0, 0, 0, 0]],
                     dtype=np.int32)
    positions = np.array([10, 16, 2], dtype=np.int32)
    tokens = np.array([17, 300, 0], dtype=np.int32)
    want = jl.llama_decode_step_paged_q8(
        jparams, CFG_J, jnp.asarray(tokens), jnp.asarray(positions),
        *(jnp.asarray(a) for a in (k8, v8, ks, vs, table)))
    bufs = [torch.from_numpy(a.copy()) for a in (k8, v8, ks, vs)]
    got = tl.llama_decode_step_paged_q8(
        tparams, CFG_T, torch.from_numpy(tokens).long(),
        torch.from_numpy(positions).long(), *bufs, torch.from_numpy(table))
    np.testing.assert_allclose(got[0].numpy()[:2], np.asarray(want[0])[:2],
                               atol=1e-4, rtol=1e-4)
    for i in (0, 1):
        _assert_q8_caches_match(bufs[i].numpy(), np.asarray(want[1 + i]),
                                bufs[2 + i].numpy(), np.asarray(want[3 + i]))


@pytest.mark.parametrize("concurrent", [False, True])
def test_dense_int8_engine_matches_jax_and_grows_with_scales(served,
                                                             concurrent):
    goldens, _, tparams = served
    eng = LLMEngine(tparams, CFG_T, device="cpu", **DENSE)
    assert eng._cache_len == 16
    assert eng.k_cache[0].dtype == torch.int8
    assert _streams(eng, concurrent) == goldens["dense"]
    assert eng._cache_len == 64
    for bufs in (eng.k_cache, eng.v_cache, eng.k_scale, eng.v_scale):
        assert all(b.shape[-1] == 64 for b in bufs)
    assert eng.k_scale[0].dtype == torch.float32


@pytest.mark.parametrize("concurrent", [False, True])
def test_paged_int8_engine_matches_jax(served, concurrent):
    goldens, _, tparams = served
    eng = PagedLLMEngine(tparams, CFG_T, device="cpu", **PAGED)
    assert eng.k_cache.dtype == torch.int8
    assert tuple(eng.k_scale.shape) == tuple(eng.k_cache.shape[:3]) + (8,)
    assert _streams(eng, concurrent) == goldens["paged"]
    assert eng.allocator.used_pages == 0


def test_paged_int8_needs_no_kernel_decode_but_dense_does(served):
    """The reference's rule: int8 on the dense engine requires
    decode_attn='kernel'; the paged engine always reads through its
    kernel."""
    _, jparams, tparams = served
    xla_t = dataclasses.replace(CFG_T, decode_attn="xla")
    xla_j = dataclasses.replace(CFG_J, decode_attn="xla")
    with pytest.raises(ValueError, match="requires decode_attn"):
        JEngine(jparams, xla_j, logger=_QuietLogger(), **DENSE)
    with pytest.raises(ValueError, match="requires decode_attn"):
        LLMEngine(tparams, xla_t, device="cpu", **DENSE)
    assert PagedLLMEngine(tparams, xla_t, device="cpu", **PAGED)._q8
    with pytest.raises(ValueError, match="not supported"):
        LLMEngine(tparams, dataclasses.replace(CFG_T, kv_dtype="float16"),
                  device="cpu", **DENSE)
