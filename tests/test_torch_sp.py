"""The port's sequence parallelism against the reference's, in one 8-rank
gloo world (tests/torch_dist.py).

Twins of tests/test_parallel.py's ring and Ulysses tests and its
sequence-parallel forward: ring attention (ops/ring_attention.py) and
Ulysses (ops/ulysses.py) at sp=8 against plain causal GQA attention, in
value and in the gradient of sum(out ** 2) w.r.t. q, k and v (the
reference's tests check the gradient finite and non-zero; here each rank's
chunk of it is held to jax.grad of the oracle), Ulysses against ring at
sp=4 x dp=2, the ValueErrors for heads and sequences sp does not divide,
and parallel/longcontext.sp_llama_forward with ring and with Ulysses at
dp=2 x sp=4 against the JAX package's llama_forward_nocache on the same
weights (rtol and atol 2e-4, as the reference). The test process computes
the JAX side; the workers import only the port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gofr_tpu.models.llama import LlamaConfig as JConfig
from gofr_tpu.models.llama import llama_forward_nocache, llama_init
from gofr_tpu_torch.models.llama import LlamaConfig

import torch_dist
import torch_dist_workers as workers

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(seed, B, T, H, Hkv, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((B, T, H, dh), (B, T, Hkv, dh),
                               (B, T, Hkv, dh)))


def _full_attention(q, k, v):
    """Plain causal GQA attention (the reference tests' oracle)."""
    B, T, H, dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, H // Hkv, dh)
    scores = jnp.einsum("bthgd,bshd->bhgts", qg, k) / math.sqrt(dh)
    causal = jnp.tril(jnp.ones((T, T), dtype=bool))
    scores = jnp.where(causal[None, None, None], scores, -jnp.inf)
    probs = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("bhgts,bshd->bthgd", probs, v).reshape(B, T, H, dh)


def _oracle(q, k, v):
    """(out, grads of sum(out ** 2)) of the oracle, as numpy."""
    out = _full_attention(q, k, v)
    grads = jax.grad(lambda *a: jnp.sum(_full_attention(*a) ** 2),
                     argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _chunk(x, rank, n, dim=1):
    size = x.shape[dim] // n
    return np.take(x, range(rank * size, (rank + 1) * size), axis=dim)


CFG = LlamaConfig.debug()


@pytest.fixture(scope="module")
def world():
    data = {"ring": _qkv(0, 2, 32, 4, 2, 16),
            "ring_grad": _qkv(1, 1, 16, 2, 2, 8),
            # GQA: Hkv=4 < sp=8 -> the repeat path
            "ulysses": _qkv(0, 2, 32, 8, 4, 16),
            "ulysses_grad": _qkv(1, 1, 16, 8, 8, 8),
            "vs_ring": _qkv(3, 1, 64, 8, 8, 8),
            "tokens": np.random.default_rng(7).integers(
                0, CFG.vocab_size, (2, 32)).astype(np.int32)}
    jparams = llama_init(JConfig.debug(), seed=0)
    results = torch_dist.run_world(workers.sp_suite, 8, data,
                                   jax.device_get(jparams), CFG, timeout=240)
    return data, jparams, results


def _held(world, key, rank_key="rank8", n=8, grads=True):
    data, _, results = world
    out, grads_want = _oracle(*data[key])
    for r in results:
        got, got_grads = r[key]
        rank = r[rank_key]
        np.testing.assert_allclose(got, _chunk(out, rank, n), **TOL)
        if grads:
            for g, want in zip(got_grads, grads_want):
                np.testing.assert_allclose(g, _chunk(want, rank, n),
                                           **GRAD_TOL)
    return results


def test_ring_attention_matches_full_attention(world):
    _held(world, "ring", grads=False)


def test_ring_attention_differentiable(world):
    results = _held(world, "ring_grad")
    assert all(np.isfinite(g).all() for r in results
               for g in r["ring_grad"][1])
    assert sum(np.abs(r["ring_grad"][1][0]).sum() for r in results) > 0


def test_ulysses_attention_matches_full_attention(world):
    _held(world, "ulysses", grads=False)


def test_ulysses_matches_ring(world):
    for r in world[2]:
        ulysses, ring = r["vs_ring"]
        np.testing.assert_allclose(ulysses, ring, **TOL)


def test_ulysses_differentiable(world):
    results = _held(world, "ulysses_grad")
    assert sum(np.abs(r["ulysses_grad"][1][0]).sum() for r in results) > 0


def test_ulysses_rejects_indivisible_heads(world):
    assert all("divide" in r["heads_refused"] for r in world[2])


def test_sp_llama_forward_matches_dense(world):
    data, jparams, results = world
    expected = np.asarray(llama_forward_nocache(jparams, JConfig.debug(),
                                                jnp.asarray(data["tokens"])))
    for r in results:
        c = r["coords"]
        for attn, got in r["sp_forward"].items():
            b, t = got.shape[:2]
            want = expected[c["dp"] * b:(c["dp"] + 1) * b,
                            c["sp"] * t:(c["sp"] + 1) * t]
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4,
                                       err_msg=attn)


def test_sp_llama_forward_rejects_indivisible_seq(world):
    assert all("divide" in r["seq_refused"] for r in world[2])
