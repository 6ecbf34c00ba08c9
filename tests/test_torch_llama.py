"""Port Llama math vs the JAX package on the CPU, on the same weights.

The JAX `llama_init` tree is carried across with the port's weight bridge
(`params_from_numpy`); the same numpy tokens go through both sides. Logits
at f32 must agree within 1e-4 (debug preset, 2 layers; differences are
summation order only), and the caches / pools the two sides write must
agree within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jl
from gofr_tpu_torch.models import llama as tl
from gofr_tpu_torch.models.weights import params_from_numpy

CFG_J = jl.LlamaConfig.debug()
CFG_T = tl.LlamaConfig.debug()


@pytest.fixture(scope="module")
def weights():
    jparams = jl.llama_init(CFG_J, seed=0)
    return jparams, params_from_numpy(jax.device_get(jparams), device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_bridge_round_trips(dtype):
    cfg = dataclasses.replace(CFG_J, dtype=dtype)
    host = jax.device_get(jl.llama_init(cfg, seed=1))
    tree = params_from_numpy(host, device="cpu")
    got = dict(_leaves(tree))
    for name, leaf in _leaves(host):
        t = got[name]
        assert tuple(t.shape) == leaf.shape, name
        assert t.dtype == getattr(torch, dtype), name
        if dtype == "bfloat16":   # bit-exact payload
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          np.asarray(leaf).view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_port_init_follows_the_recipe():
    params = tl.llama_init(CFG_T, seed=0, device="cpu")
    assert torch.equal(params["layers"]["attn_norm"],
                       torch.ones(CFG_T.n_layers, CFG_T.dim))
    std = float(params["layers"]["w_gate"].std())
    assert abs(std - CFG_T.dim ** -0.5) < 0.01
    again = tl.llama_init(CFG_T, seed=0, device="cpu")
    assert torch.equal(params["lm_head"], again["lm_head"])


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_prefill_last_matches_jax(weights, attn_impl):
    jparams, tparams = weights
    cj = dataclasses.replace(CFG_J, attn_impl=attn_impl)
    ct = dataclasses.replace(CFG_T, attn_impl=attn_impl)
    K, T = 3, 16
    L, Hkv, dh = CFG_J.n_layers, CFG_J.n_kv_heads, CFG_J.head_dim
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG_J.vocab_size, (K, T)).astype(np.int32)
    lengths = np.array([16, 9, 1], dtype=np.int32)
    positions = np.tile(np.arange(T, dtype=np.int32), (K, 1))
    zeros = np.zeros((L, K, Hkv, dh, T), dtype=np.float32)
    jl_, jk, jv = jl.llama_prefill_last(
        jparams, cj, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(lengths), jnp.asarray(zeros), jnp.asarray(zeros))
    tk, tv = torch.zeros(zeros.shape), torch.zeros(zeros.shape)
    tl_, tk2, _ = tl.llama_prefill_last(
        tparams, ct, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(lengths), tk, tv)
    assert tk2 is tk                                  # written in place
    assert tl_.dtype == torch.float32
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                               rtol=1e-5)


def test_decode_step_paged_matches_jax(weights):
    jparams, tparams = weights
    L, Hkv, dh = CFG_J.n_layers, CFG_J.n_kv_heads, CFG_J.head_dim
    P, ps = 12, 8
    rng = np.random.default_rng(1)
    pool_k = rng.standard_normal((L, P, Hkv, dh, ps), dtype=np.float32)
    pool_v = rng.standard_normal((L, P, Hkv, dh, ps), dtype=np.float32)
    # rows: mid-page, first token of a fresh page, and an inactive row
    table = np.array([[3, 4, 0, 0], [5, 6, 7, 0], [0, 0, 0, 0]],
                     dtype=np.int32)
    positions = np.array([10, 16, 2], dtype=np.int32)
    tokens = np.array([17, 300, 0], dtype=np.int32)
    jlog, jk, jv = jl.llama_decode_step_paged(
        jparams, CFG_J, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(table))
    tk = torch.from_numpy(pool_k.copy())
    tv = torch.from_numpy(pool_v.copy())
    tlog, _, _ = tl.llama_decode_step_paged(
        tparams, CFG_T, torch.from_numpy(tokens).long(),
        torch.from_numpy(positions).long(), tk, tv, torch.from_numpy(table))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                               rtol=1e-5)


def test_norm_and_rope_keep_the_input_dtype():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 16), dtype=np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    want = jl.rope(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos),
                   CFG_J.rope_theta)
    got = tl.rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos),
                  CFG_T.rope_theta)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    w = rng.standard_normal((16,), dtype=np.float32)
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
