"""Port decode reads and int8 KV helpers vs the JAX package on the CPU.

- ``quantize_kv`` must give the SAME int8 values and scales as JAX on the
  same f32 input (bit for bit);
- the port's plain ``decode_attention`` is held against the JAX Pallas
  kernel (interpret mode) and its reference on the same numpy caches, at
  the tolerances of ``tests/test_decode_attention.py``: 2e-5 in f32, 5e-2
  with int8 caches (the Pallas kernel rounds p to bf16 before p . v; the
  reference dequantizes in f32). Lengths include 0 (zeros on both sides)
  and one past S (clamped to S);
- ``paged_attention`` with int8 pools, the same way; the scale writers
  must leave scale pools EQUAL to JAX's.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jda = importlib.import_module("gofr_tpu.ops.decode_attention")
tda = importlib.import_module("gofr_tpu_torch.ops.decode_attention")
jpa = importlib.import_module("gofr_tpu.ops.paged_attention")
tpa = importlib.import_module("gofr_tpu_torch.ops.paged_attention")


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape,axis", [((3, 2, 16, 24), -2), ((4, 2, 16), -1),
                                        ((2, 3, 2, 8, 12), -2)])
def test_quantize_kv_is_bit_exact(shape, axis):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30, shape)
         ).astype(np.float32)
    want8, want_s = (np.asarray(a) for a in jda.quantize_kv(jnp.asarray(x),
                                                           axis=axis))
    got8, got_s = tda.quantize_kv(torch.from_numpy(x), axis=axis)
    assert got8.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got8.numpy(), want8)
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  want_s.view(np.int32))


def test_quantize_kv_rounds_half_to_even_and_clips():
    # amax 127 gives scale 1.0: halves round to even; a zero row keeps its
    # 1e-8 floor
    x = np.array([[127.0, 2.5, -3.5, 0.5, -0.5, 126.5],
                  [0.0] * 6], dtype=np.float32).T[None]     # [1, 6, 2]
    want8, want_s = (np.asarray(a) for a in jda.quantize_kv(jnp.asarray(x)))
    got8, got_s = tda.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(got8.numpy(), want8)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert got8[0, :, 0].tolist() == [127, 2, -4, 0, 0, 126]


def _dense_case(seed, B, H, Hkv, dh, S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, dh), dtype=np.float32),
            rng.standard_normal((B, Hkv, dh, S), dtype=np.float32),
            rng.standard_normal((B, Hkv, dh, S), dtype=np.float32))


@pytest.mark.parametrize("B,H,Hkv,dh,S,lengths,block_s", [
    (3, 8, 2, 16, 64, [5, 33, 64], 16),
    (3, 8, 2, 16, 64, [0, 7, 65], 64),       # length 0 and one past S
    (2, 4, 1, 8, 32, [10, 32], 32),          # MQA, one block
    (2, 4, 2, 16, 1024, [1000, 513], 512),   # two Pallas blocks
])
def test_decode_plain_matches_jax_kernel_and_reference(B, H, Hkv, dh, S,
                                                       lengths, block_s):
    q, k, v = _dense_case(0, B, H, Hkv, dh, S)
    lens = np.asarray(lengths, dtype=np.int32)
    got = tda.decode_attention(*_t(q, k, v, lens)).numpy()
    want_kernel = np.asarray(jda.decode_attention(*_j(q, k, v, lens),
                                                  block_s=block_s))
    want_ref = np.asarray(jda.decode_attention_reference(*_j(q, k, v, lens)))
    np.testing.assert_allclose(got, want_kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        tda.decode_attention_reference(*_t(q, k, v, lens)).numpy(), want_ref,
        rtol=2e-5, atol=2e-5)
    for b in np.flatnonzero(lens == 0):
        assert not got[b].any()


@pytest.mark.parametrize("lengths", [[5, 33, 64], [0, 1, 65]])
def test_decode_int8_plain_matches_jax_kernel_and_reference(lengths):
    B, H, Hkv, dh, S = 3, 8, 2, 16, 64
    q, k, v = _dense_case(3, B, H, Hkv, dh, S)
    k8, ks = (np.asarray(a) for a in jda.quantize_kv(jnp.asarray(k)))
    v8, vs = (np.asarray(a) for a in jda.quantize_kv(jnp.asarray(v)))
    lens = np.asarray(lengths, dtype=np.int32)
    got = tda.decode_attention(*_t(q, k8, v8, lens, ks, vs)).numpy()
    want_kernel = np.asarray(jda.decode_attention(
        *_j(q, k8, v8, lens, ks, vs)))
    want_ref = np.asarray(jda.decode_attention_reference(
        *_j(q, k8, v8, lens, ks, vs)))
    np.testing.assert_allclose(got, want_kernel, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(got, want_ref, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(
        tda.decode_attention_reference(*_t(q, k8, v8, lens, ks, vs)).numpy(),
        want_ref, rtol=2e-5, atol=2e-5)


def test_decode_attention_takes_both_scales_or_neither():
    q, k, v = _t(*_dense_case(1, 1, 2, 1, 8, 16))
    lens = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(ValueError, match="both"):
        tda.decode_attention(q, k, v, lens, torch.ones(1, 1, 16), None)


def _paged_q8_case(seed, B, H, Hkv, dh, ps, lengths):
    rng = np.random.default_rng(seed)
    need = [max(1, -(-n // ps)) for n in lengths]
    NP = max(need) + 1
    P = sum(need) + 3
    ids = rng.permutation(np.arange(1, P))[:sum(need)]
    table = np.zeros((B, NP), dtype=np.int32)
    off = 0
    for b, n in enumerate(need):
        table[b, :n] = ids[off:off + n]
        off += n
    q = rng.standard_normal((B, H, dh), dtype=np.float32)
    k = rng.standard_normal((P, Hkv, dh, ps), dtype=np.float32)
    v = rng.standard_normal((P, Hkv, dh, ps), dtype=np.float32)
    k8, ks = (np.asarray(a) for a in jda.quantize_kv(jnp.asarray(k)))
    v8, vs = (np.asarray(a) for a in jda.quantize_kv(jnp.asarray(v)))
    return q, k8, v8, table, np.asarray(lengths, dtype=np.int32), ks, vs


@pytest.mark.parametrize("B,H,Hkv,dh,ps,lengths", [
    (4, 8, 2, 32, 8, [1, 7, 8, 9]),
    (2, 8, 1, 32, 4, [13, 5]),
])
def test_paged_int8_plain_matches_jax_kernel_and_reference(B, H, Hkv, dh, ps,
                                                           lengths):
    args = _paged_q8_case(7, B, H, Hkv, dh, ps, lengths)
    got = tpa.paged_attention(*_t(*args)).numpy()
    want_kernel = np.asarray(jpa.paged_attention(*_j(*args)))
    want_ref = np.asarray(jpa.paged_attention_reference(*_j(*args)))
    np.testing.assert_allclose(got, want_kernel, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(got, want_ref, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(
        tpa.paged_attention_reference(*_t(*args)).numpy(), want_ref,
        rtol=2e-5, atol=2e-5)


def test_paged_write_prefill_scales_matches_jax():
    rng = np.random.default_rng(9)
    L, P, Hkv, ps, K, T = 2, 10, 2, 4, 3, 12
    pool = rng.standard_normal((L, P, Hkv, ps), dtype=np.float32)
    tmp = rng.standard_normal((L, K, Hkv, T), dtype=np.float32)
    table = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0]], dtype=np.int32)
    lengths = np.array([12, 6, 1], dtype=np.int32)
    want = np.asarray(jpa.paged_write_prefill_scales(*_j(pool, tmp, table,
                                                         lengths)))
    got = torch.from_numpy(pool.copy())
    out = tpa.paged_write_prefill_scales(got, *_t(tmp, table, lengths))
    assert out is got
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_write_decode_scales_matches_the_jax_rule():
    """JAX writes decode scales inline (llama_decode_step_paged_q8) with
    the value writer's indices; a position past the table clamps to its
    last (garbage) column."""
    rng = np.random.default_rng(4)
    pool = rng.standard_normal((9, 2, 8), dtype=np.float32)
    ks = rng.standard_normal((3, 2), dtype=np.float32)
    vs = rng.standard_normal((3, 2), dtype=np.float32)
    table = np.array([[3, 5, 0, 0], [7, 0, 0, 0], [0, 0, 0, 0]],
                     dtype=np.int32)
    positions = np.array([11, 40, 6], dtype=np.int32)
    jt, jp = jnp.asarray(table), jnp.asarray(positions)
    page_ids = jt[jnp.arange(3), jp // 8]
    want_k = jnp.asarray(pool).at[page_ids, :, jp % 8].set(jnp.asarray(ks))
    want_v = jnp.asarray(pool).at[page_ids, :, jp % 8].set(jnp.asarray(vs))
    tk, tv = torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())
    tpa.paged_write_decode_scales(tk, tv, *_t(ks, vs, table, positions))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(want_v))
