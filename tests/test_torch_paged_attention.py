"""Port paged attention and page writes vs the JAX package on the CPU.

The port's plain `paged_attention` is held against the JAX Pallas kernel
(interpret mode) and its reference on the same numpy pools, tables and
lengths: lengths >= 1 (at 0 the JAX kernel and reference disagree by
design), table columns past the live pages hold 0, GQA. f32 tolerance 1e-5.
The writers must leave pools EQUAL to JAX's, garbage page 0 included.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jpa = importlib.import_module("gofr_tpu.ops.paged_attention")
tpa = importlib.import_module("gofr_tpu_torch.ops.paged_attention")


def _case(seed, B, H, Hkv, dh, ps, lengths, P=None):
    """q, pools and a table whose live pages are distinct random pages and
    whose tail columns are 0."""
    rng = np.random.default_rng(seed)
    need = [max(1, -(-n // ps)) for n in lengths]
    NP = max(need) + 1
    P = P or sum(need) + 3
    ids = rng.permutation(np.arange(1, P))[:sum(need)]
    table = np.zeros((B, NP), dtype=np.int32)
    off = 0
    for b, n in enumerate(need):
        table[b, :n] = ids[off:off + n]
        off += n
    return (rng.standard_normal((B, H, dh), dtype=np.float32),
            rng.standard_normal((P, Hkv, dh, ps), dtype=np.float32),
            rng.standard_normal((P, Hkv, dh, ps), dtype=np.float32),
            table, np.asarray(lengths, dtype=np.int32))


@pytest.mark.parametrize("B,H,Hkv,dh,ps,lengths", [
    (4, 8, 2, 32, 8, [1, 7, 8, 9]),          # ragged: 1, ps-1, ps, ps+1
    (3, 4, 4, 16, 16, [33, 16, 2]),          # MHA
    (2, 8, 1, 32, 4, [13, 5]),               # all heads on one kv head
])
def test_plain_matches_jax_kernel_and_reference(B, H, Hkv, dh, ps, lengths):
    q, kp, vp, table, lens = _case(11, B, H, Hkv, dh, ps, lengths)
    got = tpa.paged_attention(*(torch.from_numpy(a)
                                for a in (q, kp, vp, table, lens)))
    j_args = [jnp.asarray(a) for a in (q, kp, vp, table, lens)]
    want_kernel = np.asarray(jpa.paged_attention(*j_args))
    want_ref = np.asarray(jpa.paged_attention_reference(*j_args))
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tpa.paged_attention_reference(*(torch.from_numpy(a) for a in
                                        (q, kp, vp, table, lens))).numpy(),
        want_ref, atol=1e-5, rtol=1e-5)


def test_paged_write_decode_matches_jax():
    rng = np.random.default_rng(3)
    L_pool = rng.standard_normal((9, 2, 16, 8), dtype=np.float32)
    k = rng.standard_normal((3, 2, 16), dtype=np.float32)
    v = rng.standard_normal((3, 2, 16), dtype=np.float32)
    # row 2 is inactive (all-zero table row) and writes to garbage page 0;
    # row 1's position runs past its pages and clamps to the last column
    table = np.array([[3, 5, 0, 0], [7, 0, 0, 0], [0, 0, 0, 0]],
                     dtype=np.int32)
    positions = np.array([11, 40, 6], dtype=np.int32)
    jk, jv = jpa.paged_write_decode(jnp.asarray(L_pool), jnp.asarray(L_pool),
                                    jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(table), jnp.asarray(positions))
    tk, tv = torch.from_numpy(L_pool.copy()), torch.from_numpy(L_pool.copy())
    out = tpa.paged_write_decode(tk, tv, torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(table),
                                 torch.from_numpy(positions))
    assert out[0] is tk and out[1] is tv          # updated in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_paged_write_prefill_stacked_matches_jax():
    """Pads past each row's length divert to the garbage page; live pages
    get exactly the window; the whole pool — page 0 too — equals JAX's."""
    rng = np.random.default_rng(5)
    L, P, Hkv, dh, ps, K, T = 2, 10, 2, 8, 4, 3, 12
    pool = rng.standard_normal((L, P, Hkv, dh, ps), dtype=np.float32)
    tmp_k = rng.standard_normal((L, K, Hkv, dh, T), dtype=np.float32)
    tmp_v = rng.standard_normal((L, K, Hkv, dh, T), dtype=np.float32)
    table = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0]], dtype=np.int32)
    lengths = np.array([12, 6, 1], dtype=np.int32)
    jk, jv = jpa.paged_write_prefill_stacked(
        jnp.asarray(pool), jnp.asarray(pool), jnp.asarray(tmp_k),
        jnp.asarray(tmp_v), jnp.asarray(table), jnp.asarray(lengths))
    tk, tv = torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())
    tpa.paged_write_prefill_stacked(tk, tv, torch.from_numpy(tmp_k),
                                    torch.from_numpy(tmp_v),
                                    torch.from_numpy(table),
                                    torch.from_numpy(lengths))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # page 7..9 were never in the table: untouched
    np.testing.assert_array_equal(tk.numpy()[:, 7:], pool[:, 7:])
    # row 1's live tokens 0..5 landed on pages 4 (0..3) and 5 (4..5)
    np.testing.assert_array_equal(tk.numpy()[:, 5, :, :, :2],
                                  tmp_k[:, 1, :, :, 4:6])


def test_prefill_scatter_indices_match_jax():
    table = np.array([[1, 2], [3, 0]], dtype=np.int32)
    lengths = np.array([7, 3], dtype=np.int32)
    jp, jo = jpa._prefill_scatter_indices(jnp.asarray(table),
                                          jnp.asarray(lengths), 8, 4)
    tp, to = tpa._prefill_scatter_indices(torch.from_numpy(table),
                                          torch.from_numpy(lengths), 8, 4)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
