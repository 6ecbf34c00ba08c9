"""The decode reads' split-and-combine, in plain PyTorch, vs the JAX package
on the CPU; and the wrapper's split planner.

The CUDA kernels of ``csrc/decode_split.cuh`` cut each row's context into
units that they deal round-robin to several blocks, which read in parallel
and then merge their (m, l, acc). ``decode_read_split_plain`` is that
arithmetic in PyTorch. It is held against ``decode_attention_plain`` and
against the JAX ``decode_attention`` / ``paged_attention`` (Pallas in
interpret mode, as their own tests run them) and their references, on
numpy inputs from a seed: B=3, H=8, Hkv=2, dh=64, units of 16 and 32
tokens over 2 or 3 blocks, lengths 0, 1, at a unit boundary, one past it,
one past the first round of units and the full capacity (so some blocks
start past their row's length). Tolerances: 1e-5 in f32 (sums in another
order); in bf16, 1e-2 * |want| + 1e-2 * rms(want) per element (both sides
round the output to bf16, and the plain versions and the Pallas kernels
also round p to bf16 where the split keeps it in f32). The int8 reads take
int8 K/V and f32 per-token scales from ``quantize_kv`` of the same seeded
normals, the same values handed to both packages, and are held the same
way: to 1e-5 in f32 against the references (which dequantize first), and
to the bf16 tolerance against the Pallas kernels and the plain version.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jda = importlib.import_module("gofr_tpu.ops.decode_attention")
jpa = importlib.import_module("gofr_tpu.ops.paged_attention")
tda = importlib.import_module("gofr_tpu_torch.ops.decode_attention")
tpa = importlib.import_module("gofr_tpu_torch.ops.paged_attention")

B, H, HKV, DH, S = 3, 8, 2, 64, 64


def _lengths(nsplit, unit, case):
    return {"short": [0, 1, S],
            "boundary": [unit, unit + 1, nsplit * unit + 1]}[case]


def _dense(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, DH), dtype=np.float32),
            rng.standard_normal((B, HKV, DH, S), dtype=np.float32),
            rng.standard_normal((B, HKV, DH, S), dtype=np.float32))


def _close_bf16(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    rms = float(np.sqrt(np.mean(want ** 2)))
    assert np.all(np.abs(got - want) <= 1e-2 * np.abs(want) + 1e-2 * rms)


SPLITS = [(2, 16), (3, 16), (2, 32)]      # (nsplit, unit)


@pytest.mark.parametrize("case", ["short", "boundary"])
@pytest.mark.parametrize("nsplit,unit", SPLITS)
def test_split_plain_matches_dense_plain_and_jax_f32(nsplit, unit, case):
    q, k, v = _dense(nsplit * unit)
    lens = np.asarray(_lengths(nsplit, unit, case), dtype=np.int32)
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lens))
    got = tda.decode_read_split_plain(tq, tk, tv, tl, nsplit, unit,
                                      tile=16).numpy()
    j = [jnp.asarray(a) for a in (q, k, v, lens)]
    np.testing.assert_allclose(
        got, tda.decode_attention_plain(tq, tk, tv, tl).numpy(),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jda.decode_attention(*j)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jda.decode_attention_reference(*j)),
        rtol=1e-5, atol=1e-5)
    for b in np.flatnonzero(lens == 0):
        assert not got[b].any()


@pytest.mark.parametrize("case", ["short", "boundary"])
@pytest.mark.parametrize("nsplit,unit", SPLITS)
def test_split_plain_matches_dense_plain_and_jax_bf16(nsplit, unit, case):
    q, k, v = _dense(nsplit * unit + 1)
    lens = np.asarray(_lengths(nsplit, unit, case), dtype=np.int32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tl = torch.from_numpy(lens)
    got = tda.decode_read_split_plain(tq, tk, tv, tl, nsplit, unit, tile=16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    _close_bf16(got, tda.decode_attention_plain(tq, tk, tv, tl).float())
    _close_bf16(got, jda.decode_attention(*j, jnp.asarray(lens)))
    for b in np.flatnonzero(lens == 0):
        assert not got[b].any()


def _paged(seed, ps, lengths):
    """q, pools and a table of distinct live pages with zero tails, NP * ps
    = S tokens of capacity."""
    rng = np.random.default_rng(seed)
    NP = S // ps
    P = B * NP + 1
    table = np.zeros((B, NP), dtype=np.int32)
    ids = rng.permutation(np.arange(1, P))
    for b, n in enumerate(lengths):
        need = -(-n // ps)
        table[b, :need] = ids[b * NP:b * NP + need]
    return (rng.standard_normal((B, H, DH), dtype=np.float32),
            rng.standard_normal((P, HKV, DH, ps), dtype=np.float32),
            rng.standard_normal((P, HKV, DH, ps), dtype=np.float32),
            table, np.asarray(lengths, dtype=np.int32))


@pytest.mark.parametrize("case", ["short", "boundary"])
@pytest.mark.parametrize("ps,nsplit,unit", [(8, 2, 16), (16, 3, 16),
                                            (16, 2, 32)])
def test_split_plain_over_pages_matches_jax_paged(ps, nsplit, unit, case):
    """A paged unit is a whole number of pages: the split read of the
    gathered pages against the JAX paged kernel (zeros at length 0) and,
    for rows of length >= 1, its reference."""
    args = _paged(ps + unit, ps, _lengths(nsplit, unit, case))
    q, kp, vp, table, lens = (torch.from_numpy(a) for a in args)
    got = tda.decode_read_split_plain(q, tpa._gather_pages(kp, table),
                                      tpa._gather_pages(vp, table), lens,
                                      nsplit, unit, tile=8).numpy()
    j = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(got, np.asarray(jpa.paged_attention(*j)),
                               rtol=1e-5, atol=1e-5)
    live = args[-1] > 0
    np.testing.assert_allclose(
        got[live], np.asarray(jpa.paged_attention_reference(*j))[live],
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, tpa.paged_attention_plain(q, kp, vp, table, lens).numpy(),
        rtol=1e-5, atol=1e-5)


def _q8(*arrays):
    """(int8 values, f32 scales) as numpy, per array: quantize_kv of the
    seeded normals (bit-identical to JAX's)."""
    out = []
    for a in arrays:
        q8, sc = tda.quantize_kv(torch.from_numpy(a))
        out += [q8.numpy(), sc.numpy()]
    return out


@pytest.mark.parametrize("case", ["short", "boundary"])
@pytest.mark.parametrize("nsplit,unit", SPLITS)
def test_split_plain_q8_matches_references_f32(nsplit, unit, case):
    """int8 K/V with per-token scales, f32 q: the split read against both
    packages' references, which dequantize before the product."""
    q, k, v = _dense(nsplit * unit + 2)
    k8, ks, v8, vs = _q8(k, v)
    lens = np.asarray(_lengths(nsplit, unit, case), dtype=np.int32)
    tq, tk, tv, tks, tvs, tl = (torch.from_numpy(a)
                                for a in (q, k8, v8, ks, vs, lens))
    got = tda.decode_read_split_plain(tq, tk, tv, tl, nsplit, unit, tile=16,
                                      k_scale=tks, v_scale=tvs).numpy()
    np.testing.assert_allclose(
        got, tda.decode_attention_reference(tq, tk, tv, tl, tks,
                                            tvs).numpy(),
        rtol=1e-5, atol=1e-5)
    j = [jnp.asarray(a) for a in (q, k8, v8, lens)]
    np.testing.assert_allclose(
        got, np.asarray(jda.decode_attention_reference(
            *j, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))),
        rtol=1e-5, atol=1e-5)
    for b in np.flatnonzero(lens == 0):
        assert not got[b].any()


@pytest.mark.parametrize("case", ["short", "boundary"])
@pytest.mark.parametrize("nsplit,unit", SPLITS)
def test_split_plain_q8_matches_pallas_and_plain_bf16(nsplit, unit, case):
    """bf16 q over int8 K/V: the split read (p in f32) against the JAX
    Pallas kernel in interpret mode and the port's plain version, both of
    which round p to bf16."""
    q, k, v = _dense(nsplit * unit + 3)
    k8, ks, v8, vs = _q8(k, v)
    lens = np.asarray(_lengths(nsplit, unit, case), dtype=np.int32)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tk, tv, tks, tvs, tl = (torch.from_numpy(a)
                            for a in (k8, v8, ks, vs, lens))
    got = tda.decode_read_split_plain(tq, tk, tv, tl, nsplit, unit, tile=16,
                                      k_scale=tks, v_scale=tvs)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    _close_bf16(got, tda.decode_attention_plain(tq, tk, tv, tl, tks,
                                                tvs).float())
    _close_bf16(got, jda.decode_attention(
        jnp.asarray(q).astype(jnp.bfloat16), *(jnp.asarray(a) for a in
                                               (k8, v8, lens)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    for b in np.flatnonzero(lens == 0):
        assert not got[b].any()


@pytest.mark.parametrize("case", ["short", "boundary"])
@pytest.mark.parametrize("ps,nsplit,unit", [(8, 2, 16), (16, 3, 16),
                                            (16, 2, 32)])
def test_split_plain_q8_over_pages_matches_jax_paged(ps, nsplit, unit, case):
    """int8 pools with [P, Hkv, ps] scale pools: the split read of the
    gathered pages and scale pages against the JAX paged reference (f32,
    rows of length >= 1) and the JAX paged kernel and the port's plain
    version (bf16 q)."""
    q, kp, vp, table, lens = _paged(ps + unit + 1, ps,
                                    _lengths(nsplit, unit, case))
    k8, ks, v8, vs = _q8(kp, vp)
    t = {n: torch.from_numpy(a) for n, a in dict(
        q=q, k8=k8, v8=v8, ks=ks, vs=vs, table=table, lens=lens).items()}

    def split(tq):
        gather = [tpa._gather_pages(t[n], t["table"])
                  for n in ("k8", "v8", "ks", "vs")]
        return tda.decode_read_split_plain(
            tq, gather[0], gather[1], t["lens"], nsplit, unit, tile=8,
            k_scale=gather[2], v_scale=gather[3])

    j = {n: jnp.asarray(a) for n, a in dict(
        k8=k8, v8=v8, ks=ks, vs=vs, table=table, lens=lens).items()}
    live = lens > 0
    want = jpa.paged_attention_reference(
        jnp.asarray(q), j["k8"], j["v8"], j["table"], j["lens"],
        k_scale=j["ks"], v_scale=j["vs"])
    got = split(t["q"]).numpy()
    np.testing.assert_allclose(got[live], np.asarray(want)[live],
                               rtol=1e-5, atol=1e-5)
    tq = t["q"].to(torch.bfloat16)
    got = split(tq).float().numpy()
    _close_bf16(got, jpa.paged_attention(
        jnp.asarray(q).astype(jnp.bfloat16), j["k8"], j["v8"], j["table"],
        j["lens"], k_scale=j["ks"], v_scale=j["vs"]))
    _close_bf16(got, tpa.paged_attention_plain(
        tq, t["k8"], t["v8"], t["table"], t["lens"], t["ks"],
        t["vs"]).float())
    for b in np.flatnonzero(~live):
        assert not got[b].any()


PLANS = [(8, 8, 512, None), (8, 8, 8192, None), (1, 8, 8192, None),
         (8, 8, 1000, None), (8, 8, 1001, None), (3, 2, 64, None),
         (1, 1, 32768, None), (8, 8, 512, 128), (8, 8, 16384, 128),
         (1, 8, 16384, 16), (4, 8, 1024, 16), (2, 4, 300, 100)]


@pytest.mark.parametrize("B_,Hkv,cap,ps", PLANS)
def test_plan_split_units_cover_the_capacity(B_, Hkv, cap, ps):
    """Units are whole tiles and whole pages; every unit of the capacity
    goes to one block, and every block has at least one unit."""
    nsplit, unit = tda.plan_split(B_, Hkv, cap, ps)
    units = -(-cap // unit)
    assert 1 <= nsplit <= min(tda.SPLIT_MAX, units)
    assert unit % tda.SPLIT_TILE == 0
    assert ps is None or unit % ps == 0          # whole pages
    dealt = sorted(u for s in range(nsplit) for u in range(s, units, nsplit))
    assert dealt == list(range(units))


@pytest.mark.parametrize("B_,Hkv,ps", [(8, 8, None), (1, 8, None),
                                        (4, 8, 128), (1, 8, 16),
                                        (2, 2, None)])
def test_plan_split_reaches_about_two_waves(B_, Hkv, ps):
    """With capacity to spare, B * Hkv * nsplit is about two waves of 132
    blocks, and no more than four."""
    nsplit, _ = tda.plan_split(B_, Hkv, 8192, ps, sms=132)
    blocks = B_ * Hkv * nsplit
    assert 0.9 * 2 * 132 <= blocks <= 4 * 132


@pytest.mark.parametrize("cap,ps", [(1, None), (64, None), (16, 16),
                                    (128, 128), (64, 8)])
def test_plan_split_one_block_for_one_unit_of_capacity(cap, ps):
    assert tda.plan_split(8, 8, cap, ps) == (1, max(64, ps or 0))


@pytest.mark.parametrize("B_,Hkv,cap,ps", PLANS)
def test_plan_split_int8_units_are_whole_128_token_tiles(B_, Hkv, cap, ps):
    """The int8 reads' tiles are 128 tokens: units are whole int8 tiles and
    whole pages, every unit goes to one block and every block has one."""
    nsplit, unit = tda.plan_split(B_, Hkv, cap, ps, tile=tda.SPLIT_TILE_Q8)
    units = -(-cap // unit)
    assert 1 <= nsplit <= min(tda.SPLIT_MAX, units)
    assert unit % tda.SPLIT_TILE_Q8 == 0
    assert ps is None or unit % ps == 0
    assert unit == (tda.SPLIT_TILE_Q8 if ps is None
                    else math.lcm(tda.SPLIT_TILE_Q8, ps))
    dealt = sorted(u for s in range(nsplit) for u in range(s, units, nsplit))
    assert dealt == list(range(units))


def test_plan_split_served_shapes():
    """The served shapes (B=8 slots, Hkv=8): a dense S=512 cache is 8
    tiles over 5 blocks, a 4-page ps=128 table 4 pages over 4 blocks; in
    int8 both are 4 tiles of 128 tokens over 4 blocks."""
    assert tda.plan_split(8, 8, 512, None) == (5, 64)
    assert tda.plan_split(8, 8, 4 * 128, 128) == (4, 128)
    q8 = tda.SPLIT_TILE_Q8
    assert tda.plan_split(8, 8, 512, None, tile=q8) == (4, 128)
    assert tda.plan_split(8, 8, 4 * 128, 128, tile=q8) == (4, 128)
