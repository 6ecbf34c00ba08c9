"""The port's CUDA kernels on the card, against their plain versions.

Marked `cuda`: each test skips without a card (decided inside the test, so
every worker collects the same tests). On a machine with one:
``python -m pytest tests/test_torch_cuda_kernels.py -q``. Tolerance per
element: RTOL * |want| + ATOL_RMS * rms(want). Both sides are bf16 roundings
of f32 results, which may sit one bf16 ulp (at most 2**-7 of the value)
apart; the floor for outputs near 0 scales with the case's own outputs.
"""

import dataclasses

import pytest
import torch

from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
from gofr_tpu_torch.ops.decode_attention import (SPLIT_TILE, SPLIT_TILE_Q8,
                                                 decode_attention,
                                                 decode_attention_cuda,
                                                 decode_attention_plain,
                                                 decode_attention_q8_cuda,
                                                 plan_split, quantize_kv)
from gofr_tpu_torch.ops.flash_attention import (KERNEL_BLOCK_KV,
                                                flash_attention,
                                                flash_attention_cuda,
                                                flash_attention_plain)
from gofr_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                paged_attention_plain,
                                                paged_attention_q8_cuda,
                                                paged_attention_reference)
from gofr_tpu_torch.tpu.engine import LLMEngine
from gofr_tpu_torch.tpu.paging import PagedLLMEngine

pytestmark = pytest.mark.cuda
RTOL = 1e-2
ATOL_RMS = 1e-2


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_agrees(got, want):
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    rms = float(w.square().mean().sqrt())
    excess = (g - w).abs() - (ATOL_RMS * rms + RTOL * w.abs())
    assert float(excess.max()) <= 0.0


def _randn(gen, dev, *shape):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("T,S,dh,causal,heads", [
    (64, 64, 128, True, (2, 8, 2)),
    (77, 77, 64, True, (2, 8, 2)),
    (200, 130, 128, False, (2, 8, 2)),
    (1, 300, 64, False, (2, 8, 2)),
    # one and two kv tiles: the score -> A fragment repack of p
    (16, 16, 128, True, (2, 8, 2)),
    (80, 80, 128, True, (2, 8, 2)),
    (1, 1, 128, True, (2, 8, 2)),
    # a ragged kv tail that must give p = 0, at both head dims
    (200, 333, 64, False, (2, 8, 2)),
    (200, 333, 128, False, (2, 8, 2)),
    # the served [4, 256] window at Llama-3-8B's heads
    (256, 256, 128, True, (4, 32, 8)),
])
def test_flash_kernel_matches_plain(cuda, T, S, dh, causal, heads):
    B, H, Hkv = heads
    gen = torch.Generator(device=cuda).manual_seed(T)
    q = _randn(gen, cuda, B, H, T, dh)
    k, v = _randn(gen, cuda, B, Hkv, S, dh), _randn(gen, cuda, B, Hkv, S, dh)
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, causal)
    assert flash_attention_cuda.launches == before + 1
    want = flash_attention_plain(q, k, v, causal, KERNEL_BLOCK_KV)
    _assert_agrees(got, want)


def test_flash_dispatch_uses_the_kernel_on_cuda(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (_randn(gen, cuda, 1, 50, 4, 64) for _ in range(3))
    before = flash_attention_cuda.launches
    out = flash_attention(q, k, v, True)
    assert flash_attention_cuda.launches == before + 1
    assert out.shape == q.shape
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), v.float(), True)


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_reads_and_writes_the_model_layout_in_place(cuda, dh):
    """[B, T, H, dh] in, one launch, a contiguous [B, T, H, dh] out that
    equals the kernel's result on contiguous [B, H, T, dh] copies."""
    gen = torch.Generator(device=cuda).manual_seed(dh)
    q = _randn(gen, cuda, 2, 130, 8, dh)
    k, v = _randn(gen, cuda, 2, 130, 2, dh), _randn(gen, cuda, 2, 130, 2, dh)
    before = flash_attention_cuda.launches
    out = flash_attention(q, k, v, True)
    assert flash_attention_cuda.launches == before + 1
    assert out.shape == q.shape and out.is_contiguous()
    want = flash_attention_cuda(*(t.transpose(1, 2).contiguous()
                                  for t in (q, k, v)), True)
    assert torch.equal(out, want.transpose(1, 2))
    ragged = _randn(gen, cuda, 2, 130, 2, dh + 4)[..., :dh]   # head stride
    with pytest.raises(ValueError):
        flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2),
                             ragged.transpose(1, 2), True)


@pytest.mark.parametrize("ps", [16, 128])
def test_paged_kernel_matches_reference(cuda, ps):
    gen = torch.Generator(device=cuda).manual_seed(ps)
    lengths = [1, ps - 1, ps, ps + 1, 3 * ps + 2]
    need = [-(-n // ps) for n in lengths]
    P = sum(need) + 1
    table = torch.zeros((5, 8), dtype=torch.int32, device=cuda)
    ids = torch.randperm(P - 1, generator=gen, device=cuda).to(torch.int32) + 1
    off = 0
    for b, n in enumerate(need):
        table[b, :n] = ids[off:off + n]
        off += n
    q = _randn(gen, cuda, 5, 16, 128)
    kp, vp = _randn(gen, cuda, P, 4, 128, ps), _randn(gen, cuda, P, 4, 128, ps)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = paged_attention_cuda(q, kp, vp, table, lens)
    want = paged_attention_reference(q, kp, vp, table, lens)
    _assert_agrees(got, want)
    lens[0] = 0
    assert bool((paged_attention_cuda(q, kp, vp, table, lens)[0] == 0).all())


def _paged_table(gen, cuda, lengths, ps):
    need = [max(1, -(-n // ps)) for n in lengths]
    P = sum(need) + 1
    table = torch.zeros((len(lengths), max(need) + 1), dtype=torch.int32,
                        device=cuda)
    ids = torch.randperm(P - 1, generator=gen, device=cuda).to(torch.int32) + 1
    off = 0
    for b, n in enumerate(need):
        table[b, :n] = ids[off:off + n]
        off += n
    return table, P


@pytest.mark.parametrize("ps", [16, 128])
def test_paged_q8_kernel_matches_plain(cuda, ps):
    gen = torch.Generator(device=cuda).manual_seed(ps + 1)
    lengths = [1, ps - 1, ps, ps + 1, 3 * ps + 2, 0]
    table, P = _paged_table(gen, cuda, lengths, ps)
    q = _randn(gen, cuda, len(lengths), 32, 128)
    k8, ks = quantize_kv(_randn(gen, cuda, P, 8, 128, ps))
    v8, vs = quantize_kv(_randn(gen, cuda, P, 8, 128, ps))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = paged_attention_q8_cuda.launches
    got = paged_attention_q8_cuda(q, k8, v8, ks, vs, table, lens)
    assert paged_attention_q8_cuda.launches == before + 1
    want = paged_attention_plain(q, k8, v8, table, lens, ks, vs)
    _assert_agrees(got, want)
    assert bool((got[-1] == 0).all())


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_kernel_matches_plain(cuda, quantized):
    """Ragged lengths including 0, S and one past S (clamped to S)."""
    gen = torch.Generator(device=cuda).manual_seed(int(quantized))
    B, S = 6, 700
    lengths = [0, 1, 130, 511, S, S + 1]
    q = _randn(gen, cuda, B, 32, 128)
    k, v = _randn(gen, cuda, B, 8, 128, S), _randn(gen, cuda, B, 8, 128, S)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    scales = ()
    if quantized:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = (ks, vs)

    def kernel(lens):
        if quantized:
            return decode_attention_q8_cuda(q, k, v, *scales, lens)
        return decode_attention_cuda(q, k, v, lens)

    got = kernel(lens)
    _assert_agrees(got, decode_attention_plain(q, k, v, lens, *scales))
    assert bool((got[0] == 0).all())
    lens[-1] = S
    assert torch.equal(kernel(lens)[-1], got[-1])


def test_decode_dispatch_uses_the_kernels_on_cuda(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(gen, cuda, 2, 8, 64)
    k, v = _randn(gen, cuda, 2, 2, 64, 40), _randn(gen, cuda, 2, 2, 64, 40)
    lens = torch.tensor([3, 40], dtype=torch.int32, device=cuda)
    f0, q0 = decode_attention_cuda.launches, decode_attention_q8_cuda.launches
    decode_attention(q, k, v, lens)
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    decode_attention(q, k8, v8, lens, ks, vs)
    assert decode_attention_cuda.launches == f0 + 1
    assert decode_attention_q8_cuda.launches == q0 + 1
    with pytest.raises(TypeError):
        decode_attention(q.float(), k.float(), v.float(), lens)


def _split_lengths(B, nsplit, unit):
    """B=1: 8192; else lengths at a unit boundary and one past it, at the
    end of the first round of units and one past it, 8192, and short rows
    whose later blocks start past them."""
    if B == 1:
        return [8192]
    return [unit, unit + 1, nsplit * unit, nsplit * unit + 1, 8192, 1, 100,
            700][:B]


def _twice(fn):
    """fn() twice in a row must give the same bits: the block that combines
    a row's blocks resets its counter."""
    first = fn()
    assert torch.equal(first, fn())
    return first


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("ps,B", [(16, 1), (16, 8), (128, 1), (128, 8)])
def test_paged_split_matches_reference(cuda, ps, B, quantized):
    """bf16 against the gather reference, int8 against the plain version
    with scales; the same bits twice, zeros at length 0."""
    Hkv = 8
    NP = 1 << (-(-8192 // ps)).bit_length()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tile = SPLIT_TILE_Q8 if quantized else SPLIT_TILE
    nsplit, unit = plan_split(B, Hkv, NP * ps, ps, sms, tile)
    assert nsplit > 1
    lengths = _split_lengths(B, nsplit, unit)
    gen = torch.Generator(device=cuda).manual_seed(ps + B)
    need = [-(-n // ps) for n in lengths]
    P = sum(need) + 1
    table = torch.zeros((B, NP), dtype=torch.int32, device=cuda)
    ids = torch.randperm(P - 1, generator=gen, device=cuda).to(torch.int32) + 1
    off = 0
    for b, n in enumerate(need):
        table[b, :n] = ids[off:off + n]
        off += n
    q = _randn(gen, cuda, B, 32, 128)
    kp, vp = (_randn(gen, cuda, P, Hkv, 128, ps) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    if quantized:
        (k8, ks), (v8, vs) = quantize_kv(kp), quantize_kv(vp)
        counter = paged_attention_q8_cuda

        def read(n):
            return paged_attention_q8_cuda(q, k8, v8, ks, vs, table, n)
        want = paged_attention_plain(q, k8, v8, table, lens, ks, vs)
    else:
        counter = paged_attention_cuda

        def read(n):
            return paged_attention_cuda(q, kp, vp, table, n)
        want = paged_attention_reference(q, kp, vp, table, lens)
    before = counter.launches
    got = _twice(lambda: read(lens))
    assert counter.launches == before + 2
    _assert_agrees(got, want)
    lens[-1] = 0
    assert bool((read(lens)[-1] == 0).all())


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("S,B", [(8192, 1), (8192, 8), (1000, 8), (1001, 8)])
def test_decode_split_matches_plain(cuda, S, B, quantized):
    """Many blocks per row, lengths 0, S and S + 1, and rows that are not
    16-byte aligned (S = 1000, 1001), bf16 and int8; the same bits twice."""
    Hkv = 8
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tile = SPLIT_TILE_Q8 if quantized else SPLIT_TILE
    nsplit, unit = plan_split(B, Hkv, S, None, sms, tile)
    assert nsplit > 1
    lengths = ([S] if B == 1 else
               [unit, unit + 1, nsplit * unit, nsplit * unit + 1, S, S + 1,
                0, 1])
    gen = torch.Generator(device=cuda).manual_seed(S + B)
    q = _randn(gen, cuda, B, 32, 128)
    k, v = (_randn(gen, cuda, B, Hkv, 128, S) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    scales = ()
    if quantized:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = (ks, vs)

    def read(n):
        if quantized:
            return decode_attention_q8_cuda(q, k, v, *scales, n)
        return decode_attention_cuda(q, k, v, n)

    got = _twice(lambda: read(lens))
    _assert_agrees(got, decode_attention_plain(q, k, v, lens, *scales))
    if B > 1:
        assert bool((got[6] == 0).all())
        lens[5] = S
        assert torch.equal(read(lens)[5], got[5])


def test_split_reads_on_two_streams(cuda):
    """Each stream has its own counters: reads on a side stream, bf16 and
    int8, agree with the same reads on the default stream."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = _randn(gen, cuda, 2, 32, 128)
    k, v = (_randn(gen, cuda, 2, 8, 128, 4096) for _ in range(2))
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    lens = torch.tensor([4000, 2500], dtype=torch.int32, device=cuda)

    def reads():
        return (decode_attention_cuda(q, k, v, lens),
                decode_attention_q8_cuda(q, k8, v8, ks, vs, lens))

    want = reads()
    side = torch.cuda.Stream(device=cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got = reads()
    torch.cuda.current_stream(cuda).wait_stream(side)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def _small_cfg(**kw):
    return dataclasses.replace(LlamaConfig.debug(), dim=256, n_heads=4,
                               n_kv_heads=2, dtype="bfloat16",
                               attn_impl="flash", **kw)


@pytest.mark.parametrize("paged,kw,counter", [
    (False, {"decode_attn": "kernel"}, decode_attention_cuda),
    (False, {"decode_attn": "kernel", "kv_dtype": "int8"},
     decode_attention_q8_cuda),
    (True, {"kv_dtype": "int8"}, paged_attention_q8_cuda),
], ids=["dense", "dense-int8", "paged-int8"])
def test_new_engine_configs_go_through_their_kernels(cuda, paged, kw,
                                                     counter):
    cfg = _small_cfg(**kw)
    engine = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16))
    params = llama_init(cfg, seed=0, device=cuda)
    eng = (PagedLLMEngine(params, cfg, device=cuda, page_size=8, **engine)
           if paged else LLMEngine(params, cfg, device=cuda, **engine))
    eng.start()
    try:
        f0, c0 = flash_attention_cuda.launches, counter.launches
        out = eng.generate(list(range(3, 17)), max_new_tokens=20)
        assert len(out) == 20
        assert flash_attention_cuda.launches - f0 == cfg.n_layers * eng.prefill_dispatches
        assert counter.launches - c0 == cfg.n_layers * eng.decode_steps
    finally:
        eng.stop()


def test_engine_on_the_card_goes_through_both_kernels(cuda):
    cfg = dataclasses.replace(LlamaConfig.debug(), dim=256, n_heads=4,
                              n_kv_heads=2, dtype="bfloat16",
                              attn_impl="flash")
    eng = PagedLLMEngine(llama_init(cfg, seed=0, device=cuda), cfg,
                         device=cuda, n_slots=4, max_seq_len=64,
                         prefill_buckets=(8, 16), page_size=8)
    eng.start()
    try:
        f0, p0 = flash_attention_cuda.launches, paged_attention_cuda.launches
        out = eng.generate([5, 6, 7], max_new_tokens=8)
        assert len(out) == 8
        assert flash_attention_cuda.launches - f0 == cfg.n_layers * eng.prefill_dispatches
        assert paged_attention_cuda.launches - p0 == cfg.n_layers * eng.decode_steps
    finally:
        eng.stop()
