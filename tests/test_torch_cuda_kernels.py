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
from gofr_tpu_torch.ops.launch_counts import counts as launch_counts
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
    before = launch_counts()["flash_attention"]
    got = flash_attention_cuda(q, k, v, causal)
    assert launch_counts()["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v, causal, KERNEL_BLOCK_KV)
    _assert_agrees(got, want)


def test_flash_dispatch_uses_the_kernel_on_cuda(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (_randn(gen, cuda, 1, 50, 4, 64) for _ in range(3))
    before = launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, True)
    assert launch_counts()["flash_attention"] == before + 1
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
    before = launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, True)
    assert launch_counts()["flash_attention"] == before + 1
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
    before = launch_counts()["paged_attention_q8"]
    got = paged_attention_q8_cuda(q, k8, v8, ks, vs, table, lens)
    assert launch_counts()["paged_attention_q8"] == before + 1
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
    before = launch_counts()
    decode_attention(q, k, v, lens)
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    decode_attention(q, k8, v8, lens, ks, vs)
    after = launch_counts()
    assert after["decode_attention"] == before["decode_attention"] + 1
    assert after["decode_attention_q8"] == before["decode_attention_q8"] + 1
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
        counter = "paged_attention_q8"

        def read(n):
            return paged_attention_q8_cuda(q, k8, v8, ks, vs, table, n)
        want = paged_attention_plain(q, k8, v8, table, lens, ks, vs)
    else:
        counter = "paged_attention"

        def read(n):
            return paged_attention_cuda(q, kp, vp, table, n)
        want = paged_attention_reference(q, kp, vp, table, lens)
    before = launch_counts()[counter]
    got = _twice(lambda: read(lens))
    assert launch_counts()[counter] == before + 2
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
    (False, {"decode_attn": "kernel"}, "decode_attention"),
    (False, {"decode_attn": "kernel", "kv_dtype": "int8"},
     "decode_attention_q8"),
    (True, {"kv_dtype": "int8"}, "paged_attention_q8"),
], ids=["dense", "dense-int8", "paged-int8"])
def test_new_engine_configs_go_through_their_kernels(cuda, paged, kw,
                                                     counter):
    cfg = _small_cfg(**kw)
    engine = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16))
    params = llama_init(cfg, seed=0, device=cuda)
    eng = (PagedLLMEngine(params, cfg, device=cuda, page_size=8, **engine)
           if paged else LLMEngine(params, cfg, device=cuda, **engine))
    eng.warmup()       # every decode graph, before the counted run
    eng.start()
    try:
        before = launch_counts()
        out = eng.generate(list(range(3, 17)), max_new_tokens=20)
        assert len(out) == 20
        after = launch_counts()
        assert (after["flash_attention"] - before["flash_attention"]
                == cfg.n_layers * eng.prefill_dispatches)
        # every decode step ran in a graph replay, counted on the card
        assert (after[counter] - before[counter]
                == cfg.n_layers * eng.decode_steps)
    finally:
        eng.stop()


def test_engine_on_the_card_goes_through_both_kernels(cuda):
    cfg = dataclasses.replace(LlamaConfig.debug(), dim=256, n_heads=4,
                              n_kv_heads=2, dtype="bfloat16",
                              attn_impl="flash")
    eng = PagedLLMEngine(llama_init(cfg, seed=0, device=cuda), cfg,
                         device=cuda, n_slots=4, max_seq_len=64,
                         prefill_buckets=(8, 16), page_size=8)
    eng.warmup()
    eng.start()
    try:
        before = launch_counts()
        out = eng.generate([5, 6, 7], max_new_tokens=8)
        assert len(out) == 8
        after = launch_counts()
        assert (after["flash_attention"] - before["flash_attention"]
                == cfg.n_layers * eng.prefill_dispatches)
        assert (after["paged_attention"] - before["paged_attention"]
                == cfg.n_layers * eng.decode_steps)
    finally:
        eng.stop()


@pytest.mark.parametrize("paged,kw", [
    (True, {}), (True, {"kv_dtype": "int8"}),
    (False, {"decode_attn": "kernel"}),
    (False, {"decode_attn": "kernel", "kv_dtype": "int8"}),
], ids=["paged", "paged-int8", "dense", "dense-int8"])
def test_decode_block_graph_matches_eager(cuda, paged, kw):
    """One decode block replayed from its CUDA graph against the same block
    run eagerly from the same state (tpu/graphcheck.graph_vs_eager, as
    chip_smoke.py runs it): equal greedy tokens, K/V (and scales) within
    one bf16 rounding of O(1) values, should cuBLAS pick another algorithm
    under capture, and the decode read counted on the card n_layers per
    step in both."""
    from gofr_tpu_torch.tpu.graphcheck import graph_vs_eager

    cfg = _small_cfg(**kw)
    engine = dict(n_slots=4, max_seq_len=128, prefill_buckets=(8, 16),
                  decode_block_size=8)
    params = llama_init(cfg, seed=0, device=cuda)
    eng = (PagedLLMEngine(params, cfg, device=cuda, page_size=8, **engine)
           if paged else LLMEngine(params, cfg, device=cuda, **engine))
    for i in range(3):
        eng.submit(list(range(3 + i, 14 + 2 * i)), max_new_tokens=60)
    for _ in range(6):
        eng._step()
    got = graph_vs_eager(eng, 8)
    assert torch.equal(got["graph"], got["eager"])
    assert got["state_diff"] <= 0.05
    assert got["graph_launches"] == got["eager_launches"] == cfg.n_layers * 8
    assert eng.executor.captures >= 1 and eng.executor.calls >= 2


def test_async_d2h_off_serves_the_same_tokens(cuda):
    """ENGINE_ASYNC_D2H=false copies a device clone of each block at sync
    instead of a pinned copy at dispatch: the same greedy streams, with
    blocks in flight behind each other either way."""
    cfg = _small_cfg()
    params = llama_init(cfg, seed=0, device=cuda)
    prompts = [list(range(3 + i, 12 + 3 * i)) for i in range(3)]
    got = []
    for async_d2h in (True, False):
        eng = PagedLLMEngine(params, cfg, device=cuda, n_slots=4,
                             max_seq_len=64, prefill_buckets=(8, 16),
                             page_size=8, async_d2h=async_d2h)
        eng.start()
        try:
            reqs = [eng.submit(p, max_new_tokens=24) for p in prompts]
            got.append([r.result(timeout_s=300) for r in reqs])
        finally:
            eng.stop()
        assert eng.max_inflight >= 2
    assert got[0] == got[1] and all(len(s) == 24 for s in got[0])


@pytest.mark.parametrize("paged,kw,tail", [
    (True, {}, False), (True, {}, True),
    (True, {"kv_dtype": "int8"}, False), (True, {"kv_dtype": "int8"}, True),
    (False, {"decode_attn": "kernel"}, False),
    (False, {"decode_attn": "kernel", "kv_dtype": "int8"}, False),
], ids=["paged", "paged-tail", "paged-int8", "paged-int8-tail", "dense",
        "dense-int8"])
def test_prefill_wave_graph_matches_eager(cuda, paged, kw, tail):
    """Admission waves (full, or tail-only over 2 cached pages) replayed
    from their CUDA graphs against the same waves run eagerly from the
    same state (tpu/graphcheck.prefill_graph_vs_eager, as chip_smoke.py
    runs it), beside two live rows, at temperature 0 and 0.8: the first
    tokens equal, the state bit-equal, flash counted on the card n_layers
    times per full wave (none in a tail wave) in both."""
    from gofr_tpu_torch.tpu.graphcheck import prefill_graph_vs_eager

    cfg = _small_cfg(**kw)
    engine = dict(n_slots=4, max_seq_len=128, prefill_buckets=(8, 16))
    params = llama_init(cfg, seed=0, device=cuda)
    eng = (PagedLLMEngine(params, cfg, device=cuda, page_size=8, **engine)
           if paged else LLMEngine(params, cfg, device=cuda, **engine))
    for i in range(2):
        eng.submit(list(range(3 + i, 14 + 2 * i)), max_new_tokens=40)
    for _ in range(3):
        eng._step()
    flash = 0 if tail else cfg.n_layers
    for K in (1, 4):
        for temperature in (0.0, 0.8):
            got = prefill_graph_vs_eager(eng, K, 16, tail, temperature)
            assert torch.equal(got["graph"], got["eager"])
            assert got["state_diff"] == 0.0
            assert got["graph_launches"] == got["eager_launches"] == flash


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_no_capture_after_wide_warmup(cuda, paged):
    """warmup(k_variants=True) (WARMUP=wide) captures every program a short
    burst reaches: waves of several widths and buckets, a prefix hit's
    tail on the paged engine, decode blocks full and half; nothing is
    captured while it is served, and every wave is one graph replay."""
    cfg = _small_cfg(**({} if paged else {"decode_attn": "kernel"}))
    engine = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16))
    params = llama_init(cfg, seed=0, device=cuda)
    eng = (PagedLLMEngine(params, cfg, device=cuda, page_size=8,
                          prefix_cache=True, **engine)
           if paged else LLMEngine(params, cfg, device=cuda, **engine))
    eng.warmup(k_variants=True)
    captures = eng.executor.captures
    eng.start()
    try:
        system = list(range(1, 9))
        assert len(eng.generate(system + [20, 21], max_new_tokens=6)) == 6
        reqs = [eng.submit(p, max_new_tokens=10) for p in
                [system + [30], system + [31, 32], [5, 6, 7],
                 list(range(40, 52)), [60, 61]]]
        assert all(len(r.result(timeout_s=300)) == 10 for r in reqs)
    finally:
        eng.stop()
    assert eng.executor.captures == captures
    waves = eng.prefill_dispatches + eng.prefix_dispatches
    calls = eng.executor.cache_info()
    assert sum(n for name, n in calls.items() if "decode" not in name) \
        == waves
    assert not paged or eng.prefix_dispatches >= 1


@pytest.mark.parametrize("rows", [8, 17, 32])
def test_int8_product_on_the_card_equals_the_cpu(cuda, rows):
    """_q_matmul's pieces on the card at a Llama-3-8B width: the int8
    activations, the int32 product through torch._int_mm (8 rows padded
    to its minimum) on a column-major weight, bit-equal to the CPU's; the
    bf16 output within one bf16 ulp (the f32 epilogue's order may differ
    inside the fused kernels)."""
    from gofr_tpu_torch.models.llama import (_int_matmul, _q_matmul,
                                             _quantize_rows, _quantized)

    gen = torch.Generator(device="cpu").manual_seed(rows)
    x = torch.randn((rows, 4096), generator=gen).to(torch.bfloat16)
    w = (torch.randn((4096, 1024), generator=gen) * 0.02).to(torch.bfloat16)
    w8, s = _quantized(w, -2)
    assert w8.t().is_contiguous()
    x8, ax = _quantize_rows(x)
    x8c, axc = _quantize_rows(x.to(cuda))
    assert torch.equal(x8c.cpu(), x8) and torch.equal(axc.cpu(), ax)
    acc = _int_matmul(x8c, w8.to(cuda))
    assert torch.equal(acc.cpu(), (x8.long() @ w8.long()).int())
    got = _q_matmul(x.to(cuda), w8.to(cuda), s.to(cuda)).float().cpu()
    want = _q_matmul(x, w8, s).float()
    assert bool(((got - want).abs() <= want.abs() * 2 ** -7).all())


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_int8_weight_decode_block_graph_matches_eager(cuda, paged):
    """An engine on int8 weights (llama_init_quantized): one decode block
    replayed from its graph against the same block run eagerly from the
    same state: equal greedy tokens and bit-equal K/V (the cuBLASLt int8
    product inside the capture replays as eager)."""
    from gofr_tpu_torch.models.llama import llama_init_quantized
    from gofr_tpu_torch.tpu.graphcheck import graph_vs_eager

    cfg = _small_cfg(**({} if paged else {"decode_attn": "kernel"}))
    engine = dict(n_slots=4, max_seq_len=128, prefill_buckets=(8, 16),
                  decode_block_size=8)
    params = llama_init_quantized(cfg, seed=0, device=cuda)
    assert params["layers"]["wq"].dtype == torch.int8
    eng = (PagedLLMEngine(params, cfg, device=cuda, page_size=8, **engine)
           if paged else LLMEngine(params, cfg, device=cuda, **engine))
    for i in range(3):
        eng.submit(list(range(3 + i, 14 + 2 * i)), max_new_tokens=60)
    for _ in range(6):
        eng._step()
    got = graph_vs_eager(eng, 8)
    assert torch.equal(got["graph"], got["eager"])
    assert got["state_diff"] == 0.0
    assert got["graph_launches"] == got["eager_launches"] == cfg.n_layers * 8


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_verify_graph_matches_eager(cuda, paged):
    """A speculative engine driven past its prefills: one verify with the
    rows' greedy continuations as drafts (graphcheck.greedy_drafts), replayed
    from its graph against the same verify run eagerly from the same state
    (tpu/graphcheck.verify_graph_vs_eager, as chip_smoke.py runs it): the
    window's tokens and emit counts equal, every draft accepted, the caches
    or pools (page 0 aside) bit-equal."""
    from gofr_tpu_torch.tpu.graphcheck import verify_graph_vs_eager

    cfg = _small_cfg(**({} if paged else {"decode_attn": "kernel"}))
    engine = dict(n_slots=4, max_seq_len=128, prefill_buckets=(8, 16),
                  speculative_tokens=4)
    params = llama_init(cfg, seed=0, device=cuda)
    eng = (PagedLLMEngine(params, cfg, device=cuda, page_size=8, **engine)
           if paged else LLMEngine(params, cfg, device=cuda, **engine))
    for i in range(3):
        eng.submit([5, 6, 7, 8, 5, 6, 7, 8, 5 + i, 6], max_new_tokens=200)
    # past the prefills, the rows still decoding (a cooloff pipelines
    # whole blocks, so a few steps only)
    for _ in range(3):
        eng._step()
    got = verify_graph_vs_eager(eng)
    assert got["rows"] == 3 and got["accepted"] == 4 * 3
    assert torch.equal(got["graph"], got["eager"])
    assert got["state_diff"] == 0.0


@pytest.mark.parametrize("paged,kw", [
    (True, {}), (True, {"kv_dtype": "int8"}), (False, {}),
    (False, {"decode_attn": "kernel", "kv_dtype": "int8"}),
], ids=["paged", "paged-int8", "dense", "dense-int8"])
def test_chunk_graph_matches_eager(cuda, paged, kw):
    """A middle and the final chunk of a [2, 32] chunked admission (chunk 8)
    replayed from their graphs against the same chunks run eagerly from
    the same state (tpu/graphcheck.chunk_graph_vs_eager), beside two live
    rows: outputs equal, the state and the carried buffers bit-equal (the
    paged garbage page 0 aside)."""
    from gofr_tpu_torch.tpu.graphcheck import chunk_graph_vs_eager

    cfg = _small_cfg(**kw)
    engine = dict(n_slots=4, max_seq_len=128, prefill_buckets=(8, 32),
                  chunk_prefill_tokens=8)
    params = llama_init(cfg, seed=0, device=cuda)
    eng = (PagedLLMEngine(params, cfg, device=cuda, page_size=8, **engine)
           if paged else LLMEngine(params, cfg, device=cuda, **engine))
    for i in range(2):
        eng.submit(list(range(3 + i, 8 + i)), max_new_tokens=40)
    for _ in range(3):
        eng._step()
    for final in (False, True):
        got = chunk_graph_vs_eager(eng, 2, 32, final, temperature=0.8)
        assert torch.equal(got["graph"], got["eager"])
        assert got["state_diff"] == 0.0


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_landing_under_captured_decode_graphs_reads_the_landed_pages(cuda,
                                                                    kv):
    """A stream exported mid-generation from engine A (its pages pulled on
    A's stream) and landed on engine B, whose every decode graph was
    captured over its pools before: B continues the stream exactly as it
    serves the prompt itself, with no prefill, no capture, no fallback, its
    pools and loop state the same tensors (the landing writes in place),
    and the paged read counted n_layers per decode step."""
    import time

    from gofr_tpu_torch.tpu.faults import FaultPlane

    cfg = _small_cfg(**({"kv_dtype": "int8"} if kv == "int8" else {}))
    # buckets to 32: the resume window (prompt + what was delivered by the
    # round) must stay inside the admission limit
    engine = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16, 32),
                  page_size=8)
    params = llama_init(cfg, seed=0, device=cuda)
    counter = "paged_attention_q8" if kv == "int8" else "paged_attention"
    slow = FaultPlane([{"site": "engine.decode", "action": "delay",
                        "every": 1, "times": 0, "delay_s": 0.02}])
    a = PagedLLMEngine(params, cfg, device=cuda, decode_block_size=1,
                       faults=slow, **engine)
    b = PagedLLMEngine(params, cfg, device=cuda, **engine)
    b.warmup()
    tensors = [b.k_cache, b.v_cache, b._tokens, b._positions, b._temps]
    if kv == "int8":
        tensors += [b.k_scale, b.v_scale]
    ptrs = [t.data_ptr() for t in tensors]
    captures = b.executor.captures
    a.start()
    b.start()
    try:
        prompt = list(range(3, 14))
        want = b.generate(prompt, max_new_tokens=24)
        req = a.submit(prompt, max_new_tokens=24)
        stream = req.stream(timeout_s=120)
        got = [next(stream), next(stream)]
        exported = []
        a.request_migration(lambda r, blobs, n: exported.append(blobs)
                            or True)
        deadline = time.monotonic() + 60
        while a.migration_pending and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(exported) == 1 and exported[0]
        waves = b.prefill_dispatches + b.prefix_dispatches
        steps = b.decode_steps
        before = launch_counts()
        b.submit_handoff(prompt, list(req.emitted), max_new_tokens=24,
                         out_queue=req.out_queue, cancelled=req.cancelled,
                         blobs=exported[0])
        got.extend(stream)
        after = launch_counts()
    finally:
        a.stop()
        b.stop()
    assert got == want
    assert b.prefill_dispatches + b.prefix_dispatches == waves
    assert b.handoff_fallbacks_total == 0
    assert b.executor.captures == captures
    assert [t.data_ptr() for t in tensors] == ptrs
    assert (after[counter] - before[counter]
            == cfg.n_layers * (b.decode_steps - steps))


# -- the per-rank shapes of tensor and sequence parallelism (ROADMAP A14a) ---
# (H, Hkv) one rank holds: Llama-3-8B (32/8 heads) and Llama-3-70B (64/8)
# at tp = 2, 4 and 8 (G = H / Hkv unchanged: 4 and 8), and Ulysses' G = 1
# (the KV heads repeated up to the query heads when sp does not divide Hkv)
RANK_HEADS = {"8b-tp2": (16, 4), "8b-tp4": (8, 2), "8b-tp8": (4, 1),
              "70b-tp2": (32, 4), "70b-tp4": (16, 2), "70b-tp8": (8, 1),
              "ulysses-g1-h4": (4, 4), "ulysses-g1-h8": (8, 8)}


@pytest.mark.parametrize("shape", sorted(RANK_HEADS))
def test_flash_at_the_per_rank_heads(cuda, shape):
    H, Hkv = RANK_HEADS[shape]
    gen = torch.Generator(device=cuda).manual_seed(H * 10 + Hkv)
    q = _randn(gen, cuda, 2, H, 256, 128)
    k, v = (_randn(gen, cuda, 2, Hkv, 256, 128) for _ in range(2))
    before = launch_counts()["flash_attention"]
    got = flash_attention_cuda(q, k, v, True)
    assert launch_counts()["flash_attention"] == before + 1
    _assert_agrees(got, flash_attention_plain(q, k, v, True, KERNEL_BLOCK_KV))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("shape", sorted(h for h in RANK_HEADS
                                         if not h.startswith("ulysses")))
def test_reads_at_the_per_rank_heads(cuda, shape, quantized):
    """The paged and the dense reads, bf16 and int8, at a TP rank's heads
    (B=8, ragged lengths, page size 128, a dense S=700 cache)."""
    H, Hkv = RANK_HEADS[shape]
    gen = torch.Generator(device=cuda).manual_seed(H + Hkv + quantized)
    lengths = [1, 127, 128, 129, 300, 700, 0, 513]
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = _randn(gen, cuda, 8, H, 128)
    table, P = _paged_table(gen, cuda, lengths, 128)
    kp, vp = (_randn(gen, cuda, P, Hkv, 128, 128) for _ in range(2))
    k, v = (_randn(gen, cuda, 8, Hkv, 128, 700) for _ in range(2))
    name = "_q8" if quantized else ""
    before = launch_counts()
    if quantized:
        (k8, ks), (v8, vs) = quantize_kv(kp), quantize_kv(vp)
        paged = paged_attention_q8_cuda(q, k8, v8, ks, vs, table, lens)
        paged_want = paged_attention_plain(q, k8, v8, table, lens, ks, vs)
        (d8, dks), (e8, dvs) = quantize_kv(k), quantize_kv(v)
        dense = decode_attention_q8_cuda(q, d8, e8, dks, dvs, lens)
        dense_want = decode_attention_plain(q, d8, e8, lens, dks, dvs)
    else:
        paged = paged_attention_cuda(q, kp, vp, table, lens)
        # the plain version, as in the int8 case: the gather oracle
        # averages V over a length-0 row, where the kernel writes zeros
        paged_want = paged_attention_plain(q, kp, vp, table, lens)
        dense = decode_attention_cuda(q, k, v, lens)
        dense_want = decode_attention_plain(q, k, v, lens)
    after = launch_counts()
    assert after["paged_attention" + name] > before["paged_attention" + name]
    assert (after["decode_attention" + name]
            > before["decode_attention" + name])
    _assert_agrees(paged, paged_want)
    _assert_agrees(dense, dense_want)
    assert bool((paged[6] == 0).all()) and bool((dense[6] == 0).all())
