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
from gofr_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_cuda,
                                                flash_attention_plain)
from gofr_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                paged_attention_reference)
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


@pytest.mark.parametrize("T,S,dh,causal", [(64, 64, 128, True),
                                           (77, 77, 64, True),
                                           (200, 130, 128, False),
                                           (1, 300, 64, False)])
def test_flash_kernel_matches_plain(cuda, T, S, dh, causal):
    gen = torch.Generator(device=cuda).manual_seed(T)
    q = _randn(gen, cuda, 2, 8, T, dh)
    k, v = _randn(gen, cuda, 2, 2, S, dh), _randn(gen, cuda, 2, 2, S, dh)
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, causal)
    assert flash_attention_cuda.launches == before + 1
    want = flash_attention_plain(q, k, v, causal)
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
