"""Training's use of the flash kernel, on the card.

Marked `cuda`: each test skips without a card (decided inside the test, so
every worker collects the same tests). On a machine with one:
``python -m pytest --noconftest tests/test_torch_train_cuda.py -q``. The
kernel's output carries the reference's gradient (``FlashAttention``: the
VJP of ``attention_reference``, so its gradients equal autograd's through
the oracle, computed by the same function from the same inputs), and a
remat train step launches the kernel twice per layer (counted on the card).
"""

import dataclasses

import pytest
import torch

from gofr_tpu_torch.models.llama import (LlamaConfig, llama_forward_nocache,
                                         llama_init)
from gofr_tpu_torch.ops import launch_counts
from gofr_tpu_torch.ops.flash_attention import (attention_reference,
                                                flash_attention)
from gofr_tpu_torch.train import make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_flash_gradient_is_the_oracle_vjp(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)

    q, g = randn(2, 256, 8, 128), randn(2, 256, 8, 128)
    k, v = randn(2, 256, 2, 128), randn(2, 256, 2, 128)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, True)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, g)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_reference(*ref, causal=True), ref, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_remat_step_launches_flash_twice_per_layer(cuda):
    # head_dim 64: the kernel takes 64 or 128
    cfg = dataclasses.replace(LlamaConfig.debug(), dim=128, n_heads=2,
                              n_kv_heads=1, dtype="bfloat16",
                              attn_impl="flash")
    params = llama_init(cfg, seed=0, device=cuda)
    init, step = make_train_step(
        lambda p, t: llama_forward_nocache(p, cfg, t))
    seq = torch.randint(1, cfg.vocab_size, (2, 65), device=cuda)
    state = init(params)
    launch_counts.counter("flash_attention", cuda)
    losses = []
    for _ in range(3):
        launch_counts.zero()
        params, state, m = step(params, state, seq[:, :-1], seq[:, 1:])
        assert launch_counts.counts()["flash_attention"] == 2 * cfg.n_layers
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    # the step updated the tensors in place and left no autograd state
    assert not any(w.requires_grad for w in params["layers"].values())
