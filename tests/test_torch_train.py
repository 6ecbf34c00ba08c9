"""The port's training layer vs the JAX package on the CPU.

Flash attention's gradient (the port's ``FlashAttention`` autograd Function
against ``jax.grad`` through the reference's custom_vjp, the Pallas kernel in
interpret mode), the loss, the cache-free forwards' gradients, the AdamW copy
against optax, whole train steps and optax state carried across. The same
numpy inputs and weights (``jax.device_get`` of the JAX init, bridged with
``params_from_numpy``) go to both packages.

Tolerances: f32 gradients 1e-5 of the largest gradient of the leaf (the same
math, summed in other orders); bf16 flash gradients 2e-2 of the largest
gradient (both recompute the f32 oracle from the same bf16 inputs, so only
the forward's rounding of the oracle's output and the cast of the cotangent
differ); the AdamW copy equal to optax bit for bit in f32 moments and in
bf16 everything, the f32 updates within 1e-6 relative (optax's decay**count
is computed by XLA's pow, the port's by torch's); three SGD steps 1e-5 of
each leaf's scale. Full steps compare under SGD, not AdamW: Adam's first
step is about lr * sign(g), so a gradient near 0 that differs in sign
between the packages would move a parameter by 2 * lr.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gofr_tpu.models import llama as jl
from gofr_tpu.train import cross_entropy_loss as j_ce
from gofr_tpu.train import make_train_step as j_make_train_step
from gofr_tpu_torch import tree
from gofr_tpu_torch.models import llama as tl
from gofr_tpu_torch.models.weights import adam_state_from_numpy, params_from_numpy
from gofr_tpu_torch.train import (AdamWState, adamw, cross_entropy_loss,
                                  global_norm, make_train_step)

# gofr_tpu.ops re-exports flash_attention (the function) under the module name
jfa = importlib.import_module("gofr_tpu.ops.flash_attention")
tfa = importlib.import_module("gofr_tpu_torch.ops.flash_attention")

LR = 1e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_leaves(got, want, rel):
    """Every leaf of `got` (torch) within rel * max|want| of `want` (JAX),
    in JAX's leaf order."""
    g, w = tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape
        scale = max(float(np.abs(b).max()), 1e-6)
        assert float(np.abs(a - b).max()) <= rel * scale, (a.shape, scale)


# -- flash attention's gradient ----------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("B,T,H,Hkv,dh", [(2, 40, 4, 2, 16),
                                          (1, 130, 4, 1, 32)])
def test_flash_gradient_matches_jax(causal, dtype, rel, B, T, H, Hkv, dh):
    rng = np.random.default_rng(T)
    q, g = (rng.standard_normal((B, T, H, dh), dtype=np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((B, T, Hkv, dh), dtype=np.float32)
            for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jg = (jnp.asarray(x).astype(jdt) for x in (q, k, v, g))
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, causal),
                     jq, jk, jv)
    want = vjp(jg)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal)
    assert out.grad_fn is not None and out.dtype == tdt
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g).to(tdt))
    _close_leaves(list(got), list(want), rel)


def test_kernel_output_carries_the_oracle_gradient(monkeypatch):
    """The fault FlashAttention fixes: on the card the kernel writes its
    output through raw pointers, so the tensor it returns has no autograd
    history, and a loss through it gave wq, wk and wv no gradient through
    attention. Here a stand-in for the kernel path writes the same way;
    through flash_attention its output has a grad_fn, and the gradient is
    the VJP of attention_reference (the reference's _flash_bwd), not
    autograd through the kernel's own arithmetic."""
    calls = []

    def raw_kernel(q, k, v, causal):
        calls.append(q.shape)
        out = torch.empty_like(q)
        with torch.no_grad():
            out.copy_(tfa.flash_attention_plain(
                *(t.transpose(1, 2) for t in (q, k, v)), causal
            ).transpose(1, 2))
        return out

    monkeypatch.setattr(tfa, "_forward", raw_kernel)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 24, 4, 16),
                                             dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 24, 2, 16),
                                                 dtype=np.float32))
            for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    # the fault: the kernel's output alone is a dead end for autograd
    assert raw_kernel(*leaves, True).grad_fn is None
    out = tfa.flash_attention(*leaves, True)
    assert out.grad_fn is not None and len(calls) == 2
    got = torch.autograd.grad(out.square().sum(), leaves)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = tfa.attention_reference(*ref_leaves, causal=True)
    want = torch.autograd.grad(ref.square().sum(), ref_leaves)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, atol=1e-5, rtol=1e-5)


def test_no_grad_path_skips_the_function():
    q = torch.randn(1, 8, 2, 16)
    k = v = torch.randn(1, 8, 2, 16)
    with torch.no_grad():
        out = tfa.flash_attention(q.requires_grad_(), k, v, True)
    assert out.grad_fn is None


# -- the loss ------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_optax(masked):
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((2, 9, 50), dtype=np.float32) * 4)
    targets = rng.integers(0, 50, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32) if masked else None
    want, want_g = jax.value_and_grad(lambda x: j_ce(x, targets, mask))(
        jnp.asarray(logits))
    tlog = torch.from_numpy(logits).requires_grad_()
    got = cross_entropy_loss(tlog, torch.from_numpy(targets),
                             None if mask is None else torch.from_numpy(mask))
    (got_g,) = torch.autograd.grad(got, tlog)
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-7)
    # an all-zero mask divides by 1, as the reference's max(sum, 1)
    zero = cross_entropy_loss(tlog.detach(), torch.from_numpy(targets),
                              torch.zeros(2, 9))
    assert float(zero) == 0.0


# -- models --------------------------------------------------------------------
def _llama(attn_impl="flash"):
    jcfg = dataclasses.replace(jl.LlamaConfig.debug(), attn_impl=attn_impl)
    tcfg = dataclasses.replace(tl.LlamaConfig.debug(), attn_impl=attn_impl)
    jp = jl.llama_init(jcfg, seed=0)
    return jcfg, tcfg, jp, params_from_numpy(jax.device_get(jp), "cpu")


def _tokens(seed, B=2, T=24, V=512):
    seq = np.random.default_rng(seed).integers(1, V, (B, T + 1)).astype(np.int32)
    return seq[:, :-1], seq[:, 1:]


def _grads(fn, params):
    """(value, grads tree) of fn(params) by torch autograd, params kept."""
    leaves = tree.leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    value = fn(tree.unflatten(params, live))
    return value, tree.unflatten(params, list(torch.autograd.grad(value, live)))


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_llama_loss_and_grads_match_jax(attn_impl):
    jcfg, tcfg, jp, tp = _llama(attn_impl)
    toks, tgts = _tokens(3)
    want, want_g = jax.value_and_grad(lambda p: j_ce(
        jl.llama_forward_nocache(p, jcfg, toks), tgts))(jp)
    got, got_g = _grads(lambda p: cross_entropy_loss(
        tl.llama_forward_nocache(p, tcfg, torch.from_numpy(toks).long()),
        torch.from_numpy(tgts)), tp)
    assert abs(float(got) - float(want)) <= 1e-5 * float(want)
    _close_leaves(got_g, want_g, 1e-5)


# -- the optimizer ---------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_optax(dtype):
    rng = np.random.default_rng(5)
    shapes = {"a": (33, 17), "b": [(7,), (2, 3)]}
    p0 = jax.tree.map(lambda s: rng.standard_normal(s, dtype=np.float32),
                      shapes, is_leaf=lambda s: isinstance(s, tuple))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), p0)
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    jopt = optax.adamw(3e-4, weight_decay=0.01, b1=0.9, b2=0.95)
    topt = adamw(3e-4, weight_decay=0.01, b1=0.9, b2=0.95)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape, dtype=np.float32) * 1e-2).astype(jdt),
            jp)
        jupd, jstate = jopt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, jupd)
        tupd, tstate = topt.update(params_from_numpy(jax.device_get(g), "cpu"),
                                   tstate, tp)
        tp = tree.tree_map(lambda p, u: p + u, tp, tupd)
        adam = jstate[0]
        assert int(tstate.count) == int(adam.count)
        for got, want in ((tstate.mu, adam.mu), (tstate.nu, adam.nu),
                          (tp, jp)):
            for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
                assert a.dtype == tdt
                np.testing.assert_array_equal(_np(a), _np(b))
        for a, b in zip(tree.leaves(tupd), jax.tree.leaves(jupd)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=0)


def test_global_norm_matches_optax():
    rng = np.random.default_rng(6)
    g = {"a": rng.standard_normal((40, 3), dtype=np.float32),
         "b": [rng.standard_normal((5,), dtype=np.float32)]}
    want = float(optax.global_norm(g))
    got = global_norm(params_from_numpy(g, "cpu"))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-6 * want


# -- whole steps -----------------------------------------------------------------
class _SGD:
    """optax.sgd(lr) without momentum, as the port's optimizer interface."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return ()

    def update(self, grads, state, params):
        return tree.tree_map(lambda g: -self.lr * g, grads), state


def _check_steps(jfwd, tfwd, jp, tp, remat, has_aux, n=3):
    toks, tgts = _tokens(7)
    j_init, j_step = j_make_train_step(jfwd, optimizer=optax.sgd(LR),
                                       has_aux_loss=has_aux, remat=remat)
    t_init, t_step = make_train_step(tfwd, optimizer=_SGD(LR),
                                     has_aux_loss=has_aux, remat=remat)
    js, ts = j_init(jp), t_init(tp)
    tt, tg = torch.from_numpy(toks).long(), torch.from_numpy(tgts).long()
    for _ in range(n):
        jp, js, jm_ = j_step(jp, js, toks, tgts)
        out, ts, tm_ = t_step(tp, ts, tt, tg)
        assert out is tp               # updated in place, the same tree
        for key in ("loss", "aux_loss", "total_loss", "grad_norm"):
            want = float(jm_[key])
            assert tm_[key].dim() == 0
            assert abs(float(tm_[key]) - want) <= 1e-5 * max(abs(want), 1e-3)
    _close_leaves(tp, jp, 1e-5)
    assert float(tm_["loss"]) < 7.0


@pytest.mark.parametrize("remat", [True, False])
def test_llama_train_steps_match_jax(remat):
    jcfg, tcfg, jp, tp = _llama()
    _check_steps(lambda p, t: jl.llama_forward_nocache(p, jcfg, t),
                 lambda p, t: tl.llama_forward_nocache(p, tcfg, t),
                 jp, tp, remat, has_aux=False)


@pytest.mark.parametrize("remat,per_layer", [(True, 2), (False, 1)])
def test_remat_runs_each_flash_forward_twice(monkeypatch, remat, per_layer):
    """The CPU image of the card's launch check: under remat every attention
    sublayer's flash forward runs in the forward and again in the
    backward's recompute; without it, once."""
    calls = []
    real = tfa._forward
    monkeypatch.setattr(tfa, "_forward",
                        lambda *a: calls.append(1) or real(*a))
    _, tcfg, _, tp = _llama()
    init, step = make_train_step(
        lambda p, t: tl.llama_forward_nocache(p, tcfg, t), remat=remat)
    toks, tgts = _tokens(8)
    step(tp, init(tp), torch.from_numpy(toks).long(),
         torch.from_numpy(tgts).long())
    assert len(calls) == per_layer * tcfg.n_layers


def test_adam_state_carried_from_optax():
    """Two default AdamW steps in JAX, params and adam state carried across
    (adam_state_from_numpy), then one more step in each package."""
    jcfg, tcfg, jp, _ = _llama()
    toks, tgts = _tokens(9)
    j_init, j_step = j_make_train_step(
        lambda p, t: jl.llama_forward_nocache(p, jcfg, t), remat=False)
    js = j_init(jp)
    for _ in range(2):
        jp, js, _ = j_step(jp, js, toks, tgts)
    adam = jax.device_get(js[0])
    tstate = adam_state_from_numpy(adam.count, adam.mu, adam.nu, "cpu")
    assert isinstance(tstate, AdamWState) and int(tstate.count) == 2
    assert tstate.count.dtype == torch.int32
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    t_init, t_step = make_train_step(
        lambda p, t: tl.llama_forward_nocache(p, tcfg, t), remat=False)
    jp, js, jmet = j_step(jp, js, toks, tgts)
    tp, tstate, tmet = t_step(tp, tstate, torch.from_numpy(toks).long(),
                              torch.from_numpy(tgts).long())
    assert int(tstate.count) == 3
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5 * float(
        jmet["loss"])
    # the third step's update is m_hat / sqrt(v_hat) of moments that two
    # identical steps built, so it is smooth in the new gradient
    _close_leaves(tp, jp, 1e-5)
    _close_leaves(tstate.mu, js[0].mu, 1e-4)
