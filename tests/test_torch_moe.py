"""The port's MoE Llama vs the JAX package on the CPU.

``MoELlamaConfig`` and ``moe_llama_init`` against the reference's presets
and shapes; ``moe_llama_forward_nocache``'s loss, aux loss and gradients
against ``jax.value_and_grad`` on the same bridged weights; three SGD train
steps with ``has_aux_loss``, remat on and off. The inputs keep the router's
K-th and (K+1)-th probabilities apart: ``torch.topk`` orders ties as
``jax.lax.top_k`` does not, and the gates depend only on the chosen set.
Tolerances as tests/test_torch_train.py: 1e-5 of each leaf's largest
gradient, 1e-5 relative on the losses.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jl
from gofr_tpu.models import moe as jm
from gofr_tpu.train import cross_entropy_loss as j_ce
from gofr_tpu_torch import tree
from gofr_tpu_torch.models import moe as tm
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.train import cross_entropy_loss

from test_torch_train import _check_steps, _close_leaves, _grads, _tokens


def _moe():
    jcfg = dataclasses.replace(jm.MoELlamaConfig.debug(), attn_impl="flash")
    tcfg = dataclasses.replace(tm.MoELlamaConfig.debug(), attn_impl="flash")
    jp = jm.moe_llama_init(jcfg, seed=0)
    return jcfg, tcfg, jp, params_from_numpy(jax.device_get(jp), "cpu")


def test_moe_forward_and_grads_match_jax():
    jcfg, tcfg, jp, tp = _moe()
    toks, tgts = _tokens(4)
    # no tie at the K-th place: torch.topk orders ties as jax.lax.top_k
    # does not, and the gates depend on the chosen set alone
    x = jp["tok_emb"][toks]
    normed = jl.rms_norm(x, jp["layers"]["ffn_norm"][0], jcfg.rms_eps)
    probs = np.sort(np.asarray(jax.nn.softmax(
        normed @ jp["layers"]["w_router"][0], axis=-1)), axis=-1)[..., ::-1]
    K = jcfg.experts_per_token
    assert float((probs[..., K - 1] - probs[..., K]).min()) > 1e-6

    def jloss(p):
        logits, aux = jm.moe_llama_forward_nocache(p, jcfg, toks)
        return j_ce(logits, tgts) + 0.01 * aux, aux

    (want, want_aux), want_g = jax.value_and_grad(jloss, has_aux=True)(jp)
    got_aux = []

    def tloss(p):
        logits, aux = tm.moe_llama_forward_nocache(
            p, tcfg, torch.from_numpy(toks).long())
        got_aux.append(aux)
        return cross_entropy_loss(logits, torch.from_numpy(tgts)) + 0.01 * aux

    got, got_g = _grads(tloss, tp)
    assert abs(float(got) - float(want)) <= 1e-5 * float(want)
    assert abs(float(got_aux[0]) - float(want_aux)) <= 1e-5 * float(want_aux)
    _close_leaves(got_g, want_g, 1e-5)


def test_moe_config_and_init_match_jax():
    cfg, jcfg = tm.MoELlamaConfig.debug(), jm.MoELlamaConfig.debug()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (tm.MoELlamaConfig().n_experts,
            tm.MoELlamaConfig().experts_per_token) == (8, 2)
    got = tm.moe_llama_init(cfg, seed=0, device="cpu")
    want = jm.moe_llama_init(jcfg, seed=0)
    paths, leaves = tree.flatten_with_paths(got)
    assert [tuple(t.shape) for t in leaves] == [
        x.shape for x in jax.tree.leaves(want)]
    assert [str(t.dtype)[6:] for t in leaves] == [
        str(x.dtype) for x in jax.tree.leaves(want)]
    # the recipe: unit norms, matrices at 1/sqrt(fan_in)
    assert torch.equal(got["layers"]["ffn_norm"], torch.ones(2, 64))
    std = float(got["layers"]["w_down"].std())
    assert abs(std - 1 / np.sqrt(cfg.ffn_dim)) < 0.1 / np.sqrt(cfg.ffn_dim)


@pytest.mark.parametrize("remat", [True, False])
def test_moe_train_steps_match_jax(remat):
    jcfg, tcfg, jp, tp = _moe()
    _check_steps(lambda p, t: jm.moe_llama_forward_nocache(p, jcfg, t),
                 lambda p, t: tm.moe_llama_forward_nocache(p, tcfg, t),
                 jp, tp, remat, has_aux=True)
