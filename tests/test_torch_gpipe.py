"""The port's GPipe (parallel/pipeline.py) against the reference's, in one
8-rank gloo world (tests/torch_dist.py; the workers import only the port).

The twin of tests/test_parallel.py:183 (`test_pipeline_forward_matches_
and_trains`) at ``MeshPlan(pp=4, tp=2)``, on that test's own small config
(4 layers, one a pp rank, each split over tp), 4 microbatches, remat off,
tokens (8, 12) from numpy seed 0 and the reference's init bridged by
``params_from_numpy``:

- every rank's logits of ``pipelined_llama_forward`` within 2e-4 of the
  reference's plain ``llama_forward_nocache``, as that test asserts, and
  of the reference's own pipelined forward;
- the sharded step (``train.make_train_step`` with ``mesh=``) held to the
  reference's jitted pipelined step as tests/test_torch_sharded_train.py
  holds the other twins: every rank's first-step gradient blocks within
  atol 1e-5 of ``jax.grad``'s (the embedding, final norm and head the
  same on every pp rank), loss and grad_norm within rel 1e-5 at each of 3
  steps, every rank's parameter blocks within atol 1e-5, the loss falls;
- a microbatch count that does not divide the batch refused with the
  reference's message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gofr_tpu.models.llama import LlamaConfig as JConfig
from gofr_tpu.models.llama import llama_forward_nocache, llama_init
from gofr_tpu.parallel import MeshPlan, make_mesh
from gofr_tpu.parallel.pipeline import pipelined_llama_forward
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.parallel import llama_param_specs

import torch_dist
import torch_dist_workers as workers
from test_torch_sharded_train import STEPS, held, reference_run

SMALL = dict(vocab_size=128, dim=32, n_layers=4, n_heads=2, n_kv_heads=2,
             ffn_dim=64, max_seq_len=64, dtype="float32")
N_MICRO = 4
SIZES = dict(pp=4, tp=2)


@pytest.fixture(scope="module")
def world():
    jcfg, cfg = JConfig(**SMALL), LlamaConfig(**SMALL)
    jparams = llama_init(jcfg, seed=0)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 12)).astype(np.int32)
    results = torch_dist.run_world(workers.gpipe_suite, 8,
                                   jax.device_get(jparams), cfg, tokens,
                                   N_MICRO, STEPS, timeout=240)
    mesh = make_mesh(MeshPlan(pp=4, tp=2))

    def fwd(p, t):
        return pipelined_llama_forward(p, jcfg, t, mesh, n_microbatches=N_MICRO)

    want = {"plain": np.asarray(llama_forward_nocache(jparams, jcfg,
                                                      jnp.asarray(tokens))),
            "piped": np.asarray(jax.jit(fwd)(jparams, jnp.asarray(tokens)))}
    ref = reference_run(fwd, jparams, mesh, (tokens[:, :-1], tokens[:, 1:]),
                        remat=False)
    try:
        pipelined_llama_forward(jparams, jcfg, jnp.asarray(tokens), mesh,
                                n_microbatches=N_MICRO - 1)
        want["refused"] = None
    except ValueError as exc:
        want["refused"] = str(exc)
    return results, want, ref


def test_pipeline_forward_matches_plain_forward(world):
    results, want, _ = world
    for r in results:
        np.testing.assert_allclose(r["logits"], want["plain"], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(r["logits"], want["piped"], rtol=2e-4,
                                   atol=2e-4)


def test_pipeline_step_matches_sharded_reference(world):
    results, _, ref = world
    held(results, ref, llama_param_specs(), SIZES)


def test_replicated_leaves_have_one_gradient_across_pp(world):
    results = world[0]
    for key in ("tok_emb", "final_norm", "lm_head"):
        by_tp = {}
        for r in results:
            by_tp.setdefault(r["coords"]["tp"], []).append(r["grads"][key])
        for blocks in by_tp.values():
            for b in blocks[1:]:
                np.testing.assert_array_equal(b, blocks[0], err_msg=key)


def test_indivisible_microbatches_refused_as_the_reference(world):
    results, want, _ = world
    assert want["refused"] is not None
    assert all(r["refused"] == want["refused"] for r in results)
