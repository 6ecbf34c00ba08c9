"""The port's sharded training step against the reference's, in spawned
gloo worlds (tests/torch_dist.py; the workers, tests/torch_dist_workers.py,
import only the port).

Twins of tests/test_parallel.py's sharded steps, each held to the
reference's SHARDED jitted step (``gofr_tpu.train.make_train_step`` under
``jax.jit`` on the 8 virtual CPU devices, params placed by
``shard_params``, the batch by ``NamedSharding``) on the same weights
(``params_from_numpy`` of the reference's init) and numpy batch (seed 0),
debug configs in f32:

- :55, dense at ``MeshPlan(dp=2, sp=2, tp=2)`` through
  ``parallel.make_mesh_forward`` (remat on, as the reference's default),
  tokens (4, 17), 3 steps; the same with a mask under which the dp ranks
  count different numbers of positions (sum over sum across ranks);
- :154, the MoE at ``MeshPlan(dp=2, ep=4)`` (``has_aux_loss``);
- :319, ring at ``MeshPlan(sp=8)`` and Ulysses at ``MeshPlan(dp=2, sp=4)``
  (sp divides the 4 query heads) through ``make_sp_forward``, remat off.

For each: every rank's first-step gradient blocks within atol 1e-5 of
``jax.grad``'s, the loss, aux loss, total loss and grad_norm within rel
1e-5 at each step, every rank's parameter blocks within atol 1e-5 after
each step (where the first gradient is within 1e-6 of zero but not zero,
on at most a hundredth of a leaf, within AdamW's own step bound instead:
``held_params``), and the loss falls. Two mutations of the dense run's first step
fail the same gradient check: the dp sum of the gradients dropped, and an
identity in place of the tp copy (its backward all-reduce gone). A world
of one: the sharded step on the all-ones mesh is the unsharded step bit for
bit over 2 steps, and the pipelined forward at pp=1 gives the plain
forward's logits. The GPipe twin is tests/test_torch_gpipe.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from gofr_tpu.models.llama import LlamaConfig as JConfig
from gofr_tpu.models.llama import llama_forward_nocache, llama_init
from gofr_tpu.models.moe import MoELlamaConfig as JMoEConfig
from gofr_tpu.models.moe import moe_llama_forward_nocache, moe_llama_init
from gofr_tpu.parallel import (MeshPlan, batch_spec, llama_param_specs,
                               make_mesh, shard_params)
from gofr_tpu.parallel.longcontext import make_sp_forward
from gofr_tpu.train import cross_entropy_loss, make_train_step
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.models.moe import MoELlamaConfig

import torch_dist
import torch_dist_workers as workers

GRAD_ATOL = 1e-5
PARAM_ATOL = 1e-5
METRIC_RTOL = 1e-5
LR = 3e-4            # the default AdamW's learning rate, both packages
TINY_GRAD = 1e-6     # held_params: a first gradient this close to 0
TINY_SHARE = 1e-2    # ... on at most this share of a leaf
STEPS = 3
METRICS = ("loss", "aux_loss", "total_loss", "grad_norm")


def _batch(vocab, B, T, seed=0):
    data = np.random.default_rng(seed).integers(0, vocab, (B, T + 1))
    return data[:, :-1].astype(np.int32), data[:, 1:].astype(np.int32)


def reference_run(fwd, params, mesh, batch, mask=None, *, specs=None,
                  data_spec=None, has_aux=False, remat=True, steps=STEPS):
    """The reference's sharded jitted step: jax.grad's gradients of the
    first step, then `steps` steps' metrics and parameters (numpy)."""
    # a copy: the jitted step donates what it is given (a placed leaf may
    # share the caller's buffer)
    params = jax.tree_util.tree_map(jnp.copy, params)
    if specs is not None:
        params = shard_params(params, mesh, specs)
    place = (lambda x: x) if data_spec is None else (
        lambda x: jax.device_put(jnp.asarray(x),
                                 NamedSharding(mesh, data_spec)))
    tokens, targets = (place(x) for x in batch)
    mask = None if mask is None else place(mask)

    def total(p):
        out = fwd(p, tokens)
        if has_aux:
            logits, aux = out
            return cross_entropy_loss(logits, targets, mask) + 0.01 * aux
        return cross_entropy_loss(out, targets, mask)

    grads = jax.device_get(jax.jit(jax.grad(total))(params))
    init, step = make_train_step(fwd, has_aux_loss=has_aux, remat=remat)
    opt = init(params)
    step = jax.jit(step, donate_argnums=(0, 1))
    metrics, snaps = [], []
    for _ in range(steps):
        params, opt, m = step(params, opt, tokens, targets, mask)
        metrics.append({k: float(m[k]) for k in METRICS})
        snaps.append(jax.device_get(params))
    return {"grads": grads, "metrics": metrics, "params": snaps}


def _block(x, spec, coords, sizes):
    """This rank's block of the global array x under spec."""
    x = np.asarray(x)
    for dim, axis in enumerate(spec):
        n = sizes.get(axis, 1) if axis is not None else 1
        if n > 1:
            size = x.shape[dim] // n
            x = np.take(x, range(coords[axis] * size,
                                 (coords[axis] + 1) * size), axis=dim)
    return x


def _leaves(got, want, spec, path=""):
    if isinstance(got, dict):
        for k in got:
            yield from _leaves(got[k], want[k],
                               spec.get(k, ()) if isinstance(spec, dict)
                               else (), f"{path}/{k}")
    else:
        yield path, got, want, spec


def held_tree(got, want, specs, coords, sizes, atol, what):
    for path, g, w, spec in _leaves(got, want, specs):
        np.testing.assert_allclose(
            g, _block(w, spec, coords, sizes), rtol=0, atol=atol,
            err_msg=f"{what} {path} at {coords}")


def held_params(got, want, grads, specs, coords, sizes, what):
    """Parameter blocks within PARAM_ATOL, except where the reference's
    first gradient is within TINY_GRAD of 0 but not 0: AdamW's first update
    there is lr * g / (|g| + 1e-8), so a gradient gap of ~1e-9 (f32
    summation order) moves it by a few percent of lr = 3e-4. Those
    elements (at most TINY_SHARE of a leaf) are held within the update's
    own bound, 2 * lr."""
    for path, g, w, spec in _leaves(got, want, specs):
        w = _block(w, spec, coords, sizes)
        gref = _block(_at(grads, path), spec, coords, sizes)
        tiny = (np.abs(gref) < TINY_GRAD) & (gref != 0)
        assert tiny.mean() <= TINY_SHARE, (path, tiny.mean())
        np.testing.assert_allclose(g[~tiny], w[~tiny], rtol=0,
                                   atol=PARAM_ATOL,
                                   err_msg=f"{what} {path} at {coords}")
        np.testing.assert_allclose(g[tiny], w[tiny], rtol=0, atol=2 * LR,
                                   err_msg=f"{what} {path} at {coords}")


def _at(tree, path):
    for key in path.strip("/").split("/"):
        tree = tree[key]
    return tree


def held(results, ref, specs, sizes, steps=STEPS):
    """Every rank's run against the reference's (the module docstring)."""
    for r in results:
        c = r["coords"]
        held_tree(r["grads"], ref["grads"], specs, c, sizes, GRAD_ATOL,
                  "grad")
        assert len(r["metrics"]) == steps
        for i, (got, want) in enumerate(zip(r["metrics"], ref["metrics"])):
            for k in METRICS:
                np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                           err_msg=f"{k} step {i} at {c}")
            held_params(r["params"][i], ref["params"][i], ref["grads"],
                        specs, c, sizes, f"param step {i}")
    losses = [m["loss"] for m in results[0]["metrics"]]
    assert losses[-1] < losses[0], losses


CFG = LlamaConfig.debug()
JCFG = JConfig.debug()
MOE = MoELlamaConfig.debug()
JMOE = JMoEConfig.debug()
DENSE_SIZES = dict(dp=2, sp=2, tp=2)


@pytest.fixture(scope="module")
def dense():
    jparams = llama_init(JCFG, seed=0)
    batch = _batch(CFG.vocab_size, 4, 16)
    # dp rank 0 (rows 0-1) counts every position, dp rank 1 only the
    # first 5 of its rows'; sp splits each row at 8
    mask = np.ones((4, 16), np.float32)
    mask[2:, 5:] = 0.0
    results = torch_dist.run_world(workers.dense_train_suite, 8,
                                   jax.device_get(jparams), CFG, batch, mask,
                                   STEPS, timeout=240)
    mesh = make_mesh(MeshPlan(dp=2, sp=2, tp=2))

    def fwd(p, t):
        return llama_forward_nocache(p, JCFG, t)

    kw = dict(specs=llama_param_specs(), data_spec=batch_spec())
    refs = {"plain": reference_run(fwd, jparams, mesh, batch, **kw),
            "masked": reference_run(fwd, jparams, mesh, batch, mask, **kw)}
    return results, refs


def test_dense_dp_sp_tp_step_matches_sharded_reference(dense):
    results, refs = dense
    held([r["plain"] for r in results], refs["plain"], llama_param_specs(),
         DENSE_SIZES)


def test_masked_loss_is_the_global_mean_across_dp(dense):
    results, refs = dense
    held([r["masked"] for r in results], refs["masked"],
         llama_param_specs(), DENSE_SIZES)


@pytest.mark.parametrize("mutation", ["no_dp", "tp_identity"])
def test_mutation_fails_the_twin(dense, mutation):
    """The same gradient check as the twin, on the dense run's first step
    with one fault put in: it must fail."""
    results, refs = dense
    with pytest.raises(AssertionError):
        for r in results:
            held_tree(r[mutation]["grads"], refs["plain"]["grads"],
                      llama_param_specs(), r[mutation]["coords"],
                      DENSE_SIZES, GRAD_ATOL, "grad")


def test_moe_dp_ep_step_matches_sharded_reference():
    jparams = moe_llama_init(JMOE, seed=0)
    batch = _batch(MOE.vocab_size, 4, 16)
    results = torch_dist.run_world(workers.moe_train_suite, 8,
                                   jax.device_get(jparams), MOE, batch,
                                   STEPS, timeout=240)
    mesh = make_mesh(MeshPlan(dp=2, ep=4))
    specs = llama_param_specs(moe=True)
    ref = reference_run(lambda p, t: moe_llama_forward_nocache(p, JMOE, t),
                        jparams, mesh, batch, specs=specs,
                        data_spec=PartitionSpec("dp", None), has_aux=True)
    held(results, ref, specs, dict(dp=2, ep=4))
    assert all(m["aux_loss"] > 0 for m in results[0]["metrics"])


@pytest.fixture(scope="module")
def seq():
    jparams = llama_init(JCFG, seed=0)
    batch = _batch(CFG.vocab_size, 2, 32)
    results = torch_dist.run_world(workers.sp_train_suite, 8,
                                   jax.device_get(jparams), CFG, batch,
                                   STEPS, timeout=240)
    refs = {}
    for attn, plan in (("ring", MeshPlan(sp=8)),
                       ("ulysses", MeshPlan(dp=2, sp=4))):
        mesh = make_mesh(plan)
        refs[attn] = reference_run(make_sp_forward(JCFG, mesh, attn=attn),
                                   jparams, mesh, batch, remat=False)
    return results, refs


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_sequence_parallel_step_matches_sharded_reference(seq, attn):
    results, refs = seq
    # the parameters are replicated: every rank holds the whole tree
    held([r[attn] for r in results], refs[attn], {}, {})


def test_world_of_one_is_the_unsharded_step_bit_for_bit():
    jparams = llama_init(JCFG, seed=0)
    batch = _batch(CFG.vocab_size, 4, 16)
    (runs,) = torch_dist.run_world(workers.one_rank_train, 1,
                                   jax.device_get(jparams), CFG, batch, 2,
                                   timeout=120)
    for (m_s, p_s), (m_p, p_p) in zip(runs["sharded"], runs["plain"]):
        for k in METRICS:
            assert np.array_equal(m_s[k], m_p[k]), k
        for path, g, w, _ in _leaves(p_s, p_p, {}):
            assert np.array_equal(g, w), path
    np.testing.assert_allclose(runs["piped"], runs["plain_logits"],
                               rtol=2e-4, atol=2e-4)
