"""Port sampling: greedy is argmax, sampled tokens stay inside the filters.

torch's generator cannot replay jax.random, so sampled rows are held to the
set the top_k / top_p filters allow (and to the distribution's shape), not
to JAX's tokens; greedy rows must equal JAX's `sample_tokens`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.tpu.sampling import sample_tokens as jax_sample
from gofr_tpu_torch.tpu.sampling import sample_tokens


def _logits(seed, B=6, V=64):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(
        np.float32) * 3


def test_greedy_is_argmax_and_matches_jax():
    logits = _logits(0)
    temps = np.zeros(6, dtype=np.float32)
    got = sample_tokens(torch.from_numpy(logits), torch.Generator().manual_seed(0),
                        torch.from_numpy(temps))
    want, _ = jax_sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                         jnp.asarray(temps))
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mixed_rows_greedy_rows_stay_greedy():
    logits = _logits(1)
    temps = np.array([0, 1.0, 0, 0.7, 0, 2.0], dtype=np.float32)
    gen = torch.Generator().manual_seed(3)
    for _ in range(20):
        got = sample_tokens(torch.from_numpy(logits), gen,
                            torch.from_numpy(temps)).numpy()
        np.testing.assert_array_equal(got[temps <= 0],
                                      logits.argmax(-1)[temps <= 0])


@pytest.mark.parametrize("top_k", [1, 5])
def test_top_k_draws_stay_in_the_top_k(top_k):
    logits = _logits(2)
    allowed = np.argsort(-logits, axis=-1)[:, :top_k]
    temps = torch.full((6,), 1.5)
    gen = torch.Generator().manual_seed(7)
    for _ in range(200):
        got = sample_tokens(torch.from_numpy(logits), gen, temps,
                            top_k=top_k).numpy()
        assert all(got[b] in allowed[b] for b in range(6))


@pytest.mark.parametrize("top_p", [0.3, 0.9])
def test_top_p_draws_stay_in_the_nucleus(top_p):
    logits = _logits(3)
    temps = np.ones(6, dtype=np.float32)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    order = np.argsort(-probs, axis=-1)
    allowed = []
    for b in range(6):
        cum = np.cumsum(probs[b, order[b]])
        n = int(np.sum(cum < top_p)) + 1        # smallest prefix >= top_p
        allowed.append(set(order[b, :n].tolist()))
    gen = torch.Generator().manual_seed(11)
    seen = [set() for _ in range(6)]
    for _ in range(300):
        got = sample_tokens(torch.from_numpy(logits), gen,
                            torch.from_numpy(temps), top_p=top_p).numpy()
        for b in range(6):
            assert got[b] in allowed[b]
            seen[b].add(int(got[b]))
    # the draw is random: rows with more than one allowed token vary
    assert any(len(s) > 1 for s, a in zip(seen, allowed) if len(a) > 1)


def test_sampled_frequencies_follow_the_softmax():
    logits = np.array([[2.0, 1.0, 0.0, -1.0]], dtype=np.float32)
    probs = np.exp(logits[0]) / np.exp(logits[0]).sum()
    gen = torch.Generator().manual_seed(5)
    n = 20000
    got = sample_tokens(torch.from_numpy(np.repeat(logits, n, axis=0)), gen,
                        torch.ones(n)).numpy()
    freq = np.bincount(got, minlength=4) / n
    np.testing.assert_allclose(freq, probs, atol=0.02)
