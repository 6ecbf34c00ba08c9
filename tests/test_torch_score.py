"""Port post-hoc scoring passes (tpu/score.py) vs the JAX package.

Ports tests/test_logprobs.py but for the cases that wait on int8 weights
(ROADMAP A13), the tensor-parallel mesh (A14) and the OpenAI routes (A17).
The same weights (llama_init(debug, seed=0), f32, bridged by
params_from_numpy) and the same token ids go through JAX's and the port's
`score_tokens` / `embed_tokens`:

- chosen logprobs and top-K logprobs within TOL (f32 forward over 2 layers;
  the two differ by summation order only, as tests/test_torch_llama.py
  holds logits to 1e-4), and the top-K ids equal wherever JAX's neighbouring
  top logprobs are more than TOL apart (below that the order of a near tie
  may differ);
- a sequence whose windows cross a boundary (bucket 256, W = 128);
- embeddings within TOL, windowed or not;
- a greedy generation scores itself top-1; the paged engines, an int8-KV
  one too, score in the model dtype (f32 here), so they give the dense
  engine's numbers exactly;
- the validation errors give JAX's messages;
- scoring and embedding from another thread while the loop serves leaves
  the streams as they are without it;
- warmup_scoring makes one program per bucket and family, named as JAX's,
  and WARMUP_SCORE=true boots through serve.build_engine with them;
- the stacked cache (init_kv_cache) and llama_decode_step_inplace equal
  JAX's.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jl
from gofr_tpu.tpu.engine import LLMEngine as JEngine
from gofr_tpu_torch.models import llama as tl
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.serve import build_engine
from gofr_tpu_torch.tpu.engine import LLMEngine
from gofr_tpu_torch.tpu.executor import Executor
from gofr_tpu_torch.tpu.paging import PagedLLMEngine
from test_torch_prefill_graphs import _graph_like

CFG_J = jl.LlamaConfig.debug()
CFG_T = tl.LlamaConfig.debug()
ENGINE = dict(n_slots=2, max_seq_len=256, prefill_buckets=(16, 32, 64, 256))
TOL = 1e-4


class _QuietLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


@pytest.fixture(scope="module")
def weights():
    jparams = jl.llama_init(CFG_J, seed=0)
    return jparams, params_from_numpy(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def engines(weights):
    """(the JAX LLMEngine, the port's), neither started: a pass needs no
    loop."""
    return (JEngine(weights[0], CFG_J, logger=_QuietLogger(), **ENGINE),
            LLMEngine(weights[1], CFG_T, device="cpu", **ENGINE))


def _seq(seed, P, C):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, CFG_T.vocab_size, size=P).tolist(),
            rng.integers(1, CFG_T.vocab_size, size=C).tolist())


def _assert_scores_close(got, want, top):
    chosen, ids, lps = got
    w_chosen, w_ids, w_lps = (np.asarray(a) for a in want)
    assert chosen.shape == w_chosen.shape and ids.shape == w_ids.shape
    np.testing.assert_allclose(chosen, w_chosen, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lps, w_lps, rtol=TOL, atol=TOL)
    # ids are compared where JAX's ranking is not a near tie
    clear = np.ones(w_ids.shape, dtype=bool)
    gaps = np.abs(np.diff(w_lps, axis=1)) > TOL
    clear[:, :-1] &= gaps
    clear[:, 1:] &= gaps
    np.testing.assert_array_equal(ids[clear], w_ids[clear])


@pytest.mark.parametrize("P, C, top", [(7, 9, 4), (120, 40, 3), (1, 15, 20)],
                         ids=["one-window", "crosses-a-window", "max-top"])
def test_score_matches_jax(engines, P, C, top):
    """One window (bucket 16), two (bucket 256, W = 128: the seam at 128),
    and the largest top over a one-token prompt."""
    jeng, teng = engines
    prompt, completion = _seq(P + C, P, C)
    got = teng.score(prompt, completion, top=top)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int64
    _assert_scores_close(got, jeng.score(prompt, completion, top=top), top)


@pytest.mark.parametrize("L", [5, 140], ids=["one-window", "windowed"])
def test_embed_matches_jax(engines, L):
    jeng, teng = engines
    toks = np.random.default_rng(L).integers(1, CFG_T.vocab_size,
                                             size=L).tolist()
    got = teng.embed(toks)
    assert got.shape == (CFG_T.dim,) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jeng.embed(toks)), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got), 1.0, rtol=1e-5)
    raw = teng.embed(toks, normalize=False)
    np.testing.assert_allclose(raw, np.asarray(jeng.embed(toks,
                                                          normalize=False)),
                               rtol=TOL, atol=TOL)


def test_score_validation_gives_the_jax_messages(engines):
    cases = [(([1, 2], []), {}), (([], [1]), {}), (([1], [2]), {"top": 0}),
             (([1], [2]), {"top": 21}), (([1] * 300, [2]), {})]
    msgs = []
    for eng in engines:
        out = []
        for args, kw in cases:
            with pytest.raises(ValueError) as err:
                eng.score(*args, **kw)
            out.append(str(err.value))
        for toks in ([], [1] * 300):
            with pytest.raises(ValueError) as err:
                eng.embed(toks)
            out.append(str(err.value))
        msgs.append(out)
    assert msgs[1] == msgs[0]


def test_greedy_generation_scores_itself_top1(weights):
    eng = LLMEngine(weights[1], CFG_T, device="cpu", **ENGINE)
    eng.start()
    try:
        prompt = [3, 1, 4, 1, 5]
        tokens = eng.generate(prompt, max_new_tokens=8, temperature=0.0)
        chosen, ids, lps = eng.score(prompt, tokens, top=2)
    finally:
        eng.stop()
    np.testing.assert_array_equal(ids[:, 0], tokens)
    np.testing.assert_allclose(chosen, lps[:, 0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["paged", "paged-int8"])
def test_paged_engines_score_in_the_model_dtype(weights, engines, kv):
    """The paged engines score through the same pass: in the model dtype
    whatever the serving kv_dtype, so equal to the dense engine's numbers
    bit for bit; the paged engine in the model dtype's greedy generation
    scores itself top-1."""
    cfg = dataclasses.replace(CFG_T, kv_dtype=kv)
    eng = PagedLLMEngine(weights[1], cfg, device="cpu", page_size=16,
                         **ENGINE)
    eng.start()
    try:
        prompt = [3, 1, 4]
        tokens = eng.generate(prompt, max_new_tokens=6, temperature=0.0)
        got = eng.score(prompt, tokens, top=3)
        assert eng.embed(prompt + tokens).shape == (CFG_T.dim,)
    finally:
        eng.stop()
    want = engines[1].score(prompt, tokens, top=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if kv is None:
        np.testing.assert_array_equal(got[1][:, 0], tokens)


def test_score_and_embed_while_the_engine_serves(weights, engines):
    """Passes from another thread while the loop decodes: the streams are
    the ones served without them, and the passes give the idle engine's
    numbers."""
    prompts = [[9, 8, 7], [2, 7, 1, 8, 2, 8]]

    def serve(passes):
        eng = LLMEngine(weights[1], CFG_T, device="cpu", **ENGINE)
        eng.start()
        out, errors = [], []

        def score_loop():
            try:
                for i in range(passes):
                    out.append(eng.score([3, 1, 4, 1, 5], [9, 2, 6 + i],
                                         top=2))
                    out.append(eng.embed([5, 4, 3, 2, 1 + i]))
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(exc)

        try:
            reqs = [eng.submit(p, max_new_tokens=24) for p in prompts]
            scorer = threading.Thread(target=score_loop)
            scorer.start()
            streams = [r.result(timeout_s=120) for r in reqs]
            scorer.join(timeout=120)
            assert not scorer.is_alive() and not errors, errors
        finally:
            eng.stop()
        return streams, out

    quiet, _ = serve(0)
    busy, passes = serve(4)
    assert busy == quiet and len(passes) == 8
    idle = engines[1]
    for i in range(4):
        for a, b in zip(passes[2 * i], idle.score([3, 1, 4, 1, 5],
                                                  [9, 2, 6 + i], top=2)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(passes[2 * i + 1],
                                      idle.embed([5, 4, 3, 2, 1 + i]))


def test_warmup_scoring_makes_one_program_per_bucket_and_family(weights):
    """warmup_scoring's programs are JAX's by name; under a capture stub
    (each program one overwritten output, as a graph's) the later passes,
    at every bucket and top, capture nothing and give the eager engine's
    numbers."""
    jeng = JEngine(weights[0], CFG_J, logger=_QuietLogger(), n_slots=2,
                   max_seq_len=64, prefill_buckets=(16, 32))
    assert jeng.warmup_scoring() == 4
    want = {n for n in jeng.executor.cache_info()
            if n.startswith(("score", "embed"))}
    eng = LLMEngine(weights[1], CFG_T, device="cpu", n_slots=2,
                    max_seq_len=64, prefill_buckets=(16, 32))
    eng.executor = Executor("cpu", capture=_graph_like)
    assert eng.warmup_scoring() == 4
    assert set(eng.executor.compiled) == want == {
        "score-16x16", "embed-16x16", "score-32x32", "embed-32x32"}
    captures = eng.executor.captures
    eager = LLMEngine(weights[1], CFG_T, device="cpu", n_slots=2,
                      max_seq_len=64, prefill_buckets=(16, 32))
    for args, top in [(([1, 2, 3], [4, 5]), 1), (([1, 2, 3], [4, 5]), 5),
                      (([1] * 20, [9] * 8), 20)]:
        for a, b in zip(eng.score(*args, top=top),
                        eager.score(*args, top=top)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(eng.embed([7, 8, 9]),
                                  eager.embed([7, 8, 9]))
    assert eng.executor.captures == captures


@pytest.mark.parametrize("paged", ["true", "false"])
def test_warmup_score_boots_with_the_score_family(weights, paged):
    env = {"MODEL_PRESET": "debug", "MAX_BATCH": "2", "MAX_SEQ_LEN": "64",
           "PREFILL_BUCKETS": "8,16", "PAGE_SIZE": "8", "PAGED": paged,
           "DECODE_ATTN": "kernel", "WARMUP": "false", "WARMUP_SCORE": "true"}
    eng = build_engine(env, device="cpu", params=weights[1])
    try:
        names = set(eng.executor.cache_info())
        assert names == {f"{f}-{b}x{b}" for f in ("score", "embed")
                         for b in (8, 16)}
        assert eng.score_warmup_seconds > 0.0
        assert len(eng.generate([5, 6, 7], max_new_tokens=3)) == 3
    finally:
        eng.stop()


def test_flash_windows_equal_the_plain_read(weights, engines):
    """At buckets <= 128 a window is the whole bucket, so under
    attn_impl="flash" its attention is flash (its plain version on the
    CPU): the same numbers as the masked read within TOL."""
    cfg = dataclasses.replace(CFG_T, attn_impl="flash")
    eng = LLMEngine(weights[1], cfg, device="cpu", **ENGINE)
    for P, C in [(7, 9), (40, 20)]:
        prompt, completion = _seq(P, P, C)
        got = eng.score(prompt, completion, top=5)
        want = engines[1].score(prompt, completion, top=5)
        np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[2], want[2], rtol=TOL, atol=TOL)


def test_init_kv_cache_and_decode_step_inplace_match_jax(weights):
    jparams, tparams = weights
    jk, jv = jl.init_kv_cache(CFG_J, 3, 32)
    tk, tv = tl.init_kv_cache(CFG_T, 3, 32, device="cpu")
    assert tuple(tk.shape) == jk.shape and tk.dtype == torch.float32
    assert not tk.any() and not tv.any()
    rng = np.random.default_rng(0)
    # a filled context: positions 0..p-1 of each row hold random K/V
    kv = rng.standard_normal((2,) + jk.shape).astype(np.float32) * 0.3
    tokens = np.asarray([5, 9, 2], dtype=np.int32)
    positions = np.asarray([3, 17, 30], dtype=np.int32)
    logits, jk2, jv2 = jl.llama_decode_step_inplace(
        jparams, CFG_J, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(kv[0]), jnp.asarray(kv[1]))
    tk.copy_(torch.from_numpy(kv[0]))
    tv.copy_(torch.from_numpy(kv[1]))
    got, tk2, tv2 = tl.llama_decode_step_inplace(
        tparams, CFG_T, torch.from_numpy(tokens).long(),
        torch.from_numpy(positions).long(), tk, tv)
    assert tk2 is tk and tv2 is tv          # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk2), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv2), atol=1e-5)


def test_executor_compile_is_safe_under_threads():
    """16 threads compile 4 names at once (a stub capture that gives the
    interpreter away mid-capture) while 2 more read the cache, with a short
    switch interval: each name is captured once, every thread gets the same
    program for a name, and no reader fails."""
    import sys
    import time

    captured = []

    def capture(fn, inputs):
        captured.append(1)
        time.sleep(0.002)
        return lambda: fn(*inputs)

    ex = Executor("cpu", capture=capture)
    got = [[] for _ in range(16)]
    errors = []
    stop = threading.Event()

    def compiler(i):
        for k in range(40):
            got[i].append(ex.compile(f"p{k % 4}", lambda: torch.zeros(1)))

    def reader():
        while not stop.is_set():
            try:
                ex.cache_info()
                ex.cache_size()
            except RuntimeError as exc:   # a dict changed mid-iteration
                errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        readers = [threading.Thread(target=reader) for _ in range(2)]
        workers = [threading.Thread(target=compiler, args=(i,))
                   for i in range(16)]
        for t in readers + workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        stop.set()
        for t in readers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in readers + workers)
    assert not errors
    assert len(captured) == ex.captures == 4
    assert sorted(ex.compiled) == ["p0", "p1", "p2", "p3"]
    first = {p.name: p for p in got[0]}
    assert all(p is first[p.name] for g in got for p in g)
