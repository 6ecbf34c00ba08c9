"""Port speculative decoding vs the JAX package (ROADMAP A10).

- `propose_draft`: the port's native scan, the engine's Python scan and
  the reference's native scan agree on histories drawn by hypothesis. The
  reference's scan is `gofr_tpu/native/gofr_native.cc`'s
  `gn_propose_draft`, built by a module fixture into a directory of its
  own with the reference loader's flags (tmp file, then rename) and bound
  by ctypes as `gofr_tpu.native` binds it: that loader builds its library
  in place from every process that imports it first, and one that loses
  the race gives up for the whole process, so its `available()` may be
  False under xdist. A second test shows the fixture's comparison runs
  with the reference loader's `available()` forced False.
- `spec_accept_epilogue` against JAX's on the same greedy continuations,
  drafts and controls ([B] and [B, 3]; partial drafts, draft_lens 0, junk
  rows): accepted counts, emit counts and greedy rows' tokens exact.
- `llama_verify_step` and `llama_verify_step_paged` against JAX on the same
  numpy inputs (weights bridged by `params_from_numpy`): greedy equal,
  logits0 within 1e-4, caches and pools within 1e-5; the paged window
  includes a junk draft row, a window crossing a page boundary and one
  running past its reservation into page 0.
- The engines, the twins of tests/test_speculative.py and of the
  speculative cases of tests/test_sampling_controls.py: every greedy stream
  of a speculative port engine (dense, paged, paged with the prefix cache,
  with sampling controls) equals the JAX plain engine's, token for token,
  on the same weights; the goldens are computed live, once per module.
- The verify graph against eager (the CPU capture stub), the warm-up's
  verify names against the JAX executor's, and SPECULATIVE_TOKENS served
  through `serve.build_engine` (refused beside KV_DTYPE=int8 and
  CHUNK_PREFILL_TOKENS, with the reference's message).
"""

import ctypes
import dataclasses
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gofr_tpu import native as jnative
from gofr_tpu.models import llama as jl
from gofr_tpu.tpu import engine as jengine
from gofr_tpu.tpu.engine import LLMEngine as JEngine
from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
from gofr_tpu_torch import native
from gofr_tpu_torch.models import llama as tl
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.serve import build_engine
from gofr_tpu_torch.tpu import graphcheck
from gofr_tpu_torch.tpu.engine import (GenerationRequest, LLMEngine,
                                       spec_accept_epilogue)
from gofr_tpu_torch.tpu.executor import Executor
from gofr_tpu_torch.tpu.paging import PagedLLMEngine

CFG_J = jl.LlamaConfig.debug()
CFG_T = tl.LlamaConfig.debug()
ENGINES = [LLMEngine, PagedLLMEngine]

# tests/test_speculative.py's prompts: with self-repetition (bigram drafts
# exist) and without
PROMPTS = [
    [5, 6, 7, 8, 5, 6, 7, 8, 5, 6],
    [9, 8, 7, 6, 5],
    list(range(1, 30)) + list(range(1, 10)),
    [11, 12, 11, 12, 11, 12, 11],
]
LONG = [3, 1, 4, 1, 5, 9, 2, 6, 3, 1, 4, 1, 5]
SYSTEM = list(range(60, 60 + 32))       # two full 16-token pages
SHARED = [SYSTEM + [40 + i, 41 + i, 42 + i] for i in range(4)]
ENGINE = dict(n_slots=4, max_seq_len=128, prefill_buckets=(8, 32, 64),
              decode_block_size=4)


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
def plain(weights):
    """The JAX plain engine's greedy streams of every scenario, computed
    once: (prompts, max_new) -> streams."""
    eng = JEngine(weights[0], CFG_J, logger=_QuietLogger(), n_slots=4,
                  max_seq_len=256, prefill_buckets=(8, 32, 64),
                  decode_block_size=4)
    eng.start()
    out = {}
    try:
        for key, prompts, n in (("prompts", PROMPTS, 24),
                                ("long", [LONG], 48),
                                ("shared", SHARED, 20),
                                ("periodic", PROMPTS[:2], 64)):
            reqs = [eng.submit(p, max_new_tokens=n, temperature=0.0)
                    for p in prompts]
            out[key] = [r.result(timeout_s=300) for r in reqs]
    finally:
        eng.stop()
    return out


def _serve(tparams, prompts, max_new, cls=LLMEngine, temperature=0.0,
           **kw):
    """(streams, engine) of a port engine whose requests were all queued
    before its loop started (so its dispatches do not hang on the client's
    timing), then stopped."""
    extra = {"page_size": 16} if cls is PagedLLMEngine else {}
    eng = cls(tparams, CFG_T, device="cpu", **{**ENGINE, **extra, **kw})
    reqs = [eng.submit(p, max_new_tokens=max_new, temperature=temperature)
            for p in prompts]
    eng.start()
    try:
        return [r.result(timeout_s=300) for r in reqs], eng
    finally:
        eng.stop()


# -- propose_draft -----------------------------------------------------------

def _python_scan(history, d):
    eng = LLMEngine.__new__(LLMEngine)
    eng.speculative_tokens = d
    eng._native_propose = None
    return eng._propose_draft(history)


_I32P = ctypes.POINTER(ctypes.c_int32)


@pytest.fixture(scope="module")
def reference_scan(tmp_path_factory):
    """The reference's native prompt-lookup scan as a function (history,
    d) -> list, as `gofr_tpu.native.propose_draft` calls it, from a library
    this fixture builds from the reference's source with its loader's
    compiler and flags into a directory of its own: written to a tmp file,
    then renamed into place, so no other process sees half a file."""
    src = os.path.join(os.path.dirname(jnative.__file__), "gofr_native.cc")
    out_dir = tmp_path_factory.mktemp("reference_native")
    lib_path = out_dir / "libgofr_native.so"
    tmp = out_dir / f"libgofr_native.so.{os.getpid()}.tmp"
    subprocess.run([os.environ.get("CXX", "g++"), "-O3", "-std=c++17",
                    "-fPIC", "-shared", "-o", str(tmp), src], check=True,
                   capture_output=True, timeout=120)
    os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.gn_propose_draft.restype = ctypes.c_int32
    lib.gn_propose_draft.argtypes = [_I32P, ctypes.c_int32, ctypes.c_int32,
                                     _I32P]

    def scan(history, d):
        # gofr_tpu/native/__init__.py's propose_draft, over this library
        n = len(history)
        if n < 3 or d <= 0:
            return []
        hist = np.ascontiguousarray(np.asarray(history, dtype=np.int32))
        out = np.empty(d, dtype=np.int32)
        count = lib.gn_propose_draft(hist.ctypes.data_as(_I32P), n, d,
                                     out.ctypes.data_as(_I32P))
        return out[:count].tolist()

    return scan


def _three_scans_agree(history, d, reference_scan):
    assert native.available()
    got = native.propose_draft(history, d)
    assert got == _python_scan(history, d) == reference_scan(history, d)
    assert len(got) <= d


@settings(max_examples=200, deadline=None)
@given(history=st.lists(st.integers(0, 5), max_size=40),
       d=st.integers(0, 6))
def test_propose_draft_native_equals_python_and_jax(history, d,
                                                    reference_scan):
    _three_scans_agree(history, d, reference_scan)


def test_reference_scan_holds_without_the_reference_loader(
        reference_scan, monkeypatch):
    """With gofr_tpu.native's loader in the state of a process that lost
    its build race (no library, the attempt spent), the comparison still
    runs against the reference's scan, and still catches a scan that
    differs."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_load_attempted", True)
    assert not jnative.available()
    history = [1, 2, 3, 1, 2, 4, 5, 1, 2]
    assert reference_scan(history, 3) == [4, 5, 1]
    _three_scans_agree(history, 3, reference_scan)
    with pytest.raises(AssertionError):
        _three_scans_agree(history, 3, lambda h, d: reference_scan(h, d)[:1])


# -- spec_accept_epilogue ----------------------------------------------------

D, B, V = 4, 6, 32


def _epilogue_inputs(seed, controls):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, V, (B, D + 1)).astype(np.int32)
    drafts = g[:, :D].copy()
    # row 0 matches all, row 1 mismatches at 2, row 2 drafts 2 of 4, row 3
    # drafts nothing, row 4 is a temperature row, row 5 junk
    drafts[1, 2] = (drafts[1, 2] + 1) % V
    drafts[5] = (drafts[5] + 3) % V
    lens = np.array([4, 4, 2, 0, 4, 4], dtype=np.int32)
    temps = np.array([0, 0, 0, 0, 0.8, 0], dtype=np.float32)
    if controls:
        temps = np.stack([temps, np.full(B, 0.9, np.float32),
                          np.full(B, 5, np.float32)], axis=1)
    logits0 = rng.standard_normal((B, V)).astype(np.float32)
    positions = rng.integers(0, 50, B).astype(np.int32)
    return g, logits0, temps, drafts, lens, positions


@pytest.mark.parametrize("controls", [False, True], ids=["temps", "controls"])
def test_spec_accept_epilogue_matches_jax(controls):
    g, logits0, temps, drafts, lens, positions = _epilogue_inputs(0, controls)
    want = jengine.spec_accept_epilogue(
        jnp.asarray(g), jnp.asarray(logits0), jnp.asarray(temps),
        jax.random.PRNGKey(0), jnp.asarray(drafts), jnp.asarray(lens),
        jnp.asarray(positions), D, 0)
    gen = torch.Generator().manual_seed(0)
    got = spec_accept_epilogue(
        torch.from_numpy(g).long(), torch.from_numpy(logits0),
        torch.from_numpy(temps), gen, torch.from_numpy(drafts).long(),
        torch.from_numpy(lens), torch.from_numpy(positions).long(), D, 0)
    w_tok, w_pos, _, w_out, w_emit = (np.asarray(a) for a in want)
    g_tok, g_pos, g_out, g_emit = (t.numpy() for t in got)
    np.testing.assert_array_equal(g_emit, w_emit)
    np.testing.assert_array_equal(g_pos, w_pos)
    assert list(g_emit) == [5, 3, 3, 1, 1, 1]
    greedy = [0, 1, 2, 3, 5]
    np.testing.assert_array_equal(g_tok[greedy], w_tok[greedy])
    np.testing.assert_array_equal(g_out[greedy], w_out[greedy])
    np.testing.assert_array_equal(g_out[4, 1:], w_out[4, 1:])


# -- the verify forwards ------------------------------------------------------

L, HKV, DH = CFG_J.n_layers, CFG_J.n_kv_heads, CFG_J.head_dim


def _window_inputs(seed, B_=3, d=4):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG_J.vocab_size, B_).astype(np.int32)
    drafts = rng.integers(0, CFG_J.vocab_size, (B_, d)).astype(np.int32)
    return tokens, drafts


def test_verify_step_matches_jax(weights):
    jparams, tparams = weights
    tokens, drafts = _window_inputs(1)
    positions = np.array([5, 17, 26], dtype=np.int32)    # the last: S - 6
    S = 32
    rng = np.random.default_rng(2)
    ck = rng.standard_normal((L, 3, HKV, DH, S), dtype=np.float32)
    cv = rng.standard_normal((L, 3, HKV, DH, S), dtype=np.float32)
    g, l0, jk, jv = jl.llama_verify_step(
        jparams, CFG_J, jnp.asarray(tokens), jnp.asarray(drafts),
        jnp.asarray(positions), tuple(jnp.asarray(c) for c in ck),
        tuple(jnp.asarray(c) for c in cv))
    tk = [torch.from_numpy(c.copy()) for c in ck]
    tv = [torch.from_numpy(c.copy()) for c in cv]
    tg, tl0, tk2, _ = tl.llama_verify_step(
        tparams, CFG_T, torch.from_numpy(tokens).long(),
        torch.from_numpy(drafts).long(), torch.from_numpy(positions).long(),
        tk, tv)
    assert tk2 is tk
    np.testing.assert_array_equal(tg.numpy(), np.asarray(g))
    np.testing.assert_allclose(tl0.numpy(), np.asarray(l0), atol=1e-4,
                               rtol=1e-4)
    for got, want in ((tk, jk), (tv, jv)):
        for gl, wl in zip(got, want):
            np.testing.assert_allclose(gl.numpy(), np.asarray(wl),
                                       atol=1e-5, rtol=1e-5)


def test_verify_step_paged_matches_jax(weights):
    """Rows: a window inside one page, one crossing a page boundary (14..18
    at ps=16), and a junk row whose window runs past its one reserved page
    into the table's zero column, the garbage page 0."""
    jparams, tparams = weights
    ps, P = 16, 10
    tokens, drafts = _window_inputs(3)
    positions = np.array([3, 14, 13], dtype=np.int32)
    table = np.array([[2, 3, 0, 0], [4, 5, 6, 0], [7, 0, 0, 0]],
                     dtype=np.int32)
    rng = np.random.default_rng(4)
    pk = rng.standard_normal((L, P, HKV, DH, ps), dtype=np.float32)
    pv = rng.standard_normal((L, P, HKV, DH, ps), dtype=np.float32)
    g, l0, jk, jv = jl.llama_verify_step_paged(
        jparams, CFG_J, jnp.asarray(tokens), jnp.asarray(drafts),
        jnp.asarray(positions), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(table))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tg, tl0, _, _ = tl.llama_verify_step_paged(
        tparams, CFG_T, torch.from_numpy(tokens).long(),
        torch.from_numpy(drafts).long(), torch.from_numpy(positions).long(),
        tk, tv, torch.from_numpy(table))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(g))
    np.testing.assert_allclose(tl0.numpy(), np.asarray(l0), atol=1e-4,
                               rtol=1e-4)
    # page 0 takes the junk row's overrun (positions 16, 17: offsets 0, 1)
    for got, want, before in ((tk, jk, pk), (tv, jv, pv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        for page in (0, 5):                   # the overrun, the crossing
            assert not np.array_equal(got.numpy()[:, page], before[:, page])
        for page in (8, 9):                   # no row's page: untouched
            np.testing.assert_array_equal(got.numpy()[:, page],
                                          before[:, page])


# -- the engines --------------------------------------------------------------

@pytest.mark.parametrize("cls", ENGINES, ids=["dense", "paged"])
def test_speculative_greedy_output_identical(weights, plain, cls):
    got, eng = _serve(weights[1], PROMPTS, 24, cls, speculative_tokens=4)
    assert got == plain["prompts"]
    assert eng.verify_dispatches > 0


@pytest.mark.parametrize("cls", ENGINES, ids=["dense", "paged"])
def test_speculative_single_long_generation_identical(weights, plain, cls):
    """One row, many verifies chaining their device state (positions
    advance by a variable accepted + 1)."""
    got, _ = _serve(weights[1], [LONG], 48, cls, speculative_tokens=6)
    assert got == plain["long"]


def test_paged_speculative_releases_pages(weights):
    """Verify-window overruns land in the garbage page: after the
    generations every page is free, and a fresh request still serves."""
    eng = PagedLLMEngine(weights[1], CFG_T, device="cpu", page_size=16,
                         speculative_tokens=4, **ENGINE)
    eng.start()
    try:
        for r in [eng.submit(p, max_new_tokens=24) for p in PROMPTS]:
            r.result(timeout_s=300)
        again = eng.submit(PROMPTS[0], max_new_tokens=8)
        assert len(again.result(timeout_s=300)) == 8
    finally:
        eng.stop()
    assert eng.allocator.used_pages == 0


def test_speculative_temperature_rows_ride_along(weights):
    """Temperature rows never accept (acceptance is greedy-only): right
    lengths, valid ids, the same streams for the same seed and different
    ones for another."""
    kw = dict(temperature=0.8, speculative_tokens=4)
    a, _ = _serve(weights[1], PROMPTS[:2], 10, seed=7, **kw)
    b, _ = _serve(weights[1], PROMPTS[:2], 10, seed=7, **kw)
    c, _ = _serve(weights[1], PROMPTS[:2], 10, seed=8, **kw)
    assert a == b and c != a
    assert all(len(t) == 10 for t in a)
    assert all(0 <= tok < CFG_T.vocab_size for t in a for tok in t)


def test_speculative_accepts_on_periodic_output(weights, plain):
    """Long greedy generations enter a cycle, and the bigram drafts of the
    cycle are ACCEPTED, not only proposed; the streams stay the plain
    engine's."""
    got, eng = _serve(weights[1], PROMPTS[:2], 64, max_seq_len=256,
                      n_slots=2, speculative_tokens=4)
    assert got == plain["periodic"]
    assert eng.spec_drafted > 0 and eng.spec_accepted > 0


def test_speculative_rejected_combinations(weights):
    q8 = dataclasses.replace(CFG_T, decode_attn="kernel", kv_dtype="int8")
    for cls, cfg, kw in ((LLMEngine, q8, {}), (PagedLLMEngine, q8, {}),
                         (LLMEngine, CFG_T, {"chunk_prefill_tokens": 8})):
        with pytest.raises(ValueError, match="speculative_tokens with"):
            cls(weights[1], cfg, n_slots=2, max_seq_len=64,
                prefill_buckets=(8, 32), speculative_tokens=4, device="cpu",
                **kw)


class Tight(LLMEngine):
    """tests/test_speculative.py's: a cooloff after two bad verifies, and a
    proposer whose drafts are never the argmax."""
    SPEC_EMA_ALPHA = 0.5
    SPEC_MIN_ACCEPT = 0.6
    SPEC_COOLOFF_DISPATCHES = 4
    cooled = False

    def _propose_draft(self, history):
        return [(history[-1] + 1) % CFG_T.vocab_size] * 4

    def _dispatch_decode(self):
        if self._spec_cooloff > 0:
            type(self).cooled = True
        return super()._dispatch_decode()


def test_adaptive_speculation_cools_off_and_stays_correct(weights, plain):
    got, eng = _serve(weights[1], PROMPTS, 24, Tight, speculative_tokens=4)
    assert Tight.cooled and eng.spec_cooloffs > 0
    assert got == plain["prompts"]


def test_acceptance_ema_normalizes_by_greedy_eligible_slots(weights):
    """Two greedy rows accepting all 4 drafts and two temperature rows read
    as 4.0 accepted per eligible row, not 2.0."""
    eng = LLMEngine(weights[1], CFG_T, n_slots=4, max_seq_len=128,
                    prefill_buckets=(8,), speculative_tokens=4, device="cpu")
    reqs = []
    for i, temp in enumerate([0.0, 0.0, 0.9, 0.9]):
        r = GenerationRequest([1, 2, 3], max_new_tokens=64, temperature=temp)
        slot = eng.slots[i]
        slot.request, slot.length, slot.remaining = r, 3, 64
        slot.history = [1, 2, 3]
        reqs.append(r)
    snapshot = [(i, reqs[i], reqs[i].temperature <= 0.0) for i in range(4)]
    out = np.full((4, 6), 7, dtype=np.int64)
    out[:, -1] = [5, 5, 1, 1]                  # the emit counts ride last
    eng._spec_accept_ema = 1.0
    eng._inflight.append(("verify", torch.from_numpy(out), snapshot, 4))
    eng._sync_oldest()
    a = LLMEngine.SPEC_EMA_ALPHA
    assert eng._spec_accept_ema == pytest.approx((1 - a) * 1.0 + a * 4.0)
    assert eng._spec_cooloff == 0
    assert [r.generated for r in reqs] == [5, 5, 1, 1]
    assert eng.slots[0].history == [1, 2, 3] + [7] * 5


def test_zero_draft_verify_falls_back_to_block_decode(weights):
    """An all-temperature batch has no drafts: block decodes, and the EMA
    is untouched (zero drafts is no acceptance signal)."""
    got, eng = _serve(weights[1], PROMPTS[:2], 12, temperature=0.9,
                      n_slots=2, speculative_tokens=4, seed=3)
    assert all(len(t) == 12 for t in got)
    assert eng.verify_dispatches == 0 and eng.spec_zero_draft > 0
    assert eng._spec_accept_ema == pytest.approx(4.0)


def test_speculative_composes_with_prefix_cache(weights, plain):
    """The verify gather reads shared prefix pages while other rows hold
    refs: equal to the plain engine, the cache hit, nothing leaked."""
    eng = PagedLLMEngine(weights[1], CFG_T, device="cpu", page_size=16,
                         speculative_tokens=4, prefix_cache=True, **ENGINE)
    eng.start()
    try:
        got = [r.result(timeout_s=300) for r in
               [eng.submit(p, max_new_tokens=20) for p in SHARED]]
        got2 = [r.result(timeout_s=300) for r in
                [eng.submit(p, max_new_tokens=20) for p in SHARED]]
        assert eng.prefix.hit_pages > 0
    finally:
        eng.stop()
    assert got == plain["shared"] and got2 == plain["shared"]
    assert eng.allocator.used_pages == eng.prefix.resident_pages
    assert all(r == 0 for r in eng.prefix._refs.values())


@pytest.mark.parametrize("cls", ENGINES, ids=["dense", "paged"])
def test_speculative_composes_with_controls(weights, plain, cls):
    """The OpenAI server's default stack (paged + speculation + sampling
    controls; test_sampling_controls.py:126 and :162), on prompts that
    draft: greedy rows equal the plain engine's, and the verifies ran (in
    the -sc-nosort variant: no row has a filter)."""
    got, eng = _serve(weights[1], PROMPTS, 24, cls, speculative_tokens=4,
                      sampling_controls=True)
    assert got == plain["prompts"]
    calls = {n: c for n, c in eng.executor.cache_info().items()
             if "-verify-" in n and c}
    assert calls and all(n.endswith("-sc-nosort") for n in calls)


# -- graphs, warm-up names, serving -----------------------------------------

def _graph_like(fn, inputs):
    out = []

    def replay():
        got = fn(*inputs)
        if out:
            out[0].copy_(got)
        else:
            out.append(got.clone())
        return out[0]
    return replay


@pytest.mark.parametrize("cls", ENGINES, ids=["dense", "paged"])
def test_verify_graph_matches_eager(weights, cls):
    """graphcheck.verify_graph_vs_eager on an engine driven into decode,
    with greedy_drafts: the program's output and state equal the eager
    verify's, and every active row accepts all 4 drafts."""
    extra = {"page_size": 16} if cls is PagedLLMEngine else {}
    eng = cls(weights[1], CFG_T, device="cpu", speculative_tokens=4,
              **{**ENGINE, **extra})
    eng.executor = Executor("cpu", capture=_graph_like)
    with torch.no_grad():
        for p in PROMPTS[:2]:
            eng.submit(p, max_new_tokens=40)
        for _ in range(12):
            eng._step()
    r = graphcheck.verify_graph_vs_eager(eng)
    assert r["rows"] > 0 and r["accepted"] == 4 * r["rows"]
    assert torch.equal(r["graph"], r["eager"])
    assert r["state_diff"] == 0.0


def _verify_names(names):
    return sorted(n for n in names if "-verify-" in n)


def test_warmup_verify_names_match_jax(weights):
    """The dense warm-up's verify program is the reference's (here both
    warm at 64: the reference grows to pow2(largest bucket + 1), the port
    to MAX_SEQ_LEN); the paged one warms the reference's width and every
    other width a dispatch can reach."""
    kw = dict(n_slots=2, max_seq_len=64, prefill_buckets=(8, 32),
              speculative_tokens=3)
    want = {}
    for cls, key in ((JEngine, "dense"), (JPaged, "paged")):
        extra = {"page_size": 16} if cls is JPaged else {}
        jeng = cls(weights[0], CFG_J, logger=_QuietLogger(), **kw, **extra)
        jeng.warmup(grow=True)
        want[key] = _verify_names(jeng.executor.cache_info())
    dense = LLMEngine(weights[1], CFG_T, device="cpu", **kw)
    dense.warmup()
    assert _verify_names(dense.executor.cache_info()) == want["dense"] == [
        "llama-verify-x3-S64"]
    paged = PagedLLMEngine(weights[1], CFG_T, device="cpu", page_size=16,
                           **kw)
    paged.warmup()
    got = _verify_names(paged.executor.cache_info())
    assert set(want["paged"]) <= set(got)
    assert got == sorted(f"llama-paged-verify-x3-NP{w}" for w in (2, 4, 8))


def test_serve_builds_speculative_engines_and_refuses_the_reference_pairs(
        weights):
    env = {"MODEL_PRESET": "debug", "MAX_BATCH": "2", "MAX_SEQ_LEN": "64",
           "PREFILL_BUCKETS": "8,16", "PAGE_SIZE": "8", "WARMUP": "false",
           "SPECULATIVE_TOKENS": "3"}
    for paged in ("true", "false"):
        eng = build_engine(dict(env, PAGED=paged), device="cpu",
                           params=weights[1])
        try:
            assert eng.speculative_tokens == 3
            assert eng.generate([5, 6, 5, 6, 5], max_new_tokens=6) == \
                eng.generate([5, 6, 5, 6, 5], max_new_tokens=6)
        finally:
            eng.stop()
    for bad in ({"KV_DTYPE": "int8"}, {"CHUNK_PREFILL_TOKENS": "8"}):
        with pytest.raises(ValueError, match="speculative_tokens with"):
            build_engine(dict(env, **bad), device="cpu", params=weights[1])
