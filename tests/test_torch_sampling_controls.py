"""Port per-request top_p / top_k (the [B, 3] row-control plane) vs JAX.

Ports tests/test_sampling_controls.py, but for the cases that wait on
speculative decoding (ROADMAP A10). torch's generator cannot replay
jax.random, so sampled rows are held to the set their filters allow:
over many draws, the support of the port's tokens equals the support of
JAX's `sample_tokens` on the same designed logits, and both equal the set
computed here by hand. Greedy rows, and rows whose filters leave one token
(top_k=1, a tiny top_p), must equal JAX's tokens exactly.

Engines (sampling_controls=True; the four serving configurations: paged,
paged int8, dense with the decode kernel, dense int8): greedy streams equal
the JAX engines' (also sampling_controls=True) token for token on the same
weights (llama_init(debug, seed=0), bridged by params_from_numpy); top_k=1
and tiny top_p rows at temperature > 0 equal them too; submit's checks give
JAX's messages; a freed slot's control row reads 0; and, under the
graph-like capture stub of tests/test_torch_prefill_graphs.py (each replay
returns one output tensor, overwritten by the next), each decode
block runs the program with the per-row filters exactly when a row of the
device state has a control, and the program names are the JAX executor's
(plus the -nosort decode variant).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jl
from gofr_tpu.tpu.engine import LLMEngine as JEngine
from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
from gofr_tpu.tpu.sampling import pack_controls as jpack
from gofr_tpu.tpu.sampling import sample_tokens as jsample
from gofr_tpu.tpu.sampling import temperature_of as jtemperature_of
from gofr_tpu_torch.models import llama as tl
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.tpu.engine import LLMEngine
from gofr_tpu_torch.tpu.executor import Executor
from gofr_tpu_torch.tpu.graphcheck import (graph_vs_eager,
                                           prefill_graph_vs_eager,
                                           state_tensors)
from gofr_tpu_torch.tpu.paging import PagedLLMEngine
from gofr_tpu_torch.tpu.sampling import (pack_controls, row_filters,
                                         sample_tokens, temperature_of)
from test_torch_prefill_graphs import _graph_like

ENGINE = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16, 32),
              decode_block_size=4)
CONFIGS = {
    "paged": (True, {}),
    "paged-int8": (True, {"kv_dtype": "int8"}),
    "dense": (False, {"decode_attn": "kernel"}),
    "dense-int8": (False, {"decode_attn": "kernel", "kv_dtype": "int8"}),
}
PROMPTS = [[5, 6, 7, 8, 5, 6, 7, 8], [9, 8, 7], list(range(20, 40)), [11]]
# the reference tests' designed distribution: probs ~ [0.4, 0.3, 0.2, 0.1]
# and a long tail of ~0
DESIGNED = np.log(np.array([0.4, 0.3, 0.2, 0.1] + [1e-9] * 60))


class _QuietLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


# -- the sampler --------------------------------------------------------------

def test_temperature_of_and_pack_controls_match_jax():
    rows = ([0.0, 0.7, 1.3], [0.5, 0.0, 0.9], [3, 0, 40])
    got, want = pack_controls(*rows), np.asarray(jpack(*rows))
    assert got.dtype == np.float32 and got.shape == (3, 3)
    np.testing.assert_array_equal(got, want)
    flat = np.asarray([0.0, 0.7, 1.3], dtype=np.float32)
    for samp in (flat, got):
        np.testing.assert_array_equal(
            temperature_of(torch.from_numpy(samp)).numpy(),
            np.asarray(jtemperature_of(jnp.asarray(samp))))


@pytest.mark.parametrize("controls", [
    ([0.0] * 6, [0.0] * 6, [0] * 6),            # greedy, no filters
    ([0.0] * 6, [0.5, 0.9, 0, 0.3, 1.0, 0], [0, 5, 3, 0, 40, 1]),
    ([1.0] * 6, [0.0] * 6, [1] * 6),            # top_k=1 at any temperature
    ([0.9] * 6, [1e-4] * 6, [0] * 6),           # a tiny top_p
], ids=["greedy", "greedy-with-filters", "top_k-1", "tiny-top_p"])
def test_single_survivor_rows_equal_jax_and_greedy(controls):
    """Rows that are greedy, or whose filters leave one token, give JAX's
    tokens, which are the argmax."""
    logits = np.random.default_rng(1).standard_normal((6, 64)).astype(
        np.float32) * 4.0
    samp = pack_controls(*controls)
    got = sample_tokens(torch.from_numpy(logits),
                        torch.Generator().manual_seed(0),
                        torch.from_numpy(samp)).numpy()
    want, _ = jsample(jnp.asarray(logits), jax.random.PRNGKey(0),
                      jnp.asarray(samp))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, logits.argmax(-1))


# (top_p, top_k) per row over DESIGNED at temperature 1, and the support a
# row may draw from: the smallest prefix of the top_k renormalized
# distribution whose mass reaches top_p
ROWS = {
    "top_k-then-top_p": ((0.5, 2), {0}),       # 0.4 / 0.7 = 0.57 >= 0.5
    "top_p-alone": ((0.5, 0), {0, 1}),         # 0.4 < 0.5 <= 0.7
    "top_k-alone": ((0.0, 3), {0, 1, 2}),
    "top_p-0.95": ((0.95, 0), {0, 1, 2, 3}),
    "top_k-2": ((0.0, 2), {0, 1}),
    "top_k-then-top_p-0.8": ((0.8, 3), {0, 1, 2}),  # 0.7 / 0.9 < 0.8
}
DRAWS = 400


@pytest.mark.parametrize("independent", [False, True],
                         ids=["one-row", "rows-independent"])
def test_filter_support_equals_jax_on_the_designed_logits(independent):
    """DRAWS draws per row (one call each side: the batch holds each row
    DRAWS times, and every row draws on its own): each row's support
    equals JAX's and the hand-computed set, one control per batch, or all
    of them as rows of one batch (each row's control applies to that row
    only; a greedy row rides along)."""
    names = sorted(ROWS)
    cases = [names] if independent else [[n] for n in names]
    for case in cases:
        controls = [ROWS[n][0] for n in case] + [(0.0, 0)]
        temps = [1.0] * len(case) + [0.0]
        samp = pack_controls(temps, [p for p, _ in controls],
                             [k for _, k in controls])
        logits = np.repeat(DESIGNED[None].astype(np.float32), len(samp), 0)
        logits[-1] = np.random.default_rng(2).standard_normal(64)
        big_logits = np.tile(logits, (DRAWS, 1))
        big_samp = np.tile(samp, (DRAWS, 1))
        port = sample_tokens(torch.from_numpy(big_logits),
                             torch.Generator().manual_seed(3),
                             torch.from_numpy(big_samp)).numpy()
        ref = np.asarray(jsample(jnp.asarray(big_logits),
                                 jax.random.PRNGKey(4),
                                 jnp.asarray(big_samp))[0])
        rows = len(samp)
        want = [ROWS[n][1] for n in case] + [{int(logits[-1].argmax())}]
        for toks in (port, ref):
            got = [set(toks.reshape(DRAWS, rows)[:, r].tolist())
                   for r in range(rows)]
            assert got == want, case


def test_row_filters_on_rows_without_controls_is_the_identity():
    """The ground for skipping the filters: on rows whose top_p and top_k
    are 0 the filters return their input bit for bit, and the same draw
    with and without them gives the same tokens and generator offset."""
    rng = np.random.default_rng(5)
    scaled = torch.from_numpy(rng.standard_normal((8, 300)).astype(
        np.float32) * 3)
    samp = torch.from_numpy(pack_controls(rng.uniform(0, 2, 8), [0.0] * 8,
                                          [0] * 8))
    assert torch.equal(row_filters(scaled, samp), scaled)
    a, b = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    with_f = sample_tokens(scaled, a, samp, row_filter=True)
    without = sample_tokens(scaled, b, samp, row_filter=False)
    assert torch.equal(with_f, without)
    assert torch.equal(a.get_state(), b.get_state())
    # a row with a control set is filtered: top_k=1 leaves the argmax
    samp[3, 2] = 1
    filtered = row_filters(scaled, samp)
    assert torch.equal(filtered[[0, 1, 2, 4, 5, 6, 7]],
                       scaled[[0, 1, 2, 4, 5, 6, 7]])
    assert int((filtered[3] > -1e29).sum()) == 1


# -- engines ------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jparams = jl.llama_init(jl.LlamaConfig.debug(), seed=0)
    return jparams, params_from_numpy(jax.device_get(jparams), device="cpu")


def _cfgs(config):
    fields = CONFIGS[config][1]
    return (dataclasses.replace(jl.LlamaConfig.debug(), **fields),
            dataclasses.replace(tl.LlamaConfig.debug(), **fields))


def _jax_engine(jparams, config, **kw):
    cfg = _cfgs(config)[0]
    if CONFIGS[config][0]:
        return JPaged(jparams, cfg, logger=_QuietLogger(), page_size=8,
                      sampling_controls=True, **{**ENGINE, **kw})
    return JEngine(jparams, cfg, logger=_QuietLogger(),
                   sampling_controls=True, **{**ENGINE, **kw})


def _port_engine(tparams, config, stub=False, **kw):
    cfg = _cfgs(config)[1]
    if CONFIGS[config][0]:
        eng = PagedLLMEngine(tparams, cfg, device="cpu", page_size=8,
                             sampling_controls=True, **{**ENGINE, **kw})
    else:
        eng = LLMEngine(tparams, cfg, device="cpu", sampling_controls=True,
                        **{**ENGINE, **kw})
    if stub:
        eng.executor = Executor("cpu", capture=_graph_like)
    return eng


def test_submit_checks_give_the_jax_messages(weights):
    def messages(make):
        out = []
        for controls, kw in [(False, {"top_p": 0.5}), (False, {"top_k": 5}),
                             (True, {"top_p": 1.5}), (True, {"top_k": -1}),
                             (True, {"top_p": -0.1})]:
            eng = make(controls)
            with pytest.raises(ValueError) as err:
                eng.submit([1, 2], **kw)
            out.append(str(err.value))
        return out

    jparams, tparams = weights
    cfg_j, cfg_t = _cfgs("dense")
    want = messages(lambda c: JEngine(jparams, cfg_j, n_slots=2,
                                      max_seq_len=64, prefill_buckets=(8,),
                                      sampling_controls=c))
    got = messages(lambda c: LLMEngine(tparams, cfg_t, device="cpu",
                                       n_slots=2, max_seq_len=64,
                                       prefill_buckets=(8,),
                                       sampling_controls=c))
    assert got == want
    assert "sampling_controls=True" in got[0]


@pytest.mark.parametrize("config", ["paged", "dense"])
def test_a_freed_slots_control_row_reads_zero(weights, config):
    """A finished top_p / top_k request leaves no control row behind (a
    stale one would make every later all-greedy block run the filters),
    and the engine's record of rows with a control empties with it."""
    eng = _port_engine(weights[1], config)
    eng.start()
    try:
        eng.submit([1, 2, 3], max_new_tokens=4, temperature=0.9, top_p=0.5,
                   top_k=3).result(timeout_s=300)
        eng.submit([4, 5], max_new_tokens=3, temperature=0.0).result(
            timeout_s=300)
    finally:
        eng.stop()
    assert not any(s.active for s in eng.slots)
    assert (eng._temps[:, 1:] == 0).all(), eng._temps
    assert not eng._filter_rows


def _drive(eng, record):
    """The loop's order by hand until idle. With `record` (the port's
    engine), per decode dispatch: (whether a row of the device state had a
    control just before it, whether the program it called runs the
    filters)."""
    seen = []
    while True:
        eng._admit()
        while (len(eng._inflight) < eng.pipeline_depth
               and any(s.active for s in eng.slots)):
            if not record:
                eng._dispatch_decode()
                continue
            live = bool((eng._temps[:, 1:] != 0).any())
            before = eng.executor.cache_info()
            eng._dispatch_decode()
            after = eng.executor.cache_info()
            called = [n for n in after if after[n] != before.get(n, 0)]
            assert len(called) == 1 and "decode" in called[0]
            seen.append((live, not called[0].endswith("-nosort")))
        if not eng._inflight:
            return seen
        eng._sync_oldest()


def _traffic(eng, record=False, submits=({}, {}, {})):
    """Two rows; then, beside them, a short top_k row at temperature 0.7
    and a third row (`submits`: the three rows' sampling arguments, greedy
    by default). Returns (the three rows' streams, the top_k row's length,
    what _drive recorded)."""
    first = [eng.submit(p, max_new_tokens=16, **kw)
             for p, kw in zip(PROMPTS[:2], submits)]
    seen = _drive(eng, record)
    filtered = eng.submit(PROMPTS[2], max_new_tokens=5, temperature=0.7,
                          top_k=3)
    late = eng.submit(PROMPTS[3], max_new_tokens=12, **submits[2])
    seen += _drive(eng, record)
    return ([r.result(timeout_s=5) for r in first + [late]],
            len(filtered.result(timeout_s=5)), seen)


@pytest.fixture(scope="module")
def jax_runs(weights):
    """config -> the JAX sampling_controls engine's _traffic: (the greedy
    streams, the top_k row's length, its program names), computed once."""
    cache = {}

    def get(config):
        if config not in cache:
            eng = _jax_engine(weights[0], config)
            streams, n, _ = _traffic(eng)
            cache[config] = (streams, n, {
                name for name in eng.executor.cache_info()
                if any(k in name for k in ("decode", "prefill", "prefix"))})
        return cache[config]
    return get


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_greedy_streams_equal_the_jax_engines(weights, jax_runs, config):
    """Greedy rows beside a sampled top_k row, every dispatch a program
    under the graph-like stub: the greedy streams equal the JAX engine's
    token for token, and the programs carry the reference's -sc names (a
    decode program the reference ran with its filters on may have run
    here only as -nosort, and the other way round)."""
    want, n_want, names = jax_runs(config)
    eng = _port_engine(weights[1], config, stub=True)
    got, n, _ = _traffic(eng)
    assert got == want and n == n_want == 5
    assert all(name.endswith("-sc") for name in names)
    assert {name.removesuffix("-nosort")
            for name in eng.executor.compiled} == names


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_single_survivor_requests_equal_greedy_end_to_end(weights, jax_runs,
                                                          config):
    """The greedy rows replaced by temperature 1.0 with top_k=1, 0.8 with a
    tiny top_p, and 2.0 with both: one survivor per step, so the served
    tokens equal the JAX engine's greedy ones token for token."""
    submits = ({"temperature": 1.0, "top_k": 1},
               {"temperature": 0.8, "top_p": 1e-4},
               {"temperature": 2.0, "top_k": 1, "top_p": 1e-4})
    got, _, _ = _traffic(_port_engine(weights[1], config), submits=submits)
    assert got == jax_runs(config)[0]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_the_filter_variant_runs_exactly_when_a_row_has_a_control(weights,
                                                                  config):
    """Under the graph-like stub: greedy rows alone run the -nosort blocks;
    the top_k row's admission switches the blocks dispatched after it to
    the filters until its slot frees and its row is cleared, behind the
    blocks in flight; warmup() makes both variants of every decode
    block."""
    eng = _port_engine(weights[1], config, stub=True)
    _, _, seen = _traffic(eng, record=True)
    assert all(live == rf for live, rf in seen), seen
    assert {rf for _, rf in seen} == {True, False}
    assert not eng._filter_rows and (eng._temps[:, 1:] == 0).all()
    warm = _port_engine(weights[1], config, stub=True)
    warm.warmup()
    decode = [n for n in warm.executor.compiled if "decode" in n]
    filt = {n for n in decode if n.endswith("-sc")}
    assert filt and {n + "-nosort" for n in filt} == set(decode) - filt


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_graph_vs_eager_under_controls_on_the_cpu(weights, config):
    """graphcheck on a sampling_controls engine under the stub: both decode
    variants (filter rows live, all rows greedy) and an admission wave
    with filter rows, at temperature 0 and 0.8: equal tokens, equal state;
    each check ran the variant it asked for."""
    eng = _port_engine(weights[1], config, stub=True)
    eng.submit(list(range(5, 17)), max_new_tokens=40)
    eng._admit()
    eng._dispatch_decode()
    while eng._inflight:
        eng._sync_oldest()
    for temperature in (0.0, 0.8):
        for filters in (True, False):
            g = graph_vs_eager(eng, 4, temperature, filters)
            assert torch.equal(g["graph"], g["eager"])
            assert g["state_diff"] == 0.0 and g["row_filter"] == filters
        before = [t.clone() for t in state_tensors(eng)]
        w = prefill_graph_vs_eager(eng, 2, 16, temperature=temperature,
                                   filters=True)
        assert torch.equal(w["graph"], w["eager"]) and w["state_diff"] == 0
        for t, s in zip(state_tensors(eng), before):
            assert torch.equal(t, s)
