"""Port prefill programs vs the JAX engines: every admission wave a program.

Every fused admission wave (dense and paged) and every tail-only wave of a
prefix hit is one program of the executor, as in the reference. Here they
run under a capture stub that behaves as a CUDA graph does where the CPU
can show it: a replay reruns the program on its static input buffers (so a
buffer the engine forgot to fill shows up) and returns ONE output tensor,
overwritten by the next replay (so an output the engine did not copy out
before the next dispatch shows up). Goldens are computed live from the JAX
engines on `llama_init(debug, seed=0)`, bridged by `params_from_numpy`.

- The greedy streams of the four serving configurations equal JAX's,
  traffic with prefix hits included, and two waves of one (K, bucket) in
  flight at once; the prefix cache's scenarios (tests/test_torch_prefix_cache)
  in model-dtype and int8 pools.
- The warm-up before a capture taken while other rows are live leaves the
  loop state, the generator and the KV of every live row as they were
  (paged: only page 0 may change; dense: only the wave's own rows).
- A dense growth drops the old length's prefill programs with its decode
  ones, and the streams across it equal JAX's.
- WARMUP=true / wide capture the JAX engine's warmup() / warmup(
  k_variants=True) admission programs, plus (wide, paged) the tail programs
  the buckets can reach (ROADMAP C).
- The static inputs, the graph-vs-eager helper and a failed capture.
- Captures of two executors in one process (two engines) never overlap:
  each holds the process-wide capture lock.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jl
from gofr_tpu.tpu.engine import LLMEngine as JEngine
from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
from gofr_tpu_torch.models import llama as tl
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.serve import build_engine
from gofr_tpu_torch.tpu.engine import LLMEngine, _admission_split
from gofr_tpu_torch.tpu.executor import Executor, next_bucket
from gofr_tpu_torch.tpu.graphcheck import prefill_graph_vs_eager
from gofr_tpu_torch.tpu.paging import PagedLLMEngine

ENGINE = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16, 32),
              decode_block_size=4)
PAGED = dict(page_size=8, prefix_cache=True)
# config -> (paged, config fields)
CONFIGS = {
    "paged": (True, {}),
    "paged-int8": (True, {"kv_dtype": "int8"}),
    "dense": (False, {"decode_attn": "kernel"}),
    "dense-int8": (False, {"decode_attn": "kernel", "kv_dtype": "int8"}),
}
SYSTEM = list(range(1, 17))             # 2 full pages at page_size 8


class _QuietLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


def _graph_like(fn, inputs):
    """A capture that records nothing and behaves as a graph's replay where
    the CPU can show it: each call runs fn on the static inputs and writes
    the result into the one output tensor every call returns."""
    out = []

    def replay():
        got = fn(*inputs)
        if out:
            out[0].copy_(got)
        else:
            out.append(got.clone())
        return out[0]
    return replay


@pytest.fixture(scope="module")
def weights():
    jparams = jl.llama_init(jl.LlamaConfig.debug(), seed=0)
    return jparams, params_from_numpy(jax.device_get(jparams), device="cpu")


def _jax_engine(jparams, config, **kw):
    paged, fields = CONFIGS[config]
    cfg = dataclasses.replace(jl.LlamaConfig.debug(), **fields)
    if paged:
        return JPaged(jparams, cfg, logger=_QuietLogger(),
                      **{**ENGINE, **PAGED, **kw})
    return JEngine(jparams, cfg, logger=_QuietLogger(), **{**ENGINE, **kw})


def _port_engine(tparams, config, **kw):
    paged, fields = CONFIGS[config]
    cfg = dataclasses.replace(tl.LlamaConfig.debug(), **fields)
    if paged:
        eng = PagedLLMEngine(tparams, cfg, device="cpu",
                             **{**ENGINE, **PAGED, **kw})
    else:
        eng = LLMEngine(tparams, cfg, device="cpu", **{**ENGINE, **kw})
    eng.executor = Executor("cpu", capture=_graph_like)
    return eng


def _drive(eng):
    """The loop's order by hand until idle: admit, dispatch decode while
    fewer than pipeline_depth are in flight, sync the oldest."""
    while True:
        eng._admit()
        while (len(eng._inflight) < eng.pipeline_depth
               and any(s.active for s in eng.slots)):
            eng._dispatch_decode()
        if not eng._inflight:
            return
        eng._sync_oldest()


def _traffic(eng):
    """One request alone (it seeds the prefix cache), four at once on the
    four slots (two hit the seed's pages on the paged engines; a fifth
    waits), then two of one (K, bucket) dispatched back to back, both in
    flight before either is synced."""
    reqs = [eng.submit(SYSTEM + [40, 41], max_new_tokens=6)]
    _drive(eng)
    reqs += [eng.submit(p, max_new_tokens=n) for p, n in [
        (SYSTEM + [50, 51, 52], 8), (SYSTEM + [60], 10), ([5, 6, 7], 8),
        (list(range(70, 84)), 12), ([9, 10, 11, 12], 5)]]
    _drive(eng)
    pair = [eng.submit([20 + i, 21, 22 + 3 * i], max_new_tokens=7)
            for i in range(2)]
    eng._admit()
    eng._admit()   # the first is not synced yet: one wave each
    kinds = [entry[0] for entry in eng._inflight]
    _drive(eng)
    return [r.result(timeout_s=5) for r in reqs + pair], kinds


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_greedy_streams_match_jax_with_every_prefill_a_program(weights,
                                                                config):
    want, jkinds = _traffic(_jax_engine(weights[0], config))
    eng = _port_engine(weights[1], config)
    got, kinds = _traffic(eng)
    assert got == want
    assert kinds == jkinds == ["prefill", "prefill"]
    assert eng.prefill_shapes[(1, 8)] >= 2
    if CONFIGS[config][0]:
        assert eng.prefix_dispatches >= 2
    # every wave and every decode block was one program call
    calls = eng.executor.cache_info()
    waves = eng.prefill_dispatches + eng.prefix_dispatches
    assert sum(n for name, n in calls.items() if "decode" not in name) \
        == waves
    assert sum(n for name, n in calls.items() if "decode" in name) \
        == eng.decode_blocks
    assert eng.executor.captures == len(eng.executor.compiled)


# -- the prefix cache's scenarios ----------------------------------------------

@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_prefix_scenarios_match_jax_with_every_prefill_a_program(weights,
                                                                  kv):
    """tests/test_torch_prefix_cache.py's engine scenarios (tail-only
    admission, the identical prompt twice, concurrent sharers, pool pressure
    that evicts) with every wave a program: the same streams, cache stats
    and wave shapes as the JAX engine's."""
    import test_torch_prefix_cache as pc

    jparams, tparams = weights
    kv_dtype = "int8" if kv == "int8" else None
    cj = dataclasses.replace(pc.CFG_J, kv_dtype=kv_dtype)
    ct = dataclasses.replace(pc.CFG_T, kv_dtype=kv_dtype)

    def port(kw):
        eng = PagedLLMEngine(tparams, ct, device="cpu", **kw)
        eng.executor = Executor("cpu", capture=_graph_like)
        return eng

    want = pc._serve(lambda kw: JPaged(jparams, cj, logger=_QuietLogger(),
                                       **kw), pc._jax_waves)
    got = pc._serve(port, pc._port_waves)
    assert got == want
    assert got["tail_only"]["waves"]["prefix"] == {(1, 8): 1}


# -- the warm-up before a capture ----------------------------------------------

def _kv(eng):
    kv = ([eng.k_cache, eng.v_cache] if isinstance(eng, PagedLLMEngine)
          else [*eng.k_cache, *eng.v_cache])
    if eng._q8:
        kv += ([eng.k_scale, eng.v_scale] if isinstance(eng, PagedLLMEngine)
               else [*eng.k_scale, *eng.v_scale])
    return [t.clone() for t in kv]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_capture_beside_live_rows_changes_none_of_them(weights, config):
    """Two rows live mid-decode, every row's temperature set, then new
    programs captured for waves into the two free slots: a full wave (and,
    paged, a tail-only one). The tokens, positions, temperatures and
    generator state are as before, and so is the KV of every live row:
    paged, every page but the garbage page 0; dense, every row but the
    wave's own."""
    eng = _port_engine(weights[1], config)
    for p in ([5, 6, 7, 8, 9], list(range(30, 41))):
        eng.submit(p, max_new_tokens=30)
    eng._admit()
    for _ in range(2):
        eng._dispatch_decode()
        eng._sync_oldest()
    while eng._inflight:
        eng._sync_oldest()
    live = [i for i, s in enumerate(eng.slots) if s.active]
    free = [i for i, s in enumerate(eng.slots) if not s.active]
    assert len(live) == 2 and len(free) == 2
    eng._temps.copy_(torch.tensor([0.3, 0.6, 0.9, 1.2]))
    loop = [t.clone() for t in (eng._tokens, eng._positions, eng._temps)]
    rng = eng.generator.get_state()
    kv = _kv(eng)
    warmed = []
    for name in ("_prefill_fn", "_prefix_fn")[:1 + CONFIGS[config][0]]:
        fn = getattr(eng, name)
        setattr(eng, name, lambda *a, fn=fn: warmed.append(1) or fn(*a))
    with torch.no_grad():
        eng._prefill_program(32, 2, free)
        if CONFIGS[config][0]:
            eng._prefix_program(32, 2, 8, free)
    # each capture ran its warm-up once (the stub runs nothing)
    assert len(warmed) == 1 + CONFIGS[config][0]
    for t, s in zip((eng._tokens, eng._positions, eng._temps), loop):
        assert torch.equal(t, s)
    assert torch.equal(eng.generator.get_state(), rng)
    for after, before in zip(_kv(eng), kv):
        if CONFIGS[config][0]:          # pools [L, P, ...]: page 0 aside
            assert torch.equal(after[:, 1:], before[:, 1:])
        else:                           # per-layer rows [B, ...]
            assert torch.equal(after[live], before[live])


# -- dense growth ---------------------------------------------------------------

@pytest.mark.parametrize("config", ["dense", "dense-int8"])
def test_growth_drops_the_old_lengths_prefill_programs(weights, config):
    """A stream admitted at S=16 grows the cache to 64; a request admitted
    after the growth runs a prefill program at S=64, and none of the S=16
    or S=32 programs, prefill or decode, is left. Both streams equal the
    JAX engine's driven the same way."""
    runs = []
    for make, params in ((_jax_engine, weights[0]),
                         (_port_engine, weights[1])):
        eng = make(params, config)
        first = eng.submit([5, 6, 7], max_new_tokens=40)
        eng._admit()
        while eng._cache_len < 64:
            eng._dispatch_decode()
            if len(eng._inflight) >= eng.pipeline_depth:
                eng._sync_oldest()
        late = eng.submit([9, 10, 11, 12], max_new_tokens=10)
        _drive(eng)
        runs.append([first.result(timeout_s=5), late.result(timeout_s=5)])
    assert runs[1] == runs[0]
    kind = "-q8" if eng._q8 else ""
    compiled, alive = eng.executor.compiled, set(eng.executor.cache_info())
    assert f"llama-prefill{kind}-8x1-S16" in compiled
    assert f"llama-prefill{kind}-8x1-S64" in alive
    assert any("decode" in n and "-S16" in n for n in compiled)
    assert all("-S64" in n for n in alive)


# -- WARMUP -------------------------------------------------------------------

WARM_ENV = {"MODEL_PRESET": "debug", "HTTP_PORT": "0", "MAX_BATCH": "4",
            "GRPC_PORT": "0",
            "MAX_SEQ_LEN": "64", "PREFILL_BUCKETS": "8,16,32",
            "PAGE_SIZE": "8", "DECODE_ATTN": "kernel"}


def _jax_warm_names(jparams, paged, k_variants):
    """The admission programs the JAX engine's warmup compiles (the XLA
    compile of each is skipped: only its name is wanted; the cache growth
    runs)."""
    cfg = dataclasses.replace(jl.LlamaConfig.debug(), attn_impl="flash",
                              decode_attn="kernel")
    kw = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16, 32))
    eng = (JPaged(jparams, cfg, logger=_QuietLogger(), page_size=8,
                  prefix_cache=True, **kw) if paged
           else JEngine(jparams, cfg, logger=_QuietLogger(), **kw))
    names, compile_ = [], eng.executor.compile

    def record(name, fn, args, **ckw):
        if name.startswith("kv-grow"):
            return compile_(name, fn, args, **ckw)
        names.append(name)
        return None
    eng.executor.compile = record
    eng.warmup(k_variants=k_variants)
    return {n for n in names if "prefill" in n or "prefix" in n}, eng


def _reachable_tails(limit, ps, buckets, n_slots):
    """Every tail-only wave's (bucket, K, width), by brute force over the
    prompts: a hit of s whole pages on an n-token prompt leaves a tail of
    n - s * ps >= 1; a row that missed rides along at its own bucket."""
    def pow2(n):
        return 1 << (n - 1).bit_length()

    hits = set()
    for n in range(ps + 1, limit + 1):
        for s in range(1, (n - 1) // ps + 1):
            hits.add((next_bucket(n - s * ps, buckets),
                      pow2(-(-n // ps))))
    shapes = set(hits)
    for bucket, width in hits:
        for m in range(1, bucket + 1):
            shapes.add((bucket, max(width, pow2(-(-m // ps)))))
    ks = {k for n in range(1, n_slots + 1)
          for k in _admission_split(n, n_slots)}
    return {(b, k, w) for b, w in shapes for k in ks}


@pytest.mark.parametrize("mode", ["true", "wide"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_warmup_captures_the_reference_warm_set(weights, paged, mode):
    want, jeng = _jax_warm_names(weights[0], paged, mode == "wide")
    env = dict(WARM_ENV, WARMUP=mode, PAGED=str(paged).lower())
    eng = build_engine(env, device="cpu", params=weights[1])
    try:
        got = {n for n in eng.executor.compiled
               if "prefill" in n or "prefix" in n}
        decode = {n for n in eng.executor.compiled if "decode" in n}
    finally:
        eng.stop()
    assert want <= got
    extra = got - want
    if paged and mode == "wide":
        reach = _reachable_tails(eng.admission_limit, 8, (8, 16, 32), 4)
        tails = {f"llama-paged-prefix-{b}x{k}-NP{w}" for b, k, w in reach}
        assert extra == tails - want
    else:
        assert not extra
    ks = (1, 2, 4) if mode == "wide" else (1,)
    assert {n for n in want if "prefill" in n} == (
        {f"llama-paged-prefill-{b}x{k}" for b in (8, 16, 32) for k in ks}
        if paged else
        {f"llama-prefill-{b}x{k}-S64-flash" for b in (8, 16, 32)
         for k in ks})
    assert decode and (paged or eng._cache_len == 64)


# -- pieces --------------------------------------------------------------------

def test_static_inputs_share_one_aligned_block(weights):
    """A program's static inputs are typed views into one block, each
    16-byte aligned, made once per key, and _upload fills them in order."""
    eng = _port_engine(weights[1], "paged")
    specs = [((3, 5), torch.long), ((3, 2), torch.int32), ((3,), torch.long),
             ((3,), torch.int32), ((3,), torch.float32)]
    inputs = eng._static_inputs(("t",), specs)
    assert eng._static_inputs(("t",), specs) is inputs
    block = eng._blocks[inputs[0].data_ptr()]
    assert all(t.untyped_storage().data_ptr() == block.data_ptr()
               for t in inputs)
    assert [(tuple(t.shape), t.dtype) for t in inputs] == specs
    assert all((t.data_ptr() - block.data_ptr()) % 16 == 0 for t in inputs)
    rng = np.random.default_rng(0)
    arrays = [rng.integers(0, 9, (3, 5)), rng.integers(0, 9, (3, 2)),
              np.arange(3), np.arange(3) + 4, np.full(3, 0.5)]
    eng._upload(inputs, arrays)
    for t, a in zip(inputs, arrays):
        assert np.array_equal(t.numpy(), a)
    assert eng._staging_bytes() >= block.numel()


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_prefill_graph_vs_eager_on_the_cpu(weights, config):
    """The card's check run here on the stub: a full wave at [1, 16] and
    [2, 16] and, paged, a tail wave at [2, 16], sampled at temperature 0
    and 0.8: the same first tokens and state, the engine left as it was."""
    from gofr_tpu_torch.tpu.graphcheck import state_tensors

    eng = _port_engine(weights[1], config)
    eng.submit(list(range(5, 17)), max_new_tokens=30)   # dense: S grows to 32
    eng._admit()
    eng._dispatch_decode()
    while eng._inflight:
        eng._sync_oldest()
    before = [t.clone() for t in state_tensors(eng)]
    rng = eng.generator.get_state()
    cases = [(1, False), (2, False)] + ([(2, True)]
                                        if CONFIGS[config][0] else [])
    for K, tail in cases:
        for temperature in (0.0, 0.8):
            got = prefill_graph_vs_eager(eng, K, 16, tail, temperature)
            assert torch.equal(got["graph"], got["eager"])
            assert got["state_diff"] == 0.0 and got["state_max"] > 0
            assert got["graph_launches"] == got["eager_launches"] == 0
    for t, s in zip(state_tensors(eng), before):
        assert torch.equal(t, s)
    assert torch.equal(eng.generator.get_state(), rng)


def test_failed_prefill_capture_fails_its_wave_and_serving_goes_on(weights):
    """A capture that raises for one admission program: warmup() raises;
    serving, the wave that needed it fails its request with the error and
    the next wave, of another shape, serves."""
    def capture(fn, inputs):
        raise RuntimeError("capture refused")

    eng = _port_engine(weights[1], "paged")
    eng.executor = Executor("cpu", capture=capture)
    with pytest.raises(RuntimeError, match="capture refused"):
        eng.warmup()

    def only_16(fn, inputs):
        if inputs[0].shape == (1, 16):
            raise RuntimeError("capture refused")
        return _graph_like(fn, inputs)

    eng = _port_engine(weights[1], "paged")
    eng.executor = Executor("cpu", capture=only_16)
    eng.start()
    try:
        bad = eng.submit(list(range(30, 42)), max_new_tokens=4)
        with pytest.raises(RuntimeError, match="capture refused"):
            bad.result(timeout_s=60)
        good = eng.submit([5, 6, 7], max_new_tokens=4)
        assert len(good.result(timeout_s=60)) == 4
    finally:
        eng.stop()
    assert eng.allocator.used_pages == eng.prefix.resident_pages


def test_captures_of_two_executors_never_overlap():
    """Two executors (two engines of one process, as the disaggregated
    pair's) compiling at once from two threads: their captures run one
    after the other, never together (on the card a capture's device-wide
    synchronize would spoil the other's), while their eager warm-up runs
    may overlap."""
    import threading
    import time

    active, overlaps, events = [0], [], []
    lock = threading.Lock()

    def stub(fn, inputs):
        with lock:
            active[0] += 1
            overlaps.append(active[0])
        time.sleep(0.05)
        with lock:
            active[0] -= 1
            events.append("captured")
        return lambda: fn(*inputs)

    executors = [Executor("cpu", capture=stub) for _ in range(2)]
    barrier = threading.Barrier(2)

    def compile_some(ex, tag):
        barrier.wait()
        for i in range(4):
            ex.compile(f"{tag}-{i}", lambda x: x + 1, (torch.ones(2),))

    threads = [threading.Thread(target=compile_some, args=(ex, tag))
               for ex, tag in zip(executors, "ab")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert events == ["captured"] * 8
    assert max(overlaps) == 1
    assert [ex.captures for ex in executors] == [4, 4]

