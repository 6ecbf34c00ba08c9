"""Port int8 weights and the capacity plan vs the JAX package.

The same numpy inputs go through both: `quantize_weights` and
`_q_matmul`'s int8 activations and int32 accumulators must equal JAX's bit
for bit (integer work is exact in both; the f32 scales equal jitted JAX's,
which compiles `/ 127.0` into a product with the reciprocal, as the port
computes it). `_q_matmul`'s output is bit-equal in f32 and within one bf16
ulp (2**-7 relative) in bf16, where the final cast may round a value the
two frameworks' f32 epilogues put on either side of a midpoint. Engines on
an int8 tree bridged from JAX serve JAX's greedy tokens (paged, dense,
int8 KV), and the capacity plan is the reference's, with the int8 tree's
actual bytes. The card's `_int_mm` is held in test_torch_cuda_kernels.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jl
from gofr_tpu.tpu import capacity as jcap
from gofr_tpu.tpu.engine import LLMEngine as JEngine
from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
from gofr_tpu_torch.models import llama as tl
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.tpu import capacity as tcap
from gofr_tpu_torch.tpu.engine import LLMEngine
from gofr_tpu_torch.tpu.paging import PagedLLMEngine

CFG_J = jl.LlamaConfig.debug()
CFG_T = tl.LlamaConfig.debug()
DTYPES = ["float32", "bfloat16"]
REQUESTS = [([5, 6, 7], 8), ([9, 10, 11, 12, 13, 14, 15, 16, 17], 8),
            ([1, 2], 8), (list(range(40, 54)), 20)]
ENGINE = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8, 16))


class _QuietLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.contiguous().numpy()


def _jax_np(a) -> np.ndarray:
    a = np.asarray(jax.device_get(a))
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module", params=DTYPES)
def trees(request):
    """(dtype, JAX int8 tree as numpy, JAX float tree as numpy)."""
    cfg = dataclasses.replace(CFG_J, dtype=request.param)
    fp = jl.llama_init(cfg, seed=0)
    fp_np = jax.device_get(fp)
    q = jax.device_get(jl.quantize_weights(jl.llama_init(cfg, seed=0)))
    return request.param, q, fp_np


def test_quantize_weights_bit_equal_to_jax(trees):
    dtype, jq, fp_np = trees
    tq = tl.quantize_weights(params_from_numpy(fp_np, device="cpu"))
    flat_j, flat_t = dict(_flat(jq)), dict(_flat(tq))
    assert sorted(flat_j) == sorted(flat_t)
    for name, want in flat_j.items():
        got = flat_t[name]
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).split(".")[-1] == np.dtype(want.dtype).name \
            or (want.dtype.name == "bfloat16"
                and got.dtype == torch.bfloat16), name
        np.testing.assert_array_equal(_np(got), _jax_np(want), err_msg=name)


def test_matrices_are_stored_column_major(trees):
    """The int8 products read column-major weights (torch._int_mm's fast
    layout on the card); the leaf keeps the JAX shape [.., in, out]."""
    _, _, fp_np = trees
    tq = tl.quantize_weights(params_from_numpy(fp_np, device="cpu"))
    for name in tl._QUANT_AXES:
        w = tq["layers"][name]
        assert w.transpose(-1, -2).is_contiguous(), name
    assert tq["lm_head"].t().is_contiguous()
    assert tq["tok_emb"].is_contiguous()


def test_quantize_consumes_input_tree():
    fp = tl.llama_init(CFG_T, seed=0, device="cpu")
    tl.quantize_weights(fp)
    assert "tok_emb" not in fp and "lm_head" not in fp
    assert "wq" not in fp["layers"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_quantized_equals_quantize_of_init(dtype):
    """Bit for bit, scales included (the reference allows its scales an
    ulp, its jit fusing generation into quantization)."""
    cfg = dataclasses.replace(CFG_T, dtype=dtype)
    want = dict(_flat(tl.quantize_weights(tl.llama_init(cfg, 0, "cpu"))))
    got = dict(_flat(tl.llama_init_quantized(cfg, 0, "cpu")))
    assert list(got) == list(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
        assert got[name].stride() == want[name].stride(), name


def test_quantized_chunks_equal_the_whole_leaf(monkeypatch):
    """_quantized's chunking changes no bit."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((3, 40, 24)).astype(np.float32))
    whole = [tl._quantize_leaf(w[i], -2) for i in range(3)]
    monkeypatch.setattr(tl, "_QUANT_CHUNK", 5)
    w8, s = tl._quantized(w, -2)
    for i, (q, sc) in enumerate(whole):
        assert torch.equal(w8[i], q) and torch.equal(s[i], sc)
    e8, es = tl._quantized(w[0], -1)
    q, sc = tl._quantize_leaf(w[0], -1)
    assert torch.equal(e8, q) and torch.equal(es, sc)


@pytest.mark.parametrize("rows", [1, 8, 17, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_q_matmul_matches_jax(rows, dtype):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 128)) * 0.1).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx = jnp.asarray(x).astype(jdt)
    jw8, js = jax.jit(jl._quantize_leaf, static_argnums=1)(
        jnp.asarray(w).astype(jdt), -2)
    want = _jax_np(jax.jit(jl._q_matmul)(jx, jw8, js))
    # the reference's activation quantization and int32 product, on the
    # same inputs
    xf = jx.astype(jnp.float32)
    ax = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12)
    jx8 = jnp.round(xf * (127.0 / ax)).astype(jnp.int8)
    jacc = jax.lax.dot_general(jx8, jw8, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)

    tx = params_from_numpy({"x": np.asarray(jx)}, device="cpu")["x"]
    tw8 = torch.from_numpy(np.asarray(jw8).copy())
    ts = torch.from_numpy(np.asarray(js).copy())
    x8, tax = tl._quantize_rows(tx)
    np.testing.assert_array_equal(x8.numpy(), np.asarray(jx8))
    np.testing.assert_array_equal(tax.numpy(), np.asarray(ax))
    acc = tl._int_matmul(x8, tw8)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    got = _np(tl._q_matmul(tx, tw8, ts))
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
    # the head's f32 logits: bit-equal in both dtypes
    head = _np(tl._q_matmul(tx, tw8, ts, out_dtype=torch.float32))
    np.testing.assert_array_equal(head, _jax_np(jax.jit(
        lambda a, b, c: jl._q_matmul(a, b, c, out_dtype=jnp.float32))(
            jx, jw8, js)))


def test_q_matmul_pads_rows_to_the_card_minimum(monkeypatch):
    """Fewer than 17 rows reach torch._int_mm zero-padded to 32; the
    int32 result of the real rows is unchanged."""
    seen = []
    real = torch._int_mm

    def spy(a, b):
        seen.append(a.shape[0])
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", spy)
    rng = np.random.default_rng(0)
    for rows in (8, 16, 17, 33):
        a = torch.from_numpy(rng.integers(-127, 128, (rows, 64), np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (128, 64), np.int8)).t()
        got = tl._int_matmul(a, b)
        assert torch.equal(got, (a.long() @ b.long()).int())
    assert seen == [32, 32, 17, 33]


@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_logits_match_jax(dtype):
    """The whole forward on the int8 tree: the f32 debug model within
    2e-5 of JAX's logits (sums in other orders around the exact int8
    products), bf16 within 0.25 (the bf16 tolerance of the port's model
    checks); in f32 the same greedy token wherever JAX's top two logits
    lie further apart than twice the tolerance."""
    cfg_j = dataclasses.replace(CFG_J, dtype=dtype)
    cfg_t = dataclasses.replace(CFG_T, dtype=dtype)
    jq = jl.quantize_weights(jl.llama_init(cfg_j, seed=0))
    tq = params_from_numpy(jax.device_get(jq), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (2, 12))
    want = np.asarray(jax.jit(jl.llama_forward_nocache, static_argnums=1)(
        jq, cfg_j, jnp.asarray(toks, jnp.int32)))
    got = tl.llama_forward_nocache(tq, cfg_t, torch.from_numpy(toks)).numpy()
    tol = 2e-5 if dtype == "float32" else 0.25
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    if dtype == "float32":
        top2 = np.sort(want, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 2 * tol
        assert clear.sum() >= clear.size // 2
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])


def _jax_streams(cls, params, cfg, **kw):
    eng = cls(params, cfg, logger=_QuietLogger(), **ENGINE, **kw)
    eng.start()
    try:
        reqs = [eng.submit(p, max_new_tokens=n, temperature=0.0)
                for p, n in REQUESTS]
        return [r.result(timeout_s=300) for r in reqs]
    finally:
        eng.stop()


def _port_streams(cls, params, cfg, **kw):
    eng = cls(params, cfg, device="cpu", **ENGINE, **kw)
    eng.start()
    try:
        reqs = [eng.submit(p, max_new_tokens=n, temperature=0.0)
                for p, n in REQUESTS]
        return [r.result(timeout_s=300) for r in reqs]
    finally:
        eng.stop()


# (engine kind, config changes): the four configurations of the server
CONFIGS = {
    "paged": ("paged", {}),
    "paged-int8": ("paged", {"kv_dtype": "int8"}),
    "dense": ("dense", {"decode_attn": "kernel"}),
    "dense-int8": ("dense", {"decode_attn": "kernel", "kv_dtype": "int8"}),
}


@pytest.fixture(scope="module")
def int8_tree():
    jq = jl.quantize_weights(jl.llama_init(CFG_J, seed=0))
    return jq, params_from_numpy(jax.device_get(jq), device="cpu")


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engines_on_an_int8_tree_match_jax(int8_tree, config):
    """Greedy streams, token for token, after tests/test_weight_quant.py's
    engine test (there: int8 against the float engine)."""
    jq, tq = int8_tree
    kind, changes = CONFIGS[config]
    cfg_j = dataclasses.replace(CFG_J, **changes)
    cfg_t = dataclasses.replace(CFG_T, **changes)
    paged = dict(page_size=8) if kind == "paged" else {}
    want = _jax_streams(JPaged if kind == "paged" else JEngine, jq, cfg_j,
                        **paged)
    got = _port_streams(PagedLLMEngine if kind == "paged" else LLMEngine,
                        tq, cfg_t, **paged)
    assert got == want
    assert [len(t) for t in got] == [n for _, n in REQUESTS]


# -- the capacity plan ---------------------------------------------------------
PLANS = [
    # (n_slots, max_seq_len, budget, buckets, paged, kv_dtype, params_nbytes)
    (8, 1024, 80 << 30, (16, 32, 64, 128, 256), True, None, None),
    (8, 8192, 18 << 30, (16, 128, 512), False, None, None),
    (16, 8192, 20 << 30, (256, 1024), True, "int8", 8 << 30),
    (4, 4096, 10 << 30, (16, 64), False, "int8", 8 << 30),
    (64, 2048, 24 << 30, (512,), False, None, 9 << 30),
]


@pytest.mark.parametrize("case", range(len(PLANS)))
def test_plan_capacity_matches_jax(case):
    slots, seq, budget, buckets, paged, kv, pn = PLANS[case]
    cfg_j = dataclasses.replace(jl.LlamaConfig.llama3_8b(), kv_dtype=kv)
    cfg_t = dataclasses.replace(tl.LlamaConfig.llama3_8b(), kv_dtype=kv)
    want = jcap.plan_capacity(cfg_j, slots, seq, budget, buckets, paged=paged,
                              params_nbytes=pn)
    got = tcap.plan_capacity(cfg_t, slots, seq, budget, buckets, paged=paged,
                             params_nbytes=pn)
    assert dataclasses.asdict(got) == {**dataclasses.asdict(want),
                                       "graph_pool_bytes": 0}
    assert got.peak_bytes == want.peak_bytes


def test_plan_refuses_what_cannot_fit_as_jax_does():
    cfg_j, cfg_t = jl.LlamaConfig.llama3_8b(), tl.LlamaConfig.llama3_8b()
    with pytest.raises(ValueError, match="cannot serve"):
        jcap.plan_capacity(cfg_j, 8, 1024, 8 << 30)
    with pytest.raises(ValueError, match="cannot serve"):
        tcap.plan_capacity(cfg_t, 8, 1024, 8 << 30)


def test_graph_pool_margin_joins_the_peak():
    cfg = tl.LlamaConfig.llama3_8b()
    base = tcap.plan_capacity(cfg, 8, 4096, 40 << 30, (256,), paged=True)
    q8 = dataclasses.replace(cfg, kv_dtype="int8")
    with_pools = tcap.plan_capacity(cfg, 8, 4096, 40 << 30, (256,), paged=True,
                                    graph_pool_bytes=tcap.graph_pool_margin(q8))
    assert with_pools.peak_bytes == base.peak_bytes + (4 << 30)
    assert tcap.graph_pool_margin(cfg) == 2 << 30
    # tight enough that the margin alone forces a clamp
    tight = base.peak_bytes / 0.92 + (1 << 30)
    assert not tcap.plan_capacity(cfg, 8, 4096, int(tight), (256,),
                                  paged=True).clamped
    assert tcap.plan_capacity(cfg, 8, 4096, int(tight), (256,), paged=True,
                              graph_pool_bytes=2 << 30).clamped


def test_device_budget_is_zero_on_the_cpu():
    assert tcap.device_budget_bytes("cpu") == 0
    assert tcap.device_budget_bytes(None) == 0


@pytest.mark.parametrize("paged", [False, True])
def test_engine_plan_uses_actual_quantized_bytes(int8_tree, paged):
    """After tests/test_weight_quant.py:141: the plan budgets the measured
    int8 tree, and clamps as the JAX engine's does on the same budget."""
    jq, tq = int8_tree
    kw = dict(n_slots=8, max_seq_len=256, prefill_buckets=(8, 64),
              budget_bytes=1 << 21)
    if paged:
        kw["page_size"] = 8
    jeng = (JPaged if paged else JEngine)(jq, CFG_J, logger=_QuietLogger(),
                                          **kw)
    teng = (PagedLLMEngine if paged else LLMEngine)(tq, CFG_T, device="cpu",
                                                    **kw)
    assert teng.plan.params_bytes == tl.params_nbytes(tq) == \
        jl.params_nbytes(jq)
    assert teng.plan.params_bytes < CFG_T.param_count() * 2
    assert (teng.n_slots, teng.max_seq_len, teng.prefill_buckets) == (
        jeng.n_slots, jeng.max_seq_len, jeng.prefill_buckets)
    assert teng.plan.clamped and len(teng.slots) == teng.n_slots
