"""Port flash attention vs the JAX package on the CPU.

The port's plain blocked version and its oracle are held against the JAX
`flash_attention` (the Pallas kernel in interpret mode, as the JAX tests run
it) and `attention_reference`, on the same numpy inputs. Tolerances: f32
1e-5 (same math, different blocking and summation order). bf16: the plain
version against the Pallas kernel 8e-3, one bf16 ulp of an O(1) output
(both round p to bf16 before p . v over the same 128-key blocks, so only
the summation order differs); the oracles 2e-2 (the reference rounds
nothing but its output, the kernels also round p).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# gofr_tpu.ops re-exports flash_attention (the function) under the module name
jfa = importlib.import_module("gofr_tpu.ops.flash_attention")
tfa = importlib.import_module("gofr_tpu_torch.ops.flash_attention")

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 8e-3}


def _qkv(seed, B, T, S, H, Hkv, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, dh), dtype=np.float32),
            rng.standard_normal((B, S, Hkv, dh), dtype=np.float32),
            rng.standard_normal((B, S, Hkv, dh), dtype=np.float32))


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


CASES = [
    # (B, T, S, H, Hkv, dh, causal): MHA and GQA, causal and non-causal,
    # lengths off the 128 block (padding masks on the JAX side)
    (2, 64, 64, 4, 4, 32, True),
    (2, 64, 64, 4, 4, 32, False),
    (1, 200, 200, 8, 2, 64, True),
    (1, 200, 200, 8, 2, 64, False),
    (2, 37, 53, 4, 2, 32, False),
    (1, 130, 130, 4, 1, 64, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,S,H,Hkv,dh,causal", CASES)
def test_flash_attention_matches_jax(B, T, S, H, Hkv, dh, causal, dtype):
    arrays = _qkv(7, B, T, S, H, Hkv, dh)
    want = jfa.flash_attention(*_jax(arrays, dtype), causal)
    got = tfa.flash_attention(*_torch(arrays, dtype), causal)
    assert tuple(got.shape) == (B, T, H, dh)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), atol=KERNEL_TOL[dtype],
                               rtol=KERNEL_TOL[dtype])
    assert got.is_contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_reference_matches_jax_reference(causal, dtype):
    arrays = _qkv(3, 2, 48, 48, 8, 2, 32)
    want = jfa.attention_reference(*_jax(arrays, dtype), causal=causal)
    got = tfa.attention_reference(*_torch(arrays, dtype), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_mixed_length_causal_takes_the_reference():
    """T < S under causal: queries are the LAST T positions (both
    packages route this to the oracle)."""
    arrays = _qkv(5, 1, 16, 48, 4, 2, 32)
    want = jfa.flash_attention(*_jax(arrays, "float32"), True)
    got = tfa.flash_attention(*_torch(arrays, "float32"), True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("block_kv", [16, 128])
def test_plain_blocked_version_matches_reference(block_kv):
    """Block size is invisible in the result; [B, H, T, dh] layout."""
    q, k, v = (torch.from_numpy(a).transpose(1, 2)
               for a in _qkv(9, 2, 70, 70, 8, 4, 32))
    got = tfa.flash_attention_plain(q, k, v, True, block_kv=block_kv)
    want = tfa.attention_reference(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=True)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want.numpy(),
                               atol=1e-5, rtol=1e-5)


def test_kernel_strides_of_the_model_layout():
    """A transposed [B, T, H, dh] view goes to the kernel as it is, its
    size-1 dims stepped by 0; views the kernel cannot read raise."""
    x = torch.zeros((2, 40, 8, 64), dtype=torch.bfloat16)
    assert tfa._strides("q", x.transpose(1, 2)) == (40 * 8 * 64, 64, 8 * 64)
    assert tfa._strides("q", x[:1].transpose(1, 2)) == (0, 64, 8 * 64)
    with pytest.raises(ValueError):
        tfa._strides("q", x.transpose(1, 3))                  # dh strided
    with pytest.raises(ValueError):
        tfa._strides("k", torch.zeros((2, 40, 8, 68))[..., :64]
                     .transpose(1, 2))                       # head stride 68


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 4, 16, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfa.flash_attention_cuda(q, q[:, :2], q[:, :2], True)


def test_plain_version_rounds_p_like_the_pallas_kernel():
    """bf16 p . v: the plain version follows the Pallas kernel's rounding of
    p, so it sits closer to the kernel than to the unrounded oracle."""
    arrays = _qkv(11, 1, 128, 128, 4, 2, 64)
    kernel = _np(jfa.flash_attention(*_jax(arrays, "bfloat16"), True))
    got = _np(tfa.flash_attention(*_torch(arrays, "bfloat16"), True))
    oracle = _np(tfa.attention_reference(*_torch(arrays, "float32"),
                                         causal=True))
    assert np.abs(got - kernel).max() < np.abs(got - oracle).max()
