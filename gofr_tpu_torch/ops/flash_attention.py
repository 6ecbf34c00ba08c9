"""Flash attention: the CUDA kernel, its plain PyTorch version, the oracle.

Ports ``gofr_tpu/ops/flash_attention.py``:

- ``attention_reference`` (the unblocked f32 oracle) and ``flash_attention``
  (same [B, T, H, dh] / [B, S, Hkv, dh] layout, same dispatch: mixed-length
  causal goes to the reference);
- the two Pallas kernels behind ``_flash_bhtd`` become one hand-written
  CUDA kernel (``csrc/flash_attention.cu``, tensor-core products) for
  tensors on the card, and ``flash_attention_plain``, a blocked
  online-softmax version of the same arithmetic in PyTorch, for tensors on
  the CPU.

On the card the model's [B, T, H, dh] tensors reach the kernel as strided
views and the output is allocated as [B, T, H, dh]: no copy on either side.

The backward pass (a recompute through the reference in JAX) is not ported:
the serving path runs forward only.
"""

from __future__ import annotations

import math

import torch

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# keys per kv tile of the CUDA kernel: the plain version at this block size
# rounds p at the same running maxima, so the two agree to the summation
# order (the JAX kernels' own block is 128, the plain version's default)
KERNEL_BLOCK_KV = 64


def attention_reference(q, k, v, *, causal: bool = True):
    """Unblocked GQA attention in f32 — the numerics oracle. Layout
    [B, T, H, dh] / [B, S, Hkv, dh]. When T < S under causal, queries are
    the LAST T positions."""
    B, T, H, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, T, Hkv, G, dh).float()
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) / math.sqrt(dh)
    if causal:
        mask = (torch.arange(S, device=q.device)[None, :]
                <= torch.arange(T, device=q.device)[:, None] + (S - T))
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return out.reshape(B, T, H, dh).to(q.dtype)


def flash_attention_plain(q, k, v, causal: bool, block_kv: int = 128):
    """The kernel's arithmetic in plain PyTorch, on [B, H, T, dh] q and
    [B, Hkv, S, dh] k/v: kv blocks folded into a running (max, sum, acc) in
    f32, causal kv blocks past the last query skipped, mask kv_pos <= q_pos
    (T == S under causal), p rounded to v's dtype before p . v as the Pallas
    kernels do (the sum l takes p unrounded). Memory is O(T * block_kv) per
    head, so it runs at lengths where the reference's [T, S] scores would
    not fit."""
    B, H, T, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    qf = q.float().reshape(B, Hkv, G * T, dh)             # rows (g, t)
    q_pos = torch.arange(T, device=q.device).repeat(G)    # [G * T]
    m = torch.full((B, Hkv, G * T, 1), DEFAULT_MASK_VALUE,
                   dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G * T, dh), dtype=torch.float32,
                      device=q.device)
    for j0 in range(0, S, block_kv):
        if causal and j0 > T - 1:
            break
        kb = k[:, :, j0:j0 + block_kv].float()
        vb = v[:, :, j0:j0 + block_kv].float()
        s = (qf @ kb.transpose(-1, -2)) * scale           # [B, Hkv, GT, bk]
        if causal:
            kv_pos = torch.arange(j0, j0 + kb.shape[2], device=q.device)
            s = torch.where(kv_pos[None, :] <= q_pos[:, None], s,
                            DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vb
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, T, dh).to(q.dtype)


def _strides(name, t):
    """(batch, head, token) element strides of a [B, H, T, dh] bf16 view
    the kernel can read: dh contiguous, rows 16-byte aligned. A dim of size
    1 is never stepped over, so its stride is passed as 0. Raises on
    anything else."""
    (n0, n1, n2, _), (s0, s1, s2, s3) = t.shape, t.stride()
    s0, s1, s2 = s0 if n0 > 1 else 0, s1 if n1 > 1 else 0, s2 if n2 > 1 else 0
    if s3 != 1 or (s0 | s1 | s2) % 8 or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous last dim and 16-byte "
                         f"aligned rows, got strides {tuple(t.stride())}")
    return s0, s1, s2


def flash_attention_cuda(q, k, v, causal: bool, out=None):
    """Launch ``csrc/flash_attention.cu`` on [B, H, T, dh] q and
    [B, Hkv, S, dh] k/v, bf16 on one CUDA device, dh in {64, 128} (causal
    needs T == S). Each may be any view whose last dim is contiguous with
    16-byte aligned rows (a transpose of [B, T, H, dh] is one). Writes into
    `out` ([B, H, T, dh], the same rules) when given, else into a new
    contiguous tensor, and returns it. Raises on any other input, or when
    the launch is refused; never falls back."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention_cuda takes bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, H, T, dh = q.shape
    _, Hkv, S, _ = k.shape
    if k.shape[0] != B or k.shape[3] != dh or H % Hkv:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)}")
    if dh not in (64, 128):
        raise ValueError(f"head_dim {dh} not supported (64 or 128)")
    if causal and T != S:
        raise ValueError("causal flash kernel needs T == S")
    if out is None:
        out = torch.empty((B, H, T, dh), dtype=q.dtype, device=q.device)
    elif (out.shape != q.shape or out.dtype != q.dtype
          or out.device != q.device):
        raise ValueError(f"out must be a {tuple(q.shape)} bf16 tensor on "
                         f"{q.device}")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            Hkv, T, S, dh, int(bool(causal)), 1.0 / math.sqrt(dh),
            *_strides("q", q), *_strides("k", k), *_strides("v", v),
            *_strides("out", out),
            torch.cuda.current_stream(q.device).cuda_stream)
    fn = _build.function("flash_attention")
    with torch.cuda.device(q.device):
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error "
                           f"{rc}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention(q, k, v, causal: bool = True):
    """Flash attention on [B, T, H, dh] q and [B, S, Hkv, dh] k/v (GQA folds
    query head h onto kv head h // (H // Hkv)). Returns a contiguous
    [B, T, H, dh] tensor in q.dtype. Mixed-length causal takes the exact
    oracle; everything else runs the CUDA kernel on a CUDA tensor (q, k, v
    read in place through transposed views, the output written in place)
    and the plain version on a CPU tensor."""
    if causal and q.shape[1] != k.shape[1]:
        return attention_reference(q, k, v, causal=causal)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if q.is_cuda:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        flash_attention_cuda(qt, kt, vt, causal, out=out.transpose(1, 2))
        return out
    if q.device.type == "cpu":
        return flash_attention_plain(qt, kt, vt, causal).transpose(
            1, 2).contiguous()
    raise ValueError(f"unsupported device {q.device}")
