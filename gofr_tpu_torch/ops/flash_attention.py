"""Flash attention: the CUDA kernel, its plain PyTorch version, the oracle.

Ports ``gofr_tpu/ops/flash_attention.py``:

- ``attention_reference`` (the unblocked f32 oracle) and ``flash_attention``
  (same [B, T, H, dh] / [B, S, Hkv, dh] layout, same dispatch: mixed-length
  causal goes to the reference);
- the two Pallas kernels behind ``_flash_bhtd`` become one hand-written
  CUDA kernel (``csrc/flash_attention.cu``) for tensors on the card, and
  ``flash_attention_plain``, a blocked online-softmax version of the same
  arithmetic in PyTorch, for tensors on the CPU.

The backward pass (a recompute through the reference in JAX) is not ported:
the serving path runs forward only.
"""

from __future__ import annotations

import math

import torch

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


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
    (T == S under causal). Memory is O(T * block_kv) per head, so it runs at
    lengths where the reference's [T, S] scores would not fit."""
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
        acc = acc * alpha + p @ vb
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, T, dh).to(q.dtype)


def flash_attention_cuda(q, k, v, causal: bool):
    """Launch ``csrc/flash_attention.cu`` on [B, H, T, dh] q and
    [B, Hkv, S, dh] k/v, contiguous bf16 on one CUDA device, dh in {64, 128}
    (causal needs T == S). Returns a new [B, H, T, dh] tensor. Raises on any
    other input, or when the launch is refused; never falls back."""
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    fn = _build.function("flash_attention")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H,
                Hkv, T, S, dh, int(bool(causal)), 1.0 / math.sqrt(dh), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error "
                           f"{rc}")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0


def flash_attention(q, k, v, causal: bool = True):
    """Flash attention on [B, T, H, dh] q and [B, S, Hkv, dh] k/v (GQA folds
    query head h onto kv head h // (H // Hkv)). Returns [B, T, H, dh] in
    q.dtype. Mixed-length causal takes the exact oracle; everything else
    runs the CUDA kernel on a CUDA tensor and the plain version on a CPU
    tensor."""
    if causal and q.shape[1] != k.shape[1]:
        return attention_reference(q, k, v, causal=causal)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if q.is_cuda:
        out = flash_attention_cuda(qt.contiguous(), kt.contiguous(),
                                   vt.contiguous(), causal)
    elif q.device.type == "cpu":
        out = flash_attention_plain(qt, kt, vt, causal)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return out.transpose(1, 2)
