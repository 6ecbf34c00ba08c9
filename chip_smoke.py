"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Needs one CUDA
card, ``nvcc`` and ``nvidia-smi``; imports nothing of JAX or gofr_tpu.
Three short modes print no ok line: ``--flash`` (build, the flash checks,
flash times at B=1 T=S 16 / 80 / 256 / 1024 / 16384 and B=4 T=S=256),
``--decode`` (build, the decode-read checks, the four decode reads' times
at B=8 over ~200-token contexts, B=8 x 8192 and B=1 x 8192) and
``--prefill`` (build, the model's prefill wall time at [1, 256] and
[4, 256]).

Phases, one or more lines each, any failure exits non-zero:

1. card and build: the card's name and power limit (nvidia-smi), TF32 off,
   the kernels' three sources built from gofr_tpu_torch/ops/csrc with one
   nvcc each, in parallel; ptxas's registers and spill bytes per kernel
   (the decode reads per element type and instantiation), and the int ->
   float conversions in the decode reads' SASS (cuobjdump; an int8 read
   must convert its elements without I2F);
2. each kernel against its plain PyTorch version on the card, in bf16, at
   the stated tolerance (flash: H=32, Hkv=8, dh=128 at T=S 128 / 1000 /
   16384, causal and not, T=S=80 causal (two kv tiles), non-causal T=200
   over S=333 at dh 128 and 64, causal dh=64, and the served B=4 T=S=256
   window read and written in the model's [B, T, H, dh] layout; paged and
   paged-int8: B=8, ragged
   lengths around the page size, zero table tails, page sizes 16 and 128,
   and zeros at length 0; decode and decode-int8: B=8 over a dense S=1024
   cache at lengths 0, S, one past S and ragged ones between; the split
   reads, bf16 and int8, where the split matters: B=1 at 8192 and B=8
   ragged up to 8192 with lengths at the split's unit boundaries and one
   past them, page sizes 16 and 128, dense S=1000 and S=1001, the same bits
   from two calls in a row, zeros at length 0 and S+1 read as S);
3. the model on the card: Llama-3-8B at full width and depth, random
   weights from seed 0; one paged decode step and one dense decode step
   (decode kernel) must match a full recompute of the same context with
   plain attention, and one dense int8 and one paged int8 step must match a
   plain step over the same int8 cache, dequantized;
4. serving, four configurations of the port's app (gofr_tpu_torch/serve.py)
   on the same weights: paged bf16 (the main path), paged int8
   (KV_DTYPE=int8), dense (PAGED=false DECODE_ATTN=kernel) and dense int8
   (the same with KV_DTYPE=int8), each with ATTN_IMPL=flash. Each answers
   concurrent streaming and non-streaming POST /generate; every request
   returns its max_tokens, a repeated greedy prompt repeats its tokens, and
   the kernels' launch counters (zeroed just before each configuration)
   grew by n_layers per prefill (flash) and per decode step (that
   configuration's decode kernel, and no other);
5. timings: each kernel beside its bound, its plain version and, where one
   PyTorch call computes the same function (flash, dense bf16 decode), the
   library's scaled_dot_product_attention, at the shapes serving gave it
   (flash also in the model's layout and at 1024 and 16384; the decode
   reads also at B=8 x 8192 and B=1 x 8192), by CUDA events and, for flash,
   the decode reads and SDPA, the kernels alone (torch.profiler); the
   model's prefill wall time at each served window, and TTFT / decode tok/s
   of the served requests, each with the card's name and power limit;
6. profile: one decode block at B=8 in each serving configuration — host
   wall time per step against the card's busy time (torch.profiler), the
   launches per step (no more than before the split reads), the decode
   read's time per step and the kernels that take it.

The last three lines are the nvidia-smi line, the kernels JSON and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import http.client
import json
import math
import re
import sys
import threading
import time

H100_BF16_FLOPS = 989e12     # dense tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12      # dense int8 tensor-core peak, the same sheet
H100_HBM_BYTES_S = 3.35e12
# a kernel agrees with its plain version when every output element is within
# RTOL * |want| + ATOL_RMS * rms(want): both are bf16 roundings of f32
# results, which may sit one bf16 ulp (at most 2**-7 = 7.8e-3 of the value)
# apart, and the floor for outputs near 0 scales with the case's own outputs
# (|o| ~ 0.01 at S=16384, ~1 on early causal rows). Flash takes that floor
# per query row: both sides round p to bf16 before p . v (as the Pallas
# kernels do) from scores summed in different orders, so now and then one p
# rounds to the other side of a bf16 midpoint, which moves an early causal
# row's outputs (a few keys, one of them heavy) by up to ~2**-8 of that row's
# own scale, more than the case-wide floor of a long window
# (0.01 * rms = 3.7e-4 at 16384)
RTOL = 1e-2
ATOL_RMS = 1e-2
MODEL_TOL = 0.25             # bf16 logits after 32 layers, see check_model
DENSE_S = 1024               # the dense cache of phase 2's checks


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# -- phase 1: the build ---------------------------------------------------------
# a decode read's instantiation in a mangled kernel name: element type, dh,
# G, addressing
SPLIT_NAME = re.compile(r"(Kv(?:Bf16|Int8))ELi(\d+)ELi(\d+)ENS_\d+(Paged|Dense)")


def build_report(name: str, _build) -> None:
    """Log source `name`'s ptxas report (registers and spill bytes per
    kernel; the decode reads per element type and instantiation) and, from
    cuobjdump's SASS, the int -> float conversions in each decode read
    (I2F / I2FP), apart from the reciprocal seeds (I2F.*.RP) of integer
    division; fails when an int8 read converts its elements that way."""
    import subprocess
    from pathlib import Path

    lib = _build.target(name)
    text = lib.with_suffix(".log").read_text()
    regs, spills, groups = [], 0, {}
    for entry in text.split("Compiling entry function")[1:]:
        r = re.search(r"Used (\d+) registers", entry)
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       entry)
        n = int(r.group(1)) if r else 0
        regs.append(n)
        spills += int(sp.group(1)) + int(sp.group(2)) if sp else 0
        m = SPLIT_NAME.search(entry.split("'")[1] if "'" in entry else "")
        if m:
            groups.setdefault(m.group(1), []).append(
                f"{m.group(4)[0]}{m.group(2)}g{m.group(3)}:{n}")
    log(f"build {name}: {len(regs)} kernels, registers "
        f"{min(regs, default=0)}-{max(regs, default=0)}, spill bytes {spills}")
    for kind, items in sorted(groups.items()):
        log(f"build {name} {kind} registers (P/D dh gG:regs): "
            f"{' '.join(sorted(items))}")
    if not groups:
        return
    exe = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(exe), "--dump-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    conv = {}
    for func in sass.split("Function : ")[1:]:
        m = SPLIT_NAME.search(func.split(None, 1)[0])
        if not m:
            continue
        ops = re.findall(r"\b(I2FP?(?:\.[A-Z0-9_.]+)?)\s", func)
        seeds = sum(op.endswith(".RP") or ".RP." in op for op in ops)
        total = conv.setdefault(m.group(1), [0, 0, 0])
        total[0] += 1
        total[1] += len(ops) - seeds
        total[2] += seeds
    for kind, (n, other, seeds) in sorted(conv.items()):
        log(f"sass {name} {kind}: {n} kernels, int->float conversions "
            f"{other} (besides {seeds} I2F.RP seeds of integer division)")
    require(conv.get("KvInt8", [0, 0])[0] > 0,
            f"{name}: no int8 decode read in the SASS")
    require(conv["KvInt8"][1] == 0,
            f"{name}: the int8 decode read converts with I2F")


# -- phase 2: kernels against their plain versions ---------------------------
def agreement(got, want, per_row=False):
    """(max_abs_err, rms(want), worst, where) with worst the largest
    |got - want| / (ATOL_RMS * rms + RTOL * |want|) over the elements, at
    index `where`; rms is over the whole case, or with per_row over each
    output row (the last dim). The kernel agrees where worst <= 1 and every
    output is finite."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs()
    sq = w.square()
    rms = (sq.mean(-1, keepdim=True) if per_row else sq.mean()).sqrt()
    limit = (ATOL_RMS * rms + RTOL * w.abs()).clamp_min(1e-30)
    ratio = err / limit
    at = int(ratio.argmax())
    where = tuple(int(i) for i in torch.unravel_index(torch.tensor(at),
                                                      ratio.shape))
    worst = float(ratio.flatten()[at])
    if not bool(torch.isfinite(g).all()):
        worst = math.inf
    return float(err.max()), float(sq.mean().sqrt()), worst, where


def check_agreement(what: str, got, want, per_row=False) -> float:
    err, rms, worst, where = agreement(got, want, per_row)
    ok = worst <= 1.0
    floor = "rms of its row" if per_row else "rms"
    log(f"check {what}: max_abs_err={err:.3e} rms(want)={rms:.3e} "
        f"worst err/tol={worst:.3f} at {list(where)} (got "
        f"{float(got[where]):.6f} want {float(want[where]):.6f}) (tol "
        f"{RTOL}*|want| + {ATOL_RMS}*{floor}) {'ok' if ok else 'FAIL'}")
    if per_row:
        log(f"check {what}: with the case-wide rms floor instead, worst "
            f"err/tol={agreement(got, want)[2]:.3f}")
    require(ok, f"kernel disagrees with its plain version: {what}")
    return err


def _randn(shape, gen, dev):
    import torch

    return torch.randn(shape, generator=gen, device=dev,
                       dtype=torch.float32).to(torch.bfloat16)


def flash_inputs(B, H, Hkv, T, S, dh, dev, seed=0):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return (_randn((B, H, T, dh), gen, dev), _randn((B, Hkv, S, dh), gen, dev),
            _randn((B, Hkv, S, dh), gen, dev))


def paged_inputs(lengths, H, Hkv, dh, ps, dev, seed=0):
    """q, pools, a table of distinct random live pages with zero tails
    (width pow2(widest + 1), as the engine builds it), lengths."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    B = len(lengths)
    need = [max(1, -(-n // ps)) for n in lengths]
    NP = 1 << max(0, max(need)).bit_length()
    P = sum(need) + 1
    perm = torch.randperm(P - 1, generator=gen, device=dev).to(torch.int32) + 1
    table = torch.zeros((B, NP), dtype=torch.int32, device=dev)
    off = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[off:off + n]
        off += n
    return (_randn((B, H, dh), gen, dev), _randn((P, Hkv, dh, ps), gen, dev),
            _randn((P, Hkv, dh, ps), gen, dev), table,
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def dense_inputs(lengths, H, Hkv, dh, S, dev, seed=0):
    """q, a dense [B, Hkv, dh, S] k and v cache, lengths."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    B = len(lengths)
    return (_randn((B, H, dh), gen, dev), _randn((B, Hkv, dh, S), gen, dev),
            _randn((B, Hkv, dh, S), gen, dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def check_flash(dev) -> None:
    """The flash kernel against its plain version: H=32, Hkv=8 at the
    listed (T, S, dh, causal), then the served [4, 256] window in the
    model's [B, T, H, dh] layout through flash_attention (strided reads and
    writes, no copies)."""
    import torch

    from gofr_tpu_torch.ops.flash_attention import (KERNEL_BLOCK_KV,
                                                    flash_attention,
                                                    flash_attention_cuda,
                                                    flash_attention_plain)

    for T, S, dh, causal in [(128, 128, 128, True), (128, 128, 128, False),
                             (80, 80, 128, True), (200, 333, 128, False),
                             (1000, 1000, 128, True), (1000, 1000, 128, False),
                             (16384, 16384, 128, True),
                             (16384, 16384, 128, False),
                             (256, 256, 64, True), (200, 333, 64, False)]:
        q, k, v = flash_inputs(1, 32, 8, T, S, dh, dev, seed=T + dh)
        got = flash_attention_cuda(q, k, v, causal)
        want = flash_attention_plain(q, k, v, causal, KERNEL_BLOCK_KV)
        what = f"T=S={T}" if T == S else f"T={T} S={S}"
        check_agreement(f"flash {what} dh={dh} causal={causal}", got, want,
                        per_row=True)
        del q, k, v, got, want
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in flash_inputs(4, 32, 8, 256, 256, 128, dev, seed=4))
    got = flash_attention(q, k, v, True)
    require(got.shape == q.shape and got.is_contiguous(),
            "flash_attention: output is not a contiguous [B, T, H, dh]")
    want = flash_attention_plain(*(t.transpose(1, 2) for t in (q, k, v)),
                                 True, KERNEL_BLOCK_KV).transpose(1, 2)
    check_agreement("flash B=4 T=S=256 causal, [B, T, H, dh] views in and "
                    "out", got, want, per_row=True)
    torch.cuda.empty_cache()


def check_split(dev) -> None:
    """The split reads (decode_split.cuh), bf16 and int8, where the split
    matters: many blocks per row (B=1 at 8192; B=8 ragged up to 8192 with
    lengths at a unit boundary and one past it, at the end of the first
    round of units and one past it, short rows whose later blocks start past
    their length), page sizes 16 and 128, dense S=8192, S=1000 and S=1001
    (rows not 16-byte aligned) with lengths 0, S and S + 1; each call is made
    twice and must give the same bits (the block that combines a row resets
    its counter), and a row of length 0 gives zeros. bf16 is held against
    the gather reference (paged) or the plain version (dense), int8 against
    the plain versions with scales."""
    import torch

    from gofr_tpu_torch.ops.decode_attention import (SPLIT_TILE,
                                                     SPLIT_TILE_Q8,
                                                     decode_attention_cuda,
                                                     decode_attention_plain,
                                                     decode_attention_q8_cuda,
                                                     plan_split, quantize_kv)
    from gofr_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                    paged_attention_plain,
                                                    paged_attention_q8_cuda,
                                                    paged_attention_reference)

    H, Hkv, dh = 32, 8, 128
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def twice(what, fn):
        first = fn()
        require(torch.equal(first, fn()),
                f"{what}: two calls in a row differ (counters not reset?)")
        return first

    for quantized in (False, True):
        kind, tile = (("-int8", SPLIT_TILE_Q8) if quantized else
                      ("", SPLIT_TILE))
        for ps in (16, 128):
            NP = 1 << (-(-8192 // ps)).bit_length()   # as paged_inputs builds it
            for B in (1, 8):
                nsplit, unit = plan_split(B, Hkv, NP * ps, ps, sms, tile)
                lengths = ([8192] if B == 1 else
                           [unit, unit + 1, nsplit * unit, nsplit * unit + 1,
                            8192, 1, 100, 700])
                q, kp, vp, table, lens = paged_inputs(lengths, H, Hkv, dh, ps,
                                                      dev, seed=ps + B)
                if quantized:
                    (k8, ks), (v8, vs) = quantize_kv(kp), quantize_kv(vp)

                    def read(n):
                        return paged_attention_q8_cuda(q, k8, v8, ks, vs,
                                                       table, n)
                    want = paged_attention_plain(q, k8, v8, table, lens, ks,
                                                 vs)
                else:
                    def read(n):
                        return paged_attention_cuda(q, kp, vp, table, n)
                    want = paged_attention_reference(q, kp, vp, table, lens)
                what = (f"paged{kind} split ps={ps} B={B} nsplit={nsplit} "
                        f"unit={unit} lengths={lengths}")
                check_agreement(what, twice(what, lambda: read(lens)), want)
                zero = lens.clone()
                zero[-1] = 0
                require(bool((read(zero)[-1] == 0).all()),
                        f"{what}: length 0 is not zeros")
                del q, kp, vp, table, lens, want
        for S, B in ((8192, 1), (8192, 8), (1000, 8), (1001, 8)):
            nsplit, unit = plan_split(B, Hkv, S, None, sms, tile)
            lengths = ([S] if B == 1 else
                       [unit, unit + 1, nsplit * unit, nsplit * unit + 1, S,
                        S + 1, 0, 1])
            q, k, v, lens = dense_inputs(lengths, H, Hkv, dh, S, dev,
                                         seed=S + B)
            if quantized:
                (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)

                def read(n):
                    return decode_attention_q8_cuda(q, k8, v8, ks, vs, n)
                want = decode_attention_plain(q, k8, v8, lens, ks, vs)
            else:
                def read(n):
                    return decode_attention_cuda(q, k, v, n)
                want = decode_attention_plain(q, k, v, lens)
            what = (f"decode{kind} split S={S} B={B} nsplit={nsplit} "
                    f"unit={unit} lengths={lengths}")
            got = twice(what, lambda: read(lens))
            check_agreement(what, got, want)
            if B > 1:
                require(bool((got[6] == 0).all()),
                        f"{what}: length 0 is not zeros")
                clamped = lens.clone()
                clamped[5] = S
                require(torch.equal(read(clamped)[5], got[5]),
                        f"{what}: length S+1 does not read as S")
            del q, k, v, lens, got, want
    torch.cuda.empty_cache()


def check_kernels(dev) -> None:
    check_flash(dev)
    check_decode(dev)


def check_decode(dev) -> None:
    from gofr_tpu_torch.ops.decode_attention import (decode_attention_cuda,
                                                     decode_attention_plain,
                                                     decode_attention_q8_cuda,
                                                     quantize_kv)
    from gofr_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                    paged_attention_plain,
                                                    paged_attention_q8_cuda,
                                                    paged_attention_reference)

    for ps in (16, 128):
        lengths = [1, ps - 1, ps, ps + 1, 2 * ps + 3, 5 * ps, 700, 1000]
        q, kp, vp, table, lens = paged_inputs(lengths, 32, 8, 128, ps, dev,
                                              seed=ps)
        got = paged_attention_cuda(q, kp, vp, table, lens)
        want = paged_attention_reference(q, kp, vp, table, lens)
        check_agreement(f"paged ps={ps} lengths={lengths}", got, want)
        (k8, ks), (v8, vs) = quantize_kv(kp), quantize_kv(vp)
        check_agreement(f"paged-int8 ps={ps} lengths={lengths}",
                        paged_attention_q8_cuda(q, k8, v8, ks, vs, table, lens),
                        paged_attention_plain(q, k8, v8, table, lens, ks, vs))
        lens[3] = 0
        zero = paged_attention_cuda(q, kp, vp, table, lens)[3]
        require(bool((zero == 0).all()), "paged kernel: length 0 is not zeros")
        zero = paged_attention_q8_cuda(q, k8, v8, ks, vs, table, lens)[3]
        require(bool((zero == 0).all()),
                "paged-int8 kernel: length 0 is not zeros")
    log("check paged and paged-int8 length=0 row: zeros ok")
    S = DENSE_S
    lengths = [0, 1, 127, 128, 129, 700, S, S + 1]
    q, k, v, lens = dense_inputs(lengths, 32, 8, 128, S, dev, seed=11)
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    fp = decode_attention_cuda(q, k, v, lens)
    q8 = decode_attention_q8_cuda(q, k8, v8, ks, vs, lens)
    check_agreement(f"decode S={S} lengths={lengths}", fp,
                    decode_attention_plain(q, k, v, lens))
    check_agreement(f"decode-int8 S={S} lengths={lengths}", q8,
                    decode_attention_plain(q, k8, v8, lens, ks, vs))
    require(bool((fp[0] == 0).all()) and bool((q8[0] == 0).all()),
            "decode kernels: length 0 is not zeros")
    lens[-1] = S
    require(bool((decode_attention_cuda(q, k, v, lens)[-1] == fp[-1]).all())
            and bool((decode_attention_q8_cuda(q, k8, v8, ks, vs, lens)[-1]
                      == q8[-1]).all()),
            "decode kernels: a length past S does not read as S")
    log("check decode and decode-int8 length=0 row: zeros; length S+1 reads "
        "as S: ok")
    check_split(dev)


# -- phase 3: the model on the card ------------------------------------------
def check_model(params, cfg, dev) -> None:
    """Prefill a prompt (flash) and take ONE decode step through each
    decode path from its KV: paged and dense (decode kernel) against a full
    recompute of prompt + token through plain masked attention; dense int8
    and paged int8 against a plain step (plain masked read) over the same
    int8 cache, dequantized to bf16. The tolerance is on the max abs logit
    difference: bf16 activations through 32 layers on two different
    attention paths (logits are O(1) here)."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import (llama_decode_step_paged,
                                             llama_decode_step_paged_q8,
                                             llama_decode_step_unrolled,
                                             llama_decode_step_unrolled_q8,
                                             llama_prefill_last)
    from gofr_tpu_torch.ops.decode_attention import quantize_kv
    from gofr_tpu_torch.ops.paged_attention import (paged_write_prefill_scales,
                                                    paged_write_prefill_stacked)

    L, Hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    n, ps, S = 100, 128, 128
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)

    def prefill(tokens, c):
        T = tokens.shape[1]
        tk = torch.zeros((L, 1, Hkv, dh, T), dtype=torch.bfloat16, device=dev)
        tv = torch.zeros_like(tk)
        pos = torch.arange(T, device=dev)[None]
        lens = torch.tensor([T], dtype=torch.int32, device=dev)
        logits, tk, tv = llama_prefill_last(params, c, tokens, pos, lens, tk, tv)
        return logits, tk, tv, lens

    def dense(tmp, dtype):
        """Per-layer [1, ..., S] buffers holding `tmp`'s n tokens."""
        out = []
        for l in range(L):
            buf = torch.zeros((*tmp.shape[1:-1], S), dtype=dtype, device=dev)
            buf[..., :n] = tmp[l]
            out.append(buf)
        return out

    def check(what, got, want) -> None:
        torch.cuda.synchronize()
        require(tuple(got.shape) == (1, cfg.vocab_size), f"{what}: shape")
        require(bool(torch.isfinite(got).all()), f"{what}: not finite")
        diff = float((got - want).abs().max())
        log(f"check model: {what}: max_abs_diff={diff:.3e} (max |logit| "
            f"{float(want.abs().max()):.3f}) tol={MODEL_TOL} "
            f"{'ok' if diff <= MODEL_TOL else 'FAIL'}")
        require(diff <= MODEL_TOL, f"{what}: disagrees")

    flash = dataclasses.replace(cfg, attn_impl="flash")
    plain = dataclasses.replace(cfg, attn_impl="xla", decode_attn="xla")
    kernel = dataclasses.replace(cfg, decode_attn="kernel")
    logits0, tk, tv, lens = prefill(prompt, flash)
    nxt = int(torch.argmax(logits0[0]))
    tok = torch.tensor([nxt], device=dev)
    pos = torch.tensor([n], device=dev)
    full = torch.cat([prompt, torch.tensor([[nxt]], device=dev)], dim=1)
    want, _, _, _ = prefill(full, plain)

    pool_k = torch.zeros((L, 3, Hkv, dh, ps), dtype=torch.bfloat16, device=dev)
    pool_v = torch.zeros_like(pool_k)
    ptable = torch.tensor([[1]], dtype=torch.int32, device=dev)
    paged_write_prefill_stacked(pool_k, pool_v, tk, tv, ptable, lens)
    table = torch.tensor([[1, 0]], dtype=torch.int32, device=dev)
    step, _, _ = llama_decode_step_paged(params, cfg, tok, pos, pool_k,
                                         pool_v, table)
    check("paged decode step vs plain recompute", step, want)
    step, _, _ = llama_decode_step_unrolled(
        params, kernel, tok, pos, dense(tk, torch.bfloat16),
        dense(tv, torch.bfloat16))
    check("dense decode step (decode kernel) vs plain recompute", step, want)

    # int8: the same prefill KV quantized per token and head
    (k8, ks), (v8, vs) = quantize_kv(tk), quantize_kv(tv)
    deq_k = (k8.float() * ks[:, :, :, None, :]).to(torch.bfloat16)
    deq_v = (v8.float() * vs[:, :, :, None, :]).to(torch.bfloat16)
    want_q8, _, _ = llama_decode_step_unrolled(
        params, plain, tok, pos, dense(deq_k, torch.bfloat16),
        dense(deq_v, torch.bfloat16))
    step = llama_decode_step_unrolled_q8(
        params, kernel, tok, pos, dense(k8, torch.int8), dense(v8, torch.int8),
        dense(ks, torch.float32), dense(vs, torch.float32))[0]
    check("dense int8 decode step vs plain step over the dequantized cache",
          step, want_q8)
    pool_k = torch.zeros((L, 3, Hkv, dh, ps), dtype=torch.int8, device=dev)
    pool_v = torch.zeros_like(pool_k)
    pool_ks = torch.zeros((L, 3, Hkv, ps), dtype=torch.float32, device=dev)
    pool_vs = torch.zeros_like(pool_ks)
    paged_write_prefill_stacked(pool_k, pool_v, k8, v8, ptable, lens)
    paged_write_prefill_scales(pool_ks, ks, ptable, lens)
    paged_write_prefill_scales(pool_vs, vs, ptable, lens)
    step = llama_decode_step_paged_q8(params, cfg, tok, pos, pool_k, pool_v,
                                      pool_ks, pool_vs, table)[0]
    check("paged int8 decode step vs plain step over the dequantized cache",
          step, want_q8)


# -- phase 4: serving ----------------------------------------------------------
PROMPT_WORDS = ("the quick brown fox jumps over a lazy dog while seven "
                "tired engineers measure kernels on a hot card").split()


def make_prompt(n_chars: int, seed: int) -> str:
    import random

    rnd = random.Random(seed)
    out = ""
    while len(out) < n_chars:
        out += rnd.choice(PROMPT_WORDS) + " "
    return out[:n_chars]


def stream_request(port, prompt, max_tokens, out, key):
    """POST /generate (SSE); records the token events' arrival times."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.monotonic()
    conn.request("POST", "/generate", body=json.dumps(
        {"prompt": prompt, "max_tokens": max_tokens, "stream": True}),
        headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    times, text, done = [], [], None
    while True:
        line = resp.readline()
        if not line:
            break
        if not line.startswith(b"data: "):
            continue
        event = json.loads(line[6:])
        if event.get("done"):
            done = event
            resp.read()   # the closing chunk, so the close is clean
            break
        times.append(time.monotonic() - t0)
        text.append(event["text"])
    conn.close()
    out[key] = {"status": resp.status, "times": times, "text": "".join(text),
                "done": done}


def plain_request(port, prompt, max_tokens, out, key):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.monotonic()
    conn.request("POST", "/generate", body=json.dumps(
        {"prompt": prompt, "max_tokens": max_tokens, "stream": False}),
        headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    out[key] = {"status": resp.status, "seconds": time.monotonic() - t0,
                "data": body.get("data")}


def kernel_wrappers() -> dict:
    """Every kernel's wrapper, whose `launches` counts its launches."""
    from gofr_tpu_torch.ops.decode_attention import (decode_attention_cuda,
                                                     decode_attention_q8_cuda)
    from gofr_tpu_torch.ops.flash_attention import flash_attention_cuda
    from gofr_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                    paged_attention_q8_cuda)

    return {"flash_attention": flash_attention_cuda,
            "paged_attention": paged_attention_cuda,
            "paged_attention_q8": paged_attention_q8_cuda,
            "decode_attention": decode_attention_cuda,
            "decode_attention_q8": decode_attention_q8_cuda}


# serving configuration -> (env beside the common keys, its decode kernel)
SERVE_CONFIGS = {
    "paged": ({}, "paged_attention"),
    "paged-int8": ({"KV_DTYPE": "int8"}, "paged_attention_q8"),
    "dense": ({"PAGED": "false", "DECODE_ATTN": "kernel"}, "decode_attention"),
    "dense-int8": ({"PAGED": "false", "DECODE_ATTN": "kernel",
                    "KV_DTYPE": "int8"}, "decode_attention_q8"),
}


def serve_phase(params, cfg, dev, card: str, config: str,
                preset: str = "llama3-8b") -> dict:
    """Drive the port's /generate in one serving configuration; returns
    what the timing phase needs."""
    from gofr_tpu_torch.serve import build_app, build_engine

    extra, decode_kernel = SERVE_CONFIGS[config]
    wrappers = kernel_wrappers()
    env = {"MODEL_PRESET": preset, "ATTN_IMPL": "flash", "HTTP_PORT": "0",
           "MAX_BATCH": "8", "MAX_SEQ_LEN": "1024", "PAGE_SIZE": "128",
           "PREFILL_BUCKETS": "16,32,64,128,256", "REQUEST_TIMEOUT": "600",
           **extra}
    engine = build_engine(env, device=dev, params=params)
    app = build_app(env, engine=engine)
    app.start()
    try:
        # warm the path once (allocator caches, cuBLAS handles), uncounted
        warm = {}
        stream_request(app.http_port, make_prompt(40, 99), 4, warm, "w")
        require(warm["w"]["status"] == 200, f"{config}: warm-up failed")

        # every kernel count to 0 just before this configuration runs
        for fn in wrappers.values():
            fn.launches = 0
        engine.prefill_dispatches = engine.decode_steps = 0
        engine.prefill_shapes.clear()
        n_tok, n_plain = 32, 16
        lengths = [150, 180, 200, 220, 240, 130, 160]
        prompts = [make_prompt(n, i) for i, n in enumerate(lengths)]
        plain_prompt = make_prompt(250, 7)
        out: dict = {}
        threads = [threading.Thread(target=stream_request,
                                    args=(app.http_port, p, n_tok, out, i))
                   for i, p in enumerate(prompts)]
        threads.append(threading.Thread(
            target=plain_request,
            args=(app.http_port, plain_prompt, n_plain, out, "plain")))
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.monotonic() - t0
        require(all(not t.is_alive() for t in threads),
                f"{config}: requests hung")
        # a repeated greedy prompt, alone each time, repeats its tokens
        rep: dict = {}
        for key in ("r1", "r2"):
            stream_request(app.http_port, prompts[0], 24, rep, key)
        launches = {name: fn.launches for name, fn in wrappers.items()}
        prefills, steps = engine.prefill_dispatches, engine.decode_steps
        shapes = dict(engine.prefill_shapes)
        cache_len = getattr(engine, "_cache_len", None)
    finally:
        app.shutdown()

    for i in range(len(prompts)):
        r = out[i]
        require(r["status"] == 200 and r["done"] is not None,
                f"{config}: stream {i} failed: {r['status']}")
        require(r["done"]["tokens"] == n_tok and len(r["times"]) == n_tok,
                f"{config}: stream {i} returned {r['done']['tokens']} of "
                f"{n_tok} tokens")
    p = out["plain"]
    require(p["status"] == 201 and p["data"]["tokens"] == n_plain,
            f"{config}: non-streaming request failed: {p}")
    require(rep["r1"]["done"]["tokens"] == 24
            and rep["r1"]["text"] == rep["r2"]["text"],
            f"{config}: repeated greedy prompt gave different tokens")
    log(f"serve {config}: {len(prompts)} streams x {n_tok} tokens + 1 "
        f"non-streaming x {n_plain} in {wall:.2f}s; repeat of a greedy "
        f"prompt identical: ok")
    L = cfg.n_layers
    log(f"serve {config}: launches " + " ".join(
        f"{k}={v}" for k, v in launches.items())
        + f" (prefills={prefills}, decode steps={steps}, n_layers={L})")
    log(f"serve {config}: prefill windows [K, bucket] x count: " + ", ".join(
        f"[{k}, {b}] x {n}" for (k, b), n in sorted(shapes.items())))
    require(prefills > 0 and launches["flash_attention"] == L * prefills,
            f"{config}: flash launches do not match n_layers per prefill")
    require(steps > 0 and launches[decode_kernel] == L * steps,
            f"{config}: {decode_kernel} launches do not match n_layers per "
            f"decode step")
    others = {k: v for k, v in launches.items()
              if k not in ("flash_attention", decode_kernel) and v}
    require(not others, f"{config}: other decode kernels launched: {others}")
    ttft = sorted(out[i]["times"][0] * 1e3 for i in range(len(prompts)))
    tps = sorted((n_tok - 1) / (out[i]["times"][-1] - out[i]["times"][0])
                 for i in range(len(prompts)))
    log(f"serve {config}: ttft_ms p50={ttft[len(ttft) // 2]:.1f} "
        f"max={ttft[-1]:.1f} (client-side, {len(ttft)} concurrent streams) "
        f"[{card}]")
    log(f"serve {config}: decode tok/s per stream p50={tps[len(tps) // 2]:.1f}"
        f" min={tps[0]:.1f}; {len(prompts)} streams [{card}]")
    solo = rep["r2"]["times"]
    log(f"serve {config}: single stream ttft_ms={solo[0] * 1e3:.1f} decode "
        f"tok/s={(len(solo) - 1) / (solo[-1] - solo[0]):.1f} [{card}]")
    return {"launches": launches, "prefill_shapes": shapes,
            "prompt_lens": [len(engine.tokenizer.encode(p)) for p in prompts],
            "max_tokens": n_tok, "cache_len": cache_len}


# -- phase 5: timings ----------------------------------------------------------
def time_ms(fn, iters: int, flush) -> float:
    """Mean device time of fn over `iters` launches, CUDA events around each,
    the 50 MB L2 flushed before each (a forward pass finds them cold)."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def kernel_device_ms(fn, iters: int, name: str) -> float:
    """Device time per call of the kernels whose name holds `name`, from
    torch.profiler over `iters` back-to-back calls (L2 warm): the kernel's
    own time, without the host time that time_ms also sees when the host
    launches slower than the card runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.key)
    return us / 1e3 / iters if us > 0 else math.nan


def flash_bound(B, H, Hkv, T, S, dh, causal):
    pairs = T * (T + 1) // 2 if causal else T * S
    flops = 4.0 * B * H * pairs * dh
    nbytes = 2.0 * (2 * B * H * T * dh + 2 * B * Hkv * S * dh)
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def read_bound(lengths, H, Hkv, dh, quantized, index_bytes):
    """The decode reads' bound: K and V of each row's live tokens read once
    (bf16, or int8 plus the two f32 scales of each token and head; the
    ragged tail of a last page is not needed), q read and o written once in
    bf16, plus `index_bytes` (lengths, live table entries). The operations,
    ~4 * H * dh per live token, at the peak rate of the K/V type."""
    per_token = Hkv * (dh * 2 + 2 * 4) if quantized else Hkv * dh * 2 * 2
    nbytes = (sum(lengths) * per_token + 2 * 2 * len(lengths) * H * dh
              + index_bytes)
    ops = 4.0 * H * dh * sum(lengths)
    t_ops = ops / (H100_INT8_OPS if quantized else H100_BF16_FLOPS)
    t_bytes = nbytes / H100_HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def paged_bound(lengths, H, Hkv, dh, ps, quantized=False):
    """read_bound, indexing through the live pages' table entries."""
    pages = sum(-(-n // ps) for n in lengths)
    return read_bound(lengths, H, Hkv, dh, quantized,
                      4 * pages + 4 * len(lengths))


def time_flash(dev, B, T, causal, iters, flush):
    import torch
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.flash_attention import (KERNEL_BLOCK_KV,
                                                    flash_attention_cuda,
                                                    flash_attention_plain)

    H, Hkv, dh = 32, 8, 128
    q, k, v = flash_inputs(B, H, Hkv, T, T, dh, dev, seed=3)
    err = check_agreement(
        f"flash B={B} T=S={T} causal={causal}",
        flash_attention_cuda(q, k, v, causal),
        flash_attention_plain(q, k, v, causal, KERNEL_BLOCK_KV), per_row=True)
    ms = time_ms(lambda: flash_attention_cuda(q, k, v, causal), iters, flush)
    # the same values in the model's [B, T, H, dh] memory, as serving hands
    # them over (transposed views in, a [B, T, H, dh] output)
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    out = torch.empty_like(qs)
    strided_ms = time_ms(lambda: flash_attention_cuda(qs, ks, vs, causal,
                                                      out=out), iters, flush)
    device_ms = kernel_device_ms(
        lambda: flash_attention_cuda(qs, ks, vs, causal, out=out), iters,
        "flash_fwd_kernel")
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal,
                                                     KERNEL_BLOCK_KV),
                       max(1, iters // 2), flush)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True), iters, flush)
    bound_ms, by = flash_bound(B, H, Hkv, T, T, dh, causal)
    del q, k, v, qs, ks, vs, out
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err,
            "strided_ms": strided_ms, "device_ms": device_ms}


def log_flash_time(B, T, r, card) -> None:
    log(f"time flash B={B} T=S={T} causal: ms={r['ms']:.4f} (model layout "
        f"{r['strided_ms']:.4f}; kernel alone on the card, profiler, L2 warm "
        f"{r['device_ms']:.4f}) bound_ms={r['bound_ms']:.4f} "
        f"({r['bound_by']}, share {r['bound_ms'] / r['ms']:.3f}) plain_ms="
        f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} [{card}]")


def time_prefill(params, cfg, dev, B, T, iters, card) -> None:
    """Host wall time of one flash prefill of the whole model at [B, T]
    (llama_prefill_last, the served prefill's forward): mean, median and
    minimum of `iters` after a warm one, each ending in a synchronize."""
    import dataclasses

    import torch

    from gofr_tpu_torch.models.llama import llama_prefill_last

    c = dataclasses.replace(cfg, attn_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           device=dev)
    pos = torch.arange(T, device=dev)[None].expand(B, T)
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    tk = torch.zeros((cfg.n_layers, B, cfg.n_kv_heads, cfg.head_dim, T),
                     dtype=torch.bfloat16, device=dev)
    tv = torch.zeros_like(tk)
    walls = []
    for i in range(iters + 1):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        llama_prefill_last(params, c, tokens, pos, lens, tk, tv)
        torch.cuda.synchronize()
        if i:
            walls.append((time.monotonic() - t0) * 1e3)
    walls.sort()
    log(f"time prefill B={B} T={T} ({cfg.n_layers} layers, flash): wall_ms "
        f"mean={sum(walls) / len(walls):.3f} p50={walls[len(walls) // 2]:.3f}"
        f" min={walls[0]:.3f} over {len(walls)} [{card}]")
    del tk, tv
    torch.cuda.empty_cache()


# what the profiler's name of each decode read's kernel holds: both launch
# decode_split_kernel, told apart by its element type
READ_KERNEL = {False: "KvBf16", True: "KvInt8"}



def time_paged(dev, lengths, ps, iters, flush, quantized=False):
    from gofr_tpu_torch.ops.decode_attention import quantize_kv
    from gofr_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                    paged_attention_plain,
                                                    paged_attention_q8_cuda)

    H, Hkv, dh = 32, 8, 128
    q, kp, vp, table, lens = paged_inputs(lengths, H, Hkv, dh, ps, dev, seed=5)
    if quantized:
        (k8, ks), (v8, vs) = quantize_kv(kp), quantize_kv(vp)

        def kernel():
            return paged_attention_q8_cuda(q, k8, v8, ks, vs, table, lens)

        def plain():
            return paged_attention_plain(q, k8, v8, table, lens, ks, vs)
    else:
        def kernel():
            return paged_attention_cuda(q, kp, vp, table, lens)

        def plain():
            return paged_attention_plain(q, kp, vp, table, lens)
    err = check_agreement(f"paged{'-int8' if quantized else ''} "
                          f"B={len(lengths)} ps={ps} {brief(lengths)}",
                          kernel(), plain())
    ms = time_ms(kernel, iters, flush)
    device_ms = kernel_device_ms(kernel, iters, READ_KERNEL[quantized])
    plain_ms = time_ms(plain, max(1, iters // 5), flush)
    bound_ms, by = paged_bound(lengths, H, Hkv, dh, ps, quantized)
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": by,
            "max_abs_err": err}


def time_decode(dev, lengths, S, iters, flush, quantized=False):
    """The dense read at B=len(lengths) over an S-long cache. Its library
    yardstick (bf16 only): scaled_dot_product_attention with a length mask
    and enable_gqa, on the same K/V copied beforehand into the [B, Hkv, S,
    dh] layout it takes, by events and as the sum of every kernel the call
    launches. No PyTorch call reads int8 K/V with scales."""
    import torch
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.decode_attention import (decode_attention_cuda,
                                                     decode_attention_plain,
                                                     decode_attention_q8_cuda,
                                                     quantize_kv)

    H, Hkv, dh = 32, 8, 128
    q, k, v, lens = dense_inputs(lengths, H, Hkv, dh, S, dev, seed=6)
    lib_ms = lib_device_ms = None
    if quantized:
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)

        def kernel():
            return decode_attention_q8_cuda(q, k8, v8, ks, vs, lens)

        def plain():
            return decode_attention_plain(q, k8, v8, lens, ks, vs)
    else:
        def kernel():
            return decode_attention_cuda(q, k, v, lens)

        def plain():
            return decode_attention_plain(q, k, v, lens)

        k_sd = k.transpose(-1, -2).contiguous()          # [B, Hkv, S, dh]
        v_sd = v.transpose(-1, -2).contiguous()
        q_sd = q[:, :, None]                             # [B, H, 1, dh]
        mask = (torch.arange(S, device=dev)[None, :]
                < lens[:, None].long())[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(q_sd, k_sd, v_sd,
                                                  attn_mask=mask,
                                                  enable_gqa=True)
        lib_ms = time_ms(library, iters, flush)
        lib_device_ms = kernel_device_ms(library, iters, "")
    err = check_agreement(f"decode{'-int8' if quantized else ''} "
                          f"B={len(lengths)} S={S} {brief(lengths)}",
                          kernel(), plain())
    ms = time_ms(kernel, iters, flush)
    device_ms = kernel_device_ms(kernel, iters, READ_KERNEL[quantized])
    plain_ms = time_ms(plain, max(1, iters // 5), flush)
    bound_ms, by = read_bound(lengths, H, Hkv, dh, quantized, 4 * len(lengths))
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_device_ms": lib_device_ms,
            "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err}


def brief(lengths) -> str:
    return (f"lengths={lengths}" if len(set(lengths)) > 1 or len(lengths) < 3
            else f"lengths={len(lengths)}x{lengths[0]}")


def log_read_time(name, shape, r, card) -> None:
    lib = ""
    if r["library_ms"] is not None:
        lib = (f" library_ms={r['library_ms']:.4f} (alone "
               f"{r['library_device_ms']:.4f})")
    log(f"time {name} {shape}: ms={r['ms']:.4f} (kernel alone on the card, "
        f"profiler, L2 warm {r['device_ms']:.4f}) bound_ms="
        f"{r['bound_ms']:.4f} ({r['bound_by']}; share {r['bound_ms'] / r['ms']:.3f}"
        f" of the event time, {r['bound_ms'] / r['device_ms']:.3f} of the "
        f"kernel alone) plain_ms={r['plain_ms']:.4f}{lib} [{card}]")


def time_reads(dev, ctx, S, flush, card) -> dict:
    """The four decode reads at B=8 over the served contexts `ctx` (paged
    ps=128, dense S), logged and returned for the kernels line, then at
    B=8 x 8192 and B=1 x 8192 (paged ps=128, dense S=8192), logged."""
    import torch

    served = {
        "paged_attention": (time_paged(dev, ctx, 128, 50, flush),
                            f"B=8 ps=128 lengths={ctx}"),
        "paged_attention_q8": (time_paged(dev, ctx, 128, 50, flush, True),
                               f"B=8 ps=128 lengths={ctx}"),
        "decode_attention": (time_decode(dev, ctx, S, 50, flush),
                             f"B=8 S={S} lengths={ctx}"),
        "decode_attention_q8": (time_decode(dev, ctx, S, 50, flush, True),
                                f"B=8 S={S} lengths={ctx}"),
    }
    for name, (r, shape) in served.items():
        log_read_time(name, shape, r, card)
    for B in (8, 1):
        long = [8192] * B
        for quantized in (False, True):
            suffix = "_q8" if quantized else ""
            log_read_time(f"paged_attention{suffix}", f"B={B} ps=128 x 8192",
                          time_paged(dev, long, 128, 20, flush, quantized),
                          card)
            log_read_time(f"decode_attention{suffix}", f"B={B} S=8192 x 8192",
                          time_decode(dev, long, 8192, 20, flush, quantized),
                          card)
            torch.cuda.empty_cache()
    return served


# -- phase 6: where a decode step's time goes ---------------------------------
# kernel launches per decode step with one read kernel per layer before the
# reads were split over blocks (this profile phase, NVIDIA H100 80GB HBM3,
# 700 W): the split reads combine in the same launch and add none
LAUNCHES_PER_STEP = {"paged": 2621, "paged-int8": 3453, "dense": 2555,
                     "dense-int8": 3071}


def profile_decode(params, cfg, dev, card: str, config: str) -> None:
    """One decode block of a serving configuration's engine at B=8
    (contexts ~200 tokens), this thread playing the engine loop (the loop
    thread is not started): host wall time per step, the card's busy time
    per step from torch.profiler (kernels only), the idle share, the top
    kernels."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gofr_tpu_torch.models.tokenizer import DebugTokenizer
    from gofr_tpu_torch.tpu.engine import LLMEngine
    from gofr_tpu_torch.tpu.paging import PagedLLMEngine

    extra, _ = SERVE_CONFIGS[config]
    cfg = dataclasses.replace(cfg, decode_attn=extra.get("DECODE_ATTN", "xla"),
                              kv_dtype=extra.get("KV_DTYPE"))
    kw = dict(device=dev, n_slots=8, max_seq_len=1024, prefill_buckets=(256,))
    eng = (LLMEngine(params, cfg, **kw) if extra.get("PAGED") == "false"
           else PagedLLMEngine(params, cfg, page_size=128, **kw))
    tok = DebugTokenizer(cfg.vocab_size)
    for i in range(8):
        eng.submit(tok.encode(make_prompt(200, 100 + i)), max_new_tokens=400)
    eng._admit()
    eng._decode()                                  # warm
    torch.cuda.synchronize()
    block = eng.decode_block_size
    t0 = time.monotonic()
    eng._decode()
    wall_ms = (time.monotonic() - t0) * 1e3 / block
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._decode()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        log(f"profile decode {config} B=8: wall_ms_per_step={wall_ms:.3f}; "
            f"device busy time: not measured (profiler saw no kernels) "
            f"[{card}]")
        return
    busy_ms = busy_us / 1e3 / block
    per_step = round(sum(e.count for e in kernels) / block)
    log(f"profile decode {config} B=8 ctx~200: wall_ms_per_step={wall_ms:.3f} "
        f"device_busy_ms_per_step={busy_ms:.3f} idle_share="
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f} kernel launches per step="
        f"{per_step} (at most {LAUNCHES_PER_STEP[config]}) [{card}]")
    read = [e for e in kernels
            if READ_KERNEL[extra.get("KV_DTYPE") == "int8"] in e.key]
    log(f"profile decode {config} decode read: ms_per_step="
        f"{sum(e.self_device_time_total for e in read) / 1e3 / block:.4f} "
        f"calls_per_step={sum(e.count for e in read) / block:.0f}")
    require(per_step <= LAUNCHES_PER_STEP[config],
            f"{config}: {per_step} launches per decode step, more than "
            f"{LAUNCHES_PER_STEP[config]}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile decode {config} kernel: {e.key[:90]} ms_per_step="
            f"{e.self_device_time_total / 1e3 / block:.4f} calls_per_step="
            f"{e.count / block:.0f}")


def flash_only(dev, card) -> None:
    """--flash: the flash checks, then its times at the windows that test
    the design (one and two kv tiles, the served windows, long prompts)."""
    import torch

    check_flash(dev)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    for B, T in [(1, 16), (1, 80), (1, 256), (4, 256), (1, 1024),
                 (1, 16384)]:
        log_flash_time(B, T, time_flash(dev, B, T, True,
                                        5 if T > 1024 else 20, flush), card)


def decode_only(dev, card) -> None:
    """--decode: the decode-read checks, then the four reads' times at B=8
    over ~200-token contexts (those of serving's mid-decode; dense S=512),
    B=8 x 8192 and B=1 x 8192."""
    import torch

    check_decode(dev)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    time_reads(dev, [167, 197, 217, 237, 257, 147, 177, 167], 512, flush,
               card)


def main(argv=()) -> int:
    """No arguments: every phase, as the module docstring lists. --flash:
    build, then only the flash checks and times. --decode: build, then
    only the decode-read checks and times. --prefill: build, then only the
    model's prefill times at [1, 256] and [4, 256]. The three short modes
    print no ok line."""
    import torch

    mode = argv[0] if argv else None
    if mode not in (None, "--flash", "--decode", "--prefill"):
        log(f"FAIL unknown argument {mode!r} (--flash, --decode, --prefill "
            f"or none)")
        return 2

    if not torch.cuda.is_available():
        log("FAIL no CUDA device is visible")
        return 1
    try:
        from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
        from gofr_tpu_torch.ops import _build
        from gofr_tpu_torch.tpu.device import card_info, resolve_device
    except ImportError as exc:
        log(f"FAIL gofr_tpu_torch is not importable ({exc}); run from the "
            f"root of a checkout")
        return 1
    t_all = time.monotonic()
    try:
        dev = resolve_device("cuda:0")
        card = card_info().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"card: {card}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; torch.backends.cuda.matmul.allow_tf32="
            f"False, torch.backends.cudnn.allow_tf32=False")
        t0 = time.monotonic()
        took = _build.build(*_build.KERNELS)
        log(f"build: {json.dumps({k: round(v, 2) for k, v in took.items()})} "
            f"wall={time.monotonic() - t0:.2f}s (nvcc, sm_90a, parallel)")
        for name in _build.KERNELS:
            build_report(name, _build)

        if mode == "--flash":
            flash_only(dev, card)
            log(f"flash only: ok, total {time.monotonic() - t_all:.1f}s")
            return 0
        if mode == "--decode":
            decode_only(dev, card)
            log(f"decode only: ok, total {time.monotonic() - t_all:.1f}s")
            return 0
        if mode != "--prefill":
            check_kernels(dev)

        cfg = LlamaConfig.llama3_8b()
        t0 = time.monotonic()
        params = llama_init(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        log(f"model: llama3_8b {cfg.param_count() / 1e9:.2f}B params bf16, "
            f"random seed 0, init {time.monotonic() - t0:.1f}s, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
        if mode == "--prefill":
            for B, T in [(1, 256), (4, 256)]:
                time_prefill(params, cfg, dev, B, T, 10, card)
            log(f"prefill only: ok, total {time.monotonic() - t_all:.1f}s")
            return 0
        check_model(params, cfg, dev)
        served = {}
        for config in SERVE_CONFIGS:
            served[config] = serve_phase(params, cfg, dev, card, config)
            torch.cuda.empty_cache()

        flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
        # flash at every [K, bucket] window the main path dispatched; the
        # kernels line carries the most frequent one (ties: the most work)
        main = served["paged"]
        shapes = main["prefill_shapes"]
        K, bucket = max(shapes, key=lambda s: (shapes[s], s[0] * s[1]))
        flash_main = time_flash(dev, K, bucket, True, 20, flush)
        others = [(k, b) for k, b in sorted(shapes) if (k, b) != (K, bucket)]
        log_flash_time(K, bucket, flash_main, card)
        for B, T in others + [(1, 1024), (1, 16384)]:
            log_flash_time(B, T, time_flash(dev, B, T, True,
                                            5 if T > 1024 else 20, flush),
                           card)
        for B, T in sorted(shapes):
            time_prefill(params, cfg, dev, B, T, 10, card)
        # the decode reads at B=8 and the contexts of mid-decode in serving
        ctx = [n + main["max_tokens"] // 2 for n in main["prompt_lens"]]
        ctx = (ctx + ctx)[:8]
        S = served["dense"]["cache_len"]
        timed = {"flash_attention": (flash_main, "")}
        timed.update(time_reads(dev, ctx, S, flush, card))
        csrc = "gofr_tpu_torch/ops/csrc/"
        # kernel -> (source, the Pallas call it replaces, its serving phase)
        origin = {
            "flash_attention": ("flash_attention.cu",
                                "gofr_tpu/ops/flash_attention.py:186",
                                "paged"),
            "paged_attention": ("paged_attention.cu",
                                "gofr_tpu/ops/paged_attention.py:210",
                                "paged"),
            "paged_attention_q8": ("paged_attention.cu",
                                   "gofr_tpu/ops/paged_attention.py:210",
                                   "paged-int8"),
            "decode_attention": ("decode_attention.cu",
                                 "gofr_tpu/ops/decode_attention.py:206",
                                 "dense"),
            "decode_attention_q8": ("decode_attention.cu",
                                    "gofr_tpu/ops/decode_attention.py:206",
                                    "dense-int8"),
        }
        kernels = []
        for name, (src, replaces, config) in origin.items():
            r = {k: x for k, x in timed[name][0].items()
                 if k != "strided_ms"}
            kern = dict(name=name, route="cuda", source=csrc + src,
                        replaces=replaces,
                        launches=served[config]["launches"][name], **r)
            require(kern["launches"] > 0, f"{name}: no launch on its path")
            require(all(kern.get(k) is None or math.isfinite(kern[k])
                        for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "max_abs_err", "library_ms",
                                  "library_device_ms")),
                    f"non-finite timing for {name}")
            kernels.append(kern)
        for config in SERVE_CONFIGS:
            profile_decode(params, cfg, dev, card, config)
            torch.cuda.empty_cache()
        log(f"total: {time.monotonic() - t_all:.1f}s")
    except Exception as exc:  # noqa: BLE001 - any phase failing fails the run
        import traceback

        traceback.print_exc()
        log(f"FAIL {type(exc).__name__}: {exc}")
        return 1
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
