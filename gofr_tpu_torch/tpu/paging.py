"""Paged KV serving: page allocator + block-table engine.

Ports from ``gofr_tpu/tpu/paging.py``: ``PageAllocator`` (page 0 is the
garbage page and is never handed out) and ``PagedLLMEngine`` with the fused
K-way prefill (``_prefill_fn``, with ``_prefill_fn_q8`` as its int8
branch), the decode block (``_decode_fn_paged``, with
``_decode_fn_paged_q8`` as its int8 branch), ``_build_table`` with its +1
garbage column, page reservation at admission and release at finish.

K/V live in a fixed pool [L, P, Hkv, dh, page_size] allocated once — in
the model dtype, or int8 with f32 scale pools [L, P, Hkv, page_size] under
kv_dtype='int8'; a slot owns ceil((prompt + max_new) / page_size) pages,
mapped by a block table. The JAX engine donates the pools and the loop
state (tokens, positions, temperatures) to every program; here they are
persistent tensors updated in place. Not ported yet: the prefix cache
(ROADMAP A7), chunked prefill and speculative verify (A10), KV tiering,
disaggregated hand-off and migration (A11).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.llama import (DTYPES, llama_decode_step_paged,
                            llama_decode_step_paged_q8)
from ..ops.decode_attention import quantize_kv
from ..ops.paged_attention import (paged_write_prefill_scales,
                                   paged_write_prefill_stacked)
from .engine import GenerationRequest, LLMEngine, _Slot, check_kernel_config


class PageAllocator:
    """Free-list page ledger. Page ids run [0, n_pages); page 0 is reserved
    as the GARBAGE page and never handed out, so zero-filled block-table
    entries (inactive slot rows, dead columns) point at garbage by
    construction and a lock-step decode's junk writes for inactive rows can
    never land in a live page."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (1 usable + garbage)")
        self.n_pages = n_pages
        self.page_size = page_size
        self.garbage_page = 0
        self._free: List[int] = list(range(1, n_pages))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def pages_for(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.page_size))

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages or None (never partial)."""
        if n > len(self._free):
            return None
        taken, self._free = self._free[:n], self._free[n:]
        return taken

    def release(self, pages: Sequence[int]) -> None:
        self._free.extend(pages)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class PagedLLMEngine(LLMEngine):
    """Continuous-batching engine over a paged KV pool. Page budget:
    n_pages * page_size tokens in total across slots (default: every slot
    can reach max_seq_len, plus the garbage page)."""

    _paged = True

    def __init__(self, params, cfg, *, page_size: int = 128,
                 n_pages: Optional[int] = None, **kw):
        self.page_size = page_size
        self._requested_pages = n_pages
        super().__init__(params, cfg, **kw)

    # -- device state ---------------------------------------------------------
    def _init_device_state(self) -> None:
        cfg = self.cfg
        if self.device.type == "cuda":
            check_kernel_config(cfg)
        ps = self.page_size
        n_pages = self._requested_pages or (
            self.n_slots * math.ceil(self.max_seq_len / ps) + 1)
        self.allocator = PageAllocator(n_pages, ps)
        self._reservations: Dict[int, List[int]] = {}
        dev = self.device
        shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, cfg.head_dim, ps)
        dtype = torch.int8 if self._q8 else DTYPES[cfg.dtype]
        self.k_cache = torch.zeros(shape, dtype=dtype, device=dev)
        self.v_cache = torch.zeros_like(self.k_cache)
        self.k_scale = self.v_scale = None
        if self._q8:   # f32 dequant scale pools ride along
            self.k_scale = torch.zeros(shape[:3] + (ps,), dtype=torch.float32,
                                       device=dev)
            self.v_scale = torch.zeros_like(self.k_scale)
        self._init_loop_state()

    # -- admission: page reservation ------------------------------------------
    def submit(self, prompt_tokens, max_new_tokens: int = 128, **kw
               ) -> GenerationRequest:
        """Reject requests whose reservation could NEVER fit the pool:
        parked, they would hold the head of the admission heap forever."""
        total = min(len(prompt_tokens) + max_new_tokens, self.max_seq_len)
        need = self.allocator.pages_for(total)
        usable = self.allocator.n_pages - 1
        if need > usable:
            raise ValueError(
                f"request needs {need} pages ({total} tokens at page_size="
                f"{self.allocator.page_size}) but the pool has only {usable} "
                f"usable pages; shrink max_new_tokens or grow n_pages")
        return super().submit(prompt_tokens, max_new_tokens, **kw)

    def _request_pages(self, request: GenerationRequest) -> int:
        total = min(len(request.prompt_tokens) + request.max_new_tokens,
                    self.max_seq_len)
        return self.allocator.pages_for(total)

    def _admission_ready(self, request: GenerationRequest) -> bool:
        if request.id in self._reservations:
            return True
        pages = self.allocator.alloc(self._request_pages(request))
        if pages is None:
            return False
        self._reservations[request.id] = pages
        return True

    def _abort_admission(self, request: GenerationRequest) -> None:
        pages = self._reservations.pop(request.id, None)
        if pages is not None:
            self.allocator.release(pages)

    def _bind_pages(self, slot: _Slot, request: GenerationRequest) -> None:
        slot.pages = self._reservations.pop(request.id)

    def _finish_slot(self, slot: _Slot) -> None:
        if slot.pages is not None:
            self.allocator.release(slot.pages)
            slot.pages = None
        super()._finish_slot(slot)

    # -- programs -------------------------------------------------------------
    def _prefill_fn(self, ptokens, ptable, slots, lengths, new_temps):
        """Fused K-way paged admission: forward the [K, bucket] window
        (flash or plain attention over the fresh window) into temps of the
        model dtype, scatter the per-layer K/V into the slots' pages —
        quantized per token and head, scales beside them, under int8 —
        sample first tokens, and splice the loop state in place. ptable:
        [K, ceil(bucket/ps)]."""
        last, tmp_k, tmp_v = self._prefill_window(ptokens, lengths)
        # token t of row k goes to (ptable[k, t // ps], t % ps); pad junk
        # past lengths[k] is redirected to the garbage page
        if self._q8:
            tmp_k, ks = quantize_kv(tmp_k, axis=-2)   # scales [L, K, Hkv, b]
            tmp_v, vs = quantize_kv(tmp_v, axis=-2)
            paged_write_prefill_scales(self.k_scale, ks, ptable, lengths)
            paged_write_prefill_scales(self.v_scale, vs, ptable, lengths)
        paged_write_prefill_stacked(self.k_cache, self.v_cache, tmp_k, tmp_v,
                                    ptable, lengths)
        return self._splice_loop_state(last, slots, lengths, new_temps)

    def _decode_fn_paged(self, table, block: int):
        """`block` paged decode steps (the int8 step under kv_dtype='int8');
        table [B, n_table]. Returns the [B, block] sampled tokens and
        advances the loop state in place."""
        params, cfg = self.params, self.cfg
        if self._q8:
            def step(tok, pos):
                return llama_decode_step_paged_q8(
                    params, cfg, tok, pos, self.k_cache, self.v_cache,
                    self.k_scale, self.v_scale, table)[0]
        else:
            def step(tok, pos):
                return llama_decode_step_paged(
                    params, cfg, tok, pos, self.k_cache, self.v_cache,
                    table)[0]
        return self._decode_loop(step, block)

    # -- dispatch -------------------------------------------------------------
    def _build_table(self) -> np.ndarray:
        """Block table for the active slots, padded to a power-of-two width
        with one extra garbage column: a position past a row's pages clamps
        to the LAST column, which is 0 (garbage) for every row."""
        active = [(i, slot) for i, slot in enumerate(self.slots)
                  if slot.active]
        widest = max(len(slot.pages) for _, slot in active)
        table = np.zeros((self.n_slots, _pow2_at_least(widest + 1)),
                         dtype=np.int32)
        for i, slot in active:
            table[i, :len(slot.pages)] = slot.pages
        return table

    def _dispatch_prefill(self, bucket: int, slots_idx: List[int],
                          batch: List[GenerationRequest]) -> torch.Tensor:
        n_ptable = max(1, math.ceil(bucket / self.page_size))
        ptable = np.zeros((len(batch), n_ptable), dtype=np.int32)
        for row, request in enumerate(batch):
            prompt_pages = self._reservations[request.id][:n_ptable]
            ptable[row, :len(prompt_pages)] = prompt_pages
        ptokens, lengths, temps = self._prep_admission(bucket, batch)
        dev = self.device
        return self._prefill_fn(
            ptokens, torch.from_numpy(ptable).to(dev),
            torch.as_tensor(slots_idx, dtype=torch.long, device=dev),
            lengths, temps)

    def _dispatch_decode(self, block: int) -> torch.Tensor:
        table = torch.from_numpy(self._build_table()).to(self.device)
        return self._decode_fn_paged(table, block)
