"""Paged KV serving: page allocator + block-table engine.

Ports from ``gofr_tpu/tpu/paging.py``: ``PageAllocator`` (page 0 is the
garbage page and is never handed out) and ``PagedLLMEngine`` with the fused
K-way prefill (``_prefill_fn``), the decode block (``_decode_fn_paged``),
``_build_table`` with its +1 garbage column, page reservation at admission
and release at finish.

K/V live in a fixed pool [L, P, Hkv, dh, page_size] allocated once; a slot
owns ceil((prompt + max_new) / page_size) pages, mapped by a block table.
The JAX engine donates the pool and the loop state (tokens, positions,
temperatures) to every program; here they are persistent tensors updated
in place. Not ported yet: the prefix cache (ROADMAP A7), int8 pools (A8),
chunked prefill and speculative verify (A10), KV tiering, disaggregated
hand-off and migration (A11).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.llama import DTYPES, llama_decode_step_paged, llama_prefill_last
from ..ops.paged_attention import paged_write_prefill_stacked
from .engine import GenerationRequest, LLMEngine, _Slot
from .sampling import sample_tokens


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

    def __init__(self, params, cfg, *, page_size: int = 128,
                 n_pages: Optional[int] = None, **kw):
        if cfg.kv_dtype not in (None, cfg.dtype):
            raise ValueError(f"kv_dtype={cfg.kv_dtype!r} is not ported yet "
                             f"(int8 paged KV: ROADMAP A8)")
        self.page_size = page_size
        self._requested_pages = n_pages
        super().__init__(params, cfg, **kw)

    # -- device state ---------------------------------------------------------
    def _init_device_state(self) -> None:
        cfg = self.cfg
        if self.device.type == "cuda" and (
                cfg.dtype != "bfloat16" or cfg.head_dim not in (64, 128)
                or cfg.q_per_kv not in (1, 2, 4, 8)):
            raise ValueError(
                f"the CUDA kernels take bfloat16, head_dim 64 or 128 and "
                f"n_heads / n_kv_heads in (1, 2, 4, 8); this config has "
                f"{cfg.dtype}, {cfg.head_dim}, {cfg.q_per_kv}")
        ps = self.page_size
        n_pages = self._requested_pages or (
            self.n_slots * math.ceil(self.max_seq_len / ps) + 1)
        self.allocator = PageAllocator(n_pages, ps)
        self._reservations: Dict[int, List[int]] = {}
        dev = self.device
        shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, cfg.head_dim, ps)
        self.k_cache = torch.zeros(shape, dtype=DTYPES[cfg.dtype], device=dev)
        self.v_cache = torch.zeros_like(self.k_cache)
        B = self.n_slots
        # loop state, persistent on the device and updated in place
        self._tokens = torch.zeros((B,), dtype=torch.long, device=dev)
        self._positions = torch.zeros((B,), dtype=torch.long, device=dev)
        self._temps = torch.zeros((B,), dtype=torch.float32, device=dev)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(self._seed)

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
        (flash or plain attention over the fresh window), scatter the
        per-layer K/V into the slots' pages, sample first tokens, and
        splice the loop state in place. ptable: [K, ceil(bucket/ps)]."""
        cfg = self.cfg
        K, bucket = ptokens.shape
        L, _, Hkv, dh, _ = self.k_cache.shape
        tmp_k = torch.zeros((L, K, Hkv, dh, bucket), dtype=self.k_cache.dtype,
                            device=self.device)
        tmp_v = torch.zeros_like(tmp_k)
        pos_grid = torch.arange(bucket, device=self.device).expand(K, bucket)
        last, tmp_k, tmp_v = llama_prefill_last(
            self.params, cfg, ptokens, pos_grid, lengths, tmp_k, tmp_v)
        # token t of row k goes to (ptable[k, t // ps], t % ps); pad junk
        # past lengths[k] is redirected to the garbage page
        paged_write_prefill_stacked(self.k_cache, self.v_cache, tmp_k, tmp_v,
                                    ptable, lengths)
        first = sample_tokens(last, self.generator, new_temps,
                              top_k=self.top_k)
        self._tokens[slots] = first
        self._positions[slots] = lengths.long()
        self._temps[slots] = new_temps
        return first

    def _decode_fn_paged(self, table, block: int):
        """`block` paged decode steps; table [B, n_table]. Returns the
        [B, block] sampled tokens and advances the loop state in place."""
        tok, pos = self._tokens, self._positions
        out = []
        for _ in range(block):
            logits, _, _ = llama_decode_step_paged(
                self.params, self.cfg, tok, pos, self.k_cache, self.v_cache,
                table)
            tok = sample_tokens(logits, self.generator, self._temps,
                                top_k=self.top_k)
            pos = pos + 1
            out.append(tok)
        self._tokens.copy_(tok)
        self._positions.copy_(pos)
        return torch.stack(out, dim=1)

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
        K = len(batch)
        n_ptable = max(1, math.ceil(bucket / self.page_size))
        ptokens = np.zeros((K, bucket), dtype=np.int64)
        ptable = np.zeros((K, n_ptable), dtype=np.int32)
        for row, request in enumerate(batch):
            ptokens[row, :len(request.prompt_tokens)] = request.prompt_tokens
            prompt_pages = self._reservations[request.id][:n_ptable]
            ptable[row, :len(prompt_pages)] = prompt_pages
        lengths = np.asarray([len(r.prompt_tokens) for r in batch],
                             dtype=np.int32)
        temps = np.asarray([r.temperature for r in batch], dtype=np.float32)
        dev = self.device
        return self._prefill_fn(
            torch.from_numpy(ptokens).to(dev), torch.from_numpy(ptable).to(dev),
            torch.as_tensor(slots_idx, dtype=torch.long, device=dev),
            torch.from_numpy(lengths).to(dev), torch.from_numpy(temps).to(dev))

    def _dispatch_decode(self, block: int) -> torch.Tensor:
        table = torch.from_numpy(self._build_table()).to(self.device)
        return self._decode_fn_paged(table, block)
