"""Paged KV serving: page allocator + block-table engine.

Ports from ``gofr_tpu/tpu/paging.py``: ``PageAllocator`` (page 0 is the
garbage page and is never handed out) and ``PagedLLMEngine`` with the fused
K-way prefill (``_prefill_fn``, with ``_prefill_fn_q8`` as its int8
branch), the decode block (``_decode_fn_paged``, with
``_decode_fn_paged_q8`` as its int8 branch), ``_build_table`` with its +1
garbage column, page reservation at admission and release at finish, and
the prefix cache (``prefix_cache=True``, tpu/prefixcache.py): the match and
the evict-and-retry of ``_reserve_pages``, ``_abort_admission``,
``_tail_bucket`` / ``_admission_bucket``, ``_release_slot_pages``, the
tail-only program (``_prefix_fn``, with ``_prefix_fn_q8`` as its int8
branch) and its dispatch (``_dispatch_prefill_prefix``), and
``_assign_pages``, which registers every wave's full prompt pages.

K/V live in a fixed pool [L, P, Hkv, dh, page_size] allocated once — in
the model dtype, or int8 with f32 scale pools [L, P, Hkv, page_size] under
kv_dtype='int8'; a slot owns ceil((prompt + max_new) / page_size) pages,
mapped by a block table. The JAX engine donates the pools and the loop
state (tokens, positions, temperatures) to every program; here they are
persistent tensors updated in place.

Every dispatch runs through the program cache (tpu/executor.py), named as
``paging.py`` names them — on the card a CUDA graph: the decode block per
(table width, block), ``llama-paged-decode[-q8]-x{block}-NP{n_table}``; the
fused admission per (bucket, K), ``_prefill_program``,
``llama-paged-prefill[-q8]-{bucket}x{K}``; the tail-only admission per
(bucket, K, table width), ``_prefix_program``,
``llama-paged-prefix[-q8]-{bucket}x{K}-NP{n_table}``; each with ``-sc``
under sampling_controls, whose decode blocks come in two variants, with the
per-row filters and without (``-sc-nosort``; tpu/engine.py). Their inputs
(tables, tokens, rows) are static buffers filled before each call by one
host-to-device copy from the engine's pinned staging ring
(``LLMEngine._upload``). The warm-up before a capture points every write at
the garbage page 0 (zero tables and prefix lengths). ``warmup`` captures
every decode width, the reference's admission and tail sets and, with
k_variants, every tail program the configured buckets can reach.

Pages are released at sync, while younger dispatched blocks may still hold
the freed pages in their tables (a finished row keeps decoding junk into
its old pages). That is safe only because everything runs on the engine's
ONE stream in dispatch order, the argument of ``gofr_tpu/tpu/engine.py``'s
docstring: those blocks' writes land before the prefill of whichever
request is handed the pages next, and a row never reads a position it has
not written. A prefix hit may likewise share pages whose prefill is queued
but has not run; its tail prefill is queued after it.

Speculative verify and chunked prefill (ROADMAP A10): the verify program
per table width (``_verify_fn_paged`` as ``_verify_forward`` around the
shared ``engine.spec_accept_epilogue``, ``_verify_program(n_table)``,
``_verify_call``), ``llama-paged-verify-x{d}-NP{n_table}``; the chunk
programs per (chunk, K, bucket) over per-job temps (``_chunk_fn_paged``
with ``_chunk_fn_paged_q8_final`` as its int8 branch,
``_chunk_program_paged``, the job's page table), and
``_tail_routes_to_chunk``, which drops a prefix hit whose tail would still
chunk; the chunk path records what the reference's paged engine records
(no ``prefill_chunk`` event; ``admitted`` at the final chunk's binding).
A QoS preemption (``_release_slot_for_preempt``, the reference's override)
returns the slot's pages as a finish does, prefix-owned pages staying
cache-resident, so the resume at prompt + emitted is a tail-only wave on
the prompt's pages (inserted at its first admission).

The KV tier, the hand-off and migration (ROADMAP A11f) are the reference's:
``kv_host_tier_bytes`` / ``kv_redis`` / ``conversation_pin_s`` build a
``kvtier.HostKVTier`` outside the device state (it survives a reset);
``_evict_prefix_pages`` spills evicted prefix pages to it before their ids
return to the allocator (``_spill_pages``); ``_restore_from_tier`` extends
a prefix hit from it under the ``kv_restore`` segment, with the
config-skew guard (``_blob_fits``); ``pin_conversation``,
``tier_inventory`` and ``prewarm_from_tier``; the migration export of a
live slot (``_export_slot_kv``), the prefill pool's export at the
prefill's sync (``_handoff_slot``) and the landing of page blobs at
admission (``_admit_handoff``, with ``submit_handoff``'s never-fits
refusal), both under ``kv_handoff``. Where the reference runs donated
scatter programs that return new pools, the port's landing
(``_h2d_restore``) index-copies into the same pools and splices the loop
state by indexed writes, in place, on the engine's stream, from pinned
staging held until an event passes; the pulls (``_page_blobs``) gather on
the same stream, behind the wave that wrote the pages. A landing needs
that order: a finished row's junk blocks may still write into pages a
hand-off's reservation was given, and land before it. Counted in
``app_tpu_kv_tier_*``, ``app_tpu_disagg_*`` and the recorder's
``kv_restore`` / ``kv_handoff`` events.

The observability planes (tpu/engine.py's docstring) reach the paged
engine at the reference's sites: the reservation is the step ledger's
``page_alloc`` (a pool too short to reserve counts
``app_tpu_page_waits_total`` and records one ``page_wait`` event per
request), the page tables are ``host_prep``, and ``_finish_slot`` sets
``app_tpu_pages_used`` and ``app_tpu_kv_pool_pages{kind=used|free}``.

Under a mesh (ROADMAP A14a; tpu/engine.py's docstring) the pools
[L, P, Hkv/tp, dh, ps] and the int8 scale pools [L, P, Hkv/tp, ps] hold
this rank's KV heads, the reference's ``_place_state`` (kv_cache_spec,
kv_scale_pool_spec): they are shaped from the rank-local config. The page
allocator, the reservations and the prefix cache are the same on every
rank: the same admission waves drive them.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.llama import (DTYPES, llama_decode_step_paged,
                            llama_decode_step_paged_q8,
                            llama_prefill_paged_prefix,
                            llama_prefill_paged_prefix_q8,
                            llama_verify_step_paged)
from ..ops.decode_attention import quantize_kv
from ..ops.paged_attention import (paged_write_prefill_scales,
                                   paged_write_prefill_stacked)
from .engine import (GenerationRequest, LLMEngine, _admission_split, _Slot,
                     _np_plane, check_kernel_config)
from .executor import next_bucket
from .kvtier import HostKVTier, PageBlob, RedisKVTier
from .ownership import loop_only
from .prefixcache import PrefixCache
from .sampling import pack_controls


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
    can reach max_seq_len, plus the garbage page). prefix_cache=True
    shares whole prompt-prefix pages between requests (refcounted, evicted
    LRU back into the allocator; int8 pools share their scale pages with
    them)."""

    _paged = True
    # the reference's paged chunk path records no prefill_chunk event and
    # admits at the final chunk's binding (chunked false)
    _records_chunks = False
    supports_kv_handoff = True   # _admit_handoff lands shipped PageBlobs

    def __init__(self, params, cfg, *, page_size: int = 128,
                 n_pages: Optional[int] = None, prefix_cache: bool = False,
                 kv_host_tier_bytes: int = 0, kv_redis=None,
                 kv_redis_ttl_s: Optional[float] = None,
                 conversation_pin_s: float = 600.0, **kw):
        self.page_size = page_size
        self._requested_pages = n_pages
        self._prefix_enabled = bool(prefix_cache)
        # the KV tier (tpu/kvtier.py): prefix pages evicted from the pool
        # spill to a host-RAM LRU (optionally write-behind to a cold store)
        # and come back by one copy on the next hit instead of a prefill.
        # Built outside the device state: the blobs are content-keyed host
        # copies of deterministic KV, valid across a reset
        self.kv_tier = None
        self.conversation_pin_s = float(conversation_pin_s)
        self._kv_spilled = 0    # lifetime page counts, for /stats and
        self._kv_restored = 0   # /debug/engine
        if kv_host_tier_bytes:
            if not self._prefix_enabled:
                raise ValueError(
                    "kv_host_tier_bytes requires prefix_cache=True: tier "
                    "blobs are addressed by the prefix cache's chain keys")
            cold = None
            if kv_redis is not None:
                cold = (kv_redis if isinstance(kv_redis, RedisKVTier)
                        else RedisKVTier(kv_redis, ttl_s=kv_redis_ttl_s))
            self.kv_tier = HostKVTier(kv_host_tier_bytes, page_size,
                                      cold=cold)
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
        # the cache lives and dies with the pool it indexes
        self.prefix = PrefixCache(ps) if self._prefix_enabled else None
        # request id -> its matched prefix pages (ref'd), until assigned
        self._prefix_hits: Dict[int, List[int]] = {}
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

    def _restore_device_state(self) -> None:
        """The host structures rebuilt wholesale, as the reference's reset
        does (``_reservations`` and ``_prefix_hits`` cleared, a fresh
        allocator and prefix cache: every cached page is invalid), then the
        loop state restored in place; the pools are kept (replayed rows
        re-prefill their pages, re-reserved against the fresh allocator at
        re-admission)."""
        self._reservations.clear()
        self._prefix_hits.clear()
        self.allocator = PageAllocator(self.allocator.n_pages, self.page_size)
        self.prefix = (PrefixCache(self.page_size) if self._prefix_enabled
                       else None)
        super()._restore_device_state()

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

    def submit_handoff(self, prompt_tokens, emitted, **kw
                       ) -> GenerationRequest:
        """submit()'s never-fits refusal on the hand-off path: refused at
        the edge (the sender then falls back), not parked forever."""
        total = min(len(prompt_tokens) + kw.get("max_new_tokens", 128),
                    self.max_seq_len)
        need = self.allocator.pages_for(total)
        usable = self.allocator.n_pages - 1
        if need > usable:
            raise ValueError(
                f"hand-off needs {need} pages ({total} tokens at page_size="
                f"{self.allocator.page_size}) but the pool has only {usable} "
                f"usable pages; shrink max_new_tokens or grow n_pages")
        return super().submit_handoff(prompt_tokens, emitted, **kw)

    def _request_pages(self, request: GenerationRequest) -> int:
        # window + remaining budget: prompt + max_new for a fresh request
        # and for a replay alike, so a reservation is reset-stable
        total = min(len(request.resume_tokens)
                    + (request.max_new_tokens - request.generated),
                    self.max_seq_len)
        return self.allocator.pages_for(total)

    def _admission_ready(self, request: GenerationRequest) -> bool:
        """Page reservation (the reference's _reserve_pages): match the
        prompt's cached prefix once, reserve the pages past it, and when
        the pool is short evict idle cache pages into it and retry before
        parking the request."""
        if request.id in self._reservations:
            return True
        with self.steps.seg("page_alloc"):
            return self._reserve_pages(request)

    def _reserve_pages(self, request: GenerationRequest) -> bool:
        shared: List[int] = []
        # a hand-off skips the prefix walk: its KV arrives as page blobs,
        # landed into the plain reservation by _admit_handoff, so a match
        # would provide the same positions twice (a fallback drops the
        # blobs before parking again: the recompute gets the full walk)
        if self.prefix is not None and request.handoff_blobs is None:
            if request.id not in self._prefix_hits:
                hit = self.prefix.match(request.resume_tokens)
                if self.kv_tier is not None:
                    # extend the pool's hit from the tiers: a restored page
                    # costs one host-to-device page copy, not a page of
                    # prefill. Its own segment, nested in page_alloc
                    with self.steps.seg("kv_restore"):
                        hit = self._restore_from_tier(request, hit)
                if hit and self._tail_routes_to_chunk(request, hit):
                    # the tail would still chunk: drop the hit before the
                    # reservation is sized (the finished chunk job still
                    # inserts, so the next such prompt admits tail-only)
                    for page_id in hit:
                        self.prefix.unref(page_id)
                    hit = []
                self._prefix_hits[request.id] = hit
            shared = self._prefix_hits[request.id]
        need = self._request_pages(request) - len(shared)
        pages = self.allocator.alloc(need)
        if pages is None and self.prefix is not None:
            # idle cache pages are reclaimable: evict (spilling their KV to
            # the tier first when there is one) and retry before parking
            self.allocator.release(
                self._evict_prefix_pages(need - self.allocator.free_pages))
            pages = self.allocator.alloc(need)
        if pages is None:
            self._obs.counter("app_tpu_page_waits_total")
            if self.recorder is not None:
                # once per request: admission retries at loop speed while
                # the pool is exhausted
                self.recorder.record_event(request.id, "page_wait",
                                           once=True, need=need)
            return False
        self._reservations[request.id] = pages
        return True

    def _abort_admission(self, request: GenerationRequest) -> None:
        pages = self._reservations.pop(request.id, None)
        if pages is not None:
            self.allocator.release(pages)
        for page_id in self._prefix_hits.pop(request.id, None) or []:
            self.prefix.unref(page_id)

    def _tail_bucket(self, request: GenerationRequest,
                     shared: List[int]) -> int:
        tail = len(request.resume_tokens) - len(shared) * self.page_size
        return next_bucket(max(1, tail), self.prefill_buckets)

    def _tail_routes_to_chunk(self, request: GenerationRequest,
                              shared: List[int]) -> bool:
        return self._chunked(self._tail_bucket(request, shared))

    def _admission_bucket(self, request: GenerationRequest) -> int:
        """On a prefix hit, the admission window is the un-cached tail."""
        shared = self._prefix_hits.get(request.id)
        if not shared:
            return super()._admission_bucket(request)
        return self._tail_bucket(request, shared)

    def _tail_only(self, batch: List[GenerationRequest]) -> bool:
        """A wave with any hit runs the tail-only program; rows that missed
        ride along with prefix_len 0."""
        return any(self._prefix_hits.get(r.id) for r in batch)

    def _assign_pages(self, slots_idx: List[int],
                      batch: List[GenerationRequest]) -> None:
        """Move each request's pages onto its slot (shared prefix pages
        first, table order) and register the freshly written full prompt
        pages in the prefix cache."""
        for row, request in enumerate(batch):
            fresh = self._reservations.pop(request.id)
            shared = self._prefix_hits.pop(request.id, None) or []
            slot = self.slots[slots_idx[row]]
            slot.pages = shared + fresh
            if self.prefix is not None:
                self.prefix.insert(request.resume_tokens, slot.pages)

    def _release_slot_pages(self, slot: _Slot) -> None:
        """Return a slot's pages to the allocator; pages the prefix cache
        owns are unref'd and stay resident."""
        if slot.pages is None:
            return
        free = slot.pages
        if self.prefix is not None:
            free = []
            for page_id in slot.pages:
                if self.prefix.owns(page_id):
                    self.prefix.unref(page_id)   # stays cache-resident
                else:
                    free.append(page_id)
        self.allocator.release(free)
        slot.pages = None

    def _release_slot_for_preempt(self, slot: _Slot) -> None:
        """A QoS preemption on the paged engine: unlike a reset, which
        rebuilds the allocator, the pool survives, so the slot's pages go
        back first, as at a finish; pages the prefix cache owns stay
        resident, so the resume's prefill is mostly a prefix hit (its
        prompt's full pages were inserted at admission)."""
        self._release_slot_pages(slot)
        super()._release_slot_for_preempt(slot)

    def _finish_slot(self, slot: _Slot) -> None:
        self._release_slot_pages(slot)
        super()._finish_slot(slot)
        used, free = self.allocator.used_pages, self.allocator.free_pages
        self._obs.gauge("app_tpu_pages_used", used)
        self._obs.gauge("app_tpu_kv_pool_pages", used, kind="used")
        self._obs.gauge("app_tpu_kv_pool_pages", free, kind="free")

    # -- pages to and from the host -------------------------------------------
    # A spill, an export and a hand-off read pages the wave that wrote them
    # may still be computing, and a landing writes pages whose previous
    # owner's junk decode blocks may still be queued (the module docstring):
    # both are enqueued on the engine's stream, behind that work, and the
    # landing writes the pools IN PLACE (index_copy_ along the page axis):
    # every captured graph reads them at fixed addresses, so no pool is ever
    # rebound, where the reference's donated programs return new arrays.
    def _pool_planes(self) -> List[torch.Tensor]:
        planes = [self.k_cache, self.v_cache]
        if self._q8:
            planes += [self.k_scale, self.v_scale]
        return planes

    def _plane_dtype(self) -> np.dtype:
        """The numpy dtype a blob of this pool carries (bf16 as uint16)."""
        if self.k_cache.dtype == torch.bfloat16:
            return np.dtype(np.uint16)
        return np.dtype(str(self.k_cache.dtype).replace("torch.", ""))

    def _page_blobs(self, page_ids: Sequence[int],
                    windows: Sequence[Sequence[int]]) -> List[PageBlob]:
        """PageBlobs of `page_ids` (the pools' planes gathered on the engine's
        stream and pulled to pinned host memory), each with its token
        window."""
        with self._stream_ctx():
            (ids,) = self._h2d(np.asarray(page_ids, dtype=np.int64))
            host = self._pull_host(*[p.index_select(1, ids)
                                     for p in self._pool_planes()])
        k, v = host[0], host[1]
        ks, vs = (host[2], host[3]) if self._q8 else (None, None)
        return [PageBlob(toks, k[:, i], v[:, i],
                         None if ks is None else ks[:, i],
                         None if vs is None else vs[:, i])
                for i, toks in enumerate(windows)]

    def _h2d_restore(self, pages: Sequence[int], blobs) -> None:
        """Land blobs into `pages` of the pools, in place (see above): each
        plane's pages are staged straight into one pinned host tensor,
        copied on the engine's stream and index-copied along the page axis
        of k_cache / v_cache (and the scale pools under int8); the staging
        is kept until the copies are done. No padding page: nothing here is
        a compiled program."""
        names = ("k", "v", "k_scale", "v_scale")
        on_card = self._stream is not None
        hosts = []
        for pool, name in zip(self._pool_planes(), names):
            host = torch.empty((pool.shape[0], len(pages)) + pool.shape[2:],
                               dtype=pool.dtype, pin_memory=on_card)
            view = _np_plane(host)   # shares the staging's memory
            for i, blob in enumerate(blobs):
                view[:, i] = getattr(blob, name)
            hosts.append(host)
        with self._stream_ctx():
            (ids,) = self._h2d(np.asarray(pages, dtype=np.int64))
            if on_card:
                planes = [h.to(self.device, non_blocking=True)
                          for h in hosts]
                self._keep_staging(*hosts)
            else:
                planes = hosts
            for pool, plane in zip(self._pool_planes(), planes):
                pool.index_copy_(1, ids, plane)

    def _blob_fits(self, blob: PageBlob) -> bool:
        """The config-skew guard: a blob of another pool's shape or dtype
        (a cold-tier blob can outlive the process that wrote it, a peer can
        run another config) is a miss, not a crash."""
        L, _, Hkv, dh, ps = self.k_cache.shape
        return (blob.k.shape == (L, Hkv, dh, ps)
                and blob.k.dtype == self._plane_dtype()
                and (not self._q8 or blob.k_scale is not None))

    # -- the KV tier: spill on evict, restore on a hit ------------------------
    @loop_only
    def _evict_prefix_pages(self, n: int) -> List[int]:
        """prefix.evict_entries plus the spill: the evicted pages' KV goes
        to the tier BEFORE their ids return to the allocator (once handed
        out again, the pages are overwritten)."""
        entries = self.prefix.evict_entries(n)
        if entries and self.kv_tier is not None:
            try:
                self._spill_pages(entries)
            except Exception as exc:  # noqa: BLE001 - losing a spill costs
                # a later recompute; a device loss resurfaces at dispatch
                self.logger.debugf("KV spill failed: %s", exc)
        return [page_id for _, page_id, _ in entries]

    def _spill_pages(self, entries) -> None:
        blobs = self._page_blobs([pid for _, pid, _ in entries],
                                 [toks for _, _, toks in entries])
        stored = sum(1 for (key, _, _), blob in zip(entries, blobs)
                     if self.kv_tier.put(key, blob))
        if stored:
            self._kv_spilled += stored
            self._obs.counter("app_tpu_kv_tier_spilled_total", stored)

    def _restore_from_tier(self, request: GenerationRequest,
                           hit: List[int]) -> List[int]:
        """Continue the prefix walk past the pool's hit through the tiers:
        consecutive verified tier hits get fresh pages and are landed by
        _h2d_restore, so only the un-cached tail is prefilled. Returns the
        extended hit, the restored pages ref'd as matched ones are (insert
        grants the owner ref; finish and abort release it)."""
        tokens = request.resume_tokens
        ps = self.page_size
        matchable = max(0, (len(tokens) - 1) // ps)
        start = len(hit)
        if start >= matchable:
            return hit
        tier = self.kv_tier

        def corrupt_count() -> int:
            return tier.corrupt + (tier.cold.corrupt if tier.cold else 0)

        corrupt0 = corrupt_count()
        keys = self.prefix.keys_for(tokens, matchable)
        blobs = []
        for i in range(start, matchable):
            blob = tier.get(keys[i], tokens[i * ps:(i + 1) * ps])
            if blob is None or not self._blob_fits(blob):
                break
            blobs.append(blob)
        corrupt = corrupt_count() - corrupt0
        if corrupt:
            self._obs.counter("app_tpu_kv_tier_corrupt_total", corrupt)
        if blobs:
            self._obs.counter("app_tpu_kv_tier_hits_total", len(blobs))
        missed = matchable - start - len(blobs)
        if missed:
            self._obs.counter("app_tpu_kv_tier_misses_total", missed)
        if not blobs:
            return hit
        need = len(blobs)
        pages = self.allocator.alloc(need)
        if pages is None:
            self.allocator.release(
                self._evict_prefix_pages(need - self.allocator.free_pages))
            pages = self.allocator.alloc(need)
        if pages is None:
            # too tight to hold them: recompute rather than deadlock
            return hit
        try:
            self._h2d_restore(pages, blobs)
        except Exception as exc:  # noqa: BLE001 - the restore is optional:
            # recompute; a real device loss resurfaces at dispatch
            self.logger.debugf("KV restore failed: %s", exc)
            self.allocator.release(pages)
            return hit
        # registered under their chain keys: insert skips the `start`
        # cached ones and grants the owner ref on the new ones, the same
        # release discipline as freshly prefilled pages
        self.prefix.insert(list(tokens[:(start + need) * ps + 1]),
                           list(hit) + pages)
        self._kv_restored += need
        self._obs.counter("app_tpu_kv_tier_restored_total", need)
        if self.recorder is not None:
            self.recorder.record_event(request.id, "kv_restore", pages=need)
        return list(hit) + pages

    def pin_conversation(self, conversation_id: str,
                         tokens: Sequence[int]) -> int:
        """Pin a conversation trunk's chain keys in the host tier for
        conversation_pin_s seconds (callable from handler threads: the keys
        are pure, the tier locks). Pins protect host-tier residency only:
        pool eviction stays unconditional (a pool that cannot evict cannot
        admit), and the spill keeps the trunk on its way down.
        conversation_id is context for the logs."""
        if self.kv_tier is None or self.prefix is None:
            return 0
        n_full = len(tokens) // self.page_size
        if n_full <= 0:
            return 0
        keys = self.prefix.keys_for(tokens, n_full)
        pinned = self.kv_tier.pin(keys, self.conversation_pin_s)
        if pinned:
            self._obs.counter("app_tpu_kv_tier_pinned_total", pinned)
        return pinned

    def tier_inventory(self, limit: int = 64):
        """The host tier's newest pages as {key, tokens} rows: served at
        /debug/kvtier for peers' warm-boot pre-warm."""
        if self.kv_tier is None:
            return []
        return self.kv_tier.inventory(limit)

    def prewarm_from_tier(self, entries, limit: int = 64) -> int:
        """The warm boot's pre-warm: pull peer-advertised pages into host
        RAM through the tier's own get() (a shared cold tier's hits
        promote; every page is verified against its window). Off the
        serving path; returns the pages now resident."""
        if self.kv_tier is None:
            return 0
        warmed = 0
        for row in list(entries)[:max(0, int(limit))]:
            try:
                key = int(row["key"])
                tokens = [int(t) for t in row["tokens"]]
            except (KeyError, TypeError, ValueError):
                continue
            if self.kv_tier.get(key, tokens) is not None:
                warmed += 1
        if warmed:
            self._obs.counter("app_tpu_elastic_prewarm_pages_total", warmed)
        return warmed

    # -- hand-off and migration (tpu/disagg.py, tpu/migrate.py) ---------------
    def _export_slot_kv(self, slot: _Slot, request: GenerationRequest):
        """A migration export of a LIVE decode slot: the pages hold
        slot.length positions (prompt + every emitted token but the last),
        the window the peer's _admit_handoff checks. Anything else (no
        pages, a mismatch) degrades to the blob-less export: the peer
        recomputes, never reads a wrong blob."""
        n_ctx = slot.length
        if (slot.pages is None or n_ctx <= 0
                or n_ctx != len(request.resume_tokens) - 1):
            return None, max(0, len(request.resume_tokens) - 1)
        ps = self.page_size
        window = request.resume_tokens[:n_ctx]
        n_kv = self.allocator.pages_for(n_ctx)
        try:
            blobs = self._page_blobs(
                slot.pages[:n_kv],
                [window[i * ps:(i + 1) * ps] for i in range(n_kv)])
        except Exception as exc:  # noqa: BLE001 - a failed pull: replay
            self.logger.errorf("migration KV pull failed for %s: %s",
                               request.id, exc)
            return None, n_ctx
        return blobs, n_ctx

    @loop_only
    def _handoff_slot(self, slot: _Slot, request: GenerationRequest) -> None:
        """The prefill pool's export, at the prefill's sync right after the
        first token: pull the slot's prompt pages (the window the decode
        pool checks; the last page is usually partial), give them and the
        stream to the hand-off sink, then evacuate the slot WITHOUT a
        terminal None: the decode pool owns the stream. If the sink raises
        even for a blob-less hand-off, the slot stays and decodes here,
        degraded but never dropped."""
        if self._handoff_sink is None:
            return   # no worker wired: the slot decodes here
        ps = self.page_size
        n_ctx = slot.length
        window = request.resume_tokens[:n_ctx]
        n_kv = self.allocator.pages_for(n_ctx)
        handled, delivered = True, False
        try:
            with self.steps.seg("kv_handoff"):
                blobs = self._page_blobs(
                    slot.pages[:n_kv],
                    [window[i * ps:(i + 1) * ps] for i in range(n_kv)])
                delivered = bool(self._handoff_sink(request, blobs, n_ctx))
        except Exception:  # noqa: BLE001 - losing the export must not lose
            # the stream: offer the sink a blob-less (recompute) hand-off
            try:
                delivered = bool(self._handoff_sink(request, None, n_ctx))
            except Exception:  # noqa: BLE001
                handled = False
        if not handled:
            return   # the slot stays bound: local decode is the last resort
        if delivered:
            self.handoffs_total += 1
            self._obs.counter("app_tpu_disagg_handoffs_total")
        else:
            # the sink took the stream and arranged its own fallback
            self.handoff_fallbacks_total += 1
            self._obs.counter("app_tpu_disagg_fallback_total",
                              reason="export")
        # evacuated as a finish is, minus the terminal None
        self._release_slot_pages(slot)
        slot.request = None
        slot.length = 0
        slot.remaining = 0
        slot.history = None
        self._forget_row_controls(self.slots.index(slot))
        request.finished_at = time.monotonic()
        active_now = sum(1 for s in self.slots if s.active)
        used, free = self.allocator.used_pages, self.allocator.free_pages

        def job() -> None:
            if request.gen_span is not None:
                request.gen_span.set_attribute("tpu.tokens",
                                               request.generated)
                request.gen_span.set_attribute("disagg.handoff", True)
                request.gen_span.end()
            if self.recorder is not None:
                self.recorder.record_finished(request, "handoff")
            self._obs.gauge("app_tpu_active_slots", active_now)
            self._obs.gauge("app_tpu_pages_used", used)
            self._obs.gauge("app_tpu_kv_pool_pages", used, kind="used")
            self._obs.gauge("app_tpu_kv_pool_pages", free, kind="free")

        self._run_off_loop(job)

    def _admit_handoff(self, batch: List[GenerationRequest], free_iter,
                       dispatched) -> None:
        """Admit hand-offs with page blobs: check each request's blobs
        against THIS pool (page count, shape and dtype, the scale planes,
        the tokens against its resume window), land the wave's pages in one
        _h2d_restore into the head of each reservation, and splice the
        loop state in place, so the next decode block continues each
        stream: no prefill on this pool. A blob that fails a check parks
        its request again for a recompute (_handoff_fallback), as the
        tier's restore does."""
        ready = []
        with self.steps.seg("kv_handoff"):
            for request in batch:
                blobs = request.handoff_blobs
                # the KV covers the resume window but its last token, whose
                # KV this pool's first decode step writes: the state of a
                # colocated slot that just emitted its first token
                window = request.resume_tokens[:-1]
                reason = None
                if len(blobs) != self.allocator.pages_for(len(window)):
                    reason = "page_count"
                elif not all(self._blob_fits(b) for b in blobs):
                    reason = "shape"
                elif [t for b in blobs for t in b.tokens] != list(window):
                    reason = "content"
                if reason is not None:
                    self._handoff_fallback(request, reason)
                    dispatched.add(request.id)   # parked, not failed
                    continue
                ready.append(request)
            if not ready:
                return
            pages_all, blobs_all = [], []
            for request in ready:
                n_kv = len(request.handoff_blobs)
                pages_all.extend(self._reservations[request.id][:n_kv])
                blobs_all.extend(request.handoff_blobs)
            try:
                self._h2d_restore(pages_all, blobs_all)
            except Exception as exc:  # noqa: BLE001 - recoverable by a
                # recompute; a real device loss resurfaces at dispatch
                self.logger.errorf("hand-off landing failed: %s", exc)
                for request in ready:
                    self._handoff_fallback(request, "restore")
                    dispatched.add(request.id)
                return
        with self.steps.seg("host_prep"):
            if self.sampling_controls:
                new_temps = pack_controls([r.temperature for r in ready],
                                          [r.top_p for r in ready],
                                          [r.top_k for r in ready])
            else:
                new_temps = np.asarray([r.temperature for r in ready],
                                       dtype=np.float32)
            batch_id = next(self._batch_seq)
            now = time.monotonic()
            idxs, last_toks, lengths = [], [], []
            for request in ready:
                slot_idx = next(free_iter)
                slot = self.slots[slot_idx]
                n_kv = len(request.handoff_blobs)
                slot.request = request
                slot.length = len(request.resume_tokens) - 1
                # no -1: nothing emits at this binding (the other engine's
                # emissions are already in `generated`)
                slot.remaining = request.max_new_tokens - request.generated
                slot.pages = self._reservations.pop(request.id)
                slot.history = (list(request.resume_tokens)
                                if self.speculative_tokens else None)
                request.handoff_blobs = None   # free the host copies
                request.admitted_at = now
                self._obs.hist("app_tpu_queue_wait_seconds",
                               now - request.enqueued_at)
                idxs.append(slot_idx)
                last_toks.append(request.resume_tokens[-1])
                lengths.append(slot.length)
                for span in (request.span, request.gen_span):
                    if span is not None:
                        span.set_attribute("batch.id", batch_id)
                        span.set_attribute("tpu.slot", slot_idx)
                if self.recorder is not None:
                    self.recorder.record_admitted(request, slot_idx, 0,
                                                  batch_id=batch_id)
                    self.recorder.record_event(request.id, "kv_handoff",
                                               pages=n_kv)
                dispatched.add(request.id)
        # the loop state, spliced in place on the engine's stream: each slot
        # is fed its last emitted token at the position after its landed KV
        with self._stream_ctx():
            sl, toks, pos, temps = self._h2d(
                np.asarray(idxs, dtype=np.int64),
                np.asarray(last_toks, dtype=np.int64),
                np.asarray(lengths, dtype=np.int64), new_temps)
            self._tokens[sl] = toks
            self._positions[sl] = pos
            self._temps[sl] = temps
        self._filter_rows.update(i for i, r in zip(idxs, ready)
                                 if r.top_p or r.top_k)

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

    def _prefix_fn(self, ptokens, ptable, prefix_lens, slots, lengths,
                   new_temps):
        """Tail-only K-way admission: each row's shared prefix pages are
        live in the pool already; only the [K, bucket] tail window is
        computed and written (llama_prefill_paged_prefix, or its int8 twin
        under kv_dtype='int8'), then first tokens sample and the loop state
        splices as in the fused path. ptable: [K, NP], shared pages first."""
        bucket = ptokens.shape[1]
        project_last = (lengths - prefix_lens - 1).clamp(0, bucket - 1)
        if self._q8:
            last = llama_prefill_paged_prefix_q8(
                self.params, self.cfg, ptokens, prefix_lens, lengths,
                self.k_cache, self.v_cache, self.k_scale, self.v_scale,
                ptable, project_last)[0]
        else:
            last = llama_prefill_paged_prefix(
                self.params, self.cfg, ptokens, prefix_lens, lengths,
                self.k_cache, self.v_cache, ptable, project_last)[0]
        return self._splice_loop_state(last, slots, lengths, new_temps)

    def _decode_program_paged(self, n_table: int, block: int,
                              row_filter: bool = True):
        """The `block`-step paged decode program at table width n_table (with
        or without the per-row filters, see _decode_variants); its one
        static input is that width's [B, n_table] table, all zero (page 0)
        in its warm-up."""
        (table,) = self._static_inputs(
            ("table", n_table), [((self.n_slots, n_table), torch.int32)])
        kind = "-q8" if self._q8 else ""
        return self.executor.compile(
            f"llama-paged-decode{kind}-x{block}-NP{n_table}"
            f"{self._decode_tag(row_filter)}",
            lambda t: self._decode_fn_paged(t, block, row_filter), (table,),
            warmup=lambda: self._warmup_state(table.zero_),
            generators=(self.generator,))

    def _prefill_program(self, bucket: int, K: int,
                         slots: Optional[Sequence[int]] = None):
        """The fused K-way paged admission at `bucket` (the reference's
        ``_prefill_program(bucket, K)``). Static inputs: tokens [K, bucket],
        the page table [K, ceil(bucket / ps)], then the rows."""
        n_ptable = max(1, math.ceil(bucket / self.page_size))
        kind = "-q8" if self._q8 else ""
        return self._admission_program(
            f"llama-paged-prefill{kind}-{bucket}x{K}{self._id_tag}",
            self._prefill_fn,
            ("prefill", bucket, K), [((K, bucket), torch.long),
                                     ((K, n_ptable), torch.int32),
                                     *self._row_specs(K)], slots)

    def _prefix_program(self, bucket: int, K: int, n_table: int,
                        slots: Optional[Sequence[int]] = None):
        """The tail-only K-way admission at `bucket` over tables n_table
        wide (the reference's ``_prefix_program(bucket, K, n_table)``).
        Static inputs: tokens [K, bucket], the table [K, n_table], the prefix
        lengths [K] int32, then the rows."""
        kind = "-q8" if self._q8 else ""
        return self._admission_program(
            f"llama-paged-prefix{kind}-{bucket}x{K}-NP{n_table}"
            f"{self._id_tag}",
            self._prefix_fn, ("prefix", bucket, K, n_table),
            [((K, bucket), torch.long), ((K, n_table), torch.int32),
             ((K,), torch.int32), *self._row_specs(K)], slots)

    def _admission_program(self, name, fn, key, specs, slots):
        inputs = self._static_inputs(key, specs)
        return self.executor.compile(
            name, fn, inputs,
            warmup=lambda: self._warmup_state(
                lambda: self._harmless_wave(inputs, slots)),
            generators=(self.generator,))

    def _verify_forward(self, drafts, table):
        return llama_verify_step_paged(self.params, self.cfg, self._tokens,
                                       drafts, self._positions, self.k_cache,
                                       self.v_cache, table)[:2]

    def _verify_program(self, n_table: int, row_filter: bool = True):
        """The paged verify program at table width n_table (the reference's
        ``_verify_program(n_table)``, ``llama-paged-verify-x{d}-NP{n}``,
        with the decode blocks' variant tag). Static inputs: the table
        [B, n_table] (all zero, page 0, in its warm-up), then the drafts
        (_verify_specs)."""
        inputs = self._static_inputs(
            ("verify", n_table),
            [((self.n_slots, n_table), torch.int32), *self._verify_specs()])
        return self.executor.compile(
            f"llama-paged-verify-x{self.speculative_tokens}-NP{n_table}"
            f"{self._decode_tag(row_filter)}",
            lambda table, drafts, lens: self._verify_fn(drafts, lens,
                                                        row_filter, table),
            inputs, warmup=lambda: self._warmup_state(inputs[0].zero_),
            generators=(self.generator,))

    def _verify_call(self, drafts: np.ndarray, lens: np.ndarray
                     ) -> torch.Tensor:
        table = self._build_table()
        return self._call(self._verify_program(table.shape[1],
                                               self._row_filter_now()),
                          (table, drafts, lens), "engine.verify")

    # -- chunked prefill into per-job temps -----------------------------------
    # A job's chunks run against temps of its bucket's width, [L, K, Hkv, dh,
    # bucket] in the model dtype, not the pool (its pages are not needed
    # until the end); the FINAL chunk scatters the whole window into the
    # pages as the fused wave does (quantized once, under int8). The dense
    # engine's parking is not needed: a reserved slot's table row is all
    # zeros, so lock-step junk between chunks lands in the garbage page.
    def _chunk_key(self, bucket: int, K: int) -> tuple:
        return ("chunk", self.chunk_prefill_tokens, K, bucket)

    def _chunk_state_specs(self, key: tuple) -> list:
        """tmp_k, tmp_v [L, K, Hkv, dh, bucket] (model dtype) and the
        `selected` logits [K, V] f32."""
        cfg, K, bucket = self.cfg, key[2], key[3]
        tmp = ((cfg.n_layers, K, cfg.n_kv_heads, cfg.head_dim, bucket),
               DTYPES[cfg.dtype])
        return [tmp, tmp, ((K, cfg.vocab_size), torch.float32)]

    def _chunk_fn_paged(self, tmp_k, tmp_v, selected, final: bool, ctokens,
                        cpositions, ptable, start, slots, lengths,
                        new_temps):
        """One paged chunk dispatch (the reference's ``_chunk_fn_paged``,
        with ``_chunk_fn_paged_q8_final`` as its int8 branch): the chunk's
        forward into the job's temps; the final one scatters the whole
        window into the pages through ptable [K, ceil(bucket / ps)] (pad
        past lengths to page 0), quantizing the float window once under
        int8, then samples and splices as a fused wave does. Returns the
        [K] first tokens (final) or `selected`."""
        self._chunk_forward(selected, ctokens, cpositions, start, slots,
                            lengths, tmp=(tmp_k, tmp_v))
        if not final:
            return selected
        if self._q8:
            k8, ks = quantize_kv(tmp_k, axis=-2)     # scales [L, K, Hkv, b]
            v8, vs = quantize_kv(tmp_v, axis=-2)
            paged_write_prefill_scales(self.k_scale, ks, ptable, lengths)
            paged_write_prefill_scales(self.v_scale, vs, ptable, lengths)
            paged_write_prefill_stacked(self.k_cache, self.v_cache, k8, v8,
                                        ptable, lengths)
        else:
            paged_write_prefill_stacked(self.k_cache, self.v_cache, tmp_k,
                                        tmp_v, ptable, lengths)
        return self._splice_loop_state(selected, slots, lengths, new_temps)

    def _chunk_program_paged(self, chunk: int, K: int, bucket: int,
                             final: bool,
                             slots: Optional[Sequence[int]] = None):
        """The paged chunk program (the reference's
        ``_chunk_program_paged``), keyed on the bucket too (the temps are
        bucket-wide): ``llama-paged-chunk-{chunk}x{K}-b{bucket}`` and
        ``llama-paged-chunk[-q8]-final-{chunk}x{K}-b{bucket}``. Static
        inputs: _chunk_specs with the page table; the carried temps and
        `selected` are _chunk_state's."""
        key = self._chunk_key(bucket, K)
        n_ptable = max(1, math.ceil(bucket / self.page_size))
        inputs = self._static_inputs(key, self._chunk_specs(
            K, [((K, n_ptable), torch.int32)]))
        tmp_k, tmp_v, selected = self._chunk_state(key)
        kind = ("-q8-final" if self._q8 else "-final") if final else ""
        return self.executor.compile(
            f"llama-paged-chunk{kind}-{chunk}x{K}-b{bucket}{self._id_tag}",
            lambda *a: self._chunk_fn_paged(tmp_k, tmp_v, selected, final,
                                            *a), inputs,
            warmup=lambda: self._warmup_state(
                lambda: self._harmless_chunk(inputs, slots, None),
                self._chunk_live_state(key)),
            generators=(self.generator,))

    def _chunk_program_of(self, job: dict, first: bool, final: bool):
        return self._chunk_program_paged(job["chunk"], len(job["batch"]),
                                         job["bucket"], final,
                                         job["slots_idx"])

    def _chunk_extra(self, bucket: int, batch: List[GenerationRequest]
                     ) -> tuple:
        """The job's page table [K, ceil(bucket / ps)]: each row's prompt
        pages from its reservation."""
        n_ptable = max(1, math.ceil(bucket / self.page_size))
        ptable = np.zeros((len(batch), n_ptable), dtype=np.int32)
        for row, request in enumerate(batch):
            pages = self._reservations[request.id][:n_ptable]
            ptable[row, :len(pages)] = pages
        return (ptable,)

    def _warm_programs(self, k_variants: bool) -> None:
        """Paged: the admission at each of _warm_ks for every bucket not
        routed to chunks, and the middle and final chunk programs at K=1
        for each bucket that is (as the reference); with the prefix cache
        the reference's tail set (the smallest bucket, K=1, every bucket's
        page span) and, with k_variants (WARMUP=wide), every tail program
        the buckets can reach (_tail_shapes) at every K _admission_split
        gives; then every table width a decode can reach (dispatch uses
        pow2(widest pages + 1): 2, 4, ... up to max_seq_len's pages + 1;
        the reference warms only the first admissions' width, and each
        other one would capture mid-serving), at the full and the half
        block and for the verify, each variant."""
        for bucket in self.prefill_buckets:
            if self._chunked(bucket):
                for final in (False, True):
                    self._chunk_program_paged(self.chunk_prefill_tokens, 1,
                                              bucket, final)
                continue
            for K in self._warm_ks(k_variants):
                self._prefill_program(bucket, K)
        if self.prefix is not None and self.prefill_buckets:
            tail_b = min(self.prefill_buckets)
            for bucket in self.prefill_buckets:
                self._prefix_program(tail_b, 1, _pow2_at_least(
                    self.allocator.pages_for(bucket)))
            if k_variants:
                split = {k for n in range(1, self.n_slots + 1)
                         for k in _admission_split(n, self.n_slots)}
                for bucket, n_table in self._tail_shapes():
                    for K in sorted(split):
                        self._prefix_program(bucket, K, n_table)
        width, widest = 2, _pow2_at_least(
            self.allocator.pages_for(self.max_seq_len) + 1)
        while width <= widest:
            for row_filter in self._decode_variants():
                if self.speculative_tokens:
                    self._verify_program(width, row_filter)
                for block in self._block_sizes():
                    self._decode_program_paged(width, block, row_filter)
            width *= 2

    def _tail_shapes(self) -> List[tuple]:
        """Every (tail bucket, table width) a tail-only wave can take: a hit
        of s >= 1 whole pages on a prompt of n <= admission_limit tokens
        (one tail token always left) gives bucket(n - s * ps) and width
        pow2(pages(n)); a row that missed rides along at its own bucket
        with its own prompt's width, so a bucket's width may also be that
        of any prompt no longer than the bucket."""
        ps, buckets = self.page_size, np.asarray(self.prefill_buckets)
        n = np.arange(ps + 1, self.admission_limit + 1)
        widths = np.asarray([_pow2_at_least(int(p)) for p in -(-n // ps)],
                            dtype=np.int64)
        hit = set()
        for s in range(1, (self.admission_limit - 1) // ps + 1):
            live = n - s * ps >= 1
            bucket = buckets[np.searchsorted(buckets, n[live] - s * ps)]
            hit.update(zip(bucket.tolist(), widths[live].tolist()))
        # a hit whose tail would chunk is dropped (_tail_routes_to_chunk)
        hit = {(b, w) for b, w in hit if not self._chunked(b)}
        shapes = set(hit)
        for bucket, width in hit:
            w = 1
            while w <= _pow2_at_least(self.allocator.pages_for(bucket)):
                shapes.add((bucket, max(width, w)))
                w *= 2
        return sorted(shapes)

    def _widest_table(self) -> int:
        return _pow2_at_least(self.allocator.pages_for(self.max_seq_len) + 1)

    def _decode_fn_paged(self, table, block: int, row_filter: bool = True):
        """`block` paged decode steps (the int8 step under kv_dtype='int8');
        table [B, n_table]; row_filter: run the per-row filters. Returns the
        [B, block] sampled tokens and advances the loop state in place."""
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
        return self._decode_loop(step, block, row_filter)

    # -- dispatch -------------------------------------------------------------
    def _build_table(self) -> np.ndarray:
        """Block table for the active slots, padded to a power-of-two width
        with one extra garbage column: a position past a row's pages clamps
        to the LAST column, which is 0 (garbage) for every row."""
        with self.steps.seg("host_prep"):
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
        if self._tail_only(batch):
            # `bucket` is already the group's tail bucket (_admission_bucket)
            return self._dispatch_prefill_prefix(bucket, slots_idx, batch)
        n_ptable = max(1, math.ceil(bucket / self.page_size))
        with self.steps.seg("host_prep"):
            ptable = np.zeros((len(batch), n_ptable), dtype=np.int32)
            for row, request in enumerate(batch):
                prompt_pages = self._reservations[request.id][:n_ptable]
                ptable[row, :len(prompt_pages)] = prompt_pages
        program = self._prefill_program(bucket, len(batch), slots_idx)
        ptokens, lengths, temps = self._prep_admission(bucket, batch)
        return self._call(program, (ptokens, ptable,
                                    np.asarray(slots_idx, np.int64),
                                    lengths, temps), "engine.prefill")

    def _dispatch_prefill_prefix(self, bucket: int, slots_idx: List[int],
                                 batch: List[GenerationRequest]
                                 ) -> torch.Tensor:
        ps = self.page_size
        hits = [self._prefix_hits.get(r.id) or [] for r in batch]
        prefix_lens = [len(h) * ps for h in hits]
        # table: shared prefix pages, then the reservation's fresh pages,
        # wide enough for every row's full PROMPT page span
        n_table = _pow2_at_least(max(
            self.allocator.pages_for(len(r.resume_tokens)) for r in batch))
        with self.steps.seg("host_prep"):
            ptable = np.zeros((len(batch), n_table), dtype=np.int32)
            for row, request in enumerate(batch):
                pages = (hits[row]
                         + self._reservations[request.id])[:n_table]
                ptable[row, :len(pages)] = pages
        program = self._prefix_program(bucket, len(batch), n_table,
                                       slots_idx)
        ptokens, lengths, temps = self._prep_admission(bucket, batch,
                                                       prefix_lens)
        return self._call(program, (ptokens, ptable,
                                    np.asarray(prefix_lens, np.int32),
                                    np.asarray(slots_idx, np.int64),
                                    lengths, temps), "engine.prefill")

    def _run_decode(self, block: int) -> torch.Tensor:
        table = self._build_table()
        return self._call(self._decode_program_paged(
            table.shape[1], block, self._row_filter_now()), (table,),
            "engine.decode")
