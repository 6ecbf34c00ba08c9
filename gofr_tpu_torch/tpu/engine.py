"""Continuous-batching LLM engine: the lean host loop.

Ports from ``gofr_tpu/tpu/engine.py``: ``GenerationRequest`` (``stream``,
``result``, ``cancel``, ``hit_stop``), ``_Slot``, ``_admission_split``, and
of ``LLMEngine``: ``submit``, ``_admit`` (priority heap, requests grouped by
``_admission_bucket``, fused K-way admission), the decode dispatch of
``decode_block_size`` steps returning [B, M] tokens, ``_demux_plan`` (same
stop / budget / context semantics), ``_finish_slot``, ``start``/``stop``,
and the dense-cache device state: the kv_dtype checks (int8 needs
``decode_attn="kernel"`` on the dense engine), the rounding of
``max_seq_len`` down to a multiple of 512 under ``decode_attn="kernel"``,
``_init_device_state`` (per-layer caches allocated at the smallest
bucket), ``_grow_cache``, ``_decode_need``, ``_prefill_fn`` and
``_decode_fn``. JAX's ``_prefill_fn_q8`` and ``_decode_fn_q8`` are branches
of those two here: eager PyTorch has no donated signatures to keep apart.

What the JAX engine overlaps, this one runs one-deep and synchronously:
each prefill or decode dispatch is followed at once by its host copy and
demux. Waiting for later PRs (ROADMAP A11): the pipelined dispatch and
async D2H, QoS, the step ledger, flight recorder and utilization ledger,
fault injection, replay-after-reset and the reset-storm breaker, the
off-loop finisher, draining and disaggregated hand-off. A failed dispatch
here fails the requests it carried and the loop keeps serving.

As in JAX, ``LLMEngine`` is the dense-cache engine (``PAGED=false``): one
[B, Hkv, dh, S] cache per layer, S grown by powers of two up to
max_seq_len as contexts need it. ``tpu/paging.PagedLLMEngine`` overrides
its device state, prefill and decode. Where JAX donates the caches to its
programs, the port updates them in place, and growth copies one layer at a
time, dropping each old buffer as its copy lands, so the peak stays one
layer above the cache.
"""

from __future__ import annotations

import collections
import heapq
import itertools
import logging
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Set

import numpy as np
import torch

from ..models.llama import (DTYPES, init_kv_cache_layers,
                            init_kv_scale_layers, llama_decode_step_unrolled,
                            llama_decode_step_unrolled_q8, llama_prefill_last)
from ..ops.decode_attention import quantize_kv
from .device import resolve_device
from .executor import next_bucket
from .sampling import sample_tokens

_request_ids = itertools.count(1)
_log = logging.getLogger(__name__)


class GenerationRequest:
    def __init__(self, prompt_tokens: Sequence[int], max_new_tokens: int = 128,
                 temperature: float = 0.0, stop_tokens: Optional[Set[int]] = None,
                 priority: int = 0, min_tokens: int = 0):
        self.id = next(_request_ids)
        # admission priority: LOWER admits first; ties resolve FIFO by id
        self.priority = int(priority)
        # stop_tokens are ignored until this many tokens have been emitted
        self.min_tokens = max(0, int(min_tokens))
        self.prompt_tokens = list(prompt_tokens)
        self.max_new_tokens = max_new_tokens
        self.temperature = float(temperature)
        self.stop_tokens = stop_tokens or set()
        self.out_queue: "queue.Queue" = queue.Queue()
        self.cancelled = threading.Event()
        self.error: Optional[BaseException] = None
        self.finished_at: Optional[float] = None   # monotonic clock
        self.generated = 0

    def cancel(self) -> None:
        self.cancelled.set()

    def hit_stop(self, token: int) -> bool:
        """True when `token` ends the generation: a stop token counts only
        once min_tokens have been emitted (generated already includes this
        token at every call site)."""
        return (token in self.stop_tokens
                and self.generated >= self.min_tokens)

    def stream(self, timeout_s: Optional[float] = None) -> Iterator[int]:
        """Yield generated token ids until the engine signals completion.

        timeout_s bounds the wait for EACH queue entry; on expiry the
        request is cancelled (freeing its slot) and TimeoutError raised.
        An entry is a bare int (one token) or a list (a demuxed decode
        block), unpacked here in order."""
        while True:
            try:
                token = self.out_queue.get(timeout=timeout_s)
            except queue.Empty:
                self.cancel()
                raise TimeoutError(
                    f"generation timed out after {timeout_s}s waiting for a token")
            if token is None:
                if self.error is not None:
                    raise self.error
                return
            if type(token) is list:
                yield from token
                continue
            yield token

    def result(self, timeout_s: Optional[float] = None) -> List[int]:
        return list(self.stream(timeout_s=timeout_s))


class _Slot:
    __slots__ = ("request", "length", "remaining", "pages")

    def __init__(self):
        self.request: Optional[GenerationRequest] = None
        self.length = 0        # tokens whose KV is in the cache
        self.remaining = 0     # emissions left in the budget
        self.pages: Optional[List[int]] = None  # paged engine: owned page ids

    @property
    def active(self) -> bool:
        return self.request is not None


def _admission_split(n: int, cap: int) -> List[int]:
    """Decompose an admission wave of n into descending K-sizes from
    {cap} + powers of four <= cap (bounds the (bucket, K) shapes a prefill
    sees; a cold full-slot burst still fuses into one dispatch)."""
    candidates = {cap}
    k = 1
    while k <= cap:
        candidates.add(k)
        k *= 4
    out: List[int] = []
    for k in sorted(candidates, reverse=True):
        while n >= k:
            out.append(k)
            n -= k
    return out


def check_kernel_config(cfg) -> None:
    """Raise unless cfg is one the CUDA kernels take: bfloat16, head_dim 64
    or 128, n_heads / n_kv_heads in (1, 2, 4, 8)."""
    if (cfg.dtype != "bfloat16" or cfg.head_dim not in (64, 128)
            or cfg.q_per_kv not in (1, 2, 4, 8)):
        raise ValueError(
            f"the CUDA kernels take bfloat16, head_dim 64 or 128 and "
            f"n_heads / n_kv_heads in (1, 2, 4, 8); this config has "
            f"{cfg.dtype}, {cfg.head_dim}, {cfg.q_per_kv}")


class LLMEngine:
    """Continuous-batching engine over `n_slots` lock-step sequences and a
    dense per-slot KV cache. The host loop (admission, decode blocks,
    demux) is shared with subclasses, which override
    ``_init_device_state``, ``_dispatch_prefill`` (returns the [K] first
    tokens on the device) and ``_dispatch_decode`` (returns the [B, block]
    tokens on the device)."""

    STOP_JOIN_S = 30.0
    # the paged subclass reads through its paged kernel whatever
    # cfg.decode_attn says, so the dense-only rules below skip it
    _paged = False

    def __init__(self, params, cfg, n_slots: int = 8,
                 max_seq_len: Optional[int] = None,
                 prefill_buckets: Sequence[int] = (16, 32, 64, 128, 256, 512,
                                                   1024),
                 top_k: int = 0, decode_block_size: int = 16, seed: int = 0,
                 device=None, logger: Optional[logging.Logger] = None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.logger = logger or _log
        self.n_slots = n_slots
        self.max_seq_len = min(max_seq_len or cfg.max_seq_len,
                               cfg.max_seq_len)
        self.prefill_buckets = tuple(b for b in prefill_buckets
                                     if b <= self.max_seq_len)
        # the Pallas decode kernel reads the cache in min(512, S) blocks
        # and the reference rounds the cap down at boot so a grow clamped
        # to max_seq_len stays divisible; the CUDA kernel takes any S, but
        # the cap is the admission limit users see, so it is kept
        if (cfg.decode_attn == "kernel" and not self._paged
                and self.max_seq_len > 512 and self.max_seq_len % 512):
            rounded = (self.max_seq_len // 512) * 512
            self.logger.warning(
                "max_seq_len %d rounded down to %d: decode_attn='kernel' "
                "keeps the reference's 512-aligned cap", self.max_seq_len,
                rounded)
            self.max_seq_len = rounded
            self.prefill_buckets = tuple(b for b in self.prefill_buckets
                                         if b <= rounded)
            if not self.prefill_buckets:
                raise ValueError(
                    f"decode_attn='kernel' rounded max_seq_len to {rounded} "
                    f"and no prefill bucket fits under it — requests could "
                    f"be accepted but never admitted; configure a bucket "
                    f"<= {rounded} or a 512-aligned max_seq_len")
        # int8 KV: quantize on write, dequantize inside the kernels' reads
        if cfg.kv_dtype not in (None, "int8", cfg.dtype):
            raise ValueError(f"kv_dtype={cfg.kv_dtype!r} not supported; "
                             f"use None or 'int8'")
        self._q8 = cfg.kv_dtype == "int8"
        if self._q8 and cfg.decode_attn != "kernel" and not self._paged:
            raise ValueError("kv_dtype='int8' requires decode_attn="
                             "'kernel' (no efficient XLA dequant read)")
        self.top_k = top_k
        self.decode_block_size = max(1, decode_block_size)
        self._seed = seed
        self.slots = [_Slot() for _ in range(n_slots)]
        # arrivals (thread-safe) and the loop-owned admission heap of
        # (priority, id, request): requests parked on a subclass resource
        # (free pages) wait here; same-priority requests stay FIFO
        self._pending: "queue.PriorityQueue" = queue.PriorityQueue()
        self._admission_heap: List[tuple] = []
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # dispatch counts (loop-thread writes): what a run can show about
        # the kernels it went through. Full-window prefill waves (flash on
        # the card) and the paged engine's tail-only prefix-hit waves are
        # counted apart; (K, bucket) -> waves of that shape dispatched
        self.prefill_dispatches = 0
        self.prefill_shapes: collections.Counter = collections.Counter()
        self.prefix_dispatches = 0
        self.prefix_shapes: collections.Counter = collections.Counter()
        self.decode_steps = 0
        self._init_device_state()

    # -- device state ---------------------------------------------------------
    def _init_device_state(self) -> None:
        """Per-layer [B, Hkv, dh, S] caches (int8 plus [B, Hkv, S] f32
        scales under kv_dtype='int8'), allocated at the smallest bucket and
        grown on demand: the plain read's cost follows the allocated S."""
        if self.device.type == "cuda" and (self.cfg.decode_attn == "kernel"
                                           or self.cfg.attn_impl == "flash"):
            check_kernel_config(self.cfg)
        B = self.n_slots
        self._cache_len = min(self.max_seq_len,
                              max(16, min(self.prefill_buckets or (16,))))
        self.k_cache, self.v_cache = init_kv_cache_layers(
            self.cfg, B, self._cache_len, dtype="int8" if self._q8 else None,
            device=self.device)
        self.k_scale = self.v_scale = None
        if self._q8:
            self.k_scale, self.v_scale = init_kv_scale_layers(
                self.cfg, B, self._cache_len, device=self.device)
        self._init_loop_state()

    def _init_loop_state(self) -> None:
        """The loop state, persistent on the device and updated in place
        (JAX donates it to every program)."""
        B, dev = self.n_slots, self.device
        self._tokens = torch.zeros((B,), dtype=torch.long, device=dev)
        self._positions = torch.zeros((B,), dtype=torch.long, device=dev)
        self._temps = torch.zeros((B,), dtype=torch.float32, device=dev)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(self._seed)

    def _grow_cache(self, needed: int) -> None:
        """Pad every layer's cache (and scales) along S to the next power
        of two covering `needed`, capped at max_seq_len. One layer at a
        time, each old buffer dropped as its copy lands; a layer already at
        the new length is skipped, so a growth that failed part way is
        finished by the next call."""
        new_len = min(self.max_seq_len,
                      1 << (max(needed, 16) - 1).bit_length())
        if new_len <= self._cache_len:
            return
        buffers = [self.k_cache, self.v_cache]
        if self._q8:
            buffers += [self.k_scale, self.v_scale]
        for layers in buffers:
            for l, old in enumerate(layers):
                if old.shape[-1] >= new_len:
                    continue
                new = old.new_zeros((*old.shape[:-1], new_len))
                new[..., :old.shape[-1]] = old
                layers[l] = new
                del old
        self._cache_len = new_len
        self.logger.debug("grew KV cache to %d", new_len)

    def _decode_need(self) -> int:
        """Cache length every active row needs after this dispatch: one
        block past the longest live context (one-deep dispatch: nothing
        else is in flight)."""
        longest = max((slot.length for slot in self.slots if slot.active),
                      default=0)
        return longest + self.decode_block_size + 1

    # -- programs -------------------------------------------------------------
    def _prep_admission(self, bucket: int, batch: List[GenerationRequest],
                        starts: Optional[Sequence[int]] = None):
        """([K, bucket] prompt tokens, [K] lengths, [K] temperatures) on
        the device for one fused admission. starts: per row, the first
        prompt position the window holds (a prefix hit's tail; default 0);
        lengths are the full prompts'."""
        ptokens = np.zeros((len(batch), bucket), dtype=np.int64)
        for row, request in enumerate(batch):
            window = request.prompt_tokens[starts[row] if starts else 0:]
            ptokens[row, :len(window)] = window
        lengths = np.asarray([len(r.prompt_tokens) for r in batch],
                             dtype=np.int32)
        temps = np.asarray([r.temperature for r in batch], dtype=np.float32)
        dev = self.device
        return (torch.from_numpy(ptokens).to(dev),
                torch.from_numpy(lengths).to(dev),
                torch.from_numpy(temps).to(dev))

    def _prefill_window(self, ptokens, lengths):
        """Forward a [K, bucket] admission window into fresh [L, K, Hkv, dh,
        bucket] temps of the model dtype (flash or plain attention over the
        window). Returns (last-position logits [K, V], tmp_k, tmp_v)."""
        cfg = self.cfg
        K, bucket = ptokens.shape
        tmp_k = torch.zeros((cfg.n_layers, K, cfg.n_kv_heads, cfg.head_dim,
                             bucket), dtype=DTYPES[cfg.dtype],
                            device=self.device)
        tmp_v = torch.zeros_like(tmp_k)
        pos_grid = torch.arange(bucket, device=self.device).expand(K, bucket)
        return llama_prefill_last(self.params, cfg, ptokens, pos_grid,
                                  lengths, tmp_k, tmp_v)

    def _splice_loop_state(self, last, slots, lengths, new_temps):
        """Sample the admitted rows' first tokens and splice them, their
        positions and temperatures into the loop state. Returns [K]."""
        first = sample_tokens(last, self.generator, new_temps,
                              top_k=self.top_k)
        self._tokens[slots] = first
        self._positions[slots] = lengths.long()
        self._temps[slots] = new_temps
        return first

    def _prefill_fn(self, ptokens, slots, lengths, new_temps):
        """Fused K-way admission into the dense caches: the window forward
        runs at full precision into temps, which splice into the slots'
        rows at [0, bucket) layer by layer — quantized per token and head
        at the splice under int8 (with their scales). Returns [K] first
        tokens."""
        bucket = ptokens.shape[1]
        last, tmp_k, tmp_v = self._prefill_window(ptokens, lengths)
        if self._q8:
            tmp_k, ks = quantize_kv(tmp_k, axis=-2)   # scales [L, K, Hkv, b]
            tmp_v, vs = quantize_kv(tmp_v, axis=-2)
        for l in range(self.cfg.n_layers):
            self.k_cache[l][slots, :, :, :bucket] = tmp_k[l]
            self.v_cache[l][slots, :, :, :bucket] = tmp_v[l]
            if self._q8:
                self.k_scale[l][slots, :, :bucket] = ks[l]
                self.v_scale[l][slots, :, :bucket] = vs[l]
        return self._splice_loop_state(last, slots, lengths, new_temps)

    def _decode_loop(self, step, block: int) -> torch.Tensor:
        """`block` lock-step decode steps: step(tokens, positions) -> [B, V]
        logits. Returns the [B, block] sampled tokens and advances the
        loop state in place."""
        tok, pos = self._tokens, self._positions
        out = []
        for _ in range(block):
            tok = sample_tokens(step(tok, pos), self.generator, self._temps,
                                top_k=self.top_k)
            pos = pos + 1
            out.append(tok)
        self._tokens.copy_(tok)
        self._positions.copy_(pos)
        return torch.stack(out, dim=1)

    def _decode_fn(self, block: int) -> torch.Tensor:
        """`block` dense decode steps (the int8 step under kv_dtype='int8')
        over the caches at their grown length."""
        params, cfg = self.params, self.cfg
        if self._q8:
            def step(tok, pos):
                return llama_decode_step_unrolled_q8(
                    params, cfg, tok, pos, self.k_cache, self.v_cache,
                    self.k_scale, self.v_scale)[0]
        else:
            def step(tok, pos):
                return llama_decode_step_unrolled(
                    params, cfg, tok, pos, self.k_cache, self.v_cache)[0]
        return self._decode_loop(step, block)

    # -- dispatch -------------------------------------------------------------
    def _dispatch_prefill(self, bucket: int, slots_idx: List[int],
                          batch: List[GenerationRequest]) -> torch.Tensor:
        if bucket + 1 > self._cache_len:   # prompts must land inside the cache
            self._grow_cache(bucket + 1)
        ptokens, lengths, temps = self._prep_admission(bucket, batch)
        slots = torch.as_tensor(slots_idx, dtype=torch.long,
                                device=self.device)
        return self._prefill_fn(ptokens, slots, lengths, temps)

    def _dispatch_decode(self, block: int) -> torch.Tensor:
        need = self._decode_need()
        if need > self._cache_len:
            self._grow_cache(need)
        return self._decode_fn(block)

    def _admission_ready(self, request: GenerationRequest) -> bool:
        return True

    def _admission_bucket(self, request: GenerationRequest) -> int:
        """The prefill bucket a request admits under: its prompt's. The
        paged engine overrides it to the un-cached tail's bucket on a
        prefix hit."""
        return next_bucket(len(request.prompt_tokens), self.prefill_buckets)

    def _tail_only(self, batch: List[GenerationRequest]) -> bool:
        """True when the wave prefills only un-cached tails (the paged
        engine's prefix hits)."""
        return False

    def _abort_admission(self, request: GenerationRequest) -> None:
        """Release whatever _admission_ready reserved for `request`."""

    # -- public API -----------------------------------------------------------
    @property
    def admission_limit(self) -> int:
        """Longest admissible prompt: the largest prefill bucket, bounded so
        the first decode step's KV write (at position len(prompt)) stays
        inside the cache's logical seq dim."""
        bucket_limit = (self.prefill_buckets[-1] if self.prefill_buckets
                        else self.max_seq_len)
        return min(bucket_limit, self.max_seq_len - 1)

    def queue_depth(self) -> int:
        return self._pending.qsize() + len(self._admission_heap)

    def health_check(self) -> Dict[str, object]:
        alive = self._thread is not None and self._thread.is_alive()
        return {"status": "UP" if alive else "DOWN",
                "active_slots": sum(1 for s in self.slots if s.active),
                "queue_depth": self.queue_depth()}

    def submit(self, prompt_tokens: Sequence[int], max_new_tokens: int = 128,
               temperature: float = 0.0,
               stop_tokens: Optional[Set[int]] = None, priority: int = 0,
               min_tokens: int = 0) -> GenerationRequest:
        """priority: LOWER admits first when slots are contended (ties stay
        FIFO). min_tokens: stop tokens are ignored until this many tokens
        have been emitted."""
        if self._stop.is_set():
            raise RuntimeError("engine is stopped")
        if not prompt_tokens:
            raise ValueError("prompt_tokens must be non-empty")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        limit = self.admission_limit
        if len(prompt_tokens) > limit:
            raise ValueError(f"prompt of {len(prompt_tokens)} tokens exceeds the "
                             f"admission limit ({limit})")
        request = GenerationRequest(prompt_tokens, max_new_tokens, temperature,
                                    stop_tokens, priority=priority,
                                    min_tokens=min_tokens)
        self._pending.put((request.priority, request.id, request))
        if self._stop.is_set():
            # stop() may have drained _pending between the check above and
            # the put; drain again so this request cannot strand its client
            self._drain_pending(RuntimeError("engine stopped"))
            raise RuntimeError("engine is stopped")
        self._wake.set()
        return request

    def generate(self, prompt_tokens: Sequence[int], **kw) -> List[int]:
        return self.submit(prompt_tokens, **kw).result()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="llm-engine",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=self.STOP_JOIN_S)
            if thread.is_alive():
                # the loop is stuck inside a device call and still owns the
                # slots: leave their teardown to it (it exits on the flag)
                self.logger.error("engine loop did not exit within %.0fs",
                                  self.STOP_JOIN_S)
                return
            self._thread = None
        self._drain_pending(RuntimeError("engine stopped"))

    # -- loop -----------------------------------------------------------------
    def _loop(self) -> None:
        with torch.no_grad():
            while not self._stop.is_set():
                try:
                    self._admit()
                    busy = any(slot.active for slot in self.slots)
                    if busy:
                        self._decode()
                except Exception:  # noqa: BLE001 - the loop must keep serving
                    self.logger.exception("engine step failed")
                    busy = False
                if not busy:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
            stop_exc = RuntimeError("engine stopped")
            for slot in self.slots:
                if slot.active:
                    slot.request.error = stop_exc
                    self._finish_slot(slot)

    def _is_cancelled(self, request: GenerationRequest) -> bool:
        return request.cancelled.is_set()

    def _admit(self) -> None:
        """Fuse pending requests into batched prefill dispatches, one per
        (bucket, K) group, while free slots last."""
        free = [i for i, slot in enumerate(self.slots) if not slot.active]
        if not free:
            return
        while True:
            try:
                heapq.heappush(self._admission_heap, self._pending.get_nowait())
            except queue.Empty:
                break
        taken: List[GenerationRequest] = []
        while self._admission_heap and len(taken) < len(free):
            entry = heapq.heappop(self._admission_heap)
            request = entry[2]
            if self._is_cancelled(request):
                self._abort_admission(request)
                self._fail_request(request)
                continue
            if not self._admission_ready(request):
                # parked on its resource: no same-priority request may
                # leapfrog it, so the round stops here
                heapq.heappush(self._admission_heap, entry)
                break
            taken.append(request)
        # grouped by admission bucket: a prefix hit admits at its tail's
        by_bucket: Dict[int, List[GenerationRequest]] = {}
        for request in taken:
            by_bucket.setdefault(self._admission_bucket(request),
                                 []).append(request)
        free_iter = iter(free)
        for bucket, group in by_bucket.items():
            offset = 0
            for K in _admission_split(len(group), self.n_slots):
                batch = group[offset:offset + K]
                offset += K
                self._prefill(bucket, [next(free_iter) for _ in batch], batch)

    def _prefill(self, bucket: int, slots_idx: List[int],
                 batch: List[GenerationRequest]) -> None:
        """One fused prefill dispatch, synced at once: bind the slots and
        their pages, emit the first tokens, finish the rows that are already
        done. A failure fails this wave only."""
        tail_only = self._tail_only(batch)
        try:
            first = self._dispatch_prefill(bucket, slots_idx, batch).tolist()
        except Exception as exc:  # noqa: BLE001 - fail the wave, keep serving
            self.logger.error("prefill wave of %d failed: %s", len(batch), exc)
            for request in batch:
                self._abort_admission(request)
                self._fail_request(request, exc)
            return
        if tail_only:
            self.prefix_dispatches += 1
            self.prefix_shapes[(len(batch), bucket)] += 1
        else:
            self.prefill_dispatches += 1
            self.prefill_shapes[(len(batch), bucket)] += 1
        self._assign_pages(slots_idx, batch)
        for row, request in enumerate(batch):
            slot = self.slots[slots_idx[row]]
            slot.request = request
            slot.length = len(request.prompt_tokens)
            slot.remaining = request.max_new_tokens - 1
            token = int(first[row])
            self._emit_block(request, [token])
            if (request.hit_stop(token) or slot.remaining <= 0
                    or self._is_cancelled(request)):
                self._finish_slot(slot)

    def _assign_pages(self, slots_idx: List[int],
                      batch: List[GenerationRequest]) -> None:
        """Move each admitted request's admission reservation onto its
        slot."""

    def _decode_block_now(self) -> int:
        """Full blocks for decode throughput, half blocks while requests
        wait for admission, so their TTFT is not gated behind a full block."""
        if self._admission_heap or self._pending.qsize():
            return max(1, self.decode_block_size // 2)
        return self.decode_block_size

    def _decode(self) -> None:
        block = self._decode_block_now()
        live = [(i, slot.request) for i, slot in enumerate(self.slots)
                if slot.active]
        try:
            tokens_host = self._dispatch_decode(block).cpu().numpy()
        except Exception as exc:  # noqa: BLE001 - fail the block, keep serving
            self.logger.error("decode block failed: %s", exc)
            for i, request in live:
                request.error = exc
                self._finish_slot(self.slots[i])
            return
        self.decode_steps += block
        counts, finishes = self._demux_plan(
            tokens_host, [i for i, _ in live], [r for _, r in live],
            [block] * len(live))
        for j, (slot_idx, request) in enumerate(live):
            slot = self.slots[slot_idx]
            n = int(counts[j])
            slot.length += n
            slot.remaining -= n
            self._emit_block(request, tokens_host[slot_idx, :n].tolist())
            if finishes[j]:
                self._finish_slot(slot)

    def _emit_block(self, request: GenerationRequest,
                    tokens: List[int]) -> None:
        """Deliver one request's tokens for this sync in ONE queue entry."""
        if not tokens:
            return
        request.generated += len(tokens)
        request.out_queue.put(tokens[0] if len(tokens) == 1 else tokens)

    def _demux_plan(self, tokens_host, rows: List[int],
                    requests: List[GenerationRequest], limits):
        """Per-row emit counts + finish flags for one synced token matrix,
        in one numpy pass:

          * every row with device tokens emits at least min(limit, 1);
          * a stop token counts only once min_tokens emissions exist
            (GenerationRequest.hit_stop), and the stop token ITSELF is
            emitted — count = first eligible hit + 1;
          * budget (slot.remaining) and context (max_seq_len - 1) caps
            emit the capping token, then finish;
          * a cancelled row emits exactly one token, then finishes.

        rows/requests/limits are parallel per live row; tokens_host is the
        full [B, W] synced matrix. Returns (counts [R] int64, finish [R]
        bool)."""
        n = len(rows)
        if n == 0:
            return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool))
        toks = tokens_host[np.asarray(rows, dtype=np.int64)]
        W = toks.shape[1]
        lim = np.minimum(np.asarray(limits, dtype=np.int64), W)
        budget = np.array([self.slots[i].remaining for i in rows],
                          dtype=np.int64)
        ctx = np.array([self.max_seq_len - 1 - self.slots[i].length
                        for i in rows], dtype=np.int64)
        gen0 = np.array([r.generated for r in requests], dtype=np.int64)
        min_t = np.array([r.min_tokens for r in requests], dtype=np.int64)
        cancelled = np.array([self._is_cancelled(r) for r in requests],
                             dtype=bool)

        # stop-token scan, one isin per DISTINCT stop set, gated by
        # min_tokens eligibility and the per-row limit; stop_cap is the
        # 1-based emit count that includes the stop token, W + 1 = none
        pos1 = np.arange(1, W + 1, dtype=np.int64)
        stop_cap = np.full(n, W + 1, dtype=np.int64)
        groups: Dict[frozenset, List[int]] = {}
        for j, r in enumerate(requests):
            if r.stop_tokens:
                groups.setdefault(frozenset(r.stop_tokens), []).append(j)
        for stops, idxs in groups.items():
            hit = np.isin(toks[idxs], np.array(sorted(stops), dtype=np.int64))
            hit &= (gen0[idxs, None] + pos1[None, :]) >= min_t[idxs, None]
            hit &= pos1[None, :] <= lim[idxs, None]
            any_hit = hit.any(axis=1)
            stop_cap[idxs] = np.where(any_hit, hit.argmax(axis=1) + 1, W + 1)

        counts = np.minimum(np.minimum(lim, stop_cap), np.minimum(budget, ctx))
        counts = np.where(cancelled, np.minimum(counts, 1), counts)
        counts = np.maximum(counts, np.minimum(lim, 1))
        finish = ((cancelled & (counts >= 1))
                  | (counts == stop_cap)      # stop_cap <= lim <= W when hit
                  | (counts >= budget)        # remaining exhausted
                  | (counts >= ctx))          # length hits max_seq_len - 1
        return counts, finish

    def _finish_slot(self, slot: _Slot) -> None:
        request = slot.request
        slot.request = None
        slot.length = 0
        slot.remaining = 0
        if request is not None:
            request.finished_at = time.monotonic()
            request.out_queue.put(None)

    def _fail_request(self, request: GenerationRequest,
                      exc: Optional[BaseException] = None) -> None:
        """Terminate a request that never reached a slot."""
        if exc is not None:
            request.error = exc
        if request.finished_at is None:
            request.finished_at = time.monotonic()
        request.out_queue.put(None)

    def _drain_pending(self, exc: BaseException) -> None:
        entries = list(self._admission_heap)
        self._admission_heap.clear()
        while True:
            try:
                entries.append(self._pending.get_nowait())
            except queue.Empty:
                break
        for _, _, request in entries:
            self._abort_admission(request)
            self._fail_request(request, exc)
