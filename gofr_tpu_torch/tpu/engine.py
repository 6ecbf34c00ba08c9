"""Continuous-batching LLM engine: the pipelined host loop.

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

The dispatch layer is the reference's: up to ``pipeline_depth`` (4)
dispatches in flight (the ``_inflight`` deque), the loop order of its
``_loop`` (admit; dispatch decode blocks while fewer than pipeline_depth
are in flight; sync the oldest; park only when nothing is in flight),
``_bind_slots`` (its slot half: a prefill's rows are bound at dispatch),
``_start_d2h`` (``async_d2h``, default True: the tokens' device-to-host
copy starts at enqueue time into pinned memory, behind a CUDA event that
``_sync_oldest`` waits on; with async_d2h=False the copy is made at sync),
``_sync_oldest`` with its prefill and decode branches and the ``slot.request
is not request`` guards for rows freed or cancelled between dispatch and
sync, the in-flight-aware ``_decode_need``, the shutdown that drains
``_inflight`` before it fails the rest, and ``warmup`` (with its
``k_variants``). Every dispatch is one program of ``tpu/executor.Executor``,
named as the reference names it: each decode block
``llama-decode[-q8]-x{block}-S{len}`` and each fused admission wave
``_prefill_program(bucket, K)``, ``llama-prefill[-q8]-{bucket}x{K}-S{len}``
(``-flash`` under attn_impl="flash"); on the card a CUDA graph replayed in
one launch, on the CPU the eager function. A program's inputs are static
buffers, typed views into one device block per program, filled before each
call by one host-to-device copy from a pinned staging ring
(``_static_inputs``, ``_upload``).

Crash-only serving (ROADMAP A11e) is the reference's: ``CacheLostError``
and ``DeviceLostError``; a launch or sync that raises (``_call``, the dense
decode call, ``_grow_cache``, ``_fetch_host``) raises ``CacheLostError``
out of the step, and the loop's catch (the stop path's too) goes to
``_reset_device_state``, which counts the reset, feeds the reset-storm
breaker (tpu/faults.py), evacuates every active slot and chunk job WITHOUT
terminating them and ``_replay_or_fail`` requeues each survivor at prompt +
emitted (``GenerationRequest.resume_tokens``, priority ``min(priority,
-1)``), bounded by ``retry_budget``, with poison quarantine (the sole
request in flight across two consecutive resets fails). Admission buckets
and prefills by ``resume_tokens``, so a replay rebuilds its whole context
in one admission wave. A host-side failure before a wave's launch (its
preparation, a failed capture) fails that wave only, as in the reference.
Where the reference rebuilds its donated device state, the port restores
it IN PLACE (``_restore_device_state``): a captured CUDA graph reads and
writes fixed addresses, so the caches, the loop state, the programs'
static inputs and the generator are kept, the loop state is zeroed and
the same generator re-seeded (a generator registered with a graph reads
its seed and offset at each replay), the host structures are rebuilt, and
every captured program survives; the dense engine keeps its grown cache
length and its graphs (the reference shrinks it to the smallest bucket).
A rebuild that raises (a sticky CUDA error poisons the context) counts as
one more reset and never leaves the loop. The breaker's half-open probe
(``_breaker_probe``, the reference's ``float(jnp.asarray(1.0) + 1.0)``) is
one tiny launch and a ``torch.cuda.synchronize()``: on a dead context it
fails, the breaker stays open, health reads DOWN and ``submit`` sheds with
``DeviceLostError`` (503), which is the crash-only answer: the process is
restarted. The fault-injection plane (``self.faults``, None by default)
hits the reference's sites ``engine.prefill``, ``.decode``, ``.verify``,
``.chunk``, ``.sync``, ``.cache_grow`` and ``.probe``; an armed raise
takes the same path as a real failure. ``resets_total``,
``replays_total``, ``replayed_tokens_total`` and ``quarantined_total``
count it, with the recorder events ``device_reset``, ``breaker_open``,
``breaker_closed``, ``breaker_probe_failed``, ``replayed`` and
``quarantined``; the incident plane (``self.incidents``) is triggered on
``breaker_open`` and ``quarantine`` and fed straggler streaks, and the
capacity meter (``self.meter``) is charged each synced batch at
``_finish_step``. Terminal teardown (span end, recorder record, meter,
the client's final None) runs on the bounded ``llm-finisher`` thread
(``_Finisher``, ``finisher_queue``; 0 or a full queue: inline), in the
reference's order: tokens, then None, and ``result()`` returning means the
recorder holds the record; ``stop`` drains it.

The observability planes (ROADMAP A11c) are the reference's, at its sites:

  * the step ledger (``self.steps``, tpu/stepledger.py): ``_step`` opens a
    record and closes it (``_finish_step``, which records a flagged
    straggler as a ``step_straggler`` engine event) before the loop's idle
    park, or aborts it when the step raises; the segments are
    ``admission`` (``_admit``), ``page_alloc`` (the paged reservation),
    ``host_prep`` (``_prep_admission``, page tables, drafts),
    ``dispatch`` (``_call`` and the dense decode call: the upload and the
    launch or replay), ``cache_grow``, ``device_sync`` (``_fetch_host``: the
    wait on the D2H copy's CUDA event), ``demux`` (``_demux_plan``) and
    ``emit`` (the rest of ``_sync_oldest``), with ``note_dispatch`` /
    ``note_sync`` at each dispatch and sync, and ``compile`` re-attributed
    from the executor's ``on_compile`` (``_note_compile``; captures on other
    threads, warm-up's and the scoring passes', are ignored by the ledger's
    thread guard);
  * the utilization ledger (``self.util``, tpu/utilization.py), built here
    with the served tree's ``params_nbytes``: ``record_prefill`` /
    ``record_decode`` at each sync with the dispatch stamp its in-flight
    entry carries, ``note_host`` with the loop's host time per step;
  * the flight recorder (``self.recorder``, None until
    ``App.enable_flight_recorder``): ``record_enqueued`` at submit,
    ``record_admitted`` at binding (a chunk job's at its first chunk),
    ``record_event("prefill_chunk")``, ``record_first_token``,
    ``record_decode_block`` per row per sync, ``record_finished`` at
    ``_finish_slot`` / ``_fail_request`` and the engine events
    ``cache_grow``, ``step_straggler`` and ``stall_shed``;
  * the stall watchdog: the loop stamps ``_last_step_at`` every iteration;
    ``stall_seconds`` past ``STALL_REJECT_S`` (150 s) makes ``submit``
    raise ``EngineStalledError`` (503) and ``health_check`` answer
    DEGRADED with the stall age;
  * ``lifecycle`` (tpu/migrate.py): ``serving`` from construction,
    ``draining`` from ``drain()``;
  * ``app_tpu_tokens_per_second`` over a 5 s window of synced tokens.

The QoS plane (ROADMAP A11e, tpu/qos.py) is the reference's: ``submit``'s
``qos_class`` (``normalize_class``: an unknown class is refused even with
no controller) and ``tenant`` ride on ``GenerationRequest``; with a
controller (``self.qos``, None until ``App.enable_qos``) submit takes the
ladder's door (``check_submit``) and bands the priority; the loop's
``_qos_actuate`` (segment ``qos``) preempts batch rows at preempt_batch
(``_preempt_slots``, ``_release_slot_for_preempt``: the replay contract,
counted in ``preemptions`` and ``preemptions_total`` apart from the
retry_budget); the admission gate takes ``admission_decision`` (expire:
``QoSDeadlineError`` and a ``qos_expired`` event; park: the entry goes back
and the round ends) and ``note_admitted``; both finish sites
``note_finished``. One guard is the port's own: a preempted request stays
queued while a dispatch in flight still holds it (``_in_flight``), so a
block that decoded its old row cannot be demuxed to it once it is bound to
the same slot again.

Disaggregated prefill/decode and migration (ROADMAP A11f, tpu/disagg.py,
tpu/migrate.py) are the reference's: ``GenerationRequest.disagg_handoff``
and ``handoff_blobs``; ``disagg_role`` ("", "prefill" or "decode", paged
only), the prefill role's ``_handoff_sink`` (called at the prefill's sync,
``_handoff_slot``) and ``_handoff_fail`` (offered every failure first by
``_fail_request``); ``submit_handoff`` (admission at prompt + emitted,
priority ``min(priority, -1)``, the client's queue and cancel event
shared), whose blob-carrying requests ``_admit`` splits off to
``_admit_handoff`` and whose failed landings ``_handoff_fallback`` parks
again for a recompute; ``request_migration`` / ``migration_pending`` and
the loop's export round ``_migrate_active_slots`` at a quiesced boundary
(``_export_slot_kv``: blob-less on the dense engine). Two gates sit in
front of the decode dispatch (``_decode_wanted``): none while a migration
round waits for the pipeline to drain, and none on a prefill pool for a
slot whose prefill is in flight. Hand-off counters: ``handoffs_total``,
``handoff_fallbacks_total``, ``migrations_total``. Host copies of pages
go through ``_pull_host`` and ``_h2d``, on the engine's stream, the
pinned staging of a landing held until its event passes
(``_keep_staging``).

Speculative decoding and chunked prefill (ROADMAP A10) are the reference's:
``spec_accept_epilogue`` (shared with the paged engine), the SPEC_* class
attributes and the adaptive state (``_spec_accept_ema``, ``_spec_cooloff``,
``_spec_no_draft_streak``), ``_propose_draft`` (the native scan bound at
boot, native/), ``_verify_fn`` / ``_verify_program`` / ``_verify_call`` /
``_dispatch_verify`` (``llama-verify-x{d}-S{len}``; a zero-draft round falls
back to a block decode), the loop's branch (one verify at a time while not
cooling off, else pipelined blocks counting the cooloff down) and the
verify sync (the EMA over greedy-eligible rows); ``_chunk_fn`` (with
``_chunk_fn_q8`` as its int8 branch; the first chunk parks the reserved
rows' positions at the cache's last column), ``_chunk_program``
(``llama-chunk[-q8]-{chunk}x{K}[-first][-final]-S{len}``),
``_start_chunk_job``, ``_advance_chunk_job`` (one chunk per loop
iteration), ``_dispatch_chunk``, ``_finish_chunk_job`` and
``_abort_chunk_job``, with a slot's ``chunking`` reservation and
``history``. Two differences come from the graphs: a verify has the decode
blocks' two variants under sampling_controls (``-sc`` and ``-sc-nosort``,
picked per dispatch), and a chunk job's carried state (the [K, V] logits
of each row's last prompt position; the paged engine's temps too) lives in
its programs' buffers, which a graph reads at fixed addresses: a second
job of the same shape swaps the first's state out into tensors it owns
and back in when it runs again (``_swap_chunk_state``, counted in
``chunk_swaps`` and ``chunk_swap_bytes``).

``sampling_controls`` (the reference's, off by default) widens the per-row
sampling state from [B] temperatures to [B, 3] (temperature, top_p, top_k):
``_temps_init``, ``_prep_admission`` packing [K, 3] rows, ``submit``'s
``top_p``/``top_k`` and their checks, the ``-sc`` tag on every program name
(``_id_tag``), and the clear of a freed slot's control row. Where the
reference skips the [B, V] sort of the per-row filters by a ``jax.lax.cond``
on the device, a CUDA graph cannot branch: each decode block of a
``sampling_controls`` engine has two programs, ``...-sc`` with the filters
and ``...-sc-nosort`` without, and the host picks one per dispatch from
``_filter_rows``, the slots whose control row on the device may be set. A
slot joins it when the admission that writes its controls is dispatched
and leaves it when the clear of its row is enqueued at ``_finish_slot``,
both on the engine's stream, so at each dispatch the set is exactly the
rows the block will read with a control. Admission waves always run the
filters (the identity on rows without controls). The post-hoc scoring
passes (``score``, ``embed``, ``warmup_scoring``) are tpu/score.py's.

Tensor-parallel serving and the admission plane (ROADMAP A14a) are the
reference's ``LLMEngine(mesh=, admission_plane=)``. Under a mesh the engine
checks that tp divides n_heads and n_kv_heads, keeps this rank's block of
the params (parallel/sharding.serving_param_specs, int8 scales included)
and a rank-local config (models/llama.ShardConfig: its heads, and the tp
axis its programs reduce over), so the dense caches, the pools and the
int8 scales hold this rank's KV heads and the loop state is whole on every
rank, the reference's ``_place_state``. Where JAX has one controller for
the mesh, PyTorch runs one process per card: each rank runs this loop, and
``_agree_on_plan`` takes the minimum (n_slots, max_seq_len) over the ranks
(each plans its own card's bytes; differing plans would dispatch different
programs and deadlock). The plane (tpu/admission.py) is on every TP path:
rank 0 publishes each iteration's wave and the followers replay it
(``_exchange_wave``), ``submit`` on a follower raises, ``_is_cancelled``
reads the synced set, ``stop`` publishes the stop sentinel, and QoS, the
breaker, the drain's early return, the stall shed, replay after a reset,
migration, the disaggregated roles and the post-hoc scoring passes are
off or refused under it, at the reference's sites.

Observability (ROADMAP A18a) is the reference's: ``LLMEngine(metrics=,
tracer=, logger=)``, ``self._obs = MetricsHook(metrics)`` (tpu/obs.py; the
names tpu/device.register_metrics registers), and ``submit(span=,
traceparent=)``, which opens the request's ``tpu.generate`` span (with
``tpu.prompt_tokens``) under the caller's span or traceparent; admission
stamps ``batch.id``, ``tpu.slot`` and ``tpu.prefill_bucket`` on it, and its
finish ``tpu.tokens``. A tracer also gets a ``tpu.prefill``/``tpu.decode``/
``tpu.verify`` span per dispatch, ended at its sync. The recording sites
are the reference's: requests and queue depth at submit; queue wait at
admission (a chunk job's at its first chunk), queue depth and active slots
after each admission round; drafts at a verify's dispatch; TTFT at a
request's first token; tokens, TPOT (``hist_n``, one call per sync),
batch size and execute seconds (dispatch to sync) at each decode sync; and
accepted drafts, tokens, TPOT, batch size and execute seconds at each
verify sync. Every one is host work at a sync the loop already makes:
nothing is recorded inside a captured graph and no sync is added.

Everything runs on ONE stream, the engine's, in dispatch order: prefills,
decode replays, cache growth, the host copies. That order is what makes
speculative decode of freed rows safe, as in the reference: a row freed at
sync keeps "decoding" junk inside blocks already dispatched; its tokens are
discarded at their sync (the slot's request changed) and its K/V writes
land before anything dispatched later — a new occupant's prefill writes
its window, and decode writes position p before reading it.

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
import contextlib
import gc
import heapq
import itertools
import math
import operator
import queue
import re
import threading
import time
import traceback
from typing import (Callable, Dict, Iterator, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np
import torch

from .. import native
from ..logging import Logger, new_logger
from ..models.llama import (DTYPES, init_kv_cache_layers,
                            init_kv_scale_layers, llama_decode_step_unrolled,
                            llama_decode_step_unrolled_q8, llama_prefill_chunk,
                            llama_prefill_chunk_q8, llama_prefill_last,
                            llama_verify_step)
from ..ops.decode_attention import quantize_kv
from ..container import STATUS_DEGRADED, STATUS_DOWN, STATUS_UP, Health
from .device import resolve_device
from .executor import Executor, next_bucket, synchronize
from .migrate import Lifecycle
from .obs import MetricsHook
from . import qos
from .ownership import loop_only
from .sampling import pack_controls, sample_tokens, temperature_of
from .stepledger import StepLedger
from .utilization import UtilizationLedger

_request_ids = itertools.count(1)
# the cache length a dense program is captured at, in its name
_CACHE_LEN = re.compile(r"-S(\d+)(?:-|$)")


class EngineDrainingError(RuntimeError):
    """Submitted, or still queued, while the engine drains for shutdown.
    status_code is duck-typed for the HTTP surface: 503 tells load
    balancers and clients to go elsewhere; retry_after_s is the
    Retry-After hint."""

    status_code = 503
    retry_after_s = 1.0

    def __init__(self):
        super().__init__("engine draining: not accepting new requests")


class CacheLostError(RuntimeError):
    """A program failed at its launch or its sync: the device state it was
    updating in place may be half-written, so the engine must restore its
    device state before serving again (_reset_device_state)."""


class DeviceLostError(RuntimeError):
    """Submitted while the reset-storm breaker is open: the device reset
    repeatedly inside the storm window and the engine refuses work until a
    half-open probe proves it sane. 503 duck-typed like the other sheds;
    retry_after_s carries the breaker's remaining cooldown."""

    status_code = 503

    def __init__(self, retry_after_s: float = 1.0):
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"device lost: reset-storm breaker open; retry in "
            f"{self.retry_after_s:.1f}s or on another backend")


class EngineStalledError(RuntimeError):
    """Submitted while the engine loop is stuck inside one device call
    past ``STALL_REJECT_S``. The server answers 503 at once (status_code
    and retry_after_s are duck-typed for the HTTP surface) instead of
    queueing the request behind a dispatch that may never complete, while
    health reports the engine DEGRADED with the stall age."""

    status_code = 503
    retry_after_s = 15.0

    def __init__(self, stall_s: float):
        super().__init__(
            f"engine loop stuck in a device call for {stall_s:.0f}s "
            f"(device not answering); shedding new requests")


def _aligned(nbytes: int) -> int:
    """nbytes rounded up to 16: every static input starts 16-byte aligned."""
    return -(-nbytes // 16) * 16


def _np_plane(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bf16 as its uint16 bit patterns (numpy has
    no bfloat16 without ml_dtypes, see tpu/kvtier.py)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _torch_plane(array: np.ndarray) -> torch.Tensor:
    """_np_plane's inverse: a uint16 array is bf16 patterns."""
    array = np.ascontiguousarray(array)
    if array.dtype == np.uint16:
        return torch.from_numpy(array.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def _cache_len_of(name: str) -> Optional[int]:
    """The cache length in a dense program's name; None for the others."""
    m = _CACHE_LEN.search(name)
    return int(m.group(1)) if m else None


class GenerationRequest:
    def __init__(self, prompt_tokens: Sequence[int], max_new_tokens: int = 128,
                 temperature: float = 0.0, stop_tokens: Optional[Set[int]] = None,
                 priority: int = 0, min_tokens: int = 0, top_p: float = 0.0,
                 top_k: int = 0, span=None, traceparent: Optional[str] = None,
                 qos_class: Optional[str] = None, tenant: str = ""):
        self.id = next(_request_ids)
        # the QoS plane's class (tpu/qos.py; None: unclassified) and the
        # tenant, for quotas, preemption and per-tenant accounting; the
        # class is already folded into `priority` by submit
        self.qos_class = qos_class
        self.tenant = tenant
        # admission priority: LOWER admits first; ties resolve FIFO by id
        self.priority = int(priority)
        # stop_tokens are ignored until this many tokens have been emitted
        self.min_tokens = max(0, int(min_tokens))
        self.prompt_tokens = list(prompt_tokens)
        self.max_new_tokens = max_new_tokens
        self.temperature = float(temperature)
        # per-request truncation of the sampled distribution (0 = off)
        self.top_p = float(top_p)
        self.top_k = int(top_k)
        self.stop_tokens = stop_tokens or set()
        # the caller's span (the HTTP server span) and its raw W3C header;
        # a streamed response ends the caller's span before admission, so
        # the engine's own tpu.generate span (gen_span, submit to finish)
        # carries the admission attributes too
        self.span = span
        self.traceparent = traceparent
        self.gen_span = None
        self.out_queue: "queue.Queue" = queue.Queue()
        self.cancelled = threading.Event()
        self.error: Optional[BaseException] = None
        # monotonic stamps: queue wait and TTFT are intervals
        self.enqueued_at = time.monotonic()
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.generated = 0
        # every token already delivered, in order: the replay ledger. After
        # a device reset the request re-admits with prompt + emitted as its
        # window and the rest of its budget, so no position is re-emitted
        # or dropped; len(emitted) == generated always
        self.emitted: List[int] = []
        # reset re-admissions consumed (bounded by the engine's
        # retry_budget; crossing it fails the request)
        self.replays = 0
        # QoS preemptions survived: each evacuates the slot and requeues at
        # prompt + emitted as a replay does, counted apart from replays and
        # outside the retry_budget
        self.preemptions = 0
        # disaggregated serving (tpu/disagg.py) and migration: True on a
        # request admitted through submit_handoff, whose prefill (and first
        # token) ran on another engine. handoff_blobs holds the shipped
        # per-page KV (kvtier.PageBlob list) until admission lands it in
        # the pool; None: recompute the resume window (the degraded path)
        self.disagg_handoff = False
        self.handoff_blobs = None

    @property
    def resume_tokens(self) -> List[int]:
        """The admission window: the prompt, plus the delivered tokens on
        a replay after a reset."""
        if not self.emitted:
            return self.prompt_tokens
        return self.prompt_tokens + self.emitted

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
    __slots__ = ("request", "length", "remaining", "pages", "chunking",
                 "history")

    def __init__(self):
        self.request: Optional[GenerationRequest] = None
        self.length = 0        # tokens whose KV is in the cache
        self.remaining = 0     # emissions left in the budget
        self.pages: Optional[List[int]] = None  # paged engine: owned page ids
        # a chunked prefill in progress: the slot is RESERVED (its rows are
        # being filled chunk by chunk) but not yet emitting, so it is
        # neither free nor demuxed until the final chunk
        self.chunking: Optional[GenerationRequest] = None
        # speculative mode: prompt + emitted tokens, the corpus the
        # prompt-lookup draft searches
        self.history: Optional[List[int]] = None

    @property
    def active(self) -> bool:
        return self.request is not None


class _Finisher:
    """Bounded off-loop worker for terminal-slot teardown (the
    reference's). Each job is a zero-argument callable whose inputs were
    captured on the loop thread. Jobs run FIFO on one ``llm-finisher``
    thread, and a request's job is made after its tokens were enqueued, so
    a client sees tokens, then None, and a returned ``result()`` means the
    recorder holds the record. A full queue (or a dead worker) makes
    submit() return False and the caller runs the job inline: jobs are
    never dropped. close() drains what is queued, bounded by its
    timeout."""

    def __init__(self, maxsize: int):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(maxsize)))
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def submit(self, job) -> bool:
        try:
            self._q.put_nowait(job)
        except queue.Full:
            return False
        if self._thread is None or not self._thread.is_alive():
            with self._lock:
                if self._thread is None or not self._thread.is_alive():
                    self._thread = threading.Thread(
                        target=self._run, name="llm-finisher", daemon=True)
                    self._thread.start()
        return True

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:   # close()'s sentinel, after the queue's jobs
                return
            try:
                job()
            except Exception:  # noqa: BLE001 - teardown is best-effort;
                pass           # the worker must not die

    def close(self, timeout_s: float = 10.0) -> None:
        """Drain the queued jobs, then stop the worker (the engine loop is
        joined: nothing new races the sentinel)."""
        thread = self._thread
        if thread is None or not thread.is_alive():
            while True:   # no worker: run the backlog inline
                try:
                    job = self._q.get_nowait()
                except queue.Empty:
                    return
                if job is None:
                    continue
                try:
                    job()
                except Exception:  # noqa: BLE001
                    pass
        self._q.put(None)
        thread.join(timeout=timeout_s)


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


def spec_accept_epilogue(g, logits0, temps, generator, drafts, draft_lens,
                         positions, d: int, top_k: int,
                         row_filter: bool = True):
    """Speculative verify's acceptance, shared by the dense and the paged
    verify programs (one implementation, as the reference insists): sample
    position 0 (through the per-row filters under [B, 3] controls unless
    row_filter is False), accept on greedy rows the longest prefix of
    drafts equal to the model's own argmax, and advance the loop state.

    g: [B, d+1] greedy continuations; logits0: [B, V] position 0's logits;
    temps: [B] or [B, 3] row controls; drafts / draft_lens: [B, d] / [B];
    positions: [B]. Returns (tokens [B], positions [B], out [B, d+1],
    n_emit [B]): row b emits out[b, :n_emit[b]]."""
    B = g.shape[0]
    next0 = sample_tokens(logits0, generator, temps, top_k=top_k,
                          row_filter=row_filter)
    greedy_row = temperature_of(temps) <= 0.0
    cols = torch.arange(d, device=g.device)[None, :]
    matches = ((drafts == g[:, :d]) & (cols < draft_lens[:, None])
               & greedy_row[:, None])
    accepted = torch.cumprod(matches.long(), dim=1).sum(dim=1)     # [B]
    out = torch.cat([next0[:, None], g[:, 1:]], dim=1)
    tokens = out[torch.arange(B, device=g.device), accepted]
    return tokens, positions + accepted + 1, out, accepted + 1


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
    tokens on the device) and ``_run_decode`` (returns the [B, block]
    tokens on the device).

    pipeline_depth: dispatches kept in flight (the reference's default 4).
    async_d2h: start each dispatch's device-to-host token copy at enqueue
    time. sampling_controls: per-request top_p / top_k ([B, 3] row
    controls; see the module docstring). retry_budget: replays a request
    may take after device resets; reset_storm_max / reset_storm_window_s /
    breaker_cooldown_s: the reset-storm breaker (tpu/faults.py); faults: a
    FaultPlane, or None; finisher_queue: the off-loop finisher's bound (0:
    teardown inline)."""

    STOP_JOIN_S = 30.0
    # the stall watchdog: a loop stuck this long inside one device call
    # sheds new requests (EngineStalledError) and degrades health
    STALL_REJECT_S = 150.0
    # adaptive speculation (class attributes, so tests can tighten them):
    # the EMA smoothing of accepted tokens per eligible row, the floor below
    # which verify dispatches pause, how many block-decode dispatches a
    # cooloff lasts, and the EMA a probe restarts at (2x the floor: ~4-5
    # zero-acceptance verifies before cooling again, one good to recover)
    SPEC_EMA_ALPHA = 0.2
    SPEC_MIN_ACCEPT = 0.25
    SPEC_COOLOFF_DISPATCHES = 16
    SPEC_PROBE_EMA = 0.5
    # the paged subclass reads through its paged kernel whatever
    # cfg.decode_attn says, so the dense-only rules below skip it
    _paged = False
    # a chunk job records its admission at its first chunk and an event per
    # chunk, as the reference's dense engine does (its paged engine records
    # neither: the admission comes at the final chunk's binding)
    _records_chunks = True
    # KV hand-off landing: the paged subclass can restore shipped page
    # blobs (kvtier.PageBlob) into its pool, for disaggregated decode pools
    # and for migration; the dense engine always replays from tokens
    supports_kv_handoff = False

    def __init__(self, params, cfg, n_slots: int = 8,
                 max_seq_len: Optional[int] = None,
                 prefill_buckets: Sequence[int] = (16, 32, 64, 128, 256, 512,
                                                   1024),
                 top_k: int = 0, decode_block_size: int = 16,
                 pipeline_depth: int = 4, async_d2h: bool = True,
                 sampling_controls: bool = False, seed: int = 0,
                 budget_bytes: Optional[int] = None,
                 speculative_tokens: int = 0, chunk_prefill_tokens: int = 0,
                 device=None, metrics=None, tracer=None,
                 logger: Optional[Logger] = None, retry_budget: int = 2,
                 reset_storm_max: int = 3,
                 reset_storm_window_s: float = 60.0,
                 breaker_cooldown_s: float = 5.0, faults=None,
                 finisher_queue: int = 256, disagg_role: str = "",
                 handoff_sink=None, mesh=None, admission_plane=None):
        self.device = resolve_device(device)
        # tensor-parallel serving (the module docstring): this rank's block
        # of the params (serving_param_specs) and its rank-local config,
        # whose head counts shape the caches and pools and whose tp axis
        # the model functions reduce over
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.sharding import (serving_param_specs,
                                             shard_config, shard_params)

            rank_cfg = shard_config(cfg, mesh)   # raises unless tp divides
            params = shard_params(params, mesh, serving_param_specs(
                quantized=isinstance(params, dict)
                and "lm_head_s" in params))
            cfg = rank_cfg
        self.params = params
        self.cfg = cfg
        self.logger = logger or new_logger()
        # the metrics manager (tpu/device.register_metrics' names) and the
        # tracer; either may be None
        self.metrics = metrics
        self.tracer = tracer
        self._obs = MetricsHook(metrics, logger=self.logger)
        # one id per dispatch, on its span and its requests' spans
        self._batch_seq = itertools.count(1)
        self.n_slots = n_slots
        self.max_seq_len = min(max_seq_len or cfg.max_seq_len,
                               cfg.max_seq_len)
        self.prefill_buckets = tuple(b for b in prefill_buckets
                                     if b <= self.max_seq_len)
        # the capacity plan (tpu/capacity.py): with a budget, clamp
        # (n_slots, max_seq_len) and the buckets so the weights, the cache,
        # the prefill transients and, on the card, the graph pools fit
        self.plan = None
        if budget_bytes is not None and budget_bytes > 0:
            from ..models.llama import params_nbytes
            from .capacity import graph_pool_margin, plan_capacity

            self.plan = plan_capacity(
                cfg, self.n_slots, self.max_seq_len, budget_bytes,
                prefill_buckets=self.prefill_buckets, paged=self._paged,
                params_nbytes=params_nbytes(params),
                graph_pool_bytes=(graph_pool_margin(cfg)
                                  if self.device.type == "cuda" else 0))
            self.n_slots = self.plan.n_slots
            self.max_seq_len = self.plan.max_seq_len
            self.prefill_buckets = self.plan.prefill_buckets
            (self.logger.warnf if self.plan.clamped
             else self.logger.infof)("%s", self.plan.summary())
        if mesh is not None:
            self._agree_on_plan()
        # the Pallas decode kernel reads the cache in min(512, S) blocks
        # and the reference rounds the cap down at boot so a grow clamped
        # to max_seq_len stays divisible; the CUDA kernel takes any S, but
        # the cap is the admission limit users see, so it is kept
        if (cfg.decode_attn == "kernel" and not self._paged
                and self.max_seq_len > 512 and self.max_seq_len % 512):
            rounded = (self.max_seq_len // 512) * 512
            self.logger.warnf(
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
        # speculative decoding (prompt-lookup drafting): d > 0 replaces the
        # block decode by a VERIFY dispatch scoring each row's current token
        # and up to d host-proposed drafts in one forward; greedy output is
        # the plain engine's. Verify dispatches run one at a time (the next
        # window starts where this one's acceptance ends)
        self.speculative_tokens = max(0, int(speculative_tokens))
        # bound once: the native scan, or the Python one without a compiler
        self._native_propose = (native.propose_draft if native.available()
                                else None)
        # adaptive speculation: the accepted-per-eligible-row estimate picks
        # a verify or a pipelined block decode; a cold streak cools off for
        # SPEC_COOLOFF_DISPATCHES blocks, then probes again
        self._spec_accept_ema = float(self.speculative_tokens)
        self._spec_cooloff = 0
        # consecutive verify rounds in which no row had a draft (two in a
        # row cool off: _dispatch_verify's zero-draft branch)
        self._spec_no_draft_streak = 0
        if self.speculative_tokens:
            if self._q8:
                raise ValueError("speculative_tokens with kv_dtype='int8' "
                                 "is not supported yet (the verify window "
                                 "needs a dequant cached-attention read)")
            if chunk_prefill_tokens:
                raise ValueError("speculative_tokens with chunked prefill "
                                 "is not supported yet")
        # chunked prefill (0 = off): prompts in buckets larger than this are
        # admitted as several bounded chunk dispatches, so decode blocks and
        # other admissions run between them; the chunk size must divide
        # every bucket it splits
        self.chunk_prefill_tokens = max(0, int(chunk_prefill_tokens))
        if self.chunk_prefill_tokens:
            for bucket in self.prefill_buckets:
                if (bucket > self.chunk_prefill_tokens
                        and bucket % self.chunk_prefill_tokens):
                    raise ValueError(
                        f"chunk_prefill_tokens={self.chunk_prefill_tokens} "
                        f"must divide prefill bucket {bucket}")
        # chunk jobs in admission order; the oldest advances one chunk per
        # loop iteration
        self._chunk_jobs: collections.deque = collections.deque()
        # a chunk job's carried device state lives in its program's buffers
        # (a graph reads fixed addresses): key -> the buffers, and the job
        # whose state they hold; a job of the same shape swaps it out
        self._chunk_bufs: Dict[tuple, Tuple[torch.Tensor, ...]] = {}
        self._chunk_resident: Dict[tuple, dict] = {}
        self.top_k = top_k
        self.decode_block_size = max(1, decode_block_size)
        self.pipeline_depth = max(1, pipeline_depth)
        self.async_d2h = bool(async_d2h)
        self.sampling_controls = bool(sampling_controls)
        # on every program name: the widened sampling state
        self._id_tag = "-sc" if self.sampling_controls else ""
        # slots whose control row on the device may be set (loop-thread
        # owned): a decode block runs the per-row filters iff any is
        self._filter_rows: Set[int] = set()
        # one post-hoc scoring pass at a time (tpu/score.py): its programs
        # share their buffers; the pass's state, made at its first use
        self._post_hoc_lock = threading.Lock()
        self._post_hoc = None
        self._seed = seed
        # the generator's seed at boot, then one more at each reset
        self._reset_counter = itertools.count(seed)
        self.slots = [_Slot() for _ in range(self.n_slots)]
        # arrivals (thread-safe) and the loop-owned admission heap of
        # (priority, id, request): requests parked on a subclass resource
        # (free pages) wait here; same-priority requests stay FIFO
        self._pending: "queue.PriorityQueue" = queue.PriorityQueue()
        self._admission_heap: List[tuple] = []
        self._wake = threading.Event()
        self._stop = threading.Event()
        # drain(): no admission; the loop fails what is queued. The lock
        # spans an admission from its pop to its slots' binding, so the
        # drain's poll never sees a request in neither place
        self._draining = False
        self._state_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        # multi-controller admission (tpu/admission.AdmissionPlane): rank 0
        # publishes each wave's composition, the other ranks replay it, so
        # every rank of a TP group dispatches the same programs in the same
        # order. None = single-controller serving
        self._plane = admission_plane
        if admission_plane is not None:
            admission_plane.stop_event = self._stop
        # dispatched, not yet synced: (kind, host fetch, rows, block) with
        # kind "prefill" (rows: the admitted (slot, request) pairs) or
        # "decode" (rows: the active pairs at dispatch)
        self._inflight: collections.deque = collections.deque()
        # the engine's one stream on the card (dispatch order is execution
        # order); None on the CPU
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        # the program cache, on this engine's device and stream
        self.executor = Executor(self.device, stream=self._stream)
        self.executor.metrics = metrics
        # the observability planes (the module docstring): the two ledgers
        # are always on; the recorder, timeline and host profiler are wired
        # by the App's enable_* methods
        from ..models.llama import params_nbytes

        on_card = self.device.type == "cuda"
        self.util = UtilizationLedger(
            cfg, metrics=metrics, params_nbytes=params_nbytes(params),
            platform="gpu" if on_card else "cpu",
            device_kind=(torch.cuda.get_device_name(self.device)
                         if on_card else None))
        self.steps = StepLedger(metrics=metrics, logger=self.logger)
        self.executor.on_compile = self._note_compile
        self.recorder = None
        self.timeline = None
        self.hostprof = None
        self.lifecycle = Lifecycle("serving")
        # the watchdog's heartbeat, stamped at the top of every iteration
        self._last_step_at = time.monotonic()
        # (synced_at, tokens) of the last 5 s: app_tpu_tokens_per_second
        self._tok_window: collections.deque = collections.deque()
        # pinned [n_slots * decode_block_size] int64 buffers free for a
        # token copy (taken at dispatch, given back at sync)
        self._host_free: List[torch.Tensor] = []
        # key -> the static inputs of its programs (_static_inputs), and the
        # device block under each, by its address; the pinned staging ring
        # that fills them (made at the first upload on the card) and its
        # next buffer
        self._static: Dict[tuple, Tuple[torch.Tensor, ...]] = {}
        self._blocks: Dict[int, torch.Tensor] = {}
        self._ring: List[tuple] = []
        self._ring_next = 0
        # the card memory warmup()'s and warmup_scoring()'s captures reserved
        # (0 on the CPU)
        self.graph_pool_bytes = 0
        self.score_pool_bytes = 0
        # dispatch counts (loop-thread writes): what a run can show about
        # the kernels it went through. Full-window prefill waves (flash on
        # the card) and the paged engine's tail-only prefix-hit waves are
        # counted apart; (K, bucket) -> waves of that shape dispatched
        self.prefill_dispatches = 0
        self.prefill_shapes: collections.Counter = collections.Counter()
        self.prefix_dispatches = 0
        self.prefix_shapes: collections.Counter = collections.Counter()
        self.decode_steps = 0
        self.decode_blocks = 0
        # the most dispatches in flight at once
        self.max_inflight = 0
        # speculation: verify dispatches, drafts proposed, drafts accepted
        # on the device, greedy-eligible rows over the verifies synced,
        # cooloffs engaged and zero-draft rounds fallen back to a block
        self.verify_dispatches = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_eligible = 0
        self.spec_cooloffs = 0
        self.spec_zero_draft = 0
        # chunked prefill: chunk dispatches, jobs started, and the swaps of
        # a job's carried state between jobs of one shape (and their bytes)
        self.chunk_dispatches = 0
        self.chunk_jobs = 0
        self.chunk_swaps = 0
        self.chunk_swap_bytes = 0
        # the fault-injection plane (tpu/faults.py): None in production,
        # every site one attribute check; the incident plane
        # (tpu/incidents.py), the capacity meter (tpu/meter.py) and the QoS
        # controller (tpu/qos.py): None until App.enable_incident_autopsy /
        # enable_capacity / enable_qos. _meter_rows stages one sync's rows
        # until _finish_step charges them
        self.faults = faults
        self.incidents = None
        self.meter = None
        self.qos = None
        self._meter_rows = None
        # crash-only recovery: replay after a reset and the reset-storm
        # breaker (the module docstring)
        from .faults import ResetStormBreaker

        self.retry_budget = max(0, int(retry_budget))
        self.breaker = ResetStormBreaker(max_resets=reset_storm_max,
                                         window_s=reset_storm_window_s,
                                         cooldown_s=breaker_cooldown_s)
        # (request id, consecutive resets) while that request was the SOLE
        # work in flight: two in a row quarantine it
        self._sole_reset_id: Optional[int] = None
        self._sole_reset_streak = 0
        # recovery evidence (loop-thread writes)
        self.resets_total = 0
        self.replays_total = 0
        self.replayed_tokens_total = 0
        self.quarantined_total = 0
        # QoS preemptions (loop-thread writes)
        self.preemptions_total = 0
        # disaggregated prefill/decode (tpu/disagg.py): "" = colocated,
        # "prefill" = prompt ingestion only, each finished prompt's KV
        # exported to the hand-off sink instead of entering decode,
        # "decode" = admissions through submit_handoff, a prefill only as
        # the recompute fallback. KV ships as pages: the paged engine only
        self.disagg_role = str(disagg_role or "")
        if self.disagg_role not in ("", "prefill", "decode"):
            raise ValueError(f"disagg_role={disagg_role!r}: "
                             f"use '', 'prefill' or 'decode'")
        if self.disagg_role and not self.supports_kv_handoff:
            raise ValueError("disaggregated serving requires the paged "
                             "engine (KV hands off as page blobs)")
        if self.disagg_role and admission_plane is not None:
            raise ValueError(
                "disaggregated roles are single-controller only; the "
                "multi-host admission plane cannot mirror hand-offs")
        # prefill role: sink(request, blobs, n_ctx) on the loop thread right
        # after the first token; True when delivered (False: the sink
        # arranged the fallback). _handoff_fail: a failing request is
        # offered to it first; True means the worker took the stream (no
        # error, no terminal None here). Both wired by disagg.PrefillWorker
        self._handoff_sink = handoff_sink
        self._handoff_fail = None
        self.handoffs_total = 0
        self.handoff_fallbacks_total = 0
        # drain with migration (tpu/migrate.py): a one-shot export round of
        # every live decode slot, run by the loop at a quiesced boundary
        self._migrate_sink = None
        self._migrate_request = False
        self.migrations_total = 0
        # pinned host staging of landings still in flight on the card:
        # (event, tensors), kept until the event says the copy is done
        self._landings: collections.deque = collections.deque()
        # terminal teardown off the loop (finisher_queue=0: inline)
        self._finisher: Optional[_Finisher] = (
            _Finisher(finisher_queue) if finisher_queue > 0 else None)
        self._init_device_state()
        if self._stream is not None:   # the state was made on the default one
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def _agree_on_plan(self) -> None:
        """Every rank of the TP group must serve the same (n_slots,
        max_seq_len, buckets): differing plans dispatch different programs
        and deadlock the collectives. Each rank plans its own card's bytes
        (tpu/capacity.py), and the group takes the minimum, by one
        all-reduce, which is also the group's first collective: on the
        card it runs eagerly, before any capture, so the NCCL communicator
        exists when the programs are captured with their collectives."""
        import torch.distributed as dist

        agreed = torch.tensor([self.n_slots, self.max_seq_len],
                              dtype=torch.int64, device=self.device)
        dist.all_reduce(agreed, op=dist.ReduceOp.MIN,
                        group=self.cfg.tp.group)
        n_slots, seq = (int(v) for v in agreed.tolist())
        if (n_slots, seq) != (self.n_slots, self.max_seq_len):
            self.logger.warnf(
                "tp group plan: n_slots %d -> %d, max_seq_len %d -> %d "
                "(the smallest rank's)", self.n_slots, n_slots,
                self.max_seq_len, seq)
        self.n_slots, self.max_seq_len = n_slots, seq
        self.prefill_buckets = tuple(b for b in self.prefill_buckets
                                     if b <= seq)

    @property
    def tp_size(self) -> int:
        """The engine's tensor-parallel degree (1 without a mesh)."""
        return getattr(self.cfg, "tp_size", 1)

    def _single_controller(self, what: str) -> None:
        """Raise for an operation one rank of a TP group would issue alone:
        its collectives would wait for peers that never join."""
        if self.tp_size > 1:
            raise RuntimeError(f"{what} is single-controller only; under "
                               f"tp={self.tp_size} no peer rank mirrors it")

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
        self._temps = self._temps_init(B)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(next(self._reset_counter))

    def _temps_init(self, rows: int) -> torch.Tensor:
        """Zeroed per-row sampling state: [rows] temperatures, or [rows, 3]
        (temperature, top_p, top_k) under sampling_controls."""
        shape = (rows, 3) if self.sampling_controls else (rows,)
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

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
        try:
            with self.steps.seg("cache_grow"):
                if self.faults is not None:
                    self.faults.hit("engine.cache_grow")
                self._grow_cache_to(new_len)
        except Exception as exc:
            # the copy was under way on the caches the programs update: a
            # device-state loss, not a host failure of one wave
            raise CacheLostError(
                f"cache growth to {new_len} failed: {exc}") from exc
        if self.recorder is not None:
            self.recorder.record_engine_event("cache_grow", new_len=new_len)

    def _grow_cache_to(self, new_len: int) -> None:
        if self._stream is not None:
            # the in-flight blocks read the old buffers, which were made
            # on another stream: let them finish before the buffers go
            self._stream.synchronize()
        # the programs of the old length, decode and prefill, read and write
        # buffers that are going
        self.executor.drop(lambda name: _cache_len_of(name) == self._cache_len)
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
        self.logger.debugf("grew KV cache to %d", new_len)

    def _decode_need(self) -> int:
        """Cache length every active row needs after this dispatch.

        Host-side slot.length lags the device by the pipelined in-flight
        dispatches, so budget a block for each outstanding dispatch plus
        this one."""
        longest = max((slot.length for slot in self.slots if slot.active),
                      default=0)
        outstanding = len(self._inflight) + 1
        # adaptive speculation interleaves verifies (d+1 tokens) and blocks
        per_dispatch = (max(self.speculative_tokens + 1,
                            self.decode_block_size)
                        if self.speculative_tokens else self.decode_block_size)
        return longest + per_dispatch * outstanding + 1

    # -- programs -------------------------------------------------------------
    def _prep_admission(self, bucket: int, batch: List[GenerationRequest],
                        starts: Optional[Sequence[int]] = None):
        """The host arrays of one fused admission: [K, bucket] int64 window
        tokens, [K] int32 lengths, [K] f32 temperatures ([K, 3] f32 row
        controls under sampling_controls). The windows are resume_tokens: a
        replayed request rebuilds its whole context. starts: per row, the
        first position the window holds (a prefix hit's tail; default 0);
        lengths are the full windows'. The step ledger's host_prep."""
        with self.steps.seg("host_prep"):
            ptokens = np.zeros((len(batch), bucket), dtype=np.int64)
            for row, request in enumerate(batch):
                window = request.resume_tokens[starts[row] if starts else 0:]
                ptokens[row, :len(window)] = window
            lengths = np.asarray([len(r.resume_tokens) for r in batch],
                                 dtype=np.int32)
            if self.sampling_controls:
                temps = pack_controls([r.temperature for r in batch],
                                      [r.top_p for r in batch],
                                      [r.top_k for r in batch])
            else:
                temps = np.asarray([r.temperature for r in batch],
                                   dtype=np.float32)
        return ptokens, lengths, temps

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
        """Sample the admitted rows' first tokens (through the per-row
        filters under sampling_controls) and splice them, their positions
        and sampling rows into the loop state. Returns [K]."""
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

    def _decode_loop(self, step, block: int, row_filter: bool = True
                     ) -> torch.Tensor:
        """`block` lock-step decode steps: step(tokens, positions) -> [B, V]
        logits; row_filter: run the per-row filters (sampling_controls).
        Returns the [B, block] sampled tokens and advances the loop state in
        place."""
        tok, pos = self._tokens, self._positions
        out = []
        for _ in range(block):
            tok = sample_tokens(step(tok, pos), self.generator, self._temps,
                                top_k=self.top_k, row_filter=row_filter)
            pos = pos + 1
            out.append(tok)
        self._tokens.copy_(tok)
        self._positions.copy_(pos)
        return torch.stack(out, dim=1)

    def _decode_fn(self, block: int, row_filter: bool = True
                   ) -> torch.Tensor:
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
        return self._decode_loop(step, block, row_filter)

    def _block_sizes(self) -> List[int]:
        """The decode blocks dispatched: full, and half under admission
        pressure (_decode_block_now)."""
        return sorted({self.decode_block_size,
                       max(1, self.decode_block_size // 2)}, reverse=True)

    def _decode_variants(self) -> Tuple[bool, ...]:
        """The decode programs of each block shape, by whether they run the
        per-row filters: both under sampling_controls, else one."""
        return (True, False) if self.sampling_controls else (True,)

    def _row_filter_now(self) -> bool:
        """Whether the next decode block must run the per-row filters: a
        row on the device may have a control set."""
        return bool(self._filter_rows) or not self.sampling_controls

    def _decode_tag(self, row_filter: bool) -> str:
        """A decode program's name tag: the engine's _id_tag, and -nosort on
        the sampling_controls block without the per-row filters."""
        if self.sampling_controls and not row_filter:
            return self._id_tag + "-nosort"
        return self._id_tag

    def _decode_program_name(self, block: int, cache_len: int,
                             row_filter: bool = True) -> str:
        tag = self._decode_tag(row_filter)
        if self._q8:
            return f"llama-decode-q8-x{block}-S{cache_len}{tag}"
        suffix = "-kern" if self.cfg.decode_attn == "kernel" else ""
        return f"llama-decode-x{block}-S{cache_len}{suffix}{tag}"

    def _decode_program(self, block: int, row_filter: bool = True):
        """The `block`-step decode program at the cache's current length:
        one CUDA graph per (block, length, variant) on the card. Its warm-up
        puts every row at position S - 1: a row writes a position before it
        reads it, so no live row reads what the run leaves there (writes
        past S - 1 clamp to it)."""
        return self.executor.compile(
            self._decode_program_name(block, self._cache_len, row_filter),
            lambda: self._decode_fn(block, row_filter),
            warmup=lambda: self._warmup_state(
                lambda: self._positions.fill_(self._cache_len - 1)),
            generators=(self.generator,))

    def _row_specs(self, K: int) -> list:
        """The static inputs every admission program ends with, as [K]
        rows: slots (int64), lengths (int32), temperatures (f32; [K, 3]
        row controls under sampling_controls)."""
        temps = (K, 3) if self.sampling_controls else (K,)
        return [((K,), torch.long), ((K,), torch.int32),
                (temps, torch.float32)]

    def _prefill_program(self, bucket: int, K: int,
                         slots: Optional[Sequence[int]] = None):
        """The fused K-way admission program at `bucket` over the caches at
        their current length (the reference's ``_prefill_program(bucket,
        K)``): one CUDA graph per (bucket, K, length) on the card. Static
        inputs: tokens [K, bucket], then the rows (_row_specs). slots: the
        wave's target rows, which the warm-up before a capture writes
        (default the first K: at boot no row is live)."""
        kind = "-q8" if self._q8 else ""
        flash = "-flash" if self.cfg.attn_impl == "flash" else ""
        inputs = self._static_inputs(
            ("prefill", bucket, K),
            [((K, bucket), torch.long), *self._row_specs(K)])
        return self.executor.compile(
            f"llama-prefill{kind}-{bucket}x{K}-S{self._cache_len}{flash}"
            f"{self._id_tag}",
            self._prefill_fn, inputs,
            warmup=lambda: self._warmup_state(
                lambda: self._harmless_wave(inputs, slots)),
            generators=(self.generator,))

    def _harmless_wave(self, inputs, slots) -> None:
        """Fill an admission program's inputs with a wave that writes only
        where no live row reads: every row one token long at temperature 0,
        zero page tables and prefix lengths (paged: every K/V write lands on
        the garbage page 0), into `slots` (dense: their cache rows at [0,
        bucket), free by construction; the loop state it splices there is
        restored by _warmup_state)."""
        for t in inputs:
            t.zero_()
        K = inputs[0].shape[0]
        inputs[-3].copy_(torch.as_tensor(
            list(slots) if slots is not None else list(range(K))))
        inputs[-2].fill_(1)

    @contextlib.contextmanager
    def _warmup_state(self, harmless: Callable[[], object],
                      extra: Sequence[torch.Tensor] = ()):
        """Around the eager run before a capture, which writes K/V and the
        loop state and advances the generator: the tokens, positions,
        temperatures, `extra` (a live chunk job's carried state) and the
        generator are saved and restored, and `harmless` points the run's
        K/V writes where no live row reads."""
        kept = (self._tokens, self._positions, self._temps, *extra)
        saved = [t.clone() for t in kept]
        rng = self.generator.get_state()
        harmless()
        try:
            yield
        finally:
            for t, s in zip(kept, saved):
                t.copy_(s)
            self.generator.set_state(rng)

    def warmup(self, k_variants: bool = False) -> None:
        """Capture every program serving is expected to reach, so no capture
        stalls the loop later (the reference's ``warmup``): every decode
        block, the fused admission at K=1 for every bucket and, with
        k_variants (WARMUP=wide), at every power-of-two K <= n_slots; the
        paged engine adds the prefix cache's tail programs (see its
        _warm_programs). Call it before start(): a capture must not race
        the loop. Sets graph_pool_bytes, the card memory the captures
        reserved."""
        if self._thread is not None:
            raise RuntimeError("warmup() runs before start()")
        with torch.no_grad(), self._stream_ctx():
            if not self._paged:
                # the last length the cache can reach (the reference grows
                # to the largest bucket; each later growth would capture
                # every program again, mid-serving)
                self._grow_cache(self.max_seq_len)
            before = self._reserved()
            self._warm_programs(k_variants)
            self.graph_pool_bytes = self._reserved() - before

    def _warm_ks(self, k_variants: bool) -> List[int]:
        """The admission widths warmed: 1, or with k_variants every power of
        two <= n_slots, as the reference's."""
        ks = [1]
        while k_variants and ks[-1] * 2 <= self.n_slots:
            ks.append(ks[-1] * 2)
        return ks

    def _chunked(self, bucket: int) -> bool:
        """Whether a wave at `bucket` is admitted in chunks."""
        return bool(self.chunk_prefill_tokens
                    and bucket > self.chunk_prefill_tokens)

    def _warm_programs(self, k_variants: bool) -> None:
        """Dense, all at the grown length: the admission at each of
        _warm_ks for every bucket not routed to chunks; for each of those
        K the first and final chunk programs (and the middle one where a
        bucket has more than two chunks); the verify program; and the full
        and the half decode block, which a cooloff runs (each variant)."""
        chunk = self.chunk_prefill_tokens
        for bucket in self.prefill_buckets:
            if not self._chunked(bucket):
                for K in self._warm_ks(k_variants):
                    self._prefill_program(bucket, K)
        if any(self._chunked(b) for b in self.prefill_buckets):
            for K in self._warm_ks(k_variants):
                self._chunk_program(chunk, K, first=True, final=False)
                self._chunk_program(chunk, K, first=False, final=True)
                if any(b > 2 * chunk for b in self.prefill_buckets):
                    self._chunk_program(chunk, K, first=False, final=False)
        for row_filter in self._decode_variants():
            if self.speculative_tokens:
                self._verify_program(row_filter)
            for block in self._block_sizes():
                self._decode_program(block, row_filter)

    def _reserved(self) -> int:
        """The card memory reserved on the engine's device once unreachable
        objects are collected and the caching allocator has let go of what
        nothing holds (a graph pool holds its blocks); 0 on the CPU."""
        if self._stream is None:
            return 0
        gc.collect()
        synchronize(self.device, empty_cache=True)
        return torch.cuda.memory_reserved(self.device)

    # -- speculative decoding (prompt-lookup drafting) ------------------------
    def _propose_draft(self, history: List[int]) -> List[int]:
        """Prompt-lookup draft: the tokens that followed the most recent
        earlier occurrence of the sequence's trailing bigram, up to
        speculative_tokens of them; empty without a match (the row then
        rides the verify as a one-token step). The native scan
        (native.propose_draft), or this Python one without a compiler."""
        d = self.speculative_tokens
        if self._native_propose is not None:
            return self._native_propose(history, d)
        n = 2
        if len(history) < n + 1:
            return []
        tail = history[-n:]
        for i in range(len(history) - n - 1, -1, -1):
            if history[i:i + n] == tail:
                return history[i + n: i + n + d]
        return []

    def _verify_forward(self, drafts, *table):
        """The window forward of a verify: (greedy [B, d+1], logits0
        [B, V]); the dense engine's over its caches."""
        return llama_verify_step(self.params, self.cfg, self._tokens, drafts,
                                 self._positions, self.k_cache,
                                 self.v_cache)[:2]

    def _verify_fn(self, drafts, draft_lens, row_filter: bool, *table):
        """One verify dispatch: the window forward, then the shared
        acceptance (spec_accept_epilogue), the loop state advanced in place.
        Returns [B, d+2]: the [B, d+1] tokens and, last, the emit counts."""
        g, logits0 = self._verify_forward(drafts, *table)
        tokens, positions, out, n_emit = spec_accept_epilogue(
            g, logits0, self._temps, self.generator, drafts, draft_lens,
            self._positions, self.speculative_tokens, self.top_k,
            row_filter)
        self._tokens.copy_(tokens)
        self._positions.copy_(positions)
        return torch.cat([out, n_emit[:, None]], dim=1)

    def _verify_specs(self) -> list:
        """The static inputs every verify program ends with: drafts [B, d]
        (int64) and their lengths [B] (int32)."""
        B = self.n_slots
        return [((B, self.speculative_tokens), torch.long),
                ((B,), torch.int32)]

    def _verify_program(self, row_filter: bool = True):
        """The verify program at the cache's current length (the
        reference's ``llama-verify-x{d}-S{len}``, with the decode blocks'
        variant tag: under sampling_controls ``-sc`` samples position 0
        through the per-row filters and ``-sc-nosort`` without). Its
        warm-up puts every row at S - 1, where the window's writes clamp."""
        inputs = self._static_inputs(("verify",), self._verify_specs())
        flash = "-flash" if self.cfg.attn_impl == "flash" else ""
        return self.executor.compile(
            f"llama-verify-x{self.speculative_tokens}-S{self._cache_len}"
            f"{flash}{self._decode_tag(row_filter)}",
            lambda drafts, lens: self._verify_fn(drafts, lens, row_filter),
            inputs,
            warmup=lambda: self._warmup_state(
                lambda: self._positions.fill_(self._cache_len - 1)),
            generators=(self.generator,))

    def _verify_call(self, drafts: np.ndarray, lens: np.ndarray
                     ) -> torch.Tensor:
        """Run the verify program over the caches, grown first to what the
        active rows need; returns its [B, d+2] output on the device."""
        need = self._decode_need()
        if need > self._cache_len:
            self._grow_cache(need)
        return self._call(self._verify_program(self._row_filter_now()),
                          (drafts, lens), "engine.verify")

    def _dispatch_verify(self) -> None:
        """Propose drafts for the greedy rows and dispatch one verify, its
        D2H started. With no draft at all, a block decode goes instead (a
        verify would be an unpipelined one-token step); two such rounds in
        a row cool speculation off."""
        d, B = self.speculative_tokens, self.n_slots
        drafts = np.zeros((B, d), dtype=np.int64)
        lens = np.zeros((B,), dtype=np.int32)
        snapshot = []
        with self.steps.seg("host_prep"):
            for i, slot in enumerate(self.slots):
                if not slot.active:
                    continue
                # acceptance is exact-match against the argmax, so only
                # greedy rows draft; a temperature row rides along as a
                # one-token step. Eligibility travels with the snapshot:
                # the acceptance EMA divides by the rows that COULD accept
                eligible = bool(slot.request.temperature <= 0.0
                                and slot.history and slot.remaining > 0)
                snapshot.append((i, slot.request, eligible))
                if eligible:
                    cont = self._propose_draft(slot.history)
                    if cont:
                        drafts[i, :len(cont)] = cont
                        lens[i] = len(cont)
        if not lens.any():
            # zero drafts is no acceptance signal (the EMA stays), but two
            # draftless rounds in a row let block decodes pipeline again
            self.spec_zero_draft += 1
            self._spec_no_draft_streak += 1
            if self._spec_no_draft_streak >= 2:
                self._cool_off()
            self._dispatch_decode()
            return
        self._spec_no_draft_streak = 0
        self.steps.note_dispatch("verify")
        started = time.monotonic()
        # a failure raises out of the step: the loop resets and replays
        fetch = self._start_d2h(self._verify_call(drafts, lens))
        self.verify_dispatches += 1
        self.spec_drafted += int(lens.sum())
        self._obs.counter("app_tpu_spec_drafted_total", float(lens.sum()))
        dspan = self._dispatch_span("tpu.verify", next(self._batch_seq),
                                    **{"batch.size": len(snapshot),
                                       "tpu.draft_tokens": int(lens.sum())})
        self._push(("verify", fetch, snapshot, d, started, dspan))

    def _cool_off(self) -> None:
        """Pause verifies for SPEC_COOLOFF_DISPATCHES block decodes."""
        if self._spec_cooloff <= 0:
            self.spec_cooloffs += 1
        self._spec_cooloff = self.SPEC_COOLOFF_DISPATCHES

    # -- chunked prefill ------------------------------------------------------
    def _chunk_key(self, bucket: int, K: int) -> tuple:
        """The key of a chunk job's programs, static inputs and carried
        state: the dense engine's depend on (chunk, K) only."""
        return ("chunk", self.chunk_prefill_tokens, K)

    def _chunk_state_specs(self, key: tuple) -> list:
        """The carried state of a job keyed `key`: the dense engine's
        [K, V] f32 logits of each row's last prompt position (`selected`: a
        short row's last token may fall in any chunk)."""
        return [((key[2], self.cfg.vocab_size), torch.float32)]

    def _chunk_state(self, key: tuple) -> Tuple[torch.Tensor, ...]:
        """The carried-state buffers of the chunk programs keyed `key`,
        made zeroed at first use and kept for the engine's life."""
        bufs = self._chunk_bufs.get(key)
        if bufs is None:
            bufs = self._chunk_bufs[key] = tuple(
                torch.zeros(shape, dtype=dtype, device=self.device)
                for shape, dtype in self._chunk_state_specs(key))
        return bufs

    def _chunk_live_state(self, key: tuple) -> Tuple[torch.Tensor, ...]:
        """The buffers a capture's warm-up must save and restore: those
        keyed `key` while a job's state is in them, else none."""
        return self._chunk_bufs[key] if key in self._chunk_resident else ()

    def _chunk_specs(self, K: int, extra: list) -> list:
        """A chunk program's static inputs: tokens and positions [K, chunk]
        (int64), `extra` (the paged engine's page table), the chunk's start
        [1] (int64), then the rows (_row_specs)."""
        chunk = self.chunk_prefill_tokens
        return [((K, chunk), torch.long), ((K, chunk), torch.long), *extra,
                ((1,), torch.long), *self._row_specs(K)]

    def _harmless_chunk(self, inputs, slots, park: Optional[int]) -> None:
        """_harmless_wave for a chunk program, with every position at
        `park` (dense: the cache's last column, where no live row reads)."""
        self._harmless_wave(inputs, slots)
        if park is not None:
            inputs[1].fill_(park)

    def _chunk_forward(self, selected, ctokens, cpositions, start, slots,
                       lengths, tmp=None):
        """One chunk's forward (the rows' own caches, or the paged job's
        temps `tmp`), its last-position logits folded into `selected`
        where a row's last prompt token falls in this chunk."""
        chunk = ctokens.shape[1]
        project_last = (lengths.long() - 1 - start).clamp(0, chunk - 1)
        params, cfg = self.params, self.cfg
        if tmp is not None:
            logits = llama_prefill_chunk(params, cfg, ctokens, cpositions,
                                         list(tmp[0]), list(tmp[1]), None,
                                         project_last)[0]
        elif self._q8:
            logits = llama_prefill_chunk_q8(
                params, cfg, ctokens, cpositions, self.k_cache, self.v_cache,
                self.k_scale, self.v_scale, slots, project_last)[0]
        else:
            logits = llama_prefill_chunk(params, cfg, ctokens, cpositions,
                                         self.k_cache, self.v_cache, slots,
                                         project_last)[0]
        last = lengths.long() - 1
        in_chunk = (last >= start) & (last < start + chunk)
        selected.copy_(torch.where(in_chunk[:, None], logits, selected))

    def _chunk_fn(self, selected, first: bool, final: bool, ctokens,
                  cpositions, start, slots, lengths, new_temps):
        """One dense chunk dispatch (the reference's ``_chunk_fn``, with
        ``_chunk_fn_q8`` as its int8 branch): the chunk's forward against
        the live cache rows; the first chunk PARKS the reserved rows'
        positions at the cache's last column, so decode blocks between
        chunks write their lock-step junk there and never inside the
        prompt; the final one samples the first tokens from `selected` and
        splices the loop state. Returns the [K] first tokens (final) or
        `selected`."""
        self._chunk_forward(selected, ctokens, cpositions, start, slots,
                            lengths)
        if first:
            self._positions.index_fill_(0, slots, self._cache_len - 1)
        if not final:
            return selected
        return self._splice_loop_state(selected, slots, lengths, new_temps)

    def _chunk_program(self, chunk: int, K: int, first: bool, final: bool,
                       slots: Optional[Sequence[int]] = None):
        """The dense chunk program (the reference's ``_chunk_program``):
        ``llama-chunk[-q8]-{chunk}x{K}[-first][-final]-S{len}``, one graph
        per variant and cache length on the card. Static inputs:
        _chunk_specs; the carried `selected` is _chunk_state's. slots: the
        job's rows, which the warm-up writes (at the parked column)."""
        key = self._chunk_key(0, K)
        inputs = self._static_inputs(key, self._chunk_specs(K, []))
        (selected,) = self._chunk_state(key)
        kind = "-q8" if self._q8 else ""
        tag = (f"{'-first' if first else ''}{'-final' if final else ''}"
               f"-S{self._cache_len}{self._id_tag}")
        return self.executor.compile(
            f"llama-chunk{kind}-{chunk}x{K}{tag}",
            lambda *a: self._chunk_fn(selected, first, final, *a), inputs,
            warmup=lambda: self._warmup_state(
                lambda: self._harmless_chunk(inputs, slots,
                                             self._cache_len - 1),
                self._chunk_live_state(key)),
            generators=(self.generator,))

    def _chunk_program_of(self, job: dict, first: bool, final: bool):
        """The program of a job's next chunk."""
        if job["bucket"] + 1 > self._cache_len:
            self._grow_cache(job["bucket"] + 1)
        return self._chunk_program(job["chunk"], len(job["batch"]), first,
                                   final, job["slots_idx"])

    def _start_chunk_job(self, bucket: int, slots_idx: List[int],
                         batch: List[GenerationRequest]) -> None:
        """Admit a wave in chunks (the reference's ``_start_chunk_job``):
        its first chunk is dispatched now (its parking lands before any
        later decode block), its slots are reserved and the job queued;
        _advance_chunk_job runs the rest, one chunk per loop iteration. A
        host-side failure before the first launch fails this wave only; a
        failed launch raises CacheLostError (the loop resets)."""
        ptokens, lengths, temps = self._prep_admission(bucket, batch)
        job = {"batch": batch, "slots_idx": slots_idx, "bucket": bucket,
               "chunk": self.chunk_prefill_tokens, "next_start": 0,
               "ptokens": ptokens, "lengths": lengths, "new_temps": temps,
               "key": self._chunk_key(bucket, len(batch)),
               "extra": self._chunk_extra(bucket, batch)}
        try:
            self._dispatch_chunk(job)
        except CacheLostError:
            self._release_chunk_state(job)
            raise
        except Exception as exc:  # noqa: BLE001 - fail the wave, keep serving
            self.logger.errorf("chunked admission of %d failed: %s",
                               len(batch), exc)
            self._release_chunk_state(job)
            for request in batch:
                self._abort_admission(request)
                self._fail_request(request, exc)
            return
        now = time.monotonic()
        for row, request in enumerate(batch):
            request.admitted_at = now
            self._obs.hist("app_tpu_queue_wait_seconds",
                           now - request.enqueued_at)
            self.slots[slots_idx[row]].chunking = request
            if self.recorder is not None and self._records_chunks:
                self.recorder.record_admitted(request, slots_idx[row],
                                              bucket, chunked=True)
        self.chunk_jobs += 1
        self._chunk_jobs.append(job)

    def _chunk_extra(self, bucket: int, batch: List[GenerationRequest]
                     ) -> tuple:
        """The host arrays a job's chunks upload between positions and
        start: none on the dense engine (the paged one: its page table)."""
        return ()

    def _advance_chunk_job(self) -> None:
        """Dispatch ONE chunk of the oldest job (decode blocks fill the
        pipeline between calls, which is the point); a job whose requests
        were all cancelled is dropped. A failure raises out of the step
        with the job still queued: the reset replays its requests."""
        if not self._chunk_jobs:
            return
        job = self._chunk_jobs[0]
        if all(self._is_cancelled(r) for r in job["batch"]):
            self._chunk_jobs.popleft()
            self._abort_chunk_job(job, None)
            return
        final = self._dispatch_chunk(job)
        if final:
            self._chunk_jobs.popleft()
            self._finish_chunk_job(job)

    def _swap_chunk_state(self, job: dict) -> None:
        """Put `job`'s carried state in its programs' buffers: the state of
        another live job of the same shape is copied out first (into
        tensors it then owns), and this job's copied in if it was swapped
        out before; both copies are enqueued on the engine's stream."""
        key = job["key"]
        bufs = self._chunk_state(key)
        resident = self._chunk_resident.get(key)
        if resident is job:
            return
        nbytes = sum(b.numel() * b.element_size() for b in bufs)
        if resident is not None:
            resident["saved"] = [b.clone() for b in bufs]
            self.chunk_swaps += 1
            self.chunk_swap_bytes += nbytes
        saved = job.pop("saved", None)
        if saved is not None:
            for b, s in zip(bufs, saved):
                b.copy_(s)
            self.chunk_swaps += 1
            self.chunk_swap_bytes += nbytes
        self._chunk_resident[key] = job

    def _release_chunk_state(self, job: dict) -> None:
        if self._chunk_resident.get(job["key"]) is job:
            del self._chunk_resident[job["key"]]

    def _dispatch_chunk(self, job: dict) -> bool:
        """Run the job's next chunk program; True when it was the final
        chunk (job["first_tok"] then holds the [K] first tokens on the
        device)."""
        batch, chunk, start = job["batch"], job["chunk"], job["next_start"]
        K = len(batch)
        final = start + chunk >= job["bucket"]
        program = self._chunk_program_of(job, start == 0, final)
        self._swap_chunk_state(job)
        positions = np.tile(np.arange(start, start + chunk, dtype=np.int64),
                            (K, 1))
        self.steps.note_dispatch("chunk")
        out = self._call(program, (
            job["ptokens"][:, start:start + chunk], positions, *job["extra"],
            np.asarray([start], dtype=np.int64),
            np.asarray(job["slots_idx"], np.int64), job["lengths"],
            job["new_temps"]), "engine.chunk")
        self.chunk_dispatches += 1
        job["next_start"] = start + chunk
        if self.recorder is not None and self._records_chunks:
            for request in batch:
                self.recorder.record_event(request.id, "prefill_chunk",
                                           start=start, final=final)
        if final:
            # the final chunk writes these rows' controls before any block
            # dispatched after it reads them
            self._filter_rows.update(
                slot for slot, r in zip(job["slots_idx"], batch)
                if r.top_p or r.top_k)
            job["first_tok"] = out
        return final

    def _finish_chunk_job(self, job: dict) -> None:
        """Bind a job's slots after its final chunk, as an admission wave's
        are at dispatch; the first tokens are emitted at its sync."""
        self._release_chunk_state(job)
        for slot_idx in job["slots_idx"]:
            self.slots[slot_idx].chunking = None
        self._assign_pages(job["slots_idx"], job["batch"])
        self._bind_slots(job["slots_idx"], job["batch"], job["first_tok"],
                         job["bucket"], chunked=True)

    def _abort_chunk_job(self, job: dict,
                         exc: Optional[BaseException]) -> None:
        """Unreserve a job's slots and fail its requests (releasing what
        their admission reserved)."""
        self._release_chunk_state(job)
        for slot_idx in job["slots_idx"]:
            self.slots[slot_idx].chunking = None
        for request in job["batch"]:
            self._abort_admission(request)
            self._fail_request(request, exc)

    # -- host <-> device ------------------------------------------------------
    def _stream_ctx(self):
        """The engine's stream as the current one (a no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _static_inputs(self, key: tuple, specs) -> Tuple[torch.Tensor, ...]:
        """The static input buffers of the programs keyed `key`, made zeroed
        at first use and kept for the engine's life (a captured graph reads
        their addresses): one typed view per (shape, dtype) of `specs` into
        one device block, each 16-byte aligned, so that _upload fills them
        all with one copy."""
        inputs = self._static.get(key)
        if inputs is None:
            sizes = [_aligned(math.prod(shape) * dtype.itemsize)
                     for shape, dtype in specs]
            block = torch.zeros(sum(sizes), dtype=torch.uint8,
                                device=self.device)
            views, offset = [], 0
            for (shape, dtype), size in zip(specs, sizes):
                n = math.prod(shape) * dtype.itemsize
                views.append(block[offset:offset + n].view(dtype).view(shape))
                offset += size
            inputs = self._static[key] = tuple(views)
            self._blocks[block.data_ptr()] = block
        return inputs

    def _staging_bytes(self) -> int:
        """The widest static block: a [n_slots, largest bucket] wave's
        tokens (a chunk's tokens and positions are no more), its rows and
        prefix lengths, two of the widest tables (a wave's page table and a
        tail wave's), and a verify's drafts."""
        B = self.n_slots
        T = max(self.prefill_buckets, default=16)
        return (_aligned(B * T * 8) + 5 * _aligned(B * 8)
                + 2 * _aligned(B * self._widest_table() * 4)
                + _aligned(B * self.speculative_tokens * 8))

    def _widest_table(self) -> int:
        """The widest page table a program takes (none on the dense
        engine)."""
        return 0

    def _upload(self, inputs: Sequence[torch.Tensor],
                arrays: Sequence[np.ndarray]) -> None:
        """Enqueue the fill of a program's static `inputs` (views made by
        _static_inputs) from the host `arrays`, in order. On the card the
        arrays are staged at the inputs' offsets in the next pinned buffer
        of a ring of pipeline_depth + 1, and the block is copied in one
        non_blocking copy on the engine's stream, with the buffer's event
        recorded behind it; a buffer is refilled only once its event has
        passed, which holds the host back only while more than
        pipeline_depth + 1 uploads wait on the card. On the CPU each input
        is filled by copy_."""
        if self._stream is None:
            for dst, array in zip(inputs, arrays):
                dst.copy_(torch.from_numpy(array))
            return
        if not self._ring:
            self._ring = [(torch.empty(self._staging_bytes(),
                                       dtype=torch.uint8, pin_memory=True),
                           torch.cuda.Event())
                          for _ in range(self.pipeline_depth + 1)]
        buf, done = self._ring[self._ring_next]
        self._ring_next = (self._ring_next + 1) % len(self._ring)
        done.synchronize()
        # the block the views share starts where the first one does
        block = self._blocks[inputs[0].data_ptr()]
        base = block.data_ptr()
        for dst, array in zip(inputs, arrays):
            offset = dst.data_ptr() - base
            staged = buf[offset:offset + dst.numel() * dst.element_size()]
            staged.view(dst.dtype).view(dst.shape).numpy()[...] = array
        block.copy_(buf[:block.numel()], non_blocking=True)
        done.record(self._stream)

    def _call(self, program, arrays: Sequence[np.ndarray],
              site: Optional[str] = None) -> torch.Tensor:
        """Fill `program`'s static inputs from host `arrays` and run it;
        returns its output, which its next call overwrites (_bind_slots and
        _dispatch_decode start its copy out before anything else is
        dispatched). The step ledger's dispatch. site: the fault plane's
        site of this dispatch (engine.prefill, ...). A failed upload or
        launch raises CacheLostError."""
        with self.steps.seg("dispatch"):
            try:
                if site is not None and self.faults is not None:
                    self.faults.hit(site)
                self._upload(program.inputs, arrays)
                return program()
            except Exception as exc:
                raise CacheLostError(
                    f"{(site or program.name).rpartition('.')[2]} dispatch "
                    f"failed: {exc}") from exc

    def _start_d2h(self, out: torch.Tensor):
        """Start a dispatch output's copy to the host at enqueue time (the
        reference's ``_start_d2h``): into a pinned buffer, non_blocking,
        with an event recorded behind it, so the sync is a completion check.
        With async_d2h=False the copy is made at sync, from a device clone
        taken now: a program's output is overwritten by its next call. On
        the CPU the output is cloned now, for the same reason. Returns what
        ``_fetch_host`` takes."""
        if self._stream is None or not self.async_d2h:
            return out.clone()
        # the widest output: a decode block, or a verify's [B, d+1] tokens
        # and its emit counts
        width = max(self.decode_block_size, self.speculative_tokens + 2)
        buf = (self._host_free.pop() if self._host_free else torch.empty(
            self.n_slots * width, dtype=torch.long, pin_memory=True))
        host = buf[:out.numel()].view(out.shape)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self._stream)
        return buf, host, done

    def _fetch_host(self, fetch) -> np.ndarray:
        """The dispatch output behind `fetch` as a numpy array, waiting for
        the device where it has to."""
        if isinstance(fetch, tuple):
            buf, host, done = fetch
            done.synchronize()
            out = host.numpy().copy()
            self._host_free.append(buf)
            return out
        return fetch.cpu().numpy()

    def _pull_host(self, *tensors: torch.Tensor) -> List[np.ndarray]:
        """Copy device tensors (gathers of the pools: a spill, an export, a
        hand-off) to the host as numpy, bf16 as its uint16 patterns
        (tpu/kvtier.py). On the card each copy is enqueued on the ENGINE's
        stream, behind every dispatch that wrote the pages, into pinned
        memory, and waited for by an event: never ``_fetch_host``'s
        ``.cpu()``, which would run on whatever stream is current."""
        if self._stream is None:
            return [_np_plane(t) for t in tensors]
        with self._stream_ctx():
            hosts = []
            for t in tensors:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                hosts.append(host)
            done = torch.cuda.Event()
            done.record(self._stream)
        done.synchronize()
        return [_np_plane(h) for h in hosts]

    def _h2d(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Host arrays (bf16 as uint16 patterns) as device tensors, copied
        on the engine's stream from pinned staging that is kept until the
        copies are done (``_keep_staging``)."""
        hosts = [_torch_plane(a) for a in arrays]
        if self._stream is None:
            return [h.clone() for h in hosts]
        hosts = [h.pin_memory() for h in hosts]
        with self._stream_ctx():
            devs = [h.to(self.device, non_blocking=True) for h in hosts]
        self._keep_staging(*hosts)
        return devs

    def _keep_staging(self, *hosts: torch.Tensor) -> None:
        """Hold pinned staging until the engine's stream has passed the
        copies enqueued from it (an event per call), dropping the
        landings whose events have completed."""
        while self._landings and self._landings[0][0].query():
            self._landings.popleft()
        done = torch.cuda.Event()
        done.record(self._stream)
        self._landings.append((done, hosts))

    # -- dispatch -------------------------------------------------------------
    def _dispatch_prefill(self, bucket: int, slots_idx: List[int],
                          batch: List[GenerationRequest]) -> torch.Tensor:
        """One fused admission wave through its program; returns its [K]
        first tokens on the device."""
        if bucket + 1 > self._cache_len:   # prompts must land inside the cache
            self._grow_cache(bucket + 1)
        program = self._prefill_program(bucket, len(batch), slots_idx)
        ptokens, lengths, temps = self._prep_admission(bucket, batch)
        return self._call(program, (ptokens, np.asarray(slots_idx, np.int64),
                                    lengths, temps), "engine.prefill")

    def _run_decode(self, block: int) -> torch.Tensor:
        """Dispatch one `block`-step decode program over the dense caches
        (grown first to what the active rows need); returns its [B, block]
        output on the device."""
        need = self._decode_need()
        if need > self._cache_len:
            self._grow_cache(need)
        program = self._decode_program(block, self._row_filter_now())
        with self.steps.seg("dispatch"):
            try:
                if self.faults is not None:
                    self.faults.hit("engine.decode")
                return program()
            except Exception as exc:
                raise CacheLostError(f"decode dispatch failed: {exc}") \
                    from exc

    def _admission_ready(self, request: GenerationRequest) -> bool:
        return True

    def _admission_bucket(self, request: GenerationRequest) -> int:
        """The prefill bucket a request admits under: its resume_tokens'
        (the prompt, plus the delivered tokens on a replay). The paged
        engine overrides it to the un-cached tail's bucket on a prefix
        hit."""
        return next_bucket(len(request.resume_tokens), self.prefill_buckets)

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

    @property
    def stall_seconds(self) -> float:
        """Seconds the loop thread has been stuck inside ONE device call,
        0.0 when healthy or not running. Host-side only: reading it never
        touches the device. An idle engine parks in 50 ms waits, so the
        stamp stops moving only while a dispatch or sync is blocked."""
        if self._thread is None or not self._thread.is_alive():
            return 0.0
        return max(0.0, time.monotonic() - self._last_step_at)

    def _stall_over_threshold(self) -> float:
        """The shed policy, read once: 0.0 when healthy, else the stall age
        that tripped it (the 503 and the health report carry the same
        reading). Multi-controller loops (an admission plane) are exempt, as
        in the reference: they legitimately block in collectives and wave
        waits for peer ranks, which host-side stall age cannot tell from a
        dead card."""
        if self._plane is not None:
            return 0.0
        stall = self.stall_seconds
        return stall if stall > self.STALL_REJECT_S else 0.0

    def wedged(self) -> bool:
        return self._stall_over_threshold() > 0.0

    def health_check(self) -> Health:
        """The container's health contributor: UP while the loop runs,
        DEGRADED with ``stall_seconds`` once it stalls past STALL_REJECT_S
        (already-dispatched work could still complete, and a load balancer
        should stop routing here either way), DOWN when the loop is not
        running or the reset-storm breaker is open or half-open (with its
        snapshot: the probe, not routed traffic, decides recovery)."""
        details = {"active_slots": sum(1 for s in self.slots if s.active),
                   "queue_depth": self.queue_depth()}
        if self._thread is None or not self._thread.is_alive():
            return Health(status=STATUS_DOWN, details=details)
        if self.breaker.blocked():
            details["breaker"] = self.breaker.snapshot()
            return Health(status=STATUS_DOWN, details=details)
        stall = self._stall_over_threshold()
        if stall:
            details["stall_seconds"] = round(stall, 1)
            return Health(status=STATUS_DEGRADED, details=details)
        return Health(status=STATUS_UP, details=details)

    def submit(self, prompt_tokens: Sequence[int], max_new_tokens: int = 128,
               temperature: float = 0.0,
               stop_tokens: Optional[Set[int]] = None, priority: int = 0,
               min_tokens: int = 0, top_p: float = 0.0,
               top_k: int = 0, span=None,
               traceparent: Optional[str] = None,
               qos_class: Optional[str] = None,
               tenant: str = "") -> GenerationRequest:
        """priority: LOWER admits first when slots are contended (ties stay
        FIFO); running generations are never preempted, except batch-class
        ones under the QoS ladder, which resume through the replay
        contract. min_tokens: stop tokens are ignored until this many
        tokens have been emitted. top_p/top_k truncate the sampled
        distribution per request (0 = off) — only on engines built with
        sampling_controls=True. span / traceparent: the caller's span, or
        its raw W3C header, that the request's tpu.generate span parents
        under (a new trace without either). qos_class: 'interactive',
        'standard' or 'batch' (tpu/qos.py) bands the priority and subjects
        the request to its class's quotas and deadline; None keeps the
        unclassified behaviour; an unknown class raises UnknownClassError
        (a ValueError, the servers' 400) even with no controller. tenant:
        the accounting tenant (the capacity meter, /debug/qos). As in the
        reference, max_new_tokens below 1 still emits the first token."""
        qos_class = qos.normalize_class(qos_class)
        self._admit_gate(prompt_tokens, top_p, top_k)
        limit = self.admission_limit
        if len(prompt_tokens) > limit:
            raise ValueError(f"prompt of {len(prompt_tokens)} tokens exceeds the "
                             f"admission limit ({limit})")
        if self.qos is not None:
            # the ladder's door (shed_standard sheds standard with 503 +
            # Retry-After), then the class's band
            self.qos.check_submit(qos_class, tenant)
            priority = qos.banded_priority(qos_class, priority)
        request = GenerationRequest(prompt_tokens, max_new_tokens, temperature,
                                    stop_tokens, priority=priority,
                                    min_tokens=min_tokens, top_p=top_p,
                                    top_k=top_k, span=span,
                                    traceparent=traceparent,
                                    qos_class=qos_class, tenant=tenant)
        self._open_span(request, span, traceparent)
        self._obs.counter("app_tpu_requests_total")
        if self.qos is not None:
            self.qos.note_submitted(request)
        if self.meter is not None:
            # the forecaster's arrival stamp (thread-safe, best-effort)
            self.meter.note_arrival(request)
        return self._enqueue(request)

    def _admit_gate(self, prompt_tokens: Sequence[int], top_p: float,
                    top_k: int) -> None:
        """The door that submit and submit_handoff both pass: the stopped,
        draining, stall and breaker sheds, then the request's own checks.
        Every prompt id must lie in the vocabulary: an id past it reaches
        the embedding gather on the card, where it fires a device-side
        assert that loses the CUDA context for good (JAX clamps the
        gather, so the reference never needed this check)."""
        if self._stop.is_set():
            raise RuntimeError("engine is stopped")
        if self._draining:
            raise EngineDrainingError()
        stall = self._stall_over_threshold()
        if stall:
            if self.recorder is not None:
                self.recorder.record_engine_event("stall_shed",
                                                  stall_s=round(stall, 1))
            raise EngineStalledError(stall)
        retry_after = self.breaker.reject_for()
        if retry_after is not None:
            if self.recorder is not None:
                self.recorder.record_engine_event(
                    "breaker_shed", state=self.breaker.state)
            raise DeviceLostError(retry_after)
        if self._plane is not None and not self._plane.is_leader:
            # multi-controller serving has ONE ingress: rank 0 composes
            # every admission wave; this rank only replays them
            raise RuntimeError(
                "this rank mirrors admission waves from the leader; "
                "submit on process 0")
        if not prompt_tokens:
            raise ValueError("prompt_tokens must be non-empty")
        self._check_token_ids(prompt_tokens, "prompt_tokens")
        if (top_p or top_k) and not self.sampling_controls:
            raise ValueError("per-request top_p/top_k need an engine built "
                             "with sampling_controls=True")
        if not 0.0 <= top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {top_p}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")

    def _check_token_ids(self, ids: Sequence[int], what: str) -> None:
        """ValueError (the servers' 400) unless every id is an integer in
        [0, vocab_size)."""
        vocab = self.cfg.vocab_size
        try:
            bad = [t for t in ids if not 0 <= operator.index(t) < vocab]
        except TypeError as exc:
            raise ValueError(f"{what} must be integer token ids") from exc
        if bad:
            raise ValueError(f"{what} holds token id {bad[0]} outside the "
                             f"vocabulary [0, {vocab})")

    def _open_span(self, request: GenerationRequest, span,
                   traceparent: Optional[str]) -> None:
        if self.tracer is not None:
            request.gen_span = self.tracer.start_span(
                "tpu.generate", parent=span, traceparent=traceparent)
            request.gen_span.set_attribute("tpu.prompt_tokens",
                                           len(request.prompt_tokens))
        if self.recorder is not None:   # after gen_span: it carries the
            self.recorder.record_enqueued(request)   # inbound trace ids

    def _enqueue(self, request: GenerationRequest) -> GenerationRequest:
        self._pending.put((request.priority, request.id, request))
        if self._stop.is_set():
            # stop() may have drained _pending between the gate and the
            # put; drain again so this request cannot strand its client
            self._drain_pending(RuntimeError("engine stopped"))
            raise RuntimeError("engine is stopped")
        self._obs.gauge("app_tpu_queue_depth", self.queue_depth())
        self._wake.set()
        return request

    def generate(self, prompt_tokens: Sequence[int], **kw) -> List[int]:
        return self.submit(prompt_tokens, **kw).result()

    def submit_handoff(self, prompt_tokens: Sequence[int],
                       emitted: Sequence[int], *,
                       max_new_tokens: int = 128, temperature: float = 0.0,
                       stop_tokens: Optional[Set[int]] = None,
                       priority: int = 0, min_tokens: int = 0,
                       top_p: float = 0.0, top_k: int = 0,
                       traceparent: Optional[str] = None,
                       out_queue=None, cancelled=None,
                       blobs=None, qos_class: Optional[str] = None,
                       tenant: str = "") -> GenerationRequest:
        """Admit a generation whose prefill (and first token) ran on another
        engine: the decode half of disaggregated serving and the landing of
        a migration, on the replay contract (the request admits at prompt +
        emitted with its remaining budget; nothing delivered is emitted
        again). blobs (one kvtier.PageBlob per page of the resume window
        but its last token, paged engines outside the prefill role) skip
        the prefill: admission checks them against this pool and lands the
        KV under the ``kv_handoff`` segment, and the slot binds straight
        into decode. blobs=None recomputes the resume window (a replay).
        out_queue / cancelled: the client-facing request's, so the stream
        continues across the hop; traceparent keeps one trace. The emitted ids, the stop set and
        the temperature are checked too: a migration's spec arrives raw
        from the network (POST /migrate)."""
        self._admit_gate(prompt_tokens, top_p, top_k)
        if blobs is not None and not self._lands_handoffs:
            raise ValueError("KV blobs require a paged engine outside the "
                             "prefill role")
        emitted = list(emitted)
        self._check_token_ids(emitted, "emitted")
        stop_tokens = set(stop_tokens or ())
        self._check_token_ids(stop_tokens, "stop_tokens")
        if not 0.0 <= temperature < math.inf:
            raise ValueError(f"temperature must be finite and >= 0, got "
                             f"{temperature}")
        if max_new_tokens - len(emitted) <= 0:
            raise ValueError("hand-off carries no remaining budget; the "
                             "prefill pool should have finished it")
        if len(prompt_tokens) + len(emitted) > self.admission_limit:
            raise ValueError(
                f"resume window of {len(prompt_tokens) + len(emitted)} "
                f"tokens exceeds the admission limit "
                f"({self.admission_limit})")
        # a hand-off outranks queued arrivals (LOWER admits first) as a
        # replay does: its client is mid-stream. The class and tenant ride
        # along for accounting, not banding
        request = GenerationRequest(prompt_tokens, max_new_tokens,
                                    temperature, stop_tokens,
                                    priority=min(int(priority), -1),
                                    min_tokens=min_tokens, top_p=top_p,
                                    top_k=top_k, traceparent=traceparent,
                                    qos_class=qos.normalize_class(qos_class),
                                    tenant=tenant)
        request.disagg_handoff = True
        request.handoff_blobs = blobs
        request.generated = len(emitted)
        request.emitted = emitted
        if emitted:
            # the client saw its first token on the other engine: TTFT
            # stays single-counted, decode TPOT anchors at the receipt
            request.first_token_at = request.enqueued_at
        if out_queue is not None:
            request.out_queue = out_queue
        if cancelled is not None:
            request.cancelled = cancelled
        self._open_span(request, None, traceparent)
        if request.gen_span is not None:
            request.gen_span.set_attribute("disagg.handoff", True)
        if self.recorder is not None:
            self.recorder.record_event(
                request.id, "handoff_received",
                pages=len(blobs) if blobs else 0,
                resume_tokens=len(request.resume_tokens))
        return self._enqueue(request)

    @property
    def _lands_handoffs(self) -> bool:
        """Whether admission can land shipped KV page blobs: the paged pool
        outside the prefill role (a decode pool lands hand-offs, any
        colocated paged replica lands migrations)."""
        return self.supports_kv_handoff and self.disagg_role != "prefill"

    def request_migration(self, sink) -> None:
        """Ask the loop to export every live decode session to ``sink``
        (drain with migration, tpu/migrate.py). Thread-safe; returns at
        once. The loop stops dispatching decode, waits for the dispatches
        in flight to sync (pipeline_depth of them at most), then calls
        ``sink(request, blobs, n_ctx)`` once per active slot at that
        quiesced boundary: True means the sink took the stream (the slot
        evacuates, nothing more is emitted here); False or a raise leaves
        the slot decoding here. One-shot: slots admitted after the round
        are not offered. Single-controller only, as in the reference."""
        if self._plane is not None:
            raise RuntimeError("migration is single-controller only; the "
                               "multi-host admission plane cannot mirror "
                               "slot evacuations")
        self._migrate_sink = sink
        self._migrate_request = True
        self._wake.set()

    @property
    def migration_pending(self) -> bool:
        """True while a requested export round has not run yet."""
        return self._migrate_request

    @loop_only
    def _migrate_active_slots(self) -> None:
        """One migration round at a quiesced boundary (loop thread, nothing
        in flight, so each slot's length and its request's resume window
        agree and the export is exact). Export order is slot order; a
        session the sink takes is evacuated with the preemption primitive
        (the request and its client stream live on, owned by the sink).
        _migrate_request clears at the END of the round: the coordinator
        polls it to know every sink call has happened."""
        sink, self._migrate_sink = self._migrate_sink, None
        if sink is None:
            self._migrate_request = False
            return
        try:
            for slot in self.slots:
                if not slot.active or slot.chunking is not None:
                    continue
                request = slot.request
                if self._is_cancelled(request):
                    continue   # the cancel teardown owns it
                if request.max_new_tokens - request.generated <= 0:
                    continue   # finishing this step
                blobs, n_ctx = self._export_slot_kv(slot, request)
                try:
                    took = bool(sink(request, blobs, n_ctx))
                except Exception as exc:  # noqa: BLE001 - a broken sink must not kill serving
                    self.logger.errorf("migration sink failed for %s: %s",
                                       request.id, exc)
                    took = False
                if not took:
                    continue   # the slot stays: local decode is the floor
                self._release_slot_for_preempt(slot)
                request.finished_at = time.monotonic()
                self.migrations_total += 1
                self._obs.counter("app_tpu_elastic_migrations_total",
                                  phase="export")
                if request.gen_span is not None:
                    request.gen_span.set_attribute("elastic.migrated", True)
                    request.gen_span.set_attribute(
                        "elastic.pages", len(blobs) if blobs else 0)
                    request.gen_span.end()
                    request.gen_span = None
                if self.recorder is not None:
                    self.recorder.record_event(
                        request.id, "migrated",
                        pages=len(blobs) if blobs else 0,
                        emitted=len(request.emitted))
                    self.recorder.record_finished(request, "migrated")
        finally:
            self._migrate_request = False
        self._obs.gauge("app_tpu_active_slots",
                        sum(1 for s in self.slots if s.active))

    def _export_slot_kv(self, slot: _Slot, request: GenerationRequest):
        """(blobs, n_ctx) of a migration export. The dense engine ships no
        KV: blobs=None and the peer replays prompt + emitted (the crash-only
        recompute contract). The paged engine pulls its pages."""
        return None, max(0, len(request.resume_tokens) - 1)

    def _admit_handoff(self, batch: List[GenerationRequest], free_iter,
                       dispatched: Set[int]) -> None:
        """The paged engine lands page blobs; submit_handoff refuses blobs
        anywhere else."""
        raise NotImplementedError(
            "page-blob hand-off admission needs the paged engine")

    def _handoff_slot(self, slot: _Slot, request: GenerationRequest) -> None:
        """The paged engine's prefill-role export (the constructor keeps the
        role to paged engines)."""
        raise NotImplementedError(
            "page-blob KV export needs the paged engine")

    @loop_only
    def _handoff_fallback(self, request: GenerationRequest,
                          reason: str) -> None:
        """A hand-off this pool cannot land (page count, shape, content, a
        failed landing) degrades to a recompute, never a failed stream: the
        blobs and the reservation go, the request is parked again and the
        next admission round prefills its resume window as a replay's.
        Counted in ``app_tpu_disagg_fallback_total{reason}``."""
        self._abort_admission(request)
        request.handoff_blobs = None
        self.handoff_fallbacks_total += 1
        self._obs.counter("app_tpu_disagg_fallback_total", reason=reason)
        if self.recorder is not None:
            self.recorder.record_event(request.id, "disagg_fallback",
                                       reason=reason)
        heapq.heappush(self._admission_heap,
                       (request.priority, request.id, request))

    def _decode_wanted(self) -> bool:
        """Whether the loop should dispatch decode (or a verify) now: some
        slot is active, no migration round is pending (the pipeline must
        drain to the quiesced boundary), and on a prefill pool the slot has
        no prefill in flight (it evacuates at that sync, so decode behind
        it would be junk; only a slot whose export failed decodes here)."""
        if self._migrate_request:
            return False
        if self.disagg_role == "prefill":
            pending = {i for e in self._inflight if e[0] == "prefill"
                       for i, _ in e[2]}
            return any(slot.active and i not in pending
                       for i, slot in enumerate(self.slots))
        return any(slot.active for slot in self.slots)

    def score(self, prompt_tokens: Sequence[int],
              completion_tokens: Sequence[int], top: int = 5):
        """Teacher-forced per-token logprobs for a completion (the OpenAI
        `logprobs` feature): (chosen_lp [C], top_ids [C, top], top_lps [C,
        top]) numpy arrays. A post-hoc pass beside serving; see
        tpu/score.py."""
        from .score import score_tokens

        self._single_controller("scoring")
        return score_tokens(self, prompt_tokens, completion_tokens, top=top)

    def embed(self, tokens: Sequence[int], normalize: bool = True):
        """The last position's final-norm hidden state as a sequence
        embedding (float32 [D], L2-normalized by default); see
        tpu/score.py."""
        from .score import embed_tokens

        self._single_controller("embedding")
        return embed_tokens(self, tokens, normalize=normalize)

    def warmup_scoring(self, embeddings: bool = True) -> int:
        """Capture the scoring (and embedding) window programs, one per
        bucket and family, so no client request waits for a capture.
        Returns the passes run. Called before start(), it sets
        score_pool_bytes, the card memory they reserved."""
        from .score import warmup_post_hoc

        self._single_controller("scoring")
        idle = self._thread is None
        before = self._reserved() if idle else 0
        ran = warmup_post_hoc(self, embeddings=embeddings)
        if idle:
            self.score_pool_bytes = self._reserved() - before
        return ran

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._draining = False   # a drained engine may be restarted
        if self.lifecycle.state == "draining":
            self.lifecycle = Lifecycle("serving")   # a fresh boot
        self._last_step_at = time.monotonic()
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
                self.logger.errorf("engine loop did not exit within %.0fs",
                                   self.STOP_JOIN_S)
                return
            self._thread = None
        if self._plane is not None:
            # leader: publish the stop sentinel AFTER the loop exits (no
            # further waves can race it) so parked followers unblock
            self._plane.close()
        self._drain_pending(RuntimeError("engine stopped"))
        if self._finisher is not None:
            # the loop is joined, so its last finish jobs are queued: run
            # them before returning (a wedged loop returned above and keeps
            # the finisher for itself)
            self._finisher.close()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown, phase 1: stop admitting (submit raises
        EngineDrainingError, and the loop thread fails the queued requests
        with it), and let the active generations run to completion, bounded
        by timeout_s. True when every one finished, False on timeout; call
        stop() either way, which fails whatever remains. Only sets the flag
        and waits: the queue is mutated by the loop thread alone. The
        lifecycle moves to ``draining``."""
        self._draining = True
        self.lifecycle.to("draining")
        self._wake.set()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._state_lock:
                busy = (any(s.active or s.chunking is not None
                            for s in self.slots)
                        or self._inflight or self._chunk_jobs
                        or self._admission_heap or self._pending.qsize())
            if not busy:
                return True
            time.sleep(0.05)
        return False

    # -- loop -----------------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            self._last_step_at = time.monotonic()
            synced = False
            try:
                synced = self._step()
            except Exception as exc:  # noqa: BLE001 - reset, keep serving
                # a step that died mid-flight must not feed the baselines
                self.steps.step_abort()
                # a failed launch or sync is the expected failure: its
                # message says where; anything else gets its traceback,
                # but a follower's stop at its leader's sentinel is the
                # normal end of its loop
                if type(exc).__name__ == "LeaderStoppedError":
                    self.logger.infof("engine loop stops: %s", exc)
                else:
                    self.logger.errorf("engine step failed: %s", exc
                                       if isinstance(exc, CacheLostError)
                                       else traceback.format_exc())
                self._reset_device_state(exc)
            # the step closed before this park: the wait is the next
            # step's idle_gap, not this one's wall
            if not synced and not self._inflight and not self._chunk_jobs:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
        # graceful shutdown: finish what was already dispatched, then fail
        # requests still mid-generation so no client blocks on result()
        with torch.no_grad(), self._stream_ctx():
            while self._inflight:
                try:
                    self._sync_oldest()
                except Exception as exc:  # noqa: BLE001
                    self.logger.errorf("engine sync failed at stop: %s",
                                       traceback.format_exc())
                    self._reset_device_state(exc)
        stop_exc = RuntimeError("engine stopped")
        while self._chunk_jobs:   # mid-prefill requests must not block
            self._abort_chunk_job(self._chunk_jobs.popleft(), stop_exc)
        for slot in self.slots:
            if slot.active:
                slot.request.error = stop_exc
                self._finish_slot(slot)

    def _step(self) -> bool:
        """One loop iteration in the reference's order: the breaker's
        half-open probe when its cooldown is over; the QoS ladder's action
        (_qos_actuate, segment ``qos``); admit; advance the
        oldest chunk job by one chunk; then, while speculation is not
        cooling off, one verify, only when no verify or decode is in flight
        (drafts come from host state that must not lag the device);
        otherwise decode blocks while fewer than pipeline_depth dispatches
        are in flight, each counting a cooloff down (its end raises the EMA
        to the probe value); sync the oldest dispatch. Returns whether it
        synced one. One step ledger record per call (the module
        docstring): its host time (everything before the sync) goes to the
        utilization ledger too."""
        steps = self.steps
        steps.step_start()
        host_t0 = time.monotonic()
        synced = False
        with torch.no_grad(), self._stream_ctx():
            if self.breaker.probe_due():
                self._breaker_probe()
            if self.qos is not None and self._plane is None:
                # the ladder acts before admission, so the slots a
                # preemption frees admit this round (single-controller
                # only: a rank-local preemption would fork the replay)
                with steps.seg("qos"):
                    self._qos_actuate()
            with steps.seg("admission"):
                self._admit()
            self._advance_chunk_job()
            if (self._migrate_request and not self._inflight
                    and not self._chunk_jobs):
                # quiesced: every dispatch synced, the export is exact
                with steps.seg("kv_handoff"), self._state_lock:
                    self._migrate_active_slots()
            if self.speculative_tokens and self._spec_cooloff <= 0:
                if (self._decode_wanted()
                        and not any(e[0] in ("verify", "decode")
                                    for e in self._inflight)):
                    self._dispatch_verify()
            else:
                while (len(self._inflight) < self.pipeline_depth
                       and self._decode_wanted()):
                    self._dispatch_decode()
                    if self._spec_cooloff > 0:
                        self._spec_cooloff -= 1
                        if self._spec_cooloff == 0:
                            self._spec_accept_ema = max(
                                self._spec_accept_ema, self.SPEC_PROBE_EMA)
                            break
            # scheduler, prep and enqueue time of this iteration (nothing
            # above waits on the card); sub-millisecond idle iterations are
            # noise, not overhead
            host_s = time.monotonic() - host_t0
            if host_s >= 1e-3:
                self.util.note_host(host_s)
            if self._inflight:
                with steps.seg("emit"):
                    self._sync_oldest()
                synced = True
        self._finish_step()
        return synced

    @loop_only
    def _note_compile(self, name: str, seconds: float) -> None:
        """The executor's cache-miss callback: re-attribute the capture's
        time out of the step segment it elapsed under. A capture on another
        thread (warm-up, the scoring passes) is ignored by the ledger's
        thread guard."""
        self.steps.note_stolen("compile", seconds)

    @loop_only
    def _finish_step(self) -> None:
        """Close the step ledger's record; charge the capacity meter with
        the batch this step synced (its measured device segments, so the
        attribution conserves against /debug/steps); a flagged straggler
        becomes a flight-recorder engine event carrying its dominant
        segment, and feeds the incident plane's streak count."""
        rec = self.steps.step_end(
            active_slots=sum(1 for s in self.slots if s.active),
            inflight=len(self._inflight), queue_depth=self.queue_depth())
        staged, self._meter_rows = self._meter_rows, None
        if self.meter is not None and staged is not None and rec is not None:
            phase, rows, queued = staged
            self.meter.account_step(rec, phase, rows, queued)
        if rec is not None and rec.straggler:
            if self.recorder is not None:
                self.recorder.record_engine_event(
                    "step_straggler", step=rec.seq, phase=rec.phase,
                    wall_s=round(rec.wall_s, 6), cause=rec.cause,
                    baseline_s=round(rec.baseline_s or 0.0, 6),
                    request_id=rec.slowest_request_id)
            if self.incidents is not None:
                # a streak of flagged steps, not one, is an incident
                self.incidents.note_straggler(
                    step=rec.seq, phase=rec.phase, cause=rec.cause,
                    wall_s=round(rec.wall_s, 6),
                    request_id=rec.slowest_request_id)

    def _is_cancelled(self, request: GenerationRequest) -> bool:
        """Cancellation as the dispatch path sees it: the live event, or,
        under an admission plane, membership in the plane's synced set (a
        cancel takes effect at the wave that broadcast it, on every rank at
        the same loop iteration)."""
        if self._plane is not None:
            return request.id in self._plane.synced_cancelled
        return request.cancelled.is_set()

    def _admit(self) -> None:
        """Fuse pending requests into batched prefill dispatches, one per
        (bucket, K) group, while free slots last; while draining, fail
        every queued request with EngineDrainingError instead. While the
        breaker is open or half-open nothing admits: queued and replayed
        requests stay parked until the probe closes it."""
        with self._state_lock:
            if self._draining and self._plane is None:
                self._drain_pending(EngineDrainingError())
                return
            if self._plane is None and self.breaker.blocked():
                return
            self._admit_locked()

    def _exchange_wave(self, free: List[int]) -> bool:
        """The admission plane's wave for this iteration (the reference's
        branch of ``_admit``): the leader publishes what it drained from
        its queue, with its cancels and its drain flag; a follower takes
        the same wave. The wave's entries, and only they, go into the
        admission heap. Returns False when this iteration admits nothing
        more (the drain landed)."""
        drained: List[tuple] = []
        while True:
            try:
                drained.append(self._pending.get_nowait())
            except queue.Empty:
                break
        if self._draining and drained:
            # a draining leader's local arrivals never enter a wave
            exc = EngineDrainingError()
            for _, _, request in drained:
                self._fail_request(request, exc)
            drained = []
        # has_work is computed from MIRRORED state only (it decides whether
        # a wave exists at all): work that can dispatch this iteration
        has_work = (any(s.active or s.chunking is not None
                        for s in self.slots)
                    or bool(self._inflight) or bool(self._chunk_jobs)
                    or (bool(self._admission_heap) and bool(free)))
        try:
            drained, drain_synced = self._plane.exchange(
                drained, has_work, draining=self._draining)
        except Exception as exc:
            # the popped arrivals are in no queue, heap or slot
            for _, _, request in drained:
                self._fail_request(request, exc)
            raise
        if self._plane.closed and not self._plane.is_leader:
            # the leader published its stop sentinel: no collective this
            # rank dispatches can complete again; stop at THIS iteration
            from .admission import LeaderStoppedError

            self._stop.set()
            raise LeaderStoppedError(
                "admission leader stopped; follower cannot make "
                "progress without its collective peer")
        if drain_synced:
            # the drain lands on every rank at THIS wave
            self._draining = True
            self._drain_pending(EngineDrainingError())
            return False
        for entry in drained:
            heapq.heappush(self._admission_heap, entry)
        return True

    def _admit_locked(self) -> None:
        free = [i for i, slot in enumerate(self.slots)
                if not slot.active and slot.chunking is None]
        if self._plane is not None:
            # the wave runs even with no free slot: cancels and the drain
            # ride waves, and a saturated server is where a cancel must
            # still free capacity
            if not self._exchange_wave(free) or not free:
                return
        elif not free:
            return
        else:
            while True:
                try:
                    heapq.heappush(self._admission_heap,
                                   self._pending.get_nowait())
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
            if self.qos is not None and self._plane is None:
                # the class gates (tpu/qos.py): an expired request fails
                # before it costs a prefill; a park keeps the heap's order,
                # as a page wait does
                decision = self.qos.admission_decision(request, self,
                                                       taken=len(taken))
                if decision == "expire":
                    self._expire(request)
                    continue
                if decision == "park" or self._in_flight(request):
                    heapq.heappush(self._admission_heap, entry)
                    break
            if not self._admission_ready(request):
                # parked on its resource: no same-priority request may
                # leapfrog it, so the round stops here
                heapq.heappush(self._admission_heap, entry)
                break
            taken.append(request)
        # a hand-off with page blobs skips the prefill: its KV lands under
        # kv_handoff and its slot binds straight into decode
        # (_admit_handoff); a fallback there parks it again blob-less, so a
        # later round admits it below as a recompute
        handed: List[GenerationRequest] = []
        if self._lands_handoffs:
            handed = [r for r in taken if r.handoff_blobs is not None]
            if handed:
                taken = [r for r in taken if r.handoff_blobs is None]
        if self.qos is not None:
            for request in itertools.chain(taken, handed):
                self.qos.note_admitted(request)
        # grouped by admission bucket: a prefix hit admits at its tail's
        by_bucket: Dict[int, List[GenerationRequest]] = {}
        for request in taken:
            by_bucket.setdefault(self._admission_bucket(request),
                                 []).append(request)
        free_iter = iter(free)
        dispatched: Set[int] = set()
        try:
            if handed:
                self._admit_handoff(handed, free_iter, dispatched)
            for bucket, group in by_bucket.items():
                offset = 0
                for K in _admission_split(len(group), self.n_slots):
                    batch = group[offset:offset + K]
                    offset += K
                    slots_idx = [next(free_iter) for _ in batch]
                    if self._chunked(bucket):
                        self._start_chunk_job(bucket, slots_idx, batch)
                    else:
                        self._prefill(bucket, slots_idx, batch)
                    dispatched.update(r.id for r in batch)
        except Exception as exc:
            # requests that reached no dispatch are in no queue and no
            # slot: fail them here (the dispatched ones hold slots and
            # replay through the reset), as the reference does
            for request in itertools.chain(taken, handed):
                if request.id not in dispatched:
                    self._abort_admission(request)
                    self._fail_request(request, exc)
            raise
        self._obs.gauge("app_tpu_queue_depth", self.queue_depth())
        self._obs.gauge("app_tpu_active_slots",
                        sum(1 for s in self.slots if s.active))

    def _prefill(self, bucket: int, slots_idx: List[int],
                 batch: List[GenerationRequest]) -> None:
        """One fused prefill dispatch: bind the slots and their pages now;
        the first tokens are emitted at its sync. A host-side failure
        before the launch (preparation, a capture) fails this wave only; a
        failed launch raises CacheLostError out of the step."""
        tail_only = self._tail_only(batch)
        self.steps.note_dispatch("prefill")
        try:
            first = self._dispatch_prefill(bucket, slots_idx, batch)
        except CacheLostError:
            raise   # device state suspect: the loop resets
        except Exception as exc:  # noqa: BLE001 - fail the wave, keep serving
            self.logger.errorf("prefill wave of %d failed pre-dispatch: %s",
                               len(batch), exc)
            for request in batch:
                self._abort_admission(request)
                self._fail_request(request, exc)
            return
        # the wave writes these rows' controls before any block dispatched
        # after it reads them
        self._filter_rows.update(slot for slot, r in zip(slots_idx, batch)
                                 if r.top_p or r.top_k)
        if tail_only:
            self.prefix_dispatches += 1
            self.prefix_shapes[(len(batch), bucket)] += 1
        else:
            self.prefill_dispatches += 1
            self.prefill_shapes[(len(batch), bucket)] += 1
        self._assign_pages(slots_idx, batch)
        self._bind_slots(slots_idx, batch, first, bucket)

    def _dispatch_span(self, name: str, batch_id: int, **attrs):
        """A span over one dispatch, ended at its sync (None without a
        tracer)."""
        if self.tracer is None:
            return None
        span = self.tracer.start_span(name)
        span.set_attribute("batch.id", batch_id)
        for key, value in attrs.items():
            span.set_attribute(key, value)
        return span

    def _bind_slots(self, slots_idx: List[int],
                    batch: List[GenerationRequest], first, bucket: int,
                    chunked: bool = False) -> None:
        """Bind a dispatched wave's rows to their slots (length: the
        window, prompt plus delivered tokens, whose KV the wave writes;
        remaining: the budget past the next token, so a replay resumes with
        what it has left) and queue it for sync, its D2H started. Records each row's
        queue wait (a chunk job's rows were stamped at their first chunk)
        and stamps the wave on the requests' spans."""
        fetch = self._start_d2h(first)
        batch_id = next(self._batch_seq)
        attrs = {"batch.size": len(batch), "tpu.prefill_bucket": bucket}
        if chunked:
            attrs["tpu.chunked"] = True
        dspan = self._dispatch_span("tpu.prefill", batch_id, **attrs)
        admitted = []
        now = time.monotonic()
        for row, request in enumerate(batch):
            if request.admitted_at is None:
                request.admitted_at = now
                self._obs.hist("app_tpu_queue_wait_seconds",
                               now - request.enqueued_at)
            slot = self.slots[slots_idx[row]]
            slot.request = request
            slot.length = len(request.resume_tokens)
            slot.remaining = request.max_new_tokens - request.generated - 1
            for span in (request.span, request.gen_span):
                if span is not None:
                    span.set_attribute("batch.id", batch_id)
                    span.set_attribute("tpu.slot", slots_idx[row])
                    span.set_attribute("tpu.prefill_bucket", bucket)
            if self.recorder is not None:
                self.recorder.record_admitted(request, slots_idx[row],
                                              bucket, batch_id=batch_id)
            admitted.append((slots_idx[row], request))
        if self.speculative_tokens and self._spec_cooloff > 0:
            # fresh traffic probes at once: the cold streak belonged to
            # other requests, and a short request could otherwise finish
            # without speculation ever being tried
            self._spec_cooloff = 0
            self._spec_accept_ema = max(self._spec_accept_ema,
                                        self.SPEC_PROBE_EMA)
        self._push(("prefill", fetch, admitted, 1, now, dspan))

    def _push(self, entry) -> None:
        self._inflight.append(entry)
        self.max_inflight = max(self.max_inflight, len(self._inflight))

    def _assign_pages(self, slots_idx: List[int],
                      batch: List[GenerationRequest]) -> None:
        """Move each admitted request's admission reservation onto its
        slot."""

    def _decode_block_now(self) -> int:
        """Full blocks for decode throughput, half blocks while requests
        wait for admission, so their TTFT is not gated behind a full block."""
        # under a plane only the mirrored heap may pick the block: the
        # leader's local queue is invisible to the followers
        if self._admission_heap or (self._plane is None
                                    and self._pending.qsize()):
            return max(1, self.decode_block_size // 2)
        return self.decode_block_size

    def _dispatch_decode(self) -> None:
        """Dispatch one decode block over the active rows, its D2H started.
        A failure raises out of the step (the loop resets and replays)."""
        block = self._decode_block_now()
        snapshot = [(i, slot.request) for i, slot in enumerate(self.slots)
                    if slot.active]
        self.steps.note_dispatch("decode")
        started = time.monotonic()
        fetch = self._start_d2h(self._run_decode(block))
        self.decode_steps += block
        self.decode_blocks += 1
        dspan = self._dispatch_span("tpu.decode", next(self._batch_seq),
                                    **{"batch.size": len(snapshot),
                                       "tpu.block": block})
        self._push(("decode", fetch, snapshot, block, started, dspan))

    def _sync_oldest(self) -> None:
        """Wait for the oldest dispatch and deliver it: a prefill's first
        tokens, a decode block demuxed per row, or a verify's accepted
        tokens demuxed per row (then the acceptance EMA). Rows whose slot
        was freed or re-bound since the dispatch are skipped. The metrics
        of the sync are recorded here (the module docstring). A failed
        sync raises CacheLostError (the loop resets and replays)."""
        if self.faults is not None:
            # sync-site chaos: latency (delay rules) or a failure (raise)
            with self.steps.seg("device_sync"):
                self.faults.hit("engine.sync")
        kind, fetch, rows, block, *stamp = self._inflight.popleft()
        started, dspan = stamp if stamp else (None, None)
        sync_t0 = time.monotonic()
        try:
            with self.steps.seg("device_sync"):
                tokens_host = self._fetch_host(fetch)
        except Exception as exc:
            if dspan is not None:
                dspan.set_status(False, str(exc))
                dspan.end()
            raise CacheLostError(f"{kind} execution failed: {exc}") from exc
        if dspan is not None:
            dspan.end()
        synced = time.monotonic()
        if started is None:
            started = synced
        elapsed = synced - started
        if kind == "prefill":
            self.util.record_prefill(
                tokens=sum(len(r.resume_tokens) for _, r in rows),
                dispatched_at=started, synced_at=synced,
                sync_wait_s=synced - sync_t0)
            # what sets the step's cost: the wave's longest window
            slowest = max(rows, key=lambda e: len(e[1].resume_tokens),
                          default=(None, None))[1]
            self.steps.note_sync(
                "prefill", tokens=len(rows),
                slowest_request_id=slowest.id if slowest else None)
            if self.meter is not None:
                # staged for _finish_step: every dispatched row is billed
                # (a cancel after dispatch still used the card), and rows
                # awaiting their first token carry their queue wait
                self._meter_rows = (
                    "prefill",
                    [(r, len(r.resume_tokens), len(r.resume_tokens))
                     for _, r in rows],
                    [(r, started - r.enqueued_at) for _, r in rows
                     if r.first_token_at is None])
            n_first = 0
            handoffs = []
            for row, (slot_idx, request) in enumerate(rows):
                slot = self.slots[slot_idx]
                if slot.request is not request:  # cancelled since dispatch
                    continue
                if request.first_token_at is None:
                    request.first_token_at = synced
                    if self.recorder is not None:
                        self.recorder.record_first_token(request)
                    self._obs.hist("app_tpu_ttft_seconds",
                                   synced - request.enqueued_at,
                                   exemplar=self._exemplar_of(request))
                token = int(tokens_host[row])
                if self.speculative_tokens:
                    # resume_tokens read before the emit below extends it
                    slot.history = list(request.resume_tokens) + [token]
                self._emit_block(request, [token])
                n_first += 1
                if (request.hit_stop(token) or slot.remaining <= 0
                        or self._is_cancelled(request)):
                    self._finish_slot(slot)
                elif self.disagg_role == "prefill":
                    # the slot never enters decode here: its KV goes to the
                    # decode pool with the stream (the first token above was
                    # this pool's whole job)
                    handoffs.append((slot, request))
            # after every first token of the wave: where the reference
            # exports each row as its token is emitted, a row's first token
            # here never waits for another row's export
            for slot, request in handoffs:
                self._handoff_slot(slot, request)
            if n_first:
                self._obs.counter("app_tpu_tokens_generated_total",
                                  float(n_first))
            return
        if kind == "verify":
            self._sync_verify(tokens_host, rows, block, started, synced,
                              sync_t0)
            return
        self._obs.hist("app_tpu_execute_seconds", elapsed)
        live = [(i, r) for i, r in rows if self.slots[i].request is r]
        # slot lengths are pre-demux here: the context this dispatch read
        # each step (the MBU KV term)
        self.util.record_decode(
            rows=len(rows), steps=block,
            kv_tokens=sum(self.slots[i].length for i, _ in live),
            dispatched_at=started, synced_at=synced,
            sync_wait_s=synced - sync_t0)
        slowest = max(live, key=lambda e: self.slots[e[0]].length,
                      default=(None, None))[1]
        if self.meter is not None:
            # block positions per live row, whatever the demux emits (a
            # stop truncates emission, not device work); pre-demux context
            self._meter_rows = (
                "decode",
                [(r, block, self.slots[i].length) for i, r in live], None)
        emitted = self._demux(tokens_host, live, [block] * len(live),
                              step_s=elapsed / block)
        if emitted:
            self._obs.counter("app_tpu_tokens_generated_total",
                              float(emitted))
        self.steps.note_sync(
            "decode", tokens=emitted,
            slowest_request_id=slowest.id if slowest else None)
        self._track_throughput(emitted)
        # every token of this sync shares one measured step time: one
        # record of n per sync, not one per token
        self._obs.hist_n(
            "app_tpu_tpot_seconds", elapsed / block, emitted,
            exemplar=self._exemplar_of(slowest) if slowest else None)
        self._obs.hist("app_tpu_batch_size", len(live))

    def _exemplar_of(self, request: GenerationRequest) -> Dict[str, str]:
        """A histogram exemplar for `request`: its id and, with a span, its
        trace id (OpenMetrics exposition only)."""
        ex = {"request_id": str(request.id)}
        span = request.gen_span or request.span
        trace_id = getattr(span, "trace_id", None)
        if trace_id:
            ex["trace_id"] = trace_id
        return ex

    def _demux(self, tokens_host, live, limits,
               step_s: Optional[float] = None, elapsed: float = 0.0) -> int:
        """Deliver a synced [B, W] token matrix to its live (slot, request)
        rows, each up to its limit (_demux_plan), extending the drafting
        history of speculative rows (a cooloff's blocks too), with one
        recorder decode_block per row (step_s per token, or elapsed / n for
        a verify's rows). Returns the tokens emitted."""
        with self.steps.seg("demux"):
            counts, finishes = self._demux_plan(
                tokens_host, [i for i, _ in live], [r for _, r in live],
                limits)
        emitted = 0
        for j, (slot_idx, request) in enumerate(live):
            slot = self.slots[slot_idx]
            n = int(counts[j])
            toks = tokens_host[slot_idx, :n].tolist()
            slot.length += n
            slot.remaining -= n
            if slot.history is not None:
                slot.history.extend(toks)
            self._emit_block(request, toks)
            emitted += n
            if self.recorder is not None and n:
                # one batched event per request per sync, recorded before
                # the slot can go terminal
                self.recorder.record_decode_block(
                    request.id, n, step_s if step_s is not None
                    else elapsed / n)
            if finishes[j]:
                self._finish_slot(slot)
        return emitted

    def _sync_verify(self, host, rows, d: int, started: float,
                     synced: float, sync_t0: float) -> None:
        """A verify's [B, d+2] output: each live row emits out[b, :n_emit]
        (truncated at its stops and budget by _demux_plan); the acceptance
        counted on the device, before that truncation, is folded into the
        EMA per greedy-ELIGIBLE row (temperature rows can never accept, so
        they must not read as rejection), and a cold EMA cools off.
        started / synced / sync_t0: the dispatch stamp, the sync's end and
        the wait's start."""
        elapsed = synced - started
        out, n_emit = host[:, :-1], host[:, -1]
        live = [(i, r) for i, r, _ in rows if self.slots[i].request is r]
        # a verify scores d + 1 positions per row over the dispatched
        # (pre-demux) context
        self.util.record_decode(
            rows=len(rows), steps=d + 1,
            kv_tokens=sum(self.slots[i].length for i, _ in live),
            dispatched_at=started, synced_at=synced,
            sync_wait_s=synced - sync_t0)
        eligible = sum(1 for i, r, e in rows
                       if e and self.slots[i].request is r)
        slowest = max(live, key=lambda e: self.slots[e[0]].length,
                      default=(None, None))[1]
        if self.meter is not None:
            # d + 1 positions scored per live row, pre-demux context
            self._meter_rows = (
                "verify",
                [(r, d + 1, self.slots[i].length) for i, r in live], None)
        self._obs.hist("app_tpu_execute_seconds", elapsed)
        limits = [int(n_emit[i]) for i, _ in live]
        accepted = sum(max(0, n - 1) for n in limits)
        self.spec_accepted += accepted
        self.spec_eligible += eligible
        self._obs.counter("app_tpu_spec_accepted_total", float(accepted))
        emitted = self._demux(out, live, limits, elapsed=elapsed)
        self.steps.note_sync(
            "verify", tokens=emitted,
            slowest_request_id=slowest.id if slowest else None)
        self._track_throughput(emitted)
        if emitted:
            self._obs.counter("app_tpu_tokens_generated_total",
                              float(emitted))
            self._obs.hist_n(
                "app_tpu_tpot_seconds",
                elapsed / (emitted / max(1, len(live))), emitted,
                exemplar=self._exemplar_of(slowest) if slowest else None)
        self._obs.hist("app_tpu_batch_size", len(live))
        if eligible:
            a = self.SPEC_EMA_ALPHA
            self._spec_accept_ema = ((1 - a) * self._spec_accept_ema
                                     + a * accepted / eligible)
            if self._spec_accept_ema < self.SPEC_MIN_ACCEPT:
                self._cool_off()

    def _track_throughput(self, tokens: int) -> None:
        """app_tpu_tokens_per_second over the syncs of the last 5 s."""
        now = time.monotonic()
        self._tok_window.append((now, tokens))
        cutoff = now - 5.0
        while self._tok_window and self._tok_window[0][0] < cutoff:
            self._tok_window.popleft()
        if len(self._tok_window) >= 2:
            span = now - self._tok_window[0][0]
            if span > 0:
                self._obs.gauge("app_tpu_tokens_per_second",
                                sum(t for _, t in self._tok_window) / span)

    def _emit_block(self, request: GenerationRequest,
                    tokens: List[int]) -> None:
        """Deliver one request's tokens for this sync in ONE queue entry."""
        if not tokens:
            return
        request.generated += len(tokens)
        request.emitted.extend(tokens)   # the replay ledger, before the put
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
        # the terminal reason, read before the slot resets: error > cancel
        # > budget or context cap ("length") > stop token
        reason = None
        if request is not None:
            if request.error is not None:
                reason = "error"
            elif self._is_cancelled(request):
                reason = "cancelled"
            elif (slot.remaining <= 0
                  or slot.length >= self.max_seq_len - 1):
                reason = "length"
            else:
                reason = "stop"
        slot.request = None
        slot.length = 0
        slot.remaining = 0
        slot.history = None
        self._forget_row_controls(self.slots.index(slot))
        if request is None:
            self._obs.gauge("app_tpu_active_slots",
                            sum(1 for s in self.slots if s.active))
            return
        # stamped here, not in the job: _fail_request's double-finish guard
        # reads it on the loop thread
        request.finished_at = time.monotonic()
        # the slow tail (span end, recorder, meter, gauge, the client's
        # None) runs off the loop, its inputs captured now; the None goes
        # last, so a returned result() means the recorder holds the record
        active_now = sum(1 for s in self.slots if s.active)
        self._run_off_loop(
            self._finish_request_job(request, reason, active_now))

    def _forget_row_controls(self, idx: int) -> None:
        """Zero a freed row's controls behind the blocks in flight (they
        read them at their fixed address), so the blocks dispatched from
        now on may skip the filters (``-sc-nosort``)."""
        if idx in self._filter_rows:
            with self._stream_ctx():
                self._temps[idx] = 0.0
            self._filter_rows.discard(idx)

    def _finish_request_job(self, request: GenerationRequest, reason: str,
                            active_now: int) -> Callable[[], None]:
        def job() -> None:
            if request.gen_span is not None:
                request.gen_span.set_attribute("tpu.tokens",
                                               request.generated)
                if request.error is not None:
                    request.gen_span.set_status(False, str(request.error))
                request.gen_span.end()
            if self.recorder is not None:
                self.recorder.record_finished(request, reason)
            if self.qos is not None:
                self.qos.note_finished(request, ok=request.error is None)
            if self.meter is not None:
                self.meter.note_finished(request, ok=request.error is None)
            self._obs.gauge("app_tpu_active_slots", active_now)
            request.out_queue.put(None)
        return job

    def _run_off_loop(self, job: Callable[[], None]) -> None:
        """Hand a teardown job to the finisher; run it inline when there is
        none (finisher_queue=0) or its queue is full. Jobs are never
        dropped, and a request has one terminal job made after its tokens
        were enqueued, so the inline fallback keeps its order."""
        if self._finisher is None or not self._finisher.submit(job):
            job()

    def _fail_request(self, request: GenerationRequest,
                      exc: Optional[BaseException] = None) -> None:
        """Terminate a request that never reached (or lost) a slot. On a
        prefill pool the failure is offered to the hand-off fail hook first
        (disagg.PrefillWorker): when it takes the request, the stream is not
        over (the decode pool recomputes prompt + emitted), so no error
        lands on the request the client shares and no None is delivered;
        this pool's span and record still close."""
        handled = (self._handoff_fail is not None
                   and self._handoff_fail(request, exc))
        if exc is not None and not handled:
            request.error = exc
        if request.finished_at is None:
            request.finished_at = time.monotonic()
        if request.gen_span is not None and request.gen_span.end_time is None:
            if request.error is not None:
                request.gen_span.set_status(False, str(request.error))
            elif request.cancelled.is_set():
                request.gen_span.set_attribute("cancelled", True)
            if handled:
                request.gen_span.set_attribute("disagg.fallback", True)
            request.gen_span.end()
        if self.recorder is not None:
            self.recorder.record_finished(
                request, "handoff" if handled
                else ("error" if request.error is not None
                      else ("cancelled" if request.cancelled.is_set()
                            else "aborted")))
        if handled:
            return
        if self.qos is not None:
            self.qos.note_finished(request, ok=request.error is None)
        if self.meter is not None:
            self.meter.note_finished(request, ok=request.error is None)
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

    # -- crash-only recovery --------------------------------------------------
    def _breaker_probe(self) -> None:
        """The breaker's half-open probe: ONE tiny device round trip
        decides whether the storm is over (the reference's
        ``float(jnp.asarray(1.0) + 1.0)``). On the card: one launch and a
        ``torch.cuda.synchronize()``, which raises on a dead context.
        Success closes the breaker, failure re-opens it for another
        cooldown. Runs on the loop thread, so a wedged probe shows as a
        stall."""
        try:
            if self.faults is not None:
                self.faults.hit("engine.probe")
            if self.device.type == "cuda":
                float((torch.ones(1, device=self.device) + 1.0).item())
                synchronize(self.device)
            else:
                float(torch.ones(1) + 1.0)
        except Exception as exc:  # noqa: BLE001 - the device is still sick
            self.breaker.probe_failed()
            self._obs.gauge("app_tpu_breaker_state", self.breaker.state_code)
            if self.recorder is not None:
                self.recorder.record_engine_event("breaker_probe_failed",
                                                  error=str(exc))
            self.logger.errorf("breaker half-open probe failed: %s", exc)
        else:
            if self.breaker.probe_ok():
                self._obs.gauge("app_tpu_breaker_state",
                                self.breaker.state_code)
                if self.recorder is not None:
                    self.recorder.record_engine_event("breaker_closed")
                self.logger.warnf("breaker closed: the device answered the "
                                  "half-open probe; resuming admission")
                self._wake.set()

    def _count_reset(self, exc: BaseException) -> None:
        """One device reset: the counters, the recorder's device_reset, and
        the breaker (its opening is an incident)."""
        self.resets_total += 1
        self._obs.counter("app_tpu_device_resets_total")
        if self.recorder is not None:
            self.recorder.record_engine_event("device_reset", error=str(exc))
        if self.breaker.record_reset():
            if self.recorder is not None:
                self.recorder.record_engine_event(
                    "breaker_open", **self.breaker.snapshot())
            if self.incidents is not None:
                # captured off the loop while the evidence is in the rings
                self.incidents.trigger("breaker_open", error=str(exc),
                                       breaker=self.breaker.snapshot())
            self.logger.errorf(
                "reset storm: %d resets inside %.0fs - breaker OPEN, "
                "shedding submits until the half-open probe passes",
                self.breaker.max_resets, self.breaker.window_s)
        self._obs.gauge("app_tpu_breaker_state", self.breaker.state_code)

    def _reset_device_state(self, exc: BaseException) -> None:
        """After a failed launch or sync: restore the device state in place
        and REPLAY the interrupted requests instead of failing them (the
        reference's ``_reset_device_state``). The host holds each one's
        prompt and every token it delivered, so the survivors (active
        slots and chunk jobs) re-admit at prompt + emitted with the rest of
        their budget: the client's stream pauses, no position is emitted
        twice or dropped. Bounded by retry_budget, with poison quarantine;
        every pass counts toward the reset-storm breaker. Never raises: a
        restore that raises counts as one more reset."""
        try:
            self._count_reset(exc)
            with self._state_lock, torch.no_grad(), self._stream_ctx():
                # the dispatch spans of the window the failure destroyed
                for entry in self._inflight:
                    dspan = entry[5] if len(entry) > 5 else None
                    if dspan is not None and dspan.end_time is None:
                        dspan.set_status(False, str(exc))
                        dspan.end()
                    if isinstance(entry[1], tuple):
                        self._host_free.append(entry[1][0])
                self._inflight.clear()
                survivors: List[GenerationRequest] = []
                while self._chunk_jobs:   # nothing emitted yet: replay too
                    job = self._chunk_jobs.popleft()
                    for slot_idx in job["slots_idx"]:
                        self.slots[slot_idx].chunking = None
                    survivors.extend(job["batch"])
                for slot in self.slots:
                    if slot.active:
                        # evacuated WITHOUT terminating: no None, no span
                        # end; the request lives on in the replay queue.
                        # Paged: the allocator is rebuilt wholesale below
                        survivors.append(slot.request)
                        slot.request = None
                        slot.length = 0
                        slot.remaining = 0
                        slot.history = None
                        slot.pages = None
                try:
                    self._restore_device_state()
                except Exception as rexc:  # noqa: BLE001 - a dead context
                    self.logger.errorf("device state restore failed: %s",
                                       rexc)
                    self._count_reset(rexc)
                self._replay_or_fail(survivors, exc)
        except Exception:  # noqa: BLE001 - the loop must survive its reset
            self.logger.errorf("device reset failed: %s",
                               traceback.format_exc())

    def _restore_device_state(self) -> None:
        """The reference rebuilds its device state after a reset; here it
        is restored in place, because every captured graph reads and writes
        its tensors at fixed addresses: no chunk job's state is resident,
        no row has controls, the loop state is zeroed and the same
        generator re-seeded (seed + resets so far), on the engine's stream
        behind the work in flight. The caches, the programs' static
        inputs and every captured program are kept; the dense caches keep
        their grown length. Replayed rows re-prefill what they read."""
        self._chunk_resident.clear()
        self._filter_rows.clear()
        self._tokens.zero_()
        self._positions.zero_()
        self._temps.zero_()
        self.generator.manual_seed(next(self._reset_counter))

    @loop_only
    def _replay_or_fail(self, survivors: List[GenerationRequest],
                        exc: BaseException) -> None:
        """Requeue each reset survivor for replay, or fail it when it is out
        of budget, poisoned, cancelled or no longer admissible. Under the
        state lock, after the device state was restored."""
        if len(survivors) == 1 and self._sole_reset_id == survivors[0].id:
            self._sole_reset_streak += 1
        else:
            self._sole_reset_id = (survivors[0].id if len(survivors) == 1
                                   else None)
            self._sole_reset_streak = 1 if self._sole_reset_id else 0
        for request in survivors:
            if self._plane is not None:
                # a replay requeue would have to ride an admission wave to
                # stay symmetric across ranks: fail loudly, as the reference
                self._fail_request(request, exc)
                continue
            if self._is_cancelled(request):
                self._fail_request(request)
                continue
            if (request.id == self._sole_reset_id
                    and self._sole_reset_streak >= 2):
                self.quarantined_total += 1
                self._obs.counter("app_tpu_requests_quarantined_total")
                if self.recorder is not None:
                    self.recorder.record_event(
                        request.id, "quarantined",
                        consecutive_sole_resets=self._sole_reset_streak)
                if self.incidents is not None:
                    self.incidents.trigger(
                        "quarantine", request_id=request.id,
                        consecutive_sole_resets=self._sole_reset_streak)
                self.logger.errorf(
                    "request %d quarantined: sole in-flight work across %d "
                    "consecutive device resets", request.id,
                    self._sole_reset_streak)
                self._fail_request(request, exc)
                continue
            budget_left = request.max_new_tokens - request.generated
            if (request.replays >= self.retry_budget or budget_left <= 0
                    or len(request.resume_tokens) > self.admission_limit):
                self._fail_request(request, exc)
                continue
            request.replays += 1
            # replays outrank queued arrivals (LOWER admits first, clients
            # are clamped to >= 0): an interrupted stream resumes first
            request.priority = min(request.priority, -1)
            request.admitted_at = None   # stamped again at re-admission
            self.replays_total += 1
            self.replayed_tokens_total += len(request.emitted)
            self._obs.counter("app_tpu_request_replays_total")
            self._obs.counter("app_tpu_replayed_tokens_total",
                              float(len(request.emitted)))
            if self.recorder is not None:
                self.recorder.record_event(
                    request.id, "replayed", attempt=request.replays,
                    replayed_tokens=len(request.emitted))
            heapq.heappush(self._admission_heap,
                           (request.priority, request.id, request))
        self._wake.set()

    # -- the QoS plane --------------------------------------------------------
    @loop_only
    def _qos_actuate(self) -> None:
        """Act on the QoS ladder (tpu/qos.py) from the loop, under the state
        lock, just before admission: at preempt_batch and above, evacuate
        the running batch rows through the replay contract, so their slots
        (and, paged, their pages) go to the work the ladder protects.
        Parking and the standard shed act at the admission gate and the
        submit door."""
        if self.qos.level < 2:
            return
        with self._state_lock:
            self._preempt_slots(("batch",))

    @loop_only
    def _preempt_slots(self, classes) -> int:
        """Preempt every running generation of `classes` that can resume
        (the reference's ``_preempt_slots``): evacuate its slot without
        terminating it (no None to its client, no span end: a reset
        survivor's recipe) and requeue it at prompt + emitted with its own
        banded priority, behind the interactive work, where a replay after
        a reset goes ahead of everything. The client's stream pauses;
        nothing is emitted twice or dropped: the blocks in flight that
        still decode its old row are dropped at their sync by the ``slot.
        request is not request`` guards, and the admission gate keeps the
        request queued until they have synced (_in_flight). Skipped: a slot
        in the middle of a chunk job, a cancelled request, an exhausted
        budget, a resume window over admission_limit. Counted in
        ``preemptions`` / ``preemptions_total``, apart from the
        retry_budget. Returns how many were preempted."""
        preempted = 0
        for slot in self.slots:
            request = slot.request
            if request is None or slot.chunking is not None:
                continue
            if request.qos_class not in classes:
                continue
            if self._is_cancelled(request):
                continue   # the demux's finish owns cancellation
            if request.max_new_tokens - request.generated <= 0:
                continue   # about to finish on its own
            if len(request.resume_tokens) > self.admission_limit:
                continue   # could never re-admit: finishing is cheaper
            self._release_slot_for_preempt(slot)
            request.preemptions += 1
            request.admitted_at = None   # stamped again at re-admission
            self.preemptions_total += 1
            preempted += 1
            self.qos.note_preempted(request)
            if self.recorder is not None:
                self.recorder.record_event(
                    request.id, "preempted", emitted=len(request.emitted),
                    preemptions=request.preemptions)
            heapq.heappush(self._admission_heap,
                           (request.priority, request.id, request))
        if preempted:
            if self.recorder is not None:
                self.recorder.record_engine_event(
                    "qos_preempt", preempted=preempted, level=self.qos.level)
            self.logger.warnf("qos ladder level %d: preempted %d batch "
                              "generation(s) for replay", self.qos.level,
                              preempted)
            self._obs.gauge("app_tpu_active_slots",
                            sum(1 for s in self.slots if s.active))
        return preempted

    def _release_slot_for_preempt(self, slot: _Slot) -> None:
        """Evacuate one slot for a preemption: the reset survivor's recipe
        (the request lives on, its stream open) and the freed row's
        controls forgotten as at a finish (the reference zeroes a filtered
        row's temperature): the row leaves ``_filter_rows``, so the blocks
        dispatched from now on may run ``-sc-nosort``. The paged engine
        returns the slot's pages first."""
        slot.request = None
        slot.length = 0
        slot.remaining = 0
        slot.history = None
        slot.pages = None
        self._forget_row_controls(self.slots.index(slot))

    def _in_flight(self, request: GenerationRequest) -> bool:
        """Whether a dispatch in flight still holds `request` in one of its
        rows: only a preempted request, queued again before the blocks that
        decoded its old row synced. Bound again to the same slot, it would
        pass their sync's guard and take their tokens, so the admission
        gate keeps it queued until they have synced (a few loop steps)."""
        if not request.preemptions:
            return False
        return any(row[1] is request for entry in self._inflight
                   for row in entry[2])

    def _expire(self, request: GenerationRequest) -> None:
        """Fail a queued request past its class's deadline (the admission
        gate's "expire") with QoSDeadlineError (503), recording a
        ``qos_expired`` event."""
        self._abort_admission(request)
        self.qos.note_expired(request)
        waited = time.monotonic() - request.enqueued_at
        if self.recorder is not None:
            self.recorder.record_event(request.id, "qos_expired",
                                       waited_s=round(waited, 2))
        cls = qos.effective_class(request)
        self._fail_request(request, qos.QoSDeadlineError(
            cls, waited, self.qos.deadlines.get(cls, 0.0)))
