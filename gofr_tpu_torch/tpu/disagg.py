"""Disaggregated prefill/decode serving: two engines, one stream.

Ports ``gofr_tpu/tpu/disagg.py`` whole: ``encode_handoff`` /
``decode_handoff`` (the envelope is the reference's, byte for byte but its
``sent_at`` stamp; the encoded blobs are spliced into it escaped as
json.dumps escapes them, without its scan of each one), ``QueueTransport``, ``PubSubTransport`` (served
under ``DISAGG_TRANSPORT=pubsub`` over the container's broker),
``PrefillWorker``,
``DecodeCoordinator``, ``DisaggRouter`` (the exactly-once registry, the
submit gate, the stale reaper, ``kill``), ``register_disagg_metrics`` and
``GET /debug/disagg`` (``install_routes``).

Interleaved prefill poisons a colocated engine's TPOT (each admitted prompt
takes a sync window from the decodes in flight). The split removes it:

  client -- DisaggRouter.submit --> prefill engine (disagg_role="prefill")
               |                        prefills, emits the FIRST token,
               |                        exports the prompt's KV as
               |                        kvtier.PageBlob pages and evacuates
               |                        the slot: it never decodes
               |   bounded in-process queue (or a pub/sub broker)
               v
          DecodeCoordinator --> decode engine (disagg_role="decode")
                                    lands the shipped KV in place (the
                                    ``kv_handoff`` segment) and binds the
                                    slot straight into decode: it never
                                    prefills on the healthy path

The client's stream never changes hands: the hand-off shares the prefill
side's out_queue and cancel event. Every lost, corrupt, refused or
orphaned hand-off degrades to a blob-less ``submit_handoff`` on the decode
pool (a recompute of ``prompt + emitted``), never a failed stream. The
router's registry is the exactly-once gate: every terminal path claims the
request by popping its entry first; whoever pops it routes the stream,
everyone else drops.

The pair runs on one card in ``DISAGG_MODE=both``: two engines over one
params tree, each with its own stream, program cache, graph pool and
generator (serve.py).
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from .kvtier import PageBlob, decode_blob, encode_blob, splice_json
from .obs import MetricsHook

HANDOFF_VERSION = 1

# every fallback increments app_tpu_disagg_fallback_total{reason=...};
# the engine/paging layers add: export, page_count, shape, content, restore
FALLBACK_TOTAL = "app_tpu_disagg_fallback_total"


def _span_traceparent(span) -> Optional[str]:
    """Best-effort W3C traceparent from a live tracer span, so the decode
    pool's spans land on the SAME trace even when the client sent no
    traceparent header (the prefill-side gen_span then roots the trace).
    Tracer backends differ; probe the common shapes and give up quietly."""
    if span is None:
        return None
    try:
        ctx = getattr(span, "context", None) or span
        trace_id = getattr(ctx, "trace_id", None)
        span_id = getattr(ctx, "span_id", None)
        if trace_id is None or span_id is None:
            return None
        if isinstance(trace_id, int):
            trace_id = f"{trace_id:032x}"
        if isinstance(span_id, int):
            span_id = f"{span_id:016x}"
        return f"00-{trace_id}-{span_id}-01"
    except Exception:  # noqa: BLE001 - tracing is never load-bearing
        return None


def encode_handoff(request, blobs: Optional[Sequence[PageBlob]],
                   n_ctx: int) -> str:
    """Serialize one hand-off. ``blobs=None`` encodes the degraded
    (recompute) form — same envelope, no KV payload."""
    spec: Dict[str, Any] = {
        "id": request.id,
        "prompt": list(request.prompt_tokens),
        "emitted": list(request.emitted),
        "max_new": request.max_new_tokens,
        "temp": request.temperature,
        "stop": sorted(request.stop_tokens),
        "prio": request.priority,
        "min": request.min_tokens,
        "top_p": request.top_p,
        "top_k": request.top_k,
        # QoS identity crosses the hop for accounting; prio already
        # carries the band and hand-offs outrank everything anyway
        "qos": getattr(request, "qos_class", None),
        "tenant": getattr(request, "tenant", ""),
    }
    traceparent = request.traceparent or _span_traceparent(request.gen_span)
    encoded = None if blobs is None else [encode_blob(b) for b in blobs]
    text = json.dumps({
        "v": HANDOFF_VERSION,
        "rid": request.id,
        "spec": spec,
        "n_ctx": int(n_ctx),
        "traceparent": traceparent,
        # single-host hop: monotonic stamps are comparable across threads
        "sent_at": time.monotonic(),
        "blobs": None if encoded is None else [
            f"@blob{i}@" for i in range(len(encoded))],
    })
    if not encoded:
        return text
    # the blobs spliced in as json.dumps would escape them: a blob's text
    # is ASCII without a backslash (json.dumps and base64 wrote it), so
    # its only escape is the quote; a page's escape scan costs ~tens of ms
    return splice_json(text, [
        (f"@blob{i}@", b.replace('"', '\\"') if "\\" not in b
         else json.dumps(b)[1:-1]) for i, b in enumerate(encoded)])


def decode_handoff(raw) -> Optional[Dict[str, Any]]:
    """Parse the envelope (NOT the blobs — those stay encoded until the
    coordinator decides per-blob, so one corrupt page cannot take down the
    whole parse). None on any structural failure; the caller cannot even
    learn the request id from a torn envelope, so envelope integrity is
    the transport's job — per-page integrity is crc32's."""
    try:
        if isinstance(raw, bytes):
            raw = raw.decode("utf-8")
        body = json.loads(raw)
        if body.get("v") != HANDOFF_VERSION:
            return None
        if "rid" not in body or "spec" not in body:
            return None
        return body
    except Exception:  # noqa: BLE001 - torn payload == lost payload
        return None


# -- transports ---------------------------------------------------------------


class QueueTransport:
    """Default hand-off transport: a bounded in-process queue. publish()
    is non-blocking — a full queue returns False, which the prefill side
    turns into a recompute fallback rather than stalling its loop (the
    decode pool is the bottleneck at that moment; shipping more KV at it
    would not help)."""

    def __init__(self, maxsize: int = 64):
        self._q: "queue.Queue[str]" = queue.Queue(maxsize=maxsize)

    def publish(self, payload: str) -> bool:
        try:
            self._q.put_nowait(payload)
        except queue.Full:
            return False
        return True

    def poll(self, timeout_s: float) -> Optional[str]:
        try:
            return self._q.get(timeout=timeout_s)
        except queue.Empty:
            return None

    def depth(self) -> int:
        return self._q.qsize()


class PubSubTransport:
    """Hand-off over a gofr_tpu/pubsub broker (config-selected): the same
    envelope published to a topic, consumed commit-to-advance by the
    decode side's group. Lets the split pair ride whatever broker the app
    already wires (in-proc for tests, Kafka-shaped for real deployments).
    Payload loss/duplication then follows the broker's delivery contract;
    the router's registry claim keeps duplicates harmless."""

    def __init__(self, broker, topic: str = "gofr.disagg.handoff",
                 group: str = "decode-pool"):
        self.broker = broker
        self.topic = topic
        self.group = group

    def publish(self, payload: str) -> bool:
        try:
            self.broker.publish(self.topic, payload.encode("utf-8"))
        except Exception:  # noqa: BLE001 - broker down == hand-off lost
            return False
        return True

    def poll(self, timeout_s: float) -> Optional[str]:
        try:
            msg = self.broker.subscribe(self.topic, self.group,
                                        timeout_s=timeout_s)
        except Exception:  # noqa: BLE001
            return None
        if msg is None:
            return None
        msg.commit()
        value = msg.value
        return value.decode("utf-8") if isinstance(value, bytes) else value

    def depth(self) -> int:
        return 0  # broker-side depth is the broker's own metric


# -- prefill side -------------------------------------------------------------


class PrefillWorker:
    """Owns the prefill engine's two disagg hooks. ``_export`` runs on the
    ENGINE LOOP thread (inside the ``kv_handoff`` step segment) right
    after the first token emits; ``_on_fail`` intercepts every would-be
    request failure and re-routes it to the decode pool instead.

    kill() is the chaos hook soak exercises: abrupt worker death must
    surface ONLY as fallback_total increments and replay events — never
    as a failed client stream."""

    def __init__(self, engine, router: "DisaggRouter"):
        if getattr(engine, "disagg_role", "") != "prefill":
            raise ValueError("PrefillWorker needs an engine built with "
                             "disagg_role='prefill'")
        self.engine = engine
        self.router = router
        self.alive = True
        engine._handoff_sink = self._export
        engine._handoff_fail = self._on_fail
        if getattr(engine, "util", None) is not None:
            engine.util.pool = "prefill"

    # engine loop thread
    def _export(self, request, blobs, n_ctx: int) -> bool:
        router = self.router
        if not self.alive:
            preq = router._claim(request.id)
            if preq is not None:
                router._fallback(preq, "worker_death")
            return False  # fallback arranged (or someone else claimed)
        with router._lock:
            entry = router._registry.get(request.id)
        if entry is None:
            # not routed through this router (or already claimed by a
            # sweep): raising keeps the slot bound so the prefill engine
            # decodes it locally — the never-a-lost-stream last resort
            raise RuntimeError(f"request {request.id} is not registered "
                               f"with the disagg router")
        payload = encode_handoff(request, blobs, n_ctx)
        if not self.router.transport.publish(payload):
            preq = router._claim(request.id)
            if preq is not None:
                router._fallback(preq, "queue_full")
            return False
        router._obs.counter("app_tpu_disagg_handoff_bytes_total",
                            float(len(payload)))
        router._obs.gauge("app_tpu_disagg_queue_depth",
                          self.router.transport.depth())
        # informational only — the kill sweep and the stale reaper key off
        # this state+stamp; a racing consume has already popped the entry
        # and mutating the dead list is harmless
        entry[1] = "queued"
        entry[2] = time.monotonic()
        return True

    # engine loop thread, via _fail_request
    def _on_fail(self, request, exc) -> bool:
        """Re-route a dying prefill-side request to the decode pool.
        True == handled (no error surfaces, no terminal None here — the
        decode side now owns the stream). Client cancels are NOT ours:
        declining lets the normal cancel path close the stream."""
        if request.cancelled.is_set():
            self.router._claim(request.id)  # drop the registry entry
            return False
        preq = self.router._claim(request.id)
        if preq is None:
            return False
        if preq.max_new_tokens - len(preq.emitted) <= 0:
            # budget already delivered; nothing to resume — just close
            preq.out_queue.put(None)
            return True
        try:
            self.router._fallback(preq, "prefill_error")
            return True
        except Exception:  # noqa: BLE001 - decode pool also unusable
            return False  # surface the original failure

    def kill(self) -> None:
        """Chaos: abrupt prefill-worker death. Stops the engine (its drain
        fails every queued request THROUGH the _on_fail hook, each one
        re-routing to the decode pool), then sweeps whatever the registry
        still holds — active-slot requests the dead loop abandoned and
        queued payloads that die with the worker's transport. Exactly-once
        is the registry pop: a coordinator racing on an already-swept
        payload claims nothing and drops it."""
        if not self.alive:
            return
        # under the submit gate: an in-flight router.submit finishes its
        # registry insert before death lands, so the drain below can
        # re-route it; later submits see alive=False and go straight to
        # the decode pool
        with self.router._submit_gate:
            self.alive = False
        try:
            self.engine.stop()
        finally:
            self.router._sweep("worker_death")


# -- decode side --------------------------------------------------------------


class DecodeCoordinator:
    """Consumer thread: polls the transport, decodes envelopes, claims the
    request from the router registry, and admits it into the decode pool
    via submit_handoff — with the shipped blobs when every page survives
    decode_blob's crc, blob-less (recompute) otherwise. Also reaps stale
    hand-offs: an entry stuck in "queued" past handoff_timeout_s means
    the payload was lost in flight; its stream falls back rather than
    hanging until the client's own timeout."""

    POLL_S = 0.1

    def __init__(self, engine, router: "DisaggRouter"):
        if getattr(engine, "disagg_role", "") != "decode":
            raise ValueError("DecodeCoordinator needs an engine built with "
                             "disagg_role='decode'")
        self.engine = engine
        self.router = router
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.consumed_total = 0
        if getattr(engine, "util", None) is not None:
            engine.util.pool = "decode"

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="disagg-decode-coordinator",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            payload = self.router.transport.poll(self.POLL_S)
            if payload is not None:
                try:
                    self._consume(payload)
                except Exception:  # noqa: BLE001 - keep consuming
                    pass
            self.router._reap_stale()

    def _consume(self, payload: str) -> None:
        router = self.router
        body = decode_handoff(payload)
        if body is None:
            # torn envelope: the rid is unreadable, so the stream cannot
            # be re-routed from here — the stale reaper rescues it
            router._count_fallback("envelope")
            return
        preq = router._claim(body["rid"])
        if preq is None:
            return  # swept/cancelled already; exactly-once says drop
        router._obs.gauge("app_tpu_disagg_queue_depth",
                          router.transport.depth())
        sent_at = body.get("sent_at")
        if isinstance(sent_at, (int, float)):
            router._obs.hist("app_tpu_disagg_handoff_seconds",
                             max(0.0, time.monotonic() - float(sent_at)))
        blobs: Optional[List[PageBlob]] = None
        raw_blobs = body.get("blobs")
        if raw_blobs is not None:
            decoded = [decode_blob(raw) for raw in raw_blobs]
            if all(b is not None for b in decoded):
                blobs = decoded
            else:
                # crc/structure failure on any page poisons the whole
                # hand-off: recompute is cheaper than a wrong KV read
                router._count_fallback("corrupt")
                if self.engine.recorder is not None:
                    self.engine.recorder.record_engine_event(
                        "disagg_corrupt_handoff", rid=body["rid"],
                        pages=len(raw_blobs))
        spec = body["spec"]
        try:
            self.engine.submit_handoff(
                spec["prompt"], spec["emitted"],
                max_new_tokens=spec["max_new"],
                temperature=spec["temp"],
                stop_tokens=set(spec["stop"]),
                priority=spec["prio"],
                min_tokens=spec["min"],
                top_p=spec["top_p"], top_k=spec["top_k"],
                traceparent=body.get("traceparent"),
                out_queue=preq.out_queue,
                cancelled=preq.cancelled,
                blobs=blobs,
                qos_class=spec.get("qos"),
                tenant=spec.get("tenant", ""))
            self.consumed_total += 1
        except Exception as exc:  # noqa: BLE001
            # decode pool refused outright (draining/shedding/never-fits):
            # both pools are unusable for this request — terminate the
            # stream explicitly rather than leaving the client hanging
            router._count_fallback("rejected")
            preq.error = exc
            preq.out_queue.put(None)


# -- the router ---------------------------------------------------------------


class DisaggRouter:
    """Front end of the split pair: clients submit here and stream from
    the returned request exactly as they would against one engine. Holds
    the rid -> [request, state, queued_at] registry that makes every
    hand-off terminal path exactly-once (see module docstring)."""

    def __init__(self, prefill_engine, decode_engine, *, metrics=None,
                 transport=None, queue_depth: int = 64,
                 handoff_timeout_s: float = 10.0):
        self.prefill_engine = prefill_engine
        self.decode_engine = decode_engine
        self.transport = transport or QueueTransport(queue_depth)
        self.handoff_timeout_s = float(handoff_timeout_s)
        self._obs = MetricsHook(metrics)
        self._lock = threading.Lock()
        self._registry: Dict[int, List[Any]] = {}
        # serializes submit's {alive-check, prefill submit, registry
        # insert} against kill(): without it a request could enter the
        # prefill engine after the death sweep but before its registry
        # entry exists, and the drain's failure hook — finding no entry —
        # would fail the stream instead of re-routing it
        self._submit_gate = threading.Lock()
        self.fallbacks_total = 0
        self.worker = PrefillWorker(prefill_engine, self)
        self.coordinator = DecodeCoordinator(decode_engine, self)

    @property
    def admission_limit(self) -> int:
        """The binding context limit across the pair (engine.submit
        parity — callers size prompts against the front door)."""
        return min(self.prefill_engine.admission_limit,
                   self.decode_engine.admission_limit)

    def start(self) -> None:
        self.coordinator.start()

    def stop(self) -> None:
        self.coordinator.stop()

    # -- client API -----------------------------------------------------------

    def submit(self, prompt_tokens: Sequence[int],
               max_new_tokens: int = 128, temperature: float = 0.0,
               stop_tokens=None, span=None, priority: int = 0,
               min_tokens: int = 0, top_p: float = 0.0, top_k: int = 0,
               traceparent: Optional[str] = None,
               qos_class: Optional[str] = None, tenant: str = ""):
        """engine.submit()'s signature, against the split pair. Returns
        the request whose stream() carries the whole generation.
        qos_class/tenant hit the PREFILL engine's QoS gate (banding,
        ladder door check); the dead-pool fallback carries them through
        for accounting only, like any hand-off."""
        with self._submit_gate:
            if self.worker.alive:
                preq = self.prefill_engine.submit(
                    prompt_tokens, max_new_tokens=max_new_tokens,
                    temperature=temperature, stop_tokens=stop_tokens,
                    span=span, priority=priority, min_tokens=min_tokens,
                    top_p=top_p, top_k=top_k, traceparent=traceparent,
                    qos_class=qos_class, tenant=tenant)
                with self._lock:
                    self._registry[preq.id] = [preq, "prefill", 0.0]
                return preq
        # dead prefill pool: the decode pool recomputes (degraded but
        # available — the soak chaos arc runs through here)
        self._count_fallback("worker_death")
        return self.decode_engine.submit_handoff(
            list(prompt_tokens), [], max_new_tokens=max_new_tokens,
            temperature=temperature, stop_tokens=stop_tokens,
            priority=priority, min_tokens=min_tokens,
            top_p=top_p, top_k=top_k, traceparent=traceparent,
            blobs=None, qos_class=qos_class, tenant=tenant)

    def stats(self) -> Dict[str, Any]:
        """/debug/disagg payload: the hand-off plane's health plus both
        pools' engine snapshots."""
        from .utilization import engine_snapshot
        with self._lock:
            pending = len(self._registry)
            queued = sum(1 for e in self._registry.values()
                         if e[1] == "queued")
        return {
            "worker_alive": self.worker.alive,
            "queue_depth": self.transport.depth(),
            "pending_handoffs": pending,
            "handoffs_in_flight": queued,
            "handoffs_total": getattr(self.prefill_engine,
                                      "handoffs_total", 0),
            "handoffs_consumed": self.coordinator.consumed_total,
            "fallbacks_total": self.fallbacks_total
            + getattr(self.prefill_engine, "handoff_fallbacks_total", 0)
            + getattr(self.decode_engine, "handoff_fallbacks_total", 0),
            "handoff_timeout_s": self.handoff_timeout_s,
            "prefill": engine_snapshot(self.prefill_engine),
            "decode": engine_snapshot(self.decode_engine),
        }

    # -- exactly-once plumbing ------------------------------------------------

    def _claim(self, rid: int):
        """Pop-and-own: whoever claims the entry routes the stream; every
        later claimer gets None and must drop."""
        with self._lock:
            entry = self._registry.pop(rid, None)
        return entry[0] if entry is not None else None

    def _count_fallback(self, reason: str) -> None:
        self.fallbacks_total += 1
        self._obs.counter(FALLBACK_TOTAL, reason=reason)

    def _fallback(self, preq, reason: str) -> None:
        """Degrade one CLAIMED request to a decode-pool recompute of its
        resume window. Terminates the stream explicitly if even that is
        impossible — a fallback may degrade latency, never deliverability."""
        self._count_fallback(reason)
        recorder = self.decode_engine.recorder
        if recorder is not None:
            recorder.record_engine_event("disagg_fallback", rid=preq.id,
                                         reason=reason)
        try:
            self.decode_engine.submit_handoff(
                preq.prompt_tokens, list(preq.emitted),
                max_new_tokens=preq.max_new_tokens,
                temperature=preq.temperature,
                stop_tokens=set(preq.stop_tokens),
                priority=preq.priority, min_tokens=preq.min_tokens,
                top_p=preq.top_p, top_k=preq.top_k,
                traceparent=preq.traceparent
                or _span_traceparent(preq.gen_span),
                out_queue=preq.out_queue, cancelled=preq.cancelled,
                blobs=None, qos_class=getattr(preq, "qos_class", None),
                tenant=getattr(preq, "tenant", ""))
        except Exception as exc:  # noqa: BLE001
            preq.error = exc
            preq.out_queue.put(None)
            raise

    def _sweep(self, reason: str) -> None:
        """Claim EVERYTHING and fall each request back — worker death."""
        with self._lock:
            entries = list(self._registry.values())
            self._registry.clear()
        for entry in entries:
            try:
                self._fallback(entry[0], reason)
            except Exception:  # noqa: BLE001 - stream already terminated
                pass

    def _reap_stale(self) -> None:
        """Rescue hand-offs lost in flight: queued past the timeout means
        the payload will never arrive (dropped by a lossy transport or a
        crashed consumer) — recompute instead of hanging the stream."""
        now = time.monotonic()
        stale = []
        with self._lock:
            for rid, entry in list(self._registry.items()):
                if (entry[1] == "queued"
                        and now - entry[2] > self.handoff_timeout_s):
                    self._registry.pop(rid)
                    stale.append(entry[0])
        for preq in stale:
            try:
                self._fallback(preq, "lost")
            except Exception:  # noqa: BLE001
                pass


# -- observability wiring -----------------------------------------------------


def register_disagg_metrics(metrics) -> None:
    """Register every app_tpu_disagg_* series on a metrics Manager
    (idempotent; the engine/paging/utilization layers record some of
    these, this module the rest)."""
    for name, desc in (
        ("app_tpu_disagg_queue_depth",
         "hand-off payloads waiting between the prefill and decode pools"),
        ("app_tpu_disagg_pool_duty_cycle",
         "per-pool device duty cycle of the disaggregated pair "
         "(pool=prefill|decode)"),
    ):
        try:
            if metrics.get(name) is None:
                metrics.new_gauge(name, desc)
        except Exception:  # noqa: BLE001 - already registered
            pass
    for name, desc in (
        ("app_tpu_disagg_handoffs_total",
         "KV hand-offs exported by the prefill pool"),
        ("app_tpu_disagg_fallback_total",
         "hand-offs degraded to a decode-pool recompute, by reason"),
        ("app_tpu_disagg_handoff_bytes_total",
         "encoded hand-off payload bytes shipped over the transport"),
    ):
        try:
            if metrics.get(name) is None:
                metrics.new_counter(name, desc)
        except Exception:  # noqa: BLE001
            pass
    try:
        if metrics.get("app_tpu_disagg_handoff_seconds") is None:
            metrics.new_histogram(
                "app_tpu_disagg_handoff_seconds",
                "transport latency of one hand-off, export to consume")
    except Exception:  # noqa: BLE001
        pass


def install_routes(app, router: DisaggRouter,
                   path: str = "/debug/disagg") -> None:
    """Mount the hand-off plane's debug endpoint on an App."""

    @app.get(path)
    def _disagg_stats(ctx):  # noqa: ARG001 - handler shape
        return router.stats()
