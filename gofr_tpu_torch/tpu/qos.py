"""QoS serving plane: tenant classes, quotas, deadlines and the shed ladder.

A copy of ``gofr_tpu/tpu/qos.py``: ``CLASSES``,
``CLASS_BAND``, ``LEVEL_LABELS``, ``normalize_class``, ``banded_priority``,
``effective_class``, ``QoSShedError``, ``QoSDeadlineError``,
``_ClassLedger``, ``QoSController`` (quotas, deadlines, the ladder's
``evaluate`` / ``force_level``, ``check_submit``, ``admission_decision``
with ``_batch_page_share``, the ``note_*`` accounting hooks, ``publish``,
``snapshot``), ``BatchLane`` (``gofr_tpu/tpu/qos.py:554-771``: the
offline lane that feeds the batch band from the App's pub/sub broker,
which ``App.enable_qos`` starts when the container has one),
``register_qos_metrics`` and ``install_routes`` (``GET /debug/qos``). The
tenant helpers ``_MAX_TENANTS``, ``_TENANT_OVERFLOW`` and
``effective_class`` live here, and tpu/meter.py imports them, as the
reference's does. The lane submits through either engine's ``submit``
(paged or dense) and sets ``app_tpu_qos_lane_depth``.

Requests carry a tenant id and one of three classes, mapped onto disjoint
bands of the engine's (priority, id) admission heap, so admission is
class-ordered with FIFO inside a class and the engine's replays (negative
priority) still first:

    replays            < 0
    interactive        0..9  (band 0 + client priority)
    standard          30..39
    batch             60..69

Unclassified requests (``qos_class=None``) keep the legacy behaviour: their
client priority passes through unbanded and no quota parks them.

The ladder, driven by the SLO burn engine's alert states (tpu/incidents.py
``SLOBurnEngine.states``):

    level 0  ok              everyone admits
    level 1  park_batch      batch admission parks (it waits, it never fails)
    level 2  preempt_batch   running batch rows are preempted through the
                             replay contract: the slot is evacuated without
                             terminating the request, which requeues at
                             prompt + emitted with its own banded priority;
                             the client's stream pauses, no token is
                             emitted twice or dropped
    level 3  request_replica nothing degrades locally: ``scaleout_wanted``
                             is advertised in the /stats fleet digest
    level 4  shed_standard   standard submits get 503 + Retry-After;
                             interactive is never shed by the ladder

— any watched track at warn arms level 1 at once, page escalates one level
per ``escalate_hold_s``, and ``recover_hold_s`` of every track ok walks one
level back down. The controller only decides; the engine acts from its
loop (``_qos_actuate``, ``_preempt_slots``). Everything here is host
arithmetic: an engine with ``engine.qos is None`` pays one attribute check
per submit and admission round.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Callable, Dict, Optional

from ..http.errors import InvalidParam
from .obs import MetricsHook

CLASSES = ("interactive", "standard", "batch")
# disjoint bands on the one admission heap: LOWER admits first, client
# priority (clamped 0..9) orders inside a band, and the gap below 30 keeps
# the engine's negative priorities (replays) on top
CLASS_BAND = {"interactive": 0, "standard": 30, "batch": 60}

LEVEL_LABELS = ("ok", "park_batch", "preempt_batch", "request_replica",
                "shed_standard")
# request_replica degrades nothing locally: it advertises scale-out pressure
# (scaleout_wanted, in /stats) before the ladder fails standard traffic
SCALEOUT_LEVEL = LEVEL_LABELS.index("request_replica")
SHED_LEVEL = LEVEL_LABELS.index("shed_standard")

# per-class goodput window (seconds): the /debug/qos payload and the
# app_tpu_qos_goodput gauge
GOODPUT_WINDOW_S = 30.0
_MAX_TENANTS = 32          # per-class tenant table bound (overflow pools)
_TENANT_OVERFLOW = "_other"


class UnknownClassError(InvalidParam, ValueError):
    """An unknown request class: the reference's typed 400 (InvalidParam),
    and a ValueError like every other argument the engines' submit
    refuses."""


def normalize_class(value) -> Optional[str]:
    """Canonicalize a request class: None or blank is unclassified; anything
    else must be one of CLASSES (case and surrounding blanks aside), or
    the request dies here with a 400 rather than land in the wrong band."""
    if value is None:
        return None
    if isinstance(value, str):
        v = value.strip().lower()
        if not v:
            return None
        if v in CLASS_BAND:
            return v
    raise UnknownClassError(
        [f"class must be one of {', '.join(CLASSES)} (got {value!r})"])


def banded_priority(qos_class: Optional[str], priority: int) -> int:
    """(class, client priority) onto the admission heap: unclassified passes
    its priority through; a class lands in its band with the client value
    clamped to 0..9, so no tenant crosses bands."""
    if qos_class is None:
        return int(priority)
    return CLASS_BAND[qos_class] + max(0, min(9, int(priority)))


def effective_class(request) -> str:
    """Accounting class: unclassified requests count as ``standard`` (they
    are quota-exempt, but goodput and queue depth need a row)."""
    return getattr(request, "qos_class", None) or "standard"


class QoSShedError(Exception):
    """A ladder shed: duck-typed 503 + Retry-After like the engine's own
    shed errors, so the servers answer it as they answer those."""

    status_code = 503

    def __init__(self, qos_class: str, level: int, retry_after_s: float):
        self.qos_class = qos_class
        self.level = level
        self.retry_after_s = retry_after_s
        super().__init__(
            f"{qos_class} shed by QoS ladder (level {level}: "
            f"{LEVEL_LABELS[level]}); retry after {retry_after_s:.1f}s")


class QoSDeadlineError(Exception):
    """A queued request outlived its class's deadline before it reached a
    slot: failed at admission instead of serving tokens its client stopped
    waiting for (503)."""

    status_code = 503

    def __init__(self, qos_class: str, waited_s: float, deadline_s: float):
        self.retry_after_s = 1.0
        super().__init__(
            f"{qos_class} request expired in queue: waited "
            f"{waited_s:.1f}s over its {deadline_s:.1f}s deadline budget")


class _ClassLedger:
    """Per-class counters and a rolling completion window, mutated under
    the controller's lock."""

    __slots__ = ("submitted", "admitted", "finished", "errors", "shed",
                 "preempted", "expired", "window")

    def __init__(self):
        self.submitted = 0
        self.admitted = 0
        self.finished = 0
        self.errors = 0
        self.shed = 0
        self.preempted = 0
        self.expired = 0
        # (t, ok, ttft_s or None) of recent completions
        self.window: "collections.deque" = collections.deque(maxlen=2048)

    def goodput(self, now: float) -> Optional[float]:
        cutoff = now - GOODPUT_WINDOW_S
        while self.window and self.window[0][0] < cutoff:
            self.window.popleft()
        if not self.window:
            return None
        ok = sum(1 for _, good, _ in self.window if good)
        return ok / len(self.window)

    def ttft_p50_ms(self) -> Optional[float]:
        ttfts = sorted(t for _, _, t in self.window if t is not None)
        if not ttfts:
            return None
        return round(ttfts[len(ttfts) // 2] * 1000.0, 2)


class QoSController:
    """Per-class quotas, deadlines and the burn-actuated shed ladder; one
    per engine (``engine.qos``), built by ``App.enable_qos``.

    Threads: ``admission_decision`` (the engine loop) and ``check_submit``
    (submit threads) take one short lock; ``evaluate`` runs on the
    controller's eval thread and the metrics scrape hook, never on the
    engine loop. The engine acts on the level (preemption) from its loop."""

    def __init__(self, interactive_reserved_slots: int = 1,
                 batch_page_fraction: float = 0.5,
                 deadlines: Optional[Dict[str, float]] = None,
                 shed_tracks=("ttft", "tpot"),
                 escalate_hold_s: float = 5.0,
                 recover_hold_s: float = 10.0,
                 retry_after_s: float = 2.0,
                 metrics=None, logger=None, recorder=None,
                 clock=time.monotonic,
                 burn_probe: Optional[Callable[[], Dict[str, str]]] = None):
        self.interactive_reserved_slots = max(0,
                                              int(interactive_reserved_slots))
        self.batch_page_fraction = min(1.0, max(0.0,
                                                float(batch_page_fraction)))
        self.deadlines = {c: max(0.0, float((deadlines or {}).get(c, 0.0)))
                          for c in CLASSES}
        self.shed_tracks = tuple(shed_tracks)
        self.escalate_hold_s = max(0.0, float(escalate_hold_s))
        self.recover_hold_s = max(0.0, float(recover_hold_s))
        self.retry_after_s = float(retry_after_s)
        self.logger = logger
        self.recorder = recorder
        self._obs = MetricsHook(metrics, logger=logger)
        self._clock = clock
        self._burn = None
        self._burn_probe = burn_probe    # tests: () -> {slo: state}
        self.lane = None                 # BatchLane, wired by enable_qos
        self.engine = None               # for snapshot(), optional
        self._lock = threading.Lock()
        self.level = 0
        self._level_since = clock()
        self._calm_since: Optional[float] = None
        self._transitions: "collections.deque" = collections.deque(maxlen=64)
        self._ledgers = {c: _ClassLedger() for c in CLASSES}
        self._tenants: Dict[str, Dict[str, int]] = {c: {} for c in CLASSES}
        self._eval_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- wiring ---------------------------------------------------------------
    def use_burn_engine(self, burn) -> None:
        """Adopt the SLOBurnEngine whose per-track alert states drive the
        ladder."""
        if burn is not None:
            self._burn = burn

    def use_metrics(self, metrics) -> None:
        if metrics is not None:
            self._obs = MetricsHook(metrics, logger=self.logger)

    def start_eval_loop(self, interval_s: float = 1.0) -> None:
        """Evaluate the ladder off the request path, so burn keeps draining
        and the ladder recovering when nothing completes or scrapes."""
        if self._eval_thread is not None:
            return
        interval_s = max(0.05, float(interval_s))

        def loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.evaluate()
                except Exception:  # noqa: BLE001 - control is best-effort
                    pass

        self._eval_thread = threading.Thread(target=loop, name="qos-eval",
                                             daemon=True)
        self._eval_thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._eval_thread
        if thread is not None:
            thread.join(timeout=2.0)
            self._eval_thread = None

    # -- the shed ladder ------------------------------------------------------
    def _probe_states(self) -> Dict[str, str]:
        if self._burn_probe is not None:
            try:
                return dict(self._burn_probe())
            except Exception:  # noqa: BLE001
                return {}
        if self._burn is not None:
            try:
                return self._burn.states()
            except Exception:  # noqa: BLE001
                return {}
        return {}

    def evaluate(self) -> int:
        """One ladder step: read the burn tracks, escalate or recover,
        publish; returns the (possibly new) level. Any watched track at
        warn arms level 1 at once; page escalates one more level per
        ``escalate_hold_s``; ``recover_hold_s`` of every track ok walks one
        level back down per hold."""
        states = self._probe_states()
        watched = [states.get(t, "ok") for t in self.shed_tracks]
        pressure = 0
        if any(s == "page" for s in watched):
            pressure = 2
        elif any(s == "warn" for s in watched):
            pressure = 1
        now = self._clock()
        with self._lock:
            old = self.level
            if pressure > 0:
                self._calm_since = None
                if self.level == 0:
                    self._set_level_locked(1, now, states)
                elif (pressure == 2 and self.level < len(LEVEL_LABELS) - 1
                        and now - self._level_since >= self.escalate_hold_s):
                    self._set_level_locked(self.level + 1, now, states)
            else:
                if self._calm_since is None:
                    self._calm_since = now
                elif (self.level > 0
                        and now - self._calm_since >= self.recover_hold_s):
                    self._set_level_locked(self.level - 1, now, states)
                    self._calm_since = now   # one step per recovery hold
            level = self.level
            self._publish_locked(now)
        if level != old and self.logger is not None:
            try:
                self.logger.infof("qos ladder: %s -> %s (%s)",
                                  LEVEL_LABELS[old], LEVEL_LABELS[level],
                                  states)
            except Exception:  # noqa: BLE001
                pass
        return level

    def _set_level_locked(self, level: int, now: float,
                          states: Dict[str, str]) -> None:
        info = {"from": LEVEL_LABELS[self.level], "to": LEVEL_LABELS[level],
                "level": level, "tracks": dict(states), "t": now}
        self._transitions.append(info)
        if level >= SCALEOUT_LEVEL > self.level:
            # crossing into scale-out territory: one ask per escalation
            self._obs.counter("app_tpu_qos_scaleout_requests_total")
        self.level = level
        self._level_since = now
        if self.recorder is not None:
            try:
                self.recorder.record_engine_event("qos_shed_level", **info)
            except Exception:  # noqa: BLE001
                pass

    def force_level(self, level: int) -> None:
        """Pin the ladder (tests, operator drills); the next evaluate()
        moves it again, so pair it with a stubbed burn probe."""
        with self._lock:
            self._set_level_locked(max(0, min(len(LEVEL_LABELS) - 1,
                                              int(level))), self._clock(), {})

    @property
    def scaleout_wanted(self) -> bool:
        """True at the request_replica rung and above: the replica's ask
        for more capacity, in its /stats fleet digest."""
        with self._lock:
            return self.level >= SCALEOUT_LEVEL

    # -- the submit door (any thread) -----------------------------------------
    def check_submit(self, qos_class: Optional[str], tenant: str = "") -> None:
        """The ladder's door, before the request exists: standard (and
        unclassified, counted as standard) sheds with 503 + Retry-After at
        shed_standard; batch always enters (it parks, never fails);
        interactive is never shed."""
        cls = qos_class or "standard"
        with self._lock:
            level = self.level
            if level >= SHED_LEVEL and cls == "standard":
                self._ledgers[cls].shed += 1
                self._obs.counter("app_tpu_qos_shed_total",
                                  **{"class": cls})
                raise QoSShedError(cls, level, self.retry_after_s)

    # -- the admission gate (engine loop, under its state lock) ---------------
    def admission_decision(self, request, engine, taken: int = 0) -> str:
        """'admit' | 'park' | 'expire' for the request at the head of the
        admission heap; `taken`: requests this round already claimed (their
        slots are spoken for, not yet bound). A park keeps the heap's
        no-leapfrog rule: the engine pushes the entry back and ends the
        round, as for a page wait. Unclassified requests are quota-exempt;
        requeued mid-stream requests (replays, preemptions) never expire."""
        cls = effective_class(request)
        now = self._clock()
        deadline = self.deadlines.get(cls, 0.0)
        if (deadline and not request.emitted
                and now - request.enqueued_at > deadline):
            return "expire"
        if request.qos_class is None:
            return "admit"
        if cls == "batch":
            with self._lock:
                parked = self.level >= 1
            if parked:
                return "park"
            if self.batch_page_fraction < 1.0:
                share = self._batch_page_share(request, engine)
                if share is not None and share > self.batch_page_fraction:
                    return "park"
        if cls != "interactive" and self.interactive_reserved_slots > 0:
            free = sum(1 for s in engine.slots
                       if not s.active and s.chunking is None) - taken
            if free <= self.interactive_reserved_slots:
                return "park"
        return "admit"

    @staticmethod
    def _batch_page_share(request, engine) -> Optional[float]:
        """The page pool's share batch would hold if this request admitted:
        pages under batch-class slots plus this request's reservation. None
        on an engine without pages."""
        allocator = getattr(engine, "allocator", None)
        if allocator is None:
            return None
        held = 0
        for slot in engine.slots:
            r = slot.request
            if r is not None and getattr(r, "qos_class", None) == "batch":
                held += len(slot.pages or ())
        need = engine._request_pages(request)
        total = max(1, allocator.n_pages - 1)
        return (held + need) / total

    # -- accounting hooks -----------------------------------------------------
    def _note_tenant_locked(self, cls: str, tenant: str) -> None:
        table = self._tenants[cls]
        key = tenant or "default"
        if key not in table and len(table) >= _MAX_TENANTS:
            key = _TENANT_OVERFLOW
        table[key] = table.get(key, 0) + 1

    def note_submitted(self, request) -> None:
        cls = effective_class(request)
        with self._lock:
            self._ledgers[cls].submitted += 1
            self._note_tenant_locked(cls, getattr(request, "tenant", ""))
        self._obs.counter("app_tpu_qos_submitted_total", **{"class": cls})

    def note_admitted(self, request) -> None:
        cls = effective_class(request)
        with self._lock:
            self._ledgers[cls].admitted += 1
        self._obs.counter("app_tpu_qos_admitted_total", **{"class": cls})

    def note_finished(self, request, ok: bool) -> None:
        cls = effective_class(request)
        ttft = None
        if request.first_token_at is not None:
            ttft = request.first_token_at - request.enqueued_at
        with self._lock:
            ledger = self._ledgers[cls]
            ledger.finished += 1
            if not ok:
                ledger.errors += 1
            ledger.window.append((self._clock(), bool(ok), ttft))

    def note_preempted(self, request) -> None:
        cls = effective_class(request)
        with self._lock:
            self._ledgers[cls].preempted += 1
        self._obs.counter("app_tpu_qos_preempted_total", **{"class": cls})

    def note_expired(self, request) -> None:
        cls = effective_class(request)
        with self._lock:
            self._ledgers[cls].expired += 1
        self._obs.counter("app_tpu_qos_expired_total", **{"class": cls})

    # -- operator surface -----------------------------------------------------
    def publish(self) -> None:
        """The scrape hook: re-evaluate the ladder (so it recovers while the
        server idles) and flush the per-class gauges."""
        self.evaluate()

    def _publish_locked(self, now: float) -> None:
        self._obs.gauge("app_tpu_qos_shed_level", self.level)
        for cls, ledger in self._ledgers.items():
            goodput = ledger.goodput(now)
            if goodput is not None:
                self._obs.gauge("app_tpu_qos_goodput", round(goodput, 4),
                                **{"class": cls})
        if self.lane is not None:
            self._obs.gauge("app_tpu_qos_lane_depth", self.lane.depth())

    def snapshot(self) -> Dict[str, Any]:
        """The GET /debug/qos payload."""
        engine = self.engine
        now = self._clock()
        queued = {c: 0 for c in CLASSES}
        active = {c: 0 for c in CLASSES}
        if engine is not None:
            try:  # a racy read of loop-owned structures, best-effort
                entries = (list(engine._admission_heap)
                           + list(engine._pending.queue))
                for entry in entries:
                    queued[effective_class(entry[2])] += 1
                for slot in engine.slots:
                    if slot.request is not None:
                        active[effective_class(slot.request)] += 1
            except Exception:  # noqa: BLE001
                pass
        with self._lock:
            classes = {}
            for cls, ledger in self._ledgers.items():
                goodput = ledger.goodput(now)
                classes[cls] = {
                    "band": CLASS_BAND[cls],
                    "deadline_s": self.deadlines[cls] or None,
                    "queued": queued[cls],
                    "active": active[cls],
                    "submitted": ledger.submitted,
                    "admitted": ledger.admitted,
                    "finished": ledger.finished,
                    "errors": ledger.errors,
                    "shed": ledger.shed,
                    "preempted": ledger.preempted,
                    "expired": ledger.expired,
                    "goodput": (round(goodput, 4)
                                if goodput is not None else None),
                    "ttft_p50_ms": ledger.ttft_p50_ms(),
                }
            snap = {
                "ladder": {
                    "level": self.level,
                    "state": LEVEL_LABELS[self.level],
                    "scaleout_wanted": self.level >= SCALEOUT_LEVEL,
                    "since_s": round(now - self._level_since, 1),
                    "shed_tracks": list(self.shed_tracks),
                    "escalate_hold_s": self.escalate_hold_s,
                    "recover_hold_s": self.recover_hold_s,
                    "transitions": list(self._transitions),
                },
                "quotas": {
                    "interactive_reserved_slots":
                        self.interactive_reserved_slots,
                    "batch_page_fraction": self.batch_page_fraction,
                },
                "classes": classes,
                "tenants": {c: dict(t) for c, t in self._tenants.items()
                            if t},
            }
        if engine is not None:
            snap["preemptions_total"] = getattr(engine, "preemptions_total",
                                                0)
        if self.lane is not None:
            snap["lane"] = self.lane.stats()
        return snap


class BatchLane:
    """Offline work feeding the engine's batch band from the app's
    pub/sub broker, with a cron kick as the drain backstop.

    Jobs are JSON: ``{"prompt": str | "tokens": [ids], "max_tokens": n,
    "temperature": f, "tenant": str, "job_id": any}``. Results publish
    to the result topic BEFORE the message commits (commit-to-advance:
    a crash between submit and commit redelivers the job — at-least-
    once, like every broker consumer in this repo). Commits are strictly
    in arrival order (the broker's committed offset is a high-water
    mark, so an out-of-order commit would silently mark earlier
    uncommitted jobs done).

    The lane pauses intake while the shed ladder is at park_batch or
    above — under pressure it must starve the engine of exactly the
    work the ladder is trying to park."""

    def __init__(self, engine, broker, topic: str = "qos.batch.jobs",
                 result_topic: str = "qos.batch.results", tokenizer=None,
                 max_inflight: int = 4, group: str = "qos-batch-lane",
                 metrics=None, logger=None, controller=None,
                 poll_s: float = 0.25):
        self.engine = engine
        self.broker = broker
        self.topic = topic
        self.result_topic = result_topic
        self.tokenizer = tokenizer
        self.max_inflight = max(1, int(max_inflight))
        self.group = group
        self.logger = logger
        self.controller = controller
        self.poll_s = float(poll_s)
        self._obs = MetricsHook(metrics, logger=logger)
        # FIFO of (message, request, job) — commits pop from the head
        # only, preserving offset order
        self._inflight: "collections.deque" = collections.deque()
        self._held = None                # (message, job) submit-shed retry
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0                # malformed jobs (committed away)
        self.retries = 0                 # shed submits re-attempted
        self.cron_ticks = 0

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="qos-lane",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
            self._thread = None

    def cron_drain(self, ctx=None):  # noqa: ARG002 - gofr cron signature
        """Cron backstop: kick the worker (a wedged poll wait ends now)
        and flush the depth gauge, so a quiet broker still drains on the
        cron cadence and the gauge never goes stale."""
        self.cron_ticks += 1
        self._wake.set()
        self._obs.gauge("app_tpu_qos_lane_depth", self.depth())
        return {"depth": self.depth(), "completed": self.completed}

    # -- worker ---------------------------------------------------------------
    def _paused(self) -> bool:
        return self.controller is not None and self.controller.level >= 1

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._reap()
                if self._paused() or len(self._inflight) >= self.max_inflight:
                    self._wake.wait(self.poll_s)
                    self._wake.clear()
                    continue
                if self._held is not None:
                    msg, job = self._held
                    self._held = None
                    self._take(msg, job)
                    continue
                msg = self.broker.subscribe(self.topic, self.group,
                                            timeout_s=self.poll_s)
                if msg is None:
                    continue
                self._take(msg, None)
            except Exception as exc:  # noqa: BLE001 - the lane must survive
                if self.logger is not None:
                    try:
                        self.logger.errorf("qos lane: %s", exc)
                    except Exception:  # noqa: BLE001
                        pass
                self._stop.wait(self.poll_s)
        # drain what already finished; uncommitted messages redeliver on
        # the next boot (at-least-once by construction)
        try:
            self._reap()
        except Exception:  # noqa: BLE001
            pass

    def _take(self, msg, job) -> None:
        if job is None:
            try:
                job = json.loads(msg.value.decode("utf-8"))
                if not isinstance(job, dict):
                    raise ValueError("job must be a JSON object")
            except Exception as exc:  # noqa: BLE001 - poison: commit away
                self._reject(msg, None, f"bad job payload: {exc}")
                return
        try:
            tokens = job.get("tokens")
            if tokens is None:
                prompt = job.get("prompt")
                if not isinstance(prompt, str) or not prompt \
                        or self.tokenizer is None:
                    raise ValueError("job needs 'tokens' or a 'prompt' "
                                     "(with a tokenizer on the lane)")
                tokens = self.tokenizer.encode(prompt)
            request = self.engine.submit(
                list(tokens),
                max_new_tokens=max(1, int(job.get("max_tokens", 32))),
                temperature=float(job.get("temperature", 0.0)),
                qos_class="batch", tenant=str(job.get("tenant", "")))
        except (TypeError, ValueError, InvalidParam) as exc:
            # the JOB is wrong, not the server: commit it away with an
            # error result or it redelivers forever
            self._reject(msg, job, str(exc))
            return
        except Exception:  # noqa: BLE001 - shed (drain/stall/breaker):
            # hold the message and retry after a beat — it is already
            # delivered-not-committed, so the broker won't re-serve it
            self._held = (msg, job)
            self.retries += 1
            self._stop.wait(self.poll_s)
            return
        self.submitted += 1
        self._inflight.append((msg, request, job))
        self._obs.gauge("app_tpu_qos_lane_depth", self.depth())

    def _reject(self, msg, job, error: str) -> None:
        self.rejected += 1
        self._publish_result({"job_id": (job or {}).get("job_id"),
                              "ok": False, "error": error})
        try:
            msg.commit()
        except Exception:  # noqa: BLE001
            pass

    def _reap(self) -> None:
        """Complete head-of-line finished jobs: result out, THEN commit.
        Strictly FIFO so the broker's high-water commit never covers a
        still-running earlier job."""
        while self._inflight:
            msg, request, job = self._inflight[0]
            if request.finished_at is None:
                return
            self._inflight.popleft()
            result = {"job_id": job.get("job_id"),
                      "tenant": job.get("tenant", "")}
            try:
                tokens = request.result(timeout_s=10.0)
                result["ok"] = True
                result["tokens"] = len(tokens)
                result["replays"] = request.replays
                result["preemptions"] = getattr(request, "preemptions", 0)
                if self.tokenizer is not None:
                    try:
                        result["text"] = self.tokenizer.decode(tokens)
                    except Exception:  # noqa: BLE001
                        pass
                self.completed += 1
            except Exception as exc:  # noqa: BLE001 - terminal failure:
                # commit anyway — an engine-failed generation redelivered
                # forever would wedge the lane behind one poisoned job
                result["ok"] = False
                result["error"] = str(exc)
                self.failed += 1
            self._publish_result(result)
            try:
                msg.commit()
            except Exception:  # noqa: BLE001
                pass
            self._obs.gauge("app_tpu_qos_lane_depth", self.depth())

    def _publish_result(self, result: Dict[str, Any]) -> None:
        try:
            self.broker.publish(self.result_topic,
                                json.dumps(result).encode("utf-8"))
        except Exception as exc:  # noqa: BLE001
            if self.logger is not None:
                try:
                    self.logger.errorf("qos lane result publish failed: %s",
                                       exc)
                except Exception:  # noqa: BLE001
                    pass

    # -- surface --------------------------------------------------------------
    def depth(self) -> int:
        return len(self._inflight) + (1 if self._held is not None else 0)

    def stats(self) -> Dict[str, Any]:
        return {"topic": self.topic, "result_topic": self.result_topic,
                "group": self.group, "inflight": len(self._inflight),
                "held": self._held is not None, "paused": self._paused(),
                "max_inflight": self.max_inflight,
                "submitted": self.submitted, "completed": self.completed,
                "failed": self.failed, "rejected": self.rejected,
                "retries": self.retries, "cron_ticks": self.cron_ticks}


def register_qos_metrics(metrics) -> None:
    """Idempotent registration of the reference's QoS series."""
    counters = [
        ("app_tpu_qos_submitted_total",
         "Requests entering the engine by QoS class"),
        ("app_tpu_qos_admitted_total",
         "Requests admitted to a slot by QoS class"),
        ("app_tpu_qos_shed_total",
         "Submits refused (503) by the QoS shed ladder, by class"),
        ("app_tpu_qos_preempted_total",
         "Running generations preempted (replay-requeued) by class"),
        ("app_tpu_qos_expired_total",
         "Queued requests failed past their class deadline budget"),
        ("app_tpu_qos_scaleout_requests_total",
         "Ladder escalations into request_replica: asks for the elastic "
         "autoscaler to add a replica before shedding starts"),
    ]
    gauges = [
        ("app_tpu_qos_shed_level",
         "QoS shed ladder level: 0 ok, 1 park batch, 2 preempt batch, "
         "3 request replica, 4 shed standard"),
        ("app_tpu_qos_goodput",
         "Fraction of recent completions that finished clean, by class"),
        ("app_tpu_qos_lane_depth",
         "Batch-lane jobs in flight (submitted, not yet committed)"),
    ]
    for name, desc in counters:
        try:
            if metrics.get(name) is None:
                metrics.new_counter(name, desc)
        except Exception:  # noqa: BLE001 - re-registration is benign
            pass
    for name, desc in gauges:
        try:
            if metrics.get(name) is None:
                metrics.new_gauge(name, desc)
        except Exception:  # noqa: BLE001
            pass


def install_routes(app, controller, path: str = "/debug/qos"):
    """GET /debug/qos: per-class queues, quotas and goodput, the ladder's
    state and transition trail, and the tenant counts."""

    @app.get(path)
    def qos_debug(ctx):  # noqa: ARG001 - handler signature
        return controller.snapshot()

    return app
