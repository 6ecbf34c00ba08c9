"""Capacity observatory, replica half: who consumes the device, and how
much load until it falls over.

A copy of ``gofr_tpu/tpu/meter.py``, whole: ``TPUMeter``,
``HeadroomForecaster``, ``register_meter_metrics`` and ``install_routes``
(``GET /debug/capacity``), wired by ``App.enable_capacity``:

  * **TPUMeter** — the attribution ledger. At every sync the engine stages
    the synced batch's rows; when the step ledger closes the iteration
    (``_finish_step``) the meter apportions that step's measured device
    time (the ledger's ``device_sync`` + ``dispatch`` segments) across the
    rows, weighted by the tokens each processed, and charges each row's
    analytic FLOPs (tpu/utilization.py's) and KV page-seconds (pages held x
    seconds since the row's previous sync). Per-request totals roll into
    per-(tenant, class) accounts, published as the
    ``app_tpu_meter_{device_seconds,flops,page_seconds,queue_seconds}_total
    {class,tenant,phase}`` counters. Conservation holds by construction:
    the weights sum to 1, so each step's attributed device-seconds sum to
    the step ledger's measured device segments.
  * **HeadroomForecaster** — arrival rate λ from an admission-door window
    (every ``engine.submit`` stamps one), service rate μ as tokens per
    device-busy second from the utilization ledger's window, ρ = λ/μ,
    headroom μ−λ, a fluid-model TTFT (base prefill service + backlog/μ) and
    a queueing-collapse warning (queue depth rising across consecutive
    evaluations while ρ is near 1). Published as the
    ``app_tpu_capacity_{rho,headroom_tok_s,predicted_ttft_ms,
    collapse_warning}`` gauges from the metrics scrape hook.

The tenant helpers ``_MAX_TENANTS``, ``_TENANT_OVERFLOW`` and
``effective_class`` are tpu/qos.py's, imported as the reference imports
them. The fleet half, the router's rollup of every replica's
``/debug/capacity`` and ``replicas_needed``, is ``fleet/capacity.py``.

Threading: ``account_step`` runs on the engine loop thread,
``note_arrival`` on submit threads, ``note_finished`` on the off-loop
finisher, ``snapshot`` / ``publish`` on handler and scrape threads: one
short lock each, O(rows) work, the metrics sink best-effort
(MetricsHook); ``engine.meter is None`` when disabled.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .obs import MetricsHook
from .qos import _MAX_TENANTS, _TENANT_OVERFLOW, effective_class
from .utilization import decode_flops, prefill_flops

DEFAULT_PAGE_TOKENS = 16      # dense engines: KV billed in 16-token pages
DEFAULT_WINDOW_S = 300.0      # bounded-window spend horizon
DEFAULT_DONE_CAPACITY = 512   # finished per-request rows retained
DEFAULT_STEPS_CAPACITY = 256  # per-step attribution rows retained
DEFAULT_TOP_K = 10            # tenants shown in the /debug/capacity table


class _RequestAccount:
    """Lifetime spend of one request, folded into its tenant account at
    the same instant it accrues — tenant totals always equal the sum of
    their request accounts, exactly."""

    __slots__ = ("id", "tenant", "cls", "device_s", "flops", "page_s",
                 "queue_s", "tokens", "first_seen", "last_seen",
                 "finished_at", "ok")

    def __init__(self, request_id: int, tenant: str, cls: str,
                 now: float) -> None:
        self.id = request_id
        self.tenant = tenant
        self.cls = cls
        self.device_s = 0.0
        self.flops = 0.0
        self.page_s = 0.0
        self.queue_s = 0.0
        self.tokens: Dict[str, int] = {}
        self.first_seen = now
        self.last_seen = now
        self.finished_at: Optional[float] = None
        self.ok: Optional[bool] = None

    def row(self) -> Dict[str, Any]:
        return {
            "id": self.id, "tenant": self.tenant, "class": self.cls,
            "device_s": round(self.device_s, 6),
            "flops": self.flops,
            "page_s": round(self.page_s, 6),
            "queue_s": round(self.queue_s, 6),
            "tokens": dict(self.tokens),
            "finished": self.finished_at is not None,
            "ok": self.ok,
        }


class _TenantAccount:
    """Lifetime + bounded-window spend of one (tenant, class) pair."""

    __slots__ = ("tenant", "cls", "device_s", "flops", "page_s",
                 "queue_s", "tokens", "requests", "finished", "window")

    def __init__(self, tenant: str, cls: str) -> None:
        self.tenant = tenant
        self.cls = cls
        self.device_s = 0.0
        self.flops = 0.0
        self.page_s = 0.0
        self.queue_s = 0.0
        self.tokens: Dict[str, int] = {}
        self.requests = 0
        self.finished = 0
        # bounded recent-spend window: (finished_at, device_s) per
        # finished request — the `_ClassLedger` rolling-window idiom
        self.window: "collections.deque" = collections.deque(maxlen=128)

    def row(self, now: float, window_s: float) -> Dict[str, Any]:
        recent = sum(d for t, d in self.window if now - t <= window_s)
        return {
            "tenant": self.tenant, "class": self.cls,
            "device_s": round(self.device_s, 6),
            "flops": self.flops,
            "page_s": round(self.page_s, 6),
            "queue_s": round(self.queue_s, 6),
            "tokens": dict(self.tokens),
            "requests": self.requests,
            "finished": self.finished,
            "window_device_s": round(recent, 6),
        }


class TPUMeter:
    """Per-tenant device-time / FLOPs / page-seconds attribution ledger
    (module docstring)."""

    def __init__(self, cfg=None, page_tokens: int = DEFAULT_PAGE_TOKENS,
                 window_s: float = DEFAULT_WINDOW_S,
                 done_capacity: int = DEFAULT_DONE_CAPACITY,
                 steps_capacity: int = DEFAULT_STEPS_CAPACITY,
                 top_k: int = DEFAULT_TOP_K,
                 metrics=None, logger=None) -> None:
        self.cfg = cfg
        self.page_tokens = max(1, int(page_tokens))
        self.window_s = max(1.0, float(window_s))
        self.top_k = max(1, int(top_k))
        self._obs = MetricsHook(metrics, logger=logger)
        self.logger = logger
        # forecaster ride-along: engine.submit calls note_arrival on the
        # ONE engine.meter attribute; the meter forwards
        self.forecaster: Optional["HeadroomForecaster"] = None
        self._lock = threading.Lock()
        self._live: Dict[int, _RequestAccount] = {}
        self._done: "collections.deque" = collections.deque(
            maxlen=max(16, int(done_capacity)))
        # late-attribution map: the off-loop finisher can fold a request
        # before the loop thread delivers the SAME step's staged rows
        # (note_finished races _finish_step). Keep finished accounts
        # addressable so the late share lands on the real account instead
        # of resurrecting a ghost in _live.
        self._recent_done: "collections.OrderedDict" = \
            collections.OrderedDict()
        # (tenant, class) -> account; tenant table bounded per class by
        # the qos overflow idiom so a tenant-id cardinality attack cannot
        # grow the ledger (or the metric label space) unbounded
        self._accounts: Dict[Tuple[str, str], _TenantAccount] = {}
        self._tenants_per_class: Dict[str, set] = {}
        # per-step attribution evidence ring: the conservation property
        # (attributed == ledger-measured device time) is checkable here
        self._steps: "collections.deque" = collections.deque(
            maxlen=max(16, int(steps_capacity)))
        self.steps_total = 0
        self.requests_total = 0

    def use_metrics(self, metrics) -> None:
        self._obs = MetricsHook(metrics, logger=self.logger)

    # -- label plumbing -------------------------------------------------------
    def _tenant_key(self, cls: str, tenant: str) -> str:
        """Bound the per-class tenant table at _MAX_TENANTS; excess
        tenants pool under the overflow label."""
        tenant = tenant or "-"
        table = self._tenants_per_class.setdefault(cls, set())
        if tenant not in table:
            if len(table) >= _MAX_TENANTS:
                return _TENANT_OVERFLOW
            table.add(tenant)
        return tenant

    def _account(self, tenant: str, cls: str) -> _TenantAccount:
        key = (tenant, cls)
        acct = self._accounts.get(key)
        if acct is None:
            acct = _TenantAccount(tenant, cls)
            self._accounts[key] = acct
        return acct

    # -- intake (engine hooks) ------------------------------------------------
    def note_arrival(self, request) -> None:
        """submit-side arrival stamp (caller threads): forwards to the
        forecaster's λ window. Best-effort — never raises into submit."""
        fc = self.forecaster
        if fc is not None:
            try:
                fc.note_arrival(len(request.prompt_tokens),
                                request.max_new_tokens)
            except Exception:  # noqa: BLE001 - accounting is best-effort
                pass

    def account_step(self, rec, phase: str, rows, queued=None) -> None:
        """One closed engine step (loop thread): apportion the step
        ledger's measured device time across the synced batch.

        rec     — the StepRecord `step_end` returned (segment timings)
        phase   — sync kind: prefill | verify | decode
        rows    — [(request, tokens_processed, kv_tokens_held)]
        queued  — [(request, queue_wait_s)] for first-service rows
        """
        if not rows and not queued:
            return
        now = time.monotonic()
        # the step's measured device time: what the device-facing
        # segments of THIS iteration cost, per the step ledger. wall_s
        # is the fallback for ledgers configured without segments.
        segs = getattr(rec, "segments", None) or {}
        device_s = segs.get("device_sync", 0.0) + segs.get("dispatch", 0.0)
        if device_s <= 0.0:
            device_s = getattr(rec, "wall_s", 0.0) or 0.0
        total_tokens = sum(max(0, t) for _, t, _ in rows)
        # per-(tenant, class) deltas batched into ONE counter bump per
        # family per step — the hot path stays O(rows), not O(rows·sinks)
        deltas: Dict[Tuple[str, str], List[float]] = {}
        with self._lock:
            self.steps_total += 1
            attributed = 0.0
            for request, tokens, kv_tokens in rows:
                acct = self._touch_locked(request, now)
                weight = (tokens / total_tokens) if total_tokens else (
                    1.0 / len(rows))
                share = device_s * weight
                attributed += share
                if phase == "prefill":
                    flops = prefill_flops(self.cfg, tokens) if self.cfg \
                        else 0.0
                else:
                    flops = decode_flops(self.cfg, 1, tokens) if self.cfg \
                        else 0.0
                # page-seconds accrue between consecutive metered syncs:
                # pages held × elapsed wall time since this row was last
                # billed (first sight bills zero — nothing was held yet)
                pages = math.ceil(max(0, kv_tokens) / self.page_tokens)
                page_s = pages * max(0.0, now - acct.last_seen)
                acct.last_seen = now
                acct.device_s += share
                acct.flops += flops
                acct.page_s += page_s
                acct.tokens[phase] = acct.tokens.get(phase, 0) + max(0,
                                                                     tokens)
                tacct = self._account(acct.tenant, acct.cls)
                tacct.device_s += share
                tacct.flops += flops
                tacct.page_s += page_s
                tacct.tokens[phase] = tacct.tokens.get(phase, 0) + max(
                    0, tokens)
                d = deltas.setdefault((acct.tenant, acct.cls),
                                      [0.0, 0.0, 0.0, 0.0])
                d[0] += share
                d[1] += flops
                d[2] += page_s
            for request, wait_s in queued or ():
                acct = self._touch_locked(request, now)
                wait_s = max(0.0, wait_s)
                acct.queue_s += wait_s
                tacct = self._account(acct.tenant, acct.cls)
                tacct.queue_s += wait_s
                d = deltas.setdefault((acct.tenant, acct.cls),
                                      [0.0, 0.0, 0.0, 0.0])
                d[3] += wait_s
            self._steps.append({
                "seq": getattr(rec, "seq", None), "phase": phase,
                "rows": len(rows), "tokens": total_tokens,
                "device_s": round(device_s, 9),
                "attributed_s": round(attributed, 9),
                "wall_s": round(getattr(rec, "wall_s", 0.0) or 0.0, 9),
            })
        for (tenant, cls), (dev, flops, page, queue) in deltas.items():
            labels = {"class": cls, "tenant": tenant, "phase": phase}
            if dev:
                self._obs.counter("app_tpu_meter_device_seconds_total",
                                  dev, **labels)
            if flops:
                self._obs.counter("app_tpu_meter_flops_total", flops,
                                  **labels)
            if page:
                self._obs.counter("app_tpu_meter_page_seconds_total",
                                  page, **labels)
            if queue:
                self._obs.counter("app_tpu_meter_queue_seconds_total",
                                  queue, **{"class": cls, "tenant": tenant,
                                            "phase": "queue"})
        fc = self.forecaster
        if fc is not None and phase == "prefill" and rows:
            # base TTFT service sample: what one prefill dispatch costs
            # at the current batch shape (the no-queue floor)
            fc.note_prefill(device_s)

    def _touch_locked(self, request, now: float) -> _RequestAccount:
        acct = self._live.get(request.id)
        if acct is None:
            acct = self._recent_done.get(request.id)
        if acct is None:
            cls = effective_class(request)
            tenant = self._tenant_key(cls, getattr(request, "tenant", ""))
            acct = _RequestAccount(request.id, tenant, cls, now)
            self._live[request.id] = acct
            self.requests_total += 1
            tacct = self._account(tenant, cls)
            tacct.requests += 1
        return acct

    def note_finished(self, request, ok: bool) -> None:
        """Fold a finished request's account into the done ring and its
        tenant's bounded window (finisher thread). Unknown ids (shed
        before any sync) are ignored — they consumed no device time."""
        now = time.monotonic()
        with self._lock:
            acct = self._live.pop(request.id, None)
            if acct is None:
                return
            acct.finished_at = now
            acct.ok = ok
            self._done.append(acct)
            self._recent_done[acct.id] = acct
            while len(self._recent_done) > (self._done.maxlen or 16):
                self._recent_done.popitem(last=False)
            tacct = self._account(acct.tenant, acct.cls)
            tacct.finished += 1
            tacct.window.append((now, acct.device_s))
        fc = self.forecaster
        if fc is not None:
            try:
                fc.note_finished(len(request.prompt_tokens),
                                 len(request.emitted))
            except Exception:  # noqa: BLE001 - accounting is best-effort
                pass

    # -- operator surface -----------------------------------------------------
    def snapshot(self, top_k: Optional[int] = None) -> Dict[str, Any]:
        """The GET /debug/capacity payload: totals, the top-K tenant
        table, per-(tenant, class) accounts, recent requests, per-step
        attribution evidence, and the forecaster readout."""
        now = time.monotonic()
        k = top_k if top_k is not None else self.top_k
        with self._lock:
            accounts = [acct.row(now, self.window_s)
                        for acct in self._accounts.values()]
            requests = [a.row() for a in self._live.values()]
            requests += [a.row() for a in list(self._done)[-32:]]
            steps = list(self._steps)[-32:]
            steps_total = self.steps_total
            requests_total = self.requests_total
        accounts.sort(key=lambda r: r["device_s"], reverse=True)
        tenants: Dict[str, Dict[str, Any]] = {}
        for row in accounts:
            t = tenants.setdefault(row["tenant"], {
                "device_s": 0.0, "flops": 0.0, "page_s": 0.0,
                "queue_s": 0.0, "requests": 0, "window_device_s": 0.0})
            for field in ("device_s", "flops", "page_s", "queue_s",
                          "requests", "window_device_s"):
                t[field] = round(t[field] + row[field], 6)
        top = sorted(tenants.items(), key=lambda kv: kv[1]["device_s"],
                     reverse=True)[:k]
        totals = {
            "device_s": round(sum(r["device_s"] for r in accounts), 6),
            "flops": sum(r["flops"] for r in accounts),
            "page_s": round(sum(r["page_s"] for r in accounts), 6),
            "queue_s": round(sum(r["queue_s"] for r in accounts), 6),
        }
        out: Dict[str, Any] = {
            "totals": totals,
            "tenants": [{"tenant": name, **row} for name, row in top],
            "accounts": accounts,
            "requests": requests,
            "steps": steps,
            "steps_total": steps_total,
            "requests_total": requests_total,
            "page_tokens": self.page_tokens,
            "window_s": self.window_s,
        }
        fc = self.forecaster
        if fc is not None:
            out["forecast"] = fc.evaluate(now)
        return out


class HeadroomForecaster:
    """λ/μ/ρ queueing readout + fluid TTFT prediction + collapse
    early-warning (module docstring)."""

    def __init__(self, engine=None, window_s: float = 60.0,
                 rho_warn: float = 0.85, collapse_evals: int = 3,
                 depth_warn: Optional[int] = None,
                 default_prompt_tokens: int = 128,
                 metrics=None, logger=None) -> None:
        self.engine = engine
        self.window_s = max(1.0, float(window_s))
        self.rho_warn = float(rho_warn)
        self.collapse_evals = max(2, int(collapse_evals))
        # depth corroboration for the collapse warning: a backlog this
        # many requests deep (two full batch waves) that is STILL
        # growing is saturation wherever the bottleneck sits — device-rho
        # alone is blind to a host- or scheduler-bound collapse
        if depth_warn is None:
            depth_warn = 2 * int(getattr(engine, "n_slots", 0) or 8)
        self.depth_warn = max(8, int(depth_warn))
        self.default_prompt_tokens = max(1, int(default_prompt_tokens))
        self._obs = MetricsHook(metrics, logger=logger)
        self.logger = logger
        self._lock = threading.Lock()
        # admission-door arrivals: (t, prompt_tokens, max_new)
        self._arrivals: "collections.deque" = collections.deque()
        self._created_at = time.monotonic()
        # EWMAs observed from served traffic (None until the first sample)
        self._ewma_prompt: Optional[float] = None
        self._ewma_decode: Optional[float] = None
        self._ewma_prefill_s: Optional[float] = None
        self._alpha = 0.2
        # collapse detector state: recent (t, queue_depth) eval samples
        self._depth_samples: "collections.deque" = collections.deque(
            maxlen=self.collapse_evals)
        self._collapse = False
        self.collapse_events = 0

    # -- intake ---------------------------------------------------------------
    def note_arrival(self, prompt_tokens: int, max_new_tokens: int) -> None:
        now = time.monotonic()
        with self._lock:
            self._arrivals.append((now, int(prompt_tokens),
                                   int(max_new_tokens)))
            self._prune_locked(now)

    def note_prefill(self, service_s: float) -> None:
        if service_s <= 0:
            return
        with self._lock:
            self._ewma_prefill_s = service_s if self._ewma_prefill_s is None \
                else (1 - self._alpha) * self._ewma_prefill_s \
                + self._alpha * service_s

    def note_finished(self, prompt_tokens: int, generated: int) -> None:
        with self._lock:
            self._ewma_prompt = float(prompt_tokens) \
                if self._ewma_prompt is None \
                else (1 - self._alpha) * self._ewma_prompt \
                + self._alpha * prompt_tokens
            self._ewma_decode = float(generated) \
                if self._ewma_decode is None \
                else (1 - self._alpha) * self._ewma_decode \
                + self._alpha * generated

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.window_s
        while self._arrivals and self._arrivals[0][0] < horizon:
            self._arrivals.popleft()

    # -- the model ------------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One λ/μ/ρ readout. Called on every scrape and on every
        /debug/capacity GET — pure host arithmetic over bounded state."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            self._prune_locked(now)
            span = max(1e-9, min(self.window_s, now - self._created_at))
            n = len(self._arrivals)
            lam_req = n / span
            decode_est = self._ewma_decode
            lam_tok = sum(
                p + (decode_est if decode_est is not None else m)
                for _, p, m in self._arrivals) / span
            prompt_est = self._ewma_prompt or float(
                self.default_prompt_tokens)
            base_s = self._ewma_prefill_s or 0.0
        mu_tok = None
        util = getattr(self.engine, "util", None)
        if util is not None:
            try:
                stats = util.window_stats(now=now)
                busy = stats.get("device_busy_s") or 0.0
                toks = sum((stats.get("tokens") or {}).values())
                if busy > 1e-6 and toks:
                    mu_tok = toks / busy
            except Exception:  # noqa: BLE001 - forecast over a dying
                pass           # engine must not take the scrape down
        depth = 0
        if self.engine is not None:
            try:
                depth = self.engine.queue_depth()
            except Exception:  # noqa: BLE001
                pass
        rho = (lam_tok / mu_tok) if mu_tok else 0.0
        headroom = max(0.0, mu_tok - lam_tok) if mu_tok else 0.0
        backlog_tokens = depth * prompt_est
        predicted_s = base_s + (backlog_tokens / mu_tok if mu_tok else 0.0)
        collapse = self._eval_collapse(now, depth, rho)
        return {
            "window_s": round(min(self.window_s, now - self._created_at), 3),
            "arrivals": n,
            "lambda_rps": round(lam_req, 4),
            "lambda_tok_s": round(lam_tok, 3),
            "mu_tok_s": round(mu_tok, 3) if mu_tok else None,
            "rho": round(rho, 4),
            "headroom_tok_s": round(headroom, 3),
            "queue_depth": depth,
            "backlog_tokens": round(backlog_tokens, 1),
            "base_prefill_s": round(base_s, 6),
            "predicted_ttft_ms": round(predicted_s * 1000.0, 3),
            "collapse_warning": collapse,
            "collapse_events": self.collapse_events,
        }

    def _eval_collapse(self, now: float, depth: int, rho: float) -> bool:
        """Sustained dq/dt > 0 while ρ→1: the queue is at a new high over
        the eval window AND the device has no headroom to drain it. Net
        growth, not strict monotonicity — a batch admission momentarily
        dips the depth without changing the trend, and an all-rising test
        would reset on every such dip and arm only after the symptom."""
        with self._lock:
            samples = self._depth_samples
            if not samples or now - samples[-1][0] >= 0.2:
                samples.append((now, depth))
            window = list(samples)
            rising = (len(window) == samples.maxlen
                      and window[-1][1] > window[-2][1]
                      and window[-1][1] > window[0][1])
            # depth measured dip-tolerantly over the last two looks, like
            # the rise test: one admission wave must not un-saturate it
            deep = max(w[1] for w in window[-2:]) if window else depth
            saturated = rho >= self.rho_warn or deep >= self.depth_warn
            collapse = bool(rising and saturated)
            if collapse and not self._collapse:
                self.collapse_events += 1
                if self.logger is not None:
                    try:
                        self.logger.warnf(
                            "capacity collapse warning: queue depth rising "
                            "across %d evals at rho=%.2f",
                            len(samples), rho)
                    except Exception:  # noqa: BLE001
                        pass
            self._collapse = collapse
            return collapse

    def publish(self, now: Optional[float] = None) -> None:
        """Scrape-hook re-eval: recompute the window so the gauges DECAY
        while the replica idles (λ→0 ⇒ ρ→0, headroom→μ window drains)."""
        stats = self.evaluate(now)
        self._obs.gauge("app_tpu_capacity_rho", stats["rho"])
        self._obs.gauge("app_tpu_capacity_headroom_tok_s",
                        stats["headroom_tok_s"])
        self._obs.gauge("app_tpu_capacity_predicted_ttft_ms",
                        stats["predicted_ttft_ms"])
        self._obs.gauge("app_tpu_capacity_collapse_warning",
                        1 if stats["collapse_warning"] else 0)


def register_meter_metrics(metrics) -> None:
    """Idempotent registration (the register_qos_metrics idiom)."""
    counters = [
        ("app_tpu_meter_device_seconds_total",
         "Attributed device time by tenant, QoS class and phase "
         "(token-weighted apportionment of the step ledger's device "
         "segments)"),
        ("app_tpu_meter_flops_total",
         "Attributed analytic FLOPs by tenant, QoS class and phase "
         "(2·P per token, the MFU convention)"),
        ("app_tpu_meter_page_seconds_total",
         "Attributed KV page-seconds by tenant, QoS class and phase "
         "(pages held x wall seconds between metered syncs)"),
        ("app_tpu_meter_queue_seconds_total",
         "Pre-admission queue wait by tenant and QoS class "
         "(phase=queue; first service only, replays excluded)"),
    ]
    gauges = [
        ("app_tpu_capacity_rho",
         "Utilization rho = token arrival rate / token service rate "
         "(>= 1 means the queue grows without bound)"),
        ("app_tpu_capacity_headroom_tok_s",
         "Token throughput headroom mu - lambda before saturation "
         "(what the replica can still absorb)"),
        ("app_tpu_capacity_predicted_ttft_ms",
         "Fluid-model TTFT forecast: base prefill service + queue "
         "backlog / service rate"),
        ("app_tpu_capacity_collapse_warning",
         "Queueing-collapse early warning: 1 while queue depth rises "
         "across consecutive evals with rho near 1"),
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


def install_routes(app, meter, path: str = "/debug/capacity") -> None:
    """GET /debug/capacity — attribution totals + top-K tenants + the
    headroom forecast."""

    @app.get(path)
    def capacity_debug(ctx):  # noqa: ARG001 - gofr handler signature
        return meter.snapshot()
