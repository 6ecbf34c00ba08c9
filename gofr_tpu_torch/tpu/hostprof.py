"""Always-on host sampling profiler: which Python frames eat the loop.

A copy of ``gofr_tpu/tpu/hostprof.py``, whole: ``HostProfiler``,
``register_hostprof_metrics`` and ``install_routes``
(``GET /debug/hostprof``). The step ledger (tpu/stepledger.py) measures how
much host time each engine iteration burns; this attributes it to code,
with the standard library only:

  * a daemon thread, ``hostprof-sampler``, wakes at ``HOSTPROF_HZ``
    (default 50) and walks ``sys._current_frames()``: one bounded dict read
    plus frame traversal, no tracing hooks, no slowdown between samples;
  * each sampled thread is classified by its name, then by the ownership
    registry (tpu/ownership.py): ``llm-engine`` (the engine's loop
    thread), or any stack holding a ``@loop_only`` function, is the loop;
    ``llm-finisher`` the finisher (the engine's off-loop teardown);
    the HTTP server's threads (``http-server-{port}`` and the
    ``Thread-N`` handler threads of ``ThreadingHTTPServer``,
    http/server.py) ``http``; everything else ``other``;
  * per-class collapsed stacks (``root;caller;leaf``) aggregate into a
    bounded dict (``max_stacks`` per class, overflow counted);
  * the sampler measures its own cost (the wall time inside sampling
    iterations) and reports it, and a duty-cycle governor stretches its
    interval so that cost stays under ``overhead_budget``.

``GET /debug/hostprof`` gives per-class top stacks, sample counts and the
measured self-overhead; ``?collapsed=1`` the raw flamegraph text.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Dict, List, Optional

from .obs import MetricsHook
from .ownership import LOOP_ONLY_REGISTRY

DEFAULT_HZ = 50.0
DEFAULT_MAX_STACKS = 256
DEFAULT_TOP_K = 5
MAX_DEPTH = 32
# the duty-cycle governor's ceiling on self_s/wall: when a sample gets
# expensive (many live threads, GIL contention) the sampler stretches its
# interval so the measured share converges below this, half the 2%
# always-on acceptance bound
OVERHEAD_BUDGET = 0.01

CLASSES = ("loop", "finisher", "http", "other")


class HostProfiler:
    """Bounded collapsed-stack sampler over ``sys._current_frames()``.

    start()/stop() follow the MemorySampler idiom (tpu/utilization.py):
    a daemon thread parked on an Event, stopped by App.on_shutdown.
    ``snapshot()`` is safe from any thread; aggregation state is guarded
    by one short lock the sampler holds only while folding a sample."""

    def __init__(self, hz: float = DEFAULT_HZ,
                 max_stacks: int = DEFAULT_MAX_STACKS,
                 top_k: int = DEFAULT_TOP_K, max_depth: int = MAX_DEPTH,
                 overhead_budget: float = OVERHEAD_BUDGET,
                 metrics=None, logger=None):
        self.hz = max(0.1, float(hz))
        self.interval_s = 1.0 / self.hz
        self.overhead_budget = max(1e-4, float(overhead_budget))
        self.max_stacks = max(8, int(max_stacks))
        self.top_k = max(1, int(top_k))
        self.max_depth = max(4, int(max_depth))
        self._obs = MetricsHook(metrics, logger=logger)
        self.logger = logger
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # class -> {collapsed stack -> samples}, bounded per class
        self._stacks: Dict[str, Dict[str, int]] = {c: {} for c in CLASSES}
        self._class_samples: Dict[str, int] = {c: 0 for c in CLASSES}
        self._dropped: Dict[str, int] = {c: 0 for c in CLASSES}
        self.samples_total = 0
        self._self_s = 0.0
        self._cost_ema = 0.0      # EMA of per-sample cost, feeds the governor
        self._throttled = 0       # intervals the governor stretched
        self._interval_eff = self.interval_s
        self._started_mono: Optional[float] = None

    def use_metrics(self, metrics) -> None:
        if metrics is not None:
            self._obs = MetricsHook(metrics, logger=self.logger)

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._started_mono = time.monotonic()
        self._thread = threading.Thread(target=self._run,
                                        name="hostprof-sampler",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout_s: float = 2.0) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout_s)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        while not self._stop.wait(self._next_interval()):
            try:
                self.sample_once()
            except Exception as exc:  # noqa: BLE001 - keep sampling
                if self.logger is not None:
                    try:
                        self.logger.debugf("hostprof sample failed: %s",
                                           exc)
                    except Exception:  # noqa: BLE001
                        pass

    def _next_interval(self) -> float:
        """Duty-cycle governor: the sleep that keeps steady-state
        self-overhead at or below the budget even when one sample is
        expensive (many live threads, a contended GIL). At the configured
        hz the duty cycle is cost/interval; when that exceeds the budget,
        stretch the interval so cost/interval == budget."""
        with self._lock:
            cost = self._cost_ema
        wait = self.interval_s
        if cost > 0.0:
            wait = max(wait, cost / self.overhead_budget)
        with self._lock:
            if wait > self.interval_s * 1.01:
                self._throttled += 1
            self._interval_eff = wait
        return wait

    # -- sampling -------------------------------------------------------------
    def _classify(self, name: str, stack: List[str]) -> str:
        if name.startswith("llm-engine"):
            return "loop"
        if name.startswith("llm-finisher"):
            return "finisher"
        if name.startswith(("http-server", "Thread-", "grpc-")):
            return "http"
        # ownership registry fallback: a renamed/embedded engine loop is
        # still recognizable by the @loop_only functions on its stack
        if any(frame in LOOP_ONLY_REGISTRY for frame in stack):
            return "loop"
        return "other"

    def sample_once(self) -> None:
        """One sampling iteration (public so tests can drive the
        aggregation deterministically without the timer thread)."""
        t0 = time.monotonic()
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()  # noqa: SLF001 - the documented profiler API
        folded: List[tuple] = []
        for ident, frame in frames.items():
            if ident == me:
                continue  # never profile the profiler
            stack: List[str] = []
            f = frame
            while f is not None and len(stack) < self.max_depth:
                code = f.f_code
                qual = getattr(code, "co_qualname", code.co_name)
                stack.append(f"{f.f_globals.get('__name__', '?')}.{qual}")
                f = f.f_back
            stack.reverse()  # root-first, the collapsed-stack convention
            cls = self._classify(names.get(ident, ""), stack)
            folded.append((cls, ";".join(stack)))
        del frames  # frame refs pin entire stacks; drop them eagerly
        with self._lock:
            for cls, collapsed in folded:
                self._class_samples[cls] += 1
                bucket = self._stacks[cls]
                if collapsed in bucket:
                    bucket[collapsed] += 1
                elif len(bucket) < self.max_stacks:
                    bucket[collapsed] = 1
                else:
                    self._dropped[cls] += 1
            self.samples_total += 1
            dt = time.monotonic() - t0
            self._self_s += dt
            self._cost_ema = (dt if self._cost_ema == 0.0
                              else 0.2 * dt + 0.8 * self._cost_ema)
        self._obs.counter("app_tpu_hostprof_samples_total")

    # -- read-out -------------------------------------------------------------
    def _top_locked(self, cls: str, k: int) -> List[Dict[str, Any]]:
        ranked = sorted(self._stacks[cls].items(), key=lambda kv: -kv[1])
        return [{"stack": stack, "samples": count}
                for stack, count in ranked[:k]]

    def top_loop_stacks(self, k: Optional[int] = None) -> List[Dict[str, Any]]:
        """Top-K loop-thread collapsed stacks (the incident-bundle embed:
        what WAS the engine loop doing)."""
        with self._lock:
            return self._top_locked("loop", k or self.top_k)

    def collapsed(self, per_class: int = 64) -> str:
        """Flamegraph-tool text: one ``class;frame;frame count`` line per
        aggregated stack, heaviest first per class."""
        with self._lock:
            lines = [f"{cls};{entry['stack']} {entry['samples']}"
                     for cls in CLASSES
                     for entry in self._top_locked(cls, per_class)]
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self, top_k: Optional[int] = None) -> Dict[str, Any]:
        """The /debug/hostprof payload: per-class sample counts + top
        stacks, plus the sampler's measured self-overhead — reported by
        the sampler itself so its cost is never a matter of faith."""
        k = top_k or self.top_k
        now = time.monotonic()
        with self._lock:
            wall = (max(1e-9, now - self._started_mono)
                    if self._started_mono is not None else 0.0)
            threads = {cls: {
                "samples": self._class_samples[cls],
                "distinct_stacks": len(self._stacks[cls]),
                "dropped_stacks": self._dropped[cls],
                "top": self._top_locked(cls, k),
            } for cls in CLASSES}
            overhead = {
                "self_s": round(self._self_s, 6),
                "share": (round(self._self_s / wall, 6) if wall else 0.0),
                "budget": self.overhead_budget,
                "interval_s": round(self._interval_eff, 6),
                "throttled": self._throttled,
            }
            samples_total = self.samples_total
        self._obs.gauge("app_tpu_hostprof_overhead_share",
                        overhead["share"])
        return {
            "hz": self.hz,
            "running": self.running,
            "samples_total": samples_total,
            "wall_s": round(wall, 3),
            "max_stacks": self.max_stacks,
            "overhead": overhead,
            "threads": threads,
        }


def register_hostprof_metrics(metrics) -> None:
    """Idempotent registration (the register_step_metrics idiom)."""
    try:
        if metrics.get("app_tpu_hostprof_samples_total") is None:
            metrics.new_counter(
                "app_tpu_hostprof_samples_total",
                "host sampling-profiler iterations taken")
    except Exception:  # noqa: BLE001 - already registered
        pass
    try:
        if metrics.get("app_tpu_hostprof_overhead_share") is None:
            metrics.new_gauge(
                "app_tpu_hostprof_overhead_share",
                "fraction of wall-clock the sampler spent sampling "
                "(its measured self-overhead)")
    except Exception:  # noqa: BLE001
        pass


def install_routes(app, profiler: HostProfiler,
                   path: str = "/debug/hostprof") -> None:
    """Register GET /debug/hostprof on an App. ``?collapsed=1``
    returns the raw flamegraph text instead of the JSON snapshot."""
    from ..http.responder import Response

    @app.get(path)
    def debug_hostprof(ctx):  # noqa: ANN001
        if (ctx.request.param("collapsed") or "") in ("1", "true"):
            return Response(
                status=200,
                headers={"Content-Type": "text/plain; charset=utf-8"},
                body=profiler.collapsed().encode())
        try:
            top_k = int(ctx.request.param("top") or 0)
        except (TypeError, ValueError):
            top_k = 0
        return profiler.snapshot(top_k=top_k or None)
