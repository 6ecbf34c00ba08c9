"""Shared best-effort metric recording for the serving engines.

A copy of ``gofr_tpu/tpu/obs.py``, whole: ``MetricsHook`` (``counter``,
``gauge``, ``hist``, ``hist_n``) and ``DROPPED_METRIC``. Metric failures
(an unregistered name in a bare Manager, say) must never take down the
serving loop, so every call swallows errors, but never silently: each
swallowed failure increments ``app_obs_dropped_metrics_total{name}``
(registered on demand on the same manager) and logs once per name at
debug. With ``metrics=None`` every call is one attribute check.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

DROPPED_METRIC = "app_obs_dropped_metrics_total"


class MetricsHook:
    def __init__(self, metrics=None, logger=None):
        self.metrics = metrics
        self.logger = logger
        # names already logged as dropped — once per name keeps a hot loop
        # recording a bad name from flooding the log at dispatch rate
        self._drop_logged: set = set()

    def _dropped(self, name: str, exc: BaseException) -> None:
        """Count (and once, log) a swallowed recording failure. Best-effort
        squared: a failure HERE is swallowed for real — the drop counter
        registers itself on first use, so the only way to lose a drop is a
        manager too broken to register a counter."""
        m = self.metrics
        try:
            inst = m.get(DROPPED_METRIC)
            if inst is None:
                m.new_counter(
                    DROPPED_METRIC,
                    "metric recordings swallowed by best-effort hooks, "
                    "by metric name (a non-zero series is a wiring bug)")
                inst = m.get(DROPPED_METRIC)
            # direct instrument add: increment_counter(name=...) would
            # collide with the method's own `name` parameter
            inst.add(1.0, name=name)
        except Exception:  # noqa: BLE001 - self-observability stays best-effort
            pass
        if name not in self._drop_logged:
            self._drop_logged.add(name)
            if self.logger is not None:
                try:
                    self.logger.debugf("metric %s dropped: %s", name, exc)
                except Exception:  # noqa: BLE001
                    pass

    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        if self.metrics is not None:
            try:
                self.metrics.increment_counter(name, value, **labels)
            except Exception as exc:  # noqa: BLE001
                self._dropped(name, exc)

    def gauge(self, name: str, value, **labels) -> None:
        if self.metrics is not None:
            try:
                self.metrics.set_gauge(name, value, **labels)
            except Exception as exc:  # noqa: BLE001
                self._dropped(name, exc)

    def hist(self, name: str, value,
             exemplar: Optional[Dict[str, Any]] = None, **labels) -> None:
        # exemplar rides only when present so duck-typed managers without
        # the kwarg (test fakes, adapters) keep working unchanged
        if self.metrics is not None:
            try:
                if exemplar is not None:
                    self.metrics.record_histogram(name, value,
                                                  exemplar=exemplar, **labels)
                else:
                    self.metrics.record_histogram(name, value, **labels)
            except Exception as exc:  # noqa: BLE001
                self._dropped(name, exc)

    def hist_n(self, name: str, value, n: int,
               exemplar: Optional[Dict[str, Any]] = None, **labels) -> None:
        """n identical observations in one call (hot-loop batching)."""
        if self.metrics is not None:
            try:
                if exemplar is not None:
                    self.metrics.record_histogram_n(name, value, n,
                                                    exemplar=exemplar,
                                                    **labels)
                else:
                    self.metrics.record_histogram_n(name, value, n, **labels)
            except Exception as exc:  # noqa: BLE001
                self._dropped(name, exc)
