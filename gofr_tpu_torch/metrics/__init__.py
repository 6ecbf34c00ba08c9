"""Name-keyed metrics registry with Prometheus text exposition.

A copy of ``gofr_tpu/metrics/__init__.py``, whole: ``Counter``,
``UpDownCounter`` (exposed as a gauge), ``Gauge``, ``Histogram`` (``record``,
``record_n``, per-bucket exemplars, ``percentile`` from bucket midpoints),
``format_bucket_bound``, the ``Manager`` (``new_*`` registration,
``increment_counter`` .. ``record_histogram_n``, ``get``, ``expose``) with
its Prometheus text and OpenMetrics exposition (exemplars and ``# EOF``
only in the latter), and ``new_metrics_manager``. The same recordings
expose the same text as the reference's.

The serving engines' metric set (``app_tpu_*``) is registered on a Manager
by ``tpu/device.register_metrics``, the HTTP layer's (``app_http_response``
and the runtime gauges) by the container.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def format_bucket_bound(bound) -> str:
    """Canonical `le` label rendering, pinned by test_metrics:

      * +inf -> "+Inf"
      * integral values -> one decimal place ("1.0", not "1"), so an int
        bucket bound and its float twin can never emit two different
        series for the same bound
      * everything else -> shortest positional decimal, never exponent
        notation (repr's "1e-05" is expanded to "0.00001" — PromQL treats
        `le` as an opaque string, so "1e-05" and "0.00001" would be
        DIFFERENT series across clients that render differently)
    """
    v = float(bound)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return f"{int(v)}.0"
    s = repr(v)
    if "e" in s or "E" in s:
        from decimal import Decimal

        s = format(Decimal(s), "f")
    return s


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted(labels.items()))


class MetricError(Exception):
    pass


class DuplicateMetric(MetricError):
    def __init__(self, name: str):
        super().__init__(f"metric {name} already registered")


class MetricNotFound(MetricError):
    def __init__(self, name: str):
        super().__init__(f"metric {name} not registered")


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, desc: str):
        self.name = name
        self.desc = desc
        self.series: Dict[LabelKey, object] = {}
        self.lock = threading.Lock()

    def expose(self, openmetrics: bool = False) -> List[str]:  # pragma: no cover - interface
        raise NotImplementedError

    def _header(self) -> List[str]:
        return [f"# HELP {self.name} {self.desc}", f"# TYPE {self.name} {self.kind}"]


def _escape_label(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
    return "{" + inner + "}"


class Counter(_Instrument):
    kind = "counter"

    def add(self, value: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self.lock:
            self.series[key] = float(self.series.get(key, 0.0)) + value  # type: ignore[arg-type]

    def expose(self, openmetrics: bool = False) -> List[str]:
        # snapshot under the lock: a hot-loop add() inserting a NEW label
        # key during a scrape would otherwise mutate the dict mid-iteration
        # and 500 the /metrics endpoint
        with self.lock:
            series = list(self.series.items())
        out = self._header()
        for key, val in sorted(series):
            out.append(f"{self.name}{_fmt_labels(key)} {val}")
        return out


class UpDownCounter(Counter):
    kind = "gauge"  # prometheus has no updown counter; exposed as gauge


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        with self.lock:
            self.series[_label_key(labels)] = float(value)

    def expose(self, openmetrics: bool = False) -> List[str]:
        with self.lock:   # see Counter.expose
            series = list(self.series.items())
        out = self._header()
        for key, val in sorted(series):
            out.append(f"{self.name}{_fmt_labels(key)} {val}")
        return out


DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30)


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name: str, desc: str, buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, desc)
        self.buckets = sorted(buckets)

    def record(self, value: float,
               exemplar: Optional[Dict[str, Any]] = None,
               **labels: str) -> None:
        self.record_n(value, 1, exemplar=exemplar, **labels)

    def record_n(self, value: float, n: int,
                 exemplar: Optional[Dict[str, Any]] = None,
                 **labels: str) -> None:
        """Record `n` identical observations in one lock acquisition.

        The serving hot loop emits one TPOT sample per generated token; at
        thousands of tokens/sec the per-call dict lookup + lock dominates —
        a decode block's tokens all share one measured step time, so they
        batch losslessly.

        `exemplar` (optional, e.g. {"trace_id": ..., "request_id": ...})
        attaches a correlation handle to the bucket this value lands in,
        last-write-wins per bucket — the Dapper-style metrics→trace link.
        Stored exemplars surface ONLY in OpenMetrics exposition (scrapes
        negotiating `application/openmetrics-text`); classic Prometheus
        text output is byte-identical with or without them."""
        if n <= 0:
            return
        key = _label_key(labels)
        with self.lock:
            entry = self.series.get(key)
            if entry is None:
                entry = {"counts": [0] * (len(self.buckets) + 1), "sum": 0.0, "count": 0}
                self.series[key] = entry
            idx = bisect.bisect_left(self.buckets, value)
            entry["counts"][idx] += n  # type: ignore[index]
            entry["sum"] += value * n  # type: ignore[operator]
            entry["count"] += n  # type: ignore[operator]
            if exemplar:
                # per-bucket last-write-wins: one (labels, value, timestamp)
                # triple per bucket keeps memory O(buckets), and "most
                # recent offender" is exactly what a deep link should open
                entry.setdefault("exemplars", {})[idx] = (  # type: ignore[union-attr]
                    _label_key({k: str(v) for k, v in exemplar.items()}),
                    float(value), time.time())

    def percentile(self, q: float, **labels: str) -> float:
        """Approximate percentile from bucket MIDPOINTS (for tests/health,
        not SLO math): the percentile falls in bucket i, and the estimate
        is the midpoint of that bucket's (lower, upper] range — lower is 0
        for the first bucket. Observations past the last bound clamp to the
        last bound (the overflow bucket has no upper edge to average)."""
        key = _label_key(labels)
        with self.lock:
            entry = self.series.get(key)
            if not entry:
                return math.nan
            target = q * entry["count"]  # type: ignore[index]
            counts = list(entry["counts"])  # type: ignore[index]
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                if i >= len(self.buckets):
                    return self.buckets[-1]
                lower = self.buckets[i - 1] if i > 0 else 0.0
                return (lower + self.buckets[i]) / 2.0
        return self.buckets[-1]

    @staticmethod
    def _fmt_exemplar(ex: Tuple) -> str:
        """OpenMetrics exemplar suffix: ` # {labels} value timestamp`."""
        labels, value, ts = ex
        inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
        return f" # {{{inner}}} {value} {round(ts, 3)}"

    def expose(self, openmetrics: bool = False) -> List[str]:
        with self.lock:   # see Counter.expose — counts lists mutate in
            # place under record_n, so each entry is deep-copied here
            series = [(key, {"counts": list(entry["counts"]),  # type: ignore[index]
                             "sum": entry["sum"],              # type: ignore[index]
                             "count": entry["count"],          # type: ignore[index]
                             "exemplars": dict(entry.get("exemplars") or ())})  # type: ignore[union-attr]
                      for key, entry in self.series.items()]
        out = self._header()
        for key, entry in sorted(series):
            exemplars = entry["exemplars"] if openmetrics else {}
            cum = 0
            for i, bound in enumerate(self.buckets):
                cum += entry["counts"][i]  # type: ignore[index]
                lk = dict(key)
                lk["le"] = format_bucket_bound(bound)
                tail = (self._fmt_exemplar(exemplars[i])
                        if i in exemplars else "")
                out.append(f"{self.name}_bucket"
                           f"{_fmt_labels(_label_key(lk))} {cum}{tail}")
            cum += entry["counts"][-1]  # type: ignore[index]
            lk = dict(key)
            lk["le"] = "+Inf"
            overflow = len(self.buckets)
            tail = (self._fmt_exemplar(exemplars[overflow])
                    if overflow in exemplars else "")
            out.append(f"{self.name}_bucket"
                       f"{_fmt_labels(_label_key(lk))} {cum}{tail}")
            out.append(f"{self.name}_sum{_fmt_labels(key)} {entry['sum']}")  # type: ignore[index]
            out.append(f"{self.name}_count{_fmt_labels(key)} {entry['count']}")  # type: ignore[index]
        return out


class Manager:
    """The 8-method metrics manager handed to user handlers via ctx.metrics()."""

    def __init__(self, logger=None):
        self._store: Dict[str, _Instrument] = {}
        self._lock = threading.Lock()
        self._logger = logger

    def _register(self, inst: _Instrument) -> None:
        with self._lock:
            if inst.name in self._store:
                err = DuplicateMetric(inst.name)
                if self._logger is not None:
                    self._logger.error(str(err))
                    return
                raise err
            self._store[inst.name] = inst

    def _get(self, name: str, kind: type) -> _Instrument:
        inst = self._store.get(name)
        if inst is None or not isinstance(inst, kind):
            err = MetricNotFound(name)
            if self._logger is not None:
                self._logger.error(str(err))
                return kind(name, "unregistered")  # inert throwaway
            raise err
        return inst

    # -- registration --------------------------------------------------------
    def new_counter(self, name: str, desc: str) -> None:
        self._register(Counter(name, desc))

    def new_updown_counter(self, name: str, desc: str) -> None:
        self._register(UpDownCounter(name, desc))

    def new_gauge(self, name: str, desc: str) -> None:
        self._register(Gauge(name, desc))

    def new_histogram(self, name: str, desc: str, buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        self._register(Histogram(name, desc, buckets))

    # -- recording -----------------------------------------------------------
    def increment_counter(self, name: str, value: float = 1.0, **labels: str) -> None:
        self._get(name, Counter).add(value, **labels)  # type: ignore[attr-defined]

    def delta_updown_counter(self, name: str, value: float, **labels: str) -> None:
        self._get(name, UpDownCounter).add(value, **labels)  # type: ignore[attr-defined]

    def set_gauge(self, name: str, value: float, **labels: str) -> None:
        self._get(name, Gauge).set(value, **labels)  # type: ignore[attr-defined]

    def record_histogram(self, name: str, value: float,
                         exemplar: Optional[Dict[str, Any]] = None,
                         **labels: str) -> None:
        self._get(name, Histogram).record(value, exemplar=exemplar, **labels)  # type: ignore[attr-defined]

    def record_histogram_n(self, name: str, value: float, n: int,
                           exemplar: Optional[Dict[str, Any]] = None,
                           **labels: str) -> None:
        self._get(name, Histogram).record_n(value, n, exemplar=exemplar, **labels)  # type: ignore[attr-defined]

    # -- introspection -------------------------------------------------------
    def get(self, name: str) -> Optional[_Instrument]:
        return self._store.get(name)

    def expose(self, openmetrics: bool = False) -> str:
        """Render the whole registry in Prometheus text exposition format.

        openmetrics=True renders the OpenMetrics dialect instead: the same
        lines plus per-bucket histogram exemplars and the terminating
        `# EOF` marker — what a scrape negotiating
        `Accept: application/openmetrics-text` gets. Classic output never
        carries exemplars (Prometheus' text parser rejects them)."""
        lines: List[str] = []
        with self._lock:
            instruments = list(self._store.values())
        for inst in sorted(instruments, key=lambda i: i.name):
            lines.extend(inst.expose(openmetrics=openmetrics))
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


def new_metrics_manager(logger=None) -> Manager:
    return Manager(logger=logger)
