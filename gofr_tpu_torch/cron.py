"""Cron scheduler: 5-field spec parser + 1-second-resolution minute ticker.

Ports ``gofr_tpu/cron.py`` whole: ``CronParseError``, ``Schedule``
(the 5-field spec) and ``Crontab`` (the minute ticker at 1-second
resolution).

Parity: reference pkg/gofr/cron.go — parser supporting wildcards, steps (*/5),
ranges (1-5), lists (1,3,5) (:86-216); a ticker fires due jobs in their own
threads with a fresh root span and a no-op Request (:218-278, 326-347);
AddJob validation (:281-295).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Set

from .context import Context

FIELD_RANGES = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]  # min hour dom month dow


class CronParseError(ValueError):
    pass


def _parse_field(field: str, lo: int, hi: int) -> Set[int]:
    out: Set[int] = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, _, step_s = part.partition("/")
            try:
                step = int(step_s)
            except ValueError as exc:
                raise CronParseError(f"invalid step {step_s!r}") from exc
            if step <= 0:
                raise CronParseError(f"invalid step {step}")
        if part in ("*", ""):
            start, end = lo, hi
        elif "-" in part:
            a, _, b = part.partition("-")
            try:
                start, end = int(a), int(b)
            except ValueError as exc:
                raise CronParseError(f"invalid range {part!r}") from exc
        else:
            try:
                start = end = int(part)
            except ValueError as exc:
                raise CronParseError(f"invalid value {part!r}") from exc
        if start < lo or end > hi or start > end:
            raise CronParseError(f"value {part!r} out of range [{lo},{hi}]")
        out.update(range(start, end + 1, step))
    return out


class Schedule:
    def __init__(self, spec: str):
        fields = spec.split()
        if len(fields) != 5:
            raise CronParseError(f"cron spec must have 5 fields, got {len(fields)}")
        self.minutes, self.hours, self.days, self.months, self.weekdays = (
            _parse_field(f, lo, hi) for f, (lo, hi) in zip(fields, FIELD_RANGES))

    def matches(self, t: Optional[time.struct_time] = None) -> bool:
        t = t or time.localtime()
        dow = (t.tm_wday + 1) % 7  # python: Mon=0; cron: Sun=0
        return (t.tm_min in self.minutes and t.tm_hour in self.hours
                and t.tm_mday in self.days and t.tm_mon in self.months
                and dow in self.weekdays)


class _NoopRequest:
    """The empty Request cron handlers receive (cron.go:326-347)."""

    def param(self, key: str) -> str:
        return ""

    def path_param(self, key: str) -> str:
        return ""

    def host_name(self) -> str:
        return "cron://"

    def bind(self, target=None):
        return target if target is not None else {}


class Crontab:
    def __init__(self, container):
        self.container = container
        self.jobs: List[tuple] = []  # (name, Schedule, fn)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_job(self, spec: str, name: str, fn: Callable[[Context], None]) -> None:
        schedule = Schedule(spec)  # raises CronParseError on a bad spec
        with self._lock:
            self.jobs.append((name, schedule, fn))

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, name="cron", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        last_minute = -1
        while not self._stop.is_set():
            now = time.localtime()
            if now.tm_min != last_minute:
                last_minute = now.tm_min
                self._tick(now)
            self._stop.wait(1.0)

    def _tick(self, now: time.struct_time) -> None:
        with self._lock:
            due = [(name, fn) for name, sched, fn in self.jobs if sched.matches(now)]
        for name, fn in due:
            threading.Thread(target=self._run_job, args=(name, fn),
                             name=f"cron-{name}", daemon=True).start()

    def _run_job(self, name: str, fn) -> None:
        container = self.container
        span = None
        if container.tracer is not None:
            span = container.tracer.start_span(f"cron {name}")
        request = _NoopRequest()
        request.span = span
        ctx = Context(request=request, container=container)
        try:
            fn(ctx)
        except Exception as exc:  # noqa: BLE001 - a failing job must not kill cron
            container.logger.errorf("cron job %s failed: %s", name, exc)
            if span is not None:
                span.set_status(False, str(exc))
        finally:
            if span is not None:
                span.end()
