"""Leveled structured logger: pretty-colored on terminals, JSON lines otherwise.

A copy of ``gofr_tpu/logging/__init__.py``: ``Level`` (DEBUG..FATAL),
``parse_level``, ``PrettyPrint``, ``Logger`` (the 15-method surface:
``debug``/``debugf`` .. ``fatal``/``fatalf``, ``log``/``logf``,
``change_level``; one JSON line per record, or a colored line on a
terminal), ``new_logger``, ``new_file_logger`` and ``MockLogger``. The
``REMOTE_LOG_URL`` level poller is ``logging/remote.py``.

Every import in the port is package-relative or absolute to
``gofr_tpu_torch``, so this package never shadows the stdlib ``logging``.
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import time
from enum import IntEnum
from typing import Any, Optional, TextIO


class Level(IntEnum):
    DEBUG = 1
    INFO = 2
    NOTICE = 3
    WARN = 4
    ERROR = 5
    FATAL = 6

    @property
    def color(self) -> int:
        return {
            Level.DEBUG: 36,   # cyan
            Level.INFO: 32,    # green
            Level.NOTICE: 35,  # magenta
            Level.WARN: 33,    # yellow
            Level.ERROR: 31,   # red
            Level.FATAL: 31,
        }[self]


def parse_level(name: str, default: "Level" = Level.INFO) -> Level:
    try:
        return Level[name.strip().upper()]
    except (KeyError, AttributeError):
        return default


class PrettyPrint:
    """Objects implementing this render their own terminal line (logger.go:17-19)."""

    def pretty_print(self, fp: TextIO) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class Logger:
    """Leveled logger writing to normal_out (<= NOTICE) or error_out (>= WARN)."""

    def __init__(
        self,
        level: Level = Level.INFO,
        normal_out: Optional[TextIO] = None,
        error_out: Optional[TextIO] = None,
        is_terminal: Optional[bool] = None,
    ):
        self.level = level
        self.normal_out = normal_out if normal_out is not None else sys.stdout
        self.error_out = error_out if error_out is not None else sys.stderr
        if is_terminal is None:
            try:
                is_terminal = self.normal_out.isatty()
            except (AttributeError, ValueError):
                is_terminal = False
        self.is_terminal = is_terminal
        self._lock = threading.Lock()

    # -- core ---------------------------------------------------------------
    def _log(self, level: Level, *args: Any) -> None:
        if level < self.level:
            return
        out = self.error_out if level >= Level.WARN else self.normal_out
        now = time.time()
        with self._lock:
            try:
                if self.is_terminal:
                    self._pretty(out, level, now, args)
                else:
                    self._json(out, level, now, args)
                out.flush()
            except (OSError, ValueError):
                pass

    def _pretty(self, out: TextIO, level: Level, now: float, args: tuple) -> None:
        ts = time.strftime("%H:%M:%S", time.localtime(now))
        out.write(f"\x1b[{level.color}m{level.name:<6}\x1b[0m [{ts}] ")
        for a in args:
            if isinstance(a, PrettyPrint):
                a.pretty_print(out)
            elif isinstance(a, (dict, list)):
                out.write(json.dumps(a, default=str))
            else:
                out.write(str(a))
            out.write(" ")
        out.write("\n")

    def _json(self, out: TextIO, level: Level, now: float, args: tuple) -> None:
        msg: Any
        rendered = []
        for a in args:
            if isinstance(a, PrettyPrint):
                buf = io.StringIO()
                a.pretty_print(buf)
                rendered.append(buf.getvalue().strip())
            else:
                rendered.append(a)
        if len(rendered) == 1:
            msg = rendered[0]
        else:
            msg = " ".join(str(r) for r in rendered)
        record = {"level": level.name, "time": now, "message": msg}
        out.write(json.dumps(record, default=str) + "\n")

    # -- public API (reference Logger 15-method surface) --------------------
    def debug(self, *args: Any) -> None:
        self._log(Level.DEBUG, *args)

    def debugf(self, fmt: str, *args: Any) -> None:
        self._log(Level.DEBUG, fmt % args if args else fmt)

    def info(self, *args: Any) -> None:
        self._log(Level.INFO, *args)

    def infof(self, fmt: str, *args: Any) -> None:
        self._log(Level.INFO, fmt % args if args else fmt)

    def notice(self, *args: Any) -> None:
        self._log(Level.NOTICE, *args)

    def noticef(self, fmt: str, *args: Any) -> None:
        self._log(Level.NOTICE, fmt % args if args else fmt)

    def warn(self, *args: Any) -> None:
        self._log(Level.WARN, *args)

    def warnf(self, fmt: str, *args: Any) -> None:
        self._log(Level.WARN, fmt % args if args else fmt)

    def error(self, *args: Any) -> None:
        self._log(Level.ERROR, *args)

    def errorf(self, fmt: str, *args: Any) -> None:
        self._log(Level.ERROR, fmt % args if args else fmt)

    def fatal(self, *args: Any) -> None:
        self._log(Level.FATAL, *args)
        raise SystemExit(1)

    def fatalf(self, fmt: str, *args: Any) -> None:
        self.fatal(fmt % args if args else fmt)

    def log(self, *args: Any) -> None:
        self._log(Level.INFO, *args)

    def logf(self, fmt: str, *args: Any) -> None:
        self.infof(fmt, *args)

    def change_level(self, level: Level) -> None:
        self.level = level


def new_logger(level: Level = Level.INFO) -> Logger:
    return Logger(level=level)


def new_file_logger(path: str, level: Level = Level.INFO) -> Logger:
    """CMD apps log to a file (logger.go:177-196). Caller owns the file's lifetime."""
    fp = open(path, "a", encoding="utf-8")  # noqa: SIM115 - long-lived sink
    return Logger(level=level, normal_out=fp, error_out=fp, is_terminal=False)


class MockLogger(Logger):
    """Captures log records for assertions. Parity: logging/mock_logger.go."""

    def __init__(self, level: Level = Level.DEBUG):
        self.buffer = io.StringIO()
        super().__init__(level=level, normal_out=self.buffer, error_out=self.buffer, is_terminal=False)

    def output(self) -> str:
        return self.buffer.getvalue()
