"""Remote log-level updater: polls a URL and applies level changes live.

A copy of ``gofr_tpu/logging/remote.py``: ``_extract_level`` (the three
response shapes: ``{"data": [{"serviceName": ..., "logLevel": {"LOG_LEVEL":
"DEBUG"}}]}``, ``{"data": {"LOG_LEVEL": "DEBUG"}}`` and a bare ``"DEBUG"``
string), ``fetch_and_update_level`` (a 200 whose level differs from the
logger's calls ``Logger.change_level``; any failure is swallowed, remote
logging never breaks the app) and ``start_remote_level_updater`` (a daemon
thread polling every ``interval_s``). The container starts it under
REMOTE_LOG_URL, every REMOTE_LOG_FETCH_INTERVAL seconds.

Two differences: the fetch is ``urllib.request`` where the reference uses
``requests`` (not a dependency of the port), and the poller takes a stop
event, which ``Container.close`` sets, so an App's shutdown ends it.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Optional

from . import Logger, parse_level


def _extract_level(payload) -> Optional[str]:
    if isinstance(payload, str):
        return payload
    if isinstance(payload, dict):
        data = payload.get("data", payload)
        if isinstance(data, list) and data:
            data = data[0]
        if isinstance(data, dict):
            lvl = data.get("logLevel", data)
            if isinstance(lvl, dict):
                return lvl.get("LOG_LEVEL")
            if isinstance(lvl, str):
                return lvl
            return data.get("LOG_LEVEL")
    return None


def fetch_and_update_level(logger: Logger, url: str) -> None:
    try:
        with urllib.request.urlopen(url, timeout=3) as resp:
            if resp.status != 200:
                return
            body = resp.read().decode()
        name = _extract_level(json.loads(body))
        if not name:
            return
        new_level = parse_level(name, logger.level)
        if new_level != logger.level:
            logger.infof("LOG_LEVEL updated from %s to %s", logger.level.name,
                         new_level.name)
            logger.change_level(new_level)
    except Exception:  # noqa: BLE001 - remote logging must never break the app
        pass


def start_remote_level_updater(logger: Logger, url: str,
                               interval_s: float = 15.0,
                               stop: Optional[threading.Event] = None
                               ) -> threading.Thread:
    """Poll `url` now and every `interval_s` seconds until `stop` is set
    (never, without one). Returns the started daemon thread."""
    stop = stop if stop is not None else threading.Event()

    def loop() -> None:
        while not stop.is_set():
            fetch_and_update_level(logger, url)
            stop.wait(interval_s)

    t = threading.Thread(target=loop, name="remote-log-level", daemon=True)
    t.start()
    return t
