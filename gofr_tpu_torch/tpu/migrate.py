"""Replica lifecycle: ``Lifecycle`` and ``LIFECYCLE_STATES``.

Ports the lifecycle of ``gofr_tpu/tpu/migrate.py``. A replica boots
``warming``, serves as ``serving`` and leaves through ``draining``; the
state is advertised in ``/stats`` so routers stop sending new sessions to
a warming or draining replica. The port's engines start at ``serving``
and ``drain()`` moves them to ``draining``. Drain with migration
(``MigrationCoordinator``, ``POST /debug/drain``, ``POST /migrate``) and
the warm boot behind ``warming`` wait in ROADMAP A11f.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List

LIFECYCLE_STATES = ("warming", "serving", "draining")


class Lifecycle:
    """Thread-safe replica lifecycle state, advertised in the /stats
    fleet digest so routers gate routing on it:
    ``warming`` and ``draining`` replicas receive no new sessions."""

    def __init__(self, state: str = "serving", clock=time.monotonic):
        if state not in LIFECYCLE_STATES:
            raise ValueError(f"lifecycle state must be one of "
                             f"{LIFECYCLE_STATES}, got {state!r}")
        self._clock = clock
        self._lock = threading.Lock()
        self._state = state
        self._since = clock()
        self._trail: List[Dict[str, Any]] = []

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def to(self, state: str) -> bool:
        """Transition; False when already there. draining is terminal —
        a draining replica never un-drains (restart it instead: the
        generation bump tells routers it is a fresh boot)."""
        if state not in LIFECYCLE_STATES:
            raise ValueError(f"unknown lifecycle state {state!r}")
        with self._lock:
            if self._state == state or self._state == "draining":
                return False
            self._trail.append({"from": self._state, "to": state,
                                "t": self._clock()})
            self._state = state
            self._since = self._clock()
            return True

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self._state,
                    "since_s": round(self._clock() - self._since, 1),
                    "trail": list(self._trail)}
