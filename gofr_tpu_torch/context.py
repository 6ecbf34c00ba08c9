"""Per-request Context: the request, the container, the span and the deadline.

Counterpart of ``gofr_tpu/context.py`` (``Context``), cut to what the port's
handlers use: ``request``, ``container``, ``responder``, ``span`` (the
tracer middleware's server span), ``bind()``, the deadline
(``remaining()``, on the monotonic clock) and ``logger``. The rest of the
reference's passthroughs (``trace``, ``metrics``, the datasources' ``sql``,
``kv``, ``pubsub``, ``publish``) wait with the container's datasources in
ROADMAP A18b.
"""

from __future__ import annotations

import time
from typing import Any, Optional


class Context:
    def __init__(self, request: Any, container: Any = None,
                 responder: Any = None, deadline: Optional[float] = None):
        self.request = request
        self.container = container
        self.responder = responder
        # time.monotonic() at which the request times out; None: unbounded
        self.deadline = deadline
        self.span = getattr(request, "span", None)

    def bind(self) -> Any:
        return self.request.bind()

    def remaining(self) -> Optional[float]:
        """Seconds left before the request deadline; None when unbounded."""
        if self.deadline is None:
            return None
        return max(0.0, self.deadline - time.monotonic())

    @property
    def logger(self):
        return self.container.logger
