"""Per-request Context: the request, the container, the span and the deadline.

Counterpart of ``gofr_tpu/context.py`` (``Context``), cut to what the port's
handlers use: ``request``, ``container``, ``responder``, ``span`` (the
tracer middleware's server span), ``bind()``, the deadline
(``remaining()``, on the monotonic clock) and ``logger``, and the
reference's passthroughs to the request (``param``, ``path_param``,
``host_name``) and to the container (``config``, ``sql``, ``kv``,
``pubsub``, ``tpu``, the device client, ``publish``). A pub/sub message and a cron tick
are requests too (pubsub.Message, cron's empty request), so subscription
and cron handlers take the same Context.
"""

from __future__ import annotations

import json
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

    def bind(self, target: Any = None) -> Any:
        if target is None:
            return self.request.bind()
        return self.request.bind(target)

    def param(self, key: str) -> str:
        return self.request.param(key)

    def path_param(self, key: str) -> str:
        return self.request.path_param(key)

    def host_name(self) -> str:
        return self.request.host_name()

    def remaining(self) -> Optional[float]:
        """Seconds left before the request deadline; None when unbounded."""
        if self.deadline is None:
            return None
        return max(0.0, self.deadline - time.monotonic())

    @property
    def logger(self):
        return self.container.logger

    @property
    def config(self):
        return self.container.config

    @property
    def sql(self):
        return self.container.sql

    @property
    def kv(self):
        return self.container.kv

    @property
    def pubsub(self):
        return self.container.pubsub

    @property
    def tpu(self):
        """The container's device client (tpu/device.CUDAClient), or None;
        the reference's name, which handlers read."""
        return self.container.tpu

    def publish(self, topic: str, message: Any) -> None:
        """Publish on the container's broker: a dict or list goes as JSON,
        a str as UTF-8, bytes as they are."""
        pub = self.container.get_publisher()
        if pub is None:
            raise RuntimeError("no pub/sub backend configured (set "
                               "PUBSUB_BACKEND)")
        if isinstance(message, (dict, list)):
            message = json.dumps(message).encode()
        elif isinstance(message, str):
            message = message.encode()
        pub.publish(topic, message)
