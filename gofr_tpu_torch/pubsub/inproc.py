"""In-process broker with per-(topic, group) committed offsets.

Ports ``gofr_tpu/pubsub/inproc.py`` whole: ``InProcBroker``.

Semantics mirror a Kafka consumer group for the single-process case
(reference kafka/kafka.go:140-218): messages are appended to a per-topic log;
each (topic, group) has a committed offset; `subscribe` returns the next
uncommitted message and only advances the offset when the handler commits
(subscriber.go:51-53). Uncommitted messages are redelivered.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..datasource import Health, STATUS_UP
from . import Client, Message, PubSubLog


class InProcBroker(Client):
    def __init__(self, config=None, logger=None, metrics=None):
        self.logger = logger
        self.metrics = metrics
        self._topics: Dict[str, List[Tuple[str, bytes, float]]] = {}
        self._offsets: Dict[Tuple[str, str], int] = {}   # committed
        self._inflight: Dict[Tuple[str, str], int] = {}  # delivered-not-committed
        self._cond = threading.Condition()

    def create_topic(self, topic: str) -> None:
        with self._cond:
            self._topics.setdefault(topic, [])

    def delete_topic(self, topic: str) -> None:
        with self._cond:
            self._topics.pop(topic, None)
            for key in [k for k in self._offsets if k[0] == topic]:
                self._offsets.pop(key)
                self._inflight.pop(key, None)

    def publish(self, topic: str, message: bytes, key: str = "") -> None:
        if isinstance(message, str):
            message = message.encode()
        with self._cond:
            self._topics.setdefault(topic, []).append((key, message, time.time()))
            self._cond.notify_all()
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_publish_total_count", topic=topic)
        if self.logger is not None:
            self.logger.debug(PubSubLog("PUB", topic, message.decode("utf-8", "replace")))

    def subscribe(self, topic: str, group: str = "default",
                  timeout_s: Optional[float] = None) -> Optional[Message]:
        deadline = None if timeout_s is None else time.time() + timeout_s
        gkey = (topic, group)
        with self._cond:
            while True:
                log = self._topics.setdefault(topic, [])
                committed = self._offsets.get(gkey, 0)
                delivered = max(committed, self._inflight.get(gkey, 0))
                if delivered < len(log):
                    idx = delivered
                    self._inflight[gkey] = delivered + 1
                    key, value, _ts = log[idx]
                    break
                remaining = None if deadline is None else deadline - time.time()
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(timeout=remaining)

        def _commit(offset=idx + 1):
            with self._cond:
                if self._offsets.get(gkey, 0) < offset:
                    self._offsets[gkey] = offset
            if self.metrics is not None:
                self.metrics.increment_counter("app_pubsub_commit_total_count", topic=topic)

        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_subscribe_total_count", topic=topic)
        if self.logger is not None:
            self.logger.debug(PubSubLog("SUB", topic, value.decode("utf-8", "replace")))
        return Message(topic=topic, value=value, key=key,
                       metadata={"offset": idx, "group": group}, committer=_commit)

    def requeue(self, topic: str, group: str = "default") -> None:
        """Roll delivered-not-committed back to the committed offset (handler failed)."""
        with self._cond:
            gkey = (topic, group)
            self._inflight[gkey] = self._offsets.get(gkey, 0)
            self._cond.notify_all()

    def health_check(self) -> Health:
        with self._cond:
            return Health(status=STATUS_UP, details={
                "backend": "inproc",
                "topics": {t: len(log) for t, log in self._topics.items()},
                "groups": {f"{t}/{g}": off for (t, g), off in self._offsets.items()},
            })
