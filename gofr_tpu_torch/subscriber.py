"""Subscription manager: one consumer loop per registered topic.

Ports ``gofr_tpu/subscriber.py`` whole: ``SubscriptionManager``.

Parity: reference pkg/gofr/subscriber.go:15-82 — registered topic->handler map;
Run() spawns a per-topic loop: Subscribe -> build Context from the Message ->
handler -> Commit on success; panic recovery keeps the loop alive; handler
errors leave the message uncommitted for redelivery.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

from .context import Context


class SubscriptionManager:
    def __init__(self, container):
        self.container = container
        self.subscriptions: Dict[str, Callable[[Context], object]] = {}
        self._stop = threading.Event()
        self._threads: list = []

    def register(self, topic: str, handler: Callable[[Context], object]) -> None:
        self.subscriptions[topic] = handler

    def start(self) -> None:
        for topic, handler in self.subscriptions.items():
            t = threading.Thread(target=self._loop, args=(topic, handler),
                                 name=f"subscriber-{topic}", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()

    def _loop(self, topic: str, handler) -> None:
        container = self.container
        subscriber = container.get_subscriber()
        if subscriber is None:
            container.logger.errorf("no pub/sub backend; subscriber for %s not started", topic)
            return
        group = container.config.get_or_default("CONSUMER_ID", "gofr-tpu")
        consecutive_failures = 0
        while not self._stop.is_set():
            try:
                msg = subscriber.subscribe(topic, group=group, timeout_s=0.5)
            except Exception as exc:  # noqa: BLE001 - broker hiccup: log and retry
                container.logger.errorf("error subscribing to %s: %s", topic, exc)
                self._stop.wait(1.0)
                continue
            if msg is None:
                continue
            ctx = Context(request=msg, container=container)
            try:
                handler(ctx)
            except Exception as exc:  # noqa: BLE001 - panic recovery (subscriber.go:64-82)
                container.logger.errorf("error in handler for topic %s: %s", topic, exc)
                if container.metrics_manager is not None:
                    container.metrics_manager.increment_counter(
                        "app_pubsub_subscribe_failure_count", topic=topic)
                requeue = getattr(subscriber, "requeue", None)
                if requeue is not None:
                    requeue(topic, group=group)
                # exponential backoff so a permanently failing handler can't
                # spin a hot redelivery loop (capped at 5 s)
                consecutive_failures += 1
                self._stop.wait(min(5.0, 0.1 * (2 ** min(consecutive_failures, 6))))
                continue
            consecutive_failures = 0
            msg.commit()
