"""Pub/Sub abstraction: Publisher/Subscriber/Committer interfaces + Message.

Ports ``gofr_tpu/pubsub/__init__.py`` whole: ``PubSubLog``, ``Message``
and ``Client``.

Parity: reference pkg/gofr/datasource/pubsub/interface.go:11-30 (Publisher,
Subscriber, Client, Committer), message.go:8-49 (Message implements the
transport-agnostic Request so handlers bind it like an HTTP body), log.go:8-20
(structured PUB/SUB records). Backends: reference ships kafka/google/mqtt over
the network; this build ships an in-process broker with consumer-group +
committed-offset semantics (the CI tier the reference mocks), and the backend
switch in the container mirrors container.go:86-131.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from ..logging import PrettyPrint


class PubSubLog(PrettyPrint):
    def __init__(self, mode: str, topic: str, message: str):
        self.mode = mode  # PUB / SUB
        self.topic = topic
        self.message = message

    def pretty_print(self, fp) -> None:
        fp.write(f"\x1b[35m{self.mode}\x1b[0m {self.topic} {self.message[:80]}")


class Message:
    """One consumed message; doubles as a handler Request (message.go:8-49)."""

    def __init__(self, topic: str, value: bytes, key: str = "",
                 metadata: Optional[Dict[str, Any]] = None, committer=None):
        self.topic = topic
        self.value = value
        self.key = key
        self.metadata = metadata or {}
        self._committer = committer
        self.span = None
        self.context: Dict[str, Any] = {}

    # -- Request interface so newContext(msg) works like HTTP -----------------
    def param(self, key: str) -> str:
        return str(self.metadata.get(key, ""))

    def path_param(self, key: str) -> str:
        if key == "topic":
            return self.topic
        return ""

    def host_name(self) -> str:
        return "pubsub://" + self.topic

    def bind(self, target: Any = None) -> Any:
        data = json.loads(self.value.decode("utf-8")) if self.value else {}
        if target is None:
            return data
        import dataclasses

        if isinstance(target, type) and dataclasses.is_dataclass(target):
            names = {f.name for f in dataclasses.fields(target)}
            return target(**{k: v for k, v in data.items() if k in names})
        if isinstance(target, dict):
            target.update(data)
            return target
        for k, v in data.items():
            setattr(target, k, v)
        return target

    def commit(self) -> None:
        if self._committer is not None:
            self._committer()


class Client:
    """Backend interface: publish/subscribe/create_topic/delete_topic/health/close."""

    def publish(self, topic: str, message: bytes, key: str = "") -> None:  # pragma: no cover
        raise NotImplementedError

    def subscribe(self, topic: str, group: str = "default",
                  timeout_s: Optional[float] = None) -> Optional[Message]:  # pragma: no cover
        raise NotImplementedError

    def create_topic(self, topic: str) -> None:  # pragma: no cover
        raise NotImplementedError

    def delete_topic(self, topic: str) -> None:  # pragma: no cover
        raise NotImplementedError

    def health_check(self):  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass
