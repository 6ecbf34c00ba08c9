"""KV store datasource: Redis-shaped API with TTLs, hashes, and atomic pipelines.

Ports ``gofr_tpu/datasource/kvstore.py`` whole: ``KVLog``, ``KVStore``
and its ``Pipeline``.

Parity: reference pkg/gofr/datasource/redis/ — go-redis command surface the
framework actually uses (get/set/del/incr/expire/hset/hget, TxPipeline for
migrations redis.go:70-135), per-command logging+metrics hook (hook.go:67-105),
health via INFO-style stats (health.go:13-42). The reference dials a Redis
server; the bundled backend here is an in-process store with the same
semantics (the "miniredis" tier the reference itself uses in tests), so user
code and migrations run unchanged. KV_STORE=redis swaps in the gated
redis-py network client (datasource/kvredis.py) with the identical surface.
"""

from __future__ import annotations

import fnmatch
import threading
import time
from typing import Any, Dict, List, Optional

from ..logging import PrettyPrint
from . import Health, STATUS_UP


class KVLog(PrettyPrint):
    def __init__(self, command: str, duration_us: int):
        self.command = command
        self.duration_us = duration_us

    def pretty_print(self, fp) -> None:
        fp.write(f"\x1b[31mKV\x1b[0m  {self.duration_us:>8}µs {self.command}")


class KVStore:
    def __init__(self, config=None, logger=None, metrics=None):
        self.logger = logger
        self.metrics = metrics
        self._data: Dict[str, Any] = {}
        self._expiry: Dict[str, float] = {}
        self._lock = threading.RLock()
        self._started_at = time.time()
        self._command_count = 0

    # -- internals ------------------------------------------------------------
    def _observe(self, command: str, start: float) -> None:
        elapsed = time.time() - start
        self._command_count += 1
        if self.metrics is not None:
            self.metrics.record_histogram("app_kv_stats", elapsed, type=command)
        if self.logger is not None:
            self.logger.debug(KVLog(command, int(elapsed * 1e6)))

    def _purge(self, key: str) -> None:
        exp = self._expiry.get(key)
        if exp is not None and time.time() >= exp:
            self._data.pop(key, None)
            self._expiry.pop(key, None)

    # -- strings --------------------------------------------------------------
    def set(self, key: str, value: Any, ttl_s: Optional[float] = None) -> None:
        start = time.time()
        with self._lock:
            self._data[key] = value
            if ttl_s is not None:
                self._expiry[key] = time.time() + ttl_s
            else:
                self._expiry.pop(key, None)
        self._observe("SET", start)

    def get(self, key: str) -> Any:
        start = time.time()
        with self._lock:
            self._purge(key)
            val = self._data.get(key)
        self._observe("GET", start)
        return val

    def delete(self, *keys: str) -> int:
        start = time.time()
        removed = 0
        with self._lock:
            for key in keys:
                if self._data.pop(key, None) is not None:
                    removed += 1
                self._expiry.pop(key, None)
        self._observe("DEL", start)
        return removed

    def exists(self, key: str) -> bool:
        with self._lock:
            self._purge(key)
            return key in self._data

    def incr(self, key: str, by: int = 1) -> int:
        start = time.time()
        with self._lock:
            self._purge(key)
            val = int(self._data.get(key, 0)) + by
            self._data[key] = val
        self._observe("INCR", start)
        return val

    def decr(self, key: str, by: int = 1) -> int:
        return self.incr(key, -by)

    def expire(self, key: str, ttl_s: float) -> bool:
        with self._lock:
            self._purge(key)
            if key not in self._data:
                return False
            self._expiry[key] = time.time() + ttl_s
            return True

    def ttl(self, key: str) -> float:
        with self._lock:
            self._purge(key)
            if key not in self._data:
                return -2.0
            exp = self._expiry.get(key)
            return -1.0 if exp is None else max(0.0, exp - time.time())

    def keys(self, pattern: str = "*") -> List[str]:
        with self._lock:
            for key in list(self._data):
                self._purge(key)
            return [k for k in self._data if fnmatch.fnmatch(k, pattern)]

    # -- hashes (used by KV-backed migrations, migration/redis.go:70-135) -----
    def hset(self, key: str, field: str, value: Any) -> None:
        start = time.time()
        with self._lock:
            self._purge(key)
            bucket = self._data.setdefault(key, {})
            if not isinstance(bucket, dict):
                raise TypeError(f"key {key} holds a non-hash value")
            bucket[field] = value
        self._observe("HSET", start)

    def hget(self, key: str, field: str) -> Any:
        with self._lock:
            self._purge(key)
            bucket = self._data.get(key)
            return bucket.get(field) if isinstance(bucket, dict) else None

    def hgetall(self, key: str) -> Dict[str, Any]:
        with self._lock:
            self._purge(key)
            bucket = self._data.get(key)
            return dict(bucket) if isinstance(bucket, dict) else {}

    # -- pipeline (atomic multi-op, parity with TxPipeline) --------------------
    def pipeline(self) -> "Pipeline":
        return Pipeline(self)

    def flushall(self) -> None:
        with self._lock:
            self._data.clear()
            self._expiry.clear()

    # -- health ---------------------------------------------------------------
    def health_check(self) -> Health:
        with self._lock:
            n = len(self._data)
        return Health(status=STATUS_UP, details={
            "backend": "inproc", "keys": n,
            "total_commands_processed": self._command_count,
            "uptime_s": round(time.time() - self._started_at, 1),
        })


class Pipeline:
    """Queues ops, applies atomically under the store lock on exec()."""

    def __init__(self, store: KVStore):
        self.store = store
        self._ops: List[tuple] = []

    def set(self, key: str, value: Any, ttl_s: Optional[float] = None) -> "Pipeline":
        self._ops.append(("set", key, value, ttl_s))
        return self

    def hset(self, key: str, field: str, value: Any) -> "Pipeline":
        self._ops.append(("hset", key, field, value))
        return self

    def delete(self, key: str) -> "Pipeline":
        self._ops.append(("delete", key))
        return self

    def exec(self) -> None:
        with self.store._lock:
            for op in self._ops:
                getattr(self.store, op[0])(*op[1:])
        self._ops.clear()

    def discard(self) -> None:
        self._ops.clear()
