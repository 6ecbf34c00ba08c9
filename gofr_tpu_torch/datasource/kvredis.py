"""Redis-backed KV store: the network twin of the in-process KVStore.

Ports ``gofr_tpu/datasource/kvredis.py`` whole: ``RedisKVStore`` (gated
on ``redis``, with the ping-retry redial) and ``RedisPipeline``.

Parity: reference pkg/gofr/datasource/redis/ — go-redis client from
REDIS_HOST/REDIS_PORT (redis.go:35-64), logging/metrics hook on every
command (hook.go:67-105), health via INFO (health.go:13-42). Gated on the
`redis` package (redis-py); a missing driver or unreachable server logs and
leaves the datasource down so boot survives (redis.go:38-41), matching the
SQL datasource's posture.

Same COMMAND surface as datasource.kvstore.KVStore (including pipeline()),
so handlers written against ctx.kv keep working when KV_STORE=redis is
deployed. Value semantics follow real Redis: everything crosses the wire as
a string (non-string hash values are JSON-encoded), while the in-process
store keeps Python objects verbatim — portable handlers should not depend
on non-string round-trips.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from . import Health, STATUS_DOWN, STATUS_UP
from .kvstore import KVLog


class RedisKVStore:
    def __init__(self, config, logger, metrics):
        self.logger = logger
        self.metrics = metrics
        self.host = config.get_or_default("REDIS_HOST", "localhost")
        self.port = config.get_int("REDIS_PORT", 6379)
        self.db = config.get_int("REDIS_DB", 0)
        self._client = None
        self._started_at: Optional[float] = None
        self._command_count = 0
        self._connect()

    def _connect(self) -> None:
        try:
            import redis
        except ImportError:
            self.logger.errorf("KV_STORE=redis needs the 'redis' package")
            return
        try:
            self._client = redis.Redis(host=self.host, port=self.port,
                                       db=self.db, decode_responses=True)
            self._client.ping()
            self._started_at = time.time()
            self.logger.infof("connected to redis at %s:%d", self.host, self.port)
        except Exception as exc:  # noqa: BLE001 - boot survives (redis.go:38-41)
            self.logger.errorf("could not connect to redis: %s", exc)
            self._client = None

    def _observe(self, command: str, start: float) -> None:
        elapsed = time.time() - start
        self._command_count += 1
        if self.metrics is not None:
            try:
                self.metrics.record_histogram("app_kv_stats", elapsed,
                                              type=command)
            except Exception:  # noqa: BLE001
                pass
        if self.logger is not None:
            self.logger.debug(KVLog(command, int(elapsed * 1e6)))

    def _require(self):
        if self._client is None:
            raise ConnectionError("redis is not connected")
        return self._client

    # -- strings (KVStore-compatible surface) ---------------------------------
    def set(self, key: str, value: Any, ttl_s: Optional[float] = None) -> None:
        start = time.time()
        # millisecond TTL: sub-second expiries (ttl_s=0.5) must not truncate
        # to the invalid EX 0
        px = max(1, int(ttl_s * 1000)) if ttl_s is not None else None
        self._require().set(key, value, px=px)
        self._observe("SET", start)

    def get(self, key: str) -> Any:
        start = time.time()
        value = self._require().get(key)
        self._observe("GET", start)
        return value

    def delete(self, *keys: str) -> int:
        start = time.time()
        n = self._require().delete(*keys)
        self._observe("DEL", start)
        return int(n)

    def exists(self, key: str) -> bool:
        start = time.time()
        n = self._require().exists(key)
        self._observe("EXISTS", start)
        return bool(n)

    def incr(self, key: str, by: int = 1) -> int:
        start = time.time()
        n = self._require().incrby(key, by)
        self._observe("INCR", start)
        return int(n)

    def decr(self, key: str, by: int = 1) -> int:
        return self.incr(key, -by)

    def expire(self, key: str, ttl_s: float) -> bool:
        start = time.time()
        ok = self._require().expire(key, int(ttl_s))
        self._observe("EXPIRE", start)
        return bool(ok)

    def ttl(self, key: str) -> float:
        start = time.time()
        out = self._require().ttl(key)
        self._observe("TTL", start)
        return float(out)

    def keys(self, pattern: str = "*") -> List[str]:
        start = time.time()
        out = list(self._require().keys(pattern))
        self._observe("KEYS", start)
        return out

    # -- hashes ---------------------------------------------------------------
    @staticmethod
    def _wire_value(value: Any):
        """Redis accepts str/bytes/numbers only; structured values (the
        migration watermark stores dicts, migration/__init__.py) ride as
        JSON strings."""
        if isinstance(value, (str, bytes, int, float)):
            return value
        import json

        return json.dumps(value, default=str)

    def hset(self, key: str, field: str, value: Any) -> None:
        start = time.time()
        self._require().hset(key, field, self._wire_value(value))
        self._observe("HSET", start)

    def hget(self, key: str, field: str) -> Any:
        start = time.time()
        out = self._require().hget(key, field)
        self._observe("HGET", start)
        return out

    def hgetall(self, key: str) -> Dict[str, Any]:
        start = time.time()
        out = dict(self._require().hgetall(key))
        self._observe("HGETALL", start)
        return out

    def flushall(self) -> None:
        start = time.time()
        self._require().flushall()
        self._observe("FLUSHALL", start)

    def pipeline(self) -> "RedisPipeline":
        return RedisPipeline(self)

    # -- health (INFO Stats, health.go:13-42) ---------------------------------
    def health_check(self) -> Health:
        if self._client is None:
            return Health(status=STATUS_DOWN,
                          details={"backend": "redis", "host": self.host,
                                   "port": self.port})
        try:
            info = self._client.info("stats")
            return Health(status=STATUS_UP, details={
                "backend": "redis", "host": self.host, "port": self.port,
                "commands": self._command_count,
                "total_commands_processed": info.get(
                    "total_commands_processed", 0),
                "uptime_s": round(time.time() - (self._started_at
                                                 or time.time()), 1),
            })
        except Exception as exc:  # noqa: BLE001
            return Health(status=STATUS_DOWN,
                          details={"backend": "redis", "error": str(exc)})

    def close(self) -> None:
        if self._client is not None:
            try:
                self._client.close()
            except Exception:  # noqa: BLE001
                pass
            self._client = None


class RedisPipeline:
    """Atomic MULTI/EXEC pipeline over redis-py, mirroring kvstore.Pipeline
    (the migration layer's TxPipeline analog, redis.go:70-135)."""

    def __init__(self, store: RedisKVStore):
        self._pipe = store._require().pipeline(transaction=True)
        self._store = store

    def set(self, key: str, value: Any, ttl_s: Optional[float] = None) -> "RedisPipeline":
        px = max(1, int(ttl_s * 1000)) if ttl_s is not None else None
        self._pipe.set(key, value, px=px)
        return self

    def hset(self, key: str, field: str, value: Any) -> "RedisPipeline":
        self._pipe.hset(key, field, self._store._wire_value(value))
        return self

    def delete(self, key: str) -> "RedisPipeline":
        self._pipe.delete(key)
        return self

    def exec(self) -> None:
        self._pipe.execute()

    def discard(self) -> None:
        self._pipe.reset()
