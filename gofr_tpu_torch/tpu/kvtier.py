"""Tiered KV page cache: a host-RAM warm tier and an optional cold tier.

Ports ``gofr_tpu/tpu/kvtier.py`` whole: ``PageBlob``, the blob wire format
(``encode_blob`` / ``decode_blob``: version 1, crc32 over the planes,
base64 JSON), ``RedisKVTier`` (write-behind, errors counted and never
raised) and ``HostKVTier`` (the byte-bounded LRU, content verification on
``get``, ``pin`` with its all-pinned overshoot, ``inventory`` and
``stats``).

The paged engine's prefix cache shares KV pages only while they stay in the
card's page pool; eviction hands the page back to the allocator and the
content is gone. This module keeps evicted page content alive in cheaper
memory:

    page pool  --spill on evict-->  HostKVTier (numpy blobs)
                                        |  write-behind on evict
                                        v
                                    RedisKVTier (base64 + crc32 blobs)

Keys are the prefix cache's cumulative chain keys, so a blob is addressed by
the whole token history it encodes. Every tier checks the stored tokens
against the requested ones on get: a hash collision or a corrupt blob is a
miss (recompute), never another prompt's KV.

bfloat16 without ``ml_dtypes``: the reference imports ``ml_dtypes`` so
that numpy knows ``bfloat16``; the port must not need it. A bf16 plane is
kept here as its 16-bit patterns (a ``uint16`` array, the port's pools
hold no other 16-bit integer KV), and the envelope still names it
``"bfloat16"``: the bytes, the crc and the JSON are the reference's, so a
blob either package encodes decodes in the other to the same bits.

Threading: the engine loop calls put()/get() at admission and eviction;
handler threads call pin() and stats(). One lock covers the index; stored
blobs are immutable.

The cold tier takes any object with the ``set(key, value, ttl_s=)`` /
``get`` / ``delete`` surface of the reference's Redis datasource
(``datasource/kvredis.py``, which ``KV_REDIS_TIER`` builds under
serving): a store that raises is counted in ``errors`` and serving never
blocks on it.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

BLOB_VERSION = 1
# the dtype name of a bf16 plane on the wire, kept here as uint16 patterns
BF16 = "bfloat16"


def wire_dtype(arr: np.ndarray) -> str:
    """The dtype name a plane carries in the envelope: ``bfloat16`` for the
    port's 16-bit patterns (and for an ``ml_dtypes`` array, whose str is
    the same), numpy's name otherwise."""
    return BF16 if arr.dtype == np.uint16 else str(arr.dtype)


def _np_dtype(name: str) -> np.dtype:
    return np.dtype(np.uint16) if name == BF16 else np.dtype(name)


class PageBlob:
    """One page's KV on the host: the ``[L, Hkv, dh, ps]`` k / v slices of
    the pool (bf16 as uint16 patterns, or int8 with the ``[L, Hkv, ps]``
    f32 scale planes), beside the exact tokens the page encodes."""

    __slots__ = ("tokens", "k", "v", "k_scale", "v_scale")

    def __init__(self, tokens: Sequence[int], k: np.ndarray, v: np.ndarray,
                 k_scale: Optional[np.ndarray] = None,
                 v_scale: Optional[np.ndarray] = None):
        self.tokens: Tuple[int, ...] = tuple(int(t) for t in tokens)
        self.k = np.ascontiguousarray(k)
        self.v = np.ascontiguousarray(v)
        self.k_scale = (np.ascontiguousarray(k_scale)
                        if k_scale is not None else None)
        self.v_scale = (np.ascontiguousarray(v_scale)
                        if v_scale is not None else None)

    @property
    def nbytes(self) -> int:
        n = self.k.nbytes + self.v.nbytes
        if self.k_scale is not None:
            n += self.k_scale.nbytes
        if self.v_scale is not None:
            n += self.v_scale.nbytes
        return n


# -- wire format for the cold tier and the hand-off ---------------------------

def _planes(k, v, k_scale, v_scale) -> List[Tuple[str, np.ndarray]]:
    """(envelope key, plane) in the envelope's order."""
    out = [("k", k), ("val", v)]
    if k_scale is not None:
        out.append(("k_scale", k_scale))
    if v_scale is not None:
        out.append(("v_scale", v_scale))
    return out


def _crc(planes) -> int:
    """crc32 over the planes' bytes in order, computed incrementally: the
    reference's crc32 of their concatenation, without the copy."""
    crc = 0
    for _, arr in planes:
        crc = zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B"), crc)
    return crc & 0xFFFFFFFF


def _unpack_array(spec: Dict[str, Any]) -> np.ndarray:
    raw = base64.b64decode(spec["data"].encode("ascii"))
    return np.frombuffer(raw, dtype=_np_dtype(spec["dtype"])).reshape(
        spec["shape"]).copy()


def splice_json(text: str, parts: List[Tuple[str, str]]) -> str:
    """`text` with each ``"<marker>"`` (in order, each once) replaced by
    the quoted string it stands for, in one join."""
    out, rest = [], text
    for marker, value in parts:
        head, found, rest = rest.partition(f'"{marker}"')
        if not found:
            raise ValueError(f"marker {marker!r} not found")
        out += [head, '"', value, '"']
    out.append(rest)
    return "".join(out)


def encode_blob(blob: PageBlob) -> str:
    """The reference's versioned, checksummed JSON envelope, as a string
    (a Redis string wire and a fake's str(value) both round-trip it), the
    same bytes as its ``json.dumps`` of the same body. The base64 planes
    are spliced into the dumped body, where json.dumps would scan each
    for characters to escape (base64 has none): a 16 MiB page's encode
    is about half the reference's host time."""
    planes = _planes(blob.k, blob.v, blob.k_scale, blob.v_scale)
    body: Dict[str, Any] = {"v": BLOB_VERSION, "tokens": list(blob.tokens)}
    data = []
    for key, arr in planes:
        marker = f"@{key}@"
        body[key] = {"dtype": wire_dtype(arr), "shape": list(arr.shape),
                     "data": marker}
        data.append((marker, base64.b64encode(
            memoryview(np.ascontiguousarray(arr)).cast("B")).decode("ascii")))
    body["crc"] = _crc(planes)
    return splice_json(json.dumps(body), data)


def decode_blob(raw: Any) -> Optional[PageBlob]:
    """Envelope -> PageBlob; any structural problem, version skew or crc
    mismatch returns None (a miss, never wrong KV)."""
    try:
        if isinstance(raw, bytes):
            raw = raw.decode("utf-8")
        body = json.loads(raw)
        if body.get("v") != BLOB_VERSION:
            return None
        k = _unpack_array(body["k"])
        v = _unpack_array(body["val"])
        k_scale = (_unpack_array(body["k_scale"])
                   if "k_scale" in body else None)
        v_scale = (_unpack_array(body["v_scale"])
                   if "v_scale" in body else None)
        if _crc(_planes(k, v, k_scale, v_scale)) != body.get("crc"):
            return None
        return PageBlob(body["tokens"], k, v, k_scale, v_scale)
    except Exception:  # noqa: BLE001 - a corrupt blob is the expected failure
        return None


class RedisKVTier:
    """Cold tier over a Redis-shaped store (set/get/delete). Write-behind by
    default: puts go to a bounded queue drained by a daemon worker, so host
    tier eviction never blocks on the network; a full queue drops the blob
    (a cache: the cost is a later recompute). ``write_behind=False`` runs
    puts inline, for tests."""

    KEY_PREFIX = "gofr:kvpage:"

    def __init__(self, store: Any, write_behind: bool = True,
                 ttl_s: Optional[float] = None, queue_depth: int = 64):
        self.store = store
        self.ttl_s = ttl_s
        self.hits = 0
        self.misses = 0
        self.stored = 0
        self.corrupt = 0
        self.errors = 0
        self.dropped = 0
        self._lock = threading.Lock()
        self._q: Optional["queue.Queue"] = None
        if write_behind:
            self._q = queue.Queue(maxsize=queue_depth)
            worker = threading.Thread(target=self._drain,
                                      name="kvtier-redis-writer", daemon=True)
            worker.start()

    def _key(self, key: int) -> str:
        return f"{self.KEY_PREFIX}{key:#x}"

    def _set(self, key: int, blob: PageBlob) -> None:
        try:
            self.store.set(self._key(key), encode_blob(blob),
                           ttl_s=self.ttl_s)
            with self._lock:
                self.stored += 1
        except Exception:  # noqa: BLE001 - the cold tier is best-effort
            with self._lock:
                self.errors += 1

    def _drain(self) -> None:
        while True:
            key, blob = self._q.get()
            try:
                self._set(key, blob)
            finally:
                self._q.task_done()

    def put(self, key: int, blob: PageBlob) -> None:
        if self._q is None:
            self._set(key, blob)
            return
        try:
            self._q.put_nowait((key, blob))
        except queue.Full:
            with self._lock:
                self.dropped += 1

    def get(self, key: int, tokens: Sequence[int]) -> Optional[PageBlob]:
        try:
            raw = self.store.get(self._key(key))
        except Exception:  # noqa: BLE001
            with self._lock:
                self.errors += 1
            return None
        if raw is None:
            with self._lock:
                self.misses += 1
            return None
        blob = decode_blob(raw)
        if blob is None or blob.tokens != tuple(int(t) for t in tokens):
            # corrupt or collided: purge, so the next lookup is a clean miss
            with self._lock:
                self.corrupt += 1
                self.misses += 1
            try:
                self.store.delete(self._key(key))
            except Exception:  # noqa: BLE001
                pass
            return None
        with self._lock:
            self.hits += 1
        return blob

    def flush(self, timeout_s: float = 5.0) -> None:
        """Wait until the write-behind queue drains (tests, shutdown)."""
        if self._q is None:
            return
        deadline = time.monotonic() + timeout_s
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.005)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "stored": self.stored, "corrupt": self.corrupt,
                    "errors": self.errors, "dropped": self.dropped}


class HostKVTier:
    """Bounded host-RAM LRU over PageBlobs, keyed by cumulative prefix keys:
    the prefix cache's spill target and the admission's restore source,
    optionally over a RedisKVTier (write-behind on eviction, promote on
    hit)."""

    def __init__(self, capacity_bytes: int, page_size: int,
                 cold: Optional[RedisKVTier] = None):
        self.capacity_bytes = int(capacity_bytes)
        self.page_size = page_size
        self.cold = cold
        self._blobs: "OrderedDict[int, PageBlob]" = OrderedDict()
        self._pins: Dict[int, float] = {}          # key -> pin deadline
        self._lock = threading.Lock()
        self.used_bytes = 0
        self.hits = 0
        self.misses = 0
        self.stored = 0
        self.evicted = 0
        self.corrupt = 0
        self.rejected = 0

    # -- internals (the caller holds the lock) --------------------------------
    def _pinned(self, key: int, now: float) -> bool:
        deadline = self._pins.get(key)
        if deadline is None:
            return False
        if deadline <= now:
            del self._pins[key]
            return False
        return True

    def _evict_to_fit(self) -> None:
        """LRU-evict until under capacity, skipping unexpired pins. When all
        that is left is pinned the tier runs over budget for a while (pins
        are TTL-bounded, so the overshoot is too): starving the spill path
        instead would turn pinning into data loss."""
        now = time.monotonic()
        if self.used_bytes <= self.capacity_bytes:
            return
        for key in list(self._blobs):
            if self.used_bytes <= self.capacity_bytes:
                break
            if self._pinned(key, now):
                continue
            blob = self._blobs.pop(key)
            self.used_bytes -= blob.nbytes
            self.evicted += 1
            if self.cold is not None:
                self.cold.put(key, blob)

    # -- the tier protocol ----------------------------------------------------
    def put(self, key: int, blob: PageBlob) -> bool:
        """Admit a spilled page. False when the blob alone exceeds the
        capacity (it would evict the whole tier for one entry)."""
        if blob.nbytes > self.capacity_bytes:
            with self._lock:
                self.rejected += 1
            return False
        with self._lock:
            old = self._blobs.pop(key, None)
            if old is not None:
                self.used_bytes -= old.nbytes
            self._blobs[key] = blob
            self.used_bytes += blob.nbytes
            self.stored += 1
            self._evict_to_fit()
        return True

    def get(self, key: int, tokens: Sequence[int]) -> Optional[PageBlob]:
        """Content-verified lookup; falls through to the cold tier on a miss
        and promotes a cold hit back into host RAM."""
        want = tuple(int(t) for t in tokens)
        with self._lock:
            blob = self._blobs.get(key)
            if blob is not None:
                if blob.tokens != want:
                    # collision or corruption: drop it so it cannot hit again
                    self._blobs.pop(key)
                    self.used_bytes -= blob.nbytes
                    self.corrupt += 1
                    self.misses += 1
                    return None
                self._blobs.move_to_end(key)
                self.hits += 1
                return blob
            self.misses += 1
        if self.cold is None:
            return None
        cold_blob = self.cold.get(key, want)
        if cold_blob is not None:
            self.put(key, cold_blob)   # promote: the next turn hits warm
        return cold_blob

    def contains(self, key: int, tokens: Sequence[int]) -> bool:
        """A peek: no LRU touch, no counters, no cold probe."""
        want = tuple(int(t) for t in tokens)
        with self._lock:
            blob = self._blobs.get(key)
            return blob is not None and blob.tokens == want

    def pin(self, keys: Sequence[int], ttl_s: float) -> int:
        """Protect chain keys from host-tier LRU eviction for ttl_s seconds
        (conversation pinning: a resumable conversation's trunk survives
        churn between turns). Pins do not depend on residency: a trunk page
        still in the pool spills here later, already covered."""
        now = time.monotonic()
        deadline = now + ttl_s
        with self._lock:
            # prune, so the pin set tracks live conversations
            for stale in [k for k, d in self._pins.items() if d <= now]:
                del self._pins[stale]
            for key in keys:
                self._pins[key] = max(self._pins.get(key, 0.0), deadline)
        return len(keys)

    def clear(self) -> None:
        with self._lock:
            self._blobs.clear()
            self._pins.clear()
            self.used_bytes = 0

    def keys(self) -> List[int]:
        with self._lock:
            return list(self._blobs)

    def inventory(self, limit: int = 64) -> List[Dict[str, Any]]:
        """The newest ``limit`` resident pages as ``{key, tokens}`` rows: the
        warm boot's pre-warm feed. A booting replica fetches a peer's
        inventory and calls ``get(key, tokens)`` on its own tier (a shared
        cold tier's hits promote into host RAM); keys alone would not do,
        since ``get`` verifies the content against the token window."""
        with self._lock:
            rows = [(k, b.tokens) for k, b in self._blobs.items()]
        rows = rows[-max(0, int(limit)):] if limit else []
        return [{"key": int(k), "tokens": list(t)} for k, t in rows]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            now = time.monotonic()
            out = {
                "capacity_bytes": self.capacity_bytes,
                "used_bytes": self.used_bytes,
                "pages": len(self._blobs),
                "hits": self.hits,
                "misses": self.misses,
                "stored": self.stored,
                "evicted": self.evicted,
                "corrupt": self.corrupt,
                "rejected": self.rejected,
                "pinned": sum(1 for k, d in self._pins.items() if d > now),
            }
        if self.cold is not None:
            out["redis"] = self.cold.stats()
        return out
