"""Prefix-affinity primitives shared by the router and the replicas.

A copy of ``gofr_tpu/fleet/affinity.py``, whole. The router sees prompt
text; a replica's prefix cache keys on token pages. Affinity bridges them
with stable hashes of the prompt's leading character blocks
(``affinity_keys``): two requests that share a leading text block would
also share leading token pages.

  - ``affinity_keys(prompt, block)``: cumulative blake2b hashes of
    ``prompt[:block]``, ``prompt[:2*block]``, ..., shortest first.
  - ``AffinityRecorder``: the replica's bounded LRU of keys it served,
    advertised in ``/stats`` as a small digest with a per-boot
    ``generation`` id (a restarted replica is a cold one).
  - ``AffinityMap``: the router's key -> replica map (``fleet/proxy.py``
    learns it from routed responses, ``fleet/registry.py`` re-warms it
    from the digests).
"""

import hashlib
import threading
import uuid
from collections import OrderedDict

DEFAULT_BLOCK = 256
DEFAULT_MAX_BLOCKS = 4


def affinity_keys(prompt, block=DEFAULT_BLOCK, max_blocks=DEFAULT_MAX_BLOCKS):
    """Stable hashes of the prompt's cumulative leading char blocks.

    Returns shortest-prefix first; matching should walk the list in
    reverse (longest prefix wins).  Empty prompt -> no keys.
    """
    if not prompt or block <= 0:
        return []
    keys = []
    for i in range(1, max_blocks + 1):
        end = i * block
        piece = prompt[:end].encode("utf-8", "replace")
        keys.append(hashlib.blake2b(piece, digest_size=8).hexdigest())
        if end >= len(prompt):
            break
    return keys


class AffinityRecorder:
    """Replica-side bounded LRU of affinity keys this process served.

    ``digest()`` is the cheap payload `/stats` advertises to routers:
    a bounded list of the hottest keys plus a per-boot ``generation``
    id.  A replica restart changes the generation, telling routers the
    KV behind those keys is gone.
    """

    def __init__(self, block=DEFAULT_BLOCK, max_blocks=DEFAULT_MAX_BLOCKS,
                 capacity=512):
        self.block = block
        self.max_blocks = max_blocks
        self.capacity = capacity
        self.generation = uuid.uuid4().hex[:12]
        self._keys = OrderedDict()
        self._lock = threading.Lock()

    def record(self, prompt):
        keys = affinity_keys(prompt, self.block, self.max_blocks)
        if not keys:
            return
        with self._lock:
            for key in keys:
                self._keys[key] = self._keys.get(key, 0) + 1
                self._keys.move_to_end(key)
            while len(self._keys) > self.capacity:
                self._keys.popitem(last=False)

    def digest(self, k=32):
        """Bounded, O(k) snapshot: the k most-recently-served keys."""
        with self._lock:
            hot = list(self._keys)[-k:]
        return {
            "block": self.block,
            "generation": self.generation,
            "keys": hot,
        }


class AffinityMap:
    """Router-side key -> replica-name map with LRU eviction.

    ``learn`` is called on every completed response; ``merge_digest``
    folds in a replica's advertised digest on probe so a freshly
    restarted router warms up without misrouting the first turn of
    every live session.  Learned entries always win over merged ones —
    the router watched the response land, the digest is just a hint.
    """

    def __init__(self, capacity=4096):
        self.capacity = capacity
        self._entries = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def learn(self, keys, replica):
        with self._lock:
            for key in keys:
                self._entries[key] = replica
                self._entries.move_to_end(key)
            self._evict()

    def merge_digest(self, replica, keys):
        """Fold a replica's advertised keys in WITHOUT overriding
        entries the router learned first-hand."""
        with self._lock:
            for key in keys:
                if key not in self._entries:
                    self._entries[key] = replica
            self._evict()

    def lookup(self, keys):
        """Longest-prefix match; returns (replica_name, key) or
        (None, None).  Refreshes the matched entry's recency."""
        with self._lock:
            for key in reversed(keys):
                name = self._entries.get(key)
                if name is not None:
                    self._entries.move_to_end(key)
                    return name, key
        return None, None

    def forget(self, replica):
        """Drop every entry pointing at `replica` (restart detected via
        generation change, or replica removed from the fleet)."""
        with self._lock:
            stale = [k for k, v in self._entries.items() if v == replica]
            for key in stale:
                del self._entries[key]
        return len(stale)

    def entries_for(self, replica):
        with self._lock:
            return sum(1 for v in self._entries.values() if v == replica)

    def _evict(self):
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
