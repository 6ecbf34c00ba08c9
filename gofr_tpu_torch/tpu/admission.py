"""Live-traffic multi-process admission: rank 0 decides, every rank replays.

Ports ``gofr_tpu/tpu/admission.py``: ``InProcKV`` (copied), ``_DiscardQueue``,
``_spec``, and ``AdmissionPlane`` whole, with ``StoreKV`` (the job's
``torch.distributed`` TCPStore) in the place of ``CoordinationKV`` (the
jax.distributed coordination service).

Multi-controller serving requires every process of a tensor-parallel group
to issue an IDENTICAL dispatch sequence: the programs hold collectives
(the Megatron all-reduces, the vocab all-gather, models/llama.py), so a
wave admitted on one rank but not another deadlocks the group. In the
reference that is the multi-host shape only; PyTorch runs one process per
card, so in the port every TP engine, one host or many, is a
multi-controller one, and this plane is on the TP serving path itself
(serve.py starts it for TP_SHARDS > 1).

  * Rank 0 (the LEADER) is the single ingress: `submit()` is only legal
    there. At each engine-loop iteration the leader drains its local
    arrival queue, freezes the wave composition (request tokens, sampling
    params, priorities, QoS identity, plus any cancellations observed since
    the last wave) and publishes it as wave N in the job's store.
  * Every FOLLOWER blocks on wave N, reconstructs shadow requests that
    reuse the leader's request ids (so the (priority, id) admission-heap
    order is bit-identical), and feeds them to the unchanged admission
    logic. From there on every rank's engine state evolves in lock-step:
    slot assignment, prefill buckets, page allocation, the prefix cache.
  * Cancellation is part of the wave, not a local event: the engine reads
    `_is_cancelled` (membership in the synced set) instead of the live
    threading.Event whenever a plane is installed, so a cancel takes
    effect at the same loop iteration on every rank.
  * When nothing is active and nothing arrived, the leader publishes
    nothing and followers park in a blocking get: the idle engine costs
    no store traffic and wakes every rank on the same wave.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import List, Optional, Tuple

# Waves older than this are deleted from the coordination store. Wave
# cadence exists only while dispatching (the engine passes has_work =
# dispatching work, not parked requests), and every dispatching iteration
# ends in a sync that blocks on the follower joining the collective — so
# the leader can run at most ~pipeline_depth waves ahead of any follower,
# and a generous constant bounds store growth without an ack channel.
_DELETE_LAG = 256


class LeaderStoppedError(RuntimeError):
    """A follower's loop at the leader's stop sentinel: no collective it
    dispatches can complete again, so it stops at this wave."""


class InProcKV:
    """Dict-backed KV with blocking gets: the single-process test double
    for the coordination service (two planes in one process share one)."""

    def __init__(self):
        self._data = {}
        self._cond = threading.Condition()

    def set(self, key: str, value: str) -> None:
        with self._cond:
            self._data[key] = value
            self._cond.notify_all()

    def get_blocking(self, key: str, timeout_s: float) -> str:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while key not in self._data:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(key)
                self._cond.wait(timeout=left)
            return self._data[key]

    def delete(self, key: str) -> None:
        with self._cond:
            self._data.pop(key, None)


class StoreKV:
    """The job's torch.distributed TCPStore as the wave plane: the store
    that formed the process group (parallel/multihost.job_store), or one a
    caller made (``serve.py``'s single-host TP job). ``get_blocking`` is
    the store's ``wait`` with a timeout, then ``get``."""

    def __init__(self, store=None):
        if store is None:
            from ..parallel.multihost import job_store

            store = job_store()
        if store is None:
            raise RuntimeError(
                "no job store: call parallel.multihost."
                "initialize_from_config() first, or pass a TCPStore")
        self._store = store

    def set(self, key: str, value: str) -> None:
        self._store.set(key, value)

    def get_blocking(self, key: str, timeout_s: float) -> str:
        """TimeoutError when the key does not come within timeout_s;
        ConnectionError when the store is gone (its server, rank 0, ended)."""
        import datetime

        import torch.distributed as dist

        try:
            self._store.wait([key], datetime.timedelta(seconds=timeout_s))
            return self._store.get(key).decode()
        except dist.DistNetworkError as exc:
            raise ConnectionError(f"{key}: {exc}") from exc
        except dist.DistStoreError as exc:
            raise TimeoutError(f"{key}: {exc}") from exc

    def delete(self, key: str) -> None:
        try:
            self._store.delete_key(key)
        except Exception:  # noqa: BLE001 - cleanup is best-effort
            pass


class _DiscardQueue:
    """Shadow requests have no consumer; their token stream must not
    accumulate. Swapped in for out_queue unless a shadow hook opts in."""

    def put(self, item) -> None:
        pass

    def get(self, timeout=None):
        raise queue.Empty

    def get_nowait(self):
        raise queue.Empty

    def qsize(self) -> int:
        return 0


def _spec(request) -> dict:
    return {"id": request.id, "prompt": request.prompt_tokens,
            "max_new": request.max_new_tokens, "temp": request.temperature,
            "stop": sorted(request.stop_tokens), "prio": request.priority,
            "min": request.min_tokens, "top_p": request.top_p,
            "top_k": request.top_k,
            # QoS identity rides the wave so follower shadows account
            # classes identically; prio already carries the band
            "qos": getattr(request, "qos_class", None),
            "tenant": getattr(request, "tenant", "")}


class AdmissionPlane:
    """One per engine per process. Leader publishes waves; followers replay.

    The engine calls `exchange()` once per loop iteration (under its state
    lock) and consults `synced_cancelled` instead of per-request live
    cancel events. `close()` publishes a stop sentinel so idle followers
    unpark promptly at shutdown.
    """

    def __init__(self, process_id: Optional[int] = None, kv=None,
                 prefix: str = "gofr/admit", wave_timeout_s: float = 120.0):
        if process_id is None:
            import torch.distributed as dist

            process_id = dist.get_rank()
        self.process_id = process_id
        self.kv = kv if kv is not None else StoreKV()
        self.prefix = prefix
        self.wave_timeout_s = wave_timeout_s
        self._seq = 0
        self._live = {}  # id -> request (leader: real; follower: shadow)
        self.synced_cancelled = set()
        self._closed = False
        self._drain_sent = False
        # the engine wires its stop event here so a parked follower can
        # abandon the wave wait when its own process shuts down first
        self.stop_event: Optional[threading.Event] = None
        # follower test/consumer hook: called with each shadow request
        # BEFORE admission; when set, shadows keep a real out_queue so the
        # hook's owner can read the mirrored token stream
        self.on_shadow = None

    @property
    def is_leader(self) -> bool:
        return self.process_id == 0

    @property
    def closed(self) -> bool:
        return self._closed

    def _key(self, seq: int) -> str:
        return f"{self.prefix}/{seq}"

    def exchange(self, drained: List[Tuple[int, int, object]],
                 has_work: bool,
                 draining: bool = False) -> Tuple[List[Tuple[int, int, object]], bool]:
        """One admission wave. `drained` is what the leader pulled from its
        local queue this iteration (followers pass []); `has_work` is
        whether mirrored engine state has anything in flight — it must be
        computed from state every rank shares, because it decides whether
        this iteration carries a wave at all; `draining` (leader-local
        decision) rides the wave so every rank fails its parked heap at
        the same iteration. Returns (heap entries to admit, drain flag) —
        identical on every rank."""
        self._prune()
        if self._closed:
            return [], False
        if self.is_leader:
            return self._publish(drained, has_work, draining)
        return self._consume(has_work)

    def _publish(self, drained, has_work, draining):
        cancels = [rid for rid, req in self._live.items()
                   if req.cancelled.is_set()
                   and rid not in self.synced_cancelled]
        if draining:
            # drain cadence: every iteration while work remains (followers
            # are in lock-step consuming), then once more so a PARKED
            # follower learns the drain too; after that, silence until
            # close() — an idle draining loop must not flood the store
            if not has_work and not cancels and self._drain_sent:
                return [], True
            payload = {"drain": True, "cancel": cancels}
            self._drain_sent = True
        else:
            if not drained and not cancels and not has_work:
                return [], False  # idle, nothing new: followers stay parked
            payload = {"reqs": [_spec(entry[2]) for entry in drained],
                       "cancel": cancels}
        self.kv.set(self._key(self._seq), json.dumps(payload))
        if self._seq >= _DELETE_LAG:
            self.kv.delete(self._key(self._seq - _DELETE_LAG))
        self._seq += 1
        self.synced_cancelled.update(cancels)
        for _, rid, request in drained:
            self._live[rid] = request
        return drained, draining

    def _consume(self, has_work):
        deadline = time.monotonic() + self.wave_timeout_s
        while True:
            try:
                raw = self.kv.get_blocking(self._key(self._seq), 0.5)
                break
            except ConnectionError:
                # the store's server (the leader's process) is gone: as
                # final as its stop sentinel (the port's addition: a TCPStore
                # ends with its process, where the reference's coordination
                # service outlives a rank)
                self._closed = True
                return [], False
            except TimeoutError:
                if self.stop_event is not None and self.stop_event.is_set():
                    return [], False
                if not has_work:
                    # idle: yield back to the engine loop instead of
                    # parking here — exchange() runs under the engine's
                    # state lock, and an indefinite in-lock wait would
                    # hang every other lock-taking API on this rank
                    # (drain timeouts, stats). _seq is untouched, so the
                    # next call resumes waiting on the same wave.
                    return [], False
                if time.monotonic() > deadline:
                    # active work on every rank but no wave: the leader is
                    # gone or wedged — surface it instead of hanging the slice
                    raise RuntimeError(
                        f"admission wave {self._seq} never arrived "
                        f"({self.wave_timeout_s}s); leader unreachable")
        self._seq += 1
        payload = json.loads(raw)
        if payload.get("stop"):
            self._closed = True
            return [], False
        entries = []
        for spec in payload.get("reqs", ()):
            request = self._shadow(spec)
            self._live[request.id] = request
            if self.on_shadow is not None:
                self.on_shadow(request)
            entries.append((request.priority, request.id, request))
        for rid in payload["cancel"]:
            self.synced_cancelled.add(rid)
            shadow = self._live.get(rid)
            if shadow is not None:
                shadow.cancelled.set()
        return entries, bool(payload.get("drain"))

    def _shadow(self, spec):
        from .engine import GenerationRequest

        request = GenerationRequest(
            spec["prompt"], max_new_tokens=spec["max_new"],
            temperature=spec["temp"], stop_tokens=set(spec["stop"]),
            priority=spec["prio"], min_tokens=spec["min"],
            top_p=spec["top_p"], top_k=spec["top_k"],
            qos_class=spec.get("qos"), tenant=spec.get("tenant", ""))
        # the leader's id keeps (priority, id) heap order bit-identical
        request.id = spec["id"]
        if self.on_shadow is None:
            request.out_queue = _DiscardQueue()
        return request

    def _prune(self) -> None:
        """Drop finished requests from the live registry. Terminal state
        (finished_at / error) is set by engine transitions that happen at
        the same loop iteration on every rank, so pruning stays symmetric."""
        done = [rid for rid, req in self._live.items()
                if req.finished_at is not None or req.error is not None]
        for rid in done:
            del self._live[rid]
            self.synced_cancelled.discard(rid)

    def close(self) -> None:
        """Leader: publish the stop sentinel so parked followers unblock.
        Follower: stop consuming. Idempotent."""
        if self.is_leader and not self._closed:
            self.kv.set(self._key(self._seq), json.dumps({"stop": True}))
            self._seq += 1
        self._closed = True
