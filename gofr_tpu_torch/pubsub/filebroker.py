"""Durable file-backed broker: append-only per-topic logs + committed offsets.

Ports ``gofr_tpu/pubsub/filebroker.py`` whole: ``FileBroker``. Its
segment files and offsets are the reference's, so a log one package
writes the other reads.

This is the build's Kafka analog (reference pkg/gofr/datasource/pubsub/kafka/
kafka.go:30-237): topics are append-only logs that survive restarts, each
(topic, group) pair has a durably-committed offset advanced only when the
handler commits (reference subscriber.go:51-53, kafka/message.go:25-31), and
uncommitted messages are redelivered after a crash.  Unlike the reference it
speaks no network protocol — durability lives on the local filesystem, with
`fcntl` file locks making publish safe across processes (multiple
apps on one host can share a broker directory the way reference apps share a
Kafka cluster; cross-host ingress stays on the gRPC/HTTP layer per
SURVEY.md §5 "Distributed communication backend").

Log format: one file per topic, a stream of records
    [u32 key_len][u32 val_len][f64 unix_ts][key bytes][value bytes]
Committed offsets: one small text file per (topic, group), written atomically
(tmp + rename) so a crash never leaves a torn offset.

Cross-process consumer groups: a per-(topic, group) state file (flock'd
read-modify-write) holds PER-RECORD claims {index: owner pid + instance id +
expiry} and the set of acked indices above the committed watermark.
Processes sharing a broker directory in the same group work-share: each
subscribe claims the lowest unacked, unclaimed record; commit acks that
record and advances the watermark over the contiguous acked prefix — so a
crashed or expired owner's records are redelivered (its claims stop being
live) while commits from other consumers can never skip them (Kafka's
session-timeout rebalance, in one file, without partitions).
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from ..datasource import Health, STATUS_DOWN, STATUS_UP
from . import Client, Message, PubSubLog

_HEADER = struct.Struct("<IId")

try:
    import fcntl

    def _lock(fp):
        fcntl.flock(fp.fileno(), fcntl.LOCK_EX)

    def _unlock(fp):
        fcntl.flock(fp.fileno(), fcntl.LOCK_UN)
except ImportError:  # non-POSIX: single-process use only
    def _lock(fp):
        pass

    def _unlock(fp):
        pass


def _safe_topic(topic: str) -> str:
    if not topic or "/" in topic or topic.startswith("."):
        raise ValueError(f"invalid topic name {topic!r}")
    return topic


class FileBroker(Client):
    """Append-log broker rooted at PUBSUB_DIR (default ./.gofr_pubsub)."""

    def __init__(self, config=None, logger=None, metrics=None, root: str = ""):
        self.logger = logger
        self.metrics = metrics
        if not root and config is not None:
            root = config.get_or_default("PUBSUB_DIR", "")
        self.root = root or ".gofr_pubsub"
        os.makedirs(self.root, exist_ok=True)
        # per-process index: topic -> (record start offsets, bytes indexed);
        # bodies stay on disk and are read on demand, so memory is O(records)
        # pointers, never O(log bytes)
        self._index: Dict[str, Tuple[List[int], int]] = {}
        # instance id distinguishes this broker from an earlier one in the
        # same pid (a restart): the old instance's claims are not honoured
        self._iid = uuid.uuid4().hex
        self._mu = threading.Lock()
        self._poll_s = 0.05
        self._lease_ttl = 30.0
        if config is not None:
            self._poll_s = float(config.get_or_default("PUBSUB_POLL_INTERVAL_S", "0.05"))
            self._lease_ttl = float(config.get_or_default("PUBSUB_LEASE_TTL_S", "30"))

    # ---- paths --------------------------------------------------------------
    def _topic_dir(self, topic: str) -> str:
        return os.path.join(self.root, _safe_topic(topic))

    def _log_path(self, topic: str) -> str:
        return os.path.join(self._topic_dir(topic), "log")

    def _offset_path(self, topic: str, group: str) -> str:
        return os.path.join(self._topic_dir(topic), f"offset.{group}")

    def _lease_path(self, topic: str, group: str) -> str:
        return os.path.join(self._topic_dir(topic), f"lease.{group}")

    # ---- admin --------------------------------------------------------------
    def create_topic(self, topic: str) -> None:
        os.makedirs(self._topic_dir(topic), exist_ok=True)
        path = self._log_path(topic)
        if not os.path.exists(path):
            open(path, "ab").close()

    def delete_topic(self, topic: str) -> None:
        shutil.rmtree(self._topic_dir(topic), ignore_errors=True)
        with self._mu:
            self._index.pop(topic, None)

    # ---- produce ------------------------------------------------------------
    def publish(self, topic: str, message: bytes, key: str = "") -> None:
        if isinstance(message, str):
            message = message.encode()
        self.create_topic(topic)
        kb = key.encode()
        record = _HEADER.pack(len(kb), len(message), time.time()) + kb + message
        with open(self._log_path(topic), "ab") as fp:
            _lock(fp)
            try:
                fp.write(record)
                fp.flush()
                os.fsync(fp.fileno())
            finally:
                _unlock(fp)
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_publish_total_count", topic=topic)
        if self.logger is not None:
            self.logger.debug(PubSubLog("PUB", topic, message.decode("utf-8", "replace")))

    # ---- consume ------------------------------------------------------------
    def _refresh(self, topic: str) -> List[int]:
        """Index record offsets appended since the last refresh (under _mu)."""
        offsets, consumed = self._index.get(topic, ([], 0))
        path = self._log_path(topic)
        try:
            size = os.path.getsize(path)
        except OSError:
            return offsets
        if size <= consumed:
            return offsets
        with open(path, "rb") as fp:
            fp.seek(consumed)
            while consumed + _HEADER.size <= size:
                header = fp.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    break
                klen, vlen, _ts = _HEADER.unpack(header)
                end = consumed + _HEADER.size + klen + vlen
                if end > size:  # torn tail from a concurrent writer; retry later
                    break
                offsets.append(consumed)
                fp.seek(end)
                consumed = end
        self._index[topic] = (offsets, consumed)
        return offsets

    def _read_record(self, topic: str, offset: int) -> Tuple[str, bytes]:
        with open(self._log_path(topic), "rb") as fp:
            fp.seek(offset)
            klen, vlen, _ts = _HEADER.unpack(fp.read(_HEADER.size))
            key = fp.read(klen).decode("utf-8", "replace")
            return key, fp.read(vlen)

    def _committed(self, topic: str, group: str) -> int:
        try:
            with open(self._offset_path(topic, group)) as fp:
                return int(fp.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def _write_offset(self, topic: str, group: str, offset: int) -> None:
        path = self._offset_path(topic, group)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fp:
            fp.write(str(offset))
            fp.flush()
            os.fsync(fp.fileno())
        os.replace(tmp, path)

    @staticmethod
    def _pid_alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
            return True
        except PermissionError:
            return True  # exists, owned by another user
        except (OSError, ProcessLookupError):
            return False

    def _read_state(self, lf) -> Dict:
        """Group delivery state: {"claims": {idx: {pid, iid, expires}},
        "acked": [indices above the committed watermark]}."""
        lf.seek(0)
        raw = lf.read()
        if not raw:
            return {"claims": {}, "acked": []}
        try:
            state = json.loads(raw.decode())
            if "claims" not in state:  # unknown / legacy layout: start clean
                return {"claims": {}, "acked": []}
            return state
        except (ValueError, UnicodeDecodeError):
            return {"claims": {}, "acked": []}

    @staticmethod
    def _write_state(lf, state: Dict) -> None:
        lf.seek(0)
        lf.truncate()
        lf.write(json.dumps(state).encode())
        lf.flush()

    def _claim_live(self, claim: Dict) -> bool:
        """A claim blocks redelivery while its owner is alive and unexpired.
        A claim from this pid but a DIFFERENT broker instance is a leftover
        from a restart in-process and is not honoured."""
        if time.time() >= claim.get("expires", 0):
            return False
        pid = claim.get("pid", -1)
        if pid == os.getpid():
            return claim.get("iid") == self._iid
        return self._pid_alive(pid)

    def subscribe(self, topic: str, group: str = "default",
                  timeout_s: Optional[float] = None) -> Optional[Message]:
        self.create_topic(topic)
        deadline = None if timeout_s is None else time.time() + timeout_s
        while True:
            with self._mu:
                offsets = self._refresh(topic)
            idx = None
            with open(self._lease_path(topic, group), "a+b") as lf:
                _lock(lf)
                try:
                    committed = self._committed(topic, group)
                    state = self._read_state(lf)
                    acked = set(state.get("acked", []))
                    claims = {int(k): v for k, v in state.get("claims", {}).items()
                              if int(k) >= committed and self._claim_live(v)}
                    # lowest record not committed, not acked, not live-claimed
                    for cand in range(committed, len(offsets)):
                        if cand not in acked and cand not in claims:
                            idx = cand
                            break
                    if idx is not None:
                        claims[idx] = {"pid": os.getpid(), "iid": self._iid,
                                       "expires": time.time() + self._lease_ttl}
                        self._write_state(lf, {
                            "claims": {str(k): v for k, v in claims.items()},
                            "acked": sorted(acked)})
                finally:
                    _unlock(lf)
            if idx is not None:
                key, value = self._read_record(topic, offsets[idx])
                break
            if deadline is not None and time.time() >= deadline:
                return None
            time.sleep(self._poll_s)

        def _commit(idx=idx):
            # ack THIS record under the group flock, then advance the durable
            # watermark over the contiguous acked prefix — commits from other
            # consumers can neither regress the offset nor skip an unacked
            # record owned by a crashed peer
            with open(self._lease_path(topic, group), "a+b") as lf:
                _lock(lf)
                try:
                    state = self._read_state(lf)
                    acked = set(state.get("acked", []))
                    acked.add(idx)
                    claims = dict(state.get("claims", {}))
                    claims.pop(str(idx), None)
                    committed = self._committed(topic, group)
                    new_committed = committed
                    while new_committed in acked:
                        acked.discard(new_committed)
                        new_committed += 1
                    if new_committed > committed:
                        self._write_offset(topic, group, new_committed)
                    # prune acks below the watermark (stale double-acks from
                    # crashed peers) so the persisted list cannot grow
                    # unboundedly over the broker's lifetime
                    acked = {i for i in acked if i >= new_committed}
                    self._write_state(lf, {"claims": claims,
                                           "acked": sorted(acked)})
                finally:
                    _unlock(lf)
            if self.metrics is not None:
                self.metrics.increment_counter("app_pubsub_commit_total_count", topic=topic)

        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_subscribe_total_count", topic=topic)
        if self.logger is not None:
            self.logger.debug(PubSubLog("SUB", topic, value.decode("utf-8", "replace")))
        return Message(topic=topic, value=value, key=key,
                       metadata={"offset": idx, "group": group}, committer=_commit)

    def requeue(self, topic: str, group: str = "default") -> None:
        """Release every claim THIS broker instance holds on the group, so
        its delivered-uncommitted records become claimable again."""
        try:
            with open(self._lease_path(topic, group), "a+b") as lf:
                _lock(lf)
                try:
                    state = self._read_state(lf)
                    state["claims"] = {
                        k: v for k, v in state.get("claims", {}).items()
                        if not (v.get("pid") == os.getpid()
                                and v.get("iid") == self._iid)}
                    self._write_state(lf, state)
                finally:
                    _unlock(lf)
        except OSError:
            pass

    # ---- health -------------------------------------------------------------
    def health_check(self) -> Health:
        if not os.path.isdir(self.root):
            return Health(status=STATUS_DOWN, details={"backend": "file", "root": self.root})
        topics = {}
        groups = {}
        with self._mu:
            for topic in sorted(os.listdir(self.root)):
                try:
                    tdir = self._topic_dir(topic)
                except ValueError:  # stray dot-entry / editor artifact: not a topic
                    continue
                if not os.path.isdir(tdir):
                    continue
                topics[topic] = len(self._refresh(topic))
                for entry in os.listdir(tdir):
                    if entry.startswith("offset.") and ".tmp." not in entry:
                        group = entry[len("offset."):]
                        groups[f"{topic}/{group}"] = self._committed(topic, group)
        return Health(status=STATUS_UP, details={
            "backend": "file", "root": self.root, "topics": topics, "groups": groups,
        })
