"""Document store datasource: Mongo-shaped API behind the injected-provider pattern.

Ports ``gofr_tpu/datasource/docstore.py`` whole: ``DocLog``, the file
``DocumentStore`` and ``New``.

Parity: reference pkg/gofr/datasource/mongo/ — the *injected* datasource idiom
(not auto-built by the container): `New(Config)` then `UseLogger/UseMetrics/
Connect` (mongo.go:41-74), the consumer-side interface the container holds
(datasource/mongo.go:142-155), wiring via App.AddMongo (externalDB.go:5-12),
and the 11 CRUD operations each logged and timed (mongo.go:77-198). This is
the pattern every future external datasource (including user-provided device
clients) follows.

The bundled backend is an in-process document store with Mongo-style filter
operators ($gt/$gte/$lt/$lte/$ne/$in) and optional JSON-file persistence —
the zero-egress tier; the API surface is what user code programs against.
The network twin is datasource/mongostore.MongoDocumentStore (same provider
pattern + operation surface; its constructor raises cleanly when pymongo is
absent), injected via App.add_document_store.
"""

from __future__ import annotations

import copy
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..logging import PrettyPrint
from . import Health, STATUS_DOWN, STATUS_UP



class DocLog(PrettyPrint):
    """Structured per-operation record (mongo.go QueryLog analog)."""

    def __init__(self, operation: str, collection: str, duration_us: int):
        self.operation = operation
        self.collection = collection
        self.duration_us = duration_us

    def pretty_print(self, fp) -> None:
        fp.write(f"\x1b[32mDOC\x1b[0m {self.duration_us:>8}µs "
                 f"{self.operation} {self.collection}")


def _matches(doc: Dict[str, Any], filter: Dict[str, Any]) -> bool:
    for key, cond in (filter or {}).items():
        value = doc.get(key)
        if isinstance(cond, dict):
            for op, want in cond.items():
                if op == "$gt":
                    ok = value is not None and value > want
                elif op == "$gte":
                    ok = value is not None and value >= want
                elif op == "$lt":
                    ok = value is not None and value < want
                elif op == "$lte":
                    ok = value is not None and value <= want
                elif op == "$ne":
                    ok = value != want
                elif op == "$in":
                    ok = value in want
                else:
                    raise ValueError(f"unsupported filter operator {op!r}")
                if not ok:
                    return False
        elif value != cond:
            return False
    return True


class DocumentStore:
    """Provider-pattern document store. Construct with `New(config)`, then
    `use_logger` / `use_metrics` / `connect` — mirroring mongo.go:41-74."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = dict(config or {})
        self.logger = None
        self.metrics = None
        self.tracer = None
        self._collections: Dict[str, List[Dict[str, Any]]] = {}
        self._lock = threading.RLock()
        self._connected = False
        self._path: Optional[str] = self.config.get("path") or None
        self._id_counter = itertools.count(1)

    # -- provider wiring (mongo.go:41-74) -------------------------------------
    def use_logger(self, logger) -> None:
        self.logger = logger

    def use_metrics(self, metrics) -> None:
        self.metrics = metrics

    def use_tracer(self, tracer) -> None:
        self.tracer = tracer

    def connect(self) -> None:
        if self._path and os.path.exists(self._path):
            with open(self._path, "r", encoding="utf-8") as fp:
                self._collections = json.load(fp)
            # seed the id counter past every persisted integer _id so a
            # restarted process never reissues an id
            max_id = max((doc["_id"] for docs in self._collections.values()
                          for doc in docs if isinstance(doc.get("_id"), int)),
                         default=0)
            self._id_counter = itertools.count(max_id + 1)
        self._connected = True
        if self.logger is not None:
            self.logger.infof("document store connected (%s)",
                              self._path or "in-memory")

    # -- instrumentation ------------------------------------------------------
    def _observe(self, operation: str, collection: str, start: float) -> None:
        elapsed = time.time() - start
        if self.logger is not None:
            self.logger.debug(DocLog(operation, collection, int(elapsed * 1e6)))
        if self.metrics is not None:
            try:
                self.metrics.record_histogram("app_doc_stats", elapsed,
                                              operation=operation)
            except Exception:  # noqa: BLE001 - histogram may not be registered
                pass

    def _require_connected(self) -> None:
        if not self._connected:
            raise RuntimeError("document store used before connect()")

    def _coll(self, name: str) -> List[Dict[str, Any]]:
        return self._collections.setdefault(name, [])

    def _persist(self) -> None:
        if self._path:
            tmp = self._path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fp:
                json.dump(self._collections, fp)
            os.replace(tmp, self._path)

    # -- the 11 CRUD operations (mongo.go:77-198) -----------------------------
    def insert_one(self, collection: str, document: Dict[str, Any]) -> Any:
        self._require_connected()
        start = time.time()
        doc = copy.deepcopy(document)
        doc.setdefault("_id", next(self._id_counter))
        with self._lock:
            self._coll(collection).append(doc)
            self._persist()
        self._observe("insertOne", collection, start)
        return doc["_id"]

    def insert_many(self, collection: str,
                    documents: List[Dict[str, Any]]) -> List[Any]:
        self._require_connected()
        start = time.time()
        ids = []
        with self._lock:
            for document in documents:
                doc = copy.deepcopy(document)
                doc.setdefault("_id", next(self._id_counter))
                self._coll(collection).append(doc)
                ids.append(doc["_id"])
            self._persist()
        self._observe("insertMany", collection, start)
        return ids

    def find(self, collection: str,
             filter: Optional[Dict[str, Any]] = None,
             limit: int = 0) -> List[Dict[str, Any]]:
        self._require_connected()
        start = time.time()
        with self._lock:
            out = [copy.deepcopy(d) for d in self._coll(collection)
                   if _matches(d, filter or {})]
        if limit:
            out = out[:limit]
        self._observe("find", collection, start)
        return out

    def find_one(self, collection: str,
                 filter: Optional[Dict[str, Any]] = None) -> Optional[Dict[str, Any]]:
        self._require_connected()
        start = time.time()
        with self._lock:
            for d in self._coll(collection):
                if _matches(d, filter or {}):
                    self._observe("findOne", collection, start)
                    return copy.deepcopy(d)
        self._observe("findOne", collection, start)
        return None

    def update_one(self, collection: str, filter: Dict[str, Any],
                   update: Dict[str, Any]) -> int:
        return self._update(collection, filter, update, many=False)

    def update_many(self, collection: str, filter: Dict[str, Any],
                    update: Dict[str, Any]) -> int:
        return self._update(collection, filter, update, many=True)

    def _update(self, collection: str, filter: Dict[str, Any],
                update: Dict[str, Any], many: bool) -> int:
        self._require_connected()
        start = time.time()
        operators = {k: v for k, v in update.items() if k.startswith("$")}
        if operators:
            unsupported = set(operators) - {"$set", "$unset", "$inc"}
            if unsupported:  # match _matches' posture: raise, don't corrupt
                raise ValueError(
                    f"unsupported update operator(s) {sorted(unsupported)}")
            plain = {k: v for k, v in update.items() if not k.startswith("$")}
            if plain:
                raise ValueError("cannot mix update operators with plain fields")

        # validate $inc deltas BEFORE any document is touched: applying a
        # non-numeric delta mid-iteration would leave earlier matches
        # updated and later ones not (mongo rejects non-numeric $inc too)
        for key, delta in operators.get("$inc", {}).items():
            if isinstance(delta, bool) or not isinstance(delta, (int, float)):
                raise ValueError(
                    f"$inc delta for {key!r} must be numeric, got "
                    f"{type(delta).__name__}")

        def apply(d: Dict[str, Any]) -> None:
            if not operators:
                d.update(copy.deepcopy(update))
                return
            for key, value in operators.get("$set", {}).items():
                d[key] = copy.deepcopy(value)
            for key in operators.get("$unset", {}):
                d.pop(key, None)
            for key, delta in operators.get("$inc", {}).items():
                # target types were dry-run-validated before mutation below
                d[key] = d.get(key, 0) + delta

        count = 0
        with self._lock:
            targets = []
            for d in self._coll(collection):
                if _matches(d, filter):
                    targets.append(d)
                    if not many:
                        break
            # validate $inc against every target BEFORE mutating anything so
            # a type error cannot leave a partially-applied, unpersisted
            # batch; the value checked is the POST-$set/$unset one, since
            # apply() runs $set/$unset first
            for key in operators.get("$inc", {}):
                for d in targets:
                    if key in operators.get("$set", {}):
                        value = operators["$set"][key]
                    elif key in operators.get("$unset", {}):
                        value = 0
                    else:
                        value = d.get(key, 0)
                    if not isinstance(value, (int, float)) or isinstance(value, bool):
                        raise ValueError(
                            f"$inc target field {key!r} is non-numeric "
                            f"({type(value).__name__})")
            for d in targets:
                apply(d)
                count += 1
            self._persist()
        self._observe("updateMany" if many else "updateOne", collection, start)
        return count

    def delete_one(self, collection: str, filter: Dict[str, Any]) -> int:
        return self._delete(collection, filter, many=False)

    def delete_many(self, collection: str, filter: Dict[str, Any]) -> int:
        return self._delete(collection, filter, many=True)

    def _delete(self, collection: str, filter: Dict[str, Any], many: bool) -> int:
        self._require_connected()
        start = time.time()
        count = 0
        with self._lock:
            docs = self._coll(collection)
            kept = []
            for d in docs:
                if _matches(d, filter) and (many or count == 0):
                    count += 1
                else:
                    kept.append(d)
            self._collections[collection] = kept
            self._persist()
        self._observe("deleteMany" if many else "deleteOne", collection, start)
        return count

    def count_documents(self, collection: str,
                        filter: Optional[Dict[str, Any]] = None) -> int:
        self._require_connected()
        start = time.time()
        with self._lock:
            n = sum(1 for d in self._coll(collection) if _matches(d, filter or {}))
        self._observe("countDocuments", collection, start)
        return n

    def create_collection(self, collection: str) -> None:
        self._require_connected()
        start = time.time()
        with self._lock:
            self._coll(collection)
            self._persist()
        self._observe("createCollection", collection, start)

    def drop_collection(self, collection: str) -> None:
        self._require_connected()
        start = time.time()
        with self._lock:
            self._collections.pop(collection, None)
            self._persist()
        self._observe("dropCollection", collection, start)

    # -- health (mongo health analog; feeds /.well-known/health) --------------
    def health_check(self) -> Health:
        if not self._connected:
            return Health(status=STATUS_DOWN, details={"error": "not connected"})
        with self._lock:
            return Health(status=STATUS_UP, details={
                "backend": self._path or "in-memory",
                "collections": len(self._collections),
                "documents": sum(len(v) for v in self._collections.values()),
            })

    def close(self) -> None:
        with self._lock:
            self._persist()
        self._connected = False


def New(config: Optional[Dict[str, Any]] = None) -> DocumentStore:  # noqa: N802
    """Reference-named factory (mongo.go:41)."""
    return DocumentStore(config)
