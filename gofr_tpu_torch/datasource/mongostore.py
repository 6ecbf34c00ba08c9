"""Mongo-backed document store: the network twin of DocumentStore.

Ports ``gofr_tpu/datasource/mongostore.py`` whole:
``MongoDocumentStore`` (gated on ``pymongo``).

Parity: reference pkg/gofr/datasource/mongo/ — INJECTED driver following
the provider pattern (mongo.go:41-74: New(Config) + UseLogger/UseMetrics/
Connect, wired by externalDB.go:5-12), 11 CRUD ops each logged+timed
(mongo.go:77-198). Gated on `pymongo`: CONSTRUCTION raises a clear
RuntimeError when the driver is absent — like the reference, the app
injects an already-constructed client, so the caller decides at boot
whether a missing driver is fatal (catch the error and skip
add_document_store to keep the nil-datasource posture).

Same operation surface as datasource.docstore.DocumentStore, so handlers
written against ctx (find/insert/update/delete/count) run unchanged when a
MongoDocumentStore is injected.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from . import Health, STATUS_DOWN, STATUS_UP
from .docstore import DocLog


class MongoDocumentStore:
    """Provider-pattern Mongo client (inject via App.add_document_store)."""

    def __init__(self, config=None, uri: str = "", database: str = ""):
        try:
            import pymongo
        except ImportError as exc:
            raise RuntimeError(
                "MongoDocumentStore needs the 'pymongo' package") from exc
        self._pymongo = pymongo
        if config is not None:
            uri = uri or config.get_or_default("MONGO_URI", "")
            database = database or config.get_or_default("MONGO_DATABASE", "")
        if not uri or not database:
            raise ValueError("MongoDocumentStore needs MONGO_URI and "
                             "MONGO_DATABASE")
        self.uri = uri
        self.database_name = database
        self.logger = None
        self.metrics = None
        self.tracer = None
        self._client = None
        self._db = None
        self._connected_at: Optional[float] = None

    # -- provider wiring (mongo.go:41-74) -------------------------------------
    def use_logger(self, logger) -> None:
        self.logger = logger

    def use_metrics(self, metrics) -> None:
        self.metrics = metrics

    def use_tracer(self, tracer) -> None:
        self.tracer = tracer

    def connect(self) -> None:
        self._client = self._pymongo.MongoClient(self.uri,
                                                 serverSelectionTimeoutMS=5000)
        self._db = self._client[self.database_name]
        self._connected_at = time.time()
        if self.logger is not None:
            self.logger.infof("connected to mongo database %s",
                              self.database_name)

    def _observe(self, operation: str, collection: str, start: float) -> None:
        elapsed = time.time() - start
        if self.metrics is not None:
            try:
                self.metrics.record_histogram("app_doc_stats", elapsed,
                                              operation=operation)
            except Exception:  # noqa: BLE001
                pass
        if self.logger is not None:
            self.logger.debug(DocLog(operation, collection,
                                     int(elapsed * 1e6)))

    def _require(self):
        if self._db is None:
            raise ConnectionError("mongo is not connected")
        return self._db

    # -- CRUD (DocumentStore-compatible surface) ------------------------------
    def insert_one(self, collection: str, document: Dict[str, Any]) -> Any:
        start = time.time()
        result = self._require()[collection].insert_one(dict(document))
        self._observe("insertOne", collection, start)
        return result.inserted_id

    def insert_many(self, collection: str,
                    documents: List[Dict[str, Any]]) -> List[Any]:
        start = time.time()
        result = self._require()[collection].insert_many(
            [dict(d) for d in documents])
        self._observe("insertMany", collection, start)
        return list(result.inserted_ids)

    def find(self, collection: str,
             filter: Optional[Dict[str, Any]] = None,
             limit: int = 0) -> List[Dict[str, Any]]:
        start = time.time()
        cursor = self._require()[collection].find(filter or {})
        if limit:
            cursor = cursor.limit(limit)
        out = list(cursor)
        self._observe("find", collection, start)
        return out

    def find_one(self, collection: str,
                 filter: Optional[Dict[str, Any]] = None) -> Optional[Dict[str, Any]]:
        start = time.time()
        out = self._require()[collection].find_one(filter or {})
        self._observe("findOne", collection, start)
        return out

    def update_one(self, collection: str, filter: Dict[str, Any],
                   update: Dict[str, Any]) -> int:
        start = time.time()
        result = self._require()[collection].update_one(
            filter, self._as_update(update))
        self._observe("updateOne", collection, start)
        # matched, not modified: the bundled store counts every matched
        # target even when the write is a no-op — parity over Mongo's
        # modified_count quirk
        return result.matched_count

    def update_many(self, collection: str, filter: Dict[str, Any],
                    update: Dict[str, Any]) -> int:
        start = time.time()
        result = self._require()[collection].update_many(
            filter, self._as_update(update))
        self._observe("updateMany", collection, start)
        return result.matched_count

    @staticmethod
    def _as_update(update: Dict[str, Any]) -> Dict[str, Any]:
        """Plain-field updates become $set (the bundled store's semantics);
        operator updates pass through to the server."""
        if any(k.startswith("$") for k in update):
            return update
        return {"$set": update}

    def delete_one(self, collection: str, filter: Dict[str, Any]) -> int:
        start = time.time()
        result = self._require()[collection].delete_one(filter)
        self._observe("deleteOne", collection, start)
        return result.deleted_count

    def delete_many(self, collection: str, filter: Dict[str, Any]) -> int:
        start = time.time()
        result = self._require()[collection].delete_many(filter)
        self._observe("deleteMany", collection, start)
        return result.deleted_count

    def count_documents(self, collection: str,
                        filter: Optional[Dict[str, Any]] = None) -> int:
        start = time.time()
        out = self._require()[collection].count_documents(filter or {})
        self._observe("countDocuments", collection, start)
        return out

    def create_collection(self, collection: str) -> None:
        start = time.time()
        db = self._require()  # not-connected must raise, not be swallowed
        try:
            db.create_collection(collection)
        except self._pymongo.errors.CollectionInvalid:  # already exists
            pass
        self._observe("createCollection", collection, start)

    def drop_collection(self, collection: str) -> None:
        start = time.time()
        self._require()[collection].drop()
        self._observe("dropCollection", collection, start)

    @staticmethod
    def _redact(uri: str) -> str:
        """Strip userinfo from the URI — health details flow into the
        public /.well-known/health aggregate."""
        import re

        return re.sub(r"//[^@/]+@", "//", uri)

    # -- health ---------------------------------------------------------------
    def health_check(self) -> Health:
        if self._client is None:
            return Health(status=STATUS_DOWN,
                          details={"backend": "mongo",
                                   "uri": self._redact(self.uri)})
        try:
            self._client.admin.command("ping")
            return Health(status=STATUS_UP, details={
                "backend": "mongo", "database": self.database_name,
                "uptime_s": round(time.time() - (self._connected_at
                                                 or time.time()), 1),
            })
        except Exception as exc:  # noqa: BLE001
            return Health(status=STATUS_DOWN,
                          details={"backend": "mongo", "error": str(exc)})

    def close(self) -> None:
        if self._client is not None:
            try:
                self._client.close()
            except Exception:  # noqa: BLE001
                pass
            self._client = None
            self._db = None
