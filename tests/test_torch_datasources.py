"""The port's datasources (gofr_tpu_torch/datasource) and the container's
datasource switch.

The twins of tests/test_datasources.py (SQL over sqlite, the in-process KV
store), the document-store half of tests/test_file_docstore.py (the file
``file/`` utilities wait in ROADMAP A18b part 7) and the datasource half of
tests/test_gated_drivers.py: the gated MySQL / Postgres, Redis and Mongo
adapters driven through fake driver modules put into ``sys.modules``
before the gated import (no driver is installed). Then the port's own
wiring: ``Container.create``'s switch and the aggregate health, and an App
whose handlers make a SQL and a KV round trip through ``ctx``.
"""

import dataclasses
import json
import json as json_mod
import os
import sys
import threading
import time
import types
import urllib.request
from typing import Any, Dict, List

import pytest

from gofr_tpu_torch.config import MockConfig
from gofr_tpu_torch.datasource import STATUS_DOWN, STATUS_UP
from gofr_tpu_torch.datasource.docstore import DocumentStore, New, _matches
from gofr_tpu_torch.datasource.kvstore import KVStore
from gofr_tpu_torch.datasource.sql import SQL
from gofr_tpu_torch.logging import MockLogger
from gofr_tpu_torch.metrics import Manager, new_metrics_manager


@pytest.fixture()
def db():
    metrics = Manager()
    metrics.new_histogram("app_sql_stats", "")
    return SQL(MockConfig({"DB_PATH": ":memory:"}), MockLogger(), metrics)


@pytest.fixture()
def kv():
    metrics = Manager()
    metrics.new_histogram("app_kv_stats", "")
    return KVStore(MockConfig(), MockLogger(), metrics)


# -- SQL ----------------------------------------------------------------------
def test_sql_exec_query_select(db):
    db.exec("CREATE TABLE t (id INTEGER PRIMARY KEY, name TEXT)")
    db.exec("INSERT INTO t (id, name) VALUES (?, ?)", 1, "a")
    db.exec("INSERT INTO t (id, name) VALUES (?, ?)", 2, "b")
    assert db.query_row("SELECT name FROM t WHERE id = ?", 2)["name"] == "b"

    @dataclasses.dataclass
    class Row:
        id: int
        name: str

    rows = db.select(Row, "SELECT * FROM t ORDER BY id")
    assert rows == [Row(1, "a"), Row(2, "b")]
    assert db.select(dict, "SELECT * FROM t")[0]["name"] == "a"


def test_sql_transaction_commit_rollback(db):
    db.exec("CREATE TABLE t (id INTEGER)")
    with db.begin() as tx:
        tx.exec("INSERT INTO t VALUES (1)")
    assert len(db.query("SELECT * FROM t")) == 1
    try:
        with db.begin() as tx:
            tx.exec("INSERT INTO t VALUES (2)")
            raise RuntimeError("abort")
    except RuntimeError:
        pass
    assert len(db.query("SELECT * FROM t")) == 1  # rolled back


def test_sql_health(db):
    health = db.health_check()
    assert health.status == "UP"
    assert health.details["dialect"] == "sqlite"


def test_sql_metrics_recorded(db):
    db.exec("CREATE TABLE t (id INTEGER)")
    db.query("SELECT * FROM t")
    text = db.metrics.expose()
    assert 'type="SELECT"' in text and 'type="CREATE"' in text


# -- KV -----------------------------------------------------------------------
def test_kv_basic_ops(kv):
    kv.set("a", "1")
    assert kv.get("a") == "1"
    assert kv.exists("a")
    assert kv.delete("a") == 1
    assert kv.get("a") is None
    assert kv.incr("n") == 1
    assert kv.incr("n", 5) == 6
    assert kv.decr("n") == 5


def test_kv_ttl(kv):
    kv.set("x", "v", ttl_s=0.05)
    assert kv.get("x") == "v"
    assert 0 < kv.ttl("x") <= 0.05
    time.sleep(0.06)
    assert kv.get("x") is None
    assert kv.ttl("x") == -2.0
    kv.set("y", "v")
    assert kv.ttl("y") == -1.0
    assert kv.expire("y", 10)
    assert kv.ttl("y") > 9


def test_kv_hashes_and_keys(kv):
    kv.hset("h", "f1", "v1")
    kv.hset("h", "f2", "v2")
    assert kv.hget("h", "f1") == "v1"
    assert kv.hgetall("h") == {"f1": "v1", "f2": "v2"}
    kv.set("other", 1)
    assert sorted(kv.keys("*")) == ["h", "other"]
    assert kv.keys("h*") == ["h"]


def test_kv_pipeline_atomic(kv):
    pipe = kv.pipeline()
    pipe.set("a", 1).hset("h", "f", 2).set("b", 3)
    assert kv.get("a") is None  # not applied yet
    pipe.exec()
    assert kv.get("a") == 1 and kv.hget("h", "f") == 2 and kv.get("b") == 3


def test_kv_health(kv):
    kv.set("k", "v")
    health = kv.health_check()
    assert health.status == "UP"
    assert health.details["keys"] == 1



# -- document store -----------------------------------------------------------
@pytest.fixture
def store():
    s = New()
    s.use_logger(MockLogger())
    s.connect()
    return s


def test_docstore_requires_connect():
    s = DocumentStore()
    with pytest.raises(RuntimeError):
        s.insert_one("c", {"a": 1})
    assert s.health_check().status == STATUS_DOWN


def test_docstore_crud(store):
    id1 = store.insert_one("users", {"name": "ada", "age": 36})
    ids = store.insert_many("users", [{"name": "bob", "age": 20},
                                      {"name": "cy", "age": 50}])
    assert id1 and len(ids) == 2

    assert store.count_documents("users") == 3
    assert store.find_one("users", {"name": "ada"})["age"] == 36
    assert store.find_one("users", {"name": "nobody"}) is None

    older = store.find("users", {"age": {"$gte": 36}})
    assert sorted(d["name"] for d in older) == ["ada", "cy"]
    assert [d["name"] for d in store.find("users", {"age": {"$lt": 30}})] == ["bob"]
    assert store.count_documents("users", {"name": {"$in": ["ada", "bob"]}}) == 2

    assert store.update_one("users", {"name": "bob"}, {"$set": {"age": 21}}) == 1
    assert store.find_one("users", {"name": "bob"})["age"] == 21
    assert store.update_many("users", {"age": {"$gt": 30}}, {"flag": True}) == 2

    assert store.delete_one("users", {"name": "ada"}) == 1
    assert store.delete_many("users", {"age": {"$ne": None}}) == 2
    assert store.count_documents("users") == 0


def test_docstore_collections_and_health(store):
    store.create_collection("empty")
    store.insert_one("full", {"x": 1})
    h = store.health_check()
    assert h.status == STATUS_UP
    assert h.details["collections"] == 2
    store.drop_collection("full")
    assert store.count_documents("full") == 0


def test_docstore_persistence(tmp_path):
    path = str(tmp_path / "docs.json")
    s1 = New({"path": path})
    s1.use_logger(MockLogger())
    s1.connect()
    s1.insert_one("kv", {"k": "v"})
    s1.close()
    assert os.path.exists(path)

    s2 = New({"path": path})
    s2.connect()
    assert s2.find_one("kv", {"k": "v"}) is not None


def test_docstore_unsupported_operator(store):
    store.insert_one("c", {"a": 1})
    with pytest.raises(ValueError):
        store.find("c", {"a": {"$regex": "x"}})
    assert not _matches({"a": 1}, {"b": 1})


def test_docstore_app_wiring():
    from gofr_tpu_torch.container import new_mock_container

    c = new_mock_container()
    s = New()
    s.use_logger(c.logger)
    s.use_metrics(c.metrics_manager)
    s.connect()
    c.docstore = s
    s.insert_one("t", {"a": 1})  # exercises the metrics histogram path
    health = c.health()
    assert health["details"]["docstore"]["status"] == STATUS_UP


def test_docstore_restart_does_not_reissue_ids(tmp_path):
    from gofr_tpu_torch.datasource.docstore import DocumentStore

    path = str(tmp_path / "docs.json")
    s1 = DocumentStore({"path": path})
    s1.connect()
    first = s1.insert_one("c", {"n": 1})
    # fresh process over the same file: counter must seed past persisted ids
    s2 = DocumentStore({"path": path})
    s2.connect()
    second = s2.insert_one("c", {"n": 2})
    assert second != first
    assert s2.count_documents("c", {"_id": second}) == 1


def test_docstore_update_operators(tmp_path):
    from gofr_tpu_torch.datasource.docstore import DocumentStore

    s = DocumentStore()
    s.connect()
    s.insert_one("c", {"name": "a", "n": 1, "tmp": True})
    assert s.update_one("c", {"name": "a"},
                        {"$set": {"name": "b"}, "$unset": {"tmp": ""},
                         "$inc": {"n": 2}}) == 1
    doc = s.find_one("c", {"name": "b"})
    assert doc["n"] == 3 and "tmp" not in doc
    with pytest.raises(ValueError, match="unsupported update operator"):
        s.update_one("c", {}, {"$push": {"tags": "x"}})
    with pytest.raises(ValueError, match="mix"):
        s.update_one("c", {}, {"$set": {"a": 1}, "plain": 2})


def test_docstore_inc_rejects_non_numeric_delta():
    """A bad DELTA (not just a bad target) must fail before any document is
    touched — `1 + "x"` mid-batch would leave a partial update."""
    from gofr_tpu_torch.datasource.docstore import DocumentStore

    s = DocumentStore()
    s.connect()
    s.insert_one("c", {"k": "a", "n": 1})
    s.insert_one("c", {"k": "b", "n": 2})
    with pytest.raises(ValueError, match="delta.*must be numeric"):
        s.update_many("c", {}, {"$inc": {"n": "x"}})
    with pytest.raises(ValueError, match="delta.*must be numeric"):
        s.update_many("c", {}, {"$inc": {"n": True}})
    assert s.find_one("c", {"k": "a"})["n"] == 1
    assert s.find_one("c", {"k": "b"})["n"] == 2


def test_docstore_inc_validates_before_mutating():
    from gofr_tpu_torch.datasource.docstore import DocumentStore

    s = DocumentStore()
    s.connect()
    s.insert_one("c", {"k": "a", "n": 1})
    s.insert_one("c", {"k": "b", "n": "oops"})
    with pytest.raises(ValueError, match="non-numeric"):
        s.update_many("c", {}, {"$inc": {"n": 1}})
    # nothing was applied — not even to the valid first document
    assert s.find_one("c", {"k": "a"})["n"] == 1


def test_docstore_inc_checks_post_set_value():
    from gofr_tpu_torch.datasource.docstore import DocumentStore

    s = DocumentStore()
    s.connect()
    s.insert_one("c", {"n": 1})
    with pytest.raises(ValueError, match="non-numeric"):
        s.update_one("c", {}, {"$set": {"n": "x"}, "$inc": {"n": 1}})
    assert s.find_one("c", {})["n"] == 1  # untouched
    # $unset then $inc starts from 0
    assert s.update_one("c", {}, {"$unset": {"n": ""}, "$inc": {"n": 5}}) == 1
    assert s.find_one("c", {})["n"] == 5


# -- fake DB-API driver -------------------------------------------------------
class FakeCursor:
    def __init__(self, conn):
        self.conn = conn
        self._rows: List[Dict[str, Any]] = []

    def execute(self, query, args=()):
        self.conn.executed.append((query, tuple(args)))
        if self.conn.fail_next:
            self.conn.fail_next = False
            raise RuntimeError("server went away")
        q = query.strip().upper()
        if q.startswith("SELECT 1"):
            self._rows = [{"1": 1}]
        elif q.startswith("SELECT"):
            self._rows = list(self.conn.store)
        elif q.startswith("INSERT"):
            row = {"id": args[0], "name": args[1]}
            self.conn.store.append(row)
            self._rows = []
        return self

    def fetchall(self):
        return list(self._rows)


class FakeConn:
    def __init__(self, **kwargs):
        self.kwargs = kwargs
        self.executed: List[tuple] = []
        self.store: List[Dict[str, Any]] = []
        self.commits = 0
        self.rollbacks = 0
        self.fail_next = False
        self.autocommit = False

    def cursor(self):
        return FakeCursor(self)

    def commit(self):
        self.commits += 1

    def rollback(self):
        self.rollbacks += 1

    def close(self):
        pass


def _fake_mysql_module(conns: List[FakeConn], fail_connects: List[int]):
    mod = types.ModuleType("pymysql")

    def connect(**kwargs):
        if fail_connects and fail_connects[0] > 0:
            fail_connects[0] -= 1
            raise ConnectionRefusedError("no route to mysql")
        conn = FakeConn(**kwargs)
        conns.append(conn)
        return conn

    mod.connect = connect
    mod.cursors = types.SimpleNamespace(DictCursor=object())
    return mod


@pytest.fixture()
def fake_mysql(monkeypatch):
    conns: List[FakeConn] = []
    fail_connects = [0]
    monkeypatch.setitem(sys.modules, "pymysql",
                        _fake_mysql_module(conns, fail_connects))
    return conns, fail_connects


def _mysql_config(**extra):
    values = {"DB_DIALECT": "mysql", "DB_HOST": "db.internal",
              "DB_PORT": "3307", "DB_USER": "app", "DB_PASSWORD": "pw",
              "DB_NAME": "orders"}
    values.update(extra)
    return MockConfig(values)


def test_mysql_adapter_connects_and_translates_bindvars(fake_mysql):
    from gofr_tpu_torch.datasource.sql import SQL

    conns, _ = fake_mysql
    db = SQL(_mysql_config(), MockLogger(), None, background=False)
    assert len(conns) == 1
    assert conns[0].kwargs["host"] == "db.internal"
    assert conns[0].kwargs["port"] == 3307
    assert conns[0].kwargs["database"] == "orders"

    db.exec("INSERT INTO t (id, name) VALUES (?, ?)", 1, "it's ? quoted")
    query, args = conns[0].executed[-1]
    # qmark -> %s, but the ? inside the string literal is preserved
    assert query == "INSERT INTO t (id, name) VALUES (%s, %s)"
    assert args == (1, "it's ? quoted")
    assert conns[0].commits == 1

    rows = db.query("SELECT * FROM t WHERE id = ?", 1)
    assert rows == [{"id": 1, "name": "it's ? quoted"}]
    assert db.query_row("SELECT * FROM t")["id"] == 1


def test_mysql_percent_literals_survive_interpolation(fake_mysql):
    """Literal % (LIKE patterns) must be escaped to %% when args are
    interpolated, and left untouched when there are no args."""
    from gofr_tpu_torch.datasource.sql import SQL, _to_format_bindvars

    assert (_to_format_bindvars("SELECT * FROM t WHERE n LIKE 'a%' AND id = ?")
            == "SELECT * FROM t WHERE n LIKE 'a%%' AND id = %s")
    conns, _ = fake_mysql
    db = SQL(_mysql_config(), MockLogger(), None, background=False)
    db.query("SELECT * FROM t WHERE n LIKE 'a%' AND id = ?", 1)
    assert conns[0].executed[-1][0] == \
        "SELECT * FROM t WHERE n LIKE 'a%%' AND id = %s"
    # no args -> no interpolation pass -> raw query untouched
    db.query("SELECT * FROM t WHERE n LIKE 'a%'")
    assert conns[0].executed[-1] == ("SELECT * FROM t WHERE n LIKE 'a%'", ())


def test_mysql_health_and_ping_redial(fake_mysql):
    from gofr_tpu_torch.datasource.sql import SQL

    conns, _ = fake_mysql
    db = SQL(_mysql_config(), MockLogger(), None,
             retry_interval_s=0.05, background=True)
    try:
        assert db.health_check().status == "UP"
        # sever the connection: the next ping fails, the loop redials
        conns[0].fail_next = True
        deadline = time.time() + 5
        while len(conns) < 2 and time.time() < deadline:
            time.sleep(0.02)
        assert len(conns) >= 2  # redialed
        assert db.health_check().status == "UP"
    finally:
        db.close()


def test_mysql_boot_survives_connect_failure_then_retries(fake_mysql):
    from gofr_tpu_torch.datasource.sql import SQL

    conns, fail_connects = fake_mysql
    fail_connects[0] = 2  # first two dials refused
    db = SQL(_mysql_config(), MockLogger(), None,
             retry_interval_s=0.05, background=True)
    try:
        assert db.health_check().status == "DOWN"  # boot survived
        with pytest.raises(ConnectionError):
            db.query("SELECT * FROM t")
        deadline = time.time() + 5
        while db.health_check().status != "UP" and time.time() < deadline:
            time.sleep(0.02)
        assert db.health_check().status == "UP"  # retry loop recovered
    finally:
        db.close()


def test_close_stops_retry_loop_without_redial(fake_mysql):
    """close() must join the ping-retry loop before closing the connection,
    so a racing iteration cannot dial a connection nobody will close."""
    from gofr_tpu_torch.datasource.sql import SQL

    conns, _ = fake_mysql
    db = SQL(_mysql_config(), MockLogger(), None,
             retry_interval_s=0.01, background=True)
    time.sleep(0.05)  # let the loop iterate
    db.close()
    n_after_close = len(conns)
    time.sleep(0.1)
    assert len(conns) == n_after_close  # no post-close redial
    assert db._thread is None


def test_mysql_transaction_commit_rollback(fake_mysql):
    from gofr_tpu_torch.datasource.sql import SQL

    conns, _ = fake_mysql
    db = SQL(_mysql_config(), MockLogger(), None, background=False)
    with db.begin() as tx:
        tx.exec("INSERT INTO t (id, name) VALUES (?, ?)", 1, "a")
    assert conns[0].commits == 1
    with pytest.raises(RuntimeError):
        with db.begin() as tx:
            conns[0].fail_next = True
            tx.exec("INSERT INTO t (id, name) VALUES (?, ?)", 2, "b")
    assert conns[0].rollbacks == 1


def test_postgres_adapter_connect_kwargs(monkeypatch):
    from gofr_tpu_torch.datasource.sql import SQL

    conns: List[FakeConn] = []
    mod = types.ModuleType("psycopg2")

    def connect(**kwargs):
        conn = FakeConn(**kwargs)
        conns.append(conn)
        return conn

    mod.connect = connect
    extras = types.ModuleType("psycopg2.extras")
    extras.RealDictCursor = object()
    mod.extras = extras
    monkeypatch.setitem(sys.modules, "psycopg2", mod)
    monkeypatch.setitem(sys.modules, "psycopg2.extras", extras)

    cfg = MockConfig({"DB_DIALECT": "postgres", "DB_HOST": "pg", "DB_USER": "u",
                      "DB_PASSWORD": "p", "DB_NAME": "d"})
    db = SQL(cfg, MockLogger(), None, background=False)
    assert conns[0].kwargs["dbname"] == "d"
    assert conns[0].kwargs["port"] == 5432  # dialect default
    db.exec("INSERT INTO t (id, name) VALUES (?, ?)", 7, "x")
    assert conns[0].executed[-1][0].count("%s") == 2


def test_missing_driver_logs_and_stays_down(monkeypatch):
    from gofr_tpu_torch.datasource.sql import SQL

    monkeypatch.setitem(sys.modules, "pymysql", None)  # import -> ImportError
    db = SQL(_mysql_config(), MockLogger(), None, background=False)
    assert db.health_check().status == "DOWN"
    with pytest.raises(ConnectionError):
        db.query("SELECT 1")


# -- fake redis-py ------------------------------------------------------------
class FakeRedis:
    instances: List["FakeRedis"] = []

    def __init__(self, host=None, port=None, db=0, decode_responses=False):
        self.kwargs = dict(host=host, port=port, db=db)
        self.store: Dict[str, Any] = {}
        self.hashes: Dict[str, Dict[str, Any]] = {}
        self.commands = 0
        FakeRedis.instances.append(self)

    def ping(self):
        return True

    def set(self, key, value, ex=None, px=None):
        self.commands += 1
        self.last_px = px
        self.store[key] = str(value)

    def get(self, key):
        return self.store.get(key)

    def delete(self, *keys):
        return sum(1 for k in keys if self.store.pop(k, None) is not None)

    def exists(self, key):
        return 1 if key in self.store else 0

    def incrby(self, key, by):
        val = int(self.store.get(key, 0)) + by
        self.store[key] = str(val)
        return val

    def expire(self, key, ttl):
        return key in self.store

    def ttl(self, key):
        return 42 if key in self.store else -2

    def keys(self, pattern):
        return list(self.store)

    def hset(self, key, field, value):
        self.hashes.setdefault(key, {})[field] = str(value)

    def hget(self, key, field):
        return self.hashes.get(key, {}).get(field)

    def hgetall(self, key):
        return dict(self.hashes.get(key, {}))

    def flushall(self):
        self.store.clear()
        self.hashes.clear()

    def info(self, section):
        return {"total_commands_processed": self.commands}

    def pipeline(self, transaction=False):
        outer = self

        class _Pipe:
            def __init__(self):
                self.ops = []

            def set(self, key, value, px=None):
                self.ops.append(("set", key, value))

            def hset(self, key, field, value):
                self.ops.append(("hset", key, field, value))

            def delete(self, key):
                self.ops.append(("del", key))

            def execute(self):
                for op in self.ops:
                    getattr(outer, {"set": "set", "hset": "hset",
                                    "del": "delete"}[op[0]])(*op[1:])
                self.ops = []

            def reset(self):
                self.ops = []

        return _Pipe()

    def close(self):
        pass


def test_redis_kvstore_adapter(monkeypatch):
    mod = types.ModuleType("redis")
    mod.Redis = FakeRedis
    monkeypatch.setitem(sys.modules, "redis", mod)
    FakeRedis.instances.clear()

    from gofr_tpu_torch.datasource.kvredis import RedisKVStore

    cfg = MockConfig({"REDIS_HOST": "cache.internal", "REDIS_PORT": "6380"})
    kv = RedisKVStore(cfg, MockLogger(), None)
    assert FakeRedis.instances[0].kwargs == {"host": "cache.internal",
                                             "port": 6380, "db": 0}
    kv.set("a", "1")
    assert kv.get("a") == "1"
    assert kv.incr("n") == 1 and kv.incr("n", 4) == 5 and kv.decr("n") == 4
    kv.hset("h", "f", "v")
    assert kv.hget("h", "f") == "v" and kv.hgetall("h") == {"f": "v"}
    assert kv.exists("a") and kv.delete("a") == 1 and not kv.exists("a")
    # sub-second TTLs ride as milliseconds, never the invalid EX 0
    kv.set("t", "v", ttl_s=0.5)
    assert FakeRedis.instances[0].last_px == 500
    # structured hash values (the migration watermark) JSON-encode
    kv.hset("gofr_migrations", "1", {"method": "UP", "duration": 3})
    assert json_mod.loads(kv.hget("gofr_migrations", "1"))["method"] == "UP"
    # atomic pipeline mirrors kvstore.Pipeline
    pipe = kv.pipeline()
    pipe.set("p1", "x").hset("ph", "f", "y")
    pipe.exec()
    assert kv.get("p1") == "x" and kv.hget("ph", "f") == "y"
    health = kv.health_check()
    assert health.status == "UP" and health.details["backend"] == "redis"
    kv.close()


def test_redis_kvstore_container_wiring(monkeypatch):
    mod = types.ModuleType("redis")
    mod.Redis = FakeRedis
    monkeypatch.setitem(sys.modules, "redis", mod)

    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.datasource.kvredis import RedisKVStore

    c = Container.create(MockConfig({"KV_STORE": "redis"}))
    assert isinstance(c.kv, RedisKVStore)
    c.kv.set("x", "y")
    assert c.kv.get("x") == "y"


def test_redis_missing_driver_stays_down(monkeypatch):
    monkeypatch.setitem(sys.modules, "redis", None)

    from gofr_tpu_torch.datasource.kvredis import RedisKVStore

    kv = RedisKVStore(MockConfig({}), MockLogger(), None)
    assert kv.health_check().status == "DOWN"
    with pytest.raises(ConnectionError):
        kv.get("a")


# -- fake pymongo -------------------------------------------------------------
class FakeMongoCollection:
    def __init__(self):
        self.docs: List[Dict[str, Any]] = []
        self._ids = 0

    @staticmethod
    def _matches(doc, flt):
        return all(doc.get(k) == v for k, v in (flt or {}).items())

    def insert_one(self, doc):
        self._ids += 1
        doc.setdefault("_id", self._ids)
        self.docs.append(doc)
        return types.SimpleNamespace(inserted_id=doc["_id"])

    def insert_many(self, docs):
        return types.SimpleNamespace(
            inserted_ids=[self.insert_one(d).inserted_id for d in docs])

    def find(self, flt):
        matched = [d for d in self.docs if self._matches(d, flt)]

        class _Cursor(list):
            def limit(self, n):
                return _Cursor(self[:n])
        return _Cursor(matched)

    def find_one(self, flt):
        for d in self.docs:
            if self._matches(d, flt):
                return d
        return None

    def update_one(self, flt, update):
        for d in self.docs:
            if self._matches(d, flt):
                d.update(update.get("$set", {}))
                return types.SimpleNamespace(matched_count=1, modified_count=1)
        return types.SimpleNamespace(matched_count=0, modified_count=0)

    def update_many(self, flt, update):
        n = 0
        for d in self.docs:
            if self._matches(d, flt):
                d.update(update.get("$set", {}))
                n += 1
        return types.SimpleNamespace(matched_count=n, modified_count=n)

    def delete_one(self, flt):
        for i, d in enumerate(self.docs):
            if self._matches(d, flt):
                del self.docs[i]
                return types.SimpleNamespace(deleted_count=1)
        return types.SimpleNamespace(deleted_count=0)

    def delete_many(self, flt):
        before = len(self.docs)
        self.docs = [d for d in self.docs if not self._matches(d, flt)]
        return types.SimpleNamespace(deleted_count=before - len(self.docs))

    def count_documents(self, flt):
        return len([d for d in self.docs if self._matches(d, flt)])

    def drop(self):
        self.docs = []


class FakeMongoDB(dict):
    def __missing__(self, name):
        self[name] = FakeMongoCollection()
        return self[name]

    def create_collection(self, name):
        _ = self[name]


class FakeMongoClient:
    def __init__(self, uri, serverSelectionTimeoutMS=None):
        self.uri = uri
        self.dbs: Dict[str, FakeMongoDB] = {}
        self.admin = types.SimpleNamespace(command=lambda cmd: {"ok": 1})

    def __getitem__(self, name):
        return self.dbs.setdefault(name, FakeMongoDB())

    def close(self):
        pass


def test_mongo_docstore_adapter(monkeypatch):
    mod = types.ModuleType("pymongo")
    mod.MongoClient = FakeMongoClient
    mod.errors = types.SimpleNamespace(
        CollectionInvalid=type("CollectionInvalid", (Exception,), {}))
    monkeypatch.setitem(sys.modules, "pymongo", mod)

    from gofr_tpu_torch.datasource.mongostore import MongoDocumentStore

    cfg = MockConfig({"MONGO_URI": "mongodb://app:s3cret@db:27017",
                      "MONGO_DATABASE": "appdb"})
    store = MongoDocumentStore(cfg)
    store.use_logger(MockLogger())
    store.connect()

    store.insert_one("users", {"name": "ada", "age": 36})
    store.insert_many("users", [{"name": "bob"}, {"name": "eve"}])
    assert store.count_documents("users") == 3
    assert store.find_one("users", {"name": "ada"})["age"] == 36
    # plain-field update becomes $set (bundled-store semantics)
    assert store.update_one("users", {"name": "ada"}, {"age": 37}) == 1
    assert store.find_one("users", {"name": "ada"})["age"] == 37
    # operator updates pass through
    assert store.update_many("users", {}, {"$set": {"active": True}}) == 3
    assert store.delete_one("users", {"name": "bob"}) == 1
    assert len(store.find("users", {})) == 2
    # matched-count parity with the bundled store: a no-op write still
    # counts the matched document
    assert store.update_one("users", {"name": "ada"}, {"age": 37}) == 1
    assert store.health_check().status == "UP"
    store.close()
    health = store.health_check()
    assert health.status == "DOWN"
    # credentials never leak into the health aggregate
    assert "s3cret" not in str(health.details)
    assert health.details["uri"] == "mongodb://db:27017"


def test_mongo_missing_driver_raises_cleanly(monkeypatch):
    monkeypatch.setitem(sys.modules, "pymongo", None)

    from gofr_tpu_torch.datasource.mongostore import MongoDocumentStore

    with pytest.raises(RuntimeError, match="pymongo"):
        MongoDocumentStore(MockConfig({"MONGO_URI": "m", "MONGO_DATABASE": "d"}))


# -- the port's wiring ---------------------------------------------------------
@pytest.mark.parametrize("env,names", [
    ({}, set()),
    ({"DB_PATH": ":memory:"}, {"sql"}),
    ({"DB_DIALECT": "sqlite", "DB_PATH": ":memory:", "KV_ENABLED": "true",
      "PUBSUB_BACKEND": "inproc"}, {"sql", "kv", "pubsub"}),
    ({"KV_STORE": "inproc", "PUBSUB_BACKEND": "memory"}, {"kv", "pubsub"}),
], ids=["none", "sql", "all", "kv-store"])
def test_container_builds_the_datasources_the_config_asks_for(env, names):
    """The reference's switch (gofr_tpu/container/__init__.py:84-119): each
    datasource the config names is built, UP, and in the aggregate health
    by name, as the reference's container reports it."""
    from gofr_tpu.container import Container as JContainer
    from gofr_tpu.config import MockConfig as JConfig
    from gofr_tpu_torch.container import Container

    c = Container.create(MockConfig(dict(env, LOG_LEVEL="ERROR")))
    ref = JContainer.create(JConfig(dict(env, LOG_LEVEL="ERROR")))
    try:
        health = c.health()
        assert set(health["details"]) == names
        assert health["status"] == STATUS_UP
        ref_details = ref.health()["details"]
        for name in names:
            assert health["details"][name]["status"] == STATUS_UP
            assert (health["details"][name]["details"].get("backend")
                    == ref_details[name]["details"].get("backend"))
        assert (c.get_publisher() is c.pubsub
                and c.get_subscriber() is c.pubsub)
    finally:
        c.close()
        ref.close()


def test_container_survives_a_bad_pubsub_backend_and_a_down_redis():
    from gofr_tpu_torch.container import Container

    c = Container.create(MockConfig({"PUBSUB_BACKEND": "carrier-pigeon",
                                     "LOG_LEVEL": "FATAL"}))
    assert c.pubsub is None
    # a Redis KV store with no driver is built DOWN and degrades the
    # aggregate, as the reference's
    saved = sys.modules.get("redis")
    sys.modules["redis"] = None
    try:
        c = Container.create(MockConfig({"KV_STORE": "redis",
                                         "LOG_LEVEL": "FATAL"}))
    finally:
        if saved is None:
            sys.modules.pop("redis", None)
        else:
            sys.modules["redis"] = saved
    health = c.health()
    assert health["details"]["kv"]["status"] == STATUS_DOWN
    assert health["status"] == "DEGRADED"


def test_mock_container_is_the_references_shape():
    from gofr_tpu.container import new_mock_container as jmock
    from gofr_tpu_torch.container import new_mock_container

    c, ref = new_mock_container(), jmock()
    assert set(c.health()["details"]) == set(ref.health()["details"]) - {
        "tpu"}
    c.sql.exec("CREATE TABLE t (a INTEGER)")
    c.sql.exec("INSERT INTO t VALUES (?)", 7)
    assert c.sql.query_row("SELECT a FROM t")[0] == 7


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read())


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_app_handlers_reach_the_datasources_through_ctx(tmp_path):
    """An App over DB_PATH, KV_ENABLED and PUBSUB_BACKEND: a handler's SQL
    and KV round trips, a publish from a handler read back from the broker,
    an injected document store, and /.well-known/health listing sql, kv,
    pubsub and docstore UP."""
    from gofr_tpu_torch.app import App

    app = App(config={"HTTP_PORT": "0", "METRICS_PORT": "0",
                      "LOG_LEVEL": "ERROR", "DB_DIALECT": "sqlite",
                      "DB_PATH": str(tmp_path / "app.db"),
                      "KV_ENABLED": "true", "PUBSUB_BACKEND": "inproc"})
    docs = New()
    app.add_document_store(docs)

    @app.post("/row")
    def put_row(ctx):
        body = ctx.bind()
        ctx.sql.exec("CREATE TABLE IF NOT EXISTS kv (k TEXT, v TEXT)")
        ctx.sql.exec("INSERT INTO kv VALUES (?, ?)", body["k"], body["v"])
        ctx.kv.set(body["k"], body["v"])
        ctx.publish("rows", body)
        ctx.container.docstore.insert_one("rows", dict(body))
        return {"sql": ctx.sql.query_row(
                    "SELECT v FROM kv WHERE k = ?", body["k"])[0],
                "kv": ctx.kv.get(body["k"])}

    app.start()
    try:
        out = _post(app.http_port, "/row", {"k": "a", "v": "1"})
        assert out["data"] == {"sql": "1", "kv": "1"}
        msg = app.container.pubsub.subscribe("rows", "test", timeout_s=5)
        assert json.loads(msg.value) == {"k": "a", "v": "1"}
        assert docs.count_documents("rows", {"k": "a"}) == 1
        health = _get(app.http_port, "/.well-known/health")["data"]
        assert {"sql", "kv", "pubsub", "docstore"} <= set(health["details"])
        assert all(health["details"][n]["status"] == STATUS_UP
                   for n in ("sql", "kv", "pubsub", "docstore"))
    finally:
        app.shutdown()
