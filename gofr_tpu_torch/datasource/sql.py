"""SQL datasource: sqlite bundled + gated mysql/postgres network dialects.

Ports ``gofr_tpu/datasource/sql.py`` whole: ``SQL`` over ``sqlite3``,
the gated MySQL / Postgres drivers, ``Tx`` and the query builders.

Parity: reference pkg/gofr/datasource/sql/ — DB wrapper logging+timing every
query into app_sql_stats (db.go:47-66), Tx wrapper (db.go:102-130), reflection
Select into structs via `db` tags (db.go:201-299 -> here dataclass fields),
query builder (query_builder.go:8-67, bindvars bind.go:24-52), health with
pool stats (health.go:26-65), mysql/postgres driver registration
(sql.go:47-55), background ping-retry loop every 10 s (sql.go:86-110), and
the pool-stats gauge pusher (sql.go:141-154).

Dialects: DB_DIALECT=sqlite (bundled, default), mysql (gated on `pymysql`),
postgres (gated on `psycopg2`). A missing driver or unreachable server logs
and leaves the datasource down — boot survives (sql.go:33-36) — while the
retry loop keeps dialing until the dependency appears.
"""

from __future__ import annotations

import dataclasses
import sqlite3
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Type

from ..logging import PrettyPrint
from . import Health, STATUS_DOWN, STATUS_UP

RETRY_INTERVAL_S = 10.0  # sql.go:87
STATS_INTERVAL_S = 10.0  # sql.go:142


class QueryLog(PrettyPrint):
    """Structured SQL log record (sql/db.go:30-38)."""

    def __init__(self, query: str, duration_us: int, args_count: int):
        self.query = query
        self.duration_us = duration_us
        self.args_count = args_count

    def pretty_print(self, fp) -> None:
        fp.write(f"\x1b[36mSQL\x1b[0m {self.duration_us:>8}µs {self.query}")


# -- dialect drivers ----------------------------------------------------------
class _SqliteDriver:
    """Bundled dialect; rows are sqlite3.Row (mapping access)."""

    name = "sqlite"
    paramstyle = "qmark"

    def __init__(self, config):
        self.path = config.get_or_default(
            "DB_PATH", config.get_or_default("DB_NAME", ":memory:"))

    def connect(self):
        conn = sqlite3.connect(self.path, check_same_thread=False)
        conn.row_factory = sqlite3.Row
        return conn

    def describe(self) -> Dict[str, Any]:
        return {"path": self.path}

    def execute(self, conn, query: str, args: Sequence[Any]):
        return conn.execute(query, args)

    def fetchall(self, cursor) -> List[Any]:
        return cursor.fetchall()

    def ping(self, conn) -> None:
        conn.execute("SELECT 1")


class _NetworkDriver:
    """Shared shape for DB-API network dialects (mysql/postgres): %s
    bindvars (bind.go:24-52 translates per dialect the same way), cursors
    returning dict rows, TCP connect params from config."""

    paramstyle = "format"

    def __init__(self, config, module):
        self.module = module
        self.host = config.get_or_default("DB_HOST", "localhost")
        self.port = config.get_int("DB_PORT", self.default_port)
        self.user = config.get_or_default("DB_USER", "")
        self.password = config.get_or_default("DB_PASSWORD", "")
        self.database = config.get_or_default("DB_NAME", "")

    def describe(self) -> Dict[str, Any]:
        return {"host": self.host, "port": self.port, "database": self.database}

    def execute(self, conn, query: str, args: Sequence[Any]):
        cursor = conn.cursor()
        if args:
            cursor.execute(_to_format_bindvars(query), tuple(args))
        else:
            # no params -> no %-interpolation pass; literal % stays as-is
            cursor.execute(query)
        return cursor

    def fetchall(self, cursor) -> List[Any]:
        return list(cursor.fetchall())

    def ping(self, conn) -> None:
        cursor = conn.cursor()
        cursor.execute("SELECT 1")
        cursor.fetchall()


class _MySQLDriver(_NetworkDriver):
    name = "mysql"
    default_port = 3306

    def connect(self):
        return self.module.connect(
            host=self.host, port=self.port, user=self.user,
            password=self.password, database=self.database,
            cursorclass=self.module.cursors.DictCursor)


class _PostgresDriver(_NetworkDriver):
    name = "postgres"
    default_port = 5432

    def connect(self):
        conn = self.module.connect(
            host=self.host, port=self.port, user=self.user,
            password=self.password, dbname=self.database,
            cursor_factory=self.module.extras.RealDictCursor)
        conn.autocommit = False
        return conn


def _to_format_bindvars(query: str) -> str:
    """qmark -> format placeholders, skipping quoted literals (bind.go).

    Literal '%' doubles to '%%' EVERYWHERE (including inside string
    literals): DB-API format-paramstyle drivers %-interpolate the whole
    statement when args are passed, so `LIKE 'a%'` would otherwise raise
    'unsupported format character'."""
    out, in_str = [], False
    for ch in query:
        if ch == "'":
            in_str = not in_str
            out.append(ch)
        elif ch == "%":
            out.append("%%")
        elif ch == "?" and not in_str:
            out.append("%s")
        else:
            out.append(ch)
    return "".join(out)


def _make_driver(config, logger):
    dialect = config.get_or_default("DB_DIALECT", "sqlite")
    if dialect == "sqlite":
        return _SqliteDriver(config)
    if dialect == "mysql":
        import importlib

        try:
            module = importlib.import_module("pymysql")
        except ImportError:
            logger.errorf("DB_DIALECT=mysql needs the 'pymysql' package")
            return None
        return _MySQLDriver(config, module)
    if dialect == "postgres":
        import importlib

        try:
            module = importlib.import_module("psycopg2")
            importlib.import_module("psycopg2.extras")
        except ImportError:
            logger.errorf("DB_DIALECT=postgres needs the 'psycopg2' package")
            return None
        return _PostgresDriver(config, module)
    logger.errorf("unknown DB_DIALECT %r (sqlite|mysql|postgres)", dialect)
    return None


class SQL:
    """Connection wrapper; one writer at a time (network dialects share the
    single connection the same way — the reference's pool is database/sql's,
    here the lock is the pool of size 1)."""

    def __init__(self, config, logger, metrics,
                 retry_interval_s: float = RETRY_INTERVAL_S,
                 background: bool = True):
        self.logger = logger
        self.metrics = metrics
        self.dialect = config.get_or_default("DB_DIALECT", "sqlite")
        self.driver = _make_driver(config, logger)
        self.path = getattr(self.driver, "path", "")  # sqlite detail for health
        self._lock = threading.RLock()
        self._conn = None
        self._connected_at: Optional[float] = None
        self._query_count = 0
        self._retry_interval_s = retry_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._connect()
        if background:
            # reconnect-retry + pool-stats pusher (sql.go:65-67 spawns both)
            self._thread = threading.Thread(target=self._background_loop,
                                            name="sql-retry", daemon=True)
            self._thread.start()

    def _connect(self) -> None:
        if self.driver is None or self._stop.is_set():
            return
        try:
            self._conn = self.driver.connect()
            self._connected_at = time.time()
            self.logger.infof("connected to %s database (%s)", self.dialect,
                              self.driver.describe())
        except Exception as exc:  # noqa: BLE001
            # boot must survive a bad datasource config (sql/sql.go:33-36)
            self.logger.errorf("could not connect to database: %s", exc)
            self._conn = None

    def _background_loop(self) -> None:
        """Ping-retry every interval (sql.go:86-110) + push pool stats
        (sql.go:141-154)."""
        while not self._stop.wait(self._retry_interval_s):
            with self._lock:
                conn = self._conn
            if conn is None:
                self._connect()
            else:
                try:
                    with self._lock:
                        self.driver.ping(self._conn)
                except Exception as exc:  # noqa: BLE001
                    self.logger.errorf("database ping failed, redialing: %s", exc)
                    with self._lock:
                        self._conn = None
                    self._connect()
            self._push_stats()

    def _push_stats(self) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.set_gauge("app_sql_open_connections",
                                   1.0 if self._conn is not None else 0.0)
            self.metrics.set_gauge("app_sql_queries_total",
                                   float(self._query_count))
        except Exception:  # noqa: BLE001 - gauges may not be registered
            pass

    def _observe(self, query: str, start: float, args: Sequence[Any]) -> None:
        elapsed = time.time() - start
        self._query_count += 1
        if self.metrics is not None:
            stmt = query.strip().split(" ", 1)[0].upper() if query.strip() else "?"
            self.metrics.record_histogram("app_sql_stats", elapsed, type=stmt)
        self.logger.debug(QueryLog(query, int(elapsed * 1e6), len(args)))

    def _require_conn(self):
        if self.driver is None or self._conn is None:
            raise ConnectionError(f"{self.dialect} database is not connected")
        return self._conn

    # -- query API ------------------------------------------------------------
    def exec(self, query: str, *args: Any):
        start = time.time()
        with self._lock:
            conn = self._require_conn()
            cur = self.driver.execute(conn, query, args)
            conn.commit()
        self._observe(query, start, args)
        return cur

    def query(self, query: str, *args: Any) -> List[Any]:
        start = time.time()
        with self._lock:
            conn = self._require_conn()
            cur = self.driver.execute(conn, query, args)
            rows = self.driver.fetchall(cur)
        self._observe(query, start, args)
        return rows

    def query_row(self, query: str, *args: Any) -> Optional[Any]:
        rows = self.query(query, *args)
        return rows[0] if rows else None

    def select(self, target_type: Type, query: str, *args: Any) -> List[Any]:
        """Reflection select: rows -> list of `target_type` (dataclass or dict)."""
        rows = self.query(query, *args)
        if target_type is dict:
            return [dict(r) for r in rows]
        if dataclasses.is_dataclass(target_type):
            names = {f.name for f in dataclasses.fields(target_type)}
            out = []
            for r in rows:
                mapping = dict(r)
                out.append(target_type(**{k: v for k, v in mapping.items()
                                          if k in names}))
            return out
        raise TypeError("select target must be dict or a dataclass type")

    def begin(self) -> "Tx":
        return Tx(self)

    # -- health ---------------------------------------------------------------
    def health_check(self) -> Health:
        details: Dict[str, Any] = {"dialect": self.dialect}
        if self.driver is not None:
            details.update(self.driver.describe())
        if self._conn is None:
            return Health(status=STATUS_DOWN, details=details)
        try:
            with self._lock:
                self.driver.ping(self._conn)
            details.update(queries=self._query_count,
                           uptime_s=round(time.time() - (self._connected_at
                                                         or time.time()), 1))
            return Health(status=STATUS_UP, details=details)
        except Exception as exc:  # noqa: BLE001
            details["error"] = str(exc)
            return Health(status=STATUS_DOWN, details=details)

    def close(self) -> None:
        # stop and JOIN the retry loop BEFORE closing the connection — an
        # in-flight iteration could otherwise see the closed conn as a ping
        # failure and dial a fresh connection nobody will ever close
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None


class Tx:
    """Explicit transaction (sql/db.go:102-130). Commit or rollback exactly once."""

    def __init__(self, db: SQL):
        self.db = db
        self.db._lock.acquire()
        try:
            conn = db._require_conn()
            if db.dialect == "sqlite":
                conn.execute("BEGIN")
            # network DB-API conns open a tx implicitly on first statement
        except BaseException:
            self.db._lock.release()
            raise
        self._done = False

    def exec(self, query: str, *args: Any):
        start = time.time()
        cur = self.db.driver.execute(self.db._conn, query, args)
        self.db._observe(query, start, args)
        return cur

    def query(self, query: str, *args: Any) -> List[Any]:
        start = time.time()
        cur = self.db.driver.execute(self.db._conn, query, args)
        rows = self.db.driver.fetchall(cur)
        self.db._observe(query, start, args)
        return rows

    def commit(self) -> None:
        if not self._done:
            self.db._conn.commit()
            self._done = True
            self.db._lock.release()

    def rollback(self) -> None:
        if not self._done:
            self.db._conn.rollback()
            self._done = True
            self.db._lock.release()

    def __enter__(self) -> "Tx":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.rollback()
        else:
            self.commit()


# -- dialect-aware query builder (backs the CRUD generator) -------------------
def insert_query(table: str, columns: Iterable[str]) -> str:
    cols = list(columns)
    placeholders = ", ".join(["?"] * len(cols))
    return f"INSERT INTO {table} ({', '.join(cols)}) VALUES ({placeholders})"


def select_all_query(table: str) -> str:
    return f"SELECT * FROM {table}"


def select_by_query(table: str, key: str) -> str:
    return f"SELECT * FROM {table} WHERE {key} = ?"


def update_by_query(table: str, columns: Iterable[str], key: str) -> str:
    sets = ", ".join(f"{c} = ?" for c in columns)
    return f"UPDATE {table} SET {sets} WHERE {key} = ?"


def delete_by_query(table: str, key: str) -> str:
    return f"DELETE FROM {table} WHERE {key} = ?"
