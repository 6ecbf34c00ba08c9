"""DI Container: the holder of the config, logger, metrics and tracer.

Counterpart of ``gofr_tpu/container/__init__.py``, cut to what the port's
servers use: ``Container`` with ``config``, ``logger`` (``LOG_LEVEL``),
``metrics_manager``, ``tracer`` (``exporter_from_config``: ``TRACE_EXPORTER``,
``TRACER_URL``), ``app_name`` (``APP_NAME``) and ``app_version``
(``APP_VERSION``); ``create`` (the framework metrics of
``register_framework_metrics`` and ``app_info``),
``refresh_runtime_metrics`` (the runtime gauges, then every hook of
``add_scrape_hook``, at every metrics scrape: the engine's stall gauge, the
utilization republish, the card-memory refresh), the aggregate ``health``
over the contributors the serving engines register
(``add_health_contributor``: a ``Health`` or a dict with a "status"; the
reference's de-flap rule for DEGRADED) and ``close`` (drains the trace
exporter).

``join_job`` joins the multi-process job the config's JAX_* keys name
(parallel/multihost.py), as the reference's ``create`` does for its device
client: once, before the first CUDA call, so a configured rank that cannot
join fails boot loudly instead of serving alone. The port calls it from
``serve.build_engine``, which knows the device (NCCL on the card, gloo
when the caller asks for the CPU).

The datasources, as the reference's ``create`` builds them from config
(``gofr_tpu/container/__init__.py:84-119``): ``sql`` under ``DB_DIALECT``
or ``DB_PATH`` (datasource/sql.py), ``kv`` under ``KV_STORE=redis`` (the
gated Redis twin) or ``KV_ENABLED`` / any other ``KV_STORE`` (the
in-process store), ``pubsub`` under ``PUBSUB_BACKEND`` (inproc | memory |
file, or the gated kafka | mqtt | google adapters, whose missing driver is
logged and leaves pub/sub None, as a bad backend name does), and
``docstore`` (injected by ``App.add_document_store``). Each joins the
aggregate ``health`` by name and is closed by ``close``;
``get_publisher`` / ``get_subscriber`` return the broker.
``new_mock_container`` is the reference's fully-faked container.

The remote log level and the device client, as the reference's
``create`` builds them: REMOTE_LOG_URL starts the level poller
(logging/remote.py) every REMOTE_LOG_FETCH_INTERVAL seconds (default 15),
stopped by ``close``; TPU_ENABLED or MODEL_NAME first joins the job of
JAX_COORDINATOR_ADDR (``join_job``: a configured rank that cannot join
fails boot), then builds ``tpu``, the device client
(tpu/device.CUDAClient, on the entry point's `device` or TPU_PLATFORM's).
A client that fails without a coordinator is logged and ``tpu`` stays
None; with one, boot fails (the other ranks wait on this one).
``App.add_tpu`` injects a client instead. It refreshes the card-memory
series at every scrape, reports in the aggregate health as ``tpu`` and is
closed by ``close``. Waiting in ROADMAP A18b part 7: the HTTP services.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional, Union

from ..config import Config, MockConfig, as_config
from ..datasource import Health, STATUS_DEGRADED, STATUS_DOWN, STATUS_UP
from ..logging import Level, Logger, MockLogger, new_logger, parse_level
from ..metrics import Manager as MetricsManager
from ..tracing import Tracer, exporter_from_config

__all__ = ["Container", "Health", "STATUS_UP", "STATUS_DOWN",
           "STATUS_DEGRADED", "new_mock_container"]

FRAMEWORK = "0.1.0-dev"

# the reference's framework histogram buckets (seconds)
HTTP_BUCKETS = (0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1, 3, 10, 30)
SQL_BUCKETS = (5e-5, 1e-4, 3e-4, 1e-3, 2e-3, 3e-3, 5e-3, 7.5e-3, 1e-2)
KV_BUCKETS = (5e-5, 1e-4, 3e-4, 5e-4, 1e-3, 2e-3, 3e-3)


class Container:
    def __init__(self, config: Config, logger: Optional[Logger] = None):
        self.config = config
        self.logger = logger or new_logger(
            parse_level(config.get_or_default("LOG_LEVEL", "INFO")))
        self.metrics_manager: Optional[MetricsManager] = None
        self.tracer: Optional[Tracer] = None
        self.sql = None
        self.kv = None
        self.pubsub = None
        self.tpu = None
        self.docstore = None
        # the REMOTE_LOG_URL poller's stop event and thread (create)
        self._level_stop = threading.Event()
        self._level_poller: Optional[threading.Thread] = None
        # app-level components in the aggregate health report (the serving
        # engines register here)
        self._health_contributors: Dict[str, Callable[[], Any]] = {}
        # name -> fn run at every metrics scrape (add_scrape_hook)
        self._scrape_hooks: Dict[str, Callable[[], Any]] = {}
        self.app_name = config.get_or_default("APP_NAME", "gofr-tpu-app")
        self.app_version = config.get_or_default("APP_VERSION", "dev")
        self._started_at = time.time()
        # consecutive health() calls that saw a DEGRADED (not DOWN)
        # contributor: see health() for the de-flap rule
        self._degraded_streak = 0

    @classmethod
    def create(cls, config: Union[Config, Mapping[str, str], None],
               device=None, device_client: bool = True) -> "Container":
        """The container of an App: its logger, its metrics manager with
        the framework metrics, its tracer, the REMOTE_LOG_URL poller, the
        datasources and, under TPU_ENABLED or MODEL_NAME (unless
        device_client is False: a process that holds no tensor, the fleet
        router), the device client. device: the entry point's device for
        the job and the client (None: TPU_PLATFORM's, the card by
        default; "cpu" for tests)."""
        config = as_config(config)
        c = cls(config)
        c.logger.debugf("container created for app %s", c.app_name)
        c.metrics_manager = MetricsManager(logger=c.logger)
        c.register_framework_metrics()
        c.metrics_manager.increment_counter(
            "app_info", 1, app_name=c.app_name, app_version=c.app_version,
            framework_version=FRAMEWORK)
        exporter = exporter_from_config(config, c.logger)
        if hasattr(exporter, "use_metrics"):
            # the async exporters count queue-overflow drops in
            # app_obs_dropped_spans_total (registered above)
            exporter.use_metrics(c.metrics_manager)
        c.tracer = Tracer(service_name=c.app_name, exporter=exporter)
        remote_url = config.get_or_default("REMOTE_LOG_URL", "")
        if remote_url:
            from ..logging.remote import start_remote_level_updater

            c._level_poller = start_remote_level_updater(
                c.logger, remote_url,
                config.get_float("REMOTE_LOG_FETCH_INTERVAL", 15.0),
                stop=c._level_stop)
        c._build_datasources()
        if device_client and (config.get_bool("TPU_ENABLED", False)
                              or config.get_or_default("MODEL_NAME", "")):
            c._build_device_client(device)
        return c

    def _build_device_client(self, device) -> None:
        """Join the job (if configured) before the first device query, then
        build the client: a rank that cannot join, or whose client fails
        once joined, fails boot (the other ranks would wait on it); a
        client that fails alone is logged and leaves ``tpu`` None."""
        from ..tpu.device import CUDAClient, requested_device

        config = self.config
        try:
            want = requested_device(config.get_or_default("TPU_PLATFORM", ""),
                                    device)
        except ValueError as exc:
            if config.get_or_default("JAX_COORDINATOR_ADDR", ""):
                raise
            self.logger.errorf("could not initialise the device client: %s",
                               exc)
            return
        joined = self.join_job(want)
        try:
            self.tpu = CUDAClient.from_config(
                config, self.logger, self.metrics_manager,
                device=joined[1] if joined else device)
        except Exception as exc:  # noqa: BLE001 - boot survives a bad datasource
            if joined:
                raise
            self.logger.errorf("could not initialise the device client: %s",
                               exc)

    def _build_datasources(self) -> None:
        """The reference's datasource switch: a datasource that cannot
        start is logged and stays None (or DOWN in the health report),
        never a failed boot."""
        config = self.config
        if (config.get_or_default("DB_DIALECT", "")
                or config.get_or_default("DB_PATH", "")):
            from ..datasource.sql import SQL
            self.sql = SQL(config, self.logger, self.metrics_manager)

        kv_backend = config.get_or_default("KV_STORE", "").lower()
        if kv_backend == "redis":
            from ..datasource.kvredis import RedisKVStore
            self.kv = RedisKVStore(config, self.logger, self.metrics_manager)
        elif config.get_bool("KV_ENABLED", False) or kv_backend:
            from ..datasource.kvstore import KVStore
            self.kv = KVStore(config, self.logger, self.metrics_manager)

        backend = config.get_or_default("PUBSUB_BACKEND", "").lower()
        if backend in ("inproc", "memory"):
            from ..pubsub.inproc import InProcBroker
            self.pubsub = InProcBroker(config, self.logger,
                                       self.metrics_manager)
        elif backend == "file":
            from ..pubsub.filebroker import FileBroker
            self.pubsub = FileBroker(config, self.logger,
                                     self.metrics_manager)
        elif backend in ("kafka", "mqtt", "google"):
            # the external drivers resolve lazily; a missing one leaves
            # pub/sub None and the boot goes on
            try:
                from ..pubsub import external
                adapter = {"kafka": external.KafkaAdapter,
                           "mqtt": external.MQTTAdapter,
                           "google": external.GooglePubSubAdapter}[backend]
                self.pubsub = adapter(config, self.logger,
                                      self.metrics_manager)
            except Exception as exc:  # noqa: BLE001
                self.logger.errorf("could not initialise %s pub/sub: %s",
                                   backend, exc)
        elif backend:
            self.logger.errorf("unsupported PUBSUB_BACKEND %r (bundled: "
                               "inproc, file; external: kafka, mqtt, "
                               "google); pub/sub disabled", backend)

    def get_publisher(self):
        return self.pubsub

    def get_subscriber(self):
        return self.pubsub

    def join_job(self, device=None, config: Optional[Config] = None,
                 backend: Optional[str] = None):
        """Join the job of the config's JAX_COORDINATOR_ADDR (and the other
        JAX_* keys) unless this process already has. Returns (spec, this
        rank's device), or None without a coordinator. config: read the
        keys there instead (serve.py's local TP job sets them over the
        App's). backend: the process group's (parallel/multihost.join;
        default NCCL on the card, gloo on the CPU)."""
        import torch
        import torch.distributed as dist

        from ..parallel.multihost import MultiHostSpec, join

        config = config or self.config
        if not config.get_or_default("JAX_COORDINATOR_ADDR", ""):
            return None
        spec = MultiHostSpec.from_config(config)
        if not dist.is_initialized():
            return spec, join(spec, device=device, logger=self.logger,
                              backend=backend)
        if device is not None and torch.device(device).type == "cpu":
            return spec, torch.device("cpu")
        return spec, torch.device("cuda", torch.cuda.current_device())

    def register_framework_metrics(self) -> None:
        m = self.metrics_manager
        m.new_counter("app_info", "static app information")
        m.new_gauge("app_python_threads", "live python threads")
        m.new_gauge("app_python_gc_objects", "objects tracked by gc")
        m.new_gauge("app_uptime_seconds", "seconds since container start")
        m.new_histogram("app_http_response", "http response time in seconds", HTTP_BUCKETS)
        m.new_histogram("app_http_service_response", "outbound http call time in seconds", HTTP_BUCKETS)
        m.new_histogram("app_sql_stats", "sql query time in seconds", SQL_BUCKETS)
        # set by the SQL datasource, which the reference does not register
        m.new_gauge("app_sql_open_connections", "open sql connections")
        m.new_gauge("app_sql_queries_total", "sql statements run")
        m.new_histogram("app_kv_stats", "kv command time in seconds", KV_BUCKETS)
        m.new_histogram("app_doc_stats", "document store op time in seconds", SQL_BUCKETS)
        m.new_counter("app_pubsub_publish_total_count", "messages published")
        m.new_counter("app_pubsub_subscribe_total_count", "messages received")
        m.new_counter("app_pubsub_commit_total_count", "messages committed")
        m.new_counter("app_pubsub_subscribe_failure_count", "handler failures")
        m.new_counter("app_obs_dropped_spans_total",
                      "finished spans dropped by the async trace exporter's "
                      "bounded queue (a dead/slow collector sheds spans "
                      "instead of blocking the span-ending thread)")

    def add_scrape_hook(self, name: str, fn: Callable[[], Any]) -> None:
        """fn() runs at every metrics scrape: for gauges whose owner cannot
        push them (a loop stuck inside a wedged device call cannot update
        its own stall gauge, so the scrape pulls the host-side reading).
        Name-keyed: registering a name again replaces its hook."""
        self._scrape_hooks[name] = fn

    def refresh_runtime_metrics(self) -> None:
        """Refreshed per metrics scrape; a hook that raises is logged and
        the scrape goes on."""
        m = self.metrics_manager
        if m is None:
            return
        m.set_gauge("app_python_threads", threading.active_count())
        m.set_gauge("app_python_gc_objects", len(gc.get_objects()) if gc.isenabled() else 0)
        m.set_gauge("app_uptime_seconds", time.time() - self._started_at)
        if self.tpu is not None and hasattr(self.tpu, "refresh_memory_metrics"):
            # a host-side read, no device round-trip: every scrape sees the
            # card's current occupancy between the memory sampler's runs
            try:
                self.tpu.refresh_memory_metrics()
            except Exception as exc:  # noqa: BLE001 - never break the scrape
                self.logger.errorf("HBM metrics refresh failed: %s", exc)
        for hook in list(self._scrape_hooks.values()):
            try:
                hook()
            except Exception as exc:  # noqa: BLE001 - never break the scrape
                self.logger.errorf("scrape hook failed: %s", exc)

    # -- aggregate health -----------------------------------------------------
    def add_health_contributor(self, name: str, fn: Callable[[], Any]) -> None:
        """Register a component in the aggregate health report. fn() returns
        a dict with a "status" of UP, DOWN or DEGRADED."""
        self._health_contributors[name] = fn

    def health(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.app_name,
            "version": self.app_version,
            "framework": FRAMEWORK,
            "status": STATUS_UP,
            "uptime_s": round(time.time() - self._started_at, 1),
        }
        details: Dict[str, Any] = {}
        statuses = []
        for name, source in (("sql", self.sql), ("kv", self.kv),
                             ("pubsub", self.pubsub), ("tpu", self.tpu),
                             ("docstore", self.docstore)):
            if source is None:
                continue
            try:
                h = source.health_check()
            except Exception as exc:  # noqa: BLE001 - a broken probe is DOWN
                h = Health(status=STATUS_DOWN, details={"error": str(exc)})
            details[name] = h.to_dict() if isinstance(h, Health) else h
            statuses.append(h.status if isinstance(h, Health)
                            else h.get("status", STATUS_DOWN))
        for name, fn in self._health_contributors.items():
            try:
                h = fn()
            except Exception as exc:  # noqa: BLE001 - a broken probe is DOWN
                h = {"status": STATUS_DOWN, "details": {"error": str(exc)}}
            if isinstance(h, Health):
                h = h.to_dict()
            details[name] = h
            statuses.append(h.get("status", STATUS_DOWN))
        # DOWN degrades the aggregate at once; a DEGRADED contributor must
        # persist across >= 2 consecutive checks
        if any(s == STATUS_DOWN for s in statuses):
            self._degraded_streak = 0
            out["status"] = STATUS_DEGRADED
        elif any(s == STATUS_DEGRADED for s in statuses):
            self._degraded_streak += 1
            if self._degraded_streak >= 2:
                out["status"] = STATUS_DEGRADED
            else:
                out["degrading"] = True  # visible, but not yet actionable
        else:
            self._degraded_streak = 0
        out["details"] = details
        return out

    def close(self) -> None:
        """Stop the level poller, drain the async trace exporter (what is
        queued reaches the collector), then close the datasources and the
        device client."""
        self._level_stop.set()
        if self._level_poller is not None:
            self._level_poller.join(timeout=5)
        tracer = self.tracer
        if tracer is not None and hasattr(tracer.exporter, "close"):
            try:
                tracer.exporter.close()
            except Exception:  # noqa: BLE001
                pass
        for source in (self.sql, self.kv, self.pubsub, self.tpu,
                       self.docstore):
            if source is not None and hasattr(source, "close"):
                try:
                    source.close()
                except Exception:  # noqa: BLE001
                    pass


def new_mock_container(config: Optional[Mapping[str, str]] = None
                       ) -> Container:
    """A container for handler unit tests, as the reference's: the real
    shape over fakes, an in-memory SQL (sqlite ``:memory:``), the
    in-process KV store and broker, and a capturing logger."""
    from ..datasource.kvstore import KVStore
    from ..datasource.sql import SQL
    from ..pubsub.inproc import InProcBroker

    cfg = MockConfig(dict(config or {}))
    c = Container(cfg, logger=MockLogger(level=Level.DEBUG))
    c.metrics_manager = MetricsManager(logger=c.logger)
    c.register_framework_metrics()
    c.tracer = Tracer(service_name="test")
    c.sql = SQL(MockConfig({"DB_PATH": ":memory:"}), c.logger,
                c.metrics_manager)
    c.kv = KVStore(cfg, c.logger, c.metrics_manager)
    c.pubsub = InProcBroker(cfg, c.logger, c.metrics_manager)
    return c

