"""The port's pub/sub (gofr_tpu_torch/pubsub): the in-process broker, the
durable file broker and the gated external adapters.

The twins of tests/test_filebroker.py and of the pub/sub half of
tests/test_gated_drivers.py: the Kafka, MQTT and Google adapters driven
through fake driver modules put into ``sys.modules`` before the gated
import (no driver is installed). A file broker's log is shared across the
two packages: what one writes and commits, the other reads and resumes
from, in both directions. The in-process broker's consumer groups,
redelivery and health close the file.
"""

import json
import json as json_mod
import os
import subprocess
import sys
import threading
import time
import types
from typing import Any, Dict, List

import pytest

from gofr_tpu_torch.config import MockConfig
from gofr_tpu_torch.logging import MockLogger
from gofr_tpu_torch.metrics import new_metrics_manager
from gofr_tpu_torch.pubsub.filebroker import FileBroker


@pytest.fixture()
def broker(tmp_path):
    return FileBroker(root=str(tmp_path / "broker"))



def test_publish_subscribe_commit_order(broker):
    broker.publish("t", b"m1", key="k1")
    broker.publish("t", b"m2")
    msg = broker.subscribe("t", group="g", timeout_s=1)
    assert (msg.value, msg.key) == (b"m1", "k1")
    msg.commit()
    assert broker.subscribe("t", group="g", timeout_s=1).value == b"m2"


def test_uncommitted_redelivered_after_restart(tmp_path):
    root = str(tmp_path / "b")
    b1 = FileBroker(root=root)
    b1.publish("jobs", b"payload")
    assert b1.subscribe("jobs", group="g", timeout_s=1).value == b"payload"
    # no commit; a fresh broker instance (process restart) must redeliver
    b2 = FileBroker(root=root)
    msg = b2.subscribe("jobs", group="g", timeout_s=1)
    assert msg.value == b"payload"
    msg.commit()
    b3 = FileBroker(root=root)
    assert b3.subscribe("jobs", group="g", timeout_s=0.05) is None


def test_commit_is_durable_and_atomic(tmp_path):
    root = str(tmp_path / "b")
    b1 = FileBroker(root=root)
    for i in range(5):
        b1.publish("t", f"m{i}".encode())
    for _ in range(3):
        b1.subscribe("t", group="g", timeout_s=1).commit()
    b2 = FileBroker(root=root)
    assert b2.subscribe("t", group="g", timeout_s=1).value == b"m3"


def test_independent_groups(broker):
    broker.publish("t", b"x")
    assert broker.subscribe("t", group="g1", timeout_s=1).value == b"x"
    assert broker.subscribe("t", group="g2", timeout_s=1).value == b"x"


def test_requeue_rolls_back_to_committed(broker):
    broker.publish("t", b"a")
    broker.publish("t", b"b")
    broker.subscribe("t", group="g", timeout_s=1).commit()
    broker.subscribe("t", group="g", timeout_s=1)  # deliver b, no commit
    broker.requeue("t", group="g")
    assert broker.subscribe("t", group="g", timeout_s=1).value == b"b"


def test_timeout_returns_none(broker):
    assert broker.subscribe("empty", timeout_s=0.05) is None


def test_create_delete_topic(broker):
    broker.create_topic("t")
    assert "t" in broker.health_check().details["topics"]
    broker.delete_topic("t")
    assert "t" not in broker.health_check().details["topics"]


def test_invalid_topic_rejected(broker):
    with pytest.raises(ValueError):
        broker.publish("../escape", b"x")


def test_health_reports_offsets(broker):
    broker.publish("t", b"x")
    broker.subscribe("t", group="g", timeout_s=1).commit()
    h = broker.health_check()
    assert h.status == "UP"
    assert h.details["topics"]["t"] == 1
    assert h.details["groups"]["t/g"] == 1


def test_cross_process_publish_consume(tmp_path):
    """A second OS process publishes; this process consumes durably."""
    root = str(tmp_path / "b")
    broker = FileBroker(root=root)
    code = (
        "import sys; sys.path.insert(0, %r); "
        "from gofr_tpu_torch.pubsub.filebroker import FileBroker; "
        "FileBroker(root=%r).publish('xp', b'from-child', key='pid')"
        % (os.path.dirname(os.path.dirname(os.path.abspath(__file__))), root))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60)
    msg = broker.subscribe("xp", group="g", timeout_s=2)
    assert msg.value == b"from-child"
    assert msg.key == "pid"


def test_torn_tail_is_skipped_until_complete(tmp_path):
    """A half-written record at the log tail must not crash or be delivered."""
    root = str(tmp_path / "b")
    broker = FileBroker(root=root)
    broker.publish("t", b"whole")
    with open(broker._log_path("t"), "ab") as fp:
        fp.write(b"\x07\x00\x00")  # 3 bytes of a 16-byte header
    assert broker.subscribe("t", group="g", timeout_s=1).value == b"whole"
    assert broker.subscribe("t", group="g", timeout_s=0.05) is None


# -- external adapters are gated on their drivers -----------------------------
def test_kafka_adapter_gated():
    from gofr_tpu_torch.pubsub.external import KafkaAdapter, MissingDriverError

    if "kafka" in sys.modules or _importable("kafka"):
        pytest.skip("kafka driver present; gating not applicable")
    with pytest.raises(MissingDriverError, match="kafka-python"):
        KafkaAdapter(brokers="localhost:9092")


def test_mqtt_adapter_gated():
    from gofr_tpu_torch.pubsub.external import MissingDriverError, MQTTAdapter

    if _importable("paho.mqtt.client"):
        pytest.skip("paho driver present; gating not applicable")
    with pytest.raises(MissingDriverError, match="paho-mqtt"):
        MQTTAdapter(host="localhost")


def test_google_adapter_gated():
    from gofr_tpu_torch.pubsub.external import GooglePubSubAdapter, MissingDriverError

    if _importable("google.cloud.pubsub_v1"):
        pytest.skip("google driver present; gating not applicable")
    with pytest.raises(MissingDriverError, match="google-cloud-pubsub"):
        GooglePubSubAdapter(project="p")


def _importable(module: str) -> bool:
    import importlib.util

    try:
        return importlib.util.find_spec(module) is not None
    except (ImportError, ModuleNotFoundError):
        return False


def test_container_wires_file_backend(tmp_path):
    from gofr_tpu_torch.config import MockConfig
    from gofr_tpu_torch.container import Container

    cfg = MockConfig({"PUBSUB_BACKEND": "file",
                      "PUBSUB_DIR": str(tmp_path / "ps"),
                      "METRICS_PORT": "0"})
    c = Container.create(cfg)
    assert isinstance(c.pubsub, FileBroker)
    c.pubsub.publish("t", b"hello")
    assert c.pubsub.subscribe("t", timeout_s=1).value == b"hello"


def test_container_survives_missing_kafka_driver():
    from gofr_tpu_torch.config import MockConfig
    from gofr_tpu_torch.container import Container

    if _importable("kafka"):
        pytest.skip("kafka driver present")
    cfg = MockConfig({"PUBSUB_BACKEND": "kafka", "METRICS_PORT": "0"})
    c = Container.create(cfg)  # boot must survive (sql.go:33-36 idiom)
    assert c.pubsub is None


# -- cross-process consumer-group claims --------------------------------------
def _write_foreign_claim(broker, topic, group, idx, pid, expires, acked=()):
    import json

    broker.create_topic(topic)
    with open(broker._lease_path(topic, group), "wb") as fp:
        fp.write(json.dumps({
            "claims": {str(idx): {"pid": pid, "iid": "foreign",
                                  "expires": expires}},
            "acked": list(acked)}).encode())


def test_live_foreign_claim_blocks_duplicate_delivery(broker):
    import time

    broker.publish("t", b"claimed-elsewhere")
    # pid 1 is always alive; its unexpired claim covers record 0
    _write_foreign_claim(broker, "t", "g", idx=0, pid=1,
                         expires=time.time() + 60)
    assert broker.subscribe("t", group="g", timeout_s=0.15) is None


def test_dead_owner_claim_is_ignored(broker):
    import time

    broker.publish("t", b"orphaned")
    _write_foreign_claim(broker, "t", "g", idx=0, pid=2 ** 22 + 12345,
                         expires=time.time() + 60)
    msg = broker.subscribe("t", group="g", timeout_s=1)
    assert msg is not None and msg.value == b"orphaned"


def test_expired_claim_is_ignored(broker):
    import time

    broker.publish("t", b"expired-claim")
    _write_foreign_claim(broker, "t", "g", idx=0, pid=1,
                         expires=time.time() - 1)
    msg = broker.subscribe("t", group="g", timeout_s=1)
    assert msg is not None and msg.value == b"expired-claim"


def test_claims_work_share_across_processes(broker):
    """A foreign live claim on record 0 leaves record 1 for this process."""
    import time

    broker.publish("t", b"m0")
    broker.publish("t", b"m1")
    _write_foreign_claim(broker, "t", "g", idx=0, pid=1,
                         expires=time.time() + 60)
    msg = broker.subscribe("t", group="g", timeout_s=1)
    assert msg.value == b"m1"


def test_acked_list_is_pruned_below_watermark(broker):
    """Stale acks (below the committed watermark) must not accumulate in the
    persisted group state forever."""
    for i in range(6):
        broker.publish("t", b"m%d" % i)
    for _ in range(6):
        broker.subscribe("t", group="g", timeout_s=1).commit()
    assert broker._committed("t", "g") == 6
    with open(broker._lease_path("t", "g"), "a+b") as lf:
        state = broker._read_state(lf)
    # contiguous committed prefix fully pruned; nothing lingers
    assert state.get("acked", []) == []
    # inject a stale ack below the watermark: the next commit sweeps it
    broker.publish("t", b"m6")
    msg = broker.subscribe("t", group="g", timeout_s=1)
    with open(broker._lease_path("t", "g"), "a+b") as lf:
        state = broker._read_state(lf)
        state["acked"] = [1, 2]  # stale: watermark is already past these
        broker._write_state(lf, state)
    msg.commit()
    with open(broker._lease_path("t", "g"), "a+b") as lf:
        state = broker._read_state(lf)
    assert state.get("acked", []) == []


def test_commit_cannot_skip_crashed_peers_record(broker):
    """Out-of-order commit must not advance the watermark past an unacked
    record owned by a dead peer — that record is redelivered, then the
    watermark covers both (the message-loss scenario)."""
    import time

    broker.publish("t", b"m0")
    broker.publish("t", b"m1")
    # dead peer crashed holding record 0
    _write_foreign_claim(broker, "t", "g", idx=0, pid=2 ** 22 + 99,
                         expires=time.time() + 60)
    # but our claim scan skips dead claims, so WE get record 0 first; to
    # model the race, claim record 1 while 0 looks live, then let it die
    _write_foreign_claim(broker, "t", "g", idx=0, pid=1,
                         expires=time.time() + 60)
    m1 = broker.subscribe("t", group="g", timeout_s=1)
    assert m1.value == b"m1"
    m1.commit()  # acks 1; watermark must stay at 0 (record 0 unacked)
    assert broker._committed("t", "g") == 0
    # peer's claim expires -> record 0 redelivered, commit advances to 2
    _write_foreign_claim(broker, "t", "g", idx=0, pid=1,
                         expires=time.time() - 1, acked=[1])
    m0 = broker.subscribe("t", group="g", timeout_s=1)
    assert m0.value == b"m0"
    m0.commit()
    assert broker._committed("t", "g") == 2
    assert broker.subscribe("t", group="g", timeout_s=0.05) is None


# -- fake kafka-python module -------------------------------------------------
class FakeKafkaMessage:
    def __init__(self, topic, value, key, offset, partition=0):
        self.topic = topic
        self.value = value
        self.key = key
        self.offset = offset
        self.partition = partition
        self.timestamp = int(time.time() * 1000)


class FakeKafkaProducer:
    def __init__(self, log, **kwargs):
        self.log = log
        self.kwargs = kwargs
        self.flushes = 0

    def send(self, topic, value=None, key=None):
        self.log.setdefault(topic, []).append(
            FakeKafkaMessage(topic, value, key,
                             offset=len(self.log.get(topic, []))))

    def flush(self):
        self.flushes += 1

    def bootstrap_connected(self):
        return True

    def close(self):
        pass


class FakeKafkaConsumer:
    def __init__(self, topic, log, commits, **kwargs):
        self.topic = topic
        self.log = log
        self.kwargs = kwargs
        self.commits = commits
        self._pos = 0

    def poll(self, timeout_ms=0, max_records=1):
        records = self.log.get(self.topic, [])[self._pos:self._pos + max_records]
        if not records:
            return {}
        self._pos += len(records)
        return {("tp", 0): records}

    def commit(self, offsets=None):
        self.commits.append(offsets)

    def close(self):
        pass


class FakeTopicPartition:
    def __init__(self, topic, partition):
        self.topic = topic
        self.partition = partition

    def __hash__(self):
        return hash((self.topic, self.partition))

    def __eq__(self, other):
        return (self.topic, self.partition) == (other.topic, other.partition)


class FakeOffsetAndMetadata:
    def __init__(self, offset, metadata):
        self.offset = offset
        self.metadata = metadata


def _fake_kafka_module(log, commits):
    mod = types.ModuleType("kafka")

    def producer(**kwargs):
        return FakeKafkaProducer(log, **kwargs)

    def consumer(topic, **kwargs):
        return FakeKafkaConsumer(topic, log, commits, **kwargs)

    mod.KafkaProducer = producer
    mod.KafkaConsumer = consumer
    mod.TopicPartition = FakeTopicPartition
    structs = types.ModuleType("kafka.structs")
    structs.OffsetAndMetadata = FakeOffsetAndMetadata
    mod.structs = structs
    return mod, structs


def test_kafka_adapter_publish_poll_commit(monkeypatch):
    """Drives the real KafkaAdapter publish/subscribe/commit flow against a
    fake kafka-python module."""
    from gofr_tpu_torch.pubsub.external import KafkaAdapter

    log: Dict[str, list] = {}
    commits: List[Any] = []
    mod, structs = _fake_kafka_module(log, commits)
    monkeypatch.setitem(sys.modules, "kafka", mod)
    monkeypatch.setitem(sys.modules, "kafka.structs", structs)

    cfg = MockConfig({"PUBSUB_BROKER": "k1:9092,k2:9092", "CONSUMER_ID": "grp"})
    metrics = new_metrics_manager()
    metrics.new_counter("app_pubsub_publish_total_count", "pub")
    metrics.new_counter("app_pubsub_subscribe_total_count", "sub")
    adapter = KafkaAdapter(cfg, MockLogger(), metrics)
    assert adapter.brokers == ["k1:9092", "k2:9092"]

    adapter.publish("jobs", b"payload-1", key="k")
    adapter.publish("jobs", "payload-2")  # str body encodes
    assert [m.value for m in log["jobs"]] == [b"payload-1", b"payload-2"]

    msg = adapter.subscribe("jobs", timeout_s=1)
    assert msg is not None and msg.value == b"payload-1"
    assert msg.topic == "jobs"
    msg.commit()
    assert commits  # consumer.commit() reached the broker
    # per-record commit: THIS record's offset+1, not the consumer position
    (offsets,) = commits
    ((tp, om),) = offsets.items()
    assert (tp.topic, om.offset) == ("jobs", 1)

    msg2 = adapter.subscribe("jobs", timeout_s=1)
    assert msg2.value == b"payload-2"
    # drained: returns None within the timeout
    assert adapter.subscribe("jobs", timeout_s=0.05) is None


def test_kafka_adapter_health(monkeypatch):
    from gofr_tpu_torch.pubsub.external import KafkaAdapter

    mod, structs = _fake_kafka_module({}, [])
    monkeypatch.setitem(sys.modules, "kafka", mod)
    monkeypatch.setitem(sys.modules, "kafka.structs", structs)
    adapter = KafkaAdapter(MockConfig({}), MockLogger(), None)
    health = adapter.health_check()
    assert health.status == "UP"
    assert health.details["backend"] == "kafka"


# -- fake paho-mqtt -----------------------------------------------------------
class FakeMQTTClient:
    def __init__(self):
        self.on_message = None
        self.subscriptions = []
        self.connected = False

    def connect(self, host, port):
        self.connect_args = (host, port)
        self.connected = True

    def loop_start(self):
        pass

    def publish(self, topic, payload, qos=0):
        msg = types.SimpleNamespace(topic=topic, payload=payload, qos=qos)
        if self.on_message:               # local echo models the broker
            self.on_message(self, None, msg)

    def subscribe(self, topic, qos=0):
        self.subscriptions.append((topic, qos))

    def unsubscribe(self, topic):
        pass

    def is_connected(self):
        return self.connected

    def loop_stop(self):
        pass

    def disconnect(self):
        self.connected = False


def test_mqtt_adapter_pubsub_and_wildcards(monkeypatch):
    mqtt_mod = types.ModuleType("paho.mqtt.client")
    mqtt_mod.Client = FakeMQTTClient
    paho = types.ModuleType("paho")
    paho_mqtt = types.ModuleType("paho.mqtt")
    monkeypatch.setitem(sys.modules, "paho", paho)
    monkeypatch.setitem(sys.modules, "paho.mqtt", paho_mqtt)
    monkeypatch.setitem(sys.modules, "paho.mqtt.client", mqtt_mod)

    from gofr_tpu_torch.pubsub.external import MQTTAdapter

    cfg = MockConfig({"MQTT_HOST": "broker", "MQTT_PORT": "1884",
                      "MQTT_QOS": "1"})
    adapter = MQTTAdapter(cfg, MockLogger(), None)
    assert adapter._client.connect_args == ("broker", 1884)

    # drain a pending subscription queue before publish (push->pull bridge)
    assert adapter.subscribe("sensors/+", timeout_s=0.05) is None
    adapter.publish("sensors/one", b"21.5")
    msg = adapter.subscribe("sensors/+", timeout_s=1)
    assert msg is not None and msg.value == b"21.5"
    assert msg.metadata["qos"] == 1
    # exact-topic subscription
    adapter.publish("alerts", b"fire")
    assert adapter.subscribe("alerts", timeout_s=1).value == b"fire"
    assert adapter.health_check().status == "UP"
    adapter.close()
    assert adapter.health_check().status == "DOWN"


# -- fake google-cloud-pubsub -------------------------------------------------
class _DeadlineExceeded(Exception):
    pass


_DeadlineExceeded.__name__ = "DeadlineExceeded"


class FakeGPublisher:
    def __init__(self, topics):
        self.topics = topics

    def topic_path(self, project, topic):
        return f"projects/{project}/topics/{topic}"

    def create_topic(self, name=None):
        self.topics.setdefault(name, [])

    def publish(self, topic_path, message, **attrs):
        self.topics.setdefault(topic_path, []).append(
            types.SimpleNamespace(data=message, attributes=attrs))

        class _F:
            def result(self):
                return "id"
        return _F()


class FakeGSubscriber:
    def __init__(self, topics, acks):
        self.topics = topics
        self.acks = acks
        self.subs = {}
        self.empty_pulls_before_delivery = 0

    def subscription_path(self, project, name):
        return f"projects/{project}/subscriptions/{name}"

    def create_subscription(self, name=None, topic=None):
        self.subs[name] = {"topic": topic, "pos": 0}

    def pull(self, subscription=None, max_messages=1, timeout=None):
        if self.empty_pulls_before_delivery > 0:
            self.empty_pulls_before_delivery -= 1
            raise _DeadlineExceeded("Deadline Exceeded")
        sub = self.subs[subscription]
        log = self.topics.get(sub["topic"], [])
        if sub["pos"] >= len(log):
            raise _DeadlineExceeded("Deadline Exceeded")
        message = log[sub["pos"]]
        sub["pos"] += 1
        received = types.SimpleNamespace(
            ack_id=f"ack-{sub['pos']}", message=message)
        return types.SimpleNamespace(received_messages=[received])

    def acknowledge(self, subscription=None, ack_ids=None):
        self.acks.extend(ack_ids)


def test_google_pubsub_adapter(monkeypatch):
    topics: Dict[str, list] = {}
    acks: List[str] = []
    mod = types.ModuleType("google.cloud.pubsub_v1")
    mod.PublisherClient = lambda: FakeGPublisher(topics)
    mod.SubscriberClient = lambda: FakeGSubscriber(topics, acks)
    google_mod = types.ModuleType("google")
    cloud_mod = types.ModuleType("google.cloud")
    monkeypatch.setitem(sys.modules, "google", google_mod)
    monkeypatch.setitem(sys.modules, "google.cloud", cloud_mod)
    monkeypatch.setitem(sys.modules, "google.cloud.pubsub_v1", mod)

    from gofr_tpu_torch.pubsub.external import GooglePubSubAdapter

    adapter = GooglePubSubAdapter(MockConfig({"GOOGLE_PROJECT_ID": "proj"}),
                                  MockLogger(), None)
    adapter.publish("jobs", b"work-1")
    # an empty pull surfaces as DeadlineExceeded: treated as no-message-yet,
    # the poll keeps waiting until the deadline instead of erroring
    adapter._subscriber.empty_pulls_before_delivery = 2
    msg = adapter.subscribe("jobs", timeout_s=5)
    assert msg is not None and msg.value == b"work-1"
    msg.commit()
    assert acks == ["ack-1"]
    # drained topic: DeadlineExceeded until the timeout, then None
    assert adapter.subscribe("jobs", timeout_s=0.2) is None




# -- a file broker's log across the two packages --------------------------------
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_file_broker_log_is_shared_with_the_reference(tmp_path, writer):
    """One broker directory: the writer's package publishes five messages
    and commits the first two in group g; the other package's broker reads
    the same log, resumes g at the third message, redelivers an uncommitted
    one after a requeue, and a fresh group reads from the start."""
    from gofr_tpu.pubsub.filebroker import FileBroker as JBroker

    root = str(tmp_path / "shared")
    first, second = ((JBroker, FileBroker) if writer == "reference"
                     else (FileBroker, JBroker))
    a = first(root=root)
    for i in range(5):
        a.publish("jobs", json.dumps({"i": i}).encode(), key=f"k{i}")
    for _ in range(2):
        msg = a.subscribe("jobs", "g", timeout_s=1.0)
        msg.commit()
    b = second(root=root)
    msg = b.subscribe("jobs", "g", timeout_s=1.0)
    assert json.loads(msg.value) == {"i": 2} and msg.key == "k2"
    b.requeue("jobs", "g")
    again = b.subscribe("jobs", "g", timeout_s=1.0)
    assert json.loads(again.value) == {"i": 2}
    again.commit()
    fresh = [json.loads(b.subscribe("jobs", "h", timeout_s=1.0).value)["i"]
             for _ in range(5)]
    assert fresh == [0, 1, 2, 3, 4]
    # the writer's broker sees the other's commit on the shared offsets
    assert json.loads(first(root=root).subscribe(
        "jobs", "g", timeout_s=1.0).value) == {"i": 3}
    assert (b.health_check().status == a.health_check().status == "UP")


# -- the in-process broker -------------------------------------------------------
def test_inproc_groups_commit_and_redelivery():
    from gofr_tpu_torch.pubsub.inproc import InProcBroker

    broker = InProcBroker()
    for i in range(3):
        broker.publish("t", str(i).encode())
    m0 = broker.subscribe("t", "a", timeout_s=1.0)
    assert m0.value == b"0" and m0.bind() == 0
    # delivered, not committed: the group's next poll moves on, a requeue
    # rolls back to the committed offset
    assert broker.subscribe("t", "a", timeout_s=1.0).value == b"1"
    broker.requeue("t", "a")
    assert broker.subscribe("t", "a", timeout_s=1.0).value == b"0"
    # another group reads the topic from its start
    assert broker.subscribe("t", "b", timeout_s=1.0).value == b"0"
    assert broker.subscribe("empty", "a", timeout_s=0.05) is None
    assert broker.health_check().status == "UP"


def test_inproc_subscribe_wakes_on_publish():
    from gofr_tpu_torch.pubsub.inproc import InProcBroker

    broker = InProcBroker()
    got = []
    t = threading.Thread(target=lambda: got.append(
        broker.subscribe("late", "g", timeout_s=10.0)))
    t.start()
    time.sleep(0.1)
    broker.publish("late", b'{"x": 1}')
    t.join(timeout=10.0)
    assert got and got[0].bind() == {"x": 1}
    assert got[0].param("missing") == "" and got[0].path_param("topic") == \
        "late"
