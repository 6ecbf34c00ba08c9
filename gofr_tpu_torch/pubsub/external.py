"""Gated adapters for external brokers: Kafka, MQTT, Google Pub/Sub.

Ports ``gofr_tpu/pubsub/external.py`` whole: ``MissingDriverError``,
``KafkaAdapter``, ``MQTTAdapter`` and ``GooglePubSubAdapter``.

The reference ships three network pub/sub backends (kafka/kafka.go:45-92,
mqtt/mqtt.go:57-80, google/google.go:36-61).  This environment bakes in none
of their client libraries, so each adapter here resolves its driver lazily at
construction: if the library is importable the adapter speaks the bundled
`Client` interface over the real broker; otherwise it raises a clear
`MissingDriverError` naming the pip package — mirroring how the reference
keeps Google Pub/Sub mock-only in CI (SURVEY.md §4) while the code path
stays first-class.

All three adapters normalise to the same semantics the bundled brokers have:
`subscribe` returns one `Message` whose `commit()` acknowledges it; handler
failure without commit leads to redelivery per the broker's own rules.
"""

from __future__ import annotations

import importlib
import time
from typing import Optional

from ..datasource import Health, STATUS_DOWN, STATUS_UP
from . import Client, Message


class MissingDriverError(ImportError):
    def __init__(self, backend: str, packages: str):
        super().__init__(
            f"pub/sub backend {backend!r} needs an external driver; install one of: "
            f"{packages} (this image bakes in none — use PUBSUB_BACKEND=inproc or "
            f"file for the bundled brokers)")
        self.backend = backend


def _need(backend: str, module: str, packages: str):
    try:
        return importlib.import_module(module)
    except ImportError as exc:
        raise MissingDriverError(backend, packages) from exc


class KafkaAdapter(Client):
    """kafka-python-backed adapter (reference kafka/kafka.go:45-92).

    Config: PUBSUB_BROKER (host:port), CONSUMER_ID (group), PUBSUB_OFFSET.
    """

    def __init__(self, config=None, logger=None, metrics=None,
                 brokers: str = "", group: str = ""):
        kafka = _need("kafka", "kafka", "kafka-python")
        self.logger = logger
        self.metrics = metrics
        if config is not None:
            brokers = brokers or config.get_or_default("PUBSUB_BROKER", "localhost:9092")
            group = group or config.get_or_default("CONSUMER_ID", "gofr")
        self.brokers = (brokers or "localhost:9092").split(",")
        self.group = group or "gofr"
        self._producer = kafka.KafkaProducer(bootstrap_servers=self.brokers)
        self._consumers = {}
        self._kafka = kafka

    def publish(self, topic: str, message: bytes, key: str = "") -> None:
        if isinstance(message, str):
            message = message.encode()
        self._producer.send(topic, value=message, key=key.encode() or None)
        self._producer.flush()
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_publish_total_count", topic=topic)

    def _consumer(self, topic: str, group: str):
        if (topic, group) not in self._consumers:
            self._consumers[(topic, group)] = self._kafka.KafkaConsumer(
                topic, bootstrap_servers=self.brokers, group_id=group,
                enable_auto_commit=False)
        return self._consumers[(topic, group)]

    def subscribe(self, topic: str, group: str = "default",
                  timeout_s: Optional[float] = None) -> Optional[Message]:
        # the Client interface's "default" group maps to the configured
        # CONSUMER_ID; explicit groups get their own offset cursor, matching
        # the bundled brokers' semantics
        consumer = self._consumer(topic, self.group if group == "default" else group)
        # bundled-broker contract: timeout_s=None blocks until a message
        deadline = None if timeout_s is None else time.time() + timeout_s
        while True:
            remaining = 1.0 if deadline is None else max(deadline - time.time(), 0)
            batch = consumer.poll(timeout_ms=int(remaining * 1000), max_records=1)
            if not batch:
                if deadline is not None and time.time() >= deadline:
                    return None
                continue
            break
        for records in batch.values():
            for rec in records:
                if self.metrics is not None:
                    self.metrics.increment_counter(
                        "app_pubsub_subscribe_total_count", topic=topic)

                def _commit(rec=rec):
                    # commit THIS record's offset, not the consumer position:
                    # a later successful handler must not mark an earlier
                    # failed (uncommitted) message as done
                    from kafka import TopicPartition
                    from kafka.structs import OffsetAndMetadata

                    consumer.commit({
                        TopicPartition(rec.topic, rec.partition):
                            OffsetAndMetadata(rec.offset + 1, None)})

                return Message(
                    topic=topic, value=rec.value,
                    key=(rec.key or b"").decode("utf-8", "replace"),
                    metadata={"offset": rec.offset, "partition": rec.partition},
                    committer=_commit)
        return None

    def create_topic(self, topic: str) -> None:
        admin = self._kafka.KafkaAdminClient(bootstrap_servers=self.brokers)
        try:
            from kafka.admin import NewTopic
            admin.create_topics([NewTopic(name=topic, num_partitions=1,
                                          replication_factor=1)])
        finally:
            admin.close()

    def delete_topic(self, topic: str) -> None:
        admin = self._kafka.KafkaAdminClient(bootstrap_servers=self.brokers)
        try:
            admin.delete_topics([topic])
        finally:
            admin.close()

    def health_check(self) -> Health:
        try:
            ok = self._producer.bootstrap_connected()
        except Exception:  # noqa: BLE001
            ok = False
        return Health(status=STATUS_UP if ok else STATUS_DOWN,
                      details={"backend": "kafka", "brokers": self.brokers})

    def close(self) -> None:
        self._producer.close()
        for consumer in self._consumers.values():
            consumer.close()


class MQTTAdapter(Client):
    """paho-mqtt-backed adapter (reference mqtt/mqtt.go:57-80,145-198).

    MQTT pushes; the adapter bridges push -> pull with a per-topic queue the
    way the reference buffers into channels (mqtt.go:145-198).
    """

    def __init__(self, config=None, logger=None, metrics=None,
                 host: str = "", port: int = 0, qos: int = 1):
        mqtt = _need("mqtt", "paho.mqtt.client", "paho-mqtt")
        import queue

        self.logger = logger
        self.metrics = metrics
        if config is not None:
            host = host or config.get_or_default("MQTT_HOST", "localhost")
            port = port or int(config.get_or_default("MQTT_PORT", "1883"))
            qos = int(config.get_or_default("MQTT_QOS", str(qos)))
        self.qos = qos
        self._queues = {}
        self._queue_mod = queue
        self._client = mqtt.Client()
        self._client.on_message = self._on_message
        self._client.connect(host or "localhost", port or 1883)
        self._client.loop_start()

    @staticmethod
    def _filter_matches(pattern: str, topic: str) -> bool:
        """MQTT topic-filter match: `+` = one level, `#` = rest (trailing)."""
        p_parts = pattern.split("/")
        t_parts = topic.split("/")
        for i, p in enumerate(p_parts):
            if p == "#":
                return True
            if i >= len(t_parts):
                return False
            if p != "+" and p != t_parts[i]:
                return False
        return len(p_parts) == len(t_parts)

    def _on_message(self, _client, _userdata, msg) -> None:
        # route by SUBSCRIPTION FILTER, not concrete topic, so wildcard
        # subscriptions ('sensors/+') receive their matches
        delivered = False
        for pattern, q in list(self._queues.items()):
            if self._filter_matches(pattern, msg.topic):
                q.put(msg)
                delivered = True
        if not delivered:
            self._queues.setdefault(msg.topic, self._queue_mod.Queue()).put(msg)

    def publish(self, topic: str, message: bytes, key: str = "") -> None:
        if isinstance(message, str):
            message = message.encode()
        self._client.publish(topic, message, qos=self.qos)
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_publish_total_count", topic=topic)

    def subscribe(self, topic: str, group: str = "default",
                  timeout_s: Optional[float] = None) -> Optional[Message]:
        if topic not in self._queues:
            self._queues[topic] = self._queue_mod.Queue()
            self._client.subscribe(topic, qos=self.qos)
        try:
            msg = self._queues[topic].get(timeout=timeout_s)
        except self._queue_mod.Empty:
            return None
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_subscribe_total_count", topic=topic)
        return Message(topic=topic, value=msg.payload, key="",
                       metadata={"qos": msg.qos}, committer=None)

    def create_topic(self, topic: str) -> None:  # topics are implicit in MQTT
        pass

    def delete_topic(self, topic: str) -> None:
        self._client.unsubscribe(topic)
        self._queues.pop(topic, None)

    def health_check(self) -> Health:
        ok = self._client.is_connected()
        return Health(status=STATUS_UP if ok else STATUS_DOWN,
                      details={"backend": "mqtt"})

    def close(self) -> None:
        self._client.loop_stop()
        self._client.disconnect()


class GooglePubSubAdapter(Client):
    """google-cloud-pubsub-backed adapter (reference google/google.go:36-61).

    Auto-creates topic + per-group subscription on first use
    (google.go:170-207); `subscribe` pulls one message and its `commit()`
    acks it (google.go:117-169).
    """

    def __init__(self, config=None, logger=None, metrics=None, project: str = ""):
        pubsub_v1 = _need("google", "google.cloud.pubsub_v1", "google-cloud-pubsub")
        self.logger = logger
        self.metrics = metrics
        if config is not None:
            project = project or config.get_or_default("GOOGLE_PROJECT_ID", "")
        if not project:
            raise ValueError("GooglePubSubAdapter needs GOOGLE_PROJECT_ID")
        self.project = project
        self._publisher = pubsub_v1.PublisherClient()
        self._subscriber = pubsub_v1.SubscriberClient()
        self._ensured_topics = set()
        self._ensured_subs = set()

    def _topic_path(self, topic: str) -> str:
        return self._publisher.topic_path(self.project, topic)

    def _sub_path(self, topic: str, group: str) -> str:
        return self._subscriber.subscription_path(self.project, f"{topic}.{group}")

    def publish(self, topic: str, message: bytes, key: str = "") -> None:
        if isinstance(message, str):
            message = message.encode()
        self.create_topic(topic)
        self._publisher.publish(self._topic_path(topic), message, key=key).result()
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_publish_total_count", topic=topic)

    def subscribe(self, topic: str, group: str = "default",
                  timeout_s: Optional[float] = None) -> Optional[Message]:
        self.create_topic(topic)
        sub_path = self._sub_path(topic, group)
        if sub_path not in self._ensured_subs:  # admin RPC once, not per poll
            try:
                self._subscriber.create_subscription(
                    name=sub_path, topic=self._topic_path(topic))
            except Exception:  # noqa: BLE001 - already exists
                pass
            self._ensured_subs.add(sub_path)
        # bundled-broker contract: timeout_s=None blocks until a message
        deadline = None if timeout_s is None else time.time() + timeout_s
        while True:
            remaining = 5.0 if deadline is None else max(deadline - time.time(), 0.1)
            try:
                resp = self._subscriber.pull(subscription=sub_path,
                                             max_messages=1, timeout=remaining)
            except Exception as exc:  # noqa: BLE001
                # an empty pull surfaces as DeadlineExceeded in the google
                # client — that is "no message yet", not an error; anything
                # else is a real failure and must propagate, not be spun on
                if type(exc).__name__ != "DeadlineExceeded":
                    raise
                resp = None
            if resp is not None and resp.received_messages:
                break
            if deadline is not None and time.time() >= deadline:
                return None
        received = resp.received_messages[0]

        def _commit():
            self._subscriber.acknowledge(subscription=sub_path,
                                         ack_ids=[received.ack_id])

        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_subscribe_total_count", topic=topic)
        return Message(topic=topic, value=received.message.data,
                       key=received.message.attributes.get("key", ""),
                       metadata=dict(received.message.attributes), committer=_commit)

    def create_topic(self, topic: str) -> None:
        if topic in self._ensured_topics:
            return
        try:
            self._publisher.create_topic(name=self._topic_path(topic))
        except Exception:  # noqa: BLE001 - already exists
            pass
        self._ensured_topics.add(topic)

    def delete_topic(self, topic: str) -> None:
        self._publisher.delete_topic(topic=self._topic_path(topic))
        self._ensured_topics.discard(topic)
        self._ensured_subs = {s for s in self._ensured_subs
                              if f"/{topic}." not in s}

    def health_check(self) -> Health:
        try:
            list(self._publisher.list_topics(project=f"projects/{self.project}",
                                             timeout=2.0))
            return Health(status=STATUS_UP, details={"backend": "google"})
        except Exception:  # noqa: BLE001
            return Health(status=STATUS_DOWN, details={"backend": "google"})
