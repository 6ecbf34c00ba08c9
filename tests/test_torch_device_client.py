"""The port's device client (tpu/device.CUDAClient) against the reference's
TPUClient, the container and App wiring around it, and the batcher
servers' multi-process job.

On the CPU: the client connects only where it is asked to (a device="cpu"
argument or TPU_PLATFORM=cpu; with neither and no card, connect raises),
reports the reference's health shape, the app_tpu_* series and the
memory gauges; its single-flight probe never starts a second thread while
one is wedged; ``mesh`` covers the job's ranks. The container builds it
under TPU_ENABLED or MODEL_NAME (as the reference's does) and keeps booting
when it fails without a coordinator; the App injects one with ``add_tpu``,
arms it with the fault plane, and the served llm-server's
/.well-known/health goes DEGRADED under a probe wedge posted to
/debug/faults and UP after it. ``serve_mnist`` as a two-rank job on gloo
(tests/torch_dist.py): each rank serves /predict on its own port, equal to
its unbatched forward within 1e-4 (the answer's 4-place rounding), and
leaves the job at shutdown.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gofr_tpu.config import MockConfig as JMockConfig
from gofr_tpu.metrics import Manager as JManager
from gofr_tpu.tpu.device import TPUClient
from gofr_tpu_torch.app import App
from gofr_tpu_torch.config import MockConfig
from gofr_tpu_torch.container import (STATUS_DEGRADED, STATUS_DOWN,
                                      STATUS_UP, Container)
from gofr_tpu_torch.logging import MockLogger
from gofr_tpu_torch.metrics import Manager
from gofr_tpu_torch.tpu.device import CUDAClient, requested_device
from gofr_tpu_torch.tpu.faults import FaultPlane

from torch_dist import run_procs
import torch_dist_workers as workers

NO_CARD = not torch.cuda.is_available()


def _client(**kw):
    metrics = Manager()
    client = CUDAClient(MockConfig(kw.pop("config", {})), **kw)
    client.use_metrics(metrics)
    client.use_logger(MockLogger())
    client.connect()
    return metrics, client


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read() or b"null")


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read() or b"null")


# -- the client -------------------------------------------------------------------
@pytest.mark.parametrize("how", ["argument", "TPU_PLATFORM"])
def test_client_connects_where_asked_and_reports_as_the_reference(how):
    kw = ({"device": "cpu"} if how == "argument"
          else {"config": {"TPU_PLATFORM": "cpu"}})
    metrics, client = _client(**kw)
    ref = TPUClient(JMockConfig({}))
    ref.use_metrics(JManager())
    ref.connect()
    assert client.device == torch.device("cpu")
    assert (client.platform, client.device_count) == ("cpu", 1)
    assert client.devices == [torch.device("cpu")]
    h, rh = client.health_check(), ref.health_check()
    assert h.status == rh.status == STATUS_UP
    assert set(h.details) == set(rh.details)
    assert set(h.details["memory"][0]) == set(rh.details["memory"][0])
    assert h.details["platform"] == "cpu" and h.details["devices"] == 1
    # the app_tpu_* series, the reference's names
    text = metrics.expose()
    for name in ("app_tpu_ttft_seconds", "app_tpu_hbm_bytes_used",
                 "app_tpu_hbm_bytes"):
        assert name in text
    client.refresh_memory_metrics()
    assert 'app_tpu_hbm_bytes{device="0",kind="limit"} 0' in \
        metrics.expose()
    client.close()
    assert client.health_check().status == STATUS_DOWN
    assert client.platform == "none"


@pytest.mark.skipif(not NO_CARD, reason="a CUDA card is visible")
def test_client_without_a_card_or_a_request_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDAClient().connect()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDAClient(MockConfig({"TPU_PLATFORM": "gpu"})).connect()
    with pytest.raises(ValueError, match="TPU_PLATFORM"):
        CUDAClient(MockConfig({"TPU_PLATFORM": "tpu"})).connect()
    assert requested_device("", None) is None
    assert requested_device("cpu", None) == "cpu"
    assert requested_device("gpu", "cpu") == "cpu"


def test_probe_is_single_flight_while_wedged():
    """Concurrent polls during a wedge share the one probe thread and all
    answer DEGRADED within the timeout; none blocks for the wedge."""
    _, client = _client(device="cpu")
    client.HEALTH_PROBE_TIMEOUT_S = 0.2
    client.faults = FaultPlane(plan=[{"site": "device.health_probe",
                                      "action": "wedge", "delay_s": 1.0,
                                      "times": 1}])
    out, probes = [], set()

    def poll():
        t0 = time.monotonic()
        h = client.health_check()
        probes.add(id(client._probe_thread))
        out.append((h.status, time.monotonic() - t0))

    threads = [threading.Thread(target=poll) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(out) == 6 and len(probes) == 1
    assert all(s == STATUS_DEGRADED and dt < 0.9 for s, dt in out)
    assert client.faults.snapshot()["hits"]["device.health_probe"] == 1
    client._probe_thread.join(timeout=10)
    assert client.health_check().status == STATUS_UP


def test_mesh_needs_the_job_and_checks_the_axes():
    _, client = _client(device="cpu")
    with pytest.raises(ValueError, match="not among"):
        client.mesh({"model": 1})
    with pytest.raises(ValueError, match="need 2 ranks"):
        client.mesh({"tp": 2})
    with pytest.raises(RuntimeError, match="join the job"):
        client.mesh({"tp": -1})


# -- the container and the App ------------------------------------------------------
@pytest.mark.parametrize("key", ["TPU_ENABLED", "MODEL_NAME"])
def test_container_builds_the_client_as_the_reference(key):
    value = "true" if key == "TPU_ENABLED" else "llama3-8b"
    c = Container.create({key: value, "LOG_LEVEL": "WARN"}, device="cpu")
    try:
        assert isinstance(c.tpu, CUDAClient) and c.tpu.platform == "cpu"
        health = c.health()
        assert health["details"]["tpu"]["status"] == STATUS_UP
        c.refresh_runtime_metrics()
        assert 'app_tpu_hbm_bytes_used{device="0"} 0' in \
            c.metrics_manager.expose()
    finally:
        c.close()
    assert c.tpu.device is None     # closed with the container
    # no key, no client; the fleet router's container builds none
    assert Container.create({"LOG_LEVEL": "WARN"}).tpu is None
    assert Container.create({key: value, "LOG_LEVEL": "WARN"}, device="cpu",
                            device_client=False).tpu is None


def test_container_keeps_booting_when_the_client_fails():
    """The reference's policy: without a coordinator a client that cannot
    start is logged and tpu stays None."""
    c = Container.create({"TPU_ENABLED": "true", "TPU_PLATFORM": "tpu",
                          "LOG_LEVEL": "WARN"})
    assert c.tpu is None
    if NO_CARD:
        c = Container.create({"TPU_ENABLED": "true", "LOG_LEVEL": "WARN"})
        assert c.tpu is None


def test_app_add_tpu_and_the_context():
    app = App({"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "WARN",
               "GRPC_PORT": "0"})
    client = CUDAClient(device="cpu")
    app.add_tpu(client)
    seen = {}

    @app.get("/dev")
    def dev(ctx):
        seen["tpu"] = ctx.tpu
        return {"platform": ctx.tpu.platform}

    app.start()
    try:
        assert app.container.tpu is client and client.metrics is not None
        assert _get(app.http_port, "/dev") == (200, {"data": {
            "platform": "cpu"}})
        assert seen["tpu"] is client
        status, health = _get(app.metrics_port, "/.well-known/health")
        assert health["details"]["tpu"]["status"] == STATUS_UP
    finally:
        app.shutdown()


def test_served_probe_wedge_degrades_then_recovers(tmp_path):
    """The llm-server with TPU_ENABLED and FAULT_INJECTION on the CPU: the
    plane is armed on the client, a device.health_probe wedge posted to
    /debug/faults makes tpu DEGRADED in /.well-known/health (the aggregate
    after two polls, the de-flap rule), and UP once the wedge ends; the
    memory sampler reads the client."""
    from gofr_tpu_torch.serve import build_app

    app = build_app({"HTTP_PORT": "0", "METRICS_PORT": "0", "GRPC_PORT": "0",
                     "MAX_SEQ_LEN": "64", "PREFILL_BUCKETS": "8,16",
                     "PAGE_SIZE": "8", "MAX_BATCH": "2", "WARMUP": "false",
                     "LOG_LEVEL": "WARN", "TPU_ENABLED": "true",
                     "FAULT_INJECTION": "true", "HOSTPROF": "false",
                     "INCIDENT_DIR": str(tmp_path)}, device="cpu")
    client = app.container.tpu
    client.HEALTH_PROBE_TIMEOUT_S = 0.2
    app.start()
    try:
        assert client.faults is app.engine.faults is not None
        _, health = _get(app.http_port, "/.well-known/health")
        assert health["data"]["details"]["tpu"]["status"] == STATUS_UP
        status, _ = _post(app.http_port, "/debug/faults", {"plan": [
            {"site": "device.health_probe", "action": "wedge",
             "delay_s": 1.5, "times": 1}]})
        assert status == 201
        seen = [_get(app.http_port, "/.well-known/health")[1]["data"]
                for _ in range(2)]
        assert [h["details"]["tpu"]["status"] for h in seen] == [
            STATUS_DEGRADED, STATUS_DEGRADED]
        assert seen[0].get("degrading") and seen[1]["status"] == \
            STATUS_DEGRADED
        client._probe_thread.join(timeout=10)
        _, health = _get(app.http_port, "/.well-known/health")
        assert health["data"]["details"]["tpu"]["status"] == STATUS_UP
        assert health["data"]["status"] == STATUS_UP
        # a generation is unaffected by the probe's plane
        status, body = _post(app.http_port, "/generate", {
            "prompt": "hi", "max_tokens": 3, "stream": False})
        assert status == 201 and body["data"]["tokens"] == 3
    finally:
        app.shutdown()


# -- the batcher servers' job -------------------------------------------------------
def test_mnist_job_serves_on_two_ranks():
    images = list(np.random.default_rng(5).random((3, 784),
                                                  dtype=np.float32))
    outs = run_procs(workers.mnist_job, 2, images, timeout=150)
    for rank, out in enumerate(outs):
        assert (out["rank"], out["world"], out["backend"]) == (rank, 2,
                                                               "gloo")
        assert out["platform"] == "cpu"
        assert out["mesh"] == {"dp": 2, "pp": 1, "sp": 1, "tp": 1, "ep": 1}
        for (status, body), row in zip(out["answers"], out["logits"]):
            assert status == 201, body
            probs = np.exp(row - row.max())
            probs /= probs.sum()
            assert body["data"]["digit"] == int(np.argmax(row))
            np.testing.assert_allclose(body["data"]["probs"], probs,
                                       atol=1e-4)
        assert out["health"]["details"]["tpu"]["status"] == STATUS_UP
        assert out["left"]
