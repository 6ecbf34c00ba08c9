"""On-demand profiling on the port (tpu/profiler.py, torch.profiler).

The twins of the profiler cases of tests/test_app.py (``test_profiler_
endpoint``, ``test_profiler_busy_answers_409`` and ``test_profiler_captures_
land_under_configured_profile_dir``) on the port's App (on the CPU): POST
/debug/profile answers 202 at once and the capture runs on a daemon thread
(its trace, ``trace.json``, a Chrome trace), a second POST while one runs
answers 409, and PROFILE_DIR is
the capture root that status() reports paths relative to. Beyond them: a
POSTed dir must lie under that root (400 otherwise; the reference takes
any); the status payload has the reference's keys; a capture asked for while another
torch.profiler runs in the process is refused in ``last_error`` and raises
nowhere; and neither server serves /debug/profile (404), as the
reference's servers serve none, while ``App.enable_profiler`` on a served
App captures while the engine serves (the kernels of the card's graph
replays in such a capture are checked on the card, by ``chip_smoke.py
--faults``, which enables the route on its own App). Every trace goes to
pytest's tmp_path.
"""

import json
import os
import time
import urllib.error
import urllib.request

import pytest
import torch

from gofr_tpu.tpu import profiler as jprofiler
from gofr_tpu_torch.app import App
from gofr_tpu_torch.tpu import profiler as profmod


def make_app(extra=None):
    return App({"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "WARN",
                **(extra or {})})


def _call(port, path, method="GET", body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read().decode() or "null")
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode() or "null")


def _wait_idle(port):
    deadline = time.time() + 60
    while time.time() < deadline:
        status = _call(port, "/debug/profile")[1]["data"]
        if not status["active"]:
            return status
        time.sleep(0.05)
    raise AssertionError("the capture never finished")


def _trace_events(trace_dir):
    with open(os.path.join(trace_dir, profmod.TRACE_FILE)) as fp:
        return json.load(fp)["traceEvents"]


def test_profiler_endpoint(tmp_path):
    # a POSTed dir must lie under the root (the reference's test names no
    # PROFILE_DIR: its route takes any dir)
    app = make_app({"PROFILE_DIR": str(tmp_path)})
    app.enable_profiler()
    app.start()
    try:
        status, body = _call(app.http_port, "/debug/profile")
        assert status == 200 and body["data"]["active"] is False
        t0 = time.time()
        status, body = _call(app.http_port, "/debug/profile", "POST",
                             {"seconds": 1.0, "dir": str(tmp_path)})
        assert status == 202
        assert time.time() - t0 < 1.0    # did NOT block for the capture
        trace_dir = body["data"]["trace_dir"]
        assert trace_dir.startswith(str(tmp_path))
        assert os.path.isdir(trace_dir)  # pending dir created up front
        status = _wait_idle(app.http_port)
        assert status["last_error"] is None
        assert status["last_dir"] == trace_dir
        assert status["last_trigger"] == "manual"
        assert 0.5 <= status["last_duration_s"] <= 30.0
        assert isinstance(_trace_events(trace_dir), list)
    finally:
        app.shutdown()
        profmod.configure(profmod._DEFAULT_DIR)


def test_profiler_busy_answers_409(tmp_path):
    app = make_app({"PROFILE_DIR": str(tmp_path)})
    app.enable_profiler()
    app.start()
    try:
        status, _ = _call(app.http_port, "/debug/profile", "POST",
                          {"seconds": 2.0, "dir": str(tmp_path)})
        assert status == 202
        status, busy = _call(app.http_port, "/debug/profile", "POST",
                             {"seconds": 1.0, "dir": str(tmp_path)})
        assert status == 409
        assert "already running" in busy["error"]["message"]
        status = _call(app.http_port, "/debug/profile")[1]["data"]
        assert status["active"] is True
        assert status["trigger"] == "manual"
        assert status["seconds"] == 2.0
        assert status["running_for_s"] >= 0.0
        assert _wait_idle(app.http_port)["active"] is False
    finally:
        app.shutdown()
        profmod.configure(profmod._DEFAULT_DIR)


def test_profiler_captures_land_under_configured_profile_dir(tmp_path):
    root = str(tmp_path / "prof-root")
    app = make_app({"PROFILE_DIR": root})
    app.enable_profiler()
    try:
        assert profmod.profile_dir() == root
        app.start()
        status, body = _call(app.http_port, "/debug/profile", "POST",
                             {"seconds": 0.5})
        assert status == 202
        trace_dir = body["data"]["trace_dir"]
        assert trace_dir.startswith(root)
        status = _wait_idle(app.http_port)
        assert status["profile_dir"] == root
        assert status["last_dir"] == trace_dir
        assert status["last_rel"] == os.path.relpath(trace_dir, root)
        assert not status["last_rel"].startswith("..")
    finally:
        app.shutdown()
        profmod.configure(profmod._DEFAULT_DIR)   # leave the global clean


def test_posted_dir_must_lie_under_profile_dir(tmp_path):
    """A relative dir is joined to the root; one outside the root, by an
    absolute path, by "..", or through a symlink, answers 400 and creates
    nothing."""
    root = tmp_path / "root"
    outside = tmp_path / "outside"
    root.mkdir()
    outside.mkdir()
    (root / "link").symlink_to(outside)
    app = make_app({"PROFILE_DIR": str(root)})
    app.enable_profiler()
    app.start()
    try:
        for bad in (str(outside / "x"), "../outside/x", "link/x", "/"):
            status, body = _call(app.http_port, "/debug/profile", "POST",
                                 {"seconds": 0.2, "dir": bad})
            assert status == 400, bad
            assert "outside PROFILE_DIR" in body["error"]["message"]
        assert list(outside.iterdir()) == []
        assert _call(app.http_port, "/debug/profile")[1]["data"][
            "active"] is False
        status, body = _call(app.http_port, "/debug/profile", "POST",
                             {"seconds": 0.2, "dir": "run-1"})
        assert status == 202
        trace_dir = body["data"]["trace_dir"]
        assert trace_dir.startswith(str(root / "run-1"))
        status = _wait_idle(app.http_port)
        assert status["last_error"] is None
        assert status["last_rel"] == os.path.relpath(trace_dir, str(root))
    finally:
        app.shutdown()
        profmod.configure(profmod._DEFAULT_DIR)


def test_status_has_the_references_keys():
    assert set(profmod.status()) == set(jprofiler.status())
    assert profmod._MAX_SECONDS == jprofiler._MAX_SECONDS
    assert profmod._DEFAULT_DIR == jprofiler._DEFAULT_DIR


def test_capture_refused_while_another_profiler_runs(tmp_path):
    """torch.profiler is one per process: a script's own profiler running
    makes the capture a refused one (last_error), never an exception on
    the caller's thread."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        trace_dir, _ = profmod.start_capture(0.2, str(tmp_path))
        deadline = time.time() + 30
        while profmod.status()["active"] and time.time() < deadline:
            time.sleep(0.02)
    status = profmod.status()
    assert status["active"] is False
    assert "another torch.profiler" in status["last_error"]
    assert status["last_dir"] != trace_dir
    # and the next capture, with the other profiler gone, succeeds
    out = profmod.capture_trace(0.2, str(tmp_path))
    assert os.path.exists(os.path.join(out, profmod.TRACE_FILE))
    assert profmod.status()["last_error"] is None


@pytest.mark.parametrize("server", ["llm", "openai"])
def test_both_servers_serve_debug_profile_while_serving(server, tmp_path):
    from gofr_tpu_torch.models.llama import LlamaConfig, llama_init
    from gofr_tpu_torch.serve import build_app, build_engine
    from gofr_tpu_torch.serve_openai import build_app as build_openai

    env = {"HTTP_PORT": "0", "METRICS_PORT": "0", "MODEL_PRESET": "debug",
           "GRPC_PORT": "0",
           "WARMUP": "false", "MAX_BATCH": "4", "MAX_SEQ_LEN": "128",
           "PREFILL_BUCKETS": "8,16", "PAGE_SIZE": "8", "LOG_LEVEL": "WARN",
           "ENGINE_HBM_SAMPLE_S": "0", "HOSTPROF": "false",
           "INCIDENT_DIR": str(tmp_path / "incidents"),
           "PROFILE_DIR": str(tmp_path / "profiles")}
    params = llama_init(LlamaConfig.debug(), seed=0, device="cpu")
    build = build_app if server == "llm" else build_openai
    app = build(env, engine=build_engine(env, device="cpu", params=params))
    app.start()
    try:
        # the reference's servers never enable the profiler: 404
        for method, body in (("POST", {"seconds": 1.0}), ("GET", None)):
            status, _ = _call(app.http_port, "/debug/profile", method, body)
            assert status == 404, method
        # a harness that wants captures enables the route on its App
        app.enable_profiler()
        status, body = _call(app.http_port, "/debug/profile", "POST",
                             {"seconds": 1.0})
        assert status == 202
        trace_dir = body["data"]["trace_dir"]
        assert trace_dir.startswith(str(tmp_path / "profiles"))
        reqs = [app.engine.submit([5 + i, 6, 7], max_new_tokens=24)
                for i in range(4)]
        for r in reqs:
            assert len(r.result(timeout_s=120)) == 24
        status = _wait_idle(app.http_port)
        assert status["last_error"] is None
        assert status["last_dir"] == trace_dir
        assert isinstance(_trace_events(trace_dir), list)
    finally:
        app.shutdown()
        profmod.configure(profmod._DEFAULT_DIR)
