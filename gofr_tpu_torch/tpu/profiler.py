"""On-demand device profiling: a torch.profiler capture under PROFILE_DIR.

Counterpart of ``gofr_tpu/tpu/profiler.py``, with its surface: ``configure``,
``profile_dir``, ``start_capture``, ``capture_trace``, ``status`` and
``install_routes``, and ``recording``:

    POST /debug/profile {"seconds": 2, "dir": "run-1"}  -> 202, the
         capture runs on a daemon thread (at most 60 s); the response
         carries the pending ``trace_dir``; a ``dir`` outside the root
         -> 400
    GET  /debug/profile                                      -> status
         (poll until ``active`` is false; ``last_dir`` is the completed
         capture, ``last_error`` a refused or failed one)

Where the reference records an xplane trace with ``jax.profiler``, a capture
here is ``torch.profiler`` with the CPU activity and, on a card, the CUDA
one (CUPTI): every kernel the card runs in the window, the kernels of CUDA
graph replays included (the host ops recorded are the capture thread's
own). The window runs ``seconds`` from the moment the profiler has started
(``recording()``): the first capture in a process initializes CUPTI
first, ~9 s on an H100's host, and nothing is initialized before one is
asked for (a process that has profiled once keeps CUPTI attached, and its
graph launches cost the host more). Stopping and writing a capture of a
busy card (a decode step is ~2600 kernels: ~170k events a second) holds
the capture thread, and the GIL, for seconds. The Chrome trace is written
to
``<trace_dir>/trace.json`` (``TRACE_FILE``; chrome://tracing or
ui.perfetto.dev load it).

Captures are serialized (one at a time, 409 while one runs) and bounded
(<= 60 s). torch.profiler is one per process: a capture asked for while
another profiler runs in the process (a script's own ``torch.profiler``
included) is refused on the capture thread and reported in ``last_error``;
it never raises on a caller's thread, and the engine's loop never touches
it. Paths in ``status`` are relative to the configured root, so "where did
my trace go" does not depend on the server's working directory. Where the
reference writes to any ``dir`` a POST names, the route here takes one
only inside the root (a relative one is joined to it): the port's servers
serve the route by default, so a client must not create directories or
write traces elsewhere on the host. All ``_state`` reads and writes hold
``_lock``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional, Tuple

_MAX_SECONDS = 60.0
_DEFAULT_DIR = "./profiles"
# the Chrome trace inside each capture's directory
TRACE_FILE = "trace.json"

_lock = threading.Lock()
# set while a capture records (recording())
_recording = threading.Event()
# the process-wide capture root (PROFILE_DIR): App.enable_profiler sets it
# at boot; every caller that names no dir (POST without "dir", incident
# captures) lands here
_profile_dir = _DEFAULT_DIR
_state = {"active": False, "pending_dir": None, "started_at": None,
          "last_dir": None, "last_captured_at": None, "last_error": None,
          # provenance: "manual" POST or "incident" autopsy, the window
          # asked for; the monotonic start backs running_for_s and
          # last_duration_s
          "trigger": None, "seconds": None, "started_mono": None,
          "last_trigger": None, "last_duration_s": None}


def configure(profile_dir: Optional[str]) -> str:
    """Set the process-wide capture root (PROFILE_DIR). Returns the
    effective dir; None or "" keeps the current one."""
    global _profile_dir
    with _lock:
        if profile_dir:
            _profile_dir = str(profile_dir)
        return _profile_dir


def profile_dir() -> str:
    """The effective capture root."""
    with _lock:
        return _profile_dir


def _rel(path: Optional[str], root: str) -> Optional[str]:
    """`path` relative to the capture root when it lives under it."""
    if not path:
        return None
    try:
        rel = os.path.relpath(path, root)
    except ValueError:
        return path
    return path if rel.startswith("..") else rel


def _under_root(path: str) -> str:
    """A POSTed dir, joined to the capture root when relative; ValueError
    unless it resolves (symlinks followed) inside the root."""
    root = os.path.abspath(profile_dir())
    out = os.path.abspath(os.path.join(root, path))
    real = os.path.realpath(root)
    if os.path.commonpath([real, os.path.realpath(out)]) != real:
        raise ValueError(f"dir {path!r} is outside PROFILE_DIR ({root})")
    return out


def _profiler_running() -> bool:
    """Whether a torch.profiler (or the autograd profiler under it) is
    already on in this process."""
    import torch

    if getattr(torch.autograd.profiler, "_is_profiler_enabled", False):
        return True
    enabled = getattr(torch._C._autograd, "_profiler_enabled", None)
    return bool(enabled()) if enabled is not None else False


def recording() -> bool:
    """Whether a capture is recording now: its window runs from here, after
    the profiler's start (the first start in a process initializes CUPTI,
    seconds on a card)."""
    return _recording.is_set()


def _run_capture(seconds: float, out: str) -> None:
    """The capture body, on its own daemon thread."""
    error: Optional[str] = None
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if _profiler_running():
            raise RuntimeError("another torch.profiler is running in this "
                               "process; capture refused")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        _recording.set()
        try:
            time.sleep(seconds)
        finally:
            _recording.clear()
            prof.stop()
        prof.export_chrome_trace(os.path.join(out, TRACE_FILE))
    except Exception as exc:  # noqa: BLE001 - surfaced via status
        error = f"{type(exc).__name__}: {exc}"
    with _lock:
        started_mono = _state["started_mono"]
        _state["active"] = False
        _state["pending_dir"] = None
        _state["started_mono"] = None
        _state["last_error"] = error
        _state["last_trigger"] = _state["trigger"]
        if started_mono is not None:
            _state["last_duration_s"] = round(
                time.monotonic() - started_mono, 3)
        if error is None:
            _state["last_dir"] = out
            _state["last_captured_at"] = time.time()


def start_capture(seconds: float, log_dir: Optional[str] = None,
                  trigger: str = "manual") -> Tuple[str, float]:
    """Begin an async capture; returns (trace_dir, bounded_seconds).
    log_dir=None captures under the configured root; trigger records
    provenance ("manual" or "incident"). Raises ValueError on a bad
    duration and RuntimeError while another capture of this module runs
    (the route answers 409)."""
    seconds = min(float(seconds), _MAX_SECONDS)
    if seconds <= 0:
        raise ValueError("profile duration must be positive")
    if not log_dir:
        log_dir = profile_dir()
    out = os.path.join(log_dir, time.strftime("trace-%Y%m%d-%H%M%S"))
    with _lock:
        if _state["active"]:
            raise RuntimeError("a profile capture is already running")
        _state["active"] = True
        _state["pending_dir"] = out
        _state["started_at"] = time.time()
        _state["started_mono"] = time.monotonic()
        _state["trigger"] = str(trigger)
        _state["seconds"] = seconds
        _state["last_error"] = None
    try:
        os.makedirs(out, exist_ok=True)
    except OSError:
        with _lock:
            _state["active"] = False
            _state["pending_dir"] = None
            _state["started_mono"] = None
        raise
    threading.Thread(target=_run_capture, args=(seconds, out),
                     name="profile-capture", daemon=True).start()
    return out, seconds


def capture_trace(seconds: float, log_dir: Optional[str] = None,
                  poll_s: float = 0.05) -> str:
    """Blocking wrapper around start_capture: waits for the capture and
    returns its trace dir; raises RuntimeError with its error."""
    out, bounded = start_capture(seconds, log_dir)
    deadline = time.monotonic() + bounded + 30.0
    while time.monotonic() < deadline:
        with _lock:
            if not _state["active"]:
                if _state["last_error"]:
                    raise RuntimeError(_state["last_error"])
                return out
        time.sleep(poll_s)
    raise TimeoutError(f"profile capture did not finish within "
                       f"{bounded + 30:.0f}s")


def status() -> dict:
    with _lock:
        out = dict(_state)
        root = _profile_dir
        if out["started_mono"] is not None:
            out["running_for_s"] = round(
                time.monotonic() - out["started_mono"], 3)
        del out["started_mono"]
    out["profile_dir"] = root
    out["pending_rel"] = _rel(out.get("pending_dir"), root)
    out["last_rel"] = _rel(out.get("last_dir"), root)
    return out


def install_routes(app, path: str = "/debug/profile") -> None:
    """Register the capture and status endpoints on an App."""
    from ..http.responder import Response

    def reply(status: int, payload: dict):
        return Response(status=status,
                        headers={"Content-Type": "application/json"},
                        body=json.dumps(payload).encode())

    @app.post(path)
    def profile(ctx):  # noqa: ANN001
        body = ctx.bind() or {}
        seconds = float(body.get("seconds", 2.0))
        log_dir = None
        if body.get("dir"):
            try:
                log_dir = _under_root(str(body["dir"]))
            except ValueError as exc:
                return reply(400, {"error": {"message": str(exc)}})
        try:
            trace_dir, bounded = start_capture(seconds, log_dir,
                                               trigger="manual")
        except RuntimeError as exc:
            return reply(409, {"error": {"message": str(exc)}})
        return reply(202, {"data": {"trace_dir": trace_dir,
                                    "seconds": bounded,
                                    "status": "capturing"}})

    @app.get(path)
    def profile_status(ctx):  # noqa: ANN001
        return status()
