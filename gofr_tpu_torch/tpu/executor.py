"""Prompt-length bucketing and the program cache.

Ports ``next_bucket`` and ``DEFAULT_BUCKETS`` from
``gofr_tpu/tpu/executor.py``, and of its ``Executor`` what the engines use:
``compile(name, fn, static_inputs)``, calling the program, ``cache_size()``,
``cache_info()``, ``compile_table()`` (the ``/debug/engine`` program table,
with the reference's row keys: ``executions`` are calls, ``compile_seconds``
capture seconds, ``disk_loads`` always 0), the ``on_compile(name, seconds)``
callback after every cache miss (the engine re-attributes the time to the
step ledger's ``compile`` segment; the timeline chains it), and, with
``metrics`` set, the reference's ``app_tpu_compile_total`` (misses),
``app_tpu_compile_cache_hits`` (lookups that found the program) and
``app_tpu_execute_total`` (calls), and the fault-injection site
``executor.compile`` (tpu/faults.py), hit at every compile-or-hit lookup
when a plane is armed (``faults``, None by default). The JAX executor compiles one XLA program per name and
shape; here a program is, on ``cuda``, a ``torch.cuda.CUDAGraph`` captured
once per name and replayed, and on ``cpu`` (only ever the tests' explicit
choice) the eager callable itself.

A captured program reads and writes fixed buffers: its ``inputs`` (the
caller fills them before each call; they stay the same tensors for the
program's life), the tensors ``fn`` closes over (the engine's caches and
loop state, updated in place) and its ``output``, which the next call
overwrites. Capture on the card goes:

1. ``fn`` runs once eagerly on the capture stream, inside the caller's
   ``warmup`` context (which puts the state it writes into a harmless one
   and restores it after). That run does the one-time work a capture must
   not: cuBLAS handles and workspaces, the kernels' shared-memory opt-ins
   (``cudaFuncSetAttribute``), the split reads' tickets, the kernels'
   launch counters.
2. The generators ``fn`` draws from are registered with the graph, and
   ``fn`` runs again under ``torch.cuda.graph`` on the same stream, all
   graphs sharing one memory pool, with Python's cycle collector held off.
   Nothing executes during a capture.

A capture that fails raises; there is no eager fallback on the card.

A replay runs no Python, so the kernels count their launches themselves,
on the card (``ops/launch_counts.py``): a replayed kernel counts as an
eager one does, and the warm-up run's kernels count too.

Collectives inside a capture (tensor-parallel engines, ROADMAP A14a): a
TP program's Megatron all-reduces and vocab all-gather (models/llama.py)
are NCCL calls on the capturing stream, captured into the graph with the
kernels around them, so a replay runs them with no Python. What that
needs: the NCCL communicator exists before the first capture (the job's
``init_process_group`` binds the card, parallel/multihost.join, and the
engine's first act under a mesh is an eager all-reduce,
``LLMEngine._agree_on_plan``); every rank captures the same programs in
the same order, since a capture runs its collectives once eagerly in the
warm-up run (the admission plane gives every rank the same dispatches,
hence the same captures, at boot and after it); and
``capture_error_mode="thread_local"`` (below), under which the NCCL
watchdog's event queries on its own thread neither fail nor spoil a
capture. On an H100 with torch 2.11 and a one-rank NCCL job this captured
and replayed with no watchdog error and no capture after boot
(chip_smoke.py phase 16); more ranks than one per job were not run on the
card yet.

Two threads may use one executor: the engine's loop, which captures and
replays its programs on the engine's stream, and a caller of the post-hoc
scoring passes (tpu/score.py), which captures and replays its window
programs on a stream of its own. So:

- ``compile`` and the cache's readers hold one lock: two captures never
  run at once (a capture begins by emptying the caching allocator, which
  PyTorch refuses while another capture is under way), and the cache is
  never read while it changes. Calls of a program do not take it.
- Every capture uses ``capture_error_mode="thread_local"``: what another
  thread does meanwhile (its launches, replays, synchronizations and
  allocations on its own stream) neither fails nor spoils the capture.
- The graphs of each stream share one memory pool of their own. A pool is
  shared only by graphs that never run at once, and graphs replayed on two
  streams may.

Two engines may share one process (the disaggregated pair's prefill twin
and decode engine, a harness's replicas), each with its own executor. A
capture begins with a device-wide synchronize and an emptying of the
caching allocator, and a device-wide synchronize while another stream
captures fails and spoils that capture. So every capture in the process,
whatever its executor, holds ``CAPTURE_LOCK``, and so does every
device-wide ``synchronize`` of the port (the launch counters' reads, the
engine's memory reading and its breaker probe, a TP job's teardown): none
runs while a capture is under way.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def next_bucket(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n. Raises if n exceeds the largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds largest bucket {buckets[-1]}")


class Program:
    """One cached program. ``program()`` runs it and returns its output;
    ``inputs`` are its static input buffers. Each call counts in its own
    ``calls`` and its executor's."""

    def __init__(self, name: str, inputs: Tuple[torch.Tensor, ...],
                 run: Callable[[], torch.Tensor], owner: "Executor"):
        self.name = name
        self.inputs = inputs
        self._run = run
        self._owner = owner
        self.calls = 0
        # compile() lookups that found this program cached
        self.hits = 0
        # seconds of the capture, its eager warm-up run included
        self.capture_seconds = 0.0

    def __call__(self) -> torch.Tensor:
        out = self._run()
        self.calls += 1
        owner = self._owner
        owner.calls += 1
        if owner.metrics is not None:
            owner._count("app_tpu_execute_total")
        return out


# held by every capture of the process and every device-wide synchronize
# (the module docstring); reentrant, so a synchronize on a capturing
# thread fails as CUDA says rather than waiting on itself
CAPTURE_LOCK = threading.RLock()


def synchronize(device, empty_cache: bool = False) -> None:
    """torch.cuda.synchronize(device), and then torch.cuda.empty_cache()
    when asked, once no capture is under way in this process."""
    with CAPTURE_LOCK:
        torch.cuda.synchronize(device)
        if empty_cache:
            torch.cuda.empty_cache()


def _graph_capture(pool, stream, generators):
    """The card's capture: fn under torch.cuda.graph on `stream`, sharing
    `pool`, with `generators` registered. Returns a replay that gives the
    static output."""

    def capture(fn, inputs):
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            # raises where this torch cannot replay a generator's draws
            graph.register_generator_state(gen)
        # Python's cycle collector must not run inside the capture: freeing
        # an unreachable object's CUDA graph or memory there is an
        # operation a capture forbids, and it invalidates the capture. So
        # collect now and hold the collector off until the capture ends.
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = fn(*inputs)
        finally:
            if enabled:
                gc.enable()

        def replay():
            graph.replay()
            return out
        return replay
    return capture


class Executor:
    """Capture-once, call-many cache of named programs on one device.

    device: where the programs run. stream: the stream a card's programs
    are captured on and must be replayed on (the engine's; ``compile``
    may name another for one program). capture:
    replaces the card's CUDA graph capture; ``capture(fn, inputs)`` returns
    a callable that runs the program and returns its output (the tests'
    stub on the CPU). With neither a card nor `capture`, a program is the
    eager callable."""

    def __init__(self, device, stream=None, capture=None):
        self.device = torch.device(device)
        self.stream = stream
        self._capture = capture
        # capture stream -> the graph memory pool of the programs on it
        self._pools: Dict[object, object] = {}
        self._lock = threading.Lock()
        self._cache: Dict[str, Program] = {}
        # program calls, dropped programs' included
        self.calls = 0
        # every name compiled, in order (a dropped program's included)
        self.compiled: List[str] = []
        self.captures = 0
        self.capture_seconds = 0.0
        # on_compile(name, seconds) after every cache miss (the engine's
        # step-ledger re-attribution; best-effort); metrics: a Manager for
        # the compile / cache-hit / execute counters, or None
        self.on_compile: Optional[Callable[[str, float], None]] = None
        self.metrics = None
        # the fault-injection plane (tpu/faults.py): None in production
        self.faults = None

    @property
    def captured(self) -> bool:
        """Whether programs are captured (the card, or a stub) rather than
        called eagerly."""
        return self._capture is not None or self.device.type == "cuda"

    def compile(self, name: str, fn: Callable[..., torch.Tensor],
                static_inputs: Sequence[torch.Tensor] = (),
                warmup: Optional[Callable[[], contextlib.AbstractContextManager]]
                = None, generators: Sequence[torch.Generator] = (),
                stream=None) -> Program:
        """The program `name`, captured from ``fn(*static_inputs)`` at its
        first use. warmup: a context manager factory around the eager run
        before the capture; generators: those ``fn`` draws from; stream:
        where this program is captured and replayed, if not the executor's
        stream (the caller makes it current around the compile and the
        calls)."""
        if self.faults is not None:   # chaos drills: slow or failed lookups
            self.faults.hit("executor.compile", name=name)
        with self._lock:
            program = self._cache.get(name)
            if program is not None:
                program.hits += 1
                if self.metrics is not None:
                    self._count("app_tpu_compile_cache_hits")
                return program
            inputs = tuple(static_inputs)
            t0 = time.monotonic()
            if not self.captured:
                program = Program(name, inputs, lambda: fn(*inputs), self)
            else:
                program = self._capture_program(name, fn, inputs, warmup,
                                                generators,
                                                stream or self.stream)
                program.capture_seconds = time.monotonic() - t0
                self.captures += 1
                self.capture_seconds += program.capture_seconds
            elapsed = time.monotonic() - t0
            self._cache[name] = program
            self.compiled.append(name)
        if self.metrics is not None:
            self._count("app_tpu_compile_total")
        if self.on_compile is not None:
            try:
                self.on_compile(name, elapsed)
            except Exception:  # noqa: BLE001 - attribution is best-effort
                pass
        return program

    def _count(self, name: str) -> None:
        try:
            self.metrics.increment_counter(name)
        except Exception:  # noqa: BLE001 - an unregistered name in a bare
            pass           # Manager must not fail a dispatch

    def _capture_program(self, name, fn, inputs, warmup, generators, stream):
        with warmup() if warmup is not None else contextlib.nullcontext():
            fn(*inputs)
        capture = self._capture
        if capture is None:
            pool = self._pools.get(stream)
            if pool is None:
                pool = self._pools[stream] = torch.cuda.graph_pool_handle()
            capture = _graph_capture(pool, stream, generators)
        with CAPTURE_LOCK:
            return Program(name, inputs, capture(fn, inputs), self)

    def drop(self, predicate: Callable[[str], bool]) -> int:
        """Forget the programs whose name satisfies `predicate` (their
        buffers are gone); returns how many."""
        with self._lock:
            names = [n for n in self._cache if predicate(n)]
            for n in names:
                del self._cache[n]
            return len(names)

    def cache_size(self) -> int:
        with self._lock:
            return len(self._cache)

    def cache_info(self) -> Dict[str, int]:
        """{program name: calls}."""
        with self._lock:
            return {name: p.calls for name, p in self._cache.items()}

    def compile_table(self) -> Dict[str, Any]:
        """The program cache as an operator table (``/debug/engine``), with
        the reference's keys: one row per program (``variants`` is 1 here:
        a name is one shape), calls as ``executions``, its lookups that
        hit as ``cache_hits``, capture seconds (its eager warm-up run
        included; 0 where programs are eager) as ``compile_seconds``;
        ``disk_loads`` and ``disk_hits_total`` are 0 (a CUDA graph has no
        disk cache). Heaviest capture first."""
        with self._lock:
            programs = list(self._cache.values())
        rows = sorted(({"name": p.name, "variants": 1,
                        "executions": p.calls, "cache_hits": p.hits,
                        "compile_seconds": round(p.capture_seconds, 3),
                        "disk_loads": 0} for p in programs),
                      key=lambda r: (-r["compile_seconds"], r["name"]))
        hits = sum(r["cache_hits"] for r in rows)
        lookups = hits + len(programs)
        return {
            "programs": rows,
            "distinct_programs": len(programs),
            "compile_seconds_total": round(
                sum(p.capture_seconds for p in programs), 3),
            "cache_hits_total": hits,
            "disk_hits_total": 0,
            "hit_ratio": round(hits / lookups, 4) if lookups else 0.0,
        }
