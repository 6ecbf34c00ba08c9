"""Spawned torch.distributed worlds for the port's CPU tests.

``run_world(fn, world, *args)`` starts `world` processes with the
``spawn`` method, joins them into one gloo process group on a free
localhost port (one thread each), runs ``fn(rank, world, *args)`` in every
one and returns the ranks' results in rank order. A rank that raises
fails the call with its traceback; a world that does not finish within
`timeout` seconds is killed and fails the call, so a hang fails the test
instead of stalling the suite. `fn` must be a module-level function of a
module that imports only the port (tests/torch_dist_workers.py): the
workers never import jax or gofr_tpu, and take and return numpy arrays
and plain values.
"""

import datetime
import multiprocessing as mp
import queue
import socket
import time
import traceback


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, args, out):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 - reported to the test process
        out.put((rank, False, traceback.format_exc()))


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def run_world(fn, world: int, *args, timeout: float = 150.0, entry=None):
    """fn(rank, world, *args) on every rank of a fresh gloo world; the
    results in rank order. entry: the per-process wrapper (default: one
    that joins the gloo group first; run_procs passes its own)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    target = entry or _entry
    procs = [ctx.Process(target=target,
                         args=(r, world, port, fn, args, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results = {}
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise AssertionError(
                    f"{getattr(fn, '__name__', fn)}: world of {world} hung "
                    f"past {timeout:.0f}s; ranks done: {sorted(results)}")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results
                        and p.exitcode not in (0, None)]
                if dead:
                    raise AssertionError(
                        f"rank {dead[0]} died with exit code "
                        f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=15)
        _kill(procs)
    return [results[r] for r in range(world)]


def _entry_bare(rank, world, port, fn, args, out):
    """A process that joins no group itself (fn does, e.g. through the
    JAX_* keys): fn(rank, world, port, *args)."""
    try:
        import torch

        torch.set_num_threads(1)
        out.put((rank, True, fn(rank, world, port, *args)))
    except BaseException:  # noqa: BLE001
        out.put((rank, False, traceback.format_exc()))


def run_procs(fn, world: int, *args, timeout: float = 150.0):
    """As run_world, but the processes join nothing: fn(rank, world, port,
    *args) gets the free port to join a job itself."""
    return run_world(fn, world, *args, timeout=timeout, entry=_entry_bare)
