"""Dynamic batching scheduler: time/size-windowed batch assembly over a queue.

Ports ``gofr_tpu/tpu/scheduler.py`` (``DynamicBatcher``, ``_WorkItem``,
``BATCH_BUCKETS``) and the ``pad_to`` it imports from the reference's
executor. Handlers enqueue a payload and block on its future; the loop
thread gathers what arrives inside ``window_s`` (up to ``max_batch``), pads
the batch dim to a power-of-two bucket with copies of row 0 and, with
``seq_axis`` set, every row to the batch's sequence bucket with
``pad_value``, runs the model once and hands each row back. The same
contract as the reference: an oversized payload is refused at ``submit``
(one bad request cannot fail the batch it would join), an unknown QoS
class is ``normalize_class``'s typed 400, ``infer(timeout_s=)`` blocks,
the queue depth, batch sizes and wait times go through
``tpu/obs.MetricsHook`` (``app_tpu_queue_depth``, ``app_tpu_batch_size``,
``app_tpu_ttft_seconds``), and ``stop()`` fails what is queued without
racing a live loop.

Each (batch bucket, sequence bucket) is one program of the port's
``tpu/executor.Executor``, named as the reference names its program, by the
batcher's name, with the shape that keys it appended
(``mnist-mlp-8x784``): on the card a CUDA graph captured under
``torch.no_grad()`` at the shape's first batch (or by ``warmup``) on the
batcher's own stream, with a fixed input buffer that each batch is copied
into, and replayed; on the CPU the eager model. ``batches`` counts the
batches run per program.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .executor import Executor, next_bucket
from .obs import MetricsHook
from .qos import normalize_class

BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def pad_to(array: np.ndarray, size: int, axis: int = 0, value=0) -> np.ndarray:
    """Pad `array` along `axis` up to `size` with `value` (no-op if already
    there)."""
    current = array.shape[axis]
    if current == size:
        return array
    if current > size:
        raise ValueError(f"array dim {current} larger than target {size}")
    widths = [(0, 0)] * array.ndim
    widths[axis] = (0, size - current)
    return np.pad(array, widths, constant_values=value)


class _WorkItem:
    __slots__ = ("payload", "future", "enqueued_at", "qos_class", "tenant")

    def __init__(self, payload, qos_class=None, tenant=""):
        self.payload = payload
        self.future: Future = Future()
        self.enqueued_at = time.monotonic()
        # the batcher assembles FIFO (items share one padded dispatch); the
        # class rides along validated, as on the engine path
        self.qos_class = qos_class
        self.tenant = tenant


class DynamicBatcher:
    """Batches single-example payloads into padded model calls.

    model_fn(batch) -> batch of outputs, on torch tensors of the executor's
    device. Payloads are numpy arrays whose leading axis is the example (a
    payload of shape [T, ...] becomes row b of a [B, T, ...] batch). When
    examples vary along `seq_axis`, each is padded to the batch's sequence
    bucket. executor: where the programs run (default: the CUDA card)."""

    def __init__(
        self,
        model_fn: Callable,
        executor: Optional[Executor] = None,
        max_batch: int = 32,
        window_s: float = 0.005,
        batch_buckets: Sequence[int] = BATCH_BUCKETS,
        seq_axis: Optional[int] = None,
        seq_buckets: Sequence[int] = (16, 32, 64, 128, 256, 512, 1024, 2048),
        pad_value=0,
        name: str = "dynamic-batcher",
        metrics=None,
        logger=None,
    ):
        if executor is None:
            from .device import resolve_device

            executor = Executor(resolve_device(None))
        self.model_fn = model_fn
        self.executor = executor
        self.device = executor.device
        # the card's programs are captured and replayed on the executor's
        # stream, one of the batcher's own unless the executor has one
        if executor.stream is None and self.device.type == "cuda":
            executor.stream = torch.cuda.Stream(self.device)
        self.stream = executor.stream
        # program name -> Program (its input buffer stays for its life)
        self._programs: Dict[str, object] = {}
        self.max_batch = max_batch
        self.window_s = window_s
        self.batch_buckets = tuple(b for b in batch_buckets if b <= max_batch) or (max_batch,)
        self.seq_axis = seq_axis
        self.seq_buckets = seq_buckets
        self.pad_value = pad_value
        self.name = name
        self.metrics = metrics if metrics is not None else executor.metrics
        self.logger = logger
        self._obs = MetricsHook(self.metrics)
        self._queue: "queue.Queue[_WorkItem]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # program name -> batches it ran
        self.batches: Dict[str, int] = collections.Counter()

    # -- ingress --------------------------------------------------------------
    def submit(self, payload, qos_class=None, tenant: str = "") -> Future:
        if self._stop.is_set():
            raise RuntimeError("batcher is stopped")
        # unknown class strings die here with a typed 400 (InvalidParam),
        # never a silent default, as engine.submit
        qos_class = normalize_class(qos_class)
        if self.seq_axis is not None and hasattr(payload, "shape"):
            # reject oversized payloads here so one bad request can't fail
            # the whole co-assembled batch in _run_batch
            seq_len = payload.shape[self.seq_axis]
            if seq_len > self.seq_buckets[-1]:
                raise ValueError(f"sequence of {seq_len} exceeds the largest "
                                 f"bucket ({self.seq_buckets[-1]})")
        item = _WorkItem(payload, qos_class=qos_class, tenant=tenant)
        self._queue.put(item)
        self._obs.gauge("app_tpu_queue_depth", self._queue.qsize())
        return item.future

    def infer(self, payload, timeout_s: Optional[float] = None):
        """Blocking convenience: submit and wait (what HTTP handlers call)."""
        return self.submit(payload).result(timeout=timeout_s)

    # -- programs -------------------------------------------------------------
    def _program(self, shape, dtype):
        """The program for a padded batch of `shape` and numpy `dtype`."""
        name = f"{self.name}-" + "x".join(str(d) for d in shape)
        program = self._programs.get(name)
        if program is None:
            buf = torch.zeros(shape, dtype=torch.from_numpy(
                np.zeros(0, dtype=dtype)).dtype, device=self.device)

            def run(x):
                with torch.no_grad():
                    return self.model_fn(x)

            program = self._programs[name] = self.executor.compile(
                name, run, (buf,))
        return program

    def warmup(self, batch_sizes: Sequence[int], example: np.ndarray) -> int:
        """Make the program of each batch size in `batch_sizes` (the
        reference's ``executor.warmup``) for payloads shaped as `example`
        (already at its sequence bucket when seq_axis is set) before
        serving; returns how many were captured."""
        before = self.executor.captures
        with self._on_stream():
            for n in batch_sizes:
                self._program((n,) + example.shape, example.dtype)
        return self.executor.captures - before

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name=self.name, daemon=True)
        self._thread.start()

    # stop() waits this long for the loop thread before declaring it stuck
    # (class attr so tests can tighten it)
    STOP_JOIN_S = 5.0

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=self.STOP_JOIN_S)
            if thread.is_alive():
                # still inside _run_batch: failing the queue here would race
                # the live loop's own future completion. The live loop
                # drains the queue itself when it exits.
                if self.logger is not None:
                    self.logger.errorf(
                        "batcher %s loop still running after %.0fs; leaving "
                        "queue draining to the live loop", self.name,
                        self.STOP_JOIN_S)
                return
            self._thread = None
        self._fail_queued(RuntimeError("batcher stopped"))

    def _fail_queued(self, exc: BaseException) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if not item.future.done():
                item.future.set_exception(exc)

    # -- device loop ----------------------------------------------------------
    def _collect(self) -> list:
        """Block for the first item, then fill the batch inside the window."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        items = [first]
        deadline = time.monotonic() + self.window_s
        while len(items) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                items.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _loop(self) -> None:
        while not self._stop.is_set():
            items = self._collect()
            if not items:
                continue
            try:
                self._run_batch(items)
            except Exception as exc:  # noqa: BLE001 - fail the batch, keep serving
                if self.logger is not None:
                    self.logger.errorf("batch failed: %s", exc)
                for item in items:
                    if not item.future.done():
                        item.future.set_exception(exc)
        # the loop owns queue draining on the way out, so completing queued
        # futures never races a batch's own completion
        self._fail_queued(RuntimeError("batcher stopped"))

    def _run_batch(self, items: list) -> None:
        n = len(items)
        bucket = next_bucket(n, self.batch_buckets)
        payloads = [np.asarray(item.payload) for item in items]

        if self.seq_axis is not None:
            max_len = max(p.shape[self.seq_axis] for p in payloads)
            seq_bucket = next_bucket(max_len, self.seq_buckets)
            payloads = [pad_to(p, seq_bucket, axis=self.seq_axis, value=self.pad_value)
                        for p in payloads]

        batch = np.stack(payloads)
        if bucket > n:  # pad batch dim with copies of row 0 (cheap, discarded)
            fill = np.broadcast_to(batch[:1], (bucket - n,) + batch.shape[1:])
            batch = np.concatenate([batch, fill], axis=0)

        with self._on_stream():
            program = self._program(batch.shape, batch.dtype)
            program.inputs[0].copy_(torch.from_numpy(batch))
            outputs = program().cpu().numpy()
        self.batches[program.name] += 1

        self._obs.hist("app_tpu_batch_size", n)
        self._obs.gauge("app_tpu_queue_depth", self._queue.qsize())
        now = time.monotonic()
        for i, item in enumerate(items):
            if not item.future.done():
                item.future.set_result(outputs[i])
            self._obs.hist("app_tpu_ttft_seconds", now - item.enqueued_at)
