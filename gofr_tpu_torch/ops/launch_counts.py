"""Kernel launch counts, kept on the card by the kernels themselves.

Every kernel of ``ops/csrc`` takes a pointer to its own 64-bit counter, and
its first thread (thread 0 of block (0, 0, 0)) adds one to it. So a launch
is counted where it runs, whether the wrapper launched it eagerly or a CUDA
graph that captured it is replayed (a replay runs no Python). Each wrapper
passes ``counter(<kernel>, device)``; ``counts()`` reads every counter and
``zero()`` clears them. The counters of a device are one int64 buffer made
at the first launch there, never freed or moved: a captured graph keeps its
address. Their reads synchronize the device, so they wait for any CUDA
graph capture under way in the process (tpu/executor.synchronize).
"""

from __future__ import annotations

from typing import Dict

import torch

# the kernels, in their counters' order (``_build.ENTRY_POINTS`` names)
KERNELS = ("flash_attention", "paged_attention", "paged_attention_q8",
           "decode_attention", "decode_attention_q8")

# device index -> its [len(KERNELS)] int64 counters
_buffers: Dict[int, torch.Tensor] = {}


def counter(kernel: str, device: torch.device) -> int:
    """The address of `kernel`'s launch counter on `device` (a CUDA
    device), made zeroed at the device's first launch. Raises during a CUDA
    graph capture if the counters do not exist yet: their fill would be
    captured and their memory taken from the graph's pool (the eager run
    before a capture makes them)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    buf = _buffers.get(index)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("kernel launch counters do not exist at "
                               "capture: launch a kernel eagerly first")
        from ..tpu.executor import synchronize

        buf = torch.zeros(len(KERNELS), dtype=torch.int64,
                          device=torch.device("cuda", index))
        # the fill is on this stream; a kernel may count on another
        synchronize(index)
        _buffers[index] = buf
    return buf.data_ptr() + buf.element_size() * KERNELS.index(kernel)


def counts() -> Dict[str, int]:
    """{kernel: launches run since the last zero()}, summed over devices;
    waits for every device that has counters."""
    from ..tpu.executor import synchronize

    total = dict.fromkeys(KERNELS, 0)
    for index, buf in _buffers.items():
        synchronize(index)
        for kernel, n in zip(KERNELS, buf.tolist()):
            total[kernel] += n
    return total


def zero() -> None:
    """Every counter to 0, after the work queued before the call and
    before any queued after it."""
    from ..tpu.executor import synchronize

    for index, buf in _buffers.items():
        synchronize(index)
        buf.zero_()
        synchronize(index)
