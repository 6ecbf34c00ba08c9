"""Prompt-length bucketing.

Ports ``next_bucket`` and ``DEFAULT_BUCKETS`` from
``gofr_tpu/tpu/executor.py``. PyTorch runs eagerly, so the JAX executor's
compile cache has no counterpart yet; capturing the step programs as CUDA
graphs is ROADMAP A11.
"""

from __future__ import annotations

from typing import Sequence

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def next_bucket(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n. Raises if n exceeds the largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds largest bucket {buckets[-1]}")
