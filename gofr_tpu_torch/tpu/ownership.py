"""Thread-ownership markers: the ``@loop_only`` convention.

A copy of ``gofr_tpu/tpu/ownership.py``, whole: ``loop_only``,
``is_loop_only`` and ``LOOP_ONLY_REGISTRY``. A function marked
``@loop_only`` (optionally with the instance fields it owns,
``fields=(...)``) runs only on the engine's loop thread. The decorator
costs nothing at run time: it stamps two attributes and returns the
function itself. The registry of every marked function is read by the
timeline (the loop track's metadata) and the host profiler (a thread whose
stack holds a marked function is the loop), never on a hot path.

    class StepLedger:
        @loop_only(fields=("_segments",))
        def step_start(self): ...
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

# qualname -> declared owned fields, for introspection and tests
LOOP_ONLY_REGISTRY: Dict[str, Tuple[str, ...]] = {}


def loop_only(fn: Optional[Callable] = None, *,
              fields: Tuple[str, ...] = ()):
    """Mark a function as engine-loop-thread-only. Usable bare
    (``@loop_only``) or with owned fields
    (``@loop_only(fields=("_slots",))``). Returns the function object
    itself: no wrapper, no per-call overhead."""

    def mark(f: Callable) -> Callable:
        f.__loop_only__ = True
        f.__loop_owned_fields__ = tuple(fields)
        LOOP_ONLY_REGISTRY[f"{f.__module__}.{f.__qualname__}"] = \
            tuple(fields)
        return f

    return mark(fn) if fn is not None else mark


def is_loop_only(fn: Callable) -> bool:
    return bool(getattr(fn, "__loop_only__", False))
