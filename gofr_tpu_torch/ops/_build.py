"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each source is one ``csrc/<name>.cu`` with a plain C interface (one or
more entry points; shared device code lives in ``csrc/*.cuh``). It is
compiled by ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at the
root of the checkout, at first use, and rebuilt when a hash of its sources
and flags changes. Nothing here runs at import: the CPU tests import every
module, and this machine may have no toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel -> (source in csrc/, C entry point, argtypes); every entry point
# takes the kernel's launch counter (launch_counts.py) as its last pointer
# before the stream and returns cudaGetLastError() as an int
ENTRY_POINTS = {
    "flash_attention": ("flash_attention", "gofr_flash_attention_fwd",
                        [_P] * 4 + [_I] * 7 + [ctypes.c_float]
                        + [ctypes.c_longlong] * 12 + [_P, _P]),
    "paged_attention": ("paged_attention", "gofr_paged_attention",
                        [_P] * 9 + [_I] * 9 + [ctypes.c_float, _P]),
    "paged_attention_q8": ("paged_attention", "gofr_paged_attention_q8",
                           [_P] * 11 + [_I] * 9 + [ctypes.c_float, _P]),
    "decode_attention": ("decode_attention", "gofr_decode_attention",
                         [_P] * 8 + [_I] * 7 + [ctypes.c_float, _P]),
    "decode_attention_q8": ("decode_attention", "gofr_decode_attention_q8",
                            [_P] * 10 + [_I] * 7 + [ctypes.c_float, _P]),
}
# the sources, one shared library each
KERNELS = tuple(dict.fromkeys(src for src, _, _ in ENTRY_POINTS.values()))

_lock = threading.Lock()
_functions: Dict[str, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """The nvcc binary: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return str(path)


def target(name: str) -> Path:
    """The library path for source `name`, keyed by a hash of its sources
    (the .cu and every shared .cuh) and the compiler flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, float]:
    """Compile the named sources that are not built yet, one nvcc process
    per source, all started together. Returns {name: seconds} for the ones
    compiled (the ptxas register/spill report is in ``<lib>.log``); raises
    RuntimeError with the compiler's output when any build fails."""
    names = names or KERNELS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    exe = None
    for name in names:
        out = target(name)
        if out.exists():
            continue
        exe = exe or nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (out, tmp, time.monotonic(), subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    took, failed = {}, []
    for name, (out, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.monotonic() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def function(name: str) -> ctypes._CFuncPtr:
    """The C entry point of kernel `name`, its argtypes and restype set,
    its source built and loaded at the first call; later calls are one dict
    lookup."""
    fn = _functions.get(name)
    if fn is not None:
        return fn
    with _lock:
        fn = _functions.get(name)
        if fn is None:
            source, symbol, argtypes = ENTRY_POINTS[name]
            build(source)
            fn = getattr(ctypes.CDLL(str(target(source))), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[name] = fn
        return fn
