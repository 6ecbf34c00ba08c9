"""ctypes loader for the port's native BPE core (gofr_native.cc).

Ports from ``gofr_tpu/native/__init__.py``: ``available``, ``version`` and
``BPECore`` (id-level greedy BPE merges, the tokenizers' hot encode loop),
with ``encode_pieces``, the loop over many pieces in one library call, and
``propose_draft`` (speculative decoding's prompt-lookup scan).
The library is compiled from the source beside this file with the host C++
compiler (``CXX``, default ``g++``) at first use, into
``build/torch_native/`` at the root of the checkout, named by a hash of the
source and flags (the reference builds next to its source, inside the
package). Nothing is built at import. Without a compiler ``available()`` is
False and the tokenizers keep their Python merge loop, as the reference's
do: host code, not a device fallback. ``pad_batch`` is not ported (the
port's admission pads).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "gofr_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_i32p = ctypes.POINTER(ctypes.c_int32)
_lock = threading.Lock()
_lib = None
_tried = False


def target() -> Path:
    """The library's path, keyed by a hash of the source and the flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f"libgofr_native-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        result = subprocess.run(
            [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
             str(SRC)], capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if result.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)   # atomic: a reader never sees half a file
    return True


def _load():
    global _lib, _tried
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = target()
        if not out.exists() and not _build(out):
            return None
        lib = ctypes.CDLL(str(out))
        lib.gn_version.restype = ctypes.c_char_p
        lib.gn_bpe_new.restype = ctypes.c_void_p
        lib.gn_bpe_new.argtypes = [ctypes.c_int32, _i32p, _i32p, _i32p]
        lib.gn_bpe_free.argtypes = [ctypes.c_void_p]
        lib.gn_bpe_encode.restype = ctypes.c_int32
        lib.gn_bpe_encode.argtypes = [ctypes.c_void_p, _i32p, ctypes.c_int32,
                                      _i32p]
        lib.gn_bpe_encode_pieces.restype = ctypes.c_int32
        lib.gn_bpe_encode_pieces.argtypes = [ctypes.c_void_p, _i32p, _i32p,
                                             ctypes.c_int32, _i32p, _i32p]
        lib.gn_propose_draft.restype = ctypes.c_int32
        lib.gn_propose_draft.argtypes = [_i32p, ctypes.c_int32,
                                         ctypes.c_int32, _i32p]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library is built (here, at first call) and loaded."""
    return _load() is not None


def version() -> str:
    lib = _load()
    return lib.gn_version().decode() if lib else "unavailable"


def propose_draft(history, d: int) -> Optional[List[int]]:
    """Prompt-lookup draft: tokens that followed the most recent earlier
    occurrence of history's trailing bigram (speculative decoding's host
    side). Returns None when the library is missing (callers fall back to
    the pure-Python scan in the engine)."""
    lib = _load()
    if lib is None:
        return None
    n = len(history)
    if n < 3 or d <= 0:
        return []
    hist = np.ascontiguousarray(np.asarray(history, dtype=np.int32))
    out = np.empty(d, dtype=np.int32)
    count = lib.gn_propose_draft(hist.ctypes.data_as(_i32p), n, d,
                                 out.ctypes.data_as(_i32p))
    return out[:count].tolist()


class BPECore:
    """Native greedy BPE over token ids. merge_triples: ordered
    [(left_id, right_id, merged_id)], the index is the rank; a pair listed
    twice takes its last rank."""

    def __init__(self, merge_triples: Sequence[Tuple[int, int, int]]):
        lib = _load()
        if lib is None:
            raise RuntimeError("the native BPE core is unavailable (no C++ "
                               "compiler?)")
        self._lib = lib
        arr = np.asarray(merge_triples, dtype=np.int32).reshape(-1, 3)
        left, right, merged = (np.ascontiguousarray(arr[:, i])
                               for i in range(3))
        self._handle = lib.gn_bpe_new(
            len(arr), left.ctypes.data_as(_i32p), right.ctypes.data_as(_i32p),
            merged.ctypes.data_as(_i32p))

    def encode(self, ids: Sequence[int]) -> List[int]:
        src = np.ascontiguousarray(np.asarray(ids, dtype=np.int32))
        if src.size == 0:
            return []
        out = np.empty(src.size, dtype=np.int32)
        n = self._lib.gn_bpe_encode(self._handle, src.ctypes.data_as(_i32p),
                                    src.size, out.ctypes.data_as(_i32p))
        return out[:n].tolist()

    def encode_pieces(self, pieces: Sequence[Sequence[int]]
                      ) -> List[List[int]]:
        """encode() of each piece, in one call of the library."""
        if not pieces:
            return []
        lengths = np.fromiter(map(len, pieces), dtype=np.int32,
                              count=len(pieces))
        offsets = np.zeros(len(pieces) + 1, dtype=np.int32)
        np.cumsum(lengths, out=offsets[1:])
        src = np.fromiter((i for p in pieces for i in p), dtype=np.int32,
                          count=int(offsets[-1]))
        out = np.empty(max(1, src.size), dtype=np.int32)
        counts = np.empty(len(pieces), dtype=np.int32)
        self._lib.gn_bpe_encode_pieces(
            self._handle, src.ctypes.data_as(_i32p),
            offsets.ctypes.data_as(_i32p), len(pieces),
            out.ctypes.data_as(_i32p), counts.ctypes.data_as(_i32p))
        flat = out.tolist()
        ends = np.cumsum(counts).tolist()
        return [flat[e - c:e] for e, c in zip(ends, counts.tolist())]

    def __del__(self):
        handle: Optional[int] = getattr(self, "_handle", None)
        if handle:
            self._lib.gn_bpe_free(handle)
            self._handle = None
