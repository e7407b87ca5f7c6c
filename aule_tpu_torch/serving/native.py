"""ctypes bindings of the native page allocator (counterpart of
aule_tpu/serving/native.py).

The C++ source is the repository's framework-free `csrc/aule_alloc.cpp`
(a plain C ABI, no Python or PyTorch headers), shared with the JAX package.
The port builds it with g++ at first use into its own git-ignored build
directory, `build/aule_tpu_torch/libaule_alloc_<source hash>.so` beside
the CUDA kernels' library, and loads it with ctypes.  Nothing is built at
import time.  `kv_cache.make_allocator` prefers `NativePageAllocator` and
falls back to `PythonPageAllocator` with a logged warning naming the build
error.

  NativePageAllocator    the LIFO free list of page ids, allocation for
                         allocation the Python allocator's order
  NativeSequenceManager  per-sequence page lists and [B, max_pages] block
                         tables with their lengths
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from .kv_cache import PagePoolExhausted

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "aule_alloc.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aule_tpu_torch"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_ERROR: Optional[str] = None

_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_PTR = ctypes.c_void_p
_P32 = ctypes.POINTER(ctypes.c_int32)
_P64 = ctypes.POINTER(ctypes.c_int64)

# C signatures of csrc/aule_alloc.cpp: (argument types, result type)
SIGNATURES = {
    "aule_alloc_create": ([_I32], _PTR),
    "aule_alloc_destroy": ([_PTR], None),
    "aule_alloc_num_free": ([_PTR], _I32),
    "aule_alloc_num_pages": ([_PTR], _I32),
    "aule_alloc_allocate": ([_PTR, _I32, _P32], _I32),
    "aule_alloc_free": ([_PTR, _I32, _P32], None),
    "aule_alloc_get_free": ([_PTR, _P32], None),
    "aule_alloc_set_free": ([_PTR, _I32, _P32], None),
    "aule_alloc_grow": ([_PTR, _I32], _I32),
    "aule_seqs_create": ([_PTR, _I32, _I32], _PTR),
    "aule_seqs_destroy": ([_PTR], None),
    "aule_seq_add": ([_PTR, _I64], _I32),
    "aule_seq_reserve": ([_PTR, _I64, _I64], _I32),
    "aule_seq_advance": ([_PTR, _I64, _I64], _I32),
    "aule_seq_len": ([_PTR, _I64], _I64),
    "aule_seq_remove": ([_PTR, _I64], _I32),
    "aule_build_batch_views": ([_PTR, _P64, _I32, _I32, _P32, _P32], _I32),
}


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libaule_alloc_{digest}.so"


def _build(so_path: Path) -> None:
    """g++ into a temporary file of the build directory, then an atomic
    rename: processes building at once never load a half-written file."""
    so_path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so_path.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ exited with {proc.returncode}: "
                               f"{proc.stderr.strip()[-2000:]}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library() -> ctypes.CDLL:
    """The allocator's library, built at the first call.  A failed build
    raises RuntimeError with g++'s error, at this call and every later
    one."""
    global _LIB, _LIB_ERROR
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        if _LIB_ERROR is not None:
            raise RuntimeError(_LIB_ERROR)
        try:
            so_path = library_path()
            if not so_path.exists():
                _build(so_path)
            lib = ctypes.CDLL(str(so_path))
        except Exception as e:  # the caller decides whether to fall back
            _LIB_ERROR = f"native allocator unavailable: {e}"
            raise RuntimeError(_LIB_ERROR) from e
        for name, (args, res) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        _LIB = lib
        return lib


def _ptr32(a: np.ndarray):
    return a.ctypes.data_as(_P32)


class NativePageAllocator:
    """PythonPageAllocator's interface on the C++ free list: the same
    pages in the same order for the same calls."""

    def __init__(self, num_pages: int):
        self._lib = load_library()
        self._h = self._lib.aule_alloc_create(num_pages)
        if not self._h:
            raise MemoryError("aule_alloc_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.aule_alloc_destroy(h)
            self._h = None

    @property
    def num_pages(self) -> int:
        return self._lib.aule_alloc_num_pages(self._h)

    @property
    def num_free(self) -> int:
        return self._lib.aule_alloc_num_free(self._h)

    def allocate(self, n: int) -> List[int]:
        out = np.empty((n,), np.int32)
        if self._lib.aule_alloc_allocate(self._h, n, _ptr32(out)) != 0:
            raise PagePoolExhausted(
                f"requested {n} pages, only {self.num_free} free")
        return out.tolist()

    def free(self, pages: List[int]) -> None:
        arr = np.ascontiguousarray(pages, np.int32)
        self._lib.aule_alloc_free(self._h, len(arr), _ptr32(arr))

    def grow(self, new_num_pages: int) -> None:
        """Add pages num_pages .. new_num_pages - 1 (the lowest comes out
        first)."""
        if self._lib.aule_alloc_grow(self._h, new_num_pages) != 0:
            raise ValueError(f"cannot shrink {self.num_pages} pages to "
                             f"{new_num_pages}")

    def free_list(self) -> List[int]:
        out = np.empty((self.num_free,), np.int32)
        self._lib.aule_alloc_get_free(self._h, _ptr32(out))
        return out.tolist()

    def set_free_list(self, pages: List[int]) -> None:
        arr = np.ascontiguousarray(pages, np.int32)
        self._lib.aule_alloc_set_free(self._h, len(arr), _ptr32(arr))


class NativeSequenceManager:
    """Per-sequence page lists and batch views on the C++ side, drawing
    pages from `allocator`."""

    def __init__(self, allocator: NativePageAllocator, page_size: int,
                 max_pages_per_seq: int):
        self._lib = allocator._lib
        self._alloc = allocator  # outlives the manager's handle
        self._h = self._lib.aule_seqs_create(allocator._h, page_size,
                                             max_pages_per_seq)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.aule_seqs_destroy(h)
            self._h = None

    def add(self, seq_id: int) -> None:
        if self._lib.aule_seq_add(self._h, seq_id) != 0:
            raise ValueError(f"sequence {seq_id} already present")

    def reserve(self, seq_id: int, num_new_tokens: int) -> None:
        rc = self._lib.aule_seq_reserve(self._h, seq_id, num_new_tokens)
        if rc == -1:
            raise PagePoolExhausted("page pool exhausted")
        if rc == -2:
            raise PagePoolExhausted("exceeds max_pages_per_seq")
        if rc != 0:
            raise KeyError(seq_id)

    def advance(self, seq_id: int, tokens: int) -> None:
        if self._lib.aule_seq_advance(self._h, seq_id, tokens) != 0:
            raise KeyError(seq_id)

    def length(self, seq_id: int) -> int:
        n = self._lib.aule_seq_len(self._h, seq_id)
        if n < 0:
            raise KeyError(seq_id)
        return int(n)

    def remove(self, seq_id: int) -> None:
        if self._lib.aule_seq_remove(self._h, seq_id) != 0:
            raise KeyError(seq_id)

    def batch_views(self, seq_ids: List[int], max_pages: int):
        """(block tables [B, max_pages] int32, -1 padded; lengths [B]
        int32) as numpy arrays; an unknown id gives a row of -1 and 0."""
        ids = np.ascontiguousarray(seq_ids, np.int64)
        bt = np.empty((len(ids), max_pages), np.int32)
        lens = np.empty((len(ids),), np.int32)
        rc = self._lib.aule_build_batch_views(
            self._h, ids.ctypes.data_as(_P64), len(ids), max_pages,
            _ptr32(bt), _ptr32(lens))
        if rc != 0:
            raise ValueError("sequence exceeds max_pages")
        return bt, lens
