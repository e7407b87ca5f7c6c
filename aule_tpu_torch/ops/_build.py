"""Build and load the port's CUDA kernels (aule_tpu_torch/csrc/*.cu).

Route: nvcc by hand into one shared library with a plain C interface,
loaded with ctypes (no PyTorch headers, so a build takes seconds, not
minutes).  Each source compiles to an object in its own nvcc process, all
started together, then one link makes the library.  The library lands in
`build/aule_tpu_torch/` at the repository root (listed in .gitignore),
named by a hash of the sources and flags, and is built at first use.

Every C entry point returns `cudaGetLastError()` after its launch;
`check` raises when that is not 0.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aule_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float

# C signatures: every pointer and the stream are c_void_p, every int c_int
SIGNATURES = {
    # q, k, v, out, lse, rope cos, rope sin, kv_len, B, Hq, Hkv, Sq, Sk, D,
    # rope_len, scale, causal, window, dtype, stream
    "aule_flash_fwd": [_VOID] * 8 + [_INT] * 7 + [_FLOAT] + [_INT] * 3 +
                      [_VOID],
    # as aule_flash_fwd (D is 128)
    "aule_flash_fwd_short": [_VOID] * 8 + [_INT] * 7 + [_FLOAT] +
                            [_INT] * 3 + [_VOID],
    # q, k, v, out, lse, rope cos, rope sin, kv_len, ws, counters, B, Hq,
    # Hkv, Sk, D, rope_len, scale, causal, window, nsplit, dtype, stream
    "aule_flash_fwd_decode": [_VOID] * 10 + [_INT] * 6 + [_FLOAT] +
                             [_INT] * 4 + [_VOID],
    # as aule_flash_fwd (dtype 2: f32)
    "aule_flash_f32_fwd": [_VOID] * 8 + [_INT] * 7 + [_FLOAT] + [_INT] * 3 +
                          [_VOID],
    # o, do, dlse, di, rows, D, dtype, stream
    "aule_flash_generic_delta": [_VOID] * 4 + [_INT] * 3 + [_VOID],
    # q, k, v, do, lse, di, dq, B, Hq, Hkv, Sq, Sk, D, scale, causal,
    # window, dtype, stream
    "aule_flash_f32_bwd_dq": [_VOID] * 7 + [_INT] * 6 + [_FLOAT] +
                             [_INT] * 3 + [_VOID],
    # q, k, v, do, lse, di, dk, dv, workspace, B, Hq, Hkv, Sq, Sk, D, scale,
    # causal, window, dtype, stream
    "aule_flash_f32_bwd_dkv": [_VOID] * 9 + [_INT] * 6 + [_FLOAT] +
                              [_INT] * 3 + [_VOID],
    # as aule_flash_f32_bwd_dkv (D 256)
    "aule_flash_generic_dkv": [_VOID] * 9 + [_INT] * 6 + [_FLOAT] +
                              [_INT] * 3 + [_VOID],
    # x, out, B * H, S, rope cos, rope sin, D, rope_len, dtype, stream
    "aule_rope_prepass": [_VOID] * 2 + [_INT] * 2 + [_VOID] * 2 +
                         [_INT] * 3 + [_VOID],
    # q, qf, kv, scales, tables, lens, out, lse, ws, counters, B, Hq, Hkv,
    # D, page, max_pages, scale, window, nsplit, tile_rows, dtype, pool,
    # sc_f32, stream
    "aule_paged_decode": [_VOID] * 10 + [_INT] * 6 + [_FLOAT] +
                         [_INT] * 6 + [_VOID],
    # q, k, v, k_scales, v_scales, tables, lens, out, lse, ws, counters, B,
    # Hq, Hkv, D, num_pages, page, max_pages, scale, window, nsplit,
    # tile_rows, dtype, pool, stream
    "aule_paged_decode_split": [_VOID] * 11 + [_INT] * 7 + [_FLOAT] +
                               [_INT] * 5 + [_VOID],
    # q, kv, scales, tables, lens, q_offsets, out, lse, B, Hq, Hkv, Sq, D,
    # page, max_pages, scale, causal, window, dtype, pool, sc_f32, stream
    "aule_paged_prefill": [_VOID] * 8 + [_INT] * 7 + [_FLOAT] +
                          [_INT] * 5 + [_VOID],
    # q, qf, kv, v, scales, v_scales, tables, lens, out, lse, ws,
    # counters, B, Hq, Hkv, num_pages, page, max_pages, D, scale, window,
    # nsplit, tile_rows, dtype, pool, sc_f32, layout, stream
    "aule_paged_generic_decode": [_VOID] * 12 + [_INT] * 7 + [_FLOAT] +
                                 [_INT] * 7 + [_VOID],
    # q, kv, scales, tables, lens, q_offsets, out, lse, B, Hq, Hkv, Sq,
    # page, max_pages, D, scale, causal, window, dtype, pool, sc_f32, stream
    "aule_paged_generic_prefill": [_VOID] * 8 + [_INT] * 7 + [_FLOAT] +
                                  [_INT] * 5 + [_VOID],
    # q, k, v, do, o, dlse, lse, di, dq, B, Hq, Hkv, Sq, Sk, D, scale,
    # causal, window, dtype, stream
    "aule_flash_bwd_dq": [_VOID] * 9 + [_INT] * 6 + [_FLOAT] + [_INT] * 3 +
                         [_VOID],
    # q, k, v, do, lse, di, dk, dv, B, Hq, Hkv, Sq, Sk, D, scale, causal,
    # window, dtype, stream
    "aule_flash_bwd_dkv": [_VOID] * 8 + [_INT] * 6 + [_FLOAT] + [_INT] * 3 +
                          [_VOID],
    # o, do, dlse, di, rows, D, dtype, stream
    "aule_flash_bwd_delta": [_VOID] * 4 + [_INT] * 3 + [_VOID],
}

# pool codes (csrc/common.cuh kPool*): what a paged pool holds
POOL_NATIVE = 0    # the q/out type (bf16 or f16; f32 in the generic kernels)
POOL_INT8 = 1      # int8 payload + scales, converted exactly
POOL_E4M3 = 2      # e4m3 payload + scales, converted exactly
POOL_INT8_DOT = 3  # int8 payload + scales, int8 q, int8 dot products


class _State:
    lib: Optional[ctypes.CDLL] = None
    build_seconds: Optional[float] = None   # None until built or loaded
    log: str = ""                           # nvcc / ptxas output


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libaule_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link the
    library, unless the library for these exact sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus, _ = _sources()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for cu in cus:
            obj = Path(tmp) / (cu.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)]
            procs.append((cu, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cu, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {cu.name}\n{out}")
            if proc.returncode != 0:
                failed.append(cu.name)
        _State.log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{_State.log}")
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, "-shared", *[str(o) for _, o, _ in procs], "-o",
             str(tmp_so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)  # atomic: a reader never sees half a file
    _State.build_seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text(_State.log)
    return so


def library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    if _State.lib is None:
        try:
            so = build()
        except RuntimeError as e:
            _record_error(str(e))
            raise
        if _State.build_seconds is None:
            _State.build_seconds = 0.0
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _INT
        lib.aule_error_string.argtypes = [_INT]
        lib.aule_error_string.restype = ctypes.c_char_p
        _State.lib = lib
    return _State.lib


def build_seconds() -> Optional[float]:
    """Seconds the last build in this process took (0.0 when the library
    was already built; None before first use)."""
    return _State.build_seconds


def build_log() -> str:
    return _State.log


def _record_error(msg: str) -> None:
    """A build or launch failure, for `get_backend_errors()["cuda"]`."""
    from .. import backends

    backends.record_error("cuda", msg)


def check(err: int, name: str) -> None:
    if err != 0:
        msg = (f"{name}: CUDA error {err} "
               f"({library().aule_error_string(err).decode()})")
        _record_error(msg)
        raise RuntimeError(msg)


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype, f32: bool = False) -> int:
    """0 = bfloat16, 1 = float16 (the kernels' storage types); 2 = float32
    where the kernel takes it (`f32`: csrc/flash_f32.cu,
    csrc/flash_f32_bwd.cu, csrc/flash_generic.cu, csrc/paged_generic.cu)."""
    if dtype == torch.bfloat16:
        return 0
    if dtype == torch.float16:
        return 1
    if f32 and dtype == torch.float32:
        return 2
    raise TypeError(f"the CUDA kernels take bfloat16 or float16"
                    f"{' or float32' if f32 else ''}, got {dtype}")


def pool_code(dtype) -> int:
    """POOL_INT8 or POOL_E4M3 for a quantized pool's payload dtype."""
    if dtype == torch.int8:
        return POOL_INT8
    if dtype == torch.float8_e4m3fn:
        return POOL_E4M3
    raise TypeError(f"quantized pools hold int8 or float8_e4m3fn, got "
                    f"{dtype}")


def scale_code(dtype) -> int:
    """0 = bfloat16, 1 = float32 (the packed scale tile's types)."""
    if dtype == torch.bfloat16:
        return 0
    if dtype == torch.float32:
        return 1
    raise TypeError(f"kv_scales must be bfloat16 or float32, got {dtype}")
