"""Flash-attention forward (counterpart of aule_tpu/ops/flash.py).

`flash_attention_fwd` keeps the JAX signature and layout: q [B, Hq, Sq, D],
k/v [B, Hkv, Sk, D] in; `(out, lse [B, Hq, Sq])` or `out` back.  It follows
its tensors:
  * CPU tensors go to `flash_attention_fwd_plain`, the dense PyTorch version;
  * CUDA tensors launch a hand-written kernel (both replace the TPU kernels
    `_fwd_kernel` and `_mono_kernel`; see the source notes), or raise for
    what the kernels do not take: `flash_fwd_tma`, csrc/flash_fwd.cu's
    TMA/wgmma kernel, on every shape but the shortest prompts, which go to
    `flash_fwd_short`, csrc/flash_fwd_short.cu's mma.sync kernel, by one
    rule on the query length (`SHORT_SQ`).
The kernels take bf16/f16 with D=128; f32 on the card, D other than 128,
fused RoPE (`rope_cos`/`rope_sin`, i.e. `flash_attention_rope`) and a
traced `kv_len` come with later slices and raise here.  Training goes
through `ops/flash_vjp.py`, whose autograd Function calls this forward
(with its LSE) and the backward kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .reference import attention_reference

KERNEL_HEAD_DIM = 128
# Queries per head at or below which the mma.sync kernel runs: a tile or
# two of work, whose time is the latency to the first tile, which the
# TMA/wgmma kernel's warp-specialised set-up lengthens.  Set from
# chip_smoke.py's device times of both kernels at short prompts (on an
# H100 the mma.sync kernel led at 7 and 16 queries and trailed from 32;
# PERF.md).
SHORT_SQ = 16


def flash_attention_fwd_plain(q, k, v, *, causal: bool = False,
                              scale: Optional[float] = None,
                              window_size: int = -1,
                              return_lse: bool = True):
    """The plain PyTorch version of the kernel: dense f32 attention."""
    return attention_reference(q, k, v, causal=causal, scale=scale,
                               window_size=window_size,
                               return_lse=return_lse)


def _scale_window(q, scale, window_size):
    """(softmax scale, 1/sqrt(D) when None; window, -1 when none)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    window = int(window_size) if window_size and window_size > 0 else -1
    return float(scale), window


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"Hq={q.shape[1]} is not a multiple of "
                         f"Hkv={k.shape[1]}")


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    window_size: int = -1,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    return_lse: bool = True,
    kv_len: Optional[torch.Tensor] = None,
):
    """softmax(scale * q k^T + mask) v with GQA, causal (top-left aligned)
    and window masks, Sq != Sk and ragged lengths.  Returns
    (out, natural-log lse f32) or just out with return_lse=False."""
    _check_shapes(q, k, v)
    if rope_cos is not None or rope_sin is not None:
        raise NotImplementedError(
            "fused RoPE (flash_attention_rope) is not ported yet: it comes "
            "with a later slice; rotate q/k with ops.rope.apply_rope first")
    if kv_len is not None:
        raise NotImplementedError(
            "a traced kv_len (bucket-padded varlen) is not ported yet: it "
            "comes with the integration slice")
    scale, window = _scale_window(q, scale, window_size)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, causal=causal, scale=scale, window_size=window,
            return_lse=return_lse)
    kernel = flash_fwd_short if q.shape[2] <= SHORT_SQ else flash_fwd_tma
    return kernel(q, k, v, causal=causal, scale=scale, window_size=window,
                  return_lse=return_lse)


def _launch(entry: str, q, k, v, causal, scale, window_size, return_lse):
    """Check CUDA q, k, v and run the C entry point `entry` on them."""
    _check_shapes(q, k, v)
    scale, window = _scale_window(q, scale, window_size)
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernels run on CUDA tensors, got "
                         f"{q.device}")
    if q.shape[-1] != KERNEL_HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA flash kernels take D={KERNEL_HEAD_DIM}; D=64 and "
            f"D=256 come with the GPT-2 slice (got D={q.shape[-1]})")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dtype == torch.float32:
        raise NotImplementedError(
            "f32 flash attention on the card comes with a later slice; "
            "pass bf16 or f16")
    code = _build.dtype_code(q.dtype)
    if not (k.device == v.device == q.device):
        raise ValueError("q, k, v must be on one device")
    lib = _build.library()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:  # a TMA tensor map's base
            raise ValueError(f"{name} must start on a 16-byte boundary")
    batch, hq, seq_q, _ = q.shape
    hkv, seq_k = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((batch, hq, seq_q), dtype=torch.float32,
                       device=q.device) if return_lse else None)
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        batch, hq, hkv, seq_q, seq_k, scale, int(bool(causal)),
        window, code, _build.stream_handle(q.device))
    _build.check(err, entry)
    return (out, lse) if return_lse else out


def flash_fwd_tma(q, k, v, *, causal: bool = False,
                  scale: Optional[float] = None, window_size: int = -1,
                  return_lse: bool = True):
    """csrc/flash_fwd.cu's TMA/wgmma kernel on CUDA tensors of any length
    (what `flash_attention_fwd` runs above SHORT_SQ queries)."""
    res = _launch("aule_flash_fwd", q, k, v, causal, scale, window_size,
                  return_lse)
    flash_fwd_tma.launches += 1
    return res


def flash_fwd_short(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, window_size: int = -1,
                    return_lse: bool = True):
    """csrc/flash_fwd_short.cu's mma.sync kernel on CUDA tensors of any
    length (what `flash_attention_fwd` runs up to SHORT_SQ queries)."""
    res = _launch("aule_flash_fwd_short", q, k, v, causal, scale,
                  window_size, return_lse)
    flash_fwd_short.launches += 1
    return res


# kernel launches since the last reset (the CPU route counts none)
flash_fwd_tma.launches = 0
flash_fwd_short.launches = 0
