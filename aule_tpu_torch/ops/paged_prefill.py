"""Chunked prefill over the fused paged pool (counterpart of
aule_tpu/ops/paged_fused.py:757-1091, `paged_attention_prefill`).

Append the chunk first (`paged_fused.kv_cache_append_prefill_fused`), then
call with `context_lens` = the new total lengths: query s of sequence b
sits at absolute position `q_offsets[b] + s` (default `context_lens -
S_new`) and attends to cache positions at or before its own (causal), and
within `q - k <= W` with a window.  Rows at or past `context_lens[b]` (the
padding of ragged chunks) give zeros and LSE -0.7 * f32max, as the JAX
function's docstring states.  (The JAX kernel itself lets such rows attend
to the whole context; ROADMAP.md queue 3 records it.  No serving path reads
those rows.)

`paged_attention_prefill` follows its tensors: CPU tensors take
`paged_attention_prefill_plain`; CUDA tensors launch a hand-written kernel
that replaces `_fused_prefill_kernel` (see the source notes), by one rule
on the type (ops/paged_generic.py `prefill_uses_generic`): for bf16 / f16
at D = 64, 128 or 256 csrc/paged_prefill.cu's (a warp-specialised wgmma
kernel whose producer warps gather the pages and convert int8 / e4m3
tiles; templated on the head dim, a D = 64 q reads the D live lanes of the
pool's 128-lane rows), for f32 at D 64 / 128 / 256 csrc/paged_prefill_f32.cu's
3xTF32 prefill (ops/paged_generic.py).  Any other head dim up to 256 runs
as the decode's does (ops/paged_fused.py): q padded to the kernel width
above it, the output sliced back.  The
JAX function's TPU tiling arguments (`block_q`, `pages_per_compute_block`)
have no counterpart: the kernel picks its tiles in the source.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .flash import kernel_head_dim, pad_head, pads_head, unpad_head
from .paged_fused import (check_kernel_inputs, check_pool, dequantize_pool,
                          from_fused_layout)
from .paged_generic import paged_prefill_f32, prefill_uses_generic
from .reference import paged_prefill_reference


def paged_attention_prefill_plain(q, kv_pages, block_tables, context_lens,
                                  *, q_offsets: torch.Tensor,
                                  kv_scales: Optional[torch.Tensor] = None,
                                  scale: Optional[float] = None,
                                  causal: bool = True,
                                  window_size: int = -1,
                                  return_lse: bool = False):
    """The plain PyTorch version of the kernel: gather the pages
    (dequantized for int8 / e4m3 pools: payload times scale, which equals
    the kernel's folding of the scales into s and p up to rounding) and run
    the f32 paged prefill oracle."""
    d_true = q.shape[-1]
    if kv_scales is not None:
        k_pages, v_pages = dequantize_pool(kv_pages, kv_scales, d_true)
    else:
        k_pages, v_pages = from_fused_layout(kv_pages, d_true)
    return paged_prefill_reference(
        q, k_pages, v_pages, block_tables, context_lens, q_offsets,
        scale=scale, causal=causal, window_size=window_size,
        return_lse=return_lse)


def paged_attention_prefill(
    q: torch.Tensor,               # [B, Hq, S_new, D]
    kv_pages: torch.Tensor,        # [P, 2, Hkv, page, Dpad]
    block_tables: torch.Tensor,    # [B, max_pages], -1 = unused
    context_lens: torch.Tensor,    # [B] TOTAL visible cache length
    *,
    q_offsets: Optional[torch.Tensor] = None,   # [B]; default lens - S_new
    kv_scales: Optional[torch.Tensor] = None,   # packed [P, page, 128]
    scale: Optional[float] = None,
    causal: bool = True,
    window_size: int = -1,
    return_lse: bool = False,
):
    """Chunked / multi-turn prefill over a paged cache.  Returns
    [B, Hq, S_new, D] (+ LSE [B, Hq, S_new] f32 with return_lse=True).
    Unquantized pools take q in the pool's dtype (as JAX); quantized pools
    keep q's dtype."""
    batch, hq, s_new, d_true = q.shape
    _, _, hkv, page_size, _ = kv_pages.shape
    check_pool(q, kv_pages, kv_scales)
    if scale is None:
        scale = 1.0 / math.sqrt(d_true)
    window = int(window_size) if window_size and window_size > 0 else -1
    if q_offsets is None:
        q_offsets = context_lens - s_new
    if kv_scales is None:
        q = q.to(kv_pages.dtype)
    if pads_head(q):
        # as the decode: the kernel width above D, the output sliced back
        res = paged_attention_prefill(
            pad_head(q, kernel_head_dim(d_true)), kv_pages, block_tables,
            context_lens, q_offsets=q_offsets, kv_scales=kv_scales,
            scale=scale, causal=causal, window_size=window,
            return_lse=return_lse)
        return unpad_head(res, d_true, return_lse)
    if q.device.type == "cpu":
        return paged_attention_prefill_plain(
            q, kv_pages, block_tables, context_lens, q_offsets=q_offsets,
            kv_scales=kv_scales, scale=scale, causal=causal,
            window_size=window, return_lse=return_lse)
    generic = check_kernel_inputs(q, (kv_pages, kv_scales), "paged-prefill",
                                  rule=prefill_uses_generic)
    q = q.contiguous()
    if kv_scales is None:
        pool, sc_f32 = _build.POOL_NATIVE, 0
    else:
        pool = _build.pool_code(kv_pages.dtype)
        sc_f32 = _build.scale_code(kv_scales.dtype)
    if generic:
        return paged_prefill_f32(
            q, kv_pages, kv_scales, block_tables, context_lens, q_offsets,
            scale=scale, causal=causal, window=window, pool=pool,
            sc_f32=sc_f32, return_lse=return_lse)
    code = _build.dtype_code(q.dtype)
    lib = _build.library()
    dev = q.device
    if q.data_ptr() % 16:  # a TMA tensor map's base
        raise ValueError("q must start on a 16-byte boundary")
    bt = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    lens = context_lens.to(device=dev, dtype=torch.int32).contiguous()
    qoff = q_offsets.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((batch, hq, s_new), dtype=torch.float32, device=dev)
           if return_lse else None)
    err = lib.aule_paged_prefill(
        q.data_ptr(), kv_pages.data_ptr(),
        kv_scales.data_ptr() if kv_scales is not None else None,
        bt.data_ptr(), lens.data_ptr(), qoff.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        batch, hq, hkv, s_new, d_true, page_size, bt.shape[1], float(scale),
        int(bool(causal)), window, code, pool, sc_f32,
        _build.stream_handle(dev))
    _build.check(err, "aule_paged_prefill")
    paged_attention_prefill.launches += 1
    return (out, lse) if return_lse else out


# kernel launches since the last reset (the CPU route does not count)
paged_attention_prefill.launches = 0
