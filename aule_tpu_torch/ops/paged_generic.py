"""Launchers of the paged kernels for f32 q at D 64, 128 or 256, what the
16-bit paged kernels do not take (csrc/paged_decode.cu runs the 16-bit
decode and csrc/paged_prefill.cu the 16-bit prefill at every head dim):
the decode on csrc/paged_generic.cuh (FFMA; its entry point in
csrc/paged_generic.cu) and the prefill on csrc/paged_prefill_f32.cu
(3xTF32 on the tensor cores).

The public wrappers route to them by one rule each: `paged_attention_fused`
and the split `paged_attention` (ops/paged_fused.py, ops/paged.py) launch
`paged_generic_decode` whenever `uses_generic_kernels(q)`, and
`paged_attention_prefill` (ops/paged_prefill.py) launches
`paged_prefill_f32` whenever `prefill_uses_generic(q)`; the wrappers'
own counters count only the tensor-core kernels.  These functions take
CUDA tensors that the wrappers have checked; each counts its launches in
`.launches`.  The plain versions are the wrappers' own.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, decode_split
# the paged kernels' head dims, the flash ones' (every family takes 64, 128
# and 256)
from .flash import GENERIC_HEAD_DIMS

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the decode kernel's pool layouts
FUSED, SPLIT = 0, 1


def _check_kernel_type(q: torch.Tensor) -> None:
    d = q.shape[-1]
    if q.dtype not in KERNEL_DTYPES or d not in GENERIC_HEAD_DIMS:
        raise ValueError(
            f"the CUDA paged kernels take f32, bf16 and f16 at D in "
            f"{GENERIC_HEAD_DIMS}; got {q.dtype} D={d}")


def uses_generic_kernels(q: torch.Tensor) -> bool:
    """Whether the card runs q's decode on the generic paged decode (f32 at
    D 64/128/256) rather than the tensor-core one (csrc/paged_decode.cu:
    bf16/f16 at D 64/128/256).  Raises ValueError for any other type or
    head dim."""
    _check_kernel_type(q)
    return q.dtype == torch.float32


def prefill_uses_generic(q: torch.Tensor) -> bool:
    """Whether the card runs q's prefill on csrc/paged_prefill_f32.cu (f32
    at D 64/128/256) rather than csrc/paged_prefill.cu (bf16/f16 at D
    64/128/256).  Raises ValueError for any other type or head dim."""
    _check_kernel_type(q)
    return q.dtype == torch.float32


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def paged_generic_decode(q, q_in, qf, kv, v, sc, vs, block_tables,
                         context_lens, *, num_pages: int, page_size: int,
                         scale: float, window: int, pool: int, sc_f32: int,
                         layout: int, return_lse: bool):
    """One launch of the decode kernel.  q [B, Hq, D] gives the out type
    and shape; q_in is what the kernel reads (q, or its per-row int8 codes
    with qf [B, Hq] f32 in the int8 dot-product mode).  layout FUSED: kv is
    the fused pool and sc its packed scale tile; SPLIT: kv, v the split
    pools and sc, vs their f32 scales (None for native pools).  The split
    count comes from the shapes only (ops/decode_split.py, at the kernel's
    `generic_blocks_per_sm`), so both layouts give the same bits on the
    same pools."""
    batch, hq, d = q.shape
    hkv = kv.shape[2] if layout == FUSED else kv.shape[0]
    dev = q.device
    max_pages = block_tables.shape[1]
    rows = decode_split.generic_tile_rows(hq // hkv)
    nsplit, ws, cnt = decode_split.launch_plan(
        batch, hq, hkv, max_pages * page_size, window, dev, head_dim=d,
        tile_rows=rows,
        blocks_per_sm=decode_split.generic_blocks_per_sm(
            d, pool != _build.POOL_NATIVE))
    bt = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    lens = context_lens.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((batch, hq), dtype=torch.float32, device=dev)
           if return_lse else None)
    err = _build.library().aule_paged_generic_decode(
        q_in.data_ptr(), _ptr(qf), kv.data_ptr(), _ptr(v), _ptr(sc),
        _ptr(vs), bt.data_ptr(), lens.data_ptr(), out.data_ptr(), _ptr(lse),
        _ptr(ws), _ptr(cnt), batch, hq, hkv, num_pages, page_size,
        max_pages, d, float(scale), window, nsplit, rows,
        _build.dtype_code(q.dtype, f32=True), pool, sc_f32, layout,
        _build.stream_handle(dev))
    _build.check(err, "aule_paged_generic_decode")
    paged_generic_decode.launches += 1
    return (out, lse) if return_lse else out


def paged_prefill_f32(q, kv_pages, kv_scales, block_tables,
                          context_lens, q_offsets, *, scale: float,
                          causal: bool, window: int, pool: int, sc_f32: int,
                          return_lse: bool):
    """One launch of csrc/paged_prefill_f32.cu's prefill over a fused pool
    (f32, int8 or e4m3 with scales): q [B, Hq, S, D] f32 contiguous;
    context_lens the total visible cache length and q_offsets the position
    of query 0, per sequence.  Raises on CPU tensors (the wrapper's plain
    version is `paged_attention_prefill_plain`)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    batch, hq, s_new, d = q.shape
    hkv, page_size = kv_pages.shape[2], kv_pages.shape[3]
    dev = q.device
    bt = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    lens = context_lens.to(device=dev, dtype=torch.int32).contiguous()
    qoff = q_offsets.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((batch, hq, s_new), dtype=torch.float32, device=dev)
           if return_lse else None)
    err = _build.library().aule_paged_prefill_f32(
        q.data_ptr(), kv_pages.data_ptr(), _ptr(kv_scales), bt.data_ptr(),
        lens.data_ptr(), qoff.data_ptr(), out.data_ptr(), _ptr(lse), batch,
        hq, hkv, s_new, page_size, bt.shape[1], d, float(scale),
        int(bool(causal)), window, _build.dtype_code(q.dtype, f32=True),
        pool, sc_f32, _build.stream_handle(dev))
    _build.check(err, "aule_paged_prefill_f32")
    paged_prefill_f32.launches += 1
    return (out, lse) if return_lse else out


# kernel launches since the last reset
paged_generic_decode.launches = 0
paged_prefill_f32.launches = 0
