"""Fused-layout paged KV pool (counterpart of aule_tpu/ops/paged_fused.py).

The pool layout is kept byte for byte, so a pool that aule_tpu built feeds
the port unchanged:

    kv_pages: [num_pages, 2, Hkv, page_size, Dpad]   (axis 1: 0=K, 1=V)

with D padded to a multiple of 128 (`pad_head_dim`).

  * `kv_cache_append_decode_fused` / `kv_cache_append_prefill_fused` write
    new tokens IN PLACE with `index_put_` (JAX rebuilds the pool
    functionally; in place saves a full pool copy per layer per step).
    They return the same tensor, so call sites read like the JAX ones.
  * `paged_attention_fused` follows its tensors: CPU tensors take
    `paged_attention_fused_plain`; CUDA tensors launch the hand-written
    kernel in csrc/paged_decode.cu (replaces the TPU kernel
    `_fused_decode_kernel` in its bf16 pool mode; see the source note
    there), or raise for what it does not take.  Quantized pools
    (`kv_scales`, int8/fp8) come with the next slice and raise here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .reference import paged_attention_reference

NUM_LANES = 128
KERNEL_HEAD_DIM = 128
KERNEL_GROUPS = (1, 2, 4, 8)


def pad_head_dim(d: int) -> int:
    """Pools store head_dim padded to 128 lanes (zeros in the pad lanes
    are exact no-ops in both products)."""
    return -(-d // NUM_LANES) * NUM_LANES


def fused_pool_shape(num_pages: int, hkv: int, page_size: int,
                     head_dim: int):
    return (num_pages, 2, hkv, page_size, pad_head_dim(head_dim))


def _pad_last(x: torch.Tensor, to: int) -> torch.Tensor:
    if x.shape[-1] == to:
        return x
    return F.pad(x, (0, to - x.shape[-1]))


def to_fused_layout(k_pages: torch.Tensor,
                    v_pages: torch.Tensor) -> torch.Tensor:
    """[Hkv, P, page, D] x2 -> [P, 2, Hkv, page, Dpad]."""
    kv = torch.stack([k_pages.transpose(0, 1), v_pages.transpose(0, 1)],
                     dim=1)
    return _pad_last(kv, pad_head_dim(kv.shape[-1])).contiguous()


def from_fused_layout(kv_pages: torch.Tensor,
                      head_dim: Optional[int] = None):
    """[P, 2, Hkv, page, Dpad] -> (k_pages, v_pages) head-major
    [Hkv, P, page, D], sliced back to `head_dim` when given."""
    if head_dim is not None:
        kv_pages = kv_pages[..., :head_dim]
    return kv_pages[:, 0].transpose(0, 1), kv_pages[:, 1].transpose(0, 1)


def _pool_index(kv_pages, phys, slot):
    """index_put_ indices writing [N, 2, Hkv, Dpad] rows at (phys, slot)."""
    hkv = kv_pages.shape[2]
    dev = kv_pages.device
    kv_i = torch.arange(2, device=dev)[None, :, None]
    h_i = torch.arange(hkv, device=dev)[None, None, :]
    return (phys[:, None, None], kv_i, h_i, slot[:, None, None])


def kv_cache_append_decode_fused(
    kv_pages: torch.Tensor,      # [P, 2, Hkv, page, Dpad]
    k_new: torch.Tensor,         # [B, Hkv, D]
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages]
    context_lens: torch.Tensor,  # [B] length BEFORE the append
    kv_scales: Optional[torch.Tensor] = None,
):
    """Write one token per sequence at position context_lens[b], in place.
    Returns (kv_pages, context_lens + 1).  A -1 table entry clamps to the
    scratch page 0; a logical page past the table clamps to its last
    column, as JAX's gather does."""
    if kv_scales is not None:
        raise NotImplementedError(
            "quantized fused pools (kv_scales) come with the next slice")
    page_size = kv_pages.shape[3]
    batch = k_new.shape[0]
    lens = context_lens.to(kv_pages.device).long()
    slot = lens % page_size
    logical = (lens // page_size).clamp(max=block_tables.shape[1] - 1)
    rows = torch.arange(batch, device=kv_pages.device)
    phys = block_tables.to(kv_pages.device)[rows, logical].long().clamp_min(0)
    new = _pad_last(torch.stack([k_new, v_new], dim=1), kv_pages.shape[-1])
    kv_pages.index_put_(_pool_index(kv_pages, phys, slot),
                        new.to(kv_pages.dtype))
    return kv_pages, context_lens + 1


def kv_cache_append_prefill_fused(
    kv_pages: torch.Tensor,      # [P, 2, Hkv, page, Dpad]
    k_new: torch.Tensor,         # [B, Hkv, S, D]
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages]
    context_lens: torch.Tensor,  # [B] tokens already in the pool
    seq_lens: torch.Tensor,      # [B] valid tokens of the S
    kv_scales: Optional[torch.Tensor] = None,
):
    """Write tokens s < seq_lens[b] at positions context_lens[b] + s, in
    place; padding tokens (s >= seq_lens[b]) leave the pool as it was
    (the masked write of aule_tpu/ops/paged.py:525-544).  Returns
    (kv_pages, context_lens + seq_lens)."""
    if kv_scales is not None:
        raise NotImplementedError(
            "quantized fused pools (kv_scales) come with the next slice")
    batch, hkv, seq, d = k_new.shape
    page_size = kv_pages.shape[3]
    dev = kv_pages.device
    ar = torch.arange(seq, device=dev)
    pos = context_lens.to(dev).long()[:, None] + ar[None, :]     # [B, S]
    valid = ar[None, :] < seq_lens.to(dev).long()[:, None]
    # padded positions may run past the table: clamp like JAX's gather
    logical = (pos // page_size).clamp(max=block_tables.shape[1] - 1)
    phys = torch.gather(block_tables.to(dev).long(), 1, logical).clamp_min(0)
    # [B, 2, Hkv, S, D] -> [B*S, 2, Hkv, Dpad]
    new = torch.stack([k_new, v_new], dim=1).movedim(3, 1).reshape(
        batch * seq, 2, hkv, d)
    new = _pad_last(new, kv_pages.shape[-1]).to(kv_pages.dtype)
    keep = valid.reshape(-1)
    phys_f = phys.reshape(-1)[keep]
    slot_f = (pos % page_size).reshape(-1)[keep]
    kv_pages.index_put_(_pool_index(kv_pages, phys_f, slot_f), new[keep])
    return kv_pages, context_lens + seq_lens


def paged_attention_fused_plain(q, kv_pages, block_tables, context_lens, *,
                                scale: Optional[float] = None,
                                window_size: int = -1,
                                return_lse: bool = False):
    """The plain PyTorch version of the kernel: gather the pages densely
    and run the f32 paged oracle."""
    d_true = q.shape[-1]
    k_pages, v_pages = from_fused_layout(kv_pages, d_true)
    return paged_attention_reference(
        q, k_pages, v_pages, block_tables, context_lens, scale=scale,
        window_size=window_size, return_lse=return_lse)


def paged_attention_fused(
    q: torch.Tensor,              # [B, Hq, D]
    kv_pages: torch.Tensor,       # [P, 2, Hkv, page, Dpad]
    block_tables: torch.Tensor,   # [B, max_pages] int32, -1 = unused
    context_lens: torch.Tensor,   # [B] int32
    *,
    kv_scales: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window_size: int = -1,
    return_lse: bool = False,
):
    """Decode attention of one query token per sequence over the fused
    pool.  Returns out [B, Hq, D] (the pool's dtype) and, with return_lse, the
    natural-log LSE [B, Hq] f32."""
    batch, hq, d_true = q.shape
    _, two, hkv, page_size, d = kv_pages.shape
    if two != 2 or d != pad_head_dim(d_true):
        raise ValueError(
            f"kv_pages {tuple(kv_pages.shape)} is not a fused pool for "
            f"head_dim {d_true} (see fused_pool_shape)")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if kv_scales is not None:
        raise NotImplementedError(
            "quantized fused decode (int8/fp8 pools with kv_scales) comes "
            "with the next slice")
    if not kv_pages.is_floating_point():
        raise ValueError("integer KV pools need kv_scales (see "
                         "aule_tpu/ops/quant.quantize_kv)")
    if scale is None:
        scale = 1.0 / math.sqrt(d_true)
    window = int(window_size) if window_size and window_size > 0 else -1
    q = q.to(kv_pages.dtype)  # as JAX: q joins the pool dtype
    if q.device.type == "cpu":
        return paged_attention_fused_plain(
            q, kv_pages, block_tables, context_lens, scale=scale,
            window_size=window, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if d_true != KERNEL_HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA paged-decode kernel takes D={KERNEL_HEAD_DIM} "
            f"(got {d_true}); other head dims come with the GPT-2 slice")
    if hq // hkv not in KERNEL_GROUPS:
        raise NotImplementedError(
            f"the CUDA paged-decode kernel takes GQA groups "
            f"{KERNEL_GROUPS} (got {hq // hkv})")
    code = _build.dtype_code(kv_pages.dtype)
    if not kv_pages.is_contiguous():
        raise ValueError("kv_pages must be contiguous")
    lib = _build.library()
    dev = q.device
    q = q.contiguous()
    bt = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    lens = context_lens.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((batch, hq), dtype=torch.float32, device=dev)
           if return_lse else None)
    err = lib.aule_paged_decode(
        q.data_ptr(), kv_pages.data_ptr(), bt.data_ptr(), lens.data_ptr(),
        out.data_ptr(), lse.data_ptr() if lse is not None else None,
        batch, hq, hkv, page_size, bt.shape[1], float(scale), window, code,
        _build.stream_handle(dev))
    _build.check(err, "aule_paged_decode")
    paged_attention_fused.launches += 1
    return (out, lse) if return_lse else out


# kernel launches since the last reset (the CPU route does not count)
paged_attention_fused.launches = 0
