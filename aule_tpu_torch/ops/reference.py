"""Dense-math reference attention: the plain oracles of the port
(counterpart of aule_tpu/ops/reference.py:29-234).

Semantics kept from the JAX package:
  * causal mask top-left aligned, `q_idx >= k_idx` (reference.py:47-55);
  * sliding window: causal `q - k <= W`; bidirectional `|q - k| <= W`;
  * GQA head mapping `h_kv = h_q // (Hq // Hkv)`;
  * NaN-safe fully-masked rows: output 0, LSE `-0.7 * f32max`
    (the kernels' convention, aule_tpu/ops/flash.py:43, 469-473).
Computation is float32 whatever the input dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import DEFAULT_MASK_VALUE


def build_mask(seq_q: int, seq_k: int, causal: bool = False,
               window_size: int = -1, device=None) -> torch.Tensor:
    """Boolean [seq_q, seq_k] mask; True = may attend."""
    q_idx = torch.arange(seq_q, device=device)[:, None]
    k_idx = torch.arange(seq_k, device=device)[None, :]
    mask = torch.ones((seq_q, seq_k), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (q_idx >= k_idx)
    if window_size is not None and window_size > 0:
        mask = mask & ((q_idx - k_idx) <= window_size)
        if not causal:
            mask = mask & ((k_idx - q_idx) <= window_size)
    return mask


def _expand_kv(x: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """Repeat KV heads (axis 1) to match the q heads for GQA."""
    group = num_q_heads // x.shape[1]
    return x if group == 1 else x.repeat_interleave(group, dim=1)


def _masked_softmax_av(scores, mask, vf):
    """(out f32, lse f32) of softmax(scores | mask) @ vf with the NaN-safe
    convention for rows that see nothing."""
    scores = torch.where(mask, scores, torch.full_like(scores,
                                                       DEFAULT_MASK_VALUE))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.matmul(p / l_safe, vf)
    lse = torch.where(l > 0.0, m + torch.log(l_safe),
                      torch.full_like(l, DEFAULT_MASK_VALUE))
    return out, lse[..., 0]


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    window_size: int = -1,
    return_lse: bool = False,
):
    """Dense attention over [B, H, S, D] tensors (GQA, Sq != Sk, causal
    and window masks).  Returns out in q's dtype, plus the natural-log
    LSE [B, Hq, Sq] f32 when asked."""
    hq, seq_q, head_dim = q.shape[1], q.shape[2], q.shape[3]
    seq_k = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    qf = q.float()
    kf = _expand_kv(k.float(), hq)
    vf = _expand_kv(v.float(), hq)
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    mask = build_mask(seq_q, seq_k, causal, window_size,
                      device=q.device)[None, None]
    out, lse = _masked_softmax_av(scores, mask, vf)
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out


def paged_attention_reference(
    q: torch.Tensor,             # [B, Hq, D]
    k_pages: torch.Tensor,       # [Hkv, P, page, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages], -1 = unused
    context_lens: torch.Tensor,  # [B]
    *,
    scale: Optional[float] = None,
    window_size: int = -1,
    return_lse: bool = False,
):
    """Dense oracle for paged decode over head-major pools.  Only the first
    context_lens[b] tokens are visible; with a window only the trailing
    `window_size` (k position p attends iff len - 1 - p < W).  -1 table
    entries clamp to page 0 (their tokens are masked by context_lens)."""
    hq, head_dim = q.shape[1], q.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    kg = _expand_kv(_gather_pages(k_pages, block_tables).float(), hq)
    vg = _expand_kv(_gather_pages(v_pages, block_tables).float(), hq)
    scores = torch.einsum("bhd,bhkd->bhk", q.float(), kg) * scale
    pos = torch.arange(kg.shape[2], device=q.device)[None, :]
    lens = context_lens.long().to(q.device)[:, None]
    valid = pos < lens
    if window_size is not None and window_size > 0:
        valid = valid & ((lens - 1 - pos) < window_size)
    out, lse = _masked_softmax_av(scores[:, :, None, :],
                                  valid[:, None, None, :], vg)
    out = out[:, :, 0].to(q.dtype)
    return (out, lse[:, :, 0]) if return_lse else out


def _gather_pages(pages, block_tables):
    """[Hkv, P, page, D] pages of each sequence's table -> [B, Hkv,
    max_pages*page, D]; -1 entries clamp to page 0."""
    hkv, _, page_size, d = pages.shape
    batch, max_pages = block_tables.shape
    bt = block_tables.long().clamp_min(0).to(pages.device)
    return pages[:, bt].transpose(0, 1).reshape(
        batch, hkv, max_pages * page_size, d)


def paged_prefill_reference(
    q: torch.Tensor,             # [B, Hq, S, D]
    k_pages: torch.Tensor,       # [Hkv, P, page, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages], -1 = unused
    context_lens: torch.Tensor,  # [B] visible cache length
    q_offsets: torch.Tensor,     # [B] absolute position of query 0
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    window_size: int = -1,
    return_lse: bool = False,
):
    """Dense oracle for a chunk of queries over a paged cache.  Query s of
    sequence b sits at q_offsets[b] + s and sees cache positions k <
    context_lens[b], k <= its own when causal, and q - k <= W with a
    window (one-sided also when not causal, as the JAX prefill kernel).
    Rows at or past context_lens[b] see nothing: output 0, LSE
    -0.7 * f32max."""
    hq, seq_q, head_dim = q.shape[1], q.shape[2], q.shape[3]
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    kg = _expand_kv(_gather_pages(k_pages, block_tables).float(), hq)
    vg = _expand_kv(_gather_pages(v_pages, block_tables).float(), hq)
    scores = torch.matmul(q.float(), kg.transpose(-1, -2)) * scale
    seq_k = kg.shape[2]
    lens = context_lens.long().to(q.device)[:, None, None]
    qpos = (q_offsets.long().to(q.device)[:, None, None]
            + torch.arange(seq_q, device=q.device)[None, :, None])
    kpos = torch.arange(seq_k, device=q.device)[None, None, :]
    valid = (kpos < lens) & (qpos < lens)
    if causal:
        valid = valid & (kpos <= qpos)
    if window_size is not None and window_size > 0:
        valid = valid & ((qpos - kpos) <= window_size)
    out, lse = _masked_softmax_av(scores, valid[:, None], vg)
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out
