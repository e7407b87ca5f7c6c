"""Dense-math reference attention: the plain oracles of the port
(counterpart of aule_tpu/ops/reference.py:29-234).

Semantics kept from the JAX package:
  * causal mask top-left aligned, `q_idx >= k_idx` (reference.py:47-55);
  * sliding window: causal `q - k <= W`; bidirectional `|q - k| <= W`;
  * GQA head mapping `h_kv = h_q // (Hq // Hkv)`;
  * NaN-safe fully-masked rows: output 0, LSE `-0.7 * f32max`
    (the kernels' convention, aule_tpu/ops/flash.py:43, 469-473);
  * fused RoPE (half-split) on q at positions q_offset .. and on k at
    0 .., and a `kv_len` that masks the keys at or past it.
Computation is float32 whatever the input dtype.  `attention_reference_
numpy` is the oracle that never goes through torch (float64 NumPy).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_MASK_VALUE
from .rope import apply_rope

# the JAX oracle's masked score (reference.py:29): half f32's min, so that
# a fully masked row's shift stays finite
NEG_INF = float(np.finfo(np.float32).min) * 0.5


def build_mask(seq_q: int, seq_k: int, causal: bool = False,
               window_size: int = -1, device=None,
               q_offset: int = 0) -> torch.Tensor:
    """Boolean [seq_q, seq_k] mask; True = may attend.  Query i sits at
    position i + q_offset."""
    q_idx = torch.arange(seq_q, device=device)[:, None] + q_offset
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
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    q_offset: int = 0,
    return_lse: bool = False,
    kv_len=None,
):
    """Dense attention over [B, H, S, D] tensors (GQA, Sq != Sk, causal
    and window masks; RoPE from [S, D/2] tables on q at positions
    q_offset .. and on k at 0 ..; only the first `kv_len` keys attend, an
    int or a tensor that is never read on the host).  Returns out in q's
    dtype, plus the natural-log LSE [B, Hq, Sq] f32 when asked."""
    hq, seq_q, head_dim = q.shape[1], q.shape[2], q.shape[3]
    seq_k = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    qf = q.float()
    kf = k.float()
    if rope_cos is not None:
        cos = rope_cos.to(device=q.device, dtype=torch.float32)
        sin = rope_sin.to(device=q.device, dtype=torch.float32)
        qf = apply_rope(qf, cos, sin, positions=torch.arange(
            seq_q, device=q.device) + q_offset)
        kf = apply_rope(kf, cos, sin)
    kf = _expand_kv(kf, hq)
    vf = _expand_kv(v.float(), hq)
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    mask = build_mask(seq_q, seq_k, causal, window_size, device=q.device,
                      q_offset=q_offset)
    if kv_len is not None:
        live = torch.as_tensor(kv_len, device=q.device).reshape(())
        mask = mask & (torch.arange(seq_k, device=q.device) < live)[None]
    out, lse = _masked_softmax_av(scores, mask[None, None], vf)
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out


def _build_mask_numpy(seq_q, seq_k, causal, window_size, q_offset):
    q_idx = np.arange(seq_q)[:, None] + q_offset
    k_idx = np.arange(seq_k)[None, :]
    mask = np.ones((seq_q, seq_k), dtype=bool)
    if causal:
        mask &= q_idx >= k_idx
    if window_size is not None and window_size > 0:
        mask &= (q_idx - k_idx) <= window_size
        if not causal:
            mask &= (k_idx - q_idx) <= window_size
    return mask


def attention_reference_numpy(
    q: np.ndarray,
    k: np.ndarray,
    v: np.ndarray,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    window_size: int = -1,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """The NumPy oracle (aule_tpu/ops/reference.py:139-180), in float64,
    never through torch: numpy arrays [B, H, S, D] in, out in q's dtype
    (and the LSE [B, Hq, Sq] f32, -0.7 * f32max for a row that sees
    nothing) back."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    group = hq // hkv
    kf = np.repeat(k.astype(np.float64), group, axis=1)
    vf = np.repeat(v.astype(np.float64), group, axis=1)
    scores = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kf) * scale
    mask = _build_mask_numpy(sq, sk, causal, window_size, q_offset)
    scores = np.where(mask[None, None], scores, -np.inf)
    m = np.max(scores, axis=-1, keepdims=True)
    m_safe = np.where(np.isfinite(m), m, 0.0)
    p = np.where(mask[None, None], np.exp(scores - m_safe), 0.0)
    l = np.sum(p, axis=-1, keepdims=True)
    l_safe = np.where(l == 0.0, 1.0, l)
    out = np.einsum("bhqk,bhkd->bhqd", p / l_safe, vf).astype(q.dtype)
    if not return_lse:
        return out
    lse = np.where(l[..., 0] > 0.0, m_safe[..., 0] + np.log(l_safe[..., 0]),
                   DEFAULT_MASK_VALUE)
    return out, lse.astype(np.float32)


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
