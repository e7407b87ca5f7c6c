"""Gravity attention: top-k sparse attention over the keys of largest
magnitude (counterpart of aule_tpu/ops/topk.py:30-145).

The JAX package has no Pallas kernel here (`lax.top_k` / `argsort`, a
gather and an online softmax in XLA), so plain PyTorch is the whole port:
the same selection (stable descending sort of |k|^2 per (batch, kv head),
ties to the lower index, as `lax.top_k`), the masks at the keys' ORIGINAL
positions, RoPE by original position, and the selected keys walked in
chunks with an online softmax, so memory is O(Sq * chunk).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .rope import apply_rope

# masked-score fill of the online softmax (aule_tpu/ops/reference.py:29)
NEG_INF = float(torch.finfo(torch.float32).min) * 0.5


def spatial_sort(k: torch.Tensor, descending: bool = True) -> torch.Tensor:
    """Indices of the keys sorted by squared magnitude per (batch, head):
    k [B, H, S, D] -> int32 [B, H, S]."""
    mag = k.float().square().sum(-1)
    order = torch.argsort(-mag if descending else mag, dim=-1, stable=True)
    return order.to(torch.int32)


def gravity_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    max_attend: int,
    indices: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    window_size: int = -1,
    rope_cos=None,
    rope_sin=None,
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    """Attention over the top `max_attend` keys by magnitude (or the first
    `max_attend` of `indices`, e.g. from `spatial_sort`); causal and window
    masks compare ORIGINAL positions, RoPE rotates by them; the selected
    keys are walked `chunk_size` (default 512) at a time with an online
    softmax.  Returns [B, Hq, Sq, D] in q's dtype."""
    batch, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    max_attend = min(max_attend, sk)
    out_dtype = q.dtype
    if rope_cos is not None:
        q = apply_rope(q.float(), rope_cos.float(), rope_sin.float())
        k = apply_rope(k.float(), rope_cos.float(), rope_sin.float())

    if indices is None:
        sel = spatial_sort(k)[..., :max_attend]              # [B, Hkv, A]
    else:
        sel = indices[..., :max_attend]
    sel = sel.long().to(q.device)

    chunk = min(max_attend, int(chunk_size) if chunk_size else 512)
    n_chunks = -(-max_attend // chunk)
    pad = n_chunks * chunk - max_attend
    if pad:
        sel = torch.nn.functional.pad(sel, (0, pad))

    rows = group * sq  # the GQA group folds into q rows per kv head
    qf = q.float().reshape(batch, hkv, rows, d)
    q_pos = (torch.arange(rows, device=q.device) % sq)[None, None, :, None]
    m = torch.full((batch, hkv, rows, 1), NEG_INF, device=q.device)
    l = torch.zeros((batch, hkv, rows, 1), device=q.device)
    acc = torch.zeros((batch, hkv, rows, d), device=q.device)
    for c in range(n_chunks):
        sel_c = sel[..., c * chunk:(c + 1) * chunk]          # [B, Hkv, c]
        idx = sel_c[..., None].expand(-1, -1, -1, d)
        kg = torch.gather(k, 2, idx).float()
        vg = torch.gather(v, 2, idx).float()
        s = torch.matmul(qf, kg.transpose(-1, -2)) * scale
        k_pos = sel_c[:, :, None, :]                         # original index
        valid = (c * chunk + torch.arange(chunk, device=q.device)
                 ) < max_attend
        mask = valid[None, None, None, :].expand(s.shape)
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window_size is not None and window_size > 0:
            mask = mask & ((q_pos - k_pos) <= window_size)
            if not causal:
                mask = mask & ((k_pos - q_pos) <= window_size)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        shift = torch.where(m_new > NEG_INF * 0.5, m_new,
                            torch.zeros_like(m_new))
        p = torch.where(mask, torch.exp(s - shift), torch.zeros_like(s))
        alpha = torch.exp(torch.where(m > NEG_INF * 0.5, m, shift) - shift)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vg)
        m = m_new
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(batch, hq, sq, d).to(out_dtype)
