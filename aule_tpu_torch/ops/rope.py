"""Rotary position embeddings, half-split convention (aule_tpu/ops/rope.py).

q1' = q1*cos - q2*sin on the first D/2 lanes, q2' = q1*sin + q2*cos on the
second; the cos/sin tables are f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def precompute_rope_frequencies(
    seq_len: int,
    head_dim: int,
    base: float = 10000.0,
    dtype=torch.float32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [seq_len, head_dim // 2], computed in f32
    and cast to `dtype` (JAX's signature, plus the device to make them
    on); theta_i = base^(-i / (d/2)), angle = pos * theta_i."""
    half = head_dim // 2
    freqs = 1.0 / (base ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))
    positions = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = positions[:, None] * freqs[None, :]
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rotate `x [..., S, D]` by position; `positions` ([..., S] or [S])
    selects table rows, default 0..S-1.  Computes in the promoted type of
    x and the f32 tables, then casts back to x's dtype (as jnp does)."""
    seq_len = x.shape[-2]
    if positions is None:
        c, s = cos[:seq_len], sin[:seq_len]
    else:
        c, s = cos[positions], sin[positions]
    while c.dim() < x.dim():
        c, s = c[None], s[None]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)
