"""On-device token samplers (counterpart of aule_tpu/serving/sampling.py).

A sampler takes (logits [..., V], generator) and returns int64 tokens
shaped like the leading dims.  All randomness comes from the explicit
`torch.Generator` (it must live on the logits' device), so a run is
reproducible from its seed.  JAX's random bits cannot be matched: the
port's sampling is held to reproducibility and to `temperature -> 0 ==
greedy`, not to JAX's tokens.  `top_k` and `top_p` come with the serving-
edges slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Sampler = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def _gumbel_argmax(scaled: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """A draw from softmax(scaled) along the last axis (Gumbel-max)."""
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    e = -torch.log(u.clamp_(min=tiny))          # Exp(1) draws
    return torch.argmax(scaled - torch.log(e.clamp_(min=tiny)), dim=-1)


def greedy() -> Sampler:
    def sample(logits, generator=None):
        del generator
        return torch.argmax(logits, dim=-1)

    return sample


def temperature(t: float = 1.0) -> Sampler:
    if t <= 0:
        return greedy()

    def sample(logits, generator):
        return _gumbel_argmax(logits.float() / t, generator)

    return sample


def sample_rows(logits: torch.Tensor, temps: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """Per-row temperatures [B] over logits [B, V]: rows with temperature
    0 take the argmax, the others sample at their temperature."""
    scaled = logits.float() / temps.clamp(min=1e-6)[:, None]
    sampled = _gumbel_argmax(scaled, generator)
    return torch.where(temps > 0.0, sampled, torch.argmax(logits, dim=-1))
