"""On-device token samplers (counterpart of aule_tpu/serving/sampling.py).

A sampler takes (logits [..., V], generator) and returns int64 tokens
shaped like the leading dims.  All randomness comes from the explicit
`torch.Generator` (it must live on the logits' device), so a run is
reproducible from its seed.  JAX's random bits cannot be matched: the
port's sampling is held to reproducibility, to its restrictions' masks
(equal to JAX's, ties included), to draws inside the kept set and to
`temperature -> 0 == greedy`, not to JAX's tokens.

  greedy()                 argmax (deterministic; the engine's default)
  temperature(t)           softmax sample at temperature t
  top_k(k, t=1.0)          restricted to the k highest logits
  top_p(p, t=1.0)          nucleus: the smallest prefix with mass >= p
  make_engine_sampler(s)   a (logits, generator) sampler as a logits ->
                           token callable with a seeded generator of its
                           own (the engine's `sample=`)
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Sampler = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def _gumbel_argmax(scaled: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """A draw from softmax(scaled) along the last axis (Gumbel-max); -inf
    entries are never drawn."""
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


def top_k(k: int, t: float = 1.0) -> Sampler:
    """Sample among the k highest logits at temperature t; every logit
    equal to the k-th stays in (JAX's `lf >= kth`)."""
    if k <= 0:
        raise ValueError("top_k needs k >= 1")

    def sample(logits, generator):
        lf = logits.float()
        kth = torch.topk(lf, k, dim=-1).values[..., -1:]
        masked = torch.where(lf >= kth, lf, -torch.inf)
        return _gumbel_argmax(masked / max(t, 1e-6), generator)

    return sample


def top_p(p: float, t: float = 1.0) -> Sampler:
    """Nucleus sampling at temperature t: the smallest prefix of the sorted
    softmax with mass >= p (always at least one token); every logit equal
    to the cutoff stays in."""
    if not 0.0 < p <= 1.0:
        raise ValueError("top_p needs 0 < p <= 1")

    def sample(logits, generator):
        lf = logits.float() / max(t, 1e-6)
        srt = torch.sort(lf, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
        idx = (cum < p).sum(dim=-1, keepdim=True).clamp_(max=lf.shape[-1] - 1)
        cutoff = torch.gather(srt, -1, idx)
        return _gumbel_argmax(torch.where(lf >= cutoff, lf, -torch.inf),
                              generator)

    return sample


def make_engine_sampler(sampler: Sampler, seed: int = 0
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A (logits, generator) sampler as a logits -> token callable, drawing
    from a generator of its own seeded with `seed` (made on the logits'
    device at the first call), for the engine's `sample=`."""
    gens = {}

    def fn(logits):
        dev = logits.device
        if dev not in gens:
            gens[dev] = torch.Generator(device=dev).manual_seed(seed)
        return sampler(logits, gens[dev])

    return fn


def restrict_rows(scaled: torch.Tensor, tks: Optional[torch.Tensor],
                  tps: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-row top-k / top-p on temperature-scaled logits [B, V] (JAX
    engine.py:53-76).  tks int [B] (0 = off) keeps the k highest logits of
    a row; tps f32 [B] (0 = off) keeps the smallest prefix of its softmax
    with mass >= p (always >= 1 token).  One descending sort serves both
    cutoffs; a logit equal to a cutoff stays in; the rest become -inf."""
    v = scaled.shape[-1]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    ninf = torch.full(scaled.shape[:-1] + (1,), -torch.inf,
                      dtype=torch.float32, device=scaled.device)
    cutoff = ninf
    if tks is not None:
        k_idx = (tks.long()[:, None] - 1).clamp(0, v - 1)
        k_cut = torch.gather(srt, -1, k_idx)
        cutoff = torch.maximum(cutoff, torch.where(tks[:, None] > 0, k_cut,
                                                   ninf))
    if tps is not None:
        cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
        p_idx = (cum < tps[:, None]).sum(dim=-1, keepdim=True)
        p_cut = torch.gather(srt, -1, p_idx.clamp(0, v - 1))
        cutoff = torch.maximum(cutoff, torch.where(tps[:, None] > 0.0, p_cut,
                                                   ninf))
    return torch.where(scaled >= cutoff, scaled, -torch.inf)


def sample_rows(logits: torch.Tensor, temps: torch.Tensor,
                generator: torch.Generator,
                tks: Optional[torch.Tensor] = None,
                tps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row temperatures [B] over logits [B, V]: rows with temperature
    0 take the argmax, the others sample at their temperature, restricted
    by their top-k `tks` / top-p `tps` (restrict_rows; None when no row
    restricts, so the vocabulary sort is skipped)."""
    scaled = logits.float() / temps.clamp(min=1e-6)[:, None]
    if tks is not None or tps is not None:
        scaled = restrict_rows(scaled, tks, tps)
    sampled = _gumbel_argmax(scaled, generator)
    return torch.where(temps > 0.0, sampled, torch.argmax(logits, dim=-1))
