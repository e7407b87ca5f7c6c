"""Quantized KV payloads with per-token scales (counterpart of
aule_tpu/ops/quant.py:28-91).

    x [..., D] -> (payload [..., D] int8 | float8_e4m3fn, scales [...] f32)

with x ~= payload * scales[..., None].  The payload bytes and the f32 scales
are identical to the JAX package's: per-token amax, `scale = amax / qmax`
(1 where amax is 0), int8 `round` (half to even, as `jnp.round`) clipped to
+-127, e4m3 clipped to +-448 then cast, with the 14 subnormal e4m3 codes
flushed to +-0 (the JAX package's fix c4c0db8, kept so that a pool either
package wrote decodes the same in both).

The JAX package's `e4m3_expand*` integer decoders are a workaround for a
TPU without fp8 hardware.  The port decodes with the card's own
conversion (csrc/) and, in plain PyTorch, with `.float()` on the
float8_e4m3fn tensor; both are exact for every code a pool can hold.
"""

from __future__ import annotations

from typing import Tuple

import torch

INT8_MAX = 127.0
FP8_MAX = 448.0  # e4m3 finite max

QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)


def _qmax(dtype) -> float:
    if dtype == torch.int8:
        return INT8_MAX
    if dtype == torch.float8_e4m3fn:
        return FP8_MAX
    raise ValueError(f"unsupported KV quant dtype {dtype} (int8 or "
                     f"float8_e4m3fn)")


def quantize_kv(x: torch.Tensor, dtype=torch.int8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token (last-axis) amax quantization: (payload in `dtype`,
    scales f32 of shape x.shape[:-1])."""
    qmax = _qmax(dtype)
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / qmax)
    scaled = xf / scale[..., None]
    if dtype == torch.int8:
        payload = torch.round(scaled).clamp(-INT8_MAX, INT8_MAX).to(
            torch.int8)
    else:
        payload = _flush_e4m3_subnormals(
            scaled.clamp(-FP8_MAX, FP8_MAX).to(dtype))
    return payload, scale


def _flush_e4m3_subnormals(payload: torch.Tensor) -> torch.Tensor:
    """Flush the subnormal e4m3 byte codes (0x01-0x07, 0x81-0x87) to +-0,
    keeping the sign, on the payload bits."""
    bits = payload.view(torch.uint8)
    em = bits & 0x7F
    keep = (em == 0) | (em >= 8)
    return torch.where(keep, bits, bits & 0x80).view(payload.dtype)


def dequantize_kv(payload: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    return (payload.float() * scale[..., None].float()).to(dtype)
