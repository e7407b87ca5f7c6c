"""Quantized KV payloads with per-token scales (counterpart of
aule_tpu/ops/quant.py:28-91).

    x [..., D] -> (payload [..., D] int8 | float8_e4m3fn, scales [...] f32)

with x ~= payload * scales[..., None].  The payload bytes and the f32 scales
are identical to the JAX package's: per-token amax, `scale = amax / qmax`
(1 where amax is 0), int8 `round` (half to even, as `jnp.round`) clipped to
+-127, e4m3 clipped to +-448 then cast, with the 14 subnormal e4m3 codes
flushed to +-0 (the JAX package's fix c4c0db8, kept so that a pool either
package wrote decodes the same in both).

The JAX package's `e4m3_expand*` integer decoders (quant.py:94-190) are a
workaround for a TPU without fp8 hardware.  They are here too, as plain
integer and bit operations on int8 tensors with the JAX package's results
bit for bit, for callers of that API; the port's kernels decode with the
card's own conversion (csrc/) and its plain versions with `.float()` on
the float8_e4m3fn tensor, both exact for every code a pool can hold.
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


def e4m3_expand(x_i8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """float8_e4m3fn payloads viewed as int8, decoded with integer ops:
    for normals the f32 bits are ((x & 0x7f) << 20) + (120 << 23) (the
    exponent and mantissa moved into place and the bias changed from 7
    to 127); subnormals (exponent field 0) are m * 2^-9; the sign bit
    negates.  The NaN codes 0x7f / 0xff decode to +-480 (a pool never
    holds them)."""
    xi = x_i8.to(torch.int32)
    em = xi & 0x7F
    mag = ((em << 20) + (120 << 23)).view(torch.float32)
    sub = (em & 0x7).to(torch.float32) * (2.0 ** -9)
    mag = torch.where(em < 8, sub, mag)
    return torch.where(xi < 0, -mag, mag).to(dtype)


# e4m3_expand_scaled* return value * 2^-E4M3_EXPAND_SHIFT; a caller folds
# 2^+shift into its scale factors
E4M3_EXPAND_SHIFT = 40


def e4m3_expand_scaled(x_i8: torch.Tensor, dtype=torch.float32
                       ) -> torch.Tensor:
    """value * 2^-40 without selects: the sign bit at bit 31 and the
    exponent and mantissa at bit 20 read as 2^(e-127) (1 + m/8) for
    normals, and one multiply by 2^80 makes that value * 2^-40 exactly.
    The subnormal codes land on f32 subnormals before the multiply: exact
    under IEEE arithmetic (this CPU, the card), flushed to +-0 where
    subnormals are (the TPU's vector unit); `quantize_kv` never writes
    them."""
    xi = x_i8.to(torch.int32)
    sign = torch.where(xi < 0, torch.tensor(-2 ** 31, dtype=torch.int32,
                                            device=xi.device),
                       torch.zeros((), dtype=torch.int32, device=xi.device))
    bits = sign | ((xi & 0x7F) << 20)
    return (bits.view(torch.float32)
            * (2.0 ** (120 - E4M3_EXPAND_SHIFT))).to(dtype)


def e4m3_expand_scaled_bf16(x_i8: torch.Tensor) -> torch.Tensor:
    """value * 2^-40 as bfloat16 by moving the bits: e4m3 embeds exactly
    in bf16, so bits (s << 15) | (em << 4) read as value * 2^-120 for
    normals and one bf16 multiply by 2^80 rescales them without rounding.
    Zero codes give +-0; subnormal codes bf16 subnormals (exact under IEEE
    arithmetic, as e4m3_expand_scaled); the NaN codes a finite 480 *
    2^-40."""
    xi = x_i8.to(torch.int32)
    bits = torch.where(xi < 0, 0x8000, 0) | ((xi & 0x7F) << 4)
    # bits < 2^16: their low 16 as int16 (two's complement) are the bf16
    bits16 = (bits - ((bits >> 15) << 16)).to(torch.int16)
    return bits16.view(torch.bfloat16) * torch.tensor(
        2.0 ** (120 - E4M3_EXPAND_SHIFT), dtype=torch.bfloat16,
        device=xi.device)
