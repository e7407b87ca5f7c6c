"""KV quantization of the PyTorch port against the JAX package.

`quantize_kv` must leave payload bytes and f32 scales identical to
aule_tpu's (exact equality, no tolerance): int8 round-half-even and clip
at +-127, e4m3 clip at +-448 with the subnormal codes flushed, zero rows
with scale 1.  `dequantize_kv` matches at f32 exactness.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from aule_tpu.ops import quant as jq
from aule_tpu_torch.ops import quant as tq
from aule_tpu_torch.utils.testing import cap_cpu_threads

cap_cpu_threads()

DTYPES = {"int8": (jnp.int8, torch.int8),
          "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _payload_bytes(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy().tobytes()
    return np.asarray(x).view(np.uint8).tobytes()


def _cases(rng):
    """Rows that cover zeros, the clip edges, half-way rounding and the
    e4m3 subnormal range (values far below the row's amax)."""
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    x[0, 0] = 0.0                                  # zero row: scale 1
    x[0, 1, :4] = [127.0, -127.0, 63.5, -0.5]      # half-way codes
    x[0, 1, 4:] = 0.25
    x[1, 2] *= 1e-3
    x[1, 2, 0] = 5.0                               # subnormal territory
    x[2, 3] = np.linspace(-448.0, 448.0, 64)
    x[2, 4] = -x[2, 4]
    return x


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_quantize_kv_bytes_identical(name):
    jdt, tdt = DTYPES[name]
    x = _cases(np.random.default_rng(0))
    jp, js = jq.quantize_kv(jnp.asarray(x), jdt)
    tp, ts = tq.quantize_kv(torch.from_numpy(x), tdt)
    assert tp.dtype == tdt and ts.dtype == torch.float32
    assert _payload_bytes(tp) == _payload_bytes(jp)
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert ts[0, 0].item() == 1.0


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_quantize_kv_bf16_input(name):
    """bf16 activations (the engine's) quantize identically too."""
    jdt, tdt = DTYPES[name]
    x = _cases(np.random.default_rng(1)).astype(ml_dtypes.bfloat16)
    jp, js = jq.quantize_kv(jnp.asarray(x), jdt)
    tx = torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    tp, ts = tq.quantize_kv(tx, tdt)
    assert _payload_bytes(tp) == _payload_bytes(jp)
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()


def test_fp8_never_emits_subnormal_codes():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 128)).astype(np.float32) \
        * np.logspace(-6, 0, 128, dtype=np.float32)
    tp, _ = tq.quantize_kv(torch.from_numpy(x), torch.float8_e4m3fn)
    em = tp.view(torch.uint8) & 0x7F
    assert not ((em >= 1) & (em <= 7)).any()
    flushed = tq._flush_e4m3_subnormals(
        torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
            torch.float8_e4m3fn))
    want = jq._flush_e4m3_subnormals(jnp.asarray(
        np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn)))
    assert _payload_bytes(flushed) == _payload_bytes(want)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_dequantize_matches(name):
    jdt, tdt = DTYPES[name]
    x = _cases(np.random.default_rng(3))
    jp, js = jq.quantize_kv(jnp.asarray(x), jdt)
    tp, ts = tq.quantize_kv(torch.from_numpy(x), tdt)
    want = np.asarray(jq.dequantize_kv(jp, js))
    got = tq.dequantize_kv(tp, ts).numpy()
    assert np.array_equal(got, want)


def test_bad_dtype_raises():
    with pytest.raises(ValueError):
        tq.quantize_kv(torch.zeros(2, 8), torch.float16)


# ---- the integer e4m3 decoders (aule_tpu/ops/quant.py:94-190) -------------

CODES = np.arange(256, dtype=np.uint8)
EM = CODES & 0x7F
SUBNORMAL = (EM >= 1) & (EM <= 7)   # never in a pool (quantize_kv flushes)
NAN_CODE = EM == 0x7F               # never in a pool (clipped to +-448)
E4M3_EXPANDERS = {
    "e4m3_expand": lambda m, x: m.e4m3_expand(x),
    "e4m3_expand_f16": lambda m, x: m.e4m3_expand(
        x, jnp.float16 if m is jq else torch.float16),
    "e4m3_expand_bf16": lambda m, x: m.e4m3_expand(
        x, jnp.bfloat16 if m is jq else torch.bfloat16),
    "e4m3_expand_scaled": lambda m, x: m.e4m3_expand_scaled(x),
    "e4m3_expand_scaled_bf16": lambda m, x: m.e4m3_expand_scaled_bf16(x),
}


def _bits(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return a.view(np.uint16)


def _decoded(name):
    xi = jnp.asarray(CODES.view(np.int8))
    want = E4M3_EXPANDERS[name](jq, xi)
    got = E4M3_EXPANDERS[name](tq, torch.from_numpy(CODES.view(np.int8)
                                                    .copy()))
    if isinstance(want, jnp.ndarray) and want.dtype == jnp.bfloat16:
        want = np.asarray(want).view(np.uint16)
        return got.view(torch.int16).numpy().view(np.uint16), want
    return _bits(got), _bits(want)


@pytest.mark.parametrize("name", sorted(E4M3_EXPANDERS))
def test_e4m3_expanders_bit_for_bit(name):
    """Every code a pool can hold (+-0 and the normals) and the NaN codes
    decode to JAX's bits; so do the subnormal codes, except where XLA on
    this CPU flushed the subnormal intermediate of the scaled decoders to
    0 (tests/test_quant.py's contract: exact or flushed), where the port
    gives the IEEE value, e4m3_expand's * 2^-40."""
    got, want = _decoded(name)
    assert np.array_equal(got[~SUBNORMAL], want[~SUBNORMAL])
    magnitude = 0x7FFF if want.dtype == np.uint16 else 0x7FFFFFFF
    flushed = SUBNORMAL & ((want & magnitude) == 0)
    assert np.array_equal(got[SUBNORMAL & ~flushed],
                          want[SUBNORMAL & ~flushed])
    if flushed.any():
        exact = tq.e4m3_expand(torch.from_numpy(CODES.view(np.int8).copy())
                               ).numpy() * np.float32(2.0 ** -40)
        got_f = (torch.from_numpy(got.view(np.int16)).view(torch.bfloat16)
                 .float().numpy() if got.dtype == np.uint16
                 else got.view(np.float32))
        assert np.array_equal(got_f[flushed], exact[flushed])
    assert tq.E4M3_EXPAND_SHIFT == jq.E4M3_EXPAND_SHIFT


def test_e4m3_expand_equals_the_cast():
    """e4m3_expand is the float8_e4m3fn cast on every non-NaN code, signed
    zeros included (the contract of tests/test_quant.py:86-100)."""
    t = torch.from_numpy(CODES.view(np.int8).copy())
    got = tq.e4m3_expand(t).numpy()
    want = t.view(torch.float8_e4m3fn).float().numpy()
    ok = ~NAN_CODE
    assert np.array_equal(got[ok].view(np.uint32), want[ok].view(np.uint32))
