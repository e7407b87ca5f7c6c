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
