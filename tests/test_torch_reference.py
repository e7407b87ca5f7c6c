"""The port's oracles against the JAX package's: `attention_reference`
with RoPE, q_offset and kv_len, and the NumPy `attention_reference_numpy`
(f32 2e-5; the NumPy oracles in float64, 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.ops import reference as jref
from aule_tpu.ops.rope import precompute_rope_frequencies as jax_tables
from aule_tpu_torch.ops import reference as tref
from aule_tpu_torch.ops.rope import precompute_rope_frequencies
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()


def _inputs(b, hq, hkv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))


NUMPY_CASES = {  # id: (B, Hq, Hkv, Sq, Sk, causal, window, q_offset)
    "causal_gqa": (1, 4, 2, 33, 33, True, -1, 0),
    "cross_window": (2, 2, 1, 20, 50, False, 7, 0),
    "decode_offset": (1, 4, 4, 5, 40, True, -1, 35),
    "offset_window": (1, 2, 2, 8, 64, True, 10, 56),
}


@pytest.mark.parametrize("case", list(NUMPY_CASES))
def test_numpy_oracle(case):
    b, hq, hkv, sq, sk, causal, window, off = NUMPY_CASES[case]
    q, k, v = _inputs(b, hq, hkv, sq, sk, 64, seed=sq + sk)
    kw = dict(causal=causal, window_size=window, q_offset=off,
              return_lse=True)
    jo, jl = jref.attention_reference_numpy(q, k, v, **kw)
    to, tl = tref.attention_reference_numpy(q, k, v, **kw)
    assert isinstance(to, np.ndarray) and to.dtype == np.float32
    assert_close(to, jo, 0, 1e-6, "out")
    assert_close(tl, jl, 0, 1e-6, "lse")


def test_tables_match_jax():
    got = precompute_rope_frequencies(48, 64, 500000.0)
    want = jax_tables(48, 64, 500000.0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert_close(g.numpy(), np.asarray(w), 0, 1e-6, "tables")


TORCH_CASES = {  # id: (Sq, Sk, causal, window, rope, q_offset, kv_len)
    "rope": (32, 32, True, -1, True, 0, None),
    "rope_offset": (4, 40, True, -1, True, 36, None),
    "kv_len": (6, 64, False, -1, False, 0, 41),
    "all": (16, 64, True, 20, True, 48, 60),
}


@pytest.mark.parametrize("case", list(TORCH_CASES))
def test_attention_reference_new_arguments(case):
    sq, sk, causal, window, rope, off, kv_len = TORCH_CASES[case]
    q, k, v = _inputs(1, 4, 2, sq, sk, 64, seed=sq * sk)
    cos, sin = precompute_rope_frequencies(64, 64)
    kw = dict(causal=causal, window_size=window, q_offset=off,
              return_lse=True)
    jkw, tkw = dict(kw), dict(kw)
    if rope:
        jkw.update(rope_cos=cos.numpy(), rope_sin=sin.numpy())
        tkw.update(rope_cos=cos, rope_sin=sin)
    if kv_len is not None:
        jkw["kv_len"] = jnp.int32(kv_len)
        tkw["kv_len"] = torch.tensor(kv_len)
    jo, jl = jref.attention_reference(*(jnp.asarray(x) for x in (q, k, v)),
                                      **jkw)
    to, tl = tref.attention_reference(*(torch.from_numpy(x)
                                        for x in (q, k, v)), **tkw)
    assert_close(to, np.asarray(jo), 0, 2e-5, "out")
    # a row that sees nothing: JAX's oracle gives NEG_INF = f32min/2 where
    # the port (and JAX's kernels) give -0.7 f32max
    seen = np.asarray(jl) > jref.NEG_INF * 0.5
    assert_close(tl.numpy()[seen], np.asarray(jl)[seen], 0, 1e-4, "lse")
    assert (tl.numpy()[~seen] < -1e38).all()


def test_build_mask_offset():
    got = tref.build_mask(5, 12, True, 3, q_offset=7).numpy()
    want = jref.build_mask(5, 12, True, 3, q_offset=7)
    assert (got == want).all()
