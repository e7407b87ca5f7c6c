"""Gravity attention and spatial sort of the port against the JAX
package's (aule_tpu/ops/topk.py, plain XLA there, plain PyTorch here),
plus tests/test_gravity.py's needle retrieval at a small size."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.ops import topk as jtopk
from aule_tpu_torch.ops import topk as ttopk
from aule_tpu_torch.ops.rope import precompute_rope_frequencies
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()


def _inputs(b, hq, hkv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))


@pytest.mark.parametrize("descending", [True, False])
def test_spatial_sort_matches_jax(descending):
    k = np.random.default_rng(3).standard_normal((2, 3, 64, 16)).astype(
        np.float32)
    want = np.asarray(jtopk.spatial_sort(jnp.asarray(k), descending))
    got = ttopk.spatial_sort(torch.from_numpy(k), descending)
    assert got.dtype == torch.int32
    assert (got.numpy() == want).all()


GRAVITY_CASES = {  # id: (Hq, Hkv, Sq, Sk, max_attend, causal, window,
    #                     rope, chunk, indices)
    "causal_gqa": (4, 2, 32, 96, 40, True, -1, False, None, False),
    "window": (2, 2, 48, 48, 30, False, 8, False, 16, False),
    "rope_causal": (2, 1, 40, 40, 24, True, -1, True, 10, False),
    "indices_chunked": (4, 2, 16, 128, 100, True, 20, False, 32, True),
    "full_k": (2, 2, 24, 24, 24, True, -1, False, None, False),
}


@pytest.mark.parametrize("case", list(GRAVITY_CASES))
def test_gravity_matches_jax(case):
    hq, hkv, sq, sk, a, causal, window, rope, chunk, given = \
        GRAVITY_CASES[case]
    q, k, v = _inputs(1, hq, hkv, sq, sk, 32, seed=sq + sk)
    kw = dict(max_attend=a, causal=causal, window_size=window,
              chunk_size=chunk)
    jkw, tkw = dict(kw), dict(kw)
    if rope:
        cos, sin = precompute_rope_frequencies(sk, 32)
        jkw.update(rope_cos=cos.numpy(), rope_sin=sin.numpy())
        tkw.update(rope_cos=cos, rope_sin=sin)
    if given:  # a shuffled selection, not the magnitude order
        perm = np.random.default_rng(1).permutation(sk).astype(np.int32)
        idx = np.broadcast_to(perm, (1, hkv, sk)).copy()
        jkw["indices"], tkw["indices"] = jnp.asarray(idx), \
            torch.from_numpy(idx)
    want = jtopk.gravity_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                   **jkw)
    got = ttopk.gravity_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  **tkw)
    assert got.shape == q.shape
    assert_close(got.float(), np.asarray(want, np.float32), 0, 2e-5, case)


def test_gravity_bf16():
    q, k, v = _inputs(1, 2, 2, 32, 64, 64, seed=9)
    want = jtopk.gravity_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), max_attend=32,
        causal=True)
    got = ttopk.gravity_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        max_attend=32, causal=True)
    assert got.dtype == torch.bfloat16
    assert_close(got.float(), np.asarray(want.astype(jnp.float32)), 0, 2e-2,
                 "bf16")


def test_needle_retrieval():
    """tests/test_gravity.py's needle at a quarter of its size: a needle
    key of high magnitude among 256 noise keys is kept by top-32 selection
    and retrieved by a query along it."""
    rng = np.random.default_rng(7)
    n, d = 256, 32
    direction = rng.standard_normal(d).astype(np.float32)
    direction /= np.linalg.norm(direction)
    k = rng.standard_normal((1, 1, n, d)).astype(np.float32) * 0.3
    v = rng.standard_normal((1, 1, n, d)).astype(np.float32)
    k[0, 0, 153] = direction * 8.0
    needle = rng.standard_normal(d).astype(np.float32)
    v[0, 0, 153] = needle
    q = (direction * 4.0)[None, None, None, :].astype(np.float32)
    out = ttopk.gravity_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  max_attend=32)[0, 0, 0].numpy()
    cos = float(out @ needle / (np.linalg.norm(out) * np.linalg.norm(needle)))
    assert cos > 0.95, cos
    want = jtopk.gravity_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                   max_attend=32)
    assert_close(out, np.asarray(want)[0, 0, 0], 0, 2e-5, "needle vs JAX")
