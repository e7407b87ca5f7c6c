"""Fused paged KV pool of the PyTorch port against the JAX package.

Layout helpers round-trip; the appends leave pools bytewise equal to JAX's;
`paged_attention_fused` on CPU tensors (its plain version, the CUDA
kernel's stand-in) matches aule_tpu's Pallas kernel in interpret mode at
f32 2e-5 and bf16 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.ops import paged_fused as jpf
from aule_tpu_torch.ops import paged_fused as tpf
from aule_tpu_torch.utils.testing import assert_close

HKV, PAGE, NUM_PAGES = 2, 16, 24


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        x = x.view(np.int16)
    return x.tobytes()


def _pool(rng, d):
    return rng.standard_normal(
        tpf.fused_pool_shape(NUM_PAGES, HKV, PAGE, d)).astype(np.float32)


def test_layout_round_trip():
    rng = np.random.default_rng(0)
    k = rng.standard_normal((HKV, NUM_PAGES, PAGE, 64)).astype(np.float32)
    v = rng.standard_normal((HKV, NUM_PAGES, PAGE, 64)).astype(np.float32)
    fused = tpf.to_fused_layout(_t(k), _t(v))
    assert tuple(fused.shape) == tpf.fused_pool_shape(NUM_PAGES, HKV, PAGE,
                                                      64)
    assert _bytes(fused) == _bytes(jpf.to_fused_layout(_j(k), _j(v)))
    k2, v2 = tpf.from_fused_layout(fused, 64)
    assert torch.equal(k2, _t(k)) and torch.equal(v2, _t(v))
    assert tpf.pad_head_dim(64) == 128 and tpf.pad_head_dim(128) == 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_append_decode_bytewise(dtype):
    rng = np.random.default_rng(1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    d = 64
    pool = _pool(rng, d)
    kn = rng.standard_normal((3, HKV, d)).astype(np.float32)
    vn = rng.standard_normal((3, HKV, d)).astype(np.float32)
    bt = np.array([[1, 2, -1], [3, -1, -1], [-1, -1, -1]], np.int32)
    lens = np.array([17, 5, 0], np.int32)
    jp, jl = jpf.kv_cache_append_decode_fused(
        _j(pool, jdt), _j(kn, jdt), _j(vn, jdt), jnp.asarray(bt),
        jnp.asarray(lens))
    tp = _t(pool, tdt)
    out, tl = tpf.kv_cache_append_decode_fused(
        tp, _t(kn, tdt), _t(vn, tdt), torch.from_numpy(bt),
        torch.from_numpy(lens))
    assert out is tp  # written in place
    assert _bytes(tp) == _bytes(jp)
    assert tl.tolist() == np.asarray(jl).tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_append_prefill_bytewise(dtype):
    """Padding tokens (s >= seq_lens) keep the old pool contents, and
    positions past the table clamp as JAX's gather does."""
    rng = np.random.default_rng(2)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    d, seq = 128, 40
    pool = _pool(rng, d)
    kn = rng.standard_normal((2, HKV, seq, d)).astype(np.float32)
    vn = rng.standard_normal((2, HKV, seq, d)).astype(np.float32)
    bt = np.array([[4, 5, 6, -1], [7, 8, -1, -1]], np.int32)
    ctx = np.array([0, 3], np.int32)
    slens = np.array([37, 20], np.int32)
    jp, jl = jpf.kv_cache_append_prefill_fused(
        _j(pool, jdt), _j(kn, jdt), _j(vn, jdt), jnp.asarray(bt),
        jnp.asarray(ctx), jnp.asarray(slens))
    tp = _t(pool, tdt)
    _, tl = tpf.kv_cache_append_prefill_fused(
        tp, _t(kn, tdt), _t(vn, tdt), torch.from_numpy(bt),
        torch.from_numpy(ctx), torch.from_numpy(slens))
    assert _bytes(tp) == _bytes(jp)
    assert tl.tolist() == np.asarray(jl).tolist()


def _decode_case(rng, d, batch, lens, hq=4):
    pool = _pool(rng, d)
    pool[0] = 1e3  # scratch page: garbage that must never be attended
    q = rng.standard_normal((batch, hq, d)).astype(np.float32)
    max_pages = 4
    bt = np.full((batch, max_pages), -1, np.int32)
    ids = rng.permutation(np.arange(1, NUM_PAGES))
    used = 0
    for b, n in enumerate(lens):
        npg = -(-n // PAGE)
        bt[b, :npg] = ids[used:used + npg]
        used += npg
    return q, pool, bt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("window", [-1, 9])
@pytest.mark.parametrize("lens", [(64, 33), (0, 1, 17, 50)])
def test_attention_f32(window, lens):
    """Mixed and zero contexts, -1 table entries, shuffled page ids."""
    rng = np.random.default_rng(3 + len(lens))
    q, pool, bt, ln = _decode_case(rng, 64, len(lens), lens)
    jo, jl = jpf.paged_attention_fused(
        _j(q), _j(pool), jnp.asarray(bt), jnp.asarray(ln),
        window_size=window, return_lse=True)
    to, tl = tpf.paged_attention_fused(
        _t(q), _t(pool), torch.from_numpy(bt), torch.from_numpy(ln),
        window_size=window, return_lse=True)
    assert_close(to, np.asarray(jo), 0, 2e-5, "out")
    assert_close(tl, np.asarray(jl), 0, 2e-5, "lse")
    zero = ln == 0
    assert (to[torch.from_numpy(zero)] == 0).all()


def test_attention_bf16():
    rng = np.random.default_rng(5)
    q, pool, bt, ln = _decode_case(rng, 128, 3, (40, 64, 7), hq=8)
    jo = jpf.paged_attention_fused(
        _j(q, jnp.bfloat16), _j(pool, jnp.bfloat16), jnp.asarray(bt),
        jnp.asarray(ln))
    to = tpf.paged_attention_fused(
        _t(q, torch.bfloat16), _t(pool, torch.bfloat16),
        torch.from_numpy(bt), torch.from_numpy(ln))
    assert to.dtype == torch.bfloat16
    assert_close(to.float(), np.asarray(jo.astype(jnp.float32)), 0, 2e-2,
                 "out")


def test_pool_built_by_jax_feeds_the_port():
    """A pool that aule_tpu.to_fused_layout built is used unchanged."""
    rng = np.random.default_rng(6)
    d = 64
    k = rng.standard_normal((HKV, NUM_PAGES, PAGE, d)).astype(np.float32)
    v = rng.standard_normal((HKV, NUM_PAGES, PAGE, d)).astype(np.float32)
    jpool = jpf.to_fused_layout(_j(k), _j(v))
    q = rng.standard_normal((2, 4, d)).astype(np.float32)
    bt = np.array([[3, 9, 1], [5, -1, -1]], np.int32)
    ln = np.array([40, 12], np.int32)
    jo = jpf.paged_attention_fused(_j(q), jpool, jnp.asarray(bt),
                                   jnp.asarray(ln))
    to = tpf.paged_attention_fused(_t(q), _t(np.asarray(jpool)),
                                   torch.from_numpy(bt),
                                   torch.from_numpy(ln))
    assert_close(to, np.asarray(jo), 0, 2e-5, "out")


def test_quantized_pools_raise():
    pool = torch.zeros(tpf.fused_pool_shape(4, HKV, PAGE, 128))
    q = torch.zeros(1, 4, 128)
    bt = torch.zeros(1, 1, dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        tpf.paged_attention_fused(q, pool, bt, ln,
                                  kv_scales=torch.zeros(4, PAGE, 128))
    with pytest.raises(ValueError):
        tpf.paged_attention_fused(q, pool.to(torch.int8), bt, ln)
