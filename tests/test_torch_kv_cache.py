"""Paged KV-cache manager of the PyTorch port against the JAX package.

Mirrors tests/test_kv_cache.py on the port (allocator, lifecycle and batch
views, growth that keeps the data, exhaustion at the pool's maximum,
max_pages_per_seq), with the JAX cache driven alongside where both give
tables, and pins the scale-aliasing trap: JAX's `create(quantized=True)`
hands one zeros array to both k_scales and v_scales, harmless for
immutable arrays; the port appends in place, so it allocates two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.ops import paged as jpg
from aule_tpu.serving import kv_cache as jkv
from aule_tpu_torch import config
from aule_tpu_torch.ops import paged as tpg
from aule_tpu_torch.serving.kv_cache import (PagedKVCache,
                                             PagePoolExhausted,
                                             PythonPageAllocator)
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()


def _create(**kw):
    return PagedKVCache.create(device="cpu", **kw)


def test_allocator_basic_and_grow_match_jax():
    ours, theirs = PythonPageAllocator(8), jkv.PythonPageAllocator(8)
    assert ours.allocate(3) == theirs.allocate(3)
    ours.free([1, 0])
    theirs.free([1, 0])
    assert ours.num_free == 7
    with pytest.raises(PagePoolExhausted):
        ours.allocate(9)
    ours.allocate(7)
    theirs.allocate(7)
    ours.grow(12)
    theirs.grow(12)
    assert ours.num_free == 4 and ours.free_list() == theirs.free_list()
    assert ours.allocate(4) == theirs.allocate(4) == [8, 9, 10, 11]
    ours.set_free_list([5, 3])
    assert ours.allocate(2) == [3, 5]
    with pytest.raises(ValueError):
        ours.grow(4)


def test_cache_lifecycle_and_views():
    """The same calls give JAX's block tables and lengths."""
    ours = _create(num_kv_heads=2, head_dim=64, num_pages=16, page_size=16,
                   max_pages_per_seq=4)
    theirs = jkv.PagedKVCache.create(2, 64, num_pages=16, page_size=16,
                                     max_pages_per_seq=4)
    for cache in (ours, theirs):
        cache.add_sequence(0)
        cache.reserve(0, 40)  # 3 pages
        cache.advance(0, 40)
        cache.add_sequence(1, 10)
        cache.advance(1, 10)
    bt, lens = ours.batch_views([0, 1])
    jbt, jlens = theirs.batch_views([0, 1])
    assert bt.dtype == torch.int32 and tuple(bt.shape) == (2, 4)
    assert bt.tolist() == np.asarray(jbt).tolist()
    assert lens.tolist() == np.asarray(jlens).tolist() == [40, 10]
    assert len(set(bt[bt >= 0].tolist())) == 4
    with pytest.raises(ValueError):
        ours.add_sequence(1)
    ours.free_sequence(0)
    assert ours.num_free_pages == 15
    assert ours.k_pages.dtype == torch.bfloat16 and ours.k_scales is None


def test_cache_growth_preserves_data():
    cache = _create(num_kv_heads=1, head_dim=8, num_pages=4, page_size=16,
                    max_pages_per_seq=64, dtype=torch.float32, quantized=True)
    cache.k_pages[0, 1, 0, 0] = 7
    cache.v_scales[0, 3, 2] = 0.5
    cache.add_sequence(0)
    cache.reserve(0, 16 * 10)  # forces growth past 4 pages
    assert cache.num_pages >= 10 and cache.allocator.num_pages == \
        cache.num_pages
    assert int(cache.k_pages[0, 1, 0, 0]) == 7
    assert float(cache.v_scales[0, 3, 2]) == 0.5
    for t in (cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales):
        assert t.shape[1] == cache.num_pages
    assert len(set(cache.seq_pages[0])) == 10


def test_cache_exhaustion_at_max(monkeypatch):
    monkeypatch.setattr(config, "MAX_PAGES", 8)
    cache = _create(num_kv_heads=1, head_dim=8, num_pages=8, page_size=16,
                    max_pages_per_seq=1000)
    cache.add_sequence(0)
    with pytest.raises(PagePoolExhausted):
        cache.reserve(0, 16 * 9)


def test_max_pages_per_seq_enforced():
    cache = _create(num_kv_heads=1, head_dim=8, num_pages=16, page_size=16,
                    max_pages_per_seq=2)
    cache.add_sequence(0)
    with pytest.raises(PagePoolExhausted):
        cache.reserve(0, 16 * 3)


def test_defaults_follow_config():
    cache = _create(num_kv_heads=1, head_dim=8)
    assert (cache.num_pages, cache.page_size, cache.max_pages_per_seq) == (
        config.INITIAL_PAGES, config.PAGE_SIZE, config.MAX_PAGES_PER_SEQ)


def test_quantized_scales_do_not_alias():
    """JAX's create shares one scale array between K and V; the port's
    two tensors stay apart through an in-place append."""
    theirs = jkv.PagedKVCache.create(2, 64, num_pages=8, quantized=True)
    assert theirs.k_scales is theirs.v_scales  # the trap, in the reference
    cache = _create(num_kv_heads=2, head_dim=64, num_pages=8,
                    quantized=True)
    assert cache.k_scales.data_ptr() != cache.v_scales.data_ptr()
    assert cache.k_pages.dtype == torch.int8
    assert cache.k_scales.dtype == torch.float32
    cache.add_sequence(0, 1)
    bt, lens = cache.batch_views([0])
    k = torch.full((1, 2, 64), 2.0)
    v = torch.full((1, 2, 64), 8.0)
    tpg.kv_cache_append_decode_quantized(
        cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales, k, v,
        bt, lens)
    page = cache.seq_pages[0][0]
    want = torch.tensor([2.0, 8.0]) / 127  # amax / qmax in f32
    assert torch.equal(cache.k_scales[:, page, 0], want[:1].expand(2))
    assert torch.equal(cache.v_scales[:, page, 0], want[1:].expand(2))


def test_cache_serves_decode_like_jax():
    """Both caches, driven alike, hold the same bytes after a prefill
    append and give the same decode attention.  Page 0 is held first as
    the scratch page of -1 entries: sequence 1's padding tokens land there
    (-1 table columns), and JAX's read-modify-write of them would race a
    live sequence's writes to page 0 (ROADMAP queue 3)."""
    rng = np.random.default_rng(3)
    hkv, hq, d = 2, 4, 64
    ours = _create(num_kv_heads=hkv, head_dim=d, num_pages=8, page_size=16,
                   max_pages_per_seq=4, dtype=torch.float32)
    theirs = jkv.PagedKVCache.create(hkv, d, num_pages=8, page_size=16,
                                     max_pages_per_seq=4, dtype=jnp.float32)
    for cache in (ours, theirs):
        cache.add_sequence(-1, 1)
        cache.add_sequence(0, 37)
        cache.add_sequence(1, 20)
    k = rng.standard_normal((2, hkv, 37, d)).astype(np.float32)
    v = rng.standard_normal((2, hkv, 37, d)).astype(np.float32)
    seq = np.array([37, 20], np.int32)
    bt, lens = ours.batch_views([0, 1])
    jbt, jlens = theirs.batch_views([0, 1])
    tpg.kv_cache_append_prefill(ours.k_pages, ours.v_pages,
                                torch.from_numpy(k), torch.from_numpy(v), bt,
                                lens, torch.from_numpy(seq))
    theirs.k_pages, theirs.v_pages, _ = jpg.kv_cache_append_prefill(
        theirs.k_pages, theirs.v_pages, jnp.asarray(k), jnp.asarray(v), jbt,
        jlens, jnp.asarray(seq))
    for sid, n in ((0, 37), (1, 20)):
        ours.advance(sid, n)
        theirs.advance(sid, n)
    assert np.array_equal(ours.k_pages.numpy(), np.asarray(theirs.k_pages))
    assert np.array_equal(ours.v_pages.numpy(), np.asarray(theirs.v_pages))
    q = rng.standard_normal((2, hq, d)).astype(np.float32)
    bt, lens = ours.batch_views([0, 1])
    jbt, jlens = theirs.batch_views([0, 1])
    got = tpg.paged_attention(torch.from_numpy(q), ours.k_pages,
                              ours.v_pages, bt, lens)
    want = jpg.paged_attention(jnp.asarray(q), theirs.k_pages,
                               theirs.v_pages, jbt, jlens)
    assert_close(got, np.asarray(want), 0, 2e-5, "decode over the caches")
