"""Fused paged KV pool of the PyTorch port against the JAX package.

Layout helpers round-trip; the appends (plain and quantized) leave pools and
packed scale tiles bytewise equal to JAX's; `paged_attention_fused` on CPU
tensors (its plain version, the CUDA kernel's stand-in) matches aule_tpu's
Pallas kernel in interpret mode at f32 2e-5 and bf16 2e-2, and on quantized
pools at 2e-5 for the exact int8 and fp8 paths (f32 q) and 4e-2 for the
int8 dot-product path (the JAX suite's own bound, tests/test_paged_fused.py:
99; the two quantize p over different token spans).  The CUDA decode's
split-KV partition (ops/decode_split.py), with the row tiles of large GQA
groups, is pinned, and its plain split-and-merge is held to JAX at the
same tolerances, at every group class (3, 6, 12 and MQA 24 included).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.ops import paged_fused as jpf
from aule_tpu.ops import quant as jq
from aule_tpu_torch.ops import decode_split as ds
from aule_tpu_torch.ops import paged_fused as tpf
from aule_tpu_torch.ops import quant as tq
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()

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


def _pool(rng, d, hkv=HKV):
    return rng.standard_normal(
        tpf.fused_pool_shape(NUM_PAGES, hkv, PAGE, d)).astype(np.float32)


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


def _decode_case(rng, d, batch, lens, hq=4, hkv=HKV):
    pool = _pool(rng, d, hkv)
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


@pytest.mark.parametrize("hq,hkv", [(6, 2), (12, 2), (24, 2), (24, 1)])
def test_attention_f32_any_group(hq, hkv):
    """GQA groups 3, 6 and 12 and MQA 24, which the JAX kernel pads to a
    multiple of 8 rows (paged_fused.py:541-544) and the CUDA kernel takes
    in row tiles: the plain version, whole and over 3 splits, against JAX
    in interpret mode at 2e-5, with a trailing window, zero and one-token
    contexts and -1 tails."""
    rng = np.random.default_rng(40 + hq + hkv)
    lens = (0, 1, 37, 64)
    q, pool, bt, ln = _decode_case(rng, 128, len(lens), lens, hq=hq,
                                   hkv=hkv)
    jo, jl = jpf.paged_attention_fused(
        _j(q), _j(pool), jnp.asarray(bt), jnp.asarray(ln), window_size=30,
        return_lse=True)
    for nsplit in (1, 3):
        to, tl = tpf.paged_attention_fused_plain(
            _t(q), _t(pool), torch.from_numpy(bt), torch.from_numpy(ln),
            window_size=30, return_lse=True, nsplit=nsplit)
        assert_close(to, np.asarray(jo), 0, 2e-5, f"out {hq}:{hkv} {nsplit}")
        assert_close(tl, np.asarray(jl), 0, 2e-5, f"lse {hq}:{hkv} {nsplit}")
    assert (to[0] == 0).all()


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


QDTYPES = {"int8": (jnp.int8, torch.int8),
           "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
SDTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
           "f32": (jnp.float32, torch.float32)}


def _tq(x, dtype):
    """A JAX / numpy array of a 1- or 2-byte dtype as a torch tensor of
    `dtype`, bit for bit."""
    a = np.asarray(x)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(dtype)
    if dtype == torch.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(dtype)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("sname", sorted(SDTYPES))
def test_scale_pack_round_trip_and_bytes(sname):
    jsd, tsd = SDTYPES[sname]
    rng = np.random.default_rng(20)
    ks = rng.uniform(0.01, 2.0, (HKV, NUM_PAGES, PAGE)).astype(np.float32)
    vs = rng.uniform(0.01, 2.0, (HKV, NUM_PAGES, PAGE)).astype(np.float32)
    tp = tpf.pack_fused_scales(_t(ks), _t(vs), dtype=tsd)
    jp = jpf.pack_fused_scales(_j(ks), _j(vs), dtype=jsd)
    assert tuple(tp.shape) == tpf.fused_scales_shape(NUM_PAGES, HKV, PAGE)
    assert _bytes(tp) == _bytes(jp)
    k2, v2 = tpf.unpack_fused_scales(tp, HKV)
    jk2, jv2 = jpf.unpack_fused_scales(jp, HKV, PAGE)
    assert np.array_equal(k2.numpy(), np.asarray(jk2))
    assert np.array_equal(v2.numpy(), np.asarray(jv2))
    if tsd == torch.float32:
        assert torch.equal(k2, _t(ks)) and torch.equal(v2, _t(vs))
    with pytest.raises(ValueError):
        tpf.fused_scales_shape(4, 65, PAGE)


def _qpools(qname, sname, d=64):
    jqd, tqd = QDTYPES[qname]
    jsd, tsd = SDTYPES[sname]
    rng = np.random.default_rng(21)
    pool = rng.standard_normal(
        tpf.fused_pool_shape(NUM_PAGES, HKV, PAGE, d)).astype(np.float32)
    payload, _ = jq.quantize_kv(jnp.asarray(pool), jqd)
    sc = rng.uniform(0.01, 1.0, tpf.fused_scales_shape(
        NUM_PAGES, HKV, PAGE)).astype(np.float32)
    return (payload, jnp.asarray(sc, jsd), _tq(payload, tqd),
            _tq(jnp.asarray(sc, jsd), tsd))


@pytest.mark.parametrize("sname", sorted(SDTYPES))
@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_quantized_append_decode_bytewise(qname, sname):
    rng = np.random.default_rng(22)
    d = 64
    jpool, jsc, tpool, tsc = _qpools(qname, sname, d)
    kn = rng.standard_normal((3, HKV, d)).astype(np.float32)
    vn = rng.standard_normal((3, HKV, d)).astype(np.float32)
    kn[1, 0] = 0.0  # a zero row takes scale 1
    bt = np.array([[1, 2, -1], [3, -1, -1], [-1, -1, -1]], np.int32)
    lens = np.array([17, 5, 0], np.int32)
    jp, js, jl = jpf.kv_cache_append_decode_fused(
        jpool, _j(kn), _j(vn), jnp.asarray(bt), jnp.asarray(lens),
        kv_scales=jsc)
    out = tpf.kv_cache_append_decode_fused(
        tpool, _t(kn), _t(vn), torch.from_numpy(bt), torch.from_numpy(lens),
        kv_scales=tsc)
    assert out[0] is tpool and out[1] is tsc  # written in place
    assert tpool.view(torch.uint8).numpy().tobytes() \
        == np.asarray(jp).view(np.uint8).tobytes()
    assert _bytes(tsc) == _bytes(js)
    assert out[2].tolist() == np.asarray(jl).tolist()


@pytest.mark.parametrize("sname", sorted(SDTYPES))
@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_quantized_append_prefill_bytewise(qname, sname):
    """Padding tokens keep the old payload and scales."""
    rng = np.random.default_rng(23)
    d, seq = 64, 40
    jpool, jsc, tpool, tsc = _qpools(qname, sname, d)
    kn = rng.standard_normal((2, HKV, seq, d)).astype(np.float32)
    vn = rng.standard_normal((2, HKV, seq, d)).astype(np.float32)
    bt = np.array([[4, 5, 6, -1], [7, 8, -1, -1]], np.int32)
    ctx = np.array([0, 3], np.int32)
    slens = np.array([37, 20], np.int32)
    jp, js, jl = jpf.kv_cache_append_prefill_fused(
        jpool, _j(kn), _j(vn), jnp.asarray(bt), jnp.asarray(ctx),
        jnp.asarray(slens), kv_scales=jsc)
    _, _, tl = tpf.kv_cache_append_prefill_fused(
        tpool, _t(kn), _t(vn), torch.from_numpy(bt), torch.from_numpy(ctx),
        torch.from_numpy(slens), kv_scales=tsc)
    assert tpool.view(torch.uint8).numpy().tobytes() \
        == np.asarray(jp).view(np.uint8).tobytes()
    assert _bytes(tsc) == _bytes(js)
    assert tl.tolist() == np.asarray(jl).tolist()


def _quant_case(qname, lens, hq=8, d=64, seed=24):
    """Head-major f32 K/V, quantized by JAX and packed (f32 scales, so the
    exact paths compare at f32 tolerance); the same bytes for the port."""
    jqd, tqd = QDTYPES[qname]
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((HKV, NUM_PAGES, PAGE, d)).astype(np.float32)
    v = rng.standard_normal((HKV, NUM_PAGES, PAGE, d)).astype(np.float32)
    kq, ks = jq.quantize_kv(jnp.asarray(k), jqd)
    vq, vs = jq.quantize_kv(jnp.asarray(v), jqd)
    jpool, jsc = jpf.to_fused_layout(kq, vq, ks, vs, scale_dtype=jnp.float32)
    q, _, bt, ln = _decode_case(rng, d, len(lens), lens, hq=hq)
    return (k, v, q, bt, ln, jpool, jsc, _tq(jpool, tqd), _tq(jsc,
                                                             torch.float32))


@pytest.mark.parametrize("window", [-1, 21])
@pytest.mark.parametrize("mode", ["int8_exact", "fp8", "int8_dot"])
def test_quantized_decode_against_jax(mode, window):
    qname = "fp8" if mode == "fp8" else "int8"
    int8_matmul = mode == "int8_dot"
    lens = (37, 0, 64, 5)
    k, v, q, bt, ln, jpool, jsc, tpool, tsc = _quant_case(qname, lens)
    jo, jl = jpf.paged_attention_fused(
        _j(q), jpool, jnp.asarray(bt), jnp.asarray(ln), kv_scales=jsc,
        window_size=window, int8_matmul=int8_matmul, return_lse=True)
    to, tl = tpf.paged_attention_fused(
        _t(q), tpool, torch.from_numpy(bt), torch.from_numpy(ln),
        kv_scales=tsc, window_size=window, int8_matmul=int8_matmul,
        return_lse=True)
    tol = 4e-2 if int8_matmul else 2e-5
    assert_close(to, np.asarray(jo), 0, tol, f"{mode} out")
    assert_close(tl, np.asarray(jl), 0, 2e-5 if not int8_matmul else 2e-2,
                 f"{mode} lse")
    assert (to[1] == 0).all()  # context 0
    if int8_matmul:
        # and the whole int8 pipeline stays within the JAX suite's bound
        # of the unquantized f32 oracle
        want = tpf.paged_attention_fused(
            _t(q), tpf.to_fused_layout(_t(k), _t(v)), torch.from_numpy(bt),
            torch.from_numpy(ln), window_size=window)
        assert_close(to, want, 0, 4e-2, "int8 dot vs f32")


def test_int8_default_follows_setting(monkeypatch):
    """int8 pools take the dot-product path unless AULE_TPU_INT8_EXACT."""
    k, v, q, bt, ln, jpool, jsc, tpool, tsc = _quant_case("int8", (40, 9))
    args = (_t(q), tpool, torch.from_numpy(bt), torch.from_numpy(ln))
    dot = tpf.paged_attention_fused(*args, kv_scales=tsc, int8_matmul=True)
    exact = tpf.paged_attention_fused(*args, kv_scales=tsc,
                                      int8_matmul=False)
    assert not torch.equal(dot, exact)
    monkeypatch.delenv("AULE_TPU_INT8_EXACT", raising=False)
    assert torch.equal(tpf.paged_attention_fused(*args, kv_scales=tsc), dot)
    monkeypatch.setenv("AULE_TPU_INT8_EXACT", "1")
    assert torch.equal(tpf.paged_attention_fused(*args, kv_scales=tsc),
                       exact)


def test_quantized_bf16_q_keeps_its_dtype():
    k, v, q, bt, ln, jpool, jsc, tpool, tsc = _quant_case("fp8", (30, 50))
    jo = jpf.paged_attention_fused(
        _j(q, jnp.bfloat16), jpool, jnp.asarray(bt), jnp.asarray(ln),
        kv_scales=jsc)
    to = tpf.paged_attention_fused(
        _t(q, torch.bfloat16), tpool, torch.from_numpy(bt),
        torch.from_numpy(ln), kv_scales=tsc)
    assert to.dtype == torch.bfloat16
    assert_close(to.float(), np.asarray(jo.astype(jnp.float32)), 0, 2e-2,
                 "fp8 bf16 q")


@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_quantized_pool_built_by_jax_feeds_the_port(qname):
    """aule_tpu.to_fused_layout with scales (bf16 packing, the engine's)
    builds a pool the port reads unchanged."""
    jqd, tqd = QDTYPES[qname]
    rng = np.random.default_rng(25)
    d = 64
    k = rng.standard_normal((HKV, NUM_PAGES, PAGE, d)).astype(np.float32)
    v = rng.standard_normal((HKV, NUM_PAGES, PAGE, d)).astype(np.float32)
    kq, ks = jq.quantize_kv(jnp.asarray(k), jqd)
    vq, vs = jq.quantize_kv(jnp.asarray(v), jqd)
    jpool, jsc = jpf.to_fused_layout(kq, vq, ks, vs)
    tpool, tsc = tpf.to_fused_layout(_tq(kq, tqd), _tq(vq, tqd), _t(ks),
                                     _t(vs))
    assert tpool.view(torch.uint8).numpy().tobytes() \
        == np.asarray(jpool).view(np.uint8).tobytes()
    assert _bytes(tsc) == _bytes(jsc)
    q = rng.standard_normal((2, 4, d)).astype(np.float32)
    bt = np.array([[3, 9, 1], [5, -1, -1]], np.int32)
    ln = np.array([40, 12], np.int32)
    jo = jpf.paged_attention_fused(_j(q), jpool, jnp.asarray(bt),
                                   jnp.asarray(ln), kv_scales=jsc,
                                   int8_matmul=False)
    to = tpf.paged_attention_fused(_t(q), _tq(jpool, tqd),
                                   torch.from_numpy(bt),
                                   torch.from_numpy(ln),
                                   kv_scales=_tq(jsc, torch.bfloat16),
                                   int8_matmul=False)
    assert_close(to, np.asarray(jo), 0, 2e-5, "out")


def test_quantized_pools_raise():
    """An integer pool without scales, scales for a float pool, a bad
    payload dtype or a mis-shaped scale tile raise ValueError."""
    pool = torch.zeros(tpf.fused_pool_shape(4, HKV, PAGE, 128))
    q = torch.zeros(1, 4, 128)
    bt = torch.zeros(1, 1, dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    sc = torch.ones(tpf.fused_scales_shape(4, HKV, PAGE))
    for bad in (dict(kv_pages=pool.to(torch.int8)),
                dict(kv_pages=pool.to(torch.float8_e4m3fn)),
                dict(kv_pages=pool, kv_scales=sc),
                dict(kv_pages=pool.to(torch.int16), kv_scales=sc),
                dict(kv_pages=pool.to(torch.int8), kv_scales=sc[:, :8])):
        kv = bad.pop("kv_pages")
        with pytest.raises(ValueError):
            tpf.paged_attention_fused(q, kv, bt, ln, **bad)
    with pytest.raises(ValueError):
        tpf.kv_cache_append_decode_fused(
            pool, torch.zeros(1, HKV, 128), torch.zeros(1, HKV, 128), bt,
            ln, kv_scales=sc)
    with pytest.raises(ValueError):
        tq.quantize_kv(torch.zeros(2, 8), torch.float16)


# -- the split-KV partition of the CUDA decode (ops/decode_split.py) -------

@pytest.mark.parametrize("batch,hkv,window,want", [
    (8, 8, -1, 6), (1, 8, -1, 17), (8, 8, 1001, 4), (64, 8, -1, 1),
    (2, 2, 100, 1)])
def test_num_splits_fills_one_wave(batch, hkv, window, want):
    """As many blocks as fit 132 SMs at once (BLOCKS_PER_SM each), at most
    one split per MIN_SPLIT_TOKENS of the 4352-token capacity or of the
    window; from the shapes alone."""
    n = ds.num_splits(batch, hkv, 4352, window, 132)
    assert n == want
    assert n == 1 or batch * hkv * n <= ds.BLOCKS_PER_SM * 132
    # a group's row tiles count as (sequence, kv head) pairs of their own
    for tiles in (2, 3):
        assert ds.num_splits(batch, hkv, 4352, window, 132, tiles) \
            == ds.num_splits(batch * tiles, hkv, 4352, window, 132)
    assert ds.num_splits(batch, hkv, 4352, window, 132, 1) == want


@pytest.mark.parametrize("group,tc,generic", [
    (1, 1, 1), (3, 1, 1), (4, 1, 1), (8, 1, 1), (12, 2, 2), (16, 2, 2),
    (24, 3, 3), (32, 4, 4)])
def test_row_tiles_in_the_launch_plan(group, tc, generic, monkeypatch):
    """Both decode kernels take up to 8 q rows a block: a larger group is
    cut into row tiles, each with its own splits and merge counters; the
    split count counts the tiles among the blocks of one wave.  Groups up
    to 8 keep one tile, so their split count is the one-tile count."""
    monkeypatch.setattr(ds, "sm_count", lambda device: 132)
    monkeypatch.setattr(ds, "_COUNTERS", {})
    # the rows the wrappers pass to the kernels: a power-of-two group up
    # to 8 whole, any other group padded, never more than the kernel takes
    tc_rows, gen_rows = ds.tc_tile_rows(group), ds.generic_tile_rows(group)
    assert tc_rows == (group if group in (1, 2, 4, 8) else 8)
    assert gen_rows in (1, 2, 4, 8) and gen_rows >= min(group, 8)
    assert ds.row_tiles(group, tc_rows) == tc
    assert ds.row_tiles(group, gen_rows) == generic
    hkv = 1 if group > 16 else 8
    dev = torch.device("cpu", 0)
    # the launch plan's default is the tensor-core rule
    assert ds.launch_plan(8, hkv * group, hkv, 4352, -1, dev)[0] \
        == ds.launch_plan(8, hkv * group, hkv, 4352, -1, dev,
                          tile_rows=tc_rows)[0]
    for rows, tiles in ((tc_rows, tc), (gen_rows, generic)):
        nsplit, ws, cnt = ds.launch_plan(8, hkv * group, hkv, 4352, -1, dev,
                                         tile_rows=rows)
        assert nsplit == ds.num_splits(8, hkv, 4352, -1, 132, tiles)
        assert nsplit == 1 or 8 * hkv * tiles * nsplit \
            <= ds.BLOCKS_PER_SM * 132
        if nsplit > 1:
            assert ws.numel() == 8 * hkv * group * nsplit * 130
            assert cnt.numel() >= 8 * hkv * tiles and not cnt.any()


@pytest.mark.parametrize("nsplit", [1, 3, 8, 17])
@pytest.mark.parametrize("window", [-1, 9, 1001])
def test_split_bounds_cover_each_live_token_once(nsplit, window):
    """Every live token lies in exactly one split's range, no range
    crosses a DECODE_SPAN span counted from t_lo, and short sequences and
    windows leave splits empty."""
    cap = 4352
    lens = torch.tensor([0, 1, 17, 36, 4068, 4096, 4352, 5000],
                        dtype=torch.int32)
    lo, hi = ds.split_bounds(lens, cap, window, nsplit)
    assert lo.shape == hi.shape == (len(lens), nsplit)
    for b, n in enumerate(lens.clamp(max=cap).tolist()):
        t_lo = max(0, n - window) if window > 0 else 0
        count = torch.zeros(cap + 8, dtype=torch.int64)
        for s in range(nsplit):
            a, z = int(lo[b, s]), int(hi[b, s])
            if a >= z:
                continue
            count[a:z] += 1
            assert (a - t_lo) % tpf.DECODE_SPAN == 0
            assert z == n or (z - t_lo) % tpf.DECODE_SPAN == 0
        assert (count[t_lo:n] == 1).all()
        assert count[:t_lo].sum() == 0 and count[n:].sum() == 0
    empty = lo >= hi
    assert empty[0].all()                       # context 0
    if nsplit >= 3:
        assert empty[1, 1:].all()               # len 1: one live split
    if nsplit >= 8:
        assert empty[2].any()                   # len 17
    if window == 9 and nsplit >= 8:
        assert empty[5].any()                   # 9 live tokens of 4096


_JAX_FUSED = {}


@pytest.mark.parametrize("nsplit", [1, 3, 8])
@pytest.mark.parametrize("window", [-1, 21])
@pytest.mark.parametrize("mode", ["f32", "int8_exact", "fp8", "int8_dot"])
def test_split_merge_plain_against_jax(mode, window, nsplit):
    """The plain split-and-merge (each split's range evaluated on its own,
    the (m, l, acc) merged in split order, as the kernel) against JAX's
    paged_attention_fused in interpret mode, with contexts 0, 1 and 5 so
    that most of 8 splits are empty: f32 pools and the exact int8 and fp8
    paths (f32 scales) at 2e-5, the int8 dot products at JAX's own 4e-2
    (LSE 2e-2; the two quantize p over other spans); and against the port's
    whole-range plain version at 1e-5 (f32 rounding of the merge)."""
    lens = (37, 0, 64, 5, 1)
    int8_matmul = mode == "int8_dot"
    if mode == "f32":
        rng = np.random.default_rng(31)
        q, pool, bt, ln = _decode_case(rng, 64, len(lens), lens)
        jargs = (_j(q), _j(pool), jnp.asarray(bt), jnp.asarray(ln))
        targs = (_t(q), _t(pool), torch.from_numpy(bt), torch.from_numpy(ln))
        jkw, tkw = {}, {}
    else:
        qname = "fp8" if mode == "fp8" else "int8"
        _, _, q, bt, ln, jpool, jsc, tpool, tsc = _quant_case(qname, lens)
        jargs = (_j(q), jpool, jnp.asarray(bt), jnp.asarray(ln))
        targs = (_t(q), tpool, torch.from_numpy(bt), torch.from_numpy(ln))
        jkw = dict(kv_scales=jsc, int8_matmul=int8_matmul)
        tkw = dict(kv_scales=tsc, int8_matmul=int8_matmul)
    key = (mode, window)
    if key not in _JAX_FUSED:
        _JAX_FUSED[key] = jpf.paged_attention_fused(
            *jargs, window_size=window, return_lse=True, **jkw)
    jo, jl = _JAX_FUSED[key]
    to, tl = tpf.paged_attention_fused_plain(
        *targs, window_size=window, return_lse=True, nsplit=nsplit, **tkw)
    tol = 4e-2 if int8_matmul else 2e-5
    assert_close(to, np.asarray(jo), 0, tol, f"{mode} out")
    assert_close(tl, np.asarray(jl), 0, 2e-2 if int8_matmul else 2e-5,
                 f"{mode} lse")
    assert (to[1] == 0).all()  # context 0
    wo, wl = tpf.paged_attention_fused_plain(
        *targs, window_size=window, return_lse=True, **tkw)
    assert_close(to, wo, 0, 1e-5, f"{mode} against one range")
    assert_close(tl, wl, 0, 1e-5, f"{mode} lse against one range")


# -- which CUDA kernel family takes a q (ops/paged_generic.py) ------------

@pytest.mark.parametrize("kernel", ["decode", "prefill"])
@pytest.mark.parametrize("dtype,d,generic", [
    (torch.float32, 64, True), (torch.float32, 128, True),
    (torch.float32, 256, True), (torch.bfloat16, 64, False),
    (torch.bfloat16, 128, False), (torch.bfloat16, 256, False),
    (torch.float16, 64, False), (torch.float16, 128, False),
    (torch.float16, 256, False)])
def test_kernel_family_routing(dtype, d, generic, kernel):
    """Each paged kernel's rule (ops/paged_generic.py).  The decode: the
    tensor-core kernel (csrc/paged_decode.cu) takes bf16/f16 at D
    64/128/256, the generic one (csrc/paged_generic.cu) f32 alone
    (`generic`).  The prefill the same: the tensor-core kernel
    (csrc/paged_prefill.cu) takes bf16/f16 at D 64/128/256, the generic
    one f32 alone."""
    from aule_tpu_torch.ops.paged_generic import (prefill_uses_generic,
                                                  uses_generic_kernels)

    if kernel == "decode":
        got = uses_generic_kernels(torch.zeros(2, 4, d, dtype=dtype))
        assert got is generic
    else:
        got = prefill_uses_generic(torch.zeros(1, 4, 8, d, dtype=dtype))
        assert got is (dtype == torch.float32)


@pytest.mark.parametrize("kernel", ["decode", "prefill"])
@pytest.mark.parametrize("dtype,d", [
    (torch.float32, 96), (torch.bfloat16, 96), (torch.float16, 32),
    (torch.float64, 64)])
def test_kernel_family_refuses_other_shapes(dtype, d, kernel):
    from aule_tpu_torch.ops.paged_generic import (prefill_uses_generic,
                                                  uses_generic_kernels)

    rule = uses_generic_kernels if kernel == "decode" \
        else prefill_uses_generic
    with pytest.raises(ValueError, match="paged kernels take"):
        rule(torch.zeros(2, 4, d, dtype=dtype))


def test_kernel_inputs_refuse_a_cpu_tensor():
    q = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError, match="device"):
        tpf.check_kernel_inputs(q, (), "paged-decode")


@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_launch_plan_workspace_holds_the_head_dim(head_dim, monkeypatch):
    """The merge workspace holds (D + 2) floats per q row and split, D of
    the kernel's head dim (csrc/paged_generic.cu takes 64 and 256 too);
    the split count depends on the shapes and SM count only."""
    monkeypatch.setattr(ds, "sm_count", lambda device: 132)
    monkeypatch.setattr(ds, "_COUNTERS", {})
    dev = torch.device("cpu", 0)  # an index, as a CUDA device has
    nsplit, ws, cnt = ds.launch_plan(8, 12, 12, 1024, -1, dev,
                                     head_dim=head_dim)
    assert nsplit == ds.num_splits(8, 12, 1024, -1, 132) == 4
    assert ws.numel() == 8 * 12 * nsplit * (head_dim + 2)
    assert cnt.numel() >= 8 * 12 and not cnt.any()


@pytest.mark.parametrize("head_dim,per_sm", [(64, 3), (128, 3), (256, 1)])
def test_tensor_core_decode_splits_by_its_blocks_per_sm(head_dim, per_sm,
                                                        monkeypatch):
    """The tensor-core decode's wave holds 3 blocks an SM at D 64 and 128
    and 1 at D 256 (csrc/paged_decode.cu min_blocks): its split count is
    one wave of those at B8 x 8 kv heads over 4096 tokens (6 splits, or 2
    at D 256), the same for either layout since it reads the shapes
    only."""
    monkeypatch.setattr(ds, "sm_count", lambda device: 132)
    monkeypatch.setattr(ds, "_COUNTERS", {})
    assert ds.tc_blocks_per_sm(head_dim) == per_sm
    dev = torch.device("cpu", 0)
    nsplit, ws, _ = ds.launch_plan(8, 32, 8, 4096, -1, dev,
                                   head_dim=head_dim,
                                   blocks_per_sm=per_sm)
    assert nsplit == per_sm * 132 // (8 * 8)
    assert ws.numel() == 8 * 32 * nsplit * (head_dim + 2)
