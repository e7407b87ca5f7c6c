"""Split-layout paged KV pools of the PyTorch port against the JAX package.

`paged_attention` on CPU tensors (its plain version, the CUDA kernel's
stand-in) against aule_tpu's Pallas `_paged_decode_kernel` in interpret
mode on the same seeded inputs: f32 at 2e-5 and bf16 at 2e-2 (the JAX
kernel rounds p to bf16 before the PV product, the port sums in f32);
int8 and e4m3 pools with f32 scales at 1e-4 against JAX's output (both
fold the scales: JAX into s and p, the plain version into the pool) and
against the f32 oracle on the unquantized pools at JAX's own 2e-2 / 1.2e-1
(tests/test_quant.py:38-62).  The four appends leave pools and scales
bytewise equal to JAX's, the masked prefill tail included, and a pool that
JAX built feeds the port unchanged.  The plain split-and-merge of the CUDA
decode's split-KV partition holds to JAX at the same tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.ops import paged as jpg
from aule_tpu.ops import quant as jq
from aule_tpu.ops.reference import paged_attention_reference as joracle
from aule_tpu_torch.ops import paged as tpg
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()

PAGE, NUM_PAGES, MAX_PAGES = 16, 40, 16

QDTYPES = {"int8": (jnp.int8, torch.int8),
           "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _bits(x, dtype):
    """A JAX / numpy array as a torch tensor of `dtype`, bit for bit."""
    a = np.asarray(x)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(dtype)
    if dtype == torch.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(dtype)
    return torch.from_numpy(a.copy())


def _same_bytes(t, j):
    return (t.contiguous().view(torch.uint8).numpy().tobytes()
            == np.asarray(j).view(np.uint8).tobytes())


def _case(lens, hq, hkv, d, seed):
    """Random head-major pools, q, and tables of shuffled page ids with -1
    tails; page 0 is the scratch page, filled with values no live row may
    see."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((hkv, NUM_PAGES, PAGE, d)).astype(np.float32)
    v = rng.standard_normal((hkv, NUM_PAGES, PAGE, d)).astype(np.float32)
    k[:, 0] = v[:, 0] = 1e3
    ids = rng.permutation(np.arange(1, NUM_PAGES))
    bt = np.full((len(lens), MAX_PAGES), -1, np.int32)
    used = 0
    for b, n in enumerate(lens):
        npg = -(-n // PAGE)
        bt[b, :npg] = ids[used:used + npg]
        used += npg
    q = rng.standard_normal((len(lens), hq, d)).astype(np.float32)
    return q, k, v, bt, np.asarray(lens, np.int32)


def _both(q, k, v, bt, ln, jdt=jnp.float32, tdt=torch.float32, **kw):
    jo = jpg.paged_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                             jnp.asarray(v, jdt), jnp.asarray(bt),
                             jnp.asarray(ln), return_lse=True, **kw)
    to = tpg.paged_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                             torch.from_numpy(bt), torch.from_numpy(ln),
                             return_lse=True, **kw)
    return jo, to


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (16, 4), (12, 1),
                                    (6, 2), (12, 2), (24, 2), (24, 1)])
def test_attention_f32_groups(hq, hkv):
    q, k, v, bt, ln = _case((37, 128, 5, 250), hq, hkv, 64, seed=hq + hkv)
    (jo, jl), (to, tl) = _both(q, k, v, bt, ln)
    assert_close(to, np.asarray(jo), 0, 2e-5, f"out {hq}:{hkv}")
    assert_close(tl, np.asarray(jl), 0, 2e-5, f"lse {hq}:{hkv}")


@pytest.mark.parametrize("window", [-1, 9])
@pytest.mark.parametrize("lens", [(64, 33), (0, 1, 17, 200)])
def test_attention_window_zero_and_mixed(lens, window):
    """Trailing windows, zero and one-token contexts, -1 tables: a context
    of 0 gives zeros and the LSE -0.7 * f32max in both."""
    q, k, v, bt, ln = _case(lens, 8, 2, 64, seed=len(lens))
    (jo, jl), (to, tl) = _both(q, k, v, bt, ln, window_size=window)
    assert_close(to, np.asarray(jo), 0, 2e-5, "out")
    assert_close(tl, np.asarray(jl), 0, 2e-5, "lse")
    zero = torch.from_numpy(ln == 0)
    assert (to[zero] == 0).all()


def test_attention_bf16_d128():
    q, k, v, bt, ln = _case((40, 256, 7), 8, 2, 128, seed=5)
    (jo, _), (to, _) = _both(q, k, v, bt, ln, jdt=jnp.bfloat16,
                             tdt=torch.bfloat16)
    assert to.dtype == torch.bfloat16
    assert_close(to.float(), np.asarray(jo.astype(jnp.float32)), 0, 2e-2,
                 "bf16 out")


def test_q_joins_the_pool_dtype():
    """Unquantized pools take q in the pool dtype, as JAX."""
    q, k, v, bt, ln = _case((30,), 4, 2, 64, seed=6)
    out = tpg.paged_attention(_t(q), _t(k, torch.bfloat16),
                              _t(v, torch.bfloat16), torch.from_numpy(bt),
                              torch.from_numpy(ln))
    assert out.dtype == torch.bfloat16


def _quantized(qname, lens, hq=8, hkv=2, d=64, seed=7):
    """Pools quantized by JAX (f32 scales); the port gets the same bytes."""
    jqd, tqd = QDTYPES[qname]
    q, k, v, bt, ln = _case(lens, hq, hkv, d, seed)
    kq, ks = jq.quantize_kv(jnp.asarray(k), jqd)
    vq, vs = jq.quantize_kv(jnp.asarray(v), jqd)
    jpools = (kq, vq, ks, vs)
    tpools = (_bits(kq, tqd), _bits(vq, tqd), _t(ks), _t(vs))
    return q, k, v, bt, ln, jpools, tpools


@pytest.mark.parametrize("window", [-1, 21])
@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_quantized_against_jax(qname, window):
    lens = (37, 0, 128, 250)
    q, k, v, bt, ln, (kq, vq, ks, vs), (tk, tv, tks, tvs) = _quantized(
        qname, lens)
    jo, jl = jpg.paged_attention(
        jnp.asarray(q), kq, vq, jnp.asarray(bt), jnp.asarray(ln),
        k_scales=ks, v_scales=vs, window_size=window, return_lse=True)
    to, tl = tpg.paged_attention(
        _t(q), tk, tv, torch.from_numpy(bt), torch.from_numpy(ln),
        k_scales=tks, v_scales=tvs, window_size=window, return_lse=True)
    assert_close(to, np.asarray(jo), 0, 1e-4, f"{qname} out")
    assert_close(tl, np.asarray(jl), 0, 1e-4, f"{qname} lse")
    assert (to[1] == 0).all()  # context 0
    # the quantization error against the f32 oracle, within JAX's bound
    want = joracle(q, k, v, bt, ln, window_size=window)
    tol = 2e-2 if qname == "int8" else 1.2e-1
    assert_close(to, np.asarray(want), 0, tol, f"{qname} vs f32 oracle")


def test_quantized_bf16_q_keeps_its_dtype():
    q, k, v, bt, ln, _, (tk, tv, tks, tvs) = _quantized("fp8", (30, 50))
    out = tpg.paged_attention(_t(q, torch.bfloat16), tk, tv,
                              torch.from_numpy(bt), torch.from_numpy(ln),
                              k_scales=tks, v_scales=tvs)
    want = tpg.paged_attention_plain(_t(q), tk, tv, torch.from_numpy(bt),
                                     torch.from_numpy(ln), k_scales=tks,
                                     v_scales=tvs)
    assert out.dtype == torch.bfloat16
    assert_close(out.float(), want, 0, 2e-2, "fp8 bf16 q")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_append_decode_bytewise(dtype):
    """Ragged positions, a -1 table (scratch page 0) and a position past
    the table (its last column, as JAX's gather clamps)."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(10)
    hkv, d = 2, 64
    k = rng.standard_normal((hkv, NUM_PAGES, PAGE, d)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    kn = rng.standard_normal((4, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((4, hkv, d)).astype(np.float32)
    bt = np.array([[1, 2], [3, -1], [-1, -1], [4, 5]], np.int32)
    lens = np.array([17, 5, 0, 40], np.int32)
    jk, jv, jl = jpg.kv_cache_append_decode(
        jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(kn, jdt),
        jnp.asarray(vn, jdt), jnp.asarray(bt), jnp.asarray(lens))
    tk, tv = _t(k, tdt), _t(v, tdt)
    out = tpg.kv_cache_append_decode(tk, tv, _t(kn, tdt), _t(vn, tdt),
                                     torch.from_numpy(bt),
                                     torch.from_numpy(lens))
    assert out[0] is tk and out[1] is tv  # written in place
    assert _same_bytes(tk, jk) and _same_bytes(tv, jv)
    assert out[2].tolist() == np.asarray(jl).tolist()


@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_append_decode_quantized_bytewise(qname):
    jqd, tqd = QDTYPES[qname]
    rng = np.random.default_rng(11)
    hkv, d = 2, 64
    shape = (hkv, NUM_PAGES, PAGE, d)
    kq, ks = jq.quantize_kv(jnp.asarray(rng.standard_normal(shape),
                                        jnp.float32), jqd)
    vq, vs = jq.quantize_kv(jnp.asarray(rng.standard_normal(shape),
                                        jnp.float32), jqd)
    kn = rng.standard_normal((3, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((3, hkv, d)).astype(np.float32)
    kn[1, 0] = 0.0  # a zero row takes scale 1
    bt = np.array([[1, 2, -1], [3, -1, -1], [-1, -1, -1]], np.int32)
    lens = np.array([17, 5, 0], np.int32)
    jout = jpg.kv_cache_append_decode_quantized(
        kq, vq, ks, vs, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(bt),
        jnp.asarray(lens))
    tpools = [_bits(kq, tqd), _bits(vq, tqd), _t(ks), _t(vs)]
    tout = tpg.kv_cache_append_decode_quantized(
        *tpools, _t(kn), _t(vn), torch.from_numpy(bt),
        torch.from_numpy(lens))
    for i in range(4):
        assert tout[i] is tpools[i]  # written in place
        assert _same_bytes(tpools[i], jout[i]), i
    assert tout[4].tolist() == np.asarray(jout[4]).tolist()


def _prefill_case(seed):
    """Two sequences of 40 tokens, 37 and 30 of them valid: one from
    position 0, one after 10 cached tokens, whose padding runs into its
    last page and then past its three-page table (positions 48 and on)."""
    rng = np.random.default_rng(seed)
    hkv, d, seq = 2, 64, 40
    kn = rng.standard_normal((2, hkv, seq, d)).astype(np.float32)
    vn = rng.standard_normal((2, hkv, seq, d)).astype(np.float32)
    bt = np.array([[4, 5, 6], [7, 8, 9]], np.int32)
    ctx = np.array([0, 10], np.int32)
    slens = np.array([37, 30], np.int32)
    return rng, kn, vn, bt, ctx, slens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_append_prefill_bytewise(dtype):
    """Padding tokens (s >= seq_lens) leave the pools as they were."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    rng, kn, vn, bt, ctx, slens = _prefill_case(12)
    k = rng.standard_normal((2, NUM_PAGES, PAGE, 64)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    jk, jv, jl = jpg.kv_cache_append_prefill(
        jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(kn, jdt),
        jnp.asarray(vn, jdt), jnp.asarray(bt), jnp.asarray(ctx),
        jnp.asarray(slens))
    tk, tv = _t(k, tdt), _t(v, tdt)
    out = tpg.kv_cache_append_prefill(
        tk, tv, _t(kn, tdt), _t(vn, tdt), torch.from_numpy(bt),
        torch.from_numpy(ctx), torch.from_numpy(slens))
    assert out[0] is tk and out[1] is tv
    assert _same_bytes(tk, jk) and _same_bytes(tv, jv)
    assert out[2].tolist() == np.asarray(jl).tolist()
    # and the tail really was left alone: page 6 (positions 32..47 of
    # sequence 0) keeps its old rows from slot 5 (position 37) on
    assert torch.equal(tk[:, 6, 5:], _t(k, tdt)[:, 6, 5:])


@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_append_prefill_quantized_bytewise(qname):
    jqd, tqd = QDTYPES[qname]
    rng, kn, vn, bt, ctx, slens = _prefill_case(13)
    shape = (2, NUM_PAGES, PAGE, 64)
    kq, ks = jq.quantize_kv(jnp.asarray(rng.standard_normal(shape),
                                        jnp.float32), jqd)
    vq, vs = jq.quantize_kv(jnp.asarray(rng.standard_normal(shape),
                                        jnp.float32), jqd)
    jout = jpg.kv_cache_append_prefill_quantized(
        kq, vq, ks, vs, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(bt),
        jnp.asarray(ctx), jnp.asarray(slens))
    tpools = [_bits(kq, tqd), _bits(vq, tqd), _t(ks), _t(vs)]
    tout = tpg.kv_cache_append_prefill_quantized(
        *tpools, _t(kn), _t(vn), torch.from_numpy(bt),
        torch.from_numpy(ctx), torch.from_numpy(slens))
    for i in range(4):
        assert tout[i] is tpools[i]
        assert _same_bytes(tpools[i], jout[i]), i
    assert tout[4].tolist() == np.asarray(jout[4]).tolist()


@pytest.mark.parametrize("qname", [None, "int8", "fp8"])
def test_pool_built_by_jax_feeds_the_port(qname):
    """Pools that JAX's prefill append wrote, handed over as bytes, give
    the port JAX's decode output."""
    rng = np.random.default_rng(14)
    hkv, hq, d, seq = 2, 8, 64, 50
    bt = np.array([[9, 3, 12, 1], [5, 20, -1, -1]], np.int32)
    slens = np.array([50, 27], np.int32)
    kn = jnp.asarray(rng.standard_normal((2, hkv, seq, d)), jnp.float32)
    vn = jnp.asarray(rng.standard_normal((2, hkv, seq, d)), jnp.float32)
    zero = jnp.zeros((2,), jnp.int32)
    shape = (hkv, NUM_PAGES, PAGE, d)
    if qname is None:
        pools = jpg.kv_cache_append_prefill(
            jnp.zeros(shape), jnp.zeros(shape), kn, vn, jnp.asarray(bt),
            zero, jnp.asarray(slens))[:2]
        tpools, kw, tkw = [_t(p) for p in pools], {}, {}
    else:
        jqd, tqd = QDTYPES[qname]
        pools = jpg.kv_cache_append_prefill_quantized(
            jnp.zeros(shape, jqd), jnp.zeros(shape, jqd),
            jnp.zeros(shape[:-1]), jnp.zeros(shape[:-1]), kn, vn,
            jnp.asarray(bt), zero, jnp.asarray(slens))[:4]
        tpools = [_bits(pools[0], tqd), _bits(pools[1], tqd), _t(pools[2]),
                  _t(pools[3])]
        kw = dict(k_scales=pools[2], v_scales=pools[3])
        tkw = dict(k_scales=tpools[2], v_scales=tpools[3])
    q = rng.standard_normal((2, hq, d)).astype(np.float32)
    jo = jpg.paged_attention(jnp.asarray(q), pools[0], pools[1],
                             jnp.asarray(bt), jnp.asarray(slens), **kw)
    to = tpg.paged_attention(_t(q), tpools[0], tpools[1],
                             torch.from_numpy(bt), torch.from_numpy(slens),
                             **tkw)
    assert_close(to, np.asarray(jo), 0, 1e-4, f"{qname} pool from JAX")


def test_bad_pools_raise():
    """An integer or e4m3 pool without scales, scales for a float pool, one
    scale tensor without the other, mis-shaped or non-f32 scales and
    mismatched K/V pools raise ValueError."""
    shape = (2, 4, PAGE, 64)
    pool = torch.zeros(shape)
    sc = torch.ones(shape[:-1])
    q = torch.zeros(1, 4, 64)
    bt = torch.zeros(1, 1, dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    i8 = pool.to(torch.int8)
    for kp, vp, kw in (
            (i8, i8, {}),
            (pool.to(torch.float8_e4m3fn), pool.to(torch.float8_e4m3fn), {}),
            (pool, pool, dict(k_scales=sc, v_scales=sc)),
            (i8, i8, dict(k_scales=sc)),
            (i8, i8, dict(k_scales=sc[:, :2], v_scales=sc[:, :2])),
            (i8, i8, dict(k_scales=sc.double(), v_scales=sc.double())),
            (pool, pool[:1], {}), (pool, pool.double(), {})):
        with pytest.raises(ValueError):
            tpg.paged_attention(q, kp, vp, bt, ln, **kw)
    with pytest.raises(ValueError):
        tpg.kv_cache_append_decode_quantized(
            pool, pool, sc, sc, torch.zeros(1, 2, 64), torch.zeros(1, 2, 64),
            bt, torch.zeros(1, dtype=torch.int32))


_JAX_SPLIT = {}


@pytest.mark.parametrize("nsplit", [1, 3, 8])
@pytest.mark.parametrize("window", [-1, 21])
@pytest.mark.parametrize("qname", [None, "int8", "fp8"])
def test_split_merge_plain_against_jax(qname, window, nsplit):
    """The plain split-and-merge of the CUDA decode's split-KV partition
    (ops/decode_split.py: each range on its own, the (m, l, acc) merged in
    split order), with contexts 0, 1 and 17 so that most of 8 splits are
    empty, against JAX's paged_attention (interpret mode): f32 pools at
    2e-5, int8 and fp8 pools with f32 scales at 1e-4; and against the
    port's whole-range plain version at 1e-5 (f32 rounding of the
    merge)."""
    lens = (37, 0, 128, 250, 1, 17)
    if qname is None:
        q, k, v, bt, ln = _case(lens, 8, 2, 64, 41)
        jpools = tuple(jnp.asarray(x) for x in (k, v)) + (None, None)
        tpools = (_t(k), _t(v), None, None)
        tol = 2e-5
    else:
        q, k, v, bt, ln, jpools, tpools = _quantized(qname, lens, seed=41)
        tol = 1e-4
    key = (qname, window)
    if key not in _JAX_SPLIT:
        _JAX_SPLIT[key] = jpg.paged_attention(
            jnp.asarray(q), jpools[0], jpools[1], jnp.asarray(bt),
            jnp.asarray(ln), k_scales=jpools[2], v_scales=jpools[3],
            window_size=window, return_lse=True)
    jo, jl = _JAX_SPLIT[key]
    args = (_t(q), tpools[0], tpools[1], torch.from_numpy(bt),
            torch.from_numpy(ln))
    kw = dict(k_scales=tpools[2], v_scales=tpools[3], window_size=window,
              return_lse=True)
    to, tl = tpg.paged_attention_plain(*args, nsplit=nsplit, **kw)
    assert_close(to, np.asarray(jo), 0, tol, f"{qname} out")
    assert_close(tl, np.asarray(jl), 0, tol, f"{qname} lse")
    assert (to[1] == 0).all()  # context 0
    wo, wl = tpg.paged_attention_plain(*args, **kw)
    assert_close(to, wo, 0, 1e-5, f"{qname} against one range")
    assert_close(tl, wl, 0, 1e-5, f"{qname} lse against one range")
