"""Chunked prefill over the fused paged pool: the PyTorch port against the
JAX package.

`paged_attention_prefill` on CPU tensors (its plain version, the CUDA
kernel's stand-in) against aule_tpu's Pallas kernel in interpret mode
(`block_q=16`), mirroring tests/test_paged_fused.py:130-220: history plus a
chunk appended by both packages, ragged chunks, D=64 padding, a window,
int8 and fp8 pools with packed scales, and LSE; and the shapes the CUDA
kernel is held at on the card (GQA groups 1 and 8 with int8 and fp8 pools,
32-token pages, 1-token chunks).  f32 at 2e-5 (outputs and
LSE), bf16 q at 2e-2.  Rows at or past `context_lens` are zeros with LSE
-0.7*f32max in the port (the JAX function's documented contract); the JAX
kernel lets those rows attend to the whole context, so only live rows are
compared with it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.ops import paged_fused as jpf
from aule_tpu_torch.config import DEFAULT_MASK_VALUE
from aule_tpu_torch.ops import paged_fused as tpf
from aule_tpu_torch.ops import paged_prefill as tpp
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()

PAGE, NUM_PAGES, MAX_PAGES = 16, 40, 8
QDTYPES = {"int8": (jnp.int8, torch.int8),
           "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _t(x, dtype=None):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    elif a.dtype.name.startswith("float8"):
        t = torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(a.copy())
    return t if dtype is None else t.to(dtype)


def _appended(batch, hkv, d, hist, chunk, s_pad, qname=None, seed=9,
              page=PAGE):
    """Both packages' pools of `page`-token pages after appending `hist`
    then `chunk` tokens per sequence (JAX appends; the port reads the same
    bytes), plus the chunk's queries and the layout."""
    rng = np.random.default_rng(seed)
    quant = qname is not None
    jdt = QDTYPES[qname][0] if quant else jnp.float32
    kv = jnp.zeros(jpf.fused_pool_shape(NUM_PAGES, hkv, page, d), jdt)
    sc = (jnp.zeros(jpf.fused_scales_shape(NUM_PAGES, hkv, page),
                    jnp.bfloat16) if quant else None)
    ids = 1 + rng.permutation(NUM_PAGES - 1)[:batch * MAX_PAGES]
    bt = ids.reshape(batch, MAX_PAGES).astype(np.int32)
    bt[:, -1] = -1  # unused tail entries
    k1 = rng.standard_normal((batch, hkv, int(hist.max()), d)).astype(
        np.float32)
    v1 = rng.standard_normal(k1.shape).astype(np.float32)
    k2 = rng.standard_normal((batch, hkv, s_pad, d)).astype(np.float32)
    v2 = rng.standard_normal(k2.shape).astype(np.float32)
    lens = jnp.zeros((batch,), jnp.int32)
    for k, v, n in ((k1, v1, hist), (k2, v2, chunk)):
        args = (kv, jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt), lens,
                jnp.asarray(n))
        if quant:
            kv, sc, lens = jpf.kv_cache_append_prefill_fused(
                *args, kv_scales=sc)
        else:
            kv, lens = jpf.kv_cache_append_prefill_fused(*args)
    return kv, sc, bt, np.array(lens), rng


def _both(q, kv, sc, bt, lens, qoff, **kw):
    jo, jl = jpf.paged_attention_prefill(
        jnp.asarray(q), kv, jnp.asarray(bt), jnp.asarray(lens),
        q_offsets=jnp.asarray(qoff), kv_scales=sc, block_q=16,
        return_lse=True, **kw)
    to, tl = tpp.paged_attention_prefill(
        _t(q), _t(kv), torch.from_numpy(bt), torch.from_numpy(lens),
        q_offsets=torch.from_numpy(qoff),
        kv_scales=None if sc is None else _t(sc), return_lse=True, **kw)
    return np.asarray(jo), np.asarray(jl), to, tl


def _check_rows(jo, jl, to, tl, live, tol, label):
    """Live rows against JAX; rows past the context zeros + mask LSE."""
    for b, n in enumerate(live):
        assert_close(to[b, :, :n], jo[b, :, :n], 0, tol, f"{label} out{b}")
        assert_close(tl[b, :, :n], jl[b, :, :n], 0, tol, f"{label} lse{b}")
        assert (to[b, :, n:] == 0).all()
        assert (tl[b, :, n:] == DEFAULT_MASK_VALUE).all()


def test_history_plus_chunk_d64():
    """Chunk 2 attends history + chunk with positional causality; ragged
    chunk lengths (rows past them are padding); D=64 pads to 128."""
    batch, hq, hkv, d, s2 = 2, 8, 2, 64, 40
    hist = np.array([30, 48], np.int32)
    chunk = np.array([40, 17], np.int32)
    kv, sc, bt, lens, rng = _appended(batch, hkv, d, hist, chunk, s2)
    q = rng.standard_normal((batch, hq, s2, d)).astype(np.float32)
    jo, jl, to, tl = _both(q, kv, sc, bt, lens, hist)
    assert to.shape == (batch, hq, s2, d)
    _check_rows(jo, jl, to, tl, chunk, 2e-5, "chunk")


@pytest.mark.parametrize("window", [7, 32])
def test_window(window):
    batch, hq, hkv, d, s2 = 2, 4, 4, 128, 24
    hist = np.array([50, 9], np.int32)
    chunk = np.array([24, 24], np.int32)
    kv, sc, bt, lens, rng = _appended(batch, hkv, d, hist, chunk, s2,
                                      seed=10)
    q = rng.standard_normal((batch, hq, s2, d)).astype(np.float32)
    jo, jl, to, tl = _both(q, kv, sc, bt, lens, hist, window_size=window)
    _check_rows(jo, jl, to, tl, chunk, 2e-5, f"window {window}")


@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_quantized_pools(qname):
    """int8 / fp8 payloads with bf16 packed scales, windowed, GQA 4."""
    batch, hq, hkv, d, s2 = 2, 8, 2, 128, 32
    hist = np.array([40, 0], np.int32)
    chunk = np.array([32, 13], np.int32)
    kv, sc, bt, lens, rng = _appended(batch, hkv, d, hist, chunk, s2,
                                      qname=qname, seed=11)
    q = rng.standard_normal((batch, hq, s2, d)).astype(np.float32)
    jo, jl, to, tl = _both(q, kv, sc, bt, lens, hist, window_size=20)
    _check_rows(jo, jl, to, tl, chunk, 2e-5, qname)


# The shapes csrc/paged_prefill.cu is held at on the card (chip_smoke.py's
# check_prefill and check_groups) that the tests above lack, at small
# sizes: (hq, hkv, page, hist, chunk, s_pad, pool, window).  D = 128, the
# kernel's.  Groups 3, 6 and 12 and MQA 24 (JAX pads them to a multiple of
# 8 rows, paged_fused.py:998-1007) are the kernel's 1, 2 and 4 heads a
# block and its 8 heads a block three times.
KERNEL_SHAPES = {
    "group 3 f32": (6, 2, 16, [37, 0], [11, 20], 20, None, 15),
    "group 6 int8": (12, 2, 16, [21, 40], [16, 5], 16, "int8", -1),
    "group 12 f32": (24, 2, 16, [21, 40], [16, 5], 16, None, 15),
    "group 24 (MQA) fp8": (24, 1, 16, [45, 9], [12, 3], 12, "fp8", 30),
    "group 1 int8": (2, 2, 16, [37, 0], [11, 20], 20, "int8", -1),
    "group 1 fp8": (2, 2, 16, [37, 0], [11, 20], 20, "fp8", 15),
    "group 8 int8": (8, 1, 16, [21, 40], [16, 5], 16, "int8", 15),
    "group 8 fp8": (8, 1, 16, [21, 40], [16, 5], 16, "fp8", -1),
    "page 32 f32": (4, 2, 32, [45, 70], [19, 3], 19, None, -1),
    "page 32 int8": (4, 2, 32, [45, 70], [19, 3], 19, "int8", 30),
    "page 32 fp8": (4, 2, 32, [45, 70], [19, 3], 19, "fp8", -1),
    "1-token chunk int8": (8, 2, 16, [60, 9], [1, 1], 1, "int8", -1),
    "1-token chunk beside 14 f32": (8, 2, 16, [33, 90], [14, 1], 14, None,
                                    -1),
}


@pytest.mark.parametrize("name", sorted(KERNEL_SHAPES))
def test_kernel_shapes_against_jax(name):
    """JAX (Pallas in interpret mode) = the port's wrapper (on the CPU: the
    plain version, which chip_smoke.py holds the CUDA kernel to) = its
    plain version called directly, at each shape the card checks: live rows
    within 2e-5, padding rows zeros with the mask LSE."""
    hq, hkv, page, hist, chunk, s_pad, qname, window = KERNEL_SHAPES[name]
    hist = np.array(hist, np.int32)
    chunk = np.array(chunk, np.int32)
    kv, sc, bt, lens, rng = _appended(len(hist), hkv, 128, hist, chunk,
                                      s_pad, qname=qname, seed=14,
                                      page=page)
    q = rng.standard_normal((len(hist), hq, s_pad, 128)).astype(np.float32)
    jo, jl, to, tl = _both(q, kv, sc, bt, lens, hist, window_size=window)
    _check_rows(jo, jl, to, tl, chunk, 2e-5, name)
    launches = tpp.paged_attention_prefill.launches
    po, pl = tpp.paged_attention_prefill_plain(
        _t(q), _t(kv), torch.from_numpy(bt), torch.from_numpy(lens),
        q_offsets=torch.from_numpy(hist),
        kv_scales=None if sc is None else _t(sc), window_size=window,
        return_lse=True)
    assert torch.equal(po, to) and torch.equal(pl, tl)
    assert tpp.paged_attention_prefill.launches == launches  # CPU route


def test_default_offsets_bf16_and_non_causal():
    """q_offsets default to context_lens - S_new; bf16 q joins a bf16 pool;
    causal=False attends to the whole visible context."""
    batch, hq, hkv, d, s2 = 1, 4, 2, 128, 20
    hist = np.array([33], np.int32)
    chunk = np.array([20], np.int32)
    kv, _, bt, lens, rng = _appended(batch, hkv, d, hist, chunk, s2,
                                     seed=12)
    q = rng.standard_normal((batch, hq, s2, d)).astype(np.float32)
    for causal in (True, False):
        jo = jpf.paged_attention_prefill(
            jnp.asarray(q, jnp.bfloat16), kv.astype(jnp.bfloat16),
            jnp.asarray(bt), jnp.asarray(lens), causal=causal, block_q=16)
        to = tpp.paged_attention_prefill(
            _t(q, torch.bfloat16), _t(kv, torch.bfloat16),
            torch.from_numpy(bt), torch.from_numpy(lens), causal=causal)
        assert to.dtype == torch.bfloat16
        assert_close(to.float(), np.asarray(jo.astype(jnp.float32)), 0,
                     2e-2, f"bf16 causal={causal}")


def test_matches_dense_flash_reference():
    """The plain version against the port's own dense oracle: a chunk at
    offset h over h + S cached tokens is the last S rows of causal
    attention over the whole sequence."""
    from aule_tpu_torch.ops.reference import attention_reference

    rng = np.random.default_rng(13)
    hkv, hq, d, h, s = 2, 4, 128, 45, 19
    k = rng.standard_normal((1, hkv, h + s, d)).astype(np.float32)
    v = rng.standard_normal((1, hkv, h + s, d)).astype(np.float32)
    q = rng.standard_normal((1, hq, s, d)).astype(np.float32)
    pool = torch.zeros(tpf.fused_pool_shape(NUM_PAGES, hkv, PAGE, d))
    bt = torch.arange(1, 1 + MAX_PAGES, dtype=torch.int32)[None]
    tpf.kv_cache_append_prefill_fused(
        pool, _t(k), _t(v), bt, torch.zeros(1, dtype=torch.int32),
        torch.tensor([h + s], dtype=torch.int32))
    got = tpp.paged_attention_prefill(_t(q), pool, bt,
                                      torch.tensor([h + s]))
    qfull = torch.zeros(1, hq, h + s, d)
    qfull[:, :, h:] = _t(q)
    want = attention_reference(qfull, _t(k), _t(v), causal=True)[:, :, h:]
    assert_close(got, want, 0, 2e-5, "dense")


def test_bad_inputs_raise():
    pool = torch.zeros(tpf.fused_pool_shape(4, 2, PAGE, 128))
    q = torch.zeros(1, 4, 3, 128)
    bt = torch.zeros(1, 1, dtype=torch.int32)
    ln = torch.full((1,), 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        tpp.paged_attention_prefill(q, pool.to(torch.int8), bt, ln)
    with pytest.raises(ValueError):
        tpp.paged_attention_prefill(q[..., :64], pool[..., :64], bt, ln)
    with pytest.raises(ValueError):
        tpp.paged_attention_prefill(q[:, :3], pool, bt, ln)
