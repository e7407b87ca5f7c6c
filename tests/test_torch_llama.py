"""Llama model of the PyTorch port against the JAX package.

`LlamaConfig.tiny()` in f32: the JAX params cross over with
`load_jax_params`, and `forward` (logits and the returned rotated K / V),
`decode_step_fused` and `prefill_step_fused` (logits; pools at 1e-4, or
bytewise for quantized pools and their scale tiles) agree with aule_tpu's
at 1e-4.  The trainer: `loss_fn` at 1e-5, every parameter's gradient at
1e-4 against `jax.grad(loss_fn)`, and two `train_step`s (loss and
parameters) at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.models import llama as jllama
from aule_tpu.ops.paged_fused import fused_pool_shape, fused_scales_shape
from aule_tpu.ops.rope import precompute_rope_frequencies as jrope
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.ops import flash_vjp
from aule_tpu_torch.ops.flash_vjp import flash_attention_vjp_plain
from aule_tpu_torch.ops.paged_fused import paged_attention_fused_plain
from aule_tpu_torch.ops.paged_prefill import paged_attention_prefill_plain
from aule_tpu_torch.ops.rope import precompute_rope_frequencies as trope
from aule_tpu_torch.parallel.mesh import make_mesh
from aule_tpu_torch.utils.testing import (assert_close, cap_cpu_threads,
                                          single_rank_world)

cap_cpu_threads()

JCFG = jllama.LlamaConfig.tiny()
TCFG = tllama.LlamaConfig.tiny()
ATOL = 1e-4


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(JCFG, jax.random.key(0))
    tp = tllama.load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def test_config_mirrors_jax():
    for name in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                 "hidden_dim", "rope_base", "norm_eps", "window_size",
                 "head_dim"):
        assert getattr(TCFG, name) == getattr(JCFG, name), name
    big_t, big_j = tllama.LlamaConfig.llama3_8b(), jllama.LlamaConfig.llama3_8b()
    assert (big_t.dim, big_t.n_layers, big_t.vocab_size, big_t.hidden_dim) \
        == (big_j.dim, big_j.n_layers, big_j.vocab_size, big_j.hidden_dim)
    assert big_t.dtype == torch.bfloat16


def test_rope_tables_match():
    jc, js = jrope(64, 32, 10000.0)
    tc, ts = trope(64, 32, 10000.0)
    assert_close(tc, np.asarray(jc), 0, 1e-6, "cos")
    assert_close(ts, np.asarray(js), 0, 1e-6, "sin")


def test_forward_logits_and_kv(params):
    jp, tp = params
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, JCFG.vocab_size, size=(2, 24)).astype(np.int32)
    jl, jkv = jllama.forward(jp, jnp.asarray(tokens), JCFG, return_kv=True)
    tl, tkv = tllama.forward(tp, torch.from_numpy(tokens).long(), TCFG,
                             return_kv=True)
    assert tl.dtype == torch.float32
    assert_close(tl, np.asarray(jl), 0, ATOL, "logits")
    assert len(tkv) == JCFG.n_layers
    for li, ((jk, jv), (tk, tv)) in enumerate(zip(jkv, tkv)):
        assert_close(tk, np.asarray(jk), 0, ATOL, f"k{li}")
        assert_close(tv, np.asarray(jv), 0, ATOL, f"v{li}")


def test_forward_attention_hook_is_the_plain_version(params):
    _, tp = params
    tokens = torch.arange(10)[None]
    a = tllama.forward(tp, tokens, TCFG)
    b = tllama.forward(tp, tokens, TCFG, attention=flash_attention_vjp_plain)
    assert torch.equal(a, b)  # on the CPU the wrapper IS the plain version


def test_decode_step_fused(params):
    jp, tp = params
    rng = np.random.default_rng(1)
    num_pages, page = 16, 16
    shape = fused_pool_shape(num_pages, JCFG.n_kv_heads, page,
                             JCFG.head_dim)
    pools = [rng.standard_normal(shape).astype(np.float32) * 0.1
             for _ in range(JCFG.n_layers)]
    bt = np.array([[1, 2, -1], [3, 4, 5]], np.int32)
    lens = np.array([20, 33], np.int32)
    tok = np.array([5, 77], np.int32)
    jc, js = jrope(64, JCFG.head_dim, JCFG.rope_base)
    tc, ts = trope(64, TCFG.head_dim, TCFG.rope_base)
    jl, jkv, jlens = jllama.decode_step_fused(
        jp, jnp.asarray(tok), jnp.asarray(lens),
        [jnp.asarray(p) for p in pools], jnp.asarray(bt), jnp.asarray(lens),
        JCFG, jc, js)
    tpools = torch.from_numpy(np.stack(pools))
    tl, _, tlens = tllama.decode_step_fused(
        tp, torch.from_numpy(tok).long(), torch.from_numpy(lens).long(),
        tpools, torch.from_numpy(bt), torch.from_numpy(lens), TCFG, tc, ts)
    assert_close(tl, np.asarray(jl), 0, ATOL, "logits")
    for li in range(JCFG.n_layers):
        assert_close(tpools[li], np.asarray(jkv[li]), 0, ATOL, f"pool{li}")
    assert tlens.tolist() == np.asarray(jlens).tolist()


QDTYPES = {"int8": (jnp.int8, torch.int8),
           "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _tbits(x, dtype):
    """A JAX array as a torch tensor of `dtype`, bit for bit."""
    a = np.asarray(x)
    if dtype == torch.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(dtype)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(dtype)
    return torch.from_numpy(a.copy())


def _same_bits(t, j):
    a = t.contiguous().view(torch.uint8).numpy()
    return a.tobytes() == np.asarray(j).view(np.uint8).tobytes()


def _quant_pools(qname, num_pages=16, page=16, seed=2):
    """Per-layer quantized pools and bf16 scale tiles with random history,
    written by JAX's prefill append; the port gets the same bytes."""
    from aule_tpu.ops.paged_fused import kv_cache_append_prefill_fused

    jqd, tqd = QDTYPES[qname]
    rng = np.random.default_rng(seed)
    bt = np.array([[1, 2, -1, -1], [3, 4, 5, -1]], np.int32)
    hist = np.array([20, 33], np.int32)
    jk, js = [], []
    for _ in range(JCFG.n_layers):
        kv = jnp.zeros(fused_pool_shape(num_pages, JCFG.n_kv_heads, page,
                                        JCFG.head_dim), jqd)
        sc = jnp.zeros(fused_scales_shape(num_pages, JCFG.n_kv_heads, page),
                       jnp.bfloat16)
        k = rng.standard_normal((2, JCFG.n_kv_heads, 33, JCFG.head_dim))
        v = rng.standard_normal(k.shape)
        kv, sc, _ = kv_cache_append_prefill_fused(
            kv, jnp.asarray(k, jnp.float32), jnp.asarray(v, jnp.float32),
            jnp.asarray(bt), jnp.zeros((2,), jnp.int32), jnp.asarray(hist),
            kv_scales=sc)
        jk.append(kv)
        js.append(sc)
    tk = torch.stack([_tbits(a, tqd) for a in jk])
    ts = torch.stack([_tbits(a, torch.bfloat16) for a in js])
    return jk, js, tk, ts, bt, hist


@pytest.mark.parametrize("mode", ["int8_exact", "int8_dot", "fp8"])
def test_decode_step_fused_quantized(params, mode, monkeypatch):
    """int8 pools on both decode paths (AULE_TPU_INT8_EXACT set in both
    packages for the exact one) and fp8 pools.  Exact paths: logits at 1e-4
    and every layer's appended payload and scale bytes identical.  The int8
    dot-product path quantizes q and p per row over different token spans
    in the two packages (ops/paged_fused.py DECODE_SPAN), so its logits
    hold at the JAX suite's 4e-2 and only layer 0's appends (made before
    any attention) are bytewise; later layers' inputs carry that
    difference."""
    import dataclasses

    from aule_tpu import config as jconfig

    if mode == "int8_exact":
        monkeypatch.setenv("AULE_TPU_INT8_EXACT", "1")
        monkeypatch.setattr(jconfig, "_config", dataclasses.replace(
            jconfig.get_config(), int8_exact=True))
    else:
        monkeypatch.delenv("AULE_TPU_INT8_EXACT", raising=False)
    jp, tp = params
    jk, js, tk, ts, bt, lens = _quant_pools(
        "fp8" if mode == "fp8" else "int8")
    tok = np.array([5, 77], np.int32)
    jc, jsn = jrope(64, JCFG.head_dim, JCFG.rope_base)
    tc, tsn = trope(64, TCFG.head_dim, TCFG.rope_base)
    jl, jkv, jlens, jsc = jllama.decode_step_fused(
        jp, jnp.asarray(tok), jnp.asarray(lens), jk, jnp.asarray(bt),
        jnp.asarray(lens), JCFG, jc, jsn, kv_scales=js)
    tl, _, tlens, _ = tllama.decode_step_fused(
        tp, torch.from_numpy(tok).long(), torch.from_numpy(lens).long(), tk,
        torch.from_numpy(bt), torch.from_numpy(lens), TCFG, tc, tsn, ts)
    dot = mode == "int8_dot"
    assert_close(tl, np.asarray(jl), 0, 4e-2 if dot else ATOL, "logits")
    for li in range(1 if dot else JCFG.n_layers):
        assert _same_bits(tk[li], jkv[li]), f"pool{li}"
        assert _same_bits(ts[li], jsc[li]), f"scales{li}"
    assert tlens.tolist() == np.asarray(jlens).tolist()


@pytest.mark.parametrize("qname", [None, "int8", "fp8"])
def test_prefill_step_fused(params, qname):
    """A ragged chunk (padding rows in sequence 1) over history: logits of
    each sequence's last valid token, and all_logits for every row."""
    jp, tp = params
    if qname is None:
        rng = np.random.default_rng(3)
        shape = fused_pool_shape(16, JCFG.n_kv_heads, 16, JCFG.head_dim)
        jk = [jnp.asarray(rng.standard_normal(shape) * 0.1, jnp.float32)
              for _ in range(JCFG.n_layers)]
        tk = torch.stack([torch.from_numpy(np.array(a)) for a in jk])
        js = ts = None
        bt = np.array([[1, 2, -1, -1], [3, 4, 5, -1]], np.int32)
        hist = np.array([20, 33], np.int32)
    else:
        jk, js, tk, ts, bt, hist = _quant_pools(qname, seed=4)
    tokens = np.random.default_rng(5).integers(
        0, JCFG.vocab_size, size=(2, 12)).astype(np.int32)
    slens = np.array([12, 7], np.int32)
    jc, jsn = jrope(64, JCFG.head_dim, JCFG.rope_base)
    tc, tsn = trope(64, TCFG.head_dim, TCFG.rope_base)
    jout = jllama.prefill_step_fused(
        jp, jnp.asarray(tokens), jnp.asarray(hist), jnp.asarray(slens), jk,
        jnp.asarray(bt), JCFG, jc, jsn, kv_scales=js)
    tout = tllama.prefill_step_fused(
        tp, torch.from_numpy(tokens).long(), torch.from_numpy(hist),
        torch.from_numpy(slens), tk, torch.from_numpy(bt), TCFG, tc, tsn, ts)
    assert_close(tout[0], np.asarray(jout[0]), 0, ATOL, "last logits")
    assert tout[2].tolist() == np.asarray(jout[2]).tolist()
    for li in range(JCFG.n_layers):
        if qname is None:
            assert_close(tk[li], np.asarray(jout[1][li]), 0, ATOL,
                         f"pool{li}")
        else:
            assert _same_bits(tk[li], jout[1][li]), f"pool{li}"
            assert _same_bits(ts[li], jout[3][li]), f"scales{li}"
    # all_logits, and the attention hook taking the plain version, over a
    # fresh copy of the pools the first call started from
    if qname is None:
        tk2 = torch.stack([torch.from_numpy(np.array(a)) for a in jk])
        ts2 = None
    else:
        _, _, tk2, ts2, _, _ = _quant_pools(qname, seed=4)
    every = tllama.prefill_step_fused(
        tp, torch.from_numpy(tokens).long(), torch.from_numpy(hist),
        torch.from_numpy(slens), tk2, torch.from_numpy(bt), TCFG, tc, tsn,
        ts2, all_logits=True, attention=paged_attention_prefill_plain)[0]
    assert every.shape == (2, 12, TCFG.vocab_size)
    assert torch.equal(every[0, 11], tout[0][0])
    assert torch.equal(every[1, 6], tout[0][1])


def _split_pools(kind, num_pages=16, page=16, seed=8):
    """Per-layer split pools ([Hkv, P, page, D] K and V, and f32 scales when
    quantized) holding random history, written by JAX's prefill append;
    the port gets the same bytes, stacked [L, ...]."""
    from aule_tpu.ops import paged as jpg

    rng = np.random.default_rng(seed)
    bt = np.array([[1, 2, -1, -1], [3, 4, 5, -1]], np.int32)
    hist = np.array([20, 33], np.int32)
    shape = (JCFG.n_kv_heads, num_pages, page, JCFG.head_dim)
    jdt, tdt = ((jnp.float32, torch.float32) if kind == "f32" else
                (jnp.bfloat16, torch.bfloat16) if kind == "bf16" else
                QDTYPES[kind])
    jpools = []
    for _ in range(JCFG.n_layers):
        k = jnp.asarray(rng.standard_normal((2,) + shape[:1] + (33,)
                                            + shape[3:]), jnp.float32)
        v = jnp.asarray(rng.standard_normal(k.shape), jnp.float32)
        where = (jnp.asarray(bt), jnp.zeros((2,), jnp.int32),
                 jnp.asarray(hist))
        if kind in QDTYPES:
            jpools.append(jpg.kv_cache_append_prefill_quantized(
                jnp.zeros(shape, jdt), jnp.zeros(shape, jdt),
                jnp.zeros(shape[:-1]), jnp.zeros(shape[:-1]), k, v,
                *where)[:4])
        else:
            jpools.append(jpg.kv_cache_append_prefill(
                jnp.zeros(shape, jdt), jnp.zeros(shape, jdt), k, v,
                *where)[:2])
    dts = (tdt, tdt, torch.float32, torch.float32)
    tpools = [torch.stack([_tbits(p[i], dts[i]) for p in jpools])
              for i in range(len(jpools[0]))]
    return [list(x) for x in zip(*jpools)], tpools, bt, hist


# bf16 runs the whole tiny model in bf16 (weights and pools, as the engine
# does): JAX rounds p to bf16 before the PV product while the port sums it
# in f32, and the two frameworks round their bf16 products at other
# places, so the logits agree to bf16 precision, not f32's
SPLIT_DECODE_TOL = {"f32": ATOL, "bf16": 5e-2, "int8": ATOL, "fp8": ATOL}


def _bf16_model(jp):
    import dataclasses

    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim == 2
                      else a, jp)
    return (jb, tllama.load_jax_params(jax.tree.map(np.asarray, jb),
                                       device="cpu"),
            dataclasses.replace(JCFG, dtype=jnp.bfloat16),
            dataclasses.replace(TCFG, dtype=torch.bfloat16))


@pytest.mark.parametrize("kind", sorted(SPLIT_DECODE_TOL))
def test_decode_step_split(params, kind):
    """decode_step over split pools against JAX's: logits (f32 pools and
    the exact, scale-folded int8 and fp8 paths at 1e-4), lengths, and
    every layer's pools after the in-place append (f32 at 1e-4; int8 and
    fp8 payloads bytewise and their f32 scales within 1e-6 relative; bf16
    bytewise in layer 0, whose appends come before any attention)."""
    jp, tp = params
    jcfg, tcfg = JCFG, TCFG
    if kind == "bf16":
        jp, tp, jcfg, tcfg = _bf16_model(jp)
    jpools, tpools, bt, lens = _split_pools(kind)
    tok = np.array([5, 77], np.int32)
    jc, jsn = jrope(64, JCFG.head_dim, JCFG.rope_base)
    tc, tsn = trope(64, TCFG.head_dim, TCFG.rope_base)
    jout = jllama.decode_step(jp, jnp.asarray(tok), jnp.asarray(lens),
                              jpools[0], jpools[1], jnp.asarray(bt),
                              jnp.asarray(lens), jcfg, jc, jsn, *jpools[2:])
    tout = tllama.decode_step(tp, torch.from_numpy(tok).long(),
                              torch.from_numpy(lens).long(), *tpools[:2],
                              torch.from_numpy(bt), torch.from_numpy(lens),
                              tcfg, tc, tsn, *tpools[2:])
    assert len(tout) == len(jout) == (6 if kind in QDTYPES else 4)
    assert_close(tout[0], np.asarray(jout[0]), 0, SPLIT_DECODE_TOL[kind],
                 "logits")
    assert tout[3].tolist() == np.asarray(jout[3]).tolist()
    for i, j in enumerate((1, 2, 4, 5)[:len(tpools)]):
        assert tout[j] is tpools[i]  # written in place
        for li in range(JCFG.n_layers):
            if kind == "f32":
                assert_close(tpools[i][li], np.asarray(jout[j][li]), 0,
                             ATOL, f"pool {i} layer {li}")
            elif kind == "bf16" and li > 0:
                # later layers' K/V come from inputs that already carry
                # the two frameworks' bf16 roundings: two bf16 steps of
                # values up to 4
                assert_close(tpools[i][li].float(), np.asarray(
                    jout[j][li].astype(jnp.float32)), 0, 2 ** -5 * 2,
                    f"pool {i} layer {li}")
            elif i >= 2:
                # a scale is the token's amax / qmax, and the two
                # frameworks sum the K/V products in other orders: a few
                # f32 steps apart
                assert_close(tpools[i][li], np.asarray(jout[j][li]), 1e-6,
                             0, f"scales {i} layer {li}")
            else:
                assert _same_bits(tpools[i][li], jout[j][li]), (i, li)


def test_decode_step_split_hook_and_mesh(params):
    """The attention hook taking the plain version gives the wrapper's
    result (on the CPU the wrapper IS the plain version); mesh= over a
    one-rank world gives the same bits (tests/test_torch_tp.py holds
    wider meshes to JAX's)."""
    from aule_tpu_torch.ops.paged import paged_attention_plain

    _, tp = params
    _, tpools, bt, lens = _split_pools("int8", seed=9)
    tc, tsn = trope(64, TCFG.head_dim, TCFG.rope_base)
    args = (torch.tensor([3, 9]), torch.from_numpy(lens).long())
    where = (torch.from_numpy(bt), torch.from_numpy(lens), TCFG, tc, tsn)
    a = tllama.decode_step(tp, *args, *[p.clone() for p in tpools[:2]],
                           *where, *[p.clone() for p in tpools[2:]])[0]
    b = tllama.decode_step(tp, *args, *[p.clone() for p in tpools[:2]],
                           *where, *[p.clone() for p in tpools[2:]],
                           attention=paged_attention_plain)[0]
    assert torch.equal(a, b)
    with single_rank_world():
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        c = tllama.decode_step(tp, *args, *[p.clone() for p in tpools[:2]],
                               *where, *[p.clone() for p in tpools[2:]],
                               mesh=mesh)[0]
    assert torch.equal(a, c)


def test_decode_attention_hook_is_the_plain_version(params):
    _, tp = params
    rng = np.random.default_rng(6)
    shape = fused_pool_shape(8, TCFG.n_kv_heads, 16, TCFG.head_dim)
    pools = torch.from_numpy(
        rng.standard_normal((TCFG.n_layers,) + shape).astype(np.float32))
    bt = torch.tensor([[1, 2]], dtype=torch.int32)
    lens = torch.tensor([20])
    tc, tsn = trope(64, TCFG.head_dim, TCFG.rope_base)
    a = tllama.decode_step_fused(tp, torch.tensor([3]), lens, pools.clone(),
                                 bt, lens, TCFG, tc, tsn)[0]
    b = tllama.decode_step_fused(tp, torch.tensor([3]), lens, pools.clone(),
                                 bt, lens, TCFG, tc, tsn,
                                 attention=paged_attention_fused_plain)[0]
    assert torch.equal(a, b)


def test_init_params_shapes_and_seed():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    p1 = tllama.init_params(TCFG, g1, device="cpu")
    p2 = tllama.init_params(TCFG, g2, device="cpu")
    jshapes = jax.tree.map(lambda a: a.shape,
                           jllama.init_params(JCFG, jax.random.key(0)))
    tshapes = {k: tuple(v.shape) for k, v in p1.items() if k != "layers"}
    for k, shape in tshapes.items():
        assert shape == tuple(jshapes[k]), k
    for name, w in p1["layers"][0].items():
        assert tuple(w.shape) == tuple(jshapes["layers"][0][name]), name
    assert p1["layers"][0]["attn_norm"].dtype == torch.float32
    assert torch.equal(p1["lm_head"], p2["lm_head"])


def test_load_jax_params_bf16(params):
    jp, _ = params
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                      if a.ndim == 2 else a, jp)
    tb = tllama.load_jax_params(jax.tree.map(np.asarray, jb), device="cpu")
    assert tb["embed"].dtype == torch.bfloat16
    assert tb["final_norm"].dtype == torch.float32
    assert torch.equal(
        tb["layers"][1]["wq"].float(),
        torch.from_numpy(np.array(jb["layers"][1]["wq"].astype(
            jnp.float32))))


def _train_tokens(seed=7):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, size=(2, 17)).astype(np.int32)


def _own_params(jp):
    """A private copy of the JAX params on the port's side (train_step
    updates in place)."""
    return tllama.load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _pairs(jtree, tparams):
    """(name, JAX array, port tensor) over every parameter."""
    for name in ("embed", "final_norm", "lm_head"):
        yield name, jtree[name], tparams[name]
    for li, (jl, tl) in enumerate(zip(jtree["layers"], tparams["layers"])):
        for key in jl:
            yield f"layers.{li}.{key}", jl[key], tl[key]


def test_loss_fn_matches_jax(params):
    jp, tp = params
    tokens = _train_tokens()
    jl = jllama.loss_fn(jp, jnp.asarray(tokens), JCFG)
    tl = tllama.loss_fn(tp, torch.from_numpy(tokens).long(), TCFG)
    assert tl.dtype == torch.float32 and tl.dim() == 0
    assert_close(tl, np.asarray(jl), 0, 1e-5, "loss")


def test_gradients_match_jax(params):
    """Every parameter's gradient of loss_fn through the port's flash
    attention (its plain backward on the CPU) against jax.grad through
    the Pallas backward kernels."""
    jp, _ = params
    tokens = _train_tokens()
    jg = jax.grad(jllama.loss_fn)(jp, jnp.asarray(tokens), JCFG)
    tp = _own_params(jp)
    for t in tllama._tensors(tp):
        t.requires_grad_(True)
    tllama.loss_fn(tp, torch.from_numpy(tokens).long(), TCFG).backward()
    for name, g, t in _pairs(jg, tp):
        assert t.grad is not None, name
        assert_close(t.grad, np.asarray(g), 1e-4, 1e-4, f"grad {name}")


def test_train_steps_match_jax(params):
    """Two SGD steps at lr 0.5 (as tests/test_model.py): the same losses
    and parameters as JAX's train_step, and the loss falls."""
    jp, _ = params
    tokens = _train_tokens()
    tp = _own_params(jp)
    jlosses, tlosses = [], []
    for _ in range(2):
        jp, jl = jllama.train_step(jp, jnp.asarray(tokens), JCFG, lr=0.5)
        out, tl = tllama.train_step(tp, torch.from_numpy(tokens).long(),
                                    TCFG, lr=0.5)
        assert out is tp and tl.grad_fn is None
        jlosses.append(float(jl))
        tlosses.append(float(tl))
    assert_close(np.array(tlosses), np.array(jlosses), 0, 1e-4, "losses")
    assert tlosses[1] < tlosses[0]
    for name, j, t in _pairs(jp, tp):
        assert t.grad is None, name  # freed after the update
        assert_close(t.detach(), np.asarray(j), 1e-4, 1e-4, name)


def test_no_grad_forward_skips_the_lse(params, monkeypatch):
    """Under torch.no_grad() (the engine's step), forward launches the
    flash forward without its LSE; with grad, with it."""
    _, tp = params
    calls = []
    fwd = flash_vjp.flash_attention_fwd

    def spy(*args, **kw):
        calls.append(kw["return_lse"])
        return fwd(*args, **kw)

    monkeypatch.setattr(flash_vjp, "flash_attention_fwd", spy)
    tokens = torch.arange(12)[None]
    with torch.no_grad():
        tllama.forward(tp, tokens, TCFG)
    assert calls == [False] * TCFG.n_layers
    calls.clear()
    grad = dict(tp, layers=[dict(layer, wq=layer["wq"].clone()
                                 .requires_grad_(True))
                            for layer in tp["layers"]])
    tllama.forward(grad, tokens, TCFG).sum().backward()
    assert calls == [True] * TCFG.n_layers
