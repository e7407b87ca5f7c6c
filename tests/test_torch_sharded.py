"""Sharded attention of the PyTorch port against the JAX package's.

Mirrors the 14 test functions of tests/test_sharded.py on the same meshes
(and adds head parallelism's replicated-KV gradients),
(2, 4) and (8,): the port's strategies run in ONE spawned gloo world of 8
CPU ranks (utils/testing.py's `run_world`, each rank on its shards with
the kernels' plain versions), JAX's on the conftest's 8 virtual CPU
devices, both on the same seeded numpy inputs.  Outputs agree with JAX's
sharded functions and with the single-device oracle within JAX's TOL
(5e-5), and the gathered gradients (context parallel, ring causal and
not, Ulysses) within GRAD_TOL (1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aule_tpu.ops.paged_fused import to_fused_layout
from aule_tpu.ops.quant import dequantize_kv, quantize_kv
from aule_tpu.ops.reference import (attention_reference,
                                    attention_reference_numpy,
                                    paged_attention_reference)
from aule_tpu.parallel.mesh import make_mesh
from aule_tpu.parallel.sharded import (make_context_parallel_attention,
                                       make_head_parallel_attention,
                                       make_ring_attention,
                                       make_sharded_paged_attention,
                                       make_sharded_paged_attention_fused,
                                       make_ulysses_attention)
from aule_tpu.utils.testing import random_qkv
from aule_tpu_torch.models.llama import _to_torch
from aule_tpu_torch.utils.testing import (assert_close, cap_cpu_threads,
                                          run_world, sharded_cases)
from tests.test_paged import make_cache

cap_cpu_threads()

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

TOL = (5e-5, 5e-5)
GRAD_TOL = (1e-4, 1e-4)
CTX = (None, None, "ctx", None)
HEADS = ("data", "model", None, None)
REPL = (None, None, None, None)


def _t(a):
    return _to_torch(np.asarray(a), "cpu", None)


def _dense(make, mesh, qkv, specs, out_spec, grads=False, **kwargs):
    return dict(make=make, kwargs=kwargs, mesh=mesh,
                args=[_t(a) for a in qkv], in_specs=specs, out_spec=out_spec,
                grads=grads)


def _paged_ctx_inputs(seed):
    """tests/test_sharded.py's ctx-sharded cache: two sequences of 130 and
    57 tokens striped page by page over 4 shards of 16 pages each, with
    per-shard tables and lengths, and each sequence's full K / V."""
    n_ctx, batch, hq, hkv, d, page = 4, 2, 4, 2, 64, 16
    rng = np.random.default_rng(seed)
    ctx_global = np.array([130, 57], np.int32)
    max_pages_shard, pool_pages_shard = 4, 16
    k_pool = rng.standard_normal(
        (hkv, n_ctx * pool_pages_shard, page, d)).astype(np.float32)
    v_pool = rng.standard_normal(
        (hkv, n_ctx * pool_pages_shard, page, d)).astype(np.float32)
    bt = np.full((batch, n_ctx, max_pages_shard), -1, np.int32)
    lens = np.zeros((batch, n_ctx), np.int32)
    order = []   # per sequence: (global page, tokens) in logical order
    next_page = [0] * n_ctx
    for b in range(batch):
        tokens = int(ctx_global[b])
        pages = []
        for lp in range(-(-tokens // page)):
            shard = lp % n_ctx
            local_phys = next_page[shard]
            next_page[shard] += 1
            bt[b, shard, lens[b, shard] // page] = local_phys
            n_tok = min(page, tokens - lp * page)
            lens[b, shard] += n_tok
            pages.append((shard * pool_pages_shard + local_phys, n_tok))
        order.append(pages)
    q = rng.standard_normal((batch, hq, d)).astype(np.float32)
    return q, k_pool, v_pool, bt, lens, order


def _full_kv(k_pool, v_pool, pages):
    return (np.concatenate([k_pool[:, g, :n] for g, n in pages], axis=1),
            np.concatenate([v_pool[:, g, :n] for g, n in pages], axis=1))


def _cases():
    cases = {}
    m24 = ((2, 4), ("data", "model"))
    m8 = ((8,), ("ctx",))
    cases["head"] = _dense("make_head_parallel_attention", m24,
                           random_qkv(2, 8, 256, 64), [HEADS] * 3, HEADS,
                           causal=True)
    cases["head_gqa"] = _dense("make_head_parallel_attention", m24,
                               random_qkv(2, 16, 128, 64, heads_kv=4),
                               [HEADS] * 3, HEADS, causal=True)
    cases["head_mqa_grads"] = _dense(
        "make_head_parallel_attention", m24,
        random_qkv(2, 8, 128, 64, heads_kv=1),
        [HEADS, ("data", None, None, None), ("data", None, None, None)],
        HEADS, grads=True, causal=True, shard_kv_heads=False)
    cases["cp"] = _dense("make_context_parallel_attention", m8,
                         random_qkv(1, 4, 256, 64, seq_k=1024),
                         [REPL, CTX, CTX], REPL)
    for causal in (True, False):
        cases[f"ring_{causal}"] = _dense(
            "make_ring_attention", m8, random_qkv(1, 4, 1024, 64),
            [CTX] * 3, CTX, causal=causal)
        cases[f"ring_grads_{causal}"] = _dense(
            "make_ring_attention", m8, random_qkv(1, 2, 512, 64),
            [CTX] * 3, CTX, grads=True, causal=causal)
        cases[f"ulysses_{causal}"] = _dense(
            "make_ulysses_attention", m8, random_qkv(2, 8, 512, 64),
            [CTX] * 3, CTX, causal=causal)
    cases["ring_gqa"] = _dense("make_ring_attention", m8,
                               random_qkv(1, 8, 512, 64, heads_kv=2),
                               [CTX] * 3, CTX, causal=True)
    cases["cp_grads"] = _dense("make_context_parallel_attention", m8,
                               random_qkv(1, 4, 128, 64, seq_k=512),
                               [REPL, CTX, CTX], REPL, grads=True)
    cases["ulysses_gqa_window"] = _dense(
        "make_ulysses_attention", ((2, 4), ("data", "ctx")),
        random_qkv(1, 8, 256, 64, heads_kv=4), [CTX] * 3, CTX, causal=True,
        window_size=64, seq_axis="ctx")
    cases["ulysses_grads"] = _dense("make_ulysses_attention", m8,
                                    random_qkv(1, 8, 512, 64), [CTX] * 3, CTX,
                                    grads=True, causal=True)
    cases["ulysses_indivisible"] = dict(
        _dense("make_ulysses_attention", m8, random_qkv(1, 4, 512, 64),
               [CTX] * 3, CTX), raises=True)

    # paged decode, heads 4-way and batch 2-way
    ctx = np.array([37, 128, 5, 250], np.int32)
    k_pages, v_pages, bt = make_cache(4, 4, 64, 128, 16, 16, ctx)
    q = np.random.default_rng(1).standard_normal((4, 8, 64)).astype(
        np.float32)
    cases["paged_model"] = dict(
        make="make_sharded_paged_attention", kwargs=dict(ctx_axis=None),
        mesh=m24, args=[_t(a) for a in (q, k_pages, v_pages, bt[:, None, :],
                                        ctx[:, None])],
        in_specs=[("data", "model", None), ("model", None, None, None),
                  ("model", None, None, None), ("data", None, None),
                  ("data", None)],
        out_spec=("data", "model", None))

    q, k_pool, v_pool, bt, lens, _ = _paged_ctx_inputs(7)
    cases["paged_ctx"] = dict(
        make="make_sharded_paged_attention",
        kwargs=dict(data_axis=None, model_axis="model", ctx_axis="ctx"),
        mesh=((2, 4), ("model", "ctx")),
        args=[_t(a) for a in (q, k_pool, v_pool, bt, lens)],
        in_specs=[(None, "model", None), ("model", "ctx", None, None),
                  ("model", "ctx", None, None), (None, "ctx", None),
                  (None, "ctx")],
        out_spec=(None, "model", None))

    q, k_pool, v_pool, bt, lens, _ = _paged_ctx_inputs(11)
    fused_specs = [("data", None, None), ("ctx", None, None, None, None),
                   ("data", "ctx", None), ("data", "ctx")]
    kv = to_fused_layout(jnp.asarray(k_pool), jnp.asarray(v_pool))
    cases["fused_ctx"] = dict(
        make="make_sharded_paged_attention_fused",
        kwargs=dict(data_axis="data", ctx_axis="ctx"),
        mesh=((2, 4), ("data", "ctx")),
        args=[_t(a) for a in (q, kv, bt, lens)], in_specs=fused_specs,
        out_spec=("data", None, None))
    kq, ks = quantize_kv(jnp.asarray(k_pool), jnp.int8)
    vq, vs = quantize_kv(jnp.asarray(v_pool), jnp.int8)
    kvq, sc = to_fused_layout(kq, vq, ks, vs)
    cases["fused_ctx_int8"] = dict(
        make="make_sharded_paged_attention_fused",
        kwargs=dict(data_axis="data", ctx_axis="ctx", quantized=True),
        mesh=((2, 4), ("data", "ctx")),
        args=[_t(a) for a in (q, kvq, bt, lens, sc)],
        in_specs=fused_specs + [("ctx", None, None)],
        out_spec=("data", None, None))
    return cases


@pytest.fixture(scope="module")
def world():
    """Every case of this file in one world of 8 ranks: {name: (case,
    rank 0's result)}."""
    cases = _cases()
    names = list(cases)
    got = run_world(sharded_cases, 8, [cases[n] for n in names])[0]
    return {n: (cases[n], g) for n, g in zip(names, got)}


def _np(case, i):
    return case["args"][i].numpy()


def _jax_dense(fn, case):
    return np.asarray(fn(*[jnp.asarray(_np(case, i)) for i in range(3)]))


def _check_dense(world, name, jax_fn, label, want=None):
    case, got = world[name]
    q, k, v = (_np(case, i) for i in range(3))
    jgot = _jax_dense(jax_fn, case)
    assert_close(got["out"], jgot, *TOL, f"{label} vs JAX")
    if want is not None:
        assert_close(got["out"], want(q, k, v), *TOL, f"{label} vs oracle")


def _grads(fn, q, k, v):
    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out.astype(jnp.float32)
                       * jnp.arange(out.size).reshape(out.shape) * 1e-3)
    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _check_grads(world, name, jax_fn, ref_fn, label):
    case, got = world[name]
    q, k, v = (jnp.asarray(_np(case, i)) for i in range(3))
    jgrads = _grads(jax_fn, q, k, v)
    rgrads = _grads(ref_fn, q, k, v)
    for which, g, jg, rg in zip("qkv", got["grads"], jgrads, rgrads):
        assert_close(g, np.asarray(jg), *GRAD_TOL, f"{label} d{which} vs JAX")
        assert_close(g, np.asarray(rg), *GRAD_TOL,
                     f"{label} d{which} vs oracle")


def test_head_parallel_matches_oracle(world):
    fn = make_head_parallel_attention(make_mesh((2, 4), ("data", "model")),
                                      causal=True)
    _check_dense(world, "head", fn, "head-parallel",
                 lambda q, k, v: attention_reference_numpy(q, k, v,
                                                           causal=True))


def test_head_parallel_gqa_colocated(world):
    fn = make_head_parallel_attention(make_mesh((2, 4), ("data", "model")),
                                      causal=True)
    _check_dense(world, "head_gqa", fn, "head-parallel gqa",
                 lambda q, k, v: attention_reference_numpy(q, k, v,
                                                           causal=True))


def test_head_parallel_mqa_replicated_kv_grads(world):
    """MQA with the one kv head replicated over `model`
    (shard_kv_heads=False): the output, and dk / dv summed over the model
    ranks once, against the oracle's gradients."""
    case, got = world["head_mqa_grads"]
    q, k, v = (jnp.asarray(_np(case, i)) for i in range(3))
    want = attention_reference_numpy(*map(np.asarray, (q, k, v)), causal=True)
    assert_close(got["out"], want, *TOL, "head-parallel mqa")
    rgrads = _grads(lambda q, k, v: attention_reference(q, k, v, causal=True),
                    q, k, v)
    for which, g, rg in zip("qkv", got["grads"], rgrads):
        assert_close(g, np.asarray(rg), *GRAD_TOL,
                     f"head-parallel mqa d{which} vs oracle")


def test_context_parallel_matches_oracle(world):
    fn = make_context_parallel_attention(make_mesh((8,), ("ctx",)))
    _check_dense(world, "cp", fn, "context-parallel",
                 attention_reference_numpy)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_oracle(world, causal):
    fn = make_ring_attention(make_mesh((8,), ("ctx",)), causal=causal)
    _check_dense(world, f"ring_{causal}", fn, f"ring causal={causal}",
                 lambda q, k, v: attention_reference_numpy(q, k, v,
                                                           causal=causal))


def test_ring_attention_gqa(world):
    fn = make_ring_attention(make_mesh((8,), ("ctx",)), causal=True)
    _check_dense(world, "ring_gqa", fn, "ring gqa",
                 lambda q, k, v: attention_reference_numpy(q, k, v,
                                                           causal=True))


def test_sharded_paged_decode_model_axis(world):
    """Heads sharded 4-way, batch 2-way; no ctx sharding."""
    case, got = world["paged_model"]
    q, kp, vp, bt, lens = (_np(case, i) for i in range(5))
    fn = make_sharded_paged_attention(make_mesh((2, 4), ("data", "model")),
                                      ctx_axis=None,
                                      pages_per_compute_block=4)
    jgot = fn(*map(jnp.asarray, (q, kp, vp, bt, lens)))
    assert_close(got["out"], np.asarray(jgot), *TOL, "paged (model) vs JAX")
    want = paged_attention_reference(q, kp, vp, bt[:, 0], lens[:, 0])
    assert_close(got["out"], np.asarray(want), *TOL, "paged (model) vs oracle")


def test_sharded_paged_decode_ctx_axis(world):
    """Pages sharded 4-way over ctx: the cross-shard softmax combine
    rebuilds each sequence's full-attention output."""
    case, got = world["paged_ctx"]
    q, k_pool, v_pool, bt, lens, order = _paged_ctx_inputs(7)
    fn = make_sharded_paged_attention(
        make_mesh((2, 4), ("model", "ctx")), data_axis=None,
        model_axis="model", ctx_axis="ctx", pages_per_compute_block=2)
    jgot = np.asarray(fn(*map(jnp.asarray, (q, k_pool, v_pool, bt, lens))))
    assert_close(got["out"], jgot, *TOL, "paged (ctx) vs JAX")
    out = got["out"].numpy()
    for b, pages in enumerate(order):
        kf, vf = _full_kv(k_pool, v_pool, pages)
        want = attention_reference_numpy(q[b:b + 1, :, None, :], kf[None],
                                         vf[None])[0, :, 0]
        assert_close(out[b], want, *TOL, f"ctx-sharded seq {b}")


def test_sharded_paged_decode_fused_ctx_axis(world):
    """Fused pools over ctx with batch over data, plain and int8 (packed
    scales sharded with their pages)."""
    q, k_pool, v_pool, bt, lens, order = _paged_ctx_inputs(11)
    mesh = make_mesh((2, 4), ("data", "ctx"))
    _, got = world["fused_ctx"]
    kv = to_fused_layout(jnp.asarray(k_pool), jnp.asarray(v_pool))
    fn = make_sharded_paged_attention_fused(
        mesh, data_axis="data", ctx_axis="ctx", pages_per_compute_block=2)
    jgot = np.asarray(fn(jnp.asarray(q), kv, jnp.asarray(bt),
                         jnp.asarray(lens)))
    assert_close(got["out"], jgot, *TOL, "fused ctx vs JAX")
    for b, pages in enumerate(order):
        kf, vf = _full_kv(k_pool, v_pool, pages)
        want = attention_reference_numpy(q[b:b + 1, :, None, :], kf[None],
                                         vf[None])[0, :, 0]
        assert_close(got["out"][b], want, *TOL, f"fused ctx-sharded seq {b}")

    _, gotq = world["fused_ctx_int8"]
    kq, ks = quantize_kv(jnp.asarray(k_pool), jnp.int8)
    vq, vs = quantize_kv(jnp.asarray(v_pool), jnp.int8)
    kvq, sc = to_fused_layout(kq, vq, ks, vs)
    fnq = make_sharded_paged_attention_fused(
        mesh, data_axis="data", ctx_axis="ctx", quantized=True,
        pages_per_compute_block=2)
    jgotq = np.asarray(fnq(jnp.asarray(q), kvq, jnp.asarray(bt),
                           jnp.asarray(lens), sc))
    kd = np.asarray(dequantize_kv(kq, ks))
    vd = np.asarray(dequantize_kv(vq, vs))
    for b, pages in enumerate(order):
        kf, vf = _full_kv(kd, vd, pages)
        want = attention_reference_numpy(q[b:b + 1, :, None, :], kf[None],
                                         vf[None])[0, :, 0]
        # the int8 dot-product pipeline (q and p quantized) and bf16
        # packed scales: JAX's own tolerance against the oracle
        assert_close(gotq["out"][b], want, 5e-2, 2e-2,
                     f"fused ctx-sharded int8 seq {b}")
        assert_close(gotq["out"][b], jgotq[b], 5e-2, 2e-2,
                     f"fused ctx-sharded int8 seq {b} vs JAX")


def test_context_parallel_grads_match_oracle(world):
    fn = make_context_parallel_attention(make_mesh((8,), ("ctx",)))
    _check_grads(world, "cp_grads", fn,
                 lambda q, k, v: attention_reference(q, k, v), "cp")


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_grads_match_oracle(world, causal):
    fn = make_ring_attention(make_mesh((8,), ("ctx",)), causal=causal)
    _check_grads(world, f"ring_grads_{causal}", fn,
                 lambda q, k, v: attention_reference(q, k, v, causal=causal),
                 f"ring causal={causal}")


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_oracle(world, causal):
    fn = make_ulysses_attention(make_mesh((8,), ("ctx",)), causal=causal)
    _check_dense(world, f"ulysses_{causal}", fn, f"ulysses causal={causal}",
                 lambda q, k, v: attention_reference_numpy(q, k, v,
                                                           causal=causal))


def test_ulysses_gqa_and_window(world):
    """The GQA group mapping survives the all-to-all and the window needs
    no chunk decomposition."""
    fn = make_ulysses_attention(make_mesh((2, 4), ("data", "ctx")),
                                causal=True, window_size=64, seq_axis="ctx")
    _check_dense(world, "ulysses_gqa_window", fn, "ulysses gqa+window",
                 lambda q, k, v: attention_reference_numpy(
                     q, k, v, causal=True, window_size=64))


def test_ulysses_grads_match_oracle(world):
    fn = make_ulysses_attention(make_mesh((8,), ("ctx",)), causal=True)
    _check_grads(world, "ulysses_grads", fn,
                 lambda q, k, v: attention_reference(q, k, v, causal=True),
                 "ulysses")


def test_ulysses_rejects_indivisible_heads(world):
    """4 heads over 8 ranks: both packages raise ValueError."""
    case, got = world["ulysses_indivisible"]
    assert "divisible" in got["error"], got
    fn = make_ulysses_attention(make_mesh((8,), ("ctx",)))
    with pytest.raises(ValueError, match="divisible"):
        _jax_dense(fn, case)
