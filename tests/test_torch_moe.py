"""Mixture-of-Experts model of the PyTorch port (models/moe.py) against the
JAX package's (aule_tpu/models/moe.py), at `MoEConfig.tiny()` in f32 with
JAX's params carried across (`load_jax_params`).

  * `_gating` against JAX's, with ties planted among the router logits
    (exact integer arithmetic, so both packages see the same ties): the
    lower expert index wins in both;
  * `forward` logits and the load-balancing aux loss within 1e-5;
  * every gradient of `loss_fn` within 1e-5 of jax.grad's;
  * two SGD `train_step`s (loss and params) within 1e-5;
  * `ServingEngine(model=moe)` token-identical to JAX's engine, over f32,
    int8 and fp8 fused pools, whole-prompt and chunked;
  * `forward` and `prefill_step_fused` with LoRA adapters within 1e-5;
  * `layout="split"` and `mesh=` raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.models import moe as jmoe
from aule_tpu.serving.engine import ServingEngine as JaxEngine
from aule_tpu_torch.models import moe as tmoe
from aule_tpu_torch.serving.engine import ServingEngine
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads
from aule_tpu_torch.utils.tree import tree_flatten

cap_cpu_threads()

JCFG = jmoe.MoEConfig.tiny()
TCFG = tmoe.MoEConfig.tiny()
TOL = 1e-5
KW = dict(max_batch=2, page_size=16, num_pages=64, max_pages_per_seq=8,
          max_seq_len=256, decode_steps=4)


@pytest.fixture(scope="module")
def params():
    jp = jmoe.init_params(JCFG, jax.random.key(0))
    return jp, tmoe.load_jax_params(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (b, s)).astype(np.int32)


def test_config_mirrors_jax():
    for name in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                 "hidden_dim", "rope_base", "norm_eps", "n_experts", "top_k",
                 "head_dim", "window_size"):
        assert getattr(TCFG, name) == getattr(JCFG, name), name
        big_t, big_j = tmoe.MoEConfig.mixtral_8x7b(), \
            jmoe.MoEConfig.mixtral_8x7b()
        assert getattr(big_t, name) == getattr(big_j, name), name
    assert big_t.dtype == torch.bfloat16


def test_init_params_shapes(params):
    jp, _ = params
    p = tmoe.init_params(TCFG, torch.Generator().manual_seed(1),
                         device="cpu")
    jshapes = [tuple(a.shape) for a in jax.tree.leaves(jp)]
    assert [tuple(t.shape) for t in tree_flatten(p)] == jshapes
    assert p["layers"][0].keys() == jp["layers"][0].keys()


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_gating_matches_jax_with_ties(top_k):
    """Integer-valued x and router make every logit exact in both
    packages; routers with repeated columns plant ties at every rank."""
    rng = np.random.default_rng(top_k)
    e = 6
    x = rng.integers(-1, 2, (40, 16)).astype(np.float32)
    router = rng.integers(-2, 3, (16, e)).astype(np.float32)
    router[:, 3] = router[:, 1]   # experts 1 and 3 always tie
    router[:, 5] = router[:, 0]   # and 0 and 5
    jcfg = jmoe.MoEConfig.tiny(n_experts=e, top_k=top_k)
    tcfg = tmoe.MoEConfig.tiny(n_experts=e, top_k=top_k)
    jw, jl = jmoe._gating({"router": jnp.asarray(router)}, jnp.asarray(x),
                          jcfg)
    tw, tl = tmoe._gating({"router": torch.from_numpy(router)},
                          torch.from_numpy(x), tcfg)
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    picked_t = tw.numpy() > 0
    picked_j = np.asarray(jw) > 0
    assert np.array_equal(picked_t, picked_j)
    assert (picked_t.sum(-1) == top_k).all()
    # ties at the cut go to the lower index: expert 3 is never chosen
    # without expert 1, nor 5 without 0
    assert not (picked_t[:, 3] & ~picked_t[:, 1]).any()
    assert not (picked_t[:, 5] & ~picked_t[:, 0]).any()
    tied = (tl[:, 1] == tl[:, 3]).all() and (tl[:, 0] == tl[:, 5]).all()
    assert tied
    assert_close(tw, np.asarray(jw), 0, 1e-6, "weights")


def test_forward_logits_and_aux(params):
    jp, tp = params
    tokens = _tokens(2, 24)
    jl, jkv, jaux = jmoe.forward(jp, jnp.asarray(tokens), JCFG,
                                 return_kv=True, return_aux=True)
    tl, tkv, taux = tmoe.forward(tp, torch.from_numpy(tokens).long(), TCFG,
                                 return_kv=True, return_aux=True)
    assert_close(tl, np.asarray(jl), 0, TOL, "logits")
    assert abs(float(taux) - float(jaux)) <= TOL
    assert float(taux) >= 0.9
    for li, ((jk, jv), (tk, tv)) in enumerate(zip(jkv, tkv)):
        assert_close(tk, np.asarray(jk), 0, TOL, f"k{li}")
        assert_close(tv, np.asarray(jv), 0, TOL, f"v{li}")
    only = tmoe.forward(tp, torch.from_numpy(tokens).long(), TCFG)
    assert torch.equal(only, tl)


def test_moe_mlp_matches_manual_topk(params):
    """The dense mixture equals a per-token evaluation of its top-k
    experts (tests/test_moe.py:37's check)."""
    _, tp = params
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 6, TCFG.dim)).astype(
        np.float32))
    layer = tp["layers"][0]
    got = tmoe._moe_mlp_dense(layer, x, TCFG)[0]
    logits = x[0] @ layer["router"]
    for t in range(6):
        vals, idx = torch.topk(logits[t], TCFG.top_k)
        g = torch.softmax(vals, -1)
        want = sum(w * ((torch.nn.functional.silu(x[0, t] @ layer["e_gate"][e])
                         * (x[0, t] @ layer["e_up"][e])) @ layer["e_down"][e])
                   for w, e in zip(g, idx))
        assert_close(got[t], want, 1e-4, 1e-4, f"token {t}")


def test_loss_gradients_match_jax(params):
    jp, tp = params
    tokens = _tokens(2, 20, seed=2)
    jloss, jgrads = jax.value_and_grad(jmoe.loss_fn)(
        jp, jnp.asarray(tokens), JCFG)
    tensors = tree_flatten(tp)
    for t in tensors:
        t.requires_grad_(True)
    loss = tmoe.loss_fn(tp, torch.from_numpy(tokens).long(), TCFG)
    grads = torch.autograd.grad(loss, tensors)
    for t in tensors:
        t.requires_grad_(False)
    assert abs(float(loss.detach()) - float(jloss)) <= TOL
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for i, (g, jg) in enumerate(zip(grads, jleaves)):
        assert_close(g, np.asarray(jg), 0, TOL, f"gradient {i}")


def test_train_step_matches_jax(params):
    jp, _ = params
    tp = tmoe.load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = _tokens(4, 24, seed=4)
    jstep = jax.jit(lambda p, t: jmoe.train_step(p, t, JCFG, lr=5e-2))
    losses = []
    for _ in range(2):
        jp, jloss = jstep(jp, jnp.asarray(tokens))
        tp, tloss = tmoe.train_step(tp, torch.from_numpy(tokens).long(),
                                    TCFG, lr=5e-2)
        assert abs(float(tloss) - float(jloss)) <= TOL
        losses.append(float(tloss))
    for t, j in zip(tree_flatten(tp), jax.tree.leaves(jp)):
        assert_close(t.detach(), np.asarray(j), 0, TOL, "params")
        assert t.grad is None
    with torch.no_grad():
        after = float(tmoe.loss_fn(tp, torch.from_numpy(tokens).long(),
                                   TCFG))
    assert after < losses[0]


QDT = {"int8": (jnp.int8, torch.int8),
       "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("qname", [None, "int8", "fp8"])
def test_engine_token_identical_to_jax(params, qname, chunk):
    """Greedy serving through ServingEngine(model=moe): whole-prompt
    (the forward, then the pool append) or chunked prefill
    (prefill_step_fused), decode through decode_step_fused, three
    requests on two slots; the tokens equal JAX's engine's."""
    jp, tp = params
    jkw = dict(KW, prefill_chunk=chunk, model=jmoe)
    tkw = dict(KW, prefill_chunk=chunk, model=tmoe)
    if qname is not None:
        jkw.update(quantized=True, quant_dtype=QDT[qname][0])
        tkw.update(quantized=True, quant_dtype=QDT[qname][1])
    jeng = JaxEngine(jp, JCFG, **jkw)
    teng = ServingEngine(tp, TCFG, device="cpu", **tkw)
    rng = np.random.default_rng(6)
    news = (3, 5, 4)
    for n, new in zip((9, 15, 12), news):  # one prefill bucket in JAX
        p = rng.integers(0, JCFG.vocab_size, size=n).astype(np.int32)
        jeng.submit(p, new)
        teng.submit(p, new)
    jout = [r.output for r in jeng.run()]
    tout = [r.output for r in teng.run()]
    assert [len(o) for o in tout] == list(news)
    assert tout == jout
    assert teng.allocator.num_free == KW["num_pages"] - 1


def test_unported_forms_raise(params):
    _, tp = params
    with pytest.raises(ValueError, match="split"):
        ServingEngine(tp, TCFG, device="cpu", model=tmoe,
                      **dict(KW, layout="split"))
    tokens = torch.from_numpy(_tokens(1, 5)).long()
    # LoRA adapters under a mesh (mesh= alone: tests/test_torch_moe_ep.py
    # and test_torch_gpt2_tp.py)
    lora = dict(lora={"layers": []}, lora_idx=torch.zeros((1,),
                                                          dtype=torch.long))
    with pytest.raises(NotImplementedError, match="LoRA"):
        tmoe.forward(tp, tokens, TCFG, mesh=object(), **lora)
    with pytest.raises(NotImplementedError, match="LoRA"):
        tmoe.decode_step_fused(tp, None, None, None, None, None, TCFG, None,
                               None, mesh=object(), **lora)
    with pytest.raises(NotImplementedError):
        ServingEngine(tp, TCFG, device="cpu", model=jmoe, **KW)


@pytest.mark.parametrize("fn", ["forward", "prefill_step_fused"])
def test_lora_matches_jax(params, fn):
    """forward and a chunk of prefill_step_fused with a two-adapter bank on
    the attention's wq / wk / wv / wo (rows on adapter 2 and the base)
    within 1e-5 of JAX's: the logits and the pools written."""
    from aule_tpu.ops.paged_fused import fused_pool_shape
    from aule_tpu.ops.rope import precompute_rope_frequencies as jrope
    from aule_tpu_torch.ops.rope import precompute_rope_frequencies as trope

    jp, tp = params
    rng = np.random.default_rng(11)
    q = JCFG.n_heads * JCFG.head_dim
    kv = JCFG.n_kv_heads * JCFG.head_dim
    dims = {"wq": (JCFG.dim, q), "wk": (JCFG.dim, kv), "wv": (JCFG.dim, kv),
            "wo": (q, JCFG.dim)}
    bank = []
    for _ in range(JCFG.n_layers):
        entry = {}
        for t, (i, o) in dims.items():
            a = rng.standard_normal((3, i, 4)).astype(np.float32) * 0.2
            b = rng.standard_normal((3, 4, o)).astype(np.float32) * 0.2
            a[0] = b[0] = 0.0
            entry[t] = (a, b)
        bank.append(entry)

    def conv(f):
        return {"layers": [{t: tuple(f(m) for m in ab)
                            for t, ab in e.items()} for e in bank]}

    idx = np.array([2, 0], np.int32)
    jl = dict(lora=conv(jnp.asarray), lora_idx=jnp.asarray(idx))
    tl = dict(lora=conv(torch.from_numpy), lora_idx=torch.from_numpy(idx))
    tokens = _tokens(2, 9, seed=12)
    if fn == "forward":
        want = jmoe.forward(jp, jnp.asarray(tokens), JCFG, **jl)
        got = tmoe.forward(tp, torch.from_numpy(tokens).long(), TCFG, **tl)
        assert_close(got, np.asarray(want), 0, TOL, "lora forward")
        return
    shape = fused_pool_shape(8, JCFG.n_kv_heads, 16, JCFG.head_dim)
    pools = np.stack([(rng.standard_normal(shape) * 0.1).astype(np.float32)
                      for _ in range(JCFG.n_layers)])
    bt = np.array([[1, 2, -1], [3, 4, 5]], np.int32)
    hist = np.array([14, 30], np.int32)
    slens = np.array([9, 5], np.int32)
    jc, js = jrope(64, JCFG.head_dim, JCFG.rope_base)
    tc, ts = trope(64, TCFG.head_dim, TCFG.rope_base)
    jout = jmoe.prefill_step_fused(
        jp, jnp.asarray(tokens), jnp.asarray(hist), jnp.asarray(slens),
        [jnp.asarray(p) for p in pools], jnp.asarray(bt), JCFG, jc, js, **jl)
    tpools = torch.from_numpy(pools.copy())
    tout = tmoe.prefill_step_fused(
        tp, torch.from_numpy(tokens).long(), torch.from_numpy(hist),
        torch.from_numpy(slens), tpools, torch.from_numpy(bt), TCFG, tc, ts,
        **tl)
    assert_close(tout[0], np.asarray(jout[0]), 0, TOL, "lora prefill")
    for li in range(JCFG.n_layers):
        assert_close(tpools[li], np.asarray(jout[1][li]), 0, TOL,
                     f"pool{li}")
