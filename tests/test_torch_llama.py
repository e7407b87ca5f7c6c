"""Llama model of the PyTorch port against the JAX package.

`LlamaConfig.tiny()` in f32: the JAX params cross over with
`load_jax_params`, and `forward` (logits and the returned rotated K / V)
and `decode_step_fused` (logits and pools) agree with aule_tpu's at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.models import llama as jllama
from aule_tpu.ops.paged_fused import fused_pool_shape
from aule_tpu.ops.rope import precompute_rope_frequencies as jrope
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.ops.flash import flash_attention_fwd_plain
from aule_tpu_torch.ops.rope import precompute_rope_frequencies as trope
from aule_tpu_torch.utils.testing import assert_close

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
    b = tllama.forward(tp, tokens, TCFG, attention=flash_attention_fwd_plain)
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


def test_forward_refuses_grad(params):
    _, tp = params
    grad = dict(tp, lm_head=tp["lm_head"].clone().requires_grad_(True))
    with pytest.raises(NotImplementedError):
        tllama.forward(grad, torch.zeros(1, 4, dtype=torch.long), TCFG)
