"""GPT-2 model family of the PyTorch port against the JAX package.

`GPT2Config.tiny()` in f32 (head_dim 64, so the fused pools pad D to 128
lanes): the JAX params cross over with `load_jax_params`; `forward` agrees
with aule_tpu's (JAX's matmuls pinned to "highest", as tests/test_gpt2.py
does) within 2e-4 (logits) and 1e-5 (the returned K / V); and the serving
engine with `model=gpt2` is token-identical to aule_tpu's
`ServingEngine(model=gpt2)` with whole-prompt and chunked prefill over f32,
int8 and fp8 pools, and refuses what JAX's refuses.  The port runs its
kernels' plain versions here (device="cpu"); JAX runs its Pallas kernels in
interpret mode.  `decode_step_fused` and `prefill_step_fused` are held to
JAX's in tests/test_torch_gpt2_steps.py (a file of their own: with them,
JAX's compiles would hold one test worker over a minute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.models import gpt2 as jgpt2
from aule_tpu.serving.engine import ServingEngine as JaxEngine
from aule_tpu_torch.models import gpt2 as tgpt2
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.serving.engine import ServingEngine
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()

JCFG = jgpt2.GPT2Config.tiny()
TCFG = tgpt2.GPT2Config.tiny()
QDTYPES = {"int8": (jnp.int8, torch.int8),
           "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


@pytest.fixture(scope="module")
def params():
    jp = jgpt2.init_params(JCFG, jax.random.key(0))
    tp = tgpt2.load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def test_config_mirrors_jax():
    for name in ("vocab_size", "n_ctx", "dim", "n_layers", "n_heads",
                 "norm_eps", "head_dim", "n_kv_heads", "hidden_dim",
                 "rope_base"):
        for j, t in ((jgpt2.GPT2Config(), tgpt2.GPT2Config()),
                     (JCFG, TCFG)):
            assert getattr(j, name) == getattr(t, name), name
    assert TCFG.dtype == torch.float32 and TCFG.head_dim == 64


def test_load_jax_params(params):
    """Every JAX parameter crosses over unchanged (w_qkv qkv-major), and
    `dtype` recasts them all."""
    jp, tp = params
    flat_j = jax.tree.leaves(jp)
    flat_t = list(tgpt2._tensors(tp))
    assert len(flat_j) == len(flat_t)
    assert tp["layers"][0]["w_qkv"].shape == (3, TCFG.dim, TCFG.dim)
    for name in ("wte", "wpe", "final_ln_g"):
        assert np.array_equal(tp[name].numpy(), np.asarray(jp[name]))
    for name, a in jp["layers"][1].items():
        assert np.array_equal(tp["layers"][1][name].numpy(), np.asarray(a))
    bf = tgpt2.load_jax_params(jax.tree.map(np.asarray, jp), device="cpu",
                               dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in tgpt2._tensors(bf))


def test_init_params_shapes_and_seed():
    def make(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return tgpt2.init_params(TCFG, g, device="cpu")

    a, b, c = make(0), make(0), make(1)
    jp = jgpt2.init_params(JCFG, jax.random.key(0))
    for name in ("wte", "wpe", "final_ln_g", "final_ln_b"):
        assert tuple(a[name].shape) == jp[name].shape, name
    for name, x in jp["layers"][0].items():
        assert tuple(a["layers"][0][name].shape) == x.shape, name
    assert len(a["layers"]) == TCFG.n_layers
    assert all(torch.equal(x, y) for x, y in
               zip(tgpt2._tensors(a), tgpt2._tensors(b)))
    assert not torch.equal(a["wte"], c["wte"])
    assert abs(float(a["wte"].std()) - TCFG.dim ** -0.5) < 0.01


def test_forward_matches_jax(params):
    jp, tp = params
    tokens = np.random.default_rng(0).integers(0, 256, size=(2, 24))
    with jax.default_matmul_precision("highest"):
        jl, jkv = jgpt2.forward(jp, jnp.asarray(tokens, jnp.int32), JCFG,
                                return_kv=True)
    tl, tkv = tgpt2.forward(tp, torch.from_numpy(tokens), TCFG,
                            return_kv=True)
    assert tl.dtype == torch.float32
    assert_close(tl, np.asarray(jl), 2e-4, 2e-4, "logits")
    for (tk, tv), (jk, jv) in zip(tkv, jkv):
        assert_close(tk, np.asarray(jk), 0, 1e-5, "k")
        assert_close(tv, np.asarray(jv), 0, 1e-5, "v")
    # explicit positions (JAX's `positions=`) move the learned embeddings
    pos = np.tile(np.arange(5, 29), (2, 1))
    with jax.default_matmul_precision("highest"):
        jl2 = jgpt2.forward(jp, jnp.asarray(tokens, jnp.int32), JCFG,
                            positions=jnp.asarray(pos, jnp.int32))
    tl2 = tgpt2.forward(tp, torch.from_numpy(tokens), TCFG,
                        positions=torch.from_numpy(pos))
    assert_close(tl2, np.asarray(jl2), 2e-4, 2e-4, "logits at positions")


KW = dict(max_batch=2, page_size=16, num_pages=64, max_pages_per_seq=8,
          max_seq_len=256, decode_steps=4)


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("qname", [None, "int8", "fp8"])
def test_engine_token_identical_to_jax(params, qname, chunk):
    """Greedy serving of two prompts (one 32-token bucket in JAX's engine)
    with whole-prompt or chunked prefill over f32, int8 or fp8 pools."""
    jp, tp = params
    jkw, tkw = dict(KW, prefill_chunk=chunk), dict(KW, prefill_chunk=chunk)
    if qname is not None:
        jkw.update(quantized=True, quant_dtype=QDTYPES[qname][0])
        tkw.update(quantized=True, quant_dtype=QDTYPES[qname][1])
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (19, 30)]
    jeng = JaxEngine(jp, JCFG, model=jgpt2, **jkw)
    teng = ServingEngine(tp, TCFG, model=tgpt2, device="cpu", **tkw)
    want = [torch.float32, torch.float32] if qname is None else [
        QDTYPES[qname][1], torch.bfloat16]
    assert [teng.kv_pages.dtype, (teng.kv_scales if qname else
                                  teng.kv_pages).dtype] == want
    assert teng.kv_pages.shape[-1] == 128  # D 64 padded to 128 lanes
    for p in prompts:
        jeng.submit(p, 4)
        teng.submit(p, 4)
    jout = [r.output for r in jeng.run()]
    tout = [r.output for r in teng.run()]
    assert [len(o) for o in tout] == [4, 4]
    assert tout == jout


def test_engine_refusals(params):
    """max_seq_len past the learned-position table raises ValueError (as
    JAX's engine), so does the split layout (no decode over split pools);
    a model module of another package and LoRA adapters with mesh= on the
    model raise NotImplementedError (mesh= alone: tests/test_torch_gpt2_tp.py)."""
    _, tp = params
    kw = dict(KW, max_pages_per_seq=32)
    with pytest.raises(ValueError, match="n_ctx"):
        ServingEngine(tp, TCFG, model=tgpt2, device="cpu",
                      **dict(kw, max_seq_len=TCFG.n_ctx + 64))
    with pytest.raises(ValueError, match="split"):
        ServingEngine(tp, TCFG, model=tgpt2, device="cpu", layout="split",
                      **KW)
    with pytest.raises(NotImplementedError):
        ServingEngine(tp, TCFG, model=jgpt2, device="cpu", **KW)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="LoRA"):
        tgpt2.forward(tp, tokens, TCFG, mesh=object(), lora={"layers": []},
                      lora_idx=torch.zeros((1,), dtype=torch.long))
    # the default family is still Llama
    lp = tllama.init_params(tllama.LlamaConfig.tiny(), torch.Generator(),
                            device="cpu")
    eng = ServingEngine(lp, tllama.LlamaConfig.tiny(), device="cpu", **KW)
    assert eng.model is tllama


def test_forward_with_lora_matches_jax(params):
    """forward with a two-adapter bank on wq / wk / wv (w_qkv's slices) and
    wo (w_proj), rows on adapter 1, the base and adapter 2, against JAX's
    under "highest" matmuls (2e-4, as forward's)."""
    jp, tp = params
    rng = np.random.default_rng(9)
    bank = []
    for _ in range(JCFG.n_layers):
        entry = {}
        for t in ("wq", "wk", "wv", "wo"):
            a = rng.standard_normal((3, JCFG.dim, 4)).astype(np.float32) * .2
            b = rng.standard_normal((3, 4, JCFG.dim)).astype(np.float32) * .2
            a[0] = b[0] = 0.0
            entry[t] = (a, b)
        bank.append(entry)
    idx = np.array([1, 0, 2], np.int32)
    tokens = rng.integers(0, JCFG.vocab_size, (3, 10)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want = jgpt2.forward(
            jp, jnp.asarray(tokens), JCFG, lora={"layers": [
                {t: tuple(jnp.asarray(m) for m in ab) for t, ab in e.items()}
                for e in bank]}, lora_idx=jnp.asarray(idx))
    got = tgpt2.forward(
        tp, torch.from_numpy(tokens).long(), TCFG, lora={"layers": [
            {t: tuple(torch.from_numpy(m) for m in ab) for t, ab in e.items()}
            for e in bank]}, lora_idx=torch.from_numpy(idx))
    assert_close(got, np.asarray(want), 0, 2e-4, "lora logits")
    plain = tgpt2.forward(tp, torch.from_numpy(tokens).long(), TCFG)
    assert torch.equal(got[1], plain[1])  # the base row is untouched
    assert not torch.allclose(got[0], plain[0])
