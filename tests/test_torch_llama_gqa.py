"""Llama at a GQA group the TPU kernels pad (3 q heads a kv head) and the
windowed Mistral preset: the PyTorch port against the JAX package and its
own plain forward.

A tiny Llama with 6 q heads over 2 kv heads (head dim 64, as JAX's paged
kernels take), f32: `forward`, `decode_step_fused` and `prefill_step_fused`
agree with aule_tpu's at 1e-4 (logits and pools, as
tests/test_torch_llama.py holds the group-2 model).  The port's engine at
that group, and at `tiny(window_size=24)` (tests/test_model.py:177-204's
Mistral-style check, there marked slow, here at the port's plain versions),
generates exactly the greedy tokens of a full forward over the growing
sequence, fused whole-prompt and with `prefill_chunk=16`, and over split
pools.  `LlamaConfig.mistral_7b()` mirrors JAX's preset field by field.
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
from aule_tpu_torch.ops.rope import precompute_rope_frequencies as trope
from aule_tpu_torch.serving.engine import ServingEngine
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()

GQA3 = dict(dim=384, n_heads=6, n_kv_heads=2)
JCFG = jllama.LlamaConfig.tiny(**GQA3)
TCFG = tllama.LlamaConfig.tiny(**GQA3)
ATOL = 1e-4
ENGINE_KW = dict(max_batch=2, page_size=16, num_pages=64, max_pages_per_seq=8,
                 max_seq_len=256, decode_steps=4)
FIELDS = ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
          "hidden_dim", "rope_base", "norm_eps", "window_size", "head_dim")


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(JCFG, jax.random.key(3))
    tp = tllama.load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def test_config_group_three():
    assert TCFG.n_heads // TCFG.n_kv_heads == 3 and TCFG.head_dim == 64
    for name in FIELDS:
        assert getattr(TCFG, name) == getattr(JCFG, name), name


def test_mistral_preset_mirrors_jax():
    t, j = tllama.LlamaConfig.mistral_7b(), jllama.LlamaConfig.mistral_7b()
    for name in FIELDS:
        assert getattr(t, name) == getattr(j, name), name
    assert (t.vocab_size, t.dim, t.n_layers, t.n_heads, t.n_kv_heads,
            t.hidden_dim, t.rope_base, t.window_size) == (
                32000, 4096, 32, 32, 8, 14336, 10000.0, 4096)
    assert t.dtype == torch.bfloat16


def test_forward_logits_and_kv(params):
    jp, tp = params
    tokens = np.random.default_rng(0).integers(
        0, JCFG.vocab_size, size=(2, 24)).astype(np.int32)
    jl, jkv = jllama.forward(jp, jnp.asarray(tokens), JCFG, return_kv=True)
    tl, tkv = tllama.forward(tp, torch.from_numpy(tokens).long(), TCFG,
                             return_kv=True)
    assert_close(tl, np.asarray(jl), 0, ATOL, "logits")
    for li, ((jk, jv), (tk, tv)) in enumerate(zip(jkv, tkv)):
        assert_close(tk, np.asarray(jk), 0, ATOL, f"k{li}")
        assert_close(tv, np.asarray(jv), 0, ATOL, f"v{li}")


def _pools(seed):
    rng = np.random.default_rng(seed)
    shape = fused_pool_shape(16, JCFG.n_kv_heads, 16, JCFG.head_dim)
    return [rng.standard_normal(shape).astype(np.float32) * 0.1
            for _ in range(JCFG.n_layers)]


def test_decode_step_fused(params):
    jp, tp = params
    pools = _pools(1)
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


def test_prefill_step_fused(params):
    """A ragged chunk (padding rows in sequence 1) over history: the last
    valid token's logits and the pools."""
    jp, tp = params
    pools = _pools(3)
    jk = [jnp.asarray(p) for p in pools]
    tk = torch.from_numpy(np.stack(pools))
    bt = np.array([[1, 2, -1, -1], [3, 4, 5, -1]], np.int32)
    hist = np.array([20, 33], np.int32)
    tokens = np.random.default_rng(5).integers(
        0, JCFG.vocab_size, size=(2, 12)).astype(np.int32)
    slens = np.array([12, 7], np.int32)
    jc, js = jrope(64, JCFG.head_dim, JCFG.rope_base)
    tc, ts = trope(64, TCFG.head_dim, TCFG.rope_base)
    jout = jllama.prefill_step_fused(
        jp, jnp.asarray(tokens), jnp.asarray(hist), jnp.asarray(slens), jk,
        jnp.asarray(bt), JCFG, jc, js)
    tout = tllama.prefill_step_fused(
        tp, torch.from_numpy(tokens).long(), torch.from_numpy(hist),
        torch.from_numpy(slens), tk, torch.from_numpy(bt), TCFG, tc, ts)
    assert_close(tout[0], np.asarray(jout[0]), 0, ATOL, "last logits")
    assert tout[2].tolist() == np.asarray(jout[2]).tolist()
    for li in range(JCFG.n_layers):
        assert_close(tk[li], np.asarray(jout[1][li]), 0, ATOL, f"pool{li}")


def _oracle(tp, cfg, prompt, steps):
    """Greedy tokens of the full forward (the plain flash version on the
    CPU) over the growing sequence."""
    seq, out = list(prompt), []
    with torch.no_grad():
        for _ in range(steps):
            logits = tllama.forward(tp, torch.tensor([seq]), cfg)
            out.append(int(logits[0, -1].argmax()))
            seq.append(out[-1])
    return out


# (fused whole-prompt, fused prefill_chunk=16, split whole-prompt): split
# pools take no chunked prefill, as in JAX's engine
ENGINE_RUNS = {"fused whole": {}, "fused chunk 16": {"prefill_chunk": 16},
               "split whole": {"layout": "split"}}


@pytest.mark.parametrize("run", sorted(ENGINE_RUNS))
@pytest.mark.parametrize("model", ["group 3", "window 24"])
def test_engine_matches_full_forward(params, model, run):
    """Engine tokens equal the full-forward oracle's: the group-3 model
    (a 21-token prompt) and the windowed tiny model (a 40-token prompt,
    so the window of 24 bites in both the prefill and the decode), with
    multi-step decode and two requests sharing the batch."""
    if model == "group 3":
        cfg, tp = TCFG, params[1]
    else:
        cfg = tllama.LlamaConfig.tiny(window_size=24)
        gen = torch.Generator().manual_seed(2)
        tp = tllama.init_params(cfg, gen, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (40, 21)]
    steps = 6
    eng = ServingEngine(tp, cfg, device="cpu", **ENGINE_KW,
                        **ENGINE_RUNS[run])
    for p in prompts:
        eng.submit(p, steps)
    outs = [r.output for r in eng.run()]
    assert outs == [_oracle(tp, cfg, p, steps) for p in prompts]
    assert eng.allocator.num_free == ENGINE_KW["num_pages"] - 1
