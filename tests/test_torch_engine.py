"""Serving engine of the PyTorch port against the JAX package's engine.

On the same tiny f32 params (carried across with `load_jax_params`), greedy
decoding through the port's engine (device='cpu': the kernels' plain
versions) is token-identical to aule_tpu's engine, with admission waiting
for retirements and multi-step decode on, with bf16/f32, int8 and fp8 pools
in the fused layout with whole-prompt or chunked prefill, and in the split
layout with whole-prompt prefill.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.models import llama as jllama
from aule_tpu.serving.engine import ServingEngine as JaxEngine
from aule_tpu_torch.models import gpt2 as tgpt2
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.models import moe as tmoe
from aule_tpu_torch.serving import sampling
from aule_tpu_torch.serving.engine import ServingEngine
from aule_tpu_torch.utils.testing import cap_cpu_threads

cap_cpu_threads()

JCFG = jllama.LlamaConfig.tiny()
TCFG = tllama.LlamaConfig.tiny()
KW = dict(max_batch=2, page_size=16, num_pages=64, max_pages_per_seq=8,
          max_seq_len=256, decode_steps=4)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(JCFG, jax.random.key(0))
    return jp, tllama.load_jax_params(jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, size=n).astype(np.int32)
            for n in (5, 21, 9)]


def test_greedy_token_identical_to_jax(params):
    jp, tp = params
    news = (6, 11, 7)
    jeng = JaxEngine(jp, JCFG, **KW)
    teng = ServingEngine(tp, TCFG, device="cpu", **KW)
    for p, n in zip(_prompts(), news):
        jeng.submit(p, n)
        teng.submit(p, n)
    jout = [r.output for r in jeng.run()]
    tout = [r.output for r in teng.run()]
    assert [len(o) for o in tout] == list(news)
    assert tout == jout
    st = teng.stats()
    assert st["prefill_dispatches"] == 3
    assert st["tokens_generated"] == sum(news)
    # 3 requests on 2 slots: the third was admitted after a retirement
    assert st["decode_steps"] >= max(news) - 1


QDT = {"int8": (jnp.int8, torch.int8),
       "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _engines(params, qname, chunk):
    jp, tp = params
    jkw = dict(KW, prefill_chunk=chunk)
    tkw = dict(KW, prefill_chunk=chunk)
    if qname is not None:
        jkw.update(quantized=True, quant_dtype=QDT[qname][0])
        tkw.update(quantized=True, quant_dtype=QDT[qname][1])
    return JaxEngine(jp, JCFG, **jkw), ServingEngine(tp, TCFG, device="cpu",
                                                     **tkw)


def _chunk_prompts():
    rng = np.random.default_rng(6)
    return [rng.integers(0, 256, size=n).astype(np.int32)
            for n in (23, 8, 40)]


@pytest.mark.parametrize("qname", [None, "int8", "fp8"])
def test_chunked_quantized_token_identical_to_jax(params, qname):
    """prefill_chunk=8 with f32, int8 (int8 dot-product decode, the
    default) and fp8 pools: greedy tokens identical to aule_tpu's engine
    with the same options.  (The int8 path quantizes p over other token
    spans than the JAX kernel; on these inputs no token differs, so no
    near-tie allowance is used.)"""
    jeng, teng = _engines(params, qname, 8)
    news = (6, 9, 5)
    for p, n in zip(_chunk_prompts(), news):
        jeng.submit(p, n)
        teng.submit(p, n)
    jout = [r.output for r in jeng.run()]
    tout = [r.output for r in teng.run()]
    assert tout == jout
    st = teng.stats()
    # 23, 8 and 40 prompt tokens in chunks of 8: 3 + 1 + 5 dispatches
    assert st["prefill_dispatches"] == 9
    assert teng.allocator.num_free == KW["num_pages"] - 1
    if qname is not None:
        assert teng.kv_pages.dtype == QDT[qname][1]
        assert tuple(teng.kv_scales.shape) == (TCFG.n_layers, 64, 16, 128)
        assert teng.kv_scales.dtype == torch.bfloat16


@pytest.mark.parametrize("qname", [None, "int8", "fp8"])
def test_chunked_matches_whole_prompt(params, qname):
    """The port's engine with prefill_chunk=8 generates the tokens it
    generates with whole-prompt prefill (tests/test_engine_quantized.py:
    96-117's check, on the port alone)."""
    outs = {}
    for chunk in (None, 8):
        _, eng = _engines(params, qname, chunk)
        for p in _chunk_prompts():
            eng.submit(p, 6)
        outs[chunk] = [r.output for r in eng.run()]
    assert outs[None] == outs[8]


@pytest.mark.parametrize("qname", [None, "int8", "fp8"])
def test_split_layout_token_identical_to_jax(params, qname):
    """layout='split' (head-major pools, f32 scales when quantized; the
    exact scale-folded decode) with whole-prompt prefill: greedy tokens
    identical to aule_tpu's engine with the same options, with admission
    waiting for retirements and multi-step decode on."""
    jp, tp = params
    jkw = dict(KW, layout="split")
    tkw = dict(KW, layout="split")
    if qname is not None:
        jkw.update(quantized=True, quant_dtype=QDT[qname][0])
        tkw.update(quantized=True, quant_dtype=QDT[qname][1])
    jeng = JaxEngine(jp, JCFG, **jkw)
    teng = ServingEngine(tp, TCFG, device="cpu", **tkw)
    news = (6, 11, 7)
    for p, n in zip(_prompts(), news):
        jeng.submit(p, n)
        teng.submit(p, n)
    jout = [r.output for r in jeng.run()]
    tout = [r.output for r in teng.run()]
    assert [len(o) for o in tout] == list(news)
    assert tout == jout
    assert teng.kv_pages is None and teng.kv_scales is None
    shape = (TCFG.n_layers, TCFG.n_kv_heads, 64, 16, TCFG.head_dim)
    assert tuple(teng.k_pages.shape) == tuple(teng.v_pages.shape) == shape
    if qname is not None:
        assert teng.k_pages.dtype == QDT[qname][1]
        assert teng.k_scales.dtype == torch.float32
        assert tuple(teng.v_scales.shape) == shape[:-1]
        assert teng.k_scales.data_ptr() != teng.v_scales.data_ptr()
    assert teng.allocator.num_free == KW["num_pages"] - 1


def test_quantized_engine_bad_options(params):
    _, tp = params
    with pytest.raises(ValueError):
        ServingEngine(tp, TCFG, device="cpu", quantized=True,
                      quant_dtype=torch.float16, **KW)
    with pytest.raises(ValueError):
        ServingEngine(tp, TCFG, device="cpu", prefill_chunk=0, **KW)


def test_split_layout_bad_options(params):
    """As JAX's engine: chunked prefill needs the fused layout, and an
    unknown layout is refused."""
    jp, tp = params
    with pytest.raises(ValueError):
        JaxEngine(jp, JCFG, **dict(KW, layout="split", prefill_chunk=8))
    with pytest.raises(ValueError):
        ServingEngine(tp, TCFG, device="cpu", layout="split",
                      prefill_chunk=8, **KW)
    with pytest.raises(ValueError):
        ServingEngine(tp, TCFG, device="cpu", layout="paged", **KW)


def test_pages_return_after_run(params):
    _, tp = params
    eng = ServingEngine(tp, TCFG, device="cpu", **KW)
    free0 = eng.allocator.num_free
    assert free0 == KW["num_pages"] - 1  # page 0 is the scratch page
    for p in _prompts():
        eng.submit(p, 20)
    eng.run()
    assert eng.allocator.num_free == free0
    assert eng.slot_pages == [[], []]
    # a second round on the reused pages gives the same tokens
    again = ServingEngine(tp, TCFG, device="cpu", **KW)
    first = [again.submit(p, 5) for p in _prompts()]
    a = [r.output for r in again.run()]
    for p in _prompts():
        again.submit(p, 5)
    b = [r.output for r in again.run()]
    assert a == b and len(first) == 3


def test_oversized_request_rejected(params):
    _, tp = params
    eng = ServingEngine(tp, TCFG, device="cpu", **KW)
    with pytest.raises(ValueError):
        eng.submit(np.arange(120, dtype=np.int32), 10)  # 130 > 8 * 16
    with pytest.raises(ValueError):
        eng.submit(np.zeros(0, np.int32), 4)


@pytest.mark.parametrize("kw", [
    dict(model=types.SimpleNamespace(__name__="a module of no family")),
    dict(model=jllama),
    dict(model=jllama, ngram_spec=2)])
def test_unported_engine_options_raise(params, kw):
    """A model that is not a family of the port (a JAX module, or another
    module) raises, with or without an option; every family's mesh is
    served (tests/test_torch_tp_engine.py, test_torch_gpt2_tp.py)."""
    _, tp = params
    with pytest.raises(NotImplementedError):
        ServingEngine(tp, TCFG, device="cpu", **dict(KW, **kw))


@pytest.mark.parametrize("kw", [
    dict(quantized=True, spec_tokens=2), dict(spec_tokens=2),
    dict(ngram_spec=2), dict(layout="split", ngram_spec=2)])
def test_speculative_engine_options(params, kw):
    """The speculative options the port's engine refused before it had
    speculation: each raises JAX's ValueError (spec_tokens without a
    draft, prompt lookup over split pools) or is accepted, as JAX's."""
    jp, tp = params
    jkw, tkw = dict(KW, **kw), dict(KW, **kw)
    try:
        JaxEngine(jp, JCFG, **jkw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ServingEngine(tp, TCFG, device="cpu", **tkw)
        assert str(got.value) == str(e)
        return
    eng = ServingEngine(tp, TCFG, device="cpu", **tkw)
    assert (eng.spec_tokens, eng.ngram_spec) == (kw.get("spec_tokens", 0),
                                                 kw.get("ngram_spec", 0))


def _adapter(seed=3, rank=2):
    rng = np.random.default_rng(seed)
    q = TCFG.n_heads * TCFG.head_dim
    return {"layers": [
        {"wq": (rng.standard_normal((TCFG.dim, rank)).astype(np.float32),
                rng.standard_normal((rank, q)).astype(np.float32) * 0.1)}
        for _ in range(TCFG.n_layers)]}


def _greedy(tp, n=6, **kw):
    eng = ServingEngine(tp, TCFG, device="cpu", **dict(KW, **kw))
    for p in _prompts():
        eng.submit(p, n)
    return [r.output for r in eng.run()]


@pytest.mark.parametrize("kw", [
    dict(enable_prefix_cache=True, prefill_chunk=8),
    dict(lora_params={"a": _adapter()}), dict(sampler=sampling.greedy())])
def test_edge_engine_options_accepted(params, kw):
    """The serving-edges options of the engine (ported from JAX's): an
    engine with the prefix cache, with a registered adapter its requests
    do not use, or with a greedy sampler= serves the plain engine's
    greedy tokens."""
    _, tp = params
    assert _greedy(tp, **kw) == _greedy(tp)


def test_prefix_cache_without_chunk_raises(params):
    _, tp = params
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(tp, TCFG, device="cpu", enable_prefix_cache=True, **KW)


@pytest.mark.parametrize("kw", [
    dict(top_k=5, temperature=0.8), dict(top_p=0.9, temperature=0.8),
    dict(logit_bias={1: 100.0}), dict(lora="a"), dict(logprobs=True),
    dict(stop=[[2, 3]])])
def test_edge_submit_options_accepted(params, kw):
    """submit() takes every per-request option of JAX's: each request
    finishes, and each option shows in its output (stop=[[2, 3]] stands for
    the plain output's tokens 2 and 3)."""
    _, tp = params
    eng = ServingEngine(tp, TCFG, device="cpu", lora_params={"a": _adapter()},
                        **KW)
    prompt = _prompts()[0]
    eng.submit(prompt, 6)
    (plain,) = eng.run()
    if "stop" in kw:
        kw = dict(stop=[[plain.output[2], plain.output[3]]])
    eng.submit(prompt, 6, **kw)
    (req,) = eng.run()
    if "stop" in kw:
        first = next(i for i in range(1, 6)
                     if req.output[i - 1:i + 1] == kw["stop"][0])
        assert len(req.output) == first + 1 <= 4
    else:
        assert len(req.output) == 6
    if "logit_bias" in kw:
        assert req.output == [1] * 6
    elif "lora" in kw:
        assert req.output != plain.output
    elif "logprobs" in kw:
        assert len(req.logprobs) == 6 and max(req.logprobs) <= 0.0
        assert req.output == plain.output and not plain.logprobs
    elif "temperature" in kw:
        assert not req.logprobs


def test_seeded_temperature_sampling_reproducible(params):
    _, tp = params

    def run(seed, temperature):
        eng = ServingEngine(tp, TCFG, device="cpu", sample_seed=seed, **KW)
        for p in _prompts():
            eng.submit(p, 8, temperature=temperature)
        return [r.output for r in eng.run()]

    assert run(1, 1.5) == run(1, 1.5)
    assert run(1, 1.5) != run(2, 1.5)
    assert run(1, 1e-7) == run(2, 0.0)  # temperature -> 0 is greedy


def test_samplers():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 50, generator=g)
    assert torch.equal(sampling.temperature(0.0)(logits, g),
                       logits.argmax(-1))
    a = sampling.temperature(1.0)(logits, torch.Generator().manual_seed(5))
    b = sampling.temperature(1.0)(logits, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    rows = sampling.sample_rows(logits, torch.tensor([0.0, 1.0, 0.0, 2.0]),
                                torch.Generator().manual_seed(1))
    assert rows[0] == logits[0].argmax() and rows[2] == logits[2].argmax()


def test_cancel_frees_pages(params):
    _, tp = params
    eng = ServingEngine(tp, TCFG, device="cpu", **KW)
    seen = []

    def cb(rid, tok):
        seen.append(tok)
        if len(seen) == 3:
            assert eng.cancel(rid)

    rid = eng.submit(_prompts()[0], 16, on_token=cb)
    done = eng.run()
    assert done[0].req_id == rid and done[0].cancelled
    assert len(done[0].output) == 3
    assert eng.allocator.num_free == KW["num_pages"] - 1
