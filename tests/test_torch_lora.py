"""Multi-LoRA serving in the PyTorch port against the JAX package
(tests/test_lora.py's cases, across the packages).

On the same tiny f32 params (`load_jax_params`) and the same seeded numpy
adapters:
  * `_lora_proj` equals JAX's for 2-D and 3-D h and a mixed index row;
  * Llama, GPT-2 and MoE `forward` / `decode_step_fused` /
    `prefill_step_fused` with `lora` / `lora_idx` within 1e-5 of JAX's;
  * the engine with two adapters serves a mixed batch token-identical to
    JAX's engine (Llama f32 whole-prompt and int8 chunked);
  * an adapter request equals an engine on the merged weights W + A @ B,
    and a base request beside it equals the base model (each family,
    whole-prompt and chunked prefill);
  * the bad registrations raise ValueError as JAX's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.models import gpt2 as jgpt2
from aule_tpu.models import llama as jllama
from aule_tpu.models import moe as jmoe
from aule_tpu.ops.paged_fused import fused_pool_shape
from aule_tpu.ops.rope import precompute_rope_frequencies as jrope
from aule_tpu.serving.engine import ServingEngine as JaxEngine
from aule_tpu_torch.models import gpt2 as tgpt2
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.models import moe as tmoe
from aule_tpu_torch.ops.rope import precompute_rope_frequencies as trope
from aule_tpu_torch.serving.engine import ServingEngine
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()

TOL = 1e-5
KW = dict(max_batch=2, page_size=16, num_pages=64, max_pages_per_seq=8,
          max_seq_len=256, decode_steps=4)
# family: (JAX module, port module, JAX config, port config)
FAMILIES = {
    "llama": (jllama, tllama, jllama.LlamaConfig.tiny(),
              tllama.LlamaConfig.tiny()),
    "gpt2": (jgpt2, tgpt2, jgpt2.GPT2Config.tiny(), tgpt2.GPT2Config.tiny()),
    "moe": (jmoe, tmoe, jmoe.MoEConfig.tiny(), tmoe.MoEConfig.tiny()),
}


@pytest.fixture(scope="module")
def family_params():
    out = {}
    for i, (name, (jm, tm, jcfg, _)) in enumerate(FAMILIES.items()):
        jp = jm.init_params(jcfg, jax.random.key(10 + i))
        out[name] = (jp, tm.load_jax_params(jax.tree.map(np.asarray, jp),
                                            device="cpu"))
    return out


def _dims(cfg):
    """(d_in, d_out) of each LoRA target."""
    q = cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    return {"wq": (cfg.dim, q), "wk": (cfg.dim, kv), "wv": (cfg.dim, kv),
            "wo": (q, cfg.dim)}


def _adapter(cfg, seed, targets=("wq", "wk", "wv", "wo"), rank=4,
             scale=0.2):
    """One adapter, {"layers": [{target: (A [d, r], B [r, o])}]}, f32 numpy
    from `seed` (the scale folded in)."""
    rng = np.random.default_rng(seed)
    dims = _dims(cfg)
    return {"layers": [
        {t: ((rng.standard_normal((dims[t][0], rank)) * scale).astype(
            np.float32),
             (rng.standard_normal((rank, dims[t][1])) * scale).astype(
                 np.float32)) for t in targets}
        for _ in range(cfg.n_layers)]}


def _bank(cfg, adapters):
    """The stacked bank of the models' `lora=` (index 0 zeros), in numpy."""
    bank = []
    for li in range(cfg.n_layers):
        entry = {}
        for t in adapters[0]["layers"][li]:
            mats = [[a["layers"][li][t][j] for a in adapters] for j in (0, 1)]
            entry[t] = tuple(np.stack([np.zeros_like(m[0])] + m)
                             for m in mats)
        bank.append(entry)
    return {"layers": bank}


def _as(bank, conv):
    return {"layers": [{t: tuple(conv(m) for m in ab) for t, ab in e.items()}
                       for e in bank["layers"]]}


@pytest.mark.parametrize("ndim", [2, 3])
def test_lora_proj_matches_jax(ndim):
    rng = np.random.default_rng(ndim)
    d, r, o, n = 32, 4, 24, 3
    shape = (4, d) if ndim == 2 else (4, 5, d)
    h = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((d, o)).astype(np.float32)
    a = rng.standard_normal((n, d, r)).astype(np.float32)
    b = rng.standard_normal((n, r, o)).astype(np.float32)
    a[0] = b[0] = 0.0
    idx = np.array([2, 0, 1, 2], np.int32)
    jl = {"wq": (jnp.asarray(a), jnp.asarray(b))}
    tl = {"wq": (torch.from_numpy(a), torch.from_numpy(b))}
    want = jllama._lora_proj(jnp.asarray(h), jnp.asarray(w), jl, "wq",
                             jnp.asarray(idx))
    got = tllama._lora_proj(torch.from_numpy(h), torch.from_numpy(w), tl,
                            "wq", torch.from_numpy(idx))
    assert_close(got, np.asarray(want), TOL, TOL, "lora_proj")
    # no adapter for the name, or no index: the plain product
    plain = torch.from_numpy(h) @ torch.from_numpy(w)
    assert torch.equal(tllama._lora_proj(torch.from_numpy(h),
                                         torch.from_numpy(w), tl, "wo",
                                         torch.from_numpy(idx)), plain)
    assert torch.equal(tllama._lora_proj(torch.from_numpy(h),
                                         torch.from_numpy(w), tl, "wq",
                                         None), plain)


def _model_banks(name, cfg):
    targets = {"llama": ("wq", "wk", "wv", "wo"), "gpt2": ("wq", "wv", "wo"),
               "moe": ("wq", "wk", "wo")}[name]
    bank = _bank(cfg, [_adapter(cfg, 1, targets), _adapter(cfg, 2, targets)])
    return _as(bank, jnp.asarray), _as(bank, torch.from_numpy)


@pytest.mark.parametrize("fn", ["forward", "decode_step_fused",
                                "prefill_step_fused"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_model_with_lora_matches_jax(family_params, name, fn):
    """Each family's entry point with a two-adapter bank and the index row
    [2, 0] (an adapter beside the base) against JAX's, f32 within 1e-5:
    the logits and, for the paged steps, the pools they wrote."""
    jm, tm, jcfg, tcfg = FAMILIES[name]
    jp, tp = family_params[name]
    jbank, tbank = _model_banks(name, jcfg)
    idx = np.array([2, 0], np.int32)
    lora_j = dict(lora=jbank, lora_idx=jnp.asarray(idx))
    lora_t = dict(lora=tbank, lora_idx=torch.from_numpy(idx))
    rng = np.random.default_rng(5)
    if fn == "forward":
        tokens = rng.integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
        want = jm.forward(jp, jnp.asarray(tokens), jcfg, **lora_j)
        got = tm.forward(tp, torch.from_numpy(tokens).long(), tcfg, **lora_t)
        assert_close(got, np.asarray(want), 0, TOL, f"{name} forward")
        return
    shape = fused_pool_shape(16, jcfg.n_kv_heads, 16, jcfg.head_dim)
    pools = [(rng.standard_normal(shape) * 0.1).astype(np.float32)
             for _ in range(jcfg.n_layers)]
    tpools = torch.from_numpy(np.stack(pools))
    bt = np.array([[1, 2, -1, -1], [3, 4, 5, -1]], np.int32)
    lens = np.array([20, 33], np.int32)
    jc, js = jrope(64, jcfg.head_dim, jcfg.rope_base)
    tc, ts = trope(64, tcfg.head_dim, tcfg.rope_base)
    jpools = [jnp.asarray(p) for p in pools]
    if fn == "decode_step_fused":
        tok = np.array([5, 77], np.int32)
        jout = jm.decode_step_fused(
            jp, jnp.asarray(tok), jnp.asarray(lens), jpools, jnp.asarray(bt),
            jnp.asarray(lens), jcfg, jc, js, **lora_j)
        tout = tm.decode_step_fused(
            tp, torch.from_numpy(tok).long(), torch.from_numpy(lens).long(),
            tpools, torch.from_numpy(bt), torch.from_numpy(lens), tcfg, tc,
            ts, **lora_t)
    else:
        tokens = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
        slens = np.array([12, 7], np.int32)
        jout = jm.prefill_step_fused(
            jp, jnp.asarray(tokens), jnp.asarray(lens), jnp.asarray(slens),
            jpools, jnp.asarray(bt), jcfg, jc, js, **lora_j)
        tout = tm.prefill_step_fused(
            tp, torch.from_numpy(tokens).long(), torch.from_numpy(lens),
            torch.from_numpy(slens), tpools, torch.from_numpy(bt), tcfg, tc,
            ts, **lora_t)
    assert_close(tout[0], np.asarray(jout[0]), 0, TOL, f"{name} {fn}")
    for li in range(jcfg.n_layers):
        assert_close(tpools[li], np.asarray(jout[1][li]), 0, TOL,
                     f"{name} {fn} pool{li}")
    assert tout[2].tolist() == np.asarray(jout[2]).tolist()


def _prompts(seed, lens, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _serve(eng, prompts, reqs):
    ids = [eng.submit(p, **r) for p, r in zip(prompts, reqs)]
    done = {r.req_id: r for r in eng.run()}
    return [done[i].output for i in ids]


QUANT = {"int8": (jnp.int8, torch.int8)}


@pytest.mark.parametrize("name,kw", [
    ("llama", dict()),
    ("llama", dict(prefill_chunk=8, quantized="int8"))],
    ids=["llama-f32-whole", "llama-int8-chunk8"])
def test_engine_mixed_batch_matches_jax(family_params, name, kw):
    """Base, adapter "a" and adapter "b" requests on two slots (the third
    waits for a retirement; multi-step decode on): greedy tokens identical
    to JAX's engine with the same adapters and options.  (GPT-2's and
    MoE's adapters are held to JAX's at the model level above and to the
    merged weights through the engine below.)"""
    jm, tm, jcfg, tcfg = FAMILIES[name]
    jp, tp = family_params[name]
    adapters = {"a": _adapter(jcfg, 3),
                "b": _adapter(jcfg, 4, targets=("wq", "wv", "wo"))}
    jkw, tkw = dict(KW, **kw), dict(KW, **kw)
    if "quantized" in kw:
        jkw.update(quantized=True, quant_dtype=QUANT[kw["quantized"]][0])
        tkw.update(quantized=True, quant_dtype=QUANT[kw["quantized"]][1])
    prompts = _prompts(6, (9, 21, 12), jcfg.vocab_size)
    reqs = [dict(max_new_tokens=n, lora=lo)
            for n, lo in ((6, "a"), (7, None), (5, "b"))]
    jout = _serve(JaxEngine(jp, jcfg, model=jm, lora_params=adapters,
                            **jkw), prompts, reqs)
    teng = ServingEngine(tp, tcfg, model=tm, device="cpu",
                         lora_params=adapters, **tkw)
    tout = _serve(teng, prompts, reqs)
    assert tout == jout
    assert teng.allocator.num_free == KW["num_pages"] - 1


def _merged(name, params, adapter):
    """The port's params with the adapter folded in (W + A @ B); GPT-2's
    wq / wk / wv go to w_qkv's slices and wo to w_proj."""
    out = dict(params)
    out["layers"] = []
    slot = {"wq": 0, "wk": 1, "wv": 2}
    for li, layer in enumerate(params["layers"]):
        nl = dict(layer)
        for t, (a, b) in adapter["layers"][li].items():
            delta = torch.from_numpy(a @ b)
            if name != "gpt2":
                nl[t] = layer[t] + delta
            elif t == "wo":
                nl["w_proj"] = layer["w_proj"] + delta
            else:
                w = nl["w_qkv"].clone()
                w[slot[t]] += delta
                nl["w_qkv"] = w
        out["layers"].append(nl)
    return out


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_adapter_equals_merged_weights(family_params, name, chunk):
    """An adapter request decodes as an engine on W + A @ B does, and a
    base request co-batched with it as the base engine does, through
    whole-prompt and chunked prefill and multi-step decode."""
    _, tm, _, tcfg = FAMILIES[name]
    _, tp = family_params[name]
    adapter = _adapter(tcfg, 7, targets=("wq", "wv", "wo"))
    prompt = _prompts(8, (13,), tcfg.vocab_size)[0]
    kw = dict(KW, prefill_chunk=chunk)

    def one(params, **engine_kw):
        eng = ServingEngine(params, tcfg, model=tm, device="cpu", **kw,
                            **engine_kw)
        return eng

    base = _serve(one(tp), [prompt], [dict(max_new_tokens=6)])[0]
    want = _serve(one(_merged(name, tp, adapter)), [prompt],
                  [dict(max_new_tokens=6)])[0]
    assert want != base  # the adapter changes the stream
    got = _serve(one(tp, lora_params={"x": adapter}), [prompt, prompt],
                 [dict(max_new_tokens=6, lora="x"),
                  dict(max_new_tokens=6)])
    assert got == [want, base]


def _bad(kind, cfg):
    """(engine kwargs, submit kwargs) of a bad registration."""
    good = _adapter(cfg, 9)
    if kind == "target":
        bad = _adapter(cfg, 9)
        bad["layers"][0]["w_gate"] = bad["layers"][0]["wq"]
        return dict(lora_params={"x": bad}), None
    if kind == "rank":
        return dict(lora_params={"x": good,
                                 "y": _adapter(cfg, 10, rank=2)}), None
    if kind == "split":
        return dict(lora_params={"x": good}, layout="split"), None
    return dict(lora_params={"x": good}), dict(lora="nope")


@pytest.mark.parametrize("kind,match", [
    ("target", "unsupported LoRA targets"),
    ("rank", "disagree on LoRA shape"),
    ("split", "layout='fused'"),
    ("unknown", "unknown LoRA adapter")])
def test_bad_registrations_raise_as_jax(family_params, kind, match):
    jcfg, tcfg = FAMILIES["llama"][2:]
    jp, tp = family_params["llama"]
    engine_kw, submit_kw = _bad(kind, jcfg)
    for make in (lambda: JaxEngine(jp, jcfg, **KW, **engine_kw),
                 lambda: ServingEngine(tp, tcfg, device="cpu", **KW,
                                       **engine_kw)):
        if submit_kw is None:
            with pytest.raises(ValueError, match=match):
                make()
        else:
            eng = make()
            with pytest.raises(ValueError, match=match):
                eng.submit(np.arange(4, dtype=np.int32), 2, **submit_kw)
