"""Per-request sampling edges of the PyTorch port's engine against the JAX
package's (tests/test_sampling.py, test_logprobs.py,
test_stop_sequences.py and test_logit_bias.py across the packages).

  * `sampling.restrict_rows` gives JAX's `_restrict_rows` masks, ties at
    the cutoffs planted, rows with k = 0 / p = 0 unrestricted; the port's
    `_chosen_logprob` equals JAX's;
  * the samplers (`top_k`, `top_p`, `sample_rows` with restrictions) draw
    only inside the kept set, at the renormalised probabilities (a fixed-
    seed frequency test), reproducibly from the generator's seed, and
    `top_k=1` or temperature -> 0 is greedy;
  * the engine's `sampler=` / `sample=` and their precedence, as JAX's;
  * greedy engines with logprobs, stop sequences and logit bias: tokens
    identical to JAX's engine and logprobs within 1e-5 (f32), with the
    stop sequences ending inside a multi-step dispatch (the overshoot
    trimmed) and whole-prompt and chunked prefill.
JAX's random bits cannot be matched, so sampled tokens are never compared
across the packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.models import llama as jllama
from aule_tpu.serving import engine as jengine
from aule_tpu.serving.engine import ServingEngine as JaxEngine
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.serving import engine as tengine
from aule_tpu_torch.serving import sampling
from aule_tpu_torch.serving.engine import ServingEngine
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

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


def _tied_logits(seed, rows=6, v=50):
    """Logits on a grid of halves: exact in f32 in both packages, with
    many ties, so cutoffs land on tied values."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, size=(rows, v)) / 2.0).astype(np.float32)


TKS = np.array([3, 0, 1, 50, 7, 2], np.int32)
TPS = np.array([0.5, 0.9, 0.0, 1.0, 0.3, 0.75], np.float32)


@pytest.mark.parametrize("which", ["top_k", "top_p", "both"])
@pytest.mark.parametrize("seed", [0, 1])
def test_restrict_rows_masks_equal_jax(which, seed):
    logits = _tied_logits(seed)
    tks = TKS if which in ("top_k", "both") else None
    tps = TPS if which in ("top_p", "both") else None
    want = np.asarray(jengine._restrict_rows(
        jnp.asarray(logits), None if tks is None else jnp.asarray(tks),
        None if tps is None else jnp.asarray(tps)))
    got = sampling.restrict_rows(
        torch.from_numpy(logits),
        None if tks is None else torch.from_numpy(tks),
        None if tps is None else torch.from_numpy(tps)).numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert np.array_equal(got[np.isfinite(got)], want[np.isfinite(want)])
    kept = np.isfinite(got).sum(-1)
    if tks is not None and tps is None:
        # k = 0 keeps every token; k = 3 keeps at least 3 (the ties of the
        # 3rd value too)
        assert kept[1] == logits.shape[1] and kept[0] >= 3
    if tps is not None and tks is None:
        assert kept[2] == logits.shape[1] and kept.min() >= 1


def test_chosen_logprob_matches_jax():
    logits = np.random.default_rng(3).standard_normal((4, 40)).astype(
        np.float32) * 3
    toks = np.array([0, 5, 39, 17], np.int32)
    want = jengine._chosen_logprob(jnp.asarray(logits), jnp.asarray(toks))
    got = tengine._chosen_logprob(torch.from_numpy(logits),
                                  torch.from_numpy(toks))
    assert_close(got, np.asarray(want), 0, 1e-6, "chosen logprob")


def _kept(logits, k=0, p=0.0, t=1.0):
    """The kept set of one row [V] as a bool numpy array (JAX's rule)."""
    scaled = jnp.asarray(logits, jnp.float32)[None] / t
    out = jengine._restrict_rows(
        scaled, jnp.asarray([k], jnp.int32) if k else None,
        jnp.asarray([p], jnp.float32) if p else None)
    return np.isfinite(np.asarray(out))[0]


SAMPLERS = {"top_k": (dict(k=5), lambda: sampling.top_k(5, 0.7)),
            "top_p": (dict(p=0.8), lambda: sampling.top_p(0.8, 0.7))}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sampler_frequencies_inside_the_kept_set(name):
    """20,000 seeded draws of one row: every draw inside JAX's kept set,
    each kept token's frequency within 0.015 of its renormalised
    probability (over 4 standard deviations at 20,000 draws)."""
    cut, make = SAMPLERS[name]
    logits = np.random.default_rng(7).standard_normal(30).astype(
        np.float32) * 1.5
    kept = _kept(logits, t=0.7, **cut)
    n = 20000
    rows = torch.from_numpy(np.tile(logits, (n, 1)))
    draws = make()(rows, torch.Generator().manual_seed(11)).numpy()
    assert kept[draws].all()
    scaled = logits.astype(np.float64) / 0.7
    probs = np.where(kept, np.exp(scaled - scaled.max()), 0.0)
    probs /= probs.sum()
    freq = np.bincount(draws, minlength=len(logits)) / n
    assert np.abs(freq - probs).max() < 0.015


def test_sample_rows_restricted_draws_stay_kept():
    """Per-row temperatures with top-k / top-p: sampled rows draw inside
    their kept sets, greedy rows (temperature 0) take the argmax."""
    logits = _tied_logits(4)
    temps = np.array([0.7, 1.0, 0.0, 1.3, 0.5, 2.0], np.float32)
    gen = torch.Generator().manual_seed(2)
    for _ in range(200):
        tok = sampling.sample_rows(
            torch.from_numpy(logits), torch.from_numpy(temps), gen,
            torch.from_numpy(TKS), torch.from_numpy(TPS)).numpy()
        for i, t in enumerate(temps):
            if t == 0.0:
                assert tok[i] == logits[i].argmax()
            else:
                assert _kept(logits[i], TKS[i], TPS[i], t)[tok[i]]


def test_samplers_reproducible_and_greedy_limits():
    logits = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (16, 64)).astype(np.float32))
    for make in (lambda: sampling.top_k(10), lambda: sampling.top_p(0.9),
                 lambda: sampling.temperature(1.0)):
        a = make()(logits, torch.Generator().manual_seed(5))
        b = make()(logits, torch.Generator().manual_seed(5))
        c = make()(logits, torch.Generator().manual_seed(6))
        assert torch.equal(a, b) and not torch.equal(a, c)
    greedy = logits.argmax(-1)
    assert torch.equal(sampling.top_k(1)(logits, torch.Generator()), greedy)
    assert torch.equal(sampling.top_p(1e-9)(logits, torch.Generator()),
                       greedy)
    assert torch.equal(sampling.temperature(0.0)(logits, None), greedy)
    tiny = torch.full((16,), 1e-7)
    assert torch.equal(sampling.sample_rows(logits, tiny,
                                            torch.Generator()), greedy)
    with pytest.raises(ValueError):
        sampling.top_k(0)
    with pytest.raises(ValueError):
        sampling.top_p(1.5)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in lens]


def _serve(eng, prompts, reqs):
    ids = [eng.submit(p, **r) for p, r in zip(prompts, reqs)]
    done = {r.req_id: r for r in eng.run()}
    return [done[i] for i in ids]


def test_engine_sampler_and_sample_options(params):
    """sampler= draws from the engine's seeded generator (reproducible,
    top_k(1) is greedy), sample= (make_engine_sampler) likewise; both
    together, or with a request's temperature / top_k, raise ValueError as
    in JAX."""
    jp, tp = params
    prompts = _prompts(1, (7, 12, 5))
    reqs = [dict(max_new_tokens=6)] * 3

    def outs(**kw):
        eng = ServingEngine(tp, TCFG, device="cpu", **KW, **kw)
        return [r.output for r in _serve(eng, prompts, reqs)]

    greedy = outs()
    assert outs(sampler=sampling.top_k(1)) == greedy
    assert outs(sample=sampling.make_engine_sampler(sampling.greedy())) \
        == greedy
    a = outs(sampler=sampling.temperature(1.5), sample_seed=3)
    assert a == outs(sampler=sampling.temperature(1.5), sample_seed=3)
    assert a != outs(sampler=sampling.temperature(1.5), sample_seed=4)
    b = outs(sample=sampling.make_engine_sampler(sampling.top_p(0.95, 1.5),
                                                 seed=2))
    assert b == outs(sample=sampling.make_engine_sampler(
        sampling.top_p(0.95, 1.5), seed=2))
    for make in (lambda **kw: JaxEngine(jp, JCFG, **KW, **kw),
                 lambda **kw: ServingEngine(tp, TCFG, device="cpu", **KW,
                                            **kw)):
        with pytest.raises(ValueError, match="not both"):
            make(sample=lambda x: x.argmax(-1), sampler=sampling.greedy())
        eng = make(sample=lambda x: x.argmax(-1))
        for bad in (dict(temperature=0.5), dict(top_k=3), dict(top_p=0.5)):
            with pytest.raises(ValueError, match="default sampler"):
                eng.submit(prompts[0], 2, **bad)
    eng = ServingEngine(tp, TCFG, device="cpu", **KW)
    for bad in (dict(top_p=1.5), dict(top_k=-1), dict(stop=[[]]),
                dict(logit_bias={256: 1.0}), dict(temperature=-1.0)):
        with pytest.raises(ValueError):
            eng.submit(prompts[0], 2, **bad)


def test_engine_top_k_one_and_cold_temperature_are_greedy(params):
    _, tp = params
    prompts = _prompts(2, (9, 6, 14))

    def outs(**r):
        eng = ServingEngine(tp, TCFG, device="cpu", **KW)
        return [x.output for x in _serve(eng, prompts,
                                         [dict(max_new_tokens=7, **r)] * 3)]

    greedy = outs()
    assert outs(temperature=1.0, top_k=1) == greedy
    assert outs(temperature=1e-7, top_p=0.5) == greedy
    assert outs(temperature=1e-7) == greedy


def _edge_requests(tp, prompts, chunk):
    """Per-request options built from the port's plain greedy output:
    request 0 stops at its output[4:6] (inside the second dispatch of 4
    steps), request 1 bans its first greedy token (-100) and favours
    another (+3), request 2 asks for logprobs and stops at a one-token
    sequence, request 3 asks for logprobs under a bias."""
    eng = ServingEngine(tp, TCFG, device="cpu", prefill_chunk=chunk, **KW)
    base = [r.output for r in _serve(eng, prompts,
                                     [dict(max_new_tokens=12)] * 4)]
    return [
        dict(max_new_tokens=12, stop=[base[0][4:6], [999 % 256, 1]]),
        dict(max_new_tokens=12, logit_bias={base[1][0]: -100.0, 17: 3.0}),
        dict(max_new_tokens=12, logprobs=True, stop=[[base[2][7]]]),
        dict(max_new_tokens=12, logprobs=True,
             logit_bias={base[3][2]: 2.5}),
    ], base


@pytest.mark.parametrize("chunk", [None, 8])
def test_edges_token_identical_to_jax(params, chunk):
    """Four greedy requests on two slots with stop sequences, logit bias
    and logprobs: the port's tokens equal JAX's engine's, logprobs within
    1e-5; the stops trim multi-step overshoot and the ban holds."""
    jp, tp = params
    prompts = _prompts(5, (9, 17, 6, 12))
    reqs, base = _edge_requests(tp, prompts, chunk)
    jeng = JaxEngine(jp, JCFG, prefill_chunk=chunk, **KW)
    teng = ServingEngine(tp, TCFG, device="cpu", prefill_chunk=chunk, **KW)
    jout = _serve(jeng, prompts, reqs)
    tout = _serve(teng, prompts, reqs)
    assert [r.output for r in tout] == [r.output for r in jout]
    for j, t in zip(jout, tout):
        assert len(t.logprobs) == (len(t.output) if t.want_logprobs else 0)
        if t.logprobs:
            assert_close(np.array(t.logprobs), np.array(j.logprobs), 0, 1e-5,
                         f"logprobs of request {t.req_id}")
    stopped = tout[0].output
    assert stopped[-2:] == base[0][4:6] and len(stopped) <= 6
    assert base[1][0] not in tout[1].output
    assert tout[2].output[-1] == base[2][7] and len(tout[2].output) <= 8
    assert teng.allocator.num_free == KW["num_pages"] - 1
