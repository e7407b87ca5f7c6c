"""Prompt-lookup speculation (`ngram_spec`) in the port's engine against the
JAX package's.

`_ngram_propose` gives JAX's proposals on many random sequences; the
engine is token-identical to JAX's with the same counters (f32 whole
prompt, int8 chunked, a slot that verifies one token beside a full one)
and to its own plain engine; the cases of tests/test_prompt_lookup.py
(greedy equality, the proposal rules, int8 with a stop sequence, the
refusals with JAX's messages) run on the port; sampled rounds keep plain
sampling's distribution (chi-square, as the draft model's test).
"""

import jax
import numpy as np
import pytest

from aule_tpu.models import llama as jllama
from aule_tpu.serving.engine import ServingEngine as JaxEngine
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.serving.engine import ServingEngine
from aule_tpu_torch.utils.testing import cap_cpu_threads

cap_cpu_threads()

JCFG = jllama.LlamaConfig.tiny()
TCFG = tllama.LlamaConfig.tiny()
KW = dict(max_batch=2, page_size=16, num_pages=64, max_pages_per_seq=8,
          max_seq_len=256)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(JCFG, jax.random.key(0))
    return jp, tllama.load_jax_params(jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _run(tp, prompts, news, **kw):
    eng = ServingEngine(tp, TCFG, device="cpu", **dict(KW, **kw))
    for p, n in zip(prompts, news):
        eng.submit(p, n)
    return [r.output for r in eng.run()], eng


@pytest.mark.parametrize("ngram_max", [1, 2, 3, 5])
def test_ngram_propose_matches_jax(params, ngram_max):
    """The same proposal (or None) as JAX's on 400 random sequences of 1
    to 40 tokens over small alphabets (so that n-grams repeat), K 1 to
    5."""
    jp, tp = params
    rng = np.random.default_rng(ngram_max)
    engines = {}
    for k in range(1, 6):
        engines[k] = (
            JaxEngine(jp, JCFG, ngram_spec=k, ngram_max=ngram_max, **KW),
            ServingEngine(tp, TCFG, device="cpu", ngram_spec=k,
                          ngram_max=ngram_max, **KW))
    hits = 0
    for _ in range(400):
        k = int(rng.integers(1, 6))
        seq = rng.integers(0, int(rng.integers(2, 9)),
                           size=int(rng.integers(1, 41))).astype(np.int32)
        want = engines[k][0]._ngram_propose(seq)
        got = engines[k][1]._ngram_propose(seq)
        if want is None:
            assert got is None
            continue
        hits += 1
        assert got.dtype == want.dtype and got.tolist() == want.tolist()
    assert hits > 300


@pytest.mark.parametrize("case", ["f32-whole", "int8-chunk"])
def test_ngram_matches_jax_engine(params, case):
    """Tokens and counters equal JAX's engine's, tokens the port's plain
    engine's.  A 100-token prompt whose greedy continuation falls into a
    loop (lookups are proposed and accepted), one with 2 tokens to go
    after its prefill (a cap-1 verify while the other speculates), one of
    40 tokens."""
    jp, tp = params
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (100, 9, 40)]
    news = (14, 2, 12)
    kw = (dict(decode_steps=1) if case == "f32-whole"
          else dict(quantized=True, prefill_chunk=8))
    jeng = JaxEngine(jp, JCFG, ngram_spec=3, **KW, **kw)
    for p, n in zip(prompts, news):
        jeng.submit(p, n)
    want = [r.output for r in jeng.run()]
    got, eng = _run(tp, prompts, news, ngram_spec=3, **kw)
    assert got == want
    counters = (eng.spec_rounds, eng.spec_drafted, eng.spec_accepted)
    assert counters == (jeng.spec_rounds, jeng.spec_drafted,
                        jeng.spec_accepted)
    assert eng.spec_rounds > 0 and eng.spec_accepted > 0
    plain, _ = _run(tp, prompts, news, **kw)
    assert got == plain


def test_ngram_matches_plain_greedy(params):
    _, tp = params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=100).astype(np.int32),
               rng.integers(0, 256, size=9).astype(np.int32)]
    plain, _ = _run(tp, prompts, (10, 10))
    spec, eng = _run(tp, prompts, (10, 10), ngram_spec=3, decode_steps=1)
    assert spec == plain
    assert eng.spec_rounds > 0 and eng.spec_drafted > 0


def test_ngram_proposal_mechanics(params):
    _, tp = params
    eng = ServingEngine(tp, TCFG, device="cpu", ngram_spec=3, ngram_max=3,
                        **dict(KW, max_batch=1))

    def prop(seq):
        return eng._ngram_propose(np.asarray(seq, np.int32))

    assert prop([5, 6, 7, 8, 9, 5, 6]).tolist() == [7, 8, 9]
    # the latest occurrence wins
    assert prop([5, 6, 1, 5, 6, 2, 3, 5, 6]).tolist() == [2, 3, 5]
    # the longest n wins over a shorter, later match
    assert prop([1, 2, 3, 9, 1, 2, 3]).tolist() == [9, 1, 2]
    # a continuation cut by the tail repeats its last token
    assert prop([4, 5, 6, 7, 7]).tolist() == [7, 7, 7]
    assert prop([1, 2, 3, 4, 5]) is None


def test_ngram_quantized_and_stop(params):
    _, tp = params
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, size=4).astype(np.int32)
    prompt = np.concatenate([base, base])
    plain, _ = _run(tp, [prompt], [8], quantized=True)
    spec, _ = _run(tp, [prompt], [8], quantized=True, ngram_spec=2)
    assert spec == plain
    stop = plain[0][2:4]
    end = next(j for j in range(2, 9) if plain[0][j - 2:j] == stop)
    eng = ServingEngine(tp, TCFG, device="cpu", quantized=True,
                        ngram_spec=2, **dict(KW, max_batch=1))
    eng.submit(prompt, max_new_tokens=8, stop=[stop])
    assert eng.run()[0].output == plain[0][:end]


def test_ngram_validation(params):
    """JAX's refusals, with JAX's messages."""
    jp, tp = params
    cases = [dict(ngram_spec=2, spec_tokens=2),
             dict(ngram_spec=2, layout="split"),
             dict(ngram_spec=2, sample=lambda lg: lg.argmax(-1)),
             dict(ngram_spec=2, ngram_max=0)]
    for kw in cases:
        jkw = dict(kw)
        if "spec_tokens" in kw:
            jkw.update(draft_params=jp, draft_cfg=JCFG)
            kw = dict(kw, draft_params=tp, draft_cfg=TCFG)
        with pytest.raises(ValueError) as want:
            JaxEngine(jp, JCFG, **KW, **jkw)
        with pytest.raises(ValueError) as got:
            ServingEngine(tp, TCFG, device="cpu", **KW, **kw)
        assert str(got.value) == str(want.value)


def test_ngram_sampled_distribution_chi2(params):
    """Sampled prompt-lookup rounds (a one-hot proposal: accept with
    p(g), else draw from p with g removed) keep plain sampling's
    distribution: the first round's first token of 192 requests whose
    prompt makes the lookup propose, chi-square under the p = 0.001
    critical value."""
    kw16 = dict(vocab_size=16, n_layers=1, n_heads=2, dim=64,
                hidden_dim=128)
    cfg = tllama.LlamaConfig.tiny(**kw16)
    tp = tllama.load_jax_params(jax.tree.map(np.asarray, jllama.init_params(
        jllama.LlamaConfig.tiny(**kw16), jax.random.key(30))), device="cpu")
    # 16 tokens over most of the vocabulary: most first tokens have an
    # earlier occurrence to look up
    prompt = np.asarray([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3],
                        np.int32)

    def collect(**kw):
        eng = ServingEngine(tp, cfg, device="cpu", max_batch=8,
                            page_size=16, num_pages=192, max_pages_per_seq=2,
                            max_seq_len=32, sample_seed=5, decode_steps=1,
                            **kw)
        ids = [eng.submit(prompt, max_new_tokens=4, temperature=1.0)
               for _ in range(192)]
        done = {r.req_id: r for r in eng.run()}
        return np.asarray([done[i].output[1] for i in ids]), eng

    plain, _ = collect()
    spec, eng = collect(ngram_spec=2, ngram_max=1)
    assert eng.spec_rounds > 0 and 0 < eng.spec_accepted < eng.spec_drafted
    n1 = np.bincount(plain, minlength=16).astype(np.float64)
    n2 = np.bincount(spec, minlength=16).astype(np.float64)
    pooled = (n1 + n2) / (n1.sum() + n2.sum())
    e1, e2 = pooled * n1.sum(), pooled * n2.sum()
    keep = pooled > 0
    chi2 = (((n1 - e1) ** 2 / np.maximum(e1, 1e-9))[keep].sum()
            + ((n2 - e2) ** 2 / np.maximum(e2, 1e-9))[keep].sum())
    dof = int(keep.sum()) - 1
    assert chi2 < 37.7 + 2.0 * max(0, dof - 15), (chi2, dof)
