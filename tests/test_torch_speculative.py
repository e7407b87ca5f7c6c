"""Speculative decoding with a draft model in the port's engine against the
JAX package's.

On the tiny f32 Llama (JAX's weights carried across by `load_jax_params`,
the port on the CPU: its kernels' plain versions), the port's speculative
engine is token-identical to JAX's, with the same spec_rounds /
spec_drafted / spec_accepted, at K 1, 2 and 4, over f32 and int8 pools,
chunked and whole-prompt, with a slot whose budget takes only a 1-token
verify in the batch; each also equals the port's plain greedy engine.  A
speculative engine's checkpoint crosses the packages both ways.  The cases
of tests/test_speculative.py run on the port against its plain engine:
a perfect draft, eos inside a round, a mixed greedy / sampled batch, per-
slot caps, the adaptive disable, the prefix cache, a windowed target,
GPT-2, an MoE target with a Llama draft, and the sampled rounds (top-k 1
equals greedy, a forcing logit bias, reproducibility, and JAX's chi-square
homogeneity test of the first speculative token against the port's plain
sampling).
"""

import jax
import numpy as np
import pytest
import torch

from aule_tpu.models import llama as jllama
from aule_tpu.serving.engine import ServingEngine as JaxEngine
from aule_tpu.serving.engine import load_engine_state as jax_load
from aule_tpu.serving.engine import save_engine_state as jax_save
from aule_tpu_torch.models import gpt2 as tgpt2
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.models import moe as tmoe
from aule_tpu_torch.serving.engine import (ServingEngine, load_engine_state,
                                           save_engine_state)
from aule_tpu_torch.utils.testing import cap_cpu_threads

cap_cpu_threads()

JCFG = jllama.LlamaConfig.tiny()
TCFG = tllama.LlamaConfig.tiny()
# JAX's draft (tests/test_speculative.py:25-26): smaller, its own weights
DRAFT = dict(dim=64, n_layers=1, n_heads=2, hidden_dim=128)
JDRAFT = jllama.LlamaConfig.tiny(**DRAFT)
TDRAFT = tllama.LlamaConfig.tiny(**DRAFT)
KW = dict(max_batch=2, page_size=16, num_pages=64, max_pages_per_seq=8,
          max_seq_len=256)
# three requests on two slots: the second has 2 tokens to go after its
# prefill, under any K+1 >= 2, so it verifies with cap 1 beside the first
PROMPT_LENS, NEWS = (7, 11, 5), (9, 2, 8)
# (K, quantized, prefill_chunk, draft): every K, both pools and both
# prefills against JAX's engine; "self" drafts with the target (every
# proposal agrees)
CASES = [(1, False, None, "draft"), (2, True, 8, "draft"),
         (4, False, 8, "self")]
SAVE_CASE, SAVE_AFTER = 1, 2   # the JAX run saved after its second step


def _torch(jp):
    return tllama.load_jax_params(jax.tree.map(np.asarray, jp),
                                  device="cpu")


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.key(0))
    jd = jllama.init_params(JDRAFT, jax.random.key(7))
    return {"target": (jp, _torch(jp)), "draft": (jd, _torch(jd))}


def _prompts(seed=0, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in lens]


def _spec_kw(case, weights, side):
    k, quantized, chunk, draft = CASES[case]
    dp = weights["target" if draft == "self" else "draft"][side]
    if side == 0:
        dcfg = JCFG if draft == "self" else JDRAFT
    else:
        dcfg = TCFG if draft == "self" else TDRAFT
    return dict(KW, spec_tokens=k, quantized=quantized, prefill_chunk=chunk,
                draft_params=dp, draft_cfg=dcfg)


def _counters(eng):
    return eng.spec_rounds, eng.spec_drafted, eng.spec_accepted


@pytest.fixture(scope="module")
def jax_runs(weights, tmp_path_factory):
    """Each case through JAX's engine once: outputs and counters; the
    SAVE_CASE run also saves its state after SAVE_AFTER steps, and its
    engine, idle and compiled, is kept to resume the port's file."""
    out = {}
    path = str(tmp_path_factory.mktemp("spec") / "jax")
    for case in range(len(CASES)):
        eng = JaxEngine(weights["target"][0], JCFG,
                        **_spec_kw(case, weights, 0))
        for p, n in zip(_prompts(), NEWS):
            eng.submit(p, n)
        steps = 0
        while eng.has_work():
            eng.step()
            steps += 1
            if case == SAVE_CASE and steps == SAVE_AFTER:
                jax_save(eng, path)
        done = sorted(eng.finished, key=lambda r: r.req_id)
        out[case] = ([r.output for r in done], _counters(eng))
        if case == SAVE_CASE:
            out["engine"] = eng
    out["saved"] = path
    return out


def _port_run(tp, cfg, prompts, news, **kw):
    eng = ServingEngine(tp, cfg, device="cpu", **kw)
    for p, n in zip(prompts, news):
        eng.submit(p, n)
    return [r.output for r in eng.run()], eng


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"K{k}-{'int8' if q else 'f32'}-"
                              f"{'chunk' if c else 'whole'}-{d}"
                              for k, q, c, d in CASES])
def test_spec_matches_jax_engine(weights, jax_runs, case):
    """Tokens and counters equal JAX's; tokens equal the port's plain
    greedy engine's; the cap-1 slot drafted nothing."""
    tp = weights["target"][1]
    got, eng = _port_run(tp, TCFG, _prompts(), NEWS,
                         **_spec_kw(case, weights, 1))
    want, counters = jax_runs[case]
    assert got == want
    assert _counters(eng) == counters
    assert eng.stats()["spec_rounds"] == counters[0] > 0
    k, quantized, chunk, draft = CASES[case]
    plain, _ = _port_run(tp, TCFG, _prompts(), NEWS, quantized=quantized,
                         prefill_chunk=chunk, **KW)
    assert got == plain
    if draft == "self":
        assert eng.spec_accepted == eng.spec_drafted > 0
    assert eng.allocator.num_free == KW["num_pages"] - 1


def test_spec_int8_whole_k4_matches_plain(weights):
    """K 4 over an int8 pool with whole-prompt prefill (both pools written
    by the quantized append of a forward), against the plain engine."""
    tp, td = weights["target"][1], weights["draft"][1]
    kw = dict(KW, quantized=True)
    plain, _ = _port_run(tp, TCFG, _prompts(), NEWS, **kw)
    got, eng = _port_run(tp, TCFG, _prompts(), NEWS, draft_params=td,
                         draft_cfg=TDRAFT, spec_tokens=4, **kw)
    assert got == plain and eng.spec_rounds > 0


def test_spec_checkpoint_crosses_packages(weights, jax_runs, tmp_path):
    """A speculative engine's state saved by JAX mid-run resumes in the
    port, and the port's in JAX, each finishing with the uninterrupted
    run's tokens (draft pool, draft lengths and counters carried)."""
    tp = weights["target"][1]
    want, _ = jax_runs[SAVE_CASE]
    port = ServingEngine(tp, TCFG, device="cpu",
                         **_spec_kw(SAVE_CASE, weights, 1))
    load_engine_state(port, jax_runs["saved"])
    assert port.slot_dlens.any() and port.spec_drafted > 0
    assert [r.output for r in port.run()] == want

    eng = ServingEngine(tp, TCFG, device="cpu",
                        **_spec_kw(SAVE_CASE, weights, 1))
    for p, n in zip(_prompts(), NEWS):
        eng.submit(p, n)
    for _ in range(SAVE_AFTER):
        eng.step()
    path = str(tmp_path / "port")
    save_engine_state(eng, path)
    jeng = jax_runs["engine"]  # idle after its run: load replaces its state
    jeng.finished = []
    jax_load(jeng, path)
    assert np.array_equal(np.asarray(jeng.slot_dlens), eng.slot_dlens)
    assert (jeng.spec_drafted, jeng.spec_accepted) == (eng.spec_drafted,
                                                       eng.spec_accepted)
    while jeng.has_work():
        jeng.step()
    assert [r.output for r in sorted(jeng.finished,
                                     key=lambda r: r.req_id)] == want


def test_spec_checkpoint_roundtrip(weights, tmp_path):
    """Preempted after one round and resumed by a fresh port engine: the
    uninterrupted run's tokens (tests/test_speculative.py:151-180)."""
    tp, td = weights["target"][1], weights["draft"][1]
    prompt = _prompts(6, (8,))[0]
    kw = dict(KW, draft_params=td, draft_cfg=TDRAFT, spec_tokens=2)
    want, _ = _port_run(tp, TCFG, [prompt], [10], **kw)
    eng = ServingEngine(tp, TCFG, device="cpu", **kw)
    eng.submit(prompt, max_new_tokens=10)
    eng.step()  # prefill and the first token
    eng.step()  # one round
    path = str(tmp_path / "ck")
    save_engine_state(eng, path)
    res = ServingEngine(tp, TCFG, device="cpu", **kw)
    load_engine_state(res, path)
    assert np.array_equal(res.slot_dlens, eng.slot_dlens)
    assert [r.output for r in res.run()] == want


def test_spec_file_without_draft_refused(weights, tmp_path):
    tp, td = weights["target"][1], weights["draft"][1]
    eng = ServingEngine(tp, TCFG, device="cpu", draft_params=td,
                        draft_cfg=TDRAFT, spec_tokens=2, **KW)
    eng.submit(_prompts()[0], 8)
    eng.step()
    eng.step()
    save_engine_state(eng, str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="draft"):
        load_engine_state(ServingEngine(tp, TCFG, device="cpu", **KW),
                          str(tmp_path / "ck"))


def test_spec_perfect_draft_accepts_everything(weights):
    tp = weights["target"][1]
    prompts = _prompts(1, (6,))
    plain, _ = _port_run(tp, TCFG, prompts, [9], **KW)
    spec, eng = _port_run(tp, TCFG, prompts, [9], draft_params=tp,
                          draft_cfg=TCFG, spec_tokens=2, **KW)
    assert spec == plain
    assert eng.spec_accepted == eng.spec_drafted > 0
    # 9 tokens: the prefill's, two rounds of K+1 = 3, then plain decode
    # once fewer than K+1 remain
    assert eng.spec_rounds == 2


def test_spec_eos_mid_round(weights):
    tp, td = weights["target"][1], weights["draft"][1]
    prompt = _prompts(4, (5,))[0]
    plain, _ = _port_run(tp, TCFG, [prompt], [8], **KW)
    eos = plain[0][3]
    want = plain[0][:plain[0].index(eos) + 1]
    for kw in ({}, dict(draft_params=tp, draft_cfg=TCFG, spec_tokens=4),
               dict(draft_params=td, draft_cfg=TDRAFT, spec_tokens=4)):
        eng = ServingEngine(tp, TCFG, device="cpu", **KW, **kw)
        eng.submit(prompt, max_new_tokens=8, eos_id=eos)
        assert eng.run()[0].output == want
        assert eng.allocator.num_free == KW["num_pages"] - 1


def test_spec_stop_sequence_and_logprobs(weights):
    """A stop sequence ending inside a round cuts the output there; the
    logprobs of a speculative run equal the plain run's."""
    tp = weights["target"][1]
    prompt = _prompts(14, (9,))[0]
    eng = ServingEngine(tp, TCFG, device="cpu", **KW)
    eng.submit(prompt, 10, logprobs=True)
    ref = eng.run()[0]
    stop = ref.output[4:6]
    end = next(j for j in range(2, 11) if ref.output[j - 2:j] == stop)
    for kw in ({}, dict(draft_params=tp, draft_cfg=TCFG, spec_tokens=3)):
        eng = ServingEngine(tp, TCFG, device="cpu", **KW, **kw)
        eng.submit(prompt, 10, logprobs=True)
        eng.submit(prompt, 10, stop=[stop])
        full, cut = eng.run()
        assert full.output == ref.output
        # the verify's logits against the decode's: the tiny model's
        # 1e-4 between the two paths
        np.testing.assert_allclose(full.logprobs, ref.logprobs, atol=1e-4)
        assert cut.output == ref.output[:end]


def test_spec_mixed_batch_keeps_speculating(weights):
    tp, td = weights["target"][1], weights["draft"][1]
    rng = np.random.default_rng(5)
    greedy_prompt = rng.integers(0, 256, size=6).astype(np.int32)
    hot_prompt = rng.integers(0, 256, size=4).astype(np.int32)
    plain, _ = _port_run(tp, TCFG, [greedy_prompt], [14], **KW)
    eng = ServingEngine(tp, TCFG, device="cpu", draft_params=td,
                        draft_cfg=TDRAFT, spec_tokens=2, **KW)
    gid = eng.submit(greedy_prompt, max_new_tokens=14)
    hid = eng.submit(hot_prompt, max_new_tokens=4, temperature=0.8)
    done = {r.req_id: r for r in eng.run()}
    assert done[gid].output == plain[0]
    assert len(done[hid].output) == 4
    assert eng.spec_drafted > 0 and eng.spec_rounds >= 3


def test_spec_per_slot_budget_caps(weights):
    tp, td = weights["target"][1], weights["draft"][1]
    rng = np.random.default_rng(22)
    long_prompt = rng.integers(0, 256, size=6).astype(np.int32)
    short_prompt = rng.integers(0, 256, size=4).astype(np.int32)
    plain, _ = _port_run(tp, TCFG, [long_prompt], [12], **KW)
    plain_short, _ = _port_run(tp, TCFG, [short_prompt], [2], **KW)
    eng = ServingEngine(tp, TCFG, device="cpu", draft_params=td,
                        draft_cfg=TDRAFT, spec_tokens=4, **KW)
    lid = eng.submit(long_prompt, max_new_tokens=12)
    sid = eng.submit(short_prompt, max_new_tokens=2)  # under K+1
    done = {r.req_id: r for r in eng.run()}
    assert done[lid].output == plain[0]
    assert done[sid].output == plain_short[0]
    assert eng.spec_rounds > 0


def test_spec_adaptive_disable(weights):
    tp, td = weights["target"][1], weights["draft"][1]
    prompts = _prompts(13, (6,))
    plain, _ = _port_run(tp, TCFG, prompts, [24], **KW)
    spec, eng = _port_run(tp, TCFG, prompts, [24], draft_params=td,
                          draft_cfg=TDRAFT, spec_tokens=1,
                          spec_min_acceptance=0.99, **KW)
    assert spec == plain
    assert eng._spec_disabled and eng.stats()["spec_disabled"]
    assert eng.spec_rounds == 8 and eng.decode_dispatches > 0
    spec, eng = _port_run(tp, TCFG, prompts, [24], draft_params=tp,
                          draft_cfg=TCFG, spec_tokens=1,
                          spec_min_acceptance=0.5, **KW)
    assert spec == plain and not eng._spec_disabled


def test_spec_lagging_draft_catches_up(weights):
    """A request admitted while another waits decodes in plain dispatches
    first (the draft pool trails); the first round replays the gap in
    draft-only chunks of K+1 and the tokens stay the plain engine's."""
    tp = weights["target"][1]
    prompts = _prompts(15, (6, 9))
    plain, _ = _port_run(tp, TCFG, prompts, [20, 3], decode_steps=1,
                         **dict(KW, max_batch=1))
    eng = ServingEngine(tp, TCFG, device="cpu", draft_params=tp,
                        draft_cfg=TCFG, spec_tokens=2, decode_steps=1,
                        **dict(KW, max_batch=1))
    eng.submit(prompts[0], 20)
    eng._admit()  # both pools prefilled
    eng.spec_tokens, k = 0, eng.spec_tokens
    for _ in range(8):
        eng.step()  # plain decode: the draft pool stays at the prompt
    lag = int(eng.slot_lens[0] + 1 - eng.slot_dlens[0])
    assert lag == 9 > k + 1
    eng.spec_tokens = k
    before = eng.draft_prefill_dispatches
    eng.submit(prompts[1], 3)
    assert [r.output for r in eng.run()] == plain
    # the gap of 9 in chunks of K+1 = 3 down to one round's catch-up,
    # then the second prompt's own prefill
    assert eng.draft_prefill_dispatches - before == 2 + 1
    assert eng.spec_accepted == eng.spec_drafted > 0


def test_spec_with_prefix_cache(weights):
    tp, td = weights["target"][1], weights["draft"][1]
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 256, size=32).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 256, size=5).astype(
        np.int32)]) for _ in range(2)]
    kw = dict(KW, prefill_chunk=16, enable_prefix_cache=True)
    plain, _ = _port_run(tp, TCFG, prompts, [6, 6], **kw)
    spec, eng = _port_run(tp, TCFG, prompts, [6, 6], draft_params=td,
                          draft_cfg=TDRAFT, spec_tokens=2, **kw)
    assert spec == plain
    assert eng.prefix_cache_hit_tokens >= 32


def test_spec_lora_request(weights):
    """A request on an adapter verifies on it (the draft runs the base
    model): the tokens of the plain engine with the same adapter."""
    tp = weights["target"][1]
    rng = np.random.default_rng(16)
    q = TCFG.n_heads * TCFG.head_dim
    bank = {"a": {"layers": [
        {"wq": (rng.standard_normal((TCFG.dim, 2)).astype(np.float32),
                rng.standard_normal((2, q)).astype(np.float32) * 0.5)}
        for _ in range(TCFG.n_layers)]}}
    prompts = _prompts(17, (8, 10))

    def run(**kw):
        eng = ServingEngine(tp, TCFG, device="cpu", lora_params=bank,
                            **KW, **kw)
        eng.submit(prompts[0], 9, lora="a")
        eng.submit(prompts[1], 9)
        return [r.output for r in eng.run()], eng

    plain, _ = run()
    spec, eng = run(draft_params=tp, draft_cfg=TCFG, spec_tokens=3)
    assert spec == plain and eng.spec_rounds > 0
    assert eng.spec_accepted < eng.spec_drafted  # the adapter disagrees


def test_spec_validation_errors(weights):
    """JAX's refusals with JAX's messages, and a JAX module as the
    draft."""
    jp, tp = weights["target"]
    jd, td = weights["draft"]
    kw = dict(max_batch=1, page_size=16, num_pages=64, max_pages_per_seq=8,
              max_seq_len=256)
    bad = dict(vocab_size=JCFG.vocab_size + 1, **DRAFT)
    jdraft = dict(draft_params=jd, draft_cfg=JDRAFT)
    tdraft = dict(draft_params=td, draft_cfg=TDRAFT)
    cases = [  # (JAX's arguments, the port's)
        (dict(spec_tokens=2), dict(spec_tokens=2)),
        (dict(jdraft, spec_tokens=2, layout="split"),
         dict(tdraft, spec_tokens=2, layout="split")),
        (dict(jdraft, spec_tokens=2, sample=lambda lg: lg.argmax(-1)),
         dict(tdraft, spec_tokens=2, sample=lambda lg: lg.argmax(-1))),
        (dict(jdraft, spec_tokens=2, sampler=object()),
         dict(tdraft, spec_tokens=2, sampler=object())),
        (dict(jdraft, spec_tokens=2,
              draft_cfg=jllama.LlamaConfig.tiny(**bad)),
         dict(tdraft, spec_tokens=2,
              draft_cfg=tllama.LlamaConfig.tiny(**bad))),
    ]
    for jkw, tkw in cases:
        with pytest.raises(ValueError) as want:
            JaxEngine(jp, JCFG, **kw, **jkw)
        with pytest.raises(ValueError) as got:
            ServingEngine(tp, TCFG, device="cpu", **kw, **tkw)
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="draft_model"):
        ServingEngine(tp, TCFG, device="cpu", draft_params=td,
                      draft_cfg=TDRAFT, draft_model=jllama, spec_tokens=2,
                      **kw)
    # a draft of a family outside the port raises under a mesh too
    with pytest.raises(NotImplementedError, match="draft_model"):
        ServingEngine(tp, TCFG, device="cpu", draft_params=td,
                      draft_cfg=TDRAFT, draft_model=jllama, spec_tokens=2,
                      mesh=object(), **kw)


def test_spec_sliding_window_model(weights):
    cfg = tllama.LlamaConfig.tiny(window_size=24)
    tp = _torch(jllama.init_params(jllama.LlamaConfig.tiny(window_size=24),
                                   jax.random.key(2)))
    td = weights["draft"][1]
    prompt = _prompts(8, (20,))
    kw = dict(KW, max_batch=1)
    plain, _ = _port_run(tp, cfg, prompt, [16], **kw)
    spec, eng = _port_run(tp, cfg, prompt, [16], draft_params=td,
                          draft_cfg=TDRAFT, spec_tokens=3, **kw)
    assert spec == plain and eng.spec_rounds > 0


def test_spec_gpt2_family():
    cfg, dcfg = tgpt2.GPT2Config.tiny(), tgpt2.GPT2Config.tiny(n_layers=1)
    gen = torch.Generator().manual_seed(3)
    params = tgpt2.init_params(cfg, gen, device="cpu")
    dparams = tgpt2.init_params(dcfg, gen, device="cpu")
    prompt = _prompts(9, (7,))
    kw = dict(KW, max_batch=1, model=tgpt2)
    plain, _ = _port_run(params, cfg, prompt, [8], **kw)
    spec, eng = _port_run(params, cfg, prompt, [8], draft_params=dparams,
                          draft_cfg=dcfg, spec_tokens=2, **kw)
    assert spec == plain and eng.spec_rounds > 0


def test_spec_moe_target_llama_draft(weights):
    cfg = tmoe.MoEConfig.tiny()
    params = tmoe.init_params(cfg, torch.Generator().manual_seed(5),
                              device="cpu")
    prompt = _prompts(10, (6,))
    kw = dict(KW, max_batch=1, model=tmoe)
    plain, _ = _port_run(params, cfg, prompt, [6], **kw)
    spec, eng = _port_run(params, cfg, prompt, [6],
                          draft_params=weights["draft"][1],
                          draft_cfg=TDRAFT, draft_model=tllama,
                          spec_tokens=2, **kw)
    assert spec == plain and eng.spec_rounds > 0


def test_spec_sampled_topk1_matches_greedy(weights):
    tp, td = weights["target"][1], weights["draft"][1]
    prompts = _prompts(20, (6, 9))
    greedy, _ = _port_run(tp, TCFG, prompts, [10, 10], **KW)
    eng = ServingEngine(tp, TCFG, device="cpu", draft_params=td,
                        draft_cfg=TDRAFT, spec_tokens=2, **KW)
    for p in prompts:
        eng.submit(p, max_new_tokens=10, temperature=5.0, top_k=1)
    assert [r.output for r in eng.run()] == greedy
    assert eng.spec_rounds > 0


def test_spec_sampled_logit_bias_forces_token(weights):
    tp, td = weights["target"][1], weights["draft"][1]
    eng = ServingEngine(tp, TCFG, device="cpu", draft_params=td,
                        draft_cfg=TDRAFT, spec_tokens=3,
                        **dict(KW, max_batch=1))
    eng.submit(_prompts(21, (5,))[0], max_new_tokens=8, temperature=1.0,
               logit_bias={7: 1e9})
    assert eng.run()[0].output == [7] * 8
    assert eng.spec_rounds > 0


def test_spec_sampled_reproducible(weights):
    tp, td = weights["target"][1], weights["draft"][1]
    prompt = _prompts(23, (6,))[0]

    def run_once():
        eng = ServingEngine(tp, TCFG, device="cpu", sample_seed=9,
                            draft_params=td, draft_cfg=TDRAFT,
                            spec_tokens=2, **dict(KW, max_batch=1))
        eng.submit(prompt, max_new_tokens=8, temperature=0.9, top_p=0.9)
        return eng.run()[0].output

    assert run_once() == run_once()


def _chi2(n1, n2):
    pooled = (n1 + n2) / (n1.sum() + n2.sum())
    e1, e2 = pooled * n1.sum(), pooled * n2.sum()
    keep = pooled > 0
    chi2 = (((n1 - e1) ** 2 / np.maximum(e1, 1e-9))[keep].sum()
            + ((n2 - e2) ** 2 / np.maximum(e2, 1e-9))[keep].sum())
    return chi2, int(keep.sum()) - 1


@pytest.mark.parametrize("top_p", [0.0, 0.8])
def test_spec_sampled_distribution_chi2(top_p):
    """tests/test_speculative.py:361-400 on the port: the first token of
    the first round (output[1]) of 192 requests, speculative against the
    port's plain sampling, two-sample chi-square under the p = 0.001
    critical value; and with top-p 0.8 on both."""
    kw16 = dict(vocab_size=16, n_layers=1, n_heads=2)
    jt = jllama.init_params(jllama.LlamaConfig.tiny(dim=64, hidden_dim=128,
                                                    **kw16),
                            jax.random.key(30))
    jd = jllama.init_params(jllama.LlamaConfig.tiny(dim=32, hidden_dim=64,
                                                    **kw16),
                            jax.random.key(31))
    cfg = tllama.LlamaConfig.tiny(dim=64, hidden_dim=128, **kw16)
    dcfg = tllama.LlamaConfig.tiny(dim=32, hidden_dim=64, **kw16)
    prompt = np.asarray([3, 1, 4, 1], np.int32)

    def collect(**kw):
        eng = ServingEngine(_torch(jt), cfg, device="cpu", max_batch=8,
                            page_size=16, num_pages=192, max_pages_per_seq=2,
                            max_seq_len=32, sample_seed=5, **kw)
        ids = [eng.submit(prompt, max_new_tokens=4, temperature=1.0,
                          top_p=top_p) for _ in range(192)]
        done = {r.req_id: r for r in eng.run()}
        return np.asarray([done[i].output[1] for i in ids]), eng

    plain, _ = collect()
    spec, eng = collect(draft_params=_torch(jd), draft_cfg=dcfg,
                        spec_tokens=2)
    assert eng.spec_rounds > 0 and eng.spec_accepted > 0
    chi2, dof = _chi2(np.bincount(plain, minlength=16).astype(np.float64),
                      np.bincount(spec, minlength=16).astype(np.float64))
    assert chi2 < 37.7 + 2.0 * max(0, dof - 15), (chi2, dof)
