"""The prefix cache of the PyTorch port's engine against the JAX package's
(tests/test_prefix_cache.py's cases, across the packages).

  * `_prompt_page_hashes` equals JAX's byte for byte, seeded by the
    adapter's name;
  * a cached engine over f32 and int8 pools, round after round (shared
    prefixes co-scheduled, a prompt resubmitted under pool pressure that
    evicts, a prompt whose first cached page was evicted): tokens identical
    to JAX's engine, and after every round the same `_prefix_cache` map,
    the same `_page_rc` (its order is the eviction order), the same free
    list and the same `stats()` counters;
  * twelve requests on one shared prefix, adapters cycling base / a / b on
    eight slots (chip_smoke.py's edges runs in small): each adapter group's
    first request registers the prefix and the other nine hit it, as in
    JAX, and no request reads another group's pages; the cached tokens
    equal the uncached engine's;
  * `enable_prefix_cache` without `prefill_chunk` raises ValueError, as
    JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.models import llama as jllama
from aule_tpu.serving.engine import ServingEngine as JaxEngine
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.serving.engine import ServingEngine
from aule_tpu_torch.utils.testing import cap_cpu_threads

cap_cpu_threads()

JCFG = jllama.LlamaConfig.tiny()
TCFG = tllama.LlamaConfig.tiny()
KW = dict(max_batch=2, page_size=16, num_pages=11, max_pages_per_seq=10,
          max_seq_len=256, decode_steps=4, prefill_chunk=16,
          enable_prefix_cache=True)
STATS = ("free_pages", "prefix_cache_pages", "prefix_cache_hit_tokens",
         "tokens_generated", "prefill_dispatches")


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(JCFG, jax.random.key(0))
    return jp, tllama.load_jax_params(jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _rand(rng, n):
    return rng.integers(0, 256, size=n).astype(np.int32)


def _adapter(seed, rank=4, scale=0.2):
    rng = np.random.default_rng(seed)
    q = JCFG.n_heads * JCFG.head_dim
    kv = JCFG.n_kv_heads * JCFG.head_dim
    dims = {"wq": (JCFG.dim, q), "wk": (JCFG.dim, kv), "wv": (JCFG.dim, kv),
            "wo": (q, JCFG.dim)}
    return {"layers": [
        {t: ((rng.standard_normal((i, rank)) * scale).astype(np.float32),
             (rng.standard_normal((rank, o)) * scale).astype(np.float32))
         for t, (i, o) in dims.items()} for _ in range(JCFG.n_layers)]}


@pytest.mark.parametrize("lora", [None, "x"])
def test_page_hashes_equal_jax(params, lora):
    jp, tp = params
    adapters = {"x": _adapter(1)}
    jeng = JaxEngine(jp, JCFG, lora_params=adapters, **KW)
    teng = ServingEngine(tp, TCFG, device="cpu", lora_params=adapters, **KW)
    prompt = _rand(np.random.default_rng(2), 53)  # 3 full pages
    want = jeng._prompt_page_hashes(prompt, lora)
    got = teng._prompt_page_hashes(prompt, lora)
    assert got == want and len(got) == 3
    assert got[0] != teng._prompt_page_hashes(prompt, "y" if lora else "x")[0]
    # the cap: a prompt of exactly 3 pages reuses at most 2
    teng._prefix_cache = {h: i + 1 for i, h in enumerate(got)}
    assert len(teng._prefix_hits(prompt[:48], lora)[0]) == 2


def _state(eng):
    st = eng.stats()
    return ({k: st[k] for k in STATS}, dict(eng._prefix_cache),
            list(eng._page_rc.items()), list(eng.allocator.free_list()))


QDT = {"int8": (jnp.int8, torch.int8)}


@pytest.mark.parametrize("qname", [None, "int8"])
def test_cached_engine_matches_jax_round_by_round(params, qname):
    """Four rounds on a 10-page pool: (1) two prompts on one 2-page prefix
    co-scheduled (the second hits the first's pages), (2) a new prompt, (3)
    the first prompt again with 100 new tokens, which evicts the oldest
    unheld page, (4) round 2's prompt again, whose first page went: it
    hits nothing and registers a new copy.  After each round both engines
    hold the same tokens, cache maps, refcounts, free list and stats."""
    jp, tp = params
    jkw, tkw = dict(KW), dict(KW)
    if qname is not None:
        jkw.update(quantized=True, quant_dtype=QDT[qname][0])
        tkw.update(quantized=True, quant_dtype=QDT[qname][1])
    jeng = JaxEngine(jp, JCFG, **jkw)
    teng = ServingEngine(tp, TCFG, device="cpu", **tkw)
    rng = np.random.default_rng(3)
    base = _rand(rng, 32)
    a = np.concatenate([base, _rand(rng, 5)])
    b = np.concatenate([base, _rand(rng, 9)])
    c = _rand(rng, 35)
    rounds = [[(a, 4), (b, 4)], [(c, 4)], [(a, 100)], [(c, 4)]]
    cache_sizes = []
    for i, batch in enumerate(rounds):
        outs = []
        for eng in (jeng, teng):
            for p, n in batch:
                eng.submit(p, n)
            outs.append([r.output for r in eng.run()])
        assert outs[1] == outs[0], f"round {i + 1}"
        assert _state(teng) == _state(jeng), f"round {i + 1}"
        cache_sizes.append(len(teng._prefix_cache))
    assert teng.prefix_cache_hit_tokens == 64  # b in round 1, a in round 3
    assert cache_sizes == [2, 4, 3, 4]  # round 3 evicted one page
    # the cached tokens are the uncached engine's
    plain = ServingEngine(tp, TCFG, device="cpu",
                          **dict(tkw, enable_prefix_cache=False,
                                 num_pages=64))
    for p, n in rounds[0] + rounds[2]:
        plain.submit(p, n)
    want = [r.output for r in plain.run()]
    again = ServingEngine(tp, TCFG, device="cpu", **tkw)
    for p, n in rounds[0]:
        again.submit(p, n)
    got = [r.output for r in again.run()]
    again.submit(*rounds[2][0])
    got += [r.output for r in again.run()]
    assert got == want


def test_adapter_groups_hit_only_their_own_pages(params):
    """Twelve prompts on one 2-page prefix, adapters cycling base, a, b
    over them, on eight slots with multi-step decode: each group's first
    request registers the prefix and the other nine reuse it, so the hits
    are 9 x 32 tokens, as JAX's engine counts them; the requests of one
    group read the same prefix pages and no other group's; the tokens
    equal JAX's and the uncached engine's."""
    jp, tp = params
    adapters = {"a": _adapter(4), "b": _adapter(5)}
    kw = dict(KW, max_batch=8, num_pages=64)
    rng = np.random.default_rng(6)
    base = _rand(rng, 32)
    prompts = [np.concatenate([base, _rand(rng, n)])
               for n in (7, 3, 12, 1, 9, 15, 4, 6, 11, 2, 8, 5)]
    groups = [(None, "a", "b")[i % 3] for i in range(len(prompts))]
    jeng = JaxEngine(jp, JCFG, lora_params=adapters, **kw)
    teng = ServingEngine(tp, TCFG, device="cpu", lora_params=adapters, **kw)
    seen = {}
    run_prefill = teng._run_prefill

    def spy(slot, req, hit_len=0):
        seen[req.req_id] = (req.lora, teng.slot_pages[slot][:2], hit_len)
        return run_prefill(slot, req, hit_len)

    teng._run_prefill = spy
    outs = []
    for eng in (jeng, teng):
        for p, g in zip(prompts, groups):
            eng.submit(p, 3, lora=g)
        outs.append([r.output for r in eng.run()])
    assert outs[1] == outs[0]
    assert teng.prefix_cache_hit_tokens == jeng.prefix_cache_hit_tokens \
        == 9 * 32
    assert _state(teng) == _state(jeng)
    by_group = {}
    for rid, (g, pages, hit) in seen.items():
        assert hit == (0 if rid < 3 else 32)
        by_group.setdefault(g, set()).add(tuple(pages))
    assert all(len(v) == 1 for v in by_group.values())  # one copy a group
    firsts = [set(next(iter(v))) for v in by_group.values()]
    assert not (firsts[0] & firsts[1] or firsts[0] & firsts[2]
                or firsts[1] & firsts[2])
    plain = ServingEngine(tp, TCFG, device="cpu", lora_params=adapters,
                          **dict(kw, enable_prefix_cache=False))
    for p, g in zip(prompts, groups):
        plain.submit(p, 3, lora=g)
    assert [r.output for r in plain.run()] == outs[1]


def test_prefix_cache_needs_chunked_prefill(params):
    jp, tp = params
    kw = dict(KW, prefill_chunk=None)
    with pytest.raises(ValueError, match="prefill_chunk"):
        JaxEngine(jp, JCFG, **kw)
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(tp, TCFG, device="cpu", **kw)
