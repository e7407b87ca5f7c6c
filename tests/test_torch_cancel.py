"""Request cancellation in the port's engine against the JAX package's
(tests/test_cancel.py's six cases).

Each case runs on both engines over the same tiny f32 weights (carried
across by `load_jax_params`), the port's on the CPU: cancelling a waiting
request, a running one whose pages admit a queued one, a cancel from the
streaming `on_token` callback mid multi-step decode, mid speculative round
and on the prefill-emitted first token with the prefix cache on, and
cancels of unknown or finished ids.  Held: each request's tokens and
`cancelled` flag, the tokens the callbacks saw, and the allocator's free
pages afterwards, equal between the two engines and to the JAX suite's
own expectations.
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


def _engines(params, **kw):
    """(JAX's engine, the port's) on the same weights and options;
    `draft` in kw means self-drafting with the target's weights."""
    jkw, tkw = dict(KW, **kw), dict(KW, **kw)
    if jkw.pop("draft", False):
        tkw.pop("draft")
        jkw.update(draft_params=params[0], draft_cfg=JCFG)
        tkw.update(draft_params=params[1], draft_cfg=TCFG)
    return (JaxEngine(params[0], JCFG, **jkw),
            ServingEngine(params[1], TCFG, device="cpu", **tkw))


def _summary(done):
    return {r.req_id: (list(r.output), bool(r.cancelled)) for r in done}


def _both(params, case, **kw):
    """Run `case(engine)` on both engines; their results must agree."""
    results = [case(eng) for eng in _engines(params, **kw)]
    assert results[1] == results[0]
    return results[1]


def test_cancel_waiting_request(params):
    def case(eng):
        rng = np.random.default_rng(0)
        keep = eng.submit(rng.integers(0, 256, size=6).astype(np.int32), 4)
        # fill both slots so the third stays waiting
        eng.submit(rng.integers(0, 256, size=6).astype(np.int32), 4)
        victim = eng.submit(rng.integers(0, 256, size=6).astype(np.int32),
                            4)
        eng.step()  # admits the first two
        assert eng.cancel(victim)
        done = _summary(eng.run())
        assert done[victim] == ([], True)
        assert not done[keep][1] and len(done[keep][0]) == 4
        return done, eng.allocator.num_free

    _both(params, case)


def test_cancel_running_frees_pages_for_waiting(params):
    """A cancelled running request's pages admit the queued one, and the
    survivor's tokens match its solo run."""
    rng = np.random.default_rng(1)
    p_short = rng.integers(0, 256, size=5).astype(np.int32)
    big = rng.integers(0, 256, size=40).astype(np.int32)

    def solo(eng):
        eng.submit(p_short, max_new_tokens=4)
        return eng.run()[0].output

    want = _both(params, solo)

    def case(eng):
        v1 = eng.submit(big, max_new_tokens=24)       # 4 pages
        v2 = eng.submit(big, max_new_tokens=24)       # 4 pages (pool full)
        kid = eng.submit(p_short, max_new_tokens=4)   # waits
        eng.step()
        assert eng.num_running == 2 and eng.waiting
        assert eng.cancel(v1) and eng.cancel(v2)
        done = _summary(eng.run())
        assert done[v1][1] and done[v2][1]
        assert done[kid] == (want, False)
        assert eng.allocator.num_free == 9 - 1  # all pages back (1 scratch)
        return done

    # tiny pool: two big requests exhaust it; the third must wait
    _both(params, case, num_pages=9, max_pages_per_seq=4)


def _cancel_at(eng, n, steps_kw):
    """Submit one request whose on_token callback cancels it at its n-th
    token; (tokens seen, its result, free pages)."""
    rng = np.random.default_rng(steps_kw)
    seen = []

    def cb(rid, tok):
        seen.append(int(tok))
        if len(seen) == n:
            assert eng.cancel(rid)

    rid = eng.submit(rng.integers(0, 256, size=6).astype(np.int32), 16,
                     on_token=cb)
    done = eng.run()
    assert done[0].req_id == rid and done[0].cancelled
    assert len(done[0].output) == n == len(seen)
    assert eng.allocator.num_free == 64 - 1
    return seen, _summary(done)


def test_cancel_from_on_token_mid_decode(params):
    """cancel() invoked from the streaming callback, mid multi-step
    decode, stops emission at once and retires cleanly."""
    _both(params, lambda eng: _cancel_at(eng, 3, 2), decode_steps=4)


def test_cancel_from_on_token_mid_spec_round(params):
    """The same inside a K=3 speculative round (it emits up to 4 tokens a
    round), self-drafting."""
    _both(params, lambda eng: _cancel_at(eng, 4, 3), draft=True,
          spec_tokens=3)


def test_cancel_unknown_or_finished(params):
    def case(eng):
        rng = np.random.default_rng(4)
        rid = eng.submit(rng.integers(0, 256, size=5).astype(np.int32), 2)
        assert not eng.cancel(rid + 999)
        done = _summary(eng.run())
        assert not eng.cancel(rid)  # already finished
        return done, eng.allocator.num_free

    _both(params, case)


def test_cancel_on_first_token_with_prefix_cache(params):
    """cancel() from the on_token callback on the prefill-emitted first
    token, with prefix caching on: no pages of the already-retired slot
    are registered, and every page comes back."""
    prompt = np.random.default_rng(5).integers(0, 256, size=20).astype(
        np.int32)  # > 1 page

    def case(eng):
        def cb(rid, tok):
            assert eng.cancel(rid)

        rid = eng.submit(prompt, max_new_tokens=6, on_token=cb)
        done = eng.run()
        assert done[0].req_id == rid and done[0].cancelled
        assert len(done[0].output) == 1
        assert eng.allocator.num_free == 64 - 1
        return _summary(done), eng.stats()["prefix_cache_pages"]

    _both(params, case, prefill_chunk=8, enable_prefix_cache=True)
