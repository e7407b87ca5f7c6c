"""The tensor-parallel serving engine of the PyTorch port against the
JAX package's (the model steps: tests/test_torch_tp.py).

`ServingEngine(mesh=)` on a (1, 2) mesh over the tiny f32 Llama: split
pools, fused, fused int8, int8 with chunked prefill, and speculative
decoding with the draft sharded on the same axis.  The port's engines run
in one spawned gloo world of 2 CPU ranks (utils/testing.py's
`run_world`), every rank driving the same loop; their tokens equal JAX's
tensor-parallel engine's on the conftest's virtual CPU devices and the
port's single-device engine's, and the speculative run's round, draft
and acceptance counters equal the single-device run's.
"""

import jax
import numpy as np
import pytest

from aule_tpu.models import llama as jllama
from aule_tpu.serving.engine import ServingEngine as JaxEngine
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.serving.engine import ServingEngine
from aule_tpu_torch.utils.testing import cap_cpu_threads, run_world, tp_cases
from tests.test_torch_tp import (JCFG, KW, MESHES, NAMES, TCFG, _jmesh,
                                 _jparams, _tparams)

cap_cpu_threads()

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs 2 (virtual) devices")

JDRAFT = jllama.LlamaConfig.tiny(dim=64, n_layers=1, n_heads=2,
                                 hidden_dim=128)
TDRAFT = tllama.LlamaConfig.tiny(dim=64, n_layers=1, n_heads=2,
                                 hidden_dim=128)


def _engine_cases():
    """{name: (engine kwargs, prompts, max_new, draft?)} on the (1, 2)
    mesh: JAX's test_model.py / test_speculative.py TP engines, plus a
    chunked prefill."""
    def prompts(seed, sizes):
        rng = np.random.default_rng(seed)
        return [rng.integers(0, 256, size=n).astype(np.int32) for n in sizes]

    return {
        "split": (dict(layout="split"), prompts(8, (7, 13)), 5, False),
        "fused": (dict(layout="fused"), prompts(9, (7, 13)), 5, False),
        "fused_int8": (dict(layout="fused", quantized=True),
                       prompts(9, (7, 13)), 5, False),
        "chunked_int8": (dict(quantized=True, prefill_chunk=8),
                         prompts(10, (21, 13)), 6, False),
        "spec": (dict(spec_tokens=2), prompts(12, (9,)), 7, True),
    }


@pytest.fixture(scope="module")
def jparams():
    return _jparams(JCFG, 0), _jparams(JDRAFT, 7)


@pytest.fixture(scope="module")
def worlds(jparams):
    """Every engine case in one world of 2 ranks: {name: rank 0's
    outputs and speculation counters}."""
    tp, td = (_tparams(p) for p in jparams)
    names, cases = [], []
    for name, (ekw, prompts, max_new, spec) in _engine_cases().items():
        kw = dict(KW, **ekw)
        if spec:
            kw["draft_cfg"] = TDRAFT
        names.append(name)
        cases.append(dict(kind="engine", mesh=(MESHES["1x2"], NAMES),
                          params=tp, cfg=TCFG, kwargs=kw,
                          draft=td if spec else None, prompts=prompts,
                          max_new=max_new))
    return dict(zip(names, run_world(tp_cases, 2, cases)[0]))


def _run_engine(eng, prompts, max_new):
    ids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done = {r.req_id: r for r in eng.run()}
    return [done[i].output for i in ids]


@pytest.mark.parametrize("name", list(_engine_cases()))
def test_tp_engine_tokens(worlds, jparams, name):
    """The port's TP engine emits JAX's TP engine's tokens and the port's
    single-device engine's."""
    jp, jd = jparams
    ekw, prompts, max_new, spec = _engine_cases()[name]
    got = worlds[name]
    jkw, tkw = dict(KW, **ekw), dict(KW, **ekw)
    if spec:
        jkw.update(draft_params=jd, draft_cfg=JDRAFT)
        tkw.update(draft_params=_tparams(jd), draft_cfg=TDRAFT)
    jeng = JaxEngine(jp, JCFG, mesh=_jmesh(MESHES["1x2"]), **jkw)
    want = _run_engine(jeng, prompts, max_new)
    teng = ServingEngine(_tparams(jp), TCFG, device="cpu", **tkw)
    single = _run_engine(teng, prompts, max_new)
    assert got["outputs"] == want, (got["outputs"], want)
    assert got["outputs"] == single, (got["outputs"], single)
    if spec:
        st = teng.stats()
        assert got["spec"] == (st["spec_rounds"], st["spec_drafted"],
                               st["spec_accepted"])
        assert got["spec"][1] > 0 and jeng.spec_drafted == got["spec"][1]
