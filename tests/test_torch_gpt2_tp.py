"""The PyTorch port's GPT-2 tensor parallelism, and the tensor-parallel
engine of GPT-2 and MoE, against the JAX package's (tests/test_gpt2.py:
111-160).

The tiny f32 GPT-2 (2 heads, D64) and the tiny MoE: the port runs in one
gloo world of 2 CPU ranks (utils/testing.py's `run_world` /
`model_cases`), JAX on the conftest's virtual CPU devices, both from the
same params and seeded numpy inputs.  Held:
  * forward(mesh=) on (data 1, model 2), one head a rank through the
    qkv-major w_qkv, and on (data 2, model 1), to JAX's forward(mesh=) on
    (1, 2) (which tests/test_gpt2.py holds to its one-device forward) and
    to the port's one-device forward, within 2e-5 (JAX's test's
    tolerance);
  * ServingEngine(model=gpt2, mesh=) over fused f32 and chunked int8
    pools, and ServingEngine(model=moe, mesh=), token for token to the
    port's one-device engine (which tests/test_torch_gpt2.py and
    test_torch_moe.py hold to JAX's), the fused f32 run to JAX's
    one-device engine too;
  * GPT-2's params cut by shard_params (w_qkv [3, dim, dim/2] a rank) and
    all-gathered back, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from aule_tpu.models import gpt2 as jgpt2
from aule_tpu.models import moe as jmoe
from aule_tpu.parallel.mesh import make_mesh
from aule_tpu.serving.engine import ServingEngine as JaxEngine
from aule_tpu_torch.models import gpt2 as tgpt2
from aule_tpu_torch.models import moe as tmoe
from aule_tpu_torch.serving.engine import ServingEngine
from aule_tpu_torch.utils.testing import (assert_close, cap_cpu_threads,
                                          model_cases, run_world)
from aule_tpu_torch.utils.tree import tree_flatten

cap_cpu_threads()

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs 2 (virtual) devices")

JCFG = jgpt2.GPT2Config.tiny()
TCFG = tgpt2.GPT2Config.tiny()
JMOE = jmoe.MoEConfig.tiny(n_layers=1)
TMOE = tmoe.MoEConfig.tiny(n_layers=1)
TP = ((1, 2), ("data", "model"))
DP = ((2, 1), ("data", "model"))
TOL = 2e-5   # tests/test_gpt2.py:130
KW = dict(max_batch=2, page_size=16, num_pages=64, max_pages_per_seq=8,
          max_seq_len=256)
MAX_NEW = 5
ENGINES = {  # name -> (family, engine options)
    "gpt2 fused": ("gpt2", {}),
    "gpt2 int8 chunked": ("gpt2", dict(quantized=True, prefill_chunk=8)),
    "moe fused": ("moe", {}),
}
JAX_ENGINE = "gpt2 fused"   # also held to JAX's one-device engine


@pytest.fixture(scope="module")
def jparams():
    return (jgpt2.init_params(JCFG, jax.random.key(0)),
            jmoe.init_params(JMOE, jax.random.key(1)))


def _carry(family, jp):
    return family.load_jax_params(jax.tree.map(np.asarray, jp),
                                  device="cpu")


def _tokens():
    return np.random.default_rng(3).integers(0, 256, (2, 24)).astype(
        np.int32)


def _prompts():
    rng = np.random.default_rng(4)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in (7, 13)]


@pytest.fixture(scope="module")
def world(jparams):
    """Every case in one world of 2 ranks: {name: rank 0's result}."""
    gp, mp = _carry(tgpt2, jparams[0]), _carry(tmoe, jparams[1])
    tok = torch.from_numpy(_tokens()).long()
    cases = {
        "tp": dict(kind="gpt2_forward", mesh=TP, params=gp, cfg=TCFG,
                   tokens=tok),
        "dp": dict(kind="gpt2_forward", mesh=DP, params=gp, cfg=TCFG,
                   tokens=tok),
        "roundtrip": dict(kind="roundtrip", model="gpt2", mesh=TP,
                          params=gp, cfg=TCFG),
    }
    for name, (fam, kw) in ENGINES.items():
        cases[name] = dict(kind="engine", model=fam, mesh=TP,
                           params=gp if fam == "gpt2" else mp,
                           cfg=TCFG if fam == "gpt2" else TMOE,
                           kwargs=dict(KW, **kw), prompts=_prompts(),
                           max_new=MAX_NEW)
    return dict(zip(cases, run_world(model_cases, 2, list(cases.values()))[0]))


def test_gpt2_forward_tensor_parallel(jparams, world):
    """forward(mesh=) on (1, 2) and, the batch split, on (2, 1): JAX's
    forward(mesh=) on (1, 2) and the port's one-device forward."""
    jp = jparams[0]
    tokens = _tokens()
    mesh = make_mesh(*TP, devices=jax.devices()[:2])
    sharded = jax.device_put(jp, jax.tree.map(
        lambda s: NamedSharding(mesh, s), jgpt2.param_specs(JCFG),
        is_leaf=lambda x: isinstance(x, P)))
    want = np.asarray(jgpt2.forward(sharded, jnp.asarray(tokens), JCFG,
                                    mesh=mesh))
    with torch.no_grad():
        one = tgpt2.forward(_carry(tgpt2, jp),
                            torch.from_numpy(tokens).long(), TCFG)
    for name in ("tp", "dp"):
        assert_close(world[name]["logits"], want, TOL, TOL,
                     f"gpt2 forward {name} vs JAX's mesh forward")
        assert_close(world[name]["logits"], one, TOL, TOL,
                     f"gpt2 forward {name} vs one device")


def _run(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new_tokens=MAX_NEW)
    return [r.output for r in eng.run()]


@pytest.mark.parametrize("name", list(ENGINES))
def test_tp_engine_tokens(jparams, world, name):
    """The tensor-parallel engine emits the port's one-device engine's
    tokens (and JAX's, for JAX_ENGINE)."""
    fam, kw = ENGINES[name]
    jfam, tfam, jcfg, tcfg, jp = ((jgpt2, tgpt2, JCFG, TCFG, jparams[0])
                                  if fam == "gpt2" else
                                  (jmoe, tmoe, JMOE, TMOE, jparams[1]))
    got = world[name]["outputs"]
    one = _run(ServingEngine(_carry(tfam, jp), tcfg, model=tfam,
                             device="cpu", **KW, **kw), _prompts())
    assert got == one, (got, one)
    if name == JAX_ENGINE:
        want = _run(JaxEngine(jp, jcfg, model=jfam, **KW, **kw), _prompts())
        assert got == want, (got, want)


def test_gpt2_shards_roundtrip(jparams, world):
    """GPT-2's params cut by shard_params on (1, 2) and all-gathered back:
    bit for bit; each rank's w_qkv holds its head's columns of all three
    projections."""
    got = world["roundtrip"]
    for i, (a, b) in enumerate(zip(tree_flatten(got["params"]),
                                   jax.tree.leaves(jparams[0]))):
        assert torch.equal(a, torch.from_numpy(np.array(b))), i
    names = sorted(jparams[0]["layers"][0])
    shapes = dict(zip(names, got["shapes"][2:2 + len(names)]))
    assert shapes["w_qkv"] == (3, JCFG.dim, JCFG.dim // 2)
    assert shapes["w_proj"] == (JCFG.dim // 2, JCFG.dim)
    assert shapes["fc_b"] == (4 * JCFG.dim // 2,)
