"""The PyTorch port's MoE expert parallelism and MoE under a mesh against
the JAX package's (tests/test_moe.py:60-90).

The tiny f32 MoE (4 experts, top 2) at one layer: the port runs in one
gloo world of 4 CPU ranks (utils/testing.py's `run_world` / `model_cases`),
JAX on the conftest's virtual CPU devices, both from the same params and
seeded numpy tokens.  Held, within 1e-5 (f32; JAX's own test allows
1e-4):
  * the expert-parallel forward over (expert 4), one expert a rank, at a
    capacity that drops nothing, to JAX's dense one-device forward;
  * at capacity factor 0.25, where tokens drop, to JAX's expert-parallel
    forward on the same mesh and to the port's one-device capacity
    mixture (make_expert_parallel_mlp(None, ...)), finite and apart from
    the dense mixture;
  * forward(mesh=) on (data 2, model 2) (llama's tensor-parallel
    attention, replicated experts) with its load-balancing term, to JAX's
    one-device forward;
  * the experts cut by shard_params(expert_axis=) and all-gathered back,
    bit for bit.
The MoE tensor-parallel engine is in tests/test_torch_gpt2_tp.py's world.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from aule_tpu.models import moe as jmoe
from aule_tpu.parallel.mesh import make_mesh
from aule_tpu_torch.models import moe as tmoe
from aule_tpu_torch.utils.testing import (assert_close, cap_cpu_threads,
                                          model_cases, run_world)
from aule_tpu_torch.utils.tree import tree_flatten

cap_cpu_threads()

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 (virtual) devices")

JCFG = jmoe.MoEConfig.tiny(n_layers=1)
TCFG = tmoe.MoEConfig.tiny(n_layers=1)
EP_MESH = ((4,), ("expert",))
TP_MESH = ((2, 2), ("data", "model"))
NO_DROP = float(JCFG.n_experts)   # JAX's test's factor: nothing drops
TIGHT = 0.25                      # JAX's: tokens drop
TOL = 1e-5


@pytest.fixture(scope="module")
def jparams():
    return jmoe.init_params(JCFG, jax.random.key(0))


def _tparams(jp):
    return tmoe.load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(seed):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (2, 16)).astype(np.int32)


@pytest.fixture(scope="module")
def world(jparams):
    """Every case in one world of 4 ranks: {name: rank 0's result}."""
    tp = _tparams(jparams)

    def tok(seed):
        return torch.from_numpy(_tokens(seed)).long()

    cases = {
        "ep": dict(kind="ep", mesh=EP_MESH, tokens=tok(2),
                   kwargs=dict(capacity_factor=NO_DROP)),
        "tight": dict(kind="ep", mesh=EP_MESH, tokens=tok(3),
                      kwargs=dict(capacity_factor=TIGHT)),
        "tp": dict(kind="moe_forward", mesh=TP_MESH, tokens=tok(2)),
        "roundtrip": dict(kind="roundtrip", model="moe", mesh=EP_MESH,
                          shard_kwargs=dict(expert_axis="expert",
                                            model_axis=None)),
    }
    for c in cases.values():
        c.update(params=tp, cfg=TCFG)
    return dict(zip(cases, run_world(model_cases, 4, list(cases.values()))[0]))


@pytest.fixture(scope="module")
def dense(jparams):
    """JAX's one-device forward (the dense mixture) and its load-balancing
    term on the tokens of seed 2."""
    logits, aux = jmoe.forward(jparams, jnp.asarray(_tokens(2)), JCFG,
                               return_aux=True)
    return np.asarray(logits), float(aux)


def test_expert_parallel_matches_dense(world, dense):
    """EP over 4 expert ranks == JAX's dense single-device mixture."""
    assert_close(world["ep"]["logits"], dense[0], 0, TOL, "ep")


def test_capacity_drops_tokens(jparams, world):
    """capacity_factor 0.25: JAX's EP on the same mesh and the port's
    one-device capacity mixture, finite; the drops move it off the dense
    mixture."""
    got = world["tight"]["logits"]
    tokens = _tokens(3)
    mesh = make_mesh(*EP_MESH, devices=jax.devices()[:4])
    placed = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), jparams,
        jmoe.param_specs(JCFG, expert_axis="expert", model_axis=None),
        is_leaf=lambda x: isinstance(x, P))
    want = jmoe.make_expert_parallel_forward(mesh, JCFG,
                                             capacity_factor=TIGHT)(
        placed, jnp.asarray(tokens))
    assert np.isfinite(got.numpy()).all()
    assert_close(got, np.asarray(want), 0, TOL, "ep drops vs JAX's ep")
    tp = _tparams(jparams)
    t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        one = tmoe.forward(tp, t, TCFG, moe_mlp=tmoe.make_expert_parallel_mlp(
            None, TCFG, capacity_factor=TIGHT))
        dense = tmoe.forward(tp, t, TCFG)
    assert_close(got, one, 0, TOL, "ep drops vs one device")
    assert float((one - dense).abs().max()) > 1e-3


def test_capacity_and_dispatch():
    """expert_capacity's rule and the dispatch's positions (JAX
    l.211-230): a pair past its expert's capacity drops."""
    assert tmoe.expert_capacity(32, TCFG, 2.0) == \
        jmoe.expert_capacity(32, JCFG, 2.0) == 32
    assert tmoe.expert_capacity(1, TCFG, 0.25) == JCFG.top_k
    w = np.zeros((5, 4), np.float32)
    w[:, 1] = 0.5
    w[:, 2] = 0.5
    w[4, 2], w[4, 3] = 0.0, 0.5
    disp, comb = tmoe._dispatch_tensors(torch.from_numpy(w), 3)
    jd, jc = jmoe._dispatch_tensors(jnp.asarray(w), JCFG, 3)
    assert np.array_equal(disp.numpy(), np.asarray(jd))
    assert np.array_equal(comb.numpy(), np.asarray(jc))
    assert disp[3].sum() == 0 and disp[4, 3, 0] == 1


def test_moe_forward_mesh(world, dense):
    """forward(mesh=) over (data 2, model 2), the load-balancing term
    averaged over the data ranks' rows == JAX's one-device forward."""
    assert_close(world["tp"]["logits"], dense[0], 0, TOL, "moe tp logits")
    assert abs(world["tp"]["aux"] - dense[1]) < TOL


def test_moe_shards_roundtrip(jparams, world):
    """The JAX package's MoE params cut by shard_params(expert_axis=) (one
    expert a rank, the attention replicated) and all-gathered back: bit
    for bit."""
    got = world["roundtrip"]
    for i, (a, b) in enumerate(zip(tree_flatten(got["params"]),
                                   jax.tree.leaves(jparams))):
        assert torch.equal(a, torch.from_numpy(np.array(b))), i
    # a layer's leaves in order: attn_norm, e_down, e_gate, e_up, ...
    assert got["shapes"][3][0] == 1 and got["shapes"][4][0] == 1
    assert tmoe.param_specs(TCFG, expert_axis="expert")["layers"][0][
        "e_up"] == ("expert", None, None)
