"""The PyTorch port's pipeline parallelism (parallel/pipeline.py) against
the JAX package's (tests/test_pipeline.py).

The tiny f32 Llama at 4 layers, one a stage over a (pipe 4) mesh: the
port runs in one gloo world of 4 CPU ranks (utils/testing.py's
`run_world` / `model_cases`), each rank on its stage's stacked layers,
JAX on the conftest's virtual CPU devices, both from the same params and
seeded numpy tokens.  Held: the stack / unstack round trip and the JAX
package's stacked tree carried across, bit for bit; the pipelined forward
at 1, 2 and 4 microbatches to JAX's one-device forward and the port's,
within 2e-5; the pipelined SGD step to JAX's pipelined step on the same
mesh (which tests/test_pipeline.py holds to JAX's one-device step) and
to the port's one-device step (loss within 1e-5, params within 1e-4,
JAX's own tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from aule_tpu.models import llama as jllama
from aule_tpu.parallel import pipeline as jpipe
from aule_tpu.parallel.mesh import make_mesh
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.parallel import pipeline as tpipe
from aule_tpu_torch.utils.testing import (assert_close, cap_cpu_threads,
                                          model_cases, run_world)
from aule_tpu_torch.utils.tree import tree_flatten

cap_cpu_threads()

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 (virtual) devices")

JCFG = jllama.LlamaConfig.tiny(n_layers=4)
TCFG = tllama.LlamaConfig.tiny(n_layers=4)
MESH = ((4,), ("pipe",))
MICROBATCHES = (1, 2, 4)
LR = 1e-2
FWD_TOL = 2e-5
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4   # JAX's (tests/test_pipeline.py:81)


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(JCFG, jax.random.key(0))


def _tparams(jp):
    return tllama.load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _fwd_tokens():
    return np.random.default_rng(0).integers(
        0, JCFG.vocab_size, (4, 24)).astype(np.int32)


def _step_tokens():
    return np.random.default_rng(1).integers(
        0, JCFG.vocab_size, (4, 17)).astype(np.int32)


@pytest.fixture(scope="module")
def world(jparams):
    """Every case in one world of 4 ranks: {name: rank 0's result}."""
    stacked = tpipe.stack_layer_params(_tparams(jparams))
    fwd = torch.from_numpy(_fwd_tokens()).long()
    cases = {f"forward{m}": dict(kind="pipeline_forward", tokens=fwd,
                                 kwargs=dict(microbatches=m))
             for m in MICROBATCHES}
    cases["step"] = dict(kind="pipeline_step",
                         tokens=torch.from_numpy(_step_tokens()).long(),
                         kwargs=dict(microbatches=2, lr=LR))
    cases["roundtrip"] = dict(kind="roundtrip", model="pipeline")
    for c in cases.values():
        c.update(mesh=MESH, params=stacked, cfg=TCFG)
    return dict(zip(cases, run_world(model_cases, 4, list(cases.values()))[0]))


def test_stack_roundtrip(jparams, world):
    """stack / unstack give back the params; the JAX package's stacked
    tree carried across is the port's stack of the carried params; each
    stage's shard of it all-gathers back; all bit for bit."""
    tp = _tparams(jparams)
    st = tpipe.stack_layer_params(tp)
    for a, b in zip(tree_flatten(tpipe.unstack_layer_params(st)),
                    tree_flatten(tp)):
        assert torch.equal(a, b)
    carried = tpipe.load_jax_params(jax.tree.map(
        np.asarray, jpipe.stack_layer_params(jparams)), device="cpu")
    for a, b in zip(tree_flatten(carried), tree_flatten(st)):
        assert torch.equal(a, b)
    for a, b in zip(tree_flatten(world["roundtrip"]["params"]),
                    tree_flatten(st)):
        assert torch.equal(a, b)
    # each stage held one layer of the four
    assert world["roundtrip"]["shapes"][2][0] == 1


@pytest.fixture(scope="module")
def plain_logits(jparams):
    """JAX's one-device forward and the port's on the forward tokens."""
    tokens = _fwd_tokens()
    with torch.no_grad():
        one = tllama.forward(_tparams(jparams),
                             torch.from_numpy(tokens).long(), TCFG)
    return np.asarray(jllama.forward(jparams, jnp.asarray(tokens), JCFG)), one


@pytest.mark.parametrize("microbatches", MICROBATCHES)
def test_pipeline_forward_matches_plain(world, plain_logits, microbatches):
    got = world[f"forward{microbatches}"]["logits"]
    want, one = plain_logits
    assert_close(got, want, 0, FWD_TOL,
                 f"pp forward mb={microbatches} vs JAX")
    assert_close(got, one, 0, FWD_TOL,
                 f"pp forward mb={microbatches} vs one device")


def test_pipeline_train_step_matches_plain(jparams, world):
    """One pipelined SGD step == one plain step of the port == JAX's
    pipelined step on the same mesh: the backward really runs the reverse
    schedule."""
    got = world["step"]
    tokens = _step_tokens()
    tnew, tloss = tllama.train_step(_tparams(jparams),
                                    torch.from_numpy(tokens).long(), TCFG,
                                    lr=LR)
    mesh = make_mesh(*MESH, devices=jax.devices()[:4])
    placed = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        jpipe.stack_layer_params(jparams), jpipe.pipeline_param_specs(),
        is_leaf=lambda x: isinstance(x, P))
    mnew, mloss = jpipe.make_pipeline_train_step(
        mesh, JCFG, microbatches=2, lr=LR)(placed, jnp.asarray(tokens))
    for want in (tloss, mloss):
        assert abs(got["loss"] - float(want)) < LOSS_TOL
    back = tpipe.unstack_layer_params(got["params"])
    for what, want in (("port one device", tnew),
                       ("JAX pipeline", jpipe.unstack_layer_params(
                           jax.device_get(mnew)))):
        for i, (a, b) in enumerate(zip(tree_flatten(back),
                                       tree_flatten(want))):
            b = b.detach() if isinstance(b, torch.Tensor) else b
            assert_close(a, np.asarray(b, np.float32), 0, PARAM_TOL,
                         f"pp params vs {what} leaf {i}")

