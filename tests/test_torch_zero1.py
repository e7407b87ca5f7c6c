"""The PyTorch port's dp x tp Llama training and ZeRO-1 AdamW against the
JAX package's (tests/test_optimizer.py:50-102 and the dp x tp train step
of `__graft_entry__.dryrun_multichip`).

The port runs in one gloo world of 4 CPU ranks on a (data 2,
model 2) mesh (utils/testing.py's `run_world` / `model_cases`), each rank
on its shards; JAX on the conftest's virtual CPU devices; both from the
same params and seeded numpy tokens.  Held: the SGD step
(`llama.train_step(mesh=)`) to JAX's on the same mesh and to the port's
one-device step, the loss within 1e-5 and the params within 1e-5; two
ZeRO-1 AdamW steps (JAX's test takes three) to JAX's ZeRO-1 on the same
mesh (which tests/test_optimizer.py holds to JAX's one-device AdamW) and
to the port's one-device AdamW (which tests/test_torch_optimizer.py holds
to JAX's), the losses within 1e-5 and the params within JAX's own 2e-4
("sharded-reduction accumulation order wiggles the last ulps"), the
moments cut over the data axis as JAX's; one step with clipping, a master
copy and micro-batches to the port's one-device step (the same
tolerances); `zero1_specs`' divisibility rule to JAX's; and the params
sharded by `shard_params` and all-gathered back, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from aule_tpu.models import llama as jllama
from aule_tpu.parallel import optimizer as jopt
from aule_tpu.parallel.mesh import make_mesh
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.parallel import optimizer as topt
from aule_tpu_torch.utils.testing import (assert_close, cap_cpu_threads,
                                          model_cases, run_world)
from aule_tpu_torch.utils.tree import tree_flatten

cap_cpu_threads()

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 (virtual) devices")

JCFG = jllama.LlamaConfig.tiny()
TCFG = tllama.LlamaConfig.tiny()
MESH = ((2, 2), ("data", "model"))
SGD_LR = 1e-2
ADAMW = dict(lr=1e-3, weight_decay=0.01)
LOSS_TOL = 1e-5
SGD_TOL = 1e-5
ZERO1_TOL = 2e-4   # JAX's own (tests/test_optimizer.py:90-92)
ADAMW_STEPS = 2
EXTRA = dict(lr=1e-3, weight_decay=0.01, clip_norm=0.5, micro_batches=2)


def _tokens(seed=0, batch=4, n=17):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (batch, n)).astype(np.int32)


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(JCFG, jax.random.key(1))


def _tparams(jp):
    return tllama.load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def world(jparams):
    """Every case in one world of 4 ranks: {name: rank 0's result}."""
    tp = _tparams(jparams)
    tok = torch.from_numpy(_tokens()).long()
    cases = {
        "sgd": dict(kind="sgd", kwargs=dict(lr=SGD_LR)),
        "zero1": dict(kind="zero1", steps=ADAMW_STEPS, kwargs=ADAMW),
        "extra": dict(kind="zero1", init=dict(master_weights=True),
                      kwargs=EXTRA),
        "roundtrip": dict(kind="roundtrip", model="llama"),
    }
    for c in cases.values():
        c.update(mesh=MESH, params=tp, cfg=TCFG, tokens=tok)
    return dict(zip(cases, run_world(model_cases, 4, list(cases.values()))[0]))


def _jmesh():
    return make_mesh(MESH[0], MESH[1], devices=jax.devices()[:4])


def _place(jp, mesh):
    return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                        jp, jllama.param_specs(JCFG),
                        is_leaf=lambda x: isinstance(x, P))


def _close_trees(got, want, tol, what):
    """Leaf by leaf (both trees in jax.tree.flatten's order) within `tol`."""
    for i, (a, b) in enumerate(zip(tree_flatten(got), tree_flatten(want))):
        if isinstance(b, torch.Tensor):
            b = b.detach()
        assert_close(a, np.asarray(b, np.float32), 0, tol, f"{what} leaf {i}")


def test_dp_tp_sgd_step(world, jparams):
    """llama.train_step(mesh=) on (data 2, model 2): JAX's jitted mesh step
    and the port's one-device step (loss 1e-5, params 1e-5)."""
    got = world["sgd"]
    tokens = _tokens()
    mesh = _jmesh()
    step = jax.jit(lambda p, t: jllama.train_step(p, t, JCFG, lr=SGD_LR,
                                                  mesh=mesh))
    jnew, jloss = step(_place(jparams, mesh), jnp.asarray(tokens))
    one, tloss = tllama.train_step(_tparams(jparams),
                                   torch.from_numpy(tokens).long(), TCFG,
                                   lr=SGD_LR)
    assert abs(got["losses"][0] - float(jloss)) < LOSS_TOL
    assert abs(got["losses"][0] - float(tloss)) < LOSS_TOL
    _close_trees(got["params"], jax.device_get(jnew), SGD_TOL, "vs JAX mesh")
    _close_trees(got["params"], one, SGD_TOL, "vs one device")


def test_zero1_matches_single_device(world, jparams):
    """Two ZeRO-1 steps == two one-device AdamW steps of the port and
    JAX's ZeRO-1 on the same mesh; the first moments cut over the data
    axis (blocks of half the rows) where JAX's are."""
    got = world["zero1"]
    tokens = _tokens()
    tp = _tparams(jparams)
    opt = topt.adamw_init(tp)
    step = topt.make_adamw_train_step(tllama, TCFG, **ADAMW)
    mesh = _jmesh()
    specs = jllama.param_specs(JCFG)
    mp = _place(jparams, mesh)
    mo = jopt.adamw_init(mp, specs, mesh)
    mstep = jopt.make_adamw_train_step(jllama, JCFG, mesh, **ADAMW)
    for i in range(ADAMW_STEPS):
        tp, opt, tloss = step(tp, opt, torch.from_numpy(tokens).long())
        mp, mo, mloss = mstep(mp, mo, jnp.asarray(tokens))
        for want in (tloss, mloss):
            assert abs(got["losses"][i] - float(want)) < LOSS_TOL
    _close_trees(got["params"], tp, ZERO1_TOL, "vs the port's one device")
    _close_trees(got["params"], jax.device_get(mp), ZERO1_TOL,
                 "vs JAX's ZeRO-1")
    _close_trees(got["mu"], opt.mu, ZERO1_TOL, "first moments")
    # the moments of the big leaves hold a data block: half the rows of
    # the rank's shard
    assert got["zero1_specs"]["embed"] == ("data", None)
    assert got["zero1_specs"]["layers"][0]["wq"] == ("data", "model")
    assert got["mu_shapes"][0] == (JCFG.vocab_size // 2, JCFG.dim)
    mu_specs = [tuple(s.spec) for s in jax.tree.leaves(jax.tree.map(
        lambda x: x.sharding, mo.mu))]
    ours = topt._spec_list(got["zero1_specs"], tp)
    assert [tuple(a for a in s if a is not None) for s in ours] == \
        [tuple(a for a in s if a is not None) for s in mu_specs]


def test_zero1_clip_master_micro(world, jparams):
    """ZeRO-1 with global-norm clipping (the norm over every rank's
    blocks), an f32 master copy in data blocks and 2 micro-batches ==
    the port's one-device step (loss 1e-5, params 2e-4)."""
    got = world["extra"]
    tp = _tparams(jparams)
    opt = topt.adamw_init(tp, master_weights=True)
    step = topt.make_adamw_train_step(tllama, TCFG, **EXTRA)
    tp, opt, loss = step(tp, opt, torch.from_numpy(_tokens()).long())
    assert abs(got["losses"][0] - float(loss)) < LOSS_TOL
    _close_trees(got["params"], tp, ZERO1_TOL, "clip/master/micro")


def test_zero1_specs_divisibility():
    """JAX's case (tests/test_optimizer.py:96-102) on a stand-in (data 4,
    model 2) mesh: the first unsharded dim the data ranks divide."""

    class Mesh42:
        mesh_dim_names = ("data", "model")
        shape = (4, 2)

    params = {"a": torch.zeros(8, 6), "b": torch.zeros(3, 5),
              "c": torch.zeros(6, 8)}
    specs = {"a": (None, "model"), "b": (), "c": ("model", None)}
    zs = topt.zero1_specs(specs, params, Mesh42())
    assert zs == {"a": ("data", "model"), "b": (None, None),
                  "c": ("model", "data")}
    jmesh = make_mesh((4, 2), ("data", "model"))
    jz = jopt.zero1_specs({"a": P(None, "model"), "b": P(),
                           "c": P("model", None)},
                          {k: jnp.zeros(tuple(v.shape))
                           for k, v in params.items()}, jmesh)
    assert {k: tuple(v) for k, v in jz.items()} == zs


def test_llama_shards_roundtrip(world, jparams):
    """JAX's params, sharded by the port's shard_params under
    param_specs on (data 2, model 2) and all-gathered back: bit for bit;
    the heads' columns and the head's vocabulary cut in two."""
    got = world["roundtrip"]
    for i, (a, b) in enumerate(zip(tree_flatten(got["params"]),
                                   jax.tree.leaves(jparams))):
        assert torch.equal(a, torch.from_numpy(np.array(b))), i
    # the leaves in order: embed, final_norm, the layers', lm_head
    assert got["shapes"][0] == (JCFG.vocab_size, JCFG.dim)
    assert got["shapes"][-1] == (JCFG.dim, JCFG.vocab_size // 2)
