"""AdamW of the PyTorch port against the JAX package's
(aule_tpu/parallel/optimizer.py, tests/test_optimizer.py's cases on one
device), at `LlamaConfig.tiny()` in f32.

  * The update alone: both packages' steps take the same numpy gradients
    (a stand-in model whose loss is sum(p * G), so its gradient is G) and
    agree on mu, nu, the master and the params within 1e-6 after three
    steps, with weight decay, with clip_norm, with a callable lr, and with
    master_weights over bf16 params.
  * End to end on the tiny Llama: the losses of 3 steps within 1e-5 of
    JAX's.  The params after such a step are not compared element by
    element: at step 1 AdamW's update is about lr * sign(g), so a gradient
    near 0 that rounds to the other sign in either package moves its
    element by 2 lr.
  * micro_batches=2 gives the full batch's step; master weights keep
    sub-ulp bf16 updates that bf16 params lose; mesh= raises.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.models import llama as jllama
from aule_tpu.parallel import optimizer as joptim
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.parallel import optimizer as toptim
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads
from aule_tpu_torch.utils.tree import tree_flatten

cap_cpu_threads()

JCFG = jllama.LlamaConfig.tiny()
TCFG = tllama.LlamaConfig.tiny()
TOL = 1e-6


def _tokens(batch=4, seq=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (batch, seq)).astype(np.int32)


def _jax_params(bf16=False):
    jp = jllama.init_params(JCFG, jax.random.key(0))
    if bf16:
        jp = jax.tree.map(
            lambda a: a.astype(jnp.bfloat16) if a.ndim == 2 else a, jp)
    return jp


def _port(jp):
    return tllama.load_jax_params(jax.tree.map(np.asarray, jp),
                                  device="cpu")


def _grads(jp, seed=1):
    """One numpy gradient per leaf, in jax.tree.leaves' order."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(np.shape(a)) * 0.05).astype(np.float32)
            for a in jax.tree.leaves(jp)]


def _linear_models(grads):
    """Stand-in model families whose loss is sum_leaf sum(p * G): the
    gradient of every step is G (rounded to the param's dtype)."""
    jg = [jnp.asarray(g) for g in grads]
    tg = [torch.from_numpy(g) for g in grads]

    def jloss(params, tokens, cfg, mesh=None):
        return sum(jnp.sum(p.astype(jnp.float32) * g)
                   for p, g in zip(jax.tree.leaves(params), jg))

    def tloss(params, tokens, cfg):
        return sum((p.float() * g).sum()
                   for p, g in zip(tree_flatten(params), tg))

    return (types.SimpleNamespace(loss_fn=jloss),
            types.SimpleNamespace(loss_fn=tloss))


def _jax_sched(t):
    return 1e-2 * jnp.minimum(1.0, t.astype(jnp.float32) / 4)


def _port_sched(t):  # the same f32 arithmetic on the host
    return float(np.float32(1e-2) * np.minimum(
        np.float32(1.0), np.float32(t) / np.float32(4)))


UPDATE_CASES = {
    "weight_decay": dict(kw=dict(lr=1e-3, weight_decay=0.01)),
    "clip_norm": dict(kw=dict(lr=1e-3, clip_norm=0.5)),
    "lr_schedule": dict(kw=dict(weight_decay=0.1), sched=True),
    "master_bf16": dict(kw=dict(lr=1e-3, weight_decay=0.01), bf16=True,
                        master=True),
}


def _leaves_close(t_tree, j_tree, what):
    tl, jl = tree_flatten(t_tree), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl), what
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert a.dtype == getattr(torch, str(b.dtype)), (what, i)
        assert_close(a.float(), np.asarray(b.astype(jnp.float32)), 0, TOL,
                     f"{what} leaf {i}")


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_matches_jax(case):
    spec = UPDATE_CASES[case]
    jp = _jax_params(spec.get("bf16", False))
    tp = _port(jp)
    jmodel, tmodel = _linear_models(_grads(jp))
    jkw, tkw = dict(spec["kw"]), dict(spec["kw"])
    if spec.get("sched"):
        jkw["lr"], tkw["lr"] = _jax_sched, _port_sched
    master = spec.get("master", False)
    jstep = joptim.make_adamw_train_step(jmodel, JCFG, **jkw)
    tstep = toptim.make_adamw_train_step(tmodel, TCFG, **tkw)
    jopt = joptim.adamw_init(jp, master_weights=master)
    topt = toptim.adamw_init(tp, master_weights=master)
    tokens = _tokens(2, 8)
    for _ in range(3):
        jp, jopt, jloss = jstep(jp, jopt, jnp.asarray(tokens))
        tp, topt, tloss = tstep(tp, topt, torch.from_numpy(tokens).long())
    assert int(topt.count) == int(jopt.count) == 3
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _leaves_close(topt.mu, jopt.mu, "mu")
    _leaves_close(topt.nu, jopt.nu, "nu")
    _leaves_close(tp, jp, "params")
    if master:
        _leaves_close(topt.master, jopt.master, "master")
    else:
        assert topt.master is None and jopt.master is None


def test_global_norm_matches_jax():
    jp = _jax_params()
    g = _grads(jp, seed=3)
    want = float(joptim.global_norm([jnp.asarray(a) for a in g]))
    got = float(toptim.global_norm([torch.from_numpy(a) for a in g]))
    assert abs(got - want) <= 1e-6 * want


@pytest.fixture(scope="module")
def jax_losses():
    """JAX's three AdamW steps on the tiny Llama (weight decay, clipping
    and a schedule), shared by the tests below."""
    jp = _jax_params()
    step = joptim.make_adamw_train_step(
        jllama, JCFG, lr=_jax_sched, weight_decay=0.01, clip_norm=1.0)
    opt = joptim.adamw_init(jp)
    losses = []
    for _ in range(3):
        jp, opt, loss = step(jp, opt, jnp.asarray(_tokens()))
        losses.append(float(loss))
    return losses


def test_end_to_end_losses_match_jax(jax_losses):
    tp = _port(_jax_params())
    step = toptim.make_adamw_train_step(
        tllama, TCFG, lr=_port_sched, weight_decay=0.01, clip_norm=1.0)
    opt = toptim.adamw_init(tp)
    tokens = torch.from_numpy(_tokens()).long()
    losses = []
    for _ in range(3):
        tp, opt, loss = step(tp, opt, tokens)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    for got, want in zip(losses, jax_losses):
        assert abs(got - want) <= 1e-5, (losses, jax_losses)
    for t in tree_flatten(tp):  # every .grad freed
        assert t.grad is None


def test_grad_accumulation_matches_full_batch():
    """micro_batches=2: the same update as the full-batch step (the loss
    is a mean, so the mean of the micro-batch gradients is the full
    batch's), as tests/test_optimizer.py:104 holds JAX's."""
    tokens = torch.from_numpy(_tokens(batch=4)).long()
    out = {}
    for mb in (1, 2):
        tp = _port(_jax_params())
        step = toptim.make_adamw_train_step(tllama, TCFG, lr=1e-3,
                                            micro_batches=mb)
        tp, opt, loss = step(tp, toptim.adamw_init(tp), tokens)
        out[mb] = (float(loss), tree_flatten(tp), tree_flatten(opt.mu))
    assert abs(out[1][0] - out[2][0]) <= 1e-6
    for a, b in zip(out[2][1], out[1][1]):
        assert_close(a, b, 0, 2e-5, "params")
    for a, b in zip(out[2][2], out[1][2]):
        assert_close(a, b, 0, 1e-6, "mu")
    with pytest.raises(ValueError):
        toptim.make_adamw_train_step(tllama, TCFG, micro_batches=3)(
            tp, toptim.adamw_init(tp), tokens)


def test_master_weights_beat_bf16_updates():
    """bf16 params with an f32 master: updates far below the bf16 ulp of
    the weights accumulate in the master (and move the params once they
    add up), while plain bf16 params keep (almost) none of them."""
    bcfg = dataclasses.replace(TCFG, dtype=torch.bfloat16)
    p0 = _port(_jax_params(bf16=True))
    tokens = torch.from_numpy(_tokens()).long()

    def run(master):
        p = _port(_jax_params(bf16=True))
        opt = toptim.adamw_init(p, master_weights=master)
        step = toptim.make_adamw_train_step(tllama, bcfg, lr=1e-6)
        for _ in range(8):
            p, opt, _ = step(p, opt, tokens)
        return p, opt

    def drift(a, b):
        return float(toptim.global_norm(
            [x.detach().float() - y.detach().float()
             for x, y in zip(tree_flatten(a), tree_flatten(b))]))

    p_plain, _ = run(False)
    _, o_master = run(True)
    moved = drift(o_master.master, p0)
    kept = drift(p_plain, p0)
    assert moved > 0.0
    assert moved > 2 * kept, (moved, kept)


def test_mesh_arguments_raise():
    """The ZeRO-1 layout takes a mesh and the param specs together (its
    steps: tests/test_torch_zero1.py)."""
    tp = _port(_jax_params())
    with pytest.raises(ValueError, match="both"):
        toptim.adamw_init(tp, mesh=object())
    with pytest.raises(ValueError, match="both"):
        toptim.adamw_init(tp, param_specs=tllama.param_specs(TCFG))
