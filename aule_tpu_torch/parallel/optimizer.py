"""AdamW on one device (counterpart of aule_tpu/parallel/optimizer.py:
31-189, without its ZeRO-1 sharding).

The update is the JAX package's, op for op and in its order (JAX
l.147-187), so the two agree to f32 rounding given the same gradients:

    mu <- b1 mu + (1 - b1) g            nu <- b2 nu + (1 - b2) g g
    c1 = 1 - b1^t, c2 = 1 - b2^t        (f32, t = the step count)
    u  = (mu / c1) / (sqrt(nu / c2) + eps)  [+ weight_decay * base]
    base <- base - lr_t * u

`base` is the f32 master copy when the state has one (the params are then
re-derived from it by one rounding to their dtype), else the params taken
to f32.  `torch.optim.AdamW` is not used: it decays before the moment
update, folds the bias correction into the step size (rounding
differently) and keeps no f32 master copy.

PyTorch's idiom departs from JAX's pure step in one way: the params, the
moments and the master are updated IN PLACE under torch.no_grad() (the
returned trees are the ones passed in), and every `.grad` is freed as soon
as it is summed or applied, so a step needs the weights, the optimizer
state and one set of gradients (with micro-batches, their f32 sums) and
nothing more.  The ZeRO-1 layout (`zero1_specs`, `mesh=`, `param_specs=`)
comes with the parallel-layer model slice and raises here.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Union

import numpy as np
import torch

from ..utils.tree import tree_flatten, tree_map

_PARALLEL = "the parallel-layer model slice"


@dataclasses.dataclass
class AdamWState:
    count: torch.Tensor  # 0-d int32 on the CPU: the schedule reads it there
    mu: Any              # f32 tree, params-shaped
    nu: Any              # f32 tree, params-shaped
    # mixed precision: f32 master copy of the params; None when the
    # params train in f32 directly
    master: Any = None


def _refuse_mesh(where: str, mesh, param_specs=None) -> None:
    if mesh is not None or param_specs is not None:
        raise NotImplementedError(
            f"{where}: mesh= / param_specs= (the ZeRO-1 layout) is not "
            f"ported yet; it comes with {_PARALLEL}")


def adamw_init(params, param_specs=None, mesh=None, data_axis: str = "data",
               master_weights: bool = False) -> AdamWState:
    """Zero f32 moments beside each parameter (on its device).
    master_weights=True keeps an f32 master copy of the params in the
    state: the update applies to it and the low-precision params are
    re-derived each step, so sub-ulp bf16 updates accumulate instead of
    vanishing."""
    del data_axis
    _refuse_mesh("adamw_init", mesh, param_specs)

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    master = (tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                       params) if master_weights else None)
    return AdamWState(count=torch.zeros((), dtype=torch.int32),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                      master=master)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    total = None
    for g in tree_flatten(tree):
        s = g.detach().to(torch.float32).square().sum()
        total = s if total is None else total + s
    return total.sqrt()


def _gradients(model, params, leaves, tokens, cfg, micro_batches: int):
    """(mean loss, the f32 gradient of each leaf), JAX l.125-148: a hook
    takes each leaf's .grad to f32 (or adds it to the leaf's f32 sum) and
    frees it as soon as backward has written it, so no more than one
    leaf's low-precision gradient lives beside the f32 sums."""
    if micro_batches > 1 and tokens.shape[0] % micro_batches:
        raise ValueError(f"batch {tokens.shape[0]} does not split into "
                         f"{micro_batches} micro-batches")
    sums = [None] * len(leaves)

    def take(j, t):
        g = t.grad.to(torch.float32)
        t.grad = None
        sums[j] = g if sums[j] is None else sums[j].add_(g)

    hooks = [t.register_post_accumulate_grad_hook(functools.partial(take, j))
             for j, t in enumerate(leaves)]
    loss_sum = None
    try:
        n = 1 if micro_batches <= 1 else tokens.shape[0] // micro_batches
        for i in range(max(1, micro_batches)):
            mb = tokens if micro_batches <= 1 else tokens[i * n:(i + 1) * n]
            loss = model.loss_fn(params, mb, cfg)
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            del loss
    finally:
        for h in hooks:
            h.remove()
    for j, t in enumerate(leaves):
        if sums[j] is None:  # no gradient reached it: zero, as in JAX
            sums[j] = torch.zeros(t.shape, dtype=torch.float32,
                                  device=t.device)
    if micro_batches > 1:
        for g in sums:
            g.div_(micro_batches)
        loss_sum = loss_sum / micro_batches
    return loss_sum, sums


def make_adamw_train_step(model, cfg, mesh=None, *,
                          lr: Union[float, Callable[[int], Any]] = 1e-4,
                          b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8, weight_decay: float = 0.0,
                          clip_norm: float = 0.0, micro_batches: int = 1,
                          data_axis: str = "data"):
    """step(params, opt_state, tokens) -> (params, opt_state, loss).

    `model` is a family module (models.llama, models.moe) exposing
    loss_fn(params, tokens, cfg).  lr: a float, or a callable of the step
    count (a Python int, 1 at the first step) returning the step's rate,
    e.g. lambda t: peak * min(1.0, t / warmup).  clip_norm > 0 clips the
    gradients to that global norm.  micro_batches=N sums the f32
    gradients of N sequential micro-batches (tokens' batch must divide
    into N) and applies one update with their mean, as the full batch
    would.  `loss` is the mean loss before the update (0-d f32).  The
    params, moments and master are updated in place (see the module
    docstring)."""
    del data_axis
    _refuse_mesh("make_adamw_train_step", mesh)

    def step(params, opt: AdamWState, tokens):
        leaves = tree_flatten(params)
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        loss, grads = _gradients(model, params, leaves, tokens, cfg,
                                 micro_batches)
        with torch.no_grad():
            if clip_norm > 0.0:
                scale = torch.clamp(
                    clip_norm / (global_norm(grads) + 1e-6), max=1.0)
                for g in grads:
                    g.mul_(scale)
            count = int(opt.count) + 1
            lr_t = float(lr(count)) if callable(lr) else lr
            # the bias corrections in f32, as JAX's
            # 1 - b1 ** count.astype(f32), as 0-d tensors on each leaf's
            # device: CUDA divides by a host scalar as a product with its
            # reciprocal, one rounding more than the true division of JAX
            # and of the CPU
            c = [np.float32(1.0) - np.float32(b) ** np.float32(count)
                 for b in (b1, b2)]
            corr = {}
            masters = (tree_flatten(opt.master) if opt.master is not None
                       else [None] * len(leaves))
            for i, (p, m, v, mp) in enumerate(zip(
                    leaves, tree_flatten(opt.mu), tree_flatten(opt.nu),
                    masters)):
                g, grads[i] = grads[i], None  # freed once applied
                m.mul_(b1).add_(g * (1 - b1))
                v.mul_(b2).add_(g * (1 - b2) * g)
                del g
                if m.device not in corr:
                    corr[m.device] = torch.tensor(
                        c, dtype=torch.float32, device=m.device)
                c1, c2 = corr[m.device]
                u = (m / c1).div_((v / c2).sqrt_().add_(eps))
                base = p.to(torch.float32) if mp is None else mp
                if weight_decay:
                    u.add_(base * weight_decay)
                u.mul_(lr_t)
                if mp is None:
                    p.copy_(base - u)
                else:
                    mp.sub_(u)
                    p.copy_(mp)
                del u, base
        opt = dataclasses.replace(
            opt, count=torch.tensor(count, dtype=torch.int32))
        return params, opt, loss

    return step
