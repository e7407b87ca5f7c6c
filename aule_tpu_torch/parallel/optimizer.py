"""AdamW, and its ZeRO-1 layout over a mesh (counterpart of
aule_tpu/parallel/optimizer.py:31-189).

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

ZeRO-1 (`mesh=`, `param_specs=`; JAX l.42-58, 61-86, 93-189): the params
are this rank's tensor-parallel shards (`model.shard_params`), replicated
over `data_axis`; each f32 moment (and the master) holds only the data
rank's block of its param, cut on the first dim that no axis shards and
the data ranks divide (`zero1_specs`; a param with none keeps whole
moments).  A step's gradients are each rank's rows' share
(`loss_fn(mesh=, sum_data_grads=False)`); they reduce-scatter over the
data axis into the moments' blocks (an all-reduce where the moments are
whole), the update runs on the blocks, and the new param blocks
all-gather back into every data rank's shard.  GSPMD places the same two
collectives in JAX's step from the sharding constraints; here they are
stated.  The elementwise update is the same as on one device.

PyTorch's idiom departs from JAX's pure step in one way: the params, the
moments and the master are updated IN PLACE under torch.no_grad() (the
returned trees are the ones passed in), and every `.grad` is freed as soon
as it is summed or applied, so a step needs the weights, the optimizer
state and one set of gradients (with micro-batches, their f32 sums) and
nothing more.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Union

import numpy as np
import torch

from ..utils.tree import tree_flatten, tree_unflatten
from .collectives import all_gather, psum, reduce_scatter
from .mesh import axis_index, axis_size, map_specs


@dataclasses.dataclass
class AdamWState:
    count: torch.Tensor  # 0-d int32 on the CPU: the schedule reads it there
    mu: Any              # f32 tree, params-shaped (ZeRO-1: the blocks)
    nu: Any              # f32 tree, params-shaped (ZeRO-1: the blocks)
    # mixed precision: f32 master copy of the params (ZeRO-1: the blocks);
    # None when the params train in f32 directly
    master: Any = None


def _spec_list(specs, params) -> list:
    """The specs of a spec tree in tree_flatten(params)'s order."""
    out = []
    map_specs(lambda s, p: out.append(s), specs, params)
    return out


def _dp(mesh, data_axis: str) -> int:
    return (axis_size(mesh, data_axis)
            if data_axis in (mesh.mesh_dim_names or ()) else 1)


def zero1_specs(param_specs, params, mesh, data_axis: str = "data"):
    """The moments' specs (JAX l.42-58): each param's spec plus
    `data_axis` on its first dim that no axis shards and the data ranks
    divide (none qualifying: the moment stays as the param's spec).  A
    spec is a tuple with an entry per dim (parallel/mesh.py); `params`
    may be the full params or a rank's shards (the dims read are
    unsharded)."""
    dp = _dp(mesh, data_axis)

    def one(spec, p):
        parts = list(spec + (None,) * (p.dim() - len(spec)))
        if dp > 1:
            for i, d in enumerate(p.shape):
                if parts[i] is None and d % dp == 0:
                    parts[i] = data_axis
                    break
        return tuple(parts)

    return map_specs(one, param_specs, params)


def _data_dim(spec, data_axis):
    return spec.index(data_axis) if data_axis in spec else None


def _block(t: torch.Tensor, dim, mesh, data_axis) -> torch.Tensor:
    """The data rank's block of `t` along `dim` (all of it for None)."""
    if dim is None:
        return t
    n = t.shape[dim] // axis_size(mesh, data_axis)
    return t.narrow(dim, axis_index(mesh, data_axis) * n, n)


def adamw_init(params, param_specs=None, mesh=None, data_axis: str = "data",
               master_weights: bool = False) -> AdamWState:
    """Zero f32 moments beside each parameter (on its device).
    master_weights=True keeps an f32 master copy of the params in the
    state: the update applies to it and the low-precision params are
    re-derived each step, so sub-ulp bf16 updates accumulate instead of
    vanishing.  With `mesh` and `param_specs` (the params then being this
    rank's shards), the moments and the master hold the data rank's
    ZeRO-1 blocks from the start (`zero1_specs`)."""
    if (mesh is None) != (param_specs is None):
        raise ValueError("adamw_init: the ZeRO-1 layout takes both mesh= "
                         "and param_specs=")
    leaves = tree_flatten(params)
    dims = ([None] * len(leaves) if mesh is None else
            [_data_dim(s, data_axis) for s in _spec_list(
                zero1_specs(param_specs, params, mesh, data_axis), params)])

    def blocks(fn):
        return tree_unflatten(params, [
            fn(_block(p.detach(), d, mesh, data_axis))
            for p, d in zip(leaves, dims)])

    def zeros(b):
        return torch.zeros(b.shape, dtype=torch.float32, device=b.device)

    master = (blocks(lambda b: b.to(torch.float32, copy=True))
              if master_weights else None)
    return AdamWState(count=torch.zeros((), dtype=torch.int32),
                      mu=blocks(zeros), nu=blocks(zeros), master=master)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    total = None
    for g in tree_flatten(tree):
        s = g.detach().to(torch.float32).square().sum()
        total = s if total is None else total + s
    return total.sqrt()


def _gradients(model, params, leaves, tokens, cfg, micro_batches: int,
               loss_kw):
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
            loss = model.loss_fn(params, mb, cfg, **loss_kw)
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


def _zero1_norm(grads, specs, mesh) -> torch.Tensor:
    """The global norm of gradient blocks laid out by `specs` (ZeRO-1): a
    rank's sum of squares of each block, divided by the number of ranks
    that hold the same block (a power of two on meshes of powers of two,
    so exactly), summed over every axis of the mesh."""
    world = int(np.prod(mesh.shape))
    total = None
    for g, spec in zip(grads, specs):
        distinct = int(np.prod([axis_size(mesh, a) for a in spec
                                if a is not None]))
        s = g.square().sum() / (world // distinct)
        total = s if total is None else total + s
    for name in mesh.mesh_dim_names:
        total = psum(total, name, mesh)
    return total.sqrt()


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
    docstring).

    With `mesh`, the ZeRO-1 step over a (data, model) mesh: `params` are
    this rank's shards under `model.param_specs(cfg)` and `opt_state` is
    `adamw_init(params, model.param_specs(cfg), mesh)`'s; `tokens` is the
    full batch (each data rank computes its rows)."""
    def step(params, opt: AdamWState, tokens):
        leaves = tree_flatten(params)
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        loss_kw = ({} if mesh is None else
                   dict(mesh=mesh, data_axis=data_axis,
                        sum_data_grads=False))
        loss, grads = _gradients(model, params, leaves, tokens, cfg,
                                 micro_batches, loss_kw)
        with torch.no_grad():
            dims = [None] * len(leaves)
            if mesh is not None:
                z = _spec_list(zero1_specs(model.param_specs(cfg), params,
                                           mesh, data_axis), params)
                dims = [_data_dim(spec, data_axis) for spec in z]
                for i, d in enumerate(dims):
                    # the rank's rows' shares summed over the data ranks,
                    # into this rank's block (whole where no dim is cut)
                    grads[i] = (psum(grads[i], data_axis, mesh) if d is None
                                else reduce_scatter(grads[i], data_axis,
                                                    mesh, dim=d))
            if clip_norm > 0.0:
                norm = (global_norm(grads) if mesh is None
                        else _zero1_norm(grads, z, mesh))
                scale = torch.clamp(clip_norm / (norm + 1e-6), max=1.0)
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
            for i, (p, m, v, mp, d) in enumerate(zip(
                    leaves, tree_flatten(opt.mu), tree_flatten(opt.nu),
                    masters, dims)):
                g, grads[i] = grads[i], None  # freed once applied
                m.mul_(b1).add_(g * (1 - b1))
                v.mul_(b2).add_(g * (1 - b2) * g)
                del g
                if m.device not in corr:
                    corr[m.device] = torch.tensor(
                        c, dtype=torch.float32, device=m.device)
                c1, c2 = corr[m.device]
                u = (m / c1).div_((v / c2).sqrt_().add_(eps))
                base = (_block(p, d, mesh, data_axis).to(torch.float32)
                        if mp is None else mp)
                if weight_decay:
                    u.add_(base * weight_decay)
                u.mul_(lr_t)
                if mp is None:
                    new = base - u
                else:
                    mp.sub_(u)
                    new = mp
                if d is None:
                    p.copy_(new)
                else:  # every data rank's block back into the shard
                    p.copy_(all_gather(new.to(p.dtype), data_axis, mesh,
                                       dim=d))
                del u, base, new
        opt = dataclasses.replace(
            opt, count=torch.tensor(count, dtype=torch.int32))
        return params, opt, loss

    return step
