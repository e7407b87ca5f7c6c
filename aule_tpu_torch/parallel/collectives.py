"""Cross-rank softmax combine and the differentiable collectives under it
(counterpart of aule_tpu/parallel/collectives.py).

Partial attention results (o_i, lse_i) over disjoint KV shards merge by
exp-weighted averaging, exchanging O(D + 1) values per query instead of
the KV shards: `softmax_combine_pair` for two partials on one rank (the
ring's hops), `softmax_combine_allreduce` across a mesh axis.

Every collective names a mesh axis (`axis_name`) and runs over that dim's
process group of `mesh`.  Gradient convention: the port reproduces
`jax.grad` of the GLOBAL function that a shard_map'd JAX function
computes.  A replicated value holds the same cotangent on every rank (its
loss is each rank's copy of one loss, not a sum over ranks), a sharded
value holds its own block's.  So the collectives come in conjugate pairs
at each replicated boundary, as in Megatron-LM:

  * `enter_region`: a replicated input entering a region where each rank
    computes a partial contribution; identity forward, all-reduce (sum)
    backward (each rank's partial gradient summed once);
  * `psum`: an all-reduced output; all-reduce forward, identity backward
    (the replicated cotangent is each partial's cotangent);
  * `pmax`: max over the axis, no gradient (the combine's shift, whose
    true derivative contribution is zero);
  * `ppermute`: point-to-point along (source, destination) pairs; the
    backward sends the cotangents along the reverse pairs;
  * `all_to_all` (JAX's tiled form): split one dim into the axis' ranks,
    concatenate what arrives along another; the backward is the reverse
    all-to-all;
  * `all_gather`: concatenate every rank's block along a dim into a
    replicated result; the backward keeps this rank's block of the
    cotangent;
  * `reduce_scatter` (no gradient): the sum over the axis of every rank's
    tensor, each rank keeping its block along a dim (ZeRO-1's gradient
    shards; `all_gather` rebuilds the updated parameters from the
    blocks).

Transport: NCCL where each rank has its own GPU; a gloo group moves host
tensors, so a CUDA tensor over a gloo group (several ranks sharing one
card) is staged through host memory for the collective alone: the
compute stays on the card and the result comes back to it.  A collective
that fails raises; nothing falls back to another path.

`STATS` counts the collectives since `reset_stats()`: calls, bytes sent
by this rank and host seconds (a staged transfer first waits for the
card's queued work, outside the count, so its seconds are the transfer's
own; an NCCL call's are its enqueue).
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import DEFAULT_MASK_VALUE
from .mesh import axis_size


STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0)


def _group(mesh, axis_name: str):
    return mesh.get_group(axis_name)


def _start(t: torch.Tensor, host: bool) -> float:
    if host:
        torch.cuda.current_stream(t.device).synchronize()
    return time.perf_counter()


def _done(t0: float, t: torch.Tensor) -> None:
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    STATS["seconds"] += time.perf_counter() - t0


def _staged(t: torch.Tensor, group) -> bool:
    """Whether `t` crosses `group` through host memory (CUDA over gloo)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _buffer(t: torch.Tensor, host: bool) -> torch.Tensor:
    """A contiguous copy of `t` to hand to a collective (on the host when
    staged)."""
    t = t.detach()
    if host:
        return t.to("cpu", copy=True).contiguous()
    return t.clone(memory_format=torch.contiguous_format)


def _back(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.to(like.device, non_blocking=False)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    host = _staged(t, group)
    t0 = _start(t, host)
    buf = _buffer(t, host)
    dist.all_reduce(buf, op=op, group=group)
    out = _back(buf, t)
    _done(t0, t)
    return out


def _all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    host = _staged(t, group)
    t0 = _start(t, host)
    buf = _buffer(t, host)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    out = _back(torch.cat(parts, dim=dim), t)
    _done(t0, t)
    return out


def _reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of every rank's `t`, of which this rank keeps
    block `rank` along `dim` (the dim must split into the group's ranks)."""
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not split into {n} ranks")
    host = _staged(t, group)
    t0 = _start(t, host)
    buf = _buffer(t.movedim(dim, 0), host)
    out = buf.new_empty((buf.shape[0] // n,) + tuple(buf.shape[1:]))
    # reduce_scatter_single: reduce_scatter_tensor's newer name
    rs = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
    rs(out, buf, group=group)
    out = _back(out, t).movedim(0, dim).contiguous()
    _done(t0, t)
    return out


def _all_to_all(t: torch.Tensor, split_dim: int, concat_dim: int,
                group) -> torch.Tensor:
    """JAX's tiled all_to_all: chunk j of `split_dim` goes to rank j; the
    chunks received from ranks 0..n-1 concatenate along `concat_dim`."""
    n = dist.get_world_size(group)
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} "
                         f"does not split into {n} ranks")
    host = _staged(t, group)
    t0 = _start(t, host)
    send = torch.stack(list(t.detach().chunk(n, dim=split_dim)))
    send = send.to("cpu") if host else send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    out = _back(torch.cat(list(recv.unbind(0)), dim=concat_dim), t)
    _done(t0, t)
    return out


def _ppermute(t: torch.Tensor, perm: Sequence[Tuple[int, int]],
              group) -> torch.Tensor:
    """Send `t` to the destination of this rank's (source, destination)
    pair and return what arrives from its source (zeros when none)."""
    me = dist.get_rank(group)
    host = _staged(t, group)
    t0 = _start(t, host)
    buf = _buffer(t, host)
    out = torch.zeros_like(buf)
    ops: List[dist.P2POp] = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(buf)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, buf,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    out = _back(out, t)
    _done(t0, t)
    return out


def _broadcast(t: torch.Tensor, group) -> torch.Tensor:
    host = _staged(t, group)
    t0 = _start(t, host)
    buf = _buffer(t, host)
    dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    out = _back(buf, t)
    _done(t0, t)
    return out


def broadcast(t: torch.Tensor, axis_name: str, mesh) -> torch.Tensor:
    """`t` of the axis' first rank, on every rank of the axis (no
    gradient); used to make ranks agree on host-visible decisions."""
    if axis_size(mesh, axis_name) == 1:
        return t
    return _broadcast(t, _group(mesh, axis_name))


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, dist.ReduceOp.SUM, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _ppermute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        back = [(dst, src) for src, dst in ctx.perm]
        return _ppermute(g, back, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, concat_dim, split_dim, ctx.group), None, None,
                None)


def psum(x: torch.Tensor, axis_name: str, mesh) -> torch.Tensor:
    """Sum over the axis (forward all-reduce, identity backward)."""
    if axis_size(mesh, axis_name) == 1:
        return x
    return _Psum.apply(x, _group(mesh, axis_name))


def enter_region(x: torch.Tensor, axis_name: str, mesh) -> torch.Tensor:
    """A replicated input entering per-rank partial work (identity
    forward, all-reduce backward)."""
    if axis_size(mesh, axis_name) == 1:
        return x
    return _EnterRegion.apply(x, _group(mesh, axis_name))


def pmax(x: torch.Tensor, axis_name: str, mesh) -> torch.Tensor:
    """Max over the axis, without gradient."""
    x = x.detach()
    if axis_size(mesh, axis_name) == 1:
        return x
    return _all_reduce(x, dist.ReduceOp.MAX, _group(mesh, axis_name))


def all_gather(x: torch.Tensor, axis_name: str, mesh, *,
               dim: int) -> torch.Tensor:
    """Every rank's block of the axis concatenated along `dim`, in axis
    order (backward: this rank's block of the cotangent)."""
    if axis_size(mesh, axis_name) == 1:
        return x
    return _AllGather.apply(x, dim, _group(mesh, axis_name))


def reduce_scatter(x: torch.Tensor, axis_name: str, mesh, *,
                   dim: int) -> torch.Tensor:
    """Sum over the axis, this rank keeping its block (axis order) along
    `dim`; no gradient."""
    x = x.detach()
    if axis_size(mesh, axis_name) == 1:
        return x
    return _reduce_scatter(x, dim, _group(mesh, axis_name))


def ppermute(x: torch.Tensor, axis_name: str, mesh,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """jax.lax.ppermute over the axis: (source, destination) pairs of axis
    indices (backward: the reverse pairs)."""
    if axis_size(mesh, axis_name) == 1:
        return x
    return _Ppermute.apply(x, tuple(perm), _group(mesh, axis_name))


def all_to_all(x: torch.Tensor, axis_name: str, mesh, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """jax.lax.all_to_all(..., tiled=True) over the axis (backward: the
    reverse all-to-all)."""
    if axis_size(mesh, axis_name) == 1:
        return x
    return _AllToAll.apply(x, split_axis, concat_axis,
                           _group(mesh, axis_name))


def softmax_combine_pair(o1, lse1, o2, lse2):
    """Merge two partial attention results over disjoint KV of the same
    queries (JAX collectives.py:20-40): o* [..., D], lse* [...].  The
    max-shift is detached (the combine is invariant to it, so its true
    derivative contribution is zero); both lse at the mask value give the
    mask value's LSE plus log 2, as JAX's."""
    lse_max = torch.maximum(lse1, lse2).detach()
    w1 = torch.exp(lse1 - lse_max)
    w2 = torch.exp(lse2 - lse_max)
    denom = w1 + w2
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / safe[..., None]
    lse = torch.where(denom > 0.0, lse_max + torch.log(safe),
                      torch.full_like(safe, DEFAULT_MASK_VALUE))
    return o, lse


def softmax_combine_allreduce(o_partial, lse_partial, axis_name: str, mesh):
    """Merge each rank's partial (o_i, lse_i) over `axis_name` (JAX
    collectives.py:43-56): a pmax of the detached lse, then ONE psum of
    [o_i w_i, w_i] (JAX's two psums, concatenated: the sums are
    elementwise, so the bits are the same).  A rank whose shard holds no
    key (lse at the mask value) weighs 0 unless every rank's does, and
    then the mask value is the LSE.  Returns the full (o, lse) on every
    rank."""
    lse_max = pmax(lse_partial, axis_name, mesh)
    w = torch.exp(lse_partial - lse_max)
    both = psum(torch.cat([o_partial * w[..., None], w[..., None]], dim=-1),
                axis_name, mesh)
    num, denom = both[..., :-1], both[..., -1]
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    o = num / safe[..., None]
    lse = torch.where(denom > 0.0, lse_max + torch.log(safe),
                      torch.full_like(safe, DEFAULT_MASK_VALUE))
    return o, lse

