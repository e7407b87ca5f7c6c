"""Meshes and shardings (counterpart of aule_tpu/parallel/mesh.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the process
group the caller initialised (`torch.distributed.init_process_group`, its
address, world size and rank given by the caller): every process is one
rank, every rank runs the same program, and a named mesh dim (`data`,
`model`, `ctx`) selects the process group of the ranks that differ only
along it.  The device type is "cuda" unless the caller asks for "cpu".

JAX shards global arrays by `PartitionSpec`; the port has no global array,
so a spec here is a tuple with one entry per dim: None (replicated), an
axis name, or a tuple of axis names (major to minor).  `shard` takes a
full tensor that every rank holds to the rank's block of it, and
`unshard` all-gathers the blocks back into the full tensor on every rank.
A spec tree (a family's `param_specs`) has the shape of its param tree
with a spec at each leaf; `map_specs` walks the two together.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

Spec = Tuple


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs torch.distributed: call init_process_group (its "
            "address, world size and rank) first")
    return dist.get_world_size()


def make_mesh(
    axis_sizes: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data", "model"),
    device_type: Optional[str] = None,
):
    """A mesh over every rank of the initialised process group; with no
    axis_sizes, everything on the first axis (JAX mesh.py:16-36)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _world_size()
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(
            f"axis sizes {axis_sizes} do not multiply to device count {n}")
    return init_device_mesh(device_type or "cuda", tuple(axis_sizes),
                            mesh_dim_names=tuple(axis_names))


def single_axis_mesh(name: str = "x", device_type: Optional[str] = None):
    """Every rank on one axis `name` (JAX mesh.py:39-41)."""
    return make_mesh((_world_size(),), (name,), device_type)


def axis_size(mesh, axis: Optional[str]) -> int:
    """Ranks along `axis` (1 for None)."""
    if axis is None:
        return 1
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r}")
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: Optional[str]) -> int:
    """This rank's coordinate along `axis` (0 for None)."""
    return 0 if axis is None else mesh.get_local_rank(axis)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block(mesh, entry) -> Tuple[int, int]:
    """(index, count) of this rank's block along a dim sharded over the
    axes of `entry`, the first axis major."""
    idx, count = 0, 1
    for a in _axes(entry):
        idx = idx * axis_size(mesh, a) + axis_index(mesh, a)
        count *= axis_size(mesh, a)
    return idx, count


def map_specs(fn: Callable, specs, params):
    """fn(spec, param) at every leaf of a param tree (dicts, lists and
    tuples) beside its spec tree, called in utils/tree.py's leaf order (a
    dict's keys sorted); the result has the params' shape."""
    if isinstance(params, dict):
        out = {k: map_specs(fn, specs[k], params[k]) for k in sorted(params)}
        return {k: out[k] for k in params}
    if isinstance(params, (list, tuple)):
        return type(params)(map_specs(fn, s, p)
                            for s, p in zip(specs, params))
    return fn(tuple(specs), params)


def renamed(spec: Spec, model_axis: Optional[str]) -> Spec:
    """`spec` with its `model` entries read as `model_axis`."""
    return tuple(model_axis if a == "model" else a for a in spec)


def shard(x: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """This rank's block of `x` (the full tensor, the same on every rank)
    under `spec`, as a contiguous tensor of its own.  A dim that its axes
    do not divide raises ValueError."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than x has dims "
                         f"({tuple(x.shape)})")
    for dim, entry in enumerate(spec):
        idx, count = _block(mesh, entry)
        if count == 1:
            continue
        if x.shape[dim] % count:
            raise ValueError(
                f"dim {dim} of {tuple(x.shape)} must divide the axis "
                f"{_axes(entry)} of {count} ranks")
        size = x.shape[dim] // count
        x = x.narrow(dim, idx * size, size)
    return x.contiguous()


def unshard(x: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """The full tensor from every rank's block under `spec` (all-gathers
    over each sharded dim's axes, minor axis first), on every rank."""
    from .collectives import all_gather

    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            x = all_gather(x, a, mesh, dim=dim)
    return x
