"""Checkpoint / resume of tensor trees (counterpart of
aule_tpu/utils/checkpoint.py:35-83), in the JAX package's file format.

A tree (nested dicts, lists, tuples, dataclasses and `None`, with tensors
or arrays at the leaves) is saved as `<path>.npz`, one array `leaf_<i>`
per leaf, plus `<path>.tree.json` holding the leaves' dtype names.  The
leaves are numbered in `jax.tree.flatten`'s order: a dict's keys sorted, a
list's or tuple's items in order, a dataclass's fields in declaration
order, and `None` an empty subtree with no leaf.  So a file crosses between
the two packages bit for bit, and a template tree puts each leaf back in
its place.

npz cannot hold bfloat16 or float8 arrays (numpy would degrade them to
void "|V2" records), so those leaves are stored as same-width unsigned
integers and the sidecar keeps their dtype names ("bfloat16",
"float8_e4m3fn", ...); loading views them back with torch's `.view(dtype)`,
without `ml_dtypes`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from .tree import tree_flatten, tree_unflatten

# dtype name -> (torch dtype, the integer type its bits are stored as)
_VIEW_AS = {
    "bfloat16": (torch.bfloat16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8),
    "float8_e4m3fnuz": (torch.float8_e4m3fnuz, np.uint8),
    "float8_e5m2fnuz": (torch.float8_e5m2fnuz, np.uint8),
}
# an integer type of the same width that torch.from_numpy takes on every
# torch version (uint16 only on recent ones); .view() keeps the bits
_SAME_WIDTH = {np.dtype(np.uint16): np.int16, np.dtype(np.uint8): np.uint8}


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _tree_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".tree.json"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_numpy(x) -> Tuple[np.ndarray, str]:
    """A leaf as the array npz stores and its dtype name."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        name = _dtype_name(t.dtype)
        if name in _VIEW_AS:
            bits = np.dtype(_VIEW_AS[name][1])
            same = torch.int16 if bits.itemsize == 2 else torch.uint8
            return t.view(same).numpy().view(bits), name
        return t.numpy(), name
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name in _VIEW_AS:
        raise TypeError(f"save_pytree: a {a.dtype} numpy leaf; pass it as a "
                        f"torch tensor")
    return a, str(a.dtype)


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of tensors or arrays to `path` (.npz + .tree.json)."""
    leaves = tree_flatten(tree)
    arrays, dtypes = {}, []
    for i, x in enumerate(leaves):
        a, name = _to_numpy(x)
        arrays[f"leaf_{i}"] = a
        dtypes.append(name)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(_npz(path), **arrays)
    with open(_tree_path(path), "w") as f:
        json.dump({"treedef": f"{len(leaves)} leaves in jax.tree.flatten "
                              f"order", "num_leaves": len(leaves),
                   "dtypes": dtypes}, f)


def _to_tensor(a: np.ndarray, name) -> torch.Tensor:
    if name in _VIEW_AS:
        dtype, bits = _VIEW_AS[name]
        if a.dtype != np.dtype(bits):
            raise ValueError(f"a {name} leaf stored as {a.dtype}, not "
                             f"{np.dtype(bits)}")
        bits = a.view(_SAME_WIDTH[a.dtype])
        return torch.from_numpy(np.array(bits)).view(dtype)
    if name is not None and name != str(a.dtype):
        raise ValueError(f"a leaf of dtype {name} has no torch "
                         f"counterpart here (stored as {a.dtype})")
    return torch.from_numpy(np.array(a))  # a writable copy


def load_pytree(path: str, template: Any) -> Any:
    """Restore a tree saved by save_pytree (by either package) in the
    shape of `template`, whose leaf values are ignored except for their
    device: each leaf comes back as a torch tensor of the dtype on disk, on
    the template leaf's device when that is a tensor, else on the CPU."""
    with np.load(_npz(path)) as npz:
        arrays = [npz[f"leaf_{i}"] for i in range(len(npz.files))]
    try:
        with open(_tree_path(path)) as f:
            dtypes = json.load(f).get("dtypes")
    except FileNotFoundError:
        dtypes = None
    if dtypes is None and any(a.dtype.kind == "V" for a in arrays):
        raise ValueError(
            f"{path}: legacy checkpoint (no dtypes sidecar) contains "
            f"void-dtype leaves: it was written with bfloat16/float8 arrays "
            f"by a save_pytree that degraded them; the original dtype is "
            f"unrecoverable, re-save from the source arrays")
    t_leaves = tree_flatten(template)
    if len(t_leaves) != len(arrays):
        raise ValueError(f"checkpoint has {len(arrays)} leaves, template "
                         f"has {len(t_leaves)}")
    names = dtypes if dtypes is not None else [None] * len(arrays)
    out = []
    for a, name, t in zip(arrays, names, t_leaves):
        x = _to_tensor(a, name)
        out.append(x.to(t.device) if isinstance(t, torch.Tensor) else x)
    return tree_unflatten(template, out)
