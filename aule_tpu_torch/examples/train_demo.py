"""Training walkthrough: a dp x tp mesh, ZeRO-1 AdamW, mixed precision, a
warm-up schedule, gradient accumulation and a checkpoint round trip
(counterpart of the JAX package's examples/train_demo.py).

    python -m aule_tpu_torch.examples.train_demo [--device cpu]

`main()` starts its own torch.distributed world, one process a rank, of
mesh_shape's size ((data 4, model 2): 8 ranks) and returns the losses.
The tiny Llama in bf16 with an f32 master: 6 steps of lr 3e-3 * min(1,
t / 3), weight decay 0.01, clip 1.0 and 2 micro-batches; then each rank
saves its shards and optimizer blocks with save_pytree to a directory of
its own, loads them back and takes one resumed step, which must equal a
seventh step of the state that never left memory.

On the card the backend is NCCL when the host has a card a rank, else
gloo with every rank on card 0 (the collectives staged through host
memory); the choice is printed.  The parent builds the kernels once and
the ranks load that library.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from ..config import resolve_device
from ..models import llama
from ..utils.tree import tree_flatten, tree_map

STEPS = 6
OPT = dict(weight_decay=0.01, clip_norm=1.0, micro_batches=2)


def lr_schedule(t: int) -> float:
    """3e-3 warmed up over the first 3 steps (t counts from 1)."""
    return 3e-3 * min(1.0, t / 3)


def demo_cfg():
    return llama.LlamaConfig.tiny(dtype=torch.bfloat16)


def demo_params():
    """The tiny bf16 Llama's weights from a CPU generator seeded 0: the
    same on every rank and in any process."""
    gen = torch.Generator()
    gen.manual_seed(0)
    return llama.init_params(demo_cfg(), gen, device="cpu")


def demo_tokens():
    """The batch: 8 sequences of 64 tokens (the JAX demo's draws)."""
    cfg = demo_cfg()
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 64)))


def train_rank(mesh_shape, device_type: str, backend: str, ckpt_dir: str):
    """One rank of the demo's world (run by utils/testing.run_world).
    Rank 0 returns {"losses", "resumed_loss", "seventh_loss",
    "resumed_equal", "lines"}, the other ranks None."""
    import torch.distributed as dist

    from ..entry import _rank_device
    from ..parallel.mesh import make_mesh, map_specs
    from ..parallel.optimizer import (adamw_init, make_adamw_train_step,
                                      zero1_specs)
    from ..utils.checkpoint import load_pytree, save_pytree

    dev = _rank_device(device_type, backend)
    rank = dist.get_rank()
    cfg = demo_cfg()
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), dev.type)
    specs = llama.param_specs(cfg)
    params = llama.shard_params(
        tree_map(lambda t: t.to(dev), demo_params()), cfg, mesh)
    opt = adamw_init(params, specs, mesh, master_weights=True)
    step = make_adamw_train_step(llama, cfg, mesh, lr=lr_schedule, **OPT)
    tokens = demo_tokens().to(dev)
    z = []
    map_specs(lambda spec, p: z.append(spec), zero1_specs(specs, params,
                                                          mesh), params)
    mu_spec = z[1]  # the JAX demo prints its second moment leaf's
    lines, losses = [], []
    for i in range(STEPS):
        params, opt, loss = step(params, opt, tokens)
        losses.append(float(loss))
        lines.append(f"step {i}: loss {losses[-1]:.4f}  (moment shard "
                     f"spec: {mu_spec})")
    path = os.path.join(ckpt_dir, f"rank{rank}")
    state = {"params": params, "opt": opt}
    save_pytree(path, state)
    restored = load_pytree(path, state)
    _, ropt, rloss = step(restored["params"], restored["opt"], tokens)
    _, opt, loss7 = step(params, opt, tokens)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_flatten({"params": restored["params"], "mu": ropt.mu,
                      "nu": ropt.nu, "master": ropt.master}),
        tree_flatten({"params": params, "mu": opt.mu, "nu": opt.nu,
                      "master": opt.master})))
    lines.append(f"resumed step: loss {float(rloss):.4f} (checkpoint round "
                 f"trip OK; the same step without it: {float(loss7):.4f}, "
                 f"every shard {'equal' if same else 'DIFFERENT'})")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    result = {"losses": losses, "resumed_loss": float(rloss),
              "seventh_loss": float(loss7), "resumed_equal": same,
              "lines": lines}
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, same)
    result["resumed_equal"] = all(flags)
    return result if rank == 0 else None


def main(mesh_shape=(4, 2), device=None, ckpt_dir=None) -> dict:
    """Run the demo in a world of prod(mesh_shape) ranks on `device` (the
    card unless "cpu"); the checkpoints go under `ckpt_dir` (a temporary
    directory, removed after, when None).  The backend is NCCL when the
    host has a card a rank, else gloo (said so in the output).  Returns
    rank 0's result (see train_rank)."""
    from ..entry import _card_backend
    from ..utils.testing import run_world

    dev = resolve_device(device or "cuda")
    world = int(np.prod(mesh_shape))
    backend = _card_backend(world, "nccl" if dev.type == "cuda" and
                            torch.cuda.device_count() >= world else "gloo",
                            dev)
    print(f"train_demo: mesh (data, model) = {tuple(mesh_shape)}, {world} "
        f"ranks over {backend} on {dev.type}")
    tmp = ckpt_dir is None
    ckpt_dir = tempfile.mkdtemp(prefix="train_demo_ckpt_") if tmp \
        else ckpt_dir
    try:
        out = run_world(train_rank, world, tuple(mesh_shape), dev.type,
                        backend, ckpt_dir, backend=backend)[0]
    finally:
        if tmp:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    for line in out["lines"]:
        print(line)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    main(device=ap.parse_args().device)
