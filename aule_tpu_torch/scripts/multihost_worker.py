"""Worker of the multi-host dry run (counterpart of the JAX package's
scripts/multihost_worker.py; entry.dryrun_multihost starts them).

    python -m aule_tpu_torch.scripts.multihost_worker <rank> <world> \
        <host:port> [--device cuda|cpu] [--backend nccl|gloo]

One process is one rank.  A "host" is a group of 2 consecutive ranks, so
a world of 2 x hosts, joined through serving.multihost.distributed_init at
the coordinator address (rank 0 serves the TCP store there).  The mesh is
(data = hosts, model = 2): the model axis stays inside a host and the data
axis crosses hosts, the layout the JAX worker prescribes (tensor-parallel
collectives must not cross hosts; data-parallel gradients tolerate the
latency).  Each rank takes one dp x tp SGD step of the JAX worker's tiny
Llama (4 / 2 heads, dim 128, hidden 256, 2 layers; weights from a CPU
generator seeded 0, the same on every rank) and prints a MULTIHOST-OK
line, which the parent looks for.

On the card NCCL puts rank r on card r; backend="gloo" puts every rank on
card 0 (ranks sharing a card, which NCCL refuses).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def run(rank: int, world: int, address: str, device: str = "cuda",
        backend=None) -> float:
    """Join the world, take the step, print MULTIHOST-OK; returns the
    loss."""
    import torch.distributed as dist

    from ..config import resolve_device
    from ..models import llama
    from ..parallel.mesh import make_mesh
    from ..serving.multihost import distributed_init
    from ..utils.tree import tree_map

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0 if backend == "gloo"
                              else rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    if world % 2:
        raise ValueError(f"a world of hosts of 2 ranks: {world} is odd")
    distributed_init(address, world, rank, device=dev.type, backend=backend)
    try:
        hosts = world // 2
        mesh = make_mesh((hosts, 2), ("data", "model"), dev.type)
        cfg = llama.LlamaConfig.tiny(n_heads=4, n_kv_heads=2, dim=128,
                                     hidden_dim=256, n_layers=2)
        gen = torch.Generator()
        gen.manual_seed(0)
        full = tree_map(lambda t: t.to(dev),
                        llama.init_params(cfg, gen, device="cpu"))
        params = llama.shard_params(full, cfg, mesh)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2 * hosts, 64))).to(dev)
        _, loss = llama.train_step(params, tokens, cfg, lr=1e-3, mesh=mesh)
        loss = float(loss)
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss}")
        print(f"MULTIHOST-OK process={rank}/{world} host={rank // 2} "
              f"dp{hosts}xtp2 {dist.get_backend()} {dev.type} "
              f"loss={loss:.4f}", flush=True)
        return loss
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("address", help="host:port of rank 0's TCP store")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
    run(args.rank, args.world, args.address, args.device, args.backend)


if __name__ == "__main__":
    main()
