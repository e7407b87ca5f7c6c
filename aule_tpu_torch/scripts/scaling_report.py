"""Serving scaling report: tokens/s at 1..N engine replicas (counterpart of
the JAX package's scripts/scaling_report.py).

    python -m aule_tpu_torch.scripts.scaling_report [--replicas 1 2 4]
        [--requests 8] [--new-tokens 32] [--layers 4] [--device cpu]
    python -m aule_tpu_torch.scripts.scaling_report --processes
        [--transport mp|tcp]

The in-process mode drives serving.multihost.EngineReplicaPool over a
fixed set of requests at each replica count: a 512-wide Llama (vocab 2048,
8 / 2 heads, hidden 1024, --layers layers; bf16 on the card, f32 on the
CPU), prompts of 8-63 tokens.  The process mode drives
MultiProcessServingPool (one spawned worker process a replica, over
multiprocessing queues or TCP) on the tiny Llama, after a direct
single-engine baseline.  The JAX script pins its process mode to CPU
workers; here the workers run on the card (they load the parent's kernel
library), and --device cpu gives the CPU-worker measurement.  On one card
the replicas time-share it, so the figure is the pool's and the
scheduler's, not a fleet's.  Every tok/s line on the card names the card
and its power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch

from ..config import resolve_device
from ..models import llama
from ..serving.engine import ServingEngine
from ..serving.multihost import EngineReplicaPool

POOL_KW = dict(max_batch=4, page_size=16, num_pages=512,
               max_pages_per_seq=16, max_seq_len=512)
PROCESS_KW = dict(max_batch=4, page_size=16, num_pages=256,
                  max_pages_per_seq=16, max_seq_len=512)


def card_note(dev) -> str:
    """", on <card name, power limit>" on the card (nvidia-smi's line),
    "" on the CPU."""
    if dev.type != "cuda":
        return ""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        line = torch.cuda.get_device_name(dev)
    return f", on {line}"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--processes", action="store_true",
                    help="process-per-replica pool")
    ap.add_argument("--transport", choices=["mp", "tcp"], default="mp")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap.parse_args(argv)


def report_cfg(layers: int, dev) -> llama.LlamaConfig:
    return llama.LlamaConfig(
        vocab_size=2048, dim=512, n_layers=layers, n_heads=8, n_kv_heads=2,
        hidden_dim=1024,
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)


def report_prompts(requests: int, vocab: int = 2048):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in rng.integers(8, 64, size=requests)]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_replicas(args, dev) -> dict:
    """The in-process mode: {replicas: {tokens, wall_s, tok_s, scaling,
    outputs}} (outputs by request, in submission order)."""
    cfg = report_cfg(args.layers, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, device=dev)
    prompts = report_prompts(args.requests, cfg.vocab_size)
    note = card_note(dev)
    # one request through a throwaway engine first, so that the first
    # replica count does not pay the process's first calls alone
    warm = ServingEngine(params, cfg, device=dev, **POOL_KW)
    warm.submit(prompts[0], max_new_tokens=args.new_tokens)
    warm.run()
    base, out = None, {}
    for n in args.replicas:
        pool = EngineReplicaPool([ServingEngine(params, cfg, device=dev,
                                                **POOL_KW)
                                  for _ in range(n)])
        for p in prompts:
            pool.submit(p, max_new_tokens=args.new_tokens)
        done = pool.run()
        _sync(dev)
        assert len(done) == len(prompts)
        tps = pool.stats.tokens_per_s
        base = base or tps
        out[n] = dict(tokens=pool.stats.tokens, wall_s=pool.stats.wall_s,
                      tok_s=tps, scaling=tps / base / n,
                      outputs=[list(r.output) for r in done])
        print(f"replicas={n}: {pool.stats.tokens} tokens in "
              f"{pool.stats.wall_s:.2f}s = {tps:,.0f} tok/s (scaling "
              f"{tps / base / n * 100:.0f}% of linear){note}", flush=True)
    return out


def run_processes(args, dev) -> dict:
    """The process mode: the direct engine's baseline, then {replicas:
    {tokens, wall_s, tok_s, scaling, workers, workers_used, outputs}}."""
    from ..serving.multihost import MultiProcessServingPool

    cfg = llama.LlamaConfig.tiny()
    rng = np.random.default_rng(0)
    # one prompt length: each worker's caches are warm before the timing;
    # tokens inside the tiny vocabulary (the JAX script draws them below
    # 2048, which its embedding gather clamps)
    prompts = [rng.integers(0, cfg.vocab_size, size=32).astype(np.int32)
               for _ in range(args.requests)]
    note = card_note(dev)
    if dev.type == "cuda":
        from ..ops import _build

        _build.library()  # once here; the workers load it
        worker_env = {"AULE_TPU_TORCH_NO_BUILD": "1"}
    else:
        cores = os.cpu_count() or 1
        if cores < max(args.replicas):
            print(f"NOTE: {cores} CPU core(s) < {max(args.replicas)} "
                  f"replicas: wall-clock scaling is core-bound here; the "
                  f"numbers that mean something are the pool's and the "
                  f"transport's overhead (procs=1 against direct) and mp "
                  f"against tcp", flush=True)
        # 2 intra-op threads a worker, so N CPU replicas on one machine run
        # side by side instead of fighting over every core
        worker_env = {"OMP_NUM_THREADS": "2", "OPENBLAS_NUM_THREADS": "2"}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    eng = ServingEngine(llama.init_params(cfg, gen, device=dev), cfg,
                        device=dev, **PROCESS_KW)
    eng.submit(np.zeros(32, np.int32), args.new_tokens)
    eng.run()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=args.new_tokens) for p in prompts]
    done = {r.req_id: list(r.output) for r in eng.run()}
    _sync(dev)
    ddt = time.perf_counter() - t0
    direct = [done[i] for i in ids]
    ntok = sum(map(len, direct))
    print(f"direct 1 engine: {ntok} tokens in {ddt:.2f}s = "
          f"{ntok / ddt:,.0f} tok/s{note}", flush=True)
    out = {"direct": dict(tokens=ntok, wall_s=ddt, tok_s=ntok / ddt,
                          outputs=direct)}
    base = None
    for n in args.replicas:
        pool = MultiProcessServingPool(
            n, dict(PROCESS_KW, device=dev.type), model_seed=0,
            transport=args.transport,
            warm={"lens": [32], "new_tokens": args.new_tokens},
            worker_env=worker_env)
        try:
            t0 = time.perf_counter()
            gids = [pool.submit(p, max_new_tokens=args.new_tokens)
                    for p in prompts]
            got = pool.collect(timeout_s=600)
            dt = time.perf_counter() - t0
        finally:
            pool.shutdown()
        toks = sum(len(v[1]) for v in got.values())
        tps = toks / dt
        base = base or tps
        out[n] = dict(tokens=toks, wall_s=dt, tok_s=tps,
                      scaling=tps / base / n, workers=sorted(pool.ready_s),
                      workers_used=sorted({got[g][0] for g in gids}),
                      outputs=[list(got[g][1]) for g in gids])
        print(f"procs={n} ({args.transport}): {toks} tokens in {dt:.2f}s = "
              f"{tps:,.0f} tok/s (scaling {tps / base / n * 100:.0f}% of "
              f"linear){note}", flush=True)
    return out


def main(argv=None) -> dict:
    """Run the report with command-line `argv`; returns its numbers."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.processes:
        return run_processes(args, dev)
    return run_replicas(args, dev)


if __name__ == "__main__":
    main()
