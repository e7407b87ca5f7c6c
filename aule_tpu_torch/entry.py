"""The port's driver entry points (counterpart of __graft_entry__.py).

    python -m aule_tpu_torch.entry [--device cpu]

runs `entry()`'s forward on the card (or on the CPU when asked), then
`dryrun_multichip(n)` over NCCL when the host has n > 1 cards.

  * `entry()`: (fn, (params, tokens)), the JAX entry's Llama-style
    causal-LM forward (vocab 2048, dim 512, 4 layers, 8 / 2 heads, hidden
    1024; bf16 on the card, f32 on the CPU) on tokens [2, 512].
  * `dryrun_multichip(n)`: every check of the JAX multi-chip dry run over
    `parallel/` in torch.distributed worlds: a dp x tp SGD step, a ZeRO-1
    AdamW step, ring and Ulysses attention and the sharded paged decode
    (split, and fused int8) against their oracles, then, as the JAX run
    takes sub-meshes of its devices, worlds of the sub-meshes' sizes: the
    pipeline step (n even), the MoE expert-parallel forward (4 ranks, n >=
    4) and tensor-parallel serving of Llama and GPT-2 (the model axis's
    ranks, when it is above 1).
  * `dryrun_multihost(p)`: p "hosts" of 2 worker processes each
    (scripts/multihost_worker.py) joined by serving.multihost.
    distributed_init into one world; a dp x tp step with `model` inside a
    host and `data` across hosts.

The worlds' backend is explicit.  NCCL (the default on the card) puts a
rank on each card and refuses to start with fewer cards than ranks;
backend="gloo" runs every rank on card 0, each collective's CUDA tensors
staged through host memory (parallel/collectives.py); device="cpu" runs
gloo on the CPU.  On the card the parent builds the kernels once and the
ranks load that library (AULE_TPU_TORCH_NO_BUILD), so no two ranks run
nvcc.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .config import resolve_device
from .models import llama
from .utils.tree import tree_flatten, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry(device=None):
    """(fn, (params, tokens)): the causal-LM forward of the JAX entry's
    Llama-style model, driven through the flash kernels on the card (their
    plain versions on CPU tensors).  Weights from a generator seeded 0 on
    the device; tokens [2, 512] from np.random.default_rng(0), as the JAX
    entry draws them."""
    dev = resolve_device(device or "cuda")
    cfg = llama.LlamaConfig(
        vocab_size=2048, dim=512, n_layers=4, n_heads=8, n_kv_heads=2,
        hidden_dim=1024,
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 512))).to(dev)

    def fn(params, tokens):
        with torch.no_grad():
            return llama.forward(params, tokens, cfg)

    fn.cfg = cfg
    return fn, (params, tokens)


# ---- the multi-chip dry run ------------------------------------------------

# the JAX dry run's checks, in the order it prints them
MULTICHIP_CHECKS = ("dp_tp", "zero1", "ring", "ulysses", "paged",
                    "fused_int8", "pipeline", "moe_ep", "tp_serving",
                    "gpt2_tp_serving")
RING_TOL = 2e-4    # ring, Ulysses and the split decode against the oracle
FUSED_TOL = 3e-2   # the fused int8 decode against the dequantized oracle


def _dryrun_cfg():
    return llama.LlamaConfig.tiny(n_heads=4, n_kv_heads=2, dim=128,
                                  hidden_dim=256, n_layers=2)


def _worlds(n: int) -> dict:
    """{world size: [checks]}: the whole mesh's checks in a world of n;
    each sub-mesh's (the JAX run's devices[:k]) in a world of k."""
    model_par = 2 if n % 2 == 0 else 1
    worlds = {n: ["dp_tp", "zero1", "ring", "ulysses", "paged",
                  "fused_int8"]}
    if n % 2 == 0:
        n_pipe = 2 if _dryrun_cfg().n_layers % 4 else min(4, n)
        worlds.setdefault(n_pipe, []).append("pipeline")
    if n >= 4:
        worlds.setdefault(4, []).append("moe_ep")
    if model_par > 1:
        worlds.setdefault(model_par, []).extend(["tp_serving",
                                                 "gpt2_tp_serving"])
    return worlds


def _rank_device(device_type: str, backend: str) -> torch.device:
    """A rank's device: its own card over NCCL, card 0 for every rank over
    gloo (the card's kernels built by the parent), or the CPU."""
    import torch.distributed as dist

    if device_type == "cpu":
        return torch.device("cpu")
    os.environ["AULE_TPU_TORCH_NO_BUILD"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    idx = dist.get_rank() % torch.cuda.device_count() \
        if backend == "nccl" else 0
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def _gen(seed: int, dev) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _dp_tp(ctx, res):
    """One dp x tp SGD step (JAX l.35-76): params tensor-parallel on
    `model`, the batch on `data`."""
    from .parallel.mesh import make_mesh

    n, dev, cfg = ctx["n"], ctx["dev"], ctx["cfg"]
    model_par = 2 if n % 2 == 0 else 1
    data_par = n // model_par
    mesh = make_mesh((data_par, model_par), ("data", "model"), dev.type)
    params = llama.shard_params(ctx["full"](), cfg, mesh)
    _, loss = llama.train_step(params, ctx["tokens"], cfg, lr=1e-3,
                               mesh=mesh)
    loss = float(loss)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    res["dp_tp"] = (loss, f"dp{data_par}xtp{model_par} train step "
                          f"loss={loss:.4f} OK")
    ctx["mesh"] = mesh


def _zero1(ctx, res):
    """One ZeRO-1 AdamW step (JAX l.78-93) from the same params: the f32
    moments cut over the data axis when it has more than one rank."""
    from .parallel.mesh import axis_size, map_specs
    from .parallel.optimizer import (adamw_init, make_adamw_train_step,
                                     zero1_specs)

    mesh, cfg = ctx["mesh"], ctx["cfg"]
    data_par = axis_size(mesh, "data")
    specs = llama.param_specs(cfg)
    params = llama.shard_params(ctx["full"](), cfg, mesh)
    opt = adamw_init(params, specs, mesh)
    step = make_adamw_train_step(llama, cfg, mesh, lr=1e-3)
    params, opt, loss = step(params, opt, ctx["tokens"])
    loss = float(loss)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    if data_par > 1:
        z = []
        map_specs(lambda spec, p: z.append(spec),
                  zero1_specs(specs, params, mesh), params)
        assert any("data" in str(spec) for spec in z), \
            "moments not sharded"
        assert any(m.numel() < p.numel() for m, p in zip(
            tree_flatten(opt.mu), tree_flatten(params))), \
            "no moment is cut over the data axis"
    res["zero1"] = (loss, f"ZeRO-1 AdamW step (dp{data_par}) "
                          f"loss={loss:.4f} OK")


def _seq_sharded(ctx, res, make, heads, what, key, rng):
    """Ring or Ulysses attention over a ctx mesh of every rank, its
    all-gathered output against the f64 NumPy oracle (JAX l.95-140)."""
    from .ops.reference import attention_reference_numpy
    from .parallel.mesh import shard, unshard

    n, dev = ctx["n"], ctx["dev"]
    seq = 64 * n
    qkv = [rng.standard_normal((1, heads, seq, 64)).astype(np.float32)
           for _ in range(3)]
    spec = (None, None, "ctx", None)
    fn = make(ctx["ctx_mesh"], causal=True)
    with torch.no_grad():
        out = fn(*[shard(torch.from_numpy(x).to(dev), ctx["ctx_mesh"], spec)
                   for x in qkv])
        out = unshard(out, ctx["ctx_mesh"], spec).cpu().numpy()
    err = float(np.abs(out - attention_reference_numpy(
        *qkv, causal=True)).max())
    assert err < RING_TOL, f"{what} off oracle by {err}"
    res[key] = (err, f"{what} err={err:.1e} OK")


def _union_pages(pool_np, n_ctx):
    """Each ctx shard's local page 1, joined along the keys: block-table
    entries are shard-local, so the cross-shard combine must equal plain
    attention over the union of those pages."""
    per = pool_np.shape[1] // n_ctx
    return np.concatenate([pool_np[:, s * per + 1] for s in range(n_ctx)],
                          axis=1)


def _paged_oracle(q, kpage, vpage, batch):
    from .ops.reference import attention_reference_numpy

    return attention_reference_numpy(
        q[:, :, None, :], np.broadcast_to(kpage[None], (batch,) + kpage.shape),
        np.broadcast_to(vpage[None], (batch,) + vpage.shape))[:, :, 0]


def _paged(ctx, res, rng):
    """The sharded paged decode over split pools, heads on `model` and
    pages on `ctx` (JAX l.142-181), and over fused int8 pools, batch on
    `data` and pages on `ctx` (l.183-217), against the union-of-pages
    oracle."""
    from .ops.paged_fused import to_fused_layout
    from .ops.quant import quantize_kv
    from .parallel.mesh import make_mesh, shard, unshard
    from .parallel.sharded import (make_sharded_paged_attention,
                                   make_sharded_paged_attention_fused)

    n, dev = ctx["n"], ctx["dev"]
    model_par = 2 if n % 2 == 0 else 1
    n_ctx = n // model_par
    hkv, page, d = 2, 16, 64
    pool = 8 * n_ctx
    kp = rng.standard_normal((hkv, pool, page, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, pool, page, d)).astype(np.float32)

    def tables(batch):
        bt = np.zeros((batch, n_ctx, 4), np.int32)
        bt[:, :, 0] = 1
        return (torch.from_numpy(bt).to(dev),
                torch.full((batch, n_ctx), page, dtype=torch.int32,
                           device=dev))

    def t(x):
        return torch.from_numpy(x).to(dev)

    mesh = make_mesh((model_par, n_ctx), ("model", "ctx"), dev.type)
    qd = rng.standard_normal((2, 4, d)).astype(np.float32)
    bt, lens = tables(2)
    fn = make_sharded_paged_attention(mesh, data_axis=None,
                                      model_axis="model", ctx_axis="ctx")
    with torch.no_grad():
        od = fn(shard(t(qd), mesh, (None, "model", None)),
                shard(t(kp), mesh, ("model", "ctx", None, None)),
                shard(t(vp), mesh, ("model", "ctx", None, None)),
                shard(bt, mesh, (None, "ctx", None)),
                shard(lens, mesh, (None, "ctx")))
        od = unshard(od, mesh, (None, "model", None)).cpu().numpy()
    err = float(np.abs(od - _paged_oracle(qd, _union_pages(kp, n_ctx),
                                          _union_pages(vp, n_ctx), 2)).max())
    assert err < RING_TOL, f"sharded paged decode off oracle by {err}"
    res["paged"] = (err, f"sharded paged decode (tp{model_par}xcp{n_ctx}) "
                         f"err={err:.1e} OK")

    fmesh = make_mesh((model_par, n_ctx), ("data", "ctx"), dev.type)
    kq, ks = quantize_kv(t(kp), torch.int8)
    vq, vs = quantize_kv(t(vp), torch.int8)
    kvq, scq = to_fused_layout(kq, vq, ks, vs)
    qf = rng.standard_normal((model_par, 4, d)).astype(np.float32)
    btf, lensf = tables(model_par)
    fn = make_sharded_paged_attention_fused(
        fmesh, data_axis="data", ctx_axis="ctx", quantized=True)
    with torch.no_grad():
        of = fn(shard(t(qf), fmesh, ("data", None, None)),
                shard(kvq, fmesh, ("ctx", None, None, None, None)),
                shard(btf, fmesh, ("data", "ctx", None)),
                shard(lensf, fmesh, ("data", "ctx")),
                shard(scq, fmesh, ("ctx", None, None)))
        of = unshard(of, fmesh, ("data", None, None)).cpu().numpy()
    kdq = (kq.float() * ks[..., None]).cpu().numpy()
    vdq = (vq.float() * vs[..., None]).cpu().numpy()
    err = float(np.abs(of - _paged_oracle(
        qf, _union_pages(kdq, n_ctx), _union_pages(vdq, n_ctx),
        model_par)).max())
    assert err < FUSED_TOL, f"fused quantized decode off oracle by {err}"
    res["fused_int8"] = (err, f"fused quantized sharded decode "
                              f"(dp{model_par}xcp{n_ctx}) err={err:.1e} OK")


def _pipeline(ctx, res):
    """The pipeline-parallel train step, layers over `pipe`, 2
    micro-batches (JAX l.219-246)."""
    from .parallel import pipeline
    from .parallel.mesh import make_mesh

    world, dev, cfg = ctx["world"], ctx["dev"], ctx["cfg"]
    mesh = make_mesh((world,), ("pipe",), dev.type)
    stacked = pipeline.shard_params(
        pipeline.stack_layer_params(ctx["full"]()), mesh)
    step = pipeline.make_pipeline_train_step(mesh, cfg, microbatches=2,
                                             lr=1e-3)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 32))).to(dev)
    _, loss = step(stacked, tokens)
    loss = float(loss)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    res["pipeline"] = (loss, f"pipeline-parallel train step (pp{world}, 2 "
                             f"microbatches) loss={loss:.4f} OK")


def _moe_ep(ctx, res):
    """The MoE forward with experts sharded over `expert` (JAX
    l.248-271)."""
    from .models import moe
    from .parallel.mesh import make_mesh

    dev = ctx["dev"]
    mesh = make_mesh((4,), ("expert",), dev.type)
    mcfg = moe.MoEConfig.tiny()
    params = moe.shard_params(moe.init_params(mcfg, _gen(3, dev), device=dev),
                              mcfg, mesh, model_axis=None,
                              expert_axis="expert")
    fn = moe.make_expert_parallel_forward(mesh, mcfg)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, mcfg.vocab_size, (2, 32))).to(dev)
    with torch.no_grad():
        logits = fn(params, tokens)
    assert bool(torch.isfinite(logits).all()), "non-finite MoE logits"
    res["moe_ep"] = (float(logits.float().abs().max()),
                     f"MoE expert-parallel forward (ep4, top-{mcfg.top_k} "
                     f"of {mcfg.n_experts}) OK")


def _tp_serving(ctx, res, key):
    """Tensor-parallel serving on the fused pools over a (1, model) mesh:
    Llama (JAX l.273-291) or GPT-2 (l.293-311) generates 3 tokens."""
    from .models import gpt2
    from .parallel.mesh import make_mesh
    from .serving.engine import ServingEngine

    world, dev = ctx["world"], ctx["dev"]
    if key == "tp_serving":
        fam, cfg, seed, what = llama, ctx["cfg"], 1, \
            f"fused TP serving (tp{world})"
    else:
        fam, cfg, seed, what = gpt2, gpt2.GPT2Config.tiny(), 2, \
            "GPT-2 fused TP serving"
    mesh = make_mesh((1, world), ("data", "model"), dev.type)
    eng = ServingEngine(
        fam.init_params(cfg, _gen(seed, dev), device=dev), cfg, model=fam,
        mesh=mesh, max_batch=2, page_size=16, num_pages=64,
        max_pages_per_seq=8, max_seq_len=256, layout="fused", device=dev)
    eng.submit(np.arange(7, dtype=np.int32) % cfg.vocab_size,
               max_new_tokens=3)
    done = eng.run()
    assert len(done) == 1 and len(done[0].output) == 3, done
    res[key] = (list(done[0].output), f"{what} OK")


def multichip_rank(n, checks, device_type, backend, params=None):
    """One rank of a dry-run world (run by utils/testing.run_world): the
    `checks` that belong to this world's size.  Rank 0 returns {check:
    (value, line)}, the other ranks None."""
    import torch.distributed as dist

    dev = _rank_device(device_type, backend)
    cfg = _dryrun_cfg()
    if params is None:
        params = llama.init_params(cfg, _gen(0, dev), device=dev)
    params = tree_map(lambda x: x.to(dev), params)
    model_par = 2 if n % 2 == 0 else 1
    ctx = dict(n=n, world=dist.get_world_size(), dev=dev, cfg=cfg,
               # a copy for each step: the steps update in place, and a
               # replicated shard is the full tensor itself
               full=lambda: tree_map(torch.clone, params),
               tokens=torch.from_numpy(np.random.default_rng(0).integers(
                   0, cfg.vocab_size, (2 * (n // model_par), 64))).to(dev))
    res = {}
    rng = np.random.default_rng(1)
    for check in checks:
        if check == "dp_tp":
            _dp_tp(ctx, res)
        elif check == "zero1":
            _zero1(ctx, res)
        elif check in ("ring", "ulysses"):
            from .parallel.mesh import make_mesh
            from .parallel.sharded import (make_ring_attention,
                                           make_ulysses_attention)

            if "ctx_mesh" not in ctx:
                ctx["ctx_mesh"] = make_mesh((n,), ("ctx",), dev.type)
            if check == "ring":
                _seq_sharded(ctx, res, make_ring_attention, 2,
                             "ring attention (sp)", "ring", rng)
            else:
                _seq_sharded(ctx, res, make_ulysses_attention, n,
                             "ulysses attention (a2a sp)", "ulysses", rng)
        elif check == "paged":
            _paged(ctx, res, rng)
        elif check == "pipeline":
            _pipeline(ctx, res)
        elif check == "moe_ep":
            _moe_ep(ctx, res)
        elif check in ("tp_serving", "gpt2_tp_serving"):
            _tp_serving(ctx, res, check)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return res if dist.get_rank() == 0 else None


def _card_backend(n: int, backend: str, dev: torch.device) -> str:
    """The worlds' backend: gloo on the CPU; on the card NCCL (one rank a
    card: refused with fewer cards than ranks) or gloo (every rank on card
    0), after the kernels are built once here."""
    if dev.type == "cpu":
        return "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    cards = torch.cuda.device_count()
    if backend == "nccl" and cards < n:
        raise RuntimeError(
            f"{n} ranks over NCCL need {n} cards, one a rank; this host has "
            f"{cards} ({n - cards} short): pass backend='gloo' to run the "
            f"ranks on one card, or device='cpu'")
    from .ops import _build

    _build.library()
    return backend


def dryrun_multichip(n_devices: int, backend: str = "nccl", device=None,
                     params=None) -> dict:
    """Every check of the JAX multi-chip dry run (__graft_entry__.py:35-294)
    in worlds of torch.distributed ranks (see the module docstring): the
    dp x tp SGD step, the ZeRO-1 AdamW step, ring and Ulysses attention
    (< 2e-4 of the f64 oracle), the sharded paged decode over split pools
    (< 2e-4) and fused int8 pools (< 3e-2) against the union-of-pages
    oracle, the pipeline step (n even), the MoE expert-parallel forward (n
    >= 4) and fused tensor-parallel serving of Llama and GPT-2 (model axis
    > 1).  Prints the JAX run's lines and returns {check: its loss, error
    or tokens}.  `params`: the tiny Llama's full params (on the CPU) in
    place of the seeded ones, for a comparison with another package."""
    from .utils.testing import run_world

    dev = resolve_device(device or "cuda")
    backend = _card_backend(n_devices, backend, dev)
    if params is not None:
        params = tree_map(lambda x: x.detach().cpu(), params)
    lines, out = {}, {}
    for world, checks in _worlds(n_devices).items():
        got = run_world(multichip_rank, world, n_devices, checks, dev.type,
                        backend, params, backend=backend)[0]
        for check, (value, line) in got.items():
            out[check], lines[check] = value, line
    for check in MULTICHIP_CHECKS:
        if check in lines:
            print(f"dryrun_multichip({n_devices}): {lines[check]}",
                  flush=True)
    return out


# ---- the multi-host dry run ------------------------------------------------

def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, n: int = 2000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def dryrun_multihost(num_processes: int = 2, timeout_s: int = 600,
                     backend: str = "nccl", device=None) -> list:
    """The multi-host dry run (__graft_entry__.py:297-332): `num_processes`
    hosts of 2 worker processes each (one rank a process: the JAX worker's
    process holds a host's devices, here a host is a group of 2 ranks), so
    a world of 2 x num_processes, joined through
    serving.multihost.distributed_init at a free localhost port.  Every
    worker (scripts/multihost_worker.py) takes one dp x tp SGD step of the
    tiny Llama on a (data num_processes, model 2) mesh, `model` inside a
    host and `data` across hosts, and prints MULTIHOST-OK.  A worker that
    exits with an error stops the others and raises at once; the run
    raises TimeoutError after `timeout_s`.  Returns each worker's loss,
    rank 0 first."""
    dev = resolve_device(device or "cuda")
    world = 2 * num_processes
    backend = _card_backend(world, backend, dev)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    if dev.type == "cuda":
        env["AULE_TPU_TORCH_NO_BUILD"] = "1"  # the library built above
    else:
        env["OMP_NUM_THREADS"] = "1"
    address = f"127.0.0.1:{_free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        logs = [os.path.join(tmp, f"worker{r}.log") for r in range(world)]
        procs = []
        for r in range(world):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "aule_tpu_torch.scripts.multihost_worker", str(r),
                     str(world), address, "--device", dev.type,
                     "--backend", backend],
                    stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT))
        try:
            deadline = time.monotonic() + timeout_s
            while True:
                codes = [p.poll() for p in procs]  # every one, each time
                if None not in codes:
                    break
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    r = bad[0]
                    raise RuntimeError(
                        f"multihost worker {r} failed (rc="
                        f"{procs[r].returncode}):\n" + _tail(logs[r]))
                if time.monotonic() > deadline:
                    raise TimeoutError(f"multihost workers still running "
                                       f"after {timeout_s} s")
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = [_tail(path, 10 ** 6) for path in logs]
    oks = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        found = [line for line in out.splitlines()
                 if line.startswith("MULTIHOST-OK")]
        if p.returncode != 0 or not found:
            raise RuntimeError(f"multihost worker {r} failed (rc="
                               f"{p.returncode}):\n" + out[-2000:])
        oks.append(found[0])
    print(f"dryrun_multihost({num_processes}): " + "; ".join(oks),
          flush=True)
    return [float(line.rsplit("loss=", 1)[1].split()[0]) for line in oks]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    if out.is_cuda:
        torch.cuda.synchronize()
    print("entry OK:", tuple(out.shape), flush=True)
    n = torch.cuda.device_count() if out.is_cuda else 0
    if n > 1:
        dryrun_multichip(n)


if __name__ == "__main__":
    main()
