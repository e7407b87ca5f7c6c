"""Test helpers: tolerance comparison (counterpart of
aule_tpu/utils/testing.py::assert_close) for torch tensors and arrays, the
intra-op thread cap, and torch.distributed worlds on one host:
`run_world` runs a function in N rank processes (gloo on the CPU, or gloo
/ NCCL on the card) and `single_rank_world` makes this process a world of
one.  `sharded_cases`, `tp_cases` and `model_cases` are the rank side of
the parallel layer's checks (tests/test_torch_sharded.py,
test_torch_tp.py, and the model level's test_torch_zero1.py,
test_torch_pipeline.py, test_torch_moe_ep.py, test_torch_gpt2_tp.py): they
live here, so a rank imports neither JAX nor a test module.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .tree import tree_flatten, tree_map


def cap_cpu_threads() -> int:
    """Cap torch's intra-op threads at this process's share of the cores.

    Under pytest-xdist each of the `PYTEST_XDIST_WORKER_COUNT` workers
    would otherwise run torch with one thread per core, and the CPU
    models' many small ops spin those threads against each other's. A lone
    run (no xdist) keeps every core. Returns the cap."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    n = max(1, (os.cpu_count() or 1) // max(1, workers))
    torch.set_num_threads(n)
    return n


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def assert_close(actual, expected, rtol: float, atol: float, label: str = ""):
    """Raise AssertionError when |actual - expected| > atol + rtol*|expected|
    anywhere; accepts torch tensors and array-likes."""
    actual = _np64(actual)
    expected = _np64(expected)
    err = np.abs(actual - expected)
    tol = atol + rtol * np.abs(expected)
    bad = err > tol
    if bad.any():
        idx = np.unravel_index(np.argmax(err - tol), err.shape)
        raise AssertionError(
            f"{label}: {bad.sum()}/{bad.size} elements out of tolerance "
            f"(rtol={rtol}, atol={atol}); worst at {idx}: "
            f"actual={actual[idx]:.6g} expected={expected[idx]:.6g} "
            f"maxAbsDiff={err.max():.3e} meanAbsDiff={err.mean():.3e}"
        )


def _rank_main(rank: int, world_size: int, init_file: str, backend: str,
               threads: int, blob: bytes, queue, address=None) -> None:
    """One rank of `run_world`: join the process group (through
    serving.multihost.distributed_init when `address` is given), run the
    function, send back (rank, ok, pickled result or traceback)."""
    import pickle
    import traceback

    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    # one host: gloo's sockets on the loopback device
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        fn, args = pickle.loads(blob)
        if address is not None:
            from ..serving.multihost import distributed_init

            distributed_init(address, world_size, rank,
                             device="cpu" if backend == "gloo" else "cuda")
        else:
            dist.init_process_group(
                backend, store=dist.FileStore(init_file, world_size),
                rank=rank, world_size=world_size)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
        raise


WORLD_TIMEOUT = 600.0  # seconds a world may run before run_world stops it


def run_world(fn, world_size: int, *args, backend: str = "gloo",
              threads: int = 1, address=None) -> list:
    """Run `fn(*args)` in a world of `world_size` new processes (one rank
    each, the process group initialised through a FileStore in a
    temporary directory, so worlds started at once never share an address)
    and return each rank's result, rank 0 first.

    The ranks fork from a forkserver that has imported torch and this
    module once per calling process (a spawned rank would pay that
    import, seconds of CPU, itself); the server initialises no CUDA, so
    a rank may.

    `fn` is pickled by its import path: it lives in an importable module
    of the port, so a child imports neither JAX nor a test file.  Tensors
    cross by value.  Each rank runs `threads` intra-op threads (0: torch's
    default).  With `address` ("host:port") the ranks join through
    serving.multihost.distributed_init, rank 0 serving the TCP store
    there.  A rank that raises, or a world still running after
    WORLD_TIMEOUT seconds, stops every rank and raises RuntimeError with
    the rank's traceback."""
    import pickle
    import queue as queue_mod
    import tempfile
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])  # read at the server's start
    blob = pickle.dumps((fn, args))
    results: list = [None] * world_size
    with tempfile.TemporaryDirectory() as tmp:
        q = ctx.Queue()
        procs = [ctx.Process(
            target=_rank_main,
            args=(r, world_size, os.path.join(tmp, "store"), backend, threads,
                  blob, q, address), daemon=True) for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + WORLD_TIMEOUT
            for _ in range(world_size):
                left = deadline - time.monotonic()
                try:
                    rank, ok, payload = q.get(timeout=max(left, 0.1))
                except queue_mod.Empty:
                    raise RuntimeError(
                        f"world of {world_size} ranks still running after "
                        f"{WORLD_TIMEOUT} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                results[rank] = pickle.loads(payload)
            for p in procs:
                p.join(timeout=30)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
            q.close()
    return results


def sharded_cases(cases):
    """Rank side of the sharded-attention checks, run by `run_world` on
    CPU ranks.

    Each case is a dict: `make` (a `parallel.sharded` maker) with `kwargs`,
    `mesh` ((axis sizes, axis names)), `args` (full tensors, the same on
    every rank) with `in_specs`, `out_spec`, and `grads`.  Every rank
    shards the args, calls the strategy on its shards and all-gathers the
    output; with `grads` it back-propagates its share of the loss
    sum(out * arange(out.numel()) * 1e-3) (the JAX tests' loss: each rank
    weighs its own block of the global output) and all-gathers the
    gradients of the first three args; with `raises` it records the
    ValueError's message.  Rank 0 returns [{"out": ...,
    "grads": [...]}] per case (CPU tensors); the other ranks None."""
    import torch.distributed as dist

    from ..parallel import mesh as pmesh
    from ..parallel import sharded

    meshes = {}
    results = []
    for case in cases:
        key = tuple(map(tuple, case["mesh"]))
        if key not in meshes:
            meshes[key] = pmesh.make_mesh(*case["mesh"], "cpu")
        mesh = meshes[key]
        args = [pmesh.shard(a, mesh, spec)
                for a, spec in zip(case["args"], case["in_specs"])]
        fn = getattr(sharded, case["make"])(mesh, **case.get("kwargs", {}))
        if case.get("raises"):
            try:
                fn(*args)
            except ValueError as e:
                results.append({"error": str(e)})
                continue
            raise AssertionError(f"{case['make']} did not raise")
        if case.get("grads"):
            for a in args[:3]:
                a.requires_grad_(True)
        got = fn(*args)
        out = pmesh.unshard(got.detach(), mesh, case["out_spec"])
        res = {"out": out.cpu()}
        if case.get("grads"):
            w = (torch.arange(out.numel(), dtype=torch.float32)
                 .reshape(out.shape) * 1e-3)
            w = pmesh.shard(w, mesh, case["out_spec"])
            (got.float() * w).sum().backward()
            res["grads"] = [pmesh.unshard(a.grad, mesh, spec).cpu()
                            for a, spec in zip(args[:3], case["in_specs"])]
        results.append(res)
    return results if dist.get_rank() == 0 else None


def _shard_arg(a, mesh, spec):
    from ..parallel.mesh import shard

    if isinstance(a, (list, tuple)):
        return [shard(t, mesh, spec) for t in a]
    return shard(a, mesh, spec)


def _unshard_out(a, mesh, spec):
    from ..parallel.mesh import unshard

    if spec is None:
        return a
    if isinstance(a, (list, tuple)):
        return [unshard(t, mesh, spec) for t in a]
    return unshard(a, mesh, spec)


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return [_cpu(t) for t in x]
    return x


def _tp_grads(llama, params, case, mesh, model_axis):
    """The full gradients of a "grads" case, in the params' structure."""
    from ..parallel.mesh import map_specs, renamed, unshard

    for t in tree_flatten(params):
        t.requires_grad_(True)
    logits = llama.forward(params, case["tokens"], case["cfg"], mesh=mesh,
                           model_axis=model_axis)
    (logits * case["weights"]).sum().backward()
    return map_specs(lambda spec, t: unshard(
        t.grad, mesh, renamed(spec, model_axis)).cpu(),
        llama.param_specs(case["cfg"]), params)


def tp_cases(cases):
    """Rank side of the tensor-parallel Llama checks, run by `run_world` on
    CPU ranks.

    A case is a dict with `mesh` ((axis sizes, axis names)), the full
    `params` and `cfg`, and either
      * kind "step": `fn`, a `models.llama` step called on this rank's
        param shards (`shard_params`) with `args` (an arg given as
        {"shard": tensor or list, "spec": spec} goes in as this rank's
        shard) and `kwargs`; the outputs come back all-gathered by
        `out_specs` (None: as the rank has it, the full logits);
      * kind "engine": a `ServingEngine(mesh=...)` (its `kwargs`; a
        `draft` entry gives the draft's full params) serving `prompts`
        for `max_new` tokens each; its outputs and speculation counters;
      * kind "grads": the gradients of sum(forward(tokens) * weights)
        with respect to this rank's param shards, all-gathered by
        `param_specs` into the full params' structure.
    Rank 0 returns the list of results (CPU tensors); the others None."""
    import torch.distributed as dist

    from ..models import llama
    from ..parallel import mesh as pmesh
    from ..serving.engine import ServingEngine

    meshes = {}
    results = []
    for case in cases:
        key = tuple(map(tuple, case["mesh"]))
        if key not in meshes:
            meshes[key] = pmesh.make_mesh(*case["mesh"], "cpu")
        mesh = meshes[key]
        names = case["mesh"][1]
        kw = dict(case.get("kwargs", {}))
        if case["kind"] == "engine":
            draft = case.get("draft")
            if draft is not None:
                kw["draft_params"] = draft
            eng = ServingEngine(case["params"], case["cfg"], mesh=mesh,
                                model_axis=names[-1], device="cpu",
                                **kw)
            for p in case["prompts"]:
                eng.submit(p, max_new_tokens=case["max_new"])
            done = eng.run()
            st = eng.stats()
            results.append({"outputs": [r.output for r in done],
                            "spec": (st["spec_rounds"], st["spec_drafted"],
                                     st["spec_accepted"])})
            continue
        params = llama.shard_params(case["params"], case["cfg"], mesh,
                                    names[-1])
        if case["kind"] == "grads":
            results.append(_tp_grads(llama, params, case, mesh, names[-1]))
            continue
        args = [_shard_arg(a["shard"], mesh, a["spec"])
                if isinstance(a, dict) and "shard" in a else a
                for a in case["args"]]
        out = getattr(llama, case["fn"])(params, *args, mesh=mesh,
                                         model_axis=names[-1], **kw)
        out = out if isinstance(out, tuple) else (out,)
        results.append([_cpu(_unshard_out(o, mesh, spec))
                        for o, spec in zip(out, case["out_specs"])])
    return results if dist.get_rank() == 0 else None


def _tree_unshard(params, specs, mesh):
    """The full params from a rank's shards under a spec tree,
    all-gathered on every rank (CPU copies)."""
    from ..parallel.mesh import map_specs, unshard

    return map_specs(lambda spec, t: unshard(t.detach(), mesh, spec).cpu()
                     .clone(), specs, params)


def _model_case(case, mesh):
    """One case of `model_cases` on this rank."""
    from ..models import gpt2, llama, moe
    from ..parallel import optimizer, pipeline
    from ..serving.engine import ServingEngine

    kind, cfg = case["kind"], case["cfg"]
    kw = dict(case.get("kwargs", {}))
    # a copy: the steps update in place, and a replicated shard is the
    # full tensor itself, which the other cases share
    case = dict(case, params=tree_map(torch.clone, case["params"]))
    if kind in ("sgd", "zero1"):
        params = llama.shard_params(case["params"], cfg, mesh)
        specs = llama.param_specs(cfg)
        losses = []
        if kind == "sgd":
            for _ in range(case.get("steps", 1)):
                params, loss = llama.train_step(params, case["tokens"], cfg,
                                                mesh=mesh, **kw)
                losses.append(float(loss))
            return {"losses": losses,
                    "params": _tree_unshard(params, specs, mesh)}
        opt = optimizer.adamw_init(params, specs, mesh, **case.get(
            "init", {}))
        step = optimizer.make_adamw_train_step(llama, cfg, mesh, **kw)
        for _ in range(case.get("steps", 1)):
            params, opt, loss = step(params, opt, case["tokens"])
            losses.append(float(loss))
        z = optimizer.zero1_specs(specs, params, mesh)
        return {"losses": losses, "params": _tree_unshard(params, specs,
                                                          mesh),
                "mu": _tree_unshard(opt.mu, z, mesh),
                "mu_shapes": [tuple(t.shape) for t in tree_flatten(opt.mu)],
                "zero1_specs": z}
    if kind in ("pipeline_forward", "pipeline_step"):
        params = pipeline.shard_params(case["params"], mesh)
        specs = pipeline.pipeline_param_specs()
        if kind == "pipeline_forward":
            fwd = pipeline.make_pipeline_forward(mesh, cfg, **kw)
            with torch.no_grad():
                return {"logits": fwd(params, case["tokens"]).cpu()}
        step = pipeline.make_pipeline_train_step(mesh, cfg, **kw)
        params, loss = step(params, case["tokens"])
        return {"loss": float(loss),
                "params": _tree_unshard(params, specs, mesh)}
    if kind == "ep":
        params = moe.shard_params(case["params"], cfg, mesh,
                                  model_axis=None, expert_axis="expert")
        fn = moe.make_expert_parallel_forward(mesh, cfg, **kw)
        with torch.no_grad():
            return {"logits": fn(params, case["tokens"]).cpu()}
    if kind == "moe_forward":
        params = moe.shard_params(case["params"], cfg, mesh)
        with torch.no_grad():
            logits, aux = moe.forward(params, case["tokens"], cfg,
                                      mesh=mesh, return_aux=True)
        return {"logits": logits.cpu(), "aux": float(aux)}
    if kind == "gpt2_forward":
        params = gpt2.shard_params(case["params"], cfg, mesh)
        with torch.no_grad():
            return {"logits": gpt2.forward(params, case["tokens"], cfg,
                                           mesh=mesh).cpu()}
    if kind == "engine":
        fam = {"llama": llama, "gpt2": gpt2, "moe": moe}[case["model"]]
        eng = ServingEngine(case["params"], cfg, mesh=mesh, model=fam,
                            device="cpu", **kw)
        for p in case["prompts"]:
            eng.submit(p, max_new_tokens=case["max_new"])
        return {"outputs": [r.output for r in eng.run()]}
    assert kind == "roundtrip"
    skw = case.get("shard_kwargs", {})
    if case["model"] == "pipeline":
        specs = pipeline.pipeline_param_specs()
        shards = pipeline.shard_params(case["params"], mesh)
    else:
        fam = {"llama": llama, "gpt2": gpt2, "moe": moe}[case["model"]]
        specs = fam.param_specs(cfg, **skw) if fam is moe else \
            fam.param_specs(cfg)
        shards = fam.shard_params(case["params"], cfg, mesh, **skw)
    return {"params": _tree_unshard(shards, specs, mesh),
            "shapes": [tuple(t.shape) for t in tree_flatten(shards)]}


def model_cases(cases):
    """Rank side of the parallel layer's model-level checks
    (tests/test_torch_zero1.py, test_torch_pipeline.py,
    test_torch_moe_ep.py, test_torch_gpt2_tp.py), run by `run_world` on
    CPU ranks.  A case is a dict with `kind`, `mesh` ((axis sizes, axis
    names)), the full `params` (stacked for the pipeline), `cfg`, and:
      * "sgd": `tokens`, `steps`, `kwargs` of llama.train_step(mesh=);
      * "zero1": `tokens`, `steps`, `init` (adamw_init's master_weights)
        and `kwargs` of make_adamw_train_step(llama, cfg, mesh);
      * "pipeline_forward" / "pipeline_step": `tokens` and the makers'
        `kwargs` (microbatches, lr);
      * "ep": `tokens`, make_expert_parallel_forward's `kwargs`;
      * "moe_forward": `tokens`: moe.forward(mesh=, return_aux=True);
      * "gpt2_forward": `tokens`;
      * "engine": `model` ("llama", "gpt2" or "moe"), engine `kwargs`,
        `prompts`, `max_new`;
      * "roundtrip": `model` ("llama", "gpt2", "moe" or "pipeline":
        stacked params) and `shard_kwargs`: the family's shard_params,
        all-gathered back by its param_specs.
    Losses, logits, outputs and the params all-gathered into their full
    structure come back; rank 0 returns the list, the others None."""
    import torch.distributed as dist

    from ..parallel import mesh as pmesh

    meshes, results = {}, []
    for case in cases:
        key = tuple(map(tuple, case["mesh"]))
        if key not in meshes:
            meshes[key] = pmesh.make_mesh(*case["mesh"], "cpu")
        results.append(_model_case(case, meshes[key]))
    return results if dist.get_rank() == 0 else None


@contextlib.contextmanager
def single_rank_world():
    """This process as the only rank of a gloo world (a FileStore in a
    temporary directory) for the block's duration."""
    import tempfile

    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("this process is already a rank of a world")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()
