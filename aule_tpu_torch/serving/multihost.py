"""Multi-process serving: engine-replica data parallelism and the
process-group set-up (counterpart of aule_tpu/serving/multihost.py).

Decode is embarrassingly parallel across sequences, so replicas own
disjoint KV pools and page allocators and nothing but request and
response tuples crosses between them.  A shared queue provides admission:
any replica with a free slot and enough free pages takes the next
request, so batching continues across the fleet.

  * `EngineReplicaPool`: N in-process replicas (each may hold a tensor-
    parallel mesh of its own) behind one queue.
  * `MultiProcessServingPool`: one process per replica
    (serving/worker.py), over multiprocessing queues or over TCP
    (serving/transport.py); workers start with the `spawn` context, never
    `fork`, since the parent may hold an initialised CUDA context.
  * `distributed_init`: one torch.distributed process group across
    processes or hosts, for the parallel layer's jointly run steps
    (parallel/mesh.py): NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from .engine import Request, ServingEngine


def distributed_init(coordinator_address: str, num_processes: int,
                     process_id: int, device="cuda",
                     backend: Optional[str] = None) -> None:
    """Join a torch.distributed world of `num_processes` processes as rank
    `process_id`, rendezvousing at `coordinator_address` ("host:port", the
    TCP store of rank 0): the counterpart of JAX's jax.distributed
    wrapper.  The backend is NCCL on the card (the default) and gloo with
    device="cpu"; backend="gloo" on the card is for ranks that share a
    card, which NCCL refuses (gloo stages their CUDA tensors through host
    memory, parallel/collectives.py).  Afterwards a parallel/mesh.py mesh
    can span the processes."""
    import torch.distributed as dist

    from ..config import resolve_device

    on_card = resolve_device(device).type == "cuda"
    if backend is None:
        backend = "nccl" if on_card else "gloo"
    if backend not in ("nccl", "gloo") or (backend == "nccl"
                                           and not on_card):
        raise ValueError(f"backend {backend!r} on {device}: NCCL or gloo on "
                         f"the card, gloo on the CPU")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


@dataclasses.dataclass
class PoolStats:
    requests: int = 0
    tokens: int = 0
    wall_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s > 0 else 0.0


class EngineReplicaPool:
    """Continuous batching across N engine replicas with a shared queue.

    Scheduling: each drive step offers the queue head to every replica
    that can admit it (free slot AND enough free pages), then advances
    all replicas one engine step.  Work therefore flows to whichever
    replica frees capacity first.
    """

    def __init__(self, engines: List[ServingEngine]):
        if not engines:
            raise ValueError("need at least one engine replica")
        self.engines = engines
        # (gid, prompt, max_new_tokens, eos_id, sampling-params dict)
        self.queue: List[tuple] = []
        self.finished: List[Request] = []
        self._next_id = 0
        self._id_map: dict = {}        # (replica, local_id) -> global_id
        self.stats = PoolStats()

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None,
               on_token=None, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 0.0,
               logprobs: bool = False) -> int:
        gid = self._next_id
        self._next_id += 1
        self.queue.append((gid, np.asarray(prompt, np.int32),
                           max_new_tokens, eos_id,
                           dict(on_token=on_token, temperature=temperature,
                                top_k=top_k, top_p=top_p,
                                logprobs=logprobs)))
        return gid

    def _try_dispatch(self) -> None:
        while self.queue:
            gid, prompt, mnt, eos, samp = self.queue[0]
            for ri, eng in enumerate(self.engines):
                free_slot = any(s is None for s in eng.slots)
                need = -(-(len(prompt) + mnt) // eng.page_size)
                if free_slot and not eng.waiting \
                        and need <= eng.allocator.num_free:
                    lid = eng.submit(prompt, mnt, eos, **samp)
                    self._id_map[(ri, lid)] = gid
                    break
            else:
                return  # nobody can take it yet
            self.queue.pop(0)

    def has_work(self) -> bool:
        return bool(self.queue) or any(e.has_work() for e in self.engines)

    def step(self) -> None:
        self._try_dispatch()
        for eng in self.engines:
            if eng.has_work():
                eng.step()

    def run(self, max_steps: int = 10**9) -> List[Request]:
        """Drive until everything completes; returns requests sorted by
        global id (Request.req_id is rewritten to the global id)."""
        t0 = time.perf_counter()
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        out: List[Request] = []
        for ri, eng in enumerate(self.engines):
            done, eng.finished = eng.finished, []
            for r in done:
                r.req_id = self._id_map.pop((ri, r.req_id))
                out.append(r)
        self.stats.wall_s += time.perf_counter() - t0
        self.stats.requests += len(out)
        self.stats.tokens += sum(len(r.output) for r in out)
        self.finished.extend(out)
        return sorted(out, key=lambda r: r.req_id)


class MultiProcessServingPool:
    """Process-per-replica serving: the deployable form of
    EngineReplicaPool.

    Spawns N worker processes (serving/worker.py), each owning a complete
    engine replica (params, KV pool, allocator) and draining a shared
    request queue; finished generations flow back over a result queue.
    Workers rebuild the tiny Llama from `model_seed`, standing in for
    per-host checkpoint loading, on `engine_kw`'s device (the card unless
    it says device="cpu"; replicas on one card time-share it).
    `worker_env` is set in each worker before it runs any torch op.
    """

    def __init__(self, num_workers: int, engine_kw: dict,
                 model_seed: int = 0, transport: str = "mp",
                 warm: dict = None, worker_env: dict = None):
        """transport='mp' wires workers over multiprocessing queues
        (single machine); transport='tcp' serves the same queue pair over
        a TCP socket (serving/transport.py), the deployable cross-host
        form, with workers connecting by (host, port).  The worker loop
        is the same in both.  With `warm` ({"lens": [...], "new_tokens":
        n}) the constructor returns once every worker has served those
        prompt lengths; `ready_s` then holds each worker's seconds from
        the pool's start to its ready message."""
        import multiprocessing as mp

        from .worker import tcp_worker_main, worker_main

        self._ctx = mp.get_context("spawn")
        self._server = None
        if transport == "mp":
            self.req_q = self._ctx.Queue()
            self.res_q = self._ctx.Queue()
            target = worker_main
            where = (self.req_q, self.res_q)
        elif transport == "tcp":
            import queue

            from .transport import QueueTransportServer

            self.req_q = queue.Queue()
            self.res_q = queue.Queue()
            self._server = QueueTransportServer(self.req_q, self.res_q)
            target = tcp_worker_main
            where = (self._server.host, self._server.port)
        else:
            raise ValueError(f"unknown transport {transport!r}")
        t0 = time.perf_counter()
        self.procs = [
            self._ctx.Process(
                target=target,
                args=(i, model_seed, engine_kw, *where, warm, worker_env),
                daemon=True)
            for i in range(num_workers)
        ]
        for p in self.procs:
            p.start()
        self._next_id = 0
        self._pending = 0
        self.ready_s: dict = {}
        if warm:
            # block until every worker reports its caches warm, so
            # caller-side timing windows measure steady-state serving
            while len(self.ready_s) < num_workers:
                msg = self._get(600.0)
                if msg[0] == "__worker_ready__":
                    self.ready_s[msg[1]] = time.perf_counter() - t0

    def _get(self, timeout_s: float):
        """The next result, waiting up to `timeout_s` (queue.Empty after
        it), in slices of a second; a worker that died (a non-zero exit
        code) raises at once instead of leaving its requests to the
        timeout, as the JAX package's pool does."""
        import queue as _q

        deadline = time.monotonic() + timeout_s
        while True:
            try:
                return self.res_q.get(
                    timeout=max(0.0, min(1.0, deadline - time.monotonic())))
            except _q.Empty:
                dead = {i: p.exitcode for i, p in enumerate(self.procs)
                        if p.exitcode not in (None, 0)}
                if dead:
                    raise RuntimeError(f"serving workers died (worker: "
                                       f"exit code): {dead}") from None
                if time.monotonic() >= deadline:
                    raise

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0, logprobs: bool = False) -> int:
        gid = self._next_id
        self._next_id += 1
        self.req_q.put((gid, np.asarray(prompt, np.int32).tolist(),
                        max_new_tokens, eos_id,
                        {"temperature": temperature, "top_k": top_k,
                         "top_p": top_p, "logprobs": logprobs}))
        self._pending += 1
        return gid

    def collect(self, timeout_s: float = 600.0):
        """Block until every submitted request finishes; returns
        {gid: (worker_id, output tokens[, logprobs])}: the logprobs
        element rides along when the request asked for it."""
        import queue as _q

        out = {}
        while self._pending:
            try:
                msg = self._get(timeout_s)
            except _q.Empty:
                raise TimeoutError(
                    f"{self._pending} requests still pending")
            gid, wid = msg[0], msg[1]
            if gid == "__worker_done__":
                continue
            out[gid] = (wid,) + tuple(msg[2:])
            self._pending -= 1
        return out

    def shutdown(self, timeout_s: float = 60.0) -> None:
        for _ in self.procs:
            self.req_q.put(None)
        for p in self.procs:
            p.join(timeout=timeout_s)
            if p.is_alive():
                p.terminate()
        if self._server is not None:
            self._server.stop()
