"""The port's multi-process serving layer (aule_tpu_torch/serving/
multihost.py, transport.py, worker.py) against the JAX package's
(tests/test_multihost.py).

On the CPU: the in-process replica pool's tokens and stats equal JAX's
`EngineReplicaPool` on the same weights (carried across by
`load_jax_params`), also when the queue waits for capacity; the TCP
transport's framing round-trips, and the port's client talks to JAX's
server (one wire format); two spawned CPU workers over multiprocessing
queues and over TCP give the tokens of the port's single engine built
from the same seed; a worker that dies fails the pool at once (a fault of
the reference the port does not copy); and two processes that join
through `distributed_init` (gloo, a free port) take one data-parallel
train step of the tiny Llama equal to the one-process step within
GRAD_TOL (the counterpart of `__graft_entry__.dryrun_multihost`).
"""

import queue
import socket
import time

import jax
import numpy as np
import pytest
import torch

from aule_tpu.models import llama as jllama
from aule_tpu.serving.engine import ServingEngine as JaxEngine
from aule_tpu.serving.multihost import EngineReplicaPool as JaxPool
from aule_tpu.serving.transport import QueueTransportServer as JaxServer
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.serving import (EngineReplicaPool,
                                    MultiProcessServingPool)
from aule_tpu_torch.serving.engine import ServingEngine
from aule_tpu_torch.serving.transport import (QueueTransportServer,
                                              RemoteQueue)
from aule_tpu_torch.utils.testing import (assert_close, cap_cpu_threads,
                                          model_cases, run_world)
from aule_tpu_torch.utils.tree import tree_flatten, tree_map

cap_cpu_threads()

JCFG = jllama.LlamaConfig.tiny()
TCFG = tllama.LlamaConfig.tiny()
KW = dict(max_batch=2, page_size=16, num_pages=64, max_pages_per_seq=8,
          max_seq_len=256)
GRAD_TOL = 1e-4   # tests/test_torch_sharded.py's
WORKER_ENV = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(JCFG, jax.random.key(0))
    return jp, tllama.load_jax_params(jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in lens]


def _pools(params, n, **kw):
    return (JaxPool([JaxEngine(params[0], JCFG, **dict(KW, **kw))
                     for _ in range(n)]),
            EngineReplicaPool([ServingEngine(params[1], TCFG, device="cpu",
                                             **dict(KW, **kw))
                               for _ in range(n)]))


def test_serving_surface_matches_jax():
    """The same `__all__` as aule_tpu.serving, and the same three names
    loaded lazily from the front-end modules."""
    import aule_tpu.serving as jserving
    import aule_tpu_torch.serving as tserving

    assert tserving.__all__ == jserving.__all__
    for name in ("ServingHTTPServer", "EngineReplicaPool",
                 "MultiProcessServingPool"):
        obj = getattr(tserving, name)
        assert obj.__name__ == getattr(jserving, name).__name__
        assert obj.__module__.startswith("aule_tpu_torch.serving.")
    with pytest.raises(AttributeError):
        tserving.NoSuchName


def test_replica_pool_matches_jax_pool(params):
    """6 requests over 2 replicas of 2 slots each: every request's tokens,
    its global id and the pool's counts equal JAX's pool's."""
    prompts = _prompts(3, (5, 9, 7, 12, 6, 8))
    runs = []
    for pool in _pools(params, 2):
        gids = [pool.submit(p, max_new_tokens=4) for p in prompts]
        done = pool.run()
        assert [r.req_id for r in done] == sorted(gids)
        runs.append(([r.output for r in done], pool.stats.requests,
                     pool.stats.tokens))
        assert pool.stats.tokens_per_s > 0
    assert runs[1] == runs[0]
    assert runs[1][1:] == (6, 24)


def test_replica_pool_queues_when_full(params):
    """More requests than total capacity: the queue drains as the replica
    frees capacity; nothing is lost or truncated, as in JAX's pool."""
    prompts = _prompts(4, (6,) * 5)
    outs = []
    for pool in _pools(params, 1, max_batch=1, num_pages=17):
        for p in prompts:
            pool.submit(p, max_new_tokens=3)
        done = pool.run()
        assert len(done) == 5 and all(len(r.output) == 3 for r in done)
        outs.append([r.output for r in done])
    assert outs[1] == outs[0]


def test_remote_queue_roundtrip():
    """Framing, empty-queue semantics, both queues; and the port's client
    against JAX's server: the same wire format."""
    for server in (QueueTransportServer, JaxServer):
        req_q, res_q = queue.Queue(), queue.Queue()
        srv = server(req_q, res_q)
        try:
            rq = RemoteQueue(srv.host, srv.port, "req")
            rs = RemoteQueue(srv.host, srv.port, "res")
            req_q.put({"x": np.arange(3).tolist(), "y": "z"})
            assert rq.get_nowait() == {"x": [0, 1, 2], "y": "z"}
            with pytest.raises(queue.Empty):
                rq.get_nowait()
            with pytest.raises(queue.Empty):
                rq.get(timeout=0.05)
            req_q.put(None)
            assert rq.get() is None  # blocking get
            rs.put(("result", 7, [1, 2]))
            assert res_q.get(timeout=5) == ("result", 7, [1, 2])
            rq.close()
            rs.close()
        finally:
            srv.stop()
    with pytest.raises(ValueError):
        RemoteQueue("127.0.0.1", 1, "other")


def _single_engine_outputs(prompts, n, logprobs_at=()):
    gen = torch.Generator().manual_seed(0)
    eng = ServingEngine(tllama.init_params(TCFG, gen, device="cpu"), TCFG,
                        device="cpu", **KW)
    out = []
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=n, logprobs=i in logprobs_at)
        r = eng.run()[0]
        out.append((r.output, r.logprobs if i in logprobs_at else None))
    return out


@pytest.mark.parametrize("transport", ["mp", "tcp"])
def test_multiprocess_pool_matches_single_engine(transport):
    """2 spawned CPU workers (each a full engine from model_seed 0) drain
    the shared queue over multiprocessing queues or over TCP; every
    greedy request's tokens equal the port's single engine built from the
    same seed, and the logprobs ride along where asked."""
    prompts = _prompts(5, (5, 9, 7, 12))
    want = _single_engine_outputs(prompts, 4, logprobs_at=(1,))
    pool = MultiProcessServingPool(2, dict(KW, device="cpu"), model_seed=0,
                                   transport=transport,
                                   warm={"lens": [5], "new_tokens": 2},
                                   worker_env=WORKER_ENV)
    try:
        assert sorted(pool.ready_s) == [0, 1]
        gids = [pool.submit(p, max_new_tokens=4, logprobs=i == 1)
                for i, p in enumerate(prompts)]
        got = pool.collect(timeout_s=120)
    finally:
        pool.shutdown()
    for g, (toks, lps) in zip(gids, want):
        assert got[g][1] == toks, (g, got[g], toks)
        if lps is not None:
            np.testing.assert_allclose(got[g][2], lps, atol=1e-6)
        else:
            assert len(got[g]) == 2
    assert all(not p.is_alive() for p in pool.procs)


def test_dead_worker_fails_the_pool_at_once():
    """A fault of the reference the port does not copy (ROADMAP queue 3):
    JAX's pool waits out collect's whole timeout for a worker that died;
    the port's raises as soon as the worker's exit code shows."""
    pool = MultiProcessServingPool(1, dict(KW, device="cpu",
                                           layout="no such layout"),
                                   worker_env=WORKER_ENV)
    try:
        pool.submit([1, 2, 3], 2)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="died"):
            pool.collect(timeout_s=300)
        assert time.monotonic() - t0 < 60
    finally:
        pool.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_distributed_init_data_parallel_step(params):
    """Two processes join one gloo world through distributed_init (a TCP
    store on a free port) and take one SGD step of the tiny Llama on a
    (data 2, model 1) mesh: loss and updated params equal the
    one-process step's within GRAD_TOL."""
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 17)).astype(np.int64))
    case = dict(kind="sgd", mesh=((2, 1), ("data", "model")),
                params=params[1], cfg=TCFG, tokens=tokens,
                kwargs=dict(lr=1e-2))
    got = run_world(model_cases, 2, [case],
                    address=f"127.0.0.1:{_free_port()}")[0][0]
    one = tree_map(torch.clone, params[1])
    one, loss = tllama.train_step(one, tokens, TCFG, lr=1e-2)
    assert abs(got["losses"][0] - float(loss)) < GRAD_TOL
    for i, (a, b) in enumerate(zip(tree_flatten(got["params"]),
                                   tree_flatten(one))):
        assert_close(a, b.detach(), GRAD_TOL, GRAD_TOL, f"leaf {i}")
