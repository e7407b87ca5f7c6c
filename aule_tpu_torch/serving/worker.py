"""Worker process of the multi-process serving pool (counterpart of the JAX
package's scripts/serving_worker.py, inside the port so that the pool
imports it by name).

Each worker owns a full engine replica (its own params, KV pool, page
allocator) and drains a shared request queue: the process-per-host form
of serving data parallelism (decode never crosses processes; only
request/response tuples do).  The loop is the same over multiprocessing
queues (`worker_main`) and over TCP (`tcp_worker_main`,
serving/transport.py).

Protocol:
  request:  (gid, prompt int32 list, max_new_tokens, eos_id,
             {temperature, top_k, top_p, logprobs}) or the sentinel
            None -> drain and exit
  response: (gid, worker_id, output token list[, logprobs list]); the 4th
            element rides along iff the request asked for logprobs, so
            consumers unpack by prefix (msg[0:3]), not by fixed arity;
            ("__worker_ready__", worker_id, []) once its caches are warm
            (with `warm`), ("__worker_done__", worker_id, []) at exit

The worker polls the queue between engine steps, so new requests join
mid-flight (continuous batching across the fleet).  It builds the tiny
Llama (`LlamaConfig.tiny()`) from `model_seed` on `engine_kw`'s device:
the card unless the caller passes device="cpu".  `worker_env` is
applied before the worker runs any torch op, so a thread cap
(OMP_NUM_THREADS) holds from its first op.
"""

import os


def worker_main(worker_id, model_seed, engine_kw, req_q, res_q,
                warm=None, worker_env=None):
    # per-worker runtime settings, applied before torch spins up its
    # threads (an intra-op thread cap, so N CPU replicas on one machine do
    # not all fight over every core; AULE_TPU_TORCH_NO_BUILD, so a
    # worker on the card loads the parent's kernel library or fails)
    for key, val in (worker_env or {}).items():
        os.environ[key] = str(val)
    import numpy as np
    import torch

    from ..config import resolve_device
    from ..models import llama
    from .engine import ServingEngine

    if "OMP_NUM_THREADS" in (worker_env or {}):
        torch.set_num_threads(int(worker_env["OMP_NUM_THREADS"]))
    device = resolve_device(engine_kw.get("device", "cuda"))
    cfg = llama.LlamaConfig.tiny()
    gen = torch.Generator(device=device)
    gen.manual_seed(model_seed)
    params = llama.init_params(cfg, gen, device=device)
    eng = ServingEngine(params, cfg, **engine_kw)

    if warm:
        # warm this worker's caches (a prefill per prompt shape and the
        # decode) before pulling real work, so pool scaling measurements
        # see steady-state workers
        for n in warm.get("lens", []):
            eng.submit(np.zeros(int(n), np.int32),
                       int(warm.get("new_tokens", 8)))
            eng.run()
        eng.finished = []
        res_q.put(("__worker_ready__", worker_id, []))

    gid_of = {}
    draining = False

    def admit(item):
        gid, prompt, mnt, eos, samp = item
        lid = eng.submit(np.asarray(prompt, np.int32), mnt, eos_id=eos,
                         **samp)
        gid_of[lid] = gid

    while True:
        # admit everything currently queued (non-blocking)
        while not draining:
            try:
                item = req_q.get_nowait()
            except Exception:
                break
            if item is None:
                draining = True
                break
            admit(item)
        if not eng.has_work():
            if draining:
                break
            try:
                item = req_q.get(timeout=0.2)
            except Exception:
                continue
            if item is None:
                draining = True
                continue
            admit(item)
        eng.step()
        done, eng.finished = eng.finished, []
        for r in done:
            msg = (gid_of.pop(r.req_id), worker_id, list(r.output))
            if r.want_logprobs:
                msg += (list(r.logprobs),)
            res_q.put(msg)
    res_q.put(("__worker_done__", worker_id, []))


def tcp_worker_main(worker_id, model_seed, engine_kw, host, port,
                    warm=None, worker_env=None):
    """TCP form of the worker: the same loop, its queues behind the wire
    (serving/transport.py).  The entry a fleet launches on each host,
    pointed at the pool's (host, port)."""
    from .transport import RemoteQueue

    worker_main(worker_id, model_seed, engine_kw,
                RemoteQueue(host, port, "req"),
                RemoteQueue(host, port, "res"), warm=warm,
                worker_env=worker_env)
