"""Serving walkthrough: one engine, every serving feature at once
(counterpart of the JAX package's examples/serve_demo.py).

    python -m aule_tpu_torch.examples.serve_demo [--device cpu]

On the card by default (the kernels built at first use); --device cpu
runs the plain PyTorch versions.  Shows continuous batching, chunked
prefill, automatic prefix caching (the second request shares the first's
32-token system prompt pages), per-request temperature in a mixed batch,
streamed tokens, int8 KV (quantized=True), then speculative decoding with
a small draft model.  `main()` returns what it served, so a caller can
check it.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import resolve_device
from ..models import llama
from ..serving.engine import ServingEngine

ENGINE_KW = dict(max_batch=4, page_size=16, num_pages=128,
                 max_pages_per_seq=8, max_seq_len=256)
DRAFT_CFG = dict(dim=64, n_layers=1, n_heads=2, hidden_dim=128)


def _seeded_params(cfg, seed: int, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return llama.init_params(cfg, gen, device=dev)


def prompts():
    """The two requests' prompts: a shared 32-token system prompt, then 6
    and 9 tokens of their own (the JAX demo's draws)."""
    rng = np.random.default_rng(0)
    system_prompt = rng.integers(0, 256, size=32).astype(np.int32)
    a = np.concatenate([system_prompt,
                        rng.integers(0, 256, size=6).astype(np.int32)])
    b = np.concatenate([system_prompt,
                        rng.integers(0, 256, size=9).astype(np.int32)])
    return a, b


def main(device=None, params=None, draft_params=None) -> dict:
    """Serve the demo on `device` (the card unless "cpu"): the tiny Llama
    (`params`, or weights seeded 0) with prefill_chunk=16, the prefix
    cache and int8 KV: a greedy request and one at temperature 1.2, both
    streamed through on_token; then request a again, 12 tokens, through a
    speculative engine (the tiny draft: `draft_params` or seeded 1; K=3).
    Returns {"cfg", "draft_cfg", "prompts", "requests" (finished, by id),
    "streamed" ({id: tokens}), "spec_requests", "prefix_cache_hit_tokens",
    "spec_accepted", "spec_drafted"}."""
    dev = resolve_device(device or "cuda")
    cfg = llama.LlamaConfig.tiny()
    if params is None:
        params = _seeded_params(cfg, 0, dev)
    eng = ServingEngine(
        params, cfg, **ENGINE_KW,
        prefill_chunk=16,           # chunked prefill: any prompt length
        enable_prefix_cache=True,   # shared prompt prefixes reuse KV pages
        quantized=True,             # int8 KV pools
        device=dev)
    a, b = prompts()
    streamed: dict = {}

    def stream(rid, tok):
        streamed.setdefault(rid, []).append(int(tok))
        print(f"  [stream] request {rid} -> token {tok}")

    # two requests sharing the system prompt; one greedy, one sampled
    eng.submit(a, max_new_tokens=6, on_token=stream)
    eng.submit(b, max_new_tokens=6, temperature=1.2, on_token=stream)
    done = sorted(eng.run(), key=lambda r: r.req_id)
    for req in done:
        kind = "greedy" if req.temperature == 0 else f"T={req.temperature}"
        print(f"request {req.req_id} ({kind}): {req.output}")
    print(f"prefix-cache hit tokens: {eng.prefix_cache_hit_tokens}")

    # speculative decoding: the draft proposes 3 tokens a round, the target
    # verifies them in one dispatch and keeps the agreeing prefix plus its
    # own next token (greedy: the tokens of plain decoding)
    draft_cfg = llama.LlamaConfig.tiny(**DRAFT_CFG)
    if draft_params is None:
        draft_params = _seeded_params(draft_cfg, 1, dev)
    spec = ServingEngine(params, cfg, **ENGINE_KW,
                         draft_params=draft_params, draft_cfg=draft_cfg,
                         spec_tokens=3, device=dev)
    spec.submit(a, max_new_tokens=12)
    spec_done = spec.run()
    for req in spec_done:
        print(f"speculative request {req.req_id}: {req.output}")
    print(f"spec acceptance: {spec.spec_accepted}/{spec.spec_drafted} "
          f"drafted tokens accepted")
    return {"cfg": cfg, "draft_cfg": draft_cfg, "prompts": (a, b),
            "requests": done, "streamed": streamed,
            "spec_requests": spec_done,
            "prefix_cache_hit_tokens": eng.prefix_cache_hit_tokens,
            "spec_accepted": spec.spec_accepted,
            "spec_drafted": spec.spec_drafted}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    main(ap.parse_args().device)
