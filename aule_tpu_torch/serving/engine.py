"""Continuous-batching serving engine (counterpart of
aule_tpu/serving/engine.py) for the single-device case, over fused pools
(the default) or split head-major pools (`layout="split"`), with pools of
the model's dtype or quantized (int8, e4m3) pools and whole-prompt or
(fused) chunked prefill.

`model=` is the model family module: `models.llama` (the default),
`models.gpt2` or `models.moe` (JAX engine.py:217-220); the engine calls
its `forward`,
`prefill_step_fused`, `decode_step_fused` and, for split pools,
`decode_step`.  A host loop drives eager PyTorch steps on the card:
  * admission: a request joins when a batch slot and all the pages its
    prompt plus max_new_tokens need are free;
  * prefill, whole prompt: one `model.forward` (the flash kernel) over the
    prompt, whose K and V (rotated, for Llama) are then written into the
    request's pages (quantized with `quantized=True`);
  * prefill, chunked (`prefill_chunk=c`, fused layout only, as JAX's):
    `model.prefill_step_fused` (the paged-prefill kernel) over chunks at
    offsets 0, c, 2c, ..., each attending to the pages the earlier chunks
    wrote;
  * decode: every running sequence advances through
    `model.decode_step_fused` (the paged-decode kernel), or
    `model.decode_step` over split pools (its split-pool instantiation);
    when nothing waits and every request has at least `decode_steps`
    tokens to go, K steps run back to back with the tokens kept on the
    device and ONE host copy per dispatch (the JAX scheduling rule,
    engine.py:1664-1666).

Page 0 is the reserved scratch page: empty slots carry block-table -1,
which clamps to page 0, so their dummy appends never touch a live page.
The JAX engine pads prompts to power-of-two buckets, chunks to
`prefill_chunk` tokens and group rows to 8; those are TPU compile and tile
artifacts and the port runs exact shapes (the last chunk of a prompt is
its remainder).

Options of the JAX engine outside this slice raise NotImplementedError
naming the slice that brings them; none is silently ignored.

`save_engine_state` / `load_engine_state` checkpoint a running engine in
the JAX package's files (JAX engine.py:1726-1855), so either package can
resume the other's greedy requests.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import PAGE_SIZE, resolve_device
from ..models import gpt2, llama, moe
from ..ops.paged import (kv_cache_append_prefill,
                         kv_cache_append_prefill_quantized)
from ..ops.paged_fused import (SCALE_DTYPE, fused_pool_shape,
                               fused_scales_shape,
                               kv_cache_append_prefill_fused)
from ..ops.quant import QUANT_DTYPES
from ..ops.rope import precompute_rope_frequencies
from ..utils.checkpoint import load_pytree, save_pytree
from . import sampling
from .kv_cache import PythonPageAllocator

_EDGES = "the serving-edges slice"

# engine arguments of the JAX engine outside this slice: (default, slice)
_LATER_ENGINE_ARGS = {
    "enable_prefix_cache": (False, _EDGES),
    "mesh": (None, "the parallel-layer slice"),
    "model_axis": ("model", "the parallel-layer slice"),
    "sample": (None, _EDGES),
    "sampler": (None, _EDGES),
    "draft_params": (None, _EDGES),
    "draft_cfg": (None, _EDGES),
    "draft_model": (None, _EDGES),
    "spec_tokens": (0, _EDGES),
    "spec_min_acceptance": (0.0, _EDGES),
    "ngram_spec": (0, _EDGES),
    "ngram_max": (3, _EDGES),
    "lora_params": (None, _EDGES),
}

# submit() options of the JAX engine outside this slice
_LATER_SUBMIT_ARGS = {
    "top_k": (0, _EDGES),
    "top_p": (0.0, _EDGES),
    "logprobs": (False, _EDGES),
    "stop": (None, _EDGES),
    "logit_bias": (None, _EDGES),
    "lora": (None, _EDGES),
}


def _refuse_later(given: Dict[str, Any], table, where: str) -> None:
    for name, value in given.items():
        if name not in table:
            raise TypeError(f"{where} got an unexpected argument {name!r}")
        default, later = table[name]
        if value != default and value is not None:
            raise NotImplementedError(
                f"{where}: {name}={value!r} is not ported yet; it comes "
                f"with {later}")


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    # streaming: on_token(req_id, token) for every generated token
    on_token: Optional[Callable[[int, int], None]] = None
    # temperature 0 = greedy (the default)
    temperature: float = 0.0
    # set by ServingEngine.cancel(): retired early with a partial output
    cancelled: bool = False

    def _emit(self, tok: int) -> None:
        self.output.append(tok)
        if self.on_token is not None:
            self.on_token(self.req_id, tok)

    @property
    def done(self) -> bool:
        if len(self.output) >= self.max_new_tokens:
            return True
        return (bool(self.output) and self.eos_id is not None
                and self.output[-1] == self.eos_id)


# the model families the engine drives (the port's own modules)
MODEL_FAMILIES = (llama, gpt2, moe)


class ServingEngine:
    """Continuous batching over a model family of the port (`model=`:
    models/llama.py, the default, models/gpt2.py or models/moe.py) with
    paged KV pools
    on one device (the card unless device='cpu').

    layout='fused' (the default) keeps one stacked fused pool `kv_pages`
    [L, P, 2, Hkv, page, Dpad]; layout='split' keeps vLLM-style head-major
    `k_pages` and `v_pages` [L, Hkv, P, page, D] (the attributes of the
    other layout are None).  quantized=True stores K/V as `quant_dtype`
    payloads (torch.int8, the default, or torch.float8_e4m3fn): fused
    pools with one stacked packed scale pool `kv_scales` [L, P, page, 128]
    bf16 (int8 decodes on the int8 dot-product path unless
    AULE_TPU_INT8_EXACT is set), split pools with f32 `k_scales` and
    `v_scales` [L, Hkv, P, page] (exact, scale-folded decode).
    prefill_chunk=c prefills prompts in chunks of c tokens through the
    paged-prefill kernel (fused layout only).  Unquantized pools take the
    model's dtype (f32 for GPT-2), with D padded to 128 lanes in the fused
    layout.  A model with learned positions (GPT-2's `cfg.n_ctx`) refuses
    max_seq_len past its table."""

    def __init__(
        self,
        params: Dict[str, Any],
        cfg,
        *,
        max_batch: int = 8,
        page_size: int = PAGE_SIZE,
        num_pages: int = 512,
        max_pages_per_seq: int = 64,
        max_seq_len: int = 2048,
        sample_seed: int = 0,
        layout: str = "fused",
        decode_steps: int = 8,
        quantized: bool = False,
        quant_dtype=torch.int8,
        prefill_chunk: Optional[int] = None,
        model=None,
        device="cuda",
        **later,
    ):
        self.device = resolve_device(device)
        if quantized and quant_dtype not in QUANT_DTYPES:
            raise ValueError(f"quant_dtype must be torch.int8 or "
                             f"torch.float8_e4m3fn, got {quant_dtype}")
        if prefill_chunk is not None and prefill_chunk <= 0:
            raise ValueError(f"prefill_chunk must be positive, got "
                             f"{prefill_chunk}")
        if layout not in ("fused", "split"):
            raise ValueError(f"unknown layout {layout!r}")
        if prefill_chunk is not None and layout != "fused":
            raise ValueError("prefill_chunk requires layout='fused'")
        _refuse_later(later, _LATER_ENGINE_ARGS, "ServingEngine")
        self.model = llama if model is None else model
        if not any(self.model is m for m in MODEL_FAMILIES):
            raise NotImplementedError(
                f"ServingEngine: model={model!r} is not a model family of "
                f"the port; pass aule_tpu_torch.models.llama, .gpt2 or "
                f".moe")
        if layout == "split" and not hasattr(self.model, "decode_step"):
            raise ValueError(
                f"layout='split' decodes through the model's decode_step "
                f"over split pools, which {self.model.__name__} has not "
                f"(nor has the JAX package's); use layout='fused'")
        # learned positions silently reuse the last row past n_ctx (as
        # JAX's gather clamps): refuse an engine that could decode there
        n_ctx = getattr(cfg, "n_ctx", None)
        if n_ctx is not None and max_seq_len > n_ctx:
            raise ValueError(
                f"max_seq_len {max_seq_len} exceeds the model's learned-"
                f"position table n_ctx={n_ctx}")
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.max_seq_len = max_seq_len
        self.rope_cos, self.rope_sin = precompute_rope_frequencies(
            max_seq_len, cfg.head_dim, cfg.rope_base, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(sample_seed)
        self.prefill_chunk = prefill_chunk
        self.layout = layout
        # stacked pools (and scale pools); layer li is the view [li]
        pool_dtype = quant_dtype if quantized else cfg.dtype
        self.kv_pages = self.kv_scales = None
        self.k_pages = self.v_pages = self.k_scales = self.v_scales = None

        def zeros(shape, dtype):
            return torch.zeros((cfg.n_layers,) + tuple(shape), dtype=dtype,
                               device=self.device)

        if layout == "fused":
            self.kv_pages = zeros(fused_pool_shape(
                num_pages, cfg.n_kv_heads, page_size, cfg.head_dim),
                pool_dtype)
            if quantized:
                self.kv_scales = zeros(fused_scales_shape(
                    num_pages, cfg.n_kv_heads, page_size), SCALE_DTYPE)
        else:  # as aule_tpu/serving/engine.py:286-294
            shape = (cfg.n_kv_heads, num_pages, page_size, cfg.head_dim)
            self.k_pages = zeros(shape, pool_dtype)
            self.v_pages = zeros(shape, pool_dtype)
            if quantized:
                self.k_scales = zeros(shape[:-1], torch.float32)
                self.v_scales = zeros(shape[:-1], torch.float32)
        self.allocator = PythonPageAllocator(num_pages)
        # page 0 is the scratch sink for -1 table entries (empty slots)
        scratch = self.allocator.allocate(1)
        if scratch != [0]:
            raise RuntimeError("page 0 must be the scratch page")

        self.slots: List[Optional[Request]] = [None] * max_batch
        self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self.slot_lens = np.zeros((max_batch,), np.int32)
        self.waiting: List[Request] = []
        self.finished: List[Request] = []
        self._next_id = 0
        self.decode_steps = max(1, int(decode_steps))

        # observability counters (see stats())
        self.tokens_generated = 0
        self.prefill_dispatches = 0
        self.decode_dispatches = 0
        self.decode_steps_run = 0
        # host seconds in prefill and in decode dispatches; each dispatch
        # ends in a host copy of its tokens, so these include device time
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    # -- public API ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               temperature: float = 0.0, **later) -> int:
        _refuse_later(later, _LATER_SUBMIT_ARGS, "submit")
        prompt = np.asarray(prompt, np.int32)
        if prompt.size == 0:
            raise ValueError("empty prompt: nothing to prefill")
        # admission is all-or-nothing: a request that cannot fit its page
        # budget would overrun into scratch page 0, so reject it here
        total = prompt.size + max_new_tokens
        capacity = min(self.max_pages_per_seq * self.page_size,
                       self.max_seq_len)
        if total > capacity:
            raise ValueError(
                f"request needs {total} tokens (prompt {prompt.size} + "
                f"max_new_tokens {max_new_tokens}) but the engine caps a "
                f"sequence at {capacity} "
                f"(min(max_pages_per_seq*page_size, max_seq_len))")
        if temperature < 0:
            raise ValueError("temperature must be >= 0")
        req = Request(self._next_id, prompt, max_new_tokens, eos_id,
                      on_token=on_token, temperature=float(temperature))
        self._next_id += 1
        self.waiting.append(req)
        return req.req_id

    def cancel(self, req_id: int) -> bool:
        """Abort a request: a waiting one leaves the queue, a running one
        retires at once and frees its pages.  It lands in `finished` with
        cancelled=True.  False when the id is unknown or finished."""
        for i, r in enumerate(self.waiting):
            if r.req_id == req_id:
                self.waiting.pop(i)
                r.cancelled = True
                self.finished.append(r)
                return True
        for s, r in enumerate(self.slots):
            if r is not None and r.req_id == req_id:
                r.cancelled = True
                self._retire(s)
                return True
        return False

    def stats(self) -> Dict[str, Any]:
        return {
            "running": self.num_running,
            "waiting": len(self.waiting),
            "finished": len(self.finished),
            "free_pages": self.allocator.num_free,
            "tokens_generated": self.tokens_generated,
            "prefill_dispatches": self.prefill_dispatches,
            "decode_dispatches": self.decode_dispatches,
            "decode_steps": self.decode_steps_run,
            "prefill_seconds": self.prefill_seconds,
            "decode_seconds": self.decode_seconds,
        }

    @property
    def num_running(self) -> int:
        return sum(r is not None for r in self.slots)

    def has_work(self) -> bool:
        return bool(self.waiting) or self.num_running > 0

    def run(self, max_steps: int = 10**9) -> List[Request]:
        """Drive until all submitted requests complete; returns them."""
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        out, self.finished = self.finished, []
        return sorted(out, key=lambda r: r.req_id)

    # -- engine internals -------------------------------------------------

    @torch.no_grad()
    def step(self) -> None:
        self._admit()
        if self.num_running:
            self._decode_all()

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.waiting:
                continue
            req = self.waiting[0]
            need = -(-(len(req.prompt) + req.max_new_tokens)
                     // self.page_size)
            if need > self.allocator.num_free:
                break  # wait for running sequences to retire
            self.waiting.pop(0)
            pages = self.allocator.allocate(need)
            if 0 in pages:
                raise RuntimeError("scratch page 0 was handed out")
            self.slots[slot] = req
            self.slot_pages[slot] = pages
            self.slot_lens[slot] = 0
            self._run_prefill(slot, req)

    def _block_table(self) -> torch.Tensor:
        bt = np.full((self.max_batch, self.max_pages_per_seq), -1, np.int32)
        for s, pages in enumerate(self.slot_pages):
            bt[s, :len(pages)] = pages
        return torch.from_numpy(bt).to(self.device)

    def _prefill(self, tokens: torch.Tensor, bt_row: torch.Tensor):
        """Forward over one prompt [1, n] and write its K/V into the pages
        of `bt_row` (quantized when the pools are, as the JAX engine,
        engine.py:920-944); returns the logits of the last prompt
        position."""
        n = tokens.shape[1]
        logits, kv = self.model.forward(
            self.params, tokens, self.cfg, rope_cos=self.rope_cos,
            rope_sin=self.rope_sin, return_kv=True)
        where = (bt_row[None],
                 torch.zeros((1,), dtype=torch.int32, device=self.device),
                 torch.full((1,), n, dtype=torch.int32, device=self.device))
        for li, (k, v) in enumerate(kv):
            if self.layout == "fused":
                kv_cache_append_prefill_fused(
                    self.kv_pages[li], k, v, *where,
                    kv_scales=None if self.kv_scales is None
                    else self.kv_scales[li])
            elif self.k_scales is not None:
                kv_cache_append_prefill_quantized(
                    self.k_pages[li], self.v_pages[li], self.k_scales[li],
                    self.v_scales[li], k, v, *where)
            else:
                kv_cache_append_prefill(self.k_pages[li], self.v_pages[li],
                                        k, v, *where)
        self.prefill_dispatches += 1
        return logits[0, n - 1]

    def _prefill_chunked(self, tokens: torch.Tensor, bt_row: torch.Tensor):
        """Chunks of `prefill_chunk` tokens at offsets 0, c, 2c, ... through
        `model.prefill_step_fused` (engine.py:1329-1381); each chunk
        appends its K/V and attends to everything before it.  Returns the
        logits of the last prompt position."""
        n, c = tokens.shape[1], self.prefill_chunk
        logits = None
        for off in range(0, n, c):
            chunk = tokens[:, off:off + c]
            out = self.model.prefill_step_fused(
                self.params, chunk,
                torch.full((1,), off, dtype=torch.int32, device=self.device),
                torch.full((1,), chunk.shape[1], dtype=torch.int32,
                           device=self.device),
                self.kv_pages, bt_row[None], self.cfg, self.rope_cos,
                self.rope_sin, self.kv_scales)
            logits = out[0]
            self.prefill_dispatches += 1
        return logits[0]

    def _run_prefill(self, slot: int, req: Request) -> None:
        t0 = time.perf_counter()
        n = len(req.prompt)
        tokens = torch.from_numpy(req.prompt.astype(np.int64))[None].to(
            self.device)
        bt = np.full((self.max_pages_per_seq,), -1, np.int32)
        pages = self.slot_pages[slot]
        bt[:len(pages)] = pages
        bt_row = torch.from_numpy(bt).to(self.device)
        if self.prefill_chunk is not None:
            logits = self._prefill_chunked(tokens, bt_row)
        else:
            logits = self._prefill(tokens, bt_row)
        self.slot_lens[slot] = n
        if req.temperature > 0.0:
            tok = sampling.temperature(req.temperature)(logits,
                                                        self.generator)
        else:
            tok = torch.argmax(logits, dim=-1)
        tok = int(tok)
        self.prefill_seconds += time.perf_counter() - t0
        self.tokens_generated += 1
        req._emit(tok)
        if self.slots[slot] is not req:
            return  # cancel() from the callback already retired it
        if req.done:
            self._retire(slot)

    def _sample(self, logits: torch.Tensor,
                temps: Optional[torch.Tensor]) -> torch.Tensor:
        if temps is None:
            return torch.argmax(logits, dim=-1)
        return sampling.sample_rows(logits, temps, self.generator)

    def _decode_all(self) -> None:
        t0 = time.perf_counter()
        tokens = np.zeros((self.max_batch,), np.int64)
        remaining = []
        for s, req in enumerate(self.slots):
            if req is not None:
                tokens[s] = req.output[-1]
                remaining.append(req.max_new_tokens - len(req.output))
        temps = None
        if any(r is not None and r.temperature > 0.0 for r in self.slots):
            temps = torch.tensor(
                [r.temperature if r is not None else 0.0
                 for r in self.slots], dtype=torch.float32,
                device=self.device)
        k = self.decode_steps
        n_steps = (k if k > 1 and not self.waiting and remaining
                   and min(remaining) >= k else 1)
        tok = torch.from_numpy(tokens).to(self.device)
        lens = torch.from_numpy(self.slot_lens.copy()).to(self.device)
        bt = self._block_table()
        steps = []
        for _ in range(n_steps):
            # positions are the lengths before this token
            if self.layout == "fused":
                logits, _, new_lens, *_ = self.model.decode_step_fused(
                    self.params, tok, lens, self.kv_pages, bt, lens,
                    self.cfg, self.rope_cos, self.rope_sin, self.kv_scales)
            else:
                logits, _, _, new_lens, *_ = self.model.decode_step(
                    self.params, tok, lens, self.k_pages, self.v_pages, bt,
                    lens, self.cfg, self.rope_cos, self.rope_sin,
                    self.k_scales, self.v_scales)
            tok = self._sample(logits, temps)
            steps.append(tok)
            lens = new_lens
        next_np = torch.stack(steps).cpu().numpy()  # one host copy
        self.decode_seconds += time.perf_counter() - t0
        self.decode_dispatches += 1
        self.decode_steps_run += n_steps
        self.slot_lens = self.slot_lens + n_steps
        for s, req in enumerate(self.slots):
            if req is None:
                self.slot_lens[s] = 0
                continue
            for step in range(n_steps):
                self.tokens_generated += 1
                req._emit(int(next_np[step, s]))
                if self.slots[s] is not req:
                    break  # cancel() from the on_token callback retired it
                if req.done:
                    # eos overshoot: the pages hold a few tokens past eos,
                    # but the request retires and frees them
                    self._retire(s)
                    break

    def _retire(self, slot: int) -> None:
        self.finished.append(self.slots[slot])
        self.allocator.free(self.slot_pages[slot])
        self.slots[slot] = None
        self.slot_pages[slot] = []
        self.slot_lens[slot] = 0


# -- checkpoint / resume (JAX engine.py:1726-1855) ---------------------------

# the request fields of the JAX engine's file that belong to features the
# port's engine lacks, with the values a request that uses none of them has
_REQUEST_LATER = {"top_k": 0, "top_p": 0.0, "want_logprobs": False,
                  "logprobs": [], "stop": [], "logit_bias": None,
                  "lora": None}


def _pools_tree(eng: ServingEngine, leaf=None) -> Dict[str, Any]:
    """The engine's pools under the JAX engine's keys: the fused pool and
    its packed scales are JAX's `k_pages` and `k_scales` (its `v_pages`
    and `v_scales` are None then); there is no draft pool (`dk_*`).  With
    `leaf`, every pool is replaced by it (a template for load_pytree)."""
    if eng.layout == "fused":
        tree = {"k_pages": eng.kv_pages, "v_pages": None,
                "k_scales": eng.kv_scales, "v_scales": None}
    else:
        tree = {"k_pages": eng.k_pages, "v_pages": eng.v_pages,
                "k_scales": eng.k_scales, "v_scales": eng.v_scales}
    tree.update(dk_pages=None, dk_scales=None)
    if leaf is not None:
        tree = {k: None if v is None else leaf for k, v in tree.items()}
    return tree


def save_engine_state(eng: ServingEngine, path: str) -> None:
    """Persist the pools and the request and slot bookkeeping to
    `<path>.pools.npz` / `.pools.tree.json` / `.state.json`, the JAX
    engine's files; params are not saved (utils.checkpoint.save_pytree
    them separately).  Fields of the JAX engine's features the port lacks
    (prefix cache, speculative decoding, top-k / top-p, logprobs, stop
    sequences, logit bias, LoRA) are written with the values an engine
    that uses none of them writes.  The sampler's state is a
    torch.Generator's, under a key of the port's own
    (`torch_generator_state`): JAX's `rng_key` cannot be derived from it,
    so a JAX engine resumes the port's sampled requests from its own
    seed."""
    save_pytree(path + ".pools", _pools_tree(eng))

    def req(r: Optional[Request]):
        return None if r is None else dict(
            req_id=r.req_id, prompt=np.asarray(r.prompt).tolist(),
            max_new_tokens=r.max_new_tokens, eos_id=r.eos_id,
            output=list(r.output), temperature=r.temperature,
            cancelled=r.cancelled, **_REQUEST_LATER)

    host = {
        "slots": [req(r) for r in eng.slots],
        "slot_pages": [list(p) for p in eng.slot_pages],
        "slot_lens": eng.slot_lens.tolist(),
        "waiting": [req(r) for r in eng.waiting],
        "finished": [req(r) for r in eng.finished],
        "next_id": eng._next_id,
        "prefix_cache": {},
        "page_rc": {},
        "prefix_hit_tokens": 0,
        "free_pages": eng.allocator.free_list(),
        "slot_dlens": [0] * eng.max_batch,
        "spec_drafted": 0,
        "spec_accepted": 0,
        "spec_disabled": False,
        "torch_generator_state": eng.generator.get_state().tolist(),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path + ".state.json", "w") as f:
        json.dump(host, f)


def load_engine_state(eng: ServingEngine, path: str) -> None:
    """Restore state saved by save_engine_state, of either package, into
    a freshly constructed engine of the same configuration (pools of the
    same layout, shapes and dtypes, written in place).  A file that holds
    a feature the port's engine lacks (a prefix-cache entry, speculative
    decoding, a request with top-k / top-p, logprobs, stop sequences, a
    logit bias or a LoRA adapter) raises NotImplementedError naming the
    slice that brings it.  A JAX file carries no torch.Generator state:
    the engine keeps its own, so greedy requests resume exactly."""
    with open(path + ".state.json") as f:
        host = json.load(f)
    if host.get("prefix_cache") or host.get("page_rc"):
        raise NotImplementedError(
            f"load_engine_state: the file holds prefix-cache entries; the "
            f"prefix cache is not ported yet, it comes with {_EDGES}")
    if (host.get("spec_drafted") or host.get("spec_accepted")
            or any(host.get("slot_dlens", []))):
        raise NotImplementedError(
            f"load_engine_state: the file holds speculative-decoding state; "
            f"speculative decoding is not ported yet, it comes with {_EDGES}")
    if len(host["slots"]) != eng.max_batch:
        raise ValueError(f"the file has {len(host['slots'])} batch slots, "
                         f"the engine {eng.max_batch}")

    def req(d) -> Optional[Request]:
        if d is None:
            return None
        later = {"top_k": d.get("top_k", 0), "top_p": d.get("top_p", 0.0),
                 "logprobs": d.get("want_logprobs", False),
                 "stop": d.get("stop") or None,
                 "logit_bias": d.get("logit_bias") or None,
                 "lora": d.get("lora")}
        _refuse_later(later, _LATER_SUBMIT_ARGS,
                      f"load_engine_state: request {d['req_id']}")
        r = Request(d["req_id"], np.asarray(d["prompt"], np.int32),
                    d["max_new_tokens"], d["eos_id"],
                    temperature=float(d.get("temperature", 0.0)),
                    cancelled=bool(d.get("cancelled", False)))
        r.output.extend(int(t) for t in d["output"])
        return r

    slots = [req(d) for d in host["slots"]]
    waiting = [req(d) for d in host["waiting"]]
    finished = [req(d) for d in host["finished"]]
    pools = _pools_tree(eng)
    state = load_pytree(path + ".pools", _pools_tree(eng, leaf=0))
    for key, t in pools.items():
        if t is None:
            continue
        got = state[key]
        if got.shape != t.shape or got.dtype != t.dtype:
            raise ValueError(
                f"{key}: the file holds {tuple(got.shape)} {got.dtype}, the "
                f"engine {tuple(t.shape)} {t.dtype}")
        t.copy_(got)
    eng.slots = slots
    eng.slot_pages = [[int(p) for p in pages] for pages in host["slot_pages"]]
    eng.slot_lens = np.asarray(host["slot_lens"], np.int32)
    eng.waiting = waiting
    eng.finished = finished
    eng._next_id = int(host["next_id"])
    eng.allocator.set_free_list([int(p) for p in host["free_pages"]])
    if "torch_generator_state" in host:
        eng.generator.set_state(torch.tensor(host["torch_generator_state"],
                                             dtype=torch.uint8))
