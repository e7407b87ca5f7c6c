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

Per request (`submit`): temperature, top-k / top-p (one vocabulary sort,
only while a running sampled request restricts), logprobs (the raw
model's, a log-softmax only while a running request asks), stop
sequences (multi-step overshoot trimmed on the host), an additive logit
bias (a [B, V] matrix rebuilt only when the slots turn over) and a LoRA
adapter (`lora_params=`: a stacked bank, index 0 the all-zero base; the
per-row gathers only while a running request has an adapter).  A greedy
batch without any of them pays none of it.  `sampler=` (a
(logits, generator) sampler) and `sample=` (a logits -> token callable)
replace the per-request sampling, as in JAX.

`enable_prefix_cache=True` (with `prefill_chunk`) keeps full prompt pages
content-addressed by a chained SHA-1 seeded by the request's adapter
name (JAX engine.py:824-898, the same hashes byte for byte): a request
whose prompt starts with cached pages reuses them (refcounted; pinned
before any eviction) and prefills from the first uncached page; pages
nobody holds stay resident until pool pressure evicts them, oldest
registration first.

Speculative decoding (JAX engine.py:659-822, 995-1327), over fused pools
with the per-request options above (an engine-level `sampler=` / `sample=`
refuses it, as JAX's):
  * draft model (`spec_tokens=K`, `draft_params`, `draft_cfg`,
    `draft_model`: a family of the port, the target's by default): the
    draft keeps its own fused pool `dk_pages` (and `dk_scales` when
    quantized) in the target's pool dtype, addressed by the same block
    tables and the same allocator, and prefills every prompt beside the
    target (whole, or chunked from the prefix cache's hit: cached pages
    carry draft KV too).  A round is one draft chunked prefill over the
    tokens its pool lacks, K-1 draft decode steps and ONE target chunked
    prefill over [t, g0..g{K-1}] with every position's logits; greedy
    slots keep the longest prefix the target's biased argmax agrees with
    plus its next token (token-identical to plain greedy decode in exact
    arithmetic), sampled slots rejection-sample against the target's
    warped distribution (each emitted token keeps its distribution).  The
    round stays on the device and ends in ONE host copy of its tokens,
    counts and logprobs.  A slot whose budget cannot take K+1 tokens
    verifies only its pending token; `spec_min_acceptance` turns
    speculation off after 8 rounds under it;
  * prompt lookup (`ngram_spec=K`, `ngram_max`): the K tokens that
    followed the latest earlier occurrence of the context's last n-gram
    (n = ngram_max .. 1) are verified the same way, with no draft model.
Tensor-parallel serving (`mesh=`, `model_axis=`; JAX engine.py:157-175,
232-238, 295-321): every rank of the mesh runs this engine loop on the
same requests; the engine takes the full params and keeps this rank's
shards (`llama.shard_params`), and its pools hold the rank's Hkv/tp kv
heads in either layout and any pool dtype, so the paged kernels run
unchanged on each rank.  The model steps join the ranks (an all-reduce
after wo and after w_down, the logits all-gathered over the vocabulary),
and every token the ranks sample is broadcast from the axis' first rank
before anything reads it, so the ranks' pools never part.  The mesh's
other axes must be 1 (serving data parallelism is replicas of the
engine); a draft model shards over the same axis.  Every family shards by
its own `shard_params` (GPT-2's heads through its qkv-major `w_qkv`, MoE's
attention over the axis with its experts replicated, as JAX's
param_specs place them); LoRA with a mesh raises ValueError, as JAX's.
No option is silently ignored.  Pages come from
`kv_cache.make_allocator`: the native C++ free list where g++ builds it.

`save_engine_state` / `load_engine_state` checkpoint a running engine in
the JAX package's files (JAX engine.py:1726-1855), so either package can
resume the other's greedy requests, with their per-request options and
the prefix cache's maps.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import logging
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
from ..parallel.collectives import broadcast
from ..parallel.mesh import axis_size
from ..utils.checkpoint import load_pytree, save_pytree
from . import sampling
from .kv_cache import make_allocator

logger = logging.getLogger("aule_tpu_torch")

# speculation turns itself off after this many rounds under
# spec_min_acceptance (JAX engine.py:813)
SPEC_DISABLE_ROUNDS = 8
# the projections an adapter may target (JAX engine.py:362)
LORA_TARGETS = ("wq", "wk", "wv", "wo")


def _chosen_logprob(logits: torch.Tensor, toks: torch.Tensor
                    ) -> torch.Tensor:
    """log softmax(logits) at the chosen tokens, [B] f32 (JAX
    engine.py:46-50)."""
    lsm = torch.log_softmax(logits.float(), dim=-1)
    return lsm.gather(-1, toks.reshape(-1, 1).long().to(lsm.device))[:, 0]


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    # streaming: on_token(req_id, token) for every generated token
    on_token: Optional[Callable[[int, int], None]] = None
    # temperature 0 = greedy (the default); top_k 0 / top_p 0 =
    # unrestricted; they restrict only sampled (temperature > 0) draws
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    # set by ServingEngine.cancel(): retired early with a partial output
    cancelled: bool = False
    # submit(logprobs=True): logprobs[i] is log softmax(raw logits) at
    # output[i], before bias, temperature and restriction
    want_logprobs: bool = False
    logprobs: List[float] = dataclasses.field(default_factory=list)
    # stop sequences (token ids): the request ends when its output ends
    # with one of them (kept in the output, as eos)
    stop: List[List[int]] = dataclasses.field(default_factory=list)
    # {token id: additive bias} on the logits before the token is chosen
    logit_bias: Optional[Dict[int, float]] = None
    # the LoRA adapter's name (None = the base model)
    lora: Optional[str] = None

    def _emit(self, tok: int, logp: Optional[float] = None) -> None:
        self.output.append(tok)
        if self.want_logprobs and logp is not None:
            self.logprobs.append(float(logp))
        if self.on_token is not None:
            self.on_token(self.req_id, tok)

    @property
    def done(self) -> bool:
        if len(self.output) >= self.max_new_tokens:
            return True
        if (self.output and self.eos_id is not None
                and self.output[-1] == self.eos_id):
            return True
        return any(len(s) <= len(self.output)
                   and self.output[-len(s):] == s for s in self.stop)


# the model families the engine drives (the port's own modules)
MODEL_FAMILIES = (llama, gpt2, moe)


def _as_tensor(x, device) -> torch.Tensor:
    """An adapter matrix (torch, numpy or any array with __array__) on
    `device`, in its own dtype."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return llama._to_torch(np.asarray(x), device, None)


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
    max_seq_len past its table.

    `sampler` is a (logits, generator) sampler (serving/sampling.py) drawn
    from the engine's generator (seeded by `sample_seed`); `sample` a
    logits -> token callable (sampling.make_engine_sampler makes one);
    either replaces the per-request temperature / top-k / top-p.
    `lora_params` = {name: {"layers": [{"wq": (A [d, r], B [r, o]), ...}
    a layer]}} registers adapters on wq / wk / wv / wo (the alpha / r
    scale folded into B; fused layout only; ranks must agree per target);
    `submit(lora=name)` picks one.  `enable_prefix_cache` (with
    `prefill_chunk`) turns on the prefix cache.

    `spec_tokens=K` with `draft_params` / `draft_cfg` (and `draft_model`,
    a family of the port; the target's by default) speculates K tokens a
    round with the draft model; `ngram_spec=K` (`ngram_max` the longest
    n-gram looked up) speculates by prompt lookup.  Both need the fused
    layout and no `sampler=` / `sample=`, and exclude each other; the
    draft's vocabulary must be the target's.  `spec_min_acceptance` > 0
    stops speculating after 8 rounds under that acceptance.

    `mesh` (a parallel.mesh mesh; Llama only) serves tensor-parallel over
    its `model_axis`: every rank builds this engine from the full params
    and runs the same loop on the same requests (see the module
    docstring)."""

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
        sample: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        sampler: Optional[sampling.Sampler] = None,
        sample_seed: int = 0,
        layout: str = "fused",
        decode_steps: int = 8,
        quantized: bool = False,
        quant_dtype=torch.int8,
        prefill_chunk: Optional[int] = None,
        enable_prefix_cache: bool = False,
        lora_params: Optional[Dict[str, Any]] = None,
        model=None,
        draft_params: Optional[Dict[str, Any]] = None,
        draft_cfg=None,
        draft_model=None,
        spec_tokens: int = 0,
        spec_min_acceptance: float = 0.0,
        ngram_spec: int = 0,
        ngram_max: int = 3,
        mesh=None,
        model_axis: str = "model",
        device="cuda",
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
        if enable_prefix_cache and prefill_chunk is None:
            raise ValueError("enable_prefix_cache requires prefill_chunk")
        if sample is not None and sampler is not None:
            raise ValueError("pass either sample= or sampler=, not both")
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
        if draft_model is not None and not any(
                draft_model is m for m in MODEL_FAMILIES):
            raise NotImplementedError(
                f"ServingEngine: draft_model={draft_model!r} is not a model "
                f"family of the port; pass aule_tpu_torch.models.llama, "
                f".gpt2 or .moe")
        self.tp = self._check_mesh(cfg, mesh, model_axis)
        self.mesh, self.model_axis = mesh, model_axis
        # learned positions silently reuse the last row past n_ctx (as
        # JAX's gather clamps): refuse an engine that could decode there
        n_ctx = getattr(cfg, "n_ctx", None)
        if n_ctx is not None and max_seq_len > n_ctx:
            raise ValueError(
                f"max_seq_len {max_seq_len} exceeds the model's learned-"
                f"position table n_ctx={n_ctx}")
        self._check_speculation(cfg, layout, sample is not None
                                or sampler is not None, draft_params,
                                draft_cfg, spec_tokens, ngram_spec,
                                ngram_max)
        self.params = self._shard(params, cfg, self.model)
        self.cfg = cfg
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.max_seq_len = max_seq_len
        self.rope_cos, self.rope_sin = precompute_rope_frequencies(
            max_seq_len, cfg.head_dim, cfg.rope_base, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(sample_seed)
        # sampler= draws from self.generator; sample= is a logits -> token
        # callable; without either, each request's own options decide
        self._sampler = sampler
        self._legacy_sample = sample is not None
        self.sample = sample or (lambda logits: torch.argmax(logits, -1))
        self.prefill_chunk = prefill_chunk
        self.layout = layout
        self.lora = None
        self._lora_names: Dict[str, int] = {}
        if lora_params:
            self._register_lora(lora_params)
        # stacked pools (and scale pools); layer li is the view [li]
        pool_dtype = quant_dtype if quantized else cfg.dtype
        self.kv_pages = self.kv_scales = None
        self.k_pages = self.v_pages = self.k_scales = self.v_scales = None

        def zeros(shape, dtype):
            return torch.zeros((cfg.n_layers,) + tuple(shape), dtype=dtype,
                               device=self.device)

        # under tensor parallelism each rank's pools hold its kv heads
        hkv = cfg.n_kv_heads // self.tp
        if layout == "fused":
            self.kv_pages = zeros(fused_pool_shape(
                num_pages, hkv, page_size, cfg.head_dim), pool_dtype)
            if quantized:
                self.kv_scales = zeros(fused_scales_shape(
                    num_pages, hkv, page_size), SCALE_DTYPE)
        else:  # as aule_tpu/serving/engine.py:286-294
            shape = (hkv, num_pages, page_size, cfg.head_dim)
            self.k_pages = zeros(shape, pool_dtype)
            self.v_pages = zeros(shape, pool_dtype)
            if quantized:
                self.k_scales = zeros(shape[:-1], torch.float32)
                self.v_scales = zeros(shape[:-1], torch.float32)
        # speculative decoding (JAX engine.py:325-338, 396-455): the draft's
        # fused pool shares the target's page ids, so one allocator serves
        # both
        self.spec_tokens = int(spec_tokens)
        self.ngram_spec = int(ngram_spec)
        self.ngram_max = int(ngram_max)
        self.spec_min_acceptance = float(spec_min_acceptance)
        self._spec_disabled = False
        self.spec_rounds = self.spec_drafted = self.spec_accepted = 0
        self.dk_pages = self.dk_scales = None
        self.draft_params = self.draft_cfg = self.draft_model = None
        if self.spec_tokens > 0:
            if draft_cfg.n_kv_heads % self.tp:
                raise ValueError(
                    f"draft n_kv_heads {draft_cfg.n_kv_heads} not divisible "
                    f"by tp {self.tp}")
            # the draft shards over the target's axis (JAX l.456-471)
            self.draft_model = self.model if draft_model is None \
                else draft_model
            self.draft_params = self._shard(draft_params, draft_cfg,
                                            self.draft_model)
            self.draft_cfg = draft_cfg
            self.draft_rope_cos, self.draft_rope_sin = \
                precompute_rope_frequencies(max_seq_len, draft_cfg.head_dim,
                                            draft_cfg.rope_base,
                                            device=self.device)
            dhkv = draft_cfg.n_kv_heads // self.tp
            self.dk_pages = torch.zeros(
                (draft_cfg.n_layers,) + fused_pool_shape(
                    num_pages, dhkv, page_size, draft_cfg.head_dim),
                dtype=pool_dtype, device=self.device)
            if quantized:
                self.dk_scales = torch.zeros(
                    (draft_cfg.n_layers,) + fused_scales_shape(
                        num_pages, dhkv, page_size),
                    dtype=SCALE_DTYPE, device=self.device)
        self.allocator = make_allocator(num_pages)
        # page 0 is the scratch sink for -1 table entries (empty slots)
        scratch = self.allocator.allocate(1)
        if scratch != [0]:
            raise RuntimeError("page 0 must be the scratch page")

        self.slots: List[Optional[Request]] = [None] * max_batch
        self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self.slot_lens = np.zeros((max_batch,), np.int32)
        # how far each slot's draft pool is written: it trails slot_lens
        # after plain decode dispatches, and a round's draft prefill
        # closes the gap
        self.slot_dlens = np.zeros((max_batch,), np.int32)
        self.waiting: List[Request] = []
        self.finished: List[Request] = []
        self._next_id = 0
        self.decode_steps = max(1, int(decode_steps))
        # prefix cache (JAX engine.py:499-512): chain hash -> page, page ->
        # chain hash, page -> refcount (insertion order = eviction order)
        self.enable_prefix_cache = enable_prefix_cache
        self._prefix_cache: Dict[str, int] = {}
        self._page_hash: Dict[int, str] = {}
        self._page_rc: Dict[int, int] = {}
        self.prefix_cache_hit_tokens = 0
        self._bias_cache = None

        # observability counters (see stats())
        self.tokens_generated = 0
        self.prefill_dispatches = 0
        self.decode_dispatches = 0
        self.decode_steps_run = 0
        # the draft's prefill dispatches (whole prompts, chunks and the
        # chunks that catch a lagging draft pool up)
        self.draft_prefill_dispatches = 0
        # host seconds in prefill (the draft's included) and in decode
        # dispatches and speculative rounds; each ends in a host copy of
        # its tokens, so these include device time
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    def _check_mesh(self, cfg, mesh, model_axis) -> int:
        """The tensor-parallel degree (1 without a mesh), after JAX's
        refusals (engine.py:232-238) and the port's: a mesh axis besides
        `model_axis` larger than 1."""
        if mesh is None:
            return 1
        for name, size in zip(mesh.mesh_dim_names or (), mesh.shape):
            if name != model_axis and size != 1:
                raise ValueError(
                    f"mesh axis {name!r} has {size} ranks: tensor-parallel "
                    f"serving shards over {model_axis!r} alone (serving data "
                    f"parallelism is engine replicas)")
        tp = axis_size(mesh, model_axis)
        if cfg.n_kv_heads % tp:
            raise ValueError(f"n_kv_heads {cfg.n_kv_heads} not divisible by "
                             f"tp {tp}")
        return tp

    def _shard(self, params, cfg, family):
        """This rank's shards of a model's full params, by its family's
        shard_params (all of them without a mesh)."""
        if self.mesh is None or params is None:
            return params
        return family.shard_params(params, cfg, self.mesh, self.model_axis)

    def _mesh_kw(self) -> Dict[str, Any]:
        """The model steps' mesh arguments ({} without a mesh)."""
        if self.mesh is None:
            return {}
        return {"mesh": self.mesh, "model_axis": self.model_axis}

    def _agree(self, t: torch.Tensor) -> torch.Tensor:
        """`t` (sampled tokens, or a round's host copy) as the mesh axis'
        first rank has it, so every rank appends and emits the same."""
        if self.mesh is None:
            return t
        return broadcast(t, self.model_axis, self.mesh)

    def _check_speculation(self, cfg, layout, engine_sampler, draft_params,
                           draft_cfg, spec_tokens, ngram_spec,
                           ngram_max) -> None:
        """JAX's refusals of speculative decoding (engine.py:396-433), in
        its order."""
        if ngram_spec > 0:
            if spec_tokens > 0:
                raise ValueError(
                    "ngram_spec and spec_tokens are mutually exclusive")
            if layout != "fused":
                raise ValueError("prompt-lookup decoding requires "
                                 "layout='fused'")
            if engine_sampler:
                raise ValueError(
                    "prompt-lookup decoding is exact for greedy decoding "
                    "only; drop sampler=/sample=")
            if ngram_max < 1:
                raise ValueError("ngram_max must be >= 1")
        if spec_tokens <= 0:
            return
        if draft_params is None or draft_cfg is None:
            raise ValueError(
                "spec_tokens > 0 requires draft_params and draft_cfg")
        if layout != "fused":
            raise ValueError("speculative decoding requires layout='fused'")
        if engine_sampler:
            raise ValueError("speculative decoding is exact for greedy "
                             "decoding only; drop sampler=/sample=")
        tv = getattr(cfg, "vocab_size", None)
        dv = getattr(draft_cfg, "vocab_size", None)
        if tv is not None and dv is not None and tv != dv:
            raise ValueError(
                f"draft vocab {dv} != target vocab {tv}: speculative "
                f"decoding requires a shared tokenizer")

    def _register_lora(self, lora_params: Dict[str, Any]) -> None:
        """Stack the adapters into one bank (JAX engine.py:339-395): per
        layer and target, A [N + 1, d, r] and B [N + 1, r, o] on the
        engine's device, index 0 all zeros (the base model), an adapter
        without that target zeros too."""
        if "lora" not in inspect.signature(
                self.model.decode_step_fused).parameters:
            raise ValueError(
                "this model family does not support LoRA serving "
                "(models/llama.py does)")
        if self.mesh is not None:
            raise ValueError("multi-LoRA does not compose with "
                             "tensor-parallel serving yet")
        if self.layout != "fused":
            raise ValueError("multi-LoRA requires layout='fused'")
        names = list(lora_params)
        self._lora_names = {n: i + 1 for i, n in enumerate(names)}
        bank = []
        for li in range(self.cfg.n_layers):
            keys: set = set()
            for n in names:
                keys |= set(lora_params[n]["layers"][li])
            bad = keys - set(LORA_TARGETS)
            if bad:
                raise ValueError(
                    f"layer {li}: unsupported LoRA targets {sorted(bad)} "
                    f"(the model applies adapters to {sorted(LORA_TARGETS)} "
                    f"only; registering others would silently ignore them)")
            entry = {}
            for key in sorted(keys):
                pairs = [lora_params[n]["layers"][li].get(key) for n in names]
                ref = next(p for p in pairs if p is not None)
                ref = [_as_tensor(m, self.device) for m in ref]
                stacks = []
                for j in range(2):
                    mats = [torch.zeros_like(ref[j]) if p is None
                            else _as_tensor(p[j], self.device) for p in pairs]
                    if len({tuple(m.shape) for m in mats}) != 1:
                        raise ValueError(
                            f"layer {li} {key}: adapters disagree on LoRA "
                            f"shape; pad ranks to match before registering")
                    stacks.append(torch.stack([torch.zeros_like(mats[0])]
                                              + mats))
                entry[key] = tuple(stacks)
            bank.append(entry)
        self.lora = {"layers": bank}

    # -- public API ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
               logprobs: bool = False, stop=None,
               logit_bias: Optional[Dict[int, float]] = None,
               lora: Optional[str] = None) -> int:
        """Queue a request (JAX engine.py:545-600); returns its id."""
        prompt = np.asarray(prompt, np.int32)
        stop = [[int(t) for t in s] for s in (stop or [])]
        if any(not s for s in stop):
            raise ValueError("stop sequences must be non-empty")
        if logit_bias:
            logit_bias = {int(k): float(v) for k, v in logit_bias.items()}
            v = self.cfg.vocab_size
            if any(not 0 <= t < v for t in logit_bias):
                raise ValueError(f"logit_bias token ids must be in "
                                 f"[0, {v})")
        if lora is not None and lora not in self._lora_names:
            raise ValueError(
                f"unknown LoRA adapter {lora!r}; registered: "
                f"{sorted(self._lora_names) or 'none'}")
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
        if (temperature or top_k or top_p) and (
                self._sampler is not None or self._legacy_sample):
            raise ValueError(
                "per-request sampling params compose with the default "
                "sampler only; drop sampler=/sample= or "
                "temperature=/top_k=/top_p=")
        if temperature < 0:
            raise ValueError("temperature must be >= 0")
        if top_p and not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1] (0 disables)")
        if top_k < 0:
            raise ValueError("top_k must be >= 0 (0 disables)")
        req = Request(self._next_id, prompt, max_new_tokens, eos_id,
                      on_token=on_token, temperature=float(temperature),
                      top_k=int(top_k), top_p=float(top_p),
                      want_logprobs=bool(logprobs), stop=stop,
                      logit_bias=logit_bias or None, lora=lora)
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
            "draft_prefill_dispatches": self.draft_prefill_dispatches,
            "spec_rounds": self.spec_rounds,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_disabled": self._spec_disabled,
            "prefill_seconds": self.prefill_seconds,
            "decode_seconds": self.decode_seconds,
            "prefix_cache_pages": len(self._page_rc),
            "prefix_cache_hit_tokens": self.prefix_cache_hit_tokens,
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
        """Admit what fits, then one speculative round (draft model or
        prompt lookup) when a slot has K+1 tokens to go, else one decode
        dispatch (JAX engine.py:659-669)."""
        self._admit()
        if self.num_running:
            caps = self._spec_caps(self.spec_tokens)
            ncaps = self._spec_caps(self.ngram_spec)
            if caps is not None:
                self._spec_all(caps)
            elif ncaps is None or not self._ngram_all(ncaps):
                self._decode_all()

    # prefix cache (JAX engine.py:824-898, 1383-1396)

    def _prompt_page_hashes(self, prompt,
                            lora: Optional[str] = None) -> List[str]:
        """Chained SHA-1 hashes of the prompt's full pages, seeded by the
        adapter's name: an adapter's wk / wv deltas change the pages'
        contents for the same tokens, so its pages are never another
        adapter's or the base model's."""
        hashes = []
        prev = f"lora={lora or ''}".encode()
        for p in range(len(prompt) // self.page_size):
            chunk = np.asarray(
                prompt[p * self.page_size:(p + 1) * self.page_size],
                np.int32).tobytes()
            prev = hashlib.sha1(prev + chunk).hexdigest().encode()
            hashes.append(prev.decode())
        return hashes

    def _prefix_hits(self, prompt, lora: Optional[str] = None):
        """(cached pages, their hashes) of the longest cached prefix,
        capped so that at least one prompt token still prefills."""
        if not self.enable_prefix_cache:
            return [], []
        max_pages = (len(prompt) - 1) // self.page_size
        hit_pages, hit_hashes = [], []
        for h in self._prompt_page_hashes(prompt, lora)[:max_pages]:
            phys = self._prefix_cache.get(h)
            if phys is None:
                break
            hit_pages.append(phys)
            hit_hashes.append(h)
        return hit_pages, hit_hashes

    def _evict_for(self, shortfall: int) -> None:
        """Free cached pages nobody holds, oldest registration first, until
        `shortfall` pages came back or none is left."""
        victims = [p for p, rc in self._page_rc.items() if rc == 0]
        for phys in victims[:max(0, shortfall)]:
            del self._prefix_cache[self._page_hash.pop(phys)]
            del self._page_rc[phys]
            self.allocator.free([phys])

    def _register_prompt_pages(self, slot: int, req: Request) -> None:
        """Register the request's full prompt pages (they hold its KV now);
        a hash already cached keeps its page, and a page this slot reused
        is already registered."""
        for idx, h in enumerate(self._prompt_page_hashes(req.prompt,
                                                         req.lora)):
            phys = self.slot_pages[slot][idx]
            if h in self._prefix_cache or phys in self._page_rc:
                continue
            self._prefix_cache[h] = phys
            self._page_hash[phys] = h
            self._page_rc[phys] = 1

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.waiting:
                continue
            req = self.waiting[0]
            total = -(-(len(req.prompt) + req.max_new_tokens)
                      // self.page_size)
            hit_pages, _ = self._prefix_hits(req.prompt, req.lora)
            need = total - len(hit_pages)
            # pin the hits before evicting: eviction frees refcount-0 pages
            # oldest first, which could be the very pages reused here
            for phys in hit_pages:
                self._page_rc[phys] += 1
            if need > self.allocator.num_free:
                self._evict_for(need - self.allocator.num_free)
            if need > self.allocator.num_free:
                for phys in hit_pages:  # admission deferred: unpin
                    self._page_rc[phys] -= 1
                break  # wait for running sequences to retire
            self.waiting.pop(0)
            pages = hit_pages + self.allocator.allocate(need)
            if 0 in pages:
                raise RuntimeError("scratch page 0 was handed out")
            self.slots[slot] = req
            self.slot_pages[slot] = pages
            self.slot_lens[slot] = 0
            self._run_prefill(slot, req,
                              hit_len=len(hit_pages) * self.page_size)

    def _block_table(self) -> torch.Tensor:
        bt = np.full((self.max_batch, self.max_pages_per_seq), -1, np.int32)
        for s, pages in enumerate(self.slot_pages):
            bt[s, :len(pages)] = pages
        return torch.from_numpy(bt).to(self.device)

    # LoRA rows (JAX engine.py:1440-1457, 1477-1479)

    def _lora_row(self) -> Optional[torch.Tensor]:
        """[B] bank indices of the running requests (0 = base), or None
        when none runs on an adapter: then no gather and no low-rank
        product runs."""
        if self.lora is None or not any(
                r is not None and r.lora for r in self.slots):
            return None
        return torch.tensor([
            self._lora_names[r.lora] if r is not None and r.lora else 0
            for r in self.slots], dtype=torch.int64, device=self.device)

    def _lora_idx_for(self, req: Request) -> Optional[torch.Tensor]:
        """[1] bank index of one request's prefill, or None on the base
        model."""
        if self.lora is None or not req.lora:
            return None
        return torch.tensor([self._lora_names[req.lora]], dtype=torch.int64,
                            device=self.device)

    def _lora_kw(self, lidx: Optional[torch.Tensor]) -> Dict[str, Any]:
        return ({} if self.lora is None or lidx is None
                else {"lora": self.lora, "lora_idx": lidx})

    def _side(self, draft: bool):
        """(model, params, cfg, rope cos, rope sin, fused pool, its scales)
        of the target or of the draft."""
        if draft:
            return (self.draft_model, self.draft_params, self.draft_cfg,
                    self.draft_rope_cos, self.draft_rope_sin, self.dk_pages,
                    self.dk_scales)
        return (self.model, self.params, self.cfg, self.rope_cos,
                self.rope_sin, self.kv_pages, self.kv_scales)

    def _prefill(self, tokens: torch.Tensor, bt_row: torch.Tensor,
                 lidx: Optional[torch.Tensor], draft: bool = False):
        """Forward over one prompt [1, n] and write its K/V into the pages
        of `bt_row` (quantized when the pools are, as the JAX engine,
        engine.py:906-945; the draft's into its own pool, :995-1018);
        returns the logits of the last prompt position."""
        n = tokens.shape[1]
        model, params, cfg, cos, sin, pool, scales = self._side(draft)
        logits, kv = model.forward(params, tokens, cfg, rope_cos=cos,
                                   rope_sin=sin, return_kv=True,
                                   **self._mesh_kw(), **self._lora_kw(lidx))
        where = (bt_row[None],
                 torch.zeros((1,), dtype=torch.int32, device=self.device),
                 torch.full((1,), n, dtype=torch.int32, device=self.device))
        for li, (k, v) in enumerate(kv):
            if self.layout == "fused":
                kv_cache_append_prefill_fused(
                    pool[li], k, v, *where,
                    kv_scales=None if scales is None else scales[li])
            elif self.k_scales is not None:
                kv_cache_append_prefill_quantized(
                    self.k_pages[li], self.v_pages[li], self.k_scales[li],
                    self.v_scales[li], k, v, *where)
            else:
                kv_cache_append_prefill(self.k_pages[li], self.v_pages[li],
                                        k, v, *where)
        self._count_prefill(draft)
        return logits[0, n - 1]

    def _count_prefill(self, draft: bool) -> None:
        if draft:
            self.draft_prefill_dispatches += 1
        else:
            self.prefill_dispatches += 1

    def _prefill_chunk(self, chunk: torch.Tensor, off: int,
                       bt_row: torch.Tensor, lidx: Optional[torch.Tensor],
                       draft: bool = False) -> torch.Tensor:
        """One chunk [1, c] at offset `off` through the target's or the
        draft's `prefill_step_fused`; returns its last row's logits [1,
        V]."""
        model, params, cfg, cos, sin, pool, scales = self._side(draft)
        out = model.prefill_step_fused(
            params, chunk,
            torch.full((1,), off, dtype=torch.int32, device=self.device),
            torch.full((1,), chunk.shape[1], dtype=torch.int32,
                       device=self.device),
            pool, bt_row[None], cfg, cos, sin, scales, **self._mesh_kw(),
            **self._lora_kw(lidx))
        self._count_prefill(draft)
        return out[0]

    def _prefill_chunked(self, tokens: torch.Tensor, bt_row: torch.Tensor,
                         start: int, lidx: Optional[torch.Tensor],
                         draft: bool = False):
        """Chunks of `prefill_chunk` tokens at offsets start, start + c,
        ... through `model.prefill_step_fused` (engine.py:1329-1381); each
        chunk appends its K/V and attends to everything before it, the
        cached prefix's pages included.  Returns the logits of the last
        prompt position."""
        n, c = tokens.shape[1], self.prefill_chunk
        logits = None
        for off in range(start, n, c):
            logits = self._prefill_chunk(tokens[:, off:off + c], off, bt_row,
                                         lidx, draft)
        return logits[0]

    def _run_prefill(self, slot: int, req: Request, hit_len: int = 0) -> None:
        t0 = time.perf_counter()
        n = len(req.prompt)
        tokens = torch.from_numpy(req.prompt.astype(np.int64))[None].to(
            self.device)
        bt = np.full((self.max_pages_per_seq,), -1, np.int32)
        pages = self.slot_pages[slot]
        bt[:len(pages)] = pages
        bt_row = torch.from_numpy(bt).to(self.device)
        lidx = self._lora_idx_for(req)
        if self.prefill_chunk is not None:
            # cached prefix pages hold their KV already: start at hit_len
            self.prefix_cache_hit_tokens += hit_len
            logits = self._prefill_chunked(tokens, bt_row, hit_len, lidx)
        else:  # the cache requires chunked prefill, so nothing was hit
            logits = self._prefill(tokens, bt_row, lidx)
        self.slot_lens[slot] = n
        if self.spec_tokens > 0:
            # the draft's pool holds the prompt too (JAX engine.py:1352-1368,
            # 1421-1429); a cached page was written by a speculative request,
            # so it holds the draft's KV as well and the draft starts at the
            # same hit
            if self.prefill_chunk is not None:
                self._prefill_chunked(tokens, bt_row, hit_len, None, True)
            else:
                self._prefill(tokens, bt_row, None, True)
            self.slot_dlens[slot] = n
        tok, logp = self._host_sample(logits, req)
        self.prefill_seconds += time.perf_counter() - t0
        self.tokens_generated += 1
        req._emit(tok, logp)
        if self.slots[slot] is not req:
            return  # cancel() from the callback already retired it
        if self.enable_prefix_cache:
            self._register_prompt_pages(slot, req)
        if req.done:
            self._retire(slot)

    # sampling (JAX engine.py:1481-1566)

    def _bias_vector(self, bias: Dict[int, float]) -> torch.Tensor:
        vec = torch.zeros((self.cfg.vocab_size,), dtype=torch.float32)
        vec[list(bias)] = torch.tensor(list(bias.values()),
                                       dtype=torch.float32)
        return vec.to(self.device)

    def _bias_matrix(self) -> Optional[torch.Tensor]:
        """[B, V] additive logit bias, or None when no running request has
        one (then no add runs).  Rebuilt only when the (slot, request)
        assignment changes: a request's bias never does."""
        key = tuple((s, r.req_id) for s, r in enumerate(self.slots)
                    if r is not None and r.logit_bias)
        if not key:
            return None
        if self._bias_cache is not None and self._bias_cache[0] == key:
            return self._bias_cache[1]
        mat = torch.zeros((self.max_batch, self.cfg.vocab_size),
                          dtype=torch.float32)
        for s, r in enumerate(self.slots):
            if r is not None and r.logit_bias:
                mat[s, list(r.logit_bias)] = torch.tensor(
                    list(r.logit_bias.values()), dtype=torch.float32)
        mat = mat.to(self.device)
        self._bias_cache = (key, mat)
        return mat

    def _sample_dev(self, logits: torch.Tensor, temps, tks, tps,
                    bias) -> torch.Tensor:
        """The next tokens of a decode step on the device: the bias added
        (when some row has one), then the engine's `sampler=`, or each
        row's temperature and top-k / top-p (temps None: every row is
        greedy, tks / tps None: no row restricts), or `sample=` / the
        argmax."""
        if bias is not None:
            logits = logits.float() + bias
        if self._sampler is not None:
            return self._sampler(logits, self.generator)
        if temps is not None and not self._legacy_sample:
            return sampling.sample_rows(logits, temps, self.generator, tks,
                                        tps)
        return self.sample(logits)

    def _host_sample(self, logits: torch.Tensor, req: Request):
        """The first token of a request from its prefill's last logits [V]
        and, when it wants logprobs, the raw logits' logprob of it."""
        raw = logits
        if req.logit_bias:
            logits = logits.float() + self._bias_vector(req.logit_bias)
        if self._sampler is not None:
            tok = self._sampler(logits, self.generator)
        elif req.temperature > 0.0 and not self._legacy_sample:
            dev = logits.device
            tok = sampling.sample_rows(
                logits[None], torch.tensor([req.temperature], device=dev),
                self.generator,
                torch.tensor([req.top_k], device=dev) if req.top_k else None,
                torch.tensor([req.top_p], device=dev) if req.top_p
                else None)[0]
        else:
            tok = self.sample(logits)
        if self.mesh is not None:
            tok = self._agree(torch.as_tensor(tok).reshape(1).long())[0]
        tok = int(tok)
        logp = None
        if req.want_logprobs:
            logp = float(_chosen_logprob(raw[None], torch.tensor([tok]))[0])
        return tok, logp

    def _decode_all(self) -> None:
        t0 = time.perf_counter()
        tokens = np.zeros((self.max_batch,), np.int64)
        remaining = []
        running = [r for r in self.slots if r is not None]
        for s, req in enumerate(self.slots):
            if req is not None:
                tokens[s] = req.output[-1]
                remaining.append(req.max_new_tokens - len(req.output))
        temps = tks = tps = None
        if any(r.temperature > 0.0 for r in running):
            def row(field, dtype):
                return torch.tensor([getattr(r, field) if r is not None
                                     else 0 for r in self.slots],
                                    dtype=dtype, device=self.device)

            temps = row("temperature", torch.float32)
            # the vocabulary sort only while a sampled request restricts
            sampled = [r for r in running if r.temperature > 0.0]
            if any(r.top_k for r in sampled):
                tks = row("top_k", torch.int64)
            if any(r.top_p for r in sampled):
                tps = row("top_p", torch.float32)
        want_lp = any(r.want_logprobs for r in running)
        bias = self._bias_matrix()
        lkw = self._lora_kw(self._lora_row())
        k = self.decode_steps
        n_steps = (k if k > 1 and not self.waiting and remaining
                   and min(remaining) >= k else 1)
        tok = torch.from_numpy(tokens).to(self.device)
        lens = torch.from_numpy(self.slot_lens.copy()).to(self.device)
        bt = self._block_table()
        steps, lps = [], []
        for _ in range(n_steps):
            # positions are the lengths before this token
            if self.layout == "fused":
                logits, _, new_lens, *_ = self.model.decode_step_fused(
                    self.params, tok, lens, self.kv_pages, bt, lens,
                    self.cfg, self.rope_cos, self.rope_sin, self.kv_scales,
                    **self._mesh_kw(), **lkw)
            else:
                logits, _, _, new_lens, *_ = self.model.decode_step(
                    self.params, tok, lens, self.k_pages, self.v_pages, bt,
                    lens, self.cfg, self.rope_cos, self.rope_sin,
                    self.k_scales, self.v_scales, **self._mesh_kw())
            tok = self._agree(
                self._sample_dev(logits, temps, tks, tps, bias).long())
            steps.append(tok)
            if want_lp:
                lps.append(_chosen_logprob(logits, tok))
            lens = new_lens
        # one host copy: the tokens, and the logprobs beside them (f64
        # holds every token id and every f32 logprob exactly)
        if want_lp:
            both = torch.stack([torch.stack(steps).double(),
                                torch.stack(lps).double()]).cpu().numpy()
            next_np = both[0].astype(np.int64)
            logp_np = both[1].astype(np.float32)
        else:
            next_np = torch.stack(steps).cpu().numpy()
            logp_np = None
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
                req._emit(int(next_np[step, s]),
                          None if logp_np is None else logp_np[step, s])
                if self.slots[s] is not req:
                    break  # cancel() from the on_token callback retired it
                if req.done:
                    # eos or stop overshoot: the pages hold a few tokens
                    # past it, but the request retires and frees them
                    self._retire(s)
                    break

    # speculative decoding (JAX engine.py:671-822, 1039-1327)

    def _spec_caps(self, k: int) -> Optional[np.ndarray]:
        """Each slot's verify length for a round of K = k candidates, or
        None when no round runs (k 0, speculation turned off, or no slot
        with K+1 tokens to go).  A slot whose budget cannot take the
        round's K+1 appends verifies only its pending token (cap 1), so
        one short request does not stop the batch's speculation."""
        if k <= 0 or self._spec_disabled:
            return None
        caps = np.ones((self.max_batch,), np.int32)
        for s, req in enumerate(self.slots):
            if req is not None and req.max_new_tokens - len(req.output) > k:
                caps[s] = k + 1
        return caps if (caps > 1).any() else None

    def _spec_sampling_args(self):
        """(temps, tks, tps) of a round on the device, or Nones when every
        running request is greedy: then the round draws no random number
        and sorts no vocabulary (tks / tps only while a sampled request
        restricts)."""
        sampled = [r for r in self.slots if r is not None
                   and r.temperature > 0.0]
        if not sampled:
            return None, None, None

        def row(field, dtype):
            return torch.tensor([getattr(r, field) if r is not None else 0
                                 for r in self.slots], dtype=dtype,
                                device=self.device)

        return (row("temperature", torch.float32),
                row("top_k", torch.int64) if any(r.top_k for r in sampled)
                else None,
                row("top_p", torch.float32) if any(r.top_p for r in sampled)
                else None)

    def _warp(self, logits: torch.Tensor, temps, tks, tps) -> torch.Tensor:
        """Logits [..., V] scaled by each row's temperature (1 for greedy
        rows) and cut to its top-k / top-p: the distribution a sampled
        row draws from, as plain decode's sampling warps it."""
        t_eff = torch.where(temps > 0.0, temps, torch.ones_like(temps))
        shape = logits.shape
        scaled = logits.float().reshape(shape[0], -1, shape[-1]) \
            / t_eff[:, None, None]
        if tks is not None or tps is not None:
            n = scaled.shape[1]

            def rep(x):
                return None if x is None else x.repeat_interleave(n)

            scaled = sampling.restrict_rows(
                scaled.reshape(-1, shape[-1]), rep(tks), rep(tps))
        return scaled.reshape(shape)

    def _propose(self, logits: torch.Tensor, temps, tks, tps):
        """A draft proposal from logits [B, V]: the argmax of greedy rows,
        a draw from the warped draft distribution for sampled rows, and
        that distribution (None when every row is greedy)."""
        amax = torch.argmax(logits, dim=-1)
        if temps is None:
            return amax, None
        scaled = self._warp(logits, temps, tks, tps)
        drawn = sampling._gumbel_argmax(scaled, self.generator)
        return (torch.where(temps > 0.0, drawn, amax),
                torch.softmax(scaled, dim=-1))

    def _spec_all(self, caps: np.ndarray) -> None:
        """One draft-model round (JAX engine.py:715-774): catch a lagging
        draft pool up, run the round, commit each slot's tokens."""
        t0 = time.perf_counter()
        k = self.spec_tokens
        seqs = {s: np.concatenate([r.prompt, np.asarray(r.output, np.int32)])
                for s, r in enumerate(self.slots) if r is not None}
        # after plain decode dispatches the draft pool may trail the
        # committed tokens by more than a round's catch-up: replay the gap
        # in draft-only chunks of K+1
        for s, seq in seqs.items():
            if self.slot_lens[s] + 1 - self.slot_dlens[s] <= k + 1:
                continue
            bt_row = self._block_table()[s]
            while self.slot_lens[s] + 1 - self.slot_dlens[s] > k + 1:
                lo = int(self.slot_dlens[s])
                self._prefill_chunk(
                    self._device_row(seq[lo:lo + k + 1][None], torch.int64),
                    lo, bt_row, None, draft=True)
                self.slot_dlens[s] = lo + k + 1
        catchup = np.zeros((self.max_batch, k + 1), np.int64)
        clen = np.zeros((self.max_batch,), np.int32)
        for s, seq in seqs.items():
            lo, hi = int(self.slot_dlens[s]), int(self.slot_lens[s]) + 1
            catchup[s, :hi - lo] = seq[lo:hi]
            clen[s] = hi - lo
        a, lp, n_emit, m = self._spec_round(catchup, clen, caps)
        self.decode_seconds += time.perf_counter() - t0
        # cap-1 slots emit one token and draft nothing
        for s, (lens_old, _, m_s, retired) in self._commit_round(
                a, lp, n_emit, m, k, counted=caps > 1).items():
            if not retired:
                # the draft pool holds t and the accepted g_0 ..
                # g_{min(m, K-1) - 1} (its decode steps append K-1 of the K
                # candidates); a cap-1 slot verified t alone
                self.slot_dlens[s] = lens_old + 1 + min(m_s, k - 1,
                                                        int(caps[s]) - 1)

    def _device_row(self, a: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        """A host array on the engine's device (lengths int32, tokens
        int64)."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype)

    def _spec_round(self, catchup: np.ndarray, clen: np.ndarray,
                    caps: np.ndarray):
        """One round for the whole batch on the device (JAX
        engine.py:1039-1144).  catchup [B, K+1] holds each slot's committed
        tokens at positions slot_dlens .. slot_lens, the last one the
        pending token t (emitted, in no pool yet): the draft appends them
        in one chunked prefill and its last row proposes g0, then K-1
        draft decode steps propose g1 .. g{K-1}; the target verifies [t,
        g0 .. g{K-1}] in one chunked prefill (_verify_chunk).  Returns the
        host arrays (a, lp, n_emit, m) of _verify_chunk."""
        k = self.spec_tokens
        model, params, cfg, cos, sin, pool, scales = self._side(True)
        temps, tks, tps = self._spec_sampling_args()
        bt = self._block_table()
        lens = self._device_row(self.slot_lens)
        clen_t = self._device_row(clen)
        catch_t = self._device_row(catchup, torch.int64)
        dlogits = model.prefill_step_fused(
            params, catch_t, self._device_row(self.slot_dlens), clen_t, pool,
            bt, cfg, cos, sin, scales, **self._mesh_kw())[0]
        tok, q0 = self._propose(dlogits, temps, tks, tps)
        tok = self._agree(tok)
        props, dists = [tok], [q0]
        for i in range(k - 1):
            # the draft pool holds the committed tokens through t at lens
            pos = lens + 1 + i
            logits = model.decode_step_fused(params, tok, pos, pool, bt, pos,
                                             cfg, cos, sin, scales,
                                             **self._mesh_kw())[0]
            tok, qn = self._propose(logits, temps, tks, tps)
            tok = self._agree(tok)
            props.append(tok)
            dists.append(qn)
        g = torch.stack(props, dim=1)
        q = None if temps is None else torch.stack(dists, dim=1)
        t = catch_t.gather(1, (clen_t.long() - 1).clamp(min=0)[:, None])
        return self._verify_chunk(torch.cat([t, g], dim=1), q, caps, bt,
                                  lens, temps, tks, tps)

    def _verify_chunk(self, chunk: torch.Tensor, q: Optional[torch.Tensor],
                      caps: np.ndarray, bt: torch.Tensor, lens: torch.Tensor,
                      temps, tks, tps):
        """The target's verify, shared by both kinds of speculation (JAX
        engine.py:1146-1251): ONE chunked prefill over chunk = [t, g_0 ..
        g_{K-1}] [B, K+1] with every position's logits, then per slot:

          greedy: a_i = the biased argmax (what plain decode emits), m =
            the longest prefix with a_i == g_i; n_emit = m + 1;
          sampled: rejection sampling against the warped target
            distribution p_i (bias, temperature, top-k / top-p): accept
            g_i when u * q_i(g_i) < p_i(g_i), draw the first rejected
            position from the residual (p_i - q_i)^+, or from p_i with
            g_i zeroed when the proposals are prompt lookup's (q None: a
            one-hot q), or the bonus from p_K when all K are accepted.

        A slot verifies min(caps, K+1) positions (0 when empty); n_emit =
        min(m + 1, caps), so rows past a slot's verify length (the
        kernel's rows past the context) never decide.  Logprobs are the
        raw model's.  Returns the host arrays a [B, K+1], lp [B, K+1] or
        None, n_emit [B] and m = n_emit - 1 [B], copied in ONE transfer."""
        k = chunk.shape[1] - 1
        active = np.array([r is not None for r in self.slots])
        vlen = np.where(active, np.minimum(caps, k + 1), 0)
        lidx = self._lora_row()
        out = self.model.prefill_step_fused(
            self.params, chunk, lens, self._device_row(vlen), self.kv_pages,
            bt, self.cfg, self.rope_cos, self.rope_sin, self.kv_scales,
            all_logits=True, **self._mesh_kw(), **self._lora_kw(lidx))
        logits = out[0]                                    # [B, K+1, V]
        bias = self._bias_matrix()
        biased = logits if bias is None else logits + bias[:, None, :]
        arg = torch.argmax(biased, dim=-1)                 # [B, K+1]
        g = chunk[:, 1:]
        if temps is None:
            a = arg
            m = torch.cumprod((arg[:, :k] == g).long(), dim=1).sum(dim=1)
        else:
            b, v = biased.shape[0], biased.shape[-1]
            p = torch.softmax(self._warp(biased, temps, tks, tps), dim=-1)
            p_at_g = p[:, :k].gather(-1, g[..., None])[..., 0]
            if q is None:  # deterministic proposals: q_i = one-hot(g_i)
                q_at_g = torch.ones_like(p_at_g)
                residual = p[:, :k].scatter(-1, g[..., None], 0.0)
            else:
                q_at_g = q.gather(-1, g[..., None])[..., 0]
                residual = (p[:, :k] - q).clamp(min=0.0)
            u = torch.rand((b, k), generator=self.generator,
                           device=self.device)
            acc = torch.where((temps <= 0.0)[:, None], arg[:, :k] == g,
                              u * q_at_g < p_at_g)
            m = torch.cumprod(acc.long(), dim=1).sum(dim=1)  # [B] in 0..K
            mk = m.clamp(max=k)[:, None]
            res_m = residual.gather(1, m.clamp(max=k - 1)[:, None, None]
                                    .expand(b, 1, v))[:, 0]
            rs = res_m.sum(dim=-1, keepdim=True)
            p_m = p.gather(1, mk[..., None].expand(b, 1, v))[:, 0]
            # rs ~ 0 only where p == q at the rejection, whose acceptance
            # was 1: fall back to p_m there
            final = torch.where(m[:, None] >= k, p_m,
                                torch.where(rs > 1e-12, res_m / rs, p_m))
            drawn = sampling._gumbel_argmax(torch.log(final), self.generator)
            final_tok = torch.where(temps > 0.0, drawn,
                                    arg.gather(1, mk)[:, 0])
            a = torch.cat([g, torch.zeros_like(g[:, :1])], dim=1)
            a = a.scatter(1, mk, final_tok[:, None])
        n_emit = torch.minimum(m + 1, self._device_row(caps, torch.int64))
        parts = [a.double().flatten(), n_emit.double()]
        if any(r is not None and r.want_logprobs for r in self.slots):
            parts.append(_chosen_logprob(logits.reshape(-1, logits.shape[-1]),
                                         a.flatten()).double())
        # one host copy: f64 holds every token id, count and f32 logprob
        host = self._agree(torch.cat(parts)).cpu().numpy()
        nb = a.numel()
        a_np = host[:nb].astype(np.int64).reshape(a.shape)
        n_np = host[nb:nb + len(caps)].astype(np.int64)
        lp_np = (host[nb + len(caps):].astype(np.float32).reshape(a.shape)
                 if len(parts) > 2 else None)
        return a_np, lp_np, n_np, n_np - 1

    def _commit_round(self, a, lp, n_emit, m, k, counted=None):
        """A round's commit for both kinds of speculation (JAX
        engine.py:776-822): each slot emits its n_emit tokens (cut at a
        stop, eos or cancel as multi-step decode is; pages past them are
        hidden by the length and overwritten), its length moves on, the
        acceptance counters take the `counted` slots' K and m, and after
        SPEC_DISABLE_ROUNDS rounds under spec_min_acceptance speculation
        stops for good.  Returns {slot: (old length, emitted, m,
        retired)}."""
        self.spec_rounds += 1
        info = {}
        for s, req in enumerate(self.slots):
            if req is None:
                continue
            lens_old = int(self.slot_lens[s])
            if counted is None or counted[s]:
                self.spec_drafted += k
                self.spec_accepted += int(m[s])
            emitted = 0
            for j in range(int(n_emit[s])):
                self.tokens_generated += 1
                req._emit(int(a[s, j]), None if lp is None else lp[s, j])
                emitted += 1
                if self.slots[s] is not req or req.done:
                    break  # cancel() from the callback, or finished
            retired = self.slots[s] is not req
            if not retired and req.done:
                self._retire(s)
                retired = True
            if not retired:
                self.slot_lens[s] = lens_old + emitted
            info[s] = (lens_old, emitted, int(m[s]), retired)
        rate = self.spec_accepted / max(self.spec_drafted, 1)
        if (self.spec_min_acceptance > 0.0
                and self.spec_rounds >= SPEC_DISABLE_ROUNDS
                and rate < self.spec_min_acceptance):
            self._spec_disabled = True
            logger.info("speculation disabled: acceptance %.3f < %.3f after "
                        "%d rounds", rate, self.spec_min_acceptance,
                        self.spec_rounds)
        return info

    def _ngram_propose(self, seq: np.ndarray) -> Optional[np.ndarray]:
        """Prompt lookup (JAX engine.py:1264-1286): the trailing n-gram
        of the context (n = ngram_max .. 1, longest first) matched against
        earlier context, the latest occurrence winning; returns the K
        tokens after it (padded by repeating its last token when the match
        sits near the end), or None when nothing matches."""
        from numpy.lib.stride_tricks import sliding_window_view

        k, n_seq = self.ngram_spec, seq.size
        for n in range(min(self.ngram_max, n_seq - 1), 0, -1):
            tail = seq[n_seq - n:]
            wins = sliding_window_view(seq, n)[:n_seq - n]  # not the tail
            hits = np.flatnonzero((wins == tail).all(axis=1))
            if hits.size == 0:
                continue
            i = int(hits[-1])
            cont = seq[i + n:i + n + k]
            if cont.size < k:
                cont = np.concatenate(
                    [cont, np.full(k - cont.size, cont[-1], seq.dtype)])
            return cont
        return None

    def _ngram_all(self, caps: np.ndarray) -> bool:
        """One prompt-lookup round (JAX engine.py:1288-1327); False (and
        nothing done) when no slot has a candidate.  A slot without one
        verifies only its pending token and is not counted."""
        t0 = time.perf_counter()
        k = self.ngram_spec
        g = np.zeros((self.max_batch, k), np.int64)
        t = np.zeros((self.max_batch, 1), np.int64)
        counted = np.zeros((self.max_batch,), bool)
        for s, req in enumerate(self.slots):
            if req is None:
                continue
            seq = np.concatenate([req.prompt,
                                  np.asarray(req.output, np.int32)])
            t[s] = seq[-1]
            prop = self._ngram_propose(seq)
            if prop is not None and caps[s] > 1:
                g[s] = prop
                counted[s] = True
        if not counted.any():
            return False
        caps = np.where(counted, caps, 1).astype(np.int32)
        temps, tks, tps = self._spec_sampling_args()
        a, lp, n_emit, m = self._verify_chunk(
            self._device_row(np.concatenate([t, g], axis=1), torch.int64),
            None, caps,
            self._block_table(), self._device_row(self.slot_lens), temps,
            tks, tps)
        self.decode_seconds += time.perf_counter() - t0
        self._commit_round(a, lp, n_emit, m, k, counted=counted)
        return True

    def _retire(self, slot: int) -> None:
        """Finish the slot's request: cached pages drop a reference and
        stay resident until evicted, private pages are freed."""
        self.finished.append(self.slots[slot])
        private = []
        for phys in self.slot_pages[slot]:
            if phys in self._page_rc:
                self._page_rc[phys] -= 1
            else:
                private.append(phys)
        self.allocator.free(private)
        self.slots[slot] = None
        self.slot_pages[slot] = []
        self.slot_lens[slot] = 0
        self.slot_dlens[slot] = 0


# -- checkpoint / resume (JAX engine.py:1726-1855) ---------------------------


def _pools_tree(eng: ServingEngine, leaf=None) -> Dict[str, Any]:
    """The engine's pools under the JAX engine's keys: the fused pool and
    its packed scales are JAX's `k_pages` and `k_scales` (its `v_pages`
    and `v_scales` are None then), the draft's fused pool and scales its
    `dk_pages` and `dk_scales` (None without a draft model).  With `leaf`,
    every pool is replaced by it (a template for load_pytree)."""
    if eng.layout == "fused":
        tree = {"k_pages": eng.kv_pages, "v_pages": None,
                "k_scales": eng.kv_scales, "v_scales": None}
    else:
        tree = {"k_pages": eng.k_pages, "v_pages": eng.v_pages,
                "k_scales": eng.k_scales, "v_scales": eng.v_scales}
    tree.update(dk_pages=eng.dk_pages, dk_scales=eng.dk_scales)
    if leaf is not None:
        tree = {k: None if v is None else leaf for k, v in tree.items()}
    return tree


def _refuse_mesh(eng: ServingEngine) -> None:
    if eng.mesh is not None:
        raise NotImplementedError(
            "checkpointing a tensor-parallel engine is not ported: its pools "
            "are per-rank shards")


def save_engine_state(eng: ServingEngine, path: str) -> None:
    """Persist the pools and the request, slot and prefix-cache
    bookkeeping to `<path>.pools.npz` / `.pools.tree.json` / `.state.json`,
    the JAX engine's files; params and adapters are not saved
    (utils.checkpoint.save_pytree them separately).  Speculative decoding
    writes the draft's pool, each slot's draft length and the acceptance
    counters under JAX's keys (JAX saves no round count: a resumed engine
    of either package counts rounds from 0).  The sampler's
    state is a torch.Generator's, under a key of the port's own
    (`torch_generator_state`): JAX's `rng_key` cannot be derived from it,
    so a JAX engine resumes the port's sampled requests from its own
    seed."""
    _refuse_mesh(eng)
    save_pytree(path + ".pools", _pools_tree(eng))

    def req(r: Optional[Request]):
        return None if r is None else dict(
            req_id=r.req_id, prompt=np.asarray(r.prompt).tolist(),
            max_new_tokens=r.max_new_tokens, eos_id=r.eos_id,
            output=list(r.output), temperature=r.temperature,
            top_k=r.top_k, top_p=r.top_p, cancelled=r.cancelled,
            want_logprobs=r.want_logprobs, logprobs=list(r.logprobs),
            stop=[list(s) for s in r.stop], logit_bias=r.logit_bias,
            lora=r.lora)

    host = {
        "slots": [req(r) for r in eng.slots],
        "slot_pages": [list(p) for p in eng.slot_pages],
        "slot_lens": eng.slot_lens.tolist(),
        "waiting": [req(r) for r in eng.waiting],
        "finished": [req(r) for r in eng.finished],
        "next_id": eng._next_id,
        # without the cache's maps a resumed engine would free a page
        # another slot still reads
        "prefix_cache": dict(eng._prefix_cache),
        "page_rc": {str(k): v for k, v in eng._page_rc.items()},
        "prefix_hit_tokens": eng.prefix_cache_hit_tokens,
        "free_pages": eng.allocator.free_list(),
        "slot_dlens": eng.slot_dlens.tolist(),
        "spec_drafted": eng.spec_drafted,
        "spec_accepted": eng.spec_accepted,
        "spec_disabled": eng._spec_disabled,
        "torch_generator_state": eng.generator.get_state().tolist(),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path + ".state.json", "w") as f:
        json.dump(host, f)


def load_engine_state(eng: ServingEngine, path: str) -> None:
    """Restore state saved by save_engine_state, of either package, into
    a freshly constructed engine of the same configuration (pools of the
    same layout, shapes and dtypes, written in place; the same adapters
    registered, the same draft model).  A request on an adapter the engine
    lacks raises ValueError, as JAX's, and so does a draft pool's state
    for an engine without a draft model.  A JAX file carries no
    torch.Generator state: the engine keeps its own, so greedy requests
    resume exactly."""
    _refuse_mesh(eng)
    with open(path + ".state.json") as f:
        host = json.load(f)
    if any(host.get("slot_dlens", [])) and eng.dk_pages is None:
        raise ValueError("the file holds a draft pool's state and the "
                         "engine has no draft model (spec_tokens=0)")
    if len(host["slots"]) != eng.max_batch:
        raise ValueError(f"the file has {len(host['slots'])} batch slots, "
                         f"the engine {eng.max_batch}")

    def req(d) -> Optional[Request]:
        if d is None:
            return None
        r = Request(d["req_id"], np.asarray(d["prompt"], np.int32),
                    d["max_new_tokens"], d["eos_id"],
                    temperature=float(d.get("temperature", 0.0)),
                    top_k=int(d.get("top_k", 0)),
                    top_p=float(d.get("top_p", 0.0)),
                    cancelled=bool(d.get("cancelled", False)),
                    want_logprobs=bool(d.get("want_logprobs", False)),
                    stop=[[int(t) for t in s] for s in d.get("stop", [])],
                    logit_bias=({int(k): float(v) for k, v in
                                 d["logit_bias"].items()}
                                if d.get("logit_bias") else None),
                    lora=d.get("lora"))
        if r.lora is not None and r.lora not in eng._lora_names:
            raise ValueError(
                f"checkpointed request {r.req_id} uses LoRA adapter "
                f"{r.lora!r} but the engine has "
                f"{sorted(eng._lora_names) or 'no adapters'} registered; "
                f"resuming would decode on the wrong weights")
        r.output.extend(int(t) for t in d["output"])
        r.logprobs.extend(float(x) for x in d.get("logprobs", []))
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
    eng._prefix_cache = {str(h): int(p) for h, p in
                         host.get("prefix_cache", {}).items()}
    eng._page_hash = {p: h for h, p in eng._prefix_cache.items()}
    eng._page_rc = {int(p): int(rc) for p, rc in
                    host.get("page_rc", {}).items()}
    eng.prefix_cache_hit_tokens = int(host.get("prefix_hit_tokens", 0))
    eng._bias_cache = None
    eng.allocator.set_free_list([int(p) for p in host["free_pages"]])
    eng.slot_dlens = np.asarray(host.get("slot_dlens",
                                         [0] * eng.max_batch), np.int32)
    eng.spec_drafted = int(host.get("spec_drafted", 0))
    eng.spec_accepted = int(host.get("spec_accepted", 0))
    eng._spec_disabled = bool(host.get("spec_disabled", False))
    if "torch_generator_state" in host:
        eng.generator.set_state(torch.tensor(host["torch_generator_state"],
                                             dtype=torch.uint8))
