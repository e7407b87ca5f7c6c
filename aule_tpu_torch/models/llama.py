"""Llama-style decoder (counterpart of aule_tpu/models/llama.py:42-603).

Parameters are a plain dict with the JAX package's keys and its `[in, out]`
weight orientation (`x @ w`), so JAX params cross over as a plain copy
(`load_jax_params`).  Dtype placement follows the JAX model exactly: norm
weights are f32 and `rms_norm` computes in f32 and casts back; the SiLU
gate is computed in f32; logits are f32.

  * `forward` is the prefill and training path: attention through the
    port's differentiable flash attention (`ops.flash_vjp`: the forward
    and backward CUDA kernels on the card, their plain versions on the
    CPU; with grad off, the forward kernel alone without its LSE write).
  * `loss_fn` is the mean next-token NLL and `train_step` one SGD step,
    as JAX's (l.367-384).
  * `decode_step_fused` is one decode step over the fused paged pools:
    append (in place) then paged attention (the paged-decode kernel), and
    `decode_step` the same over split (head-major) K and V pools (the
    kernel's split-pool instantiation);
  * `prefill_step_fused` is one chunk of chunked prefill: append the chunk
    (in place) then attend over history plus chunk (the paged-prefill
    kernel).
  All three quantize what they append when scale pools are passed, and take
  the paged attention function as an argument (default: the kernel's
  wrapper), as `forward` takes `attention`.
  `forward`, `decode_step_fused` and `prefill_step_fused` take multi-LoRA
  adapters (`lora=`, a stacked bank, and `lora_idx=`, each row's adapter;
  `_lora_proj`); the split-pool `decode_step` has none, as JAX's.

Tensor parallelism (`mesh=`, JAX l.86-102, 154-170, 282-330, 407-460,
522-560): `param_specs` shards wq, wk, wv, w_gate and w_up by columns, wo
and w_down by rows and lm_head by vocabulary; `shard_params` cuts this
rank's shards from the full params.  Under a mesh each step takes those
shards and pools of the rank's kv heads, attends locally over its heads
(GQA groups co-located), joins the ranks by one all-reduce after wo and
one after w_down (parallel/collectives.py's psum), and all-gathers the
logits over the vocabulary, so every rank holds the full logits; forward
also shards the batch over `data_axis`.  LoRA adapters with a mesh raise.

Entry points run on the card by default (`device="cuda"`) and raise
without CUDA; pass `device="cpu"` for the plain versions.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve_device
from ..ops.flash_vjp import flash_attention_vjp
from ..ops.paged import (kv_cache_append_decode,
                         kv_cache_append_decode_quantized, paged_attention)
from ..ops.paged_fused import (kv_cache_append_decode_fused,
                               kv_cache_append_prefill_fused,
                               paged_attention_fused)
from ..ops.paged_prefill import paged_attention_prefill
from ..ops.rope import apply_rope, precompute_rope_frequencies
from ..parallel.collectives import all_gather, enter_region, psum
from ..parallel.mesh import axis_size, map_specs, renamed, shard
from ..utils.tree import tree_flatten, tree_map

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14336
    rope_base: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # sliding window; -1 = full attention (prefill: q - k <= W; decode:
    # trailing W + 1 tokens, see decode_step_fused)
    window_size: int = -1

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, hidden_dim=14336)

    @classmethod
    def mistral_7b(cls) -> "LlamaConfig":
        """Mistral-7B's shape: the Llama architecture with a 4096-token
        sliding window (the JAX package's LlamaConfig.mistral_7b())."""
        return cls(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, hidden_dim=14336, rope_base=10000.0,
                   window_size=4096)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test-sized config (the JAX package's LlamaConfig.tiny())."""
        defaults = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                        n_kv_heads=2, hidden_dim=256, rope_base=10000.0,
                        dtype=torch.float32)
        defaults.update(kw)
        return cls(**defaults)


def _dense(generator, dev, dtype, fan_in, shape) -> torch.Tensor:
    """N(0, 1/fan_in) drawn in f32 from `generator`, cast to `dtype`."""
    w = torch.randn(shape, generator=generator, device=dev,
                    dtype=torch.float32)
    return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random parameters, N(0, 1/fan_in) in f32 cast to cfg.dtype (the JAX
    init's scale), norms one.  `generator` must live on `device`."""
    dev = resolve_device(device)

    def dense(fan_in, shape):
        return _dense(generator, dev, cfg.dtype, fan_in, shape)

    d, h = cfg.dim, cfg.hidden_dim
    qkv_dim = cfg.n_heads * cfg.head_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "wq": dense(d, (d, qkv_dim)),
            "wk": dense(d, (d, kv_dim)),
            "wv": dense(d, (d, kv_dim)),
            "wo": dense(qkv_dim, (qkv_dim, d)),
            "w_gate": dense(d, (d, h)),
            "w_up": dense(d, (d, h)),
            "w_down": dense(h, (h, d)),
            "attn_norm": torch.ones((d,), dtype=torch.float32, device=dev),
            "mlp_norm": torch.ones((d,), dtype=torch.float32, device=dev),
        })
    return {
        "embed": dense(1, (cfg.vocab_size, d)),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=torch.float32, device=dev),
        "lm_head": dense(d, (d, cfg.vocab_size)),
    }


def param_specs(cfg: LlamaConfig) -> Dict[str, Any]:
    """Tensor-parallel specs over a (data, model) mesh (JAX l.86-102; a
    spec is a tuple of axis names or None per dim, see parallel/mesh.py):
    wq, wk, wv, w_gate and w_up shard by columns (heads, hidden units),
    wo and w_down by rows, lm_head by vocabulary; the rest replicates."""
    layer = {
        "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
        "wo": ("model", None),
        "w_gate": (None, "model"), "w_up": (None, "model"),
        "w_down": ("model", None),
        "attn_norm": (None,), "mlp_norm": (None,),
    }
    return {
        "embed": (None, None),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "final_norm": (None,),
        "lm_head": (None, "model"),
    }


def shard_params(params: Params, cfg: LlamaConfig, mesh,
                 model_axis: str = "model") -> Params:
    """This rank's shards of the full params under `param_specs` (the
    spec's `model` read as `model_axis`): what `mesh=` calls take.  The
    full params arrive as usual (`init_params`, `load_jax_params`)."""
    return map_specs(lambda spec, t: shard(t, mesh, renamed(spec, model_axis)),
                     param_specs(cfg), params)


class _RankConfig:
    """A config as one rank of a tensor-parallel mesh sees it: its share
    of the heads (GQA groups co-located), the full head_dim."""

    def __init__(self, cfg, tp: int):
        self._cfg = cfg
        self.n_heads = cfg.n_heads // tp
        self.n_kv_heads = cfg.n_kv_heads // tp
        self.head_dim = cfg.head_dim

    def __getattr__(self, name):
        return getattr(self._cfg, name)


class _TensorParallel:
    """A `mesh=` call's view of the mesh (JAX l.154-170's shard_map island
    plus the GSPMD dense layers around it): each rank projects its heads
    and hidden units from its param shards, attends locally over its
    heads' pools, and the ranks join by one all-reduce after wo, one
    after w_down, and an all-gather of the logits over the vocabulary
    (and over the batch when `data_axis` shards it)."""

    def __init__(self, cfg, mesh, model_axis: str,
                 data_axis: Optional[str] = None):
        tp = axis_size(mesh, model_axis)
        if cfg.n_heads % tp or cfg.n_kv_heads % tp:
            raise ValueError(
                f"n_heads {cfg.n_heads} and n_kv_heads {cfg.n_kv_heads} "
                f"must be divisible by tp {tp}")
        self.mesh, self.model_axis, self.data_axis = mesh, model_axis, \
            data_axis
        self.cfg = _RankConfig(cfg, tp)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """x, replicated, entering the rank's columns (its gradient summed
        over the ranks backward)."""
        return enter_region(x, self.model_axis, self.mesh)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return psum(x, self.model_axis, self.mesh)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = all_gather(x, self.model_axis, self.mesh, dim=-1)
        if self.data_axis is not None:
            x = all_gather(x, self.data_axis, self.mesh, dim=0)
        return x

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's batch rows of `x` over `data_axis`."""
        return shard(x, self.mesh, (self.data_axis,))


def _tensor_parallel(cfg, mesh, model_axis, data_axis=None, lora=None):
    """The `_TensorParallel` view of a `mesh=` call (None without one)."""
    if mesh is None:
        return None
    if lora is not None:
        raise NotImplementedError(
            "LoRA adapters with mesh= are not ported: the serving engine "
            "refuses multi-LoRA under tensor parallelism, as JAX's does")
    return _TensorParallel(cfg, mesh, model_axis, data_axis)


def _enter(tp, x):
    return x if tp is None else tp.enter(x)


def _reduce(tp, x):
    return x if tp is None else tp.reduce(x)


def _logits(tp, x, lm_head):
    """f32 logits of the normed x (all of them on every rank under a
    mesh: the rank's vocabulary columns, all-gathered)."""
    x = (_enter(tp, x) @ lm_head).float()
    return x if tp is None else tp.logits(x)


def _to_torch(a: np.ndarray, dev, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native bf16
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    t = t.to(dev)
    return t if dtype is None else t.to(dtype)


def load_jax_params(np_tree: Params, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX package's params, converted by the caller with
    `jax.tree.map(np.asarray, params)`, as the port's params on `device`.
    `dtype` recasts the weight matrices; norms stay f32 as in JAX."""
    dev = resolve_device(device)

    def conv(name, a):
        return _to_torch(a, dev, None if name.endswith("norm") else dtype)

    return {
        "embed": conv("embed", np_tree["embed"]),
        "layers": [{k: conv(k, v) for k, v in layer.items()}
                   for layer in np_tree["layers"]],
        "final_norm": conv("final_norm", np_tree["final_norm"]),
        "lm_head": conv("lm_head", np_tree["lm_head"]),
    }


def _tensors(params: Params):
    yield params["embed"]
    yield params["final_norm"]
    yield params["lm_head"]
    for layer in params["layers"]:
        yield from layer.values()


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


def _split_heads(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim).transpose(1, 2)


def _merge_heads(x):
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def _lora_proj(h: torch.Tensor, w: torch.Tensor, lora_layer, name: str,
               idx: Optional[torch.Tensor]) -> torch.Tensor:
    """h @ w plus a per-row low-rank delta (h A_i) B_i, row b on adapter
    idx[b] of the stacked bank (JAX l.172-194): lora_layer[name] = (A
    [N, d, r], B [N, r, o]) over N adapters, the alpha / r scale folded
    into B, index 0 the all-zero base adapter.  h is [B, d] (decode) or
    [B, S, d] (prefill).  JAX's rounding: h @ w in the model's type, the
    delta in f32 on the gathered A_i, B_i, cast to the output's type, then
    added."""
    out = h @ w
    if lora_layer is None or idx is None or name not in lora_layer:
        return out
    a, b = lora_layer[name]
    idx = idx.to(a.device).long()
    ai = a[idx].float()                    # [B, d, r]
    bi = b[idx].float()                    # [B, r, o]
    hf = h.float()
    if h.dim() == 2:
        d = torch.bmm(torch.bmm(hf[:, None], ai), bi)[:, 0]
    else:
        d = torch.bmm(torch.bmm(hf, ai), bi)
    return out + d.to(out.dtype)


def _lora_at(lora, li: int):
    """Layer li's entry of a LoRA bank, or None without one."""
    return None if lora is None else lora["layers"][li]


def _mlp(x, layer, cfg, tp=None):
    h = _enter(tp, rms_norm(x, layer["mlp_norm"], cfg.norm_eps))
    gate = F.silu((h @ layer["w_gate"]).float())
    up = (h @ layer["w_up"]).float()
    return x + _reduce(tp, (gate * up).to(x.dtype) @ layer["w_down"])


def _mlp_of(tp, mlp=None):
    """The MLP block of a call: `mlp` (a family's own), or Llama's, whose
    w_down partial sums join over the ranks under tensor parallelism."""
    if mlp is not None:
        return mlp
    return _mlp if tp is None else functools.partial(_mlp, tp=tp)


def forward(
    params: Params,
    tokens: torch.Tensor,          # [B, S] int
    cfg: LlamaConfig,
    *,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    return_kv: bool = False,
    attention: Callable = flash_attention_vjp,
    mesh=None,
    data_axis: str = "data",
    model_axis: str = "model",
    lora=None,
    lora_idx: Optional[torch.Tensor] = None,
):
    """Causal-LM forward (prefill and training).  Returns logits [B, S, V]
    f32; with return_kv also the per-layer ROTATED k and unrotated v
    [B, Hkv, S, Dh] for filling the decode pools.  `attention` is the
    differentiable flash attention; a reference run passes its plain
    version (ops.flash_vjp's flash_attention_vjp_plain) to hold the kernel
    path against it.  `lora` / `lora_idx` [B]: the adapters on wq, wk, wv
    and wo (`_lora_proj`).

    With `mesh` (JAX l.154-170): `params` are this rank's shards
    (`shard_params`) and `tokens` the full batch; attention stays local to
    the rank's heads (GQA groups co-located) and its batch rows over
    `data_axis`, the ranks join after wo and w_down, and every rank gets
    the full logits; the returned k and v are the rank's heads and rows.
    Differentiable: each rank's backward of its copy of one loss gives
    its shards' gradients (the replicated params' whole, over `data_axis`
    only its rows' share: summing those is a trainer's)."""
    tp = _tensor_parallel(cfg, mesh, model_axis, data_axis, lora)
    return _forward(params, tokens, cfg, rope_cos, rope_sin, return_kv,
                    attention, _mlp_of(tp), lora, lora_idx, tp)


def _qkv(x, layer, cfg, ll, lora_idx, tp=None):
    """q [B, Hq, S, D], k and v [B, Hkv, S, D] (unrotated) of x [B, S,
    dim], each projection with its adapter of the layer's bank `ll`."""
    h = _enter(tp, rms_norm(x, layer["attn_norm"], cfg.norm_eps))
    return tuple(
        _split_heads(_lora_proj(h, layer[name], ll, name, lora_idx), heads,
                     cfg.head_dim)
        for name, heads in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                            ("wv", cfg.n_kv_heads)))


def _layer(x, layer, cfg, rope_cos, rope_sin, attention: Callable,
           mlp: Callable, ll=None, lora_idx=None, tp=None):
    """One transformer block on x [B, S, dim] (JAX l.229-250; also the
    pipeline's stage block): (its output, the layer's rotated k and
    unrotated v)."""
    q, k, v = _qkv(x, layer, cfg, ll, lora_idx, tp)
    q = apply_rope(q, rope_cos, rope_sin)
    k = apply_rope(k, rope_cos, rope_sin)
    attn = attention(q, k, v, causal=True, window_size=cfg.window_size)
    x = x + _reduce(tp, _lora_proj(_merge_heads(attn), layer["wo"], ll, "wo",
                                   lora_idx))
    return mlp(x, layer, cfg), (k, v)


def _forward(params, tokens, cfg, rope_cos, rope_sin, return_kv: bool,
             attention: Callable, mlp: Callable, lora=None, lora_idx=None,
             tp=None):
    """`forward` with the MLP block `mlp(x, layer, cfg) -> x + MLP(x)` as
    an argument (models/moe.py passes its routed mixture) and the mesh
    view `tp` (None on one device)."""
    if tp is not None:
        tokens, cfg = tp.rows(tokens), tp.cfg
    b, s = tokens.shape
    dev = params["embed"].device
    if rope_cos is None:
        rope_cos, rope_sin = precompute_rope_frequencies(
            s, cfg.head_dim, cfg.rope_base, device=dev)
    x = params["embed"][tokens.to(dev)]
    kv_out: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for li, layer in enumerate(params["layers"]):
        x, kv = _layer(x, layer, cfg, rope_cos, rope_sin, attention, mlp,
                       _lora_at(lora, li), lora_idx, tp)
        if return_kv:
            kv_out.append(kv)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(tp, x, params["lm_head"])
    if return_kv:
        return logits, kv_out
    return logits


def loss_fn(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            mesh=None, *, attention: Callable = flash_attention_vjp,
            data_axis: str = "data", model_axis: str = "model",
            sum_data_grads: bool = True) -> torch.Tensor:
    """Mean next-token negative log-likelihood of `tokens` [B, S] under
    `forward(tokens[:, :-1])` (JAX l.367-373), a 0-d f32 tensor.

    With `mesh` (dp x tp): `params` are this rank's shards (`shard_params`)
    and `tokens` the full batch, which forward shards over `data_axis`;
    every rank returns the same loss of the whole batch.  The params enter
    the data axis through `enter_region`, so backward sums each gradient
    over the data ranks and leaves the gradient of the rank's shard, as
    jax.grad of JAX's loss_fn(mesh=) gives the global one.
    sum_data_grads=False leaves the rank's rows' share instead (the ZeRO-1
    step reduce-scatters those itself)."""
    if mesh is not None and sum_data_grads:
        params = tree_map(lambda t: enter_region(t, data_axis, mesh), params)
    logits = forward(params, tokens[:, :-1], cfg, attention=attention,
                     mesh=mesh, data_axis=data_axis, model_axis=model_axis)
    targets = tokens[:, 1:].to(logits.device)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def train_step(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
               lr: float = 1e-4, mesh=None, *, data_axis: str = "data",
               model_axis: str = "model"):
    """One SGD step, p <- p - lr * grad, computed in f32 and cast back to
    each parameter's dtype (JAX l.376-384): `add_` with `alpha=-lr`, which
    PyTorch computes for bf16 and f16 in f32 (its opmath type) and rounds
    once.  Returns (params, loss).  With `mesh`, dp x tp: `params` are this
    rank's shards and each takes its gradient summed over the data ranks
    (`loss_fn(mesh=)`), so the ranks' replicated shards stay equal.

    Two departures from JAX, whose step is pure: every parameter tensor is
    made to require grad and is updated IN PLACE under torch.no_grad(),
    and each `.grad` is freed right after its update, so the step needs no
    memory beyond the weights and their gradients.  The returned params are
    the same dict; `loss` (0-d f32) is the loss before the update, as
    JAX's."""
    return params, _sgd_step(tree_flatten(params), lambda: loss_fn(
        params, tokens, cfg, mesh, data_axis=data_axis,
        model_axis=model_axis), lr)


def _sgd_step(tensors, loss_of: Callable[[], torch.Tensor],
              lr: float) -> torch.Tensor:
    """`train_step`'s update of the parameter tensors `tensors` around
    their loss `loss_of()`; returns the loss, detached."""
    for t in tensors:
        t.requires_grad_(True)
        t.grad = None
    loss = loss_of()
    loss.backward()
    with torch.no_grad():
        for t in tensors:
            t.add_(t.grad, alpha=-lr)
            t.grad = None
    return loss.detach()


def _rotate(x, c, sn, half):
    return torch.cat([x[..., :half] * c - x[..., half:] * sn,
                      x[..., :half] * sn + x[..., half:] * c],
                     dim=-1).to(x.dtype)


def _decode_window(cfg: LlamaConfig) -> int:
    """The decode kernels' window: decode windows are trailing-W (k >=
    pos-W+1) while prefill's mask is q-k <= W, so W+1 on the decode side
    makes them identical (JAX llama.py:290-292)."""
    return cfg.window_size + 1 if cfg.window_size > 0 else -1


def _decode_layers(params: Params, token, positions, cfg: LlamaConfig,
                   rope_cos, rope_sin, attend: Callable,
                   mlp: Callable = _mlp, lora=None, lora_idx=None, tp=None):
    """The layers of one decode step around `attend(li, q, k, v) ->
    (attn [B, Hq, D], context_lens + 1)`, which appends layer li's rotated
    k and v [B, Hkv, D] and attends q [B, Hq, D] over its pool, and the MLP
    block `mlp` (as `_forward`'s), with the adapters `lora` / `lora_idx`
    [B] on the projections, and the mesh view `tp` (`attend` then takes
    this rank's heads).  Returns (logits [B, V] f32, context_lens + 1)."""
    if tp is not None:
        cfg = tp.cfg
    x = params["embed"][token]
    c = rope_cos[positions][:, None, :]
    sn = rope_sin[positions][:, None, :]
    half = cfg.head_dim // 2
    lens_out = None
    for li, layer in enumerate(params["layers"]):
        ll = _lora_at(lora, li)
        h = _enter(tp, rms_norm(x, layer["attn_norm"], cfg.norm_eps))
        q, k, v = (_lora_proj(h, layer[name], ll, name, lora_idx).reshape(
            -1, heads, cfg.head_dim) for name, heads in (
                ("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                ("wv", cfg.n_kv_heads)))
        attn, lens_out = attend(li, _rotate(q, c, sn, half),
                                _rotate(k, c, sn, half), v)
        x = x + _reduce(tp, _lora_proj(
            attn.reshape(-1, cfg.n_heads * cfg.head_dim), layer["wo"], ll,
            "wo", lora_idx))
        x = mlp(x, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(tp, x, params["lm_head"]), lens_out


def decode_step(
    params: Params,
    token: torch.Tensor,                 # [B] int
    positions: torch.Tensor,             # [B] int
    k_pages: Sequence[torch.Tensor],     # per-layer split pools
    v_pages: Sequence[torch.Tensor],
    block_tables: torch.Tensor,          # [B, max_pages] int32
    context_lens: torch.Tensor,          # [B] int32, BEFORE this token
    cfg: LlamaConfig,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    k_scales: Optional[Sequence[torch.Tensor]] = None,
    v_scales: Optional[Sequence[torch.Tensor]] = None,
    mesh=None,
    data_axis: str = "data",
    model_axis: str = "model",
    *,
    attention: Callable = paged_attention,
):
    """One decode step over split (head-major) pools (JAX l.259-364):
    appends this token's K/V to each layer's pools (in place, quantized
    with f32 scales when per-layer `k_scales`/`v_scales` are given) and
    attends over them with the split paged decode.  Returns (logits [B, V]
    f32, k_pages, v_pages, context_lens + 1), then k_scales, v_scales when
    quantized.  Stacked [L, ...] tensors work as pools and scales: their
    per-layer views are written in place.  `attention` is the paged decode;
    a reference run passes its plain version
    (ops.paged.paged_attention_plain).  With `mesh` (JAX l.282-330),
    `params` are this rank's shards and the pools (and scales) hold its
    kv heads, [Hkv/tp, P, page, D]; tables and lengths are the full ones
    and every rank gets the full logits.  `data_axis` is accepted as JAX's
    step accepts it: serving shards no batch."""
    del data_axis
    tp = _tensor_parallel(cfg, mesh, model_axis)
    quantized = k_scales is not None
    window = _decode_window(cfg)

    def attend(li, q, k, v):
        if quantized:
            lens = kv_cache_append_decode_quantized(
                k_pages[li], v_pages[li], k_scales[li], v_scales[li], k, v,
                block_tables, context_lens)[-1]
            scales = dict(k_scales=k_scales[li], v_scales=v_scales[li])
        else:
            lens = kv_cache_append_decode(k_pages[li], v_pages[li], k, v,
                                          block_tables, context_lens)[-1]
            scales = {}
        return attention(q, k_pages[li], v_pages[li], block_tables, lens,
                         window_size=window, **scales), lens

    logits, lens_out = _decode_layers(params, token, positions, cfg,
                                      rope_cos, rope_sin, attend,
                                      _mlp_of(tp), tp=tp)
    if quantized:
        return logits, k_pages, v_pages, lens_out, k_scales, v_scales
    return logits, k_pages, v_pages, lens_out


def decode_step_fused(
    params: Params,
    token: torch.Tensor,                 # [B] int
    positions: torch.Tensor,             # [B] int
    kv_pages: Sequence[torch.Tensor],    # per-layer fused pools
    block_tables: torch.Tensor,          # [B, max_pages] int32
    context_lens: torch.Tensor,          # [B] int32, BEFORE this token
    cfg: LlamaConfig,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    kv_scales: Optional[Sequence[torch.Tensor]] = None,
    mesh=None,
    model_axis: str = "model",
    *,
    attention: Callable = paged_attention_fused,
    lora=None,
    lora_idx: Optional[torch.Tensor] = None,
):
    """One decode step: appends this token's K/V to each layer's fused pool
    (in place, quantized when per-layer packed scale pools `kv_scales` are
    given) and attends over it with the paged decode.  Returns (logits
    [B, V] f32, kv_pages, context_lens + 1), and kv_scales fourth when
    quantized.  Stacked [L, ...] tensors work as `kv_pages` / `kv_scales`:
    their per-layer views are written in place.  `attention` is the paged
    decode; a reference run passes its plain version
    (ops.paged_fused.paged_attention_fused_plain).  `lora` / `lora_idx`
    [B]: the adapters, as forward's.  With `mesh` (JAX l.407-460),
    `params` are this rank's shards and each fused pool holds its kv
    heads, [P, 2, Hkv/tp, page, Dpad], with scale tiles packing its local
    heads ([P, page, 128]: one 128-lane block of JAX's tp*128 lanes);
    the pages stay whole local slabs, so the kernel runs unchanged."""
    tp = _tensor_parallel(cfg, mesh, model_axis, lora=lora)
    return _decode_fused(params, token, positions, kv_pages, block_tables,
                         context_lens, cfg, rope_cos, rope_sin, kv_scales,
                         attention, _mlp_of(tp), lora, lora_idx, tp)


def _decode_fused(params, token, positions, kv_pages, block_tables,
                  context_lens, cfg, rope_cos, rope_sin, kv_scales,
                  attention: Callable, mlp: Callable, lora=None,
                  lora_idx=None, tp=None):
    """`decode_step_fused` with the MLP block as an argument (as
    `_forward`'s)."""
    window = _decode_window(cfg)

    def attend(li, q, k, v):
        sc = None if kv_scales is None else kv_scales[li]
        lens = kv_cache_append_decode_fused(
            kv_pages[li], k, v, block_tables, context_lens, kv_scales=sc)[-1]
        return attention(q, kv_pages[li], block_tables, lens, kv_scales=sc,
                         window_size=window), lens

    logits, lens_out = _decode_layers(params, token, positions, cfg,
                                      rope_cos, rope_sin, attend, mlp, lora,
                                      lora_idx, tp)
    if kv_scales is not None:
        return logits, kv_pages, lens_out, kv_scales
    return logits, kv_pages, lens_out


def prefill_step_fused(
    params: Params,
    tokens: torch.Tensor,                # [B, S_chunk] int
    q_offsets: torch.Tensor,             # [B] position of tokens[:, 0]
    seq_lens: torch.Tensor,              # [B] valid tokens of the chunk
    kv_pages: Sequence[torch.Tensor],    # per-layer fused pools
    block_tables: torch.Tensor,          # [B, max_pages] int32
    cfg: LlamaConfig,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    kv_scales: Optional[Sequence[torch.Tensor]] = None,
    mesh=None,
    model_axis: str = "model",
    *,
    all_logits: bool = False,
    attention: Callable = paged_attention_prefill,
    lora=None,
    lora_idx: Optional[torch.Tensor] = None,
):
    """One chunk of chunked prefill over the fused pools: append the
    chunk's K/V (in place, quantized when `kv_scales` are given), then
    attend to cache history plus chunk.  Returns (logits, kv_pages,
    q_offsets + seq_lens), and kv_scales fourth when quantized.  Logits are
    [B, V] f32 for each sequence's last valid chunk token, or [B, S, V] for
    every position with all_logits=True.  `attention` is the paged prefill;
    a reference run passes its plain version
    (ops.paged_prefill.paged_attention_prefill_plain).  `lora` /
    `lora_idx` [B]: the adapters, as forward's.  With `mesh` (JAX
    l.522-560): this rank's shards and pools, as decode_step_fused's."""
    tp = _tensor_parallel(cfg, mesh, model_axis, lora=lora)
    return _prefill_fused(params, tokens, q_offsets, seq_lens, kv_pages,
                          block_tables, cfg, rope_cos, rope_sin, kv_scales,
                          all_logits, attention, _mlp_of(tp), lora,
                          lora_idx, tp)


def _prefill_fused(params, tokens, q_offsets, seq_lens, kv_pages,
                   block_tables, cfg, rope_cos, rope_sin, kv_scales,
                   all_logits: bool, attention: Callable, mlp: Callable,
                   lora=None, lora_idx=None, tp=None):
    """`prefill_step_fused` with the MLP block as an argument (as
    `_forward`'s)."""
    if tp is not None:
        cfg = tp.cfg
    _, s_chunk = tokens.shape
    dev = params["embed"].device
    q_offsets = q_offsets.to(dev)
    seq_lens = seq_lens.to(dev)
    # positions past the tables (padding) clamp, as JAX's gather does
    positions = (q_offsets.long()[:, None]
                 + torch.arange(s_chunk, device=dev)[None, :]).clamp(
                     max=rope_cos.shape[0] - 1)
    x = params["embed"][tokens.to(dev)]
    lens_out = q_offsets + seq_lens
    for li, layer in enumerate(params["layers"]):
        sc = None if kv_scales is None else kv_scales[li]
        q, k, v = _qkv(x, layer, cfg, _lora_at(lora, li), lora_idx, tp)
        q = apply_rope(q, rope_cos, rope_sin, positions[:, None])
        k = apply_rope(k, rope_cos, rope_sin, positions[:, None])
        lens_out = kv_cache_append_prefill_fused(
            kv_pages[li], k, v, block_tables, q_offsets, seq_lens,
            kv_scales=sc)[-1]
        attn = attention(q, kv_pages[li], block_tables, lens_out,
                         q_offsets=q_offsets, kv_scales=sc, causal=True,
                         window_size=cfg.window_size)
        x = x + _reduce(tp, _lora_proj(_merge_heads(attn), layer["wo"],
                                       _lora_at(lora, li), "wo", lora_idx))
        x = mlp(x, layer, cfg)
    if not all_logits:
        # only the last valid row of each sequence is ever sampled
        last = (seq_lens.long() - 1).clamp_min(0)
        x = x[torch.arange(x.shape[0], device=dev), last]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(tp, x, params["lm_head"])
    if kv_scales is not None:
        return logits, kv_pages, lens_out, kv_scales
    return logits, kv_pages, lens_out
