"""GPT-2-style decoder (counterpart of aule_tpu/models/gpt2.py).

MHA (Hkv == Hq) with head_dim 64, learned absolute position embeddings,
pre-LN blocks, a tanh-GELU MLP and a weight-tied LM head, f32 by default.
It has the serving entry points of models/llama.py (`forward`,
`decode_step_fused`, `prefill_step_fused`, with llama's argument order), so
`serving.engine.ServingEngine(model=gpt2)` drives either family.

Parameters are a plain dict with the JAX package's keys and `[in, out]`
weight orientation, so JAX params cross over as a plain copy
(`load_jax_params`); `w_qkv` keeps JAX's qkv-major [3, dim, dim] layout.
Dtype placement follows the JAX model: every parameter is cfg.dtype,
`layer_norm` computes in f32 (population variance) and casts back, and the
logits are `x @ wte.T` cast to f32.  f32 products stay f32: nothing here
turns TF32 on (torch.backends.cuda.matmul.allow_tf32 stays as the caller
set it, off by default).

Attention runs on the port's kernels: `forward` through the flash
attention (on the card csrc/flash_generic.cu in f32, the tensor-core
csrc/flash_fwd.cu and csrc/flash_bwd.cu in bf16 at D 64),
`decode_step_fused` and `prefill_step_fused` through the paged kernels
(csrc/paged_generic.cu for those types and head dims), over fused pools
whose rows are padded from 64 to 128 lanes.  GPT-2 has no decode over
split pools (nor has the JAX model), so the engine's `layout="split"`
refuses it.  `lora=` / `lora_idx=` put multi-LoRA adapters on the
projections as llama's `_lora_proj` does, the engine's targets `wq`, `wk`,
`wv` on the three slices of `w_qkv` and `wo` on `w_proj` (JAX
l.145-158).

Tensor parallelism (`mesh=`, JAX l.69-89, 167-397): `param_specs` shards
the qkv-major `w_qkv` [3, dim, H*D] and its bias by heads (so the MHA
heads shard cleanly), w_fc and fc_b by hidden units, w_proj and w_out by
rows; the embeddings, norms and output biases replicate.  `shard_params`
cuts a rank's shards from the full params.  Under a mesh each rank
projects its heads and hidden units, attends over them (its pools hold its
heads), and the ranks join by one all-reduce after w_proj and one after
w_out, each followed by its replicated bias, as JAX's GSPMD program adds
it after the reduction; the tied head's logits are whole on every rank.
forward also shards the batch over `data_axis`.  LoRA with a mesh raises,
as llama's.  Entry points run on the card by default
(`device="cuda"`) and raise without CUDA; pass `device="cpu"` for the
plain versions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import resolve_device
from ..ops.flash_vjp import flash_attention_vjp
from ..ops.paged_fused import (kv_cache_append_decode_fused,
                               kv_cache_append_prefill_fused,
                               paged_attention_fused)
from ..ops.paged_prefill import paged_attention_prefill
from ..parallel.collectives import all_gather
from ..parallel.mesh import map_specs, renamed, shard
from .llama import (_enter, _lora_at, _lora_proj, _reduce, _tensor_parallel,
                    _to_torch)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_ctx: int = 1024
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    # engine compatibility (MHA: kv heads == q heads)
    @property
    def n_kv_heads(self) -> int:
        return self.n_heads

    @property
    def hidden_dim(self) -> int:
        return 4 * self.dim

    @property
    def rope_base(self) -> float:  # the engine builds (unused) RoPE tables
        return 10000.0

    @classmethod
    def tiny(cls, **kw) -> "GPT2Config":
        """Test-sized config (the JAX package's GPT2Config.tiny())."""
        defaults = dict(vocab_size=256, n_ctx=256, dim=128, n_layers=2,
                        n_heads=2)
        defaults.update(kw)
        return cls(**defaults)


def param_specs(cfg: GPT2Config) -> Dict[str, Any]:
    """Tensor-parallel specs over a (data, model) mesh (JAX l.69-89; tuples,
    see parallel/mesh.py)."""
    layer = {
        "ln1_g": (None,), "ln1_b": (None,),
        "w_qkv": (None, None, "model"),   # [3, dim, H*Dh]: heads sharded
        "qkv_b": (None, "model"),
        "w_proj": ("model", None),        # [H*Dh, dim]: rows sharded
        "proj_b": (None,),
        "ln2_g": (None,), "ln2_b": (None,),
        "w_fc": (None, "model"),
        "fc_b": ("model",),
        "w_out": ("model", None),
        "out_b": (None,),
    }
    return {
        "wte": (None, None),
        "wpe": (None, None),
        "final_ln_g": (None,),
        "final_ln_b": (None,),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
    }


def shard_params(params: Params, cfg: GPT2Config, mesh,
                 model_axis: str = "model") -> Params:
    """This rank's shards of the full params under `param_specs` (its
    `model` read as `model_axis`): what `mesh=` calls take."""
    return map_specs(lambda spec, t: shard(t, mesh, renamed(spec, model_axis)),
                     param_specs(cfg), params)


def init_params(cfg: GPT2Config, generator: torch.Generator,
                device="cuda") -> Params:
    """Random parameters with the JAX init's scales: dense weights
    N(0, 1/fan_in), position embeddings 0.01 N(0, 1), norms one, biases
    zero, all in cfg.dtype.  `generator` must live on `device`."""
    dev = resolve_device(device)

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return w.mul_(std).to(cfg.dtype)

    def dense(fan_in, shape):
        return normal(shape, 1.0 / math.sqrt(fan_in))

    def const(shape, value):
        return torch.full(shape, value, dtype=cfg.dtype, device=dev)

    d, h = cfg.dim, cfg.hidden_dim
    params: Params = {
        "wte": dense(d, (cfg.vocab_size, d)),
        "wpe": normal((cfg.n_ctx, d), 0.01),
        "final_ln_g": const((d,), 1.0),
        "final_ln_b": const((d,), 0.0),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1_g": const((d,), 1.0),
            "ln1_b": const((d,), 0.0),
            # qkv-major [3, dim, n_heads * head_dim], as JAX's
            "w_qkv": dense(d, (3, d, d)),
            "qkv_b": const((3, d), 0.0),
            "w_proj": dense(d, (d, d)),
            "proj_b": const((d,), 0.0),
            "ln2_g": const((d,), 1.0),
            "ln2_b": const((d,), 0.0),
            "w_fc": dense(d, (d, h)),
            "fc_b": const((h,), 0.0),
            "w_out": dense(h, (h, d)),
            "out_b": const((d,), 0.0),
        })
    return params


def load_jax_params(np_tree: Params, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX package's GPT-2 params, converted by the caller with
    `jax.tree.map(np.asarray, params)`, as the port's params on `device`
    (recast to `dtype` when given)."""
    dev = resolve_device(device)
    out = {k: _to_torch(v, dev, dtype) for k, v in np_tree.items()
           if k != "layers"}
    out["layers"] = [{k: _to_torch(v, dev, dtype) for k, v in layer.items()}
                     for layer in np_tree["layers"]]
    return out


def _tensors(params: Params):
    for k, v in params.items():
        if k == "layers":
            for layer in v:
                yield from layer.values()
        else:
            yield v


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in f32 (population variance), cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def _split(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim).transpose(1, 2)


def _merge(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


_QKV = ("wq", "wk", "wv")  # the LoRA targets on w_qkv's three slices


def _qkv(layer, h, cfg, ll=None, lora_idx=None):
    """q, k, v [B, H, S, D] from the qkv-major weight, each slice with its
    adapter of the layer's bank `ll`."""
    w, bias = layer["w_qkv"], layer["qkv_b"]
    return tuple(_split(_lora_proj(h, w[i], ll, name, lora_idx) + bias[i],
                        cfg.n_heads, cfg.head_dim)
                 for i, name in enumerate(_QKV))


def _proj(layer, attn, tp, ll=None, lora_idx=None):
    """The output projection of the merged heads [..., H*D], its partial
    sums joined over the ranks, then its bias."""
    return _reduce(tp, _lora_proj(attn, layer["w_proj"], ll, "wo",
                                  lora_idx)) + layer["proj_b"]


def _mlp(layer, x, cfg, tp=None):
    h = _enter(tp, layer_norm(x, layer["ln2_g"], layer["ln2_b"],
                              cfg.norm_eps))
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(h @ layer["w_fc"] + layer["fc_b"], approximate="tanh")
    return x + _reduce(tp, h @ layer["w_out"]) + layer["out_b"]


def _embed(params, tokens, positions, cfg):
    """Token plus position embeddings; positions past the table clamp to
    its last row, as JAX's gather does."""
    return (params["wte"][tokens]
            + params["wpe"][positions.long().clamp(0, cfg.n_ctx - 1)])


def _logits(params, x, cfg):
    x = layer_norm(x, params["final_ln_g"], params["final_ln_b"],
                   cfg.norm_eps)
    return (x @ params["wte"].T).float()


def forward(
    params: Params,
    tokens: torch.Tensor,          # [B, S] int
    cfg: GPT2Config,
    *,
    rope_cos=None,                 # unused (learned positions)
    rope_sin=None,
    positions: Optional[torch.Tensor] = None,   # [B, S] absolute
    return_kv: bool = False,
    attention: Callable = flash_attention_vjp,
    mesh=None,
    data_axis: str = "data",
    model_axis: str = "model",
    lora=None,
    lora_idx: Optional[torch.Tensor] = None,
):
    """Causal-LM forward: logits [B, S, V] f32, with return_kv also the
    per-layer (k, v) [B, H, S, D] for filling the decode pools.
    `attention` is the differentiable flash attention; a reference run
    passes its plain version (ops.flash_vjp.flash_attention_vjp_plain).
    `lora` / `lora_idx` [B]: the adapters (llama.forward's).  With `mesh`
    (JAX l.167-220): `params` are this rank's shards (`shard_params`),
    `tokens` (and `positions`) the full batch, sharded over `data_axis`;
    attention runs over the rank's heads and rows, every rank gets the
    full logits, and the returned k and v are the rank's heads and rows."""
    del rope_cos, rope_sin
    tp = _tensor_parallel(cfg, mesh, model_axis, data_axis, lora)
    dev = params["wte"].device
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=dev)[None].expand(b, s)
    tokens, positions = tokens.to(dev), positions.to(dev)
    if tp is not None:
        tokens, positions, cfg = tp.rows(tokens), tp.rows(positions), tp.cfg
    x = _embed(params, tokens, positions, cfg)
    kv_out: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for li, layer in enumerate(params["layers"]):
        ll = _lora_at(lora, li)
        h = _enter(tp, layer_norm(x, layer["ln1_g"], layer["ln1_b"],
                                  cfg.norm_eps))
        q, k, v = _qkv(layer, h, cfg, ll, lora_idx)
        if return_kv:
            kv_out.append((k, v))
        attn = attention(q, k, v, causal=True)
        x = x + _proj(layer, _merge(attn), tp, ll, lora_idx)
        x = _mlp(layer, x, cfg, tp)
    logits = _logits(params, x, cfg)
    if tp is not None and tp.data_axis is not None:
        logits = all_gather(logits, tp.data_axis, tp.mesh, dim=0)
    if return_kv:
        return logits, kv_out
    return logits


def decode_step_fused(
    params: Params,
    token: torch.Tensor,                 # [B] int
    positions: torch.Tensor,             # [B] int absolute
    kv_pages: Sequence[torch.Tensor],    # per-layer fused pools
    block_tables: torch.Tensor,          # [B, max_pages] int32
    context_lens: torch.Tensor,          # [B] int32, BEFORE this token
    cfg: GPT2Config,
    rope_cos=None,                       # unused (learned positions)
    rope_sin=None,
    kv_scales: Optional[Sequence[torch.Tensor]] = None,
    mesh=None,
    model_axis: str = "model",
    *,
    attention: Callable = paged_attention_fused,
    lora=None,
    lora_idx: Optional[torch.Tensor] = None,
):
    """One decode step over fused pools (llama.decode_step_fused's
    signature): appends this token's K/V to each layer's pool (in place,
    quantized when per-layer packed scale pools `kv_scales` are given) and
    attends over it with the paged decode.  Returns (logits [B, V] f32,
    kv_pages, context_lens + 1), and kv_scales fourth when quantized.
    `attention` is the paged decode; a reference run passes its plain
    version (ops.paged_fused.paged_attention_fused_plain).  `lora` /
    `lora_idx` [B]: the adapters (llama.forward's).  With `mesh` (JAX
    l.222-306): `params` are this rank's shards and each fused pool holds
    its heads, [P, 2, H/tp, page, Dpad] (scale tiles packing its local
    heads), as llama.decode_step_fused(mesh=)'s."""
    del rope_cos, rope_sin
    tp = _tensor_parallel(cfg, mesh, model_axis, lora=lora)
    if tp is not None:
        cfg = tp.cfg
    dev = params["wte"].device
    x = _embed(params, token.to(dev), positions.to(dev), cfg)
    lens_out = context_lens
    for li, layer in enumerate(params["layers"]):
        ll = _lora_at(lora, li)
        sc = None if kv_scales is None else kv_scales[li]
        h = _enter(tp, layer_norm(x, layer["ln1_g"], layer["ln1_b"],
                                  cfg.norm_eps))
        w, bias = layer["w_qkv"], layer["qkv_b"]
        q, k, v = ((_lora_proj(h, w[i], ll, name, lora_idx)
                    + bias[i]).reshape(-1, cfg.n_heads, cfg.head_dim)
                   for i, name in enumerate(_QKV))
        lens_out = kv_cache_append_decode_fused(
            kv_pages[li], k, v, block_tables, context_lens,
            kv_scales=sc)[-1]
        attn = attention(q, kv_pages[li], block_tables, lens_out,
                         kv_scales=sc)
        x = x + _proj(layer, attn.reshape(-1, cfg.n_heads * cfg.head_dim),
                      tp, ll, lora_idx)
        x = _mlp(layer, x, cfg, tp)
    logits = _logits(params, x, cfg)
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
    cfg: GPT2Config,
    rope_cos=None,                       # unused (learned positions)
    rope_sin=None,
    kv_scales: Optional[Sequence[torch.Tensor]] = None,
    mesh=None,
    model_axis: str = "model",
    *,
    all_logits: bool = False,
    attention: Callable = paged_attention_prefill,
    lora=None,
    lora_idx: Optional[torch.Tensor] = None,
):
    """One chunk of chunked prefill over the fused pools
    (llama.prefill_step_fused's signature): append the chunk's K/V (in
    place, quantized when `kv_scales` are given), then attend to cache
    history plus chunk.  Returns (logits, kv_pages, q_offsets + seq_lens),
    and kv_scales fourth when quantized.  Logits are [B, V] f32 for each
    sequence's last valid chunk token, or [B, S, V] with all_logits=True.
    `attention` is the paged prefill; a reference run passes its plain
    version (ops.paged_prefill.paged_attention_prefill_plain).  `lora` /
    `lora_idx` [B]: the adapters (llama.forward's).  With `mesh` (JAX
    l.307-397): this rank's shards and pools, as decode_step_fused's."""
    del rope_cos, rope_sin
    tp = _tensor_parallel(cfg, mesh, model_axis, lora=lora)
    if tp is not None:
        cfg = tp.cfg
    _, s_chunk = tokens.shape
    dev = params["wte"].device
    q_offsets = q_offsets.to(dev)
    seq_lens = seq_lens.to(dev)
    positions = (q_offsets.long()[:, None]
                 + torch.arange(s_chunk, device=dev)[None, :])
    x = _embed(params, tokens.to(dev), positions, cfg)
    lens_out = q_offsets + seq_lens
    for li, layer in enumerate(params["layers"]):
        ll = _lora_at(lora, li)
        sc = None if kv_scales is None else kv_scales[li]
        h = _enter(tp, layer_norm(x, layer["ln1_g"], layer["ln1_b"],
                                  cfg.norm_eps))
        q, k, v = _qkv(layer, h, cfg, ll, lora_idx)
        lens_out = kv_cache_append_prefill_fused(
            kv_pages[li], k, v, block_tables, q_offsets, seq_lens,
            kv_scales=sc)[-1]
        attn = attention(q, kv_pages[li], block_tables, lens_out,
                         q_offsets=q_offsets, kv_scales=sc, causal=True)
        x = x + _proj(layer, _merge(attn), tp, ll, lora_idx)
        x = _mlp(layer, x, cfg, tp)
    if not all_logits:
        # only the last valid row of each sequence is ever sampled
        last = (seq_lens.long() - 1).clamp_min(0)
        x = x[torch.arange(x.shape[0], device=dev), last]
    logits = _logits(params, x, cfg)
    if kv_scales is not None:
        return logits, kv_pages, lens_out, kv_scales
    return logits, kv_pages, lens_out
