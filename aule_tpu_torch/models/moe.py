"""Mixture-of-Experts Llama, Mixtral-style (counterpart of
aule_tpu/models/moe.py, its single-device forms).

The attention stack is models/llama.py's (the flash kernels, RoPE, GQA,
the paged decode and prefill); each layer's MLP becomes a top-k routed
mixture of SwiGLU experts:

  router: [dim, E] linear; each token keeps its top_k experts, whose
          logits are softmaxed into gates summing to 1 (ties go to the
          lower expert index, as jax.lax.top_k's);
  expert: SwiGLU (e_gate, e_up, e_down), the E copies stacked on a
          leading [E] dim.

`forward`, `decode_step_fused` and `prefill_step_fused` evaluate the dense
mixture (`_moe_mlp_dense`: every expert on every token, weighted by the
gates, zero off the top k; exact, JAX's single-device oracle form), or a
`moe_mlp(layer, x, cfg)` the caller passes.  Rounding follows JAX's
(l.122-138): the gate is silu of the f32 product, gate times up is f32 and
is cast to x's dtype before `@ e_down`, and the gate-weighted sum over the
experts is f32.

Expert parallelism (JAX l.87-110, 211-291): `make_expert_parallel_mlp`
is the GShard capacity dispatch over an `expert` mesh axis.  Tokens are
replicated over the axis; every rank gates all of them (the same top-k),
places each (token, expert) pair at its position in the expert's bucket
of `expert_capacity` slots (a cumulative sum over the tokens; a pair past
the capacity drops, as JAX's), gathers its E/n local experts' buckets
[E/n, C, dim], runs them, and scatters the gate-weighted outputs back; one
all-reduce (psum) over the axis combines the ranks.  The products are
einsums and matmuls, as JAX computes them outside Pallas.  `param_specs
(expert_axis=)` shards the experts' leading [E] dim, and `shard_params`
cuts a rank's shards from the full params.  Tensor parallelism (`mesh=`
on forward and the serving steps): the attention is llama's
tensor-parallel island (heads over `model_axis`) and the experts stay
replicated, as JAX's param_specs(expert_axis=None) place them.
`lora=` / `lora_idx=` put multi-LoRA adapters on the
attention's wq, wk, wv and wo, as llama's (JAX l.169-188); with a mesh
they raise, as llama's.
ServingEngine(model=moe)
serves it over fused pools (it has no decode over split pools, nor has
JAX's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..config import resolve_device
from ..ops.flash_vjp import flash_attention_vjp
from ..ops.paged_fused import paged_attention_fused
from ..ops.paged_prefill import paged_attention_prefill
from ..parallel.collectives import enter_region, psum
from ..parallel.mesh import axis_index, axis_size, map_specs, shard
from ..utils.tree import tree_flatten
from . import llama

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig(llama.LlamaConfig):
    n_experts: int = 8
    top_k: int = 2

    @classmethod
    def tiny(cls, **kw) -> "MoEConfig":
        """Test-sized config (the JAX package's MoEConfig.tiny())."""
        defaults = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                        n_kv_heads=2, hidden_dim=128, rope_base=10000.0,
                        dtype=torch.float32, n_experts=4, top_k=2)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def mixtral_8x7b(cls) -> "MoEConfig":
        """Mixtral-8x7B's shape (mistralai/Mixtral-8x7B-v0.1): 32 layers,
        8 experts, top 2, GQA 32 / 8 heads, RoPE theta 1e6."""
        return cls(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, hidden_dim=14336, rope_base=1e6,
                   n_experts=8, top_k=2)


def init_params(cfg: MoEConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random parameters: Llama's attention weights and norms, and per
    layer a router and E experts, every matrix N(0, 1/fan_in) in f32 cast
    to cfg.dtype (the JAX init's scales), norms one.  `generator` must
    live on `device`."""
    dev = resolve_device(device)

    def dense(fan_in, shape):
        return llama._dense(generator, dev, cfg.dtype, fan_in, shape)

    def ones():
        return torch.ones((cfg.dim,), dtype=torch.float32, device=dev)

    d, h, e = cfg.dim, cfg.hidden_dim, cfg.n_experts
    qkv_dim = cfg.n_heads * cfg.head_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "wq": dense(d, (d, qkv_dim)),
            "wk": dense(d, (d, kv_dim)),
            "wv": dense(d, (d, kv_dim)),
            "wo": dense(qkv_dim, (qkv_dim, d)),
            "attn_norm": ones(),
            "mlp_norm": ones(),
            "router": dense(d, (d, e)),
            "e_gate": dense(d, (e, d, h)),
            "e_up": dense(d, (e, d, h)),
            "e_down": dense(h, (e, h, d)),
        })
    return {"embed": dense(1, (cfg.vocab_size, d)), "layers": layers,
            "final_norm": ones(), "lm_head": dense(d, (d, cfg.vocab_size))}


def param_specs(cfg: MoEConfig, expert_axis: Optional[str] = None,
                model_axis: Optional[str] = "model") -> Dict[str, Any]:
    """Specs (JAX l.87-110; tuples, see parallel/mesh.py): the attention
    shards as llama's over `model_axis` (None: replicated), the experts'
    leading [E] dim over `expert_axis` when given; the router, norms and
    embedding replicate."""
    ex, mo = expert_axis, model_axis
    layer = {
        "wq": (None, mo), "wk": (None, mo), "wv": (None, mo),
        "wo": (mo, None),
        "attn_norm": (None,), "mlp_norm": (None,),
        "router": (None, None),
        "e_gate": (ex, None, None), "e_up": (ex, None, None),
        "e_down": (ex, None, None),
    }
    return {
        "embed": (None, None),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "final_norm": (None,),
        "lm_head": (None, mo),
    }


def shard_params(params: Params, cfg: MoEConfig, mesh,
                 model_axis: Optional[str] = "model",
                 expert_axis: Optional[str] = None) -> Params:
    """This rank's shards of the full params under `param_specs(cfg,
    expert_axis, model_axis)`: what `mesh=` steps (model_axis) and an
    expert-parallel forward (expert_axis, model_axis=None) take."""
    return map_specs(lambda spec, t: shard(t, mesh, spec),
                     param_specs(cfg, expert_axis, model_axis), params)


def load_jax_params(np_tree: Params, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX package's MoE params (`jax.tree.map(np.asarray, params)`)
    on `device`: `router`, `e_gate`, `e_up` and `e_down` carried across
    with the attention weights, recast to `dtype` when given; norms stay
    f32."""
    return llama.load_jax_params(np_tree, device=device, dtype=dtype)


def _gating(layer, x: torch.Tensor, cfg: MoEConfig):
    """(weights [T, E] f32 with top_k nonzeros summing to 1, router logits
    [T, E] f32) for x [T, dim].  A stable descending sort gives ties to the
    lower expert index, as jax.lax.top_k does (torch.topk promises no
    order among equal values)."""
    logits = (x @ layer["router"]).float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :cfg.top_k], dim=-1)
    weights = torch.zeros_like(logits).scatter(-1, idx[:, :cfg.top_k], gates)
    return weights, logits


def _expert_mlp(eg, eu, ed, x: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on x [T, dim] with [E, dim, hid] weights ->
    [E, T, dim] in x's dtype."""
    gate = F.silu((x @ eg).float())
    return (gate * (x @ eu).float()).to(x.dtype) @ ed


def _moe_mlp_dense(layer, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """The mixture on x [B, S, dim]: every expert on every token, summed
    in f32 with the gate weights (zero off each token's top k)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    weights, _ = _gating(layer, xt, cfg)
    outs = _expert_mlp(layer["e_gate"], layer["e_up"], layer["e_down"], xt)
    y = torch.einsum("etd,te->td", outs.float(), weights)
    return y.to(x.dtype).reshape(b, s, d)


def _block(mlp: Callable, aux: Optional[list] = None, tp=None) -> Callable:
    """The MLP block llama's layer loops take, `x + MLP(rms_norm(x))`,
    around the mixture `mlp(layer, h [B, S, dim], cfg)`; with `aux`, each
    layer also appends its load-balancing term, E * sum_e frac_e * prob_e
    on the router's inputs (JAX l.190-194: means over the whole batch, so
    over the data ranks' rows under the mesh view `tp`)."""

    def mean_rows(t):
        t = t.mean(dim=0)
        if tp is None or tp.data_axis is None:
            return t
        return psum(t, tp.data_axis, tp.mesh) / axis_size(tp.mesh,
                                                          tp.data_axis)

    def block(x, layer, cfg):
        h = llama.rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        if aux is not None:
            w, rl = _gating(layer, h.reshape(-1, cfg.dim), cfg)
            frac = mean_rows((w > 0).float())
            prob = mean_rows(torch.softmax(rl, dim=-1))
            aux.append(cfg.n_experts * (frac * prob).sum())
        if x.dim() == 2:  # a decode step's [B, dim]
            return x + mlp(layer, h[:, None, :], cfg)[:, 0]
        return x + mlp(layer, h, cfg)

    return block


def forward(
    params: Params,
    tokens: torch.Tensor,          # [B, S] int
    cfg: MoEConfig,
    *,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    return_kv: bool = False,
    return_aux: bool = False,
    moe_mlp: Optional[Callable] = None,
    mesh=None,
    data_axis: str = "data",
    model_axis: str = "model",
    lora=None,
    lora_idx=None,
    attention: Callable = flash_attention_vjp,
):
    """Causal-LM forward: logits [B, S, V] f32; with return_kv also the
    per-layer rotated k and unrotated v (llama.forward's), with return_aux
    also the load-balancing loss, the mean over layers of E * sum_e frac_e
    * prob_e.  `attention`, `lora` and `lora_idx` as llama.forward's.
    With `mesh`: `params` are this rank's shards (`shard_params`), the
    attention is llama's tensor-parallel island and the batch shards over
    `data_axis` (llama.forward(mesh=)'s), the mixture runs on the
    replicated experts."""
    tp = llama._tensor_parallel(cfg, mesh, model_axis, data_axis, lora)
    aux: list = []
    out = llama._forward(params, tokens, cfg, rope_cos, rope_sin, return_kv,
                         attention, _block(moe_mlp or _moe_mlp_dense,
                                           aux if return_aux else None, tp),
                         lora, lora_idx, tp)
    if not return_aux:
        return out
    total = 0.0
    for a in aux:
        total = total + a
    out = out if isinstance(out, tuple) else (out,)
    return out + (total / cfg.n_layers,)


def loss_fn(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
            moe_mlp: Optional[Callable] = None, aux_weight: float = 1e-2, *,
            attention: Callable = flash_attention_vjp) -> torch.Tensor:
    """Mean next-token NLL of `tokens` [B, S] plus aux_weight times the
    load-balancing loss (JAX l.294-302), a 0-d f32 tensor."""
    logits, aux = forward(params, tokens[:, :-1], cfg, moe_mlp=moe_mlp,
                          return_aux=True, attention=attention)
    targets = tokens[:, 1:].to(logits.device)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          targets.reshape(-1))
    return nll + aux_weight * aux


def train_step(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
               lr: float = 1e-4, moe_mlp: Optional[Callable] = None):
    """One SGD step, in place, as llama.train_step's.  Returns (params,
    the loss before the update)."""
    return params, llama._sgd_step(
        tree_flatten(params), lambda: loss_fn(params, tokens, cfg, moe_mlp),
        lr)


def decode_step_fused(
    params: Params,
    token: torch.Tensor,                 # [B] int
    positions: torch.Tensor,             # [B] int
    kv_pages: Sequence[torch.Tensor],    # per-layer fused pools
    block_tables: torch.Tensor,          # [B, max_pages] int32
    context_lens: torch.Tensor,          # [B] int32, BEFORE this token
    cfg: MoEConfig,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    kv_scales: Optional[Sequence[torch.Tensor]] = None,
    mesh=None,
    model_axis: str = "model",
    moe_mlp: Optional[Callable] = None,
    lora=None,
    lora_idx=None,
    *,
    attention: Callable = paged_attention_fused,
):
    """One decode step over fused pools with the routed MLP: llama's
    append and paged decode (the decode kernel), then the mixture on the
    [B, 1, dim] stream, with the adapters `lora` / `lora_idx` as llama's.
    Returns as llama.decode_step_fused.  With `mesh`: this rank's shards
    and pools of its kv heads, as llama.decode_step_fused(mesh=)'s."""
    tp = llama._tensor_parallel(cfg, mesh, model_axis, lora=lora)
    return llama._decode_fused(
        params, token, positions, kv_pages, block_tables, context_lens, cfg,
        rope_cos, rope_sin, kv_scales, attention,
        _block(moe_mlp or _moe_mlp_dense), lora, lora_idx, tp)


def prefill_step_fused(
    params: Params,
    tokens: torch.Tensor,                # [B, S_chunk] int
    q_offsets: torch.Tensor,             # [B]
    seq_lens: torch.Tensor,              # [B]
    kv_pages: Sequence[torch.Tensor],    # per-layer fused pools
    block_tables: torch.Tensor,          # [B, max_pages] int32
    cfg: MoEConfig,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    kv_scales: Optional[Sequence[torch.Tensor]] = None,
    mesh=None,
    model_axis: str = "model",
    moe_mlp: Optional[Callable] = None,
    all_logits: bool = False,
    lora=None,
    lora_idx=None,
    *,
    attention: Callable = paged_attention_prefill,
):
    """One chunk of chunked prefill over fused pools with the routed MLP
    (llama.prefill_step_fused's append and paged prefill, the prefill
    kernel), with the adapters `lora` / `lora_idx` as llama's.  Returns as
    llama.prefill_step_fused, all_logits included.  With `mesh`: as
    decode_step_fused's."""
    tp = llama._tensor_parallel(cfg, mesh, model_axis, lora=lora)
    return llama._prefill_fused(
        params, tokens, q_offsets, seq_lens, kv_pages, block_tables, cfg,
        rope_cos, rope_sin, kv_scales, all_logits, attention,
        _block(moe_mlp or _moe_mlp_dense), lora, lora_idx, tp)


def _dispatch_tensors(weights: torch.Tensor, capacity: int):
    """(dispatch [T, E, C] one-hot, combine [T, E, C] gate-weighted) of
    the gate weights [T, E] (JAX l.211-224): a (token, expert) pair's slot
    is its position among the expert's tokens (a cumulative sum over T);
    pairs at or past `capacity` drop."""
    assign = (weights > 0.0).to(torch.int64)
    pos = torch.cumsum(assign, dim=0) * assign - 1      # -1: not assigned
    keep = (assign == 1) & (pos < capacity)
    slot = torch.where(keep, pos, torch.full_like(pos, capacity))
    dispatch = F.one_hot(slot, capacity + 1)[..., :capacity].float()
    return dispatch, dispatch * weights[..., None]


def expert_capacity(tokens: int, cfg: MoEConfig,
                    capacity_factor: float = 2.0) -> int:
    """Slots per expert (JAX l.226-230): ceil(T k / E * factor), at least
    k."""
    c = int(math.ceil(tokens * cfg.top_k / cfg.n_experts * capacity_factor))
    return max(c, cfg.top_k)


def make_expert_parallel_mlp(mesh, cfg: MoEConfig, *,
                             expert_axis: str = "expert",
                             capacity_factor: float = 2.0) -> Callable:
    """moe_mlp(layer, x [B, S, dim], cfg) with this rank's E/n experts in
    `layer` (`shard_params(expert_axis=)`) and x the same on every rank
    (JAX l.232-279): the capacity dispatch of the module docstring, one
    psum over `expert_axis`.  mesh=None runs every expert on this device:
    the same capacity mixture without the psum (the plain version an
    expert-parallel run is held to).  Differentiable: x and the router
    enter the expert axis (each rank's partial gradient summed once)."""
    n_ex = 1 if mesh is None else axis_size(mesh, expert_axis)
    if cfg.n_experts % n_ex:
        raise ValueError(f"n_experts {cfg.n_experts} % {n_ex} != 0")
    e_local = cfg.n_experts // n_ex

    def enter(t):
        return t if mesh is None else enter_region(t, expert_axis, mesh)

    def moe_mlp(layer, x, cfg_):
        del cfg_
        b, s, d = x.shape
        xt = enter(x.reshape(b * s, d))
        weights, _ = _gating({"router": enter(layer["router"])}, xt, cfg)
        dispatch, combine = _dispatch_tensors(
            weights, expert_capacity(b * s, cfg, capacity_factor))
        lo = 0 if mesh is None else axis_index(mesh, expert_axis) * e_local
        buckets = torch.einsum("tec,td->ecd", dispatch[:, lo:lo + e_local],
                               xt.float()).to(x.dtype)   # [E/n, C, d]
        outs = _expert_mlp(layer["e_gate"], layer["e_up"], layer["e_down"],
                           buckets)
        y = torch.einsum("ecd,tec->td", outs.float(),
                         combine[:, lo:lo + e_local])
        if mesh is not None:
            y = psum(y, expert_axis, mesh)
        return y.to(x.dtype).reshape(b, s, d)

    return moe_mlp


def make_expert_parallel_forward(mesh, cfg: MoEConfig,
                                 expert_axis: str = "expert",
                                 capacity_factor: float = 2.0) -> Callable:
    """fn(params, tokens) -> logits (JAX l.282-291): forward with the
    expert-parallel mixture; `params` are this rank's shards under
    `shard_params(expert_axis=expert_axis, model_axis=None)` (the
    attention replicated, the rank's experts)."""
    mlp = make_expert_parallel_mlp(mesh, cfg, expert_axis=expert_axis,
                                   capacity_factor=capacity_factor)

    def fn(params, tokens):
        return forward(params, tokens, cfg, moe_mlp=mlp)

    return fn
