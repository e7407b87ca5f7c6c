"""Pipeline parallelism: a Llama's layers sharded over a `pipe` mesh axis
(counterpart of aule_tpu/parallel/pipeline.py).

GPipe: stage s holds layers [s L/P, (s+1) L/P) of the stacked params
(`stack_layer_params`: one [n_layers, ...] tensor per weight, its layer
dim cut over `pipe` by `shard_params`), and M microbatches run through the
stages in M + P - 1 ticks.  At tick t stage s runs microbatch t - s when
there is one (the bubble fraction is (P-1)/(M+P-1), as in JAX), then every
stage hands its output to the next by point-to-point (collectives.py's
ppermute, staged through host memory under gloo).  The last stage's
outputs are all-reduced over `pipe` from it and zeros elsewhere (exact:
JAX's psum of the masked outputs), so every stage holds them, and each
applies the final norm and the head.

The backward runs the reverse schedule explicitly (`_Schedule`): the
forward keeps each stage's graph per microbatch, and at reverse tick t
stage s back-propagates microbatch t - s with the cotangent its successor
sent at tick t + 1 (the last stage: the cotangent of its outputs), then
sends the cotangent of its input to its predecessor.  Each tick's exchange
is one call on every stage, so the stages stay in lockstep.  JAX gets the
same schedule from jax.grad through its scan and ppermute.  The embedding
is replicated: stage 0's cotangent of the embeddings is all-reduced over
`pipe` (zeros elsewhere), so every stage holds its full gradient, as the
convention of collectives.py asks.

A stage's block is llama's (`llama._layer`), its attention
`flash_attention_vjp` (the flash forward and backward kernels on the
card, their plain versions on CPU tensors).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import resolve_device
from ..models import llama
from ..ops.flash_vjp import flash_attention_vjp
from ..ops.rope import precompute_rope_frequencies
from ..utils.tree import tree_flatten, tree_map
from .collectives import _all_reduce, _ppermute
from .mesh import axis_index, axis_size, map_specs, shard

Params = Dict[str, Any]

LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "attn_norm", "mlp_norm")


def stack_layer_params(params: Params) -> Params:
    """llama params -> the same dict with `layers` as one dict of
    [n_layers, ...] tensors (JAX l.40-48)."""
    layers = params["layers"]
    out = dict(params)
    out["layers"] = {k: torch.stack([lay[k] for lay in layers])
                     for k in layers[0]}
    return out


def unstack_layer_params(params: Params) -> Params:
    """Inverse of stack_layer_params (JAX l.51-58); each layer's tensors
    are views of the stacked ones."""
    stacked = params["layers"]
    n = next(iter(stacked.values())).shape[0]
    out = dict(params)
    out["layers"] = [{k: v[i] for k, v in stacked.items()}
                     for i in range(n)]
    return out


def pipeline_param_specs(pipe_axis: str = "pipe") -> Dict[str, Any]:
    """Specs of the stacked params (JAX l.61-77): the layer dim on
    `pipe`, the embedding, final norm and head replicated."""
    nd = {k: 1 if k.endswith("norm") else 2 for k in LAYER_KEYS}
    return {
        "embed": (None, None),
        "layers": {k: (pipe_axis,) + (None,) * n for k, n in nd.items()},
        "final_norm": (None,),
        "lm_head": (None, None),
    }


def shard_params(stacked: Params, mesh, pipe_axis: str = "pipe") -> Params:
    """This stage's shards of the full stacked params: its layers'
    slices of each stacked tensor, the replicated rest as given."""
    return map_specs(lambda spec, t: shard(t, mesh, spec),
                     pipeline_param_specs(pipe_axis), stacked)


def load_jax_params(np_tree: Params, device="cuda") -> Params:
    """The JAX package's stacked params (its stack_layer_params, converted
    by the caller with `jax.tree.map(np.asarray, ...)`) as the port's
    stacked params on `device`, each in its own dtype."""
    dev = resolve_device(device)
    return tree_map(lambda a: llama._to_torch(a, dev, None), np_tree)


class _Stage:
    """What a stage's schedule needs besides its tensors."""

    def __init__(self, mesh, pipe_axis, cfg, rope):
        self.group = mesh.get_group(pipe_axis)
        self.n = axis_size(mesh, pipe_axis)
        self.s = axis_index(mesh, pipe_axis)
        self.cfg, self.rope = cfg, rope

    def run(self, weights, names, x):
        """The stage's layers on x [mb, S, dim] (JAX l.80-101)."""
        layers = dict(zip(names, weights))
        for i in range(weights[0].shape[0]):
            x, _ = llama._layer(x, {k: v[i] for k, v in layers.items()},
                                self.cfg, *self.rope, flash_attention_vjp,
                                llama._mlp)
        return x

    def exchange(self, t: torch.Tensor, step: int) -> torch.Tensor:
        """Every stage sends `t` to stage s + step and returns what stage
        s - step sent (zeros at the ends)."""
        perm = [(i, i + step) for i in range(self.n) if 0 <= i + step < self.n]
        return _ppermute(t, perm, self.group)


class _Schedule(torch.autograd.Function):
    """GPipe over the stages: (embeddings [M, mb, S, dim], the stage's
    stacked weights) -> the last stage's outputs [M, mb, S, dim] on every
    stage; the backward runs the reverse schedule (module docstring)."""

    @staticmethod
    def forward(ctx, stage: _Stage, names, embeds, *weights):
        record = any(ctx.needs_input_grad[2:])
        m_count, last = embeds.shape[0], stage.s == stage.n - 1
        local = [w.detach().requires_grad_(record) for w in weights]
        saved = {}
        outs = torch.zeros_like(embeds)
        x = torch.zeros_like(embeds[0])
        for t in range(m_count + stage.n - 1):
            m = t - stage.s
            send = torch.zeros_like(x)
            if 0 <= m < m_count:
                inp = embeds[m] if stage.s == 0 else x
                if record:
                    inp = inp.detach().requires_grad_(True)
                    with torch.enable_grad():
                        y = stage.run(local, names, inp)
                    saved[m] = (inp, y)
                else:
                    y = stage.run(local, names, inp)
                if last:
                    outs[m] = y.detach()
                send = y.detach()
            x = stage.exchange(send, 1)
        ctx.stage, ctx.saved, ctx.local = stage, saved, local
        ctx.shape = embeds.shape
        return _all_reduce(outs, dist.ReduceOp.SUM, stage.group)

    @staticmethod
    def backward(ctx, g_outs):
        stage, saved, local = ctx.stage, ctx.saved, ctx.local
        m_count, last = ctx.shape[0], stage.s == stage.n - 1
        g_embeds = g_outs.new_zeros(ctx.shape)
        g_recv = g_outs.new_zeros(ctx.shape[1:])
        for t in reversed(range(m_count + stage.n - 1)):
            m = t - stage.s
            send = torch.zeros_like(g_recv)
            if 0 <= m < m_count:
                inp, y = saved.pop(m)
                gy = g_outs[m] if last else g_recv
                torch.autograd.backward(y, gy.to(y.dtype),
                                        inputs=[inp] + local)
                if stage.s == 0:
                    g_embeds[m] = inp.grad
                else:
                    send = inp.grad
                del inp, y
            g_recv = stage.exchange(send, -1)
        grads = [w.grad if w.grad is not None else torch.zeros_like(w)
                 for w in local]
        ctx.local = None
        g_embeds = _all_reduce(g_embeds, dist.ReduceOp.SUM, stage.group)
        return (None, None, g_embeds, *grads)


def make_pipeline_forward(mesh, cfg: llama.LlamaConfig, *, microbatches: int,
                          pipe_axis: str = "pipe"):
    """Pipelined causal-LM forward (JAX l.104-183): fn(stacked params of
    this stage (`shard_params`), tokens [B, S], the same on every stage) ->
    logits [B, S, V] f32 on every stage.  B must divide into
    `microbatches`; the layers must divide over the pipe axis.
    Differentiable: backward of each stage's copy of one loss gives the
    stage's layers' gradients and the full gradients of the replicated
    params."""
    n_pipe = axis_size(mesh, pipe_axis)
    if cfg.n_layers % n_pipe:
        raise ValueError(f"n_layers {cfg.n_layers} % pipe {n_pipe} != 0")

    def fn(params, tokens):
        b, s = tokens.shape
        if b % microbatches:
            raise ValueError(f"batch {b} % microbatches {microbatches}")
        dev = params["embed"].device
        rope = precompute_rope_frequencies(s, cfg.head_dim, cfg.rope_base,
                                           device=dev)
        stage = _Stage(mesh, pipe_axis, cfg, rope)
        toks = tokens.to(dev).reshape(microbatches, b // microbatches, s)
        names = sorted(params["layers"])
        outs = _Schedule.apply(stage, names, params["embed"][toks],
                               *[params["layers"][k] for k in names])
        h = llama.rms_norm(outs, params["final_norm"], cfg.norm_eps)
        return (h @ params["lm_head"]).float().reshape(b, s, cfg.vocab_size)

    return fn


def make_pipeline_train_step(mesh, cfg: llama.LlamaConfig, *,
                             microbatches: int, lr: float = 1e-4,
                             pipe_axis: str = "pipe"):
    """Pipelined SGD step on a stage's stacked params (JAX l.186-215):
    step(params, tokens) -> (params, loss), the mean next-token NLL before
    the update, the same on every stage.  As llama.train_step, every
    tensor is updated in place, p <- p - lr * grad in f32 and rounded once
    to its dtype, and each .grad freed after its update."""
    fwd = make_pipeline_forward(mesh, cfg, microbatches=microbatches,
                                pipe_axis=pipe_axis)

    def loss_of(params, tokens):
        logits = fwd(params, tokens[:, :-1])
        targets = tokens[:, 1:].to(logits.device)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))

    def step(params, tokens):
        return params, llama._sgd_step(
            tree_flatten(params), lambda: loss_of(params, tokens), lr)

    return step

