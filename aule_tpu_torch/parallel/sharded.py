"""Mesh-sharded attention (counterpart of aule_tpu/parallel/sharded.py):
head-parallel, context-parallel, ring and Ulysses attention, and the
sharded paged decode over split and fused pools.

Shards in, shards out: each `make_*` returns a function that every rank
calls with ITS local shards, in the layout JAX's `in_specs` give its
shard_map'd `local_fn`, and that returns the rank's shard of the result
(JAX's `out_specs`).  `parallel.mesh.shard` / `unshard` move between full
tensors and shards.  The local cores are the port's ops, so on the card
each runs the Hopper kernels and on CPU tensors their plain versions:

  * `flash_attention_vjp` / `flash_attention_lse` (ops/flash_vjp.py): the
    flash forward (csrc/flash_fwd.cu, flash_fwd_short.cu, flash_f32.cu)
    and backward kernels (flash_bwd.cu, flash_f32_bwd.cu), the lse
    cotangent folded into delta;
  * `paged_attention(return_lse=True)` (ops/paged.py, split pools) and
    `paged_attention_fused(return_lse=True)` (ops/paged_fused.py): the
    paged decode (csrc/paged_decode.cu, paged_generic.cu).

The strategies, composable over a 2-D / 3-D mesh:

  * head parallelism (`model`): Q heads with their GQA KV heads on each
    rank, no communication inside attention;
  * context parallelism (`ctx`): KV sharded, each rank's partial (o, lse)
    merged by the softmax combine (collectives.softmax_combine_allreduce);
  * ring attention (`ctx`): KV chunks rotate by ppermute while each rank
    computes; a causal hop from source shard s to queries of shard i is
    diagonal (s == i, causal mask), full (s < i, no mask) or skipped (s >
    i: no kernel runs);
  * Ulysses (`ctx`): all-to-alls trade the sequence sharding for head
    sharding around an exact full-sequence local kernel.

Gradients follow collectives.py's convention: `loss.backward()` of each
rank's share of one global loss gives each rank the gradient of its
shards (a replicated input's gradient, the full one, on every rank), as
`jax.grad` of the shard_map'd JAX function gives the global gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import DEFAULT_MASK_VALUE
from ..ops.flash_vjp import flash_attention_lse, flash_attention_vjp
from ..ops.paged import paged_attention
from ..ops.paged_fused import paged_attention_fused
from .collectives import (all_to_all, enter_region, ppermute,
                          softmax_combine_allreduce, softmax_combine_pair)
from .mesh import axis_index, axis_size


def _check_axes(mesh, *axes) -> None:
    """ValueError for an axis name the mesh lacks (None: no axis)."""
    for a in axes:
        axis_size(mesh, a)


# ---------------------------------------------------------------------------
# head-parallel (+ data-parallel batch) prefill / training attention
# ---------------------------------------------------------------------------

def make_head_parallel_attention(
    mesh,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    window_size: int = -1,
    data_axis: str = "data",
    model_axis: str = "model",
    shard_kv_heads: bool = True,
):
    """Flash attention with heads on `model` and batch on `data` (JAX
    sharded.py:46-80).  Shards: q and the output [B/dp, Hq/tp, S, D]; k
    and v [B/dp, Hkv/tp, S, D] with shard_kv_heads (the GQA groups
    co-located: no communication, every gradient local), else [B/dp, Hkv,
    S, D] replicated over `model` (as JAX's, the local groups must then
    map onto all Hkv heads: MQA); their gradients are then summed over
    `model` once (`enter_region`)."""
    _check_axes(mesh, data_axis, model_axis)

    def local_fn(q, k, v):
        if not shard_kv_heads:
            k = enter_region(k, model_axis, mesh)
            v = enter_region(v, model_axis, mesh)
        return flash_attention_vjp(q, k, v, causal=causal, scale=scale,
                                   window_size=window_size)

    return local_fn


# ---------------------------------------------------------------------------
# context-parallel attention: KV sequence sharded, cross-shard combine
# ---------------------------------------------------------------------------

def make_context_parallel_attention(
    mesh,
    *,
    scale: Optional[float] = None,
    ctx_axis: str = "ctx",
):
    """Non-causal attention with KV sharded over `ctx_axis` (JAX
    sharded.py:83-123).  Shards: q [B, Hq, Sq, D] replicated, k and v [B,
    Hkv, Sk/n, D]; the output [B, Hq, Sq, D] replicated.  Each rank's
    partial (o, lse) over its KV shard merges by pmax + psum.

    Backward: the local core's lse cotangent (non-zero: the combine's
    weights depend on it) is folded into its delta; q enters through
    `enter_region`, so dq is each rank's partial summed over the axis
    once; dk and dv stay local to their shard."""
    _check_axes(mesh, ctx_axis)

    def local_fn(q, k, v):
        q = enter_region(q, ctx_axis, mesh)
        o, lse = flash_attention_lse(q, k, v, causal=False, scale=scale)
        o, _ = softmax_combine_allreduce(o.float(), lse, ctx_axis, mesh)
        return o.to(q.dtype)

    return local_fn


# ---------------------------------------------------------------------------
# ring attention: causal context parallelism with rotating KV chunks
# ---------------------------------------------------------------------------

class _SkipHop(torch.autograd.Function):
    """A fully masked hop: zeros and the mask LSE, no kernel.  Its
    backward hands a zero cotangent to the rotated KV chunk, so the
    chunk's rotations run backward on every rank alike."""

    @staticmethod
    def forward(ctx, q, kv):
        ctx.like = (kv.shape, kv.dtype, kv.device)
        b, h, sq, d = q.shape
        return (torch.zeros((b, h, sq, d), dtype=torch.float32,
                            device=q.device),
                torch.full((b, h, sq), DEFAULT_MASK_VALUE,
                           dtype=torch.float32, device=q.device))

    @staticmethod
    def backward(ctx, do, dlse):
        shape, dtype, dev = ctx.like
        return None, torch.zeros(shape, dtype=dtype, device=dev)


def _ring_attention_local(q, k, v, *, mesh, axis_name: str, causal: bool,
                          scale: Optional[float]):
    """One rank's ring (JAX sharded.py:126-181): q [B, Hq, Sq/n, D] and
    the rank's KV shard; at hop t the KV chunk held came from source
    shard src = (me - t) mod n and is diagonal (src == me: the local
    causal mask is the global one), fully visible (src < me) or fully
    masked (src > me: skipped, contributes the mask LSE).

    K and V rotate as ONE stacked chunk, after each hop but the last: one
    point-to-point exchange a hop, and backward the rotations form one
    chain that every rank runs in the same order (two separate chains
    could interleave differently on different ranks and pair a rank's K
    cotangent with its neighbour's V)."""
    n = axis_size(mesh, axis_name)
    me = axis_index(mesh, axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    b, h, sq, d = q.shape
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, sq), DEFAULT_MASK_VALUE, dtype=torch.float32,
                     device=q.device)
    kv = torch.stack([k, v]) if n > 1 else None
    for t in range(n):
        src = (me - t) % n
        kc, vc = (k, v) if kv is None else kv.unbind(0)
        if causal and src > me:
            o_t, lse_t = _SkipHop.apply(q, kv)
        else:
            o_t, lse_t = flash_attention_lse(
                q, kc, vc, causal=causal and src == me, scale=scale)
        o, lse = softmax_combine_pair(o, lse, o_t.float(), lse_t)
        if t + 1 < n:
            kv = ppermute(kv, axis_name, mesh, perm)
    return o.to(q.dtype)


def make_ring_attention(
    mesh,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    ctx_axis: str = "ctx",
):
    """Ring attention over `ctx_axis` (JAX sharded.py:184-213): q, k, v
    and the output sequence-sharded, [B, H, S/n, D] shards.

    Differentiable: each hop's core is the (out, lse) flash op, the pair
    combine detaches its shift, and the rotations' backward sends the KV
    cotangents back around the ring to the shard they came from."""
    _check_axes(mesh, ctx_axis)

    def local_fn(q, k, v):
        return _ring_attention_local(q, k, v, mesh=mesh, axis_name=ctx_axis,
                                     causal=causal, scale=scale)

    return local_fn


# ---------------------------------------------------------------------------
# Ulysses sequence parallelism: all-to-all head <-> sequence re-sharding
# ---------------------------------------------------------------------------

def make_ulysses_attention(
    mesh,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    window_size: int = -1,
    seq_axis: str = "ctx",
):
    """Ulysses (DeepSpeed) sequence parallelism over `seq_axis` (JAX
    sharded.py:216-287).  q, k, v arrive sequence-sharded, [B, H, S/n, D]
    shards; one all-to-all per operand re-shards heads while gathering
    the sequence ([B, H/n, S, D]), the local kernel runs exact
    full-sequence attention (causal and window masks need no chunk
    decomposition), and a final all-to-all restores the sequence
    sharding of the output.  The head counts must divide the axis
    (ValueError), and the sequence must divide it too: `mesh.shard`
    raises ValueError for a sequence that does not.

    Differentiable: the all-to-all's backward is the reverse
    all-to-all."""
    _check_axes(mesh, seq_axis)
    n = axis_size(mesh, seq_axis)

    def a2a_in(x):   # [B, h, S/n, D] -> [B, h/n, S, D]
        return all_to_all(x, seq_axis, mesh, split_axis=1, concat_axis=2)

    def local_fn(q, k, v):
        if q.shape[1] % n or k.shape[1] % n:
            raise ValueError(
                f"ulysses requires head counts divisible by the axis: "
                f"Hq={q.shape[1]}, Hkv={k.shape[1]}, |{seq_axis}|={n} "
                f"(use ring/context parallelism when heads don't split)")
        o = flash_attention_vjp(a2a_in(q), a2a_in(k), a2a_in(v),
                                causal=causal, scale=scale,
                                window_size=window_size)
        # [B, H/n, S, D] -> [B, H, S/n, D]
        return all_to_all(o, seq_axis, mesh, split_axis=2, concat_axis=1)

    return local_fn


# ---------------------------------------------------------------------------
# sharded paged decode: heads on `model`, pages on `ctx`, batch on `data`
# ---------------------------------------------------------------------------

def _local_tables(block_tables, context_lens):
    """[B, 1, max_pages] and [B, 1] shards -> [B, max_pages], [B]."""
    return (block_tables.reshape(block_tables.shape[0],
                                 block_tables.shape[-1]),
            context_lens.reshape(-1))


def make_sharded_paged_attention(
    mesh,
    *,
    scale: Optional[float] = None,
    data_axis: Optional[str] = "data",
    model_axis: Optional[str] = "model",
    ctx_axis: Optional[str] = None,
):
    """Sharded paged decode over split pools (JAX sharded.py:290-344).
    Shards (JAX's specs):
      q            [B, Hq, D]                 (data, model, None)
      k/v_pages    [Hkv, num_pages, page, D]  (model, ctx, None, None)
      block_tables [B, n_ctx, max_pages]      (data, ctx, None)
      context_lens [B, n_ctx]                 (data, ctx)
    so each rank holds [B/dp, 1, max_pages] tables and [B/dp, 1] lengths
    into its own pages.  With `ctx_axis` each rank's partial (o, lse)
    merges over it (the result in f32, as JAX's combine promotes it); a
    rank whose shard holds no token of a sequence (length 0) gives the
    mask LSE and weighs nothing.  JAX's
    `pages_per_compute_block` is a TPU tiling knob with no counterpart."""
    _check_axes(mesh, data_axis, model_axis, ctx_axis)

    def local_fn(q, k_pages, v_pages, block_tables, context_lens):
        bt, lens = _local_tables(block_tables, context_lens)
        if ctx_axis is None:
            return paged_attention(q, k_pages, v_pages, bt, lens,
                                   scale=scale)
        o, lse = paged_attention(q, k_pages, v_pages, bt, lens, scale=scale,
                                 return_lse=True)
        return softmax_combine_allreduce(o.float(), lse, ctx_axis, mesh)[0]

    return local_fn


def make_sharded_paged_attention_fused(
    mesh,
    *,
    scale: Optional[float] = None,
    data_axis: Optional[str] = "data",
    model_axis: Optional[str] = None,
    ctx_axis: Optional[str] = None,
    quantized: bool = False,
):
    """Sharded paged decode over fused pools (JAX sharded.py:347-413): the
    pool's kv-head dim shards over `model`, so each shard's pages stay
    whole fused slabs [P/n_ctx, 2, Hkv/tp, page, Dpad] and the kernel
    runs unchanged.  Shards (JAX's specs):
      q            [B, Hq, D]              (data, model, None)
      kv_pages     [P, 2, Hkv, page, Dpad] (ctx, None, model, None, None)
      block_tables [B, n_ctx, max_pages]   (data, ctx, None)
      context_lens [B, n_ctx]              (data, ctx)
      kv_scales    [P, page, tp*128]       (ctx, None, model)  (quantized:
                   each shard's 128-lane block packs its LOCAL heads,
                   as JAX's fused_scales_shape(..., tp=) lays them out)
    """
    _check_axes(mesh, data_axis, model_axis, ctx_axis)

    def local_fn(q, kv_pages, block_tables, context_lens, *maybe_scales):
        sc = maybe_scales[0] if quantized else None
        bt, lens = _local_tables(block_tables, context_lens)
        if ctx_axis is None:
            return paged_attention_fused(q, kv_pages, bt, lens, kv_scales=sc,
                                         scale=scale)
        o, lse = paged_attention_fused(q, kv_pages, bt, lens, kv_scales=sc,
                                       scale=scale, return_lse=True)
        return softmax_combine_allreduce(o.float(), lse, ctx_axis, mesh)[0]

    return local_fn
