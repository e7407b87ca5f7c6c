"""Timing and roofline helpers on the card (counterpart of
aule_tpu/utils/profiling.py).

Kernel times come from CUDA events around each launch after a warm-up:
the median of the timed repeats with its spread (min, max).  FLOPs follow
the JAX package's convention, 4*B*H*Sq*Sk*D, halved for causal, and 2.5x
that for the backward (bench.py:136); a paged prefill chunk or a window
counts the keys its rows see; a train step adds 6*N*tokens.  Bounds
use the published peaks of one NVIDIA H100 SXM at its full 700 W power
limit (NVIDIA's data sheet, dense rates).  There is no CPU fallback: a
measurement without a card raises.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Sequence, Tuple

import torch

H100_BF16_FLOPS = 989e12     # dense tensor-core bf16 / fp16, FLOP/s
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, FLOP/s
H100_TF32_FLOPS = 495e12     # dense tensor-core TF32, FLOP/s
# an f32 product in 3xTF32 (three TF32 products, csrc/flash_f32.cu)
H100_3XTF32_FLOPS = H100_TF32_FLOPS / 3
H100_HBM_BYTES = 3.35e12     # HBM3 bytes/s


def attention_flops(batch: int, heads: int, seq_q: int, seq_k: int,
                    head_dim: int, causal: bool = False) -> float:
    """4*B*H*Sq*Sk*D, halved for causal."""
    flops = 4.0 * batch * heads * seq_q * seq_k * head_dim
    return flops * 0.5 if causal else flops


def attention_bwd_flops(fwd_flops: float, products: int = 5) -> float:
    """Backward FLOPs from the forward's (its 2 products over the live
    keys): the whole backward is 5 products (S, dP, dV, dK, dQ), 2.5x the
    forward (bench.py:136); the dQ kernel alone needs 3 (S, dP, dQ) and the
    dK/dV kernel 4 (S, dP, dV, dK), since each recomputes S and dP."""
    return products / 2 * fwd_flops


def window_attention_flops(batch: int, heads: int, seq: int, head_dim: int,
                           window: int, causal: bool = True) -> float:
    """4 * B * H * D * (live (q, k) pairs) of self-attention over `seq`
    tokens with a window W: q - W <= k <= q causal, |q - k| <= W
    otherwise."""
    pairs = 0
    for q in range(seq):
        lo = max(0, q - window)
        hi = q if causal else min(seq - 1, q + window)
        pairs += hi - lo + 1
    return 4.0 * batch * heads * head_dim * pairs


def train_step_flops(matmul_params: int, tokens: int,
                     attention_fwd_flops: float) -> float:
    """One training step: 6 * N * tokens for the dense layers (N = the
    parameters of the matrix products: forward 2, backward 4 per
    parameter and token), plus the attention forward and its backward
    (2.5x): 3.5x the forward attention FLOPs."""
    return 6.0 * matmul_params * tokens + 3.5 * attention_fwd_flops


def paged_kv_bytes(tokens: int, hkv: int, head_dim: int,
                   payload_bytes: int, scale_bytes: int = 0) -> float:
    """Bytes of the K and V of `tokens` cached tokens that attention must
    read, in a fused or a split pool: the payload of both, plus, for a
    quantized pool (`scale_bytes` per scale), each token's K and V scale of
    every kv head.  A fused pool's packed row holds them in lanes h and
    64 + h (bf16, scale_bytes=2; the unused lanes are not needed); split
    pools hold them in their f32 [Hkv, P, page] scale tensors
    (scale_bytes=4)."""
    return float(tokens * 2 * hkv * (head_dim * payload_bytes + scale_bytes))


def paged_prefill_flops(q_offsets: Sequence[int], chunk_lens: Sequence[int],
                        heads: int, head_dim: int,
                        window: int = -1) -> float:
    """4 * H * D * (visible keys summed over the live rows) of a causal
    chunk over its history: the row at absolute position p sees p + 1
    cache positions, or W + 1 with a window W."""
    keys = 0
    for off, n in zip(q_offsets, chunk_lens):
        for p in range(off, off + n):
            keys += min(p + 1, window + 1) if window > 0 else p + 1
    return 4.0 * heads * head_dim * keys


def bound_ms(bytes_moved: float, flops: float,
             flop_rate: float = H100_BF16_FLOPS,
             byte_rate: float = H100_HBM_BYTES) -> Tuple[float, str]:
    """(least time in ms, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over the peak rate."""
    t_bytes = bytes_moved / byte_rate * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_time_ms(fn: Callable[[], object], *, warmup: int = 3,
                 iters: int = 20) -> Tuple[float, float, float]:
    """(median, min, max) ms of `fn()` over `iters` launches, each timed
    with its own pair of CUDA events on the current stream."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms measures on a CUDA device")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) for s, e in pairs]
    return statistics.median(times), min(times), max(times)


def device_breakdown(fn: Callable[[], object],
                     categories: Dict[str, Sequence[str]]) -> dict:
    """Run `fn()` once under torch.profiler (CPU and CUDA activity) and
    read the card's timeline: the wall time under the profiler, the device
    busy time (union of kernel intervals), and kernel time summed by
    category (the first category with a substring of the lower-cased
    kernel name; the rest is "other") and the kernels counted in each.
    All times in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_breakdown measures on a CUDA device")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    by_cat = {name: 0.0 for name in categories}
    by_cat["other"] = 0.0
    n_cat = dict.fromkeys(by_cat, 0)
    by_kernel: Dict[str, float] = {}
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        low = name.lower()
        cat = next((c for c, keys in categories.items()
                    if any(k in low for k in keys)), "other")
        by_cat[cat] += (stop - start) / 1e3
        n_cat[cat] += 1
        by_kernel[name] = by_kernel.get(name, 0.0) + (stop - start) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "busy_ms": busy_us / 1e3,
            "kernels": len(spans), "by_category_ms": by_cat,
            "kernels_by_category": n_cat, "top": top}
