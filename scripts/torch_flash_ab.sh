#!/bin/bash
# A/B of the PyTorch port's flash forward on one CUDA card: chip_smoke.py's
# check_flash (every case against the plain version, with its timing rows),
# one timing loop over the same forward shapes in both trees, then
# check_flash_bwd (its checks and CUDA-event times) and the backward's
# device time per call at its three timed shapes (delta, dQ, dK/dV, the
# whole backward and SDPA's backward), the bf16 forward and backward at
# the head dims 64 and 256 as flash_attention routes them (flash_generic.cu
# in trees before the tensor-core kernels took them; also at 1 and 16
# queries), then check_prefill
# (its checks and CUDA-event times) and the paged prefill's device time
# per call in each
# pool mode (bf16, int8, fp8) beside SDPA's on the gathered K/V, at the
# engine's chunk (512 queries at q_offset 3488 over 4000 cached tokens),
# then the one-query decode (the SDPA patch's bucketed decode, plain and
# with RoPE) and the 16-bit paged prefill at D 64 and 256, as each tree
# routes them, beside SDPA; then the TMA kernel's RoPE modes (S2048
# causal, RoPE + kv_len 3000 of 4096, D64 and D256 RoPE + kv_len) as each
# tree runs them, beside the plain TMA kernel at the same shape and SDPA on
# the rotated q, k; last the f32 forward as each tree routes it (flash_f32.cu's
# 3xTF32 kernel in trees that have it, else flash_generic.cu's FFMA one) at
# the Llama layer, GPT-2's layer, D256 and RoPE + kv_len, and the f32
# backward's parts as each tree routes them (flash_f32_bwd.cu's 3xTF32
# dQ and dK/dV in trees that have it, else flash_generic.cu's FFMA ones)
# at the Llama layer, GPT-2's layer and D256 group 8, beside SDPA in f32
# (the delta beside torch.linalg.vecdot of o and dO);
# then the f32-q paged prefill as each tree routes it at GPT-2's chunk in
# f32, int8 and e4m3 pools, beside SDPA.  The two trees run in turns, A, B, B, A, one process each, so that both
# versions meet the same card.  Each process builds its tree's kernels and
# prints the ptxas lines of every kernel.
#
#   git archive <commit> | tar -x -C build/parent   # a listed directory
#   scripts/torch_flash_ab.sh build/parent          # from the repo root
#
# Arguments: tree A (e.g. the parent commit), and tree B (default: the
# current directory).  The timing loop gives, per shape, the median of 20
# CUDA-event timed calls and, for the engine's short prompts (whose calls
# the host sets), the device time per launch from torch.profiler.
set -o pipefail
A=$(cd "${1:?usage: $0 TREE_A [TREE_B]}" && pwd)
B=$(cd "${2:-.}" && pwd)
run() {  # $1 = label, $2 = tree
  (cd "$2" && python3 - "$1" <<'EOF'
import sys

import torch

import chip_smoke as c
from aule_tpu_torch.ops.flash import flash_attention_fwd
from aule_tpu_torch.utils import profiling

tag = sys.argv[1]
c.phase_device()
c.phase_build()
g = torch.Generator("cuda")
g.manual_seed(c.SEED)
c.check_flash(g)
fwd = {}
for label, (b, hq, hkv), s, window in (
        ("S512", c.LAYER, 512, -1), ("S2048", c.LAYER, 2048, -1),
        ("B2 Hq16/Hkv4 S2048", (2, 16, 4), 2048, -1),
        ("S4096 W256", c.LAYER, 4096, 256),
        ("B4 S4096", (4, 32, 8), 4096, -1),
        ("S7", c.LAYER, 7, -1), ("S64", c.LAYER, 64, -1),
        ("S129", c.LAYER, 129, -1)):
    q = c._randn((b, hq, s, 128), g)
    k = c._randn((b, hkv, s, 128), g)
    v = c._randn((b, hkv, s, 128), g)
    call = lambda: flash_attention_fwd(q, k, v, causal=True,
                                       window_size=window, return_lse=False)
    ms = profiling.cuda_time_ms(call, iters=20)[0]
    bd = profiling.device_breakdown(lambda: [call() for _ in range(20)],
                                    {"flash": ["flash_fwd"]})
    fwd[label] = (round(ms, 5), round(bd["by_category_ms"]["flash"] / 20, 5))
    del q, k, v
print(f"{tag} flash fwd (events median ms, profiler device ms per launch)",
      fwd, flush=True)
_, t = c.check_flash_bwd(g)
print(f"{tag} flash bwd ms", {f"{s} {n}": round(v["ms"], 5)
                              for s, d in t.items() for n, v in d.items()},
      flush=True)
# the backward's device time per call (torch.profiler, 20 calls after one):
# delta, dQ, dK/dV, the whole backward and SDPA's backward, same tensors
import torch.nn.functional as F

from aule_tpu_torch.ops import flash_vjp as fv
from aule_tpu_torch.ops.reference import build_mask


def dev(fn):  # None where the profiler lost kernels in three tries
    fn()
    per_call = profiling.device_breakdown(fn, {})["kernels"]
    for _ in range(3):
        bd = profiling.device_breakdown(lambda: [fn() for _ in range(20)],
                                        {})
        if per_call > 0 and bd["kernels"] == 20 * per_call:
            return round(bd["busy_ms"] / 20, 5)
    return None


bwd = {}
for label, (b, hq, hkv), s, window in (
        ("S2048", c.LAYER, 2048, -1), ("B4 S2048", (4, 32, 8), 2048, -1),
        ("S4096 W256", c.LAYER, 4096, 256)):
    q, k, v, o, lse, do, _ = c._bwd_inputs(g, (b, hq, hkv), s, s, True,
                                           window, torch.bfloat16, False)
    di = fv.attention_delta(o, do)
    kw = dict(causal=True, window=window)
    qx = q.detach().requires_grad_(True)
    kx = k.repeat_interleave(hq // hkv, dim=1).requires_grad_(True)
    vx = v.repeat_interleave(hq // hkv, dim=1).requires_grad_(True)
    mask = (dict(attn_mask=build_mask(s, s, True, window, device="cuda"))
            if window > 0 else dict(is_causal=True))
    ref = F.scaled_dot_product_attention(qx, kx, vx, **mask)
    bwd[label] = {
        "delta": dev(lambda: fv.attention_delta(o, do)),
        "dq": dev(lambda: fv.flash_bwd_dq(q, k, v, do, lse, di, **kw)),
        "dkv": dev(lambda: fv.flash_bwd_dkv(q, k, v, do, lse, di, **kw)),
        "whole": dev(lambda: fv.flash_attention_bwd(q, k, v, o, lse, do,
                                                    **kw)),
        "sdpa": dev(lambda: torch.autograd.grad(ref, (qx, kx, vx), do,
                                                retain_graph=True))}
    del q, k, v, o, lse, do, di, qx, kx, vx, ref
    torch.cuda.empty_cache()
print(f"{tag} flash bwd device ms per call", bwd, flush=True)
# bf16 at the head dims 64 and 256 (GPT-2 small's layer; B1 Hq8/Hkv1 S2048,
# Gemma-2B's attention): the forward, the whole backward and its parts as
# flash_attention routes them in each tree, and the forward of 1 and 16
# queries over the layer's keys (a decode step; the short-query rule),
# device ms per call, on a generator of its own
g2 = torch.Generator("cuda")
g2.manual_seed(c.SEED + 300)
parts = {"delta": ["delta"], "dq": ["_dq_"], "dkv": ["_dkv"]}
dd = {}
for label, (b, hq, hkv), s, d in (("GPT-2 D64 S1024", (1, 12, 12), 1024, 64),
                                   ("D256 S2048", (1, 8, 1), 2048, 256)):
    q, k, v, do = (c._randn(x, g2) for x in ((b, hq, s, d), (b, hkv, s, d),
                                             (b, hkv, s, d), (b, hq, s, d)))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    whole = lambda: fv.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    whole()
    by = profiling.device_breakdown(lambda: [whole() for _ in range(20)],
                                    parts)["by_category_ms"]
    dd[label] = {"fwd": dev(lambda: flash_attention_fwd(
                     q, k, v, causal=True, return_lse=False)),
                 "bwd": dev(whole),
                 **{p: round(by[p] / 20, 5) for p in parts}}
    for sq in (1, 16):
        qs = q[:, :, :sq].contiguous()
        dd[label][f"fwd Sq{sq}"] = dev(lambda: flash_attention_fwd(
            qs, k, v, return_lse=False))
    del q, k, v, do, o, lse, qs
print(f"{tag} 16-bit D64/D256 device ms per call", dd, flush=True)
_, t = c.check_prefill(g)
print(f"{tag} paged prefill ms", {k: round(v["ms"], 5) for k, v in t.items()},
      flush=True)
# the paged prefill's device time per call (torch.profiler) and SDPA's on
# the sequence's K/V gathered (dequantized) to dense bf16 with a positional
# causal mask, both trees' kernels on the same inputs
from aule_tpu_torch.ops.paged_fused import dequantize_pool
from aule_tpu_torch.ops.paged_prefill import paged_attention_prefill

q, pool, bt, ln, qoff = c._prefill_inputs(g, [3488], [512], 512,
                                          shuffle=False)
mask = (torch.arange(4000, device="cuda")[None, :]
        <= 3488 + torch.arange(512, device="cuda")[:, None])
pre = {}
for name, dt in (("bf16", None), ("int8", torch.int8),
                 ("fp8", torch.float8_e4m3fn)):
    pl, sc = (pool, None) if dt is None else c.quantize_pool(pool, dt)
    if dt is None:  # the sequence's 4000 tokens sit on pages 1..250
        kh, vh = (pool[1:251, i].transpose(0, 1) for i in (0, 1))
    else:
        kh, vh = dequantize_pool(pl[1:251], sc[1:251])
    kd, vd = (x.reshape(1, 8, 4000, 128).to(torch.bfloat16)
              .repeat_interleave(4, dim=1) for x in (kh, vh))
    pre[name] = (
        dev(lambda: paged_attention_prefill(q, pl, bt, ln, q_offsets=qoff,
                                            kv_scales=sc)),
        dev(lambda: F.scaled_dot_product_attention(q, kd, vd,
                                                   attn_mask=mask)))
    del kd, vd, kh, vh
print(f"{tag} paged prefill device ms per call (kernel, sdpa)", pre,
      flush=True)
# The one-query decode and the 16-bit paged prefill at D 64 / 256 as each
# tree routes them (since PR 13: csrc/flash_fwd_short.cu's split-KV kernel
# and csrc/paged_prefill.cu's Tile<64> / Tile<256>; before, the short
# kernel and csrc/paged_generic.cu's FFMA prefill), device ms per call
# beside SDPA's, on a generator of its own: the SDPA patch's bucketed
# decode (1 query over a 4096-key bucket, kv_len 4095, the Llama layer
# B1 Hq32/Hkv8 D128 bf16; SDPA with a key mask) and the RoPE mode over
# all 4096 keys (SDPA on the rotated q, k); GPT-2's chunk of 256 at q
# offset 768 over 1024 (Hq12/Hkv12 D64 page 16) and a chunk of 256 at
# 1000 at Hq8/Hkv1 D256 (SDPA with a positional mask on the gathered K/V).
import aule_tpu_torch as T
from aule_tpu_torch.ops.paged_fused import from_fused_layout

g3 = torch.Generator("cuda")
g3.manual_seed(c.SEED + 400)
b, hq, hkv = c.LAYER
q = c._randn((b, hq, 1, 128), g3)
kp, vp = (c._randn((b, hkv, 4096, 128), g3) for _ in range(2))
kvl = torch.full((1,), 4095, dtype=torch.int32, device="cuda")
cos, sin = T.precompute_rope_frequencies(4096, 128, c.LLAMA_ROPE_BASE,
                                         device="cuda")
qr, kr = T.apply_rope(q, cos, sin), T.apply_rope(kp, cos, sin)
kx, vx, krx = (x.repeat_interleave(hq // hkv, dim=1) for x in (kp, vp, kr))
key_mask = (torch.arange(4096, device="cuda") < 4095)[None, None, None]
new = {"decode kv_len 4095": (
           dev(lambda: flash_attention_fwd(q, kp, vp, kv_len=kvl,
                                           return_lse=False)),
           dev(lambda: F.scaled_dot_product_attention(
               q, kx, vx, attn_mask=key_mask))),
       "decode RoPE": (
           dev(lambda: T.flash_attention_rope(q, kp, vp, cos, sin)),
           dev(lambda: F.scaled_dot_product_attention(qr, krx, vx)))}
del q, kp, vp, kx, vx, krx, qr, kr
for label, (hq, hkv, d), hist, chunk, max_pages in (
        ("prefill GPT-2 D64", (12, 12, 64), 768, 256, 64),
        ("prefill D256 group 8", (8, 1, 256), 1000, 256, 128)):
    total = hist + chunk
    pool, bt = c._generic_pool(g3, [total], max_pages, 16, hkv, d,
                               torch.bfloat16, False)
    q = c._randn((1, hq, chunk, d), g3)
    ln = torch.tensor([total], dtype=torch.int32, device="cuda")
    qoff = torch.tensor([hist], dtype=torch.int32, device="cuda")
    kd, vd = (x.reshape(1, hkv, -1, d)[:, :, :total]
              .repeat_interleave(hq // hkv, dim=1)
              for x in from_fused_layout(pool[1:], d))
    mask = (torch.arange(total, device="cuda")[None, :]
            <= hist + torch.arange(chunk, device="cuda")[:, None])
    new[label] = (
        dev(lambda: paged_attention_prefill(q, pool, bt, ln, q_offsets=qoff)),
        dev(lambda: F.scaled_dot_product_attention(q, kd, vd,
                                                   attn_mask=mask)))
    del pool, q, kd, vd
print(f"{tag} decode and D64/D256 prefill device ms per call (kernel, sdpa)",
      new, flush=True)
torch.cuda.empty_cache()
# The TMA kernel's RoPE modes as each tree runs them (csrc/rope_prepass.cu
# turning K once a call, then csrc/flash_fwd.cu, in trees that have it;
# before, the TMA kernel's producer turned every K stage), device ms per
# call of the whole call beside the TMA kernel at the same shape without
# tables and SDPA on the rotated q, k with the case's boolean mask, on a
# generator of its own.
g5 = torch.Generator("cuda")
g5.manual_seed(c.SEED + 600)
rope = {}
for label, (b, hq, hkv), sq, sk, d, causal, n in (
        ("S2048 causal", c.LAYER, 2048, 2048, 128, True, None),
        ("Sq512 kv_len 3000 of 4096", c.LAYER, 512, 4096, 128, False, 3000),
        ("D64 Sq512/Sk1024 causal kv_len 900", (1, 12, 12), 512, 1024, 64,
         True, 900),
        ("D256 Sq512/Sk2048 kv_len 1500", (1, 8, 1), 512, 2048, 256, False,
         1500)):
    q = c._randn((b, hq, sq, d), g5)
    k, v = (c._randn((b, hkv, sk, d), g5) for _ in range(2))
    cos, sin = T.precompute_rope_frequencies(sk, d, c.LLAMA_ROPE_BASE,
                                             device="cuda")
    kvl = (None if n is None else
           torch.full((1,), n, dtype=torch.int32, device="cuda"))
    mask = build_mask(sq, sk, causal, -1, device="cuda")
    if n is not None:
        mask = mask & (torch.arange(sk, device="cuda") < n)
    qr, kr = T.apply_rope(q, cos, sin), T.apply_rope(k, cos, sin)
    kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in (kr, v))
    call = lambda: flash_attention_fwd(q, k, v, causal=causal, rope_cos=cos,
                                       rope_sin=sin, kv_len=kvl,
                                       return_lse=False)
    rope[label] = {
        "rope": dev(call),
        "no rope": dev(lambda: flash_attention_fwd(
            q, k, v, causal=causal, kv_len=kvl, return_lse=False)),
        "sdpa": dev(lambda: F.scaled_dot_product_attention(
            qr, kx, vx, attn_mask=mask[None, None]))}
    del q, k, v, qr, kr, kx, vx, mask
    torch.cuda.empty_cache()
print(f"{tag} TMA RoPE modes device ms per call", rope, flush=True)
# The f32 forward as each tree routes it (csrc/flash_f32.cu's 3xTF32
# kernel in trees that have it, else csrc/flash_generic.cu's FFMA forward)
# and the f32 backward as each tree routes it (flash_generic.cu's delta;
# csrc/flash_f32_bwd.cu's 3xTF32 dQ and dK/dV in trees that have it, else
# flash_generic.cu's FFMA ones), device ms per call beside SDPA's in f32
# (phase_device sets allow_tf32 False; SDPA's backward: dq, dk and dv in
# one call; the delta's yardstick torch.linalg.vecdot): the Llama layer S2048, GPT-2's layer S1024 D64, D256 group 8
# S2048 (causal; SDPA is_causal) and, forward only, RoPE + kv_len (Sq512
# over 1500 of 2048 keys, causal; SDPA on the rotated q, k with the
# boolean mask), on a generator of its own.
g4 = torch.Generator("cuda")
g4.manual_seed(c.SEED + 500)
f32 = {}
for label, (b, hq, hkv), sq, sk, d, rows, n in (
        ("Llama S2048", c.LAYER, 2048, 2048, 128, None, None),
        ("GPT-2 S1024 D64", (1, 12, 12), 1024, 1024, 64, None, None),
        ("D256 group 8 S2048", (1, 8, 1), 2048, 2048, 256, None, None),
        ("RoPE kv_len 1500 Sq512/Sk2048", c.LAYER, 512, 2048, 128, 2048,
         1500)):
    q = c._randn((b, hq, sq, d), g4, torch.float32)
    k, v = (c._randn((b, hkv, sk, d), g4, torch.float32) for _ in range(2))
    cos = sin = kvl = None
    sdpa_kw = dict(is_causal=True)
    qr, kr = q, k
    if rows is not None:
        cos, sin = T.precompute_rope_frequencies(rows, d, c.LLAMA_ROPE_BASE,
                                                 device="cuda")
        kvl = torch.full((1,), n, dtype=torch.int32, device="cuda")
        qr, kr = T.apply_rope(q, cos, sin), T.apply_rope(k, cos, sin)
        sdpa_kw = dict(attn_mask=build_mask(sq, sk, True, -1, device="cuda")
                       & (torch.arange(sk, device="cuda") < n))
    kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in (kr, v))
    f32[label] = {
        "fwd": dev(lambda: flash_attention_fwd(
            q, k, v, causal=True, rope_cos=cos, rope_sin=sin, kv_len=kvl,
            return_lse=False)),
        "sdpa": dev(lambda: F.scaled_dot_product_attention(qr, kx, vx,
                                                           **sdpa_kw))}
    if rows is None:
        o, lse = flash_attention_fwd(q, k, v, causal=True)
        do = c._randn(q.shape, g4, torch.float32)
        whole = lambda: fv.flash_attention_bwd(q, k, v, o, lse, do,
                                               causal=True)
        whole()
        by = profiling.device_breakdown(lambda: [whole() for _ in range(5)],
                                        parts)["by_category_ms"]
        f32[label].update({f"bwd {p}": round(by[p] / 5, 5) for p in parts})
        # the delta's library yardstick: rowsum(o dO) in one PyTorch call
        f32[label]["vecdot"] = dev(lambda: torch.linalg.vecdot(o, do))
        qx = q.detach().requires_grad_(True)
        kxg, vxg = (x.detach().requires_grad_(True) for x in (kx, vx))
        ref = F.scaled_dot_product_attention(qx, kxg, vxg, is_causal=True)
        f32[label]["sdpa bwd"] = dev(lambda: torch.autograd.grad(
            ref, (qx, kxg, vxg), do, retain_graph=True))
        del o, lse, do, qx, kxg, vxg, ref
    del q, k, v, kx, vx, qr, kr
    torch.cuda.empty_cache()
print(f"{tag} f32 forward and backward device ms per call", f32, flush=True)
# The f32-q paged prefill as each tree routes it (csrc/paged_prefill_f32.cu's
# 3xTF32 kernel in trees that have it, else csrc/paged_generic.cu's FFMA
# one) at GPT-2's chunk of 256 at q_offset 768 over 1024 (Hq12/Hkv12 D64,
# page 16) in f32, int8 and e4m3 pools (bf16 scales), device ms per call
# beside SDPA in f32 on the gathered, dequantized K/V with a positional
# mask, on a generator of its own.
from aule_tpu_torch.ops.paged_fused import dequantize_pool, from_fused_layout
from aule_tpu_torch.ops.paged_prefill import paged_attention_prefill

g6 = torch.Generator("cuda")
g6.manual_seed(c.SEED + 700)
pool, bt = c._generic_pool(g6, [1024], 64, 16, 12, 64, torch.float32, False)
q = c._randn((1, 12, 256, 64), g6, torch.float32)
ln = torch.tensor([1024], dtype=torch.int32, device="cuda")
qoff = torch.tensor([768], dtype=torch.int32, device="cuda")
mask = (torch.arange(1024, device="cuda")[None, :]
        <= 768 + torch.arange(256, device="cuda")[:, None])
pf = {}
for name, qdt in (("f32", None), ("int8", torch.int8),
                  ("fp8", torch.float8_e4m3fn)):
    pl, sc = c._gen_quantized(pool, qdt)
    kh, vh = (from_fused_layout(pl[1:], 64) if qdt is None
              else dequantize_pool(pl[1:], sc[1:], 64))
    kd, vd = (x.reshape(1, 12, -1, 64)[:, :, :1024].float() for x in (kh, vh))
    pf[name] = (
        dev(lambda: paged_attention_prefill(q, pl, bt, ln, q_offsets=qoff,
                                            kv_scales=sc)),
        dev(lambda: F.scaled_dot_product_attention(q, kd, vd,
                                                   attn_mask=mask)))
    del kd, vd, kh, vh
print(f"{tag} f32-q paged prefill, GPT-2 chunk, device ms per call (kernel, "
      f"sdpa)", pf, flush=True)
EOF
  )
}
run A1 "$A" && run B1 "$B" && run B2 "$B" && run A2 "$A"
