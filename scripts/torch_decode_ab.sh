#!/bin/bash
# A/B of the PyTorch port's paged decode kernels on one CUDA card, run in
# two trees in turns, A, B, B, A, one process each, so that both versions
# meet the same card.  Each process builds its tree's kernels, prints the
# ptxas lines of every kernel (registers, spills) and then the card's own
# time per call (torch.profiler, 20 calls after one, the named kernel only)
# of:
#   * the decode in every pool mode and both layouts at B8 ctx4096 (the
#     headline decode row), B8 ctx1024 (the engine's decode context) and
#     B1 ctx4096, Hq32/Hkv8 D128 page 16: fused bf16, int8 dot products,
#     int8 exact, fp8 (bf16 scales); split bf16, int8, fp8 (f32 scales);
#     beside SDPA on the gathered K/V (bf16);
#   * the decode at the head dims 64 and 256 as each tree routes it (f32
#     q on csrc/paged_generic.cu; 16-bit q on csrc/paged_decode.cu in
#     trees that template it on D, else on paged_generic.cu): GPT-2
#     small's engine shape, B8 ctx1024 Hq12/Hkv12 D64 page 16, and D256
#     group 8 (B2 Hq8/Hkv1,
#     contexts 2048 and 777), every pool mode (f32 q over f32, int8 and
#     e4m3 pools; bf16 and f16 pools; int8 and e4m3 with bf16 q and bf16
#     scales, with f16 q and f32 scales) in both layouts, beside SDPA; the
#     f32-q modes also at GPT-2's heads at B64 ctx1024 (one split) and at
#     the f32 Llama layer's decode (B8 ctx4096 Hq32/Hkv8 D128); and
#     the paged prefill of a 256-token chunk at q_offset 768 over 1024 at
#     GPT-2's shape, f32 and bf16;
#   * the other kernels, which the decode's changes must leave as they
#     were: the flash forward at S2048 causal and B4 S4096, the whole
#     backward at S2048 causal, and the paged prefill (bf16, int8, fp8) at
#     the engine's chunk (512 queries at q_offset 3488 over 4000 tokens).
# Every number is in microseconds; "None" where the profiler lost kernels
# in three tries.
#
#   git archive <commit> | tar -x -C build/parent   # a listed directory
#   scripts/torch_decode_ab.sh build/parent          # from the repo root
#
# Arguments: tree A (e.g. the parent commit), and tree B (default: the
# current directory).
set -o pipefail
A=$(cd "${1:?usage: $0 TREE_A [TREE_B]}" && pwd)
B=$(cd "${2:-.}" && pwd)
run() {  # $1 = label, $2 = tree
  (cd "$2" && python3 - "$1" <<'EOF'
import sys

import torch
import torch.nn.functional as F

import chip_smoke as c
from aule_tpu_torch.ops import flash_vjp as fv
from aule_tpu_torch.ops.flash import flash_attention_fwd
from aule_tpu_torch.ops.paged import paged_attention
from aule_tpu_torch.ops.paged_fused import paged_attention_fused
from aule_tpu_torch.ops.paged_prefill import paged_attention_prefill
from aule_tpu_torch.utils import profiling

tag = sys.argv[1]
c.phase_device()
c.phase_build()


def dev(fn, key=None, calls=20):
    """Device microseconds per call of fn (its kernels named `key`)."""
    cats = {"k": [key]} if key else {}
    fn()
    per = profiling.device_breakdown(fn, cats)["kernels"]
    for _ in range(3):
        bd = profiling.device_breakdown(lambda: [fn() for _ in range(calls)],
                                        cats)
        if per and bd["kernels"] == calls * per:
            ms = bd["by_category_ms"]["k"] if key else bd["busy_ms"]
            return round(ms / calls * 1e3, 2)
    return None


g = torch.Generator("cuda")
g.manual_seed(c.SEED)
for shape, batch, ctx in (("B8 ctx4096", 8, 4096), ("B8 ctx1024", 8, 1024),
                          ("B1 ctx4096", 1, 4096)):
    q, pool, bt, ln = c._decode_inputs(g, [ctx] * batch, 272)
    out = {}
    for name, dt, dot in (("bf16", None, None), ("int8 dot", torch.int8, True),
                          ("int8 exact", torch.int8, False),
                          ("fp8", torch.float8_e4m3fn, None)):
        pl, sc = (pool, None) if dt is None else c.quantize_pool(pool, dt)
        out[f"fused {name}"] = dev(lambda: paged_attention_fused(
            q, pl, bt, ln, kv_scales=sc, int8_matmul=dot), "fusedpool")
    for name, qdt in (("bf16", None), ("int8", torch.int8),
                      ("fp8", torch.float8_e4m3fn)):
        (k, v, ks, vs), _ = c._split_pools(pool, qdt)
        out[f"split {name}"] = dev(lambda: paged_attention(
            q, k, v, bt, ln, k_scales=ks, v_scales=vs), "splitpools")
        del k, v, ks, vs
    kd, vd = (pool[1:, i].transpose(0, 1).reshape(8, batch, ctx, 128)
              .transpose(0, 1).repeat_interleave(4, dim=1) for i in (0, 1))
    out["sdpa"] = dev(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kd, vd))
    print(f"{tag} decode {shape} device us", out, flush=True)
    del q, pool, kd, vd

# The paged decode at GPT-2 small's engine shape (B8 ctx1024 Hq12/Hkv12 D64
# page 16) and at D256 group 8 (B2 Hq8/Hkv1, contexts 2048 and 777), in
# every pool mode and both layouts, and in the f32-q modes at GPT-2's heads
# at B64 ctx1024 (one split) and the f32 Llama layer's decode (B8 ctx4096
# Hq32/Hkv8 D128, SDPA in f32), as each tree routes them (f32 q on
# csrc/paged_generic.cu; 16-bit q on csrc/paged_decode.cu in trees that
# template it on D, else on paged_generic.cu), the decode kernel's own
# device time, beside SDPA on the gathered K/V (bf16, a key mask where a
# sequence is shorter than its table); then the paged prefill of a
# 256-token chunk at q offset 768 over 1024 at GPT-2's shape, f32 and
# bf16, as each tree routes it (f32 q on csrc/paged_prefill_f32.cu in
# trees that have it, else on csrc/paged_generic.cu).
from aule_tpu_torch.ops.paged_fused import from_fused_layout
from aule_tpu_torch.ops.reference import _gather_pages

f32, bf, fp = torch.float32, torch.bfloat16, torch.float16
i8, e4 = torch.int8, torch.float8_e4m3fn
modes = [  # (name, q / pool dtype, payload or None, int8_matmul, scales)
    ("f32", f32, None, None, None), ("int8 dot f32 q", f32, i8, True, bf),
    ("int8 exact f32 q", f32, i8, False, bf), ("fp8 f32 q", f32, e4, None, bf),
    ("bf16", bf, None, None, None), ("f16", fp, None, None, None),
    ("int8 dot bf16 q", bf, i8, True, bf),
    ("int8 exact bf16 q", bf, i8, False, bf),
    ("fp8 bf16 q", bf, e4, None, bf),
    ("int8 dot f16 q f32 scales", fp, i8, True, f32),
    ("fp8 f16 q f32 scales", fp, e4, None, f32)]
for shape, lens, (hq, hkv, d), max_pages, f32_only in (
        ("GPT-2 B8 ctx1024 D64", [1024] * 8, c.GPT2_HEADS, 64, False),
        ("GPT-2 B64 ctx1024 D64 (one split)", [1024] * 64, c.GPT2_HEADS, 64,
         True),
        ("D256 group 8 B2 ctx2048/777", [2048, 777], (8, 1, 256), 128, False),
        ("f32 Llama layer B8 ctx4096 D128 group 4", [4096] * 8, (32, 8, 128),
         272, True)):
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    generic = {}
    for name, dt, qdt, dot, sdt in modes:
        if f32_only and dt != f32:
            continue
        pool, bt = c._generic_pool(g, lens, max_pages, 16, hkv, d, dt, False)
        q = c._randn((len(lens), hq, d), g, dt)
        pl, sc = (pool, None) if qdt is None else c.quantize_pool(pool, qdt,
                                                                   sdt)
        generic[f"fused {name}"] = dev(lambda: paged_attention_fused(
            q, pl, bt, ln, kv_scales=sc, int8_matmul=dot), "decode_kernel")
        if not dot:
            (k, v, ks, vs), _ = c._split_pools(pool, qdt, d)
            generic[f"split {name}"] = dev(lambda: paged_attention(
                q, k, v, bt, ln, k_scales=ks, v_scales=vs), "decode_kernel")
            del k, v, ks, vs
        if name == ("f32" if f32_only else "bf16"):
            kd, vd = (_gather_pages(x, bt).repeat_interleave(hq // hkv, dim=1)
                      for x in from_fused_layout(pool, d))
            keep = None if min(lens) == max_pages * 16 else (
                torch.arange(max_pages * 16, device="cuda")[None, :]
                < ln[:, None])[:, None, None]
            generic["sdpa"] = dev(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kd, vd, attn_mask=keep))
            del kd, vd
        del pool, pl, sc, q
    print(f"{tag} paged decode {shape} device us", generic, flush=True)
hq, hkv, d = c.GPT2_HEADS
ln = torch.full((1,), 1024, dtype=torch.int32, device="cuda")
qoff = torch.tensor([768], dtype=torch.int32, device="cuda")
pre = {}
for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
    pool, bt = c._generic_pool(g, [1024], 64, 16, hkv, d, dt, False)
    q = c._randn((1, hq, 256, d), g, dt)
    pre[f"prefill {name}"] = dev(lambda: paged_attention_prefill(
        q, pool, bt, ln, q_offsets=qoff), "prefill")
print(f"{tag} paged prefill (GPT-2 chunk 256 at 768) device us", pre,
      flush=True)

other = {}
for label, (b, hq, hkv), s in (("flash fwd S2048", c.LAYER, 2048),
                               ("flash fwd B4 S4096", (4, 32, 8), 4096)):
    q = c._randn((b, hq, s, 128), g)
    k = c._randn((b, hkv, s, 128), g)
    v = c._randn((b, hkv, s, 128), g)
    other[label] = dev(lambda: flash_attention_fwd(
        q, k, v, causal=True, return_lse=False), "flash_fwd_kernel")
q, k, v, o, lse, do, _ = c._bwd_inputs(g, c.LAYER, 2048, 2048, True, -1,
                                       torch.bfloat16, False)
other["whole backward S2048"] = dev(
    lambda: fv.flash_attention_bwd(q, k, v, o, lse, do, causal=True))
q, pool, bt, ln, qoff = c._prefill_inputs(g, [3488], [512], 512,
                                          shuffle=False)
for name, dt in (("bf16", None), ("int8", torch.int8),
                 ("fp8", torch.float8_e4m3fn)):
    pl, sc = (pool, None) if dt is None else c.quantize_pool(pool, dt)
    other[f"prefill {name}"] = dev(lambda: paged_attention_prefill(
        q, pl, bt, ln, q_offsets=qoff, kv_scales=sc), "paged_prefill_kernel")
print(f"{tag} other kernels device us", other, flush=True)
EOF
  )
}
run A1 "$A" && run B1 "$B" && run B2 "$B" && run A2 "$A"
