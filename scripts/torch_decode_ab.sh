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
#   * the generic decode (csrc/paged_generic.cu) at GPT-2 small's engine
#     shape, B8 ctx1024 Hq12/Hkv12 D64 page 16: fused f32, bf16, int8 dot
#     products, int8 exact and fp8 (f32 q, bf16 scales), split f32; and
#     its prefill of a 256-token chunk at q_offset 768 over 1024, f32 and
#     bf16;
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

generic = {}
hq, hkv, d = c.GPT2_HEADS
ln = torch.full((8,), 1024, dtype=torch.int32, device="cuda")
for name, dt, qdt, dot in c.GEN_DECODE_MODES:
    pool, bt = c._generic_pool(g, [1024] * 8, 64, 16, hkv, d, dt, False)
    q = c._randn((8, hq, d), g, dt)
    pl, sc = c._gen_quantized(pool, qdt)
    generic[f"decode {name}"] = dev(lambda: paged_attention_fused(
        q, pl, bt, ln, kv_scales=sc, int8_matmul=dot), "fusedlayout")
    if name == "f32":
        (k, v, _, _), _ = c._split_pools(pool, None, d)
        generic["split decode f32"] = dev(lambda: paged_attention(
            q, k, v, bt, ln), "splitlayout")
qoff = torch.tensor([768], dtype=torch.int32, device="cuda")
for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
    pool, bt = c._generic_pool(g, [1024], 64, 16, hkv, d, dt, False)
    q = c._randn((1, hq, 256, d), g, dt)
    generic[f"prefill {name}"] = dev(lambda: paged_attention_prefill(
        q, pool, bt, ln[:1], q_offsets=qoff), "paged_generic_prefill")
print(f"{tag} generic kernels (GPT-2 shapes) device us", generic,
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
