"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing a line of its own:
  1. device: exits non-zero without CUDA (there is no CPU fallback);
     prints the card's name and power limit (nvidia-smi);
  2. build: compiles aule_tpu_torch/csrc/*.cu with nvcc for sm_90a, one
     nvcc per source, all started together;
  3. kernels: each hand-written kernel against its plain PyTorch version
     on the card (each output row within ROW_TOL of its size, LSE within
     LSE_TOL; see below): flash forward, both kernels (the TMA/wgmma one,
     also at the shape classes of the TPU's _causal_kernel and _win_kernel
     and at its tiles' edges: ragged prompts, groups 1, 2 and 8, f16,
     windows with Sq != Sk; and the mma.sync one the wrapper runs for
     prompts of at most SHORT_SQ tokens, with both kernels' device times
     at short prompts); paged decode (split-KV, the splits merged in the
     same launch) over bf16, int8 (dot-product and exact paths) and fp8
     pools, also at the split cases (B1 ctx4096, lengths 1 and 17 of 4352,
     lengths on split boundaries, a window starting deep in the table,
     64-token pages), every call twice with the same bits, timed by
     profiler device time at B8 ctx4096, B8 ctx1024 and B1 ctx4096 beside
     SDPA's; paged prefill (the
     warp-specialised wgmma kernel) over bf16, f16, int8 and fp8 pools (a
     512-token chunk at q_offset 3488 over 4000 cached tokens, with and
     without a 256 window; a ragged batch of 4 whose padding rows must be
     exact zeros; 64-token pages with a 1-token chunk; shuffled page ids
     and -1 entries), timed also by profiler device time; both
     paged kernels at GQA groups 1, 2 and 8 and with f16 q, and at every
     other group class (GROUPS, ODD_GROUPS: 3, 5, 6, 7, 12, 16 over 8 kv
     heads, 24 and 32 over one) in every pool mode, the decode also over
     split pools (the fused kernel's bits) and with a window; the decode
     over split head-major pools (bf16, f16, int8 and fp8 with f32
     scales; ragged lengths with 0 and 1, shuffled pages, -1 tails,
     trailing windows, groups 1, 2, 4 and 8, and the split cases), which
     must also give the fused kernel's bits on the same pools.  Each with
     its time at the
     engine's shapes (median of 20 CUDA-event timed runs), its bound, the
     plain version's time and a library yardstick's time
     (F.scaled_dot_product_attention on the gathered, dequantized K/V;
     timed only, the port never calls it);
  4. backward kernels: delta (within DELTA_TOL, with and without an lse
     cotangent), dQ and dK/dV (every row within ROW_TOL) against their
     plain versions at the Llama-3-8B layer, bench.py's B4 row, ragged S
     and key tiles (B2 S1100), Sq != Sk, GQA groups 1, 2 and 8, f16,
     non-causal, a non-zero lse cotangent, causal and bidirectional windows
     of 256 at S4096 and rows that see nothing; two runs bitwise equal;
     times (CUDA events and profiler device time) beside their bounds, the
     plain versions and the backward of F.scaled_dot_product_attention
     (timed only); then the f32 backward (F32_BWD_CASES: the Llama,
     GPT-2 and D256 group 8 layers, Sq != Sk, groups 1/3/8, windows, a
     non-zero lse cotangent) on csrc/flash_f32_bwd.cu, every row within
     1e-5, two runs bitwise equal;
  5. public, in a process of its own (`python3 chip_smoke.py --public`
     runs it alone): aule_tpu_torch's public API on the card, whose
     select_backend() must be cuda, each call twice with the same bits and
     held to its plain version: the Llama-3-8B layer with fused RoPE
     (flash_attention_rope: csrc/rope_prepass.cu turns K, then the TMA
     kernel; the pre-pass also held to apply_rope at D 64/128/256, bf16
     and f16, short tables) and through flash_attention forward and
     backward; the bucketed decode (1 query over K/V padded to 4096,
     csrc/flash_fwd_short.cu's split-KV kernel; bf16 and f16, with and
     without RoPE) captured in a CUDA graph, replayed with kv_len written
     in place, deleted and captured again;
     kv_len on the TMA kernel; GPT-2 small's layer (D64) and D256 in bf16
     and f16 forward and backward on the tensor-core kernels; the Llama
     layer, GPT-2's layer and D256 group 8 in f32, forward on
     csrc/flash_f32.cu (3xTF32 on the tensor cores), backward on
     csrc/flash_f32_bwd.cu (3xTF32) with
     csrc/flash_generic.cu's delta; the SDPA
     patch (install, an attn_mask call reaching torch's own function,
     uninstall); the forward's RoPE, kv_len, window and GQA modes
     (PUBLIC_MODES; f32 at D 64, 128 and 256 too); each mode timed beside
     its bound and one PyTorch call;
  6. gpt2, in a process of its own (`python3 chip_smoke.py --gpt2` runs it
     alone): csrc/paged_generic.cu's decode and csrc/paged_prefill_f32.cu's
     prefill (f32 q),
     csrc/paged_decode.cu's 16-bit decode and csrc/paged_prefill.cu's
     16-bit prefill at D 64/256 (bf16 and f16 pools, int8 and e4m3 pools
     with 16-bit q), held to their plain versions, every call twice with
     the same bits and counted on the kernel the rule picks:
     the decode at GPT-2's engine case (B8 Hq12/Hkv12 D64 ctx1024 page 16)
     and its edges (lengths 0, 1 and 17 with -1 tails, shuffled pages with
     a window, 64-token pages) in f32 q (f32, int8 dot, int8 exact, fp8
     pools) and 16-bit q (TC_DECODE_MODES), over split pools too (which
     must give the fused kernel's bits), 16 bits at D64 group 2 and D256
     group 8, f32 at the Llama layer (D128 group 4) and at D256 group 8;
     the prefill of a 256-token chunk at q_offset 768 over
     1024 (also windowed), a ragged batch whose padding rows must be exact
     zeros and 64-token pages with a 1-token chunk, f32 at D128, D256
     group 8 (also a ragged batch), D64 group 2 with a window; both at
     groups 3, 6 and 12 (f32
     D128, f32 D64, bf16 D64; GEN_GROUPS) in every pool mode; each mode
     timed at GPT-2's shapes beside its bound, its plain version and SDPA
     on the gathered K/V.  Then GPT-2 small at full width and depth
     (random f32 weights from a seeded generator on the card, and the same
     in bf16) serves 12 greedy requests of 7 to 1,000 prompt tokens
     through ServingEngine(model=gpt2) seven times (GPT2_RUNS: f32 whole
     and chunk 256, int8 chunk 256, fp8 whole and chunk 256, bf16 whole
     and chunk 256) and once more in f32 chunk 256 with two rank-16 LoRA
     adapters over its requests and top-k 20 on two of them, each checked
     as the Llama runs are (launches: the
     decode 12 times a step and the chunked prefill 12 times a chunk, on
     paged_generic.cu / paged_prefill_f32.cu in f32, on paged_decode.cu /
     paged_prefill.cu in
     bf16, the other family never;
     pages; tokens against a teacher-forced plain forward or
     plain-attention replay, the f32 runs within GPT2_F32_NEAR_TIE); the
     bf16 whole-prompt run once more, saved with save_engine_state after
     its first decode dispatch and resumed by a fresh engine, which must
     give the uninterrupted run's tokens and every page back; and
     one f32 prefill step and decode dispatch under torch.profiler;
  6b. llama32, in a process of its own (`python3 chip_smoke.py --llama32`
     runs it alone): the paged decode's device times at B8 ctx4096 at GQA
     groups 4, 3 (Llama-3.2-3B's: the same bytes), 12 and 32, and the
     paged prefill's at groups 4 and 3, beside their bounds and SDPA;
     then Llama-3.2-3B (LLAMA32_3B: 24 q over 8 kv heads, full width,
     LLAMA32_LAYERS of its 28 layers, random bf16 weights) serves the 12
     requests six
     times (LLAMA32_RUNS: bf16 whole and chunk 512, int8 chunk, fp8
     whole, split bf16 and int8), checked as the Llama-3-8B runs are;
  6c. mistral, in a process of its own (`--mistral`): Mistral-7B
     (LlamaConfig.mistral_7b(), its 4096-token window, full width and
     depth) serves 4 requests of 4,200 to 6,000 prompt tokens whole and
     with prefill_chunk=512, each held to a teacher-forced plain forward;
  6d. moe, in a process of its own (`--moe`): Mixtral-8x7B (models/moe.py,
     MoEConfig.mixtral_8x7b(): 8 experts, top 2, full width, 16 of its 32
     layers, random bf16 weights) serves the 12 requests three times
     (MOE_RUNS: bf16 whole-prompt, int8 chunk 512 with two LoRA adapters
     over its requests, fp8 whole-prompt), each checked as the Llama runs
     are, routed as the run routed; then moe.loss_fn's gradients through
     the kernels against the plain attention path's on 2 layers;
  6e. adamw, in a process of its own (`--adamw`): AdamW
     (parallel/optimizer.py, an f32 master, clip 1.0, a warm-up schedule,
     2 micro-batches) on Llama-3-8B at full width on 8 layers, 3 steps of
     B2 x 2049 tokens (launches asserted, the loss falling, step 2 timed,
     peak memory), then the update on the card against the CPU's;
  6f. spec, in a process of its own (`--spec`): speculative decoding.
     First the kernels at the shapes it gives them, each twice with the
     same bits, held to its plain version and timed beside its bound and
     SDPA: the verify's paged prefill at B8 x 5 queries over 4,096 tokens
     (D128 group 4; ragged slots of 5, 1 and 0 queries checked) and the
     draft's catch-up prefill at D64 group 4, over bf16, int8 and e4m3
     pools; the draft's decode at D64 group 4, B8 ctx4096; the draft's
     whole-prompt flash forward at D64 group 4.  Then Llama-3-8B at full
     width on ENGINE_LAYERS = 16 of its 32 layers (full depth until the
     scripts phase joined) serves the 12 prompts, 32 new tokens each, over
     ENGINE_KW with 1,024 pages (SPEC_KW): (s0) plain bf16 chunk 512;
     (s1) self-draft K=4, 4 requests sampled at temperature 0.8 / top-p
     0.9, saved after its first round and resumed by a fresh engine with
     the same greedy tokens; (s2) a Llama-3.2-1B-shaped draft (LLAMA32_1B,
     random weights) K=4 over an int8 pool, whole-prompt, turned off after
     8 rounds under spec_min_acceptance 0.3; (s3) prompt lookup K=4 over
     prompts that repeat a 64-token span, half sampled with top-k 20.
     Each run on the native page allocator, its launches checked round by
     round (the target's verify 32 paged prefills, the draft's prefill
     once a layer and its decode K-1 times a layer), every page back,
     greedy tokens held to a teacher-forced plain forward (int8: a
     plain-attention replay), sampled ones inside their sets; (s1)'s
     greedy-prefix match against (s0) and its acceptance against JAX's
     chip floors; then GPT-2 small in f32 (no bf16 near-ties) served (s4)
     plain and (s5) self-draft K=4, chunk 256: (s5)'s raw greedy-prefix
     match against (s4), with no near-tie credit, must reach JAX's 95 %
     floor; one (s1) round and one (s3) round under the profiler beside a
     plain dispatch;
  6g. parallel, in a process of its own (`--parallel`): the kernels at
     the shard shapes the strategies and the tensor-parallel engine give
     them (the ring's diagonal and full hops and context parallel's
     shard at B1 Hq32/Hkv8 S2048, Ulysses' full-sequence kernel at Hq16
     S8192 causal and window 256, head parallelism's Hq16 S4096, the
     ring hops' backward with a non-zero lse cotangent, the paged decode
     at a (model 2, ctx 2) split shard and int8 / e4m3 ctx-2 shards, the
     tp 2 engine's Hq16/Hkv4 decode and prefill), each held to its plain
     version and timed; then parallel/'s strategies through their entry
     points (PAR_CASES, Llama-3-8B's Hq32/Hkv8 D128 bf16) in spawned
     worlds (utils/testing.run_world): a world of 1 over NCCL runs every
     strategy and a short tensor-parallel engine; gloo worlds of 2 and 4
     processes share the one card, their collectives staged through host
     memory (no multi-GPU figure): ring attention over 4 ranks at S8192
     and its gradients over 2 at S4096, context parallelism (Sq2048 over
     Sk8192, 4 ranks), Ulysses over 2 at S8192 (causal, window 256),
     head parallelism on a (1, 2) mesh, the sharded paged decode at B8
     ctx4096 (split pools over model 2 x ctx 2; fused int8 and e4m3 over
     ctx 2); each held on rank 0 to the single-device kernel call on the
     full tensors (ROW_TOL; gradients within GRAD_TOL), per-rank CUDA-event
     times beside it and the collectives' share; then Llama-3-8B at full
     width on 8 layers served tensor-parallel over 2 ranks (PAR_TP_RUNS:
     bf16 and int8 chunk 512, 8 requests; a short self-draft run, the
     draft sharded too), its tokens held to the teacher-forced plain
     forward or plain-attention replay and logged beside the tp 1 engine's
     tokens and tok/s on the same weights;
  6h. head dims, in a process of its own (`--head-dims`): every attention
     wrapper at a head dim the kernels pad to the width above it (64, 128
     or 256): torch's SDPA through the patch at SD 1.5's D40 (B2 H8 S4096)
     and D160 (S256) and Phi-2's D80 (B1 Hq32 S2048 causal), the D80
     backward, RoPE with kv_len and f32 at D80, the fused decode at D80
     over bf16 / int8 / e4m3 pools and the split decode (its per-call pool
     copy timed apart), a D80 prefill chunk; each launch counted, held to
     its plain version at the true D and timed beside SDPA there, with
     its bound at the true D and the padded products' wasted share;
  6i. frontends, in a process of its own (`--frontends`): Llama-3-8B at
     full width on 4 layers behind ServingHTTPServer: (f1) 4 blocking
     requests token-exact against the same engine's direct runs, (f2) 8
     concurrent NDJSON streams held to a direct batch by the spec phase's
     near-tie rule, /health showing them batched, (f3) a /v1/cancel and a
     client disconnect with every page back; (f4) an EngineReplicaPool of
     1 and 2 replicas; (f5) MultiProcessServingPool of 2 workers on the
     card over mp and tcp (the tiny Llama in f32 at D32, padded to 64),
     each request equal to the parent's engine from the same seed;
  6j. scripts, in a process of its own (`--scripts`): the port's entry
     points and scripts as a user calls them: (x1) entry.entry()'s forward
     (the JAX entry's 512-wide Llama, bf16 D64) held to the plain forward;
     (x2) examples/serve_demo (int8 pools, chunk 16, the prefix cache, a
     sampled request, then speculation with the tiny draft; f32 at D32,
     padded to 64) held to a teacher-forced plain forward and a plain
     engine; (x3) examples/train_demo in a gloo world of 8 ranks on the
     card (ZeRO-1 AdamW, bf16) with its checkpoint round trip; (x4)
     scripts/scaling_report at 1 and 2 replicas; (x5)
     entry.dryrun_multichip(4, backend="gloo"); (x6)
     entry.dryrun_multihost(2, backend="gloo"); (x7)
     utils/profiling.benchmark against cuda_time_ms and trace();
  7. engine: a full-width Llama-3-8B on ENGINE_LAYERS = 16 of its 32
     layers (cut for the time limit; random bf16 weights from a seeded
     generator on the card) serves the same 12 greedy requests
     eight times through `ServingEngine`: over fused pools, bf16 with
     whole-prompt prefill, (a) bf16 with prefill_chunk=512, (b) int8 with
     prefill_chunk=512, (c) fp8 with whole-prompt prefill, (d) fp8 with
     prefill_chunk=512; over split pools (layout="split", whole-prompt
     prefill), (e) bf16, (f) int8 and (g) fp8.  Each run checks its launch
     counts against its dispatches (the split runs launch the split decode
     once a layer a step and the fused decode never) and that every page comes
     back.  The bf16 runs hold every token against a teacher-forced plain
     forward; (b)-(d), (f) and (g) against a teacher-forced replay of the
     same steps with the plain attention versions;
  7b. edges: on the same weights, two rank-16 LoRA adapters and 12
     prompts on one shared 1,024-token prefix (adapters cycling base, a,
     b; prefill_chunk=512) served three times: (h0) bf16, prefix cache
     off, greedy; (h) the prefix cache on, with logprobs, stop sequences,
     logit bias (+100 and -100), temperature 0.8 with top-k 20 and with
     top-p 0.9 on some requests; (i) (h)'s requests over an int8 pool.
     Each held to a teacher-forced plain forward (or, for (i), a plain-
     attention replay) on its request's adapter and bias; sampled tokens
     inside their restricted sets, logprobs within LOGPROB_TOL, stops,
     bans and the cache's hits (9 x 1,024 tokens; no group reads another's
     pages) checked; then one decode dispatch of (h)'s configuration and
     of run (a)'s under torch.profiler (kernels a step);
  8. breakdown: one prefill step and one 8-step decode dispatch of the
     engine under torch.profiler (device busy share, kernel time by
     category) for bf16, int8 chunked, fp8 chunked and int8 split pools;
  9. train: the same full-width Llama-3-8B weights (16 layers), made to
     require grad: first every parameter's gradient of loss_fn through the
     kernels against the plain attention path's on the weights cut to 2
     layers (GRAD_TOL), then 3 SGD `train_step`s on one batch of B1 x 2049
     tokens: each launches the forward, delta, dQ and dK/dV kernels once
     per layer, step 1 checks every gradient finite, step 2 is timed
     (tokens/s, share of the bf16 peak, peak memory), step 3 runs under
     torch.profiler; the loss falls at every step.  Last, as it rewrites
     the weights;
  10. a `kernels` JSON line, one entry per kernel mode the main path
     launched (the engine runs, the GPT-2 runs, the Llama-3.2-3B runs for
     the group-3 modes, the train steps for the backward, the public
     phase's calls for its modes and the GPT-2 phase's split-layout
     calls; the Mixtral runs, the AdamW steps, the edges runs and the spec
     runs added to the modes they launch; the spec phase's verify, draft
     prefill, draft decode and D64 flash modes; the parallel phase's
     shard shapes, launches summed over the ranks of the runs that give
     them those shapes; the scripts phase's in-process runs, (x1), (x2)
     and (x4), added to the modes they launch);
  11. last line: {"ok": true, "device": {...}}, printed only when every
     phase passed.  Any failure raises and the exit code is non-zero.

About 15-16 minutes on an H100 80GB HBM3 at 700 W, the build included
(`seconds by phase` in the log; PERF.md keeps the runs' figures).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# torch's own scaled_dot_product_attention, kept before the public phase's
# install() replaces the module attribute: every library yardstick below
# calls it, never the port through the patch
SDPA = F.scaled_dot_product_attention

# Kernel checks hold every output row to the plain version's row relative
# to that row's size, so a fault in a row over 4000 keys (outputs ~0.03) is
# as visible as one in a row over 1 key (outputs ~1):
#     max |out - plain| over the row <= ROW_TOL * max |plain| over the row.
# Both sides round to the output type once, and the kernel rounds p to it
# before the PV product: under 2 rounding steps of the row's largest
# element, 2^-6 of it for bf16 (8 significant bits), allowed 4 steps for
# f16.  The int8 dot-product decode may also move one p code of a span by
# 1/127 of the span's weight against its plain version (f32 rounding of
# p * 127 / max), so it gets 2^-6 more.  A wrong V tile or scale moves whole
# rows by tens of % of their size.  LSE is f32 on both sides and agrees to
# a few f32 steps; a dropped or extra 64-key tile of 4000 keys moves it by
# ~64/4000, over 100x LSE_TOL.
ROW_TOL = {torch.bfloat16: 2.0 ** -6, torch.float16: 2.0 ** -8}
INT8_DOT_EXTRA = 2.0 ** -6
LSE_TOL = 1e-4
# Teacher-forced agreement: the engine's token is the plain argmax, or its
# logit is within NEAR_TIE of the plain max.  Logits are bf16 products
# (lm_head in bf16, then f32): at |logit| in [4, 8) one bf16 step is
# 0.03125, and the two paths round their matmuls in different orders, so
# 4 steps is the allowance for a bf16 near-tie.
NEAR_TIE = 0.125
# The backward kernels round p and ds to the input type before their
# products, as the JAX kernels do (flash_vjp.py:212, 350), and sum in f32;
# the plain version computes in f32 and rounds only its outputs.  Each dQ,
# dK or dV element is a sum of such terms, so it is off by a few roundings
# of the row's larger terms: held, as the forward, to ROW_TOL of each
# output row's max.  A wrong mask, tile or group sum moves whole rows by
# tens of % of their size.
# A gradient row whose exact value cancels to zero (causal row 0 sees one
# key: p = 1 and dp = di) holds only the f32 noise of dp - di in either
# version, so a backward row is measured against at least BWD_FLOOR of the
# tensor's largest |value|; rows 1000x below the largest stay relative.
BWD_FLOOR = 2.0 ** -12
# The 2-layer gradient check holds each parameter's gradient to the plain
# attention path's in relative Frobenius norm: the two paths' attention
# outputs and gradients differ by one or two bf16 roundings (2^-9 each)
# per element, re-rounded through the bf16 products of two layers; over
# millions of elements that is a few 1e-3.  A dropped tile or a wrong mask
# moves a gradient by tens of %.
GRAD_TOL = 2e-2
# Delta sums 128 products, each exact in f32 (two 16-bit values), in
# another order than the plain version's: each sum is within 127 f32
# rounding steps (2^-23) of the sum of its terms' sizes, so the two agree
# within 2^-15 of it, with the lse cotangent's size added.  One wrong or
# dropped term moves a row by its size, ~1/128 of the row's terms.
DELTA_TOL = 2.0 ** -15
SEED = 0
DEV = "cuda"  # the engine phase's device
LAYER = (1, 32, 8)  # Llama-3-8B attention: B1, Hq32, Hkv8 (D128)
TRAIN_S = 2048      # the train batch: B1 x (TRAIN_S + 1) tokens
# SGD learning rate of the train phase: random N(0, 1/fan_in) bf16 weights
# need updates above half a bf16 step (~3e-5 at |w| ~ 1/64) to move at all;
# lm_head's gradient entries are ~1/TRAIN_S ~ 5e-4, so 0.2 moves them by
# ~1e-4 and raises each target logit by ~0.4 a step
TRAIN_LR = 0.2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        log("device: torch.cuda.is_available() is False; this script "
            "runs only on a CUDA card")
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(card_line())
    return name


def phase_build():
    from aule_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds():.2f} s) -> {_build.library_path()}")
    for line in _build.build_log().splitlines():
        if ("registers" in line or "spill" in line or line.startswith("==")
                or "Function properties" in line
                or "Performance Loss" in line):
            log(f"  ptxas {line.strip()}")


def _randn(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def hold(what, out, plain, lse, plse, tol, worst=None, key=None,
         floor=0.0):
    """Hold a kernel's (out, lse) to its plain version's: every row within
    `tol` of its size (at least `floor` times the largest |plain|), LSE
    within LSE_TOL (lse None: no LSE), all finite.  Logs the max-abs,
    row-relative and LSE errors, raises on a failure, and merges them into
    worst[key] (a dict of per-kernel worst errors) when given."""
    o, p = out.float(), plain.float()
    diff = (o - p).abs().amax(dim=-1)
    size = p.abs().amax(dim=-1).clamp_min(floor * float(p.abs().max()))
    # a row the plain version gives as zeros must be zeros
    rel = torch.where(diff == 0, torch.zeros_like(diff),
                      diff / size.clamp_min(1e-30))
    errs = (float(diff.max()), float(rel.max()),
            0.0 if lse is None else _err(lse, plse))
    ok = (errs[1] <= tol and errs[2] <= LSE_TOL
          and bool(torch.isfinite(o).all()))
    lse_part = "" if lse is None else f", max|lse-plain| {errs[2]:.3e}"
    log(f"{what}: max|out-plain| {errs[0]:.3e}, row-relative {errs[1]:.3e} "
        f"(<= {tol:.3e}){lse_part} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{what}")
    if worst is not None:
        worst[key] = tuple(max(a, b) for a, b in
                           zip(worst.get(key, (0.0, 0.0, 0.0)), errs))
    return errs


def check_flash(gen):
    """The flash forward against its plain version at every mask, at the
    shape classes of the TPU's _fwd_kernel, _mono_kernel, _causal_kernel
    and _win_kernel, and at the edges of its 128-row, 128-key tiles: the
    engine's ragged prompt lengths, GQA groups 1, 2 and 8, f16, windows
    with Sq != Sk and rows that see nothing; its times at S512, S2048, the
    _causal_kernel shape, the S4096 window and bench.py's B4 S4096 prefill
    row."""
    from aule_tpu_torch.ops.flash import (SHORT_SQ, flash_attention_fwd,
                                          flash_attention_fwd_plain,
                                          flash_fwd_short, flash_fwd_tma)
    from aule_tpu_torch.ops.reference import build_mask
    from aule_tpu_torch.utils import profiling

    worst = {}
    bf, fp = torch.bfloat16, torch.float16
    cases = [  # (label, (B, Hq, Hkv), Sq, Sk, causal, window, dtype)
        ("S512 causal (_fwd_kernel class)", LAYER, 512, 512, True, -1, bf),
        ("S2048 causal (_mono_kernel class)", LAYER, 2048, 2048, True, -1,
         bf),
        ("B2 Hq16/Hkv4 S2048 causal (_causal_kernel class)", (2, 16, 4),
         2048, 2048, True, -1, bf),
        ("S777 non-causal", LAYER, 777, 777, False, -1, bf),
        ("Sq300 Sk900 causal", LAYER, 300, 900, True, -1, bf),
        ("Sq300 Sk900 non-causal", LAYER, 300, 900, False, -1, bf),
        ("S1024 causal window 256", LAYER, 1024, 1024, True, 256, bf),
        ("S1024 non-causal window 256", LAYER, 1024, 1024, False, 256, bf),
        ("S4096 causal window 256 (_win_kernel class)", LAYER, 4096, 4096,
         True, 256, bf),
        ("S4096 bidirectional window 256 (_win_kernel class)", LAYER, 4096,
         4096, False, 256, bf),
        ("S512 causal f16", LAYER, 512, 512, True, -1, fp),
        # the engine's ragged prompts against the 128-row q and key tiles
        ("S7 causal", LAYER, 7, 7, True, -1, bf),
        ("S64 causal", LAYER, 64, 64, True, -1, bf),
        ("S129 causal", LAYER, 129, 129, True, -1, bf),
        ("S511 causal", LAYER, 511, 511, True, -1, bf),
        ("S4000 causal", LAYER, 4000, 4000, True, -1, bf),
        ("group 1 Hq8/Hkv8 S2048 causal", (1, 8, 8), 2048, 2048, True, -1,
         bf),
        ("group 2 Hq16/Hkv8 S2048 causal", (1, 16, 8), 2048, 2048, True, -1,
         bf),
        ("group 8 Hq64/Hkv8 S2048 causal", (1, 64, 8), 2048, 2048, True, -1,
         bf),
        ("S2048 causal f16", LAYER, 2048, 2048, True, -1, fp),
        ("Sq900 Sk2000 causal window 300", LAYER, 900, 2000, True, 300, bf),
        ("Sq700 Sk300 bidirectional window 100 (rows that see nothing)",
         LAYER, 700, 300, False, 100, bf),
    ]
    for label, (b, hq, hkv), sq, sk, causal, window, dt in cases:
        q = _randn((b, hq, sq, 128), gen, dt)
        k = _randn((b, hkv, sk, 128), gen, dt)
        v = _randn((b, hkv, sk, 128), gen, dt)
        po, plse = flash_attention_fwd_plain(q, k, v, causal=causal,
                                             window_size=window,
                                             return_lse=True)
        # the kernel the wrapper picks, and within one 128-row q tile both
        kernels = [(flash_attention_fwd, "")]
        if sq <= 128:
            kernels = [(flash_fwd_tma, " (TMA kernel)"),
                       (flash_fwd_short, " (short-prompt kernel)")]
        for fn, which in kernels:
            o, lse = fn(q, k, v, causal=causal, window_size=window,
                        return_lse=True)
            hold(f"flash {label}{which}", o, po, lse, plse, ROW_TOL[dt],
                 worst, "flash_short" if fn is flash_fwd_short else "flash")
        del q, k, v, o, lse, po, plse

    timings = {}
    for key, (b, hq, hkv), s, window in (
            (512, LAYER, 512, -1), (2048, LAYER, 2048, -1),
            ("causal class", (2, 16, 4), 2048, -1),
            ("window", LAYER, 4096, 256), ("B4 S4096", (4, 32, 8), 4096, -1)):
        q = _randn((b, hq, s, 128), gen)
        k = _randn((b, hkv, s, 128), gen)
        v = _randn((b, hkv, s, 128), gen)
        kx = k.repeat_interleave(hq // hkv, dim=1)
        vx = v.repeat_interleave(hq // hkv, dim=1)
        kw = dict(causal=True, window_size=window, return_lse=False)
        if window > 0:
            mask = dict(attn_mask=build_mask(s, s, True, window,
                                             device="cuda"))
            flops = profiling.window_attention_flops(b, hq, s, 128, window)
        else:
            mask = dict(is_causal=True)
            flops = profiling.attention_flops(b, hq, s, s, 128, causal=True)
        kernel = lambda: flash_attention_fwd(q, k, v, **kw)
        sdpa = lambda: SDPA(q, kx, vx, **mask)
        ms = profiling.cuda_time_ms(kernel, iters=20)
        plain = profiling.cuda_time_ms(
            lambda: flash_attention_fwd_plain(q, k, v, **kw), iters=20)
        lib = profiling.cuda_time_ms(sdpa, iters=20)
        # the card's own time per call (torch.profiler, the kernels of 20
        # calls): the CUDA-event time of one call also holds the host's
        # dispatch once a kernel is this short, and the wrapper's Python
        # dispatch is longer than SDPA's
        dev, dev_lib = (_busy_per_call(profiling.device_breakdown(
            lambda: [fn() for _ in range(20)], {}), 20)
            for fn in (kernel, sdpa))
        nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
        bound, by = profiling.bound_ms(nbytes, flops)
        timings[key] = dict(ms=ms[0], plain_ms=plain[0], library_ms=lib[0],
                            bound_ms=bound, bound_by=by, device_ms=dev,
                            library_device_ms=dev_lib)
        rate = "" if dev is None else f", {flops / dev / 1e9:.1f} TFLOP/s"
        log(f"flash time B{b} Hq{hq}/Hkv{hkv} S{s} D128 bf16 causal"
            f"{f' window {window}' if window > 0 else ''}: kernel "
            f"{ms[0]:.4f} ms (min {ms[1]:.4f} max {ms[2]:.4f}), device "
            f"{_ms(dev)}{rate}; plain {plain[0]:.4f} ms; sdpa"
            f"{' with the window mask' if window > 0 else ''} {lib[0]:.4f} "
            f"ms, device {_ms(dev_lib)}; bound {bound:.4f} ms ({by})")
    # both kernels at the engine's short prompts, in device time (torch.
    # profiler; a call's CUDA-event time is the host's at these sizes):
    # the evidence for SHORT_SQ
    cats = {"short": ["flash_fwd_short_kernel"], "tma": ["flash_fwd_kernel"]}
    short = {}
    for s in (7, 16, 32, 64, 96, 128):
        q = _randn((1, 32, s, 128), gen)
        k = _randn((1, 8, s, 128), gen)
        v = _randn((1, 8, s, 128), gen)
        dev = {}
        for name, fn in (("tma", flash_fwd_tma), ("short", flash_fwd_short)):
            fn(q, k, v, causal=True, return_lse=False)
            bd = profiling.device_breakdown(
                lambda: [fn(q, k, v, causal=True, return_lse=False)
                         for _ in range(20)], cats)
            dev[name] = (bd["by_category_ms"][name] / 20
                         if bd["kernels_by_category"][name] == 20 else None)
        short[s] = dev
        log(f"flash short prompt S{s} B1 Hq32/Hkv8 causal, device time per "
            f"launch: TMA kernel {_us(dev['tma'])}, short-prompt kernel "
            f"{_us(dev['short'])} (the wrapper runs the "
            f"{'short-prompt' if s <= SHORT_SQ else 'TMA'} kernel)")
    q = _randn((1, 32, 7, 128), gen)
    k = _randn((1, 8, 7, 128), gen)
    v = _randn((1, 8, 7, 128), gen)
    kx, vx = (x.repeat_interleave(4, dim=1) for x in (k, v))
    kw = dict(causal=True, return_lse=False)
    ms = profiling.cuda_time_ms(lambda: flash_fwd_short(q, k, v, **kw),
                                iters=20)
    plain = profiling.cuda_time_ms(
        lambda: flash_attention_fwd_plain(q, k, v, **kw), iters=20)
    sdpa = lambda: SDPA(q, kx, vx, is_causal=True)
    lib = profiling.cuda_time_ms(sdpa, iters=20)
    lib_dev = device_ms(sdpa)
    flops = profiling.attention_flops(1, 32, 7, 7, 128, causal=True)
    bound, by = profiling.bound_ms(2 * (q.numel() * 2 + k.numel() +
                                        v.numel()), flops)
    log(f"flash short prompt S7: sdpa device {_ms(lib_dev)} (events "
        f"{lib[0]:.4f} ms), kernel device {_us(short[7]['short'])}")
    timings["S7 short"] = dict(ms=ms[0], plain_ms=plain[0],
                               library_ms=lib[0], bound_ms=bound, bound_by=by,
                               library_device_ms=lib_dev,
                               device_ms_per_launch=short[7]["short"],
                               device_ms_short_prompts=short)
    flash_fwd_tma.launches = flash_fwd_short.launches = 0
    return worst, timings


def _busy_per_call(bd, calls):
    """A breakdown's device busy time per call, or None (not measured)
    when the profiler saw no kernel."""
    return bd["busy_ms"] / calls if bd["kernels"] else None


def device_ms(fn, calls=20, key=None):
    """The card's own time per call of `fn` (torch.profiler, the union of
    the kernels of `calls` calls, after one warm-up call): unlike a CUDA
    event pair it holds none of the host's dispatch.  With `key`, only the
    kernels whose lower-cased name holds it (a wrapper's kernel, not the
    PyTorch work around it).  A reading in which the profiler lost kernels
    (fewer than `calls` times those it saw in one profiled call; it does so
    after many profiled sessions in one process; with `key`, of that
    kernel alone) is taken again, up to three times; None if none was
    whole (not measured).  `key` may be a tuple of such names: their
    kernels' time together."""
    from aule_tpu_torch.utils import profiling

    cats = ({} if key is None else
            {"k": list(key) if isinstance(key, tuple) else [key]})
    part = "other" if key is None else "k"

    def count(bd):
        return bd["kernels_by_category"][part]

    fn()
    per_call = count(profiling.device_breakdown(fn, cats))
    for _ in range(3):
        bd = profiling.device_breakdown(lambda: [fn() for _ in range(calls)],
                                        cats)
        if per_call > 0 and count(bd) == calls * per_call:
            return (bd["busy_ms"] if key is None
                    else bd["by_category_ms"]["k"]) / calls
    return None


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def _us(x) -> str:
    return "not measured" if x is None else f"{x * 1e3:.2f} us"


def _vecdot_times(o, do):
    """(CUDA-event median, device time) of torch.linalg.vecdot(o, do,
    dim=-1), the one PyTorch call that computes delta's rowsum(o * do): f32
    rows on f32 inputs; on bf16/f16 inputs its rows come rounded to the
    input type, where the delta kernels return f32."""
    from aule_tpu_torch.utils import profiling

    fn = lambda: torch.linalg.vecdot(o, do, dim=-1)
    return profiling.cuda_time_ms(fn, iters=20)[0], device_ms(fn)


def _bwd_inputs(gen, shape, sq, sk, causal, window, dt, with_dlse, d=128):
    """q, k, v, do (and dlse) from the generator; o and lse from the
    forward kernel, as training has them."""
    from aule_tpu_torch.ops.flash import flash_attention_fwd

    b, hq, hkv = shape
    q = _randn((b, hq, sq, d), gen, dt)
    k = _randn((b, hkv, sk, d), gen, dt)
    v = _randn((b, hkv, sk, d), gen, dt)
    do = _randn((b, hq, sq, d), gen, dt)
    dlse = _randn((b, hq, sq), gen, torch.float32) if with_dlse else None
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window_size=window,
                                 return_lse=True)
    return q, k, v, o, lse, do, dlse


def _bwd_timings(gen, shape, s, window):
    """Delta, dQ, dK/dV and the whole backward (the three kernels) at one
    causal shape: kernel (CUDA events, and the card's own time per call
    from torch.profiler), plain and bound; the library yardstick is the
    backward of F.scaled_dot_product_attention on the same tensors (K/V
    expanded to the q heads; dq, dk, dv in one call), timed only."""
    from aule_tpu_torch.ops import flash_vjp as fv
    from aule_tpu_torch.ops.reference import build_mask
    from aule_tpu_torch.utils import profiling

    b, hq, hkv = shape
    q, k, v, o, lse, do, _ = _bwd_inputs(gen, shape, s, s, True, window,
                                         torch.bfloat16, False)
    di = fv.attention_delta(o, do)
    kw = dict(causal=True, window=window)
    if window > 0:
        fwd_flops = profiling.window_attention_flops(b, hq, s, 128, window)
        mask = dict(attn_mask=build_mask(s, s, True, window, device="cuda"))
    else:
        fwd_flops = profiling.attention_flops(b, hq, s, s, 128, causal=True)
        mask = dict(is_causal=True)
    qx = q.detach().requires_grad_(True)
    kx = k.repeat_interleave(hq // hkv, dim=1).requires_grad_(True)
    vx = v.repeat_interleave(hq // hkv, dim=1).requires_grad_(True)
    ref = SDPA(qx, kx, vx, **mask)
    sdpa_bwd = lambda: torch.autograd.grad(ref, (qx, kx, vx), do,
                                           retain_graph=True)
    lib = profiling.cuda_time_ms(sdpa_bwd, iters=20)
    lib_dev = device_ms(sdpa_bwd)
    qkvdo = 2 * (2 * q.numel() + k.numel() + v.numel())  # bytes
    stats = 4 * lse.numel()
    out = {}
    for name, fn, plain, flops, nbytes in (
            # f32 products and sums, outside the tensor cores
            ("delta", lambda: fv.attention_delta(o, do),
             lambda: fv.attention_delta_plain(o, do), 2 * o.numel(),
             2 * (o.numel() + do.numel()) + stats),
            ("dq", lambda: fv.flash_bwd_dq(q, k, v, do, lse, di, **kw),
             lambda: fv.flash_bwd_dq_plain(q, k, v, do, lse, di, **kw),
             profiling.attention_bwd_flops(fwd_flops, 3),
             qkvdo + 2 * q.numel() + 2 * stats),
            ("dkv", lambda: fv.flash_bwd_dkv(q, k, v, do, lse, di, **kw),
             lambda: fv.flash_bwd_dkv_plain(q, k, v, do, lse, di, **kw),
             profiling.attention_bwd_flops(fwd_flops, 4),
             qkvdo + 2 * (k.numel() + v.numel()) + 2 * stats),
            ("both", lambda: fv.flash_attention_bwd(q, k, v, o, lse, do,
                                                    **kw),
             lambda: fv.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw),
             profiling.attention_bwd_flops(fwd_flops),
             qkvdo + 2 * o.numel() + 2 * q.numel()
             + 2 * (k.numel() + v.numel()) + stats)):
        ms = profiling.cuda_time_ms(fn, iters=20)
        dev = device_ms(fn)
        plain_ms = profiling.cuda_time_ms(plain, iters=20)
        bound, by = profiling.bound_ms(
            nbytes, flops, profiling.H100_F32_FLOPS if name == "delta"
            else profiling.H100_BF16_FLOPS)
        lib_ms, lib_dev_ms = lib[0], lib_dev
        if name == "delta":  # torch.linalg.vecdot(o, do): rowsum(o * do)
            lib_ms, lib_dev_ms = _vecdot_times(o, do)
        out[name] = dict(ms=ms[0], device_ms=dev, plain_ms=plain_ms[0],
                         library_ms=lib_ms, library_device_ms=lib_dev_ms,
                         bound_ms=bound,
                         bound_by=by, gflop=flops / 1e9, mbytes=nbytes / 1e6)
        rate = flops / (dev if dev is not None else ms[0]) / 1e9
        log(f"flash bwd time {name} B{b} Hq{hq}/Hkv{hkv} S{s} D128 bf16 "
            f"causal{f' window {window}' if window > 0 else ''}: kernel "
            f"{ms[0]:.4f} ms (min {ms[1]:.4f} max {ms[2]:.4f}), device "
            f"{_ms(dev)}, {rate:.1f} TFLOP/s of {flops / 1e9:.1f} GFLOP; "
            f"plain {plain_ms[0]:.4f} ms; library {lib_ms:.4f} ms, "
            f"device {_ms(lib_dev_ms)}; bound {bound:.4f} ms ({by}; "
            f"{nbytes / 1e6:.1f} MB)")
    del ref, qx, kx, vx
    return out


def check_flash_bwd(gen):
    """The delta, dQ and dK/dV kernels against their plain versions at
    every mask the forward takes (delta within DELTA_TOL, with and without
    an lse cotangent; every dQ, dK, dV row within ROW_TOL of its size), two
    runs bitwise equal, `flash_attention_bwd` on a non-contiguous do equal
    to the three kernels; times at the Llama-3-8B layer, bench.py's B4 row
    and the S4096 window.  Returns the worst errors and the times."""
    from aule_tpu_torch.ops import flash_vjp as fv

    bf, fp = torch.bfloat16, torch.float16
    cases = [  # (label, (B, Hq, Hkv), Sq, Sk, causal, window, dtype, dlse)
        ("Llama-3-8B layer S2048 causal", LAYER, 2048, 2048, True, -1, bf,
         False),
        ("bench.py fwd+bwd row B4 Hq32/Hkv8 S2048 causal", (4, 32, 8), 2048,
         2048, True, -1, bf, False),
        ("ragged S1000 causal", LAYER, 1000, 1000, True, -1, bf, False),
        ("Sq300 Sk900 causal", LAYER, 300, 900, True, -1, bf, False),
        ("Sq900 Sk300 causal", LAYER, 900, 300, True, -1, bf, False),
        ("Sq300 Sk900 non-causal", LAYER, 300, 900, False, -1, bf, False),
        ("S777 non-causal", LAYER, 777, 777, False, -1, bf, False),
        ("group 1 Hq8/Hkv8 S777 causal", (1, 8, 8), 777, 777, True, -1, bf,
         False),
        ("group 2 Hq16/Hkv8 S1000 causal", (1, 16, 8), 1000, 1000, True, -1,
         bf, False),
        ("group 8 Hq64/Hkv8 S1000 causal", (1, 64, 8), 1000, 1000, True, -1,
         bf, False),
        ("f16 S1000 causal", LAYER, 1000, 1000, True, -1, fp, False),
        ("non-zero dlse S1000 causal", LAYER, 1000, 1000, True, -1, bf,
         True),
        ("S4096 causal window 256 (_win_dq/_win_dkv class)", LAYER, 4096,
         4096, True, 256, bf, False),
        ("S4096 bidirectional window 256", LAYER, 4096, 4096, False, 256, bf,
         False),
        ("Sq700 Sk300 non-causal window 100 (rows that see nothing)", LAYER,
         700, 300, False, 100, bf, True),
        # two batches of clusters, a ragged last 128-key tile
        ("B2 S1100 causal (ragged key tiles)", (2, 32, 8), 1100, 1100, True,
         -1, bf, True),
    ]
    worst = {}
    for label, shape, sq, sk, causal, window, dt, with_dlse in cases:
        q, k, v, o, lse, do, dlse = _bwd_inputs(gen, shape, sq, sk, causal,
                                                window, dt, with_dlse)
        for cot in (None, dlse) if with_dlse else (None,):
            hold_delta(f"flash bwd delta {label}"
                       f"{' with dlse' if cot is not None else ''}",
                       fv.attention_delta(o, do, cot), o, do, cot, worst)
        di = fv.attention_delta(o, do, dlse)
        kw = dict(causal=causal, window=window)
        dq = fv.flash_bwd_dq(q, k, v, do, lse, di, **kw)
        dk, dv = fv.flash_bwd_dkv(q, k, v, do, lse, di, **kw)
        pdq = fv.flash_bwd_dq_plain(q, k, v, do, lse, di, **kw)
        hold(f"flash bwd dQ {label}", dq, pdq, None, None, ROW_TOL[dt],
             worst, "dq", BWD_FLOOR)
        del pdq
        pdk, pdv = fv.flash_bwd_dkv_plain(q, k, v, do, lse, di, **kw)
        hold(f"flash bwd dK {label}", dk, pdk, None, None, ROW_TOL[dt],
             worst, "dkv", BWD_FLOOR)
        hold(f"flash bwd dV {label}", dv, pdv, None, None, ROW_TOL[dt],
             worst, "dkv", BWD_FLOOR)
        del pdk, pdv
        # deterministic: no atomics, a fixed order of every sum
        dq2 = fv.flash_bwd_dq(q, k, v, do, lse, di, **kw)
        dk2, dv2 = fv.flash_bwd_dkv(q, k, v, do, lse, di, **kw)
        if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
                and torch.equal(dv, dv2)
                and torch.equal(di, fv.attention_delta(o, do, dlse))):
            raise AssertionError(f"flash bwd {label}: two runs differ")
        # the whole backward from a transposed (non-contiguous) do, as the
        # heads merge hands it over, gives the kernels' bits
        do_t = do.transpose(1, 2).contiguous().transpose(1, 2)
        got = fv.flash_attention_bwd(q, k, v, o, lse, do_t, dlse=dlse, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, (dq, dk, dv))):
            raise AssertionError(f"flash bwd {label}: flash_attention_bwd "
                                 f"differs from its three kernels")
        del q, k, v, o, lse, do, dlse, di, dq, dk, dv, dq2, dk2, dv2, got
    log("flash bwd: every case bitwise equal over two runs and through "
        "flash_attention_bwd")
    timings = {"layer": _bwd_timings(gen, LAYER, 2048, -1),
               "B4": _bwd_timings(gen, (4, 32, 8), 2048, -1),
               "window": _bwd_timings(gen, LAYER, 4096, 256)}
    fv.flash_bwd_dq.launches = fv.flash_bwd_dkv.launches = 0
    fv.attention_delta.launches = 0
    torch.cuda.empty_cache()
    return worst, timings


F32_BWD_SEED = SEED + 15  # a generator of its own: earlier checks' inputs
# (label, (B, Hq, Hkv), Sq, Sk, D, causal, window, dlse)
F32_BWD_CASES = [
    ("Llama-3-8B layer S2048 causal", LAYER, 2048, 2048, 128, True, -1,
     False),
    ("GPT-2 layer B1 Hq12 S1024 D64 causal", (1, 12, 12), 1024, 1024, 64,
     True, -1, False),
    ("D256 group 8 Hq8/Hkv1 S2048 causal", (1, 8, 1), 2048, 2048, 256, True,
     -1, False),
    ("Sq300 Sk900 causal", LAYER, 300, 900, 128, True, -1, False),
    ("Sq900 Sk300 causal", LAYER, 900, 300, 128, True, -1, False),
    ("S777 non-causal", LAYER, 777, 777, 128, False, -1, False),
    ("group 1 Hq8/Hkv8 S777 causal", (1, 8, 8), 777, 777, 128, True, -1,
     False),
    ("group 3 Hq24/Hkv8 S1000 causal", (1, 24, 8), 1000, 1000, 128, True,
     -1, False),
    ("group 8 Hq64/Hkv8 S1000 causal", (1, 64, 8), 1000, 1000, 128, True,
     -1, False),
    ("S4096 causal window 256", LAYER, 4096, 4096, 128, True, 256, False),
    ("S4096 bidirectional window 256", LAYER, 4096, 4096, 128, False, 256,
     False),
    ("Sq700 Sk300 non-causal window 100, non-zero dlse (rows that see "
     "nothing)", LAYER, 700, 300, 128, False, 100, True),
    ("D256 group 1 Hq4/Hkv4 Sq700 Sk300 non-causal window 100, non-zero "
     "dlse", (1, 4, 4), 700, 300, 256, False, 100, True),
    ("D256 group 3 Hq6/Hkv2 S777 causal", (1, 6, 2), 777, 777, 256, True, -1,
     False),
]


def check_flash_bwd_f32():
    """The f32 backward's kernels (flash_generic.cu's delta, flash_f32_bwd.
    cu's dQ and dK/dV, at D 256 its pairs of warps on the two halves of the
    head dim) against their plain versions over
    F32_BWD_CASES: every dQ, dK, dV row within ROW_TOL[f32] of its size (at
    least F32_BWD_FLOOR of the largest |value|, for rows that cancel), two
    runs bitwise equal, `flash_attention_bwd` equal to the three kernels.
    Returns the worst errors of dQ and dK/dV and each case's."""
    from aule_tpu_torch.ops import flash_vjp as fv

    gen = torch.Generator(device="cuda")
    gen.manual_seed(F32_BWD_SEED)
    f32 = torch.float32
    worst, cases = {}, {}
    for label, shape, sq, sk, d, causal, window, with_dlse in F32_BWD_CASES:
        q, k, v, o, lse, do, dlse = _bwd_inputs(gen, shape, sq, sk, causal,
                                                window, f32, with_dlse, d)
        di = fv.attention_delta_generic(o, do, dlse)
        kw = dict(causal=causal, window=window)
        what = f"flash f32 bwd {label} D{d}"
        dkv = fv.flash_bwd_f32_dkv
        dq = fv.flash_bwd_f32_dq(q, k, v, do, lse, di, **kw)
        dk, dv = dkv(q, k, v, do, lse, di, **kw)
        errs = {"dq": hold(f"{what} dQ", dq, fv.flash_bwd_dq_plain(
            q, k, v, do, lse, di, **kw), None, None, ROW_TOL[f32], worst,
            "dq", F32_BWD_FLOOR)}
        pdk, pdv = fv.flash_bwd_dkv_plain(q, k, v, do, lse, di, **kw)
        ek = hold(f"{what} dK", dk, pdk, None, None, ROW_TOL[f32], worst,
                  "dkv", F32_BWD_FLOOR)
        ev = hold(f"{what} dV", dv, pdv, None, None, ROW_TOL[f32], worst,
                  "dkv", F32_BWD_FLOOR)
        errs["dkv"] = tuple(max(a, b) for a, b in zip(ek, ev))
        cases[label] = errs
        del pdk, pdv
        dq2 = fv.flash_bwd_f32_dq(q, k, v, do, lse, di, **kw)
        dk2, dv2 = dkv(q, k, v, do, lse, di, **kw)
        got = fv.flash_attention_bwd(q, k, v, o, lse, do, dlse=dlse, **kw)
        if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
                and torch.equal(dv, dv2)):
            raise AssertionError(f"{what}: two runs differ")
        if not all(torch.equal(a, b) for a, b in zip(got, (dq, dk, dv))):
            raise AssertionError(f"{what}: flash_attention_bwd differs from "
                                 f"its three kernels")
        del q, k, v, o, lse, do, dlse, di, dq, dk, dv, dq2, dk2, dv2, got
    log("flash f32 bwd: every case bitwise equal over two runs and through "
        "flash_attention_bwd")
    fv.flash_bwd_f32_dq.launches = fv.flash_bwd_f32_dkv.launches = 0
    fv.attention_delta_generic.launches = 0
    torch.cuda.empty_cache()
    return worst, cases


def hold_delta(what, di, o, do, dlse, worst):
    """Hold the delta kernel's di to its plain version's: each row within
    DELTA_TOL of the sum of its terms' sizes, sum |o do| + |dlse|; all
    finite."""
    from aule_tpu_torch.ops import flash_vjp as fv

    plain = fv.attention_delta_plain(o, do, dlse)
    size = (o.float() * do.float()).abs().sum(-1)
    if dlse is not None:
        size = size + dlse.abs()
    diff = (di - plain).abs()
    rel = float((diff / size.clamp_min(1e-30)).max())
    ok = rel <= DELTA_TOL and bool(torch.isfinite(di).all())
    log(f"{what}: max|di-plain| {float(diff.max()):.3e}, relative to the "
        f"row's terms {rel:.3e} (<= {DELTA_TOL:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{what}")
    worst["delta"] = tuple(max(a, b) for a, b in zip(
        worst.get("delta", (0.0, 0.0, 0.0)), (float(diff.max()), rel, 0.0)))


def _decode_inputs(gen, lens, max_pages, page=16, shuffle=False, hq=32,
                   dtype=torch.bfloat16, hkv=8):
    """A fused pool of `hkv` kv heads holding len_b tokens per sequence;
    tables -1 past the used pages; page 0 scratch filled with garbage."""
    from aule_tpu_torch.ops.paged_fused import fused_pool_shape

    batch = len(lens)
    used = [-(-n // page) for n in lens]
    num_pages = 1 + sum(used)
    pool = _randn(fused_pool_shape(num_pages, hkv, page, 128), gen, dtype)
    pool[0] = 1e4
    ids = np.arange(1, num_pages)
    if shuffle:
        ids = np.random.default_rng(SEED).permutation(ids)
    bt = np.full((batch, max_pages), -1, np.int32)
    at = 0
    for b, n in enumerate(used):
        bt[b, :n] = ids[at:at + n]
        at += n
    q = _randn((batch, hq, 128), gen, dtype)
    return (q, pool, torch.from_numpy(bt).cuda(),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def quantize_pool(pool, dtype, scale_dtype=torch.bfloat16):
    """A bf16 fused pool as (payload pool, packed scale tile), quantized
    per token by the port's quantize_kv."""
    from aule_tpu_torch.ops.paged_fused import pack_fused_scales
    from aule_tpu_torch.ops.quant import quantize_kv

    payload, sc = quantize_kv(pool, dtype)          # sc [P, 2, Hkv, page]
    return payload, pack_fused_scales(sc[:, 0].transpose(0, 1),
                                      sc[:, 1].transpose(0, 1),
                                      dtype=scale_dtype)


def _tol(dtype, int8_dot=False):
    return ROW_TOL[dtype] + (INT8_DOT_EXTRA if int8_dot else 0.0)


def _fused_operands_bytes(hkv, qdt, tokens):
    """The bytes of the live K/V of `tokens` cached tokens in a fused pool
    of `hkv` kv heads: bf16, or 1-byte payloads with bf16 scales (qdt)."""
    from aule_tpu_torch.utils import profiling

    if qdt is None:
        return profiling.paged_kv_bytes(tokens, hkv, 128, 2)
    return profiling.paged_kv_bytes(tokens, hkv, 128, 1, scale_bytes=2)


def _fused_operands(pool, qdt, tokens):
    """A bf16 fused pool as a timed kernel reads it (itself, or quantized
    by quantize_pool with bf16 scales: qdt), its K and V (dequantized)
    head-major [Hkv, P - 1, page, D] without the scratch page, and the
    bytes of the live K/V of `tokens` cached tokens."""
    from aule_tpu_torch.ops.paged_fused import dequantize_pool

    nbytes = _fused_operands_bytes(pool.shape[2], qdt, tokens)
    if qdt is None:
        kh, vh = (pool[1:, i].transpose(0, 1) for i in (0, 1))
        return pool, None, kh, vh, nbytes
    pl, sc = quantize_pool(pool, qdt)
    kh, vh = dequantize_pool(pl[1:], sc[1:])
    return pl, sc, kh, vh, nbytes


def _dense_kv(kh, vh, batch, ctx, group):
    """The dense yardstick's K and V: head-major [Hkv, P, page, D] whose
    pages hold the sequences in order -> [B, Hq, ctx, D] bf16, GQA
    expanded."""
    return tuple(x.reshape(x.shape[0], batch, ctx, x.shape[-1]).transpose(
        0, 1).to(torch.bfloat16).repeat_interleave(group, dim=1)
        for x in (kh, vh))


# The decode's timed shapes: (label, B, context).  B8 ctx4096 is bench.py's
# headline decode row, B8 ctx1024 the engine's decode context, B1 ctx4096
# the shape where a single sequence must fill the card by its splits.
DECODE_SHAPES = (("B8 ctx4096", 8, 4096), ("B8 ctx1024", 8, 1024),
                 ("B1 ctx4096", 1, 4096))
# Cases that pin the decode's split-KV partition (ops/decode_split.py): at
# B8 x Hkv8 over a 4352-token table the kernel cuts each sequence's live
# tokens into 9 ranges of ceil(n / 9) tokens rounded up to 4.  They draw
# from generators of their own, so the inputs of every later check are
# those they had without them.
DECODE_SPLIT_CASES = [  # (label, lens, max_pages, page, shuffle, window)
    ("B1 ctx4096 (17 splits)", [4096], 272, 16, False, -1),
    ("lengths 1 and 17 over 4352 (most splits empty)", [1, 17], 272, 16,
     True, -1),
    ("lengths on split boundaries (9 x 4k) and past them",
     [4068, 36, 3600, 9, 33, 4096, 2304, 4095], 272, 16, True, -1),
    ("trailing window 3001, t_lo 1095 past the table's front",
     [4096, 3001, 3002, 1, 0, 4000, 2048, 3100], 272, 16, True, 3001),
    ("page 64", [4096, 1000, 1, 0, 63, 64, 65, 4095], 68, 64, True, -1),
]


def _decode_nsplit(batch, max_pages, page, window):
    from aule_tpu_torch.ops import decode_split

    return decode_split.num_splits(batch, 8, max_pages * page, window,
                                   decode_split.sm_count(torch.device(DEV)))


def _twice(what, fn):
    """Run a kernel call twice; the two must give the same bits."""
    a, b = fn(), fn()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{what}: two runs differ")
    return a


def _decode_time(what, kernel, plain, sdpa, key, kv_bytes, batch, ctx,
                 hq=32, max_pages=272):
    """Times of one decode call at B x ctx live tokens (Hq `hq`, D128,
    tables of `max_pages` pages): CUDA-event medians of the kernel, its
    plain version and SDPA on the gathered K/V, and the device time per
    call of the kernel (torch.profiler, its own kernel only) and of SDPA,
    beside the bound (q, out, tables, lengths and the live K/V read once;
    4 B ctx Hq D operations)."""
    from aule_tpu_torch.utils import profiling

    flops = 4.0 * batch * hq * ctx * 128
    nbytes = (kv_bytes + 2 * batch * hq * 128 * 2 + batch * max_pages * 4
              + 4 * batch)
    bound, by = profiling.bound_ms(nbytes, flops)
    ms = profiling.cuda_time_ms(kernel, iters=20)
    pl = profiling.cuda_time_ms(plain, iters=20)
    lib = profiling.cuda_time_ms(sdpa, iters=20)
    dev, dev_lib = device_ms(kernel, key=key), device_ms(sdpa)
    rate = ("" if dev is None else f"{kv_bytes / dev / 1e6:.1f} GB/s of "
            f"live KV, {bound / dev:.3f} of the bound; ")
    log(f"{what}: kernel device {_ms(dev)} (events {ms[0]:.4f} ms, min "
        f"{ms[1]:.4f} max {ms[2]:.4f}), {rate}plain "
        f"{pl[0]:.4f} ms; sdpa on the gathered K/V device {_ms(dev_lib)} "
        f"(events {lib[0]:.4f} ms); bound {bound:.4f} ms ({by}; "
        f"{nbytes / 1e6:.1f} MB)")
    return dict(ms=ms[0], plain_ms=pl[0], library_ms=lib[0], bound_ms=bound,
                bound_by=by, device_ms=dev, library_device_ms=dev_lib)


def check_decode(gen):
    """The paged-decode kernel over bf16, int8 (dot-product and exact
    paths) and fp8 pools on four cases and on the split-KV cases, each
    against its plain version and twice with the same bits; times of the
    four modes at DECODE_SHAPES.  Returns the worst errors per mode and the
    times (the B8 ctx4096 ones at the top level of each mode's dict)."""
    from aule_tpu_torch.ops.paged_fused import (paged_attention_fused,
                                                paged_attention_fused_plain)

    modes = [  # (mode, payload dtype or None for bf16, int8_matmul)
        ("bf16", None, None), ("int8 dot", torch.int8, True),
        ("int8 exact", torch.int8, False),
        ("fp8", torch.float8_e4m3fn, None)]
    cases = [  # (label, lens, shuffle, window)
        ("B8 ctx4096 contiguous", [4096] * 8, False, -1),
        ("mixed 0/1/17/4096 with -1 entries",
         [0, 1, 17, 4096, 4095, 100, 2000, 3000], False, -1),
        ("shuffled page ids", [4096, 1, 17, 333, 4096, 2048, 64, 3001],
         True, -1),
        ("trailing window 1001", [0, 1, 17, 4096, 4095, 100, 2000, 3000],
         True, 1001),
    ]
    worst = {}
    split_gen = torch.Generator(device="cuda")
    split_gen.manual_seed(SEED + 8)
    all_cases = ([(label, lens, 272, 16, shuffle, window, gen)
                  for label, lens, shuffle, window in cases]
                 + [c + (split_gen,) for c in DECODE_SPLIT_CASES])
    for label, lens, max_pages, page, shuffle, window, g in all_cases:
        q, pool, bt, ln = _decode_inputs(g, lens, max_pages, page=page,
                                         shuffle=shuffle)
        nsplit = _decode_nsplit(len(lens), max_pages, page, window)
        for mode, dt, dot in modes:
            pl, sc = (pool, None) if dt is None else quantize_pool(pool, dt)
            kw = dict(kv_scales=sc, window_size=window, int8_matmul=dot,
                      return_lse=True)
            o, lse = _twice(f"paged decode {mode} {label}",
                            lambda: paged_attention_fused(q, pl, bt, ln,
                                                          **kw))
            po, plse = paged_attention_fused_plain(q, pl, bt, ln, **kw)
            hold(f"paged decode {mode} {label} ({nsplit} splits)", o, po,
                 lse, plse, _tol(q.dtype, bool(dot)), worst, mode)

    timings = {}
    time_gen = torch.Generator(device="cuda")
    time_gen.manual_seed(SEED + 9)
    for shape, batch, ctx in DECODE_SHAPES:
        lens = [ctx] * batch
        # B8 ctx4096 draws from the shared generator, as it always has
        q, pool, bt, ln = _decode_inputs(
            gen if shape == "B8 ctx4096" else time_gen, lens, 272)
        nsplit = _decode_nsplit(batch, 272, 16, -1)
        for name, dt, dot in modes:
            pl, sc, kh, vh, kv_bytes = _fused_operands(pool, dt, sum(lens))
            # the dense yardstick: the same K/V gathered (dequantized),
            # one SDPA
            kd, vd = _dense_kv(kh, vh, batch, ctx, 4)
            kw = dict(kv_scales=sc, int8_matmul=dot)
            t = _decode_time(
                f"paged decode time {name} {shape} page16 Hq32/Hkv8 "
                f"({nsplit} splits{'' if dt is None else ', bf16 scales'})",
                lambda: paged_attention_fused(q, pl, bt, ln, **kw),
                lambda: paged_attention_fused_plain(q, pl, bt, ln, **kw),
                lambda: SDPA(q[:, :, None], kd,
                                                       vd),
                "paged_decode_kernel", kv_bytes, batch, ctx)
            t["nsplit"] = nsplit
            if shape == "B8 ctx4096":
                timings[name] = dict(t, shapes={})
            timings[name]["shapes"][shape] = t
            del kd, vd, kh, vh
    paged_attention_fused.launches = 0
    return worst, timings


def _split_pools(pool, qdt, head_dim=None):
    """A fused pool's K and V as split pools [Hkv, P, page, D] (the pool's
    type, or quantized per token by the port's quantize_kv with f32
    scales; D = head_dim of the 128 lanes when given), and the same pools
    in the fused layout (f32 packed scales when quantized)."""
    from aule_tpu_torch.ops.paged_fused import (from_fused_layout,
                                                to_fused_layout)
    from aule_tpu_torch.ops.quant import quantize_kv

    k, v = (x.contiguous() for x in from_fused_layout(pool, head_dim))
    if qdt is None:
        return (k, v, None, None), (pool, None)
    (kq, ks), (vq, vs) = quantize_kv(k, qdt), quantize_kv(v, qdt)
    return (kq, vq, ks, vs), to_fused_layout(kq, vq, ks, vs,
                                             scale_dtype=torch.float32)


def _split_operands(pool, qdt, tokens):
    """_split_pools(pool, qdt) as a timed kernel reads them, then their K
    and V (dequantized) head-major [Hkv, P - 1, page, D] without the
    scratch page, and the bytes of the live K/V of `tokens` cached tokens
    (f32 scales)."""
    from aule_tpu_torch.ops.quant import dequantize_kv
    from aule_tpu_torch.utils import profiling

    (k, v, ks, vs), fused = _split_pools(pool, qdt)
    hkv = k.shape[0]
    if qdt is None:
        return ((k, v, ks, vs), fused, k[:, 1:], v[:, 1:],
                profiling.paged_kv_bytes(tokens, hkv, 128, 2))
    return ((k, v, ks, vs), fused, dequantize_kv(k, ks)[:, 1:],
            dequantize_kv(v, vs)[:, 1:],
            profiling.paged_kv_bytes(tokens, hkv, 128, 1, scale_bytes=4))


SPLIT_MODES = [  # (mode, q and pool dtype, payload dtype or None)
    ("bf16", torch.bfloat16, None), ("f16", torch.float16, None),
    ("int8", torch.bfloat16, torch.int8),
    ("fp8", torch.bfloat16, torch.float8_e4m3fn)]


def check_decode_split(gen):
    """The split-pool paged decode (csrc/paged_decode.cu, SplitPools)
    against its plain version over bf16, f16, int8 and fp8 pools (f32
    scales) on the decode phase's four cases, its split-KV cases and at
    GQA groups 1, 2, 4 and 8, twice with the same bits; it shares the fused
    kernel's partition and arithmetic, so on the same pools in the fused
    layout (f32 packed scales; the exact int8 path) the two give the same
    bits.  Times of the bf16, int8 and fp8 modes at DECODE_SHAPES beside
    the bound, the plain version, SDPA on the gathered K/V and the fused
    kernel on the same pools.  Returns the worst errors per mode and the
    times (the B8 ctx4096 ones at the top level of each mode's dict)."""
    from aule_tpu_torch.ops.paged import paged_attention, paged_attention_plain
    from aule_tpu_torch.ops.paged_fused import paged_attention_fused
    from aule_tpu_torch.utils import profiling

    cases = [  # (label, lens, max_pages, page, shuffle, window, hq)
        ("B8 ctx4096 contiguous", [4096] * 8, 272, 16, False, -1, 32),
        ("mixed 0/1/17/4096 with -1 entries",
         [0, 1, 17, 4096, 4095, 100, 2000, 3000], 272, 16, False, -1, 32),
        ("shuffled page ids", [4096, 1, 17, 333, 4096, 2048, 64, 3001], 272,
         16, True, -1, 32),
        ("trailing window 1001", [0, 1, 17, 4096, 4095, 100, 2000, 3000],
         272, 16, True, 1001, 32)] + [
        (f"group {hq // 8}, shuffled, window 64", [0, 1, 17, 600, 333], 48,
         16, True, 64, hq) for hq in (8, 16, 64)]
    split_gen = torch.Generator(device="cuda")
    split_gen.manual_seed(SEED + 10)
    all_cases = ([c + (gen,) for c in cases]
                 + [(label, lens, max_pages, page, shuffle, window, 32,
                     split_gen) for label, lens, max_pages, page, shuffle,
                    window in DECODE_SPLIT_CASES])
    worst = {}
    for label, lens, max_pages, page, shuffle, window, hq, g in all_cases:
        nsplit = _decode_nsplit(len(lens), max_pages, page, window)
        for mode, dt, qdt in SPLIT_MODES:
            q, pool, bt, ln = _decode_inputs(g, lens, max_pages, page=page,
                                             shuffle=shuffle, hq=hq,
                                             dtype=dt)
            (k, v, ks, vs), (fpool, fsc) = _split_pools(pool, qdt)
            kw = dict(k_scales=ks, v_scales=vs, window_size=window,
                      return_lse=True)
            o, lse = _twice(f"split decode {mode} {label}",
                            lambda: paged_attention(q, k, v, bt, ln, **kw))
            po, plse = paged_attention_plain(q, k, v, bt, ln, **kw)
            hold(f"split decode {mode} {label} ({nsplit} splits)", o, po,
                 lse, plse, ROW_TOL[dt], worst, mode)
            fo, flse = paged_attention_fused(
                q, fpool, bt, ln, kv_scales=fsc, window_size=window,
                int8_matmul=False, return_lse=True)
            if not (torch.equal(o, fo) and torch.equal(lse, flse)):
                raise AssertionError(f"split decode {mode} {label}: not the "
                                     f"fused kernel's bits on the same pools")
            del q, pool, k, v, ks, vs, fpool, fsc, o, lse, po, plse, fo, flse
    log("split decode: every case gives the fused kernel's bits on the same "
        "pools, and the same bits twice")

    timings = {}
    time_gen = torch.Generator(device="cuda")
    time_gen.manual_seed(SEED + 11)
    for shape, batch, ctx in DECODE_SHAPES:
        lens = [ctx] * batch
        q, pool, bt, ln = _decode_inputs(
            gen if shape == "B8 ctx4096" else time_gen, lens, 272)
        nsplit = _decode_nsplit(batch, 272, 16, -1)
        for mode, _, qdt in SPLIT_MODES:
            if mode == "f16":
                continue
            (k, v, ks, vs), (fpool, fsc), kh, vh, kv_bytes = _split_operands(
                pool, qdt, sum(lens))
            # the dense yardstick: pages 1.. hold the sequences in order
            kd, vd = _dense_kv(kh, vh, batch, ctx, 4)
            kw = dict(k_scales=ks, v_scales=vs)
            fused = lambda: paged_attention_fused(q, fpool, bt, ln,
                                                  kv_scales=fsc,
                                                  int8_matmul=False)
            t = _decode_time(
                f"split decode time {mode} {shape} page16 Hq32/Hkv8 "
                f"({nsplit} splits{'' if qdt is None else ', f32 scales'})",
                lambda: paged_attention(q, k, v, bt, ln, **kw),
                lambda: paged_attention_plain(q, k, v, bt, ln, **kw),
                lambda: SDPA(q[:, :, None], kd,
                                                       vd),
                "splitpools", kv_bytes, batch, ctx)
            t["nsplit"] = nsplit
            t["fused_kernel_same_pool_ms"] = profiling.cuda_time_ms(
                fused, iters=20)[0]
            t["fused_kernel_same_pool_device_ms"] = device_ms(
                fused, key="fusedpool")
            log(f"split decode time {mode} {shape}: the fused kernel on the "
                f"same pools device "
                f"{_ms(t['fused_kernel_same_pool_device_ms'])} (events "
                f"{t['fused_kernel_same_pool_ms']:.4f} ms)")
            if shape == "B8 ctx4096":
                timings[mode] = dict(t, shapes={})
            timings[mode]["shapes"][shape] = t
            del k, v, ks, vs, fpool, fsc, kh, vh, kd, vd
    paged_attention.launches = 0
    paged_attention_fused.launches = 0
    torch.cuda.empty_cache()
    return worst, timings


def _prefill_inputs(gen, hist, chunk, s_pad, max_pages=272, shuffle=True,
                    dtype=torch.bfloat16, hq=32, page=16, hkv=8):
    """A bf16 fused pool of `page`-token pages and `hkv` kv heads holding
    hist[b] + chunk[b] tokens per sequence (random K/V), chunk queries
    [B, hq, s_pad, 128], tables with shuffled page ids and -1 tails, page 0
    scratch filled with garbage."""
    from aule_tpu_torch.ops.paged_fused import fused_pool_shape

    total = [h + c for h, c in zip(hist, chunk)]
    used = [-(-n // page) for n in total]
    num_pages = 1 + sum(used)
    pool = _randn(fused_pool_shape(num_pages, hkv, page, 128), gen, dtype)
    pool[0] = 1e4
    ids = np.arange(1, num_pages)
    if shuffle:
        ids = np.random.default_rng(SEED).permutation(ids)
    bt = np.full((len(hist), max_pages), -1, np.int32)
    at = 0
    for b, n in enumerate(used):
        bt[b, :n] = ids[at:at + n]
        at += n
    q = _randn((len(hist), hq, s_pad, 128), gen, dtype)
    dev = "cuda"
    return (q, pool, torch.from_numpy(bt).to(dev),
            torch.tensor(total, dtype=torch.int32, device=dev),
            torch.tensor(hist, dtype=torch.int32, device=dev))


def _chunk_prefill_times(q, pool, bt, ln, qoff, modes, what, hist=3488,
                         window=-1):
    """The paged prefill of one chunk (q [1, Hq, S, 128] at q_offset
    `hist` over the hist + S tokens of a bf16 pool of 16-token pages in
    order, from _prefill_inputs; the engine's chunk case by default: 512
    queries at 3488 over 4000), causal, with a window W when window > 0,
    for each (mode, payload dtype or None) of `modes`: the kernel twice
    with the same bits, held to its plain version (ROW_TOL, LSE_TOL); the
    CUDA-event medians of the kernel, its plain version and SDPA with a
    positional mask on the gathered (dequantized) K/V, GQA expanded, and
    the device time per call of the kernel and of SDPA, beside the bound
    (the K/V the window leaves visible read once).  `what` labels the log
    lines, with a {} for the mode.  Returns the times and errors by
    mode."""
    from aule_tpu_torch.ops.paged_prefill import (
        paged_attention_prefill, paged_attention_prefill_plain)
    from aule_tpu_torch.ops.reference import build_mask
    from aule_tpu_torch.utils import profiling

    hq, hkv, s = q.shape[1], pool.shape[2], q.shape[2]
    total = hist + s
    mask = build_mask(s, total, True, window, device="cuda", q_offset=hist)
    flops = profiling.paged_prefill_flops([hist], [s], hq, 128, window)
    live = total - (max(0, hist - window) if window > 0 else 0)
    where = f"chunk {s} at {hist} over {total}" + (
        f" window {window}" if window > 0 else "")
    timings = {}
    for name, dt in modes:
        pl, sc, kh, vh, _ = _fused_operands(pool, dt, total)
        kv_bytes = _fused_operands_bytes(hkv, dt, live)
        kd, vd = _dense_kv(kh, vh, 1, total, hq // hkv)
        kw = dict(q_offsets=qoff, kv_scales=sc, window_size=window)
        kernel = lambda **x: paged_attention_prefill(q, pl, bt, ln, **kw,
                                                     **x)
        plain_fn = lambda **x: paged_attention_prefill_plain(q, pl, bt, ln,
                                                             **kw, **x)
        label = f"{what.format(name)}, {where}"
        o, lse = _twice(label, lambda: kernel(return_lse=True))
        po, plse = plain_fn(return_lse=True)
        err = hold(label, o, po, lse, plse, ROW_TOL[q.dtype])
        del o, lse, po, plse
        sdpa = lambda: SDPA(q, kd, vd, attn_mask=mask)
        ms = profiling.cuda_time_ms(kernel, iters=20)
        plain = profiling.cuda_time_ms(plain_fn, iters=20)
        lib = profiling.cuda_time_ms(sdpa, iters=20)
        # the card's own time per call (torch.profiler): a CUDA-event pair
        # around one call also holds the host's dispatch of the wrapper
        dev, dev_lib = device_ms(kernel), device_ms(sdpa)
        nbytes = 2 * q.numel() * 2 + kv_bytes + bt.shape[1] * 4 + 3 * 4
        bound, by = profiling.bound_ms(nbytes, flops)
        timings[name] = dict(ms=ms[0], plain_ms=plain[0], library_ms=lib[0],
                             bound_ms=bound, bound_by=by, device_ms=dev,
                             library_device_ms=dev_lib, err=err)
        rate = "" if dev is None else f", {flops / dev / 1e9:.1f} TFLOP/s"
        log(f"{label}, "
            f"Hq{hq}/Hkv{hkv} D128 page16: kernel {ms[0]:.4f} ms (min "
            f"{ms[1]:.4f} max {ms[2]:.4f}), device {_ms(dev)}{rate}; plain "
            f"{plain[0]:.4f} ms; sdpa on the gathered K/V with a positional "
            f"mask {lib[0]:.4f} ms, device {_ms(dev_lib)}; bound "
            f"{bound:.4f} ms ({by})")
        del kd, vd, kh, vh
    return timings


def check_prefill(gen):
    """The paged-prefill kernel against its plain version on bf16, f16,
    int8 and fp8 pools; its time in each pool mode at the engine's chunk
    case.  Returns the worst errors per mode and the times."""
    from aule_tpu_torch.config import DEFAULT_MASK_VALUE
    from aule_tpu_torch.ops.paged_prefill import (
        paged_attention_prefill, paged_attention_prefill_plain)

    cases = [  # (label, hist, chunk, s_pad, window, pool kinds, page)
        ("chunk 512 at q_offset 3488 over 4000", [3488], [512], 512, -1,
         ("bf16", "int8", "fp8"), 16),
        ("chunk 512 at 3488, window 256", [3488], [512], 512, 256,
         ("bf16", "int8", "fp8"), 16),
        ("ragged B4 with rows past context_lens", [1000, 0, 2500, 63],
         [200, 130, 1, 77], 200, -1, ("bf16", "int8", "fp8", "f16",
                                      "int8 f32-scales"), 16),
        ("first chunk, S 300", [0], [300], 300, -1, ("bf16",), 16),
        ("page 64, ragged B2 chunks 512 and 1 over 4000 and 901",
         [3488, 900], [512, 1], 512, -1, ("bf16", "int8", "fp8"), 64),
    ]
    worst = {}
    # the 64-token-page case draws from a generator of its own, so the
    # inputs of every check after it are those they had without it
    page_gen = torch.Generator(device="cuda")
    page_gen.manual_seed(SEED + 64)
    for label, hist, chunk, s_pad, window, kinds, page in cases:
        for kind in kinds:
            dt = torch.float16 if kind == "f16" else torch.bfloat16
            q, pool, bt, ln, qoff = _prefill_inputs(
                gen if page == 16 else page_gen, hist, chunk, s_pad,
                dtype=dt, page=page)
            sc = None
            if kind.startswith("int8") or kind == "fp8":
                qdt = torch.int8 if kind.startswith("int8") \
                    else torch.float8_e4m3fn
                sdt = torch.float32 if "f32" in kind else torch.bfloat16
                pool, sc = quantize_pool(pool, qdt, sdt)
            kw = dict(q_offsets=qoff, kv_scales=sc, window_size=window,
                      return_lse=True)
            o, lse = paged_attention_prefill(q, pool, bt, ln, **kw)
            po, plse = paged_attention_prefill_plain(q, pool, bt, ln, **kw)
            what = f"paged prefill {kind} {label}"
            for b, n in enumerate(chunk):  # padding rows: exact zeros
                if not (bool((o[b, :, n:] == 0).all()) and bool(
                        (lse[b, :, n:] == DEFAULT_MASK_VALUE).all())):
                    raise AssertionError(f"{what}: padding rows of sequence "
                                         f"{b} are not zeros")
            hold(what, o, po, lse, plse, ROW_TOL[dt], worst,
                 "bf16" if kind == "f16" else kind.split()[0])

    q, pool, bt, ln, qoff = _prefill_inputs(gen, [3488], [512], 512,
                                            shuffle=False)
    timings = _chunk_prefill_times(
        q, pool, bt, ln, qoff, (("bf16", None), ("int8", torch.int8),
                                ("fp8", torch.float8_e4m3fn)),
        "paged prefill time {} pool")
    paged_attention_prefill.launches = 0
    return worst, timings


# The GQA groups check_groups holds beyond the main path's 4: (Hq, Hkv).
# Groups 1, 2 and 8 have decode instantiations of their own; 3, 5, 6 and 7
# run one 8-row tile with rows masked, 12 and 16 two, 24 and 32 (MQA, Hkv
# 1) three and four; the prefill takes 1, 2, 4 or 8 heads a block, the
# largest that divides the group.
GROUPS = [(8, 8), (16, 8), (64, 8)]
ODD_GROUPS = [(24, 8), (40, 8), (48, 8), (56, 8), (96, 8), (128, 8), (24, 1),
              (32, 1)]


def check_groups(gen, decode_worst, prefill_worst, split_worst):
    """Both paged kernels at GQA groups 1, 2 and 8 (Hkv 8; the main path's
    group is 4) in every pool mode, and with f16 q, against their plain
    versions; then, from a generator of their own, at ODD_GROUPS (groups
    3, 5, 6, 7, 12, 16, 24 and 32): the decode over fused pools in every
    pool mode (f16 q too) with no window (3 splits) and a trailing window
    of 64 (one split), the prefill with a window of 64, and the decode
    over split pools (bf16, f16, int8 and fp8 with f32 scales), which must
    give the fused kernel's bits on the same pools, each call twice with
    the same bits.  The errors join each mode's worst; returns the odd
    groups' worst per (kernel mode, group), keyed "decode bf16 G3" and so
    on."""
    from aule_tpu_torch.ops.paged import paged_attention, paged_attention_plain
    from aule_tpu_torch.ops.paged_fused import (paged_attention_fused,
                                                paged_attention_fused_plain)
    from aule_tpu_torch.ops.paged_prefill import (
        paged_attention_prefill, paged_attention_prefill_plain)

    kinds = [  # (label, q and pool dtype, payload dtype, int8_matmul,
        #         decode mode, prefill mode)
        ("bf16", torch.bfloat16, None, None, "bf16", "bf16"),
        ("int8 dot", torch.bfloat16, torch.int8, True, "int8 dot", "int8"),
        ("int8 exact", torch.bfloat16, torch.int8, False, "int8 exact",
         "int8"),
        ("fp8", torch.bfloat16, torch.float8_e4m3fn, None, "fp8", "fp8"),
        ("f16 q, f16 pool", torch.float16, None, None, "bf16", "bf16"),
        ("f16 q, int8 dot", torch.float16, torch.int8, True, "int8 dot",
         "int8"),
        ("f16 q, fp8", torch.float16, torch.float8_e4m3fn, None, "fp8",
         "fp8")]
    by_group = {}

    def note(key, errs):
        by_group[key] = tuple(max(a, b) for a, b in zip(
            by_group.get(key, (0.0, 0.0, 0.0)), errs))

    odd_gen = torch.Generator(device="cuda")
    odd_gen.manual_seed(SEED + 12)
    for (hq, hkv), g in ([(x, gen) for x in GROUPS]
                         + [(x, odd_gen) for x in ODD_GROUPS]):
        odd = g is odd_gen
        name = f"group {hq // hkv}" + (" (MQA)" if hkv == 1 else "")
        for label, dt, qdt, dot, dmode, pmode in kinds:
            q, pool, bt, ln = _decode_inputs(g, [0, 1, 17, 600, 333], 48,
                                             shuffle=True, hq=hq, dtype=dt,
                                             hkv=hkv)
            q2, pool2, bt2, ln2, qoff = _prefill_inputs(
                g, [300, 0], [100, 37], 100, max_pages=48, dtype=dt, hq=hq,
                hkv=hkv)
            sc = sc2 = None
            if qdt is not None:
                pool, sc = quantize_pool(pool, qdt)
                pool2, sc2 = quantize_pool(pool2, qdt)
            for window in (-1, 64) if odd else (-1,):
                kw = dict(kv_scales=sc, int8_matmul=dot, return_lse=True,
                          window_size=window)
                what = f"{name} {label}: decode" + (
                    f" (window {window})" if window > 0 else "")
                o, lse = (_twice(what, lambda: paged_attention_fused(
                    q, pool, bt, ln, **kw)) if odd
                    else paged_attention_fused(q, pool, bt, ln, **kw))
                po, plse = paged_attention_fused_plain(q, pool, bt, ln, **kw)
                errs = hold(what, o, po, lse, plse, _tol(dt, bool(dot)),
                            decode_worst, dmode)
                if odd:
                    note(f"decode {dmode} G{hq // hkv}", errs)
            kw = dict(q_offsets=qoff, kv_scales=sc2, window_size=64,
                      return_lse=True)
            what = f"{name} {label}: prefill (window 64)"
            o, lse = (_twice(what, lambda: paged_attention_prefill(
                q2, pool2, bt2, ln2, **kw)) if odd
                else paged_attention_prefill(q2, pool2, bt2, ln2, **kw))
            po, plse = paged_attention_prefill_plain(q2, pool2, bt2, ln2,
                                                     **kw)
            errs = hold(what, o, po, lse, plse, ROW_TOL[dt], prefill_worst,
                        pmode)
            if odd:
                note(f"prefill {pmode} G{hq // hkv}", errs)
        if not odd:
            continue
        for mode, dt, qdt in SPLIT_MODES:
            q, pool, bt, ln = _decode_inputs(g, [0, 1, 17, 600, 333], 48,
                                             shuffle=True, hq=hq, dtype=dt,
                                             hkv=hkv)
            (k, v, ks, vs), (fpool, fsc) = _split_pools(pool, qdt)
            for window in (-1, 64):
                kw = dict(k_scales=ks, v_scales=vs, window_size=window,
                          return_lse=True)
                what = f"{name} split {mode}: decode" + (
                    f" (window {window})" if window > 0 else "")
                o, lse = _twice(what, lambda: paged_attention(q, k, v, bt, ln,
                                                              **kw))
                po, plse = paged_attention_plain(q, k, v, bt, ln, **kw)
                note(f"split {mode} G{hq // hkv}",
                     hold(what, o, po, lse, plse, ROW_TOL[dt], split_worst,
                          mode))
                fo, flse = paged_attention_fused(
                    q, fpool, bt, ln, kv_scales=fsc, window_size=window,
                    int8_matmul=False, return_lse=True)
                if not (torch.equal(o, fo) and torch.equal(lse, flse)):
                    raise AssertionError(f"{what}: not the fused kernel's "
                                         f"bits on the same pools")
    log("groups: every odd group's split-pool decode gives the fused "
        "kernel's bits on the same pools, and every call the same bits "
        "twice")
    paged_attention.launches = 0
    paged_attention_fused.launches = 0
    paged_attention_prefill.launches = 0
    return by_group


PROMPT_LENS = [7, 64, 129, 300, 511, 700, 1000, 1024, 1500, 2048, 3000,
               4000]
NEW_TOKENS = 24
# the engine phase's depth (and so the edges', the breakdown's and the
# train steps'): 16 of Llama-3-8B's 32 layers since the front-end and
# head-dim phases joined the script (full depth before); the spec phase's
# since the scripts phase joined
ENGINE_LAYERS = 16


ENGINE_KW = dict(max_batch=8, page_size=16, num_pages=2100,
                 max_pages_per_seq=272, max_seq_len=4352, decode_steps=8)
CHUNK = 512


def _launch_counters():
    from aule_tpu_torch.ops.flash import (flash_fwd_decode, flash_fwd_f32,
                                         flash_fwd_short, flash_fwd_tma)
    from aule_tpu_torch.ops.paged import paged_attention
    from aule_tpu_torch.ops.paged_fused import paged_attention_fused
    from aule_tpu_torch.ops.paged_generic import (paged_generic_decode,
                                                  paged_prefill_f32)
    from aule_tpu_torch.ops.paged_prefill import paged_attention_prefill

    return {"flash_fwd": flash_fwd_tma, "flash_fwd_short": flash_fwd_short,
            "flash_fwd_decode": flash_fwd_decode,
            "flash_fwd_f32": flash_fwd_f32,
            "paged_decode": paged_attention_fused,
            "paged_decode_split": paged_attention,
            "paged_prefill": paged_attention_prefill,
            "paged_generic_decode": paged_generic_decode,
            "paged_prefill_f32": paged_prefill_f32}


def run_engine(params, cfg, prompts, label, model=None, engine_kw=ENGINE_KW,
               routing=None, submit_kw=None, info=None, **kw):
    """Serve the prompts through a fresh ServingEngine (`model`: the model
    family, Llama by default); the launch counts are set to 0 just before
    the run and read just after.  Checks that every request finished, that
    the launches match the dispatches (whole-prompt prefill launches a
    flash kernel once per layer per prompt, the short-prompt one for
    prompts of at most SHORT_SQ tokens; chunked prefill launches the
    paged-prefill kernel once per layer per chunk and no flash kernel;
    decode launches the decode kernel of the engine's layout, fused or
    split, once per layer per step and the other never; whole-prompt
    prefill launches the flash forward that ops/flash.py's rule picks for
    the model's type, head dim and the prompt's length (`forward_kernel`:
    flash_f32.cu's in f32, the tensor-core kernels in bf16 at D 64 and
    128 above SHORT_SQ tokens); the paged decode and prefill that
    ops/paged_generic.py's rules pick: a model in f32 decodes and prefills
    its chunks on paged_generic.cu / paged_prefill_f32.cu, a bf16 one on
    paged_decode.cu and
    paged_prefill.cu at every head dim, and the other family never) and
    that every page came back (a cached page stays resident: free and
    cached pages together), on the native page allocator.  `routing` (a
    _Routing) logs where a mixture of
    experts sent each token.  `submit_kw` gives each request's options
    (`stop`: the request may end early; a prefix-cache hit prefills from
    the hit); `info`, a dict, receives each request's logprobs, its cache
    hit and prefix pages, the run's stats and the engine's LoRA bank."""
    from aule_tpu_torch.serving.engine import ServingEngine
    from aule_tpu_torch.serving.native import NativePageAllocator

    eng = ServingEngine(params, cfg, device=DEV, model=model, **engine_kw,
                        **kw)
    if not isinstance(eng.allocator, NativePageAllocator):
        raise AssertionError(f"{label}: the engine runs on "
                             f"{type(eng.allocator).__name__}, not the native "
                             f"allocator")
    submit_kw = submit_kw or [{}] * len(prompts)
    hits = {}
    if eng.enable_prefix_cache:
        run_prefill = eng._run_prefill

        def spy(slot, req, hit_len=0):
            hits[req.req_id] = (hit_len, list(eng.slot_pages[slot]))
            return run_prefill(slot, req, hit_len)

        eng._run_prefill = spy
    pools = [t for t in (eng.kv_pages, eng.kv_scales, eng.k_pages,
                         eng.v_pages, eng.k_scales, eng.v_scales)
             if t is not None]
    pool_gib = sum(t.numel() * t.element_size() for t in pools) / 2**30
    for p, skw in zip(prompts, submit_kw):
        eng.submit(p, NEW_TOKENS, **skw)
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    if routing is not None:
        routing.attach(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        done = eng.run()
    finally:
        if routing is not None:
            routing.detach()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    st = eng.stats()
    n_req = len(prompts)
    lens = [len(p) for p in prompts]
    decode_tokens = st["tokens_generated"] - n_req
    log(f"engine {label}: {eng.layout} pools {pools[0].dtype} "
        f"{pool_gib:.2f} GiB with scales; {len(done)} requests in "
        f"{wall:.2f} s; prefill "
        f"{st['prefill_seconds']:.3f} s over {st['prefill_dispatches']} "
        f"dispatches ({sum(lens)} prompt tokens, "
        f"{sum(lens) / st['prefill_seconds']:.0f} tok/s); decode "
        f"{st['decode_seconds']:.3f} s, {st['decode_steps']} steps in "
        f"{st['decode_dispatches']} dispatches, {decode_tokens} tokens, "
        f"{decode_tokens / st['decode_seconds']:.1f} tok/s")
    log(f"engine {label}: launches {launches}")
    if len(done) != n_req or any(
            len(r.output) != NEW_TOKENS if not r.stop
            else not 0 < len(r.output) <= NEW_TOKENS for r in done):
        raise AssertionError(f"{label}: not every request finished with "
                             f"{NEW_TOKENS} tokens (or fewer at a stop)")
    from aule_tpu_torch.ops.flash import forward_kernel
    from aule_tpu_torch.ops.paged_generic import (prefill_uses_generic,
                                                  uses_generic_kernels)

    layers = cfg.n_layers
    chunked = eng.prefill_chunk is not None
    split = eng.layout == "split"
    row = torch.empty(1, 1, 1, cfg.head_dim, dtype=cfg.dtype, device="meta")
    generic = uses_generic_kernels(row)
    decode = st["decode_steps"] * layers
    prefill = st["prefill_dispatches"] * layers
    want = dict.fromkeys(counters, 0)
    if not chunked:  # whole-prompt prefill: one dispatch per prompt
        for n in lens:
            q = torch.empty(1, 1, n, cfg.head_dim, dtype=cfg.dtype,
                            device="meta")
            name = next(k for k, fn in counters.items()
                        if fn is forward_kernel(q))
            want[name] += layers
    if generic:
        want["paged_generic_decode"] = decode
    else:
        want["paged_decode"] = 0 if split else decode
        want["paged_decode_split"] = decode if split else 0
    want["paged_prefill_f32" if prefill_uses_generic(row)
         else "paged_prefill"] = prefill if chunked else 0
    hit = [hits.get(i, (0, None))[0] for i in range(n_req)]
    if sum(hit) != st["prefix_cache_hit_tokens"]:
        raise AssertionError(f"{label}: cache hits {hit} against "
                             f"{st['prefix_cache_hit_tokens']} in stats()")
    if chunked and st["prefill_dispatches"] != sum(
            -(-(n - h) // eng.prefill_chunk) for n, h in zip(lens, hit)):
        raise AssertionError(f"{label}: {st['prefill_dispatches']} prefill "
                             f"dispatches for chunks of "
                             f"{eng.prefill_chunk}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} != dispatches "
                             f"x {layers} layers {want}")
    if (st["free_pages"] + st["prefix_cache_pages"]
            != engine_kw["num_pages"] - 1 or any(eng._page_rc.values())):
        raise AssertionError(f"{label}: pages leaked: {st['free_pages']} "
                             f"free, {st['prefix_cache_pages']} cached")
    if info is not None:
        info.update(logprobs=[list(r.logprobs) for r in done], hits=hits,
                    stats=st, lora=eng.lora)
    outputs = [list(r.output) for r in done]
    # the spy refers to the engine: drop it, or the engine and its pools
    # live on in a cycle until the collector runs
    eng.__dict__.pop("_run_prefill", None)
    del eng, done
    torch.cuda.empty_cache()
    return outputs, launches


class _Agreement:
    """Teacher-forced agreement of emitted tokens with reference logits:
    each token is the reference argmax, or within `tie` (NEAR_TIE unless
    given) of its max."""

    def __init__(self, label, tie=NEAR_TIE):
        self.label, self.exact, self.ties, self.gap = label, 0, 0, 0.0
        self.tie = tie

    def add(self, rows, chosen, where):
        best = rows.max(dim=-1)
        gap = best.values - rows.gather(1, chosen[:, None])[:, 0]
        is_exact = best.indices == chosen
        self.exact += int(is_exact.sum())
        self.ties += int(((~is_exact) & (gap <= self.tie)).sum())
        self.gap = max(self.gap, float(gap.max()))
        if bool(((~is_exact) & (gap > self.tie)).any()):
            raise AssertionError(
                f"{self.label} {where}: engine token is "
                f"{float(gap.max()):.4f} below the reference max, over the "
                f"near-tie allowance {self.tie}")

    def report(self, what):
        log(f"engine {self.label}: {what} agrees on "
            f"{self.exact + self.ties} tokens: {self.exact} exact argmax, "
            f"{self.ties} near-ties (largest gap {self.gap:.4g} <= "
            f"{self.tie:.4g})")


# A served logprob against the plain path's f32 log-softmax at the emitted
# token: both are a difference of logits, z_t - logsumexp(z), and
# logsumexp moves by a softmax-weighted mean of the logits' moves, so the
# allowance for two paths' bf16 roundings is the near-tie's, which covers
# the same roundings in the difference of two logits.
LOGPROB_TOL = NEAR_TIE


class _EdgeJudge:
    """Per-request options of a served run judged against teacher-forced
    reference logits (check_plain_forward's or check_replay's rows).  Each
    request's spec: `lora` (its bank index; 0 the base model), `bias`
    ({token: value} added to the rows first), `temperature` with `top_k` /
    `top_p` (a sampled token must lie in the restricted set of the
    reference rows, sampling.restrict_rows, within the near-tie allowance
    of its cutoff), `logprobs` (the engine's, each within LOGPROB_TOL of the
    reference log-softmax at the token); a greedy token is the reference
    argmax or a near-tie (_Agreement).  `bank` is the engine's LoRA
    bank."""

    def __init__(self, label, specs, bank=None):
        self.label, self.specs, self.bank = label, specs, bank
        self.agree = None

    def start(self, tie):
        self.agree = _Agreement(self.label, tie)
        self.tie, self.sampled, self.margin = tie, 0, float("inf")
        self.lp_n, self.lp_err = 0, 0.0
        return self

    def lora_kw(self, reqs) -> dict:
        idx = [self.specs[i].get("lora", 0) for i in reqs]
        if self.bank is None or not any(idx):
            return {}
        return dict(lora=self.bank, lora_idx=torch.tensor(idx, device=DEV))

    def add(self, i, rows, chosen, t0, where):
        from aule_tpu_torch.serving import sampling

        spec = self.specs[i]
        rows = rows.float()
        tok = torch.tensor(chosen, device=rows.device)
        where = f"{where}, request {i}"
        if spec.get("logprobs") is not None:
            lp = torch.log_softmax(rows, -1).gather(1, tok[:, None])[:, 0]
            got = torch.tensor(spec["logprobs"][t0:t0 + len(chosen)],
                               device=rows.device)
            err = float((lp - got).abs().max())
            self.lp_n += len(chosen)
            self.lp_err = max(self.lp_err, err)
            if err > LOGPROB_TOL:
                raise AssertionError(f"{self.label} {where}: logprob off the "
                                     f"plain path's by {err:.4g} > "
                                     f"{LOGPROB_TOL}")
        if spec.get("bias"):
            bias = torch.zeros(rows.shape[-1], device=rows.device)
            bias[list(spec["bias"])] = torch.tensor(
                list(spec["bias"].values()), device=rows.device)
            rows = rows + bias
        t = spec.get("temperature", 0.0)
        if not t:
            self.agree.add(rows, tok, where)
            return
        n = rows.shape[0]
        kept = sampling.restrict_rows(
            rows / t, torch.full((n,), spec.get("top_k", 0), device=DEV)
            if spec.get("top_k") else None,
            torch.full((n,), spec.get("top_p", 0.0), device=DEV)
            if spec.get("top_p") else None)
        cut = kept.masked_fill(~torch.isfinite(kept), float("inf")).min(
            -1).values * t
        margin = rows.gather(1, tok[:, None])[:, 0] - cut
        self.sampled += n
        self.margin = min(self.margin, float(margin.min()))
        if bool((margin < -self.tie).any()):
            raise AssertionError(
                f"{self.label} {where}: a sampled token lies "
                f"{-float(margin.min()):.4f} below its restricted set's "
                f"cutoff, over the near-tie allowance {self.tie}")

    def report(self, what):
        self.agree.report(what)
        if self.sampled:
            log(f"engine {self.label}: {self.sampled} sampled tokens inside "
                f"their top-k / top-p sets (smallest margin above the "
                f"cutoff {self.margin:.4g}, allowance -{self.tie:.4g})")
        if self.lp_n:
            log(f"engine {self.label}: {self.lp_n} logprobs within "
                f"{self.lp_err:.4g} of the reference log-softmax (allowance "
                f"{LOGPROB_TOL})")


def _top(logits, k):
    """Each row's top-k experts, ties to the lower index (models/moe.py's
    _gating order)."""
    return torch.sort(logits, dim=-1, descending=True,
                      stable=True).indices[:, :k]


def _mixture(layer, x, logits, idx, cfg):
    """models/moe.py's _moe_mlp_dense on x [B, S, dim] (router logits
    `logits` [B*S, E]) with each token's experts given by `idx` [B*S, k]:
    the same arithmetic, the gates from its own logits."""
    from aule_tpu_torch.models import moe

    gates = torch.softmax(logits.gather(-1, idx), dim=-1)
    w = torch.zeros_like(logits).scatter(-1, idx, gates)
    outs = moe._expert_mlp(layer["e_gate"], layer["e_up"], layer["e_down"],
                           x.reshape(-1, x.shape[-1]))
    y = torch.einsum("etd,te->td", outs.float(), w)
    return y.to(x.dtype).reshape(x.shape)


class _Routing:
    """Where a Mixtral run sent each token, logged and then pinned.

    The router's logits are bf16 products (JAX's rounding, aule_tpu/models/
    moe.py:114).  Where a token's k-th and (k+1)-th experts lie within a
    rounding of each other, the kernel path and the plain path send it to
    different experts as soon as their attention outputs differ by a
    rounding, and its MLP output moves by a gate times the difference of
    two experts' outputs (a Mixtral run's teacher-forced check saw tokens
    over a unit below the plain max).  That is the router's discontinuity,
    not the attention's error, so the checks route the plain path as the
    kernel path did.  `attach(eng)` puts a logging copy of
    moe._moe_mlp_dense in place while the engine serves (the same
    arithmetic: it notes each row's top-k, keyed by (request, position)
    from the engine's state, then calls the original) and `detach()`
    restores it; `log(rows)` makes this object a `moe_mlp` that logs a
    model call whose x rows are `rows` ((request, position) each) and runs
    the dense mixture.  Then `pin(rows)` makes it a `moe_mlp` that routes
    the next call's rows as logged, its gates from its own logits.
    `flips` counts the token-layers a pinned call would have routed
    otherwise."""

    def __init__(self, n_layers):
        self.n_layers = n_layers
        self.logged, self.table, self.rows, self.logging = [], {}, None, False
        self.calls = self.flips = 0
        self._restore = None

    def attach(self, eng):
        from aule_tpu_torch.models import moe

        dense = moe._moe_mlp_dense
        run_prefill, decode_all = eng._run_prefill, eng._decode_all
        at = dict(req=None, offset=0, calls=0, slots=(), lens=())

        def prefill(slot, req, hit_len=0):
            at.update(req=req.req_id, offset=hit_len, calls=0)
            return run_prefill(slot, req, hit_len)

        def decode():
            at.update(req=None, calls=0, lens=eng.slot_lens.copy(),
                      slots=[r and r.req_id for r in eng.slots])
            return decode_all()

        def logged(layer, x, cfg):
            b, s, d = x.shape
            if at["req"] is not None:  # a prompt, or a chunk of one
                rows = [(at["req"], at["offset"] + j) for j in range(s)]
            else:  # a decode step: one row a batch slot
                step = at["calls"] // self.n_layers
                rows = [None if r is None else (r, int(at["lens"][i]) + step)
                        for i, r in enumerate(at["slots"])]
            logits = (x.reshape(b * s, d) @ layer["router"]).float()
            self.logged.append((rows, at["calls"] % self.n_layers,
                                _top(logits, cfg.top_k)))
            at["calls"] += 1
            if at["req"] is not None and at["calls"] % self.n_layers == 0:
                at["offset"] += s
            return dense(layer, x, cfg)

        eng._run_prefill, eng._decode_all = prefill, decode
        moe._moe_mlp_dense = logged

        def restore():
            moe._moe_mlp_dense = dense
            # the wrappers refer to the engine: drop them, or the engine
            # and its pools live on in a cycle until the collector runs
            del eng._run_prefill, eng._decode_all

        self._restore = restore

    def detach(self):
        self._restore()
        self._restore = None
        self._build()

    def _build(self):
        """The logged calls as one table a request: [positions, layers,
        k] experts."""
        ends = {}
        for rows, _, _ in self.logged:
            for key in rows:
                if key is not None:
                    ends[key[0]] = max(ends.get(key[0], 0), key[1] + 1)
        k = self.logged[0][2].shape[1]
        self.table = {r: np.full((n, self.n_layers, k), -1, np.int64)
                      for r, n in ends.items()}
        for rows, li, idx in self.logged:
            idx = idx.cpu().numpy()
            for i, key in enumerate(rows):
                if key is not None:
                    self.table[key[0]][key[1], li] = idx[i]
        self.logged.clear()

    def log(self, rows):
        self.rows, self.calls, self.logging = rows, 0, True
        return self

    def pin(self, rows):
        if self.logging:
            self._build()
        self.rows, self.calls, self.logging = rows, 0, False
        return self

    def __call__(self, layer, x, cfg):
        b, s, d = x.shape
        li = self.calls % self.n_layers
        self.calls += 1
        logits = (x.reshape(b * s, d) @ layer["router"]).float()
        own = _top(logits, cfg.top_k)
        if self.logging:
            self.logged.append((self.rows, li, own))
            return _mixture(layer, x, logits, own, cfg)
        got = np.stack([self.table[r][p, li] for r, p in self.rows])
        if (got < 0).any():
            raise AssertionError("routing: a row the engine never routed")
        idx = torch.from_numpy(got).to(x.device)
        self.flips += int((own.sort(-1).values
                           != idx.sort(-1).values).any(-1).sum())
        return _mixture(layer, x, logits, idx, cfg)


def check_plain_forward(params, cfg, prompts, outputs, label, model=None,
                        tie=NEAR_TIE, routing=None, edges=None):
    """Teacher-forced plain forward (flash's plain version) over prompt +
    output: the check of the unquantized runs (`model`: Llama unless
    given; a mixture of experts routed as the run was by `routing`, a
    detached _Routing; per-request options judged by `edges`, an
    _EdgeJudge, which also gives each request its adapter)."""
    from aule_tpu_torch.models import llama
    from aule_tpu_torch.ops.flash_vjp import flash_attention_vjp_plain

    model = model or llama
    agree = _Agreement(label, tie) if edges is None else edges.start(tie)
    with torch.no_grad():
        for i, (p, out) in enumerate(zip(prompts, outputs)):
            seq = np.concatenate([p, np.asarray(out[:-1], np.int32)])
            tokens = torch.from_numpy(seq.astype(np.int64))[None].to(DEV)
            kw = {} if routing is None else dict(moe_mlp=routing.pin(
                [(i, pos) for pos in range(len(seq))]))
            if edges is not None:
                kw.update(edges.lora_kw([i]))
            logits = model.forward(params, tokens, cfg,
                                   attention=flash_attention_vjp_plain,
                                   **kw)[0]
            where = f"request {i} (prompt {len(p)})"
            if edges is None:
                agree.add(logits[len(p) - 1:], torch.tensor(out, device=DEV),
                          where)
            else:
                edges.add(i, logits[len(p) - 1:], out, 0, where)
            del logits
    agree.report("teacher-forced plain forward" + (
        "" if routing is None else
        f" (experts pinned to the run's routing; the plain path would have "
        f"routed {routing.flips} token-layers otherwise)"))


def check_replay(params, cfg, prompts, outputs, label, quant_dtype, chunk,
                 layout="fused", model=None, engine_kw=ENGINE_KW,
                 tie=NEAR_TIE, routing=None, edges=None,
                 new_tokens=NEW_TOKENS):
    """Teacher-forced replay of a quantized run's steps with the plain
    attention versions: each prompt is prefilled alone into fresh pools of
    the run's layout written the same way (chunked through
    prefill_step_fused, or a whole forward plus the quantized append), then
    all requests decode together through decode_step_fused or, over split
    pools, decode_step, fed the engine's tokens (`model`: Llama unless
    given; `engine_kw`: the run's engine settings; `tie`: the near-tie
    allowance; a mixture of experts routed as the run was by `routing`, a
    detached _Routing; per-request options, adapters and lengths judged by
    `edges`, an _EdgeJudge; `new_tokens`: the run's max_new_tokens)."""
    from aule_tpu_torch.models import llama
    from aule_tpu_torch.ops import paged
    from aule_tpu_torch.ops.flash_vjp import flash_attention_vjp_plain
    from aule_tpu_torch.ops.paged_fused import (
        fused_pool_shape, fused_scales_shape, kv_cache_append_prefill_fused,
        paged_attention_fused_plain)
    from aule_tpu_torch.ops.paged_prefill import (
        paged_attention_prefill_plain)
    from aule_tpu_torch.ops.rope import precompute_rope_frequencies

    dev = DEV
    model = model or llama
    page = engine_kw["page_size"]
    need = [-(-(len(p) + new_tokens) // page) for p in prompts]
    num_pages = 1 + sum(need)

    def zeros(shape, dtype):
        return torch.zeros((cfg.n_layers,) + tuple(shape), dtype=dtype,
                           device=dev)

    # fused: [pool, packed scales]; split: [k, v, k scales, v scales]
    if layout == "fused":
        pools = [zeros(fused_pool_shape(num_pages, cfg.n_kv_heads, page,
                                        cfg.head_dim), quant_dtype),
                 zeros(fused_scales_shape(num_pages, cfg.n_kv_heads, page),
                       torch.bfloat16)]
    else:
        shape = (cfg.n_kv_heads, num_pages, page, cfg.head_dim)
        pools = [zeros(shape, quant_dtype), zeros(shape, quant_dtype),
                 zeros(shape[:-1], torch.float32),
                 zeros(shape[:-1], torch.float32)]
    bt_np = np.full((len(prompts), engine_kw["max_pages_per_seq"]), -1,
                    np.int32)
    at = 1
    for i, n in enumerate(need):
        bt_np[i, :n] = np.arange(at, at + n)
        at += n
    bt = torch.from_numpy(bt_np).to(dev)
    cos, sin = precompute_rope_frequencies(
        engine_kw["max_seq_len"], cfg.head_dim, cfg.rope_base, device=dev)
    # [R, new_tokens]; a request that stopped early is padded with 0s past
    # its end, which feed its row but are never judged
    out_t = torch.tensor([list(o) + [0] * (new_tokens - len(o))
                          for o in outputs], device=dev)
    agree = _Agreement(label, tie) if edges is None else edges.start(tie)

    def judge(rows, t, reqs, where):
        """Rows of requests `reqs` that chose their output[t]."""
        if edges is None:
            agree.add(rows, out_t[:, t] if t else out_t[reqs[0], :1], where)
            return
        for j, i in enumerate(reqs):
            if t < len(outputs[i]):
                edges.add(i, rows[j:j + 1], [outputs[i][t]], t, where)

    def lora(reqs):
        return {} if edges is None else edges.lora_kw(reqs)

    def pinned(rows):
        return {} if routing is None else dict(moe_mlp=routing.pin(rows))

    def one(x):
        return torch.tensor([x], dtype=torch.int32, device=dev)

    with torch.no_grad():
        for i, p in enumerate(prompts):
            tokens = torch.from_numpy(p.astype(np.int64))[None].to(dev)
            n = len(p)
            if chunk:
                for off in range(0, n, chunk):
                    part = tokens[:, off:off + chunk]
                    logits = model.prefill_step_fused(
                        params, part, one(off), one(part.shape[1]),
                        pools[0], bt[i:i + 1], cfg, cos, sin, pools[1],
                        attention=paged_attention_prefill_plain,
                        **pinned([(i, off + j)
                                  for j in range(part.shape[1])]),
                        **lora([i]))[0][0]
            else:
                full, kv = model.forward(
                    params, tokens, cfg, rope_cos=cos, rope_sin=sin,
                    return_kv=True, attention=flash_attention_vjp_plain,
                    **pinned([(i, j) for j in range(n)]), **lora([i]))
                where = (bt[i:i + 1], one(0), one(n))
                for li, (k, v) in enumerate(kv):
                    if layout == "fused":
                        kv_cache_append_prefill_fused(
                            pools[0][li], k, v, *where,
                            kv_scales=pools[1][li])
                    else:
                        paged.kv_cache_append_prefill_quantized(
                            *(t[li] for t in pools), k, v, *where)
                logits = full[0, n - 1]
                del full, kv
            judge(logits[None], 0, [i], f"request {i} prefill")
        lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                            device=dev)
        everyone = list(range(len(prompts)))
        for t in range(max(len(o) for o in outputs) - 1):
            if layout == "fused":
                logits = model.decode_step_fused(
                    params, out_t[:, t], lens, pools[0], bt, lens, cfg, cos,
                    sin, pools[1], attention=paged_attention_fused_plain,
                    **pinned([(i, len(p) + t)
                              for i, p in enumerate(prompts)]),
                    **lora(everyone))[0]
            else:
                logits = model.decode_step(
                    params, out_t[:, t], lens, *pools[:2], bt, lens, cfg,
                    cos, sin, *pools[2:],
                    attention=paged.paged_attention_plain)[0]
            judge(logits, t + 1, everyone, f"decode step {t}")
            lens = lens + 1
    agree.report("teacher-forced replay with the plain attention versions"
                 + ("" if routing is None else
                    f" (experts pinned to the run's routing; the replay "
                    f"would have routed {routing.flips} token-layers "
                    f"otherwise)"))
    pools.clear()
    torch.cuda.empty_cache()


def phase_engine():
    """Eight engine runs of the 12 prompts on a full-width Llama-3-8B on
    ENGINE_LAYERS of its 32 layers: over fused pools bf16 whole-prompt, (a) bf16 chunked, (b)
    int8 chunked, (c) fp8 whole-prompt, (d) fp8 chunked; over split pools
    (layout="split", whole-prompt prefill) (e) bf16, (f) int8 and (g)
    fp8."""
    from aule_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=ENGINE_LAYERS)
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    params = llama.init_params(cfg, gen, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in llama._tensors(params))
    log(f"engine: Llama-3-8B dim {cfg.dim} layers {cfg.n_layers} heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} hidden {cfg.hidden_dim} vocab "
        f"{cfg.vocab_size} bf16: {n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s; memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    runs = {}

    out, runs["whole bf16"] = run_engine(params, cfg, prompts, "whole bf16")
    check_plain_forward(params, cfg, prompts, out, "whole bf16")

    out_a, runs["a"] = run_engine(params, cfg, prompts,
                                  "(a) bf16 chunk 512", prefill_chunk=CHUNK)
    check_plain_forward(params, cfg, prompts, out_a, "(a) bf16 chunk 512")

    for key, label, dt, chunk in (
            ("b", "(b) int8 chunk 512", torch.int8, CHUNK),
            ("c", "(c) fp8 whole-prompt", torch.float8_e4m3fn, None),
            ("d", "(d) fp8 chunk 512", torch.float8_e4m3fn, CHUNK)):
        out_q, runs[key] = run_engine(params, cfg, prompts, label,
                                      quantized=True, quant_dtype=dt,
                                      prefill_chunk=chunk)
        check_replay(params, cfg, prompts, out_q, label, dt, chunk)
        log(f"engine {label}: {_same(out_q, out_a)} of "
            f"{len(prompts) * NEW_TOKENS} tokens equal run (a)'s (for "
            f"information)")

    for key, label, dt in (("e", "(e) split bf16", None),
                           ("f", "(f) split int8", torch.int8),
                           ("g", "(g) split fp8", torch.float8_e4m3fn)):
        kw = dict(layout="split")
        if dt is not None:
            kw.update(quantized=True, quant_dtype=dt)
        out_s, runs[key] = run_engine(params, cfg, prompts, label, **kw)
        if dt is None:
            check_plain_forward(params, cfg, prompts, out_s, label)
        else:
            check_replay(params, cfg, prompts, out_s, label, dt, None,
                         layout="split")
        log(f"engine {label}: {_same(out_s, out)} of "
            f"{len(prompts) * NEW_TOKENS} tokens equal the fused bf16 "
            f"whole-prompt run's (for information)")
    return runs, params, cfg


# The edges phase: the per-request serving options over one base model.
# 12 prompts, each one shared 1,024-token prefix (64 pages, exactly two
# chunks of CHUNK, so a cached prefix ends on a chunk boundary) and a tail
# of its own; adapters cycle base, a, b over them.
EDGE_PREFIX = 1024
EDGE_TAILS = [7, 64, 129, 300, 511, 700, 1000, 33, 250, 450, 800, 999]
EDGE_GROUPS = (None, "a", "b")
EDGE_KW = dict(ENGINE_KW, prefill_chunk=CHUNK)
EDGE_RANK = 16
# B's entries are N(0, EDGE_B_STD^2) (the alpha / r scale folded in) over A
# N(0, 1 / d_in): each delta element is then N(0, r * EDGE_B_STD^2) =
# N(0, 0.25) against a base projection element N(0, 1), a shift the
# logits show (logged)
EDGE_B_STD = 0.125
EDGE_BIAS_TOKEN = 4242   # the +100 request's token
EDGE_TEMP = 0.8
EDGE_SEED = SEED + 19    # the adapters' generator


def edge_adapters(cfg, seed=EDGE_SEED) -> dict:
    """Adapters `a` and `b`, rank EDGE_RANK on wq / wk / wv / wo of every
    layer of `cfg` (f32 on the card; A N(0, 1 / d_in), B N(0,
    EDGE_B_STD^2)), from a generator seeded with `seed`."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    q = cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    dims = {"wq": (cfg.dim, q), "wk": (cfg.dim, kv), "wv": (cfg.dim, kv),
            "wo": (q, cfg.dim)}

    def mat(shape, std):
        return torch.randn(shape, generator=gen, device=DEV).mul_(std)

    return {name: {"layers": [
        {t: (mat((i, EDGE_RANK), 1.0 / math.sqrt(i)),
             mat((EDGE_RANK, o), EDGE_B_STD)) for t, (i, o) in dims.items()}
        for _ in range(cfg.n_layers)]} for name in ("a", "b")}


def edge_specs(submit_kw, info) -> list:
    """Each request's _EdgeJudge spec from its submit options and the run's
    logprobs (bank index: a 1, b 2, in edge_adapters' order)."""
    return [dict(lora={None: 0, "a": 1, "b": 2}[kw.get("lora")],
                 bias=kw.get("logit_bias"),
                 temperature=kw.get("temperature", 0.0),
                 top_k=kw.get("top_k", 0), top_p=kw.get("top_p", 0.0),
                 logprobs=info["logprobs"][i] if kw.get("logprobs")
                 else None) for i, kw in enumerate(submit_kw)]


def _edge_requests(out0) -> list:
    """Run (h)'s per-request options from run (h0)'s greedy outputs: the
    adapters as in (h0); logprobs on requests 0, 1 and 5; a stop sequence
    on 2 and 7 (their (h0) tokens 10-11); +100 on EDGE_BIAS_TOKEN for 3,
    -100 on its (h0) first token for 4; temperature EDGE_TEMP with top_k
    20 on 5 and with top_p 0.9 on 6; the rest plain greedy."""
    reqs = [dict(lora=EDGE_GROUPS[i % 3]) for i in range(len(out0))]
    for i in (0, 1, 5):
        reqs[i]["logprobs"] = True
    for i in (2, 7):
        reqs[i]["stop"] = [out0[i][10:12]]
    reqs[3]["logit_bias"] = {EDGE_BIAS_TOKEN: 100.0}
    reqs[4]["logit_bias"] = {out0[4][0]: -100.0}
    reqs[5].update(temperature=EDGE_TEMP, top_k=20)
    reqs[6].update(temperature=EDGE_TEMP, top_p=0.9)
    return reqs


def _check_edge_outputs(label, outs, reqs, info, must_stop):
    """What each option promises of the tokens: a stopped request ends with
    its stop sequence at its first occurrence (and run (h)'s do stop,
    short of NEW_TOKENS), the +100 request emits only its token, the -100
    one never its banned token; each adapter group's first request
    registers the prefix and the other nine reuse it (hits 9 x
    EDGE_PREFIX), and no request reads another group's prefix pages."""
    for i, (out, kw) in enumerate(zip(outs, reqs)):
        for seq in kw.get("stop", []):
            n = len(seq)
            at = next((j for j in range(len(out) - n + 1)
                       if out[j:j + n] == seq), None)
            if at is not None and at + n != len(out):
                raise AssertionError(f"{label}: request {i} ran past its "
                                     f"stop sequence at {at}")
            if must_stop and (at is None or len(out) >= NEW_TOKENS):
                raise AssertionError(f"{label}: request {i} did not stop at "
                                     f"{seq}: {out}")
        for tok, val in (kw.get("logit_bias") or {}).items():
            if val > 0 and set(out) != {tok}:
                raise AssertionError(f"{label}: request {i} emitted other "
                                     f"tokens than its +{val} token {tok}")
            if val < 0 and tok in out:
                raise AssertionError(f"{label}: request {i} emitted its "
                                     f"banned token {tok}")
    pages = {}
    for rid, (hit, got) in sorted(info["hits"].items()):
        group = reqs[rid].get("lora")
        first = group not in pages
        if hit != (0 if first else EDGE_PREFIX):
            raise AssertionError(f"{label}: request {rid} hit {hit} cached "
                                 f"tokens")
        prefix = tuple(got[:EDGE_PREFIX // EDGE_KW["page_size"]])
        if pages.setdefault(group, prefix) != prefix:
            raise AssertionError(f"{label}: request {rid} read other prefix "
                                 f"pages than its group's first request")
    seen = [set(p) for p in pages.values()]
    if any(a & b for j, a in enumerate(seen) for b in seen[j + 1:]):
        raise AssertionError(f"{label}: two adapter groups share prefix "
                             f"pages")
    hits = info["stats"]["prefix_cache_hit_tokens"]
    if hits != 9 * EDGE_PREFIX:
        raise AssertionError(f"{label}: {hits} cached tokens hit, not "
                             f"{9 * EDGE_PREFIX}")


def _edge_breakdown(params, cfg, prompts, reqs, adapters) -> dict:
    """One 8-step decode dispatch at B8 under torch.profiler in run (h)'s
    configuration (the first 8 requests with their options and adapters,
    the prefix cache on) and in run (a)'s (the same prompts, bf16 chunk
    512, no option): the kernels a step each launches."""
    from aule_tpu_torch.serving.engine import ServingEngine
    from aule_tpu_torch.utils import profiling

    res = {}
    for key, kw, rk in (
            ("a", {}, [{}] * 8),
            ("h", dict(enable_prefix_cache=True, lora_params=adapters),
             reqs[:8])):
        eng = ServingEngine(params, cfg, device=DEV, **EDGE_KW, **kw)
        for p, r in zip(prompts[:8], rk):
            eng.submit(p, 17, **r)
        eng.step()  # admits and prefills all 8, then a first dispatch
        bd = profiling.device_breakdown(eng.step, CATEGORIES)
        _log_breakdown(f"edges decode B8, 8 steps (one dispatch), run "
                       f"({key})'s configuration", bd)
        res[key] = dict(wall_ms=bd["wall_ms"], busy_ms=bd["busy_ms"],
                        kernels=bd["kernels"],
                        kernels_per_step=bd["kernels"] / 8)
        eng.run()
        del eng
        torch.cuda.empty_cache()
    h, a = res["h"]["kernels_per_step"], res["a"]["kernels_per_step"]
    log(f"edges: kernels a decode step {h:.1f} in run (h)'s configuration "
        f"against {a:.1f} in run (a)'s: the edges add {h - a:.1f}")
    return res


def phase_edges(params, cfg) -> dict:
    """The serving edges on the engine phase's Llama-3-8B weights: two
    rank-16 adapters (edge_adapters) and 12 prompts on one shared 1,024-token
    prefix, adapters cycling base / a / b, EDGE_KW (prefill_chunk 512),
    NEW_TOKENS each, served three times: (h0) bf16, prefix cache off, all
    greedy, held to a teacher-forced plain forward with each request's
    adapter; (h) the same requests with the prefix cache on and the
    per-request options of _edge_requests, held to the plain forward with
    adapters and biases, sampled tokens inside their restricted sets,
    logprobs within LOGPROB_TOL, stops, bans and cache hits checked; (i)
    run (h)'s requests over an int8 pool, held to a teacher-forced replay
    with the plain attention versions the same way.  Then one decode
    dispatch of (h)'s configuration under torch.profiler beside run (a)'s.
    Returns each run's launches and numbers."""
    from aule_tpu_torch.models import llama
    from aule_tpu_torch.ops.flash_vjp import flash_attention_vjp_plain

    t0 = time.perf_counter()
    adapters = edge_adapters(cfg)
    rng = np.random.default_rng(EDGE_SEED)
    prefix = rng.integers(0, cfg.vocab_size, size=EDGE_PREFIX)
    prompts = [np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, size=n)]).astype(np.int32) for n in EDGE_TAILS]
    groups = [dict(lora=EDGE_GROUPS[i % 3]) for i in range(len(prompts))]
    res = {"runs": {}, "stats": {}}
    info0 = {}
    out0, res["runs"]["h0"] = run_engine(
        params, cfg, prompts, "(h0) bf16 chunk 512, LoRA, cache off",
        engine_kw=EDGE_KW, lora_params=adapters, submit_kw=groups,
        info=info0)
    res["stats"]["h0"] = info0["stats"]
    bank = info0["lora"]
    check_plain_forward(params, cfg, prompts, out0, "(h0)", edges=_EdgeJudge(
        "(h0)", edge_specs(groups, info0), bank))
    # the adapter's effect: request 1 (adapter a) on the plain path, with
    # and without it, at its last prompt position
    with torch.no_grad():
        tokens = torch.from_numpy(prompts[1].astype(np.int64))[None].to(DEV)
        lo = [llama.forward(params, tokens, cfg,
                            attention=flash_attention_vjp_plain, **kw)[0, -1]
              for kw in ({}, dict(lora=bank,
                                  lora_idx=torch.tensor([1], device=DEV)))]
    shift = res["adapter_logit_shift"] = dict(
        max_abs=float((lo[1] - lo[0]).abs().max()),
        base_max_abs=float(lo[0].abs().max()),
        argmax_moved=bool(lo[0].argmax() != lo[1].argmax()))
    log(f"edges: adapter a moves request 1's last-position logits by up to "
        f"{shift['max_abs']:.3f} (base logits up to "
        f"{shift['base_max_abs']:.3f}; argmax moved: "
        f"{shift['argmax_moved']})")

    reqs = _edge_requests(out0)
    for key, label, kw in (
            ("h", "(h) bf16 chunk 512, LoRA, cache on, options", {}),
            ("i", "(i) int8 chunk 512, LoRA, cache on, options",
             dict(quantized=True))):
        info = {}
        out, res["runs"][key] = run_engine(
            params, cfg, prompts, label, engine_kw=EDGE_KW,
            lora_params=adapters, submit_kw=reqs, info=info,
            enable_prefix_cache=True, **kw)
        res["stats"][key] = info["stats"]
        judge = _EdgeJudge(f"({key})", edge_specs(reqs, info), info["lora"])
        if key == "h":
            check_plain_forward(params, cfg, prompts, out, f"({key})",
                                edges=judge)
        else:
            check_replay(params, cfg, prompts, out, f"({key})", torch.int8,
                         CHUNK, engine_kw=EDGE_KW, edges=judge)
        _check_edge_outputs(f"({key})", out, reqs, info, key == "h")
        greedy = [i for i, r in enumerate(reqs)
                  if not r.get("temperature") and not r.get("logit_bias")]
        same = sum(x == y for i in greedy for x, y in zip(out[i], out0[i]))
        total = sum(min(len(out[i]), len(out0[i])) for i in greedy)
        log(f"engine ({key}): {same} of {total} tokens of its greedy "
            f"unbiased requests equal run (h0)'s (for information)")
    saved = res["stats"]["h0"]["prefill_seconds"] - res["stats"]["h"][
        "prefill_seconds"]
    log(f"edges: the prefix cache skipped {9 * EDGE_PREFIX} of "
        f"{sum(len(p) for p in prompts)} prompt tokens; prefill "
        f"{res['stats']['h0']['prefill_seconds']:.3f} s in (h0), "
        f"{res['stats']['h']['prefill_seconds']:.3f} s in (h): {saved:.3f} s "
        f"saved")
    res["prefill_seconds_saved"] = saved
    res["breakdown"] = _edge_breakdown(params, cfg, prompts, reqs, adapters)
    log(f"edges: {time.perf_counter() - t0:.1f} s; {card_line()}")
    del adapters, bank
    torch.cuda.empty_cache()
    return res


def _same(outs, ref) -> int:
    """Tokens at which two runs' outputs agree."""
    return sum(x == y for o, r in zip(outs, ref) for x, y in zip(o, r))


# a kernel's category is the first whose key its lower-cased name holds:
# the split decode (paged_decode_kernel<..., SplitPools>) before the fused
CATEGORIES = {"flash_fwd_short": ["flash_fwd_short_kernel"],
              "flash_fwd_decode": ["flash_fwd_decode_kernel"],
              "flash_fwd": ["flash_fwd_kernel"],
              "flash_f32": ["flash_f32_fwd_kernel"],
              "flash_f32_bwd": ["flash_f32_bwd"],
              "rope_prepass": ["rope_prepass_kernel"],
              "flash_generic": ["flash_generic"],
              "paged_generic_decode": ["paged_generic_decode"],
              "paged_prefill_f32": ["paged_prefill_f32"],
              "flash_bwd_dq": ["flash_bwd_dq_kernel"],
              "flash_bwd_dkv": ["flash_bwd_dkv_kernel"],
              "flash_bwd_delta": ["flash_bwd_delta_kernel"],
              "paged_decode_split": ["splitpools"],
              "paged_decode": ["paged_decode_kernel"],
              "paged_prefill": ["paged_prefill_kernel"],
              "gemm": ["gemm", "nvjet", "cutlass", "xmma"],
              "copy": ["memcpy", "memset"]}


def _log_breakdown(label: str, bd: dict) -> None:
    if not bd["kernels"]:
        log(f"breakdown {label}: the profiler saw no device kernels "
            f"(not measured)")
        return
    cats = ", ".join(f"{k} {v:.3f}" for k, v in bd["by_category_ms"].items())
    log(f"breakdown {label}: wall {bd['wall_ms']:.3f} ms under the "
        f"profiler, device busy {bd['busy_ms']:.3f} ms "
        f"({100 * bd['busy_ms'] / bd['wall_ms']:.1f} %), {bd['kernels']} "
        f"kernels; ms by category: {cats}")
    for name, ms in bd["top"]:
        log(f"  {ms:9.3f} ms  {name[:110]}")


def phase_breakdown(params, cfg) -> None:
    """Where the engine's time goes on the card: a prefill step of one
    2048-token prompt and one 8-step decode dispatch at B8, each under
    torch.profiler, for bf16 pools with whole-prompt prefill and for int8
    pools with prefill_chunk=512 (that step is four chunks).  The fp8 and
    int8 split-pool configurations run in the engine phase (runs (c),
    (d), (f)) and are not profiled here: the script's time limit."""
    from aule_tpu_torch.serving.engine import ServingEngine
    from aule_tpu_torch.utils import profiling

    for label, kw in (("bf16", {}),
                      ("int8 chunk 512", dict(quantized=True,
                                              prefill_chunk=CHUNK))):
        eng = ServingEngine(params, cfg, max_batch=8, page_size=16,
                            num_pages=1200, max_pages_per_seq=272,
                            max_seq_len=4352, decode_steps=8, **kw)
        rng = np.random.default_rng(SEED + 1)
        eng.submit(rng.integers(0, cfg.vocab_size, size=2048), 1)
        _log_breakdown(f"{label} prefill S2048 (one engine step)",
                       profiling.device_breakdown(eng.step, CATEGORIES))
        eng.run()
        for _ in range(8):
            eng.submit(rng.integers(0, cfg.vocab_size, size=1024), 17)
        eng.step()  # admits and prefills all 8, then a first 8-step dispatch
        _log_breakdown(f"{label} decode B8 ctx~1040, 8 steps (one dispatch)",
                       profiling.device_breakdown(eng.run, CATEGORIES))
        del eng
        torch.cuda.empty_cache()


def check_grads(params, cfg, tokens, model=None, label="train") -> None:
    """Every parameter's gradient of `model`.loss_fn (Llama's unless
    given) through the kernels against the plain path's
    (flash_attention_fwd_plain + flash_attention_bwd_plain on the card), on
    the same weights cut to 2 layers (views, full width); relative
    Frobenius error within GRAD_TOL, all finite.  A mixture of experts
    (a model with `n_experts` in its config) is routed alike on both
    passes (_Routing: the plain pass logged first, the kernel pass
    pinned to it)."""
    import dataclasses

    from aule_tpu_torch.models import llama
    from aule_tpu_torch.ops.flash_vjp import (flash_attention_vjp,
                                              flash_attention_vjp_plain)

    model = model or llama
    small = dict(params, layers=params["layers"][:2])
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    tensors = list(llama._tensors(small))
    for t in tensors:
        t.requires_grad_(True)
    names = ["embed", "final_norm", "lm_head"] + [  # llama._tensors' order
        f"layers.{li}.{key}" for li, layer in enumerate(small["layers"])
        for key in layer]
    got, routing = {}, None
    passes = (("kernel", flash_attention_vjp),
              ("plain", flash_attention_vjp_plain))
    if hasattr(cfg, "n_experts"):
        routing = _Routing(2)
        passes = passes[::-1]
    rows = [(0, pos) for pos in range(tokens.shape[1] - 1)]
    for name, attention in passes:
        kw = {} if routing is None else dict(
            moe_mlp=routing.log(rows) if name == "plain"
            else routing.pin(rows))
        loss = model.loss_fn(small, tokens, cfg2, attention=attention, **kw)
        got[name] = (float(loss.detach()),
                     torch.autograd.grad(loss, tensors))
        del loss
    worst, worst_name = 0.0, ""
    for name, g, r in zip(names, got["kernel"][1], got["plain"][1]):
        rel = float((g.float() - r.float()).norm() / r.float().norm())
        if not (bool(torch.isfinite(g).all()) and rel <= GRAD_TOL):
            raise AssertionError(f"{label} gradient check: {name} relative "
                                 f"error {rel:.3e} (<= {GRAD_TOL}) or not "
                                 f"finite")
        if rel >= worst:
            worst, worst_name = rel, name
    log(f"{label} gradient check, 2 layers full width "
        f"S{tokens.shape[1] - 1}: loss kernel "
        f"{got['kernel'][0]:.6f} plain {got['plain'][0]:.6f}; "
        f"{len(tensors)} gradients, largest relative Frobenius error "
        f"{worst:.3e} ({worst_name}) <= {GRAD_TOL} ok"
        + ("" if routing is None else
           f"; experts pinned to the plain pass's routing, which the "
           f"kernel pass would have changed for {routing.flips} of "
           f"{cfg2.n_layers * len(rows)} token-layers"))
    del got
    torch.cuda.empty_cache()


def phase_train(params, cfg) -> dict:
    """Three SGD steps of the engine phase's model on one batch of
    B1 x (TRAIN_S + 1) tokens (after the 2-layer gradient check): step 1
    warms up and checks every gradient finite, step 2 is timed with CUDA
    events, step 3 runs under torch.profiler; every step launches the
    forward, delta, dQ and dK/dV kernels once per layer, and the loss
    falls.
    Returns the backward kernels' launches per step."""
    from aule_tpu_torch.models import llama
    from aule_tpu_torch.ops.flash import flash_fwd_tma
    from aule_tpu_torch.ops.flash_vjp import (attention_delta, flash_bwd_dkv,
                                              flash_bwd_dq)
    from aule_tpu_torch.utils import profiling

    rng = np.random.default_rng(SEED + 2)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(1, TRAIN_S + 1))).to(DEV)
    tensors = list(llama._tensors(params))
    for t in tensors:
        t.requires_grad_(True)
    check_grads(params, cfg, tokens)

    counters = {"flash_fwd": flash_fwd_tma,
                "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv,
                "flash_bwd_delta": attention_delta}
    matmul_params = sum(t.numel() for t in tensors if t.dim() == 2) \
        - params["embed"].numel()  # the embedding is a gather
    flops = profiling.train_step_flops(
        matmul_params, TRAIN_S, cfg.n_layers * profiling.attention_flops(
            1, cfg.n_heads, TRAIN_S, TRAIN_S, cfg.head_dim, causal=True))
    losses, launches = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step in range(3):
        bad, hooks = [], []
        if step == 0:  # every gradient finite, read before its update
            hooks = [t.register_post_accumulate_grad_hook(
                lambda t: bad.append(~torch.isfinite(t.grad).all()))
                for t in tensors]
        for fn in counters.values():
            fn.launches = 0
        out = []
        if step == 2:  # its time: the wall under the profiler
            bd = profiling.device_breakdown(lambda: out.append(
                llama.train_step(params, tokens, cfg, lr=TRAIN_LR)),
                CATEGORIES)
            ms = bd["wall_ms"]
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out.append(llama.train_step(params, tokens, cfg, lr=TRAIN_LR))
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        losses.append(float(out[0][1]))
        launches.append({n: fn.launches for n, fn in counters.items()})
        for h in hooks:
            h.remove()
        if step == 0:
            if len(bad) != len(tensors) or bool(torch.stack(bad).any()):
                raise AssertionError("train step 1: a gradient is not finite")
            log(f"train step 1: all {len(tensors)} gradients finite")
        if step == 1:
            step_ms = ms
        log(f"train step {step + 1}: loss {losses[-1]:.6f}, {ms:.2f} ms"
            f"{' (wall under torch.profiler)' if step == 2 else ''}; launches "
            f"{launches[-1]}")
        want = {n: cfg.n_layers for n in counters}
        if launches[-1] != want:
            raise AssertionError(f"train step {step + 1}: launches "
                                 f"{launches[-1]} != {want}")
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        losses.append(float(llama.loss_fn(params, tokens, cfg)))
    log(f"train: loss after 3 steps {losses[-1]:.6f} (lr {TRAIN_LR})")
    if not (all(math.isfinite(x) for x in losses)
            and all(a > b for a, b in zip(losses, losses[1:]))):
        raise AssertionError(f"train: the loss did not fall at every step: "
                             f"{losses}")
    log(f"train: dim {cfg.dim}, {cfg.n_layers} layers, B1 S{TRAIN_S} "
        f"{cfg.dtype}, SGD lr {TRAIN_LR}: step {step_ms:.2f} ms (CUDA events, "
        f"after one warm-up step), {TRAIN_S / step_ms * 1e3:.0f} tokens/s, "
        f"{flops / 1e12:.2f} TFLOP a step = {flops / step_ms / 1e9:.1f} "
        f"TFLOP/s, {100 * flops / step_ms / 1e9 / 989:.1f} % of the 989 "
        f"TFLOP/s bf16 peak; max memory allocated {peak / 2**30:.2f} GiB "
        f"({peak / 1e9:.2f} GB)")
    _log_breakdown("train step 3 (one SGD step)", bd)
    return {n: [x[n] for x in launches] for n in counters}


# ---- the public phase: aule_tpu_torch's public attention API on the card

# f32 rows are held as the others, to 1e-5 of each row's size: the kernel
# and its plain version sum f32 products in other orders, a few f32 steps
# (2^-24) of the row's terms apart.  A gradient row that cancels (causal
# row 0: p = 1, dp = di) holds only the f32 noise of dp - di, ~1e-7 of the
# tensor's largest values, in both versions; such rows are measured
# against F32_BWD_FLOOR of the largest |value| (2^-5: noise of 1e-7 of it
# reads as 3e-6 <= 1e-5, while a wrong tile moves a row by its own size).
ROW_TOL[torch.float32] = 1e-5
F32_BWD_FLOOR = 2.0 ** -5
PUBLIC_SEED = SEED + 9   # a generator of its own: earlier checks' inputs
LLAMA_ROPE_BASE = 500000.0  # Llama-3's RoPE theta
GPT2 = (1, 12, 12)       # GPT-2 small: 12 heads of D64 (aule_tpu/models/gpt2.py:33-44)
D256 = (1, 8, 1)         # Gemma-2B's attention shape: 8 q heads, 1 kv head, D256
BUCKET = 4096            # the bucketed decode's padded context


def _public_counters():
    from aule_tpu_torch.ops import flash as tf
    from aule_tpu_torch.ops import flash_vjp as fv

    return {"flash_fwd": tf.flash_fwd_tma, "flash_fwd_short": tf.flash_fwd_short,
            "flash_fwd_decode": tf.flash_fwd_decode,
            "flash_f32_fwd": tf.flash_fwd_f32,
            "flash_bwd_delta": fv.attention_delta, "flash_bwd_dq": fv.flash_bwd_dq,
            "flash_bwd_dkv": fv.flash_bwd_dkv,
            "flash_generic_delta": fv.attention_delta_generic,
            "flash_f32_bwd_dq": fv.flash_bwd_f32_dq,
            "flash_f32_bwd_dkv": fv.flash_bwd_f32_dkv,
            "rope_prepass": tf.rope_prepass}


class _Counted:
    """Sets every launch count to 0 on entry and reads them on exit: the
    launches of the public API calls inside, and only those."""

    def __enter__(self):
        self.counters = _public_counters()
        for fn in self.counters.values():
            fn.launches = 0
        return self

    def __exit__(self, *exc):
        self.launches = {n: fn.launches for n, fn in self.counters.items()
                         if fn.launches}
        return False


def _expect(what, launches, want):
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} != {want}")
    log(f"{what}: launches {launches}")


def _frob(what, got, want):
    """Gradients against the plain path's: relative Frobenius error within
    GRAD_TOL, all finite (as check_grads)."""
    for name, g, w in zip("qkv", got, want):
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        if not (bool(torch.isfinite(g).all()) and rel <= GRAD_TOL):
            raise AssertionError(f"{what} d{name}: relative error {rel:.3e}")
        log(f"{what} d{name}: relative Frobenius error {rel:.3e} "
            f"(<= {GRAD_TOL}) ok")


def _mode_time(what, kernel, plain, library, key, nbytes, flops, rate):
    """A kernel mode's times: CUDA-event medians of the kernel, its plain
    version and the library call, and the device time per call of the
    kernel (its own kernels: `key`) and of the library call
    (torch.profiler), beside the bound.  `library` may be the (events,
    device) times of a call timed before."""
    from aule_tpu_torch.utils import profiling

    bound, by = profiling.bound_ms(nbytes, flops, rate)
    ms = profiling.cuda_time_ms(kernel, iters=20)
    pl = profiling.cuda_time_ms(plain, iters=20)
    if isinstance(library, tuple):
        lib_ms, dev_lib = library
    else:
        lib_ms = profiling.cuda_time_ms(library, iters=20)[0]
        dev_lib = device_ms(library)
    dev = device_ms(kernel, key=key)
    lib_part = f"device {_ms(dev_lib)} (events {lib_ms:.4f} ms)"
    log(f"{what}: kernel device {_ms(dev)} (events {ms[0]:.4f} ms, min "
        f"{ms[1]:.4f} max {ms[2]:.4f}); plain {pl[0]:.4f} ms; library "
        f"{lib_part}; bound {bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP)")
    return dict(ms=ms[0], plain_ms=pl[0], library_ms=lib_ms, bound_ms=bound,
                bound_by=by, device_ms=dev, library_device_ms=dev_lib)


def _rate(dt):
    from aule_tpu_torch.utils import profiling

    return (profiling.H100_F32_FLOPS if dt == torch.float32
            else profiling.H100_BF16_FLOPS)


def _fwd_rate(dt):
    """The flash kernels' peak rate for dt: f32 runs in 3xTF32 on the
    tensor cores (csrc/flash_f32.cu, csrc/flash_f32_bwd.cu), 495 / 3
    TFLOP/s."""
    from aule_tpu_torch.utils import profiling

    return (profiling.H100_3XTF32_FLOPS if dt == torch.float32
            else profiling.H100_BF16_FLOPS)


def _causal_pairs(sq, n, causal):
    """(q, k) pairs of Sq queries over the first n keys (causal: k <= q)."""
    if not causal:
        return sq * n
    return sum(min(q + 1, n) for q in range(sq))


def _public_rope(gen, res):
    """Llama-3-8B layer, full width, RoPE: flash_attention_rope (K1's
    RoPE mode, forward only) and flash_attention(..., rope) with a backward
    through autograd (rotation outside the op, as JAX's pallas route)."""
    import aule_tpu_torch as T
    from aule_tpu_torch.ops import flash as tf
    from aule_tpu_torch.ops import flash_vjp as fv
    from aule_tpu_torch.utils import profiling

    b, hq, hkv = LAYER
    s, dt = TRAIN_S, torch.bfloat16
    q, k, v, do = (_randn(x, gen, dt) for x in ((b, hq, s, 128), (b, hkv, s, 128),
                                               (b, hkv, s, 128), (b, hq, s, 128)))
    cos, sin = T.precompute_rope_frequencies(s, 128, LLAMA_ROPE_BASE,
                                             device="cuda")
    label = f"public rope B{b} Hq{hq}/Hkv{hkv} S{s} D128 bf16 causal"
    with _Counted() as c:
        o = _twice(label, lambda: [T.flash_attention_rope(
            q, k, v, cos, sin, causal=True)])[0]
    # K turned once a call by the pre-pass, then the TMA kernel
    _expect(label, c.launches, {"flash_fwd": 2, "rope_prepass": 2})
    res["launches"]["flash_fwd_rope"] = c.launches["flash_fwd"]
    res["launches"]["rope_prepass"] = (res["launches"].get("rope_prepass", 0)
                                       + c.launches["rope_prepass"])
    po, plse = tf.flash_attention_fwd_plain(q, k, v, causal=True, rope_cos=cos,
                                            rope_sin=sin)
    _, lse = tf.flash_fwd_tma(q, k, v, causal=True, rope_cos=cos, rope_sin=sin)
    res["err"]["flash_fwd_rope"] = hold(label, o, po, lse, plse, ROW_TOL[dt])

    def fwd_bwd(fn):
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs)
        grads = torch.autograd.grad(out, xs, do)
        return [out.detach(), *grads]

    label = f"public flash_attention rope fwd+bwd B{b} Hq{hq}/Hkv{hkv} S{s}"
    with _Counted() as c:
        got = _twice(label, lambda: fwd_bwd(lambda *x: T.flash_attention(
            *x, causal=True, rope_cos=cos, rope_sin=sin)))
    _expect(label, c.launches, {n: 2 for n in ("flash_fwd", "flash_bwd_delta",
                                              "flash_bwd_dq", "flash_bwd_dkv")})
    want = fwd_bwd(lambda *x: fv.flash_attention_vjp_plain(
        *x, True, rope_cos=cos, rope_sin=sin))
    hold(label + " out", got[0], want[0], None, None, ROW_TOL[dt])
    _frob(label, got[1:], want[1:])

    qr, kr = T.apply_rope(q, cos, sin), T.apply_rope(k, cos, sin)
    kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in (kr, v))
    flops = profiling.attention_flops(b, hq, s, s, 128, causal=True)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * 2 * cos.numel()
    res["time"]["flash_fwd_rope"] = _mode_time(
        label.replace("flash_attention rope fwd+bwd", "rope mode"),
        lambda: T.flash_attention_rope(q, k, v, cos, sin, causal=True),
        lambda: tf.flash_attention_fwd_plain(q, k, v, causal=True, rope_cos=cos,
                                             rope_sin=sin, return_lse=False),
        lambda: SDPA(qr, kx, vx, is_causal=True),
        ("flash_fwd_kernel", "rope_prepass_kernel"), nbytes, flops,
        _rate(dt))


def _public_decode(gen, res):
    """The bucketed decode: one query against K/V padded to BUCKET keys,
    kv_len a device tensor, on csrc/flash_fwd_short.cu's split-KV kernel.
    In bf16 and f16, plain (the public flash_attention) and with RoPE
    tables (flash_attention_fwd, the rotation in the kernel): after two
    warm-up calls, one CUDA-graph capture of the call, replayed with
    kv_len 0, 1, 1000, BUCKET - 1 and BUCKET written in place, two replays
    with the same bits, each held to the plain version; then the graph is
    deleted, an eager call held, and a second capture replayed and held
    the same way.  The merge counters are dropped before the first
    capture, so it makes its own inside the graph (ops/decode_split.py
    launch_plan); the eager call makes the shared ones.  The kernel's LSE
    is held at kv_len BUCKET - 1; the plain mode is timed there in bf16,
    beside the device time of the short kernel that ran it before."""
    import aule_tpu_torch as T
    from aule_tpu_torch.ops import decode_split
    from aule_tpu_torch.ops import flash as tf
    from aule_tpu_torch.utils import profiling

    b, hq, hkv = LAYER
    cos, sin = T.precompute_rope_frequencies(BUCKET, 128, LLAMA_ROPE_BASE,
                                             device="cuda")
    worst = (0.0, 0.0, 0.0)
    inputs = {}
    with _Counted() as c:
        for dt in (torch.bfloat16, torch.float16):
            q = _randn((b, hq, 1, 128), gen, dt)
            kp, vp = (_randn((b, hkv, BUCKET, 128), gen, dt)
                      for _ in range(2))
            kvl = torch.full((1,), BUCKET, dtype=torch.int32, device="cuda")
            inputs[dt] = q, kp, vp, kvl
            for rope in (False, True):
                tables = dict(rope_cos=cos, rope_sin=sin) if rope else {}
                if rope:
                    call = lambda: tf.flash_attention_fwd(
                        q, kp, vp, kv_len=kvl, return_lse=False, **tables)
                else:
                    call = lambda: T.flash_attention(q, kp, vp, kv_len=kvl)
                label = (f"public bucketed decode Hq{hq}/Hkv{hkv} D128 "
                         f"{str(dt).replace('torch.', '')}"
                         f"{', RoPE' if rope else ''}, K/V {BUCKET}")
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    for _ in range(2):  # warm-up off the capture
                        call()
                torch.cuda.current_stream().wait_stream(side)
                decode_split._COUNTERS.clear()
                for rnd in ("capture", "re-capture"):
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        out = call()
                    for n in (0, 1, 1000, BUCKET - 1, BUCKET):
                        kvl.fill_(n)
                        graph.replay()
                        first = out.clone()
                        graph.replay()
                        if not torch.equal(first, out):
                            raise AssertionError(f"{label}: two replays "
                                                 f"differ")
                        po = tf.flash_attention_fwd_plain(
                            q, kp, vp, kv_len=n, return_lse=False, **tables)
                        errs = hold(f"{label}: {rnd}, replay at kv_len {n} "
                                    f"written in place", out, po, None, None,
                                    ROW_TOL[dt])
                        worst = tuple(max(a, e) for a, e in zip(worst, errs))
                    if rnd == "re-capture":
                        break
                    del graph, out
                    torch.cuda.synchronize()
                    kvl.fill_(1000)
                    o = call()
                    po = tf.flash_attention_fwd_plain(
                        q, kp, vp, kv_len=1000, return_lse=False, **tables)
                    hold(f"{label}: eager at kv_len 1000 after the graph was "
                         f"deleted", o, po, None, None, ROW_TOL[dt])
                del graph, out
    # the wrapper counts the warm-ups, captures and eager calls; replays
    # run no Python
    _expect("public bucketed decode", c.launches, {"flash_fwd_decode": 20})
    res["launches"]["flash_fwd_decode_kv_len"] = c.launches[
        "flash_fwd_decode"]
    n = BUCKET - 1
    for dt, (q, kp, vp, kvl) in inputs.items():
        kvl.fill_(n)
        for tables in ({}, dict(rope_cos=cos, rope_sin=sin)):
            o, lse = tf.flash_fwd_decode(q, kp, vp, kv_len=kvl, **tables)
            po, plse = tf.flash_attention_fwd_plain(q, kp, vp, kv_len=n,
                                                    **tables)
            errs = hold(f"public bucketed decode "
                        f"{str(dt).replace('torch.', '')}"
                        f"{', RoPE' if tables else ''}: kv_len {n} with LSE",
                        o, po, lse, plse, ROW_TOL[dt])
            worst = tuple(max(a, e) for a, e in zip(worst, errs))
    res["err"]["flash_fwd_decode_kv_len"] = worst
    q, kp, vp, kvl = inputs[torch.bfloat16]
    kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in (kp, vp))
    mask = (torch.arange(BUCKET, device="cuda") < n)[None, None, None]
    flops = 4.0 * b * hq * n * 128
    nbytes = 2 * (2 * q.numel() + 2 * b * hkv * n * 128) + 4
    label = f"public bucketed decode Hq{hq}/Hkv{hkv} D128 bf16, kv_len {n}"
    t = _mode_time(label, lambda: tf.flash_fwd_decode(
        q, kp, vp, kv_len=kvl, return_lse=False),
        lambda: tf.flash_attention_fwd_plain(q, kp, vp, kv_len=kvl,
                                             return_lse=False),
        lambda: SDPA(q, kx, vx, attn_mask=mask), "flash_fwd_decode_kernel",
        nbytes, flops, _rate(torch.bfloat16))
    t["nsplit"] = decode_split.launch_plan(b, hq, hkv, BUCKET, -1, q.device,
                                           tile_rows=8)[0]
    t["short_kernel_device_ms"] = device_ms(lambda: tf.flash_fwd_short(
        q, kp, vp, kv_len=kvl, return_lse=False), key="flash_fwd_short")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tf.flash_fwd_decode(q, kp, vp, kv_len=kvl, return_lse=False)
    t["graph_replay_ms"] = profiling.cuda_time_ms(graph.replay, iters=20)[0]
    del graph
    log(f"{label}: the short kernel on the same call (before this kernel "
        f"took it) device {_ms(t['short_kernel_device_ms'])}; "
        f"{t['nsplit']} splits; graph replay {t['graph_replay_ms']:.4f} ms")
    t["launches_note"] = ("warm-ups, captures and eager calls in bf16 and "
                          "f16, plain and RoPE; the graph replays (80 "
                          "checked, and the timed ones) launch the kernel "
                          "without the wrapper")
    res["time"]["flash_fwd_decode_kv_len"] = t
    tf.flash_fwd_decode.launches = tf.flash_fwd_short.launches = 0


def _public_kv_len_tma(gen, res):
    """kv_len on K1: 512 queries against a BUCKET-key bucket, with and
    without causal, through flash_attention(kv_len=...)."""
    import aule_tpu_torch as T
    from aule_tpu_torch.ops import flash as tf
    from aule_tpu_torch.ops.reference import build_mask

    b, hq, hkv = LAYER
    sq, n, dt = 512, 3000, torch.bfloat16
    q = _randn((b, hq, sq, 128), gen, dt)
    kp, vp = (_randn((b, hkv, BUCKET, 128), gen, dt) for _ in range(2))
    kvl = torch.full((1,), n, dtype=torch.int32, device="cuda")
    worst = (0.0, 0.0, 0.0)
    for causal in (False, True):
        label = (f"public kv_len {n} of {BUCKET} keys, Sq{sq} Hq{hq}/Hkv{hkv} "
                 f"D128 bf16{' causal' if causal else ''}")
        with _Counted() as c:
            o, lse = _twice(label, lambda: T.flash_attention(
                q, kp, vp, causal=causal, kv_len=kvl, return_lse=True))
        _expect(label, c.launches, {"flash_fwd": 2})
        res["launches"]["flash_fwd_kv_len"] = (
            res["launches"].get("flash_fwd_kv_len", 0) + c.launches["flash_fwd"])
        po, plse = tf.flash_attention_fwd_plain(q, kp, vp, causal=causal,
                                                kv_len=n)
        errs = hold(label, o, po, lse, plse, ROW_TOL[dt])
        worst = tuple(max(a, e) for a, e in zip(worst, errs))
        if causal:
            continue
        kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in (kp, vp))
        mask = (torch.arange(BUCKET, device="cuda") < n)[None, None, None]
        flops = 4.0 * b * hq * 128 * _causal_pairs(sq, n, causal)
        nbytes = 2 * (2 * q.numel() + 2 * b * hkv * n * 128) + 4
        res["time"]["flash_fwd_kv_len"] = _mode_time(
            label, lambda: tf.flash_fwd_tma(q, kp, vp, kv_len=kvl,
                                            return_lse=False),
            lambda: tf.flash_attention_fwd_plain(q, kp, vp, kv_len=kvl,
                                                 return_lse=False),
            lambda: SDPA(q, kx, vx, attn_mask=mask), "flash_fwd_kernel",
            nbytes, flops, _rate(dt))
    res["err"]["flash_fwd_kv_len"] = worst


def _layer_kernels(dt):
    """part -> (counter name, wrapper) of the forward and the three
    backward kernels that flash_attention launches for a layer of type dt
    (ops/flash.py's rule: flash_f32.cu, flash_generic.cu's delta and
    flash_f32_bwd.cu for f32, the tensor-core kernels for bf16/f16)."""
    from aule_tpu_torch.ops import flash as tf
    from aule_tpu_torch.ops import flash_vjp as fv

    if dt == torch.float32:
        return {"fwd": ("flash_f32_fwd", tf.flash_fwd_f32),
                "delta": ("flash_generic_delta", fv.attention_delta_generic),
                "dq": ("flash_f32_bwd_dq", fv.flash_bwd_f32_dq),
                "dkv": ("flash_f32_bwd_dkv", fv.flash_bwd_f32_dkv)}
    return {"fwd": ("flash_fwd", tf.flash_fwd_tma),
            "delta": ("flash_bwd_delta", fv.attention_delta),
            "dq": ("flash_bwd_dq", fv.flash_bwd_dq),
            "dkv": ("flash_bwd_dkv", fv.flash_bwd_dkv)}


def _public_layer(gen, res, name, shape, s, d, dt):
    """flash_attention forward and backward through autograd at one layer
    shape, on the kernels ops/flash.py's rule picks (`_layer_kernels`): the
    output and the gradients held to the plain path's, the forward and the
    three backward kernels to their plain versions row by row; times of the
    forward and of each backward kernel beside SDPA's and the bound (the
    16-bit D 64 / 256 layers' FFMA times before the tensor-core kernels took
    them: scripts/torch_flash_ab.sh in the parent tree).  The mode names:
    the counter's, then `name`."""
    import aule_tpu_torch as T
    from aule_tpu_torch.ops import flash as tf
    from aule_tpu_torch.ops import flash_vjp as fv
    from aule_tpu_torch.utils import profiling

    b, hq, hkv = shape
    kernels = _layer_kernels(dt)
    counter = {part: n for part, (n, _) in kernels.items()}
    k_ = {part: fn for part, (_, fn) in kernels.items()}
    q, k, v, do = (_randn(x, gen, dt) for x in ((b, hq, s, d), (b, hkv, s, d),
                                               (b, hkv, s, d), (b, hq, s, d)))
    tname = str(dt).replace("torch.", "")
    label = f"public {name} B{b} Hq{hq}/Hkv{hkv} S{s} D{d} {tname} causal"
    mode = {part: f"{n}_{name}" for part, n in counter.items()}

    def fwd_bwd(fn):
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs)
        return [out.detach(), *torch.autograd.grad(out, xs, do)]

    with _Counted() as c:
        got = _twice(label + " fwd+bwd", lambda: fwd_bwd(
            lambda *x: T.flash_attention(*x, causal=True)))
    _expect(label + " fwd+bwd", c.launches,
            {n: 2 for n in counter.values()})
    for part, n in counter.items():
        res["launches"][mode[part]] = c.launches[n]
    want = fwd_bwd(lambda *x: fv.flash_attention_vjp_plain(*x, True))
    _frob(label, got[1:], want[1:])
    o, lse = k_["fwd"](q, k, v, causal=True)
    po, plse = tf.flash_attention_fwd_plain(q, k, v, causal=True)
    tol = ROW_TOL[dt]
    res["err"][mode["fwd"]] = hold(label + " forward", o, po, lse, plse, tol)
    floor = F32_BWD_FLOOR if dt == torch.float32 else BWD_FLOOR
    di = k_["delta"](o, do)
    worst = {}
    hold_delta(label + " delta", di, o, do, None, worst)
    res["err"][mode["delta"]] = worst["delta"]
    # the tensor-core dQ at D 64/256 computes delta from o itself
    dq_kw = {} if dt == torch.float32 else dict(o=o)
    dq = k_["dq"](q, k, v, do, lse, di, causal=True, **dq_kw)
    res["err"][mode["dq"]] = hold(
        label + " dQ", dq, fv.flash_bwd_dq_plain(q, k, v, do, lse, di, causal=True),
        None, None, tol, floor=floor)
    dk, dv = k_["dkv"](q, k, v, do, lse, di, causal=True)
    pdk, pdv = fv.flash_bwd_dkv_plain(q, k, v, do, lse, di, causal=True)
    ek = hold(label + " dK", dk, pdk, None, None, tol, floor=floor)
    ev = hold(label + " dV", dv, pdv, None, None, tol, floor=floor)
    res["err"][mode["dkv"]] = tuple(max(a, e) for a, e in zip(ek, ev))
    del pdk, pdv

    kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
    esz = q.element_size()
    fwd_flops = profiling.attention_flops(b, hq, s, s, d, causal=True)
    qkv = esz * (q.numel() + k.numel() + v.numel())
    qx = q.detach().requires_grad_(True)
    kx.requires_grad_(True)
    vx.requires_grad_(True)
    ref = SDPA(qx, kx, vx, is_causal=True)
    sdpa_bwd = lambda: torch.autograd.grad(ref, (qx, kx, vx), do,
                                           retain_graph=True)
    # one library time for the three backward kernels (SDPA's backward
    # computes dq, dk and dv together)
    lib_bwd = (profiling.cuda_time_ms(sdpa_bwd, iters=20)[0],
               device_ms(sdpa_bwd))
    stats = 4 * lse.numel()
    kw = dict(causal=True)
    for part, fn, plain, flops, nbytes, library in (
            ("fwd", lambda: k_["fwd"](q, k, v, return_lse=False, **kw),
             lambda: tf.flash_attention_fwd_plain(q, k, v, return_lse=False,
                                                  **kw),
             fwd_flops, qkv + esz * q.numel(),
             lambda: SDPA(q, kx.detach(), vx.detach(), is_causal=True)),
            ("delta", lambda: k_["delta"](o, do),
             lambda: fv.attention_delta_plain(o, do), 2.0 * o.numel(),
             2 * esz * o.numel() + stats, _vecdot_times(o, do)),
            ("dq", lambda: k_["dq"](q, k, v, do, lse, di, **kw, **dq_kw),
             lambda: fv.flash_bwd_dq_plain(q, k, v, do, lse, di, **kw),
             profiling.attention_bwd_flops(fwd_flops, 3),
             # reading o in place of di where the kernel takes o
             qkv + 2 * esz * q.numel() + 2 * stats
             + (esz * o.numel() - stats if dq_kw else 0), lib_bwd),
            ("dkv", lambda: k_["dkv"](q, k, v, do, lse, di, **kw),
             lambda: fv.flash_bwd_dkv_plain(q, k, v, do, lse, di, **kw),
             profiling.attention_bwd_flops(fwd_flops, 4),
             qkv + esz * (q.numel() + k.numel() + v.numel()) + 2 * stats,
             lib_bwd)):
        # delta: f32 products outside the tensor cores whatever the type;
        # f32's forward, dQ and dK/dV in 3xTF32 (their FFMA bounds kept
        # beside them)
        rate = (profiling.H100_F32_FLOPS if part == "delta"
                else _fwd_rate(dt))
        key = counter[part] + ("_kernel" if part == "fwd" else "")
        t = _mode_time(f"{label} {part}", fn, plain, library, key, nbytes,
                       flops, rate)
        if part != "delta" and dt == torch.float32:
            t["ffma_bound_ms"] = profiling.bound_ms(
                nbytes, flops, profiling.H100_F32_FLOPS)[0]
        res["time"][mode[part]] = t
    del ref, qx, kx, vx


# The kernel modes the layer checks above do not reach, each held to its
# plain version: entry -> its cases (label, kernel, (B, Hq, Hkv), Sq, Sk,
# D, dtype, causal, window, RoPE table rows or None, kv_len or None,
# route).  Routes: "rope" is flash_attention_rope (RoPE in the kernel);
# "public" is flash_attention (a kv_len call, RoPE outside the op, as
# JAX's); "op" is ops.flash.flash_attention_fwd with RoPE and kv_len both
# in the kernel.  The first case of each entry is timed.
_BF, _FP, _F32 = torch.bfloat16, torch.float16, torch.float32
PUBLIC_MODES = {
    "flash_fwd_decode_rope": [
        (f"1 query over {BUCKET} keys", "flash_fwd_decode", LAYER, 1, BUCKET,
         128, _BF, False, -1, BUCKET, None, "rope"),
        (f"f16 1 query over {BUCKET} keys, table 3000, kv_len 3500",
         "flash_fwd_decode", LAYER, 1, BUCKET, 128, _FP, False, -1, 3000,
         3500, "op"),
        ("group 3 Hq24/Hkv8, 1 query over 1000 keys, window 300",
         "flash_fwd_decode", (1, 24, 8), 1, 1000, 128, _BF, False, 300,
         1000, None, "rope"),
        ("B2 group 12 Hq96/Hkv8 f16, causal, kv_len 900", "flash_fwd_decode",
         (2, 96, 8), 1, 1024, 128, _FP, True, -1, 1024, 900, "op")],
    "flash_fwd_short_rope": [
        ("the engine's 7-token prompt, causal", "flash_fwd_short", LAYER, 7,
         7, 128, _BF, True, -1, 7, None, "rope"),
        ("16 queries over 512 keys f16, table 300, kv_len 77",
         "flash_fwd_short", LAYER, 16, 512, 128, _FP, False, -1, 300, 77,
         "op")],
    "flash_fwd_rope_f16_window": [
        (f"S{TRAIN_S} f16 causal window 256", "flash_fwd", LAYER, TRAIN_S,
         TRAIN_S, 128, _FP, True, 256, TRAIN_S, None, "rope")],
    "flash_fwd_rope_short_table": [
        ("Sq512 over Sk2048, table 1536", "flash_fwd", LAYER, 512, 2048, 128,
         _BF, False, -1, 1536, None, "rope")],
    "flash_fwd_rope_kv_len": [
        (f"Sq512 over a {BUCKET}-key bucket, kv_len 3000", "flash_fwd",
         LAYER, 512, BUCKET, 128, _BF, False, -1, BUCKET, 3000, "op")],
    "flash_fwd_rope_kv_len_d64": [
        ("Sq512 over Sk1024 causal, kv_len 900", "flash_fwd", GPT2,
         512, 1024, 64, _BF, True, -1, 1024, 900, "op"),
        ("f16 Sq300 over Sk700, table 500, kv_len 650", "flash_fwd", GPT2,
         300, 700, 64, _FP, False, -1, 500, 650, "op"),
        ("the patch's GPT-2 decode: 1 query, kv_len 1000 of a 1024 bucket",
         "flash_fwd", GPT2, 1, 1024, 64, _BF, False, -1, None, 1000,
         "public")],
    "flash_fwd_rope_kv_len_d256": [
        ("Sq512 over Sk2048, kv_len 1500", "flash_fwd", D256, 512,
         2048, 256, _BF, False, -1, 2048, 1500, "op"),
        ("f16 Sq200 over Sk900 causal, table 600, kv_len 800", "flash_fwd",
         D256, 200, 900, 256, _FP, True, -1, 600, 800, "op")],
    "flash_f32_fwd_rope_kv_len": [
        ("Sq512 over Sk2048 causal, kv_len 1500", "flash_f32_fwd", LAYER,
         512, 2048, 128, _F32, True, -1, 2048, 1500, "op"),
        ("D256 group 8, Sq1024 causal", "flash_f32_fwd", D256, 1024, 1024,
         256, _F32, True, -1, None, None, "public"),
        ("D256 group 8, Sq300 over Sk900, window 100, table 600, kv_len "
         "800", "flash_f32_fwd", D256, 300, 900, 256, _F32, False, 100, 600,
         800, "op"),
        ("GPT-2 D64 B2 Sq333 over Sk1000 causal, window 256, table 1000, "
         "kv_len 0", "flash_f32_fwd", (2, 12, 12), 333, 1000, 64, _F32,
         True, 256, 1000, 0, "op"),
        ("group 3 Hq24/Hkv8 D128 Sq700 over Sk500, non-causal", "flash_f32_fwd",
         (1, 24, 8), 700, 500, 128, _F32, False, -1, None, None, "public")],
}


def _public_modes(res):
    """Each case of PUBLIC_MODES through its route, twice with the same
    bits, its launches counted from 0; the output and the kernel's LSE
    held to flash_attention_fwd_plain; the first case of each entry timed
    against its plain version and SDPA on the rotated q and k with the
    boolean mask of the case (a generator of its own)."""
    import aule_tpu_torch as T
    from aule_tpu_torch.ops import flash as tf
    from aule_tpu_torch.ops.reference import build_mask

    wrappers = _public_counters()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(PUBLIC_SEED + 1)
    for name, cases in PUBLIC_MODES.items():
        res["cases"][name] = {}
        for i, (what, kernel, (b, hq, hkv), sq, sk, d, dt, causal, window,
                rows, n, route) in enumerate(cases):
            q = _randn((b, hq, sq, d), gen, dt)
            k, v = (_randn((b, hkv, sk, d), gen, dt) for _ in range(2))
            cos = sin = None
            if rows is not None:
                cos, sin = T.precompute_rope_frequencies(
                    rows, d, LLAMA_ROPE_BASE, device="cuda")
            kvl = (None if n is None else
                   torch.full((1,), n, dtype=torch.int32, device="cuda"))
            kw = dict(causal=causal, window_size=window)
            call = {
                "rope": lambda: T.flash_attention_rope(q, k, v, cos, sin,
                                                       **kw),
                "public": lambda: T.flash_attention(q, k, v, kv_len=kvl,
                                                    **kw),
                "op": lambda: tf.flash_attention_fwd(
                    q, k, v, rope_cos=cos, rope_sin=sin, kv_len=kvl,
                    return_lse=False, **kw)}[route]
            label = (f"public {name}: {what}, Hq{hq}/Hkv{hkv} D{d} "
                     f"{str(dt).replace('torch.', '')} ({route} route)")
            # the TMA kernel's RoPE turns K in the pre-pass first
            prepass = kernel == "flash_fwd" and cos is not None
            with _Counted() as c:
                o = _twice(label, lambda: [call()])[0]
            _expect(label, c.launches,
                    {kernel: 2, **({"rope_prepass": 2} if prepass else {})})
            res["launches"][name] = (res["launches"].get(name, 0)
                                     + c.launches[kernel])
            if prepass:
                res["launches"]["rope_prepass"] += c.launches["rope_prepass"]
            _, lse = wrappers[kernel](q, k, v, rope_cos=cos, rope_sin=sin,
                                      kv_len=kvl, **kw)
            po, plse = tf.flash_attention_fwd_plain(
                q, k, v, rope_cos=cos, rope_sin=sin, kv_len=n, **kw)
            errs = hold(label, o, po, lse, plse, ROW_TOL[dt])
            res["cases"][name][what] = errs
            res["err"][name] = tuple(max(a, e) for a, e in zip(
                res["err"].get(name, (0.0, 0.0, 0.0)), errs))
            if i:
                continue
            mask = build_mask(sq, sk, causal, window, device="cuda")
            if n is not None:
                mask = mask & (torch.arange(sk, device="cuda") < n)
            qr, kr = q, k
            if cos is not None:
                pc, ps = tf.rope_identity_padded(cos, sin, max(sq, sk))
                qr, kr = T.apply_rope(q, pc, ps), T.apply_rope(k, pc, ps)
            kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in (kr, v))
            keys = int(mask.any(0).sum())  # the keys some query attends
            esz = q.element_size()
            nbytes = (esz * (2 * q.numel() + 2 * b * hkv * keys * d)
                      + (0 if cos is None else 2 * 4 * cos.numel())
                      + (0 if n is None else 4))
            flops = 4.0 * b * hq * d * int(mask.sum())
            res["time"][name] = _mode_time(
                label, call, lambda: tf.flash_attention_fwd_plain(
                    q, k, v, rope_cos=cos, rope_sin=sin, kv_len=kvl,
                    return_lse=False, **kw),
                lambda: SDPA(qr, kx, vx, attn_mask=mask[None, None]),
                (f"{kernel}_kernel", "rope_prepass_kernel") if prepass
                else f"{kernel}_kernel", nbytes, flops, _fwd_rate(dt))


# the RoPE pre-pass's cases: (label, (B, Hkv), S, D, dtype, table rows);
# the first is the Llama layer's K, timed
PREPASS_CASES = [
    (f"Llama-3-8B K B1 Hkv8 S{TRAIN_S}", (1, 8), TRAIN_S, 128, torch.bfloat16,
     TRAIN_S),
    ("f16 B2 Hkv8 S4096, table 3000", (2, 8), 4096, 128, torch.float16, 3000),
    ("GPT-2 K B1 Hkv12 S1024, table 500", (1, 12), 1024, 64, torch.bfloat16,
     500),
    ("f16 D256 Hkv1 S2048, table 1536", (1, 1), 2048, 256, torch.float16,
     1536),
]


def _public_rope_prepass(res):
    """csrc/rope_prepass.cu against `rope_prepass_plain` (apply_rope over
    the identity-padded tables): every value within one rounding step of
    the type (2^-7 of it in bf16, 2^-10 in f16), rows past the table as
    they were, two runs the same bits; the Llama layer's K timed beside its
    bound and plain version (no one PyTorch call computes it: library
    null).  A generator of its own."""
    import aule_tpu_torch as T
    from aule_tpu_torch.ops import flash as tf
    from aule_tpu_torch.utils import profiling

    gen = torch.Generator(device="cuda")
    gen.manual_seed(PUBLIC_SEED + 200)
    worst = (0.0, 0.0, 0.0)
    for i, (what, (b, hkv), s, d, dt, rows) in enumerate(PREPASS_CASES):
        k = _randn((b, hkv, s, d), gen, dt)
        cos, sin = T.precompute_rope_frequencies(rows, d, LLAMA_ROPE_BASE,
                                                 device="cuda")
        got = tf.rope_prepass(k, cos, sin)
        want = tf.rope_prepass_plain(k, cos, sin)
        diff = (got.float() - want.float()).abs()
        step = (2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -10)
        rel = float((diff / want.float().abs().clamp_min(2.0 ** -14)).max())
        same = int((got == want).sum())
        ok = (rel <= step and torch.equal(got[:, :, rows:], k[:, :, rows:])
              and torch.equal(got, tf.rope_prepass(k, cos, sin)))
        label = f"public rope pre-pass {what} D{d} {str(dt)[6:]}"
        log(f"{label}: max|out-plain| {float(diff.max()):.3e}, relative "
            f"{rel:.3e} (<= {step:.3e}), {same} of {got.numel()} values "
            f"equal {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version: "
                                 f"{label}")
        worst = (max(worst[0], float(diff.max())), max(worst[1], rel), 0.0)
        if i:
            continue
        nbytes = 2 * k.numel() * k.element_size() + 2 * 4 * cos.numel()
        # 6 f32 operations a pair, off the tensor cores
        bound, by = profiling.bound_ms(nbytes, 3.0 * k.numel(),
                                       profiling.H100_F32_FLOPS)
        fn = lambda: tf.rope_prepass(k, cos, sin)
        ms = profiling.cuda_time_ms(fn, iters=20)
        pl = profiling.cuda_time_ms(lambda: tf.rope_prepass_plain(k, cos, sin),
                                    iters=20)
        dev = device_ms(fn, key="rope_prepass_kernel")
        log(f"{label}: kernel device {_ms(dev)} (events {ms[0]:.4f} ms); "
            f"plain {pl[0]:.4f} ms; library none; bound {bound:.4f} ms "
            f"({by}; {nbytes / 1e6:.1f} MB)")
        res["time"]["rope_prepass"] = dict(
            ms=ms[0], plain_ms=pl[0], library_ms=None, bound_ms=bound,
            bound_by=by, device_ms=dev)
    res["err"]["rope_prepass"] = worst


def _public_patch(gen, res):
    """The SDPA patch: after install(), torch's scaled_dot_product_attention
    at the Llama shape launches the port's kernel and is held to the saved
    original; an attn_mask call reaches the original; uninstall() puts the
    function object back."""
    import aule_tpu_torch as T
    from aule_tpu_torch.integration import patching

    b, hq, hkv = LAYER
    s, dt = TRAIN_S, torch.bfloat16
    q = _randn((b, hq, s, 128), gen, dt)
    k, v = (_randn((b, hkv, s, 128), gen, dt) for _ in range(2))
    T.install()
    try:
        if F.scaled_dot_product_attention is SDPA:
            raise AssertionError("install() left torch's SDPA in place")
        label = f"public SDPA patch B{b} Hq{hq}/Hkv{hkv} S{s} causal enable_gqa"
        with _Counted() as c:
            got = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 enable_gqa=True)
        _expect(label, c.launches, {"flash_fwd": 1})
        want = patching.original_sdpa()(q, k, v, is_causal=True,
                                        enable_gqa=True)
        res["err"]["sdpa_patch"] = hold(label + " vs the saved original", got,
                                        want, None, None, ROW_TOL[dt])
        mask = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
        with _Counted() as c:
            got = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                 enable_gqa=True)
        want = SDPA(q, k, v, attn_mask=mask, enable_gqa=True)
        if c.launches or not torch.equal(got, want):
            raise AssertionError("an attn_mask call did not reach the "
                                 "original")
        log("public SDPA patch: an attn_mask call reached the original "
            "(no port launch, its bits)")
    finally:
        T.uninstall()
    if F.scaled_dot_product_attention is not SDPA:
        raise AssertionError("uninstall() did not restore torch's SDPA")
    log("public SDPA patch: uninstall() restored the function object")
    log("public patch_model: transformers is not installed here; the HF "
        "routing (logits and a bucketed generate) is checked by "
        "tests/test_torch_integration.py on the CPU")


def check_public() -> dict:
    """The public attention API on the card (the port's `aule_tpu_torch.
    flash_attention` and its family, the backend chain, the SDPA patch):
    the selected backend must be cuda; every call runs twice with the same
    bits and is held to its plain version; each mode's launches are
    counted from 0 around its public calls.  Returns the errors, times and
    launches by mode."""
    import aule_tpu_torch as T

    chosen = T.select_backend()
    if chosen != "cuda":
        raise AssertionError(f"the selected backend is {chosen!r}, not cuda: "
                             f"{T.get_backend_errors()}")
    log(f"public: select_backend() = {chosen}; available "
        f"{T.get_available_backends()}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(PUBLIC_SEED)
    res = {"err": {}, "time": {}, "launches": {}, "cases": {}}
    # each mode's launches on its public calls, read by _Counted
    _public_rope(gen, res)
    _public_decode(gen, res)
    _public_kv_len_tma(gen, res)
    _public_layer(gen, res, "gpt2", GPT2, 1024, 64, torch.bfloat16)
    _public_layer(gen, res, "f32", LAYER, TRAIN_S, 128, torch.float32)
    _public_layer(gen, res, "d256", D256, TRAIN_S, 256, torch.bfloat16)
    # f16 at both new head dims, on generators of their own (a new case
    # drawn from `gen` would move the inputs of every later check)
    for name, shape, s, d, seed, dt in (
            ("f16_d64", GPT2, 512, 64, 1, torch.float16),
            ("f16_d256", D256, 1024, 256, 2, torch.float16),
            ("gpt2_f32", GPT2, 1024, 64, 3, torch.float32),
            ("d256_f32", D256, TRAIN_S, 256, 4, torch.float32)):
        g = torch.Generator(device="cuda")
        g.manual_seed(PUBLIC_SEED + 100 + seed)
        _public_layer(g, res, name, shape, s, d, dt)
    _public_patch(gen, res)
    _public_modes(res)
    t_phase = time.perf_counter()
    _public_rope_prepass(res)
    log(f"public rope pre-pass checks: {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return res


# ---- the GPT-2 phase: the f32-q paged kernels and GPT-2 small serving, in a
# process of its own (`python3 chip_smoke.py --gpt2` runs it alone)

GPT2_SEED = SEED + 12    # a generator of its own: earlier checks' inputs
# GPT-2 small's engine (aule_tpu/models/gpt2.py:33-44: n_ctx 1024)
GPT2_ENGINE_KW = dict(max_batch=8, page_size=16, num_pages=512,
                      max_pages_per_seq=64, max_seq_len=1024, decode_steps=8)
GPT2_PROMPT_LENS = [7, 16, 17, 64, 129, 256, 300, 511, 700, 768, 999, 1000]
GPT2_CHUNK = 256
# Teacher-forced agreement of GPT-2 small in f32: the kernel path and the
# plain path differ by f32 roundings (2^-24 relative) in each product and
# sum, in another order; through 12 layers and a 768-wide head that grows
# to ~1e-5 of a logit (|logit| ~ 1-5 at random weights).  2^-10 is ~100x
# that; a wrong tile, mask or position moves logits by tenths.
GPT2_F32_NEAR_TIE = 2.0 ** -10
# The paged decode's modes, (mode, q / pool dtype, payload dtype or None,
# int8_matmul, scale dtype): f32 q on csrc/paged_generic.cu (bf16 scales,
# as the engine's), and 16-bit q on csrc/paged_decode.cu at every head dim
# (bf16 q with bf16 scales, f16 q with f32 scales)
_BS, _FS = torch.bfloat16, torch.float32
GEN_DECODE_MODES = [
    ("f32", torch.float32, None, None, None),
    ("int8 dot", torch.float32, torch.int8, True, _BS),
    ("int8 exact", torch.float32, torch.int8, False, _BS),
    ("fp8", torch.float32, torch.float8_e4m3fn, None, _BS)]
TC_DECODE_MODES = [
    ("bf16", torch.bfloat16, None, None, None),
    ("f16", torch.float16, None, None, None),
    ("int8 dot bf16 q", torch.bfloat16, torch.int8, True, _BS),
    ("int8 exact bf16 q", torch.bfloat16, torch.int8, False, _BS),
    ("fp8 bf16 q", torch.bfloat16, torch.float8_e4m3fn, None, _BS),
    ("int8 dot f16 q f32 scales", torch.float16, torch.int8, True, _FS),
    ("fp8 f16 q f32 scales", torch.float16, torch.float8_e4m3fn, None, _FS)]
GEN_PREFILL_MODES = [  # (mode, q / pool dtype, payload dtype or None)
    ("f32", torch.float32, None), ("bf16", torch.bfloat16, None),
    ("int8", torch.float32, torch.int8),
    ("fp8", torch.float32, torch.float8_e4m3fn)]
# 16-bit q on csrc/paged_prefill.cu at D 64 / 256: (mode, q dtype, payload
# dtype or None, scale dtype)
TC_PREFILL_MODES = [
    ("bf16", torch.bfloat16, None, None), ("f16", torch.float16, None, None),
    ("int8 bf16 q", torch.bfloat16, torch.int8, torch.bfloat16),
    ("fp8 bf16 q", torch.bfloat16, torch.float8_e4m3fn, torch.bfloat16),
    ("int8 f16 q f32 scales", torch.float16, torch.int8, torch.float32),
    ("fp8 f16 q f32 scales", torch.float16, torch.float8_e4m3fn,
     torch.float32)]
GPT2_HEADS = (12, 12, 64)   # Hq, Hkv, D
LLAMA_F32 = (32, 8, 128)    # the Llama layer's heads in f32 (group 4)
D256_F32 = (8, 1, 256)      # Gemma-2B's attention shape (group 8)


def _generic_pool(gen, total, max_pages, page, hkv, d, dtype, shuffle):
    """A fused pool of `page`-token pages (D padded to 128 lanes, zeros in
    the padding, as the appends leave it) holding total[b] tokens per
    sequence (random K/V), tables -1 past the used pages, page 0 scratch
    filled with garbage."""
    from aule_tpu_torch.ops.paged_fused import fused_pool_shape

    used = [-(-n // page) for n in total]
    num_pages = 1 + sum(used)
    pool = _randn(fused_pool_shape(num_pages, hkv, page, d), gen, dtype)
    pool[..., d:] = 0
    pool[0] = 1e4
    ids = np.arange(1, num_pages)
    if shuffle:
        ids = np.random.default_rng(SEED).permutation(ids)
    bt = np.full((len(total), max_pages), -1, np.int32)
    at = 0
    for b, n in enumerate(used):
        bt[b, :n] = ids[at:at + n]
        at += n
    return pool, torch.from_numpy(bt).to(DEV)


def _gen_quantized(pool, qdt, scale_dtype=torch.bfloat16):
    return (pool, None) if qdt is None else quantize_pool(pool, qdt,
                                                          scale_dtype)


def _generic_decode_checks(gen, res):
    """The paged decode at the head dims 64 and 256 against its plain
    version, twice with the same bits, each call counted on the kernel
    ops/paged_generic.py's rule picks: f32 q (GEN_DECODE_MODES: f32, int8
    dot, int8 exact and fp8 pools) on csrc/paged_generic.cu, 16-bit q
    (TC_DECODE_MODES: bf16 and f16 pools; int8 dot, int8 exact and e4m3
    pools with bf16 q and bf16 scales; int8 dot and e4m3 with f16 q and f32
    scales) on csrc/paged_decode.cu.  GPT-2's engine case (B8 ctx1024
    Hq12/Hkv12 D64 page 16) and its edges (lengths 0, 1 and 17 with -1
    tails, shuffled pages with a window, 64-token pages) in both; GPT-2's
    heads at B64 ctx1024 on shuffled pages in f32 q (768 (sequence, kv
    head) pairs: one split, so a block reads a whole 1,024-token range's
    page ids and writes its rows without the merge) and over 600-page
    tables (csrc/paged_generic.cuh copies a table's first 512 entries with
    q, the rest a ring ahead); D64 group 2 with a window of 64 and D256
    group 8 in 16 bits; f32 at the Llama
    layer (D128 group 4) and at D256 group 8.  Over split pools (f32
    scales), the same values in every mode but the int8 dot products (f32:
    GPT-2's cases; 16 bits: every case) must give the fused kernel's bits,
    and are held to the split plain version."""
    from aule_tpu_torch.ops.paged import paged_attention, paged_attention_plain
    from aule_tpu_torch.ops.paged_fused import (paged_attention_fused,
                                                paged_attention_fused_plain)
    from aule_tpu_torch.ops import decode_split
    from aule_tpu_torch.ops.paged_generic import paged_generic_decode

    if decode_split.num_splits(
            64, GPT2_HEADS[1], 1024, -1,
            decode_split.sm_count(torch.device(DEV)), 1,
            decode_split.generic_blocks_per_sm(64, True)) != 1:
        raise AssertionError("GPT-2 at B64 ctx1024 no longer runs in one "
                             "split: the case checks nothing of its own")
    both = GEN_DECODE_MODES + TC_DECODE_MODES
    cases = [  # (label, lens, max_pages, page, shuffle, window, heads, modes)
        ("GPT-2 engine B8 ctx1024", [1024] * 8, 64, 16, False, -1,
         GPT2_HEADS, both),
        ("lengths 0/1/17 with -1 tails", [1, 17, 0, 1024, 1000, 33, 512,
                                          999], 64, 16, False, -1,
         GPT2_HEADS, both),
        ("shuffled pages, window 300", [1024, 1, 17, 700, 1000, 64, 300,
                                        1023], 64, 16, True, 300,
         GPT2_HEADS, both),
        ("page 64", [1024, 1000, 1, 0, 63, 64, 65, 1023], 16, 64, True, -1,
         GPT2_HEADS, both),
        ("B64 ctx1024, one split", [1024] * 64, 64, 16, True, -1,
         GPT2_HEADS, GEN_DECODE_MODES),
        ("a 600-page table, lengths to 9600", [9600, 8193, 5, 8200], 600,
         16, True, -1, GPT2_HEADS, GEN_DECODE_MODES),
        ("D64 group 2, window 64", [1024, 1, 17, 333], 64, 16, True, 64,
         (8, 4, 64), TC_DECODE_MODES),
        ("f32 Llama layer D128 group 4", [4096, 1, 17, 3000], 272, 16, True,
         -1, LLAMA_F32, GEN_DECODE_MODES),
        ("f32 D256 group 8", [2048, 777], 128, 16, True, -1, D256_F32,
         GEN_DECODE_MODES),
        ("D256 group 8", [2048, 777], 128, 16, True, -1, D256_F32,
         TC_DECODE_MODES),
    ]
    counted = {"split decode checks": 0, "tc split decode checks": 0,
               "tc decode d256 checks": 0}
    for label, lens, max_pages, page, shuffle, window, (hq, hkv, d), modes \
            in cases:
        for mode, dt, qdt, dot, sdt in modes:
            tc = dt != torch.float32
            pool, bt = _generic_pool(gen, lens, max_pages, page, hkv, d, dt,
                                     shuffle)
            ln = torch.tensor(lens, dtype=torch.int32, device=DEV)
            q = _randn((len(lens), hq, d), gen, dt)
            pl, sc = _gen_quantized(pool, qdt, sdt)
            kw = dict(kv_scales=sc, window_size=window, int8_matmul=dot,
                      return_lse=True)
            fam = "tensor-core" if tc else "generic"
            what = (f"{fam} decode {mode} {label} Hq{hq}/Hkv{hkv} D{d} "
                    f"{str(dt).replace('torch.', '')} q")
            kernel = paged_attention_fused if tc else paged_generic_decode
            before = kernel.launches
            o, lse = _twice(what, lambda: paged_attention_fused(
                q, pl, bt, ln, **kw))
            if kernel.launches != before + 2:
                raise AssertionError(f"{what}: not launched on "
                                     f"{kernel.__name__}")
            if tc and d == 256:
                counted["tc decode d256 checks"] += 2
            po, plse = paged_attention_fused_plain(q, pl, bt, ln, **kw)
            key = (("tc " if tc else "") + "decode " + mode
                   + ("" if hq == 12 else f" {label}"))
            hold(what, o, po, lse, plse, _tol(dt, bool(dot)), res["err"], key)
            if dot or not (tc or hq == 12):
                continue
            (k, v, ks, vs), (fpool, fsc) = _split_pools(pool, qdt, d)
            skw = dict(k_scales=ks, v_scales=vs, window_size=window,
                       return_lse=True)
            kernel = paged_attention if tc else paged_generic_decode
            before = kernel.launches
            so, slse = _twice(f"split {what}", lambda: paged_attention(
                q, k, v, bt, ln, **skw))
            if kernel.launches != before + 2:
                raise AssertionError(f"split {what}: not launched on "
                                     f"{kernel.__name__}")
            counted[("tc " if tc else "") + "split decode checks"] += 2
            po, plse = paged_attention_plain(q, k, v, bt, ln, **skw)
            hold(f"split {what}", so, po, slse, plse, _tol(dt), res["err"],
                 ("tc " if tc else "") + "split " + mode
                 + ("" if hq == 12 else f" {label}"))
            fo, flse = paged_attention_fused(
                q, fpool, bt, ln, kv_scales=fsc, window_size=window,
                int8_matmul=False, return_lse=True)
            if not (torch.equal(so, fo) and torch.equal(slse, flse)):
                raise AssertionError(f"split {what}: not the fused kernel's "
                                     f"bits on the same pools")
    res["launches"].update(counted)
    log("paged decode at D 64/256: every split-pool case gives the fused "
        "kernel's bits on the same pools, and every call the same bits "
        "twice")


def _generic_prefill_checks(gen, res):
    """The paged prefill at the head dims 64 and 256 against its plain
    version, twice with the same bits, each call counted on the kernel
    ops/paged_generic.py's rule picks: f32 q (f32, int8 and fp8 pools) on
    csrc/paged_prefill_f32.cu, 16-bit q on csrc/paged_prefill.cu's tensor
    cores (TC_PREFILL_MODES: bf16 and f16 pools, int8 and e4m3 pools with
    bf16 q and bf16 scales, with f16 q and f32 scales).  GPT-2's 256-token
    chunk at q_offset 768 over 1024 (and with a 128 window), a ragged
    batch of 4 whose padding rows must be exact zeros, 64-token pages with
    a 1-token chunk; D256 group 8 (a chunk of 256 at 1000, a ragged batch
    of 3); D64 group 2 with a window; f32 at the Llama layer (a 512 chunk
    at 3488 over 4000)."""
    from aule_tpu_torch.config import DEFAULT_MASK_VALUE
    from aule_tpu_torch.ops.paged_generic import paged_prefill_f32
    from aule_tpu_torch.ops.paged_prefill import (
        paged_attention_prefill, paged_attention_prefill_plain)

    f32_modes = [(m, dt, qdt, torch.bfloat16)
                 for m, dt, qdt in GEN_PREFILL_MODES if dt == torch.float32]
    both = f32_modes + TC_PREFILL_MODES
    cases = [  # (label, hist, chunk, s_pad, max_pages, page, window, heads,
        #         modes)
        ("chunk 256 at q_offset 768 over 1024", [768], [256], 256, 64, 16,
         -1, GPT2_HEADS, both),
        ("chunk 256 at 768, window 128", [768], [256], 256, 64, 16, 128,
         GPT2_HEADS, both),
        ("ragged B4 with rows past context_lens", [700, 0, 1000, 63],
         [200, 130, 1, 77], 200, 64, 16, -1, GPT2_HEADS, both),
        ("page 64, ragged B2 chunks 256 and 1", [768, 900], [256, 1], 256,
         16, 64, -1, GPT2_HEADS, both),
        ("f32 Llama layer, chunk 512 at 3488 over 4000", [3488], [512], 512,
         272, 16, -1, LLAMA_F32, f32_modes),
        ("D256 group 8, chunk 256 at 1000", [1000], [256], 256, 128, 16, -1,
         D256_F32, both),
        ("D256 group 8, ragged B3", [700, 0, 1000], [200, 130, 1], 200, 128,
         16, -1, D256_F32, TC_PREFILL_MODES),
        ("D64 group 2, chunk 256 at 768, window 128", [768], [256], 256, 64,
         16, 128, (8, 4, 64), TC_PREFILL_MODES),
    ]
    for label, hist, chunk, s_pad, max_pages, page, window, (hq, hkv, d), \
            modes in cases:
        total = [h + c for h, c in zip(hist, chunk)]
        for mode, dt, qdt, sdt in modes:
            pool, bt = _generic_pool(gen, total, max_pages, page, hkv, d, dt,
                                     True)
            pl, sc = _gen_quantized(pool, qdt, sdt)
            q = _randn((len(hist), hq, s_pad, d), gen, dt)
            ln = torch.tensor(total, dtype=torch.int32, device=DEV)
            qoff = torch.tensor(hist, dtype=torch.int32, device=DEV)
            kw = dict(q_offsets=qoff, kv_scales=sc, window_size=window,
                      return_lse=True)
            tc = dt != torch.float32
            kernel = paged_attention_prefill if tc else paged_prefill_f32
            what = (f"{'tensor-core' if tc else 'f32-q'} prefill {mode} "
                    f"{label} Hq{hq}/Hkv{hkv} D{d} "
                    f"{str(dt).replace('torch.', '')} q")
            before = kernel.launches
            o, lse = _twice(what, lambda: paged_attention_prefill(
                q, pl, bt, ln, **kw))
            if kernel.launches != before + 2:
                raise AssertionError(f"{what}: not launched on "
                                     f"{kernel.__name__}")
            for b, n in enumerate(chunk):  # padding rows: exact zeros
                if not (bool((o[b, :, n:] == 0).all()) and bool(
                        (lse[b, :, n:] == DEFAULT_MASK_VALUE).all())):
                    raise AssertionError(f"{what}: padding rows of sequence "
                                         f"{b} are not zeros")
            po, plse = paged_attention_prefill_plain(q, pl, bt, ln, **kw)
            key = (("tc prefill " if tc else "prefill ") + mode
                   + ("" if hq == 12 else f" {label}"))
            hold(what, o, po, lse, plse, ROW_TOL[dt], res["err"], key)


# The paged kernels at the head dims 64 and 128 at GQA groups 3, 6 and 12
# over 4 kv heads (12: two row tiles of 8, the second half empty), at
# (label, q dtype, head dim): f32 q over every pool on csrc/paged_generic.cu
# and csrc/paged_prefill_f32.cu,
# bf16 q over bf16, int8 and e4m3 pools on the tensor-core kernels.
GEN_GROUPS = (3, 6, 12)
GEN_GROUP_TYPES = (("f32 D128", torch.float32, 128),
                   ("f32 D64", torch.float32, 64),
                   ("bf16 D64", torch.bfloat16, 64))


def _generic_group_checks(res):
    """The paged decode (both layouts, no window and a trailing window of
    64; paged_generic.cu's for f32 q, paged_decode.cu's for bf16 q) and the
    prefill (window 64; paged_prefill_f32.cu's for f32 q, paged_prefill.cu's
    for bf16 q) at GEN_GROUPS and GEN_GROUP_TYPES in every pool mode, from
    a generator of their own,
    held as _generic_decode_checks and _generic_prefill_checks hold theirs:
    twice with the same bits, against the plain versions, the split pools
    giving the fused kernel's bits."""
    from aule_tpu_torch.ops.paged import paged_attention, paged_attention_plain
    from aule_tpu_torch.ops.paged_fused import (paged_attention_fused,
                                                paged_attention_fused_plain)
    from aule_tpu_torch.ops.paged_prefill import (
        paged_attention_prefill, paged_attention_prefill_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(GPT2_SEED + 3)
    hkv, lens, max_pages = 4, [0, 1, 17, 600, 333], 48
    hist, chunk = [300, 0], [100, 37]
    for group in GEN_GROUPS:
        hq = group * hkv
        for tlabel, dt, d in GEN_GROUP_TYPES:
            native = "f32" if dt == torch.float32 else "bf16"
            for mode, qdt, dot in ((native, None, None),
                                   ("int8 dot", torch.int8, True),
                                   ("int8 exact", torch.int8, False),
                                   ("fp8", torch.float8_e4m3fn, None)):
                where = f"group {group} Hq{hq}/Hkv{hkv} {tlabel}"
                pool, bt = _generic_pool(gen, lens, max_pages, 16, hkv, d, dt,
                                         True)
                ln = torch.tensor(lens, dtype=torch.int32, device=DEV)
                q = _randn((len(lens), hq, d), gen, dt)
                pl, sc = _gen_quantized(pool, qdt)
                for window in (-1, 64):
                    kw = dict(kv_scales=sc, window_size=window,
                              int8_matmul=dot, return_lse=True)
                    tc = "tc " if dt != torch.float32 else ""
                    what = (f"{'tensor-core' if tc else 'generic'} decode "
                            f"{mode} {where} window {window}")
                    o, lse = _twice(what, lambda: paged_attention_fused(
                        q, pl, bt, ln, **kw))
                    po, plse = paged_attention_fused_plain(q, pl, bt, ln,
                                                           **kw)
                    hold(what, o, po, lse, plse, _tol(dt, bool(dot)),
                         res["err"], f"{tc}decode {mode} {where}")
                    if dot:
                        continue
                    (k, v, ks, vs), (fpool, fsc) = _split_pools(pool, qdt, d)
                    skw = dict(k_scales=ks, v_scales=vs, window_size=window,
                               return_lse=True)
                    so, slse = _twice(f"split {what}", lambda: paged_attention(
                        q, k, v, bt, ln, **skw))
                    po, plse = paged_attention_plain(q, k, v, bt, ln, **skw)
                    hold(f"split {what}", so, po, slse, plse, _tol(dt),
                         res["err"], f"{tc}split {mode} {where}")
                    fo, flse = paged_attention_fused(
                        q, fpool, bt, ln, kv_scales=fsc, window_size=window,
                        int8_matmul=False, return_lse=True)
                    if not (torch.equal(so, fo) and torch.equal(slse, flse)):
                        raise AssertionError(f"split {what}: not the fused "
                                             f"kernel's bits on the same "
                                             f"pools")
                if mode == "int8 exact":
                    continue  # the prefill has one int8 mode
                total = [h + c for h, c in zip(hist, chunk)]
                pool, bt = _generic_pool(gen, total, max_pages, 16, hkv, d, dt,
                                         True)
                pl, sc = _gen_quantized(pool, qdt)
                q = _randn((len(hist), hq, max(chunk), d), gen, dt)
                kw = dict(q_offsets=torch.tensor(hist, dtype=torch.int32,
                                                 device=DEV),
                          kv_scales=sc, window_size=64, return_lse=True)
                ln = torch.tensor(total, dtype=torch.int32, device=DEV)
                pmode = mode.split()[0]
                what = (f"{'generic' if dt == torch.float32 else 'tensor-core'}"
                        f" prefill {pmode} {where} window 64")
                o, lse = _twice(what, lambda: paged_attention_prefill(
                    q, pl, bt, ln, **kw))
                po, plse = paged_attention_prefill_plain(q, pl, bt, ln, **kw)
                hold(what, o, po, lse, plse, ROW_TOL[dt], res["err"],
                     ("prefill " if dt == torch.float32 else "tc prefill ")
                     + f"{pmode} {where}")
    log("generic groups: every split-pool case gives the fused kernel's bits "
        "on the same pools, and every call the same bits twice")


def _decode_mode_times(gen, res, key, mode, lens, heads, max_pages,
                       split):
    """One decode mode's times over fused pools (and split pools with f32
    scales when `split`): `_mode_time` of the wrapper as the rule routes
    it, beside SDPA on the K/V gathered (dequantized) to q's type with a
    key mask, at the context lengths `lens`.  Bounds count the D live
    lanes of each live K/V row once."""
    from aule_tpu_torch.ops.paged import paged_attention, paged_attention_plain
    from aule_tpu_torch.ops.paged_fused import (dequantize_pool,
                                                from_fused_layout,
                                                paged_attention_fused,
                                                paged_attention_fused_plain)
    from aule_tpu_torch.ops.quant import dequantize_kv
    from aule_tpu_torch.ops.reference import _gather_pages
    from aule_tpu_torch.utils import profiling

    name, dt, qdt, dot, sdt = mode
    hq, hkv, d = heads
    batch = len(lens)
    pool, bt = _generic_pool(gen, lens, max_pages, 16, hkv, d, dt, False)
    ln = torch.tensor(lens, dtype=torch.int32, device=DEV)
    q = _randn((batch, hq, d), gen, dt)
    pl, sc = _gen_quantized(pool, qdt, sdt)
    # a key mask where a sequence is shorter than the table (SDPA then
    # takes another route than without one)
    keep = None if min(lens) == max_pages * 16 else (
        torch.arange(max_pages * 16, device=DEV)[None, :]
        < ln[:, None])[:, None, None]

    def dense(k, v):
        """[Hkv, P, page, D] K and V -> [B, Hq, ctx, D] in q's type."""
        return (_gather_pages(x, bt).to(dt).repeat_interleave(
            hq // hkv, dim=1) for x in (k, v))

    kd, vd = dense(*(from_fused_layout(pl, d) if qdt is None
                     else dequantize_pool(pl, sc, d)))
    esz = q.element_size()
    payload = esz if qdt is None else 1
    common = 2 * q.numel() * esz + batch * max_pages * 4 + batch * 4
    flops = 4.0 * hq * d * sum(lens)
    rate = _rate(dt)
    kind = ("generic" if dt == torch.float32 else "tensor-core")
    shape = (f"B{batch} ctx{'/'.join(map(str, sorted(set(lens))))} page16 "
             f"Hq{hq}/Hkv{hkv} D{d}")
    kw = dict(kv_scales=sc, int8_matmul=dot)
    res["time"][f"{key}decode {name}"] = _mode_time(
        f"{kind} decode time {name} {shape}",
        lambda: paged_attention_fused(q, pl, bt, ln, **kw),
        lambda: paged_attention_fused_plain(q, pl, bt, ln, **kw),
        lambda: SDPA(q[:, :, None], kd, vd, attn_mask=keep),
        "fusedlayout" if dt == torch.float32 else "fusedpool",
        profiling.paged_kv_bytes(sum(lens), hkv, d, payload,
                                 0 if qdt is None else 2) + common,
        flops, rate)
    del kd, vd
    if not split:
        return
    (k, v, ks, vs), _ = _split_pools(pool, qdt, d)
    kw = dict(k_scales=ks, v_scales=vs)
    kd, vd = dense(*((k, v) if qdt is None else (dequantize_kv(k, ks),
                                                 dequantize_kv(v, vs))))
    res["time"][f"{key}split {name}"] = _mode_time(
        f"{kind} split decode time {name} {shape}"
        f"{'' if qdt is None else ', f32 scales'}",
        lambda: paged_attention(q, k, v, bt, ln, **kw),
        lambda: paged_attention_plain(q, k, v, bt, ln, **kw),
        lambda: SDPA(q[:, :, None], kd, vd, attn_mask=keep),
        "splitlayout" if dt == torch.float32 else "splitpools",
        profiling.paged_kv_bytes(sum(lens), hkv, d, payload,
                                 0 if qdt is None else 4) + common,
        flops, rate)
    del kd, vd, k, v


def _generic_timings(gen, res):
    """Times at GPT-2's engine shapes (profiler device time of the kernel
    alone and of the library call, CUDA-event medians of the kernel, its
    plain version and the library call, beside the bound): the decode at
    B8 ctx1024 in every f32-q mode over fused pools and in f32, int8 and
    fp8 over split pools (f32 scales) on paged_generic.cu, and on
    paged_decode.cu in bf16 (both layouts), int8 dot products and e4m3
    (bf16 q); paged_decode.cu at D256 group 8 (B2 Hq8/Hkv1, contexts 2048
    and 777) in bf16 and f16; the prefill of a 256-token chunk at
    q_offset 768 over 1024 (f32 q on paged_prefill_f32.cu, bf16 q on
    paged_prefill.cu, also over int8 and e4m3 pools) and bf16 at D256 group
    8 (a chunk of 256 at 1000).  Library: SDPA on the gathered, dequantized
    K/V in q's type (a key mask for the decode, a positional mask for the
    prefill, GQA expanded), timed only.  Bounds count the D live lanes of
    each K/V row once."""
    from aule_tpu_torch.ops.paged_fused import (dequantize_pool,
                                                from_fused_layout)
    from aule_tpu_torch.ops.paged_prefill import (
        paged_attention_prefill, paged_attention_prefill_plain)
    from aule_tpu_torch.utils import profiling

    gpt2 = ([1024] * 8, GPT2_HEADS, 64)
    for key, mode, (lens, heads, max_pages), split in (
            [("", m, gpt2, not m[3]) for m in GEN_DECODE_MODES]
            + [("tc ", m, gpt2, m[0] == "bf16")
               for m in TC_DECODE_MODES if m[0] in ("bf16", "int8 dot bf16 q",
                                                    "fp8 bf16 q")]
            + [("tc d256 ", m, ([2048, 777], D256_F32, 128), False)
               for m in TC_DECODE_MODES[:2]]
            # the f32-q decode at the f32 Llama layer's decode (D128 group
            # 4, B8 ctx4096) and D256 group 8: its plain version's time and
            # SDPA in f32 beside it
            + [(f"{tag} ", m, shape, False) for tag, shape in (
                ("llama d128", ([4096] * 8, LLAMA_F32, 256)),
                ("d256", ([2048, 777], D256_F32, 128)))
               for m in GEN_DECODE_MODES]):
        _decode_mode_times(gen, res, key, mode, lens, heads, max_pages,
                           split)
    # the prefill at GPT-2's chunk in every mode of GEN_PREFILL_MODES (f32
    # q on paged_prefill_f32.cu, bf16 on paged_prefill.cu) and with bf16 q over
    # 1-byte pools, then bf16 at D256 group 8 (a chunk of 256 at 1000)
    for mode, dt, qdt, (hq, hkv, d), hist, chunk, max_pages in [
            (m, dt, qdt, GPT2_HEADS, 768, 256, 64)
            for m, dt, qdt in GEN_PREFILL_MODES] + [
            (m, dt, qdt, GPT2_HEADS, 768, 256, 64)
            for m, dt, qdt, _ in TC_PREFILL_MODES[2:4]] + [
            ("bf16 d256", torch.bfloat16, None, D256_F32, 1000, 256, 128)]:
        mask = (torch.arange(hist + chunk, device=DEV)[None, :]
                <= hist + torch.arange(chunk, device=DEV)[:, None])
        flops = profiling.paged_prefill_flops([hist], [chunk], hq, d)
        pool, bt = _generic_pool(gen, [hist + chunk], max_pages, 16, hkv, d,
                                 dt, False)
        pl, sc = _gen_quantized(pool, qdt)
        q = _randn((1, hq, chunk, d), gen, dt)
        ln = torch.tensor([hist + chunk], dtype=torch.int32, device=DEV)
        qoff = torch.tensor([hist], dtype=torch.int32, device=DEV)
        kh, vh = (from_fused_layout(pl[1:], d) if qdt is None
                  else dequantize_pool(pl[1:], sc[1:], d))
        # pages 1.. hold the sequence in order; its last page is partial
        kd, vd = (x.reshape(1, hkv, -1, d)[:, :, :hist + chunk].to(dt)
                  .repeat_interleave(hq // hkv, dim=1) for x in (kh, vh))
        esz = q.element_size()
        kw = dict(q_offsets=qoff, kv_scales=sc)
        tc = dt != torch.float32
        nbytes = 2 * q.numel() * esz + profiling.paged_kv_bytes(
            hist + chunk, hkv, d, esz if qdt is None else 1,
            0 if qdt is None else 2) + max_pages * 4 + 3 * 4
        res["time"][("tc prefill " if tc else "prefill ") + mode] = t = \
            _mode_time(
            f"{'tensor-core' if tc else 'f32-q'} prefill time {mode} "
            f"chunk {chunk} at {hist} over {hist + chunk} Hq{hq}/Hkv{hkv} "
            f"D{d} page16",
            lambda: paged_attention_prefill(q, pl, bt, ln, **kw),
            lambda: paged_attention_prefill_plain(q, pl, bt, ln, **kw),
            lambda: SDPA(q, kd, vd, attn_mask=mask),
            "paged_prefill_kernel" if tc else "paged_prefill_f32",
            nbytes, flops, _fwd_rate(dt))
        if not tc:  # f32 q in 3xTF32; its FFMA bound beside it
            t["ffma_bound_ms"] = profiling.bound_ms(
                nbytes, flops, profiling.H100_F32_FLOPS)[0]
        del kd, vd, kh, vh


# GPT-2 small's serving runs: (key, label, bf16 model, engine options,
# check: "plain" forward or quantized "replay", near-tie allowance).  The
# f32, int8 and fp8 chunked runs put every pool mode of the f32-q prefill
# on the main path, the bf16 chunked run the tensor-core prefill at D64.
GPT2_RUNS = [
    ("f32", "GPT-2 f32 whole-prompt", False, {}, "plain", GPT2_F32_NEAR_TIE),
    ("f32 chunk", "GPT-2 f32 chunk 256", False,
     dict(prefill_chunk=GPT2_CHUNK), "plain", GPT2_F32_NEAR_TIE),
    ("int8 chunk", "GPT-2 int8 chunk 256", False,
     dict(quantized=True, prefill_chunk=GPT2_CHUNK), "replay", NEAR_TIE),
    ("fp8", "GPT-2 fp8 whole-prompt", False,
     dict(quantized=True, quant_dtype=torch.float8_e4m3fn), "replay",
     NEAR_TIE),
    ("fp8 chunk", "GPT-2 fp8 chunk 256", False,
     dict(quantized=True, quant_dtype=torch.float8_e4m3fn,
          prefill_chunk=GPT2_CHUNK), "replay", NEAR_TIE),
    ("bf16", "GPT-2 bf16 whole-prompt", True, {}, "plain", NEAR_TIE),
    ("bf16 chunk", "GPT-2 bf16 chunk 256", True,
     dict(prefill_chunk=GPT2_CHUNK), "plain", NEAR_TIE),
]


def _gpt2_resume(params, cfg, prompts, want, res):
    """Engine checkpoint / resume on the card: the GPT-2 bf16 whole-prompt
    run again, saved with save_engine_state after its first decode
    dispatch into a temporary directory (removed afterwards), loaded by a
    fresh engine, which must finish with the uninterrupted run's tokens
    (`want`) and give every page back."""
    import tempfile

    from aule_tpu_torch.models import gpt2
    from aule_tpu_torch.serving.engine import (ServingEngine,
                                               load_engine_state,
                                               save_engine_state)

    kw = GPT2_ENGINE_KW

    def engine():
        return ServingEngine(params, cfg, model=gpt2, device=DEV, **kw)

    eng = engine()
    for p in prompts:
        eng.submit(p, NEW_TOKENS)
    eng.step()  # admits and prefills 8 requests, then one decode dispatch
    if eng.decode_dispatches != 1 or not eng.waiting:
        raise AssertionError("engine resume: not saved mid-run after one "
                             "decode dispatch")
    running = eng.num_running
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "engine")
        t0 = time.perf_counter()
        save_engine_state(eng, path)
        t_save = time.perf_counter() - t0
        del eng
        torch.cuda.empty_cache()
        nbytes = sum(os.path.getsize(os.path.join(tmp, f))
                     for f in os.listdir(tmp))
        fresh = engine()
        t0 = time.perf_counter()
        load_engine_state(fresh, path)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    got = [list(r.output) for r in fresh.run()]
    if got != want:
        same = _same(got, want)
        raise AssertionError(f"engine resume: {same} of "
                             f"{len(prompts) * NEW_TOKENS} tokens equal the "
                             f"uninterrupted run's")
    if fresh.allocator.num_free != kw["num_pages"] - 1:
        raise AssertionError(f"engine resume: pages leaked: "
                             f"{fresh.allocator.num_free} free")
    log(f"engine resume GPT-2 bf16 whole-prompt: saved after the first "
        f"decode dispatch ({running} running, {len(prompts) - running} "
        f"waiting; {nbytes / 1e6:.1f} MB in {t_save:.2f} s, loaded in "
        f"{t_load:.2f} s); the resumed engine's {len(prompts) * NEW_TOKENS} "
        f"tokens equal the uninterrupted run's; every page came back")
    res["resume"] = dict(tokens_equal=len(prompts) * NEW_TOKENS,
                         file_mb=nbytes / 1e6, save_s=t_save, load_s=t_load)
    del fresh
    torch.cuda.empty_cache()


def _gpt2_serving(res):
    """GPT-2 small at full width and depth (GPT2Config(): vocab 50,257, 12
    layers of 12 heads, D64; random f32 weights from a seeded generator on
    the card, and the same cast to bf16) serves 12 greedy requests of 7 to
    1,000 prompt tokens, 24 new tokens each, through
    ServingEngine(model=gpt2) in every run of GPT2_RUNS and in an f32
    chunk-256 run with two LoRA adapters (base / a / b over the requests)
    and top-k 20 at EDGE_TEMP on two, each checked by
    run_engine (launches: the paged decode 12 times a step and the prefill
    12 times a chunk, paged_generic.cu's / paged_prefill_f32.cu's in f32,
    paged_decode.cu's and
    paged_prefill.cu's in bf16; the flash forward 12 times a whole prompt,
    by ops/flash.py's rule: flash_f32.cu's in f32, the TMA kernel at D64
    in bf16; pages) and held to a
    teacher-forced plain forward or plain-attention replay.  Then one
    prefill step and one 8-step decode dispatch of the f32 engine under
    torch.profiler."""
    from aule_tpu_torch.models import gpt2
    from aule_tpu_torch.serving.engine import ServingEngine
    from aule_tpu_torch.utils import profiling

    cfg = gpt2.GPT2Config()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = gpt2.init_params(cfg, gen, device=DEV)
    bcfg = gpt2.GPT2Config(dtype=torch.bfloat16)
    bparams = {k: ([{n: t.to(torch.bfloat16) for n, t in layer.items()}
                    for layer in v] if k == "layers" else v.to(torch.bfloat16))
               for k, v in params.items()}
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in gpt2._tensors(params))
    log(f"gpt2: GPT-2 small dim {cfg.dim} layers {cfg.n_layers} heads "
        f"{cfg.n_heads} D{cfg.head_dim} vocab {cfg.vocab_size} n_ctx "
        f"{cfg.n_ctx}: {n_params / 1e6:.1f} M params, "
        f"{4 * n_params / 1e9:.2f} GB in f32, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in GPT2_PROMPT_LENS]
    for key, label, bf16, kw, check, tie in GPT2_RUNS:
        p, c = (bparams, bcfg) if bf16 else (params, cfg)
        out, res["runs"][key] = run_engine(p, c, prompts, label, model=gpt2,
                                           engine_kw=GPT2_ENGINE_KW, **kw)
        if key == "bf16":
            _gpt2_resume(p, c, prompts, out, res)
        if check == "plain":
            check_plain_forward(p, c, prompts, out, label, model=gpt2,
                                tie=tie)
        else:
            check_replay(p, c, prompts, out, label, kw["quant_dtype"]
                         if "quant_dtype" in kw else torch.int8,
                         kw.get("prefill_chunk"), model=gpt2,
                         engine_kw=GPT2_ENGINE_KW, tie=tie)
    # f32 chunk 256 with two rank-16 adapters cycling base / a / b over the
    # requests and top-k 20 at EDGE_TEMP on two of them: paged_generic.cuh
    # and paged_prefill_f32.cu under LoRA
    label = "GPT-2 f32 chunk 256, LoRA + top-k"
    reqs = [dict(lora=EDGE_GROUPS[i % 3]) for i in range(len(prompts))]
    for i in (4, 9):
        reqs[i].update(temperature=EDGE_TEMP, top_k=20)
    info = {}
    out, res["runs"]["f32 lora"] = run_engine(
        params, cfg, prompts, label, model=gpt2, engine_kw=GPT2_ENGINE_KW,
        prefill_chunk=GPT2_CHUNK, lora_params=edge_adapters(cfg),
        submit_kw=reqs, info=info)
    check_plain_forward(params, cfg, prompts, out, label, model=gpt2,
                        tie=GPT2_F32_NEAR_TIE, edges=_EdgeJudge(
                            label, edge_specs(reqs, info), info["lora"]))
    del info
    kw = GPT2_ENGINE_KW
    eng = ServingEngine(params, cfg, model=gpt2, device=DEV, **kw)
    rng = np.random.default_rng(SEED + 1)
    n = max(GPT2_PROMPT_LENS)
    eng.submit(rng.integers(0, cfg.vocab_size, size=n), 1)
    _log_breakdown(f"gpt2 f32 prefill S{n} (one engine step)",
                   profiling.device_breakdown(eng.step, CATEGORIES))
    eng.run()
    # 8 prompts that fit the pool together with 17 tokens each (the first
    # from the prefill, then two dispatches of 8 steps)
    n = min(kw["max_seq_len"], (kw["num_pages"] - 1) // 8 *
            kw["page_size"]) - 17
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, size=n), 17)
    eng.step()  # admits and prefills all 8, then a first 8-step dispatch
    _log_breakdown(f"gpt2 f32 decode B8 ctx~{n}, 8 steps (one dispatch)",
                   profiling.device_breakdown(eng.run, CATEGORIES))
    del eng, params, bparams
    torch.cuda.empty_cache()


def check_gpt2() -> dict:
    """The GPT-2 phase: csrc/paged_generic.cu's and csrc/paged_prefill_f32.cu's
    kernels, and csrc/paged_decode.cu and csrc/paged_prefill.cu at D 64/256,
    held to
    their plain versions and timed, then GPT-2 small served.  Returns the
    errors, times and launches."""
    from aule_tpu_torch.ops.paged_generic import (paged_generic_decode,
                                                  paged_prefill_f32)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(GPT2_SEED)
    res = {"err": {}, "time": {}, "launches": {}, "runs": {}}
    _generic_decode_checks(gen, res)
    _generic_prefill_checks(gen, res)
    _generic_group_checks(res)
    _generic_timings(gen, res)
    paged_generic_decode.launches = paged_prefill_f32.launches = 0
    _gpt2_serving(res)
    return res


# Llama-3.2-3B (meta-llama/Llama-3.2-3B, config.json): 24 q heads over 8
# kv heads, GQA group 3, D128, 28 layers.  Neither package has tied
# embeddings or the llama3 RoPE scaling, so the head is untied and RoPE
# plain: no attention shape changes (~3.61 B parameters).
LLAMA32_3B = dict(vocab_size=128256, dim=3072, n_layers=28, n_heads=24,
                  n_kv_heads=8, hidden_dim=8192, rope_base=500000.0,
                  norm_eps=1e-5)
# Served at 14 of those 28 layers: depth cut for the script's time limit;
# the attention shapes do not change with depth.
LLAMA32_LAYERS = 14
# Its serving runs, the Llama-3-8B runs' keys: (key, label, engine
# options, quantized payload dtype or None).  Every run decodes through
# the tensor-core decode at group 3; the chunked ones prefill through the
# paged prefill at group 3.
LLAMA32_RUNS = [
    ("whole bf16", "Llama-3.2-3B bf16 whole-prompt", {}, None),
    ("a", "Llama-3.2-3B (a) bf16 chunk 512", dict(prefill_chunk=CHUNK),
     None),
    ("b", "Llama-3.2-3B (b) int8 chunk 512",
     dict(quantized=True, prefill_chunk=CHUNK), torch.int8),
    ("c", "Llama-3.2-3B (c) fp8 whole-prompt",
     dict(quantized=True, quant_dtype=torch.float8_e4m3fn),
     torch.float8_e4m3fn),
    ("e", "Llama-3.2-3B (e) split bf16", dict(layout="split"), None),
    ("f", "Llama-3.2-3B (f) split int8", dict(layout="split", quantized=True),
     torch.int8),
]
# The decode's GQA classes timed side by side at B8 ctx4096: (tag, Hq,
# Hkv); the main path's group 4, Llama-3.2-3B's 3 (the same bytes read),
# 12 (two 8-row tiles) and 32 (MQA, four 8-row tiles).
GQA_TIMED = (("g4", 32, 8), ("g3", 24, 8), ("g12", 96, 8), ("g32", 32, 1))
# check_groups' small case at every group, as the kernels line names it
GROUP_CASE = {
    "decode": "check_groups: B5 lengths 0/1/17/600/333 over 48-page tables "
              "(3 splits), shuffled pages, with and without a window 64",
    "prefill": "check_groups: chunks 100 at 300 and 37 at 0, 48-page "
               "tables, window 64"}
GQA_SEED = SEED + 13  # a generator of its own


def _gqa_decode_times(res):
    """The decode at B8 ctx4096 page 16 (272-page tables) for each of
    GQA_TIMED, in one process so that the groups meet the same card:
    groups 4 and 3 in every mode of Llama-3.2-3B's runs (fused bf16, int8
    dot products and fp8 with bf16 scales; split bf16 and int8 with f32
    scales), 12 and 32 fused bf16.  Each call twice with the same bits,
    held to its plain version (_tol), then its device and event times
    beside its bound, its plain version and SDPA on the gathered K/V (GQA
    expanded); errors into res["err"], times into res["time"]."""
    from aule_tpu_torch.ops.paged import paged_attention, paged_attention_plain
    from aule_tpu_torch.ops.paged_fused import (paged_attention_fused,
                                                paged_attention_fused_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(GQA_SEED)
    batch, ctx = 8, 4096
    lens = [ctx] * batch
    modes = [  # (mode, payload dtype or None, int8_matmul, split pools)
        ("bf16", None, None, False), ("int8 dot", torch.int8, True, False),
        ("fp8", torch.float8_e4m3fn, None, False),
        ("split bf16", None, None, True), ("split int8", torch.int8, None,
                                           True)]
    for tag, hq, hkv in GQA_TIMED:
        group = hq // hkv
        q, pool, bt, ln = _decode_inputs(gen, lens, 272, hq=hq, hkv=hkv)
        for mode, qdt, dot, split in (modes if tag in ("g3", "g4")
                                      else modes[:1]):
            if split:
                (k, v, ks, vs), _, kh, vh, kv_bytes = _split_operands(
                    pool, qdt, sum(lens))
                kw = dict(k_scales=ks, v_scales=vs)
                kernel = lambda **x: paged_attention(q, k, v, bt, ln, **kw,
                                                     **x)
                plain = lambda **x: paged_attention_plain(q, k, v, bt, ln,
                                                          **kw, **x)
            else:
                pl, sc, kh, vh, kv_bytes = _fused_operands(pool, qdt,
                                                           sum(lens))
                kw = dict(kv_scales=sc, int8_matmul=dot)
                kernel = lambda **x: paged_attention_fused(q, pl, bt, ln,
                                                           **kw, **x)
                plain = lambda **x: paged_attention_fused_plain(
                    q, pl, bt, ln, **kw, **x)
            what = (f"gqa decode {mode} group {group} B8 ctx4096 page16 "
                    f"Hq{hq}/Hkv{hkv}")
            o, lse = _twice(what, lambda: kernel(return_lse=True))
            po, plse = plain(return_lse=True)
            res["err"][f"decode {mode} {tag}"] = hold(
                what, o, po, lse, plse, _tol(torch.bfloat16, bool(dot)))
            del o, lse, po, plse
            kd, vd = _dense_kv(kh, vh, batch, ctx, group)
            res["time"][f"decode {mode} {tag}"] = _decode_time(
                f"gqa decode time {mode} group {group} B8 ctx4096 page16 "
                f"Hq{hq}/Hkv{hkv}", kernel, plain,
                lambda: SDPA(q[:, :, None], kd, vd),
                "splitpools" if split else "fusedpool", kv_bytes, batch, ctx,
                hq=hq)
            del kd, vd, kh, vh
        del q, pool
        torch.cuda.empty_cache()
    g3, g4 = (res["time"][f"decode bf16 {t}"]["device_ms"]
              for t in ("g3", "g4"))
    log(f"gqa decode: group 3 bf16 {_ms(g3)} against group 4 {_ms(g4)} "
        f"(same bytes read)"
        + ("" if None in (g3, g4) else f", ratio {g3 / g4:.3f}"))


def _gqa_prefill_times(res):
    """The paged prefill at the engine's chunk case (_chunk_prefill_times:
    held to its plain version, then timed) at groups 4 and 3 (Hkv 8), bf16
    and int8 pools (bf16 scales)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(GQA_SEED + 1)
    for tag, hq in (("g4", 32), ("g3", 24)):
        q, pool, bt, ln, qoff = _prefill_inputs(gen, [3488], [512], 512,
                                                shuffle=False, hq=hq)
        t = _chunk_prefill_times(
            q, pool, bt, ln, qoff, (("bf16", None), ("int8", torch.int8)),
            f"gqa prefill time {{}} group {hq // 8}")
        for mode, times in t.items():
            res["time"][f"prefill {mode} {tag}"] = times
            res["err"][f"prefill {mode} {tag}"] = times["err"]


def _serve(params, cfg, prompts, runs, res, engine_kw=ENGINE_KW,
           model=None, lora_run=None):
    """Serve the prompts once per run of `runs` ((key, label, engine
    options, quantized payload dtype or None)) of `model` (Llama unless
    given), each checked by run_engine and held to a teacher-forced plain
    forward (unquantized) or a plain-attention replay (quantized); a
    mixture of experts (`n_experts` in cfg) routed in the check as the run
    routed (_Routing).  The run keyed `lora_run` registers edge_adapters'
    two adapters and cycles base / a / b over its requests; its check runs
    each request on its adapter."""
    for key, label, kw, qdt in runs:
        routing = (_Routing(cfg.n_layers) if hasattr(cfg, "n_experts")
                   else None)
        more, info, reqs = {}, {}, None
        if key == lora_run:
            reqs = [dict(lora=EDGE_GROUPS[i % 3])
                    for i in range(len(prompts))]
            more = dict(lora_params=edge_adapters(cfg), submit_kw=reqs,
                        info=info)
        out, res["runs"][key] = run_engine(params, cfg, prompts, label,
                                           model=model, engine_kw=engine_kw,
                                           routing=routing, **more, **kw)
        edges = (None if reqs is None else
                 _EdgeJudge(label, edge_specs(reqs, info), info["lora"]))
        if qdt is None:
            check_plain_forward(params, cfg, prompts, out, label,
                                model=model, routing=routing, edges=edges)
        else:
            check_replay(params, cfg, prompts, out, label, qdt,
                         kw.get("prefill_chunk"),
                         layout=kw.get("layout", "fused"), model=model,
                         engine_kw=engine_kw, routing=routing, edges=edges)
        del more, info


def check_llama32() -> dict:
    """The GQA phase: the decode's and the prefill's times at groups 3, 4,
    12 and 32 (_gqa_decode_times, _gqa_prefill_times), then Llama-3.2-3B
    at full width on LLAMA32_LAYERS layers (LLAMA32_3B, random bf16
    weights from SEED on the card) serving the 12 prompts of PROMPT_LENS, 24 new tokens each,
    through ServingEngine(**ENGINE_KW) in every run of LLAMA32_RUNS.
    Returns the times and each run's launches."""
    from aule_tpu_torch.models import llama

    log(card_line())
    res = {"time": {}, "err": {}, "runs": {}}
    _gqa_decode_times(res)
    _gqa_prefill_times(res)
    cfg = llama.LlamaConfig(**dict(LLAMA32_3B, n_layers=LLAMA32_LAYERS))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in llama._tensors(params))
    log(f"llama32: Llama-3.2-3B dim {cfg.dim} layers {cfg.n_layers} heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} (group "
        f"{cfg.n_heads // cfg.n_kv_heads}) D{cfg.head_dim} hidden "
        f"{cfg.hidden_dim} vocab {cfg.vocab_size} bf16: "
        f"{n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    _serve(params, cfg, prompts, LLAMA32_RUNS, res)
    del params
    torch.cuda.empty_cache()
    return res


# Mistral-7B (LlamaConfig.mistral_7b(): a 4096-token sliding window) at full
# width and depth, prompts past the window so that both the prefill's and
# the decode's window bite; max_seq_len raised to hold them.
MISTRAL_PROMPT_LENS = [4200, 4700, 5300, 6000]
MISTRAL_KW = dict(max_batch=8, page_size=16, num_pages=1400,
                  max_pages_per_seq=384, max_seq_len=6144, decode_steps=8)
MISTRAL_RUNS = [
    ("whole bf16", "Mistral-7B bf16 whole-prompt", {}, None),
    ("a", "Mistral-7B (a) bf16 chunk 512", dict(prefill_chunk=CHUNK), None),
]


MISTRAL_SEED = SEED + 14  # a generator of its own


def _mistral_kernels(res):
    """Mistral-7B's windowed kernels at its shapes (Hq32/Hkv8 D128 bf16),
    each call twice with the same bits, held to its plain version
    (ROW_TOL, LSE_TOL) and timed beside its bound and a library call: the
    flash forward of the whole-prompt prefill at the longest prompt
    (S6000, window 4096: the TMA kernel's window skip; SDPA with the
    window's boolean mask); the decode over MISTRAL_KW's 384-page tables
    with the decode window 4097 (llama._decode_window), at the prompts'
    lengths after their new tokens (shuffled pages) and, timed, at B4
    ctx6000 (SDPA on the window's gathered K/V); the paged prefill of a
    512-token chunk at 5488 over 6000 with the window
    (_chunk_prefill_times).  Errors into res["err"], times into
    res["time"]."""
    from aule_tpu_torch.models import llama
    from aule_tpu_torch.ops.flash import (flash_attention_fwd,
                                          flash_attention_fwd_plain)
    from aule_tpu_torch.ops.paged_fused import (paged_attention_fused,
                                                paged_attention_fused_plain)
    from aule_tpu_torch.ops.reference import build_mask
    from aule_tpu_torch.utils import profiling

    cfg = llama.LlamaConfig.mistral_7b()
    hq, hkv, w = cfg.n_heads, cfg.n_kv_heads, cfg.window_size
    dw, pages = llama._decode_window(cfg), MISTRAL_KW["max_pages_per_seq"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(MISTRAL_SEED)

    s = max(MISTRAL_PROMPT_LENS)
    q = _randn((1, hq, s, 128), gen)
    k = _randn((1, hkv, s, 128), gen)
    v = _randn((1, hkv, s, 128), gen)
    kw = dict(causal=True, window_size=w)
    what = (f"mistral flash forward B1 Hq{hq}/Hkv{hkv} S{s} D128 bf16 "
            f"causal window {w}")
    o, lse = _twice(what, lambda: flash_attention_fwd(q, k, v,
                                                      return_lse=True, **kw))
    po, plse = flash_attention_fwd_plain(q, k, v, return_lse=True, **kw)
    res["err"]["flash"] = hold(what, o, po, lse, plse,
                               ROW_TOL[torch.bfloat16])
    del o, lse, po, plse
    kx, vx = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
    mask = build_mask(s, s, True, w, device="cuda")
    kernel = lambda: flash_attention_fwd(q, k, v, return_lse=False, **kw)
    sdpa = lambda: SDPA(q, kx, vx, attn_mask=mask)
    ms = profiling.cuda_time_ms(kernel, iters=20)
    plain = profiling.cuda_time_ms(
        lambda: flash_attention_fwd_plain(q, k, v, return_lse=False, **kw),
        iters=20)
    lib = profiling.cuda_time_ms(sdpa, iters=20)
    dev, dev_lib = device_ms(kernel), device_ms(sdpa)
    flops = profiling.window_attention_flops(1, hq, s, 128, w)
    bound, by = profiling.bound_ms(2 * (q.numel() * 2 + k.numel()
                                        + v.numel()), flops)
    res["time"]["flash"] = dict(ms=ms[0], plain_ms=plain[0],
                                library_ms=lib[0], bound_ms=bound,
                                bound_by=by, device_ms=dev,
                                library_device_ms=dev_lib)
    rate = "" if dev is None else f", {flops / dev / 1e9:.1f} TFLOP/s"
    log(f"{what}: kernel {ms[0]:.4f} ms (min {ms[1]:.4f} max {ms[2]:.4f}), "
        f"device {_ms(dev)}{rate}; plain {plain[0]:.4f} ms; sdpa with the "
        f"window mask {lib[0]:.4f} ms, device {_ms(dev_lib)}; bound "
        f"{bound:.4f} ms ({by})")
    del q, k, v, kx, vx, mask

    lens = [n + NEW_TOKENS for n in MISTRAL_PROMPT_LENS]
    for label, case_lens, shuffle in (
            ("the prompts' lengths " + "/".join(map(str, lens)), lens, True),
            ("B4 ctx6000", [s] * 4, False)):
        q, pool, bt, ln = _decode_inputs(gen, case_lens, pages,
                                         shuffle=shuffle, hq=hq, hkv=hkv)
        kernel = lambda **x: paged_attention_fused(q, pool, bt, ln,
                                                   window_size=dw, **x)
        plain = lambda **x: paged_attention_fused_plain(q, pool, bt, ln,
                                                        window_size=dw, **x)
        what = (f"mistral decode window {dw} over {pages}-page tables, "
                f"{label}, Hq{hq}/Hkv{hkv} D128 bf16")
        o, lse = _twice(what, lambda: kernel(return_lse=True))
        po, plse = plain(return_lse=True)
        errs = hold(what, o, po, lse, plse, ROW_TOL[torch.bfloat16])
        res["err"]["decode"] = tuple(max(a, b) for a, b in zip(
            res["err"].get("decode", (0.0, 0.0, 0.0)), errs))
        del o, lse, po, plse
        if shuffle:
            continue
        _, _, kh, vh, kv_bytes = _fused_operands(pool, None, 4 * dw)
        kd, vd = (x[:, :, -dw:].contiguous()
                  for x in _dense_kv(kh, vh, 4, s, hq // hkv))
        res["time"]["decode"] = _decode_time(
            f"mistral decode time window {dw} B4 ctx6000 page16 "
            f"Hq{hq}/Hkv{hkv}", kernel, plain,
            lambda: SDPA(q[:, :, None], kd, vd), "fusedpool", kv_bytes, 4,
            dw, hq=hq, max_pages=pages)
        del kd, vd, kh, vh
    del q, pool

    q, pool, bt, ln, qoff = _prefill_inputs(gen, [s - CHUNK], [CHUNK],
                                            CHUNK, max_pages=pages,
                                            shuffle=False, hq=hq, hkv=hkv)
    t = _chunk_prefill_times(q, pool, bt, ln, qoff, (("bf16", None),),
                             "mistral prefill {} pool", hist=s - CHUNK,
                             window=w)["bf16"]
    res["time"]["prefill"], res["err"]["prefill"] = t, t["err"]
    del q, pool
    torch.cuda.empty_cache()


def check_mistral() -> dict:
    """Mistral-7B: its windowed kernels at its shapes (_mistral_kernels),
    then the model (random bf16 weights from SEED on the card) serving
    MISTRAL_PROMPT_LENS prompts, 24 new tokens each, through
    ServingEngine(**MISTRAL_KW) whole-prompt and with prefill_chunk=512,
    each held to a teacher-forced plain forward with the window.  Returns
    the kernels' errors and times and each run's launches."""
    from aule_tpu_torch.models import llama

    log(card_line())
    res = {"time": {}, "err": {}, "runs": {}}
    _mistral_kernels(res)
    cfg = llama.LlamaConfig.mistral_7b()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in llama._tensors(params))
    log(f"mistral: Mistral-7B dim {cfg.dim} layers {cfg.n_layers} heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} window {cfg.window_size} vocab "
        f"{cfg.vocab_size} bf16: {n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in MISTRAL_PROMPT_LENS]
    _serve(params, cfg, prompts, MISTRAL_RUNS, res, engine_kw=MISTRAL_KW)
    del params
    torch.cuda.empty_cache()
    return res


# Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1, config.json: MoEConfig.
# mixtral_8x7b()) at full width, cut to 8 of its 32 layers: a layer holds
# 1.45 B parameters (2.9 GB in bf16), so 32 layers (93 GB) do not fit the
# card's 80 GB; 8 take 23.2 GB, with 0.5 GB of embedding and head, beside
# the 2,100-page pools (2.2 GB) and the dense mixture's [8, T, 14336]
# transients; depth cut for the script's time limit.
MIXTRAL_LAYERS = 8
# Its serving runs: (key, label, engine options, quantized payload dtype or
# None), the Llama-3-8B runs' keys.  The whole-prompt runs prefill through
# the flash forward, the chunked one through the paged prefill; every run
# decodes through the fused decode (group 4, D128, as Llama-3-8B's).
MOE_RUNS = [
    ("whole bf16", "Mixtral bf16 whole-prompt", {}, None),
    ("b", "Mixtral (b) int8 chunk 512, LoRA",
     dict(quantized=True, prefill_chunk=CHUNK), torch.int8),
    ("c", "Mixtral (c) fp8 whole-prompt",
     dict(quantized=True, quant_dtype=torch.float8_e4m3fn),
     torch.float8_e4m3fn),
]
MOE_LORA_RUN = "b"  # carries edge_adapters' two adapters (base / a / b)
MOE_GRAD_S = 1024  # the 2-layer gradient check's tokens (B1 x 1025)


def check_moe() -> dict:
    """Mixtral-8x7B at full width on MIXTRAL_LAYERS layers (random bf16
    weights from SEED on the card) serving the 12 prompts of PROMPT_LENS,
    24 new tokens each, through ServingEngine(model=moe, **ENGINE_KW) in
    every run of MOE_RUNS (each checked by run_engine: the fused decode
    once a layer a step, the paged prefill once a layer a chunk, the flash
    forward once a layer a whole prompt, every page back; tokens held to a teacher-forced
    plain forward or a plain-attention replay, routed as the run routed;
    run MOE_LORA_RUN on edge_adapters' two adapters, base / a / b over its
    requests, checked on each request's adapter),
    then moe.loss_fn's gradients through the kernels against the plain
    attention path's on the weights cut to 2 layers, both passes routed
    alike (check_grads, GRAD_TOL).  Returns each run's launches."""
    import dataclasses

    from aule_tpu_torch.models import llama, moe

    log(card_line())
    cfg = dataclasses.replace(moe.MoEConfig.mixtral_8x7b(),
                              n_layers=MIXTRAL_LAYERS)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = moe.init_params(cfg, gen, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in llama._tensors(params))
    log(f"moe: Mixtral-8x7B dim {cfg.dim} layers {cfg.n_layers} of 32 heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} D{cfg.head_dim} hidden "
        f"{cfg.hidden_dim} experts {cfg.n_experts} top {cfg.top_k} vocab "
        f"{cfg.vocab_size} RoPE {cfg.rope_base:.0f} bf16: "
        f"{n_params / 1e9:.3f} B params ({2 * n_params / 1e9:.1f} GB), init "
        f"{time.perf_counter() - t0:.1f} s; memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    res = {"runs": {}}
    _serve(params, cfg, prompts, MOE_RUNS, res, model=moe,
           lora_run=MOE_LORA_RUN)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(1, MOE_GRAD_S + 1))).to(DEV)
    check_grads(params, cfg, tokens, model=moe, label="moe")
    log(f"moe: max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    return res


# AdamW on Llama-3-8B at full width, cut to 8 of its 32 layers: the 8
# layers hold 1.75 B parameters and the embedding and head 1.05 B; bf16
# params and grads take 4 B a parameter and the f32 moments and master 12
# B, about 45 GB in all (32 layers would need about 128 GB).
ADAMW_LAYERS = 8
ADAMW_BATCH = 2          # B2 x (TRAIN_S + 1) tokens a step
ADAMW_MICRO = 2          # in micro-batches of B1
ADAMW_PEAK_LR = 1e-4     # reached after ADAMW_WARMUP steps
ADAMW_WARMUP = 2
ADAMW_CHECK = dict(lr=1e-3, weight_decay=0.01)  # the card-vs-CPU check


def adamw_lr(count: int) -> float:
    """The warm-up schedule: linear to ADAMW_PEAK_LR over ADAMW_WARMUP
    steps, then flat."""
    return ADAMW_PEAK_LR * min(1.0, count / ADAMW_WARMUP)


def _adamw_card_vs_cpu(params) -> dict:
    """The AdamW update applied to one fixed set of gradients on the card
    and on the CPU: layer 0's wq, wk and attention norm (bf16 and f32
    leaves, 21 M parameters) with an f32 master, two steps of a stand-in
    model whose loss is sum(p * G) (gradient G, seeded); every leaf of the
    params, mu, nu and master within 1e-6 of the leaf's largest value.  No
    clipping here: the global norm sums in another order on each device,
    and a clip scale one f32 step apart moves every value by a step."""
    import types

    from aule_tpu_torch.parallel import optimizer
    from aule_tpu_torch.utils.tree import tree_flatten

    layer = params["layers"][0]
    small = {k: layer[k].detach() for k in ("wq", "wk", "attn_norm")}
    cpu_gen = torch.Generator().manual_seed(SEED + 16)
    grads = {k: 0.05 * torch.randn(v.shape, generator=cpu_gen)
             for k, v in small.items()}
    out = {}
    for dev in (DEV, "cpu"):
        p = {k: v.to(dev, copy=True) for k, v in small.items()}
        g = {k: v.to(dev) for k, v in grads.items()}

        def loss_fn(params, tokens, cfg, g=g):
            return sum((params[k].float() * g[k]).sum() for k in sorted(g))

        step = optimizer.make_adamw_train_step(
            types.SimpleNamespace(loss_fn=loss_fn), None, **ADAMW_CHECK)
        opt = optimizer.adamw_init(p, master_weights=True)
        for _ in range(2):
            p, opt, _ = step(p, opt, None)
        out[dev] = {"params": p, "mu": opt.mu, "nu": opt.nu,
                    "master": opt.master}
    worst, differ, n = 0.0, 0, 0
    for part in ("params", "mu", "nu", "master"):
        for a, b in zip(tree_flatten(out[DEV][part]),
                        tree_flatten(out["cpu"][part])):
            a, b = a.detach().cpu().float(), b.detach().float()
            size = float(b.abs().max())
            err = float((a - b).abs().max())
            worst = max(worst, err / size)
            differ += int((a != b).sum())
            n += a.numel()
            if err > 1e-6 * size:
                raise AssertionError(f"AdamW card vs CPU: {part} differs by "
                                     f"{err:.3e} (> 1e-6 of {size:.3e})")
    log(f"adamw update card vs CPU (layer 0 wq, wk, attn_norm; 2 steps, "
        f"lr {ADAMW_CHECK['lr']}, weight decay "
        f"{ADAMW_CHECK['weight_decay']}, f32 master): largest difference "
        f"{worst:.3e} of a leaf's size (<= 1e-6); {differ} of {n} values "
        f"differ in any bit")
    return dict(worst_rel=worst, values_differ=differ, values=n)


def check_adamw() -> dict:
    """make_adamw_train_step(llama, cfg, lr=adamw_lr, clip_norm=1.0,
    micro_batches=ADAMW_MICRO) with adamw_init(master_weights=True) on
    Llama-3-8B at full width on ADAMW_LAYERS layers (random bf16 weights
    from SEED on the card), 3 steps on one batch of ADAMW_BATCH x (TRAIN_S +
    1) tokens: every micro-batch launches the forward, delta, dQ and dK/dV
    kernels once a layer (asserted), the loss falls at every step, step 2
    is timed (CUDA events: tokens/s, share of the bf16 peak) beside
    max_memory_allocated; then the update card vs CPU
    (_adamw_card_vs_cpu).  Returns the kernels' launches a step."""
    import dataclasses

    from aule_tpu_torch.models import llama
    from aule_tpu_torch.ops.flash import flash_fwd_tma
    from aule_tpu_torch.ops.flash_vjp import (attention_delta, flash_bwd_dkv,
                                              flash_bwd_dq)
    from aule_tpu_torch.parallel import optimizer
    from aule_tpu_torch.utils import profiling

    log(card_line())
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=ADAMW_LAYERS)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    params = llama.init_params(cfg, gen, device=DEV)
    opt = optimizer.adamw_init(params, master_weights=True)
    tensors = list(llama._tensors(params))
    n_params = sum(t.numel() for t in tensors)
    torch.cuda.synchronize()
    log(f"adamw: Llama-3-8B dim {cfg.dim} layers {cfg.n_layers} of 32, bf16 "
        f"params with f32 moments and master: {n_params / 1e9:.3f} B "
        f"params; memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    step = optimizer.make_adamw_train_step(
        llama, cfg, lr=adamw_lr, clip_norm=1.0, micro_batches=ADAMW_MICRO)
    rng = np.random.default_rng(SEED + 3)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(ADAMW_BATCH, TRAIN_S + 1))).to(DEV)
    counters = {"flash_fwd": flash_fwd_tma, "flash_bwd_delta": attention_delta,
                "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv}
    matmul_params = sum(t.numel() for t in tensors if t.dim() == 2) \
        - params["embed"].numel()  # the embedding is a gather
    n_tok = ADAMW_BATCH * TRAIN_S
    flops = profiling.train_step_flops(
        matmul_params, n_tok, cfg.n_layers * profiling.attention_flops(
            ADAMW_BATCH, cfg.n_heads, TRAIN_S, TRAIN_S, cfg.head_dim,
            causal=True))
    want = {n: ADAMW_MICRO * cfg.n_layers for n in counters}
    losses, launches, times = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        for fn in counters.values():
            fn.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, loss = step(params, opt, tokens)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(loss))
        launches.append({n: fn.launches for n, fn in counters.items()})
        log(f"adamw step {i + 1}: loss {losses[-1]:.6f} (lr "
            f"{adamw_lr(i + 1):.3g}), {times[-1]:.2f} ms; launches "
            f"{launches[-1]}")
        if launches[-1] != want:
            raise AssertionError(f"adamw step {i + 1}: launches "
                                 f"{launches[-1]} != {ADAMW_MICRO} "
                                 f"micro-batches x {cfg.n_layers} layers")
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        losses.append(float(llama.loss_fn(params, tokens[:1], cfg) +
                            llama.loss_fn(params, tokens[1:], cfg)) / 2)
    log(f"adamw: loss after 3 steps {losses[-1]:.6f}")
    if not (all(math.isfinite(x) for x in losses)
            and all(a > b for a, b in zip(losses, losses[1:]))):
        raise AssertionError(f"adamw: the loss did not fall at every step: "
                             f"{losses}")
    ms = times[1]
    log(f"adamw: dim {cfg.dim}, {cfg.n_layers} layers, B{ADAMW_BATCH} "
        f"S{TRAIN_S} in {ADAMW_MICRO} micro-batches, bf16 with an f32 "
        f"master, clip 1.0: step 2 {ms:.2f} ms (CUDA events), "
        f"{n_tok / ms * 1e3:.0f} tokens/s, {flops / 1e12:.2f} TFLOP a step "
        f"= {flops / ms / 1e9:.1f} TFLOP/s, "
        f"{100 * flops / ms / 1e9 / 989:.1f} % of the 989 TFLOP/s bf16 peak; "
        f"max memory allocated {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)")
    res = {"launches": {n: [x[n] for x in launches] for n in counters},
           "losses": losses, "step_ms": ms, "tokens_per_s": n_tok / ms * 1e3,
           "peak_share": flops / ms / 1e9 / 989, "max_memory_gb": peak / 1e9}
    res["card_vs_cpu"] = _adamw_card_vs_cpu(params)
    del params, opt
    torch.cuda.empty_cache()
    return res


# The spec phase: speculative decoding on Llama-3-8B, in a process of its
# own (`python3 chip_smoke.py --spec`).  The 12 prompts of PROMPT_LENS,
# SPEC_NEW_TOKENS each, over ENGINE_KW with SPEC_PAGES pages: the requests
# hold at most 887 pages at once, and run (s1)'s resume file carries the
# target's and the draft's pools (2 x 2.1 GB at 1,024 pages).
SPEC_SEED = SEED + 20       # the kernel checks' generator, and (s2)'s draft
SPEC_NEW_TOKENS = 32
SPEC_K = 4
SPEC_PAGES = 1024
SPEC_KW = dict(ENGINE_KW, num_pages=SPEC_PAGES)
SPEC_TEMP = 0.8
SPEC_SPAN = 64               # (s3)'s prompts repeat a span of this length
# Llama-3.2-1B's shape (meta-llama/Llama-3.2-1B config.json), cut as
# LLAMA32_3B is: an untied head and plain RoPE (no llama3 frequency
# scaling); its weights come from the seed DRAFT_SEED
LLAMA32_1B = dict(vocab_size=128256, dim=2048, n_layers=16, n_heads=32,
                  n_kv_heads=8, hidden_dim=8192, rope_base=500000.0,
                  norm_eps=1e-5)
DRAFT_SEED = SEED + 1
# JAX's chip floors (tests/test_speculative.py:444-474): the greedy-prefix
# match of a self-draft run against plain greedy, and its acceptance
SPEC_MIN_MATCH = 0.95
SPEC_MIN_ACCEPT = 0.85
# (s2) turns speculation off after 8 rounds under this acceptance
SPEC_S2_MIN_ACCEPT = 0.3
SPEC_COUNTERS = ("paged_prefill", "paged_decode", "flash_fwd",
                 "flash_fwd_short", "flash_fwd_decode", "flash_fwd_f32")


def _spec_prefill_check(gen, res, key, d, hist, chunk, modes, timed):
    """The paged prefill (csrc/paged_prefill.cu) at a speculative round's
    shape: B = len(hist) sequences of chunk[b] queries at q_offset hist[b]
    (0 queries: an empty slot; 1: a slot that verifies its pending token
    alone), Hq32/Hkv8 D`d`, 16-token pages in shuffled 272-entry tables.
    Each (mode, payload dtype or None) of `modes` twice with the same bits
    and held to its plain version (ROW_TOL, LSE_TOL; rows past a
    sequence's queries exact zeros); with `timed` (every hist equal) its
    times beside its bound, its plain version and SDPA on the gathered
    (dequantized) K/V with a positional mask, GQA expanded."""
    from aule_tpu_torch.ops.paged_fused import (dequantize_pool,
                                                from_fused_layout)
    from aule_tpu_torch.ops.paged_prefill import (
        paged_attention_prefill, paged_attention_prefill_plain)
    from aule_tpu_torch.ops.reference import _gather_pages, build_mask
    from aule_tpu_torch.utils import profiling

    hq, hkv, batch, s = 32, 8, len(hist), max(chunk)
    total = [h + c for h, c in zip(hist, chunk)]
    pool, bt = _generic_pool(gen, total, 272, 16, hkv, d, torch.bfloat16,
                             True)
    q = _randn((batch, hq, s, d), gen)
    ln = torch.tensor(total, dtype=torch.int32, device=DEV)
    qoff = torch.tensor(hist, dtype=torch.int32, device=DEV)
    shape = (f"B{batch} x {s} queries over {min(total)}-{max(total)} "
             f"Hq{hq}/Hkv{hkv} D{d} page16")
    for name, qdt in modes:
        pl, sc = _gen_quantized(pool, qdt)
        kw = dict(q_offsets=qoff, kv_scales=sc)
        kernel = (lambda **x: paged_attention_prefill(q, pl, bt, ln, **kw,
                                                      **x))
        plain = (lambda **x: paged_attention_prefill_plain(q, pl, bt, ln,
                                                           **kw, **x))
        what = f"spec {key} {name} {shape}"
        o, lse = _twice(what, lambda: kernel(return_lse=True))
        po, plse = plain(return_lse=True)
        res["err"][f"{key} {name}"] = hold(what, o, po, lse, plse,
                                           ROW_TOL[torch.bfloat16])
        del o, lse, po, plse
        if not timed:
            continue
        k, v = (from_fused_layout(pl, d) if qdt is None
                else dequantize_pool(pl, sc, d))
        kd, vd = (_gather_pages(x, bt).to(torch.bfloat16).repeat_interleave(
            hq // hkv, dim=1) for x in (k, v))
        mask = build_mask(s, kd.shape[2], True, device=DEV,
                          q_offset=hist[0])
        payload = 2 if qdt is None else 1
        nbytes = (2 * q.numel() * 2 + profiling.paged_kv_bytes(
            sum(total), hkv, d, payload, 0 if qdt is None else 2)
            + batch * 272 * 4 + 2 * batch * 4)
        res["time"][f"{key} {name}"] = _mode_time(
            f"spec {key} time {name} {shape}", kernel, plain,
            lambda: SDPA(q, kd, vd, attn_mask=mask), "paged_prefill_kernel",
            nbytes, profiling.paged_prefill_flops(hist, chunk, hq, d),
            profiling.H100_BF16_FLOPS)
        del kd, vd, k, v
    del pool, q
    torch.cuda.empty_cache()


def _spec_decode_check(gen, res):
    """The draft's decode (csrc/paged_decode.cu at D64 group 4: Hq32/Hkv8,
    Llama-3.2-1B's heads) at B8 ctx4096 page 16 over bf16, int8 (dot
    products) and e4m3 pools with bf16 scales: twice with the same bits,
    held to its plain version, then timed (_decode_mode_times: device
    time beside its bound, its plain version and SDPA)."""
    from aule_tpu_torch.ops.paged_fused import (paged_attention_fused,
                                                paged_attention_fused_plain)

    lens = [4096] * 8
    pool, bt = _generic_pool(gen, lens, 272, 16, 8, 64, torch.bfloat16, True)
    ln = torch.tensor(lens, dtype=torch.int32, device=DEV)
    q = _randn((8, 32, 64), gen)
    modes = [("bf16", torch.bfloat16, None, None, torch.bfloat16),
             ("int8 dot", torch.bfloat16, torch.int8, True, torch.bfloat16),
             ("fp8", torch.bfloat16, torch.float8_e4m3fn, None,
              torch.bfloat16)]
    for mode in modes:
        name, _, qdt, dot, _ = mode
        pl, sc = _gen_quantized(pool, qdt)
        kw = dict(kv_scales=sc, int8_matmul=dot)
        what = f"spec draft decode {name} B8 ctx4096 Hq32/Hkv8 D64 page16"
        o, lse = _twice(what, lambda: paged_attention_fused(
            q, pl, bt, ln, return_lse=True, **kw))
        po, plse = paged_attention_fused_plain(q, pl, bt, ln,
                                               return_lse=True, **kw)
        res["err"][f"draft decode {name}"] = hold(
            what, o, po, lse, plse, _tol(torch.bfloat16, bool(dot)))
        del o, lse, po, plse
        _decode_mode_times(gen, res, "draft ", mode, lens, (32, 8, 64), 272,
                           False)
    del pool, q
    torch.cuda.empty_cache()


def _spec_flash_check(gen, res):
    """The draft's whole-prompt prefill: csrc/flash_fwd.cu's TMA kernel at
    D64 group 4 (B1 Hq32/Hkv8, causal) at S2048 (timed beside its bound,
    its plain version and SDPA on GQA-expanded K/V) and S1000 (ragged
    tiles), twice with the same bits, held to its plain version."""
    from aule_tpu_torch.ops.flash import (flash_attention_fwd_plain,
                                          flash_fwd_tma)
    from aule_tpu_torch.utils import profiling

    for s in (2048, 1000):
        q = _randn((1, 32, s, 64), gen)
        k, v = (_randn((1, 8, s, 64), gen) for _ in range(2))
        what = f"spec draft flash fwd B1 Hq32/Hkv8 S{s} D64 bf16 causal"
        kernel = lambda **x: flash_fwd_tma(q, k, v, causal=True, **x)
        plain = lambda: flash_attention_fwd_plain(q, k, v, causal=True)
        o, lse = _twice(what, kernel)
        po, plse = plain()
        res["err"][f"flash d64 S{s}"] = hold(what, o, po, lse, plse,
                                             ROW_TOL[torch.bfloat16])
        del o, lse, po, plse
        if s == 2048:
            kx, vx = (x.repeat_interleave(4, dim=1) for x in (k, v))
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * 32 * s
            res["time"]["flash d64"] = _mode_time(
                f"spec draft flash fwd time B1 Hq32/Hkv8 S{s} D64 bf16 "
                f"causal", lambda: kernel(return_lse=False),
                lambda: plain()[0],
                lambda: SDPA(q, kx, vx, is_causal=True), "flash_fwd_kernel",
                nbytes, profiling.attention_flops(1, 32, s, s, 64, True),
                profiling.H100_BF16_FLOPS)
            del kx, vx
        del q, k, v


def _spec_kernel_checks(res) -> None:
    """The kernels at the shapes speculation gives them (a generator of
    its own): the verify's prefill at B8 x (K+1) queries, D128 group 4,
    over contexts near 4096 (timed) and ragged (slots of K+1, 1 and 0
    queries), in bf16, int8 and e4m3 pools; the draft's catch-up prefill
    at D64 group 4 the same way; the draft's decode at D64 group 4, B8
    ctx4096; the draft's whole-prompt flash forward at D64 group 4."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SPEC_SEED)
    modes = (("bf16", None), ("int8", torch.int8),
             ("fp8", torch.float8_e4m3fn))
    k1 = SPEC_K + 1
    ragged_hist = [4091, 3000, 4095, 0, 17, 2048, 4000, 1]
    ragged_chunk = [k1, k1, 1, 0, k1, 1, k1, k1]
    for key, d in (("verify", 128), ("draft prefill", 64)):
        _spec_prefill_check(gen, res, key, d, [4096 - k1] * 8, [k1] * 8,
                            modes, True)
        _spec_prefill_check(gen, res, key + " ragged", d, ragged_hist,
                            ragged_chunk, modes, False)
    _spec_decode_check(gen, res)
    _spec_flash_check(gen, res)


class _SpecSpy:
    """The launch counts of a speculative engine's run, by where they
    happen: spies on the engine's methods read the counters
    (_launch_counters, SPEC_COUNTERS) before and after each call.  Buckets:
    the target's and the draft's prompt prefill (whole or chunks, lag
    catch-up chunks included), plain decode dispatches, and per round the
    target's verify and the draft's part (the round less its verify)."""

    def __init__(self, eng):
        import inspect

        self.counters = {k: v for k, v in _launch_counters().items()
                         if k in SPEC_COUNTERS}
        self.buckets = {}
        self.rounds = []
        self._verify = None

        def snap():
            return {k: fn.launches for k, fn in self.counters.items()}

        def delta(a, b):
            return {k: b[k] - a[k] for k in a}

        def add(bucket, d):
            acc = self.buckets.setdefault(bucket, dict.fromkeys(d, 0))
            for k, n in d.items():
                acc[k] += n

        def wrap(name, bucket_of):
            orig = getattr(eng, name)
            sig = inspect.signature(orig)

            def spy(*a, **k):
                before = snap()
                out = orig(*a, **k)
                bucket_of(sig.bind(*a, **k).arguments, delta(before, snap()))
                return out

            setattr(eng, name, spy)

        def prefill(args, d):
            add("draft prefill" if args.get("draft") else "target prefill",
                d)

        def verify(args, d):
            self._verify = d
            add("verify", d)

        def round_(args, d):
            target = self._verify
            draft = {k: d[k] - target[k] for k in d}
            self.rounds.append(dict(draft=draft, target=target))
            add("round draft", draft)

        def ngram(args, d):
            if self._verify is not None:
                self.rounds.append(dict(draft=None, target=self._verify))

        def decode(args, d):
            add("decode", d)

        wrap("_prefill", prefill)
        wrap("_prefill_chunk", prefill)
        wrap("_verify_chunk", verify)
        wrap("_spec_round", round_)
        wrap("_decode_all", decode)
        orig_ngram = eng._ngram_all

        def ngram_spy(caps):
            self._verify = None
            fired = orig_ngram(caps)
            ngram(None, None)
            return fired

        eng._ngram_all = ngram_spy
        self.eng = eng

    def detach(self):
        for name in ("_prefill", "_prefill_chunk", "_verify_chunk",
                     "_spec_round", "_decode_all", "_ngram_all"):
            self.eng.__dict__.pop(name, None)
        self.eng = None


def _spec_launch_checks(label, spy, eng, cfg, dcfg, prompts, totals):
    """Every round launched the target's paged prefill once a layer and
    no decode, the draft's paged prefill once a layer and its decode K-1
    times a layer; plain dispatches the decode once a layer a step; the
    prompts' prefill as run_engine's rule has it; and the buckets add up
    to the counters (no launch outside them)."""
    from aule_tpu_torch.ops.flash import forward_kernel

    st = eng.stats()
    lt = cfg.n_layers
    zero = dict.fromkeys(SPEC_COUNTERS, 0)
    for i, r in enumerate(spy.rounds):
        if r["target"] != dict(zero, paged_prefill=lt):
            raise AssertionError(f"{label}: round {i} launched {r['target']} "
                                 f"in the verify, not {lt} paged prefills")
        if r["draft"] is not None:
            ld = dcfg.n_layers
            want = dict(zero, paged_prefill=ld,
                        paged_decode=ld * (eng.spec_tokens - 1))
            if r["draft"] != want:
                raise AssertionError(f"{label}: round {i}'s draft launched "
                                     f"{r['draft']}, not {want}")
    speculates = eng.spec_tokens > 0 or eng.ngram_spec > 0
    if len(spy.rounds) != st["spec_rounds"] or (speculates
                                                and not spy.rounds):
        raise AssertionError(f"{label}: {len(spy.rounds)} rounds seen, "
                             f"{st['spec_rounds']} counted")
    b = spy.buckets
    want_decode = dict(zero, paged_decode=st["decode_steps"] * lt)
    if b.get("decode", zero) != want_decode:
        raise AssertionError(f"{label}: plain decode launched "
                             f"{b.get('decode')}, not {want_decode}")

    def prefill_want(c, n_disp, lens):
        if eng.prefill_chunk is not None:
            return dict(zero, paged_prefill=n_disp * c.n_layers)
        want = dict(zero)
        for n in lens:
            q = torch.empty(1, 1, n, c.head_dim, dtype=c.dtype,
                            device="meta")
            name = next(k for k in SPEC_COUNTERS
                        if spy.counters[k] is forward_kernel(q))
            want[name] += c.n_layers
        # a lagging draft pool catches up in chunks through the prefill
        want["paged_prefill"] += (n_disp - len(lens)) * c.n_layers
        return want

    lens = [len(p) for p in prompts]
    checks = [("target prefill", prefill_want(cfg, st["prefill_dispatches"],
                                              lens))]
    if dcfg is not None:
        checks.append(("draft prefill", prefill_want(
            dcfg, st["draft_prefill_dispatches"], lens)))
    for bucket, want in checks:
        if b.get(bucket, zero) != want:
            raise AssertionError(f"{label}: {bucket} launched "
                                 f"{b.get(bucket)}, not {want}")
    added = dict(zero)
    for d in b.values():
        for k, n in d.items():
            added[k] += n
    if added != totals:
        raise AssertionError(f"{label}: the buckets add to {added}, the "
                             f"counters read {totals}")


def run_spec_engine(params, cfg, prompts, label, submit_kw, resume=None,
                    **kw):
    """Serve the prompts (SPEC_NEW_TOKENS each, per-request options
    `submit_kw`) through a fresh ServingEngine(**SPEC_KW, **kw) on the
    card; the launch counts are set to 0 just before the run and read just
    after, and held by _spec_launch_checks round by round.  Checks the
    native allocator, that every request finished and every page came
    back; logs stats().  With `resume` (a dict), the engine is saved after
    its first round (save_engine_state, a temporary directory; the save is
    not timed), a fresh engine loads it and finishes, and resume gets
    both runs' outputs and the file's size and times."""
    import tempfile

    from aule_tpu_torch.serving.engine import (ServingEngine,
                                               load_engine_state,
                                               save_engine_state)
    from aule_tpu_torch.serving.native import NativePageAllocator

    def engine():
        return ServingEngine(params, cfg, device=DEV, **SPEC_KW, **kw)

    eng = engine()
    if not isinstance(eng.allocator, NativePageAllocator):
        raise AssertionError(f"{label}: the engine runs on "
                             f"{type(eng.allocator).__name__}, not the native "
                             f"allocator")
    for p, skw in zip(prompts, submit_kw):
        eng.submit(p, SPEC_NEW_TOKENS, **skw)
    spy = _SpecSpy(eng)
    for fn in spy.counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_save, tmp = 0.0, None
    while eng.has_work():
        eng.step()
        if resume is not None and tmp is None and eng.spec_rounds >= 1:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            tmp = tempfile.TemporaryDirectory()
            path = os.path.join(tmp.name, "engine")
            save_engine_state(eng, path)
            t_save = time.perf_counter() - ts
            resume.update(rounds_at_save=eng.spec_rounds,
                          file_gb=sum(os.path.getsize(os.path.join(
                              tmp.name, f)) for f in os.listdir(tmp.name))
                          / 1e9, save_s=t_save)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - t_save
    totals = {k: fn.launches for k, fn in spy.counters.items()}
    done = sorted(eng.finished, key=lambda r: r.req_id)
    eng.finished = []
    spy.detach()
    st = eng.stats()
    n_req = len(prompts)
    decode_tokens = st["tokens_generated"] - n_req
    log(f"spec {label}: {len(done)} requests in {wall:.2f} s; prefill "
        f"{st['prefill_seconds']:.3f} s ({st['prefill_dispatches']} target "
        f"+ {st['draft_prefill_dispatches']} draft dispatches, "
        f"{sum(len(p) for p in prompts) / st['prefill_seconds']:.0f} prompt "
        f"tok/s); decode {st['decode_seconds']:.3f} s: "
        f"{st['spec_rounds']} rounds + {st['decode_dispatches']} plain "
        f"dispatches ({st['decode_steps']} steps), {decode_tokens} tokens, "
        f"{decode_tokens / st['decode_seconds']:.1f} tok/s; acceptance "
        f"{st['spec_accepted']} / {st['spec_drafted']}")
    log(f"spec {label}: stats() {st}")
    parts = {k: {n: c for n, c in v.items() if c}
             for k, v in spy.buckets.items()}
    log(f"spec {label}: launches {totals}; by part {parts}")
    if len(done) != n_req or any(
            not 0 < len(r.output) <= SPEC_NEW_TOKENS
            or (len(r.output) < SPEC_NEW_TOKENS and not r.stop
                and r.eos_id is None) for r in done):
        raise AssertionError(f"{label}: not every request finished")
    _spec_launch_checks(label, spy, eng, cfg, eng.draft_cfg, prompts,
                        totals)
    if st["free_pages"] != SPEC_PAGES - 1:
        raise AssertionError(f"{label}: pages leaked: {st['free_pages']} "
                             f"free")
    outputs = [list(r.output) for r in done]
    if resume is not None:
        if tmp is None:
            raise AssertionError(f"{label}: no round ran to save after")
        del eng
        torch.cuda.empty_cache()
        fresh = engine()
        t1 = time.perf_counter()
        load_engine_state(fresh, path)
        torch.cuda.synchronize()
        resume["load_s"] = time.perf_counter() - t1
        tmp.cleanup()
        resume["outputs"] = [list(r.output) for r in fresh.run()]
        if fresh.allocator.num_free != SPEC_PAGES - 1:
            raise AssertionError(f"{label}: the resumed engine leaked pages")
        del fresh
    else:
        del eng
    torch.cuda.empty_cache()
    # a layer pass launches one attention kernel: the decode side's
    # passes (rounds and plain dispatches) per decode token of the batch
    passes = sum(sum(spy.buckets.get(b, {}).values())
                 for b in ("verify", "round draft", "decode"))
    run = dict(stats=st, wall_s=wall, launches=totals,
               buckets=spy.buckets, rounds=len(spy.rounds),
               decode_tok_s=decode_tokens / st["decode_seconds"],
               layer_passes_per_decode_token=passes / max(decode_tokens, 1))
    return outputs, run


def _prefix_match(got, want):
    """JAX's greedy-prefix match (tests/test_speculative.py:458-465): each
    pair compared up to its first mismatch, which counts; the share of the
    compared tokens that agree, and each pair's first mismatch (None when
    they agree throughout)."""
    same = total = 0
    first = []
    for g, w in zip(got, want):
        at = None
        for j, (a, b) in enumerate(zip(g, w)):
            total += 1
            if a != b:
                at = j
                break
            same += 1
        first.append(at)
    return same / max(total, 1), same, total, first


def _divergence_gaps(params, cfg, prompts, got, want, first):
    """At each pair's first mismatch j: the plain forward (flash's plain
    version) over prompt + the shared tokens, and how far below its max
    logit each run's token j lies.  Two runs that read the same weights
    through different kernels may part only at a near-tie (both within
    NEAR_TIE of the max)."""
    from aule_tpu_torch.models import llama
    from aule_tpu_torch.ops.flash_vjp import flash_attention_vjp_plain

    gaps = []
    with torch.no_grad():
        for p, g, w, j in zip(prompts, got, want, first):
            if j is None:
                continue
            seq = np.concatenate([p, np.asarray(w[:j], np.int32)])
            tokens = torch.from_numpy(seq.astype(np.int64))[None].to(DEV)
            row = llama.forward(params, tokens, cfg,
                                attention=flash_attention_vjp_plain)[0][-1]
            top = float(row.max())
            gaps.append((top - float(row[g[j]]), top - float(row[w[j]])))
            del row
    return gaps


def _spec_round_profile(params, cfg, prompts, res) -> None:
    """One round of (s1)'s configuration under torch.profiler: the first 8
    prompts, prefilled, then one engine step profiled.  Kernels, device
    busy share and tokens emitted per profiled step.  (The plain dispatch
    and (s3)'s round are not profiled here, for the script's time limit;
    the breakdown phase profiles a plain dispatch.)"""
    from aule_tpu_torch.serving.engine import ServingEngine
    from aule_tpu_torch.utils import profiling

    eng = ServingEngine(params, cfg, device=DEV, prefill_chunk=CHUNK,
                        draft_params=params, draft_cfg=cfg,
                        spec_tokens=SPEC_K, **SPEC_KW)
    for p in prompts[:8]:
        eng.submit(p, SPEC_NEW_TOKENS)
    eng._admit()
    bd = None
    while eng.has_work() and bd is None:
        n0, r0 = eng.tokens_generated, eng.spec_rounds
        got = profiling.device_breakdown(eng.step, CATEGORIES)
        if eng.spec_rounds > r0:
            bd, emitted = got, eng.tokens_generated - n0
    what = "one (s1) self-draft round, K=4"
    if bd is None:
        log(f"spec breakdown {what}: no step to profile (not measured)")
        res["profile"]["s1"] = None
    else:
        _log_breakdown(f"spec {what}, B8, {emitted} tokens", bd)
        res["profile"]["s1"] = dict(
            wall_ms=bd["wall_ms"], busy_ms=bd["busy_ms"],
            busy_share=bd["busy_ms"] / bd["wall_ms"],
            kernels=bd["kernels"], tokens=emitted,
            ms_per_token=bd["wall_ms"] / max(emitted, 1))
    eng.run()
    del eng
    torch.cuda.empty_cache()


GPT2_SPEC_NEW = NEW_TOKENS   # GPT2_PROMPT_LENS end at 1000: within n_ctx


def _spec_gpt2_f32(res, held) -> None:
    """JAX's greedy-prefix floor on the path without near-ties: GPT-2
    small in f32 (random weights from SEED) serves GPT2_PROMPT_LENS
    greedy, GPT2_SPEC_NEW tokens each, prefill_chunk 256, (s4) plain and
    (s5) self-draft K=4.  (s5)'s raw greedy-prefix match against (s4),
    with no near-tie credit, must reach SPEC_MIN_MATCH (JAX
    tests/test_speculative.py:444-474); (s5)'s tokens are held to the
    teacher-forced plain forward within GPT2_F32_NEAR_TIE.  The bf16
    Llama run's figure counting near-tie partings as agreeing (`held`)
    is logged beside it."""
    from aule_tpu_torch.models import gpt2
    from aule_tpu_torch.serving.engine import ServingEngine

    cfg = gpt2.GPT2Config()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    params = gpt2.init_params(cfg, gen, device=DEV)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in GPT2_PROMPT_LENS]
    outs, stats = {}, {}
    for key, kw in (("s4", {}), ("s5", dict(draft_params=params,
                                            draft_cfg=cfg,
                                            spec_tokens=SPEC_K))):
        eng = ServingEngine(params, cfg, model=gpt2, device=DEV,
                            prefill_chunk=GPT2_CHUNK, **GPT2_ENGINE_KW, **kw)
        for p in prompts:
            eng.submit(p, GPT2_SPEC_NEW)
        outs[key] = [list(r.output) for r in eng.run()]
        stats[key] = eng.stats()
        del eng
    match, same, total, first = _prefix_match(outs["s5"], outs["s4"])
    st = stats["s5"]
    acc = st["spec_accepted"] / max(st["spec_drafted"], 1)
    log(f"spec (s5) GPT-2 small f32 self-draft K=4 chunk 256: raw "
        f"greedy-prefix match against (s4) plain {match:.4f} ({same} of "
        f"{total} compared tokens; {sum(f is not None for f in first)} of "
        f"{len(first)} requests part), no near-tie credit (floor "
        f"{SPEC_MIN_MATCH}); acceptance {acc:.4f} over {st['spec_rounds']} "
        f"rounds; beside it the bf16 Llama-3-8B run (s1) counting near-tie "
        f"partings as agreeing: {held:.4f}")
    check_plain_forward(params, cfg, prompts, outs["s5"], "(s5)", model=gpt2,
                        tie=GPT2_F32_NEAR_TIE)
    if match < SPEC_MIN_MATCH:
        raise AssertionError(f"(s5): raw greedy-prefix match {match:.4f} "
                             f"under JAX's floor {SPEC_MIN_MATCH}")
    res["runs"]["s5"] = dict(prefix_match=match, compared=total,
                             acceptance=acc, stats=st)
    del params
    torch.cuda.empty_cache()



def check_spec() -> dict:
    """The spec phase: the kernels at speculation's shapes
    (_spec_kernel_checks), then a full-width Llama-3-8B on ENGINE_LAYERS
    of its 32 layers (random bf16 weights from SEED) serving the 12 prompts of PROMPT_LENS,
    SPEC_NEW_TOKENS each: (s0) plain bf16 chunk 512, the yardstick; (s1)
    self-draft K=4 bf16 chunk 512, 4 requests sampled at SPEC_TEMP with
    top-p 0.9, saved after its first round and resumed by a fresh engine;
    (s2) a Llama-3.2-1B-shaped draft (LLAMA32_1B, random weights from
    DRAFT_SEED) K=4 over an int8 pool with whole-prompt prefill and
    spec_min_acceptance 0.3; (s3) prompt lookup K=4 bf16 chunk 512 over
    prompts that repeat a SPEC_SPAN-token span, half sampled at SPEC_TEMP
    with top-k 20.  Each run's launches checked round by round
    (_spec_launch_checks); greedy tokens held to a teacher-forced plain
    forward (bf16) or plain-attention replay (int8), sampled ones inside
    their top-p / top-k sets (_EdgeJudge); (s1)'s greedy-prefix match
    against (s0) and acceptance over JAX's chip floors, its resumed tokens
    equal; (s2) turned off after 8 rounds.  Then one round of (s1) and of
    (s3) under the profiler beside a plain dispatch."""
    from aule_tpu_torch.models import llama

    log(card_line())
    res = {"time": {}, "err": {}, "runs": {}, "profile": {}, "seconds": {}}
    clock = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        res["seconds"][part] = round(now - clock[0], 1)
        clock[0] = now

    _spec_kernel_checks(res)
    lap("kernels")
    # ENGINE_LAYERS of its 32 layers at full width: cut for the time limit
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=ENGINE_LAYERS)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    params = llama.init_params(cfg, gen, device=DEV)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    nreq = len(prompts)

    lap("init")
    out0, res["runs"]["s0"] = run_spec_engine(
        params, cfg, prompts, "(s0) plain bf16 chunk 512", [{}] * nreq,
        prefill_chunk=CHUNK)
    check_plain_forward(params, cfg, prompts, out0, "(s0)")
    lap("s0")

    sampled = set(range(1, nreq, 3))  # 4 of 12
    specs1 = [dict(temperature=SPEC_TEMP, top_p=0.9) if i in sampled else {}
              for i in range(nreq)]
    resume = {}
    out1, res["runs"]["s1"] = run_spec_engine(
        params, cfg, prompts, "(s1) self-draft K=4 bf16 chunk 512", specs1,
        resume=resume, prefill_chunk=CHUNK, draft_params=params,
        draft_cfg=cfg, spec_tokens=SPEC_K)
    check_plain_forward(params, cfg, prompts, out1, "(s1)",
                        edges=_EdgeJudge("(s1)", specs1))
    greedy = [i for i in range(nreq) if i not in sampled]
    match, same, total, first = _prefix_match([out1[i] for i in greedy],
                                              [out0[i] for i in greedy])
    gaps = _divergence_gaps(params, cfg, [prompts[i] for i in greedy],
                            [out1[i] for i in greedy],
                            [out0[i] for i in greedy], first)
    decisive = sum(max(gp) > NEAR_TIE for gp in gaps)
    # JAX's floor counts every parting; on random bf16 weights near-ties
    # are common (a few % of tokens, _Agreement), and two kernel paths
    # part at some of them: the floor holds the partings that are not
    # near-ties
    held = (same + len(gaps) - decisive) / max(total, 1)
    st1 = res["runs"]["s1"]["stats"]
    acc1 = st1["spec_accepted"] / max(st1["spec_drafted"], 1)
    log(f"spec (s1): greedy-prefix match against (s0) {match:.4f} ({same} "
        f"of {total} compared tokens); the runs part at "
        f"{len(gaps)} of {len(greedy)} greedy requests, {decisive} of them "
        f"not at a near-tie (gaps of the two tokens below the plain "
        f"forward's max: {[tuple(round(x, 4) for x in gp) for gp in gaps]}"
        f"); match counting near-tie partings as agreeing {held:.4f} "
        f"(floor {SPEC_MIN_MATCH}); acceptance {acc1:.4f} (floor "
        f"{SPEC_MIN_ACCEPT})")
    if held < SPEC_MIN_MATCH or acc1 < SPEC_MIN_ACCEPT:
        raise AssertionError("(s1): under JAX's chip floors")
    got = [resume["outputs"][i] for i in greedy]
    want = [out1[i] for i in greedy]
    if got != want:
        raise AssertionError(f"(s1) resumed: {_same(got, want)} greedy "
                             f"tokens equal the uninterrupted run's")
    sampled_same = sum(resume["outputs"][i] == out1[i] for i in sampled)
    log(f"spec (s1): saved after round {resume['rounds_at_save']} "
        f"({resume['file_gb']:.2f} GB in {resume['save_s']:.2f} s, loaded "
        f"in {resume['load_s']:.2f} s); the resumed engine's greedy tokens "
        f"equal the uninterrupted run's, and {sampled_same} of "
        f"{len(sampled)} sampled requests too")
    lap("s1")
    res["runs"]["s1"].update(prefix_match=match, partings=len(gaps),
                             decisive_partings=decisive,
                             prefix_match_near_ties_agree=held,
                             acceptance=acc1,
                             resume={k: v for k, v in resume.items()
                                     if k != "outputs"})

    dcfg = llama.LlamaConfig(**LLAMA32_1B)
    dgen = torch.Generator(device=DEV)
    dgen.manual_seed(DRAFT_SEED)
    dparams = llama.init_params(dcfg, dgen, device=DEV)
    out2, res["runs"]["s2"] = run_spec_engine(
        params, cfg, prompts, "(s2) Llama-3.2-1B-shaped draft K=4 int8 "
        "whole-prompt", [{}] * nreq, quantized=True,
        draft_params=dparams, draft_cfg=dcfg, spec_tokens=SPEC_K,
        spec_min_acceptance=SPEC_S2_MIN_ACCEPT)
    st2 = res["runs"]["s2"]["stats"]
    if not st2["spec_disabled"] or st2["spec_rounds"] != 8:
        raise AssertionError(f"(s2): speculation not turned off after 8 "
                             f"rounds: {st2}")
    check_replay(params, cfg, prompts, out2, "(s2)", torch.int8, None,
                 engine_kw=SPEC_KW, new_tokens=SPEC_NEW_TOKENS)
    del dparams
    torch.cuda.empty_cache()
    lap("s2")

    span = rng.integers(0, cfg.vocab_size, size=SPEC_SPAN).astype(np.int32)
    prompts3 = []
    for n in PROMPT_LENS:
        p = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        p[-min(n, SPEC_SPAN):] = span[:min(n, SPEC_SPAN)]
        if n >= 3 * SPEC_SPAN:
            p[n // 2 - SPEC_SPAN:n // 2] = span
        prompts3.append(p)
    specs3 = [dict(temperature=SPEC_TEMP, top_k=20) if i % 2 else {}
              for i in range(nreq)]
    out3, res["runs"]["s3"] = run_spec_engine(
        params, cfg, prompts3, "(s3) prompt lookup K=4 bf16 chunk 512",
        specs3, prefill_chunk=CHUNK, ngram_spec=SPEC_K)
    check_plain_forward(params, cfg, prompts3, out3, "(s3)",
                        edges=_EdgeJudge("(s3)", specs3))
    lap("s3")
    _spec_gpt2_f32(res, held)
    lap("s4-s5")
    _spec_round_profile(params, cfg, prompts, res)
    lap("profile")
    for key, run in res["runs"].items():
        if key == "s5":
            continue
        st = run["stats"]
        log(f"spec ({key}): decode {run['decode_tok_s']:.1f} tok/s, "
            f"{run['layer_passes_per_decode_token']:.2f} layer passes a "
            f"decode token, {st['spec_rounds']} rounds, acceptance "
            f"{st['spec_accepted']} / {st['spec_drafted']}")
    log(f"spec: seconds by part {res['seconds']}")
    del params
    torch.cuda.empty_cache()
    return res


PAR_SEED = SEED + 21          # the parallel phase's generators
PAR_HEADS = (32, 8)           # Llama-3-8B's attention: Hq32 / Hkv8, D128
PAR_WINDOW = 256
PAR_PAGE = 16
PAR_TP_LAYERS = 8             # the tensor-parallel engine's depth
PAR_TP_PROMPTS = PROMPT_LENS[:8]
PAR_TP_KW = dict(ENGINE_KW, num_pages=640)
PAR_SPEC_NEW = 16             # the short self-draft run: 2 requests
PAR_CTX = (None, None, "ctx", None)
PAR_REPL = (None, None, None, None)
PAR_HEADS_SPEC = ("data", "model", None, None)
# The strategies on the card: name -> (world, (mesh sizes, axis names),
# maker, its kwargs, inputs, in_specs, out_spec, gradients).  Inputs are
# ("flash", B, Hq, Hkv, Sq, Sk) or ("paged", layout, payload dtype, n_ctx)
# at B8 ctx4096 over 16-token pages striped over the ctx shards.
PAR_CASES = {
    "ring": (4, ((4,), ("ctx",)), "make_ring_attention", dict(causal=True),
             ("flash", 1, 32, 8, 8192, 8192), [PAR_CTX] * 3, PAR_CTX, False),
    "context": (4, ((4,), ("ctx",)), "make_context_parallel_attention", {},
                ("flash", 1, 32, 8, 2048, 8192),
                [PAR_REPL, PAR_CTX, PAR_CTX], PAR_REPL, False),
    "split_paged": (4, ((2, 2), ("model", "ctx")),
                    "make_sharded_paged_attention",
                    dict(data_axis=None, ctx_axis="ctx"),
                    ("paged", "split", None, 2),
                    [(None, "model", None), ("model", "ctx", None, None),
                     ("model", "ctx", None, None), (None, "ctx", None),
                     (None, "ctx")], (None, "model", None), False),
    "ring_grads": (2, ((2,), ("ctx",)), "make_ring_attention",
                   dict(causal=True), ("flash", 1, 32, 8, 4096, 4096),
                   [PAR_CTX] * 3, PAR_CTX, True),
    "ulysses": (2, ((2,), ("ctx",)), "make_ulysses_attention",
                dict(causal=True), ("flash", 1, 32, 8, 8192, 8192),
                [PAR_CTX] * 3, PAR_CTX, False),
    "ulysses_window": (2, ((2,), ("ctx",)), "make_ulysses_attention",
                       dict(causal=True, window_size=PAR_WINDOW),
                       ("flash", 1, 32, 8, 8192, 8192), [PAR_CTX] * 3,
                       PAR_CTX, False),
    "head": (2, ((1, 2), ("data", "model")), "make_head_parallel_attention",
             dict(causal=True), ("flash", 1, 32, 8, 4096, 4096),
             [PAR_HEADS_SPEC] * 3, PAR_HEADS_SPEC, False),
    "fused_int8": (2, ((2,), ("ctx",)), "make_sharded_paged_attention_fused",
                   dict(data_axis=None, ctx_axis="ctx", quantized=True),
                   ("paged", "fused", torch.int8, 2),
                   [(None, None, None), ("ctx", None, None, None, None),
                    (None, "ctx", None), (None, "ctx"), ("ctx", None, None)],
                   (None, None, None), False),
    "fused_fp8": (2, ((2,), ("ctx",)), "make_sharded_paged_attention_fused",
                  dict(data_axis=None, ctx_axis="ctx", quantized=True),
                  ("paged", "fused", torch.float8_e4m3fn, 2),
                  [(None, None, None), ("ctx", None, None, None, None),
                   (None, "ctx", None), (None, "ctx"), ("ctx", None, None)],
                  (None, None, None), False),
}
# the tensor-parallel engine's runs: name -> (engine kwargs, prompts, new
# tokens); the self-draft run's draft is the target, sharded the same way
PAR_TP_RUNS = {
    "p1": (dict(prefill_chunk=CHUNK), 8, NEW_TOKENS),
    "p2": (dict(prefill_chunk=CHUNK, quantized=True), 8, NEW_TOKENS),
    "p3": (dict(prefill_chunk=CHUNK, spec_tokens=SPEC_K), 2, PAR_SPEC_NEW),
}
PAR_TP_LABELS = {"p1": "bf16 chunk 512", "p2": "int8 chunk 512",
                 "p3": "self-draft K=4 bf16 chunk 512"}


def _par_counters():
    counters = dict(_launch_counters())
    counters.update({k: v for k, v in _public_counters().items()
                     if k.startswith("flash_bwd")})
    return counters


class _HopSpy:
    """The flash forward launches made inside each call of
    parallel/sharded.py's flash_attention_lse while the spy is in place,
    by the call's causal flag: the ring's diagonal hops (causal) and its
    full hops and context parallel's shard (non-causal).  A skipped hop
    calls no core and counts nowhere."""

    def __init__(self, counters):
        self.fwd = [c for k, c in counters.items()
                    if k.startswith("flash_fwd")]
        self.hops = {"diag": 0, "full": 0}

    def _launched(self):
        return sum(c.launches for c in self.fwd)

    def __enter__(self):
        from aule_tpu_torch.parallel import sharded

        self.real = real = sharded.flash_attention_lse

        def spy(*args, causal=False, **kw):
            before = self._launched()
            out = real(*args, causal=causal, **kw)
            self.hops["diag" if causal else "full"] += (self._launched()
                                                        - before)
            return out

        sharded.flash_attention_lse = spy
        return self

    def __exit__(self, *exc):
        from aule_tpu_torch.parallel import sharded

        sharded.flash_attention_lse = self.real
        return False


def _par_inputs(spec, seed):
    """A case's full inputs, the same on every rank (a generator seeded
    alike): q, k, v [B, H, S, D] bf16; or q [B, Hq, D] with pools of
    n_ctx shards of pages (page 0 of each scratch) holding B sequences of
    4,096 tokens striped page by page over the shards, per-shard tables
    and lengths [B, n_ctx, ...], and the same pages under one global table
    for the single-device call."""
    from aule_tpu_torch.ops.paged_fused import fused_pool_shape

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    if spec[0] == "flash":
        _, b, hq, hkv, sq, sk = spec
        return [_randn((b, hq, sq, 128), gen), _randn((b, hkv, sk, 128), gen),
                _randn((b, hkv, sk, 128), gen)], None
    _, layout, qdt, n_ctx = spec
    batch, ctx, hq, hkv = 8, 4096, *PAR_HEADS
    per_seq = ctx // PAR_PAGE
    local = 1 + batch * per_seq // n_ctx
    pool = _randn(fused_pool_shape(n_ctx * local, hkv, PAR_PAGE, 128), gen)
    bt = np.full((batch, n_ctx, per_seq // n_ctx), -1, np.int32)
    lens = np.zeros((batch, n_ctx), np.int32)
    gbt = np.zeros((batch, per_seq), np.int32)
    cursor = [1] * n_ctx
    for b in range(batch):
        for lp in range(per_seq):
            s = lp % n_ctx
            bt[b, s, lp // n_ctx] = cursor[s]
            gbt[b, lp] = s * local + cursor[s]
            lens[b, s] += PAR_PAGE
            cursor[s] += 1
    q = _randn((batch, hq, 128), gen)
    dev = "cuda"
    tables = [torch.from_numpy(bt).to(dev), torch.from_numpy(lens).to(dev)]
    full = [torch.from_numpy(gbt).to(dev),
            torch.full((batch,), ctx, dtype=torch.int32, device=dev)]
    if layout == "split":
        (k, v, _, _), _ = _split_pools(pool, None)
        return [q, k, v] + tables, [q, k, v] + full
    pl, sc = quantize_pool(pool, qdt)
    return [q, pl] + tables + [sc], [q, pl] + full + [sc]


def _par_single(name, full):
    """The single-device kernel call on a case's full tensors."""
    from aule_tpu_torch.ops.flash_vjp import flash_attention_vjp
    from aule_tpu_torch.ops.paged import paged_attention
    from aule_tpu_torch.ops.paged_fused import paged_attention_fused

    kind, kw = PAR_CASES[name][4], PAR_CASES[name][3]
    if kind[0] == "flash":
        return flash_attention_vjp(*full[:3], causal=kw.get("causal", False),
                                   window_size=kw.get("window_size", -1))
    if kind[1] == "split":
        return paged_attention(*full)
    return paged_attention_fused(*full[:4], kv_scales=full[4])


def _par_strategy(name, mesh, res, rank):
    """One strategy on this rank: its shards in, the counted call (the
    counts set to 0 just before and read just after; the flash forward's
    launches also by hop class, _HopSpy), three timed calls
    (CUDA events; the collectives' host seconds), the output all-gathered
    and, on rank 0, held to the single-device call on the full tensors
    (every row within ROW_TOL; the gradients' relative Frobenius error
    within GRAD_TOL)."""
    from aule_tpu_torch.parallel import collectives
    from aule_tpu_torch.parallel import mesh as pmesh
    from aule_tpu_torch.parallel import sharded
    from aule_tpu_torch.utils import profiling

    _, _, maker, kw, kind, in_specs, out_spec, grads = PAR_CASES[name]
    if kind[0] == "paged":  # one table a ctx shard
        kind = kind[:3] + (pmesh.axis_size(mesh, "ctx"),)
    args, full = _par_inputs(kind, PAR_SEED + len(res))
    full = full or args
    shards = [pmesh.shard(a, mesh, s) for a, s in zip(args, in_specs)]
    fn = getattr(sharded, maker)(mesh, **kw)
    do = None
    if grads:
        do = _randn(args[0].shape, torch.Generator(device="cuda")
                    .manual_seed(PAR_SEED), torch.bfloat16)
        for t in shards[:3]:
            t.requires_grad_(True)

    def call():
        out = fn(*shards)
        if grads:
            (out.float() * pmesh.shard(do, mesh, out_spec).float()).sum(
                ).backward()
        return out

    counters = _par_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    with _HopSpy(counters) as spy:
        out = call()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    got = pmesh.unshard(out.detach(), mesh, out_spec)
    # copies: the timed calls below accumulate into the shards' .grad
    got_grads = ([pmesh.unshard(t.grad, mesh, s).clone()
                  for t, s in zip(shards[:3], in_specs)] if grads else None)
    collectives.reset_stats()
    t0 = time.perf_counter()
    ms = profiling.cuda_time_ms(call, warmup=0, iters=3)
    wall = (time.perf_counter() - t0) / 3
    row = dict(launches=launches, hops=spy.hops, ms=ms[0],
               wall_ms=wall * 1e3,
               collective_ms=collectives.STATS["seconds"] / 3 * 1e3,
               collective_calls=collectives.STATS["calls"] // 3,
               collective_mbytes=collectives.STATS["bytes"] / 3 / 1e6)
    if rank == 0:
        ref_in = [t.detach().requires_grad_(grads) if i < 3 else t
                  for i, t in enumerate(full)]
        want = _par_single(name, ref_in)
        label = f"parallel {name}"
        row["err"] = hold(label, got, want, None, None,
                          _tol(torch.bfloat16, kind[2:3] == (torch.int8,)))
        if grads:
            (want.float() * do.float()).sum().backward()
            _frob(label, got_grads, [t.grad for t in ref_in[:3]])
        row["single_ms"] = profiling.cuda_time_ms(
            lambda: _par_single(name, full), iters=3)[0]
    res[name] = row


def _par_tp_engine(mesh, rank, res, cfg, params, prompts, runs):
    """The tensor-parallel engine's runs on this rank (every rank drives
    the same loop on the same requests): counts set to 0 just before each
    run and read just after, the collectives' host seconds, the decode's
    tok/s; rank 0 keeps the outputs."""
    from aule_tpu_torch.parallel import collectives
    from aule_tpu_torch.serving.engine import ServingEngine

    for key in runs:
        ekw, n_req, new = PAR_TP_RUNS[key]
        kw = dict(PAR_TP_KW, **ekw)
        if "spec_tokens" in ekw:
            kw.update(draft_params=params, draft_cfg=cfg)
        eng = ServingEngine(params, cfg, mesh=mesh, model_axis="model",
                            device=DEV, **kw)
        for p in prompts[:n_req]:
            eng.submit(p, new)
        counters = _par_counters()
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        collectives.reset_stats()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        res[key] = dict(
            launches={k: c.launches for k, c in counters.items()
                      if c.launches},
            wall_s=wall, stats=st,
            decode_tok_s=(st["tokens_generated"] - n_req)
            / max(st["decode_seconds"], 1e-9),
            collective_s=collectives.STATS["seconds"],
            collective_calls=collectives.STATS["calls"],
            outputs=[list(r.output) for r in done] if rank == 0 else None)
        del eng
        torch.cuda.empty_cache()


def _par_nccl_transport():
    """World 1 over NCCL: its meshes' axes all have size 1, so the
    strategies' collectives return before they reach NCCL.  Here each
    collective's unstaged branch (the buffer stays on the card) runs once
    on the one-rank group, through NCCL, and must hand back its input
    (ppermute's self-pair is a copy: it sends nothing).  Returns the
    collectives' STATS of these calls."""
    import torch.distributed as dist

    from aule_tpu_torch.parallel import collectives as coll

    group = dist.group.WORLD
    x = torch.arange(48, dtype=torch.float32, device=DEV).reshape(2, 4, 6)
    if coll._staged(x, group):
        raise AssertionError("world 1: a CUDA tensor over NCCL was staged "
                             "through host memory")
    coll.reset_stats()
    outs = {"all_reduce": coll._all_reduce(x, dist.ReduceOp.SUM, group),
            "all_gather": coll._all_gather(x, 1, group),
            "all_to_all": coll._all_to_all(x, 0, 2, group),
            "broadcast": coll._broadcast(x, group),
            "reduce_scatter": coll._reduce_scatter(x, 1, group),
            "ppermute": coll._ppermute(x, [(0, 0)], group)}
    torch.cuda.synchronize()
    for name, out in outs.items():
        if out.device != x.device or not torch.equal(out, x):
            raise AssertionError(f"world 1: {name} over NCCL did not hand "
                                 f"back its input")
    return dict(coll.STATS, checked=sorted(outs))


def par_rank(job):
    """One rank of a parallel-phase world on the card (run by
    utils/testing.run_world): world 1 over NCCL runs each collective's
    NCCL branch once (_par_nccl_transport); the gloo worlds of 2 and 4 run
    their PAR_CASES and, in the world of 2, the tensor-parallel engine
    (PAR_TP_RUNS) at Llama-3-8B's width on PAR_TP_LAYERS layers.  Returns
    {case: row} (rank 0's rows hold the errors)."""
    import torch.distributed as dist

    from aule_tpu_torch.models import llama
    from aule_tpu_torch.ops import _build
    from aule_tpu_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()  # built by the parent's build phase
    rank, world = dist.get_rank(), dist.get_world_size()
    res = {"world": world, "backend": dist.get_backend()}
    if job == "world1":
        res["nccl_transport"] = _par_nccl_transport()
        return res
    meshes = {}
    for name, (w, (sizes, names), *_) in PAR_CASES.items():
        if w != world:
            continue
        if (sizes, names) not in meshes:
            meshes[(sizes, names)] = pmesh.make_mesh(sizes, names, "cuda")
        _par_strategy(name, meshes[(sizes, names)], res, rank)
    if world == 2:
        cfg = llama.LlamaConfig(**dict(dataclasses.asdict(
            llama.LlamaConfig.llama3_8b()), n_layers=PAR_TP_LAYERS))
        gen = torch.Generator(device=DEV)
        gen.manual_seed(SEED)
        params = llama.init_params(cfg, gen, device=DEV)
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in PAR_TP_PROMPTS]
        tp_mesh = pmesh.make_mesh((1, world), ("data", "model"), "cuda")
        _par_tp_engine(tp_mesh, rank, res, cfg, params, prompts,
                       tuple(PAR_TP_RUNS))
        del params
    torch.cuda.empty_cache()
    return res


def _par_flash_times(name, q, k, v, causal, window=-1):
    """The forward kernel at a shard shape: twice with the same bits, held
    to its plain version (ROW_TOL, LSE_TOL), CUDA-event medians of the
    kernel, its plain version and SDPA (GQA expanded; a window as a
    boolean mask), and the device time per call of the kernel (its own
    kernel) and of SDPA (torch.profiler), beside the bound."""
    from aule_tpu_torch.ops.flash import (flash_attention_fwd,
                                         flash_attention_fwd_plain)
    from aule_tpu_torch.ops.reference import build_mask
    from aule_tpu_torch.utils import profiling

    b, hq, sq, d = q.shape
    sk, g = k.shape[2], hq // k.shape[1]
    kw = dict(causal=causal, window_size=window, return_lse=True)
    o, lse = _twice(name, lambda: flash_attention_fwd(q, k, v, **kw))
    po, plse = flash_attention_fwd_plain(q, k, v, **kw)
    err = hold(f"{name} B{b} Hq{hq}/Hkv{k.shape[1]} Sq{sq} Sk{sk} D{d} "
               f"{'causal' if causal else 'non-causal'}"
               f"{f' window {window}' if window > 0 else ''}", o, po, lse,
               plse, ROW_TOL[q.dtype])
    del o, lse, po, plse
    kx, vx = (x.repeat_interleave(g, dim=1) for x in (k, v))
    if window > 0:
        flops = profiling.window_attention_flops(b, hq, sq, d, window)
        mask = dict(attn_mask=build_mask(sq, sk, True, window, device=DEV))
    else:
        flops = profiling.attention_flops(b, hq, sq, sk, d, causal)
        mask = dict(is_causal=causal)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * hq * sq
    bound, by = profiling.bound_ms(nbytes, flops)
    ms = profiling.cuda_time_ms(lambda: flash_attention_fwd(q, k, v, **kw),
                                iters=10)
    pl = profiling.cuda_time_ms(lambda: flash_attention_fwd_plain(
        q, k, v, **kw), warmup=1, iters=3)
    sdpa = lambda: SDPA(q, kx, vx, **mask)
    lib = profiling.cuda_time_ms(sdpa, iters=10)
    dev = device_ms(lambda: flash_attention_fwd(q, k, v, **kw),
                    key="flash_fwd")
    dev_lib = device_ms(sdpa)
    del kx, vx
    rate = flops / (dev if dev is not None else ms[0]) / 1e9
    log(f"{name}: kernel device {_ms(dev)} (events {ms[0]:.4f} ms, min "
        f"{ms[1]:.4f} max {ms[2]:.4f}), {rate:.1f} TFLOP/s; plain "
        f"{pl[0]:.4f} ms; SDPA device {_ms(dev_lib)} (events {lib[0]:.4f} "
        f"ms); bound {bound:.4f} ms ({by})")
    return dict(ms=ms[0], plain_ms=pl[0], library_ms=lib[0], bound_ms=bound,
                bound_by=by, err=err, device_ms=dev,
                library_device_ms=dev_lib)


def _par_bwd_times(gen, res):
    """The backward kernels at the ring gradients' shard (B1 Hq32/Hkv8
    S2048 over 2048 keys): the diagonal hop (causal) and the full hop
    (non-causal), both with the non-zero lse cotangent the combine hands
    each hop; each held to its plain version (delta within DELTA_TOL,
    dQ / dK / dV rows within ROW_TOL); the full hop's delta, dQ and dK/dV
    timed beside the bound, their plain versions and the backward of SDPA
    (dq, dk and dv in one call; delta: torch.linalg.vecdot): CUDA-event
    medians, and device times per call (torch.profiler; a kernel's own
    kernel alone)."""
    from aule_tpu_torch.ops import flash_vjp as fv
    from aule_tpu_torch.utils import profiling

    worst = {}
    for causal in (True, False):
        q, k, v, o, lse, do, dlse = _bwd_inputs(
            gen, (1, *PAR_HEADS), 2048, 2048, causal, -1,
            torch.bfloat16, True)
        di = _twice("parallel bwd delta", lambda: (fv.attention_delta(
            o, do, dlse),))[0]
        hold_delta(f"ring shard bwd delta causal={causal}", di, o, do, dlse,
                   worst)
        pd = fv.attention_delta_plain(o, do, dlse)
        kw = dict(causal=causal)
        dq = fv.flash_bwd_dq(q, k, v, do, lse, di, o=o, dlse=dlse, **kw)
        pdq = fv.flash_bwd_dq_plain(q, k, v, do, lse, pd, **kw)
        worst[("dq", causal)] = hold(
            f"ring shard bwd dq causal={causal}", dq, pdq, None, None,
            ROW_TOL[torch.bfloat16])
        dk, dv = fv.flash_bwd_dkv(q, k, v, do, lse, di, **kw)
        pdk, pdv = fv.flash_bwd_dkv_plain(q, k, v, do, lse, pd, **kw)
        e1 = hold(f"ring shard bwd dk causal={causal}", dk, pdk, None, None,
                  ROW_TOL[torch.bfloat16])
        e2 = hold(f"ring shard bwd dv causal={causal}", dv, pdv, None, None,
                  ROW_TOL[torch.bfloat16])
        worst[("dkv", causal)] = tuple(max(a, b) for a, b in zip(e1, e2))
        del dq, pdq, dk, dv, pdk, pdv
    # the full hop (the class the ring adds), timed
    fwd_flops = profiling.attention_flops(1, 32, 2048, 2048, 128)
    qx = q.detach().requires_grad_(True)
    kx = k.repeat_interleave(4, dim=1).requires_grad_(True)
    vx = v.repeat_interleave(4, dim=1).requires_grad_(True)
    ref = SDPA(qx, kx, vx)
    sdpa_bwd = lambda: torch.autograd.grad(ref, (qx, kx, vx), do,
                                           retain_graph=True)
    lib = profiling.cuda_time_ms(sdpa_bwd, iters=10)[0]
    lib_dev = device_ms(sdpa_bwd)
    qkvdo = 2 * (2 * q.numel() + k.numel() + v.numel())
    stats = 4 * lse.numel()
    for part, fn, plain, flops, nbytes in (
            ("delta", lambda: fv.attention_delta(o, do, dlse),
             lambda: fv.attention_delta_plain(o, do, dlse), 2 * o.numel(),
             2 * (o.numel() + do.numel()) + 2 * stats),
            ("dq", lambda: fv.flash_bwd_dq(q, k, v, do, lse, di, o=o,
                                           dlse=dlse),
             lambda: fv.flash_bwd_dq_plain(q, k, v, do, lse, di),
             profiling.attention_bwd_flops(fwd_flops, 3),
             qkvdo + 2 * q.numel() + 2 * stats),
            ("dkv", lambda: fv.flash_bwd_dkv(q, k, v, do, lse, di),
             lambda: fv.flash_bwd_dkv_plain(q, k, v, do, lse, di),
             profiling.attention_bwd_flops(fwd_flops, 4),
             qkvdo + 2 * (k.numel() + v.numel()) + 2 * stats)):
        ms = profiling.cuda_time_ms(fn, iters=10)
        dev = device_ms(fn, key=f"flash_bwd_{part}")
        pl = profiling.cuda_time_ms(plain, warmup=1, iters=3)
        bound, by = profiling.bound_ms(
            nbytes, flops, profiling.H100_F32_FLOPS if part == "delta"
            else profiling.H100_BF16_FLOPS)
        lib_ms, lib_dev_ms = (_vecdot_times(o, do) if part == "delta"
                              else (lib, lib_dev))
        err = (worst["delta"] if part == "delta" else tuple(
            max(a, b) for a, b in zip(worst[(part, True)],
                                      worst[(part, False)])))
        res[f"bwd_{part}"] = dict(ms=ms[0], plain_ms=pl[0], library_ms=lib_ms,
                                  bound_ms=bound, bound_by=by, err=err,
                                  device_ms=dev, library_device_ms=lib_dev_ms)
        log(f"ring shard bwd {part} (full hop, non-zero dlse): kernel device "
            f"{_ms(dev)} (events {ms[0]:.4f} ms); plain {pl[0]:.4f} ms; "
            f"library device {_ms(lib_dev_ms)} (events {lib_ms:.4f} ms); "
            f"bound {bound:.4f} ms ({by})")
    del ref, qx, kx, vx


def _par_kernel_checks(res):
    """Each kernel at the shard shapes the strategies and the
    tensor-parallel engine give it, in this process: held to its plain
    version and timed beside its bound and one PyTorch call."""
    from aule_tpu_torch.ops.paged import paged_attention, paged_attention_plain
    from aule_tpu_torch.ops.paged_fused import (paged_attention_fused,
                                                paged_attention_fused_plain)

    gen = torch.Generator(device=DEV)
    gen.manual_seed(PAR_SEED)
    hq, hkv = PAR_HEADS

    def qkv(hq, hkv, sq, sk):
        return (_randn((1, hq, sq, 128), gen), _randn((1, hkv, sk, 128), gen),
                _randn((1, hkv, sk, 128), gen))

    t = {}
    # the ring's diagonal and full hops (S8192 over 4, S4096 over 2: the
    # same 2048-token shards), context parallel's Sq2048 over its 2048-key
    # shard (the full hop's shape)
    t["flash_fwd_ring_diag_shard"] = _par_flash_times(
        "ring diagonal hop", *qkv(hq, hkv, 2048, 2048), True)
    t["flash_fwd_shard_full"] = _par_flash_times(
        "ring full hop / context-parallel shard", *qkv(hq, hkv, 2048, 2048),
        False)
    # Ulysses' full-sequence kernel over half the heads (2 ranks), causal
    # and windowed; head parallelism's half of the heads at S4096
    t["flash_fwd_ulysses"] = _par_flash_times(
        "Ulysses local", *qkv(hq // 2, hkv // 2, 8192, 8192), True)
    t["flash_fwd_ulysses_window"] = _par_flash_times(
        "Ulysses local", *qkv(hq // 2, hkv // 2, 8192, 8192), True,
        PAR_WINDOW)
    t["flash_fwd_head_parallel"] = _par_flash_times(
        "head-parallel local", *qkv(hq // 2, hkv // 2, 4096, 4096), True)
    _par_bwd_times(gen, t)

    # the sharded paged decode: split pools over model 2 x ctx 2, fused
    # int8 / e4m3 over ctx 2 (B8, 2,048 tokens a shard)
    lens = [2048] * 8
    for name, heads, qdt in (
            ("paged_decode_split_shard", (hq // 2, hkv // 2), None),
            ("paged_decode_int8_ctx_shard", (hq, hkv), torch.int8),
            ("paged_decode_fp8_ctx_shard", (hq, hkv), torch.float8_e4m3fn)):
        q, pool, bt, ln = _decode_inputs(gen, lens, 128, hq=heads[0],
                                         hkv=heads[1])
        if qdt is None:
            (k, v, _, _), _ = _split_pools(pool, None)
            kernel = lambda **x: paged_attention(q, k, v, bt, ln, **x)
            plain = lambda **x: paged_attention_plain(q, k, v, bt, ln, **x)
            kh, vh, kv_bytes = k[:, 1:], v[:, 1:], _fused_operands_bytes(
                heads[1], None, sum(lens))
            key = "splitpools"
        else:
            pl, sc, kh, vh, kv_bytes = _fused_operands(pool, qdt, sum(lens))
            kernel = lambda **x: paged_attention_fused(q, pl, bt, ln,
                                                       kv_scales=sc, **x)
            plain = lambda **x: paged_attention_fused_plain(
                q, pl, bt, ln, kv_scales=sc,
                int8_matmul=qdt == torch.int8, **x)
            key = "fusedpool"
        o, lse = _twice(name, lambda: kernel(return_lse=True))
        po, plse = plain(return_lse=True)
        err = hold(f"{name} B8 Hq{heads[0]}/Hkv{heads[1]} ctx2048", o, po,
                   lse, plse, _tol(torch.bfloat16, qdt == torch.int8))
        kd, vd = _dense_kv(kh, vh, 8, 2048, heads[0] // heads[1])
        qd = q[:, :, None]
        tm = _decode_time(name, kernel, plain, lambda: SDPA(qd, kd, vd), key,
                          kv_bytes, 8, 2048, hq=heads[0], max_pages=128)
        t[name] = dict(tm, err=err)
        del o, lse, po, plse, kd, vd, pool
    # the tensor-parallel engine's kernels: each rank's half of the heads
    # (Hq16 / Hkv4): the decode at B8 ctx1024, the prefill of a 512-token
    # chunk at q_offset 512 (bf16 and int8 pools)
    q, pool, bt, ln = _decode_inputs(gen, [1024] * 8, 72, hq=hq // 2,
                                     hkv=hkv // 2)
    for name, qdt in (("paged_decode_tp2", None),
                      ("paged_decode_int8_tp2", torch.int8)):
        pl, sc, kh, vh, kv_bytes = _fused_operands(pool, qdt, 8 * 1024)
        kernel = lambda **x: paged_attention_fused(q, pl, bt, ln,
                                                   kv_scales=sc, **x)
        plain = lambda **x: paged_attention_fused_plain(
            q, pl, bt, ln, kv_scales=sc, int8_matmul=qdt is not None, **x)
        o, lse = _twice(name, lambda: kernel(return_lse=True))
        po, plse = plain(return_lse=True)
        err = hold(f"{name} B8 Hq16/Hkv4 ctx1024", o, po, lse, plse,
                   _tol(torch.bfloat16, qdt is not None))
        kd, vd = _dense_kv(kh, vh, 8, 1024, 4)
        qd = q[:, :, None]
        tm = _decode_time(name, kernel, plain, lambda: SDPA(qd, kd, vd),
                          "fusedpool", kv_bytes, 8, 1024, hq=hq // 2,
                          max_pages=72)
        t[name] = dict(tm, err=err)
        del o, lse, po, plse, kd, vd
    q, pool, bt, ln, qoff = _prefill_inputs(gen, [512], [512], 512,
                                            max_pages=72, hq=hq // 2,
                                            hkv=hkv // 2)
    times = _chunk_prefill_times(q, pool, bt, ln, qoff,
                                 (("bf16", None), ("int8", torch.int8)),
                                 "parallel TP prefill {}", hist=512)
    t["paged_prefill_tp2"] = times["bf16"]
    t["paged_prefill_int8_tp2"] = times["int8"]
    res["kernels"] = t


def _par_sum(counts):
    total = {}
    for c in counts:
        for k, n in c.items():
            total[k] = total.get(k, 0) + n
    return total


def _par_log_world(label, rows):
    """Per-rank times of each strategy beside the single-device call, and
    the collectives' share."""
    first = rows[0]
    for name in PAR_CASES:
        if name not in first:
            continue
        per = [r[name] for r in rows]
        share = [p["collective_ms"] / max(p["wall_ms"], 1e-9) for p in per]
        log(f"parallel {label} {name}: per-rank time "
            f"{[round(p['ms'], 3) for p in per]} ms (CUDA events, median of "
            f"3; ranks share one card), single-device call "
            f"{first[name]['single_ms']:.3f} ms; collectives "
            f"{[round(p['collective_ms'], 3) for p in per]} ms a call "
            f"({[round(s, 3) for s in share]} of each rank's wall time, "
            f"{per[0]['collective_calls']} calls, "
            f"{per[0]['collective_mbytes']:.1f} MB sent by rank 0), "
            f"launches on rank 0 {first[name]['launches']}")


def check_parallel() -> dict:
    """The parallel phase: the kernels at their shard shapes
    (_par_kernel_checks), then the strategies and the tensor-parallel
    engine through the port's entry points (par_rank) in a world of 1
    over NCCL, and in worlds of 2 and 4 gloo processes sharing this one
    card (collectives staged through host memory: no multi-GPU figure),
    then the tensor-parallel engine's tokens held to the teacher-forced
    plain forward (bf16) or plain-attention replay (int8), beside the tp 1
    engine's on the same weights and prompts."""
    from aule_tpu_torch.models import llama
    from aule_tpu_torch.serving.engine import ServingEngine
    from aule_tpu_torch.utils.testing import run_world

    log(card_line())
    res = {"seconds": {}}
    clock = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        res["seconds"][part] = round(now - clock[0], 1)
        clock[0] = now

    _par_kernel_checks(res)
    lap("kernels")
    torch.cuda.empty_cache()
    worlds = {}
    for job, world, backend in (("world1", 1, "nccl"), ("world2", 2, "gloo"),
                                ("world4", 4, "gloo")):
        rows = run_world(par_rank, world, job, backend=backend, threads=0)
        worlds[job] = rows
        _par_log_world(f"world {world} ({backend})", rows)
        lap(job)
    cfg = llama.LlamaConfig(**dict(dataclasses.asdict(
        llama.LlamaConfig.llama3_8b()), n_layers=PAR_TP_LAYERS))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    params = llama.init_params(cfg, gen, device=DEV)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PAR_TP_PROMPTS]
    # each case's launches, and its flash forwards by hop class, summed
    # over its ranks
    res["launches"], res["hops"] = {}, {}
    for job in ("world2", "world4"):
        for name in PAR_CASES:
            if name in worlds[job][0]:
                for part in ("launches", "hops"):
                    res[part][name] = _par_sum(
                        r[name][part] for r in worlds[job])
    tp_rows = worlds["world2"]
    res["tp"] = {}
    for key, (ekw, n_req, new) in PAR_TP_RUNS.items():
        kw = dict(PAR_TP_KW, **ekw)
        if "spec_tokens" in ekw:
            kw.update(draft_params=params, draft_cfg=cfg)
        eng = ServingEngine(params, cfg, device=DEV, **kw)
        for p in prompts[:n_req]:
            eng.submit(p, new)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = [list(r.output) for r in eng.run()]
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        st1 = eng.stats()
        tok1 = (st1["tokens_generated"] - n_req) / st1["decode_seconds"]
        del eng
        tp = tp_rows[0][key]
        got = tp["outputs"]
        label = f"(TP {key}) {PAR_TP_LABELS[key]}"
        if ekw.get("quantized"):
            check_replay(params, cfg, prompts[:n_req], got, label,
                         torch.int8, CHUNK, engine_kw=PAR_TP_KW,
                         new_tokens=new)
        else:
            check_plain_forward(params, cfg, prompts[:n_req], got, label)
        match = _prefix_match(got, one)[0]
        log(f"parallel {label}: tp 2 decode {tp['decode_tok_s']:.1f} tok/s "
            f"(gloo through host memory, both ranks on one card: no "
            f"multi-GPU figure), wall {tp['wall_s']:.2f} s, collectives "
            f"{tp['collective_s']:.2f} s in {tp['collective_calls']} calls "
            f"on rank 0; tp 1 decode {tok1:.1f} tok/s, wall {wall1:.2f} s; "
            f"greedy-prefix match with tp 1 {match:.4f}; launches on rank 0 "
            f"{tp['launches']}")
        res["tp"][key] = dict(tp_decode_tok_s=tp["decode_tok_s"],
                              tp1_decode_tok_s=tok1, tp_wall_s=tp["wall_s"],
                              tp1_wall_s=wall1, prefix_match_tp1=match,
                              collective_s=tp["collective_s"],
                              launches=_par_sum(r[key]["launches"]
                                                for r in tp_rows))
        torch.cuda.empty_cache()
    log(f"parallel world 1 (nccl): collectives' unstaged branch on a "
        f"one-rank group {worlds['world1'][0]['nccl_transport']}: each "
        f"handed back its input")
    del params
    torch.cuda.empty_cache()
    lap("tp")
    res["worlds"] = {job: [{k: v for k, v in r.items()
                            if k not in PAR_TP_RUNS} for r in rows]
                     for job, rows in worlds.items()}
    log(f"parallel: seconds by part {res['seconds']}")
    return res



# ---------------------------------------------------------------------------
# The parallel layer's model level (check_parallel_model): dp x tp Llama
# training with SGD and ZeRO-1 AdamW, the pipeline-parallel train step, the
# expert-parallel MoE forward and GPT-2 tensor-parallel serving, in gloo
# worlds of 4 and 2 processes on this one card (collectives staged through
# host memory: no multi-GPU figure).

PM_SEED = SEED + 22             # the model-level kernel checks' generator
# Llama-3-8B width at 2 layers.  A (data 2, model 2) rank holds ~2 GB of
# bf16 shards (the replicated 1 GB embedding, half the 1 GB head, half of
# the layers' 0.9 GB), as much in gradients, ~2 GB of f32 logits and, in
# the ZeRO-1 step, ~6 GB of f32 gradient sums and moment blocks: ~16 GB a
# rank, and the one-rank reference step ~27 GB beside the world's state;
# four ranks and a reference fit in the card's 80 GB.
PM_LAYERS = 2
PM_S = 512                      # train sequences: B x (PM_S + 1) tokens
PM_DP_TP = (2, 2)               # the dp x tp mesh: (data, model)
PM_DATA0 = (0, 1)               # its data-0 ranks, one a model shard
PM_PIPE_BATCH, PM_MICRO = 4, 4  # the pipeline: B4 in 4 microbatches
PM_ADAMW = dict(lr=1e-3, weight_decay=0.01)  # the ZeRO-1 step
PM_EP_BATCH, PM_EP_S = 2, 256   # the expert-parallel forward: B2 x 256
PM_EP_FULL = 4.0                # capacity factor E / k: nothing drops
PM_EP_TIGHT = 1.0               # a capacity factor that drops pairs
PM_GPT2_PROMPTS = [129, 300, 511, 700]
PM_GPT2_NEW = 32
PM_GPT2_KW = dict(GPT2_ENGINE_KW, num_pages=256)
# GPT-2 small's tensor-parallel runs: key -> (label, engine options)
PM_GPT2_RUNS = {
    "g1": ("bf16 whole-prompt", {}),
    "g2": ("bf16 chunk 256", dict(prefill_chunk=GPT2_CHUNK)),
    "g3": ("int8 chunk 256", dict(quantized=True, prefill_chunk=GPT2_CHUNK)),
}
PM_NOTE = ("gloo through host memory, every rank on this one card: no "
           "multi-GPU figure")


def _pm_llama_cfg():
    from aule_tpu_torch.models import llama

    return llama.LlamaConfig(**dict(dataclasses.asdict(
        llama.LlamaConfig.llama3_8b()), n_layers=PM_LAYERS))


def _pm_moe_cfg():
    from aule_tpu_torch.models import moe

    return moe.MoEConfig(**dict(dataclasses.asdict(
        moe.MoEConfig.mixtral_8x7b()), n_layers=1))


def _pm_init(family, cfg):
    """The full params of `cfg` from a generator seeded with SEED on the
    card: every rank and every reference build the same weights."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    return family.init_params(cfg, gen, device=DEV)


def _pm_tokens(vocab, batch, n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, size=(batch, n))).to(DEV)


class _GradStash:
    """Copies of each tensor's gradient as backward accumulates it (a hook
    that runs before a step's own hooks and updates)."""

    def __init__(self, tensors):
        for t in tensors:
            t.requires_grad_(True)
        self.grads = [None] * len(tensors)
        self.hooks = [t.register_post_accumulate_grad_hook(
            lambda t, i=i: self._keep(i, t)) for i, t in enumerate(tensors)]

    def _keep(self, i, t):
        g = t.grad.detach().clone()
        self.grads[i] = g if self.grads[i] is None else self.grads[i] + g

    def take(self):
        for h in self.hooks:
            h.remove()
        return self.grads


def _pm_run(fn, rank, profile=True):
    """fn() once with every launch count set to 0 just before and read just
    after: its wall seconds, the collectives' calls, bytes and host
    seconds, and (`profile`) on rank 0 the card's busy time under
    torch.profiler (the step's device time)."""
    from aule_tpu_torch.parallel import collectives
    from aule_tpu_torch.utils import profiling

    counters = _par_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    collectives.reset_stats()
    box = []
    t0 = time.perf_counter()
    profile = profile and rank == 0
    if profile:
        bd = profiling.device_breakdown(lambda: box.append(fn()), CATEGORIES)
    else:
        box.append(fn())
    torch.cuda.synchronize()
    row = dict(wall_s=time.perf_counter() - t0,
               launches={k: c.launches for k, c in counters.items()
                         if c.launches},
               collective_s=collectives.STATS["seconds"],
               collective_calls=collectives.STATS["calls"],
               collective_mb=collectives.STATS["bytes"] / 1e6)
    if profile:
        row.update(device_ms=bd["busy_ms"], profiled_wall_ms=bd["wall_ms"],
                   kernels=bd["kernels"])
    return box[0], row


def _rel(got, want) -> float:
    w = want.detach().float()
    return float((got.detach().float() - w).norm()
                 / w.norm().clamp_min(1e-30))


def _pm_hold(label, pairs) -> float:
    """Each (name, got, want) pair within GRAD_TOL relative Frobenius error
    and finite; returns the largest error."""
    worst, where = 0.0, ""
    for name, got, want in pairs:
        rel = _rel(got, want)
        if not (rel <= GRAD_TOL and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{label}: {name} relative error {rel:.3e} "
                                 f"(<= {GRAD_TOL}) or not finite")
        if rel >= worst:
            worst, where = rel, name
    log(f"{label}: {len(pairs)} tensors, largest relative Frobenius error "
        f"{worst:.3e} ({where}) <= {GRAD_TOL} ok")
    return worst


def _pm_turns(fn, ranks=None):
    """fn() on each of `ranks` (every rank for None) in turn while the
    others wait (a reference step needs the card's memory that the world's
    state leaves); {} on the other ranks."""
    import torch.distributed as dist

    torch.cuda.empty_cache()
    out = {}
    for r in range(dist.get_world_size()) if ranks is None else ranks:
        dist.barrier()
        if r == dist.get_rank():
            out = fn()
            torch.cuda.empty_cache()
    dist.barrier()
    return out


def _pm_replay(label, new, old, replays) -> int:
    """Each leaf after a step (`new`: a shard, or a ZeRO-1 block of one)
    against `replays`, the same update replayed from this rank's own
    gradient or moments on the pre-step leaf `old`: equal bit for bit, and
    the replay changes at least one value of every leaf, so the pre-step
    leaf fails the check (a skipped update, or one written to another
    block, cannot pass).  The update's inputs are held to one rank's step
    by the gradient or moment checks.  Returns the fewest values changed
    in a leaf."""
    fewest = None
    for i, (n, o, r) in enumerate(zip(new, old, replays)):
        if not torch.equal(n, r):
            raise AssertionError(
                f"{label}: leaf {i} {tuple(n.shape)} differs from its "
                f"update replayed from this rank's own state")
        changed = int((r != o).sum())
        if changed == 0:
            raise AssertionError(
                f"{label}: the update leaves leaf {i} {tuple(n.shape)} "
                f"unchanged, so the check cannot see it")
        fewest = changed if fewest is None else min(fewest, changed)
    log(f"{label}: {len(old)} leaves equal their update replayed from this "
        f"rank's state, bit for bit; every leaf moved (at least {fewest} "
        f"values)")
    return fewest


def _pm_sgd_replays(old, grads):
    """SGD's update of each pre-step leaf by the gradient the step applied
    (llama._sgd_step: one add_ in f32, rounded once)."""
    return (o.clone().add_(g, alpha=-TRAIN_LR) for o, g in zip(old, grads))


def _pm_adamw_replays(old, mu, nu):
    """The first AdamW step (count 1, no master copy) of each pre-step
    block from its moments, in optimizer.py's order of operations."""
    c = [np.float32(1.0) - np.float32(b) ** np.float32(1)
         for b in (0.9, 0.999)]  # make_adamw_train_step's b1, b2
    for o, m, v in zip(old, mu, nu):
        c1, c2 = torch.tensor(c, dtype=torch.float32, device=m.device)
        u = (m / c1).div_((v / c2).sqrt_().add_(1e-8))
        base = o.to(torch.float32)
        u.add_(base * PM_ADAMW["weight_decay"])
        u.mul_(PM_ADAMW["lr"])
        yield (base - u).to(o.dtype)


def _pm_train(res, rank):
    """dp x tp on a (data 2, model 2) mesh at Llama-3-8B width, 2 layers,
    B2 x 513 tokens (one sequence a data rank): one SGD step
    (llama.train_step(mesh=)), then one ZeRO-1 AdamW step
    (make_adamw_train_step(llama, cfg, mesh)) from the same weights.

    Every rank holds each leaf after the step to the update replayed from
    its own state (`_pm_replay`: its summed gradient for SGD; for ZeRO-1,
    its block from its moment blocks, whose second moment must be the
    first-step square of its first).  Ranks in turn hold the step's inputs
    to the same step on one rank of the card within GRAD_TOL: the loss,
    each gradient (SGD, on the data-0 ranks: the data-1 ranks' gradients
    and shards must equal theirs bit for bit, their sums compared by the
    parent) or each rank's first-moment block ((1 - b1) times the
    gradient, ZeRO-1, on every rank), and each updated shard whole."""
    from aule_tpu_torch.models import llama
    from aule_tpu_torch.parallel import mesh as pmesh
    from aule_tpu_torch.parallel import optimizer
    from aule_tpu_torch.utils.tree import tree_flatten

    cfg = _pm_llama_cfg()
    mesh = pmesh.make_mesh(PM_DP_TP, ("data", "model"), "cuda")
    tokens = _pm_tokens(cfg.vocab_size, PM_DP_TP[0], PM_S + 1, SEED + 3)
    specs = llama.param_specs(cfg)

    def shards():
        return llama.shard_params(_pm_init(llama, cfg), cfg, mesh)

    params = shards()
    spec_list = optimizer._spec_list(specs, params)
    leaves = tree_flatten(params)
    stash = _GradStash(leaves)
    (_, loss), row = _pm_run(lambda: llama.train_step(
        params, tokens, cfg, TRAIN_LR, mesh=mesh), rank)
    grads = stash.take()
    row.update(loss=float(loss), peak_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30)
    old = tree_flatten(shards())
    row["fewest_moved"] = _pm_replay(
        f"model dp x tp SGD rank {rank} updated shards", leaves, old,
        _pm_sgd_replays(old, grads))
    del old
    torch.cuda.empty_cache()

    def sgd_reference():
        full = _pm_init(llama, cfg)
        ref_stash = _GradStash(tree_flatten(full))
        _, ref_loss = llama.train_step(full, tokens, cfg, TRAIN_LR)
        ref = ref_stash.take()
        names = [f"leaf {i} {tuple(t.shape)}" for i, t in enumerate(leaves)]
        label = f"model dp x tp SGD rank {rank}"
        out = dict(
            ref_loss=float(ref_loss),
            grad_err=_pm_hold(label + " gradients", [
                (n, g, pmesh.shard(r, mesh, s)) for n, g, r, s in zip(
                    names, grads, ref, spec_list)]),
            param_err=_pm_hold(label + " updated shards, whole", [
                (n, p, pmesh.shard(r, mesh, s)) for n, p, r, s in zip(
                    names, leaves, tree_flatten(full), spec_list)]))
        del full, ref
        return out

    row.update(_pm_turns(sgd_reference, PM_DATA0))
    row["checksum"] = [float(t.float().sum()) for t in leaves + grads]
    res["sgd"] = row
    del params, leaves, grads, stash
    torch.cuda.empty_cache()

    params = shards()
    opt = optimizer.adamw_init(params, specs, mesh)
    step = optimizer.make_adamw_train_step(llama, cfg, mesh, **PM_ADAMW)
    (_, opt, loss), row = _pm_run(lambda: step(params, opt, tokens), rank)
    mu, nu = tree_flatten(opt.mu), tree_flatten(opt.nu)
    z = optimizer._spec_list(optimizer.zero1_specs(specs, params, mesh),
                             params)
    row.update(loss=float(loss), peak_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30,
               moments_gib=2 * sum(t.numel() * 4 for t in mu) / 2 ** 30,
               moments_sharded=sum("data" in s for s in z))
    if not row["moments_sharded"]:
        raise AssertionError("ZeRO-1: no moment holds a data block")
    leaves = tree_flatten(params)
    dims = [optimizer._data_dim(s, "data") for s in z]

    def block(t, d):
        return optimizer._block(t, d, mesh, "data")

    label = f"model ZeRO-1 AdamW rank {rank}"
    row["second_moment_err"] = max(_rel(v, m * m * np.float32(0.1))
                                   for m, v in zip(mu, nu))
    if row["second_moment_err"] > 1e-5:  # (1 - b2) / (1 - b1)^2 = 0.1
        raise AssertionError(f"{label}: a second moment is not the first "
                             f"step's square of its first")
    old = [block(t, d) for t, d in zip(tree_flatten(shards()), dims)]
    row["fewest_moved"] = _pm_replay(
        label + " updated blocks", [block(t, d) for t, d in zip(leaves, dims)],
        old, _pm_adamw_replays(old, mu, nu))
    del opt, nu, old
    torch.cuda.empty_cache()

    def zero1_reference():
        full = _pm_init(llama, cfg)
        ref_opt = optimizer.adamw_init(full)
        ref_step = optimizer.make_adamw_train_step(llama, cfg, **PM_ADAMW)
        _, ref_opt, ref_loss = ref_step(full, ref_opt, tokens)
        names = [f"leaf {i} {tuple(t.shape)}" for i, t in enumerate(leaves)]
        out = dict(
            ref_loss=float(ref_loss),
            moment_err=_pm_hold(label + " first moments (its blocks)", [
                (n, m, pmesh.shard(r, mesh, s)) for n, m, r, s in zip(
                    names, mu, tree_flatten(ref_opt.mu), z)]),
            param_err=_pm_hold(label + " updated shards, whole", [
                (n, p, pmesh.shard(r, mesh, s)) for n, p, r, s in zip(
                    names, leaves, tree_flatten(full), spec_list)]))
        del full, ref_opt
        return out

    row.update(_pm_turns(zero1_reference))
    row["checksum"] = [float(t.float().sum()) for t in leaves]
    res["zero1"] = row
    del params, leaves, mu
    torch.cuda.empty_cache()


def _pm_loss_check(what, row):
    if abs(row["loss"] - row["ref_loss"]) > GRAD_TOL * abs(row["ref_loss"]):
        raise AssertionError(f"{what}: loss {row['loss']} against one rank's "
                             f"{row['ref_loss']}")


def _pm_ep(res, rank):
    """The expert-parallel forward at Mixtral-8x7B width (8 experts, top 2,
    ffn 14,336), 1 layer, B2 x 256, 2 experts a rank on an (expert 4)
    mesh: at capacity factor E / k (nothing drops) and at PM_EP_TIGHT
    (pairs drop).  Rank 0 holds the first to the dense mixture and the
    second to the capacity mixture on one device (every expert local,
    moe.make_expert_parallel_mlp(None, ...)): every logit row within
    ROW_TOL."""
    from aule_tpu_torch.models import moe
    from aule_tpu_torch.parallel import mesh as pmesh

    cfg = _pm_moe_cfg()
    mesh = pmesh.make_mesh((4,), ("expert",), "cuda")
    tokens = _pm_tokens(cfg.vocab_size, PM_EP_BATCH, PM_EP_S, SEED + 4)
    params = moe.shard_params(_pm_init(moe, cfg), cfg, mesh,
                              model_axis=None, expert_axis="expert")
    torch.cuda.empty_cache()
    outs, rows = {}, {}
    with torch.no_grad():
        for key, cf in (("full", PM_EP_FULL), ("tight", PM_EP_TIGHT)):
            fn = moe.make_expert_parallel_forward(mesh, cfg,
                                                  capacity_factor=cf)
            outs[key], rows[key] = _pm_run(lambda: fn(params, tokens), rank)
    row = rows["full"]
    row.update(tight=rows["tight"],
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               checksum=[float(o.sum()) for o in outs.values()])
    del params
    torch.cuda.empty_cache()

    def reference():
        full = _pm_init(moe, cfg)
        with torch.no_grad():
            dense = moe.forward(full, tokens, cfg)
            one = moe.forward(full, tokens, cfg,
                              moe_mlp=moe.make_expert_parallel_mlp(
                                  None, cfg, capacity_factor=PM_EP_TIGHT))
        out = dict(
            err=hold("model EP forward (no drops) vs the dense mixture",
                     outs["full"], dense, None, None, ROW_TOL[torch.bfloat16]),
            err_tight=hold(f"model EP forward (capacity {PM_EP_TIGHT}) vs "
                           f"the capacity mixture on one device",
                           outs["tight"], one, None, None,
                           ROW_TOL[torch.bfloat16]),
            drop_effect=_err(one, dense))
        if out["drop_effect"] == 0.0:
            raise AssertionError("EP at the tight capacity dropped nothing")
        log(f"model EP: the tight capacity's drops move the logits by up to "
            f"{out['drop_effect']:.3e} from the dense mixture")
        del full
        return out

    row.update(_pm_turns(reference, (0,)))
    res["ep"] = row


def _pm_pipeline(res, rank):
    """GPipe on a (pipe 2) mesh at Llama-3-8B width, 2 layers (one a
    stage), B4 x 513 tokens in 4 microbatches: the pipelined forward's
    logits (no grad), then one pipelined SGD step.  Held, on each rank in
    turn, to the unpipelined forward and step on one rank: every logit row
    within ROW_TOL (rank 0), and the loss, the stage's gradients and its
    updated shards within GRAD_TOL; each rank's updated shards equal the
    update replayed from its gradients (`_pm_replay`)."""
    from aule_tpu_torch.models import llama
    from aule_tpu_torch.parallel import mesh as pmesh
    from aule_tpu_torch.parallel import pipeline
    from aule_tpu_torch.utils.tree import tree_flatten

    cfg = _pm_llama_cfg()
    mesh = pmesh.make_mesh((2,), ("pipe",), "cuda")
    tokens = _pm_tokens(cfg.vocab_size, PM_PIPE_BATCH, PM_S + 1, SEED + 5)
    params = pipeline.shard_params(pipeline.stack_layer_params(
        _pm_init(llama, cfg)), mesh)
    torch.cuda.empty_cache()
    fwd = pipeline.make_pipeline_forward(mesh, cfg, microbatches=PM_MICRO)
    with torch.no_grad():
        logits, frow = _pm_run(lambda: fwd(params, tokens[:, :-1]), rank)
    step = pipeline.make_pipeline_train_step(
        mesh, cfg, microbatches=PM_MICRO, lr=TRAIN_LR)
    leaves = tree_flatten(params)
    stash = _GradStash(leaves)
    (_, loss), row = _pm_run(lambda: step(params, tokens), rank)
    grads = stash.take()
    row.update(loss=float(loss), forward=frow,
               bubble=(2 - 1) / (PM_MICRO + 2 - 1),  # (P-1)/(M+P-1)
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               checksum=float(logits.sum()))
    old = tree_flatten(pipeline.shard_params(pipeline.stack_layer_params(
        _pm_init(llama, cfg)), mesh))
    row["fewest_moved"] = _pm_replay(
        f"model pipeline rank {rank} updated shards", leaves, old,
        _pm_sgd_replays(old, grads))
    del old
    stage = pmesh.axis_index(mesh, "pipe")
    per = cfg.n_layers // 2

    def reference():
        full = _pm_init(llama, cfg)
        out = {}
        if rank == 0:
            with torch.no_grad():
                want = llama.forward(full, tokens[:, :-1], cfg)
            out["logit_err"] = hold(
                "model pipeline forward vs the unpipelined forward", logits,
                want, None, None, ROW_TOL[torch.bfloat16])
            del want
        ref_stash = _GradStash(list(llama._tensors(full)))
        _, ref_loss = llama.train_step(full, tokens, cfg, TRAIN_LR)
        ref = dict(zip([id(t) for t in llama._tensors(full)],
                       ref_stash.take()))
        # the stage's view of the full params: its layers, stacked
        mine = pipeline.stack_layer_params(dict(
            full, layers=full["layers"][stage * per:(stage + 1) * per]))
        ref_g = pipeline.stack_layer_params({
            k: (ref[id(v)] if k != "layers" else
                [{n: ref[id(t)] for n, t in layer.items()}
                 for layer in full["layers"][stage * per:(stage + 1) * per]])
            for k, v in full.items()})
        names = [f"leaf {i} {tuple(t.shape)}" for i, t in enumerate(leaves)]
        label = f"model pipeline rank {rank}"
        out.update(
            ref_loss=float(ref_loss),
            grad_err=_pm_hold(label + " gradients", list(zip(
                names, grads, tree_flatten(ref_g)))),
            param_err=_pm_hold(label + " updated shards, whole", list(zip(
                names, leaves, tree_flatten(mine)))))
        del full, ref, mine, ref_g
        return out

    row.update(_pm_turns(reference))
    res["pipeline"] = row
    del params, leaves, grads, logits
    torch.cuda.empty_cache()


def _pm_gpt2_params():
    from aule_tpu_torch.models import gpt2

    cfg = gpt2.GPT2Config(dtype=torch.bfloat16)
    return cfg, _pm_init(gpt2, cfg)


def _pm_gpt2_prompts(vocab):
    rng = np.random.default_rng(SEED + 6)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in PM_GPT2_PROMPTS]


def _pm_gpt2(res, rank):
    """GPT-2 small (12 heads, D64, bf16 random weights) served
    tensor-parallel on a (1, 2) mesh, 6 heads a rank, in each run of
    PM_GPT2_RUNS: every rank drives the same loop; rank 0 keeps the
    tokens, which the parent holds to the plain forward or replay."""
    from aule_tpu_torch.models import gpt2
    from aule_tpu_torch.parallel import mesh as pmesh
    from aule_tpu_torch.serving.engine import ServingEngine

    cfg, params = _pm_gpt2_params()
    mesh = pmesh.make_mesh((1, 2), ("data", "model"), "cuda")
    prompts = _pm_gpt2_prompts(cfg.vocab_size)
    for key, (_, kw) in PM_GPT2_RUNS.items():
        eng = ServingEngine(params, cfg, model=gpt2, mesh=mesh, device=DEV,
                            **PM_GPT2_KW, **kw)
        for p in prompts:
            eng.submit(p, PM_GPT2_NEW)
        # one step (admission, prefill and a first decode dispatch), one
        # decode dispatch profiled on rank 0, then the rest; the counts
        # and collectives of all three
        done, row = _pm_run(lambda: _pm_serve(eng, rank), rank,
                            profile=False)
        row.update(done.pop())
        st = eng.stats()
        row.update(decode_tok_s=(st["tokens_generated"] - len(prompts))
                   / max(st["decode_seconds"], 1e-9),
                   outputs=[list(r.output) for r in done])
        res[key] = row
        del eng
        torch.cuda.empty_cache()


def _pm_serve(eng, rank):
    """An engine's run with its second step (a decode dispatch) under
    torch.profiler on rank 0: (finished requests + [the dispatch's device
    busy ms and kernels])."""
    from aule_tpu_torch.utils import profiling

    eng.step()
    if rank == 0:
        bd = profiling.device_breakdown(eng.step, CATEGORIES)
        prof = dict(device_ms=bd["busy_ms"], profiled_wall_ms=bd["wall_ms"],
                    kernels=bd["kernels"])
    else:
        eng.step()
        prof = {}
    return eng.run() + [prof]


def pm_rank(job):
    """One rank of a model-level world on the card (run by
    utils/testing.run_world): the world of 4 runs the dp x tp steps and
    the expert-parallel forward, the world of 2 the pipeline and GPT-2
    tensor-parallel serving.  Returns {configuration: row}."""
    import torch.distributed as dist

    from aule_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)  # every rank on the one card
    _build.library()  # built by the parent's build phase
    rank = dist.get_rank()
    res = {"seconds": {}}
    parts = ((("train", _pm_train), ("ep", _pm_ep)) if job == "world4"
             else (("pipeline", _pm_pipeline), ("gpt2", _pm_gpt2)))
    for name, fn in parts:
        t0 = time.perf_counter()
        fn(res, rank)
        res["seconds"][name] = round(time.perf_counter() - t0, 1)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    return res


def _pm_bwd_times(gen, name, heads, s):
    """delta, dQ and dK/dV at a train step's shard (B1, `heads` (Hq, Hkv),
    S tokens, D128 bf16 causal, no lse cotangent): each held to its plain
    version (delta within DELTA_TOL, rows within ROW_TOL of at least
    BWD_FLOOR of the largest |value|, as check_flash_bwd) and timed beside
    its bound, its plain version and the backward of SDPA (delta:
    torch.linalg.vecdot)."""
    from aule_tpu_torch.ops import flash_vjp as fv
    from aule_tpu_torch.utils import profiling

    q, k, v, o, lse, do, _ = _bwd_inputs(gen, (1, *heads), s, s, True, -1,
                                         torch.bfloat16, False)
    worst = {}
    di = _twice(f"{name} delta", lambda: (fv.attention_delta(o, do),))[0]
    hold_delta(f"{name} bwd delta", di, o, do, None, worst)
    pd = fv.attention_delta_plain(o, do)
    dq = fv.flash_bwd_dq(q, k, v, do, lse, di, causal=True, o=o)
    tol = ROW_TOL[torch.bfloat16]
    worst["dq"] = hold(f"{name} bwd dq", dq, fv.flash_bwd_dq_plain(
        q, k, v, do, lse, pd, causal=True), None, None, tol, floor=BWD_FLOOR)
    dk, dv = fv.flash_bwd_dkv(q, k, v, do, lse, di, causal=True)
    pdk, pdv = fv.flash_bwd_dkv_plain(q, k, v, do, lse, pd, causal=True)
    worst["dkv"] = tuple(max(a, b) for a, b in zip(
        hold(f"{name} bwd dk", dk, pdk, None, None, tol, floor=BWD_FLOOR),
        hold(f"{name} bwd dv", dv, pdv, None, None, tol, floor=BWD_FLOOR)))
    del dq, dk, dv, pdk, pdv
    g = heads[0] // heads[1]
    fwd_flops = profiling.attention_flops(1, heads[0], s, s, 128, True)
    qx = q.detach().requires_grad_(True)
    kx = k.repeat_interleave(g, dim=1).requires_grad_(True)
    vx = v.repeat_interleave(g, dim=1).requires_grad_(True)
    ref = SDPA(qx, kx, vx, is_causal=True)
    sdpa_bwd = lambda: torch.autograd.grad(ref, (qx, kx, vx), do,
                                           retain_graph=True)
    lib = (profiling.cuda_time_ms(sdpa_bwd, iters=10)[0], device_ms(sdpa_bwd))
    qkvdo = 2 * (2 * q.numel() + k.numel() + v.numel())
    stats = 4 * lse.numel()
    out = {}
    for part, fn, plain, flops, nbytes in (
            ("delta", lambda: fv.attention_delta(o, do),
             lambda: fv.attention_delta_plain(o, do), 2 * o.numel(),
             2 * (o.numel() + do.numel()) + stats),
            ("dq", lambda: fv.flash_bwd_dq(q, k, v, do, lse, di, causal=True,
                                           o=o),
             lambda: fv.flash_bwd_dq_plain(q, k, v, do, lse, di,
                                           causal=True),
             profiling.attention_bwd_flops(fwd_flops, 3),
             qkvdo + 2 * q.numel() + 2 * stats),
            ("dkv", lambda: fv.flash_bwd_dkv(q, k, v, do, lse, di,
                                             causal=True),
             lambda: fv.flash_bwd_dkv_plain(q, k, v, do, lse, di,
                                            causal=True),
             profiling.attention_bwd_flops(fwd_flops, 4),
             qkvdo + 2 * (k.numel() + v.numel()) + 2 * stats)):
        t = _mode_time(
            f"{name} bwd {part} B1 Hq{heads[0]}/Hkv{heads[1]} S{s} D128 "
            f"bf16 causal", fn, plain,
            _vecdot_times(o, do) if part == "delta" else lib,
            f"flash_bwd_{part}", nbytes, flops,
            profiling.H100_F32_FLOPS if part == "delta"
            else profiling.H100_BF16_FLOPS)
        err = worst[part]
        out[part] = dict(t, err=tuple(err) + (0.0,) * (3 - len(err)))
    del ref, qx, kx, vx
    return out


def _pm_gpt2_kernels(gen, t):
    """GPT-2 small's kernels at a tp 2 rank's 6 heads (D64, group 1): the
    paged decode at B4 over the engine's contexts (bf16 and int8 dot
    pools) and the prefill of a 256-token chunk at q_offset 256 over 512
    (bf16 and int8 pools), each twice with the same bits, held to its plain
    version and timed (GPT-2 phase's _decode_mode_times and _mode_time)."""
    from aule_tpu_torch.ops.paged_fused import (dequantize_pool,
                                                from_fused_layout,
                                                paged_attention_fused,
                                                paged_attention_fused_plain)
    from aule_tpu_torch.ops.paged_prefill import (
        paged_attention_prefill, paged_attention_prefill_plain)
    from aule_tpu_torch.utils import profiling

    heads = (6, 6, 64)
    lens = [n + PM_GPT2_NEW for n in PM_GPT2_PROMPTS]
    max_pages = PM_GPT2_KW["max_pages_per_seq"]
    for name, mode in (("paged_decode_gpt2_tp2", TC_DECODE_MODES[0]),
                       ("paged_decode_int8_gpt2_tp2", TC_DECODE_MODES[2])):
        _, dt, qdt, dot, sdt = mode
        pool, bt = _generic_pool(gen, lens, max_pages, 16, 6, 64, dt, True)
        pl, sc = _gen_quantized(pool, qdt, sdt)
        q = _randn((len(lens), 6, 64), gen, dt)
        ln = torch.tensor(lens, dtype=torch.int32, device=DEV)
        kw = dict(kv_scales=sc, int8_matmul=dot, return_lse=True)
        o, lse = _twice(name, lambda: paged_attention_fused(q, pl, bt, ln,
                                                            **kw))
        po, plse = paged_attention_fused_plain(q, pl, bt, ln, **kw)
        err = hold(f"{name} B4 Hq6/Hkv6 D64 ctx {lens}", o, po, lse, plse,
                   _tol(dt, qdt is not None))
        res = {"time": {}}
        _decode_mode_times(gen, res, "", mode, lens, heads, max_pages, False)
        t[name] = dict(res["time"][f"decode {mode[0]}"], err=err)
        del pool, pl, sc, o, lse, po, plse
    hist, chunk = 256, GPT2_CHUNK
    for name, qdt in (("paged_prefill_gpt2_tp2", None),
                      ("paged_prefill_int8_gpt2_tp2", torch.int8)):
        pool, bt = _generic_pool(gen, [hist + chunk], max_pages, 16, 6, 64,
                                 torch.bfloat16, False)
        pl, sc = _gen_quantized(pool, qdt)
        q = _randn((1, 6, chunk, 64), gen, torch.bfloat16)
        ln = torch.tensor([hist + chunk], dtype=torch.int32, device=DEV)
        qoff = torch.tensor([hist], dtype=torch.int32, device=DEV)
        kw = dict(q_offsets=qoff, kv_scales=sc)
        o, lse = _twice(name, lambda: paged_attention_prefill(
            q, pl, bt, ln, return_lse=True, **kw))
        po, plse = paged_attention_prefill_plain(q, pl, bt, ln,
                                                 return_lse=True, **kw)
        err = hold(f"{name} chunk {chunk} at {hist} Hq6/Hkv6 D64", o, po,
                   lse, plse, _tol(torch.bfloat16))
        kh, vh = (from_fused_layout(pl[1:], 64) if qdt is None
                  else dequantize_pool(pl[1:], sc[1:], 64))
        kd, vd = (x.reshape(1, 6, -1, 64)[:, :, :hist + chunk]
                  .to(torch.bfloat16) for x in (kh, vh))
        mask = (torch.arange(hist + chunk, device=DEV)[None, :]
                <= hist + torch.arange(chunk, device=DEV)[:, None])
        nbytes = 2 * q.numel() * 2 + profiling.paged_kv_bytes(
            hist + chunk, 6, 64, 2 if qdt is None else 1,
            0 if qdt is None else 2) + max_pages * 4 + 3 * 4
        t[name] = dict(_mode_time(
            f"{name} time chunk {chunk} at {hist} Hq6/Hkv6 D64 page16",
            lambda: paged_attention_prefill(q, pl, bt, ln, **kw),
            lambda: paged_attention_prefill_plain(q, pl, bt, ln, **kw),
            lambda: SDPA(q, kd, vd, attn_mask=mask), "paged_prefill_kernel",
            nbytes, profiling.paged_prefill_flops([hist], [chunk], 6, 64),
            profiling.H100_BF16_FLOPS), err=err)
        del pool, pl, sc, kd, vd, kh, vh, o, lse, po, plse


def _pm_kernel_checks(res):
    """Each kernel at the shard shapes the model-level configurations give
    it, in this process: held to its plain version and timed beside its
    bound and one PyTorch call."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(PM_SEED)

    def qkv(b, hq, hkv, s, d=128):
        return (_randn((b, hq, s, d), gen), _randn((b, hkv, s, d), gen),
                _randn((b, hkv, s, d), gen))

    t = {}
    hq, hkv = PAR_HEADS
    t["flash_fwd_dp_tp_shard"] = _par_flash_times(
        "dp x tp shard", *qkv(1, hq // 2, hkv // 2, PM_S), True)
    t["flash_fwd_pipeline_stage"] = _par_flash_times(
        "pipeline microbatch", *qkv(1, hq, hkv, PM_S), True)
    t["flash_fwd_ep"] = _par_flash_times(
        "expert-parallel forward", *qkv(PM_EP_BATCH, hq, hkv, PM_EP_S), True)
    t["flash_fwd_gpt2_tp2"] = _par_flash_times(
        "GPT-2 tp 2 whole prompt", *qkv(1, 6, 6, max(PM_GPT2_PROMPTS), 64),
        True)
    for key, heads in (("dp_tp_shard", (hq // 2, hkv // 2)),
                       ("pipeline_stage", (hq, hkv))):
        for part, row in _pm_bwd_times(gen, f"model {key}", heads,
                                       PM_S).items():
            t[f"flash_bwd_{part}_{key}"] = row
    _pm_gpt2_kernels(gen, t)
    res["kernels"] = t


def _pm_log(label, row, profiled="the step"):
    dev = (f", device busy {row['device_ms']:.1f} ms on rank 0 for "
           f"{profiled} (torch.profiler, {row['kernels']} kernels)"
           if "device_ms" in row else "")
    log(f"model {label}: wall {row['wall_s']:.3f} s{dev}; collectives "
        f"{row['collective_s']:.3f} s in {row['collective_calls']} calls, "
        f"{row['collective_mb']:.1f} MB sent ({PM_NOTE}); launches "
        f"{row['launches']}")


def check_parallel_model() -> dict:
    """The model-level phase: the kernels at their shard shapes
    (_pm_kernel_checks), then a gloo world of 4 (dp x tp SGD and ZeRO-1
    AdamW, the expert-parallel forward) and one of 2 (the pipeline step,
    GPT-2 tensor-parallel serving) sharing this one card (collectives
    staged through host memory: no multi-GPU figure), then GPT-2's
    tensor-parallel tokens held to the teacher-forced plain forward (bf16)
    or plain-attention replay (int8), beside the tp 1 engine's."""
    from aule_tpu_torch.models import gpt2
    from aule_tpu_torch.serving.engine import ServingEngine
    from aule_tpu_torch.utils.testing import run_world

    log(card_line())
    res = {"seconds": {}}
    clock = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        res["seconds"][part] = round(now - clock[0], 1)
        clock[0] = now

    _pm_kernel_checks(res)
    lap("kernels")
    torch.cuda.empty_cache()
    worlds = {}
    for job, world in (("world4", 4), ("world2", 2)):
        worlds[job] = run_world(pm_rank, world, job, backend="gloo",
                                threads=0)
        lap(job)
        log(f"model {job}: seconds by part on rank 0 "
            f"{worlds[job][0]['seconds']}; peak allocated GiB by rank "
            f"{[round(r['peak_gib'], 2) for r in worlds[job]]}")
    w4, w2 = worlds["world4"], worlds["world2"]
    for key, rows in (("sgd", w4), ("zero1", w4), ("ep", w4),
                      ("pipeline", w2)):
        _pm_log(key, rows[0][key])
        log(f"model {key}: peak allocated GiB by rank "
            f"{[round(r[key]['peak_gib'], 2) for r in rows]}")
    for key in ("sgd", "zero1"):
        z = [r[key]["checksum"] for r in w4]
        # ranks (0, 1) and (2, 3) hold the same model shard on data 0, 1
        if z[0] != z[2] or z[1] != z[3]:
            raise AssertionError(f"{key}: the data ranks' shards differ")
        _pm_loss_check(key, w4[0][key])
    _pm_loss_check("pipeline", w2[0]["pipeline"])
    if len({tuple(r["ep"]["checksum"]) for r in w4}) != 1:
        raise AssertionError("EP: the expert ranks' outputs differ")
    if len({r["pipeline"]["checksum"] for r in w2}) != 1:
        raise AssertionError("pipeline: the stages' logits differ")
    sgd, zero1, pipe = (w4[0]["sgd"], w4[0]["zero1"], w2[0]["pipeline"])
    log(f"model losses (rank 0 / one rank): dp x tp SGD {sgd['loss']:.6f} / "
        f"{sgd['ref_loss']:.6f}; ZeRO-1 {zero1['loss']:.6f} / "
        f"{zero1['ref_loss']:.6f}; pipeline {pipe['loss']:.6f} / "
        f"{pipe['ref_loss']:.6f} (bubble {pipe['bubble']:.3f}); ZeRO-1 "
        f"moments {zero1['moments_gib']:.2f} GiB a rank, "
        f"{zero1['moments_sharded']} leaves cut over data")
    cfg, params = _pm_gpt2_params()
    prompts = _pm_gpt2_prompts(cfg.vocab_size)
    res["gpt2"] = {}
    for key, (label, kw) in PM_GPT2_RUNS.items():
        row = w2[0][key]
        eng = ServingEngine(params, cfg, model=gpt2, device=DEV,
                            **PM_GPT2_KW, **kw)
        for p in prompts:
            eng.submit(p, PM_GPT2_NEW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = [list(r.output) for r in eng.run()]
        wall1 = time.perf_counter() - t0
        st = eng.stats()
        tok1 = (st["tokens_generated"] - len(prompts)) / st["decode_seconds"]
        del eng
        got = row["outputs"]
        what = f"(GPT-2 TP {key}) {label}"
        if kw.get("quantized"):
            check_replay(params, cfg, prompts, got, what, torch.int8,
                         kw["prefill_chunk"], model=gpt2,
                         engine_kw=PM_GPT2_KW, new_tokens=PM_GPT2_NEW)
        else:
            check_plain_forward(params, cfg, prompts, got, what, model=gpt2)
        match = _prefix_match(got, one)[0]
        _pm_log(f"GPT-2 TP {key}", row, "one 8-step decode dispatch")
        log(f"model {what}: tp 2 decode {row['decode_tok_s']:.1f} tok/s "
            f"({PM_NOTE}), wall {row['wall_s']:.2f} s; tp 1 decode "
            f"{tok1:.1f} tok/s, wall {wall1:.2f} s; greedy-prefix match "
            f"with tp 1 {match:.4f}")
        res["gpt2"][key] = dict(
            tp_decode_tok_s=row["decode_tok_s"], tp1_decode_tok_s=tok1,
            tp_wall_s=row["wall_s"], tp1_wall_s=wall1, prefix_match_tp1=match,
            collective_s=row["collective_s"],
            launches=_par_sum(r[key]["launches"] for r in w2),
            device_ms=row.get("device_ms"))
    del params
    torch.cuda.empty_cache()
    lap("gpt2 checks")
    res["launches"] = {key: _par_sum(r[key]["launches"] for r in rows)
                       for key, rows in (("sgd", w4), ("zero1", w4),
                                         ("ep", w4), ("pipeline", w2))}
    res["launches"]["ep_tight"] = _par_sum(r["ep"]["tight"]["launches"]
                                           for r in w4)
    res["launches"]["pipeline_forward"] = _par_sum(
        r["pipeline"]["forward"]["launches"] for r in w2)
    res["rows"] = {key: {k: v for k, v in rows[0][key].items()
                         if k not in ("checksum", "outputs")}
                   for key, rows in (("sgd", w4), ("zero1", w4), ("ep", w4),
                                     ("pipeline", w2))}
    res["peak_gib"] = {job: [r["peak_gib"] for r in rows]
                       for job, rows in worlds.items()}
    log(f"model: seconds by part {res['seconds']}")
    return res


# ---- head dims other than 64 / 128 / 256 (`--head-dims`): every attention
# wrapper pads such a D to the kernel width above it (ops/flash.py
# `kernel_head_dim`) and slices the output back

HD_SEED = SEED + 23   # a generator of its own
PHI2 = (1, 32, 32)    # Phi-2's attention: 32 heads of D80, no GQA
SD15 = (2, 8, 8)      # SD 1.5's attention: 8 heads of D40 / D80 / D160
HD_S = 2048
HD_CTX = 4096         # the decode's context at B8
HD_HIST, HD_CHUNK = 3488, 512
HD_KV_LEN = 3000      # of a BUCKET-key bucket
HD_PAGED = ("paged_decode", "paged_decode_split", "paged_prefill",
            "paged_generic_decode", "paged_prefill_f32")


class _HdCounted(_Counted):
    """_Counted over the public phase's counters and the paged wrappers'."""

    def __enter__(self):
        engine = _launch_counters()
        self.counters = dict(_public_counters(),
                             **{n: engine[n] for n in HD_PAGED})
        for fn in self.counters.values():
            fn.launches = 0
        return self


def _hd_time(res, name, label, call, plain, library, key, nbytes, flops,
             rate, d):
    """A padded mode's times (`_mode_time`: the kernel's device time with
    its own kernels, `key`; the plain version and the library call at the
    true D), its bound at the true D, the device time of every kernel of
    the padded call (zero-padding copies, the kernel, the slice) and the
    share of the padded products' work that the zero lanes waste."""
    from aule_tpu_torch.ops.flash import kernel_head_dim

    width = kernel_head_dim(d)
    t = _mode_time(label, call, plain, library, key, nbytes, flops, rate)
    whole = device_ms(call)
    t.update(device_us=None if t["device_ms"] is None
             else t["device_ms"] * 1e3,
             library_us=None if t["library_device_ms"] is None
             else t["library_device_ms"] * 1e3,
             padded_call_device_ms=whole, head_dim=d, kernel_head_dim=width,
             wasted_share=1.0 - d / width)
    log(f"{label}: every kernel of the padded call {_ms(whole)}; the "
        f"kernel runs at D{width}, {1.0 - d / width:.3f} of its products' "
        f"work on zero lanes; bound at D{d}")
    res["time"][name] = t


def _hd_patch_forward(gen, res, name, shape, s, d, causal):
    """torch's scaled_dot_product_attention through the port's patch at a
    head dim the kernels pad: one TMA forward launch a call at the kernel
    width, held to the plain forward at D and timed beside torch's own
    SDPA at D."""
    import aule_tpu_torch as T
    from aule_tpu_torch.ops import flash as tf
    from aule_tpu_torch.utils import profiling

    b, hq, hkv = shape
    dt = torch.bfloat16
    q = _randn((b, hq, s, d), gen, dt)
    k, v = (_randn((b, hkv, s, d), gen, dt) for _ in range(2))
    label = (f"head dims {name}: SDPA patch B{b} Hq{hq}/Hkv{hkv} S{s} D{d} "
             f"bf16{' causal' if causal else ''}")
    T.install()
    try:
        if T.select_backend() != "cuda":
            raise AssertionError(f"{label}: the patch's backend is "
                                 f"{T.select_backend()}, not cuda")
        call = lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)
        with _HdCounted() as c:
            (o,) = _twice(label, lambda: (call(),))
        _expect(label, c.launches, {"flash_fwd": 2})
        res["launches"][name] = c.launches["flash_fwd"]
        plain = lambda: tf.flash_attention_fwd_plain(
            q, k, v, causal=causal, return_lse=False)
        res["err"][name] = hold(label, o, plain(), None, None, ROW_TOL[dt])
        _hd_time(res, name, label, call, plain,
                 lambda: SDPA(q, k, v, is_causal=causal), "flash_fwd_kernel",
                 2 * (2 * q.numel() + k.numel() + v.numel()),
                 profiling.attention_flops(b, hq, s, s, d, causal),
                 _rate(dt), d)
    finally:
        T.uninstall()


def _hd_backward(gen, res):
    """flash_attention forward and backward through autograd at Phi-2's
    shape (D80 padded to 128 outside the autograd Function): the delta,
    dQ and dK/dV kernels once a backward, the gradients held to the plain
    path's (GRAD_TOL) and flash_attention_bwd's padded route row by row to
    its plain version on the same residuals; the backward timed beside
    SDPA's at D80."""
    import aule_tpu_torch as T
    from aule_tpu_torch.ops import flash_vjp as fv
    from aule_tpu_torch.utils import profiling

    name, d, dt, s = "flash_bwd_d80", 80, torch.bfloat16, HD_S
    b, hq, hkv = PHI2
    q, do = (_randn((b, hq, s, d), gen, dt) for _ in range(2))
    k, v = (_randn((b, hkv, s, d), gen, dt) for _ in range(2))
    label = f"head dims {name}: B{b} Hq{hq}/Hkv{hkv} S{s} D{d} bf16 causal"

    def graph(fn):
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        return xs, fn(*xs)

    def fwd_bwd(fn):
        xs, out = graph(fn)
        return [out.detach(), *torch.autograd.grad(out, xs, do)]

    ours = lambda *x: T.flash_attention(*x, causal=True)
    plain = lambda *x: fv.flash_attention_vjp_plain(*x, True)
    with _HdCounted() as c:
        got = _twice(label + " fwd+bwd", lambda: fwd_bwd(ours))
    _expect(label + " fwd+bwd", c.launches,
            {n: 2 for n in ("flash_fwd", "flash_bwd_delta", "flash_bwd_dq",
                            "flash_bwd_dkv")})
    res["launches"][name] = {n: c.launches[n] for n in (
        "flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkv")}
    want = fwd_bwd(plain)
    _frob(label, got[1:], want[1:])
    # the padded backward row by row against its plain version on the
    # same residuals (the kernels' o and lse at D80)
    o, lse = fv.flash_attention_fwd(q, k, v, causal=True)
    grads = fv.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    pgrads = fv.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    errs = [hold(f"{label} d{n} (flash_attention_bwd, padded)", g, w, None,
                 None, ROW_TOL[dt], floor=BWD_FLOOR)
            for n, g, w in zip("qkv", grads, pgrads)]
    res["err"][name] = tuple(max(e) for e in zip(*errs))
    xs, out = graph(ours)
    pxs, pout = graph(plain)
    ref_xs, ref = graph(lambda *x: SDPA(*x, is_causal=True))
    fwd_flops = profiling.attention_flops(b, hq, s, s, d, True)
    _hd_time(res, name, label + " backward",
             lambda: torch.autograd.grad(out, xs, do, retain_graph=True),
             lambda: torch.autograd.grad(pout, pxs, do, retain_graph=True),
             lambda: torch.autograd.grad(ref, ref_xs, do, retain_graph=True),
             ("flash_bwd_delta_kernel", "flash_bwd_dq_kernel",
              "flash_bwd_dkv_kernel"),
             2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                  + 2 * q.numel()) + 4 * b * hq * s,
             profiling.attention_bwd_flops(fwd_flops, 5), _rate(dt), d)


def _hd_rope_kv_len(gen, res):
    """RoPE fused in the forward with a device-side kv_len at D80: q and k
    padded by halves, the tables widened (cos 1, sin 0), so the pre-pass
    and the TMA kernel's EXT instantiation rotate at D128 unchanged."""
    import aule_tpu_torch as T
    from aule_tpu_torch.ops import flash as tf

    name, d, dt, sq, n = ("flash_fwd_rope_kv_len_d80", 80, torch.bfloat16,
                          512, HD_KV_LEN)
    b, hq, hkv = PHI2
    q = _randn((b, hq, sq, d), gen, dt)
    kp, vp = (_randn((b, hkv, BUCKET, d), gen, dt) for _ in range(2))
    cos, sin = T.precompute_rope_frequencies(BUCKET, d, LLAMA_ROPE_BASE,
                                             device="cuda")
    kvl = torch.full((1,), n, dtype=torch.int32, device="cuda")
    label = (f"head dims {name}: Sq{sq} over kv_len {n} of {BUCKET} keys "
             f"B{b} Hq{hq}/Hkv{hkv} D{d} bf16, RoPE")
    call = lambda: tf.flash_attention_fwd(q, kp, vp, rope_cos=cos,
                                          rope_sin=sin, kv_len=kvl)
    with _HdCounted() as c:
        o, lse = _twice(label, call)
    _expect(label, c.launches, {"flash_fwd": 2, "rope_prepass": 2})
    res["launches"][name] = {"flash_fwd": 2, "rope_prepass": 2}
    plain = lambda: tf.flash_attention_fwd_plain(
        q, kp, vp, rope_cos=cos, rope_sin=sin, kv_len=n)
    po, plse = plain()
    res["err"][name] = hold(label, o, po, lse, plse, ROW_TOL[dt])
    qr, kr = (T.apply_rope(x, cos, sin) for x in (q, kp))
    mask = (torch.arange(BUCKET, device="cuda") < n)[None, None, None]
    _hd_time(res, name, label, call, plain,
             lambda: SDPA(qr, kr, vp, attn_mask=mask),
             ("rope_prepass_kernel", "flash_fwd_kernel"),
             2 * (2 * q.numel() + 2 * b * hkv * n * d) + 4 * (
                 b * hq * sq + BUCKET * d),
             4.0 * b * hq * sq * n * d, _rate(dt), d)


def _hd_f32(gen, res):
    """The f32 forward at D80 (csrc/flash_f32.cu at D128, 3xTF32): rows
    within ROW_TOL[f32] = 1e-5 of the plain version's."""
    from aule_tpu_torch.ops import flash as tf
    from aule_tpu_torch.utils import profiling

    name, d, dt, s = "flash_f32_fwd_d80", 80, torch.float32, HD_S
    b, hq, hkv = PHI2
    q = _randn((b, hq, s, d), gen, dt)
    k, v = (_randn((b, hkv, s, d), gen, dt) for _ in range(2))
    label = f"head dims {name}: B{b} Hq{hq}/Hkv{hkv} S{s} D{d} f32 causal"
    call = lambda: tf.flash_attention_fwd(q, k, v, causal=True)
    with _HdCounted() as c:
        o, lse = _twice(label, call)
    _expect(label, c.launches, {"flash_f32_fwd": 2})
    res["launches"][name] = 2
    plain = lambda: tf.flash_attention_fwd_plain(q, k, v, causal=True)
    po, plse = plain()
    res["err"][name] = hold(label, o, po, lse, plse, ROW_TOL[dt])
    _hd_time(res, name, label, call, plain,
             lambda: SDPA(q, k, v, is_causal=True), "flash_f32_fwd_kernel",
             4 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * hq * s,
             profiling.attention_flops(b, hq, s, s, d, True), _fwd_rate(dt),
             d)


def _hd_pool(gen, lens, d, hkv):
    """A bf16 fused pool (128 lanes) of pages in order holding lens[b]
    tokens of D `d` (the lanes past d zero, as the appends write them),
    page 0 scratch garbage; tables and lengths on the card."""
    from aule_tpu_torch.ops.paged_fused import fused_pool_shape

    used = [-(-n // 16) for n in lens]
    pool = _randn(fused_pool_shape(1 + sum(used), hkv, 16, d), gen)
    pool[..., d:] = 0
    pool[0] = 1e4
    bt = np.full((len(lens), max(used)), -1, np.int32)
    at = 1
    for b, n in enumerate(used):
        bt[b, :n] = np.arange(at, at + n)
        at += n
    return pool, torch.from_numpy(bt).cuda(), torch.tensor(
        lens, dtype=torch.int32, device="cuda")


def _hd_dense(kh, vh, batch, ctx, d):
    """Head-major pages in order -> dense [B, H, ctx, d] bf16 K and V."""
    return tuple(x[..., :d].reshape(x.shape[0], batch, ctx, d).transpose(
        0, 1).to(torch.bfloat16).contiguous() for x in (kh, vh))


def _hd_decode(gen, res):
    """The fused decode at D80 (its q padded to the pool's 128 lanes) over
    bf16, int8 (dot products) and e4m3 pools, and the split decode over
    [Hkv, P, page, 80] pools, padded with q on every call: B8 ctx4096
    Hq32/Hkv32 (Phi-2's heads), timed beside SDPA at D80; the split
    layout's per-call pool copy timed on its own."""
    from aule_tpu_torch.ops import paged as tp
    from aule_tpu_torch.ops import paged_fused as tpf
    from aule_tpu_torch.utils import profiling

    d, batch, ctx = 80, 8, HD_CTX
    _, hq, hkv = PHI2
    pool, bt, ln = _hd_pool(gen, [ctx] * batch, d, hkv)
    q = _randn((batch, hq, d), gen)
    tokens = batch * ctx
    flops = 4.0 * batch * hq * ctx * d
    small = 2 * 2 * q.numel() + bt.numel() * 4 + 4 * batch
    lib_q = q[:, :, None].contiguous()
    for name, qdt in (("paged_decode_d80", None),
                      ("paged_decode_int8_d80", torch.int8),
                      ("paged_decode_fp8_d80", torch.float8_e4m3fn)):
        label = (f"head dims {name}: fused pool B{batch} ctx{ctx} "
                 f"Hq{hq}/Hkv{hkv} D{d} "
                 f"{'bf16' if qdt is None else str(qdt)[6:]}")
        if qdt is None:
            pl, sc = pool, None
            kh, vh = (pool[1:, i].transpose(0, 1) for i in (0, 1))
            kv = profiling.paged_kv_bytes(tokens, hkv, d, 2)
        else:
            pl, sc = quantize_pool(pool, qdt)
            kh, vh = tpf.dequantize_pool(pl[1:], sc[1:])
            kv = profiling.paged_kv_bytes(tokens, hkv, d, 1, scale_bytes=2)
        call = lambda: tpf.paged_attention_fused(q, pl, bt, ln, kv_scales=sc,
                                                 return_lse=True)
        with _HdCounted() as c:
            o, lse = _twice(label, call)
        _expect(label, c.launches, {"paged_decode": 2})
        res["launches"][name] = 2
        plain = lambda: tpf.paged_attention_fused_plain(
            q, pl, bt, ln, kv_scales=sc, return_lse=True)
        po, plse = plain()
        res["err"][name] = hold(label, o, po, lse, plse,
                                _tol(torch.bfloat16, qdt == torch.int8))
        kx, vx = _hd_dense(kh, vh, batch, ctx, d)
        _hd_time(res, name, label, call, plain, lambda: SDPA(lib_q, kx, vx),
                 "paged_decode_kernel", kv + small, flops,
                 profiling.H100_BF16_FLOPS, d)
        del kx, vx, kh, vh
    name = "paged_decode_split_d80"
    kp, vp = (pool[:, i].transpose(0, 1)[..., :d].contiguous()
              for i in (0, 1))
    label = (f"head dims {name}: split pools [Hkv, P, page, {d}] "
             f"B{batch} ctx{ctx} Hq{hq}/Hkv{hkv} bf16")
    call = lambda: tp.paged_attention(q, kp, vp, bt, ln, return_lse=True)
    with _HdCounted() as c:
        o, lse = _twice(label, call)
    _expect(label, c.launches, {"paged_decode_split": 2})
    res["launches"][name] = 2
    plain = lambda: tp.paged_attention_plain(q, kp, vp, bt, ln,
                                             return_lse=True)
    po, plse = plain()
    res["err"][name] = hold(label, o, po, lse, plse, ROW_TOL[torch.bfloat16])
    kx, vx = _hd_dense(kp[:, 1:], vp[:, 1:], batch, ctx, d)
    _hd_time(res, name, label, call, plain, lambda: SDPA(lib_q, kx, vx),
             "splitpools", profiling.paged_kv_bytes(tokens, hkv, d, 2)
             + small, flops, profiling.H100_BF16_FLOPS, d)
    copy = lambda: tp.pad_split_pools(kp, vp, 128)
    pool_bytes = 2 * kp.numel() * 2
    copy_ms = profiling.cuda_time_ms(copy, iters=20)[0]
    copy_dev = device_ms(copy)
    copy_bound = profiling.bound_ms(pool_bytes * (1 + 128 / d), 0)[0]
    res["time"][name].update(pool_copy_ms=copy_ms,
                             pool_copy_device_ms=copy_dev,
                             pool_copy_bound_ms=copy_bound,
                             pool_copy_mb=pool_bytes * 128 / d / 1e6)
    log(f"{label}: its per-call pool copy (both pools padded to 128 lanes, "
        f"{pool_bytes * 128 / d / 1e6:.1f} MB written) device "
        f"{_ms(copy_dev)} (events {copy_ms:.4f} ms), bound "
        f"{copy_bound:.4f} ms")


def _hd_prefill(gen, res):
    """The chunked prefill at D80: a 512-token chunk at q_offset 3488 over
    4000 cached tokens, bf16 pool, Hq32/Hkv32, timed beside SDPA with a
    positional mask at D80."""
    from aule_tpu_torch.ops import paged_prefill as tpp
    from aule_tpu_torch.utils import profiling

    name, d = "paged_prefill_d80", 80
    _, hq, hkv = PHI2
    total = HD_HIST + HD_CHUNK
    pool, bt, ln = _hd_pool(gen, [total], d, hkv)
    q = _randn((1, hq, HD_CHUNK, d), gen)
    qoff = torch.tensor([HD_HIST], dtype=torch.int32, device="cuda")
    label = (f"head dims {name}: chunk {HD_CHUNK} at q_offset {HD_HIST} over "
             f"{total}, Hq{hq}/Hkv{hkv} D{d} bf16 pool")
    call = lambda: tpp.paged_attention_prefill(q, pool, bt, ln,
                                               q_offsets=qoff,
                                               return_lse=True)
    with _HdCounted() as c:
        o, lse = _twice(label, call)
    _expect(label, c.launches, {"paged_prefill": 2})
    res["launches"][name] = 2
    plain = lambda: tpp.paged_attention_prefill_plain(
        q, pool, bt, ln, q_offsets=qoff, return_lse=True)
    po, plse = plain()
    res["err"][name] = hold(label, o, po, lse, plse, ROW_TOL[torch.bfloat16])
    kh, vh = (pool[1:, i].transpose(0, 1) for i in (0, 1))
    npages = -(-total // 16)
    kx, vx = (x[:, :, :total] for x in _hd_dense(kh, vh, 1, npages * 16, d))
    rows = torch.arange(HD_HIST, total, device="cuda")[:, None]
    mask = torch.arange(total, device="cuda")[None] <= rows
    _hd_time(res, name, label, call, plain,
             lambda: SDPA(q, kx, vx, attn_mask=mask), "paged_prefill_kernel",
             profiling.paged_kv_bytes(total, hkv, d, 2) + 2 * 2 * q.numel()
             + bt.numel() * 4,
             profiling.paged_prefill_flops([HD_HIST], [HD_CHUNK], hq, d),
             profiling.H100_BF16_FLOPS, d)


def check_head_dims() -> dict:
    """Every attention wrapper at head dims the kernels pad: the SDPA patch
    at SD 1.5's D40 (B2 H8 S4096) and D160 (S256) and Phi-2's D80 (B1 Hq32
    S2048 causal); flash forward and backward at D80; RoPE with kv_len at
    D80; f32 at D80; the fused decode at D80 over bf16, int8 and e4m3
    pools and the split decode (its pool copy timed apart); a D80 prefill
    chunk.  Each call twice with the same bits, its launches counted,
    held to its plain version at the true D and timed beside SDPA at the
    true D."""
    res = {"launches": {}, "err": {}, "time": {}}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(HD_SEED)
    _hd_patch_forward(gen, res, "flash_fwd_d80", PHI2, HD_S, 80, True)
    _hd_patch_forward(gen, res, "flash_fwd_d40", SD15, 4096, 40, False)
    _hd_patch_forward(gen, res, "flash_fwd_d160", SD15, 256, 160, False)
    _hd_backward(gen, res)
    _hd_rope_kv_len(gen, res)
    _hd_f32(gen, res)
    torch.cuda.empty_cache()
    _hd_decode(gen, res)
    torch.cuda.empty_cache()
    _hd_prefill(gen, res)
    return res


# (entry, source, TPU kernel, shape) of the padded modes, in
# check_head_dims' order
HD_FWD_ROW = "aule_tpu/ops/flash.py:92 (_fwd_kernel; its blocks take the full D)"
HD_ENTRIES = [
    ("flash_fwd_d80", "aule_tpu_torch/csrc/flash_fwd.cu",
     HD_FWD_ROW + "; aule_tpu/ops/flash.py:638 (_mono_kernel)",
     f"B1 Hq32/Hkv32 S{HD_S} D80 bf16 causal (Phi-2's attention) through "
     f"the SDPA patch, padded to D128 (library: torch's SDPA at D80)"),
    ("flash_fwd_d40", "aule_tpu_torch/csrc/flash_fwd.cu", HD_FWD_ROW,
     "B2 Hq8/Hkv8 S4096 D40 bf16 (SD 1.5's) through the SDPA patch, padded "
     "to D64 (library: torch's SDPA at D40)"),
    ("flash_fwd_d160", "aule_tpu_torch/csrc/flash_fwd.cu", HD_FWD_ROW,
     "B2 Hq8/Hkv8 S256 D160 bf16 (SD 1.5's) through the SDPA patch, padded "
     "to D256 (library: torch's SDPA at D160)"),
    ("flash_bwd_d80", "aule_tpu_torch/csrc/flash_bwd.cu",
     "aule_tpu/ops/flash_vjp.py:127 (_dq_kernel); aule_tpu/ops/flash_vjp.py"
     ":271 (_dkv_kernel); delta (flash_vjp.py:746, an XLA fusion in JAX)",
     f"B1 Hq32/Hkv32 S{HD_S} D80 bf16 causal backward (delta, dQ, dK/dV at "
     f"D128, the padding outside the autograd Function; library: SDPA's "
     f"backward at D80)"),
    ("flash_fwd_rope_kv_len_d80", "aule_tpu_torch/csrc/flash_fwd.cu",
     HD_FWD_ROW + ", use_rope l.227-246 and dynamic_kv_len l.108, 121, 136",
     f"B1 Hq32/Hkv32 Sq512 over kv_len {HD_KV_LEN} of {BUCKET} keys, D80 "
     f"bf16, RoPE (q and k padded by halves, the tables widened; the "
     f"pre-pass rope_prepass.cu counted in launches_by_kernel; library: "
     f"SDPA on the rotated q, k with a key mask)"),
    ("flash_f32_fwd_d80", "aule_tpu_torch/csrc/flash_f32.cu",
     HD_FWD_ROW + ", its f32 branch at Precision.HIGHEST, l.147-152",
     f"B1 Hq32/Hkv32 S{HD_S} D80 f32 causal, padded to D128 (library: "
     f"SDPA f32)"),
    ("paged_decode_d80", "aule_tpu_torch/csrc/paged_decode.cu",
     "aule_tpu/ops/paged_fused.py:213 (_fused_decode_kernel; JAX pads q "
     "to the pool's lanes)",
     f"B8 ctx{HD_CTX} Hq32/Hkv32 D80 in a 128-lane bf16 pool (library: "
     f"SDPA on the gathered K/V at D80)"),
    ("paged_decode_int8_d80", "aule_tpu_torch/csrc/paged_decode.cu",
     "aule_tpu/ops/paged_fused.py:213 (_fused_decode_kernel) int8 mode",
     f"as paged_decode_d80, int8 pool with bf16 scales, int8 dot products "
     f"(library: SDPA on the dequantized K/V)"),
    ("paged_decode_fp8_d80", "aule_tpu_torch/csrc/paged_decode.cu",
     "aule_tpu/ops/paged_fused.py:213 (_fused_decode_kernel) fp8 mode",
     "as paged_decode_d80, e4m3 pool with bf16 scales"),
    ("paged_decode_split_d80", "aule_tpu_torch/csrc/paged_decode.cu",
     "aule_tpu/ops/paged.py:45 (_paged_decode_kernel; JAX pads the pools "
     "on each call, paged.py:366-374)",
     f"B8 ctx{HD_CTX} Hq32/Hkv32 split bf16 pools [Hkv, P, page, 80] "
     f"padded with q to 128 lanes on every call (the copy's own time under "
     f"pool_copy_*; library: SDPA on the K/V at D80)"),
    ("paged_prefill_d80", "aule_tpu_torch/csrc/paged_prefill.cu",
     "aule_tpu/ops/paged_fused.py:770 (_fused_prefill_kernel)",
     f"B1 Hq32/Hkv32 D80, chunk {HD_CHUNK} at q_offset {HD_HIST} over "
     f"{HD_HIST + HD_CHUNK} in a 128-lane bf16 pool (library: SDPA with a "
     f"positional mask at D80)"),
]


def head_dim_entries(entries, hd) -> None:
    """The head-dim phase's padded modes as entries: launches on its
    counted calls, errors against the plain version at the true D, device
    µs, the bound at the true D, the share of the padded products wasted
    on zero lanes, the library µs."""
    for name, src, row, shape in HD_ENTRIES:
        n = hd["launches"][name]
        by_kernel = n if isinstance(n, dict) else None
        launches = sum(n.values()) if by_kernel else n
        if launches == 0:
            raise AssertionError(f"{name} was not launched in the head-dim "
                                 f"phase")
        t = hd["time"][name]
        err = tuple(hd["err"][name]) + (0.0,) * (3 - len(hd["err"][name]))
        extra = {k: t[k] for k in (
            "device_ms", "device_us", "library_device_ms", "library_us",
            "padded_call_device_ms", "head_dim", "kernel_head_dim",
            "wasted_share", "pool_copy_ms", "pool_copy_device_ms",
            "pool_copy_bound_ms", "pool_copy_mb") if k in t}
        if by_kernel:
            extra["launches_by_kernel"] = by_kernel
        entries.append(_entry(name, src, row, launches, err, t, shape,
                              phase="head dims", **extra))


# ---- the serving front ends (`--frontends`): the HTTP server, the replica
# pools and the process pools over the port's engine on the card

FE_SEED = SEED + 24   # the prompts' generator
FE_LAYERS = 4         # Llama-3-8B at full width, 4 of its 32 layers
FE_NEW = 32
FE_BLOCKING = (7, 300, 1000, 2000)
FE_STREAMS = (7, 64, 129, 300, 511, 700, 1000, 2000)
FE_CANCEL_NEW = 256   # the cancelled streams' max_tokens
FE_REPS = 3           # (f1)'s runs of each prompt, direct and over HTTP
# the JAX worker's engine (tests/test_multihost.py) on the tiny Llama
FE_TINY_KW = dict(max_batch=2, page_size=16, num_pages=64,
                  max_pages_per_seq=8, max_seq_len=256)
FE_TINY_PROMPTS = (5, 9, 7, 12)
FE_TINY_NEW = 4
FE_COUNTED = ("flash_fwd", "flash_fwd_short", "paged_decode")


def _fe_post(port, path, obj, timeout=300):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _fe_health(port):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                timeout=60) as resp:
        return json.loads(resp.read())


def _fe_open_stream(port, prompt, n):
    """A streaming completion request: (connection, response)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/v1/completions",
                 json.dumps({"prompt": [int(t) for t in prompt],
                             "max_tokens": n, "stream": True}),
                 {"Content-Type": "application/json"})
    return conn, conn.getresponse()


def _fe_read_stream(resp, t0):
    """(token lines' tokens, the request id, the done line, seconds to the
    first token) of a streamed response read to its end."""
    toks, rid, first = [], None, None
    for raw in resp:
        if not raw.strip():
            continue
        line = json.loads(raw)
        if "token" in line:
            if first is None:
                first = time.perf_counter() - t0
            rid = line["id"]
            toks.append(line["token"])
        else:
            resp.read()  # the chunked body's end
            return toks, rid, line, first
    raise AssertionError("a stream ended without its done line")


def _fe_agree(params, cfg, prompts, got, want, what):
    """The spec phase's rule: each pair compared up to its first parting
    (`_prefix_match`), a parting credited when both tokens sit within
    NEAR_TIE of the plain forward's max (`_divergence_gaps`); the raw and
    the credited agreement logged, the credited one must be 1.0."""
    match, same, total, first = _prefix_match(got, want)
    gaps = _divergence_gaps(params, cfg, prompts, got, want, first)
    decisive = sum(max(gp) > NEAR_TIE for gp in gaps)
    credited = (same + len(gaps) - decisive) / max(total, 1)
    log(f"frontends {what}: raw agreement {match:.4f} ({same} of {total} "
        f"compared tokens, {len(gaps)} partings, gaps "
        f"{[tuple(round(x, 4) for x in gp) for gp in gaps]}); near-tie-"
        f"credited {credited:.4f}")
    if credited != 1.0:
        raise AssertionError(f"frontends {what}: {decisive} partings not at "
                             f"a near-tie")
    return {"raw": match, "credited": credited, "partings": len(gaps)}


def _fe_http(params, cfg, res):
    """(f1)-(f3) on one engine behind ServingHTTPServer."""
    import threading

    from aule_tpu_torch.serving import ServingHTTPServer
    from aule_tpu_torch.serving.engine import ServingEngine

    rng = np.random.default_rng(FE_SEED)
    blocking = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                for n in FE_BLOCKING]
    streams = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in FE_STREAMS]
    eng = ServingEngine(params, cfg, device=DEV, **ENGINE_KW)
    free0 = eng.allocator.num_free
    eng.submit(blocking[0], 2)  # warm-up: first-use set-up off the clock
    eng.run()
    direct, direct_s = [], []
    for p in blocking:  # FE_REPS runs each: the median's seconds
        times, outs = [], []
        for _ in range(FE_REPS):
            t0 = time.perf_counter()
            eng.submit(p, FE_NEW)
            outs.append(list(eng.run()[0].output))
            times.append(time.perf_counter() - t0)
        if any(o != outs[0] for o in outs):
            raise AssertionError("frontends (f1): two direct runs of one "
                                 "prompt differ")
        direct.append(outs[0])
        direct_s.append(float(np.median(times)))
    for p in streams:
        eng.submit(p, FE_NEW)
    t0 = time.perf_counter()
    batch = [list(r.output) for r in eng.run()]
    batch_s = time.perf_counter() - t0
    retired = {}
    retire = eng._retire

    def spy(slot):  # each request's output as the engine retires it
        r = eng.slots[slot]
        retired[r.req_id] = (list(r.output), r.cancelled)
        return retire(slot)

    eng._retire = spy
    with ServingHTTPServer(eng) as srv:
        port = srv.port
        http_s = []
        for i, p in enumerate(blocking):
            times = []
            for _ in range(FE_REPS):
                t0 = time.perf_counter()
                out = _fe_post(port, "/v1/completions",
                               {"prompt": p.tolist(), "max_tokens": FE_NEW})
                times.append(time.perf_counter() - t0)
                if out["tokens"] != direct[i] or out["cancelled"]:
                    raise AssertionError(f"frontends (f1): the HTTP tokens "
                                         f"of prompt {len(p)} differ from "
                                         f"the engine's direct run")
            http_s.append(float(np.median(times)))
        over = [1e3 * (h - d) for h, d in zip(http_s, direct_s)]
        tok = FE_NEW * len(blocking)
        res["f1"] = dict(prompt_lens=list(FE_BLOCKING), direct_s=direct_s,
                         http_s=http_s, http_overhead_ms=over,
                         direct_tok_s=tok / sum(direct_s),
                         http_tok_s=tok / sum(http_s))
        log(f"frontends (f1): {len(blocking)} blocking requests of "
            f"{list(FE_BLOCKING)} prompt tokens, {FE_NEW} new each, "
            f"{FE_REPS} times each, equal token for token to the engine's "
            f"direct runs; medians: direct "
            f"{[round(x * 1e3, 1) for x in direct_s]} ms, HTTP "
            f"{[round(x * 1e3, 1) for x in http_s]} ms, overhead a request "
            f"{[round(x, 2) for x in over]} ms; {tok / sum(http_s):.1f} tok/s "
            f"through HTTP against {tok / sum(direct_s):.1f} direct")

        got, running = [None] * len(streams), []
        stop = threading.Event()

        def stream(i):
            t0 = time.perf_counter()
            conn, resp = _fe_open_stream(port, streams[i], FE_NEW)
            got[i] = _fe_read_stream(resp, t0) + (time.perf_counter() - t0,)
            conn.close()

        def poll():
            while not stop.is_set():
                running.append(_fe_health(port)["running"])
                time.sleep(0.02)

        poller = threading.Thread(target=poll)
        poller.start()
        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(len(streams))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        stop.set()
        poller.join(timeout=30)
        if any(g is None for g in got):
            raise AssertionError("frontends (f2): a stream did not finish")
        for i, (toks, rid, done, first, _) in enumerate(got):
            if (not done.get("done") or done.get("cancelled")
                    or done["id"] != rid or len(toks) != FE_NEW
                    or retired.get(rid) != (toks, False)):
                raise AssertionError(f"frontends (f2): stream {i} gave "
                                     f"{len(toks)} tokens, done line {done}, "
                                     f"the engine's request "
                                     f"{retired.get(rid)}")
        health = _fe_health(port)
        if max(running) < 2:
            raise AssertionError(f"frontends (f2): /health never showed two "
                                 f"running requests ({sorted(set(running))})")
        ttft = [g[3] for g in got]
        agree = _fe_agree(params, cfg, streams, [g[0] for g in got], batch,
                          "(f2) streams against the direct batch")
        res["f2"] = dict(prompt_lens=list(FE_STREAMS), wall_s=wall,
                         tok_s=FE_NEW * len(streams) / wall,
                         direct_batch_s=batch_s,
                         direct_batch_tok_s=FE_NEW * len(streams) / batch_s,
                         first_token_s=ttft, max_running=max(running),
                         agreement=agree)
        log(f"frontends (f2): {len(streams)} concurrent streams, each's "
            f"tokens its engine request's, up to {max(running)} running at "
            f"once (/health); {FE_NEW * len(streams) / wall:.1f} tok/s in "
            f"{wall:.2f} s against the direct batch's "
            f"{FE_NEW * len(streams) / batch_s:.1f} tok/s; time to the first "
            f"streamed token {min(ttft):.3f}-{max(ttft):.3f} s (median "
            f"{sorted(ttft)[len(ttft) // 2]:.3f}); /health after: "
            f"{health['tokens_generated']} tokens, {health['decode_steps']} "
            f"decode steps")

        # (f3) one /v1/cancel mid-stream, one client disconnect
        t0 = time.perf_counter()
        conn, resp = _fe_open_stream(port, streams[3], FE_CANCEL_NEW)
        first = json.loads(resp.readline())
        ok = _fe_post(port, "/v1/cancel", {"id": first["id"]})
        toks, _, done, _ = _fe_read_stream(resp, t0)
        conn.close()
        if not (ok["cancelled"] and done["cancelled"]
                and len(toks) + 1 < FE_CANCEL_NEW):
            raise AssertionError(f"frontends (f3): /v1/cancel gave {ok}, the "
                                 f"stream {len(toks) + 1} tokens and {done}")
        conn, resp = _fe_open_stream(port, streams[4], FE_CANCEL_NEW)
        gone = json.loads(resp.readline())["id"]
        conn.close()
        deadline = time.time() + 60
        while time.time() < deadline:
            h = _fe_health(port)
            if h["running"] == 0 and h["waiting"] == 0:
                break
            time.sleep(0.05)
        else:
            raise AssertionError("frontends (f3): the disconnected stream "
                                 "still runs after 60 s")
    eng._retire = retire
    lost = retired.get(gone)
    free = eng.allocator.num_free
    if free != free0 or lost is None or not lost[1] \
            or len(lost[0]) >= FE_CANCEL_NEW:
        raise AssertionError(f"frontends (f3): {free} of {free0} pages free, "
                             f"the disconnected request {lost}")
    res["f3"] = dict(cancel_tokens=len(toks) + 1,
                     disconnect_tokens=len(lost[0]), free_pages=free)
    log(f"frontends (f3): /v1/cancel stopped its stream after "
        f"{len(toks) + 1} of {FE_CANCEL_NEW} tokens, a client disconnect "
        f"after {len(lost[0])}; every page back ({free} of {free0} free)")
    return eng, streams


def _fe_pool(params, cfg, eng, prompts, res):
    """(f4) an EngineReplicaPool of 1 and of 2 replicas on the card; the 2
    replicas' tokens held to the solo runs by `_fe_agree`."""
    from aule_tpu_torch.serving import EngineReplicaPool
    from aule_tpu_torch.serving.engine import ServingEngine

    solo = []
    for p in prompts:
        eng.submit(p, FE_NEW)
        solo.append(list(eng.run()[0].output))
    rows = {}
    second = ServingEngine(params, cfg, device=DEV, **ENGINE_KW)
    for n, engines in ((1, [eng]), (2, [eng, second])):
        pool = EngineReplicaPool(engines)
        for p in prompts:
            pool.submit(p, FE_NEW)
        out = [list(r.output) for r in pool.run()]
        rows[n] = dict(tok_s=pool.stats.tokens_per_s,
                       wall_s=pool.stats.wall_s, outputs=out)
    agree = _fe_agree(params, cfg, prompts, rows[2]["outputs"], solo,
                      "(f4) 2 replicas against the solo runs")
    raw1 = _prefix_match(rows[1]["outputs"], solo)[0]
    res["f4"] = dict(tok_s_1=rows[1]["tok_s"], tok_s_2=rows[2]["tok_s"],
                     wall_s_1=rows[1]["wall_s"], wall_s_2=rows[2]["wall_s"],
                     agreement_2=agree, raw_agreement_1=raw1)
    log(f"frontends (f4): EngineReplicaPool of {len(prompts)} requests, "
        f"{FE_NEW} new each: 1 replica {rows[1]['tok_s']:.1f} tok/s, 2 "
        f"replicas {rows[2]['tok_s']:.1f} tok/s; the replicas time-share "
        f"one card, so this measures the pool's scheduler, not scaling "
        f"(1 replica's raw agreement with the solo runs {raw1:.4f})")
    del second
    torch.cuda.empty_cache()


def _fe_process_pools(res):
    """(f5) MultiProcessServingPool of 2 spawned workers on the card over
    multiprocessing queues and over TCP, the JAX worker's tiny Llama from
    model_seed 0: each request's tokens equal the parent's engine built
    from the same seed on the card.  The workers load this checkout's
    kernel library (AULE_TPU_TORCH_NO_BUILD: a worker that finds none
    fails, it builds no copy)."""
    from aule_tpu_torch.models import llama
    from aule_tpu_torch.serving import MultiProcessServingPool
    from aule_tpu_torch.serving.engine import ServingEngine

    cfg = llama.LlamaConfig.tiny()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    eng = ServingEngine(llama.init_params(cfg, gen, device=DEV), cfg,
                        device=DEV, **FE_TINY_KW)
    rng = np.random.default_rng(FE_SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in FE_TINY_PROMPTS]
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    want = []
    for p in prompts:
        eng.submit(p, FE_TINY_NEW)
        want.append(list(eng.run()[0].output))
    tiny = {n: fn.launches for n, fn in counters.items() if fn.launches}
    if not (tiny.get("flash_fwd_f32") and tiny.get("paged_generic_decode")):
        raise AssertionError(f"frontends (f5): the parent's tiny engine "
                             f"(f32, D{cfg.head_dim}) launched {tiny}")
    log(f"frontends (f5): the parent's engine, tiny Llama f32 D"
        f"{cfg.head_dim} (padded to the kernels' 64): launches {tiny}")
    res["f5"] = {"parent_launches": tiny}
    for transport in ("mp", "tcp"):
        t0 = time.perf_counter()
        pool = MultiProcessServingPool(
            2, dict(FE_TINY_KW, device=DEV), model_seed=0,
            transport=transport, warm={"lens": [5], "new_tokens": 2},
            worker_env={"AULE_TPU_TORCH_NO_BUILD": "1"})
        try:
            start = time.perf_counter() - t0
            t1 = time.perf_counter()
            gids = [pool.submit(p, FE_TINY_NEW) for p in prompts]
            got = pool.collect(timeout_s=300)
            serve = time.perf_counter() - t1
        finally:
            pool.shutdown()
        bad = [i for i, g in enumerate(gids) if got[g][1] != want[i]]
        if bad:
            raise AssertionError(f"frontends (f5) {transport}: requests {bad} "
                                 f"differ from the parent's engine")
        workers = sorted({got[g][0] for g in gids})
        res["f5"][transport] = dict(
            worker_start_s={int(k): v for k, v in pool.ready_s.items()},
            pool_start_s=start, serve_s=serve, workers_used=workers)
        log(f"frontends (f5) {transport}: 2 workers on the card, start-up "
            f"{ {k: round(v, 2) for k, v in sorted(pool.ready_s.items())} } s "
            f"(spawn, CUDA, the library loaded, warm); {len(prompts)} "
            f"requests in {serve:.2f} s on workers {workers}, each equal to "
            f"the parent's engine")


def check_frontends() -> dict:
    """The serving front ends on the card: (f1) blocking HTTP requests
    token-exact against the same engine's direct runs, (f2) concurrent
    NDJSON streams against a direct batch, (f3) /v1/cancel and a client
    disconnect with every page back, (f4) the in-process replica pool,
    (f5) the process pools over mp and TCP.  Llama-3-8B at full width on
    FE_LAYERS layers, bf16, fused pools; the launch counts set to 0 before
    (f1)-(f4) and read after."""
    from aule_tpu_torch.models import llama

    t_start = time.perf_counter()
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=FE_LAYERS)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    params = llama.init_params(cfg, gen, device=DEV)
    res = {}
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    eng, streams = _fe_http(params, cfg, res)
    _fe_pool(params, cfg, eng, streams, res)
    res["launches"] = {n: counters[n].launches for n in FE_COUNTED}
    log(f"frontends: launches of (f1)-(f4) {res['launches']}")
    for n, count in res["launches"].items():
        if count == 0:
            raise AssertionError(f"frontends: {n} was not launched")
    del eng, params
    torch.cuda.empty_cache()
    _fe_process_pools(res)
    res["seconds"] = time.perf_counter() - t_start
    log(f"frontends: {res['seconds']:.1f} s")
    return res


def add_frontend_launches(entries, fe) -> None:
    """Add the front ends' launches ((f1)-(f4)) to the entries of the
    kernel modes they launch."""
    by_name = {e["name"]: e for e in entries}
    for name in FE_COUNTED:
        by_name[name]["launches"] += fe["launches"][name]
        by_name[name]["launches_frontends"] = fe["launches"][name]


# ---- the port's entry points and scripts (`--scripts`): entry(), the
# serve and train demos, the scaling report, the multi-chip and multi-host
# dry runs and the profiling helpers, each called as a user calls it

SC_SEED = SEED + 25   # (x7)'s inputs
SC_BENCH_TOL = 0.10   # profiling.benchmark against cuda_time_ms's median
# the kernel modes the in-process scripts launch: (entry, [(run, counter)])
SCRIPTS_LAUNCHES = [
    ("flash_fwd_d64", [("x1", "flash_fwd"), ("x4", "flash_fwd")]),
    ("paged_decode_d64", [("x4", "paged_decode")]),
    ("paged_generic_decode_int8", [("x2 int8", "paged_generic_decode")]),
    ("paged_prefill_f32_int8", [("x2 int8", "paged_prefill_f32")]),
    ("paged_generic_decode_f32", [("x2 spec", "paged_generic_decode")]),
    ("paged_prefill_f32", [("x2 spec", "paged_prefill_f32")]),
    ("flash_f32_fwd_gpt2_f32", [("x2 spec", "flash_fwd_f32")]),
]


def _sc_counts(counters, before=None) -> dict:
    """The launches since `before` (a snapshot) or since the counts were
    set to 0, the kernels that launched."""
    before = before or {}
    out = {n: c.launches - before.get(n, 0) for n, c in counters.items()}
    return {n: k for n, k in out.items() if k}


def _sc_zero(counters) -> None:
    for c in counters.values():
        c.launches = 0


def _sc_entry(res, counters):
    """(x1) entry() on the card: the JAX entry's Llama-style model (dim 512,
    4 layers, 8 / 2 heads, D64) in bf16 on tokens [2, 512], one flash
    launch a layer; each position's argmax held to the plain forward's
    logits by the engine phase's judge (its argmax or within NEAR_TIE)."""
    from aule_tpu_torch import entry
    from aule_tpu_torch.models import llama
    from aule_tpu_torch.ops.flash_vjp import flash_attention_vjp_plain

    fn, (params, tokens) = entry.entry()
    cfg = fn.cfg
    _sc_zero(counters)
    t0 = time.perf_counter()
    logits = fn(params, tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _sc_counts(counters)
    if launches != {"flash_fwd": cfg.n_layers}:
        raise AssertionError(f"scripts (x1): entry()'s forward launched "
                             f"{launches}, not flash_fwd once a layer")
    with torch.no_grad():
        ref = llama.forward(params, tokens, cfg,
                            attention=flash_attention_vjp_plain)
    agree = _Agreement("scripts (x1) entry()")
    for b in range(tokens.shape[0]):
        agree.add(ref[b], logits[b].argmax(dim=-1), f"sequence {b}")
    agree.report("the plain forward (each position's argmax)")
    err = float((logits - ref).abs().max())
    res["x1"] = dict(launches=launches, shape=list(logits.shape),
                     exact=agree.exact, near_ties=agree.ties,
                     max_gap=agree.gap, max_abs_err=err, wall_s=wall)
    log(f"scripts (x1): entry() {str(cfg.dtype)[6:]} D{cfg.head_dim} group "
        f"{cfg.n_heads // cfg.n_kv_heads} logits {list(logits.shape)} in "
        f"{wall * 1e3:.1f} ms (the first call), launches {launches}, max "
        f"|logit - plain| {err:.4f}")


def _sc_serve(res, counters):
    """(x2) examples/serve_demo.main() on the card, each engine's run
    counted apart (the int8 engine with chunked prefill and the prefix
    cache; the speculative engine, f32 pools): the greedy request held to a
    teacher-forced plain forward, the speculative request equal to a plain
    engine's greedy tokens (and held the same way), the sampled request in
    the vocabulary with finite log-probabilities, prefix-cache hits."""
    from aule_tpu_torch.examples import serve_demo
    from aule_tpu_torch.models import llama
    from aule_tpu_torch.serving.engine import ServingEngine

    cfg = llama.LlamaConfig.tiny()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, device=DEV)
    runs = {}
    real = serve_demo.ServingEngine

    class Counted(real):
        def run(self, *args, **kw):
            before = {n: c.launches for n, c in counters.items()}
            out = super().run(*args, **kw)
            runs["x2 spec" if self.spec_tokens else "x2 int8"] = \
                _sc_counts(counters, before)
            return out

    serve_demo.ServingEngine = Counted
    t0 = time.perf_counter()
    try:
        out = serve_demo.main(params=params)
    finally:
        serve_demo.ServingEngine = real
    wall = time.perf_counter() - t0
    a, b = out["prompts"]
    greedy, sampled = out["requests"]
    spec = out["spec_requests"][0].output
    check_plain_forward(params, cfg, [a], [greedy.output],
                        "scripts (x2) int8 chunk 16")
    eng = ServingEngine(params, cfg, device=DEV, **serve_demo.ENGINE_KW)
    eng.submit(a, max_new_tokens=len(spec))
    plain = eng.run()[0].output
    if spec != plain:
        raise AssertionError(f"scripts (x2): the speculative tokens {spec} "
                             f"are not the plain engine's {plain}")
    check_plain_forward(params, cfg, [a], [plain], "scripts (x2) speculative")
    with torch.no_grad():
        seq = np.concatenate([b, np.asarray(sampled.output[:-1], np.int32)])
        lp = torch.log_softmax(llama.forward(
            params, torch.from_numpy(seq.astype(np.int64))[None].to(DEV),
            cfg)[0, len(b) - 1:], dim=-1)
        picked = lp.gather(1, torch.tensor(sampled.output, device=DEV)[:, None])
    if not (bool(torch.isfinite(picked).all())
            and all(0 <= t < cfg.vocab_size for t in sampled.output)):
        raise AssertionError(f"scripts (x2): sampled tokens "
                             f"{sampled.output} outside the model's support")
    hits = out["prefix_cache_hit_tokens"]
    if hits <= 0:
        raise AssertionError("scripts (x2): no prefix-cache hit")
    if out["streamed"] != {greedy.req_id: greedy.output,
                           sampled.req_id: sampled.output}:
        raise AssertionError("scripts (x2): streamed tokens differ")
    res["x2"] = dict(greedy=greedy.output, sampled=sampled.output,
                     spec=spec, prefix_cache_hit_tokens=hits,
                     spec_accepted=out["spec_accepted"],
                     spec_drafted=out["spec_drafted"], wall_s=wall)
    res["launches"].update(runs)
    log(f"scripts (x2): serve_demo in {wall:.2f} s: greedy {greedy.output}, "
        f"T=1.2 {sampled.output}, prefix-cache hits {hits} tokens, "
        f"speculative {spec} (= the plain engine's), accepted "
        f"{out['spec_accepted']} / {out['spec_drafted']}; tiny Llama f32 "
        f"D{cfg.head_dim} (padded to the kernels' 64); launches {runs}")


def _sc_train(res, counters):
    """(x3) examples/train_demo.main() in a gloo world of 8 ranks on the
    one card ((data 4, model 2), ZeRO-1 AdamW on the bf16 tiny Llama):
    the losses finite and falling, the step resumed from the checkpoint
    equal, bit for bit on every rank, to a seventh step without it."""
    from aule_tpu_torch.examples import train_demo

    t0 = time.perf_counter()
    out = train_demo.main()
    wall = time.perf_counter() - t0
    losses = out["losses"]
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"scripts (x3): losses {losses}")
    if not out["resumed_equal"] or out["resumed_loss"] != \
            out["seventh_loss"]:
        raise AssertionError(f"scripts (x3): the resumed step differs from "
                             f"the seventh: {out}")
    res["x3"] = dict(losses=losses, resumed_loss=out["resumed_loss"],
                     wall_s=wall)
    log(f"scripts (x3): train_demo, 8 gloo ranks on the card, in "
        f"{wall:.2f} s: losses {[round(x, 4) for x in losses]}, resumed "
        f"step {out['resumed_loss']:.4f} equal to the seventh on every "
        f"rank")


def _sc_scaling(res, counters):
    """(x4) scripts/scaling_report at 1 and 2 in-process replicas on the
    card (the 512-wide Llama in bf16, 4 layers, 8 requests of 32 new
    tokens): its lines carry the card's name and power limit; every
    request's tokens held to a teacher-forced plain forward."""
    from aule_tpu_torch.models import llama
    from aule_tpu_torch.scripts import scaling_report

    _sc_zero(counters)
    t0 = time.perf_counter()
    out = scaling_report.main(["--replicas", "1", "2"])
    wall = time.perf_counter() - t0
    res["launches"]["x4"] = _sc_counts(counters)
    cfg = scaling_report.report_cfg(4, torch.device(DEV))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, device=DEV)
    prompts = scaling_report.report_prompts(8)
    for n in (1, 2):
        check_plain_forward(params, cfg, prompts, out[n]["outputs"],
                            f"scripts (x4) {n} replicas")
    res["x4"] = {n: {k: v for k, v in out[n].items() if k != "outputs"}
                 for n in (1, 2)}
    res["x4"]["wall_s"] = wall
    log(f"scripts (x4): scaling_report in {wall:.2f} s, launches "
        f"{res['launches']['x4']}")


def _sc_dryruns(res, counters):
    """(x5) entry.dryrun_multichip(4, backend="gloo"): gloo worlds of 4
    and 2 ranks sharing the card; every check meets its threshold (the
    function asserts them).  (x6) entry.dryrun_multihost(2,
    backend="gloo"): 4 worker processes on the card, 2 hosts of 2."""
    from aule_tpu_torch import entry

    t0 = time.perf_counter()
    out = entry.dryrun_multichip(4, backend="gloo")
    res["x5"] = dict(out, wall_s=time.perf_counter() - t0)
    log(f"scripts (x5): dryrun_multichip(4, gloo) in "
        f"{res['x5']['wall_s']:.2f} s")
    t0 = time.perf_counter()
    losses = entry.dryrun_multihost(2, backend="gloo")
    if len(losses) != 4 or len(set(losses)) != 1:
        raise AssertionError(f"scripts (x6): worker losses {losses}")
    res["x6"] = dict(losses=losses, wall_s=time.perf_counter() - t0)
    log(f"scripts (x6): dryrun_multihost(2, gloo) in "
        f"{res['x6']['wall_s']:.2f} s")


def _sc_profiling(res, counters):
    """(x7) utils/profiling.benchmark on the Llama-3-8B layer's flash
    forward (B1 Hq32/Hkv8 S2048 D128 bf16 causal) within SC_BENCH_TOL of
    cuda_time_ms's median; trace() writes a Chrome trace that names the
    kernel."""
    import tempfile

    from aule_tpu_torch.ops.flash import flash_fwd_tma
    from aule_tpu_torch.utils import profiling

    gen = torch.Generator(device=DEV)
    gen.manual_seed(SC_SEED)
    q = _randn((1, 32, 2048, 128), gen)
    k, v = _randn((1, 8, 2048, 128), gen), _randn((1, 8, 2048, 128), gen)

    def call(q, k, v):
        return flash_fwd_tma(q, k, v, causal=True)

    sec, (lo, hi) = profiling.benchmark(call, q, k, v, return_spread=True)
    med, mn, mx = profiling.cuda_time_ms(lambda: call(q, k, v))
    ratio = sec * 1e3 / med
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profiling.trace(path):
            call(q, k, v)
        with open(path) as f:
            text = f.read()
    named = "flash_fwd_kernel" in text
    res["x7"] = dict(benchmark_ms=sec * 1e3, benchmark_spread_ms=[
        lo * 1e3, hi * 1e3], cuda_time_ms=med, cuda_time_spread_ms=[mn, mx],
        ratio=ratio, trace_bytes=len(text), trace_names_kernel=named)
    log(f"scripts (x7): profiling.benchmark {sec * 1e3 * 1e3:.1f} us "
        f"(spread {lo * 1e6:.1f}-{hi * 1e6:.1f}) against cuda_time_ms "
        f"{med * 1e3:.1f} us ({mn * 1e3:.1f}-{mx * 1e3:.1f}): ratio "
        f"{ratio:.3f}; trace {len(text)} bytes, names flash_fwd_kernel: "
        f"{named}; {card_line()}")
    if abs(ratio - 1.0) > SC_BENCH_TOL:
        raise AssertionError(f"scripts (x7): benchmark {ratio:.3f}x "
                             f"cuda_time_ms's median")
    if not named:
        raise AssertionError("scripts (x7): the trace names no "
                             "flash_fwd_kernel")


def check_scripts() -> dict:
    """The port's entry points and scripts on the card, (x1)-(x7), each
    through the call a user makes (the launch counts set to 0 before each
    in-process script and read after; the worlds' and the workers' ranks
    run in processes of their own, checked by their results)."""
    t_start = time.perf_counter()
    log(card_line())
    counters = _launch_counters()
    res = {"launches": {}, "seconds": {}}
    for part, fn in (("x1", _sc_entry), ("x2", _sc_serve), ("x3", _sc_train),
                     ("x4", _sc_scaling), ("x5-x6", _sc_dryruns),
                     ("x7", _sc_profiling)):
        t0 = time.perf_counter()
        fn(res, counters)
        res["seconds"][part] = round(time.perf_counter() - t0, 1)
    res["launches"]["x1"] = res["x1"]["launches"]
    for entry, parts in SCRIPTS_LAUNCHES:
        for run, counter in parts:
            if not res["launches"].get(run, {}).get(counter):
                raise AssertionError(f"scripts: {counter} was not launched "
                                     f"in {run} ({entry})")
    res["seconds"]["total"] = round(time.perf_counter() - t_start, 1)
    log(f"scripts: launches {res['launches']}; seconds {res['seconds']}")
    return res


def add_script_launches(entries, sc) -> None:
    """Add the in-process scripts' launches ((x1), (x2), (x4)) to the
    entries of the kernel modes they launch."""
    by_name = {e["name"]: e for e in entries}
    for name, parts in SCRIPTS_LAUNCHES:
        got = {run: sc["launches"][run][counter] for run, counter in parts}
        by_name[name]["launches"] += sum(got.values())
        by_name[name]["launches_scripts"] = got


def _phase_process(flag: str, what: str) -> dict:
    """A phase in a process of its own (`chip_smoke.py <flag>`): its
    profiled timings meet a fresh torch.profiler, which loses kernels
    after ~100 profiled runs in one process, and the phases after it keep
    their own count.  Its lines are passed on; its result is the JSON
    object on its last line."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=900)
    lines = proc.stdout.splitlines()
    for line in lines[:-1] if proc.returncode == 0 else lines:
        log(f"  {line}")
    if proc.returncode != 0:
        raise AssertionError(f"the {what} phase failed (exit code "
                             f"{proc.returncode})")
    return json.loads(lines[-1])


def phase_public() -> dict:
    """check_public in a process of its own (`chip_smoke.py --public`)."""
    return _phase_process("--public", "public")


def phase_gpt2() -> dict:
    """check_gpt2 in a process of its own (`chip_smoke.py --gpt2`)."""
    return _phase_process("--gpt2", "GPT-2")


def phase_llama32() -> dict:
    """check_llama32 in a process of its own (`chip_smoke.py --llama32`)."""
    return _phase_process("--llama32", "Llama-3.2-3B")


def phase_mistral() -> dict:
    """check_mistral in a process of its own (`chip_smoke.py --mistral`)."""
    return _phase_process("--mistral", "Mistral-7B")


def phase_moe() -> dict:
    """check_moe in a process of its own (`chip_smoke.py --moe`)."""
    return _phase_process("--moe", "Mixtral MoE")


def phase_adamw() -> dict:
    """check_adamw in a process of its own (`chip_smoke.py --adamw`)."""
    return _phase_process("--adamw", "AdamW")


def phase_spec() -> dict:
    """check_spec in a process of its own (`chip_smoke.py --spec`)."""
    return _phase_process("--spec", "speculative decoding")


def phase_parallel() -> dict:
    """check_parallel in a process of its own (`chip_smoke.py
    --parallel`), which starts the worlds' processes."""
    return _phase_process("--parallel", "parallel")


def phase_parallel_model() -> dict:
    """check_parallel_model in a process of its own (`chip_smoke.py
    --parallel-model`), which starts the worlds' processes."""
    return _phase_process("--parallel-model", "parallel model-level")


def phase_head_dims() -> dict:
    """check_head_dims in a process of its own (`chip_smoke.py
    --head-dims`)."""
    return _phase_process("--head-dims", "head-dim")


def phase_frontends() -> dict:
    """check_frontends in a process of its own (`chip_smoke.py
    --frontends`), which spawns the process pools' workers."""
    return _phase_process("--frontends", "serving front-end")


def phase_scripts() -> dict:
    """check_scripts in a process of its own (`chip_smoke.py --scripts`),
    which starts the demos' and dry runs' worlds and workers."""
    return _phase_process("--scripts", "scripts")


def child_main(check) -> None:
    """`chip_smoke.py --public`, `--gpt2`, `--llama32`, `--mistral`,
    `--moe`, `--adamw`, `--spec`, `--parallel`, `--parallel-model`,
    `--head-dims`, `--frontends` or `--scripts`: that phase alone, its
    result as one JSON line last."""
    if not torch.cuda.is_available():
        log("device: torch.cuda.is_available() is False")
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from aule_tpu_torch.ops import _build

    _build.library()  # built by the parent's build phase
    print(json.dumps(check()), flush=True)


def _entry(name, source, replaces, launches, err, t, shape, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err[0], max_row_rel_err=err[1],
                max_lse_err=err[2], ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                library_ms=t["library_ms"], shape=shape, **extra)


def gpt2_entries(gpt2: dict) -> list:
    """The GPT-2 phase's kernel modes (csrc/paged_generic.cu's decode and
    csrc/paged_prefill_f32.cu's prefill for f32 q; csrc/paged_decode.cu and
    csrc/paged_prefill.cu for 16-bit q at D 64 / 256), each with its
    launches on the GPT-2 serving runs that use it;
    the split layout, which GPT-2 serving does not take, and D256 with
    their launches on the phase's counted checks."""
    src = {"decode": "aule_tpu_torch/csrc/paged_generic.cu",
           "prefill": "aule_tpu_torch/csrc/paged_prefill_f32.cu"}
    design = {"decode": "FFMA, the int8 dot products' scores on __dp4a; "
                        "split-KV with paged_decode.cu's partition at "
                        "generic_blocks_per_sm (a wave of 3 blocks an SM "
                        "over 1-byte pools at D 64/128, else 1), the splits "
                        "merged in split order in the same launch; in a "
                        "block, warps own tiles of "
                        "16 / 8 / 4 tokens (D 64/128/256) in turn, each "
                        "streaming them through its own ring of cp.async "
                        "stages (the D live lanes of each row, each "
                        "token's scales (and page ids past the table's "
                        "first 512 entries, which come with q) copied with "
                        "the stage), 1-byte rows converted in registers as "
                        "read, the score sums scattered so that each lane "
                        "runs the softmax of its own rows, no block "
                        "barrier in the loop; the warps merged in warp "
                        "order",
              "prefill": "3xTF32 on mma.sync (tf32.cuh, short chains); a "
                         "block of 16 q rows of one head, its 4 warps taking "
                         "every 4th key tile, each gathering its own pages "
                         "by cp.async (1-byte pools converted to f32 in "
                         "shared memory), merged in warp order"}
    decode_row = ("aule_tpu/ops/paged_fused.py:213 (_fused_decode_kernel: "
                  "f32 with Precision.HIGHEST l.334-336; D64 padded to 128 "
                  "lanes l.56-66, 494-498)")
    split_row = ("aule_tpu/ops/paged.py:45 (_paged_decode_kernel: f32 "
                 "l.208; any D through the lane padding l.366-372)")
    prefill_row = ("aule_tpu/ops/paged_fused.py:770 (_fused_prefill_kernel: "
                   "f32 and D64 padded to 128 lanes)")
    decode_shape = ("GPT-2 small decode B8 ctx1024 page16 Hq12/Hkv12 D64 "
                    "(fused pools of 128 lanes)")
    prefill_shape = ("GPT-2 small prefill B1 Hq12/Hkv12 D64 page16, chunk "
                     "256 at q_offset 768 over 1024")
    err, times, runs = gpt2["err"], gpt2["time"], gpt2["runs"]

    def shapes(*prefixes):
        """The mode's errors at its other shapes and q types (Llama D128,
        D256, f16 q)."""
        return {k: v for k, v in err.items()
                if any(k.startswith(p + " ") for p in prefixes)}

    def dev(t):
        return dict(device_ms=t["device_ms"],
                    library_device_ms=t["library_device_ms"])

    entries = []
    for name, kind, mode, keys, pool in (
            ("paged_generic_decode_f32", "decode", "f32", ("f32",
                                                           "f32 chunk",
                                                           "f32 lora"),
             "f32 pools"),
            ("paged_generic_decode_int8", "decode", "int8 dot",
             ("int8 chunk",), "int8 pools, bf16 scales, f32 q, int8 dot "
             "products"),
            ("paged_generic_decode_fp8", "decode", "fp8", ("fp8",
                                                           "fp8 chunk"),
             "e4m3 pools, bf16 scales, f32 q"),
            ("paged_prefill_f32", "prefill", "f32", ("f32 chunk",
                                                     "f32 lora"),
             "f32 pool"),
            ("paged_prefill_f32_int8", "prefill", "int8",
             ("int8 chunk",), "int8 pool, bf16 scales, f32 q"),
            ("paged_prefill_f32_fp8", "prefill", "fp8", ("fp8 chunk",),
             "e4m3 pool, bf16 scales, f32 q")):
        kernel = ("paged_generic_decode" if kind == "decode"
                  else "paged_prefill_f32")
        by_run = {k: runs[k][kernel] for k in keys}
        for k, count in by_run.items():
            if count == 0:
                raise AssertionError(f"{kernel} was not launched in GPT-2 "
                                     f"run {k}")
        t = times[f"{kind} {mode}"]
        extra = dict(design=design[kind], launches_by_run=by_run, **dev(t),
                     other_shapes=shapes(f"{kind} {mode}"))
        if mode == "int8 dot":
            # the int8 exact path (int8_matmul=False) is checked and timed,
            # not launched on the main path
            extra.update(int8_exact_errs=err["decode int8 exact"],
                         int8_exact_device_ms=times["decode int8 exact"][
                             "device_ms"],
                         int8_exact_other_shapes=shapes("decode int8 exact"))
        if "ffma_bound_ms" in t:
            extra["ffma_bound_ms"] = t["ffma_bound_ms"]
        if name == "paged_generic_decode_f32":
            # every f32-q pool mode timed at the f32 Llama layer's decode
            # and at D256 group 8 (library: SDPA in f32)
            for tag, what in (("llama d128", "llama_d128_group4_B8_ctx4096"),
                              ("d256", "d256_group8_B2_ctx2048_777")):
                extra[f"time_{what}_by_mode"] = {
                    m[0]: times[f"{tag} decode {m[0]}"]
                    for m in GEN_DECODE_MODES}
        entries.append(_entry(
            name, src[kind], decode_row if kind == "decode" else prefill_row,
            sum(by_run.values()), err[f"{kind} {mode}"], t,
            f"{decode_shape if kind == 'decode' else prefill_shape}, {pool}",
            **extra))
    # 16-bit q at D 64 / 256: csrc/paged_prefill.cu's tensor cores, on the
    # bf16 chunked run
    by_run = {"bf16 chunk": runs["bf16 chunk"]["paged_prefill"]}
    if by_run["bf16 chunk"] == 0 or runs["bf16 chunk"][
            "paged_prefill_f32"]:
        raise AssertionError("the GPT-2 bf16 chunked run did not prefill on "
                             "paged_prefill.cu alone")
    t = times["tc prefill bf16"]
    entries.append(_entry(
        "paged_prefill_d64", "aule_tpu_torch/csrc/paged_prefill.cu",
        "aule_tpu/ops/paged_fused.py:770 (_fused_prefill_kernel at D64 "
        "padded to 128 lanes, l.961-964; and at D256)",
        by_run["bf16 chunk"], err["tc prefill bf16"], t,
        f"{prefill_shape}, bf16 pool", launches_by_run=by_run, **dev(t),
        design="paged_prefill.cu's warp-specialised wgmma kernel at Tile<64> "
               "/ Tile<256>: one consumer warpgroup, 128- / 64-key stages; "
               "the producer reads a row's D live lanes",
        other_shapes={k: v for k, v in err.items()
                      if k.startswith("tc prefill ")},
        time_by_mode={k[len("tc prefill "):]: v for k, v in times.items()
                      if k.startswith("tc prefill ")}))
    # 16-bit q at D 64 / 256: csrc/paged_decode.cu's tensor cores, on the
    # bf16 runs (D64), and on the phase's counted checks (split; D256)
    tc_src = "aule_tpu_torch/csrc/paged_decode.cu"
    tc_design = ("paged_decode.cu's split-KV kernel at Tile<64, POOL> / "
                 "Tile<256, POOL>: a cp.async ring of 64-token stages (4 or 8 "
                 "at D64, 3 blocks an SM; 2 or 4 at D256, 1 block an SM), "
                 "mma.sync m16n8k16 (m16n8k32 int8 scores), the fused "
                 "pool's D64 rows read at their 64 live lanes, the merge in "
                 "the launch")
    by_run = {k: runs[k]["paged_decode"] for k in ("bf16", "bf16 chunk")}
    for k, count in by_run.items():
        if count == 0 or runs[k]["paged_generic_decode"]:
            raise AssertionError(f"the GPT-2 {k} run did not decode on "
                                 f"paged_decode.cu alone")
    tc_modes = [m[0] for m in TC_DECODE_MODES]
    t = times["tc decode bf16"]
    entries.append(_entry(
        "paged_decode_d64", tc_src, decode_row.replace(
            "f32 with Precision.HIGHEST l.334-336; ", ""),
        sum(by_run.values()), err["tc decode bf16"], t,
        f"{decode_shape}, bf16 pools", design=tc_design,
        launches_by_run=by_run, **dev(t),
        errs_by_mode={m: err[f"tc decode {m}"] for m in tc_modes},
        time_by_mode={k[len("tc decode "):]: v for k, v in times.items()
                      if k.startswith("tc decode ")},
        other_shapes={k: v for k, v in err.items()
                      if k.startswith(("tc decode ", "tc split "))
                      and k not in {f"tc {x} {m}" for m in tc_modes
                                    for x in ("decode", "split")}}))
    launches = gpt2["launches"]["tc split decode checks"]
    tc_split = [m for m in tc_modes if "dot" not in m]
    entries.append(_entry(
        "paged_decode_split_d64", tc_src, split_row.replace("f32 l.208; ", ""),
        launches,
        tuple(max(err[f"tc split {m}"][i] for m in tc_split)
              for i in range(3)), times["tc split bf16"],
        "GPT-2 small decode B8 ctx1024 page16 Hq12/Hkv12 D64, split bf16 "
        "pools (f16, int8 and fp8 with f32 scales checked too)",
        design=tc_design, same_bits_as_fused_kernel=True,
        **dev(times["tc split bf16"]),
        errs_by_mode={m: err[f"tc split {m}"] for m in tc_split},
        launches_note="on the GPT-2 phase's counted paged_attention calls "
                      "at D 64 and 256: GPT-2 serving has no split layout"))
    launches = gpt2["launches"]["tc decode d256 checks"]
    d256 = {k: v for k, v in err.items()
            if k.startswith("tc ") and k.endswith("D256 group 8")}
    entries.append(_entry(
        "paged_decode_d256", tc_src, decode_row.replace(
            "f32 with Precision.HIGHEST l.334-336; D64 padded to 128 lanes "
            "l.56-66, 494-498", "D256"),
        launches, tuple(max(e[i] for e in d256.values()) for i in range(3)),
        times["tc d256 decode bf16"],
        "D256 group 8 decode B2 Hq8/Hkv1 contexts 2048 and 777 page16, bf16 "
        "pools (f16 timed too; every pool mode, both layouts checked)",
        design=tc_design, **dev(times["tc d256 decode bf16"]),
        time_f16=times["tc d256 decode f16"], errs_by_mode=d256,
        launches_note="on the GPT-2 phase's counted D256 decode checks: no "
                      "served model has a head dim of 256"))
    split_modes = ("f32", "int8 exact", "fp8")
    launches = gpt2["launches"]["split decode checks"]
    if launches == 0:
        raise AssertionError("the split layout's generic decode was not "
                             "launched")
    worst = tuple(max(err[f"split {m}"][i] for m in split_modes)
                  for i in range(3))
    entries.append(_entry(
        "paged_generic_decode_split", src["decode"], split_row, launches,
        worst, times["split f32"], "GPT-2 small decode B8 ctx1024 page16 "
        "Hq12/Hkv12 D64, split f32 pools (int8 and fp8 with f32 scales "
        "checked and timed too)", design=design["decode"],
        same_bits_as_fused_kernel=True, **dev(times["split f32"]),
        errs_by_mode={m: err[f"split {m}"] for m in split_modes},
        time_by_mode={m: times[f"split {m}"] for m in split_modes},
        launches_note="on the GPT-2 phase's counted paged_attention "
                      "calls: GPT-2 serving has no split layout"))
    return entries


def gqa_entries(llama32: dict, group_err: dict) -> list:
    """The paged kernels at GQA group 3, each mode with its launches on the
    Llama-3.2-3B runs that use it, its errors and times at B8 ctx4096
    (decode) or the 512-token chunk at 3488 over 4000 (prefill), Hq24/Hkv8,
    and its worst errors per group in check_groups' small case; the
    decode's times and errors at groups 4, 12 and 32 beside them."""
    runs, times, errs = llama32["runs"], llama32["time"], llama32["err"]
    decode_src = "aule_tpu_torch/csrc/paged_decode.cu"
    any_group = " at any GQA group (padded to a multiple of 8 rows, {})"
    fused_row = ("aule_tpu/ops/paged_fused.py:213 (_fused_decode_kernel"
                 + any_group.format("l.541-544") + ")")
    split_row = ("aule_tpu/ops/paged.py:45 (_paged_decode_kernel"
                 + any_group.format("l.376-383") + ")")
    prefill_row = ("aule_tpu/ops/paged_fused.py:770 (_fused_prefill_kernel"
                   + any_group.format("l.998-1007") + ")")
    decode_shape = "B8 ctx4096 page16 Hq24/Hkv8 D128 (group 3: one 8-row tile)"
    prefill_shape = ("B1 Hq24/Hkv8 D128 page16, chunk 512 at q_offset 3488 "
                     "over 4000 (group 3: one q head a block)")
    entries = []
    for name, kind, mode, keys, src, row, shape, err_key in (
            ("paged_decode_g3", "decode", "bf16", ("whole bf16", "a"),
             decode_src, fused_row, decode_shape + " bf16", "decode bf16"),
            ("paged_decode_g3_int8", "decode", "int8 dot", ("b",), decode_src,
             fused_row, decode_shape + " int8 dot products, bf16 scales",
             "decode int8 dot"),
            ("paged_decode_g3_fp8", "decode", "fp8", ("c",), decode_src,
             fused_row, decode_shape + " e4m3, bf16 scales", "decode fp8"),
            ("paged_decode_split_g3", "decode", "split bf16", ("e",),
             decode_src, split_row, decode_shape + " split bf16 pools",
             "split bf16"),
            ("paged_decode_split_g3_int8", "decode", "split int8", ("f",),
             decode_src, split_row, decode_shape + " split int8 pools, f32 "
             "scales", "split int8"),
            ("paged_prefill_g3", "prefill", "bf16", ("a",),
             "aule_tpu_torch/csrc/paged_prefill.cu", prefill_row,
             prefill_shape + ", bf16 pool", "prefill bf16"),
            ("paged_prefill_g3_int8", "prefill", "int8", ("b",),
             "aule_tpu_torch/csrc/paged_prefill.cu", prefill_row,
             prefill_shape + ", int8 pool, bf16 scales", "prefill int8")):
        kernel = ("paged_prefill" if kind == "prefill" else
                  "paged_decode_split" if mode.startswith("split")
                  else "paged_decode")
        by_run = {k: runs[k][kernel] for k in keys}
        for k, count in by_run.items():
            if count == 0:
                raise AssertionError(f"{kernel} was not launched in "
                                     f"Llama-3.2-3B run {k}")
        t = times[f"{kind} {mode} g3"]
        extra = dict(launches_by_run=by_run, device_ms=t["device_ms"],
                     library_device_ms=t["library_device_ms"],
                     group_4_same_run=dict(
                         times[f"{kind} {mode} g4"],
                         err=errs[f"{kind} {mode} g4"]),
                     small_case_errs_by_group={
                         k.split()[-1]: v for k, v in group_err.items()
                         if k.startswith(err_key + " G")},
                     small_case=GROUP_CASE[kind])
        if name == "paged_decode_g3":
            extra.update(
                time_group_12=dict(times["decode bf16 g12"],
                                   err=errs["decode bf16 g12"]),
                time_group_32_mqa=dict(times["decode bf16 g32"],
                                       err=errs["decode bf16 g32"]))
        entries.append(_entry(name, src, row, sum(by_run.values()),
                              errs[f"{kind} {mode} g3"], t, shape, **extra))
    return entries


def mistral_entries(mistral: dict) -> list:
    """Mistral-7B's windowed kernels (_mistral_kernels), each with its
    launches on the Mistral-7B runs, its errors and times at Mistral's
    shapes."""
    runs, times, errs = mistral["runs"], mistral["time"], mistral["err"]
    design = "window 4096 (decode: trailing 4097), group 4"
    entries = []
    for name, kernel, key, keys, src, row, shape in (
            ("flash_fwd_window_4096", "flash_fwd", "flash", ("whole bf16",),
             "aule_tpu_torch/csrc/flash_fwd.cu",
             "aule_tpu/ops/flash.py:479 (_win_kernel)",
             f"Mistral-7B whole-prompt prefill B1 Hq32/Hkv8 "
             f"S{max(MISTRAL_PROMPT_LENS)} D128 bf16 causal window 4096 "
             f"(library: SDPA with the window's boolean mask)"),
            ("paged_decode_window_4097", "paged_decode", "decode",
             ("whole bf16", "a"), "aule_tpu_torch/csrc/paged_decode.cu",
             "aule_tpu/ops/paged_fused.py:213 (_fused_decode_kernel, "
             "window_size)",
             f"Mistral-7B decode B4 ctx{max(MISTRAL_PROMPT_LENS)} page16 "
             f"Hq32/Hkv8 D128 bf16 over {MISTRAL_KW['max_pages_per_seq']}-"
             f"page tables, trailing window 4097 (held at the prompts' "
             f"lengths too; library: SDPA on the window's gathered K/V)"),
            ("paged_prefill_window_4096", "paged_prefill", "prefill", ("a",),
             "aule_tpu_torch/csrc/paged_prefill.cu",
             "aule_tpu/ops/paged_fused.py:770 (_fused_prefill_kernel, "
             "window_size)",
             f"Mistral-7B prefill B1 Hq32/Hkv8 D128 page16 bf16 pool, chunk "
             f"{CHUNK} at q_offset {max(MISTRAL_PROMPT_LENS) - CHUNK} over "
             f"{max(MISTRAL_PROMPT_LENS)}, window 4096 (library: SDPA with "
             f"the positional window mask)")):
        by_run = {k: runs[k][kernel] for k in keys}
        for k, count in by_run.items():
            if count == 0:
                raise AssertionError(f"{kernel} was not launched in "
                                     f"Mistral-7B run {k}")
        t = times[key]
        entries.append(_entry(
            name, src, row, sum(by_run.values()), errs[key], t, shape,
            design=design, launches_by_run=by_run, device_ms=t["device_ms"],
            library_device_ms=t["library_device_ms"]))
    return entries


# the kernel modes the Mixtral runs launch: (entry, counter, runs of
# MOE_RUNS); Mixtral's attention is Llama-3-8B's (group 4, D128, bf16)
MOE_LAUNCHES = [
    ("flash_fwd", "flash_fwd", ("whole bf16", "c")),
    ("flash_fwd_short", "flash_fwd_short", ("whole bf16", "c")),
    ("paged_decode", "paged_decode", ("whole bf16",)),
    ("paged_decode_int8", "paged_decode", ("b",)),
    ("paged_decode_fp8", "paged_decode", ("c",)),
    ("paged_prefill_int8", "paged_prefill", ("b",)),
]
ADAMW_LAUNCHES = ("flash_fwd", "flash_bwd_delta", "flash_bwd_dq",
                  "flash_bwd_dkv")


def add_moe_adamw_launches(entries, moe, adamw) -> None:
    """Add the Mixtral runs' and the AdamW steps' launches to the entries
    of the kernel modes they launch, each also by run or by step; a mode
    that one of them should launch and did not fails."""
    by_name = {e["name"]: e for e in entries}
    for name, counter, keys in MOE_LAUNCHES:
        n = {k: moe["runs"][k][counter] for k in keys}
        if 0 in n.values():
            raise AssertionError(f"{name} was not launched in Mixtral runs "
                                 f"{n}")
        by_name[name]["launches"] += sum(n.values())
        by_name[name]["launches_mixtral_by_run"] = n
    for name in ADAMW_LAUNCHES:
        steps = adamw["launches"][name]
        if 0 in steps:
            raise AssertionError(f"{name} was not launched in an AdamW step")
        by_name[name]["launches"] += sum(steps)
        by_name[name]["launches_per_adamw_step"] = steps


# the kernel modes the edges runs launch: (entry, counter, runs); (h0) and
# (h) over bf16 pools, (i) over int8 (row 12's int8 dot products)
EDGE_LAUNCHES = [
    ("paged_decode", "paged_decode", ("h0", "h")),
    ("paged_prefill", "paged_prefill", ("h0", "h")),
    ("paged_decode_int8", "paged_decode", ("i",)),
    ("paged_prefill_int8", "paged_prefill", ("i",)),
]


def add_edge_launches(entries, edges) -> None:
    """Add the edges runs' launches to the entries of the kernel modes they
    launch, also by run; a mode a run should launch and did not fails."""
    by_name = {e["name"]: e for e in entries}
    for name, counter, keys in EDGE_LAUNCHES:
        n = {k: edges["runs"][k][counter] for k in keys}
        if 0 in n.values():
            raise AssertionError(f"{name} was not launched in edges runs {n}")
        by_name[name]["launches"] += sum(n.values())
        by_name[name]["launches_edges_by_run"] = n


# The spec phase's launches by kernel mode: (mode, [(run, part, counter)]);
# the parts are _SpecSpy's buckets.  The first five are the modes the spec
# phase adds (the verify's and the draft's shapes); the rest add the spec
# runs' launches to the engine phase's modes.
SPEC_LAUNCHES = [
    ("paged_prefill_verify", [("s1", "verify", "paged_prefill"),
                              ("s1", "round draft", "paged_prefill"),
                              ("s3", "verify", "paged_prefill")]),
    ("paged_prefill_verify_int8", [("s2", "verify", "paged_prefill")]),
    ("paged_prefill_d64_int8", [("s2", "round draft", "paged_prefill"),
                                ("s2", "draft prefill", "paged_prefill")]),
    ("paged_decode_d64_int8", [("s2", "round draft", "paged_decode")]),
    ("flash_fwd_d64", [("s2", "draft prefill", "flash_fwd")]),
    ("paged_decode", [("s0", "decode", "paged_decode"),
                      ("s1", "decode", "paged_decode"),
                      ("s1", "round draft", "paged_decode"),
                      ("s3", "decode", "paged_decode")]),
    ("paged_prefill", [("s0", "target prefill", "paged_prefill"),
                       ("s1", "target prefill", "paged_prefill"),
                       ("s1", "draft prefill", "paged_prefill"),
                       ("s3", "target prefill", "paged_prefill")]),
    ("paged_decode_int8", [("s2", "decode", "paged_decode")]),
    ("flash_fwd", [("s2", "target prefill", "flash_fwd")]),
    ("flash_fwd_short", [("s2", "target prefill", "flash_fwd_short")]),
]


def spec_entries(entries, spec) -> None:
    """The spec phase's kernel modes as entries (each with its launches in
    the spec runs, by run and part, its errors, times and bound at the
    shape the spec phase checked), and the spec runs' launches added to
    the engine phase's modes they launch.  A mode the spec runs should
    launch and did not fails."""
    prefill_src = "aule_tpu_torch/csrc/paged_prefill.cu"
    prefill_row = "aule_tpu/ops/paged_fused.py:770 (_fused_prefill_kernel"
    decode_row = "aule_tpu/ops/paged_fused.py:213 (_fused_decode_kernel"

    def worst(*keys):
        errs = [spec["err"][k] for k in keys]
        return tuple(max(e[i] for e in errs) for i in range(3))

    def more(prefix, modes):
        return {f"{m.replace(' ', '_')}_{k}": spec["time"][f"{prefix} {m}"][k]
                for m in modes for k in ("device_ms", "library_device_ms",
                                         "ms", "bound_ms")}

    verify_shape = (f"B8 x {SPEC_K + 1} queries over 4096 (q_offset "
                    f"{4096 - SPEC_K - 1}) Hq32/Hkv8")
    new = {
        "paged_prefill_verify": (
            prefill_src, prefill_row + ") at the verify's shape: a "
            "speculative round's target pass, aule_tpu/serving/engine.py:"
            "1146-1251", worst("verify bf16", "verify ragged bf16"),
            spec["time"]["verify bf16"],
            verify_shape + " D128 bf16 page16 (ragged slots of 5, 1 and 0 "
            "queries checked; library: SDPA with a positional mask)",
            more("verify", ("fp8",))),
        "paged_prefill_verify_int8": (
            prefill_src, prefill_row + ") int8 mode at the verify's shape",
            worst("verify int8", "verify ragged int8"),
            spec["time"]["verify int8"],
            verify_shape + " D128 int8 pool, bf16 scales", {}),
        "paged_prefill_d64_int8": (
            prefill_src, prefill_row + ") int8 mode, D64 group 4: the "
            "draft's catch-up prefill, aule_tpu/serving/engine.py:1072-1087",
            worst("draft prefill int8", "draft prefill ragged int8"),
            spec["time"]["draft prefill int8"],
            verify_shape + " D64 int8 pool, bf16 scales (Llama-3.2-1B's "
            "heads)", more("draft prefill", ("bf16", "fp8"))),
        "paged_decode_d64_int8": (
            "aule_tpu_torch/csrc/paged_decode.cu", decode_row + ") int8 "
            "dot-product mode, D64 group 4: the draft's decode steps, "
            "aule_tpu/serving/engine.py:1107-1129; "
            "scripts/probe_int8_mxu.py:16 (kern)",
            spec["err"]["draft decode int8 dot"],
            spec["time"]["draft decode int8 dot"],
            "B8 ctx4096 page16 Hq32/Hkv8 D64 int8 pool, bf16 scales",
            more("draft decode", ("bf16", "fp8"))),
        "flash_fwd_d64": (
            "aule_tpu_torch/csrc/flash_fwd.cu", "aule_tpu/ops/flash.py:92 "
            "(_fwd_kernel) at D64 group 4: the draft's whole-prompt "
            "prefill, aule_tpu/serving/engine.py:995-1018; "
            "aule_tpu/ops/flash.py:638 (_mono_kernel)",
            worst("flash d64 S2048", "flash d64 S1000"),
            spec["time"]["flash d64"],
            "B1 Hq32/Hkv8 S2048 D64 bf16 causal (S1000 checked too; "
            "library: SDPA on GQA-expanded K/V)", {}),
    }
    by_name = {e["name"]: e for e in entries}
    for name, parts in SPEC_LAUNCHES:
        n = {f"{run} {part}": spec["runs"][run]["buckets"].get(part, {}).get(
            counter, 0) for run, part, counter in parts}
        total = sum(n.values())
        if total == 0:
            raise AssertionError(f"{name} was not launched in the spec runs "
                                 f"{n}")
        if name in new:
            src, row, err, t, shape, extra = new[name]
            entries.append(_entry(name, src, row, total, err, t, shape,
                                  launches_spec_by_part=n,
                                  device_ms=t["device_ms"],
                                  library_device_ms=t["library_device_ms"],
                                  **extra))
        else:
            by_name[name]["launches"] += total
            by_name[name]["launches_spec_by_part"] = n


PAR_FWD_SRC = "aule_tpu_torch/csrc/flash_fwd.cu"
PAR_FWD_ROW = "aule_tpu/ops/flash.py:92 (_fwd_kernel)"


def parallel_entries(entries, par) -> None:
    """The parallel phase's kernel modes at their shard shapes, each with
    its launches summed over the ranks of the runs that give it that
    shape (the ring's forward launches by hop class as _HopSpy counted
    them: n diagonal and n(n-1)/2 full hops over n ranks, the skipped hops
    none, and the classes' sum equal to the counters' total), its errors
    against its plain version and its times."""
    n = par["launches"]
    hops = par["hops"]
    t = par["kernels"]

    def got(case, counter):
        return n[case].get(counter, 0)

    for case, ranks in (("ring", 4), ("ring_grads", 2), ("context", 4)):
        h = hops[case]
        want = ((0, ranks) if case == "context"
                else (ranks, ranks * (ranks - 1) // 2))
        total = sum(v for k, v in n[case].items() if k.startswith("flash_fwd"))
        if (h["diag"], h["full"]) != want or total != h["diag"] + h["full"]:
            raise AssertionError(
                f"{case}: flash forward launches {h} by hop class (total "
                f"{total}), not {want[0]} diagonal and {want[1]} full")
        log(f"parallel {case}: flash forward launches by hop class {h} "
            f"({ranks} ranks)")
    bwd = {p: got("ring_grads", f"flash_bwd_{p}") for p in
           ("delta", "dq", "dkv")}
    if set(bwd.values()) != {3}:
        raise AssertionError(f"ring backward launches {bwd}, not 3 each "
                             f"(2 diagonal and 1 full hop; none skipped)")
    tp = {k: v["launches"] for k, v in par["tp"].items()}
    rows = [
        ("flash_fwd_ring_diag_shard", PAR_FWD_SRC,
         PAR_FWD_ROW + "; aule_tpu/ops/flash.py:638 (_mono_kernel)",
         hops["ring"]["diag"] + hops["ring_grads"]["diag"],
         "B1 Hq32/Hkv8 S2048 D128 bf16 causal: the ring's diagonal hops "
         "(S8192 over 4 ranks, S4096 over 2; library: SDPA)"),
        ("flash_fwd_shard_full", PAR_FWD_SRC, PAR_FWD_ROW,
         hops["ring"]["full"] + hops["ring_grads"]["full"]
         + hops["context"]["full"],
         "B1 Hq32/Hkv8 Sq2048 Sk2048 D128 bf16 non-causal: the ring's full "
         "hops and context parallel's Sq2048 over a 2048-key shard of 8192 "
         "(4 ranks; library: SDPA)"),
        ("flash_fwd_ulysses", PAR_FWD_SRC,
         PAR_FWD_ROW + "; aule_tpu/ops/flash.py:638 (_mono_kernel)",
         got("ulysses", "flash_fwd"),
         "B1 Hq16/Hkv4 S8192 D128 bf16 causal: Ulysses' full-sequence "
         "kernel on half the heads (2 ranks; library: SDPA)"),
        ("flash_fwd_ulysses_window", PAR_FWD_SRC,
         "aule_tpu/ops/flash.py:479 (_win_kernel)",
         got("ulysses_window", "flash_fwd"),
         f"B1 Hq16/Hkv4 S8192 D128 bf16 causal window {PAR_WINDOW} "
         f"(2 ranks; library: SDPA with a boolean mask)"),
        ("flash_fwd_head_parallel", PAR_FWD_SRC,
         PAR_FWD_ROW + "; aule_tpu/ops/flash.py:638 (_mono_kernel)",
         got("head", "flash_fwd"),
         "B1 Hq16/Hkv4 S4096 D128 bf16 causal: head parallelism on a "
         "(1, 2) mesh (library: SDPA)"),
        ("flash_bwd_delta_ring_shard", "aule_tpu_torch/csrc/flash_bwd.cu",
         "aule_tpu/ops/flash_vjp.py:746 (delta, an XLA fusion in JAX: no "
         "Pallas kernel)", bwd["delta"],
         "B1 Hq32/Hkv8 S2048 D128 bf16, the ring's hops with a non-zero "
         "lse cotangent; timed at the full hop (library: "
         "torch.linalg.vecdot(o, do))"),
        ("flash_bwd_dq_ring_shard", "aule_tpu_torch/csrc/flash_bwd.cu",
         "aule_tpu/ops/flash_vjp.py:127 (_dq_kernel)", bwd["dq"],
         "B1 Hq32/Hkv8 S2048 D128 bf16, the ring's diagonal and full hops "
         "with a non-zero lse cotangent; timed at the full hop (library: the "
         "backward of SDPA, dq, dk and dv together)"),
        ("flash_bwd_dkv_ring_shard", "aule_tpu_torch/csrc/flash_bwd.cu",
         "aule_tpu/ops/flash_vjp.py:271 (_dkv_kernel)", bwd["dkv"],
         "as flash_bwd_dq_ring_shard"),
        ("paged_decode_split_shard", "aule_tpu_torch/csrc/paged_decode.cu",
         "aule_tpu/ops/paged.py:45 (_paged_decode_kernel)",
         got("split_paged", "paged_decode_split"),
         "B8 Hq16/Hkv4 ctx2048 page16 D128 split bf16 pools: a (model 2, "
         "ctx 2) shard of B8 ctx4096, with its LSE for the combine "
         "(library: SDPA on the gathered K/V)"),
        ("paged_decode_int8_ctx_shard", "aule_tpu_torch/csrc/paged_decode.cu",
         "aule_tpu/ops/paged_fused.py:213 (_fused_decode_kernel) int8 mode",
         got("fused_int8", "paged_decode"),
         "B8 Hq32/Hkv8 ctx2048 page16 D128 fused int8 pool, bf16 scales: a "
         "ctx-2 shard of B8 ctx4096 (library: SDPA on the dequantized K/V)"),
        ("paged_decode_fp8_ctx_shard", "aule_tpu_torch/csrc/paged_decode.cu",
         "aule_tpu/ops/paged_fused.py:213 (_fused_decode_kernel) fp8 mode",
         got("fused_fp8", "paged_decode"),
         "B8 Hq32/Hkv8 ctx2048 page16 D128 fused e4m3 pool, bf16 scales: a "
         "ctx-2 shard of B8 ctx4096 (library: SDPA on the dequantized K/V)"),
        ("paged_decode_tp2", "aule_tpu_torch/csrc/paged_decode.cu",
         "aule_tpu/ops/paged_fused.py:213 (_fused_decode_kernel)",
         tp["p1"].get("paged_decode", 0) + tp["p3"].get("paged_decode", 0),
         "B8 Hq16/Hkv4 ctx1024 page16 D128 bf16: a rank's heads in the tp 2 "
         "engine (runs p1 and p3; library: SDPA)"),
        ("paged_decode_int8_tp2", "aule_tpu_torch/csrc/paged_decode.cu",
         "aule_tpu/ops/paged_fused.py:213 (_fused_decode_kernel) int8 mode",
         tp["p2"].get("paged_decode", 0),
         "B8 Hq16/Hkv4 ctx1024 page16 D128 int8 pool: the tp 2 engine's run "
         "p2 (library: SDPA on the dequantized K/V)"),
        ("paged_prefill_tp2", "aule_tpu_torch/csrc/paged_prefill.cu",
         "aule_tpu/ops/paged_fused.py:770 (_fused_prefill_kernel)",
         tp["p1"].get("paged_prefill", 0) + tp["p3"].get("paged_prefill", 0),
         "B1 Hq16/Hkv4 D128 page16, chunk 512 at q_offset 512 over 1024, "
         "bf16 pool: a rank's heads in the tp 2 engine (runs p1 and p3; "
         "library: SDPA with a positional mask)"),
        ("paged_prefill_int8_tp2", "aule_tpu_torch/csrc/paged_prefill.cu",
         "aule_tpu/ops/paged_fused.py:770 (_fused_prefill_kernel) int8 "
         "mode", tp["p2"].get("paged_prefill", 0),
         "as paged_prefill_tp2, int8 pool (run p2)"),
    ]
    key = {"flash_bwd_delta_ring_shard": "bwd_delta",
           "flash_bwd_dq_ring_shard": "bwd_dq",
           "flash_bwd_dkv_ring_shard": "bwd_dkv"}
    for name, src, row, launches, shape in rows:
        if launches == 0:
            raise AssertionError(f"{name} was not launched in the parallel "
                                 f"phase")
        tm = t[key.get(name, name)]
        err = tuple(tm["err"]) + (0.0,) * (3 - len(tm["err"]))
        extra = {k: tm[k] for k in ("device_ms", "library_device_ms")
                 if k in tm}
        entries.append(_entry(name, src, row, launches, err, tm, shape,
                              phase="parallel", **extra))


def parallel_model_entries(entries, pm) -> None:
    """The model-level phase's kernel modes at their shard shapes, each
    with its launches summed over the ranks of the configurations that
    give it that shape, its errors against its plain version and its
    times."""
    n = pm["launches"]
    g = pm["gpt2"]

    def got(counter, *cases):
        return sum(n[c].get(counter, 0) for c in cases)

    def gpt2_got(counter, *runs):
        return sum(g[r]["launches"].get(counter, 0) for r in runs)

    bwd_row = {"delta": "aule_tpu/ops/flash_vjp.py:746 (delta, an XLA "
                        "fusion in JAX: no Pallas kernel)",
               "dq": "aule_tpu/ops/flash_vjp.py:127 (_dq_kernel)",
               "dkv": "aule_tpu/ops/flash_vjp.py:271 (_dkv_kernel)"}
    lib = {"delta": "torch.linalg.vecdot(o, do)",
           "dq": "the backward of SDPA, dq, dk and dv together",
           "dkv": "the backward of SDPA, dq, dk and dv together"}
    mono = PAR_FWD_ROW + "; aule_tpu/ops/flash.py:638 (_mono_kernel)"
    rows = [
        ("flash_fwd_dp_tp_shard", PAR_FWD_SRC, mono,
         got("flash_fwd", "sgd", "zero1"),
         f"B1 Hq16/Hkv4 S{PM_S} D128 bf16 causal: a (data 2, model 2) "
         f"rank's sequence and heads at Llama-3-8B width, in the SGD and "
         f"ZeRO-1 steps (library: SDPA)"),
        ("flash_fwd_pipeline_stage", PAR_FWD_SRC, mono,
         got("flash_fwd", "pipeline", "pipeline_forward"),
         f"B1 Hq32/Hkv8 S{PM_S} D128 bf16 causal: a pipeline microbatch "
         f"(pipe 2, 4 microbatches; the forward and the train step; "
         f"library: SDPA)"),
        ("flash_fwd_ep", PAR_FWD_SRC, mono, got("flash_fwd", "ep", "ep_tight"),
         f"B{PM_EP_BATCH} Hq32/Hkv8 S{PM_EP_S} D128 bf16 causal: the "
         f"expert-parallel forward's replicated attention (Mixtral-8x7B "
         f"width; library: SDPA)"),
        ("flash_fwd_gpt2_tp2", PAR_FWD_SRC,
         PAR_FWD_ROW + " at D64 (d_scale tiles, l.931)",
         gpt2_got("flash_fwd", "g1"),
         f"B1 Hq6/Hkv6 S{max(PM_GPT2_PROMPTS)} D64 bf16 causal: a tp 2 "
         f"rank's heads of GPT-2 small's whole-prompt prefill (timed at "
         f"the longest prompt; library: SDPA)"),
    ]
    for key, heads, cases in (
            ("dp_tp_shard", "Hq16/Hkv4", ("sgd", "zero1")),
            ("pipeline_stage", "Hq32/Hkv8", ("pipeline",))):
        for part in ("delta", "dq", "dkv"):
            rows.append((
                f"flash_bwd_{part}_{key}", "aule_tpu_torch/csrc/flash_bwd.cu",
                bwd_row[part], got(f"flash_bwd_{part}", *cases),
                f"B1 {heads} S{PM_S} D128 bf16 causal, no lse cotangent: "
                f"the {' and '.join(cases)} step's backward (library: "
                f"{lib[part]})"))
    rows += [
        ("paged_decode_gpt2_tp2", "aule_tpu_torch/csrc/paged_decode.cu",
         "aule_tpu/ops/paged_fused.py:213 (_fused_decode_kernel)",
         gpt2_got("paged_decode", "g1", "g2"),
         "B4 Hq6/Hkv6 D64 page16 bf16 pool: a tp 2 rank's heads of GPT-2 "
         "small (runs g1, g2; library: SDPA on the gathered K/V)"),
        ("paged_decode_int8_gpt2_tp2", "aule_tpu_torch/csrc/paged_decode.cu",
         "aule_tpu/ops/paged_fused.py:213 (_fused_decode_kernel) int8 mode",
         gpt2_got("paged_decode", "g3"),
         "as paged_decode_gpt2_tp2, int8 pool with bf16 scales, int8 "
         "dot products (run g3; library: SDPA on the dequantized K/V)"),
        ("paged_prefill_gpt2_tp2", "aule_tpu_torch/csrc/paged_prefill.cu",
         "aule_tpu/ops/paged_fused.py:770 (_fused_prefill_kernel)",
         gpt2_got("paged_prefill", "g2"),
         f"B1 Hq6/Hkv6 D64 page16, chunk {GPT2_CHUNK} at q_offset 256, "
         f"bf16 pool: a tp 2 rank's heads of GPT-2 small (run g2; "
         f"library: SDPA with a positional mask)"),
        ("paged_prefill_int8_gpt2_tp2", "aule_tpu_torch/csrc/paged_prefill.cu",
         "aule_tpu/ops/paged_fused.py:770 (_fused_prefill_kernel) int8 "
         "mode", gpt2_got("paged_prefill", "g3"),
         "as paged_prefill_gpt2_tp2, int8 pool (run g3)"),
    ]
    t = pm["kernels"]
    for name, src, row, launches, shape in rows:
        if launches == 0:
            raise AssertionError(f"{name} was not launched in the model-level "
                                 f"phase")
        tm = t[name]
        err = tuple(tm["err"]) + (0.0,) * (3 - len(tm["err"]))
        extra = {k: tm[k] for k in ("device_ms", "library_device_ms")
                 if k in tm}
        entries.append(_entry(name, src, row, launches, err, tm, shape,
                              phase="parallel model", **extra))


def main() -> None:
    from aule_tpu_torch.ops.flash import SHORT_SQ

    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    kind = phase_device()
    timed("build", phase_build)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    flash_err, flash_t = check_flash(gen)
    decode_err, decode_t = check_decode(gen)
    split_err, split_t = check_decode_split(gen)
    prefill_err, prefill_t = check_prefill(gen)
    group_err = check_groups(gen, decode_err, prefill_err, split_err)
    seconds["kernels"] = round(time.perf_counter() - t0, 1)
    # before the engine's profiled phases: after many profiled sessions in
    # one process torch.profiler loses kernels, and these times read it
    bwd_err, bwd_t = timed("backward", check_flash_bwd, gen)
    f32_bwd_err, f32_bwd_cases = timed("f32 backward cases",
                                       check_flash_bwd_f32)
    public = timed("public", phase_public)
    gpt2 = timed("gpt2", phase_gpt2)
    llama32 = timed("llama32", phase_llama32)
    mistral = timed("mistral", phase_mistral)
    torch.cuda.empty_cache()  # the MoE and AdamW processes need ~60 GB
    free, total = torch.cuda.mem_get_info()
    log(f"before the MoE and AdamW processes: this process holds "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; the card "
        f"has {free / 2**30:.2f} of {total / 2**30:.2f} GiB free")
    moe = timed("moe", phase_moe)
    adamw = timed("adamw", phase_adamw)
    spec = timed("spec", phase_spec)
    torch.cuda.empty_cache()  # the worlds' processes share the card
    par = timed("parallel", phase_parallel)
    pm = timed("parallel model", phase_parallel_model)
    hd = timed("head dims", phase_head_dims)
    fe = timed("frontends", phase_frontends)
    sc = timed("scripts", phase_scripts)
    runs, params, cfg = timed("engine", phase_engine)
    edges = timed("edges", phase_edges, params, cfg)
    timed("breakdown", phase_breakdown, params, cfg)
    train = timed("train", phase_train, params, cfg)  # last: it rewrites
    del params                                       # the weights
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s, the build included; "
        f"seconds by phase {seconds}")
    log(card_line())

    def launched(kernel, *keys):
        n = {k: runs[k][kernel] for k in keys}
        for k, count in n.items():
            if count == 0:
                raise AssertionError(f"{kernel} was not launched in engine "
                                     f"run {k}")
        return sum(n.values()), n

    # One entry per kernel mode.  Each engine run uses one mode of each
    # paged kernel (its pool's), so a mode's launches are its wrapper's
    # counts in the runs over that pool.
    decode_src = "aule_tpu_torch/csrc/paged_decode.cu"
    decode_row = "aule_tpu/ops/paged_fused.py:213 (_fused_decode_kernel)"
    split_row = "aule_tpu/ops/paged.py:45 (_paged_decode_kernel)"
    split_shape = decode_shape = "B8 ctx4096 page16 Hq32/Hkv8 D128"
    decode_design = ("split-KV: nsplit blocks per (sequence, kv head), "
                     "each streaming its range through a cp.async ring in "
                     "shared memory; the last block merges the partials in "
                     "split order in the same launch")

    def decode_extra(t, **more):
        """Device times, splits and the other timed shapes of a decode
        mode."""
        return dict(design=decode_design, device_ms=t["device_ms"],
                    library_device_ms=t["library_device_ms"],
                    nsplit=t["nsplit"], time_by_shape={
                        shape: {k: v for k, v in ts.items()
                                if k not in ("plain_ms", "bound_by")}
                        for shape, ts in t["shapes"].items()}, **more)

    split_extra = {  # the fused kernel on the same pools, and its bits
        mode: decode_extra(
            split_t[mode], same_bits_as_fused_kernel=True,
            fused_kernel_same_pool_ms=split_t[mode][
                "fused_kernel_same_pool_ms"],
            fused_kernel_same_pool_device_ms=split_t[mode][
                "fused_kernel_same_pool_device_ms"])
        for mode in ("bf16", "int8", "fp8")}
    prefill_src = "aule_tpu_torch/csrc/paged_prefill.cu"
    prefill_design = ("warp-specialised: a producer warpgroup gathers the "
                      "pages with cp.async (and converts int8 / e4m3 tiles "
                      "to the q type in shared memory), two consumer "
                      "warpgroups run wgmma m64n128k16; mbarrier rings")
    prefill_extra = {
        mode: {"design": prefill_design,
               "device_ms": prefill_t[mode]["device_ms"],
               "library_device_ms": prefill_t[mode]["library_device_ms"]}
        for mode in ("bf16", "int8", "fp8")}
    prefill_row = "aule_tpu/ops/paged_fused.py:770 (_fused_prefill_kernel)"
    prefill_shape = ("B1 Hq32/Hkv8 D128 page16, chunk 512 at q_offset 3488 "
                     "over 4000")
    entries = []
    for name, kernel, keys, err, t, shape, src, row, extra in (
            ("flash_fwd", "flash_fwd", ("whole bf16", "c"), flash_err["flash"],
             flash_t[2048], "B1 Hq32/Hkv8 S2048 D128 bf16 causal",
             "aule_tpu_torch/csrc/flash_fwd.cu",
             "aule_tpu/ops/flash.py:92 (_fwd_kernel); "
             "aule_tpu/ops/flash.py:638 (_mono_kernel); "
             "aule_tpu/ops/flash.py:964 (_causal_kernel, its class checked "
             "and timed); aule_tpu/ops/flash.py:479 (_win_kernel, its class "
             "checked and timed)",
             {"launches_per_train_step": train["flash_fwd"],
              "device_ms": flash_t[2048]["device_ms"],
              "library_device_ms": flash_t[2048]["library_device_ms"],
              "time_causal_kernel_class_B2_Hq16_Hkv4_S2048":
                  flash_t["causal class"],
              "time_window_256_S4096": flash_t["window"],
              "time_S512": flash_t[512],
              "time_bench_prefill_B4_S4096": flash_t["B4 S4096"]}),
            ("flash_fwd_short", "flash_fwd_short", ("whole bf16", "c"),
             flash_err["flash_short"], flash_t["S7 short"],
             f"B1 Hq32/Hkv8 S7 D128 bf16 causal (prompts of at most "
             f"SHORT_SQ = {SHORT_SQ} tokens)",
             "aule_tpu_torch/csrc/flash_fwd_short.cu",
             "aule_tpu/ops/flash.py:92 (_fwd_kernel), the engine's shortest "
             "prompts",
             {"device_ms_per_launch": flash_t["S7 short"][
                 "device_ms_per_launch"],
              "library_device_ms": flash_t["S7 short"]["library_device_ms"],
              "device_ms_short_prompts_both_kernels": flash_t["S7 short"][
                  "device_ms_short_prompts"]}),
            ("paged_decode", "paged_decode", ("whole bf16", "a"),
             decode_err["bf16"], decode_t["bf16"],
             decode_shape + " bf16 (f16 checked too)", decode_src,
             decode_row, decode_extra(decode_t["bf16"])),
            ("paged_decode_int8", "paged_decode", ("b",),
             decode_err["int8 dot"], decode_t["int8 dot"],
             decode_shape + " int8 dot-product path, bf16 scales",
             decode_src, decode_row + " int8 mode; "
             "scripts/probe_int8_mxu.py:16 (kern)",
             # the int8 exact path (int8_matmul=False) is checked and
             # timed, not launched on the main path
             decode_extra(decode_t["int8 dot"],
                          int8_exact_errs=decode_err["int8 exact"],
                          int8_exact_device_ms=decode_t["int8 exact"][
                              "device_ms"])),
            ("paged_decode_fp8", "paged_decode", ("c", "d"),
             decode_err["fp8"], decode_t["fp8"],
             decode_shape + " e4m3, bf16 scales", decode_src,
             decode_row + " fp8 mode", decode_extra(decode_t["fp8"])),
            ("paged_decode_split", "paged_decode_split", ("e",),
             split_err["bf16"], split_t["bf16"],
             split_shape + " split bf16 pools (f16 checked too)",
             decode_src, split_row,
             dict(split_extra["bf16"], f16_errs=split_err["f16"])),
            ("paged_decode_split_int8", "paged_decode_split", ("f",),
             split_err["int8"], split_t["int8"],
             split_shape + " split int8 pools, f32 scales", decode_src,
             split_row, split_extra["int8"]),
            ("paged_decode_split_fp8", "paged_decode_split", ("g",),
             split_err["fp8"], split_t["fp8"],
             split_shape + " split e4m3 pools, f32 scales", decode_src,
             split_row, split_extra["fp8"]),
            ("paged_prefill", "paged_prefill", ("a",), prefill_err["bf16"],
             prefill_t["bf16"], prefill_shape + ", bf16 pool (f16 checked "
             "too)", prefill_src, prefill_row, prefill_extra["bf16"]),
            ("paged_prefill_int8", "paged_prefill", ("b",),
             prefill_err["int8"], prefill_t["int8"], prefill_shape +
             ", int8 pool, bf16 scales (f32 scales checked too)",
             prefill_src, prefill_row + " int8 mode", prefill_extra["int8"]),
            ("paged_prefill_fp8", "paged_prefill", ("d",), prefill_err["fp8"],
             prefill_t["fp8"], prefill_shape + ", e4m3 pool, bf16 scales",
             prefill_src, prefill_row + " fp8 mode", prefill_extra["fp8"])):
        total, by_run = launched(kernel, *keys)
        entries.append(_entry(name, src, row, total, err, t, shape,
                              launches_by_run=by_run, **extra))
    # The backward kernels run on the train phase: launches per step.
    bwd_src = "aule_tpu_torch/csrc/flash_bwd.cu"
    for name, key, row in (
            ("flash_bwd_delta", "delta", "aule_tpu/ops/flash_vjp.py:746 "
             "(delta, an XLA fusion in JAX: no Pallas kernel)"),
            ("flash_bwd_dq", "dq", "aule_tpu/ops/flash_vjp.py:127 "
             "(_dq_kernel); aule_tpu/ops/flash_vjp.py:378 (_win_dq_kernel, "
             "its class checked and timed)"),
            ("flash_bwd_dkv", "dkv", "aule_tpu/ops/flash_vjp.py:271 "
             "(_dkv_kernel); aule_tpu/ops/flash_vjp.py:464 "
             "(_win_dkv_kernel, its class checked and timed)")):
        by_step = train[name]
        if 0 in by_step:
            raise AssertionError(f"{name} was not launched in a train step")
        err = bwd_err[key][:2] + (None,)
        entries.append(_entry(
            name, bwd_src, row, sum(by_step), err, bwd_t["layer"][key],
            f"B1 Hq32/Hkv8 S{TRAIN_S} D128 bf16 causal (library: the "
            f"backward of F.scaled_dot_product_attention, dq, dk and dv "
            f"together; for delta torch.linalg.vecdot(o, do), its rows "
            f"rounded to bf16)", launches_per_train_step=by_step,
            device_ms=bwd_t["layer"][key]["device_ms"],
            library_device_ms=bwd_t["layer"][key]["library_device_ms"],
            time_whole_backward=bwd_t["layer"]["both"],
            time_B4_S2048=bwd_t["B4"][key],
            time_window_256_S4096=bwd_t["window"][key]))
    # The public phase's kernel modes: launches on its counted public calls
    # (each mode's calls, counts set to 0 just before and read just after).
    fwd_row = "aule_tpu/ops/flash.py:92 (_fwd_kernel"
    shapes = {"gpt2": "GPT-2 small layer B1 Hq12/Hkv12 S1024 D64 bf16 causal",
              "f32": f"Llama-3-8B layer B1 Hq32/Hkv8 S{TRAIN_S} D128 f32 "
                     f"causal",
              "gpt2_f32": "GPT-2 small layer B1 Hq12/Hkv12 S1024 D64 f32 "
                          "causal",
              "d256_f32": f"B1 Hq8/Hkv1 S{TRAIN_S} D256 f32 causal (Gemma-2B's "
                          f"attention shape)",
              "d256": f"B1 Hq8/Hkv1 S{TRAIN_S} D256 bf16 causal (Gemma-2B's "
                      f"attention shape)"}
    generic_rows = {
        "fwd": fwd_row + ": its f32 branch at Precision.HIGHEST, l.147-152)",
        "delta": "aule_tpu/ops/flash_vjp.py:746 (delta, an XLA fusion in "
                 "JAX: no Pallas kernel)",
        "dq": "aule_tpu/ops/flash_vjp.py:127 (_dq_kernel, f32: Precision."
              "HIGHEST l.182); aule_tpu/ops/flash_vjp.py:378 (_win_dq_kernel, "
              "f32, its class checked)",
        "dkv": "aule_tpu/ops/flash_vjp.py:271 (_dkv_kernel, f32: Precision."
               "HIGHEST l.322); aule_tpu/ops/flash_vjp.py:464 (_win_dkv_kernel, "
               "f32, its class checked)"}
    # the tensor-core kernels at the head dims 64 and 256
    tc_rows = {
        "fwd": fwd_row + " at the D 64/256 tiles of _pick_blocks' d_scale, "
               "l.931); aule_tpu/ops/flash.py:638 (_mono_kernel's causal "
               "class)",
        "delta": generic_rows["delta"],
        "dq": "aule_tpu/ops/flash_vjp.py:127 (_dq_kernel at the D 64/256 "
              "tiles of d_scale, l.575); aule_tpu/ops/flash_vjp.py:378 "
              "(_win_dq_kernel)",
        "dkv": "aule_tpu/ops/flash_vjp.py:271 (_dkv_kernel at the D 64/256 "
               "tiles of d_scale, l.708); aule_tpu/ops/flash_vjp.py:464 "
               "(_win_dkv_kernel)"}
    tc_src = {"fwd": "aule_tpu_torch/csrc/flash_fwd.cu"}
    shapes.update({
        "f16_d64": "B1 Hq12/Hkv12 S512 D64 f16 causal",
        "f16_d256": "B1 Hq8/Hkv1 S1024 D256 f16 causal"})
    public_rows = [
        ("flash_fwd_rope", "aule_tpu_torch/csrc/flash_fwd.cu",
         fwd_row + ", use_rope: the rotation l.227-246); "
         "aule_tpu/ops/flash.py:638 (_mono_kernel, its RoPE l.692-715)",
         f"B1 Hq32/Hkv8 S{TRAIN_S} D128 bf16 causal, RoPE fused (theta "
         f"{LLAMA_ROPE_BASE:.0f}; library: SDPA on apply_rope'd q, k)"),
        ("flash_fwd_kv_len", "aule_tpu_torch/csrc/flash_fwd.cu",
         fwd_row + ", dynamic_kv_len: l.108, 121, 136)",
         f"B1 Hq32/Hkv8 Sq512 over a {BUCKET}-key bucket, kv_len 3000, "
         f"D128 bf16 (causal checked too; library: SDPA with a boolean key "
         f"mask)"),
        ("flash_fwd_decode_kv_len", "aule_tpu_torch/csrc/flash_fwd_short.cu",
         fwd_row + ", dynamic_kv_len) for the SDPA patch's bucketed decode "
         "(aule_tpu/integration/patching.py:220-238): split-KV "
         "(flash_fwd_decode_kernel)",
         f"B1 Hq32/Hkv8 1 query over a {BUCKET}-key bucket, kv_len "
         f"{BUCKET - 1}, D128 bf16 (f16 and RoPE checked too; CUDA-graph "
         f"replays at kv_len 0, 1, 1000, {BUCKET - 1}, {BUCKET}, captured "
         f"twice; library: SDPA with a boolean key mask)"),
    ]

    def library_note(mode, part):
        if part in ("dq", "dkv"):
            return " (library: the backward of SDPA, dq, dk and dv together)"
        if part == "delta":
            return (" (library: torch.linalg.vecdot(o, do)"
                    + ("" if mode == "f32" else ", its rows rounded to the "
                       "input type") + ")")
        return ""

    f32_names = {"fwd": ("flash_f32_fwd", "flash_f32.cu"),
                 "delta": ("flash_generic_delta", "flash_generic.cu"),
                 "dq": ("flash_f32_bwd_dq", "flash_f32_bwd.cu"),
                 "dkv": ("flash_f32_bwd_dkv", "flash_f32_bwd.cu")}
    public_rows += [(f32_names[part][0] + f"_{mode}",
                     "aule_tpu_torch/csrc/" + f32_names[part][1],
                     generic_rows[part], shapes[mode]
                     + library_note("f32", part))
                    for mode in ("f32", "gpt2_f32", "d256_f32")
                    for part in ("fwd", "delta", "dq", "dkv")]
    public_rows.append((
        "rope_prepass", "aule_tpu_torch/csrc/rope_prepass.cu",
        fwd_row + ", use_rope l.227-246: the rotation of each K chunk, done "
        "here once a call; also _mono_kernel's, l.692-715)",
        f"B1 Hkv8 S{TRAIN_S} D128 bf16 K, RoPE theta "
        f"{LLAMA_ROPE_BASE:.0f} (launched by every RoPE call on the TMA "
        f"kernel; bf16 / f16 at D 64, 128, 256 and short tables checked "
        f"too; library: none)"))
    public_rows += [(("flash_fwd" if part == "fwd" else f"flash_bwd_{part}")
                     + f"_{mode}",
                     tc_src.get(part, "aule_tpu_torch/csrc/flash_bwd.cu"),
                     tc_rows[part], shapes[mode] + library_note(mode, part))
                    for mode in ("gpt2", "d256", "f16_d64", "f16_d256")
                    for part in ("fwd", "delta", "dq", "dkv")]
    mode_src = {"flash_fwd": "aule_tpu_torch/csrc/flash_fwd.cu",
                "flash_fwd_short": "aule_tpu_torch/csrc/flash_fwd_short.cu",
                "flash_fwd_decode": "aule_tpu_torch/csrc/flash_fwd_short.cu",
                "flash_f32_fwd": "aule_tpu_torch/csrc/flash_f32.cu"}
    for name, cases in PUBLIC_MODES.items():
        what, kernel, (b, hq, hkv), *_, d, dt = cases[0][:7]
        public_rows.append((
            name, mode_src[kernel],
            fwd_row + ", use_rope l.227-246 and dynamic_kv_len l.108, 121, "
            "136)", f"B{b} Hq{hq}/Hkv{hkv} D{d} "
            f"{str(dt).replace('torch.', '')}, {what} (timed; every case "
            f"under 'cases'; library: SDPA on the rotated q, k with the "
            f"case's boolean mask)"))
    for name, src, row, shape in public_rows:
        launches = public["launches"].get(name, 0)
        if launches == 0:
            raise AssertionError(f"{name} was not launched in the public "
                                 f"phase")
        t = public["time"][name]
        extra = {k: t[k] for k in ("device_ms", "library_device_ms",
                                   "graph_replay_ms", "launches_note",
                                   "nsplit", "short_kernel_device_ms",
                                   "ffma_bound_ms")
                 if k in t}
        if name in public["cases"]:
            extra["cases"] = public["cases"][name]
        part = {"flash_f32_bwd_dq_f32": "dq",
                "flash_f32_bwd_dkv_f32": "dkv"}.get(name)
        if part is not None:
            # the f32 backward's case list (check_flash_bwd_f32)
            extra["f32_bwd_cases"] = {c: e[part]
                                      for c, e in f32_bwd_cases.items()}
            extra["f32_bwd_cases_worst"] = f32_bwd_err[part]
        if name == "flash_fwd_gpt2":
            # GPT-2 small's bf16 whole-prompt serving prefills its prompts
            # above SHORT_SQ tokens through this mode (run_engine checks
            # the count against the rule)
            served = gpt2["runs"]["bf16"]["flash_fwd"]
            if served == 0:
                raise AssertionError("the GPT-2 bf16 whole-prompt run "
                                     "launched no TMA forward")
            extra["launches_gpt2_bf16_whole_prompt_serving"] = served
        if name == "flash_f32_fwd_gpt2_f32":
            # GPT-2 small's f32 whole-prompt serving prefills through this
            # mode at D64 (run_engine checks the count against the rule)
            served = gpt2["runs"]["f32"]["flash_fwd_f32"]
            if served == 0:
                raise AssertionError("the GPT-2 f32 whole-prompt run "
                                     "launched no f32 forward")
            extra["launches_gpt2_f32_whole_prompt_serving"] = served
        entries.append(_entry(name, src, row, launches, public["err"][name],
                              t, shape, **extra))
    entries += gpt2_entries(gpt2)
    entries += gqa_entries(llama32, group_err)
    entries += mistral_entries(mistral)
    add_moe_adamw_launches(entries, moe, adamw)
    add_edge_launches(entries, edges)
    spec_entries(entries, spec)
    parallel_entries(entries, par)
    parallel_model_entries(entries, pm)
    head_dim_entries(entries, hd)
    add_frontend_launches(entries, fe)
    add_script_launches(entries, sc)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--public"]:
        child_main(check_public)
    elif sys.argv[1:] == ["--gpt2"]:
        child_main(check_gpt2)
    elif sys.argv[1:] == ["--llama32"]:
        child_main(check_llama32)
    elif sys.argv[1:] == ["--mistral"]:
        child_main(check_mistral)
    elif sys.argv[1:] == ["--moe"]:
        child_main(check_moe)
    elif sys.argv[1:] == ["--adamw"]:
        child_main(check_adamw)
    elif sys.argv[1:] == ["--spec"]:
        child_main(check_spec)
    elif sys.argv[1:] == ["--parallel"]:
        child_main(check_parallel)
    elif sys.argv[1:] == ["--parallel-model"]:
        child_main(check_parallel_model)
    elif sys.argv[1:] == ["--head-dims"]:
        child_main(check_head_dims)
    elif sys.argv[1:] == ["--frontends"]:
        child_main(check_frontends)
    elif sys.argv[1:] == ["--scripts"]:
        child_main(check_scripts)
    else:
        main()
