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
     layer and GPT-2's layer in f32, forward on csrc/flash_f32.cu (3xTF32
     on the tensor cores), backward on csrc/flash_f32_bwd.cu (3xTF32) with
     csrc/flash_generic.cu's delta; the SDPA
     patch (install, an attn_mask call reaching torch's own function,
     uninstall); the forward's RoPE, kv_len, window and GQA modes
     (PUBLIC_MODES; f32 at D 64, 128 and 256 too); each mode timed beside
     its bound and one PyTorch call;
  6. gpt2, in a process of its own (`python3 chip_smoke.py --gpt2` runs it
     alone): csrc/paged_generic.cu's decode and prefill (f32),
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
     and chunk 256), each checked as the Llama runs are (launches: the
     decode 12 times a step and the chunked prefill 12 times a chunk, on
     paged_generic.cu in f32, on paged_decode.cu / paged_prefill.cu in
     bf16, the other family never;
     pages; tokens against a teacher-forced plain forward or
     plain-attention replay, the f32 runs within GPT2_F32_NEAR_TIE), and
     one f32 prefill step and decode dispatch under torch.profiler;
  6b. llama32, in a process of its own (`python3 chip_smoke.py --llama32`
     runs it alone): the paged decode's device times at B8 ctx4096 at GQA
     groups 4, 3 (Llama-3.2-3B's: the same bytes), 12 and 32, and the
     paged prefill's at groups 4 and 3, beside their bounds and SDPA;
     then Llama-3.2-3B (LLAMA32_3B: 24 q over 8 kv heads, 28 layers, full
     width and depth, random bf16 weights) serves the 12 requests six
     times (LLAMA32_RUNS: bf16 whole and chunk 512, int8 chunk, fp8
     whole, split bf16 and int8), checked as the Llama-3-8B runs are;
  6c. mistral, in a process of its own (`--mistral`): Mistral-7B
     (LlamaConfig.mistral_7b(), its 4096-token window, full width and
     depth) serves 4 requests of 4,200 to 6,000 prompt tokens whole and
     with prefill_chunk=512, each held to a teacher-forced plain forward;
  7. engine: a full-width, full-depth Llama-3-8B (random bf16 weights from
     a seeded generator on the card) serves the same 12 greedy requests
     eight times through `ServingEngine`: over fused pools, bf16 with
     whole-prompt prefill, (a) bf16 with prefill_chunk=512, (b) int8 with
     prefill_chunk=512, (c) fp8 with whole-prompt prefill, (d) fp8 with
     prefill_chunk=512; over split pools (layout="split", whole-prompt
     prefill), (e) bf16, (f) int8 and (g) fp8.  Each run checks its launch
     counts against its dispatches (the split runs launch the split decode
     32 times a step and the fused decode never) and that every page comes
     back.  The bf16 runs hold every token against a teacher-forced plain
     forward; (b)-(d), (f) and (g) against a teacher-forced replay of the
     same steps with the plain attention versions;
  8. breakdown: one prefill step and one 8-step decode dispatch of the
     engine under torch.profiler (device busy share, kernel time by
     category) for bf16, int8 chunked, fp8 chunked and int8 split pools;
  9. train: the same full-width, full-depth Llama-3-8B weights, made to
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
     calls);
  11. last line: {"ok": true, "device": {...}}, printed only when every
     phase passed.  Any failure raises and the exit code is non-zero.

About 7 minutes on an H100, the build included.
"""

from __future__ import annotations

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
]


def check_flash_bwd_f32():
    """The f32 backward's kernels (flash_generic.cu's delta, flash_f32_bwd.
    cu's dQ and dK/dV; at D 256 flash_generic.cu's FFMA dK/dV, as
    `f32_dkv_kernel` routes it) against their plain versions over
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
        dkv = fv.f32_dkv_kernel(q)
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
    fv.flash_bwd_generic_dkv.launches = fv.attention_delta_generic.launches = 0
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


ENGINE_KW = dict(max_batch=8, page_size=16, num_pages=2100,
                 max_pages_per_seq=272, max_seq_len=4352, decode_steps=8)
CHUNK = 512


def _launch_counters():
    from aule_tpu_torch.ops.flash import (flash_fwd_decode, flash_fwd_f32,
                                         flash_fwd_short, flash_fwd_tma)
    from aule_tpu_torch.ops.paged import paged_attention
    from aule_tpu_torch.ops.paged_fused import paged_attention_fused
    from aule_tpu_torch.ops.paged_generic import (paged_generic_decode,
                                                  paged_generic_prefill)
    from aule_tpu_torch.ops.paged_prefill import paged_attention_prefill

    return {"flash_fwd": flash_fwd_tma, "flash_fwd_short": flash_fwd_short,
            "flash_fwd_decode": flash_fwd_decode,
            "flash_fwd_f32": flash_fwd_f32,
            "paged_decode": paged_attention_fused,
            "paged_decode_split": paged_attention,
            "paged_prefill": paged_attention_prefill,
            "paged_generic_decode": paged_generic_decode,
            "paged_generic_prefill": paged_generic_prefill}


def run_engine(params, cfg, prompts, label, model=None, engine_kw=ENGINE_KW,
               **kw):
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
    its chunks on paged_generic.cu, a bf16 one on paged_decode.cu and
    paged_prefill.cu at every head dim, and the other family never) and
    that every page came back."""
    from aule_tpu_torch.serving.engine import ServingEngine

    eng = ServingEngine(params, cfg, device=DEV, model=model, **engine_kw,
                        **kw)
    pools = [t for t in (eng.kv_pages, eng.kv_scales, eng.k_pages,
                         eng.v_pages, eng.k_scales, eng.v_scales)
             if t is not None]
    pool_gib = sum(t.numel() * t.element_size() for t in pools) / 2**30
    for p in prompts:
        eng.submit(p, NEW_TOKENS)
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
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
    if len(done) != n_req or any(len(r.output) != NEW_TOKENS for r in done):
        raise AssertionError(f"{label}: not every request finished with "
                             f"{NEW_TOKENS} tokens")
    from aule_tpu_torch.ops.flash import forward_kernel
    from aule_tpu_torch.ops.paged_generic import (prefill_uses_generic,
                                                  uses_generic_kernels)

    layers = cfg.n_layers
    chunked = kw.get("prefill_chunk") is not None
    split = kw.get("layout") == "split"
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
    want["paged_generic_prefill" if prefill_uses_generic(row)
         else "paged_prefill"] = prefill if chunked else 0
    if chunked and st["prefill_dispatches"] != sum(
            -(-n // kw["prefill_chunk"]) for n in lens):
        raise AssertionError(f"{label}: {st['prefill_dispatches']} prefill "
                             f"dispatches for chunks of "
                             f"{kw['prefill_chunk']}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} != dispatches "
                             f"x {layers} layers {want}")
    if st["free_pages"] != engine_kw["num_pages"] - 1:
        raise AssertionError(f"{label}: pages leaked: {st['free_pages']} "
                             f"free")
    outputs = [list(r.output) for r in done]
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


def check_plain_forward(params, cfg, prompts, outputs, label, model=None,
                        tie=NEAR_TIE):
    """Teacher-forced plain forward (flash's plain version) over prompt +
    output: the check of the unquantized runs (`model`: Llama unless
    given)."""
    from aule_tpu_torch.models import llama
    from aule_tpu_torch.ops.flash_vjp import flash_attention_vjp_plain

    model = model or llama
    agree = _Agreement(label, tie)
    with torch.no_grad():
        for i, (p, out) in enumerate(zip(prompts, outputs)):
            seq = np.concatenate([p, np.asarray(out[:-1], np.int32)])
            tokens = torch.from_numpy(seq.astype(np.int64))[None].to(DEV)
            logits = model.forward(params, tokens, cfg,
                                   attention=flash_attention_vjp_plain)[0]
            agree.add(logits[len(p) - 1:], torch.tensor(out, device=DEV),
                      f"request {i} (prompt {len(p)})")
            del logits
    agree.report("teacher-forced plain forward")


def check_replay(params, cfg, prompts, outputs, label, quant_dtype, chunk,
                 layout="fused", model=None, engine_kw=ENGINE_KW,
                 tie=NEAR_TIE):
    """Teacher-forced replay of a quantized run's steps with the plain
    attention versions: each prompt is prefilled alone into fresh pools of
    the run's layout written the same way (chunked through
    prefill_step_fused, or a whole forward plus the quantized append), then
    all requests decode together through decode_step_fused or, over split
    pools, decode_step, fed the engine's tokens (`model`: Llama unless
    given; `engine_kw`: the run's engine settings; `tie`: the near-tie
    allowance)."""
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
    need = [-(-(len(p) + NEW_TOKENS) // page) for p in prompts]
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
    out_t = torch.tensor(outputs, device=dev)          # [R, NEW_TOKENS]
    agree = _Agreement(label, tie)

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
                        attention=paged_attention_prefill_plain)[0][0]
            else:
                full, kv = model.forward(
                    params, tokens, cfg, rope_cos=cos, rope_sin=sin,
                    return_kv=True, attention=flash_attention_vjp_plain)
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
            agree.add(logits[None], out_t[i, :1], f"request {i} prefill")
        lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                            device=dev)
        for t in range(NEW_TOKENS - 1):
            if layout == "fused":
                logits = model.decode_step_fused(
                    params, out_t[:, t], lens, pools[0], bt, lens, cfg, cos,
                    sin, pools[1], attention=paged_attention_fused_plain)[0]
            else:
                logits = model.decode_step(
                    params, out_t[:, t], lens, *pools[:2], bt, lens, cfg,
                    cos, sin, *pools[2:],
                    attention=paged.paged_attention_plain)[0]
            agree.add(logits, out_t[:, t + 1], f"decode step {t}")
            lens = lens + 1
    agree.report("teacher-forced replay with the plain attention versions")
    pools.clear()
    torch.cuda.empty_cache()


def phase_engine():
    """Eight engine runs of the 12 prompts on a full-width, full-depth
    Llama-3-8B: over fused pools bf16 whole-prompt, (a) bf16 chunked, (b)
    int8 chunked, (c) fp8 whole-prompt, (d) fp8 chunked; over split pools
    (layout="split", whole-prompt prefill) (e) bf16, (f) int8 and (g)
    fp8."""
    from aule_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b()
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
              "paged_generic_prefill": ["paged_generic_prefill"],
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
    torch.profiler, for bf16 pools with whole-prompt prefill, for int8
    and fp8 pools with prefill_chunk=512 (that step is four chunks) and for
    int8 split pools with whole-prompt prefill (run (f)'s configuration)."""
    from aule_tpu_torch.serving.engine import ServingEngine
    from aule_tpu_torch.utils import profiling

    for label, kw in (("bf16", {}),
                      ("int8 chunk 512", dict(quantized=True,
                                              prefill_chunk=CHUNK)),
                      ("fp8 chunk 512", dict(
                          quantized=True, quant_dtype=torch.float8_e4m3fn,
                          prefill_chunk=CHUNK)),
                      ("int8 split", dict(quantized=True, layout="split"))):
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


def check_grads(params, cfg, tokens) -> None:
    """Every parameter's gradient of loss_fn through the kernels against
    the plain path's (flash_attention_fwd_plain + flash_attention_bwd_plain
    on the card), on the same weights cut to 2 layers (views, full width);
    relative Frobenius error within GRAD_TOL, all finite."""
    import dataclasses

    from aule_tpu_torch.models import llama
    from aule_tpu_torch.ops.flash_vjp import (flash_attention_vjp,
                                              flash_attention_vjp_plain)

    small = dict(params, layers=params["layers"][:2])
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    tensors = list(llama._tensors(small))
    names = ["embed", "final_norm", "lm_head"] + [  # llama._tensors' order
        f"layers.{li}.{key}" for li, layer in enumerate(small["layers"])
        for key in layer]
    got = {}
    for name, attention in (("kernel", flash_attention_vjp),
                            ("plain", flash_attention_vjp_plain)):
        loss = llama.loss_fn(small, tokens, cfg2, attention=attention)
        got[name] = (float(loss.detach()),
                     torch.autograd.grad(loss, tensors))
        del loss
    worst, worst_name = 0.0, ""
    for name, g, r in zip(names, got["kernel"][1], got["plain"][1]):
        rel = float((g.float() - r.float()).norm() / r.float().norm())
        if not (bool(torch.isfinite(g).all()) and rel <= GRAD_TOL):
            raise AssertionError(f"gradient check: {name} relative error "
                                 f"{rel:.3e} (<= {GRAD_TOL}) or not finite")
        if rel >= worst:
            worst, worst_name = rel, name
    log(f"train gradient check, 2 layers full width S{TRAIN_S}: loss kernel "
        f"{got['kernel'][0]:.6f} plain {got['plain'][0]:.6f}; "
        f"{len(tensors)} gradients, largest relative Frobenius error "
        f"{worst:.3e} ({worst_name}) <= {GRAD_TOL} ok")
    del got
    torch.cuda.empty_cache()


def phase_train(params, cfg) -> dict:
    """Three SGD steps of the full-width, full-depth model on one batch of
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
            "flash_generic_dkv": fv.flash_bwd_generic_dkv,
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
            ("gpt2_f32", GPT2, 1024, 64, 3, torch.float32)):
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


# ---- the GPT-2 phase: csrc/paged_generic.cu and GPT-2 small serving, in a
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
    tails, shuffled pages with a window, 64-token pages) in both; D64 group
    2 with a window of 64 and D256 group 8 in 16 bits; f32 at the Llama
    layer (D128 group 4) and at D256 group 8.  Over split pools (f32
    scales), the same values in every mode but the int8 dot products (f32:
    GPT-2's cases; 16 bits: every case) must give the fused kernel's bits,
    and are held to the split plain version."""
    from aule_tpu_torch.ops.paged import paged_attention, paged_attention_plain
    from aule_tpu_torch.ops.paged_fused import (paged_attention_fused,
                                                paged_attention_fused_plain)
    from aule_tpu_torch.ops.paged_generic import paged_generic_decode

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
    csrc/paged_generic.cu, 16-bit q on csrc/paged_prefill.cu's tensor
    cores (TC_PREFILL_MODES: bf16 and f16 pools, int8 and e4m3 pools with
    bf16 q and bf16 scales, with f16 q and f32 scales).  GPT-2's 256-token
    chunk at q_offset 768 over 1024 (and with a 128 window), a ragged
    batch of 4 whose padding rows must be exact zeros, 64-token pages with
    a 1-token chunk; D256 group 8 (a chunk of 256 at 1000, a ragged batch
    of 3); D64 group 2 with a window; f32 at the Llama layer (a 512 chunk
    at 3488 over 4000)."""
    from aule_tpu_torch.config import DEFAULT_MASK_VALUE
    from aule_tpu_torch.ops.paged_generic import paged_generic_prefill
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
            kernel = paged_attention_prefill if tc else paged_generic_prefill
            what = (f"{'tensor-core' if tc else 'generic'} prefill {mode} "
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
# (label, q dtype, head dim): f32 q over every pool on csrc/paged_generic.cu,
# bf16 q over bf16, int8 and e4m3 pools on the tensor-core kernels.
GEN_GROUPS = (3, 6, 12)
GEN_GROUP_TYPES = (("f32 D128", torch.float32, 128),
                   ("f32 D64", torch.float32, 64),
                   ("bf16 D64", torch.bfloat16, 64))


def _generic_group_checks(res):
    """The paged decode (both layouts, no window and a trailing window of
    64; paged_generic.cu's for f32 q, paged_decode.cu's for bf16 q) and the
    prefill (window 64; paged_generic.cu's for f32 q, paged_prefill.cu's
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
    q_offset 768 over 1024 (f32 q on paged_generic.cu, bf16 q on
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
               for m in TC_DECODE_MODES[:2]]):
        _decode_mode_times(gen, res, key, mode, lens, heads, max_pages,
                           split)
    # the prefill at GPT-2's chunk in every mode of GEN_PREFILL_MODES (f32
    # q on paged_generic.cu, bf16 on paged_prefill.cu) and with bf16 q over
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
        res["time"][("tc prefill " if tc else "prefill ") + mode] = \
            _mode_time(
            f"{'tensor-core' if tc else 'generic'} prefill time {mode} "
            f"chunk {chunk} at {hist} over {hist + chunk} Hq{hq}/Hkv{hkv} "
            f"D{d} page16",
            lambda: paged_attention_prefill(q, pl, bt, ln, **kw),
            lambda: paged_attention_prefill_plain(q, pl, bt, ln, **kw),
            lambda: SDPA(q, kd, vd, attn_mask=mask),
            "paged_prefill_kernel" if tc else "paged_generic_prefill",
            2 * q.numel() * esz + profiling.paged_kv_bytes(
                hist + chunk, hkv, d, esz if qdt is None else 1,
                0 if qdt is None else 2) + max_pages * 4 + 3 * 4,
            flops, _rate(dt))
        del kd, vd, kh, vh


# GPT-2 small's serving runs: (key, label, bf16 model, engine options,
# check: "plain" forward or quantized "replay", near-tie allowance).  The
# f32, int8 and fp8 chunked runs put every pool mode of the generic prefill
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


def _gpt2_serving(res):
    """GPT-2 small at full width and depth (GPT2Config(): vocab 50,257, 12
    layers of 12 heads, D64; random f32 weights from a seeded generator on
    the card, and the same cast to bf16) serves 12 greedy requests of 7 to
    1,000 prompt tokens, 24 new tokens each, through
    ServingEngine(model=gpt2) in every run of GPT2_RUNS, each checked by
    run_engine (launches: the paged decode 12 times a step and the prefill
    12 times a chunk, paged_generic.cu's in f32, paged_decode.cu's and
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
        if check == "plain":
            check_plain_forward(p, c, prompts, out, label, model=gpt2,
                                tie=tie)
        else:
            check_replay(p, c, prompts, out, label, kw["quant_dtype"]
                         if "quant_dtype" in kw else torch.int8,
                         kw.get("prefill_chunk"), model=gpt2,
                         engine_kw=GPT2_ENGINE_KW, tie=tie)
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
    """The GPT-2 phase: csrc/paged_generic.cu's kernels, and
    csrc/paged_decode.cu and csrc/paged_prefill.cu at D 64/256, held to
    their plain versions and timed, then GPT-2 small served.  Returns the
    errors, times and launches."""
    from aule_tpu_torch.ops.paged_generic import (paged_generic_decode,
                                                  paged_generic_prefill)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(GPT2_SEED)
    res = {"err": {}, "time": {}, "launches": {}, "runs": {}}
    _generic_decode_checks(gen, res)
    _generic_prefill_checks(gen, res)
    _generic_group_checks(res)
    _generic_timings(gen, res)
    paged_generic_decode.launches = paged_generic_prefill.launches = 0
    _gpt2_serving(res)
    return res


# Llama-3.2-3B (meta-llama/Llama-3.2-3B, config.json): 24 q heads over 8
# kv heads, GQA group 3, D128, 28 layers.  Neither package has tied
# embeddings or the llama3 RoPE scaling, so the head is untied and RoPE
# plain: no attention shape changes (~3.61 B parameters).
LLAMA32_3B = dict(vocab_size=128256, dim=3072, n_layers=28, n_heads=24,
                  n_kv_heads=8, hidden_dim=8192, rope_base=500000.0,
                  norm_eps=1e-5)
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


def _serve(params, cfg, prompts, runs, res, engine_kw=ENGINE_KW):
    """Serve the prompts once per run of `runs` ((key, label, engine
    options, quantized payload dtype or None)), each checked by run_engine
    and held to a teacher-forced plain forward (unquantized) or a
    plain-attention replay (quantized)."""
    for key, label, kw, qdt in runs:
        out, res["runs"][key] = run_engine(params, cfg, prompts, label,
                                           engine_kw=engine_kw, **kw)
        if qdt is None:
            check_plain_forward(params, cfg, prompts, out, label)
        else:
            check_replay(params, cfg, prompts, out, label, qdt,
                         kw.get("prefill_chunk"),
                         layout=kw.get("layout", "fused"),
                         engine_kw=engine_kw)


def check_llama32() -> dict:
    """The GQA phase: the decode's and the prefill's times at groups 3, 4,
    12 and 32 (_gqa_decode_times, _gqa_prefill_times), then Llama-3.2-3B
    at full width and depth (LLAMA32_3B, random bf16 weights from SEED on
    the card) serving the 12 prompts of PROMPT_LENS, 24 new tokens each,
    through ServingEngine(**ENGINE_KW) in every run of LLAMA32_RUNS.
    Returns the times and each run's launches."""
    from aule_tpu_torch.models import llama

    log(card_line())
    res = {"time": {}, "err": {}, "runs": {}}
    _gqa_decode_times(res)
    _gqa_prefill_times(res)
    cfg = llama.LlamaConfig(**LLAMA32_3B)
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


def child_main(check) -> None:
    """`chip_smoke.py --public`, `--gpt2`, `--llama32` or `--mistral`: that
    phase alone, its result as one JSON line last."""
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
    """The GPT-2 phase's kernel modes (csrc/paged_generic.cu for f32 q;
    csrc/paged_decode.cu and csrc/paged_prefill.cu for 16-bit q at D 64 /
    256), each with its launches on the GPT-2 serving runs that use it;
    the split layout, which GPT-2 serving does not take, and D256 with
    their launches on the phase's counted checks."""
    src = "aule_tpu_torch/csrc/paged_generic.cu"
    design = ("FFMA, the int8 dot products' scores on __dp4a; K/V tiles "
              "gathered into f32 shared memory, only the D live lanes of a "
              "row read; decode split-KV with paged_decode.cu's partition, "
              "the splits merged in split order in the same launch")
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
                                                           "f32 chunk"),
             "f32 pools"),
            ("paged_generic_decode_int8", "decode", "int8 dot",
             ("int8 chunk",), "int8 pools, bf16 scales, f32 q, int8 dot "
             "products"),
            ("paged_generic_decode_fp8", "decode", "fp8", ("fp8",
                                                           "fp8 chunk"),
             "e4m3 pools, bf16 scales, f32 q"),
            ("paged_generic_prefill_f32", "prefill", "f32", ("f32 chunk",),
             "f32 pool"),
            ("paged_generic_prefill_int8", "prefill", "int8",
             ("int8 chunk",), "int8 pool, bf16 scales, f32 q"),
            ("paged_generic_prefill_fp8", "prefill", "fp8", ("fp8 chunk",),
             "e4m3 pool, bf16 scales, f32 q")):
        kernel = f"paged_generic_{kind}"
        by_run = {k: runs[k][kernel] for k in keys}
        for k, count in by_run.items():
            if count == 0:
                raise AssertionError(f"{kernel} was not launched in GPT-2 "
                                     f"run {k}")
        t = times[f"{kind} {mode}"]
        extra = dict(design=design, launches_by_run=by_run, **dev(t),
                     other_shapes=shapes(f"{kind} {mode}"))
        if mode == "int8 dot":
            # the int8 exact path (int8_matmul=False) is checked and timed,
            # not launched on the main path
            extra.update(int8_exact_errs=err["decode int8 exact"],
                         int8_exact_device_ms=times["decode int8 exact"][
                             "device_ms"],
                         int8_exact_other_shapes=shapes("decode int8 exact"))
        entries.append(_entry(
            name, src, decode_row if kind == "decode" else prefill_row,
            sum(by_run.values()), err[f"{kind} {mode}"], t,
            f"{decode_shape if kind == 'decode' else prefill_shape}, {pool}",
            **extra))
    # 16-bit q at D 64 / 256: csrc/paged_prefill.cu's tensor cores, on the
    # bf16 chunked run
    by_run = {"bf16 chunk": runs["bf16 chunk"]["paged_prefill"]}
    if by_run["bf16 chunk"] == 0 or runs["bf16 chunk"][
            "paged_generic_prefill"]:
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
        "paged_generic_decode_split", src, split_row, launches, worst,
        times["split f32"], "GPT-2 small decode B8 ctx1024 page16 "
        "Hq12/Hkv12 D64, split f32 pools (int8 and fp8 with f32 scales "
        "checked and timed too)", design=design,
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


def main() -> None:
    from aule_tpu_torch.ops.flash import SHORT_SQ

    t_start = time.perf_counter()
    kind = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    flash_err, flash_t = check_flash(gen)
    decode_err, decode_t = check_decode(gen)
    split_err, split_t = check_decode_split(gen)
    prefill_err, prefill_t = check_prefill(gen)
    group_err = check_groups(gen, decode_err, prefill_err, split_err)
    # before the engine's profiled phases: after many profiled sessions in
    # one process torch.profiler loses kernels, and these times read it
    bwd_err, bwd_t = check_flash_bwd(gen)
    t_phase = time.perf_counter()
    f32_bwd_err, f32_bwd_cases = check_flash_bwd_f32()
    log(f"phase f32 backward cases: {time.perf_counter() - t_phase:.1f} s")
    public = phase_public()
    gpt2 = phase_gpt2()
    llama32 = phase_llama32()
    mistral = phase_mistral()
    runs, params, cfg = phase_engine()
    phase_breakdown(params, cfg)
    train = phase_train(params, cfg)  # last: it rewrites the weights
    del params
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s, the build included")
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
                    for mode in ("f32", "gpt2_f32")
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
    else:
        main()
