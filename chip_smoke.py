"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing a line of its own:
  1. device: exits non-zero without CUDA (there is no CPU fallback);
     prints the card's name and power limit (nvidia-smi);
  2. build: compiles aule_tpu_torch/csrc/*.cu with nvcc for sm_90a;
  3. kernels: each hand-written kernel against its plain PyTorch version
     on the card in bf16 (max-abs error <= 2e-2 on unit-normal inputs),
     with its time at the engine's shapes (median of 20 CUDA-event timed
     runs), its bound, the plain version's time and a library yardstick's
     time (F.scaled_dot_product_attention; timed only, the port never
     calls it);
  4. engine: a full-width, full-depth Llama-3-8B (random bf16 weights from
     a seeded generator on the card) serves 12 greedy requests through
     `ServingEngine`; launch counts are checked against the dispatches, and
     every emitted token is held against a teacher-forced forward with the
     plain attention versions;
  5. breakdown: one prefill step and one 8-step decode dispatch of the
     engine under torch.profiler (device busy share, kernel time by
     category);
  6. a `kernels` JSON line;
  7. last line: {"ok": true, "device": {...}}, printed only when every
     phase passed.  Any failure raises and the exit code is non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

TOL = 2e-2            # bf16 kernels vs their f32-internal plain versions
# Teacher-forced agreement: the engine's token is the plain argmax, or its
# logit is within NEAR_TIE of the plain max.  Logits are bf16 products
# (lm_head in bf16, then f32): at |logit| in [4, 8) one bf16 step is
# 0.03125, and the two paths round their matmuls in different orders, so
# 4 steps is the allowance for a bf16 near-tie.
NEAR_TIE = 0.125
SEED = 0


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
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  ptxas {line.strip()}")


def _randn(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_flash(gen):
    from aule_tpu_torch.ops.flash import (flash_attention_fwd,
                                          flash_attention_fwd_plain)
    from aule_tpu_torch.utils import profiling

    worst = 0.0
    cases = [  # (label, Sq, Sk, causal, window, dtype)
        ("S512 causal (_fwd_kernel class)", 512, 512, True, -1,
         torch.bfloat16),
        ("S2048 causal (_mono_kernel class)", 2048, 2048, True, -1,
         torch.bfloat16),
        ("S777 non-causal", 777, 777, False, -1, torch.bfloat16),
        ("Sq300 Sk900 causal", 300, 900, True, -1, torch.bfloat16),
        ("Sq300 Sk900 non-causal", 300, 900, False, -1, torch.bfloat16),
        ("S1024 causal window 256", 1024, 1024, True, 256, torch.bfloat16),
        ("S1024 non-causal window 256", 1024, 1024, False, 256,
         torch.bfloat16),
        ("S512 causal f16", 512, 512, True, -1, torch.float16),
    ]
    for label, sq, sk, causal, window, dt in cases:
        q = _randn((1, 32, sq, 128), gen, dt)
        k = _randn((1, 8, sk, 128), gen, dt)
        v = _randn((1, 8, sk, 128), gen, dt)
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     window_size=window, return_lse=True)
        po, plse = flash_attention_fwd_plain(q, k, v, causal=causal,
                                             window_size=window,
                                             return_lse=True)
        torch.cuda.synchronize()
        e_o, e_l = _err(o, po), _err(lse, plse)
        ok = e_o <= TOL and e_l <= TOL and bool(torch.isfinite(o).all())
        log(f"flash {label}: max|out-plain| {e_o:.3e} "
            f"max|lse-plain| {e_l:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees: {label}")
        worst = max(worst, e_o, e_l)

    timings = {}
    for s in (512, 2048):
        q = _randn((1, 32, s, 128), gen)
        k = _randn((1, 8, s, 128), gen)
        v = _randn((1, 8, s, 128), gen)
        kx = k.repeat_interleave(4, dim=1)
        vx = v.repeat_interleave(4, dim=1)
        ms = profiling.cuda_time_ms(lambda: flash_attention_fwd(
            q, k, v, causal=True, return_lse=False), iters=20)
        plain = profiling.cuda_time_ms(lambda: flash_attention_fwd_plain(
            q, k, v, causal=True, return_lse=False), iters=20)
        lib = profiling.cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, is_causal=True), iters=20)
        flops = profiling.attention_flops(1, 32, s, s, 128, causal=True)
        nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
        bound, by = profiling.bound_ms(nbytes, flops)
        timings[s] = dict(ms=ms[0], plain_ms=plain[0], library_ms=lib[0],
                          bound_ms=bound, bound_by=by)
        log(f"flash time B1 Hq32/Hkv8 S{s} D128 bf16 causal: kernel "
            f"{ms[0]:.4f} ms (min {ms[1]:.4f} max {ms[2]:.4f}), "
            f"{flops / ms[0] / 1e9:.1f} TFLOP/s; plain {plain[0]:.4f} ms; "
            f"sdpa {lib[0]:.4f} ms; bound {bound:.4f} ms ({by})")
    flash_attention_fwd.launches = 0
    return worst, timings


def _decode_inputs(gen, lens, max_pages, page=16, shuffle=False):
    """A fused pool holding len_b tokens per sequence; tables -1 past the
    used pages; page 0 scratch filled with garbage."""
    from aule_tpu_torch.ops.paged_fused import fused_pool_shape

    batch = len(lens)
    used = [-(-n // page) for n in lens]
    num_pages = 1 + sum(used)
    pool = _randn(fused_pool_shape(num_pages, 8, page, 128), gen)
    pool[0] = 1e4
    ids = np.arange(1, num_pages)
    if shuffle:
        ids = np.random.default_rng(SEED).permutation(ids)
    bt = np.full((batch, max_pages), -1, np.int32)
    at = 0
    for b, n in enumerate(used):
        bt[b, :n] = ids[at:at + n]
        at += n
    q = _randn((batch, 32, 128), gen)
    return (q, pool, torch.from_numpy(bt).cuda(),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def check_decode(gen):
    from aule_tpu_torch.ops.paged_fused import (paged_attention_fused,
                                                paged_attention_fused_plain)
    from aule_tpu_torch.utils import profiling

    worst = 0.0
    cases = [  # (label, lens, shuffle, window)
        ("B8 ctx4096 contiguous", [4096] * 8, False, -1),
        ("mixed 0/1/17/4096 with -1 entries",
         [0, 1, 17, 4096, 4095, 100, 2000, 3000], False, -1),
        ("shuffled page ids", [4096, 1, 17, 333, 4096, 2048, 64, 3001],
         True, -1),
        ("trailing window 1001", [0, 1, 17, 4096, 4095, 100, 2000, 3000],
         True, 1001),
    ]
    for label, lens, shuffle, window in cases:
        q, pool, bt, ln = _decode_inputs(gen, lens, 272, shuffle=shuffle)
        o, lse = paged_attention_fused(q, pool, bt, ln, window_size=window,
                                       return_lse=True)
        po, plse = paged_attention_fused_plain(q, pool, bt, ln,
                                               window_size=window,
                                               return_lse=True)
        torch.cuda.synchronize()
        e_o, e_l = _err(o, po), _err(lse, plse)
        ok = e_o <= TOL and e_l <= TOL and bool(torch.isfinite(o).all())
        log(f"paged decode {label}: max|out-plain| {e_o:.3e} "
            f"max|lse-plain| {e_l:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"paged decode kernel disagrees: {label}")
        worst = max(worst, e_o, e_l)

    lens = [4096] * 8
    q, pool, bt, ln = _decode_inputs(gen, lens, 272)
    # the dense yardstick: the same K/V gathered, GQA expanded, one SDPA
    kd = pool[1:, 0].reshape(8, 256, 8, 16, 128).permute(0, 2, 1, 3, 4)
    vd = pool[1:, 1].reshape(8, 256, 8, 16, 128).permute(0, 2, 1, 3, 4)
    kd = kd.reshape(8, 8, 4096, 128).repeat_interleave(4, dim=1)
    vd = vd.reshape(8, 8, 4096, 128).repeat_interleave(4, dim=1)
    ms = profiling.cuda_time_ms(
        lambda: paged_attention_fused(q, pool, bt, ln), iters=20)
    plain = profiling.cuda_time_ms(
        lambda: paged_attention_fused_plain(q, pool, bt, ln), iters=20)
    lib = profiling.cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kd, vd), iters=20)
    kv_bytes = sum(lens) * 8 * 128 * 2 * 2
    nbytes = kv_bytes + 2 * q.numel() * 2 + 8 * 272 * 4 + 8 * 4
    flops = 4.0 * 8 * 32 * 4096 * 128
    bound, by = profiling.bound_ms(nbytes, flops)
    log(f"paged decode time B8 ctx4096 page16 Hq32/Hkv8 bf16: kernel "
        f"{ms[0]:.4f} ms (min {ms[1]:.4f} max {ms[2]:.4f}), "
        f"{kv_bytes / ms[0] / 1e6:.1f} GB/s of live KV; plain "
        f"{plain[0]:.4f} ms; sdpa on gathered K/V {lib[0]:.4f} ms; bound "
        f"{bound:.4f} ms ({by})")
    paged_attention_fused.launches = 0
    return worst, dict(ms=ms[0], plain_ms=plain[0], library_ms=lib[0],
                       bound_ms=bound, bound_by=by)


PROMPT_LENS = [7, 64, 129, 300, 511, 700, 1000, 1024, 1500, 2048, 3000,
               4000]
NEW_TOKENS = 24


def phase_engine():
    from aule_tpu_torch.models import llama
    from aule_tpu_torch.ops.flash import (flash_attention_fwd,
                                          flash_attention_fwd_plain)
    from aule_tpu_torch.ops.paged_fused import paged_attention_fused
    from aule_tpu_torch.serving.engine import ServingEngine

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = llama.init_params(cfg, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in llama._tensors(params))
    log(f"engine: Llama-3-8B dim {cfg.dim} layers {cfg.n_layers} heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} hidden {cfg.hidden_dim} vocab "
        f"{cfg.vocab_size} bf16: {n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    eng = ServingEngine(params, cfg, max_batch=8, page_size=16,
                        num_pages=2100, max_pages_per_seq=272,
                        max_seq_len=4352, decode_steps=8)
    log(f"engine: pool {tuple(eng.kv_pages.shape)} "
        f"{eng.kv_pages.numel() * 2 / 2**30:.2f} GiB; memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    for p in prompts:
        eng.submit(p, NEW_TOKENS)

    flash_attention_fwd.launches = 0
    paged_attention_fused.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention_fwd.launches,
                "paged_decode": paged_attention_fused.launches}
    st = eng.stats()
    decode_tokens = st["tokens_generated"] - st["prefill_dispatches"]
    log(f"engine: {len(done)} requests in {wall:.2f} s; prefill "
        f"{st['prefill_seconds']:.3f} s over {st['prefill_dispatches']} "
        f"dispatches ({sum(PROMPT_LENS)} prompt tokens, "
        f"{sum(PROMPT_LENS) / st['prefill_seconds']:.0f} tok/s); decode "
        f"{st['decode_seconds']:.3f} s, {st['decode_steps']} steps in "
        f"{st['decode_dispatches']} dispatches, {decode_tokens} tokens, "
        f"{decode_tokens / st['decode_seconds']:.1f} tok/s")
    log(f"engine: launches {launches}")
    if len(done) != len(prompts) or any(
            len(r.output) != NEW_TOKENS for r in done):
        raise AssertionError("not every request finished with "
                             f"{NEW_TOKENS} tokens")
    if launches["flash_fwd"] != st["prefill_dispatches"] * cfg.n_layers:
        raise AssertionError(f"flash launches {launches['flash_fwd']} != "
                             f"prefill dispatches x {cfg.n_layers}")
    if launches["paged_decode"] != st["decode_steps"] * cfg.n_layers:
        raise AssertionError(f"paged-decode launches "
                             f"{launches['paged_decode']} != decode steps "
                             f"x {cfg.n_layers}")
    if st["free_pages"] != 2100 - 1:
        raise AssertionError(f"pages leaked: {st['free_pages']} free")

    # teacher-forced plain forward over prompt + output
    exact = ties = 0
    worst_gap = 0.0
    with torch.no_grad():
        for p, r in zip(prompts, done):
            seq = np.concatenate([p, np.asarray(r.output[:-1], np.int32)])
            tokens = torch.from_numpy(seq.astype(np.int64))[None].cuda()
            logits = llama.forward(params, tokens, cfg,
                                   attention=flash_attention_fwd_plain)[0]
            rows = logits[len(p) - 1:]
            chosen = torch.tensor(r.output, device="cuda")
            best = rows.max(dim=-1)
            got = rows.gather(1, chosen[:, None])[:, 0]
            gap = (best.values - got)
            is_exact = best.indices == chosen
            exact += int(is_exact.sum())
            near = (~is_exact) & (gap <= NEAR_TIE)
            ties += int(near.sum())
            worst_gap = max(worst_gap, float(gap.max()))
            if bool(((~is_exact) & (gap > NEAR_TIE)).any()):
                raise AssertionError(
                    f"request {r.req_id} (prompt {len(p)}): engine token "
                    f"is {float(gap.max()):.4f} below the plain max, over "
                    f"the near-tie allowance {NEAR_TIE}")
            del logits
    total = len(done) * NEW_TOKENS
    log(f"engine: teacher-forced plain forward agrees on {total} tokens: "
        f"{exact} exact argmax, {ties} bf16 near-ties (largest gap "
        f"{worst_gap:.4f} <= {NEAR_TIE})")
    return launches, params, cfg


CATEGORIES = {"flash_fwd": ["flash_fwd_kernel"],
              "paged_decode": ["paged_decode_kernel"],
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
    """Where the engine's time goes on the card: one prefill step and one
    8-step decode dispatch at B8, each under torch.profiler."""
    from aule_tpu_torch.serving.engine import ServingEngine
    from aule_tpu_torch.utils import profiling

    eng = ServingEngine(params, cfg, max_batch=8, page_size=16,
                        num_pages=1200, max_pages_per_seq=272,
                        max_seq_len=4352, decode_steps=8)
    rng = np.random.default_rng(SEED + 1)
    eng.submit(rng.integers(0, cfg.vocab_size, size=2048), 1)
    _log_breakdown("prefill S2048 (one engine step)",
                   profiling.device_breakdown(eng.step, CATEGORIES))
    eng.run()
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, size=1024), 17)
    eng.step()  # admits and prefills all 8, then a first 8-step dispatch
    _log_breakdown("decode B8 ctx~1040, 8 steps (one dispatch)",
                   profiling.device_breakdown(eng.run, CATEGORIES))


def main() -> None:
    kind = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    flash_err, flash_t = check_flash(gen)
    decode_err, decode_t = check_decode(gen)
    launches, params, cfg = phase_engine()
    phase_breakdown(params, cfg)
    del params
    log(card_line())
    f = flash_t[2048]
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="aule_tpu_torch/csrc/flash_fwd.cu",
             replaces="aule_tpu/ops/flash.py:92 (_fwd_kernel); "
                      "aule_tpu/ops/flash.py:638 (_mono_kernel)",
             launches=launches["flash_fwd"], max_abs_err=flash_err,
             ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
             bound_by=f["bound_by"], library_ms=f["library_ms"],
             shape="B1 Hq32/Hkv8 S2048 D128 bf16 causal"),
        dict(name="paged_decode", route="cuda",
             source="aule_tpu_torch/csrc/paged_decode.cu",
             replaces="aule_tpu/ops/paged_fused.py:213 "
                      "(_fused_decode_kernel)",
             launches=launches["paged_decode"], max_abs_err=decode_err,
             ms=decode_t["ms"], plain_ms=decode_t["plain_ms"],
             bound_ms=decode_t["bound_ms"], bound_by=decode_t["bound_by"],
             library_ms=decode_t["library_ms"],
             shape="B8 ctx4096 page16 Hq32/Hkv8 D128 bf16"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
