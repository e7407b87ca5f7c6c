#!/bin/bash
# The f16 dQ check of chip_smoke.py's backward ("f16 S1000 causal") on the
# CPU: inputs of that class (B1 S1000 causal D128 f16, GQA group 4 with
# the heads reduced to Hq8/Hkv2; five seeds) through
#   * JAX's f16 backward (aule_tpu's flash_attention_vjp, Pallas kernels in
#     interpret mode, which computes an f16 backward in f32 throughout and
#     rounds only dq, dk, dv: aule_tpu/ops/flash_vjp.py:693-699),
#   * the port's plain backward on the same f16 tensors (f32 arithmetic,
#     dq rounded to f16 once),
#   * the port's plain dQ with ds rounded to f16 before dS K, as
#     csrc/flash_bwd.cu's dQ kernel does (its bf16 / f16 design, taken from
#     JAX's bf16 _dq_kernel, flash_vjp.py:212),
# each held to the f32 oracle (JAX's dense attention_reference under
# jax.vjp, in f32) by chip_smoke.py's rule: every dQ row within ROW_TOL f16
# = 2^-8 of max(row's largest |value|, BWD_FLOOR = 2^-12 of the tensor's);
# last, the kernel's rounding against the plain version, the quantity
# chip_smoke.py's check reads on the card.
#
#   JAX_PLATFORMS=cpu scripts/torch_f16_dq_cpu.sh     # from the repo root
set -o pipefail
exec python3 - "$@" <<'PY'
import os
import sys
import time

sys.path.insert(0, os.getcwd())
os.environ.setdefault("AULE_TPU_INTERPRET", "1")
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import torch

from aule_tpu.ops.flash_vjp import flash_attention_vjp
from aule_tpu.ops.reference import attention_reference
from aule_tpu_torch.ops import flash_vjp as fv
from aule_tpu_torch.ops.flash import flash_attention_fwd_plain

ROW_TOL, FLOOR = 2.0 ** -8, 2.0 ** -12
B, HQ, HKV, S, D = 1, 8, 2, 1000, 128


def row_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want).max(-1)
    size = np.maximum(np.abs(want).max(-1), FLOOR * np.abs(want).max())
    rel = np.where(diff == 0, 0.0, diff / np.maximum(size, 1e-30))
    return float(diff.max()), float(rel.max()), int((rel > ROW_TOL).sum())


for seed in range(5):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float16) for s in (
        (B, HQ, S, D), (B, HKV, S, D), (B, HKV, S, D), (B, HQ, S, D)))
    t0 = time.time()
    # the f32 oracle: dense attention, f32 arithmetic, jax.vjp
    _, vjp = jax.vjp(lambda a, b, c: attention_reference(
        a, b, c, causal=True), *(jnp.asarray(x, jnp.float32)
                                 for x in (q, k, v)))
    dq32 = np.asarray(vjp(jnp.asarray(do, jnp.float32))[0])
    # JAX's f16 backward (its Pallas kernels in interpret mode)
    _, vjp = jax.vjp(lambda a, b, c: flash_attention_vjp(a, b, c, True),
                     *(jnp.asarray(x) for x in (q, k, v)))
    dq_jax = np.asarray(vjp(jnp.asarray(do))[0].astype(jnp.float32))
    # the port's plain backward on the same f16 tensors
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_fwd_plain(tq, tk, tv, causal=True)
    di = fv.attention_delta_plain(o, tdo)
    dq_plain = fv.flash_bwd_dq_plain(tq, tk, tv, tdo, lse, di, causal=True)
    # ... and with ds rounded to f16 before dS K, as the card's kernel
    _, ds, kf = fv._plain_p_ds(tq, tk, tv, tdo, lse, di, True, D ** -0.5, -1)
    dq_round = torch.matmul(ds.half().float(), kf.half().float()).half()
    print(f"seed {seed} B{B} Hq{HQ}/Hkv{HKV} S{S} D{D} f16 causal "
          f"({time.time() - t0:.0f} s); max|dq32| {np.abs(dq32).max():.4f}")
    for name, got in (("JAX f16 backward", dq_jax),
                      ("port plain (f32 arithmetic)", dq_plain.float()),
                      ("port plain, ds rounded to f16 (the kernel's)",
                       dq_round.float())):
        err, rel, bad = row_rel(got, dq32)
        print(f"  {name}: max|dq - f32| {err:.3e}, row-relative {rel:.3e} "
              f"(ROW_TOL {ROW_TOL:.3e}; {bad} rows above it)")
    err, rel, bad = row_rel(dq_round.float(), dq_plain.float())
    print(f"  the kernel's rounding against the plain version: max|diff| "
          f"{err:.3e}, row-relative {rel:.3e} ({bad} rows above ROW_TOL)")
PY
