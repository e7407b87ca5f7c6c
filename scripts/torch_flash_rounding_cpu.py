"""The tensor-core flash kernels' rounding at D 64 and 256 against JAX's
f32 oracle, on the CPU (no device number).

For bf16 and f16 at D 64 and 256, B1 H2 S256, causal and not (the inputs
of tests/test_torch_flash_rounding.py), prints each output's largest
row-relative error (chip_smoke.py's rule: a row against its largest
|value|, a gradient row against at least BWD_FLOOR of the tensor's) for
  * the model of the tensor-core kernels' rounding
    (`_tensor_core_model` of the test),
  * the port's plain forward and backward (f32 arithmetic, outputs
    rounded),
  * JAX's own 16-bit flash_attention_vjp (Pallas kernels in interpret
    mode),
against `attention_reference` under jax.vjp in f32 ("oracle"), and the
model against the same with an lse cotangent that makes jax.vjp's delta
the model's ("oracle, 16-bit delta"), which is what the test holds.

    JAX_PLATFORMS=cpu python3 scripts/torch_flash_rounding_cpu.py
"""

import os
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
os.environ.setdefault("AULE_TPU_INTERPRET", "1")
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_flash_rounding as t
from aule_tpu.ops.flash_vjp import flash_attention_vjp
from aule_tpu.ops.reference import attention_reference
from aule_tpu_torch.ops import flash_vjp as fv
from aule_tpu_torch.ops.flash import flash_attention_fwd_plain

NAMES = ("out", "dq", "dk", "dv")


def rel(got, want, name):
    floor = 0.0 if name == "out" else t.BWD_FLOOR
    return t._row_rel(np.asarray(got, np.float32), np.asarray(want, np.float32),
                      floor)


for dtype in (torch.bfloat16, torch.float16):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    for d in (64, 256):
        for causal in (True, False):
            q, k, v, do = t._inputs(dtype, d, causal)
            out, di, dq, dk, dv = t._tensor_core_model(q, k, v, do, causal)
            model = [x.float().numpy() for x in (out, dq, dk, dv)]
            o, lse = flash_attention_fwd_plain(q, k, v, causal=causal)
            plain = [o, *fv.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      causal=causal)]
            plain = [x.float().numpy() for x in plain]
            f32 = [jnp.asarray(x.float().numpy()) for x in (q, k, v, do)]
            (o32, _), vjp = jax.vjp(
                lambda a, b, c: attention_reference(
                    a, b, c, causal=causal, return_lse=True), *f32[:3])
            zero = jnp.zeros(o32.shape[:-1], jnp.float32)
            oracle = [o32, *vjp((f32[3], zero))]
            dlse = jnp.sum(o32 * f32[3], axis=-1) - jnp.asarray(di.numpy())
            oracle16 = [o32, *vjp((f32[3], dlse))]
            jo, jvjp = jax.vjp(lambda a, b, c: flash_attention_vjp(
                a, b, c, causal), *(x.astype(jdt) for x in f32[:3]))
            jax16 = [jo, *jvjp(f32[3].astype(jdt))]
            jax16 = [np.asarray(x.astype(jnp.float32)) for x in jax16]
            tol = t.ROW_TOL[dtype]
            print(f"{str(dtype).replace('torch.', '')} D{d} "
                  f"{'causal' if causal else 'full'} (ROW_TOL {tol:.3e})")
            for i, name in enumerate(NAMES):
                print(f"  {name}: oracle: model {rel(model[i], oracle[i], name):.2e}"
                      f", plain {rel(plain[i], oracle[i], name):.2e}, JAX "
                      f"{rel(jax16[i], oracle[i], name):.2e}; oracle, 16-bit "
                      f"delta: model {rel(model[i], oracle16[i], name):.2e}",
                      flush=True)
