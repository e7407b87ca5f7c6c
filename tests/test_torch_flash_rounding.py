"""Where the tensor-core flash kernels round, held to JAX's f32 oracle.

csrc/flash_fwd.cu and csrc/flash_bwd.cu keep every sum in f32 and round
three operands to the input type (bf16 or f16) in registers before a
product: P before O += P V (the row sum l adds the unrounded p), P^T before
dV += P^T dO, and dS = P (dP - delta) scale before dQ += dS K and
dK += dS^T Q.  `_tensor_core_model` below is a plain PyTorch model of
exactly that arithmetic, dense and in f32 otherwise, at the head dims 64
and 256 (B1 H2 S256, causal and not, inputs from a numpy seed).  It is held
with chip_smoke.py's limits (every row within ROW_TOL, bf16 2^-6, f16 2^-8,
of its largest |value|; a gradient row against at least BWD_FLOOR = 2^-12
of the tensor's largest |value|) to:
  * JAX's `attention_reference` in f32 on the same 16-bit values (the
    output), and the gradients of its (out, lse) through `jax.vjp`;
  * the port's plain backward on the same residuals, which is what the
    card's checks hold the kernels to.
A 16-bit backward takes delta = rowsum(o do) from its 16-bit output o,
not the exact one, and where a dQ row cancels (a causal row that sees few
keys) that alone moves it by more than ROW_TOL from jax.vjp's: in bf16
the port's plain backward and JAX's own read 3e-2 to 2e-1 there
(scripts/torch_flash_rounding_cpu.py prints each).  So the oracle's
cotangent carries it: an lse cotangent of delta_exact - delta_16bit makes
jax.vjp's delta the model's (d lse / d s = p), and what is left is the
kernels' own rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.ops.reference import attention_reference
from aule_tpu_torch.utils.testing import cap_cpu_threads

cap_cpu_threads()

ROW_TOL = {torch.bfloat16: 2.0 ** -6, torch.float16: 2.0 ** -8}
BWD_FLOOR = 2.0 ** -12
B, H, S = 1, 2, 256


def _tensor_core_model(q, k, v, do, causal):
    """(out, delta, dq, dk, dv) as the tensor-core kernels round them:
    products of 16-bit operands with f32 sums, P, P^T and dS rounded to q's
    type before their products, outputs rounded to it; delta f32 from the
    16-bit output."""
    dt = q.dtype
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    s = qf @ kf.transpose(-1, -2) * scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)                      # f32, unnormalised
    l = p.sum(-1, keepdim=True)               # sums the unrounded p
    out = ((p.to(dt).float() @ vf) / l).to(dt)  # P rounded before P V
    # the backward recomputes p from the lse and delta from the output
    p = torch.exp(s - (m + torch.log(l)))
    di = (out.float() * dof).sum(-1, keepdim=True)
    dp = dof @ vf.transpose(-1, -2)
    ds = (p * (dp - di) * scale).to(dt).float()  # dS rounded
    dq = (ds @ kf).to(dt)
    dk = (ds.transpose(-1, -2) @ qf).to(dt)
    dv = (p.to(dt).float().transpose(-1, -2) @ dof).to(dt)  # P^T rounded
    return out, di[..., 0], dq, dk, dv


def _row_rel(got, want, floor):
    """The largest row error relative to its row's largest |want| (at least
    `floor` times the tensor's)."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    diff = np.abs(got - want).max(-1)
    size = np.maximum(np.abs(want).max(-1), floor * np.abs(want).max())
    return float(np.where(diff == 0, 0.0, diff / np.maximum(size, 1e-30))
                 .max())


def _inputs(dtype, d, causal):
    rng = np.random.default_rng(d + 2 * causal + (dtype == torch.float16))
    return [torch.from_numpy(rng.standard_normal((B, H, S, d))
                             .astype(np.float32)).to(dtype)
            for _ in range(4)]


def _hold(names, got, want, dtype):
    tol = ROW_TOL[dtype]
    for name, g, w in zip(names, got, want):
        floor = 0.0 if name == "out" else BWD_FLOOR
        rel = _row_rel(g.float().numpy(), np.asarray(w, np.float32), floor)
        assert rel <= tol, f"{name}: row-relative {rel:.3e} > {tol:.3e}"


CASES = pytest.mark.parametrize(
    "dtype,d,causal",
    [(dt, d, c) for dt in (torch.bfloat16, torch.float16) for d in (64, 256)
     for c in (True, False)],
    ids=lambda x: {torch.bfloat16: "bf16", torch.float16: "f16",
                   True: "causal", False: "full"}.get(x, str(x)))


@CASES
def test_rounding_within_chip_limits_of_jax(dtype, d, causal):
    q, k, v, do = _inputs(dtype, d, causal)
    out, di, dq, dk, dv = _tensor_core_model(q, k, v, do, causal)
    q32, k32, v32, do32 = (jnp.asarray(x.float().numpy())
                           for x in (q, k, v, do))
    (o32, _), vjp = jax.vjp(
        lambda a, b, c: attention_reference(a, b, c, causal=causal,
                                            return_lse=True), q32, k32, v32)
    # the lse cotangent that turns jax.vjp's delta into the model's
    dlse = jnp.sum(o32 * do32, axis=-1) - jnp.asarray(di.numpy())
    _hold(("out", "dq", "dk", "dv"), (out, dq, dk, dv),
          (o32, *vjp((do32, dlse))), dtype)


@CASES
def test_backward_rounding_within_chip_limits_of_plain(dtype, d, causal):
    """The card's rule: the kernels' rounding against the plain backward
    (f32 arithmetic) on the same residuals."""
    from aule_tpu_torch.ops import flash_vjp as fv
    from aule_tpu_torch.ops.flash import flash_attention_fwd_plain

    q, k, v, do = _inputs(dtype, d, causal)
    o, lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    di = fv.attention_delta_plain(o, do)
    p, ds, kf = fv._plain_p_ds(q, k, v, do, lse, di, causal, d ** -0.5, -1)
    ds = ds.to(dtype).float()
    got = ((ds @ kf).to(dtype),
           (ds.transpose(-1, -2) @ q.float()).to(dtype),
           (p.to(dtype).float().transpose(-1, -2) @ do.float()).to(dtype))
    _hold(("dq", "dk", "dv"), got,
          [x.float().numpy() for x in
           fv.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)],
          dtype)
