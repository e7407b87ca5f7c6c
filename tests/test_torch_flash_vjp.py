"""Flash attention gradients of the PyTorch port against the JAX package.

The same seeded numpy inputs go through aule_tpu's `flash_attention_vjp` /
`flash_attention_lse` (Pallas backward kernels in interpret mode on the
CPU) and the port's, which on CPU tensors differentiate through the plain
versions of the forward and of the backward (`flash_attention_bwd_plain`,
the CUDA kernels' stand-in).  The loss is the JAX suite's arange-weighted
sum.  f32 is held to the JAX suite's BWD_TOL 1e-4, the S1024 window case to
its 1e-3 / 5e-3 (the weights reach ~1000 there), bf16 and f16 to 2e-2
of each gradient's largest entry (rounding falls at different places: the
JAX kernels round p and ds to the input type, the plain version does not;
at bf16 both stay within 0.6 % of the largest entry of an f32 reference's
gradient, while single small entries differ by more than 2e-2 of
themselves).  The plain backward is also held to torch.autograd through
`ops.reference.attention_reference`.  Delta's plain version is held to the
JAX package's delta expression (flash_vjp.py:746-750) within 1e-6 of the
sum of each row's term sizes (f32 sums of the same exact products in
another order), and every C entry point the kernels' library exports to
its ctypes signature.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.ops import flash_vjp as jfv
from aule_tpu.ops.rope import precompute_rope_frequencies as jrope
from aule_tpu_torch.ops import _build
from aule_tpu_torch.ops import flash_vjp as tfv
from aule_tpu_torch.ops.reference import attention_reference
from aule_tpu_torch.ops.rope import precompute_rope_frequencies as trope
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()

BWD_TOL = (1e-4, 1e-4)
LOW_TOL = (2e-2, 2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _inputs(b, hq, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _weights(shape, scale=1e-3):
    return (np.arange(int(np.prod(shape)), dtype=np.float32)
            .reshape(shape) * scale)


def _jax_grads(fn, qkv, dtype, with_lse=False):
    jdt = DTYPES[dtype][0]

    def loss(q, k, v):
        res = fn(q, k, v)
        out = res[0] if with_lse else res
        total = jnp.sum(out.astype(jnp.float32) * _weights(out.shape))
        if with_lse:
            total = total + jnp.sum(res[1] * _weights(res[1].shape, 1e-2))
        return total

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jdt) for x in qkv))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch_grads(fn, qkv, dtype, with_lse=False):
    tdt = DTYPES[dtype][1]
    ts = [torch.from_numpy(x).to(tdt).requires_grad_(True) for x in qkv]
    res = fn(*ts)
    out = res[0] if with_lse else res
    assert out.dtype == tdt
    total = (out.float() * torch.from_numpy(_weights(out.shape))).sum()
    if with_lse:
        total = total + (res[1] * torch.from_numpy(
            _weights(res[1].shape, 1e-2))).sum()
    total.backward()
    for t in ts:
        assert t.grad.dtype == tdt
    return [t.grad.float().numpy() for t in ts]


def _check(jfn, tfn, qkv, dtype="float32", tol=BWD_TOL, with_lse=False):
    want = _jax_grads(jfn, qkv, dtype, with_lse)
    got = _torch_grads(tfn, qkv, dtype, with_lse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        rtol, atol = tol
        if dtype != "float32":  # atol relative to the gradient's scale
            atol *= float(np.abs(w).max())
        assert_close(g, w, rtol, atol, name)


@pytest.mark.parametrize("causal", [False, True])
def test_f32(causal):
    qkv = _inputs(1, 2, 2, 128, 128, 64, seed=1 + causal)
    _check(lambda q, k, v: jfv.flash_attention_vjp(q, k, v, causal=causal),
           lambda q, k, v: tfv.flash_attention_vjp(q, k, v, causal=causal),
           qkv)


def test_gqa():
    qkv = _inputs(1, 8, 2, 128, 128, 64, seed=3)
    _check(lambda q, k, v: jfv.flash_attention_vjp(q, k, v, causal=True),
           lambda q, k, v: tfv.flash_attention_vjp(q, k, v, causal=True),
           qkv)


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_s(causal):
    qkv = _inputs(2, 4, 2, 100, 100, 64, seed=4)
    _check(lambda q, k, v: jfv.flash_attention_vjp(q, k, v, causal=causal),
           lambda q, k, v: tfv.flash_attention_vjp(q, k, v, causal=causal),
           qkv)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(48, 130), (130, 48)])
def test_cross_lengths(causal, sq, sk):
    """Sq != Sk; the causal mask is top-left aligned (q >= k)."""
    qkv = _inputs(1, 4, 2, sq, sk, 64, seed=sq)
    _check(lambda q, k, v: jfv.flash_attention_vjp(q, k, v, causal=causal),
           lambda q, k, v: tfv.flash_attention_vjp(q, k, v, causal=causal),
           qkv)


def test_window():
    qkv = _inputs(1, 2, 2, 384, 384, 64, seed=5)
    _check(lambda q, k, v: jfv.flash_attention_vjp(q, k, v, causal=True,
                                                   window_size=64),
           lambda q, k, v: tfv.flash_attention_vjp(q, k, v, causal=True,
                                                   window_size=64),
           qkv)


def test_window_banded_gqa_s1024():
    """The banded window backward's shape (the JAX default path at causal
    W256, D128, GQA; the be44a6c dK/dV regression shape)."""
    qkv = _inputs(1, 8, 2, 1024, 1024, 128, seed=6)
    _check(lambda q, k, v: jfv.flash_attention_vjp(q, k, v, causal=True,
                                                   window_size=256),
           lambda q, k, v: tfv.flash_attention_vjp(q, k, v, causal=True,
                                                   window_size=256),
           qkv, tol=(1e-3, 5e-3))


def test_rope_grads_flow():
    qkv = _inputs(1, 2, 2, 128, 128, 64, seed=7)
    jc, js = jrope(128, 64)
    tc, ts = trope(128, 64)
    _check(lambda q, k, v: jfv.flash_attention_vjp(
               q, k, v, causal=True, rope_cos=jc, rope_sin=js),
           lambda q, k, v: tfv.flash_attention_vjp(
               q, k, v, causal=True, rope_cos=tc, rope_sin=ts),
           qkv)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_cotangent(causal):
    """A loss over out and lse: the lse cotangent folds into delta."""
    qkv = _inputs(1, 4, 2, 96, 96, 64, seed=8 + causal)
    _check(lambda q, k, v: jfv.flash_attention_lse(q, k, v, causal=causal),
           lambda q, k, v: tfv.flash_attention_lse(q, k, v, causal=causal),
           qkv, with_lse=True)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_low_precision(dtype):
    qkv = _inputs(1, 4, 2, 128, 128, 128, seed=9)
    _check(lambda q, k, v: jfv.flash_attention_vjp(q, k, v, causal=True),
           lambda q, k, v: tfv.flash_attention_vjp(q, k, v, causal=True),
           qkv, dtype=dtype, tol=LOW_TOL)


@pytest.mark.parametrize("case", [
    dict(causal=True), dict(causal=False), dict(causal=True, window=5),
    dict(causal=False, window=4, sq=30, sk=20)],
    ids=["causal", "full", "causal-window", "rows-that-see-nothing"])
def test_plain_bwd_matches_autograd(case):
    """flash_attention_bwd_plain (with a non-zero dlse) against
    torch.autograd through the dense reference, in f64 where the reference
    runs and f32 where the plain version does."""
    sq, sk = case.get("sq", 40), case.get("sk", 40)
    window = case.get("window", -1)
    causal = case["causal"]
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, dtype=torch.float64)
               for s in ((2, 4, sq, 16), (2, 2, sk, 16), (2, 2, sk, 16)))
    do = torch.randn(2, 4, sq, 16, generator=g, dtype=torch.float64)
    dlse = torch.randn(2, 4, sq, generator=g, dtype=torch.float64)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out, lse = attention_reference(*leaves, causal=causal,
                                   window_size=window, return_lse=True)
    live = lse > -1e30  # a row that sees nothing has a constant lse
    ((out * do).sum() + (torch.where(live, lse, 0) * dlse).sum()).backward()
    o, l32 = attention_reference(q.float(), k.float(), v.float(),
                                 causal=causal, window_size=window,
                                 return_lse=True)
    got = tfv.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), o, l32, do.float(), causal=causal,
        window=window, dlse=torch.where(live, dlse, 0).float())
    for name, a, want in zip(("dq", "dk", "dv"), got, leaves):
        assert a.dtype == torch.float32
        assert_close(a, want.grad, 1e-5, 1e-5, name)


def test_kernel_parts_route_to_plain_on_cpu():
    """flash_bwd_dq / flash_bwd_dkv on CPU tensors are the plain parts of
    flash_attention_bwd, and count no launch."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 50, 70, 32))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
    o, lse = attention_reference(q, k, v, causal=True, return_lse=True)
    di = tfv.attention_delta(o, do)
    before = (tfv.flash_bwd_dq.launches, tfv.flash_bwd_dkv.launches)
    dq = tfv.flash_bwd_dq(q, k, v, do, lse, di, causal=True)
    dk, dv = tfv.flash_bwd_dkv(q, k, v, do, lse, di, causal=True)
    whole = tfv.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    for a, b in zip((dq, dk, dv), whole):
        assert torch.equal(a, b)
    assert (tfv.flash_bwd_dq.launches, tfv.flash_bwd_dkv.launches) == before
    assert dk.shape == k.shape and dv.shape == v.shape


def test_grad_off_skips_the_autograd_function():
    """With no input that requires grad, or under no_grad, the op is the
    forward alone (no graph); with grad it records the Function."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 1, 16, 16, 32))
    out = tfv.flash_attention_vjp(q, k, v, causal=True)
    assert out.grad_fn is None
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert tfv.flash_attention_vjp(qg, k, v, causal=True).grad_fn is None
    out = tfv.flash_attention_vjp(qg, k, v, causal=True)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), tfv.flash_attention_vjp(q, k, v,
                                                             causal=True))


def test_unsupported_device_raises():
    q = torch.zeros(1, 2, 8, 128, device="meta")
    lse = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError):
        tfv.flash_bwd_dq(q, q, q, q, lse, lse)
    with pytest.raises(ValueError):
        tfv.flash_bwd_dkv(q, q, q, q, lse, lse)


@pytest.mark.parametrize("with_dlse", [False, True], ids=["no-dlse", "dlse"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_delta_plain_matches_jax(dtype, with_dlse):
    """attention_delta_plain against JAX's delta: sum(o * do) - dlse in f32
    (the products of two bf16 values are exact in f32)."""
    rng = np.random.default_rng(12)
    o = rng.standard_normal((2, 4, 37, 128)).astype(np.float32)
    do = rng.standard_normal((2, 4, 37, 128)).astype(np.float32)
    dlse = (rng.standard_normal((2, 4, 37)).astype(np.float32)
            if with_dlse else None)
    jdt, tdt = DTYPES[dtype]
    want = jnp.sum(jnp.asarray(o, jdt).astype(jnp.float32)
                   * jnp.asarray(do, jdt).astype(jnp.float32), axis=-1)
    if with_dlse:
        want = want - jnp.asarray(dlse).astype(jnp.float32)
    got = tfv.attention_delta_plain(
        torch.from_numpy(o).to(tdt), torch.from_numpy(do).to(tdt),
        None if dlse is None else torch.from_numpy(dlse))
    assert got.dtype == torch.float32 and got.shape == (2, 4, 37)
    # the two sums add the same exact products in another order: each is
    # within a few f32 steps of the sum of its terms' sizes
    size = (np.abs(np.asarray(jnp.asarray(o, jdt).astype(jnp.float32))
                   * np.asarray(jnp.asarray(do, jdt).astype(jnp.float32)))
            .sum(-1))
    if with_dlse:
        size = size + np.abs(dlse)
    err = np.abs(got.numpy() - np.asarray(want))
    assert (err <= 1e-6 * size).all(), float((err / size).max())


def test_delta_routes_to_plain_on_cpu():
    """attention_delta on CPU tensors is its plain version, with or without
    dlse, and counts no launch."""
    g = torch.Generator().manual_seed(3)
    o, do = (torch.randn(1, 2, 9, 128, generator=g).to(torch.bfloat16)
             for _ in range(2))
    dlse = torch.randn(1, 2, 9, generator=g)
    before = tfv.attention_delta.launches
    for cot in (None, dlse):
        assert torch.equal(tfv.attention_delta(o, do, cot),
                           tfv.attention_delta_plain(o, do, cot))
    assert tfv.attention_delta.launches == before


def test_delta_unsupported_device_raises():
    o = torch.zeros(1, 2, 8, 128, device="meta")
    with pytest.raises(ValueError):
        tfv.attention_delta(o, o)


_CTYPE_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
               ctypes.c_float: "float"}


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_c_prototype(name):
    """Each ctypes signature in ops/_build.py has the pointer, int and float
    arguments of its C entry point in csrc/, in order (a pointer passed as
    an int would be cut to 32 bits)."""
    src = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    found = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert found, f"no C prototype for {name}"
    params = [" ".join(p.split()) for p in found.group(1).split(",")]
    kinds = ["pointer" if "*" in p else p.split()[0] for p in params]
    assert kinds == [_CTYPE_KIND[t] for t in _build.SIGNATURES[name]]
