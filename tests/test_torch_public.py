"""The port's public attention surface against the JAX package's.

The same seeded numpy inputs go through `aule_tpu.flash_attention` (and
its `flash_attention_rope`, `flash_attention_lse`) and the port's.  On the
CPU the port's `cuda` route is not available, so its kernel route is
driven through the op wrappers, which on CPU tensors run the kernels'
plain versions (`ops.flash.flash_attention_fwd`, `flash_attention_cuda`,
`flash_attention_rope`, `flash_attention_lse`), against JAX's Pallas
route in interpret mode; the port's `torch` and `numpy` backends are held
to JAX's `xla`, `numpy` and `pallas` ones.  Tolerances: f32 2e-5, bf16
2e-2, f16 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aule_tpu
import aule_tpu_torch
from aule_tpu_torch.ops import flash as tflash
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()

F32, BF16, F16 = 2e-5, 2e-2, 1e-2
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
TOL = {"f32": F32, "bf16": BF16, "f16": F16}


def _inputs(b, hq, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))


def _j(xs, dt="f32"):
    return [jnp.asarray(x, JDT[dt]) for x in xs]


def _t(xs, dt="f32"):
    return [torch.from_numpy(np.asarray(x)).to(TDT[dt]) for x in xs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tables(n, d, base=10000.0):
    cos, sin = aule_tpu_torch.precompute_rope_frequencies(n, d, base)
    return cos.numpy(), sin.numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("pair", [("torch", "xla"), ("numpy", "numpy"),
                                  ("torch", "pallas")])
def test_backend_pairs(pair, causal):
    """flash_attention on each backend of the port against JAX's."""
    ours, theirs = pair
    qkv = _inputs(1, 4, 2, 64, 80, 64, seed=1 + causal)
    want = aule_tpu.flash_attention(*_j(qkv), causal=causal, backend=theirs)
    got = aule_tpu_torch.flash_attention(*_t(qkv), causal=causal,
                                         backend=ours)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert_close(_np(got), _np(want), 0, F32, f"{ours} vs {theirs}")


def test_backend_pairs_lse_rope_kv_len():
    """Every argument at once through the torch and xla backends."""
    qkv = _inputs(1, 4, 2, 40, 96, 64, seed=5)
    cos, sin = _tables(96, 64)
    kw = dict(causal=True, window_size=30, return_lse=True, kv_len=70)
    jo, jl = aule_tpu.flash_attention(*_j(qkv), rope_cos=cos, rope_sin=sin,
                                      backend="xla", **kw)
    to, tl = aule_tpu_torch.flash_attention(
        *_t(qkv), rope_cos=torch.from_numpy(cos),
        rope_sin=torch.from_numpy(sin), backend="torch", **kw)
    assert_close(_np(to), _np(jo), 0, F32, "out")
    assert_close(_np(tl), _np(jl), 0, 1e-4, "lse")


def _pallas_vs_port(qkv, dt="f32", **kw):
    """JAX's public pallas route (interpret mode) and the port's kernel
    route (the forward's plain version on CPU tensors)."""
    want = aule_tpu.flash_attention(*_j(qkv, dt), backend="pallas", **kw)
    got = tflash.flash_attention_fwd(*_t(qkv, dt), return_lse=False, **kw)
    assert got.dtype == TDT[dt]
    return _np(got), _np(want)


@pytest.mark.parametrize("head_dim", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_fwd_basic(causal, head_dim):
    got, want = _pallas_vs_port(_inputs(1, 2, 2, 128, 128, head_dim,
                                        seed=head_dim), causal=causal)
    assert_close(got, want, 0, F32, f"D={head_dim} causal={causal}")


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 1), (12, 2)])
def test_fwd_gqa(hq, hkv):
    got, want = _pallas_vs_port(_inputs(1, hq, hkv, 96, 96, 64, seed=hq),
                                causal=True)
    assert_close(got, want, 0, F32, f"gqa {hq}:{hkv}")


@pytest.mark.parametrize("sq,sk", [(64, 192), (150, 70)])
def test_fwd_cross(sq, sk):
    got, want = _pallas_vs_port(_inputs(1, 2, 2, sq, sk, 64, seed=sq),
                                causal=True)
    assert_close(got, want, 0, F32, f"cross {sq}x{sk}")


@pytest.mark.parametrize("causal", [True, False])
def test_fwd_sliding_window(causal):
    got, want = _pallas_vs_port(_inputs(1, 2, 2, 256, 256, 64, seed=7),
                                causal=causal, window_size=40)
    assert_close(got, want, 0, F32, f"window causal={causal}")


@pytest.mark.parametrize("dt", ["bf16", "f16"])
def test_fwd_half_types(dt):
    got, want = _pallas_vs_port(_inputs(1, 4, 2, 128, 128, 128, seed=11),
                                dt=dt, causal=True)
    assert_close(got, want, 0, TOL[dt], dt)


def test_fwd_lse():
    qkv = _inputs(1, 2, 2, 128, 128, 64, seed=13)
    jo, jl = aule_tpu.flash_attention(*_j(qkv), causal=True,
                                      return_lse=True, backend="pallas")
    to, tl = tflash.flash_attention_fwd(*_t(qkv), causal=True,
                                        return_lse=True)
    assert_close(_np(to), _np(jo), 0, F32, "out")
    assert_close(_np(tl), _np(jl), 0, 1e-4, "lse")


@pytest.mark.parametrize("sq,sk,table", [(128, 128, 128), (48, 160, 160),
                                         (160, 48, 100)])
def test_fused_rope(sq, sk, table):
    """flash_attention_rope: q at 0..Sq-1, k at 0..Sk-1, Sq != Sk, and a
    table shorter than the sequence (the identity past its end)."""
    qkv = _inputs(1, 4, 2, sq, sk, 64, seed=sq + sk)
    cos, sin = _tables(table, 64)
    want = aule_tpu.flash_attention_rope(*_j(qkv), cos, sin, causal=True)
    got = aule_tpu_torch.flash_attention_rope(
        *_t(qkv), torch.from_numpy(cos), torch.from_numpy(sin), causal=True)
    assert_close(_np(got), _np(want), 0, 5e-5, "fused rope")


def test_fused_rope_bf16_window_gqa():
    qkv = _inputs(1, 8, 2, 192, 192, 128, seed=17)
    cos, sin = _tables(192, 128)
    want = aule_tpu.flash_attention_rope(*_j(qkv, "bf16"), cos, sin,
                                         causal=True, window_size=50)
    got = aule_tpu_torch.flash_attention_rope(
        *_t(qkv, "bf16"), torch.from_numpy(cos), torch.from_numpy(sin),
        causal=True, window_size=50)
    assert got.dtype == torch.bfloat16
    assert_close(_np(got), _np(want), 0, BF16, "bf16 rope")


@pytest.mark.parametrize("kv_len", [37, 130, 256, 384])
def test_kv_len(kv_len):
    """One query against K/V padded to 384: only the first kv_len keys
    attend; kv_len a tensor the port never reads on the host."""
    qkv = _inputs(2, 4, 4, 1, 384, 128, seed=kv_len)
    want = aule_tpu.flash_attention(*_j(qkv), backend="pallas",
                                    kv_len=jnp.int32(kv_len))
    got = tflash.flash_attention_fwd(
        *_t(qkv), kv_len=torch.tensor(kv_len, dtype=torch.int32),
        return_lse=False)
    assert_close(_np(got), _np(want), 0, F32, f"kv_len={kv_len}")
    sliced = aule_tpu_torch.flash_attention(
        *_t((qkv[0], qkv[1][:, :, :kv_len], qkv[2][:, :, :kv_len])),
        backend="numpy")
    assert_close(_np(got), _np(sliced), 0, F32, "against the slice")


def test_kv_len_with_rope_and_lse_through_the_public_entry():
    qkv = _inputs(1, 4, 2, 16, 256, 64, seed=19)
    cos, sin = _tables(256, 64)
    kw = dict(causal=True, return_lse=True, kv_len=200)
    jo, jl = aule_tpu.flash_attention(*_j(qkv), rope_cos=cos, rope_sin=sin,
                                      backend="pallas", **kw)
    to, tl = aule_tpu_torch.flash_attention(
        *_t(qkv), rope_cos=torch.from_numpy(cos),
        rope_sin=torch.from_numpy(sin), backend="numpy", **kw)
    assert_close(_np(to), _np(jo), 0, F32, "out")
    assert_close(_np(tl), _np(jl), 0, 1e-4, "lse")


def test_kv_len_zero_gives_zero_rows():
    qkv = _inputs(1, 2, 2, 3, 64, 64, seed=23)
    out, lse = tflash.flash_attention_fwd(*_t(qkv), kv_len=0)
    assert (out == 0).all()
    assert np.allclose(lse.numpy(), -0.7 * np.finfo(np.float32).max)


def test_flash_attention_lse_public():
    qkv = _inputs(1, 4, 2, 96, 96, 64, seed=29)
    jo, jl = aule_tpu.flash_attention_lse(*_j(qkv), causal=True)
    to, tl = aule_tpu_torch.flash_attention_lse(*_t(qkv), causal=True)
    assert_close(_np(to), _np(jo), 0, F32, "out")
    assert_close(_np(tl), _np(jl), 0, 1e-4, "lse")


def _weights(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_grads_through_lse():
    """d/d(q, k, v) of sum(w o) + sum(u lse): the port's autograd Function
    (the plain backward on CPU) against jax.grad of JAX's pallas route."""
    qkv = _inputs(1, 4, 2, 64, 64, 64, seed=31)
    w, u = _weights((1, 4, 64, 64), 1), _weights((1, 4, 64), 2)

    def jloss(q, k, v):
        o, lse = aule_tpu.flash_attention(q, k, v, causal=True,
                                          return_lse=True, backend="pallas")
        return jnp.sum(o * w) + jnp.sum(lse * u)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_j(qkv))
    ts = [x.requires_grad_(True) for x in _t(qkv)]
    o, lse = aule_tpu_torch.flash_attention_lse(*ts, causal=True)
    ((o * torch.from_numpy(w)).sum()
     + (lse * torch.from_numpy(u)).sum()).backward()
    for name, t, j in zip("qkv", ts, want):
        assert_close(_np(t.grad), _np(j), 0, 1e-4, f"d{name}")


def test_grads_through_rope():
    """RoPE outside the op when a gradient is needed, as JAX's
    flash_attention_pallas; the port's cuda route on CPU tensors."""
    qkv = _inputs(1, 4, 2, 64, 64, 64, seed=37)
    cos, sin = _tables(64, 64)
    w = _weights((1, 4, 64, 64), 3)

    def jloss(q, k, v):
        o = aule_tpu.flash_attention(q, k, v, causal=True, rope_cos=cos,
                                     rope_sin=sin, backend="pallas")
        return jnp.sum(o * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_j(qkv))
    ts = [x.requires_grad_(True) for x in _t(qkv)]
    o = tflash.flash_attention_cuda(*ts, causal=True,
                                    rope_cos=torch.from_numpy(cos),
                                    rope_sin=torch.from_numpy(sin))
    (o * torch.from_numpy(w)).sum().backward()
    for name, t, j in zip("qkv", ts, want):
        assert_close(_np(t.grad), _np(j), 0, 1e-4, f"d{name}")


def test_all_names_match_jax():
    assert aule_tpu_torch.__all__ == aule_tpu.__all__
    for name in aule_tpu_torch.__all__:
        assert hasattr(aule_tpu_torch, name), name
