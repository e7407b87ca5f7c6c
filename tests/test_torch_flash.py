"""Flash forward of the PyTorch port against the JAX package.

The same seeded numpy inputs go through aule_tpu's Pallas
`flash_attention_fwd` (interpret mode on the CPU) and the port's
`flash_attention_fwd`, which on CPU tensors runs its plain version
(`flash_attention_fwd_plain`, the CUDA kernel's stand-in).  f32 is held to
2e-5 (the algorithm), bf16 to 2e-2 (rounding falls at different places).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.ops.flash import flash_attention_fwd as jax_flash
from aule_tpu.ops.reference import attention_reference as jax_reference
from aule_tpu_torch.ops import flash as tflash
from aule_tpu_torch.ops import flash_vjp as tflash_vjp
from aule_tpu_torch.utils.testing import assert_close

F32_ATOL = 2e-5
BF16_ATOL = 2e-2


def _inputs(b, hq, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    return q, k, v


def _both(q, k, v, dtype, **kw):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jo, jl = jax_flash(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                       return_lse=True, **kw)
    to, tl = tflash.flash_attention_fwd(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        return_lse=True, **kw)
    assert to.dtype == tdt and tl.dtype == torch.float32
    return (np.asarray(jo.astype(jnp.float32)), np.asarray(jl),
            to.float().numpy(), tl.numpy())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads", [(4, 2), (8, 2)])
def test_f32_gqa(causal, heads):
    hq, hkv = heads
    q, k, v = _inputs(1, hq, hkv, 128, 128, 64, seed=hq + causal)
    jo, jl, to, tl = _both(q, k, v, "float32", causal=causal)
    assert_close(to, jo, 0, F32_ATOL, "out")
    assert_close(tl, jl, 0, F32_ATOL, "lse")


@pytest.mark.parametrize("causal", [False, True])
def test_f32_ragged_sq(causal):
    """Sq not a multiple of any block; batch 2."""
    q, k, v = _inputs(2, 4, 2, 100, 100, 64, seed=3)
    jo, jl, to, tl = _both(q, k, v, "float32", causal=causal)
    assert_close(to, jo, 0, F32_ATOL, "out")
    assert_close(tl, jl, 0, F32_ATOL, "lse")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(48, 130), (130, 48)])
def test_f32_cross_lengths(causal, sq, sk):
    """Sq != Sk; the causal mask is top-left aligned (q >= k)."""
    q, k, v = _inputs(1, 4, 2, sq, sk, 64, seed=sq)
    jo, jl, to, tl = _both(q, k, v, "float32", causal=causal)
    assert_close(to, jo, 0, F32_ATOL, "out")
    assert_close(tl, jl, 0, F32_ATOL, "lse")


@pytest.mark.parametrize("causal", [False, True])
def test_f32_window(causal):
    q, k, v = _inputs(1, 4, 2, 160, 160, 64, seed=7)
    jo, jl, to, tl = _both(q, k, v, "float32", causal=causal,
                           window_size=24)
    assert_close(to, jo, 0, F32_ATOL, "out")
    assert_close(tl, jl, 0, F32_ATOL, "lse")


def test_f32_scale_and_no_lse():
    q, k, v = _inputs(1, 4, 4, 64, 64, 64, seed=9)
    jo = jax_flash(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                   scale=0.3, return_lse=False)
    to = tflash.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True, scale=0.3,
        return_lse=False)
    assert isinstance(to, torch.Tensor)
    assert_close(to, np.asarray(jo), 0, F32_ATOL, "out")


@pytest.mark.parametrize("causal", [False, True])
def test_bf16(causal):
    q, k, v = _inputs(1, 4, 2, 96, 96, 128, seed=11)
    jo, jl, to, tl = _both(q, k, v, "bfloat16", causal=causal)
    assert_close(to, jo, 0, BF16_ATOL, "out")
    assert_close(tl, jl, 0, BF16_ATOL, "lse")


def test_bf16_mono_class():
    """B1 H2/1 S1024 D128 bf16 causal: the `_mono_kernel` shape class,
    held against JAX's dense `attention_reference` (interpret mode is too
    slow at this size)."""
    q, k, v = _inputs(1, 2, 1, 1024, 1024, 128, seed=13)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jo, jl = jax_reference(jq, jk, jv, causal=True, return_lse=True)
    to, tl = tflash.flash_attention_fwd(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=True, return_lse=True)
    assert_close(to.float(), np.asarray(jo.astype(jnp.float32)), 0,
                 BF16_ATOL, "out")
    assert_close(tl, np.asarray(jl), 0, BF16_ATOL, "lse")


def test_fully_masked_rows_are_zero():
    """Non-causal window with Sq > Sk + W leaves rows that see nothing:
    output 0 and LSE -0.7*f32max, no NaN."""
    q, k, v = _inputs(1, 2, 2, 40, 8, 64, seed=17)
    to, tl = tflash.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), window_size=4)
    assert torch.isfinite(to).all()
    assert (to[:, :, 13:] == 0).all()
    assert np.allclose(tl[:, :, 13:].numpy(),
                       -0.7 * np.finfo(np.float32).max)


# The card's kernel works in tiles of 128 q rows and 128 keys, one q head a
# block; these cases put lengths, GQA groups and masks on its edges, in f32
# against JAX (interpret mode), through the port's CPU route: the plain
# version the kernel is held to on the card.
EDGE_CASES = {  # id: (B, Hq, Hkv, Sq, Sk, causal, window)
    "sq7_causal": (1, 4, 2, 7, 7, True, -1),
    "sq129_causal": (1, 4, 2, 129, 129, True, -1),
    "sq7_sk129_causal": (1, 4, 2, 7, 129, True, -1),
    "group1": (1, 2, 2, 100, 100, True, -1),
    "group2": (1, 4, 2, 100, 100, True, -1),
    "group8": (1, 8, 1, 100, 100, True, -1),
    "window_sq60_sk150_causal": (1, 4, 2, 60, 150, True, 20),
    "window_sq150_sk60_bidirectional": (1, 4, 2, 150, 60, False, 20),
    "rows_that_see_nothing": (1, 2, 2, 40, 8, False, 4),
}
MASKED_LSE = np.float32(-0.7 * np.finfo(np.float32).max)


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_f32_edge_cases(case):
    b, hq, hkv, sq, sk, causal, window = EDGE_CASES[case]
    q, k, v = _inputs(b, hq, hkv, sq, sk, 64, seed=sq + sk + hq)
    jo, jl, to, tl = _both(q, k, v, "float32", causal=causal,
                           window_size=window)
    assert_close(to, jo, 0, F32_ATOL, "out")
    assert_close(tl, jl, 0, F32_ATOL, "lse")
    # a row that sees nothing: output 0 and LSE -0.7*f32max in both
    blind = jl == MASKED_LSE
    if case == "rows_that_see_nothing":
        assert blind.any()
    assert (tl[blind] == MASKED_LSE).all() and (to[blind] == 0).all()


def test_cpu_route_does_not_count_launches():
    kernels = (tflash.flash_fwd_tma, tflash.flash_fwd_short)
    before = [fn.launches for fn in kernels]
    q, k, v = _inputs(1, 2, 2, 16, 16, 64)
    tflash.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)))
    assert [fn.launches for fn in kernels] == before


def _launcher_call(kernel, d):
    """(wrapper, a call of it on CPU tensors at head dim d): the forward
    launchers on bf16 q, k, v; the RoPE pre-pass on bf16 k and [8, d/2]
    tables; the f32 backward's dQ and dK/dV (both dK/dV kernels) on f32 q,
    k, v, do, lse, di."""
    if kernel in ("flash_fwd_tma", "flash_fwd_short", "rope_prepass"):
        fn = getattr(tflash, kernel)
        q = torch.zeros(1, 2, 8, d, dtype=torch.bfloat16)
        if kernel == "rope_prepass":
            tab = torch.ones(8, d // 2)
            return fn, lambda: fn(q, tab, tab * 0)
        return fn, lambda: fn(q, q, q, causal=True)
    fn = getattr(tflash_vjp, kernel)
    q = torch.zeros(1, 2, 8, d)
    rows = torch.zeros(1, 2, 8)
    return fn, lambda: fn(q, q, q, q, rows, rows, causal=True)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("kernel", ["flash_fwd_tma", "flash_fwd_short",
                                    "rope_prepass", "flash_bwd_f32_dq",
                                    "flash_bwd_f32_dkv",
                                    "flash_bwd_generic_dkv"])
def test_kernel_launchers_take_only_cuda_tensors(kernel, d):
    """Each kernel's launcher raises on CPU tensors (no CPU route) at every
    head dim and counts nothing."""
    fn, call = _launcher_call(kernel, d)
    before = fn.launches
    with pytest.raises(ValueError):
        call()
    assert fn.launches == before


@pytest.mark.parametrize("sq", [1, 2, tflash.SHORT_SQ, tflash.SHORT_SQ + 1])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_routing(dtype, d, sq):
    """The one rule of ops/flash.py: f32 on flash_f32.cu (the backward on
    flash_f32_bwd.cu); bf16/f16 on
    the tensor-core kernels at D 64/128/256, at D 128 the split-KV decode
    for one query and the mma.sync kernel for 2 to SHORT_SQ queries; each
    family's type check takes what the rule sends it and refuses the
    other's."""
    q = torch.zeros(1, 2, sq, d, dtype=dtype)
    generic = dtype == torch.float32
    assert tflash.uses_generic(q) is generic
    want = ("flash_fwd_f32" if generic
            else "flash_fwd_tma" if d != 128 or sq > tflash.SHORT_SQ
            else "flash_fwd_decode" if sq == 1 else "flash_fwd_short")
    assert tflash.forward_kernel(q) is getattr(tflash, want)
    tflash.check_kernel_type(q, generic)
    with pytest.raises(ValueError):
        tflash.check_kernel_type(q, not generic)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 96),
                                     (torch.bfloat16, 96),
                                     (torch.float16, 32)])
def test_kernel_routing_refuses_other_head_dims(dtype, d):
    q = torch.zeros(1, 2, 32, d, dtype=dtype)
    for generic in (True, False):
        with pytest.raises(ValueError):
            tflash.check_kernel_type(q, generic)


@pytest.mark.parametrize("feature", ["rope", "kv_len"])
def test_rope_and_kv_len_match_jax(feature):
    """Fused RoPE and a device-side kv_len (which raised before the port
    took them): the calls at [1, 2, 8, 64] against JAX's Pallas forward in
    interpret mode."""
    q, k, v = _inputs(1, 2, 2, 8, 8, 64, seed=19)
    if feature == "rope":
        rng = np.random.default_rng(5)
        ang = rng.uniform(-3, 3, (8, 32)).astype(np.float32)
        kw = dict(rope_cos=np.cos(ang), rope_sin=np.sin(ang))
        tkw = {n: torch.from_numpy(x) for n, x in kw.items()}
    else:
        kw, tkw = dict(kv_len=jnp.int32(4)), dict(kv_len=torch.tensor(4))
    jo, jl = jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                       return_lse=True, **kw)
    to, tl = tflash.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), **tkw)
    assert_close(to, np.asarray(jo), 0, F32_ATOL, "out")
    assert_close(tl, np.asarray(jl), 0, F32_ATOL, "lse")


ROPE_STEP = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_rope_prepass_plain_matches_jax(dtype, d):
    """The RoPE pre-pass's plain version (csrc/rope_prepass.cu turns K once
    a call for the TMA forward) against JAX's `apply_rope` and the Pallas
    kernel's `_apply_rope_tile` rounding (f32 rotation, rounded to the
    type) over the identity-padded tables the TPU kernel reads
    (flash.py:1564-1572): a 25-row table under 40 keys, so rows 25.. stay
    as they are, bit for bit; every other value within one rounding step
    of the type of JAX's."""
    from aule_tpu.ops.flash import _apply_rope_tile
    from aule_tpu.ops.rope import apply_rope as jax_apply_rope

    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 3, 40, d)).astype(np.float32)
    ang = rng.uniform(-3, 3, (25, d // 2)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    pad = np.zeros((15, d // 2), np.float32)
    cos_p, sin_p = np.concatenate([cos, pad + 1]), np.concatenate([sin, pad])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(x).to(tdt)
    got = tflash.rope_prepass_plain(xt, torch.from_numpy(cos),
                                    torch.from_numpy(sin))
    assert got.dtype == tdt and got.shape == xt.shape
    assert torch.equal(got[:, :, 25:], xt[:, :, 25:])
    got = got.float().numpy()
    for want in (jax_apply_rope(xj, jnp.asarray(cos_p), jnp.asarray(sin_p)),
                 _apply_rope_tile(xj.astype(jnp.float32), jnp.asarray(cos_p),
                                  jnp.asarray(sin_p)).astype(jdt)):
        want = np.asarray(want.astype(jnp.float32))
        step = ROPE_STEP[dtype] * np.maximum(np.abs(want), 2.0 ** -14)
        assert (np.abs(got - want) <= step).all()
