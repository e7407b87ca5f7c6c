"""The port's attention wrappers at head dims other than 64, 128 and 256
against the JAX package, which serves any head dim.

On the card a wrapper pads such a D to the kernel width above it
(`ops/flash.py::kernel_head_dim`: 64, 128 or 256) and slices the output
back (`pads_head` decides, on the tensor's device).  Here the
`padding_on_cpu` fixture makes that rule hold on CPU tensors too, so each
wrapper's own padding code runs, feeding the kernels' plain versions the
padded tensors; the result at the true D is held to JAX's at the same D
(Pallas in interpret mode; f32 2e-5, bf16 2e-2, LSE 1e-4, gradients 1e-4,
int8 dot products 4e-2 as tests/test_torch_paged_fused.py): the flash
forward at D 40 / 80 / 96 / 160 and odd D without RoPE, with the half-split
RoPE (each half padded on its own, the tables widened with cos 1, sin 0),
`kv_len` and a window; the gradients through the padding against
`jax.vjp`; the fused and split paged decode and the chunked prefill at D80
(and the fused decode at D40, whose kernel width 64 reads 64 of the pool's
128 lanes); and the SDPA patch's routing at D80.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aule_tpu
from aule_tpu.ops import paged as jpaged
from aule_tpu.ops import paged_fused as jpf
from aule_tpu.ops import quant as jq
import aule_tpu_torch
from aule_tpu_torch import backends
from aule_tpu_torch.integration import patching
from aule_tpu_torch.ops import flash as tflash
from aule_tpu_torch.ops import flash_vjp as tvjp
from aule_tpu_torch.ops import paged as tpaged
from aule_tpu_torch.ops import paged_fused as tpf
from aule_tpu_torch.ops import paged_prefill as tpp
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()

F32, BF16, LSE, GRAD = 2e-5, 2e-2, 1e-4, 1e-4
HKV, PAGE, NUM_PAGES = 2, 16, 24
WRAPPER_MODULES = (tflash, tvjp, tpf, tpp, tpaged)


@pytest.fixture
def padding_on_cpu(monkeypatch):
    """The wrappers' padding rule with the device left out: CPU tensors
    at other head dims take the padded route the card takes."""
    def rule(q):
        return q.shape[-1] not in tflash.TENSOR_CORE_HEAD_DIMS

    for mod in WRAPPER_MODULES:
        monkeypatch.setattr(mod, "pads_head", rule)


def _inputs(b, hq, hkv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))


def _t(xs, dtype=torch.float32):
    return [torch.from_numpy(np.asarray(x)).to(dtype) for x in xs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tables(n, d):
    cos, sin = aule_tpu_torch.precompute_rope_frequencies(n, d, 10000.0)
    return cos.numpy(), sin.numpy()


def test_kernel_width_and_the_padding_helpers():
    assert [tflash.kernel_head_dim(d) for d in (1, 40, 64, 65, 80, 96, 128,
                                                129, 160, 256)] == \
        [64, 64, 64, 128, 128, 128, 128, 256, 256, 256]
    with pytest.raises(ValueError, match="up to 256"):
        tflash.kernel_head_dim(257)
    x = torch.arange(1.0, 7.0).reshape(1, 6)
    assert tflash.pad_head(x, 10).tolist() == [[1, 2, 3, 4, 5, 6, 0, 0, 0,
                                                 0]]
    assert tflash.pad_head(x, 10, halves=True).tolist() == \
        [[1, 2, 3, 0, 0, 4, 5, 6, 0, 0]]
    cos, sin = tflash.pad_rope_tables(torch.full((2, 3), 0.5),
                                      torch.full((2, 3), 0.25), 10)
    assert cos.tolist() == [[0.5] * 3 + [1.0] * 2] * 2
    assert sin.tolist() == [[0.25] * 3 + [0.0] * 2] * 2
    assert not tflash.pads_head(torch.zeros(1, 1, 1, 80))  # CPU: plain


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [40, 80, 96, 160, 33])
def test_forward_at_other_head_dims(padding_on_cpu, d, causal):
    """Out and LSE at D 40 / 80 / 96 / 160 and an odd D (padded at the
    end) against JAX's Pallas forward at the true D; the scale is
    1/sqrt(D) of the true D."""
    qkv = _inputs(1, 4, 2, 48, 56, d, seed=d + causal)
    jo, jl = aule_tpu.flash_attention(*map(jnp.asarray, qkv), causal=causal,
                                      backend="pallas", return_lse=True)
    to, tl = tflash.flash_attention_fwd(*_t(qkv), causal=causal)
    assert to.shape[-1] == d
    assert_close(to, _np(jo), 0, F32, f"D{d} out")
    assert_close(tl, _np(jl), 0, LSE, f"D{d} lse")


def test_forward_bf16_d80(padding_on_cpu):
    qkv = _inputs(1, 8, 2, 64, 64, 80, seed=3)
    jo = aule_tpu.flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                                    for x in qkv), causal=True,
                                  backend="pallas")
    to = tflash.flash_attention_fwd(*_t(qkv, torch.bfloat16), causal=True,
                                    return_lse=False)
    assert to.dtype == torch.bfloat16
    assert_close(to, _np(jo), 0, BF16, "bf16 D80")


@pytest.mark.parametrize("d", [40, 80, 96, 160])
def test_rope_kv_len_window(padding_on_cpu, d):
    """The half-split RoPE fused in the forward (q and k padded by halves,
    the tables widened), with a device-side kv_len and a causal window,
    against JAX's forward with the same tables at the true D."""
    qkv = _inputs(1, 4, 2, 40, 96, d, seed=100 + d)
    cos, sin = _tables(96, d)
    kw = dict(causal=True, window_size=30, kv_len=70)
    jo, jl = aule_tpu.flash_attention(*map(jnp.asarray, qkv), rope_cos=cos,
                                      rope_sin=sin, backend="xla",
                                      return_lse=True, **kw)
    to, tl = tflash.flash_attention_fwd(
        *_t(qkv), rope_cos=torch.from_numpy(cos),
        rope_sin=torch.from_numpy(sin), **kw)
    assert_close(to, _np(jo), 0, F32, f"D{d} rope out")
    assert_close(tl, _np(jl), 0, LSE, f"D{d} rope lse")


def test_rope_needs_an_even_head_dim(padding_on_cpu):
    q, k, v = _t(_inputs(1, 2, 2, 8, 8, 33, seed=9))
    cos, sin = (torch.ones(8, 16),) * 2
    with pytest.raises(ValueError):
        tflash.flash_attention_fwd(q, k, v, rope_cos=cos, rope_sin=sin)


@pytest.mark.parametrize("d,causal,window", [(40, True, -1), (80, True, 20),
                                             (160, False, -1), (33, False,
                                                                 -1)])
def test_gradients_through_the_padding(padding_on_cpu, d, causal, window):
    """dQ, dK, dV through the padded forward and backward (the padding
    outside the autograd Function, sliced back by autograd; an lse
    cotangent too) against jax.vjp of JAX's attention at the true D."""
    qkv = _inputs(1, 4, 2, 32, 32, d, seed=200 + d)
    rng = np.random.default_rng(7 + d)
    do = rng.standard_normal(qkv[0].shape).astype(np.float32)
    dl = rng.standard_normal(qkv[0].shape[:3]).astype(np.float32)

    def jfn(q, k, v):
        return aule_tpu.flash_attention(q, k, v, causal=causal,
                                        window_size=window, backend="xla",
                                        return_lse=True)

    (jo, jl), vjp = jax.vjp(jfn, *map(jnp.asarray, qkv))
    jgrads = vjp((jnp.asarray(do), jnp.asarray(dl)))
    q, k, v = (x.requires_grad_(True) for x in _t(qkv))
    to, tl = tvjp.flash_attention_lse(q, k, v, causal=causal,
                                      window_size=window)
    torch.autograd.backward((to, tl), (torch.from_numpy(do),
                                       torch.from_numpy(dl)))
    assert_close(to, _np(jo), 0, F32, "out")
    assert_close(tl, _np(jl), 0, LSE, "lse")
    for name, g, w in zip("qkv", (q.grad, k.grad, v.grad), jgrads):
        assert g.shape[-1] == d
        assert_close(g, _np(w), GRAD, GRAD, f"D{d} d{name}")


def test_backward_entry_pads(padding_on_cpu):
    """flash_attention_bwd called directly at D80 (as the Function calls it
    at the kernel widths) pads q, k, v, o and do and slices the gradients:
    equal to its plain version at D80."""
    q, k, v = _t(_inputs(1, 4, 2, 24, 24, 80, seed=5))
    o, lse = tflash.flash_attention_fwd_plain(q, k, v, causal=True)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(1))
    got = tvjp.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = tvjp.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close(g, w, 0, 1e-5, "bwd")


def _decode_case(rng, d, lens, hq=4):
    pool = rng.standard_normal(
        tpf.fused_pool_shape(NUM_PAGES, HKV, PAGE, d)).astype(np.float32)
    pool[..., d:] = 0.0  # the lanes past D, as the appends write them
    pool[0] = 1e3        # scratch page: never attended
    q = rng.standard_normal((len(lens), hq, d)).astype(np.float32)
    bt = np.full((len(lens), 4), -1, np.int32)
    ids = rng.permutation(np.arange(1, NUM_PAGES))
    used = 0
    for b, n in enumerate(lens):
        npg = -(-n // PAGE)
        bt[b, :npg] = ids[used:used + npg]
        used += npg
    return q, pool, bt, np.asarray(lens, np.int32)


def _tq(x, dtype):
    a = np.asarray(x)
    if dtype == torch.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(dtype)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("d", [80, 40])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8_exact", "int8_dot",
                                  "fp8"])
def test_fused_decode(padding_on_cpu, mode, d):
    """paged_attention_fused at D80 (kernel width 128, the pool's) and D40
    (kernel width 64: 64 of the pool's 128 lanes) over f32 / bf16 pools
    and int8 / e4m3 pools with f32 scales, a window, zero and one-token
    contexts, against JAX's fused decode in interpret mode."""
    rng = np.random.default_rng(300 + d)
    lens = (37, 0, 64, 1)
    q, pool, bt, ln = _decode_case(rng, d, lens, hq=8)
    jbt, jln = jnp.asarray(bt), jnp.asarray(ln)
    tbt, tln = torch.from_numpy(bt), torch.from_numpy(ln)
    kw = dict(window_size=21, return_lse=True)
    tol, ltol = F32, F32
    if mode in ("f32", "bf16"):
        jdt, tdt = ((jnp.float32, torch.float32) if mode == "f32"
                    else (jnp.bfloat16, torch.bfloat16))
        jo, jl = jpf.paged_attention_fused(
            jnp.asarray(q, jdt), jnp.asarray(pool, jdt), jbt, jln, **kw)
        to, tl = tpf.paged_attention_fused(
            torch.from_numpy(q).to(tdt), torch.from_numpy(pool).to(tdt), tbt,
            tln, **kw)
        if mode == "bf16":
            tol, ltol = BF16, BF16
    else:
        jqd, tqd = ((jnp.float8_e4m3fn, torch.float8_e4m3fn) if mode == "fp8"
                    else (jnp.int8, torch.int8))
        # head-major K/V quantized per token by JAX, packed with f32
        # scales: the same bytes for both
        k, v = (rng.standard_normal((HKV, NUM_PAGES, PAGE, d)).astype(
            np.float32) for _ in range(2))
        kq, ks = jq.quantize_kv(jnp.asarray(k), jqd)
        vq, vs = jq.quantize_kv(jnp.asarray(v), jqd)
        payload, sc = jpf.to_fused_layout(kq, vq, ks, vs,
                                          scale_dtype=jnp.float32)
        dot = mode == "int8_dot"
        kw.update(int8_matmul=dot)
        jo, jl = jpf.paged_attention_fused(
            jnp.asarray(q), payload, jbt, jln, kv_scales=sc, **kw)
        to, tl = tpf.paged_attention_fused(
            torch.from_numpy(q), _tq(payload, tqd), tbt, tln,
            kv_scales=_tq(sc, torch.float32), **kw)
        if dot:
            tol, ltol = 4e-2, 2e-2
    assert to.shape[-1] == d
    assert_close(to, _np(jo), 0, tol, f"{mode} D{d} out")
    assert_close(tl, _np(jl), 0, ltol, f"{mode} D{d} lse")
    assert (to[1] == 0).all()  # context 0


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_split_decode_d80(padding_on_cpu, mode):
    """paged_attention over split pools [Hkv, P, page, 80]: q and both
    pools padded on each call (`pad_split_pools`), against JAX's split
    decode, which pads them the same way."""
    rng = np.random.default_rng(400)
    d, lens = 80, (37, 0, 64, 1)
    k = rng.standard_normal((HKV, NUM_PAGES, PAGE, d)).astype(np.float32)
    v = rng.standard_normal((HKV, NUM_PAGES, PAGE, d)).astype(np.float32)
    q, _, bt, ln = _decode_case(rng, d, lens, hq=8)
    args = (jnp.asarray(bt), jnp.asarray(ln))
    targs = (torch.from_numpy(bt), torch.from_numpy(ln))
    if mode == "f32":
        jo, jl = jpaged.paged_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), *args,
                                        return_lse=True)
        to, tl = tpaged.paged_attention(*_t((q, k, v)), *targs,
                                        return_lse=True)
    else:
        kq, ks = jq.quantize_kv(jnp.asarray(k), jnp.int8)
        vq, vs = jq.quantize_kv(jnp.asarray(v), jnp.int8)
        jo, jl = jpaged.paged_attention(jnp.asarray(q), kq, vq, *args,
                                        k_scales=ks, v_scales=vs,
                                        return_lse=True)
        to, tl = tpaged.paged_attention(
            torch.from_numpy(q), _tq(kq, torch.int8), _tq(vq, torch.int8),
            *targs, k_scales=_tq(ks, torch.float32),
            v_scales=_tq(vs, torch.float32), return_lse=True)
    assert to.shape[-1] == d
    assert_close(to, _np(jo), 0, 1e-4, f"split {mode} out")
    assert_close(tl, _np(jl), 0, 1e-4, f"split {mode} lse")
    kp, vp = tpaged.pad_split_pools(*_t((k, v)), 128)
    assert kp.shape[-1] == 128 and (kp[..., d:] == 0).all()


@pytest.mark.parametrize("window", [-1, 24])
def test_prefill_chunk_d80(padding_on_cpu, window):
    """paged_attention_prefill of a 24-token chunk at q_offset 40 over a
    D80 pool (a ragged second sequence), against JAX's in interpret
    mode."""
    rng = np.random.default_rng(500 + max(window, 0))
    d, s_new = 80, 24
    _, pool, bt, _ = _decode_case(rng, d, (64, 50), hq=8)
    q = rng.standard_normal((2, 8, s_new, d)).astype(np.float32)
    lens = np.array([64, 50], np.int32)
    qoff = np.array([40, 30], np.int32)
    kw = dict(causal=True, window_size=window, return_lse=True)
    jo, jl = jpf.paged_attention_prefill(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt),
        jnp.asarray(lens), q_offsets=jnp.asarray(qoff), **kw)
    to, tl = tpp.paged_attention_prefill(
        torch.from_numpy(q), torch.from_numpy(pool), torch.from_numpy(bt),
        torch.from_numpy(lens), q_offsets=torch.from_numpy(qoff), **kw)
    live = (qoff[:, None] + np.arange(s_new)[None]) < lens[:, None]
    for b in range(2):  # rows past a sequence's length: the port's zeros
        rows = live[b]
        assert_close(to[b][:, rows], _np(jo)[b][:, rows], 0, F32, "out")
        assert_close(tl[b][:, rows], _np(jl)[b][:, rows], 0, LSE, "lse")
    assert to.shape[-1] == d


def test_patch_routes_d80_to_the_kernels(monkeypatch):
    """On the cuda backend the SDPA patch keeps D80 (and odd D) on the
    port's route and hands only D above 256 to torch's function."""
    monkeypatch.setattr(backends, "select_backend", lambda b=None: "cuda")
    for d, off in ((80, False), (40, False), (160, False), (33, False),
                   (256, False), (320, True)):
        assert patching._off_kernels(torch.zeros(1, 2, 4, d), None) is off


@pytest.mark.parametrize("d", [80, 33])
def test_patched_sdpa_takes_other_head_dims(monkeypatch, d):
    """Through the patch on the torch backend a D80 or odd-D call runs the
    port's flash attention (not the original) and equals torch's SDPA."""
    original = torch.nn.functional.scaled_dot_product_attention
    q, k, v = _t(_inputs(1, 2, 2, 16, 16, d, seed=d))
    calls = []
    aule_tpu_torch.install(backend="torch")
    try:
        monkeypatch.setattr(patching, "_original_sdpa",
                            lambda *a, **kw: calls.append(1))
        got = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)
    finally:
        monkeypatch.undo()
        aule_tpu_torch.uninstall()
    assert not calls
    assert_close(got, original(q, k, v, is_causal=True), 0, F32, f"D{d}")
