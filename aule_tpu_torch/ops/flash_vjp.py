"""Trainable flash attention (counterpart of aule_tpu/ops/flash_vjp.py).

The forward is the flash forward of `ops/flash.py`; the backward is three
kernels of csrc/flash_bwd.cu, as in the JAX package (flash_vjp.py:1-20):
  * delta = rowsum(o * do) - dlse, one pass over o and do shared by the
    other two (`attention_delta`; in JAX an XLA fusion, not a Pallas
    kernel); at D 64 and 256 the dQ kernel computes its rows' delta from o
    itself, on the tensor cores that compute dP (`flash_bwd_dq`);
  * dQ, q-parallel, reducing over the live kv tiles (`flash_bwd_dq`);
  * dK/dV, kv-parallel, reducing over the live q tiles; the GQA group's q
    heads are split over the two blocks of a thread-block cluster, which
    sum their shares in a fixed order, so it needs no atomics
    (`flash_bwd_dkv`).
Both recompute P from the saved LSE; the residuals are (q, k, v, o, lse).
The wrappers follow their tensors: CPU tensors take the plain PyTorch
versions, CUDA tensors launch the hand-written kernels (replacing
`_dq_kernel` and `_dkv_kernel` at every d_scale, and with a window
`_win_dq_kernel` and `_win_dkv_kernel`) or raise for what they do not take
(bf16/f16 at D 64, 128 or 256).  f32 takes csrc/flash_generic.cu's delta
(`attention_delta_generic`) and csrc/flash_f32_bwd.cu's dQ and dK/dV
(`flash_bwd_f32_dq`, `flash_bwd_f32_dkv`: the products on the tensor cores
in 3xTF32, short chains added to f32 sums, dQ's dP on FFMA, a fixed order
of every sum, no atomics; f32 only), but at D 256 flash_generic.cu's FFMA
dK/dV (`flash_bwd_generic_dkv`; `f32_dkv_kernel` holds the rule);
`flash_attention_bwd` picks by q's type (`ops.flash.uses_generic`), the
delta with the other two.

RoPE composes outside the op through `ops.rope.apply_rope`, whose
autograd gives its exact gradient.  With grad off (no input that requires
grad, or under `torch.no_grad()`), `flash_attention_vjp` launches the
forward without the LSE write, as JAX's primal `_flash_core` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .flash import (TENSOR_CORE_HEAD_DIMS, _check_shapes, _scale_window,
                    check_kernel_type, flash_attention_fwd,
                    flash_attention_fwd_plain, uses_generic)
from .reference import _expand_kv, build_mask
from .rope import apply_rope


def attention_delta_plain(o: torch.Tensor, do: torch.Tensor,
                          dlse: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """di = rowsum(o * do) - dlse, f32 [B, Hq, Sq] (flash_vjp.py:746-750):
    the lse cotangent folds into delta because d lse / d s = p."""
    di = (o.float() * do.float()).sum(-1)
    return di if dlse is None else di - dlse.float()


def attention_delta(o: torch.Tensor, do: torch.Tensor,
                    dlse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`attention_delta_plain` for CPU tensors; for CUDA tensors the
    delta kernel of csrc/flash_bwd.cu (one pass over the bf16/f16 o and
    do at D 64, 128 or 256, f32 sums)."""
    if o.device.type == "cpu":
        return attention_delta_plain(o, do, dlse)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    if do.shape != o.shape or do.device != o.device:
        raise ValueError(f"do {tuple(do.shape)} on {do.device} is not o's "
                         f"{tuple(o.shape)} on {o.device}")
    if o.shape[-1] not in TENSOR_CORE_HEAD_DIMS:
        raise ValueError(
            f"flash_bwd.cu's delta kernel takes D in {TENSOR_CORE_HEAD_DIMS}"
            f" (got D={o.shape[-1]})")
    if do.dtype != o.dtype:
        raise TypeError(f"o/do dtypes differ: {o.dtype}, {do.dtype}")
    code = _build.dtype_code(o.dtype)
    o, do = _aligned(o=o, do=do)
    rows = o.shape[:-1]
    if dlse is not None:
        if dlse.shape != rows or dlse.device != o.device:
            raise ValueError(f"dlse must be {tuple(rows)} on {o.device}, got "
                             f"{tuple(dlse.shape)} on {dlse.device}")
        dlse = dlse.float().contiguous()
    di = torch.empty(rows, dtype=torch.float32, device=o.device)
    err = _build.library().aule_flash_bwd_delta(
        o.data_ptr(), do.data_ptr(),
        dlse.data_ptr() if dlse is not None else None, di.data_ptr(),
        di.numel(), o.shape[-1], code, _build.stream_handle(o.device))
    _build.check(err, "aule_flash_bwd_delta")
    attention_delta.launches += 1
    return di


def _aligned(**tensors):
    """The tensors contiguous; raise unless each starts on a 16-byte
    boundary (a TMA tensor map's base, and the kernels' 16-byte loads)."""
    out = []
    for name, x in tensors.items():
        x = x.contiguous()
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
        out.append(x)
    return out


# ---- plain versions: dense f32, the same recompute as the kernels

def _plain_p_ds(q, k, v, do, lse, di, causal, scale, window):
    """(p, ds, k f32 expanded to the q heads) for dense [B, Hq, Sq, Sk]:
    p = exp(scale q k^T - lse) under the mask (0 elsewhere),
    ds = p (do v^T - di) scale."""
    hq, seq_q, seq_k = q.shape[1], q.shape[2], k.shape[2]
    kf = _expand_kv(k.float(), hq)
    vf = _expand_kv(v.float(), hq)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    mask = build_mask(seq_q, seq_k, causal, window, device=q.device)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]),
                    torch.zeros((), device=q.device))
    del s
    dp = torch.matmul(do.float(), vf.transpose(-1, -2))
    ds = p * (dp - di.float()[..., None]) * scale
    return p, ds, kf


def _group_sum(x, hkv):
    """[B, Hq, S, D] -> [B, Hkv, S, D], summed over each kv head's group."""
    b, hq, s, d = x.shape
    return x.reshape(b, hkv, hq // hkv, s, d).sum(2)


def flash_bwd_dq_plain(q, k, v, do, lse, di, *, causal=False, scale=None,
                       window=-1):
    """The dQ kernel's plain version: dq = ds k, in f32, cast to q's
    dtype."""
    scale, window = _scale_window(q, scale, window)
    _, ds, kf = _plain_p_ds(q, k, v, do, lse, di, causal, scale, window)
    return torch.matmul(ds, kf).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, di, *, causal=False, scale=None,
                        window=-1):
    """The dK/dV kernel's plain version: dk = ds^T q and dv = p^T do,
    summed over the GQA group in f32, cast to k's and v's dtypes."""
    scale, window = _scale_window(q, scale, window)
    p, ds, _ = _plain_p_ds(q, k, v, do, lse, di, causal, scale, window)
    hkv = k.shape[1]
    dk = _group_sum(torch.matmul(ds.transpose(-1, -2), q.float()), hkv)
    dv = _group_sum(torch.matmul(p.transpose(-1, -2), do.float()), hkv)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=False,
                              scale=None, window=-1, dlse=None):
    """The plain version of `flash_attention_bwd`: (dq, dk, dv) from delta
    and the two kernels' plain versions, in f32 by the kernels' recompute
    (not autograd through a reference)."""
    di = attention_delta_plain(o, do, dlse)
    kw = dict(causal=causal, scale=scale, window=window)
    return (flash_bwd_dq_plain(q, k, v, do, lse, di, **kw),
            *flash_bwd_dkv_plain(q, k, v, do, lse, di, **kw))


# ---- the kernels' wrappers

def _cuda_inputs(q, k, v, do, lse, di, generic=False):
    """Check what the CUDA kernels take (flash_bwd.cu's: bf16/f16 at
    D 64/128/256; `generic`, flash_f32_bwd.cu's: f32 at D 64/128/256);
    return the tensors contiguous."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if any(t.device != q.device for t in (k, v, do, lse, di)):
        raise ValueError("q, k, v, do, lse, di must be on one device")
    check_kernel_type(q, generic)
    if not (q.dtype == k.dtype == v.dtype == do.dtype):
        raise TypeError(f"q/k/v/do dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {do.dtype}")
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} is not q's {tuple(q.shape)}")
    rows = q.shape[:3]
    for name, t in (("lse", lse), ("di", di)):
        if t.dtype != torch.float32 or t.shape != rows:
            raise ValueError(f"{name} must be f32 {tuple(rows)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return (*_aligned(q=q, k=k, v=v, do=do),
            lse.contiguous(), di.contiguous())


def flash_bwd_dq(q, k, v, do, lse, di, *, causal=False, scale=None,
                 window=-1, o=None, dlse=None):
    """dQ [B, Hq, Sq, D] from q, k, v, do, the forward's lse and delta
    `di` (f32 [B, Hq, Sq]).  CPU tensors: the plain version; CUDA tensors:
    the dQ kernel of csrc/flash_bwd.cu (replaces flash_vjp.py::
    _dq_kernel).  At D 64 and 256 the kernel computes delta itself from the
    forward's output `o` (required there) and the lse cotangent `dlse`, on
    the tensor cores that compute dP, so a row whose exact dS is zero
    (causal row 0) gets exactly zero (csrc/flash_bwd.cu DqTile); at D 128
    it reads `di`."""
    _check_shapes(q, k, v)
    scale, window = _scale_window(q, scale, window)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, di, causal=causal,
                                  scale=scale, window=window)
    q, k, v, do, lse, di = _cuda_inputs(q, k, v, do, lse, di)
    batch, hq, seq_q, d = q.shape
    if d != 128:
        if o is None or o.shape != q.shape or o.dtype != q.dtype:
            raise ValueError(f"the dQ kernel at D={d} takes the forward's "
                             f"output o, {q.dtype} {tuple(q.shape)}")
        (o,) = _aligned(o=o.to(q.device))
        if dlse is not None:
            dlse = dlse.to(q.device, torch.float32).contiguous()
    else:
        o = dlse = None
    code = _build.dtype_code(q.dtype)
    lib = _build.library()
    dq = torch.empty_like(q)
    err = lib.aule_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        o.data_ptr() if o is not None else None,
        dlse.data_ptr() if dlse is not None else None,
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), batch, hq, k.shape[1],
        seq_q, k.shape[2], d, scale, int(bool(causal)), window, code,
        _build.stream_handle(q.device))
    _build.check(err, "aule_flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, di, *, causal=False, scale=None,
                  window=-1):
    """(dK, dV) [B, Hkv, Sk, D], summed over each kv head's q-head group.
    CPU tensors: the plain version; CUDA tensors: the dK/dV kernel of
    csrc/flash_bwd.cu (replaces flash_vjp.py::_dkv_kernel)."""
    _check_shapes(q, k, v)
    scale, window = _scale_window(q, scale, window)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, di, causal=causal,
                                   scale=scale, window=window)
    q, k, v, do, lse, di = _cuda_inputs(q, k, v, do, lse, di)
    code = _build.dtype_code(q.dtype)
    lib = _build.library()
    batch, hq, seq_q, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = lib.aule_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), batch,
        hq, k.shape[1], seq_q, k.shape[2], d, scale, int(bool(causal)),
        window, code, _build.stream_handle(q.device))
    _build.check(err, "aule_flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


def attention_delta_generic(o: torch.Tensor, do: torch.Tensor,
                            dlse: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """`attention_delta_plain` for CPU tensors; for CUDA tensors the delta
    kernel of csrc/flash_generic.cu (f32 at D 64/128/256; one warp a row,
    f32 sums in a fixed order)."""
    if o.device.type == "cpu":
        return attention_delta_plain(o, do, dlse)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    if do.shape != o.shape or do.device != o.device or do.dtype != o.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} on {do.device} "
                         f"is not o's {tuple(o.shape)} {o.dtype} on "
                         f"{o.device}")
    if o.dtype != torch.float32:
        raise TypeError(f"flash_generic.cu's delta takes f32 (got {o.dtype})")
    code = _build.dtype_code(o.dtype, f32=True)
    o, do = o.contiguous(), do.contiguous()
    rows = o.shape[:-1]
    if dlse is not None:
        if dlse.shape != rows or dlse.device != o.device:
            raise ValueError(f"dlse must be {tuple(rows)} on {o.device}, got "
                             f"{tuple(dlse.shape)} on {dlse.device}")
        dlse = dlse.float().contiguous()
    di = torch.empty(rows, dtype=torch.float32, device=o.device)
    err = _build.library().aule_flash_generic_delta(
        o.data_ptr(), do.data_ptr(),
        dlse.data_ptr() if dlse is not None else None, di.data_ptr(),
        di.numel(), o.shape[-1], code, _build.stream_handle(o.device))
    _build.check(err, "aule_flash_generic_delta")
    attention_delta_generic.launches += 1
    return di


def flash_bwd_f32_dq(q, k, v, do, lse, di, *, causal=False, scale=None,
                     window=-1):
    """dQ as `flash_bwd_dq`, on csrc/flash_f32_bwd.cu's dQ kernel (CUDA
    f32 tensors at D 64/128/256; S and dS K in 3xTF32, dP on FFMA, rounded
    as the plain version's product rounds it; replaces flash_vjp.py::
    _dq_kernel's f32 branch).  Raises on other tensors:
    `flash_bwd_dq_plain` is its plain version."""
    _check_shapes(q, k, v)
    scale, window = _scale_window(q, scale, window)
    q, k, v, do, lse, di = _cuda_inputs(q, k, v, do, lse, di, generic=True)
    batch, hq, seq_q, d = q.shape
    dq = torch.empty_like(q)
    err = _build.library().aule_flash_f32_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), batch, hq, k.shape[1],
        seq_q, k.shape[2], d, scale, int(bool(causal)), window,
        _build.dtype_code(q.dtype, f32=True), _build.stream_handle(q.device))
    _build.check(err, "aule_flash_f32_bwd_dq")
    flash_bwd_f32_dq.launches += 1
    return dq


def flash_bwd_f32_dkv(q, k, v, do, lse, di, *, causal=False, scale=None,
                      window=-1):
    """(dK, dV) as `flash_bwd_dkv`, on csrc/flash_f32_bwd.cu's 3xTF32 dK/dV
    kernel (CUDA f32 tensors at D 64 and 128; replaces flash_vjp.py::
    _dkv_kernel's f32 branch): one block per kv tile and q head; with GQA
    the heads' f32 shares go to a workspace, summed in head order by a
    second kernel (no atomics).  Raises on other tensors:
    `flash_bwd_dkv_plain` is its plain version."""
    return _f32_dkv("aule_flash_f32_bwd_dkv", flash_bwd_f32_dkv, q, k, v,
                    do, lse, di, causal, scale, window)


def _f32_dkv(entry, wrapper, q, k, v, do, lse, di, causal, scale, window):
    """Run the f32 dK/dV C entry `entry` on CUDA tensors; count a launch on
    `wrapper`."""
    _check_shapes(q, k, v)
    scale, window = _scale_window(q, scale, window)
    q, k, v, do, lse, di = _cuda_inputs(q, k, v, do, lse, di, generic=True)
    batch, hq, seq_q, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    group = hq // k.shape[1]
    ws = (torch.empty(2 * group * k.numel(), dtype=torch.float32,
                      device=q.device) if group > 1 else None)
    err = getattr(_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ws.data_ptr() if ws is not None else None, batch,
        hq, k.shape[1], seq_q, k.shape[2], d, scale, int(bool(causal)),
        window, _build.dtype_code(q.dtype, f32=True),
        _build.stream_handle(q.device))
    _build.check(err, entry)
    wrapper.launches += 1
    return dk, dv


def flash_bwd_generic_dkv(q, k, v, do, lse, di, *, causal=False,
                          scale=None, window=-1):
    """(dK, dV) as `flash_bwd_dkv`, on csrc/flash_generic.cu's FFMA dK/dV
    kernel (CUDA f32 tensors at D 256, where it ran faster than
    flash_f32_bwd.cu's 3xTF32 one on an H100: `f32_dkv_kernel`; replaces
    flash_vjp.py::_dkv_kernel's f32 branch there; one block per kv tile
    and q head, GQA shares summed in head order by a second kernel).
    Raises on other tensors: `flash_bwd_dkv_plain` is its plain version."""
    return _f32_dkv("aule_flash_generic_dkv", flash_bwd_generic_dkv, q, k,
                    v, do, lse, di, causal, scale, window)


def f32_dkv_kernel(q):
    """The f32 dK/dV wrapper for q's head dim: flash_f32_bwd.cu's 3xTF32
    kernel at D 64 and 128; flash_generic.cu's FFMA kernel at D 256, where
    the 3xTF32 kernel (two passes over its q tiles: dK and dV do not fit a
    thread's registers together) took 3.22 ms against 2.32 at B1 Hq8/Hkv1
    S2048 causal on an H100 80GB HBM3 at 700 W (PERF.md)."""
    return flash_bwd_generic_dkv if q.shape[-1] == 256 else flash_bwd_f32_dkv


# kernel launches since the last reset (the CPU route does not count)
attention_delta.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
attention_delta_generic.launches = 0
flash_bwd_f32_dq.launches = 0
flash_bwd_f32_dkv.launches = 0
flash_bwd_generic_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=False, scale=None,
                        window=-1, dlse=None):
    """(dq, dk, dv) of flash attention from its residuals and the output
    cotangent `do` (and the lse cotangent `dlse`, None = zero): the delta,
    dQ and dK/dV kernels, flash_bwd.cu's for bf16/f16 (D 64, 128, 256)
    and for f32 flash_generic.cu's delta with flash_f32_bwd.cu's dQ and
    dK/dV (`f32_dkv_kernel`: flash_generic.cu's at D 256; for CPU tensors
    `flash_attention_bwd_plain`)."""
    kw = dict(causal=causal, scale=scale, window=window)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, dlse=dlse, **kw)
    do = do.contiguous()  # arrives transposed from the heads merge
    if uses_generic(q):
        di = attention_delta_generic(o, do, dlse)
        return (flash_bwd_f32_dq(q, k, v, do, lse, di, **kw),
                *f32_dkv_kernel(q)(q, k, v, do, lse, di, **kw))
    di = attention_delta(o, do, dlse)
    return (flash_bwd_dq(q, k, v, do, lse, di, o=o, dlse=dlse, **kw),
            *flash_bwd_dkv(q, k, v, do, lse, di, **kw))


# ---- autograd

class _FlashAttention(torch.autograd.Function):
    """(out, lse) of flash attention; saves (q, k, v, out, lse), with q, k
    and v as the contiguous tensors the forward kernel read, and
    differentiates through the backward kernels (`plain`: through both
    plain versions)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, plain):
        ctx.set_materialize_grads(False)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        fwd = flash_attention_fwd_plain if plain else flash_attention_fwd
        out, lse = fwd(q, k, v, causal=causal, scale=scale,
                       window_size=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, window, plain)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, window, plain = ctx.args
        if do is None:  # only the lse was used
            do = torch.zeros_like(o)
        bwd = flash_attention_bwd_plain if plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do, causal=causal, scale=scale,
                         window=window, dlse=dlse)
        return dq, dk, dv, None, None, None, None


def _flash(q, k, v, causal, scale, window_size, plain, with_lse,
           rope_cos=None, rope_sin=None):
    if rope_cos is not None:  # rotation outside the op: exact gradients
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
    _check_shapes(q, k, v)
    scale, window = _scale_window(q, scale, window_size)
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        fwd = flash_attention_fwd_plain if plain else flash_attention_fwd
        return fwd(q, k, v, causal=bool(causal), scale=scale,
                   window_size=window, return_lse=with_lse)
    out, lse = _FlashAttention.apply(q, k, v, bool(causal), scale, window,
                                     plain)
    return (out, lse) if with_lse else out


def flash_attention_lse(q, k, v, causal: bool = False,
                        scale: Optional[float] = None,
                        window_size: int = -1):
    """Differentiable (out, lse [B, Hq, Sq] f32) pair; the lse cotangent is
    honoured (folded into delta)."""
    return _flash(q, k, v, causal, scale, window_size, False, True)


def flash_attention_vjp(q, k, v, causal: bool = False,
                        scale: Optional[float] = None,
                        window_size: int = -1,
                        rope_cos: Optional[torch.Tensor] = None,
                        rope_sin: Optional[torch.Tensor] = None):
    """Differentiable flash attention over [B, H, S, D] (GQA, causal and
    window masks, Sq != Sk); RoPE, when given, rotates q and k first,
    outside the op."""
    return _flash(q, k, v, causal, scale, window_size, False, False,
                  rope_cos, rope_sin)


def flash_attention_vjp_plain(q, k, v, causal: bool = False,
                              scale: Optional[float] = None,
                              window_size: int = -1,
                              rope_cos: Optional[torch.Tensor] = None,
                              rope_sin: Optional[torch.Tensor] = None):
    """`flash_attention_vjp` through the plain versions of the forward and
    of the backward on any device: the reference a kernel run is held
    against."""
    return _flash(q, k, v, causal, scale, window_size, True, False,
                  rope_cos, rope_sin)
