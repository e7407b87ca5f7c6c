"""Flash-attention forward (counterpart of aule_tpu/ops/flash.py).

`flash_attention_fwd` keeps the JAX signature and layout: q [B, Hq, Sq, D],
k/v [B, Hkv, Sk, D] in; `(out, lse [B, Hq, Sq])` or `out` back.  It takes
every argument of the TPU kernel `_fwd_kernel`: causal and window masks,
GQA, Sq != Sk, fused RoPE (`rope_cos`/`rope_sin`, [L, D/2] f32 tables;
positions 0..Sq-1 for q and 0..Sk-1 for k, the identity past L) and a
`kv_len` (only the first kv_len keys attend; an int, or an int32 tensor
that is read on the card and never on the host, so a CUDA graph can replay
the call at another length).  It follows its tensors:
  * CPU tensors go to `flash_attention_fwd_plain`, the dense PyTorch version;
  * CUDA tensors launch a hand-written kernel, by one rule on the type, the
    head dim and the query length (`forward_kernel`):
      - bf16 / f16 at D = 64, 128 or 256 (`TENSOR_CORE_HEAD_DIMS`):
        `flash_fwd_tma`, csrc/flash_fwd.cu's TMA/wgmma kernel (replaces
        `_fwd_kernel` at every d_scale and `_mono_kernel`; see the source
        notes; with RoPE, `rope_prepass` first turns K once a call, and the
        kernel turns Q), except at D = 128 for
          one query: `flash_fwd_decode`, csrc/flash_fwd_short.cu's
          split-KV decode (every GQA group, mask, RoPE and kv_len; the
          SDPA patch's bucketed decode), and
          2 to `SHORT_SQ` queries: `flash_fwd_short`, the same file's
          mma.sync kernel
        (at D 64 and 256 the TMA kernel runs short queries too: on an H100
        it took 9.6 us against the FFMA kernel's 126 at 1 and 16 queries
        of GPT-2's layer, scripts/torch_flash_ab.sh);
      - f32 at D = 64, 128 or 256 (`GENERIC_HEAD_DIMS`):
        `flash_fwd_f32`, csrc/flash_f32.cu's kernel on the tensor cores in
        3xTF32 (each f32 operand split into two TF32 values, three
        products summed in f32: within 1e-5 of an f32 reference, as the
        TPU kernel's f32 branch keeps f32 on the matrix unit at
        Precision.HIGHEST);
    other head dims raise.
`flash_attention_rope` is the forward-only fused-RoPE entry, and
`flash_attention_cuda` the differentiable one (RoPE outside the op, as
JAX's `flash_attention_pallas`).  Training goes through `ops/flash_vjp.py`,
whose autograd Function calls this forward (with its LSE) and the backward
kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build, decode_split
from .reference import _expand_kv, attention_reference
from .rope import apply_rope

# head dims of the tensor-core kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu;
# bf16 / f16) and of the f32 ones (csrc/flash_f32.cu's forward,
# csrc/flash_f32_bwd.cu's backward with csrc/flash_generic.cu's delta)
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)
GENERIC_HEAD_DIMS = (64, 128, 256)
# Queries per head at or below which the mma.sync kernel runs at D = 128:
# a tile or two of work, whose time is the latency to the first tile,
# which the TMA/wgmma kernel's warp-specialised set-up lengthens.  Set from
# chip_smoke.py's device times of both kernels at short prompts (on an
# H100 the mma.sync kernel led at 7 and 16 queries and trailed from 32;
# PERF.md).
SHORT_SQ = 16


def rope_identity_padded(rope_cos, rope_sin, n: int):
    """The tables as the kernels read them, [n, D/2] f32: rows past the
    tables' end are cos 1, sin 0 (the TPU kernel pads them so,
    flash.py:1564-1572)."""
    cos = rope_cos.float()[:n]
    sin = rope_sin.float()[:n]
    if cos.shape[0] < n:
        pad = n - cos.shape[0]
        cos = torch.cat([cos, cos.new_ones(pad, cos.shape[1])])
        sin = torch.cat([sin, sin.new_zeros(pad, sin.shape[1])])
    return cos, sin


def flash_attention_fwd_plain(q, k, v, *, causal: bool = False,
                              scale: Optional[float] = None,
                              window_size: int = -1,
                              rope_cos: Optional[torch.Tensor] = None,
                              rope_sin: Optional[torch.Tensor] = None,
                              return_lse: bool = True, kv_len=None):
    """The plain PyTorch version of the kernels: dense f32 attention; RoPE
    in f32 with the kernels' identity past the tables, the rotated q and k
    rounded to their type as the kernels round their tiles (and as
    flash.py:227-243 does); the kv_len mask."""
    if rope_cos is not None:
        cos, sin = rope_identity_padded(rope_cos, rope_sin,
                                        max(q.shape[2], k.shape[2]))
        q = apply_rope(q, cos.to(q.device), sin.to(q.device))
        k = apply_rope(k, cos.to(k.device), sin.to(k.device))
    return attention_reference(q, k, v, causal=causal, scale=scale,
                               window_size=window_size, return_lse=return_lse,
                               kv_len=kv_len)


def decode_keys(seq_k: int, causal: bool, window: int) -> int:
    """The keys a lone query (position 0) may see of Sk: key 0 alone when
    causal, keys 0 .. window with a window, else all.  The split-KV
    decode's capacity (ops/decode_split.py `num_splits`): shapes only."""
    if causal:
        return min(seq_k, 1)
    if window > 0:
        return min(seq_k, window + 1)
    return seq_k


def flash_decode_split_plain(q, k, v, *, nsplit: int, causal: bool = False,
                             scale: Optional[float] = None,
                             window_size: int = -1, rope_cos=None,
                             rope_sin=None, kv_len=None,
                             return_lse: bool = True):
    """The plain version of the split-KV decode (`flash_fwd_decode`): one
    query over the keys [0, n) it sees (n from kv_len and
    `decode_keys`), cut into nsplit ranges by ops/decode_split.py's
    `split_bounds` and merged in split order (`split_merge`), in f32 with
    the plain version's RoPE.  q [B, Hq, 1, D]."""
    if q.shape[2] != 1:
        raise ValueError(f"the decode takes one query, got Sq={q.shape[2]}")
    scale, window = _scale_window(q, scale, window_size)
    batch, hq = q.shape[:2]
    seq_k = k.shape[2]
    if rope_cos is not None:
        cos, sin = rope_identity_padded(rope_cos, rope_sin,
                                        max(1, seq_k))
        q = apply_rope(q, cos.to(q.device), sin.to(q.device))
        k = apply_rope(k, cos.to(k.device), sin.to(k.device))
    kx = _expand_kv(k.float(), hq)
    vx = _expand_kv(v.float(), hq)
    scores = torch.einsum("bhd,bhkd->bhk", q[:, :, 0].float(), kx) * scale
    live = torch.as_tensor(seq_k if kv_len is None else kv_len,
                           device=q.device).reshape(()).clamp(
        0, decode_keys(seq_k, causal, window))
    pos = torch.arange(seq_k, device=q.device)
    valid = (pos < live)[None, None].expand(batch, hq, seq_k)
    lo, hi = decode_split.split_bounds(live.reshape(1).expand(batch),
                                       seq_k, -1, nsplit)
    out, lse = decode_split.split_merge(
        scores, valid, lo, hi,
        lambda p, keep: (p.sum(-1), torch.einsum("bhk,bhkd->bhd", p, vx)))
    out = out.to(q.dtype)[:, :, None]
    return (out, lse[:, :, None]) if return_lse else out


def _scale_window(q, scale, window_size):
    """(softmax scale, 1/sqrt(D) when None; window, -1 when none)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    window = int(window_size) if window_size and window_size > 0 else -1
    return float(scale), window


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"Hq={q.shape[1]} is not a multiple of "
                         f"Hkv={k.shape[1]}")


def _check_rope(q, rope_cos, rope_sin):
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("rope_cos and rope_sin come together")
    if rope_cos is None:
        return
    want = q.shape[-1] // 2
    if (rope_cos.dim() != 2 or rope_cos.shape != rope_sin.shape
            or rope_cos.shape[1] != want):
        raise ValueError(f"rope tables must both be [L, {want}], got "
                         f"{tuple(rope_cos.shape)} and "
                         f"{tuple(rope_sin.shape)}")


def uses_generic(q) -> bool:
    """Whether the card runs q's forward and backward on the f32 kernels
    (csrc/flash_f32.cu's 3xTF32 forward, csrc/flash_f32_bwd.cu's 3xTF32
    backward) rather than the 16-bit tensor-core kernels: f32, at every
    head dim (the f32 rows are held to 1e-5 of an f32 reference, which one
    TF32 pass, with its 11-bit significand, does not keep)."""
    return q.dtype == torch.float32


def forward_kernel(q):
    """The forward wrapper `flash_attention_fwd` launches for a CUDA q (the
    rule of the module's docstring)."""
    if uses_generic(q):
        return flash_fwd_f32
    if q.shape[-1] == 128 and q.shape[2] == 1:
        return flash_fwd_decode
    if q.shape[-1] == 128 and q.shape[2] <= SHORT_SQ:
        return flash_fwd_short
    return flash_fwd_tma


def check_kernel_type(q, generic: bool) -> None:
    """Raise unless the kernels of one family take q's type and head dim:
    the f32 kernels (`generic`: flash_f32.cu, flash_f32_bwd.cu) f32 at D
    64/128/256; the 16-bit tensor-core kernels bf16/f16 at D 64/128/256."""
    d = q.shape[-1]
    if generic:
        if d in GENERIC_HEAD_DIMS and q.dtype == torch.float32:
            return
        raise ValueError(f"the f32 flash kernels take f32 at D in "
                         f"{GENERIC_HEAD_DIMS} (got {q.dtype} D={d}); "
                         f"bf16/f16 run on the tensor-core kernels")
    if d not in TENSOR_CORE_HEAD_DIMS or q.dtype == torch.float32:
        raise ValueError(f"the tensor-core flash kernels take bf16/f16 at "
                         f"D in {TENSOR_CORE_HEAD_DIMS} (got {q.dtype} "
                         f"D={d}); f32 runs on flash_f32.cu")


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    window_size: int = -1,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    return_lse: bool = True,
    kv_len=None,
):
    """softmax(scale * q k^T + mask) v with GQA, causal (top-left aligned)
    and window masks, Sq != Sk, fused RoPE and a device-side kv_len.
    Returns (out, natural-log lse f32) or just out with return_lse=False."""
    _check_shapes(q, k, v)
    _check_rope(q, rope_cos, rope_sin)
    scale, window = _scale_window(q, scale, window_size)
    kw = dict(causal=causal, scale=scale, window_size=window,
              rope_cos=rope_cos, rope_sin=rope_sin, return_lse=return_lse,
              kv_len=kv_len)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, **kw)
    return forward_kernel(q)(q, k, v, **kw)


def _kv_len_tensor(kv_len, seq_k: int, device):
    """kv_len as one int32 on `device` (a tensor is never read on the
    host: an int32 tensor already there is passed as it is, so a CUDA graph
    that captured the call reads its value at each replay)."""
    if kv_len is None:
        return None
    if isinstance(kv_len, torch.Tensor):
        if kv_len.numel() != 1:
            raise ValueError(f"kv_len must hold one length, got shape "
                             f"{tuple(kv_len.shape)}")
        return kv_len.to(device=device, dtype=torch.int32).reshape(1)
    n = int(kv_len)
    if not 0 <= n <= seq_k:
        raise ValueError(f"kv_len {n} is outside [0, Sk={seq_k}]")
    return torch.tensor([n], dtype=torch.int32, device=device)


def _rope_tensor(t, device):
    """A table as the kernels read it: f32, contiguous, 16-byte aligned."""
    t = t.to(device=device, dtype=torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def rope_prepass_plain(x, rope_cos, rope_sin):
    """The pre-pass's plain version: `apply_rope` over the tables as the
    kernels read them (`rope_identity_padded`: the identity past their
    end), x [B, H, S, D] rotated and rounded to its type."""
    cos, sin = rope_identity_padded(rope_cos, rope_sin, x.shape[2])
    return apply_rope(x, cos.to(x.device), sin.to(x.device))


def rope_prepass(x, rope_cos, rope_sin):
    """csrc/rope_prepass.cu on CUDA bf16/f16 x [B, H, S, D] at D 64, 128 or
    256: x rotated into a new tensor, each row once (rows at or past the
    tables' length as they are), as `flash_fwd_tma` needs its K (it turns
    Q in its consumers: turning Q in the pre-pass's launch too was 1-6 %
    faster at S2048, D64 and D256 and 8 % slower over 3,000 of 4,096 keys
    on an H100 80GB HBM3 at 700 W, PERF.md).  The rotation of
    `rope_prepass_plain`, bit for bit.  Raises on other tensors."""
    if x.device.type != "cuda":
        raise ValueError(f"rope_prepass runs on CUDA tensors, got "
                         f"{x.device}")
    if x.dim() != 4:
        raise ValueError(f"rope_prepass takes [B, H, S, D], got "
                         f"{tuple(x.shape)}")
    check_kernel_type(x, False)
    _check_rope(x, rope_cos, rope_sin)
    x = x.contiguous()
    y = torch.empty_like(x)
    cos, sin = (_rope_tensor(t, x.device) for t in (rope_cos, rope_sin))
    err = _build.library().aule_rope_prepass(
        x.data_ptr(), y.data_ptr(), x.shape[0] * x.shape[1], x.shape[2],
        cos.data_ptr(), sin.data_ptr(), x.shape[-1], cos.shape[0],
        _build.dtype_code(x.dtype), _build.stream_handle(x.device))
    _build.check(err, "aule_rope_prepass")
    rope_prepass.launches += 1
    return y


def _launch(entry: str, q, k, v, causal, scale, window_size, rope_cos,
            rope_sin, return_lse, kv_len, generic: bool):
    """Check CUDA q, k, v and run the C entry point `entry` on them."""
    _check_shapes(q, k, v)
    _check_rope(q, rope_cos, rope_sin)
    scale, window = _scale_window(q, scale, window_size)
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernels run on CUDA tensors, got "
                         f"{q.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    check_kernel_type(q, generic)
    d = q.shape[-1]
    code = _build.dtype_code(q.dtype, f32=generic)
    if not (k.device == v.device == q.device):
        raise ValueError("q, k, v must be on one device")
    lib = _build.library()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:  # a TMA tensor map's base, 16-byte loads
            raise ValueError(f"{name} must start on a 16-byte boundary")
    batch, hq, seq_q, _ = q.shape
    hkv, seq_k = k.shape[1], k.shape[2]
    cos = sin = None
    if rope_cos is not None:
        cos, sin = (_rope_tensor(t, q.device) for t in (rope_cos, rope_sin))
    live = _kv_len_tensor(kv_len, seq_k, q.device)
    out = torch.empty_like(q)
    lse = (torch.empty((batch, hq, seq_q), dtype=torch.float32,
                       device=q.device) if return_lse else None)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            cos.data_ptr() if cos is not None else None,
            sin.data_ptr() if sin is not None else None,
            live.data_ptr() if live is not None else None]
    if entry == "aule_flash_fwd" and cos is not None:
        # K turned once a call; the kernel reads it as it comes
        k = rope_prepass(k, cos, sin)
        ptrs[1] = k.data_ptr()
    rope_len = cos.shape[0] if cos is not None else 0
    flags = (scale, int(bool(causal)), window)
    if entry == "aule_flash_fwd_decode":
        # the split count from the shapes (the padded Sk is the capacity)
        # and the merge buffers (ops/decode_split.py)
        nsplit, ws, cnt = decode_split.launch_plan(
            batch, hq, hkv, decode_keys(seq_k, causal, window), -1,
            q.device, head_dim=d, tile_rows=decode_split.FLASH_TILE_ROWS)
        ptrs += [ws.data_ptr() if ws is not None else None,
                 cnt.data_ptr() if cnt is not None else None]
        err = lib.aule_flash_fwd_decode(
            *ptrs, batch, hq, hkv, seq_k, d, rope_len, *flags, nsplit, code,
            _build.stream_handle(q.device))
    else:
        err = getattr(lib, entry)(
            *ptrs, batch, hq, hkv, seq_q, seq_k, d, rope_len, *flags, code,
            _build.stream_handle(q.device))
    _build.check(err, entry)
    return (out, lse) if return_lse else out


def flash_fwd_tma(q, k, v, *, causal: bool = False,
                  scale: Optional[float] = None, window_size: int = -1,
                  rope_cos=None, rope_sin=None, return_lse: bool = True,
                  kv_len=None):
    """csrc/flash_fwd.cu's TMA/wgmma kernel on CUDA bf16/f16 tensors at
    D 64, 128 or 256 of any length (what `flash_attention_fwd` runs for
    them, but for at most SHORT_SQ queries at D 128)."""
    res = _launch("aule_flash_fwd", q, k, v, causal, scale, window_size,
                  rope_cos, rope_sin, return_lse, kv_len, False)
    flash_fwd_tma.launches += 1
    return res


def flash_fwd_short(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, window_size: int = -1,
                    rope_cos=None, rope_sin=None, return_lse: bool = True,
                    kv_len=None):
    """csrc/flash_fwd_short.cu's mma.sync kernel on CUDA bf16/f16 tensors
    at D=128 of any length (what `flash_attention_fwd` runs for 2 to
    SHORT_SQ queries)."""
    if q.shape[-1] != 128:
        raise ValueError(f"flash_fwd_short.cu takes D=128 (got "
                         f"D={q.shape[-1]})")
    res = _launch("aule_flash_fwd_short", q, k, v, causal, scale,
                  window_size, rope_cos, rope_sin, return_lse, kv_len, False)
    flash_fwd_short.launches += 1
    return res


def flash_fwd_decode(q, k, v, *, causal: bool = False,
                     scale: Optional[float] = None, window_size: int = -1,
                     rope_cos=None, rope_sin=None, return_lse: bool = True,
                     kv_len=None):
    """csrc/flash_fwd_short.cu's split-KV decode on CUDA bf16/f16 tensors
    at D=128 and one query (what `flash_attention_fwd` runs for them);
    `flash_decode_split_plain` is its plain version."""
    if q.shape[-1] != 128 or q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"the split-KV decode takes one query at D=128 "
                         f"(got q {tuple(q.shape)})")
    res = _launch("aule_flash_fwd_decode", q, k, v, causal, scale,
                  window_size, rope_cos, rope_sin, return_lse, kv_len, False)
    flash_fwd_decode.launches += 1
    return res


def flash_fwd_f32(q, k, v, *, causal: bool = False,
                  scale: Optional[float] = None, window_size: int = -1,
                  rope_cos=None, rope_sin=None, return_lse: bool = True,
                  kv_len=None):
    """csrc/flash_f32.cu's 3xTF32 tensor-core forward on CUDA f32 tensors
    at D 64, 128 or 256."""
    res = _launch("aule_flash_f32_fwd", q, k, v, causal, scale,
                  window_size, rope_cos, rope_sin, return_lse, kv_len, True)
    flash_fwd_f32.launches += 1
    return res


# kernel launches since the last reset (the CPU route counts none)
flash_fwd_tma.launches = 0
flash_fwd_short.launches = 0
flash_fwd_decode.launches = 0
flash_fwd_f32.launches = 0
rope_prepass.launches = 0


def flash_attention_rope(q, k, v, rope_cos, rope_sin, *,
                         causal: bool = False, scale: Optional[float] = None,
                         window_size: int = -1):
    """Inference fast path: RoPE fused inside the kernel, no rotated q or
    k in device memory.  Forward-only (flash.py:1658-1673); training goes
    through `flash_attention_cuda`, which rotates outside the op."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                               window_size=window_size, rope_cos=rope_cos,
                               rope_sin=rope_sin, return_lse=False)


def flash_attention_cuda(q, k, v, *, causal: bool = False,
                         scale: Optional[float] = None,
                         window_size: int = -1, rope_cos=None,
                         rope_sin=None):
    """The differentiable public route of the cuda backend (the counterpart
    of flash.py:1676-1689's flash_attention_pallas): the autograd Function
    of ops/flash_vjp.py, RoPE outside the op."""
    from .flash_vjp import flash_attention_vjp

    return flash_attention_vjp(q, k, v, causal, scale, window_size,
                               rope_cos, rope_sin)
