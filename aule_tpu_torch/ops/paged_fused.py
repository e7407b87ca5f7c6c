"""Fused-layout paged KV pool (counterpart of aule_tpu/ops/paged_fused.py).

The pool layout is kept byte for byte, so a pool that aule_tpu built feeds
the port unchanged:

    kv_pages:  [num_pages, 2, Hkv, page_size, Dpad]   (axis 1: 0=K, 1=V)
    kv_scales: [num_pages, page_size, 128]            (quantized pools)

with D padded to a multiple of 128 (`pad_head_dim`).  Quantized pools hold
int8 or float8_e4m3fn payloads (ops/quant.py) and one packed scale tile per
page, token-major: row = slot, lane = kv*64 + h, bf16 by default (f32
allowed).

  * `kv_cache_append_decode_fused` / `kv_cache_append_prefill_fused` write
    new tokens IN PLACE with `index_put_` (JAX rebuilds the pool
    functionally; in place saves a full pool copy per layer per step),
    quantizing on the way in when a scale pool is passed.  They return the
    same tensors, so call sites read like the JAX ones.
  * `paged_attention_fused` follows its tensors: CPU tensors take
    `paged_attention_fused_plain`; CUDA tensors launch a hand-written
    kernel (both replace the TPU kernel `_fused_decode_kernel` in every
    pool mode; see the source notes): csrc/paged_decode.cu's tensor-core
    kernel for bf16 / f16 at D = 64, 128 or 256, csrc/paged_generic.cu's
    FFMA decode for f32 at those head dims (ops/paged_generic.py), or
    raise for what neither takes.  A D = 64 q meets pools padded to 128
    lanes; the kernels read the first D lanes of each row and the softmax
    scale is 1 / sqrt(D) of the true D.
  * The chunked-prefill kernel over this pool is ops/paged_prefill.py;
    `paged_attention_prefill` resolves here too, at the JAX package's
    import path (loaded on first use: paged_prefill imports this module).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..config import DEFAULT_MASK_VALUE, int8_exact
from . import _build, decode_split
from .decode_split import DECODE_SPAN
from .flash import kernel_head_dim, pad_head, pads_head, unpad_head
from .paged_generic import FUSED, paged_generic_decode, uses_generic_kernels
from .quant import QUANT_DTYPES, dequantize_kv, quantize_kv
from .reference import (_expand_kv, _gather_pages,
                        paged_attention_reference)

NUM_LANES = 128

# half the scale-tile lanes hold K scales (lane = h), half V (lane = 64+h)
SCALE_KV_STRIDE = NUM_LANES // 2
SCALE_DTYPE = torch.bfloat16


def pad_head_dim(d: int) -> int:
    """Pools store head_dim padded to 128 lanes (zeros in the pad lanes
    are exact no-ops in both products)."""
    return -(-d // NUM_LANES) * NUM_LANES


def fused_pool_shape(num_pages: int, hkv: int, page_size: int,
                     head_dim: int):
    return (num_pages, 2, hkv, page_size, pad_head_dim(head_dim))


def scale_rows(hkv: int, page_size: int) -> int:
    """Rows of the packed scale tile: token-major, one row per slot."""
    del hkv
    return page_size


def fused_scales_shape(num_pages: int, hkv: int, page_size: int):
    """Packed scale-pool shape [P, page, 128] (Hkv <= 64)."""
    if hkv > SCALE_KV_STRIDE:
        raise ValueError(f"fused scale layout supports Hkv <= "
                         f"{SCALE_KV_STRIDE}, got {hkv}")
    return (num_pages, page_size, NUM_LANES)


def pack_fused_scales(k_scales: torch.Tensor, v_scales: torch.Tensor,
                      dtype=SCALE_DTYPE) -> torch.Tensor:
    """Head-major scales [Hkv, P, page] x2 -> packed [P, page, 128]
    (row = slot, lane = kv*64 + h, zeros in the unused lanes)."""
    hkv, num_pages, page_size = k_scales.shape
    fused_scales_shape(num_pages, hkv, page_size)  # validates hkv

    def part(s):
        return _pad_last(s.float().permute(1, 2, 0), SCALE_KV_STRIDE)

    return torch.cat([part(k_scales), part(v_scales)], dim=-1).to(dtype)


def unpack_fused_scales(packed: torch.Tensor, hkv: int):
    """Packed [P, page, 128] -> head-major f32 ([Hkv,P,page], [Hkv,P,page])."""

    def heads(lane0):
        return packed[..., lane0:lane0 + hkv].float().permute(2, 0, 1)

    return heads(0), heads(SCALE_KV_STRIDE)


def _pad_last(x: torch.Tensor, to: int) -> torch.Tensor:
    if x.shape[-1] == to:
        return x
    return F.pad(x, (0, to - x.shape[-1]))


def to_fused_layout(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    k_scales: Optional[torch.Tensor] = None,
                    v_scales: Optional[torch.Tensor] = None,
                    scale_dtype=SCALE_DTYPE):
    """[Hkv, P, page, D] x2 -> [P, 2, Hkv, page, Dpad], plus the packed
    scales when head-major scales [Hkv, P, page] are given."""
    kv = torch.stack([k_pages.transpose(0, 1), v_pages.transpose(0, 1)],
                     dim=1)
    kv = _pad_last(kv, pad_head_dim(kv.shape[-1])).contiguous()
    if k_scales is None:
        return kv
    return kv, pack_fused_scales(k_scales, v_scales, dtype=scale_dtype)


def from_fused_layout(kv_pages: torch.Tensor,
                      head_dim: Optional[int] = None):
    """[P, 2, Hkv, page, Dpad] -> (k_pages, v_pages) head-major
    [Hkv, P, page, D], sliced back to `head_dim` when given."""
    if head_dim is not None:
        kv_pages = kv_pages[..., :head_dim]
    return kv_pages[:, 0].transpose(0, 1), kv_pages[:, 1].transpose(0, 1)


def _pool_index(kv_pages, phys, slot):
    """index_put_ indices writing [N, 2, Hkv, Dpad] rows at (phys, slot)."""
    hkv = kv_pages.shape[2]
    dev = kv_pages.device
    kv_i = torch.arange(2, device=dev)[None, :, None]
    h_i = torch.arange(hkv, device=dev)[None, None, :]
    return (phys[:, None, None], kv_i, h_i, slot[:, None, None])


def _scale_index(hkv: int, phys, slot):
    """index_put_ indices writing [N, 2, Hkv] scales at (phys, slot) into
    the packed tile (row = slot, lane = kv*64 + h)."""
    dev = phys.device
    lanes = (torch.arange(2, device=dev)[:, None] * SCALE_KV_STRIDE
             + torch.arange(hkv, device=dev)[None, :])
    return (phys[:, None, None], slot[:, None, None], lanes[None])


def _write(kv_pages, kv_scales, new, phys, slot):
    """Write rows new [N, 2, Hkv, Dpad] at (phys, slot), quantized with
    their scales when a scale pool is given."""
    if kv_scales is None:
        kv_pages.index_put_(_pool_index(kv_pages, phys, slot),
                            new.to(kv_pages.dtype))
        return
    if kv_pages.dtype not in QUANT_DTYPES:
        raise ValueError(f"kv_scales given for a {kv_pages.dtype} pool: "
                         f"quantized pools hold int8 or float8_e4m3fn")
    payload, sc = quantize_kv(new, kv_pages.dtype)   # sc [N, 2, Hkv]
    kv_pages.index_put_(_pool_index(kv_pages, phys, slot), payload)
    kv_scales.index_put_(_scale_index(kv_pages.shape[2], phys, slot),
                         sc.to(kv_scales.dtype))


def kv_cache_append_decode_fused(
    kv_pages: torch.Tensor,      # [P, 2, Hkv, page, Dpad]
    k_new: torch.Tensor,         # [B, Hkv, D]
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages]
    context_lens: torch.Tensor,  # [B] length BEFORE the append
    kv_scales: Optional[torch.Tensor] = None,  # packed [P, page, 128]
):
    """Write one token per sequence at position context_lens[b], in place.
    Returns (kv_pages, context_lens + 1), or (kv_pages, kv_scales,
    context_lens + 1) for a quantized pool.  A -1 table entry clamps to
    the scratch page 0; a logical page past the table clamps to its last
    column, as JAX's gather does."""
    page_size = kv_pages.shape[3]
    batch = k_new.shape[0]
    lens = context_lens.to(kv_pages.device).long()
    slot = lens % page_size
    logical = (lens // page_size).clamp(max=block_tables.shape[1] - 1)
    rows = torch.arange(batch, device=kv_pages.device)
    phys = block_tables.to(kv_pages.device)[rows, logical].long().clamp_min(0)
    new = _pad_last(torch.stack([k_new, v_new], dim=1), kv_pages.shape[-1])
    _write(kv_pages, kv_scales, new, phys, slot)
    if kv_scales is not None:
        return kv_pages, kv_scales, context_lens + 1
    return kv_pages, context_lens + 1


def kv_cache_append_prefill_fused(
    kv_pages: torch.Tensor,      # [P, 2, Hkv, page, Dpad]
    k_new: torch.Tensor,         # [B, Hkv, S, D]
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages]
    context_lens: torch.Tensor,  # [B] tokens already in the pool
    seq_lens: torch.Tensor,      # [B] valid tokens of the S
    kv_scales: Optional[torch.Tensor] = None,  # packed [P, page, 128]
):
    """Write tokens s < seq_lens[b] at positions context_lens[b] + s, in
    place, quantized with their scales when a scale pool is given; padding
    tokens (s >= seq_lens[b]) leave the pools as they were (the masked
    write of aule_tpu/ops/paged.py:525-544).  Returns (kv_pages,
    context_lens + seq_lens), or (kv_pages, kv_scales, context_lens +
    seq_lens) for a quantized pool."""
    batch, hkv, seq, d = k_new.shape
    page_size = kv_pages.shape[3]
    dev = kv_pages.device
    ar = torch.arange(seq, device=dev)
    pos = context_lens.to(dev).long()[:, None] + ar[None, :]     # [B, S]
    valid = ar[None, :] < seq_lens.to(dev).long()[:, None]
    # padded positions may run past the table: clamp like JAX's gather
    logical = (pos // page_size).clamp(max=block_tables.shape[1] - 1)
    phys = torch.gather(block_tables.to(dev).long(), 1, logical).clamp_min(0)
    # [B, 2, Hkv, S, D] -> [B*S, 2, Hkv, Dpad]
    new = torch.stack([k_new, v_new], dim=1).movedim(3, 1).reshape(
        batch * seq, 2, hkv, d)
    keep = valid.reshape(-1)
    new = _pad_last(new[keep], kv_pages.shape[-1])
    _write(kv_pages, kv_scales, new, phys.reshape(-1)[keep],
           (pos % page_size).reshape(-1)[keep])
    if kv_scales is not None:
        return kv_pages, kv_scales, context_lens + seq_lens
    return kv_pages, context_lens + seq_lens


def dequantize_pool(kv_pages: torch.Tensor, kv_scales: torch.Tensor,
                    head_dim: Optional[int] = None):
    """Quantized fused pool -> head-major f32 (k_pages, v_pages)
    [Hkv, P, page, D]: payload times its token's scale."""
    k_pages, v_pages = from_fused_layout(kv_pages, head_dim)
    ks, vs = unpack_fused_scales(kv_scales, kv_pages.shape[2])
    return dequantize_kv(k_pages, ks), dequantize_kv(v_pages, vs)


def _int8_dot_plain(q, kv_pages, kv_scales, block_tables, context_lens,
                    scale, window, return_lse, nsplit=1):
    """The int8 dot-product decode in plain PyTorch, with the kernel's
    arithmetic: q quantized per row; s = (q_i8 . k_i8) * qf * k scale,
    an exact integer sum (|sum| < 2^24, so exact in f32 too); p * v scale
    quantized per row to int8 over spans of DECODE_SPAN tokens counted from
    the first visible token (the JAX kernel's span is ppcb * page tokens);
    each code times its span's max / 127 weighs its V row (the kernel
    rounds that weight to f16 for its tensor-core product, 2^-11 relative;
    here it stays f32).  With nsplit > 1, per split range and merged as the
    kernel does (ops/decode_split.py): the ranges start on span
    boundaries, so the spans are the same."""
    batch, hq, d_true = q.shape
    hkv = kv_pages.shape[2]
    q_i8, qscale = quantize_kv(_pad_last(q, kv_pages.shape[-1]), torch.int8)
    qf = qscale * scale                                       # [B, Hq]
    k_i8 = _expand_kv(_gather_pages(kv_pages[:, 0].transpose(0, 1),
                                    block_tables).float(), hq)
    v_i8 = _expand_kv(_gather_pages(kv_pages[:, 1].transpose(0, 1),
                                    block_tables).float(), hq)
    ks, vs = unpack_fused_scales(kv_scales, hkv)              # [Hkv, P, pg]
    kf = _expand_kv(_gather_pages(ks[..., None], block_tables)[..., 0], hq)
    vf = _expand_kv(_gather_pages(vs[..., None], block_tables)[..., 0], hq)
    s = torch.einsum("bhd,bhkd->bhk", q_i8.float(), k_i8) * qf[..., None]
    s = s * kf
    seq_k = s.shape[-1]
    pos = torch.arange(seq_k, device=q.device)[None, None, :]
    lens = context_lens.long().to(q.device)[:, None, None]
    valid = pos < lens
    t_lo = torch.zeros_like(lens)
    if window > 0:
        valid = valid & ((lens - 1 - pos) < window)
        t_lo = (lens - window).clamp_min(0)

    def span_pv(p):
        p3 = p * vf
        span = ((pos - t_lo).clamp_min(0) // DECODE_SPAN).expand_as(p3)
        n_spans = seq_k // DECODE_SPAN + 2
        pm = torch.zeros(p3.shape[:-1] + (n_spans,), dtype=p3.dtype,
                         device=p3.device).scatter_reduce(
                             -1, span, p3, reduce="amax")
        pm_tok = pm.gather(-1, span)
        r = torch.where(pm_tok > 0.0, 127.0 / pm_tok,
                        torch.zeros_like(pm_tok))
        p_i8 = torch.floor(p3 * r + 0.5)
        w = p_i8 * (pm_tok * (1.0 / 127.0))
        return torch.einsum("bhk,bhkd->bhd", w, v_i8)

    if nsplit > 1:
        lo, hi = decode_split.split_bounds(context_lens.to(q.device), seq_k,
                                           window, nsplit)
        out, lse = decode_split.split_merge(
            s, valid, lo, hi, lambda p, keep: (p.sum(-1), span_pv(p)))
        out = out[..., :d_true].to(q.dtype)
        return (out, lse) if return_lse else out
    s = torch.where(valid, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    pv = span_pv(p)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.where(l > 0.0, pv / l_safe, torch.zeros_like(pv))
    out = out[..., :d_true].to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0.0, m + torch.log(l_safe),
                      torch.full_like(l, DEFAULT_MASK_VALUE))[..., 0]
    return out, lse


def paged_attention_fused_plain(q, kv_pages, block_tables, context_lens, *,
                                kv_scales: Optional[torch.Tensor] = None,
                                scale: Optional[float] = None,
                                window_size: int = -1,
                                int8_matmul: Optional[bool] = None,
                                return_lse: bool = False, nsplit: int = 1):
    """The plain PyTorch version of the kernel.  16-bit and f32 pools,
    int8 pools with int8_matmul=False and e4m3 pools: gather the pages
    (dequantized: payload times scale, which equals the kernel's folding
    of the scales into s and p up to f32 rounding) and run the f32 paged
    oracle.  int8 pools with int8_matmul (default: as the wrapper's):
    `_int8_dot_plain`.  nsplit > 1 evaluates the kernel's split ranges
    one by one and merges them as it does (ops/decode_split.py)."""
    d_true = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d_true)
    window = int(window_size) if window_size and window_size > 0 else -1
    if int8_matmul is None:
        int8_matmul = not int8_exact()
    if kv_scales is not None and kv_pages.dtype == torch.int8 \
            and int8_matmul:
        return _int8_dot_plain(q, kv_pages, kv_scales, block_tables,
                               context_lens, scale, window, return_lse,
                               nsplit)
    if kv_scales is not None:
        k_pages, v_pages = dequantize_pool(kv_pages, kv_scales, d_true)
    else:
        k_pages, v_pages = from_fused_layout(kv_pages, d_true)
    if nsplit > 1:
        return decode_split.paged_decode_split_plain(
            q, k_pages, v_pages, block_tables, context_lens, scale=scale,
            window=window, nsplit=nsplit, return_lse=return_lse)
    return paged_attention_reference(
        q, k_pages, v_pages, block_tables, context_lens, scale=scale,
        window_size=window, return_lse=return_lse)


def check_pool(q, kv_pages, kv_scales):
    """Shape and dtype checks shared by the decode and prefill wrappers."""
    d_true = q.shape[-1]
    num_pages, two, hkv, page_size, d = kv_pages.shape
    if two != 2 or d != pad_head_dim(d_true):
        raise ValueError(
            f"kv_pages {tuple(kv_pages.shape)} is not a fused pool for "
            f"head_dim {d_true} (see fused_pool_shape)")
    if q.shape[1] % hkv:
        raise ValueError(f"Hq={q.shape[1]} is not a multiple of Hkv={hkv}")
    if kv_scales is None:
        if not kv_pages.is_floating_point() \
                or kv_pages.dtype in QUANT_DTYPES:
            raise ValueError(
                f"{kv_pages.dtype} KV pools need kv_scales (attention over "
                f"raw codes is meaningless); see ops/quant.quantize_kv")
        return
    if kv_pages.dtype not in QUANT_DTYPES:
        raise ValueError(f"kv_scales given for a {kv_pages.dtype} pool: "
                         f"quantized pools hold int8 or float8_e4m3fn")
    want = (num_pages, scale_rows(hkv, page_size), NUM_LANES)
    if tuple(kv_scales.shape) != want:
        raise ValueError(f"kv_scales must be packed {want} (see "
                         f"pack_fused_scales), got {tuple(kv_scales.shape)}")


def check_kernel_inputs(q, pools, name: str,
                        rule=uses_generic_kernels) -> bool:
    """What the CUDA paged kernels take, at any GQA group: f32, bf16 or
    f16 q at D 64/128/256; `pools` (the pool and scale tensors; None
    entries are skipped) contiguous, 16-byte aligned, on q's device.
    Returns `rule(q)`: whether q goes to the generic kernels
    (csrc/paged_generic.cu; the decode's rule by default, the prefill's is
    ops/paged_generic.py `prefill_uses_generic`)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    generic = rule(q)
    for t in pools:
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name}: q and the pools must share a device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: pools must be contiguous and 16-byte "
                             f"aligned")
    return generic


def paged_attention_fused(
    q: torch.Tensor,              # [B, Hq, D]
    kv_pages: torch.Tensor,       # [P, 2, Hkv, page, Dpad]
    block_tables: torch.Tensor,   # [B, max_pages] int32, -1 = unused
    context_lens: torch.Tensor,   # [B] int32
    *,
    kv_scales: Optional[torch.Tensor] = None,   # packed [P, page, 128]
    scale: Optional[float] = None,
    window_size: int = -1,
    int8_matmul: Optional[bool] = None,
    return_lse: bool = False,
):
    """Decode attention of one query token per sequence over the fused
    pool.  Returns out [B, Hq, D] and, with return_lse, the natural-log LSE
    [B, Hq] f32.  Unquantized pools take q in the pool's dtype (as JAX);
    quantized pools (kv_scales given) keep q's dtype, and int8 pools run
    the int8 dot-product path unless int8_matmul=False (default: the
    AULE_TPU_INT8_EXACT setting, config.int8_exact)."""
    batch, hq, d = q.shape
    _, _, hkv, page_size, _ = kv_pages.shape
    check_pool(q, kv_pages, kv_scales)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    window = int(window_size) if window_size and window_size > 0 else -1
    if int8_matmul is None:
        int8_matmul = not int8_exact()
    if pads_head(q):
        # the kernels at the width above d, reading that many lanes of the
        # pool's rows (zeros past d: the appends pad them)
        res = paged_attention_fused(
            pad_head(q, kernel_head_dim(d)), kv_pages, block_tables,
            context_lens, kv_scales=kv_scales, scale=scale,
            window_size=window, int8_matmul=int8_matmul,
            return_lse=return_lse)
        return unpad_head(res, d, return_lse)
    int8_dot = (kv_scales is not None and kv_pages.dtype == torch.int8
                and bool(int8_matmul))
    if kv_scales is None:
        q = q.to(kv_pages.dtype)  # as JAX: q joins the pool dtype
    if q.device.type == "cpu":
        return paged_attention_fused_plain(
            q, kv_pages, block_tables, context_lens, kv_scales=kv_scales,
            scale=scale, window_size=window, int8_matmul=int8_dot,
            return_lse=return_lse)
    generic = check_kernel_inputs(q, (kv_pages, kv_scales), "paged-decode")
    q = q.contiguous()
    q_in, qf, pool, sc_f32 = q, None, _build.POOL_NATIVE, 0
    if kv_scales is not None:
        pool = _build.pool_code(kv_pages.dtype)
        sc_f32 = _build.scale_code(kv_scales.dtype)
    if int8_dot:
        # per-row int8 q and its factor, host side of the kernel as in
        # paged_fused.py:549-560 (f32 q too)
        q_in, qscale = quantize_kv(q, torch.int8)
        qf = (qscale * scale).contiguous()
        pool = _build.POOL_INT8_DOT
    if generic:
        return paged_generic_decode(
            q, q_in, qf, kv_pages, None, kv_scales, None, block_tables,
            context_lens, num_pages=kv_pages.shape[0], page_size=page_size,
            scale=scale, window=window, pool=pool, sc_f32=sc_f32,
            layout=FUSED, return_lse=return_lse)
    code = _build.dtype_code(q.dtype)
    lib = _build.library()
    dev = q.device
    max_pages = block_tables.shape[1]
    rows = decode_split.tc_tile_rows(hq // hkv)
    nsplit, ws, cnt = decode_split.launch_plan(
        batch, hq, hkv, max_pages * page_size, window, dev, head_dim=d,
        tile_rows=rows, blocks_per_sm=decode_split.tc_blocks_per_sm(d))
    bt = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    lens = context_lens.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((batch, hq), dtype=torch.float32, device=dev)
           if return_lse else None)
    err = lib.aule_paged_decode(
        q_in.data_ptr(), qf.data_ptr() if qf is not None else None,
        kv_pages.data_ptr(),
        kv_scales.data_ptr() if kv_scales is not None else None,
        bt.data_ptr(), lens.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        ws.data_ptr() if ws is not None else None,
        cnt.data_ptr() if cnt is not None else None,
        batch, hq, hkv, d, page_size, max_pages, float(scale), window,
        nsplit, rows, code, pool, sc_f32, _build.stream_handle(dev))
    _build.check(err, "aule_paged_decode")
    paged_attention_fused.launches += 1
    return (out, lse) if return_lse else out


# kernel launches since the last reset (the CPU route does not count)
paged_attention_fused.launches = 0


def __getattr__(name):
    if name == "paged_attention_prefill":
        from .paged_prefill import paged_attention_prefill
        return paged_attention_prefill
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
