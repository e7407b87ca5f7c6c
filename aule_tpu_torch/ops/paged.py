"""Split-layout paged KV pools (counterpart of aule_tpu/ops/paged.py).

The JAX package's vLLM-style head-major layout, kept byte for byte, so a
pool that aule_tpu built feeds the port unchanged:

    q:            [B, Hq, D]          one query token per sequence
    k/v_pages:    [Hkv, num_pages, page_size, D]
    k/v_scales:   [Hkv, num_pages, page_size] f32   (int8 / e4m3 pools)
    block_tables: [B, max_pages]      int32, -1 = unused
    context_lens: [B]                 int32

  * The four appends write new tokens IN PLACE with `index_put_` (JAX
    rebuilds the pools functionally) and return JAX's tuples; payloads and
    scales are bytewise equal to JAX's.  The prefill appends leave the
    pools as they were for tokens s >= seq_lens[b] (JAX's masked
    read-modify-write, paged.py:537-544).
  * `paged_attention` follows its tensors: CPU tensors take
    `paged_attention_plain`; CUDA tensors launch a hand-written kernel
    that replaces the TPU kernel `_paged_decode_kernel` (see the source
    notes): csrc/paged_decode.cu's `SplitPools` instantiation for bf16 /
    f16 at D = 64, 128 or 256, csrc/paged_generic.cu's decode (its
    `SplitLayout`) for f32 at those head dims.  Any other D up to 256
    runs at the kernel width above it with q and both pools zero-padded on
    every call (`pad_split_pools`: a copy of the pools per call, as JAX's
    route pads them, paged.py:366-374); larger D raise.  Quantized pools
    are read in place,
    their f32 scales folded into the scores and p: the JAX package's TPU
    route converts them to the fused layout on every call
    (paged.py:317-337), a copy of the whole pool per layer per step that
    the port does not make.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build, decode_split
from .flash import kernel_head_dim, pad_head, pads_head, unpad_head
from .paged_fused import check_kernel_inputs
from .paged_generic import SPLIT, paged_generic_decode
from .quant import QUANT_DTYPES, dequantize_kv, quantize_kv
from .reference import paged_attention_reference


def _rows(pool, phys, slot):
    """index_put_ indices of the rows (phys[n], slot[n]) of every kv head
    of a [Hkv, P, page, ...] pool: values are [Hkv, N, ...]."""
    heads = torch.arange(pool.shape[0], device=pool.device)[:, None]
    return heads, phys[None, :], slot[None, :]


def _decode_rows(k_pages, block_tables, context_lens):
    """Rows of the token at position context_lens[b] of each sequence.  A
    -1 table entry clamps to the scratch page 0; a logical page past the
    table clamps to its last column, as JAX's gather does."""
    page_size = k_pages.shape[2]
    dev = k_pages.device
    lens = context_lens.to(dev).long()
    logical = (lens // page_size).clamp(max=block_tables.shape[1] - 1)
    batch = torch.arange(lens.shape[0], device=dev)
    phys = block_tables.to(dev)[batch, logical].long().clamp_min(0)
    return _rows(k_pages, phys, lens % page_size)


def kv_cache_append_decode(k_pages, v_pages, k_new, v_new, block_tables,
                           context_lens):
    """Write one token per sequence (k_new, v_new [B, Hkv, D]) at position
    context_lens[b], in place.  Returns (k_pages, v_pages,
    context_lens + 1)."""
    rows = _decode_rows(k_pages, block_tables, context_lens)
    k_pages.index_put_(rows, k_new.transpose(0, 1).to(k_pages.dtype))
    v_pages.index_put_(rows, v_new.transpose(0, 1).to(v_pages.dtype))
    return k_pages, v_pages, context_lens + 1


def kv_cache_append_decode_quantized(k_pages, v_pages, k_scales, v_scales,
                                     k_new, v_new, block_tables,
                                     context_lens):
    """kv_cache_append_decode into int8 / e4m3 pools: each new row is
    quantized per token (ops/quant.quantize_kv) and its f32 scale written
    beside it.  Returns (k_pages, v_pages, k_scales, v_scales,
    context_lens + 1)."""
    rows = _decode_rows(k_pages, block_tables, context_lens)
    for pages, scales, new in ((k_pages, k_scales, k_new),
                               (v_pages, v_scales, v_new)):
        payload, sc = quantize_kv(new, pages.dtype)      # [B,Hkv,D], [B,Hkv]
        pages.index_put_(rows, payload.transpose(0, 1))
        scales.index_put_(rows, sc.transpose(0, 1).to(scales.dtype))
    return k_pages, v_pages, k_scales, v_scales, context_lens + 1


def _prefill_rows(k_pages, block_tables, context_lens, seq_lens, seq):
    """(rows of the valid tokens s < seq_lens[b] at positions
    context_lens[b] + s, their mask over the B*S tokens).  A logical page
    past the table gives page 0, as JAX's take_along_axis does (it fills
    INT_MIN, which clamps to 0)."""
    page_size = k_pages.shape[2]
    dev = k_pages.device
    ar = torch.arange(seq, device=dev)
    pos = context_lens.to(dev).long()[:, None] + ar[None, :]      # [B, S]
    keep = (ar[None, :] < seq_lens.to(dev).long()[:, None]).reshape(-1)
    logical = pos // page_size
    max_pages = block_tables.shape[1]
    phys = torch.gather(block_tables.to(dev).long(), 1,
                        logical.clamp(max=max_pages - 1))
    phys = torch.where(logical < max_pages, phys, 0).clamp_min(0)
    rows = _rows(k_pages, phys.reshape(-1)[keep],
                 (pos % page_size).reshape(-1)[keep])
    return rows, keep


def _tokens(x, keep):
    """[B, Hkv, S, ...] -> [Hkv, N, ...]: the kept tokens, head-major."""
    x = x.transpose(0, 1)
    return x.reshape((x.shape[0], -1) + tuple(x.shape[3:]))[:, keep]


def kv_cache_append_prefill(k_pages, v_pages, k_new, v_new, block_tables,
                            context_lens, seq_lens):
    """Write tokens s < seq_lens[b] of k_new, v_new [B, Hkv, S, D] at
    positions context_lens[b] + s, in place; padding tokens leave the pools
    as they were.  Returns (k_pages, v_pages, context_lens + seq_lens)."""
    rows, keep = _prefill_rows(k_pages, block_tables, context_lens,
                               seq_lens, k_new.shape[2])
    k_pages.index_put_(rows, _tokens(k_new, keep).to(k_pages.dtype))
    v_pages.index_put_(rows, _tokens(v_new, keep).to(v_pages.dtype))
    return k_pages, v_pages, context_lens + seq_lens


def kv_cache_append_prefill_quantized(k_pages, v_pages, k_scales, v_scales,
                                      k_new, v_new, block_tables,
                                      context_lens, seq_lens):
    """kv_cache_append_prefill into int8 / e4m3 pools, quantized per token
    with f32 scales.  Returns (k_pages, v_pages, k_scales, v_scales,
    context_lens + seq_lens)."""
    rows, keep = _prefill_rows(k_pages, block_tables, context_lens,
                               seq_lens, k_new.shape[2])
    for pages, scales, new in ((k_pages, k_scales, k_new),
                               (v_pages, v_scales, v_new)):
        payload, sc = quantize_kv(new, pages.dtype)   # [B,Hkv,S,D], [B,Hkv,S]
        pages.index_put_(rows, _tokens(payload, keep))
        scales.index_put_(rows, _tokens(sc, keep).to(scales.dtype))
    return k_pages, v_pages, k_scales, v_scales, context_lens + seq_lens


def paged_attention_plain(q, k_pages, v_pages, block_tables, context_lens,
                          *, k_scales: Optional[torch.Tensor] = None,
                          v_scales: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          window_size: int = -1, return_lse: bool = False,
                          nsplit: int = 1):
    """The plain PyTorch version of the kernel: the pools dequantized
    (payload times its token's f32 scale, which equals the kernel's folding
    of the scales into s and p up to f32 rounding) when scales are given,
    then the f32 paged oracle (ops/reference.py); with nsplit > 1, over the
    kernel's split ranges one by one, merged as it does
    (ops/decode_split.py)."""
    if k_scales is not None:
        k_pages = dequantize_kv(k_pages, k_scales)
        v_pages = dequantize_kv(v_pages, v_scales)
    if nsplit > 1:
        return decode_split.paged_decode_split_plain(
            q, k_pages, v_pages, block_tables, context_lens, scale=scale,
            window=window_size, nsplit=nsplit, return_lse=return_lse)
    return paged_attention_reference(
        q, k_pages, v_pages, block_tables, context_lens, scale=scale,
        window_size=window_size, return_lse=return_lse)


def check_pools(q, k_pages, v_pages, k_scales, v_scales):
    """Shape and dtype checks of split pools (raise ValueError)."""
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or k_pages.dtype != v_pages.dtype:
        raise ValueError(f"k_pages {tuple(k_pages.shape)} {k_pages.dtype} "
                         f"and v_pages {tuple(v_pages.shape)} "
                         f"{v_pages.dtype} must be one [Hkv, P, page, D] "
                         f"shape and dtype")
    hkv, num_pages, page_size, d = k_pages.shape
    if d != q.shape[-1] or q.shape[1] % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools of Hkv="
                         f"{hkv}, D={d}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    if k_scales is None:
        if not k_pages.is_floating_point() or k_pages.dtype in QUANT_DTYPES:
            raise ValueError(
                f"{k_pages.dtype} KV pools need k_scales/v_scales (attention "
                f"over raw codes is meaningless); see ops/quant.quantize_kv")
        return
    if k_pages.dtype not in QUANT_DTYPES:
        raise ValueError(f"scales given for a {k_pages.dtype} pool: "
                         f"quantized pools hold int8 or float8_e4m3fn")
    for s in (k_scales, v_scales):
        if tuple(s.shape) != (hkv, num_pages, page_size) \
                or s.dtype != torch.float32:
            raise ValueError(f"scales must be f32 [{hkv}, {num_pages}, "
                             f"{page_size}], got {s.dtype} "
                             f"{tuple(s.shape)}")


def pad_split_pools(k_pages, v_pages, width: int):
    """Split pools [Hkv, P, page, D] zero-padded to `width` lanes: new
    tensors (a copy of both pools), the per-call cost of a head dim the
    kernels do not take in the split layout.  Zero codes dequantize to
    zero, so quantized pools keep their scales."""
    return pad_head(k_pages, width), pad_head(v_pages, width)


def paged_attention(
    q: torch.Tensor,              # [B, Hq, D]
    k_pages: torch.Tensor,        # [Hkv, P, page, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,   # [B, max_pages] int32, -1 = unused
    context_lens: torch.Tensor,   # [B] int32
    *,
    k_scales: Optional[torch.Tensor] = None,   # [Hkv, P, page] f32
    v_scales: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window_size: int = -1,
    return_lse: bool = False,
):
    """Paged decode attention (one query token per sequence) over split
    pools: only the first context_lens[b] tokens are visible, with a
    window only the trailing `window_size` ((len - 1 - pos) < W).  Returns
    out [B, Hq, D] and, with return_lse, the natural-log LSE [B, Hq] f32
    (a sequence with context 0 gives zeros and -0.7 * f32max).
    Unquantized pools take q in the pool's dtype (as JAX); quantized pools
    (int8 or e4m3 with k_scales/v_scales) keep q's dtype.  JAX's TPU knobs
    (pages_per_compute_block, interpret, AULE_DECODE_XBATCH) have no
    counterpart."""
    batch, hq, d = q.shape
    hkv, num_pages, page_size, _ = k_pages.shape
    check_pools(q, k_pages, v_pages, k_scales, v_scales)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    window = int(window_size) if window_size and window_size > 0 else -1
    if k_scales is None:
        q = q.to(k_pages.dtype)  # as JAX: q joins the pool dtype
    if pads_head(q):
        # q and both pools zero-padded to the kernel width above D on every
        # call, as JAX's route pads them (paged.py:366-374): a copy of the
        # pools per call (`pad_split_pools`), the output sliced back
        width = kernel_head_dim(d)
        kp, vp = pad_split_pools(k_pages, v_pages, width)
        res = paged_attention(pad_head(q, width), kp, vp, block_tables,
                              context_lens, k_scales=k_scales,
                              v_scales=v_scales, scale=scale,
                              window_size=window, return_lse=return_lse)
        return unpad_head(res, d, return_lse)
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pages, v_pages, block_tables, context_lens,
            k_scales=k_scales, v_scales=v_scales, scale=scale,
            window_size=window, return_lse=return_lse)
    generic = check_kernel_inputs(q, (k_pages, v_pages, k_scales, v_scales),
                                  "split paged-decode")
    q = q.contiguous()
    pool = (_build.POOL_NATIVE if k_scales is None
            else _build.pool_code(k_pages.dtype))
    if generic:
        return paged_generic_decode(
            q, q, None, k_pages, v_pages, k_scales, v_scales, block_tables,
            context_lens, num_pages=num_pages, page_size=page_size,
            scale=scale, window=window, pool=pool, sc_f32=1, layout=SPLIT,
            return_lse=return_lse)
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
    err = lib.aule_paged_decode_split(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        None if k_scales is None else k_scales.data_ptr(),
        None if v_scales is None else v_scales.data_ptr(),
        bt.data_ptr(), lens.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if cnt is None else cnt.data_ptr(), batch, hq, hkv, d,
        num_pages, page_size, max_pages, float(scale), window, nsplit, rows,
        code, pool, _build.stream_handle(dev))
    _build.check(err, "aule_paged_decode_split")
    paged_attention.launches += 1
    return (out, lse) if return_lse else out


# kernel launches since the last reset (the CPU route does not count)
paged_attention.launches = 0
