"""Split-KV (flash-decoding) partition of the paged decode kernels
(csrc/paged_decode.cu, and csrc/paged_generic.cu's decode, which shares
it) and of the one-query flash decode (csrc/flash_fwd_short.cu
`flash_fwd_decode_kernel`, over contiguous K/V: t_lo = 0 and the capacity
the padded Sk), and its plain counterpart.

The kernel spreads the live tokens [t_lo, len) of one (sequence, kv head)
over `nsplit` blocks.  The wrapper picks `nsplit` here from the shapes and
the card's SM count only (`num_splits`), so it never reads context_lens on
the host; each block derives its own range on the device exactly as
`split_bounds` does:

    chunk = ceil((len - t_lo) / nsplit) rounded up to DECODE_SPAN
    split s covers [t_lo + s * chunk, min(len, t_lo + (s + 1) * chunk))

so every range starts at t_lo plus a multiple of DECODE_SPAN and no span
of the int8 dot-product mode straddles two.  Each block leaves (m, l, acc)
of its range; `split_merge` is the plain version of the partition and the
merge, in split order, over any per-range partial sums.

A block of a decode kernel takes `tile_rows` q rows of its GQA group
(`tc_tile_rows` for the tensor-core decode, `generic_tile_rows` for the
generic one, FLASH_TILE_ROWS for the flash decode): a larger group is cut
into `row_tiles` row tiles, each nsplit blocks of its own per (sequence,
kv head); `num_splits` counts them among the blocks of a wave.  The rule
lives here only: the wrappers pass the tile's rows to the kernels, which
size their grid by it and refuse a tile they have no instantiation for,
and `launch_plan` sizes the merge counters by the same number.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from ..config import DEFAULT_MASK_VALUE
from .reference import _expand_kv, _gather_pages

# the int8 dot-product decode quantizes p per row over spans of this many
# consecutive tokens counted from the first visible token (the kernel's
# half-warp step, TPW)
DECODE_SPAN = 4
# blocks of a decode kernel resident on one SM at a time (its launch
# bounds' minimum: registers and shared memory allow 3 in every pool mode;
# both decodes at D 256 allow 1, `tc_blocks_per_sm`,
# `generic_blocks_per_sm`)
BLOCKS_PER_SM = 3
# fewest tokens of the table's capacity (or window) per split
MIN_SPLIT_TOKENS = 256
MAX_SPLITS = 64
# the q rows one block of a decode kernel takes at most: the tensor-core
# kernel's live mma rows (csrc/paged_decode.cu), the generic kernel's tile
# (csrc/paged_generic.cuh kMaxGroup)
TC_TILE_ROWS = 8
GENERIC_TILE_ROWS = 8
# the groups the tensor-core decode has an instantiation of its own for
TC_EXACT_GROUPS = (1, 2, 4, 8)
# the one-query flash decode's q rows a block, at every group (its mma
# rows g; rows past the group masked)
FLASH_TILE_ROWS = 8


def tc_tile_rows(group: int) -> int:
    """The tensor-core decode's q rows a block: a group of 1, 2, 4 or 8
    whole, any other in tiles of TC_TILE_ROWS rows, the rows past the
    group masked."""
    return group if group in TC_EXACT_GROUPS else TC_TILE_ROWS


def generic_tile_rows(group: int) -> int:
    """The generic decode's q rows a block: the group up to a power of
    two, at most GENERIC_TILE_ROWS."""
    rows = 1
    while rows < min(group, GENERIC_TILE_ROWS):
        rows *= 2
    return rows


def tc_blocks_per_sm(head_dim: int) -> int:
    """The tensor-core decode's blocks resident on an SM at head dim
    `head_dim` (csrc/paged_decode.cuh min_blocks): 3 at D 64 and 128, 1 at
    D 256, whose ring of 132 KB and O fragment of 64 registers a thread
    leave room for one."""
    return 1 if head_dim > 128 else BLOCKS_PER_SM


def generic_blocks_per_sm(head_dim: int, quantized: bool) -> int:
    """The blocks an SM of the generic decode's wave at head dim
    `head_dim`: over 1-byte pools at D 64 and 128 the 3 blocks of 4 warps
    that an SM holds (csrc/paged_generic.cuh Geo<D>::BPS: their rings take
    a third of its shared memory each), since their short ranges wait on
    round trips more than on bytes; over f32 pools 1, since those stream
    at the card's rate and the merge of more splits cost more than it
    saved (on an H100, GPT-2's decode at B8 ctx1024 took 19.0 us in one
    split against 21.9 in four, the f32 Llama layer's 101.1 in two against
    111.8 in six: scripts/torch_generic_decode_sweep.py, PERF.md §6); at D
    256 1, the block of 8 warps an SM holds."""
    return BLOCKS_PER_SM if quantized and head_dim <= 128 else 1


def row_tiles(group: int, rows: int) -> int:
    """The row tiles of a GQA group of `group` q rows, `rows` a block."""
    return -(-group // rows)


def num_splits(batch: int, hkv: int, capacity: int, window: int,
               sm_count: int, tiles: int = 1,
               blocks_per_sm: int = BLOCKS_PER_SM) -> int:
    """Blocks per (sequence, kv head, row tile): as many as fit the card at
    once in one wave (`blocks_per_sm` on each of `sm_count` SMs; a second,
    partial wave would cost a whole block's time), at most one per
    MIN_SPLIT_TOKENS tokens of the table's capacity (max_pages *
    page_size, or the window when it is smaller), at most MAX_SPLITS.
    Depends on the shapes only."""
    span = min(window, capacity) if window > 0 else capacity
    pairs = max(1, batch * hkv * tiles)
    fit = blocks_per_sm * sm_count // pairs
    most = -(-max(1, span) // MIN_SPLIT_TOKENS)
    return max(1, min(fit, most, MAX_SPLITS))


def split_bounds(context_lens: torch.Tensor, capacity: int, window: int,
                 nsplit: int):
    """(lo, hi) [B, nsplit] int64: split s of sequence b covers the tokens
    lo <= pos < hi (empty where lo >= hi), as the kernel computes them."""
    lens = context_lens.long().clamp(0, capacity)
    t_lo = (lens - window).clamp_min(0) if window > 0 \
        else torch.zeros_like(lens)
    per = -(-(lens - t_lo) // nsplit)
    chunk = -(-per // DECODE_SPAN) * DECODE_SPAN
    s = torch.arange(nsplit, device=lens.device)
    lo = t_lo[:, None] + s[None, :] * chunk[:, None]
    hi = torch.minimum(lens[:, None], lo + chunk[:, None])
    return lo, hi


def split_merge(scores: torch.Tensor, valid: torch.Tensor, lo, hi,
                partial: Callable):
    """The kernel's split and merge in plain PyTorch.  scores, valid
    [B, H, K] (f32 natural-log scores of every table position; which are
    visible); lo, hi [B, nsplit] from `split_bounds`.  partial(p, keep)
    gives (l [B, H], acc [B, H, D]) of the weights p [B, H, K] (exp of the
    scores minus the range's max, 0 outside `keep`).  Each range's (m, l,
    acc) merges in split order: out = sum c_s acc_s / sum c_s l_s with
    c_s = exp(m_s - max m).  Returns (out f32 [B, H, D], lse [B, H])."""
    pos = torch.arange(scores.shape[-1], device=scores.device)
    ms, ls, accs = [], [], []
    for s in range(lo.shape[1]):
        keep = valid & (pos >= lo[:, s, None, None]) \
            & (pos < hi[:, s, None, None])
        m = torch.where(keep, scores, -torch.inf).amax(dim=-1)
        m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.where(keep, torch.exp(scores - m_safe[..., None]),
                        torch.zeros_like(scores))
        l, acc = partial(p, keep)
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    return merge_partials(torch.stack(ms, -1), torch.stack(ls, -1),
                          torch.stack(accs, -2))


def merge_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor):
    """Merge per-split states m, l [..., nsplit] (m = -inf for an empty
    split) and acc [..., nsplit, D] in split order.  Returns (out [..., D],
    lse [...]): zeros and -0.7 * f32max where no split saw a token."""
    big = m.amax(dim=-1, keepdim=True)
    seen = ~torch.isinf(big)
    c = torch.where(torch.isinf(m), torch.zeros_like(m),
                    torch.exp(m - torch.where(seen, big, 0.0)))
    total = (l * c).sum(-1)
    out = (acc * c[..., None]).sum(-2)
    safe = torch.where(total > 0, total, torch.ones_like(total))
    out = torch.where(total[..., None] > 0, out / safe[..., None],
                      torch.zeros_like(out))
    lse = torch.where(total > 0, big[..., 0] + torch.log(safe),
                      torch.full_like(total, DEFAULT_MASK_VALUE))
    return out, lse


_SM_COUNT: Dict[int, int] = {}
_COUNTERS: Dict[int, torch.Tensor] = {}
# counters that a larger set replaced: kept, since a CUDA graph captured
# with them may still replay
_RETIRED: List[torch.Tensor] = []


def sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def launch_plan(batch: int, hq: int, hkv: int, capacity: int, window: int,
                device: torch.device, head_dim: int = 128,
                tile_rows: Optional[int] = None,
                blocks_per_sm: int = BLOCKS_PER_SM):
    """The kernel's split count for these shapes (`num_splits`, over the
    group's row tiles of `tile_rows` q rows, by default the tensor-core
    decode's `tc_tile_rows`, at `blocks_per_sm`) and its merge buffers:
    (nsplit, workspace, counters), the buffers None when nsplit is 1.  The
    workspace [B, Hkv, nsplit, G, D + 2] f32 is a fresh torch.empty; the
    counters [B * Hkv * row tiles] int32 are zeroed once per device and
    reused, since the last block of each (sequence, kv head, row tile)
    sets its counter back to 0 (so calls that overlap on two streams must
    not share a device).  Inside a CUDA-graph capture without such a set,
    the counters are a torch.zeros of the capture (its fill replays before
    each launch) and are not kept: the zeroing of a set made there would
    never run eagerly, and its memory belongs to the graph."""
    if tile_rows is None:
        tile_rows = tc_tile_rows(hq // hkv)
    tiles = row_tiles(hq // hkv, tile_rows)
    nsplit = num_splits(batch, hkv, capacity, window, sm_count(device),
                        tiles, blocks_per_sm)
    if nsplit == 1:
        return nsplit, None, None
    ws = torch.empty(batch * hq * nsplit * (head_dim + 2),
                     dtype=torch.float32, device=device)
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    need = batch * hkv * tiles
    cnt = _COUNTERS.get(idx)
    if cnt is None or cnt.numel() < need:
        fresh = torch.zeros(max(need, 256), dtype=torch.int32, device=device)
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            return nsplit, ws, fresh
        if cnt is not None:
            _RETIRED.append(cnt)
        cnt = _COUNTERS[idx] = fresh
    return nsplit, ws, cnt


def paged_decode_split_plain(q, k_pages, v_pages, block_tables,
                             context_lens, *, scale: Optional[float] = None,
                             window: int = -1, nsplit: int,
                             return_lse: bool = False):
    """The plain decode over head-major pools [Hkv, P, page, D] (f32 or
    dequantized), evaluated per split range and merged as the kernel
    does (`split_merge`)."""
    hq = q.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    window = window if window and window > 0 else -1
    kg = _expand_kv(_gather_pages(k_pages, block_tables).float(), hq)
    vg = _expand_kv(_gather_pages(v_pages, block_tables).float(), hq)
    scores = torch.einsum("bhd,bhkd->bhk", q.float(), kg) * scale
    capacity = kg.shape[2]
    pos = torch.arange(capacity, device=q.device)[None, None, :]
    lens = context_lens.long().to(q.device)[:, None, None]
    valid = pos < lens
    if window > 0:
        valid = valid & ((lens - 1 - pos) < window)
    lo, hi = split_bounds(context_lens.to(q.device), capacity, window,
                          nsplit)
    out, lse = split_merge(
        scores, valid, lo, hi,
        lambda p, keep: (p.sum(-1), torch.einsum("bhk,bhkd->bhd", p, vg)))
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out
