"""Paged KV-cache management (counterpart of aule_tpu/serving/kv_cache.py).

  * `PythonPageAllocator`: the LIFO free list of page ids;
  * `make_allocator`: the native C++ allocator (serving/native.py) where
    g++ builds it, else `PythonPageAllocator` with a logged warning;
  * `PagedKVCache`: split-layout pools ([Hkv, P, page, D] K and V, and f32
    scales [Hkv, P, page] each when quantized; ops/paged.py) with the
    host-side bookkeeping of each sequence's pages and length.  Growth
    keeps the data.

Both allocators hand out the same pages in the same order for the same
calls, so free lists and checkpoint files do not depend on which one runs.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import config

logger = logging.getLogger("aule_tpu_torch")


class PagePoolExhausted(RuntimeError):
    """No free pages left."""


class PythonPageAllocator:
    """LIFO free-list page allocator: pages come out in ascending order
    from a fresh pool and freed pages are reused first."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))

    @property
    def num_free(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PagePoolExhausted(
                f"requested {n} pages, only {len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        self._free.extend(pages)

    def grow(self, new_num_pages: int) -> None:
        """Add pages num_pages .. new_num_pages - 1 (the lowest comes out
        first)."""
        if new_num_pages < self.num_pages:
            raise ValueError(f"cannot shrink {self.num_pages} pages to "
                             f"{new_num_pages}")
        self._free.extend(range(new_num_pages - 1, self.num_pages - 1, -1))
        self.num_pages = new_num_pages

    def free_list(self) -> List[int]:
        return list(self._free)

    def set_free_list(self, pages: List[int]) -> None:
        self._free = list(pages)


def make_allocator(num_pages: int):
    """The native allocator (serving/native.py, built with g++ at first
    use) where it builds and loads, else PythonPageAllocator (JAX
    kv_cache.py:69-76); the fallback logs a warning with the build
    error."""
    try:
        from .native import NativePageAllocator

        return NativePageAllocator(num_pages)
    except Exception as e:
        logger.warning("make_allocator: falling back to PythonPageAllocator "
                       "(%s)", e)
        return PythonPageAllocator(num_pages)


@dataclasses.dataclass
class PagedKVCache:
    """Caller-owned split-layout paged KV cache plus host bookkeeping.

    Device state: k_pages, v_pages [Hkv, num_pages, page_size, D] and, for
    a quantized (int8) cache, k_scales, v_scales [Hkv, num_pages,
    page_size] f32 (ops/paged.py writes and reads them).  Host state: the
    allocator and each sequence's pages and length."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_size: int
    max_pages_per_seq: int
    allocator: PythonPageAllocator
    seq_pages: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    seq_lens: Dict[int, int] = dataclasses.field(default_factory=dict)
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, num_kv_heads: int, head_dim: int, *,
               num_pages: Optional[int] = None,
               page_size: Optional[int] = None,
               max_pages_per_seq: Optional[int] = None,
               dtype=torch.bfloat16, quantized: bool = False,
               device="cuda") -> "PagedKVCache":
        """Zeroed pools on `device` (the card unless device='cpu'); sizes
        default to config.INITIAL_PAGES, PAGE_SIZE and MAX_PAGES_PER_SEQ.
        quantized=True makes int8 pools with their own K and V scale
        tensors: JAX's create passes ONE zeros array as both (:121-124),
        harmless for immutable arrays, but the port appends in place and
        would make K and V share their scales."""
        dev = config.resolve_device(device)
        num_pages = num_pages or config.INITIAL_PAGES
        page_size = page_size or config.PAGE_SIZE
        max_pages_per_seq = max_pages_per_seq or config.MAX_PAGES_PER_SEQ
        shape = (num_kv_heads, num_pages, page_size, head_dim)
        pool_dtype = torch.int8 if quantized else dtype

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)

        scales = {}
        if quantized:
            scales = dict(k_scales=zeros(shape[:-1], torch.float32),
                          v_scales=zeros(shape[:-1], torch.float32))
        return cls(zeros(shape, pool_dtype), zeros(shape, pool_dtype),
                   page_size, max_pages_per_seq,
                   make_allocator(num_pages), **scales)

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[1]

    @property
    def num_free_pages(self) -> int:
        return self.allocator.num_free

    def add_sequence(self, seq_id: int, num_tokens: int = 0) -> None:
        if seq_id in self.seq_pages:
            raise ValueError(f"sequence {seq_id} already present")
        self.seq_pages[seq_id] = []
        self.seq_lens[seq_id] = 0
        if num_tokens:
            self.reserve(seq_id, num_tokens)

    def reserve(self, seq_id: int, num_new_tokens: int) -> None:
        """Make sure pages exist for num_new_tokens more tokens, growing the
        pools when the free list runs short."""
        need_pages = -(-(self.seq_lens[seq_id] + num_new_tokens)
                       // self.page_size)
        extra = need_pages - len(self.seq_pages[seq_id])
        if extra <= 0:
            return
        if need_pages > self.max_pages_per_seq:
            raise PagePoolExhausted(
                f"sequence {seq_id} needs {need_pages} pages "
                f"> max_pages_per_seq={self.max_pages_per_seq}")
        if extra > self.allocator.num_free:
            self._grow(extra)
        self.seq_pages[seq_id].extend(self.allocator.allocate(extra))

    def advance(self, seq_id: int, num_tokens: int) -> None:
        self.seq_lens[seq_id] += num_tokens

    def free_sequence(self, seq_id: int) -> None:
        self.allocator.free(self.seq_pages.pop(seq_id))
        self.seq_lens.pop(seq_id)

    def _grow(self, min_extra: int) -> None:
        """Double the pools (at least min_extra more pages, at most
        config.MAX_PAGES), keeping their contents."""
        target = min(max(self.num_pages * 2, self.num_pages + min_extra),
                     config.MAX_PAGES)
        if target <= self.num_pages:
            raise PagePoolExhausted(
                f"pool at max ({self.num_pages} pages), "
                f"{self.allocator.num_free} free, need {min_extra}")

        extra = target - self.num_pages

        def grown(t):
            pad = list(t.shape)
            pad[1] = extra
            return torch.cat([t, t.new_zeros(pad)], dim=1)

        self.k_pages = grown(self.k_pages)
        self.v_pages = grown(self.v_pages)
        if self.k_scales is not None:
            self.k_scales = grown(self.k_scales)
            self.v_scales = grown(self.v_scales)
        self.allocator.grow(target)

    def batch_views(self, seq_ids: List[int]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(block_tables [B, max_pages_per_seq] int32, -1 padded;
        context_lens [B] int32) of the sequences, on the pools' device."""
        bt = np.full((len(seq_ids), self.max_pages_per_seq), -1, np.int32)
        lens = np.zeros((len(seq_ids),), np.int32)
        for row, sid in enumerate(seq_ids):
            pages = self.seq_pages[sid]
            bt[row, :len(pages)] = pages
            lens[row] = self.seq_lens[sid]
        dev = self.k_pages.device
        return torch.from_numpy(bt).to(dev), torch.from_numpy(lens).to(dev)
