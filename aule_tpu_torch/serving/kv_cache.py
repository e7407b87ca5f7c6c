"""Host-side page bookkeeping (counterpart of aule_tpu/serving/kv_cache.py:32-76).

The pools themselves are tensors owned by the engine; this module keeps
the free list.  The native C++ allocator (aule_tpu/serving/native.py)
comes with a later slice; unlike JAX's `make_allocator`, nothing here
falls back quietly from one allocator to another.
"""

from __future__ import annotations

from typing import List


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
