"""Serving of the PyTorch / CUDA port (mirrors aule_tpu/serving): KV-cache
pool/table management and continuous batching.

Re-exports the user-facing surface, the JAX package's `__all__`; the
HTTP front end and the replica pools load lazily (they pull in threading
and socket machinery most engine users never touch).
"""

from .engine import (  # noqa: F401
    Request,
    ServingEngine,
    load_engine_state,
    save_engine_state,
)
from .kv_cache import PagePoolExhausted, PagedKVCache, make_allocator  # noqa: F401

__all__ = [
    "Request",
    "ServingEngine",
    "load_engine_state",
    "save_engine_state",
    "PagePoolExhausted",
    "PagedKVCache",
    "make_allocator",
]


def __getattr__(name):
    if name == "ServingHTTPServer":
        from .http_api import ServingHTTPServer
        return ServingHTTPServer
    if name in ("EngineReplicaPool", "MultiProcessServingPool"):
        from . import multihost
        return getattr(multihost, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
