"""aule_tpu_torch: the PyTorch / CUDA (H100) port of aule_tpu.

The JAX package `aule_tpu` stays the reference; this package mirrors its
layout (`ops/`, `models/`, `serving/`, `utils/`) so each module's
counterpart is found by path.  It imports torch and numpy only.

Entry points (`ServingEngine`, `PagedKVCache.create`, `llama.init_params`,
`llama.load_jax_params`) run on the card by default and raise
`RuntimeError` when CUDA is absent; pass `device="cpu"` to run the plain
PyTorch versions of the kernels.
The op wrappers follow their tensors: a CPU tensor takes the plain
version, a CUDA tensor launches the hand-written kernel (csrc/) or raises.
"""

__version__ = "0.1.0"


def paged_attention(*args, **kwargs):
    """Paged decode attention over split (head-major) K/V pools (lazy
    import; see ops/paged.py for the cache contract)."""
    from .ops.paged import paged_attention as _impl

    return _impl(*args, **kwargs)


def paged_attention_fused(*args, **kwargs):
    """Fused-layout paged decode, the serving fast path (lazy import; see
    ops/paged_fused.py for the pool layout)."""
    from .ops.paged_fused import paged_attention_fused as _impl

    return _impl(*args, **kwargs)


def paged_attention_prefill(*args, **kwargs):
    """Chunked / multi-turn prefill over a fused paged cache (lazy import;
    see ops/paged_prefill.py)."""
    from .ops.paged_prefill import paged_attention_prefill as _impl

    return _impl(*args, **kwargs)
