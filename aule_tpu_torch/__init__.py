"""aule_tpu_torch: the PyTorch / CUDA (H100) port of aule_tpu.

The JAX package `aule_tpu` stays the reference; this package mirrors its
layout (`ops/`, `models/`, `serving/`, `integration/`, `utils/`) so each
module's counterpart is found by path, and its public surface: the same 25
names in `__all__`, `flash_attention(q, k, v, ...)` first.  It imports
torch and numpy only.

Backends (`backends.py`): `cuda` (the hand-written Hopper kernels of
csrc/, chosen automatically when an sm_90 card is present), `torch` (dense
PyTorch on the tensors' own device) and `numpy` (the NumPy oracle); force
one per call (`backend=`), for the process (`install(backend=...)`,
`set_config`) or with AULE_TPU_TORCH_BACKEND.  With `cuda`, inputs move
to the card and the result stays there; a build or launch failure raises
(and shows in `get_backend_errors()`), it never falls back.

Entry points (`ServingEngine`, `PagedKVCache.create`, `llama.init_params`,
`llama.load_jax_params`) run on the card by default and raise
`RuntimeError` when CUDA is absent; pass `device="cpu"` to run the plain
PyTorch versions of the kernels.
The op wrappers follow their tensors: a CPU tensor takes the plain
version, a CUDA tensor launches the hand-written kernel (csrc/) or raises.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from .backends import (
    get_available_backends,
    get_backend_errors,
    get_backend_info,
    print_backend_info,
    select_backend,
)
from .config import AuleConfig, get_config, set_config
from .ops.reference import (
    attention_reference,
    attention_reference_numpy,
    paged_attention_reference,
)
from .ops.rope import apply_rope, precompute_rope_frequencies
from .ops.topk import gravity_attention, spatial_sort

__version__ = "0.1.0"

logger = logging.getLogger("aule_tpu_torch")


def _validate(q, k, v) -> None:
    """Shape and GQA checks (aule_tpu/__init__.py:44-61)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q/k/v must be 4-D [batch, heads, seq, head_dim]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[0] != v.shape[0]:
        raise ValueError("batch dims must match")
    if q.shape[3] != k.shape[3] or q.shape[3] != v.shape[3]:
        raise ValueError("head_dim must match across q/k/v")
    if k.shape != v.shape:
        raise ValueError(f"k and v shapes must match; got {tuple(k.shape)} "
                         f"vs {tuple(v.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"num q heads ({q.shape[1]}) must be divisible by "
                         f"kv heads ({k.shape[1]})")


def _to_numpy(x):
    x = torch.as_tensor(x).detach().cpu()
    return (x.float() if x.dtype in (torch.bfloat16, torch.float16)
            else x).numpy()


def _numpy_route(q, k, v, causal, scale, window_size, rope_cos, rope_sin,
                 return_lse, kv_len):
    """The numpy backend: concrete arrays, so kv_len is a slice and RoPE
    rotates in f32 first (aule_tpu/__init__.py:142-155); CPU tensors of
    q's dtype back."""
    qn, kn, vn = _to_numpy(q), _to_numpy(k), _to_numpy(v)
    if kv_len is not None:
        n = int(torch.as_tensor(kv_len).reshape(()))
        kn, vn = kn[:, :, :n], vn[:, :, :n]
    if rope_cos is not None:
        cos = torch.as_tensor(rope_cos).float().cpu()
        sin = torch.as_tensor(rope_sin).float().cpu()
        qn = apply_rope(torch.from_numpy(qn).float(), cos, sin).numpy()
        kn = apply_rope(torch.from_numpy(kn).float(), cos, sin).numpy()
    res = attention_reference_numpy(qn, kn, vn, causal=causal, scale=scale,
                                    window_size=window_size,
                                    return_lse=return_lse)
    out = torch.from_numpy(res[0] if return_lse else res).to(q.dtype)
    return (out, torch.from_numpy(res[1])) if return_lse else out


def flash_attention(
    q,
    k,
    v,
    causal: bool = False,
    scale: Optional[float] = None,
    window_size: int = -1,
    rope_cos=None,
    rope_sin=None,
    backend: Optional[str] = None,
    return_lse: bool = False,
    kv_len=None,
):
    """Fused multi-head attention over [batch, heads, seq, head_dim]
    (aule_tpu/__init__.py:64-167).

    q [B, Hq, Sq, D]; k, v [B, Hkv, Sk, D] with Hq % Hkv == 0 (GQA/MQA) and
    Sq != Sk allowed.  causal: q_idx >= k_idx (top-left aligned).  scale:
    1/sqrt(D) by default.  window_size: -1 disables; causal windows allow k
    in [q - W, q], bidirectional |q - k| <= W.  rope_cos / rope_sin: [S,
    D/2] tables of a half-split RoPE on q and k.  backend: force 'cuda' |
    'torch' | 'numpy'.  return_lse: also return the natural-log row LSE [B,
    Hq, Sq] (differentiable in both outputs on cuda and torch).  kv_len:
    only the first kv_len keys attend; an int, or an int32 tensor the cuda
    kernels read on the card (pad K/V to a bucket and vary the length with
    no new shape; forward-only on cuda, as JAX's on pallas).

    Returns a tensor shaped like q in q's dtype (or (out, lse)); on the
    card with cuda, on q's device with torch, on the CPU with numpy.
    """
    _validate(q, k, v)
    chosen = select_backend(backend)
    if get_config().verbose:
        logger.info("flash_attention backend=%s q=%s k=%s", chosen,
                    tuple(q.shape), tuple(k.shape))
    if chosen == "numpy":
        return _numpy_route(q, k, v, causal, scale, window_size, rope_cos,
                            rope_sin, return_lse, kv_len)
    if chosen == "torch":
        return attention_reference(q, k, v, causal=causal, scale=scale,
                                   window_size=window_size,
                                   rope_cos=rope_cos, rope_sin=rope_sin,
                                   return_lse=return_lse, kv_len=kv_len)
    dev = q.device if q.device.type == "cuda" else torch.device("cuda")
    q, k, v = (x.to(dev) for x in (q, k, v))
    if rope_cos is not None:
        rope_cos, rope_sin = rope_cos.to(dev), rope_sin.to(dev)
    if kv_len is not None:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise ValueError("kv_len is forward-only: call flash_attention "
                             "with kv_len under torch.no_grad() or on "
                             "tensors that do not require grad")
        from .ops.flash import flash_attention_fwd

        if rope_cos is not None:  # outside the kernel, as JAX's route
            q = apply_rope(q, rope_cos, rope_sin)
            k = apply_rope(k, rope_cos, rope_sin)
        if isinstance(kv_len, torch.Tensor):
            kv_len = kv_len.to(dev)
        return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                   window_size=window_size, kv_len=kv_len,
                                   return_lse=return_lse)
    if return_lse:
        from .ops.flash_vjp import flash_attention_lse

        if rope_cos is not None:
            q = apply_rope(q, rope_cos, rope_sin)
            k = apply_rope(k, rope_cos, rope_sin)
        return flash_attention_lse(q, k, v, causal=causal, scale=scale,
                                   window_size=window_size)
    from .ops.flash import flash_attention_cuda

    return flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                window_size=window_size, rope_cos=rope_cos,
                                rope_sin=rope_sin)


# install()/uninstall(): the process-wide backend and the SDPA patch
# (aule_tpu/__init__.py:170-210; the reference's python/aule/__init__.py:
# 353-442)

def install(backend: Optional[str] = None, verbose: bool = False) -> None:
    """Force `backend` for the process (None: auto) and patch
    torch.nn.functional.scaled_dot_product_attention."""
    cfg = get_config()
    cfg.backend = backend
    cfg.verbose = verbose
    from .integration.patching import install_sdpa_patch

    install_sdpa_patch(backend=backend)
    if verbose:
        print_backend_info()


def uninstall() -> None:
    """Undo install(): restore torch's function, clear the forced
    backend."""
    get_config().backend = None
    from .integration.patching import uninstall_sdpa_patch

    uninstall_sdpa_patch()


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


def flash_attention_rope(*args, **kwargs):
    """Inference fast path with RoPE fused inside the kernel (forward only;
    ops/flash.py)."""
    from .ops.flash import flash_attention_rope as _impl

    return _impl(*args, **kwargs)


def flash_attention_lse(*args, **kwargs):
    """Differentiable (out, lse) pair (ops/flash_vjp.py)."""
    from .ops.flash_vjp import flash_attention_lse as _impl

    return _impl(*args, **kwargs)


def patch_model(model, causal=None, backend=None):
    """Route a model's attention through the port (HF torch models via the
    attention-interface registry; others via the SDPA patch)."""
    from .integration.patching import patch_model as _impl

    return _impl(model, causal=causal, backend=backend)


def dot_product_attention(*args, **kwargs):
    """Drop-in for torch.nn.functional.scaled_dot_product_attention
    ([B, H, S, D]; integration/patching.py)."""
    from .integration.patching import dot_product_attention as _impl

    return _impl(*args, **kwargs)


__all__ = [
    "flash_attention",
    "flash_attention_rope",
    "flash_attention_lse",
    "dot_product_attention",
    "patch_model",
    "paged_attention",
    "paged_attention_fused",
    "paged_attention_prefill",
    "gravity_attention",
    "spatial_sort",
    "attention_reference",
    "attention_reference_numpy",
    "paged_attention_reference",
    "precompute_rope_frequencies",
    "apply_rope",
    "get_available_backends",
    "get_backend_errors",
    "get_backend_info",
    "print_backend_info",
    "install",
    "uninstall",
    "AuleConfig",
    "get_config",
    "set_config",
    "__version__",
]
