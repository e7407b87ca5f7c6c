"""Drop-in `scaled_dot_product_attention`, its process-wide patch, and the
model patch (counterpart of aule_tpu/integration/patching.py).

The reference library patches `torch.nn.functional.scaled_dot_product_
attention` and keeps the original for what it does not take (SURVEY.md
§2.1, python/aule/__init__.py:288-350); the JAX package patches
`jax.nn.dot_product_attention` the same way.  Here the patch is the
reference's own: `install_sdpa_patch` replaces torch's function with
`dot_product_attention`, which routes [B, H, S, D] calls through
`aule_tpu_torch.flash_attention` and hands everything else (`attn_mask`,
`dropout_p > 0`, other ranks or types, a V head dim of its own, and on
the cuda backend a head dim above 256) to the saved original; on the
cuda backend every head dim up to 256 reaches the kernels, as the JAX
package's patch sends every 4-D call to its own.  HF models go through transformers' attention-interface
registry (`patch_model`), natively in torch: the JAX package's dlpack
bridge (patching.py:143-175) has no counterpart.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch
import torch.nn.functional as F

logger = logging.getLogger("aule_tpu_torch")

# The function `install_sdpa_patch` replaced, kept to restore it and to run
# what the port does not take; None while no patch is installed.
_original_sdpa = None
_patch_backend: Optional[str] = None

# Knobs of patched models (patching.py:29-32): causal None honours each
# call site's is_causal, True/False forces it; backend None auto-selects.
PATCH_CONFIG = {"causal": None, "backend": None}
# calls routed through the port by the HF interface, and those of them that
# took the bucketed decode (tests read them)
PATCH_STATS = {"calls": 0, "bucketed": 0}

# the decode step's K/V bucket: one kernel shape per 128 tokens of context
_KV_BUCKET = 128
_TYPES = (torch.float32, torch.bfloat16, torch.float16)


def _off_kernels(query, backend) -> bool:
    """Whether the backend `backend` selects is cuda and its kernels do not
    take query's head dim (they take every D up to 256 in every type of
    _TYPES, padding it to 64, 128 or 256: ops/flash.py
    `kernel_head_dim`), so the call belongs to torch's own function."""
    from ..backends import select_backend
    from ..ops.flash import TENSOR_CORE_HEAD_DIMS

    return (query.shape[-1] > TENSOR_CORE_HEAD_DIMS[-1]
            and select_backend(backend) == "cuda")


def original_sdpa():
    """torch's own scaled_dot_product_attention, patched or not."""
    return _original_sdpa or F.scaled_dot_product_attention


def dot_product_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                          is_causal=False, scale=None, enable_gqa=False,
                          **kwargs):
    """Drop-in for F.scaled_dot_product_attention ([B, H, S, D]): the
    port's flash attention where the arguments are in its space (GQA when
    `enable_gqa`, causal top-left aligned as torch's, any scale), torch's
    original otherwise.  The result has query's device and dtype."""
    unsupported = (
        attn_mask is not None or dropout_p > 0.0 or kwargs
        or query.dim() != 4 or key.dim() != 4 or value.shape != key.shape
        or query.shape[-1] != key.shape[-1]
        or not (query.dtype == key.dtype == value.dtype)
        or query.dtype not in _TYPES
        or (key.shape[1] != query.shape[1]
            and not (enable_gqa and query.shape[1] % key.shape[1] == 0))
        or _off_kernels(query, _patch_backend))
    if unsupported:
        return original_sdpa()(query, key, value, attn_mask=attn_mask,
                               dropout_p=dropout_p, is_causal=is_causal,
                               scale=scale, enable_gqa=enable_gqa, **kwargs)
    from .. import flash_attention

    out = flash_attention(query, key, value, causal=bool(is_causal),
                          scale=scale, backend=_patch_backend)
    return out.to(query.device)


def install_sdpa_patch(backend: Optional[str] = None) -> None:
    """Route torch.nn.functional.scaled_dot_product_attention through the
    port, process-wide, until `uninstall_sdpa_patch`."""
    global _original_sdpa, _patch_backend
    if _original_sdpa is None:
        _original_sdpa = F.scaled_dot_product_attention
    _patch_backend = backend
    F.scaled_dot_product_attention = dot_product_attention
    logger.debug("patched torch scaled_dot_product_attention (backend=%s)",
                 backend)


def uninstall_sdpa_patch() -> None:
    """Put torch's function object back."""
    global _original_sdpa, _patch_backend
    if _original_sdpa is not None:
        F.scaled_dot_product_attention = _original_sdpa
        _original_sdpa = None
    _patch_backend = None


# ---- HF torch models: an `aule_tpu_torch` entry in transformers'
# attention-interface registry (the JAX package registers `aule_tpu`; both
# may be registered in one process)

_HF_NAME = "aule_tpu_torch"
_hf_registered = False


def _hf_attention(module, query, key, value, attention_mask, dropout=0.0,
                  scaling=None, is_causal=None, head_mask=None, **kwargs):
    """transformers AttentionInterface entry: query/key/value [B, H, S, D]
    in, (out [B, S, H, D], None) back.  Additive masks, dropout, head
    masks, softcaps and, on the cuda backend, head dims above 256 go to
    transformers' sdpa path (the reference's fallback).
    Autograd flows through the port's flash attention, so training calls
    stay on it.  A one-token decode step pads K/V to a
    128-token bucket and passes the true length as a device `kv_len`
    (patching.py:220-238), so every step of a bucket has one kernel shape
    (and one CUDA-graph shape)."""
    backend = PATCH_CONFIG["backend"] or _patch_backend
    unsupported = (attention_mask is not None or dropout
                   or head_mask is not None
                   or kwargs.get("softcap") is not None
                   or _off_kernels(query, backend))
    if unsupported:
        from transformers.integrations.sdpa_attention import (
            sdpa_attention_forward,
        )

        return sdpa_attention_forward(module, query, key, value,
                                      attention_mask, dropout=dropout,
                                      scaling=scaling, is_causal=is_causal,
                                      **kwargs)
    from .. import flash_attention
    from ..backends import select_backend

    causal = PATCH_CONFIG["causal"]
    if causal is None:
        if is_causal is None:
            is_causal = (query.shape[2] > 1
                         and getattr(module, "is_causal", True))
        causal = bool(is_causal)
    PATCH_STATS["calls"] += 1
    grad = torch.is_grad_enabled() and (query.requires_grad
                                        or key.requires_grad
                                        or value.requires_grad)
    if (query.shape[2] == 1 and not grad
            and select_backend(backend) != "numpy"):
        sk = key.shape[2]
        pad = -(-sk // _KV_BUCKET) * _KV_BUCKET - sk
        if pad:
            key = F.pad(key, (0, 0, 0, pad))
            value = F.pad(value, (0, 0, 0, pad))
        kv_len = torch.tensor(sk, dtype=torch.int32, device=query.device)
        PATCH_STATS["bucketed"] += 1
        out = flash_attention(query, key, value, causal=False, scale=scaling,
                              backend=backend, kv_len=kv_len)
    else:
        out = flash_attention(query, key, value, causal=causal,
                              scale=scaling, backend=backend)
    return out.to(query.device).transpose(1, 2).contiguous(), None


def _register_hf_interface() -> None:
    global _hf_registered
    if _hf_registered:
        return
    from transformers.modeling_utils import ALL_ATTENTION_FUNCTIONS

    ALL_ATTENTION_FUNCTIONS.register(_HF_NAME, _hf_attention)
    _hf_registered = True


def patch_model(model, causal: Optional[bool] = None,
                backend: Optional[str] = None):
    """Route a model's attention through the port.

    * HF torch models (anything with `config._attn_implementation`):
      registers the `aule_tpu_torch` attention interface and switches the
      model onto it, so every attention layer's q/k/v flow through
      `aule_tpu_torch.flash_attention`.
    * Any other model: its calls of F.scaled_dot_product_attention pick up
      the process-wide patch (`install_sdpa_patch`).
    causal: None honours each call site's is_causal; True/False forces it.
    """
    PATCH_CONFIG["causal"] = causal
    PATCH_CONFIG["backend"] = backend
    if hasattr(model, "config") and hasattr(model.config,
                                            "_attn_implementation"):
        _register_hf_interface()
        try:
            model.set_attn_implementation(_HF_NAME)
        except AttributeError:  # older transformers
            model.config._attn_implementation = _HF_NAME
        return model
    install_sdpa_patch(backend)
    return model
