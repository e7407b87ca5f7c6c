"""Integration layer: the SDPA patch and the model patch helpers
(counterpart of aule_tpu/integration/)."""

from .patching import (
    PATCH_CONFIG,
    dot_product_attention,
    install_sdpa_patch,
    patch_model,
    uninstall_sdpa_patch,
)

__all__ = [
    "dot_product_attention",
    "install_sdpa_patch",
    "uninstall_sdpa_patch",
    "patch_model",
    "PATCH_CONFIG",
]
