"""Settings the port reads (counterpart of aule_tpu/config.py).

The TPU tile tables and the `AULE_FLASH_*` schedule knobs have no
counterpart here: the Hopper kernels pick their tiles in the CUDA source.
What remains is the library-wide `AuleConfig` (the backend to force and
per-call logging), the mask convention shared with the JAX kernels, the
serving and paged-cache defaults, the int8 decode setting and the device
rule of the entry points.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

# Masked-score fill and the LSE of a fully masked row, as in
# aule_tpu/ops/flash.py:43 (finite, so m - m never makes a NaN).
DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

# serving and paged-cache defaults (aule_tpu/config.py:196-199);
# serving/kv_cache.PagedKVCache reads the last three at each call
PAGE_SIZE = 16
INITIAL_PAGES = 512
MAX_PAGES = 8192
MAX_PAGES_PER_SEQ = 256


def int8_exact() -> bool:
    """AULE_TPU_INT8_EXACT, as the JAX package's `config.int8_exact`
    (default False): int8 pools decode on the int8 dot-product path unless
    it is set; a call's `int8_matmul=` overrides it.  Read at each call."""
    v = os.environ.get("AULE_TPU_INT8_EXACT")
    return v is not None and v.lower() in ("1", "true", "yes", "on")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA is the default; asking
    for it without a card raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "aule_tpu_torch entry points run on a CUDA device by default "
            "and torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain PyTorch versions")
    return dev


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    return default if v is None else v.lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class AuleConfig:
    """Library-wide settings (aule_tpu/config.py::AuleConfig, the fields
    the port reads), overridable from the environment:
      AULE_TPU_TORCH_BACKEND = cuda | torch | numpy   (force a backend)
      AULE_TPU_TORCH_VERBOSE = 1                      (per-call debug logs)
    The port reads variables of its own: the JAX package's
    AULE_TPU_BACKEND names its own backends (pallas, xla, numpy), and both
    packages may live in one process."""

    backend: Optional[str] = None  # None = auto-select
    verbose: bool = False

    @classmethod
    def from_env(cls) -> "AuleConfig":
        return cls(backend=os.environ.get("AULE_TPU_TORCH_BACKEND") or None,
                   verbose=_env_bool("AULE_TPU_TORCH_VERBOSE", False))


_config: Optional[AuleConfig] = None


def get_config() -> AuleConfig:
    """The process's settings, read from the environment at first use."""
    global _config
    if _config is None:
        _config = AuleConfig.from_env()
    return _config


def set_config(cfg: AuleConfig) -> None:
    global _config
    _config = cfg
