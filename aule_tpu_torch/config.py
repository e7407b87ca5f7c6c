"""Settings the port reads (counterpart of aule_tpu/config.py).

The TPU tile tables and the `AULE_FLASH_*` schedule knobs have no
counterpart here: the Hopper kernels pick their tiles in the CUDA source.
What remains is the mask convention shared with the JAX kernels, the
serving page size and the device rule of the entry points.
"""

from __future__ import annotations

import numpy as np
import torch

# Masked-score fill and the LSE of a fully masked row, as in
# aule_tpu/ops/flash.py:43 (finite, so m - m never makes a NaN).
DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

# serving defaults (aule_tpu/config.py:196-199)
PAGE_SIZE = 16


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
