"""Test helper: tolerance comparison (counterpart of
aule_tpu/utils/testing.py::assert_close), for torch tensors and arrays.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def cap_cpu_threads() -> int:
    """Cap torch's intra-op threads at this process's share of the cores.

    Under pytest-xdist each of the `PYTEST_XDIST_WORKER_COUNT` workers
    would otherwise run torch with one thread per core, and the CPU
    models' many small ops spin those threads against each other's. A lone
    run (no xdist) keeps every core. Returns the cap."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    n = max(1, (os.cpu_count() or 1) // max(1, workers))
    torch.set_num_threads(n)
    return n


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def assert_close(actual, expected, rtol: float, atol: float, label: str = ""):
    """Raise AssertionError when |actual - expected| > atol + rtol*|expected|
    anywhere; accepts torch tensors and array-likes."""
    actual = _np64(actual)
    expected = _np64(expected)
    err = np.abs(actual - expected)
    tol = atol + rtol * np.abs(expected)
    bad = err > tol
    if bad.any():
        idx = np.unravel_index(np.argmax(err - tol), err.shape)
        raise AssertionError(
            f"{label}: {bad.sum()}/{bad.size} elements out of tolerance "
            f"(rtol={rtol}, atol={atol}); worst at {idx}: "
            f"actual={actual[idx]:.6g} expected={expected[idx]:.6g} "
            f"maxAbsDiff={err.max():.3e} meanAbsDiff={err.mean():.3e}"
        )
