"""Backend detection, selection and reporting (counterpart of
aule_tpu/backends.py:22-128).

The chain, in auto-selection order:
  * cuda: the hand-written Hopper kernels of csrc/; available when a card
    of compute capability 9.0 is present (decided from the device alone:
    the kernels build at first use, and a build or launch failure raises
    and is recorded in `get_backend_errors()`, it never falls through);
  * torch: dense PyTorch (the plain versions) on the tensors' own device;
  * numpy: the NumPy oracle on the CPU.
Forcing: the per-call `backend=` argument, then `AuleConfig.backend`
(`install(backend=...)`, `set_config`, or AULE_TPU_TORCH_BACKEND), then
auto.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .config import get_config

BACKENDS = ("cuda", "torch", "numpy")

_errors: Dict[str, str] = {}
_available: Optional[List[str]] = None


def _cuda_reason() -> Optional[str]:
    """Why the cuda backend is unavailable, or None when it is."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False"
    caps = [torch.cuda.get_device_capability(i)
            for i in range(torch.cuda.device_count())]
    if (9, 0) not in caps:
        return (f"the kernels are built for sm_90a (compute capability "
                f"9.0); the devices have {caps}")
    return None


def _probe() -> List[str]:
    global _available
    if _available is None:
        avail = ["torch", "numpy"]
        reason = _cuda_reason()
        if reason is None:
            avail.insert(0, "cuda")
        else:
            _errors.setdefault("cuda", reason)
        _available = avail
    return _available


def record_error(backend: str, msg: str) -> None:
    """Keep the latest failure of `backend` for the reports (the cuda
    route's build and launch errors, which also raise)."""
    _errors[backend] = msg


def get_available_backends() -> List[str]:
    """Backends usable here, in auto-selection order."""
    return [b for b in BACKENDS if b in _probe()]


def get_backend_errors() -> Dict[str, str]:
    """Why a backend is unavailable, or how it last failed."""
    _probe()
    return dict(_errors)


def select_backend(forced: Optional[str] = None) -> str:
    """The backend of a call: per-call force, then the config's, then the
    first available.  Forcing an unavailable backend raises."""
    avail = _probe()
    choice = forced or get_config().backend
    if choice is None:
        return avail[0]
    choice = choice.lower()
    if choice not in BACKENDS:
        raise ValueError(f"unknown backend {choice!r}; expected one of "
                         f"{BACKENDS}")
    if choice not in avail:
        raise RuntimeError(f"backend {choice!r} unavailable: "
                           f"{_errors.get(choice, 'not detected')}")
    return choice


def get_backend_info() -> Dict[str, object]:
    """Devices and backend availability."""
    info: Dict[str, object] = {"available": get_available_backends(),
                               "errors": get_backend_errors(),
                               "selected": select_backend()}
    devices = []
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            major, minor = torch.cuda.get_device_capability(i)
            devices.append({"id": i, "platform": "cuda",
                            "kind": torch.cuda.get_device_name(i),
                            "capability": f"{major}.{minor}"})
    info["devices"] = devices
    info["device_count"] = len(devices)
    info["torch"] = torch.__version__
    info["cuda"] = torch.version.cuda
    return info


def print_backend_info() -> None:
    info = get_backend_info()
    print("aule_tpu_torch backend report")
    print(f"  selected : {info['selected']}")
    print(f"  available: {', '.join(info['available'])}")
    for d in info["devices"]:
        print(f"  device   : [{d['id']}] {d['platform']} ({d['kind']}, "
              f"compute capability {d['capability']})")
    for name, err in info["errors"].items():
        print(f"  {name}: {err}")
