"""Name parity: every public name of every `aule_tpu` module resolves at
the same import path in `aule_tpu_torch`, except the names listed below,
each with its reason and, where the port has one, the path of its
counterpart (which must resolve).

A module's public names are its `__all__` when it has one; else every
name without a leading underscore that is not a module and is a class or
function of the `aule_tpu` package, or a plain constant (number, string,
container).  Imports from outside the package (jax, numpy, typing,
logging) are not the module's surface."""

import importlib
import inspect
import pkgutil
import types

import pytest

import aule_tpu
from aule_tpu_torch.utils.testing import cap_cpu_threads

cap_cpu_threads()

_TILES = ("a Pallas tile table or TPU schedule switch (block sizes, VMEM, "
          "grid layouts): the Hopper kernels' tiles are compile-time "
          "templates in aule_tpu_torch/csrc/", None)
_LANES = ("the TPU's 128-lane vector width, which the port keeps for the "
          "fused pool's rows alone", "aule_tpu_torch.ops.paged_fused."
          "NUM_LANES")
_GROUP_PAD = ("the f32 sublane padding of a GQA group on the TPU; the CUDA "
              "decodes take any group in row tiles of up to 8", None)
_LOG2E = ("the Pallas kernels' exp2 rescale; the CUDA kernels keep theirs "
          "in csrc/", None)
_CONFIG = ("imported from aule_tpu.config", "aule_tpu_torch.config."
           "get_config")
_MASK = ("imported from aule_tpu.config", "aule_tpu_torch.config."
         "DEFAULT_MASK_VALUE")

# (module, name) -> (reason, the port's counterpart or None)
EXCEPTIONS = {
    **{("aule_tpu.config", n): _TILES for n in (
        "TileConfig", "TileRule", "TILE_TABLE", "get_tile_config",
        "decode_xbatch", "flash_diag", "flash_diag_strips",
        "flash_diag_pair")},
    **{(f"aule_tpu.ops.{m}", "get_tile_config"): _TILES
       for m in ("flash", "flash_vjp", "paged", "paged_fused")},
    **{(f"aule_tpu.ops.{m}", "NUM_LANES"): _LANES
       for m in ("flash", "flash_vjp", "paged")},
    **{(f"aule_tpu.ops.{m}", "MIN_GROUP_PAD"): _GROUP_PAD
       for m in ("paged", "paged_fused")},
    **{(f"aule_tpu.ops.{m}", "LOG2E"): _LOG2E for m in ("flash",
                                                          "flash_vjp")},
    **{(m, "get_config"): _CONFIG for m in (
        "aule_tpu.ops.flash", "aule_tpu.ops.flash_vjp", "aule_tpu.ops.paged",
        "aule_tpu.ops.paged_fused", "aule_tpu.serving.kv_cache")},
    **{(f"aule_tpu.ops.{m}", "DEFAULT_MASK_VALUE"): _MASK
       for m in ("flash", "flash_vjp", "paged")},
    ("aule_tpu.ops.flash", "LAST_LAYOUT"): (
        "the last Pallas grid layout chosen, a TPU tuning record; the port "
        "counts each kernel's launches (a wrapper's .launches)", None),
    ("aule_tpu.ops.flash", "flash_attention_pallas"): (
        "the Pallas route", "aule_tpu_torch.ops.flash.flash_attention_cuda"),
    **{("aule_tpu.ops.paged_fused", n): (
        "imported from aule_tpu.ops.quant", f"aule_tpu_torch.ops.quant.{n}")
       for n in ("E4M3_EXPAND_SHIFT", "e4m3_expand_scaled",
                 "e4m3_expand_scaled_bf16")},
    **{(m, "flash_attention_fwd"): (
        "imported from aule_tpu.ops.flash",
        "aule_tpu_torch.ops.flash.flash_attention_fwd")
       for m in ("aule_tpu.models.gpt2", "aule_tpu.parallel.sharded")},
    **{("aule_tpu.models.moe", n): ("imported from aule_tpu.ops.rope",
                                    f"aule_tpu_torch.ops.rope.{n}")
       for n in ("apply_rope", "precompute_rope_frequencies")},
}

CONSTANTS = (bool, int, float, str, tuple, list, dict, set, frozenset)


def _modules():
    return ["aule_tpu"] + sorted(
        m.name for m in pkgutil.walk_packages(aule_tpu.__path__,
                                              "aule_tpu."))


def public_names(mod):
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    out = []
    for name, value in vars(mod).items():
        if name.startswith("_") or isinstance(value, types.ModuleType):
            continue
        if inspect.isclass(value) or inspect.isfunction(value):
            if not value.__module__.startswith("aule_tpu"):
                continue
        elif not isinstance(value, CONSTANTS):
            continue
        out.append(name)
    return out


def _resolve(path):
    module, _, name = path.rpartition(".")
    return getattr(importlib.import_module(module), name)


@pytest.mark.parametrize("module", _modules())
def test_public_names_resolve_in_the_port(module):
    jmod = importlib.import_module(module)
    tmod = importlib.import_module("aule_tpu_torch"
                                   + module[len("aule_tpu"):])
    missing = [n for n in public_names(jmod) if not hasattr(tmod, n)
               and (module, n) not in EXCEPTIONS]
    assert not missing, f"{tmod.__name__} lacks {missing}"


def test_exceptions_are_real_and_their_counterparts_resolve():
    for (module, name), (reason, counterpart) in EXCEPTIONS.items():
        assert reason
        assert name in public_names(importlib.import_module(module)), \
            (module, name)
        tmod = importlib.import_module("aule_tpu_torch"
                                       + module[len("aule_tpu"):])
        assert not hasattr(tmod, name), \
            f"{module}.{name} resolves in the port: drop its exception"
        if counterpart is not None:
            _resolve(counterpart)


@pytest.mark.parametrize("path,home", [
    ("aule_tpu_torch.ops.paged_fused.paged_attention_prefill",
     "aule_tpu_torch.ops.paged_prefill.paged_attention_prefill"),
    ("aule_tpu_torch.serving.engine.PagePoolExhausted",
     "aule_tpu_torch.serving.kv_cache.PagePoolExhausted"),
    ("aule_tpu_torch.serving.engine.PagedKVCache",
     "aule_tpu_torch.serving.kv_cache.PagedKVCache"),
])
def test_repaired_paths_are_the_same_objects(path, home):
    assert _resolve(path) is _resolve(home)
