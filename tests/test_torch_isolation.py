"""The PyTorch port stands alone: no JAX anywhere in it, and its entry
points refuse to run on the CPU unless asked to."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from aule_tpu_torch.utils.testing import cap_cpu_threads

cap_cpu_threads()

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "aule_tpu")


def _port_files():
    files = sorted((ROOT / "aule_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


# the modules a user imports, and what none of them may pull in: JAX, the
# JAX package, and what the card's host may lack (transformers for the HF
# conversion, ml_dtypes for the checkpoints' bf16 and float8 leaves)
ENTRY_MODULES = (
    "aule_tpu_torch.serving.engine", "aule_tpu_torch.ops.flash",
    "aule_tpu_torch.ops.flash_vjp", "aule_tpu_torch.ops.paged",
    "aule_tpu_torch.ops.paged_fused", "aule_tpu_torch.ops.paged_prefill",
    "aule_tpu_torch.ops.quant", "aule_tpu_torch.serving.kv_cache",
    "aule_tpu_torch.models.moe", "aule_tpu_torch.models.convert",
    "aule_tpu_torch.parallel", "aule_tpu_torch.parallel.optimizer",
    "aule_tpu_torch.utils.checkpoint", "aule_tpu_torch.utils.tree",
    "aule_tpu_torch.serving.native", "aule_tpu_torch.serving.http_api",
    "aule_tpu_torch.serving.transport", "aule_tpu_torch.serving.multihost",
    "aule_tpu_torch.serving.worker")
LEFT_OUT = FORBIDDEN + ("transformers", "ml_dtypes")


def test_engine_import_leaves_jax_out():
    code = (f"import sys, {', '.join(ENTRY_MODULES)}; "
            f"print(sorted(m for m in sys.modules "
            f"if m.split('.')[0] in {LEFT_OUT!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("module", ["models/moe.py", "models/convert.py",
                                    "parallel/optimizer.py",
                                    "parallel/__init__.py",
                                    "utils/checkpoint.py", "utils/tree.py"])
def test_new_modules_import_no_optional_packages(module):
    """Not even inside a function: these modules never import
    transformers or ml_dtypes."""
    roots = set(_imported_roots(ROOT / "aule_tpu_torch" / module))
    assert not roots & set(LEFT_OUT), sorted(roots & set(LEFT_OUT))


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from aule_tpu_torch.models import llama
    from aule_tpu_torch.serving.engine import ServingEngine
    from aule_tpu_torch.serving.kv_cache import PagedKVCache

    cfg = llama.LlamaConfig.tiny()
    with pytest.raises(RuntimeError):
        llama.init_params(cfg, torch.Generator())
    params = llama.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError):
        ServingEngine(params, cfg)
    with pytest.raises(RuntimeError):
        llama.load_jax_params({})
    with pytest.raises(RuntimeError):
        PagedKVCache.create(2, 64)
    from aule_tpu_torch.models import moe

    with pytest.raises(RuntimeError):
        moe.init_params(moe.MoEConfig.tiny(), torch.Generator())
    with pytest.raises(RuntimeError):
        moe.load_jax_params({})


def _worker_probe(results):
    """In a spawned process: serve one request through the pool's worker
    loop on the CPU, then report its tokens and every module of JAX or of
    the JAX package that the process holds."""
    import queue

    from aule_tpu_torch.serving.worker import worker_main

    req_q, res_q = queue.Queue(), queue.Queue()
    req_q.put((0, [1, 2, 3, 4, 5], 3, None, {}))
    req_q.put(None)
    worker_main(0, 0, dict(device="cpu", max_batch=1, page_size=16,
                           num_pages=8, max_pages_per_seq=2,
                           max_seq_len=32), req_q, res_q,
                worker_env={"OMP_NUM_THREADS": "1"})
    results.put((res_q.get_nowait(), sorted(
        m for m in sys.modules if m.split(".")[0] in FORBIDDEN)))


def test_spawned_worker_holds_no_jax():
    """A serving worker, started as MultiProcessServingPool starts it (the
    spawn context), serves its request with neither JAX nor the JAX
    package in its sys.modules."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=_worker_probe, args=(results,))
    proc.start()
    try:
        msg, modules = results.get(timeout=120)
    finally:
        proc.join(timeout=30)
    assert msg[:2] == (0, 0) and len(msg[2]) == 3
    assert modules == []
