"""The port's native page allocator (serving/native.py over the shared
csrc/aule_alloc.cpp) against its Python allocator and the JAX package's.

The cases of tests/test_native_alloc.py on the port (the Python
allocator's pages and counts through 200 random operations, the sequence
manager, make_allocator's default), then: the JAX package's native
allocator hands out the same pages; make_allocator falls back with a
warning naming the build error; the library lands in the port's build
directory; and the engine, on either allocator, serves the same tokens,
leaves the same free list and writes the same checkpoint.
"""

import json
import logging

import numpy as np
import pytest

from aule_tpu.serving import native as jnative
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.serving import engine as tengine
from aule_tpu_torch.serving import kv_cache, native
from aule_tpu_torch.serving.kv_cache import (PagePoolExhausted,
                                             PythonPageAllocator,
                                             make_allocator)
from aule_tpu_torch.utils.testing import cap_cpu_threads

cap_cpu_threads()


def _ops(seed, allocators, n_ops=200, pages=32):
    """The same random allocate / free / grow sequence on every allocator;
    each step's pages, free counts and sizes must agree."""
    rng = np.random.default_rng(seed)
    held = [[] for _ in allocators]
    ref = allocators[0]
    for _ in range(n_ops):
        op = rng.integers(0, 3)
        if op == 0:
            n = int(rng.integers(1, 5))
            if n <= ref.num_free:
                got = [a.allocate(n) for a in allocators]
                assert all(g == got[0] for g in got)
                for h, g in zip(held, got):
                    h.append(g)
            else:
                for a in allocators:
                    with pytest.raises(PagePoolExhausted):
                        a.allocate(n)
        elif op == 1 and held[0]:
            i = int(rng.integers(0, len(held[0])))
            for a, h in zip(allocators, held):
                a.free(h.pop(i))
        elif op == 2 and rng.integers(0, 10) == 0:
            target = ref.num_pages + int(rng.integers(1, 8))
            for a in allocators:
                a.grow(target)
        assert len({a.num_free for a in allocators}) == 1
        assert len({a.num_pages for a in allocators}) == 1
        assert all(a.free_list() == ref.free_list() for a in allocators)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parity_with_python_allocator(seed):
    _ops(seed, [PythonPageAllocator(32), native.NativePageAllocator(32)])


# how long the test waits for another process's build of the JAX
# package's library to settle: that build writes the .so in place, so a
# load during it fails and leaves the module's sticky failure flag set
JAX_LIB_TRIES = 20
JAX_LIB_WAIT = 0.5  # seconds between tries


def _jax_allocator(monkeypatch, pages):
    """The JAX package's allocator, loaded again (its failure flag reset)
    while another pytest worker's in-place build of its library may be
    half-written; the last try's error fails the test."""
    import time

    err = None
    for _ in range(JAX_LIB_TRIES):
        try:
            return jnative.NativePageAllocator(pages)
        except RuntimeError as e:
            err = e
            time.sleep(JAX_LIB_WAIT)
            monkeypatch.setattr(jnative, "_LIB_FAILED", False)
    pytest.fail(f"the JAX package's native allocator: {err}")


def test_parity_with_jax_native_allocator(monkeypatch):
    """The JAX package's ctypes allocator (its own build of the same
    source) and the port's agree page for page."""
    theirs = _jax_allocator(monkeypatch, 32)
    _ops(3, [native.NativePageAllocator(32), theirs])


def test_free_list_roundtrip_and_errors():
    a = native.NativePageAllocator(8)
    assert a.allocate(3) == [0, 1, 2]
    a.free([1])
    assert a.free_list() == [7, 6, 5, 4, 3, 1]
    a.set_free_list([5, 2])
    assert (a.num_free, a.allocate(2)) == (2, [2, 5])
    with pytest.raises(PagePoolExhausted):
        a.allocate(1)
    with pytest.raises(ValueError):
        a.grow(4)
    a.grow(10)
    assert a.allocate(2) == [8, 9] and a.num_pages == 10


def test_sequence_manager():
    alloc = native.NativePageAllocator(16)
    mgr = native.NativeSequenceManager(alloc, page_size=16,
                                       max_pages_per_seq=4)
    mgr.add(10)
    mgr.reserve(10, 40)        # 3 pages
    mgr.advance(10, 40)
    assert mgr.length(10) == 40
    mgr.add(11)
    mgr.reserve(11, 10)
    mgr.advance(11, 10)
    bt, lens = mgr.batch_views([10, 11, 999], max_pages=4)
    assert bt.shape == (3, 4)
    assert list(lens) == [40, 10, 0]
    assert (bt[0, :3] >= 0).all() and bt[0, 3] == -1
    assert (bt[2] == -1).all()
    live = bt[bt >= 0]
    assert len(set(live.tolist())) == len(live)
    with pytest.raises(PagePoolExhausted):
        mgr.reserve(10, 16 * 4)  # beyond max_pages_per_seq
    with pytest.raises(ValueError):
        mgr.add(11)
    mgr.remove(10)
    assert alloc.num_free == 16 - 1  # only sequence 11's page remains
    with pytest.raises(KeyError):
        mgr.advance(12345, 1)
    with pytest.raises(KeyError):
        mgr.length(12345)


def test_native_is_default_allocator():
    assert isinstance(make_allocator(8), native.NativePageAllocator)
    cache = kv_cache.PagedKVCache.create(2, 8, num_pages=4, device="cpu")
    assert isinstance(cache.allocator, native.NativePageAllocator)


def test_library_in_the_ports_build_directory():
    path = native.library_path()
    native.load_library()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "aule_tpu_torch")


def test_make_allocator_falls_back_with_a_warning(monkeypatch, tmp_path,
                                                  caplog):
    """A source g++ cannot compile: make_allocator returns the Python
    allocator and logs the build error; every later call fails the same
    way without building again."""
    bad = tmp_path / "aule_alloc.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_ERROR", None)
    with caplog.at_level(logging.WARNING, logger="aule_tpu_torch"):
        a = make_allocator(8)
    assert type(a) is PythonPageAllocator
    assert "falling back to PythonPageAllocator" in caplog.text
    assert "g++ exited" in caplog.text
    assert not list((tmp_path / "build").glob("*.so"))
    with pytest.raises(RuntimeError, match="g\\+\\+ exited"):
        native.load_library()


def test_engine_same_with_either_allocator(monkeypatch, tmp_path):
    """The engine on the native allocator and on the Python one: the same
    tokens, the same free list mid-run and at the end, and the same
    checkpoint's bookkeeping."""
    cfg = tllama.LlamaConfig.tiny()
    import torch

    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (20, 5, 33)]
    kw = dict(max_batch=2, page_size=16, num_pages=16, max_pages_per_seq=8,
              max_seq_len=256, device="cpu")
    seen = {}
    for name in ("native", "python"):
        if name == "python":
            monkeypatch.setattr(tengine, "make_allocator",
                                PythonPageAllocator)
        eng = tengine.ServingEngine(params, cfg, **kw)
        assert (type(eng.allocator) is PythonPageAllocator) == (
            name == "python")
        for p in prompts:
            eng.submit(p, 9)
        for _ in range(3):
            eng.step()
        path = str(tmp_path / name)
        tengine.save_engine_state(eng, path)
        with open(path + ".state.json") as f:
            state = json.load(f)
        state.pop("torch_generator_state")
        out = [r.output for r in eng.run()]
        seen[name] = (out, state, eng.allocator.free_list())
    assert seen["native"] == seen["python"]
    assert seen["native"][1]["free_pages"]  # mid-run: pages out
