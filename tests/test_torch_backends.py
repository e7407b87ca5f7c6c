"""The port's backend chain (cuda -> torch -> numpy) and its forcing by
argument, config and environment, mirroring tests/test_integration.py's
backend tests for the JAX package."""

import numpy as np
import pytest
import torch

import aule_tpu_torch
from aule_tpu_torch import backends, config
from aule_tpu_torch.utils.testing import cap_cpu_threads

cap_cpu_threads()


@pytest.fixture
def fresh_config():
    """The process config as it was, after the test (the chain reads it)."""
    saved = config._config
    config.set_config(config.AuleConfig())
    yield
    config.set_config(saved)


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, 2, 16, 64))
                             .astype(np.float32)) for _ in range(3)]


def test_backend_report(fresh_config, capsys):
    info = aule_tpu_torch.get_backend_info()
    assert {"torch", "numpy"} <= set(info["available"])
    assert info["selected"] in info["available"]
    assert info["device_count"] == len(info["devices"])
    aule_tpu_torch.print_backend_info()
    assert "selected" in capsys.readouterr().out


def test_chain_order(fresh_config):
    avail = aule_tpu_torch.get_available_backends()
    assert avail == [b for b in backends.BACKENDS if b in avail]
    assert aule_tpu_torch.select_backend() == avail[0]


def test_cuda_unavailable_here_and_forcing_it_raises(fresh_config):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda backend is valid")
    assert aule_tpu_torch.get_available_backends() == ["torch", "numpy"]
    assert "cuda" in aule_tpu_torch.get_backend_errors()
    with pytest.raises(RuntimeError):
        aule_tpu_torch.select_backend("cuda")
    with pytest.raises(RuntimeError):
        aule_tpu_torch.flash_attention(*_qkv(), backend="cuda")


def test_force_unknown_backend_raises(fresh_config):
    with pytest.raises(ValueError):
        aule_tpu_torch.flash_attention(*_qkv(), backend="vulkan")


@pytest.mark.parametrize("name", ["torch", "numpy"])
def test_force_by_argument(fresh_config, name):
    assert aule_tpu_torch.select_backend(name.upper()) == name
    out = aule_tpu_torch.flash_attention(*_qkv(1), causal=True,
                                         backend=name)
    want = aule_tpu_torch.attention_reference(*_qkv(1), causal=True)
    assert out.device.type == "cpu"
    assert torch.allclose(out, want, atol=2e-5)


def test_force_by_config(fresh_config):
    aule_tpu_torch.set_config(aule_tpu_torch.AuleConfig(backend="numpy"))
    assert aule_tpu_torch.select_backend() == "numpy"
    assert aule_tpu_torch.select_backend("torch") == "torch"  # call wins


def test_force_by_env(fresh_config, monkeypatch):
    monkeypatch.setenv("AULE_TPU_TORCH_BACKEND", "numpy")
    monkeypatch.setenv("AULE_TPU_TORCH_VERBOSE", "1")
    cfg = aule_tpu_torch.AuleConfig.from_env()
    assert cfg.backend == "numpy" and cfg.verbose
    aule_tpu_torch.set_config(cfg)
    assert aule_tpu_torch.select_backend() == "numpy"


def test_the_jax_env_variable_is_not_read(fresh_config, monkeypatch):
    """AULE_TPU_BACKEND names the JAX package's backends (pallas, xla);
    the port reads only its own variable."""
    monkeypatch.setenv("AULE_TPU_BACKEND", "xla")
    monkeypatch.delenv("AULE_TPU_TORCH_BACKEND", raising=False)
    assert aule_tpu_torch.AuleConfig.from_env().backend is None
    config._config = None  # read the environment afresh
    assert aule_tpu_torch.get_config().backend is None
    assert aule_tpu_torch.select_backend() in ("cuda", "torch")


def test_install_forces_the_backend(fresh_config):
    aule_tpu_torch.install(backend="numpy")
    try:
        assert aule_tpu_torch.get_config().backend == "numpy"
        assert aule_tpu_torch.select_backend() == "numpy"
    finally:
        aule_tpu_torch.uninstall()
    assert aule_tpu_torch.get_config().backend is None


def test_recorded_errors_show_in_the_report(fresh_config):
    backends.record_error("cuda", "a launch failed")
    try:
        assert aule_tpu_torch.get_backend_errors()["cuda"] == \
            "a launch failed"
    finally:
        backends._errors.pop("cuda", None)
        backends._available = None
