"""The port's driver entry points (aule_tpu_torch/entry.py) against the
JAX package's (__graft_entry__.py), on the CPU.

  * `entry()`: the config and tokens are JAX's, and its forward on JAX's
    weights gives JAX's logits within 1e-4 (JAX's flash kernel in
    interpret mode).  The weights cross in JAX's checkpoint format, and
    the port's forward runs in a process of its own that holds no JAX: in
    a process where XLA had run, torch's first forward of this model was
    seen to differ from its own repeat by up to 1.8e-4 (against 3.7e-6
    from an f64 forward otherwise), at random.
  * `dryrun_multichip(4, device="cpu")`: every check passes at JAX's
    thresholds (ring / Ulysses / split decode < 2e-4, fused int8 < 3e-2) in
    gloo worlds of 4 and 2 ranks, and the dp x tp step's loss on JAX's
    weights equals JAX's one-device train_step loss within GRAD_TOL.
  * `dryrun_multihost(2, device="cpu")`: 2 hosts of 2 worker processes
    each join through distributed_init, every worker prints MULTIHOST-OK
    with the same loss; a worker that dies fails the run at once.
"""

import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from aule_tpu.models import llama as jllama
from aule_tpu.utils.checkpoint import save_pytree as jsave
from aule_tpu_torch import entry as tentry
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4
GRAD_TOL = 1e-4   # tests/test_torch_sharded.py's


PORT_FORWARD = """
import sys
import numpy as np
from aule_tpu_torch.entry import entry
from aule_tpu_torch.utils.checkpoint import load_pytree
fn, (params, tokens) = entry(device="cpu")
np.save(sys.argv[2], fn(load_pytree(sys.argv[1], params), tokens).numpy())
assert "jax" not in sys.modules
"""


def test_entry_logits_match_jax(tmp_path):
    jfn, (jparams, jtokens) = jentry.entry()
    fn, (params, tokens) = tentry.entry(device="cpu")
    cfg = fn.cfg
    for name in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                 "hidden_dim", "rope_base", "norm_eps", "head_dim"):
        assert getattr(cfg, name) == getattr(
            jllama.LlamaConfig(vocab_size=2048, dim=512, n_layers=4,
                               n_heads=8, n_kv_heads=2, hidden_dim=1024),
            name), name
    assert cfg.dtype == torch.float32 and jparams["embed"].dtype == \
        jnp.float32
    assert np.array_equal(tokens.numpy(), np.asarray(jtokens))
    assert tuple(params["embed"].shape) == tuple(jparams["embed"].shape)
    want = np.asarray(jax.jit(jfn)(jparams, jtokens))
    jsave(str(tmp_path / "params"), jparams)
    proc = subprocess.run(
        [sys.executable, "-c", PORT_FORWARD, str(tmp_path / "params"),
         str(tmp_path / "logits.npy")], capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    got = np.load(tmp_path / "logits.npy")
    assert got.shape == (2, 512, 2048)
    assert_close(got, want, 0, ATOL, "entry logits")


@pytest.fixture(scope="module")
def dryrun_params():
    cfg = jllama.LlamaConfig.tiny(n_heads=4, n_kv_heads=2, dim=128,
                                  hidden_dim=256, n_layers=2)
    return cfg, jllama.init_params(cfg, jax.random.key(0))


def test_dryrun_multichip_checks_pass_and_match_jax(dryrun_params, capsys):
    cfg, jparams = dryrun_params
    got = tentry.dryrun_multichip(
        4, device="cpu", params=tllama.load_jax_params(
            jax.tree.map(np.asarray, jparams), device="cpu"))
    assert sorted(got) == sorted(tentry.MULTICHIP_CHECKS)
    for key in ("ring", "ulysses", "paged"):
        assert got[key] < 2e-4, (key, got[key])
    assert got["fused_int8"] < 3e-2
    for key in ("dp_tp", "zero1", "pipeline"):
        assert np.isfinite(got[key]), key
    assert len(got["tp_serving"]) == len(got["gpt2_tp_serving"]) == 3
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32)
    _, jloss = jllama.train_step(jparams, jnp.asarray(tokens), cfg, lr=1e-3)
    assert abs(got["dp_tp"] - float(jloss)) < GRAD_TOL
    # ZeRO-1 starts from the same params: its loss is the SGD step's
    assert abs(got["zero1"] - got["dp_tp"]) < GRAD_TOL
    out = capsys.readouterr().out.splitlines()
    assert len(out) == len(tentry.MULTICHIP_CHECKS)
    assert all(line.startswith("dryrun_multichip(4): ")
               and line.endswith("OK") for line in out)


def test_dryrun_multichip_worlds():
    """The sub-meshes of the JAX run (its devices[:k]) as worlds of k."""
    assert tentry._worlds(4) == {
        4: ["dp_tp", "zero1", "ring", "ulysses", "paged", "fused_int8",
            "moe_ep"], 2: ["pipeline", "tp_serving", "gpt2_tp_serving"]}
    assert tentry._worlds(8)[4] == ["moe_ep"]
    assert tentry._worlds(3) == {3: ["dp_tp", "zero1", "ring", "ulysses",
                                     "paged", "fused_int8"]}


def test_dryrun_multihost_workers_agree(capsys):
    losses = tentry.dryrun_multihost(2, device="cpu")
    assert len(losses) == 4 and len(set(losses)) == 1
    line = capsys.readouterr().out.strip()
    assert line.startswith("dryrun_multihost(2): MULTIHOST-OK process=0/4")
    assert line.count("MULTIHOST-OK") == 4 and "dp2xtp2" in line


def test_dryrun_multihost_fails_at_once_when_a_worker_dies(monkeypatch):
    """Worker 1 exits at start; the others wait at the rendezvous for it.
    The parent raises within seconds, not at its timeout, and stops
    them."""
    started = []
    real = subprocess.Popen

    def popen(cmd, **kw):
        if cmd[3] == "1":  # [python, -m, module, rank, ...]
            cmd = [sys.executable, "-c", "import sys; sys.exit(3)"]
        started.append(real(cmd, **kw))
        return started[-1]

    monkeypatch.setattr(tentry.subprocess, "Popen", popen)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="worker 1 failed"):
        tentry.dryrun_multihost(2, timeout_s=300, device="cpu")
    assert time.monotonic() - t0 < 60
    assert len(started) == 4
    assert all(p.poll() is not None for p in started)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: the default is valid")
def test_entry_points_raise_without_a_card():
    with pytest.raises(RuntimeError):
        tentry.entry()
    with pytest.raises(RuntimeError):
        tentry.dryrun_multichip(2)
    with pytest.raises(RuntimeError):
        tentry.dryrun_multihost(1)
    proc = subprocess.run([sys.executable, "-m", "aule_tpu_torch.entry"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
