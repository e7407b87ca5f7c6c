"""The port's integration layer: the SDPA patch (install, fallback for
what the port does not take, uninstall), `dot_product_attention`, and
`patch_model` on a locally built, randomly initialised HF GPT-2 (skipped
without transformers, as tests/test_integration.py does).  Each test that
patches undoes it in a fixture: one pytest worker runs many files."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import aule_tpu_torch
from aule_tpu_torch import backends
from aule_tpu_torch.integration import patching
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()

ORIGINAL_SDPA = F.scaled_dot_product_attention


@pytest.fixture
def clean_patch():
    """Whatever a test installs is gone after it."""
    yield
    aule_tpu_torch.uninstall()
    patching.PATCH_CONFIG.update(causal=None, backend=None)
    assert F.scaled_dot_product_attention is ORIGINAL_SDPA


def _qkv(b, h, s, d, hkv=None, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(b, h, s, d), (b, hkv or h, s, d), (b, hkv or h, s, d)]
    return [torch.from_numpy(rng.standard_normal(x).astype(np.float32))
            for x in shapes]


def test_install_patches_sdpa_and_uninstall_restores(clean_patch):
    aule_tpu_torch.install()
    assert F.scaled_dot_product_attention is patching.dot_product_attention
    q, k, v = _qkv(1, 4, 32, 64, seed=1)
    got = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    want = ORIGINAL_SDPA(q, k, v, is_causal=True)
    assert_close(got, want.numpy(), 0, 2e-5, "patched sdpa")
    aule_tpu_torch.uninstall()
    assert F.scaled_dot_product_attention is ORIGINAL_SDPA


def test_patched_sdpa_gqa_and_scale(clean_patch):
    aule_tpu_torch.install()
    q, k, v = _qkv(2, 8, 24, 64, hkv=2, seed=2)
    got = F.scaled_dot_product_attention(q, k, v, scale=0.2,
                                         enable_gqa=True)
    want = ORIGINAL_SDPA(q, k, v, scale=0.2, enable_gqa=True)
    assert_close(got, want.numpy(), 0, 2e-5, "gqa")


@pytest.mark.parametrize("arg", ["attn_mask", "dropout", "rank3", "d320"])
def test_patched_sdpa_falls_back_to_the_original(clean_patch, monkeypatch,
                                                 arg):
    aule_tpu_torch.install()
    q, k, v = _qkv(1, 2, 16, 320 if arg == "d320" else 32, seed=3)
    calls = []

    def spy(*a, **kw):
        calls.append(kw)
        return ORIGINAL_SDPA(*a, **kw)

    patching._original_sdpa = spy
    if arg == "attn_mask":
        mask = torch.rand(16, 16, generator=torch.Generator().manual_seed(0)) > 0.3
        mask[:, 0] = True
        got = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        want = ORIGINAL_SDPA(q, k, v, attn_mask=mask)
    elif arg == "dropout":
        torch.manual_seed(0)
        got = F.scaled_dot_product_attention(q, k, v, dropout_p=0.5)
        torch.manual_seed(0)
        want = ORIGINAL_SDPA(q, k, v, dropout_p=0.5)
    elif arg == "rank3":
        got = F.scaled_dot_product_attention(q[0], k[0], v[0])
        want = ORIGINAL_SDPA(q[0], k[0], v[0])
    else:  # a head dim above the cuda kernels' 256, on the cuda backend
        monkeypatch.setattr(backends, "select_backend", lambda b=None: "cuda")
        got = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        want = ORIGINAL_SDPA(q, k, v, is_causal=True)
    patching._original_sdpa = ORIGINAL_SDPA
    assert len(calls) == 1
    assert torch.equal(got, want)


def test_dot_product_attention_drop_in(clean_patch):
    """SDPA's [B, H, S, D] layout and arguments, patch or no patch."""
    q, k, v = _qkv(1, 4, 20, 64, seed=4)
    got = aule_tpu_torch.dot_product_attention(q, k, v, is_causal=True)
    want = ORIGINAL_SDPA(q, k, v, is_causal=True)
    assert got.shape == q.shape
    assert_close(got, want.numpy(), 0, 2e-5, "drop-in")
    # differentiable through the port's route
    qg = q.clone().requires_grad_(True)
    aule_tpu_torch.dot_product_attention(qg, k, v, is_causal=True).sum() \
        .backward()
    qr = q.clone().requires_grad_(True)
    ORIGINAL_SDPA(qr, k, v, is_causal=True).sum().backward()
    assert_close(qg.grad, qr.grad.numpy(), 0, 1e-4, "grad")


@pytest.mark.parametrize("case", ["causal", "gqa_scale", "window"])
def test_dot_product_attention_matches_jax(clean_patch, case):
    """The port's drop-in and its patched SDPA ([B, H, S, D]) against the
    JAX package's `dot_product_attention` (BTNH) on the same seeded
    inputs, f32 within 2e-5."""
    import jax.numpy as jnp

    import aule_tpu

    hkv = 2 if case == "gqa_scale" else 4
    q, k, v = _qkv(2, 4, 40, 64, hkv=hkv, seed=6)
    kw = {"causal": dict(is_causal=True), "gqa_scale": dict(scale=0.3),
          "window": dict(is_causal=True)}[case]
    jkw = dict(kw, local_window_size=(7, 0)) if case == "window" else kw
    want = aule_tpu.dot_product_attention(
        *(jnp.asarray(x.numpy()).swapaxes(1, 2) for x in (q, k, v)), **jkw)
    want = np.asarray(want).swapaxes(1, 2)
    if case == "window":  # SDPA has no window: the port's flash_attention
        got = aule_tpu_torch.flash_attention(q, k, v, causal=True,
                                             window_size=7)
        assert_close(got, want, 0, 2e-5, "window")
        return
    gqa = dict(kw, enable_gqa=hkv != 4)
    got = aule_tpu_torch.dot_product_attention(q, k, v, **gqa)
    assert_close(got, want, 0, 2e-5, "dot_product_attention")
    aule_tpu_torch.install()
    got = F.scaled_dot_product_attention(q, k, v, **gqa)
    assert_close(got, want, 0, 2e-5, "patched sdpa")


def test_patch_model_without_hf_config_installs_the_patch(clean_patch):
    model = object()
    assert aule_tpu_torch.patch_model(model, causal=False) is model
    assert patching.PATCH_CONFIG["causal"] is False
    assert F.scaled_dot_product_attention is patching.dot_product_attention


def _gpt2(transformers, n_positions, seed):
    cfg = transformers.GPT2Config(vocab_size=128, n_positions=n_positions,
                                  n_embd=64, n_layer=2, n_head=2)
    torch.manual_seed(seed)
    return cfg, transformers.GPT2LMHeadModel(cfg).eval()


def test_patch_model_routes_hf_gpt2(clean_patch):
    """Every layer's attention goes through the port and the logits stay
    those of the unpatched model."""
    transformers = pytest.importorskip("transformers")
    cfg, model = _gpt2(transformers, 64, 0)
    ids = torch.arange(24).reshape(1, 24) % 128
    with torch.no_grad():
        want = model(ids).logits
    aule_tpu_torch.patch_model(model)
    try:
        assert model.config._attn_implementation == "aule_tpu_torch"
        patching.PATCH_STATS["calls"] = 0
        with torch.no_grad():
            got = model(ids).logits
        assert patching.PATCH_STATS["calls"] == cfg.n_layer
        assert_close(got, want.numpy(), 0, 1e-4, "logits")
    finally:
        model.set_attn_implementation("sdpa")


def test_patch_model_hands_hf_head_dim_off_the_kernels_to_sdpa(
        clean_patch, monkeypatch):
    """On the cuda backend an HF layer whose head dim the kernels do not
    take (320: above 256; every smaller D is padded to a kernel width)
    goes to transformers' sdpa path, and its logits stay those of the
    unpatched model."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.GPT2Config(vocab_size=128, n_positions=32,
                                  n_embd=640, n_layer=1, n_head=2)
    torch.manual_seed(2)
    model = transformers.GPT2LMHeadModel(cfg).eval()
    ids = torch.arange(16).reshape(1, 16) % 128
    with torch.no_grad():
        want = model(ids).logits
    monkeypatch.setattr(backends, "select_backend", lambda b=None: "cuda")
    aule_tpu_torch.patch_model(model)
    try:
        patching.PATCH_STATS["calls"] = 0
        with torch.no_grad():
            got = model(ids).logits
        assert patching.PATCH_STATS["calls"] == 0
        assert torch.equal(got, want)
    finally:
        model.set_attn_implementation("sdpa")


def test_patched_hf_generate_bucketed_decode(clean_patch):
    """generate() through the patch gives the unpatched greedy tokens, and
    its one-token steps take the bucketed decode (K/V padded to 128, the
    true length as kv_len)."""
    transformers = pytest.importorskip("transformers")
    cfg, model = _gpt2(transformers, 96, 1)
    ids = (torch.arange(12).reshape(1, 12) * 7) % 128
    with torch.no_grad():
        want = model.generate(ids, max_new_tokens=6, do_sample=False,
                              pad_token_id=0)
    aule_tpu_torch.patch_model(model)
    try:
        patching.PATCH_STATS.update(calls=0, bucketed=0)
        with torch.no_grad():
            got = model.generate(ids, max_new_tokens=6, do_sample=False,
                                 pad_token_id=0)
        # the prompt, then 5 cached one-token steps, each over 2 layers
        assert patching.PATCH_STATS["calls"] == 6 * cfg.n_layer
        assert patching.PATCH_STATS["bucketed"] == 5 * cfg.n_layer
        assert torch.equal(got, want), (got, want)
    finally:
        model.set_attn_implementation("sdpa")
