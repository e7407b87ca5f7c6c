"""GPT-2's serving steps of the PyTorch port against the JAX package.

`GPT2Config.tiny()` in f32 (head_dim 64, so the fused pools pad D to 128
lanes), params carried across with `load_jax_params`: `decode_step_fused`
and `prefill_step_fused` agree with aule_tpu's within 1e-4 (logits; f32
pools at 1e-5, quantized pools and their scale tiles bytewise); the int8
dot-product decode at the JAX suite's 4e-2 (it quantizes p over other
token spans than JAX).  The port runs its kernels' plain versions here
(device="cpu"); JAX runs its Pallas kernels in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu import config as jconfig
from aule_tpu.models import gpt2 as jgpt2
from aule_tpu.ops.paged_fused import (fused_pool_shape, fused_scales_shape,
                                      kv_cache_append_prefill_fused)
from aule_tpu_torch.models import gpt2 as tgpt2
from aule_tpu_torch.ops.paged_prefill import paged_attention_prefill_plain
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()

JCFG = jgpt2.GPT2Config.tiny()
TCFG = tgpt2.GPT2Config.tiny()
ATOL = 1e-4
QDTYPES = {"int8": (jnp.int8, torch.int8),
           "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


@pytest.fixture(scope="module")
def params():
    jp = jgpt2.init_params(JCFG, jax.random.key(0))
    tp = tgpt2.load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _tbits(x, dtype):
    """A JAX array as a torch tensor of `dtype`, bit for bit."""
    a = np.asarray(x)
    if dtype == torch.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(dtype)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(dtype)
    return torch.from_numpy(a.copy())


def _same_bits(t, j):
    a = t.contiguous().view(torch.uint8).numpy()
    return a.tobytes() == np.asarray(j).view(np.uint8).tobytes()


BT = np.array([[1, 2, -1, -1], [3, 4, 5, -1]], np.int32)
HIST = np.array([20, 33], np.int32)


def _pools(qname, seed):
    """Per-layer fused pools (D 64 padded to 128 lanes) holding random
    history written by JAX's prefill append, quantized with bf16 scale
    tiles when qname is given; the port gets the same bytes."""
    rng = np.random.default_rng(seed)
    shape = fused_pool_shape(16, JCFG.n_kv_heads, 16, JCFG.head_dim)
    jk, js = [], []
    for _ in range(JCFG.n_layers):
        k = jnp.asarray(rng.standard_normal(
            (2, JCFG.n_kv_heads, 33, JCFG.head_dim)), jnp.float32)
        v = jnp.asarray(rng.standard_normal(k.shape), jnp.float32)
        where = (jnp.asarray(BT), jnp.zeros((2,), jnp.int32),
                 jnp.asarray(HIST))
        if qname is None:
            kv, _ = kv_cache_append_prefill_fused(
                jnp.zeros(shape, jnp.float32), k, v, *where)
            sc = None
        else:
            kv, sc, _ = kv_cache_append_prefill_fused(
                jnp.zeros(shape, QDTYPES[qname][0]), k, v, *where,
                kv_scales=jnp.zeros(fused_scales_shape(
                    16, JCFG.n_kv_heads, 16), jnp.bfloat16))
        jk.append(kv)
        js.append(sc)
    tdt = torch.float32 if qname is None else QDTYPES[qname][1]
    tk = torch.stack([_tbits(a, tdt) for a in jk])
    ts = (None if qname is None else
          torch.stack([_tbits(a, torch.bfloat16) for a in js]))
    return jk, (None if qname is None else js), tk, ts


@pytest.mark.parametrize("mode", ["f32", "int8_exact", "int8_dot", "fp8"])
def test_decode_step_fused(params, mode, monkeypatch):
    """f32 pools: logits at 1e-4, pools at 1e-5.  int8 (both decode paths;
    AULE_TPU_INT8_EXACT set in both packages for the exact one) and fp8:
    logits at 1e-4 and every layer's appended payload and scale bytes
    identical; the int8 dot-product path at 4e-2, bytewise only in layer
    0 (appended before any attention)."""
    if mode == "int8_exact":
        monkeypatch.setenv("AULE_TPU_INT8_EXACT", "1")
        monkeypatch.setattr(jconfig, "_config", dataclasses.replace(
            jconfig.get_config(), int8_exact=True))
    else:
        monkeypatch.delenv("AULE_TPU_INT8_EXACT", raising=False)
    jp, tp = params
    qname = {"f32": None, "fp8": "fp8"}.get(mode, "int8")
    jk, js, tk, ts = _pools(qname, seed=1)
    tok = np.array([5, 77], np.int32)
    jout = jgpt2.decode_step_fused(
        jp, jnp.asarray(tok), jnp.asarray(HIST), jk, jnp.asarray(BT),
        jnp.asarray(HIST), JCFG, kv_scales=js)
    tout = tgpt2.decode_step_fused(
        tp, torch.from_numpy(tok).long(), torch.from_numpy(HIST).long(), tk,
        torch.from_numpy(BT), torch.from_numpy(HIST), TCFG, kv_scales=ts)
    dot = mode == "int8_dot"
    assert_close(tout[0], np.asarray(jout[0]), 0, 4e-2 if dot else ATOL,
                 "logits")
    assert tout[2].tolist() == np.asarray(jout[2]).tolist()
    for li in range(1 if dot else JCFG.n_layers):
        if qname is None:
            assert_close(tk[li], np.asarray(jout[1][li]), 0, 1e-5,
                         f"pool{li}")
        else:
            assert _same_bits(tk[li], jout[1][li]), f"pool{li}"
            assert _same_bits(ts[li], jout[3][li]), f"scales{li}"


@pytest.mark.parametrize("qname", [None, "int8", "fp8"])
def test_prefill_step_fused(params, qname):
    """A ragged chunk (padding rows in sequence 1) over history: logits of
    each sequence's last valid token and the appended pools, then
    all_logits through the plain attention hook over fresh pools."""
    jp, tp = params
    jk, js, tk, ts = _pools(qname, seed=4)
    tokens = np.random.default_rng(5).integers(
        0, JCFG.vocab_size, size=(2, 12)).astype(np.int32)
    slens = np.array([12, 7], np.int32)
    args = (torch.from_numpy(tokens).long(), torch.from_numpy(HIST),
            torch.from_numpy(slens))
    jout = jgpt2.prefill_step_fused(
        jp, jnp.asarray(tokens), jnp.asarray(HIST), jnp.asarray(slens), jk,
        jnp.asarray(BT), JCFG, kv_scales=js)
    tout = tgpt2.prefill_step_fused(tp, *args, tk, torch.from_numpy(BT),
                                    TCFG, kv_scales=ts)
    assert_close(tout[0], np.asarray(jout[0]), 0, ATOL, "last logits")
    assert tout[2].tolist() == np.asarray(jout[2]).tolist()
    for li in range(JCFG.n_layers):
        if qname is None:
            assert_close(tk[li], np.asarray(jout[1][li]), 0, 1e-5,
                         f"pool{li}")
        else:
            assert _same_bits(tk[li], jout[1][li]), f"pool{li}"
            assert _same_bits(ts[li], jout[3][li]), f"scales{li}"
    _, _, tk2, ts2 = _pools(qname, seed=4)
    every = tgpt2.prefill_step_fused(
        tp, *args, tk2, torch.from_numpy(BT), TCFG, kv_scales=ts2,
        all_logits=True, attention=paged_attention_prefill_plain)[0]
    assert every.shape == (2, 12, TCFG.vocab_size)
    # the same rows through a [B, S, dim] product: f32 rounding apart
    assert_close(every[0, 11], tout[0][0].numpy(), 0, 1e-5, "row 0")
    assert_close(every[1, 6], tout[0][1].numpy(), 0, 1e-5, "row 1")
