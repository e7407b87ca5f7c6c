"""HuggingFace checkpoint conversion into the port's param dicts
(counterpart of aule_tpu/models/convert.py:22-119).

`llama_params_from_hf` / `gpt2_params_from_hf` map a transformers model or
its state dict ({name: tensor or array}) onto models/llama.py's and
models/gpt2.py's params on `device`, with the JAX package's keys and
layouts, so the result equals `load_jax_params` of the JAX package's own
conversion bit for bit: each weight is taken to f32, laid out (HF's
nn.Linear weights are [out, in] and are transposed to the port's [in, out];
GPT-2's Conv1D weights are [in, out] already) and rounded once to the
model's dtype.  transformers itself is never imported here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..config import resolve_device

Params = Dict[str, Any]


def _state_dict(model_or_sd) -> Mapping[str, Any]:
    if hasattr(model_or_sd, "state_dict"):
        return model_or_sd.state_dict()
    return model_or_sd


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32))


def llama_params_from_hf(model_or_sd, cfg, dtype=None,
                         device="cuda") -> Params:
    """transformers LlamaForCausalLM (or its state dict) -> models/llama.py
    params on `device`.  HF's rotate_half RoPE is the half-split convention
    of ops/rope.py, so q and k need no permutation.  Norms stay f32; a
    missing lm_head.weight (tied embeddings) takes the embedding's."""
    sd = _state_dict(model_or_sd)
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)

    def w(name, transpose=True):
        x = _f32(sd[name])
        x = x.t() if transpose else x
        return x.to(dtype).contiguous().to(dev)

    def norm(name):
        return _f32(sd[name]).contiguous().to(dev)

    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        layers.append({
            "wq": w(p + "self_attn.q_proj.weight"),
            "wk": w(p + "self_attn.k_proj.weight"),
            "wv": w(p + "self_attn.v_proj.weight"),
            "wo": w(p + "self_attn.o_proj.weight"),
            "w_gate": w(p + "mlp.gate_proj.weight"),
            "w_up": w(p + "mlp.up_proj.weight"),
            "w_down": w(p + "mlp.down_proj.weight"),
            "attn_norm": norm(p + "input_layernorm.weight"),
            "mlp_norm": norm(p + "post_attention_layernorm.weight"),
        })
    lm_head = ("lm_head.weight" if "lm_head.weight" in sd
               else "model.embed_tokens.weight")  # tied embeddings
    return {
        "embed": w("model.embed_tokens.weight", transpose=False),
        "layers": layers,
        "final_norm": norm("model.norm.weight"),
        "lm_head": w(lm_head),
    }


def gpt2_params_from_hf(model_or_sd, cfg, dtype=None,
                        device="cuda") -> Params:
    """transformers GPT2LMHeadModel (or its state dict) -> models/gpt2.py
    params on `device`.  GPT-2's Conv1D weights are [in, out] already; the
    fused c_attn [dim, 3 dim] ([Q|K|V] column blocks) is repacked to the
    qkv-major [3, dim, dim] of models/gpt2.py.  The head is tied to wte."""
    sd = _state_dict(model_or_sd)
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)

    def w(name):
        return _f32(sd[name]).to(dtype).contiguous().to(dev)

    def strip(name):  # some dumps prefix "transformer."
        return name if name in sd else "transformer." + name

    layers = []
    for i in range(cfg.n_layers):
        p = (f"h.{i}." if f"h.{i}.ln_1.weight" in sd
             else f"transformer.h.{i}.")
        w_qkv = w(p + "attn.c_attn.weight").reshape(cfg.dim, 3, cfg.dim)
        layers.append({
            "ln1_g": w(p + "ln_1.weight"),
            "ln1_b": w(p + "ln_1.bias"),
            "w_qkv": w_qkv.permute(1, 0, 2).contiguous(),
            "qkv_b": w(p + "attn.c_attn.bias").reshape(3, cfg.dim),
            "w_proj": w(p + "attn.c_proj.weight"),
            "proj_b": w(p + "attn.c_proj.bias"),
            "ln2_g": w(p + "ln_2.weight"),
            "ln2_b": w(p + "ln_2.bias"),
            "w_fc": w(p + "mlp.c_fc.weight"),
            "fc_b": w(p + "mlp.c_fc.bias"),
            "w_out": w(p + "mlp.c_proj.weight"),
            "out_b": w(p + "mlp.c_proj.bias"),
        })
    return {
        "wte": w(strip("wte.weight")),
        "wpe": w(strip("wpe.weight")),
        "final_ln_g": w(strip("ln_f.weight")),
        "final_ln_b": w(strip("ln_f.bias")),
        "layers": layers,
    }
