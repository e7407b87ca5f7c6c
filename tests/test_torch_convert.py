"""HF checkpoint conversion of the PyTorch port (models/convert.py) against
transformers and the JAX package's conversion (tests/test_convert.py's
cases).

Random-init transformers models built from configs in-process (no
download): a GQA Llama and a GPT-2.  The port's forward on the converted
params holds HF's logits within 2e-3; the converted params equal
`load_jax_params` of the JAX package's conversion bit for bit; the port's
engine serving the converted Llama gives HF `generate`'s greedy tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from aule_tpu.models import convert as jconvert  # noqa: E402
from aule_tpu.models import gpt2 as jgpt2  # noqa: E402
from aule_tpu.models import llama as jllama  # noqa: E402
from aule_tpu_torch.models import convert, gpt2, llama  # noqa: E402
from aule_tpu_torch.serving.engine import ServingEngine  # noqa: E402
from aule_tpu_torch.utils.testing import cap_cpu_threads  # noqa: E402
from aule_tpu_torch.utils.tree import tree_flatten  # noqa: E402

cap_cpu_threads()

LLAMA_DIMS = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                  n_kv_heads=2, hidden_dim=96, rope_base=10000.0,
                  norm_eps=1e-5)
GPT2_DIMS = dict(vocab_size=96, n_ctx=64, dim=64, n_layers=2, n_heads=2,
                 norm_eps=1e-5)


def _hf_llama(seed, tie=False):
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        attention_bias=False, tie_word_embeddings=tie)
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(cfg).eval()


def _hf_gpt2(seed):
    cfg = transformers.GPT2Config(
        vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=2,
        layer_norm_epsilon=1e-5)
    torch.manual_seed(seed)
    return transformers.GPT2LMHeadModel(cfg).eval()


def _same_params(port, jax_tree, load):
    want = load(jax.tree.map(np.asarray, jax_tree), device="cpu")
    got, ref = tree_flatten(port), tree_flatten(want)
    assert len(got) == len(ref)
    assert port.keys() == want.keys()
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.is_contiguous()
        assert torch.equal(a, b)


@pytest.mark.parametrize("tie", [False, True])
def test_llama_conversion_matches_hf_and_jax(tie):
    hf = _hf_llama(0, tie)
    cfg = llama.LlamaConfig(dtype=torch.float32, **LLAMA_DIMS)
    params = convert.llama_params_from_hf(hf, cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, 128, size=(2, 17))
    with torch.no_grad():
        want = hf(torch.from_numpy(tokens)).logits.float()
        got = llama.forward(params, torch.from_numpy(tokens), cfg)
    err = float((got - want).abs().max())
    assert err < 2e-3, f"llama conversion logits err {err}"
    jcfg = jllama.LlamaConfig(**LLAMA_DIMS, dtype=jnp.float32)
    _same_params(params, jconvert.llama_params_from_hf(hf, jcfg),
                 llama.load_jax_params)
    # from the state dict too, recast to bf16 (norms stay f32)
    sd = convert.llama_params_from_hf(hf.state_dict(), cfg,
                                      dtype=torch.bfloat16, device="cpu")
    assert sd["layers"][0]["wq"].dtype == torch.bfloat16
    assert sd["final_norm"].dtype == torch.float32
    assert torch.equal(sd["lm_head"], params["lm_head"].to(torch.bfloat16))


def test_gpt2_conversion_matches_hf_and_jax():
    hf = _hf_gpt2(1)
    cfg = gpt2.GPT2Config(dtype=torch.float32, **GPT2_DIMS)
    params = convert.gpt2_params_from_hf(hf, cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, 96, size=(2, 21))
    with torch.no_grad():
        want = hf(torch.from_numpy(tokens)).logits.float()
        got = gpt2.forward(params, torch.from_numpy(tokens), cfg)
    err = float((got - want).abs().max())
    assert err < 2e-3, f"gpt2 conversion logits err {err}"
    jcfg = jgpt2.GPT2Config(**GPT2_DIMS, dtype=jnp.float32)
    _same_params(params, jconvert.gpt2_params_from_hf(hf, jcfg),
                 gpt2.load_jax_params)
    # a bare GPT2Model's state dict (no "transformer." prefix)
    bare = convert.gpt2_params_from_hf(hf.transformer.state_dict(), cfg,
                                       device="cpu")
    for a, b in zip(tree_flatten(bare), tree_flatten(params)):
        assert torch.equal(a, b)


def test_llama_hf_generate_equivalence_through_engine():
    """A converted HF Llama served by the port's engine (prefill, paged
    decode, KV append and sampling) gives transformers' own greedy
    generate() tokens."""
    hf = _hf_llama(3)
    cfg = llama.LlamaConfig(dtype=torch.float32, **LLAMA_DIMS)
    params = convert.llama_params_from_hf(hf, cfg, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, size=n) for n in (7, 12)]
    steps = 6
    eng = ServingEngine(params, cfg, max_batch=2, page_size=16,
                        num_pages=64, max_pages_per_seq=8, max_seq_len=128,
                        device="cpu")
    for p in prompts:
        eng.submit(p.astype(np.int32), max_new_tokens=steps)
    done = eng.run()
    for req, prompt in zip(done, prompts):
        with torch.no_grad():
            out = hf.generate(torch.from_numpy(prompt[None]),
                              max_new_tokens=steps, do_sample=False,
                              num_beams=1)
        assert req.output == out[0, len(prompt):].tolist()


def test_conversion_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = llama.LlamaConfig(dtype=torch.float32, **LLAMA_DIMS)
    with pytest.raises(RuntimeError):
        convert.llama_params_from_hf(_hf_llama(4), cfg)
