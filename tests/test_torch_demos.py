"""The port's demos and scaling report (aule_tpu_torch/examples/,
aule_tpu_torch/scripts/scaling_report.py) on the CPU.

  * serve_demo: on JAX's weights (carried by `load_jax_params`) the greedy
    request's tokens, the prefix cache's hit tokens, the speculative run's
    tokens and its drafted / accepted counts equal JAX's engine on the
    JAX demo's configuration (int8 pools in interpret mode); the sampled
    request stays in the vocabulary and both requests streamed every
    token.
  * train_demo on a (2, 2) mesh: its 6 losses against the same schedule's
    one-process AdamW steps within BF16_LOSS_TOL (the demo's model is
    bf16: the tensor-parallel ranks sum bf16 partial products, so the
    ZeRO-1 tests' f32 limits do not apply), and the step resumed from the
    checkpoint equal to a seventh step without it, bit for bit.
  * scaling_report: at 1 and 2 in-process replicas every request's tokens
    equal a direct engine's; the process mode over TCP starts 2 workers
    and gives the direct engine's tokens.
"""

import jax
import numpy as np
import pytest
import torch

from aule_tpu.models import llama as jllama
from aule_tpu.serving.engine import ServingEngine as JEngine
from aule_tpu_torch.examples import serve_demo, train_demo
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.parallel.optimizer import (adamw_init,
                                               make_adamw_train_step)
from aule_tpu_torch.scripts import scaling_report
from aule_tpu_torch.serving.engine import ServingEngine
from aule_tpu_torch.utils.testing import cap_cpu_threads

cap_cpu_threads()

# bf16's unit roundoff, relative to the loss: the sharded and the
# one-process bf16 forwards round their partial sums apart
BF16_LOSS_TOL = 2.0 ** -8


def _jax_serve_demo(params, draft_params):
    """The JAX demo's two engines (examples/serve_demo.py:33-83) on the
    given weights; the sampled request is left out (the packages draw
    from different generators)."""
    cfg = jllama.LlamaConfig.tiny()
    a, b = serve_demo.prompts()
    eng = JEngine(params, cfg, **serve_demo.ENGINE_KW, prefill_chunk=16,
                  enable_prefix_cache=True, quantized=True)
    eng.submit(a, max_new_tokens=6)
    eng.submit(b, max_new_tokens=6, temperature=1.2)
    greedy = [r.output for r in eng.run() if r.temperature == 0]
    spec = JEngine(params, cfg, **serve_demo.ENGINE_KW,
                   draft_params=draft_params,
                   draft_cfg=jllama.LlamaConfig.tiny(**serve_demo.DRAFT_CFG),
                   spec_tokens=3)
    spec.submit(a, max_new_tokens=12)
    return dict(greedy=greedy[0], hits=eng.prefix_cache_hit_tokens,
                spec=spec.run()[0].output, accepted=spec.spec_accepted,
                drafted=spec.spec_drafted)


def test_serve_demo_matches_jax():
    jparams = jllama.init_params(jllama.LlamaConfig.tiny(), jax.random.key(0))
    jdraft = jllama.init_params(jllama.LlamaConfig.tiny(
        **serve_demo.DRAFT_CFG), jax.random.key(1))
    want = _jax_serve_demo(jparams, jdraft)
    got = serve_demo.main(
        device="cpu",
        params=tllama.load_jax_params(jax.tree.map(np.asarray, jparams),
                                      device="cpu"),
        draft_params=tllama.load_jax_params(
            jax.tree.map(np.asarray, jdraft), device="cpu"))
    greedy, sampled = got["requests"]
    assert greedy.temperature == 0 and sampled.temperature == 1.2
    assert greedy.output == want["greedy"]
    assert got["prefix_cache_hit_tokens"] == want["hits"] == 32
    assert got["spec_requests"][0].output == want["spec"]
    assert (got["spec_accepted"], got["spec_drafted"]) == \
        (want["accepted"], want["drafted"])
    assert got["spec_requests"][0].output[:6] == greedy.output
    assert len(sampled.output) == 6 and all(
        0 <= t < got["cfg"].vocab_size for t in sampled.output)
    assert got["streamed"] == {0: greedy.output, 1: sampled.output}


def test_train_demo_matches_one_process_adamw():
    got = train_demo.main(mesh_shape=(2, 2), device="cpu")
    cfg = train_demo.demo_cfg()
    params = train_demo.demo_params()
    opt = adamw_init(params, master_weights=True)
    step = make_adamw_train_step(tllama, cfg, None,
                                 lr=train_demo.lr_schedule, **train_demo.OPT)
    tokens = train_demo.demo_tokens()
    want = []
    for _ in range(train_demo.STEPS + 1):
        params, opt, loss = step(params, opt, tokens)
        want.append(float(loss))
    assert len(got["losses"]) == train_demo.STEPS
    for i, (a, b) in enumerate(zip(got["losses"] + [got["seventh_loss"]],
                                   want)):
        assert abs(a - b) <= BF16_LOSS_TOL * abs(b), (i, a, b)
    assert got["losses"][-1] < got["losses"][0]
    assert got["resumed_loss"] == got["seventh_loss"]
    assert got["resumed_equal"]


def _direct(prompts, cfg, params, new_tokens, kw):
    eng = ServingEngine(params, cfg, device="cpu", **kw)
    ids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    done = {r.req_id: list(r.output) for r in eng.run()}
    return [done[i] for i in ids]


def test_scaling_report_replicas_give_the_direct_engine_tokens():
    argv = ["--device", "cpu", "--requests", "5", "--new-tokens", "6",
            "--layers", "2", "--replicas", "1", "2"]
    got = scaling_report.main(argv)
    dev = torch.device("cpu")
    cfg = scaling_report.report_cfg(2, dev)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tllama.init_params(cfg, gen, device="cpu")
    want = _direct(scaling_report.report_prompts(5), cfg, params, 6,
                   scaling_report.POOL_KW)
    for n in (1, 2):
        assert got[n]["outputs"] == want, n
        assert got[n]["tokens"] == 30 and got[n]["tok_s"] > 0


def test_scaling_report_processes_over_tcp():
    got = scaling_report.main(["--device", "cpu", "--processes",
                               "--transport", "tcp", "--replicas", "2",
                               "--requests", "4", "--new-tokens", "4"])
    assert got[2]["workers"] == [0, 1]
    assert got[2]["outputs"] == got["direct"]["outputs"]
    assert got[2]["tokens"] == got["direct"]["tokens"] == 16


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: the default is valid")
def test_demos_raise_without_a_card():
    with pytest.raises(RuntimeError):
        serve_demo.main()
    with pytest.raises(RuntimeError):
        train_demo.main()
    with pytest.raises(RuntimeError):
        scaling_report.main([])
