"""Tensor-parallel Llama steps of the PyTorch port against the JAX
package's (the tensor-parallel engine: tests/test_torch_tp_engine.py).

The tiny f32 Llama's steps with `mesh=` (`forward` and its gradients,
`decode_step`, `decode_step_fused` over f32 and int8 pools,
`prefill_step_fused` with every position's logits) on (1, 2) and (2, 2)
meshes.  The port runs in two spawned gloo worlds (2 and 4 CPU ranks,
utils/testing.py's `run_world`, each rank on its shards), JAX on the
conftest's virtual CPU devices, both from the same params and seeded
numpy inputs.  Every step agrees with the port's single-device step,
and with JAX's mesh step for one case of each kind (JAX's one-device
step for the others: JAX's own tests hold its mesh steps to those),
within 2e-5 (pools too; the int8 dot-product
decode's logits within 4e-2 of JAX's, whose kernel quantizes p over
other token spans); the gradients through forward(mesh=) agree with
JAX's and the port's one-device ones within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.models import llama as jllama
from aule_tpu.ops.paged_fused import fused_pool_shape, to_fused_layout
from aule_tpu.ops.quant import quantize_kv
from aule_tpu.parallel.mesh import make_mesh
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.models.llama import _to_torch
from aule_tpu_torch.serving.engine import ServingEngine
from aule_tpu_torch.utils.testing import (assert_close, cap_cpu_threads,
                                          run_world, single_rank_world,
                                          tp_cases)

cap_cpu_threads()

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 (virtual) devices")

JCFG = jllama.LlamaConfig.tiny()
TCFG = tllama.LlamaConfig.tiny()
TOL = 2e-5
INT8_DOT_TOL = 4e-2
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
NAMES = ("data", "model")
KW = dict(max_batch=2, page_size=16, num_pages=64, max_pages_per_seq=8,
          max_seq_len=256)
SPLIT_POOL = ("model", None, None, None)
FUSED_POOL = (None, None, "model", None, None)
FUSED_SCALES = (None, None, "model")
PAGE, NUM_PAGES, MAX_PAGES = 16, 8, 2


def _t(a):
    return _to_torch(np.asarray(a), "cpu", None)


def _jparams(cfg, seed):
    return jllama.init_params(cfg, jax.random.key(seed))


def _tparams(jp):
    return tllama.load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


# ---- the steps' inputs (numpy), shared by both packages

def _rope():
    c = np.cos(np.ones((64, TCFG.head_dim // 2))).astype(np.float32)
    return c, np.sin(np.ones((64, TCFG.head_dim // 2))).astype(np.float32)


def _tables():
    bt = np.arange(2 * MAX_PAGES, dtype=np.int32).reshape(2, MAX_PAGES) + 1
    return bt, np.array([5, 12], np.int32)


def _split_pools(seed):
    r = np.random.default_rng(seed)
    shape = (TCFG.n_kv_heads, NUM_PAGES, PAGE, TCFG.head_dim)
    return ([r.standard_normal(shape).astype(np.float32)
             for _ in range(TCFG.n_layers)],
            [r.standard_normal(shape).astype(np.float32)
             for _ in range(TCFG.n_layers)])


def _fused_pools(seed, tp=1, quantized=False):
    """Per-layer fused pools [P, 2, Hkv, page, Dpad]; quantized: int8
    payloads with scale tiles packed per shard of `tp` (each shard's 128
    lanes hold its local heads: JAX's fused_scales_shape(..., tp=))."""
    kp, vp = _split_pools(seed)
    if not quantized:
        return [np.asarray(to_fused_layout(jnp.asarray(k), jnp.asarray(v)))
                for k, v in zip(kp, vp)], None
    pools, scales = [], []
    h = TCFG.n_kv_heads // tp
    for k, v in zip(kp, vp):
        parts = []
        for s in range(tp):
            kq, ks = quantize_kv(jnp.asarray(k[s * h:(s + 1) * h]), jnp.int8)
            vq, vs = quantize_kv(jnp.asarray(v[s * h:(s + 1) * h]), jnp.int8)
            parts.append(to_fused_layout(kq, vq, ks, vs))
        pools.append(np.concatenate([np.asarray(p[0]) for p in parts], 2))
        scales.append(np.concatenate(
            [np.asarray(p[1].astype(jnp.float32)) for p in parts], -1))
    return pools, scales


def _step_inputs(name, tp):
    """(JAX args, JAX kwargs, port args, port out_specs) of a step."""
    rng = np.random.default_rng(3)
    token = rng.integers(0, 256, size=2).astype(np.int32)
    positions = np.array([5, 12], np.int32)
    bt, lens = _tables()
    cos, sin = _rope()
    if name == "forward":
        tokens = rng.integers(0, 256, size=(2, 12)).astype(np.int32)
        return ((tokens, JCFG), {}, [_t(tokens).long(), TCFG], [None])
    if name == "decode_step":
        kp, vp = _split_pools(4)
        j = (token, positions, kp, vp, bt, lens, JCFG, cos, sin)
        t = [_t(token).long(), _t(positions).long(),
             {"shard": [_t(a) for a in kp], "spec": SPLIT_POOL},
             {"shard": [_t(a) for a in vp], "spec": SPLIT_POOL},
             _t(bt), _t(lens), TCFG, _t(cos), _t(sin)]
        return j, {}, t, [None, SPLIT_POOL, SPLIT_POOL, None]
    if name.startswith("decode_step_fused"):
        quantized = name.endswith("int8")
        pools, scales = _fused_pools(5, tp, quantized)
        j = (token, positions, pools, bt, lens, JCFG, cos, sin)
        t = [_t(token).long(), _t(positions).long(),
             {"shard": [_t(a) for a in pools], "spec": FUSED_POOL},
             _t(bt), _t(lens), TCFG, _t(cos), _t(sin)]
        specs = [None, FUSED_POOL, None]
        if quantized:
            bf16 = [_t(a).to(torch.bfloat16) for a in scales]
            t.append({"shard": bf16, "spec": FUSED_SCALES})
            specs.append(FUSED_SCALES)
            return (j + ([jnp.asarray(a, jnp.bfloat16) for a in scales],),
                    {}, t, specs)
        return j, {}, t, specs
    assert name == "prefill_step_fused"
    pools, _ = _fused_pools(6)
    tokens = rng.integers(0, 256, size=(2, 8)).astype(np.int32)
    q_off = np.array([5, 12], np.int32)
    seq_lens = np.array([8, 8], np.int32)
    j = (tokens, q_off, seq_lens, pools, bt, JCFG, cos, sin)
    t = [_t(tokens).long(), _t(q_off), _t(seq_lens),
         {"shard": [_t(a) for a in pools], "spec": FUSED_POOL}, _t(bt),
         TCFG, _t(cos), _t(sin)]
    return j, {"all_logits": True}, t, [None, FUSED_POOL, None]


STEPS = ("forward", "decode_step", "decode_step_fused",
         "decode_step_fused_int8", "prefill_step_fused")
# every step on both meshes but int8's on (1, 2) alone: the (2, 2) mesh
# adds a data axis, which the pools' layout does not see
STEP_CASES = [(step, m) for step in STEPS for m in MESHES
              if not (step.endswith("int8") and m == "2x2")]


# the cases held to JAX's step on the same mesh, one of each kind; the
# others are held to JAX's one-device step (scale tiles packed per shard
# compared as one device packs them), which spares the tier minutes of
# JAX's interpret-mode kernels under shard_map
JAX_MESH_CASES = {("forward", "1x2"), ("decode_step", "2x2"),
                  ("decode_step_fused", "1x2"),
                  ("prefill_step_fused", "1x2")}


def _one_device_lanes(sc, tp):
    """Scale tiles packed per shard ([..., tp*128]: shard s's 128 lanes
    hold its local heads at kv*64 + h) as one device packs them
    ([..., 128], lane kv*64 + s*Hkv/tp + h)."""
    h = TCFG.n_kv_heads // tp
    out = torch.zeros(sc.shape[:-1] + (128,), dtype=sc.dtype)
    for r in range(tp):
        for kv in (0, 64):
            out[..., kv + r * h:kv + (r + 1) * h] = \
                sc[..., r * 128 + kv:r * 128 + kv + h]
    return out


def _fn_name(step):
    return "decode_step_fused" if step.startswith("decode_step_fused") \
        else step


@pytest.fixture(scope="module")
def jparams():
    return _jparams(JCFG, 0)


@pytest.fixture(scope="module")
def worlds(jparams):
    """The port's side: the (1, 2) steps and the gradients in a world of
    2, the (2, 2) steps in a world of 4.  {("step", mesh, name) |
    ("grads",): result}."""
    tp = _tparams(jparams)
    out = {}
    for mesh_name, world in (("1x2", 2), ("2x2", 4)):
        shape = MESHES[mesh_name]
        keys, cases = [], []
        for step, m in STEP_CASES:
            if m != mesh_name:
                continue
            _, kw, args, specs = _step_inputs(step, shape[1])
            keys.append(("step", mesh_name, step))
            cases.append(dict(kind="step", mesh=(shape, NAMES), params=tp,
                              cfg=TCFG, fn=_fn_name(step), args=args,
                              kwargs=kw, out_specs=specs))
        if mesh_name == "1x2":
            tokens, weights = _grad_inputs()
            keys.append(("grads",))
            cases.append(dict(kind="grads", mesh=(shape, NAMES), params=tp,
                              cfg=TCFG, tokens=torch.from_numpy(tokens),
                              weights=torch.from_numpy(weights)))
        got = run_world(tp_cases, world, cases)[0]
        out.update(zip(keys, got))
    return out


def _grad_inputs():
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 256, size=(2, 12)).astype(np.int64)
    weights = rng.standard_normal((2, 12, TCFG.vocab_size)).astype(
        np.float32)
    return tokens, weights


def _jax_step(step, jp, mesh):
    j, kw, _, _ = _step_inputs(step, mesh.shape["model"] if mesh else 1)
    j = tuple(jnp.asarray(a) if isinstance(a, np.ndarray)
              else [jnp.asarray(x) for x in a] if isinstance(a, list) else a
              for a in j)
    fn = getattr(jllama, _fn_name(step))
    if mesh is None:
        return fn(jp, *j, **kw)
    return fn(jp, *j, mesh=mesh, **kw)


def _torch_step_single(step, tp):
    """The port's single-device step on the full pools (scale tiles packed
    for one device)."""
    _, kw, args, _ = _step_inputs(step, 1)
    args = [[t.clone() for t in a["shard"]] if isinstance(a, dict) else a
            for a in args]
    out = getattr(tllama, _fn_name(step))(tp, *args, **kw)
    return out if isinstance(out, tuple) else (out,)


def _jmesh(shape):
    n = shape[0] * shape[1]
    return make_mesh(shape, NAMES, devices=jax.devices()[:n])


@pytest.mark.parametrize("step,mesh_name", STEP_CASES)
def test_tp_step_matches_jax(worlds, jparams, step, mesh_name):
    """The port's step on the mesh against JAX's on the same mesh
    (JAX_MESH_CASES) or JAX's one-device step, and against the port's
    one-device step."""
    jp = jparams
    got = worlds[("step", mesh_name, step)]
    jmesh = (_jmesh(MESHES[mesh_name])
             if (step, mesh_name) in JAX_MESH_CASES else None)
    jout = _jax_step(step, jp, jmesh)
    jout = jout if isinstance(jout, tuple) else (jout,)
    single = _torch_step_single(step, _tparams(jp))
    for i, (g, j, s) in enumerate(zip(got, jout, single)):
        if isinstance(g, list):
            for li, (gl, jl, sl) in enumerate(zip(g, j, s)):
                jl = np.asarray(jnp.asarray(jl).astype(jnp.float32))
                one = (gl if gl.shape == sl.shape else
                       _one_device_lanes(gl, MESHES[mesh_name][1]))
                # int8 decode: layer 1's appends follow layer 0's int8
                # dot-product output, which is JAX's within 4e-2 only
                if li == 0 or not step.endswith("int8"):
                    assert_close((one if jmesh is None else gl).float(), jl,
                                 0, TOL, f"{step} out {i}.{li}")
                assert_close(one.float(), sl.float(), 0, TOL,
                             f"{step} out {i}.{li} vs one device")
        elif isinstance(g, torch.Tensor):
            # the int8 dot-product decode quantizes p over other token
            # spans than JAX's kernel (4e-2, as tests/test_torch_llama.py)
            tol = INT8_DOT_TOL if step.endswith("int8") and i == 0 else TOL
            assert_close(g, np.asarray(j), 0, tol, f"{step} out {i}")
            assert_close(g, s, 0, TOL, f"{step} out {i} vs one device")


def test_tp_forward_grads(worlds, jparams):
    """Gradients through forward(mesh=) on (1, 2): every parameter's,
    all-gathered, equals the one-device port's and JAX's jax.grad of its
    forward (replicated inputs enter the rank's columns with their
    gradients summed over the ranks once; wo's and w_down's all-reduce
    passes the cotangent through)."""
    jp = jparams
    tokens, weights = _grad_inputs()
    got = worlds[("grads",)]
    tp = _tparams(jp)
    leaves = [tp["embed"], tp["final_norm"], tp["lm_head"]] + [
        t for layer in tp["layers"] for t in layer.values()]
    for t in leaves:
        t.requires_grad_(True)
    (tllama.forward(tp, torch.from_numpy(tokens), TCFG)
     * torch.from_numpy(weights)).sum().backward()
    jg = jax.grad(lambda p: jnp.sum(jllama.forward(
        p, jnp.asarray(tokens, jnp.int32), JCFG) * weights))(jp)
    for k in ("embed", "final_norm", "lm_head"):
        assert_close(got[k], tp[k].grad, 1e-4, 1e-4, f"d{k} vs one device")
        assert_close(got[k], np.asarray(jg[k]), 1e-4, 1e-4, f"d{k} vs JAX")
    for li, (g, t, j) in enumerate(zip(got["layers"], tp["layers"],
                                       jg["layers"])):
        for k in t:
            assert_close(g[k], t[k].grad, 1e-4, 1e-4, f"layer {li} d{k}")
            assert_close(g[k], np.asarray(j[k]), 1e-4, 1e-4,
                         f"layer {li} d{k} vs JAX")


def test_tp_refusals(jparams):
    """What the port's TP engine refuses, in one process (a world of one
    rank, a (1, 1) mesh): multi-LoRA with a mesh, as JAX's, in every
    family; a model step with LoRA adapters under a mesh; a draft family
    outside the port (the GPT-2 and MoE meshes are served:
    tests/test_torch_gpt2_tp.py)."""
    from aule_tpu_torch.models import gpt2, moe
    from aule_tpu_torch.parallel.mesh import make_mesh

    tp = _tparams(jparams)
    families = [(tllama, TCFG, tp)] + [
        (fam, cfg, fam.init_params(cfg, torch.Generator(), device="cpu"))
        for fam, cfg in ((gpt2, gpt2.GPT2Config.tiny()),
                         (moe, moe.MoEConfig.tiny()))]
    with single_rank_world():
        mesh = make_mesh((1, 1), NAMES, "cpu")
        for fam, cfg, params in families:
            with pytest.raises(ValueError, match="multi-LoRA"):
                ServingEngine(params, cfg, device="cpu", model=fam,
                              mesh=mesh, lora_params={"a": {"layers": []}},
                              **KW)
        with pytest.raises(NotImplementedError, match="LoRA"):
            tllama.forward(tp, torch.zeros((1, 4), dtype=torch.long), TCFG,
                           mesh=mesh, lora={"layers": []},
                           lora_idx=torch.zeros((1,), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="draft_model"):
        ServingEngine(tp, TCFG, device="cpu", mesh=object(),
                      draft_params=tp, draft_cfg=TCFG, draft_model=jllama,
                      spec_tokens=2, **KW)
