"""Checkpoints of the PyTorch port against the JAX package's
(tests/test_checkpoint.py's cases, and the files crossing between them).

`save_pytree` / `load_pytree` write and read the JAX package's files
(`.npz` + `.tree.json`, leaves in jax.tree.flatten's order, bf16 and float8
as same-width uints): params round-trip, a leaf-count mismatch raises, bf16
and float8 leaves round-trip bit for bit, a legacy void file is refused,
and a tree of nested dicts, lists and None crosses bit for bit both ways;
an AdamWState saved by JAX resumes in the port.  `save_engine_state` /
`load_engine_state`: the port's engine resumed mid-run gives the
uninterrupted run's tokens (greedy and with seeded temperature), a JAX
engine's greedy state resumed by the port finishes with JAX's
uninterrupted tokens, and a run with the prefix cache, LoRA requests or
stop sequences crosses between the packages both ways with the same
tokens (a request on an adapter the engine lacks raises ValueError).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.models import llama as jllama
from aule_tpu.parallel import optimizer as joptim
from aule_tpu.serving.engine import ServingEngine as JaxEngine
from aule_tpu.serving.engine import load_engine_state as jax_load_engine
from aule_tpu.serving.engine import save_engine_state as jax_save_engine
from aule_tpu.utils import checkpoint as jckpt
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.parallel import optimizer as toptim
from aule_tpu_torch.serving.engine import (ServingEngine, load_engine_state,
                                           save_engine_state)
from aule_tpu_torch.utils import checkpoint as tckpt
from aule_tpu_torch.utils.testing import cap_cpu_threads
from aule_tpu_torch.utils.tree import tree_flatten

cap_cpu_threads()

JCFG = jllama.LlamaConfig.tiny()
TCFG = tllama.LlamaConfig.tiny()
KW = dict(max_batch=2, page_size=16, num_pages=64, max_pages_per_seq=8,
          max_seq_len=256, decode_steps=1)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(JCFG, jax.random.key(0))
    return jp, tllama.load_jax_params(jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(x).reshape(-1).view(np.uint8).tobytes()


def test_params_roundtrip(tmp_path, params):
    _, tp = params
    path = str(tmp_path / "ckpt")
    tckpt.save_pytree(path, tp)
    restored = tckpt.load_pytree(path, tp)
    assert restored.keys() == tp.keys()
    for a, b in zip(tree_flatten(tp), tree_flatten(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_leaf_count_mismatch_raises(tmp_path):
    path = str(tmp_path / "ckpt")
    tckpt.save_pytree(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_pytree(path, {"a": torch.zeros(3), "b": torch.zeros(2)})


def _ml_tree(rng):
    return {
        "bf16": torch.from_numpy(rng.standard_normal((4, 8)).astype(
            np.float32)).to(torch.bfloat16),
        "fp8": torch.from_numpy(rng.standard_normal((4, 8)).astype(
            np.float32)).to(torch.float8_e4m3fn),
        "e5m2": torch.from_numpy(rng.standard_normal((3, 2)).astype(
            np.float32)).to(torch.float8_e5m2),
        "f32": torch.from_numpy(rng.standard_normal((3,)).astype(
            np.float32)),
        "i8": torch.from_numpy(rng.integers(-5, 5, (2, 2)).astype(np.int8)),
    }


def test_ml_dtypes_round_trip_bit_exact(tmp_path):
    """bfloat16 and float8 leaves survive the npz round trip bit for bit,
    stored as same-width uints with their names in the sidecar."""
    tree = _ml_tree(np.random.default_rng(0))
    path = str(tmp_path / "mlq")
    tckpt.save_pytree(path, tree)
    with open(path + ".tree.json") as f:
        names = json.load(f)["dtypes"]
    assert names == ["bfloat16", "float8_e5m2", "float32", "float8_e4m3fn",
                     "int8"]  # sorted keys: bf16, e5m2, f32, fp8, i8
    assert np.load(path + ".npz")["leaf_0"].dtype == np.uint16
    out = tckpt.load_pytree(path, tree)
    for k in tree:
        assert out[k].dtype == tree[k].dtype, k
        assert _bits(out[k]) == _bits(tree[k]), k


def test_legacy_void_checkpoint_rejected(tmp_path):
    """A file whose bf16 leaves a numpy writer degraded to void records,
    without a dtypes sidecar, fails at load."""
    path = str(tmp_path / "legacy")
    np.savez(path + ".npz", leaf_0=np.asarray(jnp.ones((2, 2), jnp.bfloat16)))
    with open(path + ".tree.json", "w") as f:
        json.dump({"num_leaves": 1}, f)
    with pytest.raises(ValueError, match="legacy checkpoint"):
        tckpt.load_pytree(path, {"w": torch.zeros(2, 2)})


def _nested(rng):
    """Nested dicts (keys out of order), lists, a tuple and None leaves."""
    return {
        "z": [rng.standard_normal((2, 3)).astype(np.float32), None,
              {"b": rng.integers(0, 9, (4,)).astype(np.int32),
               "a": (rng.standard_normal((3,)).astype(np.float32), None)}],
        "bf": rng.standard_normal((5, 2)).astype(np.float32),
        "a": None,
        "m": {"y": rng.standard_normal((1, 4)).astype(np.float32),
              "x": rng.integers(-3, 3, (2, 2)).astype(np.int8)},
    }


def _as_jax(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["bf"] = out["bf"].astype(jnp.bfloat16)
    out["m"]["y"] = out["m"]["y"].astype(jnp.float8_e4m3fn)
    return out


def _as_torch(tree):
    out = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    out["bf"] = out["bf"].to(torch.bfloat16)
    out["m"]["y"] = out["m"]["y"].to(torch.float8_e4m3fn)
    return out


def test_jax_file_loads_in_the_port(tmp_path):
    """A nested tree written by the JAX package loads in the port with
    every leaf in its place, bit for bit, None subtrees kept."""
    jtree = _as_jax(_nested(np.random.default_rng(1)))
    path = str(tmp_path / "j")
    jckpt.save_pytree(path, jtree)
    template = _as_torch(_nested(np.random.default_rng(2)))
    got = tckpt.load_pytree(path, template)
    assert got["a"] is None and got["z"][1] is None
    assert got["z"][2]["a"][1] is None
    assert isinstance(got["z"][2]["a"], tuple)
    want = jax.tree.leaves(jtree)
    have = tree_flatten(got)
    assert len(have) == len(want) == 6
    for g, w in zip(have, want):
        assert tuple(g.shape) == w.shape
        assert _bits(g) == _bits(w)
    assert got["bf"].dtype == torch.bfloat16
    assert got["m"]["y"].dtype == torch.float8_e4m3fn


def test_port_file_loads_in_jax(tmp_path):
    ttree = _as_torch(_nested(np.random.default_rng(3)))
    path = str(tmp_path / "t")
    tckpt.save_pytree(path, ttree)
    template = _as_jax(_nested(np.random.default_rng(4)))
    got = jckpt.load_pytree(path, template)
    want = tree_flatten(ttree)
    have = jax.tree.leaves(got)
    assert len(have) == len(want) == 6
    for g, w in zip(have, want):
        assert _bits(g) == _bits(w)
    assert got["bf"].dtype == jnp.bfloat16
    assert got["m"]["y"].dtype == jnp.float8_e4m3fn
    assert got["a"] is None and got["z"][1] is None


def test_jax_adamw_state_resumes_in_the_port(tmp_path, params):
    """JAX's AdamWState (count, mu, nu and an f32 master) after two steps,
    saved with the params by JAX, loads into the port's state in place of
    adamw_init's, leaf for leaf and bit for bit; the port's next step from
    it agrees with JAX's next step (loss within 1e-5, the moments within
    1e-5 of each leaf's largest value)."""
    jp, _ = params
    tokens = np.random.default_rng(5).integers(0, 256, (2, 17)).astype(
        np.int32)
    jstep = joptim.make_adamw_train_step(jllama, JCFG, lr=1e-3)
    jopt = joptim.adamw_init(jp, master_weights=True)
    for _ in range(2):
        jp, jopt, _ = jstep(jp, jopt, jnp.asarray(tokens))
    path = str(tmp_path / "opt")
    jckpt.save_pytree(path, {"params": jp, "opt": jopt})

    tp = tllama.init_params(TCFG, torch.Generator(), device="cpu")
    template = {"params": tp, "opt": toptim.adamw_init(
        tp, master_weights=True)}
    got = tckpt.load_pytree(path, template)
    assert int(got["opt"].count) == 2
    assert got["opt"].count.dtype == torch.int32
    for g, w in zip(tree_flatten(got), jax.tree.leaves(
            {"params": jp, "opt": jopt})):
        assert _bits(g) == _bits(w)
    tstep = toptim.make_adamw_train_step(tllama, TCFG, lr=1e-3)
    _, topt, tloss = tstep(got["params"], got["opt"],
                           torch.from_numpy(tokens).long())
    jp, jopt, jloss = jstep(jp, jopt, jnp.asarray(tokens))
    assert int(topt.count) == int(jopt.count) == 3
    assert abs(float(tloss) - float(jloss)) < 1e-5
    for name in ("mu", "nu"):
        for a, b in zip(tree_flatten(getattr(topt, name)),
                        jax.tree.leaves(getattr(jopt, name))):
            b = np.asarray(b)
            assert float(np.abs(a.numpy() - b).max()) \
                <= 1e-5 * float(np.abs(b).max()), name


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in lens]


def _outputs(eng):
    return [r.output for r in eng.run()]


@pytest.mark.parametrize("chunk", [None, 8])
def test_engine_checkpoint_resume(tmp_path, params, chunk):
    """Save mid-generation, restore into a fresh engine, continue: the
    outputs match the uninterrupted run's exactly (a third request still
    waits for a slot at the save)."""
    _, tp = params
    prompts = _prompts(7, (11, 6, 19))

    def make():
        return ServingEngine(tp, TCFG, device="cpu", prefill_chunk=chunk,
                             **KW)

    eng = make()
    for p in prompts:
        eng.submit(p, max_new_tokens=8)
    want = _outputs(eng)

    eng1 = make()
    for p in prompts:
        eng1.submit(p, max_new_tokens=8)
    for _ in range(3):
        eng1.step()
    assert eng1.waiting  # the third request waits for a slot
    save_engine_state(eng1, str(tmp_path / "ck"))
    eng2 = make()
    load_engine_state(eng2, str(tmp_path / "ck"))
    assert _outputs(eng2) == want
    assert eng2.allocator.num_free == KW["num_pages"] - 1


@pytest.mark.parametrize("qname", ["int8", "split"])
def test_engine_checkpoint_resume_pools(tmp_path, params, qname):
    """The same over an int8 fused pool (payload and packed scales) and
    over split pools."""
    _, tp = params
    kw = (dict(quantized=True) if qname == "int8" else dict(layout="split"))
    prompts = _prompts(8, (9, 14))

    def make():
        return ServingEngine(tp, TCFG, device="cpu", **KW, **kw)

    eng = make()
    for p in prompts:
        eng.submit(p, max_new_tokens=7)
    want = _outputs(eng)
    eng1 = make()
    for p in prompts:
        eng1.submit(p, max_new_tokens=7)
    for _ in range(3):
        eng1.step()
    save_engine_state(eng1, str(tmp_path / "ck"))
    with open(str(tmp_path / "ck.pools.tree.json")) as f:
        names = json.load(f)["dtypes"]
    assert names == (["int8", "bfloat16"] if qname == "int8"
                     else ["float32", "float32"])  # k_pages, k_scales / v_pages
    eng2 = make()
    load_engine_state(eng2, str(tmp_path / "ck"))
    assert _outputs(eng2) == want


def test_engine_checkpoint_preserves_sampling(tmp_path, params):
    """A mixed batch (greedy and two temperatures, one seed): resumed,
    token-identical to the uninterrupted run (the temperatures and the
    generator's state round-trip)."""
    _, tp = params
    prompts = _prompts(9, (9, 13, 7))
    temps = (0.0, 1.3, 0.9)

    def make():
        return ServingEngine(tp, TCFG, device="cpu", sample_seed=3,
                             **dict(KW, max_batch=3))

    eng = make()
    for p, t in zip(prompts, temps):
        eng.submit(p, max_new_tokens=8, temperature=t)
    want = _outputs(eng)
    eng1 = make()
    for p, t in zip(prompts, temps):
        eng1.submit(p, max_new_tokens=8, temperature=t)
    for _ in range(3):
        eng1.step()
    save_engine_state(eng1, str(tmp_path / "ck"))
    eng2 = make()
    load_engine_state(eng2, str(tmp_path / "ck"))
    assert _outputs(eng2) == want


def test_jax_engine_state_resumes_in_the_port(tmp_path, params):
    """A JAX engine's greedy state (tiny f32, the same weights) saved after
    3 steps, resumed by the port's engine, finishes with the JAX engine's
    uninterrupted tokens; every page comes back."""
    jp, tp = params
    prompts = _prompts(11, (11, 6, 19))
    jkw = dict(KW, decode_steps=4)
    jeng = JaxEngine(jp, JCFG, **jkw)
    for p in prompts:
        jeng.submit(p, max_new_tokens=8)
    want = _outputs(jeng)

    jeng1 = JaxEngine(jp, JCFG, **jkw)
    for p in prompts:
        jeng1.submit(p, max_new_tokens=8)
    for _ in range(3):
        jeng1.step()
    jax_save_engine(jeng1, str(tmp_path / "ck"))
    teng = ServingEngine(tp, TCFG, device="cpu", **jkw)
    load_engine_state(teng, str(tmp_path / "ck"))
    assert [r.output for r in teng.slots if r is not None]  # mid-run
    assert _outputs(teng) == want
    assert teng.allocator.num_free == KW["num_pages"] - 1


def _adapter(seed=5, rank=2):
    rng = np.random.default_rng(seed)
    kv = TCFG.n_kv_heads * TCFG.head_dim
    return {"layers": [
        {t: (rng.standard_normal((TCFG.dim, rank)).astype(np.float32) * 0.3,
             rng.standard_normal((rank, kv)).astype(np.float32) * 0.3)
         for t in ("wk", "wv")} for _ in range(TCFG.n_layers)]}


def _feature_case(edit, tp):
    """(engine options, prompts, per-request submit options) of a run that
    uses one serving-edges feature: the prefix cache (two requests on one
    2-page prefix, co-scheduled, a third waiting), LoRA adapters (base and
    adapter requests mixed) or stop sequences taken from the plain greedy
    output, the first ending after the save (with logprobs and a logit
    bias beside them)."""
    if edit == "prefix_cache":
        rng = np.random.default_rng(13)
        base = rng.integers(0, 256, size=32).astype(np.int32)
        prompts = [np.concatenate([base, t]) for t in _prompts(14, (5, 9, 3))]
        return (dict(prefill_chunk=16, enable_prefix_cache=True), prompts,
                [{}, {}, {}])
    prompts = _prompts(15, (11, 6, 19))
    if edit == "lora":
        return (dict(lora_params={"x": _adapter()}), prompts,
                [dict(lora="x"), {}, dict(lora="x")])
    eng = ServingEngine(tp, TCFG, device="cpu", **KW)
    for p in prompts:
        eng.submit(p, max_new_tokens=8)
    base = _outputs(eng)
    return ({}, prompts, [dict(stop=[base[0][4:6]], logprobs=True),
                          dict(logit_bias={3: 1.5}),
                          dict(stop=[base[2][1:2]])])


@pytest.mark.parametrize("edit", ["prefix_cache", "lora", "stop"])
def test_engine_state_with_edges_crosses_packages(tmp_path, params, edit):
    """A run with the prefix cache, LoRA requests or stop sequences saved
    after 3 steps resumes in the other package with the uninterrupted
    run's tokens, both ways: JAX's state finished by the port, the port's
    by JAX (the same JAX engine that ran uninterrupted, its state
    replaced).  The requests' options, logprobs and the cache's maps come
    across; every page comes back."""
    jp, tp = params
    engine_kw, prompts, reqs = _feature_case(edit, tp)
    jkw = dict(KW, **engine_kw)

    def submit(eng):
        for p, r in zip(prompts, reqs):
            eng.submit(p, max_new_tokens=8, **r)
        return eng

    jeng = submit(JaxEngine(jp, JCFG, **jkw))
    want = _outputs(jeng)
    assert want == _outputs(submit(ServingEngine(tp, TCFG, device="cpu",
                                                 **jkw)))
    if edit == "stop":
        assert min(len(o) for o in want) < 8  # a stop sequence ended one
    jeng1 = submit(JaxEngine(jp, JCFG, **jkw))
    for _ in range(3):
        jeng1.step()
    jax_save_engine(jeng1, str(tmp_path / "jax"))
    with open(str(tmp_path / "jax.state.json")) as f:
        host = json.load(f)
    if edit == "prefix_cache":
        assert host["prefix_cache"] and host["prefix_hit_tokens"] == 32
    teng = ServingEngine(tp, TCFG, device="cpu", **jkw)
    load_engine_state(teng, str(tmp_path / "jax"))
    assert teng._prefix_cache == jeng1._prefix_cache
    assert _outputs(teng) == want
    free = teng.allocator.num_free + len(teng._page_rc)
    assert free == KW["num_pages"] - 1

    teng1 = submit(ServingEngine(tp, TCFG, device="cpu", **jkw))
    for _ in range(3):
        teng1.step()
    save_engine_state(teng1, str(tmp_path / "port"))
    jax_load_engine(jeng, str(tmp_path / "port"))
    got = jeng.run()
    assert [r.output for r in got] == want
    if edit == "stop":
        assert len(got[0].logprobs) == len(got[0].output)


def test_lora_request_without_its_adapter_raises(tmp_path, params):
    """A saved request on an adapter the loading engine lacks raises
    ValueError, as JAX's load_engine_state does."""
    _, tp = params
    eng = ServingEngine(tp, TCFG, device="cpu",
                        lora_params={"x": _adapter()}, **KW)
    eng.submit(_prompts(12, (9,))[0], max_new_tokens=6, lora="x")
    eng.step()
    save_engine_state(eng, str(tmp_path / "ck"))
    bare = ServingEngine(tp, TCFG, device="cpu", **KW)
    with pytest.raises(ValueError, match="LoRA adapter"):
        load_engine_state(bare, str(tmp_path / "ck"))
