"""The one-query split-KV decode of the PyTorch port (csrc/flash_fwd_short.cu
`flash_fwd_decode_kernel`, launched by `ops/flash.py::flash_fwd_decode`)
against the JAX package.

The kernel cuts the keys a lone query sees, [0, kv_len) of a padded
bucket, into ranges by ops/decode_split.py's partition and merges the
ranges' (m, l, O) in split order.  Here, on the CPU: the partition depends
on the shapes only and covers [0, kv_len) exactly for every kv_len of the
bucket; the plain split-and-merge model (`flash_decode_split_plain`)
agrees with aule_tpu's `flash_attention_fwd(..., kv_len=...)` through its
plain reference (as the JAX tests run it on the CPU), with and without
RoPE tables, at kv_len 0, 1, mid and full.  f32 is held to 2e-5: the
merge reorders f32 sums (a few ulps of a row's largest value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.ops.flash import flash_attention_fwd as jax_flash
from aule_tpu_torch.ops import decode_split as ds
from aule_tpu_torch.ops import flash as tflash
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()

F32_ATOL = 2e-5
BUCKET = 256  # a bucket of the SDPA patch's decode, cut small


def _inputs(b, hq, hkv, sk, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("batch,hkv,group,sk", [
    (1, 8, 4, 4096), (1, 8, 3, 4096), (1, 8, 12, 4096), (1, 1, 32, 4096),
    (4, 8, 4, 1024), (2, 2, 1, 300)])
def test_split_plan_from_the_shapes(batch, hkv, group, sk, monkeypatch):
    """The split count and merge buffers come from the shapes and the SM
    count alone (the padded bucket is the capacity, FLASH_TILE_ROWS rows a
    block, a group over 8 in row tiles): never from kv_len."""
    monkeypatch.setattr(ds, "sm_count", lambda device: 132)
    monkeypatch.setattr(ds, "_COUNTERS", {})
    tiles = ds.row_tiles(group, ds.FLASH_TILE_ROWS)
    nsplit, ws, cnt = ds.launch_plan(
        batch, hkv * group, hkv, tflash.decode_keys(sk, False, -1), -1,
        torch.device("cpu", 0), head_dim=128,
        tile_rows=ds.FLASH_TILE_ROWS)
    assert nsplit == ds.num_splits(batch, hkv, sk, -1, 132, tiles)
    assert nsplit == 1 or batch * hkv * tiles * nsplit \
        <= ds.BLOCKS_PER_SM * 132
    if (batch, hkv, group, sk) == (1, 8, 4, 4096):
        assert nsplit == 16  # the Llama bucket: one range per 256 keys
    if nsplit > 1:
        assert ws.numel() == batch * hkv * group * nsplit * 130
        assert cnt.numel() >= batch * hkv * tiles and not cnt.any()


@pytest.mark.parametrize("causal,window,cap", [
    (False, -1, BUCKET), (True, -1, 1), (False, 100, 101),
    (True, 100, 1), (False, 1000, BUCKET)])
@pytest.mark.parametrize("nsplit", [1, 3, 16, 64])
def test_split_ranges_cover_kv_len(causal, window, cap, nsplit):
    """For every kv_len from 0 to Sk, the ranges of split_bounds over the
    keys the query sees (kv_len capped by the causal or window edge of a
    query at position 0) cover [0, n) once each, in split order; empty
    ranges are allowed."""
    assert tflash.decode_keys(BUCKET, causal, window) == cap
    lens = torch.arange(BUCKET + 1).clamp_max(cap)
    lo, hi = ds.split_bounds(lens, cap, -1, nsplit)
    assert lo.shape == (BUCKET + 1, nsplit)
    width = (hi - lo).clamp_min(0)
    assert torch.equal(width.sum(-1), lens)
    # ranges in order, each non-empty one starting where the last ended
    ends = torch.cumsum(width, -1)
    starts = ends - width
    live = width > 0
    assert torch.equal(torch.where(live, lo, 0), torch.where(live, starts, 0))
    assert bool((lo[:, 0] == 0).all())


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("n", [0, 1, 117, BUCKET])
@pytest.mark.parametrize("nsplit", [1, 5, 16])
def test_split_model_matches_jax(rope, n, nsplit):
    """The plain split-and-merge model against JAX's flash_attention_fwd
    with kv_len (and its RoPE tables), B2 Hq8/Hkv2 D64 over a 256-key
    bucket; rows that see nothing (kv_len 0) give zeros and the LSE of the
    mask value in both."""
    q, k, v = _inputs(2, 8, 2, BUCKET, seed=n + 7 * nsplit + rope)
    jkw, tkw = dict(kv_len=jnp.int32(n)), dict(kv_len=torch.tensor(n))
    if rope:
        rng = np.random.default_rng(n)
        ang = rng.uniform(-3, 3, (BUCKET, 32)).astype(np.float32)
        tables = dict(rope_cos=np.cos(ang), rope_sin=np.sin(ang))
        jkw.update({name: jnp.asarray(x) for name, x in tables.items()})
        tkw.update({name: torch.from_numpy(x) for name, x in tables.items()})
    jo, jl = jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                       return_lse=True, **jkw)
    to, tl = tflash.flash_decode_split_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), nsplit=nsplit, **tkw)
    assert to.shape == (2, 8, 1, 64) and tl.shape == (2, 8, 1)
    assert_close(to, np.asarray(jo), 0, F32_ATOL, "out")
    assert_close(tl, np.asarray(jl), 0, F32_ATOL, "lse")
    if n == 0:
        assert not to.any()


@pytest.mark.parametrize("mask", ["causal", "window", "group 12"])
def test_split_model_masks_match_the_plain_forward(mask):
    """The other masks at one query (top-left aligned: causal sees key 0,
    a window keys 0 .. W) and a group over 8 q rows: the split model
    equals the dense plain forward the CPU route runs."""
    hq, hkv = (24, 2) if mask == "group 12" else (8, 2)
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, hq, hkv, BUCKET,
                                                    seed=3))
    kw = dict(causal=mask == "causal",
              window_size=40 if mask == "window" else -1,
              kv_len=torch.tensor(200))
    po, pl = tflash.flash_attention_fwd(q, k, v, **kw)
    so, sl = tflash.flash_decode_split_plain(q, k, v, nsplit=7, **kw)
    assert_close(so, po, 0, F32_ATOL, "out")
    assert_close(sl, pl, 0, F32_ATOL, "lse")


def test_decode_launcher_takes_only_cuda_tensors():
    """The decode's launcher raises on CPU tensors (no CPU route) and on
    more than one query, and counts nothing."""
    before = tflash.flash_fwd_decode.launches
    q = torch.zeros(1, 4, 1, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tflash.flash_fwd_decode(q, k, k)
    with pytest.raises(ValueError):
        tflash.flash_fwd_decode(torch.zeros(1, 4, 2, 128,
                                            dtype=torch.bfloat16), k, k)
    assert tflash.flash_fwd_decode.launches == before
