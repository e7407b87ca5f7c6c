"""The f32-q paged decode's partition (csrc/paged_generic.cuh) on the CPU.

The kernel cuts each (sequence, kv head, row tile)'s live tokens into
split ranges (ops/decode_split.py `split_bounds`), each range into tiles of
TILE_TOKENS tokens dealt to its block's WARPS warps in turn; each warp
keeps its own (m, l, acc), the warps merge in warp order and the splits in
split order.  A plain model of that partition (`warp_split_merge`) is held
to aule_tpu's Pallas decode in interpret mode at f32 2e-5, and in the int8
dot-product mode to the port's plain version `_int8_dot_plain`; every
DECODE_SPAN span of a range lies in one warp's tile; the split count
follows `generic_blocks_per_sm`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.ops import paged_fused as jpf
from aule_tpu_torch.ops import _build
from aule_tpu_torch.ops import decode_split as ds
from aule_tpu_torch.ops import paged_fused as tpf
from aule_tpu_torch.ops import paged_generic as pg
from aule_tpu_torch.ops.quant import quantize_kv
from aule_tpu_torch.ops.reference import _expand_kv, _gather_pages
from aule_tpu_torch.utils.testing import assert_close, cap_cpu_threads

cap_cpu_threads()

HKV, PAGE, MAX_PAGES = 2, 16, 8
# the kernel's block by head dim (csrc/paged_generic.cuh Geo<D>): its
# warps, and the tokens of a warp's tile (a multiple of DECODE_SPAN)
WARPS = {64: 4, 128: 4, 256: 8}
TILE_TOKENS = {64: 16, 128: 8, 256: 4}
# contexts 0, 1, 5 and 17, and two that run every warp of a D64 block
# through more than one tile (7 and 8 tiles of 16 in one range)
LENS = (0, 1, 5, 17, 100, 128)


def _case(seed, d, hq, quantized=False):
    """Head-major K/V of LENS tokens per sequence on shuffled pages (page 0
    scratch garbage, -1 table entries past the used pages), q, and the
    fused pool of the same values (int8 with f32 scales if `quantized`)."""
    rng = np.random.default_rng(seed)
    used = [-(-n // PAGE) for n in LENS]
    num_pages = 1 + sum(used)
    k = rng.standard_normal((HKV, num_pages, PAGE, d)).astype(np.float32)
    v = rng.standard_normal((HKV, num_pages, PAGE, d)).astype(np.float32)
    k[:, 0] = v[:, 0] = 1e3
    q = rng.standard_normal((len(LENS), hq, d)).astype(np.float32)
    bt = np.full((len(LENS), MAX_PAGES), -1, np.int32)
    ids = rng.permutation(np.arange(1, num_pages))
    at = 0
    for b, n in enumerate(used):
        bt[b, :n] = ids[at:at + n]
        at += n
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if quantized:
        (kq, ks), (vq, vs) = (quantize_kv(x, torch.int8) for x in (kt, vt))
        pool, sc = tpf.to_fused_layout(kq, vq, ks, vs,
                                       scale_dtype=torch.float32)
    else:
        pool, sc = tpf.to_fused_layout(kt, vt), None
    return (torch.from_numpy(q), kt, vt, torch.from_numpy(bt),
            torch.tensor(LENS, dtype=torch.int32), pool, sc)


def warp_of(pos, lo, d):
    """The warp of a block whose range starts at `lo` that takes the token
    at `pos` (pos >= lo): tile j of the range goes to warp j % WARPS."""
    return torch.div(pos - lo, TILE_TOKENS[d], rounding_mode="floor") \
        % WARPS[d]


def _state(scores, keep, partial):
    """(m, l, acc) over the scores where `keep` (m = -inf where none):
    (l, acc) = partial(p, keep) of p = exp(scores - m) there."""
    m = torch.where(keep, scores, -torch.inf).amax(dim=-1)
    m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.where(keep, torch.exp(scores - m_safe[..., None]),
                    torch.zeros_like(scores))
    return (m,) + tuple(partial(p, keep))


def warp_split_merge(scores, valid, lo, hi, partial, d):
    """ds.split_merge with the block's warps: each split range's tokens go
    to its warps by `warp_of`, each warp's (m, l, acc) over its tokens
    alone, merged in warp order into the range's (m, sum c l, sum c acc),
    c = exp(m_w - m); then the ranges merge in split order
    (ds.merge_partials)."""
    pos = torch.arange(scores.shape[-1])
    ranges = []
    for s in range(lo.shape[1]):
        start = lo[:, s, None, None]
        keep = valid & (pos >= start) & (pos < hi[:, s, None, None])
        warp = warp_of(pos, start, d)
        m, l, acc = (torch.stack(x, -1) for x in zip(*(
            _state(scores, keep & (warp == w), partial)
            for w in range(WARPS[d]))))
        big = m.amax(-1)
        c = torch.where(torch.isinf(m), torch.zeros_like(m),
                        torch.exp(m - torch.where(torch.isinf(big), 0.0,
                                                  big)[..., None]))
        ranges.append((big, (l * c).sum(-1), (acc * c[..., None, :]).sum(-1)))
    m, l, acc = zip(*ranges)
    return ds.merge_partials(torch.stack(m, -1), torch.stack(l, -1),
                             torch.stack(acc, -2))


def _valid(lens, capacity, window):
    pos = torch.arange(capacity)[None, None, :]
    n = lens.long()[:, None, None]
    keep = pos < n
    return keep & ((n - 1 - pos) < window) if window > 0 else keep


def _model_f32(q, k, v, bt, lens, window, nsplit):
    """The kernel's arithmetic order in plain PyTorch: f32 scores, then the
    splits' ranges, each cut among the block's warps, merged in warp
    order, then in split order."""
    hq, d = q.shape[1], q.shape[2]
    kg = _expand_kv(_gather_pages(k, bt), hq)
    vg = _expand_kv(_gather_pages(v, bt), hq)
    scores = torch.einsum("bhd,bhkd->bhk", q, kg) / d ** 0.5
    cap = kg.shape[2]
    lo, hi = ds.split_bounds(lens, cap, window, nsplit)
    return warp_split_merge(
        scores, _valid(lens, cap, window), lo, hi,
        lambda p, keep: (p.sum(-1), torch.einsum("bhk,bhkd->bhd", p, vg)),
        d)


_JAX = {}


@pytest.mark.parametrize("nsplit", [1, 3])
@pytest.mark.parametrize("window", [-1, 21])
@pytest.mark.parametrize("d,group", [(64, 1), (64, 4), (128, 4),
                                     (256, 8)])
def test_warp_partition_model_against_jax(d, group, window, nsplit):
    """The model of the kernel's partition (splits, the warps' tiles within
    a split, merged in warp order and then in split order) against JAX's
    paged_attention_fused in interpret mode at f32 2e-5: GPT-2's head dim
    at groups 1 and 4, the Llama layer's D128 group 4 and D256 group 8,
    with contexts 0, 1, 5 and 17, with and without a trailing window."""
    q, k, v, bt, lens, pool, _ = _case(40 + d + group, d, HKV * group)
    key = (d, group, window)
    if key not in _JAX:
        _JAX[key] = jpf.paged_attention_fused(
            jnp.asarray(q.numpy()), jnp.asarray(pool.numpy()),
            jnp.asarray(bt.numpy()), jnp.asarray(lens.numpy()),
            window_size=window, return_lse=True)
    jo, jl = _JAX[key]
    out, lse = _model_f32(q, k, v, bt, lens, window, nsplit)
    assert_close(out, np.asarray(jo), 0, 2e-5, "out")
    assert_close(lse, np.asarray(jl), 0, 2e-5, "lse")
    assert (out[0] == 0).all()  # context 0
    # the port's plain version of the wrapper, one range per split
    po, pl = tpf.paged_attention_fused_plain(
        q, pool, bt, lens, window_size=window, return_lse=True,
        nsplit=nsplit)
    assert_close(out, po, 0, 1e-5, "out against the plain version")
    assert_close(lse, pl, 0, 1e-5, "lse against the plain version")


def _model_int8_dot(q, pool, sc, bt, lens, window, nsplit):
    """The int8 dot-product arithmetic of the kernel (as `_int8_dot_plain`:
    q codes per row, exact integer scores times qf and the K scale, p times
    the V scale quantized over DECODE_SPAN tokens from t_lo) over the
    warps' partition: p taken against each warp's max, as the kernel
    takes it against its warp's running max."""
    hq, d = q.shape[1], q.shape[2]
    hkv = pool.shape[2]
    q_i8, qscale = quantize_kv(tpf._pad_last(q, pool.shape[-1]), torch.int8)
    qf = qscale / d ** 0.5
    k_i8 = _expand_kv(_gather_pages(pool[:, 0].transpose(0, 1), bt).float(),
                      hq)
    v_i8 = _expand_kv(_gather_pages(pool[:, 1].transpose(0, 1), bt).float(),
                      hq)
    ks, vs = tpf.unpack_fused_scales(sc, hkv)
    kf = _expand_kv(_gather_pages(ks[..., None], bt)[..., 0], hq)
    vf = _expand_kv(_gather_pages(vs[..., None], bt)[..., 0], hq)
    scores = torch.einsum("bhd,bhkd->bhk", q_i8.float(), k_i8) \
        * qf[..., None] * kf
    cap = scores.shape[-1]
    pos = torch.arange(cap)[None, None, :]
    n = lens.long()[:, None, None]
    t_lo = (n - window).clamp_min(0) if window > 0 else torch.zeros_like(n)

    def span_pv(p, keep):
        p3 = p * vf
        span = ((pos - t_lo).clamp_min(0) // ds.DECODE_SPAN).expand_as(p3)
        pm = torch.zeros(p3.shape[:-1] + (cap // ds.DECODE_SPAN + 2,)
                         ).scatter_reduce(-1, span, p3, reduce="amax")
        pm_tok = pm.gather(-1, span)
        r = torch.where(pm_tok > 0, 127.0 / pm_tok, torch.zeros_like(pm_tok))
        w = torch.floor(p3 * r + 0.5) * (pm_tok * (1.0 / 127.0))
        return p.sum(-1), torch.einsum("bhk,bhkd->bhd", w, v_i8)

    lo, hi = ds.split_bounds(lens, cap, window, nsplit)
    out, lse = warp_split_merge(scores, _valid(lens, cap, window), lo, hi,
                                span_pv, d)
    return out[..., :d], lse


@pytest.mark.parametrize("nsplit", [1, 3])
@pytest.mark.parametrize("window", [-1, 21])
@pytest.mark.parametrize("d,group", [(64, 1), (64, 4)])
def test_warp_partition_model_int8_dot(d, group, window, nsplit):
    """The same partition in the int8 dot-product mode against the port's
    plain version `_int8_dot_plain` (one range per split).  The two
    quantize p * V scale per span against other maxima (a warp's against
    a split's), so a code may flip where p * 127 / max sits at a rounding
    tie; one flip moves an output by one code step of its span, at most
    max|V| / 127 (V dequantized), which is the tolerance: below the 4e-2
    that tests/test_torch_paged_fused.py holds the int8 dot path to."""
    q, _, v, bt, lens, pool, sc = _case(60 + group, d, HKV * group,
                                        quantized=True)
    out, lse = _model_int8_dot(q, pool, sc, bt, lens, window, nsplit)
    po, pl = tpf._int8_dot_plain(q, pool, sc, bt, lens, d ** -0.5, window,
                                 True, nsplit)
    ks, vs = tpf.unpack_fused_scales(sc, HKV)
    step = float((pool[1:, 1, :, :, :d].float().abs().amax(-1)
                  * vs.transpose(0, 1)[1:]).max()) / 127.0
    assert step < 4e-2
    assert_close(out, po, 0, step, "int8 dot out")
    assert_close(lse, pl, 0, 1e-5, "int8 dot lse")
    assert (out[0] == 0).all()  # context 0


@pytest.mark.parametrize("window", [-1, 9, 301])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_every_span_in_one_warps_tile(d, window):
    """For nsplit 1 to 8, with and without a window: each split's range
    starts on a DECODE_SPAN boundary from t_lo and its tiles (of a multiple
    of DECODE_SPAN tokens) go to the warps in turn, so the tokens of every
    span lie in one tile of one warp, and every warp takes every NW-th
    tile."""
    tn, nw = TILE_TOKENS[d], WARPS[d]
    assert tn % ds.DECODE_SPAN == 0
    cap = 1024
    lens = torch.tensor([0, 1, 3, 5, 17, 63, 64, 65, 333, 1000, 1023, 1024],
                        dtype=torch.int32)
    for nsplit in range(1, 9):
        lo, hi = ds.split_bounds(lens, cap, window, nsplit)
        for b, n in enumerate(lens.tolist()):
            t_lo = max(0, n - window) if window > 0 else 0
            for s in range(nsplit):
                a, z = int(lo[b, s]), int(hi[b, s])
                if a >= z:
                    continue
                pos = torch.arange(a, z)
                tile = torch.div(pos - a, tn, rounding_mode="floor")
                warp = warp_of(pos, torch.tensor(a), d)
                assert (warp == tile % nw).all()
                span = torch.div(pos - t_lo, ds.DECODE_SPAN,
                                 rounding_mode="floor")
                for sp in span.unique().tolist():
                    at = span == sp
                    assert tile[at].unique().numel() == 1, (nsplit, b, s)
                    assert warp[at].unique().numel() == 1


@pytest.mark.parametrize("label,batch,hq,hkv,d,capacity,quantized,want", [
    ("GPT-2 B8 ctx1024, f32 pools", 8, 12, 12, 64, 1024, False, 1),
    ("GPT-2 B8 ctx1024, 1-byte pools", 8, 12, 12, 64, 1024, True, 4),
    ("GPT-2 B1 ctx1024, f32 pools", 1, 12, 12, 64, 1024, False, 4),
    ("GPT-2 B64 ctx1024 (768 pairs)", 64, 12, 12, 64, 1024, True, 1),
    ("f32 Llama layer B8 ctx4096, f32 pools", 8, 32, 8, 128, 4352, False,
     2),
    ("f32 Llama layer B8 ctx4096, 1-byte pools", 8, 32, 8, 128, 4352, True,
     6),
    ("f32 D256 group 8 B2", 2, 8, 1, 256, 2048, True, 8),
    ("f32 D256 group 8 B64", 64, 8, 1, 256, 2048, True, 2)])
def test_generic_decode_splits_by_its_blocks_per_sm(label, batch, hq, hkv, d,
                                                    capacity, quantized, want,
                                                    monkeypatch):
    """The generic decode's wave: 3 blocks an SM over 1-byte pools at D 64
    and 128 (what csrc/paged_generic.cuh Geo<D>::BPS fits), 1 over f32
    pools and at D 256; its split count is one such wave over the
    (sequence, kv head) pairs, at most one split per 256 tokens of the
    table, from the shapes, the pool type and the SM count alone."""
    monkeypatch.setattr(ds, "sm_count", lambda device: 132)
    monkeypatch.setattr(ds, "_COUNTERS", {})
    per_sm = ds.generic_blocks_per_sm(d, quantized)
    assert per_sm == (3 if quantized and d < 256 else 1)
    nsplit, ws, cnt = ds.launch_plan(
        batch, hq, hkv, capacity, -1, torch.device("cpu", 0), head_dim=d,
        tile_rows=ds.generic_tile_rows(hq // hkv), blocks_per_sm=per_sm)
    assert nsplit == want, label
    assert nsplit == ds.num_splits(batch, hkv, capacity, -1, 132, 1, per_sm)
    assert (ws is None) == (nsplit == 1)
    if nsplit > 1:
        assert ws.numel() == batch * hq * nsplit * (d + 2)
        assert batch * hkv * nsplit <= per_sm * 132


class _FakeLibrary:
    """Stands in for the kernels' library: records the decode entry's
    arguments and returns success."""

    def __init__(self):
        self.args = None

    def aule_paged_generic_decode(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("d,hq,hkv,batch,pool,want", [
    (64, 12, 12, 8, 0, 1), (64, 12, 12, 8, 3, 4), (128, 32, 8, 8, 0, 2),
    (128, 32, 8, 8, 2, 6), (256, 8, 1, 64, 1, 2)])
def test_wrapper_launches_with_the_generic_plan(d, hq, hkv, batch, pool,
                                                want, monkeypatch):
    """`paged_generic_decode` hands the kernel the split count of the
    generic decode's wave for its pool (not the tensor-core decode's), the
    q rows of `generic_tile_rows` and the merge buffers, and counts one
    launch."""
    fake = _FakeLibrary()
    monkeypatch.setattr(ds, "sm_count", lambda device: 132)
    monkeypatch.setattr(ds, "_COUNTERS", {})
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(pg.paged_generic_decode, "launches", 0)
    max_pages = {64: 64, 128: 272, 256: 128}[d]
    q = torch.zeros(batch, hq, d)
    kv = torch.zeros(tpf.fused_pool_shape(4, hkv, PAGE, d))
    bt = torch.zeros(batch, max_pages, dtype=torch.int32)
    lens = torch.zeros(batch, dtype=torch.int32)
    pg.paged_generic_decode(
        q, q, None, kv, None, None, None, bt, lens, num_pages=4,
        page_size=PAGE, scale=0.125, window=-1, pool=pool, sc_f32=0,
        layout=pg.FUSED, return_lse=False)
    assert pg.paged_generic_decode.launches == 1
    nsplit, rows = fake.args[21], fake.args[22]
    assert nsplit == want
    assert rows == ds.generic_tile_rows(hq // hkv)
    assert (fake.args[10] is None) == (nsplit == 1)  # the workspace
