"""The f32 paged prefill's 3xTF32 arithmetic, held to the port's plain
prefill and to JAX's.

csrc/paged_prefill_f32.cu runs the f32-q paged prefill on the tensor cores
in TF32, three products a pair (`mma3` of tests/test_torch_flash_tf32.py):
a block takes 16 q rows of one q head, and its 4 warps split the block's
key tiles (32 keys at D 64), warp w taking tiles j_lo + w, j_lo + w + 4,
... of the keys some row of the block may see (j_lo from the window).
Each warp runs the online softmax (log2 units) over its own tiles: S
summed 16 head-dim values at a time as two k-step chains of 8 values (16c
+ {0, 1, 4, 5, 8, 9, 12, 13} and 16c + {2, 3, 6, 7, 10, 11, 14, 15}), each
from zero on the tensor cores, their sum added to S in f32; P V one key
tile a chain, added to O in f32.  The warps' (m, l, O) are then merged in
warp order.  1-byte pools are dequantized to f32 (payload times the
token's scale) before the split.  `_prefill_model` below is a plain
PyTorch model of that arithmetic.  It is held with chip_smoke.py's limits
(every output row within 1e-5 of its largest |value|, LSE within 1e-4) to:
  * the port's plain prefill (`paged_attention_prefill` on CPU tensors),
    which the card's checks hold the kernel to, in f32, int8 and e4m3
    pools, a ragged batch with rows past the context and a window;
  * JAX's `paged_attention_prefill` (the Pallas kernel in interpret mode)
    on its live rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.ops import paged_fused as jpf
from aule_tpu_torch.config import DEFAULT_MASK_VALUE
from aule_tpu_torch.ops import paged_prefill as tpp
from aule_tpu_torch.ops.paged_fused import dequantize_pool, from_fused_layout
from aule_tpu_torch.utils.testing import cap_cpu_threads
from test_torch_flash_tf32 import LSE_TOL, ROW_TOL, _row_rel, mma3
from test_torch_paged_prefill import _appended, _t

cap_cpu_threads()

BM, BN, NW = 16, 32, 4  # q rows a block, keys a warp's tile, warps (D 64)
# the two k-steps of each 16 head-dim values
KSTEP = (np.array([0, 1, 4, 5, 8, 9, 12, 13]),
         np.array([2, 3, 6, 7, 10, 11, 14, 15]))


def _dense(kv, sc, bt, d):
    """The pool's K and V gathered per sequence, f32 [B, Hkv, T, D] (T the
    table's capacity; -1 entries read page 0)."""
    kp, vp = (dequantize_pool(kv, sc, d) if sc is not None
              else from_fused_layout(kv, d))
    pages = bt.clamp_min(0).long()
    take = lambda x: x[:, pages].flatten(2, 3).transpose(0, 1).float()
    return take(kp), take(vp)


def _scores(q, k):
    """q [.., M, D] . k [.., N, D] as the kernel sums it."""
    s = None
    for c in range(0, q.shape[-1], 16):
        x = None
        for idx in KSTEP:
            cols = c + torch.from_numpy(idx)
            part = mma3(torch.zeros(q.shape[:-1] + (k.shape[-2],)),
                        q[..., cols], k[..., cols].transpose(-1, -2))
            x = part if x is None else x + part
        s = x if s is None else s + x
    return s


def _prefill_model(q, k, v, lens, qoff, causal, window):
    """(out, lse) with the kernel's arithmetic: q [B, Hq, S, D], k / v the
    dense f32 [B, Hkv, T, D] of `_dense`."""
    b_, hq, sq, d = q.shape
    k, v = (x.repeat_interleave(hq // x.shape[1], dim=1) for x in (k, v))
    sl2 = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    out = torch.zeros(q.shape)
    lse = torch.zeros(q.shape[:3])
    kpos = torch.arange(k.shape[2])
    for b in range(b_):
        n = int(lens[b])
        for s_lo in range(0, sq, BM):
            rows = slice(s_lo, min(s_lo + BM, sq))
            qpos = int(qoff[b]) + torch.arange(s_lo, min(s_lo + BM, sq))
            seen = (kpos[None] < n) & (qpos[:, None] < n)
            if causal:
                seen &= kpos[None] <= qpos[:, None]
            if window > 0:
                seen &= qpos[:, None] - kpos[None] <= window
            # the key tiles some row of the block sees, as the kernel's
            k_min = max(0, int(qpos[0]) - window) if window > 0 else 0
            k_max = (-1 if int(qpos[0]) >= n else
                     min(n - 1, int(qpos[-1])) if causal else n - 1)
            j_lo = k_min // BN
            j_hi = k_max // BN if k_max >= k_min else j_lo - 1
            parts = []
            for w in range(NW):
                m = torch.full((hq, len(qpos), 1), float("-inf"))
                l = torch.zeros((hq, len(qpos), 1))
                acc = torch.zeros((hq, len(qpos), d))
                for j in range(j_lo + w, j_hi + 1, NW):
                    keys = slice(j * BN, (j + 1) * BN)
                    s = _scores(q[b, :, rows], k[b, :, keys]) * sl2
                    s = s.masked_fill(~seen[:, keys], float("-inf"))
                    mn = torch.maximum(m, s.amax(-1, keepdim=True))
                    live = ~torch.isinf(mn)
                    mn0 = torch.where(live, mn, torch.zeros_like(mn))
                    al = torch.where(live, torch.exp2(m - mn0),
                                     torch.ones_like(mn))
                    p = torch.exp2(s - mn0)  # 0 where not seen
                    l = l * al + p.sum(-1, keepdim=True)
                    m = mn
                    part = torch.zeros_like(acc)
                    for kk in range(0, BN, 8):
                        part = mma3(part, p[..., kk:kk + 8],
                                    v[b, :, keys][:, kk:kk + 8])
                    acc = acc * al + part
                parts.append((m, l, acc))
            big = torch.stack([m for m, _, _ in parts]).amax(0)
            big0 = torch.where(torch.isinf(big), torch.zeros_like(big), big)
            tot_l, tot_o = torch.zeros_like(big), torch.zeros((hq, len(qpos), d))
            for m, l, acc in parts:  # warp order
                c = torch.where(torch.isinf(m), torch.zeros_like(m),
                                torch.exp2(m - big0))
                tot_l = tot_l + l * c
                tot_o = tot_o + acc * c
            live = tot_l > 0
            out[b, :, rows] = torch.where(
                live, tot_o / torch.where(live, tot_l, torch.ones_like(tot_l)),
                torch.zeros_like(tot_o))
            lse[b, :, rows] = torch.where(
                live, (big0 + torch.log2(tot_l)) * 0.6931471805599453,
                torch.full_like(big0, DEFAULT_MASK_VALUE))[..., 0]
    return out, lse


PAGE = 64  # a chunk of 64 at 192 over 256 tokens: 4 pages of 64
HIST = np.array([192, 100, 0], np.int32)
CHUNK = np.array([64, 30, 64], np.int32)


def _case(qname, seed):
    kv, sc, bt, lens, rng = _appended(3, 2, 64, HIST, CHUNK, 64,
                                      qname=qname, seed=seed, page=PAGE)
    q = rng.standard_normal((3, 4, 64, 64)).astype(np.float32)
    return q, kv, sc, bt, lens


def _model_of(q, kv, sc, bt, lens, window):
    k, v = _dense(_t(kv), None if sc is None else _t(sc),
                  torch.from_numpy(bt), 64)
    return _prefill_model(torch.from_numpy(q), k, v, lens, HIST, True,
                          window)


def _assert_rows(got, want, live):
    """chip_smoke.py's limits on the live rows of each sequence."""
    (go, gl), (wo, wl) = got, want
    for b, n in enumerate(live):
        rel = _row_rel(go[b, :, :n], wo[b, :, :n])
        lse = float(np.abs(np.asarray(gl[b, :, :n], np.float64)
                           - np.asarray(wl[b, :, :n], np.float64)).max())
        assert rel <= ROW_TOL, f"sequence {b}: row-relative {rel:.3e}"
        assert lse <= LSE_TOL, f"sequence {b}: lse {lse:.3e}"


MODES = [(None, 21), ("int8", 22), ("fp8", 23)]


@pytest.mark.parametrize("window", [-1, 40])
@pytest.mark.parametrize("qname,seed", MODES, ids=lambda x: str(x))
def test_3xtf32_prefill_within_chip_limits_of_plain(qname, seed, window):
    """The card's rule: the kernel's arithmetic against the port's plain
    prefill on the same pool, every row of the padded chunk (rows past a
    sequence's context: zeros and the mask LSE in both)."""
    q, kv, sc, bt, lens = _case(qname, seed)
    got = _model_of(q, kv, sc, bt, lens, window)
    want = tpp.paged_attention_prefill(
        _t(q), _t(kv), torch.from_numpy(bt), torch.from_numpy(lens),
        q_offsets=torch.from_numpy(HIST),
        kv_scales=None if sc is None else _t(sc), window_size=window,
        return_lse=True)
    _assert_rows(got, want, [64] * 3)
    for b, n in enumerate(CHUNK):
        assert (got[0][b, :, n:] == 0).all()
        assert (got[1][b, :, n:] == DEFAULT_MASK_VALUE).all()


@pytest.mark.parametrize("window", [-1, 40])
@pytest.mark.parametrize("qname,seed", MODES, ids=lambda x: str(x))
def test_3xtf32_prefill_within_chip_limits_of_jax(qname, seed, window):
    """Against JAX's paged_attention_prefill (its Pallas kernel in
    interpret mode) on the live rows."""
    q, kv, sc, bt, lens = _case(qname, seed)
    got = _model_of(q, kv, sc, bt, lens, window)
    jo, jl = jpf.paged_attention_prefill(
        jnp.asarray(q), kv, jnp.asarray(bt), jnp.asarray(lens),
        q_offsets=jnp.asarray(HIST), kv_scales=sc, block_q=16,
        window_size=window, return_lse=True)
    _assert_rows(got, (np.asarray(jo), np.asarray(jl)), CHUNK)
