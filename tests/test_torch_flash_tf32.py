"""The f32 flash forward's 3xTF32 arithmetic, held to JAX's f32 forward.

csrc/flash_f32.cu runs both products of the f32 forward on the tensor cores
in TF32, three products a pair: each f32 operand x is split into big =
tf32(x) and small = tf32(x - big) (cvt.rna.tf32.f32: round to nearest,
ties away from zero, to 10 explicit significand bits), and a b is summed
as a_small b_big + a_big b_small + a_big b_big (small x small, 2^-22 of
|a b|, dropped).  Q and K are split as they are read, P after the online
softmax (the row sum l adds the unsplit p), V as it is read.  An mma sums
its products exactly and truncates the result to f32, so the kernel keeps
its chains short: each 32 head-dim values of S and each key tile's P V
start from zero on the tensor cores and are added to S and O in f32,
rounded to nearest.  `_tf32_model` below is a plain PyTorch model of
exactly that arithmetic, tile by tile with the online softmax, in f32
otherwise (at D 256 the kernel sums S 8 values at a time).  It is held
with chip_smoke.py's limits (every output row
within 1e-5 of its largest |value|, LSE within 1e-4) to:
  * JAX's `attention_reference` in f32 (Precision.HIGHEST) on the same
    values, and to the Pallas forward in interpret mode at a small shape;
  * the port's plain forward, which is what the card's checks hold the
    kernel to.
Two variants miss the same limit, which is why the kernel is built so: one
TF32 pass (big x big alone) by far, and one truncating chain of mmas over
every key of a row (O carried in the tensor-core accumulator, as the first
build on the card did) at GPT-2's 1,024 keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.ops.flash import flash_attention_fwd as jax_flash
from aule_tpu.ops.reference import attention_reference
from aule_tpu_torch.ops.flash import flash_attention_fwd_plain
from aule_tpu_torch.ops.reference import build_mask
from aule_tpu_torch.utils.testing import cap_cpu_threads

cap_cpu_threads()

ROW_TOL = 1e-5   # chip_smoke.py ROW_TOL[torch.float32]
LSE_TOL = 1e-4   # chip_smoke.py LSE_TOL


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded as cvt.rna.tf32.f32 rounds it: the low 13 of the 23
    significand bits cleared, to nearest, ties away from zero (the
    magnitude bits carry; the sign bit is apart)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def rz(x: torch.Tensor) -> torch.Tensor:
    """f64 x to f32, rounded toward zero (an mma's truncated sum)."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def mma3(c, a, b, passes: int = 3):
    """c + a @ b over 8 (or any) values as the kernel's mmas sum it: the
    cross terms, then big x big, each mma's products summed exactly with
    its accumulator and truncated to f32; passes=1: big x big alone."""
    (ab, as_), (bb, bs) = split(a), split(b)
    terms = [(ab, bb)] if passes == 1 else [(as_, bb), (ab, bs), (ab, bb)]
    for x, y in terms:
        c = rz(c.double() + x.double() @ y.double())
    return c


def _tf32_model(q, k, v, causal, window, passes=3, chain="tile"):
    """(out, lse) of the f32 forward with the kernel's arithmetic, q [B, Hq,
    Sq, D], k / v [B, Hkv, Sk, D] f32 (GQA by repeating k, v), over the
    kernel's key tiles (64 keys, 16 at D 256) with its online softmax.
    chain="tile": S summed 32 head-dim values (4 k-steps; 8 values at D
    256) at a time and P V a tile at a time on the tensor cores, each added
    to its f32 sum; chain="long": S one chain over D, O one chain over
    every key."""
    d = q.shape[-1]
    bn = 16 if d > 128 else 64
    group = q.shape[1] // k.shape[1]
    k, v = (x.repeat_interleave(group, dim=1) for x in (k, v))
    keep = build_mask(q.shape[2], k.shape[2], causal, window)
    rows = q.shape[:3] + (1,)
    m = torch.full(rows, float("-inf"))
    l = torch.zeros(rows)
    acc = torch.zeros(q.shape)
    for j in range(0, k.shape[2], bn):
        kt, vt = k[:, :, j:j + bn], v[:, :, j:j + bn]
        s = torch.zeros(rows[:3] + (kt.shape[2],))
        part = torch.zeros_like(s)
        for c in range(0, d, 8):
            part = mma3(part, q[..., c:c + 8],
                        kt[..., c:c + 8].transpose(-1, -2), passes)
            if chain == "tile" and (c % 32 == 24 or d > 128):
                s, part = s + part, torch.zeros_like(s)
        s = (s + part) * d ** -0.5
        s = s.masked_fill(~keep[:, j:j + bn], float("-inf"))
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        seen = ~torch.isinf(mn)
        mn0 = torch.where(seen, mn, torch.zeros_like(mn))
        alpha = torch.where(seen, torch.exp(m - mn0), torch.ones_like(mn))
        p = torch.exp(s - mn0)                 # 0 where masked
        l = l * alpha + p.sum(-1, keepdim=True)  # the unsplit p
        m = mn
        acc = acc * alpha
        part = torch.zeros_like(acc) if chain == "tile" else acc
        for kk in range(0, kt.shape[2], 8):
            part = mma3(part, p[..., kk:kk + 8], vt[:, :, kk:kk + 8],
                        passes)
        acc = acc + part if chain == "tile" else part
    seen = l > 0
    out = torch.where(seen, acc / torch.where(seen, l, torch.ones_like(l)),
                      torch.zeros_like(acc))
    return out, (m + torch.log(l))[..., 0]


def _row_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want).max(-1)
    size = np.abs(want).max(-1)
    return float(np.where(diff == 0, 0.0, diff / np.maximum(size, 1e-30))
                 .max())


def _inputs(b, hq, hkv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def _jax_reference(q, k, v, causal, window):
    with jax.default_matmul_precision("highest"):
        out, lse = attention_reference(
            *(jnp.asarray(x) for x in (q, k, v)), causal=causal,
            window_size=window, return_lse=True)
    return np.asarray(out), np.asarray(lse)


# (D, causal, Hq, Hkv, Sq, Sk, window): GPT-2's layer (D64, S1024), the
# Llama layer's group 4 (D128), Gemma-2B's group 8 (D256), Sq != Sk and a
# window
SHAPES = pytest.mark.parametrize(
    "d,causal,hq,hkv,sq,sk,window",
    [(64, True, 2, 2, 1024, 1024, -1), (64, False, 2, 1, 200, 1024, -1),
     (128, True, 4, 1, 512, 512, -1), (128, False, 2, 2, 256, 640, -1),
     (256, True, 2, 1, 512, 512, -1), (256, False, 2, 2, 300, 300, 64)],
    ids=lambda x: str(x))


@SHAPES
def test_3xtf32_within_chip_limits_of_jax(d, causal, hq, hkv, sq, sk,
                                          window):
    q, k, v = _inputs(1, hq, hkv, sq, sk, d, seed=d + sq + causal)
    out, lse = _tf32_model(*(torch.from_numpy(x) for x in (q, k, v)),
                           causal, window)
    jo, jl = _jax_reference(q, k, v, causal, window)
    rel = _row_rel(out.numpy(), jo)
    assert rel <= ROW_TOL, f"row-relative {rel:.3e} > {ROW_TOL:.0e}"
    assert np.abs(lse.numpy() - jl).max() <= LSE_TOL


@SHAPES
def test_3xtf32_within_chip_limits_of_plain(d, causal, hq, hkv, sq, sk,
                                            window):
    """The card's rule: the kernel's arithmetic against the port's plain
    forward (f32) on the same values."""
    q, k, v = (torch.from_numpy(x)
               for x in _inputs(1, hq, hkv, sq, sk, d, seed=d + sk))
    out, lse = _tf32_model(q, k, v, causal, window)
    po, plse = flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window_size=window)
    rel = _row_rel(out.numpy(), po.numpy())
    assert rel <= ROW_TOL, f"row-relative {rel:.3e} > {ROW_TOL:.0e}"
    assert (lse - plse).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_within_chip_limits_of_pallas(causal):
    """Against the Pallas forward itself (interpret mode on the CPU), whose
    f32 branch runs its products at Precision.HIGHEST."""
    q, k, v = _inputs(1, 4, 2, 128, 128, 64, seed=7 + causal)
    out, lse = _tf32_model(*(torch.from_numpy(x) for x in (q, k, v)),
                           causal, -1)
    jo, jl = jax_flash(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                       return_lse=True)
    assert _row_rel(out.numpy(), np.asarray(jo)) <= ROW_TOL
    assert np.abs(lse.numpy() - np.asarray(jl)).max() <= LSE_TOL


@pytest.mark.parametrize("d", [64, 128])
def test_one_tf32_pass_misses_the_limit(d):
    """big x big alone keeps ~11 significant bits: its rows sit near 1e-3
    of their size, 100x the limit, so the split is what holds f32."""
    q, k, v = _inputs(1, 2, 2, 256, 256, d, seed=11)
    out, _ = _tf32_model(*(torch.from_numpy(x) for x in (q, k, v)), True,
                         -1, passes=1)
    jo, _ = _jax_reference(q, k, v, True, -1)
    assert _row_rel(out.numpy(), jo) > 10 * ROW_TOL


def test_one_long_chain_misses_the_limit():
    """GPT-2's layer (D64, 1,024 keys, causal) with O carried in the
    tensor-core accumulator across every key tile: each truncating mma
    biases the row toward zero, and over 384 of them it ends beyond 1e-5
    (1.4e-5 on the card; the model reads 1.7e-5), where the kernel's
    tile-long chains read ~2e-6."""
    q, k, v = _inputs(1, 2, 2, 1024, 1024, 64, seed=5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    jo, _ = _jax_reference(q, k, v, True, -1)
    long, _ = _tf32_model(tq, tk, tv, True, -1, chain="long")
    tile, _ = _tf32_model(tq, tk, tv, True, -1)
    assert _row_rel(long.numpy(), jo) > ROW_TOL
    assert _row_rel(tile.numpy(), jo) <= ROW_TOL / 2


def test_tf32_rounds_to_nearest_ties_away():
    """tf32 keeps 10 significand bits: 1 + 2^-11 (a tie) rounds up to 1 +
    2^-10, -(1 + 2^-11) to -(1 + 2^-10), 1 + 2^-12 down to 1; big + small
    gives x back within 2^-22 of |x|."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                      3.0], dtype=torch.float32)
    want = torch.tensor([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 3.0])
    assert torch.equal(tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(
        4096).astype(np.float32))
    big, small = split(r)
    assert torch.equal(tf32(big), big) and torch.equal(tf32(small), small)
    assert ((big + small - r).abs() <= 2.0 ** -22 * r.abs()).all()
