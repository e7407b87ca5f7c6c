"""The f32 flash backward's arithmetic, held to JAX's f32 backward.

csrc/flash_f32_bwd.cu runs the f32 backward on the tensor cores in TF32,
three products a pair, with the forward's split (`tf32`, `split`, `rz`,
`mma3` of tests/test_torch_flash_tf32.py): S = Q K^T (and, in the dK/dV
kernel, S^T = K Q^T and dP^T = V dO^T) sums each 8 head-dim values (one
k-step) on the tensor cores from zero, two such chains side by side, their
sum added to the f32 score; P = exp(scale S - lse) from the forward's LSE
and dS = P (dP - di) scale in f32; dQ += dS K sums one key tile (64 keys at
D 64, 32 at D 128, 16 at D 256) a chain, and dK += dS^T Q, dV += P^T dO one
q tile (32 rows) a chain, each chain added to its f32 sum; a GQA group's
dK / dV shares are added in head order.  At D 256 dK / dV run on
csrc/flash_generic.cu's FFMA kernel (every product one f32 chain in order),
which was faster there on the card.  dQ's dP alone runs on FFMA, one f32
chain in the head dim's order: where one key takes a row's
weight (a causal row 0), dS = P (dP - di) cancels to the rounding of dP
itself, and the card's check holds dQ there to the plain version's f32 dP
within 1e-5 of 2^-5 of the largest |dQ|; that rounding, not any 3xTF32
one, is the plain version's.  `_bwd_model` below is a plain PyTorch model
of exactly that arithmetic.  It is held with chip_smoke.py's limits (every
gradient row within ROW_TOL 1e-5 of its size, the size at least
F32_BWD_FLOOR of the tensor's largest |value|, for rows that cancel) to:
  * the port's plain backward, which the card's checks hold the kernels to,
    at D 64/128/256, causal and not, GQA groups 1/4/8, Sq != Sk and a
    window;
  * JAX's f32 backward: `jax.vjp` of `attention_reference` under
    `jax.default_matmul_precision("highest")`, with a non-zero LSE
    cotangent where a case has one, where JAX and the port's plain backward
    agree within the limit (at a causal row 0 at D 256 the two references
    themselves differ by 2.0e-5 of the floor: JAX rounds dP and delta in
    other orders);
  * the Pallas backward in interpret mode at a small shape.
One TF32 pass misses the limit by far, so does dK / dV carried in one
truncating chain over every q row of a long causal column, and so does
dQ's dP in 3xTF32 at the cancelling rows, which is why the kernels are
built so.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aule_tpu.ops import flash_vjp as jfv
from aule_tpu.ops.reference import attention_reference
from aule_tpu_torch.ops.flash_vjp import flash_attention_bwd_plain
from aule_tpu_torch.ops.reference import build_mask
from test_torch_flash_tf32 import ROW_TOL, mma3

F32_BWD_FLOOR = 2.0 ** -5   # chip_smoke.py F32_BWD_FLOOR
# the kernels' tiles by head dim: keys a dQ chain, q rows a dK / dV chain
# (D 256's dK / dV run on FFMA)
DQ_KEYS = {64: 64, 128: 32, 256: 16}
DKV_ROWS = {64: 32, 128: 32}


def _scores(a, b, passes=3):
    """a [.., M, D] . b [.., N, D] over D as the kernels sum it: chains of
    one k-step (8 head-dim values), two side by side, their sum added to
    the f32 total."""
    chains = [mma3(torch.zeros(a.shape[:-1] + (b.shape[-2],)),
                   a[..., c:c + 8], b[..., c:c + 8].transpose(-1, -2), passes)
              for c in range(0, a.shape[-1], 8)]
    total = None
    for i in range(0, len(chains), 2):
        x = chains[i] + chains[i + 1]
        total = x if total is None else total + x
    return total


def _ffma(a, b):
    """a [.., M, D] . b [.., N, D] over D on FFMA: one f32 chain from 0 in
    the head dim's order, each step a fused multiply-add (the product exact
    in f64, the sum rounded once to f32)."""
    out = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    a64, b64 = a.double(), b.double()
    for d in range(a.shape[-1]):
        out = (out.double() + a64[..., d, None] * b64[..., None, :, d]).float()
    return out


def _ffma_rows(w, x):
    """w [.., M, K] @ x [.., K, N] on FFMA: one f32 chain from 0 over the K
    rows in order (flash_generic.cu's dK / dV)."""
    out = torch.zeros(w.shape[:-1] + (x.shape[-1],))
    w64, x64 = w.double(), x.double()
    for kk in range(w.shape[-1]):
        out = (out.double() + w64[..., kk, None] * x64[..., kk, None, :]).float()
    return out


def _rows(w, x, tile, chain="tile", passes=3):
    """w [.., M, K] @ x [.., K, N]: the K rows in chains of `tile` (8 a
    k-step) on the tensor cores, each added to the f32 sum; chain="long":
    one chain over all K."""
    acc = torch.zeros(w.shape[:-1] + (x.shape[-1],))
    part = acc
    for j in range(0, w.shape[-1], tile):
        if chain == "tile":
            part = torch.zeros_like(acc)
        for kk in range(j, min(j + tile, w.shape[-1]), 8):
            part = mma3(part, w[..., kk:kk + 8], x[..., kk:kk + 8, :],
                        passes)
        if chain == "tile":
            acc = acc + part
    return acc if chain == "tile" else part


def _bwd_model(q, k, v, do, lse, di, causal, window, chain="tile",
               passes=3, dq_dp="ffma"):
    """(dq, dk, dv) of the f32 backward with the kernels' arithmetic: q, do
    [B, Hq, Sq, D], k, v [B, Hkv, Sk, D], lse, di [B, Hq, Sq] f32; dQ's dP
    on FFMA (dq_dp="ffma") or in 3xTF32 ("tf32"); `chain` a tuple of
    `_rows` chains gives a tuple of results, the scores computed once."""
    d = q.shape[-1]
    scale = d ** -0.5
    group = q.shape[1] // k.shape[1]
    kx, vx = (x.repeat_interleave(group, dim=1) for x in (k, v))
    keep = build_mask(q.shape[2], k.shape[2], causal, window)

    def p_ds(s, dp, lse_, di_):
        p = torch.where(keep, torch.exp(s * scale - lse_),
                        torch.zeros(()))
        return p, p * (dp - di_) * scale

    # dQ's scores, rows q
    dp = _ffma(do, vx) if dq_dp == "ffma" else _scores(do, vx, passes)
    _, ds = p_ds(_scores(q, kx, passes), dp, lse[..., None], di[..., None])
    # dK/dV's, transposed: rows k, lse and di per column; at D 256 all on
    # FFMA (flash_generic.cu)
    ffma = d == 256
    score = _ffma if ffma else (lambda a, b: _scores(a, b, passes))
    pt, dst = p_ds(score(kx, q).transpose(-1, -2),
                   score(vx, do).transpose(-1, -2), lse[..., None],
                   di[..., None])
    shape = k.shape[:2] + (group,) + k.shape[2:]

    def sums(ch):
        dq = _rows(ds, kx, DQ_KEYS[d], ch, passes)
        if ffma:
            dk_h = _ffma_rows(dst.transpose(-1, -2), q)
            dv_h = _ffma_rows(pt.transpose(-1, -2), do)
        else:
            dk_h = _rows(dst.transpose(-1, -2), q, DKV_ROWS[d], ch, passes)
            dv_h = _rows(pt.transpose(-1, -2), do, DKV_ROWS[d], ch, passes)
        dk_g, dv_g = dk_h.reshape(shape), dv_h.reshape(shape)
        dk, dv = dk_g[:, :, 0], dv_g[:, :, 0]
        for h in range(1, group):  # the workspace sum, in head order
            dk, dv = dk + dk_g[:, :, h], dv + dv_g[:, :, h]
        return dq, dk, dv

    if isinstance(chain, tuple):
        return tuple(sums(ch) for ch in chain)
    return sums(chain)


def _row_rel(got, want, floor=F32_BWD_FLOOR):
    """chip_smoke.py `hold`: the worst row's max |got - want| over the
    row's max |want|, at least `floor` of the tensor's max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want).max(-1)
    size = np.maximum(np.abs(want).max(-1), floor * np.abs(want).max())
    return float(np.where(diff == 0, 0.0, diff / np.maximum(size, 1e-30))
                 .max())


def _inputs(b, hq, hkv, sq, sk, d, seed, with_dlse):
    rng = np.random.default_rng(seed)
    shapes = ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, sq, d))
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    dlse = (rng.standard_normal((b, hq, sq)).astype(np.float32)
            if with_dlse else np.zeros((b, hq, sq), np.float32))
    return xs, dlse


def _jax_backward(q, k, v, do, dlse, causal, window):
    """JAX's f32 forward (out, lse) and the gradients of q, k, v under the
    cotangents (do, dlse), at Precision.HIGHEST."""
    with jax.default_matmul_precision("highest"):
        (out, lse), vjp = jax.vjp(
            lambda a, b, c: attention_reference(
                a, b, c, causal=causal, window_size=window,
                return_lse=True), *(jnp.asarray(x) for x in (q, k, v)))
        grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


def _model_from(q, k, v, do, dlse, out, lse, causal, window, **kw):
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tlse = torch.from_numpy(np.array(lse, np.float32))
    di = ((torch.from_numpy(np.array(out, np.float32)) * tdo).sum(-1)
          - torch.from_numpy(dlse))
    return _bwd_model(tq, tk, tv, tdo, tlse, di, causal, window, **kw)


# (D, causal, Hq, Hkv, Sq, Sk, window, dlse): GPT-2's D64 causal at group
# 4, Sq != Sk at D128 group 1, the Llama group 4 causal with an LSE
# cotangent, group 8 at D256 (Gemma-2B's), a bidirectional window at D64
# with an LSE cotangent, and group 1 causal with Sq < Sk
CASES = [(64, True, 4, 1, 384, 384, -1, False),
         (128, False, 2, 2, 200, 384, -1, False),
         (128, True, 8, 2, 320, 320, -1, True),
         (256, True, 8, 1, 160, 160, -1, False),
         (64, False, 2, 2, 300, 300, 64, True),
         (64, True, 8, 8, 200, 600, -1, False)]
# JAX's backward where it and the port's plain one agree within the limit
# (no causal row 0 at D 128 / 256), at the widths of CASES cut for time:
# GPT-2's D64 causal, Sq != Sk at D128, D256 group 4, a window with an LSE
# cotangent
JAX_CASES = [(64, True, 2, 1, 256, 256, -1, False),
             (128, False, 2, 2, 128, 256, -1, False),
             (256, False, 4, 1, 128, 96, -1, False),
             (64, False, 2, 2, 200, 200, 48, True)]
NAMES = ("dq", "dk", "dv")


def _assert_within(got, want, limit=ROW_TOL):
    for name, g, w in zip(NAMES, got, want):
        rel = _row_rel(np.asarray(g), np.asarray(w))
        assert rel <= limit, f"{name}: row-relative {rel:.3e}"


def _plain_backward(q, k, v, do, dlse, causal, window):
    """The port's plain forward (out, lse) and backward on the same
    values."""
    from aule_tpu_torch.ops.flash import flash_attention_fwd_plain

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = flash_attention_fwd_plain(tq, tk, tv, causal=causal,
                                         window_size=window)
    grads = flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                      causal=causal, window=window,
                                      dlse=torch.from_numpy(dlse))
    return out.numpy(), lse.numpy(), grads


@pytest.mark.parametrize("d,causal,hq,hkv,sq,sk,window,dlse", CASES,
                         ids=lambda x: str(x))
def test_3xtf32_bwd_within_chip_limits_of_plain(d, causal, hq, hkv, sq, sk,
                                                window, dlse):
    """The card's rule: the kernels' arithmetic against the port's plain
    backward (f32) on the same values, o and lse from the plain forward."""
    (q, k, v, do), cot = _inputs(1, hq, hkv, sq, sk, d, d + sk, dlse)
    out, lse, want = _plain_backward(q, k, v, do, cot, causal, window)
    _assert_within(_model_from(q, k, v, do, cot, out, lse, causal, window),
                   want)


@pytest.mark.parametrize("d,causal,hq,hkv,sq,sk,window,dlse", JAX_CASES,
                         ids=lambda x: str(x))
def test_3xtf32_bwd_within_chip_limits_of_jax(d, causal, hq, hkv, sq, sk,
                                              window, dlse):
    (q, k, v, do), cot = _inputs(1, hq, hkv, sq, sk, d, d + sq + causal,
                                 dlse)
    out, lse, want = _jax_backward(q, k, v, do, cot, causal, window)
    _assert_within(_model_from(q, k, v, do, cot, out, lse, causal, window),
                   want)


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_bwd_within_chip_limits_of_pallas(causal):
    """Against the Pallas backward itself (interpret mode on the CPU), from
    the same f32 forward's o and lse."""
    (q, k, v, do), cot = _inputs(1, 4, 2, 128, 128, 64, 9 + causal, False)
    with jax.default_matmul_precision("highest"):
        out, lse = attention_reference(
            *(jnp.asarray(x) for x in (q, k, v)), causal=causal,
            return_lse=True)
    want = jfv._bwd_impl(*(jnp.asarray(x) for x in (q, k, v)), out, lse,
                         jnp.asarray(do), causal=causal, scale=64 ** -0.5,
                         window=-1, interpret=True)
    _assert_within(_model_from(q, k, v, do, cot, out, lse, causal, -1),
                   want)


def test_cancelling_rows_take_the_plain_rounding_of_dp():
    """D256 group 4, causal: at row 0 (one key, dS exactly 0) what is left
    of dQ is the rounding of dP - delta.  JAX's backward and the port's
    plain one already differ there by more than the limit (2.0e-5); dP on
    FFMA in the head dim's order (the kernel's) stays within a third of it
    of the plain version (1.8e-6), dP in 3xTF32 does not (1.8e-5)."""
    (q, k, v, do), cot = _inputs(1, 4, 1, 192, 192, 256, 513, False)
    out, lse, plain = _plain_backward(q, k, v, do, cot, True, -1)
    _, _, jax_grads = _jax_backward(q, k, v, do, cot, True, -1)
    assert _row_rel(plain[0].numpy(), jax_grads[0]) > ROW_TOL
    ffma = _model_from(q, k, v, do, cot, out, lse, True, -1)
    assert _row_rel(ffma[0].numpy(), plain[0].numpy()) <= ROW_TOL / 3
    tf32 = _model_from(q, k, v, do, cot, out, lse, True, -1, dq_dp="tf32")
    assert _row_rel(tf32[0].numpy(), plain[0].numpy()) > ROW_TOL


def test_one_tf32_pass_misses_the_limit():
    """big x big alone keeps ~11 significant bits: every gradient then
    sits far past 1e-5 of its size, so the split is what holds f32."""
    (q, k, v, do), cot = _inputs(1, 2, 2, 128, 128, 64, 13, False)
    out, lse, want = _plain_backward(q, k, v, do, cot, True, -1)
    got = _model_from(q, k, v, do, cot, out, lse, True, -1, passes=1)
    for g, w in zip(got, want):
        assert _row_rel(g.numpy(), w.numpy()) > 10 * ROW_TOL


def test_one_long_chain_misses_the_limit():
    """dK / dV carried in the tensor cores' accumulator over every q row of
    a causal column (GPT-2's 1,024 positions, D64), and dQ over every key:
    each truncating mma biases the sum toward zero, and over the long
    columns dK and dV end beyond 1e-5, where the kernels' tile-long chains
    stay within a third of it."""
    (q, k, v, do), cot = _inputs(1, 1, 1, 1024, 1024, 64, 5, False)
    out, lse, want = _plain_backward(q, k, v, do, cot, True, -1)
    long, tile = _model_from(q, k, v, do, cot, out, lse, True, -1,
                             chain=("long", "tile"))
    for i in (1, 2):
        assert _row_rel(long[i].numpy(), want[i].numpy()) > ROW_TOL
    _assert_within(tile, want, ROW_TOL / 3)
