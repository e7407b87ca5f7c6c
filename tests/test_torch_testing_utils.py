"""The port's test helpers (aule_tpu_torch/utils/testing.py) against the
JAX package's (aule_tpu/utils/testing.py): `random_qkv`'s arrays bit for
bit, `DEFAULT_SEED`, `TOLERANCES`, and `max_abs_diff` / `mean_abs_diff`
on arrays and on torch tensors."""

import numpy as np
import pytest
import torch

from aule_tpu.utils import testing as jt
from aule_tpu_torch.utils import testing as tt

tt.cap_cpu_threads()


def test_constants_match():
    assert tt.DEFAULT_SEED == jt.DEFAULT_SEED == 42
    assert tt.TOLERANCES == jt.TOLERANCES


@pytest.mark.parametrize("kw", [
    dict(batch=1, heads_q=2, seq_q=8, head_dim=16),
    dict(batch=2, heads_q=8, seq_q=5, head_dim=64, heads_kv=2, seq_k=11),
    dict(batch=1, heads_q=4, seq_q=3, head_dim=32, dtype=np.float16,
         seed=7, scale=0.5),
    dict(batch=3, heads_q=1, seq_q=1, head_dim=8, dtype=np.float64, seed=0),
], ids=["default", "gqa_sq_ne_sk", "f16_seed_scale", "f64_seed0"])
def test_random_qkv_bit_for_bit(kw):
    for got, want in zip(tt.random_qkv(**kw), jt.random_qkv(**kw)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def test_diffs_match():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 5)).astype(np.float32)
    b = a + rng.standard_normal((4, 5)).astype(np.float32) * 1e-3
    for fn in ("max_abs_diff", "mean_abs_diff"):
        want = getattr(jt, fn)(a, b)
        assert getattr(tt, fn)(a, b) == want
        assert getattr(tt, fn)(torch.from_numpy(a), torch.from_numpy(b)) \
            == want
        assert getattr(tt, fn)(np.zeros((0, 3)), np.zeros((0, 3))) == 0.0
    bf = torch.from_numpy(a).bfloat16()
    assert tt.max_abs_diff(bf, a) == jt.max_abs_diff(bf.float().numpy(), a)
