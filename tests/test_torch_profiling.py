"""The port's profiling helpers (aule_tpu_torch/utils/profiling.py) against
the JAX package's (aule_tpu/utils/profiling.py): `attention_flops` over
causal, window and backward cases exactly, the peak table's H100 entry,
and `roofline_fraction` / `decode_speed_of_light_toks` equal to JAX's
formulas with the H100 peaks in JAX's table.  Without a card,
`device_peaks()` with no kind, `benchmark` and `trace` raise (no CPU
fallback)."""

import itertools

import pytest
import torch

from aule_tpu.utils import profiling as jp
from aule_tpu_torch.utils import profiling as tp
from aule_tpu_torch.utils.testing import cap_cpu_threads

cap_cpu_threads()

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize(
    "shape,causal,window,backward",
    [(s, c, w, b) for s, c, w, b in itertools.product(
        [(1, 32, 2048, 2048, 128), (4, 8, 512, 4096, 64),
         (2, 12, 1, 1024, 64), (1, 1, 0, 0, 32)],
        [False, True], [-1, 0, 256, 5000], [False, True])])
def test_attention_flops_matches_jax(shape, causal, window, backward):
    assert tp.attention_flops(*shape, causal=causal, window=window,
                              backward=backward) == jp.attention_flops(
        *shape, causal=causal, window=window, backward=backward)


def test_attention_flops_keeps_its_callers_numbers():
    """The port's callers pass (B, H, Sq, Sk, D, causal=): 4*B*H*Sq*Sk*D,
    halved for causal, as before the window and backward options."""
    assert tp.attention_flops(1, 32, 2048, 2048, 128, causal=True) == \
        0.5 * 4.0 * 32 * 2048 * 2048 * 128
    assert tp.attention_flops(2, 8, 7, 9, 64) == 4.0 * 2 * 8 * 7 * 9 * 64


def test_peaks_table():
    assert tp.device_peaks(H100) == (989.0, 3.35)
    assert tp.device_peaks("h100 pcie") == (989.0, 3.35)
    assert tp.device_peaks("some other card") == tp.DEVICE_PEAKS["default"]
    assert tp.DEVICE_PEAKS["h100"][0] * 1e12 == tp.H100_BF16_FLOPS
    assert tp.DEVICE_PEAKS["h100"][1] * 1e12 == tp.H100_HBM_BYTES


def test_peak_functions_match_jax_formulas(monkeypatch):
    monkeypatch.setitem(jp.DEVICE_PEAKS, "h100", tp.DEVICE_PEAKS["h100"])
    for tflops in (1.0, 450.5, 989.0):
        assert tp.roofline_fraction(tflops, H100) == \
            jp.roofline_fraction(tflops, H100)
    for args in [(8, 8, 4096, 128, 2), (8, 8, 4096, 128, 1.0),
                 (1, 1, 17, 64, 4), (64, 12, 1024, 64, 2)]:
        assert tp.decode_speed_of_light_toks(*args, device_kind=H100) == \
            jp.decode_speed_of_light_toks(*args, device_kind=H100)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: these measure on it")
def test_card_measurements_raise_without_a_card(tmp_path):
    with pytest.raises(RuntimeError):
        tp.device_peaks()
    with pytest.raises(RuntimeError):
        tp.roofline_fraction(1.0)
    with pytest.raises(RuntimeError):
        tp.benchmark(lambda x: x + 1, torch.zeros(4))
    with pytest.raises(RuntimeError):
        with tp.trace(str(tmp_path / "trace.json")):
            pass
    assert not (tmp_path / "trace.json").exists()
