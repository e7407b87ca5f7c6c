"""The tensor-core paged decode (csrc/paged_decode.cu) at GQA groups over 8,
with 16-row tiles (the mma fragments' rows g + 8 live: one tile for a
group of 9-16) against 8-row tiles (two tiles for such a group, each
reading the kv head's K/V), in one process on one CUDA card so that both
meet the same card.  The tile comes from ops/decode_split.py's
TC_TILE_ROWS, which the script sets; a tree whose kernel has no 16-row
instantiation (it was removed after this comparison, PERF.md)
refuses that tile, and the script prints "refused" for it.

For each group (12 and 16 over 8 kv heads, 32 over one) and pool mode
(bf16, int8 dot products with bf16 scales) at B8 ctx4096 page 16 (272-page
tables): each tile size is held to the plain version (chip_smoke.py's row
rule), then its device time per call (torch.profiler, the kernel only)
is read in the order 16, 8, 8, 16 and the two readings of each averaged.
Prints the card's name and power limit first.

    python3 scripts/torch_decode_tiles.py       # from the repo root
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as c  # noqa: E402
from aule_tpu_torch.ops import decode_split  # noqa: E402
from aule_tpu_torch.ops.paged_fused import (  # noqa: E402
    paged_attention_fused, paged_attention_fused_plain)

CASES = ((96, 8), (128, 8), (32, 1))  # (Hq, Hkv): groups 12, 16, 32
MODES = (("bf16", None, None), ("int8 dot", torch.int8, True))


def main():
    c.phase_device()
    c.phase_build()
    c.log(c.card_line())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(c.SEED + 15)
    default = decode_split.TC_TILE_ROWS
    for hq, hkv in CASES:
        q, pool, bt, ln = c._decode_inputs(gen, [4096] * 8, 272, hq=hq,
                                           hkv=hkv)
        for mode, qdt, dot in MODES:
            pl, sc = (pool, None) if qdt is None else c.quantize_pool(pool,
                                                                      qdt)
            kw = dict(kv_scales=sc, int8_matmul=dot)

            def kernel(**x):
                return paged_attention_fused(q, pl, bt, ln, **kw, **x)

            po, plse = paged_attention_fused_plain(q, pl, bt, ln,
                                                   return_lse=True, **kw)
            times = {16: [], 8: []}
            for rows in (16, 8, 8, 16):
                decode_split.TC_TILE_ROWS = rows
                what = (f"decode {mode} group {hq // hkv} Hq{hq}/Hkv{hkv} "
                        f"B8 ctx4096, {rows}-row tiles")
                try:
                    if not times[rows]:
                        o, lse = c._twice(what,
                                          lambda: kernel(return_lse=True))
                        c.hold(what, o, po, lse, plse,
                               c._tol(torch.bfloat16, bool(dot)))
                    times[rows].append(c.device_ms(kernel, key="fusedpool"))
                except RuntimeError as e:
                    c.log(f"{what}: refused ({e})")
                    times[rows].append(None)
                finally:
                    decode_split.TC_TILE_ROWS = default
            mean = {r: (None if None in t else sum(t) / len(t))
                    for r, t in times.items()}
            ratio = ("" if None in mean.values()
                     else f", 8-row / 16-row {mean[8] / mean[16]:.3f}")
            c.log(f"tiles: decode {mode} group {hq // hkv} Hq{hq}/Hkv{hkv} "
                  f"B8 ctx4096: 16-row tiles {c._ms(mean[16])} (readings "
                  f"{times[16]}), 8-row tiles {c._ms(mean[8])} (readings "
                  f"{times[8]}){ratio}")
        del q, pool
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
