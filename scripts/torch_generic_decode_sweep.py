"""Sweep of the f32-q paged decode's plan on one CUDA card.

csrc/paged_generic.cuh fixes a block's warps (Geo<D>::NW), a warp's tile
(Geo<D>::TN) and the blocks an SM (Geo<D>::BPS, which sets both the shared
memory each block's rings take and, through ops/decode_split.py
`generic_blocks_per_sm`, the split count).  This script times, in one
process so that every variant meets the same card:

  * the split count: `generic_blocks_per_sm` 1, 2, 3 and 4 on the kernel
    as built, at GPT-2 small's engine decode (B8 ctx1024 Hq12/Hkv12 D64
    page 16), the f32 Llama layer's decode (B8 ctx4096 Hq32/Hkv8 D128) and
    D256 group 8 (B2 Hq8/Hkv1, contexts 2048 and 777);
  * the D64 block: variants of Geo<64>'s (NW, TN, BPS), each built from a
    copy of the decode's sources with those constants changed (the stages
    a warp then follow from Plan; the split count from BPS), at GPT-2's
    decode, the kernel as built among them as a control;
  * the products' share: the same K/V bytes read for GQA group 1 and for
    the timed group (D128 B8 ctx4096 over 8 kv heads, groups 1 and 4;
    D256 B2 over one kv head, groups 1 and 8): the products and their
    shared-memory reads grow with the group, the bytes do not;

each in f32 q over f32, int8 (dot products) and e4m3 pools (bf16
scales), by torch.profiler device time per call of the decode kernel
alone, beside the largest difference from the plain version.  Run from
the repository root, all sections or the ones named:

    python3 scripts/torch_generic_decode_sweep.py [blocks] [splits] [groups]
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402
from aule_tpu_torch.ops import _build, decode_split  # noqa: E402
from aule_tpu_torch.ops.paged_fused import (  # noqa: E402
    paged_attention_fused, paged_attention_fused_plain)

# Geo<64>'s (NW, TN, BPS) variants; the first is the kernel as built (8
# warps take 2 blocks an SM: at 3 the launch bounds leave 85 registers)
D64_BLOCKS = [(4, 16, 3), (4, 8, 3), (8, 8, 2), (4, 16, 2)]
# a variant builds the entry point and the D64 instantiations only
SOURCES = ["paged_generic.cu", "paged_generic_d64.cu"]
HEADERS = ["paged_generic.cuh", "generic.cuh", "paged_pool.cuh", "common.cuh"]
MODES = [("f32", None, None), ("int8 dot", torch.int8, True),
         ("fp8", torch.float8_e4m3fn, None)]
# (label, lens, Hkv, D, max_pages, groups) of the products' share
GROUP_SHAPES = [("D128 B8 ctx4096 over 8 kv heads", [4096] * 8, 8, 128, 272,
                 (1, 4)),
                ("D256 B2 ctx2048/777 over 1 kv head", [2048, 777], 1, 256,
                 128, (1, 8))]
SHAPES = [  # (label, lens, (Hq, Hkv, D), max_pages)
    ("GPT-2 B8 ctx1024", [1024] * 8, c.GPT2_HEADS, 64),
    ("f32 Llama layer B8 ctx4096", [4096] * 8, c.LLAMA_F32, 272),
    ("D256 group 8 B2 ctx2048/777", [2048, 777], c.D256_F32, 128)]


def build_variants(blocks, out: Path) -> list:
    """The decode's entry point and D64 source with Geo<64>'s NW, TN and
    BPS set, one library each (the same nvcc flags as ops/_build.py; every
    source of every variant compiled at once; the other head dims
    refused), and the ptxas lines of each."""
    subs = [(r"static constexpr int BPS = D > 128 \? 1 : 3;",
             "static constexpr int BPS = D > 128 ? 1 : D == 64 ? {bps} : 3;"),
            (r"static constexpr int NW = D > 128 \? 8 : 4;",
             "static constexpr int NW = D > 128 ? 8 : D == 64 ? {nw} : 4;"),
            (r"static constexpr int TN = D == 64 \? 16 :",
             "static constexpr int TN = D == 64 ? {tn} :")]
    jobs = []
    for nw, tn, bps in blocks:
        tmp = Path(tempfile.mkdtemp(dir=out))
        for name in SOURCES + HEADERS:
            shutil.copy(_build.CSRC / name, tmp / name)
        h = tmp / "paged_generic.cuh"
        text = h.read_text()
        for pat, rep in subs:
            text, n = re.subn(pat, rep.format(nw=nw, tn=tn, bps=bps), text)
            if n != 1:
                raise RuntimeError("Geo<D> no longer reads as this script "
                                   "expects")
        h.write_text(text)
        entry = tmp / "paged_generic.cu"
        text = entry.read_text()
        for line in ("AULE_GENERIC_DECODE_DIM(, 128);",
                     "AULE_GENERIC_DECODE_DIM(extern, 256);",
                     "    case 128: return by_layout<128>(layout, pool, a);",
                     "    case 256: return by_layout<256>(layout, pool, a);"):
            if line not in text:
                raise RuntimeError("paged_generic.cu no longer reads as this "
                                   "script expects")
            text = text.replace(line + "\n", "")
        entry.write_text(text)
        procs = [subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-c", str(tmp / name), "-o",
             str(tmp / (name + ".o"))], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for name in SOURCES]
        jobs.append((tmp, procs))
    libs = []
    for (nw, tn, bps), (tmp, procs) in zip(blocks, jobs):
        logs = []
        for p in procs:
            log, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(log)
            logs.append(log)
        so = out / f"libgeneric_nw{nw}_tn{tn}_bps{bps}.so"
        subprocess.run([_build._nvcc(), "-shared",
                        *[str(tmp / (n + ".o")) for n in SOURCES], "-o",
                        str(so)], check=True)
        shutil.rmtree(tmp)
        lib = ctypes.CDLL(str(so))
        fn = lib.aule_paged_generic_decode
        fn.argtypes = _build.SIGNATURES["aule_paged_generic_decode"]
        fn.restype = ctypes.c_int
        regs = re.findall(r"paged_generic_decode_kernelILi(\d)ELi64ELi1E.*?"
                          r"FusedLayout.*?Used (\d+) registers", "".join(logs),
                          re.S)
        spills = re.findall(r"(\d+) bytes spill stores", "".join(logs))
        libs.append((lib, {f"pool {p} R1": int(r) for p, r in regs},
                     max(map(int, spills or [0]))))
    return libs


class _Library:
    """The kernels' library with the decode entry of a variant."""

    def __init__(self, base, variant):
        self._base = base
        self.aule_paged_generic_decode = variant.aule_paged_generic_decode

    def __getattr__(self, name):
        return getattr(self._base, name)


def time_modes(gen, lens, heads, max_pages):
    """{mode: (device us per call, max |out - plain|)} at one shape."""
    hq, hkv, d = heads
    pool, bt = c._generic_pool(gen, lens, max_pages, 16, hkv, d,
                               torch.float32, False)
    q = c._randn((len(lens), hq, d), gen, torch.float32)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    res = {}
    for mode, qdt, dot in MODES:
        pl, sc = c._gen_quantized(pool, qdt)
        kw = dict(kv_scales=sc, int8_matmul=dot)
        fn = lambda: paged_attention_fused(q, pl, bt, ln, **kw)
        err = (fn() - paged_attention_fused_plain(q, pl, bt, ln, **kw)
               ).abs().max().item()
        ms = c.device_ms(fn, key="fusedlayout")
        res[mode] = (None if ms is None else round(ms * 1e3, 2),
                     float(f"{err:.2e}"))
    return res


def main(sections):
    kind = c.phase_device()
    c.phase_build()
    base = _build.library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(c.SEED + 1700)
    built = decode_split.generic_blocks_per_sm
    # the products' share and the D64 block first: after many profiled
    # sessions the profiler loses kernels
    for label, lens, hkv, d, max_pages, groups in (
            GROUP_SHAPES if "groups" in sections else []):
        for group in groups:
            print(f"{kind} sweep {label} group {group}: "
                  f"{time_modes(gen, lens, (hkv * group, hkv, d), max_pages)}",
                  flush=True)
    label, lens, heads, max_pages = SHAPES[0]
    out = Path("build") / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    blocks = D64_BLOCKS if "blocks" in sections else []
    for (nw, tn, bps), (lib, regs, spill) in zip(
            blocks, build_variants(blocks, out)):
        _build._State.lib = _Library(base, lib)
        decode_split.generic_blocks_per_sm = (
            lambda d, q, b=bps: b if d == 64 else built(d, q))
        print(f"{kind} sweep {label} D64 block NW {nw} TN {tn} BPS {bps} "
              f"(R1 registers {regs}, most spill {spill} B): "
              f"{time_modes(gen, lens, heads, max_pages)}", flush=True)
    decode_split.generic_blocks_per_sm = built
    _build._State.lib = base
    # the split count, on the kernel as built
    for label, lens, heads, max_pages in (
            SHAPES if "splits" in sections else []):
        for bps in (1, 2, 3, 4):
            decode_split.generic_blocks_per_sm = lambda d, q, b=bps: b
            nsplit = decode_split.num_splits(
                len(lens), heads[1], max_pages * 16, -1,
                decode_split.sm_count(torch.device("cuda")),
                decode_split.row_tiles(heads[0] // heads[1],
                                       decode_split.generic_tile_rows(
                                           heads[0] // heads[1])), bps)
            print(f"{kind} sweep {label} blocks_per_sm {bps} (nsplit "
                  f"{nsplit}; as built: f32 {built(heads[2], False)}, "
                  f"1-byte {built(heads[2], True)}): "
                  f"{time_modes(gen, lens, heads, max_pages)}", flush=True)
        decode_split.generic_blocks_per_sm = built


if __name__ == "__main__":
    main(sys.argv[1:] or ["blocks", "splits", "groups"])
