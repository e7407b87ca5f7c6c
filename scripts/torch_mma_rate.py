"""The card's mma.sync rate: what the f32 flash kernels' products can reach.

csrc/flash_f32.cu and csrc/flash_f32_bwd.cu run their products as
mma.sync m16n8k8 .tf32 (three a pair of f32 operands, 3xTF32), the 16-bit
short kernels as mma.sync m16n8k16 .bf16; the wgmma kernels reach the
card's published tensor-core peak (989 TFLOP/s bf16, 495 TF32), mma.sync
need not.  This builds a small CUDA kernel in which every warp issues 8
independent chains of one mma shape, over 132 x 8 blocks of 256 threads,
times it with CUDA events and prints the rate in TFLOP/s and in mma a
clock an SM, with the card's name, power limit and SM clock.  Run it on
the card from the repository root (it builds into build/):

    python3 scripts/torch_mma_rate.py
"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// KIND 0: m16n8k8 .tf32 (2,048 FLOP an mma); 1: m16n8k16 .bf16 (4,096)
template <int KIND>
__global__ void __launch_bounds__(256) mma_loop(float* out, int iters) {
  float d[8][4];
  for (int j = 0; j < 8; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
  const uint32_t one = KIND == 0 ? 0x3f800000u : 0x3f803f80u;
  const uint32_t a0 = one, a1 = one ^ (threadIdx.x & 1), a2 = one, a3 = one;
  const uint32_t b0 = one, b1 = one;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  if (s == 1234.5f) out[0] = s;  // keeps the chains live
}

// ms of one launch of `blocks` x 256 threads, `iters` rounds of 8 mma a
// warp; returns cudaGetLastError()
extern "C" int mma_rate(int kind, int blocks, int iters, float* out,
                        float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {  // the first launch warms up
    cudaEventRecord(e0);
    if (kind == 0)
      mma_loop<0><<<blocks, 256>>>(out, iters);
    else
      mma_loop<1><<<blocks, 256>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
  }
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card: this script measures on one", file=sys.stderr)
        return 2
    build = Path(__file__).resolve().parents[1] / "build" / "mma_rate"
    build.mkdir(parents=True, exist_ok=True)
    cu, so = build / "mma_rate.cu", build / "libmma_rate.so"
    cu.write_text(SRC)
    nvcc = "/usr/local/cuda/bin/nvcc" if os.path.exists(
        "/usr/local/cuda/bin/nvcc") else "nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(so),
                    str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.mma_rate.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_void_p]
    lib.mma_rate.restype = ctypes.c_int
    out = torch.zeros(1, device="cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = sms * 8, 4096
    for kind, name, flop in ((0, "m16n8k8 .tf32", 2048),
                             (1, "m16n8k16 .bf16", 4096)):
        ms = ctypes.c_float()
        err = lib.mma_rate(kind, blocks, iters, out.data_ptr(),
                           ctypes.addressof(ms))
        if err:
            raise RuntimeError(f"mma_rate: CUDA error {err}")
        mmas = blocks * 8 * iters * 8  # warps x rounds x chains
        rate = mmas * flop / (ms.value * 1e-3) / 1e12
        print(f"mma.sync {name}: {ms.value:.3f} ms for {mmas} mma, "
              f"{rate:.1f} TFLOP/s ({mmas / sms / (ms.value * 1e-3):.4g} "
              f"mma a second an SM)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
