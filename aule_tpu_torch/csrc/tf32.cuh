// The 3xTF32 arithmetic of the f32 flash kernels on the tensor cores
// (flash_f32.cu's forward, flash_f32_bwd.cu's dQ and dK/dV): an f32 operand
// x is split into big = tf32(x) and small = tf32(x - big) (cvt.rna.tf32.f32,
// round to nearest, ties away from zero), and a b summed as a_small b_big +
// a_big b_small + a_big b_big on mma.sync m16n8k8 .tf32 with f32 sums (the
// small x small term, 2^-22 of |a b|, dropped).  An mma truncates its sum,
// so the kernels keep each chain of mmas short and add it to an f32 sum
// (tests/test_torch_flash_tf32.py, tests/test_torch_flash_tf32_bwd.py).
// Each source includes it once (internal linkage).
#pragma once

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// d += a b, m16n8k8, TF32 inputs, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the cross terms first, then big x big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

// The tile's rows (R of ld floats) split in place: raw values in `small`
// become their small parts, their big parts go to `big`.
template <int D, int R, int NTH>
__device__ __forceinline__ void split_rows(float* big, float* small, int ld) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < R * C; i += NTH) {
    const int at = (i / C) * ld + 4 * (i % C);
    const float4 x = *reinterpret_cast<const float4*>(small + at);
    uint32_t b[4], sm[4];
    split(x.x, b[0], sm[0]);
    split(x.y, b[1], sm[1]);
    split(x.z, b[2], sm[2]);
    split(x.w, b[3], sm[3]);
    *reinterpret_cast<uint4*>(big + at) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + at) =
        make_uint4(sm[0], sm[1], sm[2], sm[3]);
  }
}

}  // namespace
