// Shared device helpers for the port's hand-written Hopper kernels.
// Built with nvcc for sm_90a into one shared library with a plain C
// interface (see aule_tpu_torch/ops/_build.py); no PyTorch headers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aule {

// Masked-score fill / LSE of a fully masked row (aule_tpu/ops/flash.py:43).
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// dtype codes passed from Python: 0 = bfloat16, 1 = float16
constexpr int kBF16 = 0;
constexpr int kF16 = 1;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global->shared async copy; src_bytes = 0 zero-fills the slot.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-bit element helpers, one specialisation per storage type.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  __device__ __forceinline__ static float2 to_float2(uint32_t v) {
    __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
    return __bfloat1622float2(h);
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ __forceinline__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
  // D(16x8 f32) += A(16x16) * B(16x8), bf16 inputs, f32 accumulation
  __device__ __forceinline__ static void mma(float* d, uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
};

template <>
struct Elem<__half> {
  __device__ __forceinline__ static float2 to_float2(uint32_t v) {
    __half2 h = *reinterpret_cast<__half2*>(&v);
    return __half22float2(h);
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ __forceinline__ static float to_float(__half x) {
    return __half2float(x);
  }
  __device__ __forceinline__ static __half from_float(float x) {
    return __float2half(x);
  }
  __device__ __forceinline__ static void mma(float* d, uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
};

}  // namespace aule
