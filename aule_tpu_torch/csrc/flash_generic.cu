// The f32 flash backward's delta (sm_90a), hand-written CUDA C++ on FFMA;
// bf16 / f16 take flash_bwd.cu's, and the f32 dQ and dK/dV are
// flash_f32_bwd.cu's 3xTF32 kernels.
//
// delta: di = rowsum(o * do) - dlse for f32 o and do at D = 64, 128 or
// 256.  It replaces no Pallas kernel: in the JAX package delta is an XLA
// fusion (aule_tpu/ops/flash_vjp.py:746-750).  What bounds it on the H100:
// bytes (o and do read once).  One warp a row, f32 sums in a fixed order,
// so two runs give the same bits.

#include "generic.cuh"

namespace {

using namespace aule;

// ---- delta: di = rowsum(o * do) - dlse, one warp a row, in a fixed order
template <typename T>
__global__ void __launch_bounds__(NT)
    flash_generic_delta_kernel(const T* __restrict__ o,
                               const T* __restrict__ dO,
                               const float* __restrict__ dlse,
                               float* __restrict__ di, int rows, int D) {
  const int row = (blockIdx.x * NT + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* a = o + (size_t)row * D;
  const T* c = dO + (size_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32)
    s = fmaf(Val<T>::ld(a + d), Val<T>::ld(c + d), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) di[row] = dlse != nullptr ? s - dlse[row] : s;
}

}  // namespace

extern "C" int aule_flash_generic_delta(const void* o, const void* dO,
                                        const void* dlse, void* di, int rows,
                                        int D, int dtype, void* stream) {
  if (dtype != kF32 || (D != 64 && D != 128 && D != 256))
    return cudaErrorInvalidValue;
  if (rows <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + NT / 32 - 1) / (NT / 32);
  flash_generic_delta_kernel<float><<<blocks, NT, 0, s>>>(
      static_cast<const float*>(o), static_cast<const float*>(dO),
      static_cast<const float*>(dlse), static_cast<float*>(di), rows, D);
  return cudaGetLastError();
}
