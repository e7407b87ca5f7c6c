// Shared pieces of the f32 kernels (paged_generic.cuh's decode,
// flash_generic.cu's delta, the masks and tile ranges of flash_f32.cu,
// flash_f32_bwd.cu and paged_prefill_f32.cu).  Each source includes it
// once, so its internal-linkage definitions are that source's own.
#pragma once

#include "common.cuh"

namespace {

using namespace aule;

constexpr int kF32 = 2;     // dtype code of f32 (ops/_build.py)
constexpr int NT = 256;     // threads per block

// load and store of one element of the input type, in f32
template <typename T>
struct Val;

template <>
struct Val<float> {
  __device__ __forceinline__ static float ld(const float* p) {
    return __ldg(p);
  }
  __device__ __forceinline__ static float st(float x) { return x; }
};

// may query qpos see key kpos (kpos below the live key count kvl)?
__device__ __forceinline__ bool visible(int qpos, int kpos, int kvl,
                                        int causal, int window) {
  bool ok = kpos < kvl;
  if (causal) ok = ok && qpos >= kpos;
  if (window > 0) {
    ok = ok && qpos - kpos <= window;
    if (!causal) ok = ok && kpos - qpos <= window;
  }
  return ok;
}

// kv tiles j_lo .. j_hi (BN keys each) hold every key of the first kvl
// that some row of q_lo .. q_hi can see
__device__ __forceinline__ void kv_range(int q_lo, int q_hi, int kvl,
                                         int causal, int window, int BN,
                                         int& j_lo, int& j_hi) {
  int k_min = 0, k_max = kvl - 1;
  if (causal) k_max = min(k_max, q_hi);
  if (window > 0) {
    k_min = max(0, q_lo - window);
    if (!causal) k_max = min(k_max, q_hi + window);
  }
  j_lo = k_min / BN;
  j_hi = (k_max >= k_min) ? k_max / BN : j_lo - 1;
}

// cudaFuncSetAttribute once per kernel (the host call stays out of a
// CUDA-graph capture after the first launch)
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

}  // namespace

