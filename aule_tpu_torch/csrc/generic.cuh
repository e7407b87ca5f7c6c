// Shared pieces of the f32 kernels (flash_generic.cu, paged_generic.cu,
// and flash_f32.cu's masks): f32 tiles in shared memory, rows padded to D +
// 4 floats, read 16 bytes at a time by a 16 x 16 grid of threads, and the
// dispatch over the head dims those kernels take.  Each source includes it once, so its
// internal-linkage definitions are that source's own.
#pragma once

#include "common.cuh"

namespace {

using namespace aule;

constexpr int kF32 = 2;     // dtype code of f32 (ops/_build.py)
constexpr int NT = 256;     // threads per block: 16 x 16
constexpr int TX = 16;

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

// Tile shape by head dim: BM q rows, BN keys; f32 rows of LD floats,
// score rows (P, dS) of LP floats.
template <int D>
struct Tiles {
  static constexpr int BM = D > 128 ? 32 : 64;
  static constexpr int BN = BM;
  static constexpr int LD = D + 4;
  static constexpr int LP = BN + 4;
  static constexpr int RM = BM / TX;  // q rows per thread
  static constexpr int CN = BN / TX;  // keys per thread in a score tile
  static constexpr int RN = BN / TX;  // kv rows per thread (dK/dV)
  static constexpr int CD = D / TX;   // output columns per thread
  static constexpr int G = D / 64;    // 64-column groups, 4 a thread each
};

// Rows row0 .. row0 + R - 1 of src [S, D] -> dst [R][D + 4] f32; rows at or
// past S are zeros.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int S) {
  constexpr int LD = D + 4, H = D / 2;
  for (int i = threadIdx.x; i < R * H; i += NT) {
    const int r = i / H, d = i % H, pos = row0 + r;
    float x1 = 0.f, x2 = 0.f;
    if (pos < S) {
      x1 = Val<T>::ld(src + (size_t)pos * D + d);
      x2 = Val<T>::ld(src + (size_t)pos * D + d + H);
    }
    dst[r * LD + d] = x1;
    dst[r * LD + d + H] = x2;
  }
}

// s[i][j] = A[ty * RM + i] . B[tx + 16 j] over D (the rows of two tiles)
template <int D, int RM, int CN>
__device__ __forceinline__ void dot_rows(float (&s)[RM][CN], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[RM], y[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + (ty * RM + i) * LD + d);
#pragma unroll
    for (int j = 0; j < CN; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + (tx + TX * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
  }
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc[i][4 g + e] += sum_j W[ty * RM + i][j] * X[j][64 g + 4 tx + e] over
// the K rows of X (W: rows of LP floats, X: rows of D + 4 floats)
template <int D, int RM, int K, int LP>
__device__ __forceinline__ void acc_rows(float (&acc)[RM][D / TX],
                                         const float* w, const float* x,
                                         int ty, int tx) {
  constexpr int LD = D + 4, G = D / 64;
#pragma unroll 2
  for (int j = 0; j < K; j += 4) {
    float4 p[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      p[i] = *reinterpret_cast<const float4*>(w + (ty * RM + i) * LP + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            x + (j + jj) * LD + 64 * g + 4 * tx);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float pj = comp(p[i], jj);
          acc[i][4 * g] = fmaf(pj, v.x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(pj, v.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pj, v.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pj, v.w, acc[i][4 * g + 3]);
        }
      }
  }
}

// max and sum over the 16 threads of a row (lanes that differ in tx)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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

// f32 at D 64 / 128 / 256; anything else is refused
#define AULE_GENERIC_F32_DISPATCH(FN, ...)                      \
  switch (dtype * 1000 + D) {                                   \
    case kF32 * 1000 + 64: return FN<float, 64>(__VA_ARGS__);   \
    case kF32 * 1000 + 128: return FN<float, 128>(__VA_ARGS__); \
    case kF32 * 1000 + 256: return FN<float, 256>(__VA_ARGS__); \
    default: return cudaErrorInvalidValue;                      \
  }
