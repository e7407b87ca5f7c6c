// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernels aule_tpu/ops/flash.py::_fwd_kernel (the
// general FA-2 schedule, prefill below 1024 tokens) and
// aule_tpu/ops/flash.py::_mono_kernel (causal bf16 D=128, 1024 <= S <=
// 4096): both compute softmax(scale * Q K^T + mask) V, and one Hopper
// kernel with causal tile skipping covers the two shape classes.
//
// What bounds it on the H100: Llama-3-8B prefill, B1 Hq32/Hkv8 S2048
// D128 causal, is 34.4 GFLOP per layer (34.8 us at 989 TFLOP/s bf16)
// against 42 MB of Q, K, V and O (12.5 us at 3.35 TB/s): tensor-core
// bound.  The design therefore spends its effort on keeping the
// tensor cores fed and on not doing masked work:
//   * one thread block per (batch, kv head, q tile) runs all the q heads
//     of a GQA group it can hold (up to 8) against each staged K/V tile,
//     so K/V are read from memory once per group, not once per q head
//     (the sharing _fwd_kernel gets from its flattened `group` rows);
//   * K/V tiles of 64 keys are double-buffered in shared memory with
//     cp.async (XOR-swizzled rows, so ldmatrix is bank-conflict free);
//   * QK^T and PV run on mma.sync m16n8k16 (bf16 or f16 in, f32
//     accumulate); P stays in registers between the two products;
//   * online softmax in exp2: scale*log2(e) is folded into the exp2
//     argument as one FFMA (folding it into the bf16 Q tile would round
//     it), the row sum is kept per thread and reduced once at the end;
//   * kv tiles past the causal diagonal (or outside the window) are never
//     loaded; only tiles that straddle a mask edge pay for the mask.
// wgmma, TMA and warp specialisation (FlashAttention-3) are later work;
// this kernel reaches the tensor cores only through mma.sync.

#include "common.cuh"

namespace {

using namespace aule;

constexpr int D = 128;             // head dim (the only one in this slice)
constexpr int BN = 64;             // keys per K/V tile
constexpr int ROWS = 128;          // q rows per block: heads x positions
constexpr int NWARPS = 8;          // 16 rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROW_BYTES = D * 2;   // one 16-bit row
constexpr int CHUNKS = D / 8;      // 16-byte chunks per row
constexpr int SMEM_BYTES = (ROWS + 4 * BN) * ROW_BYTES;  // Q + 2x(K,V)

// Byte offset of 16-byte chunk `c` of row `r`: chunks are XOR-swizzled by
// the row's low 3 bits so 8 consecutive rows at one logical chunk hit 8
// different bank groups.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * ROW_BYTES + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// q, o: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D]; lse: [B, Hq, Sq] or null.
// Grid: (q tiles, Hkv * group / hpb, B); hpb q heads per block.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                     int hpb, float scale, int causal, int window) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + ROWS * ROW_BYTES;
  const uint32_t sV = sK + 2 * BN * ROW_BYTES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = Hq / Hkv;
  const int bq = ROWS / hpb;  // q positions per block
  // heaviest causal tiles launch first, so the tail of the grid is short
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q_lo = qt * bq;
  const int q_hi = min(q_lo + bq, Sq) - 1;
  const int blocks_per_kv = group / hpb;
  const int hk = blockIdx.y / blocks_per_kv;
  const int h0 = hk * group + (blockIdx.y % blocks_per_kv) * hpb;
  const int b = blockIdx.z;

  const T* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * Sk * D;

  // kv positions some row of this block can see
  int k_min = 0, k_max = Sk - 1;
  if (causal) k_max = min(k_max, q_hi);
  if (window > 0) {
    k_min = max(0, q_lo - window);
    if (!causal) k_max = min(k_max, q_hi + window);
  }
  const int j_lo = k_min / BN;
  const int j_hi = (k_max >= k_min) ? k_max / BN : j_lo - 1;

  // Q tile -> shared memory; block row r is (head r / bq, position r % bq)
  for (int c = tid; c < ROWS * CHUNKS; c += NTHREADS) {
    const int r = c / CHUNKS, ch = c % CHUNKS;
    const int pos = q_lo + r % bq;
    const bool ok = pos < Sq;
    const T* src =
        q + (((size_t)b * Hq + h0 + r / bq) * Sq + (ok ? pos : 0)) * D + ch * 8;
    cp_async16(sQ + swz(r, ch), src, ok);
  }
  auto load_kv = [&](int j, int stage) {
    const int kv0 = j * BN;
    const uint32_t dK = sK + stage * BN * ROW_BYTES;
    const uint32_t dV = sV + stage * BN * ROW_BYTES;
    for (int c = tid; c < BN * CHUNKS; c += NTHREADS) {
      const int r = c / CHUNKS, ch = c % CHUNKS;
      const int pos = kv0 + r;
      const bool ok = pos < Sk;  // rows past Sk are zero-filled
      const size_t off = (size_t)(ok ? pos : 0) * D + ch * 8;
      cp_async16(dK + swz(r, ch), kb + off, ok);
      cp_async16(dV + swz(r, ch), vb + off, ok);
    }
  };
  if (j_lo <= j_hi) load_kv(j_lo, 0);
  cp_async_commit();

  // this warp's 16 rows; the thread holds rows g and g + 8 of them
  const int wrow0 = warp * 16;
  const int hw = wrow0 / bq;
  const int pos0 = q_lo + wrow0 % bq;
  const int g = lane >> 2, t = lane & 3;
  const int qpos_a = pos0 + g, qpos_b = pos0 + g + 8;
  const int lrow = lane & 7, mat = lane >> 3;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const float sl2 = scale * kLog2e;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int stage = (j - j_lo) & 1;
    if (j < j_hi) load_kv(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the prefetch just issued
    __syncthreads();

    const uint32_t tK = sK + stage * BN * ROW_BYTES;
    const uint32_t tV = sV + stage * BN * ROW_BYTES;
    const int kv0 = j * BN;

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a0, a1, a2, a3;
      ldsm_x4(sQ + swz(wrow0 + lrow + (mat & 1) * 8, kk * 2 + (mat >> 1)), a0,
              a1, a2, a3);
#pragma unroll
      for (int nn = 0; nn < BN / 16; ++nn) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(tK + swz(nn * 16 + lrow + (mat >> 1) * 8, kk * 2 + (mat & 1)),
                b0, b1, b2, b3);
        Elem<T>::mma(s[2 * nn], a0, a1, a2, a3, b0, b1);
        Elem<T>::mma(s[2 * nn + 1], a0, a1, a2, a3, b2, b3);
      }
    }

    // element mask only on tiles that straddle an edge
    const bool need_mask =
        (kv0 + BN > Sk) || (causal && kv0 + BN - 1 > q_lo) ||
        (window > 0 &&
         (q_hi - kv0 > window || (!causal && kv0 + BN - 1 - q_lo > window)));
    if (need_mask) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kv0 + nt * 8 + 2 * t + (e & 1);
          const int qpos = (e < 2) ? qpos_a : qpos_b;
          bool ok = kpos < Sk;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) {
            ok = ok && qpos - kpos <= window;
            if (!causal) ok = ok && kpos - qpos <= window;
          }
          if (!ok) s[nt][e] = -INFINITY;
        }
      }
    }

    // online softmax (scores in raw units; exp2 of s*sl2 - m*sl2)
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    // a row that has seen nothing yet keeps m = -inf: no NaN from -inf+inf
    const float alpha_a = (mx_a == -INFINITY) ? 1.f : exp2f((m_a - mx_a) * sl2);
    const float alpha_b = (mx_b == -INFINITY) ? 1.f : exp2f((m_b - mx_b) * sl2);
    const float nb_a = (mx_a == -INFINITY) ? 0.f : -mx_a * sl2;
    const float nb_b = (mx_b == -INFINITY) ? 0.f : -mx_b * sl2;
    float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = exp2f(fmaf(s[nt][0], sl2, nb_a));
      s[nt][1] = exp2f(fmaf(s[nt][1], sl2, nb_a));
      s[nt][2] = exp2f(fmaf(s[nt][2], sl2, nb_b));
      s[nt][3] = exp2f(fmaf(s[nt][3], sl2, nb_b));
      ls_a += s[nt][0] + s[nt][1];
      ls_b += s[nt][2] + s[nt][3];
    }
    l_a = l_a * alpha_a + ls_a;
    l_b = l_b * alpha_b + ls_b;
    m_a = mx_a;
    m_b = mx_b;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha_a;
      acc[i][1] *= alpha_a;
      acc[i][2] *= alpha_b;
      acc[i][3] *= alpha_b;
    }

    // O += P V: the S accumulators re-packed as A fragments
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t p0 = Elem<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t p1 = Elem<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t p2 = Elem<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t p3 = Elem<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(tV + swz(kk * 16 + lrow + (mat & 1) * 8, nd * 2 + (mat >> 1)),
                  b0, b1, b2, b3);
        Elem<T>::mma(acc[2 * nd], p0, p1, p2, p3, b0, b1);
        Elem<T>::mma(acc[2 * nd + 1], p0, p1, p2, p3, b2, b3);
      }
    }
    __syncthreads();  // this stage is refilled two iterations on
  }
  cp_async_wait<0>();

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  const size_t row_base = ((size_t)b * Hq + h0 + hw) * Sq;
  if (qpos_a < Sq) {
    uint32_t* orow = reinterpret_cast<uint32_t*>(o + (row_base + qpos_a) * D);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      orow[i * 4 + t] = Elem<T>::pack(acc[i][0] * inv_a, acc[i][1] * inv_a);
    if (lse != nullptr && t == 0)
      lse[row_base + qpos_a] =
          l_a > 0.f ? m_a * scale + logf(l_a) : kMaskValue;
  }
  if (qpos_b < Sq) {
    uint32_t* orow = reinterpret_cast<uint32_t*>(o + (row_base + qpos_b) * D);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      orow[i * 4 + t] = Elem<T>::pack(acc[i][2] * inv_b, acc[i][3] * inv_b);
    if (lse != nullptr && t == 0)
      lse[row_base + qpos_b] =
          l_b > 0.f ? m_b * scale + logf(l_b) : kMaskValue;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Hq, int Hkv, int Sq, int Sk, float scale, int causal,
           int window, cudaStream_t stream) {
  const int group = Hq / Hkv;
  int hpb = 8;  // q heads per block: the largest of 8, 4, 2, 1 dividing group
  while (group % hpb) hpb >>= 1;
  const int bq = ROWS / hpb;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + bq - 1) / bq, Hkv * (group / hpb), B);
  flash_fwd_kernel<T><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Hq, Hkv, Sq, Sk, hpb, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" int aule_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Hq, int Hkv,
                              int Sq, int Sk, float scale, int causal,
                              int window, int dtype, void* stream) {
  if (Sq <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == aule::kF16)
    return launch<__half>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale, causal,
                          window, s);
  return launch<__nv_bfloat16>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale,
                               causal, window, s);
}

extern "C" const char* aule_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
