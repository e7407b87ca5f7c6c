// Flash attention backward for what the tensor-core kernels do not take
// (sm_90a): f32 inputs at D = 64, 128 or 256 (bf16 / f16 run on
// flash_bwd.cu at every head dim; the f32 forward is flash_f32.cu's
// 3xTF32 kernel, whose LSE this backward takes).  Hand-written CUDA C++,
// products on FFMA.
//
// Replaces, in f32, the TPU kernels aule_tpu/ops/flash_vjp.py::_dq_kernel
// and ::_dkv_kernel (and their window forms _win_dq_kernel and
// _win_dkv_kernel).  It computes what they compute: the backward's delta,
// dQ and dK/dV from the saved LSE, with causal and window masks, GQA and
// Sq != Sk.
//
// What bounds it on the H100: the products run at the card's f32 FFMA
// rate (67 TFLOP/s); moving them to the tensor cores in 3xTF32, as the
// forward did, is the next step.  The design is the simplest one that
// stays within that rate's reach:
//   * one block of 256 threads (16 x 16) per (q tile, head, batch) for
//     dQ, per (kv tile, q head, batch) for dK/dV; tiles of 64 rows and 64
//     keys (32 and 32 at D = 256, to stay in 227 KB);
//   * every tile in shared memory as f32 rows padded to D + 4 floats, so
//     each thread reads 16 bytes at a time and the 16 threads of a
//     half-warp meet distinct bank groups;
//   * a thread holds a 4 x 4 (2 x 2 at D = 256) block of the score tile
//     and a row block x D / 16 columns of its output, so a 16-byte read
//     feeds 4 to 16 FFMAs; dS goes through shared memory to the second
//     product;
//   * no atomics: dQ sums the kv tiles in one block, a dK/dV block the q
//     tiles of one q head; with GQA each head's f32 share goes to a
//     workspace and a second kernel sums the group's shares in head order,
//     so two runs give the same bits (with a group of 8 at Hkv 1, one block
//     per kv tile walking the whole group left most of the card idle).
// Tiles outside the causal diagonal or the window are skipped; rows at or
// past S load as zeros and are never written.

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

// p and ds of one score element: p = exp(scale s - lse) where visible,
// ds = p (dp - di) scale
__device__ __forceinline__ void p_ds(float s, float dp, float lse_r,
                                     float di_r, bool ok, float scale,
                                     float& p, float& ds) {
  p = ok ? expf(s * scale - lse_r) : 0.f;
  ds = p * (dp - di_r) * scale;
}

// ---- dQ: dq = ds k over the live kv tiles.  Grid: (q tiles, Hq, B).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_generic_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dO,
                            const float* __restrict__ lse,
                            const float* __restrict__ di, T* __restrict__ dq,
                            int Hq, int Hkv, int Sq, int Sk, float scale,
                            int causal, int window) {
  using L = Tiles<D>;
  constexpr int BM = L::BM, BN = L::BN, LD = L::LD, LP = L::LP, RM = L::RM,
                CN = L::CN, CD = L::CD, G = L::G;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + BM * LD;  // dO
  float* sK = sO + BM * LD;
  float* sV = sK + BN * LD;
  float* sS = sV + BN * LD;  // dS

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  int j_lo, j_hi;
  kv_range(q_lo, min(q_lo + BM, Sq) - 1, Sk, causal, window, BN, j_lo,
           j_hi);
  const size_t row0 = ((size_t)b * Hq + h) * Sq;
  const T* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * Sk * D;
  load_tile<T, D, BM>(sQ, q + row0 * D, q_lo, Sq);
  load_tile<T, D, BM>(sO, dO + row0 * D, q_lo, Sq);

  const int qpos0 = q_lo + ty * RM;
  float lse_r[RM], di_r[RM], acc[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const bool in = qpos0 + i < Sq;
    lse_r[i] = in ? lse[row0 + qpos0 + i] : 0.f;
    di_r[i] = in ? di[row0 + qpos0 + i] : 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int j = j_lo; j <= j_hi; ++j) {
    const int kv0 = j * BN;
    __syncthreads();
    load_tile<T, D, BN>(sK, kb, kv0, Sk);
    load_tile<T, D, BN>(sV, vb, kv0, Sk);
    __syncthreads();
    float s[RM][CN], dp[RM][CN];
    dot_rows<D, RM, CN>(s, sQ, sK, ty, tx);
    dot_rows<D, RM, CN>(dp, sO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) {
        const int qpos = qpos0 + i, kpos = kv0 + tx + TX * jj;
        float p, ds;
        p_ds(s[i][jj], dp[i][jj], lse_r[i], di_r[i],
             qpos < Sq && visible(qpos, kpos, Sk, causal, window), scale, p,
             ds);
        sS[(ty * RM + i) * LP + tx + TX * jj] = ds;
      }
    __syncthreads();
    acc_rows<D, RM, BN, LP>(acc, sS, sK, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qpos = qpos0 + i;
    if (qpos >= Sq) continue;
    T* row = dq + (row0 + qpos) * D;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        row[64 * g + 4 * tx + e] = Val<T>::st(acc[i][4 * g + e]);
  }
}

// ---- dK/dV: dk = ds^T q and dv = p^T do over the live q tiles of one q
// head; without GQA written as dk, dv, else as f32 shares [group][B, Hkv,
// Sk, D] (dK's, then dV's) in `ws` for flash_generic_dkv_kernel_sum.
// Grid: (kv tiles, Hq, B).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_generic_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dO,
                             const float* __restrict__ lse,
                             const float* __restrict__ di,
                             T* __restrict__ dk, T* __restrict__ dv,
                             float* __restrict__ ws, int Hq, int Hkv, int Sq,
                             int Sk, float scale, int causal, int window) {
  using L = Tiles<D>;
  constexpr int BM = L::BM, BN = L::BN, LD = L::LD, LP = L::LP, RM = L::RM,
                CN = L::CN, RN = L::RN, CD = L::CD, G = L::G;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BN * LD;
  float* sQ = sV + BN * LD;
  float* sO = sQ + BM * LD;  // dO
  float* sP = sO + BM * LD;
  float* sS = sP + BM * LP;  // dS
  float* sLse = sS + BM * LP;
  float* sDi = sLse + BM;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int group = Hq / Hkv;
  const int kv_lo = blockIdx.x * BN, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int kv_hi = min(kv_lo + BN, Sk) - 1;
  const size_t kvoff = ((size_t)b * Hkv + hk) * Sk * D;
  load_tile<T, D, BN>(sK, k + kvoff, kv_lo, Sk);
  load_tile<T, D, BN>(sV, v + kvoff, kv_lo, Sk);

  // q rows that see some key of this tile
  int q_min = 0, q_max = Sq - 1;
  if (causal) q_min = kv_lo;
  if (window > 0) {
    q_max = min(q_max, kv_hi + window);
    if (!causal) q_min = max(q_min, kv_lo - window);
  }
  const int t_lo = q_min / BM;
  const int t_hi = q_max >= q_min ? q_max / BM : t_lo - 1;

  float ak[RN][CD], av[RN][CD];
#pragma unroll
  for (int i = 0; i < RN; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) ak[i][c] = av[i][c] = 0.f;

  {
    const size_t row0 = ((size_t)b * Hq + h) * Sq;
    for (int t = t_lo; t <= t_hi; ++t) {
      const int q_lo = t * BM;
      __syncthreads();  // the last tile's readers are done
      load_tile<T, D, BM>(sQ, q + row0 * D, q_lo, Sq);
      load_tile<T, D, BM>(sO, dO + row0 * D, q_lo, Sq);
      for (int r = tid; r < BM; r += NT) {
        const bool in = q_lo + r < Sq;
        sLse[r] = in ? lse[row0 + q_lo + r] : 0.f;
        sDi[r] = in ? di[row0 + q_lo + r] : 0.f;
      }
      __syncthreads();
      float s[RM][CN], dp[RM][CN];
      dot_rows<D, RM, CN>(s, sQ, sK, ty, tx);
      dot_rows<D, RM, CN>(dp, sO, sV, ty, tx);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int jj = 0; jj < CN; ++jj) {
          const int r = ty * RM + i, qpos = q_lo + r;
          const int kpos = kv_lo + tx + TX * jj;
          float p, ds;
          p_ds(s[i][jj], dp[i][jj], sLse[r], sDi[r],
               qpos < Sq && visible(qpos, kpos, Sk, causal, window), scale,
               p, ds);
          sP[r * LP + tx + TX * jj] = p;
          sS[r * LP + tx + TX * jj] = ds;
        }
      __syncthreads();
      // dv[kr] += sum_r p[r][kr] do[r], dk[kr] += sum_r ds[r][kr] q[r]
      for (int r = 0; r < BM; ++r) {
        float pr[RN], sr[RN];
#pragma unroll
        for (int i = 0; i < RN; ++i) {
          pr[i] = sP[r * LP + ty * RN + i];
          sr[i] = sS[r * LP + ty * RN + i];
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 xo =
              *reinterpret_cast<const float4*>(sO + r * LD + 64 * g + 4 * tx);
          const float4 xq =
              *reinterpret_cast<const float4*>(sQ + r * LD + 64 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < RN; ++i) {
            av[i][4 * g] = fmaf(pr[i], xo.x, av[i][4 * g]);
            av[i][4 * g + 1] = fmaf(pr[i], xo.y, av[i][4 * g + 1]);
            av[i][4 * g + 2] = fmaf(pr[i], xo.z, av[i][4 * g + 2]);
            av[i][4 * g + 3] = fmaf(pr[i], xo.w, av[i][4 * g + 3]);
            ak[i][4 * g] = fmaf(sr[i], xq.x, ak[i][4 * g]);
            ak[i][4 * g + 1] = fmaf(sr[i], xq.y, ak[i][4 * g + 1]);
            ak[i][4 * g + 2] = fmaf(sr[i], xq.z, ak[i][4 * g + 2]);
            ak[i][4 * g + 3] = fmaf(sr[i], xq.w, ak[i][4 * g + 3]);
          }
        }
      }
    }
  }

  // this head's share: f32 in the workspace (head h % group's slice), or
  // the result itself without GQA
  const size_t n = (size_t)gridDim.z * Hkv * Sk * D;
  float* wk = ws != nullptr ? ws + (size_t)(h % group) * 2 * n : nullptr;
#pragma unroll
  for (int i = 0; i < RN; ++i) {
    const int kpos = kv_lo + ty * RN + i;
    if (kpos >= Sk) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t at = kvoff + (size_t)kpos * D + 64 * g + 4 * tx + e;
        if (ws != nullptr) {
          wk[at] = ak[i][4 * g + e];
          wk[n + at] = av[i][4 * g + e];
        } else {
          dk[at] = Val<T>::st(ak[i][4 * g + e]);
          dv[at] = Val<T>::st(av[i][4 * g + e]);
        }
      }
  }
}

// dk, dv = the sums of the group's f32 shares in `ws`, in head order.
template <typename T>
__global__ void __launch_bounds__(NT)
    flash_generic_dkv_kernel_sum(const float* __restrict__ ws,
                                 T* __restrict__ dk, T* __restrict__ dv,
                                 size_t n, int group) {
  for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < n;
       i += (size_t)gridDim.x * NT) {
    float sk = 0.f, sv = 0.f;
    for (int g = 0; g < group; ++g) {
      sk += ws[(size_t)g * 2 * n + i];
      sv += ws[(size_t)g * 2 * n + n + i];
    }
    dk[i] = Val<T>::st(sk);
    dv[i] = Val<T>::st(sv);
  }
}

// ---- host side: one launcher per kernel, instantiated for the (type, D)
// pairs the tensor-core kernels leave (see the dispatch below)

template <int D>
constexpr size_t dq_smem() {
  using L = Tiles<D>;
  return sizeof(float) * (2 * (L::BM + L::BN) * L::LD + L::BM * L::LP);
}

template <int D>
constexpr size_t dkv_smem() {
  using L = Tiles<D>;
  return sizeof(float) *
         (2 * (L::BM + L::BN) * L::LD + 2 * L::BM * L::LP + 2 * L::BM);
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* dO,
       const void* lse, const void* di, void* dq_, int B, int Hq, int Hkv,
       int Sq, int Sk, float scale, int causal, int window,
       cudaStream_t stream) {
  static bool done = false;
  constexpr size_t smem = dq_smem<D>();
  cudaError_t err = allow_smem(flash_generic_dq_kernel<T, D>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + Tiles<D>::BM - 1) / Tiles<D>::BM, Hq, B);
  flash_generic_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dq_), Hq, Hkv, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

template <typename T, int D>
int dkv(const void* q, const void* k, const void* v, const void* dO,
        const void* lse, const void* di, void* dk, void* dv, void* ws, int B,
        int Hq, int Hkv, int Sq, int Sk, float scale, int causal, int window,
        cudaStream_t stream) {
  static bool done = false;
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t err = allow_smem(flash_generic_dkv_kernel<T, D>, smem, done);
  if (err != cudaSuccess) return err;
  const int group = Hq / Hkv;
  if (group > 1 && ws == nullptr) return cudaErrorInvalidValue;
  const dim3 grid((Sk + Tiles<D>::BN - 1) / Tiles<D>::BN, Hq, B);
  flash_generic_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dk), static_cast<T*>(dv),
      group > 1 ? static_cast<float*>(ws) : nullptr, Hq, Hkv, Sq, Sk, scale,
      causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess || group == 1) return err;
  const size_t n = (size_t)B * Hkv * Sk * D;
  const size_t want = (n + NT - 1) / NT;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  flash_generic_dkv_kernel_sum<T><<<blocks, NT, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(dk),
      static_cast<T*>(dv), n, group);
  return cudaGetLastError();
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

extern "C" int aule_flash_generic_dq(const void* q, const void* k,
                                     const void* v, const void* dO,
                                     const void* lse, const void* di,
                                     void* dq_, int B, int Hq, int Hkv,
                                     int Sq, int Sk, int D, float scale,
                                     int causal, int window, int dtype,
                                     void* stream) {
  if (Sq <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  AULE_GENERIC_F32_DISPATCH(dq, q, k, v, dO, lse, di, dq_, B, Hq, Hkv, Sq,
                            Sk, scale, causal, window, s)
}

// ws: f32 workspace of 2 * (Hq / Hkv) * B * Hkv * Sk * D floats when
// Hq > Hkv (the group's shares of dK and dV), else null.
extern "C" int aule_flash_generic_dkv(const void* q, const void* k,
                                      const void* v, const void* dO,
                                      const void* lse, const void* di,
                                      void* dk, void* dv, void* ws, int B,
                                      int Hq, int Hkv, int Sq, int Sk, int D,
                                      float scale, int causal, int window,
                                      int dtype, void* stream) {
  if (Sk <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  AULE_GENERIC_F32_DISPATCH(dkv, q, k, v, dO, lse, di, dk, dv, ws, B, Hq,
                            Hkv, Sq, Sk, scale, causal, window, s)
}
