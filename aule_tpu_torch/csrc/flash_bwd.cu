// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernels aule_tpu/ops/flash_vjp.py::_dq_kernel (dQ,
// q-parallel, reducing over kv blocks) and ::_dkv_kernel (dK/dV,
// kv-parallel, reducing over q blocks and the GQA group's q heads); with
// window masks the same two kernels compute what ::_win_dq_kernel and
// ::_win_dkv_kernel (the banded window backward) compute.  Both recompute
// P from the LSE the forward saved, with no softmax chain:
//   p  = exp(scale * q.k - lse), 0 where masked,
//   dp = do.v,  ds = p * (dp - di) * scale,  di = rowsum(o * do) - dlse,
//   dq = ds k,  dk = ds^T q,  dv = p^T do  (dk, dv summed over the group).
// p and ds are rounded to the input type before their products (as the
// JAX kernels do, flash_vjp.py:212, 350); every sum is f32.
//
// What bounds it on the H100: Llama-3-8B's layer, B1 Hq32/Hkv8 S2048 D128
// causal, is 5 products over the live keys, 85.9 GFLOP (86.9 us at 989
// TFLOP/s bf16), against ~84 MB of q, k, v, o, do, dq, dk, dv and the row
// statistics (25 us at 3.35 TB/s): tensor-core bound.  Design:
//   * dQ: one block per (batch, kv head, q tile) holds the GQA group's q
//     and dO rows (up to 8 heads x 16 positions, or 1 x 128), as the
//     forward's block does, and walks only the live 64-key tiles (causal
//     diagonal, window band; the forward's k_min / k_max).  Each warp keeps
//     its 16 rows of dQ in registers and writes them once.
//   * dK/dV: one block per (batch, kv head, 64-key tile) keeps K and V in
//     shared memory and walks the live q tiles (flash_vjp.py::
//     _q_live_range) and, inside each, the group's q heads, so the GQA sum
//     is a loop in one block: no atomics, and the same inputs give the same
//     bits.  Each warp owns 16 keys and holds their dK and dV (2 x 64 f32
//     registers a thread); S^T and dP^T are formed 32 q rows at a time, so
//     the live scores take 32 more registers and nothing spills.
//   * tiles move with cp.async, double-buffered, into XOR-swizzled rows;
//     the products are mma.sync m16n8k16 with f32 accumulation (the
//     fragment helpers of common.cuh, shared with the forward);
//   * masks cost only on tiles that straddle an edge; rows past Sq and keys
//     past Sk are zero-filled, masked, and never written.
// wgmma, TMA and warp specialisation (FlashAttention-3) are later work.

#include "common.cuh"

namespace {

using namespace aule;

constexpr int D = kTileD;     // head dim (the only one in this slice)
constexpr int BN = kTileN;    // keys per K/V tile of the dQ walk
constexpr int ROWS = 128;     // q rows per dQ block: heads x positions
constexpr int DQ_THREADS = 256;  // 8 warps, 16 rows each
constexpr int DQ_SMEM = (2 * ROWS + 4 * BN) * kRowBytes;  // Q, dO, 2x(K,V)

constexpr int BKV = 64;       // keys per dK/dV block: 4 warps x 16
constexpr int BQ = 64;        // q rows per step of the dK/dV walk
constexpr int DKV_THREADS = 128;
constexpr int STAGE_BYTES = 2 * BQ * kRowBytes + 2 * BQ * 4;  // Q, dO, lse, di
constexpr int DKV_SMEM = 2 * BKV * kRowBytes + 2 * STAGE_BYTES;

// One 64-key tile of the dQ walk for the warp's 16 rows: S = Q K^T and
// dP = dO V^T, then dS, then dQ += dS K.  nl_* is -lse * log2(e) of rows
// a and b (-inf for rows past Sq, so their p is 0), di_* their delta.
template <typename T, typename Keep>
__device__ __forceinline__ void dq_tile(float (&acc)[D / 8][4], uint32_t sQ,
                                        uint32_t sdO, uint32_t tK,
                                        uint32_t tV, int wrow0, int lane,
                                        float sl2, float scale, float nl_a,
                                        float nl_b, float di_a, float di_b,
                                        bool need_mask, Keep keep) {
  const int t = lane & 3;
  float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], g[4];
    ldsm_a(sQ, wrow0, kk, lane, a);
    ldsm_a(sdO, wrow0, kk, lane, g);
#pragma unroll
    for (int nn = 0; nn < BN / 16; ++nn) {
      uint32_t bk[4], bv[4];
      ldsm_b(tK, nn * 16, kk, lane, bk);
      ldsm_b(tV, nn * 16, kk, lane, bv);
      mma_pair<T>(s[2 * nn], s[2 * nn + 1], a, bk);
      mma_pair<T>(dp[2 * nn], dp[2 * nn + 1], g, bv);
    }
  }
  // dS = P (dP - di) scale, P from the saved LSE; masked entries are 0
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool rb = e >= 2;
      float p = exp2f(fmaf(s[nt][e], sl2, rb ? nl_b : nl_a));
      if (need_mask && !keep(nt * 8 + 2 * t + (e & 1), rb)) p = 0.f;
      s[nt][e] = p * (dp[nt][e] - (rb ? di_b : di_a)) * scale;
    }
  // dQ += dS K, dS re-packed as A fragments
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t a[4];
    pack_a<T>(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t b[4];
      ldsm_bt(tK, kk * 16, nd, lane, b);
      mma_pair<T>(acc[2 * nd], acc[2 * nd + 1], a, b);
    }
  }
}

// q, do, dq: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D]; lse, di: [B, Hq, Sq].
// Grid: (q tiles, Hkv * group / hpb, B); hpb q heads per block.
template <typename T>
__global__ void __launch_bounds__(DQ_THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, T* __restrict__ dq,
                        int Hq, int Hkv, int Sq, int Sk, int hpb,
                        float scale, int causal, int window) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sdO = sQ + ROWS * kRowBytes;
  const uint32_t sK = sdO + ROWS * kRowBytes;
  const uint32_t sV = sK + 2 * BN * kRowBytes;

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
  const size_t kv_base = ((size_t)b * Hkv + hk) * Sk * D;

  // kv positions some row of this block can see (as flash_fwd.cu)
  int k_min = 0, k_max = Sk - 1;
  if (causal) k_max = min(k_max, q_hi);
  if (window > 0) {
    k_min = max(0, q_lo - window);
    if (!causal) k_max = min(k_max, q_hi + window);
  }
  const int j_lo = k_min / BN;
  const int j_hi = (k_max >= k_min) ? k_max / BN : j_lo - 1;

  // Q and dO tiles; block row r is (head r / bq, position r % bq)
  for (int c = tid; c < ROWS * kChunks; c += DQ_THREADS) {
    const int r = c / kChunks, ch = c % kChunks;
    const int pos = q_lo + r % bq;
    const bool ok = pos < Sq;
    const size_t off =
        (((size_t)b * Hq + h0 + r / bq) * Sq + (ok ? pos : 0)) * D + ch * 8;
    cp_async16(sQ + swz(r, ch), q + off, ok);
    cp_async16(sdO + swz(r, ch), dout + off, ok);
  }
  auto load_kv = [&](int j, int stage) {
    load_rows_async<DQ_THREADS, BN>(sK + stage * BN * kRowBytes,
                                    sV + stage * BN * kRowBytes, k + kv_base,
                                    v + kv_base, j * BN, Sk, tid);
  };
  if (j_lo <= j_hi) load_kv(j_lo, 0);
  cp_async_commit();

  // this warp's 16 rows; the thread holds rows g and g + 8 of them
  const int wrow0 = warp * 16;
  const int hw = wrow0 / bq;
  const int qpos_a = q_lo + wrow0 % bq + (lane >> 2), qpos_b = qpos_a + 8;
  const size_t row_base = ((size_t)b * Hq + h0 + hw) * Sq;
  const float nl_a = qpos_a < Sq ? -lse[row_base + qpos_a] * kLog2e
                                 : -INFINITY;
  const float nl_b = qpos_b < Sq ? -lse[row_base + qpos_b] * kLog2e
                                 : -INFINITY;
  const float di_a = qpos_a < Sq ? di[row_base + qpos_a] : 0.f;
  const float di_b = qpos_b < Sq ? di[row_base + qpos_b] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int stage = (j - j_lo) & 1;
    if (j < j_hi) load_kv(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the prefetch just issued
    __syncthreads();

    const int kv0 = j * BN;
    const bool need_mask =
        (kv0 + BN > Sk) || (causal && kv0 + BN - 1 > q_lo) ||
        (window > 0 &&
         (q_hi - kv0 > window || (!causal && kv0 + BN - 1 - q_lo > window)));
    auto keep = [&](int col, bool row_b) {
      const int kpos = kv0 + col, qpos = row_b ? qpos_b : qpos_a;
      bool ok = kpos < Sk;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) {
        ok = ok && qpos - kpos <= window;
        if (!causal) ok = ok && kpos - qpos <= window;
      }
      return ok;
    };
    dq_tile<T>(acc, sQ, sdO, sK + stage * BN * kRowBytes,
               sV + stage * BN * kRowBytes, wrow0, lane, sl2, scale, nl_a,
               nl_b, di_a, di_b, need_mask, keep);
    __syncthreads();  // this stage is refilled two iterations on
  }
  cp_async_wait<0>();
  store_rows<T>(acc, dq + row_base * D, qpos_a, qpos_b, Sq, lane);
}

// One step of the dK/dV walk: the warp's 16 keys against the staged BQ q
// rows of one head, 32 at a time: S^T = K Q^T and dP^T = V dO^T, then P
// and dS, then dV += P^T dO and dK += dS^T Q.  lse_s / di_s are the staged
// rows' statistics (shared memory).
template <typename T, typename Keep>
__device__ __forceinline__ void dkv_step(float (&dk)[D / 8][4],
                                         float (&dv)[D / 8][4], uint32_t sK,
                                         uint32_t sV, uint32_t tQ,
                                         uint32_t tdO, const float* lse_s,
                                         const float* di_s, int wrow0,
                                         int lane, float sl2, float scale,
                                         bool need_mask, Keep keep) {
  const int t = lane & 3;
#pragma unroll 1
  for (int c0 = 0; c0 < BQ; c0 += 32) {
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], g[4];
      ldsm_a(sK, wrow0, kk, lane, a);
      ldsm_a(sV, wrow0, kk, lane, g);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        uint32_t bq[4], bo[4];
        ldsm_b(tQ, c0 + nn * 16, kk, lane, bq);
        ldsm_b(tdO, c0 + nn * 16, kk, lane, bo);
        mma_pair<T>(st[2 * nn], st[2 * nn + 1], a, bq);
        mma_pair<T>(dpt[2 * nn], dpt[2 * nn + 1], g, bo);
      }
    }
    // P^T into st, dS^T into dpt; a column is one q row
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + nt * 8 + 2 * t + e;
        const float nl = -lse_s[col] * kLog2e, dcol = di_s[col];
#pragma unroll
        for (int rb = 0; rb < 2; ++rb) {
          const int idx = rb * 2 + e;
          float p = exp2f(fmaf(st[nt][idx], sl2, nl));
          if (need_mask && !keep(col, rb != 0)) p = 0.f;
          st[nt][idx] = p;
          dpt[nt][idx] = p * (dpt[nt][idx] - dcol) * scale;
        }
      }
    // dV += P^T dO, dK += dS^T Q over these 32 q rows
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t pa[4], sa[4];
      pack_a<T>(st[2 * kk], st[2 * kk + 1], pa);
      pack_a<T>(dpt[2 * kk], dpt[2 * kk + 1], sa);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bo[4], bq[4];
        ldsm_bt(tdO, c0 + kk * 16, nd, lane, bo);
        ldsm_bt(tQ, c0 + kk * 16, nd, lane, bq);
        mma_pair<T>(dv[2 * nd], dv[2 * nd + 1], pa, bo);
        mma_pair<T>(dk[2 * nd], dk[2 * nd + 1], sa, bq);
      }
    }
  }
}

// dk, dv: [B, Hkv, Sk, D].  Grid: (Sk / BKV tiles, Hkv, B).
template <typename T>
__global__ void __launch_bounds__(DKV_THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, T* __restrict__ dk,
                         T* __restrict__ dv, int Hq, int Hkv, int Sq, int Sk,
                         float scale, int causal, int window) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + BKV * kRowBytes;
  const uint32_t sStage = sV + BKV * kRowBytes;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.x * BKV;  // heaviest causal tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const size_t kv_base = ((size_t)b * Hkv + hk) * Sk * D;
  const int k_last = min(k0 + BKV, Sk) - 1;

  // q positions that see some key of this tile (flash_vjp.py:46-65)
  int q_min = 0, q_max = Sq - 1;
  if (causal) q_min = k0;
  if (window > 0) {
    q_max = min(q_max, k_last + window);
    if (!causal) q_min = max(0, k0 - window);
  }
  const int i_lo = q_min / BQ;
  const int n_steps = q_min <= q_max ? (q_max / BQ - i_lo + 1) * group : 0;

  load_rows_async<DKV_THREADS, BKV>(sK, sV, k + kv_base, v + kv_base, k0, Sk,
                                    tid);
  // step s: q tile i_lo + s / group of q head hk * group + s % group
  auto load_q = [&](int s, int stage) {
    const int pos0 = (i_lo + s / group) * BQ;
    const size_t row_base = ((size_t)b * Hq + hk * group + s % group) * Sq;
    const uint32_t dst = sStage + stage * STAGE_BYTES;
    load_rows_async<DKV_THREADS, BQ>(dst, dst + BQ * kRowBytes,
                                     q + row_base * D, dout + row_base * D,
                                     pos0, Sq, tid);
    for (int c = tid; c < 2 * BQ; c += DKV_THREADS) {  // lse, then di
      const int pos = pos0 + c % BQ;
      const bool ok = pos < Sq;
      cp_async4(dst + 2 * BQ * kRowBytes + c * 4,
                (c < BQ ? lse : di) + row_base + (ok ? pos : 0), ok);
    }
  };
  if (n_steps > 0) load_q(0, 0);
  cp_async_commit();

  const int wrow0 = warp * 16;
  const int kpos_a = k0 + wrow0 + (lane >> 2), kpos_b = kpos_a + 8;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int s = 0; s < n_steps; ++s) {
    const int stage = s & 1;
    if (s + 1 < n_steps) load_q(s + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int q0 = (i_lo + s / group) * BQ;
    // element mask only where the tile straddles an edge: q rows past Sq,
    // keys past Sk, the causal diagonal, a window edge
    const bool need_mask =
        (q0 + BQ > Sq) || (k0 + BKV > Sk) ||
        (causal && q0 < k0 + BKV - 1) ||
        (window > 0 && (q0 + BQ - 1 - k0 > window ||
                        (!causal && k0 + BKV - 1 - q0 > window)));
    auto keep = [&](int col, bool row_b) {
      const int qpos = q0 + col, kpos = row_b ? kpos_b : kpos_a;
      bool ok = qpos < Sq && kpos < Sk;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) {
        ok = ok && qpos - kpos <= window;
        if (!causal) ok = ok && kpos - qpos <= window;
      }
      return ok;
    };
    const uint32_t tQ = sStage + stage * STAGE_BYTES;
    const float* stats = reinterpret_cast<const float*>(
        smem + 2 * BKV * kRowBytes + stage * STAGE_BYTES +
        2 * BQ * kRowBytes);
    dkv_step<T>(dk_acc, dv_acc, sK, sV, tQ, tQ + BQ * kRowBytes, stats,
                stats + BQ, wrow0, lane, sl2, scale, need_mask, keep);
    __syncthreads();  // this stage is refilled two steps on
  }
  cp_async_wait<0>();
  store_rows<T>(dk_acc, dk + kv_base, kpos_a, kpos_b, Sk, lane);
  store_rows<T>(dv_acc, dv + kv_base, kpos_a, kpos_b, Sk, lane);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, void* dq, int B, int Hq,
              int Hkv, int Sq, int Sk, float scale, int causal, int window,
              cudaStream_t stream) {
  const int group = Hq / Hkv;
  int hpb = 8;  // q heads per block: the largest of 8, 4, 2, 1 dividing group
  while (group % hpb) hpb >>= 1;
  const int bq = ROWS / hpb;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DQ_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + bq - 1) / bq, Hkv * (group / hpb), B);
  flash_bwd_dq_kernel<T><<<grid, DQ_THREADS, DQ_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dq), Hq, Hkv, Sq, Sk, hpb, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* di, void* dk, void* dv, int B,
               int Hq, int Hkv, int Sq, int Sk, float scale, int causal,
               int window, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DKV_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + BKV - 1) / BKV, Hkv, B);
  flash_bwd_dkv_kernel<T><<<grid, DKV_THREADS, DKV_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, Sq, Sk, scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" int aule_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* di, void* dq, int B, int Hq,
                                 int Hkv, int Sq, int Sk, float scale,
                                 int causal, int window, int dtype,
                                 void* stream) {
  if (Sq <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == aule::kF16)
    return launch_dq<__half>(q, k, v, dout, lse, di, dq, B, Hq, Hkv, Sq, Sk,
                             scale, causal, window, s);
  return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, di, dq, B, Hq, Hkv, Sq,
                                  Sk, scale, causal, window, s);
}

extern "C" int aule_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* di, void* dk,
                                  void* dv, int B, int Hq, int Hkv, int Sq,
                                  int Sk, float scale, int causal, int window,
                                  int dtype, void* stream) {
  if (Sk <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == aule::kF16)
    return launch_dkv<__half>(q, k, v, dout, lse, di, dk, dv, B, Hq, Hkv, Sq,
                              Sk, scale, causal, window, s);
  return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, di, dk, dv, B, Hq,
                                   Hkv, Sq, Sk, scale, causal, window, s);
}
