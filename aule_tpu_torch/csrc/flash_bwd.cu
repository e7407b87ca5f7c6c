// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernels aule_tpu/ops/flash_vjp.py::_dq_kernel (dQ,
// q-parallel, reducing over kv blocks) and ::_dkv_kernel (dK/dV,
// kv-parallel, reducing over q blocks and the GQA group's q heads); with
// window masks the same two kernels compute what ::_win_dq_kernel and
// ::_win_dkv_kernel (the banded window backward) compute.  A third, small
// kernel computes delta (flash_vjp.py:746-750, an XLA fusion in JAX).
// Both big kernels recompute P from the LSE the forward saved, with no
// softmax chain:
//   p  = exp(scale * q.k - lse), 0 where masked,
//   dp = do.v,  ds = p * (dp - di) * scale,  di = rowsum(o * do) - dlse,
//   dq = ds k,  dk = ds^T q,  dv = p^T do  (dk, dv summed over the group).
// p and ds are rounded to the input type before their products (as the
// JAX kernels do, flash_vjp.py:212, 350); every sum is f32.  No atomics:
// every sum has a fixed order, so the same inputs give the same bits.
//
// What bounds it on the H100: Llama-3-8B's layer, B1 Hq32/Hkv8 S2048 D128
// causal, is 5 products over the live keys, 85.9 GFLOP (86.9 us at 989
// TFLOP/s bf16), against ~84 MB of q, k, v, o, do, dq, dk, dv and the row
// statistics (25 us at 3.35 TB/s): tensor-core bound.  Both kernels take
// the forward's (flash_fwd.cu) Hopper machinery from hopper.cuh: TMA loads
// of 128-byte swizzled tiles through rank-3 maps over [B x heads, S, 128]
// (ragged rows load as zeros, stores are clipped), an mbarrier ring, a
// producer warpgroup that gives up registers (setmaxnreg 24) and two
// consumer warpgroups that take them (240), wgmma with f32 sums in
// registers and the p / ds operands rounded in registers, never stored.
//   * dQ: one block per (batch, q head, 128-row q tile), the group's heads
//     adjacent in launch order (their K/V reads meet in L2), heaviest
//     causal tiles first.  Each consumer warpgroup holds 64 q rows of Q and
//     dO (resident in shared memory) and their lse and di (registers); a
//     4-stage ring streams the live 64-key K/V tiles (causal diagonal,
//     window band).  S = Q K^T and dP = dO V^T are wgmma m64n64k16 from
//     shared memory (both K-major), in two commit groups, so P is computed
//     while dP is still in flight; dQ += dS K is m64n128k16 with dS from
//     registers and K read MN-major.
//   * dK/dV: one block per (batch, key tile of 128, q heads), key tile 0
//     (the longest causal walk) first.  K and V stay resident; each
//     consumer warpgroup owns 64 keys and a 3-stage ring brings 64 q rows
//     of Q and dO at a time (TMA) with their -lse / scale and -di (copied
//     by a second producer warp).  S^T = K Q^T and dP^T = V dO^T are
//     m64n64k16 (K-major), accumulated onto those row statistics (so they
//     take no registers of their own); dV += P^T dO and dK += dS^T Q are
//     m64n128k16 with P^T / dS^T from registers and dO / Q MN-major.  dV
//     and dK are two passes over the same steps, each with one 64 x 128
//     f32 sum a thread: with both sums in one loop ptxas serialised every
//     wgmma (C7512, at 32 or 64 q rows a step), and the second pass's
//     extra S^T product costs less than that did (PERF.md, Findings).
//     The GQA group sum without atomics: the two blocks of a key tile that
//     take the two halves of its group's q heads (each walks its half's
//     heads in turn) are one thread-block cluster.  After each pass both
//     write their f32 share into their own shared memory, the cluster
//     syncs, and each sums half of the elements over ranks 0 and 1 in
//     order through distributed shared memory, then stores them: f32, a
//     fixed order, no partials in device memory.  Clusters of 4 or 8 (one
//     head a block) were slower: a cluster launches only where that many
//     SMs are free at once, and with one block an SM that left SMs idle.
//   * delta: one pass over o and do with 16-byte loads, 16 threads a row.
// Each wgmma product has one code site: with a product at several, ptxas
// serialises every wgmma (C7518/C7512; PERF.md, Findings).

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace aule;
using namespace aule::hopper;

constexpr int D = kTileD;       // head dim (the only one)
constexpr int ROW_BYTES = 128;  // a swizzled half-row: 64 values
constexpr int WG_ROWS = 64;     // rows per consumer warpgroup
constexpr int NTHREADS = 3 * 128;  // producer WG + 2 consumer WGs
static_assert(D == 128, "two 64-column halves per row");

// 2^x by the card's ex2.approx.ftz (as flash_fwd.cu)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Offset (in 16-byte units, for a wgmma descriptor) of k-step kk (values
// 16kk .. 16kk + 15) of a K-major tile of `rows` rows: in half kk / 4,
// 32 bytes per step into it.
__host__ __device__ constexpr int kstep(int kk, int rows) {
  return ((kk / 4) * rows * ROW_BYTES + (kk % 4) * 32) >> 4;
}

// Offset (16-byte units) of k-step kk (rows 16kk .. 16kk + 15) of an
// MN-major operand.
__host__ __device__ constexpr int mnstep(int kk) {
  return (16 * ROW_BYTES * kk) >> 4;
}

// d = A B (ONTO: d += A B) over all D / 16 k-steps from KK on: A a
// K-major tile of RA rows, B one of RB = 64 rows (m64n64k16).  The k-steps
// unroll at compile time, so each descriptor offset is an asm immediate
// and only the two base descriptors take registers.
template <typename T, int RA, int RB, bool ONTO = false, int KK = 0>
__device__ __forceinline__ void ss_product(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  static_assert(RB == 64, "N = 64");
  if constexpr (KK < D / 16) {
    Wgmma64<T>::template ss_at<kstep(KK, RA), kstep(KK, RB)>(
        d, a, b, ONTO || KK > 0);
    ss_product<T, RA, RB, ONTO, KK + 1>(d, a, b);
  }
}

// d += A B over N k-steps from KK on: A from registers (a[kk] the A
// fragment of k-step kk), B MN-major (m64n128k16).
template <typename T, int N, int KK = 0>
__device__ __forceinline__ void rs_product(float (&d)[64],
                                           const uint32_t (&a)[N][4],
                                           uint64_t b) {
  if constexpr (KK < N) {
    Wgmma<T>::template rs_at<mnstep(KK)>(d, a[KK], b);
    rs_product<T, N, KK + 1>(d, a, b);
  }
}

// Does q position qpos see key kpos?
__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Sk,
                                        int causal, int window) {
  bool ok = qpos < Sq && kpos < Sk;
  if (causal) ok = ok && qpos >= kpos;
  if (window > 0) {
    ok = ok && qpos - kpos <= window;
    if (!causal) ok = ok && kpos - qpos <= window;
  }
  return ok;
}

// Do all of q rows q0 .. q0 + nq - 1 see all of keys k0 .. k0 + nk - 1?
// (else the tile needs the element mask)
__device__ __forceinline__ bool all_visible(int q0, int nq, int k0, int nk,
                                            int Sq, int Sk, int causal,
                                            int window) {
  if (q0 + nq > Sq || k0 + nk > Sk) return false;
  if (causal && q0 < k0 + nk - 1) return false;
  if (window > 0 && (q0 + nq - 1 - k0 > window ||
                     (!causal && k0 + nk - 1 - q0 > window)))
    return false;
  return true;
}

// ---- dQ ------------------------------------------------------------------

constexpr int DQ_BM = 128;                     // q rows per block
constexpr int DQ_BN = 64;                      // keys per K/V stage
constexpr int DQ_NST = 4;                      // K/V ring stages
constexpr int DQ_HALF = DQ_BM * ROW_BYTES;     // a half of the Q / dO tile
constexpr int DQ_TILE = 2 * DQ_HALF;
constexpr int DQ_KV_HALF = DQ_BN * ROW_BYTES;  // a half of a K or V stage
constexpr int DQ_KV_TILE = 2 * DQ_KV_HALF;
constexpr int DQ_NBARS = 1 + 2 * DQ_NST;       // full Q/dO, full K/V, empty
constexpr int DQ_SMEM =
    1024 + 2 * DQ_TILE + 2 * DQ_NST * DQ_KV_TILE + 8 * DQ_NBARS;

struct DqSmem {
  uint32_t q;  // Q, then dO, K stages, V stages, barriers
  __device__ uint32_t dout() const { return q + DQ_TILE; }
  __device__ uint32_t k(int s) const { return q + 2 * DQ_TILE + s * DQ_KV_TILE; }
  __device__ uint32_t v(int s) const {
    return q + 2 * DQ_TILE + (DQ_NST + s) * DQ_KV_TILE;
  }
  __device__ uint32_t bar(int i) const {
    return q + 2 * DQ_TILE + 2 * DQ_NST * DQ_KV_TILE + 8 * i;
  }
  __device__ uint32_t full_q() const { return bar(0); }
  __device__ uint32_t full(int s) const { return bar(1 + s); }
  __device__ uint32_t empty(int s) const { return bar(1 + DQ_NST + s); }
};

// tq, tdo: [B * Hq, Sq, D] (boxes of 128 rows); tdq: the same (boxes of
// 64); tk, tv: [B * Hkv, Sk, D] (boxes of 64).  lse, di: [B, Hq, Sq].
// Grid: one block per (q tile, batch, q head), q head fastest, last q tile
// first.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tdq,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, int B, int Hq, int Hkv,
                        int Sq, int Sk, float scale, int causal,
                        int window) {
  extern __shared__ uint8_t smem[];
  DqSmem sm;
  sm.q = (smem_u32(smem) + 1023) & ~1023u;

  const int nq = (Sq + DQ_BM - 1) / DQ_BM;
  int id = blockIdx.x;
  const int h = id % Hq;
  id /= Hq;
  const int b = id % B;
  const int q_lo = (nq - 1 - id / B) * DQ_BM;
  const int q_hi = min(q_lo + DQ_BM, Sq) - 1;
  const int bhq = b * Hq + h;
  const int bhk = b * Hkv + h / (Hq / Hkv);
  // live 64-key tiles j_lo .. j_hi (as flash_fwd.cu kv_tiles)
  int k_min = 0, k_max = Sk - 1;
  if (causal) k_max = min(k_max, q_hi);
  if (window > 0) {
    k_min = max(0, q_lo - window);
    if (!causal) k_max = min(k_max, q_hi + window);
  }
  const int j_lo = k_min / DQ_BN;
  const int j_hi = (k_max >= k_min) ? k_max / DQ_BN : j_lo - 1;

  if (threadIdx.x == 0) {
    mbar_init(sm.full_q(), 1);
    for (int s = 0; s < DQ_NST; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 2 * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&tdo);
      tma_prefetch_map(&tdq);
      mbar_expect_tx(sm.full_q(), 2 * DQ_TILE);
      tma_load_3d(sm.q, &tq, sm.full_q(), 0, q_lo, bhq);
      tma_load_3d(sm.q + DQ_HALF, &tq, sm.full_q(), 64, q_lo, bhq);
      tma_load_3d(sm.dout(), &tdo, sm.full_q(), 0, q_lo, bhq);
      tma_load_3d(sm.dout() + DQ_HALF, &tdo, sm.full_q(), 64, q_lo, bhq);
      for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it) {
        const int s = it % DQ_NST;
        mbar_wait(sm.empty(s), ((it / DQ_NST) & 1) ^ 1);  // round 0 passes
        mbar_expect_tx(sm.full(s), 2 * DQ_KV_TILE);
        tma_load_3d(sm.k(s), &tk, sm.full(s), 0, j * DQ_BN, bhk);
        tma_load_3d(sm.k(s) + DQ_KV_HALF, &tk, sm.full(s), 64, j * DQ_BN,
                    bhk);
        tma_load_3d(sm.v(s), &tv, sm.full(s), 0, j * DQ_BN, bhk);
        tma_load_3d(sm.v(s) + DQ_KV_HALF, &tv, sm.full(s), 64, j * DQ_BN,
                    bhk);
      }
    }
  } else {
    // ---- consumer warpgroup c: q rows 64c .. 64c + 63 of the block
    setmaxnreg_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int w_lo = q_lo + WG_ROWS * c;
    // the thread's rows: "a" and "b" = a + 8 (the accumulator layout)
    const int qpos_a = w_lo + 16 * warp + (lane >> 2), qpos_b = qpos_a + 8;
    const size_t row0 = (size_t)bhq * Sq;
    // -lse log2(e): exp2(s scale log2(e) + nl) = exp(scale s - lse)
    const float nl_a = qpos_a < Sq ? -lse[row0 + qpos_a] * kLog2e : -INFINITY;
    const float nl_b = qpos_b < Sq ? -lse[row0 + qpos_b] * kLog2e : -INFINITY;
    const float di_a = qpos_a < Sq ? di[row0 + qpos_a] : 0.f;
    const float di_b = qpos_b < Sq ? di[row0 + qpos_b] : 0.f;
    const float sl2 = scale * kLog2e;

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    const uint32_t sq = sm.q + c * WG_ROWS * ROW_BYTES;
    const uint64_t dq_a = wgmma_desc(sq, 16, 8 * ROW_BYTES);
    const uint64_t ddo_a =
        wgmma_desc(sm.dout() + c * WG_ROWS * ROW_BYTES, 16, 8 * ROW_BYTES);
    mbar_wait(sm.full_q(), 0);

    for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it) {
      const int st = it % DQ_NST;
      const uint32_t ph = (it / DQ_NST) & 1;
      const uint64_t dk_b = wgmma_desc(sm.k(st), 16, 8 * ROW_BYTES);
      const uint64_t dv_b = wgmma_desc(sm.v(st), 16, 8 * ROW_BYTES);
      // K read MN-major for dS K: 64-column halves DQ_KV_HALF apart
      const uint64_t dk_mn = wgmma_desc(sm.k(st), DQ_KV_HALF, 8 * ROW_BYTES);

      // S = Q K^T, dP = dO V^T in two commit groups (declared here: they
      // die with dS, so they hold no registers across the dQ product)
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      mbar_wait(sm.full(st), ph);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      ss_product<T, DQ_BM, DQ_BN>(s, dq_a, dk_b);
      wgmma_commit();
      ss_product<T, DQ_BM, DQ_BN>(dp, ddo_a, dv_b);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P while dP is still in flight, zeroed by a select where masked (a
      // row that sees nothing has a finite LSE, so exp would overflow
      // there); then dS = P (dP - di) scale
      const int kv0 = j * DQ_BN;
      const bool need_mask = !all_visible(w_lo, WG_ROWS, kv0, DQ_BN, Sq, Sk,
                                          causal, window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool rb = (i & 2) != 0;
        float p = exp2_ftz(fmaf(s[i], sl2, rb ? nl_b : nl_a));
        if (need_mask &&
            !visible(rb ? qpos_b : qpos_a, kv0 + 8 * (i / 4) + 2 * t + (i & 1),
                     Sq, Sk, causal, window))
          p = 0.f;
        s[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = s[i] * (dp[i] - ((i & 2) ? di_b : di_a)) * scale;
      // dS as A fragments: k-step kk is dS's column blocks 2kk and 2kk + 1
      uint32_t ds[DQ_BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < DQ_BN / 16; ++kk) {
        ds[kk][0] = Elem<T>::pack(s[8 * kk], s[8 * kk + 1]);
        ds[kk][1] = Elem<T>::pack(s[8 * kk + 2], s[8 * kk + 3]);
        ds[kk][2] = Elem<T>::pack(s[8 * kk + 4], s[8 * kk + 5]);
        ds[kk][3] = Elem<T>::pack(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // dQ += dS K
      fence_regs(acc);
      wgmma_fence();
      rs_product<T, DQ_BN / 16>(acc, ds, dk_mn);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < DQ_BN / 16; ++kk) fence_regs(ds[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(st));  // this warp is done with it
    }

    // ---- epilogue: dQ over this warpgroup's own Q rows, one TMA store per
    // half (rows past Sq clipped); rows ra and ra + 8 share the swizzle
    named_sync(1 + c, 128);
    const int ra = 16 * warp + (lane >> 2);
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      const uint32_t at = sq + (jb / 8) * DQ_HALF + ra * ROW_BYTES +
                          (((jb % 8) ^ (ra & 7)) << 4) + 4 * t;
      st_shared_u32(at, Elem<T>::pack(acc[4 * jb], acc[4 * jb + 1]));
      st_shared_u32(at + 8 * ROW_BYTES,
                    Elem<T>::pack(acc[4 * jb + 2], acc[4 * jb + 3]));
    }
    fence_proxy_async();
    named_sync(1 + c, 128);
    if ((threadIdx.x & 127) == 0 && w_lo < Sq) {
      tma_store_3d(&tdq, sq, 0, w_lo, bhq);
      tma_store_3d(&tdq, sq + DQ_HALF, 64, w_lo, bhq);
      tma_store_commit();
      tma_store_wait_read();
    }
  }
}

// ---- dK/dV ---------------------------------------------------------------

constexpr int KV_BN = 128;                     // keys per block
constexpr int KV_BQ = 64;                      // q rows per ring stage
constexpr int KV_NST = 3;                      // ring stages
constexpr int KV_HALF = KV_BN * ROW_BYTES;     // a half of the K or V tile
constexpr int KV_TILE = 2 * KV_HALF;
constexpr int KV_Q_HALF = KV_BQ * ROW_BYTES;   // a half of a Q or dO stage
constexpr int KV_Q_TILE = 2 * KV_Q_HALF;
constexpr int KV_STATS = 2 * KV_BQ * 4;        // -lse / scale, -di
constexpr int KV_NBARS = 1 + 2 * KV_NST;       // full K/V, full, empty
constexpr int KV_RING =
    2 * KV_TILE + 2 * KV_NST * KV_Q_TILE + KV_NST * KV_STATS;
constexpr int KV_SMEM = 1024 + KV_RING + 8 * KV_NBARS;
constexpr int KV_CONSUMERS = 2 * 128;
// A pass's f32 shares, element-major (element e of consumer thread i at
// e * 256 + i), over the Q / dO stages once the pass is done (K and V stay).
constexpr int KV_SHARE = 64 * KV_CONSUMERS * 4;
static_assert(KV_SHARE <= 2 * KV_NST * KV_Q_TILE, "the shares reuse the ring");
constexpr int MAX_CLUSTER = 2;  // blocks per cluster (see the top)

struct KvSmem {
  uint32_t k;  // K, V, Q stages, dO stages, statistics, barriers
  __device__ uint32_t v() const { return k + KV_TILE; }
  __device__ uint32_t q(int s) const { return k + 2 * KV_TILE + s * KV_Q_TILE; }
  __device__ uint32_t dout(int s) const {
    return k + 2 * KV_TILE + (KV_NST + s) * KV_Q_TILE;
  }
  __device__ uint32_t stats(int s) const {
    return k + 2 * KV_TILE + 2 * KV_NST * KV_Q_TILE + s * KV_STATS;
  }
  __device__ uint32_t share() const { return q(0); }
  __device__ uint32_t bar(int i) const { return k + KV_RING + 8 * i; }
  __device__ uint32_t full_kv() const { return bar(0); }
  __device__ uint32_t full(int s) const { return bar(1 + s); }
  __device__ uint32_t empty(int s) const { return bar(1 + KV_NST + s); }
};

// What a consumer thread of the dK/dV kernel needs in its walks.
struct KvThread {
  const uint8_t* base;  // generic address of KvSmem::k
  KvSmem sm;
  int i_lo, n_qt, n_steps;
  int t, lane, kpos_a;
  int band_lo;          // q row qpos sees key kpos iff band_lo <= qpos -
  uint32_t band_span;   // kpos <= band_lo + band_span (one unsigned compare)
  float sl2, scale;
  uint64_t dk_a, dv_a;  // the warpgroup's 64 K and V rows (K-major)
};

// One walk over the block's steps (q tiles of its heads), ring positions
// it0 .. it0 + n_steps - 1: acc += P^T dO (dV, !DK) or dS^T Q (dK, DK).
// S^T = K Q^T - lse / scale and, for dK, dP^T = V dO^T - di (rows: keys;
// columns: q rows) accumulate onto the columns' row statistics, so these
// take no registers of their own.  dV and dK are two walks, each with one
// 64 x 128 f32 sum a thread: with both in one loop ptxas serialised every
// wgmma (C7512) at any step size.
template <typename T, bool DK>
__device__ __forceinline__ void dkv_walk(float (&acc)[64], const KvThread& w,
                                         int it0) {
  const KvSmem& sm = w.sm;
  for (int it = 0, qt = 0; it < w.n_steps;
       ++it, qt = (qt + 1 == w.n_qt) ? 0 : qt + 1) {
    const int g = it0 + it;  // ring position
    const int st = g % KV_NST;
    const uint32_t ph = (g / KV_NST) & 1;
    const int q0 = (w.i_lo + qt) * KV_BQ;
    const uint64_t dq_b = wgmma_desc(sm.q(st), 16, 8 * ROW_BYTES);
    const uint64_t ddo_b = wgmma_desc(sm.dout(st), 16, 8 * ROW_BYTES);
    // the dK product reads Q, the dV product dO, MN-major
    const uint64_t b_mn = wgmma_desc(DK ? sm.q(st) : sm.dout(st), KV_Q_HALF,
                                     8 * ROW_BYTES);
    const float* stats =
        reinterpret_cast<const float*>(w.base + (sm.stats(st) - sm.k));

    float s[KV_BQ / 2], dp[KV_BQ / 2];  // declared here: they die each step
    mbar_wait(sm.full(st), ph);
#pragma unroll
    for (int j = 0; j < KV_BQ / 8; ++j) {  // columns 8j + 2t, + 1 of rows a, b
      const float2 ls =
          *reinterpret_cast<const float2*>(stats + 8 * j + 2 * w.t);
      s[4 * j] = s[4 * j + 2] = ls.x;
      s[4 * j + 1] = s[4 * j + 3] = ls.y;
      if constexpr (DK) {
        const float2 ld =
            *reinterpret_cast<const float2*>(stats + KV_BQ + 8 * j + 2 * w.t);
        dp[4 * j] = dp[4 * j + 2] = ld.x;
        dp[4 * j + 1] = dp[4 * j + 3] = ld.y;
      }
    }
    fence_regs(s);
    if constexpr (DK) fence_regs(dp);
    wgmma_fence();
    ss_product<T, KV_BN, KV_BQ, true>(s, w.dk_a, dq_b);
    wgmma_commit();
    if constexpr (DK) {
      ss_product<T, KV_BN, KV_BQ, true>(dp, w.dv_a, ddo_b);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);

    // P^T (into s), dS^T (into dp); column 8 (i / 4) + 2t + (i & 1) is a q
    // row.  The mask is the band test alone, without a branch: rows past Sq
    // have p = exp2(-inf) = 0 already, and a key past Sk only feeds its own
    // dK / dV row, which is never stored.
    const int d_a = q0 + 2 * w.t - w.kpos_a - w.band_lo, d_b = d_a - 8;
#pragma unroll
    for (int i = 0; i < KV_BQ / 2; ++i) {
      const int off = 8 * (i / 4) + (i & 1);
      const bool keep =
          (uint32_t)(((i & 2) ? d_b : d_a) + off) <= w.band_span;
      s[i] = keep ? exp2_ftz(s[i] * w.sl2) : 0.f;
    }
    if constexpr (DK) {
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < KV_BQ / 2; ++i) s[i] = s[i] * dp[i] * w.scale;
    }
    // as A fragments: k-step kk is column blocks 2kk and 2kk + 1
    uint32_t fa[KV_BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < KV_BQ / 16; ++kk) {
      fa[kk][0] = Elem<T>::pack(s[8 * kk], s[8 * kk + 1]);
      fa[kk][1] = Elem<T>::pack(s[8 * kk + 2], s[8 * kk + 3]);
      fa[kk][2] = Elem<T>::pack(s[8 * kk + 4], s[8 * kk + 5]);
      fa[kk][3] = Elem<T>::pack(s[8 * kk + 6], s[8 * kk + 7]);
    }

    fence_regs(acc);
    wgmma_fence();
    rs_product<T, KV_BQ / 16>(acc, fa, b_mn);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < KV_BQ / 16; ++kk) fence_regs(fa[kk]);
    __syncwarp();
    if (w.lane == 0) mbar_arrive(sm.empty(st));  // this warp is done with it
  }
}

// The group sum of one pass: each block's f32 share over its Q / dO
// stages, then each block sums a slice of the elements over the cluster's
// blocks in rank order 0 .. csize - 1 (distributed shared memory) and
// stores its rows below Sk to out [.., Sk, D] at row base `row0`.  Every
// consumer thread of the cluster calls it; the producer threads make the
// same two cluster_sync calls.
template <typename T>
__device__ __forceinline__ void dkv_group_sum(const float (&acc)[64],
                                              const KvThread& w, int ct,
                                              int rank, int csize, T* out,
                                              size_t row0, int Sk) {
  named_sync(1, KV_CONSUMERS);  // both warpgroups are past their walk
  float* share = reinterpret_cast<float*>(
      const_cast<uint8_t*>(w.base) + (w.sm.share() - w.sm.k));
#pragma unroll
  for (int e = 0; e < 64; ++e) share[e * KV_CONSUMERS + ct] = acc[e];
  cluster_sync();
  // this block's slice: element pairs p_lo .. p_hi - 1 of the 32
  const int p_lo = rank * 32 / csize, p_hi = (rank + 1) * 32 / csize;
  uint32_t remote[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r)
    remote[r] = r < csize ? cluster_map(w.sm.share(), r) : 0u;
  for (int pr = p_lo; pr < p_hi; ++pr) {
    const uint32_t off = (2 * pr * KV_CONSUMERS + ct) * 4;
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < csize) {
        x += ld_cluster_f32(remote[r] + off);
        y += ld_cluster_f32(remote[r] + off + KV_CONSUMERS * 4);
      }
    }
    // element e = 2 pr of the thread's 64: row "a" or "b" (+ 8), columns
    // 8 (e / 4) + 2t and the next
    const int e = 2 * pr;
    const int kpos = w.kpos_a + ((e & 2) ? 8 : 0);
    if (kpos < Sk)
      *reinterpret_cast<uint32_t*>(out + (row0 + kpos) * D + 8 * (e / 4) +
                                   2 * w.t) = Elem<T>::pack(x, y);
  }
  cluster_sync();  // no block reuses its share while another reads it
}

// tq, tdo: [B * Hq, Sq, D] (boxes of 64 rows); tk, tv: [B * Hkv, Sk, D]
// (boxes of 128).  lse, di: [B, Hq, Sq]; dk, dv: [B, Hkv, Sk, D].  Grid:
// clusters of `csize` blocks, one per (key tile, batch, kv head): the
// cluster's block of rank r takes q heads hk * group + r * hpb .. + hpb - 1
// (hpb = group / csize); key tile 0, the longest causal walk, first.  Two
// passes over the same steps: dV, its group sum, then dK and its sum.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, T* __restrict__ dk,
                         T* __restrict__ dv, int B, int Hq, int Hkv, int Sq,
                         int Sk, int csize, float scale, int causal,
                         int window) {
  extern __shared__ uint8_t smem[];
  KvSmem sm;
  sm.k = (smem_u32(smem) + 1023) & ~1023u;
  uint8_t* const base = smem + (sm.k - smem_u32(smem));  // generic pointer

  const int group = Hq / Hkv, hpb = group / csize;
  int id = blockIdx.x;
  const int rank = id % csize;  // the block's rank in its cluster
  id /= csize;
  const int hk = id % Hkv;
  id /= Hkv;
  const int nkt = (Sk + KV_BN - 1) / KV_BN;
  const int b = id / nkt;  // batch outermost: its Q, dO stay in L2
  const int k0 = (id % nkt) * KV_BN;
  const int k_last = min(k0 + KV_BN, Sk) - 1;
  const int bhk = b * Hkv + hk;
  const int plane0 = b * Hq + hk * group + rank * hpb;  // first q head
  // q positions that see some key of this tile (flash_vjp.py:46-65)
  int q_min = 0, q_max = Sq - 1;
  if (causal) q_min = k0;
  if (window > 0) {
    q_max = min(q_max, k_last + window);
    if (!causal) q_min = max(0, k0 - window);
  }
  const int i_lo = q_min / KV_BQ;
  const int n_qt = q_min <= q_max ? q_max / KV_BQ - i_lo + 1 : 0;
  const int n_steps = n_qt * hpb;  // step it: head it / n_qt, tile it % n_qt

  if (threadIdx.x == 0) {
    mbar_init(sm.full_kv(), 1);
    for (int s = 0; s < KV_NST; ++s) {
      mbar_init(sm.full(s), 1 + 32);  // the TMA thread and the stats warp
      mbar_init(sm.empty(s), 2 * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: thread 0 issues the TMA loads, warp 1
    // copies each stage's row statistics; the same steps twice
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&tdo);
      mbar_expect_tx(sm.full_kv(), 2 * KV_TILE);
      tma_load_3d(sm.k, &tk, sm.full_kv(), 0, k0, bhk);
      tma_load_3d(sm.k + KV_HALF, &tk, sm.full_kv(), 64, k0, bhk);
      tma_load_3d(sm.v(), &tv, sm.full_kv(), 0, k0, bhk);
      tma_load_3d(sm.v() + KV_HALF, &tv, sm.full_kv(), 64, k0, bhk);
    }
    const int lane = threadIdx.x & 31;
    for (int pass = 0; pass < 2; ++pass) {
      for (int it = 0; it < n_steps; ++it) {
        const int g = pass * n_steps + it;  // ring position
        const int s = g % KV_NST;
        const int plane = plane0 + it / n_qt;
        const int q0 = (i_lo + it % n_qt) * KV_BQ;
        if (threadIdx.x == 0) {
          mbar_wait(sm.empty(s), ((g / KV_NST) & 1) ^ 1);  // round 0 passes
          mbar_expect_tx(sm.full(s), 2 * KV_Q_TILE);
          tma_load_3d(sm.q(s), &tq, sm.full(s), 0, q0, plane);
          tma_load_3d(sm.q(s) + KV_Q_HALF, &tq, sm.full(s), 64, q0, plane);
          tma_load_3d(sm.dout(s), &tdo, sm.full(s), 0, q0, plane);
          tma_load_3d(sm.dout(s) + KV_Q_HALF, &tdo, sm.full(s), 64, q0,
                      plane);
        } else if (threadIdx.x / 32 == 1) {
          const size_t row0 = (size_t)plane * Sq;
          float* stats =
              reinterpret_cast<float*>(base + (sm.stats(s) - sm.k));
          mbar_wait(sm.empty(s), ((g / KV_NST) & 1) ^ 1);
#pragma unroll
          for (int r = lane; r < KV_BQ; r += 32) {
            const int pos = q0 + r;
            const bool ok = pos < Sq;
            stats[r] = ok ? -lse[row0 + pos] / scale : -INFINITY;
            stats[KV_BQ + r] = ok ? -di[row0 + pos] : 0.f;
          }
          mbar_arrive(sm.full(s));
        }
      }
      cluster_sync();  // the pass's shares are written
      cluster_sync();  // the cluster has read them
    }
  } else {
    // ---- consumer warpgroup c: keys 64c .. 64c + 63 of the block
    setmaxnreg_inc<240>();
    const int ct = threadIdx.x - 128;  // consumer thread 0 .. 255
    const int c = ct / 128;
    KvThread w;
    w.base = base;
    w.sm = sm;
    w.i_lo = i_lo;
    w.n_qt = n_qt;
    w.n_steps = n_steps;
    w.lane = ct & 31;
    w.t = w.lane & 3;
    // the thread's keys: "a" and "b" = a + 8 (the accumulator layout)
    w.kpos_a = k0 + WG_ROWS * c + 16 * ((ct / 32) & 3) + (w.lane >> 2);
    // the causal diagonal, a window on one or both sides, or no limit
    w.band_lo = causal ? 0 : (window > 0 ? -window : -(1 << 30));
    w.band_span =
        (uint32_t)(window > 0 ? window : (1 << 30)) - (uint32_t)w.band_lo;
    w.sl2 = scale * kLog2e;
    w.scale = scale;
    w.dk_a = wgmma_desc(sm.k + c * WG_ROWS * ROW_BYTES, 16, 8 * ROW_BYTES);
    w.dv_a = wgmma_desc(sm.v() + c * WG_ROWS * ROW_BYTES, 16, 8 * ROW_BYTES);
    const size_t row0 = (size_t)bhk * Sk;
    mbar_wait(sm.full_kv(), 0);

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    dkv_walk<T, false>(acc, w, 0);
    dkv_group_sum<T>(acc, w, ct, rank, csize, dv, row0, Sk);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    dkv_walk<T, true>(acc, w, n_steps);
    dkv_group_sum<T>(acc, w, ct, rank, csize, dk, row0, Sk);
  }
}

// ---- delta -----------------------------------------------------------------

constexpr int DELTA_THREADS = 256;
constexpr int DELTA_LANES = D / 8;  // 16 threads a row, 8 values each
constexpr int DELTA_ROWS = DELTA_THREADS / DELTA_LANES;

// di[r] = sum_d o[r, d] do[r, d] - dlse[r] (dlse null: 0), f32; o, do:
// [rows, D] of T.  The products of two 16-bit values are exact in f32.
template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           const float* __restrict__ dlse,
                           float* __restrict__ di, int rows) {
  const int row = blockIdx.x * DELTA_ROWS + threadIdx.x / DELTA_LANES;
  const int l = threadIdx.x % DELTA_LANES;
  float sum = 0.f;
  if (row < rows) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(o + (size_t)row * D) + l);
    const uint4 g =
        __ldg(reinterpret_cast<const uint4*>(dout + (size_t)row * D) + l);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = Elem<T>::to_float2(av[i]), y = Elem<T>::to_float2(gv[i]);
      sum = fmaf(x.x, y.x, sum);
      sum = fmaf(x.y, y.y, sum);
    }
  }
#pragma unroll
  for (int m = DELTA_LANES / 2; m > 0; m /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (row < rows && l == 0) di[row] = dlse ? sum - dlse[row] : sum;
}

// ---- launches --------------------------------------------------------------

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, void* dq, int B, int Hq,
              int Hkv, int Sq, int Sk, float scale, int causal, int window,
              cudaStream_t stream) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  const int sk = Sk > 0 ? Sk : 1;
  CUtensorMap tq, tk, tv, tdo, tdq;
  cudaError_t err;
  if ((err = encode_rows128(&tq, q, f16, B * Hq, Sq, DQ_BM)) != cudaSuccess ||
      (err = encode_rows128(&tdo, dout, f16, B * Hq, Sq, DQ_BM)) !=
          cudaSuccess ||
      (err = encode_rows128(&tdq, dq, f16, B * Hq, Sq, WG_ROWS)) !=
          cudaSuccess ||
      (err = encode_rows128(&tk, k, f16, B * Hkv, sk, DQ_BN)) !=
          cudaSuccess ||
      (err = encode_rows128(&tv, v, f16, B * Hkv, sk, DQ_BN)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DQ_SMEM);
  if (err != cudaSuccess) return err;
  const int blocks = (Sq + DQ_BM - 1) / DQ_BM * B * Hq;
  flash_bwd_dq_kernel<T><<<blocks, NTHREADS, DQ_SMEM, stream>>>(
      tq, tk, tv, tdo, tdq, static_cast<const float*>(lse),
      static_cast<const float*>(di), B, Hq, Hkv, Sq, Sk, scale, causal,
      window);
  return cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* di, void* dk, void* dv, int B,
               int Hq, int Hkv, int Sq, int Sk, float scale, int causal,
               int window, cudaStream_t stream) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  const int group = Hq / Hkv;
  // a cluster of two blocks for an even group, else one block for the
  // whole group
  const int csize = group % MAX_CLUSTER == 0 ? MAX_CLUSTER : 1;
  const int sq = Sq > 0 ? Sq : 1;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = encode_rows128(&tq, q, f16, B * Hq, sq, KV_BQ)) != cudaSuccess ||
      (err = encode_rows128(&tdo, dout, f16, B * Hq, sq, KV_BQ)) !=
          cudaSuccess ||
      (err = encode_rows128(&tk, k, f16, B * Hkv, Sk, KV_BN)) !=
          cudaSuccess ||
      (err = encode_rows128(&tv, v, f16, B * Hkv, Sk, KV_BN)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KV_SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize * Hkv * B * ((Sk + KV_BN - 1) / KV_BN));
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = KV_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dkv_kernel<T>, tq, tk, tv, tdo,
                           static_cast<const float*>(lse),
                           static_cast<const float*>(di), static_cast<T*>(dk),
                           static_cast<T*>(dv), B, Hq, Hkv, Sq, Sk, csize,
                           scale, causal, window);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch_delta(const void* o, const void* dout, const void* dlse, void* di,
                 int rows, cudaStream_t stream) {
  const int blocks = (rows + DELTA_ROWS - 1) / DELTA_ROWS;
  flash_bwd_delta_kernel<T><<<blocks, DELTA_THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<const float*>(dlse), static_cast<float*>(di), rows);
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

extern "C" int aule_flash_bwd_delta(const void* o, const void* dout,
                                    const void* dlse, void* di, int rows,
                                    int dtype, void* stream) {
  if (rows <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == aule::kF16)
    return launch_delta<__half>(o, dout, dlse, di, rows, s);
  return launch_delta<__nv_bfloat16>(o, dout, dlse, di, rows, s);
}
