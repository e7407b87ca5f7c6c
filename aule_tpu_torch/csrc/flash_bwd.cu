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
// of 128-byte swizzled tiles through rank-3 maps over [B x heads, S, D]
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
//     head a block) were slower at D = 128: a cluster launches only where
//     that many SMs are free at once, and with one block an SM that left
//     SMs idle (D = 256 takes up to 8; KvTile).
//   * delta: one pass over o and do with 16-byte loads, 16 threads a row.
// Each wgmma product has one code site: with a product at several, ptxas
// serialises every wgmma (C7518/C7512; PERF.md, Findings).
//
// Head dims 64 and 256 (the template's D; `DqTile<D>` and `KvTile<D>` hold
// each one's shape): tiles are D / 64 swizzled 64-column chunks
// (hopper.cuh encode_rows), S, dP, S^T and dP^T run D / 16 k-steps, and
// the products onto a D-wide sum read their MN-major operand across D / 64
// swizzle atoms (hopper.cuh rs_product: m64n64k16 at 64, two m64n128k16 a
// k-step at 256).  Both head dims run one consumer warpgroup (256
// threads, no setmaxnreg): dQ 64 q rows a block, dK/dV 64 keys a block.
// At D = 64 that doubles GPT-2's small grids (B1 Hq12 S1024: 96 blocks of
// D = 128's shapes on 132 SMs), which ran faster on an H100.  At D = 256
// a 64 x 256 f32 sum is 128
// registers a thread, which beside S and dP does not fit the 168 a thread
// that ptxas allows at 384 threads: dQ holds Q and dO (and O, for its
// delta: DqTile) resident, 96 KB, with 2 stages of 64-key K/V (128 KB);
// dK/dV holds K and V (64 KB) with 2 stages of 64-row Q/dO (128 KB), whose
// f32 share (64 KB) reuses that ring.  The delta kernel takes D / 8
// threads a row.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace aule;
using namespace aule::hopper;

constexpr int ROW_BYTES = 128;  // a swizzled chunk row: 64 values
constexpr int WG_ROWS = 64;     // rows per consumer warpgroup

// 2^x by the card's ex2.approx.ftz (as flash_fwd.cu)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// The dQ tile shape at head dim D: consumer warpgroups (64 q rows each),
// K/V ring stages of 64 keys, and where delta comes from.  TC_DELTA: the
// kernel computes each row's delta itself, as the diagonal of dO O^T on
// the same wgmma as dP = dO V^T, so a row whose exact dS is zero gets
// exactly zero.  Causal row 0 sees one key and its output is that key's V
// row: dP and delta are then the same sum of the same products, which the
// tensor cores and the delta kernel's FMAs round differently.  In f16 at
// D = 256 that f32 difference alone took dQ row 0 past chip_smoke.py's
// ROW_TOL of its BWD_FLOOR allowance on an H100.  D = 128 reads the delta
// kernel's di, as before.
template <int D>
struct DqTile;
template <>
struct DqTile<64> {
  static constexpr int NWG = 1, NST = 4;
  static constexpr bool TC_DELTA = true;
};
template <>
struct DqTile<128> {
  static constexpr int NWG = 2, NST = 4;
  static constexpr bool TC_DELTA = false;
};
template <>
struct DqTile<256> {
  static constexpr int NWG = 1, NST = 2;
  static constexpr bool TC_DELTA = true;
};

template <int D>
struct Dq {
  static constexpr int NWG = DqTile<D>::NWG, NST = DqTile<D>::NST;
  static constexpr bool TC_DELTA = DqTile<D>::TC_DELTA;
  static constexpr int BM = NWG * WG_ROWS;              // q rows per block
  static constexpr int BN = 64;                         // keys per K/V stage
  static constexpr int NTHREADS = (1 + NWG) * 128;      // producer + consumers
  static constexpr int CHUNKS = D / 64;
  static constexpr int CHUNK = BM * ROW_BYTES;          // a chunk of Q / dO
  static constexpr int TILE = CHUNKS * CHUNK;
  static constexpr int KV_CHUNK = BN * ROW_BYTES;       // a chunk of K or V
  static constexpr int KV_TILE = CHUNKS * KV_CHUNK;
  static constexpr int NBARS = 1 + 2 * NST;  // full Q/dO, full K/V, empty
  static constexpr int NQT = TC_DELTA ? 3 : 2;  // Q, dO (and O) tiles
  static constexpr int SMEM =
      1024 + NQT * TILE + 2 * NST * KV_TILE + 8 * NBARS;
  static_assert(SMEM <= 232448, "the block's shared memory");
};

template <int D>
struct DqSmem {
  using S = Dq<D>;
  uint32_t q;  // Q, then dO (and O), K stages, V stages, barriers
  __device__ uint32_t dout() const { return q + S::TILE; }
  __device__ uint32_t o() const { return q + 2 * S::TILE; }
  __device__ uint32_t k(int s) const {
    return q + S::NQT * S::TILE + s * S::KV_TILE;
  }
  __device__ uint32_t v(int s) const {
    return q + S::NQT * S::TILE + (S::NST + s) * S::KV_TILE;
  }
  __device__ uint32_t bar(int i) const {
    return q + S::NQT * S::TILE + 2 * S::NST * S::KV_TILE + 8 * i;
  }
  __device__ uint32_t full_q() const { return bar(0); }
  __device__ uint32_t full(int s) const { return bar(1 + s); }
  __device__ uint32_t empty(int s) const { return bar(1 + S::NST + s); }
};

// tq, tdo: [B * Hq, Sq, D] (boxes of BM rows); tdq: the same (boxes of
// 64); tk, tv: [B * Hkv, Sk, D] (boxes of 64).  lse, di: [B, Hq, Sq].
// TC_DELTA: to, the forward's output (as tq), and dlse [B, Hq, Sq] or
// null take di's place.  Grid: one block per (q tile, batch, q head), q
// head fastest, last q tile first.
template <typename T, int D>
__global__ void __launch_bounds__(Dq<D>::NTHREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tdq,
                        const __grid_constant__ CUtensorMap to,
                        const float* __restrict__ lse,
                        const float* __restrict__ di,
                        const float* __restrict__ dlse, int B, int Hq,
                        int Hkv, int Sq, int Sk, float scale, int causal,
                        int window) {
  using S = Dq<D>;
  constexpr int DQ_BM = S::BM, DQ_BN = S::BN, DQ_NST = S::NST;
  extern __shared__ uint8_t smem[];
  DqSmem<D> sm;
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
      mbar_init(sm.empty(s), S::NWG * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full
    if constexpr (S::NWG == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&tdo);
      tma_prefetch_map(&tdq);
      mbar_expect_tx(sm.full_q(), S::NQT * S::TILE);
#pragma unroll
      for (int ch = 0; ch < S::CHUNKS; ++ch)
        tma_load_3d(sm.q + ch * S::CHUNK, &tq, sm.full_q(), 64 * ch, q_lo,
                    bhq);
#pragma unroll
      for (int ch = 0; ch < S::CHUNKS; ++ch)
        tma_load_3d(sm.dout() + ch * S::CHUNK, &tdo, sm.full_q(), 64 * ch,
                    q_lo, bhq);
      if constexpr (S::TC_DELTA) {
#pragma unroll
        for (int ch = 0; ch < S::CHUNKS; ++ch)
          tma_load_3d(sm.o() + ch * S::CHUNK, &to, sm.full_q(), 64 * ch,
                      q_lo, bhq);
      }
      for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it) {
        const int s = it % DQ_NST;
        mbar_wait(sm.empty(s), ((it / DQ_NST) & 1) ^ 1);  // round 0 passes
        mbar_expect_tx(sm.full(s), 2 * S::KV_TILE);
#pragma unroll
        for (int ch = 0; ch < S::CHUNKS; ++ch)
          tma_load_3d(sm.k(s) + ch * S::KV_CHUNK, &tk, sm.full(s), 64 * ch,
                      j * DQ_BN, bhk);
#pragma unroll
        for (int ch = 0; ch < S::CHUNKS; ++ch)
          tma_load_3d(sm.v(s) + ch * S::KV_CHUNK, &tv, sm.full(s), 64 * ch,
                      j * DQ_BN, bhk);
      }
    }
  } else {
    // ---- consumer warpgroup c: q rows 64c .. 64c + 63 of the block
    if constexpr (S::NWG == 2) setmaxnreg_inc<240>();
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
    float di_a, di_b;
    if constexpr (!S::TC_DELTA) {
      di_a = qpos_a < Sq ? di[row0 + qpos_a] : 0.f;
      di_b = qpos_b < Sq ? di[row0 + qpos_b] : 0.f;
    }
    const float sl2 = scale * kLog2e;

    float acc[D / 2];  // the thread's part of 64 x D f32 dQ
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    const uint32_t sq = sm.q + c * WG_ROWS * ROW_BYTES;
    const uint64_t dq_a = wgmma_desc(sq, 16, 8 * ROW_BYTES);
    const uint64_t ddo_a =
        wgmma_desc(sm.dout() + c * WG_ROWS * ROW_BYTES, 16, 8 * ROW_BYTES);
    mbar_wait(sm.full_q(), 0);
    if constexpr (S::TC_DELTA) {
      // delta = diag(dO O^T) - dlse for this warpgroup's 64 rows, on the
      // wgmma that computes dP (see DqTile)
      float dd[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dd[i] = 0.f;
      fence_regs(dd);
      wgmma_fence();
      ss_product<T, D, DQ_BM, DQ_BM>(
          dd, ddo_a,
          wgmma_desc(sm.o() + c * WG_ROWS * ROW_BYTES, 16, 8 * ROW_BYTES));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dd);
      // row a = 16 warp + g's diagonal, column a, is element 8 warp + (g &
      // 1) of lane 4g + g / 2; row b = a + 8's, element 8 warp + 6 + (g & 1)
      const int g = lane >> 2;
      float da = 0.f, db = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i == 8 * warp + (g & 1)) da = dd[i];
        if (i == 8 * warp + 6 + (g & 1)) db = dd[i];
      }
      da = __shfl_sync(0xffffffffu, da, 4 * g + g / 2);
      db = __shfl_sync(0xffffffffu, db, 4 * g + g / 2);
      di_a = qpos_a < Sq ? da - (dlse ? dlse[row0 + qpos_a] : 0.f) : 0.f;
      di_b = qpos_b < Sq ? db - (dlse ? dlse[row0 + qpos_b] : 0.f) : 0.f;
    }

    for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it) {
      const int st = it % DQ_NST;
      const uint32_t ph = (it / DQ_NST) & 1;
      const uint64_t dk_b = wgmma_desc(sm.k(st), 16, 8 * ROW_BYTES);
      const uint64_t dv_b = wgmma_desc(sm.v(st), 16, 8 * ROW_BYTES);
      // K read MN-major for dS K: 64-column chunks KV_CHUNK apart
      const uint64_t dk_mn =
          wgmma_desc(sm.k(st), S::KV_CHUNK, 8 * ROW_BYTES);

      // S = Q K^T, dP = dO V^T in two commit groups (declared here: they
      // die with dS, so they hold no registers across the dQ product)
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      mbar_wait(sm.full(st), ph);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      ss_product<T, D, DQ_BM, DQ_BN>(s, dq_a, dk_b);
      wgmma_commit();
      ss_product<T, D, DQ_BM, DQ_BN>(dp, ddo_a, dv_b);
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
      rs_product<T, D, S::KV_CHUNK, DQ_BN / 16>(acc, ds, dk_mn);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < DQ_BN / 16; ++kk) fence_regs(ds[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(st));  // this warp is done with it
    }

    // ---- epilogue: dQ over this warpgroup's own Q rows, one TMA store per
    // chunk (rows past Sq clipped); rows ra and ra + 8 share the swizzle
    named_sync(1 + c, 128);
    const int ra = 16 * warp + (lane >> 2);
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      const uint32_t at = sq + (jb / 8) * S::CHUNK + ra * ROW_BYTES +
                          (((jb % 8) ^ (ra & 7)) << 4) + 4 * t;
      st_shared_u32(at, Elem<T>::pack(acc[4 * jb], acc[4 * jb + 1]));
      st_shared_u32(at + 8 * ROW_BYTES,
                    Elem<T>::pack(acc[4 * jb + 2], acc[4 * jb + 3]));
    }
    fence_proxy_async();
    named_sync(1 + c, 128);
    if ((threadIdx.x & 127) == 0 && w_lo < Sq) {
#pragma unroll
      for (int ch = 0; ch < S::CHUNKS; ++ch)
        tma_store_3d(&tdq, sq + ch * S::CHUNK, 64 * ch, w_lo, bhq);
      tma_store_commit();
      tma_store_wait_read();
    }
  }
}

// ---- dK/dV ---------------------------------------------------------------

// The dK/dV tile shape at head dim D: consumer warpgroups (64 keys each),
// ring stages of 64 q rows, and the most blocks a cluster splits a GQA
// group over.  At D = 256 a block holds 64 keys and a cluster takes up to
// 8: Gemma-2B's B1 Hq8/Hkv1 S2048 then runs 256 blocks (one head each),
// where clusters of 2 ran 64 blocks on the 132 SMs (8 ran faster on an
// H100 than 4 or 2).
template <int D>
struct KvTile;
template <>
struct KvTile<64> {
  static constexpr int NWG = 1, NST = 3, CLUSTER = 2;
};
template <>
struct KvTile<128> {
  static constexpr int NWG = 2, NST = 3, CLUSTER = 2;
};
template <>
struct KvTile<256> {
  static constexpr int NWG = 1, NST = 2, CLUSTER = 8;
};

template <int D>
struct Kv {
  static constexpr int NWG = KvTile<D>::NWG, NST = KvTile<D>::NST;
  static constexpr int BN = NWG * WG_ROWS;          // keys per block
  static constexpr int BQ = 64;                     // q rows per ring stage
  static constexpr int NTHREADS = (1 + NWG) * 128;  // producer + consumers
  static constexpr int CHUNKS = D / 64;
  static constexpr int CHUNK = BN * ROW_BYTES;      // a chunk of K or V
  static constexpr int TILE = CHUNKS * CHUNK;
  static constexpr int Q_CHUNK = BQ * ROW_BYTES;    // a chunk of a Q / dO stage
  static constexpr int Q_TILE = CHUNKS * Q_CHUNK;
  static constexpr int STATS = 2 * BQ * 4;          // -lse / scale, -di
  static constexpr int NBARS = 1 + 2 * NST;         // full K/V, full, empty
  static constexpr int RING = 2 * TILE + 2 * NST * Q_TILE + NST * STATS;
  static constexpr int SMEM = 1024 + RING + 8 * NBARS;
  static constexpr int CONSUMERS = NWG * 128;
  // A pass's f32 shares, element-major (element e of consumer thread i at
  // e * CONSUMERS + i), over the Q / dO stages once the pass is done (K and
  // V stay).
  static constexpr int SHARE = D / 2 * CONSUMERS * 4;
  static_assert(SHARE <= 2 * NST * Q_TILE, "the shares reuse the ring");
  static_assert(SMEM <= 232448, "the block's shared memory");
  static constexpr int MAX_CLUSTER = KvTile<D>::CLUSTER;
};

template <int D>
struct KvSmem {
  using S = Kv<D>;
  uint32_t k;  // K, V, Q stages, dO stages, statistics, barriers
  __device__ uint32_t v() const { return k + S::TILE; }
  __device__ uint32_t q(int s) const { return k + 2 * S::TILE + s * S::Q_TILE; }
  __device__ uint32_t dout(int s) const {
    return k + 2 * S::TILE + (S::NST + s) * S::Q_TILE;
  }
  __device__ uint32_t stats(int s) const {
    return k + 2 * S::TILE + 2 * S::NST * S::Q_TILE + s * S::STATS;
  }
  __device__ uint32_t share() const { return q(0); }
  __device__ uint32_t bar(int i) const { return k + S::RING + 8 * i; }
  __device__ uint32_t full_kv() const { return bar(0); }
  __device__ uint32_t full(int s) const { return bar(1 + s); }
  __device__ uint32_t empty(int s) const { return bar(1 + S::NST + s); }
};

// What a consumer thread of the dK/dV kernel needs in its walks.
template <int D>
struct KvThread {
  const uint8_t* base;  // generic address of KvSmem::k
  KvSmem<D> sm;
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
// 64 x D f32 sum a thread: with both in one loop ptxas serialised every
// wgmma (C7512) at any step size.
template <typename T, int D, bool DK>
__device__ __forceinline__ void dkv_walk(float (&acc)[D / 2],
                                         const KvThread<D>& w, int it0) {
  using S = Kv<D>;
  constexpr int KV_BN = S::BN, KV_BQ = S::BQ, KV_NST = S::NST;
  const KvSmem<D>& sm = w.sm;
  for (int it = 0, qt = 0; it < w.n_steps;
       ++it, qt = (qt + 1 == w.n_qt) ? 0 : qt + 1) {
    const int g = it0 + it;  // ring position
    const int st = g % KV_NST;
    const uint32_t ph = (g / KV_NST) & 1;
    const int q0 = (w.i_lo + qt) * KV_BQ;
    const uint64_t dq_b = wgmma_desc(sm.q(st), 16, 8 * ROW_BYTES);
    const uint64_t ddo_b = wgmma_desc(sm.dout(st), 16, 8 * ROW_BYTES);
    // the dK product reads Q, the dV product dO, MN-major
    const uint64_t b_mn = wgmma_desc(DK ? sm.q(st) : sm.dout(st), S::Q_CHUNK,
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
    ss_product<T, D, KV_BN, KV_BQ, true>(s, w.dk_a, dq_b);
    wgmma_commit();
    if constexpr (DK) {
      ss_product<T, D, KV_BN, KV_BQ, true>(dp, w.dv_a, ddo_b);
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
    rs_product<T, D, S::Q_CHUNK, KV_BQ / 16>(acc, fa, b_mn);
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
template <typename T, int D>
__device__ __forceinline__ void dkv_group_sum(const float (&acc)[D / 2],
                                              const KvThread<D>& w, int ct,
                                              int rank, int csize, T* out,
                                              size_t row0, int Sk) {
  constexpr int KV_CONSUMERS = Kv<D>::CONSUMERS;
  constexpr int MAX_CLUSTER = Kv<D>::MAX_CLUSTER;
  named_sync(1, KV_CONSUMERS);  // every warpgroup is past its walk
  float* share = reinterpret_cast<float*>(
      const_cast<uint8_t*>(w.base) + (w.sm.share() - w.sm.k));
#pragma unroll
  for (int e = 0; e < D / 2; ++e) share[e * KV_CONSUMERS + ct] = acc[e];
  cluster_sync();
  // this block's slice: element pairs p_lo .. p_hi - 1 of the D / 4
  const int p_lo = rank * (D / 4) / csize,
            p_hi = (rank + 1) * (D / 4) / csize;
  // the ranks' shares as this block addresses them: clusters of 2 hold
  // both addresses; at D = 256 (up to 8) each is mapped where it is read,
  // since 8 held addresses made ptxas spill
  constexpr bool HOLD = MAX_CLUSTER == 2;
  uint32_t remote[HOLD ? MAX_CLUSTER : 1];
  if constexpr (HOLD) {
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      remote[r] = r < csize ? cluster_map(w.sm.share(), r) : 0u;
  }
  for (int pr = p_lo; pr < p_hi; ++pr) {
    const uint32_t off = (2 * pr * KV_CONSUMERS + ct) * 4;
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < csize) {
        uint32_t at;
        if constexpr (HOLD)
          at = remote[r] + off;
        else
          at = cluster_map(w.sm.share(), r) + off;
        x += ld_cluster_f32(at);
        y += ld_cluster_f32(at + KV_CONSUMERS * 4);
      }
    }
    // element e = 2 pr of the thread's D / 2: row "a" or "b" (+ 8), columns
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
// (boxes of BN).  lse, di: [B, Hq, Sq]; dk, dv: [B, Hkv, Sk, D].  Grid:
// clusters of `csize` blocks, one per (key tile, batch, kv head): the
// cluster's block of rank r takes q heads hk * group + r * hpb .. + hpb - 1
// (hpb = group / csize); key tile 0, the longest causal walk, first.  Two
// passes over the same steps: dV, its group sum, then dK and its sum.
template <typename T, int D>
__global__ void __launch_bounds__(Kv<D>::NTHREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, T* __restrict__ dk,
                         T* __restrict__ dv, int B, int Hq, int Hkv, int Sq,
                         int Sk, int csize, float scale, int causal,
                         int window) {
  using S = Kv<D>;
  constexpr int KV_BN = S::BN, KV_BQ = S::BQ, KV_NST = S::NST;
  extern __shared__ uint8_t smem[];
  KvSmem<D> sm;
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
      mbar_init(sm.empty(s), S::NWG * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: thread 0 issues the TMA loads, warp 1
    // copies each stage's row statistics; the same steps twice
    if constexpr (S::NWG == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&tdo);
      mbar_expect_tx(sm.full_kv(), 2 * S::TILE);
#pragma unroll
      for (int ch = 0; ch < S::CHUNKS; ++ch)
        tma_load_3d(sm.k + ch * S::CHUNK, &tk, sm.full_kv(), 64 * ch, k0,
                    bhk);
#pragma unroll
      for (int ch = 0; ch < S::CHUNKS; ++ch)
        tma_load_3d(sm.v() + ch * S::CHUNK, &tv, sm.full_kv(), 64 * ch, k0,
                    bhk);
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
          mbar_expect_tx(sm.full(s), 2 * S::Q_TILE);
#pragma unroll
          for (int ch = 0; ch < S::CHUNKS; ++ch)
            tma_load_3d(sm.q(s) + ch * S::Q_CHUNK, &tq, sm.full(s), 64 * ch,
                        q0, plane);
#pragma unroll
          for (int ch = 0; ch < S::CHUNKS; ++ch)
            tma_load_3d(sm.dout(s) + ch * S::Q_CHUNK, &tdo, sm.full(s),
                        64 * ch, q0, plane);
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
    if constexpr (S::NWG == 2) setmaxnreg_inc<240>();
    const int ct = threadIdx.x - 128;  // consumer thread 0 .. CONSUMERS - 1
    const int c = ct / 128;
    KvThread<D> w;
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

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    dkv_walk<T, D, false>(acc, w, 0);
    dkv_group_sum<T, D>(acc, w, ct, rank, csize, dv, row0, Sk);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    dkv_walk<T, D, true>(acc, w, n_steps);
    dkv_group_sum<T, D>(acc, w, ct, rank, csize, dk, row0, Sk);
  }
}

// ---- delta -----------------------------------------------------------------

constexpr int DELTA_THREADS = 256;

// di[r] = sum_d o[r, d] do[r, d] - dlse[r] (dlse null: 0), f32; o, do:
// [rows, D] of T, D / 8 threads a row, 8 values each.  The products of two
// 16-bit values are exact in f32.
template <typename T, int D>
__global__ void __launch_bounds__(DELTA_THREADS)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           const float* __restrict__ dlse,
                           float* __restrict__ di, int rows) {
  constexpr int DELTA_LANES = D / 8;
  constexpr int DELTA_ROWS = DELTA_THREADS / DELTA_LANES;
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

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* o, const void* dlse, const void* lse,
              const void* di, void* dq, int B, int Hq, int Hkv, int Sq,
              int Sk, float scale, int causal, int window,
              cudaStream_t stream) {
  using S = Dq<D>;
  constexpr bool f16 = std::is_same<T, __half>::value;
  const int sk = Sk > 0 ? Sk : 1;
  CUtensorMap tq, tk, tv, tdo, tdq, to = {};
  cudaError_t err;
  if constexpr (S::TC_DELTA) {
    if (o == nullptr) return cudaErrorInvalidValue;
    if ((err = encode_rows(&to, o, f16, B * Hq, Sq, S::BM, D)) != cudaSuccess)
      return err;
  }
  if ((err = encode_rows(&tq, q, f16, B * Hq, Sq, S::BM, D)) !=
          cudaSuccess ||
      (err = encode_rows(&tdo, dout, f16, B * Hq, Sq, S::BM, D)) !=
          cudaSuccess ||
      (err = encode_rows(&tdq, dq, f16, B * Hq, Sq, WG_ROWS, D)) !=
          cudaSuccess ||
      (err = encode_rows(&tk, k, f16, B * Hkv, sk, S::BN, D)) !=
          cudaSuccess ||
      (err = encode_rows(&tv, v, f16, B * Hkv, sk, S::BN, D)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::SMEM);
  if (err != cudaSuccess) return err;
  const int blocks = (Sq + S::BM - 1) / S::BM * B * Hq;
  flash_bwd_dq_kernel<T, D><<<blocks, S::NTHREADS, S::SMEM, stream>>>(
      tq, tk, tv, tdo, tdq, to, static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<const float*>(dlse), B, Hq,
      Hkv, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* di, void* dk, void* dv, int B,
               int Hq, int Hkv, int Sq, int Sk, float scale, int causal,
               int window, cudaStream_t stream) {
  using S = Kv<D>;
  constexpr bool f16 = std::is_same<T, __half>::value;
  const int group = Hq / Hkv;
  // the largest power of two up to MAX_CLUSTER blocks that divides the
  // group (two for an even group at D 64 / 128), else one block for the
  // whole group
  int csize = S::MAX_CLUSTER;
  while (group % csize != 0) csize /= 2;
  const int sq = Sq > 0 ? Sq : 1;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = encode_rows(&tq, q, f16, B * Hq, sq, S::BQ, D)) !=
          cudaSuccess ||
      (err = encode_rows(&tdo, dout, f16, B * Hq, sq, S::BQ, D)) !=
          cudaSuccess ||
      (err = encode_rows(&tk, k, f16, B * Hkv, Sk, S::BN, D)) !=
          cudaSuccess ||
      (err = encode_rows(&tv, v, f16, B * Hkv, Sk, S::BN, D)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize * Hkv * B * ((Sk + S::BN - 1) / S::BN));
  cfg.blockDim = dim3(S::NTHREADS);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dkv_kernel<T, D>, tq, tk, tv, tdo,
                           static_cast<const float*>(lse),
                           static_cast<const float*>(di), static_cast<T*>(dk),
                           static_cast<T*>(dv), B, Hq, Hkv, Sq, Sk, csize,
                           scale, causal, window);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int D>
int launch_delta(const void* o, const void* dout, const void* dlse, void* di,
                 int rows, cudaStream_t stream) {
  constexpr int per_block = DELTA_THREADS / (D / 8);  // rows a block
  const int blocks = (rows + per_block - 1) / per_block;
  flash_bwd_delta_kernel<T, D><<<blocks, DELTA_THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<const float*>(dlse), static_cast<float*>(di), rows);
  return cudaGetLastError();
}

// The launch F<T, D>(args...) at the call's type and head dim (64, 128 or
// 256; any other is refused).
#define AULE_BY_TYPE_AND_D(F, dtype, D, ...)                        \
  do {                                                              \
    const bool f16_ = (dtype) == aule::kF16;                        \
    switch (D) {                                                    \
      case 64:                                                      \
        return f16_ ? F<__half, 64>(__VA_ARGS__)                    \
                    : F<__nv_bfloat16, 64>(__VA_ARGS__);            \
      case 128:                                                     \
        return f16_ ? F<__half, 128>(__VA_ARGS__)                   \
                    : F<__nv_bfloat16, 128>(__VA_ARGS__);           \
      case 256:                                                     \
        return f16_ ? F<__half, 256>(__VA_ARGS__)                   \
                    : F<__nv_bfloat16, 256>(__VA_ARGS__);           \
    }                                                               \
    return cudaErrorInvalidValue;                                   \
  } while (0)

}  // namespace

// o, dlse: the forward's output and the lse cotangent (or null), from
// which the D 64 / 256 kernels compute delta (DqTile); di: the delta
// kernel's, which D 128 reads.
extern "C" int aule_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* o,
                                 const void* dlse, const void* lse,
                                 const void* di, void* dq, int B, int Hq,
                                 int Hkv, int Sq, int Sk, int D, float scale,
                                 int causal, int window, int dtype,
                                 void* stream) {
  if (Sq <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  AULE_BY_TYPE_AND_D(launch_dq, dtype, D, q, k, v, dout, o, dlse, lse, di,
                     dq, B, Hq, Hkv, Sq, Sk, scale, causal, window, s);
}

extern "C" int aule_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* di, void* dk,
                                  void* dv, int B, int Hq, int Hkv, int Sq,
                                  int Sk, int D, float scale, int causal,
                                  int window, int dtype, void* stream) {
  if (Sk <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  AULE_BY_TYPE_AND_D(launch_dkv, dtype, D, q, k, v, dout, lse, di, dk, dv, B,
                     Hq, Hkv, Sq, Sk, scale, causal, window, s);
}

extern "C" int aule_flash_bwd_delta(const void* o, const void* dout,
                                    const void* dlse, void* di, int rows,
                                    int D, int dtype, void* stream) {
  if (rows <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  AULE_BY_TYPE_AND_D(launch_delta, dtype, D, o, dout, dlse, di, rows, s);
}
