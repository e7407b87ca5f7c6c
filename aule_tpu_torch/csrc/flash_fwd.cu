// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernels aule_tpu/ops/flash.py::_fwd_kernel (the
// general FA-2 schedule, prefill below 1024 tokens) and
// aule_tpu/ops/flash.py::_mono_kernel (causal bf16 D=128, 1024 <= S <=
// 4096): both compute softmax(scale * Q K^T + mask) V, and one Hopper
// kernel with causal and window tile skipping covers the two shape classes
// (and those of _causal_kernel and _win_kernel).
//
// What bounds it on the H100: Llama-3-8B prefill, B1 Hq32/Hkv8 S2048
// D128 causal, is 34.4 GFLOP per layer (34.7 us at 989 TFLOP/s bf16)
// against 42 MB of Q, K, V and O (12.5 us at 3.35 TB/s): tensor-core
// bound.  The only way to the card's full tensor-core rate is wgmma, fed
// from shared memory by TMA, so the design is FlashAttention-3's:
//   * one block per (batch, q head, 128-row q tile), 384 threads: a
//     producer warpgroup and two consumer warpgroups of 64 q rows each.
//     The producer gives up registers (setmaxnreg 24) and one of its
//     threads issues every load; the consumers take them (setmaxnreg 240)
//     for their 64 x 128 f32 accumulators of S and O;
//   * Q (128 rows) and 128-key K and V tiles come in by TMA, 128-byte
//     swizzled, through rank-3 maps over [batch x heads, S, 128] (hopper.cuh
//     encode_rows128): rows past S load as zeros and never run into the
//     next head, so ragged lengths cost the kernel no address arithmetic.
//     K/V go round a ring of NST = 3 stages (224 KB of shared memory with
//     Q; on an H100 3 stages ran faster than 2 at S2048 and B4 S4096), each
//     with full barriers for K and V (TMA completes their bytes) and an
//     empty barrier the consumer warps arrive on when the stage is read;
//   * S = Q K^T on wgmma m64n128k16 with A = Q and B = K from shared memory
//     (both K-major); O += P V on wgmma m64n128k16 with A = P from
//     registers (the S accumulators rounded to bf16/f16 in place: P never
//     goes to shared memory) and B = V read MN-major through the transposed
//     -B bit, so V needs no transpose pass; f32 sums;
//   * online softmax in exp2: scale*log2(e) is folded into the exp2
//     argument as one FFMA (folding it into the bf16 Q tile would round
//     it), the row sum is kept per thread and reduced once at the end (the
//     arithmetic of common.cuh `flash_tile`);
//   * kv tiles past the causal diagonal (or outside the window) are never
//     loaded; only tiles that straddle a mask edge for a warpgroup's rows
//     pay for the element mask;
//   * GQA: one q head per block, its group's blocks side by side in launch
//     order (q head innermost), so the group's reads of a K/V tile meet
//     in L2; the heaviest causal q tiles launch first, so the tail of
//     the grid is short;
//   * the epilogue writes each warpgroup's normalised O rows over its own
//     Q rows in shared memory and stores them with one TMA store per half
//     (rows past Sq clipped); the natural-log LSE goes straight from
//     registers.
// A warpgroup runs S, its softmax and P V in turn; the two warpgroups
// overlap one's softmax with the other's products as the warp schedulers
// interleave them.  Explicit ping-pong on named barriers and overlapping a
// warpgroup's softmax with its own next S were slower on the card: with
// each product at more than one code site, ptxas serialises every wgmma
// (C7518/C7512 in the build log) and spills, and ping-pong around this
// single-site loop gained nothing (PERF.md, Findings).
//
// Fused RoPE and a device-side kv_len (_fwd_kernel's use_rope and
// dynamic_kv_len, flash.py:108-136, 227-246) take the kernel's EXT
// instantiation; the plain one compiles as before.  With tables, each
// consumer warpgroup rotates its 64 Q rows once, after Q lands and before
// its first product, and the producer warpgroup rotates each K stage in
// shared memory after its TMA load lands (in place, keeping the 128-byte
// swizzle: values d and d + 64 of a row sit at the same offset of the two
// 64-column halves) and releases it to the consumers on a barrier of its
// own, as paged_prefill.cu's producer converts its 1-byte tiles; it keeps
// NST - 1 loads in flight ahead of the rotation.  kv_len is read from the
// card by every thread: the tile range and the ragged mask come from it.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace aule;
using namespace aule::hopper;

constexpr int D = kTileD;                   // head dim (the only one)
constexpr int BM = 128;                     // q rows per block
constexpr int WG_ROWS = 64;                 // q rows per consumer warpgroup
constexpr int BN = 128;                     // keys per K/V tile
constexpr int NST = 3;                      // K/V ring stages
constexpr int ROW_BYTES = 128;              // a swizzled half-row: 64 values
constexpr int HALF_BYTES = BN * ROW_BYTES;  // one 64-column half of a tile
constexpr int TILE_BYTES = 2 * HALF_BYTES;  // a K or V stage, or the Q tile
constexpr int NTHREADS = 3 * 128;           // producer WG + 2 consumer WGs
// full Q, full K/V, empty; EXT: rotated K
template <bool EXT>
constexpr int NBARS = 1 + (EXT ? 4 : 3) * NST;
template <bool EXT>
constexpr int SMEM_BYTES = 1024 + (1 + 2 * NST) * TILE_BYTES + 8 * NBARS<EXT>;
// setmaxnreg: the producer gives up registers, the consumers take them;
// EXT's producer rotates K stages (24 + 2 * 240 and 56 + 2 * 224 fit the
// 3 * 168 a thread has at launch)
template <bool EXT>
constexpr int PREGS = EXT ? 56 : 24;
template <bool EXT>
constexpr int CREGS = EXT ? 224 : 240;
static_assert(BM == BN, "the Q tile and a K/V stage share TILE_BYTES");
static_assert(D == 128, "two 64-column halves per row");

// Shared memory: Q, K stages, V stages (each 1024-byte aligned), barriers.
struct Smem {
  uint32_t q;
  __device__ uint32_t k(int s) const { return q + (1 + s) * TILE_BYTES; }
  __device__ uint32_t v(int s) const {
    return q + (1 + NST + s) * TILE_BYTES;
  }
  __device__ uint32_t bar(int i) const {
    return q + (1 + 2 * NST) * TILE_BYTES + 8 * i;
  }
  __device__ uint32_t full_q() const { return bar(0); }
  __device__ uint32_t full_k(int s) const { return bar(1 + s); }
  __device__ uint32_t full_v(int s) const { return bar(1 + NST + s); }
  __device__ uint32_t empty(int s) const { return bar(1 + 2 * NST + s); }
  __device__ uint32_t ready_k(int s) const { return bar(1 + 3 * NST + s); }
};

// Rotates rows r0 .. r0 + n - 1 of a 128-row tile at `tile` (two 64-column
// halves of 128-byte swizzled rows) by table row pos0 + r, `threads`
// threads from `tid`; rows at or past `limit` or rope_len are left as they
// are (zeros, or the identity past the table).
template <typename T>
__device__ __forceinline__ void rope_tile(uint32_t tile, int r0, int n,
                                          int pos0, int limit,
                                          const float* rc, const float* rs,
                                          int rope_len, int tid,
                                          int threads) {
  rope_pairs<T>(
      tid, n * 8, threads, HALF_BYTES, D / 2,
      [&](int i) {
        const int r = r0 + i / 8, c = i % 8;
        return tile + r * ROW_BYTES + ((c ^ (r & 7)) << 4);
      },
      [&](int i) {
        const int pos = pos0 + r0 + i / 8;
        return pos < limit && pos < rope_len ? pos : -1;
      },
      rc, rs);
}

// 2^x by the card's ex2.approx.ftz: exp2f adds three instructions per
// element to keep results below 2^-126, which are far below a rounding
// step of the row's largest p.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// kv tiles j_lo .. j_hi hold every key some row of q_lo .. q_hi can see
__device__ __forceinline__ void kv_tiles(int q_lo, int q_hi, int Sk,
                                         int causal, int window, int& j_lo,
                                         int& j_hi) {
  int k_min = 0, k_max = Sk - 1;
  if (causal) k_max = min(k_max, q_hi);
  if (window > 0) {
    k_min = max(0, q_lo - window);
    if (!causal) k_max = min(k_max, q_hi + window);
  }
  j_lo = k_min / BN;
  j_hi = (k_max >= k_min) ? k_max / BN : j_lo - 1;
}

// tq, to: [B * Hq, Sq, D] (boxes of 128 and 64 rows); tk, tv: [B * Hkv, Sk,
// D] (boxes of 128 rows); lse: [B, Hq, Sq] or null.  EXT: rope tables
// [rope_len, D/2] f32 (or null) and kv_len, one int32 on the card (or
// null).  Grid: one block per (q tile, batch, q head), q head fastest, last
// q tile first.
template <typename T, bool EXT>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to,
                     float* __restrict__ lse, const float* rc,
                     const float* rs, const int* kv_len, int B, int Hq,
                     int Hkv, int Sq, int Sk_all, int rope_len, float scale,
                     int causal, int window) {
  extern __shared__ uint8_t smem[];
  Smem sm;
  sm.q = (smem_u32(smem) + 1023) & ~1023u;

  const int nq = (Sq + BM - 1) / BM;
  int id = blockIdx.x;
  const int h = id % Hq;
  id /= Hq;
  const int b = id % B;
  const int q_lo = (nq - 1 - id / B) * BM;
  const int q_hi = min(q_lo + BM, Sq) - 1;
  const int bhq = b * Hq + h;
  const int bhk = b * Hkv + h / (Hq / Hkv);
  // the keys that attend: the first kv_len (EXT), else all
  const int Sk = EXT ? live_keys(kv_len, Sk_all) : Sk_all;
  const bool rope = EXT && rc != nullptr;
  int j_lo, j_hi;
  kv_tiles(q_lo, q_hi, Sk, causal, window, j_lo, j_hi);

  if (threadIdx.x == 0) {
    mbar_init(sm.full_q(), 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(sm.full_k(s), 1);
      mbar_init(sm.full_v(s), 1);
      mbar_init(sm.empty(s), 2 * 4);  // one arrival per consumer warp
      if (EXT) mbar_init(sm.ready_k(s), 128);  // every producer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<PREGS<EXT>>();
    if (rope) {
      // every thread rotates each K stage once its load lands; thread 0
      // refills the stage before it, keeping NST - 1 loads ahead
      const int tid = threadIdx.x, n = j_hi - j_lo + 1;
      auto issue = [&](int it) {  // tile j_lo + it into stage it % NST
        const int s = it % NST, j = j_lo + it;
        mbar_wait(sm.empty(s), ((it / NST) & 1) ^ 1);  // round 0 passes
        mbar_expect_tx(sm.full_k(s), TILE_BYTES);
        tma_load_3d(sm.k(s), &tk, sm.full_k(s), 0, j * BN, bhk);
        tma_load_3d(sm.k(s) + HALF_BYTES, &tk, sm.full_k(s), 64, j * BN,
                    bhk);
        mbar_expect_tx(sm.full_v(s), TILE_BYTES);
        tma_load_3d(sm.v(s), &tv, sm.full_v(s), 0, j * BN, bhk);
        tma_load_3d(sm.v(s) + HALF_BYTES, &tv, sm.full_v(s), 64, j * BN,
                    bhk);
      };
      if (tid == 0) {
        tma_prefetch_map(&tq);
        tma_prefetch_map(&tk);
        tma_prefetch_map(&tv);
        tma_prefetch_map(&to);
        mbar_expect_tx(sm.full_q(), TILE_BYTES);
        tma_load_3d(sm.q, &tq, sm.full_q(), 0, q_lo, bhq);
        tma_load_3d(sm.q + HALF_BYTES, &tq, sm.full_q(), 64, q_lo, bhq);
        for (int it = 0; it < NST && it < n; ++it) issue(it);
      }
      for (int it = 0; it < n; ++it) {
        const int s = it % NST;
        mbar_wait(sm.full_k(s), (it / NST) & 1);
        rope_tile<T>(sm.k(s), 0, BN, (j_lo + it) * BN, Sk, rc, rs, rope_len,
                     tid, 128);
        fence_proxy_async();  // the stores, before wgmma reads them
        mbar_arrive(sm.ready_k(s));
        // the stage of tile it - 1, released once the consumers are past it
        if (tid == 0 && it >= 1 && it - 1 + NST < n) issue(it - 1 + NST);
      }
    } else if (threadIdx.x == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&to);
      mbar_expect_tx(sm.full_q(), TILE_BYTES);
      tma_load_3d(sm.q, &tq, sm.full_q(), 0, q_lo, bhq);
      tma_load_3d(sm.q + HALF_BYTES, &tq, sm.full_q(), 64, q_lo, bhq);
      for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it) {
        const int s = it % NST;
        mbar_wait(sm.empty(s), ((it / NST) & 1) ^ 1);  // round 0 passes
        mbar_expect_tx(sm.full_k(s), TILE_BYTES);
        tma_load_3d(sm.k(s), &tk, sm.full_k(s), 0, j * BN, bhk);
        tma_load_3d(sm.k(s) + HALF_BYTES, &tk, sm.full_k(s), 64, j * BN,
                    bhk);
        mbar_expect_tx(sm.full_v(s), TILE_BYTES);
        tma_load_3d(sm.v(s), &tv, sm.full_v(s), 0, j * BN, bhk);
        tma_load_3d(sm.v(s) + HALF_BYTES, &tv, sm.full_v(s), 64, j * BN,
                    bhk);
      }
    }
  } else {
    // ---- consumer warpgroup c: q rows 64c .. 64c + 63 of the block
    setmaxnreg_inc<CREGS<EXT>>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int w_lo = q_lo + WG_ROWS * c, w_hi = w_lo + WG_ROWS - 1;
    // the thread's rows: "a" and "b" = a + 8 (the accumulator layout)
    const int qpos_a = w_lo + 16 * warp + (lane >> 2), qpos_b = qpos_a + 8;
    const float sl2 = scale * kLog2e;

    float o[64], s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = s[i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY;  // running max of raw scores
    float l_a = 0.f, l_b = 0.f;              // this thread's row-sum parts

    // K-major operands (Q's rows, K's rows): 8-row groups 1024 bytes
    // apart; k-step kk (values 16kk .. 16kk + 15) starts in half kk / 4,
    // 32 bytes per step into it
    const uint32_t sq = sm.q + c * WG_ROWS * ROW_BYTES;
    const uint64_t dq = wgmma_desc(sq, 16, 8 * ROW_BYTES);
    mbar_wait(sm.full_q(), 0);
    if (rope) {  // this warpgroup's 64 Q rows, once
      rope_tile<T>(sm.q, WG_ROWS * c, WG_ROWS, q_lo, Sq, rc, rs, rope_len,
                   threadIdx.x & 127, 128);
      fence_proxy_async();
      named_sync(1 + c, 128);
    }

    for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it) {
      const int st = it % NST;
      const uint32_t ph = (it / NST) & 1;
      const uint64_t dk = wgmma_desc(sm.k(st), 16, 8 * ROW_BYTES);
      // MN-major V: 64-column halves HALF_BYTES apart, 8-key groups 1024
      // bytes apart; k-step kk is keys 16kk .. 16kk + 15
      const uint64_t dv = wgmma_desc(sm.v(st), HALF_BYTES, 8 * ROW_BYTES);

      // S = Q K^T
      mbar_wait(rope ? sm.ready_k(st) : sm.full_k(st), ph);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk / 4) * HALF_BYTES + (kk % 4) * 32) >> 4;
        Wgmma<T>::ss(s, dq + off, dk + off, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // element mask only on tiles that straddle an edge for these rows
      const int kv0 = j * BN;
      const bool need_mask =
          (kv0 + BN > Sk) || (causal && kv0 + BN - 1 > w_lo) ||
          (window > 0 &&
           (w_hi - kv0 > window || (!causal && kv0 + BN - 1 - w_lo > window)));
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int kpos = kv0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int qpos = (i & 2) ? qpos_b : qpos_a;
          bool ok = kpos < Sk;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) {
            ok = ok && qpos - kpos <= window;
            if (!causal) ok = ok && kpos - qpos <= window;
          }
          if (!ok) s[i] = -INFINITY;
        }
      }

      // online softmax (scores in raw units; exp2 of s*sl2 - m*sl2)
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        mx_a = fmaxf(mx_a, fmaxf(s[i], s[i + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[i + 2], s[i + 3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      // a row that has seen nothing yet keeps m = -inf: no NaN from -inf+inf
      const float alpha_a =
          (mx_a == -INFINITY) ? 1.f : exp2_ftz((m_a - mx_a) * sl2);
      const float alpha_b =
          (mx_b == -INFINITY) ? 1.f : exp2_ftz((m_b - mx_b) * sl2);
      const float nb_a = (mx_a == -INFINITY) ? 0.f : -mx_a * sl2;
      const float nb_b = (mx_b == -INFINITY) ? 0.f : -mx_b * sl2;
      float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        s[i] = exp2_ftz(fmaf(s[i], sl2, nb_a));
        s[i + 1] = exp2_ftz(fmaf(s[i + 1], sl2, nb_a));
        s[i + 2] = exp2_ftz(fmaf(s[i + 2], sl2, nb_b));
        s[i + 3] = exp2_ftz(fmaf(s[i + 3], sl2, nb_b));
        ls_a += s[i] + s[i + 1];
        ls_b += s[i + 2] + s[i + 3];
      }
      l_a = l_a * alpha_a + ls_a;
      l_b = l_b * alpha_b + ls_b;
      m_a = mx_a;
      m_b = mx_b;
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        o[i] *= alpha_a;
        o[i + 1] *= alpha_a;
        o[i + 2] *= alpha_b;
        o[i + 3] *= alpha_b;
      }
      // P as A fragments: k-step kk is S's column blocks 2kk and 2kk + 1
      uint32_t p[D / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        p[kk][0] = Elem<T>::pack(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = Elem<T>::pack(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = Elem<T>::pack(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = Elem<T>::pack(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V
      mbar_wait(sm.full_v(st), ph);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        Wgmma<T>::rs(o, p[kk], dv + ((16 * ROW_BYTES * kk) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) fence_regs(p[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(st));  // this warp is done with it
    }

    // ---- epilogue: row sums over the row's 4 threads, normalise, store
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
    const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
    // O over this warpgroup's own Q rows, once all its warps are past
    // their last product; rows ra and ra + 8 share the swizzle (r % 8)
    named_sync(1 + c, 128);
    const int ra = 16 * warp + (lane >> 2);
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      const uint32_t at = sq + (jb / 8) * HALF_BYTES + ra * ROW_BYTES +
                          (((jb % 8) ^ (ra & 7)) << 4) + 4 * t;
      st_shared_u32(at, Elem<T>::pack(o[4 * jb] * inv_a,
                                      o[4 * jb + 1] * inv_a));
      st_shared_u32(at + 8 * ROW_BYTES, Elem<T>::pack(o[4 * jb + 2] * inv_b,
                                                      o[4 * jb + 3] * inv_b));
    }
    fence_proxy_async();
    named_sync(1 + c, 128);
    if ((threadIdx.x & 127) == 0 && w_lo < Sq) {
      tma_store_3d(&to, sq, 0, w_lo, bhq);
      tma_store_3d(&to, sq + HALF_BYTES, 64, w_lo, bhq);
      tma_store_commit();
      tma_store_wait_read();
    }
    // natural-log LSE m * scale + ln l, or kMaskValue for a row that saw
    // nothing (its output is zeros)
    if (lse != nullptr && t == 0) {
      const size_t row0 = (size_t)bhq * Sq;
      if (qpos_a < Sq)
        lse[row0 + qpos_a] = l_a > 0.f ? m_a * scale + logf(l_a) : kMaskValue;
      if (qpos_b < Sq)
        lse[row0 + qpos_b] = l_b > 0.f ? m_b * scale + logf(l_b) : kMaskValue;
    }
  }
}

template <typename T, bool EXT>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* rc, const void* rs, const void* kv_len, int B, int Hq,
           int Hkv, int Sq, int Sk, int rope_len, float scale, int causal,
           int window, cudaStream_t stream) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  CUtensorMap tq, tk, tv, to;
  cudaError_t err;
  if ((err = encode_rows128(&tq, q, f16, B * Hq, Sq, BM)) != cudaSuccess ||
      (err = encode_rows128(&tk, k, f16, B * Hkv, Sk > 0 ? Sk : 1, BN)) !=
          cudaSuccess ||
      (err = encode_rows128(&tv, v, f16, B * Hkv, Sk > 0 ? Sk : 1, BN)) !=
          cudaSuccess ||
      (err = encode_rows128(&to, o, f16, B * Hq, Sq, WG_ROWS)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(flash_fwd_kernel<T, EXT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES<EXT>);
  if (err != cudaSuccess) return err;
  const int blocks = (Sq + BM - 1) / BM * B * Hq;
  flash_fwd_kernel<T, EXT><<<blocks, NTHREADS, SMEM_BYTES<EXT>, stream>>>(
      tq, tk, tv, to, static_cast<float*>(lse),
      static_cast<const float*>(rc), static_cast<const float*>(rs),
      static_cast<const int*>(kv_len), B, Hq, Hkv, Sq, Sk, rope_len, scale,
      causal, window);
  return cudaGetLastError();
}

template <typename T>
int launch_any(const void* q, const void* k, const void* v, void* o,
               void* lse, const void* rc, const void* rs, const void* kv_len,
               int B, int Hq, int Hkv, int Sq, int Sk, int rope_len,
               float scale, int causal, int window, cudaStream_t stream) {
  if (rc != nullptr || kv_len != nullptr)
    return launch<T, true>(q, k, v, o, lse, rc, rs, kv_len, B, Hq, Hkv, Sq,
                           Sk, rope_len, scale, causal, window, stream);
  return launch<T, false>(q, k, v, o, lse, nullptr, nullptr, nullptr, B, Hq,
                          Hkv, Sq, Sk, 0, scale, causal, window, stream);
}

}  // namespace

// rc, rs: RoPE tables [rope_len, D/2] f32, or null; kv_len: one int32 on
// the card, or null.
extern "C" int aule_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* rc,
                              const void* rs, const void* kv_len, int B,
                              int Hq, int Hkv, int Sq, int Sk, int rope_len,
                              float scale, int causal, int window, int dtype,
                              void* stream) {
  if (Sq <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == aule::kF16)
    return launch_any<__half>(q, k, v, o, lse, rc, rs, kv_len, B, Hq, Hkv,
                              Sq, Sk, rope_len, scale, causal, window, s);
  return launch_any<__nv_bfloat16>(q, k, v, o, lse, rc, rs, kv_len, B, Hq,
                                   Hkv, Sq, Sk, rope_len, scale, causal,
                                   window, s);
}

extern "C" const char* aule_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
