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
//     swizzled, through rank-3 maps over [batch x heads, S, D] (hopper.cuh
//     encode_rows): rows past S load as zeros and never run into the
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
//
// Head dims 64 and 256 (the template's D; `Tile<D>` holds each one's
// shape).  A tile of D columns is D / 64 swizzled 64-column chunks
// (hopper.cuh encode_rows), so Q K^T runs D / 16 k-steps across them and
// P V's V operand spans D / 64 swizzle atoms along N (the descriptor's lbo
// is the chunk stride).
//   * D = 64: O += P V is m64n64k16 (32 f32 sums a thread), Q and a K or
//     V stage 16 KB each.  GPT-2's layer (B1 Hq12 S1024) is a small grid:
//     96 blocks of D = 128's shape on 132 SMs.  One consumer warpgroup (64
//     q rows, 256 threads, no setmaxnreg) with 128-key stages makes it 192
//     blocks, which ran faster on an H100.
//   * D = 256: O is 64 x 256 f32, 128 registers a consumer thread, and
//     ptxas compiles every warpgroup within the launch's share of the
//     register file (168 a thread at 384 threads, whatever setmaxnreg
//     asks; PERF.md), so O, S and P do not fit beside a second consumer
//     warpgroup.  One consumer warpgroup (64 q rows, 256 threads, up to
//     255 registers, no setmaxnreg) with 64-key stages: S = Q K^T is
//     m64n64k16 over 16 k-steps (32 sums), O += P V two m64n128k16 a
//     k-step (hopper.cuh rs_product), and 3 stages of 32 KB K + 32 KB V
//     beside the 32 KB Q tile (225 KB with barriers).
// The RoPE pair (d, d + D/2) of a row sits at D = 128 at one offset of the
// two halves; at 64 it is 4 pieces apart in one 128-byte row, at 256 two
// chunks apart (rope_tile).

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace aule;
using namespace aule::hopper;

constexpr int WG_ROWS = 64;    // q rows per consumer warpgroup
constexpr int ROW_BYTES = 128;  // a swizzled chunk row: 64 values

// The tile shape at head dim D: consumer warpgroups, keys a K/V stage and
// ring stages (see the top).
template <int D>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int NWG = 1, BN = 128, NST = 3;
};
template <>
struct Tile<128> {
  static constexpr int NWG = 2, BN = 128, NST = 3;
};
template <>
struct Tile<256> {
  static constexpr int NWG = 1, BN = 64, NST = 3;
};

template <int D, bool EXT>
struct Shape {
  static constexpr int NWG = Tile<D>::NWG, BN = Tile<D>::BN,
                       NST = Tile<D>::NST;
  static constexpr int BM = NWG * WG_ROWS;             // q rows per block
  static constexpr int NTHREADS = (1 + NWG) * 128;     // producer + consumers
  static constexpr int CHUNKS = D / 64;                // chunks a row
  static constexpr int Q_CHUNK = BM * ROW_BYTES;       // a chunk of Q
  static constexpr int KV_CHUNK = BN * ROW_BYTES;      // a chunk of K or V
  static constexpr int Q_BYTES = CHUNKS * Q_CHUNK;     // the Q tile
  static constexpr int KV_BYTES = CHUNKS * KV_CHUNK;   // a K or V stage
  // full Q, full K/V, empty; EXT: rotated K
  static constexpr int NBARS = 1 + (EXT ? 4 : 3) * NST;
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * NST * KV_BYTES + 8 * NBARS;
  static_assert(SMEM <= 232448, "the block's shared memory");
};

// Shared memory: Q, K stages, V stages (each 1024-byte aligned), barriers.
template <int D, bool EXT>
struct Smem {
  using S = Shape<D, EXT>;
  uint32_t q;
  __device__ uint32_t k(int s) const { return q + S::Q_BYTES + s * S::KV_BYTES; }
  __device__ uint32_t v(int s) const {
    return q + S::Q_BYTES + (S::NST + s) * S::KV_BYTES;
  }
  __device__ uint32_t bar(int i) const {
    return q + S::Q_BYTES + 2 * S::NST * S::KV_BYTES + 8 * i;
  }
  __device__ uint32_t full_q() const { return bar(0); }
  __device__ uint32_t full_k(int s) const { return bar(1 + s); }
  __device__ uint32_t full_v(int s) const { return bar(1 + S::NST + s); }
  __device__ uint32_t empty(int s) const { return bar(1 + 2 * S::NST + s); }
  __device__ uint32_t ready_k(int s) const {
    return bar(1 + 3 * S::NST + s);
  }
};

// Rotates rows r0 .. r0 + n - 1 of a tile at `tile` (D / 64 chunks of
// 128-byte swizzled rows, CHUNK bytes apart) by table row pos0 + r,
// `threads` threads from `tid`; rows at or past `limit` or rope_len are
// left as they are (zeros, or the identity past the table).  The pair of
// 16-byte pieces (d, d + D/2) of a row: at D = 128 the same offset of the
// two chunks; at 64 pieces c and c + 4 of one row; at 256 piece c of chunk
// h and of chunk h + 2.
template <typename T, int D, int CHUNK>
__device__ __forceinline__ void rope_tile(uint32_t tile, int r0, int n,
                                          int pos0, int limit,
                                          const float* rc, const float* rs,
                                          int rope_len, int tid,
                                          int threads) {
  if constexpr (D == 128) {
    rope_pairs<T>(
        tid, n * 8, threads, CHUNK, D / 2,
        [&](int i) {
          const int r = r0 + i / 8, c = i % 8;
          return tile + r * ROW_BYTES + ((c ^ (r & 7)) << 4);
        },
        [&](int i) {
          const int pos = pos0 + r0 + i / 8;
          return pos < limit && pos < rope_len ? pos : -1;
        },
        rc, rs);
  } else {
    constexpr int PAIRS = D / 16;  // piece pairs a row
    // shared address of the piece holding value `col` of row r
    auto at = [&](int r, int col) {
      return tile + (col / 64) * CHUNK + r * ROW_BYTES +
             ((((col % 64) / 8) ^ (r & 7)) << 4);
    };
    for (int i = tid; i < n * PAIRS; i += threads) {
      const int r = r0 + i / PAIRS, lo = 8 * (i % PAIRS);
      const int pos = pos0 + r;
      if (pos >= limit || pos >= rope_len) continue;
      const size_t row = (size_t)pos * (D / 2) + lo;
      RopeAngles ang;
      ang.load(rc + row, rs + row);
      rope_chunks<T>(at(r, lo), at(r, lo + D / 2), ang);
    }
  }
}

// 2^x by the card's ex2.approx.ftz: exp2f adds three instructions per
// element to keep results below 2^-126, which are far below a rounding
// step of the row's largest p.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// kv tiles j_lo .. j_hi (BN keys each) hold every key some row of q_lo ..
// q_hi can see
template <int BN>
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

// tq, to: [B * Hq, Sq, D] (boxes of BM and 64 rows); tk, tv: [B * Hkv, Sk,
// D] (boxes of BN rows); lse: [B, Hq, Sq] or null.  EXT: rope tables
// [rope_len, D/2] f32 (or null) and kv_len, one int32 on the card (or
// null).  Grid: one block per (q tile, batch, q head), q head fastest, last
// q tile first.
template <typename T, int D, bool EXT>
__global__ void __launch_bounds__(Shape<D, EXT>::NTHREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to,
                     float* __restrict__ lse, const float* rc,
                     const float* rs, const int* kv_len, int B, int Hq,
                     int Hkv, int Sq, int Sk_all, int rope_len, float scale,
                     int causal, int window) {
  using S = Shape<D, EXT>;
  constexpr int BM = S::BM, BN = S::BN, NST = S::NST, NWG = S::NWG;
  constexpr int CHUNKS = S::CHUNKS, Q_CHUNK = S::Q_CHUNK,
                KV_CHUNK = S::KV_CHUNK;
  extern __shared__ uint8_t smem[];
  Smem<D, EXT> sm;
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
  kv_tiles<BN>(q_lo, q_hi, Sk, causal, window, j_lo, j_hi);

  if (threadIdx.x == 0) {
    mbar_init(sm.full_q(), 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(sm.full_k(s), 1);
      mbar_init(sm.full_v(s), 1);
      mbar_init(sm.empty(s), NWG * 4);  // one arrival per consumer warp
      if (EXT) mbar_init(sm.ready_k(s), 128);  // every producer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the Q tile, D / 64 chunks
  auto load_q = [&]() {
    mbar_expect_tx(sm.full_q(), S::Q_BYTES);
#pragma unroll
    for (int ch = 0; ch < CHUNKS; ++ch)
      tma_load_3d(sm.q + ch * Q_CHUNK, &tq, sm.full_q(), 64 * ch, q_lo, bhq);
  };
  // kv tile j into stage s once the consumers have released it
  auto load_kv = [&](int s, int j, uint32_t empty_parity) {
    mbar_wait(sm.empty(s), empty_parity);
    mbar_expect_tx(sm.full_k(s), S::KV_BYTES);
#pragma unroll
    for (int ch = 0; ch < CHUNKS; ++ch)
      tma_load_3d(sm.k(s) + ch * KV_CHUNK, &tk, sm.full_k(s), 64 * ch,
                  j * BN, bhk);
    mbar_expect_tx(sm.full_v(s), S::KV_BYTES);
#pragma unroll
    for (int ch = 0; ch < CHUNKS; ++ch)
      tma_load_3d(sm.v(s) + ch * KV_CHUNK, &tv, sm.full_v(s), 64 * ch,
                  j * BN, bhk);
  };

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full
    // setmaxnreg (two consumer warpgroups, D = 128): the producer gives up
    // registers, the consumers take them; EXT's producer rotates K stages
    // (24 + 2 * 240 and 56 + 2 * 224 fit the 3 * 168 a thread has at
    // launch)
    if constexpr (NWG == 2) setmaxnreg_dec<EXT ? 56 : 24>();
    if (rope) {
      // every thread rotates each K stage once its load lands; thread 0
      // refills the stage before it, keeping NST - 1 loads ahead
      const int tid = threadIdx.x, n = j_hi - j_lo + 1;
      auto issue = [&](int it) {  // tile j_lo + it into stage it % NST
        load_kv(it % NST, j_lo + it, ((it / NST) & 1) ^ 1);  // round 0 passes
      };
      if (tid == 0) {
        tma_prefetch_map(&tq);
        tma_prefetch_map(&tk);
        tma_prefetch_map(&tv);
        tma_prefetch_map(&to);
        load_q();
        for (int it = 0; it < NST && it < n; ++it) issue(it);
      }
      for (int it = 0; it < n; ++it) {
        const int s = it % NST;
        mbar_wait(sm.full_k(s), (it / NST) & 1);
        rope_tile<T, D, KV_CHUNK>(sm.k(s), 0, BN, (j_lo + it) * BN, Sk, rc,
                                  rs, rope_len, tid, 128);
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
      load_q();
      for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it)
        load_kv(it % NST, j, ((it / NST) & 1) ^ 1);  // round 0 passes
    }
  } else {
    // ---- consumer warpgroup c: q rows 64c .. 64c + 63 of the block
    if constexpr (NWG == 2) setmaxnreg_inc<EXT ? 224 : 240>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int w_lo = q_lo + WG_ROWS * c, w_hi = w_lo + WG_ROWS - 1;
    // the thread's rows: "a" and "b" = a + 8 (the accumulator layout)
    const int qpos_a = w_lo + 16 * warp + (lane >> 2), qpos_b = qpos_a + 8;
    const float sl2 = scale * kLog2e;

    // S: the thread's BN / 2 sums of a 64 x BN tile; O: its D / 2 of 64 x D
    float o[D / 2], s[BN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY;  // running max of raw scores
    float l_a = 0.f, l_b = 0.f;              // this thread's row-sum parts

    // K-major operands (Q's rows, K's rows): 8-row groups 1024 bytes
    // apart; k-step kk (values 16kk .. 16kk + 15) starts in chunk kk / 4,
    // 32 bytes per step into it
    const uint32_t sq = sm.q + c * WG_ROWS * ROW_BYTES;
    const uint64_t dq = wgmma_desc(sq, 16, 8 * ROW_BYTES);
    mbar_wait(sm.full_q(), 0);
    if (rope) {  // this warpgroup's 64 Q rows, once
      rope_tile<T, D, Q_CHUNK>(sm.q, WG_ROWS * c, WG_ROWS, q_lo, Sq, rc, rs,
                               rope_len, threadIdx.x & 127, 128);
      fence_proxy_async();
      named_sync(1 + c, 128);
    }

    for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it) {
      const int st = it % NST;
      const uint32_t ph = (it / NST) & 1;
      const uint64_t dk = wgmma_desc(sm.k(st), 16, 8 * ROW_BYTES);
      // MN-major V: 64-column chunks KV_CHUNK apart, 8-key groups 1024
      // bytes apart; k-step kk is keys 16kk .. 16kk + 15
      const uint64_t dv = wgmma_desc(sm.v(st), KV_CHUNK, 8 * ROW_BYTES);

      // S = Q K^T
      mbar_wait(rope ? sm.ready_k(st) : sm.full_k(st), ph);
      fence_regs(s);
      wgmma_fence();
      if constexpr (BN == 128) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<T>::ss(s, dq + kstep(kk, BM), dk + kstep(kk, BN), kk > 0);
      } else {
        ss_product<T, D, BM, BN>(s, dq, dk);
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
        for (int i = 0; i < BN / 2; ++i) {
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
      for (int i = 0; i < BN / 2; i += 4) {
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
      for (int i = 0; i < BN / 2; i += 4) {
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
      for (int i = 0; i < D / 2; i += 4) {
        o[i] *= alpha_a;
        o[i + 1] *= alpha_a;
        o[i + 2] *= alpha_b;
        o[i + 3] *= alpha_b;
      }
      // P as A fragments: k-step kk is S's column blocks 2kk and 2kk + 1
      uint32_t p[BN / 16][4];
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
      if constexpr (D == 128) {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          Wgmma<T>::rs(o, p[kk], dv + ((16 * ROW_BYTES * kk) >> 4));
      } else {
        rs_product<T, D, KV_CHUNK, BN / 16>(o, p, dv);
      }
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
      const uint32_t at = sq + (jb / 8) * Q_CHUNK + ra * ROW_BYTES +
                          (((jb % 8) ^ (ra & 7)) << 4) + 4 * t;
      st_shared_u32(at, Elem<T>::pack(o[4 * jb] * inv_a,
                                      o[4 * jb + 1] * inv_a));
      st_shared_u32(at + 8 * ROW_BYTES, Elem<T>::pack(o[4 * jb + 2] * inv_b,
                                                      o[4 * jb + 3] * inv_b));
    }
    fence_proxy_async();
    named_sync(1 + c, 128);
    if ((threadIdx.x & 127) == 0 && w_lo < Sq) {
#pragma unroll
      for (int ch = 0; ch < CHUNKS; ++ch)
        tma_store_3d(&to, sq + ch * Q_CHUNK, 64 * ch, w_lo, bhq);
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

template <typename T, int D, bool EXT>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* rc, const void* rs, const void* kv_len, int B, int Hq,
           int Hkv, int Sq, int Sk, int rope_len, float scale, int causal,
           int window, cudaStream_t stream) {
  using S = Shape<D, EXT>;
  constexpr bool f16 = std::is_same<T, __half>::value;
  CUtensorMap tq, tk, tv, to;
  cudaError_t err;
  const int sk = Sk > 0 ? Sk : 1;
  if ((err = encode_rows(&tq, q, f16, B * Hq, Sq, S::BM, D)) != cudaSuccess ||
      (err = encode_rows(&tk, k, f16, B * Hkv, sk, S::BN, D)) !=
          cudaSuccess ||
      (err = encode_rows(&tv, v, f16, B * Hkv, sk, S::BN, D)) !=
          cudaSuccess ||
      (err = encode_rows(&to, o, f16, B * Hq, Sq, WG_ROWS, D)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(flash_fwd_kernel<T, D, EXT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::SMEM);
  if (err != cudaSuccess) return err;
  const int blocks = (Sq + S::BM - 1) / S::BM * B * Hq;
  flash_fwd_kernel<T, D, EXT><<<blocks, S::NTHREADS, S::SMEM, stream>>>(
      tq, tk, tv, to, static_cast<float*>(lse),
      static_cast<const float*>(rc), static_cast<const float*>(rs),
      static_cast<const int*>(kv_len), B, Hq, Hkv, Sq, Sk, rope_len, scale,
      causal, window);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_any(const void* q, const void* k, const void* v, void* o,
               void* lse, const void* rc, const void* rs, const void* kv_len,
               int B, int Hq, int Hkv, int Sq, int Sk, int rope_len,
               float scale, int causal, int window, cudaStream_t stream) {
  if (rc != nullptr || kv_len != nullptr)
    return launch<T, D, true>(q, k, v, o, lse, rc, rs, kv_len, B, Hq, Hkv,
                              Sq, Sk, rope_len, scale, causal, window,
                              stream);
  return launch<T, D, false>(q, k, v, o, lse, nullptr, nullptr, nullptr, B,
                             Hq, Hkv, Sq, Sk, 0, scale, causal, window,
                             stream);
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o,
             void* lse, const void* rc, const void* rs, const void* kv_len,
             int B, int Hq, int Hkv, int Sq, int Sk, int D, int rope_len,
             float scale, int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_any<T, 64>(q, k, v, o, lse, rc, rs, kv_len, B, Hq, Hkv,
                               Sq, Sk, rope_len, scale, causal, window,
                               stream);
    case 128:
      return launch_any<T, 128>(q, k, v, o, lse, rc, rs, kv_len, B, Hq, Hkv,
                                Sq, Sk, rope_len, scale, causal, window,
                                stream);
    case 256:
      return launch_any<T, 256>(q, k, v, o, lse, rc, rs, kv_len, B, Hq, Hkv,
                                Sq, Sk, rope_len, scale, causal, window,
                                stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// D: 64, 128 or 256.  rc, rs: RoPE tables [rope_len, D/2] f32, or null;
// kv_len: one int32 on the card, or null.
extern "C" int aule_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* rc,
                              const void* rs, const void* kv_len, int B,
                              int Hq, int Hkv, int Sq, int Sk, int D,
                              int rope_len, float scale, int causal,
                              int window, int dtype, void* stream) {
  if (Sq <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == aule::kF16)
    return launch_d<__half>(q, k, v, o, lse, rc, rs, kv_len, B, Hq, Hkv, Sq,
                            Sk, D, rope_len, scale, causal, window, s);
  return launch_d<__nv_bfloat16>(q, k, v, o, lse, rc, rs, kv_len, B, Hq,
                                 Hkv, Sq, Sk, D, rope_len, scale, causal,
                                 window, s);
}

extern "C" const char* aule_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
