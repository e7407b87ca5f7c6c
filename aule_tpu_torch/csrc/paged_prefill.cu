// Chunked prefill over the fused paged pool for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the TPU kernel
// aule_tpu/ops/paged_fused.py::_fused_prefill_kernel: a chunk of queries
// q [B, Hq, Sq, D] attends over the sequence's pages of the fused pool
// kv_pages [P, 2, Hkv, page, D] (history plus the chunk, appended first)
// through block_tables [B, max_pages] (-1 clamps to the scratch page 0).
// Query s of sequence b sits at absolute position qoff[b] + s; it sees
// cache positions kpos < len[b], kpos <= qpos when causal, and
// qpos - kpos <= W with a window.  Rows at or past len[b] (the padding of
// ragged chunks) give zeros and LSE -0.7 * f32max, as do rows that see
// nothing.  Pools hold bf16 / f16 (the q type), or int8 / e4m3 payloads
// with the packed scale tile sc [P, page, 128] (row = slot, lane =
// kv * 64 + h; bf16 or f32): the K scale multiplies the score column, the
// V scale multiplies p before the PV product, and l sums the unscaled p
// (paged_fused.py:851-907).
//
// What bounds it on the H100: the Llama-3-8B chunk case, B1 Hq32/Hkv8 D128
// with 512 queries at offset 3488 over 4000 cached tokens, is 31 GFLOP
// (32 us at 989 TFLOP/s bf16) against 25 MB of q, K, V and out (7.5 us at
// 3.35 TB/s): tensor-core bound, so the design is the flash forward's
// (csrc/flash_fwd.cu, FlashAttention-3) with a paged loader:
//   * one block per (sequence, kv head, q tile) of 128 rows = up to 8 q
//     heads of the GQA group x positions, so each K/V tile is read once
//     per group; the heaviest causal q tiles launch first.  384 threads: a
//     producer warpgroup and two consumer warpgroups of 64 rows each, which
//     take the registers (setmaxnreg) for their f32 S and O sums;
//   * Q comes in by TMA (one box per head), O goes out by TMA (rows past
//     Sq clipped), the natural-log LSE straight from registers;
//   * the K/V tiles (128 keys) follow the block table row by row, which
//     no tensor-map box does: the producer's 128 threads load them with
//     16-byte cp.async into the 128-byte swizzle wgmma reads, zero-filling
//     rows past len, and each thread's `cp.async.mbarrier.arrive` completes
//     the stage's full barrier.  Any page size works.  Tiles past the q
//     tile's last visible position and, with a window, before its first
//     are never loaded;
//   * S = Q K^T and O += P V on wgmma m64n128k16 (Q and K from shared
//     memory, P from registers, V through the transposed-B bit), the
//     online softmax in exp2 with the scale in one FFMA, the element mask
//     only on tiles that straddle an edge for a warpgroup's rows; each
//     product at one code site (a second one makes ptxas serialise every
//     wgmma, PERF.md);
//   * bf16 / f16 pools: a ring of NST = 3 K/V stages (230 KB of shared
//     memory with Q), full barriers for K and V, an empty one per stage;
//   * int8 / e4m3 pools: wgmma takes B only from shared memory in the q
//     type, so the 1-byte tiles are converted there, by the producer and
//     off the consumers' path.  Its threads' cp.async land raw tiles (half
//     the bytes) and their scales in a ring of NRAW = 2 stages, completed
//     on each stage's full barrier; each thread then converts the chunks it
//     loaded itself (so a stage needs no empty barrier) into a q-type K
//     stage and a ring of two V stages, each with a full and an empty
//     barrier, so K(j+1) is converted while the consumers run the softmax
//     and P V of tile j.  The conversions are
//     exact and run on the ALUs (no I2F): int8 -> bf16 through the f32
//     2^23 trick (the value's bf16 is the f32's upper half), int8 -> f16 as
//     f16 (1024 + x + 128) - 1152, e4m3 -> bf16 / f16 by moving the code's
//     sign, exponent and mantissa bits into place and one multiply by 2^120
//     / 2^8 (exact for normals and subnormals; e4m3's NaN codes, which
//     quantize_kv never writes, read as +-480).  The scales are applied to
//     the score accumulators and to p in f32, as the TPU kernel does.
//     What the 1-byte modes still pay over the 16-bit one is the
//     producer's conversion (its ALU work and shared-memory round trip; a
//     deeper q-type ring did not help, PERF.md) and the consumers' scale
//     products.
//
// Head dims 64 and 256 (the template's D; `Tile<D>` holds each one's
// shape, as in flash_fwd.cu; D = 128 is the code described above, its
// constants and branches kept through `if constexpr`).  JAX pads D to the
// 128 lanes of a pool row (paged_fused.py:961-964); here the producer
// reads the D live lanes of each row at the pool's padded stride, never
// the padding.  A tile of D columns is D / 64 swizzled 64-column chunks,
// so Q K^T runs D / 16 k-steps across them and P V's V operand spans
// D / 64 swizzle atoms along N.
//   * D = 64: one consumer warpgroup (64 q rows, 256 threads, no
//     setmaxnreg) with 128-key stages: GPT-2's chunk (12 heads, group 1) is
//     twice the blocks of D = 128's shape.  O += P V is m64n64k16;
//   * D = 256: O is 64 x 256 f32, 128 registers a consumer thread, which
//     do not fit beside a second consumer warpgroup in the 168 a thread
//     has at 384 threads; one consumer warpgroup with 64-key stages: S =
//     Q K^T m64n64k16 over 16 k-steps, O += P V two m64n128k16 a k-step
//     (hopper.cuh rs_product), three 16-bit stages of 32 KB K + 32 KB V
//     beside the 32 KB Q tile.  The 1-byte raw rows are D bytes (D = 64:
//     128, half of it read).

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace aule;
using namespace aule::hopper;

constexpr int WG_ROWS = 64;     // q rows per consumer warpgroup
constexpr int ROW_BYTES = 128;  // a swizzled chunk row: 64 values
constexpr int NRAW = 2;         // 1-byte pools: raw ring stages
constexpr int QNCK = 1, QNCV = 2;  // 1-byte pools: q-type K, V stages

// The shape at head dim D (see the top): consumer warpgroups, keys a K/V
// stage, 16-bit ring stages, and (D = 128, two consumer warpgroups) the
// registers setmaxnreg moves: the producer gives up registers, the
// consumers take them (56 + 2 * 224 = 3 * 168, the registers a thread has
// at launch).
template <int D>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int NWG = 1, BN = 128, NST = 3;
};
template <>
struct Tile<128> {
  static constexpr int NWG = 2, BN = 128, NST = 3;
  static constexpr int PREGS = 56, CREGS = 224;
};
template <>
struct Tile<256> {
  static constexpr int NWG = 1, BN = 64, NST = 3;
};

// Shared memory, from the 1024-byte aligned Q tile: Q, NCK K stages, NCV V
// stages (q type; D / 64 chunks of 128-byte swizzled rows each), then for
// 1-byte pools NRAW raw stages (K then V payload, rows of max(D, 128)
// bytes), their scales (4 bytes a key, K then V) and the q-type stages'
// scales as f32; barriers: full Q, full K and V per stage, empty K and V
// per stage (16-bit pools: one empty barrier a stage for both), full per
// raw stage.
template <int D, bool QUANT>
struct Smem {
  uint32_t q;
  static constexpr int NWG = Tile<D>::NWG, BN = Tile<D>::BN;
  static constexpr int ROWS = NWG * WG_ROWS;          // q rows per block
  static constexpr int NTHREADS = (1 + NWG) * 128;    // producer + consumers
  static constexpr int CHUNKS = D < 64 ? 1 : D / 64;  // 64-column chunks
  static constexpr int Q_CHUNK = ROWS * ROW_BYTES;
  static constexpr int KV_CHUNK = BN * ROW_BYTES;
  static constexpr int Q_BYTES = CHUNKS * Q_CHUNK;
  static constexpr int KV_BYTES = CHUNKS * KV_CHUNK;
  static constexpr int RAW_ROW = D < 128 ? 128 : D;   // a raw row's bytes
  static constexpr int RAW_BYTES = BN * RAW_ROW;      // a 1-byte K or V tile
  static constexpr int NCK = QUANT ? QNCK : Tile<D>::NST;
  static constexpr int NCV = QUANT ? QNCV : Tile<D>::NST;
  static constexpr int NBARS =
      QUANT ? 1 + 2 * (NCK + NCV) + NRAW : 1 + 3 * Tile<D>::NST;
  static constexpr int RAW = Q_BYTES + (NCK + NCV) * KV_BYTES;
  static constexpr int RSC = RAW + NRAW * 2 * RAW_BYTES;
  static constexpr int SCF = RSC + NRAW * 2 * BN * 4;
  static constexpr int BARS = QUANT ? SCF + (NCK + NCV) * BN * 4 : RAW;
  static constexpr int BYTES = 1024 + BARS + 8 * NBARS;
  static_assert(BYTES <= 232448, "shared memory a block can use");

  __device__ uint32_t k(int s) const { return q + Q_BYTES + s * KV_BYTES; }
  __device__ uint32_t v(int s) const {
    return q + Q_BYTES + (NCK + s) * KV_BYTES;
  }
  __device__ uint32_t raw(int s) const { return q + RAW + s * 2 * RAW_BYTES; }
  __device__ uint32_t rsc(int s) const { return q + RSC + s * 2 * BN * 4; }
  __device__ uint32_t bar(int i) const { return q + BARS + 8 * i; }
  __device__ uint32_t full_q() const { return bar(0); }
  __device__ uint32_t full_k(int s) const { return bar(1 + s); }
  __device__ uint32_t full_v(int s) const { return bar(1 + NCK + s); }
  __device__ uint32_t empty_k(int s) const {
    return bar(1 + NCK + NCV + s);
  }
  __device__ uint32_t empty_v(int s) const {
    return QUANT ? bar(1 + 2 * NCK + NCV + s) : empty_k(s);
  }
  __device__ uint32_t raw_full(int s) const {
    return bar(1 + 2 * (NCK + NCV) + s);
  }
  // byte offsets from q of a q-type stage's f32 scales
  __host__ __device__ static constexpr int sck(int s) {
    return SCF + s * BN * 4;
  }
  __host__ __device__ static constexpr int scv(int s) {
    return SCF + (NCK + s) * BN * 4;
  }
};
// D = 128 keeps the layout it had with one shape: Q and a K/V tile 32 KB
static_assert(Smem<128, false>::Q_BYTES == 32768 &&
                  Smem<128, false>::KV_BYTES == 32768 &&
                  Smem<128, true>::RAW_BYTES == 16384,
              "D = 128's tiles");

// 4-byte global->shared async copy; zero-fills the slot where !pred.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ float2 ld_shared_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// 2^x by the card's ex2.approx.ftz (as flash_fwd.cu).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The block's place in the grid: q tiles, heaviest first (x), the q heads
// h0 .. h0 + hpb - 1 of one GQA group (y), the sequence (z).  Read from the
// special registers on each call (asm volatile), so the epilogue computes
// it afresh and nothing of it stays in registers across the main loop.
struct Place {
  int bq, q_lo, h0, b;
};

__device__ __forceinline__ uint32_t sreg(int which) {
  uint32_t v;
  switch (which) {
    case 0: asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(v)); break;
    case 1: asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(v)); break;
    case 2: asm volatile("mov.u32 %0, %%ctaid.z;\n" : "=r"(v)); break;
    case 3: asm volatile("mov.u32 %0, %%nctaid.x;\n" : "=r"(v)); break;
    default: asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(v)); break;
  }
  return v;
}

template <int ROWS>
__device__ __forceinline__ Place place(int Hq, int Hkv, int hpb) {
  const int group = Hq / Hkv, blocks_per_kv = group / hpb;
  const int y = sreg(1);
  Place p;
  p.bq = ROWS / hpb;
  p.q_lo = (sreg(3) - 1 - sreg(0)) * p.bq;
  p.h0 = y / blocks_per_kv * group + y % blocks_per_kv * hpb;
  p.b = sreg(2);
  return p;
}

// q: TMA map over [B * Hq, Sq, D] in boxes of bq rows; o: the same over the
// output in boxes of min(bq, 64) rows; kv: [P, 2, Hkv, page, Dpad] bytes
// (Dpad = D padded to 128 lanes); lse: [B, Hq, Sq] or null.  Grid: (q
// tiles, Hkv * group / hpb, B); hpb q heads per block, bq = ROWS / hpb
// positions each; block row r is head r / bq, position r % bq.
template <typename T, int POOL, int D>
__global__ void __launch_bounds__(Smem<D, POOL != kPoolNative>::NTHREADS, 1)
    paged_prefill_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap to,
                         const uint8_t* __restrict__ kv,
                         const uint8_t* __restrict__ sc, int sc_f32,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ context_lens,
                         const int* __restrict__ q_offsets,
                         float* __restrict__ lse, int Hq, int Hkv, int Sq,
                         int page_size, int max_pages, int hpb, float scale,
                         int causal, int window) {
  constexpr bool QUANT = POOL != kPoolNative;
  constexpr int ESZ = QUANT ? 1 : 2;
  using L = Smem<D, QUANT>;
  constexpr int ROWS = L::ROWS, BN = L::BN, NWG = L::NWG;
  constexpr int NST = Tile<D>::NST, CHUNKS = L::CHUNKS;
  constexpr int Q_CHUNK = L::Q_CHUNK, KV_CHUNK = L::KV_CHUNK;
  constexpr int DP = D < 128 ? 128 : D;  // the pool row's lanes
  extern __shared__ uint8_t smem[];
  L sm;
  sm.q = (smem_u32(smem) + 1023) & ~1023u;
  uint8_t* const gq = smem + (sm.q - smem_u32(smem));  // generic address

  const Place pl = place<ROWS>(Hq, Hkv, hpb);
  const int bq = pl.bq, q_lo = pl.q_lo, h0 = pl.h0, b = pl.b;
  const int q_hi = min(q_lo + bq, Sq) - 1;
  const int hk = h0 / (Hq / Hkv);

  const int len = max(0, min(context_lens[b], max_pages * page_size));
  const int off = q_offsets[b];
  const int qa_lo = off + q_lo, qa_hi = off + q_hi;  // absolute positions
  // cache positions some live row of this block can see: tiles j_lo..j_hi
  int k_min = 0, k_max = len - 1;
  if (causal) k_max = min(k_max, qa_hi);
  if (window > 0) k_min = max(0, qa_lo - window);
  if (qa_lo >= len) k_max = -1;  // every row is past the context
  const int j_lo = k_min / BN;
  const int j_hi = (k_max >= k_min) ? k_max / BN : j_lo - 1;

  if (threadIdx.x == 0) {
    mbar_init(sm.full_q(), 1);
    for (int s = 0; s < L::NCK; ++s) {
      mbar_init(sm.full_k(s), 128);  // one arrival per producer thread
      mbar_init(sm.empty_k(s), NWG * 4);  // one per consumer warp
    }
    for (int s = 0; s < L::NCV; ++s) {
      mbar_init(sm.full_v(s), 128);
      if (QUANT) mbar_init(sm.empty_v(s), NWG * 4);
    }
    for (int s = 0; s < (QUANT ? NRAW : 0); ++s)
      mbar_init(sm.raw_full(s), 128);  // one arrival per producer thread
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup
    if constexpr (NWG == 2) setmaxnreg_dec<Tile<D>::PREGS>();
    const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
    if (tid == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&to);
      mbar_expect_tx(sm.full_q(), L::Q_BYTES);
      for (int h = 0; h < hpb; ++h) {
        const uint32_t dst = sm.q + h * bq * ROW_BYTES;
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch)
          tma_load_3d(dst + ch * Q_CHUNK, &tq, sm.full_q(), 64 * ch, q_lo,
                      b * Hq + h0 + h);
      }
    }
    const int* bt = block_tables + (size_t)b * max_pages;
    const size_t slab = (size_t)page_size * DP * ESZ;  // a page's head rows
    // the thread's tile rows: (BN / 4) w + 8a + (l & 7), a < BN / 32; a
    // warp's 16-byte copies cover 8 rows x 4 chunks, neighbouring lanes on
    // neighbouring rows, so the 8 lanes of a shared-memory phase meet 8
    // bank groups through the swizzle.  A row's D live lanes are read at
    // the pool's padded stride, never its padding.
    auto row_src = [&](int j, int row, int kvsel, bool& ok) {
      const int pos = j * BN + row;
      ok = pos < len;  // rows past len are zero-filled
      const int p = ok ? pos : 0;
      const int phys = max(bt[p / page_size], 0);
      return kv + ((size_t)phys * 2 + kvsel) * Hkv * slab + hk * slab +
             (size_t)(p % page_size) * DP * ESZ;
    };
    if constexpr (!QUANT) {
      for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it) {
        const int s = it % NST;
        mbar_wait(sm.empty_k(s), ((it / NST) & 1) ^ 1);  // round 0 passes
#pragma unroll
        for (int kvsel = 0; kvsel < 2; ++kvsel) {
          const uint32_t dst = kvsel ? sm.v(s) : sm.k(s);
#pragma unroll
          for (int a = 0; a < BN / 32; ++a) {
            const int row = BN / 4 * w + 8 * a + (l & 7);
            bool ok;
            const uint8_t* src = row_src(j, row, kvsel, ok);
#pragma unroll
            for (int c4 = 0; c4 < D / 32; ++c4) {
              const int ch = 4 * c4 + (l >> 3);  // 16-byte chunk of D / 8
              cp_async16(dst + (ch >> 3) * KV_CHUNK + row * ROW_BYTES +
                             (((ch & 7) ^ (row & 7)) << 4),
                         src + ch * 16, ok);
            }
          }
          cp_async_mbar_arrive(kvsel ? sm.full_v(s) : sm.full_k(s));
        }
      }
      cp_async_wait<0>();  // no copy outlives its thread
    } else {
      const int n = j_hi - j_lo + 1;
      // raw tile j -> raw stage rs: payload rows at RAW_ROW bytes, chunk
      // c8 of row r at c8 ^ (r % 8); key `tid`'s K and V scales (the
      // aligned 4 bytes that hold lane kv * 64 + hk), tid < BN
      constexpr int RAW_ROW = L::RAW_ROW, RAW_BYTES = L::RAW_BYTES;
      auto load_raw = [&](int j, int rs) {
#pragma unroll
        for (int kvsel = 0; kvsel < 2; ++kvsel) {
          const uint32_t dst = sm.raw(rs) + kvsel * RAW_BYTES;
#pragma unroll
          for (int a = 0; a < BN / 32; ++a) {
            const int row = BN / 4 * w + 8 * a + (l & 7);
            bool ok;
            const uint8_t* src = row_src(j, row, kvsel, ok);
#pragma unroll
            for (int c2 = 0; c2 < D / 64; ++c2) {
              const int c8 = 4 * c2 + (l >> 3);  // 16-byte chunk of D / 16
              cp_async16(dst + row * RAW_ROW + ((c8 ^ (row & 7)) << 4),
                         src + c8 * 16, ok);
            }
          }
          if (BN >= 128 || tid < BN) {  // a key a thread
            const int pos = j * BN + tid;
            const bool ok = pos < len;
            const int p = ok ? pos : 0;
            const size_t elem =
                ((size_t)max(bt[p / page_size], 0) * page_size +
                 p % page_size) * kScaleLanes + kvsel * kScaleKVStride + hk;
            cp_async4(sm.rsc(rs) + (kvsel * BN + tid) * 4,
                      sc + (sc_f32 ? elem * 4 : (elem & ~(size_t)1) * 2), ok);
          }
        }
        cp_async_mbar_arrive(sm.raw_full(rs));
      };
      // the chunks this thread loaded -> a q-type stage; its key's scale
      auto convert = [&](int rs, int kvsel, uint32_t dst, int scf) {
        const uint32_t raw = sm.raw(rs) + kvsel * RAW_BYTES;
#pragma unroll
        for (int a = 0; a < BN / 32; ++a) {
          const int row = BN / 4 * w + 8 * a + (l & 7);
#pragma unroll
          for (int c2 = 0; c2 < D / 64; ++c2) {
            const int c8 = 4 * c2 + (l >> 3);
            const uint4 u =
                ld_shared_v4(raw + row * RAW_ROW + ((c8 ^ (row & 7)) << 4));
            // values 16 c8 .. +15: 16-bit chunks 2 c8, 2 c8 + 1 of the row
            const uint32_t half =
                dst + (c8 >> 2) * KV_CHUNK + row * ROW_BYTES;
            const int c = (2 * c8) & 7;
            const uint2 x0 = convert4<T, POOL>(u.x);
            const uint2 x1 = convert4<T, POOL>(u.y);
            st_shared_v4(half + ((c ^ (row & 7)) << 4),
                         make_uint4(x0.x, x0.y, x1.x, x1.y));
            const uint2 x2 = convert4<T, POOL>(u.z);
            const uint2 x3 = convert4<T, POOL>(u.w);
            st_shared_v4(half + (((c + 1) ^ (row & 7)) << 4),
                         make_uint4(x2.x, x2.y, x3.x, x3.y));
          }
        }
        if (BN >= 128 || tid < BN) {
          const uint8_t* word =
              gq + (sm.rsc(rs) - sm.q) + (kvsel * BN + tid) * 4;
          reinterpret_cast<float*>(gq + scf)[tid] =
              sc_f32 ? *reinterpret_cast<const float*>(word)
                     : __bfloat162float(
                           reinterpret_cast<const __nv_bfloat16*>(word)
                               [hk & 1]);
        }
        fence_proxy_async();  // the stores, before wgmma reads them
      };
      for (int i = 0; i < NRAW && i < n; ++i) load_raw(j_lo + i, i);
      for (int it = 0; it < n; ++it) {
        const int rs = it % NRAW;
        mbar_wait(sm.raw_full(rs), (it / NRAW) & 1);
        const int ks = it % L::NCK, vs = it % L::NCV;
        // round 0 of each empty barrier passes
        mbar_wait(sm.empty_k(ks), ((it / L::NCK) & 1) ^ 1);
        convert(rs, 0, sm.k(ks), L::sck(ks));
        mbar_arrive(sm.full_k(ks));
        mbar_wait(sm.empty_v(vs), ((it / L::NCV) & 1) ^ 1);
        convert(rs, 1, sm.v(vs), L::scv(vs));
        mbar_arrive(sm.full_v(vs));
        // refill the raw stage just converted: this thread alone reads the
        // chunks it loads, and every thread is past this phase's wait
        if (it + NRAW < n) load_raw(j_lo + it + NRAW, rs);
      }
    }
  } else {
    // ---- consumer warpgroup c: block rows 64c .. 64c + 63
    if constexpr (NWG == 2) setmaxnreg_inc<Tile<D>::CREGS>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int t = lane & 3;
    // the thread's rows "a" and "b" = a + 8 (the accumulator layout)
    const int ra = WG_ROWS * c + 16 * warp + (lane >> 2), rb = ra + 8;
    const int pa = q_lo + ra % bq, pb = q_lo + rb % bq;  // in the chunk
    // the keys a row sees, lo .. hi (hi = -1: a row at or past len)
    auto key_lo = [&](int qpos) { return window > 0 ? qpos - window : 0; };
    auto key_hi = [&](int qpos) {
      return qpos >= len ? -1 : (causal ? qpos : len - 1);
    };
    const int lo_a = key_lo(off + pa), hi_a = key_hi(off + pa);
    const int lo_b = key_lo(off + pb), hi_b = key_hi(off + pb);
    // the warpgroup's positions w_lo .. w_hi (one run of 64, or all bq of
    // its heads): tiles inside lo_max .. hi_min need no element mask
    const int w_lo = off + q_lo + (bq > WG_ROWS ? WG_ROWS * c : 0);
    const int w_hi = w_lo + min(bq, WG_ROWS) - 1;
    const int lo_max = key_lo(w_hi);
    const int hi_min = w_hi >= len ? -1 : key_hi(w_lo);
    const float sl2 = scale * kLog2e;

    // S: the thread's BN / 2 sums of a 64 x BN tile; O: its D / 2 of 64 x D
    float o[D / 2], s[BN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY;  // running max of raw scores
    float l_a = 0.f, l_b = 0.f;              // this thread's row-sum parts

    const uint32_t sqc = sm.q + c * WG_ROWS * ROW_BYTES;
    const uint64_t dq = wgmma_desc(sqc, 16, 8 * ROW_BYTES);
    mbar_wait(sm.full_q(), 0);

    for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it) {
      const int ks = it % L::NCK, vs = it % L::NCV;
      const uint64_t dk = wgmma_desc(sm.k(ks), 16, 8 * ROW_BYTES);
      const uint64_t dv = wgmma_desc(sm.v(vs), KV_CHUNK, 8 * ROW_BYTES);

      // S = Q K^T
      mbar_wait(sm.full_k(ks), (it / L::NCK) & 1);
      if constexpr (!QUANT) fence_proxy_async();  // cp.async -> wgmma
      fence_regs(s);
      wgmma_fence();
      if constexpr (BN == 128) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<T>::ss(s, dq + kstep(kk, ROWS), dk + kstep(kk, BN), kk > 0);
      } else {
        ss_product<T, D, ROWS, BN>(s, dq, dk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if constexpr (QUANT) {
        // K scales on the score columns, then the K stage is free
        const uint32_t ksc = sm.q + L::sck(ks) + 8 * t;
#pragma unroll
        for (int jb = 0; jb < BN / 8; ++jb) {
          const float2 f = ld_shared_f32x2(ksc + 32 * jb);
          s[4 * jb] *= f.x;
          s[4 * jb + 1] *= f.y;
          s[4 * jb + 2] *= f.x;
          s[4 * jb + 3] *= f.y;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.empty_k(ks));
      }

      // element mask only on tiles that straddle an edge for these rows
      const int kv0 = j * BN;
      if (kv0 < lo_max || kv0 + BN - 1 > hi_min) {
        // the row's key range, as columns of this thread's pairs
        const int ca = lo_a - kv0 - 2 * t, da = hi_a - kv0 - 2 * t;
        const int cb = lo_b - kv0 - 2 * t, db = hi_b - kv0 - 2 * t;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int col = 8 * (i / 4) + (i & 1);
          const bool ok = (i & 2) ? (col >= cb && col <= db)
                                  : (col >= ca && col <= da);
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

      mbar_wait(sm.full_v(vs), (it / L::NCV) & 1);
      if constexpr (!QUANT) {
        fence_proxy_async();
      } else {
        // V scales into p (l summed the unscaled p)
        const uint32_t vsc = sm.q + L::scv(vs) + 8 * t;
#pragma unroll
        for (int jb = 0; jb < BN / 8; ++jb) {
          const float2 f = ld_shared_f32x2(vsc + 32 * jb);
          s[4 * jb] *= f.x;
          s[4 * jb + 1] *= f.y;
          s[4 * jb + 2] *= f.x;
          s[4 * jb + 3] *= f.y;
        }
      }
      if constexpr (D == 128) {
        // P as A fragments, k-step kk from S's column blocks 2kk and
        // 2kk + 1, packed into s[4kk .. 4kk + 3] (already read): P takes
        // no registers of its own, which keeps the two-warpgroup consumer
        // within its registers
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          const uint32_t p0 = Elem<T>::pack(s[8 * kk], s[8 * kk + 1]);
          const uint32_t p1 = Elem<T>::pack(s[8 * kk + 2], s[8 * kk + 3]);
          const uint32_t p2 = Elem<T>::pack(s[8 * kk + 4], s[8 * kk + 5]);
          const uint32_t p3 = Elem<T>::pack(s[8 * kk + 6], s[8 * kk + 7]);
          s[4 * kk] = __uint_as_float(p0);
          s[4 * kk + 1] = __uint_as_float(p1);
          s[4 * kk + 2] = __uint_as_float(p2);
          s[4 * kk + 3] = __uint_as_float(p3);
        }

        // O += P V
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          const uint32_t a[4] = {
              __float_as_uint(s[4 * kk]), __float_as_uint(s[4 * kk + 1]),
              __float_as_uint(s[4 * kk + 2]), __float_as_uint(s[4 * kk + 3])};
          Wgmma<T>::rs(o, a, dv + ((16 * ROW_BYTES * kk) >> 4));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(s);
      } else {
        // one consumer warpgroup of up to 255 registers: P as A fragments
        // of its own (k-step kk from S's column blocks 2kk, 2kk + 1), then
        // O += P V over the D / 64 chunks of V (flash_fwd.cu's products)
        uint32_t p[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          p[kk][0] = Elem<T>::pack(s[8 * kk], s[8 * kk + 1]);
          p[kk][1] = Elem<T>::pack(s[8 * kk + 2], s[8 * kk + 3]);
          p[kk][2] = Elem<T>::pack(s[8 * kk + 4], s[8 * kk + 5]);
          p[kk][3] = Elem<T>::pack(s[8 * kk + 6], s[8 * kk + 7]);
        }
        fence_regs(o);
        wgmma_fence();
        rs_product<T, D, KV_CHUNK, BN / 16>(o, p, dv);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) fence_regs(p[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty_v(vs));  // this warp is done
    }

    // ---- epilogue: row sums over the row's 4 threads, normalise, store
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
    const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
    // the block's place and the thread's rows afresh (see Place)
    const Place pe = place<ROWS>(Hq, Hkv, hpb);
    const int tx = sreg(4);
    const int ce = tx / 128 - 1, r = 16 * ((tx / 32) & 3) + ((tx & 31) >> 2);
    const uint32_t so = sm.q + ce * WG_ROWS * ROW_BYTES;
    // O over this warpgroup's own Q rows, once all its warps are past
    // their last product; rows r and r + 8 share the swizzle (r % 8)
    named_sync(1 + ce, 128);
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      const uint32_t at = so + (jb / 8) * Q_CHUNK + r * ROW_BYTES +
                          (((jb % 8) ^ (r & 7)) << 4) + 4 * (tx & 3);
      st_shared_u32(at, Elem<T>::pack(o[4 * jb] * inv_a,
                                      o[4 * jb + 1] * inv_a));
      st_shared_u32(at + 8 * ROW_BYTES, Elem<T>::pack(o[4 * jb + 2] * inv_b,
                                                      o[4 * jb + 3] * inv_b));
    }
    fence_proxy_async();
    named_sync(1 + ce, 128);
    if ((tx & 127) == 0) {
      // one box per head run of the warpgroup's rows
      const int sb = min(pe.bq, WG_ROWS);
      for (int r0 = 0; r0 < WG_ROWS; r0 += sb) {
        const int br = WG_ROWS * ce + r0;
        const int pos = pe.q_lo + br % pe.bq;
        if (pos >= Sq) continue;
        const int plane = pe.b * Hq + pe.h0 + br / pe.bq;
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch)
          tma_store_3d(&to, so + ch * Q_CHUNK + r0 * ROW_BYTES, 64 * ch, pos,
                       plane);
      }
      tma_store_commit();
      tma_store_wait_read();
    }
    // natural-log LSE m * scale + ln l, or kMaskValue for a row that saw
    // nothing (its output is zeros)
    if (lse != nullptr && (tx & 3) == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int br = WG_ROWS * ce + r + 8 * half;
        const int pos = pe.q_lo + br % pe.bq;
        const float l = half ? l_b : l_a, m = half ? m_b : m_a;
        if (pos < Sq)
          lse[((size_t)pe.b * Hq + pe.h0 + br / pe.bq) * Sq + pos] =
              l > 0.f ? m * scale + logf(l) : kMaskValue;
      }
    }
  }
}

template <typename T, int POOL, int D>
int launch(const void* q, const void* kv, const void* sc, int sc_f32,
           const void* bt, const void* lens, const void* qoff, void* o,
           void* lse, int B, int Hq, int Hkv, int Sq, int page_size,
           int max_pages, float scale, int causal, int window,
           cudaStream_t stream) {
  using L = Smem<D, POOL != kPoolNative>;
  constexpr bool f16 = std::is_same<T, __half>::value;
  const int group = Hq / Hkv;
  int hpb = 8;  // q heads per block: the largest of 8, 4, 2, 1 dividing group
  while (group % hpb) hpb >>= 1;
  const int bq = L::ROWS / hpb;
  CUtensorMap tq, to;
  cudaError_t err;
  if ((err = encode_rows(&tq, q, f16, B * Hq, Sq, bq, D)) != cudaSuccess ||
      (err = encode_rows(&to, o, f16, B * Hq, Sq, bq < WG_ROWS ? bq : WG_ROWS,
                         D)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(paged_prefill_kernel<T, POOL, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + bq - 1) / bq, Hkv * (group / hpb), B);
  paged_prefill_kernel<T, POOL, D><<<grid, L::NTHREADS, L::BYTES, stream>>>(
      tq, to, static_cast<const uint8_t*>(kv),
      static_cast<const uint8_t*>(sc), sc_f32, static_cast<const int*>(bt),
      static_cast<const int*>(lens), static_cast<const int*>(qoff),
      static_cast<float*>(lse), Hq, Hkv, Sq, page_size, max_pages, hpb,
      scale, causal, window);
  return cudaGetLastError();
}

template <typename T, int D>
int by_pool(int pool, const void* q, const void* kv, const void* sc,
            int sc_f32, const void* bt, const void* lens, const void* qoff,
            void* o, void* lse, int B, int Hq, int Hkv, int Sq, int page_size,
            int max_pages, float scale, int causal, int window,
            cudaStream_t s) {
  switch (pool) {
    case kPoolNative:
      return launch<T, kPoolNative, D>(q, kv, sc, sc_f32, bt, lens, qoff, o,
                                       lse, B, Hq, Hkv, Sq, page_size,
                                       max_pages, scale, causal, window, s);
    case kPoolInt8:
      return launch<T, kPoolInt8, D>(q, kv, sc, sc_f32, bt, lens, qoff, o,
                                     lse, B, Hq, Hkv, Sq, page_size,
                                     max_pages, scale, causal, window, s);
    case kPoolE4M3:
      return launch<T, kPoolE4M3, D>(q, kv, sc, sc_f32, bt, lens, qoff, o,
                                     lse, B, Hq, Hkv, Sq, page_size,
                                     max_pages, scale, causal, window, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int by_dim(int D, int pool, const void* q, const void* kv, const void* sc,
           int sc_f32, const void* bt, const void* lens, const void* qoff,
           void* o, void* lse, int B, int Hq, int Hkv, int Sq, int page_size,
           int max_pages, float scale, int causal, int window,
           cudaStream_t s) {
  switch (D) {
    case 64:
      return by_pool<T, 64>(pool, q, kv, sc, sc_f32, bt, lens, qoff, o, lse,
                            B, Hq, Hkv, Sq, page_size, max_pages, scale,
                            causal, window, s);
    case 128:
      return by_pool<T, 128>(pool, q, kv, sc, sc_f32, bt, lens, qoff, o, lse,
                             B, Hq, Hkv, Sq, page_size, max_pages, scale,
                             causal, window, s);
    case 256:
      return by_pool<T, 256>(pool, q, kv, sc, sc_f32, bt, lens, qoff, o, lse,
                             B, Hq, Hkv, Sq, page_size, max_pages, scale,
                             causal, window, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o: [B, Hq, Sq, D], D = 64, 128 or 256; kv_pages [P, 2, Hkv, page,
// Dpad] with its packed scale tile (1-byte pools) or null.
extern "C" int aule_paged_prefill(const void* q, const void* kv_pages,
                                  const void* kv_scales,
                                  const void* block_tables,
                                  const void* context_lens,
                                  const void* q_offsets, void* o, void* lse,
                                  int B, int Hq, int Hkv, int Sq, int D,
                                  int page_size, int max_pages, float scale,
                                  int causal, int window, int dtype, int pool,
                                  int sc_f32, void* stream) {
  if (Sq <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == aule::kF16)
    return by_dim<__half>(D, pool, q, kv_pages, kv_scales, sc_f32,
                          block_tables, context_lens, q_offsets, o, lse, B,
                          Hq, Hkv, Sq, page_size, max_pages, scale, causal,
                          window, s);
  return by_dim<__nv_bfloat16>(D, pool, q, kv_pages, kv_scales, sc_f32,
                               block_tables, context_lens, q_offsets, o, lse,
                               B, Hq, Hkv, Sq, page_size, max_pages, scale,
                               causal, window, s);
}
