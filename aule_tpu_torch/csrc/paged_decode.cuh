// Paged decode for Hopper (sm_90a), hand-written CUDA C++, of bf16 / f16 q
// at head dim D = 64, 128 or 256 (the kernel's template parameter D; f32 q
// runs paged_generic.cu's FFMA decode), over either pool layout of the port
// (the kernel's template parameter L):
//   * FusedPool: kv_pages [P, 2, Hkv, page, Dpad] (axis 1: 0 = K, 1 = V; D
//     padded to 128 lanes, of which a D 64 row's 64 live lanes are read)
//     with the packed scale tile; replaces the TPU kernel
//     aule_tpu/ops/paged_fused.py::_fused_decode_kernel in every pool mode;
//   * SplitPools: head-major k_pages and v_pages [Hkv, P, page, D] with f32
//     scales [Hkv, P, page] each; replaces the TPU kernel
//     aule_tpu/ops/paged.py::_paged_decode_kernel (native, int8 and e4m3
//     pools; that kernel has no int8 dot-product mode).  The pools are read
//     where they lie: the JAX package's TPU route converts quantized split
//     pools to the fused layout on every call, which the port does not.
// One query token per sequence attends over its sequence's pages through
// block_tables [B, max_pages] (-1 clamps to the scratch page 0), over the
// first context_lens[b] tokens, optionally only the trailing `window` of
// them ((len - 1 - pos) < W).  A sequence with context 0 gives zeros and
// LSE -0.7 * f32max.  In both layouts one (head, page) slab [page, D] is
// contiguous, so the two differ only in where a token's rows and scales
// lie; the partition and the arithmetic depend on the shapes and the
// window only, so a split pool gives the bits of the same pool in the
// fused layout.
//
// Pool modes (common.cuh kPool*):
//   * native: the pool holds bf16 / f16, the q/out type;
//   * int8 and e4m3 with a packed scale tile sc [P, page, 128] (row = slot,
//     lane = kv * 64 + h; bf16 or f32), or split f32 scales: the payload
//     converts exactly to the q type (common.cuh convert4), the K scale
//     multiplies the score, the V scale multiplies p before the PV sum, and
//     l sums the unscaled p (paged_fused.py:349-447, paged.py:222-223,
//     250-251);
//   * int8 dot products (fused int8 pools, the JAX package's int8_matmul
//     default): q arrives quantized per row (int8 plus qf = q scale x
//     softmax scale, from the wrapper, as paged_fused.py:549-560); the
//     score is an int8 tensor-core product with exact int32 sums, times
//     qf * K scale; p * V scale is quantized per row to int8 codes over
//     SPAN = 4 consecutive tokens counted from the first visible token
//     t_lo (tokens t_lo + 4j .. t_lo + 4j + 3) and each code weighs its V
//     row by code x span max / 127, rounded to f16 for an f16 product over
//     the int8 V converted exactly (the plain version in
//     ops/paged_fused.py keeps that weight in f32: 2^-11 apart).  The JAX
//     kernel quantizes p over ppcb * page tokens instead; the plain version
//     mirrors this kernel's span.
//
// What bounds it on the H100: every live K and V byte is read once and
// used for a handful of operations, so it is memory bound.  At B8 ctx4096
// Hkv8 D128 the live KV is 134 MB per layer in bf16 (40 us at 3.35 TB/s),
// 67 MB of int8 or e4m3 payload plus 1.0 MB of the bf16 scales a token
// needs in the fused tile (20.4 us), or plus 2.1 MB of f32 split scales
// (20.7 us).  B8 x Hkv8 is only 64 (sequence, kv head) pairs for 132 SMs.
// GPT-2 small's decode (B8 ctx1024 Hkv12 D64) reads 25.2 MB of bf16 K/V
// (7.5 us), over 96 pairs.  What the design does about it:
//   * split-KV (flash-decoding): the live tokens [t_lo, len) of one
//     (sequence, kv head) are cut into `nsplit` ranges of `chunk` tokens,
//     chunk = ceil((len - t_lo) / nsplit) rounded up to SPAN, one block
//     each (grid (nsplit, Hkv, B)).  The wrapper picks nsplit from the
//     shapes and the SM count (ops/decode_split.py): as many blocks as fit
//     the card in one wave (a second, partial wave of short blocks cost
//     ~40 %), and it never reads context_lens; each block derives its
//     range on the device.  Ranges start at t_lo plus a multiple of SPAN,
//     so no int8 span straddles two.  A block whose range is empty loads
//     nothing;
//   * each block streams its range through a ring of NST stages in shared
//     memory, TS = 64 tokens of K and V a stage plus their scales, with
//     16-byte cp.async by all 128 threads (rows past the range
//     zero-filled; each stage's page ids read a stage ahead), 3 blocks to
//     an SM with rings of ~66 KB (2 or 4 stages at D 128, 4 or 8 of the
//     smaller rows at D 64), 1 block at D 256 (a 16-bit stage is 66 KB)
//     (one 1-D bulk copy a row, by the copy engine, was no faster;
//     PERF.md);
//   * each token's K and V scale is copied once per block with the stage
//     (4-byte cp.async; a bf16 tile's pair of lanes holding the head's
//     scale), not loaded by every lane;
//   * the products run on the tensor cores (mma.sync m16n8k16, or
//     m16n8k32 int8 for the int8 dot products' scores): each warp takes 16
//     tokens of a stage and the block's R q rows of the GQA group, padded
//     to the 16 rows of an mma; S = q K^T over a permuted head dim so that
//     each thread reads its D / 4 contiguous dims of a K row with 16-byte
//     shared-memory loads, then the online softmax in f32 on the score
//     fragments (exp2, the scale folded in), then O += P V with P from
//     registers and V's fragments paired from 16-byte reads of 4 rows.
//     The rows of a stage are XOR-swizzled in 16-byte chunks so that
//     neither read meets a bank conflict (Tile::swz_chunk, by row size).
//     1-byte rows convert to the q type (f16 for the int8 dot products'
//     PV) in registers with the exact bit tricks of paged_prefill.cu.  At
//     D 256 the K row is read in two halves and O keeps only the live mma
//     rows g (64 registers a thread, not 128).  The 4 warps' states merge
//     through shared memory;
//   * the splits merge in the same launch: each block writes its (m, l,
//     acc) to a workspace the wrapper allocates, and the last block of a
//     (sequence, kv head, row tile) to arrive (a counter that it resets to
//     0 for the next call) merges the partials in split order, so two runs
//     give the same bits and a call is one launch;
//   * any GQA group G = Hq / Hkv (the TPU kernels pad G to a multiple of
//     8, paged.py:376-383, paged_fused.py:541-544): a block takes R q rows
//     of its kv head's group, the mma rows g + 8 always zero.  G = 1, 2, 4
//     and 8 have an instantiation of their own (R = G, every row live).
//     Other groups take R = 8 with the group's rows cut into ceil(G / 8)
//     row tiles, each a grid row of its own, and the rows past G masked: a
//     group of at most 8 reads each K/V tile once per (sequence, kv head,
//     split), as the TPU kernel does, a larger one once per row tile
//     (ops/decode_split.py counts the row tiles among the blocks of a
//     wave).  A 16-row tile with the rows g + 8 live was no faster over
//     groups 12, 16 and 32 (scripts/torch_decode_tiles.py, PERF.md).

#pragma once

#include "common.cuh"

// The kernel and its launchers, in a namespace of their own so that each
// head dim's instantiations compile in a source of their own, in parallel
// (paged_decode.cu: D 128 and the entry points; paged_decode_d64.cu,
// paged_decode_d256.cu), each instantiating `by_pool` for its head dim.
namespace aule_decode {

using namespace aule;

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
// blocks resident per SM at head dim D: at D 64 and 128 the launch bounds
// hold every mode to the 168 registers a thread has at 3 blocks, and 3
// rings fit; at D 256 one ring of 132 KB fits, and the 255 registers of
// one block hold the O fragment (ops/decode_split.py tc_blocks_per_sm)
template <int D>
constexpr int min_blocks() {
  return D > 128 ? 1 : 3;
}
constexpr int TPW = 4;                // the int8 dot products' p span
constexpr int GT = 16;                // tokens a warp takes per step
constexpr int TS = NWARPS * GT;       // tokens per stage
constexpr int kMaxSplits = 64;        // ops/decode_split.py MAX_SPLITS

// A stage's geometry for a head dim and pool mode: TS rows of RB bytes
// (CPR 16-byte chunks) of K and of V, each thread copying PER_THREAD chunks
// of each, RSTEP rows apart.  Chunk c of row r sits at chunk swz_chunk(r,
// c) of its row, so the consumers' 16-byte reads (below) meet no bank
// conflict.
template <int D, int POOL>
struct Tile {
  static constexpr int ESZ = POOL == kPoolNative ? 2 : 1;
  // ring stages of about 66 KB in all (3 rings an SM) at D 64 and 128:
  // 16-bit rows 4 of 17 KB / 2 of 33 KB, 1-byte rows 8 of 9 KB / 4 of 17
  // KB; at D 256 one ring an SM, 2 of 66 KB / 4 of 33 KB
  static constexpr int NST =
      (ESZ == 2 ? 2 : 4) * (D == 64 ? 2 : 1);
  static constexpr int RB = D * ESZ;
  static constexpr int CPR = RB / 16;
  static constexpr int KV_BYTES = TS * RB;
  static constexpr int STAGE = 2 * KV_BYTES + 2 * TS * 4;
  static constexpr int RSTEP = NTHREADS / CPR;
  static constexpr int PER_THREAD = TS * CPR / NTHREADS;

  // In each quarter-warp a K read takes chunks (D ESZ / 64) t + j of rows
  // {2p, 2p + 1}, a V read chunk g + 8i of rows 2t (+ 1, + 8, + 9) (at D
  // 64 in 1-byte rows chunk g / 2 of the row, for two lanes at once): the
  // row's bit 0 and bits 1-2 and the chunk's bits 3-4 spread both over the
  // 8 chunk positions of 128 bytes.  1-byte rows at D 64 are 64 bytes, two
  // to 128: the row's bits 1-2 spread the 4 chunk positions of each.
  __device__ static __forceinline__ int swz_chunk(int r, int c) {
    if constexpr (RB == 64) return c ^ ((r >> 1) & 3);
    int x = c ^ (r & 1) ^ (((r >> 1) & 3) << 1);
    if (ESZ == 2 || D > 128) x ^= ((c >> 3) & (D > 128 ? 3 : 1)) << 1;
    return x;
  }
  __device__ static __forceinline__ int offset(int r, int c) {
    return r * RB + swz_chunk(r, c) * 16;
  }
};

__device__ __forceinline__ uint4 lds128(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// d (+)= a b, m16n8k32, int8 inputs, exact int32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a2,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// 4-byte global->shared async copy; zero-fills the slot where !pred.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0));
}

// Dynamic shared memory of one instantiation: the ring, which the warps'
// final states and the splits' merge reuse.
template <int D, int POOL>
constexpr int smem_bytes() {
  return Tile<D, POOL>::NST * Tile<D, POOL>::STAGE;
}

// O += P V where O keeps only the mma rows g (c0, c1): the rows g + 8 are
// zeros in and dropped out, so at D 256 the O fragment takes 64 registers,
// not 128.
template <typename T>
__device__ __forceinline__ void mma_rows_g(float (&d)[2], uint32_t a0,
                                           uint32_t a2, uint32_t b0,
                                           uint32_t b1) {
  float d4[4] = {d[0], d[1], 0.f, 0.f};
  Elem<T>::mma(d4, a0, 0u, a2, 0u, b0, b1);
  d[0] = d4[0];
  d[1] = d4[1];
}

template <typename T, int AC>
__device__ __forceinline__ void mma_acc(float (&d)[AC], uint32_t a0,
                                        uint32_t a2, uint32_t b0,
                                        uint32_t b1) {
  if constexpr (AC == 4)
    Elem<T>::mma(d, a0, 0u, a2, 0u, b0, b1);
  else
    mma_rows_g<T>(d, a0, a2, b0, b1);
}

// The pool layouts (the kernel's L).  Their names tell the two apart in a
// profiler's kernel list.
struct FusedPool {
  static constexpr bool kSplit = false;
};
struct SplitPools {
  static constexpr bool kSplit = true;
};

struct Args {
  const void* q;      // [B, Hq, D] (int8 codes in the int8-dot mode)
  const float* qf;    // [B, Hq] (int8-dot mode), else null
  const uint8_t* kv;  // the fused pool, or the split K pool
  const uint8_t* v;   // the split V pool (null for a fused pool)
  const void* sc;     // the packed tile, or the split K scales
  const float* vs;    // the split V scales (null for a fused pool)
  int sc_f32;
  const int* bt;
  const int* lens;
  void* out;
  float* lse;
  float* ws;          // nsplit > 1: [B, Hkv, nsplit, G, D + 2] f32
  int* counters;      // nsplit > 1: [B, Hkv, row tiles] int32, 0 between calls
  int B, Hkv, num_pages, page_size, max_pages;
  float scale;
  int window, nsplit;
  cudaStream_t stream;
  int group;          // G = Hq / Hkv (read by the PAD instantiations only)
};

// The row tiles of a group of G q rows, R rows each.
__host__ __device__ constexpr int row_tiles(int G, int R) {
  return (G + R - 1) / R;
}

// Grid (nsplit, Hkv x row tiles, B).  R: the q rows a block takes.  !PAD:
// R = G = Hq / Hkv, one tile.  PAD: G = a.group in ceil(G / R) tiles,
// blockIdx.y = hk * tiles + tile, the rows past G masked.
template <typename T, int D, int POOL, int R, bool PAD, typename L>
__global__ void __launch_bounds__(NTHREADS, min_blocks<D>())
    paged_decode_kernel(const Args a) {
  static_assert(R <= 8, "q rows of one mma, the rows g + 8 zero");
  using TL = Tile<D, POOL>;
  // the P V product's input type: the q type, or f16 for the int8 dot
  // products (their p codes times the span's scale, over int8 V)
  using PT = std::conditional_t<POOL == kPoolInt8Dot, __half, T>;
  constexpr int ESZ = TL::ESZ, RB = TL::RB, NST = TL::NST;
  constexpr bool QUANT = POOL != kPoolNative;
  constexpr bool DOT = POOL == kPoolInt8Dot;
  constexpr int VPOOL = DOT ? kPoolInt8 : POOL;  // how V converts
  // a pool row's bytes apart: a fused pool pads D to 128 lanes (D 64 rows
  // are read at their 64 live lanes); split pools are unpadded
  constexpr int GRB = (L::kSplit ? D : (D + 127) / 128 * 128) * ESZ;
  constexpr int QW = D / 32;  // 16-byte loads of a thread's 16-bit q dims
  constexpr int NJ = D / 8;   // O's n-tiles
  constexpr int AC = D > 128 ? 2 : 4;  // O's accumulators a n-tile
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_last;

  const int split = blockIdx.x, b = blockIdx.z;
  const int G = PAD ? a.group : R;
  const int tiles = PAD ? row_tiles(G, R) : 1;
  const int hk = PAD ? blockIdx.y / tiles : blockIdx.y;
  // the tile's first row g0 of the group and its nr live rows
  const int g0 = PAD ? (blockIdx.y - hk * tiles) * R : 0;
  const int nr = PAD ? min(R, G - g0) : R;
  const int Hkv = a.Hkv, Hq = Hkv * G, ps = a.page_size;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the thread's mma fragment row g (q row g0 + g of the group; rows at
  // or past nr, and rows g + 8, are zeros) and column pair 2t, 2t + 1
  const int g = lane >> 2, t = lane & 3;
  const bool row_ok = g < nr;
  const size_t row0 = (size_t)b * Hq + (size_t)hk * G + g0;

  // q row g as the A fragments of S = q K^T, over the head dim permuted
  // so that each thread reads its D / 4 dims [D t / 4, D (t + 1) / 4) of a
  // row in order: k-step kk holds dims D t / 4 + 4kk + {0, 1} and {2, 3}
  // (16-bit products, D / 16 k-steps) or D t / 4 + 8kk + {0..3} and
  // {4..7} (int8 products, D / 32 k-steps); K's B fragments are read in
  // the same order.  The int8 dot products' row factor qs = qf * log2(e).
  uint32_t qa[4 * QW];
  float qs = 0.f;
  {
    uint4 w[QW] = {};
    if (row_ok) {
      const uint8_t* qb = static_cast<const uint8_t*>(a.q) +
                          ((row0 + g) * D + D / 4 * t) * (DOT ? 1 : 2);
#pragma unroll
      for (int u = 0; u < (DOT ? QW / 2 : QW); ++u)
        w[u] = *reinterpret_cast<const uint4*>(qb + 16 * u);
      if constexpr (DOT) qs = a.qf[row0 + g] * kLog2e;
    }
#pragma unroll
    for (int u = 0; u < QW; ++u) {
      qa[4 * u] = w[u].x;
      qa[4 * u + 1] = w[u].y;
      qa[4 * u + 2] = w[u].z;
      qa[4 * u + 3] = w[u].w;
    }
  }
  const float sfac = DOT ? qs : a.scale * kLog2e;  // scores in log2 units

  // this block's range [s_lo, s_hi) of the live tokens [t_lo, len)
  const int len = max(0, min(a.lens[b], a.max_pages * ps));
  const int t_lo = a.window > 0 ? max(0, len - a.window) : 0;
  const int per = (len - t_lo + a.nsplit - 1) / a.nsplit;
  const int chunk = (per + TPW - 1) / TPW * TPW;
  const int s_lo = t_lo + split * chunk;
  const int s_hi = min(len, s_lo + chunk);
  const int ntiles = s_hi > s_lo ? (s_hi - s_lo + TS - 1) / TS : 0;
  const int* bt = a.bt + (size_t)b * a.max_pages;

  // Stage j: rows s_lo + j * TS + r.  Thread tid copies chunk tid % CPR of
  // rows tid / CPR + i * RSTEP of K and V, and (quantized pools) thread
  // tid < 2 * TS the K (tid < TS) or V scale of row tid % TS.  The page
  // ids of a stage are read one stage ahead (`fetch_pages`), so their
  // loads are in flight while the block computes; at D 256 in 16 bits a
  // thread copies 16 rows, and their ids are read as the stage is copied
  // (32 registers held across the loop spilled).
  const uint32_t ring = smem_u32(smem);
  const int crow = tid % TL::CPR, r0 = tid / TL::CPR;
  const int sr = tid % TS;  // the scale row this thread copies
  constexpr bool AHEAD = TL::PER_THREAD <= 8;
  constexpr int NPG = AHEAD ? TL::PER_THREAD : 1;
  int pg[NPG], slot[NPG], spg = 0;
  auto fetch_pages = [&](int j) {
    const int t0 = s_lo + j * TS;
    if constexpr (AHEAD) {
      int tok = t0 + r0, lp = tok / ps, sl = tok - lp * ps;
#pragma unroll
      for (int i = 0; i < TL::PER_THREAD; ++i) {
        pg[i] = tok < s_hi ? bt[lp] : 0;
        slot[i] = sl;
        tok += TL::RSTEP;
        sl += TL::RSTEP;
        while (sl >= ps) {
          sl -= ps;
          ++lp;
        }
      }
    }
    if (QUANT && tid < 2 * TS) spg = t0 + sr < s_hi ? bt[(t0 + sr) / ps] : 0;
  };
  auto load_stage = [&](int j) {
    const int t0 = s_lo + j * TS;
    const uint32_t st = ring + (j % NST) * TL::STAGE;
#pragma unroll
    for (int i = 0; i < TL::PER_THREAD; ++i) {
      const int r = r0 + i * TL::RSTEP, tok = t0 + r;
      const bool ok = tok < s_hi;
      const uint8_t* kp = a.kv;  // read nothing where !ok
      const uint8_t* vp = a.kv;
      if (ok) {
        int pid, sl;
        if constexpr (AHEAD) {
          pid = pg[i];
          sl = slot[i];
        } else {
          const int lp = tok / ps;
          pid = bt[lp];
          sl = tok - lp * ps;
        }
        const size_t page = max(pid, 0);
        if constexpr (L::kSplit) {
          const size_t off =
              (((size_t)hk * a.num_pages + page) * ps + sl) * GRB +
              crow * 16;
          kp = a.kv + off;
          vp = a.v + off;
        } else {
          kp = a.kv + ((page * 2 * Hkv + hk) * ps + sl) * GRB + crow * 16;
          vp = kp + (size_t)Hkv * ps * GRB;
        }
      }
      const uint32_t dst = st + TL::offset(r, crow);
      cp_async16(dst, kp, ok);
      cp_async16(dst + TL::KV_BYTES, vp, ok);
    }
    if constexpr (QUANT) {
      if (tid < 2 * TS) {
        const int kvsel = tid / TS, tok = t0 + sr;
        const bool ok = tok < s_hi;
        const void* src = a.sc;
        if (ok) {
          const size_t srow = (size_t)max(spg, 0) * ps + (tok - tok / ps * ps);
          if constexpr (L::kSplit) {
            src = (kvsel ? a.vs : static_cast<const float*>(a.sc)) +
                  (size_t)hk * a.num_pages * ps + srow;
          } else {
            const size_t si = srow * kScaleLanes + kvsel * kScaleKVStride;
            src = a.sc_f32
                      ? static_cast<const void*>(
                            static_cast<const float*>(a.sc) + si + hk)
                      : static_cast<const void*>(
                            static_cast<const __nv_bfloat16*>(a.sc) + si +
                            (hk & ~1));
          }
        }
        cp_async4(st + 2 * TL::KV_BYTES + (kvsel * TS + sr) * 4, src, ok);
      }
    }
  };
  // a staged scale word -> f32: a bf16 tile's word holds lanes hk & ~1
  // and hk | 1 (the head's in the high half when hk is odd)
  const bool sc16 = QUANT && !L::kSplit && !a.sc_f32;
  const int sc_shl = sc16 && !(hk & 1) ? 16 : 0;
  const uint32_t sc_mask = sc16 ? 0xFFFF0000u : 0xFFFFFFFFu;

  // the warp's state for row g: running max m (log2 units), this thread's
  // part of l, and O's fragments (c0, c1: row g; c2, c3 where kept: the
  // zero rows)
  float m = -INFINITY, l = 0.f;
  float acc[NJ][AC];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < AC; ++c) acc[j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < ntiles) {
      fetch_pages(s);
      load_stage(s);
    }
    cp_async_commit();
  }
  if (NST - 1 < ntiles) fetch_pages(NST - 1);
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // stage j landed; every thread is done with j - 1
    if (j + NST - 1 < ntiles) {
      load_stage(j + NST - 1);
      if (j + NST < ntiles) fetch_pages(j + NST);
    }
    cp_async_commit();
    // the warp's GT rows rb .. rb + 15 of the stage (warp-uniform test)
    const int rb = warp * GT;
    const int t0 = s_lo + j * TS;
    if (t0 + rb >= s_hi) continue;
    const uint8_t* st = smem + (j % NST) * TL::STAGE;
    const uint32_t* ssc =
        reinterpret_cast<const uint32_t*>(st + 2 * TL::KV_BYTES);

    // S = q K^T: n-tile nt holds rows rb + 8nt + 0..7 as its columns; the
    // thread reads row rb + 8nt + g (its B fragments: its D / 4 dims, KCH
    // chunks from chunk KCH t) and holds the scores of rows rb + 8nt + 2t +
    // {0, 1}
    constexpr int KCH = D * ESZ / 64;
    float sc[2][4] = {};
    if constexpr (DOT) {
      int si[2][4] = {};
      // two chunks (4 k-steps) of a row at a time
      constexpr int KU = KCH < 2 ? KCH : 2;
#pragma unroll
      for (int grp = 0; grp < KCH / KU; ++grp) {
        uint4 kq[2][KU];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int r = rb + 8 * nt + g;
#pragma unroll
          for (int u = 0; u < KU; ++u)
            kq[nt][u] = lds128(st + TL::offset(r, KCH * t + grp * KU + u));
        }
#pragma unroll
        for (int kk = 0; kk < 2 * KU; ++kk)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const uint4& k = kq[nt][kk / 2];
            const int qk = grp * 2 * KU + kk;
            mma_s8(si[nt], qa[2 * qk], qa[2 * qk + 1], kk & 1 ? k.z : k.x,
                   kk & 1 ? k.w : k.y);
          }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) sc[nt][e] = static_cast<float>(si[nt][e]);
    } else {
      // the thread's D / 8 q-type words of a K row, KR at a time (all of
      // them up to D 128, a quarter at D 256), each group 16-byte chunks
      // in order
      constexpr int KR = D > 128 ? 8 : D / 8 < 16 ? D / 8 : 16;
#pragma unroll
      for (int grp = 0; grp < D / 8 / KR; ++grp) {
        uint32_t kb[2][KR];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int r = rb + 8 * nt + g;
          if constexpr (ESZ == 2) {
#pragma unroll
            for (int u = 0; u < KR / 4; ++u) {
              const uint4 w =
                  lds128(st + TL::offset(r, KCH * t + grp * (KR / 4) + u));
              kb[nt][4 * u] = w.x;
              kb[nt][4 * u + 1] = w.y;
              kb[nt][4 * u + 2] = w.z;
              kb[nt][4 * u + 3] = w.w;
            }
          } else {
#pragma unroll
            for (int u = 0; u < KR / 8; ++u) {
              const uint4 w =
                  lds128(st + TL::offset(r, KCH * t + grp * (KR / 8) + u));
              const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                const uint2 c = convert4<T, POOL>(ws[v]);
                kb[nt][8 * u + 2 * v] = c.x;
                kb[nt][8 * u + 2 * v + 1] = c.y;
              }
            }
          }
        }
        // the two n-tiles' products alternate, two independent chains
#pragma unroll
        for (int kk = 0; kk < KR / 2; ++kk)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int qk = grp * (KR / 2) + kk;
            Elem<T>::mma(sc[nt], qa[2 * qk], 0u, qa[2 * qk + 1], 0u,
                         kb[nt][2 * kk], kb[nt][2 * kk + 1]);
          }
      }
    }

    // scores in log2 units (times the K scale), -inf past the range; the
    // online softmax of row g over its 4 threads
    float p[2][2], vs[2][2];
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = rb + 8 * nt + 2 * t + e;
        float f = sfac;
        if constexpr (QUANT) {
          f *= __uint_as_float((ssc[r] << sc_shl) & sc_mask);
          vs[nt][e] = __uint_as_float((ssc[TS + r] << sc_shl) & sc_mask);
        }
        p[nt][e] = t0 + r < s_hi ? sc[nt][e] * f : -INFINITY;
        mx = fmaxf(mx, p[nt][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = m_new == -INFINITY ? 1.f : exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[nt][e] = p[nt][e] == -INFINITY ? 0.f : exp2f(p[nt][e] - m_new);
        psum += p[nt][e];
      }
    l = l * alpha + psum;  // l sums the unscaled p
    m = m_new;

    // P (times the V scale) as the A fragment of O += P V: k = the group's
    // rows, 2t + {0, 1} from n-tile 0 and 8 + 2t + {0, 1} from n-tile 1
    uint32_t pa[2];
    if constexpr (DOT) {
      // p * V scale, quantized per row over each span of TPW rows (this
      // thread's pair and its neighbour's, t ^ 1), as the plain version:
      // floor(p * 127 / max + 0.5), each code times max / 127
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float p0 = p[nt][0] * vs[nt][0], p1 = p[nt][1] * vs[nt][1];
        float pm = fmaxf(p0, p1);
        pm = fmaxf(pm, __shfl_xor_sync(0xffffffffu, pm, 1));
        const float rr = pm > 0.f ? 127.f / pm : 0.f;
        const float deq = pm * (1.f / 127.f);
        const float w0 = floorf(__fadd_rn(__fmul_rn(p0, rr), 0.5f)) * deq;
        const float w1 = floorf(__fadd_rn(__fmul_rn(p1, rr), 0.5f)) * deq;
        pa[nt] = Elem<PT>::pack(w0, w1);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if constexpr (QUANT) {
          p[nt][0] *= vs[nt][0];
          p[nt][1] *= vs[nt][1];
        }
        pa[nt] = Elem<PT>::pack(p[nt][0], p[nt][1]);
      }
    }
#pragma unroll
    for (int jn = 0; jn < NJ; ++jn) {
      acc[jn][0] *= alpha;
      acc[jn][1] *= alpha;
    }

    // V's B fragments: the thread reads rows rb + 2t + {0, 1, 8, 9}, D / 8
    // values each (16-bit rows: chunks g + 8i, dims 64i + 8g .. + 7;
    // 1-byte rows: chunks g + 8i, dims 128i + 16g .. + 15, or at D 64 half
    // chunk g / 2, dims 8g .. 8g + 7), and pairs rows 2t, 2t + 1 (b0) and
    // 2t + 8, 2t + 9 (b1) value by value: n-tile jn's column g is the jn-th
    // of them
    const int vr[4] = {rb + 2 * t, rb + 2 * t + 1, rb + 2 * t + 8,
                       rb + 2 * t + 9};
    if constexpr (ESZ == 2) {
      // two chunks (16 n-tiles) at a time, one at D 64 and 256
      constexpr int VU = D == 128 ? 2 : 1;
#pragma unroll
      for (int grp = 0; grp < D / 64 / VU; ++grp) {
        uint32_t vw[4][4 * VU];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < VU; ++u) {
            const uint4 w = lds128(st + TL::KV_BYTES +
                                   TL::offset(vr[i], g + 8 * (grp * VU + u)));
            vw[i][4 * u] = w.x;
            vw[i][4 * u + 1] = w.y;
            vw[i][4 * u + 2] = w.z;
            vw[i][4 * u + 3] = w.w;
          }
#pragma unroll
        for (int jn = 0; jn < 8 * VU; ++jn) {
          const uint32_t sel = (jn & 1) ? 0x7632 : 0x5410;
          const uint32_t b0 = __byte_perm(vw[0][jn / 2], vw[1][jn / 2], sel);
          const uint32_t b1 = __byte_perm(vw[2][jn / 2], vw[3][jn / 2], sel);
          mma_acc<PT, AC>(acc[grp * 8 * VU + jn], pa[0], pa[1], b0, b1);
        }
      }
    } else {
      // one chunk (16 n-tiles) at a time; at D 64 the half chunk of lane g
      constexpr int W = D == 64 ? 2 : 4;  // 4-byte words a row a group
#pragma unroll
      for (int grp = 0; grp < (D == 64 ? 1 : D / 128); ++grp) {
        uint32_t vw[4][W];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (D == 64) {
            const uint4 w = lds128(st + TL::KV_BYTES + TL::offset(vr[i], g >> 1));
            vw[i][0] = g & 1 ? w.z : w.x;
            vw[i][1] = g & 1 ? w.w : w.y;
          } else {
            const uint4 w =
                lds128(st + TL::KV_BYTES + TL::offset(vr[i], g + 8 * grp));
            vw[i][0] = w.x; vw[i][1] = w.y; vw[i][2] = w.z; vw[i][3] = w.w;
          }
        }
#pragma unroll
        for (int i = 0; i < 2 * W; ++i) {
          const uint32_t sel = (i & 1) ? 0x7362 : 0x5140;
          const uint2 lo =
              convert4<PT, VPOOL>(__byte_perm(vw[0][i / 2], vw[1][i / 2], sel));
          const uint2 hi =
              convert4<PT, VPOOL>(__byte_perm(vw[2][i / 2], vw[3][i / 2], sel));
          mma_acc<PT, AC>(acc[grp * 16 + 2 * i], pa[0], pa[1], lo.x, hi.x);
          mma_acc<PT, AC>(acc[grp * 16 + 2 * i + 1], pa[0], pa[1], lo.y,
                          hi.y);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' states take it

  // merge the warps' states: row g's m is the same in its 4 threads, l is
  // summed over them; O column (jn, c) of n-tile jn is head dim
  // dim(2t + c, jn) (the V values' order above)
  float* s_acc = reinterpret_cast<float*>(smem);  // [NWARPS][R][D]
  float* s_m = s_acc + NWARPS * R * D;            // [NWARPS][R]
  float* s_l = s_m + NWARPS * R;                  // [NWARPS][R]
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (row_ok) {
    if (t == 0) {
      s_m[warp * R + g] = m;
      s_l[warp * R + g] = l;
    }
    float* o = s_acc + (warp * R + g) * D;
#pragma unroll
    for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 2 * t + c;
        const int dim = ESZ == 2 ? 64 * (jn / 8) + 8 * n + jn % 8
                        : D == 64 ? 8 * n + jn
                                  : 128 * (jn / 16) + 16 * n + jn % 16;
        o[dim] = acc[jn][c];
      }
  }
  __syncthreads();
  // nsplit > 1: this pair's partials, [nsplit][G][D] and [nsplit][G][2],
  // from the tile's first row g0 on
  const size_t pair = (size_t)b * Hkv + hk;
  float* ws_acc = nullptr;
  float* ws_ml = nullptr;
  if (a.nsplit > 1) {
    ws_acc = a.ws + pair * a.nsplit * G * D + (size_t)g0 * D;
    ws_ml = a.ws + (size_t)a.B * Hkv * a.nsplit * G * D +
            pair * a.nsplit * G * 2 + (size_t)g0 * 2;
  }
  for (int i = tid; i < nr * D; i += NTHREADS) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, s_m[w * R + g]);
    float Lsum = 0.f, O = 0.f;
    if (M != -INFINITY) {
      for (int w = 0; w < NWARPS; ++w) {
        const float mw = s_m[w * R + g];
        if (mw == -INFINITY) continue;
        const float c = exp2f(mw - M);
        Lsum += s_l[w * R + g] * c;
        O += s_acc[(w * R + g) * D + d] * c;
      }
    }
    if (a.nsplit == 1) {
      const size_t row = row0 + g;
      static_cast<T*>(a.out)[row * D + d] =
          Elem<T>::from_float(Lsum > 0.f ? O / Lsum : 0.f);
      if (a.lse != nullptr && d == 0)
        a.lse[row] = Lsum > 0.f ? (M + log2f(Lsum)) * kLn2 : kMaskValue;
    } else {
      ws_acc[((size_t)split * G + g) * D + d] = O;
      if (d == 0) {
        ws_ml[((size_t)split * G + g) * 2] = M;
        ws_ml[((size_t)split * G + g) * 2 + 1] = Lsum;
      }
    }
  }
  if (a.nsplit == 1) return;

  // the last block of this (sequence, kv head, row tile) to arrive merges
  // the partials in split order and resets the counter for the next call
  __threadfence();
  __syncthreads();
  const size_t cpair = PAD ? (size_t)b * Hkv * tiles + blockIdx.y : pair;
  if (tid == 0) {
    const int prev = atomicAdd(a.counters + cpair, 1);
    s_last = prev == a.nsplit - 1;
    if (s_last) atomicExch(a.counters + cpair, 0);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // every split's (m, l) into shared memory at once, then per q row the
  // max and each split's weight c = 2^(m - max) (0 for an empty split)
  // and l's sum in split order, then each output column's sum of c * acc
  // in split order (independent loads, unrolled)
  const int ns = a.nsplit;
  float* s_pm = reinterpret_cast<float*>(smem);  // [nsplit][R] m, then c
  float* s_pl = s_pm + ns * R;                   // [nsplit][R]
  float* s_M = s_pl + ns * R;                    // [R]
  float* s_L = s_M + R;                          // [R]
  if constexpr (PAD) {
    // the tile's rows of each split (the rows past nr: no token)
    for (int i = tid; i < ns * R; i += NTHREADS) {
      const int sp = i / R, gg = i % R;
      const bool live = gg < nr;
      s_pm[i] = live ? __ldcg(ws_ml + ((size_t)sp * G + gg) * 2) : -INFINITY;
      s_pl[i] = live ? __ldcg(ws_ml + ((size_t)sp * G + gg) * 2 + 1) : 0.f;
    }
  } else {
    for (int i = tid; i < ns * G; i += NTHREADS) {
      s_pm[i] = __ldcg(ws_ml + 2 * i);
      s_pl[i] = __ldcg(ws_ml + 2 * i + 1);
    }
  }
  __syncthreads();
  if (tid < R) {
    float M = -INFINITY;
    for (int sp = 0; sp < ns; ++sp) M = fmaxf(M, s_pm[sp * R + tid]);
    float Lsum = 0.f;
    for (int sp = 0; sp < ns; ++sp) {
      const float ms = s_pm[sp * R + tid];
      const float c = ms == -INFINITY ? 0.f : exp2f(ms - M);
      s_pm[sp * R + tid] = c;
      Lsum += s_pl[sp * R + tid] * c;
    }
    s_M[tid] = M;
    s_L[tid] = Lsum;
  }
  __syncthreads();
  for (int i = tid; i < nr * D; i += NTHREADS) {
    const int g = i / D, d = i % D;
    const float Lsum = s_L[g];
    float O = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < ns; ++sp)
      O = fmaf(__ldcg(ws_acc + ((size_t)sp * G + g) * D + d),
               s_pm[sp * R + g], O);
    const size_t row = row0 + g;
    static_cast<T*>(a.out)[row * D + d] =
        Elem<T>::from_float(Lsum > 0.f ? O / Lsum : 0.f);
    if (a.lse != nullptr && d == 0)
      a.lse[row] = Lsum > 0.f ? (s_M[g] + log2f(Lsum)) * kLn2 : kMaskValue;
  }
}

template <typename T, int D, int POOL, int R, bool PAD, typename L>
int launch(const Args& a) {
  constexpr int smem = smem_bytes<D, POOL>();
  static_assert(NWARPS * R * (D + 2) * 4 <= smem,
                "the warps' states fit in the ring");
  static_assert((kMaxSplits * 2 + 2) * R * 4 <= smem,
                "the merge of up to 64 splits fits in the ring");
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, D, POOL, R, PAD, L>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.nsplit, a.Hkv * (PAD ? row_tiles(a.group, R) : 1), a.B);
  paged_decode_kernel<T, D, POOL, R, PAD, L>
      <<<grid, NTHREADS, smem, a.stream>>>(a);
  return cudaGetLastError();
}

// The block's q rows R come from the wrapper (ops/decode_split.py
// tc_tile_rows, which also sizes the merge counters by the tiles of R
// rows): R = G = 1, 2, 4 or 8 has an instantiation of its own; any group
// runs in row tiles of R = 8 with the rows past G masked; any other R is
// refused.
template <typename T, int D, int POOL, typename L>
int by_group(int group, int rows, const Args& a) {
  if (group < 1) return cudaErrorInvalidValue;
  if (rows == group) {
    switch (group) {
      case 1: return launch<T, D, POOL, 1, false, L>(a);
      case 2: return launch<T, D, POOL, 2, false, L>(a);
      case 4: return launch<T, D, POOL, 4, false, L>(a);
      case 8: return launch<T, D, POOL, 8, false, L>(a);
    }
  }
  if (rows == 8) return launch<T, D, POOL, 8, true, L>(a);
  return cudaErrorInvalidValue;
}

// The split pools have no int8 dot-product mode (nor has the TPU kernel
// they replace).
template <typename T, int D, typename L>
int by_pool(int pool, int group, int rows, const Args& a) {
  switch (pool) {
    case kPoolNative: return by_group<T, D, kPoolNative, L>(group, rows, a);
    case kPoolInt8: return by_group<T, D, kPoolInt8, L>(group, rows, a);
    case kPoolE4M3: return by_group<T, D, kPoolE4M3, L>(group, rows, a);
    case kPoolInt8Dot:
      if constexpr (!L::kSplit)
        return by_group<T, D, kPoolInt8Dot, L>(group, rows, a);
      break;
  }
  return cudaErrorInvalidValue;
}

// by_pool's instantiations, one source each head dim and q type
// (AULE_DECODE_TYPE): the build runs one nvcc a source, all together, so
// it lasts as long as its largest source
#define AULE_DECODE_BY_POOL(D, T, L)                                     \
  template int by_pool<T, D, L>(int pool, int group, int rows, const Args& a)
#define AULE_DECODE_TYPE(KW, D, T)                            \
  KW AULE_DECODE_BY_POOL(D, T, FusedPool);                    \
  KW AULE_DECODE_BY_POOL(D, T, SplitPools)

}  // namespace aule_decode
