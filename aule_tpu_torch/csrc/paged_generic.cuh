// Paged decode for f32 q at D = 64, 128 or 256 (sm_90a), over either pool
// layout (the kernel's L), in every pool mode of the port.  Hand-written
// CUDA C++, the products on FFMA (the int8 dot products' scores on
// __dp4a).  16-bit q runs paged_decode.cuh's tensor-core decode at every
// head dim; the f32 prefill is paged_prefill_f32.cu's.  paged_generic.cu
// holds the entry point and the D = 128 instantiations,
// paged_generic_d64.cu and paged_generic_d256.cu the other head dims, so
// that they compile in parallel.
//
// Replaces, for f32 q, the TPU kernels aule_tpu/ops/paged_fused.py::
// _fused_decode_kernel (fused pools [P, 2, Hkv, page, Dpad], D padded to 128
// lanes: paged_fused.py:56-66, 494-498; f32 with Precision.HIGHEST,
// l.334-336) and aule_tpu/ops/paged.py::_paged_decode_kernel (split pools
// [Hkv, P, page, D]; f32 at l.208; any D through the lane padding of
// l.366-372).  Semantics as paged_decode.cuh's note: one query token per
// sequence over the first context_lens[b] tokens (the trailing `window` of
// them with a window), -1 table entries clamp to page 0, context 0 gives
// zeros and LSE -0.7 * f32max.
//
// Pool modes (common.cuh kPool*):
//   * native: the pool holds f32;
//   * int8 and e4m3 with scales (the fused packed tile, bf16 or f32, or
//     split f32 scales): each value is its payload times its token's scale
//     in f32, one product, as the plain versions dequantize;
//   * int8 dot products (fused int8 pools, the engine's default): q
//     arrives as per-row int8 codes with qf = q scale x softmax scale (the
//     wrapper quantizes it, as paged_fused.py:525-560); the score is an
//     exact int32 __dp4a sum times qf and the K scale; p times the V scale
//     is quantized per row over spans of SPAN = 4 tokens counted from the
//     first visible token (paged_decode.cuh's span, so the plain version
//     ops/paged_fused.py::_int8_dot_plain holds both), each code weighing
//     the raw V row by the span's max / 127.
//
// What bounds it on the H100: decode reads every live K and V byte once
// for a handful of operations, so it is memory bound.  GPT-2 small at B8
// ctx1024 (12 kv heads, D64) holds 50.3 MB of live f32 K/V a layer (15.0 us
// at 3.35 TB/s) and 12.6 MB of 1-byte payload plus the scales (3.9 us).
// Such a call is short: 96 (sequence, kv head) pairs in 4 splits give each
// block 256 tokens, so what a block waits on in turn (its length, its page
// ids, its rows, the merge) sets its time as much as the bytes do.  The
// design:
//   * split-KV over the card with paged_decode.cuh's partition
//     (ops/decode_split.py: nsplit blocks per (sequence, kv head, row
//     tile) from the shapes, the SM count and `generic_blocks_per_sm`
//     only, each block's range derived on the device, ranges starting on
//     SPAN boundaries); the last block of a (sequence, kv head, row tile)
//     merges the splits in split order in the same launch, through a
//     counter it resets, so two runs give the same bits;
//   * warps own their tiles: the block's range is cut into tiles of TN
//     tokens (a multiple of SPAN, so no span of the int8 dot products
//     straddles two warps), warp w takes tiles w, w + NW, ... and runs its
//     own online softmax over them, with no block barrier in the loop; at
//     the end the warps' (m, l, O) merge in warp order through shared
//     memory (paged_prefill_f32.cu's pattern);
//   * page ids off the copies' path: a block copies the first PGC = 512
//     entries of its sequence's table into shared memory with its q rows,
//     while it reads its length (one round trip for a whole range of up
//     to 8,192 tokens at 16-token pages); the ids of pages past those come
//     a ring ahead (below);
//   * each warp streams its tiles through a ring of S stages of its own in
//     shared memory: 16-byte cp.async of the D live lanes of each K and V
//     row (rows past the range zero-filled), each token's K and V scale
//     copied with its stage (4-byte cp.async, not loaded by every lane),
//     and any page ids past the first PGC that the tile S stages on needs
//     copied with the stage too, so that no table read stands between a
//     tile and its copies.  A warp waits only on its own copies
//     (cp.async.wait_group).  S is what the block's share of the SM's
//     shared memory allows (Plan::S): at GPT-2's shape a 1-byte block's
//     whole range is in flight at once;
//   * 1-byte payloads are converted where the score or P V reads a row,
//     in registers, not in a pass through shared memory;
//   * scores: each token of a tile has 32 / TN lanes, each taking 32
//     values of the head dim for every q row (a K value is read and
//     converted once), their partial sums added and scattered among them
//     by shuffles, so that each lane runs the softmax of its own rows of
//     the group (scatter_sum); P V: each
//     lane holds 4 output columns (8 at D 256) of every q row and sums its
//     share of the tile's tokens, the weights read from a warp-private row
//     of shared memory;
//   * any GQA group G (the TPU kernels pad it to a multiple of 8): a block
//     takes R q rows of its kv head's group, R = G padded to a power of
//     two up to 8 (an instantiation each), rows past G are zeros whose
//     results are dropped.  A group over 8 is cut into ceil(G / 8) row
//     tiles of R = 8, each a grid row of its own (each reads its
//     (sequence, kv head)'s K/V; ops/decode_split.py counts the tiles
//     among the blocks of a wave).

#pragma once

#include "generic.cuh"
#include "paged_pool.cuh"

namespace aule_generic {

using namespace aule;

constexpr int kMaxGroup = 8;    // q rows a decode block takes at most
constexpr int kMaxSplits = 64;  // ops/decode_split.py MAX_SPLITS
constexpr int SPAN = 4;         // ops/decode_split.py DECODE_SPAN
constexpr int PGC = 512;        // table entries a block reads with its q
constexpr unsigned kFull = 0xffffffffu;

// The kernel's arguments, as the entry point hands them to each head dim's
// source (built-in members only: the sources share the type).
struct DecodeArgs {
  const void* q;      // [B, Hq, D] (int8 codes in the int8-dot mode)
  const float* qf;    // [B, Hq] q scale x softmax scale (int8-dot mode)
  const uint8_t* kv;  // the fused pool, or the split K pool
  const uint8_t* v;   // the split V pool (null for a fused pool)
  const void* sc;     // the packed tile, or the split K scales (quantized)
  const float* vs;    // the split V scales (null for a fused pool)
  int sc_f32, Hkv, num_pages, page_size;
  const int* bt;      // [B, max_pages]
  const int* lens;    // [B]
  void* out;          // [B, Hq, D] f32
  float* lse;         // [B, Hq] or null
  float* ws;          // nsplit > 1: [B, Hkv, nsplit, G] x (D + 2) f32
  int* counters;      // nsplit > 1: [B, Hkv, row tiles] int32, 0 between calls
  int B, G, max_pages;
  int R, tiles;       // q rows a block takes (G up to a power of two, <= 8)
                      // and the row tiles of a group, ceil(G / R)
  float scale;
  int window, nsplit;
  cudaStream_t stream;
};

// Blocks an SM, warps a block and tokens a warp's tile at head dim D
// (ops/decode_split.py generic_blocks_per_sm plans the wave by them;
// tests/test_torch_paged_generic_decode.py models the partition).  At D 64
// and 128 three blocks of 4 warps share an SM; at D 256 one block of 8
// warps takes one, its tiles SPAN tokens, so that its rows of 1 KB f32
// still leave 3 stages a warp.
template <int D>
struct Geo {
  static constexpr int BPS = D > 128 ? 1 : 3;
  static constexpr int NW = D > 128 ? 8 : 4;
  static constexpr int TN = D == 64 ? 16 : D == 128 ? 8 : 4;
  static constexpr int NTH = NW * 32;
};

// The shared memory and lane plan of one instantiation.  A warp's stage:
// TN K rows, TN V rows (RB bytes apart: f32 rows of D + PADW floats,
// 1-byte rows of D + 4 PADW bytes, so that the rows and chunks a
// quarter-warp reads meet no bank conflict), TN K and TN V scale words
// (quantized pools) and the TN page ids of the tile S stages on.  Then per
// warp the tile's weights [TN][R] and rescales [R]; before them the
// block's q rows (QLD bytes apart) and the first PGC entries of its
// sequence's table.  S: as many stages as the block's share of the SM
// holds, at most 8.
template <int D, int POOL, int R>
struct Plan {
  using Gm = Geo<D>;
  static constexpr int NW = Gm::NW, TN = Gm::TN, NTH = Gm::NTH;
  static constexpr bool QUANT = POOL != kPoolNative;
  static constexpr bool DOT = POOL == kPoolInt8Dot;
  static constexpr int ESZ = QUANT ? 1 : 4;
  // a quarter-warp's 8 lanes read 8 rows (TN >= 8), or at D 256 4 rows
  // of 2 neighbouring chunks each
  static constexpr int PADW = TN >= 8 ? 4 : 8;
  static constexpr int RB = QUANT ? D + 4 * PADW : 4 * (D + PADW);
  static constexpr int CPR = D * ESZ / 16;  // 16-byte chunks a live row
  static constexpr int UD = 16 / ESZ;       // values a 16-byte chunk
  static constexpr int NU = D / UD;         // chunks a row
  static constexpr int VOFF = TN * RB, SOFF = 2 * TN * RB;
  static constexpr int POFF = SOFF + (QUANT ? 8 * TN : 0);
  static constexpr int STG = (POFF + 4 * TN + 15) / 16 * 16;
  static constexpr int WB = (4 * (TN * R + R) + 15) / 16 * 16;
  static constexpr int QLD = DOT ? D + 16 : 4 * (D + 4);
  static constexpr int QB = (R * QLD + 15) / 16 * 16;
  static constexpr int HEAD = QB + 4 * PGC;  // q rows, table entries
  // an SM's 228 KB, less 1 KB the card keeps a block and the static
  // shared memory
  static constexpr int BUDGET = 233472 / Gm::BPS - 1088;
  static constexpr int S_FIT = (BUDGET - HEAD - NW * WB) / (NW * STG);
  static constexpr int S = S_FIT > 8 ? 8 : S_FIT;
  static constexpr int RING = NW * S * STG;
  static constexpr int SMEM = HEAD + NW * WB + RING;
  // score lanes: lane = t + TN u, token t of the tile and head-dim part u
  // (chunks u, u + LPT, ...: 32 values of the row, for every q row); after
  // the sums are scattered (scatter_sum) each lane holds RPL rows
  static constexpr int LPT = 32 / TN;
  static constexpr int RPL = R > LPT ? R / LPT : 1;
  static constexpr int SPLIT = R < LPT ? R : LPT;  // lanes with other rows
  // P V lanes: lane = cg + CG tp (column group cg of 4 columns, every
  // TP-th token from tp), or at D 256 column groups lane and lane + 32
  static constexpr int CG = D / 4;
  static constexpr int TP = CG < 32 ? 32 / CG : 1;
  static constexpr int NCG = CG > 32 ? CG / 32 : 1;
  static_assert(S >= 2, "two stages a warp at least");
  static_assert(TN % SPAN == 0 && NU % LPT == 0 && TN * CPR % 32 == 0,
                "whole spans, chunks and copies");
  static_assert(4 * NW * R * (D + 2) <= RING,
                "the warps' states fit in the ring");
  static_assert(4 * (2 * kMaxSplits + 2) * kMaxGroup <= RING,
                "the merge of up to 64 splits fits in the ring");
};

// 4-byte global->shared async copy; zero-fills the slot where !pred.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0));
}

// Where the K (kvsel 0) or V scale of a token lies: a split pool's f32, a
// fused tile's f32 lane hk, or the 4-byte word of a bf16 tile that holds
// lanes hk & ~1 and hk | 1.
template <typename L>
__device__ __forceinline__ const void* scale_at(const Pool& p, size_t page,
                                                int slot, int hk,
                                                int kvsel) {
  if constexpr (L::kSplit) {
    const float* s = kvsel ? p.vs : static_cast<const float*>(p.sc);
    return s + ((size_t)hk * p.num_pages + page) * p.page_size + slot;
  } else {
    const size_t i =
        (page * p.page_size + slot) * kScaleLanes + kvsel * kScaleKVStride;
    if (p.sc_f32) return static_cast<const float*>(p.sc) + i + hk;
    return static_cast<const __nv_bfloat16*>(p.sc) + i + (hk & ~1);
  }
}

// Reduce-scatter of the N partial sums (rows 0 .. N - 1) of a token's
// lanes, whose head-dim part u is bit O and up of the lane (lane = t + TN
// u): at each bit the lane keeps half of its rows (the upper half where
// the bit is set) and adds its partner's sums of them, until one row is
// left, which the remaining bits sum whole.  Lane u then holds x[0 ..
// max(1, N / LPT)) for rows scatter_row0(u) on, each sum in one order (a +
// b in one lane is b + a in its partner: the same bits).
template <int N, int O, int LPT, int TN, typename V>
__device__ __forceinline__ void scatter_sum(V* x, int u) {
  if constexpr (O < LPT) {
    if constexpr (N > 1) {
      const bool hi = (u & O) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const V send = hi ? x[i] : x[i + N / 2];
        const V keep = hi ? x[i + N / 2] : x[i];
        x[i] = keep + __shfl_xor_sync(0xffffffffu, send, TN * O);
      }
      scatter_sum<N / 2, O * 2, LPT, TN>(x, u);
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], TN * O);
      scatter_sum<1, O * 2, LPT, TN>(x, u);
    }
  }
}

// The first of the rows that scatter_sum leaves lane part u.
template <int N, int LPT>
__device__ __forceinline__ int scatter_row0(int u) {
  int g0 = 0, n = N;
#pragma unroll
  for (int o = 1; o < LPT; o <<= 1) {
    if (n > 1) {
      if (u & o) g0 += n / 2;
      n /= 2;
    }
  }
  return g0;
}

// The row tiles of a group of G q rows, R rows each.
__host__ __device__ constexpr int row_tiles(int G, int R) {
  return (G + R - 1) / R;
}

// A decode block's row tile: kv head hk, the group's rows g0 .. g0 + nr -
// 1 of `tiles`.  blockIdx.y is read with asm volatile, so the epilogue
// derives the tile afresh and nothing of it holds registers across the
// main loop (as paged_prefill.cu's Place).
struct RowTile {
  int hk, tile, g0, nr, tiles;
};

__device__ __forceinline__ RowTile row_tile(const DecodeArgs& a) {
  uint32_t y;
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(y));
  RowTile t;
  t.tiles = a.tiles;
  t.hk = t.tiles == 1 ? y : y / t.tiles;  // a group up to 8: no division
  t.tile = y - t.hk * t.tiles;
  t.g0 = t.tile * a.R;
  t.nr = min(a.R, a.G - t.g0);
  return t;
}

// Grid (nsplit, Hkv x row tiles, B), blockIdx.y = hk * tiles + tile; G =
// Hq / Hkv, any whole number; R the q rows a block takes.
template <int POOL, int D, int R, typename L>
__global__ void __launch_bounds__(Geo<D>::NTH, Geo<D>::BPS)
    paged_generic_decode_kernel(const DecodeArgs a) {
  using P = Plan<D, POOL, R>;
  using RW = Row<float, POOL, D, L>;
  constexpr int NW = P::NW, TN = P::TN, NTH = P::NTH, S = P::S, RB = P::RB;
  constexpr int LPT = P::LPT, RPL = P::RPL;
  constexpr int CG = P::CG, TP = P::TP, NCG = P::NCG;
  constexpr bool QUANT = P::QUANT, DOT = P::DOT;
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  __shared__ int s_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, b = blockIdx.z;
  const int ps = a.page_size;
  const Pool pool{a.kv, a.v, a.sc, a.vs, a.sc_f32, a.Hkv, a.num_pages, ps};
  const RowTile rt0 = row_tile(a);
  const int hk = rt0.hk;
  uint8_t* sQ = smem;
  int* sTab = reinterpret_cast<int*>(smem + P::QB);
  float* sW = reinterpret_cast<float*>(smem + P::HEAD + warp * P::WB);
  float* sA = sW + TN * R;  // this tile's rescale of each row
  uint8_t* rings = smem + P::HEAD + NW * P::WB;
  uint8_t* ring = rings + warp * S * P::STG;
  const int* bt = a.bt + (size_t)b * a.max_pages;

  // the tile's q rows, zeros past nr, and the first PGC entries of the
  // sequence's table, in flight while the block reads its length
  {
    constexpr int QE = DOT ? 1 : 4, QC = D * QE / 16;
    const uint8_t* qb =
        static_cast<const uint8_t*>(a.q) +
        (((size_t)b * a.Hkv + hk) * a.G + rt0.g0) * D * QE;
    for (int i = tid; i < R * QC; i += NTH) {
      const int g = i / QC, c = i % QC;
      const bool ok = g < rt0.nr;
      cp_async16(smem_u32(sQ + g * P::QLD + 16 * c),
                 qb + (ok ? (size_t)g * D * QE + 16 * c : 0), ok);
    }
    for (int i = tid; i < min(a.max_pages, PGC); i += NTH)
      cp_async4(smem_u32(sTab + i), bt + i, true);
    cp_async_commit();
  }

  // this block's range [s_lo, s_hi) of the live tokens [t_lo, len)
  // (ops/decode_split.py split_bounds), cut into tiles of TN tokens, warp
  // w taking tiles w, w + NW, ...: nmine of them
  const int len = max(0, min(a.lens[b], a.max_pages * ps));
  const int t_lo = a.window > 0 ? max(0, len - a.window) : 0;
  const int per = (len - t_lo + a.nsplit - 1) / a.nsplit;
  const int chunk = (per + SPAN - 1) / SPAN * SPAN;
  const int s_lo = t_lo + split * chunk;
  const int s_hi = min(len, s_lo + chunk);
  const int ntiles = s_hi > s_lo ? (s_hi - s_lo + TN - 1) / TN : 0;
  const int nmine = ntiles > warp ? (ntiles - 1 - warp) / NW + 1 : 0;
  auto tile_t0 = [&](int i) { return s_lo + (warp + i * NW) * TN; };

  // the page ids of the warp's i-th tile past the block's first PGC table
  // entries into stage i % S (lane < TN: its token's)
  auto fetch_ids = [&](int i) {
    if (i >= nmine || lane >= TN) return;
    const int tok = tile_t0(i) + lane, lp = tok / ps;
    if (tok < s_hi && lp >= PGC)
      cp_async4(smem_u32(ring + (i % S) * P::STG + P::POFF + 4 * lane),
                bt + lp, true);
  };
  // the K and V rows and scales of the warp's i-th tile into stage i % S,
  // from the page ids (lane < TN finds its token's rows, the warp's chunks
  // take them by shuffle; zeros past the range)
  auto load_tile = [&](int i) {
    if (i >= nmine) return;
    uint8_t* st = ring + (i % S) * P::STG;
    const int tok = tile_t0(i) + lane;
    long long rk = -1, rv = -1;
    if (lane < TN) {
      const bool ok = tok < s_hi;
      const int lp = tok / ps, slot = tok - lp * ps;
      const int id = !ok ? 0
                     : lp < PGC ? sTab[lp]
                                : reinterpret_cast<const int*>(st + P::POFF)[lane];
      const size_t page = (size_t)max(id, 0);
      if (ok) {
        rk = (long long)(row_index<L>(pool, page, slot, hk, 0) * RW::BYTES);
        rv = (long long)(row_index<L>(pool, page, slot, hk, 1) * RW::BYTES);
      }
      if constexpr (QUANT) {
        const uint32_t sd = smem_u32(st + P::SOFF + 4 * lane);
        cp_async4(sd, ok ? scale_at<L>(pool, page, slot, hk, 0) : a.sc, ok);
        cp_async4(sd + 4 * TN,
                  ok ? scale_at<L>(pool, page, slot, hk, 1) : a.sc, ok);
      }
    }
    const uint8_t* vbase = L::kSplit ? pool.v : pool.kv;
    constexpr int CPR = P::CPR;
#pragma unroll
    for (int k = 0; k < TN * CPR / 32; ++k) {
      const int c = (lane + 32 * k) % CPR, r = (lane + 32 * k) / CPR;
      const long long ak = __shfl_sync(kFull, rk, r);
      const long long av = __shfl_sync(kFull, rv, r);
      const uint32_t d = smem_u32(st + r * RB + 16 * c);
      cp_async16(d, pool.kv + (ak < 0 ? 0 : ak + 16 * c), ak >= 0);
      cp_async16(d + P::VOFF, vbase + (av < 0 ? 0 : av + 16 * c), av >= 0);
    }
  };

  // a staged scale word -> f32: a bf16 tile's word holds lanes hk & ~1
  // and hk | 1 (the head's in the high half when hk is odd)
  const bool sc16 = QUANT && !L::kSplit && !a.sc_f32;
  const int sc_shl = sc16 && !(hk & 1) ? 16 : 0;
  const uint32_t sc_mask = sc16 ? 0xFFFF0000u : 0xFFFFFFFFu;
  auto scale_of = [&](const uint8_t* st, int kvsel, int t) {
    const uint32_t w =
        reinterpret_cast<const uint32_t*>(st + P::SOFF)[kvsel * TN + t];
    return __uint_as_float((w << sc_shl) & sc_mask);
  };

  // the score lanes' token t, head-dim part u and rows r0 .. r0 + RPL - 1
  // (written by the lanes u < SPLIT); each of those rows' score factor (log2
  // units): qf (int8 dot products) or the softmax scale; the P V lanes'
  // column groups and token part
  const int t = lane % TN, u = lane / TN;
  const int r0 = scatter_row0<R, LPT>(u);
  const bool writer = u < P::SPLIT;
  const int cg = lane % (CG < 32 ? CG : 32), tp = lane / (CG < 32 ? CG : 32);
  float sf[RPL], m[RPL], l[RPL];
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const int g = r0 + k;
    sf[k] = (DOT && g < rt0.nr
                 ? a.qf[((size_t)b * a.Hkv + hk) * a.G + rt0.g0 + g]
                 : a.scale) *
            kLog2e;
    m[k] = -INFINITY;
    l[k] = 0.f;  // this lane's token's share of the row sum
  }
  float acc[R][NCG][4];
#pragma unroll
  for (int g = 0; g < R; ++g)
#pragma unroll
    for (int j = 0; j < NCG; ++j)
      acc[g][j][0] = acc[g][j][1] = acc[g][j][2] = acc[g][j][3] = 0.f;

  // the q rows, the table's first entries and every warp's first page ids
  // past them landed, then S tiles of each warp in flight, each group with
  // the page ids of the tile S on
#pragma unroll 1
  for (int i = 0; i < S; ++i) fetch_ids(i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll 1
  for (int i = 0; i < S; ++i) {
    load_tile(i);
    __syncwarp();  // every lane read the stage's page ids
    fetch_ids(i + S);
    cp_async_commit();
  }

#pragma unroll 1
  for (int i = 0; i < nmine; ++i) {
    cp_async_wait<S - 1>();
    __syncwarp();  // tile i and the page ids of tile i + S landed
    const uint8_t* st = ring + (i % S) * P::STG;
    const int t0 = tile_t0(i);

    // scores in log2 units, -inf past the range: every row with token t,
    // each lane over its chunks u, u + LPT, ... of the head dim (K
    // converted once), the LPT parts summed and scattered by shuffles: rows
    // r0 + k in s[k]
    float s[RPL];
    const uint8_t* kr = st + t * RB;
    if constexpr (DOT) {
      int x[R];
#pragma unroll
      for (int g = 0; g < R; ++g) x[g] = 0;
#pragma unroll
      for (int i2 = 0; i2 < P::NU / LPT; ++i2) {
        const int c = u + LPT * i2;
        const int4 kw = *reinterpret_cast<const int4*>(kr + 16 * c);
#pragma unroll
        for (int g = 0; g < R; ++g) {
          const int4 qw =
              *reinterpret_cast<const int4*>(sQ + g * P::QLD + 16 * c);
          x[g] = __dp4a(qw.x, kw.x, x[g]);
          x[g] = __dp4a(qw.y, kw.y, x[g]);
          x[g] = __dp4a(qw.z, kw.z, x[g]);
          x[g] = __dp4a(qw.w, kw.w, x[g]);
        }
      }
      const float ks = scale_of(st, 0, t);
      scatter_sum<R, 1, LPT, TN>(x, u);
#pragma unroll
      for (int k = 0; k < RPL; ++k)
        s[k] = static_cast<float>(x[k]) * sf[k] * ks;
    } else {
      // four partial sums a row (the values 4e .. 4e + 3 of each chunk)
      float x[R][4];
#pragma unroll
      for (int g = 0; g < R; ++g) x[g][0] = x[g][1] = x[g][2] = x[g][3] = 0.f;
      const float ks = QUANT ? scale_of(st, 0, t) : 1.f;
#pragma unroll
      for (int i2 = 0; i2 < P::NU / LPT; ++i2) {
        const int c = u + LPT * i2;
        float kv[P::UD];
        const uint4 w = *reinterpret_cast<const uint4*>(kr + 16 * c);
        chunk_to_float<float, POOL>(w, kv);
        if constexpr (QUANT) {
#pragma unroll
          for (int e = 0; e < P::UD; ++e) kv[e] *= ks;
        }
#pragma unroll
        for (int g = 0; g < R; ++g) {
          const float* qr =
              reinterpret_cast<const float*>(sQ + g * P::QLD) + P::UD * c;
#pragma unroll
          for (int e = 0; e < P::UD; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qr + e);
            x[g][0] = fmaf(q4.x, kv[e], x[g][0]);
            x[g][1] = fmaf(q4.y, kv[e + 1], x[g][1]);
            x[g][2] = fmaf(q4.z, kv[e + 2], x[g][2]);
            x[g][3] = fmaf(q4.w, kv[e + 3], x[g][3]);
          }
        }
      }
      float y[R];
#pragma unroll
      for (int g = 0; g < R; ++g)
        y[g] = (x[g][0] + x[g][1]) + (x[g][2] + x[g][3]);
      scatter_sum<R, 1, LPT, TN>(y, u);
#pragma unroll
      for (int k = 0; k < RPL; ++k) s[k] = y[k] * sf[k];
    }

    // the online softmax of the lane's rows over the tile's TN lanes; their
    // weights (p, or in the int8 dot products p times the V scale quantized
    // over the span of lanes 4k .. 4k + 3: floor(p * 127 / max + 0.5),
    // each code times max / 127, as the plain version) and rescales into
    // sW, sA
    const bool live = t0 + t < s_hi;
    const float vs_t = DOT ? scale_of(st, 1, t) : 0.f;
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int g = r0 + k;
      const float sv = live ? s[k] : -INFINITY;
      float mx = sv;
#pragma unroll
      for (int o = 1; o < TN; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float mn = fmaxf(m[k], mx);
      const float al = mn == -INFINITY ? 1.f : exp2f(m[k] - mn);
      const float p = sv == -INFINITY ? 0.f : exp2f(sv - mn);
      l[k] = l[k] * al + p;  // l sums the unscaled p
      m[k] = mn;
      float w = p;
      if constexpr (DOT) {
        const float p3 = p * vs_t;
        float pm = fmaxf(p3, __shfl_xor_sync(kFull, p3, 1));
        pm = fmaxf(pm, __shfl_xor_sync(kFull, pm, 2));
        const float rr = pm > 0.f ? 127.f / pm : 0.f;
        w = floorf(__fadd_rn(__fmul_rn(p3, rr), 0.5f)) * (pm * (1.f / 127.f));
      }
      if (writer) {
        sW[t * R + g] = w;
        if (t == 0) sA[g] = al;
      }
    }
    __syncwarp();

    // O += W V: each row's columns rescaled, then the lane's tokens tp,
    // tp + TP, ... in order (1-byte rows converted as read, times their
    // token's scale except in the int8 dot products)
    {
      float al[R];
#pragma unroll
      for (int g = 0; g < R; ++g) al[g] = sA[g];
#pragma unroll
      for (int g = 0; g < R; ++g)
#pragma unroll
        for (int j = 0; j < NCG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][j][e] *= al[g];
      const uint8_t* vt = st + P::VOFF;
#pragma unroll 2
      for (int tt = tp; tt < TN; tt += TP) {
        float wt[R];
#pragma unroll
        for (int g = 0; g < R; ++g) wt[g] = sW[tt * R + g];
        const float vsc = QUANT && !DOT ? scale_of(st, 1, tt) : 1.f;
#pragma unroll
        for (int j = 0; j < NCG; ++j) {
          const int col = cg + 32 * j;
          float v[4];
          if constexpr (QUANT) {
            payload4_to_float<DOT ? kPoolInt8 : POOL>(
                *reinterpret_cast<const uint32_t*>(vt + tt * RB + 4 * col),
                v);
            if constexpr (!DOT) {
#pragma unroll
              for (int e = 0; e < 4; ++e) v[e] *= vsc;
            }
          } else {
            const float4 y =
                *reinterpret_cast<const float4*>(vt + tt * RB + 16 * col);
            v[0] = y.x;
            v[1] = y.y;
            v[2] = y.z;
            v[3] = y.w;
          }
#pragma unroll
          for (int g = 0; g < R; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[g][j][e] = fmaf(wt[g], v[e], acc[g][j][e]);
        }
      }
    }
    __syncwarp();  // every lane is done with the stage and the weights

    load_tile(i + S);
    __syncwarp();  // every lane read the stage's page ids
    fetch_ids(i + 2 * S);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // the warp's row sums over its tokens, and at D 64 its two token parts'
  // columns (a + b in one lane, b + a in the other: the same bits)
#pragma unroll
  for (int k = 0; k < RPL; ++k)
#pragma unroll
    for (int o = 1; o < TN; o <<= 1)
      l[k] += __shfl_xor_sync(kFull, l[k], o);
#pragma unroll
  for (int o = CG; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < R; ++g)
#pragma unroll
      for (int j = 0; j < NCG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[g][j][e] += __shfl_xor_sync(kFull, acc[g][j][e], o);
  __syncthreads();  // every warp is done with its ring: the states take it

  // the warps' (m, l, O) merged in warp order: sO [NW][R][D], sM, sL
  // [NW][R]
  float* sO = reinterpret_cast<float*>(rings);
  float* sM = sO + NW * R * D;
  float* sL = sM + NW * R;
  if (tp == 0) {
#pragma unroll
    for (int g = 0; g < R; ++g)
#pragma unroll
      for (int j = 0; j < NCG; ++j)
        *reinterpret_cast<float4*>(sO + (warp * R + g) * D + 4 * (cg + 32 * j)) =
            make_float4(acc[g][j][0], acc[g][j][1], acc[g][j][2],
                        acc[g][j][3]);
  }
  if (t == 0 && writer) {
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      sM[warp * R + r0 + k] = m[k];
      sL[warp * R + r0 + k] = l[k];
    }
  }
  __syncthreads();

  // nsplit == 1: normalised out and LSE, else this split's (m, l, acc) for
  // the merge (the tile's rows, from row g0 of the group on)
  const RowTile rt = row_tile(a);
  const int G = a.G, Hkv = a.Hkv, g0 = rt.g0, nr = rt.nr;
  const size_t row0 = ((size_t)b * Hkv + rt.hk) * G + g0;
  const size_t pair = (size_t)b * Hkv + rt.hk;
  float* ws_acc = nullptr;
  float* ws_ml = nullptr;
  if (a.nsplit > 1) {
    ws_acc = a.ws + pair * a.nsplit * G * D + (size_t)g0 * D;
    ws_ml = a.ws + (size_t)a.B * Hkv * a.nsplit * G * D +
            pair * a.nsplit * G * 2 + (size_t)g0 * 2;
  }
  for (int i = tid; i < nr * D; i += NTH) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sM[w * R + g]);
    float Lsum = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = sM[w * R + g];
      const float c = mw == -INFINITY ? 0.f : exp2f(mw - M);
      Lsum += sL[w * R + g] * c;
      O += sO[(w * R + g) * D + d] * c;
    }
    if (a.nsplit == 1) {
      const size_t row = row0 + g;
      static_cast<float*>(a.out)[row * D + d] = Lsum > 0.f ? O / Lsum : 0.f;
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
  // the partials in split order and resets the counter (paged_decode.cuh's
  // merge)
  __threadfence();
  __syncthreads();
  const size_t cpair = pair * rt.tiles + rt.tile;
  if (tid == 0) {
    const int prev = atomicAdd(a.counters + cpair, 1);
    s_last = prev == a.nsplit - 1;
    if (s_last) atomicExch(a.counters + cpair, 0);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int ns = a.nsplit;
  float* s_pm = reinterpret_cast<float*>(rings);  // [nsplit][nr] m, then c
  float* s_pl = s_pm + ns * nr;                   // [nsplit][nr]
  float* s_M = s_pl + ns * nr;                    // [nr]
  float* s_L = s_M + nr;                          // [nr]
  for (int i = tid; i < ns * nr; i += NTH) {
    // one tile holds the group: its rows run on over the splits
    const size_t at = nr == G ? i : (size_t)(i / nr) * G + i % nr;
    s_pm[i] = __ldcg(ws_ml + at * 2);
    s_pl[i] = __ldcg(ws_ml + at * 2 + 1);
  }
  __syncthreads();
  if (tid < nr) {
    float M = -INFINITY;
    for (int sp = 0; sp < ns; ++sp) M = fmaxf(M, s_pm[sp * nr + tid]);
    float Lsum = 0.f;
    for (int sp = 0; sp < ns; ++sp) {
      const float ms = s_pm[sp * nr + tid];
      const float c = ms == -INFINITY ? 0.f : exp2f(ms - M);
      s_pm[sp * nr + tid] = c;
      Lsum += s_pl[sp * nr + tid] * c;
    }
    s_M[tid] = M;
    s_L[tid] = Lsum;
  }
  __syncthreads();
  for (int i = tid; i < nr * D; i += NTH) {
    const int g = i / D, d = i % D;
    const float Lsum = s_L[g];
    float O = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < ns; ++sp)
      O = fmaf(__ldcg(ws_acc + ((size_t)sp * G + g) * D + d),
               s_pm[sp * nr + g], O);
    const size_t row = row0 + g;
    static_cast<float*>(a.out)[row * D + d] = Lsum > 0.f ? O / Lsum : 0.f;
    if (a.lse != nullptr && d == 0)
      a.lse[row] = Lsum > 0.f ? (s_M[g] + log2f(Lsum)) * kLn2 : kMaskValue;
  }
}

// ---- host side

template <int POOL, int D, int R, typename L>
int launch(const DecodeArgs& a) {
  static bool done = false;
  constexpr int smem = Plan<D, POOL, R>::SMEM;
  const cudaError_t err =
      allow_smem(paged_generic_decode_kernel<POOL, D, R, L>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nsplit, a.Hkv * a.tiles, a.B);
  paged_generic_decode_kernel<POOL, D, R, L>
      <<<grid, Geo<D>::NTH, smem, a.stream>>>(a);
  return cudaGetLastError();
}

// The block's q rows R come from the wrapper (ops/decode_split.py
// generic_tile_rows, which also sizes the merge counters): 1, 2, 4 or 8.
template <int POOL, int D, typename L>
int by_rows(const DecodeArgs& a) {
  switch (a.R) {
    case 1: return launch<POOL, D, 1, L>(a);
    case 2: return launch<POOL, D, 2, L>(a);
    case 4: return launch<POOL, D, 4, L>(a);
    case 8: return launch<POOL, D, 8, L>(a);
  }
  return cudaErrorInvalidValue;
}

// The split pools have no int8 dot-product mode (nor has the TPU kernel
// they replace).
template <int D, typename L>
int by_pool(int pool, const DecodeArgs& a) {
  switch (pool) {
    case kPoolNative: return by_rows<kPoolNative, D, L>(a);
    case kPoolInt8: return by_rows<kPoolInt8, D, L>(a);
    case kPoolE4M3: return by_rows<kPoolE4M3, D, L>(a);
    case kPoolInt8Dot:
      if constexpr (!L::kSplit) return by_rows<kPoolInt8Dot, D, L>(a);
      break;
  }
  return cudaErrorInvalidValue;
}

// layout 0: fused pools, 1: split pools.  One source instantiates it for
// each head dim (AULE_GENERIC_DECODE_DIM).
template <int D>
int by_layout(int layout, int pool, const DecodeArgs& a) {
  return layout ? by_pool<D, SplitLayout>(pool, a)
                : by_pool<D, FusedLayout>(pool, a);
}

#define AULE_GENERIC_DECODE_DIM(KW, D) \
  KW template int by_layout<D>(int layout, int pool, const DecodeArgs& a)

}  // namespace aule_generic
