// Paged attention for what the tensor-core paged kernels (paged_decode.cu,
// paged_prefill.cu) do not take (sm_90a): f32 q and pools at D = 64, 128 or
// 256 (those two run bf16 / f16 at every head dim), in every pool mode of
// the port.  Hand-written CUDA C++, the products on FFMA (the int8 dot
// products' scores on __dp4a).  The f32 prefill is paged_prefill_f32.cu's
// (3xTF32 on the tensor cores).  The kernel:
//   paged decode over either pool layout (the kernel's L, as in
//       paged_decode.cu).  Replaces, for those types and head dims, the TPU
//       kernels aule_tpu/ops/paged_fused.py::_fused_decode_kernel (fused
//       pools [P, 2, Hkv, page, Dpad], D padded to 128 lanes:
//       paged_fused.py:56-66, 494-498; f32 with Precision.HIGHEST,
//       l.334-336) and aule_tpu/ops/paged.py::_paged_decode_kernel (split
//       pools [Hkv, P, page, D]; f32 at l.208; any D through the lane
//       padding of l.366-372).  Semantics as paged_decode.cu's note: one
//       query token per sequence over the first context_lens[b] tokens (the
//       trailing `window` of them with a window), -1 table entries clamp to
//       page 0, context 0 gives zeros and LSE -0.7 * f32max;
//
// Pool modes (common.cuh kPool*):
//   * native: the pool holds the q / out type (f32);
//   * int8 and e4m3 with scales (the fused packed tile, bf16 or f32, or
//     split f32 scales): each value is its payload times its token's scale
//     in f32, one product, as the plain versions dequantize;
//   * int8 dot products (fused int8 pools, the engine's default): q
//     arrives as per-row int8 codes with qf = q scale x softmax scale (the
//     wrapper quantizes it, f32 q too, as paged_fused.py:525-560); the
//     score is an exact int32 __dp4a sum times qf and the K scale; p times
//     the V scale is quantized per row over spans of SPAN = 4 tokens
//     counted from the first visible token (paged_decode.cu's span, so the
//     plain version ops/paged_fused.py::_int8_dot_plain holds both), each
//     code weighing the raw V row by the span's max / 127.
//
// What bounds it on the H100: decode reads every live K and V byte once
// for a handful of operations, so it is memory bound.  GPT-2 small at B8
// ctx1024 (12 kv heads, D64) holds 50.3 MB of live f32 K/V a layer (15.0 us
// at 3.35 TB/s) and 12.6 MB of 1-byte payload (plus the scales).  The kernel reads only the D live lanes of a fused pool's
// 128-lane row: reading the padded rows whole would double those bytes.
// The design:
//   * decode is split-KV over the card with the partition of
//     paged_decode.cu (ops/decode_split.py: nsplit blocks per (sequence,
//     kv head) from the shapes and the SM count only, each block's range
//     derived on the device, ranges starting on SPAN boundaries), so the
//     split and fused layouts run the same arithmetic on the same values
//     and give the same bits; the last block of a (sequence, kv head)
//     merges the splits in split order in the same launch, through a
//     counter it resets, so two runs give the same bits;
//   * a block of 256 threads gathers BN tokens of K and V at a time into
//     f32 rows of D + 4 floats in shared memory (dequantized on the way),
//     every thread issuing all of its 16-byte loads before it uses one;
//   * decode scores: each (q row, token) pair's dot product is split over
//     NDP adjacent lanes (a slice of D each, summed by shuffles) so that
//     the GQA group's few rows keep every thread busy; then one warp a q
//     row runs the online softmax (exp2, log2 units); then each thread
//     accumulates a quad of output columns over every NTP-th token, and
//     the token parts are summed in a fixed order at the end;
//   * any GQA group G (the TPU kernels pad it to a multiple of 8): a block
//     takes R q rows of its kv head's group, R = G padded to a power of
//     two up to 8, so that the lane mapping above divides; rows past G are
//     zeros whose results are dropped.  A group over 8 is cut into
//     ceil(G / 8) row tiles of R = 8, each a grid row of its own (each
//     reads its (sequence, kv head)'s K/V; ops/decode_split.py counts the
//     tiles among the blocks of a wave).

#include "generic.cuh"
#include "paged_pool.cuh"

namespace {

using namespace aule;

constexpr int kMaxGroup = 8;  // q rows a decode block takes at most
constexpr int kMaxSplits = 64;  // ops/decode_split.py MAX_SPLITS
constexpr int SPAN = 4;         // ops/decode_split.py DECODE_SPAN
constexpr unsigned kFull = 0xffffffffu;

// Tokens tok0 .. tok0 + R - 1 of a sequence's table, kv head hk, K (kvsel
// 0) or V -> dst [R][D + 4] f32: 1-byte payloads times their token's scale
// unless RAW; tokens at or past `hi` are zeros.  Every 16-byte load of the
// thread is issued before the first is used.
template <typename T, int POOL, int D, int R, typename L, bool RAW>
__device__ __forceinline__ void load_kv(float* dst, const Pool& p,
                                        const int* bt, int hk, int kvsel,
                                        int tok0, int hi) {
  using RW = Row<T, POOL, D, L>;
  constexpr int CPR = RW::CPR, NV = 16 / RW::ESZ, LD = D + 4;
  constexpr int NCH = R * CPR / NT;
  constexpr bool SCALED = POOL != kPoolNative && !RAW;
  static_assert(NCH * NT == R * CPR, "whole chunks for every thread");
  const uint8_t* base = L::kSplit && kvsel ? p.v : p.kv;
  uint4 w[NCH];
  float s[NCH];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int id = threadIdx.x + i * NT, r = id / CPR, c = id % CPR;
    const int tok = tok0 + r;
    w[i] = make_uint4(0u, 0u, 0u, 0u);
    s[i] = 1.f;
    if (tok < hi) {
      size_t page;
      int slot;
      locate(bt, tok, p.page_size, page, slot);
      w[i] = __ldg(reinterpret_cast<const uint4*>(
          base + row_index<L>(p, page, slot, hk, kvsel) * RW::BYTES +
          c * 16));
      if constexpr (SCALED) s[i] = row_scale<L>(p, page, slot, hk, kvsel);
    }
  }
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int id = threadIdx.x + i * NT, r = id / CPR, c = id % CPR;
    float f[NV];
    chunk_to_float<T, POOL>(w[i], f);
    float* o = dst + r * LD + c * NV;
#pragma unroll
    for (int e = 0; e < NV; e += 4) {
      float4 x = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
      if constexpr (SCALED) {
        x.x *= s[i];
        x.y *= s[i];
        x.z *= s[i];
        x.w *= s[i];
      }
      *reinterpret_cast<float4*>(o + e) = x;
    }
  }
}

// The int8 dot products' K: tokens tok0 .. tok0 + R - 1 as raw int8 rows
// of D + 16 bytes (dst), zeros at or past `hi`.
template <int D, int R, typename L>
__device__ __forceinline__ void load_codes(uint8_t* dst, const Pool& p,
                                           const int* bt, int hk, int tok0,
                                           int hi) {
  using RW = Row<int8_t, kPoolInt8Dot, D, L>;
  constexpr int CPR = RW::CPR, NCH = R * CPR / NT;
  static_assert(NCH * NT == R * CPR, "whole chunks for every thread");
  uint4 w[NCH];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int id = threadIdx.x + i * NT, r = id / CPR, c = id % CPR;
    const int tok = tok0 + r;
    w[i] = make_uint4(0u, 0u, 0u, 0u);
    if (tok < hi) {
      size_t page;
      int slot;
      locate(bt, tok, p.page_size, page, slot);
      w[i] = __ldg(reinterpret_cast<const uint4*>(
          p.kv + row_index<L>(p, page, slot, hk, 0) * RW::BYTES + c * 16));
    }
  }
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int id = threadIdx.x + i * NT, r = id / CPR, c = id % CPR;
    *reinterpret_cast<uint4*>(dst + r * (D + 16) + c * 16) = w[i];
  }
}

// ---- (a) decode

struct DecodeArgs {
  const void* q;     // [B, Hq, D] (int8 codes in the int8-dot mode)
  const float* qf;   // [B, Hq] q scale x softmax scale (int8-dot mode)
  Pool pool;
  const int* bt;     // [B, max_pages]
  const int* lens;   // [B]
  void* out;         // [B, Hq, D] in T
  float* lse;        // [B, Hq] or null
  float* ws;         // nsplit > 1: [B, Hkv, nsplit, G] x (D + 2) f32
  int* counters;     // nsplit > 1: [B, Hkv, row tiles] int32, 0 between calls
  int B, G, max_pages;
  int R, tiles;      // q rows a block takes (G up to a power of two, <= 8)
                     // and the row tiles of a group, ceil(G / R)
  float scale;
  int window, nsplit;
  cudaStream_t stream;
};

// Shared memory of the decode: K and V tiles, the group's q rows, their
// scores, per-row state (m, l, alpha, score factor), the int8 dot
// products' K and V scales.
template <int D>
constexpr size_t decode_smem() {
  using Ti = Tiles<D>;
  return sizeof(float) *
         (2 * Ti::BN * Ti::LD + kMaxGroup * (D + Ti::BN + 4) + 2 * Ti::BN);
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
  const int G = a.G, R = a.R;
  RowTile t;
  t.tiles = a.tiles;
  t.hk = t.tiles == 1 ? y : y / t.tiles;  // a group up to 8: no division
  t.tile = y - t.hk * t.tiles;
  t.g0 = t.tile * R;
  t.nr = min(R, G - t.g0);
  return t;
}

// Grid (nsplit, Hkv x row tiles, B), blockIdx.y = hk * tiles + tile; G =
// Hq / Hkv, any whole number.
template <typename T, int POOL, int D, typename L>
__global__ void __launch_bounds__(NT)
    paged_generic_decode_kernel(const DecodeArgs a) {
  using Ti = Tiles<D>;
  constexpr int BN = Ti::BN, LD = Ti::LD, KB = D + 16;
  constexpr bool DOT = POOL == kPoolInt8Dot;
  extern __shared__ float4 smem4[];
  float* sV = reinterpret_cast<float*>(smem4);  // [BN][LD]
  float* sK = sV + BN * LD;   // [BN][LD]; int8 dot: raw rows of KB bytes
  float* sQ = sK + BN * LD;   // [R][D]; int8 dot: the codes
  float* sS = sQ + kMaxGroup * D;  // [R][BN] scores, then weights
  float* sM = sS + kMaxGroup * BN;  // running max (log2 units)
  float* sL = sM + kMaxGroup;       // running sum of p
  float* sA = sL + kMaxGroup;       // this tile's rescale of the sums
  float* sF = sA + kMaxGroup;       // score factor (log2 units)
  float* sKs = sF + kMaxGroup;      // int8 dot: [BN] K scales, [BN] V's
  float* sVs = sKs + BN;
  __shared__ int s_last;

  const int split = blockIdx.x, b = blockIdx.z;
  const int G = a.G, R = a.R;
  const int Hkv = a.pool.Hkv, ps = a.pool.page_size;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const RowTile rt0 = row_tile(a);
  const int hk = rt0.hk;

  // the tile's q rows, zeros past nr
  {
    const int nr = rt0.nr;
    const size_t row0 = ((size_t)b * Hkv + hk) * G + rt0.g0;
    if constexpr (DOT) {
      const int8_t* qb = static_cast<const int8_t*>(a.q) + row0 * D;
      int8_t* sq = reinterpret_cast<int8_t*>(sQ);
      for (int i = tid; i < R * D; i += NT) sq[i] = i < nr * D ? qb[i] : 0;
    } else {
      const T* qb = static_cast<const T*>(a.q) + row0 * D;
      for (int i = tid; i < R * D; i += NT)
        sQ[i] = i < nr * D ? Val<T>::ld(qb + i) : 0.f;
    }
    if (tid < R) {
      sM[tid] = -INFINITY;
      sL[tid] = 0.f;
      sF[tid] = (DOT && tid < nr ? a.qf[row0 + tid] : a.scale) * kLog2e;
    }
  }

  // this block's range [s_lo, s_hi) of the live tokens [t_lo, len)
  // (ops/decode_split.py split_bounds)
  const int len = max(0, min(a.lens[b], a.max_pages * ps));
  const int t_lo = a.window > 0 ? max(0, len - a.window) : 0;
  const int per = (len - t_lo + a.nsplit - 1) / a.nsplit;
  const int chunk = (per + SPAN - 1) / SPAN * SPAN;
  const int s_lo = t_lo + split * chunk;
  const int s_hi = min(len, s_lo + chunk);
  const int ntiles = s_hi > s_lo ? (s_hi - s_lo + BN - 1) / BN : 0;
  const int* bt = a.bt + (size_t)b * a.max_pages;

  // Score pairs (g, t) of a tile: NDP adjacent threads each (a slice of DW
  // dims), PS pairs a thread.  Output quads (g, 4 columns): NTP threads
  // each (every NTP-th token), PQ quads a thread.  R, BN, D and NT are
  // powers of two, so every count divides.
  const int SP = R * BN;
  const int NDP = SP < NT ? NT / SP : 1, PS = SP > NT ? SP / NT : 1;
  const int NPS = NT / NDP, DW = D / NDP;
  const int dpart = tid % NDP, pslot = tid / NDP;
  const int OQ = R * D / 4;
  const int NTP = OQ < NT ? NT / OQ : 1, PQ = OQ > NT ? OQ / NT : 1;
  const int QS = NT / NTP;  // quads in flight
  const int tpart = tid / QS, qslot = tid % QS;
  float acc[2][4];
#pragma unroll
  for (int k = 0; k < 2; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int t0 = s_lo + j * BN;
    __syncthreads();  // the last tile's readers are done
    if constexpr (DOT) {
      load_codes<D, BN, L>(reinterpret_cast<uint8_t*>(sK), a.pool, bt, hk,
                           t0, s_hi);
      load_kv<T, POOL, D, BN, L, true>(sV, a.pool, bt, hk, 1, t0, s_hi);
      if (tid < 2 * BN) {  // sKs then sVs
        const int tok = t0 + tid % BN;
        float s = 0.f;
        if (tok < s_hi) {
          size_t page;
          int slot;
          locate(bt, tok, ps, page, slot);
          s = row_scale<L>(a.pool, page, slot, hk, tid / BN);
        }
        sKs[tid] = s;
      }
    } else {
      load_kv<T, POOL, D, BN, L, false>(sK, a.pool, bt, hk, 0, t0, s_hi);
      load_kv<T, POOL, D, BN, L, false>(sV, a.pool, bt, hk, 1, t0, s_hi);
    }
    __syncthreads();

    // scores in log2 units, -inf past the range
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k >= PS) break;
      const int pr = pslot + k * NPS, g = pr / BN, t = pr % BN;
      float s;
      if constexpr (DOT) {
        const int4* qw = reinterpret_cast<const int4*>(
            reinterpret_cast<const int8_t*>(sQ) + g * D + dpart * DW);
        const int4* kw = reinterpret_cast<const int4*>(
            reinterpret_cast<const uint8_t*>(sK) + t * KB + dpart * DW);
        int x = 0;
        for (int u = 0; u < DW / 16; ++u) {
          const int4 qa = qw[u], kb = kw[u];
          x = __dp4a(qa.x, kb.x, x);
          x = __dp4a(qa.y, kb.y, x);
          x = __dp4a(qa.z, kb.z, x);
          x = __dp4a(qa.w, kb.w, x);
        }
        for (int o = 1; o < NDP; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
        s = static_cast<float>(x) * sF[g] * sKs[t];
      } else {
        const float* qr = sQ + g * D + dpart * DW;
        const float* kr = sK + t * LD + dpart * DW;
        float x = 0.f;
        for (int d = 0; d < DW; d += 4) {
          const float4 u = *reinterpret_cast<const float4*>(qr + d);
          const float4 v = *reinterpret_cast<const float4*>(kr + d);
          x = fmaf(u.x, v.x, x);
          x = fmaf(u.y, v.y, x);
          x = fmaf(u.z, v.z, x);
          x = fmaf(u.w, v.w, x);
        }
        for (int o = 1; o < NDP; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
        s = x * sF[g];
      }
      if (dpart == 0) sS[g * BN + t] = t0 + t < s_hi ? s : -INFINITY;
    }
    __syncthreads();

    // online softmax, one warp a q row; the weights replace the scores
    if (warp < R) {
      const int g = warp;
      constexpr int PL = BN / 32;  // tokens a lane
      float sv[PL];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        sv[i] = sS[g * BN + lane + 32 * i];
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_old = sM[g], m_new = fmaxf(m_old, mx);
      const float alpha = m_new == -INFINITY ? 1.f : exp2f(m_old - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int t = lane + 32 * i;
        const float p = sv[i] == -INFINITY ? 0.f : exp2f(sv[i] - m_new);
        psum += p;  // l sums the unscaled p
        float w = p;
        if constexpr (DOT) {
          // p * V scale as int8 codes over this span of SPAN tokens (lanes
          // 4k .. 4k + 3), as the plain version: floor(p * 127 / max +
          // 0.5), each code times max / 127
          const float p3 = p * sVs[t];
          float pm = fmaxf(p3, __shfl_xor_sync(kFull, p3, 1));
          pm = fmaxf(pm, __shfl_xor_sync(kFull, pm, 2));
          const float rr = pm > 0.f ? 127.f / pm : 0.f;
          w = floorf(__fadd_rn(__fmul_rn(p3, rr), 0.5f)) *
              (pm * (1.f / 127.f));
        }
        sS[g * BN + t] = w;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(kFull, psum, o);
      if (lane == 0) {
        sM[g] = m_new;
        sL[g] = sL[g] * alpha + psum;
        sA[g] = alpha;
      }
    }
    __syncthreads();

    // O += W V over this thread's tokens, each quad rescaled first
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k >= PQ) break;
      const int qd = qslot + k * QS, g = qd / (D / 4), c = qd % (D / 4) * 4;
      const float al = sA[g];
      float* ac = acc[k];
      ac[0] *= al;
      ac[1] *= al;
      ac[2] *= al;
      ac[3] *= al;
      const float* wr = sS + g * BN;
      for (int t = tpart; t < BN; t += NTP) {
        const float w = wr[t];
        const float4 v = *reinterpret_cast<const float4*>(sV + t * LD + c);
        ac[0] = fmaf(w, v.x, ac[0]);
        ac[1] = fmaf(w, v.y, ac[1]);
        ac[2] = fmaf(w, v.z, ac[2]);
        ac[3] = fmaf(w, v.w, ac[3]);
      }
    }
  }
  __syncthreads();  // the tiles are free: the token parts' sums take them

  float* sO = sK;  // [NTP][R * D]
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k >= PQ) break;
    const int qd = qslot + k * QS, g = qd / (D / 4), c = qd % (D / 4) * 4;
    float* o = sO + (size_t)tpart * R * D + g * D + c;
    o[0] = acc[k][0];
    o[1] = acc[k][1];
    o[2] = acc[k][2];
    o[3] = acc[k][3];
  }
  __syncthreads();
  // the token parts summed in order; nsplit == 1: normalised out and LSE,
  // else this split's (m, l, acc) for the merge (the tile's rows, from
  // row g0 of the group on)
  const RowTile rt = row_tile(a);
  const int g0 = rt.g0, nr = rt.nr;
  const size_t row0 = ((size_t)b * Hkv + hk) * G + g0;
  const size_t pair = (size_t)b * Hkv + hk;
  float* ws_acc = nullptr;
  float* ws_ml = nullptr;
  if (a.nsplit > 1) {
    ws_acc = a.ws + pair * a.nsplit * G * D + (size_t)g0 * D;
    ws_ml = a.ws + (size_t)a.B * Hkv * a.nsplit * G * D +
            pair * a.nsplit * G * 2 + (size_t)g0 * 2;
  }
  for (int i = tid; i < nr * D; i += NT) {
    const int g = i / D, d = i % D;
    float O = 0.f;
    for (int tp = 0; tp < NTP; ++tp) O += sO[(size_t)tp * R * D + i];
    const float M = sM[g], Lsum = sL[g];
    if (a.nsplit == 1) {
      const size_t row = row0 + g;
      static_cast<T*>(a.out)[row * D + d] =
          Val<T>::st(Lsum > 0.f ? O / Lsum : 0.f);
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
  // the partials in split order and resets the counter (paged_decode.cu's
  // merge)
  __threadfence();
  __syncthreads();
  const size_t cpair = ((size_t)b * Hkv + hk) * rt.tiles + rt.tile;
  if (tid == 0) {
    const int prev = atomicAdd(a.counters + cpair, 1);
    s_last = prev == a.nsplit - 1;
    if (s_last) atomicExch(a.counters + cpair, 0);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int ns = a.nsplit;
  float* s_pm = sK;              // [nsplit][nr] m, then the weight c
  float* s_pl = s_pm + ns * nr;  // [nsplit][nr]
  float* s_M = s_pl + ns * nr;   // [nr]
  float* s_L = s_M + nr;         // [nr]
  for (int i = tid; i < ns * nr; i += NT) {
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
  for (int i = tid; i < nr * D; i += NT) {
    const int g = i / D, d = i % D;
    const float Lsum = s_L[g];
    float O = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < ns; ++sp)
      O = fmaf(__ldcg(ws_acc + ((size_t)sp * G + g) * D + d),
               s_pm[sp * nr + g], O);
    const size_t row = row0 + g;
    static_cast<T*>(a.out)[row * D + d] =
        Val<T>::st(Lsum > 0.f ? O / Lsum : 0.f);
    if (a.lse != nullptr && d == 0)
      a.lse[row] = Lsum > 0.f ? (s_M[g] + log2f(Lsum)) * kLn2 : kMaskValue;
  }
}

// ---- host side

template <typename T, int POOL, int D, typename L>
int decode(const DecodeArgs& a) {
  static bool done = false;
  constexpr size_t smem = decode_smem<D>();
  const cudaError_t err =
      allow_smem(paged_generic_decode_kernel<T, POOL, D, L>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nsplit, a.pool.Hkv * a.tiles, a.B);
  paged_generic_decode_kernel<T, POOL, D, L>
      <<<grid, NT, smem, a.stream>>>(a);
  return cudaGetLastError();
}

// The split pools have no int8 dot-product mode (nor has the TPU kernel
// they replace).
template <typename T, int D, typename L>
int decode_by_pool(int pool, const DecodeArgs& a) {
  switch (pool) {
    case kPoolNative: return decode<T, kPoolNative, D, L>(a);
    case kPoolInt8: return decode<T, kPoolInt8, D, L>(a);
    case kPoolE4M3: return decode<T, kPoolE4M3, D, L>(a);
    case kPoolInt8Dot:
      if constexpr (!L::kSplit) return decode<T, kPoolInt8Dot, D, L>(a);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename T, int D>
int decode_by_layout(int layout, int pool, const DecodeArgs& a) {
  return layout ? decode_by_pool<T, D, SplitLayout>(pool, a)
                : decode_by_pool<T, D, FusedLayout>(pool, a);
}

bool group_ok(int Hq, int Hkv) { return Hkv > 0 && Hq > 0 && Hq % Hkv == 0; }

// The q rows a decode block may take: a power of two up to kMaxGroup, so
// that the lane mapping divides (the wrapper picks them: ops/decode_split.py
// generic_tile_rows, which also sizes the merge counters).
bool rows_ok(int rows) {
  return rows > 0 && rows <= kMaxGroup && (rows & (rows - 1)) == 0;
}

}  // namespace

// (a) q, out [B, Hq, D] (q: int8 codes in the int8-dot mode, with qf
// [B, Hq] f32 = per-row q scale x softmax scale; qf null otherwise); dtype
// f32, the out type.  layout 0: kv the fused pool [P, 2, Hkv, page, Dpad], sc
// its packed scale tile (bf16, or f32 with sc_f32); layout 1: kv, v the
// split pools [Hkv, num_pages, page, D], sc, vs their f32 scales [Hkv,
// num_pages, page].  Scales null for native pools.  nsplit > 1: ws
// [B, Hkv, nsplit, Hq / Hkv, D + 2] f32 (uninitialised) and counters
// [B, Hkv, row tiles] int32 (ceil(G / tile_rows) row tiles; G = Hq / Hkv,
// any whole number), zero before the first call and left zero; tile_rows
// the q rows a block takes (rows_ok).
extern "C" int aule_paged_generic_decode(
    const void* q, const void* qf, const void* kv, const void* v,
    const void* sc, const void* vs, const void* block_tables,
    const void* context_lens, void* out, void* lse, void* ws, void* counters,
    int B, int Hq, int Hkv, int num_pages, int page_size, int max_pages,
    int D, float scale, int window, int nsplit, int tile_rows, int dtype,
    int pool, int sc_f32, int layout, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (!group_ok(Hq, Hkv) || !rows_ok(tile_rows) || nsplit < 1 ||
      nsplit > kMaxSplits ||
      (nsplit > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const DecodeArgs a{q,
                     static_cast<const float*>(qf),
                     Pool{static_cast<const uint8_t*>(kv),
                          static_cast<const uint8_t*>(v), sc,
                          static_cast<const float*>(vs), sc_f32, Hkv,
                          num_pages, page_size},
                     static_cast<const int*>(block_tables),
                     static_cast<const int*>(context_lens),
                     out,
                     static_cast<float*>(lse),
                     static_cast<float*>(ws),
                     static_cast<int*>(counters),
                     B,
                     Hq / Hkv,
                     max_pages,
                     tile_rows,
                     row_tiles(Hq / Hkv, tile_rows),
                     scale,
                     window,
                     nsplit,
                     static_cast<cudaStream_t>(stream)};
  AULE_GENERIC_F32_DISPATCH(decode_by_layout, layout, pool, a)
}
