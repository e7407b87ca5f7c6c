// Paged prefill for f32 q at D = 64, 128 or 256 (sm_90a), on the tensor
// cores in 3xTF32.  Hand-written CUDA C++.  bf16 / f16 q run on
// paged_prefill.cu; the f32 decode is paged_generic.cu's.
//
// Replaces, for f32 q, the TPU kernel aule_tpu/ops/paged_fused.py::
// _fused_prefill_kernel (its f32 branch, Precision.HIGHEST) over fused pools
// [P, 2, Hkv, page, Dpad] (D padded to 128 lanes) in every pool mode of the
// prefill: f32, and int8 or e4m3 with the packed scale tile (bf16 or f32),
// each value its payload times its token's scale in f32.  Query s of
// sequence b sits at q_offsets[b] + s and sees cache positions below
// context_lens[b], at or before its own when causal, and within q - k <= W
// with a window (one-sided also when not causal); -1 table entries clamp
// to page 0; rows at or past context_lens[b] give zeros and LSE -0.7 *
// f32max (the port's documented divergence from the JAX kernel, ROADMAP
// queue 3).
//
// What bounds it on the H100: operations, 4 D per (row, visible key) pair,
// in 3xTF32 on mma.sync (tf32.cuh: three TF32 products a pair, 165 TFLOP/s
// against 67 of FFMA).  The design:
//   * the grid fills the card: a block takes 16 q rows of one q head (a
//     chunk of 256 over GPT-2's 12 heads is 192 blocks, against 48 of 64
//     rows), and its NW warps split the block's key tiles among them (warp
//     w takes tiles j_lo + w, j_lo + w + NW, ...), each running the online
//     softmax over its own tiles; at the end the warps' (m, l, O) are merged
//     in warp order through shared memory, so two runs give the same bits;
//   * each warp gathers its K and V tiles itself, by 16-byte cp.async
//     (rows of the D live lanes of a pool row, tokens at or past the
//     context zero-filled), V(j) in flight while S = Q K(j)^T runs and the
//     warp's next K while O += P V(j) runs, the next tile's table entries
//     and scales read a tile ahead; a warp waits only on its own copies
//     (no block barrier in the loop).  1-byte pools land in a byte
//     staging tile and are converted to f32 times the token's scale in
//     shared memory, then split as they are read;
//   * the products as flash_f32.cu's: mma.sync m16n8k8 .tf32, Q split
//     into big and small TF32 parts once for the block, K, V and P as
//     they are read (each warp's tiles are its own), S
//     summed on the tensor cores in short chains (each k-step pair of 16
//     head-dim values from zero) and each tile's P V from zero, every
//     chain added to its f32 sum (an mma truncates its sum);
//   * the head dim of S is permuted within each 16 values (Q and K rows D
//     + 16 floats apart, 16-byte reads), the keys of P V within each 8 (P's
//     A fragment is the score accumulator as it stands; V rows D + 4
//     floats apart), as in flash_f32.cu;
//   * the key tiles outside the causal diagonal, the window or the context
//     of the block's rows are skipped.

#include "generic.cuh"
#include "paged_pool.cuh"
#include "tf32.cuh"

namespace {

using namespace aule;

// NW warps a block of 16 q rows, BN keys a warp's tile; Q (its big and
// small parts) and K rows of LQ floats, V rows of LV floats, 1-byte staging
// rows of D bytes.  Shared memory (f32 pools / 1-byte pools): 84 / 100 KB
// at D 64, 87 / 103 KB at D 128, 167 / 199 KB at D 256.  8 warps of
// 16-key tiles at D 64 took as long on an H100 (PERF.md).
template <int D>
struct PfTile {
  static constexpr int NW = 4, NTH = NW * 32, BM = 16;
  static constexpr int BN = D == 64 ? 32 : 16;
  static constexpr int LQ = D + 16, LV = D + 4;
  static constexpr int WARP_FLOATS = BN * (LQ + LV);  // a warp's K and V
};

template <int D, int POOL>
constexpr int pf_smem() {
  using TL = PfTile<D>;
  return 4 * (2 * TL::BM * TL::LQ + TL::NW * TL::WARP_FLOATS) +
         (POOL == kPoolNative ? 0 : TL::NW * 2 * TL::BN * D);
}

struct PrefillArgs {
  const float* q;     // [B, Hq, Sq, D]
  Pool pool;
  const int* bt;      // [B, max_pages]
  const int* lens;    // [B] total visible cache length
  const int* qoff;    // [B] absolute position of query 0
  float* out;         // [B, Hq, Sq, D]
  float* lse;         // [B, Hq, Sq] or null
  int Hq, Sq, max_pages;
  float scale;
  int causal, window;
};

// may the query at qpos see the key at kpos, with len cached tokens?
__device__ __forceinline__ bool seen(int qpos, int kpos, int len, int causal,
                                     int window) {
  bool ok = kpos < len && qpos < len;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && qpos - kpos <= window;
  return ok;
}

// Where lane i < BN's token tok0 + i lies: the byte offsets of its K and
// V rows (-1 at or past len) and, in 1-byte pools, their scales.  A warp
// finds them a tile ahead, so the table and scale reads are off the copies'
// path.
struct TokRows {
  long long k, v;
  float sk, sv;
};

template <int POOL, int D, int BN>
__device__ __forceinline__ TokRows find_rows(const Pool& p, const int* bt,
                                             int hk, int tok0, int len,
                                             int lane) {
  using RW = Row<float, POOL, D, FusedLayout>;
  TokRows r{-1, -1, 0.f, 0.f};
  const int tok = tok0 + lane;
  if (lane < BN && tok < len) {
    size_t page;
    int slot;
    locate(bt, tok, p.page_size, page, slot);
    r.k = (long long)(row_index<FusedLayout>(p, page, slot, hk, 0) *
                      RW::BYTES);
    r.v = (long long)(row_index<FusedLayout>(p, page, slot, hk, 1) *
                      RW::BYTES);
    if constexpr (POOL != kPoolNative) {
      r.sk = row_scale<FusedLayout>(p, page, slot, hk, 0);
      r.sv = row_scale<FusedLayout>(p, page, slot, hk, 1);
    }
  }
  return r;
}

// One warp's copy of its tile's BN K or V rows (lane i's row offset `at`,
// taken by the warp's chunks by shuffle) by 16-byte cp.async (the caller
// commits): f32 rows of ld floats into dst, or 1-byte rows of D bytes into
// stage; rows at -1 zeros.
template <int POOL, int D, int BN>
__device__ __forceinline__ void gather(float* dst, int ld, uint8_t* stage,
                                       const Pool& p, long long at,
                                       int lane) {
  constexpr int CPR = Row<float, POOL, D, FusedLayout>::CPR;
  static_assert(BN <= 32 && BN * CPR % 32 == 0, "a lane a token");
#pragma unroll
  for (int k = 0; k < BN * CPR / 32; ++k) {
    const int i = lane + 32 * k, r = i / CPR, c = i % CPR;
    const long long row = __shfl_sync(0xffffffffu, at, r);
    const void* src = p.kv + (row < 0 ? 0 : row + 16 * c);
    const uint32_t to = POOL == kPoolNative
                            ? smem_u32(dst + r * ld + 4 * c)
                            : smem_u32(stage + r * D + 16 * c);
    cp_async16(to, src, row >= 0);
  }
}

// A warp's staged 1-byte tile -> f32 rows of ld floats, each value times
// its token's scale (lane i's `sc`; zero rows past the context stay zero).
template <int POOL, int D, int BN>
__device__ __forceinline__ void convert(float* dst, int ld,
                                        const uint8_t* stage, float sc,
                                        int lane) {
  constexpr int CPR = D / 16;
#pragma unroll 2
  for (int k = 0; k < BN * CPR / 32; ++k) {
    const int i = lane + 32 * k, r = i / CPR, c = i % CPR;
    const float s = __shfl_sync(0xffffffffu, sc, r);
    const uint4 w = *reinterpret_cast<const uint4*>(stage + r * D + 16 * c);
    float f[16];
    chunk_to_float<float, POOL>(w, f);
    float* o = dst + r * ld + 16 * c;
#pragma unroll
    for (int e = 0; e < 16; e += 4)
      *reinterpret_cast<float4*>(o + e) =
          make_float4(f[e] * s, f[e + 1] * s, f[e + 2] * s, f[e + 3] * s);
  }
}

// Grid (q tiles of 16 rows, Hq, B), the last q tile first.
template <int POOL, int D>
__global__ void __launch_bounds__(PfTile<D>::NTH)
    paged_prefill_f32_kernel(const PrefillArgs a) {
  using TL = PfTile<D>;
  constexpr int NW = TL::NW, NTH = TL::NTH, BM = TL::BM, BN = TL::BN,
                LQ = TL::LQ, LV = TL::LV;
  constexpr int NS = BN / 8;  // score n-tiles (keys)
  constexpr int NO = D / 8;   // output n-tiles (head dim)
  constexpr bool STAGED = POOL != kPoolNative;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // Q's big parts
  float* sQs = sQ + BM * LQ;  // where the raw Q lands: its small parts
  float* tiles = sQs + BM * LQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sK = tiles + warp * TL::WARP_FLOATS;
  float* sV = sK + BN * LQ;
  uint8_t* stK = reinterpret_cast<uint8_t*>(tiles + NW * TL::WARP_FLOATS) +
                 warp * 2 * BN * D;
  uint8_t* stV = stK + BN * D;

  const int g = lane >> 2, t = lane & 3;
  const int s_lo = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.pool.Hkv);
  const int len = max(0, min(a.lens[b], a.max_pages * a.pool.page_size));
  const int q0 = a.qoff[b];
  // the keys [k_min, k_max] some live row of this tile sees
  const int qa_lo = q0 + s_lo, qa_hi = q0 + min(s_lo + BM, a.Sq) - 1;
  const int k_min = a.window > 0 ? max(0, qa_lo - a.window) : 0;
  const int k_max =
      qa_lo >= len ? -1 : (a.causal ? min(len - 1, qa_hi) : len - 1);
  const int j_lo = k_min / BN;
  const int j_hi = k_max >= k_min ? k_max / BN : j_lo - 1;
  const int* bt = a.bt + (size_t)b * a.max_pages;
  const size_t qoff = ((size_t)b * a.Hq + h) * a.Sq * D;

  // Q once for the block, then each warp its first K tile
  {
    constexpr int C = D / 4;
    for (int i = threadIdx.x; i < BM * C; i += NTH) {
      const int r = i / C, c = i % C, sq = s_lo + r;
      const bool ok = sq < a.Sq;
      cp_async16(smem_u32(sQs + r * LQ + 4 * c),
                 a.q + qoff + (ok ? (size_t)sq * D + 4 * c : 0), ok);
    }
    cp_async_commit();
  }
  const int j0 = j_lo + warp;
  TokRows next = find_rows<POOL, D, BN>(a.pool, bt, hk, j0 * BN, len, lane);
  if (j0 <= j_hi) {
    gather<POOL, D, BN>(sK, LQ, stK, a.pool, next.k, lane);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // Q (and each warp's first K) landed
  split_rows<D, BM, NTH>(sQ, sQs, LQ);
  __syncthreads();  // Q split

  const int qpos0 = q0 + s_lo + g, qpos1 = qpos0 + 8;
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float sl2 = a.scale * kLog2e;

  for (int j = j0; j <= j_hi; j += NW) {
    const int kv0 = j * BN;
    const TokRows cur = next;
    gather<POOL, D, BN>(sV, LV, stV, a.pool, cur.v, lane);
    cp_async_commit();
    // the warp's next tile's rows, read while this one's products run
    if (j + NW <= j_hi)
      next = find_rows<POOL, D, BN>(a.pool, bt, hk, kv0 + NW * BN, len,
                                    lane);
    cp_async_wait<1>();
    __syncwarp();  // K(j) landed
    if constexpr (STAGED) {
      convert<POOL, D, BN>(sK, LQ, stK, cur.sk, lane);
      __syncwarp();
    }

    // S = Q K^T, 16 head-dim values at a time (k-step 2c: values 16c + 4t
    // + {0, 1} as its columns t, t + 4; k-step 2c + 1: 16c + 4t + {2, 3}),
    // each k-step's products from 0 on the tensor cores, the pair's sum
    // added to S in f32
    float s[NS][4];
#pragma unroll 2
    for (int c = 0; c < D / 16; ++c) {
      float part[2][NS][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jn = 0; jn < NS; ++jn)
          part[i][jn][0] = part[i][jn][1] = part[i][jn][2] = part[i][jn][3] =
              0.f;
      const int qa = g * LQ + 16 * c + 4 * t, qb = qa + 8 * LQ;
      const uint4 xa = *reinterpret_cast<const uint4*>(sQ + qa);
      const uint4 xb = *reinterpret_cast<const uint4*>(sQ + qb);
      const uint4 ya = *reinterpret_cast<const uint4*>(sQs + qa);
      const uint4 yb = *reinterpret_cast<const uint4*>(sQs + qb);
      const uint32_t ab[2][4] = {{xa.x, xb.x, xa.y, xb.y},
                                 {xa.z, xb.z, xa.w, xb.w}};
      const uint32_t as[2][4] = {{ya.x, yb.x, ya.y, yb.y},
                                 {ya.z, yb.z, ya.w, yb.w}};
#pragma unroll
      for (int jn = 0; jn < NS; ++jn) {
        const float4 y = *reinterpret_cast<const float4*>(
            sK + (8 * jn + g) * LQ + 16 * c + 4 * t);
        uint32_t bb[2][2], bs[2][2];
        split(y.x, bb[0][0], bs[0][0]);
        split(y.y, bb[0][1], bs[0][1]);
        split(y.z, bb[1][0], bs[1][0]);
        split(y.w, bb[1][1], bs[1][1]);
        mma3(part[0][jn], ab[0], as[0], bb[0], bs[0]);
        mma3(part[1][jn], ab[1], as[1], bb[1], bs[1]);
      }
#pragma unroll
      for (int jn = 0; jn < NS; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = part[0][jn][e] + part[1][jn][e];
          s[jn][e] = c == 0 ? x : s[jn][e] + x;
        }
    }

    // scores in log2 units, -inf where not seen; the online softmax of rows
    // g (e = 0, 1) and g + 8 (e = 2, 3) over their 4 threads
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int jn = 0; jn < NS; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kv0 + 8 * jn + 2 * t + (e & 1);
        const bool ok =
            seen(e < 2 ? qpos0 : qpos1, kpos, len, a.causal, a.window);
        s[jn][e] = ok ? s[jn][e] * sl2 : -INFINITY;
        if (e < 2)
          mx0 = fmaxf(mx0, s[jn][e]);
        else
          mx1 = fmaxf(mx1, s[jn][e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row that has seen nothing yet keeps m = -inf and p = 0
    const float al0 = mn0 == -INFINITY ? 1.f : exp2f(m0 - mn0);
    const float al1 = mn1 == -INFINITY ? 1.f : exp2f(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int jn = 0; jn < NS; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn0 : mn1;
        const float p = mn == -INFINITY ? 0.f : exp2f(s[jn][e] - mn);
        s[jn][e] = p;
        if (e < 2)
          ps0 += p;
        else
          ps1 += p;
      }
    l0 = l0 * al0 + ps0;  // this thread's part of the row sums
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int jn = 0; jn < NO; ++jn) {
      acc[jn][0] *= al0;
      acc[jn][1] *= al0;
      acc[jn][2] *= al1;
      acc[jn][3] *= al1;
    }

    __syncwarp();  // every lane is done with K(j)
    if (j + NW <= j_hi) {
      gather<POOL, D, BN>(sK, LQ, stK, a.pool, next.k, lane);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // V(j) landed
    if constexpr (STAGED) {
      convert<POOL, D, BN>(sV, LV, stV, cur.sv, lane);
      __syncwarp();
    }

    // O += P V: k-step kk takes keys 8kk + 2t and 8kk + 2t + 1 as its
    // columns t and t + 4 (P's A fragment is the score accumulator (c0, c2,
    // c1, c3)); each output n-tile's chain over the tile's keys from 0 on
    // the tensor cores, JB side by side, added to O in f32
    uint32_t pb[NS][4], pv[NS][4];
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      split(s[kk][0], pb[kk][0], pv[kk][0]);
      split(s[kk][2], pb[kk][1], pv[kk][1]);
      split(s[kk][1], pb[kk][2], pv[kk][2]);
      split(s[kk][3], pb[kk][3], pv[kk][3]);
    }
    const float* vt = sV + 2 * t * LV + g;
    constexpr int JB = NO < 8 ? NO : 8;
#pragma unroll
    for (int jb = 0; jb < NO; jb += JB) {
      float part[JB][4];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
        part[jj][0] = part[jj][1] = part[jj][2] = part[jj][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NS; ++kk)
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          uint32_t bb[2], bs[2];
          const int a0 = 8 * kk * LV + 8 * (jb + jj);
          split(vt[a0], bb[0], bs[0]);
          split(vt[a0 + LV], bb[1], bs[1]);
          mma3(part[jj], pb[kk], pv[kk], bb, bs);
        }
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jb + jj][e] += part[jj][e];
    }
    __syncwarp();  // every lane is done with V(j)
  }

  // the warps' (m, l, O) merged in warp order: sM, sL [NW][BM], sO
  // [NW][BM][D] over the tiles
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  __syncthreads();  // every warp is done with its tiles
  float* sO = tiles;
  float* sM = sO + NW * BM * D;
  float* sL = sM + NW * BM;
  {
    float* o = sO + warp * BM * D;
#pragma unroll
    for (int jn = 0; jn < NO; ++jn) {
      *reinterpret_cast<float2*>(o + g * D + 8 * jn + 2 * t) =
          make_float2(acc[jn][0], acc[jn][1]);
      *reinterpret_cast<float2*>(o + (g + 8) * D + 8 * jn + 2 * t) =
          make_float2(acc[jn][2], acc[jn][3]);
    }
    if (t == 0) {
      sM[warp * BM + g] = m0;
      sM[warp * BM + g + 8] = m1;
      sL[warp * BM + g] = l0;
      sL[warp * BM + g + 8] = l1;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * D; i += NTH) {
    const int r = i / D, sq = s_lo + r;
    if (sq >= a.Sq) continue;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sM[w * BM + r]);
    float Lsum = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = sM[w * BM + r];
      const float c = mw == -INFINITY ? 0.f : exp2f(mw - M);
      Lsum += sL[w * BM + r] * c;
      O += sO[(w * BM + r) * D + i % D] * c;
    }
    a.out[qoff + (size_t)sq * D + i % D] = Lsum > 0.f ? O / Lsum : 0.f;
    if (a.lse != nullptr && i % D == 0)
      a.lse[((size_t)b * a.Hq + h) * a.Sq + sq] =
          Lsum > 0.f ? (M + log2f(Lsum)) * kLn2 : kMaskValue;
  }
}

template <int POOL, int D>
int prefill(const PrefillArgs& a, int B, cudaStream_t stream) {
  static bool done = false;
  constexpr int smem = pf_smem<D, POOL>();
  static_assert(4 * (PfTile<D>::NW * PfTile<D>::BM * (D + 2)) <=
                    4 * PfTile<D>::NW * PfTile<D>::WARP_FLOATS,
                "the merge fits the warps' tiles");
  const cudaError_t err =
      allow_smem(paged_prefill_f32_kernel<POOL, D>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + PfTile<D>::BM - 1) / PfTile<D>::BM, a.Hq, B);
  paged_prefill_f32_kernel<POOL, D>
      <<<grid, PfTile<D>::NTH, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
int prefill_by_pool(int pool, const PrefillArgs& a, int B,
                    cudaStream_t stream) {
  switch (pool) {
    case kPoolNative: return prefill<kPoolNative, D>(a, B, stream);
    case kPoolInt8: return prefill<kPoolInt8, D>(a, B, stream);
    case kPoolE4M3: return prefill<kPoolE4M3, D>(a, B, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out [B, Hq, Sq, D] f32 (16-bit q runs csrc/paged_prefill.cu); kv the
// fused pool [P, 2, Hkv, page, Dpad] with its packed scale tile sc
// (quantized pools; bf16, or f32 with sc_f32) or null; context_lens the
// total visible cache length and q_offsets the position of query 0, per
// sequence; lse [B, Hq, Sq] or null.
extern "C" int aule_paged_prefill_f32(
    const void* q, const void* kv, const void* sc, const void* block_tables,
    const void* context_lens, const void* q_offsets, void* out, void* lse,
    int B, int Hq, int Hkv, int Sq, int page_size, int max_pages, int D,
    float scale, int causal, int window, int dtype, int pool, int sc_f32,
    void* stream) {
  if (B <= 0 || Sq <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq <= 0 || Hq % Hkv) return cudaErrorInvalidValue;
  if (dtype != kF32) return cudaErrorInvalidValue;  // paged_prefill.cu's
  const PrefillArgs a{static_cast<const float*>(q),
                      Pool{static_cast<const uint8_t*>(kv), nullptr, sc,
                           nullptr, sc_f32, Hkv, 0, page_size},
                      static_cast<const int*>(block_tables),
                      static_cast<const int*>(context_lens),
                      static_cast<const int*>(q_offsets),
                      static_cast<float*>(out),
                      static_cast<float*>(lse),
                      Hq,
                      Sq,
                      max_pages,
                      scale,
                      causal,
                      window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return prefill_by_pool<64>(pool, a, B, s);
    case 128: return prefill_by_pool<128>(pool, a, B, s);
    case 256: return prefill_by_pool<256>(pool, a, B, s);
  }
  return cudaErrorInvalidValue;
}
