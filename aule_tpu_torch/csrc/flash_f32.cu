// Flash attention forward for f32 inputs at D = 64, 128 or 256 (sm_90a),
// on the tensor cores in 3xTF32.  Hand-written CUDA C++.  bf16 / f16 run on
// flash_fwd.cu; the f32 backward is flash_f32_bwd.cu's and takes this
// kernel's LSE.
//
// Replaces, in f32, the TPU kernel aule_tpu/ops/flash.py::_fwd_kernel (its
// f32 branch, flash.py:147-152, which puts f32 on the matrix unit at
// Precision.HIGHEST, i.e. in several bf16 passes).  It computes what that
// kernel computes: causal and window masks, GQA, Sq != Sk, fused half-split
// RoPE from [L, D/2] f32 tables (identity past L), a device-side kv_len (one
// int32 read on the card, so a CUDA graph replays the call at another
// length) and the natural-log LSE; rows at or past Sq are never written.
//
// What bounds it on the H100: operations.  Each product is 3xTF32: an f32
// operand x is split into big = tf32(x) and small = tf32(x - big)
// (cvt.rna.tf32.f32, round to nearest, so x = big + small to ~22 bits), and
// a b = a_small b_big + a_big b_small + a_big b_big, summed in f32 in that
// order (the small x small term, 2^-22 of |a b|, is dropped).  Three TF32
// products run at 495 / 3 = 165 TFLOP/s, against 67 TFLOP/s of f32 FFMA,
// and keep the f32 rows within 1e-5 of an f32 reference (the CPU model in
// tests/test_torch_flash_tf32.py; one TF32 pass does not).  The design:
//   * one block per (q tile, q head, sequence), the heaviest (last) q
//     tiles first, of 4 warps (8 at D = 128, one block an SM); each warp
//     owns 16 q rows, so its score tile and its output stay in registers
//     (the O fragment is 16 x D a warp: D / 2 floats a thread);
//   * K and V tiles of BN keys (64, or 16 at D = 256) in shared memory, in
//     two buffers: V(j) is copied (cp.async) while the warps compute S =
//     Q K(j)^T, and K(j + 1) while they compute O += P V(j).  With RoPE
//     the Q and K tiles go through registers to be rotated;
//   * at D = 64 and 128 the block splits each K and V tile once as it
//     lands (the raw tile lands where its small parts go, each value split
//     in place by one thread, its big part beside it), so the warps read
//     both parts; at D = 256 (no room for both) each warp splits K and V
//     as it reads them.  Q is split as it is read (16-byte reads), P in
//     registers after the online softmax; mma.sync m16n8k8 .tf32;
//   * short chains: the tensor cores truncate their sums, and one chain of
//     mmas over all 1,024 keys of a GPT-2 row left O 1.4e-5 of its size
//     low (PERF.md).  So each 32 head-dim values of S (8 at D = 256) and
//     each tile's P V products are summed on the tensor cores from zero
//     (12 or 3, and 3 BN / 8 mmas a chain, 8 chains side by side) and added
//     to S and O in f32, rounded to nearest;
//   * the head dim of S is permuted within each 16 values so that a thread
//     reads 4 contiguous values of a Q or K row per 16-byte load (rows D +
//     16 floats apart: no bank conflict), and the keys of P V within each 8
//     so that the score accumulators are P's A fragments as they stand
//     (V rows D + 4 floats apart: its column reads meet no bank conflict);
//   * online softmax in log2 units (exp2, the scale folded in), row max
//     and sum over the row's 4 threads by shuffles;
//   * tiles outside the causal diagonal, the window or kv_len are skipped;
//     K / V rows at or past kv_len load as zeros.
// Shared memory: 94 KB at D = 64 (2 blocks an SM), 210 KB at D = 128 (one
// block of 8 warps), 101 KB at D = 256 (2; its O fragment takes 128
// registers a thread).

#include "generic.cuh"
#include "tf32.cuh"

namespace {

using namespace aule;

// Tile shape by head dim: NW warps of 16 q rows, BN keys a tile; Q and K
// rows of LQ floats, V rows of LV floats; MINB blocks resident on an SM
// (shared memory allows it).  On an H100, splitting K and V once per block
// took 10-13 % off the time of every warp splitting them (D 64 and 128);
// 32-key tiles at 3 blocks an SM took 11-14 % longer than 64-key tiles;
// at D 256, 16-key tiles at 2 blocks took 7 % less than 32-key tiles at 1
// (PERF.md).
template <int D>
struct F32Tile {
  // PRE: K and V split once per block as their tiles land (big and small
  // parts in two arrays each), not by every warp as it reads them; at D
  // 256 both parts leave no room for a second block
  static constexpr bool PRE = D <= 128;
  static constexpr int NW = PRE && D == 128 ? 8 : 4;  // warps a block
  static constexpr int NTH = NW * 32;
  static constexpr int BM = NW * 16;  // q rows a block, 16 a warp
  static constexpr int BN = D > 128 ? 16 : 64;
  static constexpr int LQ = D + 16;
  static constexpr int LV = D + 4;
  static constexpr int MINB = PRE ? (D == 128 ? 1 : 2) : (D == 64 ? 3 : 2);
  static constexpr int SMEM =
      4 * (BM * LQ + (PRE ? 2 : 1) * BN * (LQ + LV));
};

// Rows row0 .. row0 + R - 1 of src [S, D] f32 -> dst (rows of ld floats);
// rows at or past lim are zeros.  Without tables by 16-byte cp.async (the
// caller commits); with them through registers, row pos turned by table
// row pos (half split, as common.cuh's rope_chunks: rounded products) and
// rows at or past rope_len as they are.
template <int D, int R, int NTH>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int row0, int lim, const float* rc,
                                          const float* rs, int rope_len) {
  if (rc == nullptr) {
    constexpr int C = D / 4;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < R * C; i += NTH) {
      const int r = i / C, c = i % C, pos = row0 + r;
      const bool ok = pos < lim;
      cp_async16(smem_u32(dst + r * ld + 4 * c),
                 src + (ok ? (size_t)pos * D + 4 * c : 0), ok);
    }
    return;
  }
  constexpr int H = D / 2, C = H / 4;  // 4-value groups of a half row
  for (int i = threadIdx.x; i < R * C; i += NTH) {
    const int r = i / C, c = i % C, pos = row0 + r;
    float4 x1 = make_float4(0.f, 0.f, 0.f, 0.f), x2 = x1;
    if (pos < lim) {
      x1 = __ldg(reinterpret_cast<const float4*>(src + (size_t)pos * D) + c);
      x2 = __ldg(reinterpret_cast<const float4*>(src + (size_t)pos * D + H) +
                 c);
      if (pos < rope_len) {
        const float4 cs =
            __ldg(reinterpret_cast<const float4*>(rc + (size_t)pos * H) + c);
        const float4 sn =
            __ldg(reinterpret_cast<const float4*>(rs + (size_t)pos * H) + c);
        const float4 y1 = make_float4(
            rot_lo(x1.x, x2.x, cs.x, sn.x), rot_lo(x1.y, x2.y, cs.y, sn.y),
            rot_lo(x1.z, x2.z, cs.z, sn.z), rot_lo(x1.w, x2.w, cs.w, sn.w));
        x2 = make_float4(
            rot_hi(x1.x, x2.x, cs.x, sn.x), rot_hi(x1.y, x2.y, cs.y, sn.y),
            rot_hi(x1.z, x2.z, cs.z, sn.z), rot_hi(x1.w, x2.w, cs.w, sn.w));
        x1 = y1;
      }
    }
    *reinterpret_cast<float4*>(dst + r * ld + 4 * c) = x1;
    *reinterpret_cast<float4*>(dst + r * ld + H + 4 * c) = x2;
  }
}

// q, o [B, Hq, Sq, D]; k, v [B, Hkv, Sk, D]; lse [B, Hq, Sq] or null; rope
// tables [rope_len, D / 2] f32 or null; kv_len one int32 on the card or
// null.  Grid: (q tiles, Hq, B), the last q tile first.
template <int D>
__global__ void __launch_bounds__(F32Tile<D>::NTH, F32Tile<D>::MINB)
    flash_f32_fwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, const float* rc,
                         const float* rs, const int* kv_len, int Hq, int Hkv,
                         int Sq, int Sk, int rope_len, float scale,
                         int causal, int window) {
  using TL = F32Tile<D>;
  constexpr bool PRE = TL::PRE;
  constexpr int BN = TL::BN, LQ = TL::LQ, LV = TL::LV, BM = TL::BM,
                NTH = TL::NTH;
  constexpr int NS = BN / 8;  // score n-tiles (keys)
  constexpr int NO = D / 8;   // output n-tiles (head dim)
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BM * LQ;
  float* sV = sK + BN * LQ;
  // with PRE the small parts, where the raw tiles land first
  float* sKs = PRE ? sV + BN * LV : sK;
  float* sVs = PRE ? sKs + BN * LQ : sV;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int kvl = live_keys(kv_len, Sk);
  int j_lo, j_hi;
  kv_range(q_lo, min(q_lo + BM, Sq) - 1, kvl, causal, window, BN, j_lo, j_hi);
  const size_t qoff = ((size_t)b * Hq + h) * Sq * D;
  const float* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const float* vb = v + ((size_t)b * Hkv + hk) * Sk * D;

  // the thread's rows r (g) and r + 8 of the warp's 16
  const int r0 = warp * 16 + g;
  const int qpos0 = q_lo + r0, qpos1 = qpos0 + 8;
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float sl2 = scale * kLog2e;

  if (j_lo <= j_hi) {
    load_rows<D, BM, NTH>(sQ, LQ, q + qoff, q_lo, Sq, rc, rs, rope_len);
    load_rows<D, BN, NTH>(sKs, LQ, kb, j_lo * BN, kvl, rc, rs, rope_len);
    cp_async_commit();
  }
  for (int j = j_lo; j <= j_hi; ++j) {
    const int kv0 = j * BN;
    cp_async_wait<0>();
    __syncthreads();  // K(j) landed; every warp is done with V(j - 1)
    if constexpr (PRE) split_rows<D, BN, NTH>(sK, sKs, LQ);
    load_rows<D, BN, NTH>(sVs, LV, vb, kv0, kvl, nullptr, nullptr, 0);
    cp_async_commit();
    if constexpr (PRE) __syncthreads();  // K(j) split

    // S = Q K^T: 16 head-dim values at a time, k-step 2c taking values
    // 16c + 4t + {0, 1} as its columns t, t + 4 and k-step 2c + 1 values
    // 16c + 4t + {2, 3}; the products of CF such groups summed on the
    // tensor cores from 0 (32 values, or at D 256, with only 4 score
    // n-tiles, each k-step apart: 8 independent chains of 3), then added
    // to S in f32 (the first group's sums are S)
    constexpr int KS = NS < 8 ? 2 : 1;
    constexpr int CF = KS == 1 ? 2 : 1;
    constexpr int UNR = 2 / CF;  // 16-value groups a loop iteration: 2
    float s[NS][4];
#pragma unroll (UNR)
    for (int c0 = 0; c0 < D / 16; c0 += CF) {
      float part[KS][NS][4];
#pragma unroll
      for (int i = 0; i < KS; ++i)
#pragma unroll
        for (int j2 = 0; j2 < NS; ++j2)
          part[i][j2][0] = part[i][j2][1] = part[i][j2][2] = part[i][j2][3] =
              0.f;
#pragma unroll
      for (int c = c0; c < c0 + CF; ++c) {
        const float4 xa =
            *reinterpret_cast<const float4*>(sQ + r0 * LQ + 16 * c + 4 * t);
        const float4 xb = *reinterpret_cast<const float4*>(
            sQ + (r0 + 8) * LQ + 16 * c + 4 * t);
        uint32_t ab[2][4], as[2][4];
        split(xa.x, ab[0][0], as[0][0]);
        split(xb.x, ab[0][1], as[0][1]);
        split(xa.y, ab[0][2], as[0][2]);
        split(xb.y, ab[0][3], as[0][3]);
        split(xa.z, ab[1][0], as[1][0]);
        split(xb.z, ab[1][1], as[1][1]);
        split(xa.w, ab[1][2], as[1][2]);
        split(xb.w, ab[1][3], as[1][3]);
#pragma unroll
        for (int jn = 0; jn < NS; ++jn) {
          const int at = (8 * jn + g) * LQ + 16 * c + 4 * t;
          const float4 y = *reinterpret_cast<const float4*>(sK + at);
          uint32_t bb[2][2], bs[2][2];
          if constexpr (PRE) {
            const uint4 z = *reinterpret_cast<const uint4*>(sKs + at);
            bb[0][0] = __float_as_uint(y.x);
            bb[0][1] = __float_as_uint(y.y);
            bb[1][0] = __float_as_uint(y.z);
            bb[1][1] = __float_as_uint(y.w);
            bs[0][0] = z.x;
            bs[0][1] = z.y;
            bs[1][0] = z.z;
            bs[1][1] = z.w;
          } else {
            split(y.x, bb[0][0], bs[0][0]);
            split(y.y, bb[0][1], bs[0][1]);
            split(y.z, bb[1][0], bs[1][0]);
            split(y.w, bb[1][1], bs[1][1]);
          }
          mma3(part[0][jn], ab[0], as[0], bb[0], bs[0]);
          mma3(part[KS - 1][jn], ab[1], as[1], bb[1], bs[1]);
        }
      }
#pragma unroll
      for (int jn = 0; jn < NS; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = part[0][jn][e];
          if (KS == 2) x += part[KS - 1][jn][e];
          s[jn][e] = c0 == 0 ? x : s[jn][e] + x;
        }
    }

    // scores in log2 units, -inf where not visible; the online softmax of
    // rows r (e = 0, 1) and r + 8 (e = 2, 3) over their 4 threads
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int jn = 0; jn < NS; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kv0 + 8 * jn + 2 * t + (e & 1);
        const bool ok =
            visible(e < 2 ? qpos0 : qpos1, kpos, kvl, causal, window);
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

    cp_async_wait<0>();
    __syncthreads();  // V(j) landed; every warp is done with K(j)
    if constexpr (PRE) {
      split_rows<D, BN, NTH>(sV, sVs, LV);
      __syncthreads();  // V(j) split
    }
    if (j < j_hi) {
      load_rows<D, BN, NTH>(sKs, LQ, kb, kv0 + BN, kvl, rc, rs, rope_len);
      cp_async_commit();
    }

    // O += P V: k-step kk takes keys 8kk + 2t and 8kk + 2t + 1 as its
    // columns t and t + 4, so P's A fragment is the score accumulator
    // (c0, c2, c1, c3) and V's B fragment rows 8kk + 2t, 8kk + 2t + 1.
    // Each output n-tile sums this tile's products on the tensor cores
    // from 0 and adds them to O in f32: the tensor cores truncate their
    // sums, so a chain of mmas over every key biases O toward zero by
    // ~1e-5 of a row over 1,024 keys; a tile's chain is 3 NS mmas long,
    // JB n-tiles' chains side by side
    uint32_t pb[NS][4], pv[NS][4];
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      split(s[kk][0], pb[kk][0], pv[kk][0]);
      split(s[kk][2], pb[kk][1], pv[kk][1]);
      split(s[kk][1], pb[kk][2], pv[kk][2]);
      split(s[kk][3], pb[kk][3], pv[kk][3]);
    }
    const float* vt = sV + 2 * t * LV + g;
    const float* vts = sVs + 2 * t * LV + g;
    constexpr int JB = NO < 8 ? NO : 8;
#pragma unroll
    for (int j0 = 0; j0 < NO; j0 += JB) {
      float part[JB][4];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
        part[jj][0] = part[jj][1] = part[jj][2] = part[jj][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NS; ++kk)
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          uint32_t bb[2], bs[2];
          const int a0 = 8 * kk * LV + 8 * (j0 + jj), a1 = a0 + LV;
          if constexpr (PRE) {
            bb[0] = __float_as_uint(vt[a0]);
            bb[1] = __float_as_uint(vt[a1]);
            bs[0] = __float_as_uint(vts[a0]);
            bs[1] = __float_as_uint(vts[a1]);
          } else {
            split(vt[a0], bb[0], bs[0]);
            split(vt[a1], bb[1], bs[1]);
          }
          mma3(part[jj], pb[kk], pv[kk], bb, bs);
        }
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j0 + jj][e] += part[jj][e];
    }
  }

  // normalise; LSE m ln 2 + ln l, or kMaskValue with zeros for a row that
  // saw nothing
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = half ? qpos1 : qpos0;
    const float l = half ? l1 : l0, m = half ? m1 : m0;
    if (qpos >= Sq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* orow = o + qoff + (size_t)qpos * D + 2 * t;
#pragma unroll
    for (int jn = 0; jn < NO; ++jn)
      *reinterpret_cast<float2*>(orow + 8 * jn) = make_float2(
          acc[jn][2 * half] * inv, acc[jn][2 * half + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[(size_t)(b * Hq + h) * Sq + qpos] =
          l > 0.f ? (m + log2f(l)) * kLn2 : kMaskValue;
  }
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        const void* rc, const void* rs, const void* kv_len, int B, int Hq,
        int Hkv, int Sq, int Sk, int rope_len, float scale, int causal,
        int window, cudaStream_t stream) {
  using TL = F32Tile<D>;
  static bool done = false;
  constexpr int smem = TL::SMEM;
  cudaError_t err = allow_smem(flash_f32_fwd_kernel<D>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + TL::BM - 1) / TL::BM, Hq, B);
  flash_f32_fwd_kernel<D><<<grid, TL::NTH, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<const float*>(rc),
      static_cast<const float*>(rs), static_cast<const int*>(kv_len), Hq, Hkv,
      Sq, Sk, rope_len, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// As aule_flash_fwd (ops/_build.py), f32 only (dtype 2) at D 64/128/256.
extern "C" int aule_flash_f32_fwd(const void* q, const void* k,
                                  const void* v, void* o, void* lse,
                                  const void* rc, const void* rs,
                                  const void* kv_len, int B, int Hq, int Hkv,
                                  int Sq, int Sk, int D, int rope_len,
                                  float scale, int causal, int window,
                                  int dtype, void* stream) {
  if (dtype != kF32) return cudaErrorInvalidValue;
  if (Sq <= 0 || B <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return fwd<64>(q, k, v, o, lse, rc, rs, kv_len, B, Hq, Hkv, Sq, Sk,
                     rope_len, scale, causal, window, s);
    case 128:
      return fwd<128>(q, k, v, o, lse, rc, rs, kv_len, B, Hq, Hkv, Sq, Sk,
                      rope_len, scale, causal, window, s);
    case 256:
      return fwd<256>(q, k, v, o, lse, rc, rs, kv_len, B, Hq, Hkv, Sq, Sk,
                      rope_len, scale, causal, window, s);
  }
  return cudaErrorInvalidValue;
}
