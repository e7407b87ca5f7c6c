// Flash attention backward for f32 inputs at D = 64, 128 or 256 (sm_90a),
// on the tensor cores in 3xTF32.  Hand-written CUDA C++.  bf16 / f16 run on
// flash_bwd.cu; the f32 forward is flash_f32.cu's, whose LSE this takes, and
// the f32 delta is flash_generic.cu's.
//
// Replaces, in f32, the TPU kernels aule_tpu/ops/flash_vjp.py::_dq_kernel
// and ::_dkv_kernel (their f32 branches, Precision.HIGHEST) and their
// window forms _win_dq_kernel and _win_dkv_kernel.  It computes what they
// compute: dQ, dK and dV from the saved LSE and delta (delta carries a
// non-zero LSE cotangent), with causal, window and bidirectional-window
// masks, GQA, Sq != Sk and rows that see nothing.
//
// What bounds it on the H100: operations.  Each product is 3xTF32 (tf32.cuh:
// an f32 operand split into big + small TF32 parts, three mma.sync m16n8k8
// a pair), at 495 / 3 = 165 TFLOP/s against 67 of f32 FFMA, which is what
// the FFMA kernels this replaces ran at (2.9x their FFMA bound on an H100
// 80GB HBM3 at 700 W; PERF.md).  The design follows flash_f32.cu:
//   * dQ: one block per (q tile, q head, sequence), the last q tile first;
//     each warp owns 16 q rows.  For each live kv tile S = Q K^T on the
//     tensor cores and dP = dO V^T on FFMA (below), P = exp(scale S - lse)
//     and dS = P (dP - di) scale in registers, and dQ += dS K on the
//     tensor cores.  The keys of dS K are permuted within each 8 so that
//     the score accumulators are dS's A fragments as they stand
//     (flash_f32.cu's P V trick): nothing goes through shared memory
//     between the products.
//   * dQ's dP on FFMA, one f32 chain in the head dim's order, as the plain
//     version's matrix product rounds it: where one key takes a row's
//     weight (a causal row 0, whose exact dS is 0), dS = P (dP - di) is
//     the rounding of dP itself, and the card's check holds dQ there to
//     the plain version within 1e-5 of 2^-5 of the largest |dQ|.  A dP in
//     3xTF32 rounds otherwise and missed that limit on the card, though no
//     further from an exact dP than the plain's own (the CPU model in
//     tests/test_torch_flash_tf32_bwd.py: 1.8e-5 against the plain version
//     at D256, where FFMA dP reads 1.8e-6); on FFMA every case of
//     chip_smoke.py's F32_BWD_CASES reads 2.5-3.9e-6 (PERF.md).  dK/dV's
//     dP^T stays on the tensor cores: no dK or dV row cancels so.
//   * dK/dV (D 64 and 128): one block per (kv tile, q head, sequence); each
//     warp owns 16 keys.  For each live q tile S^T = K Q^T and dP^T = V
//     dO^T, P^T and dS^T with lse and di per column, dV += P^T dO and dK +=
//     dS^T Q.  At D 256 the 16 x 256 sums of dK and dV (256 registers a
//     thread) do not fit together: a block running two passes over its q
//     tiles (dV's, then dK's, S recomputed) took 3.22 ms at B1 Hq8/Hkv1
//     S2048 causal against flash_generic.cu's FFMA kernel's 2.32 (H100
//     80GB HBM3, 700 W; PERF.md), so D 256 keeps that kernel.
//   * splits once a block: dQ splits each K tile as it lands, dK/dV each Q
//     and dO tile (the raw tile lands where its small parts go, each value
//     split in place by one thread, its big part beside it); the warps
//     split their own A rows as they read them (Q for dQ; K and V for
//     dK/dV, split once at the block's start at D 64).
//   * one layout for every tile: f32 rows of D + 4 floats.  The head-dim
//     operands are read as float2 (values 8c + 2t, 8c + 2t + 1 as k-step
//     c's columns t and t + 4: a permutation within each 8 that leaves the
//     dot product alone), and the row operands (K for dQ, Q and dO for
//     dK/dV) as single floats of rows 8kk + 2t, 8kk + 2t + 1: a row stride
//     of 4 banks keeps both conflict-free, so no tile is kept twice.
//   * short chains: an mma truncates its f32 sum, so the scores (S, and
//     dK/dV's dP^T) sum each 8 head-dim values (one k-step) on the tensor
//     cores from zero, two such chains side by side, dQ each kv tile and
//     dK / dV each q tile, and each chain is added to its f32 sum, rounded
//     to nearest (the CPU model in tests/test_torch_flash_tf32_bwd.py
//     shows one chain over a long causal column missing the limit).
//   * loads overlap the products: cp.async of the next V (dQ) or the next
//     Q and dO (dK/dV) is issued as soon as the last product reading the
//     buffer is done.
//   * dK/dV at D 128 runs 8 warps (128 keys) a block with K and V split by
//     each warp as it reads its rows, in the shared memory that split
//     copies of 64 keys took for 4 warps: twice the warps an SM, which ran
//     faster on the card.
//   * the same bits on every run: no atomics.  dQ sums its kv tiles in one
//     block; with GQA each q head's dK/dV share goes to an f32 workspace
//     and a second kernel sums the group in head order (one block per kv
//     tile walking the whole group left most of the card idle with a group
//     of 8 at Hkv 1).
// Tiles outside the causal diagonal or the window are skipped; rows at or
// past S load as zeros and are never written.

#include "generic.cuh"
#include "tf32.cuh"

namespace {

using namespace aule;

// dQ tiles: NW warps of 16 q rows, BN keys a tile; Q, dO and V raw, K in
// big and small parts (shared memory: 85 KB at D 64, two blocks an SM;
// 182 KB at D 128 with 8 warps; 179 KB at D 256).
template <int D>
struct DqTile;
template <>
struct DqTile<64> {
  static constexpr int NW = 4, BN = 64, MINB = 2;
};
template <>
struct DqTile<128> {
  static constexpr int NW = 8, BN = 32, MINB = 1;
};
template <>
struct DqTile<256> {
  static constexpr int NW = 4, BN = 16, MINB = 1;
};

// dK/dV tiles: NW warps of 16 keys, BM q rows a tile; PRE: K and V split
// once at the start (else by each warp as it reads its rows).  Shared
// memory: 102 KB at D 64 (two blocks an SM), 198 KB at D 128 (8 warps).
template <int D>
struct KvTile;
template <>
struct KvTile<64> {
  static constexpr int NW = 4, BM = 32, MINB = 2;
  static constexpr bool PRE = true;
};
template <>
struct KvTile<128> {
  static constexpr int NW = 8, BM = 32, MINB = 1;
  static constexpr bool PRE = false;
};

template <int D>
constexpr int dq_smem() {
  using T = DqTile<D>;
  return 4 * (2 * 16 * T::NW + 3 * T::BN) * (D + 4);
}

template <int D>
constexpr int dkv_smem() {
  using T = KvTile<D>;
  return 4 * (((T::PRE ? 4 : 2) * 16 * T::NW + 4 * T::BM) * (D + 4) +
              2 * T::BM);
}

// Rows row0 .. row0 + R - 1 of src [S, D] f32 -> dst (rows of D + 4
// floats) by 16-byte cp.async (the caller commits); rows at or past lim are
// zeros.
template <int D, int R, int NTH>
__device__ __forceinline__ void load_async(float* dst, const float* src,
                                           int row0, int lim) {
  constexpr int C = D / 4, L = D + 4;
  for (int i = threadIdx.x; i < R * C; i += NTH) {
    const int r = i / C, c = i % C, pos = row0 + r;
    const bool ok = pos < lim;
    cp_async16(smem_u32(dst + r * L + 4 * c),
               src + (ok ? (size_t)pos * D + 4 * c : 0), ok);
  }
}

// A fragment of rows r and r + 8 at k-step c (head-dim values 8c + 2t and
// 8c + 2t + 1 as columns t and t + 4): from big and small parts (PRE), or
// split from the raw rows in `big`.
template <int L, bool PRE>
__device__ __forceinline__ void frag_a(const float* big, const float* small,
                                       int r, int c, int t, uint32_t (&ab)[4],
                                       uint32_t (&as)[4]) {
  const int a0 = r * L + 8 * c + 2 * t, a1 = a0 + 8 * L;
  if constexpr (PRE) {
    const uint2 xb = *reinterpret_cast<const uint2*>(big + a0);
    const uint2 yb = *reinterpret_cast<const uint2*>(big + a1);
    const uint2 xs = *reinterpret_cast<const uint2*>(small + a0);
    const uint2 ys = *reinterpret_cast<const uint2*>(small + a1);
    ab[0] = xb.x, ab[1] = yb.x, ab[2] = xb.y, ab[3] = yb.y;
    as[0] = xs.x, as[1] = ys.x, as[2] = xs.y, as[3] = ys.y;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(big + a0);
    const float2 y = *reinterpret_cast<const float2*>(big + a1);
    split(x.x, ab[0], as[0]);
    split(y.x, ab[1], as[1]);
    split(x.y, ab[2], as[2]);
    split(y.y, ab[3], as[3]);
  }
}

// s[NS][4] = A rows (r, r + 8) . B rows (8 jn + g) over the head dim: B in
// big and small parts; chains of one k-step (8 head-dim values) on the
// tensor cores from zero, two side by side, their sum added to s in f32
// (the first pair's sum is s).
template <int D, int NS, bool APRE>
__device__ __forceinline__ void scores(float (&s)[NS][4], const float* ab_,
                                       const float* as_, int r,
                                       const float* bb_, const float* bs_,
                                       int g, int t) {
  constexpr int L = D + 4, KS = 2;
#pragma unroll 2
  for (int c0 = 0; c0 < D / 8; c0 += KS) {
    float part[KS][NS][4];
#pragma unroll
    for (int i = 0; i < KS; ++i)
#pragma unroll
      for (int jn = 0; jn < NS; ++jn)
        part[i][jn][0] = part[i][jn][1] = part[i][jn][2] = part[i][jn][3] =
            0.f;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int kc = c0 + i;
      uint32_t ab[4], as[4];
      frag_a<L, APRE>(ab_, as_, r, kc, t, ab, as);
#pragma unroll
      for (int jn = 0; jn < NS; ++jn) {
        const int at = (8 * jn + g) * L + 8 * kc + 2 * t;
        const uint2 y = *reinterpret_cast<const uint2*>(bb_ + at);
        const uint2 z = *reinterpret_cast<const uint2*>(bs_ + at);
        const uint32_t bb[2] = {y.x, y.y}, bs[2] = {z.x, z.y};
        mma3(part[i][jn], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int jn = 0; jn < NS; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = part[0][jn][e] + part[1][jn][e];
        s[jn][e] = c0 == 0 ? x : s[jn][e] + x;
      }
  }
}

// A fragments of a 16 x 8 NS score tile for the next product, split: its
// k-step kk takes columns 8kk + 2t and 8kk + 2t + 1 as its columns t and
// t + 4, so the accumulators (c0, c2, c1, c3) are the fragment as it is.
template <int NS>
__device__ __forceinline__ void score_frags(const float (&x)[NS][4],
                                            uint32_t (&ab)[NS][4],
                                            uint32_t (&as)[NS][4]) {
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
    split(x[kk][0], ab[kk][0], as[kk][0]);
    split(x[kk][2], ab[kk][1], as[kk][1]);
    split(x[kk][1], ab[kk][2], as[kk][2]);
    split(x[kk][3], ab[kk][3], as[kk][3]);
  }
}

// acc[D / 8][4] += A (KK k-steps, from score_frags) x B rows 8kk + 2t, 8kk
// + 2t + 1 (columns 8 jn + g), B in big and small parts: each output
// n-tile's chain over the tile's KK k-steps on the tensor cores from zero,
// JB side by side, added to acc in f32.
template <int D, int KK>
__device__ __forceinline__ void rows_product(float (&acc)[D / 8][4],
                                             const uint32_t (&ab)[KK][4],
                                             const uint32_t (&as)[KK][4],
                                             const float* bb_,
                                             const float* bs_, int g,
                                             int t) {
  constexpr int L = D + 4, NO = D / 8, JB = NO < 8 ? NO : 8;
  const float* pb = bb_ + 2 * t * L + g;
  const float* ps = bs_ + 2 * t * L + g;
#pragma unroll
  for (int j0 = 0; j0 < NO; j0 += JB) {
    float part[JB][4];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)
      part[jj][0] = part[jj][1] = part[jj][2] = part[jj][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        const int a0 = 8 * kk * L + 8 * (j0 + jj), a1 = a0 + L;
        const uint32_t bb[2] = {__float_as_uint(pb[a0]),
                                __float_as_uint(pb[a1])};
        const uint32_t bs[2] = {__float_as_uint(ps[a0]),
                                __float_as_uint(ps[a1])};
        mma3(part[jj], ab[kk], as[kk], bb, bs);
      }
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j0 + jj][e] += part[jj][e];
  }
}

// dp[NS][4] = dO rows (r, r + 8) . V rows (8 jn + 2t, + 1) over the head
// dim on FFMA, one f32 chain from 0 in the head dim's order, raw rows of
// D + 4 floats (the quad's four threads read one dO row, the eight groups
// one V row: broadcasts)
template <int D, int NS>
__device__ __forceinline__ void ffma_scores(float (&dp)[NS][4],
                                            const float* o_, const float* v_,
                                            int r, int t) {
  constexpr int L = D + 4;
#pragma unroll
  for (int jn = 0; jn < NS; ++jn)
    dp[jn][0] = dp[jn][1] = dp[jn][2] = dp[jn][3] = 0.f;
  const float* oa = o_ + r * L;
  const float* ob = oa + 8 * L;
  const float* vr = v_ + 2 * t * L;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 xa = *reinterpret_cast<const float4*>(oa + d);
    const float4 xb = *reinterpret_cast<const float4*>(ob + d);
#pragma unroll
    for (int jn = 0; jn < NS; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 y =
            *reinterpret_cast<const float4*>(vr + (8 * jn + h) * L + d);
        float& a = dp[jn][h];
        float& b = dp[jn][2 + h];
        a = fmaf(xa.x, y.x, a);
        a = fmaf(xa.y, y.y, a);
        a = fmaf(xa.z, y.z, a);
        a = fmaf(xa.w, y.w, a);
        b = fmaf(xb.x, y.x, b);
        b = fmaf(xb.y, y.y, b);
        b = fmaf(xb.z, y.z, b);
        b = fmaf(xb.w, y.w, b);
      }
  }
}

// p = exp(scale s - lse) where visible, else 0
__device__ __forceinline__ float prob(float s, float lse_r, bool ok,
                                      float scale) {
  return ok ? expf(s * scale - lse_r) : 0.f;
}

// ---- dQ: dq = ds k over the live kv tiles.  Grid: (q tiles, Hq, B), the
// last q tile first.
template <int D>
__global__ void __launch_bounds__(DqTile<D>::NW * 32, DqTile<D>::MINB)
    flash_f32_bwd_dq_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dO,
                            const float* __restrict__ lse,
                            const float* __restrict__ di,
                            float* __restrict__ dq, int Hq, int Hkv, int Sq,
                            int Sk, float scale, int causal, int window) {
  using TL = DqTile<D>;
  constexpr int NTH = TL::NW * 32, BM = TL::NW * 16, BN = TL::BN;
  constexpr int L = D + 4, NS = BN / 8, NO = D / 8;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + BM * L;  // dO
  float* sKb = sO + BM * L;
  float* sKs = sKb + BN * L;  // where the raw K tile lands
  float* sV = sKs + BN * L;  // raw

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  int j_lo, j_hi;
  kv_range(q_lo, min(q_lo + BM, Sq) - 1, Sk, causal, window, BN, j_lo, j_hi);
  const size_t row0 = ((size_t)b * Hq + h) * Sq;
  const float* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const float* vb = v + ((size_t)b * Hkv + hk) * Sk * D;

  // the thread's rows r (g) and r + 8 of the warp's 16
  const int r = warp * 16 + g;
  const int qpos0 = q_lo + r, qpos1 = qpos0 + 8;
  const float lse0 = qpos0 < Sq ? lse[row0 + qpos0] : 0.f;
  const float lse1 = qpos1 < Sq ? lse[row0 + qpos1] : 0.f;
  const float di0 = qpos0 < Sq ? di[row0 + qpos0] : 0.f;
  const float di1 = qpos1 < Sq ? di[row0 + qpos1] : 0.f;
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (j_lo <= j_hi) {
    load_async<D, BM, NTH>(sQ, q + row0 * D, q_lo, Sq);
    load_async<D, BM, NTH>(sO, dO + row0 * D, q_lo, Sq);
    load_async<D, BN, NTH>(sV, vb, j_lo * BN, Sk);
    cp_async_commit();
  }
  for (int j = j_lo; j <= j_hi; ++j) {
    const int kv0 = j * BN;
    load_async<D, BN, NTH>(sKs, kb, kv0, Sk);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // V(j) (and Q, dO) landed
    float dp[NS][4];
    ffma_scores<D, NS>(dp, sO, sV, r, t);

    cp_async_wait<0>();
    __syncthreads();  // K(j) landed; every warp is done with V(j)
    split_rows<D, BN, NTH>(sKb, sKs, L);
    if (j < j_hi) {
      load_async<D, BN, NTH>(sV, vb, kv0 + BN, Sk);
      cp_async_commit();
    }
    __syncthreads();  // K(j) split
    float s[NS][4];
    scores<D, NS, false>(s, sQ, sQ, r, sKb, sKs, g, t);

    // dS = P (dP - di) scale, over the score tile in place
#pragma unroll
    for (int jn = 0; jn < NS; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kv0 + 8 * jn + 2 * t + (e & 1);
        const int qpos = e < 2 ? qpos0 : qpos1;
        const float p =
            prob(s[jn][e], e < 2 ? lse0 : lse1,
                 qpos < Sq && visible(qpos, kpos, Sk, causal, window), scale);
        s[jn][e] = p * (dp[jn][e] - (e < 2 ? di0 : di1)) * scale;
      }
    // dQ += dS K: K's rows 8kk + 2t, 8kk + 2t + 1
    uint32_t ab[NS][4], as[NS][4];
    score_frags<NS>(s, ab, as);
    rows_product<D, NS>(acc, ab, as, sKb, sKs, g, t);
    __syncthreads();  // every warp is done with K(j)
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = half ? qpos1 : qpos0;
    if (qpos >= Sq) continue;
    float* out = dq + (row0 + qpos) * D + 2 * t;
#pragma unroll
    for (int jn = 0; jn < NO; ++jn)
      *reinterpret_cast<float2*>(out + 8 * jn) =
          make_float2(acc[jn][2 * half], acc[jn][2 * half + 1]);
  }
}

// ---- dK/dV: dk = ds^T q and dv = p^T do over the live q tiles of one q
// head; without GQA written as dk, dv, else as f32 shares [group][B, Hkv,
// Sk, D] (dK's, then dV's) in `ws` for flash_f32_bwd_dkv_sum_kernel.
// Grid: (kv tiles, Hq, B).
template <int D>
struct DkvArgs {
  const float *q, *k, *v, *dO, *lse, *di;
  float *dk, *dv, *ws;
  int Hq, Hkv, Sq, Sk;
  float scale;
  int causal, window;
};

template <int D>
struct DkvBlock {
  using TL = KvTile<D>;
  static constexpr int NTH = TL::NW * 32, BN = TL::NW * 16, BM = TL::BM;
  static constexpr int L = D + 4, NS = BM / 8, NO = D / 8;
  static constexpr bool PRE = TL::PRE;
  float *sK, *sKs, *sV, *sVs, *sQ, *sQs, *sO, *sOs, *sLse, *sDi;
  int g, t, r, kv_lo, kpos0, kpos1, t_lo, t_hi;
  size_t row0, kvoff;

  // dV += P^T dO and dK += dS^T Q over the q tiles t_lo .. t_hi; Q(t_lo)
  // and dO(t_lo) are in flight (two commit groups)
  __device__ __forceinline__ void pass(const DkvArgs<D>& a,
                                       float (&av)[NO][4],
                                       float (&ak)[NO][4]) const {
    for (int tq = t_lo; tq <= t_hi; ++tq) {
      const int q_lo = tq * BM;
      cp_async_wait<1>();
      __syncthreads();  // Q(tq) landed
      split_rows<D, BM, NTH>(sQ, sQs, L);
      for (int i = threadIdx.x; i < BM; i += NTH) {
        const bool in = q_lo + i < a.Sq;
        sLse[i] = in ? a.lse[row0 + q_lo + i] : 0.f;
        sDi[i] = in ? a.di[row0 + q_lo + i] : 0.f;
      }
      __syncthreads();  // Q(tq) split, its lse and di in place
      // S^T = K Q^T: the warp's keys r, r + 8 against q rows 8 jn + g
      float s[NS][4];
      scores<D, NS, PRE>(s, sK, sKs, r, sQ, sQs, g, t);

      cp_async_wait<0>();
      __syncthreads();  // dO(tq) landed
      split_rows<D, BM, NTH>(sO, sOs, L);
      __syncthreads();  // dO(tq) split
      float dp[NS][4];
      scores<D, NS, PRE>(dp, sV, sVs, r, sO, sOs, g, t);
      // P^T and dS^T, lse and di per column (q row)
#pragma unroll
      for (int jn = 0; jn < NS; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * jn + 2 * t + (e & 1), qpos = q_lo + col;
          const int kpos = e < 2 ? kpos0 : kpos1;
          const float p = prob(
              s[jn][e], sLse[col],
              qpos < a.Sq && visible(qpos, kpos, a.Sk, a.causal, a.window),
              a.scale);
          s[jn][e] = p;
          dp[jn][e] = p * (dp[jn][e] - sDi[col]) * a.scale;
        }
      // dK += dS^T Q: Q's rows 8kk + 2t, 8kk + 2t + 1
      uint32_t ab[NS][4], as[NS][4];
      score_frags<NS>(dp, ab, as);
      rows_product<D, NS>(ak, ab, as, sQ, sQs, g, t);
      __syncthreads();  // every warp is done with Q(tq)
      if (tq < t_hi) {
        load_async<D, BM, NTH>(sQs, a.q + row0 * D, q_lo + BM, a.Sq);
        cp_async_commit();
      }
      // dV += P^T dO
      score_frags<NS>(s, ab, as);
      rows_product<D, NS>(av, ab, as, sO, sOs, g, t);
      __syncthreads();  // every warp is done with dO(tq)
      if (tq < t_hi) {
        load_async<D, BM, NTH>(sOs, a.dO + row0 * D, q_lo + BM, a.Sq);
        cp_async_commit();
      }
    }
  }

  // Q(t_lo) and dO(t_lo) on their way, one commit group each
  __device__ __forceinline__ void first_tiles(const DkvArgs<D>& a) const {
    if (t_lo > t_hi) return;
    load_async<D, BM, NTH>(sQs, a.q + row0 * D, t_lo * BM, a.Sq);
    cp_async_commit();
    load_async<D, BM, NTH>(sOs, a.dO + row0 * D, t_lo * BM, a.Sq);
    cp_async_commit();
  }

  // the warp's rows of a 16 x D sum: to the workspace share of head h
  // (GQA) or to out
  __device__ __forceinline__ void store(const DkvArgs<D>& a,
                                        const float (&acc)[NO][4], float* out,
                                        float* share) const {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kpos = half ? kpos1 : kpos0;
      if (kpos >= a.Sk) continue;
      const size_t at = kvoff + (size_t)kpos * D + 2 * t;
      float* dst = (share != nullptr ? share : out) + at;
#pragma unroll
      for (int jn = 0; jn < NO; ++jn)
        *reinterpret_cast<float2*>(dst + 8 * jn) =
            make_float2(acc[jn][2 * half], acc[jn][2 * half + 1]);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(KvTile<D>::NW * 32, KvTile<D>::MINB)
    flash_f32_bwd_dkv_kernel(const DkvArgs<D> a) {
  using Blk = DkvBlock<D>;
  constexpr int NTH = Blk::NTH, BN = Blk::BN, BM = Blk::BM, L = Blk::L,
                NO = Blk::NO;
  constexpr bool PRE = Blk::PRE;
  extern __shared__ float4 smem4[];
  Blk blk;
  blk.sK = reinterpret_cast<float*>(smem4);
  blk.sKs = PRE ? blk.sK + BN * L : blk.sK;  // where the raw K tile lands
  blk.sV = blk.sK + (PRE ? 2 : 1) * BN * L;
  blk.sVs = PRE ? blk.sV + BN * L : blk.sV;
  blk.sQ = blk.sV + (PRE ? 2 : 1) * BN * L;
  blk.sQs = blk.sQ + BM * L;  // where the raw Q tile lands
  blk.sO = blk.sQs + BM * L;  // dO
  blk.sOs = blk.sO + BM * L;
  blk.sLse = blk.sOs + BM * L;
  blk.sDi = blk.sLse + BM;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  blk.g = lane >> 2;
  blk.t = lane & 3;
  blk.r = warp * 16 + blk.g;
  const int group = a.Hq / a.Hkv;
  const int h = blockIdx.y, b = blockIdx.z;
  blk.kv_lo = blockIdx.x * BN;
  blk.kpos0 = blk.kv_lo + blk.r;
  blk.kpos1 = blk.kpos0 + 8;
  const int kv_hi = min(blk.kv_lo + BN, a.Sk) - 1;
  blk.kvoff = ((size_t)b * a.Hkv + h / group) * a.Sk * D;
  blk.row0 = ((size_t)b * a.Hq + h) * a.Sq;
  // q rows that see some key of this tile
  int q_min = 0, q_max = a.Sq - 1;
  if (a.causal) q_min = blk.kv_lo;
  if (a.window > 0) {
    q_max = min(q_max, kv_hi + a.window);
    if (!a.causal) q_min = max(q_min, blk.kv_lo - a.window);
  }
  blk.t_lo = q_min / BM;
  blk.t_hi = q_max >= q_min ? q_max / BM : blk.t_lo - 1;

  // K and V once, split at the start (PRE); then Q(t_lo), dO(t_lo)
  load_async<D, BN, NTH>(blk.sKs, a.k + blk.kvoff, blk.kv_lo, a.Sk);
  load_async<D, BN, NTH>(blk.sVs, a.v + blk.kvoff, blk.kv_lo, a.Sk);
  cp_async_commit();
  blk.first_tiles(a);
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (PRE) {
    split_rows<D, BN, NTH>(blk.sK, blk.sKs, L);
    split_rows<D, BN, NTH>(blk.sV, blk.sVs, L);
  }
  // (pass()'s first barrier orders the split before any read)

  const size_t n = (size_t)gridDim.z * a.Hkv * a.Sk * D;
  float* wk = a.ws != nullptr ? a.ws + (size_t)(h % group) * 2 * n : nullptr;
  float av[NO][4], ak[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[j][e] = ak[j][e] = 0.f;
  blk.pass(a, av, ak);
  blk.store(a, ak, a.dk, wk);
  blk.store(a, av, a.dv, wk != nullptr ? wk + n : nullptr);
}

// dk, dv = the sums of the group's f32 shares in `ws`, in head order.
__global__ void __launch_bounds__(NT)
    flash_f32_bwd_dkv_sum_kernel(const float* __restrict__ ws,
                                 float* __restrict__ dk,
                                 float* __restrict__ dv, size_t n,
                                 int group) {
  for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < n;
       i += (size_t)gridDim.x * NT) {
    float sk = 0.f, sv = 0.f;
    for (int g = 0; g < group; ++g) {
      sk += ws[(size_t)g * 2 * n + i];
      sv += ws[(size_t)g * 2 * n + n + i];
    }
    dk[i] = sk;
    dv[i] = sv;
  }
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* dO,
       const void* lse, const void* di, void* dq_, int B, int Hq, int Hkv,
       int Sq, int Sk, float scale, int causal, int window,
       cudaStream_t stream) {
  using TL = DqTile<D>;
  static bool done = false;
  constexpr int smem = dq_smem<D>();
  cudaError_t err = allow_smem(flash_f32_bwd_dq_kernel<D>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + 16 * TL::NW - 1) / (16 * TL::NW), Hq, B);
  flash_f32_bwd_dq_kernel<D><<<grid, TL::NW * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<float*>(dq_), Hq, Hkv, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const void* dO,
        const void* lse, const void* di, void* dk, void* dv, void* ws, int B,
        int Hq, int Hkv, int Sq, int Sk, float scale, int causal, int window,
        cudaStream_t stream) {
  using TL = KvTile<D>;
  static bool done = false;
  constexpr int smem = dkv_smem<D>();
  cudaError_t err = allow_smem(flash_f32_bwd_dkv_kernel<D>, smem, done);
  if (err != cudaSuccess) return err;
  const int group = Hq / Hkv;
  if (group > 1 && ws == nullptr) return cudaErrorInvalidValue;
  const DkvArgs<D> a{static_cast<const float*>(q),
                     static_cast<const float*>(k),
                     static_cast<const float*>(v),
                     static_cast<const float*>(dO),
                     static_cast<const float*>(lse),
                     static_cast<const float*>(di),
                     static_cast<float*>(dk),
                     static_cast<float*>(dv),
                     group > 1 ? static_cast<float*>(ws) : nullptr,
                     Hq, Hkv, Sq, Sk, scale, causal, window};
  const dim3 grid((Sk + 16 * TL::NW - 1) / (16 * TL::NW), Hq, B);
  flash_f32_bwd_dkv_kernel<D><<<grid, TL::NW * 32, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || group == 1) return err;
  const size_t n = (size_t)B * Hkv * Sk * D;
  const size_t want = (n + NT - 1) / NT;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  flash_f32_bwd_dkv_sum_kernel<<<blocks, NT, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(dk),
      static_cast<float*>(dv), n, group);
  return cudaGetLastError();
}

}  // namespace

// As aule_flash_bwd_dq's arguments without o and dlse (delta carries the
// lse cotangent); f32 only (dtype 2) at D 64/128/256.
extern "C" int aule_flash_f32_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dO,
                                     const void* lse, const void* di,
                                     void* dq_, int B, int Hq, int Hkv,
                                     int Sq, int Sk, int D, float scale,
                                     int causal, int window, int dtype,
                                     void* stream) {
  if (dtype != kF32) return cudaErrorInvalidValue;
  if (Sq <= 0 || B <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dq<64>(q, k, v, dO, lse, di, dq_, B, Hq, Hkv, Sq, Sk, scale,
                    causal, window, s);
    case 128:
      return dq<128>(q, k, v, dO, lse, di, dq_, B, Hq, Hkv, Sq, Sk, scale,
                     causal, window, s);
    case 256:
      return dq<256>(q, k, v, dO, lse, di, dq_, B, Hq, Hkv, Sq, Sk, scale,
                     causal, window, s);
  }
  return cudaErrorInvalidValue;
}

// ws: f32 workspace of 2 * (Hq / Hkv) * B * Hkv * Sk * D floats when
// Hq > Hkv (the group's shares of dK and dV), else null.  D 64 or 128 (D
// 256 runs flash_generic.cu's FFMA dK/dV).
extern "C" int aule_flash_f32_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* dO,
                                      const void* lse, const void* di,
                                      void* dk, void* dv, void* ws, int B,
                                      int Hq, int Hkv, int Sq, int Sk, int D,
                                      float scale, int causal, int window,
                                      int dtype, void* stream) {
  if (dtype != kF32) return cudaErrorInvalidValue;
  if (Sk <= 0 || B <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dkv<64>(q, k, v, dO, lse, di, dk, dv, ws, B, Hq, Hkv, Sq, Sk,
                     scale, causal, window, s);
    case 128:
      return dkv<128>(q, k, v, dO, lse, di, dk, dv, ws, B, Hq, Hkv, Sq, Sk,
                      scale, causal, window, s);
  }
  return cudaErrorInvalidValue;
}
