// Flash-attention forward for prompts of few tokens (sm_90a): the
// mma.sync kernel that csrc/flash_fwd.cu replaced on every other shape,
// kept where its shorter path to the first tile wins, and the split-KV
// kernel for one query.
//
// Replaces, for those shapes, the TPU kernel
// aule_tpu/ops/flash.py::_fwd_kernel (the general FA-2 schedule): both
// compute softmax(scale * Q K^T + mask) V as flash_fwd.cu does, with the
// same masks, GQA groups, LSE and zero rows, and ops/flash.py picks them
// by the query count (one query: `flash_fwd_decode_kernel`; up to SHORT_SQ:
// `flash_fwd_short_kernel`).
//
// (1) `flash_fwd_short_kernel`, 2 to 16 queries.  What bounds it: bytes,
// 0.04 us for the 0.14 MB of Q, K, V and O at B1 Hq32/Hkv8 S7; the call
// lasts the latency of one tile's loads and products instead (a few
// microseconds).  One block per (batch, kv head, q tile) holds all the q
// heads of a GQA group it can (up to 8), so the whole prompt is a handful
// of blocks; each loads its Q and 64-key K/V tiles with cp.async (no
// tensor map to fetch, no warp specialisation to set up) and runs mma.sync
// m16n8k16 through common.cuh's `flash_tile` and `flash_store`.  Fused
// RoPE (_fwd_kernel's rotation, flash.py:227-246) and a kv_len read on the
// card take the kernel's EXT instantiation; the plain one compiles as
// before.
//
// (2) `flash_fwd_decode_kernel`, one query: the bucketed decode of the SDPA
// patch (integration/patching.py), one query against K/V padded to a
// bucket with the live length `kv_len` read from the card (so a CUDA graph
// can replay the call at any length), with or without fused RoPE, at any
// GQA group.  What bounds it: the K/V read, 16.8 MB at Hkv8 D128 over 4096
// keys (5.0 us at 3.35 TB/s); the q rows of a group are a few.  The short
// kernel ran it on 8 blocks (one per kv head) walking 64 tiles each, with
// 4 of its 8 warps on padding rows (132 us on an H100).  The design is
// paged_decode.cu's over contiguous K/V:
//   * split-KV: the keys [0, len) that the query sees (kv_len, and the
//     causal or window edge of a query at position 0) of one (sequence, kv
//     head) are cut into `nsplit` ranges, one block each (grid (nsplit,
//     Hkv x row tiles, B)), by ops/decode_split.py's partition: the
//     wrapper picks nsplit from the shapes and the SM count (the padded
//     bucket is the capacity), and each block derives its range from
//     kv_len on the card; a range past kv_len loads nothing;
//   * each block streams its range through a 2-stage ring of 64 keys of K
//     and V (16-byte cp.async by all 128 threads, rows past the range
//     zero-filled, XOR-swizzled in 16-byte chunks), 3 blocks to an SM;
//   * a block takes R = 8 q rows of the GQA group (the mma rows g; rows
//     g + 8 zero, rows past the group masked; a group over 8 in row tiles
//     of 8, a grid row each), and each of the 4 warps takes 16 keys of a
//     stage: S = q K^T and O += P V on mma.sync m16n8k16 (q in registers
//     over a permuted head dim, K's rows read as 16-byte shared loads,
//     V's fragments paired from 16-byte reads of 4 rows), the online
//     softmax in exp2 with the scale folded in; the warps merge through
//     shared memory;
//   * the splits merge in the same launch: each block writes its (m, l,
//     O) to a workspace and the last block of a (sequence, kv head, row
//     tile) to arrive (a counter it resets to 0) merges them in split
//     order, so two runs give the same bits and a call is one launch;
//   * RoPE (ROPE instantiation): q is rotated once in registers (each
//     thread reads the partner half of its dims), each K stage in shared
//     memory before its products, every product rounded before the sum
//     as `apply_rope` computes it.

#include "common.cuh"

namespace {

using namespace aule;

constexpr int D = kTileD;          // head dim (the only one in this slice)
constexpr int BN = kTileN;         // keys per K/V tile
constexpr int ROWS = 128;          // q rows per block: heads x positions
constexpr int NWARPS = 8;          // 16 rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROW_BYTES = kRowBytes;  // one 16-bit row
constexpr int CHUNKS = D / 8;      // 16-byte chunks per row
constexpr int SMEM_BYTES = (ROWS + 4 * BN) * ROW_BYTES;  // Q + 2x(K,V)

// Rotates the 16-byte chunk pairs (c, c + 8) of rows 0 .. n - 1 of a tile
// of 256-byte rows (`swz`) by table row pos(r) (EXT with tables; rows with
// pos(r) < 0 or past the table stay): chunk c + 8 of a row sits 128 bytes
// past chunk c under the swizzle.
template <typename T, typename Pos>
__device__ __forceinline__ void rope_rows(uint32_t tile, int n, Pos pos,
                                          const float* rc, const float* rs,
                                          int rope_len) {
  rope_pairs<T>(
      threadIdx.x, n * 8, NTHREADS, 128, D / 2,
      [&](int i) { return tile + swz(i / 8, i % 8); },
      [&](int i) {
        const int p = pos(i / 8);
        return p < rope_len ? p : -1;
      },
      rc, rs);
}

// q, o: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D]; lse: [B, Hq, Sq] or null.
// EXT: rope tables [rope_len, D/2] f32 (or null) and kv_len, one int32 on
// the card (or null).  Grid: (q tiles, Hkv * group / hpb, B); hpb q heads
// per block.
template <typename T, bool EXT>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, const float* rc,
                     const float* rs, const int* kv_len, int Hq, int Hkv,
                     int Sq, int Sk_all, int rope_len, int hpb, float scale,
                     int causal, int window) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + ROWS * ROW_BYTES;
  const uint32_t sV = sK + 2 * BN * ROW_BYTES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = Hq / Hkv;
  const int bq = ROWS / hpb;  // q positions per block
  // heaviest causal tiles launch first, so the tail of the grid is short
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q_lo = qt * bq;
  const int q_hi = min(q_lo + bq, Sq) - 1;
  const int blocks_per_kv = group / hpb;
  const int hk = blockIdx.y / blocks_per_kv;
  const int h0 = hk * group + (blockIdx.y % blocks_per_kv) * hpb;
  const int b = blockIdx.z;

  const T* kb = k + ((size_t)b * Hkv + hk) * Sk_all * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * Sk_all * D;
  // the keys that attend: the first kv_len (EXT), else all; the rest are
  // never loaded and masked as the rows past Sk are
  const int Sk = EXT ? live_keys(kv_len, Sk_all) : Sk_all;

  // kv positions some row of this block can see
  int k_min = 0, k_max = Sk - 1;
  if (causal) k_max = min(k_max, q_hi);
  if (window > 0) {
    k_min = max(0, q_lo - window);
    if (!causal) k_max = min(k_max, q_hi + window);
  }
  const int j_lo = k_min / BN;
  const int j_hi = (k_max >= k_min) ? k_max / BN : j_lo - 1;

  // Q tile -> shared memory; block row r is (head r / bq, position r % bq)
  for (int c = tid; c < ROWS * CHUNKS; c += NTHREADS) {
    const int r = c / CHUNKS, ch = c % CHUNKS;
    const int pos = q_lo + r % bq;
    const bool ok = pos < Sq;
    const T* src =
        q + (((size_t)b * Hq + h0 + r / bq) * Sq + (ok ? pos : 0)) * D + ch * 8;
    cp_async16(sQ + swz(r, ch), src, ok);
  }
  auto load_kv = [&](int j, int stage) {
    const int kv0 = j * BN;
    const uint32_t dK = sK + stage * BN * ROW_BYTES;
    const uint32_t dV = sV + stage * BN * ROW_BYTES;
    for (int c = tid; c < BN * CHUNKS; c += NTHREADS) {
      const int r = c / CHUNKS, ch = c % CHUNKS;
      const int pos = kv0 + r;
      const bool ok = pos < Sk;  // rows past Sk are zero-filled
      const size_t off = (size_t)(ok ? pos : 0) * D + ch * 8;
      cp_async16(dK + swz(r, ch), kb + off, ok);
      cp_async16(dV + swz(r, ch), vb + off, ok);
    }
  };
  if (j_lo <= j_hi) load_kv(j_lo, 0);
  cp_async_commit();

  // this warp's 16 rows; the thread holds rows g and g + 8 of them
  const int wrow0 = warp * 16;
  const int hw = wrow0 / bq;
  const int pos0 = q_lo + wrow0 % bq;
  const int qpos_a = pos0 + (lane >> 2), qpos_b = qpos_a + 8;

  WarpRows w;
  w.init();
  const float sl2 = scale * kLog2e;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int stage = (j - j_lo) & 1;
    if (j < j_hi) load_kv(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the prefetch just issued
    __syncthreads();

    const int kv0 = j * BN;
    if constexpr (EXT) {
      if (rc != nullptr) {  // Q once, each K tile as it lands
        if (j == j_lo)
          rope_rows<T>(sQ, ROWS, [&](int r) {
            const int p = q_lo + r % bq;
            return p < Sq ? p : -1;
          }, rc, rs, rope_len);
        rope_rows<T>(sK + stage * BN * ROW_BYTES, BN,
                     [&](int r) { return kv0 + r < Sk ? kv0 + r : -1; }, rc,
                     rs, rope_len);
        __syncthreads();
      }
    }
    // element mask only on tiles that straddle an edge
    const bool need_mask =
        (kv0 + BN > Sk) || (causal && kv0 + BN - 1 > q_lo) ||
        (window > 0 &&
         (q_hi - kv0 > window || (!causal && kv0 + BN - 1 - q_lo > window)));
    auto keep = [&](int col, bool row_b) {
      const int kpos = kv0 + col, qpos = row_b ? qpos_b : qpos_a;
      bool ok = kpos < Sk;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) {
        ok = ok && qpos - kpos <= window;
        if (!causal) ok = ok && kpos - qpos <= window;
      }
      return ok;
    };
    flash_tile<T>(w, sQ, sK + stage * BN * ROW_BYTES,
                  sV + stage * BN * ROW_BYTES, wrow0, lane, sl2, need_mask,
                  keep);
    __syncthreads();  // this stage is refilled two iterations on
  }
  cp_async_wait<0>();

  flash_store<T>(w, o, lse, ((size_t)b * Hq + h0 + hw) * Sq, qpos_a, qpos_b,
                 Sq, lane, scale);
}

template <typename T, bool EXT>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* rc, const void* rs, const void* kv_len, int B, int Hq,
           int Hkv, int Sq, int Sk, int rope_len, float scale, int causal,
           int window, cudaStream_t stream) {
  const int group = Hq / Hkv;
  int hpb = 8;  // q heads per block: the largest of 8, 4, 2, 1 dividing group
  while (group % hpb) hpb >>= 1;
  const int bq = ROWS / hpb;
  // set once, so that a launch inside a CUDA-graph capture makes no
  // attribute call
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_short_kernel<T, EXT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  dim3 grid((Sq + bq - 1) / bq, Hkv * (group / hpb), B);
  flash_fwd_short_kernel<T, EXT><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      static_cast<const float*>(rc), static_cast<const float*>(rs),
      static_cast<const int*>(kv_len), Hq, Hkv, Sq, Sk, rope_len, hpb, scale,
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

// ---- (2) the one-query decode: split-KV over contiguous K/V

namespace dec {
constexpr int NW = 4;           // warps
constexpr int NT = NW * 32;
constexpr int MIN_BLOCKS = 3;   // ops/decode_split.py BLOCKS_PER_SM
constexpr int GT = 16;          // keys a warp takes per stage
constexpr int TS = NW * GT;     // keys per stage
constexpr int NST = 2;          // ring stages
constexpr int R = 8;            // q rows a block: the mma rows g
constexpr int SPAN = 4;         // ops/decode_split.py DECODE_SPAN
constexpr int kMaxSplits = 64;  // ops/decode_split.py MAX_SPLITS
constexpr int RB = D * 2;       // bytes of a row
constexpr int CPR = RB / 16;    // 16-byte chunks a row
constexpr int KV_BYTES = TS * RB;
constexpr int STAGE = 2 * KV_BYTES;
constexpr int RSTEP = NT / CPR;
constexpr int PER_THREAD = TS * CPR / NT;
constexpr int SMEM = NST * STAGE;
static_assert(NW * R * (D + 2) * 4 <= SMEM, "the warps' states fit");
static_assert((kMaxSplits * 2 + 2) * R * 4 <= SMEM, "the merge fits");

// Chunk c of row r at chunk x of its row: a K read (chunks 4t + j of rows
// g) and a V read (chunk g (+ 8) of rows 2t (+ 1, + 8, + 9)) meet no bank
// conflict (paged_decode.cu's swizzle of 16-bit rows).
__device__ __forceinline__ int offset(int r, int c) {
  int x = c ^ (r & 1) ^ (((r >> 1) & 3) << 1);
  x ^= ((c >> 3) & 1) << 1;
  return r * RB + x * 16;
}

__device__ __forceinline__ uint4 lds128(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

struct Args {
  const void* q;      // [B, Hq, 1, D]
  const void* k;      // [B, Hkv, Sk, D]
  const void* v;
  void* out;          // [B, Hq, 1, D]
  float* lse;         // [B, Hq, 1] or null
  const float* rc;    // RoPE tables [rope_len, D / 2] f32, or null
  const float* rs;
  const int* kv_len;  // one int32 on the card, or null
  float* ws;          // nsplit > 1: [B, Hkv, nsplit, G] x (D + 2) f32
  int* counters;      // nsplit > 1: [B, Hkv, row tiles] int32, 0 between calls
  int B, Hq, Hkv, Sk, rope_len;
  float scale;
  int causal, window, nsplit;
};
}  // namespace dec

// Grid (nsplit, Hkv x row tiles, B): blockIdx.y = hk * tiles + tile.
template <typename T, bool ROPE>
__global__ void __launch_bounds__(dec::NT, dec::MIN_BLOCKS)
    flash_fwd_decode_kernel(const dec::Args a) {
  using namespace dec;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_last;

  const int split = blockIdx.x, b = blockIdx.z;
  const int G = a.Hq / a.Hkv, tiles = (G + R - 1) / R;
  const int hk = blockIdx.y / tiles;
  // the tile's first row g0 of the group and its nr live rows
  const int g0 = (blockIdx.y - hk * tiles) * R;
  const int nr = min(R, G - g0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the thread's mma fragment row g and column pair 2t, 2t + 1
  const int g = lane >> 2, t = lane & 3;
  const bool row_ok = g < nr;
  const size_t row0 = (size_t)b * a.Hq + (size_t)hk * G + g0;

  // q row g as the A fragments of S = q K^T over the head dim permuted so
  // that each thread holds its 32 dims [32t, 32t + 32) in order: k-step
  // kk is dims 32t + 4kk + {0, 1} and {2, 3} (paged_decode.cu's order)
  uint32_t qa[16];
  {
    uint4 w[4] = {};
    if (row_ok) {
      const T* qr = static_cast<const T*>(a.q) + (row0 + g) * D + 32 * t;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        w[u] = *reinterpret_cast<const uint4*>(qr + 8 * u);
      if constexpr (ROPE) {
        // the query sits at position 0: table row 0 turns the pair (d,
        // d + 64), of which this thread holds one half and reads the other
        // (thread t ^ 2's dims); dims 32t .. take entries 32 (t & 1) ..
        if (a.rc != nullptr && a.rope_len > 0) {
          const T* pr = static_cast<const T*>(a.q) + (row0 + g) * D +
                        32 * (t ^ 2);
          const float* cs = a.rc + 32 * (t & 1);
          const float* sn = a.rs + 32 * (t & 1);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uint4 o = *reinterpret_cast<const uint4*>(pr + 8 * u);
            uint32_t mine[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
            const uint32_t other[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 8 * u + 2 * e;  // the pair's entry, and + 1
              const float2 xm = Elem<T>::to_float2(mine[e]);
              const float2 xo = Elem<T>::to_float2(other[e]);
              const float c0 = __ldg(cs + i), c1 = __ldg(cs + i + 1);
              const float s0 = __ldg(sn + i), s1 = __ldg(sn + i + 1);
              mine[e] = t < 2 ? Elem<T>::pack(rot_lo(xm.x, xo.x, c0, s0),
                                              rot_lo(xm.y, xo.y, c1, s1))
                              : Elem<T>::pack(rot_hi(xo.x, xm.x, c0, s0),
                                              rot_hi(xo.y, xm.y, c1, s1));
            }
            w[u] = make_uint4(mine[0], mine[1], mine[2], mine[3]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      qa[4 * u] = w[u].x;
      qa[4 * u + 1] = w[u].y;
      qa[4 * u + 2] = w[u].z;
      qa[4 * u + 3] = w[u].w;
    }
  }
  const float sfac = a.scale * kLog2e;  // scores in log2 units

  // the keys the query (position 0) sees: the first kv_len of the bucket,
  // key 0 alone when causal, keys 0 .. window with a window; this block's
  // range [s_lo, s_hi) of them (ops/decode_split.py split_bounds)
  int len = live_keys(a.kv_len, a.Sk);
  if (a.causal) len = min(len, 1);
  else if (a.window > 0) len = min(len, a.window + 1);
  const int per = (len + a.nsplit - 1) / a.nsplit;
  const int chunk = (per + SPAN - 1) / SPAN * SPAN;
  const int s_lo = split * chunk;
  const int s_hi = min(len, s_lo + chunk);
  const int ntiles = s_hi > s_lo ? (s_hi - s_lo + TS - 1) / TS : 0;
  const size_t kvoff = ((size_t)b * a.Hkv + hk) * a.Sk * D;
  const T* kb = static_cast<const T*>(a.k) + kvoff;
  const T* vb = static_cast<const T*>(a.v) + kvoff;

  // stage j: keys s_lo + j * TS + r; thread tid copies chunk tid % CPR of
  // rows tid / CPR + i * RSTEP of K and V
  const uint32_t ring = smem_u32(smem);
  const int crow = tid % CPR, r0 = tid / CPR;
  auto load_stage = [&](int j) {
    const int t0 = s_lo + j * TS;
    const uint32_t st = ring + (j % NST) * STAGE;
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int r = r0 + i * RSTEP, tok = t0 + r;
      const bool ok = tok < s_hi;  // rows past the range are zero-filled
      const size_t off = (size_t)(ok ? tok : 0) * D + crow * 8;
      const uint32_t dst = st + offset(r, crow);
      cp_async16(dst, kb + off, ok);
      cp_async16(dst + KV_BYTES, vb + off, ok);
    }
  };

  // the warp's state for row g: running max m (log2 units), this thread's
  // part of l, and O's fragments (c0, c1: row g; c2, c3: the zero rows)
  float m = -INFINITY, l = 0.f;
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < ntiles) load_stage(s);
    cp_async_commit();
  }
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // stage j landed; every thread is done with j - 1
    if (j + NST - 1 < ntiles) load_stage(j + NST - 1);
    cp_async_commit();
    const int t0 = s_lo + j * TS;
    const uint8_t* st = smem + (j % NST) * STAGE;
    if constexpr (ROPE) {
      if (a.rc != nullptr) {
        // each live row's pairs of chunks (c, c + 8) turn by the row's
        // position (the identity past the table)
        const uint32_t sk = smem_u32(st);
        for (int i = tid; i < TS * 8; i += NT) {
          const int r = i / 8, c = i % 8, pos = t0 + r;
          if (pos >= s_hi || pos >= a.rope_len) continue;
          const size_t at = (size_t)pos * (D / 2) + 8 * c;
          RopeAngles ang;
          ang.load(a.rc + at, a.rs + at);
          rope_chunks<T>(sk + offset(r, c), sk + offset(r, c + 8), ang);
        }
        __syncthreads();
      }
    }
    // the warp's GT rows rb .. rb + 15 of the stage (warp-uniform test)
    const int rb = warp * GT;
    if (t0 + rb >= s_hi) continue;

    // S = q K^T: n-tile nt holds rows rb + 8nt + 0..7 as its columns; the
    // thread reads row rb + 8nt + g (its B fragments) and holds the scores
    // of rows rb + 8nt + 2t + {0, 1}
    float sc[2][4] = {};
    {
      uint32_t kw[2][16];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int r = rb + 8 * nt + g;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint4 w = lds128(st + offset(r, 4 * t + u));
          kw[nt][4 * u] = w.x;
          kw[nt][4 * u + 1] = w.y;
          kw[nt][4 * u + 2] = w.z;
          kw[nt][4 * u + 3] = w.w;
        }
      }
      // the two n-tiles' products alternate, two independent chains
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          Elem<T>::mma(sc[nt], qa[2 * kk], 0u, qa[2 * kk + 1], 0u,
                       kw[nt][2 * kk], kw[nt][2 * kk + 1]);
    }

    // scores in log2 units, -inf past the range; the online softmax of
    // row g over its 4 threads
    float p[2][2];
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = rb + 8 * nt + 2 * t + e;
        p[nt][e] = t0 + r < s_hi ? sc[nt][e] * sfac : -INFINITY;
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
    l = l * alpha + psum;
    m = m_new;
    // P as the A fragment of O += P V: k = the stage rows 2t + {0, 1}
    // (n-tile 0) and 8 + 2t + {0, 1} (n-tile 1)
    const uint32_t pa0 = Elem<T>::pack(p[0][0], p[0][1]);
    const uint32_t pa1 = Elem<T>::pack(p[1][0], p[1][1]);
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      acc[jn][0] *= alpha;
      acc[jn][1] *= alpha;
    }
    // V's B fragments: the thread reads rows rb + 2t + {0, 1, 8, 9},
    // chunks g and 8 + g (dims 8g .. 8g + 7 and 64 + 8g ..), and pairs
    // rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) value by value: n-tile
    // jn's column g is the jn-th of them
    const int vr[4] = {rb + 2 * t, rb + 2 * t + 1, rb + 2 * t + 8,
                       rb + 2 * t + 9};
    uint32_t vw[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 lo = lds128(st + KV_BYTES + offset(vr[i], g));
      const uint4 hi = lds128(st + KV_BYTES + offset(vr[i], 8 + g));
      vw[i][0] = lo.x; vw[i][1] = lo.y; vw[i][2] = lo.z; vw[i][3] = lo.w;
      vw[i][4] = hi.x; vw[i][5] = hi.y; vw[i][6] = hi.z; vw[i][7] = hi.w;
    }
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      const uint32_t sel = (jn & 1) ? 0x7632 : 0x5410;
      const uint32_t b0 = __byte_perm(vw[0][jn / 2], vw[1][jn / 2], sel);
      const uint32_t b1 = __byte_perm(vw[2][jn / 2], vw[3][jn / 2], sel);
      Elem<T>::mma(acc[jn], pa0, 0u, pa1, 0u, b0, b1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' states take it

  // merge the warps' states: row g's m is the same in its 4 threads, l is
  // summed over them; O column (jn, c) of n-tile jn is head dim
  // dim(2t + c, jn) (the V values' order above)
  float* s_acc = reinterpret_cast<float*>(smem);  // [NW][R][D]
  float* s_m = s_acc + NW * R * D;                // [NW][R]
  float* s_l = s_m + NW * R;                      // [NW][R]
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (row_ok) {
    if (t == 0) {
      s_m[warp * R + g] = m;
      s_l[warp * R + g] = l;
    }
    float* o = s_acc + (warp * R + g) * D;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 2 * t + c;
        o[jn < 8 ? 8 * n + jn : 64 + 8 * n + jn - 8] = acc[jn][c];
      }
  }
  __syncthreads();
  // nsplit > 1: this pair's partials, [nsplit][G][D] and [nsplit][G][2],
  // from the tile's first row g0 on
  const size_t pair = (size_t)b * a.Hkv + hk;
  float* ws_acc = nullptr;
  float* ws_ml = nullptr;
  if (a.nsplit > 1) {
    ws_acc = a.ws + pair * a.nsplit * G * D + (size_t)g0 * D;
    ws_ml = a.ws + (size_t)a.B * a.Hkv * a.nsplit * G * D +
            pair * a.nsplit * G * 2 + (size_t)g0 * 2;
  }
  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < nr * D; i += NT) {
    const int gg = i / D, d = i % D;
    float M = -INFINITY;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, s_m[w * R + gg]);
    float Lsum = 0.f, O = 0.f;
    if (M != -INFINITY) {
      for (int w = 0; w < NW; ++w) {
        const float mw = s_m[w * R + gg];
        if (mw == -INFINITY) continue;
        const float c = exp2f(mw - M);
        Lsum += s_l[w * R + gg] * c;
        O += s_acc[(w * R + gg) * D + d] * c;
      }
    }
    if (a.nsplit == 1) {
      const size_t row = row0 + gg;
      out[row * D + d] = Elem<T>::from_float(Lsum > 0.f ? O / Lsum : 0.f);
      if (a.lse != nullptr && d == 0)
        a.lse[row] = Lsum > 0.f ? (M + log2f(Lsum)) * kLn2 : kMaskValue;
    } else {
      ws_acc[((size_t)split * G + gg) * D + d] = O;
      if (d == 0) {
        ws_ml[((size_t)split * G + gg) * 2] = M;
        ws_ml[((size_t)split * G + gg) * 2 + 1] = Lsum;
      }
    }
  }
  if (a.nsplit == 1) return;

  // the last block of this (sequence, kv head, row tile) to arrive merges
  // the partials in split order and resets the counter for the next call
  __threadfence();
  __syncthreads();
  const size_t cpair = (size_t)b * a.Hkv * tiles + blockIdx.y;
  if (tid == 0) {
    const int prev = atomicAdd(a.counters + cpair, 1);
    s_last = prev == a.nsplit - 1;
    if (s_last) atomicExch(a.counters + cpair, 0);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // every split's (m, l) into shared memory, then per q row the max, each
  // split's weight c = 2^(m - max) (0 for an empty split) and l's sum in
  // split order, then each output column's sum of c * O in split order
  const int ns = a.nsplit;
  float* s_pm = reinterpret_cast<float*>(smem);  // [nsplit][R] m, then c
  float* s_pl = s_pm + ns * R;                   // [nsplit][R]
  float* s_M = s_pl + ns * R;                    // [R]
  float* s_L = s_M + R;                          // [R]
  for (int i = tid; i < ns * R; i += NT) {
    const int sp = i / R, gg = i % R;
    const bool live = gg < nr;
    s_pm[i] = live ? __ldcg(ws_ml + ((size_t)sp * G + gg) * 2) : -INFINITY;
    s_pl[i] = live ? __ldcg(ws_ml + ((size_t)sp * G + gg) * 2 + 1) : 0.f;
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
  for (int i = tid; i < nr * D; i += NT) {
    const int gg = i / D, d = i % D;
    const float Lsum = s_L[gg];
    float O = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < ns; ++sp)
      O = fmaf(__ldcg(ws_acc + ((size_t)sp * G + gg) * D + d),
               s_pm[sp * R + gg], O);
    const size_t row = row0 + gg;
    out[row * D + d] = Elem<T>::from_float(Lsum > 0.f ? O / Lsum : 0.f);
    if (a.lse != nullptr && d == 0)
      a.lse[row] = Lsum > 0.f ? (s_M[gg] + log2f(Lsum)) * kLn2 : kMaskValue;
  }
}

template <typename T, bool ROPE>
int launch_decode(const dec::Args& a, cudaStream_t stream) {
  // set once, so that a launch inside a CUDA-graph capture makes no
  // attribute call
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_decode_kernel<T, ROPE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, dec::SMEM);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const int G = a.Hq / a.Hkv;
  dim3 grid(a.nsplit, a.Hkv * ((G + dec::R - 1) / dec::R), a.B);
  flash_fwd_decode_kernel<T, ROPE><<<grid, dec::NT, dec::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch_decode_any(const dec::Args& a, cudaStream_t stream) {
  return a.rc != nullptr ? launch_decode<T, true>(a, stream)
                         : launch_decode<T, false>(a, stream);
}

}  // namespace

// D: 128 only (any other is refused).  rc, rs: RoPE tables [rope_len,
// D/2] f32, or null; kv_len: one int32 on the card, or null.
extern "C" int aule_flash_fwd_short(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    const void* rc, const void* rs,
                                    const void* kv_len, int B, int Hq,
                                    int Hkv, int Sq, int Sk, int D,
                                    int rope_len, float scale, int causal,
                                    int window, int dtype, void* stream) {
  if (D != kTileD) return cudaErrorInvalidValue;
  if (Sq <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == aule::kF16)
    return launch_any<__half>(q, k, v, o, lse, rc, rs, kv_len, B, Hq, Hkv,
                              Sq, Sk, rope_len, scale, causal, window, s);
  return launch_any<__nv_bfloat16>(q, k, v, o, lse, rc, rs, kv_len, B, Hq,
                                   Hkv, Sq, Sk, rope_len, scale, causal,
                                   window, s);
}

// One query (q, out [B, Hq, 1, D], lse [B, Hq, 1] or null) over K/V [B,
// Hkv, Sk, D], D = 128; rc, rs: RoPE tables [rope_len, D/2] f32, or null;
// kv_len: one int32 on the card, or null.  nsplit > 1: ws [B, Hkv, nsplit,
// Hq / Hkv, D + 2] f32 (uninitialised) and counters [B, Hkv, ceil(G / 8)]
// int32, zero before the first call and left zero.
extern "C" int aule_flash_fwd_decode(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     const void* rc, const void* rs,
                                     const void* kv_len, void* ws,
                                     void* counters, int B, int Hq, int Hkv,
                                     int Sk, int D, int rope_len, float scale,
                                     int causal, int window, int nsplit,
                                     int dtype, void* stream) {
  if (D != kTileD || Hkv <= 0 || Hq % Hkv || nsplit < 1 ||
      nsplit > dec::kMaxSplits ||
      (nsplit > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const dec::Args a{q, k, v, o, static_cast<float*>(lse),
                    static_cast<const float*>(rc),
                    static_cast<const float*>(rs),
                    static_cast<const int*>(kv_len), static_cast<float*>(ws),
                    static_cast<int*>(counters), B, Hq, Hkv, Sk, rope_len,
                    scale, causal, window, nsplit};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == aule::kF16) return launch_decode_any<__half>(a, s);
  return launch_decode_any<__nv_bfloat16>(a, s);
}
