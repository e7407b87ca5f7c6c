// Flash-attention forward for prompts of few tokens (sm_90a): the
// mma.sync kernel that csrc/flash_fwd.cu replaced on every other shape,
// kept where its shorter path to the first tile wins.
//
// Replaces, for those shapes, the TPU kernel
// aule_tpu/ops/flash.py::_fwd_kernel (the general FA-2 schedule): it
// computes softmax(scale * Q K^T + mask) V as flash_fwd.cu does, with the
// same masks, GQA groups, LSE and zero rows, and ops/flash.py picks it
// by the prompt length (SHORT_SQ).
//
// It also runs the bucketed decode of the SDPA patch
// (integration/patching.py): one query against K/V padded to a bucket,
// with the live length `kv_len` read from the card, so a CUDA graph can
// replay the call at any length, and fused RoPE (_fwd_kernel's rotation,
// flash.py:227-246).  Those two take the kernel's EXT instantiation; the
// plain one compiles as before.
//
// What bounds it: bytes, 0.04 us for the 0.14 MB of Q, K, V and O at
// B1 Hq32/Hkv8 S7; the call lasts the latency of one tile's loads and
// products instead (a few microseconds).  At the bucketed decode's 4096
// keys it is the K/V read, 16.8 MB at Hkv8 D128 (5.0 us), done by 8
// blocks walking 64 tiles each.  One block per (batch, kv head,
// q tile) holds all the q heads of a GQA group it can (up to 8), so the
// whole prompt is a handful of blocks; each loads its Q and 64-key K/V
// tiles with cp.async (no tensor map to fetch, no warp specialisation to
// set up) and runs mma.sync m16n8k16 through common.cuh's `flash_tile`
// and `flash_store`.

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
