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
// 3.35 TB/s): tensor-core bound, like the flash forward it starts from
// (csrc/flash_fwd.cu).  The design:
//   * one block per (sequence, kv head, q tile) holds up to 8 q heads of a
//     GQA group (128 rows = heads x positions), so each K/V tile is read
//     once per group;
//   * the K/V tile loader follows the block table: a 64-key tile is 64
//     token rows, each one contiguous run of the page's per-head slab
//     kv_pages[phys, 0|1, h], loaded with 16-byte cp.async and
//     double-buffered; rows past len are zero-filled;
//   * tiles past the q tile's last visible position and, with a window,
//     before its first are never loaded;
//   * QK^T, the online softmax and PV are the flash block's
//     (common.cuh `flash_tile` / `flash_store`, shared with flash_fwd.cu):
//     mma.sync m16n8k16 (bf16 or f16 in, f32 accumulate) with P in
//     registers; this kernel adds its loader, scales and positional mask;
//   * int8 and e4m3 pools load their 1-byte payload (half the bytes of a
//     16-bit tile) and convert it once per tile in shared memory to the q
//     type, exactly (int8 -> float -> bf16/f16; e4m3 -> f16 with
//     cvt.rn.f16x2.e4m3x2, then to bf16 through f32 when q is bf16), so
//     the product code is the 16-bit one.  That pass costs one extra
//     shared-memory round trip per tile; building the mma fragments
//     straight from the 1-byte tile is later performance work, as are
//     wgmma and TMA.

#include "common.cuh"

namespace {

using namespace aule;

constexpr int D = kTileD;
constexpr int BN = kTileN;         // keys per K/V tile
constexpr int ROWS = 128;          // q rows per block: heads x positions
constexpr int NWARPS = 8;          // 16 rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROW_BYTES = kRowBytes;      // one 16-bit row
constexpr int CHUNKS = D / 8;             // 16-byte chunks per 16-bit row
constexpr int ROW8_BYTES = D;             // one 1-byte payload row
constexpr int CHUNKS8 = D / 16;           // 16-byte chunks per payload row
constexpr int Q_BYTES = ROWS * ROW_BYTES;
constexpr int TILE16 = 2 * BN * ROW_BYTES;  // K and V tiles, 16-bit
constexpr int TILE8 = 2 * BN * ROW8_BYTES;  // K and V tiles, 1-byte payload
constexpr int SC_CHUNKS = 2 * BN * 16;      // each key's 16-byte K, V chunk
// native pools: Q | 2 x 16-bit tiles
constexpr int SMEM_NATIVE = Q_BYTES + 2 * TILE16;
// quantized: Q | converted 16-bit tile | 2 x payload | 2 x scale chunks |
// the tile's scales as f32 [2][BN]
constexpr int SMEM_QUANT =
    Q_BYTES + TILE16 + 2 * TILE8 + 2 * SC_CHUNKS + 2 * BN * 4;

__device__ __forceinline__ uint32_t swz8(int r, int c) {
  return r * ROW8_BYTES + ((c ^ (r & 7)) << 4);
}

// four payload bytes -> four q-type values, exact
template <typename T, int POOL>
__device__ __forceinline__ uint2 convert4(uint32_t w) {
  float f[4];
  payload4_to_float<POOL>(w, f);
  return make_uint2(Elem<T>::pack(f[0], f[1]), Elem<T>::pack(f[2], f[3]));
}

// q, o: [B, Hq, Sq, D]; kv: [P, 2, Hkv, page, D] bytes; lse: [B, Hq, Sq]
// or null.  Grid: (q tiles, Hkv * group / hpb, B); hpb q heads per block.
template <typename T, int POOL>
__global__ void __launch_bounds__(NTHREADS)
    paged_prefill_kernel(const T* __restrict__ q,
                         const uint8_t* __restrict__ kv,
                         const uint8_t* __restrict__ sc, int sc_f32,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ context_lens,
                         const int* __restrict__ q_offsets,
                         T* __restrict__ o, float* __restrict__ lse, int Hq,
                         int Hkv, int Sq, int page_size, int max_pages,
                         int hpb, float scale, int causal, int window) {
  constexpr bool QUANT = POOL != kPoolNative;
  constexpr int ESZ = QUANT ? 1 : 2;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sT = sQ + Q_BYTES;  // 16-bit K/V tile(s) the mma reads
  const uint32_t s8 = sT + TILE16;   // quantized: payload stages
  const uint32_t sC = s8 + 2 * TILE8;  // quantized: scale-chunk stages
  float* sF = reinterpret_cast<float*>(smem + Q_BYTES + TILE16 +
                                       2 * TILE8 + 2 * SC_CHUNKS);

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

  const int len = max(0, min(context_lens[b], max_pages * page_size));
  const int off = q_offsets[b];
  const int qa_lo = off + q_lo, qa_hi = off + q_hi;  // absolute positions
  const int* bt = block_tables + (size_t)b * max_pages;

  // cache positions some live row of this block can see
  int k_min = 0, k_max = len - 1;
  if (causal) k_max = min(k_max, qa_hi);
  if (window > 0) k_min = max(0, qa_lo - window);
  if (qa_lo >= len) k_max = -1;  // every row is past the context
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

  // byte offset of token `pos`'s row of head hk, K (kvsel 0) or V (1)
  auto row_off = [&](int pos, int kvsel) -> size_t {
    const int phys = max(bt[pos / page_size], 0);
    return ((((size_t)phys * 2 + kvsel) * Hkv + hk) * page_size +
            pos % page_size) * D * ESZ;
  };
  auto load_kv = [&](int j, int stage) {
    const int kv0 = j * BN;
    if constexpr (!QUANT) {
      const uint32_t dst = sT + stage * TILE16;
      for (int c = tid; c < 2 * BN * CHUNKS; c += NTHREADS) {
        const int kvsel = c / (BN * CHUNKS), rc = c % (BN * CHUNKS);
        const int r = rc / CHUNKS, ch = rc % CHUNKS;
        const int pos = kv0 + r;
        const bool ok = pos < len;  // rows past len are zero-filled
        cp_async16(dst + kvsel * BN * ROW_BYTES + swz(r, ch),
                   kv + row_off(ok ? pos : 0, kvsel) + ch * 16, ok);
      }
    } else {
      const uint32_t dst = s8 + stage * TILE8;
      for (int c = tid; c < 2 * BN * CHUNKS8; c += NTHREADS) {
        const int kvsel = c / (BN * CHUNKS8), rc = c % (BN * CHUNKS8);
        const int r = rc / CHUNKS8, ch = rc % CHUNKS8;
        const int pos = kv0 + r;
        const bool ok = pos < len;
        cp_async16(dst + kvsel * BN * ROW8_BYTES + swz8(r, ch),
                   kv + row_off(ok ? pos : 0, kvsel) + ch * 16, ok);
      }
      // the aligned 16 bytes of the scale row that hold lane kv*64 + hk
      if (tid < 2 * BN) {
        const int kvsel = tid / BN, r = tid % BN;
        const int pos = kv0 + r;
        const bool ok = pos < len;
        const int p = ok ? pos : 0;
        const int lane_sc = kvsel * kScaleKVStride + hk;
        const int per16 = sc_f32 ? 4 : 8;
        const size_t elem =
            ((size_t)max(bt[p / page_size], 0) * page_size + p % page_size) *
                kScaleLanes + (lane_sc - lane_sc % per16);
        cp_async16(sC + stage * SC_CHUNKS + tid * 16,
                   sc + elem * (sc_f32 ? 4 : 2), ok);
      }
    }
  };
  if (j_lo <= j_hi) load_kv(j_lo, 0);
  cp_async_commit();

  // this warp's 16 rows; the thread holds rows g and g + 8 of them
  const int wrow0 = warp * 16;
  const int hw = wrow0 / bq;
  const int pa = q_lo + wrow0 % bq + (lane >> 2), pb = pa + 8;  // in chunk
  const int qpos_a = off + pa, qpos_b = off + pb;  // absolute positions

  WarpRows w;
  w.init();
  const float sl2 = scale * kLog2e;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int stage = (j - j_lo) & 1;
    if (j < j_hi) load_kv(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the prefetch just issued
    __syncthreads();

    uint32_t tK;
    if constexpr (!QUANT) {
      tK = sT + stage * TILE16;
    } else {
      // payload -> q type, each 16-byte chunk to two chunks of the row
      const uint8_t* src = smem + (s8 - sQ) + stage * TILE8;
      uint8_t* dst = smem + (sT - sQ);
      for (int c = tid; c < 2 * BN * CHUNKS8; c += NTHREADS) {
        const int kvsel = c / (BN * CHUNKS8), rc = c % (BN * CHUNKS8);
        const int r = rc / CHUNKS8, ch = rc % CHUNKS8;
        const uint4 u = *reinterpret_cast<const uint4*>(
            src + kvsel * BN * ROW8_BYTES + swz8(r, ch));
        const uint2 c0 = convert4<T, POOL>(u.x), c1 = convert4<T, POOL>(u.y);
        const uint2 c2 = convert4<T, POOL>(u.z), c3 = convert4<T, POOL>(u.w);
        uint8_t* row = dst + kvsel * BN * ROW_BYTES;
        *reinterpret_cast<uint4*>(row + swz(r, 2 * ch)) =
            make_uint4(c0.x, c0.y, c1.x, c1.y);
        *reinterpret_cast<uint4*>(row + swz(r, 2 * ch + 1)) =
            make_uint4(c2.x, c2.y, c3.x, c3.y);
      }
      if (tid < 2 * BN) {
        const int lane_sc = (tid / BN) * kScaleKVStride + hk;
        const uint8_t* chunk = smem + (sC - sQ) + stage * SC_CHUNKS + tid * 16;
        sF[tid] = sc_f32
                      ? reinterpret_cast<const float*>(chunk)[lane_sc % 4]
                      : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
                            chunk)[lane_sc % 8]);
      }
      __syncthreads();
      tK = sT;
    }
    const int kv0 = j * BN;

    // element mask only on tiles that straddle an edge
    const bool need_mask =
        (kv0 + BN > len) || (qa_hi >= len) ||
        (causal && kv0 + BN - 1 > qa_lo) ||
        (window > 0 && qa_hi - kv0 > window);
    auto keep = [&](int col, bool row_b) {
      const int kpos = kv0 + col, qpos = row_b ? qpos_b : qpos_a;
      bool ok = kpos < len && qpos < len;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && qpos - kpos <= window;
      return ok;
    };
    // quantized: K scales on the score columns, V scales into p (sF)
    flash_tile<T, QUANT>(w, sQ, tK, tK + BN * ROW_BYTES, wrow0, lane, sl2, sF,
                         sF + BN, need_mask, keep);
    __syncthreads();  // this stage (and the converted tile) is refilled
  }
  cp_async_wait<0>();

  flash_store<T>(w, o, lse, ((size_t)b * Hq + h0 + hw) * Sq, pa, pb, Sq, lane,
                 scale);
}

template <typename T, int POOL>
int launch(const void* q, const void* kv, const void* sc, int sc_f32,
           const void* bt, const void* lens, const void* qoff, void* o,
           void* lse, int B, int Hq, int Hkv, int Sq, int page_size,
           int max_pages, float scale, int causal, int window,
           cudaStream_t stream) {
  const int group = Hq / Hkv;
  int hpb = 8;  // q heads per block: the largest of 8, 4, 2, 1 dividing group
  while (group % hpb) hpb >>= 1;
  const int bq = ROWS / hpb;
  const int smem = POOL == kPoolNative ? SMEM_NATIVE : SMEM_QUANT;
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<T, POOL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + bq - 1) / bq, Hkv * (group / hpb), B);
  paged_prefill_kernel<T, POOL><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const uint8_t*>(kv),
      static_cast<const uint8_t*>(sc), sc_f32, static_cast<const int*>(bt),
      static_cast<const int*>(lens), static_cast<const int*>(qoff),
      static_cast<T*>(o), static_cast<float*>(lse), Hq, Hkv, Sq, page_size,
      max_pages, hpb, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
int by_pool(int pool, const void* q, const void* kv, const void* sc,
            int sc_f32, const void* bt, const void* lens, const void* qoff,
            void* o, void* lse, int B, int Hq, int Hkv, int Sq, int page_size,
            int max_pages, float scale, int causal, int window,
            cudaStream_t s) {
  switch (pool) {
    case kPoolNative:
      return launch<T, kPoolNative>(q, kv, sc, sc_f32, bt, lens, qoff, o, lse,
                                    B, Hq, Hkv, Sq, page_size, max_pages,
                                    scale, causal, window, s);
    case kPoolInt8:
      return launch<T, kPoolInt8>(q, kv, sc, sc_f32, bt, lens, qoff, o, lse,
                                  B, Hq, Hkv, Sq, page_size, max_pages, scale,
                                  causal, window, s);
    case kPoolE4M3:
      return launch<T, kPoolE4M3>(q, kv, sc, sc_f32, bt, lens, qoff, o, lse,
                                  B, Hq, Hkv, Sq, page_size, max_pages, scale,
                                  causal, window, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int aule_paged_prefill(const void* q, const void* kv_pages,
                                  const void* kv_scales,
                                  const void* block_tables,
                                  const void* context_lens,
                                  const void* q_offsets, void* o, void* lse,
                                  int B, int Hq, int Hkv, int Sq,
                                  int page_size, int max_pages, float scale,
                                  int causal, int window, int dtype, int pool,
                                  int sc_f32, void* stream) {
  if (Sq <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == aule::kF16)
    return by_pool<__half>(pool, q, kv_pages, kv_scales, sc_f32, block_tables,
                           context_lens, q_offsets, o, lse, B, Hq, Hkv, Sq,
                           page_size, max_pages, scale, causal, window, s);
  return by_pool<__nv_bfloat16>(pool, q, kv_pages, kv_scales, sc_f32,
                                block_tables, context_lens, q_offsets, o, lse,
                                B, Hq, Hkv, Sq, page_size, max_pages, scale,
                                causal, window, s);
}
