// Paged decode for Hopper (sm_90a): the entry points, the dispatch over
// type and head dim, and the bf16 D = 128 instantiations; the kernel and
// its design note are in paged_decode.cuh, f16 D = 128 in
// paged_decode_f16.cu, D 64 and 256 in paged_decode_d64.cu,
// paged_decode_d256.cu and their _f16 twins.

#include "paged_decode.cuh"

namespace aule_decode {

AULE_DECODE_TYPE(, 128, __nv_bfloat16);
AULE_DECODE_TYPE(extern, 128, __half);
AULE_DECODE_TYPE(extern, 64, __nv_bfloat16);
AULE_DECODE_TYPE(extern, 64, __half);
AULE_DECODE_TYPE(extern, 256, __nv_bfloat16);
AULE_DECODE_TYPE(extern, 256, __half);

namespace {

template <typename T, typename L>
int by_dim(int D, int pool, int group, int rows, const Args& a) {
  switch (D) {
    case 64: return by_pool<T, 64, L>(pool, group, rows, a);
    case 128: return by_pool<T, 128, L>(pool, group, rows, a);
    case 256: return by_pool<T, 256, L>(pool, group, rows, a);
  }
  return cudaErrorInvalidValue;
}

template <typename L>
int by_dtype(int dtype, int D, int group, int rows, int pool,
             const Args& a) {
  if (a.B <= 0) return cudaSuccess;
  if (a.nsplit < 1 || a.nsplit > kMaxSplits ||
      (a.nsplit > 1 && (a.ws == nullptr || a.counters == nullptr)))
    return cudaErrorInvalidValue;
  if (dtype == aule::kF16) return by_dim<__half, L>(D, pool, group, rows, a);
  if (dtype == aule::kBF16)
    return by_dim<__nv_bfloat16, L>(D, pool, group, rows, a);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace aule_decode

using aule_decode::by_dtype;
using aule_decode::FusedPool;
using aule_decode::SplitPools;

// q: [B, Hq, D] in the out type (int8 codes in the int8-dot mode, with
// qf [B, Hq] f32 = per-row q scale x softmax scale; qf null otherwise), D
// 64, 128 or 256; kv_pages [P, 2, Hkv, page, D padded to 128 lanes].
// tile_rows: the q rows a block takes (by_group).  nsplit > 1: ws [B, Hkv,
// nsplit, Hq / Hkv, D + 2] f32 (uninitialised) and counters [B, Hkv, row
// tiles] int32 (ceil(G / tile_rows) row tiles; G = Hq / Hkv, any whole
// number), zero before the first call and left zero.
extern "C" int aule_paged_decode(const void* q, const void* qf,
                                 const void* kv_pages, const void* kv_scales,
                                 const void* block_tables,
                                 const void* context_lens, void* out,
                                 void* lse, void* ws, void* counters, int B,
                                 int Hq, int Hkv, int D, int page_size,
                                 int max_pages, float scale, int window,
                                 int nsplit, int tile_rows, int dtype,
                                 int pool, int sc_f32, void* stream) {
  const aule_decode::Args a{q, static_cast<const float*>(qf),
               static_cast<const uint8_t*>(kv_pages), nullptr, kv_scales,
               nullptr, sc_f32, static_cast<const int*>(block_tables),
               static_cast<const int*>(context_lens), out,
               static_cast<float*>(lse), static_cast<float*>(ws),
               static_cast<int*>(counters), B, Hkv, 0, page_size, max_pages,
               scale, window, nsplit, static_cast<cudaStream_t>(stream),
               Hkv > 0 ? Hq / Hkv : 0};
  if (Hkv <= 0 || Hq % Hkv) return cudaErrorInvalidValue;
  return by_dtype<FusedPool>(dtype, D, Hq / Hkv, tile_rows, pool, a);
}

// Split pools: q, out [B, Hq, D] in the out type, D 64, 128 or 256;
// k_pages, v_pages [Hkv, num_pages, page, D] (the out type, or int8 / e4m3
// payloads with f32 k_scales, v_scales [Hkv, num_pages, page]; null
// otherwise); ws, counters, nsplit and tile_rows as above.
extern "C" int aule_paged_decode_split(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* context_lens, void* out, void* lse, void* ws, void* counters,
    int B, int Hq, int Hkv, int D, int num_pages, int page_size,
    int max_pages, float scale, int window, int nsplit, int tile_rows,
    int dtype, int pool, void* stream) {
  const aule_decode::Args a{q, nullptr, static_cast<const uint8_t*>(k_pages),
               static_cast<const uint8_t*>(v_pages), k_scales,
               static_cast<const float*>(v_scales), 1,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(context_lens), out,
               static_cast<float*>(lse), static_cast<float*>(ws),
               static_cast<int*>(counters), B, Hkv, num_pages, page_size,
               max_pages, scale, window, nsplit,
               static_cast<cudaStream_t>(stream), Hkv > 0 ? Hq / Hkv : 0};
  if (Hkv <= 0 || Hq % Hkv) return cudaErrorInvalidValue;
  return by_dtype<SplitPools>(dtype, D, Hq / Hkv, tile_rows, pool, a);
}
