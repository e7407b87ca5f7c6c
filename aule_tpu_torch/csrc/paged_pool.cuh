// The paged pools as the f32 paged kernels read them (paged_generic.cuh's
// decode, paged_prefill_f32.cu's prefill): the two layouts, where a token's
// row and scale lie, and a 16-byte chunk of a row in f32.  Each source
// includes it once (internal linkage).
#pragma once

#include "common.cuh"

namespace {

using namespace aule;

// The pool layouts (the decode's L).  Their names tell the kernels apart
// in a profiler's list, and from paged_decode.cu's FusedPool / SplitPools.
struct FusedLayout {
  static constexpr bool kSplit = false;
};
struct SplitLayout {
  static constexpr bool kSplit = true;
};

// Where a pool's rows and scales lie.
struct Pool {
  const uint8_t* kv;  // the fused pool, or the split K pool
  const uint8_t* v;   // the split V pool (null for a fused pool)
  const void* sc;     // the packed tile, or the split K scales (quantized)
  const float* vs;    // the split V scales (null for a fused pool)
  int sc_f32, Hkv, num_pages, page_size;
};

// A stored row: ESZ-byte values BYTES apart (D values, padded to 128
// lanes in a fused pool), of which the CPR 16-byte chunks holding the D
// values are read.
template <typename T, int POOL, int D, typename L>
struct Row {
  static constexpr int ESZ = POOL == kPoolNative ? (int)sizeof(T) : 1;
  static constexpr int BYTES = (L::kSplit ? D : (D + 127) / 128 * 128) * ESZ;
  static constexpr int CPR = D * ESZ / 16;
};

// Index of the row (in rows of the pool's row size) of K (kvsel 0) or V of
// token `slot` of page `page`, kv head hk.  Split pools keep K and V in two
// tensors of the same shape.
template <typename L>
__device__ __forceinline__ size_t row_index(const Pool& p, size_t page,
                                            int slot, int hk, int kvsel) {
  if constexpr (L::kSplit)
    return ((size_t)hk * p.num_pages + page) * p.page_size + slot;
  else
    return ((page * 2 + kvsel) * p.Hkv + hk) * p.page_size + slot;
}

// The K (kvsel 0) or V scale of that token, f32.
template <typename L>
__device__ __forceinline__ float row_scale(const Pool& p, size_t page,
                                           int slot, int hk, int kvsel) {
  if constexpr (L::kSplit) {
    const float* s = kvsel ? p.vs : static_cast<const float*>(p.sc);
    return __ldg(s + ((size_t)hk * p.num_pages + page) * p.page_size + slot);
  } else {
    return load_scale(p.sc,
                      (page * p.page_size + slot) * kScaleLanes +
                          kvsel * kScaleKVStride + hk,
                      p.sc_f32);
  }
}

// One 16-byte chunk of a row -> its values in f32, exactly.
template <typename T, int POOL>
__device__ __forceinline__ void chunk_to_float(const uint4& w, float* f) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  if constexpr (POOL != kPoolNative) {
#pragma unroll
    for (int i = 0; i < 4; ++i) payload4_to_float<POOL>(u[i], f + 4 * i);
  } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(u[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = Elem<T>::to_float2(u[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
}

// Page and slot of token `tok` through one sequence's table (-1 -> 0).
__device__ __forceinline__ void locate(const int* bt, int tok, int ps,
                                       size_t& page, int& slot) {
  const int lp = tok / ps;
  slot = tok - lp * ps;
  page = (size_t)max(__ldg(bt + lp), 0);
}

}  // namespace
