// Paged decode for f32 q (sm_90a): the entry point and the D = 128
// instantiations; the kernel and its design note are in paged_generic.cuh,
// D 64 and 256 in paged_generic_d64.cu and paged_generic_d256.cu.

#include "paged_generic.cuh"

namespace aule_generic {

AULE_GENERIC_DECODE_DIM(, 128);
AULE_GENERIC_DECODE_DIM(extern, 64);
AULE_GENERIC_DECODE_DIM(extern, 256);

namespace {

bool group_ok(int Hq, int Hkv) { return Hkv > 0 && Hq > 0 && Hq % Hkv == 0; }

// The q rows a decode block may take: a power of two up to kMaxGroup (the
// wrapper picks them: ops/decode_split.py generic_tile_rows, which also
// sizes the merge counters).
bool rows_ok(int rows) {
  return rows > 0 && rows <= kMaxGroup && (rows & (rows - 1)) == 0;
}

}  // namespace
}  // namespace aule_generic

// q, out [B, Hq, D] (q: int8 codes in the int8-dot mode, with qf [B, Hq]
// f32 = per-row q scale x softmax scale; qf null otherwise); dtype f32,
// the out type.  layout 0: kv the fused pool [P, 2, Hkv, page, Dpad], sc
// its packed scale tile (bf16, or f32 with sc_f32); layout 1: kv, v the
// split pools [Hkv, num_pages, page, D], sc, vs their f32 scales [Hkv,
// num_pages, page].  Scales null for native pools.  nsplit > 1: ws [B,
// Hkv, nsplit, Hq / Hkv, D + 2] f32 (uninitialised) and counters [B, Hkv,
// row tiles] int32 (ceil(G / tile_rows) row tiles; G = Hq / Hkv, any whole
// number), zero before the first call and left zero; tile_rows the q rows
// a block takes (rows_ok).
extern "C" int aule_paged_generic_decode(
    const void* q, const void* qf, const void* kv, const void* v,
    const void* sc, const void* vs, const void* block_tables,
    const void* context_lens, void* out, void* lse, void* ws, void* counters,
    int B, int Hq, int Hkv, int num_pages, int page_size, int max_pages,
    int D, float scale, int window, int nsplit, int tile_rows, int dtype,
    int pool, int sc_f32, int layout, void* stream) {
  using namespace aule_generic;
  if (B <= 0) return cudaSuccess;
  if (!group_ok(Hq, Hkv) || !rows_ok(tile_rows) || nsplit < 1 ||
      nsplit > kMaxSplits || dtype != kF32 ||
      (nsplit > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const DecodeArgs a{q,
                     static_cast<const float*>(qf),
                     static_cast<const uint8_t*>(kv),
                     static_cast<const uint8_t*>(v),
                     sc,
                     static_cast<const float*>(vs),
                     sc_f32,
                     Hkv,
                     num_pages,
                     page_size,
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
  switch (D) {
    case 64: return by_layout<64>(layout, pool, a);
    case 128: return by_layout<128>(layout, pool, a);
    case 256: return by_layout<256>(layout, pool, a);
  }
  return cudaErrorInvalidValue;
}
