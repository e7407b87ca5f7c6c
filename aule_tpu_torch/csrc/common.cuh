// Shared device helpers for the port's hand-written Hopper kernels.
// Built with nvcc for sm_90a into one shared library with a plain C
// interface (see aule_tpu_torch/ops/_build.py); no PyTorch headers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace aule {

// Masked-score fill / LSE of a fully masked row (aule_tpu/ops/flash.py:43).
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// dtype codes passed from Python: 0 = bfloat16, 1 = float16
constexpr int kBF16 = 0;
constexpr int kF16 = 1;

// pool modes passed from Python (ops/_build.py POOL_*): what the paged
// pools hold and how the kernels read it
constexpr int kPoolNative = 0;  // the q/out type (bf16 or f16)
constexpr int kPoolInt8 = 1;    // int8 payload + scales, converted exactly
constexpr int kPoolE4M3 = 2;    // e4m3 payload + scales, converted exactly
constexpr int kPoolInt8Dot = 3; // int8 payload + scales, int8 q, int8 dot
                                // products (paged decode only)

// Packed scale tile [P, page, 128]: row = slot, lane = kv * 64 + h.
constexpr int kScaleLanes = 128;
constexpr int kScaleKVStride = 64;

// The flash and paged-prefill head dim: D = 128 16-bit values per row.
constexpr int kTileD = 128;
constexpr int kRowBytes = kTileD * 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `c` of row `r` in a tile of 256-byte rows:
// chunks are XOR-swizzled by the row's low 3 bits so 8 consecutive rows at
// one logical chunk hit 8 different bank groups.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// Four payload bytes (little-endian in `w`) to four floats, exactly.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = static_cast<float>(static_cast<int8_t>(w >> (8 * i)));
}

// e4m3 -> f16 with the card's cvt.rn.f16x2.e4m3x2 (exact: every e4m3 value
// is an f16 value), then f16 -> f32 (exact).
__device__ __forceinline__ void e4m3x4_to_float(uint32_t w, float* f) {
  const __half2_raw lo = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w & 0xFFFFu), __NV_E4M3);
  const __half2_raw hi = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3);
  const float2 a = __half22float2(__half2(lo));
  const float2 b = __half22float2(__half2(hi));
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

template <int POOL>
__device__ __forceinline__ void payload4_to_float(uint32_t w, float* f) {
  if constexpr (POOL == kPoolE4M3)
    e4m3x4_to_float(w, f);
  else
    int8x4_to_float(w, f);
}

__device__ __forceinline__ uint32_t mul_x2(uint32_t a, uint32_t b,
                                           bool f16) {
  uint32_t d;
  if (f16)
    asm("mul.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  else
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Four payload bytes (little-endian in `w`) -> four q-type values, exactly,
// with byte permutes, logic and one add or multiply per pair (the 1-byte
// pools of paged_prefill.cu and paged_decode.cu).
template <typename T, int POOL>
__device__ __forceinline__ uint2 convert4(uint32_t w) {
  constexpr bool F16 = std::is_same<T, __half>::value;
  if constexpr (POOL == kPoolInt8) {
    const uint32_t u = w ^ 0x80808080u;  // x + 128 per byte, unsigned
    if constexpr (F16) {
      // f16 0x64uu = 1024 + u, minus 1152 (0x6480): x
      uint32_t lo = __byte_perm(u, 0x64646464u, 0x5140);
      uint32_t hi = __byte_perm(u, 0x64646464u, 0x7362);
      asm("sub.rn.f16x2 %0, %0, %1;\n" : "+r"(lo) : "r"(0x64806480u));
      asm("sub.rn.f16x2 %0, %0, %1;\n" : "+r"(hi) : "r"(0x64806480u));
      return make_uint2(lo, hi);
    } else {
      // f32 0x4B0000uu = 2^23 + u, minus 2^23 + 128: x, whose low 16 bits
      // are zero, so its bf16 is its upper half
      uint32_t f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f[i] = __float_as_uint(
            __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
            8388736.f);
      return make_uint2(__byte_perm(f[0], f[1], 0x7632),
                        __byte_perm(f[2], f[3], 0x7632));
    }
  } else {
    // e4m3 s.eeee.mmm, each byte to the top of a 16-bit lane; sign kept,
    // exponent and mantissa moved to the top of the q type's fields, then
    // times 2^(bias difference): 2^8 into f16 (bias 15), 2^120 into bf16
    const uint32_t v01 = __byte_perm(w, 0, 0x1404);
    const uint32_t v23 = __byte_perm(w, 0, 0x3424);
    const int sh = F16 ? 1 : 4;
    const uint32_t em = F16 ? 0x3F803F80u : 0x07F007F0u;
    const uint32_t two = F16 ? 0x5C005C00u : 0x7B807B80u;
    return make_uint2(
        mul_x2((v01 & 0x80008000u) | ((v01 >> sh) & em), two, F16),
        mul_x2((v23 & 0x80008000u) | ((v23 >> sh) & em), two, F16));
  }
}

// One scale of the packed tile, bf16 (sc_f32 = 0) or f32 (sc_f32 = 1).
__device__ __forceinline__ float load_scale(const void* sc, size_t i,
                                            int sc_f32) {
  return sc_f32 ? __ldg(static_cast<const float*>(sc) + i)
                : __bfloat162float(static_cast<const __nv_bfloat16*>(sc)[i]);
}

// 16-byte global->shared async copy; src_bytes = 0 zero-fills the slot.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-bit element helpers, one specialisation per storage type.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  __device__ __forceinline__ static float2 to_float2(uint32_t v) {
    __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
    return __bfloat1622float2(h);
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ __forceinline__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
  // D(16x8 f32) += A(16x16) * B(16x8), bf16 inputs, f32 accumulation
  __device__ __forceinline__ static void mma(float* d, uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
};

template <>
struct Elem<__half> {
  __device__ __forceinline__ static float2 to_float2(uint32_t v) {
    __half2 h = *reinterpret_cast<__half2*>(&v);
    return __half22float2(h);
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ __forceinline__ static float to_float(__half x) {
    return __half2float(x);
  }
  __device__ __forceinline__ static __half from_float(float x) {
    return __float2half(x);
  }
  __device__ __forceinline__ static void mma(float* d, uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
};

// ---- Fused RoPE on 16-bit tiles in shared memory (flash_fwd.cu and
// flash_fwd_short.cu; aule_tpu/ops/flash.py:227-246): the half-split
// rotation x1' = x1 cos - x2 sin, x2' = x1 sin + x2 cos of eight value
// pairs, x1 the 16-byte chunk at shared address `lo` (values d .. d + 7 of
// a row), x2 the chunk at `hi` (values d + D/2 ..), by the angles of eight
// table entries (`RopeAngles`, f32); in f32, rounded back to T in place,
// as the TPU kernel rounds its rotated tiles.  Each product is rounded
// before the sum (no FMA contraction), as `ops.rope.apply_rope` computes
// it, so both round to the same T values.
__device__ __forceinline__ float rot_lo(float x1, float x2, float c,
                                        float s) {
  return __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
}

__device__ __forceinline__ float rot_hi(float x1, float x2, float c,
                                        float s) {
  return __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c));
}

// cos and sin of eight consecutive table entries (16-byte aligned rows)
struct RopeAngles {
  float4 c[2], s[2];
  __device__ __forceinline__ void load(const float* cs, const float* sn) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c[h] = __ldg(reinterpret_cast<const float4*>(cs) + h);
      s[h] = __ldg(reinterpret_cast<const float4*>(sn) + h);
    }
  }
};

// Eight value pairs in registers: a holds x1 (8 T values), b x2; both are
// rotated in place (rope_chunks in shared memory, rope_prepass.cu in
// device memory: the same roundings).
template <typename T>
__device__ __forceinline__ void rope_regs(uint32_t (&a)[4], uint32_t (&b)[4],
                                          const RopeAngles& ang) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 c = ang.c[h], s = ang.s[h];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float2 x1 = Elem<T>::to_float2(a[2 * h + e]);
      const float2 x2 = Elem<T>::to_float2(b[2 * h + e]);
      const float c0 = e ? c.z : c.x, c1 = e ? c.w : c.y;
      const float s0 = e ? s.z : s.x, s1 = e ? s.w : s.y;
      a[2 * h + e] = Elem<T>::pack(rot_lo(x1.x, x2.x, c0, s0),
                                   rot_lo(x1.y, x2.y, c1, s1));
      b[2 * h + e] = Elem<T>::pack(rot_hi(x1.x, x2.x, c0, s0),
                                   rot_hi(x1.y, x2.y, c1, s1));
    }
  }
}

// The shared-memory accesses are volatile asm with no memory clobber: they
// keep their order against the barrier waits, fences and __syncthreads
// around them (volatile asm and barriers), and leave the compiler free to
// schedule the table loads.
template <typename T>
__device__ __forceinline__ void rope_chunks(uint32_t lo, uint32_t hi,
                                            const RopeAngles& ang) {
  uint32_t a[4], b[4];
  asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(lo));
  asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(hi));
  rope_regs<T>(a, b, ang);
  asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(lo),
               "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]));
  asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(hi),
               "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]));
}

// Rotates chunk pairs i = first, first + step, .. < count of a tile: chunk
// pair i sits at shared addresses `addr(i)` and `addr(i) + hi_off` and
// turns by table row pos(i) (skipped where pos(i) < 0), columns 8 (i % 8)
// .. of the [*, half] tables.
template <typename T, typename Addr, typename Pos>
__device__ __forceinline__ void rope_pairs(int first, int count, int step,
                                           uint32_t hi_off, int half,
                                           Addr addr, Pos pos,
                                           const float* rc,
                                           const float* rs) {
  for (int i = first; i < count; i += step) {
    const int p = pos(i);
    if (p < 0) continue;
    const size_t at = (size_t)p * half + 8 * (i % 8);
    RopeAngles ang;
    ang.load(rc + at, rs + at);
    rope_chunks<T>(addr(i), addr(i) + hi_off, ang);
  }
}

// The live key count of a call: kv_len (one int32 on the card, read by
// the kernel, never by the host) clamped to [0, Sk], or Sk without one.
__device__ __forceinline__ int live_keys(const int* kv_len, int Sk) {
  return kv_len != nullptr ? min(max(__ldg(kv_len), 0), Sk) : Sk;
}

// ---- mma.sync m16n8k16 fragments of swizzled tiles (256-byte rows of
// D = 128 16-bit values in shared memory, `swz`).  The thread holds rows
// g = lane / 4 ("a") and g + 8 ("b") of an accumulator's 16, and columns
// 2 * (lane % 4) + {0, 1} of each 8-column n-tile.
constexpr int kChunks = kTileD / 8;  // 16-byte chunks per row

// A fragment: rows row0 .. row0 + 15 of the tile, values kk*16 .. +15.
__device__ __forceinline__ void ldsm_a(uint32_t tile, int row0, int kk,
                                       int lane, uint32_t (&a)[4]) {
  const int lrow = lane & 7, mat = lane >> 3;
  ldsm_x4(tile + swz(row0 + lrow + (mat & 1) * 8, kk * 2 + (mat >> 1)),
          a[0], a[1], a[2], a[3]);
}

// B fragments of two 8-column n-tiles whose columns are rows n0 .. n0 + 15
// of the tile (a product with the tile transposed, as Q K^T takes K),
// contracted over values kk*16 .. +15: b[0..1] n-tile n0, b[2..3] n0 + 8.
__device__ __forceinline__ void ldsm_b(uint32_t tile, int n0, int kk,
                                       int lane, uint32_t (&b)[4]) {
  const int lrow = lane & 7, mat = lane >> 3;
  ldsm_x4(tile + swz(n0 + lrow + (mat >> 1) * 8, kk * 2 + (mat & 1)),
          b[0], b[1], b[2], b[3]);
}

// B fragments of the tile as it stands (as P V takes V): contracted over
// rows k0 .. k0 + 15, columns nd*16 .. +15 in two n-tiles.
__device__ __forceinline__ void ldsm_bt(uint32_t tile, int k0, int nd,
                                        int lane, uint32_t (&b)[4]) {
  const int lrow = lane & 7, mat = lane >> 3;
  ldsm_x4_t(tile + swz(k0 + lrow + (mat & 1) * 8, nd * 2 + (mat >> 1)),
            b[0], b[1], b[2], b[3]);
}

// d0 += A B[0..1], d1 += A B[2..3]: the two n-tiles of one x4 B load.
template <typename T>
__device__ __forceinline__ void mma_pair(float (&d0)[4], float (&d1)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
  Elem<T>::mma(d0, a[0], a[1], a[2], a[3], b[0], b[1]);
  Elem<T>::mma(d1, a[0], a[1], a[2], a[3], b[2], b[3]);
}

// Two 8-column accumulator n-tiles re-packed (rounded to T) as the A
// fragment of a product over those 16 columns.
template <typename T>
__device__ __forceinline__ void pack_a(const float (&lo)[4],
                                       const float (&hi)[4],
                                       uint32_t (&a)[4]) {
  a[0] = Elem<T>::pack(lo[0], lo[1]);
  a[1] = Elem<T>::pack(lo[2], lo[3]);
  a[2] = Elem<T>::pack(hi[0], hi[1]);
  a[3] = Elem<T>::pack(hi[2], hi[3]);
}

// ---- The flash block's per-warp work (flash_fwd_short.cu's mma.sync
// kernel).  A warp owns 16 rows of the block's Q tile and runs
// mma.sync m16n8k16 against 64-key K/V tiles, all in shared memory as
// swizzled 256-byte rows (`swz`); the thread holds rows g = lane / 4 ("a")
// and g + 8 ("b") of the warp's 16, and key columns 2 * (lane % 4) + {0, 1}
// of each 8-key n-tile.
constexpr int kTileN = 64;  // keys per K/V tile

struct WarpRows {
  float acc[kTileD / 8][4];  // O, unnormalised
  float m_a, m_b;            // running max of the raw scores
  float l_a, l_b;            // this thread's part of the row sums

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < kTileD / 8; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    m_a = m_b = -INFINITY;
    l_a = l_b = 0.f;
  }
};

// One K/V tile: S = Q K^T; where `need_mask`, scores of columns
// `keep(col, row_b)` rejects become -inf (row_b: row "b", else "a"); the
// online softmax in exp2 (sl2 = scale * log2 e folded into one FFMA); then
// O += P V with P in registers.
template <typename T, typename Keep>
__device__ __forceinline__ void flash_tile(WarpRows& w, uint32_t sQ,
                                           uint32_t tK, uint32_t tV,
                                           int wrow0, int lane, float sl2,
                                           bool need_mask, Keep keep) {
  constexpr int D = kTileD, BN = kTileN;
  const int t = lane & 3;

  // S for the warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
  float s[BN / 8][4];
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_a(sQ, wrow0, kk, lane, a);
#pragma unroll
    for (int nn = 0; nn < BN / 16; ++nn) {
      uint32_t b[4];
      ldsm_b(tK, nn * 16, kk, lane, b);
      mma_pair<T>(s[2 * nn], s[2 * nn + 1], a, b);
    }
  }
  if (need_mask) {
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!keep(nt * 8 + 2 * t + (e & 1), e >= 2)) s[nt][e] = -INFINITY;
  }

  // online softmax (scores in raw units; exp2 of s*sl2 - m*sl2)
  float mx_a = w.m_a, mx_b = w.m_b;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
    mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  // a row that has seen nothing yet keeps m = -inf: no NaN from -inf+inf
  const float alpha_a =
      (mx_a == -INFINITY) ? 1.f : exp2f((w.m_a - mx_a) * sl2);
  const float alpha_b =
      (mx_b == -INFINITY) ? 1.f : exp2f((w.m_b - mx_b) * sl2);
  const float nb_a = (mx_a == -INFINITY) ? 0.f : -mx_a * sl2;
  const float nb_b = (mx_b == -INFINITY) ? 0.f : -mx_b * sl2;
  float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    s[nt][0] = exp2f(fmaf(s[nt][0], sl2, nb_a));
    s[nt][1] = exp2f(fmaf(s[nt][1], sl2, nb_a));
    s[nt][2] = exp2f(fmaf(s[nt][2], sl2, nb_b));
    s[nt][3] = exp2f(fmaf(s[nt][3], sl2, nb_b));
    ls_a += s[nt][0] + s[nt][1];
    ls_b += s[nt][2] + s[nt][3];
  }
  w.l_a = w.l_a * alpha_a + ls_a;
  w.l_b = w.l_b * alpha_b + ls_b;
  w.m_a = mx_a;
  w.m_b = mx_b;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    w.acc[i][0] *= alpha_a;
    w.acc[i][1] *= alpha_a;
    w.acc[i][2] *= alpha_b;
    w.acc[i][3] *= alpha_b;
  }

  // O += P V: the S accumulators re-packed as A fragments
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t p[4];
    pack_a<T>(s[2 * kk], s[2 * kk + 1], p);
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t b[4];
      ldsm_bt(tV, kk * 16, nd, lane, b);
      mma_pair<T>(w.acc[2 * nd], w.acc[2 * nd + 1], p, b);
    }
  }
}

// The epilogue: reduce the row sums over the row's 4 threads, then write
// rows ra and rb (those below Sq) of o [.., Sq, D] at row_base normalised,
// and their natural-log LSE m * scale + ln l, or kMaskValue with zeros for
// a row that saw nothing.
template <typename T>
__device__ __forceinline__ void flash_store(WarpRows& w, T* o, float* lse,
                                            size_t row_base, int ra, int rb,
                                            int Sq, int lane, float scale) {
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = half ? w.l_b : w.l_a;
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = half ? rb : ra;
    if (r >= Sq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    uint32_t* orow = reinterpret_cast<uint32_t*>(o + (row_base + r) * kTileD);
#pragma unroll
    for (int i = 0; i < kTileD / 8; ++i)
      orow[i * 4 + t] = Elem<T>::pack(w.acc[i][2 * half] * inv,
                                      w.acc[i][2 * half + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[row_base + r] =
          l > 0.f ? (half ? w.m_b : w.m_a) * scale + logf(l) : kMaskValue;
  }
}

}  // namespace aule
