// Paged decode for Hopper (sm_90a), hand-written CUDA C++, over either pool
// layout of the port (the kernel's template parameter L):
//   * FusedPool: kv_pages [P, 2, Hkv, page, D] (axis 1: 0 = K, 1 = V) with
//     the packed scale tile; replaces the TPU kernel
//     aule_tpu/ops/paged_fused.py::_fused_decode_kernel in every pool mode;
//   * SplitPools: head-major k_pages and v_pages [Hkv, P, page, D] with f32
//     scales [Hkv, P, page] each; replaces the TPU kernel
//     aule_tpu/ops/paged.py::_paged_decode_kernel (native, int8 and e4m3
//     pools; that kernel has no int8 dot-product mode).  The pools are read
//     where they lie: the JAX package's TPU route converts quantized split
//     pools to the fused layout on every call, which the port does not.
// One query token per sequence attends over its sequence's pages through
// block_tables [B, max_pages] (-1 clamps to the scratch page 0), over the
// first context_lens[b] tokens, optionally only the trailing `window` of
// them ((len - 1 - pos) < W).  A sequence with context 0 gives zeros and
// LSE -0.7 * f32max.  In both layouts one (head, page) slab [page, D] is
// contiguous, so the two differ only in where a token's rows and scales
// lie; the loop, and so the arithmetic, is the same: a bf16 split pool
// gives the bits of the same pool in the fused layout.
//
// Pool modes (common.cuh kPool*):
//   * native: the pool holds bf16 / f16, the q/out type;
//   * int8 and e4m3 with a packed scale tile sc [P, page, 128] (row = slot,
//     lane = kv * 64 + h; bf16 or f32), or split f32 scales: the payload
//     converts exactly to f32 in registers (e4m3 through
//     cvt.rn.f16x2.e4m3x2), the K scale multiplies the score, the V scale
//     multiplies p before the PV sum, and l sums the unscaled p
//     (paged_fused.py:349-447, paged.py:222-223, 250-251);
//   * int8 dot products (fused int8 pools, the JAX package's int8_matmul
//     default):
//     q arrives quantized per row (int8 plus qf = q scale x softmax scale,
//     from the wrapper, as paged_fused.py:549-560); the score is __dp4a over
//     int8 K with exact int32 sums, times qf * K scale; p * V scale is
//     quantized per row to int8 over SPAN = 4 consecutive tokens (each
//     half-warp's step below: tokens t_lo + 4j .. t_lo + 4j + 3) and the PV
//     sum is __dp4a over int8 V, exact in int32, times span max / 127.  The
//     JAX kernel quantizes p over ppcb * page tokens instead; the plain
//     version (ops/paged_fused.py) mirrors this kernel's span.
//
// What bounds it on the H100: every live K and V byte is read once and
// used for a handful of operations, so it is memory bound.  At B8 ctx4096
// Hkv8 D128 the live KV is 134 MB per layer in bf16 (40 us at 3.35 TB/s),
// 67 MB of int8 or e4m3 payload plus 1.0 MB of the bf16 scales a token
// needs in the fused tile (20.4 us), or plus 2.1 MB of f32 split scales
// (20.7 us).
// What the design does about it:
//   * one block per (sequence, kv head) reads that head's K/V slabs of
//     each page once and serves all Hq/Hkv q rows of the GQA group from
//     them (the group's q rows sit pre-scaled in registers);
//   * each half-warp reads one token row per load (16 bytes a lane of a
//     16-bit row, 8 bytes a lane of a 1-byte payload row; neighbouring
//     lanes on neighbouring addresses) and keeps four tokens of K and four
//     of V in flight; 8 warps per block keep 16 independent streams going;
//   * each half-warp runs its own f32 online softmax over the tokens it
//     owns, and the 16 partial states merge once at the end;
//   * the trailing window skips the dead front of the sequence entirely.
// At B8 x Hkv8 this is only 64 blocks for 132 SMs, so one block per SM and
// half the card idle: a split-KV (flash-decoding) pass that spreads one
// sequence over several blocks and merges their (m, l, acc) is the later
// performance PR's work.  The scale of each token is read by all 16 lanes
// of the half-warp (one broadcast load); the 8-byte payload loads reach
// half the bytes per instruction of the 16-bit path.

#include "common.cuh"

namespace {

using namespace aule;

constexpr int D = 128;          // head dim: 16 lanes x 8 elements
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int NWORKERS = NWARPS * 2;  // half-warps
constexpr int TPW = 4;                // tokens per half-warp per step (SPAN)

// A lane's 8 elements of one token row: 16 bytes of a 16-bit pool, 8 bytes
// of a 1-byte payload.
template <int POOL>
struct Raw {
  using type = uint2;
};
template <>
struct Raw<kPoolNative> {
  using type = uint4;
};

template <typename T, int POOL, typename R>
__device__ __forceinline__ void to_float8(const R& u, float* f) {
  if constexpr (POOL == kPoolNative) {
    float2 a = Elem<T>::to_float2(u.x), b = Elem<T>::to_float2(u.y);
    float2 c = Elem<T>::to_float2(u.z), d = Elem<T>::to_float2(u.w);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
    f[4] = c.x; f[5] = c.y; f[6] = d.x; f[7] = d.y;
  } else {
    payload4_to_float<POOL>(u.x, f);
    payload4_to_float<POOL>(u.y, f + 4);
  }
}

// shared floats for group size n: per-worker acc, q, per-worker m and l
constexpr size_t smem_floats(int n) {
  return (size_t)n * D * (NWORKERS + 1) + 2 * NWORKERS * n;
}

// The pool layouts (the kernel's L).  Their names tell the two apart in a
// profiler's kernel list.
struct FusedPool {
  static constexpr bool kSplit = false;
};
struct SplitPools {
  static constexpr bool kSplit = true;
};

// q, out: [B, Hq, D] (q int8 in the int8-dot mode, with qf [B, Hq]);
// lse: [B, Hq] or null.  FusedPool: kv [P, 2, Hkv, page, D] bytes, sc the
// packed tile [P, page, 128] (bf16 or f32 by sc_f32) or null; v_pages,
// v_scales and num_pages unused.  SplitPools: kv the K pool and v_pages the
// V pool [Hkv, P, page, D] bytes, sc and v_scales their f32 scales
// [Hkv, P, page] or null.  Grid: (Hkv, B).  G = Hq / Hkv.
template <typename T, int POOL, int G, typename L>
__global__ void __launch_bounds__(NTHREADS)
    paged_decode_kernel(const void* __restrict__ q,
                        const float* __restrict__ qf,
                        const uint8_t* __restrict__ kv,
                        const uint8_t* __restrict__ v_pages,
                        const void* __restrict__ sc,
                        const float* __restrict__ v_scales, int sc_f32,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ context_lens,
                        T* __restrict__ out, float* __restrict__ lse, int Hkv,
                        int num_pages, int page_size, int max_pages,
                        float scale, int window) {
  using R = typename Raw<POOL>::type;
  constexpr int ESZ = (POOL == kPoolNative) ? 2 : 1;  // bytes per element
  constexpr bool QUANT = POOL != kPoolNative;
  constexpr bool DOT = POOL == kPoolInt8Dot;
  extern __shared__ float sm[];
  float* s_acc = sm;                        // [NWORKERS][G][D]
  float* s_q = s_acc + NWORKERS * G * D;    // [G][D]
  float* s_m = s_q + G * D;                 // [NWORKERS][G]
  float* s_l = s_m + NWORKERS * G;          // [NWORKERS][G]

  const int hk = blockIdx.x, b = blockIdx.y;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, d0 = (lane & 15) * 8;
  const int worker = warp * 2 + half;
  const float sl2 = scale * kLog2e;
  const size_t row0 = (size_t)b * Hq + (size_t)hk * G;

  // q rows of the group: f32 pre-scaled by scale*log2(e), or int8 codes
  // with their factor qf*log2(e)
  float qr[G][8];
  int qi[G][2];
  float qs[G];
  if constexpr (DOT) {
    const int8_t* qb = static_cast<const int8_t*>(q) + row0 * D + d0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const uint2 w = *reinterpret_cast<const uint2*>(qb + g * D);
      qi[g][0] = static_cast<int>(w.x);
      qi[g][1] = static_cast<int>(w.y);
      qs[g] = qf[row0 + g] * kLog2e;
    }
  } else {
    const T* qb = static_cast<const T*>(q) + row0 * D;
    for (int i = tid; i < G * D; i += NTHREADS)
      s_q[i] = Elem<T>::to_float(qb[i]) * sl2;
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] = s_q[g * D + d0 + e];
  }

  const int len =
      max(0, min(context_lens[b], max_pages * page_size));
  const int t_lo = window > 0 ? max(0, len - window) : 0;
  const int* bt = block_tables + (size_t)b * max_pages;
  const size_t page_elems = (size_t)2 * Hkv * page_size * D;
  const size_t head_off = (size_t)hk * page_size * D + d0;
  const size_t v_off = (size_t)Hkv * page_size * D;
  // split pools: row 0 of this head's page 0 (rows count tokens)
  const size_t head_row0 = (size_t)hk * num_pages * page_size;

  float acc[G][8], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  // warp-uniform walk: each warp takes 2 x TPW consecutive tokens per step
  for (int wbase = t_lo + warp * 2 * TPW; wbase < len;
       wbase += NWARPS * 2 * TPW) {
    const int base = wbase + half * TPW;
    R kr[TPW], vr[TPW];
    float ksc[TPW], vsc[TPW];
    bool ok[TPW];
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int tok = base + i;
      ok[i] = tok < len;
      kr[i] = R{};
      vr[i] = R{};
      ksc[i] = vsc[i] = 0.f;
      if (ok[i]) {
        const int page = max(bt[tok / page_size], 0);
        const int slot = tok % page_size;
        if constexpr (L::kSplit) {
          const size_t row = head_row0 + (size_t)page * page_size + slot;
          const size_t off = (row * D + d0) * ESZ;
          kr[i] = __ldg(reinterpret_cast<const R*>(kv + off));
          vr[i] = __ldg(reinterpret_cast<const R*>(v_pages + off));
          if constexpr (QUANT) {
            ksc[i] = __ldg(static_cast<const float*>(sc) + row);
            vsc[i] = __ldg(v_scales + row);
          }
        } else {
          const uint8_t* p =
              kv + ((size_t)page * page_elems + head_off + (size_t)slot * D) *
                       ESZ;
          kr[i] = __ldg(reinterpret_cast<const R*>(p));
          vr[i] = __ldg(reinterpret_cast<const R*>(p + v_off * ESZ));
          if constexpr (QUANT) {
            const size_t si =
                ((size_t)page * page_size + slot) * kScaleLanes + hk;
            ksc[i] = load_scale(sc, si, sc_f32);
            vsc[i] = load_scale(sc, si + kScaleKVStride, sc_f32);
          }
        }
      }
    }

    // scores in log2 units, summed over the 16 lanes of each half-warp
    // (xor offsets stay inside it)
    float s[TPW][G];
    if constexpr (DOT) {
      int si[TPW][G];
#pragma unroll
      for (int i = 0; i < TPW; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g)
          si[i][g] = __dp4a(qi[g][0], static_cast<int>(kr[i].x),
                            __dp4a(qi[g][1], static_cast<int>(kr[i].y), 0));
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
#pragma unroll
        for (int i = 0; i < TPW; ++i)
#pragma unroll
          for (int g = 0; g < G; ++g)
            si[i][g] += __shfl_xor_sync(0xffffffffu, si[i][g], off);
#pragma unroll
      for (int i = 0; i < TPW; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[i][g] = static_cast<float>(si[i][g]) * qs[g] * ksc[i];
    } else {
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        float kf[8];
        to_float8<T, POOL>(kr[i], kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qr[g][e], kf[e], dot);
          s[i][g] = dot;
        }
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
#pragma unroll
        for (int i = 0; i < TPW; ++i)
#pragma unroll
          for (int g = 0; g < G; ++g)
            s[i][g] += __shfl_xor_sync(0xffffffffu, s[i][g], off);
      if constexpr (QUANT) {
#pragma unroll
        for (int i = 0; i < TPW; ++i)
#pragma unroll
          for (int g = 0; g < G; ++g) s[i][g] *= ksc[i];
      }
    }

    // V of the TPW tokens: f32 values, or (int8 dot) the four tokens'
    // bytes of element e gathered into one word for __dp4a
    float vf[TPW][8];
    int vt[8];
    if constexpr (DOT) {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const uint32_t w0 = w ? vr[0].y : vr[0].x, w1 = w ? vr[1].y : vr[1].x;
        const uint32_t w2 = w ? vr[2].y : vr[2].x, w3 = w ? vr[3].y : vr[3].x;
        const uint32_t t01lo = __byte_perm(w0, w1, 0x5140);  // e0, e1
        const uint32_t t23lo = __byte_perm(w2, w3, 0x5140);
        const uint32_t t01hi = __byte_perm(w0, w1, 0x7362);  // e2, e3
        const uint32_t t23hi = __byte_perm(w2, w3, 0x7362);
        vt[4 * w + 0] = static_cast<int>(__byte_perm(t01lo, t23lo, 0x5410));
        vt[4 * w + 1] = static_cast<int>(__byte_perm(t01lo, t23lo, 0x7632));
        vt[4 * w + 2] = static_cast<int>(__byte_perm(t01hi, t23hi, 0x5410));
        vt[4 * w + 3] = static_cast<int>(__byte_perm(t01hi, t23hi, 0x7632));
      }
    } else {
#pragma unroll
      for (int i = 0; i < TPW; ++i) to_float8<T, POOL>(vr[i], vf[i]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int i = 0; i < TPW; ++i)
        if (ok[i]) mx = fmaxf(mx, s[i][g]);
      const float alpha = (mx == -INFINITY) ? 1.f : exp2f(m[g] - mx);
      float p[TPW], psum = 0.f;
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        p[i] = ok[i] ? exp2f(s[i][g] - mx) : 0.f;
        psum += p[i];
      }
      l[g] = l[g] * alpha + psum;  // l sums the unscaled p
      m[g] = mx;
      if constexpr (DOT) {
        // p * V scale, quantized per row over this span of TPW tokens
        float pm = 0.f;
#pragma unroll
        for (int i = 0; i < TPW; ++i) {
          p[i] *= vsc[i];
          pm = fmaxf(pm, p[i]);
        }
        const float r = pm > 0.f ? 127.f / pm : 0.f;
        uint32_t pk = 0;
        // floor(p * r + 0.5) with two roundings, as the plain version
        // (no fused multiply-add)
#pragma unroll
        for (int i = 0; i < TPW; ++i)
          pk |= (static_cast<uint32_t>(
                     floorf(__fadd_rn(__fmul_rn(p[i], r), 0.5f))) &
                 0xFFu)
                << (8 * i);
        const float deq = pm * (1.f / 127.f);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[g][e] = acc[g][e] * alpha +
                      static_cast<float>(__dp4a(static_cast<int>(pk), vt[e],
                                                0)) * deq;
      } else {
        if constexpr (QUANT) {
#pragma unroll
          for (int i = 0; i < TPW; ++i) p[i] *= vsc[i];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float a = acc[g][e] * alpha;
#pragma unroll
          for (int i = 0; i < TPW; ++i) a = fmaf(p[i], vf[i][e], a);
          acc[g][e] = a;
        }
      }
    }
  }

  // merge the 16 half-warp states: every lane of a half-warp holds the
  // same m and l, and its own 8 columns of acc
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if ((lane & 15) == 0) {
      s_m[worker * G + g] = m[g];
      s_l[worker * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      s_acc[(worker * G + g) * D + d0 + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
    for (int w = 0; w < NWORKERS; ++w) M = fmaxf(M, s_m[w * G + g]);
    float L = 0.f, O = 0.f;
    if (M != -INFINITY) {
      for (int w = 0; w < NWORKERS; ++w) {
        const float mw = s_m[w * G + g];
        if (mw == -INFINITY) continue;
        const float c = exp2f(mw - M);
        L += s_l[w * G + g] * c;
        O += s_acc[(w * G + g) * D + d] * c;
      }
    }
    const size_t row = row0 + g;
    out[row * D + d] = Elem<T>::from_float(L > 0.f ? O / L : 0.f);
    if (lse != nullptr && d == 0)
      lse[row] = L > 0.f ? (M + log2f(L)) * kLn2 : kMaskValue;
  }
}

struct Args {
  const void* q;
  const float* qf;
  const uint8_t* kv;  // the fused pool, or the split K pool
  const uint8_t* v;   // the split V pool (null for a fused pool)
  const void* sc;     // the packed tile, or the split K scales
  const float* vs;    // the split V scales (null for a fused pool)
  int sc_f32;
  const int* bt;
  const int* lens;
  void* out;
  float* lse;
  int B, Hkv, num_pages, page_size, max_pages;
  float scale;
  int window;
  cudaStream_t stream;
};

template <typename T, int POOL, int G, typename L>
int launch(const Args& a) {
  const size_t smem = smem_floats(G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, POOL, G, L>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.Hkv, a.B);
  paged_decode_kernel<T, POOL, G, L><<<grid, NTHREADS, smem, a.stream>>>(
      a.q, a.qf, a.kv, a.v, a.sc, a.vs, a.sc_f32, a.bt, a.lens,
      static_cast<T*>(a.out), a.lse, a.Hkv, a.num_pages, a.page_size,
      a.max_pages, a.scale, a.window);
  return cudaGetLastError();
}

template <typename T, int POOL, typename L>
int by_group(int group, const Args& a) {
  switch (group) {
    case 1: return launch<T, POOL, 1, L>(a);
    case 2: return launch<T, POOL, 2, L>(a);
    case 4: return launch<T, POOL, 4, L>(a);
    case 8: return launch<T, POOL, 8, L>(a);
  }
  return cudaErrorInvalidValue;
}

// The split pools have no int8 dot-product mode (nor has the TPU kernel
// they replace).
template <typename T, typename L>
int by_pool(int pool, int group, const Args& a) {
  switch (pool) {
    case kPoolNative: return by_group<T, kPoolNative, L>(group, a);
    case kPoolInt8: return by_group<T, kPoolInt8, L>(group, a);
    case kPoolE4M3: return by_group<T, kPoolE4M3, L>(group, a);
    case kPoolInt8Dot:
      if constexpr (!L::kSplit) return by_group<T, kPoolInt8Dot, L>(group, a);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename L>
int by_dtype(int dtype, int group, int pool, const Args& a) {
  if (a.B <= 0) return cudaSuccess;
  if (dtype == aule::kF16) return by_pool<__half, L>(pool, group, a);
  return by_pool<__nv_bfloat16, L>(pool, group, a);
}

}  // namespace

// q: [B, Hq, D] in the out type (int8 codes in the int8-dot mode, with
// qf [B, Hq] f32 = per-row q scale x softmax scale; qf null otherwise).
extern "C" int aule_paged_decode(const void* q, const void* qf,
                                 const void* kv_pages, const void* kv_scales,
                                 const void* block_tables,
                                 const void* context_lens, void* out,
                                 void* lse, int B, int Hq, int Hkv,
                                 int page_size, int max_pages, float scale,
                                 int window, int dtype, int pool, int sc_f32,
                                 void* stream) {
  const Args a{q, static_cast<const float*>(qf),
               static_cast<const uint8_t*>(kv_pages), nullptr, kv_scales,
               nullptr, sc_f32, static_cast<const int*>(block_tables),
               static_cast<const int*>(context_lens), out,
               static_cast<float*>(lse), B, Hkv, 0, page_size, max_pages,
               scale, window, static_cast<cudaStream_t>(stream)};
  return by_dtype<FusedPool>(dtype, Hq / Hkv, pool, a);
}

// Split pools: q, out [B, Hq, D] in the out type; k_pages, v_pages
// [Hkv, num_pages, page, D] (the out type, or int8 / e4m3 payloads with
// f32 k_scales, v_scales [Hkv, num_pages, page]; null otherwise).
extern "C" int aule_paged_decode_split(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* context_lens, void* out, void* lse, int B, int Hq, int Hkv,
    int num_pages, int page_size, int max_pages, float scale, int window,
    int dtype, int pool, void* stream) {
  const Args a{q, nullptr, static_cast<const uint8_t*>(k_pages),
               static_cast<const uint8_t*>(v_pages), k_scales,
               static_cast<const float*>(v_scales), 1,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(context_lens), out,
               static_cast<float*>(lse), B, Hkv, num_pages, page_size,
               max_pages, scale, window, static_cast<cudaStream_t>(stream)};
  return by_dtype<SplitPools>(dtype, Hq / Hkv, pool, a);
}
