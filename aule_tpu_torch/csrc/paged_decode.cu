// Fused-layout paged decode for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel aule_tpu/ops/paged_fused.py::_fused_decode_kernel
// in its bf16/f16 pool mode: one query token per sequence attends over its
// sequence's pages of the fused pool kv_pages [P, 2, Hkv, page, D] (axis 1:
// 0 = K, 1 = V), through block_tables [B, max_pages] (-1 clamps to the
// scratch page 0), over the first context_lens[b] tokens, optionally only
// the trailing `window` of them ((len - 1 - pos) < W).  A sequence with
// context 0 gives zeros and LSE -0.7 * f32max.
//
// What bounds it on the H100: every live K and V byte is read once and
// used for a handful of FLOPs, so it is memory bound.  At B8 ctx4096
// Hkv8 D128 bf16 the live KV is 134 MB per layer, 40 us at 3.35 TB/s.
// What the design does about it:
//   * one block per (sequence, kv head) reads that head's K/V slabs of
//     each page once and serves all Hq/Hkv q rows of the GQA group from
//     them (the group's q rows sit pre-scaled in registers);
//   * each half-warp reads one 256-byte token row with 16-byte loads
//     (neighbouring lanes on neighbouring addresses) and keeps four
//     tokens of K and four of V in flight; 8 warps per block keep 16
//     independent streams going;
//   * each half-warp runs its own f32 online softmax over the tokens it
//     owns, and the 16 partial states merge once at the end;
//   * the trailing window skips the dead front of the sequence entirely.
// At B8 x Hkv8 this is only 64 blocks for 132 SMs, so one block per SM and
// half the card idle: a split-KV (flash-decoding) pass that spreads one
// sequence over several blocks and merges their (m, l, acc) is the later
// performance PR's work.

#include "common.cuh"

namespace {

using namespace aule;

constexpr int D = 128;          // head dim: 16 lanes x 8 elements
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int NWORKERS = NWARPS * 2;  // half-warps
constexpr int TPW = 4;                // tokens per half-warp per step

template <typename T>
__device__ __forceinline__ void to_float8(const uint4& u, float* f) {
  float2 a = Elem<T>::to_float2(u.x), b = Elem<T>::to_float2(u.y);
  float2 c = Elem<T>::to_float2(u.z), d = Elem<T>::to_float2(u.w);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  f[4] = c.x; f[5] = c.y; f[6] = d.x; f[7] = d.y;
}

// shared floats for group size n: per-worker acc, q, per-worker m and l
constexpr size_t smem_floats(int n) {
  return (size_t)n * D * (NWORKERS + 1) + 2 * NWORKERS * n;
}

// q, out: [B, Hq, D]; kv: [P, 2, Hkv, page, D]; lse: [B, Hq] or null.
// Grid: (Hkv, B).  G = Hq / Hkv.
template <typename T, int G>
__global__ void __launch_bounds__(NTHREADS)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ context_lens,
                        T* __restrict__ out, float* __restrict__ lse, int Hkv,
                        int page_size, int max_pages, float scale,
                        int window) {
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

  const T* qb = q + ((size_t)b * Hq + (size_t)hk * G) * D;
  for (int i = tid; i < G * D; i += NTHREADS)
    s_q[i] = Elem<T>::to_float(qb[i]) * sl2;
  __syncthreads();
  float qr[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[g][e] = s_q[g * D + d0 + e];

  const int len =
      max(0, min(context_lens[b], max_pages * page_size));
  const int t_lo = window > 0 ? max(0, len - window) : 0;
  const int* bt = block_tables + (size_t)b * max_pages;
  const size_t page_elems = (size_t)2 * Hkv * page_size * D;
  const size_t head_off = (size_t)hk * page_size * D + d0;
  const size_t v_off = (size_t)Hkv * page_size * D;

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
    uint4 kr[TPW], vr[TPW];
    bool ok[TPW];
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int tok = base + i;
      ok[i] = tok < len;
      if (ok[i]) {
        const int page = max(bt[tok / page_size], 0);
        const T* p = kv + (size_t)page * page_elems + head_off +
                     (size_t)(tok % page_size) * D;
        kr[i] = __ldg(reinterpret_cast<const uint4*>(p));
        vr[i] = __ldg(reinterpret_cast<const uint4*>(p + v_off));
      } else {
        kr[i] = make_uint4(0, 0, 0, 0);
        vr[i] = make_uint4(0, 0, 0, 0);
      }
    }
    float s[TPW][G];
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      float kf[8];
      to_float8<T>(kr[i], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qr[g][e], kf[e], dot);
        s[i][g] = dot;
      }
    }
    // sum over the 16 lanes of each half-warp (offsets stay inside it)
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
#pragma unroll
      for (int i = 0; i < TPW; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[i][g] += __shfl_xor_sync(0xffffffffu, s[i][g], off);

    float vf[TPW][8];
#pragma unroll
    for (int i = 0; i < TPW; ++i) to_float8<T>(vr[i], vf[i]);
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
      l[g] = l[g] * alpha + psum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int i = 0; i < TPW; ++i) a = fmaf(p[i], vf[i][e], a);
        acc[g][e] = a;
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
    const size_t row = (size_t)b * Hq + (size_t)hk * G + g;
    out[row * D + d] = Elem<T>::from_float(L > 0.f ? O / L : 0.f);
    if (lse != nullptr && d == 0)
      lse[row] = L > 0.f ? (M + log2f(L)) * kLn2 : kMaskValue;
  }
}

template <typename T, int G>
int launch(const void* q, const void* kv, const void* bt, const void* lens,
           void* out, void* lse, int B, int Hkv, int page_size, int max_pages,
           float scale, int window, cudaStream_t stream) {
  const size_t smem = smem_floats(G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  paged_decode_kernel<T, G><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv),
      static_cast<const int*>(bt), static_cast<const int*>(lens),
      static_cast<T*>(out), static_cast<float*>(lse), Hkv, page_size,
      max_pages, scale, window);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int group, const void* q, const void* kv, const void* bt,
             const void* lens, void* out, void* lse, int B, int Hkv,
             int page_size, int max_pages, float scale, int window,
             cudaStream_t s) {
  switch (group) {
    case 1:
      return launch<T, 1>(q, kv, bt, lens, out, lse, B, Hkv, page_size,
                          max_pages, scale, window, s);
    case 2:
      return launch<T, 2>(q, kv, bt, lens, out, lse, B, Hkv, page_size,
                          max_pages, scale, window, s);
    case 4:
      return launch<T, 4>(q, kv, bt, lens, out, lse, B, Hkv, page_size,
                          max_pages, scale, window, s);
    case 8:
      return launch<T, 8>(q, kv, bt, lens, out, lse, B, Hkv, page_size,
                          max_pages, scale, window, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int aule_paged_decode(const void* q, const void* kv_pages,
                                 const void* block_tables,
                                 const void* context_lens, void* out,
                                 void* lse, int B, int Hq, int Hkv,
                                 int page_size, int max_pages, float scale,
                                 int window, int dtype, void* stream) {
  if (B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  if (dtype == aule::kF16)
    return dispatch<__half>(group, q, kv_pages, block_tables, context_lens,
                            out, lse, B, Hkv, page_size, max_pages, scale,
                            window, s);
  return dispatch<__nv_bfloat16>(group, q, kv_pages, block_tables,
                                 context_lens, out, lse, B, Hkv, page_size,
                                 max_pages, scale, window, s);
}
