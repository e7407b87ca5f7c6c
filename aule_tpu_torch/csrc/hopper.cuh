// Hopper (sm_90a) building blocks for the port's hand-written kernels:
// TMA tensor maps (encoded on the host) and their loads and stores, the
// mbarrier that a TMA load or a thread's cp.async completes, wgmma
// shared-memory descriptors and the m64n128k16 and m64n64k16 products with
// f32 sums (and the products of a head dim's k-steps built on them),
// warpgroup register rebalancing, and thread-block cluster
// barriers and shared-memory reads.
// Built with nvcc into the plain-C library (ops/_build.py);
// libcuda's cuTensorMapEncodeTiled is reached through the runtime's
// entry-point query, so nothing links against libcuda.
//
// Layout convention of every tile here: a [rows, d] matrix of 16-bit
// values (d = 64, 128 or 256) sits in shared memory as d / 64 chunks of 64
// columns, each [rows, 64] of 128-byte rows in the 128-byte swizzle
// (16-byte piece c of row r at piece c ^ (r % 8)) that TMA writes and wgmma
// reads.  Each chunk starts on a 1024-byte boundary, so the swizzle, which
// the hardware takes from the address bits, is the same for all.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aule {
namespace hopper {

// ---- TMA tensor maps (host) ----------------------------------------------

using EncodeTiledFn = decltype(&cuTensorMapEncodeTiled);

// libcuda's cuTensorMapEncodeTiled, looked up once; null if the installed
// libcuda lacks it.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A rank-3 map over a contiguous [planes, rows, d] tensor of 16-bit values
// (planes = batch x heads; d = 64, 128 or 256), read or written in boxes of
// [1, box_rows, 64]: one 64-column chunk of box_rows rows, 128-byte
// swizzled, so a tile of d columns is d / 64 such chunks.  A plane is a
// dimension of its own, so a box never runs into the next head's rows:
// rows past `rows` load as zeros and are clipped from stores.
inline cudaError_t encode_rows(CUtensorMap* map, const void* base, bool f16,
                               int planes, int rows, int box_rows, int d) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map,
                  f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  3, const_cast<void*>(base), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- mbarrier ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async (TMA) proxy;
// a __syncthreads() after it makes it visible to the other threads.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA transactions to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread issued before it has
// landed; it does not raise the barrier's expected count (.noinc), so the
// count given to mbar_init includes these arrivals.
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.  A phase that
// never completes (a fault in the ring's accounting) traps after ~2^26
// polls, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 22)) __trap();
  }
}

// ---- TMA (one thread issues; the hardware moves the whole box) -----------

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Box at (c0, c1, c2) of a rank-3 map -> shared memory at dst; completes
// its bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Shared memory at src -> box at (c0, c1, c2); out-of-range rows are
// clipped.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until the committed stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy (TMA, wgmma) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- warpgroup register rebalancing --------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma ---------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at shared address `addr`:
// `lbo` and `sbo` in bytes.  K-major (the contracted dimension contiguous):
// sbo is the stride between 8-row groups, lbo unused.  MN-major: lbo is the
// stride between 64-element swizzle atoms along M/N, sbo between 8-row
// groups along K.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an in-flight wgmma writes: the compiler may not move
// their reads above the wait, nor their writes below the issue.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The thread's 64 f32 sums of a 64 x 128 product: rows 16 * warp + lane / 4
// (+ 8 for elements 2, 3) of the warpgroup's 64, columns 8 * j + 2 *
// (lane % 4) + {0, 1} in elements 4j .. 4j + 3 (the mma.sync m16n8 layout
// repeated over 16 column blocks).
#define AULE_WGMMA_D                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define AULE_ACC8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define AULE_ACC64                                                     \
  AULE_ACC8(0), AULE_ACC8(8), AULE_ACC8(16), AULE_ACC8(24),            \
      AULE_ACC8(32), AULE_ACC8(40), AULE_ACC8(48), AULE_ACC8(56)

template <typename T>
struct Wgmma;

// d (+)= A B for A 64 x 16 and B 16 x 128, f32 sums.  `ss`: A and B from
// shared memory, both K-major; the sum starts from zero when !accumulate.
// `rs`: A from registers (the mma.sync A fragment of the thread's rows),
// B from shared memory, MN-major (the transposed-B bit).
#define AULE_WGMMA_TYPE(T, NAME)                                            \
  template <>                                                               \
  struct Wgmma<T> {                                                         \
    __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a,   \
                                              uint64_t b, int accumulate) { \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                      \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." NAME "." NAME " "  \
          AULE_WGMMA_D ", %64, %65, p, 1, 1, 0, 0;\n}\n"                    \
          : AULE_ACC64                                                      \
          : "l"(a), "l"(b), "r"(accumulate));                               \
    }                                                                       \
    __device__ __forceinline__ static void rs(float (&d)[64],               \
                                              const uint32_t (&a)[4],       \
                                              uint64_t b) {                 \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                      \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." NAME "." NAME " "  \
          AULE_WGMMA_D ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"      \
          : AULE_ACC64                                                      \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));    \
    }                                                                       \
    /* `rs` with B's descriptor advanced by OB inside the asm */            \
    template <int OB>                                                       \
    __device__ __forceinline__ static void rs_at(float (&d)[64],            \
                                                 const uint32_t (&a)[4],    \
                                                 uint64_t b) {              \
      asm volatile(                                                         \
          "{\n.reg .pred p;\n.reg .b64 db;\nadd.s64 db, %68, %70;\n"        \
          "setp.ne.b32 p, %69, 0;\n"                                        \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." NAME "." NAME " "  \
          AULE_WGMMA_D ", {%64, %65, %66, %67}, db, p, 1, 1, 1;\n}\n"       \
          : AULE_ACC64                                                      \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),     \
            "n"(OB));                                                       \
    }                                                                       \
  };

AULE_WGMMA_TYPE(__nv_bfloat16, "bf16")
AULE_WGMMA_TYPE(__half, "f16")

// The thread's 32 f32 sums of a 64 x 64 product: the layout above over 8
// column blocks.
#define AULE_WGMMA_D32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define AULE_ACC32 AULE_ACC8(0), AULE_ACC8(8), AULE_ACC8(16), AULE_ACC8(24)

template <typename T>
struct Wgmma64;

// d (+)= A B for A 64 x 16 and B 16 x 64 (N = 64), f32 sums.  `ss_at`:
// both from shared memory and K-major; the sum starts from zero when
// !accumulate.  `rs_at`: A from registers, B MN-major, as Wgmma's `rs`.
// The descriptors are advanced by OA and OB (16-byte units: the k-step's
// offset) inside the asm, so a loop holds only the base descriptors in
// registers, not one advanced descriptor per k-step.
#define AULE_WGMMA64_TYPE(T, NAME)                                          \
  template <>                                                               \
  struct Wgmma64<T> {                                                       \
    template <int OA, int OB>                                               \
    __device__ __forceinline__ static void ss_at(float (&d)[32], uint64_t a,\
                                                 uint64_t b,                \
                                                 int accumulate) {          \
      asm volatile(                                                         \
          "{\n.reg .pred p;\n.reg .b64 da, db;\nadd.s64 da, %32, %35;\n"   \
          "add.s64 db, %33, %36;\nsetp.ne.b32 p, %34, 0;\n"                 \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." NAME "." NAME " "   \
          AULE_WGMMA_D32 ", da, db, p, 1, 1, 0, 0;\n}\n"                    \
          : AULE_ACC32                                                      \
          : "l"(a), "l"(b), "r"(accumulate), "n"(OA), "n"(OB));             \
    }                                                                       \
    /* A from registers, B MN-major, B's descriptor advanced by OB */       \
    template <int OB>                                                       \
    __device__ __forceinline__ static void rs_at(float (&d)[32],            \
                                                 const uint32_t (&a)[4],    \
                                                 uint64_t b) {              \
      asm volatile(                                                         \
          "{\n.reg .pred p;\n.reg .b64 db;\nadd.s64 db, %36, %38;\n"        \
          "setp.ne.b32 p, %37, 0;\n"                                        \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." NAME "." NAME " "   \
          AULE_WGMMA_D32 ", {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"     \
          : AULE_ACC32                                                      \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),     \
            "n"(OB));                                                       \
    }                                                                       \
  };

AULE_WGMMA64_TYPE(__nv_bfloat16, "bf16")
AULE_WGMMA64_TYPE(__half, "f16")

#undef AULE_WGMMA64_TYPE
#undef AULE_ACC32
#undef AULE_WGMMA_D32
#undef AULE_WGMMA_TYPE
#undef AULE_ACC64
#undef AULE_ACC8
#undef AULE_WGMMA_D

// ---- the k-steps of a product over a head dim ------------------------------

// Offset (in 16-byte units, for a wgmma descriptor) of k-step kk (values
// 16kk .. 16kk + 15) of a K-major tile whose 64-column chunks hold `rows`
// 128-byte rows each: in chunk kk / 4, 32 bytes per step into it.
__host__ __device__ constexpr int kstep(int kk, int rows) {
  return ((kk / 4) * rows * 128 + (kk % 4) * 32) >> 4;
}

// Offset (16-byte units) of k-step kk (rows 16kk .. 16kk + 15) of an
// MN-major operand.
__host__ __device__ constexpr int mnstep(int kk) { return (16 * 128 * kk) >> 4; }

// d = A B (ONTO: d += A B) over all D / 16 k-steps from KK on, N = 64
// (m64n64k16): A a K-major tile of RA rows a chunk, B one of RB rows a
// chunk, the 64 from its descriptor's row on.  The k-steps unroll at
// compile time, so each descriptor offset is an asm immediate and only the
// two base descriptors take registers.
template <typename T, int D, int RA, int RB, bool ONTO = false, int KK = 0>
__device__ __forceinline__ void ss_product(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  static_assert(RA % 64 == 0 && RB % 64 == 0, "whole 64-row groups");
  if constexpr (KK < D / 16) {
    Wgmma64<T>::template ss_at<kstep(KK, RA), kstep(KK, RB)>(
        d, a, b, ONTO || KK > 0);
    ss_product<T, D, RA, RB, ONTO, KK + 1>(d, a, b);
  }
}

// d += A B over N k-steps from KK on, N = D output columns: A from
// registers (a[kk] the A fragment of k-step kk), B MN-major with its
// 64-column chunks CHUNK bytes apart (the descriptor's lbo).  m64n64k16 at
// D = 64, m64n128k16 at 128; at 256 two m64n128k16 a k-step, columns
// 0 .. 127 into d[0 .. 63] and 128 .. 255 (B two chunks on) into
// d[64 .. 127], which keeps the accumulator layout of one 64 x D product.
template <typename T, int D, int CHUNK, int N, int KK = 0>
__device__ __forceinline__ void rs_product(float (&d)[D / 2],
                                           const uint32_t (&a)[N][4],
                                           uint64_t b) {
  if constexpr (KK < N) {
    if constexpr (D == 64) {
      Wgmma64<T>::template rs_at<mnstep(KK)>(d, a[KK], b);
    } else if constexpr (D == 128) {
      Wgmma<T>::template rs_at<mnstep(KK)>(d, a[KK], b);
    } else {
      static_assert(D == 256, "D = 64, 128 or 256");
      Wgmma<T>::template rs_at<mnstep(KK)>(
          *reinterpret_cast<float(*)[64]>(d), a[KK], b);
      Wgmma<T>::template rs_at<mnstep(KK) + 2 * CHUNK / 16>(
          *reinterpret_cast<float(*)[64]>(d + 64), a[KK], b);
    }
    rs_product<T, D, CHUNK, N, KK + 1>(d, a, b);
  }
}

// ---- thread-block clusters ------------------------------------------------

// Every thread of every block of the cluster arrives, then waits for all:
// shared-memory writes before it are visible to the cluster's reads after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// The address of this block's shared address `addr` in the block of
// cluster rank `rank` (for ld.shared::cluster).
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

}  // namespace hopper
}  // namespace aule
