// RoPE pre-pass for the TMA flash forward (sm_90a), hand-written CUDA C++:
// rotates K [B, Hkv, Sk, D] once a call into a scratch tensor of its shape,
// so that flash_fwd.cu's producer loads the rotated rows by TMA as its
// plain instantiation does (its consumers turn Q).
//
// Replaces no TPU kernel of its own: it is the K half of the fused RoPE of
// aule_tpu/ops/flash.py::_fwd_kernel (use_rope, flash.py:227-246), which
// turns each K chunk inside its score loop, once for every q tile and q
// head that reads it.  The function is that kernel's: the half-split
// rotation x1' = x1 cos - x2 sin, x2' = x1 sin + x2 cos in f32 with each
// product rounded before the sum (common.cuh rope_regs, the arithmetic of
// rope_chunks), rounded back to bf16 / f16, and rows at or past the
// table's rope_len copied as they are (the identity past the table, as
// ops/flash.py::rope_identity_padded).  Every row of the tensor is turned:
// kv_len is never read here (on the host or the card), so a CUDA-graph
// replay at another length stays right; rows past kv_len are masked by the
// forward anyway.
//
// What bounds it on the H100: bytes.  At the Llama layer (B1 Hkv8 S2048
// D128 bf16) K is 4 MB read and 4 MB written, the tables 1 MB: ~2.8 us at
// 3.35 TB/s.  One thread turns eight value pairs (two 16-byte pieces of a
// row) of one position for every head its block covers, so it loads the
// position's 64 bytes of cos / sin once for all of them; neighbouring
// threads hold neighbouring pieces of a row and neighbouring rows, so a
// warp reads 512 contiguous bytes of each half of a head.  The heads are
// cut into groups (grid y) only as far as the card needs blocks.

#include "common.cuh"

namespace {

using namespace aule;

constexpr int NTH = 256;  // threads a block

// x [bh, s, D] -> y; grid (row blocks, head groups of hb heads)
template <typename T, int D>
__global__ void __launch_bounds__(NTH)
    rope_prepass_kernel(const T* x, T* y, int bh, int s, int hb,
                        const float* __restrict__ rc,
                        const float* __restrict__ rs, int rope_len) {
  constexpr int P = D / 16;  // piece pairs a row
  const int i = blockIdx.x * NTH + threadIdx.x;
  const int pos = i / P, c = i % P;
  const int h0 = blockIdx.y * hb;
  if (pos >= s || h0 >= bh) return;
  const int h1 = min(h0 + hb, bh);
  const size_t off = (size_t)pos * D + 8 * c;
  const bool turn = pos < rope_len;
  RopeAngles ang;
  if (turn) {
    const size_t at = (size_t)pos * (D / 2) + 8 * c;
    ang.load(rc + at, rs + at);
  }
  // HB heads' loads in flight before their stores (x and y never alias,
  // which the compiler cannot see)
  constexpr int HB = 4;
  const size_t hstride = (size_t)s * D;
  for (int h = h0; h < h1; h += HB) {
    uint4 va[HB], vb[HB];
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      if (h + j >= h1) break;
      const T* src = x + (h + j) * hstride + off;
      va[j] = __ldg(reinterpret_cast<const uint4*>(src));
      vb[j] = __ldg(reinterpret_cast<const uint4*>(src + D / 2));
    }
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      if (h + j >= h1) break;
      uint32_t a[4] = {va[j].x, va[j].y, va[j].z, va[j].w};
      uint32_t b[4] = {vb[j].x, vb[j].y, vb[j].z, vb[j].w};
      if (turn) rope_regs<T>(a, b, ang);
      T* dst = y + (h + j) * hstride + off;
      *reinterpret_cast<uint4*>(dst) = make_uint4(a[0], a[1], a[2], a[3]);
      *reinterpret_cast<uint4*>(dst + D / 2) =
          make_uint4(b[0], b[1], b[2], b[3]);
    }
  }
}

// Heads a block of a tensor with bh heads and blocks_x row blocks: all of
// them while that still makes four blocks an SM (132 SMs), else fewer.
int heads_per_block(int bh, int blocks_x) {
  const int want = 4 * 132;
  int groups = (want + blocks_x - 1) / blocks_x;
  groups = groups < 1 ? 1 : groups > bh ? bh : groups;
  return (bh + groups - 1) / groups;
}

template <typename T, int D>
int launch(const void* x, void* y, int bh, int s, const void* rc,
           const void* rs, int rope_len, cudaStream_t stream) {
  const int bx = (s * (D / 16) + NTH - 1) / NTH;
  const int hb = heads_per_block(bh, bx);
  rope_prepass_kernel<T, D><<<dim3(bx, (bh + hb - 1) / hb), NTH, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), bh, s, hb,
      static_cast<const float*>(rc), static_cast<const float*>(rs), rope_len);
  return cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* x, void* y, int bh, int s, const void* rc,
             const void* rs, int rope_len, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(x, y, bh, s, rc, rs, rope_len, stream);
    case 128:
      return launch<T, 128>(x, y, bh, s, rc, rs, rope_len, stream);
    case 256:
      return launch<T, 256>(x, y, bh, s, rc, rs, rope_len, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x [bh, s, D] -> y rotated; tables [rope_len, D / 2] f32, 16-byte aligned
// rows; D 64, 128 or 256; dtype 0 bf16, 1 f16.
extern "C" int aule_rope_prepass(const void* x, void* y, int bh, int s,
                                 const void* rc, const void* rs, int D,
                                 int rope_len, int dtype, void* stream) {
  if (bh <= 0 || s <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF16)
    return launch_d<__half>(D, x, y, bh, s, rc, rs, rope_len, st);
  if (dtype == kBF16)
    return launch_d<__nv_bfloat16>(D, x, y, bh, s, rc, rs, rope_len, st);
  return cudaErrorInvalidValue;
}
