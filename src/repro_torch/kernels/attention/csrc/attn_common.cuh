// Helpers shared by the attention kernels (mha_fwd.cu, mha_bwd.cu): dtype
// conversion, 16-byte row loads and the staging of a tile into shared
// memory as f32 for the FMA kernels; cp.async copies, ldmatrix fragment
// loads and the mma.sync m16n8k16 product (bf16 products, f32 sums) for the
// tensor-core kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // finite -inf stand-in, as the TPU kernel's

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// Eight consecutive elements (16 bytes for bf16, 32 for f32) as f32. The
// wrappers check that every row start is 16-byte aligned.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* o) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// Stage a (rows, width) tile of one head into shared memory as f32, with
// row stride `ld` floats; rows at or past `n_valid` are zero (ragged tiles).
template <typename T, int NT>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, int64_t row_stride,
                                      int rows, int width, int n_valid) {
  for (int e = threadIdx.x * 8; e < rows * width; e += NT * 8) {
    const int r = e / width, d = e % width;  // width % 8 == 0: no chunk spans rows
    float tmp[8];
    if (r < n_valid) {
      load8(src + r * row_stride + d, tmp);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) tmp[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[r * ld + d + i] = tmp[i];
  }
}

// ---------------------------------------------------------------- tensor cores
// Fragments of mma.sync.m16n8k16.row.col (lane = 4 * g + t4):
//   A (16 x 16, bf16): a0 (row g, cols 2t4, 2t4+1), a1 (row g+8, same cols),
//     a2 (row g, cols 2t4+8, +9), a3 (row g+8, cols 2t4+8, +9);
//   B (16 x 8, bf16): b0 (rows 2t4, 2t4+1, col g), b1 (rows 2t4+8, +9, col g);
//   C (16 x 8, f32): c0, c1 (row g, cols 2t4, 2t4+1), c2, c3 (row g+8).
// The lower-indexed element of each bf16 pair sits in the low half.

// Copy the first n of 16 bytes (n is 0 or 16 here) into shared memory and
// fill the rest with zeros: the ragged edge of a tile reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
// The same for one f32 (n is 0 or 4): per-row statistics such as lse.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed copy groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, 16-byte aligned. Without .trans, lane 4g + t4 receives
// elements (g, 2t4) and (g, 2t4+1) of each; with .trans, (2t4, g) and
// (2t4+1, g).
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// c += a b, bf16 products exact in f32, f32 sums.
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to nearest-even bf16, lo in the low half: the A
// fragment register of two adjacent C columns.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// c += a b with the product formed in a fresh fragment and added in f32
// with round-to-nearest. Chained through the mma's own accumulator, long
// sums truncate at each k-step; folded so, they round. The fragment is
// scoped to the asm block: as C++ temporaries, ptxas kept more of them
// live and spilled.
__device__ __forceinline__ void mma_bf16_fold(float* c, const unsigned* a, unsigned b0,
                                              unsigned b1) {
  asm volatile(
      "{\n.reg .f32 t0, t1, t2, t3;\n"
      "mov.f32 t0, 0f00000000;\nmov.f32 t1, 0f00000000;\n"
      "mov.f32 t2, 0f00000000;\nmov.f32 t3, 0f00000000;\n"
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {t0, t1, t2, t3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {t0, t1, t2, t3};\n"
      "add.rn.f32 %0, %0, t0;\nadd.rn.f32 %1, %1, t1;\n"
      "add.rn.f32 %2, %2, t2;\nadd.rn.f32 %3, %3, t3;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tensor-core kernels' blocks: 4 warps, tiles of 64 rows, 16 per warp.
constexpr int kMmaTile = 64;
constexpr int kMmaThreads = 128;
using bf16 = __nv_bfloat16;

// Copy rows r0 .. r0 + 63 of a (rows, HD) bf16 array (row stride `ld_src`
// elements, last dim contiguous) into a (64, HD + 8) shared tile; rows at
// or past `end` are zero-filled and not read.
template <int HD>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, int64_t ld_src, int r0,
                                          int end) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kMmaTile * CH; c += kMmaThreads) {
    const int r = c / CH, d = (c % CH) * 8;
    const bool ok = r0 + r < end;
    cp_async16(dst + r * (HD + 8) + d, ok ? src + (int64_t)(r0 + r) * ld_src + d : src,
               ok ? 16 : 0);
  }
}
// copy_tile of the same rows of two arrays (K and V, Q and dO) in one loop:
// as two loops, the forward kernel took 9 more registers and ran slower.
template <int HD>
__device__ __forceinline__ void copy_tile_pair(bf16* d1, const bf16* s1, int64_t ld1, bf16* d2,
                                               const bf16* s2, int64_t ld2, int r0, int end) {
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < kMmaTile * CH; c += kMmaThreads) {
    const int r = c / CH, d = (c % CH) * 8;
    const bool ok = r0 + r < end;
    cp_async16(d1 + r * (HD + 8) + d, ok ? s1 + (int64_t)(r0 + r) * ld1 + d : s1, ok ? 16 : 0);
    cp_async16(d2 + r * (HD + 8) + d, ok ? s2 + (int64_t)(r0 + r) * ld2 + d : s2, ok ? 16 : 0);
  }
}

// A fragments of k-step ks for this warp's 16 rows of a (64, LD) tile.
template <int LD>
__device__ __forceinline__ void frag_a(unsigned* r, const bf16* tile, int warp, int ks,
                                       int lane) {
  const int mi = lane >> 3, r8 = lane & 7;
  ldmatrix_x4(r, tile + (warp * 16 + (mi & 1) * 8 + r8) * LD + ks * 16 + (mi >> 1) * 8);
}
// B fragments of k-step ks (over the tile's columns) for the two n8 tiles
// of tile rows n16 .. n16 + 15: a product A tile^T.
template <int LD>
__device__ __forceinline__ void frag_bt(unsigned* r, const bf16* tile, int n16, int ks,
                                        int lane) {
  const int mi = lane >> 3, r8 = lane & 7;
  ldmatrix_x4(r, tile + (n16 + (mi >> 1) * 8 + r8) * LD + ks * 16 + (mi & 1) * 8);
}
// B fragments of the k-step over tile rows k16 .. k16 + 15 for the two n8
// tiles of columns d16 .. d16 + 15: a product A tile.
template <int LD>
__device__ __forceinline__ void frag_b(unsigned* r, const bf16* tile, int k16, int d16,
                                       int lane) {
  const int mi = lane >> 3, r8 = lane & 7;
  ldmatrix_x4_trans(r, tile + (k16 + (mi & 1) * 8 + r8) * LD + d16 + (mi >> 1) * 8);
}

// A warp's (16, HD) f32 C fragments rounded to bf16, staged through its 16
// rows `stage` of a shared tile, then stored as whole 16-byte chunks to the
// rows of `out` (row stride `ld_out` elements) below `n_valid`.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* stage, const float (*acc)[4], bf16* out,
                                           int64_t ld_out, int n_valid, int lane) {
  constexpr int LD = HD + 8, CH = HD / 8;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int d = n * 8 + 2 * t4;
    *reinterpret_cast<unsigned*>(stage + g * LD + d) = pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<unsigned*>(stage + (g + 8) * LD + d) = pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, d = (c % CH) * 8;
    if (r < n_valid)
      *reinterpret_cast<uint4*>(out + r * ld_out + d) =
          *reinterpret_cast<const uint4*>(stage + r * LD + d);
  }
}

// The two packed bf16 A-fragment registers of a 16-column chunk from its
// two n8 C fragments (columns 0-7 and 8-15).
__device__ __forceinline__ void pack_a(unsigned* a, const float (*c)[4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

}  // namespace
