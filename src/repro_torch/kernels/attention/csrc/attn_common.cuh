// Helpers shared by the attention kernels (mha_fwd.cu, mha_bwd.cu): dtype
// conversion, 16-byte row loads and the staging of a tile into shared
// memory as f32.
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

}  // namespace
