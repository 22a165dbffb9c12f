// Fused momentum EMA + sum of squares of the SCALE LM-head update for
// Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `momentum_sumsq` of
// src/repro/kernels/scale_head/scale_head.py (`_momentum_sumsq_kernel`
// line 36, `pallas_call` line 92). On the canonical (L, m, n) view:
//   m' = beta * f32(m) + (1 - beta) * (gscale * f32(g))     (all f32)
//   m  <- m' rounded to m's dtype, in place (the TPU kernel aliases m to
//         its output; bf16 under momentum_dtype="bfloat16")
//   ss = sum of m'^2 of the *pre-cast* f32 m' over rows (col: (L, 1, n))
//        or over columns (row: (L, m, 1)), f32.
// The head's apply step then reads the stored m' through update_apply
// (colnorm.cu), as on the TPU.
//
// Numerics follow the TPU kernel body: f32 math with beta read as f32 and
// 1 - beta formed in f32, one rounding of the stored m' (round to nearest
// even). The EMA is written with _rn intrinsics so that nvcc cannot
// contract it into an FMA, so m' matches the plain PyTorch version bit for
// bit. beta and gscale are read from device memory when the caller passes a
// tensor, else passed by value.
//
// What bounds it on an H100: bytes. At llama-1b's lm_head, (2048, 32000)
// with f32 momentum and bf16 g, it reads m and g and writes m: 655 MB.
//
// The design is the reduction skeleton of colnorm.cu's norm_sumsq (kept as
// its own copy: each kernel family builds from its own folder), with the
// EMA and the in-place store of m' folded into the load loop: scalar,
// coalesced loads along the last axis with int64 strided offsets (any
// layout, any alignment); col sums by 32-column x 8-warp blocks, row sums
// by one warp per row; the reduce axis split into S ranges of at most 64
// terms per lane whose partial sums a second launch adds in split order.
// No f32 atomics: two runs on the same inputs are bitwise equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ float scalar(const float* p, float v) { return p != nullptr ? *p : v; }

struct Shape {
  int L, m, n;
};
struct Strides {
  int64_t l, m, n;  // in elements
};

constexpr int kCols = 32;
constexpr int kRowWarps = 8;
constexpr int kRowsPerBlock = 8;
constexpr int kUnroll = 4;

struct Ema {
  float beta, omb, gs;  // omb = 1 - beta, in f32
  __device__ __forceinline__ float operator()(float m, float g) const {
    return __fadd_rn(__fmul_rn(beta, m), __fmul_rn(omb, __fmul_rn(g, gs)));
  }
};

__device__ __forceinline__ Ema make_ema(const float* beta_p, float beta_v, const float* gs_p,
                                        float gs_v) {
  const float beta = scalar(beta_p, beta_v);
  return Ema{beta, __fsub_rn(1.f, beta), scalar(gs_p, gs_v)};
}

template <typename Tm, typename Tg>
__global__ void __launch_bounds__(kCols * kRowWarps)
momentum_col_kernel(Tm* __restrict__ mom, Strides sm, const Tg* __restrict__ g, Strides sg,
                    Shape sh, int chunk, const float* __restrict__ beta_p, float beta_v,
                    const float* __restrict__ gs_p, float gs_v, float* __restrict__ part) {
  const int j = blockIdx.x * kCols + threadIdx.x;
  const int split = blockIdx.y, l = blockIdx.z;
  const int r1 = min(sh.m, (split + 1) * chunk);
  const Ema ema = make_ema(beta_p, beta_v, gs_p, gs_v);
  float acc = 0.f;
  if (j < sh.n) {
    Tm* mp = mom + l * sm.l + j * sm.n;
    const Tg* gp = g + l * sg.l + j * sg.n;
    int i = split * chunk + threadIdx.y;
    for (; i + (kUnroll - 1) * kRowWarps < r1; i += kUnroll * kRowWarps) {
      float mv[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t r = i + u * kRowWarps;
        mv[u] = to_f32(mp[r * sm.m]);
        gv[u] = to_f32(gp[r * sg.m]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float v = ema(mv[u], gv[u]);
        store(&mp[(int64_t)(i + u * kRowWarps) * sm.m], v);
        acc = __fmaf_rn(v, v, acc);
      }
    }
    for (; i < r1; i += kRowWarps) {
      const float v = ema(to_f32(mp[(int64_t)i * sm.m]), to_f32(gp[(int64_t)i * sg.m]));
      store(&mp[(int64_t)i * sm.m], v);
      acc = __fmaf_rn(v, v, acc);
    }
  }
  __shared__ float red[kRowWarps][kCols + 1];
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < sh.n) {
    float t = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kRowWarps; ++w) t = __fadd_rn(t, red[w][threadIdx.x]);
    part[((int64_t)l * gridDim.y + split) * sh.n + j] = t;
  }
}

template <typename Tm, typename Tg>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
momentum_row_kernel(Tm* __restrict__ mom, Strides sm, const Tg* __restrict__ g, Strides sg,
                    Shape sh, int chunk, const float* __restrict__ beta_p, float beta_v,
                    const float* __restrict__ gs_p, float gs_v, float* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int split = blockIdx.y, l = blockIdx.z;
  if (i >= sh.m) return;  // warp-uniform; this kernel has no block barrier
  const int c1 = min(sh.n, (split + 1) * chunk);
  const Ema ema = make_ema(beta_p, beta_v, gs_p, gs_v);
  Tm* mp = mom + l * sm.l + (int64_t)i * sm.m;
  const Tg* gp = g + l * sg.l + (int64_t)i * sg.m;
  float acc = 0.f;
  int j = split * chunk + lane;
  for (; j + (kUnroll - 1) * 32 < c1; j += kUnroll * 32) {
    float mv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t c = j + u * 32;
      mv[u] = to_f32(mp[c * sm.n]);
      gv[u] = to_f32(gp[c * sg.n]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float v = ema(mv[u], gv[u]);
      store(&mp[(int64_t)(j + u * 32) * sm.n], v);
      acc = __fmaf_rn(v, v, acc);
    }
  }
  for (; j < c1; j += 32) {
    const float v = ema(to_f32(mp[(int64_t)j * sm.n]), to_f32(gp[(int64_t)j * sg.n]));
    store(&mp[(int64_t)j * sm.n], v);
    acc = __fmaf_rn(v, v, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) part[((int64_t)l * gridDim.y + split) * sh.m + i] = acc;
}

// out[l, o] = sum over s of part[l, s, o], in split order.
__global__ void finish_kernel(const float* __restrict__ part, int S, int64_t per_layer,
                              int64_t total, float* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t l = idx / per_layer, o = idx % per_layer;
  const float* p = part + l * S * per_layer + o;
  float t = p[0];
  for (int s = 1; s < S; ++s) t = __fadd_rn(t, p[s * per_layer]);
  out[idx] = t;
}

template <typename Tm, typename Tg>
cudaError_t launch(void* mom, Strides sm, const void* g, Strides sg, Shape sh, int row_axis,
                   const float* beta_p, float beta_v, const float* gs_p, float gs_v, float* part,
                   float* ss, int S, int chunk, cudaStream_t stream) {
  float* first = S > 1 ? part : ss;
  if (row_axis) {
    const dim3 grid((sh.m + kRowsPerBlock - 1) / kRowsPerBlock, S, sh.L);
    momentum_row_kernel<Tm, Tg><<<grid, 32 * kRowsPerBlock, 0, stream>>>(
        static_cast<Tm*>(mom), sm, static_cast<const Tg*>(g), sg, sh, chunk, beta_p, beta_v,
        gs_p, gs_v, first);
  } else {
    const dim3 grid((sh.n + kCols - 1) / kCols, S, sh.L);
    momentum_col_kernel<Tm, Tg><<<grid, dim3(kCols, kRowWarps), 0, stream>>>(
        static_cast<Tm*>(mom), sm, static_cast<const Tg*>(g), sg, sh, chunk, beta_p, beta_v,
        gs_p, gs_v, first);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  const int64_t per_layer = row_axis ? sh.m : sh.n;
  const int64_t total = per_layer * sh.L;
  finish_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, S, per_layer, total, ss);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int momentum_sumsq(void* mom, int m_bf16, int64_t ml, int64_t mm, int64_t mn, const void* g,
                   int g_bf16, int64_t gl, int64_t gm, int64_t gn, int L, int m, int n,
                   int row_axis, const float* beta_p, float beta_v, const float* gs_p,
                   float gs_v, float* part, float* ss, int S, int chunk, cudaStream_t stream) {
  const Strides sm{ml, mm, mn}, sg{gl, gm, gn};
  const Shape sh{L, m, n};
  if (m_bf16) {
    return g_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(mom, sm, g, sg, sh, row_axis, beta_p,
                                                         beta_v, gs_p, gs_v, part, ss, S, chunk,
                                                         stream)
                  : launch<__nv_bfloat16, float>(mom, sm, g, sg, sh, row_axis, beta_p, beta_v,
                                                 gs_p, gs_v, part, ss, S, chunk, stream);
  }
  return g_bf16 ? launch<float, __nv_bfloat16>(mom, sm, g, sg, sh, row_axis, beta_p, beta_v,
                                               gs_p, gs_v, part, ss, S, chunk, stream)
                : launch<float, float>(mom, sm, g, sg, sh, row_axis, beta_p, beta_v, gs_p, gs_v,
                                       part, ss, S, chunk, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
