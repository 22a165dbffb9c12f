// Column/row-norm kernels of the SCALE update for Hopper (sm_90a), CUDA C++.
//
// Replaces three TPU kernels of src/repro/kernels/colnorm/colnorm.py:
//   norm_sumsq   (`_sumsq_kernel` line 113, `pallas_call` line 157)
//   norm_apply   (`_norm_apply_kernel` line 176, `pallas_call` line 209)
//   update_apply (`_update_apply_kernel` line 219, `pallas_call` line 240)
// on the canonical (L, m, n) view of a parameter (2-D leaves get L = 1):
//   norm_sumsq:   ss = sum of (gscale * f32(g))^2 over rows (col: ss is
//                 (L, 1, n)) or over columns (row: ss is (L, m, 1)), f32;
//   norm_apply:   out = gscale * f32(g) / (sqrt(ss) + eps), in out's dtype;
//   update_apply: theta = theta - lr * (gscale * f32(g)) / (sqrt(ss) + eps),
//                 written into theta in place (the TPU kernel aliases theta
//                 to its output).
//
// Numerics follow the TPU kernel bodies: all math in f32, `sqrt(ss) + eps`
// then a true division, one rounding to the output dtype (round to nearest
// even). The element-wise operations are written with the _rn intrinsics so
// that nvcc cannot contract them into FMAs: the kernels then round exactly
// as the plain PyTorch versions do, and match them bit for bit given the
// same ss. lr, gscale (and beta in momentum_sumsq.cu) are read from device
// memory when the caller passes a tensor, so a training step never waits
// for the host; a Python number is passed by value.
//
// What bounds them on an H100: bytes. They do a few flops per element (no
// tensor cores) and move every element of g (and theta) once per pass: at
// llama-1b's w_gate, (24, 2048, 5461) bf16, norm_sumsq reads 537 MB and
// update_apply moves 1.6 GB.
//
// Design of the reductions and norm_apply, the simple one:
//   * Loads are scalar, along the contiguous last axis across a warp
//     (coalesced), with int64 offsets from the tensor's own strides, so any
//     layout and any alignment is taken: llama-1b's d_ff = 5461 makes bf16
//     rows 10,922 bytes long, not a multiple of 16. Each thread keeps four
//     loads in flight.
//   * col sums: a block is 32 columns x 8 warps; each warp walks every 8th
//     row of its row range. row sums: one warp per row, lanes along the row,
//     a shuffle butterfly at the end.
//   * The reduce axis is split across blocks (S splits of at most 64 terms
//     per lane) so that llama-1b's tok_embed (32000 x 2048, col) fills the
//     132 SMs instead of 64 blocks. The S partial sums go to a workspace and
//     a second launch adds them in split order: no f32 atomics, so two runs
//     on the same inputs are bitwise equal. S depends only on the shape.
//     With S = 1 the first launch writes ss directly.
//   * norm_apply gives each block 1024 columns of one row.
//
// update_apply has two routes, picked by the wrapper from the operands'
// dtypes, strides and addresses (colnorm.py, `_route`); both compute every
// element with the same device function (`update_value`), so they agree bit
// for bit:
//   * vec, for theta and g contiguous that reach a 16-byte boundary at the
//     same element (every launch of the training step): the tensor is one
//     flat run of L*m*n elements, a ragged head of up to W - 1 elements, a
//     body of W-element vectors (W = 8 with a bf16 operand, else 4) and a
//     ragged tail. A persistent grid (as many blocks as the card holds at
//     once) strides over tiles of 512 vectors; each thread loads two
//     vectors of theta and of g with 16-byte accesses before it computes
//     (theta at L2's evict-first priority, g read-only and past L1), and
//     writes theta back with 16-byte streaming stores. ss is tiny and read
//     through the read-only cache: its index comes from the flat offset by
//     multiply-and-shift divisions, once per vector; a col vector's W
//     consecutive ss words are loaded as the aligned 16-byte words that hold
//     them, then shifted into place. The head and tail go element by
//     element in the first block. One launch, no workspace.
//   * strided, for any other layout (transposed views, operands at
//     different offsets): one block per row per 1024 columns, scalar loads
//     through the tensors' own strides.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// A scalar operand: read from device memory when the wrapper passed a
// tensor, else the value passed by the host.
__device__ __forceinline__ float scalar(const float* p, float v) { return p != nullptr ? *p : v; }

struct Shape {
  int L, m, n;
};
struct Strides {
  int64_t l, m, n;  // in elements
};

constexpr int kCols = 32;      // col sums: columns per block, one per lane
constexpr int kRowWarps = 8;   // col sums: warps per block, striding rows
constexpr int kRowsPerBlock = 8;  // row sums: one warp per row
constexpr int kUnroll = 4;     // loads in flight per thread
constexpr int kEwThreads = 256;   // element-wise: threads per block
constexpr int kEwPer = 4;         // element-wise: columns per thread

__device__ __forceinline__ float scaled_sq(float x, float gs, float acc) {
  const float v = __fmul_rn(x, gs);
  return __fmaf_rn(v, v, acc);
}

// Partial sums of squares along rows: part[l, split, j] over rows
// [split * chunk, (split + 1) * chunk).
template <typename T>
__global__ void __launch_bounds__(kCols * kRowWarps)
sumsq_col_kernel(const T* __restrict__ g, Strides sg, Shape sh, int chunk,
                 const float* __restrict__ gs_p, float gs_v, float* __restrict__ part) {
  const int j = blockIdx.x * kCols + threadIdx.x;
  const int split = blockIdx.y, l = blockIdx.z;
  const int r1 = min(sh.m, (split + 1) * chunk);
  const float gs = scalar(gs_p, gs_v);
  float acc = 0.f;
  if (j < sh.n) {
    const T* p = g + l * sg.l + j * sg.n;
    int i = split * chunk + threadIdx.y;
    for (; i + (kUnroll - 1) * kRowWarps < r1; i += kUnroll * kRowWarps) {
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = to_f32(p[(int64_t)(i + u * kRowWarps) * sg.m]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = scaled_sq(x[u], gs, acc);
    }
    for (; i < r1; i += kRowWarps) acc = scaled_sq(to_f32(p[(int64_t)i * sg.m]), gs, acc);
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

// Partial sums of squares along columns: part[l, split, i] over columns
// [split * chunk, (split + 1) * chunk), one warp per row.
template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
sumsq_row_kernel(const T* __restrict__ g, Strides sg, Shape sh, int chunk,
                 const float* __restrict__ gs_p, float gs_v, float* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int split = blockIdx.y, l = blockIdx.z;
  if (i >= sh.m) return;  // warp-uniform; this kernel has no block barrier
  const int c1 = min(sh.n, (split + 1) * chunk);
  const float gs = scalar(gs_p, gs_v);
  const T* p = g + l * sg.l + (int64_t)i * sg.m;
  float acc = 0.f;
  int j = split * chunk + lane;
  for (; j + (kUnroll - 1) * 32 < c1; j += kUnroll * 32) {
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = to_f32(p[(int64_t)(j + u * 32) * sg.n]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = scaled_sq(x[u], gs, acc);
  }
  for (; j < c1; j += 32) acc = scaled_sq(to_f32(p[(int64_t)j * sg.n]), gs, acc);
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

template <typename T>
cudaError_t launch_sumsq(const void* g, Strides sg, Shape sh, int row_axis, const float* gs_p,
                         float gs_v, float* part, float* out, int S, int chunk,
                         cudaStream_t stream) {
  float* first = S > 1 ? part : out;
  if (row_axis) {
    const dim3 grid((sh.m + kRowsPerBlock - 1) / kRowsPerBlock, S, sh.L);
    sumsq_row_kernel<T><<<grid, 32 * kRowsPerBlock, 0, stream>>>(
        static_cast<const T*>(g), sg, sh, chunk, gs_p, gs_v, first);
  } else {
    const dim3 grid((sh.n + kCols - 1) / kCols, S, sh.L);
    sumsq_col_kernel<T><<<grid, dim3(kCols, kRowWarps), 0, stream>>>(
        static_cast<const T*>(g), sg, sh, chunk, gs_p, gs_v, first);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  const int64_t per_layer = row_axis ? sh.m : sh.n;
  const int64_t total = per_layer * sh.L;
  finish_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, S, per_layer, total, out);
  return cudaGetLastError();
}

// One element of update_apply: theta - lr * (gs * g) / (sqrt(ss) + eps),
// each operation rounded once, in this order, on both routes.
__device__ __forceinline__ float update_value(float th, float g, float s, float lr, float gs,
                                              float eps) {
  const float norm = __fadd_rn(__fsqrt_rn(s), eps);
  const float gf = __fmul_rn(g, gs);
  return __fsub_rn(th, __fdiv_rn(__fmul_rn(lr, gf), norm));
}

// theta[l, i, j] -= lr * (gs * g[l, i, j]) / (sqrt(ss) + eps), in place: the
// strided route.
template <typename Tt, typename Tg>
__global__ void __launch_bounds__(kEwThreads)
update_apply_kernel(Tt* __restrict__ theta, Strides st, const Tg* __restrict__ g, Strides sg,
                    const float* __restrict__ ss, Shape sh, int row_axis,
                    const float* __restrict__ lr_p, float lr_v, const float* __restrict__ gs_p,
                    float gs_v, float eps) {
  const int64_t r = blockIdx.x;  // row of the (L * m, n) view
  const int l = (int)(r / sh.m), i = (int)(r % sh.m);
  const int j0 = blockIdx.y * (kEwThreads * kEwPer) + threadIdx.x;
  const float lr = scalar(lr_p, lr_v), gs = scalar(gs_p, gs_v);
  Tt* tp = theta + l * st.l + (int64_t)i * st.m;
  const Tg* gp = g + l * sg.l + (int64_t)i * sg.m;
  const float* sp = row_axis ? ss + r : ss + (int64_t)l * sh.n;
  float th[kEwPer], gv[kEwPer], sv[kEwPer];
#pragma unroll
  for (int u = 0; u < kEwPer; ++u) {
    const int j = j0 + u * kEwThreads;
    if (j < sh.n) {
      th[u] = to_f32(tp[j * st.n]);
      gv[u] = to_f32(gp[j * sg.n]);
      sv[u] = row_axis ? sp[0] : sp[j];
    }
  }
#pragma unroll
  for (int u = 0; u < kEwPer; ++u) {
    const int j = j0 + u * kEwThreads;
    if (j < sh.n) store(&tp[j * st.n], update_value(th[u], gv[u], sv[u], lr, gs, eps));
  }
}

// out[l, i, j] = (gs * g[l, i, j]) / (sqrt(ss) + eps); out is contiguous.
template <typename Tg, typename To>
__global__ void __launch_bounds__(kEwThreads)
norm_apply_kernel(const Tg* __restrict__ g, Strides sg, const float* __restrict__ ss,
                  To* __restrict__ out, Shape sh, int row_axis, const float* __restrict__ gs_p,
                  float gs_v, float eps) {
  const int64_t r = blockIdx.x;
  const int l = (int)(r / sh.m), i = (int)(r % sh.m);
  const int j0 = blockIdx.y * (kEwThreads * kEwPer) + threadIdx.x;
  const float gs = scalar(gs_p, gs_v);
  const Tg* gp = g + l * sg.l + (int64_t)i * sg.m;
  const float* sp = row_axis ? ss + r : ss + (int64_t)l * sh.n;
  To* op = out + r * sh.n;
  float gv[kEwPer], sv[kEwPer];
#pragma unroll
  for (int u = 0; u < kEwPer; ++u) {
    const int j = j0 + u * kEwThreads;
    if (j < sh.n) {
      gv[u] = to_f32(gp[j * sg.n]);
      sv[u] = row_axis ? sp[0] : sp[j];
    }
  }
#pragma unroll
  for (int u = 0; u < kEwPer; ++u) {
    const int j = j0 + u * kEwThreads;
    if (j < sh.n) {
      const float norm = __fadd_rn(__fsqrt_rn(sv[u]), eps);
      store(&op[j], __fdiv_rn(__fmul_rn(gv[u], gs), norm));
    }
  }
}

dim3 ew_grid(Shape sh) {
  const int per_block = kEwThreads * kEwPer;
  return dim3((unsigned)((int64_t)sh.L * sh.m), (sh.n + per_block - 1) / per_block);
}

template <typename Tt, typename Tg>
cudaError_t launch_update(void* theta, Strides st, const void* g, Strides sg, const float* ss,
                          Shape sh, int row_axis, const float* lr_p, float lr_v,
                          const float* gs_p, float gs_v, float eps, cudaStream_t stream) {
  update_apply_kernel<Tt, Tg><<<ew_grid(sh), kEwThreads, 0, stream>>>(
      static_cast<Tt*>(theta), st, static_cast<const Tg*>(g), sg, ss, sh, row_axis, lr_p, lr_v,
      gs_p, gs_v, eps);
  return cudaGetLastError();
}

// ------------------------------------------------ update_apply, the vec route

constexpr int kVecThreads = 256;  // threads per block
constexpr int kVecUnroll = 2;     // vectors of each operand in flight per thread
constexpr int kVecTile = kVecThreads * kVecUnroll;  // vectors per tile

// x / d for 0 <= x < 2^31 by a multiply-high and a shift (Granlund and
// Montgomery): mul = ceil(2^p / d) with p = 31 + ceil(log2 d), exact there.
struct FastDiv {
  uint32_t d, mul, shr;
};

FastDiv fast_div(uint32_t d) {
  FastDiv f{d, 0, 0};
  if (d > 1) {
    uint32_t lg = 0;
    while ((1ull << lg) < d) ++lg;
    f.mul = (uint32_t)(((1ull << (31 + lg)) + d - 1) / d);
    f.shr = lg - 1;
  }
  return f;
}

__device__ __forceinline__ uint32_t quot(uint32_t x, FastDiv f) {
  return f.d == 1 ? x : __umulhi(x, f.mul) >> f.shr;
}

// The flat run of L*m*n elements: [0, head) and [head + nvec*W, + tail)
// element by element, W-element vectors between.
struct VecPlan {
  uint32_t head, nvec, tail;
  FastDiv n, m;  // row length and rows per layer of the (L, m, n) view
  int row_axis;
};

// ss's index for flat element e: col (l, j), row (l, i), i.e. the row
// l*m + i of the (L*m, n) view.
__device__ __forceinline__ uint32_t ss_index(uint32_t e, const VecPlan& p) {
  const uint32_t q = quot(e, p.n);
  return p.row_axis ? q : quot(q, p.m) * p.n.d + (e - q * p.n.d);
}

// W consecutive elements of T held as 32-bit words, moved as 16-byte words.
template <typename T, int W>
struct Pack {
  static constexpr int kWords = W * (int)sizeof(T) / 4;
  uint32_t w[kWords];
  __device__ __forceinline__ float get(int k) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[k]);
    } else {
      return __uint_as_float(k & 1 ? w[k >> 1] & 0xffff0000u : w[k >> 1] << 16);
    }
  }
  __device__ __forceinline__ void set(const float (&x)[W]) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if constexpr (sizeof(T) == 4) {
        w[k] = __float_as_uint(x[k]);
      } else {
        const __nv_bfloat162 b = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
        w[k] = (uint32_t)__bfloat16_as_ushort(b.x) | (uint32_t)__bfloat16_as_ushort(b.y) << 16;
      }
    }
  }
};

// 16-byte accesses of the streamed operands, each byte used once: theta at
// L2's evict-first priority (.cs), g read-only and not kept in L1, theta's
// stores streamed, so that L2 keeps ss. Volatile keeps them in the order
// written: all of a tile's loads go out before its first use.
__device__ __forceinline__ void ld_cs(uint32_t* w, const void* p) {
  asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "l"(p));
}
__device__ __forceinline__ void ld_nc(uint32_t* w, const void* p) {
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "l"(p));
}
__device__ __forceinline__ void st_cs(void* p, const uint32_t* w) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(w[0]), "r"(w[1]),
               "r"(w[2]), "r"(w[3])
               : "memory");
}

// ss for the W elements from flat element e. Within one row: a row vector
// shares one word; a col vector's W consecutive words are read as the
// aligned 16-byte words that hold them (a word past the start's offset o
// holds at least one of them, so it lies in ss's allocation) and shifted by
// o with selects. Across a row end: word by word.
template <int W>
__device__ __forceinline__ void load_ss(float (&s)[W], const float* __restrict__ ss, uint32_t e,
                                        const VecPlan& p) {
  const uint32_t q = quot(e, p.n), j = e - q * p.n.d;
  if (j + W <= p.n.d) {
    if (p.row_axis) {
      const float v = __ldg(ss + q);
#pragma unroll
      for (int k = 0; k < W; ++k) s[k] = v;
      return;
    }
    const float* src = ss + quot(q, p.m) * p.n.d + j;
    const float4* a =
        reinterpret_cast<const float4*>(reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15));
    const int o = (int)(reinterpret_cast<uintptr_t>(src) >> 2) & 3;
    float win[W + 4];
#pragma unroll
    for (int c = 0; c <= W / 4; ++c) {
      const float4 v = c < W / 4 || o ? __ldg(a + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      win[4 * c] = v.x;
      win[4 * c + 1] = v.y;
      win[4 * c + 2] = v.z;
      win[4 * c + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float lo = o & 1 ? win[k + 1] : win[k];
      const float hi = o & 1 ? win[k + 3] : win[k + 2];
      s[k] = o & 2 ? hi : lo;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < W; ++k) s[k] = __ldg(ss + ss_index(e + k, p));
}

// theta -= lr * (gs * g) / (sqrt(ss) + eps) over the flat run, in place.
template <typename Tt, typename Tg, int W>
__global__ void __launch_bounds__(kVecThreads)
update_apply_vec_kernel(Tt* __restrict__ theta, const Tg* __restrict__ g,
                        const float* __restrict__ ss, VecPlan p, const float* __restrict__ lr_p,
                        float lr_v, const float* __restrict__ gs_p, float gs_v, float eps) {
  const float lr = scalar(lr_p, lr_v), gs = scalar(gs_p, gs_v);
  if (blockIdx.x == 0 && threadIdx.x < p.head + p.tail) {  // the ragged ends
    const uint32_t e = threadIdx.x < p.head ? threadIdx.x : threadIdx.x + p.nvec * W;
    store(&theta[e], update_value(to_f32(theta[e]), to_f32(g[e]), __ldg(ss + ss_index(e, p)), lr,
                                  gs, eps));
  }
  Tt* tb = theta + p.head;  // 16-byte aligned, as is g + head
  const Tg* gb = g + p.head;
  for (uint32_t t0 = blockIdx.x * kVecTile; t0 < p.nvec; t0 += gridDim.x * kVecTile) {
    Pack<Tt, W> th[kVecUnroll];
    Pack<Tg, W> gv[kVecUnroll];
    float sv[kVecUnroll][W];
    // every vector's theta and g in flight before ss, whose loads wait on
    // their own (short) round trip
#pragma unroll
    for (int u = 0; u < kVecUnroll; ++u) {
      const uint32_t v = t0 + u * kVecThreads + threadIdx.x;
      if (v < p.nvec) {
#pragma unroll
        for (int c = 0; c < Pack<Tt, W>::kWords; c += 4)
          ld_cs(&th[u].w[c], tb + (size_t)v * W + c * 4 / sizeof(Tt));
#pragma unroll
        for (int c = 0; c < Pack<Tg, W>::kWords; c += 4)
          ld_nc(&gv[u].w[c], gb + (size_t)v * W + c * 4 / sizeof(Tg));
      }
    }
#pragma unroll
    for (int u = 0; u < kVecUnroll; ++u) {
      const uint32_t v = t0 + u * kVecThreads + threadIdx.x;
      if (v < p.nvec) load_ss<W>(sv[u], ss, p.head + v * W, p);
    }
#pragma unroll
    for (int u = 0; u < kVecUnroll; ++u) {
      const uint32_t v = t0 + u * kVecThreads + threadIdx.x;
      if (v < p.nvec) {
        float out[W];
#pragma unroll
        for (int k = 0; k < W; ++k)
          out[k] = update_value(th[u].get(k), gv[u].get(k), sv[u][k], lr, gs, eps);
        th[u].set(out);
#pragma unroll
        for (int c = 0; c < Pack<Tt, W>::kWords; c += 4)
          st_cs(tb + (size_t)v * W + c * 4 / sizeof(Tt), &th[u].w[c]);
      }
    }
  }
}

template <typename Tt, typename Tg, int W>
cudaError_t launch_update_vec(void* theta, const void* g, const float* ss, const VecPlan& p,
                              const float* lr_p, float lr_v, const float* gs_p, float gs_v,
                              float eps, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(static_cast<Tt*>(theta) + p.head) |
       reinterpret_cast<uintptr_t>(static_cast<const Tg*>(g) + p.head)) & 15)
    return cudaErrorMisalignedAddress;
  static int resident = 0;  // blocks the card holds at once: the persistent grid
  if (resident == 0) {
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, update_apply_vec_kernel<Tt, Tg, W>, kVecThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * per_sm;
  }
  const uint32_t tiles = (p.nvec + kVecTile - 1) / kVecTile;
  const unsigned grid = tiles < 1 ? 1 : (tiles < (uint32_t)resident ? tiles : resident);
  update_apply_vec_kernel<Tt, Tg, W><<<grid, kVecThreads, 0, stream>>>(
      static_cast<Tt*>(theta), static_cast<const Tg*>(g), ss, p, lr_p, lr_v, gs_p, gs_v, eps);
  return cudaGetLastError();
}

template <typename Tg, typename To>
cudaError_t launch_norm_apply(const void* g, Strides sg, const float* ss, void* out, Shape sh,
                              int row_axis, const float* gs_p, float gs_v, float eps,
                              cudaStream_t stream) {
  norm_apply_kernel<Tg, To><<<ew_grid(sh), kEwThreads, 0, stream>>>(
      static_cast<const Tg*>(g), sg, ss, static_cast<To*>(out), sh, row_axis, gs_p, gs_v, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ss (or, with S > 1, the (L, S, n|m) workspace `part` and then ss) of g.
int norm_sumsq(const void* g, int g_bf16, int64_t gl, int64_t gm, int64_t gn, int L, int m,
               int n, int row_axis, const float* gs_p, float gs_v, float* part, float* out,
               int S, int chunk, cudaStream_t stream) {
  const Strides sg{gl, gm, gn};
  const Shape sh{L, m, n};
  return g_bf16 ? launch_sumsq<__nv_bfloat16>(g, sg, sh, row_axis, gs_p, gs_v, part, out, S,
                                              chunk, stream)
                : launch_sumsq<float>(g, sg, sh, row_axis, gs_p, gs_v, part, out, S, chunk,
                                      stream);
}

int update_apply(void* theta, int t_bf16, int64_t tl, int64_t tm, int64_t tn, const void* g,
                 int g_bf16, int64_t gl, int64_t gm, int64_t gn, const float* ss, int L, int m,
                 int n, int row_axis, const float* lr_p, float lr_v, const float* gs_p,
                 float gs_v, float eps, cudaStream_t stream) {
  const Strides st{tl, tm, tn}, sg{gl, gm, gn};
  const Shape sh{L, m, n};
  if (t_bf16) {
    return g_bf16 ? launch_update<__nv_bfloat16, __nv_bfloat16>(theta, st, g, sg, ss, sh,
                                                                row_axis, lr_p, lr_v, gs_p,
                                                                gs_v, eps, stream)
                  : launch_update<__nv_bfloat16, float>(theta, st, g, sg, ss, sh, row_axis,
                                                        lr_p, lr_v, gs_p, gs_v, eps, stream);
  }
  return g_bf16 ? launch_update<float, __nv_bfloat16>(theta, st, g, sg, ss, sh, row_axis, lr_p,
                                                      lr_v, gs_p, gs_v, eps, stream)
                : launch_update<float, float>(theta, st, g, sg, ss, sh, row_axis, lr_p, lr_v,
                                              gs_p, gs_v, eps, stream);
}

// The vec route: theta and g contiguous, both 16-byte aligned at element
// `head`; head + nvec * W + tail = L*m*n < 2^31, W = 8 with a bf16 operand,
// else 4 (colnorm.py, `vec_split`).
int update_apply_vec(void* theta, int t_bf16, const void* g, int g_bf16, const float* ss, int L,
                     int m, int n, int row_axis, int head, int nvec, int tail, const float* lr_p,
                     float lr_v, const float* gs_p, float gs_v, float eps, cudaStream_t stream) {
  const int W = t_bf16 || g_bf16 ? 8 : 4;
  const int64_t total = (int64_t)L * m * n;
  if (head < 0 || nvec < 0 || tail < 0 || head >= W || tail >= W || total >= (1ll << 31) ||
      head + (int64_t)nvec * W + tail != total)
    return cudaErrorInvalidValue;
  const VecPlan p{(uint32_t)head, (uint32_t)nvec, (uint32_t)tail, fast_div(n), fast_div(m),
                  row_axis};
  if (t_bf16) {
    return g_bf16 ? launch_update_vec<__nv_bfloat16, __nv_bfloat16, 8>(theta, g, ss, p, lr_p, lr_v,
                                                                       gs_p, gs_v, eps, stream)
                  : launch_update_vec<__nv_bfloat16, float, 8>(theta, g, ss, p, lr_p, lr_v, gs_p,
                                                               gs_v, eps, stream);
  }
  return g_bf16 ? launch_update_vec<float, __nv_bfloat16, 8>(theta, g, ss, p, lr_p, lr_v, gs_p,
                                                             gs_v, eps, stream)
                : launch_update_vec<float, float, 4>(theta, g, ss, p, lr_p, lr_v, gs_p, gs_v, eps,
                                                     stream);
}

int norm_apply(const void* g, int g_bf16, int64_t gl, int64_t gm, int64_t gn, const float* ss,
               void* out, int out_bf16, int L, int m, int n, int row_axis, const float* gs_p,
               float gs_v, float eps, cudaStream_t stream) {
  const Strides sg{gl, gm, gn};
  const Shape sh{L, m, n};
  if (g_bf16) {
    return out_bf16 ? launch_norm_apply<__nv_bfloat16, __nv_bfloat16>(
                          g, sg, ss, out, sh, row_axis, gs_p, gs_v, eps, stream)
                    : launch_norm_apply<__nv_bfloat16, float>(g, sg, ss, out, sh, row_axis,
                                                              gs_p, gs_v, eps, stream);
  }
  return out_bf16 ? launch_norm_apply<float, __nv_bfloat16>(g, sg, ss, out, sh, row_axis, gs_p,
                                                            gs_v, eps, stream)
                  : launch_norm_apply<float, float>(g, sg, ss, out, sh, row_axis, gs_p, gs_v,
                                                    eps, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
