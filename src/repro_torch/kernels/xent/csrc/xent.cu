// Fused LM-head cross-entropy for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces three TPU kernels of src/repro/kernels/xent/xent.py:
//   xent_fwd    (`_fwd_kernel` line 149, `pallas_call` line 196)
//   xent_bwd_dh (`_dh_kernel` line 218, `pallas_call` line 271)
//   xent_bwd_dw (`_dw_kernel` line 291, `pallas_call` line 346)
// for the untied head: h (N, D), w (D, V), labels (N,) int32. With
// logits = h @ w in f32 and `ncols` = min(V, vocab_size):
//   xent_fwd:    lse[n] = logsumexp of logits[n, c] over c < ncols, and
//                ll[n] = logits[n, labels[n]] (0 when the label is -1 or
//                >= ncols);
//   xent_bwd_dh: dH = G @ w^T, and xent_bwd_dw: dW = h^T @ G, where
//                G[n, c] = (exp(logits[n, c] - lse[n]) - [c == labels[n]])
//                * gl[n] for c < ncols and n < N, else 0; columns of dW at
//                or past ncols are 0.
// The logit and G matrices never leave a block: no (N, V) array is written.
//
// Numerics follow the TPU kernel bodies: f32 products of the inputs (bf16 or
// f32, read as f32) summed in f32; the running max starts at the finite
// -1e30 and every exp is masked explicitly, so a tile of padding adds
// nothing; w columns past ncols and h rows past N are read as 0 in both
// operands of every contraction. No f32 atomics: each output has one owner
// and every sum runs in a fixed order, so two runs are bitwise equal.
//
// What bounds them on an H100: operations. At llama-1b's loss (N = 4096
// tokens, D = 2048, V = 32000) the forward is 2*N*D*V = 0.537 TFLOP and each
// backward kernel recomputes the logits and contracts once more, 1.074 TFLOP,
// against 0.15 GB of h and w.
//
// Design. The TPU kernel's blocks are sized for VMEM and do not fit
// Hopper's 227 KB of shared memory, and its sequential grid carries the
// log-sum-exp and the accumulators from step to step. Here a block owns a narrow tile and walks
// the other axis in a loop: token rows walking the vocab (forward, dH), or
// vocab columns walking the tokens (dW). Each function has two kernels:
//   * tensor cores (mma.sync m16n8k16, bf16 products, f32 sums) for bf16
//     operands whose rows are contiguous and 16-byte aligned, the main path;
//     their notes are at xent_fwd_mma_kernel and xent_bwd_mma_kernel;
//   * f32 FMAs for f32 operands and any other layout, below.
// The FMA kernels: a block of 512 threads owns IT items (16 for bf16, 8 for
// f32: 32 bytes per row of D), kept in shared memory as (D, IT), and stages
// IT items of the other operand per step (2 * 32 * D bytes: 128 KB at
// D = 2048; above 48 KB by the opt-in). The IT x IT logit tile is a sum over
// D split across the 16 warps (each lane 8 or 2 outputs over its warp's
// share of D), and the 16 partials are added in warp order. The forward
// folds the tile into a running (max, sum, label logit) per row; the
// backward forms the G tile and adds G @ (streamed operand)^T into an
// (IT, D) f32 accumulator held in registers, each thread owning IT rows of
// 4 columns of D (so D <= 2048).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // finite -inf stand-in, as the TPU kernel's
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNdt = 4;  // accumulator columns of D per thread: D <= 2048

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16_rn(0.f); }

template <typename T>
struct Items {
  static constexpr int n = 32 / sizeof(T);  // one 32-byte row of the tile
};

// n consecutive elements of shared memory as f32; p is 16-byte aligned.
template <int n>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* o) {
  static_assert(n % 8 == 0, "bf16 rows load in 16-byte pieces");
#pragma unroll
  for (int c = 0; c < n / 8; ++c) {
    uint4 raw = reinterpret_cast<const uint4*>(p)[c];
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h2[i]);
      o[8 * c + 2 * i] = f.x;
      o[8 * c + 2 * i + 1] = f.y;
    }
  }
}
template <int n>
__device__ __forceinline__ void load_f32(const float* p, float* o) {
  static_assert(n % 2 == 0, "f32 rows load in 8-byte pieces");
#pragma unroll
  for (int c = 0; c < n / 2; ++c) {
    float2 f = reinterpret_cast<const float2*>(p)[c];
    o[2 * c] = f.x;
    o[2 * c + 1] = f.y;
  }
}

struct Operand {
  const void* p;
  int64_t s0, s1;  // element strides: h (n, d), w (d, v)
};

// IT rows [row0, row0 + nvalid) of h into dst (D, IT); rows past nvalid are
// 0. Each thread gathers one d of all IT rows (coalesced along d) and
// writes its 32-byte row at once.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, Operand h, int row0, int nvalid, int D) {
  constexpr int IT = Items<T>::n;
  const T* src = static_cast<const T*>(h.p);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    alignas(16) T v[IT];
#pragma unroll
    for (int j = 0; j < IT; ++j)
      v[j] = j < nvalid ? src[(int64_t)(row0 + j) * h.s0 + (int64_t)d * h.s1] : zero<T>();
    uint4* out = reinterpret_cast<uint4*>(dst + (int64_t)d * IT);
    const uint4* in = reinterpret_cast<const uint4*>(v);
    out[0] = in[0];
    out[1] = in[1];
  }
}

// IT columns [col0, col0 + nvalid) of w into dst (D, IT); columns past
// nvalid are 0. Consecutive threads take consecutive columns of a row.
template <typename T>
__device__ __forceinline__ void load_cols(T* dst, Operand w, int col0, int nvalid, int D) {
  constexpr int IT = Items<T>::n;
  const T* src = static_cast<const T*>(w.p);
  for (int e = threadIdx.x; e < D * IT; e += kThreads) {
    const int d = e / IT, j = e % IT;
    dst[e] = j < nvalid ? src[(int64_t)d * w.s0 + (int64_t)(col0 + j) * w.s1] : zero<T>();
  }
}

// The IT x IT logit tile out[f * IT + s] = sum_d F[d, f] * S[d, s], for the
// threads t < IT * IT (one output each). Warp k sums its share of D into
// red[k], and the 16 partials are added in warp order. Ends synchronized.
template <typename T>
__device__ __forceinline__ float logit_tile(const T* F, const T* S, float* red, int D) {
  constexpr int IT = Items<T>::n;
  constexpr int OPL = IT * IT / 32;  // outputs per lane
  constexpr int LPF = IT / OPL;      // lanes per row f
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = lane / LPF, s0 = (lane % LPF) * OPL;
  const int chunk = (D + kWarps - 1) / kWarps;
  const int d1 = min(D, (warp + 1) * chunk);
  float acc[OPL];
#pragma unroll
  for (int o = 0; o < OPL; ++o) acc[o] = 0.f;
  for (int d = warp * chunk; d < d1; ++d) {
    const float fv = to_f32(F[d * IT + f]);
    float sv[OPL];
    load_f32<OPL>(S + d * IT + s0, sv);
#pragma unroll
    for (int o = 0; o < OPL; ++o) acc[o] = fmaf(fv, sv[o], acc[o]);
  }
#pragma unroll
  for (int o = 0; o < OPL; ++o) red[warp * IT * IT + f * IT + s0 + o] = acc[o];
  __syncthreads();
  float x = 0.f;
  if (threadIdx.x < IT * IT) {
#pragma unroll
    for (int k = 0; k < kWarps; ++k) x += red[k * IT * IT + threadIdx.x];
  }
  return x;
}

// F and S (32 bytes per d each), the warps' partial tiles and the G tile.
template <typename T>
constexpr size_t smem_bytes(int D) {
  return 2 * (size_t)D * 32 + sizeof(float) * (kWarps + 1) * Items<T>::n * Items<T>::n;
}

// One block per IT token rows; walks the vocab tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
xent_fwd_kernel(Operand h, Operand w, const int* __restrict__ labels, float* __restrict__ lse,
                float* __restrict__ ll, int N, int D, int ncols) {
  constexpr int IT = Items<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  T* F = reinterpret_cast<T*>(smem);
  T* S = F + (size_t)D * IT;
  float* red = reinterpret_cast<float*>(S + (size_t)D * IT);

  const int n0 = blockIdx.x * IT;
  load_rows<T>(F, h, n0, min(IT, N - n0), D);
  const int t = threadIdx.x, f = t / IT, s = t % IT;
  const int row = n0 + f;
  const bool owner = t < IT * IT;
  const int label = owner && row < N ? labels[row] : -1;
  float m = kNeg, sum = 0.f, lab = 0.f;  // sum and lab are this lane's share

  for (int v0 = 0; v0 < ncols; v0 += IT) {
    __syncthreads();  // the previous tile is consumed (and F is staged)
    load_cols<T>(S, w, v0, min(IT, ncols - v0), D);
    __syncthreads();
    const float x = logit_tile<T>(F, S, red, D);
    if (owner) {
      const int col = v0 + s;
      const bool valid = col < ncols;
      const float xv = valid ? x : kNeg;
      float tmax = xv;
#pragma unroll
      for (int o = IT / 2; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m, tmax);
      sum = sum * expf(m - m_new) + (valid ? expf(xv - m_new) : 0.f);
      lab += valid && col == label ? xv : 0.f;
      m = m_new;
    }
  }
  if (owner) {
#pragma unroll
    for (int o = IT / 2; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      lab += __shfl_xor_sync(0xffffffffu, lab, o);
    }
    if (s == 0 && row < N) {
      lse[row] = m + logf(sum);
      ll[row] = lab;
    }
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// The backward: acc[f, d] = sum_s G[f, s] * S[d, s] over the streamed tiles.
//   dh (TOK_F): f = token rows (F = h rows), s = vocab columns (S = w);
//   dw:         f = vocab columns (F = w),   s = token rows (S = h rows).
template <typename T, typename O, bool TOK_F>
__global__ void __launch_bounds__(kThreads, 1)
xent_bwd_kernel(Operand h, Operand w, const int* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ gl, O* __restrict__ out,
                int N, int D, int V, int ncols) {
  constexpr int IT = Items<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  T* F = reinterpret_cast<T*>(smem);
  T* S = F + (size_t)D * IT;
  float* red = reinterpret_cast<float*>(S + (size_t)D * IT);
  float* G = red + kWarps * IT * IT;

  const int f0 = blockIdx.x * IT;
  const int t = threadIdx.x, f = t / IT, s = t % IT;
  const bool owner = t < IT * IT;
  float acc[IT][kNdt];
#pragma unroll
  for (int i = 0; i < IT; ++i)
#pragma unroll
    for (int k = 0; k < kNdt; ++k) acc[i][k] = 0.f;

  int n_stream;
  int lab_f = -1;
  float lse_f = 0.f, gl_f = 0.f;
  if (TOK_F) {
    load_rows<T>(F, h, f0, min(IT, N - f0), D);
    n_stream = ncols;
    if (owner && f0 + f < N) {
      lab_f = labels[f0 + f];
      lse_f = lse[f0 + f];
      gl_f = gl[f0 + f];
    }
  } else {
    // vocab columns past ncols get no gradient: skip straight to the writes
    n_stream = f0 < ncols ? N : 0;
    if (n_stream) load_cols<T>(F, w, f0, min(IT, ncols - f0), D);
  }

  for (int s0 = 0; s0 < n_stream; s0 += IT) {
    __syncthreads();  // the previous tile is consumed (and F is staged)
    if (TOK_F)
      load_cols<T>(S, w, s0, min(IT, ncols - s0), D);
    else
      load_rows<T>(S, h, s0, min(IT, N - s0), D);
    __syncthreads();
    const float x = logit_tile<T>(F, S, red, D);
    if (owner) {
      const int tok = TOK_F ? f0 + f : s0 + s;
      const int col = TOK_F ? s0 + s : f0 + f;
      float g = 0.f;
      if (tok < N && col < ncols) {
        float l_t = lse_f, g_t = gl_f;
        int lab = lab_f;
        if (!TOK_F) {
          l_t = lse[tok];
          g_t = gl[tok];
          lab = labels[tok];
        }
        g = (expf(x - l_t) - (col == lab ? 1.f : 0.f)) * g_t;
      }
      G[f * IT + s] = g;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kNdt; ++k) {
      const int d = t + k * kThreads;
      if (d < D) {
        float sv[IT];
        load_f32<IT>(S + (size_t)d * IT, sv);
#pragma unroll
        for (int i = 0; i < IT; ++i) {
          const float4* gr = reinterpret_cast<const float4*>(G + i * IT);
          float a = acc[i][k];
#pragma unroll
          for (int c = 0; c < IT / 4; ++c) {
            const float4 g4 = gr[c];
            a = fmaf(g4.x, sv[4 * c], a);
            a = fmaf(g4.y, sv[4 * c + 1], a);
            a = fmaf(g4.z, sv[4 * c + 2], a);
            a = fmaf(g4.w, sv[4 * c + 3], a);
          }
          acc[i][k] = a;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kNdt; ++k) {
    const int d = t + k * kThreads;
    if (d >= D) continue;
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      if (TOK_F) {
        if (f0 + i < N) store(out + (int64_t)(f0 + i) * D + d, acc[i][k]);
      } else {
        if (f0 + i < V) store(out + (int64_t)d * V + f0 + i, acc[i][k]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 forward on tensor cores. A block of 4 warps owns 64 token rows
// (16 per warp) and a range of the vocab tiles of 128 columns (a split of
// the vocab, so that the 132 SMs fill at N = 4096); the logit tile is
// mma.sync m16n8k16 (bf16 products, f32 sums) over D in chunks of 32,
// staged by cp.async in two buffers, the next chunk's copy in flight while
// the current one is multiplied. Each split writes a partial (max, sum,
// label logit) per row to a workspace, and a second launch combines the
// splits in order: no atomics. Needs rows of h and w contiguous along D and
// V, 16-byte aligned (D and V multiples of 8); other bf16 layouts and f32
// take the FMA kernel above.
constexpr int kMmaBM = 64, kMmaBN = 128, kMmaBK = 32, kMmaThreads = 128;
constexpr int kAStride = kMmaBK + 8;  // 80-byte rows: ldmatrix without bank conflicts
constexpr int kBStride = kMmaBN + 8;  // 272-byte rows

// Copy the first n of 16 bytes (0 <= n <= 16) and fill the rest with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
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
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kMmaThreads)
xent_fwd_mma_kernel(const __nv_bfloat16* __restrict__ h, int64_t sh, const __nv_bfloat16* __restrict__ w,
                    int64_t sw, const int* __restrict__ labels, float* __restrict__ part, int N, int D,
                    int V, int ncols, int tiles_per_split) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kMmaBM * kAStride];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kMmaBK * kBStride];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * kMmaBM;
  const int split = blockIdx.y, splits = gridDim.y;
  const int jt0 = split * tiles_per_split;
  const int n_vt = (ncols + kMmaBN - 1) / kMmaBN;
  const int n_tiles = max(0, min(n_vt, jt0 + tiles_per_split) - jt0);
  const int nk = (D + kMmaBK - 1) / kMmaBK;
  const int total = n_tiles * nk;

  // the copy of step idx = (vocab tile, D chunk) into buffer buf
  auto load = [&](int idx, int buf) {
    const int v0 = (jt0 + idx / nk) * kMmaBN, k0 = (idx % nk) * kMmaBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A: 64 rows x 4 pieces of 8
      const int p = threadIdx.x + i * kMmaThreads, r = p >> 2, c = (p & 3) * 8;
      const bool ok = n0 + r < N && k0 + c < D;
      cp_async16(&As[buf][r * kAStride + c], ok ? h + (int64_t)(n0 + r) * sh + k0 + c : h,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // B: 32 rows x 16 pieces of 8
      const int p = threadIdx.x + i * kMmaThreads, r = p >> 4, c = (p & 15) * 8;
      const bool ok = k0 + r < D && v0 + c < V;
      cp_async16(&Bs[buf][r * kBStride + c], ok ? w + (int64_t)(k0 + r) * sw + v0 + c : w,
                 ok ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  int label[2];
  float m[2], sum[2], lab[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = n0 + warp * 16 + g + 8 * i;
    label[i] = row < N ? labels[row] : -1;
    m[i] = kNeg;
    sum[i] = 0.f;
    lab[i] = 0.f;
  }
  float acc[kMmaBN / 8][4];
#pragma unroll
  for (int j = 0; j < kMmaBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (total > 0) load(0, 0);
  for (int idx = 0; idx < total; ++idx) {
    const int buf = idx & 1;
    if (idx + 1 < total) {
      load(idx + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kMmaBK / 16; ++ks) {
      unsigned a[4];
      const int mi = lane >> 3, r8 = lane & 7;
      ldmatrix_x4(a, &As[buf][(warp * 16 + (mi & 1) * 8 + r8) * kAStride + ks * 16 + (mi >> 1) * 8]);
#pragma unroll
      for (int np = 0; np < kMmaBN / 16; ++np) {
        unsigned b[4];
        ldmatrix_x4_trans(b, &Bs[buf][(ks * 16 + (mi & 1) * 8 + r8) * kBStride + np * 16 + (mi >> 1) * 8]);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // buffer buf is free for the copy of step idx + 2
    if (idx % nk == nk - 1) {  // the tile is complete: fold it into the rows
      const int v0 = (jt0 + idx / nk) * kMmaBN;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float tmax = kNeg;
#pragma unroll
        for (int j = 0; j < kMmaBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = v0 + j * 8 + 2 * t4 + e;
            if (col < ncols) tmax = fmaxf(tmax, acc[j][2 * i + e]);
          }
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m[i], tmax);
        float s = sum[i] * expf(m[i] - m_new);
#pragma unroll
        for (int j = 0; j < kMmaBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = v0 + j * 8 + 2 * t4 + e;
            const float x = acc[j][2 * i + e];
            if (col < ncols) {
              s += expf(x - m_new);
              if (col == label[i]) lab[i] += x;
            }
          }
        sum[i] = s;
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kMmaBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float s = sum[i], l = lab[i];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = n0 + warp * 16 + g + 8 * i;
    if (t4 == 0 && row < N) {
      float* p = part + (int64_t)row * splits + split;  // part (3, N, splits)
      p[0] = m[i];
      p[(int64_t)N * splits] = s;
      p[2 * (int64_t)N * splits] = l;
    }
  }
}

// lse and ll of each row from its splits' partial (max, sum, label logit),
// added in split order.
__global__ void xent_fwd_combine_kernel(const float* __restrict__ part, float* __restrict__ lse,
                                        float* __restrict__ ll, int N, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const float* pm = part + (int64_t)row * splits;
  const float* ps = pm + (int64_t)N * splits;
  const float* pl = ps + (int64_t)N * splits;
  float m = kNeg;
  for (int k = 0; k < splits; ++k) m = fmaxf(m, pm[k]);
  float s = 0.f, l = 0.f;
  for (int k = 0; k < splits; ++k) {
    s += ps[k] * expf(pm[k] - m);
    l += pl[k];
  }
  lse[row] = m + logf(s);
  ll[row] = l;
}

// ---------------------------------------------------------------------------
// The bf16 backward on tensor cores, for the same layouts as the forward
// above (D a multiple of 16). A block of 16 warps owns 16 items: token rows
// for dH, vocab columns for dW. Both operands of a step sit in shared
// memory: 16 rows of h as (16, D) and 16 columns of w as (D, 16). Each step
//   * forms the 16 x 16 logit tile with mma.sync (bf16 products, f32 sums),
//     the 16 warps each over a share of D, adding their partials in warp
//     order;
//   * forms G = (softmax - onehot) * gl in f32 and splits it into two bf16
//     halves, hi + lo, which carry G to about 2^-16 of itself;
//   * adds G @ w_tile^T (dH) or G^T @ h_tile (dW) into a (16, D) f32
//     accumulator held in registers: warp k owns columns [128k, 128k + 128)
//     of D, so D <= 2048. Each step's product is formed in a fresh tile
//     and added with an IEEE add: the tensor cores' accumulation truncates,
//     which over the ~2000 steps of one accumulator drifts by 1e-4.
// The streamed tile is copied with cp.async and not overlapped with the
// math (one buffer: the two operands take 160 KB at D = 2048).
constexpr int kBwdIt = 16;            // items (tokens or vocab columns) per block and step
constexpr int kWsStride = kBwdIt + 8;  // 48-byte rows of the (D, 16) w tile
constexpr int kGStride = kBwdIt + 8;

inline size_t bwd_mma_smem(int D) {
  return 2 * ((size_t)kBwdIt * (D + 8) + (size_t)D * kWsStride + 2 * kBwdIt * kGStride) +
         sizeof(float) * kWarps * kBwdIt * kBwdIt;
}

__device__ __forceinline__ void store2(void* out, int out_bf16, int64_t i, float a, float b) {
  if (out_bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + i) =
        __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) = make_float2(a, b);
}
__device__ __forceinline__ void store1(void* out, int out_bf16, int64_t i, float a) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(a);
  else
    static_cast<float*>(out)[i] = a;
}

template <bool DH>
__global__ void __launch_bounds__(kThreads, 1)
xent_bwd_mma_kernel(const __nv_bfloat16* __restrict__ h, int64_t sh,
                    const __nv_bfloat16* __restrict__ w, int64_t sw, const int* __restrict__ labels,
                    const float* __restrict__ lse, const float* __restrict__ gl, void* out,
                    int out_bf16, int N, int D, int V, int ncols) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hs = D + 8;  // row stride of the h tile, in elements
  __nv_bfloat16* Hs = reinterpret_cast<__nv_bfloat16*>(smem);  // (16, D)
  __nv_bfloat16* Ws = Hs + kBwdIt * hs;                           // (D, 16)
  __nv_bfloat16* Ghi = Ws + (size_t)D * kWsStride;                // (16 tokens, 16 columns)
  __nv_bfloat16* Glo = Ghi + kBwdIt * kGStride;
  float* red = reinterpret_cast<float*>(Glo + kBwdIt * kGStride);  // (16 warps, 16, 16)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int f0 = blockIdx.x * kBwdIt;

  auto load_h = [&](int r0) {  // rows [r0, r0 + 16) of h; rows >= N are 0
    const int pieces = D / 8;
    for (int p = threadIdx.x; p < kBwdIt * pieces; p += kThreads) {
      const int r = p / pieces, c = (p % pieces) * 8;
      const bool ok = r0 + r < N;
      cp_async16(Hs + r * hs + c, ok ? h + (int64_t)(r0 + r) * sh + c : h, ok ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto load_w = [&](int c0) {  // columns [c0, c0 + 16) of w; columns >= ncols are 0
    for (int p = threadIdx.x; p < D * 2; p += kThreads) {
      const int d = p >> 1, c = (p & 1) * 8;
      const int n = 2 * max(0, min(8, ncols - c0 - c));
      cp_async16(Ws + d * kWsStride + c, n ? w + (int64_t)d * sw + c0 + c : w, n);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[16][4];  // (16 items, this warp's 128 columns of D)
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int n_stream;
  if (DH) {
    load_h(f0);
    n_stream = ncols;
  } else {
    n_stream = f0 < ncols ? N : 0;
    if (n_stream) load_w(f0);
  }
  const int ksteps = D / 16, ks_per = (ksteps + kWarps - 1) / kWarps;
  const int ks0 = warp * ks_per, ks1 = min(ksteps, ks0 + ks_per);
  const int d_warp = warp * 128;

  for (int s0 = 0; s0 < n_stream; s0 += kBwdIt) {
    if (DH)
      load_w(s0);
    else
      load_h(s0);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // this warp's share of the logit tile (tokens x columns) over D
    float lg[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int ks = ks0; ks < ks1; ++ks) {
      unsigned a[4], b[4];
      ldmatrix_x4(a, Hs + ((mi & 1) * 8 + r8) * hs + ks * 16 + (mi >> 1) * 8);
      ldmatrix_x4_trans(b, Ws + (ks * 16 + (mi & 1) * 8 + r8) * kWsStride + (mi >> 1) * 8);
      mma_bf16(lg[0], a, b[0], b[1]);
      mma_bf16(lg[1], a, b[2], b[3]);
    }
    float* rw = red + warp * kBwdIt * kBwdIt;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        rw[g * kBwdIt + j * 8 + 2 * t4 + e] = lg[j][e];
        rw[(g + 8) * kBwdIt + j * 8 + 2 * t4 + e] = lg[j][2 + e];
      }
    __syncthreads();

    if (threadIdx.x < kBwdIt * kBwdIt) {
      float x = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) x += red[k * kBwdIt * kBwdIt + threadIdx.x];
      const int ti = threadIdx.x / kBwdIt, ci = threadIdx.x % kBwdIt;
      const int tok = DH ? f0 + ti : s0 + ti;
      const int col = DH ? s0 + ci : f0 + ci;
      float gv = 0.f;
      if (tok < N && col < ncols)
        gv = (expf(x - lse[tok]) - (col == labels[tok] ? 1.f : 0.f)) * gl[tok];
      const __nv_bfloat16 hi = __float2bfloat16_rn(gv);
      Ghi[ti * kGStride + ci] = hi;
      Glo[ti * kGStride + ci] = __float2bfloat16_rn(gv - __bfloat162float(hi));
    }
    __syncthreads();

    if (d_warp < D) {
      unsigned ahi[4], alo[4];
      if (DH) {  // A = G (tokens x columns)
        ldmatrix_x4(ahi, Ghi + ((mi & 1) * 8 + r8) * kGStride + (mi >> 1) * 8);
        ldmatrix_x4(alo, Glo + ((mi & 1) * 8 + r8) * kGStride + (mi >> 1) * 8);
      } else {  // A = G^T (columns x tokens)
        ldmatrix_x4_trans(ahi, Ghi + ((mi >> 1) * 8 + r8) * kGStride + (mi & 1) * 8);
        ldmatrix_x4_trans(alo, Glo + ((mi >> 1) * 8 + r8) * kGStride + (mi & 1) * 8);
      }
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        const int d0 = d_warp + np * 16;
        if (d0 < D) {
          unsigned b[4];
          if (DH)  // B[k = column][n = d] = w[d][column]
            ldmatrix_x4(b, Ws + (d0 + (mi >> 1) * 8 + r8) * kWsStride + (mi & 1) * 8);
          else  // B[k = token][n = d] = h[token][d]
            ldmatrix_x4_trans(b, Hs + ((mi & 1) * 8 + r8) * hs + d0 + (mi >> 1) * 8);
          // each step's product goes to a fresh tile that an IEEE add folds
          // into acc: the tensor cores' own accumulation truncates, and
          // over thousands of steps into one register it drifts by 1e-4
          float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(p0, ahi, b[0], b[1]);
          mma_bf16(p0, alo, b[0], b[1]);
          mma_bf16(p1, ahi, b[2], b[3]);
          mma_bf16(p1, alo, b[2], b[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[2 * np][e] += p0[e];
            acc[2 * np + 1][e] += p1[e];
          }
        }
      }
    }
    __syncthreads();  // the tiles are free for the next copy
  }

  // acc rows: items g and g + 8; columns d_warp + 8j + 2*t4 + {0, 1}
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int d = d_warp + j * 8 + 2 * t4;
    if (d >= D) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int item = f0 + g + 8 * i;
      if (DH) {
        if (item < N) store2(out, out_bf16, (int64_t)item * D + d, acc[j][2 * i], acc[j][2 * i + 1]);
      } else if (item < V) {
        store1(out, out_bf16, (int64_t)d * V + item, acc[j][2 * i]);
        store1(out, out_bf16, (int64_t)(d + 1) * V + item, acc[j][2 * i + 1]);
      }
    }
  }
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  // Above 48 KB a launch is refused unless the kernel opts in.
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t launch_fwd(Operand h, Operand w, const int* labels, float* lse, float* ll, int N,
                       int D, int ncols, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(D);
  cudaError_t e = prepare(xent_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const int IT = Items<T>::n;
  xent_fwd_kernel<T><<<(N + IT - 1) / IT, kThreads, smem, stream>>>(h, w, labels, lse, ll, N, D,
                                                                     ncols);
  return cudaGetLastError();
}

template <typename T, typename O, bool TOK_F>
cudaError_t launch_bwd(Operand h, Operand w, const int* labels, const float* lse,
                       const float* gl, void* out, int N, int D, int V, int ncols,
                       cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(D);
  cudaError_t e = prepare(xent_bwd_kernel<T, O, TOK_F>, smem);
  if (e != cudaSuccess) return e;
  const int IT = Items<T>::n;
  const int blocks = TOK_F ? (N + IT - 1) / IT : (V + IT - 1) / IT;
  xent_bwd_kernel<T, O, TOK_F><<<blocks, kThreads, smem, stream>>>(
      h, w, labels, lse, gl, static_cast<O*>(out), N, D, V, ncols);
  return cudaGetLastError();
}

template <bool TOK_F>
cudaError_t bwd(int is_bf16, int out_bf16, Operand h, Operand w, const int* labels,
                const float* lse, const float* gl, void* out, int N, int D, int V, int ncols,
                cudaStream_t s) {
  using bf = __nv_bfloat16;
  if (is_bf16)
    return out_bf16 ? launch_bwd<bf, bf, TOK_F>(h, w, labels, lse, gl, out, N, D, V, ncols, s)
                    : launch_bwd<bf, float, TOK_F>(h, w, labels, lse, gl, out, N, D, V, ncols, s);
  return out_bf16 ? launch_bwd<float, bf, TOK_F>(h, w, labels, lse, gl, out, N, D, V, ncols, s)
                  : launch_bwd<float, float, TOK_F>(h, w, labels, lse, gl, out, N, D, V, ncols, s);
}

}  // namespace

extern "C" {

// h (N, D) with element strides (sh_n, sh_d), w (D, V) with (sw_d, sw_v),
// both bf16 (is_bf16) or f32; labels (N,) int32, lse/ll/gl (N,) f32, all
// contiguous. ncols = min(V, vocab_size). Returns the launch's cudaError_t.
int xent_fwd(const void* h, int64_t sh_n, int64_t sh_d, const void* w, int64_t sw_d,
             int64_t sw_v, int is_bf16, const int* labels, float* lse, float* ll, int N, int D,
             int ncols, void* stream) {
  const Operand oh{h, sh_n, sh_d}, ow{w, sw_d, sw_v};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16 ? launch_fwd<__nv_bfloat16>(oh, ow, labels, lse, ll, N, D, ncols, s)
                          : launch_fwd<float>(oh, ow, labels, lse, ll, N, D, ncols, s);
  return static_cast<int>(e);
}

// The tensor-core forward for bf16: h rows and w rows contiguous and 16-byte
// aligned (strides sh, sw in elements, multiples of 8; D and V multiples of
// 8), part a (3, N, splits) f32 workspace, each split taking tiles_per_split
// vocab tiles of 128 columns.
int xent_fwd_mma(const void* h, int64_t sh, const void* w, int64_t sw, const int* labels,
                 float* part, float* lse, float* ll, int N, int D, int V, int ncols, int splits,
                 int tiles_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + kMmaBM - 1) / kMmaBM, splits);
  xent_fwd_mma_kernel<<<grid, kMmaThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(h), sh,
                                                   static_cast<const __nv_bfloat16*>(w), sw,
                                                   labels, part, N, D, V, ncols,
                                                   tiles_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  xent_fwd_combine_kernel<<<(N + 255) / 256, 256, 0, s>>>(part, lse, ll, N, splits);
  return static_cast<int>(cudaGetLastError());
}

// dH (N, D) contiguous, in f32 or bf16 (out_bf16).
int xent_bwd_dh(const void* h, int64_t sh_n, int64_t sh_d, const void* w, int64_t sw_d,
                int64_t sw_v, int is_bf16, const int* labels, const float* lse, const float* gl,
                void* dh, int out_bf16, int N, int D, int V, int ncols, void* stream) {
  return static_cast<int>(bwd<true>(is_bf16, out_bf16, {h, sh_n, sh_d}, {w, sw_d, sw_v}, labels,
                                    lse, gl, dh, N, D, V, ncols,
                                    static_cast<cudaStream_t>(stream)));
}

// dW (D, V) contiguous, in f32 or bf16 (out_bf16).
int xent_bwd_dw(const void* h, int64_t sh_n, int64_t sh_d, const void* w, int64_t sw_d,
                int64_t sw_v, int is_bf16, const int* labels, const float* lse, const float* gl,
                void* dw, int out_bf16, int N, int D, int V, int ncols, void* stream) {
  return static_cast<int>(bwd<false>(is_bf16, out_bf16, {h, sh_n, sh_d}, {w, sw_d, sw_v}, labels,
                                     lse, gl, dw, N, D, V, ncols,
                                     static_cast<cudaStream_t>(stream)));
}

// The tensor-core dH (dh = 1, (N, D)) or dW (dh = 0, (D, V)), contiguous, in
// f32 or bf16 (out_bf16), for the layouts of xent_fwd_mma with D a multiple
// of 16 and D <= 2048.
int xent_bwd_mma(int dh, const void* h, int64_t sh, const void* w, int64_t sw,
                 const int* labels, const float* lse, const float* gl, void* out, int out_bf16,
                 int N, int D, int V, int ncols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_mma_smem(D);
  auto hp = static_cast<const __nv_bfloat16*>(h);
  auto wp = static_cast<const __nv_bfloat16*>(w);
  cudaError_t e;
  if (dh) {
    e = prepare(xent_bwd_mma_kernel<true>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    xent_bwd_mma_kernel<true><<<(N + kBwdIt - 1) / kBwdIt, kThreads, smem, s>>>(
        hp, sh, wp, sw, labels, lse, gl, out, out_bf16, N, D, V, ncols);
  } else {
    e = prepare(xent_bwd_mma_kernel<false>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    xent_bwd_mma_kernel<false><<<(V + kBwdIt - 1) / kBwdIt, kThreads, smem, s>>>(
        hp, sh, wp, sw, labels, lse, gl, out, out_bf16, N, D, V, ncols);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
