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
// The FMA kernels and the tensor-core forward keep the logits on chip;
// the tensor-core backward writes G for one chunk of the vocabulary at a
// time to a workspace of at most 64 MiB (no (N, V) array).
//
// Numerics follow the TPU kernel bodies: products of the inputs (bf16 or
// f32) summed in f32; the running max starts at the finite -1e30 and every
// exp is masked explicitly, so a tile of padding adds nothing; w columns
// past ncols and h rows past N are read as 0 in both operands of every
// contraction. No f32 atomics: each output has one owner and every sum
// runs in a fixed order, so two runs are bitwise equal.
//
// What bounds them on an H100: operations. At llama-1b's loss (N = 4096
// tokens, D = 2048, V = 32000) the forward is 2*N*D*V = 0.537 TFLOP and each
// backward kernel recomputes the logits and contracts once more, 1.074 TFLOP,
// against 0.15 GB of h and w.
//
// Design. The TPU kernel's blocks are sized for VMEM and do not fit
// Hopper's 227 KB of shared memory, and its sequential grid carries the
// log-sum-exp and the accumulators from step to step. Each function has
// two routes:
//   * tensor cores for bf16 operands whose rows are contiguous and 16-byte
//     aligned, the main path. The forward runs on wgmma and TMA (the
//     mainloop of hopper_gemm.cuh; note at FwdEpilogue): it replaces an
//     mma.sync kernel whose 64 x 128 tiles of 16-row warps reached 157
//     TFLOP/s, bound by the ldmatrix traffic every mma.sync needs and by
//     cp.async copies into the same shared memory. wgmma reads both
//     operands from shared memory through descriptors (no ldmatrix, no
//     fragments in registers), TMA copies with no thread instructions, and
//     a 128 x 256 tile per block halves the bytes staged per product; the
//     tile's logits stay in the consumers' registers for the softmax
//     epilogue. It is bound by the tensor cores: its mainloop alone takes
//     about nine tenths of its time, the TMA ring alone about seven tenths,
//     and the epilogue, during which both consumers leave the tensor cores
//     idle, the rest (chip_smoke.py's "fwd" variants; PERF.md). The
//     backward is chunked, a G kernel and a product per chunk, both on one
//     mma.sync GEMM template of 128 x 128 tiles (note at xent_gemm_kernel),
//     with no accumulator that grows with D;
//   * f32 FMAs for f32 operands and any other layout, below. A block of
//     512 threads owns IT items (16 for bf16, 8 for f32: 32 bytes per row
//     of D): token rows walking the vocab (forward, dH) or vocab columns
//     walking the tokens (dW). D is walked in slabs of kSlab = 2048: each
//     step stages a slab of the block's IT items and of IT items of the
//     other operand in shared memory as (slab, IT) (2 * 32 * 2048 bytes:
//     128 KB; above 48 KB by the opt-in). With one slab (D <= 2048) the
//     block's own items stay staged; with more, both operands are staged
//     slab by slab. The IT x IT logit tile of a slab is a sum over the
//     slab split across the 16 warps (each lane 8 or 2 outputs over its
//     warp's share), the 16 partials are added in warp order, and the
//     slabs' tiles in slab order, before the tile is used: a fixed order,
//     so two runs are bitwise equal. The forward folds the tile into a
//     running (max, sum, label logit) per row; the backward forms the G
//     tile and adds G @ (streamed operand)^T into an (IT, kSlab) f32
//     accumulator held in registers, each thread owning IT rows of 4
//     columns of D. A block owns one slab of the output's D (grid y), and
//     recomputes the whole logit tile for it: at D = 4096 the logits are
//     formed twice. Nothing of this limits D.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_gemm.cuh"

namespace {

constexpr float kNeg = -1e30f;  // finite -inf stand-in, as the TPU kernel's
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNdt = 4;  // accumulator columns of D per thread
constexpr int kSlab = kNdt * kThreads;  // D staged (and accumulated) at once

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

// IT rows [row0, row0 + nvalid) of h, columns [d0, d0 + D), into dst (D,
// IT); rows past nvalid are 0. Each thread gathers one d of all IT rows
// (coalesced along d) and writes its 32-byte row at once.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, Operand h, int row0, int nvalid, int d0,
                                          int D) {
  constexpr int IT = Items<T>::n;
  const T* src = static_cast<const T*>(h.p);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    alignas(16) T v[IT];
#pragma unroll
    for (int j = 0; j < IT; ++j)
      v[j] = j < nvalid ? src[(int64_t)(row0 + j) * h.s0 + (int64_t)(d0 + d) * h.s1]
                         : zero<T>();
    uint4* out = reinterpret_cast<uint4*>(dst + (int64_t)d * IT);
    const uint4* in = reinterpret_cast<const uint4*>(v);
    out[0] = in[0];
    out[1] = in[1];
  }
}

// IT columns [col0, col0 + nvalid) of w, rows [d0, d0 + D), into dst (D,
// IT); columns past nvalid are 0. Consecutive threads take consecutive
// columns of a row.
template <typename T>
__device__ __forceinline__ void load_cols(T* dst, Operand w, int col0, int nvalid, int d0,
                                          int D) {
  constexpr int IT = Items<T>::n;
  const T* src = static_cast<const T*>(w.p);
  for (int e = threadIdx.x; e < D * IT; e += kThreads) {
    const int d = e / IT, j = e % IT;
    dst[e] = j < nvalid ? src[(int64_t)(d0 + d) * w.s0 + (int64_t)(col0 + j) * w.s1] : zero<T>();
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

// F and S (32 bytes per d of a slab each), the warps' partial tiles and
// the G tile.
template <typename T>
constexpr size_t smem_bytes(int D) {
  return 2 * (size_t)std::min(D, kSlab) * 32 +
         sizeof(float) * (kWarps + 1) * Items<T>::n * Items<T>::n;
}

// The IT x IT logit tile of the block's items F (rows of h or columns of w,
// at f0) against the streamed items S (at s0), summed over D's slabs in
// order, for the threads t < IT * IT. With one slab F is staged by the
// caller, once; with more, each slab of both is staged here. Leaves the
// last slab of S staged; ends synchronized.
template <typename T, bool TOK_F>
__device__ __forceinline__ float logits(T* F, T* S, float* red, Operand h, Operand w, int f0,
                                        int nf, int s0, int ns, int D) {
  const int nslab = (D + kSlab - 1) / kSlab;
  float x = 0.f;
  for (int k = 0; k < nslab; ++k) {
    const int d0 = k * kSlab, dn = min(kSlab, D - d0);
    __syncthreads();  // the previous tile or slab is consumed (and F staged)
    if (nslab > 1) {
      if (TOK_F)
        load_rows<T>(F, h, f0, nf, d0, dn);
      else
        load_cols<T>(F, w, f0, nf, d0, dn);
    }
    if (TOK_F)
      load_cols<T>(S, w, s0, ns, d0, dn);
    else
      load_rows<T>(S, h, s0, ns, d0, dn);
    __syncthreads();
    const float part = logit_tile<T>(F, S, red, dn);
    x = k ? x + part : part;
  }
  return x;
}

// One block per IT token rows; walks the vocab tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
xent_fwd_kernel(Operand h, Operand w, const int* __restrict__ labels, float* __restrict__ lse,
                float* __restrict__ ll, int N, int D, int ncols) {
  constexpr int IT = Items<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  T* F = reinterpret_cast<T*>(smem);
  T* S = F + (size_t)min(D, kSlab) * IT;
  float* red = reinterpret_cast<float*>(S + (size_t)min(D, kSlab) * IT);

  const int n0 = blockIdx.x * IT, nf = min(IT, N - n0);
  if (D <= kSlab) load_rows<T>(F, h, n0, nf, 0, D);
  const int t = threadIdx.x, f = t / IT, s = t % IT;
  const int row = n0 + f;
  const bool owner = t < IT * IT;
  const int label = owner && row < N ? labels[row] : -1;
  float m = kNeg, sum = 0.f, lab = 0.f;  // sum and lab are this lane's share

  for (int v0 = 0; v0 < ncols; v0 += IT) {
    const float x = logits<T, true>(F, S, red, h, w, n0, nf, v0, min(IT, ncols - v0), D);
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
  T* S = F + (size_t)min(D, kSlab) * IT;
  float* red = reinterpret_cast<float*>(S + (size_t)min(D, kSlab) * IT);
  float* G = red + kWarps * IT * IT;

  const int f0 = blockIdx.x * IT;
  const int d0 = blockIdx.y * kSlab, dn = min(kSlab, D - d0);  // this block's slab of D
  const int t = threadIdx.x, f = t / IT, s = t % IT;
  const bool owner = t < IT * IT;
  float acc[IT][kNdt];
#pragma unroll
  for (int i = 0; i < IT; ++i)
#pragma unroll
    for (int k = 0; k < kNdt; ++k) acc[i][k] = 0.f;

  int n_stream, nf;
  int lab_f = -1;
  float lse_f = 0.f, gl_f = 0.f;
  if (TOK_F) {
    nf = min(IT, N - f0);
    if (D <= kSlab) load_rows<T>(F, h, f0, nf, 0, D);
    n_stream = ncols;
    if (owner && f0 + f < N) {
      lab_f = labels[f0 + f];
      lse_f = lse[f0 + f];
      gl_f = gl[f0 + f];
    }
  } else {
    // vocab columns past ncols get no gradient: skip straight to the writes
    nf = min(IT, ncols - f0);
    n_stream = f0 < ncols ? N : 0;
    if (n_stream && D <= kSlab) load_cols<T>(F, w, f0, nf, 0, D);
  }

  for (int s0 = 0; s0 < n_stream; s0 += IT) {
    const int ns = min(IT, (TOK_F ? ncols : N) - s0);
    const float x = logits<T, TOK_F>(F, S, red, h, w, f0, nf, s0, ns, D);
    // S holds D's last slab; this block's own slab, if another, replaces
    // it (every read of S in logits came before its last barrier)
    if (d0 + kSlab < D) {
      if (TOK_F)
        load_cols<T>(S, w, s0, ns, d0, dn);
      else
        load_rows<T>(S, h, s0, ns, d0, dn);
    }
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
      if (d < dn) {
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
    const int d = d0 + t + k * kThreads;
    if (t + k * kThreads >= dn) continue;
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
// The bf16 forward on wgmma and TMA (the mainloop of hopper_gemm.cuh), for
// h and w rows contiguous and 16-byte aligned, D a multiple of 16. A block
// owns 128 token rows and a contiguous range of vocab tiles of 256 columns
// (a split of the vocabulary: `split_plan` in xent.py, a function of (N,
// ncols) alone, so that about one block per SM fills the card); a tile's
// logits chain over D in the consumers' registers and never leave them.
// The epilogue below folds each finished tile into every row's running
// (max, sum, label logit). TMA zero-fills past the tensor maps' edges (w's
// ends at ncols), and a zero is a logit, so columns >= ncols are masked
// here; -1 labels and labels >= ncols match nothing. Each split writes its
// partial per row to a (3, N, splits) workspace, and a second launch
// combines the splits in order: no atomics, so two runs are bitwise equal.
struct FwdEpilogue {
  const int* labels;
  float* part;  // (3, N, splits): max, sum, label logit
  int N, ncols;
  struct Rows {
    int row, label[2];
    float m[2], s[2], lab[2];
  };
  __device__ __forceinline__ Rows begin(int row) const {
    Rows r;
    r.row = row;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r.label[i] = row + 8 * i < N ? labels[row + 8 * i] : -1;
      r.m[i] = kNeg;
      r.s[i] = 0.f;
      r.lab[i] = 0.f;
    }
    return r;
  }
  // acc[4 j + 2 i + e] is the logit of row r.row + 8 i and column
  // n0 + 8 j + 2 (lane % 4) + e; RAGGED: the tile reaches past ncols.
  template <bool RAGGED>
  __device__ __forceinline__ void fold(Rows& r, const float (&acc)[hopper::kAcc], int n0) const {
    const int c0 = n0 + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tmax = kNeg;
#pragma unroll
      for (int j = 0; j < hopper::kAcc / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (!RAGGED || c0 + 8 * j + e < ncols) tmax = fmaxf(tmax, acc[4 * j + 2 * i + e]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(r.m[i], tmax);
      float s = r.s[i] * expf(r.m[i] - m_new);
#pragma unroll
      for (int j = 0; j < hopper::kAcc / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (!RAGGED || c0 + 8 * j + e < ncols) s += expf(acc[4 * j + 2 * i + e] - m_new);
      r.s[i] = s;
      r.m[i] = m_new;
      const int label = r.label[i];  // in at most one tile of the vocabulary
      if (label < ncols && (unsigned)(label - n0) < (unsigned)hopper::kBN) {
#pragma unroll
        for (int j = 0; j < hopper::kAcc / 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (c0 + 8 * j + e == label) r.lab[i] += acc[4 * j + 2 * i + e];
      }
    }
  }
  __device__ __forceinline__ void tile(Rows& r, const float (&acc)[hopper::kAcc], int n0) const {
    if (n0 + hopper::kBN <= ncols)
      fold<false>(r, acc, n0);
    else
      fold<true>(r, acc, n0);
  }
  __device__ __forceinline__ void end(const Rows& r) const {
    const int split = blockIdx.y, splits = gridDim.y;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float s = r.s[i], l = r.lab[i];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = r.row + 8 * i;
      if ((threadIdx.x & 3) == 0 && row < N) {
        float* p = part + (int64_t)row * splits + split;
        p[0] = r.m[i];
        p[(int64_t)N * splits] = s;
        p[2 * (int64_t)N * splits] = l;
      }
    }
  }
};

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
// mma.sync helpers of the tensor-core backward below.
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

// ---------------------------------------------------------------------------
// The bf16 backward on tensor cores, for the layouts of the forward above
// (D a multiple of 16). The vocabulary is cut into chunks of Vc columns
// and, past 2^17 tokens, the tokens into chunks too (`chunk_plan` in
// xent.py: a function of (N, ncols) alone, with G's workspace at most
// 64 MiB). Each chunk takes two launches of one GEMM template,
// xent_gemm_kernel, with two epilogues:
//   * the G kernel: the chunk's logits h @ w[:, chunk] on the tensor cores,
//     then G = (exp(x - lse) - onehot) * gl in f32, 0 on rows >= N and
//     columns >= ncols, written to a (rows, Vc) workspace as two bf16
//     halves, hi = bf16(G) and lo = bf16(G - hi), which carry G to about
//     2^-16 of itself;
//   * the product: dH (rows, D) += G_c @ w_c^T, summed over the vocabulary
//     chunks in order in f32 (the output itself when it is f32, else a
//     (rows, D) f32 sum whose last chunk writes the output); or dW[:, c] =
//     h^T @ G_c, disjoint per vocabulary chunk (summed over token chunks
//     in order the same way). dW's columns in [ncols, V) are set to 0. A
//     block loads the earlier chunks' sum into its accumulator before its
//     main loop, so the loads land while the ring fills (read in the
//     epilogue instead, they stalled each block).
// The GEMM: a block of 4 warps owns a 128 x 128 tile of C, each warp 64 x
// 64 of it in f32 registers; K-tiles of 32 are staged through a 3-deep
// cp.async ring, the next two copies in flight while one is multiplied
// (two blocks an SM: 255 registers a thread, at most 92 KB each). An
// operand is held as stored: "K-major" (rows along M or N, k contiguous:
// h for the logits, dH's G and w chunk) is read by ldmatrix, the other
// ("M-/N-major": w for the logits, dW's h and G) by ldmatrix.trans. The
// operand split into hi and lo shares the other's fragments: two mma per
// fragment. In the products each K-tile's 4 mma (2 k-steps, hi and lo)
// chain in a fresh fragment that an IEEE add folds into the accumulator:
// the tensor cores' own accumulation truncates, and over the 2,000
// k-steps of dH's sum (the accumulator starts from the earlier chunks')
// it drifts past the f32 tolerance (chip_smoke.py's "chained" variant:
// dH's f32 error over tolerance 1.5 against 0.19 with the fold, dW's 0.41
// against 0.20; the fold costs 8% of dH and 2% of dW: PERF.md). The
// logits chain over D in the accumulator, as the forward's wgmma does.
// Elements outside an operand's valid extent are zero-filled by
// cp.async's source size and never read. No atomics: every sum runs in a
// fixed order, so two runs are bitwise equal. What bounds the template is
// shared memory: with 64 x 64 warp tiles every mma takes 96-128 bytes of
// ldmatrix, and the cp.async copies write into the same banks
// (chip_smoke.py's "no copies" variant runs the pair 1.3-1.5x faster;
// wider blocks or a deeper ring did not help). The forward's wgmma + TMA
// mainloop (hopper_gemm.cuh) has neither cost, and is where the G kernel
// and the products go next (ROADMAP item 16a, continued).
constexpr int kGemmT = 128, kGemmK = 32, kGemmStages = 3, kGemmThreads = 128;
using bf16 = __nv_bfloat16;
using Acc = float[4][8][4];  // a warp's 64 x 64 of C: [16 rows][8 columns][fragment]

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// A GEMM operand as stored: row-major bf16 (row stride ld elements, rows
// 16-byte aligned), of which rows < rows and columns < cols are read and
// the rest reads as 0; lo is the offset of the low half of a split operand.
struct Mat {
  const bf16* p;
  int64_t ld;
  int rows, cols;
  int64_t lo;
};

// A stage's tile of an operand as stored: K-major, 128 rows (along M or N)
// of 32 k; else 32 rows of k by 128. Rows are padded by 16 bytes (80 or
// 272 bytes), so ldmatrix's eight row addresses hit distinct banks.
template <bool KM>
struct Tile {
  static constexpr int rows = KM ? kGemmT : kGemmK, cols = KM ? kGemmK : kGemmT;
  static constexpr int stride = cols + 8, size = rows * stride;
};

template <bool KM>
__device__ __forceinline__ void copy_gemm_tile(bf16* s, const bf16* p, int64_t ld, int rows,
                                               int cols, int r0, int c0) {
  using T = Tile<KM>;
  constexpr int PPR = T::cols / 8;  // 16-byte pieces per row
#pragma unroll
  for (int i = 0; i < T::rows * PPR / kGemmThreads; ++i) {
    const int piece = threadIdx.x + i * kGemmThreads, r = piece / PPR, c = (piece % PPR) * 8;
    const int n = r0 + r < rows ? 2 * max(0, min(8, cols - c0 - c)) : 0;
    cp_async16(s + r * T::stride + c, n ? p + (int64_t)(r0 + r) * ld + c0 + c : p, n);
  }
}

// The A fragment of rows [m, m + 16) and k [kk, kk + 16).
template <bool KM>
__device__ __forceinline__ void frag_a(unsigned* r, const bf16* s, int m, int kk, int lane) {
  constexpr int S = Tile<KM>::stride;
  const int q = lane >> 3, r8 = lane & 7;
  if (KM)
    ldmatrix_x4(r, s + (m + (q & 1) * 8 + r8) * S + kk + (q >> 1) * 8);
  else
    ldmatrix_x4_trans(r, s + (kk + (q >> 1) * 8 + r8) * S + m + (q & 1) * 8);
}
// The B fragments of columns [n, n + 8) (r[0], r[1]) and [n + 8, n + 16)
// (r[2], r[3]) over k [kk, kk + 16).
template <bool KM>
__device__ __forceinline__ void frag_b(unsigned* r, const bf16* s, int n, int kk, int lane) {
  constexpr int S = Tile<KM>::stride;
  const int q = lane >> 3, r8 = lane & 7;
  if (KM)
    ldmatrix_x4(r, s + (n + (q >> 1) * 8 + r8) * S + kk + (q & 1) * 8);
  else
    ldmatrix_x4_trans(r, s + (kk + (q & 1) * 8 + r8) * S + n + (q >> 1) * 8);
}

// c += a0 b0 + ... + a3 b3: the products chained in a fresh fragment,
// scoped inside the asm, added to c with round-to-nearest.
__device__ __forceinline__ void mma_fold4(float* c, const unsigned* a0, const unsigned* b0,
                                          const unsigned* a1, const unsigned* b1,
                                          const unsigned* a2, const unsigned* b2,
                                          const unsigned* a3, const unsigned* b3) {
  asm volatile(
      "{\n.reg .f32 t0, t1, t2, t3;\n"
      "mov.f32 t0, 0f00000000;\nmov.f32 t1, 0f00000000;\n"
      "mov.f32 t2, 0f00000000;\nmov.f32 t3, 0f00000000;\n"
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {t0, t1, t2, t3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {t0, t1, t2, t3};\n"
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {t0, t1, t2, t3}, "
      "{%10, %11, %12, %13}, {%14, %15}, {t0, t1, t2, t3};\n"
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {t0, t1, t2, t3}, "
      "{%16, %17, %18, %19}, {%20, %21}, {t0, t1, t2, t3};\n"
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {t0, t1, t2, t3}, "
      "{%22, %23, %24, %25}, {%26, %27}, {t0, t1, t2, t3};\n"
      "add.rn.f32 %0, %0, t0;\nadd.rn.f32 %1, %1, t1;\n"
      "add.rn.f32 %2, %2, t2;\nadd.rn.f32 %3, %3, t3;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0[0]), "r"(a0[1]), "r"(a0[2]), "r"(a0[3]), "r"(b0[0]), "r"(b0[1]), "r"(a1[0]),
        "r"(a1[1]), "r"(a1[2]), "r"(a1[3]), "r"(b1[0]), "r"(b1[1]), "r"(a2[0]), "r"(a2[1]),
        "r"(a2[2]), "r"(a2[3]), "r"(b2[0]), "r"(b2[1]), "r"(a3[0]), "r"(a3[1]), "r"(a3[2]),
        "r"(a3[3]), "r"(b3[0]), "r"(b3[1]));
}

// One K-tile of a warp's 64 x 64 tile at (wm, wn) of the block: as and bs
// are the stage's A and B tiles (the lo half of a split one follows its hi
// half). All of the unsplit operand's fragments are held while the split
// one's are loaded 16 rows (or columns) at a time; each fragment of C
// takes its hi and lo products over the K-tile's two k-steps in one fold.
// Without a split (the logits) the products chain in acc, as the forward's
// wgmma does.
template <bool A_KM, bool B_KM, bool SPLIT_A, bool SPLIT_B>
__device__ __forceinline__ void gemm_ktile(Acc& acc, const bf16* as, const bf16* bs, int wm,
                                           int wn, int lane) {
  static_assert(!(SPLIT_A && SPLIT_B), "one split operand");
  if constexpr (!SPLIT_B) {
    unsigned b[2][4][4];  // [k-step][16 columns]
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int np = 0; np < 4; ++np) frag_b<B_KM>(b[ks][np], bs, wn + np * 16, ks * 16, lane);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      unsigned a[2][4], al[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        frag_a<A_KM>(a[ks], as, wm + mi * 16, ks * 16, lane);
        if constexpr (SPLIT_A)
          frag_a<A_KM>(al[ks], as + Tile<A_KM>::size, wm + mi * 16, ks * 16, lane);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const unsigned* b0 = &b[0][ni >> 1][(ni & 1) * 2];
        const unsigned* b1 = &b[1][ni >> 1][(ni & 1) * 2];
        if constexpr (SPLIT_A) {
          mma_fold4(acc[mi][ni], a[0], b0, al[0], b0, a[1], b1, al[1], b1);
        } else {
          mma_bf16(acc[mi][ni], a[0], b0[0], b0[1]);
          mma_bf16(acc[mi][ni], a[1], b1[0], b1[1]);
        }
      }
    }
  } else {
    unsigned a[2][4][4];  // [k-step][16 rows]
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) frag_a<A_KM>(a[ks][mi], as, wm + mi * 16, ks * 16, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned bh[2][4], bl[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        frag_b<B_KM>(bh[ks], bs, wn + np * 16, ks * 16, lane);
        frag_b<B_KM>(bl[ks], bs + Tile<B_KM>::size, wn + np * 16, ks * 16, lane);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          mma_fold4(acc[mi][2 * np + j], a[0][mi], &bh[0][2 * j], a[0][mi], &bl[0][2 * j],
                    a[1][mi], &bh[1][2 * j], a[1][mi], &bl[1][2 * j]);
    }
  }
}

// A stage of the ring: A's tile (hi, then lo when split), then B's.
template <bool A_KM, bool B_KM, bool SPLIT_A, bool SPLIT_B>
struct Stage {
  static constexpr int a_size = Tile<A_KM>::size * (1 + SPLIT_A);
  static constexpr int size = a_size + Tile<B_KM>::size * (1 + SPLIT_B);
  static constexpr size_t ring_bytes = sizeof(bf16) * kGemmStages * size;
};

// C (M x N) = A (M x K) @ B (K x N) in f32, handed to the epilogue: A held
// K-major (stored M x K) or M-major (stored K x M), B K-major (stored N x K)
// or N-major (stored K x N). Grid: (N tiles, M tiles).
template <bool A_KM, bool B_KM, bool SPLIT_A, bool SPLIT_B, class Epi>
__global__ void __launch_bounds__(kGemmThreads, 2)
xent_gemm_kernel(Mat A, Mat B, int K, Epi epi) {
  using St = Stage<A_KM, B_KM, SPLIT_A, SPLIT_B>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kGemmT, n0 = blockIdx.x * kGemmT;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 64;
  const int nk = (K + kGemmK - 1) / kGemmK;

  auto load = [&](int kt) {
    bf16* s = smem + (kt % kGemmStages) * St::size;
    bf16* sb = s + St::a_size;
    const int k0 = kt * kGemmK;
    const int ar = A_KM ? m0 : k0, ac = A_KM ? k0 : m0;
    const int br = B_KM ? n0 : k0, bc = B_KM ? k0 : n0;
    copy_gemm_tile<A_KM>(s, A.p, A.ld, A.rows, A.cols, ar, ac);
    if (SPLIT_A)
      copy_gemm_tile<A_KM>(s + Tile<A_KM>::size, A.p + A.lo, A.ld, A.rows, A.cols, ar, ac);
    copy_gemm_tile<B_KM>(sb, B.p, B.ld, B.rows, B.cols, br, bc);
    if (SPLIT_B)
      copy_gemm_tile<B_KM>(sb + Tile<B_KM>::size, B.p + B.lo, B.ld, B.rows, B.cols, br, bc);
  };

  Acc acc;
  epi.init(acc, m0 + wm, n0 + wn, lane);  // its loads land while the ring fills

#pragma unroll
  for (int st = 0; st < kGemmStages - 1; ++st) {
    if (st < nk) load(st);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kGemmStages - 2) : "memory");
    __syncthreads();  // stage kt has landed; stage kt - 1 is free for the copy below
    if (kt + kGemmStages - 1 < nk) load(kt + kGemmStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const bf16* s = smem + (kt % kGemmStages) * St::size;
    gemm_ktile<A_KM, B_KM, SPLIT_A, SPLIT_B>(acc, s, s + St::a_size, wm, wn, lane);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // the ring is free for the epilogue
  epi(acc, m0, n0, wm, wn, lane, smem);
}

// acc[mi][ni][2 * i + e] is C[m + 16 mi + g + 8 i][n + 8 ni + 2 t4 + e] for
// the warp's (m, n), g = lane / 4 and t4 = lane % 4.

// The G kernel's epilogue: G of a logit tile, as bf16 hi and lo halves,
// on rows < M and columns < ncols of the chunk (exactly 0 past ncols),
// staged in shared memory and written in 16-byte pieces, every column of
// the tile (the workspace is as wide as the chunk's tiles of 128).
struct GEpilogue {
  const int* labels;  // the chunk's first row's
  const float* lse;
  const float* gl;
  bf16* g;
  int64_t ld, lo;
  int M, ncols, c0;  // c0: the chunk's first vocabulary column
  static constexpr int S = kGemmT + 8;  // the staged tile's row stride
  static constexpr size_t smem = sizeof(bf16) * 2 * kGemmT * S;
  __device__ __forceinline__ void init(Acc& acc, int, int, int) const { zero(acc); }
  __device__ __forceinline__ void operator()(const Acc& acc, int m0, int n0, int wm, int wn,
                                             int lane, bf16* smem) const {
    const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + mi * 16 + g8 + 8 * i, row = m0 + r;
        const bool ok = row < M;
        const int lab = ok ? labels[row] - c0 : -1;  // -1 and other chunks' labels match nothing
        const float l = ok ? lse[row] : 0.f, s = ok ? gl[row] : 0.f;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int c = wn + ni * 8 + 2 * t4, col = n0 + c;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = ok && col + e < ncols
                       ? (expf(acc[mi][ni][2 * i + e] - l) - (col + e == lab ? 1.f : 0.f)) * s
                       : 0.f;
          const __nv_bfloat162 vh = __floats2bfloat162_rn(v[0], v[1]);
          *reinterpret_cast<__nv_bfloat162*>(smem + r * S + c) = vh;
          *reinterpret_cast<__nv_bfloat162*>(smem + (kGemmT + r) * S + c) = __floats2bfloat162_rn(
              __fsub_rn(v[0], __low2float(vh)), __fsub_rn(v[1], __high2float(vh)));
        }
      }
    __syncthreads();
    constexpr int PPR = kGemmT / 8;  // 16-byte pieces per row
    for (int p = threadIdx.x; p < 2 * kGemmT * PPR; p += kGemmThreads) {
      const int hr = p / PPR, half = hr / kGemmT, r = hr % kGemmT, c = p % PPR * 8;
      if (m0 + r < M)
        *reinterpret_cast<uint4*>(g + half * lo + (int64_t)(m0 + r) * ld + n0 + c) =
            *reinterpret_cast<const uint4*>(smem + hr * S + c);
    }
  }
};

// The products' epilogue: C starts from in, the f32 sum of the earlier
// chunks (0 on the first), the chunk's products fold into it, and it is
// written as f32 or bf16 on rows < M and columns < N.
struct StoreEpilogue {
  const float* in;
  int64_t ld_in;
  void* out;
  int64_t ld;
  int out_bf16, M, N;
  static constexpr size_t smem = 0;
  __device__ __forceinline__ void init(Acc& acc, int m, int n, int lane) const {
    zero(acc);
    if (!in) return;
    const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = m + mi * 16 + g8 + 8 * i;
        if (row >= M) continue;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int col = n + ni * 8 + 2 * t4;
          const float* p = in + (int64_t)row * ld_in + col;
          if (col < N) acc[mi][ni][2 * i] = p[0];
          if (col + 1 < N) acc[mi][ni][2 * i + 1] = p[1];
        }
      }
  }
  __device__ __forceinline__ void operator()(const Acc& acc, int m0, int n0, int wm, int wn,
                                             int lane, bf16*) const {
    const int g8 = lane >> 2, t4 = lane & 3, m = m0 + wm, n = n0 + wn;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = m + mi * 16 + g8 + 8 * i;
        if (row >= M) continue;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int col = n + ni * 8 + 2 * t4;
          if (col >= N) continue;
          const bool two = col + 1 < N;
          const float x0 = acc[mi][ni][2 * i], x1 = acc[mi][ni][2 * i + 1];
          const int64_t o = (int64_t)row * ld + col;
          if (out_bf16) {
            bf16* p = static_cast<bf16*>(out) + o;
            if (two)
              *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
            else
              *p = __float2bfloat16_rn(x0);
          } else {
            float* p = static_cast<float*>(out) + o;
            if (two)
              *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
            else
              *p = x0;
          }
        }
      }
  }
};

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
  const dim3 blocks(TOK_F ? (N + IT - 1) / IT : (V + IT - 1) / IT, (D + kSlab - 1) / kSlab);
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

template <bool A_KM, bool B_KM, bool SPLIT_A, bool SPLIT_B, class Epi>
cudaError_t gemm(Mat A, Mat B, int M, int N, int K, Epi epi, cudaStream_t s) {
  const size_t smem = std::max(Stage<A_KM, B_KM, SPLIT_A, SPLIT_B>::ring_bytes, Epi::smem);
  auto kernel = xent_gemm_kernel<A_KM, B_KM, SPLIT_A, SPLIT_B, Epi>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kGemmT - 1) / kGemmT, (M + kGemmT - 1) / kGemmT);
  kernel<<<grid, kGemmThreads, smem, s>>>(A, B, K, epi);
  return cudaGetLastError();
}

// The tensor-core backward's operands and chunk plan (see the C entries).
struct Bwd {
  const bf16 *h, *w;
  int64_t sh, sw;
  const int* labels;
  const float *lse, *gl;
  bf16* g;      // (2, min(N, rows), cols): hi, then lo
  float* acc;   // the f32 sum when the output is bf16 and takes several chunks
  void* out;
  int out_bf16, N, D, V, ncols, rows, cols;
  int64_t lo() const { return (int64_t)std::min(N, rows) * cols; }
};

// G of rows [r0, r0 + nr) and vocabulary columns [c0, c0 + width).
cudaError_t g_chunk(const Bwd& b, int r0, int nr, int c0, int width, cudaStream_t s) {
  const GEpilogue epi{b.labels + r0, b.lse + r0, b.gl + r0, b.g, b.cols, b.lo(), nr, width, c0};
  return gemm<true, false, false, false>({b.h + (int64_t)r0 * b.sh, b.sh, nr, b.D, 0},
                                         {b.w + c0, b.sw, b.D, width, 0}, nr, width, b.D, epi, s);
}

cudaError_t bwd_dh_mma(const Bwd& b, cudaStream_t s) {
  const size_t el = b.out_bf16 ? 2 : 4;
  for (int r0 = 0; r0 < b.N; r0 += b.rows) {
    const int nr = std::min(b.rows, b.N - r0);
    char* out = static_cast<char*>(b.out) + (int64_t)r0 * b.D * el;
    float* sum = b.out_bf16 ? b.acc : reinterpret_cast<float*>(out);
    for (int c0 = 0; c0 < b.ncols; c0 += b.cols) {
      const int width = std::min(b.cols, b.ncols - c0);
      const bool last = c0 + b.cols >= b.ncols;
      cudaError_t e = g_chunk(b, r0, nr, c0, width, s);
      if (e != cudaSuccess) return e;
      const StoreEpilogue epi{c0 ? sum : nullptr, b.D, last ? out : static_cast<void*>(sum),
                              b.D, last && b.out_bf16, nr, b.D};
      e = gemm<true, true, true, false>({b.g, b.cols, nr, width, b.lo()},
                                        {b.w + c0, b.sw, b.D, width, 0}, nr, b.D, width, epi, s);
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

cudaError_t bwd_dw_mma(const Bwd& b, cudaStream_t s) {
  const size_t el = b.out_bf16 ? 2 : 4;
  for (int c0 = 0; c0 < b.ncols; c0 += b.cols) {
    const int width = std::min(b.cols, b.ncols - c0);
    char* out = static_cast<char*>(b.out) + c0 * el;
    float* sum = b.out_bf16 ? b.acc : reinterpret_cast<float*>(out);
    const int64_t ld_sum = b.out_bf16 ? b.cols : b.V;
    for (int r0 = 0; r0 < b.N; r0 += b.rows) {
      const int nr = std::min(b.rows, b.N - r0);
      const bool last = r0 + b.rows >= b.N;
      cudaError_t e = g_chunk(b, r0, nr, c0, width, s);
      if (e != cudaSuccess) return e;
      const StoreEpilogue epi{r0 ? sum : nullptr, ld_sum, last ? out : static_cast<void*>(sum),
                              last ? b.V : ld_sum, last && b.out_bf16, b.D, width};
      e = gemm<false, false, false, true>({b.h + (int64_t)r0 * b.sh, b.sh, nr, b.D, 0},
                                          {b.g, b.cols, nr, width, b.lo()}, b.D, width, nr, epi,
                                          s);
      if (e != cudaSuccess) return e;
    }
  }
  if (b.ncols < b.V)  // no gradient for the padded vocabulary
    return cudaMemset2DAsync(static_cast<char*>(b.out) + b.ncols * el, b.V * el, 0,
                             (b.V - b.ncols) * el, b.D, s);
  return cudaSuccess;
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

// The tensor-core forward for bf16, on wgmma and TMA: h (N, D) and w (D,
// V) with rows contiguous and 16-byte aligned (row strides sh, sw in
// elements, multiples of 8; D a multiple of 16), part a (3, N, splits) f32
// workspace, each split taking tiles_per_split vocab tiles of 256 columns.
int xent_fwd_wgmma(const void* h, int64_t sh, const void* w, int64_t sw, const int* labels,
                   float* part, float* lse, float* ll, int N, int D, int ncols, int splits,
                   int tiles_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdEpilogue epi{labels, part, N, ncols};
  cudaError_t e = hopper::gemm_rows(h, sh, w, sw, N, ncols, D, splits, tiles_per_split, epi, s);
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

// The tensor-core dH (N, D) (dh = 1) or dW (D, V) (dh = 0), contiguous, in
// f32 or bf16 (out_bf16), for the layouts of xent_fwd_wgmma (D a multiple
// of 16). rows and cols are the chunk plan (cols a multiple of 128); g is a
// (2, min(N, rows), cols) bf16 workspace; acc an f32 workspace, (min(N,
// rows), D) for dH and (D, cols) for dW, needed only for a bf16 output
// summed over several chunks (more than one vocabulary chunk for dH, more
// than one token chunk for dW), else null.
int xent_bwd_chunks(int dh, const void* h, int64_t sh, const void* w, int64_t sw,
                    const int* labels, const float* lse, const float* gl, void* g, float* acc,
                    void* out, int out_bf16, int N, int D, int V, int ncols, int rows,
                    int cols, void* stream) {
  const Bwd b{static_cast<const bf16*>(h), static_cast<const bf16*>(w), sh, sw, labels, lse, gl,
              static_cast<bf16*>(g), acc, out, out_bf16, N, D, V, ncols, rows, cols};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dh ? bwd_dh_mma(b, s) : bwd_dw_mma(b, s));
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
