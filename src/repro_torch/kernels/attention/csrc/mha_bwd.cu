// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++: two
// kernels, dQ and (dK, dV).
//
// Replaces the TPU kernels of src/repro/kernels/attention/attention.py:
//   * `mha_bwd_dq` (`_dq_kernel`, line 321; `pallas_call` at line 372);
//   * `mha_bwd_dkv` (`_dkv_kernel`, line 401; `pallas_call` at line 468).
// They compute the same functions, from the forward's per-row log-sum-exp
// `lse` and delta = rowsum(f32(dO) * f32(O)), which the caller forms:
//   s  = scale * q k^T              (f32 sums of the inputs upcast)
//   p  = valid ? exp(s - lse) : 0   (a select: a fully masked row, whose
//                                    lse is about -1e30, gives exactly 0)
//   dp = dO v^T
//   ds = valid ? p * (dp - delta) * scale : 0
//   dQ = ds k,  dK = ds^T q,  dV = p^T dO
// with ds rounded to the dtype of q and k before the dQ and dK products and
// p rounded to dO's dtype before the dV product; every sum is f32. Native
// GQA: the kv head of query head h is h / G, never repeated, and dK, dV sum
// the G query heads of their kv head inside one block, so they come out in
// the (B, T, K, hd) storage layout with no atomics: both kernels are
// bitwise repeatable. The mask clauses are the forward's: rectangular
// causal with offset T - S, and the `kv_len` fill bound (a device int32
// scalar) with causal off. Segment ids come with packed batches.
//
// What bounds them on an H100: bytes. At the training shape (B=16,
// S=T=256, H=K=32, hd=64, causal, bf16) dQ reads q, k, v and dO (16.8 MB
// each) and lse and delta (0.5 MB each) and writes dQ: about 85 MB, 0.025 ms
// at 3.35 TB/s. dK, dV read the same and write two: about 102 MB,
// 0.030 ms. Their products over the 16.8 M valid (query, key) pairs are
// 6.4 and 8.6 GFLOP, 6.5 and 8.7 us at 989 TFLOP/s.
//
// The design is the forward's, the simple one: f32 FMAs on tiles staged in
// shared memory as f32 (no mma.sync, wgmma or TMA), so, like the forward,
// the kernels are bound by their shared-memory reads and not by HBM.
//   * dQ: one block per (32-row q tile, query head, batch). The rows' q and
//     dO are staged once; the block walks the kv tiles of 64 keys up to the
//     last one any of its rows can see (causal diagonal, kv_len bound), the
//     loop taking the place of the TPU's sequential kv grid axis. A row is
//     owned by 8 lanes of one warp: lane t forms s and dp for keys t, t+8,
//     ..., writes ds to shared memory, and accumulates dQ dims t, t+8, ...
//     in registers; dQ is written once.
//   * dK, dV: one block per (32-key tile, kv head, batch); the block's k and
//     v rows are staged once, and dK and dV stay in registers while the
//     block loops over the G query heads of its kv head and, within each,
//     over the 64-row q tiles from the first that can see its keys (the
//     causal diagonal) on. Rows past S and keys past T are zero on both
//     operand sides and masked, so their lse and delta never enter a sum.
#include "attn_common.cuh"

namespace {

constexpr int kBK = 64;  // keys per kv tile of the dQ kernel
constexpr int kBQ = 64;  // query rows per q tile of the dK, dV kernel
constexpr int kRows = 32, kTPR = 8;  // a block's own rows, lanes per row

// Element strides (batch, token, head) of q, k, v and dO; last dim contiguous.
struct Strides {
  int64_t qb, qs, qh, kb, kt, kh, vb, vt, vh, ob, os, oh;
};

// One block: BQ query rows of one (batch, head); TPR lanes per row. DMAX
// bounds hd and hdv (the accumulator count per lane is DMAX / TPR).
template <typename T, int BQ, int TPR, int DMAX>
__global__ void __launch_bounds__(BQ * TPR)
mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, const int* __restrict__ kv_len,
                  T* __restrict__ dq, int S, int T_len, int H, int G, int hd, int hdv,
                  Strides st, float scale, int causal) {
  constexpr int NT = BQ * TPR;
  constexpr int NCOL = kBK / TPR;   // keys per lane
  constexpr int NACC = DMAX / TPR;  // dQ dims per lane
  static_assert(32 % TPR == 0, "a row's lanes must share a warp");

  extern __shared__ float smem[];
  const int lq = hd + 1, lo = hdv + 1, ls = kBK + 1;  // odd strides: no bank conflicts
  float* Qs = smem;            // (BQ, hd)
  float* Os = Qs + BQ * lq;    // (BQ, hdv): dO
  float* Ks = Os + BQ * lo;    // (kBK, hd)
  float* Vs = Ks + kBK * lq;   // (kBK, hdv)
  float* Ds = Vs + kBK * lo;   // (BQ, kBK): ds in k's dtype

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int r = threadIdx.x / TPR, t = threadIdx.x % TPR;
  const int row = q0 + r;
  const int offset = T_len - S;

  stage<T, NT>(Qs, lq, q + b * st.qb + h * st.qh + (int64_t)q0 * st.qs, st.qs, BQ, hd, S - q0);
  stage<T, NT>(Os, lo, dout + b * st.ob + h * st.oh + (int64_t)q0 * st.os, st.os, BQ, hdv,
               S - q0);
  const T* kb = k + b * st.kb + kvh * st.kh;
  const T* vb = v + b * st.vb + kvh * st.vh;
  const int64_t stat = ((int64_t)b * H + h) * S + row;
  const float lse_r = row < S ? lse[stat] : 0.f;
  const float d_r = row < S ? delta[stat] : 0.f;

  // Keys at or past `kend` are masked for every row of this block.
  const int kl = kv_len ? *kv_len : T_len;
  int kend = min(T_len, max(kl, 0));
  if (causal) kend = min(kend, offset + min(q0 + BQ, S));
  const int n_tiles = (kend + kBK - 1) / kBK;

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile is consumed (and q, dO staged)
    stage<T, NT>(Ks, lq, kb + (int64_t)k0 * st.kt, st.kt, kBK, hd, T_len - k0);
    stage<T, NT>(Vs, lo, vb + (int64_t)k0 * st.vt, st.vt, kBK, hdv, T_len - k0);
    __syncthreads();

    float s[NCOL], dp[NCOL];
#pragma unroll
    for (int c = 0; c < NCOL; ++c) s[c] = dp[c] = 0.f;
    const float* qrow = Qs + r * lq;
    for (int d = 0; d < hd; ++d) {
      const float x = qrow[d];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) s[c] = fmaf(x, Ks[(t + c * TPR) * lq + d], s[c]);
    }
    const float* orow = Os + r * lo;
    for (int d = 0; d < hdv; ++d) {
      const float x = orow[d];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) dp[c] = fmaf(x, Vs[(t + c * TPR) * lo + d], dp[c]);
    }
    float* drow = Ds + r * ls;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int col = k0 + t + c * TPR;
      const bool valid =
          row < S && col < T_len && col < kl && (!causal || offset + row >= col);
      const float p = valid ? expf(s[c] * scale - lse_r) : 0.f;
      const float ds = valid ? p * (dp[c] - d_r) * scale : 0.f;
      drow[t + c * TPR] = to_f32(from_f32<T>(ds));  // ds in k's dtype for ds.k
    }
    __syncwarp();  // a row's ds values are written by lanes of its own warp

    // Keys at or past kend have ds == 0: stop there.
    const int cend = min(kBK, kend - k0);
    for (int c = 0; c < cend; ++c) {
      const float x = drow[c];
      const float* krow = Ks + c * lq;
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int d = t + i * TPR;
        if (d < hd) acc[i] = fmaf(x, krow[d], acc[i]);
      }
    }
  }

  if (row < S) {
    T* out = dq + (((int64_t)b * S + row) * H + h) * hd;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int d = t + i * TPR;
      if (d < hd) out[d] = from_f32<T>(acc[i]);
    }
  }
}

// One block: BK keys of one (batch, kv head); TPR lanes per key. DMAX bounds
// hd and hdv.
template <typename T, int BK, int TPR, int DMAX>
__global__ void __launch_bounds__(BK * TPR)
mha_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, const int* __restrict__ kv_len,
                   T* __restrict__ dk, T* __restrict__ dv, int S, int T_len, int H, int G,
                   int hd, int hdv, Strides st, float scale, int causal) {
  constexpr int NT = BK * TPR;
  constexpr int NCOL = kBQ / TPR;   // query rows per lane
  constexpr int NACC = DMAX / TPR;  // dK (and dV) dims per lane
  static_assert(32 % TPR == 0, "a key's lanes must share a warp");

  extern __shared__ float smem[];
  const int lk = hd + 1, lv = hdv + 1, lp = kBQ + 1;  // odd strides: no bank conflicts
  float* Ks = smem;            // (BK, hd)
  float* Vs = Ks + BK * lk;    // (BK, hdv)
  float* Qs = Vs + BK * lv;    // (kBQ, hd)
  float* Os = Qs + kBQ * lk;   // (kBQ, hdv): dO
  float* Ps = Os + kBQ * lv;   // (BK, kBQ): p in dO's dtype
  float* Ss = Ps + BK * lp;    // (BK, kBQ): ds in q's dtype
  float* Ls = Ss + BK * lp;    // (kBQ): lse
  float* Dl = Ls + kBQ;        // (kBQ): delta

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int K = gridDim.y;
  const int r = threadIdx.x / TPR, t = threadIdx.x % TPR;
  const int col = k0 + r;  // this lane's key
  const int offset = T_len - S;

  stage<T, NT>(Ks, lk, k + b * st.kb + kvh * st.kh + (int64_t)k0 * st.kt, st.kt, BK, hd,
               T_len - k0);
  stage<T, NT>(Vs, lv, v + b * st.vb + kvh * st.vh + (int64_t)k0 * st.vt, st.vt, BK, hdv,
               T_len - k0);

  // Keys at or past `kend` are masked for every query row. A block with no
  // valid key does no work; otherwise its first q tile is the one holding
  // the first row that sees key k0 (causal: offset + i >= k0).
  const int kl = kv_len ? *kv_len : T_len;
  const int kend = min(T_len, max(kl, 0));
  const int i_end = k0 < kend ? S : 0;
  const int i_start = causal ? (max(0, k0 - offset) / kBQ) * kBQ : 0;

  float acc_k[NACC], acc_v[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qh = q + b * st.qb + h * st.qh;
    const T* oh = dout + b * st.ob + h * st.oh;
    const float* lh = lse + ((int64_t)b * H + h) * S;
    const float* dh = delta + ((int64_t)b * H + h) * S;
    for (int i0 = i_start; i0 < i_end; i0 += kBQ) {
      __syncthreads();  // the previous tile is consumed (and k, v staged)
      stage<T, NT>(Qs, lk, qh + (int64_t)i0 * st.qs, st.qs, kBQ, hd, S - i0);
      stage<T, NT>(Os, lv, oh + (int64_t)i0 * st.os, st.os, kBQ, hdv, S - i0);
      for (int x = threadIdx.x; x < kBQ; x += NT) {
        const bool in = i0 + x < S;  // rows past S: never read, kept finite
        Ls[x] = in ? lh[i0 + x] : 0.f;
        Dl[x] = in ? dh[i0 + x] : 0.f;
      }
      __syncthreads();

      float s[NCOL], dp[NCOL];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) s[c] = dp[c] = 0.f;
      const float* krow = Ks + r * lk;
      for (int d = 0; d < hd; ++d) {
        const float x = krow[d];
#pragma unroll
        for (int c = 0; c < NCOL; ++c) s[c] = fmaf(Qs[(t + c * TPR) * lk + d], x, s[c]);
      }
      const float* vrow = Vs + r * lv;
      for (int d = 0; d < hdv; ++d) {
        const float x = vrow[d];
#pragma unroll
        for (int c = 0; c < NCOL; ++c) dp[c] = fmaf(Os[(t + c * TPR) * lv + d], x, dp[c]);
      }
      float* prow = Ps + r * lp;
      float* srow = Ss + r * lp;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const int qc = t + c * TPR, qi = i0 + qc;
        const bool valid = qi < S && col < kend && (!causal || offset + qi >= col);
        const float p = valid ? expf(s[c] * scale - Ls[qc]) : 0.f;
        const float ds = valid ? p * (dp[c] - Dl[qc]) * scale : 0.f;
        prow[qc] = to_f32(from_f32<T>(p));   // p in dO's dtype for p^T dO
        srow[qc] = to_f32(from_f32<T>(ds));  // ds in q's dtype for ds^T q
      }
      __syncwarp();  // a key's p and ds are written by lanes of its own warp

      // Rows past S have p == ds == 0: stop there.
      const int cend = min(kBQ, S - i0);
      for (int c = 0; c < cend; ++c) {
        const float pv = prow[c], sv = srow[c];
        const float* qr = Qs + c * lk;
        const float* orow = Os + c * lv;
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
          const int d = t + i * TPR;
          if (d < hd) acc_k[i] = fmaf(sv, qr[d], acc_k[i]);
          if (d < hdv) acc_v[i] = fmaf(pv, orow[d], acc_v[i]);
        }
      }
    }
  }

  if (col < T_len) {
    T* ko = dk + (((int64_t)b * T_len + col) * K + kvh) * hd;
    T* vo = dv + (((int64_t)b * T_len + col) * K + kvh) * hdv;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int d = t + i * TPR;
      if (d < hd) ko[d] = from_f32<T>(acc_k[i]);
      if (d < hdv) vo[d] = from_f32<T>(acc_v[i]);
    }
  }
}

// Shared memory of either kernel: its own 32 rows and a streamed tile of 64
// rows, each at the q|k and dO|v widths, and the (32, 64) ds tile (dK, dV:
// the p and ds tiles, and the q tile's lse and delta).
size_t smem_bytes(int hd, int hdv, bool dkv) {
  const size_t rows = (size_t)(kRows + 64) * (hd + 1 + hdv + 1);
  const size_t tiles = (size_t)kRows * 65 * (dkv ? 2 : 1) + (dkv ? 2 * kBQ : 0);
  return sizeof(float) * (rows + tiles);
}

template <typename T, int DMAX>
cudaError_t launch(bool dkv, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const int* kv_len, void* o1, void* o2,
                   int B, int S, int T_len, int H, int K, int hd, int hdv, const Strides& st,
                   float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, hdv, dkv);
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(dout);
  // Above 48 KB a launch is refused unless the kernel opts in; the wrapper
  // bounds hd and hdv so that the largest case fits the H100's 227 KB.
  if (dkv) {
    auto kern = mha_bwd_dkv_kernel<T, kRows, kTPR, DMAX>;
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    dim3 grid((T_len + kRows - 1) / kRows, K, B);
    kern<<<grid, kRows * kTPR, smem, stream>>>(q_, k_, v_, o_, lse, delta, kv_len,
                                               static_cast<T*>(o1), static_cast<T*>(o2), S,
                                               T_len, H, H / K, hd, hdv, st, scale, causal);
  } else {
    auto kern = mha_bwd_dq_kernel<T, kRows, kTPR, DMAX>;
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    dim3 grid((S + kRows - 1) / kRows, H, B);
    kern<<<grid, kRows * kTPR, smem, stream>>>(q_, k_, v_, o_, lse, delta, kv_len,
                                               static_cast<T*>(o1), S, T_len, H, H / K, hd,
                                               hdv, st, scale, causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(bool dkv, const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, const int* kv_len, void* o1,
                     void* o2, int B, int S, int T_len, int H, int K, int hd, int hdv,
                     const Strides& st, float scale, int causal, cudaStream_t stream) {
  if (hd <= 64 && hdv <= 64)
    return launch<T, 64>(dkv, q, k, v, dout, lse, delta, kv_len, o1, o2, B, S, T_len, H, K,
                         hd, hdv, st, scale, causal, stream);
  return launch<T, 128>(dkv, q, k, v, dout, lse, delta, kv_len, o1, o2, B, S, T_len, H, K,
                        hd, hdv, st, scale, causal, stream);
}

int run(bool dkv, const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, const int* kv_len, void* o1, void* o2,
        int is_bf16, int B, int S, int T_len, int H, int K, int hd, int hdv,
        const int64_t* strides, float scale, int causal, void* stream) {
  const Strides st = {strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
                      strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      is_bf16 ? launch_d<__nv_bfloat16>(dkv, q, k, v, dout, lse, delta, kv_len, o1, o2, B, S,
                                        T_len, H, K, hd, hdv, st, scale, causal, s)
              : launch_d<float>(dkv, q, k, v, dout, lse, delta, kv_len, o1, o2, B, S, T_len,
                                H, K, hd, hdv, st, scale, causal, s);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// q (B,S,H,hd), k (B,T,K,hd), v (B,T,K,hdv) and dout (B,S,H,hdv) through
// element strides {q: b,s,h; k: b,t,h; v: b,t,h; dout: b,s,h}, last dim
// contiguous, all in one dtype; lse and delta (B,H,S) f32 contiguous.
// kv_len: device int32 scalar or NULL (= T). Outputs contiguous in the
// inputs' dtype: dq (B,S,H,hd); dk (B,T,K,hd) and dv (B,T,K,hdv). Each
// returns the launch's cudaError_t.
int mha_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* kv_len, void* dq, int is_bf16, int B, int S,
               int T_len, int H, int K, int hd, int hdv, const int64_t* strides, float scale,
               int causal, void* stream) {
  return run(false, q, k, v, dout, lse, delta, kv_len, dq, nullptr, is_bf16, B, S, T_len, H,
             K, hd, hdv, strides, scale, causal, stream);
}

int mha_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, const int* kv_len, void* dk, void* dv,
                int is_bf16, int B, int S, int T_len, int H, int K, int hd, int hdv,
                const int64_t* strides, float scale, int causal, void* stream) {
  return run(true, q, k, v, dout, lse, delta, kv_len, dk, dv, is_bf16, B, S, T_len, H, K, hd,
             hdv, strides, scale, causal, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
