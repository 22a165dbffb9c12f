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
// Two routes, chosen by the wrapper (attention.py, `_bwd_route`) by dtype
// and shape alone; the C entries `mha_bwd_dq_mma` and `mha_bwd_dkv_mma`
// take the first, `mha_bwd_dq` and `mha_bwd_dkv` the second. Neither is a
// fallback of the other.
//
//   * mma (bf16, hd == hdv in {64, 128}: training) -- FlashAttention-2's
//     backward on mma.sync m16n8k16 (bf16 products, exact in f32; f32
//     sums), as the forward's mma route (mha_fwd.cu). Blocks of 4 warps;
//     tiles of 64 rows are copied into shared memory as bf16 by 16-byte
//     cp.async straight through the model's strides, rows padded by 8
//     elements so that the 8 rows an ldmatrix reads fall in distinct
//     banks, and the streamed tiles are double-buffered: the next tile's
//     copy is in flight while the current one is multiplied. Rows past S
//     and keys past the block's last visible key are zero-filled through
//     the copy's source size, so a stale value cannot reach a product
//     through 0 x NaN. Each warp owns 16 rows of the block's own tile and
//     walks the streamed tile in chunks of 16, one k-step of the gradient
//     products: the chunk's scores and dp (two n8 tiles each) come from
//     the tensor cores, p and ds are formed on the C fragments (masks only
//     on diagonal and edge tiles; chunks a warp cannot see are skipped),
//     and two C fragments packed to bf16 -- the rounding of ds to k's
//     dtype, of p to dO's -- are the A fragment of the next product, whose
//     B fragments come from the streamed tile by ldmatrix.trans. Nothing
//     but the copies goes through shared memory until the epilogue, which
//     stages each warp's rows in its own rows of the block's tile for
//     16-byte stores.
//     - dQ: one block per (64-row q tile, query head, batch), the q-tile
//       index reversed so that the longest causal blocks start first. The
//       Q and dO tiles are copied once; K and V tiles of 64 keys stream up
//       to the last key any row of the block sees. S = Q K^T, dP = dO V^T,
//       dQ += dS K; lse and delta of a lane's two rows sit in registers.
//     - dK, dV: one block per (64-key tile, kv head, batch). The K and V
//       tiles are copied once; the block walks the G query heads of its kv
//       head and, within each, the 64-row q tiles from the first that sees
//       its keys, streaming Q, dO and the tile's 64 lse and delta values.
//       S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q. The GQA sum
//       stays in the block's registers: no atomics, bitwise repeatable,
//       and dK, dV leave in the (B, T, K, hd) layout.
//     The A fragments of the block's own tile are held in registers at hd
//     64 (dQ: Q's; dK, dV: K's and V's) and read from shared memory at
//     each k-step otherwise. dQ re-reads dO's at hd 64 too: holding both
//     Q's and dO's takes ptxas past the 128 registers that keep four blocks
//     on an SM, and it spills. At hd 128 dK and dV's held K and V and their
//     two (16, 128) f32 accumulators would not fit 255 registers.
//     Tensor-core sums: each product's 16 terms are summed inside the mma.
//     A score's 4 or 8 k-steps chain through the mma's f32 accumulator,
//     whose additions truncate rather than round. The gradient sums are
//     longer chains: T/16 k-steps for dQ and G*S/16 for dK and dV (224 for
//     qwen2's 7-head groups over 512 rows). Their worst cases came within
//     half of the bf16 tolerance, so each of their k-steps is formed in a
//     fresh fragment and folded in with an IEEE add (`mma_bf16_fold`):
//     dQ's and dK's always, dV's at hd 64. At hd 128 dV chains, since
//     folding both of dK and dV takes ptxas past 255 registers into
//     spills. The errors the fold saves and its cost are in PERF.md.
//   * fma (f32; bf16 with hd != hdv or hd not in {64, 128}) -- the simple
//     design: f32 FMAs on tiles staged in shared memory as f32 (no
//     mma.sync, wgmma or TMA), bound by its shared-memory reads and not
//     by HBM.
//     - dQ: one block per (32-row q tile, query head, batch). The rows' q
//       and dO are staged once; the block walks the kv tiles of 64 keys up
//       to the last one any of its rows can see (causal diagonal, kv_len
//       bound), the loop taking the place of the TPU's sequential kv grid
//       axis. A row is owned by 8 lanes of one warp: lane t forms s and dp
//       for keys t, t+8, ..., writes ds to shared memory, and accumulates
//       dQ dims t, t+8, ... in registers; dQ is written once.
//     - dK, dV: one block per (32-key tile, kv head, batch); the block's k
//       and v rows are staged once, and dK and dV stay in registers while
//       the block loops over the G query heads of its kv head and, within
//       each, over the 64-row q tiles from the first that can see its keys
//       (the causal diagonal) on. Rows past S and keys past T are zero on
//       both operand sides and masked, so their lse and delta never enter
//       a sum.
//     Each kernel is built for heads of up to 64, 128 and 256 (DMAX; a
//     lane holds DMAX / 8 accumulators of each gradient). Head dim 256 is
//     gemma-2b's (8 query heads over 1 kv head): its staged f32 tiles take
//     201 KB of shared memory for dQ and 209.5 KB for dK, dV, so one block
//     runs on an SM, and a lane holds 32 dQ sums, or 32 dK and 32 dV sums.
//     That is the widest head whose tiles fit the H100's 227 KB. A
//     tensor-core backward at 256 would need two (16, 256) f32 gradient
//     fragments a warp, more than the registers hold (ROADMAP Queue 2).
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
  if (hd <= 128 && hdv <= 128)
    return launch<T, 128>(dkv, q, k, v, dout, lse, delta, kv_len, o1, o2, B, S, T_len, H, K,
                          hd, hdv, st, scale, causal, stream);
  return launch<T, 256>(dkv, q, k, v, dout, lse, delta, kv_len, o1, o2, B, S, T_len, H, K,
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


// ---------------------------------------------------------------------------
// The mma route (design in the note at the top). HD == hd == hdv; bf16.

// c += a b, folded in by an IEEE add (mma_bf16_fold) or chained through
// the mma's accumulator.
template <bool FOLD>
__device__ __forceinline__ void mma_acc(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  if constexpr (FOLD)
    mma_bf16_fold(c, a, b0, b1);
  else
    mma_bf16(c, a, b0, b1);
}
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
mha_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ kv_len, bf16* __restrict__ dq, int S, int T_len,
                      int H, int G, Strides st, float scale, int causal) {
  constexpr int LD = HD + 8, TILE = kMmaTile * LD;
  constexpr int NO = HD / 8;       // n8 tiles of dQ per warp
  constexpr int KQ = HD / 16;      // k16 steps of a score
  constexpr bool HOLD = HD == 64;  // Q fragments held in registers

  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(mma_smem);  // (64, LD)
  bf16* Os = Qs + TILE;                          // (64, LD): dO
  bf16* Ks = Os + TILE;                          // 2 x (64, LD)
  bf16* Vs = Ks + 2 * TILE;                      // 2 x (64, LD)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaTile;  // most causal work first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int offset = T_len - S;
  const int w0 = q0 + warp * 16;  // this warp's first row
  const int row0 = w0 + g;        // this lane's rows: row0 and row0 + 8

  // Keys at or past klim are masked for every row; at or past kend for
  // every row of this block, at or past wend for every row of this warp.
  const int kl = kv_len ? *kv_len : T_len;
  const int klim = min(T_len, max(kl, 0));
  int kend = klim, wend = w0 < S ? klim : 0;
  if (causal) {
    kend = min(kend, offset + min(q0 + kMmaTile, S));
    wend = min(wend, offset + min(w0 + 16, S));
  }
  const int n_tiles = (kend + kMmaTile - 1) / kMmaTile;

  const bf16* kb = k + b * st.kb + kvh * st.kh;
  const bf16* vb = v + b * st.vb + kvh * st.vh;
  copy_tile_pair<HD>(Qs, q + b * st.qb + h * st.qh, st.qs, Os, dout + b * st.ob + h * st.oh,
                     st.os, q0, S);
  auto load_kv = [&](int j, int buf) {
    copy_tile_pair<HD>(Ks + buf * TILE, kb, st.kt, Vs + buf * TILE, vb, st.vt, j * kMmaTile,
                       kend);
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();  // group 0: the Q and dO tiles and kv tile 0

  float lr[2], dr[2];  // lse and delta of this lane's rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const int64_t x = ((int64_t)b * H + h) * S + row;
    lr[i] = row < S ? lse[x] : 0.f;
    dr[i] = row < S ? delta[x] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  unsigned qf[HOLD ? KQ : 1][4], of[4];

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1, k0 = j * kMmaTile;
    if (j + 1 < n_tiles) {
      load_kv(j + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and at j = 0 the Q and dO tiles) is in shared memory
    if (HOLD && j == 0) {
#pragma unroll
      for (int ks = 0; ks < KQ; ++ks) frag_a<LD>(qf[ks], Qs, warp, ks, lane);
    }
    const bf16* Kt = Ks + buf * TILE;
    const bf16* Vt = Vs + buf * TILE;
    // Only the diagonal and kv_len edge tiles mask element by element.
    const bool edge = k0 + kMmaTile > klim || (causal && k0 + kMmaTile - 1 > offset + w0);
#pragma unroll
    for (int c = 0; c < kMmaTile / 16; ++c) {
      const int kc = k0 + c * 16;
      if (kc >= wend) break;  // no row of this warp sees these keys
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KQ; ++ks) {
        if constexpr (!HOLD) frag_a<LD>(qf[0], Qs, warp, ks, lane);
        frag_a<LD>(of, Os, warp, ks, lane);
        const int ka = HOLD ? ks : 0;
        unsigned f[4];
        frag_bt<LD>(f, Kt, c * 16, ks, lane);
        mma_bf16(s[0], qf[ka], f[0], f[1]);
        mma_bf16(s[1], qf[ka], f[2], f[3]);
        frag_bt<LD>(f, Vt, c * 16, ks, lane);
        mma_bf16(dp[0], of, f[0], f[1]);
        mma_bf16(dp[1], of, f[2], f[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kc + n * 8 + 2 * t4 + (e & 1), i = e >> 1;
          const bool valid =
              !edge || (col < klim && (!causal || offset + row0 + 8 * i >= col));
          const float p = valid ? expf(s[n][e] * scale - lr[i]) : 0.f;
          s[n][e] = valid ? p * (dp[n][e] - dr[i]) * scale : 0.f;  // ds
        }
      unsigned da[4];  // ds in k's dtype: the A fragment of dS K
      pack_a(da, s);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        unsigned f[4];
        frag_b<LD>(f, Kt, c * 16, np * 16, lane);
        mma_bf16_fold(acc[2 * np], da, f[0], f[1]);
        mma_bf16_fold(acc[2 * np + 1], da, f[2], f[3]);
      }
    }
    __syncthreads();  // buffer buf is free for the copy of tile j + 2
  }

  cp_async_wait<0>();  // with no tile, the Q and dO copies may still be in flight
  __syncthreads();
  store_rows<HD>(Qs + warp * 16 * LD, acc, dq + (((int64_t)b * S + w0) * H + h) * HD,
                 (int64_t)H * HD, S - w0, lane);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
mha_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ kv_len, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int S, int T_len, int H, int G, Strides st,
                       float scale, int causal) {
  constexpr int LD = HD + 8, TILE = kMmaTile * LD;
  constexpr int NO = HD / 8;       // n8 tiles of dK (and dV) per warp
  constexpr int KQ = HD / 16;      // k16 steps of a score
  constexpr bool HOLD = HD == 64;  // K and V fragments held in registers
  constexpr bool FOLD_DV = HD == 64;  // folding dV too at hd 128 spills

  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(mma_smem);  // (64, LD)
  bf16* Vs = Ks + TILE;                          // (64, LD)
  bf16* Qs = Vs + TILE;                          // 2 x (64, LD)
  bf16* Os = Qs + 2 * TILE;                      // 2 x (64, LD): dO
  float* Ls = reinterpret_cast<float*>(Os + 2 * TILE);  // 2 x 64: lse
  float* Dl = Ls + 2 * kMmaTile;                        // 2 x 64: delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * kMmaTile, kvh = blockIdx.y, b = blockIdx.z;
  const int K = gridDim.y;
  const int offset = T_len - S;
  const int w0 = k0 + warp * 16;  // this warp's first key
  const int key0 = w0 + g;        // this lane's keys: key0 and key0 + 8

  // Keys at or past `kend` are masked for every query row. A block with no
  // visible key does no work; otherwise its q tiles run from the one
  // holding the first row that sees key k0 (causal: offset + i >= k0).
  const int kl = kv_len ? *kv_len : T_len;
  const int kend = min(T_len, max(kl, 0));
  const int i_start = causal ? (max(0, k0 - offset) / kMmaTile) * kMmaTile : 0;
  const int nq = k0 < kend ? (S - i_start + kMmaTile - 1) / kMmaTile : 0;
  const int n_iter = G * nq;  // (query head, q tile) pairs, head-major

  copy_tile_pair<HD>(Ks, k + b * st.kb + kvh * st.kh, st.kt, Vs, v + b * st.vb + kvh * st.vh,
                     st.vt, k0, kend);
  auto load_q = [&](int it, int buf) {
    const int h = kvh * G + it / nq, i0 = i_start + (it % nq) * kMmaTile;
    copy_tile_pair<HD>(Qs + buf * TILE, q + b * st.qb + h * st.qh, st.qs, Os + buf * TILE,
                       dout + b * st.ob + h * st.oh, st.os, i0, S);
    const int64_t x = ((int64_t)b * H + h) * S;
    for (int e = threadIdx.x; e < 2 * kMmaTile; e += kMmaThreads) {
      const int r = e % kMmaTile;
      const bool ok = i0 + r < S;  // rows past S: zeros, never read unmasked
      const float* src = (e < kMmaTile ? lse : delta) + x;
      cp_async4((e < kMmaTile ? Ls : Dl) + buf * kMmaTile + r, ok ? src + i0 + r : src,
                ok ? 4 : 0);
    }
  };
  if (n_iter > 0) load_q(0, 0);
  cp_async_commit();  // group 0: the K and V tiles and the first q tile

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  unsigned kf[HOLD ? KQ : 1][4], vf[HOLD ? KQ : 1][4];

  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1, i0 = i_start + (it % nq) * kMmaTile;
    if (it + 1 < n_iter) {
      load_q(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // q tile it (and at it = 0 the K and V tiles) is in shared memory
    if (HOLD && it == 0) {
#pragma unroll
      for (int ks = 0; ks < KQ; ++ks) {
        frag_a<LD>(kf[ks], Ks, warp, ks, lane);
        frag_a<LD>(vf[ks], Vs, warp, ks, lane);
      }
    }
    const bf16* Qt = Qs + buf * TILE;
    const bf16* Ot = Os + buf * TILE;
    const float* Lt = Ls + buf * kMmaTile;
    const float* Dt = Dl + buf * kMmaTile;
    // Only the diagonal, ragged-row and kv_len edge tiles mask element by
    // element.
    const bool edge =
        i0 + kMmaTile > S || w0 + 16 > kend || (causal && offset + i0 < w0 + 15);
#pragma unroll
    for (int c = 0; c < kMmaTile / 16; ++c) {
      const int r0 = i0 + c * 16;
      // no key of this warp is visible, or to no row of this chunk
      if (w0 >= kend || r0 >= S || (causal && offset + r0 + 15 < w0)) continue;
      float s[2][4] = {}, dp[2][4] = {};  // S^T and dP^T: keys x rows
#pragma unroll
      for (int ks = 0; ks < KQ; ++ks) {
        if constexpr (!HOLD) {
          frag_a<LD>(kf[0], Ks, warp, ks, lane);
          frag_a<LD>(vf[0], Vs, warp, ks, lane);
        }
        const int ka = HOLD ? ks : 0;
        unsigned f[4];
        frag_bt<LD>(f, Qt, c * 16, ks, lane);
        mma_bf16(s[0], kf[ka], f[0], f[1]);
        mma_bf16(s[1], kf[ka], f[2], f[3]);
        frag_bt<LD>(f, Ot, c * 16, ks, lane);
        mma_bf16(dp[0], vf[ka], f[0], f[1]);
        mma_bf16(dp[1], vf[ka], f[2], f[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c * 16 + n * 8 + 2 * t4 + (e & 1), qi = i0 + qc;
          const int key = key0 + 8 * (e >> 1);
          const bool valid =
              !edge || (qi < S && key < kend && (!causal || offset + qi >= key));
          const float p = valid ? expf(s[n][e] * scale - Lt[qc]) : 0.f;
          dp[n][e] = valid ? p * (dp[n][e] - Dt[qc]) * scale : 0.f;  // ds
          s[n][e] = p;
        }
      unsigned pa[4], da[4];  // p in dO's dtype, ds in q's: A fragments
      pack_a(pa, s);
      pack_a(da, dp);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        unsigned f[4];
        frag_b<LD>(f, Ot, c * 16, np * 16, lane);
        mma_acc<FOLD_DV>(dva[2 * np], pa, f[0], f[1]);
        mma_acc<FOLD_DV>(dva[2 * np + 1], pa, f[2], f[3]);
        frag_b<LD>(f, Qt, c * 16, np * 16, lane);
        mma_bf16_fold(dka[2 * np], da, f[0], f[1]);
        mma_bf16_fold(dka[2 * np + 1], da, f[2], f[3]);
      }
    }
    __syncthreads();  // buffer buf is free for the copy of q tile it + 2
  }

  cp_async_wait<0>();  // with no q tile, the K and V copies may still be in flight
  __syncthreads();
  const int64_t o = (((int64_t)b * T_len + w0) * K + kvh) * HD;
  store_rows<HD>(Ks + warp * 16 * LD, dka, dk + o, (int64_t)K * HD, T_len - w0, lane);
  store_rows<HD>(Vs + warp * 16 * LD, dva, dv + o, (int64_t)K * HD, T_len - w0, lane);
}

template <int HD>
cudaError_t launch_mma(bool dkv, const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, const int* kv_len, void* o1,
                       void* o2, int B, int S, int T_len, int H, int K, const Strides& st,
                       float scale, int causal, cudaStream_t stream) {
  // six (64, HD + 8) bf16 tiles (dQ: Q, dO and two K and two V; dK, dV: K,
  // V and two Q and two dO), and for dK, dV two tiles' lse and delta: 54 KB
  // at hd 64, 102 KB at hd 128
  constexpr size_t tiles = sizeof(bf16) * 6 * kMmaTile * (HD + 8);
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* o_ = static_cast<const bf16*>(dout);
  if (dkv) {
    constexpr size_t smem = tiles + sizeof(float) * 4 * kMmaTile;
    auto kern = mha_bwd_dkv_mma_kernel<HD>;
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    dim3 grid((T_len + kMmaTile - 1) / kMmaTile, K, B);
    kern<<<grid, kMmaThreads, smem, stream>>>(q_, k_, v_, o_, lse, delta, kv_len,
                                              static_cast<bf16*>(o1), static_cast<bf16*>(o2),
                                              S, T_len, H, H / K, st, scale, causal);
  } else {
    auto kern = mha_bwd_dq_mma_kernel<HD>;
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tiles);
    if (e != cudaSuccess) return e;
    dim3 grid((S + kMmaTile - 1) / kMmaTile, H, B);
    kern<<<grid, kMmaThreads, tiles, stream>>>(q_, k_, v_, o_, lse, delta, kv_len,
                                               static_cast<bf16*>(o1), S, T_len, H, H / K, st,
                                               scale, causal);
  }
  return cudaGetLastError();
}

int run_mma(bool dkv, const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, const int* kv_len, void* o1, void* o2,
            int is_bf16, int B, int S, int T_len, int H, int K, int hd, int hdv,
            const int64_t* strides, float scale, int causal, void* stream) {
  const Strides st = {strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
                      strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16 || hd != hdv) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaErrorInvalidValue;
  if (hd == 64)
    e = launch_mma<64>(dkv, q, k, v, dout, lse, delta, kv_len, o1, o2, B, S, T_len, H, K, st,
                       scale, causal, s);
  else if (hd == 128)
    e = launch_mma<128>(dkv, q, k, v, dout, lse, delta, kv_len, o1, o2, B, S, T_len, H, K, st,
                        scale, causal, s);
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

// The mma route: the arguments of mha_bwd_dq and mha_bwd_dkv, for bf16 with
// hd == hdv in {64, 128} only (anything else is cudaErrorInvalidValue).
int mha_bwd_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const int* kv_len, void* dq,
                   int is_bf16, int B, int S, int T_len, int H, int K, int hd, int hdv,
                   const int64_t* strides, float scale, int causal, void* stream) {
  return run_mma(false, q, k, v, dout, lse, delta, kv_len, dq, nullptr, is_bf16, B, S, T_len,
                 H, K, hd, hdv, strides, scale, causal, stream);
}

int mha_bwd_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, const int* kv_len, void* dk,
                    void* dv, int is_bf16, int B, int S, int T_len, int H, int K, int hd,
                    int hdv, const int64_t* strides, float scale, int causal, void* stream) {
  return run_mma(true, q, k, v, dout, lse, delta, kv_len, dk, dv, is_bf16, B, S, T_len, H, K,
                 hd, hdv, strides, scale, causal, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
