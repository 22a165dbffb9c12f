// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `mha_fwd` of src/repro/kernels/attention/attention.py
// (`_fwd_kernel`, line 223; `pallas_call` at line 290). It computes the same
// function: out = softmax(scale * q k^T, masked) v with native GQA (kv head =
// q_head / G, never repeated), the rectangular causal mask with offset T - S,
// the `kv_len` cache-fill bound read from a device int32 scalar, and the
// per-row f32 log-sum-exp. The segment-id clause of the TPU kernel is not
// ported yet (it comes with packed training batches).
//
// Numerics follow the TPU kernel exactly:
//   * masked scores are the finite -1e30, never -inf, and p is an explicit
//     `valid ? exp(s - m) : 0`, so a fully masked row neither NaNs nor adds
//     exp(0) = 1 per masked column;
//   * p is rounded to v's dtype before the P.V product; all sums are f32;
//   * the epilogue clamps l at 1e-30, so a fully masked row (kv_len = 0)
//     gives exactly 0, and lse = m + log(l).
//
// What bounds it on an H100: bytes. At the serving path's prefill shape
// (B=8, S=T=512, H=K=12, hd=64, causal) q, k, v and out are 6.3 MB each,
// about 25 MB moved against about 3.2 GFLOP, far below the 295 FLOP/byte
// ridge; a decode step (S=1) reads the whole filled cache once for one
// query row per head.
//
// The design is the simple one: one thread block per (q tile, head, batch)
// walks the kv tiles in order (the loop takes the place of the TPU's
// sequential kv grid axis) with the running max, sum and f32 accumulator in
// registers. K and V tiles are staged in shared memory as f32 with 16-byte
// loads straight from the model's (B, T, K, hd) layout, read through strides.
// Each query row is owned by TPR consecutive lanes of one warp: lane t
// computes the scores of columns t, t+TPR, ... and accumulates output dims
// t, t+TPR, ...; row max and sum are warp shuffles. Products are plain f32
// FMAs (no mma.sync, wgmma or TMA), so at prefill the kernel is bound by its
// shared-memory reads, not by HBM. The kv loop stops at the last tile that
// any row of the block can see (kv_len bound and causal diagonal), as the
// TPU kernel skips fully masked tiles. Small S (decode) takes a 4-row tile
// with a full warp per row. A decode step still gets only B*H blocks, one
// row each; splitting the cache across blocks (split-KV) is the next step.
#include "attn_common.cuh"

namespace {

constexpr int kBK = 64;         // keys per kv tile

// One block: BQ query rows of one (batch, head); TPR lanes per row.
// DMAX bounds hdv (the accumulator count per lane is DMAX / TPR).
template <typename T, int BQ, int TPR, int DMAX>
__global__ void __launch_bounds__(BQ * TPR)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int* __restrict__ kv_len, T* __restrict__ out, float* __restrict__ lse,
               int S, int T_len, int H, int G, int hd, int hdv,
               int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t skt, int64_t skh,
               int64_t svb, int64_t svt, int64_t svh, float scale, int causal) {
  constexpr int NT = BQ * TPR;
  constexpr int NCOL = kBK / TPR;   // score columns per lane
  constexpr int NACC = DMAX / TPR;  // output dims per lane
  static_assert(32 % TPR == 0, "a row's lanes must share a warp");

  extern __shared__ float smem[];
  const int lq = hd + 1, lk = hd + 1, lp = kBK + 1;  // odd strides: no bank conflicts
  float* Qs = smem;              // (BQ, hd)
  float* Ks = Qs + BQ * lq;      // (kBK, hd)
  float* Vs = Ks + kBK * lk;     // (kBK, hdv)
  float* Ps = Vs + kBK * hdv;    // (BQ, kBK)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int r = threadIdx.x / TPR, t = threadIdx.x % TPR;
  const int row = q0 + r;
  const int offset = T_len - S;

  const T* qb = q + b * sqb + h * sqh + (int64_t)q0 * sqs;
  const T* kb = k + b * skb + kvh * skh;
  const T* vb = v + b * svb + kvh * svh;
  stage<T, NT>(Qs, lq, qb, sqs, BQ, hd, S - q0);

  // Keys at or past `kend` are masked for every row of this block.
  const int kl = kv_len ? *kv_len : T_len;
  int kend = min(T_len, max(kl, 0));
  if (causal) kend = min(kend, offset + min(q0 + BQ, S));
  const int n_tiles = (kend + kBK - 1) / kBK;

  float m = kNeg, l = 0.f;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile is consumed (and Qs staged)
    stage<T, NT>(Ks, lk, kb + (int64_t)k0 * skt, skt, kBK, hd, T_len - k0);
    stage<T, NT>(Vs, hdv, vb + (int64_t)k0 * svt, svt, kBK, hdv, T_len - k0);
    __syncthreads();

    float s[NCOL];
#pragma unroll
    for (int c = 0; c < NCOL; ++c) s[c] = 0.f;
    const float* qrow = Qs + r * lq;
    for (int d = 0; d < hd; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) s[c] = fmaf(qd, Ks[(t + c * TPR) * lk + d], s[c]);
    }

    bool valid[NCOL];
    float tile_max = kNeg;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int col = k0 + t + c * TPR;
      valid[c] = col < T_len && col < kl && (!causal || offset + row >= col);
      s[c] = valid[c] ? s[c] * scale : kNeg;
      tile_max = fmaxf(tile_max, s[c]);
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, o));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);

    float psum = 0.f;
    float* prow = Ps + r * lp;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const float p = valid[c] ? expf(s[c] - m_new) : 0.f;
      psum += p;
      prow[t + c * TPR] = to_f32(from_f32<T>(p));  // p in v's dtype for P.V
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's p values are written by lanes of its own warp

    // Columns at or past kend have p == 0: stop there.
    const int cend = min(kBK, kend - k0);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= alpha;
    for (int c = 0; c < cend; ++c) {
      const float p = prow[c];
      const float* vrow = Vs + c * hdv;
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int d = t + i * TPR;
        if (d < hdv) acc[i] = fmaf(p, vrow[d], acc[i]);
      }
    }
  }

  if (row < S) {
    const float lc = fmaxf(l, 1e-30f);  // fully masked rows -> 0 output
    T* orow = out + (((int64_t)b * S + row) * H + h) * hdv;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int d = t + i * TPR;
      if (d < hdv) orow[d] = from_f32<T>(acc[i] / lc);
    }
    if (t == 0) lse[((int64_t)b * H + h) * S + row] = m + logf(lc);
  }
}

template <typename T, int BQ, int TPR, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_len, void* out,
                   float* lse, int B, int S, int T_len, int H, int K, int hd, int hdv,
                   const int64_t* st, float scale, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (hd + 1) + kBK * (hd + 1) + kBK * hdv + BQ * (kBK + 1));
  // Above 48 KB a launch is refused unless the kernel opts in; the wrapper
  // bounds hd and hdv so that the largest case fits the H100's 227 KB.
  cudaError_t e = cudaFuncSetAttribute(mha_fwd_kernel<T, BQ, TPR, DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  mha_fwd_kernel<T, BQ, TPR, DMAX><<<grid, BQ * TPR, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_len,
      static_cast<T*>(out), lse, S, T_len, H, H / K, hd, hdv, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], scale, causal);
  return cudaGetLastError();
}

template <typename T, int BQ, int TPR>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* kv_len, void* out,
                     float* lse, int B, int S, int T_len, int H, int K, int hd, int hdv,
                     const int64_t* st, float scale, int causal, cudaStream_t stream) {
  if (hdv <= 64)
    return launch<T, BQ, TPR, 64>(q, k, v, kv_len, out, lse, B, S, T_len, H, K, hd, hdv, st,
                                  scale, causal, stream);
  if (hdv <= 128)
    return launch<T, BQ, TPR, 128>(q, k, v, kv_len, out, lse, B, S, T_len, H, K, hd, hdv, st,
                                   scale, causal, stream);
  return launch<T, BQ, TPR, 256>(q, k, v, kv_len, out, lse, B, S, T_len, H, K, hd, hdv, st,
                                 scale, causal, stream);
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, const int* kv_len, void* out,
                     float* lse, int B, int S, int T_len, int H, int K, int hd, int hdv,
                     const int64_t* st, float scale, int causal, cudaStream_t stream) {
  if (S <= 4)  // decode: one warp per row, four rows
    return launch_d<T, 4, 32>(q, k, v, kv_len, out, lse, B, S, T_len, H, K, hd, hdv, st,
                              scale, causal, stream);
  return launch_d<T, 32, 8>(q, k, v, kv_len, out, lse, B, S, T_len, H, K, hd, hdv, st, scale,
                            causal, stream);
}

}  // namespace

extern "C" {

// q (B,S,H,hd), k (B,T,K,hd), v (B,T,K,hdv) through element strides
// st = {q: b,s,h; k: b,t,h; v: b,t,h}, last dim contiguous. out (B,S,H,hdv)
// contiguous in q's dtype, lse (B,H,S) f32. kv_len: device int32 scalar or
// NULL (= T). Returns the launch's cudaError_t.
int mha_fwd(const void* q, const void* k, const void* v, const int* kv_len, void* out,
            float* lse, int is_bf16, int B, int S, int T_len, int H, int K, int hd, int hdv,
            int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t skt, int64_t skh,
            int64_t svb, int64_t svt, int64_t svh, float scale, int causal, void* stream) {
  const int64_t st[9] = {sqb, sqs, sqh, skb, skt, skh, svb, svt, svh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      is_bf16 ? launch_t<__nv_bfloat16>(q, k, v, kv_len, out, lse, B, S, T_len, H, K, hd, hdv,
                                        st, scale, causal, s)
              : launch_t<float>(q, k, v, kv_len, out, lse, B, S, T_len, H, K, hd, hdv, st,
                                scale, causal, s);
  return static_cast<int>(e);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
