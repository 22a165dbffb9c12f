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
// What bounds it on an H100: bytes. At the training step's shape (B=16,
// S=T=256, 32 heads of 64, causal, bf16) q, k, v and out are 16.8 MB each,
// about 67 MB moved against about 4.3 GFLOP, far below the 295 FLOP/byte
// ridge; at llama-130m's prefill (B=8, S=T=512, 12 heads of 64) 25 MB
// against 3.2 GFLOP; a decode step (S=1) reads the filled cache once for one
// query row per head. On an H100 80GB HBM3 at 700 W (chip_smoke.py phase 4)
// the mma route takes about 0.06 ms of device time at the training shape
// against a 0.020 ms byte bound: a block has only 1 to 4 kv tiles at
// S = 256, so its first tile's copy is never hidden, each K and V tile is
// read again (from L2) by every q tile of its head, and at 136 registers a
// lane (178 at hd 128) three blocks fit an SM.
//
// Three kernels, one per route. The wrapper (attention.py, `_fwd_route`)
// chooses by dtype and shape alone, and calls `mha_fwd_mma` for the first
// and `mha_fwd` for the other two; none is a fallback of another.
//
//   * mma (bf16, S > 4, hd == hdv in {64, 128}: the training and eval steps
//     and prefill) -- FlashAttention-2 on mma.sync. One block of 4 warps
//     per (64-row q tile, head, batch), the q-tile index reversed so that
//     the blocks with the most causal work start first. The Q tile is
//     copied once into shared memory as bf16 (16-byte cp.async straight
//     through the model's strides) and held in registers as A fragments
//     (ldmatrix) for the whole kv loop. K and V tiles of 64 keys are bf16
//     in two shared buffers: the next tile's cp.async is in flight while
//     the current one is multiplied. Rows are padded by 8 elements (16
//     bytes), so the 8 rows an ldmatrix reads fall in distinct banks. Keys
//     at or past the block's last visible key are zero-filled through the
//     copy's source size, so no stale cache value reaches P.V. Each warp
//     owns 16 query rows: S = Q K^T is mma.sync m16n8k16 (bf16 products,
//     exact in f32; f32 sums), the masks are applied to the accumulator
//     fragment (only on the diagonal and kv_len edge tiles), the row max
//     and sum are taken over the 4 lanes of a quad, and the C fragments of
//     two adjacent score tiles, packed to bf16 (the rounding of p to v's
//     dtype), are the A fragment of P.V, with V read by ldmatrix.trans.
//     Nothing but the copies goes through shared memory until the epilogue,
//     which stages each warp's output rows in its own rows of the Q tile
//     for 16-byte stores. The kv loop stops at the last tile any row of
//     the block can see.
//     Tensor-core sums: each product's 16 terms are summed inside the
//     mma, and the 4 (hd 64) or 8 (hd 128) k-steps are chained through
//     its f32 accumulator, whose additions truncate rather than round.
//     With scores of order 1 and at most 8 chained steps, the difference
//     from a rounded f32 sum is some 1e-6 of a score, and lse moves by no
//     more than its largest score does, well inside 1e-4 + 1e-5 |lse|.
//     (xent.cu's backward chains far longer sums over D = 2048 and adds
//     each step's product with an IEEE add; here that is not needed.)
//     hd = 256 does not take this route: a warp's (16, 256) f32 output
//     accumulator is 128 registers a lane, and with the Q fragments (64)
//     and the scores (32) it leaves no room below the 255-register limit
//     without spills.
//   * fma (f32; bf16 with hd = 256 or hd != hdv) -- the simple design: one
//     block per (q tile, head, batch) walks the kv tiles with the running
//     max, sum and f32 accumulator in registers; K and V tiles are staged
//     in shared memory as f32; each query row is owned by TPR lanes of one
//     warp, and every product is an f32 FMA with one shared-memory operand,
//     so it is bound by its shared-memory reads, not by HBM.
//   * decode (S <= 4) -- the fma kernel with a 4-row tile and a full warp
//     per row. A decode step still gets only B*H blocks, one row each;
//     splitting the cache across blocks (split-KV) is the next step.
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

// ---------------------------------------------------------------------------
// The mma route (design in the note at the top). HD == hd == hdv.

template <int HD>
constexpr size_t mma_smem_bytes() {  // Q tile and two K and two V tiles
  return sizeof(__nv_bfloat16) * (kMmaTile + 4 * kBK) * (HD + 8);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
mha_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_len,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S, int T_len,
                   int H, int G, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb,
                   int64_t skt, int64_t skh, int64_t svb, int64_t svt, int64_t svh,
                   float scale, int causal) {
  constexpr int LD = HD + 8;      // padded rows: conflict-free ldmatrix
  constexpr int TILE = kBK * LD;  // elements of one K or V buffer
  constexpr int NS = kBK / 8;     // n8 score tiles per warp
  constexpr int NO = HD / 8;      // n8 output tiles per warp
  constexpr int KQ = HD / 16;     // k16 steps of Q K^T
  static_assert(kBK == kMmaTile && HD % 16 == 0, "tile shapes");

  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(mma_smem);  // (64, LD)
  bf16* Ks = Qs + kMmaTile * LD;                 // 2 x (64, LD)
  bf16* Vs = Ks + 2 * TILE;                      // 2 x (64, LD)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row and column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaTile;  // most causal work first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int offset = T_len - S;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0 and row0 + 8

  // Keys at or past klim are masked for every row; at or past kend for
  // every row of this block.
  const int kl = kv_len ? *kv_len : T_len;
  const int klim = min(T_len, max(kl, 0));
  int kend = klim;
  if (causal) kend = min(kend, offset + min(q0 + kMmaTile, S));
  const int n_tiles = (kend + kBK - 1) / kBK;

  const __nv_bfloat16* qb = q + b * sqb + h * sqh;
  const __nv_bfloat16* kb = k + b * skb + kvh * skh;
  const __nv_bfloat16* vb = v + b * svb + kvh * svh;
  copy_tile<HD>(Qs, qb, sqs, q0, S);    // rows past S are zeros
  auto load_kv = [&](int j, int buf) {  // keys past kend are zeros
    copy_tile_pair<HD>(Ks + buf * TILE, kb, skt, Vs + buf * TILE, vb, svt, j * kBK, kend);
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();  // group 0: the Q tile and kv tile 0

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this lane's share of the row sum
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  unsigned qf[KQ][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1, k0 = j * kBK;
    if (j + 1 < n_tiles) {
      load_kv(j + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and at j = 0 the Q tile) is in shared memory
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KQ; ++ks) frag_a<LD>(qf[ks], Qs, warp, ks, lane);
    }
    const __nv_bfloat16* Kt = Ks + buf * TILE;
    const __nv_bfloat16* Vt = Vs + buf * TILE;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KQ; ++ks)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned kf[4];  // B fragments of key tiles 2np and 2np+1
        frag_bt<LD>(kf, Kt, np * 16, ks, lane);
        mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }

    // Only the diagonal and kv_len edge tiles mask element by element.
    const bool edge = k0 + kBK > klim || (causal && k0 + kBK - 1 > offset + q0);
    auto valid = [&](int n, int e) {
      const int col = k0 + n * 8 + 2 * t4 + (e & 1), row = row0 + 8 * (e >> 1);
      return !edge || (col < klim && (!causal || offset + row >= col));
    };
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = valid(n, e) ? s[n][e] * scale : kNeg;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float m_new[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new[i]);
      m[i] = m_new[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = valid(n, e) ? expf(s[n][e] - m_new[e >> 1]) : 0.f;
        l[e >> 1] += p;  // the sum takes p in f32, P.V in v's dtype
        s[n][e] = p;
      }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      unsigned pa[4];
      pack_a(pa, s + 2 * kk);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        unsigned vf[4];  // B fragments of output tiles 2np and 2np+1
        frag_b<LD>(vf, Vt, kk * 16, np * 16, lane);
        mma_bf16(o[2 * np], pa, vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // buffer buf is free for the copy of tile j + 2
  }

  cp_async_wait<0>();  // with no tile, the Q copy may still be in flight
  __syncthreads();     // every copy into Qs has landed before it is reused
  float lc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lc[i] = fmaxf(l[i], 1e-30f);  // fully masked rows -> 0 output
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] /= lc[e >> 1];
  // This warp's 16 output rows through its own rows of Qs, then 16-byte
  // stores of whole rows.
  const int w0 = q0 + warp * 16;
  store_rows<HD>(Qs + warp * 16 * LD, o, out + (((int64_t)b * S + w0) * H + h) * HD,
                 (int64_t)H * HD, S - w0, lane);
  if (t4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < S) lse[((int64_t)b * H + h) * S + row] = m[i] + logf(lc[i]);
    }
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const int* kv_len,
                       void* out, float* lse, int B, int S, int T_len, int H, int K,
                       const int64_t* st, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HD>();  // 46 KB at hd 64, 85 KB at hd 128
  cudaError_t e = cudaFuncSetAttribute(mha_fwd_mma_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + kMmaTile - 1) / kMmaTile, H, B);
  mha_fwd_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_len, static_cast<__nv_bfloat16*>(out), lse, S,
      T_len, H, H / K, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal);
  return cudaGetLastError();
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

// The mma route: the arguments of mha_fwd, for bf16 with hd == hdv in
// {64, 128} only (anything else is cudaErrorInvalidValue).
int mha_fwd_mma(const void* q, const void* k, const void* v, const int* kv_len, void* out,
                float* lse, int is_bf16, int B, int S, int T_len, int H, int K, int hd,
                int hdv, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t skt,
                int64_t skh, int64_t svb, int64_t svt, int64_t svh, float scale, int causal,
                void* stream) {
  const int64_t st[9] = {sqb, sqs, sqh, skb, skt, skh, svb, svt, svh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16 || hd != hdv) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaErrorInvalidValue;
  if (hd == 64)
    e = launch_mma<64>(q, k, v, kv_len, out, lse, B, S, T_len, H, K, st, scale, causal, s);
  else if (hd == 128)
    e = launch_mma<128>(q, k, v, kv_len, out, lse, B, S, T_len, H, K, st, scale, causal, s);
  return static_cast<int>(e);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
