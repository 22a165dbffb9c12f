// A warp-specialised wgmma + TMA GEMM mainloop for Hopper (sm_90a).
//
// C (rows x cols) = A (rows x K) @ B (K x cols) with bf16 operands and f32
// sums, for a row-major A ("K-major": k contiguous, h of the LM head) and
// a B that is either row-major ("N-major": columns contiguous, the untied
// head's w stored (D, V)) or stored transposed ("K-major" like A: k
// contiguous, the tied head's w stored (V, D), the token embedding), both
// read as stored: no copy, no transpose. A block owns one
// tile of kBM = 128 rows and walks a contiguous range of column tiles of
// kBN = 256; each finished 128 x 256 tile of C is handed, in registers,
// to an epilogue (the caller's), and nothing of C is stored here.
//
// The block is three warpgroups. Warpgroup 0 is the producer: one thread
// issues the TMA loads (cp.async.bulk.tensor) of each K-tile of 64 (A:
// one 128 x 64 box; an N-major B: four 64 x 64 boxes, one per 64 columns;
// a K-major B: one box of 256 columns by 64 k, 128 bytes a column, laid
// out as A's) into a ring of kStages stages, and the copy engine signals
// the stage's "full"
// mbarrier with the bytes it wrote. Warpgroups 1 and 2 are consumers, each
// owning 64 of the 128 rows: per K-tile four wgmma.mma_async m64n256k16
// (A and B read from shared memory through descriptors, no ldmatrix), the
// 128 f32 sums a thread holds chained over K in registers; a stage is
// released on its "empty" mbarrier (one arrival per consumer warp) once
// the wgmma that read it has completed, the next K-tile's wgmma already in
// flight. Both operands are stored with the 128-byte swizzle that TMA
// writes and wgmma reads. setmaxnreg moves registers from the producer to
// the consumers (232 a thread: 128 for the accumulator).
//
// Elements outside A (rows, K) and B (K, cols) are zero-filled by TMA, so
// a ragged K-tile adds 0; columns past the epilogue's own limit must be
// masked there. The global layouts need what TMA needs: 16-byte aligned
// bases and row strides that are multiples of 16 bytes.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached through cudart
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kConsumers = 2, kThreads = 128 * (1 + kConsumers);
constexpr int kAcc = kBN / 2;  // f32 sums a consumer thread holds: 64 x 256 / 128
constexpr int kBoxN = 64;      // an N-major B's box: 64 columns (128 bytes, the swizzle span) x kBK
constexpr int kABytes = kBM * kBK * 2, kBBoxBytes = kBK * kBoxN * 2;
constexpr int kStageBytes = kABytes + (kBN / kBoxN) * kBBoxBytes;  // 48 KB
// the ring, its 1024-byte alignment (the swizzle's period) and the barriers
constexpr size_t kSmemBytes = (size_t)kStages * kStageBytes + 1024 + 2 * kStages * sizeof(uint64_t);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// One box of a 2-D tensor map at element coordinates (c0 innermost, c1)
// into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand at
// shared address `addr`: `lbo` and `sbo` in bytes. K-major (A, and the
// tied head's B): sbo is the stride of 8-row groups (1024), lbo unused.
// N-major (the untied head's B): lbo is the stride between 64-column
// swizzle atoms, sbo that of 8-row groups of k.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}
// Order the accumulator's registers after the wait above: without it the
// compiler may read them before the asynchronous wgmma has written them.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32) = A (64 x 16, K-major) @ B (16 x 256) + (accumulate
// ? d : 0), B N-major (the transposed-B flag, kTnspB = 1) or K-major
// (kTnspB = 0). d[4 j + 2 i + e] is row 16 (warp % 4) + lane / 4 + 8 i,
// column 8 j + 2 (lane % 4) + e.
template <int kTnspB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[kAcc], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTnspB));
}

// The mainloop. Grid: (row tiles, column splits); block (x, y) owns rows
// [128 x, 128 x + 128) and column tiles [y * tiles_per_block, ...) of
// the col_tiles. B_KM: B is K-major (stored cols x K), else N-major
// (stored K x cols). The epilogue Epi supplies
//   struct Rows;                         a consumer thread's state
//   Rows begin(int row) const;           row: the thread's first row
//   void tile(Rows&, const float (&acc)[kAcc], int col0) const;
//   void end(const Rows&) const;
// with acc laid out as wgmma_m64n256k16_bt's d, its rows offset by `row`
// and its columns by col0 (the tile's first column).
template <class Epi, bool B_KM>
__global__ void __launch_bounds__(kThreads, 1)
gemm_rows_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                 int k_tiles, int col_tiles, int tiles_per_block, Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.x * kBM;
  const int tile0 = blockIdx.y * tiles_per_block;
  const int n_tiles = max(0, min(col_tiles, tile0 + tiles_per_block) - tile0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const int n0 = (tile0 + t) * kBN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * kStageBytes;
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load(st, &tm_a, &full[stage], kt * kBK, m0);
          if constexpr (B_KM) {
            tma_load(st + kABytes, &tm_b, &full[stage], kt * kBK, n0);
          } else {
#pragma unroll
            for (int q = 0; q < kBN / kBoxN; ++q)
              tma_load(st + kABytes + q * kBBoxBytes, &tm_b, &full[stage], n0 + q * kBoxN,
                       kt * kBK);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // a consumer: 64 rows of every tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1, t = threadIdx.x % 128, lane = t % 32;
    typename Epi::Rows rows = epi.begin(m0 + 64 * c + 16 * (t / 32) + lane / 4);
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    int stage = 0, phase = 0, prev = 0;
    for (int tl = 0; tl < n_tiles; ++tl) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint32_t a = smem_u32(ring + stage * kStageBytes) + c * (64 * kBK * 2);
        const uint32_t b = smem_u32(ring + stage * kStageBytes + kABytes);
        wgmma_fence();
        if constexpr (B_KM) {
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_m64n256k16<0>(acc, sw128_desc(a + 32 * kk, 16, 1024),
                                sw128_desc(b + 32 * kk, 16, 1024), kt > 0 || kk > 0);
        } else {
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_m64n256k16<1>(acc, sw128_desc(a + 32 * kk, 16, 1024),
                                sw128_desc(b + 16 * 128 * kk, kBBoxBytes, 1024), kt > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous K-tile's wgmma is done: free its stage
        if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);
      epi.tile(rows, acc, (tile0 + tl) * kBN);
    }
    epi.end(rows);
  }
}

// cuTensorMapEncodeTiled, from the driver through cudart (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                                                 : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major bf16 matrix (rows x cols, row stride ld
// elements) read in boxes of box_rows x box_cols (box_cols * 2 <= 128
// bytes, box_rows <= 256), 128-byte swizzled, out-of-range elements read
// as 0. Host only; it does not touch the device.
inline cudaError_t bf16_tensor_map(CUtensorMap* map, const void* base, int64_t rows, int64_t cols,
                                   int64_t ld, int box_rows, int box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// C = A (rows x K) @ B (K x cols), bf16, tile by tile into the epilogue,
// on a grid of (row tiles, splits) with tiles_per_block column tiles per
// split. A is row-major; B row-major (N-major, B_KM false) or stored
// transposed, cols x K with row stride ldb (K-major, B_KM true).
template <class Epi, bool B_KM = false>
cudaError_t gemm_rows(const void* a, int64_t lda, const void* b, int64_t ldb, int rows, int cols,
                      int K, int splits, int tiles_per_block, Epi epi, cudaStream_t s) {
  CUtensorMap tm_a, tm_b;
  cudaError_t e = bf16_tensor_map(&tm_a, a, rows, K, lda, kBM, kBK);
  if (e == cudaSuccess)
    e = B_KM ? bf16_tensor_map(&tm_b, b, cols, K, ldb, kBN, kBK)
             : bf16_tensor_map(&tm_b, b, K, cols, ldb, kBK, kBoxN);
  if (e != cudaSuccess) return e;
  auto kernel = gemm_rows_kernel<Epi, B_KM>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((rows + kBM - 1) / kBM, splits);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(tm_a, tm_b, (K + kBK - 1) / kBK,
                                            (cols + kBN - 1) / kBN, tiles_per_block, epi);
  return cudaGetLastError();
}

}  // namespace hopper
