// Tiled matrix product whose output tiles are launched along a space-filling
// curve (Morton, Hilbert or row-major), for Hopper.
//
// Replaces the Pallas kernel `morton_matmul_kernel`
// (src/repro/kernels/morton_matmul/kernel.py:49, pallas_call at :101).
//
// What it computes.  out = a (M, K) . b (K, N), summed in fp32, rounded
// once to T (float or bfloat16).  The output is cut into (bm, bn) tiles,
// an nm x nn grid with ragged last rows and columns, and block b of the
// launch computes tile tiles[b] (tile id i * nn + j).  The wrapper builds
// `tiles` on the host from the TPU kernel's own index maps (kernel.py:63-84)
// and keeps it on the card.
//
// Duplicate curve cells.  On the TPU the grid is walked in order on one
// core; for a grid that is not a power of two (or, for Hilbert, not a
// square power of two) the curve is padded and its extra cells are clamped
// onto real tiles, which the TPU then writes again with the same values.
// Those duplicates need not be consecutive (a 3 x 3 Morton walk visits
// (0,2), (1,2), then (0,2) again).  Here blocks run in parallel, so a
// duplicate block would write a tile while another writes it too.  So
// `tiles` is the curve's first visit of each tile: a permutation of the
// nm * nn tiles, one block each.  Every tile is written exactly once, with
// no atomics and no split of K, and each tile's arithmetic does not depend
// on the block that computes it, so the three orders give bit-identical
// results.  The hardware dispatches blocks in index order, so the launch
// follows the curve.
//
// Two bodies.
//
// fp32 (the TPU kernel's HIGHEST precision; TF32 would break the JAX
// test's 1e-4): fp32 FMAs on the CUDA cores, summed over k in order.  A
// block of 256 threads (16 x 16) computes its (bm, bn) tile as consecutive
// 128 x 128 sub-tiles (a 256 x 256 fp32 accumulator would be 256 KB, past
// both the registers and shared memory), each thread 8 x 8 outputs in
// registers.  K is walked in block_k steps, as the TPU grid's inner axis
// walks it, each step in stages of 32 through shared memory: A transposed
// and B row-major (33 KB), read as 16-byte vectors (4 vector loads per 64
// FMAs).  The next stage's global loads go to registers before the current
// stage's products.  A chunk that is whole and 16-byte aligned is one or
// two vector loads, any other (the ragged edges of M, N and K, a block_k
// step that ends inside a stage, an unaligned row) is loaded value by value
// with zeros past the edge, so any shape is taken.
//
// bf16: Hopper's tensor-core path.  A block of three warpgroups walks its
// (bm, bn) tile in CTA sub-tiles of 128 x BN (BN 256 when bn > 128, else
// 128).  Warpgroup 0 is the producer: one thread keeps a ring of 4
// shared-memory stages filled by TMA (cp.async.bulk.tensor, 128-byte
// swizzle), each stage a 128 x 64 A box and BN / 64 boxes of 64 x 64 of B,
// completion counted on a `full` mbarrier per stage.  Warpgroups 1 and 2
// are consumers, 64 rows of the sub-tile each: they wait on `full`, run
// four wgmma.mma_async m64nBNk16 products (bf16 in, fp32 accumulators in
// registers, BN / 2 a thread) reading A K-major and B, row-major (K, N) in
// memory, MN-major through the descriptor's transpose bit (no transpose
// copy), keep one stage's products in flight, and release the stage before
// on an `empty` mbarrier.  K is summed in stages of 64 in order; block_k no
// longer sets the order of the sum in this body.  The epilogue rounds the
// accumulators once to bf16 and stores them, masked to the caller's tile
// and to the matrix, while the producer already loads the next sub-tile.
// TMA fills the boxes' parts past M, N or K with zeros, which covers the
// ragged edges.  TMA needs 16-byte aligned bases and row strides: this
// body reads rows of a and b at a stride of K and N rounded up to a
// multiple of 8 elements, and the wrapper hands it padded, aligned copies
// of operands that are not laid out so (and counts them).
//
// Bound.  At M = N = K = 8192 in bf16 the work is 2 * M * N * K = 1.10e12
// operations, 1.11 ms at the card's 989 TFLOP/s bf16 tensor rate, against
// 0.40 GB of operands and result (each read or written once), 0.12 ms at
// 3.35 TB/s: operations bound it.  In fp32 the bound is the CUDA cores'
// 67 TFLOP/s (16.4 ms).  Now that bf16 runs on the tensor cores, the
// curve decides which A and B panels the blocks in flight share in L2,
// which can show in the time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "_hopper.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kS = 128;        // sub-tile rows and columns
constexpr int kBK = 32;        // depth per stage
constexpr int kLA = kS + 4;    // row of the transposed A stage, 16-byte aligned
constexpr int kChunks = kS * kBK / 8 / kThreads;  // 8-value chunks a thread loads per operand
static_assert(kChunks == 2, "two chunks of A and two of B per thread");

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// `valid` (0 to 8) consecutive values as fp32, zeros after them
__device__ __forceinline__ void load8(const float* p, int valid, float* v) {
  if (valid == 8 && aligned16(p)) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < valid ? p[i] : 0.f;
  }
}
// the first `valid` (1 to 4) of 4 fp32 values at p
__device__ __forceinline__ void store4(float* p, float4 v, int valid) {
  if (valid == 4 && aligned16(p)) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    if (valid > 0) p[0] = v.x;
    if (valid > 1) p[1] = v.y;
    if (valid > 2) p[2] = v.z;
    if (valid > 3) p[3] = v.w;
  }
}
__device__ __forceinline__ int clamp8(int n) { return max(0, min(8, n)); }

// One stage of A: sub-tile rows [r0, r0 + 128) x depth [k0, k0 + 32) of a
// row-major (M, K) matrix; rows at or past `rend`, depth at or past `kend`
// as zeros.  Chunk c of thread t is row (t + 256 c) / 4, depth 8 * (t % 4).
template <typename T>
struct AStage {
  float v[kChunks][8];
  __device__ void fetch(const T* __restrict__ a, int64_t K, int r0, int rend,
                        int k0, int kend) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      const int m = idx / (kBK / 8), kk = idx % (kBK / 8) * 8;
      const int valid = r0 + m < rend ? clamp8(kend - (k0 + kk)) : 0;
      load8(a + (int64_t)(r0 + m) * K + k0 + kk, valid, v[c]);
    }
  }
  __device__ void put(float* As) const {  // transposed: As[k][m]
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      const int m = idx / (kBK / 8), kk = idx % (kBK / 8) * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) As[(kk + i) * kLA + m] = v[c][i];
    }
  }
};

// One stage of B: depth [k0, k0 + 32) x sub-tile columns [c0, c0 + 128)
// of a row-major (K, N) matrix; depth at or past `kend` and columns at or
// past `cend` as zeros.  Chunk c of thread t is depth (t + 256 c) / 16,
// columns 8 * (t % 16).
template <typename T>
struct BStage {
  float v[kChunks][8];
  __device__ void fetch(const T* __restrict__ b, int64_t N, int c0, int cend,
                        int k0, int kend) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      const int k = idx / (kS / 8), n = idx % (kS / 8) * 8;
      const int valid = k0 + k < kend ? clamp8(cend - (c0 + n)) : 0;
      load8(b + (int64_t)(k0 + k) * N + c0 + n, valid, v[c]);
    }
  }
  __device__ void put(float* Bs) const {  // row-major: Bs[k][n]
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      const int k = idx / (kS / 8), n = idx % (kS / 8) * 8;
      float* dst = Bs + k * kS + n;
      *reinterpret_cast<float4*>(dst) =
          make_float4(v[c][0], v[c][1], v[c][2], v[c][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(v[c][4], v[c][5], v[c][6], v[c][7]);
    }
  }
};

// Block b computes tile tiles[b].  `trace`, when not null, holds 3 n + 1
// int32 zeros (n = nm * nn) and records the tile block b computed
// (trace[b]), how many times each tile was computed (trace[n + tile]) and
// the order in which blocks started (trace[2 n + b], from the counter at
// trace[3 n]).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    morton_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         T* __restrict__ out, const int* __restrict__ tiles,
                         int* __restrict__ trace, int M, int N, int K, int bm,
                         int bn, int bk, int nn, int n_tiles) {
  __shared__ __align__(16) float As[kBK * kLA];
  __shared__ __align__(16) float Bs[kBK * kS];
  const int tile = tiles[blockIdx.x];
  if (trace != nullptr && threadIdx.x == 0) {
    trace[blockIdx.x] = tile;
    atomicAdd(trace + n_tiles + tile, 1);
    trace[2 * n_tiles + blockIdx.x] = atomicAdd(trace + 3 * n_tiles, 1);
  }
  const int ti = tile / nn, tj = tile % nn;
  const int row_end = (int)min((int64_t)ti * bm + bm, (int64_t)M);
  const int col_end = (int)min((int64_t)tj * bn + bn, (int64_t)N);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  for (int r0 = ti * bm; r0 < row_end; r0 += kS) {
    const int rend = min(r0 + kS, row_end);
    for (int c0 = tj * bn; c0 < col_end; c0 += kS) {
      const int cend = min(c0 + kS, col_end);
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
      AStage<T> as;
      BStage<T> bs;
      // stages walk each block_k step [kb, kend) 32 at a time
      int k0 = 0, kend = min(bk, K);
      as.fetch(a, K, r0, rend, k0, kend);
      bs.fetch(b, N, c0, cend, k0, kend);
      while (k0 < K) {
        __syncthreads();  // the previous stage's products are done
        as.put(As);
        bs.put(Bs);
        __syncthreads();
        int nk0 = k0 + kBK, nkend = kend;
        if (nk0 >= kend) {  // the next block_k step
          nk0 = kend;
          nkend = (int)min((int64_t)kend + bk, (int64_t)K);
        }
        if (nk0 < K) {  // the next stage's loads fly during the products
          as.fetch(a, K, r0, rend, nk0, nkend);
          bs.fetch(b, N, c0, cend, nk0, nkend);
        }
#pragma unroll 8
        for (int k = 0; k < kBK; ++k) {
          const float4 a0 = *reinterpret_cast<const float4*>(As + k * kLA + ty * 4);
          const float4 a1 = *reinterpret_cast<const float4*>(As + k * kLA + 64 + ty * 4);
          const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kS + tx * 4);
          const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * kS + 64 + tx * 4);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }
        k0 = nk0;
        kend = nkend;
      }
      // rows ty*4 + r and 64 + ty*4 + r, columns tx*4 + c and 64 + tx*4 + c
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int m = r0 + (r / 4) * 64 + ty * 4 + r % 4;
        if (m >= rend) continue;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int n = c0 + g * 64 + tx * 4;
          if (n < cend)
            store4(out + (int64_t)m * N + n,
                   make_float4(acc[r][4 * g], acc[r][4 * g + 1], acc[r][4 * g + 2],
                               acc[r][4 * g + 3]),
                   min(4, cend - n));
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* out, const int* tiles,
                   int* trace, int M, int N, int K, int bm, int bn, int bk,
                   int nn, int n_tiles, cudaStream_t stream) {
  morton_matmul_kernel<T><<<n_tiles, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      tiles, trace, M, N, K, bm, bn, bk, nn, n_tiles);
  return cudaGetLastError();
}

// ------------------------------------------------------ bf16: tensor cores

namespace tc {

constexpr int kBM = 128;            // CTA sub-tile rows: two consumers of 64
constexpr int kBK = 64;             // depth of a stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 3 * 128;   // producer warpgroup + two consumers
constexpr int kBox = 64;            // B box side (64 x 64 bf16, 8 KB)

template <int BN>
struct Smem {
  static constexpr int kA = kBM * kBK;  // elements of a stage of A
  static constexpr int kB = kBK * BN;   // of B: BN / 64 boxes of 64 x 64
  static constexpr size_t bytes =
      kStages * (kA + kB) * sizeof(__nv_bfloat16) + 2 * kStages * sizeof(uint64_t);
  static constexpr size_t dynamic = bytes + 1024;  // room to align to 1024
};

// Block b computes tile tiles[b]; `trace` as in the fp32 body.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    morton_matmul_tc(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap bmap,
                     __nv_bfloat16* __restrict__ out, const int* __restrict__ tiles,
                     int* __restrict__ trace, int M, int N, int K, int bm, int bn,
                     int nn, int n_tiles) {
  using S = Smem<BN>;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms must start 1024-byte aligned (descriptor base offset 0)
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* Bs = As + kStages * S::kA;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kStages * S::kB);
  uint64_t* empty = full + kStages;

  const int tile = tiles[blockIdx.x];
  if (threadIdx.x == 0) {
    if (trace != nullptr) {
      trace[blockIdx.x] = tile;
      atomicAdd(trace + n_tiles + tile, 1);
      trace[2 * n_tiles + blockIdx.x] = atomicAdd(trace + 3 * n_tiles, 1);
    }
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int ti = tile / nn, tj = tile % nn;
  const int row0 = ti * bm, col0 = tj * bn;
  const int row_end = min(row0 + bm, M), col_end = min(col0 + bn, N);
  const int subs_n = (col_end - col0 + BN - 1) / BN;
  const int subs = (row_end - row0 + kBM - 1) / kBM * subs_n;
  const int nk = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // producer: one thread issues every load; the warpgroup gives up registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int it = 0; it < subs * nk; ++it) {
        const int s = it % kStages, round = it / kStages;
        const int sub = it / nk, k0 = (it % nk) * kBK;
        const int r0 = row0 + sub / subs_n * kBM, c0 = col0 + sub % subs_n * BN;
        hopper::mbar_wait(&empty[s], (round & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], (S::kA + S::kB) * sizeof(__nv_bfloat16));
        hopper::tma_load_2d(As + s * S::kA, &amap, &full[s], k0, r0);
#pragma unroll
        for (int c = 0; c < BN / kBox; ++c)
          hopper::tma_load_2d(Bs + s * S::kB + c * kBox * kBK, &bmap, &full[s],
                              c0 + c * kBox, k0);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;                     // rows [64 cw, 64 cw + 64) of a sub-tile
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const bool leader = t == 0;
    float acc[BN / 2];
    int it = 0;
    for (int sub = 0; sub < subs; ++sub) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        acc[i] = 0.f;
        hopper::fence_operand(acc[i]);
      }
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(&full[s], (it / kStages) & 1);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart, k16
          // steps 32 bytes along the row.  B: MN-major, 64-column boxes
          // kBK * 128 bytes apart (leading), 8-row groups 1024 bytes apart
          // (stride), k16 steps 16 rows = 2048 bytes.
          const uint64_t da = hopper::sw128_desc(As + s * S::kA + cw * 64 * kBK + kk * 16,
                                                 16, 1024);
          const uint64_t db = hopper::sw128_desc(Bs + s * S::kB + kk * 16 * kBox,
                                                 kBox * kBK * 2, 1024);
          hopper::wgmma_bn<BN>(acc, da, db);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the stage before this one is read
        if (kb > 0 && leader) hopper::mbar_arrive(&empty[(it - 1) % kStages]);
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) hopper::fence_operand(acc[i]);
      if (leader) hopper::mbar_arrive(&empty[(it - 1) % kStages]);

      // epilogue: acc[4 j + 2 h + e] is row warp * 16 + lane / 4 + 8 h,
      // column 8 j + 2 (lane % 4) + e of this warpgroup's 64 x BN
      const int r0 = row0 + sub / subs_n * kBM + cw * 64 + warp * 16 + lane / 4;
      const int c0 = col0 + sub % subs_n * BN + 2 * (lane % 4);
      const bool pairs = (N % 2) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= row_end) continue;
        __nv_bfloat16* orow = out + (int64_t)r * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = c0 + 8 * j;
          const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
          if (pairs && c + 1 < col_end) {
            *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(x0, x1);
          } else {
            if (c < col_end) orow[c] = __float2bfloat16_rn(x0);
            if (c + 1 < col_end) orow[c + 1] = __float2bfloat16_rn(x1);
          }
        }
      }
    }
  }
}

// a row-major (rows, cols) bf16 matrix with rows `ld` elements apart, in
// boxes of box_rows x 64 with 128-byte swizzle; zeros past its edges
bool make_map(CUtensorMap* map, const void* base, int64_t rows, int64_t cols,
              int64_t ld, int box_rows) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
cudaError_t launch(const void* a, const void* b, void* out, const int* tiles, int* trace,
                   int M, int N, int K, int bm, int bn, int nn, int n_tiles,
                   cudaStream_t stream) {
  const int64_t lda = (K + 7) / 8 * 8, ldb = (N + 7) / 8 * 8;
  CUtensorMap amap, bmap;
  if (!make_map(&amap, a, M, K, lda, kBM) || !make_map(&bmap, b, K, N, ldb, kBK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(morton_matmul_tc<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Smem<BN>::dynamic);
  if (err != cudaSuccess) return err;
  morton_matmul_tc<BN><<<n_tiles, kThreads, Smem<BN>::dynamic, stream>>>(
      amap, bmap, static_cast<__nv_bfloat16*>(out), tiles, trace, M, N, K, bm, bn, nn,
      n_tiles);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// C entry point (bound with ctypes).  a (M, K), b (K, N) and out (M, N),
// in the dtype given (0 = float32, 1 = bfloat16); tiles (n_tiles,) int32
// on the device, a permutation of the ceil(M / bm) x ceil(N / bn) tile ids
// i * nn + j; trace null or 3 n_tiles + 1 int32 zeros.  float32: all
// contiguous.  bfloat16: out contiguous; a and b 16-byte aligned, with
// rows K and N rounded up to a multiple of 8 elements apart (contiguous
// when K and N are multiples of 8); bk is not used.  Returns the
// cudaError_t of the launch (0 on success); cudaErrorInvalidValue (1) for
// a shape or layout the kernel does not take.
extern "C" int morton_matmul_launch(const void* a, const void* b, void* out,
                                    const void* tiles, void* trace, int64_t M,
                                    int64_t N, int64_t K, int64_t bm,
                                    int64_t bn, int64_t bk, int64_t n_tiles,
                                    int64_t dtype, void* stream) {
  const int64_t kMax = (int64_t(1) << 31) - 256;
  if (M < 1 || N < 1 || K < 1 || bm < 1 || bn < 1 || bk < 1 || M > kMax ||
      N > kMax || K > kMax || bm > M || bn > N || bk > K)
    return cudaErrorInvalidValue;
  const int64_t nm = (M + bm - 1) / bm, nn = (N + bn - 1) / bn;
  if (n_tiles != nm * nn || 3 * n_tiles + 1 > kMax) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tiles);
  int* tr = static_cast<int*>(trace);
  if (dtype == 0)
    return launch<float>(a, b, out, t, tr, (int)M, (int)N, (int)K, (int)bm,
                         (int)bn, (int)bk, (int)nn, (int)n_tiles, s);
  if (dtype == 1) {
    if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15)
      return cudaErrorInvalidValue;
    if (bn > 128)
      return tc::launch<256>(a, b, out, t, tr, (int)M, (int)N, (int)K, (int)bm, (int)bn,
                             (int)nn, (int)n_tiles, s);
    return tc::launch<128>(a, b, out, t, tr, (int)M, (int)N, (int)K, (int)bm, (int)bn,
                           (int)nn, (int)n_tiles, s);
  }
  return cudaErrorInvalidValue;
}

// Blocks of the kernel that one SM holds at once, for the dtype given (the
// bf16 body at its 128 x 256 sub-tile), in *blocks; returns the
// cudaError_t of the query.
extern "C" int morton_matmul_blocks_per_sm(int64_t dtype, int* blocks) {
  if (dtype == 0)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, morton_matmul_kernel<float>, kThreads, 0);
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(tc::morton_matmul_tc<256>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)tc::Smem<256>::dynamic);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, tc::morton_matmul_tc<256>, tc::kThreads, tc::Smem<256>::dynamic);
  }
  return cudaErrorInvalidValue;
}
