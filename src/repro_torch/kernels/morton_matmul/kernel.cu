// Tiled matrix product whose output tiles are launched along a space-filling
// curve (Morton, Hilbert or row-major), for Hopper.
//
// Replaces the Pallas kernel `morton_matmul_kernel`
// (src/repro/kernels/morton_matmul/kernel.py:49, pallas_call at :101).
//
// What it computes.  out = a (M, K) . b (K, N), summed in fp32 over k in
// order, rounded once to T (float or bfloat16).  For fp32 operands the
// products are fp32 FMAs (the TPU kernel's HIGHEST precision; no TF32);
// bf16 operands are widened to fp32, whose products are exact.  The output
// is cut into (bm, bn) tiles, an nm x nn grid with ragged last rows and
// columns, and block b of the launch computes tile tiles[b] (tile id
// i * nn + j).  The wrapper builds `tiles` on the host from the TPU
// kernel's own index maps (kernel.py:63-84) and keeps it on the card.
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
// no atomics, and each tile's arithmetic does not depend on the order, so
// the three orders give bit-identical results.  The hardware dispatches
// blocks in index order, so the launch follows the curve.
//
// Design.  A block of 256 threads (16 x 16) computes its (bm, bn) tile as
// consecutive 128 x 128 sub-tiles (a 256 x 256 fp32 accumulator would be
// 256 KB, past both the registers and shared memory), each thread 8 x 8
// outputs in registers.  K is walked in block_k steps, as the TPU grid's
// inner axis walks it, each step in stages of 32 through shared memory: A
// transposed and B row-major, both in fp32 (33 KB), read as 16-byte
// vectors (4 vector loads per 64 FMAs).  The next stage's global loads go
// to registers before the current stage's products.  Loads are 8 values a
// thread; a chunk that is whole and 16-byte aligned is one or two vector
// loads, any other (the ragged edges of M, N and K, a block_k step that
// ends inside a stage, an unaligned row) is loaded value by value with
// zeros past the edge, so any shape is taken.  Stores past the tile or the
// matrix are masked.  Offsets are 64-bit.
//
// Bound.  At M = N = K = 8192 in bf16 the work is 2 * M * N * K = 1.10e12
// operations, 1.11 ms at the card's 989 TFLOP/s bf16 tensor rate, against
// 0.40 GB of operands and result (each read or written once), 0.12 ms at
// 3.35 TB/s: operations bound it.  In fp32 the bound is the CUDA cores'
// 67 TFLOP/s (16.4 ms).  This kernel does fp32 FMAs on the CUDA cores in
// both cases, so in bf16 it sits far above its bound, and the tile order
// can change little while the FMAs take the time: the curve decides which
// A and B panels the blocks in flight share in L2, which matters once the
// products run on tensor cores (mma.sync, wgmma, TMA: later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int valid, float* v) {
  if (valid == 8 && aligned16(p)) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < valid ? __bfloat162float(p[i]) : 0.f;
  }
}

// the first `valid` (1 to 4) of 4 fp32 values into T at p, rounded to
// nearest even
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
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v, int valid) {
  if (valid == 4 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    if (valid > 0) p[0] = __float2bfloat16_rn(v.x);
    if (valid > 1) p[1] = __float2bfloat16_rn(v.y);
    if (valid > 2) p[2] = __float2bfloat16_rn(v.z);
    if (valid > 3) p[3] = __float2bfloat16_rn(v.w);
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

}  // namespace

// C entry point (bound with ctypes).  a (M, K), b (K, N) and out (M, N),
// contiguous, in the dtype given (0 = float32, 1 = bfloat16); tiles
// (n_tiles,) int32 on the device, a permutation of the ceil(M / bm) x
// ceil(N / bn) tile ids i * nn + j; trace null or 3 n_tiles + 1 int32
// zeros.  Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue (1) for a shape the kernel does not take.
extern "C" int morton_matmul_launch(const void* a, const void* b, void* out,
                                    const void* tiles, void* trace, int64_t M,
                                    int64_t N, int64_t K, int64_t bm,
                                    int64_t bn, int64_t bk, int64_t n_tiles,
                                    int64_t dtype, void* stream) {
  const int64_t kMax = (int64_t(1) << 31) - kS;
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
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, out, t, tr, (int)M, (int)N, (int)K,
                                 (int)bm, (int)bn, (int)bk, (int)nn,
                                 (int)n_tiles, s);
  return cudaErrorInvalidValue;
}

// Blocks of the kernel that one SM holds at once, for the dtype given, in
// *blocks; returns the cudaError_t of the query.
extern "C" int morton_matmul_blocks_per_sm(int64_t dtype, int* blocks) {
  if (dtype == 0)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, morton_matmul_kernel<float>, kThreads, 0);
  if (dtype == 1)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, morton_matmul_kernel<__nv_bfloat16>, kThreads, 0);
  return cudaErrorInvalidValue;
}
