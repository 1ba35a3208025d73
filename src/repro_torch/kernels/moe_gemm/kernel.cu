// Grouped SwiGLU expert GEMM over an MoE capacity buffer, for Hopper.
//
// Replaces the Pallas kernel `moe_gemm_kernel`
// (src/repro/kernels/moe_gemm/kernel.py:55, pallas_call at :82).
//
// What it computes.  x (E, C, d) holds, for each expert e, the C capacity
// slots its dispatch filled; counts[e] of them (rows 0 .. counts[e] - 1)
// are live.  For every live row c of expert e:
//   h[c] = round(silu(x[c] . Wg[e]) * (x[c] . Wu[e]))   (fp32, rounded to T)
//   y[c] = round(h[c] . Wd[e])                          (fp32 sums)
// and every other row of y is 0.  T is float or bfloat16.  A count above
// C means all C rows are live (the dispatch counts dropped tokens too).
// The TPU kernel skips whole row tiles past the count and computes the
// rows of a partly live tile; here every row at or past the count is
// written 0, so the result equals the plain version (ref.py) whatever the
// buffer holds past the counts.
//
// Bound.  At granite-moe-1b-a400m's prefill (E 32, d 1,024, f 512, C
// 20,480, about 524,288 live rows) the work is 2 * 3 * d * f * rows = 1.65e12
// operations (1.67 ms at the bf16 tensor rate) against ~2.5 GB of bytes
// (live x rows, y, the weights; 0.75 ms at 3.35 TB/s): operations bound
// it.  At a decode step (32 tokens, C 10) it is reading the 100.7 MB of
// expert weights (0.030 ms at 3.35 TB/s): bytes bound it.
//
// Two phases in one entry point: phase 1 writes h (E, C, f) in T, which
// the result rounds to anyway (a 128-row tile of g and u in fp32 at f 512
// would be 512 KB, past shared memory), and phase 2 reads it back.  Each
// block reads counts[e] from device memory (the TPU kernel's scalar
// prefetch), so a call makes no host sync; a row tile at or past the
// count does no arithmetic: phase 1 returns, phase 2 writes its zeros.
// Column tiles spread a decode step (at most C = 10 rows an expert) over
// 128 blocks in each phase.  Two bodies:
//
// bf16: Hopper's tensor cores, the mainloop of morton_matmul's bf16 body.
// A bf16 x bf16 product is exact in fp32, so wgmma with fp32 accumulators
// computes the TPU kernel's HIGHEST-precision function.  A block of three
// warpgroups owns a 128-row tile of one expert: warpgroup 0 is the
// producer, one thread keeping a ring of 4 stages filled by TMA
// (128-byte swizzle, depth 64 a stage, completion on a `full` mbarrier);
// warpgroups 1 and 2 consume 64 rows each with wgmma m64nNk16 (A K-major,
// B row-major (K, N) in memory, read MN-major through the descriptor's
// transpose bit), keep one stage's products in flight and release the
// stage before on an `empty` mbarrier.  Phase 1: 128 columns of f a
// block, two accumulators (g and u, 64 + 64 fp32 a thread) from a stage of
// one x box and two boxes each of Wg and Wu; the epilogue stores
// round(silu(g) * u) for the live rows.  Phase 2: 256 columns of d a
// block (128 when d <= 128), A = h, B = Wd; rows at or past the count are
// stored as 0.  A consumer whose 64 rows are all past the count runs no
// wgmma (phase 2 stores its zeros).  The tensor maps are 3-D with the
// expert outermost, x (E, C, d), Wg and Wu (E, d, f), h (E, C, f) and Wd
// (E, f, d): TMA fills zeros only at a tensor's own edge, so a box at the
// ragged end of d, f or C reads no neighbouring expert's rows.  TMA needs
// 16-byte aligned bases and row strides, which d % 8 == f % 8 == 0 and
// 16-byte aligned tensors give: no operand is copied.  Rows of x and h in
// [count, C) hold whatever the buffer holds; they are multiplied (a
// product row depends only on its own row) and never stored.  A map is a
// pure function of (base, shape, box), so maps are cached on that key: a
// decode step's weights are encoded once.
//
// fp32 (TF32 would break the JAX test's 1e-4): fp32 FMAs on the CUDA
// cores, one block of 256 threads (16 x 16) per (column tile, 64-row tile,
// expert).  Phase 1: 64 rows x 64 columns of f, g and u accumulated side
// by side (4 x 4 of each per thread).  Phase 2: 64 rows x 128 columns of
// d (4 x 8 per thread).  The depth is taken 32 at a time: A transposed and
// B row-major in shared memory, read as 16-byte vectors (3 vector loads
// per 32 FMAs); the next stage's global loads are issued into registers
// before the current stage's products.  Rows past the count load as
// zeros.
//
// Offsets are 64-bit.  Shapes taken: d and f multiples of 8; all tensors
// contiguous and 16-byte aligned; E and the row tiles (C over 64 rows in
// fp32, 128 in bf16) up to 65,535.
//
// The backward (bf16 only; `moe_gemm_grad_launch`) replaces no TPU kernel:
// the JAX package differentiates einsums, and the port's fp32 route
// differentiates the plain version.  It computes the gradient of the
// function above for a cotangent dy with autograd's rounding points
// (ref.py, `moe_gemm_grad_ref`), over the live rows only:
//   dh = round(dy Wd^T); g, u recomputed in fp32; h = round(silu(g) u);
//   dg = dh u silu'(g), du = dh silu(g) (fp32);
//   dx = round(dg Wg^T + du Wu^T), 0 past the count;
//   dWg = round(x^T dg), dWu = round(x^T du), dWd = round(h^T dy).
// dg and du, the only fp32 operands, enter their products as bf16 hi + lo
// pairs (hi = round(v), lo = round(v - hi): ~16 bits of the mantissa).
// Bound: the gradient needs 8 products of 2 d f (live rows) operations
// (g and u recomputed, dh, dx's two, dWg, dWu, dWd); at granite's train-2k
// microbatch (131,072 live rows of E 32 x C 16,384) 1.10e12 operations,
// 1.11 ms at the bf16 tensor rate, against ~1.6 GB of bytes it must move
// (0.48 ms: the live rows of x and dy read, dx written whole).  The kernel
// runs 12 such products, the hi + lo split doubling the depth of dx's two
// and of dWg and dWu (3 in launch 1, 4 in launch 2, 2 + 2 + 1 in launch 3),
// and moves ~4.1 GB (x and dy read twice, the scratch written once and
// read twice).  Three launches on the forward's ring of TMA stages,
// producer warpgroup and two consumer warpgroups of 64 rows:
//   1. per (64 columns of f, 128-row tile, expert): g, u and dh in three
//      accumulators (K = d; A = x or dy K-major, B = Wg and Wu MN-major,
//      Wd K-major), whose epilogue writes h, dg hi, dg lo, du hi and du lo
//      into a (5, E, C, f) scratch for the live rows; a dead tile returns;
//   2. per (256 columns of d, 128-row tile, expert): dx over K = 4 f, the
//      four scratch planes against Wg, Wg, Wu, Wu (both K-major); a dead
//      tile writes its zeros;
//   3. per (128 x 256 tile of dWg, dWu or dWd, expert): the depth is the
//      expert's live rows, A = x or h and B = a scratch plane or dy, both
//      read MN-major through the descriptors' transpose bits; whole 64-row
//      tiles come by TMA, and the last, partial one is copied by the
//      consumers into a stage in TMA's swizzled layout with the rows past
//      the count as zeros (those rows of x, dy and the scratch hold
//      anything), then multiplied.
// No atomics: every output element is written by one block, so a call is
// deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <functional>
#include <mutex>
#include <unordered_map>

#include "_hopper.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kBM = 64;        // rows per block
constexpr int kBK = 32;        // depth per stage
constexpr int kBN1 = 64;       // phase 1: columns of f per block
constexpr int kBN2 = 128;      // phase 2: columns of d per block
constexpr int kLA = kBM + 4;   // row of the transposed A tile, 16-byte aligned

// 8 consecutive fp32 values
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 4 consecutive fp32 values
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ int live_rows(const int* counts, int e, int C) {
  return min(max(counts[e], 0), C);
}

// One stage of A: rows [0, kBM) x depth [k0, k0 + kBK) of a row-major
// (rows, K) matrix, rows at or past `rows` and depth past K as zeros;
// each thread holds 8 values (one 8-wide chunk of one row).
template <typename T>
struct ATile {
  float v[8];
  int m, kk;
  __device__ ATile() : m(threadIdx.x / (kBK / 8)), kk(threadIdx.x % (kBK / 8) * 8) {}
  __device__ void fetch(const T* __restrict__ a, int rows, int K, int k0) {
    if (m < rows && k0 + kk < K) {
      load8(a + (int64_t)m * K + k0 + kk, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
  }
  __device__ void put(float* As) const {  // transposed: As[k][m]
#pragma unroll
    for (int i = 0; i < 8; ++i) As[(kk + i) * kLA + m] = v[i];
  }
};
static_assert(kBM * kBK / 8 == kThreads, "one A chunk per thread");

// One stage of B: depth [k0, k0 + kBK) x columns [n0, n0 + BN) of a
// row-major (K, N) matrix, zeros past K or N; each thread holds BN / 64
// chunks of 8 values.
template <typename T, int BN>
struct BTile {
  static constexpr int kChunks = kBK * BN / 8 / kThreads;
  float v[kChunks][8];
  __device__ void fetch(const T* __restrict__ b, int K, int N, int k0, int n0) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      const int k = idx / (BN / 8), n = idx % (BN / 8) * 8;
      if (k0 + k < K && n0 + n < N) {
        load8(b + (int64_t)(k0 + k) * N + n0 + n, v[c]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[c][i] = 0.f;
      }
    }
  }
  __device__ void put(float* Bs) const {  // row-major: Bs[k][n]
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      const int k = idx / (BN / 8), n = idx % (BN / 8) * 8;
      float* dst = Bs + k * BN + n;
      *reinterpret_cast<float4*>(dst) =
          make_float4(v[c][0], v[c][1], v[c][2], v[c][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(v[c][4], v[c][5], v[c][6], v[c][7]);
    }
  }
};

// Phase 1: h = round(silu(x Wg) * (x Wu)) for the live rows of one
// (64 columns of f, 64-row tile, expert) block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_gate_up_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                       const T* __restrict__ wu, const int* __restrict__ counts,
                       T* __restrict__ h, int C, int d, int f) {
  __shared__ __align__(16) float As[kBK * kLA];
  __shared__ __align__(16) float Gs[kBK * kBN1];
  __shared__ __align__(16) float Us[kBK * kBN1];
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN1;
  const int rows = live_rows(counts, e, C) - m0;
  if (rows <= 0) return;  // a dead tile: phase 2 writes its zeros
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* xa = x + ((int64_t)e * C + m0) * d;
  const T* g_w = wg + (int64_t)e * d * f;
  const T* u_w = wu + (int64_t)e * d * f;

  float4 ag[4], au[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    ag[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    au[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  ATile<T> a;
  BTile<T, kBN1> bg, bu;
  a.fetch(xa, rows, d, 0);
  bg.fetch(g_w, d, f, 0, n0);
  bu.fetch(u_w, d, f, 0, n0);
  for (int k0 = 0; k0 < d; k0 += kBK) {
    __syncthreads();  // the previous stage's products are done
    a.put(As);
    bg.put(Gs);
    bu.put(Us);
    __syncthreads();
    if (k0 + kBK < d) {  // the next stage's loads fly during the products
      a.fetch(xa, rows, d, k0 + kBK);
      bg.fetch(g_w, d, f, k0 + kBK, n0);
      bu.fetch(u_w, d, f, k0 + kBK, n0);
    }
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float4 av = ld4(As + k * kLA + ty * 4);
      const float4 gv = ld4(Gs + k * kBN1 + tx * 4);
      const float4 uv = ld4(Us + k * kBN1 + tx * 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float w = comp(av, r);
        ag[r].x += w * gv.x; ag[r].y += w * gv.y;
        ag[r].z += w * gv.z; ag[r].w += w * gv.w;
        au[r].x += w * uv.x; au[r].y += w * uv.y;
        au[r].z += w * uv.z; au[r].w += w * uv.w;
      }
    }
  }
  const int n = n0 + tx * 4;
  if (n >= f) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = ty * 4 + r;
    if (m >= rows) continue;
    const float4 g = ag[r], u = au[r];
    const float4 hv = make_float4(g.x / (1.f + expf(-g.x)) * u.x,
                                  g.y / (1.f + expf(-g.y)) * u.y,
                                  g.z / (1.f + expf(-g.z)) * u.z,
                                  g.w / (1.f + expf(-g.w)) * u.w);
    store4(h + ((int64_t)e * C + m0 + m) * f + n, hv);
  }
}

// Phase 2: y = h Wd for one (128 columns of d, 64-row tile, expert)
// block; rows at or past the count are written 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_down_kernel(const T* __restrict__ h, const T* __restrict__ wd,
                    const int* __restrict__ counts, T* __restrict__ y, int C,
                    int d, int f) {
  __shared__ __align__(16) float As[kBK * kLA];
  __shared__ __align__(16) float Bs[kBK * kBN2];
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN2;
  const int rows = live_rows(counts, e, C) - m0;  // may be <= 0
  const int tile_rows = min(kBM, C - m0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  T* yb = y + ((int64_t)e * C + m0) * d;

  float4 acc[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int g = 0; g < 2; ++g) acc[r][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (rows > 0) {
    const T* ha = h + ((int64_t)e * C + m0) * f;
    const T* w = wd + (int64_t)e * f * d;
    ATile<T> a;
    BTile<T, kBN2> b;
    a.fetch(ha, rows, f, 0);
    b.fetch(w, f, d, 0, n0);
    for (int k0 = 0; k0 < f; k0 += kBK) {
      __syncthreads();
      a.put(As);
      b.put(Bs);
      __syncthreads();
      if (k0 + kBK < f) {
        a.fetch(ha, rows, f, k0 + kBK);
        b.fetch(w, f, d, k0 + kBK, n0);
      }
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        const float4 av = ld4(As + k * kLA + ty * 4);
        const float4 b0 = ld4(Bs + k * kBN2 + tx * 4);
        const float4 b1 = ld4(Bs + k * kBN2 + 64 + tx * 4);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = comp(av, r);
          acc[r][0].x += v * b0.x; acc[r][0].y += v * b0.y;
          acc[r][0].z += v * b0.z; acc[r][0].w += v * b0.w;
          acc[r][1].x += v * b1.x; acc[r][1].y += v * b1.y;
          acc[r][1].z += v * b1.z; acc[r][1].w += v * b1.w;
        }
      }
    }
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = ty * 4 + r;
    if (m >= tile_rows) continue;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int n = n0 + tx * 4 + 64 * g;
      if (n < d) store4(yb + (int64_t)m * d + n, m < rows ? acc[r][g] : zero);
    }
  }
}


cudaError_t launch_fma(const float* x, const float* wg, const float* wu, const float* wd,
                       const int* counts, float* h, float* y, int E, int C, int d, int f,
                       cudaStream_t stream) {
  const int row_tiles = (C + kBM - 1) / kBM;
  moe_gate_up_kernel<float><<<dim3((f + kBN1 - 1) / kBN1, row_tiles, E), kThreads, 0,
                              stream>>>(x, wg, wu, counts, h, C, d, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_down_kernel<float><<<dim3((d + kBN2 - 1) / kBN2, row_tiles, E), kThreads, 0,
                           stream>>>(h, wd, counts, y, C, d, f);
  return cudaGetLastError();
}

// ------------------------------------------------------ bf16: tensor cores

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBM = 128;               // row tile: two consumer warpgroups of 64
constexpr int kBK = 64;                // depth of a stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 3 * 128;      // producer warpgroup + two consumers
constexpr int kBox = 64;               // B box side (64 x 64 bf16, 8 KB)
constexpr int kBoxElems = kBox * kBK;
constexpr int kBN1 = 128;              // phase 1: columns of f a block (g and u each)

// A ring of kNum stages of kElems bf16 each, filled by TMA, with `full`
// and `empty` barriers; `consumers` warpgroups release each stage.
template <int kElems, int kNum = kStages>
struct Ring {
  static constexpr uint32_t kBytes = kElems * sizeof(bf16);
  static constexpr size_t dynamic = kNum * (size_t)kBytes + 2 * kNum * sizeof(uint64_t) + 1024;
  bf16* base;
  uint64_t *full, *empty;
  __device__ Ring(uint8_t* raw, int consumers) {
    // swizzle atoms must start 1024-byte aligned (descriptor base offset 0)
    uint8_t* p = raw + ((1024 - (hopper::smem_addr(raw) & 1023)) & 1023);
    base = reinterpret_cast<bf16*>(p);
    full = reinterpret_cast<uint64_t*>(p + kNum * (size_t)kBytes);
    empty = full + kNum;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kNum; ++s) {
        hopper::mbar_init(&full[s], 1);
        hopper::mbar_init(&empty[s], consumers);
      }
      hopper::mbar_fence_init();
    }
    __syncthreads();
  }
  __device__ bf16* stage(int it) const { return base + (it % kNum) * kElems; }
  // producer: waits for step `it`'s stage to be free, expects a full stage
  // of TMA bytes on its `full` barrier and returns that barrier
  __device__ uint64_t* fill(int it) const {
    const int s = it % kNum;
    hopper::mbar_wait(&empty[s], ((it / kNum) & 1) ^ 1);
    hopper::mbar_arrive_expect_tx(&full[s], kBytes);
    return &full[s];
  }
  // consumers: step `it`'s stage once its bytes have landed
  __device__ const bf16* wait(int it) const {
    hopper::mbar_wait(&full[it % kNum], (it / kNum) & 1);
    return stage(it);
  }
  // consumers, after issuing step `it`'s products: keep them in flight and
  // release the stage of the step before, whose products are then done
  __device__ void issued(int it, int t) const {
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    if (it > 0 && t == 0) hopper::mbar_arrive(&empty[(it - 1) % kNum]);
  }
};

// a stage of one 128 x 64 box of A (or two 64 x 64) and NB 64 x 64 boxes of B
template <int NB>
using BoxRing = Ring<kBM * kBK + NB * kBoxElems>;

// A K-major tile: rows of 64 depth values (128 bytes, swizzled) from
// `rows` on, 8-row groups 1024 bytes apart; depth step kk is 32 bytes
__device__ __forceinline__ uint64_t desc_k(const bf16* rows, int kk) {
  return hopper::sw128_desc(rows + kk * 16, 16, 1024);
}
// An MN-major tile: boxes of kBK depth rows x 64 columns from `box` on,
// 8 KB apart; depth step kk is 16 rows (2048 bytes)
__device__ __forceinline__ uint64_t desc_mn(const bf16* box, int kk) {
  return hopper::sw128_desc(box + kk * 16 * kBox, kBoxElems * 2, 1024);
}

template <int N>
__device__ __forceinline__ void zero_acc(float* acc) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i] = 0.f;
    hopper::fence_operand(acc[i]);
  }
}
template <int N>
__device__ __forceinline__ void fence_acc(float* acc) {
#pragma unroll
  for (int i = 0; i < N; ++i) hopper::fence_operand(acc[i]);
}

// y[r][c0, c1) = 0 for rows [r0, r1) of expert e, by all threads in 16-byte stores
__device__ void zero_rows(bf16* y, int64_t row_base, int d, int r0, int r1, int c0, int c1) {
  const int chunks = (c1 - c0) / 8;
  for (int i = threadIdx.x; i < (r1 - r0) * chunks; i += blockDim.x) {
    const int r = r0 + i / chunks, c = c0 + i % chunks * 8;
    *reinterpret_cast<uint4*>(y + (row_base + r) * d + c) = make_uint4(0, 0, 0, 0);
  }
}

// Phase 1: h = round(silu(x Wg) * (x Wu)) for the live rows of one
// (128 columns of f, 128-row tile, expert) block.
__global__ void __launch_bounds__(kThreads, 1)
    moe_gate_up_tc(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap gmap,
                   const __grid_constant__ CUtensorMap umap, const int* __restrict__ counts,
                   bf16* __restrict__ h, int C, int d, int f) {
  constexpr int NB = 2 * kBN1 / kBox;  // boxes of Wg, then of Wu
  constexpr int B = kBM * kBK;
  extern __shared__ uint8_t smem_raw[];
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN1;
  const int live = live_rows(counts, e, C);
  if (m0 >= live) return;  // a dead tile: phase 2 writes its zeros
  const int consumers = live - m0 > 64 ? 2 : 1;
  const BoxRing<NB> ring(smem_raw, consumers);
  const int nk = (d + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // producer: one thread issues every load
    hopper::producer_regs();
    if (threadIdx.x == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        uint64_t* bar = ring.fill(kb);
        bf16* st = ring.stage(kb);
        hopper::tma_load_3d(st, &xmap, bar, kb * kBK, m0, e);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          hopper::tma_load_3d(st + B + c * kBoxElems, c < NB / 2 ? &gmap : &umap, bar,
                              n0 + c % (NB / 2) * kBox, kb * kBK, e);
      }
    }
    return;
  }
  hopper::consumer_regs();
  const int cw = wg - 1;  // rows [64 cw, 64 cw + 64) of the tile
  if (cw >= consumers) return;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  float g[kBN1 / 2], u[kBN1 / 2];
  zero_acc<kBN1 / 2>(g);
  zero_acc<kBN1 / 2>(u);
  for (int kb = 0; kb < nk; ++kb) {
    const bf16* st = ring.wait(kb);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = desc_k(st + cw * 64 * kBK, kk);
      hopper::wgmma_128(g, da, desc_mn(st + B, kk));
      hopper::wgmma_128(u, da, desc_mn(st + B + NB / 2 * kBoxElems, kk));
    }
    ring.issued(kb, t);  // the stage before this one is read
  }
  hopper::wgmma_wait<0>();
  fence_acc<kBN1 / 2>(g);
  fence_acc<kBN1 / 2>(u);

  // epilogue: acc[4 j + 2 hh + q] is row warp * 16 + lane / 4 + 8 hh,
  // column 8 j + 2 (lane % 4) + q of this warpgroup's 64 x 128
  const int r0 = m0 + cw * 64 + warp * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= live) continue;
    bf16* hrow = h + ((int64_t)e * C + r) * f;
#pragma unroll
    for (int j = 0; j < kBN1 / 8; ++j) {
      const int c = c0 + 8 * j;  // even, and f is a multiple of 8
      if (c >= f) continue;
      const int i = 4 * j + 2 * hh;
      const float h0 = g[i] / (1.f + expf(-g[i])) * u[i];
      const float h1 = g[i + 1] / (1.f + expf(-g[i + 1])) * u[i + 1];
      *reinterpret_cast<__nv_bfloat162*>(hrow + c) = __floats2bfloat162_rn(h0, h1);
    }
  }
}

// Phase 2: y = h Wd for one (BN columns of d, 128-row tile, expert)
// block; rows at or past the count are written 0.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    moe_down_tc(const __grid_constant__ CUtensorMap hmap,
                const __grid_constant__ CUtensorMap wmap, const int* __restrict__ counts,
                bf16* __restrict__ y, int C, int d, int f) {
  constexpr int NB = BN / kBox;
  constexpr int B = kBM * kBK;
  extern __shared__ uint8_t smem_raw[];
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int live = live_rows(counts, e, C);
  const int tile_end = min(m0 + kBM, C), col_end = min(n0 + BN, d);
  const int64_t row_base = (int64_t)e * C;
  if (m0 >= live) {  // a dead tile: zeros only
    zero_rows(y, row_base, d, m0, tile_end, n0, col_end);
    return;
  }
  const int consumers = live - m0 > 64 ? 2 : 1;
  const BoxRing<NB> ring(smem_raw, consumers);
  const int nk = (f + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    hopper::producer_regs();
    if (threadIdx.x == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        uint64_t* bar = ring.fill(kb);
        bf16* st = ring.stage(kb);
        hopper::tma_load_3d(st, &hmap, bar, kb * kBK, m0, e);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          hopper::tma_load_3d(st + B + c * kBoxElems, &wmap, bar, n0 + c * kBox, kb * kBK, e);
      }
    }
    return;
  }
  hopper::consumer_regs();
  const int cw = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  if (cw >= consumers) {  // its 64 rows are all past the count
    const int r0 = min(m0 + 64, tile_end);
    for (int i = t; i < (tile_end - r0) * (col_end - n0) / 8; i += 128) {
      const int r = r0 + i / ((col_end - n0) / 8), c = n0 + i % ((col_end - n0) / 8) * 8;
      *reinterpret_cast<uint4*>(y + (row_base + r) * d + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  float acc[BN / 2];
  zero_acc<BN / 2>(acc);
  for (int kb = 0; kb < nk; ++kb) {
    const bf16* st = ring.wait(kb);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      hopper::wgmma_bn<BN>(acc, desc_k(st + cw * 64 * kBK, kk), desc_mn(st + B, kk));
    ring.issued(kb, t);
  }
  hopper::wgmma_wait<0>();
  fence_acc<BN / 2>(acc);

  const int r0 = m0 + cw * 64 + warp * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= tile_end) continue;
    const bool on = r < live;
    bf16* yrow = y + (row_base + r) * d;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c0 + 8 * j;
      if (c >= col_end) continue;
      const int i = 4 * j + 2 * hh;
      *reinterpret_cast<__nv_bfloat162*>(yrow + c) =
          __floats2bfloat162_rn(on ? acc[i] : 0.f, on ? acc[i + 1] : 0.f);
    }
  }
}

// The tensor map of a (E, rows, cols) bf16 tensor, contiguous, in boxes of
// box_rows x 64 x 1 with 128-byte swizzle; zeros past its edges.  A map is
// a pure function of (base, shape, box), so maps are cached on that key (a
// decode step's 72 weight maps are encoded once); the cache is emptied
// when it reaches kMaxMaps.
struct MapKey {
  const void* base;
  int64_t E, rows, cols, box_rows;
  bool operator==(const MapKey& o) const {
    return base == o.base && E == o.E && rows == o.rows && cols == o.cols &&
           box_rows == o.box_rows;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    return std::hash<const void*>()(k.base) ^
           std::hash<int64_t>()(((k.E * 31 + k.rows) * 31 + k.cols) * 31 + k.box_rows);
  }
};

bool make_map(CUtensorMap* map, const MapKey& k) {
  constexpr size_t kMaxMaps = 4096;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  static std::mutex guard;
  std::lock_guard<std::mutex> lock(guard);
  const auto hit = cache.find(k);
  if (hit != cache.end()) {
    *map = hit->second;
    return true;
  }
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)k.cols, (cuuint64_t)k.rows, (cuuint64_t)k.E};
  const cuuint64_t strides[2] = {(cuuint64_t)k.cols * sizeof(bf16),
                                 (cuuint64_t)(k.rows * k.cols) * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)k.box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(k.base), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= kMaxMaps) cache.clear();
  cache.emplace(k, *map);
  return true;
}

// lets `kernel` take `bytes` of dynamic shared memory (callers keep the
// result in a function-local static: set once, thread-safe)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int BN>
cudaError_t launch_down(const CUtensorMap& hmap, const CUtensorMap& wmap, const int* counts,
                        bf16* y, int E, int C, int d, int f, cudaStream_t stream) {
  using R = BoxRing<BN / kBox>;
  static const cudaError_t allowed = allow_smem(moe_down_tc<BN>, R::dynamic);
  if (allowed != cudaSuccess) return allowed;
  moe_down_tc<BN><<<dim3((d + BN - 1) / BN, (C + kBM - 1) / kBM, E), kThreads, R::dynamic,
                    stream>>>(hmap, wmap, counts, y, C, d, f);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const void* wg, const void* wu, const void* wd,
                   const int* counts, void* h, void* y, int E, int C, int d, int f,
                   cudaStream_t stream) {
  CUtensorMap xmap, gmap, umap, hmap, wmap;
  if (!make_map(&xmap, {x, E, C, d, kBM}) || !make_map(&gmap, {wg, E, d, f, kBK}) ||
      !make_map(&umap, {wu, E, d, f, kBK}) || !make_map(&hmap, {h, E, C, f, kBM}) ||
      !make_map(&wmap, {wd, E, f, d, kBK}))
    return cudaErrorInvalidValue;
  using R1 = BoxRing<2 * kBN1 / kBox>;
  static const cudaError_t allowed = allow_smem(moe_gate_up_tc, R1::dynamic);
  if (allowed != cudaSuccess) return allowed;
  moe_gate_up_tc<<<dim3((f + kBN1 - 1) / kBN1, (C + kBM - 1) / kBM, E), kThreads,
                   R1::dynamic, stream>>>(xmap, gmap, umap, counts, static_cast<bf16*>(h), C,
                                          d, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (d > 128)
    return launch_down<256>(hmap, wmap, counts, static_cast<bf16*>(y), E, C, d, f, stream);
  return launch_down<128>(hmap, wmap, counts, static_cast<bf16*>(y), E, C, d, f, stream);
}

}  // namespace tc

// -------------------------------------------------- bf16 backward: tensor cores

namespace grad {

using tc::bf16;
using tc::BoxRing;
using tc::desc_k;
using tc::desc_mn;
using tc::kBK;
using tc::kBM;
using tc::kBoxElems;
using tc::kThreads;
constexpr int kHidN = 64;  // columns of f a hidden block (g, u and dh each)

// Launch 1: for the live rows of one (64 columns of f, 128-row tile,
// expert) block, g = x Wg, u = x Wu and dh = dy Wd^T in fp32, then
//   h = round(silu(g) u), dh = round(dh), dg = dh u silu'(g), du = dh silu(g)
// into the scratch planes (h, dg hi, dg lo, du hi, du lo), each (E, C, f).
// Stage: x and dy boxes of 128 rows x 64 of d, Wg and Wu boxes of 64 of d
// x 64 of f (MN-major B), a Wd box of 64 of f x 64 of d (K-major B).
constexpr int kHidStage = 2 * kBM * kBK + 3 * kBoxElems;
using HidRing = tc::Ring<kHidStage>;

__global__ void __launch_bounds__(kThreads, 1)
    moe_grad_hidden_tc(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap dymap,
                       const __grid_constant__ CUtensorMap gmap,
                       const __grid_constant__ CUtensorMap umap,
                       const __grid_constant__ CUtensorMap dmap,
                       const int* __restrict__ counts, bf16* __restrict__ s, int E, int C,
                       int d, int f) {
  constexpr int X = 0, DY = kBM * kBK, G = 2 * kBM * kBK, U = G + kBoxElems,
                D = U + kBoxElems;
  extern __shared__ uint8_t smem_raw[];
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kHidN;
  const int live = live_rows(counts, e, C);
  if (m0 >= live) return;  // a dead tile: nothing of it is read again
  const int consumers = live - m0 > 64 ? 2 : 1;
  const HidRing ring(smem_raw, consumers);
  const int nk = (d + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::producer_regs();
    if (threadIdx.x == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        uint64_t* bar = ring.fill(kb);
        bf16* st = ring.stage(kb);
        hopper::tma_load_3d(st + X, &xmap, bar, kb * kBK, m0, e);
        hopper::tma_load_3d(st + DY, &dymap, bar, kb * kBK, m0, e);
        hopper::tma_load_3d(st + G, &gmap, bar, n0, kb * kBK, e);
        hopper::tma_load_3d(st + U, &umap, bar, n0, kb * kBK, e);
        hopper::tma_load_3d(st + D, &dmap, bar, kb * kBK, n0, e);
      }
    }
    return;
  }
  hopper::consumer_regs();
  const int cw = wg - 1;
  if (cw >= consumers) return;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  float g[kHidN / 2], u[kHidN / 2], dh[kHidN / 2];
  tc::zero_acc<kHidN / 2>(g);
  tc::zero_acc<kHidN / 2>(u);
  tc::zero_acc<kHidN / 2>(dh);
  for (int kb = 0; kb < nk; ++kb) {
    const bf16* st = ring.wait(kb);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t ax = desc_k(st + X + cw * 64 * kBK, kk);
      hopper::wgmma_bn<kHidN, 0, 1>(g, ax, desc_mn(st + G, kk));
      hopper::wgmma_bn<kHidN, 0, 1>(u, ax, desc_mn(st + U, kk));
      const uint64_t ady = desc_k(st + DY + cw * 64 * kBK, kk);
      hopper::wgmma_bn<kHidN, 0, 0>(dh, ady, desc_k(st + D, kk));
    }
    ring.issued(kb, t);
  }
  hopper::wgmma_wait<0>();
  tc::fence_acc<kHidN / 2>(g);
  tc::fence_acc<kHidN / 2>(u);
  tc::fence_acc<kHidN / 2>(dh);

  // acc[4 j + 2 hh + q] is row warp * 16 + lane / 4 + 8 hh, column
  // 8 j + 2 (lane % 4) + q of this warpgroup's 64 x 64
  const int64_t plane = (int64_t)E * C * f;
  const int r0 = m0 + cw * 64 + warp * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= live) continue;
    bf16* row = s + ((int64_t)e * C + r) * f;
#pragma unroll
    for (int j = 0; j < kHidN / 8; ++j) {
      const int c = c0 + 8 * j;  // even, and f is a multiple of 8
      if (c >= f) continue;
      float out[5][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = 4 * j + 2 * hh + q;
        const float gi = g[i], sg = 1.f / (1.f + expf(-gi)), act = gi * sg;
        const float dhi = __bfloat162float(__float2bfloat16_rn(dh[i]));
        const float dgi = dhi * u[i] * sg * (1.f + gi * (1.f - sg));
        const float dui = dhi * act;
        const float dg_hi = __bfloat162float(__float2bfloat16_rn(dgi));
        const float du_hi = __bfloat162float(__float2bfloat16_rn(dui));
        out[0][q] = act * u[i];
        out[1][q] = dg_hi;
        out[2][q] = dgi - dg_hi;
        out[3][q] = du_hi;
        out[4][q] = dui - du_hi;
      }
#pragma unroll
      for (int p = 0; p < 5; ++p)
        *reinterpret_cast<__nv_bfloat162*>(row + p * plane + c) =
            __floats2bfloat162_rn(out[p][0], out[p][1]);
    }
  }
}

// Launch 2: dx = [dg hi, dg lo, du hi, du lo] [Wg, Wg, Wu, Wu]^T (depth 4 f)
// for one (BN columns of d, 128-row tile, expert) block, rounded once;
// rows at or past the count are written 0.  Stage: a scratch box of 128
// rows x 64 of f (A, K-major) and BN / 64 boxes of 64 of d x 64 of f of
// Wg or Wu (B, K-major).
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    moe_grad_input_tc(const __grid_constant__ CUtensorMap smap,
                      const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ CUtensorMap umap,
                      const int* __restrict__ counts, bf16* __restrict__ dx, int E, int C,
                      int d, int f) {
  constexpr int NB = BN / 64;
  constexpr int B = kBM * kBK;
  extern __shared__ uint8_t smem_raw[];
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int live = live_rows(counts, e, C);
  const int tile_end = min(m0 + kBM, C), col_end = min(n0 + BN, d);
  const int64_t row_base = (int64_t)e * C;
  if (m0 >= live) {  // a dead tile: zeros only
    tc::zero_rows(dx, row_base, d, m0, tile_end, n0, col_end);
    return;
  }
  const int consumers = live - m0 > 64 ? 2 : 1;
  const BoxRing<NB> ring(smem_raw, consumers);
  const int nkf = (f + kBK - 1) / kBK, nk = 4 * nkf;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::producer_regs();
    if (threadIdx.x == 0) {
      for (int it = 0; it < nk; ++it) {
        const int part = it / nkf, k0 = it % nkf * kBK;  // dg hi, dg lo, du hi, du lo
        uint64_t* bar = ring.fill(it);
        bf16* st = ring.stage(it);
        hopper::tma_load_3d(st, &smap, bar, k0, m0, (1 + part) * E + e);
        const CUtensorMap* w = part < 2 ? &gmap : &umap;
#pragma unroll
        for (int c = 0; c < NB; ++c)
          hopper::tma_load_3d(st + B + c * kBoxElems, w, bar, k0, n0 + c * 64, e);
      }
    }
    return;
  }
  hopper::consumer_regs();
  const int cw = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  if (cw >= consumers) {  // its 64 rows are all past the count
    const int r0 = min(m0 + 64, tile_end), chunks = (col_end - n0) / 8;
    for (int i = t; i < (tile_end - r0) * chunks; i += 128) {
      const int r = r0 + i / chunks, c = n0 + i % chunks * 8;
      *reinterpret_cast<uint4*>(dx + (row_base + r) * d + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  float acc[BN / 2];
  tc::zero_acc<BN / 2>(acc);
  for (int it = 0; it < nk; ++it) {
    const bf16* st = ring.wait(it);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      hopper::wgmma_bn<BN, 0, 0>(acc, desc_k(st + cw * 64 * kBK, kk), desc_k(st + B, kk));
    ring.issued(it, t);
  }
  hopper::wgmma_wait<0>();
  tc::fence_acc<BN / 2>(acc);

  const int r0 = m0 + cw * 64 + warp * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= tile_end) continue;
    const bool on = r < live;
    bf16* row = dx + (row_base + r) * d;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c0 + 8 * j;
      if (c >= col_end) continue;
      const int i = 4 * j + 2 * hh;
      *reinterpret_cast<__nv_bfloat162*>(row + c) =
          __floats2bfloat162_rn(on ? acc[i] : 0.f, on ? acc[i + 1] : 0.f);
    }
  }
}

// Launch 3: the weights' gradients, one (128 rows, BN columns) tile of
// dWg = x^T [dg hi; dg lo], dWu = x^T [du hi; du lo] or dWd = h^T dy
// (product 0, 1, 2) of one expert a block, its depth the expert's live
// rows: once through each of the product's parts (two, hi and lo, or one).
// Stage: two boxes of 64 rows x 64 columns of A's tensor (x or h, MN-major)
// and BN / 64 of B's (a scratch plane or dy, MN-major).  TMA brings the
// whole 64-row tiles; the last, partial tile of each part is copied by
// the consumers with the rows at or past the count as zeros (TMA fills
// zeros only at C, and those rows of x, dy and the scratch hold anything).
// one operand of a part: the tensor map and, for the partial tile, the
// same tensor's base, its plane z in a (planes, C, cols) view and cols
struct Operand {
  const CUtensorMap* map;
  const bf16* base;
  int z, cols;
};

// The partial tile's box at (col0, rows [row0, row0 + 64)) of `o` into
// `box` as TMA lays it out (128-byte swizzle: 16-byte chunk ch of row r at
// chunk ch ^ (r % 8)); rows at or past `live` and columns past cols as 0.
// By the 256 consumer threads, `i0` the thread's index among them.
__device__ void copy_box(bf16* box, const Operand& o, int C, int live, int row0, int col0,
                         int i0) {
  for (int i = i0; i < 64 * 8; i += 256) {
    const int r = i / 8, ch = i % 8, row = row0 + r, col = col0 + ch * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < live && col < o.cols)
      v = *reinterpret_cast<const uint4*>(o.base + ((int64_t)o.z * C + row) * o.cols + col);
    *reinterpret_cast<uint4*>(box + r * 64 + ((ch ^ (r & 7)) * 8)) = v;
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    moe_grad_weights_tc(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap dymap,
                        const __grid_constant__ CUtensorMap smap, const bf16* __restrict__ x,
                        const bf16* __restrict__ dy, const bf16* __restrict__ s,
                        const int* __restrict__ counts, bf16* __restrict__ dwg,
                        bf16* __restrict__ dwu, bf16* __restrict__ dwd, int E, int C, int d,
                        int f) {
  constexpr int NB = BN / 64;
  constexpr int B = 2 * kBoxElems;
  extern __shared__ uint8_t smem_raw[];
  const int e = blockIdx.y;
  // the tile: products 0 and 1 (d x f) first, their depth twice product 2's
  const int gu_tiles = (d + kBM - 1) / kBM * ((f + BN - 1) / BN);
  const int tile = blockIdx.x, prod = min(tile / gu_tiles, 2);
  const int local = tile - prod * gu_tiles;
  const int M = prod < 2 ? d : f, N = prod < 2 ? f : d;
  const int m0 = local / ((N + BN - 1) / BN) * kBM, n0 = local % ((N + BN - 1) / BN) * BN;
  const int parts = prod < 2 ? 2 : 1;
  Operand a[2], b[2];
  for (int p = 0; p < parts; ++p) {
    a[p] = prod < 2 ? Operand{&xmap, x, e, d} : Operand{&smap, s, e, f};
    b[p] = prod < 2 ? Operand{&smap, s, (1 + 2 * prod + p) * E + e, f}
                    : Operand{&dymap, dy, e, d};
  }
  const int live = live_rows(counts, e, C);
  const int whole = live / kBK, rem = live % kBK, nk = parts * whole;
  const BoxRing<NB> ring(smem_raw, 2);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::producer_regs();
    if (threadIdx.x == 0) {
      for (int it = 0; it < nk; ++it) {
        const int p = it / whole, k0 = it % whole * kBK;
        uint64_t* bar = ring.fill(it);
        bf16* st = ring.stage(it);
#pragma unroll
        for (int c = 0; c < 2; ++c)
          hopper::tma_load_3d(st + c * kBoxElems, a[p].map, bar, m0 + c * 64, k0, a[p].z);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          hopper::tma_load_3d(st + B + c * kBoxElems, b[p].map, bar, n0 + c * 64, k0, b[p].z);
      }
    }
    return;
  }
  hopper::consumer_regs();
  const int cw = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  float acc[BN / 2];
  tc::zero_acc<BN / 2>(acc);
  for (int it = 0; it < nk; ++it) {
    const bf16* st = ring.wait(it);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      hopper::wgmma_bn<BN, 1, 1>(acc, desc_mn(st + cw * kBoxElems, kk), desc_mn(st + B, kk));
    ring.issued(it, t);
  }
  hopper::wgmma_wait<0>();
  if (rem > 0) {  // the partial tile of each part, through ring stage 0
    bf16* st = ring.base;
    for (int p = 0; p < parts; ++p) {
      consumers_sync();  // both consumers' products out of stage 0 are done
      const int i0 = threadIdx.x - 128;
      for (int c = 0; c < 2; ++c)
        copy_box(st + c * kBoxElems, a[p], C, live, whole * kBK, m0 + c * 64, i0);
      for (int c = 0; c < NB; ++c)
        copy_box(st + B + c * kBoxElems, b[p], C, live, whole * kBK, n0 + c * 64, i0);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // seen by wgmma
      consumers_sync();
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        hopper::wgmma_bn<BN, 1, 1>(acc, desc_mn(st + cw * kBoxElems, kk), desc_mn(st + B, kk));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
    }
  }
  tc::fence_acc<BN / 2>(acc);

  // acc[4 j + 2 hh + q] is row warp * 16 + lane / 4 + 8 hh, column
  // 8 j + 2 (lane % 4) + q of this warpgroup's 64 x BN
  bf16* out = (prod == 0 ? dwg : prod == 1 ? dwu : dwd) + (int64_t)e * M * N;
  const int r0 = m0 + cw * 64 + warp * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c0 + 8 * j;
      if (c >= N) continue;
      const int i = 4 * j + 2 * hh;
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)r * N + c) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

template <int BN>
cudaError_t launch_input(const CUtensorMap& smap, const CUtensorMap& gmap,
                         const CUtensorMap& umap, const int* counts, bf16* dx, int E, int C,
                         int d, int f, cudaStream_t stream) {
  using R = BoxRing<BN / 64>;
  static const cudaError_t allowed = tc::allow_smem(moe_grad_input_tc<BN>, R::dynamic);
  if (allowed != cudaSuccess) return allowed;
  moe_grad_input_tc<BN><<<dim3((d + BN - 1) / BN, (C + kBM - 1) / kBM, E), kThreads,
                          R::dynamic, stream>>>(smap, gmap, umap, counts, dx, E, C, d, f);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_weights(const CUtensorMap& xmap, const CUtensorMap& dymap,
                           const CUtensorMap& smap, const bf16* x, const bf16* dy,
                           const bf16* s, const int* counts, bf16* dwg, bf16* dwu, bf16* dwd,
                           int E, int C, int d, int f, cudaStream_t stream) {
  using R = BoxRing<BN / 64>;
  static const cudaError_t allowed = tc::allow_smem(moe_grad_weights_tc<BN>, R::dynamic);
  if (allowed != cudaSuccess) return allowed;
  const int tiles = 2 * ((d + kBM - 1) / kBM) * ((f + BN - 1) / BN) +
                    (f + kBM - 1) / kBM * ((d + BN - 1) / BN);
  moe_grad_weights_tc<BN><<<dim3(tiles, E), kThreads, R::dynamic, stream>>>(
      xmap, dymap, smap, x, dy, s, counts, dwg, dwu, dwd, E, C, d, f);
  return cudaGetLastError();
}

cudaError_t launch(const bf16* x, const bf16* wg, const bf16* wu, const bf16* wd,
                   const int* counts, const bf16* dy, bf16* s, bf16* dx, bf16* dwg, bf16* dwu,
                   bf16* dwd, int E, int C, int d, int f, cudaStream_t stream) {
  CUtensorMap x128, dy128, gmap, umap, dmap, s128, x64, dy64, s64;
  if (!tc::make_map(&x128, {x, E, C, d, kBM}) || !tc::make_map(&dy128, {dy, E, C, d, kBM}) ||
      !tc::make_map(&gmap, {wg, E, d, f, kBK}) || !tc::make_map(&umap, {wu, E, d, f, kBK}) ||
      !tc::make_map(&dmap, {wd, E, f, d, kBK}) ||
      !tc::make_map(&s128, {s, 5 * (int64_t)E, C, f, kBM}) ||
      !tc::make_map(&x64, {x, E, C, d, kBK}) || !tc::make_map(&dy64, {dy, E, C, d, kBK}) ||
      !tc::make_map(&s64, {s, 5 * (int64_t)E, C, f, kBK}))
    return cudaErrorInvalidValue;
  static const cudaError_t allowed = tc::allow_smem(moe_grad_hidden_tc, HidRing::dynamic);
  if (allowed != cudaSuccess) return allowed;
  moe_grad_hidden_tc<<<dim3((f + kHidN - 1) / kHidN, (C + kBM - 1) / kBM, E), kThreads,
                       HidRing::dynamic, stream>>>(x128, dy128, gmap, umap, dmap, counts, s,
                                                   E, C, d, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = d > 128 ? launch_input<256>(s128, gmap, umap, counts, dx, E, C, d, f, stream)
                : launch_input<128>(s128, gmap, umap, counts, dx, E, C, d, f, stream);
  if (err != cudaSuccess) return err;
  if (d > 128 && f > 128)
    return launch_weights<256>(x64, dy64, s64, x, dy, s, counts, dwg, dwu, dwd, E, C, d, f,
                               stream);
  return launch_weights<128>(x64, dy64, s64, x, dy, s, counts, dwg, dwu, dwd, E, C, d, f,
                             stream);
}

}  // namespace grad

}  // namespace

// C entry point (bound with ctypes).  x (E, C, d), w_gate and w_up
// (E, d, f), w_down (E, f, d), the scratch h (E, C, f) and the output y
// (E, C, d), all contiguous and 16-byte aligned in the dtype given (0 =
// float32: the FMA body, 1 = bfloat16: the tensor-core body); counts (E,)
// int32 on the device.  Returns the cudaError_t of the launches (0 on
// success); cudaErrorInvalidValue (1) for a shape the kernel does not take.
extern "C" int moe_gemm_launch(const void* x, const void* w_gate,
                               const void* w_up, const void* w_down,
                               const void* counts, void* h, void* y,
                               int64_t E, int64_t C, int64_t d, int64_t f,
                               int64_t dtype, void* stream) {
  const int64_t rows = dtype == 1 ? tc::kBM : kBM;  // the body's row tile
  if (E < 1 || E > 65535 || C < 1 || (C + rows - 1) / rows > 65535 || d < 8 ||
      d % 8 || f < 8 || f % 8 || d > (1 << 30) || f > (1 << 30))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(counts);
  if (dtype == 0)
    return launch_fma(static_cast<const float*>(x), static_cast<const float*>(w_gate),
                      static_cast<const float*>(w_up), static_cast<const float*>(w_down), c,
                      static_cast<float*>(h), static_cast<float*>(y), (int)E, (int)C,
                      (int)d, (int)f, s);
  if (dtype == 1)
    return tc::launch(x, w_gate, w_up, w_down, c, h, y, (int)E, (int)C, (int)d, (int)f, s);
  return cudaErrorInvalidValue;
}

// C entry point of the backward (bound with ctypes), bf16 only: x and dy
// (E, C, d), w_gate and w_up (E, d, f), w_down (E, f, d), counts (E,) int32
// on the device, the scratch (5, E, C, f) and the outputs dx (E, C, d),
// dw_gate, dw_up (E, d, f) and dw_down (E, f, d), all contiguous and
// 16-byte aligned.  Three launches on `stream`, in order.  Returns the
// cudaError_t of the launches (0 on success); cudaErrorInvalidValue (1)
// for a shape the kernel does not take.
extern "C" int moe_gemm_grad_launch(const void* x, const void* w_gate, const void* w_up,
                                    const void* w_down, const void* counts, const void* dy,
                                    void* scratch, void* dx, void* dw_gate, void* dw_up,
                                    void* dw_down, int64_t E, int64_t C, int64_t d, int64_t f,
                                    void* stream) {
  if (E < 1 || E > 65535 || C < 1 || (C + grad::kBM - 1) / grad::kBM > 65535 || d < 8 ||
      d % 8 || f < 8 || f % 8 || d > (1 << 30) || f > (1 << 30))
    return cudaErrorInvalidValue;
  using grad::bf16;
  return grad::launch(static_cast<const bf16*>(x), static_cast<const bf16*>(w_gate),
                      static_cast<const bf16*>(w_up), static_cast<const bf16*>(w_down),
                      static_cast<const int*>(counts), static_cast<const bf16*>(dy),
                      static_cast<bf16*>(scratch), static_cast<bf16*>(dx),
                      static_cast<bf16*>(dw_gate), static_cast<bf16*>(dw_up),
                      static_cast<bf16*>(dw_down), (int)E, (int)C, (int)d, (int)f,
                      static_cast<cudaStream_t>(stream));
}

// The tiles of the two phases for the dtype given and a width d: out[0]
// the body (0 FMA, 1 tensor cores), out[1..2] phase 1's rows and columns
// a block, out[3..4] phase 2's.  Returns cudaErrorInvalidValue for another
// dtype.
extern "C" int moe_gemm_tiles(int64_t dtype, int64_t d, int64_t* out) {
  if (dtype == 0) {
    const int64_t t[5] = {0, kBM, kBN1, kBM, kBN2};
    for (int i = 0; i < 5; ++i) out[i] = t[i];
    return cudaSuccess;
  }
  if (dtype == 1) {
    const int64_t t[5] = {1, tc::kBM, tc::kBN1, tc::kBM, d > 128 ? 256 : 128};
    for (int i = 0; i < 5; ++i) out[i] = t[i];
    return cudaSuccess;
  }
  return cudaErrorInvalidValue;
}
