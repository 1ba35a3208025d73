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
constexpr int kBM = 128;           // row tile: two consumer warpgroups of 64
constexpr int kBK = 64;            // depth of a stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 3 * 128;  // producer warpgroup + two consumers
constexpr int kBox = 64;           // B box side (64 x 64 bf16, 8 KB)
constexpr int kBN1 = 128;          // phase 1: columns of f a block (g and u each)

// a stage: one 128 x 64 box of A and NB boxes of 64 x 64 of B
template <int NB>
struct Smem {
  static constexpr int kA = kBM * kBK;
  static constexpr int kB = NB * kBox * kBK;
  static constexpr size_t bytes = kStages * (kA + kB) * sizeof(bf16) +
                                  2 * kStages * sizeof(uint64_t);
  static constexpr size_t dynamic = bytes + 1024;  // room to align to 1024
};

// The ring of one block: stages, `full` and `empty` barriers.  `consumers`
// is how many consumer warpgroups release each stage.
template <int NB>
struct Ring {
  bf16 *a, *b;
  uint64_t *full, *empty;
  __device__ Ring(uint8_t* raw, int consumers) {
    // swizzle atoms must start 1024-byte aligned (descriptor base offset 0)
    uint8_t* base = raw + ((1024 - (hopper::smem_addr(raw) & 1023)) & 1023);
    a = reinterpret_cast<bf16*>(base);
    b = a + kStages * Smem<NB>::kA;
    full = reinterpret_cast<uint64_t*>(b + kStages * Smem<NB>::kB);
    empty = full + kStages;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        hopper::mbar_init(&full[s], 1);
        hopper::mbar_init(&empty[s], consumers);
      }
      hopper::mbar_fence_init();
    }
    __syncthreads();
  }
  // producer: stage `it` of A at (k0, row0, e) and of B at columns
  // (cols[c], k0, e) of maps[c], one box each
  __device__ void load(int it, const CUtensorMap* amap, int k0, int row0, int e,
                       const CUtensorMap* const* bmaps, const int* cols) {
    const int s = it % kStages;
    hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
    hopper::mbar_arrive_expect_tx(&full[s], (Smem<NB>::kA + Smem<NB>::kB) * sizeof(bf16));
    hopper::tma_load_3d(a + s * Smem<NB>::kA, amap, &full[s], k0, row0, e);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      hopper::tma_load_3d(b + s * Smem<NB>::kB + c * kBox * kBK, bmaps[c], &full[s], cols[c],
                          k0, e);
  }
  // descriptors of stage s, depth step kk: A rows [64 cw, 64 cw + 64)
  // (K-major rows of 128 bytes, 8-row groups 1024 bytes apart, k16 steps
  // 32 bytes along the row) and B from box `box` on (MN-major: 64-column
  // boxes kBK * 128 bytes apart, 8-row groups 1024 bytes apart, k16 steps
  // 16 rows = 2048 bytes)
  __device__ uint64_t desc_a(int s, int cw, int kk) const {
    return hopper::sw128_desc(a + s * Smem<NB>::kA + cw * 64 * kBK + kk * 16, 16, 1024);
  }
  __device__ uint64_t desc_b(int s, int box, int kk) const {
    return hopper::sw128_desc(b + s * Smem<NB>::kB + box * kBox * kBK + kk * 16 * kBox,
                              kBox * kBK * 2, 1024);
  }
};

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
  extern __shared__ uint8_t smem_raw[];
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN1;
  const int live = live_rows(counts, e, C);
  if (m0 >= live) return;  // a dead tile: phase 2 writes its zeros
  const int consumers = live - m0 > 64 ? 2 : 1;
  Ring<NB> ring(smem_raw, consumers);
  const int nk = (d + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // producer: one thread issues every load; the warpgroup gives up registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const CUtensorMap* maps[NB] = {&gmap, &gmap, &umap, &umap};
      const int cols[NB] = {n0, n0 + kBox, n0, n0 + kBox};
      for (int kb = 0; kb < nk; ++kb) ring.load(kb, &xmap, kb * kBK, m0, e, maps, cols);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;  // rows [64 cw, 64 cw + 64) of the tile
  if (cw >= consumers) return;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  float g[kBN1 / 2], u[kBN1 / 2];
  zero_acc<kBN1 / 2>(g);
  zero_acc<kBN1 / 2>(u);
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % kStages;
    hopper::mbar_wait(&ring.full[s], (kb / kStages) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = ring.desc_a(s, cw, kk);
      hopper::wgmma_128(g, da, ring.desc_b(s, 0, kk));
      hopper::wgmma_128(u, da, ring.desc_b(s, 2, kk));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the stage before this one is read
    if (kb > 0 && t == 0) hopper::mbar_arrive(&ring.empty[(kb - 1) % kStages]);
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
  Ring<NB> ring(smem_raw, consumers);
  const int nk = (f + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const CUtensorMap* maps[NB];
      int cols[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        maps[c] = &wmap;
        cols[c] = n0 + c * kBox;
      }
      for (int kb = 0; kb < nk; ++kb) ring.load(kb, &hmap, kb * kBK, m0, e, maps, cols);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
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
    const int s = kb % kStages;
    hopper::mbar_wait(&ring.full[s], (kb / kStages) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      hopper::wgmma_bn<BN>(acc, ring.desc_a(s, cw, kk), ring.desc_b(s, 0, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    if (kb > 0 && t == 0) hopper::mbar_arrive(&ring.empty[(kb - 1) % kStages]);
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
  using S = Smem<BN / kBox>;
  static const cudaError_t allowed = allow_smem(moe_down_tc<BN>, S::dynamic);
  if (allowed != cudaSuccess) return allowed;
  moe_down_tc<BN><<<dim3((d + BN - 1) / BN, (C + kBM - 1) / kBM, E), kThreads, S::dynamic,
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
  using S1 = Smem<2 * kBN1 / kBox>;
  static const cudaError_t allowed = allow_smem(moe_gate_up_tc, S1::dynamic);
  if (allowed != cudaSuccess) return allowed;
  moe_gate_up_tc<<<dim3((f + kBN1 - 1) / kBN1, (C + kBM - 1) / kBM, E), kThreads,
                   S1::dynamic, stream>>>(xmap, gmap, umap, counts, static_cast<bf16*>(h), C,
                                          d, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (d > 128)
    return launch_down<256>(hmap, wmap, counts, static_cast<bf16*>(y), E, C, d, f, stream);
  return launch_down<128>(hmap, wmap, counts, static_cast<bf16*>(y), E, C, d, f, stream);
}

}  // namespace tc

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
