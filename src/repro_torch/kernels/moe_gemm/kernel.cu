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
// it.  At a decode step (32 tokens, C 10) it is reading the 100 MB of
// expert weights: bytes bound it.  This kernel does its arithmetic as
// fp32 FMAs on the CUDA cores (as the TPU kernel's HIGHEST precision asks
// of fp32 inputs), so at prefill it sits far above the bound; bf16 tensor
// cores (mma.sync, then wgmma) are the later work that closes the gap,
// and they are exact for bf16 inputs (a bf16 x bf16 product is exact in
// fp32).
//
// Design.  Two phases in one entry point, each a tiled GEMM with one
// block of 256 threads (a 16 x 16 grid) per (column tile, 64-row tile,
// expert).  The hidden activations do not fit shared memory whole (a
// 64-row tile of g and u in fp32 at f 512 is 256 KB), so phase 1 writes
// h (E, C, f) in T, which the result rounds to anyway, and phase 2 reads
// it back.  Phase 1: 64 rows x 64 columns of f, g and u accumulated side
// by side (4 x 4 of each per thread).  Phase 2: 64 rows x 128 columns of
// d (4 x 8 per thread).  Column tiles fill the card at decode, where an
// expert holds at most C = 10 rows: phase 1 runs 8 x 32 blocks, phase 2
// 8 x 32.  A block reads counts[e] from device memory (the TPU kernel's
// scalar prefetch) and a row tile at or past it does no arithmetic:
// phase 1 returns, phase 2 writes zeros.  The depth is taken 32 at a
// time: A transposed and B row-major in shared memory, read as 16-byte
// vectors (3 vector loads per 32 FMAs); the next stage's global loads are
// issued into registers before the current stage's products.  Rows past
// the count load as zeros.  Offsets are 64-bit.
//
// Shapes taken: d and f multiples of 8; all tensors contiguous and
// 16-byte aligned; E and ceil(C / 64) up to 65,535.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kBM = 64;        // rows per block
constexpr int kBK = 32;        // depth per stage
constexpr int kBN1 = 64;       // phase 1: columns of f per block
constexpr int kBN2 = 128;      // phase 2: columns of d per block
constexpr int kLA = kBM + 4;   // row of the transposed A tile, 16-byte aligned

// 8 consecutive values as fp32 (16 bytes of bf16, 32 of fp32)
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 4 consecutive fp32 values into T, rounded to nearest even
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
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

template <typename T>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, const int* counts, void* h, void* y, int E,
                   int C, int d, int f, cudaStream_t stream) {
  const int row_tiles = (C + kBM - 1) / kBM;
  moe_gate_up_kernel<T><<<dim3((f + kBN1 - 1) / kBN1, row_tiles, E), kThreads, 0,
                          stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), counts, static_cast<T*>(h), C, d, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_down_kernel<T><<<dim3((d + kBN2 - 1) / kBN2, row_tiles, E), kThreads, 0,
                       stream>>>(static_cast<const T*>(h),
                                 static_cast<const T*>(wd), counts,
                                 static_cast<T*>(y), C, d, f);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes).  x (E, C, d), w_gate and w_up
// (E, d, f), w_down (E, f, d), the scratch h (E, C, f) and the output y
// (E, C, d), all contiguous in the dtype given (0 = float32, 1 =
// bfloat16); counts (E,) int32 on the device.  Returns the cudaError_t of
// the launches (0 on success); cudaErrorInvalidValue (1) for a shape the
// kernel does not take.
extern "C" int moe_gemm_launch(const void* x, const void* w_gate,
                               const void* w_up, const void* w_down,
                               const void* counts, void* h, void* y,
                               int64_t E, int64_t C, int64_t d, int64_t f,
                               int64_t dtype, void* stream) {
  if (E < 1 || E > 65535 || C < 1 || (C + kBM - 1) / kBM > 65535 || d < 8 ||
      d % 8 || f < 8 || f % 8 || d > (1 << 30) || f > (1 << 30))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(counts);
  if (dtype == 0)
    return launch<float>(x, w_gate, w_up, w_down, c, h, y, (int)E, (int)C,
                         (int)d, (int)f, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w_gate, w_up, w_down, c, h, y, (int)E,
                                 (int)C, (int)d, (int)f, s);
  return cudaErrorInvalidValue;
}
