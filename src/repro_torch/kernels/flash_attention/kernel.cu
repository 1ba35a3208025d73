// GQA flash attention (forward), causal and sliding-window, for Hopper.
//
// Replaces the Pallas kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py:25-87, pallas_call at :113)
// and the layout transposes of its wrapper (ops.py:30-32): q, k, v and the
// output stay in the public (B, S, heads, D) layout and are read through
// their strides.
//
// What it computes.  For query i of batch b and head h = kh * G + g,
//   out = softmax_j(q_i . k_j * scale  masked) . v_j   over kv head kh,
// with query i at key position (Skv - Sq) + i; masked when j > that
// position (causal), when position - j >= window (sliding window) and past
// Skv.  The numerics are the TPU kernel's: scores in fp32 from q taken to
// fp32 and scaled in fp32; masked scores -1e30 (not -inf); an online
// softmax with fp32 running max m, sum l and accumulator; p rounded to the
// input dtype before the PV product; out = acc / max(l, 1e-30).
//
// Bound.  At prefill the work is 4 * D operations per live (query head,
// key) pair: 4 * B * H * D * (live pairs), against the card's bf16 tensor
// rate; the bytes (q, k, v read once, out written once) are far below.
//
// Design.  One block per (query tile, kv head, batch).  A block holds all
// G query heads of its kv head: its 64 rows are (query, head) pairs, with
// Bq = floor(64 / G) queries (21 at G = 3), so every K/V tile staged in
// shared memory serves G heads, as the TPU kernel's (G * Bq, D) product
// does.  The TPU grid's sequential kv axis becomes a loop inside the block
// over tiles of 64 keys, skipping tiles that are dead for the whole block
// by the TPU kernel's test (kernel.py:44-54).  Each of the 8 warps owns 8
// rows: lane c scores keys c and c + 32 (float4 reads of q and k from
// shared memory), the row max and sum are warp shuffles, the rounded p go
// to shared memory, and lane l accumulates output columns
// [l * D / 32, (l + 1) * D / 32) of its 8 rows in registers (one column,
// and half the lanes idle, at D = 16).  D is 16, 32, 64, 128 or 256.
//
// Arithmetic.  Scores and PV are plain fp32 FMAs on the CUDA cores, not
// tensor cores (no mma.sync / wgmma): simple and exact in fp32, far below
// the bf16 tensor-core bound.  Shared memory: q (64 x D), k (64 x (D + 4),
// padded so the float4 reads of 8 lanes hit distinct banks), v (64 x D)
// and p (64 x 64), all fp32: 64 KB at D = 64, 209 KB at D = 256, set as
// dynamic shared memory through cudaFuncSetAttribute at each launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // (query, head) rows per block
constexpr int kBkv = 64;                      // keys per tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {  // in elements; the D axis is contiguous
  int64_t b, s, h;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kRows * D + kBkv * (D + 4) + kBkv * D + kRows * kBkv);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           Strides qs, Strides ks, Strides vs, Strides os,
                           int Sq, int Skv, int G, int Bq, int causal,
                           int window, float scale) {
  constexpr int KP = D + 4;                   // padded k row
  constexpr int DL = D >= 32 ? D / 32 : 1;    // output columns per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kRows][D], scaled
  float* Ks = Qs + kRows * D;                    // [kBkv][KP]
  float* Vs = Ks + kBkv * KP;                    // [kBkv][D]
  float* Ps = Vs + kBkv * D;                     // [kRows][kBkv]

  const int kh = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * Bq;   // first query of the tile
  const int nq = min(Bq, Sq - q0);  // queries in the tile
  const int nrows = nq * G;         // live rows; row r = query r / G, head r % G
  const int off = Skv - Sq;         // key position of query 0
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRowsPerWarp;
  // lanes past D (D = 16) repeat the last columns and write nothing
  const int col = min(lane * DL, D - DL);

  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    float x = 0.f;
    if (r < nrows) {
      const int qi = q0 + r / G, h = kh * G + r % G;
      x = to_float(q[b * qs.b + qi * qs.s + h * qs.h + d]) * scale;
    }
    Qs[i] = x;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[i][e] = 0.f;
  }

  const int q_lo = off + q0, q_hi = off + q0 + nq - 1;  // key positions
  const int n_kv = (Skv + kBkv - 1) / kBkv;
  for (int j = 0; j < n_kv; ++j) {
    const int k_lo = j * kBkv, k_hi = min(k_lo + kBkv, Skv) - 1;
    // dead tiles: every query precedes every key, or is past the window
    if (causal && q_hi < k_lo) break;
    if (window > 0 && q_lo - k_hi >= window) continue;

    __syncthreads();  // the previous tile's k, v are no longer read
    for (int i = threadIdx.x; i < kBkv * D; i += kThreads) {
      const int c = i / D, d = i - (i / D) * D;
      const int pos = k_lo + c;
      float kx = 0.f, vx = 0.f;
      if (pos < Skv) {
        kx = to_float(k[b * ks.b + pos * ks.s + kh * ks.h + d]);
        vx = to_float(v[b * vs.b + pos * vs.s + kh * vs.h + d]);
      }
      Ks[c * KP + d] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    // scores of rows r0..r0+7 against keys lane and lane + 32
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
    const float4* k0 = reinterpret_cast<const float4*>(Ks + lane * KP);
    const float4* k1 = reinterpret_cast<const float4*>(Ks + (lane + 32) * KP);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 a = k0[d4], c = k1[d4];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 x = reinterpret_cast<const float4*>(Qs + (r0 + i) * D)[d4];
        s[i][0] = fmaf(x.x, a.x, s[i][0]);
        s[i][0] = fmaf(x.y, a.y, s[i][0]);
        s[i][0] = fmaf(x.z, a.z, s[i][0]);
        s[i][0] = fmaf(x.w, a.w, s[i][0]);
        s[i][1] = fmaf(x.x, c.x, s[i][1]);
        s[i][1] = fmaf(x.y, c.y, s[i][1]);
        s[i][1] = fmaf(x.z, c.z, s[i][1]);
        s[i][1] = fmaf(x.w, c.w, s[i][1]);
      }
    }

    // masks and the online softmax update, one row at a time
    float corr[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qpos = off + q0 + (r0 + i) / G;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int pos = k_lo + lane + 32 * t;
        bool ok = pos < Skv;
        if (causal) ok = ok && qpos >= pos;
        if (window > 0) ok = ok && qpos - pos < window;
        if (!ok) s[i][t] = kNeg;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[i][0], s[i][1])));
      const float p0 = expf(s[i][0] - m_new), p1 = expf(s[i][1] - m_new);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + warp_sum(p0 + p1);
      m[i] = m_new;
      Ps[(r0 + i) * kBkv + lane] = to_float(from_float<T>(p0));
      Ps[(r0 + i) * kBkv + lane + 32] = to_float(from_float<T>(p1));
    }
    __syncwarp();

    // acc = acc * corr + p . v over this tile's keys
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[i][e] *= corr[i];
#pragma unroll 2
    for (int c4 = 0; c4 < kBkv / 4; ++c4) {
      float p[kRowsPerWarp][4];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 x = reinterpret_cast<const float4*>(Ps + (r0 + i) * kBkv)[c4];
        p[i][0] = x.x;
        p[i][1] = x.y;
        p[i][2] = x.z;
        p[i][3] = x.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = Vs + (c4 * 4 + cc) * D + col;
        float vv[DL];
#pragma unroll
        for (int e = 0; e < DL; ++e) vv[e] = vrow[e];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
          for (int e = 0; e < DL; ++e) acc[i][e] = fmaf(p[i][cc], vv[e], acc[i][e]);
      }
    }
    __syncwarp();  // Ps is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + i;
    if (r >= nrows || lane * DL >= D) break;
    const int qi = q0 + r / G, h = kh * G + r % G;
    T* o = out + b * os.b + qi * os.s + h * os.h + col;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DL; ++e) o[e] = from_float<T>(acc[i][e] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   Strides qs, Strides ks, Strides vs, Strides os, int B,
                   int Sq, int Skv, int K, int G, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  // set on every launch: the attribute belongs to the current device, and
  // the call is cheap next to the kernel
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int Bq = kRows / G;
  const dim3 grid((Sq + Bq - 1) / Bq, K, B);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, Sq, Skv,
      G, Bq, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* out, Strides qs, Strides ks, Strides vs,
                       Strides os, int B, int Sq, int Skv, int K, int G,
                       int causal, int window, float scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, qs, ks, vs, os, B, Sq, Skv, K, G,
                           causal, window, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, out, qs, ks, vs, os, B, Sq, Skv, K, G,
                           causal, window, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, qs, ks, vs, os, B, Sq, Skv, K, G,
                           causal, window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, qs, ks, vs, os, B, Sq, Skv, K, G,
                            causal, window, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, qs, ks, vs, os, B, Sq, Skv, K, G,
                            causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (bound with ctypes).  q (B, Sq, K * G, D), k and v
// (B, Skv, K, D), out (B, Sq, K * G, D) with the given element strides and
// a contiguous D axis.  dtype 0 = float32, 1 = bfloat16.  window <= 0
// means none.  Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue (1) for a shape the kernel has no instance for.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int64_t B,
    int64_t Sq, int64_t Skv, int64_t K, int64_t G, int64_t D, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int64_t osb, int64_t oss,
    int64_t osh, int64_t causal, int64_t window, float scale, int64_t dtype,
    void* stream) {
  if (G < 1 || G > kRows || Sq > Skv) return cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0 || K <= 0) return cudaSuccess;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>((int)D, q, k, v, out, qs, ks, vs, os, (int)B,
                             (int)Sq, (int)Skv, (int)K, (int)G, (int)causal,
                             (int)window, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>((int)D, q, k, v, out, qs, ks, vs, os,
                                     (int)B, (int)Sq, (int)Skv, (int)K,
                                     (int)G, (int)causal, (int)window, scale,
                                     s);
  return cudaErrorInvalidValue;
}
