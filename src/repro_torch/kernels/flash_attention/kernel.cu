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
// Skv.  The numerics are the TPU kernel's: fp32 scores; masked scores -1e30
// (not -inf); an online softmax with fp32 running max m, sum l and
// accumulator; p rounded to the input dtype before the PV product; out =
// acc / max(l, 1e-30).
//
// Bound.  At prefill the work is 4 * D operations per live (query head,
// key) pair: 4 * B * H * D * (live pairs), against the card's bf16 tensor
// rate; the bytes (q, k, v read once, out written once) are far below.
//
// Design, both bodies.  One block per (query tile, kv head, batch).  A
// block holds all G query heads of its kv head: its 64 rows are (query,
// head) pairs, with Bq = floor(64 / G) queries (21 at G = 3, and one
// padding row that computes but never writes), so every K/V tile staged in
// shared memory serves G heads, as the TPU kernel's (G * Bq, D) product
// does.  The TPU grid's sequential kv axis becomes a loop inside the block
// over tiles of keys, skipping tiles that are dead for the whole block by
// the TPU kernel's test (kernel.py:44-54).  D is 16, 32, 64, 128 or 256.
//
// fp32 body: plain fp32 FMAs on the CUDA cores (TF32 could not meet the
// fp32 tolerance of 2e-5).  q is scaled in fp32 before the product, as the
// TPU kernel does.  Each of the 8 warps owns 8 rows: lane c scores keys c
// and c + 32 (float4 reads of q and k from shared memory), the row max and
// sum are warp shuffles, the rounded p go to shared memory, and lane l
// accumulates output columns [l * D / 32, (l + 1) * D / 32) of its 8 rows
// in registers (one column, and half the lanes idle, at D = 16).  Shared
// memory: q (64 x D), k (64 x (D + 4), padded so the float4 reads of 8
// lanes hit distinct banks), v (64 x D) and p (64 x 64), all fp32: 64 KB at
// D = 64, 209 KB at D = 256, set as dynamic shared memory through
// cudaFuncSetAttribute at each launch.
//
// bf16 body: FlashAttention-2 on the tensor cores.  4 warps, 16 rows each;
// tiles of 64 keys (32 at D = 256); at D <= 64 the launch bounds hold a
// thread to 128 registers, so that 4 blocks share an SM.  q . k and p . v are mma.sync m16n8k16
// (bf16 in, fp32 accumulators).  The q fragments are loaded once per block
// into registers with ldmatrix (at D = 256 they are read from shared
// memory at each tile, to leave registers to the 16 x 256 accumulator).
// K/V tiles are double-buffered through shared memory by cp.async, the
// next tile's copies flying during this tile's products; rows are padded
// by 16 bytes so ldmatrix reads distinct banks.  The online softmax runs on
// the accumulator fragments: a row's values sit in the 4 lanes of a quad,
// whose max and sum are xor shuffles.  p is rounded to bf16 and fed from
// registers as the A operand of p . v, with v read by ldmatrix.trans from
// its (key, d) rows.  The scale is applied to the fp32 score after the
// product (the products of bf16 values are exact in fp32, the sum is not
// reordered by it), where the TPU kernel scales q in fp32 first: the two
// differ by about an fp32 ulp per score.  Scores are kept in base 2 (the
// scale times log2 e) and p = exp2f(s - m), the hardware's ex2 (2 ulp):
// the same p as expf within a few fp32 ulps, far below its rounding to
// bf16, at a fraction of expf's instructions, which the softmax of a
// 64-wide head would otherwise be bound by.  cp.async moves 16-byte chunks,
// so q, k and v must have 16-byte aligned bases and strides a multiple of
// 8 elements (the wrapper hands over aligned copies otherwise).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "_hopper.cuh"

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

// ------------------------------------------------------ bf16: tensor cores

namespace tc {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 4 * 32;  // 4 warps of 16 rows

template <int D>
struct Cfg {
  static constexpr int KB = D == 256 ? 32 : 64;  // keys per tile
  static constexpr int LD = D + 8;  // shared row (elements): ldmatrix rows on distinct banks
  static constexpr int CPR = D / 8;              // 16-byte chunks per row
  static constexpr bool QREG = D <= 128;         // Q fragments held in registers
  static constexpr size_t bytes = (size_t)(kRows + 4 * KB) * LD * sizeof(bf16);
};

template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int64_t row_stride,
                                          int rows, int live) {
  // rows [0, rows) of 16-byte chunks; rows at or past `live` as zeros
  constexpr int CPR = Cfg<D>::CPR, LD = Cfg<D>::LD;
  for (int i = threadIdx.x; i < rows * CPR; i += kThreads) {
    const int r = i / CPR, c = i - (i / CPR) * CPR;
    const bool ok = r < live;
    hopper::cp_async16(dst + r * LD + c * 8, ok ? src + r * row_stride + c * 8 : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 4 : 1)
    flash_attention_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, Strides qs,
                       Strides ks, Strides vs, Strides os, int Sq, int Skv, int G, int Bq,
                       int causal, int window, float scale) {
  using C = Cfg<D>;
  constexpr int KB = C::KB, LD = C::LD, CPR = C::CPR;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [kRows][LD]
  bf16* Ks = Qs + kRows * LD;                 // [2][KB][LD]
  bf16* Vs = Ks + 2 * KB * LD;                // [2][KB][LD]

  const int kh = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * Bq;   // first query of the tile
  const int nq = min(Bq, Sq - q0);  // queries in the tile
  const int nrows = nq * G;         // live rows; row r = query r / G, head r % G
  const int off = Skv - Sq;         // key position of query 0
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qd = lane % 4;          // fragment column pair
  const float scale2 = scale * kLog2e;  // scores in base 2: exp(x) = 2^(x log2 e)

  // Q: row r is (query q0 + r / G, head kh * G + r % G), one 16-byte chunk
  // at a time; padding rows are zeros
  for (int i = threadIdx.x; i < kRows * CPR; i += kThreads) {
    const int r = i / CPR, c = i - (i / CPR) * CPR;
    const bool ok = r < nrows;
    const bf16* src = ok ? q + b * qs.b + (int64_t)(q0 + r / G) * qs.s +
                               (int64_t)(kh * G + r % G) * qs.h + c * 8
                         : q;
    hopper::cp_async16(Qs + r * LD + c * 8, src, ok);
  }
  hopper::cp_async_commit();

  // the live kv tiles [j0, j1): the TPU kernel's dead-tile test at KB keys
  const int q_lo = off + q0, q_hi = off + q0 + nq - 1;  // key positions
  const int n_kv = (Skv + KB - 1) / KB;
  const int j1 = causal ? min(n_kv, q_hi / KB + 1) : n_kv;
  int j0 = 0;
  if (window > 0)
    while (j0 < j1 && q_lo - (min((j0 + 1) * KB, Skv) - 1) >= window) ++j0;

  const bf16* kb = k + b * ks.b + kh * ks.h;
  const bf16* vb = v + b * vs.b + kh * vs.h;
  auto load_kv = [&](int j, int buf) {
    const int live = min(KB, Skv - j * KB);
    load_rows<D>(Ks + buf * KB * LD, kb + (int64_t)j * KB * ks.s, ks.s, KB, live);
    load_rows<D>(Vs + buf * KB * LD, vb + (int64_t)j * KB * vs.s, vs.s, KB, live);
  };

  // this thread's two rows of its warp's 16, and their key positions
  const int ra = warp * 16 + lane / 4, rb = ra + 8;
  const int qpos[2] = {off + q0 + ra / G, off + q0 + rb / G};

  float o[D / 8][4], m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < D / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  uint32_t qf[C::QREG ? D / 16 : 1][4];

  if (j0 < j1) load_kv(j0, 0);
  hopper::cp_async_commit();
  for (int j = j0; j < j1; ++j) {
    const int buf = (j - j0) & 1;
    if (j + 1 < j1) load_kv(j + 1, buf ^ 1);  // flies during this tile's products
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();  // Q and tile j have landed
    __syncthreads();
    const bf16* Kt = Ks + buf * KB * LD;
    const bf16* Vt = Vs + buf * KB * LD;
    const bf16* qrow = Qs + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
    if constexpr (C::QREG) {
      if (j == j0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) hopper::ldmatrix_x4(qf[kk], qrow + kk * 16);
      }
    }

    // s = q . k over D, 16 rows x KB keys a warp (m16n8k16, fp32 sums)
    float s[KB / 8][4];
#pragma unroll
    for (int t = 0; t < KB / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (C::QREG) {
        a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2], a[3] = qf[kk][3];
      } else {
        hopper::ldmatrix_x4(a, qrow + kk * 16);
      }
#pragma unroll
      for (int t = 0; t < KB / 8; t += 2) {
        uint32_t bk[4];
        hopper::ldmatrix_x4(bk, Kt + (t * 8 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                                    ((lane / 8) % 2) * 8);
        hopper::mma_bf16_16816(s[t], a, bk);
        hopper::mma_bf16_16816(s[t + 1], a, bk + 2);
      }
    }

    // scale in fp32 (to base 2), mask, and the online softmax on the
    // fragments: a row's values sit in the 4 lanes of a quad (xor shuffles
    // 1 and 2)
    const int k_lo = j * KB;
    const bool edge = (causal && k_lo + KB - 1 > q_lo) ||
                      (window > 0 && q_hi - k_lo >= window) || k_lo + KB > Skv;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int t = 0; t < KB / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * scale2;
        if (edge) {
          const int pos = k_lo + t * 8 + 2 * qd + (e & 1), qp = qpos[e / 2];
          bool ok = pos < Skv;
          if (causal) ok = ok && qp >= pos;
          if (window > 0) ok = ok && qp - pos < window;
          if (!ok) x = kNeg;
        }
        s[t][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
    // p rounded to bf16 becomes the A operand of p . v in registers: the
    // fragments of key tiles 2 t' and 2 t' + 1 are those of k-step t'
    uint32_t pf[KB / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < KB / 8; ++t) {
      const float p0 = exp2f(s[t][0] - m[0]), p1 = exp2f(s[t][1] - m[0]);
      const float p2 = exp2f(s[t][2] - m[1]), p3 = exp2f(s[t][3] - m[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[t / 2][(t % 2) * 2] = hopper::pack_bf16(p0, p1);
      pf[t / 2][(t % 2) * 2 + 1] = hopper::pack_bf16(p2, p3);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];  // this lane's share
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      o[t][0] *= corr[0];
      o[t][1] *= corr[0];
      o[t][2] *= corr[1];
      o[t][3] *= corr[1];
    }

    // o += p . v, v by ldmatrix.trans from its (key, d) rows
#pragma unroll
    for (int kt = 0; kt < KB / 16; ++kt) {
#pragma unroll
      for (int t = 0; t < D / 8; t += 2) {
        uint32_t bv[4];
        hopper::ldmatrix_x4_trans(
            bv, Vt + (kt * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD + t * 8 +
                    (lane / 16) * 8);
        hopper::mma_bf16_16816(o[t], pf[kt], bv);
        hopper::mma_bf16_16816(o[t + 1], pf[kt], bv + 2);
      }
    }
    __syncthreads();  // this buffer is refilled at the next tile
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = h == 0 ? ra : rb;
    if (r >= nrows) continue;
    const float den = fmaxf(l[h], 1e-30f);
    bf16* orow = out + b * os.b + (int64_t)(q0 + r / G) * os.s +
                 (int64_t)(kh * G + r % G) * os.h + 2 * qd;
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
      *reinterpret_cast<__nv_bfloat162*>(orow + t * 8) =
          __floats2bfloat162_rn(o[t][2 * h] / den, o[t][2 * h + 1] / den);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, Strides qs,
                   Strides ks, Strides vs, Strides os, int B, int Sq, int Skv, int K,
                   int G, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Cfg<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_tc<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const int Bq = kRows / G;
  const dim3 grid((Sq + Bq - 1) / Bq, K, B);
  flash_attention_tc<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), qs, ks, vs, os, Sq, Skv, G,
      Bq, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// C entry point (bound with ctypes).  q (B, Sq, K * G, D), k and v
// (B, Skv, K, D), out (B, Sq, K * G, D) with the given element strides and
// a contiguous D axis.  dtype 0 = float32 (the fp32 body), 1 = bfloat16
// (the tensor-core body: bases 16-byte aligned, strides multiples of 8).  window <= 0
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
  if (dtype == 1) {
    // the tensor-core body moves 16-byte chunks
    const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                            reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
    const int64_t strides = qsb | qss | qsh | ksb | kss | ksh | vsb | vss | vsh | osb |
                            oss | osh;
    if ((bases & 15) || (strides & 7)) return cudaErrorInvalidValue;
    const int b = (int)B, sq = (int)Sq, skv = (int)Skv, kk = (int)K, g = (int)G,
              c = (int)causal, w = (int)window;
    switch (D) {
      case 16:
        return tc::launch<16>(q, k, v, out, qs, ks, vs, os, b, sq, skv, kk, g, c, w, scale, s);
      case 32:
        return tc::launch<32>(q, k, v, out, qs, ks, vs, os, b, sq, skv, kk, g, c, w, scale, s);
      case 64:
        return tc::launch<64>(q, k, v, out, qs, ks, vs, os, b, sq, skv, kk, g, c, w, scale, s);
      case 128:
        return tc::launch<128>(q, k, v, out, qs, ks, vs, os, b, sq, skv, kk, g, c, w, scale, s);
      case 256:
        return tc::launch<256>(q, k, v, out, qs, ks, vs, os, b, sq, skv, kk, g, c, w, scale, s);
      default:
        return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
