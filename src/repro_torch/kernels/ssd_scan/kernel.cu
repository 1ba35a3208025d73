// Mamba-2 chunked SSD scan (state-space duality), forward, for Hopper.
//
// Replaces the Pallas kernel `ssd_scan_kernel`
// (src/repro/kernels/ssd_scan/kernel.py:67, pallas_call at :81) and the
// transposes and pad copy of its wrapper (ops.py:31-47): x, dt, B and C are
// read in place in the model's layout through their strides, the log-decay
// a = dt * A is formed here, and the last partial chunk is masked instead
// of padded.
//
// What it computes.  For batch b and head h, over chunks of Q steps
// (the last one ragged), with cum the within-chunk cumulative sum of
// a = dt * A and S the (P, N) state carried in from the previous chunks:
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) (x_j dt_j)
//           + exp(cum_i) C_i . S
//   S_new = exp(cum_last) S + sum_j B_j (x_j dt_j exp(cum_last - cum_j))
// which is what the TPU kernel computes chunk by chunk.  A masked row (past
// the sequence) behaves as dt = 0: it adds nothing and leaves cum, and so
// the state, unchanged, exactly as the wrapper's zero padding does.
// L[i, j] = exp(cum_i - cum_j) is evaluated only for i >= j: for i < j the
// exponent is positive and may overflow, and a select after an inf product
// would give NaN.
//
// Outputs.  y (B, S, H, P) in fp32, and the final state (B, H, P, N) fp32,
// the decode cache's layout.  The TPU kernel stores y in x.dtype and its
// wrapper casts back to fp32 (kernel.py:97, ops.py:50); the JAX model's
// default path (`_ssd_chunked`) keeps y in fp32.  Keeping fp32 matches that
// path and drops one bf16 rounding.
//
// Bound.  At the serving prefill (B 32, S 2,048, H 32, P 64, N 128, Q 256)
// the products need 2 (Q (Q + 1) / 2 (N + P) + 2 Q N P) operations per
// (b, h, chunk), 1.7e11 in all (0.17 ms at the bf16 tensor rate), and the
// bytes (x read once, y written once in fp32, B, C, dt read, state written)
// are 0.88 GB (0.26 ms at 3.35 TB/s): bytes bound it.  This kernel does its
// arithmetic as fp32 FMAs on the CUDA cores from shared memory, and
// recomputes C . B for every head (the TPU kernel does too), so it sits far
// above that bound.  Tensor cores (mma.sync, then wgmma) and one C . B per
// (b, chunk) shared by all H heads are the later work that closes the gap.
//
// Design.  One block of 256 threads (a 16 x 16 grid) per (h, b).  The TPU
// grid's sequential chunk axis becomes a loop inside the block, with the
// (P, N) state held in shared memory from one chunk to the next.  A chunk
// of up to 256 rows does not fit whole (B and C of 256 x 128 in fp32 are
// 128 KB each), so its rows are taken in tiles of 64: for each output tile
// I, the key tiles J <= I give G = (C_I . B_J^T) o L in shared memory and
// then G . (x dt)_J into registers (4 rows x up to 8 columns a thread); the
// carried state adds (C_I exp(cum_I)) . S; then, once every output tile has
// read the old state, a second pass over the chunk's tiles updates it.  The
// within-chunk cumsum is a warp scan.  Every product reads shared memory
// in 16-byte vectors (8 vector loads per 64 FMAs); rows of B and C are
// padded to N + 4 floats so that 8 consecutive rows fall in distinct
// banks, and the state is kept n-major so its rows are read as vectors.
// Shared memory: 2 * 64 (N + 4) + 64 P + 64 * 68 + N (P + 4) + 512 floats,
// 136 KB at P 64 / N 128 and 185 KB at P = N = 128 (one block per SM),
// raised through cudaFuncSetAttribute at every launch.
//
// Shapes taken: Q from 1 to 256; P and N multiples of 8 up to 128; x, B
// and C all fp32 or all bf16; dt and A fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kT = 64;         // rows per tile
constexpr int kMaxQ = 256;     // rows per chunk
constexpr int kMaxPN = 128;    // largest P and N
constexpr int GL = kT + 4;     // padded row of G

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Strides3 {  // in elements; the last axis is contiguous
  int64_t b, s, h;
};

// Shared memory in floats.  Rows of B and C hold N + 4 floats: 16-byte
// aligned, and N / 4 + 1 is odd, so the float4 reads of 8 consecutive
// rows fall in distinct banks.  The state is n-major, rows of P + 4.
size_t smem_floats(int P, int N) {
  return (size_t)2 * kT * (N + 4) + (size_t)kT * P + (size_t)kT * GL +
         (size_t)N * (P + 4) + 2 * kMaxQ;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// rows [first, first + kT) of a (S, width) matrix into dst[kT][ld], rows
// at or past `rows` (relative) as zeros, each scaled by scale[r] if given
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int64_t row_stride, int64_t first,
                                          int rows, int width,
                                          const float* scale) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int r = ty; r < kT; r += 16) {
    const bool live = r < rows;
    const float f = live && scale ? scale[r] : 1.f;
    const T* row = src + (first + r) * row_stride;
    for (int c = tx; c < width; c += 16)
      dst[r * ld + c] = live ? to_float(row[c]) * f : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, float* __restrict__ y,
                    float* __restrict__ state, Strides3 xs, Strides3 ds,
                    Strides3 bs, Strides3 cs, int S, int H, int P, int N,
                    int Q) {
  extern __shared__ float4 smem4[];
  const int NL = N + 4, SL = P + 4;
  float* Cs = reinterpret_cast<float*>(smem4);  // [kT][NL]
  float* Bs = Cs + kT * NL;                      // [kT][NL]
  float* Xs = Bs + kT * NL;                      // [kT][P]  x dt (x dt seg)
  float* Gs = Xs + kT * P;                       // [kT][GL]
  float* St = Gs + kT * GL;                      // [N][SL]  the carried state
  float* cum = St + N * SL;                      // [kMaxQ]
  float* dts = cum + kMaxQ;                      // [kMaxQ]
  float* seg = Gs;  // [kMaxQ] exp(cum_last - cum_j), in G's room in pass 2

  const int h = blockIdx.x, b = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lane = threadIdx.x % 32;
  const float Ah = A[h];
  const T* xb = x + b * xs.b + h * xs.h;
  const T* Bb = Bm + b * bs.b;
  const T* Cb = Cm + b * cs.b;
  const float* db = dt + b * ds.b + h * ds.h;
  float* yb = y + ((int64_t)b * S * H + h) * P;
  const int64_t y_row = (int64_t)H * P;

  for (int i = threadIdx.x; i < N * SL; i += kThreads) St[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int q = min(Q, S - c0);
    const int nt = (q + kT - 1) / kT;
    __syncthreads();  // the previous chunk is done with cum, dts and seg
    for (int i = threadIdx.x; i < q; i += kThreads) {
      const float d = db[(int64_t)(c0 + i) * ds.s];
      dts[i] = d;
      cum[i] = d * Ah;
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // inclusive cumsum of a over the chunk
      const int per = (q + 31) / 32;
      const int lo = min(lane * per, q), hi = min(lo + per, q);
      float run = 0.f;
      for (int k = lo; k < hi; ++k) {
        run += cum[k];
        cum[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const float off = incl - run;
      for (int k = lo; k < hi; ++k) cum[k] += off;
    }
    __syncthreads();
    const float total = cum[q - 1];

    // ---- y: intra-chunk products and the carried state's share ----
    // thread (ty, tx) owns rows i0 + ty + 16 r and columns tx * 4 + 64 g
    // + k of the output tile; of G, rows ty + 16 r and columns tx + 16 c
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * kT;
      float4 acc[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int g = 0; g < 2; ++g) acc[r][g] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        __syncthreads();  // Cs, Bs, Xs and Gs are free
        if (jt == 0) load_rows(Cs, NL, Cb, cs.s, c0 + i0, q - i0, N, nullptr);
        load_rows(Bs, NL, Bb, bs.s, c0 + j0, q - j0, N, nullptr);
        load_rows(Xs, P, xb, xs.s, c0 + j0, q - j0, P, dts + j0);
        __syncthreads();
        float gv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) gv[r][c] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float4 cr[4], bc[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cr[r] = ld4(Cs + (ty + 16 * r) * NL + n);
#pragma unroll
          for (int c = 0; c < 4; ++c) bc[c] = ld4(Bs + (tx + 16 * c) * NL + n);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              gv[r][c] += cr[r].x * bc[c].x;
              gv[r][c] += cr[r].y * bc[c].y;
              gv[r][c] += cr[r].z * bc[c].z;
              gv[r][c] += cr[r].w * bc[c].w;
            }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int il = ty + 16 * r, i = i0 + il;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int jl = tx + 16 * c, j = j0 + jl;
            float v = 0.f;
            if (i < q && j <= i) v = gv[r][c] * expf(cum[i] - cum[j]);
            Gs[il * GL + jl] = v;
          }
        }
        __syncthreads();
        // G . (x dt); columns of G past the chunk are 0, rows of Xs too
        const int jn = (min(kT, q - j0) + 3) & ~3;
        for (int j = 0; j < jn; j += 4) {
          float4 gr[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) gr[r] = ld4(Gs + (ty + 16 * r) * GL + j);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
#pragma unroll
            for (int g = 0; g < 2; ++g) {
              const int p = tx * 4 + 64 * g;
              if (p < P) {
                const float4 xv = ld4(Xs + (j + k) * P + p);
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  const float w = comp(gr[r], k);
                  acc[r][g].x += w * xv.x;
                  acc[r][g].y += w * xv.y;
                  acc[r][g].z += w * xv.z;
                  acc[r][g].w += w * xv.w;
                }
              }
            }
          }
        }
      }
      // (C_i exp(cum_i)) . S with the state carried into this chunk
      float e[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        e[r] = i < q ? expf(cum[i]) : 0.f;
      }
      for (int n = 0; n < N; n += 4) {
        float4 cr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          cr[r] = ld4(Cs + (ty + 16 * r) * NL + n);
          cr[r].x *= e[r];
          cr[r].y *= e[r];
          cr[r].z *= e[r];
          cr[r].w *= e[r];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            const int p = tx * 4 + 64 * g;
            if (p < P) {
              const float4 sv = ld4(St + (n + k) * SL + p);
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const float w = comp(cr[r], k);
                acc[r][g].x += w * sv.x;
                acc[r][g].y += w * sv.y;
                acc[r][g].z += w * sv.z;
                acc[r][g].w += w * sv.w;
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= q) continue;
        float* yr = yb + (int64_t)(c0 + i) * y_row;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int p = tx * 4 + 64 * g;
          if (p < P) *reinterpret_cast<float4*>(yr + p) = acc[r][g];
        }
      }
    }

    // ---- the state: S = exp(cum_last) S + sum_j B_j (x_j dt_j seg_j) ----
    __syncthreads();  // every output tile has read the old state
    const float decay = expf(total);
    for (int i = threadIdx.x; i < N * SL; i += kThreads) St[i] *= decay;
    for (int i = threadIdx.x; i < q; i += kThreads)
      seg[i] = dts[i] * expf(total - cum[i]);
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();  // Bs and Xs are free; seg is written
      load_rows(Bs, NL, Bb, bs.s, c0 + j0, q - j0, N, nullptr);
      load_rows(Xs, P, xb, xs.s, c0 + j0, q - j0, P, seg + j0);
      __syncthreads();
      const int jn = min(kT, q - j0);
      // thread (ty, tx) owns state rows n0 + ty * 4 + r, columns p0 + tx * 4 + k
      for (int n0 = 0; n0 < N; n0 += 64) {
        for (int p0 = 0; p0 < P; p0 += 64) {
          const int nn = n0 + ty * 4, pp = p0 + tx * 4;
          if (nn >= N || pp >= P) continue;
          float4 sv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) sv[r] = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int j = 0; j < jn; ++j) {
            const float4 bn = ld4(Bs + j * NL + nn);
            const float4 u = ld4(Xs + j * P + pp);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float w = comp(bn, r);
              sv[r].x += w * u.x;
              sv[r].y += w * u.y;
              sv[r].z += w * u.z;
              sv[r].w += w * u.w;
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float4* dst = reinterpret_cast<float4*>(St + (nn + r) * SL + pp);
            float4 v = *dst;
            v.x += sv[r].x;
            v.y += sv[r].y;
            v.z += sv[r].z;
            v.w += sv[r].w;
            *dst = v;
          }
        }
      }
    }
  }
  __syncthreads();
  float* sb = state + ((int64_t)b * H + h) * P * N;
  for (int i = threadIdx.x; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    sb[i] = St[n * SL + p];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, float* y, float* state,
                   Strides3 xs, Strides3 ds, Strides3 bs, Strides3 cs, int B,
                   int S, int H, int P, int N, int Q, cudaStream_t stream) {
  const size_t bytes = smem_floats(P, N) * sizeof(float);
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(kMaxPN, kMaxPN) * sizeof(float)));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), y, state, xs, ds, bs, cs, S, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes).  x (B, S, H, P) and B, C (B, S, N)
// in the dtype given (0 = float32, 1 = bfloat16), dt (B, S, H) float32, all
// with the given element strides (batch, step, head; the last axis
// contiguous; B and C have no head stride); A (H,) float32.  Writes y
// (B, S, H, P) and state (B, H, P, N), both contiguous float32.  Returns
// the cudaError_t of the launch (0 on success); cudaErrorInvalidValue (1)
// for a shape the kernel does not take.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* state, int64_t B, int64_t S, int64_t H,
                               int64_t P, int64_t N, int64_t Q, int64_t xsb,
                               int64_t xss, int64_t xsh, int64_t dsb,
                               int64_t dss, int64_t dsh, int64_t bsb,
                               int64_t bss, int64_t csb, int64_t css,
                               int64_t dtype, void* stream) {
  if (Q < 1 || Q > kMaxQ || P < 8 || P > kMaxPN || P % 8 || N < 8 ||
      N > kMaxPN || N % 8 || S < 1 || H < 1 || B < 1 || H > 65535 ||
      B > 65535)
    return cudaErrorInvalidValue;
  const Strides3 xs{xsb, xss, xsh}, ds{dsb, dss, dsh}, bs{bsb, bss, 0},
      cs{csb, css, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  if (dtype == 0)
    return launch<float>(x, dtf, Af, Bm, Cm, yf, sf, xs, ds, bs, cs, (int)B,
                         (int)S, (int)H, (int)P, (int)N, (int)Q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, yf, sf, xs, ds, bs, cs,
                                 (int)B, (int)S, (int)H, (int)P, (int)N,
                                 (int)Q, s);
  return cudaErrorInvalidValue;
}
