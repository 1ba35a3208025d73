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
// are 0.88 GB (0.26 ms at 3.35 TB/s): bytes bound it.
//
// Two bodies.  fp32 inputs run the FMA body (`ssd_scan_kernel`); bf16
// inputs run the tensor-core body (`tc::ssd_scan_tc`).  Both hold y and
// the state to fp32 level (the tests' rtol 1e-4 and 1e-4 of max |out|).
//
// The FMA body.  One block of 256 threads (a 16 x 16 grid) per (h, b).
// The TPU grid's sequential chunk axis becomes a loop inside the block,
// with the (P, N) state held in shared memory from one chunk to the next.
// A chunk of up to 256 rows does not fit whole (B and C of 256 x 128 in
// fp32 are 128 KB each), so its rows are taken in tiles of 64: for each
// output tile I, the key tiles J <= I give G = (C_I . B_J^T) o L in shared
// memory and then G . (x dt)_J into registers (4 rows x up to 8 columns a
// thread); the carried state adds (C_I exp(cum_I)) . S; then, once every
// output tile has read the old state, a second pass over the chunk's tiles
// updates it.  The within-chunk cumsum is a warp scan.  Every product reads
// shared memory in 16-byte vectors (8 vector loads per 64 FMAs); rows of B
// and C are padded to N + 4 floats so that 8 consecutive rows fall in
// distinct banks, and the state is kept n-major so its rows are read as
// vectors.  Shared memory: 2 * 64 (N + 4) + 64 P + 64 * 68 + N (P + 4) +
// 512 floats, 136 KB at P 64 / N 128 and 185 KB at P = N = 128 (one block
// per SM), raised through cudaFuncSetAttribute at every launch.
//
// The tensor-core body.  mma.sync m16n8k16 (bf16 in, fp32 sums) for all
// four products.  x, B and C enter as the bf16 values they are, so C . B^T
// is exact; each operand formed in fp32 -- G' = (C . B^T) o L o dt, the
// carried state S, and x o w of the state update (w_j = dt_j exp(total -
// cum_j)) -- is split into hi = bf16(v) and lo = bf16(v - hi) and
// multiplied twice: rounding it once would put y ~2e-3 of max |y| off,
// the split keeps ~2^-16 (ref.py `ssd_scan_split_ref` repeats these
// roundings).  One block of 8 warps per (head, sequence), two blocks an
// SM at P <= 64 (128 registers a thread, 99,328 bytes of shared memory at
// P 64 / N 128).  The state lives in registers, as the update's
// accumulator fragments, across the chunk loop.  Per chunk: the state is
// written to shared memory as bf16 hi + lo and scaled by exp(total) in
// place; then the chunk's rows in output tiles of 128, 16 a warp.  A tile
// loads its C (cp.async), and while its first key stage is in flight each
// warp forms exp(cum_i) (C . S_hi^T + C . S_lo^T); then its key rows
// stream in stages of 32 (B, and x), double-buffered, each stage giving
// the scores C . B^T of a warp's rows, G' on the fragments (exp2 of the
// cum difference; masked only on the diagonal stage), and G'_hi . x +
// G'_lo . x; a warp skips the stages past its rows.  The chunk's last tile
// visits every key stage, so it also runs the state update S += (x o
// w)_hi^T . B + (x o w)_lo^T . B: no second pass over B and x.  Rows of
// bf16 are padded by 16 bytes so that ldmatrix reads distinct banks.
// 2.92e11 tensor FLOP at the prefill (the split's extra products
// included), 1.41 ms on an H100 SXM at 700 W (PERF.md §6): shared-memory
// reads of the operands each warp re-reads, and waits, not the tensor
// rate, set the pace.  C . B^T is formed per head: blocks of 2 heads
// sharing it were slower (one block an SM), and 4 do not fit a block's
// shared memory (PERF.md §6).
//
// Shapes taken: Q from 1 to 256; P and N multiples of 8 up to 128; x, B
// and C all fp32 or all bf16; dt and A fp32.  The tensor-core body loads
// by cp.async when x, B and C are 16-byte aligned with strides of 8
// elements, and by plain loads otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "_hopper.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kT = 64;         // rows per tile
constexpr int kMaxQ = 256;     // rows per chunk
constexpr int kMaxPN = 128;    // largest P and N
constexpr int GL = kT + 4;     // padded row of G

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
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int64_t row_stride, int64_t first,
                                          int rows, int width,
                                          const float* scale) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int r = ty; r < kT; r += 16) {
    const bool live = r < rows;
    const float f = live && scale ? scale[r] : 1.f;
    const float* row = src + (first + r) * row_stride;
    for (int c = tx; c < width; c += 16)
      dst[r * ld + c] = live ? row[c] * f : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, float* __restrict__ y,
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
  const float* xb = x + b * xs.b + h * xs.h;
  const float* Bb = Bm + b * bs.b;
  const float* Cb = Cm + b * cs.b;
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

cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* Bm, const float* Cm, float* y, float* state,
                   Strides3 xs, Strides3 ds, Strides3 bs, Strides3 cs, int B,
                   int S, int H, int P, int N, int Q, cudaStream_t stream) {
  const size_t bytes = smem_floats(P, N) * sizeof(float);
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(kMaxPN, kMaxPN) * sizeof(float)));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  ssd_scan_kernel<<<grid, kThreads, bytes, stream>>>(x, dt, A, Bm, Cm, y, state, xs, ds,
                                                     bs, cs, S, H, P, N, Q);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// The bf16 body: mma.sync m16n8k16 tensor cores, fp32 sums, split operands.
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kRows = 128;  // output rows a tile: 16 a warp
constexpr int kKeys = 32;   // key rows a stage of the cp.async double buffer

// Shared memory for runtime P and N (byte offsets).  Rows of C, B and the
// state copies hold N16 + 8 bf16 and rows of x P16 + 8 (N16, P16: N and P
// rounded up to 16, the mma depth): 16 bytes more than a multiple of 32
// bytes, so the 8 rows an ldmatrix reads fall in distinct banks.
struct Plan {
  int n16, p16, nl, xl;
  size_t cs, bs, xs, sh, sl, fl, bytes;
};

__host__ __device__ inline Plan plan(int P, int N) {
  Plan s;
  s.n16 = (N + 15) & ~15;
  s.p16 = (P + 15) & ~15;
  s.nl = s.n16 + 8;
  s.xl = s.p16 + 8;
  size_t o = 0;
  s.cs = o, o += (size_t)kRows * s.nl * 2;          // C, one output tile
  s.bs = o, o += (size_t)2 * kKeys * s.nl * 2;      // B, two stages
  s.xs = o, o += (size_t)2 * kKeys * s.xl * 2;      // x, two stages
  s.sh = o, o += (size_t)s.p16 * s.nl * 2;          // the state (P, N), bf16 hi
  s.sl = o, o += (size_t)s.p16 * s.nl * 2;          // and lo
  s.fl = o, o += (size_t)3 * kMaxQ * 4;             // cum, dt, w
  s.bytes = o;
  return s;
}

// the largest P and N an instance takes: 64 or 128
constexpr int width_of(int w) { return w <= 64 ? 64 : 128; }

// blocks an SM the launch bounds ask for: two of 8 warps (16 warps) where
// the registers (128 a thread: y's 16 x P and the state's share) and
// shared memory allow
template <int PM>
struct MinBlocks {
  static constexpr int value = PM == 64 ? 2 : 1;
};

constexpr float kLog2e = 1.4426950408889634f;

// rows [0, rows) of `cols` bf16 (a multiple of 8) at src (rows `stride`
// elements apart) into dst rows of `ld`, in 16-byte pieces up to `width`
// columns; rows at or past `live` and columns at or past `cols` as zeros.
// cp.async when the source is 16-byte aligned, else plain loads.
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          int64_t stride, int rows, int live,
                                          int cols, int width, bool aligned) {
  const int cpr = width / 8;
  for (int i = threadIdx.x; i < rows * cpr; i += kThreads) {
    const int r = i / cpr, c = i - r * cpr;
    const bool ok = r < live && c * 8 < cols;
    bf16* d = dst + r * ld + c * 8;
    const bf16* s = src + r * stride + c * 8;
    if (aligned) {
      hopper::cp_async16(d, ok ? s : src, ok);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (ok) {
        const uint16_t* h = reinterpret_cast<const uint16_t*>(s);
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = h[2 * k] | (uint32_t)h[2 * k + 1] << 16;
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// v as hi + lo, both bf16: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = hopper::pack_bf16(a - hf.x, b - hf.y);
}

// Grid (H, B); 8 warps.  Block (h, b) scans head h of sequence b.  Per
// chunk: the state (registers) is copied to shared memory as bf16 hi + lo
// and scaled by exp(total) in place; then the chunk's rows in output tiles
// of 128, each warp owning 16 rows.  For a tile, the key rows stream in
// stages of 32 (B and x) by cp.async, the next stage in flight while this
// one is multiplied:
//   y   = exp(cum_i) (C . S_hi^T + C . S_lo^T)           at the first stage
//       + sum over stages of G'_hi . x + G'_lo . x,  G' = (C . B^T) o L o dt
// and, on the chunk's last tile (whose stages cover every key row), the
// state update S += (x o w)_hi^T . B + (x o w)_lo^T . B.
template <int PM, int NM, bool EXACT>
__global__ void __launch_bounds__(kThreads, MinBlocks<PM>::value)
    ssd_scan_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ state, Strides3 xs, Strides3 ds, Strides3 bs,
                Strides3 cs, int S, int H, int P, int N, int Q, int aligned) {
  constexpr int MG = PM / 16;            // 16-row groups of the state's P axis
  constexpr int NTW = NM / 8 / (8 / MG);  // state n-tiles a warp
  const Plan pl = plan(P, N);
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  bf16* Cs = reinterpret_cast<bf16*>(base + pl.cs);
  bf16* Bs = reinterpret_cast<bf16*>(base + pl.bs);
  bf16* Xs = reinterpret_cast<bf16*>(base + pl.xs);
  bf16* Sh = reinterpret_cast<bf16*>(base + pl.sh);
  bf16* Sl = reinterpret_cast<bf16*>(base + pl.sl);
  float* cum = reinterpret_cast<float*>(base + pl.fl);  // [kMaxQ]
  float* dts = cum + kMaxQ;                             // [kMaxQ]
  float* wts = dts + kMaxQ;  // [kMaxQ] dt_j exp(total - cum_j), 0 past q
  const int nl = pl.nl, xl = pl.xl, n16 = pl.n16;

  const int h = blockIdx.x, b = blockIdx.y;
  const float Ah = A[h];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qr = lane / 4, qc = lane % 4;  // fragment row and column pair
  const bool al = aligned != 0;
  const bf16* xb = x + b * xs.b + (int64_t)h * xs.h;
  const bf16* Bb = Bm + b * bs.b;
  const bf16* Cb = Cm + b * cs.b;
  const float* db = dt + b * ds.b + (int64_t)h * ds.h;

  // this warp's share of the state: P rows [pm 16, pm 16 + 16), n-tiles
  // [nt0, nt0 + NTW) of 8 columns; fragment (row qr (+8), columns 2 qc, +1)
  const int pm = warp % MG, nt0 = (warp / MG) * NTW;
  float st[NTW][4];
#pragma unroll
  for (int t = 0; t < NTW; ++t) st[t][0] = st[t][1] = st[t][2] = st[t][3] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int q = min(Q, S - c0);
    __syncthreads();  // the previous chunk is done with cum, dts, wts, Sh, Sl
    for (int j = threadIdx.x; j < kMaxQ; j += kThreads) {
      const float d = j < q ? db[(int64_t)(c0 + j) * ds.s] : 0.f;
      dts[j] = d;
      cum[j] = d * Ah;
    }
    __syncthreads();
    if (warp == 0) {  // inclusive cumsum of a over the chunk
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
    for (int j = threadIdx.x; j < kMaxQ; j += kThreads)
      wts[j] = j < q ? dts[j] * expf(total - cum[j]) : 0.f;
    if (c0 > 0 && pm * 16 < pl.p16) {
      // the state carried into this chunk, as bf16 hi + lo for C . S^T,
      // then scaled by exp(total) for this chunk's update
      const float decay = expf(total);
#pragma unroll
      for (int t = 0; t < NTW; ++t) {
        const int n = (nt0 + t) * 8 + 2 * qc;
        if (n < n16) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = pm * 16 + qr + 8 * r;
            uint32_t hi, lo;
            split2(st[t][2 * r], st[t][2 * r + 1], hi, lo);
            const size_t o = (size_t)p * nl + n;
            *reinterpret_cast<uint32_t*>(Sh + o) = hi;
            *reinterpret_cast<uint32_t*>(Sl + o) = lo;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) st[t][e] *= decay;
      }
    }

    for (int i0 = 0; i0 < q; i0 += kRows) {
      const bool last = i0 + kRows >= q;  // this tile's stages cover the chunk
      const int nk = (min(i0 + kRows, q) + kKeys - 1) / kKeys;
      const int r0 = i0 + warp * 16;  // this warp's first row (in the chunk)
      const int ia = r0 + qr, ib = ia + 8;
      float acc[PM / 8][4];
#pragma unroll
      for (int t = 0; t < PM / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

      auto load_stage = [&](int jt) {
        const int j0 = jt * kKeys, buf = jt & 1;
        load_tile(Bs + buf * kKeys * nl, nl, Bb + (int64_t)(c0 + j0) * bs.s, bs.s, kKeys,
                  q - j0, N, n16, al);
        load_tile(Xs + buf * kKeys * xl, xl, xb + (int64_t)(c0 + j0) * xs.s, xs.s, kKeys,
                  q - j0, P, pl.p16, al);
      };
      load_tile(Cs, nl, Cb + (int64_t)(c0 + i0) * cs.s, cs.s, kRows, q - i0, N, n16, al);
      hopper::cp_async_commit();
      load_stage(0);
      hopper::cp_async_commit();
      const bf16* crow = Cs + (warp * 16 + lane % 16) * nl + (lane / 16) * 8;

      if (c0 > 0) {  // the carried state's share, while stage 0 is in flight
        hopper::cp_async_wait<1>();  // C has landed
        __syncthreads();
        if (r0 < q) {
          // exp(cum_i) (C . S_hi^T + C . S_lo^T)
#pragma unroll
          for (int kk = 0; kk < NM / 16; ++kk) {
            if (!EXACT && kk * 16 >= n16) break;
            uint32_t a[4];
            hopper::ldmatrix_x4(a, crow + kk * 16);
            const size_t so = kk * 16 + ((lane / 8) % 2) * 8 +
                              (size_t)((lane / 16) * 8 + lane % 8) * nl;
#pragma unroll
            for (int t = 0; t < PM / 8; t += 2) {
              if (!EXACT && t * 8 >= P) break;
              uint32_t bh[4], bl[4];
              hopper::ldmatrix_x4(bh, Sh + so + (size_t)t * 8 * nl);
              hopper::ldmatrix_x4(bl, Sl + so + (size_t)t * 8 * nl);
              hopper::mma_bf16_16816(acc[t], a, bh);
              hopper::mma_bf16_16816(acc[t + 1], a, bh + 2);
              hopper::mma_bf16_16816(acc[t], a, bl);
              hopper::mma_bf16_16816(acc[t + 1], a, bl + 2);
            }
          }
          const float ea = ia < q ? expf(cum[ia]) : 0.f;
          const float eb = ib < q ? expf(cum[ib]) : 0.f;
#pragma unroll
          for (int t = 0; t < PM / 8; ++t) {
            acc[t][0] *= ea, acc[t][1] *= ea;
            acc[t][2] *= eb, acc[t][3] *= eb;
          }
        }
      }

      for (int jt = 0; jt < nk; ++jt) {
        if (jt + 1 < nk) load_stage(jt + 1);  // flies during this stage's products
        hopper::cp_async_commit();
        hopper::cp_async_wait<1>();  // C and stage jt have landed
        __syncthreads();
        const int j0 = jt * kKeys, buf = jt & 1;
        const bf16* Bt = Bs + buf * kKeys * nl;

        if (r0 < q && j0 <= r0 + 15) {
          // scores C . B^T of this warp's 16 rows against the stage's 32 keys
          float s[4][4];
#pragma unroll
          for (int t = 0; t < 4; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < NM / 16; ++kk) {
            if (!EXACT && kk * 16 >= n16) break;
            uint32_t a[4];
            hopper::ldmatrix_x4(a, crow + kk * 16);
#pragma unroll
            for (int t = 0; t < 4; t += 2) {
              uint32_t bk[4];
              hopper::ldmatrix_x4(bk, Bt + (t * 8 + (lane / 16) * 8 + lane % 8) * nl +
                                          kk * 16 + ((lane / 8) % 2) * 8);
              hopper::mma_bf16_16816(s[t], a, bk);
              hopper::mma_bf16_16816(s[t + 1], a, bk + 2);
            }
          }
          const float ca = cum[min(ia, q - 1)], cb = cum[min(ib, q - 1)];
          // G' = s exp(cum_i - cum_j) dt_j for j <= i, split hi + lo (the
          // exponent is <= 0 there; rows past q have s = 0); the mask is
          // needed only where the stage reaches past this warp's first
          // row.  The fragments of key tiles 2 k and 2 k + 1 are those of
          // k-step k.
          const bool diag = j0 + kKeys - 1 > r0;
          uint32_t gh[2][4], gl[2][4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int j = j0 + t * 8 + 2 * qc;
            const float2 cj = *reinterpret_cast<const float2*>(cum + j);
            const float2 dj = *reinterpret_cast<const float2*>(dts + j);
            float v[4] = {s[t][0] * exp2f((ca - cj.x) * kLog2e) * dj.x,
                          s[t][1] * exp2f((ca - cj.y) * kLog2e) * dj.y,
                          s[t][2] * exp2f((cb - cj.x) * kLog2e) * dj.x,
                          s[t][3] * exp2f((cb - cj.y) * kLog2e) * dj.y};
            if (diag) {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (j + (e & 1) > (e < 2 ? ia : ib)) v[e] = 0.f;
            }
            split2(v[0], v[1], gh[t / 2][(t % 2) * 2], gl[t / 2][(t % 2) * 2]);
            split2(v[2], v[3], gh[t / 2][(t % 2) * 2 + 1], gl[t / 2][(t % 2) * 2 + 1]);
          }
          const bf16* Xt = Xs + buf * kKeys * xl;
#pragma unroll
          for (int kt = 0; kt < 2; ++kt) {
            if (j0 + kt * 16 > r0 + 15) break;
#pragma unroll
            for (int t = 0; t < PM / 8; t += 2) {
              if (!EXACT && t * 8 >= P) break;
              uint32_t bv[4];
              hopper::ldmatrix_x4_trans(
                  bv, Xt + (kt * 16 + ((lane / 8) % 2) * 8 + lane % 8) * xl + t * 8 +
                          (lane / 16) * 8);
              hopper::mma_bf16_16816(acc[t], gh[kt], bv);
              hopper::mma_bf16_16816(acc[t + 1], gh[kt], bv + 2);
              hopper::mma_bf16_16816(acc[t], gl[kt], bv);
              hopper::mma_bf16_16816(acc[t + 1], gl[kt], bv + 2);
            }
          }
        }

        if (last && pm * 16 < P) {
          // the state update: S += (x o w)_hi^T . B + (x o w)_lo^T . B
          const bf16* Xt = Xs + buf * kKeys * xl;
          const float* wg = wts + j0;
#pragma unroll
          for (int kt = 0; kt < 2; ++kt) {
            // x^T's A fragment by ldmatrix.trans: rows k = key, columns m = p
            uint32_t xa[4], ah[4], alo[4];
            hopper::ldmatrix_x4_trans(
                xa, Xt + (kt * 16 + (lane / 16) * 8 + lane % 8) * xl + pm * 16 +
                        ((lane / 8) % 2) * 8);
            const int k = kt * 16 + 2 * qc;
            const float w0 = wg[k], w1 = wg[k + 1], w8 = wg[k + 8], w9 = wg[k + 9];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float2 f =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa[r]));
              split2(f.x * (r < 2 ? w0 : w8), f.y * (r < 2 ? w1 : w9), ah[r], alo[r]);
            }
#pragma unroll
            for (int t = 0; t < NTW; t += 2) {
              if (!EXACT && (nt0 + t) * 8 >= N) break;
              uint32_t bb[4];
              hopper::ldmatrix_x4_trans(
                  bb, Bt + (kt * 16 + ((lane / 8) % 2) * 8 + lane % 8) * nl +
                          (nt0 + t) * 8 + (lane / 16) * 8);
              hopper::mma_bf16_16816(st[t], ah, bb);
              hopper::mma_bf16_16816(st[t + 1], ah, bb + 2);
              hopper::mma_bf16_16816(st[t], alo, bb);
              hopper::mma_bf16_16816(st[t + 1], alo, bb + 2);
            }
          }
        }
        __syncthreads();  // this stage's buffers are refilled at the next stage
      }

      // y rows ia and ib of this warp, columns 8 t + 2 qc, +1
      float* yb = y + ((int64_t)b * S * H + h) * P;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r == 0 ? ia : ib;
        if (i >= q) continue;
        float* yr = yb + (int64_t)(c0 + i) * H * P + 2 * qc;
#pragma unroll
        for (int t = 0; t < PM / 8; ++t)
          if (EXACT || t * 8 < P)
            *reinterpret_cast<float2*>(yr + t * 8) =
                make_float2(acc[t][2 * r], acc[t][2 * r + 1]);
      }
    }
  }
  hopper::cp_async_wait<0>();

  // the final state, (B, H, P, N) fp32, from the fragments
  float* sb = state + ((int64_t)b * H + h) * P * N;
#pragma unroll
  for (int t = 0; t < NTW; ++t) {
    const int n = (nt0 + t) * 8 + 2 * qc;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = pm * 16 + qr + 8 * r;
      if (p < P && n < N)
        *reinterpret_cast<float2*>(sb + (int64_t)p * N + n) =
            make_float2(st[t][2 * r], st[t][2 * r + 1]);
    }
  }
}

template <int PM, int NM, bool EXACT>
cudaError_t launch_tc(const bf16* x, const float* dt, const float* A, const bf16* Bm,
                      const bf16* Cm, float* y, float* state, Strides3 xs, Strides3 ds,
                      Strides3 bs, Strides3 cs, int B, int S, int H, int P, int N, int Q,
                      int aligned, cudaStream_t stream) {
  auto kernel = ssd_scan_tc<PM, NM, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)plan(PM, NM).bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, plan(P, N).bytes, stream>>>(
      x, dt, A, Bm, Cm, y, state, xs, ds, bs, cs, S, H, P, N, Q, aligned);
  return cudaGetLastError();
}

template <int PM, int NM>
int occupancy(int P, int N, int64_t* out) {
  auto kernel = ssd_scan_tc<PM, NM, false>;
  const size_t bytes = plan(P, N).bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)plan(PM, NM).bytes);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, bytes);
  out[0] = (int64_t)bytes;
  out[1] = MinBlocks<PM>::value;
  out[2] = blocks;
  out[3] = kThreads / 32;
  return err;
}

// P and N as an instance takes them: the largest widths (64 or 128) and
// whether P and N are exactly those (the loops then have no edge guards)
template <typename F>
cudaError_t dispatch(int P, int N, F&& go) {
  const int pm = width_of(P), nm = width_of(N);
  const bool exact = P == pm && N == nm;
  if (pm == 64 && nm == 64)
    return exact ? go(launch_tc<64, 64, true>) : go(launch_tc<64, 64, false>);
  if (pm == 64)
    return exact ? go(launch_tc<64, 128, true>) : go(launch_tc<64, 128, false>);
  if (nm == 64)
    return exact ? go(launch_tc<128, 64, true>) : go(launch_tc<128, 64, false>);
  return exact ? go(launch_tc<128, 128, true>) : go(launch_tc<128, 128, false>);
}

}  // namespace tc

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
    return launch(static_cast<const float*>(x), dtf, Af, static_cast<const float*>(Bm),
                  static_cast<const float*>(Cm), yf, sf, xs, ds, bs, cs, (int)B, (int)S,
                  (int)H, (int)P, (int)N, (int)Q, s);
  if (dtype == 1) {
    using tc::bf16;
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* bb = static_cast<const bf16*>(Bm);
    const bf16* cb = static_cast<const bf16*>(Cm);
    // cp.async takes 16-byte pieces: aligned bases, strides multiples of 8
    const int aligned =
        ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
          reinterpret_cast<uintptr_t>(Cm)) % 16 == 0) &&
        ((xsb | xss | xsh | bsb | bss | csb | css) % 8 == 0);
    return tc::dispatch((int)P, (int)N, [&](auto fn) {
      return fn(xb, dtf, Af, bb, cb, yf, sf, xs, ds, bs, cs, (int)B, (int)S, (int)H,
                (int)P, (int)N, (int)Q, aligned, s);
    });
  }
  return cudaErrorInvalidValue;
}

// What the bf16 body launches for P and N (one block a head and sequence),
// for the host's plan to be held to: out[0] dynamic shared-memory bytes a
// block, out[1] blocks an SM its launch bounds ask for, out[2] blocks an
// SM that CUDA's occupancy calculator gives, out[3] warps a block.
// Returns a cudaError_t.
extern "C" int ssd_scan_tc_plan(int64_t P, int64_t N, int64_t* out) {
  if (P < 8 || P > kMaxPN || P % 8 || N < 8 || N > kMaxPN || N % 8)
    return cudaErrorInvalidValue;
  const int pm = tc::width_of((int)P), nm = tc::width_of((int)N);
  int err;
  if (pm == 64 && nm == 64)
    err = tc::occupancy<64, 64>((int)P, (int)N, out);
  else if (pm == 64)
    err = tc::occupancy<64, 128>((int)P, (int)N, out);
  else if (nm == 64)
    err = tc::occupancy<128, 64>((int)P, (int)N, out);
  else
    err = tc::occupancy<128, 128>((int)P, (int)N, out);
  return err;
}
