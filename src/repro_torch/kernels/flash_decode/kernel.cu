// One-token GQA attention against a KV cache (flash decode), for Hopper.
//
// Replaces the Pallas kernel `flash_decode_kernel`
// (src/repro/kernels/flash_decode/kernel.py:26-63, pallas_call at :101)
// and the cache transposes of its wrapper (ops.py:34-35): the cache is read
// in place in the model's (B, S, K, D) layout, through its strides, so no
// step copies it.
//
// What it computes.  For sequence b and head h = kh * G + g,
//   out = softmax_{j < lens[b]}(q . k_j * scale) . v_j   over kv head kh.
// Numerics as the TPU kernel: q taken to fp32 and scaled in fp32, fp32
// scores, online softmax with fp32 m, l and accumulator, p rounded to the
// cache dtype before the PV product, out = acc / max(l, 1e-30).  Positions
// at or past lens[b] are never read (the TPU kernel reads and masks them
// with -1e30; the result is the same for lens[b] >= 1).
//
// Bound.  Bytes: each live cache row is read once, sum_b lens[b] * K * D *
// 2 tensors * element size; the operations (4 * H * D per live position)
// are ~1 per byte, far below the card's ratio.
//
// Design.  lens[b] is read by each block from device memory (the TPU's
// scalar prefetch).  B * K blocks alone (96 at smollm-135m's decode batch
// of 32) would leave most of the 132 SMs idle, so the kv axis is split:
// block (split, kh, b) takes positions [split * chunk, (split+1) * chunk)
// and writes its partial (m, l, acc); a second kernel merges the splits
// (skipped when there is one split).  Inside a block, LP lanes read one
// cache row as 16-byte vectors (a whole 128-byte row for D = 64 in bf16),
// so a warp reads 32 / LP rows per step, coalesced; each group of LP lanes
// keeps its own online softmax over its rows for all G heads (partial
// dot products reduced by xor shuffles inside the group), and the block's
// groups are merged through shared memory at the end.  The G query heads
// are held in registers GM (4 or 8) at a time; a larger G walks the rows
// once per group of 8, so any G is taken.  Plain fp32 FMAs.  D is 16, 32,
// 64, 128 or 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
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

// Unpack one 16-byte vector of T into floats.
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

struct Strides {  // in elements; the D axis is contiguous
  int64_t b, s, h;
};

template <typename T, int D>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);                      // per vector
  static constexpr int LP = (D / VEC) < 32 ? (D / VEC) : 32;      // lanes/row
  static constexpr int EPL = D / LP;                              // per lane
  static constexpr int NV = EPL / VEC;                            // vectors
  static constexpr int RPW = 32 / LP;                             // rows/warp
  static constexpr int GROUPS = kWarps * RPW;
};

template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ lens, T* __restrict__ out,
                        float* __restrict__ part_o, float* __restrict__ part_m,
                        float* __restrict__ part_l, Strides qs, Strides ks,
                        Strides vs, Strides os, int S, int K, int G,
                        int chunk, int nsplit, float scale) {
  using L = Layout<T, D>;
  constexpr int EPL = L::EPL, VEC = L::VEC;
  __shared__ float sm_m[L::GROUPS][GM], sm_l[L::GROUPS][GM];
  __shared__ float sm_o[L::GROUPS][GM][D];

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp * L::RPW + lane / L::LP, sub = lane % L::LP;
  const int len = min(max(lens[b], 0), S);
  const int lo = split * chunk, hi = min(lo + chunk, len);

  const int64_t part = ((int64_t)b * K + kh) * nsplit + split;

  // the G heads in register groups of GM: each group walks the block's
  // rows again (from L2 after the first), so any G is taken
  for (int g0 = 0; g0 < G; g0 += GM) {
    const int gn = min(GM, G - g0);  // heads in this group
    float qr[GM][EPL], acc[GM][EPL], m[GM], l[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m[g] = kNeg;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        acc[g][e] = 0.f;
        qr[g][e] = g < gn ? to_float(q[b * qs.b + (kh * G + g0 + g) * qs.h +
                                       sub * EPL + e]) * scale
                          : 0.f;
      }
    }

    // warp-uniform trip count (the shuffles need every lane); a lane whose
    // row is past `hi` reads nothing and leaves its state as it is
    for (int base = lo + warp * L::RPW; base < hi; base += L::GROUPS) {
      const int pos = base + lane / L::LP;
      const bool live = pos < hi;
      float kr[EPL], vr[EPL];
      if (live) {
        const uint4* kp = reinterpret_cast<const uint4*>(
            k + b * ks.b + pos * ks.s + kh * ks.h + sub * EPL);
        const uint4* vp = reinterpret_cast<const uint4*>(
            v + b * vs.b + pos * vs.s + kh * vs.h + sub * EPL);
#pragma unroll
        for (int n = 0; n < L::NV; ++n) {
          unpack(__ldg(kp + n), kr + n * VEC, T());
          unpack(__ldg(vp + n), vr + n * VEC, T());
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[e] = vr[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= gn) break;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s = fmaf(qr[g][e], kr[e], s);
#pragma unroll
        for (int o = L::LP / 2; o > 0; o /= 2)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (live) {
          const float m_new = fmaxf(m[g], s);
          const float corr = expf(m[g] - m_new);
          const float p = expf(s - m_new);
          const float pr = to_float(from_float<T>(p));
          l[g] = l[g] * corr + p;
          m[g] = m_new;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pr, vr[e], acc[g][e] * corr);
        }
      }
    }

    // merge the block's groups
    __syncthreads();  // the previous head group's merge is done with sm_*
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (sub == 0) {
        sm_m[grp][g] = m[g];
        sm_l[grp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_o[grp][g][sub * EPL + e] = acc[g][e];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < gn * D; i += kThreads) {
      const int g = i / D, d = i - (i / D) * D, h = g0 + g;
      float M = kNeg;
      for (int r = 0; r < L::GROUPS; ++r) M = fmaxf(M, sm_m[r][g]);
      float Ls = 0.f, A = 0.f;
      for (int r = 0; r < L::GROUPS; ++r) {
        const float w = expf(sm_m[r][g] - M);
        Ls = fmaf(sm_l[r][g], w, Ls);
        A = fmaf(sm_o[r][g][d], w, A);
      }
      if (nsplit == 1) {
        out[b * os.b + (kh * G + h) * os.h + d] = from_float<T>(A / fmaxf(Ls, 1e-30f));
      } else {
        part_o[(part * G + h) * D + d] = A;
        if (d == 0) {
          part_m[part * G + h] = M;
          part_l[part * G + h] = Ls;
        }
      }
    }
  }
}

// Merge the splits of one (kh, b): out = sum_s w_s acc_s / sum_s w_s l_s.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_decode_combine(const float* __restrict__ part_o,
                         const float* __restrict__ part_m,
                         const float* __restrict__ part_l, T* __restrict__ out,
                         Strides os, int K, int G, int D, int nsplit) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int64_t first = ((int64_t)b * K + kh) * nsplit;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i - (i / D) * D;
    float M = kNeg;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, part_m[(first + s) * G + g]);
    float Ls = 0.f, A = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(part_m[(first + s) * G + g] - M);
      Ls = fmaf(part_l[(first + s) * G + g], w, Ls);
      A = fmaf(part_o[(first + s) * G * D + i], w, A);
    }
    out[b * os.b + (kh * G + g) * os.h + d] = from_float<T>(A / fmaxf(Ls, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v;
  const int32_t* lens;
  void* out;
  float *part_o, *part_m, *part_l;
  Strides qs, ks, vs, os;
  int B, S, K, G, nsplit;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int GM>
cudaError_t launch(const Args& a) {
  const int chunk = (a.S + a.nsplit - 1) / a.nsplit;
  flash_decode_kernel<T, D, GM><<<dim3(a.nsplit, a.K, a.B), kThreads, 0,
                                  a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.lens, static_cast<T*>(a.out), a.part_o,
      a.part_m, a.part_l, a.qs, a.ks, a.vs, a.os, a.S, a.K, a.G, chunk,
      a.nsplit, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  flash_decode_combine<T><<<dim3(a.K, a.B), kThreads, 0, a.stream>>>(
      a.part_o, a.part_m, a.part_l, static_cast<T*>(a.out), a.os, a.K, a.G,
      D, a.nsplit);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(const Args& a) {
  if (a.G <= 4) return launch<T, D, 4>(a);
  return launch<T, D, 8>(a);  // groups of 8 heads, the last one partial
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a) {
  switch (D) {
    case 16:
      return dispatch_g<T, 16>(a);
    case 32:
      return dispatch_g<T, 32>(a);
    case 64:
      return dispatch_g<T, 64>(a);
    case 128:
      return dispatch_g<T, 128>(a);
    case 256:
      return dispatch_g<T, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (bound with ctypes).  q (B, 1, K * G, D); k and v caches
// (B, S, K, D); lens (B,) int32 on the device; out (B, 1, K * G, D); all
// with a contiguous D axis, and the caches' rows 16-byte aligned.  With
// nsplit > 1, part_o (B * K * nsplit * G * D), part_m and part_l
// (B * K * nsplit * G) are fp32 scratch.  dtype 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launches (0 on success);
// cudaErrorInvalidValue (1) for a shape the kernel has no instance for.
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const void* lens, void* out,
    void* part_o, void* part_m, void* part_l, int64_t B, int64_t S,
    int64_t K, int64_t G, int64_t D, int64_t qsb, int64_t qsh, int64_t ksb,
    int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
    int64_t osb, int64_t osh, int64_t nsplit, float scale, int64_t dtype,
    void* stream) {
  if (nsplit < 1 || G < 1) return cudaErrorInvalidValue;
  if (B <= 0 || K <= 0) return cudaSuccess;
  Args a{q,
         k,
         v,
         static_cast<const int32_t*>(lens),
         out,
         static_cast<float*>(part_o),
         static_cast<float*>(part_m),
         static_cast<float*>(part_l),
         Strides{qsb, 0, qsh},
         Strides{ksb, kss, ksh},
         Strides{vsb, vss, vsh},
         Strides{osb, 0, osh},
         (int)B,
         (int)S,
         (int)K,
         (int)G,
         (int)nsplit,
         scale,
         static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_d<float>((int)D, a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>((int)D, a);
  return cudaErrorInvalidValue;
}
