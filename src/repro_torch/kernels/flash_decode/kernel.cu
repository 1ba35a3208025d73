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
// are ~1 per byte, far below the card's ratio, so the FMAs stay on the
// CUDA cores.  At smollm-135m's decode (B 32, ~2,100 positions, K 3, D 64,
// bf16) that is 51.6 MB, 0.0154 ms at 3.35 TB/s; reaching it takes ~25 KB
// in flight on every SM at a time (the rate times a ~1 us memory latency).
//
// Design.  Block (split, kh, b) takes positions [split * chunk, (split + 1)
// * chunk) of sequence b, kv head kh; lens[b] is read by each block from
// device memory (the TPU's scalar prefetch).  The splits of one (kh, b)
// are one thread-block cluster of nsplit <= 8 blocks (the host's plan,
// ops.py `split_plan`, picks nsplit for about two blocks an SM: fewer,
// longer blocks pay the fill of the ring and the merge less often).
// - Bytes in flight: the block streams its positions through a ring of 3
//   shared-memory stages, each TP positions of K and of V (16 KB; TP = 64
//   at D 64 in bf16, fewer positions for wider rows), copied by cp.async
//   16 bytes a thread with zeros past the split's end.  Two stages are in
//   flight while the third is scored: 32 KB a block; launch bounds of four
//   blocks an SM (16 warps, 128 KB in flight) for latency hiding, two when
//   eight heads share a pass.
// - Scoring from shared memory: LP lanes read one cache row as 16-byte
//   vectors (a whole 128-byte row for D = 64 in bf16, so reads are free of
//   bank conflicts), so a warp covers 32 / LP rows; each group of LP lanes
//   keeps its own online softmax for the G heads and takes its J = TP /
//   groups rows of a stage at once: J x G partial dot products reduced by
//   xor shuffles inside the group, independent of one another, then one
//   softmax step for the stage (a row at a time made each lane wait on a
//   chain of shuffles and two expf per row and head: 29% of the byte
//   bound).  Scores are kept in base 2 (q prescaled by scale x log2 e,
//   exp2f), which is exp of the same fp32 scores up to rounding.  The G
//   query heads are held in registers GM (2, 3, 4 or 8) at a time; a
//   larger G streams the positions once per group of 8, so any G is taken.
// - One launch: the block's groups are merged through shared memory (over
//   the ring, which is free by then) into the block's partial (m, l, acc);
//   after a cluster barrier, the cluster's threads read every split's
//   partial through distributed shared memory and merge them in split
//   order, each output by one thread: no second kernel, no fp32 scratch in
//   device memory, no atomics, and the result does not depend on timing.
// One template over T (float or bfloat16) and D (16, 32, 64, 128 or 256).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "_hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int kStageBytes = 16384;  // K and V of one stage
constexpr int kMaxSplits = 8;       // a portable cluster
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

template <typename T, int D, int GM>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);                      // per vector
  static constexpr int LP = (D / VEC) < 32 ? (D / VEC) : 32;      // lanes/row
  static constexpr int EPL = D / LP;                              // per lane
  static constexpr int NV = EPL / VEC;                            // vectors
  static constexpr int RPW = 32 / LP;                             // rows/warp
  static constexpr int GROUPS = kWarps * RPW;
  static constexpr int ROW = D * sizeof(T);                       // bytes
  // positions a stage: kStageBytes of K and V, at least one step of the
  // block's groups, at most 128
  static constexpr int TP_BYTES = kStageBytes / (2 * ROW);
  static constexpr int TP = TP_BYTES < GROUPS ? GROUPS : (TP_BYTES > 128 ? 128 : TP_BYTES);
  static constexpr int STAGE = 2 * TP * ROW;  // K rows, then V rows
  static constexpr int RING = kStages * STAGE;
  // after the last stage, over the ring: the merge of the block's groups
  // (m, l, acc of each), then the block's partial (m, l, acc) for the
  // cluster's merge
  static constexpr int MERGE = (2 * GROUPS * GM + GROUPS * GM * D) * 4;
  static constexpr int PART_OFFSET = MERGE;
  static constexpr int PART_END = MERGE + (2 * GM + GM * D) * 4;
  static constexpr int SMEM = RING > PART_END ? RING : PART_END;
  static_assert(TP % GROUPS == 0 && STAGE % (16 * kThreads) == 0, "stage shape");
};

// at most 128 registers a thread for four blocks an SM; eight heads a pass
// (G > 4) need more and take two blocks an SM
template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads, GM > 4 ? 2 : 4)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int32_t* __restrict__ lens,
                        T* __restrict__ out, Strides qs, Strides ks, Strides vs,
                        Strides os, int S, int G, int chunk, float scale) {
  using L = Layout<T, D, GM>;
  constexpr int EPL = L::EPL, VEC = L::VEC;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sm_m = reinterpret_cast<float*>(smem);  // [GROUPS][GM]
  float* sm_l = sm_m + L::GROUPS * GM;          // [GROUPS][GM]
  float* sm_o = sm_l + L::GROUPS * GM;          // [GROUPS][GM][D]
  float* pm = reinterpret_cast<float*>(smem + L::PART_OFFSET);  // [GM]
  float* pl = pm + GM;                                          // [GM]
  float* po = pl + GM;                                          // [GM][D]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, nsplit = gridDim.x, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp * L::RPW + lane / L::LP, sub = lane % L::LP;
  const int len = min(max(lens[b], 0), S);
  const int lo = split * chunk, hi = min(lo + chunk, len);
  const int n_stages = hi > lo ? (hi - lo + L::TP - 1) / L::TP : 0;
  const uint8_t* kb = reinterpret_cast<const uint8_t*>(k + b * ks.b + kh * ks.h);
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(v + b * vs.b + kh * vs.h);
  const float scale2 = scale * kLog2e;  // scores in base 2: exp(x) = exp2(x log2 e)

  // stage i (positions lo + i * TP ...) into ring slot i % kStages; rows at
  // or past hi are zeros and read nothing
  auto load_stage = [&](int i) {
    uint8_t* dst = smem + (i % kStages) * L::STAGE;
    constexpr int PER_ROW = L::ROW / 16, HALF = L::TP * PER_ROW;
#pragma unroll
    for (int j = 0; j < 2 * HALF / kThreads; ++j) {
      const int c = threadIdx.x + j * kThreads;
      const int kv = c / HALF, r = c % HALF / PER_ROW, w = c % PER_ROW;
      const int pos = lo + i * L::TP + r;
      const bool ok = pos < hi;
      const uint8_t* src = kv ? vb + (ok ? pos : lo) * vs.s * (int64_t)sizeof(T)
                              : kb + (ok ? pos : lo) * ks.s * (int64_t)sizeof(T);
      hopper::cp_async16(dst + c * 16, src + w * 16, ok);
    }
  };

  for (int g0 = 0; g0 < G; g0 += GM) {
    for (int i = 0; i < kStages - 1; ++i) {  // the ring fills while q is read
      if (i < n_stages) load_stage(i);
      hopper::cp_async_commit();
    }
    // heads g0 .. g0 + GM - 1; those past G (the last group's) run on a zero
    // q and are not stored
    const int gn = min(GM, G - g0);
    float qr[GM][EPL], acc[GM][EPL], m[GM], l[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m[g] = kNeg;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        acc[g][e] = 0.f;
        qr[g][e] = g < gn ? to_float(q[b * qs.b + (kh * G + g0 + g) * qs.h +
                                       sub * EPL + e]) * scale2
                          : 0.f;
      }
    }

    for (int i = 0; i < n_stages; ++i) {
      hopper::cp_async_wait<kStages - 2>();  // stage i has landed (this thread's part)
      __syncthreads();  // ... every thread's part; slot (i - 1) % kStages is free
      if (i + kStages - 1 < n_stages) load_stage(i + kStages - 1);
      hopper::cp_async_commit();
      const uint8_t* st = smem + (i % kStages) * L::STAGE;
      // the group's J rows of the stage (r = grp + j * GROUPS) at once: J x
      // GM dot products, reduced over the row's LP lanes by xor shuffles
      // (the same trip count on every lane), then one online-softmax step
      // for the stage; a row past hi was filled with zeros and is masked
      constexpr int J = L::TP / L::GROUPS;
      float s[J][GM];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const uint4* kp =
            reinterpret_cast<const uint4*>(st + (grp + j * L::GROUPS) * L::ROW) + sub * L::NV;
        float kr[EPL];
#pragma unroll
        for (int n = 0; n < L::NV; ++n) unpack(kp[n], kr + n * VEC, T());
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          s[j][g] = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) s[j][g] = fmaf(qr[g][e], kr[e], s[j][g]);
        }
      }
#pragma unroll
      for (int o = L::LP / 2; o > 0; o /= 2)
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int g = 0; g < GM; ++g) s[j][g] += __shfl_xor_sync(0xffffffffu, s[j][g], o);
      const int p0 = lo + i * L::TP + grp;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float m_new = m[g];
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (p0 + j * L::GROUPS < hi) m_new = fmaxf(m_new, s[j][g]);
        const float corr = exp2f(m[g] - m_new);
        m[g] = m_new;
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float p = p0 + j * L::GROUPS < hi ? exp2f(s[j][g] - m_new) : 0.f;
          l[g] += p;
          s[j][g] = to_float(from_float<T>(p));  // p in the cache dtype, for PV
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const uint4* vp = reinterpret_cast<const uint4*>(
                              st + (L::TP + grp + j * L::GROUPS) * L::ROW) + sub * L::NV;
        float vr[EPL];
#pragma unroll
        for (int n = 0; n < L::NV; ++n) unpack(vp[n], vr + n * VEC, T());
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(s[j][g], vr[e], acc[g][e]);
      }
    }
    hopper::cp_async_wait<0>();
    __syncthreads();  // every stage is read: the ring takes the merge

    // merge the block's groups into the block's partial
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (sub == 0) {
        sm_m[grp * GM + g] = m[g];
        sm_l[grp * GM + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_o[(grp * GM + g) * D + sub * EPL + e] = acc[g][e];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < gn * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      float M = kNeg;
      for (int r = 0; r < L::GROUPS; ++r) M = fmaxf(M, sm_m[r * GM + g]);
      float Ls = 0.f, A = 0.f;
      for (int r = 0; r < L::GROUPS; ++r) {
        const float w = exp2f(sm_m[r * GM + g] - M);
        Ls = fmaf(sm_l[r * GM + g], w, Ls);
        A = fmaf(sm_o[(r * GM + g) * D + d], w, A);
      }
      po[i] = A;
      if (d == 0) {
        pm[g] = M;
        pl[g] = Ls;
      }
    }

    // merge the cluster's splits, in split order: out = sum_s w_s acc_s /
    // sum_s w_s l_s; each output by one thread of the cluster
    cluster.sync();  // every split's partial is written
    for (int i = split * kThreads + threadIdx.x; i < gn * D; i += nsplit * kThreads) {
      const int g = i / D, d = i - g * D;
      float M = kNeg;
      for (int s = 0; s < nsplit; ++s) M = fmaxf(M, cluster.map_shared_rank(pm, s)[g]);
      float Ls = 0.f, A = 0.f;
      for (int s = 0; s < nsplit; ++s) {
        const float w = exp2f(cluster.map_shared_rank(pm, s)[g] - M);
        Ls = fmaf(cluster.map_shared_rank(pl, s)[g], w, Ls);
        A = fmaf(cluster.map_shared_rank(po, s)[i], w, A);
      }
      out[b * os.b + (kh * G + g0 + g) * os.h + d] = from_float<T>(A / fmaxf(Ls, 1e-30f));
    }
    cluster.sync();  // no block refills its ring or exits while its partial is read
  }
}

struct Args {
  const void *q, *k, *v;
  const int32_t* lens;
  void* out;
  Strides qs, ks, vs, os;
  int B, S, K, G, nsplit;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int GM>
cudaError_t launch(const Args& a) {
  using L = Layout<T, D, GM>;
  auto kernel = flash_decode_kernel<T, D, GM>;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (allowed != cudaSuccess) return allowed;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nsplit, a.K, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int chunk = (a.S + a.nsplit - 1) / a.nsplit;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a.q),
                            static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.lens,
                            static_cast<T*>(a.out), a.qs, a.ks, a.vs, a.os, a.S, a.G, chunk,
                            a.scale);
}

template <typename T, int D>
cudaError_t dispatch_g(const Args& a) {
  if (a.G <= 2) return launch<T, D, 2>(a);
  if (a.G == 3) return launch<T, D, 3>(a);
  if (a.G == 4) return launch<T, D, 4>(a);
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

// the stage plan of the instance dispatch_g picks for G
template <typename T, int D, int GM>
void stage_of(int64_t* out) {
  using L = Layout<T, D, GM>;
  out[0] = L::TP;
  out[1] = kStages;
  out[2] = L::SMEM;
}

template <typename T, int D>
void stage_of_g(int64_t G, int64_t* out) {
  if (G <= 2) return stage_of<T, D, 2>(out);
  if (G == 3) return stage_of<T, D, 3>(out);
  if (G == 4) return stage_of<T, D, 4>(out);
  stage_of<T, D, 8>(out);
}

}  // namespace

// C entry point (bound with ctypes).  q (B, 1, K * G, D); k and v caches
// (B, S, K, D); lens (B,) int32 on the device; out (B, 1, K * G, D); all
// with a contiguous D axis, and the caches' rows 16-byte aligned.  nsplit
// (1 to 8) splits of the kv axis, one cluster, merged inside the launch.
// part_o, part_m and part_l are not read (the wrapper passes null); they
// keep the signature of sources that merge through scratch in a second
// kernel, so that the bench times either through one binding.  dtype 0 =
// float32, 1 = bfloat16.  Returns the cudaError_t of the launch (0 on
// success); cudaErrorInvalidValue (1) for a shape the kernel has no
// instance for.
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const void* lens, void* out,
    void* part_o, void* part_m, void* part_l, int64_t B, int64_t S,
    int64_t K, int64_t G, int64_t D, int64_t qsb, int64_t qsh, int64_t ksb,
    int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
    int64_t osb, int64_t osh, int64_t nsplit, float scale, int64_t dtype,
    void* stream) {
  (void)part_o, (void)part_m, (void)part_l;
  if (nsplit < 1 || nsplit > kMaxSplits || G < 1 || B > 65535 || K > 65535)
    return cudaErrorInvalidValue;
  if (B <= 0 || K <= 0) return cudaSuccess;
  Args a{q,
         k,
         v,
         static_cast<const int32_t*>(lens),
         out,
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

// The stage plan of the instance for (D, G, dtype): out[0] positions a
// stage, out[1] stages in the ring, out[2] the dynamic shared memory of a
// block in bytes.  Returns cudaErrorInvalidValue when there is no instance.
extern "C" int flash_decode_stages(int64_t D, int64_t G, int64_t dtype, int64_t* out) {
  if ((dtype != 0 && dtype != 1) || G < 1) return cudaErrorInvalidValue;
  switch (D) {
    case 16:
      dtype ? stage_of_g<__nv_bfloat16, 16>(G, out) : stage_of_g<float, 16>(G, out);
      return cudaSuccess;
    case 32:
      dtype ? stage_of_g<__nv_bfloat16, 32>(G, out) : stage_of_g<float, 32>(G, out);
      return cudaSuccess;
    case 64:
      dtype ? stage_of_g<__nv_bfloat16, 64>(G, out) : stage_of_g<float, 64>(G, out);
      return cudaSuccess;
    case 128:
      dtype ? stage_of_g<__nv_bfloat16, 128>(G, out) : stage_of_g<float, 128>(G, out);
      return cudaSuccess;
    case 256:
      dtype ? stage_of_g<__nv_bfloat16, 256>(G, out) : stage_of_g<float, 256>(G, out);
      return cudaSuccess;
    default:
      return cudaErrorInvalidValue;
  }
}
