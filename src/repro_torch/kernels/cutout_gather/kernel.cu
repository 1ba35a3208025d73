// Cutout assembly from the Morton-ordered cuboid-major array, for Hopper.
//
// Replaces the Pallas kernel `cutout_gather_kernel`
// (src/repro/kernels/cutout_gather/kernel.py:30) together with the trim of
// its wrapper (src/repro/kernels/cutout_gather/ops.py:40-41): the output is
// the box [lo, hi) itself, not the cuboid-aligned box.
//
// Layout.  `packed` is (n_cells, cx, cy, cz) in C order; row `m` is the
// cuboid with Morton index m.  `plan[g]` is the Morton index of box-grid
// position g = (gxi * gy + gyi) * gz + gzi.  (ox, oy, oz) is the offset of
// the box's lo inside the cuboid-aligned box.  A time series is a rank-4
// grid: `packed` is (n_cells, cx, cy, cz, ct), g = ((gxi * gy + gyi) * gz
// + gzi) * gt + gti, and `cutout_gather4_kernel` decodes the fourth axis.
// The C entry point takes rank-4 extents; a leading unit axis (X = cx = 1,
// which is how the wrapper passes grids of rank 1-3) goes to the rank-3
// kernel with the other three, so those grids run the rank-3 code as is.
//
// Bound.  Pure data movement: the least traffic is each output byte read
// once from `packed` and written once, so the card's HBM rate bounds it.
//
// Design.  Each thread copies one *unit* of V bytes (V in 1, 2, 4, 8, 16),
// chosen by the wrapper as the widest power of two that divides the
// innermost extents and offsets in bytes and both base addresses: then no
// unit straddles a cuboid along Z and every load/store is a naturally
// aligned V-byte access (16-byte vectors for uint8 cuboids with cz = 16).
// (At rank 4 the units lie along T, the innermost axis.)
// The element size only enters through that unit conversion, so any 1-,
// 2-, 4- or 8-byte dtype passes through byte-exact.  Threads walk output
// units in C order (grid-stride), so stores coalesce along the contiguous
// Z axis; loads are contiguous within each cuboid's Z run.  All index and
// byte arithmetic is 64-bit: a 16 GiB level has cell * 262144 past 2^34.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void cutout_gather_kernel(T* __restrict__ out,
                                     const T* __restrict__ packed,
                                     const int32_t* __restrict__ plan,
                                     int64_t Y, int64_t Zu,
                                     int64_t ox, int64_t oy, int64_t ozu,
                                     int64_t cx, int64_t cy, int64_t czu,
                                     int64_t gy, int64_t gz, int64_t total) {
  const int64_t cub = cx * cy * czu;  // units per cuboid
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t zu = i % Zu;
    const int64_t row = i / Zu;
    const int64_t ay = row % Y + oy;
    const int64_t ax = row / Y + ox;
    const int64_t az = zu + ozu;
    const int64_t gxi = ax / cx, ix = ax - gxi * cx;
    const int64_t gyi = ay / cy, iy = ay - gyi * cy;
    const int64_t gzi = az / czu, iz = az - gzi * czu;
    const int64_t cell = (int64_t)__ldg(plan + (gxi * gy + gyi) * gz + gzi);
    out[i] = __ldg(packed + cell * cub + (ix * cy + iy) * czu + iz);
  }
}

template <typename T>
__global__ void cutout_gather4_kernel(T* __restrict__ out,
                                      const T* __restrict__ packed,
                                      const int32_t* __restrict__ plan,
                                      int64_t Y, int64_t Z, int64_t Tu,
                                      int64_t ox, int64_t oy, int64_t oz,
                                      int64_t otu, int64_t cx, int64_t cy,
                                      int64_t cz, int64_t ctu, int64_t gy,
                                      int64_t gz, int64_t gt, int64_t total) {
  const int64_t cub = cx * cy * cz * ctu;  // units per cuboid
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t tu = i % Tu;
    const int64_t row = i / Tu;  // (x, y, z) of the output, row-major
    const int64_t az = row % Z + oz;
    const int64_t xy = row / Z;
    const int64_t ay = xy % Y + oy;
    const int64_t ax = xy / Y + ox;
    const int64_t at = tu + otu;
    const int64_t gxi = ax / cx, ix = ax - gxi * cx;
    const int64_t gyi = ay / cy, iy = ay - gyi * cy;
    const int64_t gzi = az / cz, iz = az - gzi * cz;
    const int64_t gti = at / ctu, it = at - gti * ctu;
    const int64_t cell =
        (int64_t)__ldg(plan + ((gxi * gy + gyi) * gz + gzi) * gt + gti);
    out[i] = __ldg(packed + cell * cub + ((ix * cy + iy) * cz + iz) * ctu + it);
  }
}

template <typename T>
cudaError_t launch(void* out, const void* packed, const int32_t* plan,
                   int64_t X, int64_t Y, int64_t Zu, int64_t ox, int64_t oy,
                   int64_t ozu, int64_t cx, int64_t cy, int64_t czu,
                   int64_t gy, int64_t gz, cudaStream_t stream) {
  const int64_t total = X * Y * Zu;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride past 32 blocks/SM
  cutout_gather_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(packed), plan, Y, Zu, ox,
      oy, ozu, cx, cy, czu, gy, gz, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch4(void* out, const void* packed, const int32_t* plan,
                    int64_t X, int64_t Y, int64_t Z, int64_t Tu, int64_t ox,
                    int64_t oy, int64_t oz, int64_t otu, int64_t cx,
                    int64_t cy, int64_t cz, int64_t ctu, int64_t gy,
                    int64_t gz, int64_t gt, cudaStream_t stream) {
  const int64_t total = X * Y * Z * Tu;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  cutout_gather4_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(packed), plan, Y, Z, Tu,
      ox, oy, oz, otu, cx, cy, cz, ctu, gy, gz, gt, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(void* out, const void* packed, const int32_t* plan,
                     int64_t X, int64_t Y, int64_t Z, int64_t Tu, int64_t ox,
                     int64_t oy, int64_t oz, int64_t otu, int64_t cx,
                     int64_t cy, int64_t cz, int64_t ctu, int64_t gy,
                     int64_t gz, int64_t gt, cudaStream_t stream) {
  if (X == 1 && cx == 1)  // a leading unit axis: the rank-3 kernel
    return launch<T>(out, packed, plan, Y, Z, Tu, oy, oz, otu, cy, cz, ctu,
                     gz, gt, stream);
  return launch4<T>(out, packed, plan, X, Y, Z, Tu, ox, oy, oz, otu, cx, cy,
                    cz, ctu, gy, gz, gt, stream);
}

}  // namespace

// C entry point (bound with ctypes).  Rank-4 extents (a grid of rank 1-3
// comes with leading unit axes); all are in elements except those of the
// innermost axis (Tu, otu, ctu), which are in units of `unit_bytes`.
// Returns the cudaError_t of the launch (0 on success); -1 for a unit
// size the kernel has no instance for.
extern "C" int cutout_gather_launch(void* out, const void* packed,
                                    const void* plan, int64_t X, int64_t Y,
                                    int64_t Z, int64_t Tu, int64_t ox,
                                    int64_t oy, int64_t oz, int64_t otu,
                                    int64_t cx, int64_t cy, int64_t cz,
                                    int64_t ctu, int64_t gy, int64_t gz,
                                    int64_t gt, int64_t unit_bytes,
                                    void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0 || Tu <= 0) return 0;
  const int32_t* p = static_cast<const int32_t*>(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit_bytes) {
    case 1:
      return dispatch<uint8_t>(out, packed, p, X, Y, Z, Tu, ox, oy, oz, otu,
                               cx, cy, cz, ctu, gy, gz, gt, s);
    case 2:
      return dispatch<uint16_t>(out, packed, p, X, Y, Z, Tu, ox, oy, oz, otu,
                                cx, cy, cz, ctu, gy, gz, gt, s);
    case 4:
      return dispatch<uint32_t>(out, packed, p, X, Y, Z, Tu, ox, oy, oz, otu,
                                cx, cy, cz, ctu, gy, gz, gt, s);
    case 8:
      return dispatch<uint2>(out, packed, p, X, Y, Z, Tu, ox, oy, oz, otu, cx,
                             cy, cz, ctu, gy, gz, gt, s);
    case 16:
      return dispatch<uint4>(out, packed, p, X, Y, Z, Tu, ox, oy, oz, otu, cx,
                             cy, cz, ctu, gy, gz, gt, s);
    default:
      return -1;
  }
}
