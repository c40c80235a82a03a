// Roofline probe for Hopper (sm_90a): P1, ablations of K1's pair loop.
//
// Replaces benchmarks/roofline_probe.py::make_kernel (the Pallas probe that
// bench_variant times).  Each variant is K1's unbiased pair loop with part
// of its arithmetic taken out, so that the time each one saves shows which
// resource bounds the loop.  The ablated variants compute wrong physics on
// purpose: they exist to be timed.  For row body i of one set and column
// body j of another, both of n bodies:
//
//   dx = xj - xi, dy = yj - yi, dsqr = dx*dx + dy*dy,
//   forced = max(dsqr, (ri + rj)^2)
//   full       inv = rsqrt(max(forced*forced*dsqr, 1e-30))
//   no_rsqrt   inv = max(forced*forced*dsqr, 1e-30) * 1e-6   (no MUFU)
//   no_soften  inv = rsqrt(max(dsqr*dsqr*dsqr, 1e-30))       (no forced)
//   mem_only   inv = dx + dy + mj + rj                       (no dsqr)
//   acc_i += mj * inv * (dx, dy);   F_i = acc_i * (mi * 1.1)
//
// `full` is K1's unbiased loop except for the de-NaN floor: the probe's
// max(q, 1e-30) in place of K1's q + 1e-36, one FMNMX where K1 folds the
// floor into an FMA.  `mem_only` still reads all four column values of a
// pair (they all feed inv); `no_soften` has no use for rj, so its per-pair
// shared-memory load of rj goes with the softening it ablates (the tile is
// still staged).
//
// Layout: K1's (forces.cu and pairs.cuh), so that the ablations ablate the
// CUDA K1's loop and not the TPU's: one thread per row body, blocks of
// kBlock = 128 threads, 128-wide column tiles staged in shared memory, the
// sum in registers, and a copy of pairs.cuh::sweep_tile with the variant's
// arithmetic in place of K1's.  The Pallas probe's tile_i and tile_j do not
// change P1's arithmetic; the launcher takes them so that P1 and P2 share
// one C signature, and ignores them.  The wrapper
// (benchmarks/roofline_probe.py) admits only n that is a multiple of 128, so
// no row or column tile is ragged.
//
// Bound: operations.  `full` costs 16 FP32 operations (13 instructions, 3
// of them FMAs) and one MUFU rsqrt per pair; each of the 8 input vectors is
// read once and each of the 2 outputs written once, 40 bytes per body.  At
// n = 65536 the operations take 1.03 ms at the 67 TFLOP/s FP32 peak, the
// rsqrts 1.03 ms at 16 per clock per SM (1.98 GHz), the 13 FP32
// instructions 1.67 ms at 128 lanes per clock per SM; the bytes 0.8 us.
//
// Build: as forces.cu (ops/_build.py, library "probes"); no
// --use_fast_math.

#include "pairs.cuh"

namespace {

using nbody::kBlock;

enum Variant { kFull = 0, kNoRsqrt = 1, kNoSoften = 2, kMemOnly = 3 };

template <int V>
__device__ __forceinline__ void sweep_tile(
    const float* __restrict__ sx, const float* __restrict__ sy,
    const float* __restrict__ sm, const float* __restrict__ sr, float xi,
    float yi, float ri, float& ax, float& ay) {
#pragma unroll 8
  for (int t = 0; t < kBlock; ++t) {
    const float dx = sx[t] - xi;
    const float dy = sy[t] - yi;
    float inv;
    if constexpr (V == kMemOnly) {
      inv = dx + dy + sm[t] + sr[t];
    } else if constexpr (V == kNoSoften) {
      const float dsqr = dx * dx + dy * dy;
      inv = rsqrtf(fmaxf(dsqr * dsqr * dsqr, 1e-30f));
    } else {
      const float dsqr = dx * dx + dy * dy;
      const float mind = ri + sr[t];
      const float forced = fmaxf(dsqr, mind * mind);
      const float q = fmaxf(forced * forced * dsqr, 1e-30f);
      inv = V == kFull ? rsqrtf(q) : q * 1e-6f;
    }
    const float s = sm[t] * inv;
    ax += s * dx;
    ay += s * dy;
  }
}

template <int V>
__global__ void __launch_bounds__(kBlock) roofline_probe_kernel(
    const float* __restrict__ xi, const float* __restrict__ yi,
    const float* __restrict__ mi, const float* __restrict__ ri,
    const float* __restrict__ xj, const float* __restrict__ yj,
    const float* __restrict__ mj, const float* __restrict__ rj, int64_t n,
    float* __restrict__ xf, float* __restrict__ yf) {
  __shared__ float sx[kBlock], sy[kBlock], sm[kBlock], sr[kBlock];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const float x0 = xi[i], y0 = yi[i], r0 = ri[i];
  float ax = 0.f, ay = 0.f;
  for (int64_t j0 = 0; j0 < n; j0 += kBlock) {
    const int64_t j = j0 + threadIdx.x;
    sx[threadIdx.x] = xj[j];
    sy[threadIdx.x] = yj[j];
    sm[threadIdx.x] = mj[j];
    sr[threadIdx.x] = rj[j];
    __syncthreads();
    sweep_tile<V>(sx, sy, sm, sr, x0, y0, r0, ax, ay);
    __syncthreads();
  }
  const float gmi = mi[i] * 1.1f;
  xf[i] = ax * gmi;
  yf[i] = ay * gmi;
}

template <int V>
int launch(const float* xi, const float* yi, const float* mi,
           const float* ri, const float* xj, const float* yj,
           const float* mj, const float* rj, int64_t n, float* xf,
           float* yf, cudaStream_t stream) {
  roofline_probe_kernel<V><<<static_cast<unsigned>(n / kBlock), kBlock, 0,
                             stream>>>(xi, yi, mi, ri, xj, yj, mj, rj, n, xf,
                                       yf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// variant: 0 full, 1 no_rsqrt, 2 no_soften, 3 mem_only.  n must be a
// positive multiple of 128 (the wrapper checks); tile_i and tile_j are
// unused.  Returns the cudaError_t of the launch (0 on success).
int nbody_roofline_probe(int variant, const float* xi, const float* yi,
                         const float* mi, const float* ri, const float* xj,
                         const float* yj, const float* mj, const float* rj,
                         int64_t n, int64_t tile_i, int64_t tile_j,
                         float* xf, float* yf, void* stream) {
  (void)tile_i;
  (void)tile_j;
  auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull:
      return launch<kFull>(xi, yi, mi, ri, xj, yj, mj, rj, n, xf, yf, s);
    case kNoRsqrt:
      return launch<kNoRsqrt>(xi, yi, mi, ri, xj, yj, mj, rj, n, xf, yf, s);
    case kNoSoften:
      return launch<kNoSoften>(xi, yi, mi, ri, xj, yj, mj, rj, n, xf, yf,
                               s);
    case kMemOnly:
      return launch<kMemOnly>(xi, yi, mi, ri, xj, yj, mj, rj, n, xf, yf, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The probe library's copy of forces.cu's error-string function.
const char* nbody_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
