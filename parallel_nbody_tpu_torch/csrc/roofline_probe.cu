// Roofline probe for Hopper (sm_90a): P1, ablations of the fp32 pair loop.
//
// Replaces benchmarks/roofline_probe.py::make_kernel (the Pallas probe that
// bench_variant times).  Each variant is the unbiased pair loop with part
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
// `full` is K1's unbiased arithmetic except for the de-NaN floor: the
// probe's max(q, 1e-30) in place of K1's q + 1e-36.  `mem_only`, `full`
// and `no_rsqrt` read all four values of each staged column (one LDS.128);
// `no_soften` has no use for rj and reads x, y and m only (an LDS.64 and an
// LDS), so the load of rj goes with the softening it ablates.
//
// The rsqrt is the bare MUFU instruction (pairs.cuh::rsqrt_t), as in K1.
// rsqrtf adds, without -ftz, a test for arguments below FLT_MIN (1.18e-38)
// that rescales them; the argument here is max(q, 1e-30), never below
// FLT_MIN (or +inf, or NaN from NaN inputs), so the test never fires and
// rsqrt.approx.ftz.f32 returns rsqrtf's bits.  No other operation changes:
// no -ftz, no --use_fast_math.
//
// Layout (csrc/probe_layout.cuh): R = 4 rows per thread in blocks of 128
// threads, each staged float4 column used for all R rows, the tile staging
// double-buffered, the columns split into S = 2 parts whose partials are
// folded in rank order inside a thread block cluster.  The probes no longer
// run K1's layout (one row per thread, no split, four separate staged
// arrays, two barriers a tile): they differ from K1 in the rows per thread,
// the split and its fold, and the staging, and so in the order each row is
// summed, not in the pair arithmetic.  The Pallas probe's
// tile_i and tile_j do not change P1's arithmetic; the launcher takes them
// so that P1 and P2 share one C signature, and ignores them.  The wrapper
// (benchmarks/roofline_probe.py) admits any n that is a multiple of 128.
//
// Bound: operations by the FP32 peak, instruction issue on the card.
// `full` costs 16 FP32 operations (13 instructions, 3 of them FMAs) and one
// MUFU rsqrt per pair; each of the 8 input vectors is read once and each of
// the 2 outputs written once, 40 bytes per body.  At n = 65536 the
// operations take 1.03 ms at the 67 TFLOP/s FP32 peak, the bytes 0.8 us.
// But each SM sub-partition issues one warp instruction per clock, and the
// loop is 13 FP32 instructions, the MUFU, and the shared load and loop
// overhead split over R pairs: 14.375 instructions per pair at R = 4
// (benchmarks/sass_census.py), an issue bound of 1.85 ms at n = 65536 (132
// SMs at 1.98 GHz), which the loop reaches at ~80%.  Time goes with
// instructions per pair, so the layout shares what it can over R rows and
// keeps each warp busy with R independent rows.  Tensor cores would only take
// the two FFMAs of the row sums and need the terms converted (P2's mxu2_*
// measure that); TMA or cp.async would save the tile's staging, ~0.08
// issue slots per pair; Newton's-third-law folding has nothing to fold, as
// rows and columns are different sets.
//
// Build: ops/_build.py, library "probes"; no --use_fast_math.

#include "probe_layout.cuh"

namespace {

using nbody::kBlock;

enum Variant { kFull = 0, kNoRsqrt = 1, kNoSoften = 2, kMemOnly = 3 };

template <int V, int R>
__device__ __forceinline__ void sweep_tile(const float4* __restrict__ s,
                                           const float (&xi)[R],
                                           const float (&yi)[R],
                                           const float (&ri)[R],
                                           float (&ax)[R], float (&ay)[R]) {
#pragma unroll 8
  for (int t = 0; t < kBlock; ++t) {
    float4 c;
    if constexpr (V == kNoSoften) {
      const float2 xy = reinterpret_cast<const float2*>(s)[2 * t];
      c = make_float4(xy.x, xy.y, reinterpret_cast<const float*>(s)[4 * t + 2],
                      0.f);
    } else {
      c = s[t];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float dx = c.x - xi[r];
      const float dy = c.y - yi[r];
      float inv;
      if constexpr (V == kMemOnly) {
        inv = dx + dy + c.z + c.w;
      } else if constexpr (V == kNoSoften) {
        const float dsqr = dx * dx + dy * dy;
        inv = nbody::rsqrt_t(fmaxf(dsqr * dsqr * dsqr, 1e-30f));
      } else {
        const float dsqr = dx * dx + dy * dy;
        const float mind = ri[r] + c.w;
        const float forced = fmaxf(dsqr, mind * mind);
        const float q = fmaxf(forced * forced * dsqr, 1e-30f);
        inv = V == kFull ? nbody::rsqrt_t(q) : q * 1e-6f;
      }
      const float sc = c.z * inv;
      ax[r] += sc * dx;
      ay[r] += sc * dy;
    }
  }
}

template <int V, int R>
__global__ void __cluster_dims__(1, probe::kSplit, 1)
    __launch_bounds__(kBlock, probe::kMinBlocks) roofline_probe_kernel(
        const float* __restrict__ xi, const float* __restrict__ yi,
        const float* __restrict__ mi, const float* __restrict__ ri,
        const float* __restrict__ xj, const float* __restrict__ yj,
        const float* __restrict__ mj, const float* __restrict__ rj,
        int64_t n, float* __restrict__ xf, float* __restrict__ yf) {
  __shared__ float4 s[2][kBlock];
  float x0[R], y0[R], r0[R], ax[R] = {}, ay[R] = {};
  probe::load_rows<R>(xi, n, x0);
  probe::load_rows<R>(yi, n, y0);
  probe::load_rows<R>(ri, n, r0);
  const probe::Part part = probe::part_of(n);
  float4 next = probe::fetch(xj, yj, mj, rj, n, part.begin);
  int buf = 0;
  for (int64_t j0 = part.begin; j0 < part.end; j0 += kBlock, buf ^= 1) {
    s[buf][threadIdx.x] = next;
    __syncthreads();
    if (j0 + kBlock < part.end) {
      next = probe::fetch(xj, yj, mj, rj, n, j0 + kBlock);
    }
    sweep_tile<V, R>(s[buf], x0, y0, r0, ax, ay);
  }
  probe::fold_store<R>(ax, ay, mi, n, xf, yf);
}

template <int V>
int launch(const float* xi, const float* yi, const float* mi,
           const float* ri, const float* xj, const float* yj,
           const float* mj, const float* rj, int64_t n, float* xf,
           float* yf, cudaStream_t stream) {
  roofline_probe_kernel<V, probe::kRows>
      <<<probe::grid(n), kBlock, 0, stream>>>(xi, yi, mi, ri, xj, yj, mj, rj,
                                              n, xf, yf);
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
