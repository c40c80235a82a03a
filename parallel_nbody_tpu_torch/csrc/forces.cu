// All-pairs gravitational block forces for Hopper (sm_90a), fp32 and fp64.
//
// Replaces parallel_nbody_tpu/ops/pallas_step.py::_force_kernel (the
// VMEM-resident Pallas kernel reached through pallas_block_forces).  It
// computes the same one-sided block force: for every row body i of block I
// and every column body j of block J,
//
//   dx = xj - xi, dy = yj - yi, dsqr = dx*dx + dy*dy
//   forced = max(dsqr, (ri + rj)^2)
//   acc_i += mj * rsqrt(forced*forced*dsqr + eps) * (dx, dy)
//
// and F_i = acc_i * (G * mi), the row factor applied once after the sum.
// Coincident distinct pairs (dsqr == 0, gj != gi, with g the GLOBAL body
// index row_g0 + i / col_g0 + j) get the reference's atan2(0, 0) kick
// mj * sign(gj - gi) / forced along +x (nbody-seq.c:91-106), added directly
// rather than through the TPU kernel's dx bias.  Self-pairs contribute 0
// (dx = dy = 0 and sign 0); eps keeps rsqrt finite there.
//
// Bound: compute.  Each of the M*K ordered pairs costs about 20 FP32
// operations (most of them fused multiply-adds) and one rsqrt on the SFU,
// while each body's 16 bytes (x, y, m, r) are read from device memory once
// per block of rows.  The j-tiles staged through shared memory are what keep
// it compute-bound: a block of kBlock threads reads every column body once
// from device memory (through L2) and then serves it to all kBlock rows from
// shared memory, so device-memory traffic is 16*K bytes per kBlock rows.
//
// Layout: one thread per row body, blocks of kBlock threads, j-tiles of
// kBlock column bodies; the accumulator lives in registers and no sum crosses
// threads, so there is no cross-block reduction.  The ragged column tail is
// filled with zero-mass bodies at the origin (contribution exactly 0); rows
// past M neither read nor write.  In fp32, far zero-mass padding bodies
// (state.pad_state, at 1e9) overflow forced*forced*dsqr to inf and
// rsqrt(inf) = 0, so they contribute 0 as well.
//
// The coincident-pair flag is read from device memory (a 0-d bool tensor
// written by ops/cuda_step.any_coincident), so the host never waits for it;
// the branch on it is uniform across the grid.
//
// Build (ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v
// No --use_fast_math: rsqrtf is the SFU approximation (2 ulp) either way,
// and the default -fmad=true contracts a*b+c into FMAs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;

template <typename T> struct Consts;
template <> struct Consts<float> {
  // De-NaN floor inside the rsqrt (pallas_step.py::_EPS), and the
  // denominator floor of the kick (forces.py::_DENOM_FLOOR).
  static constexpr float eps = 1e-36f;
  static constexpr float denom_floor = 1e-30f;
};
template <> struct Consts<double> {
  static constexpr double eps = 1e-200;
  static constexpr double denom_floor = 1e-30;
};

__device__ __forceinline__ float rsqrt_t(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_t(double v) { return rsqrt(v); }

template <typename T, bool kBiased>
__device__ __forceinline__ void sweep_tile(
    const T* __restrict__ sx, const T* __restrict__ sy,
    const T* __restrict__ sm, const T* __restrict__ sr,
    T xi, T yi, T ri, long long gi, long long gj0, T& ax, T& ay) {
#pragma unroll 8
  for (int t = 0; t < kBlock; ++t) {
    const T dx = sx[t] - xi;
    const T dy = sy[t] - yi;
    const T dsqr = dx * dx + dy * dy;
    const T mind = ri + sr[t];
    const T forced = max(dsqr, mind * mind);
    const T s = sm[t] * rsqrt_t(forced * forced * dsqr + Consts<T>::eps);
    ax += s * dx;
    ay += s * dy;
    if (kBiased && dsqr == T(0)) {
      const long long gj = gj0 + t;
      if (gj != gi) {
        const T sgn = gj > gi ? T(1) : T(-1);
        ax += sm[t] * sgn / max(forced, T(Consts<T>::denom_floor));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock) block_forces_kernel(
    const T* __restrict__ xi, const T* __restrict__ yi,
    const T* __restrict__ mi, const T* __restrict__ ri, int64_t m,
    const T* __restrict__ xj, const T* __restrict__ yj,
    const T* __restrict__ mj, const T* __restrict__ rj, int64_t k,
    int64_t row_g0, int64_t col_g0, T gravity,
    const bool* __restrict__ biased_flag, int biased_default,
    T* __restrict__ xf, T* __restrict__ yf) {
  __shared__ T sx[kBlock], sy[kBlock], sm[kBlock], sr[kBlock];

  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const bool row_ok = i < m;
  const T x0 = row_ok ? xi[i] : T(0);
  const T y0 = row_ok ? yi[i] : T(0);
  const T r0 = row_ok ? ri[i] : T(0);
  const long long gi = row_g0 + i;
  const bool biased = biased_flag != nullptr ? *biased_flag
                                             : biased_default != 0;

  T ax = T(0), ay = T(0);
  for (int64_t j0 = 0; j0 < k; j0 += kBlock) {
    const int64_t j = j0 + threadIdx.x;
    if (j < k) {
      sx[threadIdx.x] = xj[j];
      sy[threadIdx.x] = yj[j];
      sm[threadIdx.x] = mj[j];
      sr[threadIdx.x] = rj[j];
    } else {
      sx[threadIdx.x] = T(0);
      sy[threadIdx.x] = T(0);
      sm[threadIdx.x] = T(0);
      sr[threadIdx.x] = T(0);
    }
    __syncthreads();
    if (biased) {
      sweep_tile<T, true>(sx, sy, sm, sr, x0, y0, r0, gi, col_g0 + j0, ax, ay);
    } else {
      sweep_tile<T, false>(sx, sy, sm, sr, x0, y0, r0, gi, col_g0 + j0, ax,
                           ay);
    }
    __syncthreads();
  }
  if (row_ok) {
    const T gmi = mi[i] * gravity;
    xf[i] = ax * gmi;
    yf[i] = ay * gmi;
  }
}

template <typename T>
int launch(const T* xi, const T* yi, const T* mi, const T* ri, int64_t m,
           const T* xj, const T* yj, const T* mj, const T* rj, int64_t k,
           int64_t row_g0, int64_t col_g0, double gravity,
           const bool* biased_flag, int biased_default, T* xf, T* yf,
           void* stream) {
  const int64_t blocks = (m + kBlock - 1) / kBlock;
  block_forces_kernel<T><<<static_cast<unsigned>(blocks), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      xi, yi, mi, ri, m, xj, yj, mj, rj, k, row_g0, col_g0,
      static_cast<T>(gravity), biased_flag, biased_default, xf, yf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  Pointers are device
// pointers; biased_flag may be null, and then biased_default decides.
int nbody_block_forces_f32(const float* xi, const float* yi, const float* mi,
                           const float* ri, int64_t m, const float* xj,
                           const float* yj, const float* mj, const float* rj,
                           int64_t k, int64_t row_g0, int64_t col_g0,
                           double gravity, const bool* biased_flag,
                           int biased_default, float* xf, float* yf,
                           void* stream) {
  return launch<float>(xi, yi, mi, ri, m, xj, yj, mj, rj, k, row_g0, col_g0,
                       gravity, biased_flag, biased_default, xf, yf, stream);
}

int nbody_block_forces_f64(const double* xi, const double* yi,
                           const double* mi, const double* ri, int64_t m,
                           const double* xj, const double* yj,
                           const double* mj, const double* rj, int64_t k,
                           int64_t row_g0, int64_t col_g0, double gravity,
                           const bool* biased_flag, int biased_default,
                           double* xf, double* yf, void* stream) {
  return launch<double>(xi, yi, mi, ri, m, xj, yj, mj, rj, k, row_g0, col_g0,
                        gravity, biased_flag, biased_default, xf, yf, stream);
}

const char* nbody_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
