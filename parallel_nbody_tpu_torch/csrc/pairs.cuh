// Pair arithmetic and column sweep shared by the two force kernels:
// forces.cu (K1, one sum over all columns) and forces_streamed.cu (K2, one
// partial sum per column band).
//
// Storage and compute types.  fp32 and fp64 compute in their own type.
// bf16 is a storage format only, as in pallas_step.py::_compute_dtype:
// loads upcast to fp32 (exact), every product and sum stays fp32, and the
// result is rounded to bf16 once, at the store.  So a bf16 launch computes
// bit for bit what the fp32 launch computes on the upcast inputs.
//
// Accumulation.  With kComp = false each pair term is added straight into
// the row accumulator.  With kComp = true each kBlock-wide j-tile is summed
// into a fresh partial, and the partial is Kahan-folded into the row sum
// (pallas_step.py::_kahan_add, at :191-197); the compensation term is
// dropped when the sweep ends (_acc_finish).  -fmad=true contracts only
// a*b+c, and the Kahan steps hold no product, so the compensation survives
// the compiler; there is no --use_fast_math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nbody {

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

template <typename S> struct ComputeOf { using type = S; };
template <> struct ComputeOf<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ float to_compute(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_compute(float v) { return v; }
__device__ __forceinline__ double to_compute(double v) { return v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }

__device__ __forceinline__ float rsqrt_t(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_t(double v) { return rsqrt(v); }

template <typename T>
__device__ __forceinline__ void kahan_add(T& acc, T& comp, T val) {
  const T y = val - comp;
  const T t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}

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

// Raw acceleration (before G * m_i) of row body (xi, yi, ri) with global id
// gi from columns [j_begin, j_end) of the column block, whose global ids
// start at col_g0.  Every thread of the block calls it with the same range,
// since the tiles are staged cooperatively.  Columns past j_end are staged
// as zero-mass bodies at the origin, whose terms are exactly 0.
template <typename S, bool kComp>
__device__ __forceinline__ void sweep_columns(
    const S* __restrict__ xj, const S* __restrict__ yj,
    const S* __restrict__ mj, const S* __restrict__ rj, int64_t j_begin,
    int64_t j_end, int64_t col_g0, typename ComputeOf<S>::type xi,
    typename ComputeOf<S>::type yi, typename ComputeOf<S>::type ri,
    long long gi, bool biased, typename ComputeOf<S>::type* sx,
    typename ComputeOf<S>::type* sy, typename ComputeOf<S>::type* sm,
    typename ComputeOf<S>::type* sr, typename ComputeOf<S>::type& ax,
    typename ComputeOf<S>::type& ay) {
  using T = typename ComputeOf<S>::type;
  T cx = T(0), cy = T(0);
  for (int64_t j0 = j_begin; j0 < j_end; j0 += kBlock) {
    const int64_t j = j0 + threadIdx.x;
    if (j < j_end) {
      sx[threadIdx.x] = to_compute(xj[j]);
      sy[threadIdx.x] = to_compute(yj[j]);
      sm[threadIdx.x] = to_compute(mj[j]);
      sr[threadIdx.x] = to_compute(rj[j]);
    } else {
      sx[threadIdx.x] = T(0);
      sy[threadIdx.x] = T(0);
      sm[threadIdx.x] = T(0);
      sr[threadIdx.x] = T(0);
    }
    __syncthreads();
    const long long gj0 = col_g0 + j0;
    if (kComp) {
      T px = T(0), py = T(0);
      if (biased) {
        sweep_tile<T, true>(sx, sy, sm, sr, xi, yi, ri, gi, gj0, px, py);
      } else {
        sweep_tile<T, false>(sx, sy, sm, sr, xi, yi, ri, gi, gj0, px, py);
      }
      kahan_add(ax, cx, px);
      kahan_add(ay, cy, py);
    } else if (biased) {
      sweep_tile<T, true>(sx, sy, sm, sr, xi, yi, ri, gi, gj0, ax, ay);
    } else {
      sweep_tile<T, false>(sx, sy, sm, sr, xi, yi, ri, gi, gj0, ax, ay);
    }
    __syncthreads();
  }
}

}  // namespace nbody
