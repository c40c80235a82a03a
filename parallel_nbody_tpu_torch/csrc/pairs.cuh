// Pair arithmetic and column sweep shared by the force kernels: forces.cu
// (K1, one sum over all columns), forces_streamed.cu (K2, one partial sum
// per column band) and forces_symmetric.cu (K1's square fp32 case, whose
// diagonal tiles run K1's sweep).
//
// Storage and compute types.  fp32 and fp64 compute in their own type.
// bf16 is a storage format only, as in pallas_step.py::_compute_dtype:
// loads upcast to fp32 (exact), every product and sum stays fp32, and the
// result is rounded to bf16 once, at the store.  So a bf16 launch computes
// bit for bit what the fp32 launch computes on the upcast inputs.
//
// The coincident kick: the TPU kernel's dx bias, segmented by tile
// (pallas_step.py:26-46, _make_col_sweep at :158-223).  The reference gives
// a coincident distinct pair (dsqr == 0) the kick mj * sign(gj - gi) / forced
// along +x, with g the GLOBAL body index.  Adding a bias b to dx makes that
// pair's term mj * b / (forced * |b|), the kick, with no branch; a self-pair
// gets b = 0 and stays 0.  For each staged 128-wide column tile the block
// knows from its rows' global range [gi0, gi0 + 128) and the tile's
// [gj0, gj0 + 128) where the tile lies, the same for every thread:
//   - wholly below the rows (every gj < gi):  b = -C;
//   - wholly above (every gj > gi):           b = +C;
//   - overlapping:                            b = (gj - gi) * P, the index
//     difference taken in integers (|gj - gi| < 256, so the float is exact).
// C and P are pallas_step.py:90-93's by compute type: 2^-26 and 2^-50 in
// fp32, 2^-40 and 2^-80 in fp64.  The order (xj - xi) + b is the TPU's; with
// no fast-math flag it is kept, so self-pair and coincident terms round as
// the Pallas kernel's do.  Against Pallas's 1024-wide tiles the card's
// segments are finer: a 128-row block overlaps one column tile when
// row_g0 - col_g0 is a multiple of 128 and two when it is not, so per-pair
// bias falls on 128 or 256 of a row's columns where Pallas puts it on 1024
// or 2048, and a pair that Pallas biases per pair may get the constant here.
// Both are exact kicks for coincident pairs; on any other pair the bias
// moves dx by at most C, which no dx of magnitude >= 1 feels in fp32.
//
// The unbiased variant is its own instantiation with no add; the device-side
// flag picks between them once per tile, uniformly across the grid.
//
// Accumulation.  Each kBlock-wide j-tile is summed term by term into a
// fresh partial, and the partial is added to the row sum, as the Pallas
// kernel adds each column tile's partial (pallas_step.py:180-193) and as the
// plain versions do (ops/cuda_step._tile_partials, _fold): a partial takes
// kBlock terms and the row sum N / kBlock partials, where one running sum
// over the row would take N terms.  With kComp = false the partial is added
// plainly; with kComp = true it is Kahan-folded into the row sum
// (pallas_step.py::_kahan_add, at :191-197), and the compensation term is
// dropped when the sweep ends (_acc_finish).  The pair loop is the same
// either way; the fold costs one FADD per component per tile (four under
// kComp), not per pair.  -fmad=true contracts only a*b+c, and the Kahan
// steps hold no product, so the compensation survives the compiler; there
// is no --use_fast_math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nbody {

constexpr int kBlock = 128;

template <typename T> struct Consts;
template <> struct Consts<float> {
  // De-NaN floor inside the rsqrt (pallas_step.py::_EPS), and the dx bias:
  // the constant of non-overlapping tiles and the per-pair scale
  // (_CBIAS, _PBIAS).
  static constexpr float eps = 1e-36f;
  static constexpr float cbias = 0x1p-26f;
  static constexpr float pbias = 0x1p-50f;
};
template <> struct Consts<double> {
  static constexpr double eps = 1e-200;
  static constexpr double cbias = 0x1p-40;
  static constexpr double pbias = 0x1p-80;
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

// The bare MUFU reciprocal square root.  rsqrtf compiles, without -ftz, to
// the same MUFU.RSQ behind a test for inputs below FLT_MIN (1.18e-38) that
// scales them by 2^24 first and the result by 2^12 after.  The pair loop's
// argument is forced^2 * dsqr + eps with forced^2 * dsqr >= 0 and
// eps = 1e-36 > FLT_MIN, so it is never below FLT_MIN: it is normal, or
// +inf when a far padding pair overflows (rsqrt gives +0 either way), or
// NaN only from NaN inputs (NaN either way).  On every such argument the
// wrapper does not fire and rsqrt.approx.ftz.f32 returns rsqrtf's bits.
// No other operation changes: there is no global -ftz.
__device__ __forceinline__ float rsqrt_t(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ double rsqrt_t(double v) { return rsqrt(v); }

template <typename T>
__device__ __forceinline__ void kahan_add(T& acc, T& comp, T val) {
  const T y = val - comp;
  const T t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}

// What a tile's pair loop adds to dx.
enum class Bias { kNone, kConst, kPerPair };

// One staged tile against one row.  kConst adds `c` to every dx; kPerPair
// adds (d + t) * P, where d = gj0 - gi is the tile's first column minus the
// row (global ids), so d + t = gj - gi.
template <typename T, Bias kBias>
__device__ __forceinline__ void sweep_tile(
    const T* __restrict__ sx, const T* __restrict__ sy,
    const T* __restrict__ sm, const T* __restrict__ sr, T xi, T yi, T ri,
    T c, int d, T& ax, T& ay) {
#pragma unroll 8
  for (int t = 0; t < kBlock; ++t) {
    T dx = sx[t] - xi;
    if constexpr (kBias == Bias::kConst) dx = dx + c;
    if constexpr (kBias == Bias::kPerPair) {
      dx = dx + static_cast<T>(d + t) * Consts<T>::pbias;
    }
    const T dy = sy[t] - yi;
    const T dsqr = dx * dx + dy * dy;
    const T mind = ri + sr[t];
    const T forced = max(dsqr, mind * mind);
    const T s = sm[t] * rsqrt_t(forced * forced * dsqr + Consts<T>::eps);
    ax += s * dx;
    ay += s * dy;
  }
}

// The tile sweep with the tile's segment of the dx bias: none when
// unbiased; else -C or +C when the tile [gj0, gj0 + kBlock) lies wholly
// below or above the rows' block [gi0, gi0 + kBlock), and the per-pair bias
// where they overlap; the row is gi0 + place.  The choice is the same for
// every thread that shares gi0 and gj0.
template <typename T>
__device__ __forceinline__ void sweep_segment(
    const T* __restrict__ sx, const T* __restrict__ sy,
    const T* __restrict__ sm, const T* __restrict__ sr, T xi, T yi, T ri,
    bool biased, long long gi0, long long gj0, int place, T& ax, T& ay) {
  const long long d0 = gj0 - gi0;
  if (!biased) {
    sweep_tile<T, Bias::kNone>(sx, sy, sm, sr, xi, yi, ri, T(0), 0, ax, ay);
  } else if (d0 > -kBlock && d0 < kBlock) {
    const int d = static_cast<int>(d0) - place;
    sweep_tile<T, Bias::kPerPair>(sx, sy, sm, sr, xi, yi, ri, T(0), d, ax,
                                  ay);
  } else {
    const T c = d0 < 0 ? -Consts<T>::cbias : Consts<T>::cbias;
    sweep_tile<T, Bias::kConst>(sx, sy, sm, sr, xi, yi, ri, c, 0, ax, ay);
  }
}

// Raw acceleration (before G * m_i) of row body (xi, yi, ri) of a block
// whose rows have global ids gi0 + threadIdx.x, from columns
// [j_begin, j_end) of the column block, whose global ids start at col_g0.
// Every thread of the block calls it with the same range, since the tiles
// are staged cooperatively.  Columns past j_end are staged as zero-mass
// bodies at the origin, whose terms are exactly 0.  Each thread loads its
// column of the next tile into registers while the block sweeps this one,
// and stores it to shared memory after the barrier, so the sweep does not
// wait on device memory at each tile.
template <typename S, bool kComp>
__device__ __forceinline__ void sweep_columns(
    const S* __restrict__ xj, const S* __restrict__ yj,
    const S* __restrict__ mj, const S* __restrict__ rj, int64_t j_begin,
    int64_t j_end, int64_t col_g0, typename ComputeOf<S>::type xi,
    typename ComputeOf<S>::type yi, typename ComputeOf<S>::type ri,
    long long gi0, bool biased, typename ComputeOf<S>::type* sx,
    typename ComputeOf<S>::type* sy, typename ComputeOf<S>::type* sm,
    typename ComputeOf<S>::type* sr, typename ComputeOf<S>::type& ax,
    typename ComputeOf<S>::type& ay) {
  using T = typename ComputeOf<S>::type;
  T cx = T(0), cy = T(0);
  S nx{}, ny{}, nm{}, nr{};
  int64_t j = j_begin + threadIdx.x;
  bool in = j < j_end;
  if (in) {
    nx = xj[j];
    ny = yj[j];
    nm = mj[j];
    nr = rj[j];
  }
  for (int64_t j0 = j_begin; j0 < j_end; j0 += kBlock) {
    sx[threadIdx.x] = in ? to_compute(nx) : T(0);
    sy[threadIdx.x] = in ? to_compute(ny) : T(0);
    sm[threadIdx.x] = in ? to_compute(nm) : T(0);
    sr[threadIdx.x] = in ? to_compute(nr) : T(0);
    __syncthreads();
    j = j0 + kBlock + threadIdx.x;
    in = j < j_end;
    if (in) {
      nx = xj[j];
      ny = yj[j];
      nm = mj[j];
      nr = rj[j];
    }
    const long long gj0 = col_g0 + j0;
    T px = T(0), py = T(0);
    sweep_segment<T>(sx, sy, sm, sr, xi, yi, ri, biased, gi0, gj0,
                     static_cast<int>(threadIdx.x), px, py);
    if (kComp) {
      kahan_add(ax, cx, px);
      kahan_add(ay, cy, py);
    } else {
      ax += px;
      ay += py;
    }
    __syncthreads();
  }
}

}  // namespace nbody
