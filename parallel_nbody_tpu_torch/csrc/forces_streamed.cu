// Band-by-band block forces for Hopper (sm_90a): K2.
//
// Replaces parallel_nbody_tpu/ops/pallas_step.py::_force_kernel_streamed
// (reached through pallas_block_forces_streamed; the JAX package runs it
// above 131072 bodies).  It computes K1's one-sided block force (forces.cu
// gives the pair math; pairs.cuh the coincident kick, the TPU kernel's dx
// bias segmented by tile, with a band's tiles counted from the band's start
// as pallas_step.py:373-386 counts them) with K2's summation structure: the
// columns are cut into bands of `band` bodies (65536 by default; a multiple
// of the 128-wide tile), each row's raw acceleration is summed band by band,
// and the band partials are folded in band order 0..nb-1 before G * m_i is
// applied.  Under accum "compensated" the tiles of a band are Kahan-folded
// into the band partial (whose compensation term is dropped at band end, as
// pallas_step._acc_finish drops it) and the band partials are Kahan-folded
// into the total (the TPU kernel's two scratch rows, pallas_step.py:460-463).
// bf16 is storage only (pairs.cuh).
//
// Design: two launches.  The TPU kernel carries the cross-band sum in its
// revisited output block, because its grid runs the bands in order on one
// core.  CUDA blocks run in parallel and carry nothing from one to the next,
// so:
//   1. band_partials_kernel, grid (row blocks of 128, bands): each block
//      sweeps one band through 128-wide shared-memory j-tiles, exactly as
//      K1 sweeps all columns, and writes its band partial (x, y) to a
//      workspace of shape (bands, 2, M) in the compute type;
//   2. band_fold_kernel, one thread per row: adds the bands in order,
//      plainly or with Kahan, multiplies by G * m_i, and stores the result
//      in the storage type.
// The result is deterministic (fixed fold order, no atomics), and the band
// axis multiplies the blocks in flight, which fills the 132 SMs for a small
// row block (a shard's rows, or a row chunk).  A single kernel that looped
// over the bands inside each thread would need no workspace but would give
// a small row block only M/128 blocks.
//
// Bound: the band kernel runs K1's pair loop and is bound, as K1 is, by
// instruction issue at the loop's instructions per pair (forces.cu gives
// the census; tensor cores and TMA do not serve it, for K1's reasons).  The
// fold reads 2 * bands * M compute-type words and writes 2 * M: at N=262144
// fp32 with 4 bands that is 8 MiB, a few microseconds at device bandwidth
// against tens of milliseconds of pair work.
//
// Global ids stay 64-bit: a tile's first column is col_g0 + b * band + j0
// and a block's first row row_g0 + blockIdx.x * 128, so the tile's bias
// segment, and with it the kick's sign, is right for any band and any block
// offset.
// The ragged last band and tile are filled with zero-mass bodies at the
// origin and nothing past K is read.
//
// Build: as forces.cu (ops/_build.py compiles each source on its own).

#include "pairs.cuh"

namespace {

using nbody::ComputeOf;
using nbody::kBlock;

constexpr int kFoldBlock = 256;

template <typename S, bool kComp>
__global__ void __launch_bounds__(kBlock) band_partials_kernel(
    const S* __restrict__ xi, const S* __restrict__ yi,
    const S* __restrict__ ri, int64_t m, const S* __restrict__ xj,
    const S* __restrict__ yj, const S* __restrict__ mj,
    const S* __restrict__ rj, int64_t k, int64_t band, int64_t row_g0,
    int64_t col_g0, const bool* __restrict__ biased_flag, int biased_default,
    typename ComputeOf<S>::type* __restrict__ ws) {
  using T = typename ComputeOf<S>::type;
  __shared__ T sx[kBlock], sy[kBlock], sm[kBlock], sr[kBlock];

  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const int64_t b = blockIdx.y;
  const bool row_ok = i < m;
  const T x0 = row_ok ? nbody::to_compute(xi[i]) : T(0);
  const T y0 = row_ok ? nbody::to_compute(yi[i]) : T(0);
  const T r0 = row_ok ? nbody::to_compute(ri[i]) : T(0);
  const long long gi0 = row_g0 + static_cast<int64_t>(blockIdx.x) * kBlock;
  const bool biased = biased_flag != nullptr ? *biased_flag
                                             : biased_default != 0;
  const int64_t j_begin = b * band;
  const int64_t j_end = j_begin + band < k ? j_begin + band : k;

  T ax = T(0), ay = T(0);
  nbody::sweep_columns<S, kComp>(xj, yj, mj, rj, j_begin, j_end, col_g0, x0,
                                 y0, r0, gi0, biased, sx, sy, sm, sr, ax, ay);
  if (row_ok) {
    ws[(2 * b) * m + i] = ax;
    ws[(2 * b + 1) * m + i] = ay;
  }
}

template <typename S, bool kComp>
__global__ void __launch_bounds__(kFoldBlock) band_fold_kernel(
    const typename ComputeOf<S>::type* __restrict__ ws, int64_t nb, int64_t m,
    const S* __restrict__ mi, typename ComputeOf<S>::type gravity,
    S* __restrict__ xf, S* __restrict__ yf) {
  using T = typename ComputeOf<S>::type;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kFoldBlock +
                    threadIdx.x;
  if (i >= m) return;
  T ax = T(0), ay = T(0), cx = T(0), cy = T(0);
  for (int64_t b = 0; b < nb; ++b) {
    const T px = ws[(2 * b) * m + i];
    const T py = ws[(2 * b + 1) * m + i];
    if (kComp) {
      nbody::kahan_add(ax, cx, px);
      nbody::kahan_add(ay, cy, py);
    } else {
      ax += px;
      ay += py;
    }
  }
  const T gmi = nbody::to_compute(mi[i]) * gravity;
  nbody::store(xf + i, ax * gmi);
  nbody::store(yf + i, ay * gmi);
}

template <typename S, bool kComp>
int launch_partials_k(const S* xi, const S* yi, const S* ri, int64_t m,
                      const S* xj, const S* yj, const S* mj, const S* rj,
                      int64_t k, int64_t band, int64_t row_g0,
                      int64_t col_g0, const bool* biased_flag,
                      int biased_default, typename ComputeOf<S>::type* ws,
                      cudaStream_t stream) {
  const int64_t nb = k > band ? (k + band - 1) / band : 1;
  const dim3 grid(static_cast<unsigned>((m + kBlock - 1) / kBlock),
                  static_cast<unsigned>(nb));
  band_partials_kernel<S, kComp><<<grid, kBlock, 0, stream>>>(
      xi, yi, ri, m, xj, yj, mj, rj, k, band, row_g0, col_g0, biased_flag,
      biased_default, ws);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_partials(const S* xi, const S* yi, const S* ri, int64_t m,
                    const S* xj, const S* yj, const S* mj, const S* rj,
                    int64_t k, int64_t band, int64_t row_g0, int64_t col_g0,
                    const bool* biased_flag, int biased_default,
                    int compensated, typename ComputeOf<S>::type* ws,
                    void* stream) {
  if (band <= 0 || band % kBlock != 0 || m <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (compensated) {
    return launch_partials_k<S, true>(xi, yi, ri, m, xj, yj, mj, rj, k, band,
                                      row_g0, col_g0, biased_flag,
                                      biased_default, ws, s);
  }
  return launch_partials_k<S, false>(xi, yi, ri, m, xj, yj, mj, rj, k, band,
                                     row_g0, col_g0, biased_flag,
                                     biased_default, ws, s);
}

template <typename S>
int launch_fold(const typename ComputeOf<S>::type* ws, int64_t nb, int64_t m,
                const S* mi, double gravity, int compensated, S* xf, S* yf,
                void* stream) {
  using T = typename ComputeOf<S>::type;
  if (m <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks =
      static_cast<unsigned>((m + kFoldBlock - 1) / kFoldBlock);
  if (compensated) {
    band_fold_kernel<S, true><<<blocks, kFoldBlock, 0, s>>>(
        ws, nb, m, mi, static_cast<T>(gravity), xf, yf);
  } else {
    band_fold_kernel<S, false><<<blocks, kFoldBlock, 0, s>>>(
        ws, nb, m, mi, static_cast<T>(gravity), xf, yf);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Band partials: ws is (nb, 2, m) in the compute type (fp32 for bf16), nb =
// ceil(k / band) (1 when k <= band); band is a positive multiple of 128.
// Returns the cudaError_t of the launch (0 on success).
int nbody_band_partials_f32(const float* xi, const float* yi, const float* ri,
                            int64_t m, const float* xj, const float* yj,
                            const float* mj, const float* rj, int64_t k,
                            int64_t band, int64_t row_g0, int64_t col_g0,
                            const bool* biased_flag, int biased_default,
                            int compensated, float* ws, void* stream) {
  return launch_partials<float>(xi, yi, ri, m, xj, yj, mj, rj, k, band,
                                row_g0, col_g0, biased_flag, biased_default,
                                compensated, ws, stream);
}

int nbody_band_partials_f64(const double* xi, const double* yi,
                            const double* ri, int64_t m, const double* xj,
                            const double* yj, const double* mj,
                            const double* rj, int64_t k, int64_t band,
                            int64_t row_g0, int64_t col_g0,
                            const bool* biased_flag, int biased_default,
                            int compensated, double* ws, void* stream) {
  return launch_partials<double>(xi, yi, ri, m, xj, yj, mj, rj, k, band,
                                 row_g0, col_g0, biased_flag, biased_default,
                                 compensated, ws, stream);
}

int nbody_band_partials_bf16(
    const __nv_bfloat16* xi, const __nv_bfloat16* yi,
    const __nv_bfloat16* ri, int64_t m, const __nv_bfloat16* xj,
    const __nv_bfloat16* yj, const __nv_bfloat16* mj,
    const __nv_bfloat16* rj, int64_t k, int64_t band, int64_t row_g0,
    int64_t col_g0, const bool* biased_flag, int biased_default,
    int compensated, float* ws, void* stream) {
  return launch_partials<__nv_bfloat16>(
      xi, yi, ri, m, xj, yj, mj, rj, k, band, row_g0, col_g0, biased_flag,
      biased_default, compensated, ws, stream);
}

// Fold of nb band partials in band order, times G * m_i, into (xf, yf).
int nbody_band_fold_f32(const float* ws, int64_t nb, int64_t m,
                        const float* mi, double gravity, int compensated,
                        float* xf, float* yf, void* stream) {
  return launch_fold<float>(ws, nb, m, mi, gravity, compensated, xf, yf,
                            stream);
}

int nbody_band_fold_f64(const double* ws, int64_t nb, int64_t m,
                        const double* mi, double gravity, int compensated,
                        double* xf, double* yf, void* stream) {
  return launch_fold<double>(ws, nb, m, mi, gravity, compensated, xf, yf,
                             stream);
}

int nbody_band_fold_bf16(const float* ws, int64_t nb, int64_t m,
                         const __nv_bfloat16* mi, double gravity,
                         int compensated, __nv_bfloat16* xf,
                         __nv_bfloat16* yf, void* stream) {
  return launch_fold<__nv_bfloat16>(ws, nb, m, mi, gravity, compensated, xf,
                                    yf, stream);
}

}  // extern "C"
