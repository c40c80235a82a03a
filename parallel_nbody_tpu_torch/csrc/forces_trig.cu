// The reference's parity force pass for Hopper (sm_90a): float64, the
// transcendental decomposition of nbody-seq.c:79-109, and each body's sum in
// the C loop's own order.
//
// Replaces no TPU kernel.  The JAX package runs its parity mode only through
// XLA's dense path (parallel_nbody_tpu/ops/forces.py::compute_forces_dense,
// trig), and so did the port (ops/forces.py), which holds about ten (N, N)
// float64 matrices a step: 34 GB each at N=65536, so the dense path stops
// near N = 2e4 on an 80 GB card.  This kernel holds nothing but the state.
//
// What it computes, for every body k, from +0 and one add at a time:
//
//   F_k = sum over j = 0 .. N-1, j != k, in ascending j, of
//           + pair(k, j)   for j > k
//           - pair(j, k)   for j < k
//   pair(l, h), l < h, in the C loop's roles (i = l outer, j = h inner):
//     dx = x[h] - x[l], dy = y[h] - y[l], angle = atan2(dy, dx)
//     dsqr = dx*dx + dy*dy, forced = max(max(dsqr, (r_l + r_h)^2), 1e-30)
//     force = m_l * m_h * G / forced
//     pair = (force * cos(angle), force * sin(angle))
//
// which is ops/forces.py::compute_forces_dense's trig path bit for bit on
// the card: its upper-triangle matrix holds pair(i, j) at [i, j], its
// signed matrix fx - fx.T holds -pair(j, k) at [k, j] for j < k, and its
// row sum adds each row's columns in order (_sequential_row_sum); the
// C loop applies pair(i, j) + to body i and - to body j as it meets the
// pair, which is the same order for every body.  Three things keep the
// bits:
//   - the adds: each body's terms are added one at a time, in ascending
//     partner order, from +0.  The dense path also adds +0 at the diagonal
//     and on the lower triangle's zero entries; a sum that starts at +0
//     never becomes -0 under round-to-nearest, so those adds change no bit
//     and the self slot and the ragged tile's empty slots here add nothing;
//   - the roles: a term from a lower partner j is the negation of the pair
//     value computed as the C loop computes it, from x[k] - x[j] and
//     atan2(y[k] - y[j], x[k] - x[j]); atan2 of the reversed differences
//     would differ by rounding;
//   - the arithmetic: every add, multiply and divide is an explicit
//     round-to-nearest intrinsic (__dadd_rn, __dsub_rn, __dmul_rn,
//     __ddiv_rn), so nothing is contracted into an FMA, as nothing is
//     between torch's separate elementwise kernels; atan2, cos and sin are
//     the CUDA math library's, which torch's elementwise kernels call
//     (::atan2, ::cos, ::sin).  The build keeps the default -fmad=true, so
//     those library functions compile as they do inside torch.
// A coincident distinct pair (dx = dy = +0) needs no case of its own:
// atan2(+0, +0) = +0 gives the reference's kick (force, +0) on the lower
// index and its negation on the higher (nbody-seq.c:91-106), so the pass
// takes no coincidence flag.  Zero-mass padding gives force 0 and adds
// only zeros.
//
// Bound: the FP64 pipe.  Per ordered pair the work is atan2 (a division and
// a polynomial), cos and sin of its result (one argument reduction), the
// force's division and a dozen plain operations, about 170 FP64-pipe
// instructions (benchmarks/sass_census.py counts the built loop).  Each SM
// issues 64 FP64 lanes a clock, so at 132 SMs and 1.98 GHz N = 65536 takes
// about 44 ms for its N^2 ordered pairs.  Memory is far below that: each
// block reads every column body (32 bytes) once, through L2, into shared
// memory.
//
// Layout: the rows' chains are the only sequential part, so a row's terms
// may be evaluated by several threads as long as one chain adds them in
// order.  kRowSlots = 4 threads share a row (32 rows a block): at each step
// they evaluate 4 consecutive columns of a staged tile of kTile column
// bodies, one column each, and every thread of the group then adds the
// group's 4 terms in column order, read by warp shuffles, so the group's
// threads hold the same sums and the first one stores them.  At N=65536 on
// the H100, 4 threads a row took 55.3 ms a pass, 1 and 2 took 56-58,
// 8 took 63; below N ~ 3e4 more threads a row would fill the card
// better (8 took 1.7 ms at N=10000, 4 took 2.4), but no measured
// deployment runs there, so the library builds this one layout.  The
// pair's roles are selects, not branches: within the diagonal tile the
// threads of a warp take both roles.
//
// Build (ops/_build.py, library "kernels", an object of its own):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -Xptxas -v -c
// No --use_fast_math and no -fmad=false: see the arithmetic above.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = kThreads;  // one column body staged per thread
// Threads that share a row; the kernel's template argument, so the census
// names the build trig_forces_kernel<Li4> (benchmarks/sass_census.py).
constexpr int kRowSlots = 4;
constexpr unsigned kFullMask = 0xffffffffu;
// ops/forces.py::_DENOM_FLOOR: the dense path's clamp of forced.
constexpr double kDenomFloor = 1e-30;

// pair(l, h) as the C loop computes it, negated for a lower partner:
// (xk, yk, mk, rk) is the row body k, (xj, yj, mj, rj) the column body j,
// and upper = j > k says which of the two is l.
__device__ __forceinline__ void term(double xk, double yk, double mk,
                                     double rk, double xj, double yj,
                                     double mj, double rj, bool upper,
                                     double gravity, double& tx,
                                     double& ty) {
  const double dx = upper ? __dsub_rn(xj, xk) : __dsub_rn(xk, xj);
  const double dy = upper ? __dsub_rn(yj, yk) : __dsub_rn(yk, yj);
  const double angle = atan2(dy, dx);
  const double dsqr = __dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy));
  // r_l + r_h and m_l * m_h: one rounding each, whatever the order.
  const double mind = __dadd_rn(rk, rj);
  const double forced = fmax(fmax(dsqr, __dmul_rn(mind, mind)), kDenomFloor);
  const double force =
      __ddiv_rn(__dmul_rn(__dmul_rn(mk, mj), gravity), forced);
  const double fx = __dmul_rn(force, cos(angle));
  const double fy = __dmul_rn(force, sin(angle));
  tx = upper ? fx : -fx;
  ty = upper ? fy : -fy;
}

template <int kSlots>
__global__ void __launch_bounds__(kThreads) trig_forces_kernel(
    const double* __restrict__ x, const double* __restrict__ y,
    const double* __restrict__ m, const double* __restrict__ r, int64_t n,
    double gravity, double* __restrict__ xf, double* __restrict__ yf) {
  constexpr int kRows = kThreads / kSlots;
  __shared__ double sx[kTile], sy[kTile], sm[kTile], sr[kTile];

  const int slot = threadIdx.x % kSlots;
  const int64_t k =
      static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x / kSlots;
  const bool row_ok = k < n;
  const double xk = row_ok ? x[k] : 0.0;
  const double yk = row_ok ? y[k] : 0.0;
  const double mk = row_ok ? m[k] : 0.0;
  const double rk = row_ok ? r[k] : 0.0;

  double ax = 0.0, ay = 0.0;
  for (int64_t j0 = 0; j0 < n; j0 += kTile) {
    const int cnt = static_cast<int>(n - j0 < kTile ? n - j0 : kTile);
    __syncthreads();  // the previous tile is no longer read
    if (threadIdx.x < cnt) {
      sx[threadIdx.x] = x[j0 + threadIdx.x];
      sy[threadIdx.x] = y[j0 + threadIdx.x];
      sm[threadIdx.x] = m[j0 + threadIdx.x];
      sr[threadIdx.x] = r[j0 + threadIdx.x];
    }
    __syncthreads();
    // cnt is the block's, so every thread runs every step and the
    // shuffles see their whole group.
    for (int c = 0; c < cnt; c += kSlots) {
      const int cc = c + slot;
      const int ci = cc < cnt ? cc : c;  // a staged body in every slot
      double tx, ty;
      term(xk, yk, mk, rk, sx[ci], sy[ci], sm[ci], sr[ci], j0 + cc > k,
           gravity, tx, ty);
      // The group's terms in column order; the ragged tile's empty slots
      // and the row's own slot add nothing.
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const double vx = __shfl_sync(kFullMask, tx, s, kSlots);
        const double vy = __shfl_sync(kFullMask, ty, s, kSlots);
        if (c + s < cnt && j0 + c + s != k) {
          ax = __dadd_rn(ax, vx);
          ay = __dadd_rn(ay, vy);
        }
      }
    }
  }
  if (row_ok && slot == 0) {
    xf[k] = ax;
    yf[k] = ay;
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  Pointers are
// device pointers to n float64 values each.
int nbody_trig_forces_f64(const double* x, const double* y, const double* m,
                          const double* r, int64_t n, double gravity,
                          double* xf, double* yf, void* stream) {
  constexpr int kRows = kThreads / kRowSlots;
  const int64_t blocks = (n + kRows - 1) / kRows;
  trig_forces_kernel<kRowSlots>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(x, y, m, r, n, gravity, xf,
                                               yf);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
