// All-pairs gravitational block forces for Hopper (sm_90a): K1.
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
// mj * sign(gj - gi) / forced along +x (nbody-seq.c:91-106) through the TPU
// kernel's dx bias, segmented by tile: -C on column tiles wholly below the
// block's rows, +C wholly above, (gj - gi) * P on the one or two tiles that
// overlap them (pairs.cuh says where these fall against Pallas's tiles).
// Self-pairs get bias 0 and contribute 0; eps keeps rsqrt finite there.
//
// Options (pairs.cuh): fp32, fp64, and bf16 storage with fp32 compute;
// accum "plain" (each pair term added to the row sum) or "compensated"
// (each 128-wide j-tile's partial Kahan-folded into the row sum, as the
// Pallas kernel folds each column tile's partial).
//
// Bound: instruction issue.  Each SM's four schedulers issue one warp
// instruction per clock, and the fp32 pair loop is nearly all FP32-pipe
// instructions, so its time goes as its instructions per pair.  The census
// of the built library (benchmarks/sass_census.py) counts, per pair, in
// the fp32 loops: unbiased 15.0 (12 FP32 — 3 FADD, 4 FMUL, 4 FFMA,
// 1 FMNMX — one MUFU.RSQ, one LDS.128 (a 16-byte load of one of the four
// staged arrays serves 4 pairs), and 1.0 of address and loop overhead: per
// 8 pairs four ULEA, a UIADD3, a UISETP, a PLOP3 and the branch); constant
// bias 15.875 (one FADD more, 0.875 overhead); per-pair bias 18.0 (an IADD3
// and an I2FP more, the bias folded into an FFMA), on one or two tiles of a
// row's N/128.  That issue time is about twice the FP32-operation bound,
// since the 67 TFLOP/s peak counts an FFMA as two operations and the loop's
// FADD/FMUL/FMNMX as one each.  Memory is far below both: each block of
// kBlock threads reads every column body (16 bytes) once from device
// memory, through L2, and serves it to its kBlock rows from shared memory.
// The Kahan folds add 3 adds per 128 pairs per component.
//
// What does not serve this loop.  Tensor cores: the pair math has no
// product that keeps fp32 accuracy (dsqr as |p|^2 - 2 p.q + |q|^2 cancels
// at pixel coordinates), and a tf32 row reduction on mma.sync measured
// 1.41x the scalar loop (P2, csrc/bias_variants_probe.cu).  TMA or cp.async
// staging: the staging costs about 0.08 issue slots per pair (four loads,
// four stores and two barriers per 128 pairs), so the copy is not the limit.
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
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -Xptxas -v -c
// No --use_fast_math and no -ftz: the fp32 rsqrt is the bare MUFU
// instruction by inline PTX on its one operand (pairs.cuh says why that is
// rsqrtf's result), the default -fmad=true contracts a*b+c into FMAs, and
// neither the bias order nor the Kahan folds may be reassociated.

#include "pairs.cuh"

namespace {

using nbody::ComputeOf;
using nbody::kBlock;

template <typename S, bool kComp>
__global__ void __launch_bounds__(kBlock) block_forces_kernel(
    const S* __restrict__ xi, const S* __restrict__ yi,
    const S* __restrict__ mi, const S* __restrict__ ri, int64_t m,
    const S* __restrict__ xj, const S* __restrict__ yj,
    const S* __restrict__ mj, const S* __restrict__ rj, int64_t k,
    int64_t row_g0, int64_t col_g0, typename ComputeOf<S>::type gravity,
    const bool* __restrict__ biased_flag, int biased_default,
    S* __restrict__ xf, S* __restrict__ yf) {
  using T = typename ComputeOf<S>::type;
  __shared__ T sx[kBlock], sy[kBlock], sm[kBlock], sr[kBlock];

  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const bool row_ok = i < m;
  const T x0 = row_ok ? nbody::to_compute(xi[i]) : T(0);
  const T y0 = row_ok ? nbody::to_compute(yi[i]) : T(0);
  const T r0 = row_ok ? nbody::to_compute(ri[i]) : T(0);
  const long long gi0 = row_g0 + static_cast<int64_t>(blockIdx.x) * kBlock;
  const bool biased = biased_flag != nullptr ? *biased_flag
                                             : biased_default != 0;

  T ax = T(0), ay = T(0);
  nbody::sweep_columns<S, kComp>(xj, yj, mj, rj, 0, k, col_g0, x0, y0, r0,
                                 gi0, biased, sx, sy, sm, sr, ax, ay);
  if (row_ok) {
    const T gmi = nbody::to_compute(mi[i]) * gravity;
    nbody::store(xf + i, ax * gmi);
    nbody::store(yf + i, ay * gmi);
  }
}

template <typename S, bool kComp>
int launch_k(const S* xi, const S* yi, const S* mi, const S* ri, int64_t m,
             const S* xj, const S* yj, const S* mj, const S* rj, int64_t k,
             int64_t row_g0, int64_t col_g0, double gravity,
             const bool* biased_flag, int biased_default, S* xf, S* yf,
             cudaStream_t stream) {
  using T = typename ComputeOf<S>::type;
  const int64_t blocks = (m + kBlock - 1) / kBlock;
  block_forces_kernel<S, kComp><<<static_cast<unsigned>(blocks), kBlock, 0,
                                  stream>>>(
      xi, yi, mi, ri, m, xj, yj, mj, rj, k, row_g0, col_g0,
      static_cast<T>(gravity), biased_flag, biased_default, xf, yf);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch(const S* xi, const S* yi, const S* mi, const S* ri, int64_t m,
           const S* xj, const S* yj, const S* mj, const S* rj, int64_t k,
           int64_t row_g0, int64_t col_g0, double gravity,
           const bool* biased_flag, int biased_default, int compensated,
           S* xf, S* yf, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (compensated) {
    return launch_k<S, true>(xi, yi, mi, ri, m, xj, yj, mj, rj, k, row_g0,
                             col_g0, gravity, biased_flag, biased_default,
                             xf, yf, s);
  }
  return launch_k<S, false>(xi, yi, mi, ri, m, xj, yj, mj, rj, k, row_g0,
                            col_g0, gravity, biased_flag, biased_default, xf,
                            yf, s);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).  Pointers are
// device pointers; biased_flag may be null, and then biased_default decides;
// compensated != 0 selects the Kahan tile folds.
int nbody_block_forces_f32(const float* xi, const float* yi, const float* mi,
                           const float* ri, int64_t m, const float* xj,
                           const float* yj, const float* mj, const float* rj,
                           int64_t k, int64_t row_g0, int64_t col_g0,
                           double gravity, const bool* biased_flag,
                           int biased_default, int compensated, float* xf,
                           float* yf, void* stream) {
  return launch<float>(xi, yi, mi, ri, m, xj, yj, mj, rj, k, row_g0, col_g0,
                       gravity, biased_flag, biased_default, compensated, xf,
                       yf, stream);
}

int nbody_block_forces_f64(const double* xi, const double* yi,
                           const double* mi, const double* ri, int64_t m,
                           const double* xj, const double* yj,
                           const double* mj, const double* rj, int64_t k,
                           int64_t row_g0, int64_t col_g0, double gravity,
                           const bool* biased_flag, int biased_default,
                           int compensated, double* xf, double* yf,
                           void* stream) {
  return launch<double>(xi, yi, mi, ri, m, xj, yj, mj, rj, k, row_g0, col_g0,
                        gravity, biased_flag, biased_default, compensated, xf,
                        yf, stream);
}

int nbody_block_forces_bf16(
    const __nv_bfloat16* xi, const __nv_bfloat16* yi,
    const __nv_bfloat16* mi, const __nv_bfloat16* ri, int64_t m,
    const __nv_bfloat16* xj, const __nv_bfloat16* yj,
    const __nv_bfloat16* mj, const __nv_bfloat16* rj, int64_t k,
    int64_t row_g0, int64_t col_g0, double gravity, const bool* biased_flag,
    int biased_default, int compensated, __nv_bfloat16* xf,
    __nv_bfloat16* yf, void* stream) {
  return launch<__nv_bfloat16>(xi, yi, mi, ri, m, xj, yj, mj, rj, k, row_g0,
                               col_g0, gravity, biased_flag, biased_default,
                               compensated, xf, yf, stream);
}

const char* nbody_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
