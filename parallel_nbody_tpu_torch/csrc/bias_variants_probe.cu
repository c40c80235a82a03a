// Coincident-bias probe for Hopper (sm_90a): P2, the ways of applying the
// reference's coincident-pair kick inside the fp32 pair loop.
//
// Replaces benchmarks/bias_variants_probe.py::make_kernel (the Pallas probe
// that bench_variant times).  The reference gives a coincident distinct
// pair (dsqr == 0) the kick m_j * sign(gj - gi) / forced along +x.  The TPU
// kernels get it without a branch by adding a tiny bias to dx, so that
// dx / |dx| is the sign.  The variants price the formulations, on two sets
// of n bodies (rows i, columns j) with global indices gi = i, gj = j:
//
//   r2           dx = xj - xi                       (no kick: the bar)
//   bias2_max    dx = (xj - xi) + (bj - bi)         bj = gj * 2^-50,
//   bias2_fma    the same                           bi = gi * 2^-50
//   bias_cond    per Pallas tile pair: (bj - bi) where the row tile
//                [row0, row0 + tile_i) and the column tile
//                [col0, col0 + tile_j) overlap, else +2^-26 if col0 > row0
//                and -2^-26 otherwise
//   bias1_const  dx = (xj - xi) + 2^-26             (wrong on the diagonal:
//   bias1_fma    the same                            a lower bound)
//   mxu2_r2      r2, the row sums on the tensor cores
//   bias1_mxu2   bias1_fma, the row sums on the tensor cores
//
//   dy = yj - yi, dsqr = dx*dx + dy*dy, forced = max(dsqr, (ri + rj)^2)
//   inv = rsqrt(max(forced*forced*dsqr, 1e-30))   r2, bias2_max, mxu2_r2
//   inv = rsqrt(forced*forced*dsqr + 1e-36)       the others
//   acc_i += mj * inv * (dx, dy);   F_i = acc_i * (mi * 1.1)
//
// bias1_const and bias1_fma are the same arithmetic in the Pallas probe, and
// so here.  bj is computed once per staged column (a second shared-memory
// array beside the float4 columns), as the Pallas kernel computes it once
// per column tile; bj - bi is exact (both are integers below 2^24 times
// 2^-50), and the order (xj - xi) + bias is kept, with no --use_fast_math,
// so the rounding of each biased dx is the Pallas probe's.
//
// The rsqrt is the bare MUFU instruction (pairs.cuh::rsqrt_t) in every
// variant.  Its argument is max(q, 1e-30) or q + 1e-36 with q = forced^2 *
// dsqr >= 0: never below FLT_MIN (1.18e-38), or +inf, or NaN from NaN
// inputs, so rsqrtf's rescaling of tiny arguments never fires and
// rsqrt.approx.ftz.f32 returns rsqrtf's bits.  No -ftz elsewhere.
//
// Layout of the six scalar variants: csrc/probe_layout.cuh, as P1's.  R = 4
// rows per thread (each with its own bi), each staged float4 column used
// for all R rows, the tile staging double-buffered (bj too), the columns
// split into S = 2 parts folded in rank order inside a thread block
// cluster.  They no longer run K1's layout (one row per thread, no split):
// what differs is the rows per thread, the split and its fold, the
// staging, and so each row's summation order, not the pair arithmetic.
// Their loops are 14.375 (r2) to 16.469 (bias2_max) instructions per pair,
// bound by instruction issue as P1's.  bias_cond's overlap test uses the
// probe's semantic tiles, not the CUDA block: row0 = i - i % tile_i of the thread's rows, which lie
// in one tile_i segment (a warp's 32 R contiguous rows), and col0 = j0 - j0
// % tile_j per staged tile, one Pallas column tile because the wrapper
// admits only tile_j that is a multiple of 128 and the split cuts on
// 128-column tiles.  The test is made once per staged tile, uniformly
// across each warp, as the Pallas kernel's lax.cond is made once per tile
// pair.
//
// The two tensor-core variants replace the TPU's matrix-vector product
// against ones on the MXU (:88-96) with mma.sync.m16n8k8 (tf32 inputs,
// fp32 accumulate) against a B operand of ones.  A warp owns 16 rows, a
// block of 128 threads 64.  For each 8-column chunk of a staged tile, lane
// (g = lane / 4, t = lane % 4) reads its two columns t and t + 4 as one
// LDS.128 each (the same float4 staging), computes the four A-fragment
// terms of its slots, rows g and g + 8 by those columns, rounds them to
// tf32 (cvt.rna), and one mma per component adds the chunk's row sums to
// every column of the C fragment.  A fresh C per staged tile holds that
// tile's partial, which is then added to the row's fp32 sum, as the Pallas
// kernel adds each tile's product to its accumulator.  They take no column
// split and a single-buffered tile: 64 rows a block already make 1024
// blocks of 4 warps at n = 65536, and what bounds them is their loop of
// 19.6 instructions per pair (r2's is 14.4): the tf32 conversions and the
// fragment addressing.  The rounding to tf32 (11 significant bits,
// relative error at most 2^-11 per term) sets the tolerance: |error_i| <=
// 2^-10 * sum_j |term_ij| per row.  3xTF32 would buy fp32 accuracy for
// twice the mma count; the probe prices the single pass.  wgmma would not
// help: the reduction is 2 HMMA per 16 pairs a warp, and the cost lies in
// the FP32 work that builds and converts the terms.
//
// Bound: operations by the FP32 peak, instruction issue on the card (see
// roofline_probe.cu).  r2 costs 16 FP32 operations and one MUFU rsqrt per
// pair, bias2_* 18, bias1_* 17, bias_cond 18 on overlapping tiles and 17
// elsewhere; the tensor-core variants 14 (FP32) plus 2 tf32 conversions,
// and two m16n8k8 per 128 pairs.  Bytes: 40 per body.
//
// Build: ops/_build.py, library "probes".

#include <stdint.h>

#include "probe_layout.cuh"

namespace {

using nbody::kBlock;

enum Variant {
  kR2 = 0,
  kBias2Max = 1,
  kBias2Fma = 2,
  kBiasCond = 3,
  kBias1Const = 4,
  kBias1Fma = 5,
  kMxu2R2 = 6,
  kBias1Mxu2 = 7,
};

constexpr float kBias = 0x1p-50f;
constexpr float kCBias = 0x1p-26f;
// Rows of the tensor-core kernel's block: 4 warps of 16.
constexpr int kMmaRows = 64;

// What is added to dx: nothing, (bj - bi), or a constant.
enum Add { kNone, kPerPair, kConst };

// Variants whose de-NaN floor is max(q, 1e-30); the others add 1e-36.
template <int V>
constexpr bool kFloorByMax = V == kR2 || V == kBias2Max || V == kMxu2R2;

// mj * inv of one pair with column c = (xj, yj, mj, rj); dx and dy are
// returned for the row sums.
template <int A, bool kMaxEps>
__device__ __forceinline__ float pair_scale(float xi, float yi, float ri,
                                            float4 c, float add, float& dx,
                                            float& dy) {
  dx = c.x - xi;
  if constexpr (A != kNone) dx = dx + add;
  dy = c.y - yi;
  const float dsqr = dx * dx + dy * dy;
  const float mind = ri + c.w;
  const float forced = fmaxf(dsqr, mind * mind);
  const float q = forced * forced * dsqr;
  return c.z * nbody::rsqrt_t(kMaxEps ? fmaxf(q, 1e-30f) : q + 1e-36f);
}

// One staged tile against the thread's R rows, with the variant's dx.  `c`
// is the constant bias of kConst; kPerPair reads bj from sb.
template <int A, bool kMaxEps, int R>
__device__ __forceinline__ void sweep_tile(
    const float4* __restrict__ s, const float* __restrict__ sb,
    const float (&xi)[R], const float (&yi)[R], const float (&ri)[R],
    const float (&bi)[R], float c, float (&ax)[R], float (&ay)[R]) {
#pragma unroll 8
  for (int t = 0; t < kBlock; ++t) {
    const float4 col = s[t];
    const float bj = A == kPerPair ? sb[t] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float dx, dy;
      const float add = A == kPerPair ? bj - bi[r] : c;
      const float sc = pair_scale<A, kMaxEps>(xi[r], yi[r], ri[r], col, add,
                                              dx, dy);
      ax[r] += sc * dx;
      ay[r] += sc * dy;
    }
  }
}

template <int V, int R>
__global__ void __cluster_dims__(1, probe::kSplit, 1)
    __launch_bounds__(kBlock, probe::kMinBlocks) bias_probe_kernel(
        const float* __restrict__ xi, const float* __restrict__ yi,
        const float* __restrict__ mi, const float* __restrict__ ri,
        const float* __restrict__ xj, const float* __restrict__ yj,
        const float* __restrict__ mj, const float* __restrict__ rj,
        int64_t n, int64_t tile_i, int64_t tile_j, float* __restrict__ xf,
        float* __restrict__ yf) {
  constexpr bool kIndex = V == kBias2Max || V == kBias2Fma || V == kBiasCond;
  __shared__ float4 s[2][kBlock];
  __shared__ float sb[2][kBlock];
  float x0[R], y0[R], r0[R], b0[R], ax[R] = {}, ay[R] = {};
  probe::load_rows<R>(xi, n, x0);
  probe::load_rows<R>(yi, n, y0);
  probe::load_rows<R>(ri, n, r0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    b0[r] = static_cast<float>(probe::row_of<R>(r)) * kBias;
  }
  // The start of the tile_i segment that holds all of the thread's rows.
  const int64_t i = probe::row_of<R>(0);
  const int64_t row0 = i - i % tile_i;
  const probe::Part part = probe::part_of(n);
  float4 next = probe::fetch(xj, yj, mj, rj, n, part.begin);
  int buf = 0;
  for (int64_t j0 = part.begin; j0 < part.end; j0 += kBlock, buf ^= 1) {
    s[buf][threadIdx.x] = next;
    if constexpr (kIndex) {
      sb[buf][threadIdx.x] = static_cast<float>(j0 + threadIdx.x) * kBias;
    }
    __syncthreads();
    if (j0 + kBlock < part.end) {
      next = probe::fetch(xj, yj, mj, rj, n, j0 + kBlock);
    }
    const float4* st = s[buf];
    const float* sbt = sb[buf];
    if constexpr (V == kR2) {
      sweep_tile<kNone, true, R>(st, sbt, x0, y0, r0, b0, 0.f, ax, ay);
    } else if constexpr (V == kBias2Max || V == kBias2Fma) {
      sweep_tile<kPerPair, kFloorByMax<V>, R>(st, sbt, x0, y0, r0, b0, 0.f,
                                              ax, ay);
    } else if constexpr (V == kBiasCond) {
      const int64_t col0 = j0 - j0 % tile_j;
      if (row0 < col0 + tile_j && col0 < row0 + tile_i) {
        sweep_tile<kPerPair, false, R>(st, sbt, x0, y0, r0, b0, 0.f, ax,
                                       ay);
      } else {
        sweep_tile<kConst, false, R>(st, sbt, x0, y0, r0, b0,
                                     col0 > row0 ? kCBias : -kCBias, ax, ay);
      }
    } else {  // kBias1Const, kBias1Fma
      sweep_tile<kConst, false, R>(st, sbt, x0, y0, r0, b0, kCBias, ax, ay);
    }
  }
  probe::fold_store<R>(ax, ay, mi, n, xf, yf);
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// d += a * ones for one m16n8k8 tile: every column of d gains the row sums
// of the 16 x 8 tf32 matrix a.  1.0 is exact in tf32.
__device__ __forceinline__ void mma_row_sums(float (&d)[4],
                                             const uint32_t (&a)[4]) {
  const uint32_t one = 0x3f800000u;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(one), "r"(one));
}

// mxu2_r2 (kBias1 = false) and bias1_mxu2 (true).  Fragment layout of
// m16n8k8 tf32 (PTX ISA): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); c0, c1 row g and c2, c3 row g + 8, at columns 2t and
// 2t + 1.  With B all ones every column holds the row sum, so c0 and c2
// are read.
template <bool kBias1>
__global__ void __launch_bounds__(kBlock) bias_probe_mma_kernel(
    const float* __restrict__ xi, const float* __restrict__ yi,
    const float* __restrict__ mi, const float* __restrict__ ri,
    const float* __restrict__ xj, const float* __restrict__ yj,
    const float* __restrict__ mj, const float* __restrict__ rj, int64_t n,
    float* __restrict__ xf, float* __restrict__ yf) {
  constexpr int A = kBias1 ? kConst : kNone;
  constexpr bool kMaxEps = !kBias1;
  __shared__ float4 s[kBlock];
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // The lane's two rows.
  const int64_t ia = static_cast<int64_t>(blockIdx.x) * kMmaRows +
                     (threadIdx.x / 32) * 16 + g;
  const int64_t ib = ia + 8;
  const float xa = xi[ia], ya = yi[ia], ra = ri[ia];
  const float xb = xi[ib], yb = yi[ib], rb = ri[ib];
  float ax_a = 0.f, ay_a = 0.f, ax_b = 0.f, ay_b = 0.f;
  for (int64_t j0 = 0; j0 < n; j0 += kBlock) {
    probe::stage(xj, yj, mj, rj, n, j0, s);
    __syncthreads();
    float cx[4] = {0.f, 0.f, 0.f, 0.f}, cy[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c0 = 0; c0 < kBlock; c0 += 8) {
      // k = 0..3: (row a, col t), (row b, col t), (row a, col t + 4),
      // (row b, col t + 4).
      const float4 col[2] = {s[c0 + t], s[c0 + t + 4]};
      uint32_t fx[4], fy[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool row_b = k & 1;
        float dx, dy;
        const float sc = pair_scale<A, kMaxEps>(
            row_b ? xb : xa, row_b ? yb : ya, row_b ? rb : ra, col[k >> 1],
            kCBias, dx, dy);
        fx[k] = to_tf32(sc * dx);
        fy[k] = to_tf32(sc * dy);
      }
      mma_row_sums(cx, fx);
      mma_row_sums(cy, fy);
    }
    ax_a += cx[0];
    ax_b += cx[2];
    ay_a += cy[0];
    ay_b += cy[2];
    __syncthreads();
  }
  if (t == 0) {
    const float ga = mi[ia] * 1.1f, gb = mi[ib] * 1.1f;
    xf[ia] = ax_a * ga;
    yf[ia] = ay_a * ga;
    xf[ib] = ax_b * gb;
    yf[ib] = ay_b * gb;
  }
}

template <int V>
int launch(const float* xi, const float* yi, const float* mi,
           const float* ri, const float* xj, const float* yj,
           const float* mj, const float* rj, int64_t n, int64_t tile_i,
           int64_t tile_j, float* xf, float* yf, cudaStream_t stream) {
  if constexpr (V == kMxu2R2 || V == kBias1Mxu2) {
    bias_probe_mma_kernel<V == kBias1Mxu2>
        <<<static_cast<unsigned>(n / kMmaRows), kBlock, 0, stream>>>(
            xi, yi, mi, ri, xj, yj, mj, rj, n, xf, yf);
  } else {
    bias_probe_kernel<V, probe::kRows>
        <<<probe::grid(n), kBlock, 0, stream>>>(xi, yi, mi, ri, xj, yj, mj,
                                                rj, n, tile_i, tile_j, xf,
                                                yf);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// variant: 0 r2, 1 bias2_max, 2 bias2_fma, 3 bias_cond, 4 bias1_const,
// 5 bias1_fma, 6 mxu2_r2, 7 bias1_mxu2.  n must be a positive multiple of
// 128, and of tile_i and tile_j, which are multiples of 128 (the wrapper
// checks).  Returns the cudaError_t of the launch (0 on success).
int nbody_bias_variants_probe(int variant, const float* xi, const float* yi,
                              const float* mi, const float* ri,
                              const float* xj, const float* yj,
                              const float* mj, const float* rj, int64_t n,
                              int64_t tile_i, int64_t tile_j, float* xf,
                              float* yf, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define NBODY_CASE(V)                                                      \
  case V:                                                                  \
    return launch<V>(xi, yi, mi, ri, xj, yj, mj, rj, n, tile_i, tile_j, xf, \
                     yf, s);
  switch (variant) {
    NBODY_CASE(kR2)
    NBODY_CASE(kBias2Max)
    NBODY_CASE(kBias2Fma)
    NBODY_CASE(kBiasCond)
    NBODY_CASE(kBias1Const)
    NBODY_CASE(kBias1Fma)
    NBODY_CASE(kMxu2R2)
    NBODY_CASE(kBias1Mxu2)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NBODY_CASE
}

}  // extern "C"
