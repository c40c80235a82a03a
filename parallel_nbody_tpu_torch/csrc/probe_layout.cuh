// The layout of the probe kernels' row loops on Hopper (sm_90a): P1
// (roofline_probe.cu) and the six scalar variants of P2
// (bias_variants_probe.cu).  The variant's pair arithmetic stays in each
// source; this header places the rows, stages the columns and folds the
// column split.
//
// Rows.  Each thread keeps R = kRows rows (xi, yi, ri, and bi in P2) and
// one pair of fp32 accumulators per row.  A warp owns 32 R contiguous rows,
// lane + 32 r for r < R, so each row load and store is coalesced, and
// since 32 R <= 128 divides every tile_i the wrapper admits (a multiple of
// 128), a warp's rows lie in one tile_i segment: P2's bias_cond test is
// uniform across the warp.  A block of kBlock = 128 threads holds 128 R
// rows; rows past n compute on zeros and are not stored.
//
// Columns.  A 128-wide column tile is staged in shared memory with the four
// values of a column side by side, (x, y, m, r) in one float4, so one
// LDS.128 returns them, and each is used for all R rows: the load and the
// loop overhead are shared by R pairs.  The staging is double-buffered: the
// next tile's global loads go out before the current tile's sweep, and one
// barrier per tile suffices (a warp that stores tile k + 1 into the other
// buffer has passed the barrier that every warp reached after its sweep of
// tile k - 1, the buffer's last reader).  The n / 128 tiles are cut into
// S = kSplit parts of ceil(tiles / S) tiles each, part p to the block with
// blockIdx.y = p; each part sums its columns in order.  Columns past n (a
// short last part, or a part wholly past n) are staged as zero-mass bodies
// at the origin, whose terms are exactly 0 for every finite row.
//
// The fold.  The S blocks of one row block form a thread block cluster
// (__cluster_dims__(1, S, 1): a plain <<<>>> launch of a (row blocks, S)
// grid).  Each block writes its R x 128 partial sums to its own shared
// memory; after cluster.sync() rank 0 (= part 0) reads the other ranks'
// partials through distributed shared memory, adds them in rank order to
// its own, applies m_i * 1.1 and stores.  A second cluster.sync() keeps
// every block resident until rank 0 has read it.  One launch, no workspace,
// no atomics, and a fixed order: per row, ((p0 + p1) + p2) + ..., each p a
// sequential sum over its part's columns (_probe.kernel_order states it).
//
// Why R = 4 and S = 2 (a sweep on an H100 80GB HBM3 at 700 W, n = 65536,
// run by building with other values of the three constants below; PERF.md
// has the table).  R = 4 shares the LDS.128 and
// the loop overhead over 4 pairs: 14.375 instructions per pair for `full`
// against 15.375 at R = 1 and 14.688 at R = 2.  Four independent rows per
// thread give each warp the latency hiding that more warps would: with 2
// blocks of 4 warps per SM (S = 2, 256 blocks) the loop issues at ~80% of
// the rate.  More blocks did not help: S = 8 ran at 74% (the card holds
// 124 of its 128 clusters of 8 at once, so four run in a second wave), and
// S = 4 at 65% (its 128 clusters of 4 fit, 248 at once, so we infer that
// they are spread less evenly over the SMs); S = 1 (128 blocks, one warp
// per scheduler) ran at 67%.  kMinBlocks = 8 caps the registers at 64 a
// thread without spills; more registers (80 at 4) ran slower.
// benchmarks/_probe.py's ROWS and SPLIT mirror kRows and kSplit.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "pairs.cuh"

namespace probe {

using nbody::kBlock;

constexpr int kRows = 4;
constexpr int kSplit = 2;
static_assert(kRows == 1 || kRows == 2 || kRows == 4,
              "a warp's 32 R rows must divide a 128-row tile");
static_assert(kSplit >= 1 && kSplit <= 8, "8 is the portable cluster size");
// Blocks per SM that __launch_bounds__ keeps registers for: 8 blocks of
// 128 threads leave 64 registers a thread.
constexpr int kMinBlocks = 8;

// The global index of the thread's r-th row.
template <int R>
__device__ __forceinline__ int64_t row_of(int r) {
  return static_cast<int64_t>(blockIdx.x) * (kBlock * R) +
         (threadIdx.x / 32) * (32 * R) + r * 32 + threadIdx.x % 32;
}

// v[r] = a[row r], 0 past n.
template <int R>
__device__ __forceinline__ void load_rows(const float* __restrict__ a,
                                          int64_t n, float (&v)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t i = row_of<R>(r);
    v[r] = i < n ? a[i] : 0.f;
  }
}

// Columns [begin, end) of this block's part; end may pass n.
struct Part {
  int64_t begin, end;
};
__device__ __forceinline__ Part part_of(int64_t n) {
  const int64_t width = (n / kBlock + kSplit - 1) / kSplit * kBlock;
  const int64_t begin = static_cast<int64_t>(blockIdx.y) * width;
  return {begin, begin + width};
}

// Column j0 + threadIdx.x as (x, y, m, r); zeros past n.
__device__ __forceinline__ float4 fetch(const float* __restrict__ xj,
                                        const float* __restrict__ yj,
                                        const float* __restrict__ mj,
                                        const float* __restrict__ rj,
                                        int64_t n, int64_t j0) {
  const int64_t j = j0 + threadIdx.x;
  return j < n ? make_float4(xj[j], yj[j], mj[j], rj[j])
               : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Stage columns [j0, j0 + kBlock) at s[t].
__device__ __forceinline__ void stage(const float* __restrict__ xj,
                                      const float* __restrict__ yj,
                                      const float* __restrict__ mj,
                                      const float* __restrict__ rj,
                                      int64_t n, int64_t j0, float4* s) {
  s[threadIdx.x] = fetch(xj, yj, mj, rj, n, j0);
}

template <int R>
__device__ __forceinline__ void store_rows(const float (&ax)[R],
                                           const float (&ay)[R],
                                           const float* __restrict__ mi,
                                           int64_t n, float* __restrict__ xf,
                                           float* __restrict__ yf) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t i = row_of<R>(r);
    if (i < n) {
      const float g = mi[i] * 1.1f;
      xf[i] = ax[r] * g;
      yf[i] = ay[r] * g;
    }
  }
}

// Fold the cluster's S partials in rank order into rank 0 and store
// F_i = acc_i * (m_i * 1.1).  Every thread of every block of the cluster
// calls it.
template <int R>
__device__ __forceinline__ void fold_store(float (&ax)[R], float (&ay)[R],
                                           const float* __restrict__ mi,
                                           int64_t n, float* __restrict__ xf,
                                           float* __restrict__ yf) {
  if constexpr (kSplit > 1) {
    namespace cg = cooperative_groups;
    __shared__ float part[2 * R * kBlock];
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      part[r * kBlock + threadIdx.x] = ax[r];
      part[(R + r) * kBlock + threadIdx.x] = ay[r];
    }
    cluster.sync();
    if (cluster.block_rank() == 0) {
#pragma unroll
      for (int p = 1; p < kSplit; ++p) {
        const float* peer = cluster.map_shared_rank(part, p);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          ax[r] += peer[r * kBlock + threadIdx.x];
          ay[r] += peer[(R + r) * kBlock + threadIdx.x];
        }
      }
      store_rows<R>(ax, ay, mi, n, xf, yf);
    }
    cluster.sync();
  } else {
    store_rows<R>(ax, ay, mi, n, xf, yf);
  }
}

// The grid of a row-loop launch: (row blocks, S).
inline dim3 grid(int64_t n) {
  return dim3(static_cast<unsigned>((n + kBlock * kRows - 1) /
                                    (kBlock * kRows)),
              kSplit);
}

}  // namespace probe
